"""Data pipelines (port of ``src/repro/data``)."""
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
