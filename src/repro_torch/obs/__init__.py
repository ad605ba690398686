"""Observability of the port: the build-phase timeline."""
from repro_torch.obs.timeline import BuildTimeline  # noqa: F401
