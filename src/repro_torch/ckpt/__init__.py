"""Checkpointing (port of ``src/repro/ckpt``)."""
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: F401
