"""Fused multi-predicate weightings (query fast path)."""
from repro_torch.kernels.weightings.ops import (batched_weightings,  # noqa: F401
                                                fused_weightings, q_bucket)
