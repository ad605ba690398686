"""Fused multi-predicate weightings (query fast path)."""
from repro_torch.kernels.weightings.ops import (batched_weightings,  # noqa: F401
                                                check_stack, fold_index,
                                                fused_weightings, q_bucket,
                                                stacked_weightings)
