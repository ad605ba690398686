"""Pair-batched sub-bin histograms (chi-squared counts of 2-D refinement)."""
from repro_torch.kernels.subbin.ops import batched_subbin_hist  # noqa: F401
