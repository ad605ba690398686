"""Pair-batched weighted 2-D histograms (construction bin counts)."""
from repro_torch.kernels.hist2d.ops import batched_hist2d  # noqa: F401
