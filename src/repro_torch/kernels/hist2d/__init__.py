"""Weighted 2-D histograms: the single histogram and its row-sharded
distributed form, and the pair-batched construction bin counts."""
from repro_torch.kernels.hist2d.ops import (batched_hist2d, hist2d,  # noqa: F401
                                            hist2d_sharded)
