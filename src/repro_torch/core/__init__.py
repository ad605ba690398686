# The PairwiseHist synopsis and its query engine on PyTorch: construction
# runs on torch tensors (CUDA kernels for the histogram counts), queries run
# on host NumPy with the fused weightings kernel as the fast path.
from repro_torch.core.types import (  # noqa: F401
    Hist1D,
    PairHist,
    PairwiseHist,
    BuildParams,
    synopsis_from_numpy,
)
