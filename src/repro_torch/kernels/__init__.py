"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

  * ``weightings`` — the fused multi-predicate weightings of the query
    fast path (``batched_weightings``, and ``fused_weightings`` as its
    single-query launch);
  * ``hist2d`` / ``subbin`` — the pair-batched 2-D count and chi-squared
    sub-bin histograms of construction, one flat-id histogram kernel;
  * ``hist2d`` also holds the single weighted 2-D histogram (``hist2d``,
    its own kernel: global atomics into the output for up to 2M rows,
    shared-memory slabs beyond) and its row-sharded form over
    ``torch.distributed`` (``hist2d_sharded``).

Each package has ``ref.py`` (plain PyTorch) and ``ops.py``, which sends a
CUDA tensor to the kernel (``csrc/*.cu``, built by ``loader``) and a CPU
tensor to ``ref.py``. Every wrapper counts its kernel launches.
"""
from __future__ import annotations


def _counters():
    from repro_torch.kernels.hist2d import ops as hist2d_ops
    from repro_torch.kernels.subbin import ops as subbin_ops
    from repro_torch.kernels.weightings import ops as weightings_ops
    return (weightings_ops.launches, hist2d_ops.launches, subbin_ops.launches)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    out = {}
    for counter in _counters():
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _counters():
        for name in counter:
            counter[name] = 0
