"""Dispatch for the pair-batched 2-D histogram: CUDA kernel or plain
PyTorch, by the device of the weights."""
from __future__ import annotations

from repro_torch.kernels.flat_hist import flat_hist_cuda
from repro_torch.kernels.hist2d.ref import batched_hist2d_ref

launches = {"batched_hist2d": 0}


def batched_hist2d(bi, bj, weights, ki: int, kj: int):
    """Pair-batched weighted 2-D histograms: (P, N) -> (P, KI, KJ).

    The construction hot loop's inner op (twice per refinement round, once
    per metadata launch). A CUDA tensor goes to ``csrc/flat_hist.cu`` with
    the flat id ``bi * KJ + bj``; a CPU tensor to ``ref.py``. The result has
    the weights' dtype.
    """
    if weights.is_cuda:
        p = weights.shape[0]
        return flat_hist_cuda(bi, bj, weights, ki, kj, launches,
                              "batched_hist2d").reshape(p, ki, kj)
    if weights.device.type == "cpu":
        return batched_hist2d_ref(bi, bj, weights, ki, kj)
    raise ValueError(f"unsupported device {weights.device}")
