"""Dispatch for the pair-batched sub-bin histogram: CUDA kernel or plain
PyTorch, by the device of the weights."""
from __future__ import annotations

from repro_torch.kernels.flat_hist import flat_hist_cuda
from repro_torch.kernels.subbin.ref import batched_subbin_hist_ref

launches = {"batched_subbin_hist": 0}


def batched_subbin_hist(cell, sub, weights, ncell: int, s_max: int):
    """Pair-batched sub-bin histograms: (P, N) -> (P, ncell, s_max).

    The chi-squared inner scatter of 2-D refinement: every point of pair p
    adds its weight to ``out[p, cell, sub]``; null rows carry weight 0 and
    ids are clipped. A CUDA tensor goes to ``csrc/flat_hist.cu`` with the
    flat id ``cell * s_max + sub``; a CPU tensor to ``ref.py``.
    """
    if weights.is_cuda:
        p = weights.shape[0]
        return flat_hist_cuda(cell, sub, weights, ncell, s_max, launches,
                              "batched_subbin_hist").reshape(p, ncell, s_max)
    if weights.device.type == "cpu":
        return batched_subbin_hist_ref(cell, sub, weights, ncell, s_max)
    raise ValueError(f"unsupported device {weights.device}")
