"""Plain PyTorch version of the pair-batched 2-D histogram."""
from __future__ import annotations

import torch


def batched_hist2d_ref(bi, bj, weights, ki: int, kj: int):
    """(P, N) indices/weights -> (P, KI, KJ) in the weights' dtype.

    ``out[p, a, b] = sum_n w[p, n] [clip(bi) == a][clip(bj) == b]``; indices
    are clipped, so rows that must not count carry weight 0. The dtype is
    preserved: construction feeds f64 ones/flags and gets exact f64 counts.
    """
    p = bi.shape[0]
    flat = (torch.clamp(bi.to(torch.int64), 0, ki - 1) * kj
            + torch.clamp(bj.to(torch.int64), 0, kj - 1))
    out = torch.zeros((p, ki * kj), dtype=weights.dtype, device=weights.device)
    out.scatter_add_(1, flat, weights)
    return out.reshape(p, ki, kj)
