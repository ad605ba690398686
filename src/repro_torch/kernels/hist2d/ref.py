"""Plain PyTorch versions of the 2-D histograms (single and pair-batched)."""
from __future__ import annotations

import torch


def hist2d_ref(bi, bj, weights, ki: int, kj: int):
    """(N,) indices/weights -> (KI, KJ) fp32.

    ``H[a, b] = sum_n w_n [clip(bi_n) == a][clip(bj_n) == b]`` with indices
    clipped into ``[0, k-1]`` and weights cast to fp32, as the reference's
    oracle does; rows that must not count carry weight 0.
    """
    flat = (torch.clamp(bi.to(torch.int64), 0, ki - 1) * kj
            + torch.clamp(bj.to(torch.int64), 0, kj - 1))
    out = torch.zeros(ki * kj, dtype=torch.float32, device=weights.device)
    out.scatter_add_(0, flat, weights.to(torch.float32))
    return out.reshape(ki, kj)


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
