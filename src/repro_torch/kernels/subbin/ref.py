"""Plain PyTorch version of the pair-batched sub-bin histogram."""
from __future__ import annotations

import torch


def batched_subbin_hist_ref(cell, sub, weights, ncell: int, s_max: int):
    """(P, N) ids/weights -> (P, ncell, s_max) in the weights' dtype.

    ``hbar[p, c, r] = sum_n w[p, n] [clip(cell) == c][clip(sub) == r]``.
    Rows that must not contribute carry weight 0. The dtype is preserved,
    so f64 validity ones give exact f64 counts.
    """
    p = cell.shape[0]
    flat = (torch.clamp(cell.to(torch.int64), 0, ncell - 1) * s_max
            + torch.clamp(sub.to(torch.int64), 0, s_max - 1))
    out = torch.zeros((p, ncell * s_max), dtype=weights.dtype,
                      device=weights.device)
    out.scatter_add_(1, flat, weights)
    return out.reshape(p, ncell, s_max)
