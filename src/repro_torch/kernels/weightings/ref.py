"""Plain PyTorch versions of the fused weightings kernel.

On a CUDA device the ``einsum`` products run through cuBLAS; they are full
fp32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default). A caller that compares them with the kernel sets it so.
"""
from __future__ import annotations

import torch


def fused_weightings_ref(h_stack, beta, fold, hx):
    """prod_l fold_l( clip( (H_l @ beta_l) / hx_l , 0, 1) )  — Eq. 25/27/28.

    h_stack: (L, K2, K2)  pair-count matrices (x-dim = agg column)
    beta:    (L, K2)      coverage vectors on the predicate columns' slices
    fold:    (L, K1, K2)  one-hot gather: 1-D bin -> containing pair x-row
    hx:      (L, K2)      pair x-row totals
    Returns  (K1,) per-1-D-bin probability product; the caller multiplies by
    the 1-D bin counts h^(i) to obtain weightings (Eq. 24).
    """
    v = torch.einsum("lab,lb->la", h_stack, beta)            # (L, K2)
    p_row = torch.clamp(v / torch.clamp(hx, min=1e-30), 0.0, 1.0)
    p1 = torch.einsum("lka,la->lk", fold, p_row)             # (L, K1)
    return torch.prod(p1, dim=0)


def batched_weightings_ref(h_stack, beta, fold, hx):
    """Query-batched fused weightings — Eq. 25/27/28 over Q queries at once.

    h_stack (L, K2, K2), beta (Q, L, K2), fold (L, K1, K2), hx (L, K2).
    Returns (Q, K1) per-query probability products.
    """
    v = torch.einsum("lab,qlb->qla", h_stack, beta)          # (Q, L, K2)
    p_row = torch.clamp(v / torch.clamp(hx, min=1e-30)[None], 0.0, 1.0)
    p1 = torch.einsum("lka,qla->qlk", fold, p_row)           # (Q, L, K1)
    return torch.prod(p1, dim=1)
