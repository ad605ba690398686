"""Plain PyTorch versions of the fused weightings kernel.

``fold`` comes in either of two forms, and both give the same numbers bit
for bit (the fold is one-hot, ``p >= 0`` is finite, and the one nonzero term
of each dense sum is ``p * 1``):

* dense, ``(L, K1, K2)`` float: the reference's one-hot matrix, applied as
  an ``einsum``;
* index, ``(L, K1)`` integer: the column of each row's 1, applied as a
  ``torch.gather``; an index outside ``[0, K2)`` (``-1``: an all-zero row)
  gives 0.

On a CUDA device the ``einsum`` products run through cuBLAS; they are full
fp32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default). A caller that compares them with the kernel sets it so.
"""
from __future__ import annotations

import torch


def _fold(p_row, fold):
    """(Q, L, K2) probabilities through ``fold`` -> (Q, L, K1)."""
    if fold.dim() == 3:
        return torch.einsum("lka,qla->qlk", fold, p_row)
    q, el, k2 = p_row.shape
    idx = fold.to(torch.int64)
    valid = (idx >= 0) & (idx < k2)
    if k2 == 0:
        return torch.zeros((q, el, idx.shape[1]), dtype=p_row.dtype,
                           device=p_row.device)
    picked = torch.gather(p_row, 2,
                          idx.clamp(0, k2 - 1).expand(q, el, idx.shape[1]))
    return torch.where(valid, picked, torch.zeros((), dtype=p_row.dtype,
                                                  device=p_row.device))


def fused_weightings_ref(h_stack, beta, fold, hx):
    """prod_l fold_l( clip( (H_l @ beta_l) / hx_l , 0, 1) )  — Eq. 25/27/28.

    h_stack: (L, K2, K2)  pair-count matrices (x-dim = agg column)
    beta:    (L, K2)      coverage vectors on the predicate columns' slices
    fold:    (L, K1, K2)  one-hot gather: 1-D bin -> containing pair x-row,
             or its (L, K1) index (see the module docstring)
    hx:      (L, K2)      pair x-row totals
    Returns  (K1,) per-1-D-bin probability product; the caller multiplies by
    the 1-D bin counts h^(i) to obtain weightings (Eq. 24).
    """
    v = torch.einsum("lab,lb->la", h_stack, beta)            # (L, K2)
    p_row = torch.clamp(v / torch.clamp(hx, min=1e-30), 0.0, 1.0)
    p1 = _fold(p_row[None], fold)[0]                         # (L, K1)
    return torch.prod(p1, dim=0)


def batched_weightings_ref(h_stack, beta, fold, hx):
    """Query-batched fused weightings — Eq. 25/27/28 over Q queries at once.

    h_stack (L, K2, K2), beta (Q, L, K2), fold (L, K1, K2) or its (L, K1)
    index, hx (L, K2). Returns (Q, K1) per-query probability products.
    """
    v = torch.einsum("lab,qlb->qla", h_stack, beta)          # (Q, L, K2)
    p_row = torch.clamp(v / torch.clamp(hx, min=1e-30)[None], 0.0, 1.0)
    p1 = _fold(p_row, fold)                                  # (Q, L, K1)
    return torch.prod(p1, dim=1)
