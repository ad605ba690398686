"""Dispatch for the fused weightings: CUDA kernel or plain PyTorch.

The device of ``h_stack`` decides: a CUDA tensor launches the kernel of
``csrc/weightings.cu``, a CPU tensor runs ``ref.py``. ``beta`` may be a
NumPy array (per-query host data); it is moved to ``h_stack``'s device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.weightings.ref import (batched_weightings_ref,
                                                fused_weightings_ref)

launches = {"batched_weightings": 0, "fused_weightings": 0}


def q_bucket(q: int) -> int:
    """Power-of-two bucketing rule for the query-batch dimension (UP to the
    next power of two, floor 8), kept from the reference for the serving
    layer's wave sizing. The CUDA kernel takes any Q and is not padded."""
    return max(8, 1 << (int(q) - 1).bit_length())


def _launch(h_stack, beta, fold, hx, counter: str):
    """(L,K2,K2), (Q,L,K2), (L,K1,K2), (L,K2) fp32 CUDA -> (Q, K1); counts
    the launch under ``launches[counter]``."""
    dev = h_stack.device
    for name, t in (("h_stack", h_stack), ("beta", beta), ("fold", fold),
                    ("hx", hx)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    el, k2, k2b = h_stack.shape
    q = beta.shape[0]
    k1 = fold.shape[1]
    if (k2b != k2 or beta.shape[1:] != (el, k2) or fold.shape != (el, k1, k2)
            or hx.shape != (el, k2)):
        raise ValueError("weightings: inconsistent shapes "
                         f"{tuple(h_stack.shape)} {tuple(beta.shape)} "
                         f"{tuple(fold.shape)} {tuple(hx.shape)}")
    out = torch.empty((q, k1), dtype=torch.float32, device=dev)
    if q == 0 or k1 == 0:
        return out
    if k2 == 0:
        return out.fill_(1.0 if el == 0 else 0.0)
    lib = loader.library("weightings")
    with torch.cuda.device(dev):
        status = lib.weightings_launch(
            h_stack.data_ptr(), beta.data_ptr(), fold.data_ptr(),
            hx.data_ptr(), out.data_ptr(), el, q, k1, k2,
            torch.cuda.current_stream(dev).cuda_stream)
    loader.check(status, "weightings_launch")
    launches[counter] += 1
    return out


def _on(device, x):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def fused_weightings(h_stack, beta, fold, hx):
    """Single-query weightings: beta (L, K2) -> (K1,) fp32. See ref.py."""
    dev = h_stack.device
    beta = _on(dev, beta)
    if dev.type == "cuda":
        return _launch(h_stack, beta.reshape(1, *beta.shape).contiguous(),
                       fold, hx, "fused_weightings")[0]
    if dev.type == "cpu":
        return fused_weightings_ref(h_stack, beta, fold, hx)
    raise ValueError(f"unsupported device {dev}")


def batched_weightings(h_stack, beta, fold, hx):
    """Query-batched weightings: beta (Q, L, K2) -> (Q, K1) fp32.

    One launch for a whole plan-shape group: H, fold and hx are shared,
    only beta varies per query. See ref.py for the semantics.
    """
    dev = h_stack.device
    beta = _on(dev, beta)
    if dev.type == "cuda":
        return _launch(h_stack, beta.contiguous(), fold, hx,
                       "batched_weightings")
    if dev.type == "cpu":
        return batched_weightings_ref(h_stack, beta, fold, hx)
    raise ValueError(f"unsupported device {dev}")
