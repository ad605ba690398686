"""Launcher of ``csrc/flat_hist.cu``, shared by the hist2d and subbin ops.

One weighted histogram per row of (P, N) inputs over the flat id
``clip(a, 0, ka-1) * kb + clip(b, 0, kb-1)``, accumulated in fp32 and
returned in the weights' dtype (exact for 0/1 weights below 2^24 rows).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader


def flat_hist_cuda(a, b, weights, ka: int, kb: int, counter: dict, key: str):
    """(P, N) CUDA indices/weights -> (P, ka * kb) in ``weights.dtype``.

    Indices of any integer dtype are cast once to int64 (the kernel reads
    int64, PyTorch's index type); weights other than fp32/fp64 are
    accumulated as fp32. Counts the launch under ``counter[key]``.
    """
    dev = weights.device
    if a.device != dev or b.device != dev:
        raise ValueError("flat_hist: inputs on different devices")
    if a.shape != weights.shape or b.shape != weights.shape or \
            weights.dim() != 2:
        raise ValueError("flat_hist: need (P, N) indices and weights of one "
                         f"shape, got {tuple(a.shape)} {tuple(b.shape)} "
                         f"{tuple(weights.shape)}")
    for name, t in (("a", a), ("b", b), ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"flat_hist: {name} must be contiguous")
        if name != "weights" and (t.dtype.is_floating_point
                                  or t.dtype == torch.bool):
            raise ValueError(f"flat_hist: {name} must be integer")
    if ka < 1 or kb < 1:
        raise ValueError("flat_hist: empty histogram")
    p, n = weights.shape
    out = torch.zeros((p, ka * kb), dtype=torch.float32, device=dev)
    if p and n:
        a = a.to(torch.int64)
        b = b.to(torch.int64)
        w = weights
        if w.dtype not in (torch.float32, torch.float64):
            w = w.to(torch.float32)
        fn = "flat_hist_f64" if w.dtype == torch.float64 else "flat_hist_f32"
        lib = loader.library("flat_hist")
        with torch.cuda.device(dev):
            status = getattr(lib, fn)(
                a.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(),
                p, n, ka, kb, torch.cuda.current_stream(dev).cuda_stream)
        loader.check(status, fn)
        counter[key] += 1
    return out.to(weights.dtype)
