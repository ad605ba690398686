"""Launcher of ``csrc/flat_hist.cu``, shared by the hist2d and subbin ops.

One weighted histogram per row of (P, N) inputs over the flat id
``clip(a, 0, ka-1) * kb + clip(b, 0, kb-1)``, returned in the weights'
dtype. The kernel adds each run of equal ids once, straight into the
zeroed output in that dtype (f64 weights sum in f64), so counts of 0/1
weights are exact integers. Its grid is one block a tile of 1,024 rows of
one pair; the launcher has no choices to make.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import loader

MAX_PAIRS = 65535             # the grid's second dimension
MAX_BINS = 1 << 30


@functools.lru_cache(maxsize=None)
def _entry():
    """The bound C entry point (built and loaded once)."""
    return loader.library("flat_hist").flat_hist_launch


def _aligned(t):
    """``t`` itself when its data is 16-byte aligned (the kernel stages rows
    with 16-byte copies), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flat_hist_cuda(a, b, weights, ka: int, kb: int, counter: dict, key: str):
    """(P, N) CUDA indices/weights -> (P, ka * kb) in ``weights.dtype``.

    Indices of another integer dtype than int64 are cast once (the kernel
    reads int64, PyTorch's index type); weights other than fp32/fp64 are
    counted in fp32 and the result cast back. Counts the launch under
    ``counter[key]``; a refused launch raises."""
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
    if ka * kb > MAX_BINS or p > MAX_PAIRS or n >= 1 << 31:
        raise ValueError(f"flat_hist: {p} pairs x {n} rows into {ka} x {kb} "
                         f"bins exceed the kernel's limits")
    w = weights
    if w.dtype not in (torch.float32, torch.float64):
        w = w.to(torch.float32)
    out = torch.zeros((p, ka * kb), dtype=w.dtype, device=dev)
    if p and n:
        a, b, w = (_aligned(t) for t in (a.to(torch.int64),
                                         b.to(torch.int64), w))
        index = dev.index
        args = (a.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(), p,
                n, ka, kb, int(w.dtype == torch.float64),
                torch._C._cuda_getCurrentRawStream(index))
        if index == torch.cuda.current_device():
            status = _entry()(*args)
        else:
            with torch.cuda.device(index):
                status = _entry()(*args)
        loader.check(status, "flat_hist_launch")
        counter[key] += 1
    return out if out.dtype == weights.dtype else out.to(weights.dtype)
