"""Dispatch for the 2-D histograms: CUDA kernel or plain PyTorch, by the
device of the weights."""
from __future__ import annotations

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.flat_hist import flat_hist_cuda
from repro_torch.kernels.hist2d.ref import batched_hist2d_ref, hist2d_ref

launches = {"batched_hist2d": 0, "hist2d": 0}

# Bins of one histogram row that fit in the kernel's shared-memory slab.
MAX_KJ = 49152


def hist2d(bi, bj, weights, ki: int, kj: int):
    """Weighted 2-D histogram: (N,) indices/weights -> (KI, KJ) fp32.

    ``H[a, b] = sum_n w_n [clip(bi_n) == a][clip(bj_n) == b]``. Indices of
    any integer dtype are cast to int32 and weights of any dtype to fp32, as
    the reference's wrapper does. A CUDA tensor goes to ``csrc/hist2d.cu``,
    a CPU tensor to ``ref.py``; ``n = 0`` gives zeros without a launch.

    Out-of-range indices are clipped into the edge bins, as ``hist2d_ref``
    (both packages') and the pair-batched kernel do. The reference's Pallas
    path drops them instead; the contract gives such rows weight 0, and
    inside it the two agree.
    """
    dev = weights.device
    if bi.device != dev or bj.device != dev:
        raise ValueError("hist2d: inputs on different devices")
    if weights.dim() != 1 or bi.shape != weights.shape or \
            bj.shape != weights.shape:
        raise ValueError("hist2d: need (N,) indices and weights, got "
                         f"{tuple(bi.shape)} {tuple(bj.shape)} "
                         f"{tuple(weights.shape)}")
    for name, t in (("bi", bi), ("bj", bj)):
        if t.dtype.is_floating_point or t.dtype.is_complex or \
                t.dtype == torch.bool:
            raise ValueError(f"hist2d: {name} must be integer")
    if ki < 1 or kj < 1:
        raise ValueError("hist2d: empty histogram")
    bi = bi.to(torch.int32)
    bj = bj.to(torch.int32)
    w = weights.to(torch.float32)
    if w.is_cuda:
        return _hist2d_cuda(bi, bj, w, ki, kj)
    if dev.type == "cpu":
        return hist2d_ref(bi, bj, w, ki, kj)
    raise ValueError(f"unsupported device {dev}")


def _hist2d_cuda(bi, bj, w, ki: int, kj: int):
    """Launch ``hist2d_launch`` on int32/fp32 CUDA vectors of one length."""
    if kj > MAX_KJ:
        raise ValueError(f"hist2d: kj = {kj} exceeds the kernel's "
                         f"{MAX_KJ} bins per row")
    dev = w.device
    bi, bj, w = bi.contiguous(), bj.contiguous(), w.contiguous()
    out = torch.zeros((ki, kj), dtype=torch.float32, device=dev)
    n = w.shape[0]
    if n:
        lib = loader.library("hist2d")
        with torch.cuda.device(dev):
            status = lib.hist2d_launch(
                bi.data_ptr(), bj.data_ptr(), w.data_ptr(), out.data_ptr(),
                n, ki, kj, torch.cuda.current_stream(dev).cuda_stream)
        loader.check(status, "hist2d_launch")
        launches["hist2d"] += 1
    return out


def hist2d_sharded(bi, bj, weights, ki: int, kj: int, group=None):
    """Row-sharded distributed bin counting: every rank of ``group`` passes
    its own row shard and gets the (KI, KJ) fp32 counts of all the rows.

    The reference's ``hist2d_sharded(bi, bj, weights, ki, kj, mesh, axis)``
    takes the whole arrays and a mesh, shards the rows over the mesh's axis
    itself and lets GSPMD insert the psum of the replicated output. In
    PyTorch each process owns its data, so the caller shards (one process
    per rank, ``torch.distributed`` initialised) and this function is the
    per-rank program: it bins the local rows with ``hist2d`` (the K5 kernel
    for CUDA tensors) and sums the counts over ``group`` with
    ``torch.distributed.all_reduce``. Only counts cross ranks.

    The reference bins through its pair-batched op at P = 1. That is the
    same function, but the pair-batched kernel reads int64 indices (twice
    the index bytes of int32) and is built for rows sorted by bin, whose
    runs it adds once each; a shard's rows come in no order. So the port
    bins through the single-histogram kernel, which reads int32 indices.

    Raises ``RuntimeError`` when no process group is initialised.
    """
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("hist2d_sharded: torch.distributed is not "
                           "initialised; call init_process_group on every "
                           "rank first")
    counts = hist2d(bi, bj, weights, ki, kj)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    return counts


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
