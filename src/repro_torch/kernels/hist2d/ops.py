"""Dispatch for the 2-D histograms: CUDA kernel or plain PyTorch, by the
device of the weights.

The single histogram's kernel (``csrc/hist2d.cu``) takes its whole launch
geometry from ``_plan``, a pure function of the shape and of what the card
offers (``Device``: SMs, shared memory a block, resident clusters), which
is queried once per device. So the planner is tested on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.flat_hist import flat_hist_cuda
from repro_torch.kernels.hist2d.ref import batched_hist2d_ref, hist2d_ref

launches = {"batched_hist2d": 0, "hist2d": 0}

# Bins of one histogram row that fit in the kernel's shared-memory slab.
MAX_KJ = 49152
# Up to this many rows every row is added straight into the output (no
# slabs), in chunks of DIRECT_CHUNK_ROWS rows a block and with a block for
# every ZERO_BINS bins to zero.
DIRECT_ROWS = 1 << 21
DIRECT_CHUNK_ROWS = 1024
ZERO_BINS = 2048
# Beyond it, slab plans cut the rows into chunks of at least this many rows
# and reduce the partial slabs of CLUSTER_CHUNKS chunks in a cluster.
CHUNK_ROWS = 4096
CLUSTER_CHUNKS = 2


class Device(NamedTuple):
    """What the planner needs of a card: its SMs, the shared memory a block
    may use, and ``resident(cy, smem)``, the blocks in clusters of ``cy``
    with ``smem`` bytes of shared memory each that fit on it at once
    (``resident(0, 0)``: blocks of the slab-free path)."""
    sms: int
    smem: int
    resident: Callable[[int, int], int]


class Plan(NamedTuple):
    """One launch of the kernel. With ``n_slabs`` 0, no slabs: ``n_chunks``
    blocks, all resident at once, zero the output, meet at a grid-wide
    barrier and add their rows straight into it. Else H is cut into
    ``n_slabs`` slabs of ``slab_rows`` rows (grid x), the rows into
    ``n_chunks`` chunks (grid y), clusters of ``cy`` chunks of one slab,
    which reduce their partial slabs through distributed shared memory and
    add them into a zeroed output."""
    n_slabs: int
    slab_rows: int
    n_chunks: int
    cy: int

    @property
    def zero_fill(self) -> bool:
        """Whether the output is zeroed before the launch (a second device
        operation): slab plans add into it, the slab-free path zeroes it
        itself."""
        return self.n_slabs > 0

    def smem_bytes(self, kj: int) -> int:
        """Dynamic shared memory a block: its slab in whole 16-byte quads."""
        return -(-self.slab_rows * kj // 4) * 16


def _plan(n: int, ki: int, kj: int, dev: Device) -> Plan:
    """The launch geometry for ``n`` rows into ``ki`` x ``kj`` bins.

    Up to ``DIRECT_ROWS`` rows, one cooperative launch of blocks of about
    ``DIRECT_CHUNK_ROWS`` rows, or of ``ZERO_BINS`` bins where the output
    is the larger, and no more than fit on the card at once, zeroes the
    output and adds straight into it; beyond it, ``_slab_plan``. Raises
    ``ValueError`` for a shape the kernel does not take."""
    if n < 1 or ki < 1 or kj < 1:
        raise ValueError(f"hist2d: no plan for {n} rows into {ki} x {kj}")
    if kj > MAX_KJ:
        raise ValueError(f"hist2d: kj = {kj} exceeds the kernel's "
                         f"{MAX_KJ} bins per row")
    if n <= DIRECT_ROWS:
        chunks = max(-(-n // DIRECT_CHUNK_ROWS), -(-ki * kj // ZERO_BINS))
        return Plan(0, 0, min(chunks, dev.resident(0, 0)), 1)
    return _slab_plan(n, ki, kj, dev)


def _slab_plan(n: int, ki: int, kj: int, dev: Device) -> Plan:
    """The slab plan for ``n`` rows into ``ki`` x ``kj`` bins (1 <= kj <=
    ``MAX_KJ``). Every block reads all the rows of its chunk and zeroes and
    adds the bins of its slab, so the slabs are cut to balance the two:
    about sqrt(bins x SMs / rows) of them, no fewer than shared memory
    needs; enough chunks to fill the card once, in clusters of
    ``CLUSTER_CHUNKS``, add into a zeroed output."""
    rows_fit = min(MAX_KJ // kj, dev.smem // (4 * kj))
    n_fit = -(-ki // rows_fit)
    want = round(math.sqrt(ki * kj * dev.sms / n))
    slab_rows = -(-ki // min(ki, max(n_fit, want)))
    plan = Plan(-(-ki // slab_rows), slab_rows, 1, 1)
    blocks = dev.resident(CLUSTER_CHUNKS, plan.smem_bytes(kj))
    chunks = max(1, min(blocks // plan.n_slabs, -(-n // CHUNK_ROWS)))
    cy = CLUSTER_CHUNKS if chunks >= CLUSTER_CHUNKS else 1
    chunks = chunks // cy * cy
    return plan._replace(n_chunks=chunks, cy=cy)


def hist2d(bi, bj, weights, ki: int, kj: int):
    """Weighted 2-D histogram: (N,) indices/weights -> (KI, KJ) fp32.

    ``H[a, b] = sum_n w_n [clip(bi_n) == a][clip(bj_n) == b]``. Indices of
    any integer dtype are cast to int32 and weights of any dtype to fp32, as
    the reference's wrapper does. A CUDA tensor goes to ``csrc/hist2d.cu``
    (KJ at most ``MAX_KJ``), a CPU tensor to ``ref.py``; ``n = 0`` gives
    zeros without a launch.

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
        n = w.shape[0]
        if not n:
            return torch.zeros((ki, kj), dtype=torch.float32, device=dev)
        return _launch(bi.contiguous(), bj.contiguous(), w.contiguous(), ki,
                       kj, _device_plan(n, ki, kj, dev.index))
    if dev.type == "cpu":
        return hist2d_ref(bi, bj, w, ki, kj)
    raise ValueError(f"unsupported device {dev}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The loaded kernel library (built and bound once)."""
    return loader.library("hist2d")


@functools.lru_cache(maxsize=None)
def _device(index: int) -> Device:
    """CUDA device ``index`` as the planner sees it, queried once; the
    first query also sets the kernel's shared-memory ceiling there."""
    lib = _entry()
    smem, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        loader.check(lib.hist2d_device(ctypes.byref(smem), ctypes.byref(sms)),
                     "hist2d_device")

    @functools.lru_cache(maxsize=None)
    def resident(cy: int, smem_bytes: int) -> int:
        got = ctypes.c_int()
        with torch.cuda.device(index):
            loader.check(lib.hist2d_resident(cy, smem_bytes,
                                             ctypes.byref(got)),
                         "hist2d_resident")
        return got.value

    return Device(sms.value, smem.value, resident)


@functools.lru_cache(maxsize=1024)
def _device_plan(n: int, ki: int, kj: int, index: int) -> Plan:
    """``_plan`` on CUDA device ``index``, once a shape."""
    return _plan(n, ki, kj, _device(index))


def _launch(bi, bj, w, ki: int, kj: int, plan: Plan):
    """Launch ``hist2d_launch`` by ``plan`` on contiguous int32/fp32 CUDA
    vectors of one length n >= 1; the output is zeroed only where the plan
    adds into it. The C entry checks the plan; a refused launch raises."""
    dev = w.device
    alloc = torch.zeros if plan.zero_fill else torch.empty
    out = alloc((ki, kj), dtype=torch.float32, device=dev)
    index = dev.index
    args = (bi.data_ptr(), bj.data_ptr(), w.data_ptr(), out.data_ptr(),
            w.shape[0], ki, kj, *plan,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        status = _entry().hist2d_launch(*args)
    else:
        with torch.cuda.device(index):
            status = _entry().hist2d_launch(*args)
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
