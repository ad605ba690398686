"""Dispatch for the fused weightings: CUDA kernel or plain PyTorch.

The device of ``h_stack`` decides: a CUDA tensor launches the kernel of
``csrc/weightings.cu``, a CPU tensor runs ``ref.py``. ``beta`` may be a
NumPy array (per-query host data); it is moved to ``h_stack``'s device.

The fold travels as its ``(L, K1)`` int32 index (``fold_index``): the
kernel gathers where the reference multiplies by a one-hot matrix. The
public functions take either form and check what they are given;
``FastPath`` checks its cached stacks once (``check_stack``) and calls
``stacked_weightings``, which checks nothing.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.weightings.ref import (batched_weightings_ref,
                                                fused_weightings_ref)

launches = {"batched_weightings": 0, "fused_weightings": 0}
_TQ_MAX = 16       # queries a block of the kernel's phase A (a power of two)
_TAIL_MAX = 256    # threads a block of the kernel


def q_bucket(q: int) -> int:
    """Power-of-two bucketing rule for the query-batch dimension (UP to the
    next power of two, floor 8), kept from the reference for the serving
    layer's wave sizing. The CUDA kernel takes any Q and is not padded."""
    return max(8, 1 << (int(q) - 1).bit_length())


def fold_index(fold) -> torch.Tensor:
    """The (L, K1) int32 index of a one-hot (L, K1, K2) fold, on its device:
    the column of each row's 1, or -1 for an all-zero row. Raises
    ``ValueError`` for a value other than 0 or 1 or a row with more than one
    nonzero. On a CUDA tensor this costs a few launches and one copy back
    to the host (the check)."""
    fold = torch.as_tensor(fold)
    if fold.dim() != 3:
        raise ValueError(f"fold: need (L, K1, K2), got {tuple(fold.shape)}")
    nonzero = fold != 0
    flags = torch.stack([(nonzero & (fold != 1)).any(),
                         (nonzero.sum(-1) > 1).any()]).tolist()
    if flags[0]:
        raise ValueError("fold is not one-hot: a value other than 0 and 1")
    if flags[1]:
        raise ValueError("fold is not one-hot: a row with more than one "
                         "nonzero")
    if fold.shape[2] == 0:
        return torch.full(fold.shape[:2], -1, dtype=torch.int32,
                          device=fold.device)
    col = nonzero.to(torch.int8).argmax(-1)
    return torch.where(nonzero.any(-1), col, -1).to(torch.int32)


def _as_index(fold, dev) -> torch.Tensor:
    """A 2-D integer ``fold`` is the index; a 3-D one goes through
    ``fold_index``. An int32 index already contiguous on ``dev`` passes
    through without a tensor operation."""
    if isinstance(fold, torch.Tensor) and fold.dtype == torch.int32 \
            and fold.device == dev and fold.is_contiguous():
        return fold
    fold = torch.as_tensor(fold, device=dev)
    if fold.dim() == 2 and not fold.is_floating_point() \
            and fold.dtype != torch.bool:
        return fold.to(torch.int32).contiguous()
    if fold.dim() == 3:
        return fold_index(fold)
    raise ValueError(f"fold: need an (L, K1) integer index or an "
                     f"(L, K1, K2) one-hot matrix, got {fold.dtype} "
                     f"{tuple(fold.shape)}")


def check_stack(h_stack, fold_idx, hx) -> tuple[int, int, int]:
    """Check the shared stacks of a launch: H (L, K2, K2) and hx (L, K2)
    fp32, the index (L, K1) int32, contiguous, on one device. Returns
    (L, K1, K2)."""
    dev = h_stack.device
    for name, t, dtype in (("h_stack", h_stack, torch.float32),
                           ("fold_idx", fold_idx, torch.int32),
                           ("hx", hx, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    el, k2 = hx.shape
    k1 = fold_idx.shape[1] if fold_idx.dim() == 2 else -1
    if h_stack.shape != (el, k2, k2) or fold_idx.shape != (el, k1):
        raise ValueError("weightings: inconsistent shapes "
                         f"{tuple(h_stack.shape)} {tuple(fold_idx.shape)} "
                         f"{tuple(hx.shape)}")
    return el, k1, k2


@functools.lru_cache(maxsize=1024)
def _plan(el: int, q: int, k1: int, k2: int,
          sms: int) -> tuple[int, int, bool]:
    """(queries, stack rows) of a phase-A block on a card with ``sms`` SMs,
    and whether phase B runs in the same launch: the query tile up to 16,
    then the largest row tile of 32, 16 or 8 that still gives every SM a
    block (8 when none does); phase B in the launch when a query tile has
    at most ``_TAIL_MAX`` outputs, one a thread of the block that does it."""
    tq = min(_TQ_MAX, 1 << max(0, q - 1).bit_length())
    q_tiles = -(-q // tq)
    for tr in (32, 16, 8):
        if -(-(el * k2) // tr) * q_tiles >= sms:
            break
    return tq, tr, min(q, tq) * k1 <= _TAIL_MAX


# Per (device, stream): phase A's scratch p and the tickets of a phase B
# run in the same launch (one int32 per query tile, which the kernel leaves
# at 0). Launches on one stream run one after another and each is done with
# both when it ends, so they share them; the buffers only grow.
_buffers: dict = {}


def _stream_buffers(dev, stream: int, n_tickets: int, n_scratch: int):
    tickets, scratch = _buffers.get((dev.index, stream), (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 64), dtype=torch.int32,
                              device=dev)
    if scratch is None or scratch.numel() < n_scratch:
        scratch = torch.empty(max(n_scratch, 1 << 16), dtype=torch.float32,
                              device=dev)
    _buffers[(dev.index, stream)] = tickets, scratch
    return tickets, scratch


@functools.lru_cache(maxsize=None)
def _device(index: int):
    """(SM count, bound C entry point) of CUDA device ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, loader.library("weightings").weightings_launch


def _launch(h_stack, beta, fold_idx, hx, out, counter: str):
    """The kernel on checked stacks: ``beta`` holds Q rows of (L, K2) fp32,
    contiguous on their CUDA device, and ``out`` Q rows of K1 (any shapes
    with those sizes); counts the launch under ``launches[counter]``."""
    el, k2 = hx.shape
    k1 = fold_idx.shape[1]
    q = out.numel() // k1 if k1 else 0
    if q == 0:
        return out
    if el == 0 or k2 == 0:
        return out.fill_(1.0 if el == 0 else 0.0)
    dev = h_stack.device
    sms, fn = _device(dev.index)
    tq, tr, fuse = _plan(el, q, k1, k2, sms)
    # The raw stream handle (what ``current_stream(dev).cuda_stream`` gives,
    # without building a Stream object on every launch).
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets, scratch = _stream_buffers(dev, stream, -(-q // tq), q * el * k2)
    args = (h_stack.data_ptr(), beta.data_ptr(), fold_idx.data_ptr(),
            hx.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr() if fuse else None,
            el, q, k1, k2, tq, tr, stream)
    if dev.index == torch.cuda.current_device():
        status = fn(*args)
    else:
        with torch.cuda.device(dev):
            status = fn(*args)
    loader.check(status, "weightings_launch")
    launches[counter] += 1
    return out


def stacked_weightings(h_stack, beta, fold_idx, hx, counter: str, out=None):
    """Weightings on stacks that ``check_stack`` accepted, for a caller
    that checked them once: beta (Q, L, K2) fp32 contiguous on their device
    -> (Q, K1), written into ``out`` when given. A CUDA launch counts under
    ``launches[counter]``; the CPU runs the plain version."""
    if h_stack.device.type == "cuda":
        if out is None:
            out = torch.empty((beta.shape[0], fold_idx.shape[1]),
                              dtype=torch.float32, device=h_stack.device)
        return _launch(h_stack, beta, fold_idx, hx, out, counter)
    got = batched_weightings_ref(h_stack, beta, fold_idx, hx)
    return got if out is None else out.copy_(got)


def _checked(h_stack, beta, fold, hx, batched: bool):
    """Check the public functions' inputs; returns beta (fp32, contiguous,
    on the stack's device) and the fold's index."""
    dev = h_stack.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    fold_idx = _as_index(fold, dev)
    el, _k1, k2 = check_stack(h_stack, fold_idx, hx)
    if not (isinstance(beta, torch.Tensor) and beta.dtype == torch.float32
            and beta.device == dev):
        beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    want = (el, k2)
    if batched:
        want = (beta.shape[0] if beta.dim() == 3 else -1,) + want
    if tuple(beta.shape) != want:
        raise ValueError(f"beta: need {want}, got {tuple(beta.shape)}")
    return beta.contiguous(), fold_idx


def fused_weightings(h_stack, beta, fold, hx):
    """Single-query weightings: beta (L, K2) -> (K1,) fp32. See ref.py.

    ``fold`` is the (L, K1) integer index or the reference's (L, K1, K2)
    one-hot matrix; a matrix is converted by ``fold_index`` on every call,
    which costs extra device work and a copy back to the host."""
    beta, fold_idx = _checked(h_stack, beta, fold, hx, batched=False)
    if h_stack.device.type == "cpu":
        return fused_weightings_ref(h_stack, beta, fold_idx, hx)
    out = torch.empty(fold_idx.shape[1], dtype=torch.float32,
                      device=h_stack.device)
    return _launch(h_stack, beta, fold_idx, hx, out, "fused_weightings")


def batched_weightings(h_stack, beta, fold, hx):
    """Query-batched weightings: beta (Q, L, K2) -> (Q, K1) fp32.

    One launch for a whole plan-shape group: H, fold and hx are shared,
    only beta varies per query. ``fold`` as in ``fused_weightings``. See
    ref.py for the semantics.
    """
    beta, fold_idx = _checked(h_stack, beta, fold, hx, batched=True)
    if h_stack.device.type == "cpu":
        return batched_weightings_ref(h_stack, beta, fold_idx, hx)
    return stacked_weightings(h_stack, beta, fold_idx, hx,
                              "batched_weightings")
