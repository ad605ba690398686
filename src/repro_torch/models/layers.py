"""Layer library for the 10 assigned architectures.

The port of ``src/repro/models/layers.py``. Each layer is an ``nn.Module``
that holds its parameters in the reference's layouts (``wq (d, h, dh)``,
``wo (h, dh, d)``, ``w1 (d, f)``, MoE ``w1 (e, d, f)``, ...) and an apply
function with the reference's name that takes the module in place of the
reference's parameter dict. Matmul weights live in the activation dtype
unless the layer is built with another ``dtype`` (training builds them in
f32, the reference's masters); every apply function casts them to the
activation dtype where it uses them, as the reference does. Norm scales,
the router, ``A_log``, ``dt_bias``, ``D`` and ``lam`` are f32.

Attention is chunked: f32 scores per query chunk, never (S, S). Caches are
preallocated tensors written in place; the position of the next token is
a Python int shared by every slot.

Each layer has the reference's ``*_axes`` function (the logical axes of
its parameters or cache leaves) and ``constrain``s its activations where
the reference does; without a mesh (``sharding.set_mesh``) both change
nothing, with one the parameters, caches and activations are DTensors.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import (apply_rope, gelu, make_rope,
                                       rms_norm, sigmoid, silu, softcap,
                                       softplus, trunc_normal_)
from repro_torch.sharding import constrain, get_mesh, placements


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _act(cfg):
    return gelu if cfg.mlp_act == "gelu" else silu


# The residual stream's logical axes, where the layers' outputs go.
RESID = ("batch", "resid_seq", "resid_embed")


# ---------------------------------------------------------------------------
# Attention (GQA/MQA, optional qk-norm / soft-capping / local window)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Parameters ``wq (d, h, dh)``, ``wk``/``wv (d, hkv, dh)``,
    ``wo (h, dh, d)`` and, with ``qk_norm``, ``q_norm``/``k_norm (dh,)``."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        dt = dtype or cfg.act_dtype
        self.wq = _param((d, h, dh), dt, device)
        self.wk = _param((d, hkv, dh), dt, device)
        self.wv = _param((d, hkv, dh), dt, device)
        self.wo = _param((h, dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = _param((dh,), torch.float32, device)
            self.k_norm = _param((dh,), torch.float32, device)

    def reset_parameters(self, cfg, generator) -> None:
        """The reference's ``init_attention``, drawn from ``generator``."""
        std = 1.0 / math.sqrt(cfg.d_model)
        for w in (self.wq, self.wk, self.wv):
            trunc_normal_(w, std, generator)
        trunc_normal_(self.wo, 1.0 / math.sqrt(cfg.n_heads * cfg.head_dim),
                      generator)
        if cfg.qk_norm:
            with torch.no_grad():
                self.q_norm.zero_()
                self.k_norm.zero_()


def attention_axes(cfg):
    return {
        "wq": ("fsdp", "heads", None),
        "wk": ("fsdp", "kv_heads", None),
        "wv": ("fsdp", "kv_heads", None),
        "wo": ("heads", None, "fsdp"),
        **({"q_norm": (None,), "k_norm": (None,)} if cfg.qk_norm else {}),
    }


_NEG_POS = -(2**30)


def _chunked_attention(q, k, v, *, q_positions, kv_positions, window, cap,
                       chunk):
    """Blockwise causal attention with explicit absolute positions.

    q: (B, Sq, Hkv, G, dh); k/v: (B, Skv, Hkv, dh).
    q_positions: (Sq,) int32; kv_positions: (Skv,) int32 (ring caches carry
    stale slots with very negative positions -> masked automatically).
    Returns (B, Sq, Hkv, G, dh). Scores are per-chunk f32 (never (S, S)).

    K and V are laid out for the products once, f32 K as (B Hkv, dh, Skv)
    and V as (B Hkv, Skv, dh), and every chunk multiplies views of them,
    its query rows grouped as (B Hkv, G c, dh): autograd keeps one copy
    of K and V for all chunks and no permuted copy of the probabilities,
    and only each chunk's output is permuted.
    """
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, sq)
    if sq % chunk != 0:  # ragged (smoke-test) sizes: single chunk
        chunk = sq
    n_chunks = max(sq // chunk, 1)
    kt = _f32_contiguous(k.permute(0, 2, 3, 1)).view(b * hkv, dh, skv)
    v32 = _f32_contiguous(v.permute(0, 2, 1, 3)).view(b * hkv, skv, dh)
    kv_pos = kv_positions[None, :]
    outs = []
    for c in range(n_chunks):
        qc = _f32_contiguous(q[:, c * chunk:(c + 1) * chunk]
                             .permute(0, 2, 3, 1, 4)).view(b * hkv,
                                                           g * chunk, dh)
        q_pos = q_positions[c * chunk:(c + 1) * chunk, None]
        s = torch.bmm(qc, kt).view(b, hkv, g, chunk, skv) * scale
        if cap is not None:
            s = softcap(s, cap)
        causal = (kv_pos <= q_pos) & (kv_pos >= 0)  # unwritten ring slots < 0
        if window is not None:
            causal &= kv_pos > (q_pos - window)
        s = torch.where(causal, s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = torch.bmm(p.view(b * hkv, g * chunk, skv), v32)
        outs.append(out.view(b, hkv, g, chunk, dh).permute(0, 3, 1, 2, 4)
                    .to(q.dtype))
    return outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)


def _f32_contiguous(t):
    """``t`` in f32, contiguous, in one copy at most."""
    return t.to(torch.float32, memory_format=torch.contiguous_format) \
        .contiguous()


def _attention(q, k, v, **kw):
    """Attention of q (B, Sq, H, dh) over k/v (B, Skv, Hkv, dh), query head
    i reading kv head i // (H / Hkv); returns (B, Sq, H, dh).

    ``_chunked_attention`` on the grouped heads (``_grouped_attention``);
    on DTensors (under a mesh) each rank runs it on its shards
    (``local_map``): batch and heads split the work. Where a mesh dim
    shards the query heads but not the kv heads (its size does not divide
    Hkv), q stays split there and K/V come whole: each rank holds H / M
    contiguous query heads and reads the kv heads they need, so its K/V
    gradients are partial sums over that dim (``in_grad_placements``). A
    key/value sequence sharded over a mesh dim (the ``kv_seq`` cache,
    decoding) is combined by a distributed softmax
    (``_seq_sharded_attention``); q is whole on that dim, since each rank
    attends every head over its slice of the sequence."""
    g = q.shape[2] // k.shape[2]
    if get_mesh() is None or not hasattr(q, "placements"):
        return _grouped_attention(q, k, v, g=g, **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q_pl, kv_pl, seq_dims, split = [], [], [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pk.is_shard(1):     # decoding: q whole for the distributed softmax
            seq_dims.append(i)
            q_pl.append(Replicate())
            kv_pl.append(Shard(1))
        elif pk.is_shard(2) or (pq.is_shard(2)
                                and k.shape[2] % mesh.size(i) == 0):
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2))
        elif pq.is_shard(2):
            split.append(i)
            q_pl.append(Shard(2))
            kv_pl.append(Replicate())
        elif pq.is_shard(0) or pk.is_shard(0):
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    kv_grad = [Partial() if i in split else pl for i, pl in enumerate(kv_pl)]
    if len(seq_dims) > 1 or (seq_dims and split):
        raise NotImplementedError("a key/value sequence sharded over more "
                                  "than one mesh dim, or beside query "
                                  "heads split within a kv group")
    q, k, v = (t.redistribute(mesh, pl) for t, pl in
               ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    rep = [Replicate()] * mesh.ndim
    q_pos, kv_pos = (_replicated(t, mesh) for t in
                     (kw.pop("q_positions"), kw.pop("kv_positions")))
    if seq_dims:
        (dim,) = seq_dims
        lo = mesh.get_local_rank(dim) * (k.shape[1] // mesh.size(dim))
        fn = functools.partial(_seq_sharded_attention,
                               group=mesh.get_group(dim), lo=lo, **kw)
    else:
        fn = functools.partial(
            _grouped_attention, g=g,
            q_lo=_shard_offset(mesh, q_pl, 2, q.shape[2]),
            kv_lo=_shard_offset(mesh, kv_pl, 2, k.shape[2]), **kw)
    return local_map(fn, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl, rep, rep),
                     in_grad_placements=(q_pl, kv_grad, kv_grad, rep, rep),
                     device_mesh=mesh)(q, k, v, q_pos, kv_pos)


def _shard_offset(mesh, pls, dim: int, n: int) -> int:
    """The global index of this rank's first element along tensor dim
    ``dim`` (of size ``n``) under placements ``pls``."""
    lo = 0
    for i, pl in enumerate(pls):
        if pl.is_shard(dim):
            n //= mesh.size(i)
            lo += mesh.get_local_rank(i) * n
    return lo


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _grouped_attention(q, k, v, q_positions, kv_positions, *, g: int,
                       q_lo: int = 0, kv_lo: int = 0, **kw):
    """``_chunked_attention`` of query heads ``[q_lo, q_lo + Hq)`` (q:
    (B, Sq, Hq, dh)) over the kv heads from ``kv_lo`` on (k/v: (B, Skv,
    n, dh)), query head i reading kv head i // g; returns (B, Sq, Hq, dh).
    Where the query heads do not start and end on a group's edge (a rank's
    share of the heads split within a group), the range is cut at the
    edges into a partial group at each end and whole groups between, each
    attended with its own kv heads."""
    b, sq, hq, dh = q.shape
    hi = q_lo + hq
    first = min(-(-q_lo // g) * g, hi)      # the first group edge in range
    last = max(hi // g * g, first)          # the last one
    outs = []
    for lo, up in ((q_lo, first), (first, last), (last, hi)):
        if up <= lo:
            continue
        n_kv = (up - lo) // g if (lo, up) == (first, last) else 1
        kv = lo // g - kv_lo
        out = _chunked_attention(
            q[:, :, lo - q_lo:up - q_lo].reshape(b, sq, n_kv, -1, dh),
            k[:, :, kv:kv + n_kv], v[:, :, kv:kv + n_kv],
            q_positions=q_positions, kv_positions=kv_positions, **kw)
        outs.append(out.reshape(b, sq, up - lo, dh))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _seq_sharded_attention(q, k, v, q_positions, kv_positions, *, group,
                           lo: int, window, cap, chunk):
    """Attention of ``q`` (B, Sq, H, dh) over this rank's slice ``[lo, lo
    + Skv_local)`` of the key/value sequence, combined over ``group`` (the
    ranks holding the other slices): the max and the sums of the softmax
    are all-reduced (a distributed softmax), as the reference's decode
    over a sequence-sharded cache does. Forward only (decoding)."""
    from torch.distributed import _functional_collectives as funcol
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    kv_pos = kv_positions[lo:lo + k.shape[1]][None, :]
    q_pos = q_positions[:, None]
    s = torch.einsum("bchgd,bshd->bhgcs",
                     q.reshape(b, sq, hkv, h // hkv, dh).float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    if cap is not None:
        s = softcap(s, cap)
    causal = (kv_pos <= q_pos) & (kv_pos >= 0)
    if window is not None:
        causal &= kv_pos > (q_pos - window)
    s = torch.where(causal, s, -1e30)
    m = funcol.wait_tensor(funcol.all_reduce(
        torch.amax(s, -1, keepdim=True), "max", group))
    p = torch.exp(s - m)
    den = funcol.wait_tensor(funcol.all_reduce(p.sum(-1), "sum", group))
    num = funcol.wait_tensor(funcol.all_reduce(
        torch.einsum("bhgcs,bshd->bhgcd", p, v.float()), "sum", group))
    out = num / den[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def attention_apply(p, x, cfg, *, local: bool, cache=None, cache_index=None):
    """Full-sequence path when cache is None; else cached prefill/decode.

    cache: dict(k/v=(B, S_eff, Hkv, dh), pos=(S_eff,) i32), written in
    place. Local-attention caches are ring buffers of size window; writes
    go to index % S_eff and masking relies on the stored absolute
    positions. cache_index: the position of x's first token (an int).
    Returns the output (B, S, d).
    """
    s, dh = x.shape[1], cfg.head_dim
    window = cfg.window if local else None

    kv_axes = ("batch", None, "kv_heads", None)
    q, k, v = _project(x, [w.to(x.dtype) for w in (p.wq, p.wk, p.wv)],
                       [("batch", None, "heads", None), kv_axes, kv_axes])
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if cache_index is not None:
        positions = positions + cache_index
    cos, sin = make_rope(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

    if cache is None or s > 1:
        # Full sequence, or prefill from an empty cache: attend within the
        # prompt itself; the cache receives the tail needed for decoding.
        out = _attention(q, k, v, q_positions=positions,
                         kv_positions=positions, window=window,
                         cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
        if cache is not None:
            eff = cache["k"].shape[1]
            take = min(s, eff)
            # Ring invariant: position p lives in slot p % eff, so later
            # decode writes (at index % eff) overwrite the right slots.
            _ring_write(cache, 0, k[:, -take:], v[:, -take:],
                        positions[-take:], shift=(s - take) % eff)
    else:
        # Single-token decode: ring write at index % eff, mask by positions.
        eff = cache["k"].shape[1]
        _ring_write(cache, cache_index % eff, k, v, positions)
        out = _attention(q, cache["k"], cache["v"], q_positions=positions,
                         kv_positions=cache["pos"], window=window,
                         cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
    (out,) = _project(out, [p.wo.to(x.dtype)],
                      [("batch", "resid_seq", "resid_embed")], n_in=2)
    return constrain(out, "batch", "resid_seq", "resid_embed")


def _project(x, ws, out_axes, n_in: int = 1, split_cols: bool = True,
             logits: bool = False):
    """``x`` (B, S, *c) times each weight of ``ws`` (*c, *n), contracted
    over c (``x``'s last ``n_in`` dims) in one 2-D product: a list of
    (B, S, *n), one a weight, whose logical axes ``out_axes`` lists.

    On DTensors (under a mesh) each rank multiplies the shards that the
    reference's placements give it: ``local_map`` with the placements of
    ``_project_placements``, stated per mesh dim rather than left to
    DTensor's strategies, x redistributed once for all of ``ws``. Each
    product is then redistributed to its axes (split columns gathered,
    partial sums reduce-scattered or all-reduced), and every input's
    gradient comes back in the input's own placements. ``split_cols``
    False keeps a weight's columns whole where its placements leave them
    whole (the router's, as the reference does). ``logits`` marks the
    tied logits' product: a split sequence of x is gathered, as the
    reference gathers it there, and x is gathered inside the product
    where a mesh dim wider than one splits it, only its shard kept for
    the backward pass, which gathers it again (outside the remat a
    gathered x would stay live until the loss's backward pass)."""
    b, s = x.shape[:2]
    shapes = [w.shape[n_in:] for w in ws]
    flat = [w if w.dim() == 2 else _single_whole(w).reshape(
        math.prod(w.shape[:n_in]), -1) for w in ws]
    if get_mesh() is None or not hasattr(x, "placements"):
        outs = _matmuls(x, *flat)
    else:
        outs = _project_local(x, flat, [
            placements(ax, (b, s, *n)) for ax, n in zip(out_axes, shapes)],
            split_cols, logits)
    return [o if len(n) == 1 else o.view(b, s, *n)
            for o, n in zip(outs, shapes)]


def _single_whole(w):
    """``w``, on DTensors whole on every mesh dim of size 1: a DTensor's
    view cannot merge a sharded dim of size 1 (one kv head's on a one-wide
    mesh dim), and there a split is the whole tensor anyway."""
    if not hasattr(w, "placements"):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    return _placed(w, [Replicate() if mesh.size(i) == 1 else pl
                       for i, pl in enumerate(w.placements)])


def _project_local(x, ws, targets, split_cols: bool = True,
                   logits: bool = False):
    """``_project``'s products on DTensors: ``x`` (B, S, *c) times the 2-D
    weights ``ws``, each product brought to its placements in
    ``targets``. For the ``logits``, ``_gathered_matmuls`` gathers x
    inside the product wherever a mesh dim wider than one splits it and
    the product wants it whole or gathered along the sequence."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = [_project_placements(x.placements, w.placements, w.shape[1],
                                mesh.shape, split_cols, logits) for w in ws]
    if any(r[0] != rows[0][0] for r in rows):   # x placed otherwise: apart
        return tuple(o for w, t in zip(ws, targets)
                     for o in _project_local(x, [w], [t], split_cols,
                                             logits))
    x_pl, _, _, x_grad, _ = rows[0]
    fn = _matmuls
    for i, (now, want) in enumerate(zip(x.placements, x_pl)):
        whole = want.is_shard(1)       # the sequence gathered, products whole
        if logits and (whole or (mesh.size(i) > 1 and
                                 isinstance(now, Shard) and now.dim > 0 and
                                 not want.is_shard())):
            fn = functools.partial(
                _gathered_matmuls, group=mesh.get_group(i), dim=now.dim,
                lo=mesh.get_local_rank(i) * (x.shape[now.dim] // mesh.size(i)),
                whole=whole)
            x_pl, x_grad = list(x_pl), list(x_grad)
            x_pl[i] = x_grad[i] = now
    outs = local_map(fn, out_placements=tuple(r[2] for r in rows),
                     in_placements=(x_pl,) + tuple(r[1] for r in rows),
                     in_grad_placements=(x_grad,) + tuple(r[4] for r in rows),
                     device_mesh=mesh)(
        _placed(x, x_pl),
        *(w.redistribute(mesh, r[1]) for w, r in zip(ws, rows)))
    return tuple(o.redistribute(mesh, t) for o, t in zip(outs, targets))


def _placed(x, pls):
    """The DTensor ``x`` on placements ``pls``: ``x`` itself where it is
    on them already. A redistribute to its own placements would bring a
    gradient that is a partial sum back to them (an all-reduce); without
    it the partial sums of every consumer add up and are reduced once,
    where ``x`` was placed."""
    if tuple(x.placements) == tuple(pls):
        return x
    return x.redistribute(x.device_mesh, pls)


def _project_placements(x_pls, w_pls, cols: int, sizes,
                        split_cols: bool = True, gather_seq: bool = False):
    """The placements of one of ``_project``'s products on each mesh dim
    (of sizes ``sizes``): (x, the 2-D weight, the (B, S, N) product, x's
    gradient, the weight's gradient), each a list over the mesh dims.

    * A dim that splits x's tokens (batch, or sequence without
      ``gather_seq``) keeps them split and gathers the weight; the
      weight's gradients are partial sums.
    * Column parallel: where the dim splits the weight's columns (q on
      ``heads``, ``w1``/``w3`` on ``tensor``, the tied logits on
      ``vocab``), or the weight is whole on it and its columns divide
      evenly (K/V whose heads the dim does not divide; their products are
      gathered whole after; not with ``split_cols`` False), x is gathered
      and each rank multiplies its columns; x's gradients are partial
      sums.
    * With ``gather_seq`` (the logits under ``seq_sp``), a dim that
      splits x's sequence and not the weight: x is gathered and each rank
      computes the whole product; in the backward pass x's gradient and
      the weight's (a partial sum) from its own tokens only
      (``_gathered_matmuls``; x's placements there are its own), as the
      reference's partitioned HLO does at full width.
    * Row parallel: where the dim splits the weight's rows (``wo`` on
      ``heads``, ``w2`` on ``tensor``), or x's first contracted dim while
      the weight's columns stay whole, x and the rows split alike and the
      products are partial sums.
    * Else both are whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rows = []
    for px, pw, size in zip(x_pls, w_pls, sizes):
        if px.is_shard(0) or (px.is_shard(1) and not gather_seq):
            rows.append((px, Replicate(), px, px, Partial()))
        elif pw.is_shard(1) or (split_cols and not pw.is_shard()
                                and cols % size == 0):
            rows.append((Replicate(), Shard(1), Shard(2), Partial(),
                         Shard(1)))
        elif px.is_shard(1):
            rows.append((px, Replicate(), Replicate(), px, Partial()))
        elif pw.is_shard(0) or px.is_shard(2):
            rows.append((Shard(2), Shard(0), Partial(), Shard(2), Shard(0)))
        else:
            rows.append((Replicate(),) * 5)
    return tuple(list(col) for col in zip(*rows))


def _matmuls(x, *ws):
    """``x`` (B, S, *c), its last dims flattened, @ each 2-D weight of
    ``ws``: a tuple of (B, S, N)."""
    if x.dim() > 3:
        x = x.flatten(2)
    return tuple(x @ w for w in ws)


def _gathered_matmuls(x, *ws, group, dim: int, lo: int, whole: bool):
    """``_matmuls`` of ``x`` (B, S, c) gathered along ``dim`` over
    ``group`` (this rank's shard starts at ``lo``): the sequence (1) or
    the contracted d_model (2). Only x's shard is kept for the backward
    pass. With ``whole`` products (the weights whole, the sequence
    gathered) the gradients come from this rank's tokens only, the
    weights' partial sums; else (each rank's columns) x is gathered again
    for the weights' gradients, and x's partial sums are reduce-scattered
    along ``dim``."""
    return _GatheredMatmuls.apply(x, group, dim, lo, whole, *ws)


def _gather(x, dim: int, group):
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x, dim, group))


def _reduce_scatter(x, dim: int, group):
    from torch.distributed import _functional_collectives as funcol
    scatter = getattr(funcol, "reduce_scatter_single", None) or \
        funcol.reduce_scatter_tensor
    return funcol.wait_tensor(scatter(x, "sum", dim, group))


class _GatheredMatmuls(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, lo, whole, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.group, ctx.dim, ctx.lo, ctx.whole = group, dim, lo, whole
        return _matmuls(_gather(x, dim, group), *ws)

    @staticmethod
    def backward(ctx, *grads):
        x, *ws = ctx.saved_tensors
        if ctx.whole:
            grads = [g[:, ctx.lo:ctx.lo + x.shape[1]] for g in grads]
            rows = x.flatten(0, 1)
            dx = sum(g @ w.T for g, w in zip(grads, ws))
        else:
            rows = _gather(x, ctx.dim, ctx.group).flatten(0, 1)
            dx = _reduce_scatter(sum(g @ w.T for g, w in zip(grads, ws)),
                                 ctx.dim, ctx.group)
        return (dx, None, None, None, None,
                *(rows.T @ g.flatten(0, 1) for g in grads))


def _ring_write(cache: dict, slot: int, k, v, positions,
                shift: int = 0) -> None:
    """Write ``k``/``v`` (B, n, Hkv, dh) and ``positions`` (n,), each
    rolled by ``shift`` along the sequence, into the cache's slots ``slot ..
    slot + n``, in place. Under a mesh the cache is a DTensor and each
    rank writes its own shard's part of the slots (``_write_local``): a
    slice of a sharded dim is not a view of it."""
    n = k.shape[1]
    if get_mesh() is None:
        if shift:
            k, v = (torch.roll(t, shift, dims=1) for t in (k, v))
            positions = torch.roll(positions, shift, dims=0)
        cache["k"][:, slot:slot + n] = k
        cache["v"][:, slot:slot + n] = v
        cache["pos"][slot:slot + n] = positions
        return
    from torch.distributed.tensor import DTensor, Replicate
    for key, new in (("k", k), ("v", v), ("pos", positions)):
        dst = cache[key]
        if not isinstance(new, DTensor):  # positions: the same on every rank
            new = DTensor.from_local(new, dst.device_mesh,
                                     [Replicate()] * dst.device_mesh.ndim,
                                     run_check=False)
        _write_local(dst, new, 0 if key == "pos" else 1, slot, shift)


def _write_local(dst, new, dim: int, slot: int, shift: int) -> None:
    """``dst[..., slot:slot + n, ...] = roll(new, shift)`` along ``dim`` on
    DTensors: ``new`` is brought to ``dst``'s placements but on ``dim``,
    which it keeps whole (replicated on the mesh dims that shard ``dim``
    in ``dst``) and is rolled locally (DTensor has no ``roll`` strategy on
    some PyTorch releases); each rank copies the rows of the slots that
    its shard of ``dst`` holds."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
            for pl in dst.placements]
    src = new.redistribute(mesh, want).to_local()
    if shift:
        src = torch.roll(src, shift, dim)
    local = dst.to_local()
    lo, size = 0, dst.shape[dim]
    for mdim, pl in enumerate(dst.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size //= mesh.size(mdim)
            lo += mesh.get_local_rank(mdim) * size
    a, b = max(slot, lo), min(slot + new.shape[dim], lo + size)
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(src.narrow(dim, a - slot,
                                                          b - a))


def attention_cache_axes():
    # "kv_seq" is the fallback shard axis when kv heads don't divide the
    # tensor axis (the dry run's rules enable exactly one of kv_heads and
    # kv_seq).
    return {"k": ("batch", "kv_seq", "kv_heads", None),
            "v": ("batch", "kv_seq", "kv_heads", None),
            "pos": (None,)}


def attention_cache(cfg, batch: int, max_len: int, dtype, local: bool = False,
                    device=None) -> dict:
    """Zeroed k/v (B, S_eff, Hkv, dh) and positions marked unwritten;
    local layers keep a ring of ``min(max_len, window)`` slots. ``device``
    ``None`` means CUDA, as for every cache constructor here."""
    device = resolve_device(device)
    eff = max_len
    if local and cfg.window:
        eff = min(max_len, cfg.window)
    shape = (batch, eff, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((eff,), _NEG_POS, dtype=torch.int32,
                              device=device)}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Parameters ``w1``/``w3 (d, f)`` and ``w2 (f, d)``."""

    def __init__(self, cfg, d_ff=None, device=None, dtype=None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, dtype or cfg.act_dtype
        self.w1 = _param((d, f), dt, device)
        self.w3 = _param((d, f), dt, device)
        self.w2 = _param((f, d), dt, device)

    def reset_parameters(self, cfg, generator) -> None:
        """The reference's ``init_mlp``, drawn from ``generator``."""
        d, f = self.w1.shape
        trunc_normal_(self.w1, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.w3, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.w2, 1.0 / math.sqrt(f), generator)


def mlp_axes():
    return {"w1": ("fsdp", "tensor"), "w3": ("fsdp", "tensor"),
            "w2": ("tensor", "fsdp")}


def mlp_apply(p, x, cfg):
    """SwiGLU (``mlp_act="silu"``) or GeGLU with the tanh GELU."""
    act = _act(cfg)
    ff_axes = ("batch", None, "tensor")
    h1, h3 = _project(x, [p.w1.to(x.dtype), p.w3.to(x.dtype)],
                      [ff_axes, ff_axes])
    hcur = constrain(act(h1) * h3, *ff_axes)
    (out,) = _project(hcur, [p.w2.to(x.dtype)],
                      [("batch", "resid_seq", "resid_embed")])
    return out


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-based dispatch)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """Parameters ``router (d, e)`` (f32), ``w1``/``w3 (e, d, f)``,
    ``w2 (e, f, d)`` and, with ``n_shared``, a ``shared`` MLP."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        d, e, f, dt = cfg.d_model, cfg.n_experts, cfg.d_ff_expert, \
            dtype or cfg.act_dtype
        self.router = _param((d, e), torch.float32, device)
        self.w1 = _param((e, d, f), dt, device)
        self.w3 = _param((e, d, f), dt, device)
        self.w2 = _param((e, f, d), dt, device)
        if cfg.n_shared > 0:
            self.shared = MLP(cfg, d_ff=cfg.d_ff_expert * cfg.n_shared,
                              device=device, dtype=dt)

    def reset_parameters(self, cfg, generator) -> None:
        """The reference's ``init_moe``, drawn from ``generator``."""
        d, f = cfg.d_model, cfg.d_ff_expert
        trunc_normal_(self.router, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.w1, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.w3, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.w2, 1.0 / math.sqrt(f), generator)
        if cfg.n_shared > 0:
            self.shared.reset_parameters(cfg, generator)


def moe_axes(cfg):
    ax = {
        "router": ("fsdp", None),
        "w1": ("expert", "fsdp", None),
        "w3": ("expert", "fsdp", None),
        "w2": ("expert", None, "fsdp"),
    }
    if cfg.n_shared > 0:
        ax["shared"] = mlp_axes()
    return ax


def moe_apply(p, x, cfg):
    """Top-k MoE FFN. Two dispatch implementations (cfg.moe_impl):

    "einsum" (baseline): one-hot dispatch/combine einsums.
    "sort": tokens sorted by expert id, placed into (E, C) buffers by
    gathers, combined by a scatter-add.

    Tokens past an expert's capacity fall through the residual.

    On DTensors (under a mesh) the routed experts run through
    ``_moe_routed``: each rank dispatches its batch rows to the experts it
    holds and combines their outputs into a partial sum, which is
    reduce-scattered to the residual stream. The block input gathered
    there also feeds the shared experts."""
    top_p, top_e, cap = _moe_router(p, x, cfg)
    local = _moe_sort_local if cfg.moe_impl == "sort" else _moe_einsum_local
    xg = _moe_input(x)
    out = _moe_routed(functools.partial(local, cap=cap, act=_act(cfg)), xg,
                      top_p, top_e,
                      [w.to(x.dtype) for w in (p.w1, p.w3, p.w2)])
    out = constrain(out, "batch", "resid_seq", "resid_embed")
    if cfg.n_shared > 0:
        out = out + mlp_apply(p.shared, xg, cfg)
    return constrain(out, "batch", "resid_seq", "resid_embed")


def _moe_router(p, x, cfg):
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(s * k / e * cfg.capacity_factor))
    cap = min(max(cap, 4), s)
    # Under a mesh the reference keeps the router's columns whole: a
    # partial sum over x's split d_model, all-reduced.
    (logits,) = _project(x.float(), [p.router.float()],
                         [("batch", None, None)], split_cols=False)
    route = functools.partial(_route, k=k)
    if get_mesh() is not None and hasattr(logits, "placements"):
        # Each rank routes its own rows (``local_map``): DTensor's rule
        # for top-k's backward builds the global batch's probabilities on
        # some releases.
        from torch.distributed.tensor.experimental import local_map
        rows = list(logits.placements)
        route = local_map(route, out_placements=(rows, rows),
                          in_placements=(rows,),
                          device_mesh=logits.device_mesh)
    top_p, top_e = route(logits)
    return top_p, top_e, cap


def _route(logits, k: int):
    """The router's softmax over (B, S, E) ``logits``, its top ``k`` and
    their weights normalised: (top_p, top_e), each (B, S, k)."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e


def _moe_input(x):
    """``x`` (B, S, D) with its batch rows split as the ``batch`` axis
    splits them and whole on every other mesh dim (d_model gathered), on
    DTensors; else ``x``."""
    if get_mesh() is None or not hasattr(x, "placements"):
        return x
    return x.redistribute(x.device_mesh, placements(("batch", None, None),
                                                    x.shape))


def _moe_routed(local, x, top_p, top_e, ws):
    """The routed experts' output (B, S, D): ``local(x, top_p, top_e, w1,
    w3, w2, lo=0)`` on plain tensors.

    On DTensors ``local`` runs on each rank's shards (``local_map``),
    placed per mesh dim as the reference's ``constrain``s of the expert
    buffers place them (``"batch"``, ``"expert"``):

    * a dim that splits the batch rows keeps x, the router's choices and
      the output split on them; the experts' weights are whole in the
      products and their gradients are summed over the dim. Where the dim
      splits each weight along another dim than the experts' (d_model,
      ``fsdp``), ``local`` gets the shards and ``gather``, the dim's group
      and the split dims: each weight is gathered inside its product, in
      the forward and again in the backward pass, and its gradient is
      reduce-scattered to the shard there (``_expert_ffn``; one such mesh
      dim); else the weights are gathered before and their gradients are
      partial sums;
    * a dim that splits the experts (E / M each, from expert ``lo``) keeps
      x and the router's choices whole and the weights split; each rank
      dispatches to and combines from its own experts only, so the output
      and the gradients of x and of the gates are partial sums over the
      dim, the weights' gradients split;
    * any other dim (where M does not divide E, the rules leave the
      experts whole) keeps everything whole.

    x is redistributed to these placements unless it is on them already
    (``_moe_input`` puts it there once for these and the shared
    experts)."""
    if get_mesh() is None or not hasattr(x, "placements"):
        return local(x, top_p, top_e, *ws, lo=0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = placements(("batch", None, None), x.shape)
    experts = placements(("expert", None, None), ws[0].shape)
    x_grad, w_pl, w_grad, gather = [], [], [], None
    for i, (pr, pe) in enumerate(zip(rows, experts)):
        if pr.is_shard(0):
            x_grad.append(Shard(0))
            pls = [w.placements[i] for w in ws]
            if gather is None and mesh.size(i) > 1 and all(
                    pl.is_shard() and not pl.is_shard(0) for pl in pls):
                gather = (mesh.get_group(i), tuple(pl.dim for pl in pls))
                grads = pls
            else:
                pls, grads = [Replicate()] * 3, [Partial()] * 3
        elif pe.is_shard(0):
            x_grad.append(Partial())
            pls = grads = [Shard(0)] * 3
        else:
            x_grad.append(Replicate())
            pls = grads = [Replicate()] * 3
        w_pl.append(pls)
        w_grad.append(grads)
    w_pl, w_grad = list(zip(*w_pl)), list(zip(*w_grad))   # by weight
    top_p, top_e = (t.redistribute(mesh, rows) for t in (top_p, top_e))
    ws = [_placed(w, pl) for w, pl in zip(ws, w_pl)]
    fn = functools.partial(local, lo=_shard_offset(mesh, w_pl[0], 0,
                                                   ws[0].shape[0]),
                           gather=gather)
    return local_map(fn, out_placements=x_grad,
                     in_placements=(rows, rows, rows) + tuple(w_pl),
                     in_grad_placements=(x_grad, x_grad, rows)
                     + tuple(w_grad),
                     device_mesh=mesh)(_placed(x, rows), top_p, top_e, *ws)


def _expert_ffn(xe, w1, w3, w2, act, gather=None):
    """The experts' gated FFN on their rows ``xe`` (n, T, D), expert by
    expert: (n, T, D). Only ``xe`` and the two hidden products are held for
    the backward pass, which recomputes the gate's activation and its
    gradient a slice of rows at a time (``_GATE_SLICES``). With ``gather`` (a process group and the dim of each weight that it
    splits) the weights are this rank's shards: each is gathered inside its
    product, in the forward and again in the backward pass, and its
    gradient comes back reduce-scattered to the shard."""
    return _ExpertFFN.apply(xe, w1, w3, w2, act, gather)


# The backward pass's gate work runs on this many slices of the rows, so
# that its temporaries (the activation's autograd graph) stay a fraction of
# a hidden product's size; the forward pass, which holds none of them, runs
# it whole.
_GATE_SLICES = 8


def _row_slices(t):
    step = -(-t.shape[1] // _GATE_SLICES)
    return [slice(i, i + step) for i in range(0, t.shape[1], step)]


def _gated(act, h1, h3):
    """``act(h1) * h3``, a slice of rows at a time."""
    out = torch.empty_like(h1)
    for sl in _row_slices(h1):
        out[:, sl] = act(h1[:, sl]) * h3[:, sl]
    return out


def _gated_grads(act, h1, h3, g):
    """The gradients of ``act(h1) * h3`` for the gradient ``g``: (of h1, of
    h3), a slice of rows at a time."""
    gh1, gh3 = torch.empty_like(h1), torch.empty_like(h3)
    for sl in _row_slices(h1):
        with torch.enable_grad():
            h = h1[:, sl].detach().requires_grad_()
            a = act(h)
        gh3[:, sl] = g[:, sl] * a.detach()
        (gh1[:, sl],) = torch.autograd.grad(a, h, g[:, sl] * h3[:, sl])
    return gh1, gh3


def _whole(w, j: int, gather):
    """Weight ``j`` (w1, w3, w2) whole: gathered where ``gather`` splits
    it."""
    return w if gather is None else _gather(w, gather[1][j], gather[0])


def _shard_grad(g, j: int, gather):
    """The gradient ``g`` of weight ``j`` whole, reduce-scattered to the
    shard where ``gather`` splits the weight."""
    return g if gather is None else _reduce_scatter(g, gather[1][j],
                                                    gather[0])


class _ExpertFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xe, w1, w3, w2, act, gather):
        h1 = torch.bmm(xe, _whole(w1, 0, gather))
        h3 = torch.bmm(xe, _whole(w3, 1, gather))
        ctx.save_for_backward(xe, h1, h3, w1, w3, w2)
        ctx.act, ctx.gather = act, gather
        return torch.bmm(act(h1) * h3, _whole(w2, 2, gather))

    @staticmethod
    def backward(ctx, gy):
        xe, h1, h3, w1, w3, w2 = ctx.saved_tensors
        need, gather = ctx.needs_input_grad, ctx.gather
        gw1 = gw3 = gw2 = gxe = None
        if need[3]:
            gw2 = _shard_grad(_gated(ctx.act, h1, h3).transpose(1, 2)
                              .bmm(gy), 2, gather)
        gh = torch.bmm(gy, _whole(w2, 2, gather).transpose(1, 2))
        gh1, gh3 = _gated_grads(ctx.act, h1, h3, gh)
        del gh
        if need[0]:
            gxe = torch.bmm(gh1, _whole(w1, 0, gather).transpose(1, 2))
            gxe = gxe + torch.bmm(gh3, _whole(w3, 1, gather).transpose(1, 2))
        if need[1]:
            gw1 = _shard_grad(xe.transpose(1, 2).bmm(gh1), 0, gather)
        if need[2]:
            gw3 = _shard_grad(xe.transpose(1, 2).bmm(gh3), 1, gather)
        return gxe, gw1, gw3, gw2, None, None


def _moe_sort_local(x, top_p, top_e, w1, w3, w2, *, cap: int, act,
                    lo: int, gather=None):
    """Sort-based dispatch, one group a batch row: gathers/scatter-adds
    instead of one-hot matmuls, into and out of the buffers of experts
    ``[lo, lo + n)`` (``w1``/``w3`` (n, D, F), ``w2`` (n, F, D), or their
    shards with ``gather``, ``_expert_ffn``); the sort runs over every
    expert, so each entry's buffer position is the one it has among all
    E. Returns these experts' share of the output (B, S, D): all of it
    where they are all E.

    The buffers are expert-major, (n, B * C, D), so the FFN reads them in
    place. The dispatch and the combine (``_SortDispatch``,
    ``_SortCombine``) go by buffer row: each row's token and gate, from
    the sort's entries, so no (B, S * k, D) rows are made, and only these
    indices and gates are held for the backward pass."""
    b, s, d = x.shape
    k = top_e.shape[-1]
    n = w1.shape[0]
    flat_e = top_e.reshape(b, s * k)
    flat_tok = torch.arange(s, device=x.device).repeat_interleave(k)
    flat_gate = top_p.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_tok[order]                                       # (B, S*k)
    sg = torch.gather(flat_gate, 1, order)
    # position of each entry within its expert's buffer
    pos = torch.arange(s * k, device=x.device) - torch.searchsorted(
        se, se, side="left")
    keep = (pos < cap) & (se >= lo) & (se < lo + n)
    row = torch.arange(b, device=x.device)[:, None]
    # each entry's buffer row in (n, B, C) order; a dropped one's: rows
    rows = n * b * cap
    slot = torch.where(keep, ((se - lo) * b + row) * cap + pos,
                       rows).flatten()
    # each buffer row's token (of x's B * S rows; B * S where it is empty)
    # and gate, the overflow row dropped
    tok = torch.full((rows + 1,), b * s, dtype=slot.dtype,
                     device=x.device).index_put_(
        (slot,), (st + row * s).flatten())[:-1]
    sg = sg.to(x.dtype).flatten()
    gate = sg.new_zeros(rows + 1).index_put((slot,), sg)[:-1]
    xe = _SortDispatch.apply(x.reshape(b * s, d), tok)
    y = _expert_ffn(xe.view(n, b * cap, d), w1, w3, w2, act, gather)
    return _SortCombine.apply(y.view(rows, d), gate, tok,
                              b * s).view(b, s, d)


def _rows_or_zero(t, idx):
    """The rows ``idx`` of ``t`` (N, D), a row of zeros where ``idx`` is
    N (an empty buffer row's token)."""
    out = t.index_select(0, idx.clamp(max=t.shape[0] - 1))
    return out.masked_fill_((idx == t.shape[0])[:, None], 0)


class _SortDispatch(torch.autograd.Function):
    """The buffer rows: the rows ``tok`` of x (N, D), zero where ``tok``
    is N."""

    @staticmethod
    def forward(ctx, x, tok):
        ctx.save_for_backward(tok)
        ctx.rows = x.shape[0]
        return _rows_or_zero(x, tok)

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        gx = g.new_zeros(ctx.rows + 1, g.shape[1]).index_add_(0, tok, g)
        return gx[:-1], None


class _SortCombine(torch.autograd.Function):
    """The buffer rows ``y``, each times its ``gate``, added into the
    output's rows ``tok`` (an empty buffer row's token is ``rows``, which
    is dropped) of a zeroed (rows, D)."""

    @staticmethod
    def forward(ctx, y, gate, tok, rows: int):
        ctx.save_for_backward(y, gate, tok)
        out = y.new_zeros(rows + 1, y.shape[1]).index_add_(
            0, tok, y * gate[:, None])
        return out[:-1]

    @staticmethod
    def backward(ctx, g):
        y, gate, tok = ctx.saved_tensors
        need = ctx.needs_input_grad
        grows = _rows_or_zero(g, tok)
        ggate = (grows * y).sum(-1) if need[1] else None
        gy = grows.mul_(gate[:, None]) if need[0] else None
        return gy, ggate, None, None


def _moe_einsum_local(x, top_p, top_e, w1, w3, w2, *, cap: int, act,
                      lo: int, gather=None):
    """Capacity-based top-k routing with einsum dispatch/combine, on
    experts ``[lo, lo + n)`` (``w1``/``w3`` (n, D, F), ``w2`` (n, F, D),
    or their shards with ``gather``, ``_expert_ffn``): their share of the
    output (B, S, D), all of it where they are all E.

    Tokens grouped by batch row (group = one sequence): capacity
    C = ceil(S * k / E * capacity_factor). Each expert's buffer positions
    depend on its own column of the routing only. The one-hot products
    run on the masks' own layout, (B, S, C, n), flattened, which needs no
    copy of them and contracts the combine in the order the reference's
    einsum does; the expert buffers are copied once each way between the
    rows' layout (B, C, n, D) and the experts' (n, B * C, D)."""
    b, s, d = x.shape
    n = w1.shape[0]
    disp, comb = _einsum_routing(top_p, top_e, lo, n, cap, x.dtype)
    xe = torch.einsum("bsk,bsd->bkd", disp.flatten(2), x)     # (B,Cn,D)
    xe = xe.view(b, cap, n, d).permute(2, 0, 1, 3).reshape(n, b * cap, d)
    y = _expert_ffn(xe, w1, w3, w2, act, gather)
    y = y.view(n, b, cap, d).permute(1, 2, 0, 3).reshape(b, cap * n, d)
    return torch.einsum("bsk,bkd->bsd", (disp * comb[:, :, None]).flatten(2),
                        y)


def _einsum_routing(top_p, top_e, lo: int, n: int, cap: int, dtype):
    """The one-hot dispatch mask (B, S, C, n) of experts ``[lo, lo + n)``
    in ``dtype``, and each token's gate for them (B, S, n)."""
    onehot = (top_e[..., None] == torch.arange(
        lo, lo + n, device=top_e.device)).float()              # (B,S,k,n)
    comb = (onehot * top_p[..., None]).sum(2)                  # (B,S,n)
    mask = onehot.sum(2)                                       # (B,S,n) 0/1
    pos = torch.cumsum(mask, dim=1) - 1.0                      # (B,S,n)
    keep = (pos < cap) & (mask > 0)
    # a one-hot row of zeros for pos = -1 or pos >= cap, as jax.nn.one_hot
    pos_oh = (pos.to(torch.int32)[:, :, None]
              == torch.arange(cap, device=top_e.device)[:, None]).to(dtype)
    return pos_oh * keep[:, :, None].to(dtype), comb.to(dtype)


def moe_aux_loss(p, x, cfg):
    """Load-balance auxiliary loss (Switch-style)."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top_e, cfg.n_experts).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD — state-space duality, chunked)
# ---------------------------------------------------------------------------


class SSM(nn.Module):
    """Parameters ``in_proj (d, 2 din + 2 N + nh)``, ``conv_w (W, din +
    2 N)``, ``A_log``/``dt_bias``/``D (nh,)`` (f32) and ``out_proj (din,
    d)``."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        din = cfg.ssm_expand * d
        nh = din // cfg.ssm_head_dim
        n = cfg.ssm_state
        dt = dtype or cfg.act_dtype
        self.in_proj = _param((d, 2 * din + 2 * n + nh), dt, device)
        self.conv_w = _param((cfg.ssm_conv, din + 2 * n), dt, device)
        self.A_log = _param((nh,), torch.float32, device)
        self.dt_bias = _param((nh,), torch.float32, device)
        self.D = _param((nh,), torch.float32, device)
        self.out_proj = _param((din, d), dt, device)

    def reset_parameters(self, cfg, generator) -> None:
        """The reference's ``init_ssm``, drawn from ``generator``."""
        din = self.out_proj.shape[0]
        trunc_normal_(self.in_proj, 1.0 / math.sqrt(cfg.d_model), generator)
        trunc_normal_(self.conv_w, 0.2, generator)
        trunc_normal_(self.out_proj, 1.0 / math.sqrt(din), generator)
        nh = self.A_log.shape[0]
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, nh, dtype=torch.float32)))
            self.dt_bias.zero_()
            self.D.fill_(1.0)


def ssm_axes():
    return {"in_proj": ("fsdp", "tensor"), "conv_w": (None, "tensor"),
            "A_log": (None,), "dt_bias": (None,), "D": (None,),
            "out_proj": ("tensor", "fsdp")}


def _causal_conv(x, w, carry=None):
    """Depthwise causal conv along seq. x: (B,S,C), w: (W,C).

    carry: (B, W-1, C) previous context (decode); returns (y, new_carry).
    """
    width = w.shape[0]
    if carry is None:
        pad = torch.zeros(x.shape[0], width - 1, x.shape[2], dtype=x.dtype,
                          device=x.device)
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = w.to(x.dtype)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(width))
    new_carry = xp[:, -(width - 1):]
    return y, new_carry


def _ssd(xs, bmat, cmat, dt, da, state, *, q: int, intra_dt):
    """``_ssd_chunks``; on DTensors each rank runs it on its heads and
    batch rows (``local_map``: every head's recurrence is its own; DTensor
    finds no strategy for the SSD's 4-operand einsums in reasonable time).
    ``bmat``/``cmat`` are shared by the heads, so their gradients are
    partial sums over the ranks that split the heads."""
    if get_mesh() is None or not hasattr(xs, "placements"):
        return _ssd_chunks(xs, bmat, cmat, dt, da, state, q, intra_dt)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs.device_mesh
    heads = [Shard(2) if pl.is_shard(2) else
             Shard(0) if pl.is_shard(0) else Replicate()
             for pl in xs.placements]
    rows = [Shard(0) if pl.is_shard(0) else Replicate() for pl in heads]
    rows_grad = [Partial() if pl.is_shard(2) else r
                 for pl, r in zip(heads, rows)]
    st = [Shard(1) if pl.is_shard(2) else pl for pl in heads]
    xs, dt, da = (t.redistribute(mesh, heads) for t in (xs, dt, da))
    bmat, cmat = (t.redistribute(mesh, rows) for t in (bmat, cmat))
    if state is not None:
        state = state.redistribute(mesh, st)
    fn = local_map(functools.partial(_ssd_chunks, q=q, intra_dt=intra_dt),
                   out_placements=(heads, st),
                   in_placements=(heads, rows, rows, heads, heads,
                                  None if state is None else st),
                   in_grad_placements=(heads, rows_grad, rows_grad, heads,
                                       heads, None if state is None else st),
                   device_mesh=mesh)
    return fn(xs, bmat, cmat, dt, da, state)


def _ssd_chunks(xs, bmat, cmat, dt, da, state, q: int, intra_dt):
    """The chunked SSD of ``xs`` (B, S, nh, hd) with ``bmat``/``cmat``
    (B, S, N), ``dt``/``da`` (B, S, nh) f32 and the carried ``state``
    (B, nh, hd, N) or None, in chunks of ``q``: returns (y (B, S, nh, hd)
    f32 without the skip term, the final state)."""
    f32 = torch.float32
    b, s, nh, hd = xs.shape
    n = bmat.shape[-1]
    nc = s // q
    xs_c = xs.reshape(b, nc, q, nh, hd)
    b_c = bmat.reshape(b, nc, q, n).to(intra_dt)
    c_c = cmat.reshape(b, nc, q, n).to(intra_dt)
    dt_c = dt.reshape(b, nc, q, nh)
    da_c = da.reshape(b, nc, q, nh)
    acum = torch.cumsum(da_c, dim=2)                   # (B,nc,q,nh) f32

    # Intra-chunk (quadratic within chunk): L[i,j] = exp(acum_i - acum_j)
    # i>=j. Mask *before* exp: the upper triangle's positive diffs overflow.
    diff = acum[:, :, :, None] - acum[:, :, None, :, :]  # (B,nc,q,q,nh)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xs.device))
    lmat = torch.exp(torch.where(tri[None, None, ..., None], diff, -1e30))
    lmat = lmat.to(intra_dt)
    gmat = torch.einsum("bcin,bcjn->bcij", c_c, b_c)   # scores C_i . B_j
    # ``bcij,bcijh,bcjh,bcjhp->bcihp`` contracted left to right: the
    # weights of each (i, j), then j against xs. The path that opt_einsum
    # picks for the four operands builds a (B, nc, q, nh, hd, q) product.
    wmat = gmat.float()[..., None] * lmat.float() \
        * dt_c.to(intra_dt).float()[:, :, None]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", wmat,
                          xs_c.to(intra_dt).float())

    # Chunk-final states + inter-chunk recurrence.
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)  # (B,nc,q,nh)
    chunk_state = torch.einsum("bcjn,bcjh,bcjh,bcjhp->bchpn", b_c.float(),
                               decay_to_end, dt_c, xs_c.float())
    chunk_decay = torch.exp(acum[:, :, -1, :])         # (B,nc,nh)

    h = torch.zeros(b, nh, hd, n, dtype=f32, device=xs.device) \
        if state is None else state
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # (B,nc,nh,hd,n)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", c_c.float(), h_prevs,
                         torch.exp(acum))
    return (y_diag + y_off).reshape(b, s, nh, hd), h


def ssm_apply(p, x, cfg, state=None, conv_carry=None):
    """Chunked SSD forward. state: (B, nh, hd, N) for decode.

    Returns (y, (new_state, new_conv_carry)).
    """
    b, s, d = x.shape
    din = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    nh = din // hd
    n = cfg.ssm_state
    f32 = torch.float32

    # Under a mesh: in_proj column parallel, its product gathered whole
    # (no slice of split columns) and z, xBC and dt each split evenly over
    # ``tensor``, as the reference places them; the conv on xBC's split,
    # then xBC gathered: xs split by heads, B and C whole.
    (zxbcdt,) = _project(x, [p.in_proj.to(x.dtype)], [("batch", None, None)])
    split = ("batch", None, "tensor")
    z = constrain(zxbcdt[..., :din], *split)
    xbc = constrain(zxbcdt[..., din:din + din + 2 * n], *split)
    dt = constrain(zxbcdt[..., -nh:], *split)
    xbc, new_conv = _causal_conv(xbc, p.conv_w, conv_carry)
    xbc = constrain(silu(xbc), "batch", None, None)
    xs = xbc[..., :din].reshape(b, s, nh, hd)
    xs = constrain(xs, "batch", None, "tensor", None)
    bmat = xbc[..., din:din + n]                       # (B,S,N) single group
    cmat = xbc[..., din + n:]                          # (B,S,N)
    dt = softplus(dt.float() + p.dt_bias[None, None])  # (B,S,nh)
    a = -torch.exp(p.A_log)[None, None]                # (1,1,nh)
    da = dt * a                                        # (B,S,nh) negative

    if state is not None and s == 1:  # single-step decode
        xs1 = xs[:, 0]                                 # (B,nh,hd)
        dt1 = dt[:, 0]
        da1 = torch.exp(da[:, 0])                      # (B,nh)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt1, bmat[:, 0].float(),
                           xs1.float())
        new_state = state * da1[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new_state, cmat[:, 0].float())
        y = y + p.D[None, :, None] * xs1.float()
        y = y.reshape(b, 1, din).to(x.dtype)
        y = y * silu(z)
        (out,) = _project(y, [p.out_proj.to(x.dtype)], [RESID])
        return out, (new_state, new_conv)

    q = min(cfg.ssm_chunk, s)
    if s % q != 0:  # ragged (smoke-test) sizes: single chunk
        q = s
    # ssm_bf16_intra: the intra-chunk tensors in bf16, accumulated in f32.
    intra_dt = torch.bfloat16 if cfg.ssm_bf16_intra else f32
    y, h = _ssd(xs, bmat, cmat, dt, da, state, q=q, intra_dt=intra_dt)
    y = y + p.D[None, None, :, None] * xs.float()
    y = y.reshape(b, s, din).to(x.dtype)
    y = y * silu(z)
    y = constrain(y, "batch", None, "tensor")
    (out,) = _project(y, [p.out_proj.to(x.dtype)], [RESID])
    return out, (h, new_conv)


def ssm_cache_axes():
    return {"state": ("batch", "tensor", None, None),
            "conv": ("batch", None, "tensor")}


def ssm_cache(cfg, batch: int, dtype, device=None) -> dict:
    """Zeroed f32 state (B, nh, hd, N) and conv context (B, W-1, C)."""
    device = resolve_device(device)
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    return {
        "state": torch.zeros(batch, nh, cfg.ssm_head_dim, cfg.ssm_state,
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, din + 2 * cfg.ssm_state,
                            dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------


class RGLRU(nn.Module):
    """Parameters ``in_x``/``in_gate (d, w)``, ``conv_w (W, w)``,
    ``w_input_gate``/``w_rec_gate (w, w)``, ``lam (w,)`` (f32) and
    ``out_proj (w, d)``."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        d, w, dt = cfg.d_model, cfg.rnn_width, dtype or cfg.act_dtype
        self.in_x = _param((d, w), dt, device)
        self.in_gate = _param((d, w), dt, device)
        self.conv_w = _param((cfg.rnn_conv, w), dt, device)
        self.w_input_gate = _param((w, w), dt, device)
        self.w_rec_gate = _param((w, w), dt, device)
        self.lam = _param((w,), torch.float32, device)
        self.out_proj = _param((w, d), dt, device)

    def reset_parameters(self, cfg, generator) -> None:
        """The reference's ``init_rglru``, drawn from ``generator``."""
        d, w = cfg.d_model, cfg.rnn_width
        trunc_normal_(self.in_x, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.in_gate, 1.0 / math.sqrt(d), generator)
        trunc_normal_(self.conv_w, 0.2, generator)
        trunc_normal_(self.w_input_gate, 1.0 / math.sqrt(w), generator)
        trunc_normal_(self.w_rec_gate, 1.0 / math.sqrt(w), generator)
        trunc_normal_(self.out_proj, 1.0 / math.sqrt(w), generator)
        with torch.no_grad():
            self.lam.fill_(8.0)  # Λ parameter


def rglru_axes():
    return {"in_x": ("fsdp", "tensor"), "in_gate": ("fsdp", "tensor"),
            "conv_w": (None, "tensor"), "w_input_gate": (None, "tensor"),
            "w_rec_gate": (None, "tensor"), "lam": ("tensor",),
            "out_proj": ("tensor", "fsdp")}


_RG_C = 8.0


def _interleave(even, odd):
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _linear_scan(a, b):
    """All prefixes of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1,
    combined in the order of ``jax.lax.associative_scan``'s recursion:
    adjacent pairs first, then the odd prefixes, then the even ones.
    Returns (prefix products of a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a0, b0 = a[:, 0:n - 1:2], b[:, 0:n - 1:2]
    a1, b1 = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _linear_scan(a0 * a1, a1 * b0 + b1)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    prev_a, prev_b = (odd_a[:, :-1], odd_b[:, :-1]) if n % 2 == 0 \
        else (odd_a, odd_b)
    even_a = torch.cat([a[:, :1], prev_a * a2], dim=1)
    even_b = torch.cat([b[:, :1], a2 * prev_b + b2], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rglru_scan(a, gated, state):
    """h_t = a_t h_{t-1} + gated_t along dim 1 from h_{-1} = ``state`` (B,
    w), or 0 where it is None: every h. On DTensors each rank scans its
    batch rows and channels (``local_map`` on ``a``'s shards, ``gated``
    and ``state`` brought to them): every channel's recurrence is its own,
    and every row's; the scan's interleaved buffers would otherwise be
    built whole over the global batch and the full width."""
    if get_mesh() is None or not hasattr(a, "placements"):
        return _rglru_scan_local(a, gated, state)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    rows = [Shard(0) if pl.is_shard(0) else
            Shard(2) if pl.is_shard(2) else Replicate()
            for pl in a.placements]
    st = [Shard(1) if pl.is_shard(2) else pl for pl in rows]
    a, gated = (t.redistribute(mesh, rows) for t in (a, gated))
    if state is not None:
        state = state.redistribute(mesh, st)
    return local_map(_rglru_scan_local, out_placements=rows,
                     in_placements=(rows, rows,
                                    None if state is None else st),
                     device_mesh=mesh)(a, gated, state)


def _rglru_scan_local(a, gated, state):
    if state is not None:  # chain from a carried state
        gated[:, 0] += a[:, 0] * state
    return _linear_scan(a, gated)[1]


def rglru_apply(p, x, cfg, state=None, conv_carry=None):
    """Griffin recurrent block: proj -> causal conv -> RG-LRU -> gated out.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Λ) * r_t).
    """
    split = ("batch", None, "tensor")
    xb, gate = _project(x, [p.in_x.to(x.dtype), p.in_gate.to(x.dtype)],
                        [split, split])
    xb, new_conv = _causal_conv(xb, p.conv_w, conv_carry)
    xb = constrain(xb, *split)

    # Under a mesh xb is gathered and each rank computes its columns of
    # the gates, split as xb is (``_project``), as the reference does.
    r, i = _project(xb, [p.w_rec_gate.to(xb.dtype),
                         p.w_input_gate.to(xb.dtype)], [split, split])
    r, i = sigmoid(r.float()), sigmoid(i.float())
    log_a = -_RG_C * softplus(p.lam)[None, None] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.float())

    if state is not None and x.shape[1] == 1:  # decode: single step
        h = a[:, 0] * state + gated[:, 0]
        y = h[:, None]
        new_state = h
    else:
        y = _rglru_scan(a, gated, state)
        new_state = y[:, -1]
    y = y.to(x.dtype) * gelu(gate)
    y = constrain(y, *split)
    (out,) = _project(y, [p.out_proj.to(x.dtype)], [RESID])
    return out, (new_state, new_conv)


def rglru_cache_axes():
    return {"state": ("batch", "tensor"), "conv": ("batch", None, "tensor")}


def rglru_cache(cfg, batch: int, dtype, device=None) -> dict:
    """Zeroed f32 state (B, w) and conv context (B, W-1, w)."""
    device = resolve_device(device)
    return {
        "state": torch.zeros(batch, cfg.rnn_width, dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(batch, cfg.rnn_conv - 1, cfg.rnn_width,
                            dtype=dtype, device=device),
    }
