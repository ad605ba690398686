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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import (apply_rope, gelu, make_rope,
                                       rms_norm, sigmoid, silu, softcap,
                                       softplus, trunc_normal_)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _act(cfg):
    return gelu if cfg.mlp_act == "gelu" else silu


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


_NEG_POS = -(2**30)


def _chunked_attention(q, k, v, *, q_positions, kv_positions, window, cap,
                       chunk):
    """Blockwise causal attention with explicit absolute positions.

    q: (B, Sq, Hkv, G, dh); k/v: (B, Skv, Hkv, dh).
    q_positions: (Sq,) int32; kv_positions: (Skv,) int32 (ring caches carry
    stale slots with very negative positions -> masked automatically).
    Returns (B, Sq, Hkv, G, dh). Scores are per-chunk f32 (never (S, S)).
    """
    b, sq, hkv, g, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, sq)
    if sq % chunk != 0:  # ragged (smoke-test) sizes: single chunk
        chunk = sq
    n_chunks = max(sq // chunk, 1)
    k32, v32 = k.float(), v.float()
    kv_pos = kv_positions[None, :]
    outs = []
    for c in range(n_chunks):
        qc = q[:, c * chunk:(c + 1) * chunk].float()
        q_pos = q_positions[c * chunk:(c + 1) * chunk, None]
        s = torch.einsum("bchgd,bshd->bhgcs", qc, k32) * scale
        if cap is not None:
            s = softcap(s, cap)
        causal = (kv_pos <= q_pos) & (kv_pos >= 0)  # unwritten ring slots < 0
        if window is not None:
            causal &= kv_pos > (q_pos - window)
        s = torch.where(causal, s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgcs,bshd->bchgd", p, v32)
        outs.append(out.to(q.dtype))
    return outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)


def attention_apply(p, x, cfg, *, local: bool, cache=None, cache_index=None):
    """Full-sequence path when cache is None; else cached prefill/decode.

    cache: dict(k/v=(B, S_eff, Hkv, dh), pos=(S_eff,) i32), written in
    place. Local-attention caches are ring buffers of size window; writes
    go to index % S_eff and masking relies on the stored absolute
    positions. cache_index: the position of x's first token (an int).
    Returns the output (B, S, d).
    """
    b, s, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = h // hkv
    window = cfg.window if local else None

    q = (x @ p.wq.to(x.dtype).reshape(d, h * dh)).view(b, s, h, dh)
    k = (x @ p.wk.to(x.dtype).reshape(d, hkv * dh)).view(b, s, hkv, dh)
    v = (x @ p.wv.to(x.dtype).reshape(d, hkv * dh)).view(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if cache_index is not None:
        positions = positions + cache_index
    cos, sin = make_rope(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qg = q.view(b, s, hkv, g, dh)

    if cache is None or s > 1:
        # Full sequence, or prefill from an empty cache: attend within the
        # prompt itself; the cache receives the tail needed for decoding.
        out = _chunked_attention(qg, k, v, q_positions=positions,
                                 kv_positions=positions, window=window,
                                 cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
        if cache is not None:
            eff = cache["k"].shape[1]
            take = min(s, eff)
            # Ring invariant: position p lives in slot p % eff, so later
            # decode writes (at index % eff) overwrite the right slots.
            shift = (s - take) % eff
            cache["k"][:, :take] = torch.roll(k[:, -take:], shift, dims=1)
            cache["v"][:, :take] = torch.roll(v[:, -take:], shift, dims=1)
            cache["pos"][:take] = torch.roll(positions[-take:], shift, dims=0)
    else:
        # Single-token decode: ring write at index % eff, mask by positions.
        eff = cache["k"].shape[1]
        slot = cache_index % eff
        cache["k"][:, slot:slot + 1] = k
        cache["v"][:, slot:slot + 1] = v
        cache["pos"][slot:slot + 1] = positions
        out = _chunked_attention(qg, cache["k"], cache["v"],
                                 q_positions=positions,
                                 kv_positions=cache["pos"], window=window,
                                 cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
    out = out.reshape(b, s, h * dh)
    return out @ p.wo.to(x.dtype).reshape(h * dh, d)


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


def mlp_apply(p, x, cfg):
    """SwiGLU (``mlp_act="silu"``) or GeGLU with the tanh GELU."""
    act = _act(cfg)
    hcur = act(x @ p.w1.to(x.dtype)) * (x @ p.w3.to(x.dtype))
    return hcur @ p.w2.to(x.dtype)


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


def moe_apply(p, x, cfg):
    """Top-k MoE FFN. Two dispatch implementations (cfg.moe_impl):

    "einsum" (baseline): one-hot dispatch/combine einsums.
    "sort": tokens sorted by expert id, placed into (E, C) buffers by
    gathers, combined by a scatter-add.

    Tokens past an expert's capacity fall through the residual.
    """
    if cfg.moe_impl == "sort":
        return _moe_apply_sort(p, x, cfg)
    return _moe_apply_einsum(p, x, cfg)


def _moe_router(p, x, cfg):
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(s * k / e * cfg.capacity_factor))
    cap = min(max(cap, 4), s)
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                      # (B,S,E)
    top_p, top_e = torch.topk(probs, k, dim=-1)                # (B,S,k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e, cap


def _moe_ffn(p, xin, cfg):
    """xin: (B, E, C, D) -> (B, E, C, D)."""
    act = _act(cfg)
    hcur = act(torch.einsum("becd,edf->becf", xin, p.w1.to(xin.dtype)))
    hcur = hcur * torch.einsum("becd,edf->becf", xin, p.w3.to(xin.dtype))
    return torch.einsum("becf,efd->becd", hcur, p.w2.to(xin.dtype))


def _moe_apply_sort(p, x, cfg):
    """Sort-based dispatch, one group a batch row: gathers/scatter-adds
    instead of one-hot matmuls."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    top_p, top_e, cap = _moe_router(p, x, cfg)
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
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, e * cap)         # overflow slot
    keep_x = keep[..., None].to(x.dtype)
    rows = torch.gather(x, 1, st[..., None].expand(b, s * k, d)) * keep_x
    buf = torch.zeros(b, e * cap + 1, d, dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(b, s * k, d), rows)
    xin = buf[:, :-1].reshape(b, e, cap, d)
    yout = _moe_ffn(p, xin, cfg)                               # (B,E,C,D)
    ybuf = torch.cat([yout.reshape(b, e * cap, d),
                      torch.zeros(b, 1, d, dtype=x.dtype, device=x.device)],
                     dim=1)
    contrib = torch.gather(ybuf, 1, dest[..., None].expand(b, s * k, d)) \
        * (sg[..., None].to(x.dtype) * keep_x)
    out = torch.zeros(b, s, d, dtype=x.dtype, device=x.device)
    out.scatter_add_(1, st[..., None].expand(b, s * k, d), contrib)
    if cfg.n_shared > 0:
        out = out + mlp_apply(p.shared, x, cfg)
    return out


def _moe_apply_einsum(p, x, cfg):
    """Capacity-based top-k routing with einsum dispatch/combine.

    Tokens grouped by batch row (group = one sequence): capacity
    C = ceil(S * k / E * capacity_factor).
    """
    b, s, d = x.shape
    e = cfg.n_experts
    top_p, top_e, cap = _moe_router(p, x, cfg)

    # Position of each (token, choice) in its expert's buffer.
    onehot = F.one_hot(top_e, e).float()                       # (B,S,k,E)
    comb = (onehot * top_p[..., None]).sum(2)                  # (B,S,E)
    mask = onehot.sum(2)                                       # (B,S,E) 0/1
    pos = torch.cumsum(mask, dim=1) - 1.0                      # (B,S,E)
    keep = (pos < cap) & (mask > 0)
    # a one-hot row of zeros for pos = -1 or pos >= cap, as jax.nn.one_hot
    pos_oh = (pos.to(torch.int32)[..., None]
              == torch.arange(cap, device=x.device)).to(x.dtype)
    disp = pos_oh * keep[..., None].to(x.dtype)                # (B,S,E,C)

    xin = torch.einsum("bsec,bsd->becd", disp, x)              # (B,E,C,D)
    eout = _moe_ffn(p, xin, cfg)
    out = torch.einsum("becd,bsec->bsd", eout,
                       disp * comb.to(x.dtype)[..., None])
    if cfg.n_shared > 0:
        out = out + mlp_apply(p.shared, x, cfg)
    return out


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

    zxbcdt = x @ p.in_proj.to(x.dtype)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * n]
    dt = zxbcdt[..., -nh:]
    xbc, new_conv = _causal_conv(xbc, p.conv_w, conv_carry)
    xbc = silu(xbc)
    xs = xbc[..., :din].reshape(b, s, nh, hd)
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
        return y @ p.out_proj.to(x.dtype), (new_state, new_conv)

    q = min(cfg.ssm_chunk, s)
    if s % q != 0:  # ragged (smoke-test) sizes: single chunk
        q = s
    nc = s // q
    # ssm_bf16_intra: the intra-chunk tensors in bf16, accumulated in f32.
    intra_dt = torch.bfloat16 if cfg.ssm_bf16_intra else f32
    xs_c = xs.reshape(b, nc, q, nh, hd)
    b_c = bmat.reshape(b, nc, q, n).to(intra_dt)
    c_c = cmat.reshape(b, nc, q, n).to(intra_dt)
    dt_c = dt.reshape(b, nc, q, nh)
    da_c = da.reshape(b, nc, q, nh)
    acum = torch.cumsum(da_c, dim=2)                   # (B,nc,q,nh) f32

    # Intra-chunk (quadratic within chunk): L[i,j] = exp(acum_i - acum_j)
    # i>=j. Mask *before* exp: the upper triangle's positive diffs overflow.
    diff = acum[:, :, :, None] - acum[:, :, None, :, :]  # (B,nc,q,q,nh)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    lmat = torch.exp(torch.where(tri[None, None, ..., None], diff, -1e30))
    lmat = lmat.to(intra_dt)
    gmat = torch.einsum("bcin,bcjn->bcij", c_c, b_c)   # scores C_i . B_j
    y_diag = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", gmat.float(),
                          lmat.float(), dt_c.to(intra_dt).float(),
                          xs_c.to(intra_dt).float())

    # Chunk-final states + inter-chunk recurrence.
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)  # (B,nc,q,nh)
    chunk_state = torch.einsum("bcjn,bcjh,bcjh,bcjhp->bchpn", b_c.float(),
                               decay_to_end, dt_c, xs_c.float())
    chunk_decay = torch.exp(acum[:, :, -1, :])         # (B,nc,nh)

    h = torch.zeros(b, nh, hd, n, dtype=f32, device=x.device) \
        if state is None else state
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # (B,nc,nh,hd,n)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", c_c.float(), h_prevs,
                         torch.exp(acum))
    y = (y_diag + y_off).reshape(b, s, nh, hd)
    y = y + p.D[None, None, :, None] * xs.float()
    y = y.reshape(b, s, din).to(x.dtype)
    y = y * silu(z)
    return y @ p.out_proj.to(x.dtype), (h, new_conv)


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


def rglru_apply(p, x, cfg, state=None, conv_carry=None):
    """Griffin recurrent block: proj -> causal conv -> RG-LRU -> gated out.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Λ) * r_t).
    """
    xb = x @ p.in_x.to(x.dtype)
    gate = x @ p.in_gate.to(x.dtype)
    xb, new_conv = _causal_conv(xb, p.conv_w, conv_carry)

    r = sigmoid((xb @ p.w_rec_gate.to(xb.dtype)).float())
    i = sigmoid((xb @ p.w_input_gate.to(xb.dtype)).float())
    log_a = -_RG_C * softplus(p.lam)[None, None] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.float())

    if state is not None and x.shape[1] == 1:  # decode: single step
        h = a[:, 0] * state + gated[:, 0]
        y = h[:, None]
        new_state = h
    else:
        if state is not None:  # chain from a carried state
            gated[:, 0] += a[:, 0] * state
        _, y = _linear_scan(a, gated)
        new_state = y[:, -1]
    y = y.to(x.dtype) * gelu(gate)
    return y @ p.out_proj.to(x.dtype), (new_state, new_conv)


def rglru_cache(cfg, batch: int, dtype, device=None) -> dict:
    """Zeroed f32 state (B, w) and conv context (B, W-1, w)."""
    device = resolve_device(device)
    return {
        "state": torch.zeros(batch, cfg.rnn_width, dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(batch, cfg.rnn_conv - 1, cfg.rnn_width,
                            dtype=dtype, device=device),
    }
