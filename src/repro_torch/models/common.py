"""Shared model components: norms, RoPE, initializers, dtype policy.

The port of ``src/repro/models/common.py``. Every function takes or keeps
explicit dtypes, as the reference does.
"""
from __future__ import annotations

import functools
import math

import torch


def rms_norm(x, scale, eps: float = 1e-6, upcast: bool = True):
    """RMSNorm with the ``1 + scale`` convention. upcast=True (default): f32
    math on the full tensor. upcast=False keeps the tensor in its dtype and
    only accumulates the variance in f32."""
    dtype = x.dtype
    if upcast:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
        return out.to(dtype)
    var = torch.mean(x * x, dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(dtype)
    return x * inv * (1.0 + scale.float()).to(dtype)


def make_rope(positions, head_dim: int, theta: float = 10000.0):
    """Rotary embedding tables for given positions: (..., head_dim/2) each,
    f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Half-split rotation. x: (B, S, H, D); cos/sin: (B, S, half) or
    (S, half)."""
    half = x.shape[-1] // 2
    if cos.ndim == 2:  # (S, half) -> broadcast over batch/heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def softplus(x):
    """``log(1 + exp(x))`` in the reference's form, ``max(x, 0) +
    log1p(exp(-|x|))`` (``jax.nn.softplus``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


@functools.lru_cache(maxsize=None)
def _const(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as JAX rounds a Python constant to the
    dtype of the array it meets."""
    return float(torch.tensor(c, dtype=dtype))


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA evaluates it, ``1 / (1 + exp(-x))``
    rounded to x's dtype after each step; in bf16 that differs from
    ``torch.sigmoid``, which rounds once."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, step by step in x's dtype."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu``'s default tanh approximation, step by step in x's
    dtype with its constants rounded to that dtype, as its jaxpr reads."""
    c = _const(math.sqrt(2.0 / math.pi), x.dtype)
    k = _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def trunc_normal_(t, std: float, generator):
    """Fill ``t`` in place with ``std`` times a standard normal truncated to
    [-2, 2], drawn in f32 from ``generator`` on the generator's device;
    returns ``t``. A tensor on the ``meta`` device is left as it is."""
    if t.device.type == "meta":
        return t
    draw = torch.empty(t.shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    with torch.no_grad():
        t.copy_(std * draw)
    return t


def param_count(params) -> int:
    """Parameters of a module, or of a mapping of tensors (a state dict)."""
    tensors = params.values() if isinstance(params, dict) \
        else params.parameters()
    return int(sum(t.numel() for t in tensors))
