"""AdamW with linear-warmup cosine decay and global-norm clipping.

The port of ``src/repro/train/optimizer.py``. The optimizer state mirrors
the model's parameters (f32 moments, one a parameter). The update keeps
the reference's arithmetic, op for op: the schedule and the bias
corrections are computed in f32 (0-dim tensors on the host, then applied
as those exact f32 values), then ``sqrt(nu / bc2) + eps``, ``+ wd * p``
and ``p - lr * step``, each a ``torch._foreach_*`` pass over every tensor,
not ``torch.optim.AdamW``'s fused order. Parameters and moments are
updated in place (the reference returns new trees), which saves three
copies of the model; the parameters must be f32 masters.

Weight decay follows the rank of the reference's leaf: every leaf of a
layer group is stacked along a repeat axis, so every block parameter
(norm scales, ``A_log`` and biases too) and the embedding decay, and only
the final norm ``ln_f`` does not (``convert.reference_leaves``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.convert import reference_leaves


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(hyper: Hyper, step) -> torch.Tensor:
    """The learning rate at ``step``, an f32 0-dim tensor on the host."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(hyper.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - hyper.warmup_steps)
                       / max(hyper.total_steps - hyper.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return hyper.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(model) -> dict:
    """Zero f32 moments ``{"mu": {name: tensor}, "nu": {...}}`` beside
    ``model``'s parameters."""
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in model.named_parameters()}
    return {"mu": zeros(), "nu": zeros()}


def decayed(cfg) -> set:
    """The names of the parameters that weight decay reaches: those of the
    reference leaves of rank 2 or more."""
    return {name for leaf in reference_leaves(cfg) if leaf.ndim >= 2
            for name in leaf.names}


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, f32, on their device."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.float() for t in tensors])))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    tensors = list(grads.values())
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(tensors, scale)
    return grads, norm


@torch.no_grad()
def adamw_update(model, grads: dict, opt: dict, step: int, hyper: Hyper):
    """One AdamW step on ``model``'s f32 parameters with the f32 ``grads``
    (``{name: tensor}``, clipped in place). Updates the parameters and
    ``opt`` in place; returns (model, opt, metrics)."""
    names = [name for name, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("AdamW updates f32 master weights; build the model "
                         "with param_dtype=torch.float32")
    grads, gnorm = clip_by_global_norm(grads, hyper.clip_norm)
    g = [grads[name] for name in names]
    mu = [opt["mu"][name] for name in names]
    nu = [opt["nu"][name] for name in names]
    lr = schedule(hyper, step)
    t = torch.tensor(step + 1, dtype=torch.float32)
    bc1 = 1.0 - hyper.b1 ** t
    bc2 = 1.0 - hyper.b2 ** t

    # mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g * g
    tmp = torch._foreach_mul(g, 1.0 - hyper.b1)
    torch._foreach_mul_(mu, hyper.b1)
    torch._foreach_add_(mu, tmp)
    tmp = torch._foreach_mul(g, 1.0 - hyper.b2)
    torch._foreach_mul_(tmp, g)
    torch._foreach_mul_(nu, hyper.b2)
    torch._foreach_add_(nu, tmp)
    del tmp
    # step = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd * p]
    step_val = torch._foreach_div(mu, bc1.item())
    denom = torch._foreach_div(nu, bc2.item())
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, hyper.eps)
    torch._foreach_div_(step_val, denom)
    del denom
    decay = decayed(model.cfg)
    idx = [i for i, name in enumerate(names) if name in decay]
    if idx:
        torch._foreach_add_([step_val[i] for i in idx], torch._foreach_mul(
            [params[i] for i in idx], hyper.weight_decay))
    # p = p - lr * step
    torch._foreach_mul_(step_val, lr.item())
    torch._foreach_sub_(params, step_val)
    return model, opt, {"grad_norm": gnorm, "lr": lr}
