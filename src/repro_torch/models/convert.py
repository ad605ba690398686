"""Carry parameters between the reference's tree and the port's ``Model``.

The reference keeps one parameter tree, ``{"embed", "ln_f", "groups":
[{f"{pi}_{kind}": {...}}, ...]}``, with every leaf of a layer group stacked
along a leading repeat axis. ``params_from_reference`` takes that tree with
NumPy leaves (``jax.tree_util.tree_map(np.asarray, params)``) and unstacks
it in the port's layer order; ``reference_tree`` restacks the port's
tensors (parameters, gradients, moments) into it. ``reference_leaves``
names the reference's leaves and the port tensors that each one stacks:
the optimizer's decay rule, the gradient codecs' per-leaf scales and the
checkpoints' keys are defined on those leaves. Nothing here imports
``jax`` or the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, ModelConfig, layer_slots


class Leaf(NamedTuple):
    """One leaf of the reference's parameter tree: its key path (``"embed"``,
    ``"groups/0/0_attn/attn/wq"``, the reference checkpoint's names), the
    port parameters it holds, one a repeat in repeat order, whether it is
    stacked (a layer group's leaf, with a leading repeat axis) and its rank
    in the reference (a stacked leaf's is one more than its tensors')."""
    key: str
    names: tuple
    stacked: bool
    ndim: int


@functools.lru_cache(maxsize=None)
def reference_leaves(cfg: ModelConfig) -> tuple:
    """Every ``Leaf`` of ``cfg``'s reference tree, in the order
    ``jax.tree_util`` flattens it (dict keys sorted, groups in order)."""
    slots = layer_slots(cfg)
    leaves, ndims = {}, {}
    for name, param in Model(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            path = (name,)
            leaves[path], ndims[path] = [(0, name)], param.ndim
            continue
        gi, rep, pi, kind = slots[int(parts[1])]
        path = ("groups", gi, f"{pi}_{kind}", *parts[2:])
        leaves.setdefault(path, []).append((rep, name))
        ndims[path] = param.ndim + 1
    return tuple(Leaf("/".join(map(str, path)),
                      tuple(name for _, name in sorted(members)),
                      path[0] == "groups", ndims[path])
                 for path, members in sorted(leaves.items()))


def reference_tree(tensors: dict, cfg: ModelConfig) -> dict:
    """``tensors`` (``{port parameter name: tensor}``: parameters,
    gradients or moments) restacked into the reference's tree as NumPy
    arrays on the host, in each tensor's dtype (bf16 widened to f32, which
    NumPy lacks)."""
    tree = {"groups": [{} for _ in cfg.layer_groups()]}
    for leaf in reference_leaves(cfg):
        arrays = [_host(tensors[name]) for name in leaf.names]
        path = leaf.key.split("/")
        if not leaf.stacked:
            tree[path[0]] = arrays[0]
            continue
        node = tree["groups"][int(path[1])]
        for part in path[2:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.stack(arrays)
    return tree


def flatten_tree(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of a nested dict, the names of the port's
    ``state_dict`` for a reference subtree (``attn.wq``, ``moe.shared.w1``,
    ...)."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flatten_tree(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _host(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def reference_state_dict(tree: dict, cfg: ModelConfig) -> dict:
    """The reference tree as ``{port parameter name: NumPy array}``: layer
    ``i`` of the port is repeat ``rep`` of pattern position ``pi`` of
    group ``gi`` (``model.layer_slots``)."""
    groups = tree["groups"]
    if len(groups) != len(cfg.layer_groups()):
        raise ValueError(f"the tree has {len(groups)} layer groups, the "
                         f"config {len(cfg.layer_groups())}")
    out = {"embed": tree["embed"], "ln_f": tree["ln_f"]}
    used = set()
    for i, (gi, rep, pi, kind) in enumerate(layer_slots(cfg)):
        key = f"{pi}_{kind}"
        if key not in groups[gi]:
            raise KeyError(f"group {gi} has no block {key!r}")
        used.add((gi, key))
        for name, leaf in flatten_tree(groups[gi][key]):
            out[f"blocks.{i}.{name}"] = np.asarray(leaf)[rep]
    extra = [(gi, key) for gi, g in enumerate(groups) for key in g
             if (gi, key) not in used]
    if extra:
        raise KeyError(f"blocks of the tree that the config has no layer "
                       f"for: {extra}")
    return out


def params_from_reference(tree: dict, cfg: ModelConfig, device=None,
                          param_dtype=None) -> Model:
    """A ``Model`` on ``device`` (``None``: CUDA) holding the reference's
    weights. Every shape is checked; a missing or extra leaf raises
    ``KeyError``, a wrong shape ``ValueError``. Each weight takes the
    dtype of the port's parameter: the matmul weights ``param_dtype``
    (``Model``; ``None``: the activation dtype)."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta", param_dtype=param_dtype)
    want = model.state_dict()
    got = reference_state_dict(tree, cfg)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"reference tree: missing {missing}, extra {extra}")
    state = {}
    for name, param in want.items():
        leaf = np.asarray(got[name])
        if tuple(leaf.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {leaf.shape}, port "
                             f"shape {tuple(param.shape)}")
        state[name] = torch.tensor(leaf, dtype=param.dtype, device=dev)
    model.load_state_dict(state, assign=True)
    return model
