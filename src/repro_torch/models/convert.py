"""Carry the reference's weights into the port's ``Model``.

The reference keeps one parameter tree, ``{"embed", "ln_f", "groups":
[{f"{pi}_{kind}": {...}}, ...]}``, with every leaf of a layer group stacked
along a leading repeat axis. ``params_from_reference`` takes that tree with
NumPy leaves (``jax.tree_util.tree_map(np.asarray, params)``) and unstacks
it in the port's layer order. It imports neither ``jax`` nor the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, ModelConfig, layer_slots


def flatten_tree(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of a nested dict, the names of the port's
    ``state_dict`` for a reference subtree (``attn.wq``, ``moe.shared.w1``,
    ...)."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flatten_tree(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _reference_state_dict(tree: dict, cfg: ModelConfig) -> dict:
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


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` on ``device`` (``None``: CUDA) holding the reference's
    weights. Every shape is checked; a missing or extra leaf raises
    ``KeyError``, a wrong shape ``ValueError``. Each weight takes the
    dtype of the port's parameter (matmul weights the activation dtype)."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    want = model.state_dict()
    got = _reference_state_dict(tree, cfg)
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
