"""The port's sharding rules, logical axes, meshes and dry-run specs against
the reference's, on the CPU.

Axes: for each of the ten architectures the port's ``param_logical_axes``
and ``cache_logical_axes`` are the reference's trees, and every leaf of
the reference's tree equals the axes of each port tensor it stacks
(``convert.reference_leaves``). Specs: the port's ``logical_to_spec`` is
the reference's for every parameter and cache leaf at the full config's
shapes, on the production and debug meshes, under the default rules,
``arch_rules`` and each ``VARIANTS`` rule set. The reference's function
reads only ``mesh.axis_names`` and ``mesh.devices.shape``, the port's
``mesh.mesh_dim_names`` and ``mesh.shape``, so stand-ins serve and no mesh
is built for it.
"""
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as S
from repro_torch.models import model as M
from repro_torch.models.convert import reference_leaves
from repro_torch.sharding import rules as R

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "debug": ((2, 2), ("data", "model")),
          "debug_multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref():
    """The reference's model, sharding and dry-run modules. Its dry run
    sets ``XLA_FLAGS`` when imported; the backend is started first (so the
    flag cannot change it) and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.configs import get_config as ref_config
    from repro.launch import dryrun, specs
    from repro.models import model
    from repro.sharding import rules
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return SimpleNamespace(config=ref_config, dryrun=dryrun, specs=specs,
                           model=model, rules=rules)


def _norm(spec) -> tuple:
    """A reference ``PartitionSpec`` entry by entry as the port's tuples."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _leaf(tree, key: str):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _is_axes(x):
    return isinstance(x, tuple)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_reference(arch, ref):
    cfg = get_config(arch)
    want = ref.model.param_logical_axes(ref.config(arch))
    assert M.param_logical_axes(cfg) == want
    assert M.cache_logical_axes(cfg) == \
        ref.model.cache_logical_axes(ref.config(arch))
    axes = M.model_param_axes(M.Model(cfg, device="meta"))
    for leaf in reference_leaves(cfg):
        ref_ax = _leaf(want, leaf.key)
        for name in leaf.names:
            assert ((None,) + axes[name] if leaf.stacked else axes[name]) \
                == ref_ax, (leaf.key, name)
    ref_cache = ref.model.cache_logical_axes(ref.config(arch))["groups"]
    for (gi, _, pi, kind), layer in zip(M.layer_slots(cfg),
                                        M.cache_axes(cfg)):
        stacked = ref_cache[gi][f"{pi}_{kind}"]
        assert {k: (None,) + v for k, v in layer.items()} == stacked


def _install(mesh_name, rules, ref):
    shape, names = MESHES[mesh_name]
    R.set_mesh(SimpleNamespace(mesh_dim_names=names, shape=shape,
                               ndim=len(shape)), rules)
    ref.rules.set_mesh(SimpleNamespace(axis_names=names,
                                       devices=np.empty(shape)), rules)


def _rule_sets(cfg, mesh_name, ref):
    shape, names = MESHES[mesh_name]
    model = shape[names.index("model")]
    base = ref.dryrun.arch_rules(ref.config(cfg.name.replace(
        "-smoke", "")), model)
    assert base == R_arch_rules(cfg, model)
    out = {"default": None, "arch": base}
    for name, spec in ref.dryrun.VARIANTS.items():
        if spec.get("rules"):
            out[name] = dict(base, **spec["rules"])
    return out


def R_arch_rules(cfg, model_size):
    from repro_torch.launch.dryrun import arch_rules
    return arch_rules(cfg, model_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference_on_every_mesh_and_rule_set(arch, ref):
    cfg = get_config(arch)
    model = M.Model(cfg, device="meta")
    axes = M.model_param_axes(model)
    params = dict(model.named_parameters())
    leaves = []   # (reference shape, reference axes, port shape, port axes)
    for leaf in reference_leaves(cfg):
        for name in leaf.names:
            shape = tuple(params[name].shape)
            leaves.append((((len(leaf.names),) if leaf.stacked else ())
                           + shape,
                           ((None,) if leaf.stacked else ()) + axes[name],
                           shape, axes[name]))
    info = S.SHAPES["decode_32k"]
    cache, cache_ax = S.cache_specs(cfg, info["batch"], info["seq"])
    for layer, ax in zip(cache.layers, cache_ax):
        for k, t in layer.items():
            leaves.append(((1,) + tuple(t.shape), (None,) + ax[k],
                           tuple(t.shape), ax[k]))
    n = 0
    try:
        for mesh_name in MESHES:
            for label, rules in _rule_sets(cfg, mesh_name, ref).items():
                _install(mesh_name, rules, ref)
                for ref_shape, ref_ax, shape, ax in leaves:
                    want = _norm(ref.rules.logical_to_spec(ref_ax,
                                                           ref_shape))
                    got = R.logical_to_spec(ax, shape)
                    assert got == want[1:] if len(want) > len(got) \
                        else got == want, (mesh_name, label, ax, shape)
                    n += 1
    finally:
        R.set_mesh(None)
        ref.rules.set_mesh(None)
    assert n > 100


def test_variants_and_shapes_copied_value_for_value(ref):
    from repro_torch.launch import dryrun
    assert dryrun.VARIANTS == ref.dryrun.VARIANTS
    assert S.SHAPES == ref.specs.SHAPES
    assert R.LOGICAL_RULES == ref.rules.LOGICAL_RULES
    assert R.MESH_AXES == ref.rules.MESH_AXES
    for arch in ARCHS:
        for shape in S.SHAPES:
            assert S.shape_supported(get_config(arch), shape) == \
                ref.specs.shape_supported(ref.config(arch), shape)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "musicgen_medium"])
def test_input_specs_match_reference(arch, ref):
    """Batch, token and prompt specs: the reference's shapes, dtypes and
    axes, as meta tensors; the cache's per layer, the reference's stacked."""
    cfg, rcfg = get_config(arch), ref.config(arch)
    to_np = {torch.int32: np.int32, torch.bfloat16: jax.numpy.bfloat16}
    got = S.batch_specs(cfg, 8, 128)
    want = ref.specs.batch_specs(rcfg, 8, 128)
    assert set(got) == set(want)
    pairs = [(got[k], want[k]) for k in got]
    pairs += [(S.token_specs(cfg, 4), ref.specs.token_specs(rcfg, 4)),
              (S.prompt_specs(cfg, 4, 64), ref.specs.prompt_specs(rcfg, 4,
                                                                  64))]
    for (t, ax), (sds, rax) in pairs:
        assert t.device.type == "meta"
        assert tuple(t.shape) == sds.shape and ax == rax
        assert np.dtype(to_np[t.dtype]) == np.dtype(sds.dtype)
    cache, axes = S.cache_specs(cfg, 2, 64)
    rshapes, raxes = ref.specs.cache_specs(rcfg, 2, 64)
    for (gi, rep, pi, kind), layer, ax in zip(M.layer_slots(cfg),
                                              cache.layers, axes):
        for k, t in layer.items():
            assert t.device.type == "meta"
            stacked = rshapes["groups"][gi][f"{pi}_{kind}"][k]
            assert (stacked.shape[0],) + tuple(t.shape) == stacked.shape
            assert (None,) + ax[k] == raxes["groups"][gi][f"{pi}_{kind}"][k]


def test_placements_constrain_and_param_sharding():
    """Placements: ``Shard(d)`` on every mesh dim that shards tensor dim
    d; without a mesh, ``constrain`` returns its input and
    ``param_sharding`` is None."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    x = torch.ones(4, 6)
    assert R.get_mesh() is None
    assert R.constrain(x, "batch", "embed") is x
    assert R.param_sharding(("fsdp", "tensor")) is None
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.device_type == "cpu"
        R.set_mesh(mesh)
        try:
            assert R.placements(("batch", None, "vocab"), (64, 3, 32)) == \
                (Shard(0), Shard(0), Shard(2))
            # 24 does not divide over pod x data: left whole
            assert R.placements(("batch", "fsdp"), (24, 48)) == \
                (Replicate(), Shard(1), Replicate())
            assert R.param_sharding(("fsdp", "tensor"), (32, 32)) == \
                (Replicate(), Shard(0), Shard(1))
            assert R.constrain(x, "batch", None) is x   # not a DTensor
        finally:
            R.set_mesh(None)
    with fake_world(4):
        mesh = make_debug_mesh()
        assert tuple(mesh.shape) == (2, 2)
        assert mesh.mesh_dim_names == ("data", "model")
    with fake_world(8):
        assert tuple(make_debug_mesh(multi_pod=True).shape) == (2, 2, 2)
    assert not torch.distributed.is_initialized()


def test_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()
