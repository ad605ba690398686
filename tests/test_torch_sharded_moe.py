"""The MoE and the ``blk_out`` remat under a mesh.

Under a mesh each rank dispatches its batch rows to the experts it holds
and combines their outputs into a partial sum, reduce-scattered to the
residual stream (``models/layers.py::_moe_routed``), for the einsum and
the sort dispatch alike; ``checkpoint_name`` runs on each rank's shard,
keeping the input's placements, where the remat policy still sees it
(``models/model.py::_shard_checkpoint_name``).

(a) The reference's per-device dots: its ``moe_apply`` forward and
    ``jax.grad`` for the parameters, compiled on a (data 2, model 4) mesh
    of 8 CPU devices (a subprocess; ``AxisType.Auto`` axes) at a narrow
    dbrx-like width (d_model 128, 8 experts, top-2, expert d_ff 64,
    batch 4 x 64, capacity 20, f32); the dots' FLOPs read from the
    partitioned HLO. The same layer on a fake 8-rank (2, 4) mesh under
    the dry run's ``DeviceCost``: per-device matmul FLOPs within 1% of
    the reference's, for both dispatches. On the parent tree this failed:
    the einsum dispatch read 1.59x the reference's forward and 1.54x its
    parameters' gradient (the combine and its gradient on all 8 experts
    on every ``model`` rank), and the sort dispatch raised (no DTensor
    strategy for ``searchsorted``).
(b) deepseek-moe-16b's ``train_4k`` dry run on (data 16, model 16) at 1
    and 2 layers: the MoE layer's products (2 layers minus 1) have no
    whole E x C (64 x 480) dim, and its FLOPs are at most 1.05 x the count
    of the reference's placements (``reference_moe_layer_flops``); the
    ``moe_sort`` and ``combo`` variants, qwen3-0.6b's ``remat_names`` and
    mamba2-1.3b's ``ssm_mem`` run ``ok`` at 2 layers. These tests import
    no JAX, so they also run where JAX is not installed (torch 2.11 on
    the card's machine raised in ``combo`` and in every mamba2 train
    cell before).
(c) Four gloo ranks on the (2, 2) debug mesh: the MoE layer of dbrx's and
    deepseek-moe's smoke configs under both dispatches, its output and
    the gradients of every parameter and of the input against the
    unsharded port and the reference, at rtol 1e-5 with an absolute floor
    of 1e-5 of each tensor's largest magnitude; and qwen3's smoke config
    trained 3 steps with ``remat_policy="blk_out"`` on the mesh against
    one process (losses at rtol 1e-5), the remat policy saving as many
    block outputs on the mesh as on one process, and recomputing none.
(d) One gloo rank on a (data 1, model 1) mesh: 3 steps of the smoke
    configs of deepseek-moe (sort dispatch), dbrx (einsum dispatch) and
    qwen3 (``blk_out``), the state DTensors, against the plain path from
    the same seed: parameters ``torch.equal`` (on one rank the local
    products are the plain path's, in its order).
"""
import collections
import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
DEADLINE_S = 240
IMPLS = ("einsum", "sort")

# (a): the narrow width, the mesh and the tokens.
NARROW = dict(d_model=128, n_experts=8, top_k=2, d_ff_expert=64,
              dtype="float32")
MESH_A = (2, 4)
BATCH_A, SEQ_A = 4, 64

_REFERENCE_DOTS = r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.dryrun import arch_rules
from repro.models import layers as RL
from repro.sharding import rules as RR

narrow, (data, model), batch, seq = json.loads(sys.argv[1])
mesh = jax.make_mesh((data, model), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:data * model])


def dot_flops(hlo):
    shapes = {m.group(1): [int(v) for v in m.group(2).split(",") if v]
              for m in re.finditer(r"%([\w.\-]+) = \w+\[([0-9,]*)\]", hlo)}
    total = 0
    for m in re.finditer(r"= \w+\[([0-9,]*)\]\S* dot\(%([\w.\-]+), "
                         r"%[\w.\-]+\).*?lhs_contracting_dims=\{([0-9,]*)\}",
                         hlo):
        out = [int(v) for v in m.group(1).split(",") if v]
        lhs = shapes[m.group(2)]
        k = int(np.prod([lhs[int(i)] for i in m.group(3).split(",") if i]))
        total += 2 * int(np.prod(out)) * k
    return total


res = {}
for impl in ("einsum", "sort"):
    cfg = dataclasses.replace(get_config("dbrx-132b"), moe_impl=impl,
                              **narrow)
    RR.set_mesh(mesh, arch_rules(cfg, model))
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    shapes = {"router": (d, e), "w1": (e, d, f), "w3": (e, d, f),
              "w2": (e, f, d)}
    axes = RL.moe_axes(cfg)
    p = {k: jax.ShapeDtypeStruct(s, jnp.float32,
                                 sharding=RR.param_sharding(axes[k], s))
         for k, s in shapes.items()}
    xs = (batch, seq, d)
    x = jax.ShapeDtypeStruct(xs, jnp.float32, sharding=RR.param_sharding(
        ("batch", None, "blk_in_embed"), xs))
    apply = lambda p, x: RL.moe_apply(p, x, cfg)
    res[f"{impl}/forward"] = dot_flops(
        jax.jit(apply).lower(p, x).compile().as_text())
    grad = jax.grad(lambda p, x: jnp.sum(apply(p, x) ** 2))
    res[f"{impl}/params"] = dot_flops(
        jax.jit(grad).lower(p, x).compile().as_text())
print(json.dumps(res))
"""


def _narrow_cfg(impl):
    return dataclasses.replace(get_config("dbrx-132b"), moe_impl=impl,
                               **NARROW)


@pytest.fixture(scope="module")
def _reference_dots():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_DOTS,
         json.dumps([NARROW, MESH_A, BATCH_A, SEQ_A])],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_matmul_flops(impl: str, backward: bool) -> int:
    """Rank 0's matmul FLOPs of the MoE layer's forward or of the
    parameters' gradient of ``sum(layer(x) ** 2)`` on a fake 8-rank (2, 4)
    mesh, parameters and input DTensors of fake shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import replicate_plain, set_mesh
    cfg = _narrow_cfg(impl)
    module = L.MoE(cfg, device="meta", dtype=torch.float32)
    axes = L.moe_axes(cfg)
    with D.fake_world(MESH_A[0] * MESH_A[1]):
        mesh = make_mesh(MESH_A, ("data", "model"))
        set_mesh(mesh, D.arch_rules(cfg, MESH_A[1]))
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                for n, p in list(module.named_parameters()):
                    module._parameters[n] = torch.nn.Parameter(
                        D._dtensor(p, axes[n], mesh))
                x = D._dtensor(torch.empty(BATCH_A, SEQ_A, cfg.d_model,
                                           device="meta"),
                               ("batch", None, "blk_in_embed"), mesh)
            cost = D.DeviceCost()
            with cost, replicate_plain():
                out = L.moe_apply(module, x, cfg)
                if backward:
                    torch.autograd.grad((out ** 2).sum(),
                                        list(module.parameters()))
        finally:
            set_mesh(None)
    return cost.flops


@pytest.mark.parametrize("wrt", ["forward", "params"])
@pytest.mark.parametrize("impl", IMPLS)
def test_port_dots_equal_reference_dots(_reference_dots, impl, wrt):
    """(a) Each rank multiplies what the reference's partitioned HLO
    multiplies on a device, within 1%: the forward and the parameters'
    gradient (the forward's products included), both dispatches."""
    want = _reference_dots[f"{impl}/{wrt}"]
    got = _port_matmul_flops(impl, backward=wrt == "params")
    assert abs(got / want - 1) <= 0.01, (got, want)


# ---------------------------------------------------------------- (b)


def _capacity(cfg, seq: int) -> int:
    """Each expert's buffer slots a batch row, as the router sets them."""
    cap = math.ceil(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return min(max(cap, 4), seq)


def reference_moe_layer_flops(cfg, batch: int, seq: int, data: int,
                              model: int) -> int:
    """Per-device matmul FLOPs of one attention + MoE layer of the train
    step under the reference's placements on a (``data``, ``model``) mesh,
    every backward product on its forward product's shards (as
    ``test_torch_sharded_projections.reference_layer_flops`` counts the
    attention): tokens split over ``data``; q, K/V and ``wo`` on H·dh /
    ``model`` or d_model / ``model`` (the same count); the router
    contracted over d_model / ``model``; the shared experts on their d_ff
    / ``model``; the routed experts on the rank's E / ``model`` experts
    (capacity C per batch row), the einsum dispatch and combine over
    them. Each product runs forward, in the remat's recompute and twice
    in the backward pass (a gradient for each operand), but the dispatch
    once (no gradient of its one-hot) and the block's last product (the
    shared ``w2``, or the combine), which the recompute stops before; QK
    and PV on the rank's heads of its sequences, four times each."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    e, f = cfg.n_experts, cfg.d_ff_expert
    t, rows = batch * seq // data, batch // data
    cap = _capacity(cfg, seq)
    slots = rows * (e // model) * cap
    forward = {"attention": 2 * t * (2 * d * h * dh + 2 * d * cfg.n_kv * dh)
               // model,
               "router": 2 * t * (d // model) * e,
               "shared": 2 * t * 3 * d * (cfg.n_shared * f // model),
               "experts": 2 * slots * 3 * d * f}
    dispatch = combine = 0
    if cfg.moe_impl == "einsum":
        dispatch = combine = 2 * rows * seq * (e // model) * cap * d
    last = 2 * t * d * (cfg.n_shared * f // model) if cfg.n_shared \
        else combine
    dense = sum(forward.values())
    attention = 4 * 2 * 2 * rows * (h // model) * seq * seq * dh
    return 4 * dense + 3 * dispatch + 4 * combine - last + attention


def _tally(arch: str, n_layers: int, variant=None):
    """The dry run's per-device FLOPs of ``arch``'s train_4k on (16, 16)
    cut to ``n_layers``, and its matmuls' FLOPs by operand shapes."""
    from repro_torch.launch import dryrun as D
    tally = collections.Counter()
    dispatch = D.DeviceCost.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            tally[shapes] += self.flops - before
        return out

    D.DeviceCost.__torch_dispatch__ = counting
    try:
        res = D.run_cell(arch, "train_4k", multi_pod=False,
                         n_layers=n_layers, variant=variant)
    finally:
        D.DeviceCost.__torch_dispatch__ = dispatch
    assert res.get("ok"), res.get("error")
    return res["cost_analysis"]["flops"], tally


@pytest.mark.parametrize("variant", [None, "moe_sort"])
def test_train_4k_moe_layer_on_reference_shards(variant):
    """(b) deepseek-moe-16b's MoE layer of train_4k on (16, 16), either
    dispatch: no product has a whole E x C dim (every expert's buffer),
    and the layer's FLOPs are at most 1.05 x the count of the reference's
    placements."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    torch.set_num_threads(1)
    (one, t1), (two, t2) = (_tally("deepseek-moe-16b", n, variant)
                            for n in (1, 2))
    cfg, _ = D._config("deepseek-moe-16b", variant, None, False)
    info = S.SHAPES["train_4k"]
    layer = {k: v - t1.get(k, 0) for k, v in t2.items() if v != t1.get(k)}
    slots = cfg.n_experts * _capacity(cfg, info["seq"])
    wide = [k for k in layer if slots in {n for s in k for n in s}]
    assert not wide, wide
    want = reference_moe_layer_flops(cfg, info["batch"], info["seq"], 16,
                                     16)
    assert two - one <= 1.05 * want, (two - one, want)


@pytest.mark.parametrize("arch,variant", [("deepseek-moe-16b", "combo"),
                                          ("qwen3-0.6b", "remat_names"),
                                          ("mamba2-1.3b", "ssm_mem")])
def test_moe_and_remat_variants_run(arch, variant):
    """(b) The dry run's variants that raised before run ``ok`` at 2
    layers: ``combo`` (the sort dispatch, bf16 casts, the SSD's bf16
    chunks, the sequence-sharded residual, whose logits' product raised
    on torch 2.11), ``remat_names`` (the ``blk_out`` policy, whose
    ``checkpoint_name`` had no DTensor rule) and mamba2's ``ssm_mem``
    (its tied table's two gradients could not be added on torch 2.11)."""
    from repro_torch.launch import dryrun as D
    torch.set_num_threads(1)
    res = D.run_cell(arch, "train_4k", multi_pod=False, n_layers=2,
                     variant=variant)
    assert res.get("ok"), res.get("error")


# ---------------------------------------------------------------- (c)

B, S = 4, 32
RESID = ("batch", "resid_seq", "resid_embed")
MOE_ARCHS = ("dbrx-132b", "deepseek-moe-16b")
CASES = [(arch, impl) for arch in MOE_ARCHS for impl in IMPLS]
HYPER = dict(lr=1e-3, warmup_steps=1, total_steps=40)
STEPS, BATCH, SEQ = 3, 4, 64


def _cfg(arch, impl):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", moe_impl=impl)


def _case(arch, impl):
    """(MoE module with seeded f32 weights, the apply function, the input,
    the output's cotangent), all on the CPU."""
    cfg = _cfg(arch, impl)
    gen = torch.Generator().manual_seed(7)
    module = L.MoE(cfg, device="cpu", dtype=torch.float32)
    module.reset_parameters(cfg, gen)

    def apply(p, x):
        return L.moe_apply(p, x, cfg)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    ct = torch.randn(B, S, cfg.d_model, generator=gen)
    return module, apply, x, ct


def _grads(module, apply, x, ct):
    out = apply(module, x)
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad((out * ct).sum(),
                                list(module.parameters()) + [x])
    return out, dict(zip(names + ["x"], grads))


def _remat_cfg():
    return dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                               dtype="float32", remat_policy="blk_out")


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the runs of ``checkpoint_name`` on plain tensors: on a mesh
    it declines DTensor ops, so it sees each rank's local op; not those on
    fake tensors (DTensor's shape propagation)."""

    def __init__(self):
        super().__init__()
        self.runs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.repro_torch.checkpoint_name.default and \
                not isinstance(args[0], FakeTensor):
            self.runs += 1
        return func(*args, **(kwargs or {}))


def _train_blk_out(root: str, name: str) -> dict:
    """qwen3's smoke config under ``blk_out`` trained STEPS steps from the
    port's seeded init; its losses, the block outputs the remat policy
    saved (a forward pass's ``MUST_SAVE`` on ``checkpoint_name``) and the
    runs of the op (forward passes and recomputes)."""
    from repro_torch.models import model as M
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import Hyper
    policy = M._POLICIES["blk_out"]
    saved = collections.Counter()

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if op is torch.ops.repro_torch.checkpoint_name.default and \
                not ctx.is_recompute:
            saved[out.name] += 1
        return out

    M._POLICIES["blk_out"] = counting
    ops = _OpCount()
    try:
        with ops:
            _, hist = train(_remat_cfg(), Hyper(**HYPER), steps=STEPS,
                            batch=BATCH, seq=SEQ,
                            ckpt_dir=os.path.join(root, name),
                            ckpt_every=100, verbose=False, device="cpu")
    finally:
        M._POLICIES["blk_out"] = policy
    return {"loss": hist["loss"], "saved": dict(saved), "runs": ops.runs}


def _mesh_rank(rank: int, world: int, init_file: str, root: str):
    """One of four ranks on the (2, 2) debug mesh: each case's parameters,
    input and cotangent sharded by their logical axes, then the ``blk_out``
    training; rank 0 saves the gathered outputs and gradients and the
    training's record."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import placements, replicate_plain, set_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    got = {}
    try:
        mesh = make_debug_mesh()
        for arch, impl in CASES:
            cfg = _cfg(arch, impl)
            set_mesh(mesh, arch_rules(cfg, 2))
            module, apply, x, ct = _case(arch, impl)
            axes = L.moe_axes(cfg)
            for n, p in list(module.named_parameters()):
                owner, _, attr = n.rpartition(".")
                sub = module.get_submodule(owner) if owner else module
                ax = axes[owner][attr] if owner else axes[attr]
                sub._parameters[attr] = torch.nn.Parameter(distribute_tensor(
                    p.detach(), mesh, placements(ax, p.shape)))
            xd, ctd = (distribute_tensor(t, mesh, placements(ax, t.shape))
                       for t, ax in ((x, ("batch", None, "blk_in_embed")),
                                     (ct, RESID)))
            with replicate_plain():
                out, grads = _grads(module, apply, xd.requires_grad_(), ctd)
            got[f"{arch}/{impl}"] = {
                "out": out.full_tensor().detach(),
                "out_placements": [repr(p) for p in out.placements],
                "grads": {n: g.full_tensor() for n, g in grads.items()}}
        set_mesh(mesh, arch_rules(_remat_cfg(), 2))
        got["blk_out"] = _train_blk_out(root, "mesh")
        if rank == 0:
            torch.save(got, os.path.join(root, "mesh.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _mesh(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_moe"))
    ctx = torch.multiprocessing.spawn(
        _mesh_rank, args=(4, os.path.join(root, "init"), root), nprocs=4,
        join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the mesh ranks did not finish in {DEADLINE_S} s")
    return torch.load(os.path.join(root, "mesh.pt")), root


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("arch,impl", CASES)
def test_mesh_moe_matches_unsharded_port(_mesh, arch, impl):
    """(c) Against the unsharded port on the same weights; the output on
    the residual stream's placements (d_model split over ``model``)."""
    torch.set_num_threads(1)
    module, apply, x, ct = _case(arch, impl)
    out, grads = _grads(module, apply, x.requires_grad_(), ct)
    got = _mesh[0][f"{arch}/{impl}"]
    assert got["out_placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
    _close(got["out"], out.detach(), "out")
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        _close(got["grads"][name], g, name)


def _reference(arch, impl):
    """The reference's output and gradients of the same loss on the same
    weights (its layouts are the port's), ``jax.value_and_grad``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import layers as RL
    rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                               dtype="float32", moe_impl=impl)
    module, _, x, ct = _case(arch, impl)
    p = {}
    for n, t in module.named_parameters():
        owner, _, attr = n.rpartition(".")
        (p.setdefault(owner, {}) if owner else p)[attr] = \
            jnp.asarray(t.detach().numpy())

    def loss(p, x):
        out = RL.moe_apply(p, x, rcfg)
        return (out * ct.numpy()).sum(), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x.numpy()))
    flat = {}
    for n, g in gp.items():
        if isinstance(g, dict):
            flat.update({f"{n}.{k}": np.asarray(v) for k, v in g.items()})
        else:
            flat[n] = np.asarray(g)
    return np.asarray(out), {**flat, "x": np.asarray(gx)}


@pytest.mark.parametrize("arch,impl", CASES)
def test_mesh_moe_matches_reference(_mesh, arch, impl):
    """(c) Against the reference's layer on the same weights."""
    out, grads = _reference(arch, impl)
    got = _mesh[0][f"{arch}/{impl}"]
    _close(got["out"], out, "out")
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        _close(got["grads"][name], g, name)


def test_mesh_blk_out_training_matches_single_process(_mesh):
    """(c) qwen3's smoke config under ``blk_out`` on the mesh against one
    process: losses at rtol 1e-5; the policy saves both block outputs of
    every layer in every forward pass, on the mesh as on one process, and
    ``checkpoint_name`` runs once for each (none is recomputed)."""
    got, root = _mesh
    torch.set_num_threads(1)
    want = _train_blk_out(root, "single")
    mesh = got["blk_out"]
    np.testing.assert_allclose(mesh["loss"], want["loss"], rtol=RTOL)
    n = STEPS * _remat_cfg().n_layers
    assert want["saved"] == {"MUST_SAVE": 2 * n}, want["saved"]
    assert mesh["saved"] == want["saved"]
    assert mesh["runs"] == want["runs"] == 2 * n


# ---------------------------------------------------------------- (d)

ONE_RANK = {
    "deepseek-moe-16b/sort": ("deepseek-moe-16b", {"moe_impl": "sort"}),
    "dbrx-132b/einsum": ("dbrx-132b", {}),
    "qwen3-0.6b/blk_out": ("qwen3-0.6b", {"remat_policy": "blk_out"})}


def _steps(cfg, mesh) -> dict:
    """STEPS train steps of ``cfg`` from seed 0 on ``mesh`` (installed, the
    state and each batch sharded) or, with ``mesh`` None, the plain path;
    the parameters after them."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.sharding import set_mesh
    from repro_torch.train.loop import shard_batch
    from repro_torch.train.optimizer import Hyper
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)
    set_mesh(mesh, None if mesh is None else arch_rules(cfg, 1))
    try:
        pipe = TokenPipeline(cfg.vocab, BATCH, SEQ, seed=0)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        if mesh is not None:
            state = shard_state(state)
        step = make_train_step(cfg, Hyper(**HYPER))
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v)
                     for k, v in pipe.host_slice(i).items()}
            if mesh is not None:
                batch = shard_batch(batch, mesh, BATCH, SEQ)
            state, _ = step(state, batch)
    finally:
        set_mesh(None)
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
            .detach() for n, p in state.params.named_parameters()}


def _one_rank(rank: int, world: int, init_file: str, root: str):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        got = {}
        for name, (arch, over) in ONE_RANK.items():
            cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
            got[name] = (_steps(cfg, mesh), _steps(cfg, None))
        torch.save(got, os.path.join(root, "one_rank.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _one_rank_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("one_rank_moe"))
    ctx = torch.multiprocessing.spawn(
        _one_rank, args=(1, os.path.join(root, "init"), root), nprocs=1,
        join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the rank did not finish in {DEADLINE_S} s")
    return torch.load(os.path.join(root, "one_rank.pt"))


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_mesh_steps_equal_plain_steps(_one_rank_runs, name):
    """(d) The (1, 1)-mesh steps are the plain steps bit for bit."""
    mesh, plain = _one_rank_runs[name]
    assert mesh.keys() == plain.keys()
    unequal = [n for n in plain if not torch.equal(mesh[n], plain[n])]
    assert not unequal, unequal
