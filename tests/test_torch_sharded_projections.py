"""The sharded step's projections (``models/layers.py::_project``): under a
mesh each rank multiplies the shards that the reference's placements give
it. q, K/V, ``w1`` and ``w3`` are column parallel on a gathered block input
(q on ``heads``, ``w1``/``w3`` on ``tensor``, K/V, whose heads the ``model``
dim may not divide, on an even split of their columns, gathered whole
after); ``wo`` and ``w2`` are row parallel, their partial sums
reduce-scattered to the residual stream's placements.

(a) The reference's per-device dots: ``jax.grad`` of its ``attention_apply``
    and ``mlp_apply`` compiled on a (data 2, model 4) mesh of 8 CPU devices
    (a subprocess; ``AxisType.Auto`` axes) at a narrow qwen3-like width
    whose heads and d_ff divide 4 and whose kv heads do not; the dots'
    FLOPs read from the partitioned HLO (``tests/hlo_dots.py``; at this
    length the attention runs in one chunk, in no loop). The same layers
    on a fake 8-rank (2, 4) mesh under the dry run's ``DeviceCost``:
    per-device matmul FLOPs within 1% of the reference's, for the
    parameters' gradients, and for the MLP also with the input's. With the
    input's gradient the reference's GSPMD computes K/V's whole (T, d) on
    every rank; the port computes its split, so it reads less there.
(b) qwen3-0.6b's ``train_4k`` dry run on (data 16, model 16) at 1 and 2
    layers: the layer's products (2 layers minus 1) have no full head
    (H x dh = 2048) or d_ff (3072) dim, and its FLOPs are at most 1.05 x
    the count of the reference's placements (``reference_layer_flops``).
    This test imports no JAX, so it also runs where JAX is not installed.
(c) Four gloo ranks on the (2, 2) debug mesh: attention and MLP outputs
    and the gradients of every parameter and of the input against the
    unsharded port and the reference, at the tolerances of
    ``test_torch_sharded_attention.py`` (rtol 1e-5, an absolute floor of
    1e-5 of each tensor's largest magnitude): qwen3's smoke config with
    one kv head (K/V split by columns), gemma2's (heads not shardable:
    the attention whole on ``model``, its output projection split by
    d_model's columns) and deepseek-moe's shared-expert MLP.
"""
import collections
import dataclasses
import datetime
import json
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
DEADLINE_S = 180

# (a): the narrow width, the mesh and the tokens.
NARROW = dict(d_model=128, n_heads=8, n_kv=2, head_dim=32, d_ff=384,
              dtype="float32")
MESH_A = (2, 4)
BATCH_A, SEQ_A = 4, 64

_REFERENCE_DOTS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.dryrun import arch_rules
from repro.models import layers as RL
from repro.sharding import rules as RR
from hlo_dots import dots

narrow, (data, model), batch, seq = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config("qwen3-0.6b"), **narrow)
mesh = jax.make_mesh((data, model), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:data * model])
RR.set_mesh(mesh, arch_rules(cfg, model))
d, h, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                    cfg.d_ff)
layers = {
    "attention": ({"wq": (d, h, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
                   "wo": (h, dh, d), "q_norm": (dh,), "k_norm": (dh,)},
                  RL.attention_axes(cfg),
                  lambda p, x: RL.attention_apply(p, x, cfg, local=False)[0]),
    "mlp": ({"w1": (d, f), "w3": (d, f), "w2": (f, d)}, RL.mlp_axes(),
            lambda p, x: RL.mlp_apply(p, x, cfg)),
}

res = {}
for name, (shapes, axes, apply) in layers.items():
    p = {k: jax.ShapeDtypeStruct(s, jnp.float32,
                                 sharding=RR.param_sharding(axes[k], s))
         for k, s in shapes.items()}
    xs = (batch, seq, d)
    x = jax.ShapeDtypeStruct(xs, jnp.float32, sharding=RR.param_sharding(
        ("batch", None, "blk_in_embed"), xs))
    for wrt, argnums in (("params", 0), ("params_x", (0, 1))):
        grad = jax.grad(lambda p, x: jnp.sum(apply(p, x) ** 2), argnums)
        res[f"{name}/{wrt}"] = dots(
            jax.jit(grad).lower(p, x).compile().as_text())[0]
print(json.dumps(res))
"""


def _narrow_cfg():
    return dataclasses.replace(get_config("qwen3-0.6b"), **NARROW)


@pytest.fixture(scope="module")
def _reference_dots():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_DOTS,
         json.dumps([NARROW, MESH_A, BATCH_A, SEQ_A])],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_matmul_flops(name: str, wrt_x: bool) -> int:
    """Rank 0's matmul FLOPs of the gradient of ``sum(layer(x) ** 2)``
    (the parameters', and the input's with ``wrt_x``) on a fake 8-rank
    (2, 4) mesh, parameters and input DTensors of fake shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import replicate_plain, set_mesh
    cfg = _narrow_cfg()
    module, axes, apply = {
        "attention": (L.Attention, L.attention_axes(cfg),
                      lambda p, x: L.attention_apply(p, x, cfg,
                                                     local=False)),
        "mlp": (L.MLP, L.mlp_axes(), lambda p, x: L.mlp_apply(p, x, cfg)),
    }[name]
    module = module(cfg, device="meta", dtype=torch.float32)
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
                x.requires_grad_(wrt_x)
            cost = D.DeviceCost()
            wrt = list(module.parameters()) + ([x] if wrt_x else [])
            with cost, replicate_plain():
                torch.autograd.grad((apply(module, x) ** 2).sum(), wrt)
        finally:
            set_mesh(None)
    return cost.flops


@pytest.mark.parametrize("name", ["attention", "mlp"])
def test_port_dots_equal_reference_dots(_reference_dots, name):
    """(a) The parameters' gradients: each rank multiplies what the
    reference's partitioned HLO multiplies on a device, within 1%."""
    want = _reference_dots[f"{name}/params"]
    got = _port_matmul_flops(name, wrt_x=False)
    assert abs(got / want - 1) <= 0.01, (got, want)


def test_port_dots_with_input_gradient(_reference_dots):
    """(a) With the input's gradient too: the MLP's equal the reference's
    within 1%; the attention's are below them, since the reference
    computes K/V's input gradient whole on every rank (T x Hkv dh x d
    twice) where the port computes its column split."""
    got = _port_matmul_flops("mlp", wrt_x=True)
    want = _reference_dots["mlp/params_x"]
    assert abs(got / want - 1) <= 0.01, (got, want)
    cfg = _narrow_cfg()
    tokens = BATCH_A * SEQ_A // MESH_A[0]
    whole = 2 * 2 * tokens * cfg.n_kv * cfg.head_dim * cfg.d_model
    got = _port_matmul_flops("attention", wrt_x=True)
    want = _reference_dots["attention/params_x"]
    assert got == want - whole + whole // MESH_A[1], (got, want)


def reference_layer_flops(cfg, batch: int, seq: int, data: int,
                          model: int) -> int:
    """Per-device matmul FLOPs of one attention + MLP layer of the train
    step under the reference's placements on a (``data``, ``model``) mesh,
    every backward product on its forward product's shards: tokens split
    over ``data``; q and ``wo`` on the rank's H / model heads, K/V on
    d_model / model of the contraction (the reference's dots; n_kv does
    not divide ``model``), ``w1``/``w3``/``w2`` on d_ff / model. Forward 2,
    backward 4 and the remat's recompute 2 FLOPs a weight and token but
    for ``w2`` (``dryrun.analytic_train_flops``); QK and PV on the rank's
    heads of its sequences, four times each."""
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    t = batch * seq // data
    forward = 2 * t * (d * h * dh // model                     # q
                       + 2 * (d // model) * cfg.n_kv * dh      # k, v
                       + h * dh // model * d                   # o
                       + 3 * d * (f // model))                 # w1, w3, w2
    recompute = forward - 2 * t * (f // model) * d
    attention = 4 * 2 * 2 * (batch // data) * (h // model) * seq * seq * dh
    return 3 * forward + recompute + attention


def _tally(n_layers: int):
    """The dry run's per-device FLOPs of qwen3-0.6b's train_4k on (16, 16)
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
        res = D.run_cell("qwen3-0.6b", "train_4k", multi_pod=False,
                         n_layers=n_layers)
    finally:
        D.DeviceCost.__torch_dispatch__ = dispatch
    assert res.get("ok"), res.get("error")
    return res["cost_analysis"]["flops"], tally


def test_train_4k_layer_on_reference_shards():
    """(b) One layer of train_4k on (16, 16): no product has a whole head
    dim or d_ff dim, and the layer's FLOPs are at most 1.05 x the count of
    the reference's placements."""
    from repro_torch.launch import specs as S
    torch.set_num_threads(1)
    (one, t1), (two, t2) = _tally(1), _tally(2)
    cfg, info = get_config("qwen3-0.6b"), S.SHAPES["train_4k"]
    layer = {k: v - t1.get(k, 0) for k, v in t2.items() if v != t1.get(k)}
    whole = {cfg.n_heads * cfg.head_dim, cfg.d_ff}
    wide = [k for k in layer if whole & {n for s in k for n in s}]
    assert not wide, wide
    want = reference_layer_flops(cfg, info["batch"], info["seq"], 16, 16)
    assert two - one <= 1.05 * want, (two - one, want)


# ---------------------------------------------------------------- (c)

B, S = 4, 32
RESID = ("batch", "resid_seq", "resid_embed")
CASES = {"qwen3-0.6b": ("attention", "mlp"), "gemma2-2b": ("attention",
                                                           "mlp"),
         "deepseek-moe-16b": ("shared",)}


def _cfg(arch):
    over = {"dtype": "float32"}
    if arch == "qwen3-0.6b":
        over["n_kv"] = 1            # K/V whole on model = 2: column split
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def _case(arch, layer):
    """(module with seeded f32 weights, its axes, the apply function, the
    input, the output's cotangent), all on the CPU."""
    cfg = _cfg(arch)
    gen = torch.Generator().manual_seed(7)
    if layer == "attention":
        module = L.Attention(cfg, device="cpu", dtype=torch.float32)
        module.reset_parameters(cfg, gen)
        if cfg.qk_norm:
            with torch.no_grad():
                module.q_norm.normal_(0, 0.3, generator=gen)
                module.k_norm.normal_(0, 0.3, generator=gen)
        axes = L.attention_axes(cfg)

        def apply(p, x):
            return L.attention_apply(p, x, cfg, local=False)
    else:
        d_ff = cfg.d_ff_expert * cfg.n_shared if layer == "shared" else None
        module = L.MLP(cfg, d_ff=d_ff, device="cpu", dtype=torch.float32)
        module.reset_parameters(cfg, gen)
        axes = L.mlp_axes()

        def apply(p, x):
            return L.mlp_apply(p, x, cfg)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    ct = torch.randn(B, S, cfg.d_model, generator=gen)
    return module, axes, apply, x, ct


def _grads(module, apply, x, ct):
    out = apply(module, x)
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad((out * ct).sum(),
                                list(module.parameters()) + [x])
    return out, dict(zip(names + ["x"], grads))


def _mesh_rank(rank: int, world: int, init_file: str, root: str):
    """One of four ranks on the (2, 2) debug mesh: each case's parameters,
    input and cotangent sharded by their logical axes; rank 0 saves the
    gathered outputs and gradients."""
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
        for arch, layers in CASES.items():
            set_mesh(mesh, arch_rules(_cfg(arch), 2))
            for layer in layers:
                module, axes, apply, x, ct = _case(arch, layer)
                for n, p in list(module.named_parameters()):
                    setattr(module, n, torch.nn.Parameter(distribute_tensor(
                        p.detach(), mesh, placements(axes[n], p.shape))))
                xd, ctd = (distribute_tensor(t, mesh, placements(ax, t.shape))
                           for t, ax in ((x, ("batch", None, "blk_in_embed")),
                                         (ct, RESID)))
                with replicate_plain():
                    out, grads = _grads(module, apply, xd.requires_grad_(),
                                        ctd)
                got[f"{arch}/{layer}"] = {
                    "out": out.full_tensor().detach(),
                    "out_placements": [repr(p) for p in out.placements],
                    "grads": {n: g.full_tensor() for n, g in grads.items()}}
        if rank == 0:
            torch.save(got, os.path.join(root, "mesh.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _mesh(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_projections"))
    ctx = torch.multiprocessing.spawn(
        _mesh_rank, args=(4, os.path.join(root, "init"), root), nprocs=4,
        join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the mesh ranks did not finish in {DEADLINE_S} s")
    return torch.load(os.path.join(root, "mesh.pt"))


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=name)


PAIRS = [(arch, layer) for arch, layers in CASES.items() for layer in layers]


@pytest.mark.parametrize("arch,layer", PAIRS)
def test_mesh_projections_match_unsharded_port(_mesh, arch, layer):
    """(c) Against the unsharded port on the same weights; the output on
    the residual stream's placements (d_model split over ``model``)."""
    torch.set_num_threads(1)
    module, _, apply, x, ct = _case(arch, layer)
    out, grads = _grads(module, apply, x.requires_grad_(), ct)
    got = _mesh[f"{arch}/{layer}"]
    assert got["out_placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
    _close(got["out"], out.detach(), "out")
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        _close(got["grads"][name], g, name)


def _reference(arch, layer):
    """The reference's output and gradients of the same loss on the same
    weights (its layouts are the port's), ``jax.value_and_grad``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import layers as RL
    cfg = _cfg(arch)
    rcfg = dataclasses.replace(
        ref_config(arch, smoke=True), dtype="float32",
        **({"n_kv": cfg.n_kv} if arch == "qwen3-0.6b" else {}))
    module, _, _, x, ct = _case(arch, layer)
    p = {n: jnp.asarray(t.detach().numpy())
         for n, t in module.named_parameters()}
    if layer == "attention":
        def apply(p, x):
            return RL.attention_apply(p, x, rcfg, local=False)[0]
    else:
        def apply(p, x):
            return RL.mlp_apply(p, x, rcfg)

    def loss(p, x):
        out = apply(p, x)
        return (out * ct.numpy()).sum(), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x.numpy()))
    return np.asarray(out), {**{n: np.asarray(g) for n, g in gp.items()},
                             "x": np.asarray(gx)}


@pytest.mark.parametrize("arch,layer", PAIRS)
def test_mesh_projections_match_reference(_mesh, arch, layer):
    """(c) Against the reference's layer on the same weights."""
    out, grads = _reference(arch, layer)
    got = _mesh[f"{arch}/{layer}"]
    _close(got["out"], out, "out")
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        _close(got["grads"][name], g, name)
