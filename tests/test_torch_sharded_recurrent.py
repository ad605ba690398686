"""The SSD's and the RG-LRU's projections, the MoE router and the tied
logits under a mesh: each rank multiplies the shards that the reference's
placements give it (``models/layers.py::_project``).

(a) The reference's per-device dots: ``jax.grad`` of mamba2's
    ``ssm_apply``, recurrentgemma's ``rglru_apply``, dbrx's
    ``_moe_router``, the tied head with the loss's tail (a vocab of 512,
    which ``model`` divides, and of 514, which it does not) and gemma2's
    attention with its heads whole on ``model`` (its chunks in a scan),
    for the parameters and for the parameters and the input, under the
    base rules and the ``zero_r`` and ``seq_sp`` variants, compiled on a
    (data 2, model 4) mesh of 8 CPU devices (a subprocess;
    ``AxisType.Auto`` axes) at a narrow width; the dots' FLOPs read from
    the partitioned HLO, each dot once for every run of its computation,
    a loop's body once a trip (``tests/hlo_dots.py``). The same on a fake
    8-rank (2, 4) mesh under the dry run's ``DeviceCost``
    (``scripts/torch_narrow_sharding.py``): the per-device matmul FLOPs
    within 1% of the reference's. For the SSD the projections are its 2-D
    products (``in_proj``, ``out_proj``; the scan's einsums are contracted
    in another order by the two compilers). Where the port reads (M - 1)
    / M of one product less: the reference computes the router's input
    gradient whole from the gathered router on every ``model`` rank, the
    port on its d_model split; under ``seq_sp`` with a vocab ``model``
    does not divide the reference computes the table's gradient whole on
    every rank at this width, from each rank's own tokens at full width,
    as the port does at both; in gemma2's attention the reference computes
    the q/k/v input gradient whole on every ``model`` rank, and under
    ``zero_r`` (the block input whole on d_model) the q/k/v projection and
    its weight gradient too, where the port computes each on its split.
    mamba2's head at full width equals the reference's dots compiled on
    256 devices under the base rules and ``seq_sp``, and so does the
    attention of gemma2-2b, minitron-4b and musicgen-medium (the base
    rules, the parameters' gradient; their heads whole on ``model``).
    Before these placements were stated the SSD's ``in_proj`` gradient
    under ``zero_r`` read 4x (all its columns on every rank), the router
    under ``zero_r`` 0.62x and 0.50x, and the head had no function of its
    own. Each rank's peak (its allocations and its inputs' shards, each
    storage counted once) is at most 1.15x the reference's
    ``memory_analysis()`` (the SSD's 0.90x), mamba2's head at full width
    too, and so is dbrx's MoE (8 experts, top 2, d_ff_expert 64) under
    both dispatches (``_expert_ffn``, the sort's dispatch and combine by
    buffer row), and so are qwen3's attention and MLP, gemma2's
    attention, and the attention of the three archs at full width: the
    RG-LRU scans each rank's rows and channels, the router routes each
    rank's rows, the loss holds no f32 copy of the logits, the MoE gathers
    each expert weight inside its product and keeps no scaled or gathered
    copy of the dispatched rows, and the attention lays K and V out once
    for every query chunk and keeps no permuted copy of the probabilities
    (before: up to 1.83x, 2.06x and 1.76x; the MoE 1.58x
    under the einsum dispatch, 1.30x under the sort dispatch; gemma2's
    attention 1.22x).
(b) One layer (2 layers' tally minus 1's) of mamba2-1.3b's and
    recurrentgemma-9b's ``train_4k`` dry run on (data 16, model 16): no
    product over a whole dim that the reference splits (mamba2's in_proj
    width 8,512 or d_inner 4,096; a whole 4,096 x 4,096 block of
    recurrentgemma's d_model x rnn_width), and at most 1.01 x the count of
    the reference's placements; mamba2's ``zero_r`` cell at 1.01 x its
    base cell's FLOPs at most (the reference's narrow dots are the same
    under both, (a)). These tests import no JAX, so they also run where
    JAX is not installed. Before these placements were stated both layers
    had such products, and ``zero_r`` read 1.63x. Each cell's peak at 1
    and 2 layers within ``LAYER_PEAK``, with no buffer of the global batch
    and at most two f32 tensors of the rank's logits live at it.
(c) Four gloo ranks on the (2, 2) debug mesh: the SSD and the RG-LRU of
    the smoke configs, dbrx's router and the tied head with the loss (a
    vocab of 512 and of 511; the base rules, ``seq_sp``, and ``zero_r``
    for the SSD and the router): the outputs and the gradients of every
    parameter and of the input against the unsharded port and the
    reference, at rtol 1e-5 with an absolute floor of 1e-5 of each
    tensor's largest magnitude (the SSD against the reference at rtol
    1e-4, as ``tests/test_torch_models.py`` holds it); and the RG-LRU
    chained from a carried state (a prefill from a cache), the new state
    on the cache's placements, against the unsharded port.
(d) One gloo rank on a (data 1, model 1) mesh: 3 steps of mamba2's and
    recurrentgemma's smoke configs, the state DTensors, against the plain
    path from the same seed: parameters ``torch.equal``.

The reference's compile and the ranks of (c) and (d) start with the
module and run beside (a)'s and (b)'s in-process work. Run as a script,
``PYTHONPATH=src python tests/test_torch_sharded_recurrent.py [--out
FILE]``, the file prints (a)'s cases of both packages side by side, FLOPs
and peak bytes (the reference's ``memory_analysis()``).
"""
import dataclasses
import datetime
import functools
import importlib.util
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
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
DEADLINE_S = 240


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N = _script("torch_narrow_sharding")
# Each narrow case traced once for the module's tests.
_port = functools.lru_cache(maxsize=None)(N.port)

_REFERENCE_DOTS = r"""
import json, os, sys
narrow, cases, (data, model), batch, seq, full = json.loads(sys.argv[1])
devices = max([data * model] + [f[5] * f[6] for f in full])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
import dataclasses
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.dryrun import VARIANTS, arch_rules
from repro.models import layers as RL
from repro.sharding import rules as RR
from repro.sharding.rules import constrain
from hlo_dots import dots

mesh = jax.make_mesh((data, model), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:data * model])
RESID = ("batch", "resid_seq", "resid_embed")


def case(layer, batch=batch, seq=seq):
    arch, over = narrow.get(layer) or narrow.get(layer.rstrip("0123456789"),
                                                 (layer, {}))
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
    d = cfg.d_model
    x_axes = ("batch", None, "blk_in_embed")
    if layer == "ssm":
        din, n = cfg.ssm_expand * d, cfg.ssm_state
        nh = din // cfg.ssm_head_dim
        shapes = {"in_proj": (d, 2 * din + 2 * n + nh),
                  "conv_w": (cfg.ssm_conv, din + 2 * n), "A_log": (nh,),
                  "dt_bias": (nh,), "D": (nh,), "out_proj": (din, d)}
        axes = RL.ssm_axes()
        loss = lambda p, x: jnp.sum(constrain(
            RL.ssm_apply(p, x, cfg)[0], *RESID) ** 2)
    elif layer == "rec":
        w = cfg.rnn_width
        shapes = {"in_x": (d, w), "in_gate": (d, w),
                  "conv_w": (cfg.rnn_conv, w), "w_input_gate": (w, w),
                  "w_rec_gate": (w, w), "lam": (w,), "out_proj": (w, d)}
        axes = RL.rglru_axes()
        loss = lambda p, x: jnp.sum(constrain(
            RL.rglru_apply(p, x, cfg)[0], *RESID) ** 2)
    elif layer == "router":
        shapes = {"router": (d, cfg.n_experts)}
        axes = {"router": RL.moe_axes(cfg)["router"]}
        loss = lambda p, x: jnp.sum(RL._moe_router(p, x, cfg)[0] ** 2)
    elif layer.partition("_")[0] in ("attention", "mlp", "moe"):
        h, hkv, dh, f = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff
        e, fe = cfg.n_experts, cfg.d_ff_expert
        shapes, axes, apply = {
            "attention": ({"wq": (d, h, dh), "wk": (d, hkv, dh),
                           "wv": (d, hkv, dh), "wo": (h, dh, d),
                           "q_norm": (dh,), "k_norm": (dh,)},
                          RL.attention_axes(cfg),
                          lambda p, x: RL.attention_apply(
                              p, x, cfg, local=False)[0]),
            "mlp": ({"w1": (d, f), "w3": (d, f), "w2": (f, d)},
                    RL.mlp_axes(), lambda p, x: RL.mlp_apply(p, x, cfg)),
            "moe": ({"router": (d, e), "w1": (e, d, fe), "w3": (e, d, fe),
                     "w2": (e, fe, d)}, RL.moe_axes(cfg),
                    lambda p, x: RL.moe_apply(p, x, cfg)),
        }[layer.partition("_")[0]]
        shapes = {k: s for k, s in shapes.items() if k in axes}
        loss = lambda p, x: jnp.sum(constrain(apply(p, x), *RESID) ** 2)
    else:
        if layer.startswith("head"):
            cfg = dataclasses.replace(cfg, vocab=int(layer[4:]))
        shapes = {"embed": (cfg.vocab, d), "ln_f": (d,)}
        axes = {"embed": ("vocab", "fsdp"), "ln_f": (None,)}
        x_axes = RESID
        labels = (jnp.arange(batch * seq, dtype=jnp.int32)
                  % cfg.vocab).reshape(batch, seq)

        def loss(p, x):
            x = RL.rms_norm(x, p["ln_f"], upcast=cfg.norm_upcast)
            logits = jnp.einsum("bsd,vd->bsv", x, p["embed"])
            logits = constrain(logits, "batch", None, "vocab")
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, labels[..., None], axis=-1)
            return jnp.mean(lse - gold[..., 0])
    return cfg, shapes, axes, x_axes, loss


def compile_case(layer, rules_name, wrt, mesh, batch, seq):
    cfg, shapes, axes, x_axes, loss = case(layer, batch, seq)
    rules = arch_rules(cfg, mesh.shape["model"])
    if rules_name != "base":
        rules.update(VARIANTS[rules_name]["rules"])
    RR.set_mesh(mesh, rules)
    p = {k: jax.ShapeDtypeStruct(s, jnp.float32,
                                 sharding=RR.param_sharding(axes[k], s))
         for k, s in shapes.items()}
    xs = (batch, seq, cfg.d_model)
    x = jax.ShapeDtypeStruct(xs, jnp.float32,
                             sharding=RR.param_sharding(x_axes, xs))
    grad = jax.grad(loss, 0 if wrt == "params" else (0, 1))
    compiled = jax.jit(grad).lower(p, x).compile()
    total, two_d = dots(compiled.as_text())
    mem = compiled.memory_analysis()
    peak = (mem.argument_size_in_bytes + mem.output_size_in_bytes
            + mem.temp_size_in_bytes - mem.alias_size_in_bytes)
    return {"dots": total, "dots_2d": two_d, "peak_bytes": peak}


res = {"/".join(c): compile_case(*c, mesh, batch, seq) for c in cases}
for rules_name, layer, wrt, b, s, dd, mm in full:
    big = jax.make_mesh((dd, mm), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2,
                        devices=jax.devices()[:dd * mm])
    res[f"full/{layer}/{rules_name}"] = compile_case(layer, rules_name, wrt,
                                                     big, b, s)
print(json.dumps(res))
"""


# Cases at full width, train_4k's batch on (data 16, model 16), ``[rules,
# layer, wrt, batch, seq, data, model]``, which the reference compiles on
# 256 XLA CPU devices: mamba2-1.3b's head (a vocab that ``model`` does not
# divide) under each rule set, its products read off the port's dry run
# (``N.head_full_port``); the attention of ``N.FULL_ATTENTION`` under the
# base rules, for the parameters.
FULL = ([[rules, "mamba2-1.3b", "params_x", 256, 4096, 16, 16]
         for rules in N.RULES]
        + [["base", layer, "params", 256, 4096, 16, 16]
           for layer in N.FULL_ATTENTION])


def _reference_process(timeout: float = DEADLINE_S, cases=None, full=FULL):
    """The reference's dots and peaks of ``cases`` (default: the cases
    of ``scripts/torch_narrow_sharding.py``'s ``PEAK_LAYERS``, the MoE's
    too) and of ``full``, compiled in a
    subprocess, started: returns a function that waits for it and returns
    its JSON line, ``{"layer/rules/wrt": {...}, "full/layer/rules":
    {...}}`` (raising on failure), the process as its ``proc``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_DOTS,
         json.dumps([N.NARROW, N.peak_cases() if cases is None else cases,
                     N.MESH, N.BATCH, N.SEQ, full])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait() -> str:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        if proc.returncode != 0:
            raise RuntimeError(err[-4000:])
        return out.strip().splitlines()[-1]
    wait.proc = proc
    return wait


def _spawn(fn, nprocs: int, root: str):
    return torch.multiprocessing.spawn(
        fn, args=(nprocs, os.path.join(root, f"init_{fn.__name__}"), root),
        nprocs=nprocs, join=False)


def _join(ctx, label: str, started: float) -> None:
    while not ctx.join(timeout=5):
        if time.monotonic() > started + DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{label} did not finish in {DEADLINE_S} s")


@pytest.fixture(scope="module", autouse=True)
def _jobs(tmp_path_factory):
    """The module's children, started together: the reference's compile
    (a), the four ranks of (c) and the one of (d)."""
    root = str(tmp_path_factory.mktemp("sharded_recurrent"))
    jobs = {"started": time.monotonic(), "root": root,
            "mesh": _spawn(_mesh_rank, 4, root),
            "one_rank": _spawn(_one_rank, 1, root)}
    jobs["reference"] = _reference_process()
    yield jobs
    for key in ("mesh", "one_rank"):
        for p in jobs[key].processes:
            if p.is_alive():
                p.kill()
    if jobs["reference"].proc.poll() is None:
        jobs["reference"].proc.kill()
        jobs["reference"].proc.communicate()


# ---------------------------------------------------------------- (a)


@pytest.fixture(scope="module")
def _reference_dots(_jobs):
    if "dots" not in _jobs:
        _jobs["dots"] = json.loads(_jobs["reference"]())
    return _jobs["dots"]


@pytest.mark.parametrize("wrt", N.WRT)
@pytest.mark.parametrize("rules", N.RULES)
@pytest.mark.parametrize("layer", N.LAYERS + ("attention_gemma2",))
def test_port_dots_equal_reference_dots(_reference_dots, layer, rules, wrt):
    """(a) Each rank multiplies what the reference's partitioned HLO
    multiplies on a device (each dot of its scan once a trip), within 1%;
    the router's input gradient on the port's d_model split (the
    reference's whole, less (M - 1) / M). gemma2's attention, its heads
    whole on ``model``: the reference computes the q/k/v input gradient
    whole on every ``model`` rank, and under ``zero_r``, its block input
    whole on d_model, the q/k/v projection and its weight gradient too;
    the port computes each on its split, (M - 1) / M less."""
    torch.set_num_threads(1)
    want = _reference_dots[f"{layer}/{rules}/{wrt}"]
    got = _port(layer, rules, wrt)
    if layer == "ssm":
        got, want = got["mm"], want["dots_2d"]
    else:
        got, want = got["flops"], want["dots"]
    cfg = N.narrow_cfg(layer)
    tokens = N.BATCH * N.SEQ // N.MESH[0]
    if layer == "router" and wrt == "params_x" and rules != "zero_r":
        whole = 2 * tokens * cfg.n_experts * cfg.d_model
        assert got == want - whole + whole // N.MESH[1], (got, want)
        return
    if layer == "head514" and rules == "seq_sp":
        whole = 2 * tokens * cfg.vocab * cfg.d_model
        assert got == want - whole + whole // N.MESH[1], (got, want)
        return
    if layer == "attention_gemma2":
        whole = (2 * tokens * (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim
                 * cfg.d_model)
        n = (wrt == "params_x") + 2 * (rules == "zero_r")
        assert got == want - n * (whole - whole // N.MESH[1]), (got, want)
        return
    assert abs(got / want - 1) <= 0.01, (got, want)


# The port's peak against the reference's ``memory_analysis()`` (arguments,
# outputs and temporaries less aliases): at most PEAK_RATIO x, the SSD's at
# most SSM_PEAK_RATIO x (its reading once the SSD's placements were stated).
PEAK_RATIO = 1.15
SSM_PEAK_RATIO = 0.90


@pytest.mark.parametrize("wrt", N.WRT)
@pytest.mark.parametrize("rules", N.RULES)
@pytest.mark.parametrize("layer", N.PEAK_LAYERS)
def test_port_peak_within_reference(_reference_dots, layer, rules, wrt):
    """(a) Each rank's peak bytes (its allocations and its inputs'
    shards) within PEAK_RATIO of the reference's per-device peak: the
    RG-LRU scans its own rows and channels, the loss holds no f32 copy of
    the logits (before: up to 1.83x, 2.06x for the head of vocab 514);
    dbrx's MoE under both dispatches gathers each expert weight inside its
    product and holds no copy of the dispatched rows that the reference's
    gradient does not (before: up to 1.58x under the einsum dispatch,
    1.30x under the sort dispatch); gemma2's attention in 8 chunks holds
    one copy of K and V and none of the probabilities (before: up to
    1.22x), and qwen3's attention and MLP are held too."""
    torch.set_num_threads(1)
    want = _reference_dots[f"{layer}/{rules}/{wrt}"]["peak_bytes"]
    got = _port(layer, rules, wrt)["peak_bytes"]
    bound = SSM_PEAK_RATIO if layer == "ssm" else PEAK_RATIO
    assert got <= bound * want, (got, want, got / want)


@pytest.mark.parametrize("key", ["/".join(c) for c in N.peak_cases()]
                         + [f"full/{f[1]}/{f[0]}" for f in FULL])
def test_chip_smoke_reference_peaks_are_the_references(_reference_dots, key):
    """(a) ``chip_smoke.py`` holds the port's peaks on the card, where
    there is no JAX, to ``NARROW_REFERENCE_PEAKS``: each is the peak that
    the reference's compile reads for the case."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.NARROW_REFERENCE_PEAKS[key] == \
        _reference_dots[key]["peak_bytes"]


@pytest.mark.parametrize("rules", N.RULES)
def test_full_width_head_peak_within_reference(_reference_dots, rules):
    """(a) mamba2-1.3b's head at full width (train_4k's batch on (16, 16),
    f32, the vocab whole on ``model``): the port's peak within PEAK_RATIO
    of the reference's compiled on 256 devices, about two f32 copies of
    the rank's logits (before: five)."""
    torch.set_num_threads(1)
    want = _reference_dots[f"full/mamba2-1.3b/{rules}"]["peak_bytes"]
    got = _port(N.FULL_HEAD, rules, "params_x",
                **N.FULL_SHAPE)["peak_bytes"]
    assert got <= PEAK_RATIO * want, (got, want, got / want)


@pytest.mark.parametrize("rules", ["base", "seq_sp"])
def test_full_width_head_equals_reference(_reference_dots, rules):
    """(a) mamba2-1.3b's head at full width (train_4k's batch on (16,
    16)): the port's products of the tied table in its one-layer dry run
    equal the reference's dots compiled on 256 devices, within 1%."""
    torch.set_num_threads(1)
    want = _reference_dots[f"full/mamba2-1.3b/{rules}"]["dots"]
    got = N.head_full_port(rules)
    assert abs(got / want - 1) <= 0.01, (got, want)


@functools.lru_cache(maxsize=None)
def _full_attention(layer: str) -> dict:
    """The port's record of ``layer`` (of ``N.FULL_ATTENTION``) at full
    width, with every group of storages live at its peak."""
    torch.set_num_threads(1)
    return N.port_live(layer, "base", "params", top=None, **N.FULL_SHAPE)


@pytest.mark.parametrize("layer", N.FULL_ATTENTION)
def test_full_width_attention_peak_within_reference(_reference_dots, layer):
    """(a) The attention of gemma2-2b, minitron-4b and musicgen-medium at
    full width (train_4k's batch on (16, 16), f32, the base rules, the
    parameters' gradient; the heads of all three whole on ``model``): the
    port's peak within PEAK_RATIO of the reference's compiled on 256
    devices (34.49, 63.69 and 40.66 GB before K and V were laid out once
    for every chunk)."""
    want = _reference_dots[f"full/{layer}/base"]["peak_bytes"]
    got = _full_attention(layer)["peak_bytes"]
    assert got <= PEAK_RATIO * want, (got, want, got / want)


@pytest.mark.parametrize("layer", N.FULL_ATTENTION)
def test_full_width_attention_dots_equal_reference(_reference_dots, layer):
    """(a) The same attention at full width: the port's matmul FLOPs equal
    the reference's dots compiled on 256 devices, each dot of its scan
    counted once a trip, within 1%."""
    want = _reference_dots[f"full/{layer}/base"]["dots"]
    got = _full_attention(layer)["flops"]
    assert abs(got / want - 1) <= 0.01, (got, want)


@pytest.mark.parametrize("layer", N.FULL_ATTENTION)
def test_full_width_attention_holds_one_copy_of_k_and_v(layer):
    """(a) The same attention at full width: the copies of K's size live
    at the peak are one f32 K and one V (before: one of each a query
    chunk, 8 of each), and no copy of a chunk's probabilities is (before:
    one a chunk, permuted for the product with V)."""
    cfg = N.narrow_cfg(layer)
    rows = N.FULL_SHAPE["batch"] // N.FULL_SHAPE["mesh_shape"][0]
    seq = N.FULL_SHAPE["seq"]
    kv = rows * seq * cfg.n_kv * cfg.head_dim
    probs = rows * cfg.n_heads * min(cfg.attn_chunk, seq) * seq
    clones = [(shape, size) for (_, op, shape, _), size
              in _full_attention(layer)["live"] if op == "clone.default"]
    assert sum(size for shape, size in clones
               if math.prod(shape) == kv) <= 2 * 4 * kv, clones
    assert not [c for c in clones if math.prod(c[0]) == probs], clones


@pytest.mark.parametrize("layer", ["ssm", "head514"])
def test_reference_zero_r_dots_equal_base(_reference_dots, layer):
    """(a) The reference multiplies as much under ``zero_r`` as under the
    base rules in mamba2's SSD and its head (the ratio (b) holds the
    port's full-width cells to)."""
    for wrt in N.WRT:
        assert _reference_dots[f"{layer}/zero_r/{wrt}"]["dots"] == \
            _reference_dots[f"{layer}/base/{wrt}"]["dots"]


# ---------------------------------------------------------------- (b)

F = _script("torch_dryrun_flops")
BATCH_B, SEQ_B, MESH_B = 256, 4096, (16, 16)


def _ssd_einsum_flops(cfg, rows: int, heads: int, seq: int) -> int:
    """The SSD's einsums on ``rows`` batch rows and ``heads`` heads (one
    rank's, as the reference places them: xs on heads, B and C whole),
    forward twice (the remat's recompute) and backward once, counted on
    those local shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    def meta(*shape):
        return torch.empty(*shape, device="meta", requires_grad=True)
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    ins = [meta(rows, seq, heads, hd), meta(rows, seq, n), meta(rows, seq, n),
           meta(rows, seq, heads), meta(rows, seq, heads)]
    intra = torch.bfloat16 if cfg.ssm_bf16_intra else torch.float32
    with FlopCounterMode(display=False) as fwd:
        y, _ = L._ssd_chunks(*ins, None, min(cfg.ssm_chunk, seq), intra)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(y.sum(), ins)
    return 2 * fwd.get_total_flops() + bwd.get_total_flops()


def reference_layer_flops(cfg, batch: int, seq: int, data: int,
                          model: int) -> int:
    """Per-device matmul FLOPs of one layer of the train step under the
    reference's placements (2 layers minus 1) on a (``data``, ``model``)
    mesh, tokens split over ``data``:

    * mamba2 (each layer its own remat superblock): ``in_proj`` on
      ``model``'s share of its columns four times (forward, recompute,
      two gradients), ``out_proj`` on its share of d_inner three times
      (the superblock's last product is not recomputed), the SSD's
      einsums on the rank's heads (``_ssd_einsum_flops``);
    * recurrentgemma (its recurrent layers in one superblock): the
      RG-LRU's five products and the MLP's three, each on ``model``'s
      share of rnn_width or d_ff, four times (the second layer brings the
      recompute of the first one's ``w2``)."""
    t, d = batch * seq // data, cfg.d_model
    if cfg.block_pattern == ("ssm",):
        din, n = cfg.ssm_expand * d, cfg.ssm_state
        nh = din // cfg.ssm_head_dim
        width = 2 * din + 2 * n + nh
        return (4 * 2 * t * d * (width // model)
                + 3 * 2 * t * (din // model) * d
                + _ssd_einsum_flops(cfg, batch // data, nh // model, seq))
    w, f = cfg.rnn_width, cfg.d_ff
    return 4 * 2 * t * (4 * d * (w // model) + w * (w // model)
                        + 3 * d * (f // model))


def _operand_shapes(key: str) -> list:
    """The operand shapes of a tally key ``"op ((a, b), (c, d))"``."""
    return [tuple(s) for s in json.loads(
        key.split(" ", 1)[1].replace("(", "[").replace(")", "]")
        .replace(",]", "]"))]


def _whole(arch: str, shape: tuple) -> bool:
    """Whether an operand spans a dim that the reference splits."""
    cfg = get_config(arch)
    if arch == "mamba2-1.3b":
        din = cfg.ssm_expand * cfg.d_model
        width = 2 * din + 2 * cfg.ssm_state + din // cfg.ssm_head_dim
        return bool({width, din} & set(shape))
    return shape == (cfg.d_model, cfg.rnn_width)


@functools.lru_cache(maxsize=None)
def _layer(arch: str, variant=None):
    """One layer's tally (2 layers' minus 1's), the 1-layer and the
    2-layer cells, and the storages live at each one's peak (``{layers:
    [[label, operator, shape, dtype], bytes]}``), each cell traced once."""
    runs, live = [], {}
    for n in (1, 2):
        with F.recording_live(top=40) as snap:
            runs.append(F.tally(arch, "train_4k", False, n, variant))
        live[n] = snap["live"]
    for res, _ in runs:
        assert res.get("ok"), res.get("error")
    (one, t1), (two, t2) = runs
    flops = (two["cost_analysis"]["flops"] - one["cost_analysis"]["flops"])
    return flops, t2 - t1, one, two, live


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_train_4k_layer_on_reference_shards(arch):
    """(b) One layer of train_4k on (16, 16): no product spans a dim the
    reference splits, and the layer's FLOPs are at most 1.01 x the count
    of the reference's placements."""
    torch.set_num_threads(1)
    flops, tally, *_ = _layer(arch)
    wide = [k for k in tally if any(_whole(arch, s)
                                     for s in _operand_shapes(k))]
    assert not wide, wide
    want = reference_layer_flops(get_config(arch), BATCH_B, SEQ_B, *MESH_B)
    assert flops <= 1.01 * want, (flops, want)


# Per-device peak bytes of train_4k's base cells on (16, 16) at 1 and 2
# layers, at most (the dry run on torch 2.13): recurrentgemma-9b's are the
# readings with the RG-LRU's scan on each rank's shards alone (the loss's
# f32 copy still there), mamba2-1.3b's 1.15x the reference's head
# (``full/mamba2-1.3b/base``). Before: 89,548,582,922 and 119.17 GB;
# 66,096,114,698 at 1 layer.
LAYER_PEAK = {"recurrentgemma-9b": {1: 13_000_899_594, 2: 13_035_616_266},
              "mamba2-1.3b": {1: 30_490_966_315, 2: 30_490_966_315}}


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_train_4k_layer_peak(arch):
    """(b) train_4k on (16, 16) at 1 and 2 layers: each cell's peak within
    LAYER_PEAK; no buffer of the global batch (``new_empty``: the scan's
    interleaves built whole) and at most two tensors of the rank's
    logits' shape (its vocab slice where ``model`` divides the vocab) in
    f32 live at either peak."""
    torch.set_num_threads(1)
    cfg = get_config(arch)
    *_, one, two, live = _layer(arch)
    vocab = cfg.vocab // MESH_B[1] if cfg.vocab % MESH_B[1] == 0 \
        else cfg.vocab
    logits = (BATCH_B // MESH_B[0], SEQ_B, vocab)
    for n, cell in ((1, one), (2, two)):
        peak = cell["memory_analysis"]["peak_bytes"]
        assert peak <= LAYER_PEAK[arch][n], (n, peak)
        groups = [(key, size) for key, size in live[n]]
        global_batch = [g for g in groups if g[0][1] == "new_empty"
                        and g[0][2][0] == BATCH_B]
        assert not global_batch, (n, global_batch)
        f32_logits = sum(size for (_, _, shape, dtype), size in groups
                         if dtype == "float32" and shape is not None and
                         math.prod(shape) == math.prod(logits))
        assert f32_logits <= 2 * 4 * math.prod(logits), (n, f32_logits)


def test_mamba2_zero_r_cell_reads_its_base_cell():
    """(b) mamba2's train_4k cut to one layer reads as many FLOPs under
    ``zero_r`` as under the base rules, within 1%, as the reference's
    narrow dots do (a)."""
    from repro_torch.launch import dryrun as D
    torch.set_num_threads(1)
    base, zero_r = (D.run_cell("mamba2-1.3b", "train_4k", False, n_layers=1,
                               variant=v) for v in (None, "zero_r"))
    assert base.get("ok") and zero_r.get("ok"), (base.get("error"),
                                                  zero_r.get("error"))
    ratio = zero_r["cost_analysis"]["flops"] / base["cost_analysis"]["flops"]
    assert abs(ratio - 1) <= 0.01, ratio


# ---------------------------------------------------------------- (c)

B, S = 4, 64
RESID = ("batch", "resid_seq", "resid_embed")
CASES = ("ssm", "ssm/zero_r", "rec", "router", "router/zero_r", "head512",
         "head511", "head512/seq_sp", "head511/seq_sp")


def _cfg(case: str):
    layer, _, _ = case.partition("/")
    arch = {"ssm": "mamba2-1.3b", "rec": "recurrentgemma-9b",
            "router": "dbrx-132b"}.get(layer, "mamba2-1.3b")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if layer.startswith("head"):
        cfg = dataclasses.replace(cfg, vocab=int(layer[4:]))
    return cfg


def _rules(case: str, model: int):
    from repro_torch.launch.dryrun import VARIANTS, arch_rules
    rules = arch_rules(_cfg(case), model)
    variant = case.partition("/")[2]
    if variant:
        rules.update(VARIANTS[variant]["rules"])
    return rules


def _case(case: str):
    """(module with seeded f32 weights, {name: logical axes}, the input and
    its axes, the apply function of (module, x, ct) -> (out, loss), the
    cotangent or labels and their axes), all on the CPU."""
    layer = case.partition("/")[0]
    cfg = _cfg(case)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    x_axes = ("batch", None, "blk_in_embed")
    if layer == "ssm":
        module = L.SSM(cfg, device="cpu", dtype=torch.float32)
        module.reset_parameters(cfg, gen)
        with torch.no_grad():
            for t in (module.dt_bias, module.D):
                t.normal_(0, 0.3, generator=gen)
        axes = L.ssm_axes()
        fn, ct_axes = (lambda p, x: L.ssm_apply(p, x, cfg)[0]), RESID
    elif layer == "rec":
        module = L.RGLRU(cfg, device="cpu", dtype=torch.float32)
        module.reset_parameters(cfg, gen)
        axes = L.rglru_axes()
        fn, ct_axes = (lambda p, x: L.rglru_apply(p, x, cfg)[0]), RESID
    elif layer == "router":
        module = torch.nn.Module()
        module.router = torch.nn.Parameter(
            torch.randn(cfg.d_model, cfg.n_experts, generator=gen)
            / cfg.d_model ** 0.5)
        axes = {"router": L.moe_axes(cfg)["router"]}
        fn, ct_axes = (lambda p, x: L._moe_router(p, x, cfg)[0]), \
            ("batch", None, None)
    else:
        module = torch.nn.Module()
        module.embed = torch.nn.Parameter(
            torch.randn(cfg.vocab, cfg.d_model, generator=gen) * 0.1)
        module.ln_f = torch.nn.Parameter(
            torch.randn(cfg.d_model, generator=gen) * 0.3)
        axes = {"embed": ("vocab", "fsdp"), "ln_f": (None,)}
        x_axes = RESID
        labels = torch.randint(0, cfg.vocab, (B, S), generator=gen)

        def apply(p, x, labels):
            logits = M.head_apply(x, p.ln_f, p.embed, cfg)
            return logits, M._nll(logits.float(), labels).sum() / (B * S)
        return module, axes, x, x_axes, apply, labels, ("batch", None)
    out_shape = fn(module, x).shape
    ct = torch.randn(*out_shape, generator=gen)

    def apply(p, x, ct):
        out = fn(p, x)
        return out, (out * ct).sum()
    return module, axes, x, x_axes, apply, ct, ct_axes


def _prefill_case():
    """The RG-LRU of the smoke config with seeded f32 weights, an input of
    B x S tokens and a carried cache (state, conv), on the CPU."""
    cfg = _cfg("rec")
    gen = torch.Generator().manual_seed(5)
    module = L.RGLRU(cfg, device="cpu", dtype=torch.float32)
    module.reset_parameters(cfg, gen)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    cache = {"state": torch.randn(B, cfg.rnn_width, generator=gen),
             "conv": torch.randn(B, cfg.rnn_conv - 1, cfg.rnn_width,
                                 generator=gen)}
    return module, x, cache


def _grads(module, apply, x, ct):
    out, loss = apply(module, x, ct)
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, list(module.parameters()) + [x])
    return out, loss, dict(zip(names + ["x"], grads))


def _mesh_rank(rank: int, world: int, init_file: str, root: str):
    """One of four ranks on the (2, 2) debug mesh: each case's parameters,
    input and cotangent sharded by their logical axes; rank 0 saves the
    gathered outputs and gradients."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import placements, replicate_plain, set_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    got = {}
    try:
        mesh = make_debug_mesh()
        for case in CASES:
            set_mesh(mesh, _rules(case, 2))
            module, axes, x, x_axes, apply, ct, ct_axes = _case(case)
            for n, p in list(module.named_parameters()):
                setattr(module, n, torch.nn.Parameter(distribute_tensor(
                    p.detach(), mesh, placements(axes[n], p.shape))))
            xd, ctd = (distribute_tensor(t, mesh, placements(ax, t.shape))
                       for t, ax in ((x, x_axes), (ct, ct_axes)))
            with replicate_plain():
                out, loss, grads = _grads(module, apply, xd.requires_grad_(),
                                          ctd)
            got[case] = {
                "out": out.full_tensor().detach(),
                "out_placements": [repr(p) for p in out.placements],
                "loss": loss.full_tensor().detach(),
                "grads": {n: g.full_tensor() for n, g in grads.items()}}
        set_mesh(mesh, _rules("rec", 2))
        module, x, cache = _prefill_case()
        for n, p in list(module.named_parameters()):
            setattr(module, n, torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, placements(L.rglru_axes()[n], p.shape))))
        x = distribute_tensor(x, mesh, placements(
            ("batch", None, "blk_in_embed"), x.shape))
        cache = {k: distribute_tensor(t, mesh, placements(
            L.rglru_cache_axes()[k], t.shape)) for k, t in cache.items()}
        with torch.no_grad(), replicate_plain():
            out, (state, conv) = L.rglru_apply(
                module, x, _cfg("rec"), cache["state"], cache["conv"])
        got["rec/prefill"] = {
            "out": out.full_tensor(), "state": state.full_tensor(),
            "conv": conv.full_tensor(),
            "state_placements": [repr(p) for p in state.placements]}
        if rank == 0:
            torch.save(got, os.path.join(root, "mesh.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _mesh(_jobs):
    _join(_jobs["mesh"], "the mesh ranks", _jobs["started"])
    return torch.load(os.path.join(_jobs["root"], "mesh.pt"))


def _close(got, want, name, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=name)


# The output's placements on the (2, 2) mesh: the residual stream's (d_model
# split over ``model``), the router's choices whole on ``model``, the logits
# split on the vocab where ``model`` divides it.
OUT_PLACEMENTS = {"ssm": ["Shard(dim=0)", "Shard(dim=2)"],
                  "rec": ["Shard(dim=0)", "Shard(dim=2)"],
                  "router": ["Shard(dim=0)", "Replicate()"],
                  "head512": ["Shard(dim=0)", "Shard(dim=2)"],
                  "head511": ["Shard(dim=0)", "Replicate()"]}


@pytest.mark.parametrize("case", CASES)
def test_mesh_matches_unsharded_port(_mesh, case):
    """(c) Against the unsharded port on the same weights."""
    torch.set_num_threads(1)
    module, _, x, _, apply, ct, _ = _case(case)
    out, loss, grads = _grads(module, apply, x.requires_grad_(), ct)
    got = _mesh[case]
    assert got["out_placements"] == OUT_PLACEMENTS[case.partition("/")[0]]
    _close(got["out"], out.detach(), "out")
    _close(got["loss"], loss.detach(), "loss")
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        _close(got["grads"][name], g, name)


def test_mesh_prefill_from_state_matches_unsharded_port(_mesh):
    """(c) The RG-LRU chained from a carried state (a prefill from a
    cache): each rank scans its rows and channels from its shard of the
    state (``rglru_cache_axes()["state"]``), the new state on the same
    placements, against the unsharded port."""
    module, x, cache = _prefill_case()
    with torch.no_grad():
        out, (state, conv) = L.rglru_apply(module, x, _cfg("rec"),
                                           cache["state"], cache["conv"])
    got = _mesh["rec/prefill"]
    assert got["state_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    for name, want in (("out", out), ("state", state), ("conv", conv)):
        _close(got[name], want, name)


def _reference(case: str):
    """The reference's output, loss and gradients on the same weights
    (its layouts are the port's), ``jax.value_and_grad``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import layers as RL
    layer = case.partition("/")[0]
    cfg = _cfg(case)
    arch = {"ssm": "mamba2-1.3b", "rec": "recurrentgemma-9b",
            "router": "dbrx-132b"}.get(layer, "mamba2-1.3b")
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="float32",
                               vocab=cfg.vocab)
    module, _, x, _, _, ct, _ = _case(case)
    p = {n: jnp.asarray(t.detach().numpy())
         for n, t in module.named_parameters()}
    ct = jnp.asarray(ct.numpy())
    if layer.startswith("head"):
        def loss(p, x):
            h = RL.rms_norm(x, p["ln_f"], upcast=rcfg.norm_upcast)
            logits = jnp.einsum("bsd,vd->bsv", h, p["embed"])
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, ct[..., None], axis=-1)
            return jnp.mean(lse - gold[..., 0]), logits
    else:
        fn = {"ssm": lambda p, x: RL.ssm_apply(p, x, rcfg)[0],
              "rec": lambda p, x: RL.rglru_apply(p, x, rcfg)[0],
              "router": lambda p, x: RL._moe_router(p, x, rcfg)[0]}[layer]

        def loss(p, x):
            out = fn(p, x)
            return (out * ct).sum(), out

    (value, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x.numpy()))
    return (np.asarray(out), np.asarray(value),
            {**{n: np.asarray(g) for n, g in gp.items()}, "x": np.asarray(gx)})


# Against the reference the SSD is held at tests/test_torch_models.py's
# rtol for it: its chunked scan adds in another order (the unsharded port
# differs from the reference as much, up to 6e-5 in ``A_log``'s gradient).
REFERENCE_RTOL = {"ssm": 1e-4}


@pytest.mark.parametrize("case", CASES)
def test_mesh_matches_reference(_mesh, case):
    """(c) Against the reference's layer on the same weights."""
    out, loss, grads = _reference(case)
    got = _mesh[case]
    rtol = REFERENCE_RTOL.get(case.partition("/")[0], RTOL)
    _close(got["out"], out, "out", rtol)
    _close(got["loss"], loss, "loss", rtol)
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        _close(got["grads"][name], g, name, rtol)


# ---------------------------------------------------------------- (d)

ONE_RANK = ("mamba2-1.3b", "recurrentgemma-9b")
HYPER = dict(lr=1e-3, warmup_steps=1, total_steps=40)
STEPS, BATCH, SEQ = 3, 4, 64


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
        for arch in ONE_RANK:
            cfg = get_config(arch, smoke=True)
            got[arch] = (_steps(cfg, mesh), _steps(cfg, None))
        torch.save(got, os.path.join(root, "one_rank.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _one_rank_runs(_jobs):
    _join(_jobs["one_rank"], "the rank", _jobs["started"])
    return torch.load(os.path.join(_jobs["root"], "one_rank.pt"))


@pytest.mark.parametrize("arch", ONE_RANK)
def test_one_rank_mesh_steps_equal_plain_steps(_one_rank_runs, arch):
    """(d) The (1, 1)-mesh steps are the plain steps bit for bit."""
    mesh, plain = _one_rank_runs[arch]
    assert mesh.keys() == plain.keys()
    unequal = [n for n in plain if not torch.equal(mesh[n], plain[n])]
    assert not unequal, unequal


def main(argv=None) -> int:
    """The narrow cases and the full-width head and attention side by
    side, one JSON line each: the port's FLOPs and peak bytes
    (``scripts/torch_narrow_sharding.py``) beside the reference's dots and
    ``memory_analysis()`` peak."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    wait = _reference_process()
    ported = {"/".join(c): N.port(*c) for c in N.peak_cases()}
    for rules, layer, wrt, *_ in FULL:
        if layer == "mamba2-1.3b":
            got = dict(N.port(N.FULL_HEAD, rules, wrt, **N.FULL_SHAPE),
                       flops=N.head_full_port(rules), mm=None)
        else:
            got = N.port(layer, rules, wrt, **N.FULL_SHAPE)
        ported[f"full/{layer}/{rules}"] = got
    ref = json.loads(wait())
    lines = []
    for key, got in ported.items():
        want = ref[key]
        lines.append(json.dumps({
            "case": key, "torch": torch.__version__,
            "port_flops": got["flops"], "port_mm": got["mm"],
            "reference_dots": want["dots"],
            "reference_dots_2d": want["dots_2d"],
            "port_peak_bytes": got["peak_bytes"],
            "reference_peak_bytes": want["peak_bytes"],
            "peak_ratio": got["peak_bytes"] / want["peak_bytes"]}))
    print("\n".join(lines))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
