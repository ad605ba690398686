"""The port's LM stack (``repro_torch.models``) against the reference on the
CPU: every architecture's smoke config in f32 with the reference's weights
carried across (``params_from_reference``), the same inputs made with
NumPy, and the JAX functions jitted. Layer-level cases cover both MoE
dispatches and the aux loss, the SSD and RG-LRU recurrences chunked and
step by step, a local ring cache decoded past its window and the bf16
RMSNorm; the full configs' parameter counts are checked on the ``meta``
device.

Tolerance: rtol 1e-4, atol 1e-5 everywhere in f32 (the largest error
measured over the ten architectures' logits, which reach |8|, is 3.5e-6);
the bf16 RMSNorm is held to one bf16 rounding (see its test).

bf16, the configured dtype and the one served: the reference runs jitted
with XLA's excess precision off (``_strict``), so that every op's result
is rounded to its dtype, as its jaxpr says and as eager PyTorch computes
(XLA on the CPU otherwise keeps f32 between fused bf16 ops, which moves
the logits about as far as computing in f32 does). Each layer is held
bit for bit on all but a few elements (``_close_bf16``); whole models,
where bf16 rounding differences grow from layer to layer, are held to a
share of the distance between the reference's f32 and bf16 logits
(``BF16_SHARE``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.models import common as RC
from repro.models import layers as RL
from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.common import param_count, rms_norm
from repro_torch.models.convert import flatten_tree, params_from_reference
from repro_torch.models.model import Model

B, S = 2, 64
RTOL, ATOL = 1e-4, 1e-5
KEY = jax.random.PRNGKey(0)
# XLA option that rounds every op's result to its dtype (see the docstring).
STRICT = {"xla_allow_excess_precision": False}


def _cfgs(arch, smoke=True, **kw):
    """The reference's and the port's config of ``arch`` in f32 with
    ``capacity_factor=8.0`` (as ``tests/test_models.py``), plus ``kw``."""
    kw = dict(dict(dtype="float32", capacity_factor=8.0), **kw)
    return (dataclasses.replace(ref_config(arch, smoke=smoke), **kw),
            dataclasses.replace(get_config(arch, smoke=smoke), **kw))


def _inputs(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return (0.1 * rng.standard_normal((b, s, cfg.d_model))).astype(
            np.float32)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def _strict(fn, *args):
    """``fn(*args)`` jitted with every op rounded to its dtype."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b):
    """Relative distance ||a - b|| / ||b|| in f32."""
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def reference_runs():
    """Per architecture, computed once: the reference's weights, inputs,
    ``forward`` logits, cached ``prefill`` logits, and ``decode_step``
    logits after prefilling S - 1 tokens."""
    runs = {}

    def get(arch):
        if arch not in runs:
            rcfg, _ = _cfgs(arch)
            params = jax.jit(lambda k: R.init_params(rcfg, k))(KEY)
            inp = _inputs(rcfg)
            last = inp[:, S - 1:S] if rcfg.embed_inputs else inp[:, S - 1]
            pre = jax.jit(lambda p, x: R.prefill(
                p, rcfg, x, R.init_cache(rcfg, B, S)))
            _, cache = pre(params, inp[:, :S - 1])
            runs[arch] = {
                "tree": _tree(params), "inp": inp, "last": last,
                "forward": jax.jit(lambda p, x: R.forward(p, rcfg, x))(
                    params, inp),
                "prefill": pre(params, inp)[0],
                "decode": jax.jit(lambda p, x, c: R.decode_step(
                    p, rcfg, x, c))(params, last, cache)[0],
            }
        return runs[arch]
    return get


def _port(arch, run):
    _, cfg = _cfgs(arch)
    return cfg, params_from_reference(run["tree"], cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, reference_runs):
    run = reference_runs(arch)
    cfg, model = _port(arch, run)
    logits = M.forward(model, torch.from_numpy(run["inp"]))
    assert logits.shape == (B, S, cfg.vocab)
    _close(logits, run["forward"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, reference_runs):
    run = reference_runs(arch)
    cfg, model = _port(arch, run)
    cache = M.init_cache(cfg, B, S, device="cpu")
    logits, cache = M.prefill(model, torch.from_numpy(run["inp"]), cache)
    assert cache.index == S
    _close(logits, run["prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, reference_runs):
    run = reference_runs(arch)
    cfg, model = _port(arch, run)
    cache = M.init_cache(cfg, B, S, device="cpu")
    _, cache = M.prefill(model, torch.from_numpy(run["inp"][:, :S - 1]),
                         cache)
    logits, cache = M.decode_step(model, torch.from_numpy(run["last"]), cache)
    assert logits.shape == (B, 1, cfg.vocab) and cache.index == S
    _close(logits, run["decode"])


def test_loss_matches_reference(reference_runs):
    run = reference_runs("qwen3_0_6b")
    rcfg, _ = _cfgs("qwen3_0_6b")
    _, model = _port("qwen3_0_6b", run)
    labels = np.roll(run["inp"], -1, axis=1)
    mask = (np.arange(S) < S - 1).astype(np.float32)[None].repeat(B, 0)
    for m in (None, mask):
        ref_batch = {"tokens": run["inp"], "labels": labels}
        batch = {"tokens": torch.from_numpy(run["inp"]),
                 "labels": torch.from_numpy(labels)}
        if m is not None:
            ref_batch["mask"], batch["mask"] = m, torch.from_numpy(m)
        want = R.loss_fn(jax.tree_util.tree_map(jnp.asarray, run["tree"]),
                         rcfg, ref_batch)
        _close(M.loss_fn(model, batch), want)


# ------------------------------------------------------------- layer level


def _load(module, tree):
    module.load_state_dict({name: torch.tensor(np.asarray(leaf))
                            for name, leaf in flatten_tree(_tree(tree))})
    return module


def _x(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_apply_matches_reference(impl, capacity_factor):
    """At capacity factor 1.0 some experts overflow (C = 32 of 64 tokens):
    the dropped tokens' contributions must vanish in both dispatches."""
    rcfg, cfg = _cfgs("dbrx_132b", moe_impl=impl,
                      capacity_factor=capacity_factor)
    p = RL.init_moe(KEY, rcfg)
    moe = _load(L.MoE(cfg, device="cpu"), p)
    x = _x(cfg, B, S, 1)
    with torch.no_grad():
        out = L.moe_apply(moe, torch.from_numpy(x), cfg)
    _close(out, jax.jit(lambda x: RL.moe_apply(p, x, rcfg))(x))


def test_moe_aux_loss_matches_reference():
    rcfg, cfg = _cfgs("dbrx_132b")
    p = RL.init_moe(KEY, rcfg)
    moe = _load(L.MoE(cfg, device="cpu"), p)
    x = _x(cfg, B, S, 2)
    with torch.no_grad():
        aux = L.moe_aux_loss(moe, torch.from_numpy(x), cfg)
    _close(aux, jax.jit(lambda x: RL.moe_aux_loss(p, x, rcfg))(x))
    assert float(aux) >= 1.0 - 1e-6


def _stepwise(apply, p, x, cfg, cache):
    """Feed x one position at a time; returns (y, state, conv)."""
    st, cv = cache["state"], cache["conv"]
    ys = []
    for t in range(x.shape[1]):
        y, (st, cv) = apply(p, x[:, t:t + 1], cfg, st, cv)
        ys.append(y)
    return ys, st, cv


def test_ssm_apply_chunked_and_stepwise_match_reference():
    """Two chunks of 32 (the inter-chunk recurrence), then the single-step
    path over the same inputs; outputs, states and conv contexts."""
    rcfg, cfg = _cfgs("mamba2_1_3b")
    p = RL.init_ssm(KEY, rcfg)
    ssm = _load(L.SSM(cfg, device="cpu"), p)
    x = _x(cfg, B, S, 3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y, (state, conv) = L.ssm_apply(ssm, xt, cfg)
        ys, st, cv = _stepwise(L.ssm_apply, ssm, xt, cfg,
                               L.ssm_cache(cfg, B, torch.float32, "cpu"))
    ry, (rstate, rconv) = jax.jit(lambda xs: RL.ssm_apply(p, xs, rcfg))(x)
    step = jax.jit(lambda xs, s, c: RL.ssm_apply(p, xs, rcfg, s, c))
    rc = RL.ssm_cache(rcfg, B, jnp.float32)
    rys, rst, rcv = _stepwise(lambda _p, xs, _c, s, c: step(xs, s, c), p,
                              jnp.asarray(x), rcfg, rc)
    _close(y, ry)
    _close(state, rstate)
    _close(conv, rconv)
    _close(torch.cat(ys, dim=1), jnp.concatenate(rys, axis=1))
    _close(st, rst)
    _close(cv, rcv)


def test_rglru_apply_scan_and_stepwise_match_reference():
    """A scan of 37 positions, one of 27 chained from its state (odd
    lengths take the scan's odd branch), and 16 single steps."""
    rcfg, cfg = _cfgs("recurrentgemma_9b")
    p = RL.init_rglru(KEY, rcfg)
    rec = _load(L.RGLRU(cfg, device="cpu"), p)
    x = _x(cfg, B, S, 4)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y1, (s1, c1) = L.rglru_apply(rec, xt[:, :37], cfg)
        y2, (s2, c2) = L.rglru_apply(rec, xt[:, 37:], cfg, s1, c1)
        ys, st, _ = _stepwise(L.rglru_apply, rec, xt[:, :16], cfg,
                              L.rglru_cache(cfg, B, torch.float32, "cpu"))
    ref = jax.jit(lambda xs, s, c: RL.rglru_apply(p, xs, rcfg, s, c))
    ry1, (rs1, rc1) = jax.jit(lambda xs: RL.rglru_apply(p, xs, rcfg))(
        x[:, :37])
    ry2, (rs2, _) = ref(x[:, 37:], rs1, rc1)
    rys, rst, _ = _stepwise(lambda _p, xs, _c, s, c: ref(xs, s, c), p,
                            jnp.asarray(x[:, :16]), rcfg,
                            RL.rglru_cache(rcfg, B, jnp.float32))
    for port, ref in ((y1, ry1), (s1, rs1), (c1, rc1), (y2, ry2), (s2, rs2),
                      (st, rst)):
        _close(port, ref)
    _close(torch.cat(ys, dim=1), jnp.concatenate(rys, axis=1))


def test_local_ring_cache_decoded_past_window_matches_reference():
    """gemma2 with its window cut to 8: a 12-token prefill rolls the ring,
    then 24 decode steps wrap it three times; logits at every step."""
    rcfg, cfg = _cfgs("gemma2_2b", window=8)
    params = jax.jit(lambda k: R.init_params(rcfg, k))(KEY)
    model = params_from_reference(_tree(params), cfg, device="cpu")
    toks = _inputs(rcfg, s=12 + 24, seed=5)
    rcache = R.init_cache(rcfg, B, S)
    cache = M.init_cache(cfg, B, S, device="cpu")
    assert cache.layers[0]["k"].shape[1] == 8      # local: the ring
    assert cache.layers[1]["k"].shape[1] == S      # global: max_len
    rlog, rcache = R.prefill(params, rcfg, toks[:, :12], rcache)
    logits, cache = M.prefill(model, torch.from_numpy(toks[:, :12]), cache)
    _close(logits, rlog)
    step = jax.jit(lambda t, c: R.decode_step(params, rcfg, t, c))
    for t in range(12, 12 + 24):
        rlog, rcache = step(toks[:, t], rcache)
        logits, cache = M.decode_step(model, torch.from_numpy(toks[:, t]),
                                      cache)
        _close(logits, rlog)
    np.testing.assert_array_equal(cache.layers[0]["pos"].numpy(),
                                  np.asarray(rcache["groups"][0]
                                             ["0_attn_local"]["pos"][0]))


def test_rms_norm_bf16_without_upcast_matches_reference():
    """``upcast=False`` keeps the tensor in bf16 and only accumulates the
    variance in f32. Held to 2^-8 relative: one bf16 rounding of the
    product, whose two multiplies XLA may fuse."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, 96)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(96)).astype(np.float32)
    ref = RC.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                      upcast=False)
    out = rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(scale), upcast=False)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_matches_reference(arch):
    """The published config, built on the ``meta`` device (nothing is
    allocated), against ``jax.eval_shape`` of the reference's init."""
    rcfg, cfg = _cfgs(arch, smoke=False)
    shapes = jax.eval_shape(lambda k: R.init_params(rcfg, k), KEY)
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    model = Model(cfg, device="meta")
    assert param_count(model) == want
    assert param_count(model.state_dict()) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_is_seeded_and_keeps_the_dtype_policy(arch):
    """The port's own init (what the card serves): equal weights from equal
    seeds, matmul weights in the activation dtype (bf16 here), vectors in
    f32, norm scales zero, finite bf16 logits."""
    cfg = get_config(arch, smoke=True)
    a = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        want = torch.float32 if p.ndim == 1 or name.endswith("router") \
            else torch.bfloat16
        assert p.dtype == want, (name, p.dtype)
        if name.split(".")[-1] in ("ln1", "ln2", "ln_f", "q_norm", "k_norm"):
            assert not p.any(), name
    logits = M.forward(a, torch.from_numpy(_inputs(cfg, s=16)))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------- bf16


@pytest.fixture(scope="module")
def bf16_runs(reference_runs):
    """Per architecture, computed once: the reference's bf16 ``forward``,
    cached ``prefill`` and ``decode_step`` logits (``_strict``) on the f32
    runs' weights and inputs."""
    runs = {}

    def get(arch):
        if arch not in runs:
            run = reference_runs(arch)
            rcfg, _ = _cfgs(arch, dtype="bfloat16")
            params = jax.tree_util.tree_map(jnp.asarray, run["tree"])
            inp, last = run["inp"], run["last"]

            def pre(p, x):
                return R.prefill(p, rcfg, x, R.init_cache(rcfg, B, S))

            runs[arch] = {
                "forward": _strict(lambda p, x: R.forward(p, rcfg, x),
                                   params, inp),
                "prefill": _strict(lambda p, x: pre(p, x)[0], params, inp),
                "decode": _strict(
                    lambda p, x, t: R.decode_step(p, rcfg, t, pre(p, x)[1])[0],
                    params, inp[:, :S - 1], last),
            }
        return runs[arch]
    return get


# The port's bf16 logits may lie at most this share of the distance between
# the reference's f32 and bf16 logits from the reference's bf16 ones.
# Measured: at most 0.58 (mistral-nemo decode; gemma2 0.54, the rest below
# 0.46). Wrong dtype steps, each in the worst of the three calls of every
# architecture it touches: an f32 model cast to bf16 1.00-1.07, silu/GELU
# rounded once (torch's fused forms) 0.72-1.02, softmax probabilities cast
# to bf16 0.72-1.41, the embedding scale applied in f32 0.91-1.18.
BF16_SHARE = 0.7


@pytest.mark.parametrize("call", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_reference(arch, call, reference_runs, bf16_runs):
    """Every architecture's smoke config in bf16 (its configured dtype),
    the reference's weights carried across: the port's bf16 logits must be
    much nearer the reference's bf16 logits than its f32 ones are."""
    run, ref = reference_runs(arch), bf16_runs(arch)
    _, cfg = _cfgs(arch, dtype="bfloat16")
    model = params_from_reference(run["tree"], cfg, device="cpu")
    inp = torch.from_numpy(run["inp"])
    if call == "forward":
        logits = M.forward(model, inp)
    else:
        cache = M.init_cache(cfg, B, S, device="cpu")
        if call == "prefill":
            logits, _ = M.prefill(model, inp, cache)
        else:
            _, cache = M.prefill(model, inp[:, :S - 1], cache)
            logits, _ = M.decode_step(model, torch.from_numpy(run["last"]),
                                      cache)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
    mismatch = _rel(run[call], ref[call])
    assert mismatch > 0
    assert _rel(logits, ref[call]) <= BF16_SHARE * mismatch


def _close_bf16(port, ref):
    """A bf16 output of one layer on the same inputs: at most 1% of its
    elements differ from the reference's, by at most 5e-4 of its norm in
    all (measured over the cases below: 0.28% and 9.0e-5; wrong dtype
    steps give 16-66% and 1.5e-3-8.6e-2). An f32 output (a recurrent
    state) to 1e-5 of its norm (measured 7.2e-8)."""
    assert port.dtype == (torch.bfloat16 if ref.dtype == jnp.bfloat16
                          else torch.float32)
    if port.dtype == torch.float32:
        assert _rel(port, ref) <= 1e-5
        return
    assert float(np.mean(_f32(port) != _f32(ref))) <= 0.01
    assert _rel(port, ref) <= 5e-4


def _bf16_layer(name):
    """(reference config, port config, port module holding the reference's
    weights, reference apply, port apply) of one layer case in bf16."""
    arch, kw = {
        "mlp_silu": ("qwen3_0_6b", {}),
        "mlp_gelu": ("gemma2_2b", {}),
        "attention_qk_norm": ("qwen3_0_6b", {}),
        "attention_local_softcap": ("gemma2_2b", {}),
        "moe_einsum": ("dbrx_132b", {"moe_impl": "einsum"}),
        "moe_sort": ("dbrx_132b", {"moe_impl": "sort"}),
        "ssm": ("mamba2_1_3b", {}),
        "ssm_bf16_intra": ("mamba2_1_3b", {"ssm_bf16_intra": True}),
        "rglru": ("recurrentgemma_9b", {}),
    }[name]
    rcfg, cfg = _cfgs(arch, dtype="bfloat16", **kw)
    kind = name.split("_")[0]
    if kind == "attention":
        local = name.endswith("softcap")
        p = RL.init_attention(KEY, rcfg)
        return rcfg, cfg, _load(L.Attention(cfg, device="cpu"), p), \
            lambda x: RL.attention_apply(p, x, rcfg, local=local)[0], \
            lambda m, x: L.attention_apply(m, x, cfg, local=local)
    init, module, ref_apply, apply = {
        "mlp": (RL.init_mlp, L.MLP, RL.mlp_apply, L.mlp_apply),
        "moe": (RL.init_moe, L.MoE, RL.moe_apply, L.moe_apply),
        "ssm": (RL.init_ssm, L.SSM, RL.ssm_apply, L.ssm_apply),
        "rglru": (RL.init_rglru, L.RGLRU, RL.rglru_apply, L.rglru_apply),
    }[kind]
    p = init(KEY, rcfg)
    return rcfg, cfg, _load(module(cfg, device="cpu"), p), \
        lambda x, *c: ref_apply(p, x, rcfg, *c), \
        lambda m, x, *c: apply(m, x, cfg, *c)


@pytest.mark.parametrize("name", [
    "mlp_silu", "mlp_gelu", "attention_qk_norm", "attention_local_softcap",
    "moe_einsum", "moe_sort", "ssm", "ssm_bf16_intra", "rglru"])
def test_bf16_layer_matches_reference(name):
    """Each layer kind in bf16 on the same unit-scale inputs as the
    reference: the silu/GELU and sigmoid steps, the f32 scores and
    softmax, soft-capping, qk-norm, both MoE dispatches, SSD (with
    ``ssm_bf16_intra`` too) and RG-LRU, the recurrences also stepped
    through 8 single positions from their zero caches."""
    rcfg, cfg, module, ref_apply, apply = _bf16_layer(name)
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        out = apply(module, xt)
    ref = _strict(ref_apply, xb)
    if not name.startswith(("ssm", "rglru")):
        _close_bf16(out, ref)
        return
    (y, (state, _)), (ry, (rstate, _)) = out, ref
    _close_bf16(y, ry)
    _close_bf16(state, rstate)
    if name == "ssm_bf16_intra":   # the single-step path has no intra chunk
        return
    make = L.ssm_cache if name == "ssm" else L.rglru_cache
    ref_make = RL.ssm_cache if name == "ssm" else RL.rglru_cache
    cache = make(cfg, B, torch.bfloat16, "cpu")
    rc = ref_make(rcfg, B, jnp.bfloat16)
    st, cv, rst, rcv = cache["state"], cache["conv"], rc["state"], rc["conv"]
    step = jax.jit(ref_apply).lower(xb[:, :1], rst, rcv).compile(
        compiler_options=STRICT)
    for t in range(8):
        with torch.no_grad():
            y, (st, cv) = apply(module, xt[:, t:t + 1], st, cv)
        ry, (rst, rcv) = step(xb[:, t:t + 1], rst, rcv)
        _close_bf16(y, ry)
        _close_bf16(st, rst)
