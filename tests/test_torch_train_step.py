"""The port's training step (``repro_torch.train``, ``repro_torch.data``, the
model's autograd and remat) against the reference on the CPU.

Every architecture's smoke config in f32 (``capacity_factor=8.0``, as
``tests/test_models.py``) starts from the reference's
``init_train_state(PRNGKey(0))``, carried across by
``params_from_reference(..., param_dtype=f32)``, at step ``START`` (past
the warmup, so the compared step moves the weights) with zero moments.
One jitted reference ``train_step`` and ``jax.value_and_grad(loss_fn)``
run on a ``TokenPipeline`` batch; the port's step runs on the same batch.
Everything is compared in the reference's stacked layout
(``convert.reference_tree``).

Tolerances, measured over the ten architectures and the variants:

* loss: rtol 1e-6 (measured at most 1.3e-7); grad norm: rtol 3e-5
  (measured at most 9.8e-6: the reference sums the squares of 88k-675k
  elements in f32 in index order);
* learning rate: rtol 1e-6 (measured 5.4e-7, 4.5 ulps: jitted, XLA
  multiplies by the reciprocal of the constant warmup and fuses the
  schedule's multiply-adds, so its own eager schedule differs from its
  jitted one; the port rounds each op as the jaxpr says);
* gradients, per leaf: ``|port - ref| <= 3e-5 * max|ref|`` (measured at
  most 1.03e-5, the SSD's ``A_log``); moments ``5e-5`` (measured at most
  1.04e-5 for ``mu`` and 2.08e-5 for ``nu``, which carry the clip scale
  and its f32 norm); with ``cast_bf16``, whose gradients are bf16
  cotangents on both sides, ``BF16_TOL`` = 2^-9 of the leaf's largest;
* updated parameters, by the sign rule: on the first AdamW steps
  ``mhat / (sqrt(vhat) + eps)`` is about ``sign(g)``, so an element whose
  gradient lies within rounding of zero may move by up to ``2 * lr``
  between two correct implementations. The step is insensitive to a
  relative error of ``g`` elsewhere: ``eps / (|g| + eps)`` times it. So an
  element is clear of the noise where the two packages' gradients (read
  from the new ``mu``, 0.1 x the clipped gradient: the moments start at
  zero) agree within ``AGREE`` = 1e-4 of ``|g|``; there the parameters are
  held at rtol 1e-6, atol 1e-7 (a ten-thousandth of one step of ``lr``
  1e-3). The other elements are counted: 220 (mamba2) to 3,901
  (recurrentgemma) of 88,560-674,208, at most 0.58% (qwen3: 1,105 of
  270,912), bounded at ``NOISE_SHARE`` = 1%; each may differ by at most
  one flipped step. With ``cast_bf16`` see ``BF16_TOL``.
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
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.train import grad_compress as RG
from repro.train.optimizer import Hyper as RefHyper
from repro.train.optimizer import schedule as ref_schedule
from repro.train.step import init_train_state as ref_init_state
from repro.train.step import make_train_step as ref_make_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import Model
from repro_torch.models.convert import (params_from_reference,
                                        reference_leaves,
                                        reference_state_dict, reference_tree)
from repro_torch.train import grad_compress as G
from repro_torch.train.optimizer import Hyper, adamw_init, decayed, schedule
from repro_torch.train.step import TrainState, loss_and_grads, \
    make_train_step

B, S = 4, 32
START = 6
HYPER = dict(lr=1e-3, warmup_steps=5, total_steps=40)
WD = Hyper().weight_decay
KEY = jax.random.PRNGKey(0)
STRICT = {"xla_allow_excess_precision": False}
LOSS_RTOL, GNORM_RTOL = 1e-6, 3e-5
GRAD_TOL = 3e-5          # of the leaf's largest magnitude
MOMENT_TOL = 5e-5
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7
AGREE = 1e-4             # gradients agreeing within this share of |g|
NOISE = 1e-4             # cast_bf16: |g| above this share of the leaf's max
NOISE_SHARE = 0.01       # at most this share of elements is noise
LR_RTOL = 1e-6
# With cast_bf16 each weight is cast to bf16 once and its gradient reaches
# the f32 master as a bf16 cotangent, on both sides (the uses of one weight,
# such as the embedding's lookup and logits, summed in bf16). An element
# whose f32 cotangent lies near a rounding boundary lands one bf16 ulp
# (2^-8 of itself) away: the moments are held at BF16_TOL of the leaf's
# largest (measured at most 9.1e-4 for mu, 2.4e-4 for nu). For the sign
# rule an element is clear where the two gradients agree within
# BF16_AGREE (one bf16 ulp and a half) of |g| and |g| exceeds NOISE of its
# leaf's largest (the step feels eps below it): 3,628 of 270,912 (1.34%)
# are not, bounded at 3%.
BF16_TOL = 2.0 ** -9
BF16_AGREE = 2.0 ** -7
BF16_NOISE_SHARE = 0.03
VARIANTS = {
    "microbatches_4": ({}, {"microbatches": 4}),
    "cast_bf16": ({}, {"cast_bf16": True}),
    "remat_off": ({"remat": False}, {}),
    "remat_dots": ({"remat_policy": "dots"}, {}),
    "remat_blk_out": ({"remat_policy": "blk_out"}, {}),
}



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's smoke-sized ops on one intra-op thread, restored after
    each test: under the suite's parallel workers, more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(arch, **kw):
    kw = dict(dict(dtype="float32", capacity_factor=8.0), **kw)
    return (dataclasses.replace(ref_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def _batch(cfg, seed=1):
    batch = RefPipeline(cfg.vocab, B, S, seed=seed).host_slice(0)
    if cfg.embed_inputs:
        rng = np.random.default_rng(seed)
        batch = {"embeds": (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32),
            "labels": batch["labels"]}
    return batch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def reference_steps():
    """Per (arch, variant), computed once: the reference's start state,
    batch, loss and gradients of ``value_and_grad(loss_fn)`` and the state
    and metrics after one ``train_step``, as NumPy trees."""
    runs = {}

    def get(arch, variant=None):
        if (arch, variant) not in runs:
            cfg_kw, step_kw = VARIANTS[variant] if variant else ({}, {})
            rcfg, _ = _cfgs(arch, **cfg_kw)
            state = ref_init_state(rcfg, KEY)._replace(step=jnp.int32(START))
            batch = _batch(rcfg)
            step = ref_make_step(rcfg, RefHyper(**HYPER), **step_kw)
            fn = jax.jit(lambda s, b: (step(s, b), jax.value_and_grad(
                R.loss_fn)(s.params, rcfg, b)))
            if step_kw.get("cast_bf16"):   # round to bf16 where it casts
                fn = fn.lower(state, batch).compile(compiler_options=STRICT)
            (new, metrics), (loss, grads) = fn(state, batch)
            runs[arch, variant] = {
                "params": _np(state.params), "batch": batch,
                "loss": float(loss), "grads": _np(grads),
                "new": _np(new.params), "mu": _np(new.opt["mu"]),
                "nu": _np(new.opt["nu"]),
                "metrics": {k: float(v) for k, v in metrics.items()}}
        return runs[arch, variant]
    return get


def _port_state(run, cfg):
    model = params_from_reference(run["params"], cfg, device="cpu",
                                  param_dtype=torch.float32)
    return TrainState(params=model, opt=adamw_init(model), step=START)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_tree(port, ref, what, tol):
    """Every leaf within ``tol`` of its largest magnitude."""
    for (path, want), got in zip(_leaves(ref),
                                 jax.tree_util.tree_leaves(port)):
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (what, jax.tree_util.keystr(path),
                                    err, scale)


def _check_params(port, ref, start, port_g, ref_g, lr, agree=AGREE,
                  floor=0.0, share=NOISE_SHARE):
    """The sign rule (module docstring): an element is clear of noise where
    the two packages' gradients (``port_g``, ``ref_g``) agree within
    ``agree`` of ``|g|`` and ``|g|`` exceeds ``floor`` of its leaf's
    largest; its parameter must match at PARAM_RTOL / PARAM_ATOL. At most
    ``share`` of the elements are not clear, and each of them lies within
    one flipped step. Returns their count."""
    noise = total = 0
    for (path, want), got, p0, pg, g in zip(
            _leaves(ref), jax.tree_util.tree_leaves(port),
            jax.tree_util.tree_leaves(start),
            jax.tree_util.tree_leaves(port_g),
            jax.tree_util.tree_leaves(ref_g)):
        clear = (np.abs(pg - g) <= agree * np.abs(g)) \
            & (np.abs(g) > floor * float(np.abs(g).max()))
        np.testing.assert_allclose(got[clear], want[clear], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        limit = 2 * lr * (1 + WD * np.abs(p0[~clear])) + PARAM_ATOL
        assert (np.abs(got[~clear] - want[~clear]) <= limit).all()
        noise += int((~clear).sum())
        total += g.size
    assert noise <= share * total, (noise, total)
    return noise


def _run_port(arch, run, cfg_kw=None, step_kw=None):
    _, cfg = _cfgs(arch, **(cfg_kw or {}))
    state = _port_state(run, cfg)
    batch = _torch_batch(run["batch"])
    loss, grads = loss_and_grads(state.params, batch)
    new, metrics = make_train_step(cfg, Hyper(**HYPER), **(step_kw or {}))(
        state, batch)
    return cfg, loss, grads, new, metrics


def _check_step(cfg, run, new, metrics, tol=MOMENT_TOL):
    """The step's metrics and moments (at ``tol``), and its parameters by the sign rule with ``|g|`` read from the reference's
    new ``mu`` (0.1 x the clipped gradient: the moments start at zero)."""
    assert new.step == START + 1
    assert float(metrics["loss"]) == pytest.approx(run["metrics"]["loss"],
                                                   rel=LOSS_RTOL)
    assert float(metrics["grad_norm"]) == pytest.approx(
        run["metrics"]["grad_norm"], rel=GNORM_RTOL)
    assert float(metrics["lr"]) == pytest.approx(run["metrics"]["lr"],
                                                 rel=LR_RTOL)
    _close_tree(reference_tree(new.opt["mu"], cfg), run["mu"], "mu", tol)
    _close_tree(reference_tree(new.opt["nu"], cfg), run["nu"], "nu", tol)
    kw = dict(agree=BF16_AGREE, floor=NOISE, share=BF16_NOISE_SHARE) \
        if tol == BF16_TOL else {}
    return _check_params(
        reference_tree(dict(new.params.named_parameters()), cfg), run["new"],
        run["params"], reference_tree(new.opt["mu"], cfg), run["mu"],
        run["metrics"]["lr"], **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, reference_steps):
    """Loss, gradients (against ``value_and_grad``), grad norm, moments and
    the updated parameters of one step."""
    run = reference_steps(arch)
    cfg, loss, grads, new, metrics = _run_port(arch, run)
    assert float(loss) == pytest.approx(run["loss"], rel=LOSS_RTOL)
    _close_tree(reference_tree(grads, cfg), run["grads"], "grads", GRAD_TOL)
    _check_step(cfg, run, new, metrics)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_variant_matches_reference(variant, reference_steps):
    """qwen3's smoke config with 4 microbatches, with ``cast_bf16`` and
    under each other remat setting, against the reference's same step."""
    run = reference_steps("qwen3_0_6b", variant)
    cfg_kw, step_kw = VARIANTS[variant]
    cfg, _, _, new, metrics = _run_port("qwen3_0_6b", run, cfg_kw, step_kw)
    _check_step(cfg, run, new, metrics,
                BF16_TOL if step_kw.get("cast_bf16") else MOMENT_TOL)


def test_token_pipeline_bit_for_bit():
    """``global_batch`` and ``host_slice`` of both ranks of a 2-rank
    pipeline, for several seeds and steps."""
    for seed in (0, 1, 7):
        for rank in (0, 1):
            ref = RefPipeline(512, 6, 49, seed=seed, n_ranks=2, rank=rank)
            port = TokenPipeline(512, 6, 49, seed=seed, n_ranks=2, rank=rank)
            for step in (0, 1, 5, 123):
                for got, want in ((port.global_batch(step),
                                   ref.global_batch(step)),
                                  (port.host_slice(step),
                                   ref.host_slice(step))):
                    assert got.keys() == want.keys()
                    for k in want:
                        assert got[k].dtype == want[k].dtype
                        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        TokenPipeline(512, 5, 8, n_ranks=2)


@pytest.mark.parametrize("hyper", [HYPER, {}])
def test_schedule_matches_reference(hyper):
    """Every step of the schedule, 0 .. total_steps, against the jitted
    reference's, within two ulps (module docstring)."""
    ref_h, port_h = RefHyper(**hyper), Hyper(**hyper)
    steps = np.arange(port_h.total_steps + 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda t: ref_schedule(ref_h, t)))(
        steps))
    got = np.array([float(schedule(port_h, int(t))) for t in steps],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)
    assert schedule(port_h, 3).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_leaves_and_decayed_set(arch):
    """``reference_leaves`` names the reference tree's leaves in its
    flatten order, with their ranks; weight decay (and ``cast_bf16``)
    reaches exactly the reference's leaves of rank 2 or more: every block
    leaf and the embedding, never ``ln_f``."""
    rcfg, cfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: R.init_params(rcfg, k), KEY)
    ref = [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path), len(leaf.shape))
           for path, leaf in _leaves(shapes)]
    leaves = reference_leaves(cfg)
    assert [(leaf.key, leaf.ndim) for leaf in leaves] == ref
    port_decayed = {leaf.key for leaf in leaves
                    if set(leaf.names) <= decayed(cfg)}
    assert port_decayed == {key for key, ndim in ref if ndim >= 2}
    assert {key for key, _ in ref} - port_decayed == {"ln_f"}
    names = [name for leaf in leaves for name in leaf.names]
    assert sorted(names) == sorted(
        n for n, _ in Model(cfg, device="meta").named_parameters())


@pytest.mark.parametrize("codec", ["gd8", "gd4", "topk"])
def test_codecs_match_reference(codec, reference_steps):
    """Both packages' ``compress`` on the reference's gradients of qwen3's
    smoke step and a nonzero error-feedback tree: equal decompressed
    gradients and new errors, bit for bit. The scale (``GDQuantizer``) and
    the threshold (``TopKCompressor``) are taken per reference leaf: one
    over both layers of each stacked leaf."""
    run = reference_steps("qwen3_0_6b")
    _, cfg = _cfgs("qwen3_0_6b")
    rng = np.random.default_rng(3)
    grads = run["grads"]
    err = jax.tree_util.tree_map(
        lambda g: (1e-3 * rng.standard_normal(g.shape)).astype(np.float32)
        * np.float32(np.abs(g).max()), grads)
    ref_codec, port_codec = {
        "gd8": (RG.GDQuantizer(8), G.GDQuantizer(8)),
        "gd4": (RG.GDQuantizer(4), G.GDQuantizer(4)),
        "topk": (RG.TopKCompressor(0.1), G.TopKCompressor(0.1))}[codec]
    want = _np(ref_codec.compress(grads, err))
    model = params_from_reference(run["params"], cfg, device="cpu",
                                  param_dtype=torch.float32)
    assert all(not e.any() for e in port_codec.init(model).values())

    def port_dict(tree):
        return {k: torch.from_numpy(np.array(v))
                for k, v in reference_state_dict(tree, cfg).items()}
    got = port_codec.compress(port_dict(grads), port_dict(err))
    for part in (0, 1):
        for (path, w), g in zip(_leaves(want[part]), jax.tree_util.tree_leaves(
                reference_tree(got[part], cfg))):
            np.testing.assert_array_equal(g, w, err_msg=(
                part, jax.tree_util.keystr(path)))


# The port's bf16 gradients may lie at most this share of the distance
# between the reference's f32 and bf16 gradients from the reference's bf16
# ones (the models' bf16 share, tests/test_torch_models.py).
BF16_SHARE = 0.7


def test_bf16_step_matches_reference(reference_steps):
    """qwen3's smoke config computing in bf16 from f32 masters, as it
    trains on the card: the loss and the gradients of one step, against the
    reference compiled with every op rounded to its dtype, within
    ``BF16_SHARE`` of the reference's own f32-to-bf16 distance."""
    run = reference_steps("qwen3_0_6b")
    rcfg, cfg = _cfgs("qwen3_0_6b", dtype="bfloat16")
    params = jax.tree_util.tree_map(jnp.asarray, run["params"])
    fn = jax.jit(jax.value_and_grad(lambda p, b: R.loss_fn(p, rcfg, b)))
    loss16, g16 = fn.lower(params, run["batch"]).compile(
        compiler_options=STRICT)(params, run["batch"])
    model = params_from_reference(run["params"], cfg, device="cpu",
                                  param_dtype=torch.float32)
    loss, grads = loss_and_grads(model, _torch_batch(run["batch"]))
    assert all(g.dtype == torch.float32 for g in grads.values())

    def flat(tree):
        return np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in jax.tree_util.tree_leaves(tree)])
    want, f32 = flat(_np(g16)), flat(run["grads"])
    got = flat(reference_tree(grads, cfg))
    mismatch = np.linalg.norm(f32 - want) / np.linalg.norm(want)
    assert mismatch > 0
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= \
        BF16_SHARE * mismatch
    assert abs(float(loss) - float(loss16)) <= \
        BF16_SHARE * abs(run["loss"] - float(loss16))
