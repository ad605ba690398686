"""Port copy of tests/test_train.py on ``repro_torch.train`` (resume
determinism, corruption recovery, compression, microbatches, telemetry)
at the reference test's sizes with ``device="cpu"``, plus: the telemetry
synopsis field by field against the reference's (the build is exact), the
checkpoint format read across the two packages, the checkpoint manager's
async error surfacing, SIGTERM, the entry points' devices, the training
command line, and the remat policies' gradients bit for bit."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params
from repro_torch.train.loop import InjectedFailure, train
from repro_torch.train.optimizer import Hyper
from repro_torch.train.step import init_train_state, loss_and_grads
from test_torch_build import assert_same_synopsis

ROOT = Path(__file__).resolve().parents[1]



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's smoke-sized ops on one intra-op thread, restored after
    each test: under the suite's parallel workers, more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfg():
    return dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                               dtype="float32")


HYPER = Hyper(lr=1e-3, warmup_steps=5, total_steps=40)


def _params(state):
    return [p.detach() for p in state.params.parameters()]


def test_crash_resume_bitwise_identical(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    s1, h1 = train(_cfg(), HYPER, steps=12, batch=4, seq=64, ckpt_dir=d1,
                   ckpt_every=4, verbose=False, device="cpu")
    with pytest.raises(InjectedFailure):
        train(_cfg(), HYPER, steps=12, batch=4, seq=64, ckpt_dir=d2,
              ckpt_every=4, fail_at_step=7, verbose=False, device="cpu")
    s2, h2 = train(_cfg(), HYPER, steps=12, batch=4, seq=64, ckpt_dir=d2,
                   ckpt_every=4, verbose=False, device="cpu")
    assert int(s1.step) == int(s2.step) == 12
    for a, b in zip(_params(s1), _params(s2)):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for name in s1.opt[k]:
            assert torch.equal(s1.opt[k][name], s2.opt[k][name])
    assert h1["loss"][4:] == h2["loss"]          # resumed at step 4


def test_corrupt_checkpoint_skip_back(tmp_path):
    d = str(tmp_path / "c")
    train(_cfg(), HYPER, steps=8, batch=4, seq=64, ckpt_dir=d, ckpt_every=3,
          verbose=False, device="cpu")
    mgr = CheckpointManager(d)
    steps = mgr.all_steps()
    assert len(steps) >= 2
    # Corrupt the newest checkpoint's first array file.
    newest = os.path.join(d, f"step_{steps[-1]:010d}")
    victim = next(f for f in os.listdir(newest) if f.endswith(".npy"))
    with open(os.path.join(newest, victim), "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xde\xad\xbe\xef")
    like = init_train_state(_cfg(), torch.Generator().manual_seed(0), "cpu")
    step, state = mgr.restore(like, device="cpu")
    assert step == steps[-2]  # skipped back past the corrupt one


def test_loss_decreases(tmp_path):
    _, hist = train(_cfg(), HYPER, steps=30, batch=8, seq=64,
                    ckpt_dir=str(tmp_path / "d"), ckpt_every=100,
                    verbose=False, device="cpu")
    first = np.mean(hist["loss"][:5])
    last = np.mean(hist["loss"][-5:])
    assert last < first - 0.2
    assert np.isfinite(hist["grad_norm"]).all()


def test_grad_compression_error_feedback_converges(tmp_path):
    from repro_torch.train.grad_compress import GDQuantizer
    _, hist = train(_cfg(), HYPER, steps=30, batch=8, seq=64,
                    ckpt_dir=str(tmp_path / "e"), ckpt_every=100,
                    compressor=GDQuantizer(bits=8), verbose=False,
                    device="cpu")
    first = np.mean(hist["loss"][:5])
    last = np.mean(hist["loss"][-5:])
    assert last < first - 0.2  # compression must not break convergence


def test_microbatch_accumulation_matches_full_batch():
    import copy

    from repro_torch.train.step import make_train_step
    cfg = _cfg()
    pipe = TokenPipeline(cfg.vocab, 8, 64, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in pipe.host_slice(0).items()}
    s0 = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    full = make_train_step(cfg, HYPER, microbatches=1)
    micro = make_train_step(cfg, HYPER, microbatches=4)
    s1, m1 = full(copy.deepcopy(s0), batch)     # the step updates in place
    s2, m2 = micro(copy.deepcopy(s0), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(_params(s1), _params(s2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def _telemetry_rows():
    rng = np.random.default_rng(0)
    rows = []
    for step in range(5000):
        host = f"host{step % 4}"
        base = 0.1 if host != "host3" else 0.25   # host3 is a straggler
        rows.append(dict(step=step, loss=3.0 - step * 1e-4,
                         grad_norm=float(rng.random()),
                         step_time=base + rng.random() * 0.01, host=host))
    return rows


def test_telemetry_aqp_queries():
    from repro_torch.core.types import BuildParams
    from repro_torch.train.telemetry import TelemetryStore
    tel = TelemetryStore(BuildParams(n_samples=5000), device="cpu")
    for row in _telemetry_rows():
        tel.record(**row)
    res = tel.query("SELECT AVG(step_time) FROM t WHERE host = 'host3'")
    assert abs(res.estimate - 0.255) < 0.01
    # loss is a *deterministic uniform* function of step: both marginals are
    # uniform, so the paper's per-dimension uniformity test never splits the
    # pair — a structural blind spot of RefineBin2D (DESIGN.md §7.6). The
    # estimate degrades gracefully to ~8% instead of <1%.
    res2 = tel.query("SELECT AVG(loss) FROM t WHERE step > 4000")
    exact2 = 3.0 - 4500 * 1e-4
    assert abs(res2.estimate - exact2) / exact2 < 0.12
    stragglers = tel.straggler_report()
    assert "host3" in stragglers


def test_telemetry_synopsis_equals_reference():
    """The same 5,000 rows into both packages' stores: the synopses are
    equal field by field, and so are the three answers and the straggler
    report."""
    from repro.core.types import BuildParams as RefParams
    from repro.train.telemetry import TelemetryStore as RefStore
    from repro_torch.core.types import BuildParams
    from repro_torch.train.telemetry import TelemetryStore
    rows = _telemetry_rows()
    ref = RefStore(RefParams(n_samples=5000))
    port = TelemetryStore(BuildParams(n_samples=5000), device="cpu")
    ref.extend(rows)
    port.extend(rows)
    ref.build()
    port.build()
    assert_same_synopsis(port._framework.synopsis, ref._framework.synopsis)
    for sql in ("SELECT AVG(step_time) FROM t WHERE host = 'host3'",
                "SELECT AVG(loss) FROM t WHERE step > 4000",
                "SELECT MEDIAN(step_time) FROM t"):
        assert port.query(sql).estimate == ref.query(sql).estimate, sql
    assert port.straggler_report() == ref.straggler_report()


def test_telemetry_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.train.telemetry import TelemetryStore
    with pytest.raises(RuntimeError, match="CUDA"):
        TelemetryStore()


def _ref_state(cfg, step):
    from repro.configs import get_config as ref_config
    from repro.train.step import init_train_state as ref_init
    rcfg = dataclasses.replace(ref_config(cfg.name.replace("-smoke", ""),
                                          smoke=True), dtype="float32")
    state = ref_init(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(step)
    noisy = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32), state)
    return noisy._replace(step=np.int32(step))


def test_checkpoints_cross_packages(tmp_path):
    """The port writes the reference's layout and keys: the reference's
    ``CheckpointManager`` restores a port checkpoint, the port's restores a
    reference checkpoint, both with equal values."""
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    from repro_torch.models.convert import reference_tree
    cfg = _cfg()
    ref_state = _ref_state(cfg, 5)
    RefManager(str(tmp_path / "r")).save(5, ref_state, blocking=True)
    like = init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    step, got = CheckpointManager(str(tmp_path / "r")).restore(like,
                                                               device="cpu")
    assert step == 5 and got.step == 5
    want = jax.tree_util.tree_map(np.asarray, ref_state)
    for part, tree in (("params", dict(got.params.named_parameters())),
                       ("mu", got.opt["mu"]), ("nu", got.opt["nu"])):
        ref_tree = want.params if part == "params" else want.opt[part]
        for a, b in zip(jax.tree_util.tree_leaves(reference_tree(tree, cfg)),
                        jax.tree_util.tree_leaves(ref_tree)):
            np.testing.assert_array_equal(a, b)

    CheckpointManager(str(tmp_path / "p")).save(7, got, blocking=True)
    step, back = RefManager(str(tmp_path / "p")).restore(ref_state)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_restore_skips_a_checkpoint_of_another_model(tmp_path):
    cfg = _cfg()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, init_train_state(cfg, torch.Generator().manual_seed(0),
                                 "cpu"), blocking=True)
    wider = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    like = init_train_state(wider, torch.Generator().manual_seed(0), "cpu")
    assert mgr.restore(like, device="cpu") == (None, None)


def test_async_save_error_surfaces_at_wait(tmp_path):
    """A save that fails on the worker thread raises at the next
    ``wait()`` (or the next ``save``, which waits first), once."""
    state = init_train_state(_cfg(), torch.Generator().manual_seed(0), "cpu")
    mgr = CheckpointManager(str(tmp_path))
    blocker = tmp_path / f"step_{1:010d}.tmp"
    blocker.write_text("a file where the save wants a directory")
    mgr.save(1, state)                      # async: returns at once
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                              # reported once
    blocker.unlink()
    mgr.save(2, state)
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_save_snapshots_before_returning(tmp_path):
    """The async save copies the state to the host before it returns, so
    an update in place right after it does not reach the checkpoint."""
    cfg = _cfg()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    before = state.params.embed.detach().clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    with torch.no_grad():
        state.params.embed.add_(1.0)
    mgr.wait()
    like = init_train_state(cfg, torch.Generator().manual_seed(2), "cpu")
    _, got = mgr.restore(like, device="cpu")
    assert torch.equal(got.params.embed, before)


def test_train_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "3", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "done: step 3" in out.stdout
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [3]


def test_entry_points_refuse_mesh_and_missing_card(tmp_path):
    """``--mesh single`` without its 256 ranks raises, naming them; without
    a card the default device raises in the CLI, ``train``,
    ``init_train_state`` and ``CheckpointManager.restore``."""
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        train_cli.main(["--smoke", "--steps", "1", "--mesh", "single",
                        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--smoke", "--steps", "1", "--ckpt-dir",
                        str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train(_cfg(), HYPER, steps=1, batch=2, seq=8, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(_cfg())
    like = init_train_state(_cfg(), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(str(tmp_path / "r")).restore(like)


def test_sigterm_checkpoints_and_stops(tmp_path):
    """A SIGTERM during a step makes the loop checkpoint after it and
    return (the handler set by ``train`` is restored)."""
    import signal

    class KillAtStep2:
        def record(self, step, **_):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    d = str(tmp_path / "s")
    state, hist = train(_cfg(), HYPER, steps=10, batch=2, seq=16,
                        ckpt_dir=d, ckpt_every=100, telemetry=KillAtStep2(),
                        verbose=False, device="cpu")
    assert int(state.step) == 3 and len(hist["loss"]) == 3
    assert CheckpointManager(d).all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) == before


def test_train_leaves_no_deterministic_mode(tmp_path):
    """``train`` runs its steps with deterministic algorithms and restores
    the process's settings when it returns or raises."""
    from torch.utils import deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              deterministic.fill_uninitialized_memory,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    train(_cfg(), HYPER, steps=2, batch=2, seq=16,
          ckpt_dir=str(tmp_path / "a"), verbose=False, device="cpu")
    with pytest.raises(InjectedFailure):
        train(_cfg(), HYPER, steps=2, batch=2, seq=16,
              ckpt_dir=str(tmp_path / "b"), fail_at_step=1, verbose=False,
              device="cpu")
    assert (torch.are_deterministic_algorithms_enabled(),
            deterministic.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG")) == before


# One architecture a block kind: attention with qk-norm, local/global
# attention with soft-capping, MoE, SSD and RG-LRU.
REMAT_ARCHS = ("qwen3_0_6b", "gemma2_2b", "dbrx_132b", "mamba2_1_3b",
               "recurrentgemma_9b")


@pytest.mark.parametrize("arch,cast_bf16",
                         [(a, False) for a in REMAT_ARCHS]
                         + [("qwen3_0_6b", True), ("dbrx_132b", True)])
def test_remat_policies_give_identical_gradients(arch, cast_bf16):
    """The port's gradients are bit for bit equal with remat off and under
    ``"nothing"``, ``"dots"`` and ``"blk_out"``: recomputation repeats the
    forward exactly, with ``cast_bf16`` on the same bf16 weights (a cast
    made outside what the backward recomputes would read the f32 masters
    there). The model's parameters keep their identity and order."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    batch = TokenPipeline(cfg.vocab, 2, 32, seed=1).host_slice(0)
    if cfg.embed_inputs:
        batch["embeds"] = np.random.default_rng(1).standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for kw in ({"remat": False}, {"remat_policy": "nothing"},
               {"remat_policy": "dots"}, {"remat_policy": "blk_out"}):
        model = init_params(dataclasses.replace(cfg, **kw),
                            torch.Generator().manual_seed(0), "cpu",
                            param_dtype=torch.float32)
        names = [(n, id(p)) for n, p in model.named_parameters()]
        out.append(loss_and_grads(model, batch, cast_bf16))
        assert [(n, id(p)) for n, p in model.named_parameters()] == names
    (loss0, g0), rest = out[0], out[1:]
    for loss, g in rest:
        assert torch.equal(loss, loss0)
        for name in g0:
            assert torch.equal(g[name], g0[name]), name


def test_remat_policy_unknown_raises():
    cfg = dataclasses.replace(_cfg(), remat_policy="everything")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        param_dtype=torch.float32)
    batch = TokenPipeline(cfg.vocab, 2, 16, seed=1).host_slice(0)
    with pytest.raises(ValueError, match="remat_policy"):
        loss_and_grads(model, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
