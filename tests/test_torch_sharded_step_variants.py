"""Microbatches and gradient compression under a mesh, over gloo on the
CPU: four ranks on the (2, 2) debug mesh train qwen3's smoke config (f32,
batch 4 x 64, 3 steps) with ``microbatches=2``, with ``GDQuantizer(8)``
and with ``TopKCompressor(0.1)``, each against the single-process port
(and the microbatches against the jitted reference step too), all from
the reference's ``init_train_state(PRNGKey(0))`` restored at step 0. The
ranks also split a batch into microbatches and run both codecs on sharded
gradients, which are held against the single process bit for bit.

Tolerances: losses at rtol 1e-5 and parameters at rtol 2e-4, atol 2e-5
for the microbatches (``test_torch_train.py``'s microbatch test: the mesh
sums its partial products in another order); losses at rtol 1e-4 with a
codec (the int8 grid or the top-k cut moves an element a whole level
where a gradient's last bits differ)."""
import dataclasses
import datetime
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.train import grad_compress as G
from repro_torch.train.loop import train
from repro_torch.train.optimizer import Hyper

HYPER = Hyper(lr=1e-3, warmup_steps=1, total_steps=40)
STEPS, BATCH, SEQ = 3, 4, 64
DEADLINE_S = 240
CODECS = {"gd8": lambda: G.GDQuantizer(8),
          "topk": lambda: G.TopKCompressor(0.1)}
RUNS = {"mb2": {"microbatches": 2},
        **{name: {"compressor": make} for name, make in CODECS.items()}}


def _cfg():
    return dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                               dtype="float32")


def _train(run: str, root: str, prefix: str):
    kw = dict(RUNS[run])
    if "compressor" in kw:
        kw["compressor"] = kw["compressor"]()
    return train(_cfg(), HYPER, steps=STEPS, batch=BATCH, seq=SEQ,
                 ckpt_dir=os.path.join(root, f"{prefix}_{run}"),
                 ckpt_every=100, verbose=False, device="cpu", **kw)


def _codec_inputs(model):
    """Gradients and nonzero error feedback for every parameter, drawn
    from one seed (the same on every rank), at gradient-like scales."""
    rng = np.random.default_rng(9)
    grads, err = {}, {}
    for name, p in model.named_parameters():
        g = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        grads[name] = torch.from_numpy(1e-2 * g)
        err[name] = torch.from_numpy(
            1e-5 * rng.standard_normal(tuple(p.shape)).astype(np.float32))
    return grads, err


def _mesh_checks(mesh, cfg) -> dict:
    """On every rank: the microbatch split of a (4, 64) batch sharded as
    ``loop.shard_batch`` shards it, and both codecs on sharded gradients
    (their inputs and outputs gathered)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import model as M
    from repro_torch.sharding import placements
    from repro_torch.train.loop import _data_rank, shard_batch
    from repro_torch.train.step import split_microbatches
    tokens = torch.arange(BATCH * SEQ, dtype=torch.int32).reshape(BATCH, SEQ)
    n, r = _data_rank(mesh, BATCH, SEQ)
    per = BATCH // n
    batch = shard_batch({"tokens": tokens[r * per:(r + 1) * per]}, mesh,
                        BATCH, SEQ)
    micro = split_microbatches(batch, 2)
    out = {"micro": [{"placements": [repr(p) for p in mb["tokens"].placements],
                      "want": [repr(p) for p in placements(
                          ("batch", None), tuple(mb["tokens"].shape))],
                      "local_rows": mb["tokens"].to_local().shape[0],
                      "rows": mb["tokens"].full_tensor(),
                      "local": mb["tokens"].to_local()} for mb in micro],
           "data_rank": r}
    try:
        split_microbatches(batch, 4)
    except ValueError as exc:
        out["refused"] = str(exc)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                          param_dtype=torch.float32)
    placed = M.model_placements(model)
    M.replace_parameters(model, lambda name, p: distribute_tensor(
        p.detach(), mesh, placed[name], src_data_rank=None))
    grads, err = _codec_inputs(model)
    out["codecs"] = {}
    for name, make in CODECS.items():
        codec = make()
        zero = codec.init(model)
        sharded_err = all(
            e.placements == p.placements and e.to_local().shape ==
            p.to_local().shape for e, p in zip(zero.values(),
                                               model.parameters()))
        g = {n: distribute_tensor(t, mesh, placed[n], src_data_rank=None)
             for n, t in grads.items()}
        e = {n: distribute_tensor(t, mesh, placed[n], src_data_rank=None)
             for n, t in err.items()}
        kept, new_err = codec.compress(g, e)
        out["codecs"][name] = {
            "sharded_err": sharded_err,
            "placements_kept": all(kept[n].placements == placed[n]
                                   for n in kept),
            "kept": {n: t.full_tensor() for n, t in kept.items()},
            "err": {n: t.full_tensor() for n, t in new_err.items()}}
    return out


def _rank(rank: int, world: int, init_file: str, root: str):
    import torch.distributed as dist
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import set_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_debug_mesh()
        cfg = _cfg()
        set_mesh(mesh, arch_rules(cfg, 2))
        losses = {run: _train(run, root, "mesh")[1]["loss"] for run in RUNS}
        checks = _mesh_checks(mesh, cfg)
        torch.save(checks, os.path.join(root, f"checks_{rank}.pt"))
        if rank == 0:
            torch.save(losses, os.path.join(root, "mesh_loss.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    from repro.configs import get_config as ref_config
    from repro.train.loop import train as ref_train
    from repro.train.step import init_train_state as ref_init
    root = str(tmp_path_factory.mktemp("sharded_variants"))
    ref_cfg = dataclasses.replace(ref_config("qwen3-0.6b", smoke=True),
                                  dtype="float32")
    RefManager(os.path.join(root, "ref")).save(
        0, ref_init(ref_cfg, jax.random.PRNGKey(0)), blocking=True)
    for prefix in ("single", "mesh"):
        for run in RUNS:
            shutil.copytree(os.path.join(root, "ref"),
                            os.path.join(root, f"{prefix}_{run}"))
    ctx = torch.multiprocessing.spawn(
        _rank, args=(4, os.path.join(root, "init"), root), nprocs=4,
        join=False)
    try:
        _, ref_hist = ref_train(ref_cfg, HYPER, steps=STEPS, batch=BATCH,
                                seq=SEQ, ckpt_dir=os.path.join(root, "ref"),
                                ckpt_every=100, verbose=False,
                                microbatches=2)
        single = {run: _train(run, root, "single") for run in RUNS}
    finally:
        deadline = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the mesh ranks did not finish in "
                            f"{DEADLINE_S} s")
    return {"root": root, "ref_loss": np.asarray(ref_hist["loss"]),
            "single": single,
            "mesh_loss": torch.load(os.path.join(root, "mesh_loss.pt")),
            "checks": [torch.load(os.path.join(root, f"checks_{r}.pt"))
                       for r in range(4)]}


def test_mesh_microbatches_match_single_process_and_reference(_runs):
    mesh = np.asarray(_runs["mesh_loss"]["mb2"])
    state, hist = _runs["single"]["mb2"]
    assert len(mesh) == STEPS
    np.testing.assert_allclose(mesh, hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(mesh, _runs["ref_loss"], rtol=1e-5)
    _, got = CheckpointManager(os.path.join(_runs["root"],
                                            "mesh_mb2")).restore(
        state, device="cpu")
    for (name, p), (_, want) in zip(got.params.named_parameters(),
                                    state.params.named_parameters()):
        np.testing.assert_allclose(p.detach(), want.detach(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_mesh_microbatches_hold_the_reference_rows_sharded(_runs):
    """Microbatch i holds the global rows [2 i, 2 i + 2), sharded on the
    ``batch`` axis over the two data ranks (one row each); a split into
    4 microbatches over 2 data ranks is refused, naming the numbers."""
    tokens = torch.arange(BATCH * SEQ, dtype=torch.int32).reshape(BATCH, SEQ)
    for checks in _runs["checks"]:
        r = checks["data_rank"]
        for i, mb in enumerate(checks["micro"]):
            assert mb["placements"] == mb["want"]
            assert "Shard(dim=0)" in mb["placements"]
            assert mb["local_rows"] == 1
            assert torch.equal(mb["rows"], tokens[2 * i:2 * i + 2])
            assert torch.equal(mb["local"], tokens[2 * i + r:2 * i + r + 1])
        assert "4 microbatches over 2 data ranks" in checks["refused"]


@pytest.mark.parametrize("codec", list(CODECS))
def test_mesh_codec_equals_single_process_bit_for_bit(_runs, codec):
    """The codec on sharded gradients and error feedback, gathered, equals
    the single-process codec on the gathered inputs; the error feedback it
    makes (``init``) and its outputs lie on the parameters' placements."""
    from repro_torch.models import model as M
    model = M.init_params(_cfg(), torch.Generator().manual_seed(0), "cpu",
                          param_dtype=torch.float32)
    grads, err = _codec_inputs(model)
    single = CODECS[codec]()
    single.init(model)
    want_kept, want_err = single.compress(grads, err)
    for checks in _runs["checks"]:
        got = checks["codecs"][codec]
        assert got["sharded_err"] and got["placements_kept"]
        for name in want_kept:
            assert torch.equal(got["kept"][name], want_kept[name]), name
            assert torch.equal(got["err"][name], want_err[name]), name


@pytest.mark.parametrize("codec", list(CODECS))
def test_mesh_training_with_codec_matches_single_process(_runs, codec):
    mesh = np.asarray(_runs["mesh_loss"][codec])
    assert len(mesh) == STEPS
    np.testing.assert_allclose(mesh, _runs["single"][codec][1]["loss"],
                               rtol=1e-4)
