"""The port's sharded training over gloo on the CPU: a (2, 2) mesh of four
processes trains qwen3's smoke config against the single-process port
and the reference (and mamba2's and deepseek-moe's against the single
process), the checkpoint it writes restores onto two ranks and
is read by the reference's ``CheckpointManager``, decoding over a
sequence-sharded cache matches the plain decode, and ``--mesh`` refuses
to train without its ranks.

The ranks are spawned once for the module (``_runs``); each test reads
what they wrote. All three trainings restore the reference's initial
state (``init_train_state(PRNGKey(0))``) from a checkpoint at step 0, so
they start from the same weights; losses are held at rtol 1e-5 (the
reference against the port: a step's loss agrees to 1e-6,
``test_torch_train_step.py``; the mesh sums its partial results across
ranks in another order)."""
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
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import reference_tree
from repro_torch.train.loop import train
from repro_torch.train.optimizer import Hyper

HYPER = Hyper(lr=1e-3, warmup_steps=1, total_steps=40)
STEPS, BATCH, SEQ = 3, 4, 64
DEADLINE_S = 240


# Trained on the mesh against the single process besides qwen3: the SSD
# (its chunked scan per head under local_map) and an MoE (einsum dispatch).
OTHERS = ("mamba2-1.3b", "deepseek-moe-16b")


def _cfg(arch="qwen3-0.6b"):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _init_group(rank: int, world: int, init_file: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def _train_rank(rank: int, world: int, init_file: str, root: str):
    """One of four ranks: train on the (2, 2) debug mesh from the
    checkpoint at step 0; rank 0 saves the losses."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import set_mesh
    _init_group(rank, world, init_file)
    try:
        mesh = make_debug_mesh()
        cfg = _cfg()
        set_mesh(mesh, arch_rules(cfg, 2))
        _, hist = train(cfg, HYPER, steps=STEPS, batch=BATCH, seq=SEQ,
                        ckpt_dir=os.path.join(root, "mesh"), ckpt_every=100,
                        verbose=False, device="cpu")
        losses = {"qwen3-0.6b": hist["loss"]}
        for arch in OTHERS:
            set_mesh(mesh, arch_rules(_cfg(arch), 2))
            _, h = train(_cfg(arch), HYPER, steps=STEPS, batch=BATCH,
                         seq=SEQ, ckpt_dir=os.path.join(root, arch),
                         ckpt_every=100, verbose=False, device="cpu")
            losses[arch] = h["loss"]
        if rank == 0:
            torch.save(losses, os.path.join(root, "mesh_loss.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def _restore_rank(rank: int, world: int, init_file: str, root: str):
    """One of two ranks: restore the four ranks' final checkpoint onto a
    (data=1, model=2) mesh and save the gathered parameters (rank 0); then
    prefill and decode with the cache's sequence sharded over ``model``
    and save the logits."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import set_mesh
    from repro_torch.train.step import init_train_state
    _init_group(rank, world, init_file)
    try:
        mesh = make_mesh((1, 2), ("data", "model"))
        cfg = _cfg()
        set_mesh(mesh, arch_rules(cfg, 2))
        like = init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
        step, state = CheckpointManager(os.path.join(root, "mesh")).restore(
            like, device="cpu",
            placements=M.model_placements(like.params))
        full = {n: p.full_tensor() for n, p in
                state.params.named_parameters()}
        placed = {n: [repr(pl) for pl in p.placements] for n, p in
                  state.params.named_parameters()}
        if rank == 0:
            torch.save({"step": step, "params": full, "placements": placed},
                       os.path.join(root, "restored.pt"))
        _sharded_decode(cfg, mesh, root, rank)
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def _decode_inputs(cfg):
    from repro_torch.models import model as M
    model = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).int()
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (2,))).int()
    return model, prompt, token


def _decode(model, cfg, prompt, token, cache):
    from repro_torch.models import model as M
    first, cache = M.prefill(model, prompt, cache)
    second, _ = M.decode_step(model, token, cache)
    return first, second


def _sharded_decode(cfg, mesh, root, rank):
    """Prefill 2 x 12 tokens and decode one with the kv cache's sequence
    sharded over ``model`` (``kv_seq``; the heads replicated), as the
    rules make it where the kv heads do not divide the tensor axis."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.models import model as M
    from repro_torch.sharding import placements, set_mesh
    rules = dict(arch_rules(cfg, 2), kv_heads=(), kv_seq=("model",))
    set_mesh(mesh, rules)
    model, prompt, token = _decode_inputs(cfg)
    placed = M.model_placements(model)
    M.replace_parameters(model, lambda name, p: distribute_tensor(
        p.detach(), mesh, placed[name], src_data_rank=None))
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    cache.layers = [{k: distribute_tensor(t, mesh,
                                          placements(ax[k], t.shape),
                                          src_data_rank=None)
                     for k, t in layer.items()}
                    for layer, ax in zip(cache.layers, M.cache_axes(cfg))]
    dt = [DTensor.from_local(t, mesh, placements(("batch",) + (None,) *
                                                 (t.ndim - 1), t.shape),
                             run_check=False)
          for t in (prompt, token)]
    first, second = _decode(model, cfg, *dt, cache)
    seq_sharded = [repr(p) for p in cache.layers[0]["k"].placements]
    out = {"prefill": first.full_tensor(), "decode": second.full_tensor(),
           "cache_k": cache.layers[0]["k"].full_tensor(),
           "k_placements": seq_sharded}
    if rank == 0:
        torch.save(out, os.path.join(root, "decode.pt"))


def _spawn(fn, world: int, root: str, tag: str):
    ctx = torch.multiprocessing.spawn(
        fn, args=(world, os.path.join(root, f"init_{tag}"), root),
        nprocs=world, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {tag} ranks did not finish in {DEADLINE_S} s")


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """The reference's initial state at step 0 in three checkpoint
    directories; the reference and the port train from it in this
    process, four gloo ranks on the mesh; two ranks restore the mesh's
    final checkpoint and decode."""
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    from repro.configs import get_config as ref_config
    from repro.train.step import init_train_state as ref_init
    root = str(tmp_path_factory.mktemp("sharded"))
    ref_cfg = dataclasses.replace(ref_config("qwen3-0.6b", smoke=True),
                                  dtype="float32")
    RefManager(os.path.join(root, "ref")).save(
        0, ref_init(ref_cfg, jax.random.PRNGKey(0)), blocking=True)
    for name in ("single", "mesh"):
        shutil.copytree(os.path.join(root, "ref"), os.path.join(root, name))
    from repro.train.loop import train as ref_train
    _, ref_hist = ref_train(ref_cfg, HYPER, steps=STEPS, batch=BATCH,
                            seq=SEQ, ckpt_dir=os.path.join(root, "ref"),
                            ckpt_every=100, verbose=False)
    single, hist = train(_cfg(), HYPER, steps=STEPS, batch=BATCH, seq=SEQ,
                         ckpt_dir=os.path.join(root, "single"),
                         ckpt_every=100, verbose=False, device="cpu")
    others = {arch: train(_cfg(arch), HYPER, steps=STEPS, batch=BATCH,
                          seq=SEQ, ckpt_dir=os.path.join(root, "1_" + arch),
                          ckpt_every=100, verbose=False,
                          device="cpu")[1]["loss"]
              for arch in OTHERS}
    _spawn(_train_rank, 4, root, "train")
    _spawn(_restore_rank, 2, root, "restore")
    mesh = torch.load(os.path.join(root, "mesh_loss.pt"))
    return {"root": root, "ref_loss": np.asarray(ref_hist["loss"]),
            "single_loss": np.asarray(hist["loss"]),
            "mesh_loss": np.asarray(mesh["qwen3-0.6b"]),
            "others": {a: (np.asarray(mesh[a]), np.asarray(others[a]))
                       for a in OTHERS},
            "single": single, "ref_cfg": ref_cfg}


def test_mesh_training_matches_single_process_and_reference(_runs):
    assert len(_runs["mesh_loss"]) == STEPS
    np.testing.assert_allclose(_runs["mesh_loss"], _runs["single_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(_runs["mesh_loss"], _runs["ref_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(_runs["single_loss"], _runs["ref_loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("arch", OTHERS)
def test_mesh_training_of_ssd_and_moe_matches_single_process(_runs, arch):
    """mamba2's and deepseek-moe's smoke configs (f32, the einsum MoE
    dispatch) on the (2, 2) mesh against the single process, both from
    the port's seeded init: losses at rtol 1e-5."""
    mesh, single = _runs["others"][arch]
    assert len(mesh) == STEPS
    np.testing.assert_allclose(mesh, single, rtol=1e-5)


def test_elastic_restore_on_two_ranks_is_exact(_runs):
    """The four ranks' checkpoint (gathered, written by rank 0) restores
    onto a two-rank mesh, sharded, with every parameter equal to the
    file's."""
    got = torch.load(os.path.join(_runs["root"], "restored.pt"))
    assert got["step"] == STEPS
    assert any("Shard" in pl for pls in got["placements"].values()
               for pl in pls)
    like = _runs["single"]
    _, want = CheckpointManager(os.path.join(_runs["root"], "mesh")).restore(
        like, device="cpu")
    for name, p in want.params.named_parameters():
        assert torch.equal(got["params"][name], p.detach()), name


def test_mesh_checkpoint_reads_in_the_reference(_runs):
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    from repro.train.step import init_train_state as ref_init
    like = ref_init(_runs["ref_cfg"], jax.random.PRNGKey(1))
    step, ref_state = RefManager(os.path.join(_runs["root"],
                                              "mesh")).restore(like)
    assert int(step) == STEPS
    got = torch.load(os.path.join(_runs["root"], "restored.pt"))["params"]
    tree = reference_tree(got, _cfg())
    flat_got = jax.tree_util.tree_leaves(tree)
    flat_ref = jax.tree_util.tree_leaves(ref_state.params)
    assert len(flat_got) == len(flat_ref)
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_sequence_sharded_decode_matches_plain(_runs):
    """Prefill and one decode step with the cache's sequence split over
    two ranks (ring writes into each rank's slots, distributed softmax)
    against the plain decode: logits at rtol 1e-5, atol 1e-6 (f32 sums in
    another order: the residual stream's d_model is sharded, so the
    projections sum partial products), the cache's keys likewise."""
    from repro_torch.models import model as M
    got = torch.load(os.path.join(_runs["root"], "decode.pt"))
    assert "Shard(dim=1)" in got["k_placements"]
    cfg = _cfg()
    model, prompt, token = _decode_inputs(cfg)
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    first, second = _decode(model, cfg, prompt, token, cache)
    torch.testing.assert_close(got["prefill"], first, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got["decode"], second, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got["cache_k"], cache.layers[0]["k"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_mesh_flag_refuses_without_its_ranks(mesh, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    need = "512" if mesh == "multi" else "256"
    with pytest.raises(RuntimeError, match=f"needs {need} ranks"):
        train_cli.run(train_cli.parse(["--mesh", mesh, "--smoke",
                                       "--device", "cpu", "--steps", "1"]))
