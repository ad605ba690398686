"""Fault-tolerant training loop.

The port of ``src/repro/train/loop.py``:

  * periodic + SIGTERM-triggered atomic checkpoints (preemption safety);
  * deterministic resume: the data pipeline is a function of the step,
    parameters and moments restore bit-exactly, and the steps themselves
    are reproducible (``deterministic_algorithms``) -> the state after a
    resume equals the uninterrupted run's bit for bit, on the card too;
  * straggler watchdog: per-step wall times stream into the PairwiseHist
    telemetry store; steps above 1.5x the trailing p99 are flagged (on a
    real fleet this triggers a hot-spare swap — here it logs);
  * failure injection (``fail_at_step``) for crash/restart testing;
  * optional GD-inspired gradient compression with error feedback.
"""
from __future__ import annotations

import contextlib
import os
import signal
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import ModelConfig, model_placements
from repro_torch.sharding import get_mesh, logical_to_spec, placements
from repro_torch.train.grad_compress import make_compressing_hook
from repro_torch.train.optimizer import Hyper
from repro_torch.train.step import (init_train_state, make_train_step,
                                    shard_state)

# cuBLAS's deterministic workspace setting (NVIDIA's cuBLAS documentation,
# "Results reproducibility"), which PyTorch's deterministic mode requires.
CUBLAS_WORKSPACE = ":4096:8"


class InjectedFailure(RuntimeError):
    pass


@contextlib.contextmanager
def deterministic_algorithms():
    """Within the block, PyTorch picks deterministic kernels
    (``torch.use_deterministic_algorithms(True, warn_only=True)``):
    gradients that scatter, such as the loss's gather and the MoE sort
    dispatch, sum in a fixed order; ``CUBLAS_WORKSPACE_CONFIG`` is
    ``:4096:8`` unless it was set (it takes effect where no cuBLAS call
    ran before it; on one stream cuBLAS repeats its results either way).
    An op that PyTorch lists without a deterministic CUDA version (the f32
    ``cumsum`` of the SSD and of the MoE einsum dispatch, the latter on
    0/1 values, so exact in any order) warns instead of raising.
    Uninitialised memory is not filled. Every setting is restored on
    exit."""
    from torch.utils import deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            deterministic.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    if prev[3] is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True, warn_only=True)
    deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        deterministic.fill_uninitialized_memory = prev[2]
        if prev[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def _data_rank(mesh, batch: int, seq: int) -> tuple:
    """(ranks, this rank) of the data-parallel split of the batch under
    ``mesh``: the mesh dims that shard the ``batch`` axis (``(1, 0)``
    where none does, as when the batch does not divide)."""
    n, rank = 1, 0
    for axis in logical_to_spec(("batch", None), (batch, seq))[0]:
        i = mesh.mesh_dim_names.index(axis)
        n, rank = n * mesh.size(i), rank * mesh.size(i) + \
            mesh.get_local_rank(i)
    return n, rank


def shard_batch(local: dict, mesh, batch: int, seq: int) -> dict:
    """This rank's rows as DTensors of the global ``(batch, seq)`` batch."""
    from torch.distributed.tensor import DTensor
    pl = placements(("batch", None), (batch, seq))
    return {k: DTensor.from_local(t, mesh, pl, shape=torch.Size((batch, seq)),
                                  stride=(seq, 1))
            for k, t in local.items()}


def train(cfg: ModelConfig, hyper: Hyper, *, steps: int, batch: int, seq: int,
          ckpt_dir: str, ckpt_every: int = 50, seed: int = 0,
          fail_at_step: int | None = None, compressor=None,
          microbatches: int = 1, log_every: int = 10,
          watchdog_factor: float = 1.5, telemetry=None, verbose: bool = True,
          device=None):
    """Run (or resume) training on ``device`` (``None``: CUDA). Returns
    (final TrainState, history dict): per step ``loss``, ``grad_norm`` and
    ``step_time`` (s), ``flagged_steps``, and ``final_save_s``, the time of
    the final blocking checkpoint.

    Contract: every step runs under ``deterministic_algorithms``, so a
    run resumed from a checkpoint reproduces the uninterrupted run bit for
    bit on one device; the process's settings are restored on return.
    The model trains from f32 masters (``init_train_state``), computing in
    ``cfg.dtype``.

    Under a mesh (``sharding.set_mesh``; every rank calls ``train``) the
    state is sharded by its logical axes (``shard_state``), each rank
    reads its data-parallel slice of the batch (``TokenPipeline(n_ranks,
    rank)``) and checkpoints are saved whole and restored onto the mesh.
    Each microbatch is sharded over the data ranks as the batch is
    (``step.split_microbatches``), and the compressor's error feedback is
    made after the state is sharded, on the parameters' placements."""
    dev = resolve_device(device)
    mesh = get_mesh()
    n_ranks, rank = (1, 0) if mesh is None else _data_rank(mesh, batch, seq)
    pipeline = TokenPipeline(cfg.vocab, batch, seq, seed=seed,
                             n_ranks=n_ranks, rank=rank)
    mgr = CheckpointManager(ckpt_dir)

    err_holder = {"err": None}
    hook = None if compressor is None else \
        make_compressing_hook(compressor, err_holder)
    step_fn = make_train_step(cfg, hyper, microbatches=microbatches,
                              compressor=hook)

    state = init_train_state(cfg, torch.Generator(dev).manual_seed(seed), dev)
    if mesh is not None:
        state = shard_state(state)
    if compressor is not None:
        err_holder["err"] = compressor.init(state.params)
    start, restored = mgr.restore(
        state, device=dev,
        placements=None if mesh is None else model_placements(state.params))
    if restored is not None:
        state = restored
        if verbose:
            print(f"[loop] resumed from step {start}")
    start_step = int(state.step)

    stop = {"now": False}

    def on_sigterm(signum, frame):
        stop["now"] = True

    old_handler = signal.signal(signal.SIGTERM, on_sigterm)
    history = {"loss": [], "grad_norm": [], "step_time": [],
               "flagged_steps": []}
    times: list[float] = []
    try:
        with deterministic_algorithms():
            for step in range(start_step, steps):
                if fail_at_step is not None and step == fail_at_step:
                    raise InjectedFailure(f"injected failure at step {step}")
                t0 = time.perf_counter()
                batch_arrays = {k: torch.from_numpy(v).to(dev) for k, v in
                                pipeline.host_slice(step).items()}
                if mesh is not None:
                    batch_arrays = shard_batch(batch_arrays, mesh, batch,
                                                 seq)
                state, metrics = step_fn(state, batch_arrays)
                loss = float(metrics["loss"])
                grad_norm = float(metrics["grad_norm"])
                dt = time.perf_counter() - t0
                times.append(dt)
                history["loss"].append(loss)
                history["grad_norm"].append(grad_norm)
                history["step_time"].append(dt)
                if telemetry is not None:
                    telemetry.record(step=step, loss=loss,
                                     grad_norm=grad_norm, step_time=dt,
                                     host="host0")
                # straggler watchdog on the trailing window
                if len(times) >= 20:
                    p99 = float(np.quantile(times[-200:], 0.99))
                    if dt > watchdog_factor * p99:
                        history["flagged_steps"].append(step)
                        if verbose:
                            print(f"[watchdog] step {step} took {dt:.3f}s "
                                  f"(> {watchdog_factor:.1f} x p99 "
                                  f"{p99:.3f}s) — hot-spare swap would "
                                  "trigger here")
                if verbose and step % log_every == 0:
                    print(f"[loop] step {step} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)")
                if (step + 1) % ckpt_every == 0 or stop["now"]:
                    mgr.save(int(state.step), state)
                if stop["now"]:
                    if verbose:
                        print("[loop] SIGTERM: checkpointed and exiting")
                    break
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        mgr.wait()
    t0 = time.perf_counter()
    mgr.save(int(state.step), state, blocking=True)
    history["final_save_s"] = time.perf_counter() - t0
    return state, history
