"""Train step: loss -> grads -> AdamW, with optional microbatch accumulation
and optional gradient compression (``repro_torch.train.grad_compress``).

The port of ``src/repro/train/step.py``. Gradients come from autograd on
``models.model.loss_fn`` (the model rematerialises each superblock in the
backward pass under its ``remat_policy``); microbatches run one after
another, their f32 gradients summed and divided once, as the reference's
``lax.scan`` does (under a mesh each microbatch is sharded over the data
ranks, and the sums are DTensors on the parameters' placements). The
step updates the state's model and moments in place and returns the
state with its step advanced.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.models.model import (Model, ModelConfig, init_params,
                                      loss_fn, model_placements,
                                      replace_parameters)
from repro_torch.sharding import (get_mesh, logical_to_spec, placements,
                                 replicate_plain)
from repro_torch.train.optimizer import (Hyper, adamw_init, adamw_update,
                                         decayed)


class TrainState(NamedTuple):
    params: Model     # f32 master weights
    opt: dict         # {"mu": {name: tensor}, "nu": {...}}
    step: int


def init_train_state(cfg: ModelConfig, generator=None,
                     device=None) -> TrainState:
    """A fresh state on ``device`` (``None``: CUDA): the model's f32
    masters drawn from ``generator`` (``init_params``), zero moments."""
    model = init_params(cfg, generator, device, param_dtype=torch.float32)
    return TrainState(params=model, opt=adamw_init(model), step=0)


def shard_state(state: TrainState) -> TrainState:
    """``state``, the same on every rank (drawn from one seed), with its
    parameters and moments made DTensors of their logical axes' placements
    on the installed mesh (``model_placements``); each rank keeps its own
    shards, with no communication. The model is changed in place."""
    from torch.distributed.tensor import distribute_tensor
    mesh = get_mesh()
    model = state.params
    placements = model_placements(model)

    def shard(name, t):
        return distribute_tensor(t.detach(), mesh, placements[name],
                                 src_data_rank=None)
    replace_parameters(model, shard)
    opt = {k: {n: shard(n, t) for n, t in moments.items()}
           for k, moments in state.opt.items()}
    return TrainState(params=model, opt=opt, step=state.step)


@contextlib.contextmanager
def _bf16_weights(model: Model):
    """Within the block, every parameter of a reference leaf of rank 2 or
    more (all but ``ln_f``) reads as one bf16 cast of its f32 master: its
    module's parameter slot holds the cast tensor, the same at every use,
    in the forward and in the backward's recomputation alike, so
    gradients reach the master through one cast. The masters go back into
    their slots on exit, in place and in order."""
    swapped = []
    for name in sorted(decayed(model.cfg)):
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        master = module._parameters[attr]
        module._parameters[attr] = master.to(torch.bfloat16)
        swapped.append((module, attr, master))
    try:
        yield
    finally:
        for module, attr, master in swapped:
            module._parameters[attr] = master


def loss_and_grads(model: Model, batch: dict, cast_bf16: bool = False):
    """(loss, ``{name: f32 gradient}``) of ``loss_fn`` on ``batch``. With
    ``cast_bf16`` the loss sees the f32 masters of every reference leaf of
    rank 2 or more cast to bf16 once, as the reference casts the
    ``p.ndim >= 2`` leaves of its stacked tree before the layer stack.

    Under a mesh (``sharding.set_mesh``; parameters and batch DTensors)
    every rank must call it: each gradient is redistributed to its
    parameter's placements (autograd leaves it ``Partial`` where the
    batch is sharded) and the loss is returned whole."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    with replicate_plain(), \
            _bf16_weights(model) if cast_bf16 else contextlib.nullcontext():
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
    if get_mesh() is not None:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for p, g in zip(params, grads)]
        loss = loss.full_tensor()
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def split_microbatches(batch: dict, k: int) -> list:
    """``batch`` cut into ``k`` microbatches of consecutive rows, as the
    reference's reshape to ``(k, B / k, ...)`` cuts it: microbatch i holds
    the global rows ``[i B / k, (i + 1) B / k)``. Under a mesh (DTensor
    batches) each microbatch is sharded on the ``batch`` axis over the
    data ranks, as the whole batch is (``loop.shard_batch``): every rank
    gathers the batch (token ids, 4 bytes a position) and keeps its own
    rows of each microbatch. Raises unless ``k`` times the data ranks
    divide the batch."""
    first = next(iter(batch.values()))
    b, mesh = first.shape[0], get_mesh()
    dtensors = mesh is not None and hasattr(first, "placements")
    n = 1
    for axis in logical_to_spec(("batch",))[0] if dtensors else ():
        n *= mesh.size(mesh.mesh_dim_names.index(axis))
    if b % (k * n):
        raise ValueError(f"a batch of {b} rows does not split into {k} "
                         f"microbatches over {n} data ranks ({b} is not a "
                         f"multiple of {k} x {n})")
    rows = b // k
    if not dtensors:
        return [{key: v[i * rows:(i + 1) * rows] for key, v in batch.items()}
                for i in range(k)]
    from torch.distributed.tensor import distribute_tensor
    whole = {key: v.full_tensor() for key, v in batch.items()}
    return [{key: distribute_tensor(
                v[i * rows:(i + 1) * rows], mesh,
                placements(("batch",) + (None,) * (v.ndim - 1),
                           (rows,) + tuple(v.shape[1:])),
                src_data_rank=None)
             for key, v in whole.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, hyper: Hyper, microbatches: int = 1,
                    compressor=None, cast_bf16: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the state's device.

    cast_bf16: cast the f32 master weights to bf16 before the layer stack
    (``loss_and_grads``), halving what a sharded step would gather.
    compressor: ``hook(grads, state) -> (grads, state)`` applied to the
    accumulated gradients before the optimizer.
    """

    def train_step(state: TrainState, batch: dict):
        model = state.params
        if microbatches == 1:
            loss, grads = loss_and_grads(model, batch, cast_bf16)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(model.parameters()).device)
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in model.named_parameters()}
            for mb in split_microbatches(batch, microbatches):
                mb_loss, g = loss_and_grads(model, mb, cast_bf16)
                torch._foreach_add_(list(grads.values()),
                                    [g[n] for n in grads])
                loss = loss + mb_loss
            loss = loss / microbatches
            torch._foreach_div_(list(grads.values()), microbatches)
        if compressor is not None:
            grads, state = compressor(grads, state)
        model, opt, metrics = adamw_update(model, grads, state.opt,
                                           state.step, hyper)
        metrics["loss"] = loss
        return TrainState(params=model, opt=opt, step=state.step + 1), \
            metrics

    return train_step
