"""GD-inspired gradient compression with error feedback.

The port of ``src/repro/train/grad_compress.py``. Each step the gradient
is split into a quantized base grid (what the optimizer consumes) and a
deviation that enters an error-feedback accumulator and reappears on later
steps (cf. EF-SGD; held by ``tests/test_torch_train.py::
test_grad_compression_error_feedback_converges``). Two codecs:

  * ``GDQuantizer`` — one scale a leaf + an int8 base grid (the "base
    bits"), error feedback carries the deviation;
  * ``TopKCompressor`` — classical sparsification baseline.

Both work per leaf of the reference's parameter tree, where a layer
group's leaf stacks that parameter of every repeat: ``GDQuantizer``'s
scale is ``max|g|`` over all the group's ``wq`` at once, and
``TopKCompressor``'s ``k`` and threshold are taken over them together
(``convert.reference_leaves``). ``init(model)`` binds a codec to the
model's leaves. As in the reference, this is the algorithmic half
(quantization and error feedback); no collective moves the int8 grid.
Under a mesh the gradients and the error feedback are DTensors on the
parameters' placements; only the leaf-wide scale and threshold are
reduced over the mesh, and the result is the single process's bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.models.convert import reference_leaves


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _all_reduce(t, op: str, mesh):
    """``t`` (a plain tensor, the same shape on every rank) reduced in
    place by ``op`` (``"sum"`` or ``"max"``) over every rank of ``mesh``,
    one mesh dim after another."""
    import torch.distributed as dist
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    for i in range(mesh.ndim):
        dist.all_reduce(t, op=red, group=mesh.get_group(i))
    return t


class _Codec:
    def init(self, model) -> dict:
        """Zero f32 error feedback beside ``model``'s parameters, on their
        placements under a mesh (each rank holds its own shards); binds
        the codec to the model's reference leaves."""
        self._leaves = reference_leaves(model.cfg)
        return {name: torch.zeros_like(p, dtype=torch.float32)
                for name, p in model.named_parameters()}

    def compress(self, grads: dict, err: dict):
        """Returns (decompressed grads as seen by the optimizer, new error),
        both ``{name: tensor}``. Under a mesh (DTensor gradients and error
        on the parameters' placements) each rank codes its own shards; the
        leaf-wide scale or threshold (``_keep``) is the whole leaf's, so
        the result is the single process's bit for bit."""
        from torch.distributed.tensor import DTensor
        leaves = [[grads[n].float() + err[n] for n in leaf.names]
                  for leaf in self._leaves]
        mesh = getattr(leaves[0][0], "device_mesh", None)
        kept = self._keep([[_local(g) for g in gs] for gs in leaves],
                          leaves, mesh)
        out, new_err = {}, {}
        for leaf, gs, ks in zip(self._leaves, leaves, kept):
            for name, g, k in zip(leaf.names, gs, ks):
                if mesh is not None:
                    k = DTensor.from_local(k, mesh, g.placements,
                                           shape=g.shape, stride=g.stride(),
                                           run_check=False)
                out[name], new_err[name] = k, g - k
        return out, new_err


class GDQuantizer(_Codec):
    """int8 base / error-feedback deviation gradient codec. Under a mesh
    the leaves' ``max|g|`` are all-reduced once a step (one f32 a leaf)."""

    def __init__(self, bits: int = 8):
        if bits not in (4, 8):
            raise ValueError("bits must be 4 or 8")
        self.bits = bits
        self.levels = 2 ** (bits - 1) - 1

    def _keep(self, leaves: list, whole: list, mesh) -> list:
        """Per leaf (this rank's shards ``leaves``), the base grid of every
        tensor on the leaf's scale."""
        amax = torch.stack([torch.stack([torch.max(torch.abs(g))
                                         for g in gs]).max()
                            for gs in leaves])
        if mesh is not None:
            amax = _all_reduce(amax, "max", mesh)
        out = []
        for gs, a in zip(leaves, amax):
            scale = torch.clamp(a, min=1e-12) / self.levels
            out.append([torch.clamp(torch.round(g / scale), -self.levels,
                                    self.levels).to(torch.int8).float()
                        * scale for g in gs])   # "base" part, transmitted
        return out


class TopKCompressor(_Codec):
    """Keep the top-k fraction of entries per leaf; error-feedback rest.

    The threshold is the leaf's exact k-th largest ``|g|``, ties kept by
    ``>=``. Under a mesh no shard leaves its rank: a radix select on the
    f32 bit patterns of ``|g|`` (``_kth_largest_abs``) costs each rank 31
    passes over its shards and 31 rounds of all-reduce (one a mesh dim)
    of a vector of one int64 count a leaf, a step."""

    def __init__(self, frac: float = 0.1):
        self.frac = frac

    def _keep(self, leaves: list, whole: list, mesh) -> list:
        ks = [max(1, int(sum(g.numel() for g in gs) * self.frac))
              for gs in whole]
        if mesh is None:
            thresh = [torch.topk(torch.cat([torch.abs(g).reshape(-1)
                                            for g in gs]), k).values[-1]
                      for gs, k in zip(leaves, ks)]
        else:
            thresh = _kth_largest_abs(leaves, whole, ks, mesh)
        return [[torch.where(torch.abs(g) >= t, g, 0.0) for g in gs]
                for gs, t in zip(leaves, thresh)]


def _kth_largest_abs(leaves: list, whole: list, ks: list, mesh):
    """Per leaf, the ``ks``-th largest ``|g|`` over the leaf's tensors,
    sharded over ``mesh`` (``leaves``: this rank's shards; ``whole``: the
    DTensors, for their placements), exactly: the f32 values of ``|g|``
    order as their int32 bit patterns, so the largest pattern ``t`` with
    at least k elements ``>= t`` is found bit by bit from the top, each
    bit one count over the shards, summed over the mesh. An element
    replicated over a mesh dim is counted on that dim's rank 0 only."""
    dev = leaves[0][0].device
    bits = [[torch.abs(g).view(torch.int32) for g in gs] for gs in leaves]
    own = [[all(pl.is_shard() or mesh.get_local_rank(i) == 0
                for i, pl in enumerate(g.placements)) for g in gs]
           for gs in whole]
    k = torch.tensor(ks, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    found = torch.zeros(len(ks), dtype=torch.int32, device=dev)
    for bit in range(30, -1, -1):
        cand = found | (1 << bit)
        counts = torch.stack([
            sum(((b >= c).sum() for b, o in zip(bs, os_) if o), zero)
            for bs, os_, c in zip(bits, own, cand)])
        counts = _all_reduce(counts, "sum", mesh)
        found = torch.where(counts >= k, cand, found)
    return found.view(torch.float32)


def make_compressing_hook(codec, err_state_holder: dict):
    """Adapter for ``make_train_step(compressor=...)``: the error-feedback
    state lives outside ``TrainState`` in ``err_state_holder["err"]``, so
    the hook takes and returns the state explicitly."""
    def hook(grads, state):
        err = err_state_holder["err"]
        new_grads, new_err = codec.compress(grads, err)
        err_state_holder["err"] = new_err
        return new_grads, state
    return hook
