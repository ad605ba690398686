"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes with fake tensors and record per-device memory, cost
and collective statistics.

    PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \
        --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --debug-mesh  # (2,2)/(2,2,2)

The port of ``src/repro/launch/dryrun.py``. Each cell runs in this one
process under a fake process group of the mesh's size
(``init_process_group("fake")``, rank 0): parameters, optimizer state,
batch and caches are DTensors with the placements of their logical axes
(``sharding.placements``), their local shards fake tensors
(``FakeTensorMode``), so nothing is allocated and no collective moves a
byte. A train cell runs ``make_train_step``'s whole step (AdamW
included); a serve cell ``prefill`` or ``decode_step`` on bf16 weights.
``DeviceCost``, a dispatch mode under DTensor, sees rank 0's local ops:

  * ``memory_analysis``: the peak of live local storage bytes, split into
    parameters, gradients, optimizer state, activations and temporaries
    at that peak, and the argument bytes (the step's inputs);
  * ``cost_analysis``: ``flops`` of the matmuls (``torch.utils.
    flop_counter``'s formulas on local shapes) and ``bytes accessed``, the
    input and output bytes of every dispatched op but views and device
    queries (an eager program's count, not XLA's fused one);
  * ``collectives``: each ``_c10d_functional`` collective's result bytes
    and group size, with the reference's ring factors (``wire_bytes``).

Results are written as JSON under ``build/dryrun_results/`` (one file per
cell, the reference's names); ``--force`` recomputes. The roofline suite
(``repro_torch.bench.roofline``) reads them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding import rules as R
from repro_torch.train.optimizer import Hyper
from repro_torch.train.step import TrainState, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_results"

# The reference's ring model of per-device wire bytes (``parse_collectives``):
# all-gather (g-1)/g x result (the gathered tensor), all-reduce 2 (g-1)/g,
# reduce-scatter (g-1) x result (the scattered shard), all-to-all (g-1)/g,
# collective-permute 1.
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


def wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` whose result is
    ``result_bytes`` on a group of ``g`` ranks."""
    factor = {"all-gather": (g - 1) / g,
              "all-reduce": 2 * (g - 1) / g,
              "reduce-scatter": float(g - 1),
              "all-to-all": (g - 1) / g,
              "collective-permute": 1.0}[kind]
    return result_bytes * factor


def analytic_train_flops(cfg, batch: int, seq: int) -> int:
    """The matmul FLOPs of one training step of a dense attention + MLP
    ``cfg`` (all layers ``"attn"``, remat ``"nothing"``) on ``batch`` x
    ``seq`` tokens: per weight and token, forward 2, backward 4 (the tied
    logits too) and the superblocks' recompute 2, but for each block's
    last product (``w2``): the recompute stops once every tensor the
    backward needs is back (``torch.utils.checkpoint``'s early stop), and
    no backward needs that output. Attention's QK and PV run over all
    ``seq`` keys, masked or not: forward and recompute one product each,
    backward two."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    per_layer = d * (h + 2 * cfg.n_kv) * dh + h * dh * d + 3 * d * cfg.d_ff
    recompute = per_layer - d * cfg.d_ff
    tokens = batch * seq
    attention = 2 * 2 * batch * h * seq * seq * dh     # QK + PV, forward
    return (6 * tokens * cfg.n_layers * per_layer
            + 2 * tokens * cfg.n_layers * recompute
            + 6 * tokens * cfg.vocab * d
            + 4 * cfg.n_layers * attention)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class DeviceCost(TorchDispatchMode):
    """Counts rank 0's local work under DTensor: it declines ops on
    DTensors (``NotImplemented``), so DTensor lowers them to local ops and
    collectives, which it then sees. Enter it with no fake mode active
    (the shards are fake tensors made before): DTensor's shape propagation
    runs in a fake mode of its own, and its ops are skipped.

    Memory: each storage that an op creates is live from then until it is
    freed (a weak reference), labelled ``activations`` (outside the
    backward pass) or ``temporaries`` (in it, or after ``mark_gradients``);
    ``register`` labels the step's inputs; ``mark_gradients`` relabels the
    gradients. ``peak`` is the largest live total and ``at_peak`` its
    split."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = {}
        self.live: dict = {}
        self.total = 0
        self.peak = 0
        self.at_peak: dict = {}
        self._labels: dict = {}
        self._after_grads = False

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    # -- memory
    def _add(self, t, label: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._labels:
            return
        n = st.nbytes()
        self._labels[key] = (label, n)
        self.live[label] = self.live.get(label, 0) + n
        self.total += n
        weakref.finalize(st, self._free, key)
        if self.total > self.peak:
            self.peak = self.total
            self.at_peak = dict(self.live)

    def _free(self, key) -> None:
        label, n = self._labels.pop(key)
        self.live[label] -= n
        self.total -= n

    def _relabel(self, t, label: str) -> None:
        key = id(t.untyped_storage())
        if key not in self._labels:
            self._add(t, label)
            return
        old, n = self._labels[key]
        self._labels[key] = (label, n)
        self.live[old] -= n
        self.live[label] = self.live.get(label, 0) + n

    def register(self, tensors, label: str) -> int:
        """Label the local shards of ``tensors`` (created before the step;
        call it before entering the mode); returns their bytes."""
        n = 0
        for t in tensors:
            local = _local(t)
            self._add(local, label)
            n += _nbytes(local)
        return n

    def mark_gradients(self, grads, state):
        """``make_train_step``'s ``compressor`` hook: the gradients reach
        the optimizer unchanged; their storages are relabelled and what
        follows (AdamW) counts as temporaries."""
        for g in grads.values():
            self._relabel(_local(g), "gradients")
        self._after_grads = True
        return grads, state

    # -- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        waiting = packet is torch.ops._c10d_functional.wait_tensor
        wrapping = packet.__name__ == "_wrap_tensor_autograd"
        if (waiting or wrapping) and isinstance(args[0], FakeTensor):
            # Eager waits return their input, and eager wraps of a
            # collective's result (``_wrap_tensor_autograd``, on some
            # releases) hold it; their fake kernels make a new tensor.
            return args[0]
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out  # DTensor's shape propagation, not the rank's work
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _KINDS.get(packet.__name__) \
            if packet.__module__ == "torch._ops._c10d_functional" else None
        if kind is not None:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            g = _resolve_process_group(args[-1]).size()
            size = sum(_nbytes(t) for t in outs)
            rec = self.collectives.setdefault(
                kind, {"count": 0, "result_bytes": 0,
                       "wire_bytes_per_device": 0.0})
            rec["count"] += 1
            rec["result_bytes"] += size
            rec["wire_bytes_per_device"] += wire_bytes(kind, size, g)
        elif not func.is_view and not waiting and \
                packet is not torch.ops.prim.device:
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        graph = torch._C._current_graph_task_id() != -1
        label = "temporaries" if graph or self._after_grads \
            else "activations"
        for t in outs:
            self._add(t, label)
        return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _dtensor(meta, axes, mesh, dtype=None):
    """An uninitialised DTensor of ``meta``'s shape (and ``dtype``, default
    ``meta``'s) with the placements of ``axes``; its local shard is
    allocated in the active mode (fake in the dry run)."""
    from torch.distributed.tensor import empty
    return empty(*meta.shape, dtype=dtype or meta.dtype, device_mesh=mesh,
                 placements=R.placements(axes, meta.shape))


def _sharded_model(cfg, mesh, param_dtype, serve: bool):
    """``Model(cfg)`` with every parameter a DTensor of its axes'
    placements; a serving model's floating parameters are all bf16 (the
    reference's ``_serve_dtype``)."""
    model = M.Model(cfg, device="meta", param_dtype=param_dtype)
    axes = M.model_param_axes(model)
    if serve:
        model.requires_grad_(False)
    M.replace_parameters(model, lambda name, p: _dtensor(
        p, axes[name], mesh, dtype=torch.bfloat16 if serve else p.dtype))
    return model


# Optimization variants: config overrides, train-step kwargs and rule
# overrides. A variant cost pass (--cost --variant NAME) produces
# {arch}__{shape}__single_pod_cost__{NAME}.json beside the baseline's.
VARIANTS = {
    "cast_bf16": {"step_kwargs": {"cast_bf16": True}},
    "moe_sort": {"cfg": {"moe_impl": "sort"}},
    "ssm_mem": {"cfg": {"ssm_chunk": 128, "ssm_bf16_intra": True}},
    # residual stream sharded over SEQ instead of D
    "seq_sp": {"rules": {"resid_seq": ("model",), "resid_embed": ()}},
    # bf16 RMSNorm with f32 accumulation
    "bf16_norm": {"cfg": {"norm_upcast": False}},
    # replicate the residual at block ENTRY
    "zero_r": {"rules": {"blk_in_embed": ()}},
    # zero_r + bf16 norm
    "zero_r_bf16": {"rules": {"blk_in_embed": ()},
                    "cfg": {"norm_upcast": False}},
    # save matmul outputs under remat
    "remat_dots": {"cfg": {"remat_policy": "dots"}},
    # save only the named per-block outputs
    "remat_names": {"cfg": {"remat_policy": "blk_out"}},
    "combo": {"step_kwargs": {"cast_bf16": True},
              "cfg": {"moe_impl": "sort", "ssm_chunk": 128,
                      "ssm_bf16_intra": True},
              "rules": {"resid_seq": ("model",), "resid_embed": ()}},
}


def arch_rules(cfg, model_size: int) -> dict:
    rules = dict(R.LOGICAL_RULES)
    heads_ok = cfg.heads_shardable and cfg.n_heads % model_size == 0
    kv_ok = cfg.n_kv > 0 and cfg.n_kv % model_size == 0
    rules["heads"] = ("model",) if heads_ok else ()
    # KV cache: shard heads when they divide the tensor axis; otherwise fall
    # back to sequence-sharded KV (distributed-softmax decode).
    rules["kv_heads"] = ("model",) if kv_ok else ()
    rules["kv_seq"] = () if kv_ok else ("model",)
    return rules


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0) for
    the block; it must be the process's only group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _config(arch, variant, n_layers, unrolled):
    cfg = get_config(arch)
    step_kwargs = {}
    if variant:
        spec = VARIANTS[variant]
        if spec.get("cfg"):
            cfg = dataclasses.replace(cfg, **spec["cfg"])
        step_kwargs = dict(spec.get("step_kwargs", {}))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if unrolled:
        cfg = dataclasses.replace(cfg, force_unroll=True)
    return cfg, step_kwargs


def trace_cell(cfg, info: dict, mesh, rules: dict, step_kwargs=None) -> dict:
    """Trace one cell of ``cfg`` at ``info`` (a ``S.SHAPES`` entry: kind,
    seq, batch) on ``mesh`` under ``rules``; returns the memory, cost and
    collective record. The inputs are DTensors with fake shards; plain
    tensors that the step itself makes (positions, masks) are real and
    small, and meet the fake ones as constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    R.set_mesh(mesh, rules)
    cost = DeviceCost()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            if info["kind"] == "train":
                model = _sharded_model(cfg, mesh, torch.float32, serve=False)
                params = dict(model.named_parameters())
                opt = {k: {n: _like(p) for n, p in params.items()}
                       for k in ("mu", "nu")}
                batch = {k: _dtensor(meta, ax, mesh) for k, (meta, ax) in
                         S.batch_specs(cfg, info["batch"],
                                       info["seq"]).items()}
                inputs = {"parameters": params.values(),
                          "optimizer_state": [t for k in opt
                                              for t in opt[k].values()],
                          "activations": batch.values()}
            else:
                model = _sharded_model(cfg, mesh, None, serve=True)
                cache_meta, axes = S.cache_specs(cfg, info["batch"],
                                                 info["seq"])
                cache = M.Cache([{k: _dtensor(t, ax[k], mesh)
                                  for k, t in layer.items()}
                                 for layer, ax in zip(cache_meta.layers,
                                                      axes)])
                if info["kind"] == "prefill":
                    meta, ax = S.prompt_specs(cfg, info["batch"],
                                              info["seq"])
                else:
                    meta, ax = S.token_specs(cfg, info["batch"])
                tok = _dtensor(meta, ax, mesh)
                inputs = {"parameters": model.parameters(),
                          "activations": [tok] + [t for layer in cache.layers
                                                  for t in layer.values()]}
        args = sum(cost.register(ts, label) for label, ts in inputs.items())
        with cost:
            if info["kind"] == "train":
                step = make_train_step(cfg, Hyper(), **(step_kwargs or {}),
                                       compressor=cost.mark_gradients)
                step(TrainState(params=model, opt=opt, step=0), batch)
            else:
                fn = M.prefill if info["kind"] == "prefill" \
                    else M.decode_step
                fn(model, tok, cache)
    finally:
        R.set_mesh(None)
    mem = {k: int(cost.at_peak.get(k, 0)) for k in
           ("parameters", "gradients", "optimizer_state", "activations",
            "temporaries")}
    mem.update(peak_bytes=int(cost.peak), argument_size_in_bytes=int(args),
               temp_size_in_bytes=int(cost.peak - args))
    return {"memory_analysis": mem,
            "cost_analysis": {"flops": float(cost.flops),
                              "bytes accessed": float(cost.bytes)},
            "collectives": cost.collectives}


def _like(p):
    """A DTensor of ``p``'s shape, dtype and placements."""
    from torch.distributed.tensor import empty
    return empty(*p.shape, dtype=p.dtype, device_mesh=p.device_mesh,
                 placements=p.placements)


def run_cell(arch: str, shape: str, multi_pod: bool, debug_mesh: bool = False,
             unrolled: bool = False, n_layers: int | None = None,
             variant: str | None = None) -> dict:
    """One cell's record (``ok: false`` with its error when it fails)."""
    t0 = time.time()
    result = {"arch": arch, "shape": shape, "unrolled": unrolled,
              "n_layers": n_layers, "variant": variant,
              "mesh": "multi_pod" if multi_pod else "single_pod"}
    try:
        cfg, step_kwargs = _config(arch, variant, n_layers, unrolled)
        ok, why = S.shape_supported(cfg, shape)
        if not ok:
            result.update(skipped=True, reason=why)
            return result
        mesh_shape = ((2, 2, 2) if multi_pod else (2, 2)) if debug_mesh \
            else ((2, 16, 16) if multi_pod else (16, 16))
        n_dev = 1
        for n in mesh_shape:
            n_dev *= n
        with fake_world(n_dev):
            mesh = (make_debug_mesh if debug_mesh else make_production_mesh)(
                multi_pod=multi_pod)
            rules = arch_rules(cfg, mesh.size(mesh.mesh_dim_names.index(
                "model")))
            if variant and VARIANTS[variant].get("rules"):
                rules.update(VARIANTS[variant]["rules"])
            result.update(mesh=list(mesh_shape), n_devices=n_dev)
            t1 = time.time()
            result.update(trace_cell(cfg, S.SHAPES[shape], mesh, rules,
                                     step_kwargs))
            result["trace_s"] = time.time() - t1
        result["ok"] = True
    except Exception as exc:  # noqa: BLE001 — a failed cell is a result
        result["ok"] = False
        result["error"] = f"{type(exc).__name__}: {exc}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["total_s"] = time.time() - t0
    return result


def cell_path(arch: str, shape: str, mesh_name: str) -> str:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    return str(RESULTS_DIR / f"{arch}__{shape}__{mesh_name}.json")


def _combine_costs(full: dict, u1: dict, u2: dict, n_super: int) -> dict:
    """true = full + (n_super - 1) * (U2 - U1), per metric, where ``full``
    carries exactly ONE superblock of the repeated group (see
    ``run_cost_cell``) and two shallow variants measure the marginal cost
    of one more superblock (flops, bytes, collectives)."""
    out = {"method": "U1/U2 extrapolation", "n_super": n_super}
    scale = n_super - 1

    def delta(key):
        a = u2.get("cost_analysis", {}).get(key, 0.0)
        b = u1.get("cost_analysis", {}).get(key, 0.0)
        return max(a - b, 0.0)

    cost = {}
    for key in ("flops", "bytes accessed"):
        base = full.get("cost_analysis", {}).get(key, 0.0)
        cost[key] = base + scale * delta(key)
    out["cost_analysis"] = cost

    coll = {}
    kinds = set(full.get("collectives", {})) | set(u1.get("collectives", {})) \
        | set(u2.get("collectives", {}))
    for kind in kinds:
        f = full.get("collectives", {}).get(kind, {})
        a = u1.get("collectives", {}).get(kind, {})
        b = u2.get("collectives", {}).get(kind, {})
        dw = max(b.get("wire_bytes_per_device", 0.0)
                 - a.get("wire_bytes_per_device", 0.0), 0.0)
        dc = max(b.get("count", 0) - a.get("count", 0), 0)
        coll[kind] = {
            "count": f.get("count", 0) + scale * dc,
            "wire_bytes_per_device": (f.get("wire_bytes_per_device", 0.0)
                                      + scale * dw),
        }
    out["collectives"] = coll
    out["n_devices"] = full.get("n_devices")
    out["memory_analysis"] = full.get("memory_analysis")
    out["u1_trace_s"] = u1.get("trace_s")
    out["u2_trace_s"] = u2.get("trace_s")
    out["ok"] = full.get("ok", False) and u1.get("ok", False) \
        and u2.get("ok", False)
    for src, name in ((u1, "u1"), (u2, "u2")):
        if not src.get("ok"):
            out[f"{name}_error"] = src.get("error")
    return out


def run_cost_cell(arch: str, shape: str, debug_mesh: bool = False,
                  variant: str | None = None) -> dict:
    """Cost record for one single-pod cell by U1/U2 extrapolation.

    The reference's full (scan) program counts its scanned superblock
    once. The port traces every layer, so its full-depth count is exact
    already; the program that counts like the reference's is the config
    with the repeated group cut to one repeat (``one``), and the
    extrapolation from it must give the full-depth count back (a test
    holds them equal). Memory comes from the full-depth cell."""
    cfg = get_config(arch)
    ok, why = S.shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": True, "reason": why}
    base = 1 if cfg.first_dense else 0
    pat = len(cfg.block_pattern)
    groups = cfg.layer_groups()
    n_super = max(rep for _, rep in groups)
    full_path = cell_path(arch, shape, "single_pod")
    if variant is None and os.path.exists(full_path):
        with open(full_path) as fh:
            full = json.load(fh)
    else:
        full = run_cell(arch, shape, False, debug_mesh=debug_mesh,
                        variant=variant)
    one = run_cell(arch, shape, False, debug_mesh=debug_mesh, unrolled=True,
                   n_layers=cfg.n_layers - (n_super - 1) * pat,
                   variant=variant)
    u1 = run_cell(arch, shape, False, debug_mesh=debug_mesh, unrolled=True,
                  n_layers=base + pat, variant=variant)
    u2 = run_cell(arch, shape, False, debug_mesh=debug_mesh, unrolled=True,
                  n_layers=base + 2 * pat, variant=variant)
    out = _combine_costs(dict(full, cost_analysis=one.get("cost_analysis"),
                              collectives=one.get("collectives"),
                              ok=full.get("ok") and one.get("ok")),
                         u1, u2, n_super)
    out.update({"arch": arch, "shape": shape, "mesh": "single_pod",
                "variant": variant})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(S.SHAPES),
                    help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the 2-pod mesh (default: both meshes)")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the single-pod mesh")
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unrolled", action="store_true",
                    help="set force_unroll (the port's layers are unrolled "
                         "already; the cells are written under "
                         "*_unrolled names)")
    ap.add_argument("--cost", action="store_true",
                    help="U1/U2 cost-extrapolation pass (single-pod)")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS),
                    help="apply an optimization variant (with --cost)")
    args = ap.parse_args(argv)

    if args.cost:
        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else list(S.SHAPES)
        suffix = "single_pod_cost" + (f"__{args.variant}" if args.variant
                                      else "")
        n_fail = 0
        for arch in archs:
            for shape in shapes:
                path = cell_path(arch, shape, suffix)
                if os.path.exists(path) and not args.force:
                    with open(path) as fh:
                        prev = json.load(fh)
                    if prev.get("ok") or prev.get("skipped"):
                        print(f"[cached] cost {arch} {shape}")
                        continue
                res = run_cost_cell(arch, shape, debug_mesh=args.debug_mesh,
                                    variant=args.variant)
                with open(path, "w") as fh:
                    json.dump(res, fh, indent=1)
                if res.get("skipped"):
                    print(f"[skip]   cost {arch} {shape}")
                elif res.get("ok"):
                    fl = res["cost_analysis"]["flops"]
                    print(f"[ok]     cost {arch} {shape} flops/dev={fl:.3g}")
                else:
                    n_fail += 1
                    print(f"[FAIL]   cost {arch} {shape}: "
                          f"{res.get('u1_error') or res.get('u2_error')}")
        return 1 if n_fail else 0

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(S.SHAPES)
    meshes = []
    if not args.multi_pod:
        meshes.append(("single_pod", False))
    if not args.single_pod:
        meshes.append(("multi_pod", True))

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name, mp in meshes:
                suffix = mesh_name + ("_unrolled" if args.unrolled else "")
                path = cell_path(arch, shape, suffix)
                if os.path.exists(path) and not args.force:
                    with open(path) as fh:
                        prev = json.load(fh)
                    if prev.get("ok") or prev.get("skipped"):
                        print(f"[cached] {arch} {shape} {mesh_name}")
                        n_ok += prev.get("ok", False)
                        n_skip += prev.get("skipped", False)
                        continue
                res = run_cell(arch, shape, mp, debug_mesh=args.debug_mesh,
                               unrolled=args.unrolled)
                with open(path, "w") as fh:
                    json.dump(res, fh, indent=1)
                if res.get("skipped"):
                    n_skip += 1
                    print(f"[skip]   {arch} {shape} {mesh_name}: "
                          f"{res['reason'][:60]}")
                elif res.get("ok"):
                    n_ok += 1
                    fl = res["cost_analysis"]["flops"]
                    print(f"[ok]     {arch} {shape} {mesh_name} "
                          f"trace={res['trace_s']:.1f}s flops={fl:.3g}")
                else:
                    n_fail += 1
                    print(f"[FAIL]   {arch} {shape} {mesh_name}: "
                          f"{res['error'][:200]}")
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
