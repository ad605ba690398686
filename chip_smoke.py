#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

``--profile`` traces the main and serve phases' runs with ``torch.profiler``
(device busy time and idle share per span).

Phases, each printing one JSON line:

  1. device  — the card's name and power limit (``nvidia-smi``);
  2. build   — compile every CUDA kernel of the port from
               ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source,
               all started together);
  3. kernels — hold each kernel against its plain PyTorch version on the
               card at the main path's shapes (K3/K4 on the inputs of the
               first 2-D refinement round of one ingest of the main table,
               recorded outside the main run, and on uniform and sorted
               skewed inputs at k2 = 64, 128, 256; the single histogram,
               K5, at 100,000 and 10,000,000 rows into 256 x 256 bins, at
               its one-slab, many-slab and more-than-8-slab shapes and on
               one row, with its device operations per call; K1/K2 at the
               build caps) and time kernel, plain version and one PyTorch
               library call;
  4. main    — ingest the 500,000-row ``flights`` table with the paper's
               defaults (N_s = 100,000, alpha = 0.001, M = 1%), answer 256
               generated queries one at a time and one 64-query serving wave
               through ``FastPath.batch``, check every answer against the
               host-NumPy engine and count the kernel launches of this run;
               then K1/K2 once more on the wave's own stacks;
  5. serve   — the main phase's framework behind ``AQPServer(mode="cuda")``:
               the 256 queries through ``submit`` from 8 client threads
               (their shapes rarely meet in one admission window, so they
               run as singles through K2) and the 64-query wave through
               ``query_batch`` (one fused group through K1), every answer
               held against an ``AQPServer(mode="numpy")`` on a synopsis
               built from the same compressed table (rtol 1e-5, atol 1e-6),
               with each server's per-single execution time from its own
               trace spans; then the synopsis encoded (``storage.encode``),
               registered as a cold table and the 256 queries answered again
               from it in ``"numpy"`` mode (rtol 1e-9 against the warm
               answers);
  6. schedulers — rebuild the main table on the card (from the main
               phase's compressed table, the paper's defaults) with the
               per-pair loop (``pair_batched=False``), the compacting
               scheduler's oracle, and require its synopsis to equal the
               main phase's compacting one field by field; then build two
               more tables with both schedulers and the same equality: a
               correlated one (the construction bench's
               ``_correlated_data`` at 60,000 rows x 8 columns, drawn from
               seed 3, so not the bench's own table; it reaches the
               k2 = 128 rung) and one of 100,000 rows whose pairs start at
               k2 = 64 and some of which must escalate to 128
               (``escalation_data``); each build's ``pair_phase_s``, its
               split into timeline intervals (column upload, presort,
               launches, metadata), capacity rungs and K3/K4 launches are
               printed; then K3/K4 are held against their plain versions
               on the first inputs of each shape that the compacting
               builds launched;
  7. parity  — build a 60,000-row ``flights`` synopsis on the card and on
               the CPU and require them equal field by field;
  8. sharded — two ``gloo`` ranks in two processes on the one card bin the
               two halves of 10,000,000 rows with ``hist2d_sharded``; rank 0
               requires the all-reduced counts to equal the plain version
               on the whole input exactly;
  9. bench   — ``repro_torch.bench.kernels.run`` and
               ``repro_torch.bench.construction.run(quick=True)`` on the
               card (their CSV rows print on lines of their own, their JSON
               goes to ``chiprun_out/bench/``);
 10. lm      — the LM serving path (``repro_torch.models``,
               ``serve.engine``), which launches none of the kernels above:
               qwen3-0.6b at its published width in bf16, weights from the
               port's seeded init with the MLP output projections scaled
               so that greedy decoding moves (``LM_RESID_SCALE``), serves
               8 requests (prompts of 64-192 tokens, 32 new each) over 4
               slots through ``ServeEngine(device=None)``, with tokens/s,
               the prefill and median decode-step ms, the launches and
               device time of a decode step (``torch.profiler``), the peak
               memory and the floor of reading the weights once; the same
               weights in f32 with TF32 off prefill 2 x 64 tokens on the
               card and the CPU (logits at rtol 1e-3, atol 2e-4) and
               generate 2 x 8 greedy tokens on each (tokens equal and
               moving, every step's logits at the same tolerance); the
               bf16 weights prefill the same tokens on both (logits
               within ``LM_BF16_FULL_SHARE`` of the CPU's f32-to-bf16
               distance); the 8 requests again in f32 and then in bf16
               give the f32 decode step's cost beside bf16's and the share
               of greedy tokens that bf16 and f32 agree on (no
               threshold); then each architecture's smoke config (MoE
               under both dispatches) prefills 2 x 64 inputs and decodes
               4 steps on the card and the CPU, in f32 at the same
               tolerance and in bf16 within ``LM_BF16_SHARE``;
 11. train   — the LM training path (``repro_torch.launch.train`` ->
               ``train.loop``, ``train.step``, ``train.optimizer``,
               ``ckpt.checkpoint``, ``train.telemetry``): qwen3-0.6b at
               its published width, bf16 compute from f32 masters, remat
               ``"nothing"``, the reference's command-line defaults
               (batch 8 x 128, lr 1e-3, warmup steps // 10) for 20 steps
               with telemetry on and the final blocking checkpoint in a
               temporary directory (deleted): every step's loss (the last
               5 must average below the first 5), grad norms, step ms,
               tokens/s, the launches and device time of a step, peak
               memory, ``ckpt_save_s``, ``train_floor_ms`` (8 N T FLOPs at
               989 TFLOP/s or AdamW's bytes at 3.35 TB/s) and
               ``train_mfu`` (the step's device time and launches read
               with deterministic algorithms on, as the loop runs it),
               and windows of steps with them on and off in turns; one
               step with remat off and under each policy (the
               gradient pass's peak memory must be lower under
               ``"nothing"`` than with no remat); f32 with TF32 off at
               full width cut to ``TRAIN_DEPTH`` layers, one step of 2 x
               64 on the card and the CPU from the same weights (loss,
               grad norm, each gradient and moment tensor, parameters by
               the sign rule with noise counted per tensor, and each card
               parameter against its own moments' update; ``TRAIN_*``
               tolerances); the reference test's crash-and-resume on the
               card at that depth and for the SSD's and an einsum MoE's
               smoke configs (final state ``torch.equal``); every smoke config (MoE under both
               dispatches) one f32 step card against CPU as above,
               qwen3's smoke config 30 steps with ``GDQuantizer(8)`` (the
               loss must fall by 0.2) and 4 microbatches against 1 (rtol
               2e-4, atol 2e-5); tests/test_train.py's 5,000 telemetry
               rows into a ``TelemetryStore`` on the card and one on the
               CPU (synopses equal field by field, answers and stragglers
               equal, K3/K4 launched and held against their plain versions
               on the build's first inputs of each shape);
 12. sharding — ``repro_torch.sharding``, ``launch.{mesh,specs,dryrun}``,
               ``bench.roofline``, with the train phase's step (qwen3-0.6b,
               batch 8 x 128): (a) its dry run on a one-device mesh in a
               child process (a fake process group, fake tensors), the
               predicted peak within 15% of the train phase's measured
               ``max_memory_allocated`` and the matmul FLOPs within 1% of
               ``dryrun.analytic_train_flops``; (b) one NCCL rank with a
               (data=1, model=1) mesh, the state DTensors, 3 steps against
               3 of the plain path from the same seed, parameters
               ``torch.equal``, then the same with 4 microbatches and with
               a ``GDQuantizer(8)`` gradient codec on both sides; (c)
               qwen3-0.6b's ``train_4k``, ``prefill_32k`` and
               ``decode_32k`` cells on the 256-rank mesh and
               ``decode_32k`` on the 512-rank one, one child each, then
               ``repro_torch.bench.run --only roofline``; per cell its
               per-device FLOPs, bytes, wire bytes by kind, peak bytes,
               trace seconds and dominant roofline term: ``train_4k``'s
               and the decode cells' FLOPs within 1% of the count the
               dry run reads on torch 2.13 for this tree
               (``DRYRUN_FLOPS``), every cell's FLOPs and peak no higher
               than the earlier tree's (``EARLIER_CELLS``), the decode
               cells' peaks within 1% of it, and every cell's FLOPs and
               peak within 1% of the card's reading once the
               projections' placements were stated, before the MoE's
               (``PROJECTION_CELLS``; ``train_4k``'s peak once the loss
               upcast the logits a block of rows at a time); (d) the
               MoE and the ``blk_out`` remat under a mesh: in (b) also
               deepseek-moe's smoke config with the sort dispatch and
               qwen3's with ``remat_policy="blk_out"``, each against its
               plain steps, ``torch.equal``; the per-layer tally
               (``scripts/torch_dryrun_flops.py --per-layer``) of
               dbrx-132b's and deepseek-moe-16b's ``train_4k`` on (16,
               16) under both dispatches, one child each, within 1% of
               the count torch 2.13 reads for this tree, which is the
               count of the reference's placements
               (``MOE_LAYER_FLOPS``), and deepseek-moe's with no product
               over all its E x C expert slots; and the dry run's
               ``remat_names`` (qwen3-0.6b), ``combo`` (deepseek-moe)
               and ``ssm_mem`` (mamba2) variants ``ok`` at 2 layers; the
               SSD's and the RG-LRU's projections, the router and the
               tied logits on the reference's shards: in (b) also
               mamba2's and recurrentgemma's smoke configs against their
               plain steps, ``torch.equal``; the per-layer tally of
               mamba2-1.3b's (base, ``zero_r``) and recurrentgemma-9b's
               (base, ``remat_dots``) ``train_4k`` on (16, 16), one child
               each, the layer's FLOPs and its 2-layer cell's within 1%
               of torch 2.13's reading for this tree
               (``RECURRENT_LAYER_FLOPS``), with no product over a whole
               dim that the reference splits (``RECURRENT_WHOLE``), the
               base cells' peaks at 1 and 2 layers within
               ``RECURRENT_LAYER_PEAK``; and the narrow cases of
               ``scripts/torch_narrow_sharding.py`` (the SSD, the RG-LRU,
               the router, the tied head, dbrx's MoE under both
               dispatches, qwen3's attention and MLP and gemma2's
               attention on (2, 4); mamba2's head and the attention of
               gemma2-2b, minitron-4b and musicgen-medium at full width
               on (16, 16)), each
               peak within 1.15x of the reference's (the SSD's 0.90x;
               ``NARROW_REFERENCE_PEAKS``), the ratios
               printed on a line of their own. (a) to (d) run side by
               side;
 13. lanes   — the port's smoke lanes ``scripts/torch_{trace,plan,gd,
               chaos}_smoke.py`` on the card, one child each (servers in
               ``"cuda"`` mode), each passing its own gates and launching
               its kernels (K1 from the servers' waves, K2 from single
               AND queries, K3/K4 from the GD lane's builds), with its
               wall time; then ``examples/torch_quickstart.py``;
 14. greedygd — ``GreedyGD(device="cuda")`` on the rolling month
               (494,233 rows of 31 ``flights_day`` days) and 500,000 rows
               of ``flights`` and ``power`` (``aqpbench/tables``) against
               the same code on the CPU: every ``CompressedTable`` field
               equal with its dtype and shape, each span's seconds
               (``gd_missing``, ``gd_plan``, ``gd_encode``) on both sides
               and the card's peak allocated bytes over a compress.
Then it prints the card line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
the last line. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero at once. The nvcc log goes to
``chiprun_out/chip_smoke_build.log``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
# record_function spans that ``--profile`` reports (not device work).
PROFILE_SPANS = ("main.", "serve.")

# H100 SXM peaks (NVIDIA data sheet): device memory and fp32 without tensor
# cores (the kernels keep fp32 IEEE; construction counts are fp32 adds).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The TPU kernels these CUDA kernels replace (function reaching pallas_call).
TPU_KERNELS = {
    "batched_weightings": "src/repro/kernels/weightings/weightings.py:61",
    "fused_weightings": "src/repro/kernels/weightings/weightings.py:92",
    "batched_hist2d": "src/repro/kernels/hist2d/hist2d.py:82",
    "batched_subbin_hist": "src/repro/kernels/subbin/subbin.py:52",
    "hist2d": "src/repro/kernels/hist2d/hist2d.py:42",
}
SOURCES = {
    "batched_weightings": "src/repro_torch/kernels/csrc/weightings.cu",
    "fused_weightings": "src/repro_torch/kernels/csrc/weightings.cu",
    "batched_hist2d": "src/repro_torch/kernels/csrc/flat_hist.cu",
    "batched_subbin_hist": "src/repro_torch/kernels/csrc/flat_hist.cu",
    "hist2d": "src/repro_torch/kernels/csrc/hist2d.cu",
}
# The kernels that the main phase's path (ingest, queries, wave) launches;
# K5 (``hist2d``) is launched by the sharded and bench phases.
MAIN_KERNELS = ("batched_weightings", "fused_weightings", "batched_hist2d",
                "batched_subbin_hist")
# The 2-D kernels that the compacting pair scheduler launches.
PAIR_KERNELS = ("batched_hist2d", "batched_subbin_hist")
# The sharded phase: rows and bins of the whole input, and its ranks.
SHARDED_N, SHARDED_K, SHARDED_WORLD = 10_000_000, 256, 2
# The schedulers phase's correlated table (rows, columns): the construction
# bench's generator at its full size, drawn from a generator of its own
# (seed 3), so not the bench's table; and the rows of its escalation table.
CORRELATED = (60_000, 8)
ESCALATION_N = 100_000
# The timeline intervals that split the compacting scheduler's pair phase.
PAIR_SPANS = ("pair_presort", "pair_upload", "compact_launch",
              "pair_metadata")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def wall_ms(fn, reps: int = 20, warm: int = 3, windows: int = 5) -> float:
    """Time per call of ``fn`` over ``reps`` warm back-to-back calls,
    between two CUDA events: the device time, or the host's time to issue
    the call when that is longer; the median of ``windows`` such windows
    (the host's time varies from window to window)."""
    import statistics

    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def _is_device_work(e) -> bool:
    """A kernel, memset or copy on the card (not a profiler annotation)."""
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(PROFILE_SPANS))


def device_ms(fn, reps: int = 20, warm: int = 3, tries: int = 5) -> float:
    """Device time per call of ``fn`` (``device_profile``)."""
    return device_profile(fn, reps, warm, tries)[0]


def device_profile(fn, reps: int = 20, warm: int = 3,
                   tries: int = 5) -> tuple[float, float]:
    """Device time and device operations per call of ``fn``: the summed
    durations and the number of the kernels, memsets and copies it puts on
    the card (``torch.profiler``), over ``reps`` warm calls. Host overhead
    is not in it. Every call puts at least one operation on the card, so a
    trace with fewer than ``reps`` device events lost some (seen on the
    card as whole cases reading 0) and is taken again, up to ``tries``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        work = [e for e in prof.events() if _is_device_work(e)]
        if len(work) >= reps:
            break
    total_us = sum(e.time_range.end - e.time_range.start for e in work)
    return total_us / 1e3 / reps, len(work) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1


def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    info = {"phase": "device", "nvidia_smi": card,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


# --------------------------------------------------------------- phase 2


def phase_build() -> None:
    from repro_torch.kernels import loader
    seconds, logs = loader.build()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name in loader.EXPORTS:
        loader.library(name)
    emit({"phase": "build", "seconds": seconds,
          "libraries": sorted(loader.EXPORTS)})


# --------------------------------------------------------------- phase 3


HIST_P, HIST_N, HIST_S_MAX = 8, 100_000, 32   # a pair loop's launch


def _hist_bins(kind: str, k2: int) -> tuple[int, int]:
    """(KA, KB) of K3 (k2 x k2 counts) or K4 (k2^2 cells x s_max)."""
    return (k2, k2) if kind == "batched_hist2d" else (k2 * k2, HIST_S_MAX)


def hist_inputs(kind: str, k2: int, weights: str, layout: str, rng,
                device="cuda"):
    """Synthetic K3/K4 inputs of a pair loop's launch (8 pairs x 100,000
    rows). ``layout`` "uniform": ids uniform over the bins; "sorted": each
    pair's rows sorted by flat id, a quarter of them in one heavy bin and
    the rest Zipf(1.3)-distributed over the bins, as sorted skewed columns
    give. ``weights`` "f64_01" (5% zeros) or "f32": uniform in [0, 1) on
    uniform ids; on sorted ids multiples of 1/256 in [0, 1), whose fp32
    sums are exact in any order (a heavy bin sums 25,000 rows, where the
    plain version's own fp32 order alone moves the sum by about 1e-5)."""
    import numpy as np
    import torch
    p, n = HIST_P, HIST_N
    ka, kb = _hist_bins(kind, k2)
    if layout == "uniform":
        a, b = rng.integers(0, ka, (p, n)), rng.integers(0, kb, (p, n))
    else:
        nb = ka * kb
        rank = np.minimum(rng.zipf(1.3, (p, n)), nb) - 1
        flat = (rank * 7919 + rng.integers(0, nb, (p, 1))) % nb
        flat = np.where(rng.random((p, n)) < 0.25,
                        rng.integers(0, nb, (p, 1)), flat)
        flat.sort(axis=1)
        a, b = flat // kb, flat % kb
    if weights == "f64_01":
        w = (rng.random((p, n)) < 0.95).astype(np.float64)
    elif layout == "uniform":
        w = rng.random((p, n)).astype(np.float32)
    else:
        w = (rng.integers(0, 256, (p, n)) / 256).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (a, b, w)) + \
        (ka, kb)


class _Captured(Exception):
    """Ends the capturing ingest once both launches were recorded."""


@contextmanager
def recording_hist_inputs(got: dict, key, stop: bool = False):
    """Within the block, the arguments of every K3 and K4 launch whose
    ``key(name, args)`` is new in ``got`` are cloned there; with ``stop``
    the block ends (``_Captured``) once both kernels were recorded. The
    names the 2-D refinement bound at import are wrapped for the block only
    and restored."""
    import repro_torch.core.chi2 as chi2
    import repro_torch.core.refine as refine
    sites = ((refine, "batched_hist2d"), (chi2, "batched_subbin_hist"))
    originals = [getattr(mod, name) for mod, name in sites]

    def wrap(name, fn):
        def recorder(*args):
            k = key(name, args)
            if k not in got:
                got[k] = tuple(x.clone() if hasattr(x, "clone") else x
                               for x in args)
            if stop and len(got) == len(sites):
                raise _Captured
            return fn(*args)
        return recorder

    for (mod, name), fn in zip(sites, originals):
        setattr(mod, name, wrap(name, fn))
    try:
        yield got
    finally:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, fn)


def capture_main_hist_inputs(device: str = "cuda", table=None,
                             params=None) -> dict:
    """The arguments of the first K3 and the first K4 launch of one
    ``AQPFramework.ingest`` of the main table (the first 2-D refinement
    round: f64 first-occurrence flags into k2 x k2 cells, f64 validity into
    k2^2 x s_max sub-bins), cloned. The names the callers bound at import
    are wrapped for this ingest only and restored; the ingest stops once
    both are recorded. ``table`` and ``params`` (the main table and the
    paper's defaults when None) let a rehearsal on the CPU run it small."""
    from repro_torch.aqp import datasets
    from repro_torch.aqp.engine import AQPFramework
    from repro_torch.core.types import BuildParams
    got = {}
    try:
        with recording_hist_inputs(got, lambda name, args: name, stop=True):
            AQPFramework(params or BuildParams(), use_compression=True,
                         device=device).ingest(
                             datasets.flights() if table is None else table)
    except _Captured:
        pass
    if len(got) != 2:
        raise AssertionError(f"ingest launched only {sorted(got)}")
    return got


def _hist_case(kind: str, a, b, w, ka: int, kb: int, **labels) -> dict:
    """One K3/K4 comparison: exact for f64 0/1 weights, rtol 1e-5 atol
    1e-6 otherwise (atomics add in no fixed order); times the kernel, its
    plain version and ``torch.bincount`` on the clipped flat id."""
    import torch
    from repro_torch.kernels.hist2d import batched_hist2d
    from repro_torch.kernels.hist2d.ref import batched_hist2d_ref
    from repro_torch.kernels.subbin import batched_subbin_hist
    from repro_torch.kernels.subbin.ref import batched_subbin_hist_ref
    fn, ref = (batched_hist2d, batched_hist2d_ref) \
        if kind == "batched_hist2d" else \
        (batched_subbin_hist, batched_subbin_hist_ref)
    p, n = w.shape
    got = fn(a, b, w, ka, kb)
    want = ref(a, b, w, ka, kb)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if w.dtype == torch.float64 and bool(((w == 0) | (w == 1)).all()):
        ok, tol = bool(torch.equal(got, want)), "exact"
    else:
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
        tol = "rtol 1e-5 atol 1e-6"
    nbins = ka * kb
    offs = torch.arange(p, device=w.device)[:, None] * nbins
    flat = (torch.clamp(a, 0, ka - 1) * kb + torch.clamp(b, 0, kb - 1)
            + offs).reshape(-1)
    wf = w.reshape(-1)
    out_bytes = p * nbins * w.element_size()
    n_bytes = p * n * (a.element_size() + b.element_size()
                       + w.element_size()) + out_bytes
    bms, by = bound_ms(n_bytes, p * n)
    return dict(_times(lambda: fn(a, b, w, ka, kb),
                       lambda: ref(a, b, w, ka, kb),
                       lambda: torch.bincount(flat, weights=wf,
                                              minlength=p * nbins)),
                name=kind, p=p, n=n, ka=ka, kb=kb, ok=ok, tolerance=tol,
                max_abs_err=err, bound_ms=bms, bound_by=by, **labels)


def hist_cases(rng) -> list:
    """K3/K4: the main path's own first launches (reported, ``shape``
    "main"), then uniform and sorted skewed inputs at k2 = 64, 128, 256
    with f64 0/1 and f32 weights."""
    main = capture_main_hist_inputs()
    cases = []
    for kind in ("batched_hist2d", "batched_subbin_hist"):
        a, b, w, ka, kb = main[kind]
        k2 = ka if kind == "batched_hist2d" else round(ka ** 0.5)
        cases.append(_hist_case(kind, a, b, w, ka, kb, shape="main", k2=k2,
                                weights=str(w.dtype).replace("torch.", "")))
    for kind in ("batched_hist2d", "batched_subbin_hist"):
        for layout in ("sorted", "uniform"):
            for k2 in (64, 128, 256):
                for wd in ("f64_01", "f32"):
                    args = hist_inputs(kind, k2, wd, layout, rng)
                    cases.append(_hist_case(kind, *args, shape=layout, k2=k2,
                                            weights=wd))
    return cases


# K5's cases (rows, KI, KJ, weights, clipped): the reported shape first,
# then whole-table scale, one slab (with out-of-range rows), many slabs,
# more than 8 slabs, one row.
K5_CASES = ((100_000, 256, 256, "f32", False),
            (SHARDED_N, 256, 256, "01", False),
            (SHARDED_N, 256, 256, "f32", False),
            (64_000, 96, 64, "01", True),
            (1_024, 512, 512, "f32", False),
            (2_048 * 5 + 3, 2_048, 256, "01", False),
            (1, 256, 256, "f32", False))


def single_hist_inputs(n: int, ki: int, kj: int, weights: str,
                       clip: bool = False, device="cuda"):
    """K5 inputs from a seed of the shape: int32 ids uniform over the bins
    (``clip``: up to 2 bins outside them), ``weights`` "01" (10% zeros) or
    "f32" uniform in [0, 1)."""
    import numpy as np
    import torch
    rng = np.random.default_rng([n, ki, kj])
    pad = 2 if clip else 0
    bi, bj = (rng.integers(-pad, k + pad, n, dtype=np.int32) for k in (ki, kj))
    if weights == "01":
        w = (rng.random(n) < 0.9).astype(np.float32)
    else:
        w = rng.random(n, dtype=np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (bi, bj, w))


def _single_hist_case(n: int, ki: int, kj: int, weights: str,
                      clip: bool = False) -> dict:
    """One K5 comparison: ``weights`` "01" (exact) or "f32" (rtol 1e-5,
    atol 1e-6: atomics add in no fixed order); times the kernel, its plain
    version and ``torch.bincount``, and counts the kernel's device
    operations per call."""
    import torch
    from repro_torch.kernels.hist2d import hist2d
    from repro_torch.kernels.hist2d.ref import hist2d_ref
    bi, bj, w = single_hist_inputs(n, ki, kj, weights, clip)
    got = hist2d(bi, bj, w, ki, kj)
    want = hist2d_ref(bi, bj, w, ki, kj)
    torch.cuda.synchronize()
    if weights == "01":
        ok, tol = bool(torch.equal(got, want)), "exact"
    else:
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
        tol = "rtol 1e-5 atol 1e-6"
    flat = (torch.clamp(bi.to(torch.int64), 0, ki - 1) * kj
            + torch.clamp(bj.to(torch.int64), 0, kj - 1))
    bms, by = bound_ms(n * 12 + ki * kj * 4, n)
    times = _times(lambda: hist2d(bi, bj, w, ki, kj),
                   lambda: hist2d_ref(bi, bj, w, ki, kj),
                   lambda: torch.bincount(flat, weights=w,
                                          minlength=ki * kj))
    return dict(times, name="hist2d", n=n, ki=ki, kj=kj, weights=weights,
                clipped=clip, ok=ok, tolerance=tol,
                max_abs_err=float((got - want).abs().max()), bound_ms=bms,
                bound_by=by,
                device_ops=device_profile(
                    lambda: hist2d(bi, bj, w, ki, kj))[1])


def _single_hist_empty() -> dict:
    """K5 with no rows: zeros and no launch."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.hist2d import hist2d
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    before = launch_counts()["hist2d"]
    out = hist2d(empty, empty, empty.float(), 256, 256)
    ok = (out.shape == (256, 256) and not bool(out.any())
          and launch_counts()["hist2d"] == before)
    return {"name": "hist2d", "n": 0, "ki": 256, "kj": 256, "ok": ok,
            "tolerance": "zeros, no launch", "max_abs_err": 0.0}


def _times(fn, ref, library) -> dict:
    """Device ms per call of the kernel's wrapper, its plain version and the
    library call, plus the wall ms per call of all three."""
    return {"ms": device_ms(fn), "plain_ms": device_ms(ref),
            "library_ms": device_ms(library), "wall_ms": wall_ms(fn),
            "plain_wall_ms": wall_ms(ref), "library_wall_ms": wall_ms(library)}


def _weightings_inputs(q: int, el: int, k2: int, k1: int, rng):
    """Random K1/K2 inputs: dense counts, one-hot fold, random coverage."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    H = (rng.random((el, k2, k2)) * 10).astype(np.float32)
    hx = H.sum(2) + 1.0
    fold = np.zeros((el, k1, k2), np.float32)
    for li in range(el):
        fold[li, np.arange(k1), np.sort(rng.integers(0, k2, k1))] = 1.0
    beta = rng.random((q, el, k2)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (H, beta, fold, hx))


def _weightings_case(kind: str, H, beta, fold, hx, **labels) -> dict:
    """One K1/K2 comparison; K2 (``fused_weightings``) takes ``beta[0]``.

    ``fold`` is the dense one-hot fold or its index; the kernel and its
    plain version take the index (converted here, outside the timed calls),
    the library call (the reference's einsum chain) the dense fold."""
    import torch
    from repro_torch.kernels.weightings import (batched_weightings,
                                                fold_index, fused_weightings)
    from repro_torch.kernels.weightings.ref import (batched_weightings_ref,
                                                    fused_weightings_ref)
    el, k2, _ = H.shape
    if fold.dim() == 3:
        dense, idx = fold, fold_index(fold)
    else:
        idx = fold
        dense = torch.nn.functional.one_hot(idx.long(), k2).float()
    q, k1 = beta.shape[0], idx.shape[1]
    if kind == "fused_weightings":
        q = 1
        b1 = beta[0]

        def fn():
            return fused_weightings(H, b1, idx, hx)

        def ref():
            return fused_weightings_ref(H, b1, idx, hx)
    else:
        def fn():
            return batched_weightings(H, beta, idx, hx)

        def ref():
            return batched_weightings_ref(H, beta, idx, hx)

    def library():
        v = torch.einsum("lab,qlb->qla", H, beta[:q])
        p_row = torch.clamp(v / torch.clamp(hx, min=1e-30), 0.0, 1.0)
        return torch.einsum("lka,qla->qlk", dense, p_row).prod(dim=1)

    got, want = fn(), ref()
    torch.cuda.synchronize()
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
    # Bytes: each input once (the fold as its int32 index), the output once;
    # operations: the products H beta and the product over predicates.
    n_bytes = 4 * (el * k2 * k2 + q * el * k2 + el * k1 + el * k2 + q * k1)
    n_ops = 2 * q * el * k2 * k2 + q * el * k1
    bms, by = bound_ms(n_bytes, n_ops)
    # The bound of PRs 11-12: the dense fold read, its one-hot products.
    dense_bms, _ = bound_ms(n_bytes + 4 * el * k1 * (k2 - 1),
                            n_ops + 2 * q * el * k1)
    return dict(_times(fn, ref, library), name=kind, q=q, l=el, k2=k2,
                k1=k1, ok=ok,
                tolerance="rtol 1e-5 atol 1e-6",
                max_abs_err=float((got - want).abs().max()), bound_ms=bms,
                bound_by=by, dense_fold_bound_ms=dense_bms, **labels)


def phase_kernels() -> dict:
    """Every kernel against its plain version; the first case of each kernel
    is its reported (main-path) shape."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 einsums
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    cases = hist_cases(rng)
    # K1/K2 at the build caps (Q = 64, K2 = 256, K1 = 512); the main path's
    # own shape is measured in the main phase.
    for el in (1, 3):
        args = _weightings_inputs(64, el, 256, 512, rng)
        for kind in ("batched_weightings", "fused_weightings"):
            cases.append(_weightings_case(kind, *args, shape="caps"))
    cases += [_single_hist_case(*case) for case in K5_CASES]
    cases.append(_single_hist_empty())
    _check(cases, "kernels")
    return cases


def _check(cases, phase: str) -> None:
    for c in cases:
        emit(dict(c, phase=phase))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")


# --------------------------------------------------------------- phase 4


def _close(a, b, rtol: float = 1e-5, atol: float = 1e-6) -> bool:
    import numpy as np
    if a[0] is None or b[0] is None:
        return a == b
    return bool(np.allclose(a, b, rtol=rtol, atol=atol))


def _drive_main(fw, table, queries, wave_sql) -> dict:
    """Ingest, answer ``queries`` one at a time, then serve ``wave_sql`` as
    one fused wave; the launch counts are reset first and read last."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    span = torch.profiler.record_function
    out = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with span("main.ingest"):
        fw.ingest(table)
        torch.cuda.synchronize()
    out["ingest_s"] = time.perf_counter() - t0
    out["single_ms"], out["answers"] = [], []
    with span("main.queries"):
        for sql in queries:
            t = time.perf_counter()
            out["answers"].append(fw.query(sql).as_tuple())
            out["single_ms"].append((time.perf_counter() - t) * 1e3)
    engine = out["engine"] = fw.engine
    t = time.perf_counter()
    plans = out["plans"] = [engine.plan_sql(s) for s in wave_sql]
    out["plan_s"] = time.perf_counter() - t
    agg_col = out["agg_col"] = plans[0].agg_col
    t = time.perf_counter()
    with span("main.wave"):
        triples = fw.fastpath.batch(engine.ph, agg_col,
                                    [p.tree for p in plans], engine.corrected)
        if triples is None:
            raise AssertionError("the serving wave was not batchable")
        out["wave"] = [engine.execute_plan(p, weightings=w).as_tuple()
                       for p, w in zip(plans, triples)]
        torch.cuda.synchronize()
    out["wave_s"] = time.perf_counter() - t
    out["launches"] = launch_counts()
    return out


def phase_main(profile: bool = False) -> dict:
    """The main path; with ``profile`` its run (ingest, queries, wave) is
    traced by ``torch.profiler`` and summarized by ``_profile_report``."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch.aqp import datasets
    from repro_torch.aqp.engine import AQPFramework
    from repro_torch.aqp.exact import ExactEngine
    from repro_torch.aqp.queries import (AGGS_INITIAL, generate_queries,
                                         relative_error)
    from repro_torch.core.fastpath import FastPath
    from repro_torch.core.query import QueryEngine
    from repro_torch.core.types import BuildParams

    table = datasets.flights()
    queries = generate_queries(table, 256, seed=0, aggs=AGGS_INITIAL,
                               max_preds=3)
    rng = np.random.default_rng(0)
    wave_sql = [f"SELECT AVG(arr_delay) FROM t WHERE distance > "
                f"{int(a)} AND dep_delay < {int(b)}"
                for a, b in zip(rng.uniform(200, 2000, 64),
                                rng.uniform(-2, 40, 64))]
    exact = ExactEngine(table)
    truth = [exact.query(s) for s in queries + wave_sql]
    fw = AQPFramework(BuildParams(), use_compression=True,
                      fastpath=FastPath(), device="cuda")

    # The main path's run: counters at 0 just before, read just after.
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    with prof:
        run = _drive_main(fw, table, queries, wave_sql)
    if profile:
        _profile_report(prof, "main.", "chip_smoke_profile.json")
    engine, plans, agg_col = run["engine"], run["plans"], run["agg_col"]
    answers, wave, launches = run["answers"], run["wave"], run["launches"]
    single_ms = run["single_ms"]

    # K1 and K2 once more on the main path's own inputs (the wave's stacks
    # and coverage vectors) against their plain versions; these launches
    # come after the counts were read.
    fp = fw.fastpath
    split = [fp._split_leaves(engine.ph, agg_col, p.tree) for p in plans]
    pair_cols = tuple(lf.col for lf in split[0][1])
    hs, fidx, hxs, _k1, k2max = fp._get_stack(engine.ph, agg_col, pair_cols)
    betas = fp._pair_betas_batch(engine.ph, agg_col,
                                 [pls for _, pls in split], k2max)
    betas = torch.as_tensor(betas.reshape(-1, len(pair_cols), k2max),
                            device=hs.device)
    main_cases = [_weightings_case(kind, hs, betas, fidx, hxs, shape="main")
                  for kind in ("batched_weightings", "fused_weightings")]
    _check(main_cases, "main_kernels")

    host = QueryEngine(fw.synopsis)
    mismatched = []
    for sql, got in zip(queries + wave_sql, answers + wave):
        want = host.query(sql).as_tuple()
        if not _close(got, want):
            mismatched.append((sql, got, want))
    rel = [relative_error(a[0], tr)
           for a, tr in zip(answers + wave, truth)]
    n_and = sum(" OR " not in s for s in queries)
    out = {
        "phase": "main", "rows": len(table["distance"]),
        "columns": len(table), "pairs": len(fw.synopsis.pairs),
        "ingest_s": run["ingest_s"], "timings": {
            k: v for k, v in fw.timings.items()},
        "queries": len(queries), "and_queries": n_and,
        "single_p50_ms": float(np.percentile(single_ms, 50)),
        "single_p99_ms": float(np.percentile(single_ms, 99)),
        "wave_queries": len(wave_sql), "wave_plan_s": run["plan_s"],
        "wave_s": run["wave_s"], "wave_qps": len(wave_sql) / run["wave_s"],
        "median_rel_err_pct": float(np.median(rel[:len(queries)])),
        "wave_median_rel_err_pct": float(np.median(rel[len(queries):])),
        "fastpath_vs_host_mismatches": len(mismatched),
        "launches": launches, "kernel_cases": main_cases,
        "build_stats": {k: v for k, v in fw.synopsis.build_stats.items()
                        if k in ("pair_launches", "compaction", "device")},
    }
    emit({k: v for k, v in out.items() if k != "kernel_cases"})
    if mismatched:
        raise AssertionError(f"fast path differs from host NumPy: "
                             f"{mismatched[:5]}")
    zero = [k for k in MAIN_KERNELS if launches[k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{zero}")
    out["serve_inputs"] = (fw, queries, wave_sql)
    return out


def _profile_report(prof, prefix: str, fname: str) -> None:
    """Per ``prefix*`` span of a profiled phase: the device's busy time
    (intervals of kernels, memsets and copies merged and clipped to the
    span) and idle share, and device time by name, written to
    ``chiprun_out/<fname>``. The profiler's own overhead is inside these
    numbers."""
    import torch
    events = prof.events()
    work = [e for e in events if _is_device_work(e)]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in work)
    report = {"phase": "profile", "kernel_events": len(kernels), "spans": {}}
    for e in events:
        if not e.name.startswith(prefix) or \
                e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        busy, end = 0.0, lo
        for k0, k1 in kernels:          # merge overlaps, clip to the span
            k0, k1 = max(k0, end, lo), min(k1, hi)
            if k1 > k0:
                busy += k1 - k0
                end = k1
        wall = hi - lo
        seen = kernels and wall > 0     # no kernel events: not measured
        report["spans"][e.name] = {
            "wall_ms": wall / 1e3,
            "device_busy_ms": busy / 1e3 if seen else None,
            "idle_share": 1.0 - busy / wall if seen else None}
    by_name = {}
    for e in work:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    report["top_kernels"] = [
        {"name": n[:120], "device_ms": v[0], "count": v[1]}
        for n, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / fname).write_text(
        json.dumps(report, indent=1))
    emit({"phase": "profile", "spans_of": prefix,
          "kernel_events": len(kernels),
          "spans": report["spans"], "top_kernels": report["top_kernels"][:8]})


# --------------------------------------------------------------- phase 5


SERVE_CLIENTS = 8
# The serving layer's kernels: K1 for fused groups (the wave), K2 for the
# singles (the client queries, which rarely share a shape in one window).
SERVE_KERNELS = ("batched_weightings", "fused_weightings")


def _host_framework(fw):
    """The ``"numpy"`` server's table: a framework without a fast path,
    built by ``ingest_compressed`` from ``fw``'s compressed table (no
    second pre-processing or compression; the build is deterministic, so
    its synopsis is ``fw``'s)."""
    from repro_torch.aqp.engine import AQPFramework
    return AQPFramework(fw.params, device=fw.device).ingest_compressed(
        fw.compressed, fw.preprocessed.columns)


def _serve_clients(srv, queries) -> tuple[list, list]:
    """Answer ``queries`` through ``srv.submit`` from ``SERVE_CLIENTS``
    threads, each waiting for one answer before it submits the next;
    returns the answers (in ``queries`` order) and the per-query latencies
    in ms (submit to answer)."""
    import threading
    answers = [None] * len(queries)
    lat_ms = [0.0] * len(queries)
    errors = []

    def client(ci):
        try:
            for qi in range(ci, len(queries), SERVE_CLIENTS):
                t = time.perf_counter()
                res = srv.submit(queries[qi]).result(timeout=120)
                lat_ms[qi] = (time.perf_counter() - t) * 1e3
                answers[qi] = res.as_tuple()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a serving client never finished")
    if errors:
        raise errors[0]
    return answers, lat_ms


def _serve_run(srv, queries, wave_sql, label: str) -> dict:
    """The 256 queries from the clients, then the 64-query wave through
    ``query_batch``, each under a ``serve.<label>.*`` profiler span; then
    the server's own trace read back: its execution spans (``single_exec``
    per query run alone, ``wave_group`` per fused group) and its stage
    latencies."""
    import numpy as np
    import torch
    span = torch.profiler.record_function
    with span(f"serve.{label}.clients"):
        answers, lat_ms = _serve_clients(srv, queries)
    t = time.perf_counter()
    with span(f"serve.{label}.wave"):
        wave = [r.as_tuple() for r in srv.query_batch(wave_sql)]
    wave_s = time.perf_counter() - t
    spans = {}
    for sp in srv.tracer.spans():
        spans.setdefault(sp.name, []).append((sp.t1 - sp.t0) * 1e3)
    single = spans.get("single_exec", [])
    stages = srv.stats()["totals"]["stages"]
    return {"answers": answers, "wave": wave, "lat_ms": lat_ms,
            "wave_s": wave_s, "exec": {
                "singles": len(single),
                "single_exec_p50_ms": float(np.percentile(single, 50))
                if single else None,
                "single_exec_ms": float(np.sum(single)),
                "fused_groups": len(spans.get("wave_group", [])),
                "fused_group_ms": float(np.sum(spans.get("wave_group", []))),
                "stage_p50_ms": {k: stages[k]["p50_ms"] for k in (
                    "plan", "admit", "queue", "assemble", "execute",
                    "resolve")}}}


def phase_serve(main_out: dict, card: str, profile: bool = False) -> dict:
    """The serving stack on the main phase's framework: ``AQPServer`` in
    ``"cuda"`` mode (the client queries as singles through K2, the wave as
    one fused group through K1) against one in ``"numpy"`` mode on the same
    synopsis, both with tracing on; then the synopsis encoded, registered
    as a cold table and answered again in ``"numpy"`` mode. With
    ``profile`` both servers' runs are traced by ``torch.profiler``."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch.core import storage
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.aqp import AQPServer
    fw, queries, wave_sql = main_out["serve_inputs"]
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    host_fw = _host_framework(fw)

    with prof:
        # The serving path's run: counters at 0 just before, read just
        # after.
        reset_launch_counts()
        srv = AQPServer(mode="cuda", trace_enabled=True)
        try:
            srv.register("t", fw)
            fused = _serve_run(srv, queries, wave_sql, "cuda")
            launches = launch_counts()
            stats = srv.stats()["tables"]["t"]
        finally:
            srv.close()
        host = AQPServer(mode="numpy", trace_enabled=True)
        try:
            host.register("t", host_fw)
            plain = _serve_run(host, queries, wave_sql, "numpy")
        finally:
            host.close()
    if profile:
        _profile_report(prof, "serve.", "chip_smoke_profile_serve.json")

    host = AQPServer(mode="numpy")
    try:
        host.register("t", host_fw)
        blob = storage.encode(fw.synopsis)
        host.register_cold("t_cold", blob)
        cold_sql = [q.replace(" FROM t ", " FROM t_cold ") for q in queries]
        cold, _ = _serve_clients(host, cold_sql)
        decode_s = host.catalog.resolve("t_cold").timings["cold_decode_s"]
    finally:
        host.close()

    mismatched = [(q, g, w) for q, g, w in zip(
        queries + wave_sql, fused["answers"] + fused["wave"],
        plain["answers"] + plain["wave"]) if not _close(g, w)]
    cold_mismatched = [(q, g, w) for q, g, w in zip(
        cold_sql, cold, plain["answers"]) if not _close(g, w, 1e-9, 0.0)]
    lat = fused["lat_ms"]
    out = {
        "phase": "serve", "card": card,
        "queries": len(queries), "clients": SERVE_CLIENTS,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "numpy_p50_ms": float(np.percentile(plain["lat_ms"], 50)),
        "numpy_p99_ms": float(np.percentile(plain["lat_ms"], 99)),
        "wave_queries": len(wave_sql), "wave_s": fused["wave_s"],
        "wave_qps": len(wave_sql) / fused["wave_s"],
        "numpy_wave_qps": len(wave_sql) / plain["wave_s"],
        "exec": fused["exec"], "numpy_exec": plain["exec"],
        "batched": stats["batched"], "fallback": stats["fallback"],
        "kernel_launches": {k: launches[k] for k in SERVE_KERNELS},
        "mismatches": len(mismatched),
        "blob_bytes": len(blob), "eq12_bound": storage.eq12_bound(
            fw.synopsis), "decode_s": decode_s,
        "cold_mismatches": len(cold_mismatched),
    }
    emit(out)
    if mismatched:
        raise AssertionError(f"cuda server differs from the numpy "
                             f"server: {mismatched[:5]}")
    if cold_mismatched:
        raise AssertionError(f"cold tier differs from the warm numpy "
                             f"answers: {cold_mismatched[:5]}")
    if stats["batched"] <= 0:
        raise AssertionError("the server never took the fused path")
    zero = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched by the server: "
                             f"{zero}")
    return out


# --------------------------------------------------------------- phase 6


def synopsis_diffs(a, b) -> list:
    """The fields (``"hist i f"``, ``"pair (a, b) f"``) in which two
    synopses differ under ``array_equal``."""
    import numpy as np
    diffs = []
    for i, (ha, hb) in enumerate(zip(a.hists, b.hists)):
        for f in ha._fields:
            if not np.array_equal(getattr(ha, f), getattr(hb, f)):
                diffs.append(f"hist {i} {f}")
    if len(a.hists) != len(b.hists) or set(a.pairs) != set(b.pairs):
        diffs.append("keys")
    for key in set(a.pairs) & set(b.pairs):
        for f in a.pairs[key]._fields:
            if not np.array_equal(getattr(a.pairs[key], f),
                                  getattr(b.pairs[key], f)):
                diffs.append(f"pair {key} {f}")
    return diffs


def escalation_data(n: int, rng):
    """Four integer columns: a uniform base, a near copy of it, an
    independent uniform column and a near mirror of the base. Each column's
    1-D grid fits the k2 = 64 rung, but the joint of two base-derived
    columns needs more than 64 bins an axis, so the compacting scheduler
    escalates those pairs one rung up."""
    import numpy as np
    x = rng.integers(0, 100_000, n).astype(float)
    return np.stack([x, np.round(x + rng.normal(0, 300, n)),
                     rng.integers(0, 100_000, n).astype(float),
                     np.round(100_000 - x + rng.normal(0, 300, n))], 1)


def _scheduler_build(data, columns, params, scheduler: str) -> tuple:
    """One build on the card under ``scheduler`` with its K3/K4 launches
    counted; returns the synopsis and its report: ``split_s`` is the pair
    phase's timeline intervals (``PAIR_SPANS``)."""
    import dataclasses

    import torch
    from repro_torch.core.build import build_pairwise_hist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    over = {"compact": {}, "sequential": {"pair_batched": False}}[scheduler]
    reset_launch_counts()
    t = time.perf_counter()
    syn = build_pairwise_hist(data, columns,
                              dataclasses.replace(params, **over),
                              device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launch_counts()
    stats = syn.build_stats
    if stats["mode"] != scheduler:
        raise AssertionError(f"{scheduler} build ran as {stats['mode']}")
    rep = dict(_pair_report(stats), mode=scheduler, build_s=seconds,
               launches={k: counts[k] for k in PAIR_KERNELS})
    return syn, rep


def _pair_report(stats: dict) -> dict:
    split = {k: v for k, v in stats["phase_s"].items() if k in PAIR_SPANS}
    return {"pair_phase_s": stats["pair_phase_s"], "split_s": split,
            "other_s": stats["pair_phase_s"] - sum(split.values()),
            "pair_launches": stats.get("pair_launches"),
            "compaction": stats.get("compaction")}


def _shape_key(name: str, args: tuple) -> tuple:
    return name, args[3], args[4]


def phase_schedulers(main_out: dict) -> list:
    """The per-pair loop on the card, held to the compacting scheduler's
    synopsis field by field: on the main table (the main phase's synopsis;
    the rebuild starts from its compressed table), on a correlated table
    (``CORRELATED``) and on one whose pairs escalate
    (``escalation_data``, whose compacting build must escalate a pair).
    The K3/K4 inputs of each new shape that the compacting builds of the
    last two launch are recorded and held against the plain versions;
    returns those cases."""
    import numpy as np
    from repro_torch.bench.construction import _correlated_data
    from repro_torch.core.types import BuildParams, ColumnInfo

    def ints(d):
        return [ColumnInfo(name=f"c{i}", kind="int") for i in range(d)]

    fw = main_out["serve_inputs"][0]
    n, d = CORRELATED
    tables = {
        "main": (fw.compressed, fw.preprocessed.columns, fw.params,
                 fw.synopsis),
        "correlated": (_correlated_data(n, d, np.random.default_rng(3)),
                       ints(d), BuildParams(n_samples=n), None),
        "escalation": (escalation_data(ESCALATION_N,
                                       np.random.default_rng(5)),
                       ints(4), BuildParams(n_samples=ESCALATION_N), None),
    }
    out = {"phase": "schedulers", "tables": {}}
    bad = []
    recorded = {}
    for label, (data, columns, params, ref) in tables.items():
        if ref is None:
            with recording_hist_inputs(recorded, _shape_key):
                ref, rep = _scheduler_build(data, columns, params, "compact")
            zero = [k for k in PAIR_KERNELS if rep["launches"][k] <= 0]
            if zero:
                bad.append((label, "compact", f"no launches of {zero}"))
        else:
            rep = dict(_pair_report(ref.build_stats), mode="compact",
                       source="main phase")
        if label == "escalation" and \
                rep["compaction"]["escalated_pairs"] <= 0:
            bad.append((label, "compact", "no pair escalated"))
        syn, seq = _scheduler_build(data, columns, params, "sequential")
        diffs = synopsis_diffs(ref, syn)
        seq["mismatched_fields"] = len(diffs)
        if diffs:
            bad.append((label, "sequential", diffs[:10]))
        builds = [rep, seq]
        out["tables"][label] = {"pairs": len(ref.pairs),
                                "n_samples": params.n_samples,
                                "builds": builds}
    emit(out)
    if bad:
        raise AssertionError(f"schedulers phase failed: {bad}")
    cases = []
    for (kind, ka, kb), (a, b, w, *_k) in recorded.items():
        k2 = ka if kind == "batched_hist2d" else round(ka ** 0.5)
        cases.append(_hist_case(kind, a, b, w, ka, kb, shape="schedulers",
                                k2=k2,
                                weights=str(w.dtype).replace("torch.", "")))
    _check(cases, "schedulers")
    return cases


# --------------------------------------------------------------- phase 7


def phase_parity() -> None:
    from repro_torch.aqp import datasets
    from repro_torch.aqp.engine import AQPFramework
    from repro_torch.core.types import BuildParams
    table = datasets.flights(n=60_000)
    params = BuildParams(n_samples=20_000)
    built = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        built[dev] = AQPFramework(params, device=dev).ingest(table).synopsis
        built[dev + "_s"] = time.perf_counter() - t
    a, b = built["cuda"], built["cpu"]
    diffs = synopsis_diffs(a, b)
    emit({"phase": "parity", "rows": 60_000, "n_samples": 20_000,
          "pairs": len(a.pairs), "cuda_build_s": built["cuda_s"],
          "cpu_build_s": built["cpu_s"], "mismatched_fields": diffs})
    if diffs:
        raise AssertionError(f"card and CPU synopses differ: {diffs}")


# --------------------------------------------------------------- phase 8


def _sharded_run(rank: int, world: int, init_file: str, device: str,
                 n: int) -> dict:
    """One rank of the sharded phase: the whole input from the seed, this
    rank's ``np.array_split`` share binned by ``hist2d_sharded``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.hist2d import hist2d_sharded
    from repro_torch.kernels.hist2d.ref import hist2d_ref
    k = SHARDED_K
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        rng = np.random.default_rng(0)
        bi = rng.integers(0, k, n, dtype=np.int32)
        bj = rng.integers(0, k, n, dtype=np.int32)
        w = (rng.random(n) < 0.9).astype(np.float32)
        dev = torch.device(device)
        a, b, c = (torch.as_tensor(np.array_split(x, world)[rank], device=dev)
                   for x in (bi, bj, w))
        before = launch_counts()["hist2d"]
        got = hist2d_sharded(a, b, c, k, k)      # warm-up
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: 0)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        got = hist2d_sharded(a, b, c, k, k)
        sync()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        buf = torch.ones(k * k, device=dev)
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        sync()
        out = {"rank": rank, "rows": int(a.shape[0]),
               "sharded_ms": sharded_ms,
               "all_reduce_ms": (time.perf_counter() - t0) * 1e3,
               "launches": launch_counts()["hist2d"] - before}
        if rank == 0:
            want = hist2d_ref(torch.as_tensor(bi, device=dev),
                              torch.as_tensor(bj, device=dev),
                              torch.as_tensor(w, device=dev), k, k)
            out["exact"] = bool(torch.equal(got, want))
            out["max_abs_err"] = float((got - want).abs().max())
        return out
    finally:
        dist.destroy_process_group()


def _sharded_rank(rank: int, world: int, init_file: str, device: str, n: int,
                  queue) -> None:
    """Process entry of one rank: its result, or its traceback, goes to
    ``queue``."""
    sys.path.insert(0, str(ROOT / "src"))
    try:
        out = _sharded_run(rank, world, init_file, device, n)
    except Exception:  # noqa: BLE001 — reported to the parent
        out = {"rank": rank, "error": traceback.format_exc()}
    queue.put(out)


def phase_sharded(device: str = "cuda:0", n: int = SHARDED_N) -> list:
    """Two gloo ranks on one card (NCCL refuses two ranks on one device);
    every process started here is stopped before it returns."""
    import torch.multiprocessing as mp
    OUT_DIR.mkdir(exist_ok=True)
    init = OUT_DIR / "sharded.init"
    init.unlink(missing_ok=True)
    queue = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _sharded_rank, args=(SHARDED_WORLD, str(init), device, n, queue),
        nprocs=SHARDED_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    ranks = []
    try:
        done = False
        while not done:                 # drain the queue while joining
            while not queue.empty():
                ranks.append(queue.get())
            done = ctx.join(timeout=2)
            if not done and time.monotonic() > deadline:
                raise TimeoutError("sharded ranks did not finish in 300 s")
        while not queue.empty():
            ranks.append(queue.get())
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        init.unlink(missing_ok=True)
    ranks.sort(key=lambda r: r["rank"])
    if len(ranks) != SHARDED_WORLD:
        raise AssertionError(f"sharded phase: {len(ranks)} of "
                             f"{SHARDED_WORLD} ranks reported")
    emit({"phase": "sharded", "rows": n, "bins": [SHARDED_K, SHARDED_K],
          "world": SHARDED_WORLD, "backend": "gloo", "device": device,
          "seconds": time.perf_counter() - t0, "ranks": ranks})
    bad = [r for r in ranks if "error" in r or r["launches"] <= 0]
    if bad or not ranks[0].get("exact"):
        raise AssertionError(f"sharded phase failed: {ranks}")
    return ranks


# --------------------------------------------------------------- phase 9


def phase_bench() -> int:
    """The kernel bench and the quick construction bench on the card;
    returns K5's launches in the kernel bench."""
    from repro_torch.bench import construction as bench_construction
    from repro_torch.bench import kernels as bench_kernels
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rows = []
    reset_launch_counts()
    out = bench_kernels.run(rows, device="cuda", out_dir=OUT_DIR / "bench")
    launches = launch_counts()["hist2d"]
    n_kernel_rows = len(rows)
    cons = bench_construction.run(rows, quick=True, device="cuda",
                                  out_dir=OUT_DIR / "bench")
    for row in rows:
        print(row, flush=True)
    emit({"phase": "bench", "rows": len(rows), "kernel_rows": n_kernel_rows,
          "hist2d_launches": launches,
          "query_agree": out["query_path"]["agree"],
          "construction_equal": (cons["pair_phase"]["bitforbit_equal"]
                                 and cons["correlated"]["bitforbit_equal"]),
          "json": [str((OUT_DIR / "bench" / f"{name}.json").relative_to(ROOT))
                   for name in ("kernels", "construction")]})
    if launches <= 0:
        raise AssertionError("the bench never launched the hist2d kernel")
    return launches


# -------------------------------------------------------------- phase 10

# The lm phase: qwen3-0.6b at its published width, served in its bf16;
# prompt lengths drawn from LM_PROMPTS (inclusive) by a fixed seed.
LM_ARCH = "qwen3-0.6b"
LM_REQUESTS, LM_SLOTS, LM_NEW, LM_MAX_LEN = 8, 4, 32, 512
LM_PROMPTS = (64, 192)
# Card against CPU in f32, TF32 off: the reference's own decode-vs-prefill
# tolerance (tests/test_models.py).
LM_RTOL, LM_ATOL = 1e-3, 2e-4
LM_CHECK_B, LM_CHECK_S, LM_CHECK_NEW, LM_DECODES = 2, 64, 8, 4
# The full-width models' MLP output projections (w2) are scaled by this
# power of two after the seeded init (exact in bf16), so that each block's
# MLP, a function of the current token, outweighs the tied embedding and
# the attention's average over the context in the residual stream, and
# greedy decoding moves on from token to token: at the init's scale every
# request repeats its first generated token, and equal tokens test one
# argmax.
LM_RESID_SCALE = 32.0
# bf16 on the card against bf16 on the CPU, the same weights: the logits'
# relative distance as a share of the CPU's own f32-to-bf16 distance (1.0:
# as far as computing in f32). Smoke configs: at most 0.66 measured over
# the 12 cases' prefill and 4 decode steps on an H100, so 0.8. Full width:
# 0.81 measured, as the 28 layers let rounding differences grow nearly as
# far as f32 lies; 1.25 catches gross faults only. Whether each dtype step
# rounds where the reference does is held by the CPU tests against the
# reference (tests/test_torch_models.py).
LM_BF16_SHARE, LM_BF16_FULL_SHARE = 0.8, 1.25


def _lm_requests(vocab: int, n: int = LM_REQUESTS, new: int = LM_NEW,
                 seed: int = 0) -> list:
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    lengths = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, n)
    return [Request(prompt=rng.integers(0, vocab, int(k)).astype(np.int32),
                    max_new_tokens=new) for k in lengths]


def _lm_serve(model, reqs, slots: int, max_len: int, device=None,
              record: bool = False) -> dict:
    """Serve ``reqs``; with ``record``, also every step's last-position
    logits as the engine sampled them (``"logits"``, f32 on the host)."""
    from repro_torch.serve.engine import ServeEngine

    class Recording(ServeEngine):
        def _sample(self, logits):
            seen.append(logits.float().cpu())
            return ServeEngine._sample(logits)

    seen = []
    engine = (Recording if record else ServeEngine)(
        model, batch_slots=slots, max_len=max_len, device=device)
    engine.generate(reqs)
    tokens = sum(len(r.out_tokens) for r in reqs)
    return {"tokens": tokens, "stats": engine.last_stats,
            "tokens_per_s": tokens / engine.last_stats["wall_s"],
            "out": [list(r.out_tokens) for r in reqs], "logits": seen}


def _lm_moving(model):
    """Scale ``model``'s MLP output projections by LM_RESID_SCALE in
    place; returns it."""
    import torch
    with torch.no_grad():
        for block in model.blocks:
            block.mlp.w2.mul_(LM_RESID_SCALE)
    return model


def _lm_moving_share(out: list) -> float:
    """Share of consecutive generated tokens that differ, over requests."""
    pairs = [(a, b) for toks in out for a, b in zip(toks, toks[1:])]
    return sum(a != b for a, b in pairs) / len(pairs)


def _lm_rel(a, b) -> float:
    """Relative distance ||a - b|| / ||b|| of two logit tensors, in f32 on
    the host."""
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _lm_err(a, b) -> tuple[float, bool]:
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    return (float((a - b).abs().max()),
            bool(torch.allclose(a, b, rtol=LM_RTOL, atol=LM_ATOL)))


def _lm_cpu_copy(model):
    import copy
    return copy.deepcopy(model).to("cpu")


def _lm_timings(model, cfg) -> dict:
    """Prefill of LM_SLOTS x the longest prompt and LM_NEW single decode
    steps on a fresh cache (host clock around synchronised calls, medians);
    the device operations and busy time of one decode step
    (``device_profile``)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_SLOTS, LM_PROMPTS[1])).astype(np.int32)).cuda()
    pre_ms = []
    for _ in range(3):
        cache = init_cache(cfg, LM_SLOTS, LM_MAX_LEN)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(model, toks, cache)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t) * 1e3)
    last = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    step_ms = []
    for _ in range(LM_NEW):
        t = time.perf_counter()
        logits, cache = decode_step(model, last, cache)
        last = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        last.cpu()
        step_ms.append((time.perf_counter() - t) * 1e3)
    busy_ms, ops = device_profile(lambda: decode_step(model, last, cache),
                                  reps=5, warm=1)
    return {"prefill_tokens": LM_SLOTS * LM_PROMPTS[1],
            "prefill_ms": statistics.median(pre_ms),
            "decode_step_ms": statistics.median(step_ms),
            "decode_step_device_ms": busy_ms,
            "decode_launches_per_step": ops}


def _lm_arch_case(arch: str, moe_impl: str | None) -> dict:
    """One smoke architecture, the same weights on the card and the CPU:
    prefill of LM_CHECK_B x LM_CHECK_S inputs, then LM_DECODES decode
    steps on fixed inputs, in f32 (the largest logit error of each call,
    at LM_RTOL / LM_ATOL) and in bf16 (each call's card-to-CPU distance as
    a share of the CPU's f32-to-bf16 distance, at most LM_BF16_SHARE)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, \
        prefill
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    rng = np.random.default_rng(2)
    b, s, n = LM_CHECK_B, LM_CHECK_S, LM_CHECK_S + LM_DECODES
    inp = (0.1 * rng.standard_normal((b, n, cfg.d_model))).astype(
        np.float32) if cfg.embed_inputs else \
        rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    inp = torch.from_numpy(inp)
    steps = [inp[:, :s]] + [inp[:, t:t + 1] if cfg.embed_inputs
                            else inp[:, t] for t in range(s, n)]
    logits = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = dataclasses.replace(cfg, dtype=dtype)
        gpu = init_params(dcfg, torch.Generator("cuda").manual_seed(1))
        models = {"cuda": gpu, "cpu": _lm_cpu_copy(gpu)}
        caches = {"cuda": init_cache(dcfg, b, 2 * s),
                  "cpu": init_cache(dcfg, b, 2 * s, device="cpu")}
        for dev in ("cuda", "cpu"):
            logits[dtype, dev] = [
                (prefill if i == 0 else decode_step)(
                    models[dev], x.to(dev), caches[dev])[0].cpu()
                for i, x in enumerate(steps)]
    errs, ok = [], True
    for got, want in zip(logits["float32", "cuda"], logits["float32", "cpu"]):
        err, close = _lm_err(got, want)
        errs.append(err)
        ok &= close and bool(torch.isfinite(got).all())
    shares = [_lm_rel(g16, c16) / _lm_rel(c32, c16) for g16, c16, c32 in
              zip(logits["bfloat16", "cuda"], logits["bfloat16", "cpu"],
                  logits["float32", "cpu"])]
    ok16 = all(torch.isfinite(g).all() for g in logits["bfloat16", "cuda"]) \
        and max(shares) <= LM_BF16_SHARE
    kinds = sorted({k for pat, _ in cfg.layer_groups() for k in pat})
    return {"arch": arch, "moe_impl": moe_impl,
            "kinds": kinds, "layers": cfg.n_layers,
            "prefill_max_abs_err": errs[0], "decode_max_abs_err": errs[1:],
            "bf16_shares": shares, "ok": ok and ok16}


def phase_lm(card: str) -> dict:
    """The port's LM serving path on the card (``repro_torch.models``,
    ``serve.engine``): qwen3-0.6b at full width in bf16 served through
    ``ServeEngine(device=None)``; the same weights in f32 on the card and
    the CPU (logits, greedy tokens), the bf16 weights' logits on the card
    and the CPU, the f32 decode step's cost; the share of greedy tokens that
    bf16 and f32 agree on; then every architecture's smoke config on the
    card and the CPU. Launches no kernel of the port (K1-K5)."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.models.common import param_count
    t_phase = time.perf_counter()
    reset_launch_counts()
    cfg = get_config(LM_ARCH)                       # bf16, the published one
    gen = torch.Generator("cuda")
    t = time.perf_counter()
    model = _lm_moving(init_params(cfg, gen.manual_seed(0)))
    init_s = time.perf_counter() - t
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())

    # 1. Full-width serving in bf16 (a short warm-up request first).
    _lm_serve(model, _lm_requests(cfg.vocab, n=1, new=2, seed=9), LM_SLOTS,
              LM_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bf16 = _lm_serve(model, _lm_requests(cfg.vocab), LM_SLOTS, LM_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    timings = _lm_timings(model, cfg)
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3

    # 2. The same weights in f32 (drawn from the same seed; the bf16
    # model's are their roundings), TF32 off, on the card and the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = _lm_moving(init_params(cfg32, gen.manual_seed(0)))
    cpu32 = _lm_cpu_copy(m32)
    reqs = _lm_requests(cfg.vocab, n=LM_CHECK_B, new=LM_CHECK_NEW, seed=3)
    toks = torch.stack([torch.from_numpy(r.prompt[:LM_CHECK_S])
                        for r in reqs])
    lg_gpu, _ = prefill(m32, toks.cuda(),
                        init_cache(cfg32, LM_CHECK_B, LM_CHECK_S))
    t = time.perf_counter()
    lg_cpu, _ = prefill(cpu32, toks, init_cache(cfg32, LM_CHECK_B,
                                                LM_CHECK_S, device="cpu"))
    cpu_prefill_s = time.perf_counter() - t
    logit_err, logits_close = _lm_err(lg_gpu, lg_cpu)
    short = [dataclasses.replace(r, prompt=r.prompt[:LM_CHECK_S],
                                 out_tokens=[]) for r in reqs]
    gen_gpu = _lm_serve(m32, [dataclasses.replace(r, out_tokens=[])
                              for r in short], LM_CHECK_B, 2 * LM_CHECK_S,
                        record=True)
    gen_cpu = _lm_serve(cpu32, [dataclasses.replace(r, out_tokens=[])
                                for r in short], LM_CHECK_B,
                        2 * LM_CHECK_S, device="cpu", record=True)
    del cpu32
    steps = [_lm_err(a, b) for a, b in zip(gen_gpu["logits"],
                                           gen_cpu["logits"])]
    steps_close = len(gen_gpu["logits"]) == len(gen_cpu["logits"]) and \
        all(ok for _, ok in steps)

    # 2b. The bf16 weights on the card and the CPU: the logits' distance
    # against the CPU's own f32-to-bf16 distance on the same prompts.
    cpu16 = _lm_cpu_copy(model)
    lg16_gpu, _ = prefill(model, toks.cuda(),
                          init_cache(cfg, LM_CHECK_B, LM_CHECK_S))
    lg16_cpu, _ = prefill(cpu16, toks, init_cache(cfg, LM_CHECK_B,
                                                  LM_CHECK_S, device="cpu"))
    del cpu16
    bf16_rel = _lm_rel(lg16_gpu, lg16_cpu)
    f32_bf16_rel = _lm_rel(lg_cpu, lg16_cpu)
    bf16_close = bool(torch.isfinite(lg16_gpu).all()) and \
        bf16_rel <= LM_BF16_FULL_SHARE * f32_bf16_rel

    # 4. bf16 against f32 at full width: the same 8 requests in f32, and
    # the f32 decode step's cost beside the bf16 one's.
    f32 = _lm_serve(m32, _lm_requests(cfg.vocab), LM_SLOTS, LM_MAX_LEN)
    timings32 = _lm_timings(m32, cfg32)
    pairs = [(a, b) for ra, rb in zip(bf16["out"], f32["out"])
             for a, b in zip(ra, rb)]
    del m32
    # bf16 again, so that the host-bound times of the two dtypes compare
    # within the call in the order bf16, f32, bf16.
    again = _lm_serve(model, _lm_requests(cfg.vocab), LM_SLOTS, LM_MAX_LEN)
    again = {"tokens_per_s": again["tokens_per_s"],
             "tokens_equal": again["out"] == bf16["out"],
             **_lm_timings(model, cfg)}

    # 3. Every block kind: the ten smoke configs, MoE under both dispatches.
    cases = []
    for arch in ARCHS:
        impls = ("einsum", "sort") if get_config(arch, smoke=True).n_experts \
            else (None,)
        cases += [_lm_arch_case(arch, impl) for impl in impls]
    failed = [c["arch"] + (f"/{c['moe_impl']}" if c["moe_impl"] else "")
              for c in cases if not c["ok"]]
    port_launches = {k: v for k, v in launch_counts().items() if v}

    out = {"phase": "lm", "card": card, "arch": LM_ARCH,
           "dtype": cfg.dtype, "params": param_count(model),
           "weight_bytes": weight_bytes, "init_s": init_s,
           "resid_scale": LM_RESID_SCALE,
           "requests": LM_REQUESTS, "slots": LM_SLOTS,
           "new_tokens": LM_NEW, "max_len": LM_MAX_LEN,
           "prompt_lengths": [len(r.prompt) for r in _lm_requests(cfg.vocab)],
           "tokens": bf16["tokens"], "serve_stats": bf16["stats"],
           "tokens_per_s": bf16["tokens_per_s"], **timings,
           "moving_share": _lm_moving_share(bf16["out"]),
           "decode_floor_ms": floor_ms,
           "max_memory_allocated": peak,
           "f32_check": {"batch": LM_CHECK_B, "seq": LM_CHECK_S,
                         "logits_max_abs_err": logit_err,
                         "logits_close": logits_close,
                         "cpu_prefill_s": cpu_prefill_s,
                         "tokens_cuda": gen_gpu["out"],
                         "tokens_cpu": gen_cpu["out"],
                         "tokens_equal": gen_gpu["out"] == gen_cpu["out"],
                         "moving_share": _lm_moving_share(gen_gpu["out"]),
                         "step_logits_max_abs_err": max(e for e, _ in steps),
                         "step_logits_close": steps_close},
           "bf16_check": {"batch": LM_CHECK_B, "seq": LM_CHECK_S,
                          "logits_rel": bf16_rel,
                          "f32_bf16_rel": f32_bf16_rel,
                          "share": bf16_rel / f32_bf16_rel,
                          "limit": LM_BF16_FULL_SHARE,
                          "close": bf16_close},
           "f32_tokens_per_s": f32["tokens_per_s"],
           "f32_timings": timings32, "bf16_again": again,
           "bf16_f32_equal_token_share": sum(a == b for a, b in pairs)
           / len(pairs),
           "archs": cases, "arch_failures": failed,
           "port_kernel_launches": port_launches,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if bf16["tokens"] != LM_REQUESTS * LM_NEW:
        raise AssertionError(f"served {bf16['tokens']} tokens, not "
                             f"{LM_REQUESTS * LM_NEW}")
    if not logits_close:
        raise AssertionError(f"f32 logits differ between the card and the "
                             f"CPU by up to {logit_err}")
    if not out["f32_check"]["tokens_equal"]:
        raise AssertionError("f32 greedy tokens differ between the card "
                             "and the CPU")
    if not steps_close:
        raise AssertionError("f32 logits of a generate step differ between "
                             "the card and the CPU")
    if not all(len(set(t)) > 1 for t in gen_gpu["out"]):
        raise AssertionError("f32 greedy decoding repeats one token in a "
                             "request: the token check would test one "
                             "argmax")
    if not bf16_close:
        raise AssertionError(f"bf16 logits differ between the card and the "
                             f"CPU by {bf16_rel} of their norm, more than "
                             f"{LM_BF16_FULL_SHARE} of the f32-to-bf16 "
                             f"distance {f32_bf16_rel}")
    if failed:
        raise AssertionError(f"architectures whose card and CPU logits "
                             f"differ: {failed}")
    return out


# -------------------------------------------------------------- phase 11

# The train phase: qwen3-0.6b at its published width, computing in bf16
# from f32 masters, driven through repro_torch.launch.train with the
# reference's command-line defaults (batch 8, seq 128, lr 1e-3, warmup
# steps // 10) for TRAIN_STEPS steps.
TRAIN_STEPS = 20
# The card-vs-CPU and resume checks cut qwen3-0.6b to this many layers
# (full width: d_model 1024, vocab 151,936).
TRAIN_DEPTH = 2
TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 64
# One compared step: past the warmup (so it moves the weights), from zero
# moments, with tests/test_train.py's schedule.
TRAIN_START = 6
TRAIN_HYPER = dict(lr=1e-3, warmup_steps=5, total_steps=40)
# H100 SXM dense bf16 peak (NVIDIA data sheet).
BF16_FLOPS_PER_S = 989e12
# AdamW's bytes a parameter: p, g, mu, nu read, p, mu, nu written, f32.
ADAMW_BYTES_PER_PARAM = 7 * 4
# Card against CPU in f32, TF32 off (tests/test_torch_train_step.py's
# measured spreads against the reference are the model): loss rtol 2e-5,
# grad norm rtol 1e-4, each gradient tensor within 1e-4 of its norm (f32
# sums in another order: about 1e-6), the moments of each tensor within
# 1e-4 of its norm. Parameters by the sign rule: at rtol 1e-6, atol 1e-7
# where the two gradients agree within 1e-4 of |g|; the other elements
# ("noise": a gradient within rounding of zero, whose AdamW step may flip)
# within one flipped step (2 lr) of the CPU's, counted per tensor and
# bounded: 1% for the smoke configs (the CPU test's bound; at most 0.60%
# read on an H100), 2.5% at full width (1.8% read on an H100, 94% of it
# in the embedding, whose rows outside the batch get only the softmax's
# gradient). Every element of the card's parameters, noise
# included, is also held at rtol 1e-6, atol 1e-7 to the AdamW update that
# the card's own new moments give (computed in f64), so no element goes
# unchecked.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_TENSOR_REL = 2e-5, 1e-4, 1e-4
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 1e-6, 1e-7
TRAIN_AGREE = 1e-4
TRAIN_NOISE_FULL, TRAIN_NOISE_SMOKE = 0.025, 0.01
# Reported, not bounded: the share of elements whose |g| is at most this
# share of their tensor's largest (the bf16 test's floor).
TRAIN_FLOOR = 1e-4
TRAIN_TELEMETRY_ROWS = 5000
# Determinism's cost: windows of this many steps, on and off in turns.
TRAIN_DET_STEPS, TRAIN_DET_TURNS = 10, ("on", "off", "off", "on")
# Resumed on the card besides qwen3-0.6b at TRAIN_DEPTH (f32, the default
# einsum dispatch for the MoE).
TRAIN_RESUME_SMOKE = ("mamba2_1_3b", "deepseek_moe_16b")


def _train_batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """``TokenPipeline``'s batch at step 0 (embeddings drawn from ``seed``
    for a frontend-fed config), as NumPy arrays."""
    import numpy as np
    from repro_torch.data.pipeline import TokenPipeline
    batch = TokenPipeline(cfg.vocab, b, s, seed=seed).host_slice(0)
    if cfg.embed_inputs:
        rng = np.random.default_rng(seed)
        batch = {"embeds": (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32),
            "labels": batch["labels"]}
    return batch


def _rel_norm(a, b) -> float:
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    n = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / n if n else \
        float(torch.linalg.vector_norm(a))


def _train_card_vs_cpu(cfg, batch: dict, noise_share: float) -> dict:
    """One f32 step of ``cfg`` on the card and on the CPU from the same
    weights (drawn on the CPU from seed 1) and batch, at TRAIN_START: loss,
    grad norm and each gradient and moment tensor at the TRAIN_*
    tolerances; the parameters by the sign rule, with at most
    ``noise_share`` of the elements noise; every card parameter against
    the update its own moments give."""
    import copy

    import torch
    from repro_torch.train.optimizer import (Hyper, adamw_init, decayed,
                                             schedule)
    from repro_torch.train.step import (TrainState, init_train_state,
                                        loss_and_grads, make_train_step)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    start = {n: p.detach().clone() for n, p in cpu.params.named_parameters()}
    gpu_model = copy.deepcopy(cpu.params).cuda()
    states = {"cuda": TrainState(gpu_model, adamw_init(gpu_model),
                                 TRAIN_START),
              "cpu": cpu._replace(step=TRAIN_START)}
    hyper = Hyper(**TRAIN_HYPER)
    step = make_train_step(cfg, hyper)
    out = {}
    for dev, state in states.items():
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(state.params, b)
        new, metrics = step(state, b)
        out[dev] = {"loss": float(loss), "grads": grads,
                    "grad_norm": float(metrics["grad_norm"]),
                    "params": dict(new.params.named_parameters()),
                    "opt": new.opt}
    g, c = out["cuda"], out["cpu"]
    grad_rel = max(_rel_norm(g["grads"][n], c["grads"][n])
                   for n in c["grads"])
    moment_rel = max(_rel_norm(g["opt"][k][n], c["opt"][k][n])
                     for k in ("mu", "nu") for n in c["grads"])
    # The AdamW update in f64 from the card's own moments, with the f32
    # learning rate and bias corrections that adamw_update applies.
    t = torch.tensor(TRAIN_START + 1, dtype=torch.float32)
    lr = float(schedule(hyper, TRAIN_START))
    bc1, bc2 = float(1.0 - hyper.b1 ** t), float(1.0 - hyper.b2 ** t)
    decay = decayed(cfg)
    noise = total = bad = own_bad = floor = 0
    noise_by = {}
    for name, want in c["params"].items():
        got = g["params"][name].detach()
        p0 = start[name].cuda().double()
        mu, nu = g["opt"]["mu"][name].double(), g["opt"]["nu"][name].double()
        upd = (mu / bc1) / ((nu / bc2).sqrt() + hyper.eps)
        if name in decay:
            upd = upd + hyper.weight_decay * p0
        own = p0 - lr * upd
        own_bad += int(((got.double() - own).abs() > TRAIN_PARAM_ATOL
                        + TRAIN_PARAM_RTOL * own.abs()).sum())
        got, want = got.cpu(), want.detach()
        gc = c["grads"][name]
        clear = (g["grads"][name].cpu() - gc).abs() <= TRAIN_AGREE * gc.abs()
        diff = (got - want).abs()
        bad += int((diff > TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL
                    * want.abs())[clear].sum())
        flip = 2 * lr * (1 + hyper.weight_decay * start[name].abs()) \
            + TRAIN_PARAM_ATOL
        bad += int((diff > flip)[~clear].sum())
        n_noise = int((~clear).sum())
        if n_noise:
            noise_by[name] = [n_noise, want.numel()]
        noise += n_noise
        floor += int((gc.abs() <= TRAIN_FLOOR * gc.abs().max()).sum())
        total += want.numel()
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    gnorm_rel = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
    ok = (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL
          and grad_rel <= TRAIN_TENSOR_REL and moment_rel <= TRAIN_TENSOR_REL
          and bad == 0 and own_bad == 0 and noise <= noise_share * total)
    top = sorted(noise_by.items(), key=lambda kv: -kv[1][0])[:4]
    return {"loss_cuda": g["loss"], "loss_cpu": c["loss"],
            "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
            "grad_tensor_rel_max": grad_rel,
            "moment_tensor_rel_max": moment_rel,
            "param_mismatches": bad, "own_update_mismatches": own_bad,
            "noise_elements": noise, "noise_share": noise / total,
            "noise_bound": noise_share, "noise_by_tensor": dict(top),
            "below_floor_share": floor / total,
            "elements": total, "ok": ok}


def _train_resume(cfg, root: str) -> dict:
    """tests/test_train.py's resume recipe on the card: 12 steps of 4 x
    64, checkpoints every 4, against a run failed at step 7 and resumed;
    the final parameters and moments must be equal bit for bit."""
    import os
    import statistics

    import torch
    from repro_torch.train.loop import InjectedFailure, train
    from repro_torch.train.optimizer import Hyper
    t = time.perf_counter()
    rh = Hyper(**TRAIN_HYPER)
    kw = dict(steps=12, batch=4, seq=64, ckpt_every=4, verbose=False)
    s1, h1 = train(cfg, rh, ckpt_dir=os.path.join(root, "a"), **kw)
    t_run = [time.perf_counter() - t]
    failed = False
    try:
        train(cfg, rh, ckpt_dir=os.path.join(root, "b"), fail_at_step=7,
              **kw)
    except InjectedFailure:
        failed = True
    t_run.append(time.perf_counter() - t - sum(t_run))
    s2, _ = train(cfg, rh, ckpt_dir=os.path.join(root, "b"), **kw)
    t_run.append(time.perf_counter() - t - sum(t_run))
    equal = s1.step == s2.step == 12 and all(
        torch.equal(a, b) for a, b in zip(s1.params.parameters(),
                                          s2.params.parameters())) \
        and all(torch.equal(s1.opt[k][n], s2.opt[k][n])
                for k in ("mu", "nu") for n in s1.opt[k])
    return {"steps": 12, "batch": 4, "seq": 64, "ckpt_every": 4,
            "fail_at_step": 7, "failed": failed, "state_equal": equal,
            "ok": failed and equal, "run_s": t_run,
            "final_save_s": h1["final_save_s"],
            "median_step_ms": statistics.median(h1["step_time"][1:]) * 1e3,
            "seconds": time.perf_counter() - t}


def _device_top(fn, n: int = 12) -> list:
    """The device operations of one warm call of ``fn`` grouped by name:
    the ``n`` largest by summed time, as [name, ms, count]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if _is_device_work(e):
            ms, k = by.get(e.name, (0.0, 0))
            by[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                          k + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return [[name[:240], ms, k] for name, (ms, k) in top]


def _train_timed_steps(step_fn, state, batch, n: int) -> tuple:
    """``n`` synchronised steps; returns (state, median ms)."""
    import statistics

    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        times.append((time.perf_counter() - t) * 1e3)
    return state, statistics.median(times)


def _train_telemetry() -> tuple:
    """tests/test_train.py's 5,000 telemetry rows (rng 0) into a store on
    the card and one on the CPU: synopsis diffs, answers, stragglers, the
    card build's K3/K4 launches and the K3/K4 cases on the first inputs of
    each shape that the card build launched."""
    import numpy as np
    from repro_torch.core.types import BuildParams
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.telemetry import TelemetryStore
    rng = np.random.default_rng(0)
    rows = []
    for step in range(TRAIN_TELEMETRY_ROWS):
        host = f"host{step % 4}"
        base = 0.1 if host != "host3" else 0.25
        rows.append(dict(step=step, loss=3.0 - step * 1e-4,
                         grad_norm=float(rng.random()),
                         step_time=base + rng.random() * 0.01, host=host))
    stores = {}
    recorded = {}
    for dev in (None, "cpu"):
        store = TelemetryStore(BuildParams(n_samples=TRAIN_TELEMETRY_ROWS),
                               device=dev)
        store.extend(rows)
        if dev is None:
            reset_launch_counts()
            t = time.perf_counter()
            with recording_hist_inputs(recorded, _shape_key):
                store.build()
            build_s = time.perf_counter() - t
            launches = {k: v for k, v in launch_counts().items() if v}
        else:
            store.build()
        stores[dev] = store
    card, host = stores[None], stores["cpu"]
    diffs = synopsis_diffs(card._framework.synopsis, host._framework.synopsis)
    sqls = ("SELECT AVG(step_time) FROM t WHERE host = 'host3'",
            "SELECT AVG(loss) FROM t WHERE step > 4000",
            "SELECT MEDIAN(step_time) FROM t")
    answers = [(card.query(s).estimate, host.query(s).estimate)
               for s in sqls]
    stragglers = card.straggler_report()
    cases = []
    for (kind, ka, kb), (a, b, w, *_k) in recorded.items():
        k2 = ka if kind == "batched_hist2d" else round(ka ** 0.5)
        cases.append(_hist_case(kind, a, b, w, ka, kb, shape="telemetry",
                                k2=k2,
                                weights=str(w.dtype).replace("torch.", "")))
    out = {"rows": len(rows), "build_s": build_s,
           "mismatched_fields": len(diffs), "answers": answers,
           "answers_equal": all(a == b for a, b in answers),
           "stragglers": sorted(stragglers),
           "stragglers_equal": stragglers == host.straggler_report(),
           "launches": launches}
    return out, cases


def phase_train(card: str) -> tuple:
    """The port's LM training path on the card (``repro_torch.launch.train``
    -> ``train.loop`` -> ``train.step`` -> ``train.optimizer``,
    ``ckpt.checkpoint``, ``train.telemetry``): qwen3-0.6b at full width
    for TRAIN_STEPS steps, its step cost and what determinism costs; one
    step under each remat setting; f32 card against CPU at depth
    TRAIN_DEPTH; bit-exact resume on the card; every smoke config card
    against CPU, compression, microbatches; the telemetry store's build
    (K3/K4) against the CPU's. Returns (the phase's JSON, the K3/K4 cases
    held against their plain versions)."""
    import copy
    import dataclasses
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.common import param_count
    from repro_torch.train.grad_compress import GDQuantizer
    from repro_torch.train.loop import deterministic_algorithms, train
    from repro_torch.train.optimizer import Hyper
    from repro_torch.train.step import (init_train_state, loss_and_grads,
                                        make_train_step)
    from repro_torch.train.telemetry import TelemetryStore
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    bad = []
    try:
        # 1. Full width through the command line's path, telemetry on.
        args = train_cli.parse(["--steps", str(TRAIN_STEPS), "--ckpt-dir",
                                os.path.join(tmp, "full")])
        cfg = get_config(args.arch)
        tel = TelemetryStore(device=None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, hist = train_cli.run(args, telemetry=tel)
        run_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        n_params = param_count(state.params)
        tokens = args.batch * args.seq
        step_ms = statistics.median(hist["step_time"][1:]) * 1e3
        flops = 8 * n_params * tokens           # fwd 2, bwd 4, remat 2
        adamw_bytes = ADAMW_BYTES_PER_PARAM * n_params
        floor_ms = max(flops / BF16_FLOPS_PER_S,
                       adamw_bytes / HBM_BYTES_PER_S) * 1e3
        losses = hist["loss"]
        telemetry_avg = tel.query("SELECT AVG(step_time) FROM t").estimate
        hyper = Hyper(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
        step_fn = make_train_step(cfg, hyper)
        host = {k: torch.from_numpy(v).cuda() for k, v in
                _train_batch(cfg, args.batch, args.seq).items()}
        box = [state]

        def one_step():
            box[0], _ = step_fn(box[0], host)
        # What determinism costs: windows of TRAIN_DET_STEPS steps with it
        # on and off in turns, then one profiled step of each. The loop
        # runs its steps with it on, so the step's device time, launches
        # and idle share are read with it on.
        det = {"on": [], "off": []}
        for mode in TRAIN_DET_TURNS:
            with (deterministic_algorithms() if mode == "on"
                  else nullcontext()):
                box[0], ms = _train_timed_steps(step_fn, box[0], host,
                                                TRAIN_DET_STEPS)
            det[mode].append(ms)
        det["off_device_ms"], det["off_launches"] = device_profile(
            one_step, reps=1, warm=1)
        with deterministic_algorithms():
            busy_ms, launches = device_profile(one_step, reps=3, warm=1)
            top = _device_top(one_step)
        full = {"arch": args.arch, "dtype": cfg.dtype,
                "param_dtype": str(state.params.param_dtype),
                "remat": cfg.remat, "remat_policy": cfg.remat_policy,
                "params": n_params, "batch": args.batch, "seq": args.seq,
                "steps": args.steps, "lr": args.lr,
                "warmup_steps": hyper.warmup_steps,
                "loss": losses, "grad_norm": hist["grad_norm"],
                "step_ms": [t * 1e3 for t in hist["step_time"]],
                "median_step_ms": step_ms,
                "tokens_per_s": tokens / (step_ms / 1e3),
                "step_device_ms": busy_ms, "launches_per_step": launches,
                "step_device_top": top,
                "idle_share": 1.0 - busy_ms / step_ms,
                "max_memory_allocated": peak,
                "ckpt_save_s": hist["final_save_s"], "run_s": run_s,
                "train_floor_ms": floor_ms,
                "floor_by": "operations" if flops / BF16_FLOPS_PER_S >=
                adamw_bytes / HBM_BYTES_PER_S else "bytes",
                "train_mfu": 6 * n_params * tokens
                / (step_ms / 1e3 * BF16_FLOPS_PER_S),
                "deterministic_step_ms": det,
                "flagged_steps": hist["flagged_steps"],
                "telemetry_rows": len(hist["loss"]),
                "telemetry_avg_step_time": telemetry_avg}
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            bad.append("full-width loss did not fall")
        if not np.isfinite(hist["grad_norm"]).all():
            bad.append("full-width grad norm not finite")
        del state, box, step_fn
        shutil.rmtree(os.path.join(tmp, "full"), ignore_errors=True)

        # 2. One step under each remat setting: peak memory of the
        # gradient pass and of the whole step.
        remat = {}
        for label, kw in (("off", {"remat": False}),
                          ("nothing", {"remat_policy": "nothing"}),
                          ("dots", {"remat_policy": "dots"}),
                          ("blk_out", {"remat_policy": "blk_out"})):
            c = dataclasses.replace(cfg, **kw)
            st = init_train_state(c, torch.Generator("cuda").manual_seed(0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, grads = loss_and_grads(st.params, host)
            torch.cuda.synchronize()
            grad_peak = torch.cuda.max_memory_allocated()
            del grads
            t = time.perf_counter()
            st, metrics = make_train_step(c, hyper)(st, host)
            float(metrics["loss"])
            remat[label] = {"grad_peak_bytes": grad_peak,
                            "step_peak_bytes":
                                torch.cuda.max_memory_allocated(),
                            "state_bytes": base, "loss": float(loss),
                            "grad_norm": float(metrics["grad_norm"]),
                            "step_ms": (time.perf_counter() - t) * 1e3}
            del st
        if not remat["nothing"]["grad_peak_bytes"] < \
                remat["off"]["grad_peak_bytes"]:
            bad.append("remat 'nothing' did not lower peak memory")

        # 3. f32 card against CPU, full width cut to TRAIN_DEPTH layers.
        cut = dataclasses.replace(cfg, dtype="float32", n_layers=TRAIN_DEPTH)
        t = time.perf_counter()
        f32 = _train_card_vs_cpu(
            cut, _train_batch(cut, TRAIN_CHECK_B, TRAIN_CHECK_S),
            TRAIN_NOISE_FULL)
        f32["seconds"] = time.perf_counter() - t
        if not f32["ok"]:
            bad.append("f32 card and CPU steps differ")

        # 4. Bit-exact resume on the card (tests/test_train.py's recipe):
        # full width at TRAIN_DEPTH, and the smoke configs of the SSD
        # (its f32 cumsum) and of an MoE under the einsum dispatch.
        resume = {"full_width": dict(_train_resume(cut, os.path.join(
            tmp, "resume")), cut=f"n_layers {cfg.n_layers} -> {TRAIN_DEPTH}")}
        for arch in TRAIN_RESUME_SMOKE:
            sc = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype="float32")
            resume[arch] = dict(_train_resume(sc, os.path.join(tmp, arch)),
                                moe_impl=sc.moe_impl if sc.n_experts
                                else None)
        not_exact = [k for k, v in resume.items() if not v["ok"]]
        if not_exact:
            bad.append(f"resume on the card is not bit-exact: {not_exact}")

        # 5. Every smoke config card against CPU (MoE under both
        # dispatches); compression; microbatches.
        smoke = []
        for arch in ARCHS:
            sc = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype="float32")
            for impl in (("einsum", "sort") if sc.n_experts else (None,)):
                c = dataclasses.replace(sc, moe_impl=impl) if impl else sc
                case = _train_card_vs_cpu(
                    c, _train_batch(c, TRAIN_CHECK_B, TRAIN_CHECK_S),
                    TRAIN_NOISE_SMOKE)
                smoke.append(dict(case, arch=arch, moe_impl=impl))
        smoke_failed = [c["arch"] + (f"/{c['moe_impl']}" if c["moe_impl"]
                                     else "") for c in smoke if not c["ok"]]
        if smoke_failed:
            bad.append(f"smoke configs differ card vs CPU: {smoke_failed}")
        qcfg = dataclasses.replace(get_config(args.arch, smoke=True),
                                   dtype="float32")
        rh = Hyper(**TRAIN_HYPER)
        _, gd = train(qcfg, rh, steps=30, batch=8, seq=64,
                      ckpt_dir=os.path.join(tmp, "gd"), ckpt_every=100,
                      compressor=GDQuantizer(bits=8), verbose=False)
        gd_drop = float(np.mean(gd["loss"][:5]) - np.mean(gd["loss"][-5:]))
        if not gd_drop > 0.2:
            bad.append(f"GDQuantizer training loss fell by {gd_drop} only")
        s0 = init_train_state(qcfg, torch.Generator("cuda").manual_seed(0))
        mb = {k: torch.from_numpy(v).cuda()
              for k, v in _train_batch(qcfg, 8, 64, seed=1).items()}
        m1 = make_train_step(qcfg, rh)(copy.deepcopy(s0), mb)[0]
        m4 = make_train_step(qcfg, rh, microbatches=4)(s0, mb)[0]
        with torch.no_grad():
            mb_err = max(float(((a - b).abs() - 2e-4 * b.abs()).max())
                         for a, b in zip(m4.params.parameters(),
                                         m1.params.parameters()))
        if not mb_err <= 2e-5:
            bad.append(f"microbatches=4 differ from 1 by {mb_err}")

        # 6. The telemetry store on the card against the CPU.
        telemetry, cases = _train_telemetry()
        if telemetry["mismatched_fields"] or not telemetry["answers_equal"] \
                or "host3" not in telemetry["stragglers"] \
                or not telemetry["stragglers_equal"]:
            bad.append("telemetry on the card differs from the CPU")
        zero = [k for k in PAIR_KERNELS
                if telemetry["launches"].get(k, 0) <= 0]
        if zero:
            bad.append(f"the telemetry build never launched {zero}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cut_note = f"n_layers {cfg.n_layers} -> {TRAIN_DEPTH}, widths kept"
    out = {"phase": "train", "card": card, "full_width": full,
           "remat": remat, "f32_check": dict(f32, cut=cut_note,
                                             batch=TRAIN_CHECK_B,
                                             seq=TRAIN_CHECK_S),
           "resume": resume, "smoke": smoke, "smoke_failures": smoke_failed,
           "gd_quantizer_loss_drop": gd_drop,
           "microbatch_excess": mb_err, "telemetry": telemetry,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if bad:
        raise AssertionError(f"train phase failed: {bad}")
    _check(cases, "train_kernels")
    return out, cases


# -------------------------------------------------------------- phase 12

# The sharding phase reuses the train phase's step: qwen3-0.6b at full
# width, bf16 compute from f32 masters, remat "nothing", batch 8 x 128 of
# TokenPipeline(seed=0), its command line's hyper-parameters for 20 steps.
SHARDING_BATCH, SHARDING_SEQ, SHARDING_STEPS = 8, 128, 3
SHARDING_HYPER = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
# (a): the dry run's matmul FLOPs against the analytic count
# (dryrun.analytic_train_flops), its peak against the train phase's
# measured max_memory_allocated.
SHARDING_FLOPS_RTOL, SHARDING_PEAK_RTOL = 0.01, 0.15
# (b): the variants run on the (1, 1) mesh and on the plain path besides
# the plain step: 4 microbatches (batch 8 -> 2 rows each), GDQuantizer(8).
SHARDING_VARIANTS = {"microbatches_4": {"microbatches": 4},
                     "gd8": {"gd_bits": 8}}
# (c): qwen3-0.6b's cells of the reference's shapes (long_500k is skipped
# by shape_supported for a full-attention architecture), one process each.
SHARDING_CELLS = (("train_4k", "--single-pod"), ("prefill_32k", "--single-pod"),
                  ("decode_32k", "--single-pod"), ("decode_32k", "--multi-pod"))
# Per-device FLOPs of the cells as the dry run reads them for this tree on
# torch 2.13 (``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch
# qwen3-0.6b --shape SHAPE --single-pod|--multi-pod`` on a CPU): the
# projections' placements are stated (``layers._project``), not DTensor's
# choice, so the card's release must read the same within 1%.
DRYRUN_FLOPS = {"train_4k/single": 32_926_293_032_960,
                "decode_32k/single": 4_354_080_768,
                "decode_32k/multi": 2_177_040_384}
DRYRUN_FLOPS_RTOL = 0.01
# Per-device FLOPs and peak bytes of the cells on the card's release
# before the projections' placements were stated (the query heads already
# sharded): none may read more; the decode cells' peaks stay within 1%.
# The decode cells' peaks are read with each storage counted once (a
# collective's wrapped result is its input in eager, where the fake kernel
# of ``_wrap_tensor_autograd`` makes a new tensor): 2,847,329,312 and
# 1,907,805,200 B with it counted twice.
EARLIER_CELLS = {"train_4k/single": (7.622e13, 8_138_772_234),
                 "prefill_32k/single": (35_668_629_651_456, 3_186_494_464),
                 "decode_32k/single": (5.235e9, 2_536_164_384),
                 "decode_32k/multi": (2.617e9, 1_596_640_272)}


# Per-device FLOPs and peak bytes of the cells on the card's release once
# the projections' placements were stated, before the MoE's were:
# qwen3-0.6b has no MoE and its remat policy is "nothing", so each must
# stay within 1%. train_4k's peak is the card's reading once the loss
# upcast the logits a block of rows at a time (7,817,913,354 B before, an
# f32 copy of the logits and the eager backward's temporaries); the decode
# cells' with each storage counted once (``EARLIER_CELLS``).
PROJECTION_CELLS = {
    "train_4k/single": (32_926_293_032_960, 3_265_901_834),
    "prefill_32k/single": (35_668_629_651_456, 1_997_016_064),
    "decode_32k/single": (4_354_080_768, 2_536_164_384),
    "decode_32k/multi": (2_177_040_384, 1_596_640_272)}
PROJECTION_CELLS_RTOL = 0.01
# (b) also runs these smoke configs on the (1, 1) mesh and on the plain
# path: the sort dispatch's MoE and the blk_out remat policy.
SHARDING_CONFIGS = {"deepseek_moe_sort": ("deepseek-moe-16b",
                                          {"moe_impl": "sort"}),
                    "qwen3_blk_out": ("qwen3-0.6b",
                                      {"remat_policy": "blk_out"}),
                    "mamba2": ("mamba2-1.3b", {}),
                    "recurrentgemma": ("recurrentgemma-9b", {})}
# (d): one MoE layer's per-device FLOPs of train_4k on (16, 16) (2 layers'
# tally minus 1's; deepseek-moe's first layer is dense) as torch 2.13
# reads them for this tree, each equal to the count of the reference's
# placements (``tests/test_torch_sharded_moe.py::
# reference_moe_layer_flops``); keyed "arch" or "arch/variant".
MOE_LAYER_FLOPS = {"dbrx-132b": 43_193_412_354_048,
                   "dbrx-132b/moe_sort": 37_008_659_447_808,
                   "deepseek-moe-16b": 7_357_278_978_048,
                   "deepseek-moe-16b/moe_sort": 3_749_506_449_408}
MOE_LAYER_RTOL = 0.01
# Products over every expert slot (E x C) that a rank must not run: the
# parent tree's combine ran deepseek-moe's 64 x 480 slots on every rank.
# (dbrx's 16 x 1280 equals its rank's batch rows x C, so not checked.)
MOE_WHOLE_SLOTS = {"deepseek-moe-16b": 64 * 480}
# (d): one recurrent layer's per-device FLOPs of train_4k on (16, 16) (2
# layers' tally minus 1's) and the 2-layer cell's, as torch 2.13 reads them
# for this tree (the layer's equal to the count of the reference's
# placements, ``tests/test_torch_sharded_recurrent.py::
# reference_layer_flops``); keyed "arch" or "arch/variant". Before the
# SSD's and RG-LRU's placements were stated the card's torch read
# recurrentgemma's 2-layer cell at 1.202x and mamba2's zero_r at 2.006x
# its base cell.
RECURRENT_LAYER_FLOPS = {
    "mamba2-1.3b": (863_288_426_496, 4_257_252_114_432),
    "mamba2-1.3b/zero_r": (863_288_426_496, 4_257_252_114_432),
    "recurrentgemma-9b": (7_696_581_394_432, 40_750_649_704_448),
    "recurrentgemma-9b/remat_dots": (5_772_436_045_824, 37_314_675_867_648)}
RECURRENT_LAYER_RTOL = 0.01
# (d): the most bytes a device may hold at the peak of the base recurrent
# cells of train_4k on (16, 16), (1 layer, the 2-layer cell): the RG-LRU's
# scan on each rank's rows and channels and the loss's tail with no f32
# copy of the logits. recurrentgemma-9b's are torch 2.13's readings with
# the scan alone repaired, mamba2-1.3b's 1.15x the reference's head at full
# width; before, 89,548,582,922 / 119.17 GB and 66,096,114,698 / 66.11 GB.
RECURRENT_LAYER_PEAK = {"mamba2-1.3b": (30_490_966_315, 30_490_966_315),
                        "recurrentgemma-9b": (13_000_899_594,
                                              13_035_616_266)}
# (d): the reference's per-device peak (``memory_analysis()``: arguments,
# outputs and temporaries less aliases) of each case of
# ``scripts/torch_narrow_sharding.py``, compiled on a (2, 4) mesh of XLA
# CPU devices (mamba2-1.3b's head and three archs' attention at full width
# on (16, 16)) by ``python tests/test_torch_sharded_recurrent.py`` (the
# card machine has no JAX); the port's must stay within NARROW_PEAK_RATIO
# of it, the SSD's within NARROW_SSM_PEAK_RATIO. The MoE's cases read up
# to 1.58x (einsum dispatch) and 1.30x (sort) before each expert weight was
# gathered inside its product and the dispatched rows were no longer held
# scaled; gemma2's attention up to 1.22x before K and V were laid out once
# for every query chunk.
NARROW_REFERENCE_PEAKS = {
    "ssm/base/params": 2_664_168,
    "ssm/base/params_x": 2_768_624,
    "ssm/zero_r/params": 2_713_320,
    "ssm/zero_r/params_x": 2_776_816,
    "ssm/seq_sp/params": 2_664_168,
    "ssm/seq_sp/params_x": 2_768_624,
    "rec/base/params": 750_344,
    "rec/base/params_x": 797_072,
    "rec/zero_r/params": 733_960,
    "rec/zero_r/params_x": 780_688,
    "rec/seq_sp/params": 750_344,
    "rec/seq_sp/params_x": 797_072,
    "router/base/params": 41_040,
    "router/base/params_x": 103_008,
    "router/zero_r/params": 89_168,
    "router/zero_r/params_x": 151_648,
    "router/seq_sp/params": 41_040,
    "router/seq_sp/params_x": 103_008,
    "head512/base/params": 378_000,
    "head512/base/params_x": 394_920,
    "head512/zero_r/params": 378_000,
    "head512/zero_r/params_x": 394_920,
    "head512/seq_sp/params": 378_004,
    "head512/seq_sp/params_x": 460_136,
    "head514/base/params": 823_440,
    "head514/base/params_x": 826_536,
    "head514/zero_r/params": 823_440,
    "head514/zero_r/params_x": 826_536,
    "head514/seq_sp/params": 1_069_972,
    "head514/seq_sp/params_x": 1_102_888,
    "moe_einsum/base/params": 563_008,
    "moe_einsum/base/params_x": 714_632,
    "moe_einsum/zero_r/params": 608_064,
    "moe_einsum/zero_r/params_x": 764_104,
    "moe_einsum/seq_sp/params": 563_008,
    "moe_einsum/seq_sp/params_x": 714_632,
    "moe_sort/base/params": 1_047_040,
    "moe_sort/base/params_x": 1_152_072,
    "moe_sort/zero_r/params": 1_096_128,
    "moe_sort/zero_r/params_x": 1_302_536,
    "moe_sort/seq_sp/params": 983_232,
    "moe_sort/seq_sp/params_x": 1_090_312,
    "attention/base/params": 725_728,
    "attention/base/params_x": 824_104,
    "attention/zero_r/params": 694_944,
    "attention/zero_r/params_x": 793_320,
    "attention/seq_sp/params": 1_233_568,
    "attention/seq_sp/params_x": 1_348_328,
    "mlp/base/params": 647_216,
    "mlp/base/params_x": 794_744,
    "mlp/zero_r/params": 630_832,
    "mlp/zero_r/params_x": 778_360,
    "mlp/seq_sp/params": 647_216,
    "mlp/seq_sp/params_x": 745_656,
    "attention_gemma2/base/params": 1_817_760,
    "attention_gemma2/base/params_x": 2_079_912,
    "attention_gemma2/zero_r/params": 1_817_696,
    "attention_gemma2/zero_r/params_x": 2_030_696,
    "attention_gemma2/seq_sp/params": 1_867_056,
    "attention_gemma2/seq_sp/params_x": 2_129_208,
    "full/mamba2-1.3b/base": 26_513_883_752,
    "full/mamba2-1.3b/zero_r": 26_513_883_752,
    "full/mamba2-1.3b/seq_sp": 27_312_492_584,
    "full/attention_gemma2-2b/base": 43_065_803_744,
    "full/attention_minitron-4b/base": 71_848_428_240,
    "full/attention_musicgen-medium/base": 71_362_413_136}
NARROW_PEAK_RATIO, NARROW_SSM_PEAK_RATIO = 1.15, 0.90
# Operands that span a dim the reference splits: mamba2's whole in_proj
# width (8,512) or d_inner (4,096); a whole d_model x rnn_width block of
# recurrentgemma's (its d_model is 4,096 too, so only the pair).
RECURRENT_WHOLE = {"mamba2-1.3b": {"dims": (8512, 4096)},
                   "recurrentgemma-9b": {"shapes": ((4096, 4096),)}}
# (d): dry-run variants that must run ok at 2 layers (on torch 2.11 the
# last two raised at the logits and at the tied table's gradient before).
SHARDING_VARIANT_CELLS = (("qwen3-0.6b", "remat_names"),
                          ("deepseek-moe-16b", "combo"),
                          ("mamba2-1.3b", "ssm_mem"))


def _child(fn: str, *args) -> subprocess.Popen:
    """``fn(*args)`` of this module in a fresh Python process: the dry
    run's fake process group and the card's NCCL group never share one,
    and the CPU-bound traces run side by side. One intra-op thread each."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as c; c.{fn}(*{args!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def sharding_predict(path: str) -> None:
    """(a), in a child: the train phase's step dry-run on a one-device
    (data=1, model=1) mesh; its record and the analytic FLOPs to
    ``path``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    cfg = get_config(LM_ARCH)
    t = time.perf_counter()
    with D.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        res = D.trace_cell(cfg, {"kind": "train", "seq": SHARDING_SEQ,
                                 "batch": SHARDING_BATCH},
                           mesh, D.arch_rules(cfg, 1))
    res["trace_s"] = time.perf_counter() - t
    res["analytic_flops"] = D.analytic_train_flops(cfg, SHARDING_BATCH,
                                                   SHARDING_SEQ)
    Path(path).write_text(json.dumps(res))


def _sharding_run(cfg, mesh, step_kw: dict) -> dict:
    """SHARDING_STEPS steps of qwen3-0.6b from seed 0 under deterministic
    algorithms, as the loop runs them: on ``mesh`` (installed, the state
    sharded, each batch ``shard_batch``ed) or, with ``mesh`` None, the
    plain path; ``step_kw`` may hold ``microbatches`` and ``gd_bits`` (a
    ``GDQuantizer``, whose error feedback is made after the state is
    sharded). Returns the losses,
    step ms, peak memory, parameter types and the parameters on the
    host."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.sharding import set_mesh
    from repro_torch.train.grad_compress import (GDQuantizer,
                                                make_compressing_hook)
    from repro_torch.train.loop import deterministic_algorithms, shard_batch
    from repro_torch.train.optimizer import Hyper
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)
    set_mesh(mesh, None if mesh is None else arch_rules(cfg, 1))
    pipe = TokenPipeline(cfg.vocab, SHARDING_BATCH, SHARDING_SEQ, seed=0)
    state = init_train_state(cfg, torch.Generator("cuda").manual_seed(0))
    if mesh is not None:
        state = shard_state(state)
    hook = None
    if "gd_bits" in step_kw:
        codec = GDQuantizer(step_kw["gd_bits"])
        hook = make_compressing_hook(codec, {"err": codec.init(state.params)})
    step = make_train_step(cfg, Hyper(**SHARDING_HYPER), compressor=hook,
                           microbatches=step_kw.get("microbatches", 1))
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with deterministic_algorithms():
        for i in range(SHARDING_STEPS):
            t = time.perf_counter()
            b = {k: torch.from_numpy(v).cuda()
                 for k, v in pipe.host_slice(i).items()}
            if mesh is not None:
                b = shard_batch(b, mesh, SHARDING_BATCH, SHARDING_SEQ)
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
    out = {"losses": losses, "step_ms": times,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "param_types": sorted({type(p).__name__ for p in
                                  state.params.parameters()}),
           "params": {n: (p.full_tensor() if hasattr(p, "full_tensor")
                          else p).detach().cpu()
                      for n, p in state.params.named_parameters()}}
    set_mesh(None)
    del state, step, hook
    torch.cuda.empty_cache()
    return out


def _sharding_compare(mesh_run: dict, plain_run: dict) -> dict:
    """Whether two runs' parameters are equal (``torch.equal``), with the
    largest differences where not; pops both runs' parameters."""
    import torch
    a, b = mesh_run.pop("params"), plain_run.pop("params")
    diff = {n: float((a[n].double() - b[n].double()).abs().max())
            for n in b if not torch.equal(a[n], b[n])}
    return {"equal": not diff, "unequal_tensors": len(diff),
            "worst": sorted(diff.items(), key=lambda kv: -kv[1])[:4],
            "losses_equal": mesh_run["losses"] == plain_run["losses"]}


def sharding_mesh_step(path: str, port: int) -> None:
    """(b), in a child: one NCCL rank, a (data=1, model=1) mesh installed,
    the state sharded (every parameter and moment a DTensor, every
    ``constrain`` a redistribute on the card), SHARDING_STEPS steps; then
    the same steps of the plain path from the same seed. Both under
    deterministic algorithms, as the loop runs them. Then the same pair
    for each of SHARDING_VARIANTS (microbatches; a gradient codec) and
    for each smoke config of SHARDING_CONFIGS. The parameters are
    compared on the host; the result goes to ``path``."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    torch.cuda.set_device(0)
    cfg = get_config(LM_ARCH)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        out = {"mesh": _sharding_run(cfg, mesh, {}),
               "plain": _sharding_run(cfg, None, {})}
        out.update(_sharding_compare(out["mesh"], out["plain"]))
        out["variants"] = {}
        for name, step_kw in SHARDING_VARIANTS.items():
            runs = {label: _sharding_run(cfg, m, step_kw)
                    for label, m in (("mesh", mesh), ("plain", None))}
            out["variants"][name] = dict(runs, **_sharding_compare(
                runs["mesh"], runs["plain"]))
        out["configs"] = {}
        for name, (arch, over) in SHARDING_CONFIGS.items():
            smoke = dataclasses.replace(get_config(arch, smoke=True), **over)
            runs = {label: _sharding_run(smoke, m, {})
                    for label, m in (("mesh", mesh), ("plain", None))}
            out["configs"][name] = dict(runs, **_sharding_compare(
                runs["mesh"], runs["plain"]))
    finally:
        dist.destroy_process_group()
    Path(path).write_text(json.dumps(out))


def _wait(proc: subprocess.Popen, label: str, timeout: float) -> str:
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise TimeoutError(f"sharding: {label} did not finish in {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"sharding: {label} exited {proc.returncode}:\n"
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
    return stdout


def _sharding_scripts() -> dict:
    """(d)'s children: ``{label: argv}`` of the repository's scripts, the
    per-layer tallies of MOE_LAYER_FLOPS and RECURRENT_LAYER_FLOPS and the
    variant cells."""
    script = {}
    for kind, keys in (("layer", MOE_LAYER_FLOPS),
                       ("recurrent", RECURRENT_LAYER_FLOPS)):
        for key in keys:
            arch, _, variant = key.partition("/")
            script[f"{kind} {key}"] = [
                "scripts/torch_dryrun_flops.py", "--arch", arch, "--shape",
                "train_4k", "--per-layer", "--top", "1000"] + (
                ["--variant", variant] if variant else [])
    script["narrow peaks"] = ["scripts/torch_narrow_sharding.py"]
    for arch, variant in SHARDING_VARIANT_CELLS:
        script[f"variant {arch}/{variant}"] = [
            "scripts/torch_dryrun_sweep.py", "--arch", arch, "--shape",
            "train_4k", "--single-pod", "--variants", variant, "--layers",
            "2"]
    return script


def _tally_shapes(key: str) -> list:
    """The operand shapes of a tally key ``"op ((a, b), (c, d))"``."""
    return [tuple(s) for s in json.loads(
        key.split(" ", 1)[1].replace("(", "[").replace(")", "]")
        .replace(",]", "]"))]


def _sharding_recurrent(key: str, rec: dict, bad: list) -> dict:
    """(d)'s record of one recurrent layer's tally ``rec``; failed checks
    appended to ``bad``."""
    if not rec.get("ok"):
        bad.append(f"recurrent layer {key} failed: {rec.get('error')}")
        return {"layer": key, "ok": False, "error": rec.get("error")}
    want, want_cell = RECURRENT_LAYER_FLOPS[key]
    whole = RECURRENT_WHOLE[key.partition("/")[0]]
    wide = [k for k in rec["by_op"] if any(
        set(whole.get("dims", ())) & set(s) or s in whole.get("shapes", ())
        for s in _tally_shapes(k))]
    cell = rec["cell"]["flops"]
    out = {"layer": key, "ok": True, "flops_per_device": rec["flops"],
           "flops_torch_2_13": want,
           "flops_vs_torch_2_13": rec["flops"] / want,
           "cell_flops_per_device": cell, "cell_flops_torch_2_13": want_cell,
           "cell_flops_vs_torch_2_13": cell / want_cell,
           "cell_peak_bytes": rec["cell"]["peak_bytes"],
           "cell_wire_bytes_by_kind": rec["cell"]["wire_bytes"],
           "peak_bytes": rec["peak_bytes"],
           "wire_bytes_by_kind": rec["wire_bytes"],
           "whole_dim_products": wide,
           "top": dict(list(rec["by_op"].items())[:4])}
    if abs(rec["flops"] / want - 1) > RECURRENT_LAYER_RTOL:
        bad.append(f"recurrent layer {key}: {rec['flops']} FLOPs against "
                   f"{want} on torch 2.13")
    if abs(cell / want_cell - 1) > RECURRENT_LAYER_RTOL:
        bad.append(f"recurrent cell {key}: {cell} FLOPs against "
                   f"{want_cell} on torch 2.13")
    if wide:
        bad.append(f"recurrent layer {key} multiplies a whole dim that the "
                   f"reference splits: {wide}")
    if key in RECURRENT_LAYER_PEAK:
        peaks = (rec["cell"]["peak_bytes"] - rec["peak_bytes"],
                 rec["cell"]["peak_bytes"])
        out.update(one_layer_peak_bytes=peaks[0],
                   peak_bound_bytes=RECURRENT_LAYER_PEAK[key])
        for layers, peak, bound in zip((1, 2), peaks,
                                       RECURRENT_LAYER_PEAK[key]):
            if peak > bound:
                bad.append(f"recurrent cell {key} at {layers} layer(s): "
                           f"peak {peak} B above {bound}")
    return out


def _sharding_narrow(log: str, bad: list) -> list:
    """(d)'s narrow peaks: each case's line of ``scripts/
    torch_narrow_sharding.py`` (``log``) against NARROW_REFERENCE_PEAKS;
    failed checks appended to ``bad``."""
    rows = []
    for line in log.strip().splitlines():
        rec = json.loads(line)
        want = NARROW_REFERENCE_PEAKS[rec["case"]]
        bound = NARROW_SSM_PEAK_RATIO if rec["case"].startswith("ssm/") \
            else NARROW_PEAK_RATIO
        rows.append({"case": rec["case"], "peak_bytes": rec["peak_bytes"],
                     "reference_peak_bytes": want,
                     "peak_ratio": rec["peak_bytes"] / want})
        if rec["peak_bytes"] > bound * want:
            bad.append(f"narrow {rec['case']}: peak {rec['peak_bytes']} B, "
                       f"{rec['peak_bytes'] / want:.3f}x the reference's")
    return rows


def _sharding_layers(logs: dict, out_dir: Path, bad: list) -> tuple:
    """(d)'s records from the children's output (``logs`` by label), each
    also written to ``out_dir``; failed checks appended to ``bad``.
    Returns (MoE layers, recurrent layers, variant cells)."""
    moe_layers, recurrent_layers, variant_cells = [], [], []
    for label in _sharding_scripts():
        if label == "narrow peaks":
            continue
        rec = json.loads(logs[label].strip().splitlines()[-1])
        (out_dir / (label.replace(" ", "_").replace("/", "__")
                    + ".json")).write_text(json.dumps(rec))
        kind, key = label.split(" ")
        if kind == "recurrent":
            recurrent_layers.append(_sharding_recurrent(key, rec, bad))
            continue
        if kind == "variant":
            variant_cells.append({"cell": key, "ok": rec.get("ok"),
                                  "error": rec.get("error"),
                                  "flops_per_device": rec.get("flops"),
                                  "peak_bytes": rec.get("peak_bytes"),
                                  "trace_s": rec.get("trace_s")})
            if not rec.get("ok"):
                bad.append(f"variant {key} failed: {rec.get('error')}")
            continue
        if not rec.get("ok"):
            bad.append(f"MoE layer {key} failed: {rec.get('error')}")
            moe_layers.append({"layer": key, "ok": False,
                               "error": rec.get("error")})
            continue
        want = MOE_LAYER_FLOPS[key]
        slots = MOE_WHOLE_SLOTS.get(key.partition("/")[0])
        whole = [k for k in rec["by_op"] if slots is not None and
                 str(slots) in k.replace(",", " ").replace("(", " ")
                 .replace(")", " ").split()]
        moe_layers.append({"layer": key, "ok": True,
                           "flops_per_device": rec["flops"],
                           "flops_torch_2_13": want,
                           "flops_vs_torch_2_13": rec["flops"] / want,
                           "peak_bytes": rec["peak_bytes"],
                           "wire_bytes_by_kind": rec["wire_bytes"],
                           "whole_slot_products": whole,
                           "top": dict(list(rec["by_op"].items())[:4])})
        if abs(rec["flops"] / want - 1) > MOE_LAYER_RTOL:
            bad.append(f"MoE layer {key}: {rec['flops']} FLOPs against "
                       f"{want} on torch 2.13")
        if whole:
            bad.append(f"MoE layer {key} multiplies all {slots} expert "
                       f"slots: {whole}")
    return moe_layers, recurrent_layers, variant_cells


def phase_sharding(card: str, train_out: dict) -> dict:
    """(a) the dry run's prediction of the train phase's step against its
    measurement; (b) the step on a (1, 1) mesh, DTensors on the card,
    against the plain step; (c) qwen3-0.6b's reference cells dry-run on
    the production meshes (256 and 512 fake ranks) and the roofline suite
    on them; (d) the MoE and recurrent layers' per-device tallies and the
    MoE and remat variants on (16, 16). Every part runs in child processes
    side by side."""
    import os
    import socket
    from repro_torch.bench import run as bench_run
    from repro_torch.bench.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
    from repro_torch.launch.dryrun import cell_path
    t_phase = time.perf_counter()
    out_dir = OUT_DIR / "sharding"
    out_dir.mkdir(parents=True, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = {"predict": _child("sharding_predict",
                               str(out_dir / "predict.json")),
             "mesh_step": _child("sharding_mesh_step",
                                 str(out_dir / "mesh_step.json"), port)}
    cell_of = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for shape, mesh in SHARDING_CELLS:
        label = f"{shape}{mesh.replace('-pod', '').replace('--', '/')}"
        cell_of[label] = (shape, mesh)
        procs[label] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             LM_ARCH, "--shape", shape, mesh, "--force"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    script = _sharding_scripts()
    for label, argv in script.items():
        procs[label] = subprocess.Popen(
            [sys.executable] + argv, cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs, failed = {}, []
    try:
        for label, p in procs.items():
            try:
                logs[label] = _wait(p, label, 600)
            except (AssertionError, TimeoutError) as exc:
                failed.append(str(exc))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for shape, mesh in SHARDING_CELLS:
        name = "multi_pod" if mesh == "--multi-pod" else "single_pod"
        src = Path(cell_path(LM_ARCH, shape, name))
        if src.exists():
            (out_dir / src.name).write_text(src.read_text())
    if failed:
        raise AssertionError("\n".join(failed))
    bad = []
    pred = json.loads((out_dir / "predict.json").read_text())
    measured = train_out["full_width"]["max_memory_allocated"]
    peak = pred["memory_analysis"]["peak_bytes"]
    flops = pred["cost_analysis"]["flops"]
    predict = {"peak_bytes": peak, "measured_peak_bytes": measured,
               "peak_rel": peak / measured - 1,
               "flops": flops, "analytic_flops": pred["analytic_flops"],
               "flops_rel": flops / pred["analytic_flops"] - 1,
               "memory_analysis": pred["memory_analysis"],
               "bytes_accessed": pred["cost_analysis"]["bytes accessed"],
               "trace_s": pred["trace_s"]}
    if abs(predict["flops_rel"]) > SHARDING_FLOPS_RTOL:
        bad.append(f"dry-run FLOPs {flops} vs analytic "
                   f"{pred['analytic_flops']}")
    if abs(predict["peak_rel"]) > SHARDING_PEAK_RTOL:
        bad.append(f"dry-run peak {peak} vs measured {measured}")
    step = json.loads((out_dir / "mesh_step.json").read_text())
    if not step["equal"]:
        bad.append(f"(1, 1)-mesh step differs from the plain step: "
                   f"{step['worst']}")
    if step["mesh"]["param_types"] != ["DTensor"]:
        bad.append(f"mesh parameters are {step['mesh']['param_types']}")
    for name, var in step["variants"].items():
        if not var["equal"]:
            bad.append(f"(1, 1)-mesh step with {name} differs from the "
                       f"plain one: {var['worst']}")
        if var["mesh"]["param_types"] != ["DTensor"]:
            bad.append(f"{name}: mesh parameters are "
                       f"{var['mesh']['param_types']}")
    for name, pair in step["configs"].items():
        if not pair["equal"]:
            bad.append(f"(1, 1)-mesh step of {name} differs from the plain "
                       f"one: {pair['worst']}")
        if pair["mesh"]["param_types"] != ["DTensor"]:
            bad.append(f"{name}: mesh parameters are "
                       f"{pair['mesh']['param_types']}")
    moe_layers, recurrent_layers, variant_cells = _sharding_layers(
        logs, out_dir, bad)
    narrow = _sharding_narrow(logs["narrow peaks"], bad)
    (out_dir / "narrow_peaks.json").write_text(json.dumps(narrow))
    emit({"phase": "sharding_narrow_peaks",
          "peak_ratio": {r["case"]: r["peak_ratio"] for r in narrow}})
    if bench_run.main(["--only", "roofline", "--out",
                       str(OUT_DIR / "bench")]) != 0:
        bad.append("the roofline suite failed")
    cells = []
    for label, (shape, mesh) in cell_of.items():
        name = "multi_pod" if mesh == "--multi-pod" else "single_pod"
        rec = json.loads(Path(cell_path(LM_ARCH, shape, name)).read_text())
        if not rec.get("ok"):
            bad.append(f"cell {label} failed: {rec.get('error')}")
            cells.append({"cell": label, "ok": False,
                          "error": rec.get("error")})
            continue
        coll = rec["collectives"]
        wire = sum(v["wire_bytes_per_device"] for v in coll.values())
        terms = {"compute": rec["cost_analysis"]["flops"] / PEAK_FLOPS,
                 "memory": rec["cost_analysis"]["bytes accessed"] / HBM_BW,
                 "collective": wire / LINK_BW}
        cells.append({
            "cell": label, "ok": True, "mesh": rec["mesh"],
            "flops_per_device": rec["cost_analysis"]["flops"],
            "bytes_per_device": rec["cost_analysis"]["bytes accessed"],
            "wire_bytes_by_kind": {k: v["wire_bytes_per_device"]
                                   for k, v in coll.items()},
            "peak_bytes": rec["memory_analysis"]["peak_bytes"],
            "trace_s": rec["trace_s"], "terms_s": terms,
            "dominant": max(terms, key=terms.get)})
        flops, peak = (rec["cost_analysis"]["flops"],
                       rec["memory_analysis"]["peak_bytes"])
        was_flops, was_peak = EARLIER_CELLS[label]
        cells[-1].update(earlier_flops=was_flops, earlier_peak_bytes=was_peak,
                         flops_vs_earlier=flops / was_flops,
                         peak_vs_earlier=peak / was_peak)
        if flops > was_flops or peak > was_peak:
            bad.append(f"cell {label}: {flops} FLOPs, {peak} B peak "
                       f"against {was_flops}, {was_peak} before")
        if shape == "decode_32k" and abs(peak / was_peak - 1) > 0.01:
            bad.append(f"cell {label}: peak {peak} B against {was_peak}")
        proj_flops, proj_peak = PROJECTION_CELLS[label]
        cells[-1].update(flops_vs_projections=flops / proj_flops,
                         peak_vs_projections=peak / proj_peak)
        if abs(flops / proj_flops - 1) > PROJECTION_CELLS_RTOL or \
                abs(peak / proj_peak - 1) > PROJECTION_CELLS_RTOL:
            bad.append(f"cell {label}: {flops} FLOPs, {peak} B peak "
                       f"against {proj_flops}, {proj_peak} before the "
                       f"MoE's placements")
        if label in DRYRUN_FLOPS:
            want = DRYRUN_FLOPS[label]
            cells[-1].update(dryrun_flops_torch_2_13=want,
                             flops_vs_torch_2_13=flops / want)
            if abs(flops / want - 1) > DRYRUN_FLOPS_RTOL:
                bad.append(f"cell {label}: {flops} FLOPs against {want} "
                           f"on torch 2.13")
    out = {"phase": "sharding", "card": card, "arch": LM_ARCH,
           "batch": SHARDING_BATCH, "seq": SHARDING_SEQ, "predict": predict,
           "mesh_step": step, "cells": cells, "moe_layers": moe_layers,
           "recurrent_layers": recurrent_layers,
           "narrow_peaks": narrow, "variant_cells": variant_cells,
           "dryrun_log": {k: v.strip().splitlines()[-1:] for k, v in
                          logs.items() if k in cell_of},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if bad:
        raise AssertionError(f"sharding phase failed: {bad}")
    return out


# -------------------------------------------------------------- phase 13

# The port's smoke lanes, each in a child on the card with its time limit,
# and the kernels each must launch there: the servers' waves K1, their
# tables' single AND queries K2 (``FastPath``), the GD lane's builds K3/K4.
LANES = {
    "torch_trace_smoke": ("batched_weightings",),
    "torch_plan_smoke": ("batched_weightings", "fused_weightings"),
    "torch_gd_smoke": ("batched_hist2d", "batched_subbin_hist"),
    "torch_chaos_smoke": ("batched_weightings", "fused_weightings"),
}
LANE_TIMEOUT_S = 60
# The example run on the card after the lanes.
LANE_EXAMPLE = "examples/torch_quickstart.py"


def _lane(path: str, timeout: float) -> dict:
    """``path`` (a script of the repository) in a child on the card, killed
    after ``timeout`` s: its exit code, wall time, output lines and, where
    its last line is ``{"launches": ...}``, the kernel launches it made."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cwd = OUT_DIR / "lanes"
    cwd.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(ROOT / path)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"lane": path, "rc": None, "wall_s": timeout,
                "error": f"did not finish in {timeout} s"}
    lines = proc.stdout.strip().splitlines()
    launches = {}
    if lines and lines[-1].startswith('{"launches"'):
        launches = json.loads(lines.pop())["launches"]
    out = {"lane": path, "rc": proc.returncode,
           "wall_s": time.perf_counter() - t, "checks": lines,
           "launches": launches}
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-3000:]
    return out


def phase_lanes() -> list:
    """The four ``scripts/torch_*_smoke.py`` lanes on the card (servers in
    ``"cuda"`` mode), one after another (the trace lane's overhead gate and
    the chaos lane's deadline are timings), then ``LANE_EXAMPLE``: each must
    exit 0, its own gates passed, and launch its kernels. One JSON line per
    lane."""
    t_phase = time.perf_counter()
    bad, outs = [], []
    runs = [(f"scripts/{name}.py", kinds) for name, kinds in LANES.items()]
    for path, kinds in runs + [(LANE_EXAMPLE, ())]:
        out = _lane(path, LANE_TIMEOUT_S)
        emit(dict(out, phase="lanes"))
        outs.append(out)
        if out["rc"] != 0:
            bad.append(f"{path}: exit {out['rc']} {out.get('error', '')}")
        missing = [k for k in kinds if not out.get("launches", {}).get(k)]
        if missing:
            bad.append(f"{path}: launched no {missing}")
    emit({"phase": "lanes", "seconds": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError(f"lanes phase failed: {bad}")
    return outs


# -------------------------------------------------------------- phase 14

# The greedygd phase's tables: the rolling month (31 days of 15,943 rows, as
# the benchmark's ``flights_rolling`` holds) and 500,000 rows of the
# benchmark's ``flights`` and ``power``, each drawn from a seed of its own.
GD_MONTH_DAYS, GD_DAY_ROWS, GD_ROWS = 31, 15_943, 500_000
GD_FIELDS = ("bases", "base_ids", "base_bits", "total_bits", "null_mask",
             "sentinels")


def _gd_tables() -> dict:
    """The greedygd phase's pre-processed matrices by name."""
    import numpy as np
    from aqpbench.tables import flights, flights_day, power
    from repro_torch.gd.preprocess import preprocess_table
    days = [flights_day.make(GD_DAY_ROWS, 35_000 + j, j)
            for j in range(GD_MONTH_DAYS)]
    month = {k: np.concatenate([d[k] for d in days]) for k in days[0]}
    return {"rolling_month": preprocess_table(month).data,
            "flights": preprocess_table(flights.make(GD_ROWS, 35_100)).data,
            "power": preprocess_table(power.make(GD_ROWS, 35_200)).data}


def _gd_run(gd, data) -> tuple:
    """``gd.compress(data)`` on a timeline of its own: the table, each
    span's seconds and the counters' totals."""
    from repro_torch.obs.timeline import BuildTimeline
    tl = BuildTimeline()
    with tl.phase("gd_compress"):
        ct = gd.compress(data)
    return ct, tl.summary(), tl.totals()


def compressed_diffs(a, b) -> list:
    """The ``CompressedTable`` fields in which two tables differ in value,
    dtype or shape."""
    import numpy as np

    def same(x, y):
        return (x.dtype, x.shape) == (y.dtype, y.shape) and \
            np.array_equal(x, y)
    diffs = [f for f in GD_FIELDS if not same(getattr(a, f), getattr(b, f))]
    if len(a.deviations) != len(b.deviations) or \
            not all(map(same, a.deviations, b.deviations)):
        diffs.append("deviations")
    return diffs


def phase_greedygd() -> list:
    """GreedyGD on the card against the same code on this machine's CPU,
    which the CPU tests hold bit for bit against the reference package:
    the fields apart (none may be), each span's seconds on both sides (the
    card's from its second run) and the card's peak allocated bytes over
    a compress."""
    import torch
    from repro_torch.gd.greedygd import GreedyGD
    card, oracle = GreedyGD(device="cuda"), GreedyGD(device="cpu")
    t_phase = time.perf_counter()
    outs, bad = [], []
    for name, data in _gd_tables().items():
        _gd_run(card, data)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got, spans, counts = _gd_run(card, data)
        peak = torch.cuda.max_memory_allocated() - base
        want, oracle_spans, _ = _gd_run(oracle, data)
        diffs = compressed_diffs(got, want)
        out = {"phase": "greedygd", "table": name, "rows": data.shape[0],
               "d": data.shape[1], "bases": got.bases.shape[0],
               "base_bits": got.base_bits.tolist(),
               "total_bits": int(got.total_bits.sum()),
               "card_s": spans, "cpu_s": oracle_spans,
               "card_counts": counts, "card_peak_bytes": peak,
               "peak_bytes_per_cell": peak / data.size,
               "mismatched_fields": diffs}
        emit(out)
        outs.append(out)
        if diffs:
            bad.append(f"{name}: {diffs}")
    emit({"phase": "greedygd", "seconds": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError(f"greedygd phase failed: {bad}")
    return outs


# --------------------------------------------------------------------- main


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main and serve phases' runs with "
                         "torch.profiler (device busy time and idle share "
                         "per span)")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        info = phase_device()
        phase_build()
        cases = phase_kernels()
        main_out = phase_main(args.profile)
        serve_out = phase_serve(main_out, info["nvidia_smi"], args.profile)
        cases = cases + phase_schedulers(main_out)
        phase_parity()
        ranks = phase_sharded()
        bench_launches = phase_bench()
        phase_lm(info["nvidia_smi"])
        train_out, train_cases = phase_train(info["nvidia_smi"])
        cases = cases + train_cases
        phase_sharding(info["nvidia_smi"], train_out)
        lanes = phase_lanes()
        phase_greedygd()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    # Reported shapes: K1/K2 on the main path's own wave inputs, K3/K4 on
    # the main path's own first launches (both ``shape`` "main"); K5 at the
    # bench's 100,000 rows x 256 x 256, fp32 weights. max_abs_err is the
    # largest over every case of the kernel. K1/K2's launches are those of
    # the main phase and the serve phase; K3/K4's those of the main phase
    # and the train phase's telemetry build; K5's those of the sharded
    # ranks and the bench; each adds the lanes' own (their processes').
    cases = cases + main_out["kernel_cases"]
    report = {c["name"]: c for c in cases if c.get("shape") == "main"}
    for c in cases:
        if c["name"] == "hist2d" and c.get("n") == 100_000 and \
                c.get("weights") == "f32":
            report[c["name"]] = c
    launches = dict(main_out["launches"],
                    hist2d=bench_launches + sum(r["launches"] for r in ranks))
    for name, n in serve_out["kernel_launches"].items():
        launches[name] += n
    for name, n in train_out["telemetry"]["launches"].items():
        launches[name] += n
    for lane in lanes:
        for name, n in lane.get("launches", {}).items():
            launches[name] += n
    kernels = []
    for name in TPU_KERNELS:
        c = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["name"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
