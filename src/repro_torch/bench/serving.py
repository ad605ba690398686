"""Serving-layer throughput on the port: the batched multi-table
``AQPServer`` vs one-at-a-time queries.

    run(rows, quick=False, device=None, out_dir=None, trace=False)

Workload model: serving traffic is a Zipf-weighted stream over a pool of
*templated* queries against two registered tables — a handful of query
templates (fixed aggregate + predicate column set), many literal variants,
with popular queries repeated (dashboard / public-endpoint traffic). Every
variant of a template lands in the same fused launch group. Compared:

  * baseline — the stream one at a time through ``AQPFramework.query``
    (parse + plan + host NumPy weightings per call, no caching);
  * server — ``AQPServer.query_batch`` at batch sizes 1/8/64: plan and
    result caches and one fused weightings launch per plan-shape group per
    wave.

Reported: queries/sec per batch size, the speedup at batch 64, cache hit
rates, a cold sweep (every query distinct) isolating the batching win from
the caching win, and explicit ``fused_ref`` rows (the fused path's plain
version, ``mode="ref"``). The server's mode is ``"cuda"`` (K1/K2 on the
card) when ``device`` is the card, the default, and ``"ref"`` only for an
explicit ``device="cpu"``; no mode falls back to the host by itself.

Further modes: streaming (``AQPServer.submit`` under Poisson arrivals at
~70% of the measured batch-64 capacity: client-observed p50/p99 and
sustained qps), GROUP BY (a ``flights.airline`` template pool, per-query
vs ``query_batch`` at batch 16/64), overload (8 submitter threads on a
bounded block-policy queue, lock-split submit path vs the single-lock
baseline), planning (cold ``plan_sql`` vs template ``bind`` vs
``bind_batch``, and overload with plan templating on vs off), tracing
overhead (traced vs untraced, paired chunks) and the disabled fault hooks'
cost. Times are host wall time. Sizes are the module-level ``FULL`` /
``QUICK`` tables. With ``trace`` the last traced pass's spans go to
``out_dir/serving_trace.json``; the JSON goes to ``out_dir/serving.json``.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np

from repro_torch.aqp.datasets import load
from repro_torch.aqp.engine import AQPFramework
from repro_torch.bench.common import RESULTS_DIR, emit, save_json
from repro_torch.core.sql import fingerprint_sql, parse_sql
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.obs.export import validate_trace_events, write_trace
from repro_torch.obs.trace import Tracer
from repro_torch.serve.aqp import AQPServer, faults

FULL = {"n": 120_000, "n_samples": 30_000, "templates": 6, "variants": 16,
        "requests": 1024, "stream": 512, "gb_templates": 5,
        "gb_variants": 12, "gb_requests": 384, "ov_threads": 8,
        "ov_per_thread": 48, "pl_variants": 256, "reps": 3,
        "guard_iters": 200_000}
QUICK = dict(FULL, n=60_000, templates=4, variants=12, requests=512,
             stream=256, gb_templates=3, gb_variants=8, gb_requests=192,
             ov_per_thread=24, pl_variants=128)


def _template_pool(table: dict, name: str, rng, n_templates: int,
                   variants: int) -> list[str]:
    """Templated queries: per template fix (agg func, agg col, predicate
    columns + ops); vary only the literals across ``variants`` instances."""
    numeric = [c for c in table
               if np.asarray(table[c]).dtype.kind not in ("U", "S", "O")]
    pool = []
    for _ in range(n_templates):
        func = rng.choice(("COUNT", "SUM", "AVG"))
        agg_col = rng.choice(numeric)
        others = [c for c in numeric if c != agg_col]
        k = int(rng.integers(1, min(3, len(others)) + 1))
        pred_cols = list(rng.choice(others, size=k, replace=False))
        ops = [rng.choice(("<", "<=", ">", ">=")) for _ in pred_cols]
        for _ in range(variants):
            conds = []
            for col, op in zip(pred_cols, ops):
                x = np.asarray(table[col], float)
                x = x[np.isfinite(x)]
                lit = float(np.quantile(x, rng.uniform(0.1, 0.9)))
                conds.append(f"{col} {op} {lit:.4f}")
            pool.append(f"SELECT {func}({agg_col}) FROM {name} "
                        f"WHERE {' AND '.join(conds)}")
    return pool


def _zipf_stream(rng, items, n, s: float = 1.5):
    p = 1.0 / np.arange(1, len(items) + 1) ** s
    p /= p.sum()
    idx = rng.choice(len(items), size=n, p=p)
    return [items[i] for i in idx]


def _serve_qps(frameworks, workload, batch_size, mode, dev):
    """Steady-state serving throughput at one batch size.

    Runs the sweep twice on *fresh servers* and times the second: the first
    pass warms the process's one-time costs (kernel build and first
    launches), while plan/result caches start cold in the timed pass
    because the server is new.
    """
    stats = None
    for attempt in range(2):
        srv = AQPServer(mode=mode, device=dev)
        for name, fw in frameworks.items():
            srv.register(name, fw)
        t0 = time.perf_counter()
        for lo in range(0, len(workload), batch_size):
            srv.query_batch([sql for sql, _ in workload[lo:lo + batch_size]])
        wall = time.perf_counter() - t0
        stats = srv.stats()
        srv.close()   # detach framework callbacks: servers here are throwaway
    return len(workload) / wall, stats


def _groupby_pool(table: dict, name: str, group_col: str, rng,
                  n_templates: int, variants: int) -> list[str]:
    """GROUP BY templates: fixed (func, agg col, predicate col, group col);
    literals vary across ``variants`` instances."""
    numeric = [c for c in table
               if np.asarray(table[c]).dtype.kind not in ("U", "S", "O")]
    pool = []
    for _ in range(n_templates):
        func = rng.choice(("COUNT", "SUM", "AVG"))
        agg_col = rng.choice(numeric)
        pred_col = rng.choice([c for c in numeric if c != agg_col])
        op = rng.choice(("<", "<=", ">", ">="))
        for _ in range(variants):
            x = np.asarray(table[pred_col], float)
            x = x[np.isfinite(x)]
            lit = float(np.quantile(x, rng.uniform(0.1, 0.9)))
            pool.append(f"SELECT {func}({agg_col}) FROM {name} "
                        f"WHERE {pred_col} {op} {lit:.4f} "
                        f"GROUP BY {group_col}")
    return pool


def _noop_guard_cost_us(n: int = 200_000) -> float:
    """Measured cost of the disabled-tracing guard branches one submitted
    query pays. With tracing off, the serving path creates NO span or trace
    objects — it only reads ``tracer.enabled`` (or an equivalent
    ``trace is not None``) at roughly a dozen sites across submit, drain,
    scheduler and resolution. This times those dozen attribute-read
    branches per iteration, so the reported per-query cost is the honest
    ceiling of what the instrumentation costs when disabled."""
    tr = Tracer(enabled=False)
    t0 = time.perf_counter()
    for _ in range(n):
        for _site in range(12):
            if tr.enabled:
                pass
    return (time.perf_counter() - t0) / n * 1e6


def _fault_hook_cost_us(n: int = 200_000) -> float:
    """Measured cost of the disabled fault-injection hooks one query pays.

    With no FaultPlan installed, ``faults.hook(site)`` is one module-global
    read plus an ``is None`` branch. A query crosses at most 6 sites
    (planner, wave_execute, worker, kernel_launch, blob_read, cold_decode
    — the cold sites only on a cold table's first access), so timing 6
    real hook calls per iteration is the honest per-query ceiling of the
    harness when disabled."""
    assert faults.active() is None
    t0 = time.perf_counter()
    for _ in range(n):
        for site in ("planner", "wave_execute", "worker", "kernel_launch",
                     "blob_read", "cold_decode"):
            faults.hook(site)
    return (time.perf_counter() - t0) / n * 1e6


def _tracing_overhead(frameworks, workload, mode, dev, reps: int = 3,
                      guard_iters: int = 200_000,
                      trace_path: str | None = None) -> dict:
    """Traced vs untraced serving latency, paired-chunk interleaved A/B.

    Shared benchmark boxes drift by double-digit percentages at the
    100ms timescale, so pass-level medians cannot resolve a few-percent
    effect. Each ~10-query chunk of the workload is instead timed
    back-to-back on an untraced and a traced server (order alternating
    chunk to chunk) and the reported overhead is the median of the
    per-chunk traced/untraced ratios — drift cancels within a pair, a
    real regression shifts every pair. The final traced server's span
    ring is exported to ``trace_path`` (validated).
    """
    def mk(trace_enabled: bool):
        srv = AQPServer(mode=mode, trace_enabled=trace_enabled, device=dev)
        for name, fw in frameworks.items():
            srv.register(name, fw)
        return srv

    def chunk_ms(srv, sqls):
        t0 = time.perf_counter()
        srv.query_batch(sqls)
        return (time.perf_counter() - t0) / len(sqls) * 1e3

    chunks = [[sql for sql, _ in workload[lo:lo + 16]]
              for lo in range(0, len(workload), 16)]
    warm = mk(False)                             # compile/cache warm-up
    for chunk in chunks:
        chunk_ms(warm, chunk)
    warm.close()

    ratios, off_ms, on_ms = [], [], []
    events = None
    for _ in range(reps):
        off_srv, on_srv = mk(False), mk(True)
        for i, chunk in enumerate(chunks):
            if i % 2 == 0:
                off = chunk_ms(off_srv, chunk)
                on = chunk_ms(on_srv, chunk)
            else:
                on = chunk_ms(on_srv, chunk)
                off = chunk_ms(off_srv, chunk)
            ratios.append(on / off)
            off_ms.append(off)
            on_ms.append(on)
        events = on_srv.trace_events()
        off_srv.close()
        on_srv.close()
    p50_off = float(np.median(off_ms))
    guard_us = _noop_guard_cost_us(guard_iters)
    out = {
        "p50_ms_untraced": p50_off,
        "p50_ms_traced": float(np.median(on_ms)),
        "enabled_overhead_pct": (float(np.median(ratios)) - 1.0) * 100.0,
        # Disabled cost: the measured guard-branch cost per query as a
        # fraction of the untraced median latency (no spans/objects are
        # created when disabled, so the branches ARE the entire cost).
        "disabled_guard_us_per_query": guard_us,
        "disabled_overhead_pct": guard_us / (p50_off * 1e3) * 100.0,
        "spans_exported": len(events or []),
    }
    if trace_path is not None and events:
        problems = validate_trace_events(events)
        out["trace_valid"] = not problems
        out["trace_path"] = write_trace(trace_path, events)
    return out


def _streaming_run(frameworks, workload, rate_qps: float, rng, mode, dev):
    """Submit ``workload`` through the async path under Poisson arrivals.

    Client-observed latency = submit -> future resolution (admission wait +
    queueing + execution share). Returns qps/p50/p99 + admission telemetry.
    """
    srv = AQPServer(mode=mode, device=dev)
    for name, fw in frameworks.items():
        srv.register(name, fw)
    done_at: dict[int, float] = {}
    submitted_at: list[float] = []
    futs = []
    t0 = time.perf_counter()
    t_next = t0
    for sql, _name in workload:
        now = time.perf_counter()
        if t_next > now:
            time.sleep(t_next - now)
        submitted_at.append(time.perf_counter())
        fut = srv.submit(sql)
        idx = len(futs)
        fut.add_done_callback(
            lambda f, i=idx: done_at.__setitem__(i, time.perf_counter()))
        futs.append(fut)
        t_next += rng.exponential(1.0 / rate_qps)
    srv.flush()
    for fut in futs:
        fut.result()
    wall = time.perf_counter() - t0
    lat_ms = 1e3 * (np.array([done_at[i] for i in range(len(futs))])
                    - np.array(submitted_at))
    stats = srv.stats()
    srv.close()
    return {
        "offered_qps": rate_qps,
        "qps": len(futs) / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "admission": stats["totals"]["admission"],
    }


def _overload_run(frameworks, workloads, single_lock: bool, mode, dev,
                  max_queue_depth: int = 128,
                  plan_templates: bool = False):
    """Fixed-work overload: N submitter threads blast the bounded queue as
    fast as they can (no pacing). ``shed_policy="block"`` paces producers
    to the consumer, so every query is answered and no work is shed — the
    measured wall time is therefore the end-to-end submit-path + drain
    throughput under contention, comparable across modes (a metric that
    counted raw submissions/sec would *reward* starving the worker, which
    is exactly the single-lock failure mode).

    ``single_lock=True`` runs the pre-split critical section (parse + plan
    + leaf expansion under the one server lock) as the contention baseline
    for the lock-split submit path. NOTE the honest caveat recorded in
    docs/benchmarks.md: on a GIL-bound CPython host the split's gain is
    bounded (planning is Python, so submitters serialize on the GIL
    whether or not they serialize on a lock); the structural win shows up
    where execution is device-side or planning runs without the GIL.

    Plan templating defaults OFF here so the split / single_lock rows stay
    directly comparable with their pre-templating baselines; the planning
    mode flips it on explicitly for the templated-vs-plain comparison.
    """
    n_threads = len(workloads)
    srv = AQPServer(max_wait_ms=1.0, max_batch=64,
                    max_queue_depth=max_queue_depth,
                    shed_policy="block", single_lock=single_lock,
                    plan_templates=plan_templates, mode=mode, device=dev)
    for name, fw in frameworks.items():
        srv.register(name, fw)
    futs = [[] for _ in range(n_threads)]
    lat: dict[int, float] = {}
    barrier = threading.Barrier(n_threads + 1)

    def submitter(ti):
        barrier.wait()
        for sql, _name in workloads[ti]:
            t_sub = time.perf_counter()
            fut = srv.submit(sql)
            key = id(fut)
            fut.add_done_callback(
                lambda f, k=key, t=t_sub: lat.__setitem__(
                    k, time.perf_counter() - t))
            futs[ti].append(fut)

    threads = [threading.Thread(target=submitter, args=(ti,))
               for ti in range(n_threads)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    submit_wall = time.perf_counter() - t0
    srv.flush()
    flat = [f for per in futs for f in per]
    for fut in flat:
        fut.result()
    wall = time.perf_counter() - t0
    adm = srv.stats()["totals"]["admission"]
    srv.close()
    lat_ms = 1e3 * np.array([lat[id(f)] for f in flat])
    return {
        "qps": len(flat) / wall,
        "submit_qps": len(flat) / submit_wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "queue_high_water": adm["queue_high_water"],
        "rejected": adm["rejected"],
        "shed": adm["shed"],
    }


def _planning_micro(framework, sqls: list[str], reps: int = 3) -> dict:
    """Per-plan planning latency: cold ``plan_sql`` (parse + plan) vs the
    zero-parse template path (fingerprint + ``bind``) vs the wave-vectorized
    ``bind_batch`` over the whole set, all producing bit-for-bit equal
    plans. Median of ``reps`` sweeps over ``sqls`` (distinct literals, one
    shape)."""
    engine = framework.engine
    template = engine.plan_template(parse_sql(sqls[0]))
    cold_us, bind_us, batch_us = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for sql in sqls:
            engine.plan_sql(sql)
        cold_us.append((time.perf_counter() - t0) / len(sqls) * 1e6)
        t0 = time.perf_counter()
        for sql in sqls:
            template.bind(fingerprint_sql(sql).literals)
        bind_us.append((time.perf_counter() - t0) / len(sqls) * 1e6)
        t0 = time.perf_counter()
        template.bind_batch([fingerprint_sql(s).literals for s in sqls])
        batch_us.append((time.perf_counter() - t0) / len(sqls) * 1e6)
    out = {
        "plans": len(sqls),
        "cold_plan_us": float(np.median(cold_us)),
        "template_bind_us": float(np.median(bind_us)),
        "template_bind_batch_us": float(np.median(batch_us)),
    }
    out["bind_speedup"] = out["cold_plan_us"] / out["template_bind_us"]
    out["bind_batch_speedup"] = (out["cold_plan_us"]
                                 / out["template_bind_batch_us"])
    return out


def run(rows: list, quick: bool = False, device=None, out_dir=None,
        trace: bool = False) -> dict:
    dev = resolve_device(device)
    mode = "cuda" if dev.type == "cuda" else "ref"
    sizes = QUICK if quick else FULL
    rng = np.random.default_rng(0)
    n = sizes["n"]
    n_templates = sizes["templates"]
    variants = sizes["variants"]
    n_requests = sizes["requests"]
    params = BuildParams(n_samples=min(n, sizes["n_samples"]), seed=0)

    frameworks, pool = {}, []
    for name, ds in (("power", "power"), ("flights", "flights")):
        table = load(ds, n=n)
        frameworks[name] = AQPFramework(
            params=params, use_compression=False, device=dev).ingest(table)
        for sql in _template_pool(table, name, rng, n_templates, variants):
            pool.append((sql, name))
    workload = _zipf_stream(rng, pool, n_requests)

    # Baseline: one-at-a-time through the single-table framework.
    t0 = time.perf_counter()
    for sql, name in workload:
        frameworks[name].query(sql)
    qps_base = len(workload) / (time.perf_counter() - t0)

    out = {"quick": quick, "mode": mode, "n_rows": n, "pool": len(pool),
           "requests": n_requests, "qps_baseline": qps_base}
    emit(rows, "serving/qps_baseline", 1e6 / qps_base, f"{qps_base:.0f} qps")

    stats = None
    for bs in (1, 8, 64):
        qps, stats = _serve_qps(frameworks, workload, bs, mode, dev)
        out[f"qps_b{bs}"] = qps
        emit(rows, f"serving/qps_b{bs}", 1e6 / qps,
             f"{qps:.0f} qps ({qps / qps_base:.1f}x)")
    speedup = out["qps_b64"] / qps_base
    out["speedup_b64"] = speedup
    out["plan_cache_hit_rate"] = stats["totals"]["plan_cache"]["hit_rate"]
    out["result_cache_hit_rate"] = stats["totals"]["result_cache"]["hit_rate"]
    out["batched_fraction"] = stats["totals"]["batched_fraction"]
    emit(rows, "serving/speedup_b64", None, f"{speedup:.1f}x")
    emit(rows, "serving/plan_cache_hit_rate", None,
         f"{out['plan_cache_hit_rate']:.2f}")
    emit(rows, "serving/result_cache_hit_rate", None,
         f"{out['result_cache_hit_rate']:.2f}")

    # Cold sweep: all-distinct workload (each pool query once) at batch 64 —
    # isolates grouping gains from repeat-traffic cache gains.
    t0 = time.perf_counter()
    for sql, name in pool:
        frameworks[name].query(sql)
    qps_base_cold = len(pool) / (time.perf_counter() - t0)
    qps_cold, _ = _serve_qps(frameworks, pool, 64, mode, dev)
    out["qps_baseline_cold"] = qps_base_cold
    out["qps_b64_cold"] = qps_cold
    out["speedup_b64_cold"] = qps_cold / qps_base_cold
    emit(rows, "serving/speedup_b64_cold", None,
         f"{qps_cold / qps_base_cold:.1f}x")

    # The fused path's plain version at batch 64, for the record.
    qps_fused, fstats = _serve_qps(frameworks, workload, 64, "ref", dev)
    out["qps_b64_fused_ref"] = qps_fused
    out["fused_batched_fraction"] = fstats["totals"]["batched_fraction"]
    emit(rows, "serving/qps_b64_fused_ref", 1e6 / qps_fused,
         f"{qps_fused:.0f} qps ({qps_fused / qps_base:.1f}x, "
         f"batched={out['fused_batched_fraction']:.2f})")

    # Streaming admission under Poisson arrivals at ~70% of batch capacity:
    # client-observed latency percentiles + sustained throughput.
    n_stream = sizes["stream"]
    rate = max(min(0.7 * out["qps_b64"], 5_000.0), 50.0)
    stream_wl = _zipf_stream(rng, pool, n_stream)
    out["streaming"] = _streaming_run(frameworks, stream_wl, rate, rng,
                                      mode, dev)
    emit(rows, "serving/streaming_qps", 1e6 / out["streaming"]["qps"],
         f"{out['streaming']['qps']:.0f} qps "
         f"(offered {out['streaming']['offered_qps']:.0f})")
    emit(rows, "serving/streaming_p50_ms", None,
         f"{out['streaming']['p50_ms']:.2f} ms")
    emit(rows, "serving/streaming_p99_ms", None,
         f"{out['streaming']['p99_ms']:.2f} ms")

    # GROUP BY batching: per-category leaf expansion through the batched
    # path + per-leaf result cache, vs the sequential per-category loop.
    gb_templates = sizes["gb_templates"]
    gb_variants = sizes["gb_variants"]
    gb_requests = sizes["gb_requests"]
    fl_table = load("flights", n=n)
    gb_pool = [(sql, "flights") for sql in _groupby_pool(
        fl_table, "flights", "airline", rng, gb_templates, gb_variants)]
    gb_wl = _zipf_stream(rng, gb_pool, gb_requests)

    t0 = time.perf_counter()
    for sql, name in gb_wl:
        frameworks[name].query(sql)
    qps_gb_base = len(gb_wl) / (time.perf_counter() - t0)
    out["groupby"] = {"pool": len(gb_pool), "requests": gb_requests,
                      "qps_baseline": qps_gb_base}
    emit(rows, "serving/groupby_qps_baseline", 1e6 / qps_gb_base,
         f"{qps_gb_base:.0f} qps")
    gstats = None
    for bs in (16, 64):
        qps_gb, gstats = _serve_qps(frameworks, gb_wl, bs, mode, dev)
        out["groupby"][f"qps_b{bs}"] = qps_gb
        out["groupby"][f"speedup_b{bs}"] = qps_gb / qps_gb_base
        emit(rows, f"serving/groupby_qps_b{bs}", 1e6 / qps_gb,
             f"{qps_gb:.0f} qps ({qps_gb / qps_gb_base:.1f}x)")
    gb_tm = gstats["tables"]["flights"]["group_by"]
    out["groupby"]["leaves_executed"] = gb_tm["leaves_executed"]
    out["groupby"]["leaf_cache_hits"] = gb_tm["leaf_cache_hits"]
    # Fused leaf launches through the plain version, for the record.
    qps_gb_fused, _ = _serve_qps(frameworks, gb_wl, 64, "ref", dev)
    out["groupby"]["qps_b64_fused_ref"] = qps_gb_fused
    emit(rows, "serving/groupby_speedup_b16", None,
         f"{out['groupby']['speedup_b16']:.1f}x")

    # Overload: 8 concurrent submitters blasting a bounded (block-policy)
    # queue with a plan-heavy mixed pool — the lock-split submit path vs
    # the pre-split single-lock baseline (p99 bounded by the queue bound,
    # not by queue growth). Split runs FIRST so any
    # process-warmth advantage accrues to the baseline.
    ov_threads = sizes["ov_threads"]
    ov_per_thread = sizes["ov_per_thread"]
    ov_pool = pool + gb_pool
    workloads = [_zipf_stream(rng, ov_pool, ov_per_thread)
                 for _ in range(ov_threads)]
    out["overload"] = {"threads": ov_threads,
                       "queries": ov_threads * ov_per_thread,
                       "max_queue_depth": 128}
    _overload_run(frameworks, workloads, False, mode, dev)       # warm-up
    reps = sizes["reps"]
    runs = {"split": [], "single_lock": []}
    for _ in range(reps):                   # interleave: box drift is real
        for label, single in (("split", False), ("single_lock", True)):
            runs[label].append(
                _overload_run(frameworks, workloads, single, mode, dev))
    for label in ("split", "single_lock"):
        med = sorted(runs[label],
                     key=lambda r: r["qps"])[(len(runs[label]) - 1) // 2]
        out["overload"][label] = med
        emit(rows, f"serving/overload_qps_{label}", 1e6 / med["qps"],
             f"{med['qps']:.0f} qps (p99 {med['p99_ms']:.1f} ms, "
             f"high water {med['queue_high_water']})")
    speedup = (out["overload"]["split"]["qps"]
               / out["overload"]["single_lock"]["qps"])
    out["overload"]["speedup"] = speedup
    emit(rows, "serving/overload_speedup", None, f"{speedup:.1f}x")

    # Planning fast path. Two measurements:
    #   micro — cold plan_sql (parse + plan) vs zero-parse template bind vs
    #   wave-vectorized bind_batch, per plan, same shape / distinct literals;
    #   overload — the submit-path throughput with templating on vs off
    #   (off = the overload baseline above) on a repeat-shape,
    #   all-distinct-literal workload: every query misses the text-keyed
    #   plan cache, so only the template path can skip the parse. The queue
    #   bound is raised so producers never block on the drain — submit_qps
    #   isolates the submit path, which is what templating changes.
    pl_var = sizes["pl_variants"]
    pl_sqls = _template_pool(fl_table, "flights", rng, 1, pl_var)
    out["planning"] = {"micro": _planning_micro(frameworks["flights"],
                                                pl_sqls)}
    mic = out["planning"]["micro"]
    emit(rows, "serving/planning_cold_plan", mic["cold_plan_us"],
         f"{mic['cold_plan_us']:.0f} us/plan")
    emit(rows, "serving/planning_template_bind", mic["template_bind_us"],
         f"{mic['template_bind_us']:.0f} us/plan "
         f"({mic['bind_speedup']:.1f}x vs cold)")
    emit(rows, "serving/planning_bind_batch", mic["template_bind_batch_us"],
         f"{mic['template_bind_batch_us']:.0f} us/plan "
         f"({mic['bind_batch_speedup']:.1f}x vs cold)")

    tp_pool = [(sql, "flights") for sql in _template_pool(
        fl_table, "flights", rng, 6, ov_threads * ov_per_thread // 6 + 1)]
    tp_wls = [[tp_pool[i] for i in range(ti, len(tp_pool), ov_threads)]
              for ti in range(ov_threads)]
    _overload_run(frameworks, tp_wls, False, mode, dev,
                  max_queue_depth=4096, plan_templates=True)     # warm-up
    tp_runs = {"plain": [], "templated": []}
    for _ in range(reps):                   # interleave: box drift is real
        for label, templ in (("plain", False), ("templated", True)):
            tp_runs[label].append(_overload_run(
                frameworks, tp_wls, False, mode, dev,
                max_queue_depth=4096, plan_templates=templ))
    for label in ("plain", "templated"):
        med = sorted(tp_runs[label], key=lambda r: r["submit_qps"])[
            (len(tp_runs[label]) - 1) // 2]
        out["planning"][label] = med
        emit(rows, f"serving/planning_submit_qps_{label}",
             1e6 / med["submit_qps"], f"{med['submit_qps']:.0f} submit qps")
    t_speedup = (out["planning"]["templated"]["submit_qps"]
                 / out["planning"]["plain"]["submit_qps"])
    out["planning"]["templating_speedup"] = t_speedup
    out["planning"]["queries"] = len(tp_pool)
    emit(rows, "serving/planning_templating_speedup", None,
         f"{t_speedup:.1f}x")

    # Tracing overhead: enabled-vs-disabled median latency on the
    # repeat-traffic workload, plus the measured disabled-guard cost. With
    # ``trace`` the last traced pass's span ring lands in
    # out_dir/serving_trace.json (trace_event schema valid).
    out_dir = Path(RESULTS_DIR if out_dir is None else out_dir)
    trace_path = (str(out_dir / "serving_trace.json") if trace else None)
    out["tracing"] = _tracing_overhead(frameworks, workload, mode, dev,
                                       reps=sizes["reps"],
                                       guard_iters=sizes["guard_iters"],
                                       trace_path=trace_path)
    tr = out["tracing"]
    emit(rows, "serving/tracing_enabled_overhead", None,
         f"{tr['enabled_overhead_pct']:+.1f}% "
         f"({tr['p50_ms_untraced']:.3f} -> {tr['p50_ms_traced']:.3f} ms p50)")
    emit(rows, "serving/tracing_disabled_overhead", tr["disabled_guard_us_per_query"],
         f"{tr['disabled_overhead_pct']:.3f}% of p50 "
         f"({tr['disabled_guard_us_per_query']:.2f} us/query)")
    if trace:
        emit(rows, "serving/trace_artifact", None,
             f"{tr['spans_exported']} events, "
             f"valid={tr.get('trace_valid')} -> {tr.get('trace_path')}")

    # Fault-injection harness: the permanently compiled-in hooks, measured
    # with NO plan installed, as a share of serving p50 — same method as
    # the disabled-tracing guard.
    hook_us = _fault_hook_cost_us(sizes["guard_iters"])
    out["faults"] = {
        "disabled_hook_us_per_query": hook_us,
        "disabled_overhead_pct":
            hook_us / (tr["p50_ms_untraced"] * 1e3) * 100.0,
        "sites_per_query": 6,
    }
    emit(rows, "serving/fault_hooks_disabled_overhead", hook_us,
         f"{out['faults']['disabled_overhead_pct']:.3f}% of p50 "
         f"({hook_us:.2f} us/query)")

    save_json("serving", out, dev, out_dir)
    return out
