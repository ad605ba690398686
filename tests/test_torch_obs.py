"""Port copy of tests/test_obs.py on ``repro_torch.obs`` and
``repro_torch.serve.aqp``, on the CPU (``device="cpu"``; the server runs
the ``"ref"`` mode where the reference's auto mode picked its own), plus the
port's profiler annotation and span names held against the reference
server's.

Observability subsystem: span ring, EXPLAIN accounting, trace export,
build timeline, metrics concurrency, immutable build timings.
"""
import json
import random
import threading
import time

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.types import BuildParams
from repro_torch.obs.export import (spans_to_events, timeline_to_events,
                              trace_json, validate_trace_events)
from repro_torch.obs.trace import NOOP_SPAN, QueryTrace, Tracer
from repro_torch.obs.timeline import BuildTimeline
from repro_torch.serve.aqp import AQPServer
from repro_torch.serve.aqp.metrics import Metrics, TableMetrics


def _table():
    rng = np.random.default_rng(5)
    n = 8_000
    return {
        "a": rng.integers(0, 400, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "c": rng.integers(0, 40, n).astype(float),
    }


@pytest.fixture(scope="module")
def framework():
    table = _table()
    params = BuildParams(n_samples=4_000, seed=1)
    return AQPFramework(params=params, use_compression=False,
                        device="cpu").ingest(table)


def _server(framework, **kwargs):
    srv = AQPServer(mode="ref", **kwargs, device="cpu")
    srv.register("t", framework)
    return srv


# --------------------------------------------------------------- span ring


def test_ring_wraparound_drops_oldest():
    tr = Tracer(capacity=8)
    for i in range(20):
        tr.add(f"s{i}", float(i), float(i) + 0.5)
    assert tr.n_recorded == 20
    assert tr.n_dropped == 12
    window = tr.spans()
    assert len(window) == 8
    assert [s.name for s in window] == [f"s{i}" for i in range(12, 20)]
    assert [s.seq for s in window] == list(range(12, 20))
    tr.clear()
    assert tr.spans() == [] and tr.n_recorded == 0 and tr.n_dropped == 0


def test_disabled_tracer_records_nothing():
    tr = Tracer(capacity=8, enabled=False)
    assert tr.span("x") is NOOP_SPAN
    with tr.span("x"):
        pass
    tr.add("y", 0.0, 1.0)
    tr.instant("z")
    assert tr.spans() == [] and tr.n_recorded == 0


def test_concurrent_add_no_lost_spans():
    tr = Tracer(capacity=4096)
    n_threads, per = 8, 200

    def worker(tid):
        for i in range(per):
            tr.add(f"t{tid}-{i}", 0.0, 1.0, track=f"w{tid}")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.n_recorded == n_threads * per
    assert tr.n_dropped == 0
    spans = tr.spans()
    assert len(spans) == n_threads * per
    # every committed span is present exactly once
    assert len({s.name for s in spans}) == n_threads * per


# ----------------------------------------------------------------- explain


def test_explain_tiles_interval_exactly():
    qt = QueryTrace(t_submit=10.0)
    qt.t_planned = 10.002
    qt.t_admitted = 10.003
    # t_drained missing (e.g. cache hit) -> zero-width queue stage
    qt.t_exec0 = 10.010
    qt.t_exec1 = 10.020
    qt.t_resolved = 10.021
    exp = qt.explain()
    stages = [exp[k] for k in ("plan_ms", "admit_ms", "queue_ms",
                               "assemble_ms", "execute_ms", "resolve_ms")]
    assert exp["queue_ms"] == 0.0
    assert sum(stages) == pytest.approx(exp["total_ms"])
    assert exp["total_ms"] == pytest.approx(21.0, rel=1e-6)


def test_explain_accounts_observed_wall_clock(framework):
    # Acceptance: the EXPLAIN breakdown of a traced query accounts for
    # >= 95% of the wall-clock the client observed. The admission wait
    # (max_wait_ms) is part of the traced interval, so the measured total
    # dwarfs the only unaccounted gaps (pre-submit entry + future wakeup).
    srv = _server(framework, trace_enabled=True, max_wait_ms=50.0)
    try:
        t0 = time.perf_counter()
        fut = srv.submit("SELECT AVG(b) FROM t WHERE a > 100")
        res = fut.result(timeout=30)
        wall_ms = (time.perf_counter() - t0) * 1e3
        exp = res.explain
        assert exp is not None
        assert exp["total_ms"] <= wall_ms + 1e-6
        assert exp["total_ms"] >= 0.95 * wall_ms, (exp, wall_ms)
        stages = [exp[k] for k in ("plan_ms", "admit_ms", "queue_ms",
                                   "assemble_ms", "execute_ms",
                                   "resolve_ms")]
        assert sum(stages) == pytest.approx(exp["total_ms"])
    finally:
        srv.close()


def test_cached_results_stay_explain_free(framework):
    srv = _server(framework, trace_enabled=True)
    try:
        sql = "SELECT COUNT(a) FROM t WHERE b > 90"
        first = srv.query(sql)
        assert first.explain is not None
        assert first.explain["result_cache_hit"] is False
        hit = srv.query(sql)
        assert hit.explain is not None           # per-query, not cached
        assert hit.explain["result_cache_hit"] is True
        assert hit.explain["execute_ms"] == 0.0
    finally:
        srv.close()


def test_untraced_server_attaches_no_explain(framework):
    srv = _server(framework)
    try:
        res = srv.query("SELECT SUM(b) FROM t WHERE c < 20")
        assert res.explain is None
        assert srv.stats()["tracing"]["enabled"] is False
        assert srv.trace_events() == []
    finally:
        srv.close()


def test_slow_query_log_bounded_and_thresholded(framework):
    srv = _server(framework, trace_enabled=True, slow_query_ms=0.0)
    try:
        for thr in (50, 60, 70):
            srv.query(f"SELECT COUNT(a) FROM t WHERE b > {thr}")
        log = srv.slow_queries()
        assert len(log) == 3
        assert all("sql" in e and e["total_ms"] >= 0.0 for e in log)
        assert len(log) <= AQPServer.SLOW_LOG_CAP
    finally:
        srv.close()


# ------------------------------------------------------------------ export


def test_trace_export_valid_trace_event_json(framework):
    srv = _server(framework, trace_enabled=True)
    try:
        srv.query_batch([
            "SELECT COUNT(a) FROM t WHERE b > 80",
            "SELECT AVG(b) FROM t WHERE a < 300",
            "SELECT SUM(b) FROM t WHERE c >= 5",
        ])
        parsed = json.loads(srv.trace_json())
        assert parsed, "no events exported"
        assert validate_trace_events(parsed) == []
        names = {ev["name"] for ev in parsed}
        assert {"plan", "execute", "resolve"} <= names
        # every query lane is named via M metadata
        meta = [ev for ev in parsed if ev["ph"] == "M"]
        assert {m["args"]["name"] for m in meta} >= {"admission"}
    finally:
        srv.close()


def test_validate_trace_events_catches_breakage():
    good = spans_to_events([])
    assert good == []
    bad = [{"ph": "X", "name": "x", "pid": 1, "tid": 0, "ts": -5.0,
            "dur": 1.0},
           {"ph": "i", "name": 3, "pid": 1, "tid": 1, "ts": 0.0, "s": "t"}]
    problems = validate_trace_events(bad)
    assert any("ts" in p for p in problems)
    assert any("name" in p for p in problems)
    assert any("thread_name" in p for p in problems)
    assert validate_trace_events("nope") == ["top level is not a JSON array"]


# ----------------------------------------------------------- build timeline


def test_build_timeline_and_phase_summary(framework):
    stats = framework.synopsis.build_stats
    events = stats["timeline"]
    assert events, "build recorded no timeline events"
    phase_names = {ev["name"] for ev in events if ev["kind"] == "phase"}
    assert {"sample", "refine_1d", "pair_phase", "folds"} <= phase_names
    summary = stats["phase_s"]
    assert {"sample", "refine_1d", "pair_phase"} <= set(summary)
    assert all(v >= 0.0 for v in summary.values())
    exported = timeline_to_events(events)
    assert validate_trace_events(json.loads(trace_json(exported))) == []


@pytest.mark.parametrize("scheduler, over, spans", [
    ("compact", {}, ("pair_presort", "pair_upload", "compact_launch",
                     "pair_metadata")),
])
def test_pair_phase_spans_split_the_pair_phase(scheduler, over, spans):
    """The compacting scheduler times the upload of the sample's columns,
    its device presort, its launches and its metadata as child spans of
    the pair phase, apart from one another; the launches count the host's
    reads of the device and the upload its two copies."""
    from repro_torch.core.build import build_pairwise_hist
    from repro_torch.core.types import ColumnInfo
    data = np.stack(list(_table().values()), 1)
    syn = build_pairwise_hist(
        data, [ColumnInfo(name=f"c{i}", kind="int") for i in range(3)],
        BuildParams(n_samples=4_000, seed=1, **over), device="cpu")
    stats = syn.build_stats
    assert stats["mode"] == scheduler
    events = stats["timeline"]
    (i_pair,) = [i for i, ev in enumerate(events)
                 if ev["name"] == "pair_phase"]
    pair = events[i_pair]
    inner = sorted((ev for ev in events if ev["name"] in spans),
                   key=lambda ev: ev["t0"])
    assert {ev["name"] for ev in inner} == set(spans)
    for ev in inner:
        assert ev["parent"] == i_pair
        assert pair["t0"] <= ev["t0"] <= ev["t1"] <= pair["t1"]
    for a, b in zip(inner, inner[1:]):
        assert a["t1"] <= b["t0"]
    assert sum(stats["phase_s"][s] for s in spans) <= \
        stats["phase_s"]["pair_phase"]
    assert stats["pair_phase_s"] == pair["t1"] - pair["t0"]
    launch = f"{scheduler}_launch"
    assert all(ev["counts"]["d2h_reads"] > 0 for ev in inner
               if ev["name"] == launch)
    counts = stats["counts"]
    assert sum(ev["name"] == "pair_upload" for ev in events) == 1
    assert counts["pair_upload"]["h2d_copies"] == 2
    assert "d2h_reads" not in counts["pair_upload"]


# A compressed build that takes every span of the compacting scheduler:
# 10 pairs in two groups of at most 8, pairs escalating from k2 = 8.
SPAN_PARAMS = dict(n_samples=4_000, seed=1, pair_chunk=2, k2_start=8)


def _span_table():
    rng = np.random.default_rng(5)
    n = 8_000
    a = rng.integers(0, 400, n).astype(float)
    d = np.abs(rng.normal(100, 30, n)).round()
    d[rng.random(n) < 0.1] = np.nan
    return {"a": a, "b": (a * 0.5 + rng.normal(0, 10, n)).round().clip(0),
            "c": rng.integers(0, 40, n).astype(float), "d": d,
            "e": rng.integers(0, 4, n).astype(float)}


@pytest.fixture(scope="module")
def span_framework():
    fw = AQPFramework(params=BuildParams(**SPAN_PARAMS),
                      use_compression=True, device="cpu")
    return fw.ingest(_span_table())


@pytest.fixture(scope="module")
def span_build(span_framework):
    return span_framework.synopsis.build_stats


def _check_nesting(stats):
    events = stats["timeline"]
    assert events[0]["parent"] is None
    for i, ev in enumerate(events):
        assert ev["t0"] <= ev["t1"]
        if ev["parent"] is None:
            continue
        assert ev["parent"] < i
        up = events[ev["parent"]]
        assert up["kind"] == "phase"
        assert up["t0"] <= ev["t0"] <= ev["t1"] <= up["t1"]
    roots = [ev for ev in events if ev["parent"] is None]
    for a, b in zip(roots, roots[1:]):
        assert a["t1"] <= b["t0"]


def _check_names(stats):
    from collections import Counter
    from repro_torch.core.build import _COMPACT_QUEUE
    events = stats["timeline"]
    n = Counter(ev["name"] for ev in events if ev["kind"] == "phase")
    groups = -(-stats["n_pairs"] // (SPAN_PARAMS["pair_chunk"]
                                     * _COMPACT_QUEUE))
    assert groups == 2 and stats["compaction"]["escalated_pairs"] > 0
    launches = len(stats["pair_launches"])
    assert n == {
        # the spans the build had before
        "sample": 1, "refine_1d": 1, "pair_phase": 1, "union_regrid": 1,
        "folds": 1, "pair_presort": 1 + groups, "pair_upload": 1,
        "compact_launch": launches, "pair_metadata": groups,
        # and the new ones
        "seed_edges": 1, "decompress_rows": 1, "crit_table": 1,
        "presort_ranks": 1, "presort_gather": groups,
        "presort_sort": groups}
    by_name = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(ev)
    assert [ev["pairs"] for ev in by_name["pair_presort"]] == [0, 8, 2]
    for name, parent in (("decompress_rows", "sample"),
                         ("crit_table", "sample"),
                         ("presort_ranks", "pair_presort"),
                         ("presort_gather", "pair_presort"),
                         ("presort_sort", "pair_presort")):
        assert all(events[ev["parent"]]["name"] == parent
                   for ev in by_name[name])
    (rank_span,) = by_name["presort_ranks"]
    assert events[rank_span["parent"]]["pairs"] == 0
    assert [ev["counts"]["presort_device_pairs"]
            for ev in by_name["presort_sort"]] == [8, 2]
    assert stats["counts"]["presort_sort"]["presort_device_pairs"] == \
        stats["count_totals"]["presort_device_pairs"] == stats["n_pairs"]
    assert sum(ev["name"] == "rung_escalation" for ev in events) > 0


def _check_d2h(stats):
    """One read a compacting round, the edges of each launch, the nine
    fields of each metadata launch."""
    meta = sum(ev["launches"] for ev in stats["timeline"]
               if ev["name"] == "pair_metadata")
    want = (stats["compaction"]["loop_rounds"]
            + 2 * len(stats["pair_launches"]) + 9 * meta)
    assert stats["counts"]["pair_phase"]["d2h_reads"] == want


def _check_h2d(stats):
    """The pair phase's upload is the sample's columns (f64) and NaN mask
    (bool), once; each group's presort uploads its pairs' two column
    index lists (int64) and nothing else."""
    n_s = stats["rows_decoded"]
    (up,) = [ev for ev in stats["timeline"] if ev["name"] == "pair_upload"]
    upload = stats["counts"]["pair_upload"]
    assert upload == {"h2d_copies": 2, "h2d_bytes": up["d"] * n_s * (8 + 1)}
    gather = stats["counts"]["presort_gather"]
    assert gather == {"h2d_copies": 2 * 2,
                      "h2d_bytes": 2 * 8 * stats["n_pairs"]}
    assert stats["counts"]["pair_presort"] == dict(
        gather, presort_device_pairs=stats["n_pairs"])
    totals = stats["count_totals"]
    assert totals["h2d_bytes"] >= upload["h2d_bytes"]
    assert totals == {
        k: sum(c.get(k, 0) for name, c in stats["counts"].items()
               if name in ("seed_edges", "sample", "refine_1d",
                           "pair_phase", "union_regrid", "folds"))
        for k in totals}


@pytest.mark.parametrize("check", [_check_nesting, _check_names, _check_d2h,
                                   _check_h2d])
def test_build_span_tree(span_build, check):
    """A small compressed build's span tree: every span inside its parent;
    the earlier spans as often as before beside the new ones; the pair
    phase's reads of the device as the compacting loop implies; the
    column upload's and the presort's copies and bytes."""
    check(span_build)


@pytest.mark.parametrize("profiled", [True, False])
def test_spans_are_profiler_annotations(span_framework, monkeypatch,
                                        profiled):
    """Under a recording ``torch.profiler`` every span is a user
    annotation of its name, nested as the spans nest; with none recording
    no ``record_function`` is entered."""
    import contextlib

    import torch
    from repro_torch.core.build import build_pairwise_hist
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof if profiled else contextlib.nullcontext():
        syn = build_pairwise_hist(
            span_framework.compressed, span_framework.preprocessed.columns,
            BuildParams(**SPAN_PARAMS), device="cpu")
    spans = [ev for ev in syn.build_stats["timeline"]
             if ev["kind"] == "phase"]
    assert len(spans) > 10
    if not profiled:
        assert entered == []
        return
    assert entered == [ev["name"] for ev in spans]
    names = {ev["name"] for ev in spans}
    notes = sorted((e for e in prof.events()
                    if e.is_user_annotation and e.name in names),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in notes] == [ev["name"] for ev in spans]
    events = syn.build_stats["timeline"]
    index = {id(e): i for i, e in enumerate(notes)}
    span_index = {id(ev): i for i, ev in enumerate(spans)}
    for e, ev in zip(notes, spans):
        up = e.cpu_parent
        while up is not None and id(up) not in index:
            up = up.cpu_parent
        want = (None if ev["parent"] is None
                else span_index[id(events[ev["parent"]])])
        assert (None if up is None else index[id(up)]) == want


def test_compact_occupancy_hist_ledger(framework):
    comp = framework.synopsis.build_stats.get("compaction")
    if comp is None:
        pytest.skip("compact path not taken on this build")
    hist = comp["occupancy_hist"]
    assert hist and all(isinstance(v, int) and v > 0 for v in hist.values())
    # one histogram entry per device loop round ...
    assert sum(hist.values()) == comp["loop_rounds"]
    # ... and occupancy-weighted rounds are exactly the pair-rounds refined
    assert sum(n * v for n, v in hist.items()) == comp["pair_rounds"]


def test_counts_go_to_the_innermost_open_span():
    """``to_device`` / ``to_host`` count on the innermost open span of the
    current timeline (an empty copy not at all), ``counts`` sums a span
    and its descendants by name, ``totals`` the whole timeline; with no
    span open nothing is counted anywhere."""
    import torch
    from repro_torch.obs.timeline import to_device, to_host
    tl = BuildTimeline()
    to_host(to_device(np.zeros(4), "cpu"))
    with tl.phase("outer"):
        to_device([1, 2, 3], "cpu", torch.int64)
        with tl.phase("inner") as span:
            to_host(to_device(np.zeros(5, bool), "cpu"))
            to_device([], "cpu", torch.int64)
            tl.count("rounds", 3)
            span["done"] = True
        with tl.phase("inner"):
            to_host(to_device(2.0, "cpu", torch.float64))
    outer, inner, inner2 = tl.events
    assert outer["counts"] == {"h2d_copies": 1, "h2d_bytes": 24}
    assert inner["counts"] == {"h2d_copies": 1, "h2d_bytes": 5,
                               "d2h_reads": 1, "rounds": 3}
    assert inner["done"] and inner["parent"] == inner2["parent"] == 0
    assert tl.counts() == {
        "outer": {"h2d_copies": 3, "h2d_bytes": 37, "d2h_reads": 2,
                  "rounds": 3},
        "inner": {"h2d_copies": 2, "h2d_bytes": 13, "d2h_reads": 2,
                  "rounds": 3}}
    assert tl.totals() == tl.counts()["outer"]
    to_host(to_device(np.zeros(4), "cpu"))
    assert tl.totals() == tl.counts()["outer"]


@pytest.mark.parametrize("device, waits", [("cpu", 0), ("cuda", 1),
                                           (None, 0)])
def test_phase_completion_wait(monkeypatch, device, waits):
    """``phase(..., wait=device)`` ends the span on a completion wait: a
    synchronize of the device's current stream on CUDA, before the span's
    end is read, and nothing on the CPU. The wait is no ``d2h_reads`` and
    no attribute of the span; a block that raises does not wait."""
    import torch
    synced = []

    class Stream:
        def synchronize(self):
            synced.append(time.perf_counter())

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream())
    tl = BuildTimeline()
    with tl.phase("presort_sort", wait=device, pairs=3):
        tl.count("presort_device_pairs", 3)
    (ev,) = tl.events
    assert len(synced) == waits
    assert all(ev["t0"] <= t <= ev["t1"] for t in synced)
    assert ev["counts"] == {"presort_device_pairs": 3}
    assert "wait" not in ev and ev["pairs"] == 3
    with pytest.raises(ValueError):
        with tl.phase("presort_gather", wait=device):
            raise ValueError
    assert len(synced) == waits and "counts" not in tl.events[1]


def test_timeline_disabled_records_nothing():
    from repro_torch.obs import timeline as tlmod
    tl = BuildTimeline(enabled=False)
    with tl.phase("sample") as span:
        span["x"] = 1
        tl.count("d2h_reads")
        tlmod.to_host(tlmod.to_device([1.0], "cpu"))
    tl.event("y")
    assert tl.events == [] and tl.summary() == {}
    assert tl.counts() == {} and tl.totals() == {}
    assert tlmod._CURRENT.get() is None


# ----------------------------------------------------------------- metrics


def test_qps_reported_for_single_query():
    tm = TableMetrics()
    tm.record(0.002, batched=False)
    snap = tm.snapshot()
    assert snap["qps"] is not None and snap["qps"] > 0
    empty = TableMetrics().snapshot()
    assert empty["qps"] is None


def test_metrics_concurrent_record_ledger_exact():
    m = Metrics(reservoir=128)
    n_threads, per = 8, 250
    errors = []

    def worker(tid):
        rng = random.Random(tid)
        try:
            for i in range(per):
                tm = m.table(f"t{tid % 2}")
                tm.record(rng.random() * 1e-3, batched=(i % 2 == 0))
                if i % 5 == 0:
                    tm.record_result_hit()
                m.admission.record_wait(rng.random() * 1e-4)
                m.record_explain({"plan_ms": 0.1, "execute_ms": 0.5,
                                  "total_ms": 0.6})
                if i % 50 == 0:
                    m.snapshot()      # concurrent snapshots must not blow up
        except Exception as exc:      # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    snap = m.snapshot()
    total = n_threads * per
    assert snap["totals"]["queries_executed"] == total
    executed = sum(t["queries_executed"] for t in snap["tables"].values())
    batched = sum(t["batched"] for t in snap["tables"].values())
    fallback = sum(t["fallback"] for t in snap["tables"].values())
    assert executed == batched + fallback == total
    hits = sum(t["result_cache_hits"] for t in snap["tables"].values())
    assert hits == n_threads * len(range(0, per, 5))
    assert snap["totals"]["stages"]["explained"] == total
    assert snap["totals"]["stages"]["execute"]["p50_ms"] == pytest.approx(0.5)


# ------------------------------------------------------- immutable timings


def test_published_timings_immutable_and_atomic(framework):
    timings = framework.timings
    assert {"preprocess_s", "build_synopsis_s", "build_pairs_s",
            "build_phase_s"} <= set(timings)
    with pytest.raises(TypeError):
        timings["preprocess_s"] = 0.0
    engine, epoch = framework.published
    assert engine is framework.engine and epoch == framework.epoch


def test_stale_publish_carries_timings_forward(framework):
    rng = np.random.default_rng(6)
    n = 4_000
    table = {"a": rng.integers(0, 100, n).astype(float),
             "b": np.abs(rng.normal(50, 10, n)).round()}
    fw = AQPFramework(params=BuildParams(n_samples=2_000, seed=2),
                      use_compression=False, device="cpu").ingest(table)
    before = fw.timings
    fw.append_rows({k: v[:100] for k, v in table.items()})
    assert fw.is_stale
    assert fw.timings is before       # carried forward, still immutable
    fw.rebuild(table)
    assert not fw.is_stale
    assert fw.timings is not before   # fresh build published fresh telemetry


# --------------------------- profiler annotation, against the reference


WAVE = ["SELECT COUNT(a) FROM t WHERE b > 80 AND c < 30",
        "SELECT COUNT(a) FROM t WHERE b > 95 AND c < 20",
        "SELECT COUNT(a) FROM t WHERE b > 110 AND c < 35",
        "SELECT SUM(b) FROM t WHERE a < 100 OR c > 30"]


def _reference_framework():
    """The reference's framework on the ``framework`` fixture's table."""
    from repro.aqp.engine import AQPFramework as RefFramework
    from repro.core.types import BuildParams as RefParams
    return RefFramework(params=RefParams(n_samples=4_000, seed=1),
                        use_compression=False).ingest(_table())


def _run_wave(scheduler, tracer, framework, to_events):
    """Execute ``WAVE`` as one scheduler wave; (results, sorted span
    names)."""
    scheduler.catalog.register("t", framework)
    engine = framework.engine
    results = scheduler.execute([("t", engine.plan_sql(s)) for s in WAVE])
    return results, sorted(ev["name"] for ev in to_events(tracer.spans())
                           if ev["ph"] == "X")


def test_annotated_fused_launch_matches_reference_spans(framework):
    """With ``Tracer(annotate=True)`` the fused launch runs under a
    ``torch.profiler.record_function`` range named after the group, and the
    wave records the same spans (``kernel``, ``wave_group``,
    ``single_exec``) as the reference's scheduler on the same wave."""
    import torch
    from repro.obs.export import spans_to_events as ref_spans_to_events
    from repro.obs.trace import Tracer as RefTracer
    from repro.serve.aqp import TableCatalog as RefCatalog
    from repro.serve.aqp.scheduler import BatchScheduler as RefScheduler
    from repro_torch.serve.aqp import TableCatalog
    from repro_torch.serve.aqp.scheduler import BatchScheduler

    tracer = Tracer(annotate=True)
    sched = BatchScheduler(TableCatalog(device="cpu"), mode="ref",
                           tracer=tracer)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        results, names = _run_wave(sched, tracer, framework,
                                   spans_to_events)
    assert [r.batched for r in results] == [True, True, True, False]
    assert any(e.name.startswith("aqp.fused:t.") for e in prof.events())

    ref_tracer = RefTracer()
    ref_sched = RefScheduler(RefCatalog(), mode="ref", tracer=ref_tracer)
    ref_results, ref_names = _run_wave(ref_sched, ref_tracer,
                                       _reference_framework(),
                                       ref_spans_to_events)
    assert names == ref_names == ["kernel", "single_exec", "wave_group"]
    for got, want in zip(results, ref_results):
        assert got.batched == want.batched
        np.testing.assert_allclose(got.result.as_tuple(),
                                   want.result.as_tuple(),
                                   rtol=1e-4, atol=1e-6)


def test_server_trace_span_names_match_reference(framework):
    """The server's exported trace validates, and names the same spans as
    the reference server's for the same wave (both in their ``"ref"``
    mode)."""
    from repro.serve.aqp import AQPServer as RefServer
    srv = _server(framework, trace_enabled=True, max_wait_ms=10_000.0,
                  max_batch=len(WAVE))
    ref = RefServer(mode="ref", trace_enabled=True, max_wait_ms=10_000.0,
                    max_batch=len(WAVE))
    ref.register("t", _reference_framework())
    try:
        srv.tracer.annotate = True
        got = srv.query_batch(WAVE)
        want = ref.query_batch(WAVE)
        events = json.loads(srv.trace_json())
        assert validate_trace_events(events) == []
        names = {ev["name"] for ev in events if ev["ph"] == "X"}
        ref_names = {ev["name"] for ev in json.loads(ref.trace_json())
                     if ev["ph"] == "X"}
        assert names == ref_names
        assert {"kernel", "wave_group", "single_exec"} <= names
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.as_tuple(), w.as_tuple(),
                                       rtol=1e-4, atol=1e-6)
    finally:
        srv.close()
        ref.close()
