"""Serving telemetry: latency/wait percentiles, throughput, admission stats.

Three layers:

  * ``TableMetrics`` — per-table query latencies (bounded reservoir with
    uniform replacement, so long-running servers report stable p50/p99
    without unbounded memory), batched/fallback/cache-hit counters, and
    GROUP BY leaf-expansion counters. Counters are exact: recording and
    snapshotting are serialized by a per-object lock, so concurrent
    submitter/worker threads can never lose an increment or snapshot a
    half-updated reservoir (asserted under contention in
    tests/test_obs.py).
  * ``AdmissionMetrics`` — server-wide streaming-admission stats: queue
    depth at drain time, per-query admission wait (submit -> drain), and
    drain causes (``full`` / ``flush`` / ``timeout``).
  * ``StageMetrics`` — trace-derived per-stage latency reservoirs (plan /
    queue / execute / ...): ``Metrics.record_explain`` feeds each traced
    query's EXPLAIN breakdown in, and the snapshot reports per-stage
    p50/p99 so aggregate dashboards see where wall-clock goes without
    reading raw traces.
  * ``Metrics`` — the container ``AQPServer`` owns; assembles the snapshot
    dict (see ``docs/serving.md`` for the field reference).
"""
from __future__ import annotations

import random
import threading
import time

import numpy as np


class _Reservoir:
    """Bounded uniform-replacement sample of a float stream."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self._data: list[float] = []
        self.n_seen = 0

    def add(self, value: float):
        self.n_seen += 1
        if len(self._data) < self.capacity:
            self._data.append(value)
        else:
            idx = self._rng.randrange(self.n_seen)
            if idx < self.capacity:
                self._data[idx] = value

    def percentiles_ms(self, qs=(50, 99)) -> list:
        """Requested percentiles in milliseconds, or Nones when empty."""
        if not self._data:
            return [None] * len(qs)
        arr = np.asarray(self._data, float)
        return [float(np.percentile(arr, q) * 1e3) for q in qs]


class TableMetrics:
    """Per-table serving counters + latency reservoir.

    ``record``/``record_result_hit`` mirror the server's execution paths;
    ``record_group_expansion`` tracks GROUP BY queries whose per-category
    leaves went through the batched path (executed vs served from the
    per-leaf result cache).
    """

    def __init__(self, reservoir: int = 4096, seed: int = 0):
        self.reservoir = int(reservoir)
        self._lock = threading.Lock()
        self._lat = _Reservoir(self.reservoir, seed)
        self.n_queries = 0          # executed (cache misses)
        self.n_batched = 0          # executed via the fused batched kernel
        self.n_fallback = 0         # executed via the per-query path
        self.n_result_hits = 0      # served straight from the result cache
        self.n_group_queries = 0    # GROUP BY queries answered
        self.n_leaves_executed = 0  # GROUP BY leaves actually executed
        self.n_leaf_cache_hits = 0  # GROUP BY leaves served from cache
        self.n_cold_decodes = 0     # cold-tier blob -> engine decodes
        self.cold_synopsis_bytes = 0  # registered blob size (cold tables)
        self.cold_decode_ms = None  # latest cold-start decode latency
        self.n_demotes = 0          # governor engine -> blob demotions
        self.engine_resident_bytes = 0  # decoded-engine footprint right now
        self._t_first = None
        self._t_last = None
        # Last time this table served anything (executions, result-cache
        # hits, cold decodes) — the governor's idle clock. Separate from
        # _t_last so cache hits don't stretch the qps window.
        self._t_activity = None

    def record(self, latency_s: float, batched: bool):
        """One executed query: its latency share and whether it fused."""
        now = time.perf_counter()
        with self._lock:
            self._t_first = self._t_first if self._t_first is not None else now
            self._t_last = now
            self._t_activity = now
            self.n_queries += 1
            if batched:
                self.n_batched += 1
            else:
                self.n_fallback += 1
            self._lat.add(latency_s)

    def record_result_hit(self):
        """One query served from the result cache (no execution). Counts as
        table activity for the governor's idle clock — a cache-hit-hot
        table must not look idle and get demoted under it."""
        now = time.perf_counter()
        with self._lock:
            self._t_activity = now
            self.n_result_hits += 1

    def record_group_expansion(self, n_executed: int, n_cached: int):
        """One GROUP BY query: leaves executed vs served from cache."""
        with self._lock:
            self.n_group_queries += 1
            self.n_leaves_executed += int(n_executed)
            self.n_leaf_cache_hits += int(n_cached)

    def record_cold_register(self, n_bytes: int):
        """A cold (storage-tier) table registered under this name: its
        bit-packed synopsis blob size, reported before any decode."""
        with self._lock:
            self.cold_synopsis_bytes = int(n_bytes)

    def record_cold_decode(self, n_bytes: int, decode_s: float,
                           resident_bytes: int | None = None):
        """One lazy cold-start decode (blob -> engine) and its latency."""
        now = time.perf_counter()
        with self._lock:
            self._t_activity = now
            self.n_cold_decodes += 1
            self.cold_synopsis_bytes = int(n_bytes)
            self.cold_decode_ms = float(decode_s) * 1e3
            if resident_bytes is not None:
                self.engine_resident_bytes = int(resident_bytes)

    def record_demote(self):
        """One governor demotion (engine -> blob) for this table."""
        with self._lock:
            self.n_demotes += 1
            self.engine_resident_bytes = 0

    @property
    def last_activity(self) -> float | None:
        """``time.perf_counter()`` of this table's most recent serve
        activity (execution, result-cache hit, or cold decode); None if
        never queried. The governor orders demotion candidates by this."""
        with self._lock:
            return self._t_activity

    def snapshot(self) -> dict:
        """Point-in-time dict of counters + p50/p99/qps (None when empty)."""
        with self._lock:
            served = self.n_queries + self.n_result_hits
            span = ((self._t_last - self._t_first)
                    if self._t_first is not None else 0.0)
            n_queries = self.n_queries
            p50, p99 = self._lat.percentiles_ms()
            snap = {
                "queries_served": served,
                "queries_executed": n_queries,
                "batched": self.n_batched,
                "fallback": self.n_fallback,
                "result_cache_hits": self.n_result_hits,
                "batched_fraction": (self.n_batched / n_queries
                                     if n_queries else 0.0),
                "p50_ms": p50,
                "p99_ms": p99,
                "group_by": {
                    "queries": self.n_group_queries,
                    "leaves_executed": self.n_leaves_executed,
                    "leaf_cache_hits": self.n_leaf_cache_hits,
                },
            }
            if self.n_cold_decodes or self.cold_synopsis_bytes:
                snap["cold"] = {
                    "decodes": self.n_cold_decodes,
                    "synopsis_bytes": self.cold_synopsis_bytes,
                    "decode_ms": self.cold_decode_ms,
                    "demotes": self.n_demotes,
                    "resident_bytes": self.engine_resident_bytes,
                }
        # qps window: once >= 1 query landed, span is clamped to a small
        # epsilon so a single query (span == 0 between first and last)
        # reports a finite rate instead of None.
        snap["qps"] = (n_queries / max(span, 1e-9)
                       if n_queries > 0 else None)
        return snap


class AdmissionMetrics:
    """Streaming-admission telemetry: queue depth, waits, drain causes,
    backpressure decisions (rejected / shed submissions)."""

    def __init__(self, reservoir: int = 4096):
        self._lock = threading.Lock()
        self._wait = _Reservoir(reservoir, seed=1)
        self.n_drains = 0
        self.n_submitted = 0
        self.max_depth = 0
        self._depth_sum = 0
        self.causes = {"full": 0, "flush": 0, "timeout": 0}
        self.n_rejected = 0         # new submissions turned away (reject)
        self.n_shed = 0             # queued submissions evicted (shed_oldest)
        self.queue_high_water = 0   # max depth observed at admit time
        self.n_stale_requeue = 0    # wave items re-enqueued on epoch races

    def record_submit(self):
        """One ``AQPServer.submit`` call (cache hits and dupes included)."""
        with self._lock:
            self.n_submitted += 1

    def record_shed(self, reason: str, depth: int):
        """One backpressure decision: a submission rejected at the door
        (``reason="reject"``) or evicted from the queue (``"shed_oldest"``).
        Counted per *submission*, not per attached future. ``depth`` (the
        queue depth observed at decision time) feeds the high-water mark,
        NOT ``max_depth`` (which stays drain-time-only as documented)."""
        with self._lock:
            if reason == "reject":
                self.n_rejected += 1
            else:
                self.n_shed += 1
            self.queue_high_water = max(self.queue_high_water, depth)

    def record_stale_requeue(self):
        """One submission re-enqueued because a rebuild raced its wave
        (the scheduler's per-item epoch re-validation refused to pair the
        old plan with the new synopsis)."""
        with self._lock:
            self.n_stale_requeue += 1

    def record_drain(self, stats):
        """One admission-loop drain (a ``scheduler.DrainStats``)."""
        with self._lock:
            self.n_drains += 1
            self.max_depth = max(self.max_depth, stats.depth)
            self._depth_sum += stats.depth
            self.causes[stats.cause] = self.causes.get(stats.cause, 0) + 1

    def record_wait(self, wait_s: float):
        """One submission's admission wait (submit -> drained into a wave)."""
        with self._lock:
            self._wait.add(wait_s)

    def snapshot(self) -> dict:
        """Point-in-time admission stats (see ``docs/serving.md``)."""
        with self._lock:
            p50, p99 = self._wait.percentiles_ms()
            return {
                "submitted": self.n_submitted,
                "drains": self.n_drains,
                "drain_causes": dict(self.causes),
                "max_queue_depth": self.max_depth,
                "mean_queue_depth": (self._depth_sum / self.n_drains
                                     if self.n_drains else 0.0),
                "wait_p50_ms": p50,
                "wait_p99_ms": p99,
                "rejected": self.n_rejected,
                "shed": self.n_shed,
                "queue_high_water": self.queue_high_water,
                "stale_requeues": self.n_stale_requeue,
            }


# The EXPLAIN stage keys StageMetrics aggregates (matches
# ``repro_torch.obs.trace.QueryTrace.explain`` stage names). The two
# ``plan_*`` keys split the plan stage by planner path: a traced query's
# ``plan_ms`` additionally lands in ``plan_full`` (cold parse+plan) or
# ``plan_template_hit`` (zero-parse template bind / plan-cache hit)
# according to its ``plan_path`` label.
_STAGE_KEYS = ("plan", "admit", "queue", "assemble", "execute", "resolve",
               "plan_template_hit", "plan_full")


class StageMetrics:
    """Trace-derived per-stage latency reservoirs (seconds in, ms out)."""

    def __init__(self, reservoir: int = 4096):
        self._lock = threading.Lock()
        self._stages = {k: _Reservoir(reservoir, seed=2) for k in _STAGE_KEYS}
        self.n_explained = 0

    def record_explain(self, explain: dict):
        """Fold one query's EXPLAIN breakdown into the stage reservoirs."""
        with self._lock:
            self.n_explained += 1
            for key, res in self._stages.items():
                ms = explain.get(f"{key}_ms")
                if ms is not None:
                    res.add(ms / 1e3)
            path = explain.get("plan_path")
            plan_ms = explain.get("plan_ms")
            if path is not None and plan_ms is not None:
                split = "plan_full" if path == "full" else "plan_template_hit"
                self._stages[split].add(plan_ms / 1e3)

    def snapshot(self) -> dict:
        """Per-stage ``{"p50_ms", "p99_ms"}`` plus the explained count."""
        with self._lock:
            out = {"explained": self.n_explained}
            for key, res in self._stages.items():
                p50, p99 = res.percentiles_ms()
                out[key] = {"p50_ms": p50, "p99_ms": p99}
            return out


class ColdTierMetrics:
    """Server-wide cold-tier governor telemetry: decoded-engine resident
    bytes (current + high-water) and total demotions.

    ``record_resident`` is fed *post-enforcement* resident bytes by the
    governor, so with ``max_engine_bytes`` set the high-water mark is the
    proof the budget held — a transient decode-then-evict never lands in
    it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.resident_bytes = 0
        self.resident_high_water = 0
        self.n_demotes = 0
        self.n_sweeps = 0

    def record_resident(self, n_bytes: int):
        """One governor sweep's post-enforcement resident-bytes total."""
        with self._lock:
            self.n_sweeps += 1
            self.resident_bytes = int(n_bytes)
            self.resident_high_water = max(self.resident_high_water,
                                           int(n_bytes))

    def record_demote(self, n: int = 1):
        """``n`` engines demoted back to their blobs."""
        with self._lock:
            self.n_demotes += int(n)

    def snapshot(self) -> dict:
        """Point-in-time cold-tier dict (see ``docs/compression.md``)."""
        with self._lock:
            return {
                "resident_bytes": self.resident_bytes,
                "resident_high_water": self.resident_high_water,
                "demotes": self.n_demotes,
                "sweeps": self.n_sweeps,
            }


class FaultMetrics:
    """Failure-containment counters (see ``docs/robustness.md``).

    Every contained failure increments exactly one primary counter:
    ``query_errors`` (futures resolved with a typed ``QueryError``),
    ``quarantined`` (quarantine events — a poison query or a cold table
    entering quarantine), ``deadline_expired`` (futures resolved with
    ``DeadlineExceeded``), ``decode_retries`` (cold decode attempts
    retried after a failure), plus supporting ``exec_retries`` (waves
    re-run after an execution failure) and ``worker_restarts`` is
    reported by the admission queue itself.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.n_query_errors = 0
        self.n_quarantined = 0
        self.n_deadline_expired = 0
        self.n_decode_retries = 0
        self.n_exec_retries = 0

    def record_query_error(self):
        """One future resolved with a typed ``QueryError`` result."""
        with self._lock:
            self.n_query_errors += 1

    def record_quarantined(self):
        """One quarantine event (query statement or cold table)."""
        with self._lock:
            self.n_quarantined += 1

    def record_deadline_expired(self):
        """One future resolved with a ``DeadlineExceeded`` result."""
        with self._lock:
            self.n_deadline_expired += 1

    def record_decode_retry(self):
        """One cold-decode attempt retried after a failure."""
        with self._lock:
            self.n_decode_retries += 1

    def record_exec_retry(self):
        """One submission re-enqueued after a wave execution failure."""
        with self._lock:
            self.n_exec_retries += 1

    def snapshot(self) -> dict:
        """Point-in-time fault-counter dict."""
        with self._lock:
            return {
                "query_errors": self.n_query_errors,
                "quarantined": self.n_quarantined,
                "deadline_expired": self.n_deadline_expired,
                "decode_retries": self.n_decode_retries,
                "exec_retries": self.n_exec_retries,
            }


class Metrics:
    """Per-table ``TableMetrics`` + admission stats + server-wide totals."""

    def __init__(self, reservoir: int = 4096):
        self.reservoir = reservoir
        self._lock = threading.Lock()
        self._tables: dict[str, TableMetrics] = {}
        self.admission = AdmissionMetrics(reservoir)
        self.stages = StageMetrics(reservoir)
        self.cold = ColdTierMetrics()
        self.faults = FaultMetrics()

    def table(self, name: str) -> TableMetrics:
        """The (lazily created) ``TableMetrics`` for ``name``."""
        tm = self._tables.get(name)
        if tm is None:
            with self._lock:
                tm = self._tables.setdefault(name, TableMetrics(self.reservoir))
        return tm

    def record_explain(self, explain: dict):
        """One traced query's stage breakdown -> stage-latency reservoirs."""
        self.stages.record_explain(explain)

    def snapshot(self, plan_cache=None, result_cache=None,
                 template_cache=None) -> dict:
        """Full telemetry snapshot: ``{"tables", "totals"}`` (see
        ``docs/serving.md`` for every field)."""
        with self._lock:
            tables = sorted(self._tables.items())
        out = {name: tm.snapshot() for name, tm in tables}
        totals = {
            "queries_served": sum(t["queries_served"] for t in out.values()),
            "queries_executed": sum(t["queries_executed"] for t in out.values()),
            "batched_fraction": (
                sum(t["batched"] for t in out.values())
                / max(sum(t["queries_executed"] for t in out.values()), 1)),
            "admission": self.admission.snapshot(),
            "stages": self.stages.snapshot(),
            "faults": self.faults.snapshot(),
        }
        if plan_cache is not None:
            totals["plan_cache"] = plan_cache.stats()
        if result_cache is not None:
            totals["result_cache"] = result_cache.stats()
        if template_cache is not None:
            totals["template_cache"] = template_cache.stats()
        return {"tables": out, "totals": totals}
