"""AQPServer: multi-table AQP serving front-end with streaming admission.

Pipeline per submitted SQL string (``submit`` -> ``QueryFuture``):

    normalize -> plan cache -> template cache -> result cache -> dedupe -> enqueue
       |            |              |                                          |
       |       (epoch-keyed   (epoch-keyed                           StreamingAdmission
       |        QueryPlans)    PlanTemplates:                        drains plan-shape
       v                       zero-parse shape hits)                waves -> futures
    FROM <table> resolved via TableCatalog (PlanError if unknown)

**Planner fast path** (zero-parse templating): when ``plan_templates`` is
on, a submission that misses the exact-text plan cache is fingerprinted
(``sql.fingerprint_sql`` — a tokenizer pass, no parse) into a
literal-stripped shape key + literal vector. A shape that hits the
epoch-keyed template cache skips ``parse_sql``/``plan_query`` entirely:
the submission carries ``(template, literals)`` with ``plan=None`` and the
admission worker binds every such submission of a wave in one
``PlanTemplate.bind_batch`` call per template — literal encoding for the
whole wave is a single numpy pass. Bound plans are bit-for-bit equal to
the cold path's (asserted by tests and the ``--plan-smoke`` lane). Cold
shapes plan as before and compile + cache their template as a side effect;
with ``planner_workers > 0`` that cold planning runs on a small planner
pool so the submit path never blocks on a parse.

``submit`` enqueues immediately and returns a future; the admission worker
drains the queue into execution waves under a ``max_wait_ms`` /
``max_batch`` policy and resolves futures as waves complete, without
blocking later arrivals. ``query_batch`` survives as a thin synchronous
wrapper: submit everything, flush, wait (with drain-and-retry when the
bounded queue rejects a submission — see ``retry_timeout_s``).

**Backpressure**: the admission queue is bounded by ``max_queue_depth``;
a full queue resolves the overflowing submission's futures with a typed
``AdmissionRejected`` *result* (never an exception raised in the worker)
according to ``shed_policy`` — see ``scheduler.StreamingAdmission``.

**Locking** (lock-split submit path): two locks replace the original
single server RLock so concurrent submitters no longer serialize against
each other or against wave resolution:

  * ``_plan_lock`` — read-mostly: guards the plan cache only. Planning
    itself (parse + literal encoding + GROUP BY leaf expansion, the
    expensive part of admission) runs with NO lock held; only the cache
    get/put bracket it.
  * ``_state_lock`` — short critical sections: result cache, metrics, and
    the in-flight dedupe map. Wave resolution snapshots futures under it
    but calls ``set_result``/``set_exception`` outside it, so done
    callbacks never run under (or deadlock against) a server lock.

The only nesting is ``_state_lock`` -> ``_plan_lock`` (re-plan inside a
wave); nothing acquires them in the reverse order. ``single_lock=True``
collapses both to one lock and plans inside it — the pre-split critical
section, kept as the contention baseline for ``benchmarks/bench_serving``.

GROUP BY queries ride the batched fast path: plans arrive from
``core/query.py`` already expanded into per-category leaf plans, the server
executes every *uncached* leaf of every in-flight query through the
scheduler's fused ``batched_weightings`` launches, and reassembles per-group
results. Leaf results are cached under plan-canonical keys
(``QueryPlan.canonical_key``), so overlapping GROUP BYs — textual variants,
or re-issues after partial eviction — share entries.

Staleness: every ``AQPFramework`` bumps its epoch on ingest/append_rows;
cache entries are tagged with the epoch captured at *planning* time, so a
result computed before an ``append_rows`` that lands mid-flight is stored
under the old epoch and can never be served after the bump — and a query
against a stale (un-rebuilt) table fails with ``RuntimeError`` exactly like
the single-table ``AQPFramework.query``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time

from repro_torch.core import sql as sqlmod
from repro_torch.core.query import (AdmissionRejected, DeadlineExceeded,
                                    PlanError, QueryError, QueryPlan,
                                    QueryResult, assemble_groups)
from repro_torch.obs.export import spans_to_events, trace_json, write_trace
from repro_torch.obs.trace import QueryTrace, Tracer
from repro_torch.serve.aqp.cache import LRUCache, normalize_sql
from repro_torch.serve.aqp.catalog import (ColdTable, TableCatalog,
                                           TableQuarantinedError)
from repro_torch.serve.aqp.metrics import Metrics
from repro_torch.serve.aqp.scheduler import (BatchScheduler, PlannerPool,
                                             StreamingAdmission)

import repro_torch.serve.aqp.faults as faults


class QueryFuture(concurrent.futures.Future):
    """Handle for one submitted query; resolves to a ``QueryResult``.

    Standard ``concurrent.futures.Future`` API (``result(timeout)``,
    ``done()``, ``exception()``, ``add_done_callback``) plus the originating
    ``sql`` text for bookkeeping. Overload decisions resolve it with an
    ``AdmissionRejected`` result (``result().rejected`` is True), never an
    exception.
    """

    def __init__(self, sql: str = ""):
        super().__init__()
        self.sql = sql


@dataclasses.dataclass
class _Submission:
    """One enqueued (not yet executed) query and its attached futures.

    ``plan`` may be None for a template-cache hit: the submission then
    carries ``(template, literals)`` and the admission worker binds the
    plan at wave time (one ``bind_batch`` per template per wave).
    """

    norm: str
    table: str
    plan: QueryPlan | None
    epoch: int                       # table epoch captured at planning time
    t_submit: float
    futures: list                    # [QueryFuture]; index 0 is the primary
    missing: list | None = None      # GROUP BY: leaf indices still to execute
    cached_leaves: dict = dataclasses.field(default_factory=dict)
    retries: int = 0                 # stale-epoch re-enqueues (bounded)
    trace: QueryTrace | None = None  # per-query trace (tracing enabled only)
    template: object = None          # PlanTemplate (deferred-bind hits only)
    literals: tuple | None = None    # fingerprint literal vector (ditto)
    deadline_at: float | None = None  # perf_counter deadline (deadline_ms)
    exec_failures: int = 0           # wave execution failures (bounded retry)
    requeued: bool = False           # True while re-admitted to the queue


def _leaf_key(plan: QueryPlan) -> str:
    """Result-cache key for one GROUP BY leaf plan.

    Plan-canonical (text-independent), prefixed so it can never collide
    with a normalized-SQL whole-query key (SQL never starts with ``@``).
    """
    return "@leaf|" + plan.canonical_key()


class AQPServer:
    """Multi-table AQP serving front-end (catalog + admission + caches).

    Args:
        catalog: existing ``TableCatalog`` to serve from (default: new).
        mode: scheduler execution mode — ``"cuda"`` (the hand-written
            kernels on the card) / ``"ref"`` (their plain versions on the
            CPU) / ``"numpy"`` (no fused launch) / ``None`` (``"cuda"``,
            raising without a card; see ``scheduler.BatchScheduler``).
        plan_cache_size / result_cache_size: LRU capacities (entries).
        plan_templates: zero-parse planner fast path (default on) — see
            the module docstring; ``docs/serving.md`` has the architecture.
        template_cache_size: ``PlanTemplate`` LRU capacity (shapes).
        planner_workers: > 0 offloads *cold* planning to a
            ``scheduler.PlannerPool`` of that many workers, so the submit
            path never blocks on a parse (0 = plan inline, the default).
        max_result_bytes: approximate byte budget for the result cache
            (``<= 0`` = entries-only bounding); the LRU end evicts until
            the estimated footprint fits (``cache.LRUCache``).
        max_group / min_group: fused-launch group bounds (scheduler knobs).
        max_wait_ms: admission policy — how long the oldest queued
            submission may wait before a partial wave fires.
        max_batch: admission policy — wave fires early once this many
            submissions are queued.
        max_queue_depth: backpressure — bound on the admission queue
            (``<= 0`` = unbounded; default 1024).
        shed_policy: what a full queue does — ``"reject"`` (turn the new
            submission away), ``"shed_oldest"`` (evict the oldest queued
            submission to admit the new one) or ``"block"`` (pace the
            submitter until the worker drains space). Rejected/shed
            futures resolve with ``AdmissionRejected``.
        retry_timeout_s: ``query_batch``'s drain-and-retry budget when its
            submissions are rejected by the bounded queue.
        single_lock: compatibility/benchmark baseline — plan under the one
            big server lock (the pre-split critical section) instead of the
            lock-split submit path.
        trace_enabled: per-query tracing (``repro_torch.obs``): every
            submission carries a ``QueryTrace`` through submit -> admission
            -> wave -> resolution, its result gains an ``explain`` stage
            breakdown, stage spans land in the server's span ring
            (``export_trace``/``trace_json``), stage-latency percentiles
            fold into ``stats()["totals"]["stages"]`` and queries slower
            than ``slow_query_ms`` enter the bounded slow-query log.
            Off by default: the disabled path adds no allocation and no
            clock reads beyond the pre-existing ``t_submit`` stamp.
        trace_buffer: span ring capacity (oldest spans overwritten).
        slow_query_ms: slow-query log threshold on a traced query's
            end-to-end latency (``explain()["total_ms"]``).
        max_engine_bytes / demote_idle_s: cold-tier memory governor —
            budget on decoded cold-table engines and idle-demotion window;
            see ``docs/compression.md`` for semantics and defaults.
        device: where synopses are built (``None``: the CUDA device,
            raising without one; ``"cpu"`` runs the kernels' plain
            versions) — handed to a catalog made here, and to the
            scheduler as the ``"cuda"`` mode's card.
    """

    # A submission whose table epoch keeps moving mid-wave re-enqueues at
    # most this many times before its futures fail (each retry implies a
    # full rebuild landed inside one wave — more than a couple in a row
    # means the table is being rebuilt faster than queries can run).
    MAX_STALE_RETRIES = 5

    # Bounded slow-query log: newest SLOW_LOG_CAP breakdowns whose total
    # latency crossed ``slow_query_ms`` (a window, like the span ring).
    SLOW_LOG_CAP = 256

    # A query whose wave raises this many times is quarantined: its futures
    # resolve with a typed QueryError and re-submissions of the same
    # normalized text are refused until the quarantine clears (a poison
    # query is contained, not retried forever).
    MAX_EXEC_FAILURES = 2

    # Bounded quarantine map (norm -> cause): oldest entries fall out so a
    # hostile workload cannot grow server state without bound.
    QUARANTINE_CAP = 1024

    def __init__(self, catalog: TableCatalog | None = None,
                 mode: str | None = None,
                 plan_cache_size: int = 4096,
                 result_cache_size: int = 16384,
                 plan_templates: bool = True,
                 template_cache_size: int = 512,
                 planner_workers: int = 0,
                 max_result_bytes: int = 0,
                 max_group: int = 256, min_group: int = 2,
                 max_wait_ms: float = 2.0, max_batch: int = 64,
                 max_queue_depth: int = 1024, shed_policy: str = "reject",
                 retry_timeout_s: float = 30.0, single_lock: bool = False,
                 trace_enabled: bool = False, trace_buffer: int = 65536,
                 slow_query_ms: float = 100.0,
                 max_engine_bytes: int = 0, demote_idle_s: float = 0.0,
                 device=None):
        self.catalog = catalog or TableCatalog(device=device)
        self.max_engine_bytes = int(max_engine_bytes)
        self.demote_idle_s = float(demote_idle_s)
        self.tracer = Tracer(capacity=trace_buffer, enabled=trace_enabled)
        self.slow_query_ms = float(slow_query_ms)
        self._slow_log: collections.deque = collections.deque(
            maxlen=self.SLOW_LOG_CAP)
        self.scheduler = BatchScheduler(self.catalog, mode=mode,
                                        max_group=max_group,
                                        min_group=min_group,
                                        tracer=self.tracer, device=device)
        self.admission = StreamingAdmission(self._execute_wave,
                                            max_wait_ms=max_wait_ms,
                                            max_batch=max_batch,
                                            max_queue_depth=max_queue_depth,
                                            shed_policy=shed_policy,
                                            shed_cb=self._on_shed,
                                            tracer=self.tracer,
                                            idle_cb=self._govern_cold,
                                            error_cb=self._on_wave_error)
        self.plan_cache = LRUCache(plan_cache_size)
        self.result_cache = LRUCache(result_cache_size,
                                     max_bytes=max_result_bytes)
        # Zero-parse fast path: fingerprint-shape -> PlanTemplate, epoch-
        # keyed like the plan cache and guarded by the same _plan_lock.
        self.plan_templates = bool(plan_templates)
        self.template_cache = LRUCache(template_cache_size)
        self._planner = (PlannerPool(planner_workers)
                         if planner_workers > 0 else None)
        self.metrics = Metrics()
        self.retry_timeout_s = float(retry_timeout_s)
        self.single_lock = bool(single_lock)
        self._wiring: dict[str, tuple] = {}   # name -> (framework, callback)
        # Lock split (see module docstring): _state_lock guards result
        # cache + metrics + in-flight map; _plan_lock guards the plan cache.
        # Both RLocks: invalidation callbacks and the single_lock baseline
        # re-enter them. single_lock collapses the two into one.
        self._state_lock = threading.RLock()
        self._plan_lock = (self._state_lock if single_lock
                           else threading.RLock())
        self._inflight: dict[str, _Submission] = {}
        # norm -> (table, cause): statements refused after repeated
        # execution failure. Guarded by _state_lock; bounded; cleared by
        # clear_quarantine(), an epoch bump on the table (_purge), or
        # falling off the cap.
        self._quarantine: collections.OrderedDict = collections.OrderedDict()

    # ------------------------------------------------------------ registration

    def register(self, name: str, framework) -> "AQPServer":
        """Register a table; wires eager cache purging to its invalidation.
        Re-registering a name detaches the previous framework's wiring so a
        replaced table can no longer purge its successor's cache entries."""
        self.catalog.register(name, framework)
        self._wire(name, framework)
        return self

    def register_table(self, name: str, table: dict, **kwargs) -> "AQPServer":
        """Convenience: build + ingest a framework from a raw column dict
        (kwargs forward to ``TableCatalog.register_table``) and register it."""
        fw = self.catalog.register_table(name, table, **kwargs)
        self._wire(name, fw)
        return self

    def register_cold(self, name: str, blob: bytes, compressed=None,
                      params=None, fastpath=None, decode_retries: int = 2,
                      decode_backoff_s: float = 0.01,
                      breaker_reset_s: float = 0.0) -> "AQPServer":
        """Register a cold (storage-tier) table: a bit-packed synopsis blob
        that decodes lazily on the first query against it. The decode
        latency and blob size land in this table's metrics (``stats()``
        ``"cold"`` section); ``compressed`` (a ``CompressedTable``) enables
        GD-native ``rebuild`` on the returned catalog entry.

        The blob is validated (integrity frame + magic, inside
        ``ColdTable``) *before* any telemetry is recorded, so a rejected
        registration leaves no phantom metrics entry behind. The retry /
        backoff / breaker knobs configure decode resilience (retries, then
        quarantine with a typed error — see ``docs/robustness.md``); fault
        events land in ``stats()["totals"]["faults"]`` and on the trace
        ring's "faults" lane."""
        cold = self.catalog.register_cold(
            name, blob, compressed=compressed, params=params,
            fastpath=fastpath,
            decode_cb=lambda n, s, name=name: self._on_cold_decode(name, n, s),
            decode_retries=decode_retries, decode_backoff_s=decode_backoff_s,
            breaker_reset_s=breaker_reset_s,
            fault_cb=lambda ev, n, exc, name=name:
                self._on_cold_fault(name, ev, n, exc))
        self.metrics.table(name).record_cold_register(len(blob))
        self._wire(name, cold)
        return self

    def _on_cold_fault(self, name: str, event: str, n: int, exc):
        """ColdTable fault callback: decode retries and quarantine events
        into the fault counters and the trace ring's "faults" lane."""
        if event == "decode_retry":
            self.metrics.faults.record_decode_retry()
        else:                              # "quarantine"
            self.metrics.faults.record_quarantined()
        if self.tracer.enabled:
            self.tracer.instant(event, track="faults",
                                attrs={"table": name, "attempt": n,
                                       "error": repr(exc)})

    def _wire(self, name: str, framework):
        old = self._wiring.pop(name, None)
        if old is not None:
            old[0].off_invalidate(old[1])
            self._purge(name)     # drop entries computed from the old table
        cb = lambda fw, name=name: self._purge(name)  # noqa: E731
        framework.on_invalidate(cb)
        self._wiring[name] = (framework, cb)

    # ------------------------------------------------------- cold-tier governor

    def _on_cold_decode(self, name: str, n_bytes: int, decode_s: float):
        """ColdTable decode callback: per-table telemetry, then immediate
        budget enforcement (a decode is exactly when resident bytes grow,
        so waiting for the next between-waves sweep could overshoot)."""
        try:
            cold = self.catalog.resolve(name)
            resident = getattr(cold, "resident_bytes", None)
        except PlanError:       # unregistered mid-decode
            resident = None
        self.metrics.table(name).record_cold_decode(
            n_bytes, decode_s, resident_bytes=resident)
        if self.max_engine_bytes > 0:
            self._govern_cold(idle=False)

    def _govern_cold(self, idle: bool = True):
        """The cold-tier memory governor: one sweep over the catalog's
        ``ColdTable`` entries.

        Two policies, both LRU-ordered by ``TableMetrics.last_activity``:
        idle demotion (``demote_idle_s > 0``: engines untouched for that
        long drop back to their blobs; only on between-waves sweeps, where
        ``idle=True``) and budget enforcement (``max_engine_bytes > 0``:
        least-recently-active engines demote until the decoded-resident
        total fits). Demotion is epoch-stable, so no cache purge and no
        invalidation callbacks — an in-flight wave holding a demoted
        engine's reference finishes safely and the next query re-decodes.
        Post-enforcement resident bytes land in the server-wide high-water
        telemetry (``stats()["cold"]``)."""
        budget = self.max_engine_bytes
        idle_s = self.demote_idle_s
        if budget <= 0 and idle_s <= 0:
            return
        resident = [(n, t) for n, t in self.catalog.cold_tables()
                    if t.engine is not None]

        def last_activity(name):
            la = self.metrics.table(name).last_activity
            return la if la is not None else 0.0

        demoted = 0
        if idle and idle_s > 0:
            now = time.perf_counter()
            for name, t in resident:
                if now - last_activity(name) >= idle_s and t.demote():
                    self.metrics.table(name).record_demote()
                    demoted += 1
        if budget > 0:
            live = sorted(((n, t) for n, t in resident if t.engine is not None),
                          key=lambda nt: last_activity(nt[0]))
            total = sum(t.resident_bytes for _, t in live)
            for name, t in live:
                if total <= budget:
                    break
                n_bytes = t.resident_bytes
                if t.demote():
                    self.metrics.table(name).record_demote()
                    demoted += 1
                    total -= n_bytes
        if demoted:
            self.metrics.cold.record_demote(demoted)
        self.metrics.cold.record_resident(
            sum(t.resident_bytes for _, t in self.catalog.cold_tables()))

    def demote(self, name: str) -> bool:
        """Explicitly demote one cold table's decoded engine back to its
        blob (same epoch-stable semantics as the governor — caches stay
        valid, the next query re-decodes). Returns True if an engine was
        resident and demoted; False for unknown, non-cold, or already-cold
        tables."""
        try:
            t = self.catalog.resolve(name)
        except PlanError:
            return False
        if not isinstance(t, ColdTable) or not t.demote():
            return False
        self.metrics.table(name).record_demote()
        self.metrics.cold.record_demote()
        self.metrics.cold.record_resident(
            sum(ct.resident_bytes for _, ct in self.catalog.cold_tables()))
        return True

    def unregister(self, name: str):
        """Drop a table: detach its invalidation wiring and purge its
        cache entries."""
        old = self._wiring.pop(name, None)
        if old is not None:
            old[0].off_invalidate(old[1])
        self.catalog.unregister(name)
        self._purge(name)

    def close(self):
        """Shut down: join the planner pool (pending cold plans enqueue or
        fail their futures), drain+stop the admission worker, then detach
        every framework callback so a discarded server is not kept alive
        (and purged into) by long-lived frameworks."""
        if self._planner is not None:
            self._planner.close()
        self.admission.close()
        for name, (fw, cb) in list(self._wiring.items()):
            fw.off_invalidate(cb)
        self._wiring.clear()

    def _purge(self, name: str):
        # Sequential (never nested) acquisition: purging needs no atomicity
        # across the two caches — each entry validates its epoch anyway.
        with self._plan_lock:
            self.plan_cache.purge_table(name)
            self.template_cache.purge_table(name)
        with self._state_lock:
            self.result_cache.purge_table(name)
            # An epoch bump (rebuild / re-register) gives quarantined
            # statements against this table a fresh chance.
            for norm in [n for n, (t, _) in self._quarantine.items()
                         if t == name]:
                del self._quarantine[norm]

    # ----------------------------------------------------------------- queries

    def submit(self, sql_text: str,
               deadline_ms: float | None = None) -> QueryFuture:
        """Enqueue one query; returns immediately with a ``QueryFuture``.

        Planning (cached), result-cache lookup and in-flight deduplication
        happen inline on the calling thread — a cache hit resolves the
        future before ``submit`` returns, and planning errors (unknown
        table/column, stale synopsis) are set ON the future rather than
        raised, so streaming callers handle every outcome in one place.
        A full admission queue resolves the future with a typed
        ``AdmissionRejected`` result per ``shed_policy``; otherwise the
        query enters the queue and resolves when its wave completes.

        ``deadline_ms`` attaches a per-query deadline: the drain policy
        fires a wave early rather than let the deadline expire in the
        queue, and a query whose deadline has passed by the time its wave
        starts skips execution and resolves with a typed
        ``DeadlineExceeded`` result. Deadline-carrying submissions skip
        in-flight deduplication (each deadline is its own contract); they
        still hit the result cache. A statement quarantined after
        repeated execution failures resolves immediately with a typed
        ``QueryError`` (``kind="quarantined"``).

        On the lock-split path the expensive planning step runs with no
        server lock held; only the dedupe check / admission bookkeeping
        take the short state lock.
        """
        fut = QueryFuture(sql_text)
        t_submit = time.perf_counter()
        norm = normalize_sql(sql_text)
        deadline_at = (t_submit + deadline_ms / 1e3
                       if deadline_ms is not None else None)
        # Per-query trace only when tracing: the disabled path pays no
        # allocation beyond the future itself.
        trace = QueryTrace(t_submit) if self.tracer.enabled else None
        sub = None
        with self._state_lock:
            self.metrics.admission.record_submit()
            quarantined = self._quarantine.get(norm)
            if quarantined is not None:
                self.metrics.faults.record_query_error()
            else:
                inflight = (self._inflight.get(norm)
                            if deadline_at is None else None)
                if inflight is not None:      # identical query already queued
                    inflight.futures.append(fut)
                    return fut
                if self.single_lock:          # legacy: plan under the lock
                    sub = self._plan_admit(fut, norm, t_submit, trace,
                                           deadline_at)
        if quarantined is not None:
            fut.set_result(QueryError(
                error=quarantined[1], kind="quarantined",
                retries=self.MAX_EXEC_FAILURES))
            return fut
        if not self.single_lock:
            sub = self._plan_admit(fut, norm, t_submit, trace, deadline_at)
        if sub is not None:
            self._enqueue(sub)
        return fut

    def flush(self):
        """Ask the admission worker to drain the queue now (no-op if empty)."""
        self.admission.flush()

    def query(self, sql_text: str) -> QueryResult:
        """Synchronous single query (submit + flush + wait, with the same
        drain-and-retry as ``query_batch`` if the queue is full)."""
        return self.query_batch([sql_text])[0]

    def query_batch(self, sqls: list[str],
                    retry_timeout_s: float | None = None
                    ) -> list[QueryResult]:
        """Synchronous wave: results align with ``sqls``.

        Thin wrapper over the streaming path: submits everything, flushes
        the admission queue (so a blocking caller never pays ``max_wait_ms``)
        and waits. Raises PlanError for unknown tables/columns and
        RuntimeError for stale tables — the serving contract matches
        ``AQPFramework.query``.

        A submission rejected by the bounded admission queue (``"reject"``
        or ``"shed_oldest"`` shed policy under load) is **drained and
        retried**: the queue is flushed and the query re-submitted until it
        is answered or ``retry_timeout_s`` (default: the server's
        ``retry_timeout_s``) elapses, at which point ``TimeoutError`` is
        raised. A synchronous caller therefore never sees an
        ``AdmissionRejected`` result — that outcome is for streaming
        clients that chose to observe overload.
        """
        budget = (self.retry_timeout_s if retry_timeout_s is None
                  else float(retry_timeout_s))
        deadline = time.monotonic() + budget
        futures = [self.submit(sql) for sql in sqls]
        self.flush()
        out = []
        for i, fut in enumerate(futures):
            while True:
                res = fut.result()            # plan/stale errors raise here
                if not getattr(res, "rejected", False):
                    break
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"query_batch: admission queue still full after "
                        f"{budget:.1f}s of drain-and-retry "
                        f"(last outcome: {res.reason}, queue depth "
                        f"{res.queue_depth})")
                self.flush()                  # drain, then retry
                time.sleep(0.001)
                fut = self.submit(sqls[i])
                self.flush()
            out.append(res)
        return out

    # ------------------------------------------------------ submit-side helpers

    def _plan_admit(self, fut: QueryFuture, norm: str, t_submit: float,
                    trace: QueryTrace | None = None,
                    deadline_at: float | None = None) -> _Submission | None:
        """Plan ``norm`` (fast path first), then admit it.

        Resolution order: exact-text plan cache -> template cache (zero
        parse; the plan bind is deferred to the wave) -> cold planning —
        inline, or on the planner pool when ``planner_workers > 0`` (the
        pool job admits AND enqueues; this call then returns None with the
        future pending). Returns the ``_Submission`` the caller should
        enqueue, or None when the future was settled inline / handed off.
        """
        fast = self._plan_fast(norm)
        if fast is not None:
            return self._admit(fut, norm, t_submit, trace, deadline_at,
                               *fast)
        if self._planner is not None:
            self._planner.submit(self._plan_async, fut, norm, t_submit,
                                 trace, deadline_at)
            return None
        return self._plan_cold_admit(fut, norm, t_submit, trace, deadline_at)

    def _plan_fast(self, norm: str):
        """Lock-cheap planner fast path: exact-text plan-cache hit, else
        template-cache hit on the literal-stripped fingerprint shape (no
        ``parse_sql`` on either). Returns admit args or None (plan cold).
        """
        with self._plan_lock:
            entry = self.plan_cache.get(norm, self.catalog.epoch)
        if entry is not None:
            return (entry.table, entry.value, entry.epoch, "plan_cache",
                    None, None)
        if not self.plan_templates:
            return None
        try:
            fp = sqlmod.fingerprint_sql(norm)
        except sqlmod.SQLError:
            return None          # untokenizable: let the cold parse raise
        with self._plan_lock:
            tentry = self.template_cache.get(fp.shape, self.catalog.epoch)
            if tentry is None:
                self.template_cache.miss(None)
        if tentry is not None and tentry.value.n_slots == len(fp.literals):
            return (tentry.table, None, tentry.epoch, "template",
                    tentry.value, fp.literals)
        return None

    def _plan_cold_admit(self, fut: QueryFuture, norm: str, t_submit: float,
                         trace: QueryTrace | None,
                         deadline_at: float | None = None
                         ) -> _Submission | None:
        """Cold-plan ``norm`` (parse + plan + template compile), then admit."""
        try:
            table, plan, epoch = self._plan_cold(norm)
        except Exception as exc:          # PlanError / stale RuntimeError
            fut.set_exception(exc)
            return None
        return self._admit(fut, norm, t_submit, trace, deadline_at, table,
                           plan, epoch, "full", None, None)

    def _plan_async(self, fut: QueryFuture, norm: str, t_submit: float,
                    trace: QueryTrace | None,
                    deadline_at: float | None = None):
        """Planner-pool job: cold-plan, admit, enqueue (worker thread)."""
        sub = self._plan_cold_admit(fut, norm, t_submit, trace, deadline_at)
        if sub is not None:
            self._enqueue(sub)

    def _admit(self, fut: QueryFuture, norm: str, t_submit: float,
               trace: QueryTrace | None, deadline_at: float | None,
               table: str, plan: QueryPlan | None, epoch: int, path: str,
               template, literals) -> _Submission | None:
        """Admit a planned (or template-deferred) query under a short
        state-lock section.

        Returns the ``_Submission`` the caller should enqueue, or None when
        the future was settled inline (result-cache hit, fully-cached
        GROUP BY) or attached to a submission another thread planned
        concurrently. Future resolution happens after the lock is released.
        """
        if trace is not None:
            trace.t_planned = time.perf_counter()
            trace.plan_cache_hit = path == "plan_cache"
            trace.plan_path = path
        hit = None
        with self._state_lock:
            inflight = (self._inflight.get(norm)
                        if deadline_at is None else None)
            if inflight is not None:      # planned concurrently: attach
                inflight.futures.append(fut)
                return None
            rentry = self.result_cache.get(norm, self.catalog.epoch)
            if rentry is not None:
                self.metrics.table(table).record_result_hit()
                hit = rentry.value
            else:
                self.result_cache.miss(table)
                sub = _Submission(norm, table, plan, epoch, t_submit, [fut],
                                  trace=trace, template=template,
                                  literals=literals, deadline_at=deadline_at)
                if plan is not None and plan.leaf_plans:
                    self._lookup_leaves(sub)
                    if not sub.missing:   # every leaf served from cache
                        hit = self._finish_cached_group(sub)
                if hit is None and deadline_at is None:
                    # Deadline-carrying submissions are never dedupe
                    # targets: each deadline is its own contract.
                    self._inflight[norm] = sub
        if hit is not None:
            if trace is not None:
                trace.result_cache_hit = True
                trace.t_resolved = time.perf_counter()
                exp = self._trace_done(trace, norm)
                fut.set_result(dataclasses.replace(hit, latency_s=0.0,
                                                   explain=exp))
            else:
                fut.set_result(dataclasses.replace(hit, latency_s=0.0))
            return None
        if trace is not None:
            trace.t_admitted = time.perf_counter()
        return sub

    def _enqueue(self, sub: _Submission, requeue: bool = False):
        """Hand an admitted submission to the streaming-admission queue.
        Backpressure rejection is handled by ``_on_shed`` (wired as the
        admission's shed callback); a closed server fails the futures.
        ``requeue=True`` re-admits a wave item from the worker thread
        itself, bypassing backpressure (``StreamingAdmission.requeue`` —
        blocking or shedding there would deadlock or drop an
        already-admitted query)."""
        try:
            if requeue:
                # Marks the submission as queue-owned again: a wave-level
                # error callback skips requeued items (the next wave, not
                # the supervisor, owns their resolution).
                sub.requeued = True
                self.admission.requeue(sub, sub.t_submit)
            else:
                self.admission.submit(sub, sub.t_submit)
        except Exception as exc:          # closed server: fail, don't leak
            with self._state_lock:
                if self._inflight.get(sub.norm) is sub:
                    del self._inflight[sub.norm]
                futures = list(sub.futures)
            for f in futures:
                f.set_exception(exc)

    def _on_shed(self, sub: _Submission, reason: str, depth: int):
        """Backpressure decision (runs on the deciding submitter's thread,
        no admission lock held): detach the submission from the in-flight
        dedupe map and resolve every attached future with a typed
        ``AdmissionRejected`` result — overload is an answer, not a worker
        exception."""
        with self._state_lock:
            if self._inflight.get(sub.norm) is sub:
                del self._inflight[sub.norm]
            futures = list(sub.futures)
            self.metrics.admission.record_shed(reason, depth)
        if sub.trace is not None:
            sub.trace.rejected = True
            sub.trace.t_resolved = time.perf_counter()
            self.tracer.instant("shed", track="admission",
                                attrs={"reason": reason, "depth": depth,
                                       "qid": sub.trace.qid})
            sub.trace.emit_spans(self.tracer, sub.norm)
        for fut in futures:
            fut.set_result(AdmissionRejected(reason=reason,
                                             queue_depth=depth))

    def _plan_cold(self, norm: str):
        """Cold planning: parse + plan -> (table, plan, epoch). Compiles and
        caches the shape's ``PlanTemplate`` as a side effect, so the next
        query of this shape skips the parse entirely.

        Engine and epoch come from one atomic ``catalog.snapshot``, so the
        plan is tagged with exactly the epoch of the synopsis its literals
        were encoded against — a rebuild racing the planning can never
        produce a plan that validates (in the caches or at wave execution)
        against a synopsis it was not planned for.

        Only the cache get/puts take ``_plan_lock``; the planning work
        itself (parse + encode + GROUP BY leaf expansion + template
        compile) runs unlocked, so concurrent submitters planning
        *different* queries overlap. Two threads planning the *same* query
        race benignly: both plans are identical and the puts are
        idempotent.
        """
        faults.hook("planner")
        parsed = sqlmod.parse_sql(norm)
        table = parsed.table
        with self._plan_lock:
            self.plan_cache.miss(table if table in self.catalog else None)
        engine, epoch = self.catalog.snapshot(table)  # PlanError/RuntimeError
        plan = engine.plan_query(parsed)
        template = fp = None
        if self.plan_templates:
            try:
                template = engine.plan_template(parsed)
                fp = sqlmod.fingerprint_sql(norm)
            except Exception:
                template = None   # shape not templatable: plan cold next time
        with self._plan_lock:
            self.plan_cache.put(norm, table, epoch, plan)
            if template is not None and template.n_slots == len(fp.literals):
                self.template_cache.put(fp.shape, table, epoch, template)
        return table, plan, epoch

    def _lookup_leaves(self, sub: _Submission):
        """Fill ``sub.cached_leaves`` / ``sub.missing`` from the result cache
        (one recorded miss per missing leaf, matching the per-leaf hits).
        Caller holds ``_state_lock``."""
        sub.missing = []
        sub.cached_leaves = {}
        for i, leaf in enumerate(sub.plan.leaf_plans):
            entry = self.result_cache.get(_leaf_key(leaf), self.catalog.epoch)
            if entry is not None:
                sub.cached_leaves[i] = entry.value
            else:
                self.result_cache.miss(sub.table)
                sub.missing.append(i)

    def _replan(self, sub: _Submission):
        """The table changed while ``sub`` sat in the admission queue: its
        plan may encode literals against a synopsis that no longer exists.
        Re-plan against the current synopsis (plan + template caches were
        purged by the epoch bump — always the cold path, which recompiles
        the shape's template) and refresh the per-leaf cache lookups;
        raises the usual PlanError/RuntimeError if the table is gone or
        stale."""
        sub.table, sub.plan, sub.epoch = self._plan_cold(sub.norm)
        sub.template = sub.literals = None   # concrete plan supersedes
        sub.missing = None
        if sub.plan.leaf_plans:
            with self._state_lock:
                self._lookup_leaves(sub)

    def _finish_cached_group(self, sub: _Submission,
                             result: QueryResult | None = None) -> QueryResult:
        """GROUP BY answered entirely from per-leaf cache entries (state
        lock held); returns the assembled result for the caller to set.
        ``result`` carries a pre-assembled answer from the wave path (a
        deferred template bind learns its leaves are all cached only after
        binding) so assembly is never repeated under the lock."""
        if result is None:
            result = assemble_groups(sub.plan, sub.cached_leaves)
        tm = self.metrics.table(sub.table)
        tm.record_result_hit()
        tm.record_group_expansion(0, len(sub.cached_leaves))
        self.result_cache.put(sub.norm, sub.table, sub.epoch, result)
        return result

    def _trace_done(self, trace: QueryTrace, label: str) -> dict:
        """Finalize a resolved query's trace: assemble the EXPLAIN
        breakdown, emit its stage spans, fold the stage latencies into the
        metrics reservoirs and (past ``slow_query_ms``) append to the
        bounded slow-query log. Returns the explain dict for attachment to
        the outgoing result. No server lock held (metrics self-lock)."""
        exp = trace.explain()
        trace.emit_spans(self.tracer, label)
        self.metrics.record_explain(exp)
        if exp["total_ms"] >= self.slow_query_ms:
            entry = dict(exp)
            entry["sql"] = label
            self._slow_log.append(entry)
        return exp

    # ------------------------------------------------------- admission worker

    def _execute_wave(self, batch: list, drain):
        """Execute one drained wave (admission-worker thread).

        Submissions whose table epoch moved while they sat in the queue
        (append_rows/rebuild landed mid-flight) are re-planned first — a
        plan encodes literals against one specific synopsis, so executing
        it against a rebuilt one would be silently wrong; if the table is
        stale (no rebuild yet) the re-plan raises and the futures resolve
        with that error. Then expands GROUP BY submissions into their
        uncached leaf plans, runs ALL work units (plain queries + leaves of
        every in-flight GROUP BY) through one ``BatchScheduler.execute``
        call — plan-shape grouping inside the scheduler fuses everything
        fusable — then reassembles, caches and resolves. A scheduler error
        isolates to per-item retry so one poisoned query cannot reject an
        entire wave's futures.

        Locking: metrics and cache puts take the short state lock; the
        re-plan, the scheduler execution and the future resolution all run
        outside it, so submitters are never blocked behind a wave.
        """
        # Drained items are worker-owned now; clearing the requeue flag
        # FIRST means a wave-level crash (including the injected
        # wave_execute fault below) routes every un-requeued item through
        # the supervisor exactly once.
        for sub in batch:
            sub.requeued = False
        faults.hook("wave_execute")
        now = time.perf_counter()
        with self._state_lock:
            self.metrics.admission.record_drain(drain)
            for sub in batch:
                self.metrics.admission.record_wait(now - sub.t_submit)
        for sub in batch:
            if sub.trace is not None:
                sub.trace.t_drained = now
                sub.trace.drain_cause = drain.cause
                sub.trace.wave_size = drain.size
        # Per-query deadlines: a submission whose deadline passed while it
        # sat in the queue skips the fused launch entirely and resolves
        # with a typed DeadlineExceeded result.
        expired = [sub for sub in batch
                   if sub.deadline_at is not None and now >= sub.deadline_at]
        if expired:
            gone = {id(s) for s in expired}
            batch = [sub for sub in batch if id(sub) not in gone]
            self._resolve_expired(expired)
        prefailed: dict[int, Exception] = {}
        for sub in batch:
            if sub.epoch != self.catalog.epoch(sub.table):
                try:
                    self._replan(sub)
                except Exception as exc:
                    prefailed[id(sub)] = exc

        # Deferred template binds: every template-hit submission of the
        # wave still carries (template, literals). Group them by template
        # and bind each group in ONE bind_batch call — the wave's literal
        # encoding collapses into a single numpy pass per shape. A bad
        # literal isolates to its own submission (per-sub scalar bind on
        # group failure), never poisoning the rest of the group.
        by_template: dict[int, list] = {}
        for sub in batch:
            if id(sub) not in prefailed and sub.plan is None:
                by_template.setdefault(id(sub.template), []).append(sub)
        bound_groups = []
        for subs in by_template.values():
            template = subs[0].template
            try:
                plans = template.bind_batch([s.literals for s in subs])
            except Exception:
                plans = None
            if plans is None:          # isolate: per-sub scalar bind
                for s in subs:
                    try:
                        s.plan = template.bind(s.literals)
                    except Exception as exc:
                        prefailed[id(s)] = exc
            else:
                for s, p in zip(subs, plans):
                    s.plan = p
            for s in subs:
                if id(s) not in prefailed:
                    if s.plan.leaf_plans:
                        bound_groups.append(s)
                    with self._plan_lock:   # exact-text repeats skip the bind
                        self.plan_cache.put(s.norm, s.table, s.epoch, s.plan)
        if bound_groups:
            # GROUP BY leaf-cache lookups were deferred along with the bind.
            with self._state_lock:
                for s in bound_groups:
                    self._lookup_leaves(s)

        items, slots = [], []          # slots: (submission, leaf_idx | None)
        for sub in batch:
            if id(sub) in prefailed:
                continue
            # Items carry the plan's epoch so the scheduler re-validates it
            # per item at execution time (engines are fetched there; see
            # BatchScheduler.execute). A rebuild landing after the pre-check
            # above then surfaces as stale=True instead of silently pairing
            # this plan with the new synopsis.
            if sub.plan.leaf_plans:
                for i in sub.missing:
                    items.append((sub.table, sub.plan.leaf_plans[i],
                                  sub.epoch))
                    slots.append((sub, i))
            else:
                items.append((sub.table, sub.plan, sub.epoch))
                slots.append((sub, None))

        errors: dict[int, Exception] = {}
        t_exec0 = time.perf_counter()
        try:
            scheduled = self.scheduler.execute(items)
        except Exception:
            scheduled = [None] * len(items)
            for k, item in enumerate(items):
                try:
                    scheduled[k] = self.scheduler.execute([item])[0]
                except Exception as exc:       # isolate the poisoned item
                    errors[k] = exc
        t_exec1 = time.perf_counter()

        leaf_out: dict[int, dict] = {}         # id(sub) -> {leaf_idx: sr}
        failed = dict(prefailed)               # id(sub) -> first error
        exec_failed: set[int] = set()          # failed during EXECUTION:
        direct: dict[int, object] = {}         # retry/quarantine, not raise
        stale: set[int] = set()                # id(sub) -> re-enqueue
        for k, (sub, leaf_idx) in enumerate(slots):
            if k in errors:
                if id(sub) not in failed:
                    failed[id(sub)] = errors[k]
                    exec_failed.add(id(sub))
            elif scheduled[k] is not None and scheduled[k].stale:
                # A rebuild raced this item inside the wave: the scheduler
                # refused to pair the old plan with the new synopsis. The
                # whole submission re-enqueues (next wave's epoch pre-check
                # re-plans it); partial leaf results are discarded.
                stale.add(id(sub))
            elif leaf_idx is None:
                direct[id(sub)] = scheduled[k]
            else:
                leaf_out.setdefault(id(sub), {})[leaf_idx] = scheduled[k]
        for sub in batch:
            if id(sub) in stale and id(sub) not in failed:
                if sub.retries >= self.MAX_STALE_RETRIES:
                    failed[id(sub)] = RuntimeError(
                        f"table {sub.table!r}: epoch kept moving mid-wave "
                        f"after {sub.retries} re-plans; giving up")
                    stale.discard(id(sub))

        # Caching + metrics under the state lock — taken PER SUBMISSION, not
        # across the batch, so a submitter's short critical section can
        # interleave with a long wave's bookkeeping. Future resolution
        # happens outside the lock (done callbacks must never run under a
        # server lock). Popping the in-flight entry under the lock freezes
        # the futures list: any duplicate attached before the pop is
        # resolved here, any submit after it plans afresh. Pure group
        # assembly runs unlocked too.
        for sub in batch:
            tr = sub.trace
            if id(sub) in stale:
                # Keep the in-flight entry (dupes still attach) and send the
                # submission back through admission — bypassing backpressure
                # (we ARE the worker; see _enqueue) — so the next wave's
                # epoch pre-check re-plans it against the rebuilt synopsis.
                sub.retries += 1
                with self._state_lock:
                    self.metrics.admission.record_stale_requeue()
                if self.tracer.enabled:
                    self.tracer.instant(
                        "requeue", track="worker",
                        attrs={"table": sub.table, "retries": sub.retries})
                self._enqueue(sub, requeue=True)
                continue
            err = failed.get(id(sub))
            if err is not None and id(sub) in exec_failed:
                # Execution failures are a containment outcome, not a
                # raise: retry once (requeue), then quarantine with a
                # typed QueryError. Plan/bind errors above keep their
                # exception semantics.
                self._resolve_exec_failure(sub, err)
                continue
            result = None
            batched = False
            if err is None and sub.plan.leaf_plans:
                executed = leaf_out.get(id(sub), {})
                leaf_results = dict(sub.cached_leaves)
                leaf_results.update({i: sr.result
                                     for i, sr in executed.items()})
                result = assemble_groups(sub.plan, leaf_results)
                result.latency_s = sum(sr.latency_s
                                       for sr in executed.values())
                batched = any(sr.batched for sr in executed.values())
            with self._state_lock:
                # Conditional pop: deadline-carrying submissions never
                # register in the dedupe map, so an unconditional pop could
                # detach a different submission sharing the text.
                if self._inflight.get(sub.norm) is sub:
                    del self._inflight[sub.norm]
                futures = list(sub.futures)
                if err is None:
                    if sub.plan.leaf_plans and not executed \
                            and not sub.missing:
                        # Deferred-bind GROUP BY whose leaves were ALL in
                        # the cache: account as a result hit, exactly like
                        # the submit-time fully-cached fast path (a plan
                        # known at submit never reaches the wave in this
                        # state — it resolves there instead).
                        result = self._finish_cached_group(sub, result)
                    elif sub.plan.leaf_plans:
                        self._finish_group(sub, executed, result)
                    else:
                        sr = direct[id(sub)]
                        result = self._finish_single(sub, sr)
                        batched = sr.batched
                    for _ in futures[1:]:      # served dupes = result hits
                        self.metrics.table(sub.table).record_result_hit()
            if err is not None:
                if tr is not None:             # spans still tell the story
                    tr.t_exec0, tr.t_exec1 = t_exec0, t_exec1
                    tr.t_resolved = time.perf_counter()
                    tr.emit_spans(self.tracer, sub.norm)
                for fut in futures:
                    fut.set_exception(err)
            else:
                # Primary future gets the real latency (and, when traced,
                # its own explain-carrying copy — the cached result object
                # stays explain-free, a breakdown describes ONE submission);
                # in-flight duplicates are served copies.
                if tr is not None:
                    tr.t_exec0, tr.t_exec1 = t_exec0, t_exec1
                    tr.kernel_share_s = result.latency_s
                    tr.batched = batched
                    tr.retries = sub.retries
                    tr.t_resolved = time.perf_counter()
                    exp = self._trace_done(tr, sub.norm)
                    futures[0].set_result(
                        dataclasses.replace(result, explain=exp))
                else:
                    futures[0].set_result(result)
                for fut in futures[1:]:
                    fut.set_result(dataclasses.replace(result, latency_s=0.0))

    def _resolve_expired(self, subs: list):
        """Resolve deadline-expired submissions with typed
        ``DeadlineExceeded`` results (admission-worker thread, outside any
        server lock at resolution time)."""
        now = time.perf_counter()
        for sub in subs:
            with self._state_lock:
                if self._inflight.get(sub.norm) is sub:
                    del self._inflight[sub.norm]
                futures = list(sub.futures)
                self.metrics.faults.record_deadline_expired()
            deadline_ms = (sub.deadline_at - sub.t_submit) * 1e3
            elapsed_ms = (now - sub.t_submit) * 1e3
            if self.tracer.enabled:
                self.tracer.instant(
                    "deadline_expired", track="faults",
                    attrs={"deadline_ms": deadline_ms,
                           "elapsed_ms": elapsed_ms})
            if sub.trace is not None:
                sub.trace.t_resolved = now
                sub.trace.emit_spans(self.tracer, sub.norm)
            res = DeadlineExceeded(deadline_ms=deadline_ms,
                                   elapsed_ms=elapsed_ms)
            for fut in futures:
                if not fut.done():
                    fut.set_result(res)

    def _resolve_exec_failure(self, sub: _Submission, exc: Exception):
        """Contain one submission's wave-execution failure.

        First failure: re-enqueue for one more attempt (the retry rides
        the normal wave path, so a transient fault — an injected kernel
        error, a recovered cold table — answers correctly on the retry).
        At ``MAX_EXEC_FAILURES`` the statement quarantines: its futures
        resolve with a typed ``QueryError`` and re-submissions are refused
        until the quarantine clears. A ``TableQuarantinedError`` (the cold
        table's circuit breaker is open) skips the retry — it would only
        fail fast against the same open breaker — and quarantines the
        statement immediately. Never raises, never hangs a future.
        """
        sub.exec_failures += 1
        if isinstance(exc, TableQuarantinedError):
            sub.exec_failures = self.MAX_EXEC_FAILURES
        if sub.exec_failures < self.MAX_EXEC_FAILURES:
            with self._state_lock:
                self.metrics.faults.record_exec_retry()
            if self.tracer.enabled:
                self.tracer.instant(
                    "exec_retry", track="faults",
                    attrs={"table": sub.table, "error": repr(exc)})
            self._enqueue(sub, requeue=True)
            return
        with self._state_lock:
            if self._inflight.get(sub.norm) is sub:
                del self._inflight[sub.norm]
            futures = list(sub.futures)
            self._quarantine[sub.norm] = (sub.table, repr(exc))
            while len(self._quarantine) > self.QUARANTINE_CAP:
                self._quarantine.popitem(last=False)
            self.metrics.faults.record_quarantined()
            self.metrics.faults.record_query_error()
        if self.tracer.enabled:
            self.tracer.instant(
                "quarantine", track="faults",
                attrs={"table": sub.table, "error": repr(exc)})
        if sub.trace is not None:
            sub.trace.t_resolved = time.perf_counter()
            sub.trace.emit_spans(self.tracer, sub.norm)
        kind = ("quarantined" if isinstance(exc, TableQuarantinedError)
                else "execution")
        res = QueryError(error=repr(exc), kind=kind,
                         retries=sub.exec_failures)
        for fut in futures:
            if not fut.done():
                fut.set_result(res)

    def _on_wave_error(self, batch: list, exc: Exception):
        """Supervision callback: ``_execute_wave`` raised for a whole wave.

        Runs on the (surviving) admission worker. Every submission that is
        neither already resolved nor already re-admitted to the queue goes
        through the same retry-then-quarantine containment as an isolated
        execution failure, so a wave-level crash resolves every future
        with a typed result instead of stranding them.
        """
        for sub in batch:
            if sub.requeued:
                continue              # queue-owned again; next wave handles
            futures = list(sub.futures)
            if futures and all(f.done() for f in futures):
                continue              # already resolved (cache/expired path)
            self._resolve_exec_failure(sub, exc)

    # -------------------------------------------------------------- quarantine

    def quarantined(self) -> dict:
        """Snapshot of quarantined statements: normalized SQL ->
        ``{"table", "error"}``."""
        with self._state_lock:
            return {norm: {"table": t, "error": e}
                    for norm, (t, e) in self._quarantine.items()}

    def clear_quarantine(self, norm: str | None = None):
        """Lift the quarantine for one normalized statement (or all with
        ``None``) so re-submissions execute again."""
        with self._state_lock:
            if norm is None:
                self._quarantine.clear()
            else:
                self._quarantine.pop(normalize_sql(norm), None)

    def _finish_single(self, sub: _Submission, sr) -> QueryResult:
        """Cache + account one executed plain query (state lock held)."""
        self.result_cache.put(sub.norm, sub.table, sub.epoch, sr.result)
        self.metrics.table(sub.table).record(sr.latency_s, sr.batched)
        return sr.result

    def _finish_group(self, sub: _Submission, executed: dict,
                      result: QueryResult):
        """Cache executed leaves + the pre-assembled group result, account
        (state lock held; the assembly itself ran unlocked)."""
        batched = False
        for i, sr in executed.items():
            self.result_cache.put(_leaf_key(sub.plan.leaf_plans[i]),
                                  sub.table, sub.epoch, sr.result)
            batched = batched or sr.batched
        self.result_cache.put(sub.norm, sub.table, sub.epoch, result)
        tm = self.metrics.table(sub.table)
        tm.record(result.latency_s, batched)
        tm.record_group_expansion(len(executed), len(sub.cached_leaves))

    # ------------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Telemetry snapshot (tables + totals; see ``docs/serving.md``).
        Takes each lock separately (never nested): counters across the two
        caches may be mutually a submit apart, which telemetry tolerates."""
        with self._plan_lock:
            plan_stats = self.plan_cache.stats()
            tmpl_stats = self.template_cache.stats()
        with self._state_lock:
            snap = self.metrics.snapshot(None, self.result_cache)
        snap["totals"]["plan_cache"] = plan_stats
        snap["totals"]["template_cache"] = tmpl_stats
        adm = snap["totals"]["admission"]
        adm["queue_depth"] = self.admission.depth()
        # The admission object tracks depth after every admit; the metrics
        # side only sees shed-time observations — report the max of both.
        adm["queue_high_water"] = max(adm["queue_high_water"],
                                      self.admission.high_water)
        flt = snap["totals"]["faults"]
        flt["worker_restarts"] = self.admission.restarts
        with self._state_lock:
            flt["quarantine_size"] = len(self._quarantine)
        snap["tracing"] = {
            "enabled": self.tracer.enabled,
            "spans_recorded": self.tracer.n_recorded,
            "spans_dropped": self.tracer.n_dropped,
            "buffer_capacity": self.tracer.capacity,
            "slow_queries": len(self._slow_log),
            "slow_query_ms": self.slow_query_ms,
        }
        cold_tables = self.catalog.cold_tables()
        if cold_tables:
            gov = self.metrics.cold.snapshot()
            snap["cold"] = {
                "tables": len(cold_tables),
                # Live decoded-engine footprint; the high-water mark is
                # governor-recorded *post-enforcement* (the budget proof).
                "resident_bytes": sum(t.resident_bytes
                                      for _, t in cold_tables),
                "resident_high_water": gov["resident_high_water"],
                "demotes": gov["demotes"],
                "sweeps": gov["sweeps"],
                "max_engine_bytes": self.max_engine_bytes,
                "demote_idle_s": self.demote_idle_s,
            }
        return snap

    # ----------------------------------------------------------------- tracing

    def trace_events(self) -> list[dict]:
        """The span ring as Chrome/Perfetto ``trace_event`` dicts (one lane
        per query plus admission/worker lanes)."""
        return spans_to_events(self.tracer.spans())

    def trace_json(self) -> str:
        """The span ring serialized as trace_event JSON (paste into
        https://ui.perfetto.dev or chrome://tracing)."""
        return trace_json(self.trace_events())

    def export_trace(self, path) -> str:
        """Write the trace_event JSON artifact to ``path``; returns it."""
        return write_trace(path, self.trace_events())

    def slow_queries(self) -> list[dict]:
        """The bounded slow-query log, oldest first: explain breakdowns
        (plus ``sql``) of traced queries slower than ``slow_query_ms``."""
        return list(self._slow_log)
