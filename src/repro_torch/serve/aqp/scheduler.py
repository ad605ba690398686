"""Batch scheduler + streaming admission for the AQP serving layer.

At sub-ms per-query latency the serving bottleneck is dispatch, not math
(the same observation that motivates ``core/fastpath``'s per-predicate
fusion, one level up). ``BatchScheduler`` takes a set of in-flight planned
queries and groups them by **plan shape** ``(table, exec column,
pair-predicate column set)``; each group shares its padded (H, fold, hx)
stacks and executes as ONE query-batched kernel launch covering every query
and all three bound variants (``FastPath.batch`` -> the
``batched_weightings`` CUDA kernel). Per-query work shrinks to beta
assembly + the final scalar aggregation.

``StreamingAdmission`` feeds it continuously: submissions enqueue without
blocking and a worker thread drains the queue into waves under a
``max_wait_ms`` / ``max_batch`` policy, so the batched launches fill up
from *traffic*, not from whoever happened to call ``query_batch`` with a
big list. GROUP BY queries arrive from the server already expanded into
per-category leaf plans (``QueryPlan.leaf_plans``) — every leaf of every
in-flight GROUP BY shares one plan shape and rides the same fused launch.

Queries outside the batchable shape (OR trees, no WHERE) fall back to the
per-table engine's own path — which is also the oracle the batched path is
tested against.

Execution modes:
  * ``"cuda"``  — the hand-written batched weightings kernel on the CUDA
                  device (``FastPath(device=<the card>)``)
  * ``"ref"``   — the kernel's plain PyTorch version on the CPU (f32,
                  ``FastPath(device="cpu")``)
  * ``"numpy"`` — no fused launch; per-query reference execution,
                  bit-identical to ``QueryEngine.query`` (grouping,
                  dedup and caching still apply)
  * ``None``    — ``"cuda"``; raises without a CUDA device. There is no
                  automatic fall back to ``"numpy"``: a server that asked
                  for the card and silently ran on the host would hide it.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time

from repro_torch.core.fastpath import FastPath
from repro_torch.core.query import QueryPlan, QueryResult
from repro_torch.device import resolve_device

import repro_torch.serve.aqp.faults as faults


@dataclasses.dataclass
class ScheduledResult:
    """Outcome of one scheduled (planned) query.

    Attributes:
        result: the ``QueryResult`` (estimate/bounds or groups dict);
            None when ``stale``.
        batched: True iff this query executed inside a fused batched launch.
        latency_s: per-query wall share (group wall time / group size).
        stale: the item's table epoch moved between planning and execution
            (a rebuild landed mid-wave), so the plan was NOT executed — its
            literal encodings belong to a synopsis that no longer exists.
            The caller must re-plan and retry (``AQPServer`` re-enqueues).
    """

    result: QueryResult | None
    batched: bool           # executed via the fused batched launch
    latency_s: float        # per-query wall share (group wall / group size)
    stale: bool = False     # epoch moved mid-wave: not executed, re-plan


@dataclasses.dataclass
class DrainStats:
    """One admission-loop drain: why it fired and what it took.

    Attributes:
        cause: ``"full"`` (queue reached ``max_batch``), ``"flush"``
            (explicit flush / synchronous wrapper), ``"timeout"``
            (``max_wait_ms`` elapsed with a partial group), or
            ``"deadline"`` (a queued item's per-query deadline is at risk,
            so the wave stops filling and fires early).
        size: number of submissions drained into this wave.
        depth: queue depth observed at drain time (``size`` plus whatever
            stayed behind because of ``max_batch``).
        waited_s: age of the oldest drained submission (enqueue -> drain).
    """

    cause: str
    size: int
    depth: int
    waited_s: float


SHED_POLICIES = ("reject", "shed_oldest", "block")


class PlannerPool:
    """Optional planner offload: cold planning runs off the submit thread.

    A thin, swappable wrapper over a thread pool. On today's GIL-bound
    CPython a thread pool mostly buys submit-path *latency* (the submitter
    returns a pending future instead of planning inline); the interface —
    ``submit(fn, *args) -> future``, ``close()`` — is deliberately the
    executor protocol so a free-threaded or subprocess executor can drop
    in without touching the server (``AQPServer(planner_workers=N)``).
    """

    def __init__(self, workers: int):
        if workers <= 0:
            raise ValueError("PlannerPool needs workers >= 1")
        self.workers = int(workers)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="aqp-planner")

    def submit(self, fn, *args) -> concurrent.futures.Future:
        """Schedule ``fn(*args)`` on a planner worker; returns its future."""
        return self._pool.submit(fn, *args)

    def close(self):
        """Stop accepting work and join the workers (pending plans finish)."""
        self._pool.shutdown(wait=True)


class StreamingAdmission:
    """Continuous admission: a bounded queue drained into waves by a worker.

    ``submit`` enqueues and returns immediately — the online-aggregation
    serving model, replacing the synchronous wave-per-call scheduler. A
    single daemon worker drains the queue into execution waves under a
    latency/batch-size policy:

      * a wave fires as soon as ``max_batch`` submissions are queued, or
      * when the oldest queued submission has waited ``max_wait_ms``, or
      * immediately on ``flush()`` (used by the synchronous ``query_batch``
        wrapper so a blocking caller never pays the admission wait).

    **Backpressure** (overload safety): the queue is bounded by
    ``max_queue_depth`` (``<= 0`` = unbounded). When a submit finds the
    queue full, ``shed_policy`` decides:

      * ``"reject"`` — the *new* item is turned away (``submit`` returns
        False after invoking ``shed_cb(item, "reject", depth)``);
      * ``"shed_oldest"`` — the *oldest* queued item is evicted
        (``shed_cb(old, "shed_oldest", depth)``) and the new one admitted;
      * ``"block"`` — ``submit`` blocks until the worker drains space (the
        producer is paced to the consumer; raises if closed while waiting).

    ``shed_cb`` runs on the submitting thread with no admission lock held,
    so it may take the server's locks and resolve futures. An item is
    handed to exactly one of ``execute_cb`` (as part of one wave) or
    ``shed_cb`` — never both, never twice — which is the exactly-once
    foundation the serving layer's future-resolution contract builds on.
    ``high_water`` records the maximum depth ever observed right after an
    admit (the enforced bound is therefore visible, not just configured).

    The worker executes each wave via ``execute_cb(batch, stats)`` (supplied
    by ``AQPServer``) and keeps draining, so completed waves resolve their
    futures without blocking later arrivals. ``flush()`` on an empty queue
    is a no-op (the flag is cleared while idle, never banked).

    The worker thread starts lazily on first submit and is a daemon;
    ``close()`` stops and joins it (pending submissions are drained first so
    no future is abandoned).
    """

    def __init__(self, execute_cb, max_wait_ms: float = 2.0,
                 max_batch: int = 64, max_queue_depth: int = 0,
                 shed_policy: str = "reject", shed_cb=None, tracer=None,
                 idle_cb=None, error_cb=None):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {shed_policy!r}; "
                             f"expected one of {SHED_POLICIES}")
        self.execute_cb = execute_cb
        # Supervision hook: when execute_cb raises, the worker survives and
        # hands the wave to error_cb(batch, exc) so the server can resolve
        # every future with a typed result (never a hang, never a dead
        # loop). error_cb itself is guarded — a raising error handler
        # cannot kill the worker either.
        self.error_cb = error_cb
        # Optional between-waves hook on the worker thread (the server wires
        # the cold-tier memory governor here): runs after each wave's
        # execute_cb returns, never concurrently with one, and exceptions
        # are swallowed so housekeeping can't kill the drain loop.
        self.idle_cb = idle_cb
        # Optional repro_torch.obs.trace.Tracer: each drain emits an instant
        # on the "admission" lane (cause/size/depth/oldest-wait).
        self.tracer = tracer
        self.max_wait_ms = float(max_wait_ms)
        self.max_batch = int(max_batch)
        self.max_queue_depth = int(max_queue_depth)
        self.shed_policy = shed_policy
        self.shed_cb = shed_cb or (lambda item, reason, depth: None)
        self.high_water = 0
        # Watchdog: number of times a dead worker thread was replaced (a
        # BaseException escaped the wave guard, e.g. an injected worker
        # crash). Un-executed wave items are restored to the queue front
        # before the restart, preserving the exactly-once contract.
        self.restarts = 0
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._flush = False
        self._stop = False
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- public

    def submit(self, item, t_submit: float | None = None) -> bool:
        """Enqueue ``item`` and wake the admission worker.

        Returns True if the item was admitted, False if the bounded queue
        rejected it (``shed_policy="reject"``; ``shed_cb`` has then already
        been invoked with the item). Under ``"shed_oldest"`` the call always
        admits but may evict the queue's oldest item; under ``"block"`` it
        waits for space (non-blocking otherwise).
        """
        t = time.perf_counter() if t_submit is None else t_submit
        shed = None
        with self._cv:
            if self._stop:
                raise RuntimeError("admission queue is closed")
            self._ensure_worker()
            bound = self.max_queue_depth
            if bound > 0 and len(self._q) >= bound:
                if self.shed_policy == "block":
                    while len(self._q) >= bound and not self._stop:
                        self._cv.wait()
                    if self._stop:
                        raise RuntimeError("admission queue is closed")
                elif self.shed_policy == "reject":
                    shed, reason = item, "reject"
                else:                         # shed_oldest: evict to admit
                    shed, reason = self._q.popleft()[1], "shed_oldest"
                depth = len(self._q)
            if shed is not item:
                self._q.append((t, item))
                self.high_water = max(self.high_water, len(self._q))
                self._cv.notify_all()
        if shed is not None:
            self.shed_cb(shed, reason, depth)
        return shed is not item

    def requeue(self, item, t_submit: float):
        """Re-admit an item that was already admitted once (wave retry).

        Skips the backpressure bound entirely: the caller is the admission
        worker itself (re-enqueueing a wave item whose table epoch moved),
        so ``"block"`` would deadlock on the condition the worker alone
        drains, and ``"reject"``/``"shed_oldest"`` would shed an already-
        admitted query. The queue may briefly exceed ``max_queue_depth`` by
        the handful of retried items; they re-enter at the FRONT (oldest
        first — they keep their original submit time, so the wave deadline
        policy treats them as the longest-waiting work).
        """
        with self._cv:
            if self._stop:
                raise RuntimeError("admission queue is closed")
            self._ensure_worker()
            self._q.appendleft((t_submit, item))
            self.high_water = max(self.high_water, len(self._q))
            self._cv.notify_all()

    def flush(self):
        """Drain the current queue immediately (no-op when empty)."""
        with self._cv:
            if self._q:
                self._ensure_worker()
                self._flush = True
                self._cv.notify_all()

    def depth(self) -> int:
        """Current queue depth (submitted, not yet drained into a wave)."""
        with self._cv:
            return len(self._q)

    def close(self):
        """Stop the worker after draining anything still queued."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None

    # ----------------------------------------------------------------- worker

    def _ensure_worker(self):
        """Start the worker lazily; restart it if it died (watchdog).

        Caller holds ``self._cv``. A replacement after a hard death (a
        ``BaseException`` that escaped the wave guard) counts in
        ``restarts``; ``_loop`` restores un-executed items to the queue
        front before dying, so nothing is lost across the restart.
        """
        if self._thread is not None and not self._thread.is_alive():
            self._thread = None
            self.restarts += 1
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="aqp-admission", daemon=True)
            self._thread.start()

    def _queue_deadline(self):
        """Earliest per-item ``deadline_at`` among queued items, or None."""
        qdl = None
        for _, item in self._q:
            dl = getattr(item, "deadline_at", None)
            if dl is not None and (qdl is None or dl < qdl):
                qdl = dl
        return qdl

    def _collect(self):
        """Block until a wave is due; returns (pairs, DrainStats) or None.

        ``pairs`` keeps the ``(t_submit, item)`` tuples so a crashing
        worker can restore un-executed items to the queue front with their
        original submit times intact.
        """
        with self._cv:
            while not self._q:
                self._flush = False         # flush on empty queue: no-op
                if self._stop:
                    return None
                self._cv.wait()
            # Admission policy: the wave fires on whichever of max_batch /
            # flush / oldest-waited-max_wait_ms trips first — or early,
            # with cause "deadline", when a queued item's per-query
            # deadline would expire before the normal wave fire time (the
            # drain stops adding to a wave whose oldest deadline is at
            # risk).
            margin = self.max_wait_ms / 1e3
            deadline = self._q[0][0] + margin
            cause = "timeout"
            while True:
                if len(self._q) >= self.max_batch:
                    cause = "full"
                    break
                if self._flush or self._stop:
                    cause = "flush"
                    break
                wake = deadline
                at_risk = False
                qdl = self._queue_deadline()
                if qdl is not None and qdl - margin < wake:
                    wake = qdl - margin
                    at_risk = True
                remaining = wake - time.perf_counter()
                if remaining <= 0:
                    if at_risk:
                        cause = "deadline"
                    break
                self._cv.wait(remaining)
            self._flush = False
            depth = len(self._q)
            take = min(depth, self.max_batch)
            now = time.perf_counter()
            waited = now - self._q[0][0]
            pairs = [self._q.popleft() for _ in range(take)]
            self._cv.notify_all()   # wake producers blocked on a full queue
        stats = DrainStats(cause, take, depth, waited)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                "drain", track="admission",
                attrs={"cause": cause, "size": take, "depth": depth,
                       "oldest_wait_ms": waited * 1e3})
        return pairs, stats

    def _loop(self):
        while True:
            wave = self._collect()
            if wave is None:
                return
            pairs, stats = wave
            try:
                faults.hook("worker")
            except Exception:
                # Simulated worker death before the wave ran: nothing was
                # executed, so the whole wave re-enters the queue and the
                # replacement worker drains it. Exit quietly — the crash is
                # already accounted for in ``restarts``.
                self._revive(pairs)
                return
            except BaseException:
                self._revive(pairs)
                raise
            batch = [item for _, item in pairs]
            try:
                self.execute_cb(batch, stats)
            except Exception as exc:
                # Supervision: a raising wave must not kill the drain loop
                # or strand its futures. The server's error_cb resolves
                # them with typed QueryError results (or retries).
                if self.error_cb is not None:
                    try:
                        self.error_cb(batch, exc)
                    except Exception:
                        pass
            except BaseException:
                # Hard death (interpreter shutdown, injected worker crash
                # mid-wave): the wave may be partially executed, so it is
                # NOT restored — already-resolved futures stay resolved,
                # and the watchdog replaces the worker for queued items.
                self._revive(())
                raise
            if self.idle_cb is not None:
                try:
                    self.idle_cb()
                except Exception:
                    pass

    def _revive(self, pairs):
        """Restore un-executed wave items and spawn a replacement worker.

        Called on the dying worker thread itself. ``pairs`` (possibly
        empty) re-enter at the queue FRONT in their original order with
        original submit times — they were handed to neither ``execute_cb``
        nor ``shed_cb``, so exactly-once is preserved across the restart.
        """
        with self._cv:
            self._q.extendleft(reversed(pairs))
            self.high_water = max(self.high_water, len(self._q))
            if not self._stop:
                self.restarts += 1
                self._thread = threading.Thread(
                    target=self._loop, name="aqp-admission", daemon=True)
                self._thread.start()
            self._cv.notify_all()


class BatchScheduler:
    """Groups planned queries by plan shape and fuses kernel launches.

    Args:
        catalog: ``TableCatalog`` resolving table names to engines.
        mode: ``"cuda"`` / ``"ref"`` / ``"numpy"`` / ``None`` (``"cuda"``)
            — see the module docstring for the semantics of each.
        max_group: hard cap on queries per fused launch (group splits).
        min_group: groups smaller than this skip the fused launch (a batch
            of one gains nothing from the kernel but still pays dispatch).
        tracer: optional ``repro_torch.obs.trace.Tracer``. When enabled,
            every fused launch records a ``kernel`` span on the "worker"
            lane — wall time, since ``FastPath.batch`` returns host arrays
            — and (``tracer.annotate``) opens a matching
            ``torch.profiler.record_function`` range so the span lines up
            inside a captured PyTorch profiler trace.
        device: the CUDA device of the ``"cuda"`` mode (``None``: the
            current one); the other modes ignore it.
    """

    def __init__(self, catalog, mode: str | None = None,
                 max_group: int = 256, min_group: int = 2, tracer=None,
                 device=None):
        if mode is None:
            mode = "cuda"
        if mode not in ("cuda", "ref", "numpy"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        if mode == "cuda":
            device = resolve_device(device)
            if device.type != "cuda":
                raise ValueError(
                    f"scheduler mode 'cuda' needs a CUDA device, not "
                    f"{device}; mode='ref' runs the kernel's plain version "
                    f"on the CPU")
        self.catalog = catalog
        self.mode = mode
        self.max_group = int(max_group)
        # Groups below min_group skip the fused launch: a batch of one gains
        # nothing from the kernel but still pays its dispatch.
        self.min_group = int(min_group)
        self.tracer = tracer
        self.fastpath = (None if mode == "numpy" else FastPath(
            device=device if mode == "cuda" else "cpu"))

    # ----------------------------------------------------------------- public

    def execute(self, items: list[tuple]) -> list[ScheduledResult]:
        """Execute a wave of planned queries; returns results aligned with
        ``items``. Grouping is transparent: results are identical (numpy
        mode) / fp-close (kernel modes) to per-query execution.

        Items are ``(table, plan)`` or ``(table, plan, epoch)``. With an
        epoch, the item's table epoch is **re-validated here, per item**,
        against an atomic ``catalog.snapshot`` — engines are fetched at
        execution time, so a rebuild landing after the server's wave-start
        epoch check would otherwise pair this old plan with the new
        synopsis (silently wrong literal encodings). The framework
        publishes ``(engine, epoch)`` in one assignment, so a snapshot
        whose epoch matches the plan's guarantees the engine is exactly
        the synopsis the plan was encoded against (no tearing); executing
        that engine stays correct even if a rebuild lands mid-execution —
        the result is consistent at the plan's epoch and is cached under
        it. A mismatched snapshot returns ``stale=True`` for that item
        (nothing executes) and the caller re-plans."""
        out: list[ScheduledResult | None] = [None] * len(items)
        groups: dict[tuple, list[int]] = {}
        for idx, item in enumerate(items):
            table, plan = item[0], item[1]
            shape = plan.shape_key() if self.fastpath is not None else None
            if shape is None:
                self._run_single(items, idx, out)
            else:
                groups.setdefault((table,) + shape, []).append(idx)

        for (table, exec_col, _cols), idxs in groups.items():
            if len(idxs) < self.min_group:
                for idx in idxs:
                    self._run_single(items, idx, out)
                continue
            for lo in range(0, len(idxs), self.max_group):
                self._run_group(items, table, exec_col,
                                idxs[lo:lo + self.max_group], out)
        return out  # type: ignore[return-value]

    # ---------------------------------------------------------------- helpers

    @staticmethod
    def _item_epoch(item):
        """The epoch an item's plan was made at, or None (no validation)."""
        return item[2] if len(item) > 2 else None

    def _stale_result(self) -> ScheduledResult:
        """A per-item 'epoch moved mid-wave' outcome (plan not executed)."""
        return ScheduledResult(None, False, 0.0, stale=True)

    def _tracing(self) -> bool:
        return self.tracer is not None and self.tracer.enabled

    def _run_single(self, items, idx, out, span: bool = True):
        item = items[idx]
        table, plan, epoch = item[0], item[1], self._item_epoch(item)
        engine, cur = self.catalog.snapshot(table)
        if epoch is not None and cur != epoch:
            out[idx] = self._stale_result()
            return
        t0 = time.perf_counter()
        res = engine.execute_plan(plan)
        t1 = time.perf_counter()
        if span and self._tracing():
            self.tracer.add("single_exec", t0, t1, track="worker",
                            attrs={"table": table})
        out[idx] = ScheduledResult(res, False, t1 - t0)

    def _run_group(self, items, table, exec_col, idxs, out):
        engine, cur = self.catalog.snapshot(table)
        live = []
        for idx in idxs:
            epoch = self._item_epoch(items[idx])
            if epoch is not None and cur != epoch:
                out[idx] = self._stale_result()
            else:
                live.append(idx)
        if not live:
            return
        ph = engine.ph
        tracing = self._tracing()
        t0 = time.perf_counter()
        triples = None
        if len(live) > 0 and self.fastpath is not None:
            faults.hook("kernel_launch")
            trees = [items[idx][1].tree for idx in live]
            if tracing and self.tracer.annotate:
                import torch.profiler
                with torch.profiler.record_function(
                        f"aqp.fused:{table}.{exec_col}"):
                    triples = self.fastpath.batch(ph, exec_col, trees,
                                                  engine.corrected)
            else:
                triples = self.fastpath.batch(ph, exec_col, trees,
                                              engine.corrected)
            if tracing and triples is not None:
                # No fence needed: FastPath.batch copies the launch's output
                # to host NumPy (``.cpu()``), which waits for the device, so
                # the kernel span is already wall time.
                self.tracer.add("kernel", t0, time.perf_counter(),
                                track="worker",
                                attrs={"table": table, "col": exec_col,
                                       "queries": len(live)})
        if triples is None:       # ineligible after all: per-query fallback
            # One group_exec span for the whole loop, not one per item:
            # GROUP BY leaves land here ~10 at a time and per-leaf spans
            # were the single largest traced-path cost (ring churn included)
            # for zero extra information — the leaves are interchangeable.
            for idx in live:
                self._run_single(items, idx, out, span=False)
            if tracing:
                self.tracer.add("group_exec", t0, time.perf_counter(),
                                track="worker",
                                attrs={"table": table, "col": exec_col,
                                       "queries": len(live)})
            return
        for triple, idx in zip(triples, live):
            res = engine.execute_plan(items[idx][1], weightings=triple)
            out[idx] = ScheduledResult(res, True, 0.0)
        t1 = time.perf_counter()
        if tracing:
            self.tracer.add("wave_group", t0, t1, track="worker",
                            attrs={"table": table, "col": exec_col,
                                   "queries": len(live)})
        share = (t1 - t0) / len(live)
        for idx in live:
            out[idx].latency_s = share
            out[idx].result.latency_s = share
