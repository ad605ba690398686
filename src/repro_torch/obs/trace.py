"""Span tracing: a monotonic-clock, lock-free ring-buffer collector.

Design constraints (serving hot path):

  * **near-zero cost when disabled** — ``Tracer.span`` on a disabled tracer
    returns one shared no-op context manager (no allocation, no clock
    read); call sites that would build attribute dicts guard on
    ``tracer.enabled`` first.
  * **lock-free when enabled** — committing a span claims a slot from an
    ``itertools.count`` (atomic under CPython) and writes one list item;
    there is no lock to contend on and a recording thread can never block
    a submitter. The buffer is a fixed-capacity ring: once full, the
    oldest spans are overwritten (``n_dropped`` counts them) — tracing is
    a window, not an unbounded log.
  * **monotonic clock** — all timestamps are ``time.perf_counter()``
    seconds; exporters rebase to the first event.

``QueryTrace`` is the per-query companion: one slotted object riding a
serving submission that stamps the stage-boundary timestamps
(submit/plan/admit/drain/execute/resolve) across threads and assembles the
EXPLAIN breakdown — the stages *tile* the submit->resolve interval, so the
breakdown accounts for the full client-observed wall clock.
"""
from __future__ import annotations

import itertools
import time


class Span:
    """One recorded interval (or instant, when ``t1 == t0``).

    ``track`` is a free-form lane name (``"q42"`` for a query's own lane,
    ``"worker"`` / ``"submit-<tid>"`` for thread lanes); the exporter maps
    each distinct track to a Perfetto thread row. ``attrs`` become the
    event's ``args``.
    """

    __slots__ = ("seq", "name", "cat", "t0", "t1", "track", "attrs")

    def __init__(self, name: str, cat: str, t0: float, t1: float,
                 track: str, attrs: dict | None):
        self.seq = -1
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.track = track
        self.attrs = attrs

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, cat={self.cat!r}, track={self.track!r},"
                f" dur={(self.t1 - self.t0) * 1e3:.3f}ms)")


class _NoopSpan:
    """Shared do-nothing context manager returned by disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    """Context manager that stamps perf_counter on enter/exit and commits."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_attrs", "_t0")

    def __init__(self, tracer, name, cat, track, attrs):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add(self._name, self._t0, time.perf_counter(),
                         cat=self._cat, track=self._track,
                         attrs=self._attrs)
        return False


class Tracer:
    """Lock-free ring-buffer span collector.

    Args:
        capacity: ring size in spans (oldest overwritten beyond it).
        enabled: when False every recording call is a no-op; flip
            ``enabled`` at runtime to start/stop collection.
        annotate: when True, instrumented kernel launches additionally
            open a ``torch.profiler.record_function`` range so spans line
            up with a captured PyTorch profiler trace (off by default — it
            is only useful under an active profiler session).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 annotate: bool = False):
        self.capacity = max(int(capacity), 1)
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self._buf: list = [None] * self.capacity
        self._seq = itertools.count()
        self._n = 0   # spans ever committed (monotonic; benign read races)

    # -------------------------------------------------------------- recording

    def span(self, name: str, cat: str = "serve", track: str = "main",
             attrs: dict | None = None):
        """Context manager timing a block; no-op when disabled."""
        if not self.enabled:
            return NOOP_SPAN
        return _LiveSpan(self, name, cat, track, attrs)

    def add(self, name: str, t0: float, t1: float, cat: str = "serve",
            track: str = "main", attrs: dict | None = None):
        """Record a span retroactively from already-captured timestamps
        (how cross-thread intervals like queue-wait are recorded)."""
        if not self.enabled:
            return
        span = Span(name, cat, t0, t1, track, attrs)
        i = next(self._seq)            # atomic slot claim (CPython)
        span.seq = i
        self._buf[i % self.capacity] = span
        self._n = i + 1

    def instant(self, name: str, cat: str = "serve", track: str = "main",
                attrs: dict | None = None):
        """Record a zero-duration event (shed / requeue / drain markers)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        self.add(name, now, now, cat=cat, track=track, attrs=attrs)

    # -------------------------------------------------------------- inspection

    @property
    def n_recorded(self) -> int:
        """Total spans ever committed (including overwritten ones)."""
        return self._n

    @property
    def n_dropped(self) -> int:
        """Spans overwritten by ring wraparound."""
        return max(0, self._n - self.capacity)

    def spans(self) -> list:
        """The retained window, oldest first (at most ``capacity`` spans)."""
        live = [s for s in self._buf if s is not None]
        live.sort(key=lambda s: s.seq)
        return live

    def clear(self):
        """Drop every retained span (counters reset too)."""
        self._buf = [None] * self.capacity
        self._seq = itertools.count()
        self._n = 0


# ---------------------------------------------------------------------------
# Per-query trace
# ---------------------------------------------------------------------------

_QID = itertools.count(1)

# Stage-boundary timestamp chain. Each stage's duration is the gap from the
# previous *present* boundary, so the stages tile t_submit -> t_resolved
# exactly — missing boundaries (e.g. a result-cache hit never queues)
# contribute zero width instead of holes.
_STAGES = (("plan", "t_planned"), ("admit", "t_admitted"),
           ("queue", "t_drained"), ("assemble", "t_exec0"),
           ("execute", "t_exec1"), ("resolve", "t_resolved"))


class QueryTrace:
    """Stage-boundary timestamps + flags for one submitted query.

    Stamped across threads (submit/plan on the submitter, drain/execute/
    resolve on the admission worker); each field is written once per
    attempt by exactly one thread, and the EXPLAIN breakdown is assembled
    only at resolution time, after every stamp has happened.
    """

    __slots__ = ("qid", "t_submit", "t_planned", "t_admitted", "t_drained",
                 "t_exec0", "t_exec1", "t_resolved", "plan_cache_hit",
                 "result_cache_hit", "plan_path", "drain_cause", "wave_size",
                 "kernel_share_s", "batched", "retries", "rejected")

    def __init__(self, t_submit: float | None = None):
        self.qid = next(_QID)
        self.t_submit = (time.perf_counter() if t_submit is None
                         else t_submit)
        self.t_planned = None
        self.t_admitted = None
        self.t_drained = None
        self.t_exec0 = None
        self.t_exec1 = None
        self.t_resolved = None
        self.plan_cache_hit = False
        self.result_cache_hit = False
        # Which planner path produced the plan: "full" (cold parse+plan),
        # "template" (zero-parse template bind), "plan_cache" (exact-text
        # plan-cache hit), or None (never planned, e.g. result-cache hit).
        self.plan_path = None
        self.drain_cause = None
        self.wave_size = 0
        self.kernel_share_s = 0.0
        self.batched = False
        self.retries = 0
        self.rejected = False

    @property
    def track(self) -> str:
        """This query's export lane (one Perfetto row per query)."""
        return f"q{self.qid}"

    def explain(self) -> dict:
        """The EXPLAIN breakdown: per-stage milliseconds + flags.

        ``plan/admit/queue/assemble/execute/resolve`` tile the full
        submit -> resolve interval (``total_ms``); ``kernel_share_ms`` is
        this query's amortized share of its fused wave/kernel launch time
        (informational — already contained inside ``execute_ms``).
        """
        out = {"qid": self.qid}
        prev = self.t_submit
        total = 0.0
        for stage, field in _STAGES:
            t = getattr(self, field)
            if t is None or t < prev:
                t = prev
            out[f"{stage}_ms"] = (t - prev) * 1e3
            total += t - prev
            prev = t
        out["total_ms"] = total * 1e3
        out["kernel_share_ms"] = self.kernel_share_s * 1e3
        out["plan_cache_hit"] = self.plan_cache_hit
        out["result_cache_hit"] = self.result_cache_hit
        out["plan_path"] = self.plan_path
        out["batched"] = self.batched
        out["wave_size"] = self.wave_size
        out["drain_cause"] = self.drain_cause
        out["stale_retries"] = self.retries
        out["rejected"] = self.rejected
        return out

    def emit_spans(self, tracer: Tracer, label: str = ""):
        """Write this query's stage spans onto its own export lane."""
        if not tracer.enabled:
            return
        track = self.track
        attrs = {"qid": self.qid}
        if label:
            attrs["sql"] = label
        if self.plan_path is not None:
            attrs["plan_path"] = self.plan_path
        prev = self.t_submit
        for stage, field in _STAGES:
            t = getattr(self, field)
            if t is None or t < prev:
                continue
            if t > prev:
                tracer.add(stage, prev, t, cat="query", track=track,
                           attrs=attrs if stage == "plan" else None)
            prev = t
