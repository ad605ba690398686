"""Build timeline: the span tree of one synopsis construction, with
counters; and the same recorder over an ingest around it.

Construction is single-threaded host orchestration around device launches,
so the recorder is an append-only list of dict events, one per span in the
order the spans open. ``build_pairwise_hist`` opens one ``phase(...)`` per
pipeline stage (seed edges, sample, 1-D refine, pair phase, union regrid,
folds) and the stages open theirs inside: the sample's decode
(``decompress_rows``) and critical-value table (``crit_table``); the
compacting scheduler's upload of the sample's columns (``pair_upload``),
its device presort (``pair_presort``, split into ``presort_ranks``,
``presort_gather`` and ``presort_sort``), one ``compact_launch`` per
launch and its metadata (``pair_metadata``), with ``rung_escalation``
markers.

Events are plain dicts (JSON-ready, survive a trip through
``build_stats``): ``{"name", "t0", "t1", "kind": "phase"|"event",
"parent", ...attrs}`` with perf_counter seconds; ``parent`` is the index in
``events`` of the enclosing span, or None. A span that counted something
holds its own counts under ``"counts"``.

Counters (``BuildTimeline.count``; ``to_device`` and ``to_host``, which
count on the current timeline) go to the innermost open span. A timeline
is current, through a context variable, while any of its spans is open,
so code below the build counts without a timeline argument. The build
counts
``d2h_reads`` (blocking reads of a device value by the host),
``h2d_copies`` and ``h2d_bytes`` (host data made into device tensors).

While a ``torch.profiler`` records, every span is also a
``torch.profiler.record_function`` range of its name, so the spans nest in
the profiler's own event list and in any trace it exports.

``AQPFramework.ingest`` and ``rebuild`` record a timeline of their own
(``merge``, ``preprocess``, ``gd_compress``, ``build``); pre-processing and
GreedyGD open their children (``preprocess_categorical`` /
``preprocess_numeric`` a column; ``gd_missing``, ``gd_plan``,
``gd_encode``) and count (``preprocess_rows``, ``preprocess_str_rows``,
``gd_rows_encoded``, ``gd_plan_steps``, ``gd_bases``) through ``span`` and
``count``, which act on the current timeline and do nothing where none is
current; GreedyGD's transfers count there too (``h2d_copies``,
``h2d_bytes``, ``d2h_reads``). The build inside keeps its own timeline in
``build_stats``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar

import torch
import torch.profiler

_CURRENT: ContextVar["BuildTimeline | None"] = ContextVar(
    "repro_torch_build_timeline", default=None)


class BuildTimeline:
    """Append-only span and counter recorder for one synopsis construction."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: list[dict] = []
        self._open: list[int] = []

    @contextmanager
    def phase(self, name: str, wait=None, **attrs):
        """Time a block as a span inside the innermost open one; yields the
        span's dict, so attributes known only at the end can be set on it.

        A span over device work ends on a host read of that work
        (``to_host``), a blocking copy or, with ``wait`` (a device), a
        completion wait: the block's end waits for the device's current
        stream (a stream synchronize on CUDA, nothing on the CPU; no
        ``d2h_reads``). So its interval is wall-clock, not dispatch
        time."""
        if not self.enabled:
            yield {}
            return
        ev = {"name": name, "t0": 0.0, "t1": 0.0, "kind": "phase",
              "parent": self._open[-1] if self._open else None}
        ev.update(attrs)
        rf = (torch.profiler.record_function(name)
              if torch.autograd._profiler_enabled() else None)
        if rf is not None:
            rf.__enter__()
        token = _CURRENT.set(self)
        self._open.append(len(self.events))
        self.events.append(ev)
        ev["t0"] = time.perf_counter()
        try:
            yield ev
            if wait is not None and torch.device(wait).type == "cuda":
                torch.cuda.current_stream(wait).synchronize()
        finally:
            ev["t1"] = time.perf_counter()
            self._open.pop()
            _CURRENT.reset(token)
            if rf is not None:
                rf.__exit__(None, None, None)

    def event(self, name: str, **attrs):
        """Record an instantaneous marker (e.g. a rung escalation)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        ev = {"name": name, "t0": now, "t1": now, "kind": "event",
              "parent": self._open[-1] if self._open else None}
        ev.update(attrs)
        self.events.append(ev)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to counter ``name`` of the innermost open span (one
        must be open)."""
        if not self.enabled:
            return
        own = self.events[self._open[-1]].setdefault("counts", {})
        own[name] = own.get(name, 0) + n

    def summary(self) -> dict:
        """Total seconds per phase name (events contribute zero)."""
        out: dict[str, float] = {}
        for ev in self.events:
            if ev["kind"] == "phase":
                out[ev["name"]] = out.get(ev["name"], 0.0) \
                    + (ev["t1"] - ev["t0"])
        return out

    def counts(self) -> dict:
        """``{span name: {counter: total}}``: each counter summed over the
        spans of that name and their descendants."""
        inclusive = [dict(ev.get("counts", {})) for ev in self.events]
        for i in range(len(self.events) - 1, -1, -1):
            parent = self.events[i]["parent"]
            if parent is not None:
                _add(inclusive[parent], inclusive[i])
        out: dict[str, dict] = {}
        for ev, c in zip(self.events, inclusive):
            if c:
                _add(out.setdefault(ev["name"], {}), c)
        return out

    def totals(self) -> dict:
        """``{counter: total}`` over the whole build."""
        out: dict[str, int] = {}
        for ev in self.events:
            _add(out, ev.get("counts", {}))
        return out


def _add(into: dict, more: dict):
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


@contextmanager
def span(name: str, **attrs):
    """``BuildTimeline.phase(name, **attrs)`` of the current timeline, inside
    its innermost open span; nothing where no timeline is current."""
    tl = _CURRENT.get()
    if tl is None:
        yield {}
        return
    with tl.phase(name, **attrs) as ev:
        yield ev


def count(name: str, n: int = 1):
    """``BuildTimeline.count(name, n)`` of the current timeline, if any."""
    tl = _CURRENT.get()
    if tl is not None:
        tl.count(name, n)


def to_device(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)`` of host data (an
    array, a list or a number), counted as one ``h2d_copies`` of the
    tensor's ``nbytes``; an empty one copies nothing and is not counted.
    With no current timeline the count costs one lookup."""
    t = torch.as_tensor(data, dtype=dtype, device=device)
    tl = _CURRENT.get()
    if tl is not None and t.nbytes:
        tl.count("h2d_copies")
        tl.count("h2d_bytes", t.nbytes)
    return t


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as one ``d2h_reads``: the host waits for the
    device work that makes ``t``."""
    tl = _CURRENT.get()
    if tl is not None:
        tl.count("d2h_reads")
    return t.cpu()
