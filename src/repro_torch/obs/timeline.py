"""Build-phase timeline: phases + per-launch compaction events.

Construction is single-threaded host orchestration around device launches,
so the recorder is an append-only list of dict events.
``build_pairwise_hist`` opens one ``phase(...)`` per pipeline stage (sample,
1-D refine, pair phase, union regrid, folds) and ``build_pairs_compact``
appends one ``compact_launch`` interval per capacity rung carrying its
round and escalation counters, plus ``rung_escalation`` markers; the
batched schedulers also time their host presort (``pair_presort``), its
upload (``pair_upload``) and the compacting one its metadata
(``pair_metadata``).

Events are plain dicts (JSON-ready, survive a trip through
``build_stats``): ``{"name", "t0", "t1", "kind": "phase"|"event", ...attrs}``
with perf_counter seconds.
"""
from __future__ import annotations

import time
from contextlib import contextmanager


class BuildTimeline:
    """Append-only event recorder for one synopsis construction."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: list[dict] = []
        self.t_start = time.perf_counter()

    @contextmanager
    def phase(self, name: str, **attrs):
        """Time a pipeline stage; the caller is responsible for fencing
        device work (``torch.cuda.synchronize()``) inside the block so the
        interval is honest wall-clock, not dispatch time."""
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            ev = {"name": name, "t0": t0, "t1": time.perf_counter(),
                  "kind": "phase"}
            ev.update(attrs)
            self.events.append(ev)

    def add(self, name: str, t0: float, t1: float, **attrs):
        """Record an interval from captured timestamps."""
        if not self.enabled:
            return
        ev = {"name": name, "t0": t0, "t1": t1, "kind": "phase"}
        ev.update(attrs)
        self.events.append(ev)

    def event(self, name: str, **attrs):
        """Record an instantaneous marker (e.g. a rung escalation)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        ev = {"name": name, "t0": now, "t1": now, "kind": "event"}
        ev.update(attrs)
        self.events.append(ev)

    def summary(self) -> dict:
        """Total seconds per phase name (events contribute zero)."""
        out: dict[str, float] = {}
        for ev in self.events:
            if ev["kind"] == "phase":
                out[ev["name"]] = out.get(ev["name"], 0.0) \
                    + (ev["t1"] - ev["t0"])
        return out
