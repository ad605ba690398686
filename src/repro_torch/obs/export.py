"""Chrome/Perfetto ``trace_event`` JSON export + schema validation.

Emits the JSON-array flavor of the Trace Event Format: ``"X"`` (complete)
events with microsecond ``ts``/``dur``, ``"i"`` instants, and ``"M"``
metadata events naming the tracks. Everything lands under a single
``pid``; each distinct span track (a query lane, the admission worker, a
submitter thread, a build phase lane) gets its own ``tid`` so Perfetto
renders one row per track. Load artifacts at https://ui.perfetto.dev or
chrome://tracing.
"""
from __future__ import annotations

import json
import os

_PID = 1


def _track_tids(names):
    """Stable track-name -> tid mapping plus the naming metadata events.

    Tracks are numbered in first-appearance order; query lanes (``q<n>``)
    sort after service lanes so the per-query swimlanes group together at
    the bottom of the view.
    """
    service = [n for n in names if not (n.startswith("q") and n[1:].isdigit())]
    queries = [n for n in names if n.startswith("q") and n[1:].isdigit()]
    queries.sort(key=lambda n: int(n[1:]))
    tids = {}
    meta = []
    for i, name in enumerate(service + queries):
        tids[name] = i
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                     "tid": i, "args": {"name": name}})
    return tids, meta


def spans_to_events(spans, t0: float | None = None) -> list[dict]:
    """Convert ``Tracer`` spans to trace_event dicts (ts rebased to t0)."""
    spans = list(spans)
    if not spans:
        return []
    if t0 is None:
        t0 = min(s.t0 for s in spans)
    seen = []
    for s in spans:
        if s.track not in seen:
            seen.append(s.track)
    tids, events = _track_tids(seen)
    for s in spans:
        ev = {"name": s.name, "cat": s.cat, "pid": _PID,
              "tid": tids[s.track], "ts": (s.t0 - t0) * 1e6}
        if s.t1 > s.t0:
            ev["ph"] = "X"
            ev["dur"] = (s.t1 - s.t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"           # thread-scoped instant
        if s.attrs:
            ev["args"] = dict(s.attrs)
        events.append(ev)
    return events


def timeline_to_events(timeline, t0: float | None = None) -> list[dict]:
    """Convert a ``BuildTimeline`` (or its raw ``events`` list) to
    trace_event dicts. Phases go on a ``build`` track, instantaneous
    markers and per-launch events on a ``compact`` track."""
    raw = timeline if isinstance(timeline, list) else timeline.events
    if not raw:
        return []
    if t0 is None:
        t0 = min(ev["t0"] for ev in raw)
    tids, events = _track_tids(["build", "compact"])
    for ev in raw:
        track = "build" if ev["kind"] == "phase" else "compact"
        args = {k: v for k, v in ev.items()
                if k not in ("name", "t0", "t1", "kind")}
        out = {"name": ev["name"], "cat": "build", "pid": _PID,
               "tid": tids[track], "ts": (ev["t0"] - t0) * 1e6}
        if ev["t1"] > ev["t0"]:
            out["ph"] = "X"
            out["dur"] = (ev["t1"] - ev["t0"]) * 1e6
        else:
            out["ph"] = "i"
            out["s"] = "t"
        if args:
            out["args"] = args
        events.append(out)
    return events


def trace_json(events: list[dict]) -> str:
    """Serialize events as the JSON-array trace format Perfetto accepts."""
    return json.dumps(events, separators=(",", ":"), default=str)


def write_trace(path, events: list[dict]) -> str:
    """Write events to ``path`` (parent dirs created); returns the path."""
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(trace_json(events))
    return str(path)


def validate_trace_events(events) -> list[str]:
    """Schema-check a parsed event list; returns problems ([] = valid).

    Checks the invariants Perfetto's importer actually relies on: a JSON
    array of objects, required keys per phase type, numeric non-negative
    ``ts``/``dur``, and ``M`` metadata naming each referenced tid.
    """
    problems = []
    if not isinstance(events, list):
        return ["top level is not a JSON array"]
    named_tids = set()
    used_tids = set()
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if "name" not in ev or not isinstance(ev["name"], str):
            problems.append(f"{where}: missing/invalid name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            problems.append(f"{where}: pid/tid must be ints")
            continue
        if ph == "M":
            named_tids.add(ev["tid"])
            continue
        used_tids.add(ev["tid"])
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs non-negative dur")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be an object")
    for tid in sorted(used_tids - named_tids):
        problems.append(f"tid {tid} has events but no thread_name metadata")
    return problems
