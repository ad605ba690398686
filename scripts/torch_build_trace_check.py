"""What the build's span tree and counters cost and how they line up with a
device trace, on one benchmark cell's table.

    PYTHONPATH=src python3 scripts/torch_build_trace_check.py \
        --workload flights.build --seed 7 --builds 6 --rounds 3

Sets up as the cell's rebuild loop does (its table from the seed, GreedyGD,
one warm build), then:

1. ``rounds`` times, ``builds`` untraced builds and ``builds`` builds under
   the benchmark's own device trace (``aqpbench.trace.DeviceTrace``: CUDA
   activity only): each build's seconds, traced against untraced;
2. in those traced builds, the device's host-to-device and device-to-host
   copies that start inside a build's root spans, against the build's
   ``h2d_copies`` and ``d2h_reads``;
3. ``builds`` builds under a profiler of CPU and CUDA activity: each
   span's start mapped onto the profiler's clock by the device trace's
   rule (one reading of both clocks at the close) against the start of its
   ``record_function`` annotation (the annotations taken in start order,
   which must name the spans in theirs).

Prints one JSON summary, and writes it to ``--out`` if given. Needs a
CUDA device unless ``--device cpu`` (then the copies are not counted).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _quartiles(xs):
    if len(xs) < 2:
        return xs[0], xs[0], xs[0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, q2, q3


def _roots(stats):
    return [ev for ev in stats["timeline"] if ev["parent"] is None]


def _mean_spans(all_stats):
    out: dict[str, float] = {}
    for st in all_stats:
        for k, v in st["phase_s"].items():
            out[k] = out.get(k, 0.0) + v / len(all_stats)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _mean_counts(all_stats):
    out: dict[str, dict] = {}
    for st in all_stats:
        for name, c in list(st["counts"].items()) + [
                ("build", st["count_totals"])]:
            acc = out.setdefault(name, {})
            for k, v in c.items():
                acc[k] = acc.get(k, 0.0) + v / len(all_stats)
    return out


def _copies(events, all_stats):
    """Device copies that start inside each build's root spans."""
    got = {"h2d": 0, "d2h": 0}
    want = {"h2d": 0, "d2h": 0}
    for st in all_stats:
        spans = [(ev["t0"], ev["t1"]) for ev in _roots(st)]
        for name, t0, _t1 in events:
            if not any(a <= t0 <= b for a, b in spans):
                continue
            if name.startswith("Memcpy HtoD"):
                got["h2d"] += 1
            elif name.startswith("Memcpy DtoH"):
                got["d2h"] += 1
        want["h2d"] += st["count_totals"].get("h2d_copies", 0)
        want["d2h"] += st["count_totals"].get("d2h_reads", 0)
    return {"device_trace": got, "counters": want}


def _annotation_gaps(prof, wall_ns, perf, all_stats):
    """Span starts mapped by the one-point rule against their
    annotations' starts, once the annotations name the spans in order."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    notes = sorted(((e.name(), e.start_ns()) for e in
                    prof.profiler.kineto_results.events()
                    if e.device_type() == cpu and e.is_user_annotation()),
                   key=lambda ne: ne[1])
    spans = sorted((ev for st in all_stats for ev in st["timeline"]
                    if ev["kind"] == "phase"), key=lambda ev: ev["t0"])
    names = {ev["name"] for ev in spans}
    notes = [ne for ne in notes if ne[0] in names]
    matched = len(notes) == len(spans) and all(
        n == ev["name"] for (n, _), ev in zip(notes, spans))
    gaps = [ev["t0"] - (perf + (s_ns - wall_ns) * 1e-9)
            for (_, s_ns), ev in zip(notes, spans)] if matched else []
    return {"spans": len(spans), "annotations": len(notes),
            "names_match": matched,
            "gap_max_abs_s": max((abs(g) for g in gaps), default=None),
            "gap_median_s": statistics.median(gaps) if gaps else None,
            "gap_min_s": min(gaps, default=None),
            "gap_max_s": max(gaps, default=None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="flights.build")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--builds", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--n-samples", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aqpbench import common, harness, spec
    from aqpbench import trace as tr
    harness.cache_env(ROOT)
    dev = torch.device(args.device)
    cell = spec.cell(args.workload)
    config = dict(cell["config"])
    if args.n_samples:
        config["build"] = dict(config["build"], n_samples=args.n_samples)
    seeds = common.Seeds(args.seed)
    table = spec.table(config["table"])(args.rows or config["rows"],
                                        seeds.data)
    warm = common.framework(config, seeds.sample(0), dev)
    warm.ingest(table)
    compressed, columns = warm.compressed, warm.preprocessed.columns
    del warm
    common.settle(dev)
    k = 0

    def build():
        nonlocal k
        k += 1
        fw = common.framework(config, seeds.sample(k), dev)
        b0 = time.perf_counter()
        fw.ingest_compressed(compressed, columns)
        common.sync(dev)
        return time.perf_counter() - b0, fw.synopsis.build_stats

    plain_s, traced_s, traced_stats, copies = [], [], [], []
    for _ in range(args.rounds):
        plain_s += [build()[0] for _ in range(args.builds)]
        dtrace = tr.DeviceTrace(dev)
        dtrace.start()
        enabled = torch.autograd._profiler_enabled()
        got = [build() for _ in range(args.builds)]
        dtrace.stop()
        traced_s += [s for s, _ in got]
        traced_stats += [st for _, st in got]
        copies.append(_copies(dtrace.events, [st for _, st in got]))

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    annotated = [build()[1] for _ in range(args.builds)]
    common.sync(dev)
    wall_ns, perf = time.time_ns(), time.perf_counter()
    prof.__exit__(None, None, None)
    gaps = _annotation_gaps(prof, wall_ns, perf, annotated)

    p1, p2, p3 = _quartiles(plain_s)
    t1, t2, t3 = _quartiles(traced_s)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "build_s_untraced": {"median": p2, "q1": p1, "q3": p3,
                             "all": plain_s},
        "build_s_traced": {"median": t2, "q1": t1, "q3": t3,
                           "all": traced_s},
        "traced_over_untraced": t2 / p2 - 1.0,
        "profiler_enabled_under_device_trace": enabled,
        "copies": {
            kind: {side: sum(c[side][kind] for c in copies)
                   for side in ("device_trace", "counters")}
            for kind in ("h2d", "d2h")},
        "annotations": gaps,
        "span_s": _mean_spans(traced_stats),
        "counts": _mean_counts(traced_stats),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
