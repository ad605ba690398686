"""The ``append_rebuild`` loop: a rolling window of days fed one day at a
time through the port's retention API, ``AQPFramework.expire_rows``,
``append_rows`` and ``rebuild()``.

Set-up renders the pool of days, each dated by its place in the pool
(``reference/stream.py`` states the stream), and ingests the first
``retained_days`` of them into one framework, which serves the whole run
with sample seed ``Seeds(seed).sample(0)``. The window runs cycles back to
back until one ends past its close: expire a day's rows, append the next
day, rebuild, wait for the device. ``build_s`` is the stale window a cycle,
as ``loops/rebuild.py`` counts builds. ``correct`` judges the window's
first cycle and one drawn from the seed against the reference, on the
retained table that ``reference/stream.py`` makes again from the seed once
the window has closed and the peak is read. A traced run records the
cycles' builds as ``loops/rebuild.py`` does, kernel launches included.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback

import numpy as np

from aqpbench import check, common, spec
from aqpbench import trace as tr
from aqpbench.loops.rebuild import build_s
from aqpbench.reference import stream
from aqpbench.reference import synopsis as ref


def run(cell: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float, rows=None, n_samples=None, root=spec.ROOT) -> dict:
    import torch
    from repro_torch.aqp.engine import AQPFramework
    if not hasattr(AQPFramework, "expire_rows"):
        raise SystemExit("aqpbench: the program has no retention API "
                         "(AQPFramework.expire_rows); append_rebuild "
                         "cannot run")
    config, mix = cell["config"], cell["mix"]
    seeds = common.Seeds(seed)
    n_day, keep = stream.day_rows(config, rows), config["retained_days"]
    make = spec.table(config["table"], root)
    pool = [make(n_day, seeds(stream.DAY_STREAM, j), j)
            for j in range(mix["pool_days"])]
    build = dict(config["build"])
    if n_samples:
        build["n_samples"] = n_samples
    config = dict(config, build=build)
    # Set-up: the first month's pre-processing, GreedyGD and build.
    fw = common.framework(config, seeds.sample(0), dev)
    fw.ingest({k: np.concatenate([d[k] for d in pool[:keep]])
               for k in pool[0]})
    common.settle(dev)

    recorder, dtrace = tr.LaunchRecorder(), tr.DeviceTrace(dev)
    cycles, timings, failed = [], {}, 0
    setup_s = time.perf_counter() - t_start
    ctx = recorder.installed() if trace else contextlib.nullcontext()
    with ctx:
        if trace:
            dtrace.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = 0
        while True:
            k += 1
            c0 = time.perf_counter()
            try:
                fw.expire_rows(n_day)
                fw.append_rows(pool[(keep + k - 1) % len(pool)])
                fw.rebuild()
                common.sync(dev)
                cycles.append((k, c0, time.perf_counter(), fw.synopsis))
                timings[k] = fw.timings
            except Exception as exc:  # noqa: BLE001 — counted as failed
                traceback.print_exc(file=sys.stderr)
                failed += 1
                cycles.append((k, c0, time.perf_counter(), exc))
            if cycles[-1][2] >= deadline:
                break
        if trace:
            dtrace.stop()
    gc.unfreeze()
    metrics = {"build_s": build_s(seconds, deadline, cycles),
               "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ok = [c for c in cycles if not isinstance(c[3], BaseException)]
    # Each cycle's ingest spans and counters, and its build's statistics
    # under the key that the build cells' readers take.
    record = {"kind": "append",
              "cycles": [{"phase_s": timings[c[0]]["ingest_phase_s"],
                          "counts": timings[c[0]]["ingest_counts"]}
                         for c in ok],
              "builds": [c[3].build_stats for c in ok]}
    if trace:
        spans = [(ev["name"], ev["t0"], ev["t1"]) for c in ok
                 for ev in (timings[c[0]]["ingest_timeline"]
                            + c[3].build_stats["timeline"])
                 if ev["kind"] == "phase"]
        common.device_record(record, dtrace, recorder, t0, deadline, spans)

    # The reference: the window's first cycle and one drawn from the seed.
    rng = np.random.default_rng(seeds.check)
    picks = ok[:1]
    if len(ok) > 1:
        picks.append(ok[1 + int(rng.integers(len(ok) - 1))])
    picks = picks[:mix["check_cycles"]]
    got = [check.fields(c[3]) for c in picks]
    checked = [c[0] for c in picks]
    del cycles, timings, ok, picks, fw, pool
    wants = [ref.reference(stream.retained(cell["config"], mix, seed, k,
                                           rows, root),
                           build, [seeds.sample(0)], dev,
                           gd=config["greedygd"])[0] for k in checked]
    gaps = [check.synopsis_gap(g, w) for g, w in zip(got, wants)]
    checks = {"synopsis_gap": (max(gaps) if gaps else 1.0,
                               config["limits"]["synopsis_gap"]),
              "missing": (failed, 0)}
    return {"metrics": metrics, "record": record, "checks": checks,
            "attempted": len(record["cycles"]) + failed, "failed": failed,
            "peak": peak, "checked": len(got)}
