"""The ``rebuild`` loop: back-to-back synopsis builds of the seeded
compressed table through ``AQPFramework.ingest_compressed`` (the cold
catalog's rebuild path), a fresh framework and sample seed each build.

Set-up makes the table from the seed, pre-processes and compresses it
(GreedyGD) and builds once. The window builds until a build ends past its
close. ``correct`` judges the window's first build and one drawn from the
seed against the reference, which works the synopsis out again from the
raw table once the window has closed and the peak is read.
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
from aqpbench.reference import synopsis as ref


def build_s(seconds: float, deadline: float, builds) -> float:
    """Window seconds over builds completed, a build counted by its share
    inside the window (builds are (k, start, end, outcome))."""
    share = sum(min(1.0, max(0.0, (deadline - b0) / (b1 - b0)))
                for _, b0, b1, _ in builds)
    return seconds / share


def run(cell: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float, rows=None, n_samples=None, root=spec.ROOT) -> dict:
    import torch
    config, mix = cell["config"], cell["mix"]
    seeds = common.Seeds(seed)
    table = spec.table(config["table"], root)(rows or config["rows"],
                                              seeds.data)
    build = dict(config["build"])
    if n_samples:
        build["n_samples"] = n_samples
    config = dict(config, build=build)
    # Set-up: pre-processing, GreedyGD and one warm build.
    warm = common.framework(config, seeds.sample(0), dev)
    warm.ingest(table)
    compressed, columns = warm.compressed, warm.preprocessed.columns
    del warm
    common.settle(dev)

    recorder, dtrace = tr.LaunchRecorder(), tr.DeviceTrace(dev)
    builds, failed = [], 0
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
            fw = common.framework(config, seeds.sample(k), dev)
            b0 = time.perf_counter()
            try:
                fw.ingest_compressed(compressed, columns)
                common.sync(dev)
                builds.append((k, b0, time.perf_counter(), fw.synopsis))
            except Exception as exc:  # noqa: BLE001 — counted as failed
                traceback.print_exc(file=sys.stderr)
                failed += 1
                builds.append((k, b0, time.perf_counter(), exc))
            if builds[-1][2] >= deadline:
                break
        if trace:
            dtrace.stop()
    gc.unfreeze()
    metrics = {"build_s": build_s(seconds, deadline, builds),
               "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ok = [b for b in builds if not isinstance(b[3], BaseException)]
    record = {"kind": "build",
              "builds": [b[3].build_stats for b in ok]}
    if trace:
        spans = [(ev["name"], ev["t0"], ev["t1"]) for b in ok
                 for ev in b[3].build_stats.get("timeline", [])
                 if ev.get("kind") == "phase"]
        common.device_record(record, dtrace, recorder, t0, deadline, spans)

    # The reference: the window's first build and one drawn from the seed.
    rng = np.random.default_rng(seeds.check)
    picks = ok[:1]
    if len(ok) > 1:
        picks.append(ok[1 + int(rng.integers(len(ok) - 1))])
    picks = picks[:mix["check_builds"]]
    got = [check.fields(b[3]) for b in picks]
    sample_seeds = [seeds.sample(b[0]) for b in picks]
    del builds, ok, picks, fw, compressed
    wants = ref.reference(table, build, sample_seeds, dev,
                          gd=config["greedygd"])
    gaps = [check.synopsis_gap(g, w) for g, w in zip(got, wants)]
    checks = {"synopsis_gap": (max(gaps) if gaps else 1.0,
                               config["limits"]["synopsis_gap"]),
              "missing": (failed, 0)}
    return {"metrics": metrics, "record": record, "checks": checks,
            "attempted": len(record["builds"]) + failed, "failed": failed,
            "peak": peak, "checked": len(got)}
