"""Trace lane of the PyTorch port.

    PYTHONPATH=src python scripts/torch_trace_smoke.py              # card
    PYTHONPATH=src python scripts/torch_trace_smoke.py --device cpu

The port's counterpart of ``scripts/trace_smoke.py``, with the same table,
workload, seeds and gates, over the port's observability surface:

  1. build one small synopsis with the always-on build timeline and serve a
     small workload through a *traced* ``AQPServer`` (``"cuda"`` mode on
     the card, whose waves launch the fused weightings kernel and whose
     table answers single queries through ``FastPath``, its single-query
     launch; ``"ref"`` mode with ``--device cpu``);
  2. export both the serving span ring and the construction timeline to
     trace_event JSON, JSON-round-trip them, and validate against the
     schema checker (``repro_torch.obs.export.validate_trace_events``);
  3. replay the same workload through traced and untraced servers in
     back-to-back chunk pairs (order alternating, median of per-pair
     ratios over ``OVERHEAD_REPS`` passes — robust to the ±20% drift of
     shared boxes) and assert the traced overhead stays under
     ``TRACE_SMOKE_MAX_OVERHEAD_PCT`` (default 5%);
  4. sanity-check one EXPLAIN breakdown: stages tile submit->resolve, and
     the accounted total covers the observed wall-clock.

Writes nothing outside a temp directory; exits non-zero on any failure.
The last line is the kernels' launch counts as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch import kernels
from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.fastpath import FastPath
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.obs.export import (timeline_to_events, validate_trace_events,
                                    write_trace)
from repro_torch.serve.aqp import AQPServer

MAX_OVERHEAD_PCT = float(os.environ.get("TRACE_SMOKE_MAX_OVERHEAD_PCT", "5"))
# Passes over the workload's chunk pairs (the reference lane makes 3). A
# chunk served in "cuda" mode is short, so each ratio carries much of the
# host's jitter: on an H100's host, around a ~3.5% overhead, the median
# of 3 passes spreads over about 8 points, of 20 over about 3, of 60 over
# about 0.5 (scripts/torch_trace_overhead.py).
OVERHEAD_REPS = 60


def _framework(dev):
    rng = np.random.default_rng(11)
    n = 8_000
    table = {
        "a": rng.integers(0, 400, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "c": rng.integers(0, 40, n).astype(float),
        "g": np.array([f"g{i}" for i in rng.integers(0, 10, n)]),
    }
    params = BuildParams(n_samples=4_000, seed=1)
    return AQPFramework(params=params, use_compression=False,
                        fastpath=FastPath(dev), device=dev).ingest(table)


def _workload():
    """All-distinct queries so every one executes (a result-cache hit's
    wall-clock is smaller than a single span, which would make a relative
    budget meaningless), with GROUP BY mixed in so per-query work is
    representative of serving traffic (leaf expansion multiplies the real
    work per query; the tracing cost stays per-query)."""
    sqls = []
    for thr in range(40, 136, 2):
        sqls.append(f"SELECT AVG(b) FROM t WHERE a > {thr * 2} GROUP BY g")
        sqls.append(f"SELECT COUNT(a) FROM t WHERE b > {thr} AND c < 25")
    return sqls


def _make_server(fw, dev, mode: str, trace_enabled: bool) -> AQPServer:
    srv = AQPServer(mode=mode, device=dev, trace_enabled=trace_enabled)
    srv.register("t", fw)
    return srv


def _chunk_ms(srv, chunk) -> float:
    t0 = time.perf_counter()
    srv.query_batch(chunk)
    return (time.perf_counter() - t0) / len(chunk) * 1e3


def _overhead_pct(fw, dev, mode: str, sqls) -> float:
    """Traced-vs-untraced overhead on the batched serving path.

    Shared boxes drift by +/- 20% at the 100ms timescale, so pass-level
    A/B medians cannot resolve a 5% effect. Instead each chunk of the
    workload is timed back-to-back on an untraced and a traced server
    (order alternating chunk to chunk, so drift biases successive pairs in
    opposite directions) and the reported overhead is the median of the
    per-chunk traced/untraced ratios — drift cancels within a pair, and a
    real regression shifts every pair.
    """
    chunks = [sqls[lo:lo + 8] for lo in range(0, len(sqls), 8)]
    ratios = []
    for _ in range(OVERHEAD_REPS):
        off_srv = _make_server(fw, dev, mode, False)
        on_srv = _make_server(fw, dev, mode, True)
        for i, chunk in enumerate(chunks):
            if i % 2 == 0:
                off = _chunk_ms(off_srv, chunk)
                on = _chunk_ms(on_srv, chunk)
            else:
                on = _chunk_ms(on_srv, chunk)
                off = _chunk_ms(off_srv, chunk)
            ratios.append(on / off)
        off_srv.close()
        on_srv.close()
    return (float(np.median(ratios)) - 1.0) * 100.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host and 'ref' mode (default: the "
                         "CUDA device, 'cuda' mode)")
    dev = resolve_device(ap.parse_args(argv).device)
    code = _run(dev, "cuda" if dev.type == "cuda" else "ref")
    print(json.dumps({"launches": kernels.launch_counts()}))
    return code


def _run(dev, mode: str) -> int:
    failures = []
    fw = _framework(dev)
    sqls = _workload()

    # --- serve traced once: explain sanity + span export -------------------
    srv = _make_server(fw, dev, mode, True)
    t0 = time.perf_counter()
    res = srv.query(sqls[0])
    wall_ms = (time.perf_counter() - t0) * 1e3
    exp = res.explain
    if exp is None:
        failures.append("traced query returned no explain")
    else:
        stage_sum = sum(exp[k] for k in ("plan_ms", "admit_ms", "queue_ms",
                                         "assemble_ms", "execute_ms",
                                         "resolve_ms"))
        if abs(stage_sum - exp["total_ms"]) > 1e-6:
            failures.append(f"explain stages do not tile: {stage_sum} vs "
                            f"{exp['total_ms']}")
        if exp["total_ms"] > wall_ms:
            failures.append(f"explain total {exp['total_ms']:.3f} ms exceeds "
                            f"observed wall {wall_ms:.3f} ms")
    srv.query_batch(sqls[:16])
    events = srv.trace_events()
    srv.close()

    build_events = timeline_to_events(fw.synopsis.build_stats["timeline"])
    with tempfile.TemporaryDirectory() as tmp:
        for label, evs in (("serving", events), ("construction", build_events)):
            if not evs:
                failures.append(f"{label}: no trace events recorded")
                continue
            path = write_trace(os.path.join(tmp, f"{label}.json"), evs)
            with open(path) as f:
                parsed = json.load(f)
            problems = validate_trace_events(parsed)
            if problems:
                failures.append(f"{label}: invalid trace_event JSON: "
                                + "; ".join(problems[:5]))
            else:
                print(f"trace_smoke: {label} trace OK ({len(parsed)} events)")

    # --- traced vs untraced overhead ---------------------------------------
    warm = _make_server(fw, dev, mode, False)
    for lo in range(0, len(sqls), 16):            # compile/cache warm-up
        warm.query_batch(sqls[lo:lo + 16])
    warm.close()
    overhead_pct = _overhead_pct(fw, dev, mode, sqls)
    print(f"trace_smoke: traced-vs-untraced overhead {overhead_pct:+.1f}% "
          f"(median of paired chunk ratios, budget {MAX_OVERHEAD_PCT:.0f}%)")
    if overhead_pct >= MAX_OVERHEAD_PCT:
        failures.append(f"tracing overhead {overhead_pct:.1f}% >= "
                        f"{MAX_OVERHEAD_PCT:.1f}% budget")

    if failures:
        print("trace_smoke: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("trace_smoke: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
