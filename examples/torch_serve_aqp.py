"""Multi-table AQP serving demo on the PyTorch port: streaming admission +
batched execution.

The port's counterpart of ``examples/serve_aqp.py``. The single-table
``AQPFramework`` answers one query at a time; the serving subsystem
(``repro_torch.serve.aqp``; the reference's docs/serving.md) turns it into
a multi-tenant query server:

  * **TableCatalog** — registers many named tables, so ``FROM <table>``
    actually resolves (unknown tables raise ``PlanError``);
  * **streaming admission** — ``submit`` enqueues and returns a
    ``QueryFuture`` immediately; an admission worker drains the queue into
    waves under a latency/batch-size policy and resolves futures as waves
    complete (``query_batch`` is the synchronous submit+flush+wait
    wrapper);
  * **BatchScheduler** — groups in-flight queries by plan shape
    (table, agg column, predicate column set) and runs every group as ONE
    fused query-batched kernel launch (``kernels.weightings
    .batched_weightings``, a CUDA kernel on the card); GROUP BY queries
    expand into per-category leaf plans at planning time and their leaves
    ride the same fused launches (OR-trees fall back per query);
  * **backpressure** — the admission queue is bounded (``max_queue_depth``)
    and a full queue sheds per ``shed_policy`` (``reject`` /
    ``shed_oldest`` / ``block``), resolving the losing futures with a
    typed ``AdmissionRejected`` result instead of growing without limit
    (synchronous ``query_batch`` drains-and-retries instead);
  * **LRU plan + result caches** — keyed on normalized SQL (plus
    plan-canonical per-leaf keys for GROUP BY) and the owning table's
    staleness epoch, so ``append_rows`` invalidates rather than serves
    stale results;
  * **Metrics** — per-table p50/p99 latency, throughput, cache hit rates,
    GROUP BY expansion counters, admission queue/wait/drain/shed
    telemetry;
  * **tracing** — the demo runs with tracing on: each query gets an
    EXPLAIN stage breakdown (printed for one below) and the span ring is
    exported to ``trace.json`` in the working directory — open it at
    https://ui.perfetto.dev (or chrome://tracing) to see the admission /
    worker / per-query swimlanes.

Run:

    PYTHONPATH=src python examples/torch_serve_aqp.py                # card
    PYTHONPATH=src python examples/torch_serve_aqp.py --device cpu

On the card the servers run in ``"cuda"`` mode; with ``--device cpu`` in
``"ref"`` mode (the fused path through the kernel's plain version).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.aqp.datasets import load
from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.query import PlanError
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.serve.aqp import AQPServer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host and 'ref' mode (default: the "
                         "CUDA device, 'cuda' mode)")
    dev = resolve_device(ap.parse_args(argv).device)
    mode = "cuda" if dev.type == "cuda" else "ref"
    params = BuildParams(n_samples=20_000, seed=0)
    srv = AQPServer(mode=mode, device=dev, trace_enabled=True)

    print("== registering tables ==")
    for name in ("power", "flights"):
        table = load(name, n=50_000)
        srv.register_table(name, table, params=params, use_compression=False)
        print(f"  {name}: {len(next(iter(table.values()))):,} rows, "
              f"{len(table)} columns")

    print("\n== one wave, two tables, mixed shapes ==")
    wave = [
        "SELECT COUNT(*) FROM power WHERE global_active_power > 2.0",
        "SELECT COUNT(*) FROM power WHERE global_active_power > 4.0",
        "SELECT AVG(arr_delay) FROM flights WHERE distance > 800",
        "SELECT SUM(arr_delay) FROM flights WHERE distance > 800 "
        "AND dep_delay > 10",
        # OR-tree: executes on the per-query reference path
        "SELECT COUNT(*) FROM flights WHERE dep_delay > 30 OR arr_delay > 30",
    ]
    for sql, res in zip(wave, srv.query_batch(wave)):
        est, lo, hi = res.as_tuple()
        print(f"  {sql}\n    -> {est:,.1f}  [{lo:,.1f}, {hi:,.1f}]")

    print("\n== EXPLAIN: where one traced query's wall-clock went ==")
    res = srv.query("SELECT AVG(arr_delay) FROM flights WHERE distance > 650")
    exp = res.explain
    for stage in ("plan", "admit", "queue", "assemble", "execute", "resolve"):
        print(f"  {stage:>9}: {exp[f'{stage}_ms']:8.3f} ms")
    print(f"  {'total':>9}: {exp['total_ms']:8.3f} ms  "
          f"(kernel share {exp['kernel_share_ms']:.3f} ms, "
          f"plan_cache_hit={exp['plan_cache_hit']}, "
          f"batched={exp['batched']}, wave={exp['wave_size']})")

    print("\n== GROUP BY rides the batched path (per-category leaf plans) ==")
    res = srv.query("SELECT AVG(arr_delay) FROM flights "
                    "WHERE distance > 500 GROUP BY airline")
    for value, (est, lo, hi) in sorted(res.groups.items())[:5]:
        print(f"  {value}: {est:,.1f}  [{lo:,.1f}, {hi:,.1f}]")
    print(f"  ... {len(res.groups)} groups; group_by telemetry: "
          f"{srv.stats()['tables']['flights']['group_by']}")

    print("\n== streaming: submit returns futures, waves resolve them ==")
    futures = [srv.submit(sql) for sql in wave * 2]   # dupes dedupe in-flight
    srv.flush()
    results = [fut.result() for fut in futures]
    print(f"  {len(futures)} submitted, "
          f"{sum(r.estimate is not None for r in results)} resolved; "
          f"admission: "
          f"{json.dumps(srv.stats()['totals']['admission'], default=float)}")

    print("\n== repeated query: served from the result cache ==")
    srv.query(wave[0])
    print(json.dumps(srv.stats()["totals"], indent=2, default=float))

    print("\n== staleness: append_rows invalidates, rebuild restores ==")
    fw: AQPFramework = srv.catalog.resolve("power")
    base = load("power", n=50_000)
    extra = {k: np.asarray(v)[:5_000] for k, v in base.items()}
    fw.append_rows(extra)
    try:
        srv.query(wave[0])
    except RuntimeError as exc:
        print(f"  stale as expected: {exc}")
    fw.rebuild(base)
    print(f"  after rebuild: {srv.query(wave[0]).estimate:,.1f}")

    print("\n== backpressure: a bounded queue sheds typed, never grows ==")
    tiny = AQPServer(catalog=srv.catalog, mode=mode, device=dev,
                     max_wait_ms=10_000.0,
                     max_queue_depth=1, shed_policy="reject")
    queued = tiny.submit(wave[1])             # occupies the whole queue
    turned = tiny.submit(wave[2])             # full -> AdmissionRejected
    res = turned.result()
    print(f"  rejected: rejected={res.rejected} reason={res.reason!r} "
          f"queue_depth={res.queue_depth} estimate={res.estimate}")
    tiny.flush()
    print(f"  queued one answered: {queued.result().estimate:,.1f}")
    print(f"  sync query_batch drains-and-retries instead: "
          f"{len(tiny.query_batch([wave[1], wave[2], wave[3]]))} answered")
    adm = tiny.stats()["totals"]["admission"]
    print(f"  ledger: rejected={adm['rejected']} shed={adm['shed']} "
          f"high_water={adm['queue_high_water']}")
    tiny.close()

    print("\n== unknown table ==")
    try:
        srv.query("SELECT COUNT(*) FROM nope WHERE x > 1")
    except PlanError as exc:
        print(f"  PlanError: {exc}")

    print("\n== per-table telemetry ==")
    print(json.dumps(srv.stats()["tables"], indent=2, default=float))

    print("\n== trace export ==")
    path = srv.export_trace("trace.json")
    tr = srv.stats()["tracing"]
    print(f"  {tr['spans_recorded']} spans ({tr['spans_dropped']} dropped) "
          f"-> {path}")
    print("  open it at https://ui.perfetto.dev to see the admission/worker/"
          "per-query swimlanes")


if __name__ == "__main__":
    main()
