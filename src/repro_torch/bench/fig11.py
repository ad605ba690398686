"""Fig. 11 on the port: synopsis storage, total storage with compression,
query latency and construction time on the scaled-up tables.

    run(rows, quick=False, device=None, out_dir=None)

The paper's claims: sub-MB synopses; total storage reduction 3.2–4.3x with
GreedyGD; sub-ms median query latency; construction in seconds to minutes
and faster when seeded with GD bases. Each table is ingested twice on
``device`` (``None``: the CUDA device, raising without one), with and
without compression; latencies and build times are host wall time. Sizes
are ``FULL`` / ``QUICK``. The JSON goes to ``out_dir/fig11.json``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.aqp.datasets import load, scale_up
from repro_torch.aqp.engine import AQPFramework
from repro_torch.aqp.queries import AGGS_FULL, generate_queries
from repro_torch.bench.common import emit, save_json
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

FULL = {"n": 150_000, "scale": 8, "queries": 80, "n_samples": 100_000}
QUICK = {"n": 75_000, "scale": 2, "queries": 30, "n_samples": 100_000}


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    sizes = QUICK if quick else FULL
    out = {"quick": quick}
    for name in ("power", "flights"):
        base = load(name, n=sizes["n"])
        table = scale_up(base, sizes["scale"], seed=9)
        queries = generate_queries(table, sizes["queries"], seed=31,
                                   aggs=AGGS_FULL, max_preds=5,
                                   min_selectivity=1e-5)
        params = BuildParams(n_samples=sizes["n_samples"])
        # With compression (bases seed bin edges) vs without.
        fw = AQPFramework(params, use_compression=True,
                          device=dev).ingest(table)
        fw_nc = AQPFramework(params, use_compression=False,
                             device=dev).ingest(table)
        lats = []
        for sql in queries:
            t0 = time.perf_counter()
            fw.query(sql)
            lats.append(time.perf_counter() - t0)
        rep = fw.storage_report()
        entry = {
            "synopsis_bytes": rep["synopsis"]["total"],
            "compressed_data_bytes": rep["compressed_data_bytes"],
            "raw_data_bytes": rep["raw_data_bytes"],
            "total_storage_reduction": rep["total_storage_reduction"],
            "median_latency_ms": float(np.median(lats) * 1e3),
            "p99_latency_ms": float(np.percentile(lats, 99) * 1e3),
            "build_with_gd_s": fw.timings["build_synopsis_s"],
            "compress_s": fw.timings["compress_s"],
            "build_without_gd_s": fw_nc.timings["build_synopsis_s"],
        }
        out[name] = entry
        emit(rows, f"fig11/{name}/latency",
             entry["median_latency_ms"] * 1e3, "median query")
        emit(rows, f"fig11/{name}/synopsis_size", None,
             f"{entry['synopsis_bytes']}B")
        emit(rows, f"fig11/{name}/total_storage_reduction", None,
             f"{entry['total_storage_reduction']:.2f}x")
        emit(rows, f"fig11/{name}/build_time", None,
             f"{entry['build_with_gd_s']:.1f}s(gd)/"
             f"{entry['build_without_gd_s']:.1f}s(raw)")
    save_json("fig11", out, dev, out_dir)
    return out
