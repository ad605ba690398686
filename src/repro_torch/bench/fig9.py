"""Fig. 9 on the port: parameter sensitivity to N_s, M (via ``m_frac``)
and alpha.

    run(rows, quick=False, device=None, out_dir=None)

The paper's claims: N_s dominates accuracy, size and build time; alpha has
near-zero impact; a lower M gives more bins, better accuracy and a bigger
synopsis. Every alpha of ``GRID`` has a checked-in crit table, so each
synopsis is the reference's. ``build_s`` is the host wall time of
``AQPFramework.ingest`` on ``device`` (``None``: the CUDA device, raising
without one). Sizes are ``FULL`` / ``QUICK`` (``knobs`` swept) with
``GRID`` and ``BASE``. The JSON goes to ``out_dir/fig9.json``.
"""
from __future__ import annotations

import time

from repro_torch.aqp.datasets import load
from repro_torch.aqp.engine import AQPFramework
from repro_torch.aqp.exact import ExactEngine
from repro_torch.aqp.queries import AGGS_INITIAL, generate_queries
from repro_torch.bench.common import emit, eval_engine, save_json
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

GRID = {
    "n_samples": (10_000, 50_000, 100_000),
    "m_frac": (0.005, 0.01, 0.02),
    "alpha": (0.01, 0.001, 0.0001),
}
BASE = dict(n_samples=50_000, m_frac=0.01, alpha=0.001)
FULL = {"n": 150_000, "queries": 50, "knobs": tuple(GRID)}
QUICK = {"n": 150_000, "queries": 25, "knobs": ("n_samples",)}


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    sizes = QUICK if quick else FULL
    table = load("flights", n=sizes["n"])
    exact = ExactEngine(table)
    queries = generate_queries(table, sizes["queries"], seed=41,
                               aggs=AGGS_INITIAL, max_preds=3,
                               min_selectivity=1e-4)
    out = {"quick": quick}
    for knob in sizes["knobs"]:
        for val in GRID[knob]:
            kw = dict(BASE)
            kw[knob] = val
            t0 = time.perf_counter()
            fw = AQPFramework(BuildParams(**kw), device=dev).ingest(table)
            build_s = time.perf_counter() - t0
            res = eval_engine(fw.query, queries, exact)
            res.pop("errs")
            res["build_s"] = build_s
            res["size_bytes"] = fw.size_bytes()
            out[f"{knob}={val}"] = res
            emit(rows, f"fig9/{knob}={val}", None,
                 f"err={res['median_err']:.3f}%/size={res['size_bytes']}B"
                 f"/build={build_s:.1f}s")
    save_json("fig9", out, dev, out_dir)
    return out
