"""Table 5 on the port: median relative error by aggregation function on
the scaled-up power and flights tables (IDEBench-style scale-up; all seven
aggregations).

    run(rows, quick=False, device=None, out_dir=None)

The paper's claims: per-function sub-2% medians for COUNT/SUM/AVG/VAR,
0–5%-ish for MIN/MAX/MEDIAN; overall medians ~0.2–0.5%. The synopsis is
built on ``device`` (``None``: the CUDA device, raising without one).
Sizes are ``FULL`` / ``QUICK``: base rows ``n`` scaled up ``scale`` times
(150,000 x 8 = 1.2M rows, a stand-in for the paper's 1e9). The JSON goes
to ``out_dir/table5.json``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.aqp.datasets import load, scale_up
from repro_torch.aqp.engine import AQPFramework
from repro_torch.aqp.exact import ExactEngine
from repro_torch.aqp.queries import AGGS_FULL, generate_queries, relative_error
from repro_torch.bench.common import emit, save_json
from repro_torch.core.sql import parse_sql
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

FULL = {"n": 150_000, "scale": 8, "queries": 140, "n_samples": 100_000}
QUICK = {"n": 75_000, "scale": 2, "queries": 60, "n_samples": 100_000}


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    sizes = QUICK if quick else FULL
    out = {"quick": quick}
    for name in ("power", "flights"):
        base = load(name, n=sizes["n"])
        table = scale_up(base, sizes["scale"], seed=5)
        exact = ExactEngine(table)
        queries = generate_queries(table, sizes["queries"], seed=23,
                                   aggs=AGGS_FULL, max_preds=5,
                                   min_selectivity=1e-5)
        fw = AQPFramework(BuildParams(n_samples=sizes["n_samples"]),
                          device=dev).ingest(table)
        by_func: dict[str, list] = {}
        for sql in queries:
            func = parse_sql(sql).func
            res = fw.query(sql)
            ex = exact.query(sql)
            by_func.setdefault(func, []).append(
                relative_error(res.estimate, ex))
        table_out = {}
        all_errs = []
        for func, errs in sorted(by_func.items()):
            med = float(np.median(errs))
            table_out[func] = {"median_err": med, "n": len(errs)}
            all_errs.extend(errs)
            emit(rows, f"table5/{name}/{func}", None, f"{med:.3f}%")
        table_out["overall"] = {"median_err": float(np.median(all_errs)),
                                "n": len(all_errs)}
        emit(rows, f"table5/{name}/overall", None,
             f"{table_out['overall']['median_err']:.3f}%")
        out[name] = table_out
    save_json("table5", out, dev, out_dir)
    return out
