"""Table 6 on the port: bounds correct-rate (%) and median bound width (%
of exact) on the scaled-up power and flights tables.

    run(rows, quick=False, device=None, out_dir=None)

The paper's reference points: PairwiseHist 70–80% correct with ~3–9%
widths. The faithful Eq. 29 widening is reported, plus the corrected
sampling bounds for comparison. The synopsis is built on ``device``
(``None``: the CUDA device, raising without one). Sizes are ``FULL`` /
``QUICK``. The JSON goes to ``out_dir/table6.json``.
"""
from __future__ import annotations

from repro_torch.aqp.datasets import load, scale_up
from repro_torch.aqp.engine import AQPFramework
from repro_torch.aqp.exact import ExactEngine
from repro_torch.aqp.queries import AGGS_FULL, generate_queries
from repro_torch.bench.common import emit, eval_engine, save_json
from repro_torch.core.query import QueryEngine
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

FULL = {"n": 150_000, "scale": 8, "queries": 100, "n_samples": 100_000}
QUICK = {"n": 75_000, "scale": 2, "queries": 40, "n_samples": 100_000}


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    sizes = QUICK if quick else FULL
    out = {"quick": quick}
    for name in ("power", "flights"):
        base = load(name, n=sizes["n"])
        table = scale_up(base, sizes["scale"], seed=7)
        exact = ExactEngine(table)
        queries = generate_queries(table, sizes["queries"], seed=29,
                                   aggs=AGGS_FULL, max_preds=4,
                                   min_selectivity=1e-5)
        fw = AQPFramework(BuildParams(n_samples=sizes["n_samples"]),
                          device=dev).ingest(table)
        res_faithful = eval_engine(fw.query, queries, exact)
        res_faithful.pop("errs")
        eng_corr = QueryEngine(fw.synopsis, corrected_sampling_bounds=True)
        res_corr = eval_engine(eng_corr.query, queries, exact)
        res_corr.pop("errs")
        out[name] = {"faithful_eq29": res_faithful,
                     "corrected": res_corr}
        emit(rows, f"table6/{name}/correct_rate", None,
             f"{res_faithful['bounds_correct_pct']:.1f}%")
        emit(rows, f"table6/{name}/width", None,
             f"{res_faithful['median_bound_width_pct']:.2f}%")
        emit(rows, f"table6/{name}/correct_rate_corrected", None,
             f"{res_corr['bounds_correct_pct']:.1f}%")
    save_json("table6", out, dev, out_dir)
    return out
