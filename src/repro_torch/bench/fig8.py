"""Fig. 8 on the port: median query error and synopsis size across
datasets.

    run(rows, quick=False, device=None, out_dir=None)

PairwiseHist (built on ``device`` at two sample sizes) vs the sampling
baseline and the histogram-product (attribute-independence) baseline
(``repro_torch.aqp.baselines``, host NumPy), over the synthetic dataset
suite. The paper's claims: PairwiseHist sub-1% median error on most
datasets with sub-MB synopses, 1–2 orders of magnitude smaller than
competitors at comparable accuracy. Query latencies are host wall time.
Sizes are the module-level ``FULL`` / ``QUICK`` tables; ``device=None`` is
the CUDA device (raising without one). The JSON goes to
``out_dir/fig8.json``.
"""
from __future__ import annotations

from repro_torch.aqp.baselines import HistProductAQP, SamplingAQP
from repro_torch.aqp.datasets import load
from repro_torch.aqp.engine import AQPFramework
from repro_torch.aqp.exact import ExactEngine
from repro_torch.aqp.queries import AGGS_INITIAL, generate_queries
from repro_torch.bench.common import emit, eval_engine, save_json
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

DATASETS = ("power", "flights", "iot_temp", "aqua", "taxi", "gas")
FULL = {"datasets": DATASETS, "n": 150_000, "queries": 50,
        "n_samples": (10_000, 50_000), "baseline_sample": 50_000}
QUICK = dict(FULL, datasets=DATASETS[:3])


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    sizes = QUICK if quick else FULL
    out = {"quick": quick}
    for name in sizes["datasets"]:
        table = load(name, n=sizes["n"])
        exact = ExactEngine(table)
        queries = generate_queries(table, sizes["queries"], seed=17,
                                   aggs=AGGS_INITIAL, max_preds=3,
                                   min_selectivity=1e-4)
        per = {}
        for n_s in sizes["n_samples"]:
            fw = AQPFramework(BuildParams(n_samples=n_s),
                              device=dev).ingest(table)
            res = eval_engine(fw.query, queries, exact)
            res["size_bytes"] = fw.size_bytes()
            res.pop("errs")
            per[f"pairwisehist_{n_s//1000}k"] = res
            emit(rows, f"fig8/{name}/pairwisehist_{n_s//1000}k_err",
                 res["median_latency_ms"] * 1e3, f"{res['median_err']:.3f}%")
            emit(rows, f"fig8/{name}/pairwisehist_{n_s//1000}k_size",
                 None, f"{res['size_bytes']}B")
        n_b = sizes["baseline_sample"]
        tag = f"{n_b // 1000}k"
        samp = SamplingAQP(table, n_sample=n_b)
        res = eval_engine(samp.query, queries, exact)
        res["size_bytes"] = samp.size_bytes()
        res.pop("errs")
        per[f"sampling_{tag}"] = res
        emit(rows, f"fig8/{name}/sampling_{tag}_err",
             res["median_latency_ms"] * 1e3,
             f"{res['median_err']:.3f}%/{res['size_bytes']}B")
        hp = HistProductAQP(table, n_sample=n_b)
        res = eval_engine(hp.query, queries, exact)
        res["size_bytes"] = hp.size_bytes()
        res.pop("errs")
        per[f"histproduct_{tag}"] = res
        emit(rows, f"fig8/{name}/histproduct_{tag}_err",
             res["median_latency_ms"] * 1e3,
             f"{res['median_err']:.3f}%/{res['size_bytes']}B")
        out[name] = per
    save_json("fig8", out, dev, out_dir)
    return out
