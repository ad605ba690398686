"""Kernel micro-benchmarks and the fused-query-path comparison, on the port.

    run(rows, quick=False, device=None, out_dir=None)

Four measurements, each checked against its plain version (a mismatch
raises):

  (a) ``hist2d`` (K5) at 100,000 rows into 256 x 256 bins, against its plain
      version and ``torch.bincount`` on the flat id;
  (b) ``fused_weightings`` (K2) at L = 5, K2 = K1 = 256, against its plain
      version, both on the fold's index (converted once, outside the
      timed calls);
  (c) one AVG query with three predicates over the 100,000-row ``power``
      table (``BuildParams(n_samples=50_000)``), answered through the
      per-predicate host path and through ``FastPath(device)``; the answers
      must agree at rtol 1e-5;
  (d) ``hist2d_sharded`` across a ``torch.distributed`` world of size 1
      (gloo, file rendezvous in ``out_dir``) on the rows of (a).

``quick`` cuts every size (a few thousand rows, L = 2, K = 32). Times are
wall microseconds per call (``common.time_us``). ``device=None`` runs on the
CUDA device and raises without one; only ``device="cpu"`` runs on the CPU,
through the plain versions. Rows go to ``rows`` as ``name,us,derived``; the
JSON goes to ``out_dir/kernels.json`` (``common.RESULTS_DIR`` by default).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.aqp.datasets import load
from repro_torch.aqp.engine import AQPFramework
from repro_torch.bench.common import RESULTS_DIR, emit, save_json, time_us
from repro_torch.core.fastpath import FastPath
from repro_torch.core.query import QueryEngine
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.kernels.hist2d import hist2d, hist2d_sharded
from repro_torch.kernels.hist2d.ref import hist2d_ref
from repro_torch.kernels.weightings import fold_index, fused_weightings
from repro_torch.kernels.weightings.ref import fused_weightings_ref

QUERY = ("SELECT AVG(global_active_power) FROM t WHERE voltage > 238 AND "
         "global_intensity < 9 AND sub_metering_3 >= 1")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"bench kernels: {what}")


def _bench_hist2d(rows, out, dev, rng, quick):
    n, ki, kj = (4_000, 64, 64) if quick else (100_000, 256, 256)
    bi = torch.as_tensor(rng.integers(0, ki, n, dtype=np.int32), device=dev)
    bj = torch.as_tensor(rng.integers(0, kj, n, dtype=np.int32), device=dev)
    w = torch.as_tensor(rng.random(n, dtype=np.float32), device=dev)
    flat = bi.to(torch.int64) * kj + bj
    got, want = hist2d(bi, bj, w, ki, kj), hist2d_ref(bi, bj, w, ki, kj)
    _require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
             "hist2d differs from its plain version")
    t_k = time_us(lambda: hist2d(bi, bj, w, ki, kj), dev)
    t_p = time_us(lambda: hist2d_ref(bi, bj, w, ki, kj), dev)
    t_b = time_us(lambda: torch.bincount(flat, weights=w, minlength=ki * kj),
                  dev)
    out["hist2d"] = {"n": n, "ki": ki, "kj": kj, "us": t_k, "plain_us": t_p,
                     "bincount_us": t_b, "matches_plain": True}
    emit(rows, "kernels/hist2d", t_k, f"n={n} k={ki}x{kj} match=True")
    emit(rows, "kernels/hist2d_plain", t_p, "scatter_add_")
    emit(rows, "kernels/hist2d_bincount", t_b, "torch.bincount")
    return bi, bj, ki, kj


def _bench_weightings(rows, out, dev, rng, quick):
    el, k2, k1 = (2, 32, 32) if quick else (5, 256, 256)
    H = rng.random((el, k2, k2)).astype(np.float32)
    beta = rng.random((el, k2)).astype(np.float32)
    hx = H.sum(2) + 1.0
    fold = np.zeros((el, k1, k2), np.float32)
    fold[:, np.arange(k1), np.sort(rng.integers(0, k2, k1))] = 1
    H, beta, fold, hx = (torch.as_tensor(a, device=dev)
                         for a in (H, beta, fold, hx))
    fold = fold_index(fold)     # once, outside the timed calls
    _require(torch.allclose(fused_weightings(H, beta, fold, hx),
                            fused_weightings_ref(H, beta, fold, hx),
                            rtol=1e-5, atol=1e-5),
             "fused_weightings differs from its plain version")
    t_k = time_us(lambda: fused_weightings(H, beta, fold, hx), dev)
    t_p = time_us(lambda: fused_weightings_ref(H, beta, fold, hx), dev)
    out["fused_weightings"] = {"l": el, "k2": k2, "k1": k1, "us": t_k,
                               "plain_us": t_p, "matches_plain": True}
    emit(rows, "kernels/fused_weightings", t_k,
         f"L={el} K2={k2} K1={k1} match=True")
    emit(rows, "kernels/fused_weightings_plain", t_p, "plain")


def _bench_query(rows, out, dev, quick):
    n, n_samples = (4_000, 2_000) if quick else (100_000, 50_000)
    fw = AQPFramework(BuildParams(n_samples=n_samples), device=dev)
    fw.ingest(load("power", n=n))
    per_pred = QueryEngine(fw.synopsis)
    fused = QueryEngine(fw.synopsis, fastpath=FastPath(dev))
    a, b = per_pred.query(QUERY).as_tuple(), fused.query(QUERY).as_tuple()
    agree = bool(np.allclose(a, b, rtol=1e-5))
    _require(agree, f"fused answer {b} differs from per-predicate {a}")
    t_pp = time_us(lambda: per_pred.query(QUERY), dev)
    t_f = time_us(lambda: fused.query(QUERY), dev)
    out["query_path"] = {"n": n, "n_samples": n_samples,
                         "per_predicate_us": t_pp, "fused_us": t_f,
                         "answer": list(b), "agree": agree}
    emit(rows, "kernels/query_per_predicate", t_pp, "baseline")
    emit(rows, "kernels/query_fused", t_f,
         f"{t_pp / t_f:.2f}x vs baseline, agree={agree}")


def _bench_sharded(rows, out, dev, rng, bi, bj, ki, kj, out_dir):
    import torch.distributed as dist
    w01 = torch.as_tensor((rng.random(bi.shape[0]) < 0.9).astype(np.float32),
                          device=dev)
    owned = not dist.is_initialized()
    init = Path(out_dir) / "sharded_world1.init"
    if owned:
        init.parent.mkdir(parents=True, exist_ok=True)
        init.unlink(missing_ok=True)
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                world_size=1, rank=0)
    try:
        got = hist2d_sharded(bi, bj, w01, ki, kj)
        _require(torch.equal(got, hist2d_ref(bi, bj, w01, ki, kj)),
                 "hist2d_sharded differs from the plain version")
        t = time_us(lambda: hist2d_sharded(bi, bj, w01, ki, kj), dev)
        world = dist.get_world_size()
    finally:
        if owned:
            dist.destroy_process_group()
            init.unlink(missing_ok=True)
    out["hist2d_sharded"] = {"n": int(bi.shape[0]), "world": world,
                             "backend": "gloo", "us": t, "exact": True}
    emit(rows, "kernels/hist2d_sharded", t, f"world={world} exact=True")


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    out_dir = Path(RESULTS_DIR if out_dir is None else out_dir)
    rng = np.random.default_rng(0)
    out = {"quick": quick}
    bi, bj, ki, kj = _bench_hist2d(rows, out, dev, rng, quick)
    _bench_weightings(rows, out, dev, rng, quick)
    _bench_query(rows, out, dev, quick)
    _bench_sharded(rows, out, dev, rng, bi, bj, ki, kj, out_dir)
    save_json("kernels", out, dev, out_dir)
    return out
