"""Planner lane of the PyTorch port.

    PYTHONPATH=src python scripts/torch_plan_smoke.py               # card
    PYTHONPATH=src python scripts/torch_plan_smoke.py --device cpu

The port's counterpart of ``scripts/plan_smoke.py``, with the same table,
shapes, seeds and gates, end to end through the zero-parse planner path:

  1. build one small synopsis and serve a repeat-shape / distinct-literal
     workload through an ``AQPServer`` with templating on (every hit-phase
     query misses the plan and result caches, so only the template path
     can avoid the parse), in ``"cuda"`` mode on the card (its waves
     launch the fused weightings kernel, and the table's engine answers
     single queries through ``FastPath``, the kernel's single-query
     launch) or ``"ref"`` mode with ``--device cpu``;
  2. assert the hit phase performed **zero** ``parse_sql`` calls —
     counter-based (``repro_torch.core.sql.parse_calls``), not timing-based;
  3. assert hit-path answers are bit-for-bit equal to the cold path (every
     query parsed and planned from scratch: a server of the same mode with
     templating off, answering the same wave), and hit-path plans
     canonical-key-equal to freshly planned ones;
  4. sanity-check the telemetry: template-cache hit rate > 0 and the
     ``plan_template_hit`` stage reservoir populated on a traced re-run.

Writes nothing; exits non-zero on any failure. The last line is the
kernels' launch counts as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch import kernels
from repro_torch.aqp.engine import AQPFramework
from repro_torch.core import sql as sqlmod
from repro_torch.core.fastpath import FastPath
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.serve.aqp import AQPServer


def _framework(dev):
    rng = np.random.default_rng(13)
    n = 8_000
    table = {
        "a": rng.integers(0, 400, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "c": rng.integers(0, 40, n).astype(float),
        "g": np.array([f"g{i}" for i in rng.integers(0, 8, n)]),
    }
    return AQPFramework(params=BuildParams(n_samples=4_000, seed=1),
                        use_compression=False, fastpath=FastPath(dev),
                        device=dev).ingest(table)


SHAPES = [
    "SELECT COUNT(*) FROM t WHERE a > {p} AND b < {q}",
    "SELECT SUM(b) FROM t WHERE a >= {p} AND a <= {q}",
    "SELECT AVG(b) FROM t WHERE a < {p} OR c > {q}",
    "SELECT MIN(b) FROM t WHERE b > {p} AND b < {q}",
    "SELECT COUNT(b) FROM t WHERE a < {p} GROUP BY g",
]


def _workload(rng, n_per_shape=8):
    """Distinct-literal instances of each shape (no two texts equal, so the
    plan/result caches cannot answer them — only the template path can)."""
    out = []
    for shape in SHAPES:
        seen = set()
        while len(seen) < n_per_shape:
            p = int(rng.integers(0, 300))
            q = int(rng.integers(50, 400))
            if (p, q) not in seen:
                seen.add((p, q))
                out.append(shape.format(p=p, q=q))
    return out


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
    fw = _framework(dev)
    rng = np.random.default_rng(29)

    srv = AQPServer(mode=mode, device=dev).register("t", fw)
    # Cold phase: one instance per shape compiles each template.
    for shape in SHAPES:
        srv.query(shape.format(p=999, q=1000))

    hits = _workload(rng)
    before = sqlmod.parse_calls()
    served = srv.query_batch(hits)
    parses = sqlmod.parse_calls() - before
    if parses != 0:
        print(f"FAIL: template-hit phase performed {parses} parse_sql "
              f"calls (expected 0 across {len(hits)} queries)")
        return 1
    print(f"zero-parse: OK ({len(hits)} template-hit queries, 0 parses)")

    # Bit-for-bit: hit-path answers vs the cold path, and hit-path plans vs
    # freshly planned ones (these comparisons parse — they run after the
    # counting window).
    cold_srv = AQPServer(mode=mode, device=dev,
                         plan_templates=False).register("t", fw)
    cold_answers = cold_srv.query_batch(hits)
    cold_srv.close()
    eng = fw.engine
    for sql, got, want in zip(hits, served, cold_answers):
        if got.as_tuple() != want.as_tuple() or got.groups != want.groups:
            print(f"FAIL: hit-path result diverged for {sql!r}: "
                  f"{got.as_tuple()} vs {want.as_tuple()}")
            return 1
        fp = sqlmod.fingerprint_sql(sql)
        entry = srv.template_cache.get(fp.shape, srv.catalog.epoch)
        if entry is None:
            print(f"FAIL: no template cached for shape of {sql!r}")
            return 1
        hot = entry.value.bind(fp.literals)
        cold = eng.plan_sql(sql)
        if hot.canonical_key() != cold.canonical_key():
            print(f"FAIL: template plan differs from cold plan for {sql!r}:\n"
                  f"  hot : {hot.canonical_key()}\n"
                  f"  cold: {cold.canonical_key()}")
            return 1
    print(f"bit-for-bit: OK ({len(hits)} plans + results)")

    tc = srv.stats()["totals"]["template_cache"]
    if not tc["hits"] or tc["hit_rate"] <= 0:
        print(f"FAIL: template cache reports no hits: {tc}")
        return 1
    srv.close()

    # Traced re-run: the plan-stage split must label both paths.
    srv2 = AQPServer(mode=mode, device=dev, trace_enabled=True).register(
        "t", fw)
    srv2.query(SHAPES[0].format(p=10, q=100))          # cold -> plan_full
    hot = srv2.query(SHAPES[0].format(p=20, q=200))    # hit  -> template
    stages = srv2.stats()["totals"]["stages"]
    if stages["plan_full"]["p50_ms"] is None or \
            stages["plan_template_hit"]["p50_ms"] is None:
        print(f"FAIL: plan-stage split not populated: "
              f"full={stages['plan_full']} "
              f"template={stages['plan_template_hit']}")
        return 1
    if hot.explain is None or hot.explain.get("plan_path") != "template":
        print(f"FAIL: EXPLAIN plan_path label missing/wrong: {hot.explain}")
        return 1
    srv2.close()
    print("telemetry: OK (plan_full / plan_template_hit split + "
          "EXPLAIN plan_path)")
    print("plan smoke: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
