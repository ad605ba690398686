"""GD pipeline lane of the PyTorch port.

    PYTHONPATH=src python scripts/torch_gd_smoke.py                 # card
    PYTHONPATH=src python scripts/torch_gd_smoke.py --device cpu

The port's counterpart of ``scripts/gd_smoke.py``, with the same table,
seeds and gates, end to end through the GD-native compressed pipeline:

  1. compress a tiny redundant table with GreedyGD and assert the
     compression ratio is > 1 (bases/deviations split actually pays);
  2. build the synopsis **directly from the CompressedTable** on the card
     (its pair rounds launch the 2-D and sub-bin histogram kernels) or,
     with ``--device cpu``, on the host — assert the build decoded only
     the N_s sampled rows (``rows_decoded`` stat) and is bit-identical to
     the raw build with ``seed_edges`` passed in;
  3. encode to a bit-packed blob, ``register_cold`` it on an ``AQPServer``
     (``"cuda"`` mode on the card, ``"ref"`` on the host) and serve: the
     first query decodes exactly once, the second reuses the decoded
     engine (decode-once counter), and the epoch is stable across the
     decode;
  4. GD-native ``rebuild`` bumps the epoch, purges the result cache, and
     the rebuilt table still answers; cold telemetry (synopsis bytes,
     decode ms) lands in ``stats()``;
  5. ``demote`` drops the engine back to its blob at a *stable* epoch,
     the next query transparently re-decodes (decode-count increments)
     with bit-identical answers, and demote telemetry lands in
     ``stats()["cold"]``.

Writes nothing; exits non-zero on any failure. The last line is the
kernels' launch counts as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch import kernels
from repro_torch.core import storage
from repro_torch.core.build import build_pairwise_hist
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.gd.greedygd import GreedyGD
from repro_torch.gd.preprocess import preprocess_table
from repro_torch.serve.aqp import AQPServer


def _table(n=12_000):
    rng = np.random.default_rng(7)
    return {
        "a": rng.integers(0, 12, n).astype(float) * 500,   # few bases
        "b": np.round(rng.normal(800, 4, n)),              # narrow spread
        "c": rng.integers(0, 6, n).astype(float),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host and 'ref' mode (default: the "
                         "CUDA device, 'cuda' mode)")
    dev = resolve_device(ap.parse_args(argv).device)
    mode = "cuda" if dev.type == "cuda" else "ref"
    code = _run(dev, mode)
    print(json.dumps({"launches": kernels.launch_counts()}))
    return code


def _run(dev, mode: str) -> int:
    pp = preprocess_table(_table())
    ct = GreedyGD(device=dev).compress(pp.data)
    ratio = ct.raw_size_bytes() / ct.size_bytes()
    if ratio <= 1.0:
        print(f"FAIL: compression ratio {ratio:.3f} <= 1")
        return 1
    print(f"compress: OK (ratio {ratio:.2f}x, "
          f"{ct.raw_size_bytes()} -> {ct.size_bytes()} bytes)")

    params = BuildParams(n_samples=5_000, seed=3)
    ph = build_pairwise_hist(ct, pp.columns, params, device=dev)
    if not ph.build_stats.get("from_compressed"):
        print("FAIL: build did not take the compressed path")
        return 1
    decoded = ph.build_stats.get("rows_decoded")
    if decoded != 5_000 or decoded >= ct.n_rows:
        print(f"FAIL: expected 5000 sampled rows decoded, got {decoded} "
              f"(table has {ct.n_rows})")
        return 1
    raw = build_pairwise_hist(pp.data, pp.columns, params,
                              seed_edges=GreedyGD.seed_edges(ct), device=dev)
    for h1, h2 in zip(ph.hists, raw.hists):
        if not (np.array_equal(h1.edges, h2.edges)
                and np.array_equal(h1.h, h2.h)):
            print("FAIL: compressed build differs from raw+seed_edges build")
            return 1
    print(f"gd-native build: OK ({decoded}/{ct.n_rows} rows decoded, "
          f"bit-identical to raw build)")

    blob = storage.encode(ph)
    srv = AQPServer(mode=mode, device=dev)
    srv.register_cold("t", blob, compressed=ct, params=params)
    cold = srv.catalog.resolve("t")
    e0 = srv.catalog.epoch("t")
    if cold.cold_info()["decoded"]:
        print("FAIL: registration decoded the blob eagerly")
        return 1
    sql = "SELECT COUNT(*) FROM t WHERE a > 2000"
    first = srv.query(sql)
    if cold.decode_count != 1 or srv.catalog.epoch("t") != e0:
        print(f"FAIL: first query: decode_count={cold.decode_count} "
              f"(want 1), epoch {e0} -> {srv.catalog.epoch('t')}")
        return 1
    srv.query("SELECT AVG(b) FROM t WHERE c < 3")
    if cold.decode_count != 1:
        print(f"FAIL: second query re-decoded (count={cold.decode_count})")
        return 1
    st = srv.stats()["tables"]["t"]["cold"]
    if st["synopsis_bytes"] != len(blob) or not st["decode_ms"]:
        print(f"FAIL: cold telemetry incomplete: {st}")
        return 1
    print(f"cold serve: OK (decode-once, {len(blob)} blob bytes, "
          f"{st['decode_ms']:.1f} ms decode, epoch stable)")

    cold.rebuild()
    if srv.catalog.epoch("t") <= e0:
        print(f"FAIL: rebuild did not bump the epoch ({e0} -> "
              f"{srv.catalog.epoch('t')})")
        return 1
    if len(srv.result_cache) != 0:
        print("FAIL: rebuild left stale result-cache entries")
        return 1
    again = srv.query(sql)
    if again.estimate is None or first.estimate is None:
        print("FAIL: no estimate before/after rebuild")
        return 1
    print(f"rebuild: OK (epoch {e0} -> {cold.epoch}, caches purged, "
          f"estimate {first.estimate:.0f} -> {again.estimate:.0f})")

    e1 = srv.catalog.epoch("t")
    dc = cold.decode_count
    if not srv.demote("t") or cold.engine is not None:
        print("FAIL: demote did not drop the decoded engine")
        return 1
    if srv.catalog.epoch("t") != e1:
        print(f"FAIL: demote moved the epoch ({e1} -> "
              f"{srv.catalog.epoch('t')})")
        return 1
    fresh = srv.query("SELECT COUNT(*) FROM t WHERE b < 810")
    if fresh.estimate is None or cold.decode_count != dc + 1:
        print(f"FAIL: post-demote query did not re-decode "
              f"(count={cold.decode_count}, want {dc + 1})")
        return 1
    redo = srv.query(sql)
    if redo.as_tuple()[:3] != again.as_tuple()[:3]:
        print(f"FAIL: post-demote answer drifted: "
              f"{again.as_tuple()[:3]} -> {redo.as_tuple()[:3]}")
        return 1
    snap = srv.stats()
    if snap["cold"]["demotes"] < 1 \
            or snap["tables"]["t"]["cold"]["demotes"] < 1:
        print(f"FAIL: demote telemetry missing: {snap.get('cold')}")
        return 1
    srv.close()
    print(f"demote: OK (re-decode {dc} -> {cold.decode_count}, epoch "
          f"stable at {e1}, answers bit-identical)")
    print("gd smoke: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
