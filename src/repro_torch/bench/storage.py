"""§4.3 storage encoding on the port: encoded size against the Eq. 12
bound, codec round-trip integrity and the vectorized decode against the
per-bin decode.

    run(rows, quick=False, device=None, out_dir=None)

Each table is ingested by ``AQPFramework`` on ``device`` (``None``: the
CUDA device, raising without one; ``"cpu"``: the kernels' plain
versions); the codec itself is host NumPy. Sizes are the module-level
``FULL`` / ``QUICK`` tables. Rows go to ``rows``; the JSON goes to
``out_dir/storage.json``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.aqp.datasets import load
from repro_torch.aqp.engine import AQPFramework
from repro_torch.bench.common import emit, save_json
from repro_torch.core import storage
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

FULL = {"datasets": ("power", "taxi"), "n": 100_000, "n_samples": 50_000}
QUICK = dict(FULL, datasets=("power",))


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    sizes = QUICK if quick else FULL
    out = {"quick": quick}
    for name in sizes["datasets"]:
        table = load(name, n=sizes["n"])
        fw = AQPFramework(BuildParams(n_samples=sizes["n_samples"]),
                          device=dev).ingest(table)
        rep = storage.synopsis_size_report(fw.synopsis)
        t0 = time.perf_counter()
        blob = storage.encode(fw.synopsis)
        encode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ph2 = storage.decode(blob)
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ph_oracle = storage.decode(blob, vectorized=False)
        decode_oracle_ms = (time.perf_counter() - t0) * 1e3
        roundtrip = all(
            np.allclose(h1.h, h2.h) and np.allclose(h1.edges, h2.edges)
            for h1, h2 in zip(fw.synopsis.hists, ph2.hists))
        vectorized_ok = all(
            np.array_equal(h1.h, h2.h) and np.array_equal(h1.edges, h2.edges)
            for h1, h2 in zip(ph_oracle.hists, ph2.hists))
        rep["roundtrip_ok"] = roundtrip
        rep["vectorized_matches_oracle"] = vectorized_ok
        rep["ratio_vs_eq12"] = rep["total"] / max(rep["eq12_bound"], 1)
        rep["encode_ms"] = encode_ms
        rep["decode_ms"] = decode_ms
        rep["decode_oracle_ms"] = decode_oracle_ms
        rep["decode_speedup"] = decode_oracle_ms / max(decode_ms, 1e-9)
        out[name] = rep
        emit(rows, f"storage/{name}/encoded", None, f"{rep['total']}B")
        emit(rows, f"storage/{name}/vs_eq12_bound", None,
             f"{rep['ratio_vs_eq12']:.2f}x")
        emit(rows, f"storage/{name}/roundtrip", None, str(roundtrip))
        emit(rows, f"storage/{name}/codec", None,
             f"encode {encode_ms:.1f} ms / decode {decode_ms:.1f} ms")
        emit(rows, f"storage/{name}/decode_vectorized", None,
             f"{decode_ms:.1f} ms vs oracle {decode_oracle_ms:.1f} ms "
             f"({rep['decode_speedup']:.1f}x, match={vectorized_ok})")
    save_json("storage", out, dev, out_dir)
    return out
