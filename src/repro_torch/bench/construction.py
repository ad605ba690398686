"""Construction benchmarks on the port.

    run(rows, quick=False, device=None, out_dir=None, correlated_only=False,
        trace=False)

Four measurements:

  1. paper-faithful sequential construction (Algorithm 1/2, recursive
     NumPy, ``core/ref_sequential.py``) vs the level-synchronous build on
     ``device`` (full build);
  2. the 2-D *pair phase* alone on a mixed (mostly independent) table at
     d = 8: the per-pair loop (``pair_batched=False``, one host check a
     round and one transfer a pair) vs the default compacting scheduler,
     in pairs per second, the synopses required bit-for-bit equal;
  3. the *correlated-pair* table (``correlated_only`` runs it alone, with
     the GD build): the per-pair loop vs the compacting scheduler, with
     the compaction ledger and the (slots, capacity rung) of each of its
     launches; the synopses required bit-for-bit equal;
  4. a GreedyGD-compressed table: the build from the ``CompressedTable``
     vs the raw build with base-seeded edges, and the cold-start decode of
     the encoded synopsis.

``trace`` also exports one build's timeline as a validated trace file.
Pair-phase times are the synopsis's ``build_stats["pair_phase_s"]``, the
median of ``repeats`` builds after one warm build. Sizes are the
module-level ``FULL`` / ``QUICK`` tables. ``device=None`` runs on the CUDA
device and raises without one; ``device="cpu"`` runs on the CPU through
the kernels' plain versions. Rows go to ``rows`` as ``name,us,derived``;
the JSON goes to ``out_dir/construction.json``.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from repro_torch.bench.common import RESULTS_DIR, emit, save_json
from repro_torch.core import chi2 as chi2lib
from repro_torch.core import ref_sequential, storage
from repro_torch.core.build import build_pairwise_hist
from repro_torch.core.types import BuildParams, ColumnInfo
from repro_torch.device import resolve_device
from repro_torch.gd.greedygd import GreedyGD
from repro_torch.obs.export import (timeline_to_events, validate_trace_events,
                                    write_trace)
from repro_torch.serve.aqp.catalog import ColdTable

# (rows, columns) of each measurement, and the timed builds per scheduler.
FULL = {"full_build": (100_000, 6), "pair_phase": (60_000, 8),
        "correlated": (60_000, 8), "trace": (60_000, 8), "gd": (100_000, 6),
        "repeats": 3}
QUICK = {"full_build": (50_000, 4), "pair_phase": (20_000, 8),
         "correlated": (20_000, 8), "trace": (20_000, 8), "gd": (30_000, 6),
         "repeats": 2}


def _pair_phase_data(n: int, d: int, rng):
    """d >= 8 mixed workload: independent + correlated + heavy-tail columns
    so the 2-D refinement actually splits (the all-independent case is the
    degenerate no-split fast path)."""
    base = np.abs(rng.normal(300, 90, n))
    cols = [np.round(np.abs(rng.normal(100 * (i + 1), 20 + 10 * i, n)))
            for i in range(d - 2)]
    cols.append(np.round(base))
    cols.append(np.round(base * 2 + rng.normal(0, 20, n)))
    return np.stack(cols, 1)


def _correlated_data(n: int, d: int, rng):
    """Pairwise-dependent workload: half the columns derive from one shared
    base, so every pair among them refines deep while the independent half
    converges in a round or two — the mix that convergence compaction's
    drain and backfill are for."""
    base = np.abs(rng.normal(300, 90, n))
    cols = [np.round(np.abs(rng.normal(100 * (i + 1), 20 + 10 * i, n)))
            for i in range(d // 2)]
    cols += [np.round(base * (1 + 0.5 * i) + rng.normal(0, 15, n))
             for i in range(d - d // 2)]
    return np.stack(cols, 1)


def _cols(d: int) -> list:
    return [ColumnInfo(name=f"c{i}", kind="int") for i in range(d)]


def _timed_pair_phase(data, cols, params, repeats: int, dev):
    """Median ``pair_phase_s`` of ``repeats`` builds after a warm one;
    returns it with the last build's stats and synopsis."""
    syn = build_pairwise_hist(data, cols, params, device=dev)
    times = []
    for _ in range(repeats):
        syn = build_pairwise_hist(data, cols, params, device=dev)
        times.append(syn.build_stats["pair_phase_s"])
    return float(np.median(times)), syn.build_stats, syn


def _assert_pairs_equal(a, b):
    assert set(a.pairs) == set(b.pairs)
    for key in a.pairs:
        for f, x, y in zip(a.pairs[key]._fields, a.pairs[key], b.pairs[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"pair {key} field {f}")


def _run_correlated(rows: list, out: dict, sizes: dict, rng, dev):
    """Correlated-pair scenario: per-pair loop vs compacting.

    The tracked number is the speedup over the per-pair loop, with the
    compaction ledger (pair-rounds refined vs slot-rounds its launches
    could run) and the (slots, k2 rung) of every launch.
    """
    n, d = sizes["correlated"]
    repeats = sizes["repeats"]
    data = _correlated_data(n, d, rng)
    cols = _cols(d)
    n_pairs = d * (d - 1) // 2
    p_loop = BuildParams(n_samples=n, pair_batched=False)
    p_compact = dataclasses.replace(p_loop, pair_batched=True)

    t_loop, _, s_loop = _timed_pair_phase(data, cols, p_loop, repeats, dev)
    t_compact, cstats, s_compact = _timed_pair_phase(data, cols, p_compact,
                                                     repeats, dev)
    _assert_pairs_equal(s_loop, s_compact)
    comp = cstats["compaction"]
    out["correlated"] = {
        "n": n, "d": d, "n_pairs": n_pairs,
        "per_pair_loop_s": t_loop,
        "compact_s": t_compact,
        "speedup_compact": t_loop / t_compact,
        "pairs_per_s_compact": n_pairs / t_compact,
        "occupancy": (comp["pair_rounds"] / comp["slot_rounds"]
                      if comp["slot_rounds"] else None),
        "compaction": comp,
        "compact_launches": [list(x) for x in cstats["pair_launches"]],
        "bitforbit_equal": True,
    }
    emit(rows, "construction/correlated_compact", t_compact * 1e6,
         f"{t_loop / t_compact:.2f}x vs loop; "
         f"occupancy {out['correlated']['occupancy']:.2f}")


def _trace_build(rows: list, out: dict, sizes: dict, rng, dev, out_dir):
    """One build's per-phase / per-launch timeline (``build_stats
    ["timeline"]``) exported to a validated trace_event file, with the
    phase-seconds summary in the JSON."""
    n, d = sizes["trace"]
    data = _correlated_data(n, d, rng)
    syn = build_pairwise_hist(data, _cols(d), BuildParams(n_samples=n),
                              device=dev)
    stats = syn.build_stats
    events = timeline_to_events(stats["timeline"])
    problems = validate_trace_events(events)
    path = write_trace(Path(out_dir) / "construction_trace.json", events)
    out["trace"] = {
        "n": n, "d": d,
        "phase_s": dict(stats.get("phase_s", {})),
        "events": len(events),
        "valid": not problems,
        "path": path,
    }
    emit(rows, "construction/trace_artifact", None,
         f"{len(events)} events, valid={not problems} -> {path}")
    for phase, secs in sorted(out["trace"]["phase_s"].items(),
                              key=lambda kv: -kv[1]):
        emit(rows, f"construction/phase_{phase}", secs * 1e6,
             f"{secs * 1e3:.1f} ms")


def _run_gd(rows: list, out: dict, sizes: dict, rng, dev):
    """GD-native compressed construction + storage cold start: compress a
    redundant table, build the synopsis from the ``CompressedTable`` (only
    the N_s sampled rows decode) vs the raw build with the same base-seeded
    edges, then encode the synopsis and time the cold-start decode a
    ``ColdTable`` pays on its first query."""
    n, d = sizes["gd"]
    # Few distinct high-order patterns per column -> real base dedup.
    data = np.stack(
        [rng.integers(0, 40 + 10 * i, n).astype(float) * 64
         + rng.integers(0, 8, n) for i in range(d)], 1)
    cols = _cols(d)
    # N_s < n so rows_decoded reflects a sample-only decode, not a full pass.
    params = BuildParams(n_samples=min(n // 2, 50_000))

    ct = GreedyGD(device=dev).compress(data)
    ratio = ct.raw_size_bytes() / ct.size_bytes()

    build_pairwise_hist(ct, cols, params, device=dev)       # warm
    t0 = time.perf_counter()
    syn = build_pairwise_hist(ct, cols, params, device=dev)
    t_ct = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_pairwise_hist(data, cols, params,
                        seed_edges=GreedyGD.seed_edges(ct), device=dev)
    t_raw = time.perf_counter() - t0

    blob = storage.encode(syn)
    cold = ColdTable(blob, compressed=ct, device=dev)
    cold.published                                   # first access: decode
    decode_ms = cold.timings["cold_decode_s"] * 1e3

    out["gd"] = {
        "n": n, "d": d,
        "synopsis_bytes": len(blob),
        "compression_ratio": ratio,
        "cold_start_decode_ms": decode_ms,
        "table_bytes_raw": ct.raw_size_bytes(),
        "table_bytes_compressed": ct.size_bytes(),
        "rows_decoded": syn.build_stats["rows_decoded"],
        "build_from_compressed_s": t_ct,
        "build_raw_s": t_raw,
    }
    emit(rows, "construction/gd_compression", None,
         f"{ratio:.2f}x ({ct.raw_size_bytes()} -> {ct.size_bytes()}B)")
    emit(rows, "construction/gd_build", t_ct * 1e6,
         f"{syn.build_stats['rows_decoded']}/{n} rows decoded; "
         f"raw build {t_raw * 1e3:.0f} ms")
    emit(rows, "construction/gd_cold_start", decode_ms * 1e3,
         f"{len(blob)}B synopsis, {decode_ms:.1f} ms decode")


def _run_full_build(rows: list, out: dict, sizes: dict, rng, dev):
    """Algorithm 1/2 as printed (recursive NumPy) vs the level-synchronous
    build on ``dev``."""
    n, d = sizes["full_build"]
    data = np.stack([np.round(np.abs(rng.normal(100 * (i + 1), 20 + 10 * i,
                                                n))) for i in range(d)], 1)
    crit = chi2lib.build_crit_table(0.001, 128)
    m_pts = n // 100

    t0 = time.perf_counter()
    edges_1d = {}
    for i in range(d):
        x = data[:, i]
        init = np.array([x.min(), x.max()])
        edges_1d[i], _, _, _, _ = ref_sequential.build_1d_sequential(
            x, init, m_pts, crit)
    for i in range(d):
        for j in range(i):
            ref_sequential.build_2d_sequential(
                data[:, j], data[:, i], edges_1d[j], edges_1d[i], m_pts, crit,
                s_max=32)
    t_seq = time.perf_counter() - t0

    cols = _cols(d)
    params = BuildParams(n_samples=n)
    build_pairwise_hist(data, cols, params, device=dev)      # warm
    t0 = time.perf_counter()
    build_pairwise_hist(data, cols, params, device=dev)
    t_vec = time.perf_counter() - t0

    out["full_build"] = {"n": n, "d": d, "sequential_s": t_seq,
                         "vectorized_s": t_vec, "speedup": t_seq / t_vec}
    emit(rows, "construction/sequential_alg1", t_seq * 1e6, "paper-faithful")
    emit(rows, "construction/levelsync", t_vec * 1e6,
         f"{t_seq / t_vec:.2f}x vs sequential")


def _run_pair_phase(rows: list, out: dict, sizes: dict, rng, dev):
    """The pair phase on the mixed table: per-pair loop vs compacting."""
    n, d = sizes["pair_phase"]
    repeats = sizes["repeats"]
    data = _pair_phase_data(n, d, rng)
    cols = _cols(d)
    n_pairs = d * (d - 1) // 2
    p_loop = BuildParams(n_samples=n, pair_batched=False)
    p_batched = dataclasses.replace(p_loop, pair_batched=True)

    t_loop, _, s_loop = _timed_pair_phase(data, cols, p_loop, repeats, dev)
    t_batched, bstats, s_batched = _timed_pair_phase(data, cols, p_batched,
                                                     repeats, dev)
    _assert_pairs_equal(s_loop, s_batched)

    speedup = t_loop / t_batched
    out["pair_phase"] = {
        "n": n, "d": d, "n_pairs": n_pairs,
        "per_pair_loop_s": t_loop, "batched_s": t_batched,
        "speedup": speedup,
        "pairs_per_s_loop": n_pairs / t_loop,
        "pairs_per_s_batched": n_pairs / t_batched,
        "compact_launches": [list(x) for x in bstats["pair_launches"]],
        "bitforbit_equal": True,
    }
    emit(rows, "construction/pair_loop", t_loop * 1e6,
         f"{n_pairs / t_loop:.1f} pairs/s")
    emit(rows, "construction/pair_batched", t_batched * 1e6,
         f"{n_pairs / t_batched:.1f} pairs/s; {speedup:.2f}x vs loop")


def run(rows: list, quick: bool = False, device=None, out_dir=None,
        correlated_only: bool = False, trace: bool = False) -> dict:
    dev = resolve_device(device)
    out_dir = Path(RESULTS_DIR if out_dir is None else out_dir)
    sizes = QUICK if quick else FULL
    rng = np.random.default_rng(3)
    out: dict = {"quick": quick}
    if not correlated_only:
        _run_full_build(rows, out, sizes, rng, dev)
        _run_pair_phase(rows, out, sizes, rng, dev)
    _run_correlated(rows, out, sizes, rng, dev)
    if trace:
        _trace_build(rows, out, sizes, rng, dev, out_dir)
    _run_gd(rows, out, sizes, rng, dev)
    save_json("construction", out, dev, out_dir)
    return out
