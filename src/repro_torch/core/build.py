"""BuildPairwiseHist (Algorithm 1) on torch tensors.

Pipeline (the reference package's, step for step):
  1. downsample the (pre-processed, integer-domain) dataset to N_s rows,
     drawing row indices with numpy's ``default_rng(params.seed)``;
  2. all columns at once: one host ``np.sort(axis=0)`` + vectorized
     unique-prefix, then ``refine.refine_1d`` with the columns as a batch
     dimension on the device;
  3. pair histograms under one of two schedulers (``BuildParams``),
     bit-for-bit equal to each other:
       * convergence-compacting (the default; ``build_pairs_compact`` /
         ``refine.refine_2d_compact``): the sample's columns are uploaded
         once, per-column ranks are shared across pairs
         (``refine.column_ranks``), a group of pairs is gathered and
         presorted on the device (``refine.presort_pairs``), ``pair_chunk``
         slots refine it with drain/backfill on the host, and
         capacity-guard escalation re-queues only the capped pairs one
         rung up the k2 ladder. It counts through
         ``repro_torch.kernels.hist2d`` and ``repro_torch.kernels.subbin``
         — CUDA kernels when the build runs on the card;
       * per pair (``pair_batched=False``; ``build_pairs_sequential`` /
         ``refine.refine_2d``): the reference's oracle and benchmark
         baseline, one pair and one host check a round at a time;
  4. the 1-D grids are refined to the union of their pairs' edges and the
     fold maps are computed (host NumPy + one batched metadata call).

Missing values (NaN) are excluded per-histogram, as in SQL. The result is
bit-for-bit the reference's synopsis for the same input and parameters.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import chi2 as chi2lib
from repro_torch.core import refine
from repro_torch.core.types import (BuildParams, ColumnInfo, Hist1D, PairHist,
                                    PairwiseHist)
from repro_torch.device import resolve_device
from repro_torch.gd.greedygd import CompressedTable, GreedyGD, decompress_rows
from repro_torch.obs.timeline import BuildTimeline, to_device, to_host

# The timeline of a scheduler called without one: records nothing.
_NO_TIMELINE = BuildTimeline(enabled=False)


def _prep_columns(sample: np.ndarray):
    """Sort all columns at once with NaN (missing) pushed to +inf at the tail.

    Returns (xs_all (d, N), uprefix_all (d, N+1), n_valid (d,), vmin (d,),
    vmax (d,)).
    """
    x = np.asarray(sample, np.float64).copy()
    n, d = x.shape
    nan = np.isnan(x)
    x[nan] = np.inf
    xs = np.sort(x, axis=0)                       # (N, d)
    n_valid = (n - nan.sum(axis=0)).astype(np.int64)
    new = np.empty((n, d), bool)
    new[0] = True
    new[1:] = xs[1:] != xs[:-1]
    up = np.zeros((n + 1, d), np.int64)
    np.cumsum(new, axis=0, out=up[1:])
    has = n_valid > 0
    vmin = np.where(has, xs[0], 0.0)
    vmax = np.where(has, xs[np.maximum(n_valid - 1, 0), np.arange(d)], 0.0)
    return (np.ascontiguousarray(xs.T), np.ascontiguousarray(up.T),
            n_valid, vmin, vmax)


def fold_to_rows(edges_1d: np.ndarray, edges_pair: np.ndarray) -> np.ndarray:
    """Map each 1-D (union-grid) bin to the pair row containing it.

    Pair edges are a subset of the union grid, so containment is exact.
    """
    mids = 0.5 * (edges_1d[:-1] + edges_1d[1:])
    idx = np.searchsorted(edges_pair, mids, side="right") - 1
    return np.clip(idx, 0, max(edges_pair.size - 2, 0)).astype(np.int32)


def _init_edges(vmin: float, vmax: float, cap: int, n_take: int,
                seed_edges=None) -> tuple[np.ndarray, int]:
    """Initial bin edges: GD bases (downsampled to ceil(N_s/M)) or min/max."""
    if seed_edges is not None and len(seed_edges) > 2:
        e = np.unique(np.asarray(seed_edges, np.float64))
        e = e[(e > vmin) & (e < vmax)]
        if e.size > max(n_take - 2, 0):
            idx = np.linspace(0, e.size - 1, max(n_take - 2, 0)).round().astype(int)
            e = e[np.unique(idx)] if idx.size else e[:0]
        edges = np.concatenate([[vmin], e, [vmax]])
    else:
        edges = np.array([vmin, vmax], np.float64)
    edges = np.unique(edges)
    if edges.size == 1:  # constant column: single zero-width bin
        edges = np.array([edges[0], edges[0]], np.float64)
    edges = edges[: cap + 1]
    n_bins = edges.size - 1
    out = np.full(cap + 1, np.inf, np.float64)
    out[: edges.size] = edges
    return out, n_bins


def _pad_edges(e: np.ndarray, cap: int) -> np.ndarray:
    out = np.full(cap + 1, np.inf, np.float64)
    out[: min(e.size, cap + 1)] = e[: cap + 1]
    return out


def _pair_keys(d: int) -> list[tuple[int, int]]:
    """Pair keys (a, b), a < b, in the reference's emission order."""
    return [(j, i) for i in range(1, d) for j in range(i)]


def _trim_pair(ex, ey, kx, ky, H, hx, ux, vminx, vmaxx, hy, uy, vminy,
               vmaxy) -> PairHist:
    """Trim one pair's fixed-capacity (host) arrays to its valid bins."""
    nkx, nky = int(kx), int(ky)
    return PairHist(
        ex=ex[: nkx + 1].copy(), ey=ey[: nky + 1].copy(),
        kx=np.int32(nkx), ky=np.int32(nky),
        H=H[:nkx, :nky].copy(),
        hx=hx[:nkx].copy(), ux=ux[:nkx].copy(),
        vminx=vminx[:nkx].copy(), vmaxx=vmaxx[:nkx].copy(),
        hy=hy[:nky].copy(), uy=uy[:nky].copy(),
        vminy=vminy[:nky].copy(), vmaxy=vmaxy[:nky].copy(),
        fold_x=np.zeros(0, np.int32), fold_y=np.zeros(0, np.int32),
    )


def build_pairs_sequential(sample: np.ndarray, hists: list, params, crit2,
                           m_pts: int, device) -> dict:
    """Per-pair host loop: ``refine.refine_2d`` and ``refine.pair_metadata``
    on one pair after another, at capacity ``k2_cap``, with one host check
    a round and one transfer a pair.

    The compacting scheduler's bit-for-bit oracle and the benchmarks'
    baseline. Returns {(a, b): PairHist} without fold maps.
    """
    K2 = params.k2_cap
    cols = to_device(np.ascontiguousarray(np.nan_to_num(sample, nan=0.0).T),
                     device, torch.float64)
    nanmask = np.isnan(sample)
    raw_pairs = {}
    for a, b in _pair_keys(sample.shape[1]):
        valid = to_device(~(nanmask[:, a] | nanmask[:, b]), device)
        ex0 = to_device(_pad_edges(hists[a].edges, K2), device)
        ey0 = to_device(_pad_edges(hists[b].edges, K2), device)
        ex, ey, kx, ky = refine.refine_2d(
            cols[a], cols[b], valid, ex0, ey0, min(int(hists[a].k), K2),
            min(int(hists[b].k), K2), float(m_pts), crit2, k2=K2,
            s_max=params.s2_max, max_rounds=params.max_rounds_2d)
        out = refine.pair_metadata(cols[a], cols[b], valid, ex, ey, kx, ky,
                                   k2=K2)
        raw_pairs[(a, b)] = _trim_pair(
            to_host(ex).numpy(), to_host(ey).numpy(), kx, ky,
            *(to_host(v).numpy() for v in out))
    return raw_pairs


def _column_ranks(sample_nn: np.ndarray) -> np.ndarray:
    """Per-column dense ranks (d, N): ties share a rank, order preserved.

    One sort + one searchsorted *per column*. The host oracle of
    ``refine.column_ranks``, which the build runs on the device; tests use
    it to make ``_presort_pairs_host``'s rank rows and expected values.
    """
    n, d = sample_nn.shape
    xs = np.sort(sample_nn, axis=0)
    ranks = np.empty((d, n), np.int64)
    for i in range(d):
        ranks[i] = np.searchsorted(xs[:, i], sample_nn[:, i], side="left")
    return ranks


def _presort_pairs_host(x, y, valid, rx=None, ry=None):
    """Per-pair presorts in (x, y) and (y, x) order, with run-start flags.

    x/y/valid: (P, N). Returns xo1/yo1/vo1/new1 (values, validity and
    x-run starts in (x, y) order) and xo2/yo2/vo2/new2 (the same in (y, x)
    order); invalid rows sort to the tail. With ``rx``/``ry`` (rows of
    ``_column_ranks``) each order is one stable argsort of the composite
    integer key ``rank_primary * (N+1) + rank_secondary``, which gives the
    same permutation as the two-key float lexsort.

    The host oracle of ``refine.presort_pairs``, which the build runs on
    the device (``_presort_group``); tests use it to make the compacting
    scheduler's presorted inputs and to hold the device presort to, bit
    for bit.
    """
    n_pairs, n = x.shape
    xo1 = np.empty_like(x)
    yo1 = np.empty_like(y)
    vo1 = np.empty_like(valid)
    xo2 = np.empty_like(x)
    yo2 = np.empty_like(y)
    vo2 = np.empty_like(valid)
    big = np.int64(n + 1) * np.int64(n + 1)
    for p in range(n_pairs):
        if rx is None:
            kx = np.where(valid[p], x[p], np.inf)
            ky = np.where(valid[p], y[p], np.inf)
            o1 = np.lexsort((ky, kx))
            o2 = np.lexsort((kx, ky))
        else:
            key1 = np.where(valid[p], rx[p] * np.int64(n + 1) + ry[p], big)
            key2 = np.where(valid[p], ry[p] * np.int64(n + 1) + rx[p], big)
            o1 = np.argsort(key1, kind="stable")
            o2 = np.argsort(key2, kind="stable")
        xo1[p], yo1[p], vo1[p] = x[p][o1], y[p][o1], valid[p][o1]
        xo2[p], yo2[p], vo2[p] = x[p][o2], y[p][o2], valid[p][o2]
    new1 = np.empty((n_pairs, n), bool)
    new1[:, 0] = True
    new1[:, 1:] = xo1[:, 1:] != xo1[:, :-1]
    new2 = np.empty((n_pairs, n), bool)
    new2[:, 0] = True
    new2[:, 1:] = yo2[:, 1:] != yo2[:, :-1]
    return xo1, yo1, vo1, new1, xo2, yo2, vo2, new2


def _upload_sample(sample: np.ndarray, device, tl: BuildTimeline):
    """The compacting scheduler's presort inputs, once a build: the sample's
    columns (d, N) f64 with NaN as 0.0 and their (d, N) NaN mask in one
    ``pair_upload`` span, then the column ranks on the device in a
    ``pair_presort`` span of no pairs (``presort_ranks``)."""
    with tl.phase("pair_upload", d=sample.shape[1]):
        cols = to_device(
            np.ascontiguousarray(np.nan_to_num(sample, nan=0.0).T), device,
            torch.float64)
        nanm = to_device(np.ascontiguousarray(np.isnan(sample).T), device)
    with tl.phase("pair_presort", pairs=0):
        with tl.phase("presort_ranks", wait=device):
            ranks = refine.column_ranks(cols)
    return cols, nanm, ranks


def _presort_group(part, cols, nanm, ranks, device,
                   tl: BuildTimeline) -> tuple:
    """One group's presort on the device, ``_presort_pairs_host``'s eight
    (len(part), N) arrays for the pairs ``part``. ``presort_gather``
    uploads the pairs' column indices and gathers x, y, their ranks and
    validity; ``presort_sort`` sorts the composite rank keys
    (``refine.presort_pairs``)."""
    with tl.phase("presort_gather", wait=device):
        a = to_device([ab[0] for ab in part], device, torch.int64)
        b = to_device([ab[1] for ab in part], device, torch.int64)
        x, y, rx, ry = cols[a], cols[b], ranks[a], ranks[b]
        valid = ~(nanm[a] | nanm[b])
    with tl.phase("presort_sort", wait=device):
        tl.count("presort_device_pairs", len(part))
        return refine.presort_pairs(x, y, valid, rx, ry)


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1): the slot-count rule (rounding
    DOWN honours the ``pair_chunk`` memory ceiling)."""
    return 1 << (max(1, n).bit_length() - 1)


def _cap_ladder(k2_start: int, k2_cap: int) -> list[int]:
    """Doubling capacity ladder k2_start, 2*k2_start, ..., k2_cap."""
    c = min(max(2, k2_start), k2_cap)
    ladder = [c]
    while c < k2_cap:
        c = min(c * 2, k2_cap)
        ladder.append(c)
    return ladder


# Pairs uploaded to the device per group, in units of the slot count: the
# compaction horizon and the (group * N) presort-upload memory bound.
_COMPACT_QUEUE = 4


def _stack_edges(rows, cap: int, device) -> torch.Tensor:
    return to_device(np.stack([_pad_edges(e, cap) for e in rows]), device,
                     torch.float64)


def build_pairs_compact(sample: np.ndarray, hists: list, params, crit2,
                        m_pts: int, device, stats: dict | None = None,
                        timeline: BuildTimeline | None = None) -> dict:
    """Convergence-compacting 2-D construction. Returns {(a, b): PairHist}
    without fold maps.

    Pairs go to the device in groups of up to ``_COMPACT_QUEUE`` slot
    counts. Each pair starts at the smallest k2 rung that fits its initial
    grids; a pair whose capacity guard binds on a lower rung is drained,
    discarded and re-queued one rung up. Pairs that finished at the same
    capacity share one ``pair_metadata_batch`` call. ``stats`` receives the
    launch shapes and the round ledger (rounds, pair-rounds, the
    slot-rounds its launches' slot counts could have run, and rounds by
    active-slot count in ``occupancy_hist``); a ``timeline`` gets one
    ``compact_launch`` span per rung and a ``rung_escalation`` marker when
    pairs move up, the ``pair_upload`` of the sample's columns and the
    ``pair_presort`` span of the column ranks (``presort_ranks``) once, and,
    per group, a ``pair_presort`` (its ``presort_gather`` and
    ``presort_sort``) and a ``pair_metadata`` span (the metadata launches,
    their transfers and the trim).
    """
    tl = timeline or _NO_TIMELINE
    K2 = params.k2_cap
    d = sample.shape[1]
    keys = _pair_keys(d)
    cols, nanm, ranks = _upload_sample(sample, device, tl)
    slots = _pow2_floor(int(params.pair_chunk))
    group_cap = slots * _COMPACT_QUEUE
    launches = []
    comp = {"loop_rounds": 0, "pair_rounds": 0, "slot_rounds": 0,
            "escalated_pairs": 0, "occupancy_hist": {}}
    raw_pairs = {}

    for start in range(0, len(keys), group_cap):
        part = keys[start:start + group_cap]
        g = len(part)
        kx0g = np.array([min(int(hists[a].k), K2) for a, _ in part],
                        np.int64)
        ky0g = np.array([min(int(hists[b].k), K2) for _, b in part],
                        np.int64)
        with tl.phase("pair_presort", pairs=g):
            pres = _presort_group(part, cols, nanm, ranks, device, tl)

        ladder = _cap_ladder(params.k2_start, K2)
        queue: dict[int, list] = {}
        for gid in range(g):
            need = max(int(kx0g[gid]), int(ky0g[gid]))
            cap = next(c for c in ladder if c >= need or c == K2)
            queue.setdefault(cap, []).append(gid)
        final: dict[int, tuple] = {}  # gid -> (cap, ex, ey, kx, ky)
        for rung_i, cap in enumerate(ladder):
            pend = queue.pop(cap, [])
            if not pend:
                continue
            drain_capped = cap < K2
            n_slots = min(slots, len(pend))
            with tl.phase("compact_launch", cap=cap, slots=n_slots,
                          pairs=len(pend)) as span:
                idx = to_device(pend, device, torch.int64)
                ledger = {"loop_rounds": 0, "pair_rounds": 0,
                          "occupancy_hist": comp["occupancy_hist"]}
                oex, oey, okx, oky, ocap, _ornd = refine.refine_2d_compact(
                    tuple(arr[idx] for arr in pres),
                    _stack_edges([hists[part[gid][0]].edges for gid in pend],
                                 cap, device),
                    _stack_edges([hists[part[gid][1]].edges for gid in pend],
                                 cap, device),
                    to_device(kx0g[pend], device),
                    to_device(ky0g[pend], device),
                    float(m_pts), crit2, n_slots=n_slots, k2=cap,
                    s_max=params.s2_max, max_rounds=params.max_rounds_2d,
                    drain_capped=drain_capped, stats=ledger)
                oex_h = to_host(oex).numpy()
                oey_h = to_host(oey).numpy()
                launches.append((n_slots, cap))
                comp["loop_rounds"] += ledger["loop_rounds"]
                comp["pair_rounds"] += ledger["pair_rounds"]
                comp["slot_rounds"] += ledger["loop_rounds"] * n_slots
                escalated = 0
                for p, gid in enumerate(pend):
                    if drain_capped and ocap[p]:
                        queue.setdefault(ladder[rung_i + 1], []).append(gid)
                        escalated += 1
                    else:
                        final[gid] = (cap, oex_h[p], oey_h[p], okx[p],
                                      oky[p])
                comp["escalated_pairs"] += escalated
                span.update(escalated=escalated,
                            loop_rounds=ledger["loop_rounds"],
                            pair_rounds=ledger["pair_rounds"])
            if escalated:
                tl.event("rung_escalation", from_cap=cap,
                         to_cap=ladder[rung_i + 1], pairs=escalated)

        # Metadata per rung (pairs that finished at the same capacity share
        # one launch; the trim is capacity-independent).
        with tl.phase("pair_metadata", pairs=g) as span:
            by_cap: dict[int, list] = {}
            for gid, (cap, *_rest) in final.items():
                by_cap.setdefault(cap, []).append(gid)
            for cap, gids in sorted(by_cap.items()):
                idx = to_device(gids, device, torch.int64)
                ex_m = np.stack([final[gid][1] for gid in gids])
                ey_m = np.stack([final[gid][2] for gid in gids])
                kx_m = np.array([final[gid][3] for gid in gids], np.int64)
                ky_m = np.array([final[gid][4] for gid in gids], np.int64)
                meta = refine.pair_metadata_batch(
                    *(arr[idx] for arr in pres),
                    to_device(ex_m, device), to_device(ey_m, device),
                    to_device(kx_m, device), to_device(ky_m, device), k2=cap)
                meta_h = [to_host(v).numpy() for v in meta]
                for p, gid in enumerate(gids):
                    raw_pairs[part[gid]] = _trim_pair(
                        ex_m[p], ey_m[p], kx_m[p], ky_m[p],
                        *(v[p] for v in meta_h))
            span["launches"] = len(by_cap)
        del pres  # before the next group's presort is made
    if stats is not None:
        stats["pair_launches"] = launches
        stats["compaction"] = comp
    return raw_pairs


def _hists_from_host(edges, k, h, u, vmin, vmax, c, cm, cp) -> list:
    """Trim batched (d, K) host arrays into per-column ``Hist1D``s."""
    out = []
    for i in range(edges.shape[0]):
        ki = int(k[i])
        out.append(Hist1D(
            edges=edges[i, : ki + 1].copy(), k=np.int32(ki),
            h=h[i, :ki].copy(), u=u[i, :ki].copy(),
            vmin=vmin[i, :ki].copy(), vmax=vmax[i, :ki].copy(),
            c=c[i, :ki].copy(), cminus=cm[i, :ki].copy(),
            cplus=cp[i, :ki].copy()))
    return out


def build_pairwise_hist(
    data: np.ndarray,
    columns: list[ColumnInfo],
    params: BuildParams | None = None,
    n_rows_full: int | None = None,
    seed_edges: list | None = None,
    device=None,
) -> PairwiseHist:
    """Construct the synopsis from a pre-processed (N, d) float64 matrix.

    ``data`` is in the *pre-processed* (GD) domain: non-negative integers as
    f64, NaN for missing — or a ``CompressedTable``, in which case only the
    N_s sampled rows are decoded and, unless ``seed_edges`` are given, the
    1-D edges are seeded from the deduplicated bases (§3). ``seed_edges``
    (optional) are per-column initial edge candidates. ``n_rows_full`` is N
    of the complete dataset when ``data`` is itself a sample.

    ``params.pair_batched`` picks the pair scheduler
    (``build_stats["mode"]``: ``"compact"`` or ``"sequential"``); both give
    the same synopsis.
    ``device=None`` builds on the CUDA device (and raises without one);
    ``device="cpu"`` runs the same code with the kernels' plain versions.
    The input ``columns`` list is left untouched; the returned synopsis
    carries copies with per-column null counts filled in.
    """
    params = params or BuildParams()
    dev = resolve_device(device)
    ct = data if isinstance(data, CompressedTable) else None
    timeline = BuildTimeline()
    if ct is not None:
        n_input = ct.n_rows
        d = ct.d
        if seed_edges is None:
            with timeline.phase("seed_edges", d=d):
                seed_edges = GreedyGD.seed_edges(ct)
    else:
        data = np.asarray(data, np.float64)
        n_input = int(data.shape[0])
        d = data.shape[1]
    n_total = n_input if n_rows_full is None else int(n_rows_full)
    if len(columns) != d:
        raise ValueError("columns metadata must match data width")

    def f64(a):
        return to_device(a, dev, torch.float64)

    def i64(a):
        return to_device(a, dev, torch.int64)

    # --- 1. sample ---------------------------------------------------------
    with timeline.phase("sample", n_rows=n_input, d=d):
        n_s = min(params.n_samples, n_input)
        if n_s < n_input:
            rng = np.random.default_rng(params.seed)
            rows = rng.choice(n_input, size=n_s, replace=False)
        else:
            rows = None
        if ct is not None:
            with timeline.phase("decompress_rows", rows=n_s):
                sample = decompress_rows(ct, rows)
        else:
            sample = data if rows is None else data[rows]
        m_pts = max(2, int(round(params.m_frac * n_s)))
        n_take = max(2, math.ceil(n_s / m_pts))
        s_max = max(params.s1_max, params.s2_max)
        with timeline.phase("crit_table", s_max=s_max):
            crit_np = chi2lib.build_crit_table(params.alpha, s_max)
            crit = f64(crit_np)
        crit1 = crit[: params.s1_max + 1]
        crit2 = crit[: params.s2_max + 1]

    # --- 2. one-dimensional histograms (columns as a batch dimension) ------
    K1 = params.k1_cap
    with timeline.phase("refine_1d", d=d):
        xs_all, up_all, nv_all, vmin_all, vmax_all = _prep_columns(sample)
        columns = [dataclasses.replace(c, n_null=int(n_s - nv_all[i]))
                   for i, c in enumerate(columns)]
        e0_all = np.empty((d, K1 + 1), np.float64)
        n0_all = np.empty((d,), np.int64)
        mu_all = np.array([c.mu for c in columns], np.float64)
        for i in range(d):
            seed = None if seed_edges is None else seed_edges[i]
            if columns[i].kind == "categorical" and \
                    0 < len(columns[i].categories) <= max(n_take, 4):
                # One bin per category (see the reference's build.py).
                seed = np.arange(len(columns[i].categories) - 1) + 0.5
            e0_all[i], n0_all[i] = _init_edges(vmin_all[i], vmax_all[i], K1,
                                               n_take, seed)
        xs_t, up_t, mu_t = f64(xs_all), i64(up_all), f64(mu_all)
        edges_t, k_t = refine.refine_1d(
            xs_t, up_t, f64(e0_all), i64(n0_all), float(m_pts), crit1,
            s_max=params.s1_max, max_rounds=params.max_rounds_1d)
        meta = refine.metadata_1d(xs_t, up_t, edges_t, k_t, float(m_pts),
                                  crit1, mu_t, s_max=params.s1_max)
        hists = _hists_from_host(to_host(edges_t).numpy(),
                                 to_host(k_t).numpy(),
                                 *(to_host(v).numpy() for v in meta))

    # --- 3. pair histograms (batched across pairs) -------------------------
    build_stats: dict = {}
    with timeline.phase("pair_phase") as pair_span:
        if params.pair_batched:
            mode = "compact"
            raw_pairs = build_pairs_compact(sample, hists, params, crit2,
                                            m_pts, dev, stats=build_stats,
                                            timeline=timeline)
        else:
            mode = "sequential"
            raw_pairs = build_pairs_sequential(sample, hists, params, crit2,
                                               m_pts, dev)
    build_stats.update({
        "mode": mode,
        "n_pairs": len(raw_pairs),
        "pair_phase_s": pair_span["t1"] - pair_span["t0"],
        "pair_chunk": params.pair_chunk,
        "from_compressed": ct is not None,
        "device": str(dev),
    })
    if ct is not None:
        build_stats["rows_decoded"] = int(n_s)

    # --- 4. refine 1-D grids to the union of their pairs' edge sets --------
    # Aggregation runs on the 1-D grid (Table 3); the union grid preserves
    # the 2-D refinement. Fold maps: 1-D bin -> containing pair row.
    with timeline.phase("union_regrid", d=d):
        e_pad = np.full((d, K1 + 1), np.inf)
        k_u = np.empty(d, np.int64)
        for i in range(d):
            union = [hists[i].edges]
            for (a, b), pr in raw_pairs.items():
                if a == i:
                    union.append(pr.ex)
                elif b == i:
                    union.append(pr.ey)
            edges_u = np.unique(np.concatenate(union))
            edges_u = edges_u[np.isfinite(edges_u)]
            # Capacity: thin uniformly, keep the extremes.
            if edges_u.size > K1 + 1:
                idx = np.linspace(0, edges_u.size - 1,
                                  K1 + 1).round().astype(int)
                edges_u = edges_u[np.unique(idx)]
            e_pad[i, : edges_u.size] = edges_u
            k_u[i] = edges_u.size - 1
        meta = refine.metadata_1d(xs_t, up_t, f64(e_pad), i64(k_u),
                                  float(m_pts), crit1, mu_t,
                                  s_max=params.s1_max)
        hists = _hists_from_host(e_pad, k_u,
                                 *(to_host(v).numpy() for v in meta))

    pairs: dict[tuple[int, int], PairHist] = {}
    with timeline.phase("folds", n_pairs=len(raw_pairs)):
        for (a, b), pr in raw_pairs.items():
            pairs[(a, b)] = pr._replace(
                fold_x=fold_to_rows(hists[a].edges, pr.ex),
                fold_y=fold_to_rows(hists[b].edges, pr.ey))

    build_stats["timeline"] = timeline.events
    build_stats["phase_s"] = timeline.summary()
    build_stats["counts"] = timeline.counts()
    build_stats["count_totals"] = timeline.totals()

    return PairwiseHist(
        params=params,
        n_rows=n_total,
        n_sampled=n_s,
        columns=columns,
        hists=hists,
        pairs=pairs,
        chi2_table=crit_np,
        build_stats=build_stats,
    )
