"""Level-synchronous histogram refinement (Alg. 1 + 2) on torch tensors.

The paper's ``RefineBin1D``/``RefineBin2D`` are data-dependent recursions.
As in the reference package, *every* bin of a histogram refines at once per
round over fixed-capacity, +inf-padded edge buffers:

  round:  (1) vectorized per-bin statistics (count, unique count, chi-squared
              over Terrell–Scott sub-bins) via batched ``searchsorted``;
          (2) every bin failing the uniformity test inserts its midpoint;
          (3) edges <- sort(concat(edges, midpoints))[:capacity].

The reference's ``lax.while_loop``s become Python loops with one host check
per round; its ``vmap``s become an explicit leading batch dimension (columns
in 1-D, pairs in 2-D). Every per-bin value is computed by the same
floating-point operations in the same order as the reference, and all
counts are exact integers, so the results are bit-for-bit the reference's.

2-D refinement has two schedulers, bit-for-bit equal:

  * ``refine_2d`` / ``pair_metadata`` — one pair at a time, its segment
    sums as plain torch scatters (``index_add_``, ``scatter_reduce``) and
    one host check of the split count a round: the reference's oracle and
    the benchmarks' per-pair loop;
  * ``refine_2d_compact`` / ``pair_metadata_batch`` —
    convergence-compacting: a slot set of presorted pairs
    (``presort_pairs``) over a pending queue, draining and backfilling on
    the host. Its rounds (``_round_2d_batch``) count per-cell unique
    values through ``repro_torch.kernels.hist2d.batched_hist2d`` and
    chi-squared sub-bins through ``repro_torch.kernels.subbin`` (via
    ``chi2.subbin_counts``) — hand-written CUDA kernels for CUDA tensors.

Both share the split selection (``_split_2d_batch``) and the chi-squared
tail (``_chi2_from_hbar_b``).
"""
from __future__ import annotations

import torch

from repro_torch.core import chi2 as chi2lib
from repro_torch.kernels.hist2d import batched_hist2d
from repro_torch.obs.timeline import to_device, to_host

_INF = float("inf")


def _clip(x, lo, hi):
    """``jnp.clip`` of a tensor to host numbers: min(max(x, lo), hi)."""
    lo = to_device(lo, x.device, x.dtype)
    hi = to_device(hi, x.device, x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


def _full_like(x, value):
    return torch.full((), value, dtype=x.dtype, device=x.device)


# The reference's compiler (XLA on the CPU) contracts a product feeding an
# addition into one fused multiply-add where both sit in one fused loop: the
# chi-squared sub-bin edges and the weighted-centre bounds are rounded once,
# not twice. PyTorch runs each operation on its own, so ``_fma`` rebuilds the
# single rounding from error-free transformations (Dekker's product, Knuth's
# sum) in f64 elementwise operations, which round the same on CPU and GPU.
# It is exact except when a*b + c lies within 2^-106 relative of a rounding
# boundary. Non-finite results fall back to the plain expression.

_SPLITTER = 134217729.0  # 2^27 + 1


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def _fma(a, b, c):
    """a * b + c rounded once (f64 tensors, broadcasting)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl   # a*b == p + err
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)                          # p + c == s + t
    out = s + (t + err)
    return torch.where(torch.isfinite(out), out, p + c)


def _sum_last(x):
    """Sum over the last axis in index order, from 0.0 — the order of the
    reference's row reductions, so f64 sums round identically."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


# ---------------------------------------------------------------------------
# Shared vectorized bin statistics (1-D, batched over columns)
# ---------------------------------------------------------------------------


def bin_stats_1d(xs, uprefix, edges, k):
    """Per-bin (count, unique, vmin, vmax, lo_idx, hi_idx) from sorted data.

    xs:      (D, N) f64 sorted ascending per row; invalid entries (+inf) last.
    uprefix: (D, N+1) int64, uprefix[:, n] = distinct values among xs[:, :n].
    edges:   (D, K+1) f64 sorted, +inf padded.
    k:       (D,) int64 number of valid bins.
    """
    K = edges.shape[1] - 1
    n = xs.shape[1]
    t = torch.arange(K, device=xs.device)[None, :]
    left = torch.searchsorted(xs, edges, right=False)     # (D, K+1)
    right = torch.searchsorted(xs, edges, right=True)
    lo = left[:, :-1]
    # Standard histogram convention: all bins half-open, last valid bin closed.
    hi = torch.where(t == k[:, None] - 1, right[:, 1:], left[:, 1:])
    valid = t < k[:, None]
    lo = torch.where(valid, lo, n)
    hi = torch.where(valid, torch.maximum(hi, lo), lo)
    h = (hi - lo).to(torch.float64)
    u = (torch.gather(uprefix, 1, hi)
         - torch.gather(uprefix, 1, lo)).to(torch.float64)
    vmin = torch.gather(xs, 1, _clip(lo, 0, n - 1))
    vmax = torch.gather(xs, 1, _clip(hi - 1, 0, n - 1))
    # Empty bins keep their edges as extrema (RefineBin1D line 4).
    eL, eR = edges[:, :-1], edges[:, 1:]
    empty = h == 0
    vmin = torch.where(empty, eL, vmin)
    vmax = torch.where(empty, eR, vmax)
    return h, u, vmin, vmax, lo, hi


def chi2_stat_1d(xs, edges, k, h, u, lo, hi, s_max: int, crit_table):
    """Vectorized IsUniform over all bins of all columns: (chi2, crit, s).

    Sub-bin boundary positions come from one batched searchsorted of the
    (D, K, s_max-1) sub-edge tensor into the sorted columns.
    """
    d = xs.shape[0]
    K = edges.shape[1] - 1
    eL, eR = edges[:, :-1], edges[:, 1:]
    s = chi2lib.num_subbins(u, s_max)                              # (D, K)
    r = torch.arange(1, s_max, device=xs.device)                   # (s_max-1,)
    frac = (r.to(torch.float64)[None, None, :]
            / torch.clamp(s, min=1).to(torch.float64)[:, :, None])
    diff = eR - eL
    width = torch.where(torch.isfinite(diff), diff, _full_like(diff, 0.0))
    sub_edges = _fma(width[:, :, None], frac, eL[:, :, None])
    pos = torch.searchsorted(xs, sub_edges.reshape(d, -1), right=False)
    pos = pos.reshape(d, K, s_max - 1)
    in_range = r[None, None, :] < s[:, :, None]
    pos = torch.where(in_range, pos, hi[:, :, None])
    pos = torch.minimum(torch.maximum(pos, lo[:, :, None]), hi[:, :, None])
    bounds = torch.cat([lo[:, :, None], pos, hi[:, :, None]], dim=2)
    hbar = torch.diff(bounds, dim=2).to(torch.float64)            # (D, K, s_max)
    expect = h / torch.clamp(s.to(torch.float64), min=1.0)
    rr = torch.arange(s_max, device=xs.device)
    live = rr[None, None, :] < s[:, :, None]
    dev = hbar - expect[:, :, None]
    num = torch.where(live, dev * dev, _full_like(dev, 0.0))
    stat = _sum_last(num) / torch.clamp(expect, min=1e-30)
    crit = crit_table[_clip(s, 0, crit_table.shape[0] - 1)]
    return stat, crit, s


# ---------------------------------------------------------------------------
# 1-D refinement
# ---------------------------------------------------------------------------


def refine_1d(xs, uprefix, init_edges, n_init, min_points, crit_table,
              s_max: int = 128, max_rounds: int = 64):
    """Refine every column's histogram at once. Returns (edges, k).

    xs:         (D, N) sorted values, invalid rows = +inf at the end.
    init_edges: (D, K+1) initial edges (+inf padded), K = capacity.
    n_init:     (D,) number of valid initial bins.
    min_points: M.

    Loops while any column still splits (at most ``max_rounds``). A column
    that stopped splitting is a fixed point — another round recomputes the
    same statistics and splits nothing — so running it along with slower
    columns changes nothing, as in the reference's vmapped while_loop.
    """
    K = init_edges.shape[1] - 1
    edges = init_edges
    k = n_init.to(torch.int64)
    t = torch.arange(K, device=xs.device)[None, :]
    for _ in range(max_rounds):
        h, u, _, _, lo, hi = bin_stats_1d(xs, uprefix, edges, k)
        stat, crit, _ = chi2_stat_1d(xs, edges, k, h, u, lo, hi, s_max,
                                     crit_table)
        eL, eR = edges[:, :-1], edges[:, 1:]
        z = 0.5 * (eL + eR)
        splittable = (z > eL) & (z < eR) & torch.isfinite(z)
        split = ((t < k[:, None])
                 & (h >= min_points)      # "fewer than M tuples" -> no split
                 & (u > 1.0)              # single unique value -> no split
                 & (stat > crit)          # IsUniform -> no split
                 & splittable)
        # Capacity guard: keep at most (K - k) new edges (first-come by index).
        rank = torch.cumsum(split.to(torch.int64), dim=1) - 1
        split = split & (rank < (K - k)[:, None])
        n_split = split.sum(dim=1)
        new = torch.where(split, z, _full_like(z, _INF))
        edges = torch.sort(torch.cat([edges, new], dim=1), dim=1).values
        edges = edges[:, : K + 1].contiguous()
        k = k + n_split
        if not bool(to_host(n_split.any())):
            break
    return edges, k


def metadata_1d(xs, uprefix, edges, k, min_points, crit_table, mu,
                s_max: int = 128):
    """Final per-bin metadata for refined 1-D histograms (batched).

    Returns (h, u, vmin, vmax, c, cminus, cplus) — Eq. 10 for the centre
    bounds, midpoint c = (v+ + v-)/2. ``mu`` is (D,).
    """
    h, u, vmin, vmax, _, _ = bin_stats_1d(xs, uprefix, edges, k)
    c = 0.5 * (vmin + vmax)
    cminus, cplus = centre_bounds(h, u, vmin, vmax, min_points, crit_table,
                                  mu[:, None], s_max=s_max)
    return h, u, vmin, vmax, c, cminus, cplus


def centre_bounds(h, u, vmin, vmax, min_points, crit_table, mu, s_max: int):
    """Weighted-centre bounds (Theorem 1 / Eq. 10).

    Non-passing bins (h < M): c± = v± ∓ (u-1)u·mu / (2h).
    Passing bins:            c± = v- + (s±1)δ/2 ± (δ/6)·sqrt(3·chi2_a·(s²-1)/h).
    """
    s_i = chi2lib.num_subbins(u, s_max)
    s = s_i.to(torch.float64)
    delta = (vmax - vmin) / torch.clamp(s, min=1.0)
    crit = crit_table[_clip(s_i, 0, crit_table.shape[0] - 1)]
    crit = torch.where(torch.isfinite(crit), crit, _full_like(crit, 0.0))
    hsafe = torch.clamp(h, min=1.0)

    # delta * (1/6), not delta / 6: the reference's compiler rewrites a
    # division by a constant as a product with its reciprocal, and the two
    # round differently in the last bit. The +- spread is a fused
    # multiply-add there (see ``_fma``).
    d6 = delta * (1.0 / 6.0)
    root = torch.sqrt(3.0 * crit * (s * s - 1.0) / hsafe)
    c_lo_pass = _fma(-d6, root, vmin + (s - 1.0) * delta / 2.0)
    c_hi_pass = _fma(d6, root, vmin + (s + 1.0) * delta / 2.0)

    shift = (u - 1.0) * u * mu / (2.0 * hsafe)
    c_lo_fail = vmin + shift
    c_hi_fail = vmax - shift

    fail = h < min_points
    cminus = torch.where(fail, c_lo_fail, c_lo_pass)
    cplus = torch.where(fail, c_hi_fail, c_hi_pass)

    mid = 0.5 * (vmin + vmax)
    degenerate = u <= 1.0
    cminus = torch.where(degenerate, mid, cminus)
    cplus = torch.where(degenerate, mid, cplus)
    cminus = torch.minimum(torch.maximum(cminus, vmin), vmax)
    cplus = torch.minimum(torch.maximum(cplus, cminus), vmax)
    return cminus, cplus


# ---------------------------------------------------------------------------
# 2-D refinement, one pair at a time
# ---------------------------------------------------------------------------


def _bin_index(vals, edges, k):
    """Bin index per point under the half-open-except-last convention."""
    return _bin_index_b(vals[None], edges[None], k.reshape(1))[0]


def _segment_sum(vals, seg, num_segments: int):
    """``jax.ops.segment_sum``: f64 sums of ``vals`` by segment id."""
    out = torch.zeros(num_segments, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, seg, vals.to(torch.float64))


def _slice_unique(sort_primary, sort_value, valid, num_segments: int):
    """Unique-value counts per segment via lexsort + first-occurrence flags.

    The lexsort on (primary, value) is two stable sorts: by the value, then
    by the segment id.
    """
    order = torch.sort(sort_value, stable=True).indices
    order = order[torch.sort(sort_primary[order], stable=True).indices]
    seg = sort_primary[order]
    val = sort_value[order]
    first = torch.ones_like(valid)
    first[1:] = (seg[1:] != seg[:-1]) | (val[1:] != val[:-1])
    return _segment_sum(first & valid[order], seg, num_segments)


def _cell_chi2(vals, lo, width, cell, h_cell, u_cell, valid, k2: int,
               s_max: int, crit_table):
    """Per-cell chi-squared uniformity statistic along one dimension.

    vals/lo/width: per-point value + its cell's interval in this dimension.
    cell:          per-point flattened cell id in [0, k2*k2).
    h_cell/u_cell: per-cell totals (k2*k2,).
    The sub-bin index is ``chi2.subbin_index``, as in the batched rounds;
    the counts are a plain scatter here and the tail is
    ``_chi2_from_hbar_b``.
    """
    ncell = k2 * k2
    s = chi2lib.num_subbins(u_cell, s_max)                       # (ncell,)
    r = chi2lib.subbin_index(vals, lo, width, s[cell])
    flat = torch.where(valid, cell * s_max + r,
                       torch.full_like(r, ncell * s_max))
    hbar = _segment_sum(torch.ones_like(vals), flat, ncell * s_max + 1)
    hbar = hbar[:-1].reshape(1, ncell, s_max)
    stat, crit = _chi2_from_hbar_b(hbar, h_cell[None], s[None], s_max,
                                   crit_table)
    return stat[0], crit[0]


def refine_2d(x, y, valid, ex0, ey0, kx0: int, ky0: int, min_points,
              crit_table, *, k2: int, s_max: int = 32, max_rounds: int = 16):
    """Refine one pair histogram. Returns (ex, ey, kx, ky).

    x, y:    (N,) point coordinates (pre-processed domain); ``valid`` masks
             rows where either column is null.
    ex0/ey0: (k2+1,) initial edges = the columns' final 1-D edges (padded).
    Rounds run while the previous one split (at most ``max_rounds``); the
    host reads the split and bin counts once a round. ``kx``/``ky`` come
    back as ints, the edges as (k2+1,) tensors on the device.
    """
    ncell = k2 * k2
    dev = x.device
    ex, ey = ex0[None], ey0[None]
    kx = to_device([kx0], dev, torch.int64)
    ky = to_device([ky0], dev, torch.int64)
    kx_h, ky_h = int(kx0), int(ky0)
    ones = valid.to(torch.float64)
    for _ in range(max_rounds):
        bi = _bin_index(x, ex[0], kx)
        bj = _bin_index(y, ey[0], ky)
        cell = bi * k2 + bj
        cell_m = torch.where(valid, cell, torch.full_like(cell, ncell))
        h_cell = _segment_sum(ones, cell_m, ncell + 1)[:-1]
        ux_cell = _slice_unique(cell_m, x, valid, ncell + 1)[:-1]
        uy_cell = _slice_unique(cell_m, y, valid, ncell + 1)[:-1]

        lox = ex[0][bi]
        wx = ex[0][bi + 1] - lox
        loy = ey[0][bj]
        wy = ey[0][bj + 1] - loy
        stat_x, crit_x = _cell_chi2(x, lox, wx, cell, h_cell, ux_cell, valid,
                                    k2, s_max, crit_table)
        stat_y, crit_y = _cell_chi2(y, loy, wy, cell, h_cell, uy_cell, valid,
                                    k2, s_max, crit_table)
        ex, ey, kx, ky, n_split, _ = _split_2d_batch(
            h_cell[None], ux_cell[None], uy_cell[None], stat_x[None],
            crit_x[None], stat_y[None], crit_y[None], ex, ey, kx, ky,
            min_points, k2=k2)
        n_split_h, kx_h, ky_h = to_host(torch.cat([n_split, kx, ky])).tolist()
        if n_split_h == 0:
            break
    return ex[0], ey[0], kx_h, ky_h


def pair_metadata(x, y, valid, ex, ey, kx: int, ky: int, *, k2: int):
    """Final pair-histogram metadata (counts + per-dim slice aggregates).

    Returns (H, hx, ux, vminx, vmaxx, hy, uy, vminy, vmaxy) at capacity k2.
    Segment extrema are ``scatter_reduce`` over the valid rows; an empty
    slice takes its edges as extrema, so no sentinel survives.
    """
    ncell = k2 * k2
    dev = x.device
    kx_t = to_device([kx], dev, torch.int64)
    ky_t = to_device([ky], dev, torch.int64)
    bi = _bin_index(x, ex, kx_t)
    bj = _bin_index(y, ey, ky_t)
    cell = torch.where(valid, bi * k2 + bj, torch.full_like(bi, ncell))
    ones = valid.to(torch.float64)
    H = _segment_sum(ones, cell, ncell + 1)[:-1].reshape(k2, k2)

    big = torch.finfo(torch.float64).max
    row = torch.where(valid, bi, torch.full_like(bi, k2))
    col = torch.where(valid, bj, torch.full_like(bj, k2))

    def slice_meta(seg, vals, edges):
        hh = _segment_sum(ones, seg, k2 + 1)[:-1]
        vmin = torch.full((k2 + 1,), big, dtype=torch.float64, device=dev)
        vmin = vmin.scatter_reduce(
            0, seg, torch.where(valid, vals, _full_like(vals, big)), "amin",
            include_self=False)[:-1]
        vmax = torch.full((k2 + 1,), -big, dtype=torch.float64, device=dev)
        vmax = vmax.scatter_reduce(
            0, seg, torch.where(valid, vals, _full_like(vals, -big)), "amax",
            include_self=False)[:-1]
        uu = _slice_unique(seg, vals, valid, k2 + 1)[:-1]
        empty = hh == 0
        vmin = torch.where(empty, edges[:-1], vmin)
        vmax = torch.where(empty, edges[1:], vmax)
        return hh, uu, vmin, vmax

    hx, ux, vminx, vmaxx = slice_meta(row, x, ex)
    hy, uy, vminy, vmaxy = slice_meta(col, y, ey)
    return H, hx, ux, vminx, vmaxx, hy, uy, vminy, vmaxy


# ---------------------------------------------------------------------------
# Pair-batched 2-D refinement
# ---------------------------------------------------------------------------


def column_ranks(cols):
    """Per-column ranks (d, N) int64 of (d, N) columns without NaN: the
    number of the column's values below each value, so ties share a rank
    and the order is kept. One sort and one searchsorted for all columns;
    ``build._column_ranks`` on the device, to the integer."""
    xs = torch.sort(cols, dim=1).values
    return torch.searchsorted(xs, cols, side="left")


def presort_pairs(x, y, valid, rx, ry):
    """Per-pair presorts on the device, done once per group.

    x/y/valid: (P, N); rx/ry: their rows of ``column_ranks``. Invalid rows
    sort to the tail. Returns the points of every pair in (x, y) order and
    in (y, x) order plus run-start flags, ``build._presort_pairs_host``'s
    layout and dtypes:

      xo1/yo1/vo1/new1: values, validity and x-run starts in (x, y) order;
      xo2/yo2/vo2/new2: values, validity and y-run starts in (y, x) order.

    Each order is one stable sort of the composite key
    ``rank_primary * (N+1) + rank_secondary`` ((N+1)**2 on invalid rows),
    the host's keys, which give the permutation of the reference's two-key
    float lexsort (ties keep their row order).
    """
    n1 = x.shape[1] + 1

    def order(primary, secondary):
        key = torch.where(valid, primary * n1 + secondary, n1 * n1)
        return torch.sort(key, dim=1, stable=True).indices

    o1 = order(rx, ry)
    o2 = order(ry, rx)
    xo1, yo1, vo1 = (torch.gather(a, 1, o1) for a in (x, y, valid))
    xo2, yo2, vo2 = (torch.gather(a, 1, o2) for a in (x, y, valid))
    new1 = torch.ones_like(vo1)
    new1[:, 1:] = xo1[:, 1:] != xo1[:, :-1]
    new2 = torch.ones_like(vo2)
    new2[:, 1:] = yo2[:, 1:] != yo2[:, :-1]
    return xo1, yo1, vo1, new1, xo2, yo2, vo2, new2


def _bin_index_b(vals, edges, k):
    """(P, N) values x (P, K+1) edges -> per-point bin indices, per pair."""
    idx = torch.searchsorted(edges, vals, right=True) - 1
    return torch.minimum(torch.clamp(idx, min=0),
                         torch.clamp(k[:, None] - 1, min=0))


def _unique_flags(new_run, other_bin, valid):
    """First-occurrence flags of each (run, other-dim bin) group (f64)."""
    prev = torch.cat([other_bin[:, :1], other_bin[:, :-1]], dim=1)
    return ((new_run | (other_bin != prev)) & valid).to(torch.float64)


def _chi2_from_hbar_b(hbar, h_cell, s, s_max: int, crit_table):
    """Batched per-cell chi-squared tail: identical float ops on (P, ncell)."""
    sf = torch.clamp(s.to(torch.float64), min=1.0)
    expect = h_cell / sf
    rr = torch.arange(s_max, device=hbar.device)
    live = rr[None, None, :] < s[:, :, None]
    dev = hbar - expect[:, :, None]
    num = torch.where(live, dev * dev, _full_like(dev, 0.0))
    stat = _sum_last(num) / torch.clamp(expect, min=1e-30)
    crit = crit_table[_clip(s, 0, crit_table.shape[0] - 1)]
    return stat, crit


def _round_2d_batch(xo1, yo1, vo1, new1, xo2, yo2, vo2, new2,
                    ex, ey, kx, ky, min_points, crit_table, *,
                    k2: int, s_max: int):
    """ONE level-synchronous refinement round over P pairs.

    Inputs are the presorted per-pair arrays (``build._presort_pairs_host``
    layout: values, validity and run starts in (x, y) and (y, x) order) and
    the (P, k2+1) edges / (P,) bin counts. Per-cell statistics come from the
    batched hist2d and sub-bin kernels, then split selection, capacity guard
    and edge insertion. Returns (ex, ey, kx, ky, n_split, capped_round).
    """
    p = xo1.shape[0]
    ncell = k2 * k2
    bio1 = _bin_index_b(xo1, ex, kx)
    bjo1 = _bin_index_b(yo1, ey, ky)
    bio2 = _bin_index_b(xo2, ex, kx)
    bjo2 = _bin_index_b(yo2, ey, ky)
    cell1 = bio1 * k2 + bjo1
    cell2 = bio2 * k2 + bjo2

    ux_cell = batched_hist2d(bio1, bjo1, _unique_flags(new1, bjo1, vo1),
                             k2, k2).reshape(p, ncell)
    uy_cell = batched_hist2d(bio2, bjo2, _unique_flags(new2, bio2, vo2),
                             k2, k2).reshape(p, ncell)
    s_x = chi2lib.num_subbins(ux_cell, s_max)
    s_y = chi2lib.num_subbins(uy_cell, s_max)

    lox = torch.gather(ex, 1, bio1)
    wx = torch.gather(ex, 1, bio1 + 1) - lox
    loy = torch.gather(ey, 1, bjo2)
    wy = torch.gather(ey, 1, bjo2 + 1) - loy
    hbar_x = chi2lib.subbin_counts(xo1, lox, wx, cell1, s_x, vo1,
                                   ncell=ncell, s_max=s_max)
    hbar_y = chi2lib.subbin_counts(yo2, loy, wy, cell2, s_y, vo2,
                                   ncell=ncell, s_max=s_max)
    h_cell = torch.sum(hbar_x, dim=2)
    stat_x, crit_x = _chi2_from_hbar_b(hbar_x, h_cell, s_x, s_max, crit_table)
    stat_y, crit_y = _chi2_from_hbar_b(hbar_y, h_cell, s_y, s_max, crit_table)
    return _split_2d_batch(h_cell, ux_cell, uy_cell, stat_x, crit_x, stat_y,
                           crit_y, ex, ey, kx, ky, min_points, k2=k2)


def _split_2d_batch(h_cell, ux_cell, uy_cell, stat_x, crit_x, stat_y, crit_y,
                    ex, ey, kx, ky, min_points, *, k2: int):
    """Split selection, capacity guard and edge insertion over P pairs.

    The per-cell (P, k2*k2) counts, unique counts and chi-squared tests of
    one round in; (ex, ey, kx, ky, n_split, capped_round) out, with per-pair
    split and guard-bound flags for this round.
    """
    p = h_cell.shape[0]
    eligible = h_cell > min_points                      # Alg. 1 line 17
    fail_x = eligible & (ux_cell > 1.0) & (stat_x > crit_x)
    fail_y = eligible & (uy_cell > 1.0) & (stat_y > crit_y)
    # "split applied to the least uniform column": larger excess ratio.
    neg = _full_like(stat_x, -1.0)
    exc_x = torch.where(fail_x, stat_x / torch.clamp(crit_x, min=1e-30), neg)
    exc_y = torch.where(fail_y, stat_y / torch.clamp(crit_y, min=1e-30), neg)
    pick_x = fail_x & (~fail_y | (exc_x >= exc_y))
    pick_y = fail_y & ~pick_x

    # cell (ti, tj) -> whole row/column wants a split (Fig. 5).
    want_x = pick_x.reshape(p, k2, k2).any(dim=2)
    want_y = pick_y.reshape(p, k2, k2).any(dim=1)

    tK = torch.arange(k2, device=ex.device)[None, :]
    zx = 0.5 * (ex[:, :-1] + ex[:, 1:])
    zy = 0.5 * (ey[:, :-1] + ey[:, 1:])
    ok_x = want_x & (tK < kx[:, None]) & (zx > ex[:, :-1]) & (zx < ex[:, 1:])
    ok_y = want_y & (tK < ky[:, None]) & (zy > ey[:, :-1]) & (zy < ey[:, 1:])
    nwx = ok_x.sum(dim=1)                 # wanted, pre-guard
    nwy = ok_y.sum(dim=1)
    capped_round = (nwx > k2 - kx) | (nwy > k2 - ky)
    rank_x = torch.cumsum(ok_x.to(torch.int64), dim=1) - 1
    rank_y = torch.cumsum(ok_y.to(torch.int64), dim=1) - 1
    ok_x = ok_x & (rank_x < (k2 - kx)[:, None])
    ok_y = ok_y & (rank_y < (k2 - ky)[:, None])
    nx = ok_x.sum(dim=1)
    ny = ok_y.sum(dim=1)

    ex = torch.sort(torch.cat([ex, torch.where(ok_x, zx, _full_like(zx, _INF))],
                              dim=1), dim=1).values[:, : k2 + 1].contiguous()
    ey = torch.sort(torch.cat([ey, torch.where(ok_y, zy, _full_like(zy, _INF))],
                              dim=1), dim=1).values[:, : k2 + 1].contiguous()
    return ex, ey, kx + nx, ky + ny, nx + ny, capped_round


def refine_2d_compact(pres, ex0, ey0, kx0, ky0, min_points, crit_table, *,
                      n_slots: int, k2: int, s_max: int = 32,
                      max_rounds: int = 16, drain_capped: bool = False,
                      stats: dict | None = None):
    """Convergence-compacting refinement: an S-slot active set over G pairs.

    ``pres`` holds the eight presorted (G, N) arrays of all G pending pairs;
    ``ex0``/``ey0`` (G, k2+1) and ``kx0``/``ky0`` (G,) their start grids.
    At most ``n_slots`` pairs refine per round (the memory ceiling of
    ``BuildParams.pair_chunk``). After every round the host fetches the
    slots' split counts and guard flags, drains the converged slots (no
    split, ``max_rounds`` reached, or — when ``drain_capped`` — the capacity
    guard bound) into per-pair outputs and backfills them from the pending
    queue in order. PyTorch does not recompile per shape, so the active set
    simply shrinks when the queue runs dry.

    Each pair's trajectory is the deterministic ``_round_2d_batch``
    fixed-point iteration, independent of its slot neighbours, so the
    result is schedule-independent and bit-for-bit the reference's.

    Returns (ex, ey, kx, ky, capped, rounds) per pair: (G, k2+1) tensors on
    the device and host lists kx/ky/capped/rounds. ``stats`` (optional)
    accumulates ``loop_rounds`` (rounds run), ``pair_rounds`` (pair
    refinements run, summed over rounds) and ``occupancy_hist`` (active
    slots -> rounds run with that many).
    """
    g = ex0.shape[0]
    dev = ex0.device
    out_ex = torch.empty_like(ex0)
    out_ey = torch.empty_like(ey0)
    out_kx = [0] * g
    out_ky = [0] * g
    out_cap = [False] * g
    out_rnd = [0] * g

    slot_pair = list(range(min(n_slots, g)))
    next_ptr = len(slot_pair)
    idx = to_device(slot_pair, dev, torch.int64)
    sex, sey = ex0[idx], ey0[idx]
    skx = kx0[idx].to(torch.int64)
    sky = ky0[idx].to(torch.int64)
    scap = torch.zeros(len(slot_pair), dtype=torch.bool, device=dev)
    srnd = [0] * len(slot_pair)
    while slot_pair:
        idx = to_device(slot_pair, dev, torch.int64)
        data = [a[idx] for a in pres]
        sex, sey, skx, sky, n_split, cap_r = _round_2d_batch(
            *data, sex, sey, skx, sky, min_points, crit_table, k2=k2,
            s_max=s_max)
        scap = scap | cap_r
        # One grouped device->host transfer per round.
        flags = to_host(torch.stack([n_split, scap.to(torch.int64), skx,
                                     sky]))
        n_split_h, scap_h, skx_h, sky_h = flags.tolist()
        if stats is not None:
            stats["loop_rounds"] += 1
            stats["pair_rounds"] += len(slot_pair)
            occ = stats.setdefault("occupancy_hist", {})
            occ[len(slot_pair)] = occ.get(len(slot_pair), 0) + 1
        keep, done = [], []
        for si in range(len(slot_pair)):
            srnd[si] += 1
            conv = n_split_h[si] == 0 or srnd[si] >= max_rounds
            if drain_capped and scap_h[si]:
                conv = True
            (done if conv else keep).append(si)
        if done:
            d_idx = to_device(done, dev, torch.int64)
            p_idx = to_device([slot_pair[si] for si in done], dev,
                              torch.int64)
            out_ex[p_idx] = sex[d_idx]
            out_ey[p_idx] = sey[d_idx]
            for si in done:
                pair = slot_pair[si]
                out_kx[pair], out_ky[pair] = skx_h[si], sky_h[si]
                out_cap[pair] = bool(scap_h[si])
                out_rnd[pair] = srnd[si]
        n_new = min(len(done), g - next_ptr)
        fresh = list(range(next_ptr, next_ptr + n_new))
        next_ptr += n_new
        if done and (keep or fresh):
            k_idx = to_device(keep, dev, torch.int64)
            f_idx = to_device(fresh, dev, torch.int64)
            sex = torch.cat([sex[k_idx], ex0[f_idx]])
            sey = torch.cat([sey[k_idx], ey0[f_idx]])
            skx = torch.cat([skx[k_idx], kx0[f_idx].to(torch.int64)])
            sky = torch.cat([sky[k_idx], ky0[f_idx].to(torch.int64)])
            scap = torch.cat([scap[k_idx],
                              torch.zeros(n_new, dtype=torch.bool,
                                          device=dev)])
        slot_pair = [slot_pair[si] for si in keep] + fresh
        srnd = [srnd[si] for si in keep] + [0] * n_new
    return out_ex, out_ey, out_kx, out_ky, out_cap, out_rnd


def pair_metadata_batch(xo1, yo1, vo1, new1, xo2, yo2, vo2, new2,
                        ex, ey, kx, ky, *, k2: int):
    """Final pair-histogram metadata for P pairs: (P, ...) in and out.

    The count matrix routes through the batched hist2d kernel; everything
    per-dimension comes from the presorted order *without scatters*: a
    row's points are a contiguous slice of the (x, y)-sorted array (bin
    index depends on x alone), so row extrema are the slice ends and
    distinct counts are prefix-sum differences of the run flags.
    Returns (H, hx, ux, vminx, vmaxx, hy, uy, vminy, vmaxy).
    """
    p, n = xo1.shape
    dev = xo1.device
    bio1 = _bin_index_b(xo1, ex, kx)
    bjo1 = _bin_index_b(yo1, ey, ky)
    ones1 = vo1.to(torch.float64)
    H = batched_hist2d(bio1, bjo1, ones1, k2, k2)              # (P, K2, K2)
    hx = H.sum(dim=2)
    hy = H.sum(dim=1)
    nv = vo1.sum(dim=1)                                        # (P,)
    t = torch.arange(k2, device=dev)[None, :]

    def slice_meta(vals_sorted, valid_sorted, run_flags, edges, k):
        keyed = torch.where(valid_sorted, vals_sorted,
                            _full_like(vals_sorted, _INF))
        pos = torch.searchsorted(keyed, edges, right=False)    # (P, K2+1)
        lo = pos[:, :-1]
        # Half-open bins except the last valid one (closed): its slice runs
        # to the end of the valid prefix.
        hi = torch.where(t == k[:, None] - 1, nv[:, None], pos[:, 1:])
        hi = torch.maximum(hi, lo)
        up = torch.cumsum((run_flags & valid_sorted).to(torch.float64), dim=1)
        up = torch.cat([torch.zeros((p, 1), dtype=torch.float64, device=dev),
                        up], dim=1)
        uu = torch.gather(up, 1, hi) - torch.gather(up, 1, lo)
        vmin = torch.gather(vals_sorted, 1, _clip(lo, 0, n - 1))
        vmax = torch.gather(vals_sorted, 1, _clip(hi - 1, 0, n - 1))
        return uu, vmin, vmax

    ux, vminx, vmaxx = slice_meta(xo1, vo1, new1, ex, kx)
    uy, vminy, vmaxy = slice_meta(yo2, vo2, new2, ey, ky)

    zero = torch.zeros((), dtype=torch.float64, device=dev)
    empty_x = hx == 0
    vminx = torch.where(empty_x, ex[:, :-1], vminx)
    vmaxx = torch.where(empty_x, ex[:, 1:], vmaxx)
    ux = torch.where(empty_x, zero, ux)
    empty_y = hy == 0
    vminy = torch.where(empty_y, ey[:, :-1], vminy)
    vmaxy = torch.where(empty_y, ey[:, 1:], vmaxy)
    uy = torch.where(empty_y, zero, uy)
    return H, hx, ux, vminx, vmaxx, hy, uy, vminy, vmaxy
