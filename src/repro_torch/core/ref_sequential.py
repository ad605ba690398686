"""Paper-faithful sequential construction (Algorithms 1 + 2) in NumPy.

This is the literal, recursive, depth-first implementation of
``BuildPairwiseHist`` / ``RefineBin1D`` / ``RefineBin2D`` as printed in the
paper. It serves two purposes:

  1. Test oracle: in 1-D, midpoint splits make refinement decisions
     independent across bins, so the level-synchronous implementation in
     ``repro_torch.core.refine`` must produce *identical* edge sets —
     asserted in tests/test_torch_refine.py.
  2. The "paper-faithful baseline" of the construction benchmark
     (``repro_torch.bench.construction``: sequential recursion vs
     vectorized level-sync rounds).

It is host NumPy, as in the reference package; only the crit table comes
from ``repro_torch.core.chi2``.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core import chi2 as chi2lib


def is_uniform(x: np.ndarray, e_lo: float, e_hi: float, n_unique: int,
               crit_table: np.ndarray, s_max: int) -> bool:
    """IsUniform: chi-squared test against within-bin uniformity (Eq. 2–3)."""
    s = int(np.clip(np.ceil(np.cbrt(2.0 * n_unique)), 1, s_max))
    if s < 2:
        return True
    h = x.size
    # Sub-bin counts over equal-width sub-intervals of [e_lo, e_hi).
    edges = e_lo + (e_hi - e_lo) * np.arange(1, s) / s
    idx = np.searchsorted(np.sort(x), edges, side="left")
    bounds = np.concatenate([[0], idx, [h]])
    hbar = np.diff(bounds)
    expect = h / s
    stat = float(np.sum((hbar - expect) ** 2) / expect)
    crit = crit_table[s] if s < len(crit_table) else crit_table[-1]
    return stat <= crit


def refine_bin_1d(x: np.ndarray, e_lo: float, e_hi: float, m_points: int,
                  crit_table: np.ndarray, s_max: int, depth: int = 0,
                  max_depth: int = 64):
    """RefineBin1D (Algorithm 2). Returns (upper_edges, vmin, vmax, u)."""
    uniq = np.unique(x)
    n_u = uniq.size
    if x.size == 0:
        return [e_hi], [e_lo], [e_hi], [0]
    if n_u == 1:
        return [e_hi], [uniq[0]], [uniq[0]], [1]
    if x.size < m_points or depth >= max_depth or \
            is_uniform(x, e_lo, e_hi, n_u, crit_table, s_max):
        return [e_hi], [uniq[0]], [uniq[-1]], [n_u]
    z = 0.5 * (e_lo + e_hi)          # equal-width split at the midpoint
    if not (e_lo < z < e_hi):
        return [e_hi], [uniq[0]], [uniq[-1]], [n_u]
    left = x[x < z]
    right = x[x >= z]
    e_l, v_l, vp_l, u_l = refine_bin_1d(left, e_lo, z, m_points, crit_table,
                                        s_max, depth + 1, max_depth)
    e_r, v_r, vp_r, u_r = refine_bin_1d(right, z, e_hi, m_points, crit_table,
                                        s_max, depth + 1, max_depth)
    return e_l + e_r, v_l + v_r, vp_l + vp_r, u_l + u_r


def build_1d_sequential(x: np.ndarray, init_edges: np.ndarray, m_points: int,
                        crit_table: np.ndarray, s_max: int = 128):
    """The 1-D section of BuildPairwiseHist (Algorithm 1, lines 3–12)."""
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x)]
    edges = [float(init_edges[0])]
    vmin, vmax, u = [], [], []
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        for t in range(len(init_edges) - 1):
            lo, hi = float(init_edges[t]), float(init_edges[t + 1])
            last = t == len(init_edges) - 2
            sel = (x >= lo) & ((x <= hi) if last else (x < hi))
            e_new, v_new, vp_new, u_new = refine_bin_1d(
                x[sel], lo, hi, m_points, crit_table, s_max)
            edges.extend(e_new)
            vmin.extend(v_new)
            vmax.extend(vp_new)
            u.extend(u_new)
    finally:
        sys.setrecursionlimit(old_limit)
    edges = np.asarray(edges)
    counts, _ = np.histogram(x, bins=edges)
    return (edges, counts.astype(np.float64), np.asarray(u, np.float64),
            np.asarray(vmin, np.float64), np.asarray(vmax, np.float64))


def refine_bin_2d(xy: np.ndarray, bx: tuple, by: tuple, m_points: int,
                  crit_table: np.ndarray, s_max: int, depth: int = 0,
                  max_depth: int = 16):
    """RefineBin2D: returns (new_x_edges, new_y_edges) discovered in this bin."""
    if xy.shape[0] <= m_points or depth >= max_depth:
        return [], []
    x, y = xy[:, 0], xy[:, 1]
    ux, uy = np.unique(x).size, np.unique(y).size
    ok_x = ux <= 1 or is_uniform(x, bx[0], bx[1], ux, crit_table, s_max)
    ok_y = uy <= 1 or is_uniform(y, by[0], by[1], uy, crit_table, s_max)
    if ok_x and ok_y:
        return [], []

    def excess(vals, lo, hi, n_u):
        s = int(np.clip(np.ceil(np.cbrt(2.0 * n_u)), 2, s_max))
        edges = lo + (hi - lo) * np.arange(1, s) / s
        idx = np.searchsorted(np.sort(vals), edges, side="left")
        hbar = np.diff(np.concatenate([[0], idx, [vals.size]]))
        expect = vals.size / s
        return float(np.sum((hbar - expect) ** 2) / expect) / crit_table[s]

    split_x = not ok_x and (ok_y or excess(x, *bx, ux) >= excess(y, *by, uy))
    if split_x:
        z = 0.5 * (bx[0] + bx[1])
        if not (bx[0] < z < bx[1]):
            return [], []
        ex_l, ey_l = refine_bin_2d(xy[x < z], (bx[0], z), by, m_points,
                                   crit_table, s_max, depth + 1, max_depth)
        ex_r, ey_r = refine_bin_2d(xy[x >= z], (z, bx[1]), by, m_points,
                                   crit_table, s_max, depth + 1, max_depth)
        return [z] + ex_l + ex_r, ey_l + ey_r
    z = 0.5 * (by[0] + by[1])
    if not (by[0] < z < by[1]):
        return [], []
    ex_l, ey_l = refine_bin_2d(xy[y < z], bx, (by[0], z), m_points,
                               crit_table, s_max, depth + 1, max_depth)
    ex_r, ey_r = refine_bin_2d(xy[y >= z], bx, (z, by[1]), m_points,
                               crit_table, s_max, depth + 1, max_depth)
    return ex_l + ex_r, [z] + ey_l + ey_r


def build_2d_sequential(x, y, ex0, ey0, m_points, crit_table, s_max: int = 32):
    """The 2-D section of BuildPairwiseHist (Algorithm 1, lines 14–26)."""
    pts = np.stack([x, y], 1)
    pts = pts[np.isfinite(pts).all(1)]
    ex, ey = list(ex0), list(ey0)
    H, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=[np.asarray(ex), np.asarray(ey)])
    new_x, new_y = [], []
    for ti in range(len(ex) - 1):
        for tj in range(len(ey) - 1):
            if H[ti, tj] <= m_points:
                continue
            last_x = ti == len(ex) - 2
            last_y = tj == len(ey) - 2
            sel_x = (pts[:, 0] >= ex[ti]) & ((pts[:, 0] <= ex[ti + 1]) if last_x
                                             else (pts[:, 0] < ex[ti + 1]))
            sel_y = (pts[:, 1] >= ey[tj]) & ((pts[:, 1] <= ey[tj + 1]) if last_y
                                             else (pts[:, 1] < ey[tj + 1]))
            cell = pts[sel_x & sel_y]
            zx, zy = refine_bin_2d(cell, (ex[ti], ex[ti + 1]),
                                   (ey[tj], ey[tj + 1]), m_points,
                                   crit_table, s_max)
            new_x.extend(zx)
            new_y.extend(zy)
    ex = np.unique(np.concatenate([ex, new_x]))
    ey = np.unique(np.concatenate([ey, new_y]))
    H, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=[ex, ey])
    return ex, ey, H


def crit_table_for(alpha: float, s_max: int) -> np.ndarray:
    return chi2lib.build_crit_table(alpha, s_max)
