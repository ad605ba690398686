"""Predicate coverage (§5.2): Eq. 14–16 estimates, Eq. 22–23 bounds.

Coverage beta_t = Pr(P | point in bin t), computed per bin of whichever bin
grid the predicate column uses for the query at hand (the 1-D histogram when
the predicate column *is* the aggregation column, a pair-histogram slice
otherwise — the slice carries the same metadata: h, u, v-, v+).

Functions here are NumPy (they are also the kernel oracle); the fused CUDA
path lives in ``repro_torch.core.fastpath``.

Consolidation ("delayed transformation", §5.2): groups of conditions on the
same column directly under one AND/OR are merged into an interval set in a
half-integer domain (integer data with spacing mu) *before* coverage, because
same-column conditions are maximally conditionally dependent (Eq. 28's
independence assumption would be badly violated).
"""
from __future__ import annotations

import math

import numpy as np

_RANGE_OPS = ("<", "<=", ">", ">=")


# ---------------------------------------------------------------------------
# Interval algebra for consolidation (half-open real intervals)
# ---------------------------------------------------------------------------


def cond_to_intervals(op: str, v: float, mu: float):
    """Condition -> list of closed intervals in the half-integer domain."""
    half = 0.5 * mu
    if op == "<":
        return [(-math.inf, v - half)]
    if op == "<=":
        return [(-math.inf, v + half)]
    if op == ">":
        return [(v + half, math.inf)]
    if op == ">=":
        return [(v - half, math.inf)]
    if op == "=":
        return [(v - half, v + half)]
    if op in ("!=", "<>"):
        return [(-math.inf, v - half), (v + half, math.inf)]
    raise ValueError(f"unknown operator {op!r}")


def union_intervals(sets):
    """Union of interval lists -> disjoint sorted list."""
    ivs = sorted(iv for s in sets for iv in s)
    out = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def intersect_intervals(sets):
    """Intersection of interval lists -> disjoint sorted list."""
    cur = sets[0]
    for s in sets[1:]:
        nxt = []
        for a_lo, a_hi in cur:
            for b_lo, b_hi in s:
                lo, hi = max(a_lo, b_lo), min(a_hi, b_hi)
                if lo <= hi:
                    nxt.append((lo, hi))
        cur = sorted(nxt)
    return cur


# ---------------------------------------------------------------------------
# Coverage estimates (Eq. 15 / 16)
# ---------------------------------------------------------------------------


def coverage_single(op, value, h, u, vmin, vmax):
    """Eq. 15 (equality / inequality) and Eq. 16 (range ops), vectorized.

    All bin arrays share shape (k,). Returns beta in [0, 1].
    """
    h = np.asarray(h, float)
    u = np.asarray(u, float)
    vmin = np.asarray(vmin, float)
    vmax = np.asarray(vmax, float)
    inside = (vmin <= value) & (value <= vmax)
    usafe = np.maximum(u, 1.0)
    if op == "=":
        return np.where(inside & (u > 0), 1.0 / usafe, 0.0)
    if op in ("!=", "<>"):
        return np.where(u > 0, 1.0 - np.where(inside, 1.0 / usafe, 0.0), 0.0)
    if op not in _RANGE_OPS:
        raise ValueError(f"unknown operator {op!r}")

    def sat(x):
        if op == "<":
            return x < value
        if op == "<=":
            return x <= value
        if op == ">":
            return x > value
        return x >= value

    lo_ok = sat(vmin)
    hi_ok = sat(vmax)
    width = np.maximum(vmax - vmin, 1e-300)
    if op in ("<", "<="):
        frac = (value - vmin) / width
    else:
        frac = (vmax - value) / width
    frac = np.clip(frac, 0.0, 1.0)
    beta = np.where(
        lo_ok & hi_ok, 1.0,
        np.where(
            ~lo_ok & ~hi_ok, 0.0,
            np.where(u == 2.0, 0.5, frac),
        ),
    )
    return np.where(h > 0, beta, np.where(lo_ok & hi_ok, 1.0, np.where(~lo_ok & ~hi_ok, 0.0, 0.5)))


def coverage_intervals(intervals, h, u, vmin, vmax, mu):
    """Coverage of a disjoint interval set (consolidated same-column group).

    Non-degenerate intervals contribute their overlap fraction of the bin's
    value span (the f_t(P) of Eq. 16); degenerate (single-value, width <= mu)
    intervals contribute 1/u (the Eq. 15 equality rule).
    """
    h = np.asarray(h, float)
    u = np.asarray(u, float)
    vmin = np.asarray(vmin, float)
    vmax = np.asarray(vmax, float)
    usafe = np.maximum(u, 1.0)
    width = np.maximum(vmax - vmin, 1e-300)
    beta = np.zeros_like(h)
    for lo, hi in intervals:
        if hi - lo <= mu * (1 + 1e-9):  # equality point
            v = 0.5 * (lo + hi)
            beta += np.where((vmin <= v) & (v <= vmax), 1.0 / usafe, 0.0)
            continue
        cov_lo = np.maximum(lo, vmin)
        cov_hi = np.minimum(hi, vmax)
        full = (lo <= vmin) & (vmax <= hi)
        none = (cov_hi < cov_lo)
        frac = np.clip((cov_hi - cov_lo) / width, 0.0, 1.0)
        beta += np.where(full, 1.0, np.where(none, 0.0, frac))
    return np.clip(np.where(u > 0, beta, 0.0), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Coverage bounds (Theorem 2 -> Eq. 22 / 23)
# ---------------------------------------------------------------------------


def coverage_bounds(beta, h, u, min_points, crit_table, s_max: int):
    """Lower / upper coverage bounds per Eq. 22–23.

    beta in {0,1}: exact. h < M: [1/h, 1-1/h]. Otherwise the partial-count
    bounds from Theorem 2 with a = floor(beta*s), b = ceil(beta*s).
    """
    beta = np.asarray(beta, float)
    h = np.asarray(h, float)
    u = np.asarray(u, float)
    s = np.clip(np.ceil(np.cbrt(2.0 * np.maximum(u, 0.0))), 1, s_max)
    chi = crit_table[np.clip(s.astype(int), 0, len(crit_table) - 1)]
    chi = np.where(np.isfinite(chi), chi, 0.0)
    hsafe = np.maximum(h, 1.0)

    a = np.floor(beta * s)
    b = np.ceil(beta * s)
    with np.errstate(divide="ignore", invalid="ignore"):
        lo_pass = a / s - (a / s) * np.sqrt(chi * (s - a) / (hsafe * np.maximum(a, 1.0)))
        hi_pass = b / s + (b / s) * np.sqrt(chi * (s - b) / (hsafe * np.maximum(b, 1.0)))
    lo_pass = np.where(a > 0, lo_pass, 0.0)
    hi_pass = np.where(b > 0, hi_pass, 0.0)

    lo_fail = 1.0 / hsafe
    hi_fail = 1.0 - 1.0 / hsafe

    passing = h >= min_points
    lo = np.where(passing, lo_pass, lo_fail)
    hi = np.where(passing, hi_pass, hi_fail)

    exact = (beta <= 0.0) | (beta >= 1.0)
    lo = np.where(exact, beta, lo)
    hi = np.where(exact, beta, hi)
    empty = h <= 0
    lo = np.where(empty, beta, lo)
    hi = np.where(empty, beta, hi)
    lo = np.clip(np.minimum(lo, beta), 0.0, 1.0)
    hi = np.clip(np.maximum(hi, beta), 0.0, 1.0)
    return lo, hi
