"""Chi-squared machinery for the uniformity hypothesis tests (§4.1).

The paper tests the null hypothesis "points are uniform within the bin" with a
chi-squared statistic over ``s = ceil((2u)^(1/3))`` sub-bins (Terrell–Scott,
Eq. 2–3) at significance ``alpha``.

Critical values chi2_alpha(df) gate every split (``stat > crit``) and are
written into the weighted-centre bounds (at build and at storage decode), so
a synopsis is only bit-identical to the reference package's if the table is
too. For every alpha the repo uses (0.01, 0.001 and 0.0001) and ``s <= 256``
the tables are therefore checked in (``repro_torch.core.crit_table``, exact
``float.hex`` literals of the reference's values). Any other alpha, or a
longer table, runs the same Wilson–Hilferty-bracketed bisection on the
regularized upper incomplete gamma as the reference, on
``torch.special.gammaincc`` — whose last bits differ from the reference's
gamma function, so such a table may differ from the reference's in the last
ulp.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import crit_table as _crit
from repro_torch.kernels.subbin import batched_subbin_hist


def chi2_sf(x, df):
    """Survival function of the chi-squared distribution: Pr(X > x)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    df = torch.as_tensor(df, dtype=torch.float64)
    return torch.special.gammaincc(df / 2.0, x / 2.0)


def _wilson_hilferty(alpha, df):
    """Approximate upper quantile (starting point for bisection)."""
    z = math.sqrt(2.0) * torch.special.erfinv(
        torch.tensor(1.0 - 2.0 * alpha, dtype=torch.float64))
    term = 1.0 - 2.0 / (9.0 * df) + z * torch.sqrt(2.0 / (9.0 * df))
    return df * term**3


def chi2_isf(alpha: float, df, iters: int = 90):
    """Inverse survival function: x such that Pr(X > x) = alpha.

    Vectorized over ``df``. Bisection on [0, hi] where hi brackets the root.
    90 f64 bisection steps resolve to ~1 ulp of the bracket.
    """
    df = torch.as_tensor(df, dtype=torch.float64)
    guess = _wilson_hilferty(alpha, torch.clamp(df, min=1.0))
    hi = torch.maximum(4.0 * guess + 100.0, df + 200.0)
    lo = torch.zeros_like(df)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        # SF decreases in x: SF(mid) > alpha => root is to the right.
        go_right = chi2_sf(mid, df) > alpha
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def build_crit_table(alpha: float, s_max: int) -> np.ndarray:
    """Critical values indexed by the number of sub-bins ``s``.

    ``table[s] = chi2_isf(alpha, df=s-1)`` for s >= 2; entries for s < 2 are
    +inf (a bin with a single sub-bin can never fail the test — it also can
    never be split, matching RefineBin1D's u == 1 early-out). The checked-in
    tables serve alpha 0.01, 0.001 and 0.0001 up to ``CRIT_S_MAX`` (256),
    bit for bit the reference's; any other alpha or a longer table is
    bisected here and may differ from the reference's in the last ulp.
    """
    if s_max < 2:
        raise ValueError("s_max must be >= 2")
    hexes = _crit.CRIT_HEX.get(alpha)
    if hexes is not None and s_max <= _crit.CRIT_S_MAX:
        return np.array([float.fromhex(v) for v in hexes[:s_max + 1]],
                        np.float64)
    table = np.full(s_max + 1, np.inf, dtype=np.float64)
    s = np.arange(2, s_max + 1, dtype=np.float64)
    table[2:] = chi2_isf(alpha, torch.from_numpy(s - 1.0)).numpy()
    return table


def num_subbins(u, s_max: int):
    """Terrell–Scott sub-bin count (Eq. 2): s = ceil((2u)^(1/3)), clipped.

    Computed without a floating cube root (PyTorch has none): ``s`` is the
    smallest integer with ``s^3 >= 2u``, i.e. one plus the number of cubes
    ``k^3 < 2u`` for ``k = 1 .. s_max - 1``, found by one ``searchsorted``
    into the exact cube table. That equals the reference's ``ceil(cbrt(2u))``
    for every integer-valued ``u`` (unique-value counts, which is all the
    refinement passes); ``u <= 0`` gives 1. Returns int64 on ``u``'s device.
    """
    u = torch.as_tensor(u, dtype=torch.float64)
    cubes = torch.arange(1, s_max, dtype=torch.float64, device=u.device) ** 3
    return 1 + torch.searchsorted(cubes, (2.0 * u).contiguous(), right=False)


def subbin_counts(vals, lo, width, cell, s, valid, *, ncell: int, s_max: int):
    """Kernel-backed per-cell sub-bin counts: (P, ncell, s_max) f64.

    Each valid point lands in sub-bin ``r = floor(s_cell * frac)`` of its
    cell, where ``frac`` is the point's fractional position in the cell's
    interval along the tested dimension. The counting itself dispatches
    through ``repro_torch.kernels.subbin.batched_subbin_hist`` (the CUDA
    kernel for CUDA tensors, the plain scatter-add otherwise); counts are
    exact integers either way.

    Every valid point lands in exactly one live sub-bin, so the last-axis
    sum reproduces the per-cell totals — callers need no separate h_cell
    scatter.

    vals/lo/width: (P, N) f64 per-point value + its cell's interval.
    cell:          (P, N) int64 flattened cell id in [0, ncell).
    s:             (P, ncell) int64 per-cell sub-bin counts (``num_subbins``).
    valid:         (P, N) bool row mask (nulls contribute weight 0).
    """
    r = subbin_index(vals, lo, width, torch.gather(s, 1, cell))
    w = valid.to(torch.float64)
    return batched_subbin_hist(cell, r, w, ncell, s_max)


def subbin_index(vals, lo, width, s_pt):
    """Sub-bin ``r = floor(s * frac)`` of each point, clipped to
    ``[0, s - 1]``: ``frac`` is the point's fractional position in its
    cell's interval ``[lo, lo + width)`` and ``s_pt`` (int64) its cell's
    sub-bin count. Any shape; int64 out."""
    frac = torch.where(width > 0, (vals - lo) / width,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    # Truncation toward zero, as the reference's astype(int32).
    r = (frac * s_pt.to(torch.float64)).to(torch.int64)
    return torch.minimum(torch.clamp(r, min=0), s_pt - 1)
