"""Aggregation functions and their bounds (§5.4, Table 3).

Everything operates in the *pre-processed* domain; the engine de-preprocesses
results (repro_torch.core.query). Inputs: weightings (w, wlo, whi) on the 1-D bins
of the aggregation column plus that histogram's metadata and rho = N_s/N.

Each function returns (estimate, lower, upper); empty results (no bin with
positive weight) return (nan, nan, nan) — SQL NULL.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-12


def _subbin_geometry(u, vmin, vmax, s_max):
    s = np.clip(np.ceil(np.cbrt(2.0 * np.maximum(np.asarray(u, float), 0.0))), 1, s_max)
    delta = (np.asarray(vmax, float) - np.asarray(vmin, float)) / s
    return s, delta


def agg_count(w, wlo, whi, rho):
    return (float(w.sum() / rho), float(wlo.sum() / rho), float(whi.sum() / rho))


def agg_sum(w, wlo, whi, c, cminus, cplus, rho):
    est = float(w @ c / rho)
    lo = float(wlo @ cminus / rho)
    hi = float(whi @ cplus / rho)
    return est, min(lo, est), max(hi, est)


def agg_avg(w, wlo, whi, c, cminus, cplus):
    tot = w.sum()
    if tot <= _EPS:
        return (np.nan,) * 3
    est = float(w @ c / tot)
    los, his = [], []
    for wb in (wlo, whi):
        n = wb.sum()
        if n > _EPS:
            los.append(wb @ cminus / n)
            his.append(wb @ cplus / n)
    lo = float(min(los)) if los else est
    hi = float(max(his)) if his else est
    return est, min(lo, est), max(hi, est)


def _first(mask):
    idx = np.flatnonzero(mask)
    return int(idx[0]) if idx.size else None


def _last(mask):
    idx = np.flatnonzero(mask)
    return int(idx[-1]) if idx.size else None


def agg_min(w, wlo, whi, hist, min_points, s_max, single_col: bool):
    """MIN per Table 3 (§5.4.4) with the single-column tightenings."""
    h, u, vmin, vmax = hist.h, hist.u, hist.vmin, hist.vmax
    s, delta = _subbin_geometry(u, vmin, vmax, s_max)

    t = _first(w > _EPS)
    if t is None:
        return (np.nan,) * 3
    if single_col and u[t] == 2 and w[t] < h[t] / 2.0:
        est = float(vmax[t])
    else:
        est = float(vmin[t])

    # Lower bound: first bin that *might* contain matches (Eq. 31).
    tl = _first(whi > _EPS)
    if tl is None:
        lo = est
    elif single_col and u[tl] == 2 and whi[tl] < h[tl] / 5.0:
        lo = float(vmax[tl])
    else:
        lo = float(vmin[tl])

    # Upper bound: first bin very likely to contain matches (Eq. 32).
    tu = _first(wlo > 0.5)
    if tu is None:
        tu = _last(whi > _EPS)  # conservative fallback
    if tu is None:
        hi = est
    elif single_col and u[tu] > 2 and h[tu] >= min_points:
        a = np.floor(s[tu] * wlo[tu] / max(h[tu], 1.0))
        hi = float(vmax[tu] - a * delta[tu])
    else:
        hi = float(vmax[tu])
    return est, min(lo, est), max(hi, est)


def agg_max(w, wlo, whi, hist, min_points, s_max, single_col: bool):
    """MAX — the mirror of MIN (§5.4.5)."""
    h, u, vmin, vmax = hist.h, hist.u, hist.vmin, hist.vmax
    s, delta = _subbin_geometry(u, vmin, vmax, s_max)

    t = _last(w > _EPS)
    if t is None:
        return (np.nan,) * 3
    if single_col and u[t] == 2 and w[t] < h[t] / 2.0:
        est = float(vmin[t])
    else:
        est = float(vmax[t])

    tu = _last(whi > _EPS)
    if tu is None:
        hi = est
    elif single_col and u[tu] == 2 and whi[tu] < h[tu] / 5.0:
        hi = float(vmin[tu])
    else:
        hi = float(vmax[tu])

    tl = _last(wlo > 0.5)
    if tl is None:
        tl = _first(whi > _EPS)
    if tl is None:
        lo = est
    elif single_col and u[tl] > 2 and h[tl] >= min_points:
        a = np.floor(s[tl] * wlo[tl] / max(h[tl], 1.0))
        lo = float(vmin[tl] + a * delta[tl])
    else:
        lo = float(vmin[tl])
    return est, min(lo, est), max(hi, est)


def _median_bin(wb):
    tot = wb.sum()
    if tot <= _EPS:
        return None
    cum = np.cumsum(wb)
    return int(np.searchsorted(cum, 0.5 * tot))


def agg_median(w, wlo, whi, hist):
    """MEDIAN per Eq. 34–37."""
    u, vmin, vmax = hist.u, hist.vmin, hist.vmax
    tot = w.sum()
    if tot <= _EPS:
        return (np.nan,) * 3
    cum = np.cumsum(w)
    t = int(np.searchsorted(cum, 0.5 * tot))
    t = min(t, len(w) - 1)
    prev = cum[t - 1] if t > 0 else 0.0
    f = (0.5 * tot - prev) / max(w[t], _EPS)
    if u[t] == 2:
        est = float(vmin[t] if f < 0.5 else vmax[t])
    else:
        est = float(vmin[t] + (vmax[t] - vmin[t]) * np.clip(f, 0.0, 1.0))

    ts = [x for x in (_median_bin(wlo), _median_bin(whi)) if x is not None]
    if ts:
        lo = float(vmin[min(ts)])
        hi = float(vmax[max(ts)])
    else:
        lo = hi = est
    return est, min(lo, est), max(hi, est)


def agg_var(w, wlo, whi, c, vmin, vmax):
    """VAR per §5.4.7 (Eq. 38–39)."""
    tot = w.sum()
    if tot <= _EPS:
        return (np.nan,) * 3
    avg = w @ c / tot
    est = float(w @ (c**2) / tot - avg**2)

    xi_lo = np.where(vmax < avg, vmax, np.where(vmin > avg, vmin, avg))
    xi_hi = np.where(np.abs(avg - vmin) > np.abs(vmax - avg), vmin, vmax)

    los, his = [], []
    for wb in (wlo, whi):
        n = wb.sum()
        if n <= _EPS:
            continue
        m_lo = wb @ xi_lo / n
        los.append(wb @ (xi_lo**2) / n - m_lo**2)
        m_hi = wb @ xi_hi / n
        his.append(wb @ (xi_hi**2) / n - m_hi**2)
    lo = float(min(los)) if los else est
    hi = float(max(his)) if his else est
    lo = max(lo, 0.0)
    return est, min(lo, est), max(hi, est)
