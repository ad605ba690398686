"""The reference synopsis: PairwiseHist's construction (arXiv:2401.12018,
Algorithm 1, Sec. 4) written from its definitions in plain PyTorch, one
column and one pair at a time, on any device and in the real dtype asked
for (float64 as the configurations state; the control runs float32). It
imports nothing of the program and reads nothing the program made.

Definitions, with M = max(2, round(m_frac * N_s)):

  * Sample: N_s rows drawn without replacement by NumPy's
    ``default_rng(seed).choice``; a column's values are its non-missing
    ones.
  * Bins: bin t holds the values v with e_t <= v < e_{t+1}, the last bin
    also v = e_k. A bin's h is its count, u its distinct values, v-/v+ its
    least and largest value (its edges when empty).
  * Sub-bins (Terrell-Scott): s = the least integer with s^3 >= 2u, in
    [1, s_max]. Uniformity: chi2 = sum_r (n_r - h/s)^2 / (h/s) over the s
    sub-bins against the upper alpha quantile of chi-squared with s - 1
    degrees of freedom (none for s < 2). In 1-D the sub-bin edges are
    e_L + width * r / s; in 2-D a point's sub-bin along a dimension is
    floor(s * (v - lo) / width) of its cell's interval, clipped to [0, s-1].
  * 1-D initial edges: the column's least and largest value around its
    GreedyGD bases strictly between them (one edge between categories for a
    text column of at most max(ceil(N_s / M), 4) categories), thinned to
    ceil(N_s / M) - 2 inner edges at evenly spaced ranks.
  * 1-D rounds, every bin of a column at once: a bin with h >= M, u > 1 and
    chi2 above its quantile splits at its midpoint, the first K1 - k of them
    by position; at most ``max_rounds_1d`` rounds, until none splits.
  * 2-D rounds, per pair (a, b) over the rows where both are present, from
    the two columns' 1-D edges (at most K2 bins each): a cell with h > M
    fails along a dimension where its distinct values there exceed one and
    its chi2 there is above the quantile; it asks to split the dimension
    whose chi2 over its quantile is larger (x on a tie); a row (column) of
    cells splits at its midpoint when any of its cells asks, the first
    K2 - k by position; at most ``max_rounds_2d`` rounds, until none splits.
  * Pair metadata: the cell counts H, and per row (column) slice its count,
    distinct values, least and largest value (its edges when empty).
  * Union: a column's final edges are the union of its 1-D edges and every
    pair's edges along it, thinned to K1 + 1 at evenly spaced ranks; its
    bins' metadata are taken again on them, with the centre c = (v- + v+)/2
    and its bounds (Eq. 10): for u <= 1 both c; for h < M,
    v- + (u-1)u/(2h) and v+ - (u-1)u/(2h); else, with delta = (v+ - v-)/s,
    v- + (s -/+ 1) delta/2 -/+ (delta/6) sqrt(3 chi2_alpha (s^2 - 1) / h);
    each clipped to [v-, v+] and c+ >= c-.
  * Folds: each union bin's midpoint located in the pair's edges.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy import stats

from aqpbench.reference import table as ref_table

HIST_FIELDS = ("edges", "k", "h", "u", "vmin", "vmax", "c", "cminus",
               "cplus")
PAIR_FIELDS = ("ex", "ey", "kx", "ky", "H", "hx", "ux", "vminx", "vmaxx",
               "hy", "uy", "vminy", "vmaxy", "fold_x", "fold_y")
# The capacities and round limits of a build, as the program's defaults
# state them; a configuration's ``build`` overrides any of them.
DEFAULTS = {"n_samples": 100_000, "m_frac": 0.01, "alpha": 0.001,
            "k1_cap": 512, "k2_cap": 256, "s1_max": 128, "s2_max": 32,
            "max_rounds_1d": 64, "max_rounds_2d": 16}


def quantiles(alpha: float, s_max: int) -> np.ndarray:
    """``q[s]``: the upper ``alpha`` quantile of chi-squared with s - 1
    degrees of freedom; +inf for s < 2."""
    q = np.full(s_max + 1, np.inf)
    q[2:] = stats.chi2.isf(alpha, np.arange(1, s_max))
    return q


def subbins(u: torch.Tensor, s_max: int) -> torch.Tensor:
    """The least integer s with s^3 >= 2u, in [1, s_max] (int64)."""
    two_u = (2 * torch.round(u)).to(torch.int64)
    s = torch.round(two_u.double() ** (1.0 / 3.0)).to(torch.int64)
    s = torch.where(s ** 3 < two_u, s + 1, s)
    s = torch.where((s > 1) & ((s - 1) ** 3 >= two_u), s - 1, s)
    return s.clamp(1, s_max)


def _distinct(group: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """Distinct values of integer-valued ``v`` in each of ``n`` groups."""
    span = int(v.max().item()) + 1 if v.numel() else 1
    keys = torch.unique(group * span + v.to(torch.int64))
    return torch.bincount(keys // span, minlength=n)


class _Build:
    def __init__(self, params: dict, dtype, device):
        self.p = dict(DEFAULTS, **params)
        self.dtype, self.dev = dtype, torch.device(device)
        n_s = self.p["n_samples"]
        self.m = max(2, int(round(self.p["m_frac"] * n_s)))
        s_top = max(self.p["s1_max"], self.p["s2_max"])
        self.q_np = quantiles(self.p["alpha"], s_top)
        self.q = torch.as_tensor(self.q_np, dtype=dtype, device=self.dev)

    def real(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.dev)

    # -------------------------------------------------------------- 1-D
    def bins_1d(self, xs, e):
        """(h, u, v-, v+, lo, hi) of sorted values ``xs`` on edges ``e``."""
        lo = torch.searchsorted(xs, e[:-1])
        hi = torch.searchsorted(xs, e[1:])
        if hi.numel():      # a column of one value may end with no bin
            hi[-1] = torch.searchsorted(xs, e[-1:], right=True)[0]
        hi = torch.maximum(hi, lo)
        h = (hi - lo).to(self.dtype)
        new = torch.ones_like(xs, dtype=torch.int64)
        new[1:] = (xs[1:] != xs[:-1]).to(torch.int64)
        first = torch.zeros(xs.numel() + 1, dtype=torch.int64, device=self.dev)
        first[1:] = torch.cumsum(new, 0)
        # bins are cut by value, so a bin's first value differs from the
        # value before it and counts as new
        u = (first[hi] - first[lo]).to(self.dtype)
        starts = lo < hi
        top = max(xs.numel() - 1, 0)
        vmin = torch.where(starts, xs[lo.clamp(max=top)], e[:-1])
        vmax = torch.where(starts, xs[(hi - 1).clamp(0, top)], e[1:])
        return h, u, vmin, vmax, lo, hi

    def chi2_1d(self, xs, e, h, u, lo, hi):
        s_max = self.p["s1_max"]
        s = subbins(u, s_max)
        r = torch.arange(1, s_max, device=self.dev)
        frac = r[None, :].to(self.dtype) / s[:, None].to(self.dtype)
        width = e[1:] - e[:-1]
        sub = e[:-1, None] + width[:, None] * frac
        pos = torch.searchsorted(xs, sub.reshape(-1)).reshape(sub.shape)
        pos = torch.where(r[None, :] < s[:, None], pos, hi[:, None])
        pos = torch.minimum(torch.maximum(pos, lo[:, None]), hi[:, None])
        cuts = torch.cat([lo[:, None], pos, hi[:, None]], 1)
        n_r = (cuts[:, 1:] - cuts[:, :-1]).to(self.dtype)
        expect = h / s.to(self.dtype)
        live = torch.arange(s_max, device=self.dev)[None, :] < s[:, None]
        dev2 = torch.where(live, (n_r - expect[:, None]) ** 2, 0.0)
        chi2 = dev2.sum(1) / torch.clamp(expect, min=1e-30)
        return chi2, self.q[s]

    def initial_edges(self, xs, seeds, categorical: int | None):
        n_s = self.p["n_samples"]
        n_take = max(2, math.ceil(n_s / self.m))
        if xs.numel():
            lo, hi = float(xs[0]), float(xs[-1])
        else:
            lo = hi = 0.0
        if categorical is not None and 0 < categorical <= max(n_take, 4):
            seeds = np.arange(categorical - 1) + 0.5
        if seeds is not None and len(seeds) > 2:
            inner = np.unique(np.asarray(seeds, np.float64))
            inner = inner[(inner > lo) & (inner < hi)]
            keep = max(n_take - 2, 0)
            if inner.size > keep:
                at = np.linspace(0, inner.size - 1, keep).round().astype(int)
                inner = inner[np.unique(at)] if at.size else inner[:0]
            e = np.unique(np.concatenate([[lo], inner, [hi]]))
        else:
            e = np.unique(np.array([lo, hi]))
        if e.size == 1:
            e = np.array([e[0], e[0]])
        return self.real(e[: self.p["k1_cap"] + 1])

    def refine_1d(self, xs, e):
        cap = self.p["k1_cap"]
        for _ in range(self.p["max_rounds_1d"]):
            h, u, _, _, lo, hi = self.bins_1d(xs, e)
            chi2, q = self.chi2_1d(xs, e, h, u, lo, hi)
            z = 0.5 * (e[:-1] + e[1:])
            split = ((h >= self.m) & (u > 1) & (chi2 > q)
                     & (z > e[:-1]) & (z < e[1:]) & torch.isfinite(z))
            room = cap - (e.numel() - 1)
            split &= torch.cumsum(split.to(torch.int64), 0) <= room
            if not bool(split.any()):
                break
            e = torch.sort(torch.cat([e, z[split]])).values
        return e

    def centre_bounds(self, h, u, vmin, vmax):
        s = subbins(u, self.p["s1_max"]).to(self.dtype)
        q = self.q[s.to(torch.int64)]
        q = torch.where(torch.isfinite(q), q, 0.0)
        hh = torch.clamp(h, min=1.0)
        delta = (vmax - vmin) / s
        spread = delta / 6.0 * torch.sqrt(3.0 * q * (s * s - 1.0) / hh)
        lo = vmin + (s - 1.0) * delta / 2.0 - spread
        up = vmin + (s + 1.0) * delta / 2.0 + spread
        few = h < self.m
        shift = (u - 1.0) * u / (2.0 * hh)
        lo = torch.where(few, vmin + shift, lo)
        up = torch.where(few, vmax - shift, up)
        c = 0.5 * (vmin + vmax)
        lo = torch.where(u <= 1, c, lo)
        up = torch.where(u <= 1, c, up)
        lo = torch.minimum(torch.maximum(lo, vmin), vmax)
        up = torch.minimum(torch.maximum(up, lo), vmax)
        return c, lo, up

    def hist_1d(self, xs, e) -> dict:
        h, u, vmin, vmax, _, _ = self.bins_1d(xs, e)
        c, lo, up = self.centre_bounds(h, u, vmin, vmax)
        return {"edges": e, "k": e.numel() - 1, "h": h, "u": u,
                "vmin": vmin, "vmax": vmax, "c": c, "cminus": lo,
                "cplus": up}

    # -------------------------------------------------------------- 2-D
    @staticmethod
    def locate(v, e):
        return (torch.searchsorted(e, v, right=True) - 1).clamp(
            0, e.numel() - 2)

    def chi2_2d(self, v, lo, width, cell, h, u, n):
        s_max = self.p["s2_max"]
        s = subbins(u, s_max)
        frac = torch.where(width > 0, (v - lo) / width, 0.0)
        sp = s[cell]
        r = torch.minimum((frac * sp.to(self.dtype)).to(torch.int64).clamp(
            min=0), sp - 1)
        n_r = torch.bincount(cell * s_max + r, minlength=n * s_max)
        n_r = n_r.reshape(n, s_max).to(self.dtype)
        expect = h / s.to(self.dtype)
        live = torch.arange(s_max, device=self.dev)[None, :] < s[:, None]
        dev2 = torch.where(live, (n_r - expect[:, None]) ** 2, 0.0)
        return dev2.sum(1) / torch.clamp(expect, min=1e-30), self.q[s]

    def refine_2d(self, x, y, ex, ey):
        cap = self.p["k2_cap"]
        for _ in range(self.p["max_rounds_2d"]):
            kx, ky = ex.numel() - 1, ey.numel() - 1
            i, j = self.locate(x, ex), self.locate(y, ey)
            cell, n = i * ky + j, kx * ky
            h = torch.bincount(cell, minlength=n).to(self.dtype)
            ux = _distinct(cell, x, n).to(self.dtype)
            uy = _distinct(cell, y, n).to(self.dtype)
            cx, qx = self.chi2_2d(x, ex[i], ex[i + 1] - ex[i], cell, h, ux, n)
            cy, qy = self.chi2_2d(y, ey[j], ey[j + 1] - ey[j], cell, h, uy, n)
            big = h > self.m
            fx = big & (ux > 1) & (cx > qx)
            fy = big & (uy > 1) & (cy > qy)
            rx = torch.where(fx, cx / torch.clamp(qx, min=1e-30), -1.0)
            ry = torch.where(fy, cy / torch.clamp(qy, min=1e-30), -1.0)
            px = fx & (~fy | (rx >= ry))
            py = fy & ~px
            ex2, nx = self._split(ex, px.reshape(kx, ky).any(1), cap)
            ey2, ny = self._split(ey, py.reshape(kx, ky).any(0), cap)
            ex, ey = ex2, ey2
            if nx + ny == 0:
                break
        return ex, ey

    @staticmethod
    def _split(e, want, cap):
        z = 0.5 * (e[:-1] + e[1:])
        ok = want & (z > e[:-1]) & (z < e[1:])
        ok &= torch.cumsum(ok.to(torch.int64), 0) <= cap - (e.numel() - 1)
        n = int(ok.sum())
        return (torch.sort(torch.cat([e, z[ok]])).values if n else e), n

    def slices(self, idx, v, e, k):
        h = torch.bincount(idx, minlength=k).to(self.dtype)
        u = _distinct(idx, v, k).to(self.dtype)
        vmin = torch.full((k,), math.inf, dtype=self.dtype, device=self.dev)
        vmax = torch.full((k,), -math.inf, dtype=self.dtype, device=self.dev)
        vmin = vmin.scatter_reduce(0, idx, v, "amin")
        vmax = vmax.scatter_reduce(0, idx, v, "amax")
        empty = h == 0
        return (h, u, torch.where(empty, e[:-1], vmin),
                torch.where(empty, e[1:], vmax))

    def pair(self, x, y, ex, ey) -> dict:
        ex, ey = self.refine_2d(x, y, ex, ey)
        kx, ky = ex.numel() - 1, ey.numel() - 1
        i, j = self.locate(x, ex), self.locate(y, ey)
        H = torch.bincount(i * ky + j, minlength=kx * ky).reshape(kx, ky)
        hx, ux, vminx, vmaxx = self.slices(i, x, ex, kx)
        hy, uy, vminy, vmaxy = self.slices(j, y, ey, ky)
        return {"ex": ex, "ey": ey, "kx": kx, "ky": ky,
                "H": H.to(self.dtype), "hx": hx, "ux": ux, "vminx": vminx,
                "vmaxx": vmaxx, "hy": hy, "uy": uy, "vminy": vminy,
                "vmaxy": vmaxy}


def _host(t):
    if isinstance(t, torch.Tensor):
        a = t.cpu().numpy()
        return a.astype(np.float64) if a.dtype.kind == "f" else a
    return np.asarray(t)


def _fold(edges_1d: np.ndarray, edges_pair: np.ndarray) -> np.ndarray:
    mid = 0.5 * (edges_1d[:-1] + edges_1d[1:])
    at = np.searchsorted(edges_pair, mid, side="right") - 1
    return np.clip(at, 0, max(edges_pair.size - 2, 0))


def build(data: np.ndarray, meta: list[dict], seeds: list[np.ndarray],
          params: dict, sample_seed: int, device="cpu",
          dtype=torch.float64) -> dict:
    """The synopsis of pre-processed ``data`` (``table.preprocess``) with
    GreedyGD seed edges ``seeds`` (``table.seed_edges``), build
    ``params`` (a configuration's ``build``) and ``sample_seed``:
    ``{"n_rows", "n_sampled", "n_null", "quantiles", "hists", "pairs"}``,
    host arrays (reals as float64) under the fields the synopsis has."""
    b = _Build(params, dtype, device)
    n, d = data.shape
    n_s = min(b.p["n_samples"], n)
    if n_s < n:
        rows = np.random.default_rng(sample_seed).choice(n, n_s,
                                                          replace=False)
        sample = data[rows]
    else:
        sample = data
    b.p["n_samples"] = n_s
    b.m = max(2, int(round(b.p["m_frac"] * n_s)))
    present = ~np.isnan(sample)

    xs = [torch.sort(b.real(sample[present[:, c], c])).values
          for c in range(d)]
    first = []
    for c in range(d):
        cats = (len(meta[c]["categories"])
                if meta[c]["kind"] == "categorical" else None)
        e0 = b.initial_edges(xs[c], seeds[c], cats)
        first.append(b.refine_1d(xs[c], e0))

    k2 = b.p["k2_cap"]
    cols = b.real(np.nan_to_num(sample))
    pairs = {}
    for bb in range(1, d):
        for a in range(bb):
            both = torch.as_tensor(present[:, a] & present[:, bb],
                                   device=b.dev)
            pairs[(a, bb)] = b.pair(cols[both, a], cols[both, bb],
                                    first[a][: k2 + 1], first[bb][: k2 + 1])

    hists = []
    for c in range(d):
        parts = [_host(first[c])]
        parts += [_host(p["ex"]) for (a, _), p in pairs.items() if a == c]
        parts += [_host(p["ey"]) for (_, bb), p in pairs.items() if bb == c]
        e = np.unique(np.concatenate(parts))
        e = e[np.isfinite(e)]
        if e.size > b.p["k1_cap"] + 1:
            at = np.linspace(0, e.size - 1, b.p["k1_cap"] + 1).round()
            e = e[np.unique(at.astype(int))]
        hists.append({f: _host(v) for f, v in
                      b.hist_1d(xs[c], b.real(e)).items()})
    out_pairs = {}
    for (a, bb), p in pairs.items():
        p = {f: _host(v) for f, v in p.items()}
        p["fold_x"] = _fold(hists[a]["edges"], p["ex"])
        p["fold_y"] = _fold(hists[bb]["edges"], p["ey"])
        out_pairs[(a, bb)] = p
    return {"n_rows": n, "n_sampled": n_s,
            "n_null": [int(n_s - present[:, c].sum()) for c in range(d)],
            "quantiles": b.q_np, "hists": hists, "pairs": out_pairs}


def reference(table: dict, params: dict, sample_seeds, device="cpu",
              dtype=torch.float64, gd: dict = ref_table.GREEDYGD) -> list:
    """One reference synopsis per sample seed, of the raw ``table``."""
    data, meta = ref_table.preprocess(table)
    seeds = ref_table.seed_edges(data, gd)
    return [build(data, meta, seeds, params, s, device, dtype)
            for s in sample_seeds]
