"""Comparison baselines.

DeepDB and DBEst++ (the paper's baselines) are unavailable offline; we
implement the two classical families they descend from, which bracket the
design space the paper argues against:

  * ``SamplingAQP``  — offline uniform-sample AQP (BlinkDB-family): evaluate
    the query exactly on an n-row sample, scale counts/sums by 1/rho, CLT
    bounds. Strong on accuracy per byte, weak on skew/outliers.
  * ``HistProductAQP`` — classical synopsis AQP: independent per-column
    equi-depth histograms, selectivity = product of marginal coverages
    (attribute-value independence) — what PairwiseHist's 2-D histograms fix.

Both expose the same .query(sql) -> (est, lo, hi) and .size_bytes() API as
the PairwiseHist engine, so benchmarks sweep engines uniformly.
"""
from __future__ import annotations

import numpy as np

from repro_torch.aqp.exact import ExactEngine
from repro_torch.core import sql as sqlmod

_Z98 = 2.3263478740408408


class SamplingAQP:
    def __init__(self, table: dict, n_sample: int = 100_000, seed: int = 0):
        self.n = len(next(iter(table.values())))
        rng = np.random.default_rng(seed)
        take = min(n_sample, self.n)
        idx = rng.choice(self.n, take, replace=False)
        self.sample = {k: np.asarray(v)[idx] for k, v in table.items()}
        self.rho = take / self.n
        self._exact = ExactEngine(self.sample)

    def size_bytes(self) -> int:
        total = 0
        for v in self.sample.values():
            arr = np.asarray(v)
            if arr.dtype.kind in ("U", "S", "O"):
                total += sum(len(str(x)) for x in arr[:1000]) * (len(arr) // 1000 + 1)
            else:
                total += arr.astype(np.float64).nbytes
        return total

    def query(self, sql_text: str):
        q = sqlmod.parse_sql(sql_text)
        mask = self._exact._mask(q.where)
        est = self._exact._agg(q.func, q.agg_col, mask)
        if est is None:
            return None, None, None
        n_match = float(mask.sum())
        if q.func in ("COUNT", "SUM"):
            est = est / self.rho
            # CLT bound on the match count (binomial, finite population).
            p = n_match / max(len(mask), 1)
            se = np.sqrt(max(p * (1 - p) * len(mask), 0.0)) / self.rho
            if q.func == "COUNT":
                return est, max(est - _Z98 * se, 0.0), est + _Z98 * se
            mean = est / max(n_match / self.rho, 1.0)
            return est, est - _Z98 * se * abs(mean), est + _Z98 * se * abs(mean)
        if q.func == "AVG":
            col = self.sample[q.agg_col].astype(np.float64)
            v = col[mask & np.isfinite(col)]
            se = v.std() / np.sqrt(max(v.size, 1))
            return est, est - _Z98 * se, est + _Z98 * se
        return est, est, est  # MIN/MAX/MEDIAN/VAR: sample value, no real bound


class HistProductAQP:
    """Per-column equi-depth histograms + independence assumption."""

    def __init__(self, table: dict, n_sample: int = 100_000, bins: int = 64,
                 seed: int = 0):
        self.n = len(next(iter(table.values())))
        rng = np.random.default_rng(seed)
        take = min(n_sample, self.n)
        idx = rng.choice(self.n, take, replace=False)
        self.rho = take / self.n
        self.bins = bins
        self.hists = {}
        self.cats = {}
        for name, col in table.items():
            arr = np.asarray(col)[idx]
            if arr.dtype.kind in ("U", "S", "O"):
                vals, counts = np.unique(arr.astype(str), return_counts=True)
                self.cats[name] = (vals, counts.astype(np.float64))
                continue
            x = arr.astype(np.float64)
            x = x[np.isfinite(x)]
            if x.size == 0:
                continue
            qs = np.quantile(x, np.linspace(0, 1, bins + 1))
            edges = np.unique(qs)
            h, _ = np.histogram(x, bins=edges)
            mids = 0.5 * (edges[:-1] + edges[1:])
            self.hists[name] = (edges, h.astype(np.float64), mids, x.size)

    def size_bytes(self) -> int:
        total = 0
        for edges, h, mids, _ in self.hists.values():
            total += edges.nbytes + h.nbytes
        for vals, counts in self.cats.values():
            total += sum(len(v) for v in vals) + counts.nbytes
        return total

    def _cond_fraction(self, cond: sqlmod.RawCond) -> float:
        """Marginal selectivity of one condition."""
        if cond.col in self.cats:
            vals, counts = self.cats[cond.col]
            total = counts.sum()
            match = counts[vals == str(cond.value)].sum()
            frac = match / max(total, 1.0)
            return frac if cond.op == "=" else 1.0 - frac
        if cond.col not in self.hists:
            return 0.0
        edges, h, mids, n = self.hists[cond.col]
        v = float(cond.value)
        total = h.sum()
        lo, hi = edges[:-1], edges[1:]
        width = np.maximum(hi - lo, 1e-300)
        if cond.op in ("<", "<="):
            frac_bin = np.clip((v - lo) / width, 0, 1)
        elif cond.op in (">", ">="):
            frac_bin = np.clip((hi - v) / width, 0, 1)
        else:
            inside = (lo <= v) & (v <= hi)
            frac_bin = np.where(inside, np.minimum(1.0 / np.maximum(h, 1), 1.0), 0.0)
            if cond.op in ("!=", "<>"):
                frac_bin = 1.0 - frac_bin
        return float((h * frac_bin).sum() / max(total, 1.0))

    def _selectivity(self, node) -> float:
        if node is None:
            return 1.0
        if isinstance(node, sqlmod.RawCond):
            return self._cond_fraction(node)
        fracs = [self._selectivity(ch) for ch in node.children]
        if node.kind == "and":
            out = 1.0
            for f in fracs:
                out *= f
            return out
        out = 1.0
        for f in fracs:
            out *= (1.0 - f)
        return 1.0 - out

    def _weighted_hist(self, col: str, node):
        """Weight the aggregation column's own histogram by its own
        conditions exactly; other columns contribute a scalar selectivity."""
        edges, h, mids, n = self.hists[col]
        w = h.astype(np.float64).copy()
        scalar = 1.0
        conds_self, others = [], []

        def walk(nd, own, oth):
            if nd is None:
                return
            if isinstance(nd, sqlmod.RawCond):
                (own if nd.col == col else oth).append(nd)
                return
            for ch in nd.children:
                walk(ch, own, oth)

        walk(node, conds_self, others)
        lo, hi = edges[:-1], edges[1:]
        width = np.maximum(hi - lo, 1e-300)
        for cond in conds_self:
            v = float(cond.value)
            if cond.op in ("<", "<="):
                w = w * np.clip((v - lo) / width, 0, 1)
            elif cond.op in (">", ">="):
                w = w * np.clip((hi - v) / width, 0, 1)
            elif cond.op == "=":
                w = w * np.where((lo <= v) & (v <= hi), 1.0 / np.maximum(h, 1), 0.0)
            else:
                w = w * (1 - np.where((lo <= v) & (v <= hi), 1.0 / np.maximum(h, 1), 0.0))
        for cond in others:
            scalar *= self._cond_fraction(cond)
        return w * scalar, mids

    def query(self, sql_text: str):
        q = sqlmod.parse_sql(sql_text)
        if q.func == "COUNT":
            sel = self._selectivity(q.where)
            est = sel * self.n
            return est, None, None
        if q.agg_col not in self.hists:
            return None, None, None
        w, mids = self._weighted_hist(q.agg_col, q.where)
        tot = w.sum()
        if tot <= 0:
            return None, None, None
        if q.func == "SUM":
            return float(w @ mids / self.rho), None, None
        if q.func == "AVG":
            return float(w @ mids / tot), None, None
        if q.func == "VAR":
            m = w @ mids / tot
            return float(w @ (mids**2) / tot - m**2), None, None
        nz = np.flatnonzero(w > 1e-9)
        edges = self.hists[q.agg_col][0]
        if q.func == "MIN":
            return float(edges[nz[0]]), None, None
        if q.func == "MAX":
            return float(edges[nz[-1] + 1]), None, None
        cum = np.cumsum(w)
        t = int(np.searchsorted(cum, 0.5 * tot))
        return float(mids[min(t, len(mids) - 1)]), None, None
