"""Fused CUDA query fast path (beyond-paper optimization, §Perf).

The paper's execution model runs ~3 small ops per predicate (mat-vec, fold,
divide) plus a combine — at sub-ms latencies the launch/dispatch overhead
dominates. This path stacks all AND-ed predicates of a query and executes
ONE fused kernel per bound variant (estimate / lower / upper): the
hand-written weightings kernel on the CUDA device, its plain PyTorch
version when the ``FastPath`` was made with ``device="cpu"``.

``FastPath`` additionally exposes a *query-batched* entry (``batch``): a
group of queries sharing a plan shape (same agg column, same pair-predicate
column set) executes as ONE launch covering every query and all three bound
variants — the serving-layer analogue of the per-predicate fusion, used by
``repro_torch.serve.aqp.scheduler.BatchScheduler``.

Supported: AND trees of leaves (the dominant template in the paper's
workload). OR / nested trees return None -> engine falls back to the NumPy
reference path (repro_torch.core.weightings), which is also the oracle in tests.

Unlike the reference, the stacks are not padded to 128 lanes (that served
the TPU's matrix unit): they are exactly (L, K2max, K2max) and (L, K2max),
and the fold travels as its (L, K1) int32 index (``fold_x`` per predicate)
instead of the reference's dense one-hot (L, K1p, K2max) matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import coverage as covlib
from repro_torch.core import weightings as wlib
from repro_torch.device import resolve_device
from repro_torch.kernels.weightings import check_stack, stacked_weightings

Z_98 = wlib.Z_98


def _slice_beta(ph, leaf, h, u, vmin, vmax, mu):
    if isinstance(leaf, wlib.Consolidated):
        beta = covlib.coverage_intervals(leaf.intervals, h, u, vmin, vmax, mu)
    else:
        beta = covlib.coverage_single(leaf.op, leaf.value, h, u, vmin, vmax)
    blo, bhi = covlib.coverage_bounds(
        beta, h, u, ph.params.min_points, ph.chi2_table, ph.params.s1_max)
    return beta, blo, bhi


def _widen_clip(w, wlo, whi, ph, h, corrected):
    """Eq. 29 sampling widening + monotone clipping (same as the reference
    path). Broadcasts over leading batch dimensions: w/wlo/whi are (..., K1),
    h is (K1,)."""
    rho = ph.rho
    if rho < 1.0:
        fpc = (ph.n_rows - ph.n_sampled) / max(ph.n_rows - 1, 1)
        blo = np.divide(wlo, h, out=np.zeros_like(wlo), where=h > 0)
        bhi = np.divide(whi, h, out=np.zeros_like(whi), where=h > 0)
        var_lo = blo * (1.0 - blo) * fpc
        var_hi = bhi * (1.0 - bhi) * fpc
        if corrected:
            var_lo, var_hi = var_lo * h, var_hi * h
        wlo = wlo - Z_98 * np.sqrt(np.maximum(var_lo, 0.0))
        whi = whi + Z_98 * np.sqrt(np.maximum(var_hi, 0.0))
    wlo = np.clip(wlo, 0.0, w)
    whi = np.clip(whi, w, h)
    return w, wlo, whi


class FastPath:
    """Engine hook: (ph, agg_col, tree, corrected) -> weightings triple.

    The (H, fold index, hx) stacks depend only on (agg column, predicate
    columns), NOT on the query literals — they are device-resident
    constants of the synopsis, cached per column set on ``device`` and
    checked once when built; per query only the tiny beta vectors are
    assembled on the host and copied over.
    ``device=None`` means the CUDA device (raising without one).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)

    # ----------------------------------------------------------- shared stacks

    def _get_stack(self, ph, agg_col, pred_cols):
        # The stack cache lives ON the synopsis object: its lifetime is
        # exactly the synopsis's (a rebuild produces a new PairwiseHist, so
        # stale stacks can never be served and the old device arrays are
        # garbage-collected with the old synopsis). Keying an external dict
        # on id(ph) would leak per rebuild and could alias a recycled id.
        cache = getattr(ph, "_fastpath_stacks", None)
        if cache is None:
            cache = {}
            ph._fastpath_stacks = cache
        key = (agg_col, pred_cols, str(self.device))
        if key in cache:
            return cache[key]
        hist = ph.hists[agg_col]
        k1 = int(hist.k)
        prs = [ph.pair(agg_col, j) for j in pred_cols]
        k2max = max(max(p.H.shape) for p in prs)
        el = len(prs)
        hpad = np.zeros((el, k2max, k2max), np.float32)
        hxpad = np.zeros((el, k2max), np.float32)
        fidx = np.zeros((el, k1), np.int32)
        for li, pr in enumerate(prs):
            hpad[li, :pr.H.shape[0], :pr.H.shape[1]] = pr.H
            # per-row denominator = 1-D mass inside the row (incl. j-NULLs)
            denom = np.zeros(int(pr.kx))
            np.add.at(denom, pr.fold_x, hist.h)
            hxpad[li, :pr.H.shape[0]] = denom
            fidx[li] = pr.fold_x      # 1-D bin -> containing pair x-row
        entry = tuple(torch.as_tensor(a, device=self.device)
                      for a in (hpad, fidx, hxpad)) + (k1, k2max)
        check_stack(*entry[:3])
        cache[key] = entry
        return entry

    def _split_leaves(self, ph, agg_col, tree):
        """Pure-AND tree -> (same-col beta triples, pair leaves) or None."""
        leaves = wlib.flat_and_leaves(tree)
        if leaves is None:
            return None
        hist = ph.hists[agg_col]
        same_col = [[], [], []]   # per variant: (k1,) probs for j == agg_col
        pair_leaves = []
        for leaf in leaves:
            if leaf.col == agg_col:
                triple = _slice_beta(ph, leaf, hist.h, hist.u, hist.vmin,
                                     hist.vmax, ph.columns[leaf.col].mu)
                for idx in range(3):
                    same_col[idx].append(np.clip(triple[idx], 0.0, 1.0))
            else:
                pair_leaves.append(leaf)
        # Canonical (sorted-column) leaf order: the single and batched paths
        # then share one cached stack per column set regardless of the order
        # predicates appeared in the WHERE clause.
        pair_leaves.sort(key=lambda lf: lf.col)
        return same_col, pair_leaves

    def _pair_betas(self, ph, agg_col, pair_leaves, k2max):
        """(3, L, K2max) coverage matrix for one query's pair leaves."""
        el = len(pair_leaves)
        betas = np.zeros((3, el, k2max), np.float32)
        for li, leaf in enumerate(pair_leaves):
            pr = ph.pair(agg_col, leaf.col)
            triple = _slice_beta(ph, leaf, pr.hy, pr.uy, pr.vminy,
                                 pr.vmaxy, ph.columns[leaf.col].mu)
            for idx in range(3):
                betas[idx, li, :len(triple[idx])] = triple[idx]
        return betas

    def _pair_betas_batch(self, ph, agg_col, leaf_lists, k2max):
        """(B, 3, L, K2max) coverage stack for B same-shape queries.

        Vectorized per-leaf beta assembly: the B leaves on pair column
        ``li`` share the slice metadata (h, u, v-, v+), so simple-op leaves
        stack their literals into ONE broadcasted ``coverage_single`` +
        ``coverage_bounds`` evaluation per (column, operator) group —
        replacing the per-query-per-wave Python calls into ``_pair_betas``.
        Consolidated (interval-set) leaves keep the per-leaf path; they are
        the rarity in batched waves. Bit-for-bit equal to stacking
        ``_pair_betas`` per query (same elementwise arithmetic, broadcast
        over a leading batch axis).
        """
        nq = len(leaf_lists)
        el = len(leaf_lists[0])
        betas = np.zeros((nq, 3, el, k2max), np.float32)
        for li in range(el):
            leaves = [pls[li] for pls in leaf_lists]
            col = leaves[0].col
            pr = ph.pair(agg_col, col)
            h, u = pr.hy, pr.uy
            vmin, vmax = pr.vminy, pr.vmaxy
            k = len(np.asarray(h))
            mu = ph.columns[col].mu
            by_op: dict[str, list] = {}
            for qi, leaf in enumerate(leaves):
                if isinstance(leaf, wlib.Consolidated):
                    triple = _slice_beta(ph, leaf, h, u, vmin, vmax, mu)
                    for idx in range(3):
                        betas[qi, idx, li, :k] = triple[idx]
                else:
                    by_op.setdefault(leaf.op, []).append(qi)
            for op, qis in by_op.items():
                values = np.array([[leaves[qi].value] for qi in qis],
                                  float)                       # (Bg, 1)
                beta = covlib.coverage_single(op, values, h, u, vmin, vmax)
                blo, bhi = covlib.coverage_bounds(
                    beta, h, u, ph.params.min_points, ph.chi2_table,
                    ph.params.s1_max)
                rows = np.asarray(qis)
                for idx, arr in enumerate((beta, blo, bhi)):
                    betas[rows, idx, li, :k] = arr
        return betas

    # ------------------------------------------------------------ single query

    def __call__(self, ph, agg_col, tree, corrected):
        split = self._split_leaves(ph, agg_col, tree)
        if split is None:
            return None  # OR / nested: NumPy reference path
        same_col, pair_leaves = split
        hist = ph.hists[agg_col]
        h = np.asarray(hist.h, np.float64)

        outs = []
        if pair_leaves:
            pred_cols = tuple(lf.col for lf in pair_leaves)
            hpad, fidx, hxpad, k1c, k2max = self._get_stack(
                ph, agg_col, pred_cols)
            betas = torch.as_tensor(
                self._pair_betas(ph, agg_col, pair_leaves, k2max),
                device=self.device)                         # (3, L, K2)
            prob1 = torch.empty((3, k1c), dtype=torch.float32,
                                device=self.device)
            for idx in range(3):   # one launch per bound variant
                stacked_weightings(hpad, betas[idx:idx + 1], fidx, hxpad,
                                   "fused_weightings",
                                   out=prob1[idx:idx + 1])
            prob1 = prob1.cpu().numpy()
            for idx in range(3):
                w = h * prob1[idx]
                for prob in same_col[idx]:
                    w = w * prob
                outs.append(np.asarray(w, np.float64))
        else:
            for idx in range(3):
                w = h.copy()
                for prob in same_col[idx]:
                    w = w * prob
                outs.append(w)
        w, wlo, whi = outs
        return _widen_clip(w, wlo, whi, ph, h, corrected)

    # ------------------------------------------------------------- query batch

    def batch(self, ph, agg_col, trees, corrected):
        """One fused launch for B same-shape queries (x3 bound variants).

        Every tree must be a pure AND with an identical pair-predicate column
        *set* (same-column leaves are free to differ — they apply as
        elementwise products outside the kernel). Returns a list of
        (w, wlo, whi) triples aligned with ``trees``, or None if any tree is
        ineligible (caller falls back to per-query execution).
        """
        splits = []
        pair_cols = None
        for tree in trees:
            split = self._split_leaves(ph, agg_col, tree)
            if split is None:
                return None
            same_col, pair_leaves = split
            cols = tuple(lf.col for lf in pair_leaves)   # already sorted
            if len(set(cols)) != len(cols):
                return None  # duplicate pair col: un-consolidated shape
            if pair_cols is None:
                pair_cols = cols
            elif cols != pair_cols:
                return None
            splits.append((same_col, pair_leaves))

        hist = ph.hists[agg_col]
        h = np.asarray(hist.h, np.float64)
        nq = len(splits)

        if pair_cols:
            hpad, fidx, hxpad, k1c, k2max = self._get_stack(
                ph, agg_col, pair_cols)
            betas = self._pair_betas_batch(
                ph, agg_col, [pls for _, pls in splits], k2max)  # (B,3,L,K2)
            flat = torch.as_tensor(
                betas.reshape(nq * 3, len(pair_cols), k2max),
                device=self.device)
            prob1 = stacked_weightings(hpad, flat, fidx, hxpad,
                                       "batched_weightings").cpu().numpy()
            prob1 = prob1.reshape(nq, 3, k1c)               # (B, 3, K1)
        else:
            prob1 = np.ones((nq, 3, int(hist.k)))

        out = []
        for qi, (same_col, _) in enumerate(splits):
            triple = []
            for idx in range(3):
                w = h * np.asarray(prob1[qi, idx], np.float64)
                for prob in same_col[idx]:
                    w = w * prob
                triple.append(w)
            out.append(_widen_clip(*triple, ph, h, corrected))
        return out


def make_fastpath(device=None) -> FastPath:
    """Returns the engine hook (kept for parity with the reference's
    ``make_fastpath``); ``device=None`` means the CUDA device."""
    return FastPath(device=device)
