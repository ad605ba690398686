"""Bin weightings (§5.3): Eq. 24–29.

Given aggregation column i and a predicate tree, weightings w^(i) estimate
how many points in each 1-D bin of column i satisfy the predicate:

    leaf on column j != i:  p = fold( H^(ij) @ beta^(j) ) / h^(i)     (Eq. 27)
    leaf on column j == i:  p = beta^(i)           (same-column: direct)
    AND:  p = prod_l p_l                                              (Eq. 25)
    OR:   p = 1 - prod_l (1 - p_l)                                    (Eq. 26)
    w = h^(i) * p                                                     (Eq. 24)

Bounds propagate through AND/OR monotonically (all p in [0,1]); Eq. 29 widens
them for sampling when rho < 1.

NumPy implementation (kernel oracle). The fused CUDA path is
``repro_torch.core.fastpath`` / ``repro_torch.kernels.weightings``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import coverage as covlib

Z_98 = 2.3263478740408408  # standard normal quantile for two-sided 98% CI


# ---------------------------------------------------------------------------
# Normalized predicate tree (planner output; see repro_torch.core.query)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Leaf:
    """A single condition on one column."""

    col: int
    op: str
    value: float


@dataclasses.dataclass
class Consolidated:
    """A same-column group merged into a disjoint interval set (§5.2)."""

    col: int
    intervals: list


@dataclasses.dataclass
class Node:
    """AND / OR of children."""

    kind: str          # "and" | "or"
    children: list


def flat_and_leaves(tree):
    """Tree -> list of Leaf/Consolidated if it is a pure AND tree, else None.

    Pure AND trees are the batchable/fusable plan shape (repro_torch.core.fastpath
    and the serving BatchScheduler); OR/nested trees evaluate via eval_tree.
    """
    if isinstance(tree, (Leaf, Consolidated)):
        return [tree]
    if isinstance(tree, Node) and tree.kind == "and":
        out = []
        for ch in tree.children:
            sub = flat_and_leaves(ch)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


# ---------------------------------------------------------------------------
# Leaf probabilities
# ---------------------------------------------------------------------------


def _slice_beta(ph, leaf, h, u, vmin, vmax, mu):
    """Coverage + bounds of a Leaf/Consolidated on a given bin grid."""
    if isinstance(leaf, Consolidated):
        beta = covlib.coverage_intervals(leaf.intervals, h, u, vmin, vmax, mu)
    else:
        beta = covlib.coverage_single(leaf.op, leaf.value, h, u, vmin, vmax)
    blo, bhi = covlib.coverage_bounds(
        beta, h, u, ph.params.min_points, ph.chi2_table, ph.params.s1_max)
    return beta, blo, bhi


def leaf_prob(ph, agg_col: int, leaf):
    """Pr(P_l | bin t of 1-D hist agg_col) with bounds — Eq. 27 + fold."""
    j = leaf.col
    hist_i = ph.hists[agg_col]
    mu_j = ph.columns[j].mu
    if j == agg_col:
        beta = _slice_beta(ph, leaf, hist_i.h, hist_i.u, hist_i.vmin,
                           hist_i.vmax, mu_j)
        return beta  # (p, plo, phi) directly on the 1-D grid

    pr = ph.pair(agg_col, j)  # x-dim = agg_col, y-dim = j
    beta, blo, bhi = _slice_beta(ph, leaf, pr.hy, pr.uy, pr.vminy, pr.vmaxy,
                                 mu_j)
    # Denominator: the 1-D mass of each pair row — this *includes* rows
    # where column j is NULL (they fail the predicate; SQL semantics), which
    # hx excludes. Matches Eq. 27's h^(i) conditioning.
    denom = np.zeros(int(pr.kx))
    np.add.at(denom, pr.fold_x, hist_i.h)
    denom = np.maximum(denom, 1e-300)

    def fold(b):
        v = pr.H @ b                               # (kx,) matching mass
        p_row = np.clip(v / denom, 0.0, 1.0)       # Pr(P | pair x-row)
        return p_row[pr.fold_x]                    # gather onto the 1-D grid

    return fold(beta), fold(blo), fold(bhi)


# ---------------------------------------------------------------------------
# Tree evaluation
# ---------------------------------------------------------------------------


def eval_tree(ph, agg_col: int, node):
    """Returns (p, plo, phi), each (k_i,)."""
    if isinstance(node, (Leaf, Consolidated)):
        return leaf_prob(ph, agg_col, node)
    ps = [eval_tree(ph, agg_col, ch) for ch in node.children]
    if node.kind == "and":
        p = np.prod([x[0] for x in ps], axis=0)
        lo = np.prod([x[1] for x in ps], axis=0)
        hi = np.prod([x[2] for x in ps], axis=0)
    elif node.kind == "or":
        p = 1.0 - np.prod([1.0 - x[0] for x in ps], axis=0)
        lo = 1.0 - np.prod([1.0 - x[1] for x in ps], axis=0)
        hi = 1.0 - np.prod([1.0 - x[2] for x in ps], axis=0)
    else:
        raise ValueError(node.kind)
    return p, lo, hi


def weightings(ph, agg_col: int, tree, corrected_sampling_bounds: bool = False):
    """Full weightings vector + bounds for a query (Eq. 24–29).

    ``tree`` may be None (no WHERE clause): w = h, exact bounds.
    """
    hist = ph.hists[agg_col]
    h = hist.h
    if tree is None:
        return h.copy(), h.copy(), h.copy()
    p, plo, phi = eval_tree(ph, agg_col, tree)
    w = h * p
    wlo = h * plo
    whi = h * phi

    rho = ph.rho
    if rho < 1.0:
        # Eq. 29: widen by the two-sided 98% normal CI with finite-population
        # correction. Faithful mode uses the equation as printed; corrected
        # mode restores the binomial count-variance scale factor h_t.
        fpc = (ph.n_rows - ph.n_sampled) / max(ph.n_rows - 1, 1)
        blo = np.divide(wlo, h, out=np.zeros_like(wlo), where=h > 0)
        bhi = np.divide(whi, h, out=np.zeros_like(whi), where=h > 0)
        var_lo = blo * (1.0 - blo) * fpc
        var_hi = bhi * (1.0 - bhi) * fpc
        if corrected_sampling_bounds:
            var_lo = var_lo * h
            var_hi = var_hi * h
        wlo = wlo - Z_98 * np.sqrt(np.maximum(var_lo, 0.0))
        whi = whi + Z_98 * np.sqrt(np.maximum(var_hi, 0.0))

    wlo = np.clip(wlo, 0.0, w)
    whi = np.clip(whi, w, h)
    return w, wlo, whi
