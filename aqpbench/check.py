"""How ``correct`` is decided: the synopses that the timed window built,
against the plain reference (``aqpbench.reference``), which pre-processes
the benchmark's own table, finds its GreedyGD bases and builds the synopsis
again from the same sample seed. Nothing the program made is read by the
reference; the program's synopsis is read only here, to be judged.

Numbers compared (each against a limit from the configuration file):

  * ``synopsis_gap`` — over every field of the checked builds' synopses
    (the row and sample counts, each column's missing count, the chi-squared
    quantiles, the 1-D edges and bin metadata with the centre bounds, the
    pair edges, cell counts, slice metadata and folds): the largest
    ``max|got - want|`` over ``max|want|`` of a field; 1.0 where a field's
    shape differs, a pair is missing or a value is finite on one side only;
  * ``missing`` — builds of the window that failed (limit 0).
"""
from __future__ import annotations

import numpy as np

from aqpbench.reference import synopsis as ref


def field_gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return 1.0
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    if same.all():
        return 0.0
    finite = np.isfinite(got) & np.isfinite(want)
    if not finite[~same].all():
        return 1.0
    scale = float(np.max(np.abs(want[finite])))
    diff = float(np.max(np.abs(got[~same] - want[~same])))
    return diff / scale if scale > 0 else 1.0


def fields(ph) -> dict:
    """The program's synopsis ``ph`` under the reference's fields, as host
    arrays: what is judged."""
    return {"n_rows": ph.n_rows, "n_sampled": ph.n_sampled,
            "n_null": [c.n_null for c in ph.columns],
            "quantiles": np.asarray(ph.chi2_table),
            "hists": [{f: np.asarray(getattr(h, f)) for f in ref.HIST_FIELDS}
                      for h in ph.hists],
            "pairs": {key: {f: np.asarray(getattr(p, f))
                            for f in ref.PAIR_FIELDS}
                      for key, p in ph.pairs.items()}}


def synopsis_gap(got: dict, want: dict) -> float:
    """The largest relative gap of any field of synopsis ``got`` from the
    reference's ``want`` (both as ``reference.synopsis.build`` returns)."""
    if set(got["pairs"]) != set(want["pairs"]) or \
            len(got["hists"]) != len(want["hists"]):
        return 1.0
    gaps = [field_gap(got[f], want[f])
            for f in ("n_rows", "n_sampled", "n_null", "quantiles")]
    for hg, hw in zip(got["hists"], want["hists"]):
        gaps += [field_gap(hg[f], hw[f]) for f in ref.HIST_FIELDS]
    for key, pw in want["pairs"].items():
        gaps += [field_gap(got["pairs"][key][f], pw[f])
                 for f in ref.PAIR_FIELDS]
    return max(gaps)
