"""The reference's own pre-processing of a table and its GreedyGD seed
edges, written from their definitions (PairwiseHist, arXiv:2401.12018, Sec. 3
and Fig. 2) in plain NumPy. Nothing of the program is imported or read.

Pre-processing maps every column to non-negative integers held as float64,
NaN for a missing value:

  * a text column: codes by descending frequency, ties in sorted order;
  * an integral column: the value less the column's minimum;
  * any other numeric column: fixed point (the least power of ten, at most
    10^6, that makes every value integral to 1e-6), less its minimum.

GreedyGD splits each column's code into a base (its high bits) and a
deviation; the distinct bases, shifted back, are the column's seed edges.
Which bits go to the base is a greedy nibble search on a modelled size:

    bits(b) = n_bases(b) * sum(b) + n * max(1, ceil(log2 max(n_bases, 2)))
              + n * sum(w - b)

over ``GREEDYGD["search_rows"]`` rows drawn without replacement by NumPy's
``default_rng(GREEDYGD["search_seed"])``, starting from empty bases and
moving, while one lowers the size, the nibble of the column that lowers it
most (the first such column on a tie). A missing value is coded as its
column's largest code plus one.
"""
from __future__ import annotations

import math

import numpy as np

# GreedyGD as the configurations state it (``compression`` in each file).
GREEDYGD = {"nibble": 4, "search_rows": 20_000, "search_seed": 0,
            "max_moves": 512}


def _decimals_scale(x: np.ndarray) -> float:
    for p in range(7):
        y = x * 10 ** p
        if np.all(np.abs(y - np.round(y)) < 1e-6):
            return float(10 ** p)
    return 1e6


def preprocess(table: dict) -> tuple[np.ndarray, list[dict]]:
    """``{name: values}`` -> ((rows, d) float64 codes, NaN missing; one
    ``{"name", "kind", "categories"}`` a column)."""
    cols, meta = [], []
    for name, values in table.items():
        arr = np.asarray(values)
        if arr.dtype.kind in "USO":
            text = np.array([None if v is None or (isinstance(v, float)
                                                    and v != v) else str(v)
                             for v in arr], dtype=object)
            present = np.array([v is not None for v in text])
            names, counts = np.unique(text[present].astype(str),
                                      return_counts=True)
            ranked = names[np.argsort(-counts, kind="stable")]
            code = {v: float(i) for i, v in enumerate(ranked)}
            out = np.full(arr.shape, np.nan)
            out[present] = [code[v] for v in text[present]]
            cols.append(out)
            meta.append({"name": name, "kind": "categorical",
                         "categories": [str(v) for v in ranked]})
            continue
        x = arr.astype(np.float64)
        ok = np.isfinite(x)
        if not ok.any():
            cols.append(np.full(x.shape, np.nan))
            meta.append({"name": name, "kind": "int", "categories": []})
            continue
        integral = bool(np.all(np.abs(x[ok] - np.round(x[ok])) < 1e-9))
        scale = 1.0 if integral else _decimals_scale(x[ok])
        out = np.round(x * scale - float(np.min(x[ok]) * scale))
        out[~ok] = np.nan
        cols.append(out)
        meta.append({"name": name, "kind": "int" if integral else "float",
                     "categories": []})
    return np.stack(cols, axis=1), meta


def _codes(data: np.ndarray) -> np.ndarray:
    codes = np.empty(data.shape, np.uint64)
    for i in range(data.shape[1]):
        col = data[:, i]
        ok = np.isfinite(col)
        top = int(col[ok].max()) if ok.any() else 0
        codes[:, i] = np.where(ok, col, top + 1).astype(np.uint64)
    return codes


def _bits(codes: np.ndarray) -> np.ndarray:
    return np.array([max(1, int(v).bit_length()) for v in codes.max(axis=0)],
                    np.int64)


def _model_bits(n: int, widths, base, n_bases: int) -> int:
    ids = max(1, math.ceil(math.log2(max(n_bases, 2))))
    return int(n_bases * base.sum() + n * ids + n * (widths - base).sum())


def base_bits(codes: np.ndarray, gd: dict = GREEDYGD) -> np.ndarray:
    """GreedyGD's base width of every column."""
    n, d = codes.shape
    widths = _bits(codes)
    if n > gd["search_rows"]:
        rng = np.random.default_rng(gd["search_seed"])
        codes = codes[rng.choice(n, gd["search_rows"], replace=False)]
    n = codes.shape[0]
    base = np.zeros(d, np.int64)
    size = _model_bits(n, widths, base, 1)
    for _ in range(gd["max_moves"]):
        best = None
        for i in np.flatnonzero(base < widths):
            cand = base.copy()
            cand[i] = min(widths[i], cand[i] + gd["nibble"])
            high = codes >> (widths - cand).astype(np.uint64)
            n_bases = np.unique(high, axis=0).shape[0]
            bits = _model_bits(n, widths, cand, n_bases)
            if bits < size and (best is None or bits < best[0]):
                best = (bits, cand)
        if best is None:
            break
        size, base = best
    return base


def seed_edges(data: np.ndarray, gd: dict = GREEDYGD) -> list[np.ndarray]:
    """Every column's distinct GreedyGD bases, shifted back to values."""
    codes = _codes(data)
    shift = (_bits(codes) - base_bits(codes, gd)).astype(np.uint64)
    return [np.unique(codes[:, i] >> shift[i]).astype(np.float64)
            * float(2 ** int(shift[i])) for i in range(codes.shape[1])]
