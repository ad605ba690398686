"""GreedyGD pre-processing (§3 "Data Compression", Fig. 2).

Per-column, type-driven, and requiring no extra storage beyond tiny per-column
metadata (offset/scale/dictionary):

  * integers:      minimum-value subtraction;
  * floats:        fixed-point conversion (10.22 -> 1022) then min-subtraction;
  * categoricals:  frequency-ranked codes (most common -> 0, ...);
  * missing:       excluded via NaN; the null positions are carried in a
                   bitmap (storage) and as NaN in the working matrix.

Batch-friendly: ``preprocess_table`` accepts an iterable of column arrays; a
two-pass variant could stream batches, which we note rather than build (the
paper notes arbitrary batch sizes are possible, not a specific API).

Output values are non-negative integers stored as float64 (NaN = missing),
the domain PairwiseHist is built on, plus ``ColumnInfo`` used to encode query
literals (§5.1) and decode results.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import ColumnInfo
from repro_torch.obs.timeline import count, span


class Preprocessed:
    """Pre-processed table: integer-domain matrix + per-column metadata."""

    def __init__(self, data: np.ndarray, columns: list):
        self.data = data          # (N, d) f64, NaN for missing
        self.columns = columns    # list[ColumnInfo]

    @property
    def n_rows(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]


def _float_scale(x: np.ndarray, max_decimals: int = 6) -> float:
    """Smallest power of ten making every value integral (10.22 -> 1022)."""
    finite = x[np.isfinite(x)]
    for p in range(max_decimals + 1):
        scaled = finite * 10**p
        if np.all(np.abs(scaled - np.round(scaled)) < 1e-6):
            return float(10**p)
    return float(10**max_decimals)


def preprocess_column(values, name: str):
    """One column -> (f64 codes with NaN, ColumnInfo), in a
    ``preprocess_categorical`` or ``preprocess_numeric`` span of the
    current timeline."""
    arr = np.asarray(values)
    categorical = arr.dtype.kind in ("U", "S", "O")
    with span("preprocess_categorical" if categorical
              else "preprocess_numeric", column=name):
        if categorical:
            return _categorical(arr, name)
        return _numeric(arr, name)


def _categorical(arr: np.ndarray, name: str):
    str_vals = np.array(["\0NULL\0" if v is None or (isinstance(v, float)
                         and np.isnan(v)) else str(v) for v in arr])
    null = str_vals == "\0NULL\0"
    vals, counts = np.unique(str_vals[~null], return_counts=True)
    order = np.argsort(-counts, kind="stable")  # frequency-ranked
    ranked = vals[order]
    lut = {v: i for i, v in enumerate(ranked)}
    out = np.full(arr.shape, np.nan)
    out[~null] = [lut[v] for v in str_vals[~null]]
    info = ColumnInfo(name=name, kind="categorical",
                      categories=tuple(ranked.tolist()), mu=1.0)
    return out, info


def _numeric(arr: np.ndarray, name: str):
    x = arr.astype(np.float64)
    null = ~np.isfinite(x)
    finite = x[~null]
    if finite.size == 0:
        return np.full(arr.shape, np.nan), ColumnInfo(name=name, kind="int")
    integral = np.all(np.abs(finite - np.round(finite)) < 1e-9)
    scale = 1.0 if integral else _float_scale(finite)
    kind = "int" if integral else "float"
    offset = float(np.min(finite) * scale)
    out = x * scale - offset
    out[null] = np.nan
    info = ColumnInfo(name=name, kind=kind, offset=offset, scale=scale, mu=1.0)
    return np.round(out), info


def preprocess_table(table: dict) -> Preprocessed:
    """{name: column array} -> Preprocessed (column order preserved); its
    rows are counted as ``preprocess_rows`` on the current timeline."""
    cols, mats = [], []
    for name, values in table.items():
        codes, info = preprocess_column(values, name)
        mats.append(codes)
        cols.append(info)
    out = Preprocessed(np.stack(mats, axis=1), cols)
    count("preprocess_rows", out.n_rows)
    return out
