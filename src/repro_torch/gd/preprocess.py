"""GreedyGD pre-processing (§3 "Data Compression", Fig. 2).

Per-column, type-driven, and requiring no extra storage beyond tiny per-column
metadata (offset/scale/dictionary):

  * integers:      minimum-value subtraction;
  * floats:        fixed-point conversion (10.22 -> 1022) then min-subtraction;
  * categoricals:  frequency-ranked codes (most common -> 0, ties by the
                   value's code-point order, ...);
  * missing:       excluded via NaN; the null positions are carried in a
                   bitmap (storage) and as NaN in the working matrix.

Batch-friendly: ``preprocess_table`` accepts an iterable of column arrays; a
two-pass variant could stream batches, which we note rather than build (the
paper notes arbitrary batch sizes are possible, not a specific API).

Output values are non-negative integers stored as float64 (NaN = missing),
the domain PairwiseHist is built on, plus ``ColumnInfo`` used to encode query
literals (§5.1) and decode results.

A categorical column is coded by whole-column array operations: one sort of
its keys, one ``searchsorted`` of every row into the sorted unique keys, a
count of each and a stable rank by count. Its keys come from the column
itself, as its ``preprocess_categorical`` span's ``path`` says:

  * ``"packed"``:  a ``U`` column whose width times its largest code point's
                   bit length is at most 63: the code points packed into one
                   int64 a row, first character highest, so the keys sort as
                   the strings do (zero padding keeps "A" before "AB");
  * ``"values"``:  any other ``U`` column: the strings themselves;
  * ``"objects"``: ``S`` and ``O`` columns: each value made a ``str`` (bytes
                   as ``str(b"AA")``, ``None`` and float NaN missing), then
                   the strings; these rows are counted as
                   ``preprocess_str_rows`` (0 on the other paths).

A value equal to ``"\\0NULL\\0"`` is missing on every path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import ColumnInfo
from repro_torch.obs.timeline import count, span

_NULL = "\0NULL\0"   # the missing value of a categorical column


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
    ``preprocess_categorical`` (with its key ``path``) or
    ``preprocess_numeric`` span of the current timeline."""
    arr = np.asarray(values)
    if arr.dtype.kind not in ("U", "S", "O"):
        with span("preprocess_numeric", column=name):
            return _numeric(arr, name)
    with span("preprocess_categorical", column=name) as ev:
        if arr.dtype.kind == "U":
            keys, ev["path"] = _unicode_keys(arr)
            count("preprocess_str_rows", 0)
        else:
            arr = np.array([_NULL if v is None or (isinstance(v, float)
                            and np.isnan(v)) else str(v) for v in arr],
                           dtype=str)
            keys, ev["path"] = arr, "objects"
            count("preprocess_str_rows", arr.size)
        return _categorical(arr, keys, name)


def _unicode_keys(arr: np.ndarray):
    """A ``U`` column's sort keys and the path's name: its code points
    packed into one int64 a row where they fit, else the strings."""
    width = arr.dtype.itemsize // 4
    points = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("="))
    points = points.view(np.uint32).reshape(arr.size, width)
    bits = int(points.max()).bit_length() if points.size else 0
    if width * bits > 63:
        return arr, "values"
    keys = np.zeros(arr.size, np.int64)
    for j in range(width):
        keys <<= bits
        keys |= points[:, j]
    return keys, "packed"


def _categorical(arr: np.ndarray, keys: np.ndarray, name: str):
    """Frequency-ranked codes of a ``U`` column from its sort keys: most
    common -> 0, ties in sorted order, ``_NULL`` -> NaN."""
    uniq = np.unique(keys)
    inverse = np.searchsorted(uniq, keys)
    row = np.empty(uniq.size, np.intp)      # a row of each key
    row[inverse] = np.arange(inverse.size)
    values = arr[row]
    counts = np.bincount(inverse, minlength=uniq.size)
    kept = np.flatnonzero(values != _NULL)
    order = kept[np.argsort(-counts[kept], kind="stable")]
    rank = np.full(uniq.size, np.nan)
    rank[order] = np.arange(order.size)
    info = ColumnInfo(name=name, kind="categorical",
                      categories=tuple(values[order].tolist()), mu=1.0)
    return rank[inverse], info


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
