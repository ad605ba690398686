"""Core data structures for the PairwiseHist synopsis.

Runtime (in-memory) representation, field for field the reference
package's. ``c``/``c±`` (midpoints / weighted-centre bounds) are re-derivable
(§4.3) and are cached here.

Histogram structs are NamedTuples of trimmed NumPy arrays; construction
works on fixed-capacity, +inf-padded torch tensors and trims on the host.
``synopsis_from_numpy`` copies a synopsis built by the reference package
into these types without importing it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------------------
# Build-time parameters (Table 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BuildParams:
    """Static construction parameters (Table 2 + capacity knobs).

    The paper's defaults (§6): ``m_frac = 0.01`` (M = 1% of N_s) and
    ``alpha = 0.001``.
    """

    n_samples: int = 100_000          # N_s
    m_frac: float = 0.01              # M = max(2, m_frac * N_s)
    alpha: float = 0.001              # hypothesis-test significance
    seed: int = 0                     # sampling seed
    # Fixed capacities of the padded construction buffers.
    k1_cap: int = 512                 # max 1-D bins per column
    k2_cap: int = 256                 # max 2-D bins per dimension
    s1_max: int = 128                 # max sub-bins, 1-D tests  (>= (2N_s)^(1/3))
    s2_max: int = 32                  # max sub-bins, 2-D tests
    max_rounds_1d: int = 64           # refinement rounds (== max recursion depth)
    max_rounds_2d: int = 16
    # Pair-batched construction (the 2-D hot path). ``pair_chunk`` bounds how
    # many pairs refine per round (memory ~ pair_chunk * k2_cap^2 * s2_max);
    # it rounds DOWN to a power of two so the memory bound is honoured.
    # pair_batched=False selects the per-pair loop, the compacting
    # scheduler's bit-for-bit oracle; both give the same synopsis.
    pair_batched: bool = True         # compacting scheduler vs per-pair loop
    pair_chunk: int = 8               # compacting slots (pow-2)
    # Adaptive 2-D capacity: each pair refines at the smallest rung of the
    # doubling ladder k2_start, 2*k2_start, ..., k2_cap that fits its
    # initial grids, escalating only when the capacity guard binds (the
    # result is capacity-independent otherwise). Real pair grids are tens of
    # bins, so the k2_cap^2 * s2_max chi-squared workspace shrinks ~16x.
    k2_start: int = 64                # first rung of the capacity ladder

    @property
    def min_points(self) -> int:
        """M — minimum points for a bin to be split."""
        return max(2, int(round(self.m_frac * self.n_samples)))


# ---------------------------------------------------------------------------
# Histogram structs
# ---------------------------------------------------------------------------


class Hist1D(NamedTuple):
    """One-dimensional histogram for one column (fixed capacity K).

    Valid bins are ``t in [0, k)``; bin ``t`` spans ``[edges[t], edges[t+1])``
    (last valid bin right-closed). Padding: ``edges[k+1:] = +inf``.
    """

    edges: np.ndarray   # (K+1,) f64, sorted, +inf padded
    k: np.ndarray       # ()    i32, number of valid bins
    h: np.ndarray       # (K,)  f64, bin counts
    u: np.ndarray       # (K,)  f64, unique-value counts
    vmin: np.ndarray    # (K,)  f64, per-bin minimum data value (v^-)
    vmax: np.ndarray    # (K,)  f64, per-bin maximum data value (v^+)
    c: np.ndarray       # (K,)  f64, midpoints (derived, cached)
    cminus: np.ndarray  # (K,)  f64, weighted-centre lower bound (Eq. 10)
    cplus: np.ndarray   # (K,)  f64, weighted-centre upper bound (Eq. 10)


class PairHist(NamedTuple):
    """Two-dimensional histogram for a column pair (i, j), i = x-dim, j = y-dim.

    ``H[tx, ty]`` counts points with x in x-bin tx, y in y-bin ty.
    Slice metadata aggregates over one dimension (everything the coverage and
    weightings math needs): e.g. ``hx[tx]`` is the row total,
    ``ux[tx]``/``vminx``/``vmaxx`` the unique count / extrema of x values in
    that row slice.

    ``fold_x[t]`` maps 1-D bin t of column i onto the pair x-row containing
    it (the 1-D grids are union-refined over all their pairs' edges at build
    time, so pair edges ⊆ 1-D edges and containment is exact). This realizes
    ``Pr(P_l | 1-D bin t) = [H^(ij) β^(j)]_{row(t)} / hx_{row(t)}`` — Eq. 27
    evaluated at the refined grid (the paper's Fig. 4 per-dimension 2-D
    metadata story).
    """

    ex: np.ndarray      # (K2+1,) f64 x-dim edges (+inf padded)
    ey: np.ndarray      # (K2+1,) f64 y-dim edges
    kx: np.ndarray      # () i32
    ky: np.ndarray      # () i32
    H: np.ndarray       # (K2, K2) f64 bin counts
    hx: np.ndarray      # (K2,) f64 row totals
    ux: np.ndarray      # (K2,) f64 unique x per row slice
    vminx: np.ndarray   # (K2,) f64
    vmaxx: np.ndarray   # (K2,) f64
    hy: np.ndarray      # (K2,) f64 column totals
    uy: np.ndarray      # (K2,) f64
    vminy: np.ndarray   # (K2,) f64
    vmaxy: np.ndarray   # (K2,) f64
    fold_x: np.ndarray  # (K2,) i32 x-row -> 1-D bin of column i
    fold_y: np.ndarray  # (K2,) i32 y-col -> 1-D bin of column j


# ---------------------------------------------------------------------------
# Host-side container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnInfo:
    """Per-column bookkeeping carried from GD pre-processing into queries."""

    name: str
    kind: str                 # "int" | "float" | "categorical"
    offset: float = 0.0       # subtracted minimum (pre-processed = raw*scale - offset)
    scale: float = 1.0        # float->int multiplier (10**p)
    categories: tuple = ()    # frequency-ranked category values (code -> value)
    n_null: int = 0           # null count (nulls are excluded from histograms)
    mu: float = 1.0           # minimum value spacing in pre-processed domain

    def encode(self, value):
        """Raw literal -> pre-processed domain."""
        if self.kind == "categorical":
            try:
                return float(self.categories.index(value))
            except ValueError:
                return float("nan")  # unseen literal: matches nothing
        # Clear float noise (10.22*100 -> 1022.0000000000001) but keep
        # off-grid literals (e.g. "> 18.65" with scale 10) intact.
        # np.round rather than builtin round so the scalar path and the
        # template batch-bind path (np.round over a literal matrix) share
        # one rounding algorithm elementwise — bit-for-bit by construction.
        return float(np.round(float(value) * self.scale - self.offset, 6))

    def decode(self, value: float):
        """Pre-processed domain -> raw domain (for result reporting)."""
        if self.kind == "categorical":
            idx = int(round(value))
            if 0 <= idx < len(self.categories):
                return self.categories[idx]
            return None
        return (value + self.offset) / self.scale


@dataclasses.dataclass
class PairwiseHist:
    """The complete synopsis: d 1-D histograms + d(d-1)/2 pair histograms."""

    params: BuildParams
    n_rows: int                         # N  (full dataset)
    n_sampled: int                      # N_s actually used
    columns: list                       # list[ColumnInfo]
    hists: list                         # list[Hist1D]   (numpy, trimmed to k)
    pairs: dict                         # {(i, j) i<j : PairHist} (numpy, trimmed)
    chi2_table: np.ndarray              # chi2 critical values, indexed by s
    # Construction telemetry (pair-phase wall time, mode, launch sizes);
    # in-memory only, not serialized.
    build_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def d(self) -> int:
        return len(self.columns)

    @property
    def rho(self) -> float:
        """Sampling ratio rho = N_s / N."""
        return self.n_sampled / max(1, self.n_rows)

    def col_index(self, name: str) -> int:
        for idx, col in enumerate(self.columns):
            if col.name == name:
                return idx
        raise KeyError(f"unknown column {name!r}")

    def pair(self, i: int, j: int) -> PairHist:
        """The pair histogram with x-dim = i, y-dim = j (transposing if needed)."""
        if i == j:
            raise ValueError("no pair histogram for identical columns")
        if (i, j) in self.pairs:
            return self.pairs[(i, j)]
        p = self.pairs[(j, i)]
        return PairHist(
            ex=p.ey, ey=p.ex, kx=p.ky, ky=p.kx, H=p.H.T,
            hx=p.hy, ux=p.uy, vminx=p.vminy, vmaxx=p.vmaxy,
            hy=p.hx, uy=p.ux, vminy=p.vminx, vmaxy=p.vmaxx,
            fold_x=p.fold_y, fold_y=p.fold_x,
        )

    def nbytes_runtime(self) -> int:
        """In-memory (runtime) footprint; the encoded size comes from storage.py."""
        total = 0
        for hist in self.hists:
            total += sum(np.asarray(a).nbytes for a in hist)
        for p in self.pairs.values():
            total += sum(np.asarray(a).nbytes for a in p)
        total += self.chi2_table.nbytes
        return total

    @property
    def nbytes(self) -> int:
        """Decoded-engine footprint estimator the cold-tier governor budgets
        against (``AQPServer(max_engine_bytes=...)``)."""
        return self.nbytes_runtime()


# ---------------------------------------------------------------------------
# Conversion from the reference package's synopsis
# ---------------------------------------------------------------------------


def params_from_any(params) -> BuildParams:
    """``BuildParams`` from any object carrying the same field names.

    Names the port does not have are dropped: five of the reference's
    fields select nothing here (its fixed-chunk scheduler, its re-bucketing
    threshold, its Pallas switch and its two compressed-input switches).
    """
    return BuildParams(**{f.name: getattr(params, f.name)
                          for f in dataclasses.fields(BuildParams)
                          if hasattr(params, f.name)})


def column_from_any(col) -> ColumnInfo:
    """``ColumnInfo`` from any object carrying the same field names."""
    return ColumnInfo(**{f.name: getattr(col, f.name)
                         for f in dataclasses.fields(ColumnInfo)})


def synopsis_from_numpy(ph) -> PairwiseHist:
    """The port's ``PairwiseHist`` from a synopsis of the reference package.

    Duck-typed: ``ph`` needs the fields ``params``, ``n_rows``,
    ``n_sampled``, ``columns``, ``hists``, ``pairs`` and ``chi2_table``,
    with histograms that are NamedTuples of the same field names. Every
    array is copied, so the two synopses share no memory. Build telemetry
    is not carried over.
    """
    def copy_tuple(cls, nt):
        # np.array(...)[()] keeps 0-d fields (k, kx, ky) as NumPy scalars.
        return cls(**{f: np.array(getattr(nt, f), copy=True)[()]
                      for f in cls._fields})

    return PairwiseHist(
        params=params_from_any(ph.params),
        n_rows=int(ph.n_rows),
        n_sampled=int(ph.n_sampled),
        columns=[column_from_any(c) for c in ph.columns],
        hists=[copy_tuple(Hist1D, h) for h in ph.hists],
        pairs={(int(a), int(b)): copy_tuple(PairHist, p)
               for (a, b), p in ph.pairs.items()},
        chi2_table=np.array(ph.chi2_table, np.float64, copy=True),
    )
