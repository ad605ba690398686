"""GreedyGD: Generalized Deduplication with greedy base-bit selection (§3).

GD splits each row (chunk) into a *base* (most significant bits of every
column) and a *deviation* (the remaining bits). Bases are deduplicated —
compression wins when few distinct bases cover many rows (Fig. 3). GreedyGD
chooses *which* bits go to the base by greedily minimizing the modelled
compressed size:

    size = n_bases * sum(b_i)                       (deduplicated bases)
         + N * ceil(log2(n_bases))                  (base ids)
         + N * sum(w_i - b_i)                       (verbatim deviations)
         + null bitmap + dictionaries

starting from all bits in the base and repeatedly moving the nibble (4 bits,
GD's usual granularity) whose move reduces the modelled size the most.
Unique-base counts during the greedy search are estimated on a row subsample
(the search is a heuristic either way); the final split is exact.

The deduplicated bases double as seed bin edges for PairwiseHist (§3), which
is what makes construction on compressed data *faster*: the initial edges are
already shaped like the data.

Lossless: ``decompress()`` restores the pre-processed matrix bit-exactly
(including NaN positions via the null bitmap).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.obs.timeline import count, span


@dataclasses.dataclass
class CompressedTable:
    bases: np.ndarray          # (n_bases, d) uint64 — base bit patterns
    base_ids: np.ndarray       # (N,) uint32 — row -> base
    deviations: list           # per column: (N,) uint64 of low bits
    base_bits: np.ndarray      # (d,) — b_i
    total_bits: np.ndarray     # (d,) — w_i
    null_mask: np.ndarray      # (N, d) bool
    sentinels: np.ndarray      # (d,) — missing-value codes

    @property
    def n_rows(self) -> int:
        return self.base_ids.shape[0]

    @property
    def d(self) -> int:
        return self.bases.shape[1]

    def size_bits(self) -> dict:
        n, d = self.n_rows, self.d
        nb = self.bases.shape[0]
        id_bits = max(1, math.ceil(math.log2(max(nb, 2))))
        return {
            "bases": int(nb * self.base_bits.sum()),
            "ids": int(n * id_bits),
            "deviations": int(n * (self.total_bits - self.base_bits).sum()),
            "null_bitmap": int(n * d),
        }

    def size_bytes(self) -> int:
        return math.ceil(sum(self.size_bits().values()) / 8)

    def raw_size_bytes(self) -> int:
        """Typed-binary baseline: minimal whole-byte width per column."""
        n = self.n_rows
        return int(sum(n * max(1, math.ceil(w / 8)) for w in self.total_bits))


def decompress_rows(ct: CompressedTable, rows=None) -> np.ndarray:
    """Decode a row subset of a ``CompressedTable`` bit-exactly.

    ``rows`` is an index array (any order, duplicates allowed) or None for
    every row. Only the selected rows' base ids / deviations / null-bitmap
    slices are touched, so decoding an N_s-row construction sample costs
    O(N_s * d) regardless of the table's full height — this is what lets
    ``build_pairwise_hist`` consume a ``CompressedTable`` without ever
    materializing the full raw matrix.
    """
    shift = (ct.total_bits - ct.base_bits).astype(np.uint64)
    ids = ct.base_ids if rows is None else ct.base_ids[rows]
    base_rows = ct.bases[ids]
    out = np.empty((ids.shape[0], ct.d), np.float64)
    for i in range(ct.d):
        dev = ct.deviations[i] if rows is None else ct.deviations[i][rows]
        null = ct.null_mask[:, i] if rows is None else ct.null_mask[rows, i]
        codes = (base_rows[:, i] << shift[i]) | dev
        col = codes.astype(np.float64)
        col[null] = np.nan
        out[:, i] = col
    return out


class GreedyGD:
    """Compressor + decompressor + base extraction."""

    def __init__(self, nibble: int = 4, search_rows: int = 20000,
                 max_iters: int = 512, seed: int = 0):
        self.nibble = nibble
        self.search_rows = search_rows
        self.max_iters = max_iters
        self.seed = seed

    # ------------------------------------------------------------- internals

    @staticmethod
    def _encode_missing(data: np.ndarray):
        """NaN -> per-column sentinel code (max+1); returns ints + masks."""
        null = ~np.isfinite(data)
        codes = np.zeros(data.shape, np.uint64)
        sentinels = np.zeros(data.shape[1], np.uint64)
        for i in range(data.shape[1]):
            col = data[:, i]
            ok = ~null[:, i]
            mx = int(col[ok].max()) if ok.any() else 0
            sentinel = mx + 1
            sentinels[i] = sentinel
            vals = np.where(ok, col, float(sentinel))
            codes[:, i] = vals.astype(np.uint64)
        return codes, null, sentinels

    @staticmethod
    def _width(codes: np.ndarray) -> np.ndarray:
        mx = codes.max(axis=0).astype(np.uint64)
        return np.array([max(1, int(v).bit_length()) for v in mx], np.int64)

    @staticmethod
    def _n_unique_rows(masked: np.ndarray) -> int:
        view = np.ascontiguousarray(masked).view(
            np.dtype((np.void, masked.dtype.itemsize * masked.shape[1])))
        return np.unique(view).size

    def _model_bits(self, n_rows, widths, base_bits, nb) -> float:
        id_bits = max(1, math.ceil(math.log2(max(nb, 2))))
        return (nb * base_bits.sum() + n_rows * id_bits
                + n_rows * (widths - base_bits).sum())

    def plan(self, codes: np.ndarray) -> np.ndarray:
        """Greedy nibble search -> per-column base bit counts b_i.

        GreedyGD grows the base from *empty*: repeatedly move the MSB nibble
        of the column whose move most reduces the modelled size (deviations
        shrink by 4 bits/row; bases/ids grow with the deduplicated count).
        Stops at the first iteration with no improving move.
        """
        n, d = codes.shape
        widths = self._width(codes)
        rng = np.random.default_rng(self.seed)
        if n > self.search_rows:
            sub = codes[rng.choice(n, self.search_rows, replace=False)]
        else:
            sub = codes
        ns = sub.shape[0]
        base_bits = np.zeros(d, np.int64)

        def masked(bb):
            shift = (widths - bb).astype(np.uint64)
            return sub >> shift

        cur_cost = self._model_bits(ns, widths, base_bits, 1)
        for _ in range(self.max_iters):
            best = None
            for i in range(d):
                if base_bits[i] >= widths[i]:
                    continue
                cand = base_bits.copy()
                cand[i] = min(widths[i], cand[i] + self.nibble)
                nb = self._n_unique_rows(masked(cand))
                cost = self._model_bits(ns, widths, cand, nb)
                if cost < cur_cost and (best is None or cost < best[0]):
                    best = (cost, i, cand)
            if best is None:
                break
            cur_cost, _, base_bits = best
        return base_bits

    # ------------------------------------------------------------------- API

    def compress(self, data: np.ndarray) -> CompressedTable:
        """Pre-processed (N, d) f64 matrix (NaN = missing) -> CompressedTable.

        On the current timeline: spans ``gd_missing`` (sentinel codes),
        ``gd_plan`` (widths and the base search) and ``gd_encode`` (shifts,
        masks, base dedup); counters ``gd_rows_encoded`` and ``gd_bases``."""
        data = np.asarray(data, np.float64)
        count("gd_rows_encoded", data.shape[0])
        with span("gd_missing"):
            codes, null, sentinels = self._encode_missing(data)
        with span("gd_plan"):
            widths = self._width(codes)
            base_bits = self.plan(codes)
        with span("gd_encode"):
            shift = (widths - base_bits).astype(np.uint64)
            base_part = codes >> shift
            dev_mask = ((np.uint64(1) << shift) - np.uint64(1))
            deviations = [np.asarray(codes[:, i] & dev_mask[i])
                          for i in range(codes.shape[1])]
            view = np.ascontiguousarray(base_part).view(np.dtype(
                (np.void, base_part.dtype.itemsize * base_part.shape[1])))
            _, first_idx, inverse = np.unique(view, return_index=True,
                                              return_inverse=True)
            bases = base_part[first_idx]
        count("gd_bases", bases.shape[0])
        return CompressedTable(
            bases=bases, base_ids=inverse.astype(np.uint32).reshape(-1),
            deviations=deviations, base_bits=base_bits, total_bits=widths,
            null_mask=null, sentinels=sentinels)

    def decompress(self, ct: CompressedTable) -> np.ndarray:
        """Bit-exact inverse of compress (NaN restored from the bitmap)."""
        return decompress_rows(ct, None)

    @staticmethod
    def decompress_rows(ct: CompressedTable, rows) -> np.ndarray:
        """Decode only ``rows`` (see module-level ``decompress_rows``)."""
        return decompress_rows(ct, rows)

    @staticmethod
    def seed_edges(ct: CompressedTable) -> list:
        """Per-column candidate bin edges from the deduplicated bases (§3).

        Each distinct base value of a column marks the lower boundary of the
        value range it covers: base << dev_bits.
        """
        shift = (ct.total_bits - ct.base_bits).astype(np.uint64)
        edges = []
        for i in range(ct.d):
            vals = np.unique(ct.bases[:, i])
            lo = (vals << shift[i]).astype(np.float64)
            edges.append(np.unique(lo))
        return edges
