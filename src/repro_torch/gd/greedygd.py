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

``compress`` runs on ``GreedyGD(device=...)`` (``resolve_device``'s rule:
CUDA unless ``device="cpu"``) over one upload of the matrix, the codes held
as (d, N) int64: pre-processed values must be non-negative and below 2^63,
and ``compress`` raises on a column outside that range. At its peak the
device holds about 85 bytes a row and column (the matrix, the codes, the
null mask, the sorts' keys and indices): 492 MB for the rolling month's
494,233 rows of 12 columns on an H100. Row deduplication is dense ranks by
sorts, no ``np.unique`` of row views:

  * the search: a candidate adds a nibble to one column i of the current
    base bits b, so a sampled row's candidate base is told apart exactly by
    its dense id g under b and column i shifted to the candidate's bits.
    A candidate's distinct count is that of ``g * n_s + rank_i``; one
    batched sort of those (d, n_s) keys and one read of the d counts score
    a step on the host, and the winner's dense ids become g;
  * the encode: the base ids are the same dense ranks refined a column
    at a time, ``ids * N + rank_j``, over the columns with base bits, where
    ``rank_j`` orders column j by its words' bytes compared as unsigned
    (every other column's base is 0). That is ``np.unique``'s order
    on a ``void`` view of the little-endian uint64 rows, so the bases,
    their order and the base ids (first occurrence wins) are NumPy's.

The ``CompressedTable`` is a host object with NumPy's dtypes. On the current
timeline (``obs/timeline.py``): spans ``gd_missing`` (the upload, the
sentinel codes, one read of the sentinels and maxima), ``gd_plan`` (one read
a step; with more rows than ``search_rows`` the search rows' upload) and
``gd_encode`` (shifts, masks, the dedup, the count of bases and four
downloads); counters ``gd_rows_encoded``, ``gd_plan_steps`` (greedy steps
scored, one ``d2h_reads`` each) and ``gd_bases``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.timeline import count, span, to_device, to_host

_SIGN = -(1 << 63)   # int64 of the sign bit alone


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
    """Compressor + decompressor + base extraction, on ``device`` (CUDA
    unless ``device="cpu"``; ``resolve_device``)."""

    def __init__(self, nibble: int = 4, search_rows: int = 20000,
                 max_iters: int = 512, seed: int = 0, device=None):
        self.nibble = nibble
        self.search_rows = search_rows
        self.max_iters = max_iters
        self.seed = seed
        self.device = resolve_device(device)

    # ------------------------------------------------------------- internals

    @staticmethod
    def _encode_missing(x: torch.Tensor):
        """(N, d) f64 (NaN = missing) -> (d, N) int64 codes, the (N, d) null
        mask and a (3, d) int64 stack of each column's sentinel (largest
        value + 1, or 1 where all are missing), largest code and 1 where a
        value lies outside [0, 2^63), which int64 codes cannot hold."""
        null = ~torch.isfinite(x)
        top = torch.where(null, -math.inf, x).amax(0)
        low = torch.where(null, math.inf, x).amin(0)
        sentinel = torch.where(torch.isfinite(top), top, 0.0).to(
            torch.int64) + 1
        codes = torch.where(null, sentinel.to(x.dtype), x).to(torch.int64)
        codes = codes.T.contiguous()
        bad = (low < 0) | (top >= 2.0 ** 63)
        return codes, null, torch.stack([sentinel, codes.amax(1),
                                         bad.to(torch.int64)])

    def _model_bits(self, n_rows, widths, base_bits, nb) -> float:
        id_bits = max(1, math.ceil(math.log2(max(nb, 2))))
        return (nb * base_bits.sum() + n_rows * id_bits
                + n_rows * (widths - base_bits).sum())

    def plan(self, codes: torch.Tensor, widths: np.ndarray) -> np.ndarray:
        """Greedy nibble search -> per-column base bit counts b_i.

        GreedyGD grows the base from *empty*: repeatedly move the MSB nibble
        of the column whose move most reduces the modelled size (deviations
        shrink by 4 bits/row; bases/ids grow with the deduplicated count).
        Stops at the first iteration with no improving move.

        ``codes`` is the (d, N) int64 code matrix on the device, ``widths``
        the host's (d,) bit widths. Each step scores every column's
        candidate from one batched sort of the keys ``g * n_s + rank_i``
        and one read of the d distinct counts (``gd_plan_steps``); the
        winner's dense ids become ``g``. A column's ranks are sorted again
        only when it moves.
        """
        d, n = codes.shape
        dev = codes.device
        if n > self.search_rows:
            rows = np.random.default_rng(self.seed).choice(
                n, self.search_rows, replace=False)
            codes = codes[:, to_device(rows, dev)]
        ns = codes.shape[1]
        base_bits = np.zeros(d, np.int64)
        cand = np.minimum(widths, self.nibble)     # each column's candidate
        shift = to_device(widths - cand, dev)[:, None]
        ranks = _dense_ids(codes >> shift)[0]
        group = torch.zeros(ns, dtype=torch.int64, device=dev)
        cur_cost = self._model_bits(ns, widths, base_bits, 1)
        for _ in range(self.max_iters):
            live = np.flatnonzero(base_bits < widths)
            if not live.size:
                break
            ids, n_distinct = _dense_ids(group * ns + ranks)
            n_distinct = to_host(n_distinct).numpy()
            count("gd_plan_steps")
            best = None
            for i in live:
                bits = base_bits.copy()
                bits[i] = cand[i]
                cost = self._model_bits(ns, widths, bits, int(n_distinct[i]))
                if cost < cur_cost and (best is None or cost < best[0]):
                    best = (cost, i, bits)
            if best is None:
                break
            cur_cost, i, base_bits = best
            group = ids[i]
            if base_bits[i] < widths[i]:
                cand[i] = min(widths[i], base_bits[i] + self.nibble)
                shift = int(widths[i] - cand[i])
                ranks[i] = _dense_ids(codes[i] >> shift)[0]
        return base_bits

    # ------------------------------------------------------------------- API

    def compress(self, data: np.ndarray) -> CompressedTable:
        """Pre-processed (N, d) f64 matrix (NaN = missing) -> CompressedTable.

        Spans ``gd_missing``, ``gd_plan`` and ``gd_encode`` (see the module
        docstring), each ending on a host read or a completion wait."""
        data = np.ascontiguousarray(data, np.float64)
        dev = self.device
        count("gd_rows_encoded", data.shape[0])
        with span("gd_missing", wait=dev):
            codes, null, tops = self._encode_missing(to_device(data, dev))
            sentinels, maxima, bad = to_host(tops).numpy()
            if bad.any():
                raise ValueError(
                    "GreedyGD codes values in [0, 2^63); columns "
                    f"{np.flatnonzero(bad).tolist()} lie outside it")
            widths = np.array([max(1, int(v).bit_length()) for v in maxima],
                              np.int64)
        with span("gd_plan", wait=dev):
            base_bits = self.plan(codes, widths)
        with span("gd_encode", wait=dev):
            shift = to_device(widths - base_bits, dev)[:, None]
            base = codes >> shift
            first, ids = _dedup(base, base_bits)
            bases = to_host(base[:, first].T.contiguous()).numpy()
            base_ids = to_host(ids.to(torch.int32)).numpy()
            deviations = to_host(codes & ((1 << shift) - 1)).numpy()
            null_mask = to_host(null).numpy()
        count("gd_bases", bases.shape[0])
        return CompressedTable(
            bases=bases.view(np.uint64), base_ids=base_ids.view(np.uint32),
            deviations=list(deviations.view(np.uint64)), base_bits=base_bits,
            total_bits=widths, null_mask=null_mask,
            sentinels=sentinels.view(np.uint64))

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


def _dense_ids(keys: torch.Tensor):
    """Dense ids of ``keys`` along the last dim (0 for the least value, in
    the values' order) and each row's number of distinct values."""
    srt, order = torch.sort(keys, dim=-1)
    new = srt[..., 1:] != srt[..., :-1]
    sorted_ids = torch.nn.functional.pad(new.cumsum(-1), (1, 0))
    ids = torch.empty_like(sorted_ids).scatter_(-1, order, sorted_ids)
    return ids, sorted_ids[..., -1] + 1


def _memcmp_keys(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """int64 keys whose order is that of ``t``'s little-endian words
    compared byte by byte as unsigned (a byte swap, then the sign bit
    flipped); ``t``'s bytes from ``n_bytes`` up must be zero."""
    keys = torch.zeros_like(t)
    for b in range(n_bytes):
        keys |= ((t >> 8 * b) & 0xFF) << 56 - 8 * b
    return keys ^ _SIGN


def _dedup(base: torch.Tensor, base_bits: np.ndarray):
    """(d, N) int64 bases -> (each distinct base's first row, in
    ``np.unique``'s order on a ``void`` view of the little-endian uint64
    rows; each row's base id). The ids are dense ranks refined a column at
    a time, ``ids * N + rank_j``, over the columns with base bits (the
    others are 0 in every row), where ``rank_j`` orders column j by its
    words' bytes compared as unsigned, as NumPy compares the rows. One
    read (the count of bases) where a column has base bits; else one base.
    """
    n = base.shape[1]
    arange = torch.arange(n, device=base.device)
    ids = torch.zeros_like(arange)
    n_bases = 1
    live = np.flatnonzero(base_bits)
    if live.size:
        ranks = _dense_ids(_memcmp_keys(base, (int(base_bits.max()) + 7)
                                        // 8))[0]
        for j in live:
            ids, n_bases = _dense_ids(ids * n + ranks[j])
        n_bases = int(to_host(n_bases))
    first = torch.empty(n_bases, dtype=ids.dtype, device=base.device)
    first.scatter_reduce_(0, ids, arange, "amin", include_self=False)
    return first, ids
