"""The end-to-end AQP framework of Fig. 2.

    raw table --preprocess--> integer domain --GreedyGD--> bases+deviations
                                   |                           |
                                   |                     (seed bin edges)
                                   v                           v
                            PairwiseHist  <--- BuildPairwiseHist(sample)
                                   |
        SQL --parse/encode--> QueryEngine --> (estimate, lower, upper)

Data lives compressed (CompressedTable); the synopsis answers queries without
touching it. ``append_rows`` supports incremental ingestion (compressed store
updated immediately; synopsis marked stale and rebuilt lazily) — the paper's
"more frequent updates" story.

The synopsis is built on ``device`` (``None``: the CUDA device, raising
without one; ``"cpu"`` runs the kernels' plain versions).
"""
from __future__ import annotations

import itertools
import time
import types

import numpy as np

from repro_torch.core import storage as storagemod
from repro_torch.core.build import build_pairwise_hist
from repro_torch.core.query import QueryEngine, QueryResult
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.gd.greedygd import GreedyGD
from repro_torch.gd.preprocess import preprocess_table


class AQPFramework:
    # Process-global epoch sequence: epochs are unique across *all*
    # frameworks, so a serving cache entry tagged with one framework's epoch
    # can never validate against a different framework that replaced it
    # under the same catalog name (same-value collision is impossible).
    _epoch_seq = itertools.count(1)

    def __init__(self, params: BuildParams | None = None,
                 use_compression: bool = True, fastpath=None, device=None):
        self.params = params or BuildParams()
        self.device = resolve_device(device)
        self.use_compression = use_compression
        self.fastpath = fastpath
        self.gd = GreedyGD()
        self.compressed = None
        self.preprocessed = None
        self.synopsis = None
        self._raw_batches = []
        # Serving-layer integration: the queryable state is the ATOMICALLY
        # published (engine, epoch, timings) triple — one tuple assignment
        # whenever it changes (ingest / append_rows / rebuild), so a reader
        # snapshotting ``published`` can never observe an engine with the
        # wrong epoch (the serving scheduler's per-item epoch revalidation
        # and the plan-time epoch capture both rely on this). ``timings``
        # rides along as an immutable MappingProxyType: a server thread
        # snapshotting build telemetry mid-``rebuild()`` sees either the
        # whole old dict or the whole new one, never a half-built mutation.
        # Plan/result caches keyed on the epoch can never serve stale
        # answers; callbacks let a catalog purge eagerly.
        self._published: tuple = (None, 0, types.MappingProxyType({}))
        self._invalidate_cbs = []

    # ------------------------------------------------------- staleness hooks

    @property
    def engine(self):
        """The current QueryEngine, or None while stale (append_rows)."""
        return self._published[0]

    @property
    def epoch(self) -> int:
        """Staleness epoch of the currently published queryable state."""
        return self._published[1]

    @property
    def published(self) -> tuple:
        """Atomic (engine, epoch) snapshot — the pair was published in one
        assignment, so the engine is exactly the one built at that epoch."""
        return self._published[:2]

    @property
    def timings(self) -> "types.MappingProxyType":
        """Read-only build-timing telemetry published with the engine.

        Immutable by construction: ``ingest``/``rebuild`` assemble a fresh
        dict and publish it in the same tuple assignment as the engine, so
        concurrent readers never see partial updates and the keys always
        describe the *published* synopsis, not one mid-build.
        """
        return self._published[2]

    @property
    def is_stale(self) -> bool:
        return self.engine is None

    def on_invalidate(self, callback):
        """Register ``callback(framework)`` to fire on every epoch bump."""
        self._invalidate_cbs.append(callback)

    def off_invalidate(self, callback):
        """Detach a callback registered with ``on_invalidate`` (no-op if
        absent) — e.g. when a serving catalog replaces this framework."""
        try:
            self._invalidate_cbs.remove(callback)
        except ValueError:
            pass

    def _publish(self, engine, timings: dict | None = None):
        """Atomically publish ``(engine, fresh epoch, timings)`` and fire
        the invalidation callbacks (``engine=None`` marks the table stale;
        ``timings=None`` carries the previous telemetry forward)."""
        if timings is None:
            frozen = self._published[2]
        else:
            frozen = types.MappingProxyType(dict(timings))
        self._published = (engine, next(AQPFramework._epoch_seq), frozen)
        for cb in list(self._invalidate_cbs):
            cb(self)

    # -------------------------------------------------------------- ingest

    def ingest(self, table: dict) -> "AQPFramework":
        t0 = time.perf_counter()
        self.preprocessed = preprocess_table(table)
        t1 = time.perf_counter()
        if self.use_compression:
            self.compressed = self.gd.compress(self.preprocessed.data)
        t2 = time.perf_counter()
        # GD-native construction: build directly from the compressed store —
        # only the N_s sampled rows are decoded and the bases seed the 1-D
        # edges (bit-for-bit equal to the raw+seed_edges path).
        use_ct = self.use_compression and self.params.from_compressed
        build_input = self.compressed if use_ct else self.preprocessed.data
        seed_edges = (GreedyGD.seed_edges(self.compressed)
                      if self.use_compression and not use_ct else None)
        self.synopsis = build_pairwise_hist(
            build_input, self.preprocessed.columns, self.params,
            seed_edges=seed_edges, device=self.device)
        t3 = time.perf_counter()
        engine = QueryEngine(self.synopsis, fastpath=self.fastpath)
        # Pair-phase telemetry from the (batched) builder: rebuild() runs
        # through here too, so serving-cache invalidation pauses
        # (append_rows -> rebuild) are dominated by build_pairs_s.
        stats = self.synopsis.build_stats
        self._publish(engine, {
            "preprocess_s": t1 - t0, "compress_s": t2 - t1,
            "build_synopsis_s": t3 - t2,
            "build_pairs_s": stats.get("pair_phase_s", 0.0),
            "build_pair_mode": stats.get("mode", ""),
            "build_phase_s": dict(stats.get("phase_s", {})),
            "build_from_compressed": bool(stats.get("from_compressed")),
        })
        return self

    def ingest_compressed(self, compressed, columns) -> "AQPFramework":
        """Ingest an already-compressed table: build the synopsis straight
        from the ``CompressedTable`` (no raw matrix anywhere). ``columns``
        is the ``ColumnInfo`` list from pre-processing; this is the cold
        catalog's rebuild path."""
        t0 = time.perf_counter()
        self.compressed = compressed
        self.preprocessed = None
        self.synopsis = build_pairwise_hist(compressed, columns, self.params,
                                            device=self.device)
        t1 = time.perf_counter()
        engine = QueryEngine(self.synopsis, fastpath=self.fastpath)
        stats = self.synopsis.build_stats
        self._publish(engine, {
            "preprocess_s": 0.0, "compress_s": 0.0,
            "build_synopsis_s": t1 - t0,
            "build_pairs_s": stats.get("pair_phase_s", 0.0),
            "build_pair_mode": stats.get("mode", ""),
            "build_phase_s": dict(stats.get("phase_s", {})),
            "build_from_compressed": True,
        })
        return self

    def append_rows(self, table: dict):
        """Incremental ingestion: recompress the union (GD supports appends;
        dictionary growth forces re-coding here), mark synopsis stale."""
        self._raw_batches.append(table)
        self.synopsis = None
        self._publish(None)

    def _ensure_fresh(self):
        if self.engine is None:
            raise RuntimeError(
                "synopsis is stale after append_rows; call rebuild() first")

    def rebuild(self, base_table: dict):
        merged = dict(base_table)
        for batch in self._raw_batches:
            for k in merged:
                merged[k] = np.concatenate([np.asarray(merged[k]),
                                            np.asarray(batch[k])])
        self._raw_batches = []
        return self.ingest(merged)

    # -------------------------------------------------------------- queries

    def query(self, sql_text: str) -> QueryResult:
        self._ensure_fresh()
        return self.engine.query(sql_text)

    # -------------------------------------------------------------- reports

    def storage_report(self) -> dict:
        rep = {"synopsis": storagemod.synopsis_size_report(self.synopsis)}
        if self.compressed is not None:
            rep["compressed_data_bytes"] = self.compressed.size_bytes()
            rep["raw_data_bytes"] = self.compressed.raw_size_bytes()
            rep["compression_ratio"] = (self.compressed.raw_size_bytes()
                                        / max(self.compressed.size_bytes(), 1))
            rep["total_with_synopsis"] = (rep["compressed_data_bytes"]
                                          + rep["synopsis"]["total"])
            rep["total_storage_reduction"] = (rep["raw_data_bytes"]
                                              / max(rep["total_with_synopsis"], 1))
        return rep

    def size_bytes(self) -> int:
        return storagemod.synopsis_size_report(self.synopsis)["total"]
