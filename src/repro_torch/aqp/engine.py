"""The end-to-end AQP framework of Fig. 2.

    raw table --preprocess--> integer domain --GreedyGD--> bases+deviations
                                   |                           |
                                   |                     (seed bin edges)
                                   v                           v
                            PairwiseHist  <--- BuildPairwiseHist(sample)
                                   |
        SQL --parse/encode--> QueryEngine --> (estimate, lower, upper)

Data lives compressed (CompressedTable); the synopsis answers queries without
touching it. The framework holds the raw table it last ingested (by
reference, no copy): ``append_rows`` queues rows behind it, ``expire_rows``
drops its oldest ones, each marking the synopsis stale, and ``rebuild()``
ingests what is held then — a rolling window fed by appends, the paper's
"more frequent updates" story. Nothing is incremental: a rebuild is the
whole ingest of the held rows.

``ingest`` and ``rebuild`` record a timeline (``obs/timeline.py``):
``merge``, ``preprocess``, ``gd_compress`` and ``build`` spans with the
children and counters that pre-processing and GreedyGD record on it,
published in ``timings`` with the epoch.

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
from repro_torch.obs.timeline import BuildTimeline


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
        self.gd = GreedyGD(device=self.device)
        self.compressed = None
        self.preprocessed = None
        self.synopsis = None
        # The held rows: the raw table last ingested (None after
        # ingest_compressed), the batches appended since, and how many of
        # the oldest held rows are to be dropped at the next rebuild.
        self._retained = None
        self._raw_batches = []
        self._expired = 0
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
        """Pre-process, compress and build from raw ``table``, which the
        framework then holds (by reference) as its retained rows; batches
        appended and rows expired before it are dropped with the old
        rows."""
        return self._ingest(table, BuildTimeline())

    def _ingest(self, table: dict, tl: BuildTimeline) -> "AQPFramework":
        with tl.phase("preprocess"):
            self.preprocessed = preprocess_table(table)
        if self.use_compression:
            with tl.phase("gd_compress"):
                self.compressed = self.gd.compress(self.preprocessed.data)
        self._retained, self._raw_batches, self._expired = table, [], 0
        # GD-native construction: build directly from the compressed store —
        # only the N_s sampled rows are decoded and the bases seed the 1-D
        # edges.
        build_input = (self.compressed if self.use_compression
                       else self.preprocessed.data)
        with tl.phase("build"):
            self.synopsis = build_pairwise_hist(
                build_input, self.preprocessed.columns, self.params,
                device=self.device)
        # The ingest's own spans beside the build's telemetry (rebuild()
        # runs through here too).
        phase_s = tl.summary()
        self._publish_build(phase_s["preprocess"],
                            phase_s.get("gd_compress", 0.0), phase_s["build"],
                            ingest_timeline=tl.events, ingest_phase_s=phase_s,
                            ingest_counts=tl.totals())
        return self

    def ingest_compressed(self, compressed, columns) -> "AQPFramework":
        """Ingest an already-compressed table: build the synopsis straight
        from the ``CompressedTable`` (no raw matrix anywhere). ``columns``
        is the ``ColumnInfo`` list from pre-processing; this is the cold
        catalog's rebuild path. No raw rows are held afterwards: pending
        appends and expiries are dropped."""
        t0 = time.perf_counter()
        self.compressed = compressed
        self.preprocessed = None
        self._retained, self._raw_batches, self._expired = None, [], 0
        self.synopsis = build_pairwise_hist(compressed, columns, self.params,
                                            device=self.device)
        self._publish_build(0.0, 0.0, time.perf_counter() - t0)
        return self

    def _publish_build(self, preprocess_s: float, compress_s: float,
                       build_s: float, **extra):
        """Publish a query engine over the new synopsis with the timings
        that every ingest path reports (the stage seconds given and the
        build's pair-phase telemetry), and ``extra`` beside them."""
        stats = self.synopsis.build_stats
        self._publish(QueryEngine(self.synopsis, fastpath=self.fastpath), {
            "preprocess_s": preprocess_s,
            "compress_s": compress_s,
            "build_synopsis_s": build_s,
            "build_pairs_s": stats.get("pair_phase_s", 0.0),
            "build_pair_mode": stats.get("mode", ""),
            "build_phase_s": dict(stats.get("phase_s", {})),
            "build_from_compressed": bool(stats.get("from_compressed")),
            **extra,
        })

    def append_rows(self, table: dict):
        """Queue ``table``'s rows (by reference) behind the held ones and
        publish the synopsis stale. Nothing is compressed or built until
        ``rebuild``."""
        self._raw_batches.append(table)
        self.synopsis = None
        self._publish(None)

    def expire_rows(self, n: int):
        """Mark the oldest ``n`` held rows (the retained table's first, then
        the appended batches') to be dropped at the next ``rebuild``, and
        publish the synopsis stale."""
        held = sum(_n_rows(t) for t in self._held(self._retained))
        if not 0 <= n <= held - self._expired:
            raise ValueError(f"cannot expire {n} of the "
                             f"{held - self._expired} rows held")
        self._expired += n
        self.synopsis = None
        self._publish(None)

    def _ensure_fresh(self):
        if self.engine is None:
            raise RuntimeError(
                "synopsis is stale after append_rows or expire_rows; call "
                "rebuild() first")

    def _held(self, base):
        return ([] if base is None else [base]) + self._raw_batches

    def rebuild(self, base_table: dict | None = None):
        """Ingest the held rows less the expired ones: the retained table
        (``base_table`` in its place where given), then the appended
        batches, in that order. The result is the synopsis of a fresh
        framework's ``ingest`` of the same rows."""
        base = self._retained if base_table is None else base_table
        if base is None and not self._raw_batches:
            raise ValueError("no raw table is held: ingest one, or pass "
                             "base_table")
        tl = BuildTimeline()
        with tl.phase("merge"):
            merged = _concat_rows(self._held(base), self._expired)
        return self._ingest(merged, tl)

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


def _n_rows(table: dict) -> int:
    return len(next(iter(table.values())))


def _concat_rows(tables: list, drop: int) -> dict:
    """The rows of ``tables`` in order, less the first ``drop``, under the
    first table's column names; a table left whole and alone is returned as
    it is (no copy)."""
    kept = []
    for t in tables:
        n = _n_rows(t)
        if drop >= n:
            drop -= n
            continue
        kept.append(t if drop == 0 else
                    {k: np.asarray(v)[drop:] for k, v in t.items()})
        drop = 0
    if len(kept) == 1:
        return kept[0]
    return {k: np.concatenate([np.asarray(t[k]) for t in kept])
            for k in tables[0]}
