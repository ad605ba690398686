"""Table catalog: named multi-table registry for the AQP server.

``core/sql.py`` has always parsed ``FROM <table>`` but nothing resolved the
name — the single-table engines just ignored it. The catalog closes that
gap: queries against unregistered tables raise ``PlanError`` with the list
of known tables, and each registered ``AQPFramework`` reports its staleness
epoch for cache invalidation.

**Cold tier** (``register_cold`` / ``ColdTable``): a table can register as
a bit-packed ``storage.py`` synopsis blob (plus, optionally, its
``CompressedTable``) instead of a live framework. The blob decodes lazily
on the first ``snapshot``/``published`` access — concurrent first queries
block on one decode and all observe the same atomic ``(engine, epoch)``
pair, exactly the ``append_rows``/``rebuild`` publication semantics — so
thousands of registered tables cost blob bytes, not runtime synopses,
until queried. ``epoch`` never triggers a decode (it is on the submit-path
cache-validation hot path).

Synopses are built on the catalog's ``device`` (``None``: the CUDA device,
raising without one; ``"cpu"`` runs the kernels' plain versions); a decoded
cold synopsis is host NumPy, as the reference's is.
"""
from __future__ import annotations

import threading
import time
import types

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core import storage as storagemod
from repro_torch.core.build import build_pairwise_hist
from repro_torch.core.query import PlanError, QueryEngine
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device

import repro_torch.serve.aqp.faults as faults


class TableQuarantinedError(RuntimeError):
    """The cold table's blob repeatedly failed to decode and is quarantined.

    Raised (typed, fast — no decode re-attempt while the circuit breaker
    is open) by every access that needs the engine. Recover by fixing the
    blob and re-registering the table, by ``reset_faults()``, or
    automatically after ``breaker_reset_s`` elapses (half-open retry).
    Queriers see this as a failed future, never a hang.
    """


class ColdTable:
    """A storage-tier table: bit-packed synopsis blob, decoded lazily.

    Duck-types the slice of ``AQPFramework`` the catalog and server use
    (``published`` / ``epoch`` / ``engine`` / ``on_invalidate`` /
    ``off_invalidate``). The epoch is allocated from the same process-global
    sequence at registration and is *stable across the first decode* —
    decoding changes representation, not table state — so epoch-keyed
    plan/result caches populated after the decode stay valid. ``rebuild``
    (GD-native, from the attached ``CompressedTable``) re-encodes the blob
    and publishes at a fresh epoch, firing the invalidation callbacks like
    a live framework's rebuild.

    ``demote`` reverses the decode: the engine drops back to its blob at
    the *same* epoch (again a representation change, not a state change —
    epoch-keyed cache entries stay valid), and the next query transparently
    re-decodes. In-flight waves holding the pre-demote engine reference
    finish safely; the tuple swap never mutates an engine in place.

    ``decode_cb(n_bytes, decode_s)`` (optional) fires once per decode,
    *outside* the publication lock — the server wires it to per-table
    cold-start telemetry and the memory governor, which may demote other
    tables (taking their locks) from inside the callback.

    ``device`` (``None``: the CUDA device) is where ``rebuild`` builds.
    """

    BACKOFF_CAP_S = 1.0

    def __init__(self, blob: bytes, compressed=None,
                 params: BuildParams | None = None, fastpath=None,
                 decode_cb=None, decode_retries: int = 2,
                 decode_backoff_s: float = 0.01,
                 breaker_reset_s: float = 0.0, fault_cb=None, device=None):
        storagemod.blob_info(blob)   # verify frame checksum + magic up front
        self.device = resolve_device(device)
        self.blob = bytes(blob)
        self.compressed = compressed
        self.params = params
        self.fastpath = fastpath
        self.decode_cb = decode_cb
        # Resilience policy: a failed decode is retried decode_retries
        # times with capped exponential backoff (decode_backoff_s base);
        # when every attempt fails the table quarantines — the circuit
        # breaker makes subsequent accesses raise TableQuarantinedError
        # immediately instead of hammering the broken blob. breaker_reset_s
        # > 0 allows a half-open re-attempt after that long.
        self.decode_retries = max(int(decode_retries), 0)
        self.decode_backoff_s = max(float(decode_backoff_s), 0.0)
        self.breaker_reset_s = float(breaker_reset_s)
        # fault_cb(event, n, exc) with event in {"decode_retry",
        # "quarantine"}: the server wires fault telemetry (counters +
        # trace instants) here. Runs under the table lock; must not take
        # table locks itself.
        self.fault_cb = fault_cb
        self.decode_count = 0
        self.demote_count = 0
        self.decode_failures = 0
        self._fault: Exception | None = None
        self._fault_t = 0.0
        self._lock = threading.Lock()
        # Rebuilds serialize on their own lock so a slow older build can
        # never overwrite a newer publication (epochs are claimed before
        # building, and the publish refuses to go backwards).
        self._rebuild_lock = threading.Lock()
        self._invalidate_cbs = []
        self._engine_nbytes = 0
        # Same atomic-tuple publication as AQPFramework: (engine, epoch,
        # timings) swaps in one assignment; engine None = not yet decoded.
        self._published: tuple = (None, next(AQPFramework._epoch_seq),
                                  types.MappingProxyType({}))
        # Epoch the current self.blob encodes; when a rebuild bumps the
        # epoch the blob is re-encoded in step, so demote only needs to
        # re-encode if the two ever diverge.
        self._blob_epoch = self._published[1]

    # -------------------------------------------------------- framework duck

    @property
    def engine(self):
        """The decoded QueryEngine, or None while still cold (no decode)."""
        return self._published[0]

    @property
    def epoch(self) -> int:
        """Staleness epoch; never triggers a decode (submit-path safe)."""
        return self._published[1]

    @property
    def published(self) -> tuple:
        """Atomic ``(engine, epoch)``; decodes the blob on first access."""
        pub = self._published
        if pub[0] is None:
            pub = self._decode()
        return pub[:2]

    @property
    def timings(self) -> "types.MappingProxyType":
        """Read-only telemetry published with the engine (decode/build)."""
        return self._published[2]

    def on_invalidate(self, callback):
        """Register ``callback(table)`` to fire on every epoch bump."""
        self._invalidate_cbs.append(callback)

    def off_invalidate(self, callback):
        """Detach a callback registered with ``on_invalidate`` (no-op if
        absent)."""
        try:
            self._invalidate_cbs.remove(callback)
        except ValueError:
            pass

    # ------------------------------------------------------------- lifecycle

    def _check_breaker(self):
        """Raise fast while quarantined; allow a half-open retry after
        ``breaker_reset_s`` (caller holds the lock)."""
        if self._fault is None:
            return
        if self.breaker_reset_s > 0 and \
                time.perf_counter() - self._fault_t >= self.breaker_reset_s:
            return                    # half-open: permit a fresh attempt
        raise TableQuarantinedError(
            f"cold table quarantined (circuit open): {self._fault!r}")

    def _decode(self) -> tuple:
        """Decode the blob under the lock (double-checked): concurrent first
        readers block here and then all see the same published tuple.

        Returns the locally published tuple (not a re-read of
        ``_published``) so a demote racing in right after the decode cannot
        hand the caller a cold ``(None, epoch)`` — the in-flight query keeps
        the engine it decoded.

        Decode failures retry with capped exponential backoff; when every
        attempt fails the table quarantines (``TableQuarantinedError``,
        typed and immediate for queriers — never a hang) and the circuit
        breaker short-circuits further attempts until reset."""
        with self._lock:
            pub = self._published
            if pub[0] is not None:
                return pub
            self._check_breaker()
            ph = None
            last: Exception | None = None
            attempts = self.decode_retries + 1
            for attempt in range(attempts):
                if attempt:
                    time.sleep(min(
                        self.decode_backoff_s * (2 ** (attempt - 1)),
                        self.BACKOFF_CAP_S))
                    if self.fault_cb is not None:
                        self.fault_cb("decode_retry", attempt, last)
                t0 = time.perf_counter()
                try:
                    faults.hook("blob_read")
                    blob = self.blob
                    faults.hook("cold_decode")
                    ph = storagemod.decode(blob)
                    break
                except Exception as exc:
                    last = exc
                    self.decode_failures += 1
            if ph is None:
                self._fault = last
                self._fault_t = time.perf_counter()
                if self.fault_cb is not None:
                    self.fault_cb("quarantine", attempts, last)
                raise TableQuarantinedError(
                    f"cold table blob failed to decode after {attempts} "
                    f"attempts (re-register or reset_faults() to recover): "
                    f"{last!r}") from last
            self._fault = None
            engine = QueryEngine(ph, fastpath=self.fastpath)
            decode_s = time.perf_counter() - t0
            self.decode_count += 1
            self._engine_nbytes = ph.nbytes
            published = (engine, pub[1], types.MappingProxyType({
                "cold_decode_s": decode_s,
                "synopsis_bytes": len(self.blob),
            }))
            self._published = published
        # Outside the lock: the server's callback runs the memory governor,
        # which may demote tables (taking their _lock) — firing it under
        # our own (non-reentrant) lock would deadlock on self-demotion.
        if self.decode_cb is not None:
            self.decode_cb(len(self.blob), decode_s)
        return published

    def demote(self) -> bool:
        """Drop the decoded engine back to the blob (the governor's evict).

        Publishes ``(None, epoch)`` at the *unchanged* epoch — demote is a
        representation change, so plan/result caches keyed on the epoch stay
        valid and no invalidation callbacks fire. If the engine was rebuilt
        since the blob was last encoded, the fresh synopsis is re-encoded
        first so no state is lost. Returns True if an engine was resident
        (demoted), False if the table was already cold (no-op)."""
        with self._lock:
            pub = self._published
            engine = pub[0]
            if engine is None:
                return False
            if self._blob_epoch != pub[1]:
                self.blob = storagemod.encode(engine.ph)
                self._blob_epoch = pub[1]
            self.demote_count += 1
            self._engine_nbytes = 0
            self._published = (None, pub[1], types.MappingProxyType({
                "demoted": True,
                "synopsis_bytes": len(self.blob),
            }))
        return True

    @property
    def resident_bytes(self) -> int:
        """Decoded-engine footprint right now (0 while cold/demoted)."""
        return self._engine_nbytes if self._published[0] is not None else 0

    @property
    def quarantined(self) -> bool:
        """True while the decode circuit breaker is open."""
        return self._fault is not None

    def reset_faults(self):
        """Close the circuit breaker so the next access re-attempts the
        decode (operator override; re-registering the table also works)."""
        with self._lock:
            self._fault = None

    def rebuild(self, params: BuildParams | None = None) -> "ColdTable":
        """Rebuild the synopsis GD-natively from the attached
        ``CompressedTable``, re-encode the blob and publish at a fresh
        epoch (fires the invalidation callbacks — caches purge exactly as
        for a live framework's rebuild).

        Concurrent rebuilds serialize on ``_rebuild_lock`` and each claims
        its epoch *before* building, so publications land in epoch order;
        the publish additionally refuses to overwrite a higher epoch, so a
        stale build can never clobber a newer one (last-write-wins bug)."""
        if self.compressed is None:
            raise RuntimeError(
                "cold table has no CompressedTable attached; cannot rebuild")
        with self._rebuild_lock:
            epoch_new = next(AQPFramework._epoch_seq)
            engine_old = self.published[0]  # decode if needed: columns live
            columns = engine_old.ph.columns  # in the synopsis
            build_params = params or self.params or engine_old.ph.params
            t0 = time.perf_counter()
            ph = build_pairwise_hist(self.compressed, columns, build_params,
                                     device=self.device)
            blob = storagemod.encode(ph)
            engine = QueryEngine(ph, fastpath=self.fastpath)
            build_s = time.perf_counter() - t0
            with self._lock:
                if self._published[1] > epoch_new:
                    return self             # a newer publication already won
                self.blob = blob
                self.params = build_params
                self._blob_epoch = epoch_new
                self._engine_nbytes = ph.nbytes
                self._published = (engine, epoch_new,
                                   types.MappingProxyType({
                                       "build_synopsis_s": build_s,
                                       "synopsis_bytes": len(blob),
                                       "build_from_compressed": True,
                                   }))
        for cb in list(self._invalidate_cbs):
            cb(self)
        return self

    def cold_info(self) -> dict:
        """Header peek + decode state: {bytes, n_rows, n_sampled, d,
        decoded, decode_count, demote_count, resident_bytes} without
        forcing a decode."""
        info = storagemod.blob_info(self.blob)
        info["decoded"] = self._published[0] is not None
        info["decode_count"] = self.decode_count
        info["demote_count"] = self.demote_count
        info["resident_bytes"] = self.resident_bytes
        info["quarantined"] = self.quarantined
        info["decode_failures"] = self.decode_failures
        return info


class TableCatalog:
    """name -> AQPFramework registry with staleness-epoch bookkeeping.

    All registry access goes through ``_reglock``: ``register``/
    ``unregister`` racing submit-path ``resolve``/``epoch``/``tables()``
    used to mutate the plain dict mid-``sorted()`` (``RuntimeError:
    dictionary changed size during iteration``) or tear a registration.
    The lock only guards the dict, never a decode or build, so it is
    never held across anything slow.

    ``device`` (``None``: the CUDA device, raising without one) is handed
    to every framework and cold table the catalog makes.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: dict[str, AQPFramework] = {}
        self._reglock = threading.Lock()

    # ------------------------------------------------------------ registration

    def register(self, name: str, framework: AQPFramework) -> AQPFramework:
        """Register an (already ingested or to-be-ingested) framework."""
        with self._reglock:
            self._tables[name] = framework
        return framework

    def register_table(self, name: str, table: dict,
                       params: BuildParams | None = None,
                       use_compression: bool = True,
                       fastpath=None) -> AQPFramework:
        """Convenience: build + ingest a framework from a raw column dict."""
        fw = AQPFramework(params=params, use_compression=use_compression,
                          fastpath=fastpath, device=self.device)
        fw.ingest(table)
        return self.register(name, fw)

    def register_cold(self, name: str, blob: bytes, compressed=None,
                      params: BuildParams | None = None, fastpath=None,
                      decode_cb=None, decode_retries: int = 2,
                      decode_backoff_s: float = 0.01,
                      breaker_reset_s: float = 0.0,
                      fault_cb=None) -> ColdTable:
        """Register a storage-tier table: a bit-packed synopsis blob (plus
        optionally its ``CompressedTable`` for GD-native rebuilds) that
        decodes lazily on first query — see ``ColdTable``. The retry /
        backoff / breaker knobs and ``fault_cb`` configure decode
        resilience (see ``docs/robustness.md``)."""
        cold = ColdTable(blob, compressed=compressed, params=params,
                         fastpath=fastpath, decode_cb=decode_cb,
                         decode_retries=decode_retries,
                         decode_backoff_s=decode_backoff_s,
                         breaker_reset_s=breaker_reset_s, fault_cb=fault_cb,
                         device=self.device)
        with self._reglock:
            self._tables[name] = cold
        return cold

    def unregister(self, name: str):
        """Drop ``name`` from the registry (no-op if absent)."""
        with self._reglock:
            self._tables.pop(name, None)

    # -------------------------------------------------------------- resolution

    def __contains__(self, name: str) -> bool:
        with self._reglock:
            return name in self._tables

    def __len__(self) -> int:
        with self._reglock:
            return len(self._tables)

    def tables(self) -> list[str]:
        """Sorted registered table names."""
        with self._reglock:
            return sorted(self._tables)

    def cold_tables(self) -> list:
        """Point-in-time ``[(name, ColdTable)]`` snapshot — the governor's
        sweep list (live frameworks are not demotable and are excluded)."""
        with self._reglock:
            return [(name, t) for name, t in self._tables.items()
                    if isinstance(t, ColdTable)]

    def resolve(self, name: str) -> AQPFramework:
        """The framework registered under ``name``; PlanError if unknown."""
        with self._reglock:
            fw = self._tables.get(name)
        if fw is None:
            raise PlanError(
                f"unknown table {name!r}; registered tables: "
                f"{self.tables()}")
        return fw

    def engine(self, name: str):
        """Fresh QueryEngine for ``name``; raises RuntimeError if the
        synopsis is stale (append_rows without rebuild)."""
        return self.snapshot(name)[0]

    def snapshot(self, name: str) -> tuple:
        """Atomic ``(engine, epoch)`` for ``name`` — the framework publishes
        the pair in one assignment, so the returned engine is exactly the
        one built at the returned epoch (no engine/epoch tearing even when
        a rebuild races the read). Raises PlanError for unknown tables and
        RuntimeError for stale ones, like ``engine``."""
        fw = self.resolve(name)
        engine, epoch = fw.published
        if engine is None:
            raise RuntimeError(
                f"table {name!r}: synopsis is stale after append_rows; "
                "call rebuild() first")
        return engine, epoch

    def epoch(self, name: str) -> int:
        """Current staleness epoch of a table (cache-key component).
        Unknown tables report -1 so stale cache entries for dropped tables
        can never validate."""
        with self._reglock:
            fw = self._tables.get(name)
        return fw.epoch if fw is not None else -1
