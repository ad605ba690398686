"""LRU plan / result caches for the AQP serving layer.

Entries are keyed on *normalized* SQL text and tagged with the owning
table's epoch (``AQPFramework.epoch``); a lookup whose stored epoch differs
from the table's current epoch is a miss — appended rows can never be
answered from a stale cached result. ``purge_table`` additionally evicts
eagerly (wired to ``AQPFramework.on_invalidate`` by the server) so stale
entries do not linger holding memory.

Thread safety: ``LRUCache`` is deliberately unsynchronized — the server's
lock split assigns each instance exactly one guarding lock (the plan cache
lives under ``AQPServer._plan_lock``, the result cache under
``AQPServer._state_lock``; see the locking section of
``repro_torch.serve.aqp.server``), and every access goes through the owning
lock. Adding a lock here would double-pay on the hot path.
"""
from __future__ import annotations

import collections
import dataclasses
import re

import numpy as np

_QUOTED_RE = re.compile(r"('[^']*'|\"[^\"]*\")")


def normalize_sql(text: str) -> str:
    """Canonical cache key: collapse whitespace, drop a trailing semicolon.

    Quoted string literals are preserved verbatim (``'New  York'`` keeps its
    double space — the server parses the *normalized* text, so literal
    content must survive normalization); identifier/literal case is
    preserved too. Only insignificant layout outside quotes is collapsed,
    so ``SELECT COUNT(*)  FROM t ;`` and ``SELECT COUNT(*) FROM t`` share
    one cache slot.
    """
    parts = _QUOTED_RE.split(text.strip())
    parts[-1] = parts[-1].rstrip().rstrip(";")   # always outside quotes
    out = [part if i % 2 else " ".join(part.split())
           for i, part in enumerate(parts)]
    return " ".join(p for p in out if p)


def approx_nbytes(value, _depth: int = 0) -> int:
    """Rough in-memory footprint of a cached value, in bytes.

    Counts what dominates real result payloads — numpy arrays (``.nbytes``),
    strings, and the per-element overhead of containers / dataclasses —
    without a full ``gc`` traversal. It is an *estimate* feeding the cache's
    approximate byte budget, not an accounting tool; recursion is depth-
    bounded so a pathological self-referencing value cannot hang a put.
    """
    if _depth > 6 or value is None:
        return 8
    if isinstance(value, np.ndarray):
        return int(value.nbytes) + 96
    if isinstance(value, (bytes, str)):
        return len(value) + 49
    if isinstance(value, (int, float, bool, np.generic)):
        return 28
    if isinstance(value, dict):
        return 64 + sum(approx_nbytes(k, _depth + 1)
                        + approx_nbytes(v, _depth + 1)
                        for k, v in value.items())
    if isinstance(value, (list, tuple, set, frozenset)):
        return 56 + sum(approx_nbytes(v, _depth + 1) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return 56 + sum(
            approx_nbytes(getattr(value, f.name, None), _depth + 1)
            for f in dataclasses.fields(value))
    return 64


@dataclasses.dataclass
class CacheEntry:
    """One cached value tagged with its owning table + staleness epoch."""

    table: str
    epoch: int
    value: object
    nbytes: int = 0     # approx_nbytes(value), frozen at put time


class LRUCache:
    """LRU over normalized-SQL keys with epoch validation + stats.

    Bounded two ways: ``capacity`` (max entries) and — when ``max_bytes``
    is positive — an **approximate byte budget**: every put estimates the
    value's footprint (``approx_nbytes``) and evicts from the LRU end
    until the running total fits. An entry larger than the whole budget is
    rejected before insertion (the budget is a bound, not a best effort,
    and an oversized insert must not churn warm entries through the LRU
    end on its way out), which also means ``max_bytes > 0`` caches can
    reject a value outright.
    Byte-driven evictions are counted separately (``byte_evictions``) from
    capacity churn so telemetry shows which bound is binding.
    """

    def __init__(self, capacity: int = 1024, max_bytes: int = 0):
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes)
        self._data: collections.OrderedDict[str, CacheEntry] = \
            collections.OrderedDict()
        self._bytes = 0
        self.byte_evictions = 0
        self.hits = 0
        self.misses = 0
        self.table_hits: collections.Counter = collections.Counter()
        self.table_misses: collections.Counter = collections.Counter()

    def __len__(self) -> int:
        return len(self._data)

    @property
    def nbytes(self) -> int:
        """Approximate bytes currently held (sum of entry estimates)."""
        return self._bytes

    def get(self, key: str, epoch_of) -> CacheEntry | None:
        """Validated lookup. ``epoch_of(table) -> int`` supplies the current
        epoch; entries from older epochs are evicted silently. Miss
        accounting is the caller's job (one ``miss()`` per failed lookup,
        once the key's table is known) so a stale entry is not double
        counted."""
        entry = self._data.get(key)
        if entry is not None and entry.epoch == epoch_of(entry.table):
            self._data.move_to_end(key)
            self.hits += 1
            self.table_hits[entry.table] += 1
            return entry
        if entry is not None:   # stale epoch: evict; caller records the miss
            self._bytes -= entry.nbytes
            del self._data[key]
        return None

    def miss(self, table: str | None = None):
        """Record a miss (``table=None`` when the key's table is unknown)."""
        self.misses += 1
        if table is not None:
            self.table_misses[table] += 1

    def put(self, key: str, table: str, epoch: int, value):
        """Insert/refresh ``key`` (evicts LRU entries beyond capacity, then
        beyond the byte budget when ``max_bytes`` is set). A value larger
        than the whole budget is rejected up front — inserting it first
        would wipe every warm entry on its way through the LRU end — and
        drops the key's previous value (the caller meant to replace it)."""
        if self.capacity <= 0:
            return
        nb = approx_nbytes(value) if self.max_bytes > 0 else 0
        if self.max_bytes > 0 and nb > self.max_bytes:
            self.byte_evictions += 1
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            return
        old = self._data.get(key)
        if old is not None:
            self._bytes -= old.nbytes
        self._data[key] = CacheEntry(table, epoch, value, nb)
        self._data.move_to_end(key)
        self._bytes += nb
        while len(self._data) > self.capacity:
            self._pop_lru()
        while self.max_bytes > 0 and self._bytes > self.max_bytes \
                and self._data:
            self._pop_lru(byte_evict=True)

    def _pop_lru(self, byte_evict: bool = False):
        _, entry = self._data.popitem(last=False)
        self._bytes -= entry.nbytes
        if byte_evict:
            self.byte_evictions += 1

    def purge_table(self, table: str):
        """Eagerly drop every entry belonging to ``table``."""
        dead = [k for k, e in self._data.items() if e.table == table]
        for k in dead:
            self._bytes -= self._data[k].nbytes
            del self._data[k]

    def clear(self):
        """Drop every entry (counters are preserved)."""
        self._data.clear()
        self._bytes = 0

    @property
    def hit_rate(self) -> float:
        """Lifetime hits / (hits + misses); 0.0 before any lookup."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """Size/capacity/byte-budget/hit counters for telemetry snapshots."""
        return {"size": len(self._data), "capacity": self.capacity,
                "bytes": self._bytes, "max_bytes": self.max_bytes,
                "byte_evictions": self.byte_evictions,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate}
