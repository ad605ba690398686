"""Port copy of tests/test_serving.py on ``repro_torch.serve.aqp`` (the
CPU: ``device="cpu"``; the ``"ref"`` mode runs the batched kernel's plain
version), plus the cross-package checks against the reference's server.

Multi-table AQP serving subsystem: catalog, batching oracle-equivalence,
plan/result caches, staleness lifecycle, metrics."""
import dataclasses

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.query import PlanError
from repro_torch.core.types import BuildParams
from repro_torch.serve.aqp import AQPServer, TableCatalog, normalize_sql


def _make_tables():
    rng = np.random.default_rng(7)
    n = 12_000
    sensors = {
        "a": rng.integers(0, 500, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "c": rng.integers(0, 50, n).astype(float),
    }
    logs = {
        "x": rng.integers(0, 300, n).astype(float),
        "y": np.abs(rng.normal(10, 3, n)).round(),
    }
    return sensors, logs


@pytest.fixture(scope="module")
def tables():
    return _make_tables()


@pytest.fixture(scope="module")
def frameworks(tables):
    params = BuildParams(n_samples=6_000, seed=1)
    sensors, logs = tables
    fws = {}
    for name, tbl in (("sensors", sensors), ("logs", logs)):
        fws[name] = AQPFramework(params=params,
                                 use_compression=False,
                                 device="cpu").ingest(tbl)
    return fws


def _server(frameworks, mode, **kwargs):
    srv = AQPServer(mode=mode, **kwargs, device="cpu")
    for name, fw in frameworks.items():
        srv.register(name, fw)
    return srv


def _mixed_workload():
    """>= 32 queries across 2 tables: AND batches, same-col, OR fallbacks,
    GROUP-BY-free aggregates of every kind."""
    sqls = []
    for thr in (60, 80, 100, 120, 140, 160):
        sqls.append(f"SELECT COUNT(a) FROM sensors WHERE b > {thr} AND c < 25")
        sqls.append(f"SELECT AVG(b) FROM sensors WHERE a < {thr * 3} AND c >= 5")
        sqls.append(f"SELECT SUM(b) FROM sensors WHERE b <= {thr + 60}")
        sqls.append(f"SELECT SUM(y) FROM logs WHERE x > {thr}")
        sqls.append(f"SELECT COUNT(*) FROM logs WHERE x < {thr} OR y > 12")
    sqls += [
        "SELECT MIN(b) FROM sensors WHERE b > 90 AND a < 400",
        "SELECT MAX(b) FROM sensors WHERE b < 180 AND c > 2",
        "SELECT MEDIAN(y) FROM logs WHERE x >= 50 AND x < 250",
        "SELECT VAR(y) FROM logs WHERE x > 20",
        "SELECT COUNT(*) FROM sensors WHERE (a < 100 OR c > 40) AND b > 70",
        "SELECT AVG(y) FROM logs",
    ]
    return sqls


# ------------------------------------------------------------------- catalog


def test_unknown_table_raises_plan_error(frameworks):
    srv = _server(frameworks, mode="numpy")
    with pytest.raises(PlanError) as exc:
        srv.query("SELECT COUNT(*) FROM nope WHERE a > 1")
    msg = str(exc.value)
    assert "unknown table 'nope'" in msg
    assert "logs" in msg and "sensors" in msg


def test_catalog_resolve_and_epoch(frameworks):
    cat = TableCatalog(device="cpu")
    cat.register("sensors", frameworks["sensors"])
    assert "sensors" in cat and "nope" not in cat
    assert cat.epoch("sensors") == frameworks["sensors"].epoch
    assert cat.epoch("nope") == -1
    with pytest.raises(PlanError):
        cat.resolve("nope")


# ------------------------------------------------- batched oracle equivalence


def test_batched_numpy_mode_bit_for_bit(frameworks):
    """numpy scheduler mode routes through the exact sequential code path."""
    srv = _server(frameworks, mode="numpy")
    sqls = _mixed_workload()
    assert len(sqls) >= 32
    got = srv.query_batch(sqls)
    for sql, res in zip(sqls, got):
        table = "sensors" if "sensors" in sql else "logs"
        ref = frameworks[table].engine.query(sql)
        assert res.as_tuple() == ref.as_tuple(), sql


def test_batched_kernel_mode_matches_sequential(frameworks):
    """Fused batched launches (the CUDA kernel's plain PyTorch version,
    f32) match the sequential f64 reference to fp tolerance; OR trees fall
    back and match exactly."""
    srv = _server(frameworks, mode="ref")
    sqls = _mixed_workload()
    got = srv.query_batch(sqls)
    n_batched = sum(t["batched"] for t in srv.stats()["tables"].values())
    assert n_batched >= 20          # the AND templates actually fused
    for sql, res in zip(sqls, got):
        table = "sensors" if "sensors" in sql else "logs"
        ref = frameworks[table].engine.query(sql)
        np.testing.assert_allclose(res.as_tuple(), ref.as_tuple(),
                                   rtol=1e-4, atol=1e-6, err_msg=sql)
        if " OR " in sql:           # fallback path: identical code
            assert res.as_tuple() == ref.as_tuple(), sql


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_cuda_kernel_matches_sequential(frameworks, cuda):
    """The hand-written batched kernel on the card (the reference runs its
    Pallas kernel in interpret mode here)."""
    srv = AQPServer(mode="cuda", min_group=1, device=cuda)
    for name, fw in frameworks.items():
        srv.register(name, fw)
    sqls = ["SELECT COUNT(a) FROM sensors WHERE b > 100 AND c < 30",
            "SELECT COUNT(a) FROM sensors WHERE b > 80 AND c < 40",
            "SELECT AVG(b) FROM sensors WHERE a < 300 AND c < 40",
            "SELECT SUM(y) FROM logs WHERE x > 120 AND y < 16",
            "SELECT COUNT(x) FROM logs WHERE x <= 240 AND y >= 6"]
    got = srv.query_batch(sqls)
    for sql, res in zip(sqls, got):
        table = "sensors" if "sensors" in sql else "logs"
        ref = frameworks[table].engine.query(sql)
        np.testing.assert_allclose(res.as_tuple(), ref.as_tuple(),
                                   rtol=1e-4, atol=1e-6, err_msg=sql)
    # the same-shape queries fused into K1 launches (not five singles)
    assert sum(t["batched"] for t in srv.stats()["tables"].values()) > 0


# ------------------------------------------------------------------- caching


def test_plan_and_result_cache_hits(frameworks):
    srv = _server(frameworks, mode="ref")
    sql = "SELECT COUNT(a) FROM sensors WHERE b > 110 AND c < 20"
    first = srv.query(sql)
    again = srv.query("  SELECT  COUNT(a)  FROM sensors "
                      "WHERE b > 110 AND c < 20 ; ")   # same after normalize
    assert again.as_tuple() == first.as_tuple()
    st = srv.stats()["totals"]
    assert st["result_cache"]["hits"] == 1
    assert st["queries_executed"] == 1      # second answer came from cache
    # duplicate within one wave executes once
    res = srv.query_batch(["SELECT SUM(y) FROM logs WHERE x > 99"] * 5)
    assert len({r.as_tuple() for r in res}) == 1
    assert srv.stats()["totals"]["queries_executed"] == 2


def test_result_cache_byte_budget():
    """The byte budget evicts from the LRU end until the estimated
    footprint fits, counts those evictions separately, and drops a value
    larger than the whole budget outright."""
    from repro_torch.serve.aqp.cache import LRUCache, approx_nbytes
    payload = np.zeros(1000)                     # ~8 KB each
    per_entry = approx_nbytes(payload)
    assert per_entry >= payload.nbytes
    cache = LRUCache(capacity=100, max_bytes=3 * per_entry)
    for i in range(5):
        cache.put(f"q{i}", "t", 1, payload)
    assert len(cache) == 3                       # budget, not capacity, binds
    assert cache.nbytes <= cache.max_bytes
    assert cache.byte_evictions == 2
    assert cache.get("q0", lambda t: 1) is None  # LRU end evicted
    assert cache.get("q4", lambda t: 1) is not None
    # refreshing an existing key replaces its bytes, not double-counts
    before = cache.nbytes
    cache.put("q4", "t", 1, payload)
    assert cache.nbytes == before
    # an oversized single value never sticks AND never churns warm
    # entries out on its way through
    cache.put("big", "t", 1, np.zeros(10_000))
    assert cache.get("big", lambda t: 1) is None
    assert len(cache) == 3                       # q2/q3/q4 survived
    assert cache.get("q4", lambda t: 1) is not None
    assert cache.nbytes <= cache.max_bytes
    # purge/stale eviction keep the ledger consistent
    cache.purge_table("t")
    assert cache.nbytes == 0 and len(cache) == 0
    st = cache.stats()
    assert st["max_bytes"] == 3 * per_entry
    assert st["byte_evictions"] == cache.byte_evictions


def test_server_max_result_bytes_knob(frameworks):
    """max_result_bytes wires through to the result cache and surfaces in
    the telemetry snapshot; a tiny budget keeps the cache near-empty but
    answers stay correct."""
    srv = _server(frameworks, mode="numpy", max_result_bytes=1)
    sqls = [f"SELECT COUNT(a) FROM sensors WHERE b > {100 + i}"
            for i in range(4)]
    res = srv.query_batch(sqls)
    assert all(r.estimate is not None for r in res)
    st = srv.stats()["totals"]["result_cache"]
    assert st["max_bytes"] == 1
    assert st["size"] == 0                   # every result outgrew the budget
    assert st["byte_evictions"] >= len(sqls)
    assert st["bytes"] == 0
    srv.close()


def test_normalize_sql():
    assert normalize_sql("  SELECT COUNT(*)\n FROM t ; ") \
        == "SELECT COUNT(*) FROM t"
    # quoted literals survive verbatim: the server parses the normalized
    # text, so 'New  York' must keep its double space (and distinct
    # literals must not collide onto one cache key)
    a = normalize_sql("SELECT COUNT(*) FROM t WHERE city = 'New  York'")
    b = normalize_sql("SELECT COUNT(*) FROM t WHERE city = 'New York'")
    assert "'New  York'" in a and a != b


def test_reregister_detaches_old_framework(tables):
    """A replaced framework can no longer purge its successor's caches."""
    sensors, _ = tables
    params = BuildParams(n_samples=2_000, seed=4)
    fw1 = AQPFramework(params=params, use_compression=False,
                       device="cpu").ingest(sensors)
    fw2 = AQPFramework(params=params, use_compression=False,
                       device="cpu").ingest(sensors)
    srv = AQPServer(mode="numpy", device="cpu").register("t", fw1)
    srv.register("t", fw2)               # replace: fw1 wiring detached
    sql = "SELECT COUNT(*) FROM t WHERE a >= 0"
    srv.query(sql)
    assert len(srv.result_cache) == 1
    fw1.append_rows({k: np.asarray(v)[:10] for k, v in sensors.items()})
    assert len(srv.result_cache) == 1    # fw1's bump didn't purge fw2 entries
    fw2.append_rows({k: np.asarray(v)[:10] for k, v in sensors.items()})
    assert len(srv.result_cache) == 0    # fw2's bump did


# ------------------------------------------------------- staleness lifecycle


def test_staleness_lifecycle_and_cache_invalidation(tables):
    sensors, _ = tables
    params = BuildParams(n_samples=4_000, seed=2)
    fw = AQPFramework(params=params, use_compression=False,
                      device="cpu").ingest(sensors)
    srv = AQPServer(mode="ref", device="cpu").register("sensors", fw)

    sql = "SELECT COUNT(*) FROM sensors WHERE a >= 0"
    before = srv.query(sql)
    assert srv.query(sql).as_tuple() == before.as_tuple()  # cached

    extra = {k: np.asarray(v)[:2_000] for k, v in sensors.items()}
    fw.append_rows(extra)
    assert fw.is_stale
    with pytest.raises(RuntimeError, match="stale"):
        srv.query(sql)                  # cache is NOT consulted when stale
    with pytest.raises(RuntimeError, match="stale"):
        fw.query(sql)                   # single-table contract unchanged

    fw.rebuild(sensors)
    after = srv.query(sql)
    assert after.estimate is not None
    # the rebuilt table has 2k more rows: a stale cached COUNT would be wrong
    assert after.estimate > before.estimate
    np.testing.assert_allclose(after.estimate, fw.synopsis.n_rows, rtol=1e-6)
    # batched path after rebuild uses the NEW synopsis's kernel stacks
    # (stack cache lives on the PairwiseHist, dies with it)
    batched_sql = "SELECT COUNT(a) FROM sensors WHERE b > 100 AND c < 25"
    got = srv.query_batch([batched_sql,
                           "SELECT COUNT(a) FROM sensors "
                           "WHERE b > 120 AND c < 25"])
    ref = fw.engine.query(batched_sql)
    np.testing.assert_allclose(got[0].as_tuple(), ref.as_tuple(),
                               rtol=1e-4, atol=1e-6)


def test_epoch_bumps(tables):
    sensors, _ = tables
    params = BuildParams(n_samples=2_000, seed=3)
    fw = AQPFramework(params=params, use_compression=False, device="cpu")
    seen = []
    fw.on_invalidate(lambda f: seen.append(f.epoch))
    fw.ingest(sensors)
    fw.append_rows({k: np.asarray(v)[:100] for k, v in sensors.items()})
    fw.rebuild(sensors)
    # epochs are strictly increasing and drawn from a process-global
    # sequence: no two frameworks can ever share an epoch value
    assert len(seen) == 3 and seen == sorted(set(seen))
    fw2 = AQPFramework(params=params, use_compression=False, device="cpu")
    fw2.ingest({k: np.asarray(v)[:500] for k, v in sensors.items()})
    assert fw2.epoch > fw.epoch


def test_replacing_table_via_catalog_cannot_serve_stale(tables):
    """Even bypassing AQPServer.register (raw catalog swap), globally
    unique epochs make the old table's cached results unservable."""
    sensors, _ = tables
    params = BuildParams(n_samples=2_000, seed=5)
    small = {k: np.asarray(v)[:4_000] for k, v in sensors.items()}
    big = {k: np.asarray(v)[:9_000] for k, v in sensors.items()}
    fw1 = AQPFramework(params=params, use_compression=False,
                       device="cpu").ingest(small)
    fw2 = AQPFramework(params=params, use_compression=False,
                       device="cpu").ingest(big)
    srv = AQPServer(mode="numpy", device="cpu").register("t", fw1)
    sql = "SELECT COUNT(*) FROM t WHERE a >= 0"
    assert round(srv.query(sql).estimate) == 4_000
    srv.catalog.register("t", fw2)       # raw swap, no server wiring
    assert round(srv.query(sql).estimate) == 9_000


def test_unregister_and_close_detach(tables):
    sensors, _ = tables
    params = BuildParams(n_samples=2_000, seed=6)
    fw = AQPFramework(params=params, use_compression=False,
                      device="cpu").ingest(sensors)
    srv = AQPServer(mode="numpy", device="cpu").register("t", fw)
    srv.query("SELECT COUNT(*) FROM t WHERE a >= 0")
    srv.unregister("t")
    assert len(srv.result_cache) == 0 and not fw._invalidate_cbs
    with pytest.raises(PlanError):
        srv.query("SELECT COUNT(*) FROM t WHERE a >= 0")
    srv2 = AQPServer(mode="numpy", device="cpu").register("t", fw)
    srv2.close()
    assert not fw._invalidate_cbs       # discarded server is unreferenced


# ---------------------------------------------------------------- cold tier


@pytest.fixture(scope="module")
def cold_blob(tables):
    """A bit-packed synopsis blob + its CompressedTable, built GD-natively."""
    from repro_torch.core import storage
    sensors, _ = tables
    fw = AQPFramework(params=BuildParams(n_samples=4_000, seed=11),
                      use_compression=True, device="cpu").ingest(sensors)
    return storage.encode(fw.synopsis), fw.compressed, fw


def test_cold_catalog_lazy_decode_once(cold_blob):
    blob, compressed, fw = cold_blob
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("sensors", blob, compressed=compressed)
    cold = srv.catalog.resolve("sensors")
    # Registration and epoch reads never decode (submit-path safety).
    assert srv.catalog.epoch("sensors") == cold.epoch
    assert cold.cold_info()["decoded"] is False and cold.decode_count == 0
    sql = "SELECT COUNT(a) FROM sensors WHERE b > 100"
    res = srv.query(sql)
    assert cold.decode_count == 1
    # Decoded synopsis answers like the live framework it was encoded from.
    ref = fw.engine.query(sql)
    np.testing.assert_allclose(res.as_tuple(), ref.as_tuple(),
                               rtol=1e-9, atol=1e-9)
    # Subsequent queries reuse the decoded engine — decode-once.
    srv.query("SELECT AVG(b) FROM sensors WHERE a < 300")
    assert cold.decode_count == 1
    st = srv.stats()["tables"]["sensors"]["cold"]
    assert st["decodes"] == 1 and st["synopsis_bytes"] == len(blob)
    assert st["decode_ms"] is not None and st["decode_ms"] > 0
    srv.close()


def test_cold_epoch_stable_across_decode_bumps_on_rebuild(cold_blob):
    blob, compressed, _ = cold_blob
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("sensors", blob, compressed=compressed)
    cold = srv.catalog.resolve("sensors")
    e0 = srv.catalog.epoch("sensors")
    srv.query("SELECT COUNT(*) FROM sensors WHERE a >= 0")
    # The first decode changes representation, not table state: epoch-keyed
    # cache entries written after it stay valid.
    assert srv.catalog.epoch("sensors") == e0
    assert len(srv.result_cache) == 1
    # GD-native rebuild: fresh epoch, invalidation purges the caches.
    cold.rebuild()
    assert srv.catalog.epoch("sensors") > e0
    assert len(srv.result_cache) == 0
    res = srv.query("SELECT COUNT(*) FROM sensors WHERE a >= 0")
    assert res.estimate is not None
    assert cold.decode_count == 1       # rebuild publishes directly, no decode
    assert cold.cold_info()["bytes"] > 0
    srv.close()


def test_register_cold_invalid_blob_leaves_no_phantom_metrics():
    """Regression: ``register_cold`` recorded cold telemetry *before* the
    blob's magic was validated, so a rejected registration left a phantom
    metrics entry (and a ``cold`` stats section) for a table that was
    never registered. Validation must come first."""
    srv = AQPServer(mode="numpy", device="cpu")
    with pytest.raises(ValueError):
        srv.register_cold("ghost", b"NOPE" + b"\x00" * 64)
    assert "ghost" not in srv.catalog
    assert "ghost" not in srv.stats()["tables"]
    assert "ghost" not in srv.metrics._tables
    srv.close()


def test_register_cold_corrupted_blob_rejected_at_registration(cold_blob):
    """A bit-flipped or truncated blob is refused AT registration (typed
    IntegrityError from the frame check), before any metrics/catalog entry
    exists — corruption is caught at the door, not at first query."""
    from repro_torch.core.storage import IntegrityError
    blob, _, _ = cold_blob
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0x10
    for bad in (bytes(flipped), blob[: len(blob) // 2]):
        srv = AQPServer(mode="numpy", device="cpu")
        with pytest.raises(IntegrityError):
            srv.register_cold("ghost", bad)
        assert "ghost" not in srv.catalog
        assert "ghost" not in srv.stats()["tables"]
        srv.close()


def test_cold_first_query_decode_failure_is_typed_with_telemetry(cold_blob):
    """Decode failing on FIRST access (blob fine at registration, fault at
    decode time) resolves typed and records retry/quarantine telemetry —
    queriers never hang on a sick cold table."""
    from repro_torch.serve.aqp import TableQuarantinedError, faults
    blob, _, _ = cold_blob
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("sensors", blob, decode_retries=1,
                      decode_backoff_s=0.001)
    plan = faults.FaultPlan().fail("cold_decode", first=2)
    with faults.installed(plan):
        fut = srv.submit("SELECT COUNT(a) FROM sensors WHERE b > 100")
        srv.flush()
        with pytest.raises(TableQuarantinedError):
            fut.result(timeout=30)
    flt = srv.stats()["totals"]["faults"]
    assert flt["decode_retries"] == 1 and flt["quarantined"] == 1
    cold = srv.catalog.resolve("sensors")
    assert cold.quarantined
    assert cold.cold_info()["quarantined"] is True
    assert cold.cold_info()["decode_failures"] == 2
    srv.close()


def test_cold_quarantine_reregister_recovers_cleanly(cold_blob):
    """Quarantine -> re-register lifecycle: the replacement table serves,
    the breaker state is gone, and no stale failure telemetry leaks into
    the fresh table's stats."""
    from repro_torch.serve.aqp import TableQuarantinedError, faults
    blob, compressed, fw = cold_blob
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("sensors", blob, decode_retries=0,
                      decode_backoff_s=0.001)
    with faults.installed(faults.FaultPlan().fail("cold_decode", at=[0])):
        fut = srv.submit("SELECT COUNT(a) FROM sensors WHERE b > 100")
        srv.flush()
        with pytest.raises(TableQuarantinedError):
            fut.result(timeout=30)
    srv.register_cold("sensors", blob, compressed=compressed)
    cold = srv.catalog.resolve("sensors")
    assert not cold.quarantined and cold.decode_failures == 0
    sql = "SELECT COUNT(a) FROM sensors WHERE b > 100"
    res = srv.query(sql)
    np.testing.assert_allclose(res.as_tuple(),
                               fw.engine.query(sql).as_tuple(),
                               rtol=1e-9, atol=1e-9)
    st = srv.stats()["tables"]["sensors"]["cold"]
    assert st["decodes"] == 1
    srv.close()


def test_cold_rebuild_without_compressed_table_refuses(cold_blob):
    blob, _, _ = cold_blob
    cat = TableCatalog(device="cpu")
    cold = cat.register_cold("t", blob)          # no CompressedTable attached
    with pytest.raises(RuntimeError, match="CompressedTable"):
        cold.rebuild()


def test_cold_concurrent_first_access_decodes_once(cold_blob):
    """No stale serve mid-decode: concurrent first readers block on the one
    decode and all observe the same atomic (engine, epoch) pair."""
    import threading
    blob, compressed, _ = cold_blob
    cat = TableCatalog(device="cpu")
    cat.register_cold("t", blob, compressed=compressed)
    cold = cat.resolve("t")
    seen = []
    barrier = threading.Barrier(8)

    def reader():
        barrier.wait()
        seen.append(cat.snapshot("t"))

    threads = [threading.Thread(target=reader) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cold.decode_count == 1
    engines = {id(eng) for eng, _ in seen}
    epochs = {ep for _, ep in seen}
    assert len(engines) == 1 and len(epochs) == 1
    assert epochs == {cold.epoch}


# ------------------------------------------------------------------- metrics


def test_metrics_snapshot(frameworks):
    srv = _server(frameworks, mode="ref")
    srv.query_batch(_mixed_workload())
    snap = srv.stats()
    for name in ("sensors", "logs"):
        tm = snap["tables"][name]
        assert tm["queries_executed"] > 0
        assert tm["p50_ms"] is not None and tm["p99_ms"] is not None
        assert tm["p50_ms"] <= tm["p99_ms"] + 1e-9
    assert 0.0 < snap["totals"]["batched_fraction"] <= 1.0
    assert "hit_rate" in snap["totals"]["plan_cache"]


# ------------------------------------------------ against the reference server


@pytest.fixture(scope="module")
def ref_frameworks(tables):
    from repro.aqp.engine import AQPFramework as RefFramework
    from repro.core.types import BuildParams as RefParams
    sensors, logs = tables
    return {name: RefFramework(params=RefParams(n_samples=6_000, seed=1),
                               use_compression=False).ingest(tbl)
            for name, tbl in (("sensors", sensors), ("logs", logs))}


def test_numpy_server_bit_identical_to_reference_server(frameworks,
                                                        ref_frameworks):
    """The same tables and queries through the reference's server and the
    port's, both in ``"numpy"`` mode: identical answers. The port's
    ``"ref"`` mode (fused launches, the kernel's plain version in f32) is
    fp-close to them at the reference's kernel-mode tolerance."""
    from repro.serve.aqp import AQPServer as RefServer
    ref = RefServer(mode="numpy")
    for name, fw in ref_frameworks.items():
        ref.register(name, fw)
    port = _server(frameworks, mode="numpy")
    fused = _server(frameworks, mode="ref")
    try:
        sqls = _mixed_workload()
        want = ref.query_batch(sqls)
        got = port.query_batch(sqls)
        got_fused = fused.query_batch(sqls)
        for sql, w, g, f in zip(sqls, want, got, got_fused):
            assert g.as_tuple() == w.as_tuple(), sql
            np.testing.assert_allclose(f.as_tuple(), w.as_tuple(),
                                       rtol=1e-4, atol=1e-6, err_msg=sql)
        n_batched = sum(t["batched"]
                        for t in fused.stats()["tables"].values())
        assert n_batched >= 20
    finally:
        for srv in (ref, port, fused):
            srv.close()


def test_default_server_needs_cuda(monkeypatch):
    """``AQPServer()`` means the card: without one it raises, naming the
    CPU opt-in, instead of serving from the host."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AQPServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AQPServer(mode="numpy")
    with pytest.raises(ValueError, match="mode='ref'"):
        AQPServer(mode="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler mode"):
        AQPServer(mode="pallas", device="cpu")


def test_concurrent_waves_share_the_stack_cache(frameworks):
    """Waves from many threads at once on one synopsis (the server's
    admission thread and planner pool issue launches from threads other
    than the one that built the stacks): every wave gets the sequential
    answers, whichever thread fills ``FastPath``'s stack cache."""
    import sys
    import threading

    from repro_torch.serve.aqp import BatchScheduler
    cat = TableCatalog(device="cpu")
    for name, fw in frameworks.items():
        cat.register(name, fw)
    items = [(("sensors" if "sensors" in s else "logs"),
              cat.engine("sensors" if "sensors" in s else "logs").plan_sql(s))
             for s in _mixed_workload()]
    want = [r.result.as_tuple() for r in
            BatchScheduler(cat, mode="ref").execute(items)]
    for fw in frameworks.values():      # start each thread from a cold cache
        fw.synopsis.__dict__.pop("_fastpath_stacks", None)
    results, errors = [None] * 16, []

    def wave(ti):
        try:
            res = BatchScheduler(cat, mode="ref").execute(items)
            results[ti] = [r.result.as_tuple() for r in res]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=wave, args=(ti,))
                   for ti in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert all(r == want for r in results)
