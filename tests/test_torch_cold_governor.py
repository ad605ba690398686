"""Port copy of tests/test_cold_governor.py on ``repro_torch.serve.aqp``, on
the CPU (``device="cpu"``).

Cold-tier memory governor + catalog/rebuild race regressions.

Covers the demote/re-promote lifecycle (epoch stability, bit-identical
answers, cache validity, in-flight waves racing a demote, rebuild-then-
demote freshness), the byte-budget stress (high-water telemetry proves
resident engine bytes stay within ``max_engine_bytes``), and two threaded
regressions that fail on the pre-fix code: the unlocked ``TableCatalog``
registry dict and ``ColdTable.rebuild``'s last-write-wins publication.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core import storage
from repro_torch.core.types import BuildParams
from repro_torch.serve.aqp import AQPServer, TableCatalog
from repro_torch.serve.aqp import catalog as catalogmod


@pytest.fixture(scope="module")
def cold_fixture():
    """A small GD-compressed table, its synopsis blob, and the live fw."""
    rng = np.random.default_rng(3)
    n = 6_000
    table = {
        "a": rng.integers(0, 400, n).astype(float),
        "b": np.abs(rng.normal(80, 25, n)).round(),
        "c": rng.integers(0, 40, n).astype(float),
    }
    fw = AQPFramework(params=BuildParams(n_samples=2_500, seed=5),
                      use_compression=True, device="cpu").ingest(table)
    return storage.encode(fw.synopsis), fw.compressed, fw


QUERIES = [
    "SELECT COUNT(a) FROM {t} WHERE b > 70",
    "SELECT AVG(b) FROM {t} WHERE a < 250",
    "SELECT SUM(b) FROM {t} WHERE c >= 10",
]


# ----------------------------------------------------- demote / re-promote


def test_demote_repromote_lifecycle(cold_fixture):
    """Epoch stable across demote; answers before/after re-promotion are
    bit-identical; telemetry counts every transition."""
    blob, compressed, _ = cold_fixture
    srv = AQPServer(mode="numpy", result_cache_size=0, device="cpu")
    srv.register_cold("t", blob, compressed=compressed)
    cold = srv.catalog.resolve("t")
    sqls = [q.format(t="t") for q in QUERIES]
    before = [srv.query(s).as_tuple() for s in sqls]
    e0 = cold.epoch
    assert cold.decode_count == 1 and cold.resident_bytes > 0

    assert srv.demote("t") is True
    assert cold.epoch == e0                 # representation, not state
    assert cold.engine is None and cold.resident_bytes == 0
    assert srv.demote("t") is False         # already cold: no-op

    after = [srv.query(s).as_tuple() for s in sqls]
    assert after == before                  # bit-identical, not just close
    assert cold.decode_count == 2 and cold.demote_count == 1
    tm = srv.stats()["tables"]["t"]["cold"]
    assert tm["decodes"] == 2 and tm["demotes"] == 1
    info = cold.cold_info()
    assert info["demote_count"] == 1 and info["decoded"] is True
    srv.close()


def test_result_cache_survives_demote(cold_fixture):
    """Demote is epoch-stable, so result-cache entries stay valid: a repeat
    query after the demote is a cache hit and never re-decodes."""
    blob, compressed, _ = cold_fixture
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("t", blob, compressed=compressed)
    cold = srv.catalog.resolve("t")
    sql = "SELECT COUNT(a) FROM t WHERE b > 70"
    first = srv.query(sql)
    assert len(srv.result_cache) == 1 and cold.decode_count == 1
    assert srv.demote("t")
    assert len(srv.result_cache) == 1       # no spurious purge
    hit = srv.query(sql)
    assert hit.as_tuple() == first.as_tuple()
    assert cold.decode_count == 1           # served cold, straight from cache
    assert srv.stats()["tables"]["t"]["result_cache_hits"] == 1
    srv.close()


def test_inflight_engine_survives_demote(cold_fixture):
    """A wave holding the pre-demote (engine, epoch) snapshot finishes
    safely: demote swaps the published tuple, never touches the engine."""
    blob, compressed, _ = cold_fixture
    cat = TableCatalog(device="cpu")
    cat.register_cold("t", blob, compressed=compressed)
    cold = cat.resolve("t")
    engine, epoch = cat.snapshot("t")       # the wave's held reference
    assert cold.demote() is True
    assert cold.engine is None
    # The held engine still answers — and identically to a re-decode.
    from repro_torch.core.sql import parse_sql
    plan = engine.plan_query(parse_sql("SELECT AVG(b) FROM t WHERE a < 250"))
    held = engine.execute_plan(plan).as_tuple()
    engine2, epoch2 = cat.snapshot("t")     # transparent re-decode
    assert epoch2 == epoch and cold.decode_count == 2
    assert engine2.execute_plan(plan).as_tuple() == held


def test_queries_racing_demote_storm(cold_fixture):
    """Queries submitted while another thread demotes in a tight loop all
    come back bit-identical to an undisturbed server's answers."""
    blob, compressed, _ = cold_fixture
    ref = AQPServer(mode="numpy", device="cpu")
    ref.register_cold("t", blob, compressed=compressed)
    sqls = [q.format(t="t") for q in QUERIES] * 4
    expected = [ref.query(s).as_tuple() for s in sqls]
    ref.close()

    srv = AQPServer(mode="numpy", result_cache_size=0, device="cpu")
    srv.register_cold("t", blob, compressed=compressed)
    stop = threading.Event()

    def demoter():
        while not stop.is_set():
            srv.demote("t")

    th = threading.Thread(target=demoter)
    th.start()
    try:
        got = [srv.query(s).as_tuple() for s in sqls]
    finally:
        stop.set()
        th.join()
    assert got == expected
    assert srv.catalog.resolve("t").demote_count >= 1
    srv.close()


def test_rebuild_then_demote_serves_fresh_state(cold_fixture):
    """Demote after a rebuild re-promotes to the *rebuilt* synopsis, never
    the registration-time blob; and if the blob ever lags the published
    epoch, demote re-encodes before dropping the engine."""
    blob, compressed, _ = cold_fixture
    srv = AQPServer(mode="numpy", result_cache_size=0, device="cpu")
    srv.register_cold("t", blob, compressed=compressed,
                      params=BuildParams(n_samples=2_500, seed=5))
    cold = srv.catalog.resolve("t")
    srv.query("SELECT COUNT(a) FROM t WHERE b > 70")
    cold.rebuild(BuildParams(n_samples=1_800, seed=9))
    rebuilt = [srv.query(q.format(t="t")).as_tuple() for q in QUERIES]
    assert cold.engine.ph.n_sampled == 1_800
    assert srv.demote("t")
    again = [srv.query(q.format(t="t")).as_tuple() for q in QUERIES]
    assert again == rebuilt
    assert cold.engine.ph.n_sampled == 1_800    # not the 2_500-sample seed

    # Defensive branch: force blob/engine divergence (as if the encode had
    # been deferred) and check demote re-encodes rather than losing state.
    stale_blob = cold.blob
    cold._blob_epoch = cold.epoch - 1
    assert srv.demote("t")
    assert cold.blob != stale_blob or storage.decode(cold.blob).n_sampled == 1_800
    assert cold._blob_epoch == cold.epoch
    final = [srv.query(q.format(t="t")).as_tuple() for q in QUERIES]
    assert final == rebuilt
    srv.close()


# ------------------------------------------------------------ byte budget


def test_budget_stress_high_water(cold_fixture):
    """Many cold tables under ``max_engine_bytes``: resident engine bytes
    never exceed the budget (post-enforcement high-water proves it), the
    governor actually demotes, and every answer is bit-identical to an
    unbudgeted server's."""
    blob, compressed, _ = cold_fixture
    engine_bytes = storage.decode(blob).nbytes
    names = [f"t{i:02d}" for i in range(12)]

    ref = AQPServer(mode="numpy", result_cache_size=0, device="cpu")
    srv = AQPServer(mode="numpy", result_cache_size=0,
                    max_engine_bytes=3 * engine_bytes, device="cpu")
    for s in (ref, srv):
        for name in names:
            s.register_cold(name, blob, compressed=compressed)

    sqls = [QUERIES[i % len(QUERIES)].format(t=name)
            for i in range(2) for name in names]
    expected = [ref.query(s).as_tuple() for s in sqls]
    ref.close()
    got = [srv.query(s).as_tuple() for s in sqls]
    assert got == expected

    st = srv.stats()["cold"]
    assert st["max_engine_bytes"] == 3 * engine_bytes
    assert st["demotes"] > 0
    assert 0 < st["resident_high_water"] <= 3 * engine_bytes
    assert st["resident_bytes"] <= 3 * engine_bytes
    total = sum(t.resident_bytes for _, t in srv.catalog.cold_tables())
    assert total <= 3 * engine_bytes
    srv.close()


def test_idle_demotion_between_waves(cold_fixture):
    """``demote_idle_s``: a table idle past the window demotes on the next
    between-waves sweep; an active table does not."""
    blob, compressed, _ = cold_fixture
    srv = AQPServer(mode="numpy", demote_idle_s=0.15, result_cache_size=0,
                    device="cpu")
    srv.register_cold("idle", blob, compressed=compressed)
    srv.register_cold("hot", blob, compressed=compressed)
    srv.query("SELECT COUNT(a) FROM idle WHERE b > 70")
    time.sleep(0.3)
    # A wave against the hot table triggers the sweep; "hot" was active in
    # this very wave, "idle" was not.
    srv.query("SELECT COUNT(a) FROM hot WHERE b > 70")
    deadline = time.time() + 2.0
    idle = srv.catalog.resolve("idle")
    while idle.engine is not None and time.time() < deadline:
        time.sleep(0.01)
    assert idle.engine is None and idle.demote_count == 1
    assert srv.catalog.resolve("hot").engine is not None
    res = srv.query("SELECT COUNT(a) FROM idle WHERE b > 70")  # re-promotes
    assert res.estimate is not None and idle.decode_count == 2
    srv.close()


# --------------------------------------------------- regression: catalog race


def test_catalog_register_unregister_race():
    """Registration churn racing ``tables()``/``resolve``/``epoch`` must
    never raise (pre-fix: plain-dict mutation mid-``sorted()`` raised
    ``RuntimeError: dictionary changed size during iteration``)."""

    class _Dummy:
        epoch = 1

    cat = TableCatalog(device="cpu")
    for i in range(300):
        cat.register(f"seed{i:03d}", _Dummy())
    stop = threading.Event()
    errors = []

    def churn(tag):
        i = 0
        while not stop.is_set():
            name = f"{tag}{i % 200:03d}"
            try:
                cat.register(name, _Dummy())
                cat.unregister(name)
            except Exception as exc:    # pragma: no cover - pre-fix only
                errors.append(exc)
                return
            i += 1

    def reader():
        while not stop.is_set():
            try:
                cat.tables()
                # Python-level .items() iteration: without the registry
                # lock this is the line that raises "dictionary changed
                # size during iteration" under churn.
                cat.cold_tables()
                cat.epoch("seed000")
                "seed001" in cat
                len(cat)
            except Exception as exc:    # pragma: no cover - pre-fix only
                errors.append(exc)
                return

    threads = ([threading.Thread(target=churn, args=(t,)) for t in "ab"]
               + [threading.Thread(target=reader) for _ in range(2)])
    for t in threads:
        t.start()
    time.sleep(0.6)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors


# --------------------------------------------- regression: rebuild last-write


def test_concurrent_rebuild_newer_wins(cold_fixture, monkeypatch):
    """A slow rebuild that started first must not clobber a faster one that
    published after it (pre-fix: builds ran outside the lock and the last
    writer won, so the *older* build's engine and blob overwrote the newer
    publication after its callbacks had already fired)."""
    blob, compressed, _ = cold_fixture
    cat = TableCatalog(device="cpu")
    cat.register_cold("t", blob, compressed=compressed,
                      params=BuildParams(n_samples=2_500, seed=5))
    cold = cat.resolve("t")
    cold.published                           # decode so rebuild has columns

    real_build = catalogmod.build_pairwise_hist
    slow_entered = threading.Event()
    release_slow = threading.Event()

    def instrumented(compressed_tbl, columns, params, **kwargs):
        if params.n_samples == 1_000:        # the slow, older rebuild
            slow_entered.set()
            release_slow.wait(timeout=10)
        return real_build(compressed_tbl, columns, params, **kwargs)

    monkeypatch.setattr(catalogmod, "build_pairwise_hist", instrumented)

    published_epochs = []
    cold.on_invalidate(lambda c: published_epochs.append(c.epoch))

    slow = threading.Thread(
        target=cold.rebuild, args=(BuildParams(n_samples=1_000, seed=5),))
    slow.start()
    assert slow_entered.wait(timeout=10)
    # The fast rebuild arrives while the slow one is mid-build.
    fast = threading.Thread(
        target=cold.rebuild, args=(BuildParams(n_samples=2_000, seed=5),))
    fast.start()
    time.sleep(0.1)
    release_slow.set()
    slow.join(timeout=30)
    fast.join(timeout=30)

    # The later-arriving build's state must be what remains published.
    assert cold.engine.ph.n_sampled == 2_000
    assert storage.decode(cold.blob).n_sampled == 2_000
    # Publications observed in strictly increasing epoch order.
    assert published_epochs == sorted(published_epochs)
    assert len(set(published_epochs)) == len(published_epochs)
