"""Port copy of tests/test_faults.py on ``repro_torch.serve.aqp``, on the
CPU (``device="cpu"``).

Deterministic fault injection: FaultPlan scheduling semantics, worker
supervision, per-query deadlines, execution retry/quarantine containment,
cold-tier decode resilience, and a seeded mini-chaos run asserting the
serving invariants (every future resolves — typed error or correct answer,
never a hang; exactly-once; bit-identical retried-through answers)."""
import time

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core import storage
from repro_torch.core.types import BuildParams
from repro_torch.serve.aqp import (AQPServer, DeadlineExceeded, QueryError,
                             TableQuarantinedError, faults)
from repro_torch.serve.aqp.faults import FaultPlan, InjectedFault

TIMEOUT = 30


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """A test that dies mid-``installed`` must not poison its neighbours."""
    yield
    faults.clear()


def _make_table(n=6_000, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 500, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
    }


@pytest.fixture(scope="module")
def framework():
    return AQPFramework(BuildParams(n_samples=3_000, seed=5),
                        use_compression=False,
                        device="cpu").ingest(_make_table())


@pytest.fixture(scope="module")
def blob(framework):
    return storage.encode(framework.engine.ph)


def _server(framework, **kwargs):
    kwargs.setdefault("mode", "numpy")
    return AQPServer(**kwargs, device="cpu").register("t", framework)


# ------------------------------------------------------------ FaultPlan unit


def test_plan_at_schedule_fires_exact_indices():
    plan = FaultPlan().fail("s", at=[1, 3])
    fired = []
    for i in range(5):
        try:
            plan.fire("s")
        except InjectedFault as exc:
            fired.append(exc.index)
            assert exc.site == "s"
    assert fired == [1, 3]
    assert plan.count("s") == 5
    assert plan.injected("s") == 2


def test_plan_first_and_every_schedules():
    plan = FaultPlan().fail("f", first=2).fail("e", every=3)
    f = [i for i in range(6) if _fires(plan, "f")]
    e = [i for i in range(9) if _fires(plan, "e")]
    assert f == [0, 1]
    assert e == [2, 5, 8]          # every=3 -> indices 2, 5, 8 (1-based 3rd)


def _fires(plan, site):
    try:
        plan.fire(site)
    except InjectedFault:
        return True
    return False


def test_plan_rate_is_deterministic_under_seed():
    a = FaultPlan(seed=7).fail("k", rate=0.3)
    b = FaultPlan(seed=7).fail("k", rate=0.3)
    sched_a = [_fires(a, "k") for _ in range(200)]
    sched_b = [_fires(b, "k") for _ in range(200)]
    assert sched_a == sched_b
    assert 20 < sum(sched_a) < 120  # actually probabilistic, not degenerate
    c = FaultPlan(seed=8).fail("k", rate=0.3)
    assert [_fires(c, "k") for _ in range(200)] != sched_a


def test_plan_action_injects_without_raising():
    stalls = []
    plan = FaultPlan().fail("w", at=[0], action=lambda: stalls.append(1))
    plan.fire("w")
    plan.fire("w")
    assert stalls == [1]
    assert plan.injected("w") == 1


def test_plan_custom_exception_factory():
    plan = FaultPlan().fail("d", at=[0],
                            exc=lambda site, i: OSError(f"{site}@{i}"))
    with pytest.raises(OSError, match="d@0"):
        plan.fire("d")


def test_installed_restores_previous_plan():
    assert faults.active() is None
    outer = FaultPlan()
    with faults.installed(outer):
        assert faults.active() is outer
        with faults.installed(FaultPlan()) as inner:
            assert faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None
    faults.hook("anything")        # no plan: must be a silent no-op


def test_snapshot_reports_counts_and_injections():
    plan = FaultPlan().fail("x", at=[0])
    _fires(plan, "x")
    _fires(plan, "x")
    snap = plan.snapshot()
    assert snap["counts"] == {"x": 2}
    assert snap["injected"] == {"x": 1}


# ------------------------------------------------- wave retry and quarantine


def test_wave_fault_retries_to_bit_identical_answer(framework):
    sql = "SELECT COUNT(a) FROM t WHERE b > 95"
    control = _server(framework)
    want = control.query(sql).as_tuple()
    control.close()

    srv = _server(framework)
    with faults.installed(FaultPlan().fail("wave_execute", at=[0])):
        res = srv.query(sql)
    assert res.failed is False
    assert res.as_tuple() == want
    flt = srv.stats()["totals"]["faults"]
    assert flt["exec_retries"] == 1
    assert flt["query_errors"] == 0
    srv.close()


def test_poison_query_quarantines_then_recovers(framework):
    sql = "SELECT COUNT(a) FROM t WHERE b > 96"
    srv = _server(framework)
    with faults.installed(FaultPlan().fail("wave_execute", at=[0, 1])):
        res = srv.query(sql)
    assert isinstance(res, QueryError)
    assert res.failed and res.kind == "execution" and res.retries == 2
    assert "injected fault" in res.error
    # Re-submission is refused from quarantine without touching the wave
    # path (no fault plan installed any more, yet it still fails typed).
    res2 = srv.query(sql)
    assert isinstance(res2, QueryError) and res2.kind == "quarantined"
    q = srv.quarantined()
    assert len(q) == 1 and next(iter(q.values()))["table"] == "t"
    flt = srv.stats()["totals"]["faults"]
    assert flt["quarantined"] >= 1 and flt["query_errors"] >= 2
    # clear_quarantine gives the statement a fresh chance; it now answers.
    srv.clear_quarantine(sql)
    assert srv.quarantined() == {}
    assert srv.query(sql).failed is False
    srv.close()


def test_wave_fault_does_not_poison_neighbours(framework):
    """One wave-level crash retries EVERY submission of the wave and all of
    them answer; exactly-once holds (no duplicate or lost resolution)."""
    srv = _server(framework, max_wait_ms=10_000.0)
    control = _server(framework)
    sqls = [f"SELECT COUNT(a) FROM t WHERE b > {90 + i}" for i in range(4)]
    want = [control.query(s).as_tuple() for s in sqls]
    control.close()
    with faults.installed(FaultPlan().fail("wave_execute", at=[0])):
        futs = [srv.submit(s) for s in sqls]
        srv.flush()
        got = [f.result(timeout=TIMEOUT) for f in futs]
    assert [r.as_tuple() for r in got] == want
    srv.close()


def test_kernel_fault_isolates_to_per_item_fallback(framework):
    """A fused-launch fault must not fail the wave: the scheduler's
    isolation path re-runs items one by one (below min_group, so no second
    fused launch) and every answer is still correct — bit-identical to the
    numpy control, because the fallback IS the numpy path."""
    srv = _server(framework, mode="ref", max_wait_ms=10_000.0)
    control = _server(framework)
    sqls = [f"SELECT COUNT(a) FROM t WHERE b > {80 + i}" for i in range(3)]
    want = [control.query(s).as_tuple() for s in sqls]
    control.close()
    with faults.installed(FaultPlan().fail("kernel_launch", every=1)) as plan:
        futs = [srv.submit(s) for s in sqls]
        srv.flush()
        got = [f.result(timeout=TIMEOUT) for f in futs]
        assert plan.injected("kernel_launch") >= 1
    assert [r.as_tuple() for r in got] == want
    flt = srv.stats()["totals"]["faults"]
    assert flt["query_errors"] == 0    # isolation, not failure
    srv.close()


def test_planner_fault_raises_typed_on_future(framework):
    srv = _server(framework)
    with faults.installed(FaultPlan().fail("planner", at=[0])):
        fut = srv.submit("SELECT COUNT(a) FROM t WHERE b > 97")
        srv.flush()
        with pytest.raises(InjectedFault):
            fut.result(timeout=TIMEOUT)
    # The plan error resolved the future immediately; nothing leaked into
    # the quarantine (plan errors keep exception semantics).
    assert srv.quarantined() == {}
    srv.close()


# ------------------------------------------------------- worker supervision


def test_worker_crash_restarts_and_answers(framework):
    sql = "SELECT COUNT(a) FROM t WHERE b > 98"
    control = _server(framework)
    want = control.query(sql).as_tuple()
    control.close()
    srv = _server(framework)
    with faults.installed(FaultPlan().fail("worker", at=[0])) as plan:
        fut = srv.submit(sql)
        srv.flush()
        res = fut.result(timeout=TIMEOUT)
        assert plan.injected("worker") == 1
    assert res.as_tuple() == want      # exactly-once: re-queued, not lost
    assert srv.admission.restarts == 1
    assert srv.stats()["totals"]["faults"]["worker_restarts"] == 1
    srv.close()


# ---------------------------------------------------------------- deadlines


def test_deadline_expired_resolves_typed_within_bound(framework):
    """A submission whose deadline passes while the wave ahead of it stalls
    resolves with DeadlineExceeded — within 2x the deadline, never a hang —
    and skips the fused launch entirely."""
    srv = _server(framework, max_wait_ms=10_000.0)
    stall = 0.12
    plan = FaultPlan().fail("wave_execute", at=[0],
                            action=lambda: time.sleep(stall))
    with faults.installed(plan):
        t0 = time.perf_counter()
        slow = srv.submit("SELECT COUNT(a) FROM t WHERE b > 99")
        doomed = srv.submit("SELECT COUNT(a) FROM t WHERE b > 100",
                            deadline_ms=100.0)
        srv.flush()
        res = doomed.result(timeout=TIMEOUT)
        waited = time.perf_counter() - t0
    assert isinstance(res, DeadlineExceeded)
    assert res.expired and res.failed is False
    assert res.deadline_ms == pytest.approx(100.0)
    assert res.elapsed_ms >= 100.0
    assert waited < 2 * 0.1 + 0.05     # 2x deadline (+sched slack)
    assert slow.result(timeout=TIMEOUT).estimate is not None
    assert srv.stats()["totals"]["faults"]["deadline_expired"] == 1
    srv.close()


def test_deadline_wakes_drain_before_max_wait(framework):
    """With a huge max_wait the drain must still wake for an imminent
    deadline: the query answers (not expires) long before max_wait."""
    srv = _server(framework, max_wait_ms=30_000.0)
    t0 = time.perf_counter()
    fut = srv.submit("SELECT COUNT(a) FROM t WHERE b > 101",
                     deadline_ms=200.0)
    res = fut.result(timeout=TIMEOUT)   # NO flush: the deadline wakes it
    waited = time.perf_counter() - t0
    assert res.expired is False and res.estimate is not None
    assert waited < 5.0
    adm = srv.stats()["totals"]["admission"]
    assert adm["drain_causes"].get("deadline", 0) >= 1
    srv.close()


def test_deadline_queries_skip_dedupe(framework):
    """Deadline-carrying submissions never share a dedupe entry: the same
    text without a deadline keeps its own contract."""
    srv = _server(framework, max_wait_ms=10_000.0)
    sql = "SELECT COUNT(a) FROM t WHERE b > 102"
    a = srv.submit(sql, deadline_ms=60_000.0)
    b = srv.submit(sql)
    srv.flush()
    ra = a.result(timeout=TIMEOUT)
    rb = b.result(timeout=TIMEOUT)
    assert ra.as_tuple() == rb.as_tuple()
    srv.close()


# ------------------------------------------------------- cold-tier resilience


def test_cold_decode_retry_recovers(framework, blob):
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("c", blob, decode_retries=1, decode_backoff_s=0.001)
    with faults.installed(FaultPlan().fail("cold_decode", at=[0])) as plan:
        res = srv.query("SELECT COUNT(a) FROM c WHERE b > 95")
        assert plan.count("cold_decode") == 2
    assert res.failed is False and res.estimate is not None
    flt = srv.stats()["totals"]["faults"]
    assert flt["decode_retries"] == 1 and flt["quarantined"] == 0
    srv.close()


def test_cold_decode_exhaustion_quarantines_table(framework, blob):
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("c", blob, decode_retries=1, decode_backoff_s=0.001)
    with faults.installed(FaultPlan().fail("cold_decode", first=2)) as plan:
        fut = srv.submit("SELECT COUNT(a) FROM c WHERE b > 96")
        srv.flush()
        with pytest.raises(TableQuarantinedError):
            fut.result(timeout=TIMEOUT)
        n = plan.count("cold_decode")
        # Circuit breaker: the next query fails fast with NO fresh decode
        # attempt (typed, immediate — never a hang).
        fut2 = srv.submit("SELECT COUNT(a) FROM c WHERE b > 97")
        srv.flush()
        with pytest.raises(TableQuarantinedError):
            fut2.result(timeout=TIMEOUT)
        assert plan.count("cold_decode") == n
    ct = srv.catalog.resolve("c")
    assert ct.quarantined and ct.decode_failures == 2
    assert srv.stats()["totals"]["faults"]["quarantined"] >= 1
    # Re-registering the blob clears the breaker; the table serves again.
    srv.register_cold("c", blob)
    assert srv.query("SELECT COUNT(a) FROM c WHERE b > 96").failed is False
    srv.close()


def test_cold_breaker_half_opens_after_reset(framework, blob):
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("c", blob, decode_retries=0, decode_backoff_s=0.001,
                      breaker_reset_s=0.05)
    with faults.installed(FaultPlan().fail("cold_decode", at=[0])):
        fut = srv.submit("SELECT COUNT(a) FROM c WHERE b > 98")
        srv.flush()
        with pytest.raises(TableQuarantinedError):
            fut.result(timeout=TIMEOUT)
        assert srv.catalog.resolve("c").quarantined
        time.sleep(0.06)               # breaker half-opens; index 1 passes
        res = srv.query("SELECT COUNT(a) FROM c WHERE b > 99")
    assert res.failed is False and res.estimate is not None
    assert not srv.catalog.resolve("c").quarantined
    srv.close()


def test_cold_reset_faults_reopens_without_reregister(framework, blob):
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("c", blob, decode_retries=0, decode_backoff_s=0.001)
    with faults.installed(FaultPlan().fail("blob_read", at=[0])):
        fut = srv.submit("SELECT COUNT(a) FROM c WHERE b > 100")
        srv.flush()
        with pytest.raises(TableQuarantinedError):
            fut.result(timeout=TIMEOUT)
        srv.catalog.resolve("c").reset_faults()
        res = srv.query("SELECT COUNT(a) FROM c WHERE b > 101")
    assert res.failed is False
    srv.close()


def test_demoted_table_quarantine_is_typed_not_hang(framework, blob):
    """Decode failure at execution time (table demoted, plan cached) goes
    through exec containment: typed QueryError(kind='quarantined'), no
    wasted retry against the open breaker."""
    srv = AQPServer(mode="numpy", device="cpu")
    srv.register_cold("c", blob, decode_retries=0, decode_backoff_s=0.001)
    assert srv.query("SELECT COUNT(a) FROM c WHERE b > 95").failed is False
    assert srv.demote("c")
    # New text: the cached result for the first query must not satisfy it.
    with faults.installed(FaultPlan().fail("cold_decode", first=8)):
        res = srv.query("SELECT COUNT(a) FROM c WHERE b > 94")
    assert isinstance(res, QueryError) and res.kind == "quarantined"
    srv.close()


# ------------------------------------------------------------ seeded chaos


def test_mini_chaos_every_future_resolves(framework):
    """Seeded multi-site chaos: every future resolves (correct answer or
    typed result, never a hang), retried-through answers are bit-identical
    to an undisturbed control, and the admission queue stays bounded."""
    sqls = [f"SELECT COUNT(a) FROM t WHERE b > {60 + i}" for i in range(24)]
    control = _server(framework)
    want = {s: control.query(s).as_tuple() for s in sqls}
    control.close()

    srv = _server(framework, max_wait_ms=20.0, max_batch=8)
    plan = (FaultPlan(seed=3)
            .fail("wave_execute", rate=0.15)
            .fail("kernel_launch", rate=0.15)
            .fail("worker", at=[2]))
    with faults.installed(plan):
        futs = [srv.submit(s) for s in sqls]
        srv.flush()
        got = [f.result(timeout=TIMEOUT) for f in futs]
    ok = failed = 0
    for sql, res in zip(sqls, got):
        if isinstance(res, QueryError):
            failed += 1
            assert res.kind in ("execution", "quarantined")
        else:
            ok += 1
            assert res.as_tuple() == want[sql]
    assert ok + failed == len(sqls)    # exactly-once: all resolved
    assert ok > 0
    flt = srv.stats()["totals"]["faults"]
    assert flt["query_errors"] == failed
    adm = srv.stats()["totals"]["admission"]
    # Bounded depth: requeues/retries never balloon the queue past the
    # original submission count.
    assert adm["max_queue_depth"] <= len(sqls)
    srv.close()
