"""Port copy of tests/test_streaming.py on ``repro_torch.serve.aqp``, on the
CPU (``device="cpu"``).

Streaming admission + GROUP BY batching: futures, admission policy edge
cases (empty drain, timeout with a partial group, epoch bumps mid-flight),
and GROUP BY leaf-path equivalence with the unbatched oracle."""
import threading
import time

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.types import BuildParams
from repro_torch.serve.aqp import AQPServer, StreamingAdmission

TIMEOUT = 30  # generous future-resolution bound; loaded CI boxes are slow


def _make_table(n=8_000, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 500, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "cat": np.array(["r", "g", "b", "c", "m", "y"])[
            rng.integers(0, 6, n)],
    }


@pytest.fixture(scope="module")
def framework():
    return AQPFramework(BuildParams(n_samples=4_000, seed=2),
                        use_compression=False,
                        device="cpu").ingest(_make_table())


def _server(framework, **kwargs):
    kwargs.setdefault("mode", "numpy")
    return AQPServer(**kwargs, device="cpu").register("t", framework)


# -------------------------------------------------------- admission mechanics


def test_submit_returns_future_and_resolves(framework):
    srv = _server(framework)
    sql = "SELECT COUNT(a) FROM t WHERE b > 100"
    fut = srv.submit(sql)
    assert fut.sql == sql
    srv.flush()
    res = fut.result(timeout=TIMEOUT)
    assert res.as_tuple() == framework.engine.query(sql).as_tuple()
    srv.close()


def test_empty_queue_drain_is_noop(framework):
    """flush() with nothing queued must not hang, fire a wave, or poison
    the worker — and must not bank a drain for the next arrivals."""
    srv = _server(framework, max_wait_ms=200.0)
    srv.flush()                               # worker not even started
    fut = srv.submit("SELECT COUNT(a) FROM t WHERE b > 120")
    srv.flush()
    assert fut.result(timeout=TIMEOUT).estimate is not None
    srv.flush()                               # empty again, after a wave
    time.sleep(0.05)
    snap = srv.stats()["totals"]["admission"]
    assert snap["drains"] == 1 and snap["queue_depth"] == 0
    srv.close()


def test_streaming_admission_close_drains_pending():
    """Pending submissions are executed, not abandoned, on close()."""
    seen = []
    adm = StreamingAdmission(lambda batch, stats: seen.append(
        (len(batch), stats.cause)), max_wait_ms=10_000.0, max_batch=64)
    adm.submit("x")
    adm.submit("y")
    adm.close()
    assert seen == [(2, "flush")]
    with pytest.raises(RuntimeError, match="closed"):
        adm.submit("z")


def test_worker_survives_raising_execute_cb():
    """Regression: an exception escaping execute_cb must not kill the drain
    worker. Pre-fix the first raising wave ended the daemon thread and every
    later submission sat in the queue forever; now the guard routes the
    error to error_cb and the SAME worker keeps draining."""
    errors = []
    seen = []

    def execute(batch, stats):
        if "poison" in batch:
            raise RuntimeError("boom")
        seen.extend(batch)

    adm = StreamingAdmission(execute, max_wait_ms=5.0, max_batch=1,
                             error_cb=lambda batch, exc: errors.append(
                                 (list(batch), exc)))
    adm.submit("poison")
    adm.flush()
    deadline = time.perf_counter() + TIMEOUT
    while not errors and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert errors and errors[0][0] == ["poison"]
    assert isinstance(errors[0][1], RuntimeError)
    # The worker survived: later submissions still execute, with no restart.
    adm.submit("after")
    adm.flush()
    deadline = time.perf_counter() + TIMEOUT
    while "after" not in seen and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert seen == ["after"]
    assert adm.restarts == 0
    adm.close()


def test_raising_error_cb_does_not_kill_worker():
    """The supervision callback itself is untrusted: if error_cb raises,
    the worker still survives and keeps draining."""
    seen = []

    def execute(batch, stats):
        if "poison" in batch:
            raise RuntimeError("boom")
        seen.extend(batch)

    def bad_error_cb(batch, exc):
        raise ValueError("error_cb is broken too")

    adm = StreamingAdmission(execute, max_wait_ms=5.0, max_batch=1,
                             error_cb=bad_error_cb)
    adm.submit("poison")
    adm.submit("after")
    adm.flush()
    deadline = time.perf_counter() + TIMEOUT
    while "after" not in seen and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert seen == ["after"]
    assert adm.restarts == 0
    adm.close()


def test_watchdog_respawns_dead_worker():
    """If the worker thread dies outside the guarded paths, the next
    submit notices (is_alive() false), bumps ``restarts`` and respawns —
    queued items are never stranded."""
    seen = []
    adm = StreamingAdmission(lambda batch, stats: seen.extend(batch),
                             max_wait_ms=5.0, max_batch=1)
    adm.submit("first")
    adm.flush()
    deadline = time.perf_counter() + TIMEOUT
    while "first" not in seen and time.perf_counter() < deadline:
        time.sleep(0.005)
    # Simulate a hard worker death the guards never saw.
    with adm._cv:
        adm._stop = True
        adm._cv.notify_all()
    adm._thread.join(timeout=TIMEOUT)
    assert not adm._thread.is_alive()
    adm._stop = False
    adm.submit("second")                      # watchdog respawns here
    adm.flush()
    deadline = time.perf_counter() + TIMEOUT
    while "second" not in seen and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert seen == ["first", "second"]
    assert adm.restarts == 1
    adm.close()


def test_max_wait_timeout_fires_partial_group(framework):
    """A partial group (size < max_batch) executes once the oldest
    submission has waited max_wait_ms — no flush, no full batch."""
    srv = _server(framework, max_wait_ms=60.0, max_batch=64)
    futs = [srv.submit(f"SELECT COUNT(a) FROM t WHERE b > {thr}")
            for thr in (90, 110, 130)]
    t0 = time.perf_counter()
    for fut in futs:                          # resolve WITHOUT flush
        assert fut.result(timeout=TIMEOUT).estimate is not None
    waited = time.perf_counter() - t0
    assert waited < TIMEOUT
    adm = srv.stats()["totals"]["admission"]
    assert adm["drain_causes"]["timeout"] >= 1
    assert adm["drain_causes"]["full"] == 0
    assert 3 <= adm["max_queue_depth"] <= 3
    assert adm["wait_p99_ms"] >= 20.0         # the group actually waited
    srv.close()


def test_full_batch_fires_without_waiting(framework):
    srv = _server(framework, max_wait_ms=10_000.0, max_batch=4)
    futs = [srv.submit(f"SELECT COUNT(a) FROM t WHERE b > {thr}")
            for thr in (60, 70, 80, 90)]
    for fut in futs:                          # max_batch reached: no flush
        assert fut.result(timeout=TIMEOUT).estimate is not None
    assert srv.stats()["totals"]["admission"]["drain_causes"]["full"] >= 1
    srv.close()


def test_inflight_duplicates_execute_once(framework):
    srv = _server(framework, max_wait_ms=10_000.0)
    sql = "SELECT SUM(b) FROM t WHERE a > 250"
    futs = [srv.submit(sql) for _ in range(4)]
    srv.flush()
    got = {fut.result(timeout=TIMEOUT).as_tuple() for fut in futs}
    assert len(got) == 1
    st = srv.stats()
    assert st["totals"]["queries_executed"] == 1
    assert st["tables"]["t"]["result_cache_hits"] == 3
    srv.close()


def test_streaming_does_not_block_later_arrivals(framework):
    """A second wave completes while an earlier submission's results are
    still being consumed — admission is continuous, not call-scoped."""
    srv = _server(framework, max_wait_ms=5.0)
    first = srv.submit("SELECT COUNT(a) FROM t WHERE b > 100")
    done = threading.Event()
    first.add_done_callback(lambda f: done.set())
    assert done.wait(TIMEOUT)
    second = srv.submit("SELECT COUNT(a) FROM t WHERE b > 101")
    assert second.result(timeout=TIMEOUT).estimate is not None
    assert srv.stats()["totals"]["admission"]["drains"] >= 2
    srv.close()


# --------------------------------------------------- epoch bumps mid-flight


def test_append_rows_mid_flight_rejects_future():
    """append_rows lands after submit but before the wave executes: the
    future resolves with the staleness error and nothing stale is cached."""
    table = _make_table(4_000, seed=8)
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=3),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, max_wait_ms=10_000.0)
    sql = "SELECT COUNT(a) FROM t WHERE b > 100"
    fut = srv.submit(sql)                     # enqueued at the fresh epoch
    fw.append_rows({k: np.asarray(v)[:100] for k, v in table.items()})
    srv.flush()                               # wave executes against stale fw
    with pytest.raises(RuntimeError, match="stale"):
        fut.result(timeout=TIMEOUT)
    assert len(srv.result_cache) == 0
    fw.rebuild(table)
    assert srv.query(sql).estimate is not None
    srv.close()


def test_rebuild_mid_flight_replans_against_new_synopsis():
    """A rebuild that lands while a submission waits in the admission queue
    invalidates the plan's literal encodings: the wave must re-plan against
    the new synopsis, not execute the stale plan (silently wrong) or fail.
    The doubled table makes a stale answer numerically obvious."""
    table = _make_table(4_000, seed=9)
    bigger = {k: np.concatenate([np.asarray(v), np.asarray(v)])
              for k, v in table.items()}
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=4),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, max_wait_ms=10_000.0)
    sql = "SELECT COUNT(*) FROM t WHERE a >= 0"
    fut = srv.submit(sql)                     # planned+tagged at old epoch
    fw.append_rows({k: np.asarray(v)[:100] for k, v in table.items()})
    fw.rebuild(bigger)        # merges the 100 appended rows: 8100 total
    srv.flush()
    res = fut.result(timeout=TIMEOUT)
    np.testing.assert_allclose(res.estimate, 8_100, rtol=1e-6)
    # the replanned result was cached under the NEW epoch: repeats hit it
    executed = srv.stats()["totals"]["queries_executed"]
    assert round(srv.query(sql).estimate) == 8_100
    assert srv.stats()["totals"]["queries_executed"] == executed
    srv.close()


def test_rebuild_mid_wave_execution_requeues_and_replans():
    """Regression for the wave-execution epoch window: a rebuild landing
    AFTER the wave's epoch pre-check but DURING scheduler execution must
    not pair the old plan with the new synopsis. The scheduler's per-item
    epoch re-validation (inside ``BatchScheduler.execute``) marks the item
    stale, the server re-enqueues the submission, and the next wave
    re-plans against the rebuilt table — the doubled table makes a stale
    answer numerically obvious."""
    table = _make_table(4_000, seed=21)
    bigger = {k: np.concatenate([np.asarray(v), np.asarray(v)])
              for k, v in table.items()}
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=5),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, max_wait_ms=5.0)
    real_execute = srv.scheduler.execute
    fired = []

    def racing_execute(items):
        if not fired:                 # first wave only: simulate the race
            fired.append(True)
            fw.rebuild(bigger)        # lands inside the wave, post pre-check
        return real_execute(items)

    srv.scheduler.execute = racing_execute
    res = srv.query("SELECT COUNT(*) FROM t WHERE a >= 0")
    np.testing.assert_allclose(res.estimate, 8_000, rtol=1e-6)
    assert srv.stats()["totals"]["admission"]["stale_requeues"] >= 1
    srv.close()


def test_stale_requeue_bypasses_block_backpressure():
    """The stale re-enqueue runs ON the admission worker thread; with the
    bounded queue full under shed_policy="block" it must bypass the bound
    — blocking there would deadlock the worker on the condition only it
    can drain, hanging every queued future."""
    table = _make_table(2_000, seed=23)
    bigger = {k: np.concatenate([np.asarray(v), np.asarray(v)])
              for k, v in table.items()}
    fw = AQPFramework(BuildParams(n_samples=1_000, seed=7),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, max_wait_ms=5.0, max_queue_depth=1,
                  shed_policy="block")
    real_execute = srv.scheduler.execute
    fired, extra = [], []

    def racing(items):
        if not fired:
            fired.append(True)
            # fill the bounded queue to its limit, then move the epoch:
            # the wave item's requeue now meets a FULL queue
            extra.append(srv.submit("SELECT COUNT(*) FROM t WHERE a >= 1"))
            fw.rebuild(bigger)
        return real_execute(items)

    srv.scheduler.execute = racing
    fut = srv.submit("SELECT COUNT(*) FROM t WHERE a >= 0")
    srv.flush()
    res = fut.result(timeout=TIMEOUT)          # pre-fix: deadlocked here
    np.testing.assert_allclose(res.estimate, 4_000, rtol=1e-6)
    assert extra[0].result(timeout=TIMEOUT).estimate is not None
    srv.close()


def test_stale_retry_bound_fails_futures():
    """A table rebuilt inside EVERY wave exhausts MAX_STALE_RETRIES and
    fails the future instead of re-enqueueing forever."""
    table = _make_table(2_000, seed=22)
    fw = AQPFramework(BuildParams(n_samples=1_000, seed=6),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, max_wait_ms=1.0)
    real_execute = srv.scheduler.execute

    def always_racing(items):
        fw.rebuild(table)             # epoch moves inside every wave
        return real_execute(items)

    srv.scheduler.execute = always_racing
    fut = srv.submit("SELECT COUNT(*) FROM t WHERE a >= 0")
    srv.flush()
    with pytest.raises(RuntimeError, match="epoch kept moving"):
        fut.result(timeout=TIMEOUT)
    srv.close()


def test_submit_after_close_fails_cleanly(framework):
    """submit() on a closed server rejects the future AND leaves no orphaned
    in-flight entry for later submits of the same SQL to attach to."""
    srv = _server(framework)
    srv.close()
    sql = "SELECT COUNT(a) FROM t WHERE b > 115"
    for _ in range(2):                        # second submit must not hang
        fut = srv.submit(sql)
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=TIMEOUT)
    assert not srv._inflight


# ----------------------------------------------------------- backpressure


def test_streaming_rejection_resolves_future_typed(framework):
    """A full queue under shed_policy="reject" resolves the overflowing
    future with a typed AdmissionRejected RESULT (never an exception)."""
    srv = _server(framework, max_wait_ms=10_000.0, max_batch=64,
                  max_queue_depth=1, shed_policy="reject")
    ok = srv.submit("SELECT COUNT(a) FROM t WHERE b > 103")
    turned = srv.submit("SELECT COUNT(a) FROM t WHERE b > 104")
    res = turned.result(timeout=TIMEOUT)
    assert res.rejected and res.reason == "reject"
    assert res.as_tuple() == (None, None, None)
    assert res.queue_depth == 1
    srv.flush()
    assert ok.result(timeout=TIMEOUT).estimate is not None
    adm = srv.stats()["totals"]["admission"]
    assert adm["rejected"] == 1 and adm["shed"] == 0
    assert adm["queue_high_water"] == 1
    srv.close()


def test_shed_oldest_evicts_queued_future(framework):
    """shed_policy="shed_oldest": the oldest queued submission (and every
    duplicate future attached to it) resolves AdmissionRejected; the new
    arrival takes its place and is answered."""
    srv = _server(framework, max_wait_ms=10_000.0, max_batch=64,
                  max_queue_depth=1, shed_policy="shed_oldest")
    first = srv.submit("SELECT COUNT(a) FROM t WHERE b > 105")
    dup = srv.submit("SELECT COUNT(a) FROM t WHERE b > 105")    # attaches
    second = srv.submit("SELECT COUNT(a) FROM t WHERE b > 106")
    res = first.result(timeout=TIMEOUT)
    assert res.rejected and res.reason == "shed_oldest"
    assert dup.result(timeout=TIMEOUT).rejected                 # rides along
    srv.flush()
    assert second.result(timeout=TIMEOUT).estimate is not None
    adm = srv.stats()["totals"]["admission"]
    assert adm["shed"] == 1 and adm["rejected"] == 0            # per-submission
    assert not srv._inflight
    srv.close()


def test_query_batch_at_capacity_drains_and_retries(framework):
    """Regression: query_batch on a server whose queue is at capacity had
    no defined behavior. Now it drains and retries rejected submissions —
    a synchronous caller never sees AdmissionRejected."""
    srv = _server(framework, max_wait_ms=10_000.0, max_batch=64,
                  max_queue_depth=2, shed_policy="reject")
    sqls = [f"SELECT COUNT(a) FROM t WHERE b > {100 + i}" for i in range(8)]
    results = srv.query_batch(sqls)
    assert len(results) == 8
    assert all(not r.rejected and r.estimate is not None for r in results)
    adm = srv.stats()["totals"]["admission"]
    assert adm["rejected"] >= 1           # the bound actually bound
    assert adm["queue_high_water"] <= 2
    srv.close()


def test_query_batch_retry_timeout(framework):
    """The drain-and-retry budget is enforced: a zero budget with a full
    queue raises TimeoutError instead of retrying forever."""
    srv = _server(framework, max_wait_ms=10_000.0, max_batch=64,
                  max_queue_depth=1, shed_policy="reject")
    sqls = [f"SELECT COUNT(a) FROM t WHERE b > {110 + i}" for i in range(3)]
    with pytest.raises(TimeoutError, match="drain-and-retry"):
        srv.query_batch(sqls, retry_timeout_s=0.0)
    srv.close()


def test_append_rows_mid_flight_with_shed_interaction():
    """Epoch bump while submissions sit in a BOUNDED queue: the shed loser
    resolves AdmissionRejected (it was never executed, so it must NOT get
    the staleness error), the queued survivor fails with the staleness
    error at wave time, and nothing stale is cached."""
    table = _make_table(4_000, seed=21)
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=9),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, max_wait_ms=10_000.0, max_batch=64,
                  max_queue_depth=1, shed_policy="shed_oldest")
    victim = srv.submit("SELECT COUNT(b) FROM t WHERE a < 250 GROUP BY cat")
    survivor = srv.submit("SELECT COUNT(a) FROM t WHERE b > 100")  # evicts
    res = victim.result(timeout=TIMEOUT)
    assert res.rejected and res.reason == "shed_oldest"
    fw.append_rows({k: np.asarray(v)[:100] for k, v in table.items()})
    srv.flush()
    with pytest.raises(RuntimeError, match="stale"):
        survivor.result(timeout=TIMEOUT)
    assert len(srv.result_cache) == 0
    # a NEW submit against the stale table fails at planning, not admission
    fut = srv.submit("SELECT COUNT(a) FROM t WHERE b > 100")
    with pytest.raises(RuntimeError, match="stale"):
        fut.result(timeout=TIMEOUT)
    fw.rebuild(table)
    assert srv.query("SELECT COUNT(a) FROM t WHERE b > 100").estimate \
        is not None
    srv.close()


# ------------------------------------------------------- GROUP BY batching


GROUP_SQLS = [
    "SELECT COUNT(b) FROM t WHERE a < 300 GROUP BY cat",
    "SELECT AVG(b) FROM t WHERE a > 100 AND b < 160 GROUP BY cat",
    "SELECT SUM(b) FROM t GROUP BY cat",
    "SELECT COUNT(*) FROM t WHERE b > 90 GROUP BY cat",
]


def _oracle_groups(framework, sql):
    """The unbatched sequential GROUP BY path (engine.execute -> _group_by)."""
    plan = framework.engine.plan_sql(sql)
    return framework.engine.execute(plan.func, plan.agg_col, plan.tree,
                                    plan.group_by).groups


def test_group_by_leaves_bit_for_bit_numpy(framework):
    """numpy-mode serving (leaf expansion, no kernels) is bit-for-bit equal
    to the sequential per-category loop."""
    srv = _server(framework, mode="numpy")
    for sql, res in zip(GROUP_SQLS, srv.query_batch(GROUP_SQLS)):
        assert res.groups == _oracle_groups(framework, sql), sql
    tm = srv.stats()["tables"]["t"]
    assert tm["group_by"]["queries"] == len(GROUP_SQLS)
    assert tm["group_by"]["leaves_executed"] == 6 * len(GROUP_SQLS)
    srv.close()


def test_group_by_leaves_batched_kernel_close(framework):
    """ref-mode serving fuses all six category leaves of each GROUP BY into
    batched launches; estimates match the oracle to fp tolerance."""
    srv = _server(framework, mode="ref")
    for sql, res in zip(GROUP_SQLS, srv.query_batch(GROUP_SQLS)):
        oracle = _oracle_groups(framework, sql)
        assert set(res.groups) == set(oracle), sql
        for value, triple in oracle.items():
            np.testing.assert_allclose(res.groups[value], triple,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{sql} [{value}]")
    tm = srv.stats()["tables"]["t"]
    assert tm["batched"] > 0                  # leaves actually fused
    assert tm["group_by"]["leaves_executed"] > 0
    srv.close()


def test_overlapping_group_by_share_leaf_cache(framework):
    """Textual variants of one GROUP BY (clause order differs, so the
    normalized-SQL keys differ) share per-leaf cache entries: the second
    query executes zero leaves."""
    srv = _server(framework, mode="numpy")
    a = "SELECT COUNT(b) FROM t WHERE a < 200 GROUP BY cat"
    b = "SELECT COUNT(b) FROM t GROUP BY cat WHERE a < 200"
    res_a = srv.query(a)
    executed = srv.stats()["totals"]["queries_executed"]
    res_b = srv.query(b)
    assert res_b.groups == res_a.groups
    assert srv.stats()["totals"]["queries_executed"] == executed
    gb = srv.stats()["tables"]["t"]["group_by"]
    assert gb["leaf_cache_hits"] == 6         # all of b's leaves were shared
    srv.close()


def test_group_by_epoch_invalidates_leaf_cache():
    table = _make_table(4_000, seed=11)
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=5),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw, mode="numpy")
    sql = "SELECT COUNT(b) FROM t WHERE a < 250 GROUP BY cat"
    srv.query(sql)
    fw.append_rows({k: np.asarray(v)[:500] for k, v in table.items()})
    fw.rebuild(table)
    executed = srv.stats()["totals"]["queries_executed"]
    srv.query(sql)                            # leaf entries must NOT validate
    assert srv.stats()["totals"]["queries_executed"] == executed + 1
    srv.close()
