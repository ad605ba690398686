"""Port copy of the small-N lane of tests/test_stress_serving.py on
``repro_torch.serve.aqp``, on the CPU (``device="cpu"``).

Concurrency stress harness for backpressure-bounded streaming admission.

The acceptance gate for the lock-split submit path (see docs/serving.md):
seeded multi-threaded workloads (N submitter threads x mixed GROUP BY /
point queries, optional mid-flight ``append_rows``/``rebuild``) drive a
live ``AQPServer`` and assert the serving invariants directly:

  * **no future is lost** — every submitted ``QueryFuture`` resolves
    (answered, ``AdmissionRejected``, or failed with the staleness/plan
    error) exactly once;
  * **the queue bound holds** — observed admission-queue depth never
    exceeds ``max_queue_depth`` (submit-time high-water AND drain-time
    depth);
  * **no stale epoch is served** — every answered ``COUNT(*)`` equals the
    row count of some synopsis version that actually existed;
  * **the ledger matches** — shed/reject counters equal the number of
    rejected submissions when the workload has no in-flight duplicates.

These are the small-N variants (the reference's default lane); the full-N
``stress`` variants of tests/test_stress_serving.py are not copied.
"""
import concurrent.futures
import threading
import time
from collections import Counter

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.query import PlanError
from repro_torch.core.types import BuildParams
from repro_torch.serve.aqp import AQPServer, StreamingAdmission

TIMEOUT = 60  # generous future-resolution bound; loaded CI boxes are slow


def _make_table(n=6_000, seed=13):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 500, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "cat": np.array(["r", "g", "b", "c"])[rng.integers(0, 4, n)],
    }


@pytest.fixture(scope="module")
def framework():
    return AQPFramework(BuildParams(n_samples=3_000, seed=4),
                        use_compression=False,
                        device="cpu").ingest(_make_table())


def _workload(rng, n, unique_tag=None):
    """Seeded mixed stream: dup-heavy point + GROUP BY queries, literal
    variants, full-table counts. ``unique_tag`` makes every query textually
    distinct (one future == one submission, for ledger-exact tests)."""
    out = []
    for i in range(n):
        u = "" if unique_tag is None else f" AND a >= 0.{unique_tag}{i}"
        r = rng.random()
        if r < 0.12:
            out.append("SELECT COUNT(*) FROM t" if unique_tag is None else
                       f"SELECT SUM(b) FROM t WHERE b >= 0{u}")
        elif r < 0.25:
            out.append(f"SELECT COUNT(b) FROM t WHERE a < 250{u} "
                       "GROUP BY cat")
        elif r < 0.35:
            out.append(f"SELECT AVG(b) FROM t "
                       f"WHERE a > {int(rng.integers(0, 400))}{u} "
                       "GROUP BY cat")
        elif r < 0.55:
            out.append(f"SELECT COUNT(a) FROM t WHERE b > 100{u}")
        else:
            out.append(f"SELECT SUM(b) FROM t "
                       f"WHERE a > {int(rng.integers(0, 450))}{u}")
    return out


def _classify(futs):
    """-> (answered, rejected, failed); asserts every future resolved and
    every failure is the documented staleness/plan error."""
    answered = rejected = failed = 0
    for fut in futs:
        assert fut.done(), f"lost future: {fut.sql!r}"
        exc = fut.exception()
        if exc is not None:
            assert isinstance(exc, (RuntimeError, PlanError)), exc
            failed += 1
        elif getattr(fut.result(), "rejected", False):
            rejected += 1
        else:
            answered += 1
    return answered, rejected, failed


def _run_stress(fw, *, n_threads, n_per_thread, shed_policy, max_queue_depth,
                seed=0, unique=False, mutator=None, **server_kwargs):
    """Drive one seeded multi-threaded stress run; returns
    (futures, admission-stats snapshot, answered/rejected/failed counts)."""
    server_kwargs.setdefault("mode", "numpy")
    server_kwargs.setdefault("max_wait_ms", 1.0)
    server_kwargs.setdefault("max_batch", 16)
    srv = AQPServer(max_queue_depth=max_queue_depth, shed_policy=shed_policy,
                    **server_kwargs, device="cpu")
    srv.register("t", fw)
    ledgers = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads + (1 if mutator else 0))

    def submitter(ti):
        rng = np.random.default_rng(seed * 1_000 + ti)
        wl = _workload(rng, n_per_thread,
                       unique_tag=f"{seed}{ti}" if unique else None)
        barrier.wait()
        for sql in wl:
            ledgers[ti].append(srv.submit(sql))

    threads = [threading.Thread(target=submitter, args=(ti,))
               for ti in range(n_threads)]
    if mutator:
        threads.append(threading.Thread(target=mutator, args=(barrier,)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive(), "stress thread wedged"
    srv.flush()
    futs = [f for ledger in ledgers for f in ledger]
    done, not_done = concurrent.futures.wait(futs, timeout=TIMEOUT)
    assert not not_done, f"{len(not_done)} futures never resolved"
    counts = _classify(futs)
    stats = srv.stats()["totals"]["admission"]
    srv.close()
    # The bound is a hard invariant: depth observed right after every admit
    # (high water) and at every drain must respect it.
    if max_queue_depth > 0:
        assert stats["queue_high_water"] <= max_queue_depth
        assert stats["max_queue_depth"] <= max_queue_depth
    assert stats["submitted"] == len(futs)
    return futs, stats, counts


# ------------------------------------------------------- default (small-N)


def test_stress_small_reject(framework):
    futs, stats, (answered, rejected, failed) = _run_stress(
        framework, n_threads=4, n_per_thread=24,
        shed_policy="reject", max_queue_depth=8, seed=1)
    assert answered + rejected + failed == len(futs)
    assert failed == 0                    # no mutation: nothing may error
    assert answered > 0


def test_stress_small_shed_oldest(framework):
    futs, stats, (answered, rejected, failed) = _run_stress(
        framework, n_threads=4, n_per_thread=24,
        shed_policy="shed_oldest", max_queue_depth=4, seed=2)
    assert answered + rejected + failed == len(futs)
    assert failed == 0
    assert answered > 0
    assert stats["rejected"] == 0         # shed_oldest never rejects the new


def test_stress_small_block(framework):
    """block policy: producers are paced, nothing is ever shed — every
    future must come back answered."""
    futs, stats, (answered, rejected, failed) = _run_stress(
        framework, n_threads=4, n_per_thread=16,
        shed_policy="block", max_queue_depth=4, seed=3)
    assert (answered, rejected, failed) == (len(futs), 0, 0)
    assert stats["rejected"] == 0 and stats["shed"] == 0


def test_stress_counters_match_ledger(framework):
    """Unique-text workload (no in-flight dedupe): the shed/reject counters
    must equal the number of AdmissionRejected futures exactly."""
    futs, stats, (answered, rejected, failed) = _run_stress(
        framework, n_threads=4, n_per_thread=24, unique=True,
        shed_policy="reject", max_queue_depth=2, seed=4)
    assert failed == 0
    assert stats["rejected"] + stats["shed"] == rejected
    reasons = Counter(f.result().reason for f in futs
                      if f.exception() is None
                      and getattr(f.result(), "rejected", False))
    assert reasons.get("reject", 0) == stats["rejected"]
    assert reasons.get("shed_oldest", 0) == stats["shed"]


def test_stress_append_rows_mid_flight():
    """Mid-flight append_rows/rebuild cycles: answered COUNT(*) values must
    all equal a row count some synopsis version actually had — a stale
    epoch served would produce a count outside the valid set."""
    base = _make_table(4_000, seed=17)
    extra = {k: np.asarray(v)[:200] for k, v in base.items()}
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=6),
                      use_compression=False, device="cpu").ingest(base)
    valid = {4_000.0, 4_200.0}            # base, base + one append cycle

    def mutator(barrier):
        barrier.wait()
        time.sleep(0.2)                   # let early waves answer fresh
        for _ in range(3):
            fw.append_rows(extra)         # stale window: queries must fail
            time.sleep(0.005)
            fw.rebuild(base)              # merges pending: back to 4_200

    futs, _stats, (answered, rejected, failed) = _run_stress(
        fw, n_threads=4, n_per_thread=24,
        shed_policy="reject", max_queue_depth=16, seed=5, mutator=mutator)
    assert answered > 0
    for fut in futs:
        if fut.exception() is None and not getattr(fut.result(), "rejected",
                                                   False):
            res = fut.result()
            if fut.sql == "SELECT COUNT(*) FROM t":
                assert res.estimate in valid, \
                    f"stale count served: {res.estimate}"
    for fut in futs:                      # failures are staleness, only
        exc = fut.exception()
        if exc is not None:
            assert "stale" in str(exc)


def test_admission_interleavings_exactly_once():
    """Seeded interleavings of submit/flush/sleep/close against a bounded
    StreamingAdmission: every item lands in exactly one executed wave or
    exactly one shed callback — never both, never twice, never dropped.
    (The hypothesis generalization lives in test_property_admission.py.)"""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        executed, shed = [], []
        delay = 0.002 if seed % 2 else 0.0

        def execute(batch, stats, _d=delay, _e=executed):
            if _d:
                time.sleep(_d)            # slow consumer: forces full queues
            _e.extend(batch)

        adm = StreamingAdmission(
            execute,
            max_wait_ms=float(rng.choice([0.2, 2.0])),
            max_batch=int(rng.integers(1, 5)),
            max_queue_depth=int(rng.integers(1, 5)),
            shed_policy=str(rng.choice(["reject", "shed_oldest"])),
            shed_cb=lambda item, reason, depth, _s=shed: _s.append(item))
        submitted = []
        for i in range(int(rng.integers(10, 40))):
            op = rng.random()
            if op < 0.7:
                item = (seed, i)
                submitted.append(item)
                adm.submit(item)
            elif op < 0.85:
                adm.flush()
            else:
                time.sleep(float(rng.random()) * 0.003)
        adm.close()
        assert Counter(executed) + Counter(shed) == Counter(submitted), \
            f"seed {seed}: exactly-once violated"
        assert adm.high_water <= adm.max_queue_depth


def test_admission_block_policy_paces_producer():
    """block: a submit against a full queue waits for the drain instead of
    shedding; everything executes exactly once. The long max_wait keeps the
    worker idle until flush, so the full-queue window is deterministic."""
    executed = []
    adm = StreamingAdmission(lambda batch, stats: executed.extend(batch),
                             max_wait_ms=10_000.0, max_batch=8,
                             max_queue_depth=2, shed_policy="block")
    adm.submit(0)
    adm.submit(1)                         # queue at the bound; worker idle
    done = threading.Event()
    threading.Thread(target=lambda: (adm.submit(2), done.set()),
                     daemon=True).start()
    assert not done.wait(0.15)            # queue full: submit is blocked
    adm.flush()                           # drain frees space -> admit
    assert done.wait(TIMEOUT)
    adm.close()
    assert sorted(executed) == [0, 1, 2]
    assert adm.high_water <= 2
