"""Fault-injection chaos lane of the PyTorch port.

    PYTHONPATH=src python scripts/torch_chaos_smoke.py              # card
    PYTHONPATH=src python scripts/torch_chaos_smoke.py --device cpu

The port's counterpart of ``scripts/chaos_smoke.py``: the same table,
seed, workload and fault plan. An undisturbed control and a chaos server
run the same workload; the chaos server runs under a seeded multi-site
``FaultPlan`` (wave crashes, faults at the fused launch, one of them
scripted, a scripted worker death, cold decode failures, injected wave
latency) in ``"cuda"`` mode on the card or ``"ref"`` mode with
``--device cpu`` (the kernel's plain version). The table's engine answers
single queries through ``FastPath`` (the fused weightings kernel's
single-query launch on the card) and the servers' waves group them into
its batched launch. The chaos server must uphold the serving invariants:

  1. EVERY submitted future resolves: a correct answer or a typed result
     (``QueryError`` / ``DeadlineExceeded``), never a hang;
  2. answers that retried through transient faults are bit-identical to
     the undisturbed answer of the path that served them: a fused answer
     (``explain["batched"]``) to a control of the same mode that answers
     the workload in one wave, any other (a single, or an item re-run one
     by one after a launch fault) to the ``"numpy"`` control, whose
     singles run through the same engine;
  3. the admission worker never stays dead: scripted crashes are absorbed
     by revive/watchdog and the final queue is fully drained;
  4. deadline-expired queries resolve within 2x their deadline;
  5. failure telemetry is consistent: typed failures on the wire match the
     ``query_errors`` counter, and the queue depth stayed bounded.

Deterministic under its seed; writes nothing; exits non-zero on failure.
The last line is the kernels' launch counts as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch import kernels
from repro_torch.aqp.engine import AQPFramework
from repro_torch.core import storage
from repro_torch.core.fastpath import FastPath
from repro_torch.core.types import BuildParams
from repro_torch.device import resolve_device
from repro_torch.serve.aqp import (AQPServer, DeadlineExceeded, QueryError,
                                   faults)

TIMEOUT_S = 30.0


def _table(n=10_000):
    rng = np.random.default_rng(17)
    return {
        "a": rng.integers(0, 500, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
    }


def _sqls():
    return [f"SELECT COUNT(a) FROM t WHERE b > {50 + i}" for i in range(32)]


def _check(name, ok, detail=""):
    status = "ok" if ok else "FAIL"
    print(f"chaos_smoke: [{status}] {name}" + (f" ({detail})" if detail else ""))
    return bool(ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host and 'ref' mode (default: the "
                         "CUDA device, 'cuda' mode)")
    dev = resolve_device(ap.parse_args(argv).device)
    mode = "cuda" if dev.type == "cuda" else "ref"
    fw = AQPFramework(BuildParams(n_samples=5_000, seed=3),
                      use_compression=False, fastpath=FastPath(dev),
                      device=dev).ingest(_table())
    blob = storage.encode(fw.engine.ph)
    sqls = _sqls()

    control = AQPServer(mode="numpy", device=dev).register("t", fw)
    want = {s: control.query(s).as_tuple() for s in sqls}
    control.close()
    fused = AQPServer(mode=mode, device=dev,
                      max_wait_ms=10_000.0).register("t", fw)
    want_fused = {s: r.as_tuple() for s, r in
                  zip(sqls, fused.query_batch(sqls))}
    fused.close()

    srv = AQPServer(mode=mode, device=dev, max_wait_ms=20.0, max_batch=8,
                    trace_enabled=True).register("t", fw)
    srv.register_cold("c", blob, decode_retries=2, decode_backoff_s=0.005)

    # Rule order matters (first match wins): the wave-0 stall outlives the
    # doomed query's deadline deterministically, making the expiry path
    # exercised on every run, not just lucky schedules; so does the fault
    # at the second fused launch (the reference's numpy lane has none).
    plan = (faults.FaultPlan(seed=11)
            .fail("wave_execute", at=[0], action=lambda: time.sleep(0.12))
            .fail("wave_execute", rate=0.15)
            .fail("kernel_launch", at=[1])
            .fail("kernel_launch", rate=0.10)
            .fail("worker", at=[1])
            .fail("cold_decode", at=[0])
            .fail("wave_execute", every=7,
                  action=lambda: time.sleep(0.02)))

    ok = True
    with faults.installed(plan):
        futs = [srv.submit(s) for s in sqls]
        cold_fut = srv.submit("SELECT COUNT(a) FROM c WHERE b > 90")
        doomed = srv.submit("SELECT AVG(b) FROM t WHERE a < 9999",
                            deadline_ms=100.0)
        t_doomed = time.perf_counter()
        srv.flush()

        resolved = matched = failed = batched = 0
        for sql, fut in zip(sqls, futs):
            try:
                res = fut.result(timeout=TIMEOUT_S)
            except Exception as exc:       # plan errors would raise typed
                ok = _check(f"future resolved: {sql}", False, repr(exc))
                continue
            resolved += 1
            if isinstance(res, QueryError):
                failed += 1
                if res.kind not in ("execution", "quarantined"):
                    ok = _check("typed failure kind", False, res.kind)
                continue
            on_fused = bool(res.explain and res.explain.get("batched"))
            batched += on_fused
            if res.as_tuple() == (want_fused if on_fused else want)[sql]:
                matched += 1
            else:
                ok = _check("bit-identical retried answer", False, sql)
        ok &= _check("every future resolves",
                     resolved == len(sqls), f"{resolved}/{len(sqls)}")
        ok &= _check("answers bit-identical to control",
                     matched + failed == resolved,
                     f"{matched} matched ({batched} fused), {failed} typed "
                     "failures")
        injected = plan.snapshot()["injected"]
        ok &= _check("chaos actually injected, at the fused launch too",
                     sum(injected.values()) > 0
                     and injected.get("kernel_launch", 0) >= 1,
                     str(injected))

        # Cold table: the decode retried through the injected fault.
        cold_res = cold_fut.result(timeout=TIMEOUT_S)
        ok &= _check("cold decode retried through fault",
                     cold_res.estimate is not None and
                     plan.count("cold_decode") >= 2)

        # Deadline: the wave-0 stall (120ms) outlives the 100ms deadline,
        # so the query expires while queued and must resolve — typed —
        # within 2x its deadline.
        dres = doomed.result(timeout=TIMEOUT_S)
        waited_ms = (time.perf_counter() - t_doomed) * 1e3
        ok &= _check("deadline resolves typed within 2x deadline",
                     isinstance(dres, DeadlineExceeded)
                     and waited_ms < 2 * 100.0,
                     f"{waited_ms:.1f}ms")

    # Worker supervision: scripted crash absorbed, worker alive at the end.
    post = srv.query("SELECT COUNT(a) FROM t WHERE b > 49")
    flt = srv.stats()["totals"]["faults"]
    ok &= _check("worker never stays dead",
                 post.as_tuple() is not None and post.failed is False
                 and flt["worker_restarts"] >= 1,
                 f"restarts={flt['worker_restarts']}")
    ok &= _check("telemetry consistent with typed failures",
                 flt["query_errors"] == failed,
                 f"counter={flt['query_errors']} wire={failed}")
    adm = srv.stats()["totals"]["admission"]
    ok &= _check("queue depth bounded",
                 adm["max_queue_depth"] <= len(sqls) + 2,
                 str(adm["max_queue_depth"]))
    srv.close()
    print("chaos_smoke:", "PASS" if ok else "FAIL")
    print(json.dumps({"launches": kernels.launch_counts()}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
