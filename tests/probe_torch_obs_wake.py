"""Where the wall time that ``test_explain_accounts_observed_wall_clock``
leaves unaccounted goes (``tests/test_torch_obs.py``).

    PYTHONPATH=src python tests/probe_torch_obs_wake.py 30
    for i in 1 2 3 4 5 6; do PYTHONPATH=src python \
        tests/probe_torch_obs_wake.py 30 & done; wait   # six at once

Runs the test's scenario (one traced query, ``max_wait_ms=50``) ``runs``
times and prints one JSON line: the smallest traced share of the client's
wall time, the unaccounted gap (client wall minus the trace's total), and
how much of it lies between ``QueryFuture.set_result`` and the client
waking, against the server's own interval from its last trace stamp to
``set_result``. Six copies at once stand for the test suite's six
workers. Not a test: pytest collects ``test_*.py`` only.
"""
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.aqp.engine import AQPFramework  # noqa: E402
from repro_torch.core.types import BuildParams  # noqa: E402
from repro_torch.serve.aqp import server  # noqa: E402
from test_torch_obs import _server, _table  # noqa: E402


def main(runs: int) -> dict:
    fw = AQPFramework(params=BuildParams(n_samples=4_000, seed=1),
                      use_compression=False, device="cpu").ingest(_table())
    stamp = {}
    original = server.QueryFuture.set_result

    def set_result(self, result):
        stamp["set"] = time.perf_counter()
        return original(self, result)

    server.QueryFuture.set_result = set_result
    rows = []
    try:
        for _ in range(runs):
            srv = _server(fw, trace_enabled=True, max_wait_ms=50.0)
            try:
                t0 = time.perf_counter()
                res = srv.submit("SELECT AVG(b) FROM t WHERE a > 100").result(
                    timeout=30)
                t1 = time.perf_counter()
            finally:
                srv.close()
            wall = (t1 - t0) * 1e3
            gap = wall - res.explain["total_ms"]
            wake = (t1 - stamp["set"]) * 1e3
            rows.append((res.explain["total_ms"] / wall, gap, wake))
    finally:
        server.QueryFuture.set_result = original
    shares, gaps, wakes = zip(*rows)
    return {"runs": runs, "min_share": min(shares),
            "below_0.95": sum(s < 0.95 for s in shares),
            "gap_ms_p50": statistics.median(gaps), "gap_ms_max": max(gaps),
            "set_to_wake_ms_p50": statistics.median(wakes),
            "set_to_wake_ms_max": max(wakes),
            "rest_ms_max": max(g - w for g, w in zip(gaps, wakes))}


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 30)))
