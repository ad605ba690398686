"""The spread of the trace lane's overhead measure: the lane's table and
workload (``scripts/torch_trace_smoke.py``), its paired-chunk median
taken ``--runs`` times at each number of passes in ``--passes``.

    PYTHONPATH=src python scripts/torch_trace_overhead.py            # card
    PYTHONPATH=src python scripts/torch_trace_overhead.py --device cpu \\
        --passes 3 20 60 --runs 8 6 4

Prints one JSON object: per number of passes, the overhead (%) of each
run; the servers run in ``"cuda"`` mode on the card, ``"ref"`` on the CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--passes", type=int, nargs="+", default=[3, 20, 60])
    ap.add_argument("--runs", type=int, nargs="+", default=[8, 6, 4])
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location(
        "trace_lane", Path(__file__).resolve().parent / "torch_trace_smoke.py")
    lane = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lane)
    dev = resolve_device(args.device)
    mode = "cuda" if dev.type == "cuda" else "ref"
    fw, sqls = lane._framework(dev), lane._workload()
    warm = lane._make_server(fw, dev, mode, False)
    for lo in range(0, len(sqls), 16):
        warm.query_batch(sqls[lo:lo + 16])
    warm.close()
    out = {"device": str(dev), "mode": mode}
    for passes, runs in zip(args.passes, args.runs):
        lane.OVERHEAD_REPS = passes
        out[f"passes_{passes}"] = [lane._overhead_pct(fw, dev, mode, sqls)
                                   for _ in range(runs)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
