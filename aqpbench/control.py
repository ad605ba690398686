"""The precision control of ``correct``: the reference put in the program's
place, one precision below the configuration's, must come out as not
correct. The configurations state float64 for the synopsis, so the control
is the reference synopsis built with float32 reals, judged against the
float64 reference by ``check.synopsis_gap``, for the sample seed of the
window's first build.

Run on the card at the cell's own size, a reading per seed:
``python3 aqpbench/control.py --workload <name> --seeds 1,2,3``. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from aqpbench import check, common, spec  # noqa: E402
from aqpbench.reference import synopsis as ref  # noqa: E402


def reading(name: str, seed: int, device, rows=None,
            n_samples=None) -> float:
    import torch
    config = spec.cell(name)["config"]
    seeds = common.Seeds(seed)
    table = spec.table(config["table"])(rows or config["rows"], seeds.data)
    build = dict(config["build"], **({"n_samples": n_samples}
                                     if n_samples else {}))
    data, meta = ref.ref_table.preprocess(table)
    edges = ref.ref_table.seed_edges(data, config["greedygd"])
    s = seeds.sample(1)
    want = ref.build(data, meta, edges, build, s, device, torch.float64)
    got = ref.build(data, meta, edges, build, s, device, torch.float32)
    return check.synopsis_gap(got, want)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="aqpbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        value = reading(args.workload, s, dev)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "control": value, "device": str(dev),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
