"""Where a dry-run cell's per-device FLOPs go: one cell of the port's dry
run (``repro_torch.launch.dryrun.run_cell``) with its FLOPs tallied by
operator and input shapes.

    PYTHONPATH=src python scripts/torch_dryrun_flops.py --arch qwen3-0.6b \\
        --shape train_4k --layers 1 [--top 25]

Prints the cell's FLOPs, peak bytes and wire bytes, then the largest
(operator, shapes) entries, as one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import json

import torch

from repro_torch.launch import dryrun as D


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    tally = collections.Counter()
    dispatch = D.DeviceCost.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            tally[f"{func.__name__} {shapes}"] += self.flops - before
        return out

    D.DeviceCost.__torch_dispatch__ = counting
    try:
        res = D.run_cell(args.arch, args.shape, args.multi_pod,
                         n_layers=args.layers)
    finally:
        D.DeviceCost.__torch_dispatch__ = dispatch
    if not res.get("ok"):
        print(json.dumps({"ok": False, "error": res.get("error")}))
        return 1
    print(json.dumps({
        "ok": True, "torch": torch.__version__, "arch": args.arch,
        "shape": args.shape, "layers": args.layers,
        "flops": res["cost_analysis"]["flops"],
        "peak_bytes": res["memory_analysis"]["peak_bytes"],
        "wire_bytes": {k: v["wire_bytes_per_device"]
                       for k, v in res["collectives"].items()},
        "by_op": dict(tally.most_common(args.top))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
