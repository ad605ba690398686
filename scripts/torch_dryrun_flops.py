"""Where a dry-run cell's per-device FLOPs go: one cell of the port's dry
run (``repro_torch.launch.dryrun.run_cell``) with its FLOPs tallied by
operator and input shapes.

    PYTHONPATH=src python scripts/torch_dryrun_flops.py --arch qwen3-0.6b \\
        --shape train_4k --layers 1 [--top 25] [--per-layer] \\
        [--variant moe_sort]

Prints the cell's FLOPs, peak bytes and wire bytes, then the largest
(operator, shapes) entries, as one JSON object. With ``--per-layer`` the
cell runs cut to n and to n + 1 layers (n = ``--layers``, default 1) and
every number printed is the second run's minus the first's: what one
layer adds. ``--variant`` names an entry of ``dryrun.VARIANTS``, applied
to every run.
"""
from __future__ import annotations

import argparse
import collections
import json

import torch

from repro_torch.launch import dryrun as D


def tally(arch: str, shape: str, multi_pod: bool, layers,
          variant: str | None = None):
    """The cell's record (``run_cell``, with ``variant``) and its FLOPs
    by (operator, shapes)."""
    counts = collections.Counter()
    dispatch = D.DeviceCost.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            counts[f"{func.__name__} {shapes}"] += self.flops - before
        return out

    D.DeviceCost.__torch_dispatch__ = counting
    try:
        res = D.run_cell(arch, shape, multi_pod, n_layers=layers,
                         variant=variant)
    finally:
        D.DeviceCost.__torch_dispatch__ = dispatch
    return res, counts


def _numbers(res: dict) -> dict:
    return {"flops": res["cost_analysis"]["flops"],
            "peak_bytes": res["memory_analysis"]["peak_bytes"],
            "wire_bytes": {k: v["wire_bytes_per_device"]
                           for k, v in res["collectives"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default=None, choices=list(D.VARIANTS))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--per-layer", action="store_true",
                    help="print n + 1 layers' tally minus n layers'")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    layers = (args.layers or 1) if args.per_layer else args.layers
    runs = [tally(args.arch, args.shape, args.multi_pod, n, args.variant)
            for n in ((layers, layers + 1) if args.per_layer else (layers,))]
    for res, _ in runs:
        if not res.get("ok"):
            print(json.dumps({"ok": False, "error": res.get("error")}))
            return 1
    nums, counts = _numbers(runs[-1][0]), runs[-1][1]
    if args.per_layer:
        first = _numbers(runs[0][0])
        nums = {"flops": nums["flops"] - first["flops"],
                "peak_bytes": nums["peak_bytes"] - first["peak_bytes"],
                "wire_bytes": {k: v - first["wire_bytes"].get(k, 0.0)
                               for k, v in nums["wire_bytes"].items()}}
        counts = counts - runs[0][1]
    print(json.dumps({
        "ok": True, "torch": torch.__version__, "arch": args.arch,
        "shape": args.shape, "variant": args.variant, "layers": layers,
        "per_layer": args.per_layer,
        **nums, "by_op": dict(counts.most_common(args.top))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
