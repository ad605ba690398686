"""Where a dry-run cell's per-device FLOPs go: one cell of the port's dry
run (``repro_torch.launch.dryrun.run_cell``) with its FLOPs tallied by
operator and input shapes.

    PYTHONPATH=src python scripts/torch_dryrun_flops.py --arch qwen3-0.6b \\
        --shape train_4k --layers 1 [--top 25] [--per-layer | --live] \\
        [--variant moe_sort]

Prints the cell's FLOPs, peak bytes and wire bytes, then the largest
(operator, shapes) entries, as one JSON object. With ``--live`` it prints
instead the ``--top`` largest groups of storages live at the cell's
peak, each ``[[label, the operator that made it, shape, dtype],
bytes]``. With ``--per-layer`` the
cell runs cut to n and to n + 1 layers (n = ``--layers``, default 1) and
every number printed is the second run's minus the first's: what one
layer adds; ``cell`` then holds the second run's own numbers.
``--variant`` names an entry of ``dryrun.VARIANTS``, applied to every
run.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
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


@contextlib.contextmanager
def recording_live(top: int = 25):
    """For the block, every ``DeviceCost`` notes the ``top`` largest
    groups of storages live at its peak; yields a dict whose ``"live"``
    then holds them: ``[(label, creating operator, shape, dtype),
    bytes]``."""
    made, snap = {}, {"peak": -1, "live": []}
    cur = [None]
    add, free = D.DeviceCost._add, D.DeviceCost._free
    dispatch = D.DeviceCost.__torch_dispatch__

    def adding(self, t, label):
        key = id(t.untyped_storage())
        new = key not in self._labels
        add(self, t, label)
        if new:
            made[key] = (cur[0], tuple(t.shape),
                         str(t.dtype).replace("torch.", ""))
        if self.peak > snap["peak"]:
            groups = collections.Counter()
            for k, (lab, n) in self._labels.items():
                groups[(lab, *made.get(k, (None, None, None)))] += n
            snap.update(peak=self.peak, live=groups.most_common(top))

    def freeing(self, key):
        free(self, key)
        made.pop(key, None)

    def naming(self, func, types, args=(), kwargs=None):
        prev, cur[0] = cur[0], func.__name__
        try:
            return dispatch(self, func, types, args, kwargs)
        finally:
            cur[0] = prev

    D.DeviceCost._add, D.DeviceCost._free = adding, freeing
    D.DeviceCost.__torch_dispatch__ = naming
    try:
        yield snap
    finally:
        D.DeviceCost._add, D.DeviceCost._free = add, free
        D.DeviceCost.__torch_dispatch__ = dispatch
        snap["live"] = [[list(k), n] for k, n in snap["live"]]


def live_at_peak(arch: str, shape: str, multi_pod: bool, layers,
                 variant: str | None = None, top: int = 25):
    """The cell's record and the ``top`` largest groups of storages live
    at its peak (``recording_live``)."""
    with recording_live(top) as snap:
        res = D.run_cell(arch, shape, multi_pod, n_layers=layers,
                         variant=variant)
    return res, snap["live"]


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
    ap.add_argument("--live", action="store_true",
                    help="print the storages live at the cell's peak "
                         "instead (the --top largest groups)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.live:
        res, live = live_at_peak(args.arch, args.shape, args.multi_pod,
                                 args.layers, args.variant, args.top)
        if not res.get("ok"):
            print(json.dumps({"ok": False, "error": res.get("error")}))
            return 1
        print(json.dumps({
            "ok": True, "torch": torch.__version__, "arch": args.arch,
            "shape": args.shape, "variant": args.variant,
            "layers": args.layers, **_numbers(res),
            "memory_analysis": res["memory_analysis"],
            "live": live}))
        return 0
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
                               for k, v in nums["wire_bytes"].items()},
                "cell": nums}
        counts = counts - runs[0][1]
    print(json.dumps({
        "ok": True, "torch": torch.__version__, "arch": args.arch,
        "shape": args.shape, "variant": args.variant, "layers": layers,
        "per_layer": args.per_layer,
        **nums, "by_op": dict(counts.most_common(args.top))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
