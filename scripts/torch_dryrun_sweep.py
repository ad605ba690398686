"""A sweep of the port's dry run: many cells (``repro_torch.launch.dryrun.
run_cell``), each in a fresh process, several side by side, one JSON line
each.

    PYTHONPATH=src python scripts/torch_dryrun_sweep.py --layers 2 \\
        --jobs 6 --out build/sweep.jsonl            # base cells, both meshes
    PYTHONPATH=src python scripts/torch_dryrun_sweep.py --layers 2 \\
        --variants all --shape train_4k --single-pod --out build/v.jsonl
    PYTHONPATH=src python scripts/torch_dryrun_sweep.py --arch dbrx-132b \\
        --shape train_4k --single-pod              # full depth

Cells: every architecture (or ``--arch``) x every shape (or ``--shape``)
x both meshes (or one), with no variant or with each of ``--variants``
(names of ``dryrun.VARIANTS``, or ``all``), cut to ``--layers`` (default:
full depth). Each line holds the cell's key, ``ok`` / ``skipped`` (with
the reason) / the error (and its traceback's end), its per-device FLOPs,
peak bytes, wire bytes by collective kind and trace seconds. A skipped
cell (``shape_supported``) costs nothing.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import sys


def _cell(arch: str, shape: str, multi_pod: bool, layers, variant):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    torch.set_num_threads(1)
    res = D.run_cell(arch, shape, multi_pod, n_layers=layers,
                     variant=variant)
    out = {"arch": get_config(arch).name, "shape": shape,
           "mesh": "multi_pod" if multi_pod else "single_pod",
           "variant": variant, "layers": layers, "torch": torch.__version__}
    if res.get("skipped"):
        return dict(out, skipped=True, reason=res["reason"])
    if not res.get("ok"):
        return dict(out, ok=False, error=res.get("error"),
                    traceback=res.get("traceback", "")[-1500:])
    return dict(out, ok=True, flops=res["cost_analysis"]["flops"],
                peak_bytes=res["memory_analysis"]["peak_bytes"],
                wire_bytes={k: v["wire_bytes_per_device"]
                            for k, v in res["collectives"].items()},
                trace_s=res["trace_s"])


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append",
                    help="an architecture (repeatable; default: all)")
    ap.add_argument("--shape", action="append", choices=list(S.SHAPES))
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variants", default="",
                    help="comma-separated dryrun.VARIANTS names, or all")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    variants = list(D.VARIANTS) if args.variants == "all" else \
        [v for v in args.variants.split(",") if v] or [None]
    for v in variants:
        if v is not None and v not in D.VARIANTS:
            ap.error(f"unknown variant {v!r}")
    meshes = [m for m, skip in ((False, args.multi_pod),
                                (True, args.single_pod)) if not skip]
    cells = [(a, s, m, args.layers, v) for a in args.arch or ARCHS
             for s in args.shape or S.SHAPES for m in meshes
             for v in variants]
    n_fail = 0
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                max_tasks_per_child=1) as pool:
        futures = [pool.submit(_cell, *c) for c in cells]
        for fut in futures:
            line = json.dumps(fut.result())
            n_fail += '"ok": false' in line
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    print(f"cells {len(cells)}, failed {n_fail}", file=sys.stderr)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
