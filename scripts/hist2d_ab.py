#!/usr/bin/env python3
"""Time the single 2-D histogram kernel (K5 ``hist2d``) of one tree of the
port on fixed inputs, so that two trees can be compared on one card in one
run.

    PYTHONPATH=TREE/src python3 scripts/hist2d_ab.py time LABEL OUT.json
    PYTHONPATH=src python3 scripts/hist2d_ab.py variants OUT.json

``time`` runs ``chip_smoke.K5_CASES`` (inputs from a seed of each shape,
so every tree gets the same ones) through the public ``hist2d`` of the
``repro_torch`` found on ``PYTHONPATH``, holds each result to a plain
scatter-add (exact for 0/1 weights, else rtol 1e-5 atol 1e-6) and records
device ms and device operations per call (``chip_smoke.device_profile``)
and wall ms per call between CUDA events (``chip_smoke.wall_ms``: windows
of 20 calls, as ``chip_smoke.py`` reports it, and of 1,000 calls, which
average out more of the host's jitter). Run it
as parent, change, change, parent to compare two trees, the parent
unpacked with ``git archive`` into a gitignored directory.

``variants`` times this tree's kernel under plans other than the one
``ops._plan`` picks (through ``ops._launch``), on the same cases: where
the rows are few, direct atomics in other chunk sizes and the slab plan
(zero-fill and launch); where they are many, direct atomics and partial
slabs added chunk by chunk instead of reduced in clusters of two chunks
through distributed shared memory. Each run writes ``OUT.json`` with the
card's ``nvidia-smi`` line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's ``chip_smoke`` module (its helpers import
    ``repro_torch`` from the path, not from this checkout)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(bi, bj, w, ki, kj):
    """The plain version (a clipped scatter-add), independent of the tree
    under test."""
    import torch
    flat = (torch.clamp(bi.long(), 0, ki - 1) * kj
            + torch.clamp(bj.long(), 0, kj - 1))
    out = torch.zeros(ki * kj, dtype=torch.float32, device=w.device)
    return out.scatter_add_(0, flat, w).reshape(ki, kj)


def _row(smoke, fn, want, weights, **labels) -> dict:
    import torch
    got = fn()
    torch.cuda.synchronize()
    if weights == "01":
        ok = bool(torch.equal(got, want))
    else:
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
    ms, ops = smoke.device_profile(fn)
    row = dict(labels, weights=weights, ok=ok,
               max_abs_err=float((got - want).abs().max()), ms=ms,
               device_ops=ops, wall_ms=smoke.wall_ms(fn),
               wall_1000_ms=smoke.wall_ms(fn, reps=1000))
    print(json.dumps(row), flush=True)
    return row


def _write(out: str, label: str, rows: list) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps({"tree": label,
                                     "nvidia_smi": smi.stdout.strip(),
                                     "rows": rows}, indent=1))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        print(f"{len(bad)} cases disagree with the plain version",
              file=sys.stderr)
        return 1
    return 0


def time_tree(label: str, out: str) -> int:
    from repro_torch.kernels.hist2d import hist2d
    smoke = _smoke()
    rows = []
    for n, ki, kj, weights, clip in smoke.K5_CASES:
        bi, bj, w = smoke.single_hist_inputs(n, ki, kj, weights, clip)
        rows.append(_row(smoke, lambda: hist2d(bi, bj, w, ki, kj),
                         _plain(bi, bj, w, ki, kj), weights, tree=label,
                         n=n, ki=ki, kj=kj, clipped=clip))
    return _write(out, label, rows)


def _variants(ops, index, n, ki, kj):
    """(name, plan) of the variants of one shape: the planned one; where the
    rows are few, the slab-free path in other chunk sizes and the slab plan
    (a zero-fill and a launch); where they are many, the slab-free path and
    slab plans whose chunks add their partial slabs one by one (clusters of
    one chunk)."""
    info = ops._device(index)
    planned = ops._device_plan(n, ki, kj, index)
    yield "planned", planned
    if n <= ops.DIRECT_ROWS:
        for rows in (512, 2048):
            chunks = min(-(-n // rows), info.resident(0, 0))
            yield f"direct{rows}", ops.Plan(0, 0, chunks, 1)
        yield "slab", ops._slab_plan(n, ki, kj, info)
        return
    chunks = min(-(-n // ops.DIRECT_CHUNK_ROWS), info.resident(0, 0))
    yield "direct", ops.Plan(0, 0, chunks, 1)
    yield "cy1", planned._replace(cy=1)


def variants(out: str) -> int:
    import torch
    from repro_torch.kernels.hist2d import ops
    smoke = _smoke()
    index = torch.cuda.current_device()
    rows = []
    for n, ki, kj, weights, clip in smoke.K5_CASES:
        if n == smoke.SHARDED_N and weights == "f32":
            continue
        bi, bj, w = smoke.single_hist_inputs(n, ki, kj, weights, clip)
        want = _plain(bi, bj, w, ki, kj)
        for name, plan in _variants(ops, index, n, ki, kj):
            rows.append(_row(smoke,
                             lambda plan=plan: ops._launch(bi, bj, w, ki, kj,
                                                           plan),
                             want, weights, variant=name, n=n, ki=ki, kj=kj,
                             clipped=clip, plan=plan._asdict()))
    return _write(out, "variants", rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time")
    t.add_argument("label")
    t.add_argument("out")
    v = sub.add_parser("variants")
    v.add_argument("out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hist2d_ab.py: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "time":
        return time_tree(args.label, args.out)
    return variants(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
