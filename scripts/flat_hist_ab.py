#!/usr/bin/env python3
"""Time the pair-batched histogram kernels (K3 ``batched_hist2d``, K4
``batched_subbin_hist``) of one tree of the port on fixed inputs, so that
two trees can be compared on one card in one run.

    PYTHONPATH=src python3 scripts/flat_hist_ab.py capture OUT.pt
    PYTHONPATH=TREE/src python3 scripts/flat_hist_ab.py time IN.pt LABEL \\
        OUT.json

``capture`` records the arguments of the first K3 and K4 launch of one
ingest of the main table (``chip_smoke.capture_main_hist_inputs``) into
``IN.pt``. ``time`` loads them, adds ``chip_smoke``'s synthetic cases (the
same seed, so every tree gets the same inputs) and times the kernels'
public wrappers of the ``repro_torch`` found on ``PYTHONPATH`` (device ms
per call, ``chip_smoke.device_ms``; wall ms between CUDA events,
``chip_smoke.wall_ms``), after holding each result to a plain scatter-add
(exact for 0/1 weights, else rtol 1e-5 atol 1e-6); the main inputs are also
timed cut to their first 1, 2 and 4 pairs, as late rounds launch. Needs a
CUDA device. Run it as parent, change, change, parent to compare two
trees; each run writes ``OUT.json`` with the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
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


def _plain(kind, a, b, w, ka, kb):
    """The plain version (a clipped scatter-add), independent of the tree
    under test."""
    import torch
    p = w.shape[0]
    flat = torch.clamp(a, 0, ka - 1) * kb + torch.clamp(b, 0, kb - 1)
    out = torch.zeros((p, ka * kb), dtype=w.dtype, device=w.device)
    return out.scatter_add_(1, flat, w).reshape(p, ka, kb)


def _agree(got, want, w) -> bool:
    import torch
    if w.dtype == torch.float64 and bool(((w == 0) | (w == 1)).all()):
        return bool(torch.equal(got, want))
    return bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))


def _cases(smoke, inputs: dict):
    """(label dict, kind, a, b, w, ka, kb) of every timed case."""
    import numpy as np
    rng = np.random.default_rng(0)
    for kind in ("batched_hist2d", "batched_subbin_hist"):
        a, b, w, ka, kb = inputs[kind]
        yield dict(shape="main"), kind, a, b, w, ka, kb
    for p in (1, 2, 4):
        for kind in ("batched_hist2d", "batched_subbin_hist"):
            a, b, w, ka, kb = inputs[kind]
            yield (dict(shape="main", pairs=p), kind, a[:p].contiguous(),
                   b[:p].contiguous(), w[:p].contiguous(), ka, kb)
    for kind in ("batched_hist2d", "batched_subbin_hist"):
        for layout in ("sorted", "uniform"):
            for k2 in (64, 128, 256):
                for wd in ("f64_01", "f32"):
                    a, b, w, ka, kb = smoke.hist_inputs(kind, k2, wd, layout,
                                                        rng)
                    yield (dict(shape=layout, k2=k2, weights=wd), kind,
                           a, b, w, ka, kb)


def capture(out: str) -> None:
    import torch
    smoke = _smoke()
    got = smoke.capture_main_hist_inputs()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: tuple(x.cpu() if hasattr(x, "cpu") else x for x in v)
                for k, v in got.items()}, out)
    print(json.dumps({"captured": {k: [tuple(x.shape) for x in v[:3]]
                                   for k, v in got.items()}}))


def time_tree(inputs_path: str, label: str, out: str) -> int:
    import subprocess

    import torch
    from repro_torch.kernels.hist2d import batched_hist2d
    from repro_torch.kernels.subbin import batched_subbin_hist
    smoke = _smoke()
    fns = {"batched_hist2d": batched_hist2d,
           "batched_subbin_hist": batched_subbin_hist}
    dev = torch.device("cuda")
    inputs = {k: tuple(x.to(dev) if hasattr(x, "to") else x for x in v)
              for k, v in torch.load(inputs_path).items()}
    rows, bad = [], []

    def run(labels, kind, a, b, w, ka, kb):
        def fn():
            return fns[kind](a, b, w, ka, kb)
        got = fn().reshape(w.shape[0], ka, kb)
        ok = _agree(got, _plain(kind, a, b, w, ka, kb), w)
        torch.cuda.synchronize()
        row = dict(labels, name=kind, tree=label, p=int(w.shape[0]),
                   n=int(w.shape[1]), ka=ka, kb=kb,
                   weights=labels.get("weights",
                                      str(w.dtype).replace("torch.", "")),
                   ok=ok, ms=smoke.device_ms(fn), wall_ms=smoke.wall_ms(fn))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not ok:
            bad.append(row)

    for case in _cases(smoke, inputs):
        run(*case)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps({"tree": label,
                                     "nvidia_smi": smi.stdout.strip(),
                                     "rows": rows}, indent=1))
    if bad:
        print(f"{len(bad)} cases disagree with the plain version",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("out")
    t = sub.add_parser("time")
    t.add_argument("inputs")
    t.add_argument("label")
    t.add_argument("out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flat_hist_ab.py: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "capture":
        capture(args.out)
        return 0
    return time_tree(args.inputs, args.label, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
