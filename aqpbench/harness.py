"""One run of one cell: ``python3 aqpbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``.

It checks for the cards the cell asks for, resolves the cell's files by
name (``spec``), runs the loop its mix names (``loops/``), checks that no
JAX module was loaded, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks`` (each number compared and
its limit) last. The checks are also the last lines on standard error.
With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each from its own reader in
``aqpbench/metrics``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from aqpbench import spec

# Top-level module names that no run may load (the JAX stack and the JAX
# package that the port was made from), compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "aqpbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=spec.ROOT, **sizes) -> tuple[dict, dict]:
    """Set up, measure and judge one cell on ``device`` (a
    ``torch.device``); returns the result line's fields and the loop's own
    output. ``sizes`` (``rows``, ``n_samples``) shrink the cell for the CPU
    tests; runs on the card take the configuration's."""
    cell = spec.cell(name, root)
    out = spec.loop(cell["mix"]["kind"], root)(
        cell, seed, seconds, trace, device, t_start, root=root, **sizes)
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.reader(m["name"], root)(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["metrics"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {}, "checks": checks}
    return result, out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="aqpbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env(spec.ROOT)
    import torch
    chips = spec.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"aqpbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    res, out = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), dev, t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"aqpbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": 1, "memory_peak_bytes": int(out["peak"])}
    if args.trace:
        rec = out["record"]
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["window_s"]
    checks = res.pop("checks")
    res["device"] = device
    if args.trace:
        res["breakdown"] = out["record"]["breakdown"]
    res["checks"] = checks
    print(f"aqpbench: checked {out['checked']} outputs of the window",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
