"""Benchmark entry point of the port.

    PYTHONPATH=src python -m repro_torch.bench.run [--quick] [--only NAME]
                                                   [--device cpu] [--out DIR]

Prints ``name,us_per_call,derived`` CSV rows and writes JSON results, each
naming its device and card, to ``DIR`` (``build/bench_torch/`` by default).
Runs on the CUDA device unless ``--device cpu``; without a card a suite
raises, it never falls back to the CPU. Every suite of the reference is
ported (``construction``, ``kernels``, ``storage``, ``serving``, ``fig8``,
``fig9``, ``table5``, ``table6``, ``fig11``, ``roofline``); ``roofline``
reads the dry run's artifacts (``repro_torch.launch.dryrun``) and runs on
no device.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

SUITES = ("construction", "kernels", "storage", "serving", "fig8", "fig9",
          "table5", "table6", "fig11", "roofline")
PORTED = {name: f"repro_torch.bench.{name}" for name in SUITES}


def suite(name: str):
    """The module of a suite; raises for an unknown name."""
    if name not in SUITES:
        raise ValueError(f"unknown suite {name!r}; choose from {SUITES}")
    return importlib.import_module(PORTED[name])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="reduced sizes")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {SUITES}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--out", default=None, help="directory for the JSON")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(SUITES)

    rows: list[str] = []
    failures = []
    print("name,us_per_call,derived")
    for name in names:
        t0 = time.time()
        try:
            before = len(rows)
            suite(name).run(rows, quick=args.quick, device=args.device,
                            out_dir=args.out)
            for row in rows[before:]:
                print(row, flush=True)
            print(f"# {name}: {time.time() - t0:.1f}s", file=sys.stderr)
        except Exception:  # noqa: BLE001 — report every failed suite
            failures.append(name)
            print(f"# {name} FAILED:\n{traceback.format_exc()}",
                  file=sys.stderr)
    if failures:
        print(f"# FAILED suites: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
