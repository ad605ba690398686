"""Shared utilities of the port's benchmarks: the CSV row format, a timer,
an engine sweep over queries and JSON results that name the device they
were measured on."""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

# Results go under the checkout's gitignored build directory.
RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "bench_torch"


def card_line(device: torch.device) -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        return f"nvidia-smi failed: {smi.stderr.strip()}"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return lines[min(index, len(lines) - 1)]


def device_fields(device: torch.device) -> dict:
    """``{"device": "cpu"}`` on the CPU; on a card its name and the
    ``nvidia-smi`` line with its power limit."""
    if device.type != "cuda":
        return {"device": device.type}
    return {"device": torch.cuda.get_device_name(device),
            "card": card_line(device)}


def save_json(name: str, payload: dict, device: torch.device,
              out_dir=None) -> Path:
    """Write ``payload`` and the device's fields to ``<out_dir>/<name>.json``
    (``RESULTS_DIR`` by default) and return the path."""
    out_dir = Path(RESULTS_DIR if out_dir is None else out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    path.write_text(json.dumps(dict(payload, **device_fields(device)),
                               indent=1, default=float))
    return path


def emit(rows: list, name: str, us_per_call, derived) -> None:
    """Append one ``name,us_per_call,derived`` CSV row."""
    us = "" if us_per_call is None else f"{us_per_call:.1f}"
    rows.append(f"{name},{us},{derived}")


def time_us(fn, device: torch.device, reps: int = 20, warm: int = 2) -> float:
    """Wall microseconds per call of ``fn`` over ``reps`` back-to-back warm
    calls, the card synchronised before and after."""
    for _ in range(warm):
        fn()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e6


def eval_engine(query_fn, queries, exact_engine) -> dict:
    """Run ``queries`` through ``query_fn`` against ``exact_engine``: error,
    latency (host wall time per query), bounds-correctness and bound-width
    summaries, plus the per-query errors under ``errs``."""
    from repro_torch.aqp.queries import relative_error
    errs, lats, bok, widths = [], [], [], []
    for sql in queries:
        exact = exact_engine.query(sql)
        t0 = time.perf_counter()
        out = query_fn(sql)
        lats.append(time.perf_counter() - t0)
        if isinstance(out, tuple):
            est, lo, hi = out
        else:
            est, lo, hi = out.estimate, out.lower, out.upper
        errs.append(relative_error(est, exact))
        if lo is not None and hi is not None and exact is not None:
            bok.append(lo - 1e-9 <= exact <= hi + 1e-9)
            if exact != 0:
                widths.append(abs(hi - lo) / abs(exact) * 100.0)
    return {
        "median_err": float(np.median(errs)) if errs else None,
        "mean_err": float(np.mean(errs)) if errs else None,
        "p90_err": float(np.percentile(errs, 90)) if errs else None,
        "errs": errs,
        "median_latency_ms": float(np.median(lats) * 1e3),
        "bounds_correct_pct": (float(np.mean(bok) * 100.0) if bok else None),
        "median_bound_width_pct": (float(np.median(widths)) if widths
                                   else None),
        "n_queries": len(queries),
    }
