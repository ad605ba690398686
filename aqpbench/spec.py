"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A ``workloads`` entry names a configuration and a traffic mix. The
configuration is the file that ``configs[].file`` gives; it names its table,
made by ``aqpbench/tables/<table>.py`` (``make(rows, seed)``). The mix is
``aqpbench/traffic/<traffic>.json``; its ``kind`` names the run loop
``aqpbench/loops/<kind>.py`` (``run(cell, seed, seconds, trace, device,
t_start, **sizes)``). A per-layer metric ``<name>`` is read by
``aqpbench/metrics/<name>.py``, or where there is none by the reader of the
part of its name before the first dot (``idle_share.build`` by
``idle_share.py``). A new deployment, table, mix, loop or metric is new
files plus new entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> dict:
    """The workload ``name`` with its configuration, mix and metrics:
    ``{"workload", "config", "mix", "end_to_end", "per_layer"}``; the two
    metric lists hold the entries whose ``workloads`` name this cell (an
    entry without the key is every cell's)."""
    bench = bench or load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "aqpbench" / "traffic"
                      / f"{work['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return {"workload": work, "config": config, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def _module(path: Path, prefix: str):
    mod_name = prefix + "".join(ch if ch.isalnum() else "_"
                                for ch in str(path.relative_to(path.parents[2])))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` function of the metric's reader."""
    base = root / "aqpbench" / "metrics"
    path = base / f"{metric}.py"
    if not path.exists():
        path = base / f"{metric.split('.', 1)[0]}.py"
    return _module(path, "aqpbench_metric_").read


def table(name: str, root: Path = ROOT):
    """The ``make(rows, seed)`` function of ``tables/<name>.py``."""
    return _module(root / "aqpbench" / "tables" / f"{name}.py",
                   "aqpbench_table_").make


def loop(kind: str, root: Path = ROOT):
    """The ``run`` function of ``loops/<kind>.py``."""
    return _module(root / "aqpbench" / "loops" / f"{kind}.py",
                   "aqpbench_loop_").run
