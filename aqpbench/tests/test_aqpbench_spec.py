"""BENCHMARK.json against the contract, and every entry resolved to its
files by name; a new configuration, mix and metric added as files run
without an edit of the harness."""
import json
import re
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["aqpbench"]
    assert bench["command"] == ["python3", "aqpbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 2 + 14 * 24 <= 338
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("aqpbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {"build_s", "setup_s"} == set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in bench["workloads"]]
    for w in cells:
        reported = [m for m in e2e.values() if w in m.get("workloads", [w])]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", [w]) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_entry_resolves_by_name(bench):
    from aqpbench import spec
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert callable(spec.loop(cell["mix"]["kind"]))
        assert callable(spec.table(cell["config"]["table"]))
        for key in cell["config"]["reduced"]:
            assert key in cell["config"]
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["guarantees"] and conf["limits"]


NEW_TABLE = """
import numpy as np


def make(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, n).astype(float)
    return {"a": a, "b": np.round(a * 3 + rng.normal(0, 4, n)),
            "c": rng.choice(np.array(["x", "y", "z"]), n)}
"""

NEW_LOOP = """
from aqpbench import spec


def run(cell, seed, seconds, trace, dev, t_start, root, **sizes):
    mix = dict(cell["mix"], check_builds=cell["mix"]["checked"])
    out = spec.loop("rebuild", root)(dict(cell, mix=mix), seed, seconds,
                                     trace, dev, t_start, root=root, **sizes)
    out["metrics"]["builds"] = len(out["record"]["builds"])
    return out
"""


def test_new_files_run_without_an_edit(tmp_path, run_tiny):
    """A deployment on a new table, a mix with a new loop and two metrics
    (one with a reader of its own, one read by an existing reader through
    its name's first part) added as files plus entries; no file that is
    there is edited."""
    shutil.copytree(ROOT / "aqpbench", tmp_path / "aqpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "aqpbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "aqpbench/configs/flights.json").read_text())
    conf.update(name="tiny", table="tiny", rows=3000)
    (tmp_path / "aqpbench/tables/tiny.py").write_text(NEW_TABLE)
    (tmp_path / "aqpbench/configs/tiny.json").write_text(json.dumps(conf))
    (tmp_path / "aqpbench/loops/counted.py").write_text(NEW_LOOP)
    (tmp_path / "aqpbench/traffic/once.json").write_text(
        json.dumps({"kind": "counted", "checked": 1}))
    (tmp_path / "aqpbench/metrics/pairs_per_build.py").write_text(
        "def read(rec):\n    b = rec['builds']\n"
        "    return sum(s['n_pairs'] for s in b) / len(b) if b else None\n")
    bench["configs"].append({"name": "tiny", "source": "x",
                             "file": "aqpbench/configs/tiny.json",
                             "reduced": ["rows"], "why": "x"})
    bench["workloads"].append({"name": "tiny.once", "config": "tiny",
                               "traffic": "once", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "builds", "unit": "builds",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.once"]})
    for name in ("pairs_per_build", "idle_share.once"):
        bench["per_layer"].append({"name": name, "unit": "x",
                                   "better": "lower",
                                   "source": "program_span", "layer": "x",
                                   "moves": "builds",
                                   "workloads": ["tiny.once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_tiny("tiny.once", trace=True, root=tmp_path)
    assert res["correct"], res["checks"]
    assert res["metrics"]["pairs_per_build"]["value"] == 3
    assert res["metrics"]["idle_share.once"]["value"] == 100.0
    assert "idle_share.build" not in res["metrics"]
    res = run_tiny("tiny.once", root=tmp_path)
    assert set(res["metrics"]) == {"build_s", "setup_s", "builds"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
