"""The ``flights.append_rebuild`` cell on the CPU at a tiny size: a run
through the harness, traced and untraced, is correct and reads every metric
of the cell; the stream's reference imports nothing of the program and
slides one day a cycle; the precision control fails the cell's limit; the
readers take the window's cycles and read nothing without their spans and
counters."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from aqpbench import spec

ROOT = Path(__file__).resolve().parents[2]
CELL = "flights.append_rebuild"
READERS = ("preprocess_s", "gd_compress_s", "synopsis_build_s",
           "gd_rows_encoded")
# The rows of ``conftest.TINY``, which the cell's retained month is cut to.
TINY_ROWS = 10_000


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(run_tiny, trace):
    from aqpbench.reference import stream
    res = run_tiny(CELL, seed=3_000_000_017, trace=trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    cell = spec.cell(CELL)
    want = ({m["name"] for m in cell["per_layer"]} if trace
            else {"build_s", "setup_s"})
    assert set(res["metrics"]) == want
    if trace:
        config = cell["config"]
        held = stream.day_rows(config, TINY_ROWS) * config["retained_days"]
        assert res["metrics"]["gd_rows_encoded"]["value"] == held
        assert res["metrics"]["idle_share.append"]["value"] == 100.0


def test_traced_record_holds_the_cycles_builds():
    """A traced run keeps each cycle's build statistics under ``builds``,
    where the build cells' readers take them, and records the calendar: a
    retained month holds one or two months and every weekday."""
    import time

    import torch
    from aqpbench import harness
    from aqpbench.tests.conftest import TINY
    _, out = harness.run_cell(CELL, 3_000_000_019, 0.5, True,
                              torch.device("cpu"), time.perf_counter(),
                              **TINY)
    rec = out["record"]
    assert len(rec["builds"]) == len(rec["cycles"]) >= 1
    for metric in ("pair_phase_s", "refine_1d_s"):
        assert spec.reader(metric)(rec) > 0


def test_days_are_dated():
    from aqpbench.reference import stream
    cell = spec.cell(CELL)
    config, mix = cell["config"], cell["mix"]
    day = stream.day_rows(config, TINY_ROWS)
    held = stream.retained(config, mix, 9, 20, TINY_ROWS)
    assert set(held["month"]) == {1.0, 2.0}
    weekdays = held["day_of_week"].reshape(config["retained_days"], day)
    assert (weekdays == weekdays[:, :1]).all()
    # 21 January 2015 was a Wednesday, and a week on is one again.
    assert weekdays[0, 0] == weekdays[7, 0] == 3.0
    assert set(weekdays[:7, 0]) == set(range(1, 8))


def test_stream_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1]]\n"
        "from aqpbench import spec\n"
        "from aqpbench.reference import stream\n"
        "cell = spec.cell('flights.append_rebuild')\n"
        "stream.retained(cell['config'], cell['mix'], 5, 3, rows=2000)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro',"
        " 'repro_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_stream_slides_one_day_a_cycle():
    """Cycle k + 1 holds cycle k's days less the oldest, then one more; a
    day comes back only after the pool's length."""
    from aqpbench.reference import stream
    cell = spec.cell(CELL)
    config, mix = cell["config"], cell["mix"]
    day = stream.day_rows(config, TINY_ROWS)
    a, b = (stream.retained(config, mix, 9, k, TINY_ROWS) for k in (4, 5))
    n = day * config["retained_days"]
    for col in a:
        assert len(a[col]) == len(b[col]) == n
        np.testing.assert_array_equal(a[col][day:], b[col][:-day])
    far = stream.retained(config, mix, 9, 4 + mix["pool_days"], TINY_ROWS)
    for col in a:
        np.testing.assert_array_equal(a[col], far[col])


def test_control_fails_the_limit():
    import torch
    from aqpbench import control
    limit = spec.cell(CELL)["config"]["limits"]["synopsis_gap"]
    got = control.reading(CELL, 77, torch.device("cpu"), rows=20_000,
                          n_samples=4_000)
    assert got > limit


def _cycle(pre, gd, build, rows):
    return {"phase_s": {"merge": 0.01, "preprocess": pre,
                        "preprocess_categorical": pre / 2,
                        "gd_compress": gd, "gd_plan": gd / 2,
                        "build": build},
            "counts": {"preprocess_rows": rows, "gd_rows_encoded": rows,
                       "gd_bases": 40}}


@pytest.mark.parametrize("metric, want", [
    ("preprocess_s", 2.5), ("gd_compress_s", 1.5),
    ("synopsis_build_s", 0.3), ("gd_rows_encoded", 494_233.0)])
def test_reader_takes_the_mean_over_cycles(metric, want):
    rec = {"kind": "append",
           "cycles": [_cycle(2.0, 1.0, 0.2, 494_233),
                      _cycle(3.0, 2.0, 0.4, 494_233)]}
    assert spec.reader(metric)(rec) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_nothing_without_its_source(metric):
    read = spec.reader(metric)
    assert read({"kind": "append", "cycles": []}) is None
    assert read({"kind": "build", "builds": [{"phase_s": {"build": 1.0}}]}) \
        is None
    # Cycles of a program that publishes no ingest spans or counters.
    assert read({"kind": "append",
                 "cycles": [{"phase_s": {}, "counts": {}}] * 2}) is None
