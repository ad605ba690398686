"""The port's smoke lanes (``scripts/torch_*_smoke.py``) and examples
(``examples/torch_*.py``) on the CPU: each runs with ``--device cpu`` in a
subprocess (its servers in ``"ref"`` mode, the kernels' plain versions)
with one intra-op thread (several test workers' torch threads otherwise
spin against each other, which the trace lane's timing gate would read
as tracing overhead), at its smallest arguments, and must exit 0 with
its own checks printed (a lane that failed only a timing gate runs
again, up to three times: ``TIMING_GATES``). None of them, nor the
port's diagnostic scripts or ``chip_smoke.py``, imports ``jax`` or the
reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# lane -> the lines its passing run prints (its gates).
LANES = {
    "torch_trace_smoke": ["trace_smoke: serving trace OK",
                          "trace_smoke: construction trace OK",
                          "trace_smoke: traced-vs-untraced overhead",
                          "trace_smoke: OK"],
    "torch_plan_smoke": ["zero-parse: OK (40 template-hit queries, 0 parses)",
                         "bit-for-bit: OK (40 plans + results)",
                         "telemetry: OK", "plan smoke: PASS"],
    "torch_gd_smoke": ["compress: OK", "gd-native build: OK (5000/12000",
                       "cold serve: OK (decode-once", "rebuild: OK",
                       "demote: OK", "gd smoke: PASS"],
    "torch_chaos_smoke": [
        "[ok] every future resolves (32/32)",
        "[ok] answers bit-identical to control",
        "[ok] chaos actually injected, at the fused launch too",
        "[ok] cold decode retried through fault",
        "[ok] deadline resolves typed within 2x deadline",
        "[ok] worker never stays dead",
        "[ok] telemetry consistent with typed failures",
        "[ok] queue depth bounded", "chaos_smoke: PASS"],
}

# example -> (its smallest arguments, lines its run prints).
EXAMPLES = {
    "torch_quickstart": ([], ["table: 12 columns x 200000 rows",
                              "synopsis:", "GROUP BY airline"]),
    "torch_aqp_edge_demo": ([], ["edge node storage:", "remote node answers",
                                 "rebuilt synopsis answers"]),
    "torch_serve_aqp": ([], ["== one wave, two tables, mixed shapes ==",
                             "stale as expected", "rejected: rejected=True",
                             "PlanError", "-> trace.json"]),
    "torch_serve_lm": ([], ["7 requests over 4 slots: 112 tokens"]),
    "torch_train_lm": (["--steps", "3", "--layers", "2"],
                       ["final step 3", "telemetry  SELECT AVG(loss)"]),
}


# The lanes' gates that time the run (the trace lane's overhead budget, the
# chaos lane's 2x deadline): on a CPU shared with other test workers they
# read the load. A lane whose every failed check is one of these runs
# again, up to three runs; any other failed check fails at once. On the
# card (chip_smoke.py's lanes phase) each lane runs once.
TIMING_GATES = ("tracing overhead", "deadline resolves typed")


def _failed_checks(out) -> list:
    """The check lines a lane printed as failed."""
    return [line.strip() for line in (out.stdout + out.stderr).splitlines()
            if "[FAIL]" in line or line.startswith(("FAIL", "  "))]


def _run(path: Path, args: list, cwd, timeout: int, attempts: int = 1) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for _ in range(attempts):
        out = subprocess.run(
            [sys.executable, str(path), *args, "--device", "cpu"], cwd=cwd,
            env=env, capture_output=True, text=True, timeout=timeout)
        failed = _failed_checks(out)
        if out.returncode == 0 or not failed or not all(
                any(gate in line for gate in TIMING_GATES)
                for line in failed):
            break
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_passes_its_gates_on_the_cpu(lane, tmp_path):
    stdout = _run(ROOT / "scripts" / f"{lane}.py", [], tmp_path, 120,
                  attempts=3)
    for line in LANES[lane]:
        assert line in stdout, (line, stdout[-3000:])


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_example_runs_on_the_cpu(example, tmp_path):
    args, lines = EXAMPLES[example]
    if example == "torch_train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    stdout = _run(ROOT / "examples" / f"{example}.py", args, tmp_path, 150)
    for line in lines:
        assert line in stdout, (line, stdout[-3000:])


def _imports(path: Path) -> set:
    """The top-level package of every module ``path`` imports, at any
    depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [f"scripts/{name}.py" for name in LANES]
                         + [f"examples/{name}.py" for name in EXAMPLES]
                         + ["scripts/torch_dryrun_flops.py",
                            "scripts/torch_trace_overhead.py",
                            "chip_smoke.py"])
def test_lanes_and_examples_import_neither_jax_nor_reference(path):
    names = _imports(ROOT / path)
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}, names
