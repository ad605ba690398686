"""The port's benchmark entry points, at small sizes on the CPU.

Each suite runs with ``quick=True, device="cpu"`` and its ``QUICK`` size
table shrunk through ``monkeypatch`` (a few seconds each); its CSV rows and
its JSON are checked. Without a card and without ``device="cpu"`` every
suite raises.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch.bench import kernels as bench_kernels
from repro_torch.bench import run as bench_run


def test_kernels_bench_writes_rows_and_json(tmp_path):
    rows = []
    out = bench_kernels.run(rows, quick=True, device="cpu", out_dir=tmp_path)
    names = [r.split(",")[0] for r in rows]
    assert names == ["kernels/hist2d", "kernels/hist2d_plain",
                     "kernels/hist2d_bincount", "kernels/fused_weightings",
                     "kernels/fused_weightings_plain",
                     "kernels/query_per_predicate", "kernels/query_fused",
                     "kernels/hist2d_sharded"]
    assert all(float(r.split(",")[1]) > 0 for r in rows)
    saved = json.loads((tmp_path / "kernels.json").read_text())
    assert saved["device"] == "cpu" and "card" not in saved
    assert saved["hist2d"]["n"] < 10_000 and saved["fused_weightings"]["l"] == 2
    assert saved["fused_weightings"]["k2"] == 32
    assert saved["query_path"]["agree"] is True
    assert saved["hist2d_sharded"]["world"] == 1
    assert np.allclose(out["query_path"]["answer"],
                       saved["query_path"]["answer"])
    assert not torch.distributed.is_initialized()


def test_kernels_bench_needs_cuda_by_default(monkeypatch, tmp_path):
    """No card: the bench raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_kernels.run([], quick=True, out_dir=tmp_path)
    assert not (tmp_path / "kernels.json").exists()


def test_bench_run_ports_every_suite_and_runs_roofline(tmp_path, capsys,
                                                      monkeypatch):
    """Every suite is ported; ``--only roofline`` reads the dry run's
    artifacts (one written here) and reports each cell; an unknown suite
    raises, and a failed suite does not stop the others."""
    from repro_torch.bench import roofline
    assert set(bench_run.PORTED) == set(bench_run.SUITES)
    with pytest.raises(ValueError, match="unknown suite"):
        bench_run.suite("nope")
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    _write_cells(tmp_path)
    out = tmp_path / "out"
    rc = bench_run.main(["--only", "roofline,kernels", "--quick", "--device",
                         "cpu", "--out", str(out)])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert "roofline/qwen3-0.6b/train_4k,,dom=" in captured.out
    assert "roofline/qwen3-0.6b/long_500k,,skipped:" in captured.out
    saved = json.loads((out / "roofline.json").read_text())
    assert saved["peaks_of"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert saved["peak_flops"] == 989e12 and saved["hbm_bw"] == 3.35e12
    assert saved["qwen3-0.6b/prefill_32k"]["skipped"] == "missing"
    assert (out / "kernels.json").exists()


def _write_cells(root):
    """Synthetic dry-run artifacts: qwen3's train_4k (its full-depth cell
    and a cost file), decode_32k and a skipped long_500k; mistral's
    train_4k with its full-depth cell only."""
    def cell(flops, nbytes, wire, n_dev=256, **extra):
        return dict({"ok": True, "n_devices": n_dev,
                     "cost_analysis": {"flops": flops,
                                       "bytes accessed": nbytes},
                     "collectives": {"all-gather": {
                         "count": 3, "result_bytes": wire,
                         "wire_bytes_per_device": wire * 15 / 16}},
                     "memory_analysis": {"temp_size_in_bytes": 7 * nbytes,
                                         "argument_size_in_bytes": nbytes}},
                    **extra)
    cells = {
        "qwen3-0.6b__train_4k__single_pod": cell(2.9e14, 4.7e13, 5.6e11),
        "qwen3-0.6b__train_4k__single_pod_cost": cell(3.1e14, 4.0e13,
                                                      1e11),
        "qwen3-0.6b__decode_32k__single_pod": cell(5.2e9, 3.1e10, 2e9),
        "qwen3-0.6b__long_500k__single_pod": {"skipped": True,
                                              "reason": "full attention"},
        "mistral-nemo-12b__train_4k__single_pod": cell(9e15, 2e13, 9e12,
                                                       n_dev=512),
    }
    for name, rec in cells.items():
        (root / f"{name}.json").write_text(json.dumps(rec))
    return [name.split("__")[:2] for name in cells
            if not name.endswith("_cost")]


def test_roofline_analyze_matches_reference(tmp_path, monkeypatch):
    """The port's ``analyze`` is the reference's on the same artifacts
    and peaks: the reference module's peaks and results directory are
    patched to the port's; only the name of the cost source differs (the
    port's full-depth count is exact, not a scan body counted once)."""
    from benchmarks import roofline as ref
    from repro_torch.bench import roofline
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref, name, getattr(roofline, name))
    monkeypatch.setattr(ref, "RESULTS_DIR", str(tmp_path))
    for arch, shape in _write_cells(tmp_path) + [["gemma2-2b", "train_4k"]]:
        got, want = roofline.analyze(arch, shape), ref.analyze(arch, shape)
        sources = (got.pop("cost_source", None), want.pop("cost_source",
                                                         None))
        assert got == want, (arch, shape)
        assert sources in ((None, None), ("full depth", "scan(body-once)"),
                           ("u1u2-extrapolated", "u1u2-extrapolated"))
    assert roofline.markdown_table(["train_4k"], ["qwen3_0_6b"]) \
        .count("| qwen3-0.6b | train_4k |") == 1


# Tiny ``QUICK`` tables (and fig9's grid) for the CPU runs of the suites.
TINY = {
    "construction": {"QUICK": {
        "full_build": (3000, 3), "pair_phase": (2000, 4),
        "correlated": (2000, 4), "trace": (2000, 4), "gd": (3000, 3),
        "repeats": 1}},
    "storage": {"QUICK": {"datasets": ("power",), "n": 4000,
                          "n_samples": 2000}},
    "fig8": {"QUICK": {"datasets": ("power", "gas"), "n": 4000,
                       "queries": 8, "n_samples": (1000, 2000),
                       "baseline_sample": 2000}},
    "fig9": {"QUICK": {"n": 4000, "queries": 8,
                       "knobs": ("n_samples", "alpha")},
             "GRID": {"n_samples": (1000, 2000), "m_frac": (0.02,),
                      "alpha": (0.01, 0.0001)},
             "BASE": dict(n_samples=2000, m_frac=0.01, alpha=0.001)},
    "table5": {"QUICK": {"n": 3000, "scale": 2, "queries": 12,
                         "n_samples": 2000}},
    "table6": {"QUICK": {"n": 3000, "scale": 2, "queries": 12,
                         "n_samples": 2000}},
    "fig11": {"QUICK": {"n": 3000, "scale": 2, "queries": 8,
                        "n_samples": 2000}},
    "serving": {"QUICK": {
        "n": 4000, "n_samples": 2000, "templates": 2, "variants": 3,
        "requests": 32, "stream": 16, "gb_templates": 1, "gb_variants": 2,
        "gb_requests": 12, "ov_threads": 2, "ov_per_thread": 4,
        "pl_variants": 8, "reps": 1, "guard_iters": 1000}},
}

# Every row name each suite emits at the tiny sizes (``{d}``: a dataset).
ROWS = {
    "construction": [
        "construction/sequential_alg1", "construction/levelsync",
        "construction/pair_loop", "construction/pair_batched",
        "construction/correlated_compact", "construction/gd_compression",
        "construction/gd_build", "construction/gd_cold_start"],
    "storage": ["storage/power/encoded", "storage/power/vs_eq12_bound",
                "storage/power/roundtrip", "storage/power/codec",
                "storage/power/decode_vectorized"],
    "fig8": [f"fig8/{d}/{r}" for d in ("power", "gas") for r in (
        "pairwisehist_1k_err", "pairwisehist_1k_size", "pairwisehist_2k_err",
        "pairwisehist_2k_size", "sampling_2k_err", "histproduct_2k_err")],
    "fig9": ["fig9/n_samples=1000", "fig9/n_samples=2000",
             "fig9/alpha=0.01", "fig9/alpha=0.0001"],
    "table6": [f"table6/{d}/{r}" for d in ("power", "flights")
               for r in ("correct_rate", "width", "correct_rate_corrected")],
    "fig11": [f"fig11/{d}/{r}" for d in ("power", "flights") for r in (
        "latency", "synopsis_size", "total_storage_reduction",
        "build_time")],
}


def _run_tiny(name, monkeypatch, tmp_path):
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    for attr, value in TINY[name].items():
        monkeypatch.setattr(mod, attr, value)
    rows = []
    out = mod.run(rows, quick=True, device="cpu", out_dir=tmp_path)
    saved = json.loads((tmp_path / f"{name}.json").read_text())
    assert saved["device"] == "cpu" and "card" not in saved
    assert saved["quick"] is True
    assert all(len(r.split(",")) >= 3 for r in rows)
    return rows, out, saved


@pytest.mark.parametrize("name", [n for n in TINY if n in ROWS])
def test_suite_rows_and_json(name, monkeypatch, tmp_path):
    rows, out, saved = _run_tiny(name, monkeypatch, tmp_path)
    assert [r.split(",")[0] for r in rows] == ROWS[name]
    assert set(saved) == set(out) | {"device"}


def test_construction_suite_schedulers_agree(monkeypatch, tmp_path):
    rows, out, saved = _run_tiny("construction", monkeypatch, tmp_path)
    assert saved["pair_phase"]["bitforbit_equal"] is True
    cor = saved["correlated"]
    assert cor["bitforbit_equal"] is True and cor["n_pairs"] == 6
    assert cor["per_pair_loop_s"] > 0 and cor["compact_s"] > 0
    assert 0 < cor["occupancy"] <= 1
    assert cor["compact_launches"]
    assert saved["gd"]["rows_decoded"] == 1500


def test_construction_suite_trace(monkeypatch, tmp_path):
    mod = importlib.import_module("repro_torch.bench.construction")
    monkeypatch.setattr(mod, "QUICK", TINY["construction"]["QUICK"])
    rows = []
    out = mod.run(rows, quick=True, device="cpu", out_dir=tmp_path,
                  correlated_only=True, trace=True)
    assert "full_build" not in out and out["trace"]["valid"] is True
    assert json.loads((tmp_path / "construction_trace.json").read_text())
    names = [r.split(",")[0] for r in rows]
    assert "construction/trace_artifact" in names
    assert "construction/phase_pair_phase" in names


def test_table5_rows_cover_aggregations(monkeypatch, tmp_path):
    rows, _out, saved = _run_tiny("table5", monkeypatch, tmp_path)
    for d in ("power", "flights"):
        assert f"table5/{d}/overall" in [r.split(",")[0] for r in rows]
        funcs = set(saved[d]) - {"overall"}
        assert funcs and funcs <= {"COUNT", "SUM", "AVG", "MIN", "MAX",
                                   "MEDIAN", "VAR"}
        assert sum(saved[d][f]["n"] for f in funcs) == 12


def test_serving_suite_modes(monkeypatch, tmp_path):
    """On an explicit ``device="cpu"`` the server runs the fused path's
    plain version (``"ref"``), never a quiet host mode; every section of
    the reference's suite reports."""
    rows, _out, saved = _run_tiny("serving", monkeypatch, tmp_path)
    assert saved["mode"] == "ref"
    for key in ("qps_b1", "qps_b8", "qps_b64", "qps_b64_cold",
                "qps_b64_fused_ref", "streaming", "groupby", "overload",
                "planning", "tracing", "faults"):
        assert key in saved, key
    assert saved["streaming"]["p99_ms"] >= saved["streaming"]["p50_ms"] > 0
    assert saved["overload"]["split"]["qps"] > 0
    names = [r.split(",")[0] for r in rows]
    assert names[0] == "serving/qps_baseline"
    assert names[-1] == "serving/fault_hooks_disabled_overhead"


@pytest.mark.parametrize("name", sorted(set(bench_run.PORTED)
                                         - {"kernels", "roofline"}))
def test_suites_need_cuda_by_default(name, monkeypatch, tmp_path):
    """No card: every suite that measures raises at once instead of falling
    back to the CPU, and writes no JSON (``roofline`` reads files and
    measures nothing)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_run.suite(name).run([], quick=True, out_dir=tmp_path)
    assert not list(tmp_path.iterdir())
