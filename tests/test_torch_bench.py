"""The port's kernel benchmark entry point, at a small size on the CPU."""
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


def test_bench_run_refuses_unported_suites(tmp_path, capsys):
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        bench_run.suite("construction")
    with pytest.raises(ValueError, match="unknown suite"):
        bench_run.suite("nope")
    rc = bench_run.main(["--quick", "--only", "kernels,serving",
                         "--device", "cpu", "--out", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1 and "kernels/query_fused" in captured.out
    assert "FAILED suites: ['serving']" in captured.err
    assert (tmp_path / "kernels.json").exists()
