"""The port's end-to-end framework against the reference package, and the
port's import hygiene (no JAX, nothing of the reference package)."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.fastpath import FastPath
from repro_torch.core.types import BuildParams

from test_query_accuracy import CASES
from test_torch_build import assert_same_synopsis

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def frameworks(small_table):
    from repro.aqp.engine import AQPFramework as RefFramework
    from repro.core.types import BuildParams as RefParams
    ref = RefFramework(RefParams(n_samples=30_000)).ingest(small_table)
    port = AQPFramework(BuildParams(n_samples=30_000),
                        fastpath=FastPath(device="cpu"),
                        device="cpu").ingest(small_table)
    return ref, port


def test_ingest_builds_the_reference_synopsis(frameworks):
    ref, port = frameworks
    assert_same_synopsis(ref.synopsis, port.synopsis)
    t = port.timings
    assert t["build_pair_mode"] == "compact"
    assert t["build_from_compressed"] is True
    assert t["build_pairs_s"] > 0 and "pair_phase" in t["build_phase_s"]
    # The reference's keys, and the ingest's span tree beside them.
    assert set(t) == set(ref.timings) | {"ingest_timeline", "ingest_phase_s",
                                         "ingest_counts"}


@pytest.mark.parametrize("sql,tol_pct", CASES)
def test_answers_match_reference(frameworks, sql, tol_pct):
    ref, port = frameworks
    r_ref, r_port = ref.query(sql), port.query(sql)
    np.testing.assert_allclose(r_port.as_tuple(), r_ref.as_tuple(),
                               rtol=1e-5, atol=1e-6)


def test_append_rebuild_publishes_new_epoch(small_table):
    fw = AQPFramework(BuildParams(n_samples=4000), use_compression=False,
                      device="cpu")
    seen = []
    fw.on_invalidate(lambda f: seen.append(f.epoch))
    fw.ingest(small_table)
    e1 = fw.epoch
    extra = {k: np.asarray(v)[:500] for k, v in small_table.items()}
    fw.append_rows(extra)
    assert fw.is_stale and fw.epoch > e1
    with pytest.raises(RuntimeError, match="stale"):
        fw.query("SELECT COUNT(*) FROM t")
    fw.rebuild(small_table)
    assert not fw.is_stale and len(seen) == 3
    assert fw.synopsis.n_rows == len(small_table["c0"]) + 500
    engine, epoch = fw.published
    assert engine is fw.engine and epoch == fw.epoch == seen[-1]


def test_ingest_compressed_matches_reference(small_table):
    from repro.aqp.engine import AQPFramework as RefFramework
    from repro.core.types import BuildParams as RefParams
    from repro.gd.greedygd import GreedyGD as RefGD
    from repro.gd.preprocess import preprocess_table as ref_preprocess
    from repro_torch.gd.greedygd import GreedyGD
    from repro_torch.gd.preprocess import preprocess_table
    pp_r = ref_preprocess(small_table)
    pp = preprocess_table(small_table)
    ref = RefFramework(RefParams(n_samples=6000, seed=3)).ingest_compressed(
        RefGD().compress(pp_r.data), pp_r.columns)
    port = AQPFramework(BuildParams(n_samples=6000, seed=3),
                        device="cpu").ingest_compressed(
        GreedyGD(device="cpu").compress(pp.data), pp.columns)
    assert port.preprocessed is None and port.timings["build_from_compressed"]
    assert_same_synopsis(ref.synopsis, port.synopsis)
    sql = "SELECT COUNT(*) FROM t WHERE c1 > 300"
    assert port.query(sql).as_tuple() == ref.query(sql).as_tuple()


def test_ingest_compressed_timings_are_ingests(frameworks):
    """Both ingest paths publish the same build timings; the raw ingest
    adds only its span tree."""
    from repro_torch.gd.greedygd import GreedyGD
    _ref, port = frameworks
    fw = AQPFramework(BuildParams(n_samples=4000, seed=3), device="cpu")
    fw.ingest_compressed(
        GreedyGD(device="cpu").compress(port.preprocessed.data),
        port.preprocessed.columns)
    t = fw.timings
    assert set(t) <= set(port.timings)
    assert set(port.timings) - set(t) == {"ingest_timeline",
                                          "ingest_phase_s", "ingest_counts"}
    assert t["preprocess_s"] == t["compress_s"] == 0.0
    assert t["build_synopsis_s"] > 0 and t["build_pair_mode"] == "compact"
    assert t["build_from_compressed"] is True


def test_storage_reports_wait_for_the_codec(frameworks):
    """The codec is ported: the storage report and synopsis size are the
    reference's on the same table (the synopses are bit-identical)."""
    ref, port = frameworks
    assert port.storage_report() == ref.storage_report()
    assert port.size_bytes() == ref.size_bytes() > 0


def test_default_device_needs_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AQPFramework()


def test_port_imports_neither_jax_nor_reference():
    """Import every module of the port in a fresh interpreter (the storage
    codec, ``obs`` and ``serve.aqp`` included): no ``jax`` and no ``repro``
    module may be loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
        # 50 modules with the storage codec, obs and serve.aqp: a module
        # that goes missing later shows here.
        assert len(names) >= 50 and not bad, (len(names), bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
