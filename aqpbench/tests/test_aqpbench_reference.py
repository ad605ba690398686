"""The plain reference: it imports nothing of JAX, the JAX package or the
port, and it agrees with the port run on the CPU at a tiny size."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BUILD = {"n_samples": 3_000, "alpha": 0.001, "m_frac": 0.01}


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1]]\n"
        "import aqpbench.reference.synopsis, aqpbench.reference.table\n"
        "import aqpbench.check, aqpbench.control, aqpbench.spec\n"
        "from aqpbench import spec\n"
        "spec.table('flights')(100, 1); spec.table('power')(100, 1)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro',"
        " 'repro_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_sources_name_no_program_module():
    for path in (ROOT / "aqpbench" / "reference").glob("*.py"):
        for line in path.read_text().splitlines():
            if line.startswith(("import ", "from ")):
                assert "repro" not in line and "jax" not in line, line


@pytest.fixture(scope="module", params=["flights", "power"])
def both(request):
    """The port's synopsis and table and the reference's of one tiny
    table."""
    from aqpbench import check, spec
    from aqpbench.reference import synopsis as ref
    from repro_torch.aqp.engine import AQPFramework
    from repro_torch.core.types import BuildParams
    torch.set_num_threads(1)
    gd = spec.cell(f"{request.param}.build")["config"]["greedygd"]
    table = spec.table(request.param)(12_000, 8)
    fw = AQPFramework(BuildParams(seed=5, **BUILD), device="cpu")
    fw.ingest(table)
    want = ref.reference(table, BUILD, [5], "cpu", gd=gd)[0]
    return table, fw, check.fields(fw.synopsis), want, gd


def test_reference_synopsis_is_the_ports(both):
    from aqpbench import check
    from aqpbench.reference import synopsis as ref
    _, _, got, want, _ = both
    assert check.synopsis_gap(got, want) < 1e-13
    # Every count, edge and fold is the port's to the bit.
    for hg, hw in zip(got["hists"], want["hists"]):
        for f in ("edges", "k", "h", "u", "vmin", "vmax"):
            assert np.array_equal(hg[f], hw[f]), f
    for key, pw in want["pairs"].items():
        for f in ref.PAIR_FIELDS:
            assert np.array_equal(got["pairs"][key][f], pw[f]), (key, f)


def test_reference_table_is_the_ports(both):
    from aqpbench.reference import table as ref_table
    from repro_torch.gd.greedygd import GreedyGD
    table, fw, _, _, gd = both
    data, meta = ref_table.preprocess(table)
    assert np.array_equal(data, fw.preprocessed.data, equal_nan=True)
    assert [m["kind"] for m in meta] == [c.kind for c in
                                         fw.preprocessed.columns]
    for mine, port in zip(ref_table.seed_edges(data, gd),
                          GreedyGD.seed_edges(fw.compressed)):
        assert np.array_equal(mine, port)


def test_a_different_sample_reads_a_gap(both):
    from aqpbench import check
    from aqpbench.reference import synopsis as ref
    table, _, got, _, gd = both
    other = ref.reference(table, BUILD, [6], "cpu", gd=gd)[0]
    assert check.synopsis_gap(got, other) > 1e-3


def test_subbins_are_the_least_cube_root():
    from aqpbench.reference.synopsis import subbins
    u = torch.arange(0, 300_000, dtype=torch.float64)
    s = subbins(u, 10_000)
    want = [max(1, next(k for k in range(200) if k ** 3 >= 2 * v))
            for v in range(0, 300_000, 997)]
    assert s[::997].tolist() == want
    assert subbins(u, 32).max() == 32


def test_quantiles_are_chi_squared():
    from aqpbench.reference.synopsis import quantiles
    from scipy import stats
    q = quantiles(0.001, 8)
    assert np.isinf(q[:2]).all()
    assert q[2] == pytest.approx(10.827566, rel=1e-6)
    assert stats.chi2.sf(q[5], 4) == pytest.approx(0.001, rel=1e-9)


def test_field_gap():
    from aqpbench.check import field_gap
    assert field_gap([1.0, np.inf], [1.0, np.inf]) == 0.0
    assert field_gap([1.0, 2.0], [1.0]) == 1.0
    assert field_gap([1.0, np.inf], [1.0, 2.0]) == 1.0
    assert field_gap([4.0, 2.0], [4.0, 2.5]) == pytest.approx(0.125)
