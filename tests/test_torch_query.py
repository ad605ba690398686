"""The port's query side against the reference package, on one synopsis.

The reference builds the conftest synopsis; ``synopsis_from_numpy`` copies
it into the port's types, so these tests hold the port's ``FastPath`` and
``QueryEngine`` to the reference independently of the build port.
"""
import numpy as np
import pytest

from repro_torch.core.fastpath import FastPath
from repro_torch.core.query import QueryEngine
from repro_torch.core.types import PairwiseHist, synopsis_from_numpy

FASTPATH_SQL = (
    "SELECT COUNT(c0) FROM t WHERE c1 > 300 AND c2 < 900",
    "SELECT AVG(c2) FROM t WHERE c1 >= 250 AND c1 < 350",
    "SELECT SUM(c1) FROM t WHERE c2 <= 900 AND c0 < 500",
    "SELECT MIN(c1) FROM t WHERE c1 > 100",
    # OR falls back to the NumPy path inside the engine
    "SELECT AVG(c1) FROM t WHERE c0 < 100 OR c3 = 2",
)


@pytest.fixture(scope="module")
def port_synopsis(synopsis):
    return synopsis_from_numpy(synopsis)


def test_synopsis_from_numpy_copies_every_field(synopsis, port_synopsis):
    ph = port_synopsis
    assert isinstance(ph, PairwiseHist)
    assert (ph.n_rows, ph.n_sampled, ph.d) == (synopsis.n_rows,
                                               synopsis.n_sampled, synopsis.d)
    assert [c.name for c in ph.columns] == [c.name for c in synopsis.columns]
    for h1, h2 in zip(synopsis.hists, ph.hists):
        for f in h1._fields:
            np.testing.assert_array_equal(getattr(h1, f), getattr(h2, f))
    for key, p1 in synopsis.pairs.items():
        p2 = ph.pairs[key]
        for f in p1._fields:
            x, y = np.asarray(getattr(p1, f)), np.asarray(getattr(p2, f))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
            if x.ndim:
                assert not np.shares_memory(x, y)
    np.testing.assert_array_equal(ph.chi2_table, synopsis.chi2_table)
    assert ph.params.n_samples == synopsis.params.n_samples


def test_pair_betas_batch_bit_for_bit(synopsis, port_synopsis):
    """The port's vectorized beta assembly equals the reference's, and its
    own per-query path, bit for bit."""
    from repro.core import weightings as ref_wlib
    from repro.core.fastpath import FastPath as RefFastPath
    from repro_torch.core import weightings as wlib
    rng = np.random.default_rng(5)
    ref_lists, port_lists = [], []
    for qi in range(9):
        lo = float(rng.uniform(100, 500))
        op1 = str(rng.choice(["<", "<=", ">", ">=", "=", "!="]))
        v1 = float(rng.uniform(-50, 700))
        op2 = str(rng.choice(["<", ">"]))
        v2 = float(rng.uniform(0, 1200))
        for lib, out in ((ref_wlib, ref_lists), (wlib, port_lists)):
            out.append([lib.Leaf(1, op1, v1),
                        (lib.Consolidated(2, [(lo, lo + 200.0)])
                         if qi % 3 == 0 else lib.Leaf(2, op2, v2))])
    fp = FastPath(device="cpu")
    got = fp._pair_betas_batch(port_synopsis, 0, port_lists, 512)
    want = RefFastPath(use_pallas=False)._pair_betas_batch(
        synopsis, 0, ref_lists, 512)
    np.testing.assert_array_equal(got, want)
    seq = np.stack([fp._pair_betas(port_synopsis, 0, pls, 512)
                    for pls in port_lists])
    np.testing.assert_array_equal(got, seq)


def test_fastpath_batch_equals_single(port_synopsis):
    fp = FastPath(device="cpu")
    eng = QueryEngine(port_synopsis)
    trees = [eng.plan_sql(f"SELECT COUNT(c0) FROM t WHERE c1 > {200 + 10 * i}"
                          f" AND c2 < {900 - 15 * i}").tree
             for i in range(6)]
    batch = fp.batch(port_synopsis, 0, trees, corrected=False)
    assert batch is not None
    for tree, triple in zip(trees, batch):
        single = fp(port_synopsis, 0, tree, corrected=False)
        for got, want in zip(triple, single):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_fastpath_equals_reference_engine(synopsis, port_synopsis):
    from repro.core.query import QueryEngine as RefEngine
    e_ref = RefEngine(synopsis)
    e_fast = QueryEngine(port_synopsis, fastpath=FastPath(device="cpu"))
    e_host = QueryEngine(port_synopsis)
    for sql in FASTPATH_SQL:
        r_ref = e_ref.query(sql)
        np.testing.assert_allclose(e_fast.query(sql).as_tuple(),
                                   r_ref.as_tuple(), rtol=1e-5, atol=1e-6)
        # The host NumPy path is the same code on the same arrays.
        assert e_host.query(sql).as_tuple() == r_ref.as_tuple()


def test_host_engine_matches_reference_on_corpus(synopsis, port_synopsis):
    from repro.core.query import QueryEngine as RefEngine
    from test_query_accuracy import CASES
    e_ref = RefEngine(synopsis)
    e_port = QueryEngine(port_synopsis)
    for sql, _tol in CASES:
        assert e_port.query(sql).as_tuple() == e_ref.query(sql).as_tuple(), sql


def test_fastpath_default_device_needs_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastPath()
