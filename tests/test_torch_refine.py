"""The port's level-synchronous refinement vs the paper-faithful sequential
oracle, and its single-pair functions against the reference's.

The first four tests are re-pointed copies of ``tests/test_refine.py``
(``ref_sequential`` and ``refine`` taken from the port, on the CPU). The
rest feed the same numpy inputs to the reference's and the port's
``refine_2d``, ``pair_metadata``, ``presort_pairs`` and
``ref_sequential.build_{1d,2d}_sequential`` and require equal outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import chi2 as chi2lib
from repro_torch.core import ref_sequential, refine


def _dist(name, n=4000, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "bimodal": lambda: np.where(rng.random(n) < 0.4, rng.normal(50, 3, n),
                                    rng.normal(200, 30, n)).round(),
        "uniform": lambda: rng.integers(0, 50, n).astype(float),
        "zipf": lambda: rng.zipf(1.6, n).clip(1, 500).astype(float),
        "steps": lambda: np.repeat(np.arange(8.0) * 100, n // 8)
        + rng.integers(0, 30, n),
    }[name]()


def _bfs_edges(x, init, m_pts, crit):
    K = 384
    xs = np.sort(x)
    up = np.concatenate([[0], np.cumsum(np.concatenate([[True],
                                                        xs[1:] != xs[:-1]]))])
    e0 = np.full(K + 1, np.inf)
    e0[: len(init)] = init
    edges, k = refine.refine_1d(
        torch.from_numpy(xs)[None],
        torch.from_numpy(up.astype(np.int64))[None],
        torch.from_numpy(e0)[None], torch.tensor([len(init) - 1]),
        float(m_pts), torch.from_numpy(crit))
    return edges[0].numpy()[: int(k[0]) + 1]


@pytest.mark.parametrize("dist", ["bimodal", "uniform", "zipf", "steps"])
def test_bfs_equals_sequential_recursion(dist):
    x = _dist(dist)
    crit = chi2lib.build_crit_table(0.001, 128)
    m_pts = 40
    init = np.array([x.min(), x.max()], float)
    e_seq, h, u, vmin, vmax = ref_sequential.build_1d_sequential(
        x, init, m_pts, crit)
    e_bfs = _bfs_edges(x, init, m_pts, crit)
    assert e_seq.size == e_bfs.size
    np.testing.assert_allclose(e_seq, e_bfs)


@pytest.fixture(scope="module")
def port_synopsis(small_table):
    from repro_torch.core.build import build_pairwise_hist
    from repro_torch.core.types import BuildParams, ColumnInfo
    data = np.stack(list(small_table.values()), 1)
    cols = [ColumnInfo(name=k, kind="int") for k in small_table]
    return build_pairwise_hist(data, cols, BuildParams(n_samples=30_000,
                                                       seed=3), device="cpu")


def test_refinement_invariants(port_synopsis):
    for hist in port_synopsis.hists:
        k = int(hist.k)
        edges = hist.edges[: k + 1]
        assert np.all(np.diff(edges) >= 0)
        assert np.all(hist.h >= 0)
        assert np.all(hist.u <= np.maximum(hist.h, 1))
        assert np.all(hist.vmin <= hist.vmax + 1e-12)
        assert np.all(hist.vmin >= edges[:-1] - 1e-9)
        assert np.all(hist.vmax <= edges[1:] + 1e-9)
        assert np.all(hist.cminus <= hist.cplus + 1e-12)
        assert np.all(hist.cminus >= hist.vmin - 1e-9)
        assert np.all(hist.cplus <= hist.vmax + 1e-9)


def test_pair_invariants(port_synopsis):
    syn = port_synopsis
    for (i, j), pr in syn.pairs.items():
        np.testing.assert_allclose(pr.H.sum(1), pr.hx)
        np.testing.assert_allclose(pr.H.sum(0), pr.hy)
        # pair edges are a subset of the union-refined 1-D edges
        e1 = syn.hists[i].edges
        assert np.all(np.isin(np.round(pr.ex, 9), np.round(e1, 9)))
        e1j = syn.hists[j].edges
        assert np.all(np.isin(np.round(pr.ey, 9), np.round(e1j, 9)))
        # fold maps (1-D bin -> pair row) are monotone and in range
        assert np.all(np.diff(pr.fold_x) >= 0)
        assert np.all(np.diff(pr.fold_y) >= 0)
        assert pr.fold_x.shape[0] == int(syn.hists[i].k)
        assert pr.fold_y.shape[0] == int(syn.hists[j].k)
        assert pr.fold_x.max() < int(pr.kx)
        assert pr.fold_y.max() < int(pr.ky)


def test_uniform_data_is_not_split():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1000, 20000).astype(float)
    crit = chi2lib.build_crit_table(0.001, 128)
    e = _bfs_edges(x, np.array([x.min(), x.max()]), 200, crit)
    assert e.size - 1 <= 2  # uniform: essentially no refinement


# ---------------------------------------------------------------- reference


def _pair_inputs(case):
    """One pair's (x, y, valid, ex0, ey0, kx0, ky0) as numpy, at k2 = 32."""
    rng = np.random.default_rng(5)
    n, k2 = 1500, 32
    base = np.abs(rng.normal(100, 30, n))
    x, y = {
        "correlated": (np.round(base), np.round(base * 2
                                                + rng.normal(0, 5, n))),
        "independent": (np.round(rng.uniform(0, 50, n)),
                        np.round(rng.uniform(0, 200, n))),
        "ties": (np.round(rng.uniform(0, 9, n)),
                 np.round(rng.uniform(0, 50, n) * 3 + base)),
    }[case]
    valid = rng.random(n) >= 0.1
    x = np.where(valid, x, 0.0)       # the build's nan_to_num of NULL rows
    ex0 = np.full(k2 + 1, np.inf)
    ey0 = np.full(k2 + 1, np.inf)
    ex0[:3] = [x.min(), np.median(x), x.max()]
    ey0[:2] = [y.min(), y.max()]
    return x, y, valid, ex0, ey0, 2, 1


@pytest.mark.parametrize("case", ["correlated", "independent", "ties"])
@pytest.mark.parametrize("k2", [32, 8])
def test_refine_2d_and_pair_metadata_match_reference(case, k2):
    """The per-pair loop's edges and bin counts, then every metadata field,
    equal the reference's on the same inputs (k2 = 8 binds the guard)."""
    from repro.core import refine as ref_refine
    x, y, valid, ex0, ey0, kx0, ky0 = _pair_inputs(case)
    ex0, ey0 = ex0[: k2 + 1], ey0[: k2 + 1]
    crit = chi2lib.build_crit_table(0.001, 16)
    m_pts = 25.0
    rex, rey, rkx, rky = ref_refine.refine_2d(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), jnp.asarray(ex0),
        jnp.asarray(ey0), jnp.int32(kx0), jnp.int32(ky0), jnp.float64(m_pts),
        jnp.asarray(crit), k2=k2, s_max=16, max_rounds=16)
    t = torch.from_numpy
    pex, pey, pkx, pky = refine.refine_2d(
        t(x), t(y), t(valid), t(ex0), t(ey0), kx0, ky0, m_pts, t(crit),
        k2=k2, s_max=16, max_rounds=16)
    np.testing.assert_array_equal(pex.numpy(), np.asarray(rex))
    np.testing.assert_array_equal(pey.numpy(), np.asarray(rey))
    assert (pkx, pky) == (int(rkx), int(rky))
    assert pkx + pky > kx0 + ky0 or case == "independent"

    want = ref_refine.pair_metadata(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), rex, rey, rkx,
        rky, k2=k2)
    got = refine.pair_metadata(t(x), t(y), t(valid), pex, pey, pkx, pky,
                               k2=k2)
    names = "H hx ux vminx vmaxx hy uy vminy vmaxy".split()
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_presort_pairs_matches_reference():
    from repro.core import refine as ref_refine
    rng = np.random.default_rng(2)
    p, n = 3, 400
    x = rng.integers(0, 30, (p, n)).astype(float)   # many ties
    y = rng.integers(0, 30, (p, n)).astype(float)
    valid = rng.random((p, n)) < 0.9
    want = ref_refine.presort_pairs(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(valid))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = refine.presort_pairs(tx, ty, torch.from_numpy(valid),
                               refine.column_ranks(tx),
                               refine.column_ranks(ty))
    for name, g, w in zip("xo1 yo1 vo1 new1 xo2 yo2 vo2 new2".split(),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("dist", ["bimodal", "uniform", "zipf", "steps"])
def test_ref_sequential_matches_reference(dist):
    """The port's copy of Algorithms 1 and 2 returns exactly the
    reference's 1-D and 2-D results and crit table."""
    from repro.core import ref_sequential as ref_seq
    x = _dist(dist)
    y = _dist("bimodal" if dist != "bimodal" else "zipf", seed=12)
    for alpha in (0.01, 0.001, 0.0001):
        np.testing.assert_array_equal(
            ref_sequential.crit_table_for(alpha, 128),
            ref_seq.crit_table_for(alpha, 128))
    crit = ref_seq.crit_table_for(0.001, 128)
    m_pts = 40
    one_d = {}
    for name, v in (("x", x), ("y", y)):
        init = np.array([v.min(), v.max()], float)
        got = ref_sequential.build_1d_sequential(v, init, m_pts, crit)
        want = ref_seq.build_1d_sequential(v, init, m_pts, crit)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        one_d[name] = got[0]
    got = ref_sequential.build_2d_sequential(x, y, one_d["x"], one_d["y"],
                                             m_pts, crit, s_max=32)
    want = ref_seq.build_2d_sequential(x, y, one_d["x"], one_d["y"], m_pts,
                                       crit, s_max=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
