"""The port's chi-squared machinery against the reference package.

Run as a script with ``--write`` to regenerate the checked-in critical-value
tables of the port from the reference:

    PYTHONPATH=src python tests/test_torch_chi2.py --write
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CRIT_MODULE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
               / "core" / "crit_table.py")
CRIT_ALPHAS = (0.01, 0.001, 0.0001)
CRIT_S_MAX = 256


def render_crit_module(tables) -> str:
    """Source of ``repro_torch/core/crit_table.py`` for reference tables,
    ``{alpha: table}``."""
    blocks = "".join(
        f"    {alpha!r}: (\n"
        + "".join(f'        "{float(v).hex()}",\n' for v in table)
        + "    ),\n" for alpha, table in tables.items())
    return f'''"""Chi-squared critical values for alpha in {CRIT_ALPHAS}, s = 0 .. {CRIT_S_MAX}.

``CRIT_HEX[alpha][s] = chi2_isf(alpha, df=s-1)`` as exact ``float.hex``
literals, +inf for s < 2. Generated from the reference package's
``repro.core.chi2.build_crit_table`` by

    PYTHONPATH=src python tests/test_torch_chi2.py --write

(do not edit by hand); ``tests/test_torch_chi2.py`` regenerates the tables
and compares them bit for bit.
"""

CRIT_S_MAX = {CRIT_S_MAX}
CRIT_HEX = {{
{blocks}}}
'''


def _reference_tables():
    from repro.core import chi2 as ref_chi2
    return {alpha: ref_chi2.build_crit_table(alpha, CRIT_S_MAX)
            for alpha in CRIT_ALPHAS}


def _reference_table():
    """The reference's table at the paper's alpha = 0.001, s <= 128."""
    from repro.core import chi2 as ref_chi2
    return ref_chi2.build_crit_table(0.001, 128)


def test_crit_table_bit_identical_to_reference():
    """H1/F1: the checked-in tables are the reference's, bit for bit, at
    every alpha the repo uses, and the module on disk is exactly what
    ``--write`` would produce."""
    from repro_torch.core import chi2
    ref = _reference_tables()
    for alpha, want in ref.items():
        got = chi2.build_crit_table(alpha, CRIT_S_MAX)
        assert got.dtype == np.float64
        assert [v.hex() for v in got.tolist()] == \
            [v.hex() for v in want.tolist()]
    assert CRIT_MODULE.read_text() == render_crit_module(ref)


@pytest.mark.parametrize("alpha", CRIT_ALPHAS)
@pytest.mark.parametrize("s_max", [2, 16, 32, 128, 256])
def test_crit_table_prefixes(alpha, s_max):
    """F1: bit-identical at alpha 0.01, 0.001 and 0.0001 for every s_max up
    to the tables' 256 (before, only alpha = 0.001 with s <= 128 was)."""
    from repro.core import chi2 as ref_chi2
    from repro_torch.core import chi2
    np.testing.assert_array_equal(chi2.build_crit_table(alpha, s_max),
                                  ref_chi2.build_crit_table(alpha, s_max))


def test_crit_table_other_alpha_bisects_close_to_reference():
    """An alpha outside the tables runs the bisection on torch's gammaincc:
    the same quantiles up to the last bits of the two gamma functions."""
    from repro.core import chi2 as ref_chi2
    from repro_torch.core import chi2
    got = chi2.build_crit_table(0.05, 40)
    want = ref_chi2.build_crit_table(0.05, 40)
    assert np.isinf(got[:2]).all()
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-12)


def test_num_subbins_matches_cbrt_for_every_count():
    """H2: the cube-free sub-bin count equals the reference's
    ceil(cbrt(2u)) for every integer u in 0..200000, at s_max 128 and 32."""
    import jax.numpy as jnp
    from repro.core import chi2 as ref_chi2
    from repro_torch.core import chi2
    u = np.arange(0, 200_001, dtype=np.float64)
    for s_max in (128, 32):
        want = np.asarray(ref_chi2.num_subbins(jnp.asarray(u), s_max))
        got = chi2.num_subbins(torch.from_numpy(u), s_max).numpy()
        np.testing.assert_array_equal(got, want)


def test_subbin_counts_matches_reference():
    """chi2.subbin_counts (port, plain path) == the reference's, bit for
    bit, including null rows and zero-width (constant) cells."""
    import jax.numpy as jnp
    from repro.core import chi2 as ref_chi2
    from repro_torch.core import chi2
    rng = np.random.default_rng(4)
    p, n, k2, s_max = 2, 3000, 8, 16
    ncell = k2 * k2
    vals = rng.uniform(0, 100, (p, n))
    lo = np.floor(rng.uniform(0, 50, (p, n)))
    width = rng.choice([0.0, 25.0, 50.0], (p, n))
    cell = rng.integers(0, ncell, (p, n))
    u = rng.integers(0, 40, (p, ncell)).astype(np.float64)
    valid = rng.random((p, n)) < 0.9
    want = ref_chi2.subbin_counts(
        jnp.asarray(vals), jnp.asarray(lo), jnp.asarray(width),
        jnp.asarray(cell, jnp.int32), ref_chi2.num_subbins(jnp.asarray(u),
                                                           s_max),
        jnp.asarray(valid), ncell=ncell, s_max=s_max, use_pallas=False)
    t = torch.from_numpy
    got = chi2.subbin_counts(t(vals), t(lo), t(width), t(cell),
                             chi2.num_subbins(t(u), s_max), t(valid),
                             ncell=ncell, s_max=s_max)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cell_chi2_statistic_bit_identical():
    """The 2-D per-cell statistic rounds as the reference's does (its row
    sum runs in index order), so split decisions cannot tie-break apart."""
    import jax
    import jax.numpy as jnp
    from repro.core import refine as ref_refine
    from repro_torch.core import refine
    rng = np.random.default_rng(0)
    p, ncell, s_max = 2, 300, 32
    crit = _reference_table()[: s_max + 1]
    s = rng.integers(1, s_max + 1, (p, ncell))
    live = np.arange(s_max)[None, None, :] < s[:, :, None]
    hbar = np.where(live, rng.integers(0, 50, (p, ncell, s_max)), 0.0)
    h_cell = hbar.sum(axis=2)
    want = jax.jit(lambda hb, hc, ss: ref_refine._chi2_from_hbar_b(
        hb, hc, ss, s_max, jnp.asarray(crit)))(hbar, h_cell,
                                               s.astype(np.int32))
    t = torch.from_numpy
    got = refine._chi2_from_hbar_b(t(hbar), t(h_cell), t(s), s_max, t(crit))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bin_chi2_statistic_bit_identical():
    """The 1-D statistic: sub-bin edges rounded once (a fused multiply-add
    in the reference) and the row sum in index order."""
    import jax
    import jax.numpy as jnp
    from repro.core import refine as ref_refine
    from repro_torch.core import refine
    rng = np.random.default_rng(0)
    d, n, K = 3, 5000, 64
    vals = np.round(rng.gamma(2, 50, (d, n)))
    vals[rng.random((d, n)) < 0.05] = np.inf
    xs = np.sort(vals, axis=1)
    up = np.zeros((d, n + 1), np.int64)
    edges = np.full((d, K + 1), np.inf)
    k = np.zeros(d, np.int64)
    for i in range(d):
        up[i, 1:] = np.cumsum(np.r_[True, xs[i, 1:] != xs[i, :-1]])
        fin = xs[i][np.isfinite(xs[i])]
        e = np.unique(np.quantile(fin, np.linspace(0, 1, 30)).round(1))
        edges[i, : e.size] = e
        k[i] = e.size - 1
    crit = _reference_table()

    def ref_stat(x, u, e, kk):
        h, uu, _, _, lo, hi = ref_refine.bin_stats_1d(x, u, e, kk)
        return ref_refine.chi2_stat_1d(x, e, kk, h, uu, lo, hi, 128,
                                       jnp.asarray(crit))[0]

    want = np.asarray(jax.jit(jax.vmap(ref_stat))(xs, up, edges,
                                                  k.astype(np.int32)))
    t = torch.from_numpy
    h, u, _, _, lo, hi = refine.bin_stats_1d(t(xs), t(up), t(edges), t(k))
    got = refine.chi2_stat_1d(t(xs), t(edges), t(k), h, u, lo, hi, 128,
                              t(crit))[0].numpy()
    valid = np.arange(K)[None, :] < k[:, None]
    np.testing.assert_array_equal(got[valid], want[valid])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_chi2.py --write")
    CRIT_MODULE.write_text(render_crit_module(_reference_tables()))
    print(f"wrote {CRIT_MODULE}")
