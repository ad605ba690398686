"""The port's convergence-compacting 2-D construction vs its per-pair loop.

A re-pointed copy of ``tests/test_build_compact.py`` on the CPU
(``device="cpu"``): the compacted path (``refine.refine_2d_compact`` driven
by ``build.build_pairs_compact`` — host drain/backfill, shared per-column
presorts, per-pair capacity rungs) must be *bit-for-bit* equal to the
per-pair loop (``build.build_pairs_sequential``) on every workload mix.
Covers correlated, independent, constant, NaN-heavy and K2-capped mixes
plus the schedule invariants (every pair drains once, deterministic
outputs, exact round ledger), the device presort against its host
oracles and the column prep.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.build import (_NO_TIMELINE, _column_ranks,
                                    _pad_edges, _pair_keys, _presort_group,
                                    _presort_pairs_host, _upload_sample,
                                    build_pairwise_hist)
from repro_torch.core.types import BuildParams, ColumnInfo
from test_torch_kernels import cuda  # noqa: F401 — the card fixture


def _cols(d):
    return [ColumnInfo(name=f"c{i}", kind="int") for i in range(d)]


def _build(data, params):
    return build_pairwise_hist(data, _cols(data.shape[1]), params,
                               device="cpu")


def _mixed_table(n=5000, seed=7):
    """Deep (correlated) + shallow (independent) + constant + NaN-heavy."""
    rng = np.random.default_rng(seed)
    base = np.abs(rng.normal(300, 80, n))
    c0 = rng.integers(0, 500, n).astype(float)       # independent
    c1 = np.round(base)                              # correlated cluster
    c2 = np.round(base * 2 + rng.normal(0, 25, n))
    c3 = rng.zipf(1.7, n).clip(1, 40).astype(float)  # heavy tail + NULLs
    c3[rng.random(n) < 0.05] = np.nan
    c4 = np.full(n, 7.0)                             # constant
    return np.stack([c0, c1, c2, c3, c4], 1)


def _independent_table(n=4000, seed=11, d=4):
    rng = np.random.default_rng(seed)
    return np.stack([np.round(np.abs(rng.normal(100 * (i + 1), 20 + 10 * i,
                                                n))) for i in range(d)], 1)


def _assert_same_synopsis(a, b):
    for h1, h2 in zip(a.hists, b.hists):
        for f, x, y in zip(h1._fields, h1, h2):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"hist field {f}")
    assert set(a.pairs) == set(b.pairs)
    for key in a.pairs:
        for f, x, y in zip(a.pairs[key]._fields, a.pairs[key], b.pairs[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"pair {key} field {f}")


@pytest.fixture(scope="module")
def mixed():
    return _mixed_table()


@pytest.fixture(scope="module")
def seq_mixed(mixed):
    params = BuildParams(n_samples=mixed.shape[0], k2_cap=64, s2_max=16,
                         pair_batched=False)
    return _build(mixed, params)


def test_compact_equals_sequential_bitforbit(mixed, seq_mixed):
    params = BuildParams(n_samples=mixed.shape[0], k2_cap=64, s2_max=16,
                         pair_batched=True, pair_chunk=4)
    compact = _build(mixed, params)
    assert compact.build_stats["mode"] == "compact"
    _assert_same_synopsis(seq_mixed, compact)


@pytest.mark.parametrize("chunk", [1, 2, 3, 8, 16])
def test_slot_count_invariance(mixed, seq_mixed, chunk):
    """Slot count (and with it queue order / drain timing) never changes
    bits — the schedule-independence core of the compaction claim; 3 is
    not a power of two (it rounds down to 2 slots) and 16 slots outnumber
    the 10 pairs. Every launch runs at most the rounded-down slot count."""
    params = BuildParams(n_samples=mixed.shape[0], k2_cap=64, s2_max=16,
                         pair_batched=True, pair_chunk=chunk)
    compact = _build(mixed, params)
    _assert_same_synopsis(seq_mixed, compact)
    slots = {n for n, _cap in compact.build_stats["pair_launches"]}
    assert max(slots) <= 1 << (chunk.bit_length() - 1)


def test_independent_columns(seq_mixed):
    data = _independent_table()
    p_seq = BuildParams(n_samples=data.shape[0], k2_cap=64, s2_max=16,
                        pair_batched=False)
    p_cmp = dataclasses.replace(p_seq, pair_batched=True, pair_chunk=4)
    _assert_same_synopsis(_build(data, p_seq), _build(data, p_cmp))


@pytest.mark.parametrize("chunk", [1, 4])
def test_k2_capacity_guard(mixed, chunk):
    """At a tiny k2_cap the guard binds; the final rung must NOT early-drain
    capped pairs (their capped result is the real one) and must reproduce
    the sequential capped bins."""
    p_seq = BuildParams(n_samples=mixed.shape[0], k2_cap=8, s2_max=16,
                        pair_batched=False)
    p_cmp = dataclasses.replace(p_seq, pair_batched=True, pair_chunk=chunk)
    seq = _build(mixed, p_seq)
    cmp_ = _build(mixed, p_cmp)
    _assert_same_synopsis(seq, cmp_)
    for pr in cmp_.pairs.values():
        assert int(pr.kx) <= 8 and int(pr.ky) <= 8


@pytest.mark.parametrize("chunk", [1, 4])
def test_capacity_ladder_escalation_per_pair(mixed, chunk):
    """A tiny first rung forces guards to bind; only the capped pairs
    re-queue one rung up (per-pair escalation) and the result still matches
    the sequential loop at full capacity."""
    p_seq = BuildParams(n_samples=mixed.shape[0], k2_cap=128, s2_max=16,
                        pair_batched=False)
    p_esc = dataclasses.replace(p_seq, pair_batched=True, pair_chunk=chunk,
                                k2_start=4)
    seq = _build(mixed, p_seq)
    esc = _build(mixed, p_esc)
    _assert_same_synopsis(seq, esc)
    comp = esc.build_stats["compaction"]
    assert comp["escalated_pairs"] > 0
    # escalation is per pair: strictly fewer pair-slots re-ran than a
    # whole-chunk re-run would have paid
    assert comp["escalated_pairs"] < len(esc.pairs)


def test_schedule_ledger_and_determinism(mixed):
    """Every pair drains exactly once (n_pairs results, round ledger exact:
    pair_rounds <= slot_rounds, both positive) and repeated builds are
    identical."""
    params = BuildParams(n_samples=mixed.shape[0], k2_cap=64, s2_max=16,
                         pair_batched=True, pair_chunk=4)
    a = _build(mixed, params)
    b = _build(mixed, params)
    _assert_same_synopsis(a, b)
    d = mixed.shape[1]
    assert len(a.pairs) == d * (d - 1) // 2
    comp = a.build_stats["compaction"]
    assert 0 < comp["pair_rounds"] <= comp["slot_rounds"]
    assert comp["loop_rounds"] > 0
    assert a.build_stats["pair_launches"]


def test_rank_presort_matches_lexsort_presort():
    """The shared-rank composite-key presort is permutation-identical to
    the two-key float lexsort (stable sorts, order-isomorphic keys)."""
    rng = np.random.default_rng(2)
    p, n = 4, 500
    x = rng.integers(0, 25, (p, n)).astype(float)    # many ties
    y = rng.integers(0, 25, (p, n)).astype(float)
    valid = rng.random((p, n)) < 0.85
    sample = np.stack([x[0], y[0], x[1], y[1]], 1)   # rank source columns
    ranks = _column_ranks(sample)
    lex = _presort_pairs_host(x[:2], y[:2], valid[:2])
    rk = _presort_pairs_host(x[:2], y[:2], valid[:2],
                             np.stack([ranks[0], ranks[2]]),
                             np.stack([ranks[1], ranks[3]]))
    for name, h, r in zip("xo1 yo1 vo1 new1 xo2 yo2 vo2 new2".split(),
                          lex, rk):
        np.testing.assert_array_equal(h, r, err_msg=name)


def test_refine_2d_compact_direct_invariants():
    """Drive refine_2d_compact directly: every pair drains exactly once
    with the same (ex, ey, kx, ky) as the single-pair refine_2d oracle,
    and the round ledger is exact (sum of per-pair rounds == pair_rounds
    <= loop_rounds * slots)."""
    from repro_torch.core import chi2 as chi2lib
    from repro_torch.core import refine

    rng = np.random.default_rng(5)
    n, n_pairs, k2 = 1500, 4, 32
    crit = torch.from_numpy(chi2lib.build_crit_table(0.001, 16))
    base = np.abs(rng.normal(100, 30, n))
    xs = np.stack([np.round(base), np.round(base),
                   np.round(rng.uniform(0, 50, n)),
                   np.round(rng.uniform(0, 9, n))])
    ys = np.stack([np.round(base * 2 + rng.normal(0, 5, n)),
                   np.round(rng.uniform(0, 200, n)),
                   np.round(rng.uniform(0, 50, n) * 3 + base),
                   np.round(rng.uniform(0, 9, n))])
    valid = np.ones((n_pairs, n), bool)
    valid[1, rng.random(n) < 0.1] = False
    pres = tuple(torch.from_numpy(a) for a in
                 _presort_pairs_host(xs, ys, valid))
    ex0 = np.stack([_pad_edges(np.array([x.min(), x.max()]), k2)
                    for x in xs])
    ey0 = np.stack([_pad_edges(np.array([y.min(), y.max()]), k2)
                    for y in ys])
    ones = torch.ones(n_pairs, dtype=torch.int64)
    m_pts = 25.0

    ledger = {"loop_rounds": 0, "pair_rounds": 0}
    oex, oey, okx, oky, _ocap, ornd = refine.refine_2d_compact(
        pres, torch.from_numpy(ex0), torch.from_numpy(ey0), ones, ones,
        m_pts, crit, n_slots=2, k2=k2, s_max=16, max_rounds=16,
        stats=ledger)
    assert len(ornd) == n_pairs and min(ornd) > 0
    assert ledger["pair_rounds"] == sum(ornd)
    assert ledger["pair_rounds"] <= ledger["loop_rounds"] * 2

    for p in range(n_pairs):
        ex, ey, kx, ky = refine.refine_2d(
            torch.from_numpy(xs[p]), torch.from_numpy(ys[p]),
            torch.from_numpy(valid[p]), torch.from_numpy(ex0[p]),
            torch.from_numpy(ey0[p]), 1, 1, m_pts, crit, k2=k2, s_max=16,
            max_rounds=16)
        np.testing.assert_array_equal(oex[p].numpy(), ex.numpy())
        np.testing.assert_array_equal(oey[p].numpy(), ey.numpy())
        assert okx[p] == kx and oky[p] == ky


@pytest.mark.parametrize("chunk", [1, 8])
def test_all_nan_pair_column(chunk):
    """A column that is NULL on every row yields empty pair histograms
    through the compacted path too."""
    rng = np.random.default_rng(0)
    n = 2000
    data = np.stack([rng.integers(0, 100, n).astype(float),
                     np.full(n, np.nan),
                     np.abs(rng.normal(50, 10, n)).round()], 1)
    p_seq = BuildParams(n_samples=n, k2_cap=32, s2_max=16,
                        pair_batched=False)
    p_cmp = dataclasses.replace(p_seq, pair_batched=True, pair_chunk=chunk)
    seq = _build(data, p_seq)
    cmp_ = _build(data, p_cmp)
    _assert_same_synopsis(seq, cmp_)
    assert cmp_.columns[1].n_null == n
    assert float(cmp_.pairs[(0, 1)].H.sum()) == 0.0


def test_build_does_not_mutate_caller_columns(mixed):
    cols = _cols(mixed.shape[1])
    params = BuildParams(n_samples=mixed.shape[0], k2_cap=32, s2_max=16)
    syn = build_pairwise_hist(mixed, cols, params, device="cpu")
    assert all(c.n_null == 0 for c in cols), \
        "build_pairwise_hist mutated the caller's ColumnInfo list"
    assert syn.columns is not cols
    assert syn.columns[3].n_null > 0          # NaN column counted on the copy
    assert all(a is not b for a, b in zip(cols, syn.columns))


def test_device_presort_matches_float_lexsort():
    """The device presort (one stable torch sort of the rank key per
    order) and the host's float np.lexsort produce identical layouts."""
    from repro_torch.core.refine import column_ranks, presort_pairs
    rng = np.random.default_rng(2)
    p, n = 3, 400
    x = rng.integers(0, 30, (p, n)).astype(float)   # many ties
    y = rng.integers(0, 30, (p, n)).astype(float)
    valid = rng.random((p, n)) < 0.9
    host = _presort_pairs_host(x, y, valid)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    dev = presort_pairs(tx, ty, torch.from_numpy(valid), column_ranks(tx),
                        column_ranks(ty))
    for name, h, d in zip("xo1 yo1 vo1 new1 xo2 yo2 vo2 new2".split(),
                          host, dev):
        assert d.dtype == torch.from_numpy(h).dtype, name
        np.testing.assert_array_equal(h, d.numpy(), err_msg=name)


def test_prep_columns_matches_per_column_reference():
    """Vectorized all-column prep == the straightforward per-column loop."""
    from repro_torch.core.build import _prep_columns
    rng = np.random.default_rng(5)
    n, d = 500, 4
    sample = rng.normal(0, 10, (n, d)).round()
    sample[rng.random((n, d)) < 0.1] = np.nan
    sample[:, 2] = 3.0                         # constant column
    xs_all, up_all, nv, vmin, vmax = _prep_columns(sample)
    for i in range(d):
        x = sample[:, i].copy()
        nan = np.isnan(x)
        x[nan] = np.inf
        xs = np.sort(x)
        n_valid = int(x.size - nan.sum())
        new = np.empty(x.size, bool)
        new[0] = True
        new[1:] = xs[1:] != xs[:-1]
        up = np.concatenate([[0], np.cumsum(new)]).astype(np.int64)
        np.testing.assert_array_equal(xs_all[i], xs)
        np.testing.assert_array_equal(up_all[i], up)
        assert nv[i] == n_valid
        if n_valid:
            assert vmin[i] == xs[0] and vmax[i] == xs[n_valid - 1]


def _presort_table(n, seed=3):
    """Columns that stress the presort: heavy ties, NaNs, -0.0 beside 0.0,
    a column that is all NaN and a constant one."""
    rng = np.random.default_rng(seed)
    ties = rng.integers(0, 6, n).astype(float)
    nans = rng.integers(0, 300, n).astype(float)
    nans[rng.random(n) < 0.2] = np.nan
    zeros = rng.choice([-1.0, -0.0, 0.0, 2.0], n)
    wide = np.round(rng.normal(0, 1e4, n))
    return np.stack([ties, nans, zeros, np.full(n, np.nan), np.full(n, 7.0),
                     wide], 1)


def _host_presort(sample, part):
    """``_presort_pairs_host`` on the pairs ``part`` with the host ranks."""
    nn = np.nan_to_num(sample, nan=0.0).T
    nan = np.isnan(sample).T
    ranks = _column_ranks(nn.T)
    x = np.zeros((len(part), nn.shape[1]))
    y = np.zeros_like(x)
    rx = np.zeros(x.shape, np.int64)
    ry = np.zeros_like(rx)
    valid = np.zeros(x.shape, bool)
    for p, (a, b) in enumerate(part):
        x[p], y[p], rx[p], ry[p] = nn[a], nn[b], ranks[a], ranks[b]
        valid[p] = ~(nan[a] | nan[b])
    return ranks, _presort_pairs_host(x, y, valid, rx, ry)


def _assert_bits_equal(got, want, name):
    got = got.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype == np.float64:   # -0.0 and 0.0 apart
        got, want = got.view(np.int64), want.view(np.int64)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _check_device_presort(sample, part, device):
    cols, nanm, ranks = _upload_sample(sample, device, _NO_TIMELINE)
    got = _presort_group(part, cols, nanm, ranks, device, _NO_TIMELINE)
    want_ranks, want = _host_presort(sample, part)
    _assert_bits_equal(ranks, want_ranks, "ranks")
    for name, g, w in zip("xo1 yo1 vo1 new1 xo2 yo2 vo2 new2".split(),
                          got, want):
        _assert_bits_equal(g, w, name)


@pytest.mark.parametrize("part", [
    _pair_keys(6),                # every pair: one compacting group
    _pair_keys(6)[:1],            # a group of one pair
    [(2, 3)],                     # -0.0 and 0.0 against an all-NaN column
])
def test_device_presort_matches_host_presort(part):
    """The build's device presort (``_upload_sample``'s column ranks,
    ``_presort_group``'s gathers and composite-key sorts) is the host
    oracle's (``_column_ranks``, ``_presort_pairs_host`` with ranks) bit
    for bit: ranks, all eight arrays and their dtypes."""
    _check_device_presort(_presort_table(3000), part, "cpu")


@pytest.mark.cuda
def test_cuda_device_presort_matches_host_presort(cuda):
    """The same on the card at the benchmark cells' group shape (32 pairs
    of 100,000 rows)."""
    sample = np.concatenate([_presort_table(100_000, seed=s)
                             for s in (4, 5)], 1)
    part = _pair_keys(sample.shape[1])[:32]
    _check_device_presort(sample, part, cuda)
