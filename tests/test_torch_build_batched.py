"""The port's fixed-chunk 2-D construction vs its per-pair loop.

A re-pointed copy of ``tests/test_build_batched.py`` on the CPU
(``device="cpu"``, the kernels' plain versions): the fixed-chunk path
(``refine.refine_2d_batch`` / ``pair_metadata_batch`` driven by
``build.build_pairs_batched``) must be *bit-for-bit* equal to the per-pair
loop (``build.build_pairs_sequential``). Covers NaN-masked rows, constant
columns, the K2-capacity guard, chunk bucketing, the adaptive capacity
ladder, the device-side presort and the column prep.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.build import build_pairwise_hist
from repro_torch.core.types import BuildParams, ColumnInfo


def _table(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, 500, n).astype(float)
    c1 = np.abs(rng.normal(300, 80, n)).round()
    c2 = (c1 * 2 + rng.normal(0, 25, n)).round()   # correlated with c1
    c3 = rng.zipf(1.7, n).clip(1, 40).astype(float)
    c3[rng.random(n) < 0.05] = np.nan              # NULL-heavy column
    c4 = np.full(n, 7.0)                           # constant column
    return np.stack([c0, c1, c2, c3, c4], 1)


def _cols(d):
    return [ColumnInfo(name=f"c{i}", kind="int") for i in range(d)]


def _build(data, params, cols=None):
    return build_pairwise_hist(data, cols or _cols(data.shape[1]), params,
                               device="cpu")


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
def data():
    return _table()


@pytest.fixture(scope="module")
def seq_synopsis(data):
    params = BuildParams(n_samples=data.shape[0], k2_cap=64, s2_max=16,
                         pair_batched=False)
    return _build(data, params)


def test_batched_equals_sequential_bitforbit(data, seq_synopsis):
    params = BuildParams(n_samples=data.shape[0], k2_cap=64, s2_max=16,
                         pair_batched=True, compact_drain=False, pair_chunk=4)
    batched = _build(data, params)
    assert seq_synopsis.build_stats["mode"] == "sequential"
    assert batched.build_stats["mode"] == "batched"
    _assert_same_synopsis(seq_synopsis, batched)


def test_chunk_bucketing_invariance(data, seq_synopsis):
    """Chunk size (incl. non-pow2 -> padded dummy lanes) never changes bits."""
    for chunk in (1, 2, 3, 16):
        params = BuildParams(n_samples=data.shape[0], k2_cap=64, s2_max=16,
                             pair_batched=True, compact_drain=False,
                             pair_chunk=chunk)
        batched = _build(data, params)
        _assert_same_synopsis(seq_synopsis, batched)
        sizes = {size for size, _cap in batched.build_stats["pair_launches"]}
        assert all(size & (size - 1) == 0 for size in sizes)
        assert max(sizes) <= max(1, 1 << (chunk.bit_length() - 1))


def test_capacity_ladder_escalation(data):
    """A tiny first rung forces the guard to bind and the chunk to re-run
    one rung up; the escalated result must still match the per-pair loop run
    directly at full capacity."""
    p_seq = BuildParams(n_samples=data.shape[0], k2_cap=128, s2_max=16,
                        pair_batched=False)
    p_esc = dataclasses.replace(p_seq, pair_batched=True, compact_drain=False,
                                pair_chunk=4, k2_start=4)
    seq = _build(data, p_seq)
    esc = _build(data, p_esc)
    _assert_same_synopsis(seq, esc)
    n_chunks = -(-len(esc.pairs) // 4)
    assert len(esc.build_stats["pair_launches"]) > n_chunks  # a chunk re-ran


def test_k2_capacity_guard(data):
    """At a deliberately tiny k2_cap the guard binds in both paths; the
    batched ladder is pinned at K2 and must reproduce the capped bins."""
    p_seq = BuildParams(n_samples=data.shape[0], k2_cap=8, s2_max=16,
                        pair_batched=False)
    p_bat = dataclasses.replace(p_seq, pair_batched=True, compact_drain=False)
    seq = _build(data, p_seq)
    bat = _build(data, p_bat)
    _assert_same_synopsis(seq, bat)
    for pr in bat.pairs.values():
        assert int(pr.kx) <= 8 and int(pr.ky) <= 8


def test_all_nan_pair_column():
    """A column that is NULL on every row yields empty pair histograms
    without breaking either path."""
    rng = np.random.default_rng(0)
    n = 2000
    data = np.stack([rng.integers(0, 100, n).astype(float),
                     np.full(n, np.nan),
                     np.abs(rng.normal(50, 10, n)).round()], 1)
    p_seq = BuildParams(n_samples=n, k2_cap=32, s2_max=16,
                        pair_batched=False)
    p_bat = dataclasses.replace(p_seq, pair_batched=True, compact_drain=False)
    seq = _build(data, p_seq)
    bat = _build(data, p_bat)
    _assert_same_synopsis(seq, bat)
    assert bat.columns[1].n_null == n
    assert float(bat.pairs[(0, 1)].H.sum()) == 0.0


def test_build_does_not_mutate_caller_columns(data):
    cols = _cols(data.shape[1])
    params = BuildParams(n_samples=data.shape[0], k2_cap=32, s2_max=16,
                         compact_drain=False)
    syn = _build(data, params, cols)
    assert all(c.n_null == 0 for c in cols), \
        "build_pairwise_hist mutated the caller's ColumnInfo list"
    assert syn.columns is not cols
    assert syn.columns[3].n_null > 0          # NaN column counted on the copy
    assert all(a is not b for a, b in zip(cols, syn.columns))


def test_device_presort_matches_host_presort():
    """The device presort (one stable torch sort of the rank key per
    order) and the host's float np.lexsort produce identical layouts."""
    from repro_torch.core.build import _presort_pairs_host
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
