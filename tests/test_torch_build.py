"""The port's synopsis construction against the reference package.

Same input, same ``BuildParams``: the port's ``build_pairwise_hist`` (on
the CPU, through the kernels' plain versions) must produce the reference's
synopsis field by field with ``array_equal`` — edges, counts, unique
counts, extrema, centre bounds and fold maps — on the mixes of
``tests/test_build_compact.py`` and on ``CompressedTable`` input, under
each of the two pair schedulers (compacting, per pair).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import refine
from repro_torch.core.build import (_presort_pairs_host, _pad_edges,
                                    build_pairwise_hist)
from repro_torch.core.types import BuildParams, ColumnInfo


def _mixed_table(n=5000, seed=7):
    """Deep (correlated) + shallow (independent) + constant + NaN-heavy
    (``tests/test_build_compact.py``'s table)."""
    rng = np.random.default_rng(seed)
    base = np.abs(rng.normal(300, 80, n))
    c0 = rng.integers(0, 500, n).astype(float)
    c1 = np.round(base)
    c2 = np.round(base * 2 + rng.normal(0, 25, n))
    c3 = rng.zipf(1.7, n).clip(1, 40).astype(float)
    c3[rng.random(n) < 0.05] = np.nan
    c4 = np.full(n, 7.0)
    return np.stack([c0, c1, c2, c3, c4], 1)


def _ref_build(data, params_kw, cols=None, seed_edges=None):
    from repro.core.build import build_pairwise_hist as ref_build
    from repro.core.types import BuildParams as RefParams
    from repro.core.types import ColumnInfo as RefColumn
    d = data.shape[1]
    cols = cols or [RefColumn(name=f"c{i}", kind="int") for i in range(d)]
    return ref_build(data, cols, RefParams(**params_kw),
                     seed_edges=seed_edges)


def _port_build(data, params_kw, cols=None, seed_edges=None):
    d = data.shape[1]
    cols = cols or [ColumnInfo(name=f"c{i}", kind="int") for i in range(d)]
    return build_pairwise_hist(data, cols, BuildParams(**params_kw),
                               seed_edges=seed_edges, device="cpu")


def assert_same_synopsis(a, b):
    assert a.n_rows == b.n_rows and a.n_sampled == b.n_sampled
    np.testing.assert_array_equal(a.chi2_table, b.chi2_table)
    assert [c.n_null for c in a.columns] == [c.n_null for c in b.columns]
    assert len(a.hists) == len(b.hists)
    for i, (ha, hb) in enumerate(zip(a.hists, b.hists)):
        assert int(ha.k) == int(hb.k)
        for f in ha._fields:
            x, y = np.asarray(getattr(ha, f)), np.asarray(getattr(hb, f))
            assert x.dtype == y.dtype, (i, f)
            np.testing.assert_array_equal(x, y, err_msg=f"hist {i} {f}")
    assert set(a.pairs) == set(b.pairs)
    for key, pa in a.pairs.items():
        pb = b.pairs[key]
        for f in pa._fields:
            x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
            assert x.dtype == y.dtype, (key, f)
            np.testing.assert_array_equal(x, y, err_msg=f"pair {key} {f}")


@pytest.fixture(scope="module")
def mixed():
    return _mixed_table()


# The two pair schedulers, as ``BuildParams`` overrides, and the
# ``build_stats["mode"]`` each reports.
SCHEDULERS = {"compact": {}, "sequential": dict(pair_batched=False)}


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
@pytest.mark.parametrize("params_kw", [
    dict(k2_cap=64, s2_max=16, pair_chunk=4),          # test_build_compact
    dict(k2_cap=64, s2_max=16, pair_chunk=1),          # one slot
    dict(k2_cap=64, s2_max=16, pair_chunk=3),          # not a power of two
    dict(k2_cap=64, s2_max=16, pair_chunk=16),         # more slots than pairs
    dict(k2_cap=8, s2_max=16, pair_chunk=4),           # K2-capped guard
    dict(k2_cap=128, s2_max=16, pair_chunk=4, k2_start=4),  # ladder escalation
    # F1: the checked-in crit tables at the other alphas the repo uses.
    dict(k2_cap=64, s2_max=16, pair_chunk=4, alpha=0.01),
    dict(k2_cap=64, s2_max=16, pair_chunk=4, alpha=0.0001),
], ids=["compact", "one_slot", "slots_3", "slots_16", "k2_capped",
        "escalation", "alpha_0.01", "alpha_0.0001"])
def test_build_bit_identical_to_reference(mixed, params_kw, scheduler):
    params_kw = dict(params_kw, n_samples=mixed.shape[0],
                     **SCHEDULERS[scheduler])
    ref = _ref_build(mixed, params_kw)
    port = _port_build(mixed, params_kw)
    assert_same_synopsis(ref, port)
    stats = port.build_stats
    assert stats["mode"] == ref.build_stats["mode"] == scheduler
    assert stats["from_compressed"] is False
    assert stats["pair_phase_s"] > 0 and "pair_phase" in stats["phase_s"]
    if params_kw["k2_cap"] == 8:
        assert all(int(p.kx) <= 8 and int(p.ky) <= 8
                   for p in port.pairs.values())
    if params_kw.get("k2_start") == 4 and scheduler == "compact":
        comp = stats["compaction"]
        assert 0 < comp["escalated_pairs"] < len(port.pairs)


def test_sampled_build_bit_identical(small_table):
    """N_s < N: both packages draw the same row indices from the seed."""
    data = np.stack(list(small_table.values()), 1)
    kw = dict(n_samples=8000, seed=3, k2_cap=64)
    assert_same_synopsis(_ref_build(data, kw), _port_build(data, kw))


def test_compressed_input_bit_identical(small_table):
    """A CompressedTable goes through both packages' GreedyGD, sampling,
    row decode and base seeding to the same synopsis."""
    from repro.core.build import build_pairwise_hist as ref_build
    from repro.core.types import BuildParams as RefParams
    from repro.gd.greedygd import GreedyGD as RefGD
    from repro.gd.preprocess import preprocess_table as ref_preprocess
    from repro_torch.gd.greedygd import GreedyGD
    from repro_torch.gd.preprocess import preprocess_table
    pp_r = ref_preprocess(small_table)
    ct_r = RefGD().compress(pp_r.data)
    pp = preprocess_table(small_table)
    ct = GreedyGD(device="cpu").compress(pp.data)
    np.testing.assert_array_equal(ct.bases, ct_r.bases)
    np.testing.assert_array_equal(ct.base_ids, ct_r.base_ids)
    ref = ref_build(ct_r, pp_r.columns, RefParams(n_samples=10_000, seed=3))
    port = build_pairwise_hist(ct, pp.columns,
                               BuildParams(n_samples=10_000, seed=3),
                               device="cpu")
    assert_same_synopsis(ref, port)
    assert port.build_stats["from_compressed"] is True
    assert port.build_stats["rows_decoded"] == 10_000


def test_all_nan_pair_column():
    rng = np.random.default_rng(0)
    n = 2000
    data = np.stack([rng.integers(0, 100, n).astype(float),
                     np.full(n, np.nan),
                     np.abs(rng.normal(50, 10, n)).round()], 1)
    kw = dict(n_samples=n, k2_cap=32, s2_max=16)
    port = _port_build(data, kw)
    assert_same_synopsis(_ref_build(data, kw), port)
    assert float(port.pairs[(0, 1)].H.sum()) == 0.0


def test_refine_2d_compact_slot_invariance():
    """Drain/backfill order never changes a pair's result: 1, 2 and 4 slots
    give identical grids, and every pair drains exactly once."""
    rng = np.random.default_rng(5)
    n, n_pairs, k2 = 1500, 4, 32
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
    ex0 = torch.from_numpy(np.stack([
        _pad_edges(np.array([x.min(), x.max()]), k2) for x in xs]))
    ey0 = torch.from_numpy(np.stack([
        _pad_edges(np.array([y.min(), y.max()]), k2) for y in ys]))
    ones = torch.ones(n_pairs, dtype=torch.int64)
    from repro.core.chi2 import build_crit_table
    crit = torch.from_numpy(build_crit_table(0.001, 16))
    results = []
    for slots in (1, 2, 4):
        ledger = {"loop_rounds": 0, "pair_rounds": 0}
        ex, ey, kx, ky, _cap, rnd = refine.refine_2d_compact(
            pres, ex0, ey0, ones, ones, 25.0, crit, n_slots=slots, k2=k2,
            s_max=16, max_rounds=16, stats=ledger)
        assert ledger["pair_rounds"] == sum(rnd)
        assert ledger["loop_rounds"] * slots >= sum(rnd)
        results.append((ex.numpy(), ey.numpy(), kx, ky))
    for other in results[1:]:
        np.testing.assert_array_equal(results[0][0], other[0])
        np.testing.assert_array_equal(results[0][1], other[1])
        assert results[0][2:] == other[2:]


def test_default_device_needs_cuda(mixed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = [ColumnInfo(name=f"c{i}", kind="int") for i in range(5)]
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pairwise_hist(mixed, cols, BuildParams(n_samples=1000))


def test_params_conversion_keeps_every_field():
    from repro.core.types import BuildParams as RefParams
    from repro_torch.core.types import params_from_any
    ref = RefParams(n_samples=123, k2_cap=32, occupancy_min=0.5)
    assert dataclasses.asdict(params_from_any(ref)) == {
        f.name: getattr(ref, f.name)
        for f in dataclasses.fields(BuildParams)}


@pytest.mark.parametrize("name, value", [
    ("use_pallas", True), ("compact_drain", False), ("occupancy_min", 0.5),
    ("from_compressed", False), ("seed_from_bases", False)])
def test_removed_build_options_are_rejected(name, value):
    """The reference's options that select nothing in the port are not
    fields: a caller still passing one fails instead of running the
    compacting scheduler unasked."""
    with pytest.raises(TypeError, match=name):
        BuildParams(**{name: value})


def _random_table(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    base = np.abs(rng.normal(300, 80, n))
    cols = [rng.integers(0, int(rng.integers(5, 2000)), n).astype(float),
            np.round(base * rng.uniform(0.5, 3)),
            np.round(base * 2 + rng.normal(0, rng.uniform(1, 60), n)),
            rng.zipf(1.5 + rng.random(), n).clip(1, 60).astype(float),
            np.round(rng.gamma(2.0, 100.0, n))]
    cols[3][rng.random(n) < 0.05] = np.nan
    return np.stack(cols, 1)


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
@pytest.mark.parametrize("seed", [1, 3, 4, 6, 8, 10])
def test_random_tables_bit_identical(seed, scheduler):
    """Random mixes whose weighted-centre bounds and sub-bin edges depend
    on the reference's fused multiply-adds (seeds that differed in the last
    bit before ``refine._fma``), under each scheduler."""
    data = _random_table(seed)
    kw = dict(n_samples=2500, seed=seed, k2_cap=64, s2_max=16, pair_chunk=4,
              **SCHEDULERS[scheduler])
    port = _port_build(data, kw)
    assert_same_synopsis(_ref_build(data, kw), port)
    assert port.build_stats["mode"] == scheduler
