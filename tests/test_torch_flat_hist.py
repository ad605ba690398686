"""The pair-batched histogram kernel (K3 ``batched_hist2d``, K4
``batched_subbin_hist``, one CUDA source ``csrc/flat_hist.cu``).

On the CPU: a NumPy model of the kernel's adds (strips, first runs joining
the previous lane's last run, the segmented shuffle) that must reproduce
the histogram exactly and add about once a run on sorted rows; the
launcher's checks; and the port's plain versions against the reference's
Pallas kernels (interpret mode) and its plain oracles on rows sorted into
long runs, the layout the construction's presorted pairs give. The tests
marked ``cuda`` hold the kernel to its plain version on the card (exact for
0/1 weights, rtol 1e-5 atol 1e-6 for fp32 ones, whose atomics add in no
fixed order) and skip without one; they import nothing of the JAX package,
so ``python -m pytest -m cuda tests/test_torch_flat_hist.py`` runs where JAX
is absent.
"""
import numpy as np
import pytest
import torch
from test_torch_kernels import cuda  # noqa: F401 — the card fixture

from repro_torch.kernels import flat_hist as fh
from repro_torch.kernels import launch_counts
from repro_torch.kernels.hist2d import batched_hist2d
from repro_torch.kernels.hist2d.ref import batched_hist2d_ref
from repro_torch.kernels.subbin import batched_subbin_hist
from repro_torch.kernels.subbin.ref import batched_subbin_hist_ref

S_MAX = 32
TILE, STRIP = 1024, 4          # the kernel's kTile and kStrip


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bins(kind, k2):
    return (k2, k2) if kind == "k3" else (k2 * k2, S_MAX)


# ------------------------------------------------- the kernel's adds, modelled


def _model_adds(flat, w):
    """The (id, sum) adds the kernel issues for one pair's rows, in NumPy:
    tiles of TILE rows, warps of 32 lanes, STRIP rows a lane."""
    adds = []
    for t0 in range(0, len(flat), TILE):
        ids, ws = flat[t0:t0 + TILE], w[t0:t0 + TILE]
        for w0 in range(0, TILE, 32 * STRIP):
            lanes = []                       # (first, last) runs of a lane
            for lane in range(32):
                runs = []
                lo = w0 + lane * STRIP
                for i in range(lo, min(lo + STRIP, len(ids))):
                    if ws[i] == 0:
                        continue
                    if runs and runs[-1][0] == ids[i]:
                        runs[-1][1] += ws[i]
                    else:
                        runs.append([int(ids[i]), ws[i]])
                first = runs[0] if len(runs) > 1 else None
                adds += [tuple(r) for r in runs[1:-1]]
                lanes.append([first, runs[-1] if runs else None])
            for lane in range(32):           # first runs join lane - 1
                first = lanes[lane][0]
                prev = lanes[lane - 1][1] if lane else None
                if first is None:
                    continue
                if prev is not None and prev[0] == first[0]:
                    prev[1] += first[1]
                else:
                    adds.append(tuple(first))
            lane = 0                         # segments of equal last runs
            while lane < 32:
                end = lane
                while end + 1 < 32 and lanes[end + 1][1] is not None and \
                        lanes[lane][1] is not None and \
                        lanes[end + 1][1][0] == lanes[lane][1][0]:
                    end += 1
                if lanes[lane][1] is not None:
                    adds.append((lanes[lane][1][0],
                                 sum(lanes[j][1][1]
                                     for j in range(lane, end + 1))))
                lane = end + 1
    return adds


@pytest.mark.parametrize("layout", ["sorted", "uniform", "one_bin", "zeros"])
@pytest.mark.parametrize("n", [1, 37, 1024, 3001])
def test_model_of_the_adds_is_exact(layout, n):
    """Every row's weight lands once: the modelled adds sum to the
    histogram, and on sorted rows there is about one add a run."""
    rng = np.random.default_rng(n + len(layout))
    nb = 500
    if layout == "uniform":
        flat = rng.integers(0, nb, n)
    elif layout == "one_bin":
        flat = np.full(n, 7)
    else:
        flat = np.sort(rng.integers(0, nb // 10, n))
    w = (rng.random(n) < 0.8).astype(np.float64)
    if layout == "zeros":
        w[:] = 0
    adds = _model_adds(flat, w)
    got = np.zeros(nb)
    for i, v in adds:
        got[i] += v
    want = np.zeros(nb)
    np.add.at(want, flat, w)
    np.testing.assert_array_equal(got, want)
    if layout in ("sorted", "one_bin", "zeros"):
        nz = flat[w != 0]
        runs = int(nz.size and 1 + (nz[1:] != nz[:-1]).sum())
        warps = -(-n // (32 * STRIP))
        assert len(adds) <= runs + 2 * warps
        assert len(adds) >= (runs > 0)


def test_model_adds_once_a_warp_for_one_long_run():
    flat = np.full(4 * TILE, 3)
    adds = _model_adds(flat, np.ones(4 * TILE))
    assert len(adds) == 4 * TILE // (32 * STRIP)
    assert sum(v for _, v in adds) == 4 * TILE


# ------------------------------------------------------------ the launcher


@pytest.mark.parametrize("bad", ["shape", "rank", "float_ids", "bool_ids",
                                 "strided", "empty_hist", "too_many_bins"])
def test_launcher_rejects_bad_inputs(bad):
    """The checks run before anything touches a device."""
    a = torch.zeros((2, 10), dtype=torch.int64)
    b = torch.zeros((2, 10), dtype=torch.int64)
    w = torch.ones((2, 10), dtype=torch.float64)
    ka, kb = 4, 4
    if bad == "shape":
        b = b[:, :5]
    elif bad == "rank":
        a, b, w = a[0], b[0], w[0]
    elif bad == "float_ids":
        a = a.double()
    elif bad == "bool_ids":
        b = b.bool()
    elif bad == "strided":
        w = torch.ones((10, 2), dtype=torch.float64).t()
    elif bad == "empty_hist":
        ka = 0
    else:
        ka, kb = 1 << 16, 1 << 15
    with pytest.raises(ValueError, match="flat_hist"):
        fh.flat_hist_cuda(a, b, w, ka, kb, {"k": 0}, "k")


def test_aligned_copies_only_a_misaligned_view():
    t = torch.arange(64, dtype=torch.int64)
    assert t.data_ptr() % 16 == 0 and fh._aligned(t) is t
    view = t[1:33]
    assert view.data_ptr() % 16 != 0
    copy = fh._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


# --------------------------------------------- chip_smoke.py's K3/K4 inputs


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_capture_main_hist_inputs_restores_the_callers():
    """The recorder takes the first K3 and K4 launch of an ingest (here a
    small one on the CPU), clones them and puts the callers' names back."""
    import repro_torch.core.chi2 as chi2
    import repro_torch.core.refine as refine
    from repro_torch.aqp import datasets
    from repro_torch.core.types import BuildParams
    smoke = _chip_smoke()
    before = (refine.batched_hist2d, chi2.batched_subbin_hist)
    got = smoke.capture_main_hist_inputs(
        "cpu", datasets.flights(n=6000), BuildParams(n_samples=3000))
    assert (refine.batched_hist2d, chi2.batched_subbin_hist) == before
    a, b, w, ka, kb = got["batched_hist2d"]
    k2 = ka
    assert kb == k2 and a.shape == b.shape == w.shape and a.shape[1] == 3000
    assert w.dtype == torch.float64 and bool(((w == 0) | (w == 1)).all())
    a, b, w, ka, kb = got["batched_subbin_hist"]
    assert (ka, kb) == (k2 * k2, S_MAX) and w.dtype == torch.float64


@pytest.mark.parametrize("kind", ["batched_hist2d", "batched_subbin_hist"])
def test_chip_smoke_sorted_inputs(kind):
    """Sorted cases: every pair sorted by flat id with a heavy bin; fp32
    weights multiples of 1/256 (exact sums in any order)."""
    smoke = _chip_smoke()
    a, b, w, ka, kb = smoke.hist_inputs(kind, 64, "f32", "sorted",
                                        np.random.default_rng(0),
                                        device="cpu")
    flat = a * kb + b
    assert bool((flat[:, 1:] >= flat[:, :-1]).all())
    assert int(torch.bincount(flat[0]).max()) >= flat.shape[1] // 5
    assert w.dtype == torch.float32 and bool(((w * 256) % 1 == 0).all())


# --------------------------------------------- plain versions vs reference


def _sorted_runs(rng, p, n, ka, kb, heavy=0.3):
    """(P, N) ids sorted by flat id: a heavy bin and Zipf-distributed runs,
    plus a few out-of-range ids at both ends."""
    nb = ka * kb
    flat = (np.minimum(rng.zipf(1.4, (p, n)), nb) - 1) * 31 % nb
    flat = np.where(rng.random((p, n)) < heavy, rng.integers(0, nb, (p, 1)),
                    flat)
    flat.sort(axis=1)
    a, b = flat // kb, flat % kb
    a[:, :3] = -2
    b[:, -3:] = kb + 5
    return a, b


@pytest.mark.parametrize("p,n,ki,kj", [
    (1, 1000, 8, 8), (3, 2500, 37, 53), (2, 4096, 64, 64), (4, 1500, 128, 16),
])
def test_plain_hist2d_matches_reference_on_sorted_runs(p, n, ki, kj):
    """fp32 weights: the port's plain version against the reference's
    Pallas kernel (interpret mode) and its jnp oracle, rtol 1e-5."""
    from repro.kernels.hist2d import batched_hist2d as jax_hist2d
    from repro.kernels.hist2d.ref import batched_hist2d_ref as jax_ref
    rng = np.random.default_rng(p * n + ki)
    bi, bj = _sorted_runs(rng, p, n, ki, kj)
    bi, bj = bi.astype(np.int32), bj.astype(np.int32)
    w = rng.random((p, n)).astype(np.float32)
    out = batched_hist2d(_t(bi), _t(bj), _t(w), ki, kj)
    assert out.shape == (p, ki, kj) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_ref(bi, bj, w, ki, kj)),
                               rtol=1e-5, atol=1e-5)
    # The Pallas kernel's contract: out-of-range rows carry weight 0.
    w_in = np.where((bi >= 0) & (bi < ki) & (bj >= 0) & (bj < kj), w, 0)
    np.testing.assert_allclose(
        batched_hist2d(_t(bi), _t(bj), _t(w_in), ki, kj).numpy(),
        np.asarray(jax_hist2d(bi, bj, w_in, ki, kj, use_pallas=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p,n,ncell,s_max", [
    (1, 1000, 9, 8), (3, 2500, 64, 16), (2, 4096, 256, 32), (4, 1500, 100, 5),
])
def test_plain_subbin_matches_reference_on_sorted_runs(p, n, ncell, s_max):
    from repro.kernels.subbin import batched_subbin_hist as jax_subbin
    from repro.kernels.subbin.ref import batched_subbin_hist_ref as jax_ref
    rng = np.random.default_rng(p * n + ncell)
    cell, sub = _sorted_runs(rng, p, n, ncell, s_max)
    cell, sub = cell.astype(np.int32), sub.astype(np.int32)
    w = rng.random((p, n)).astype(np.float32)
    out = batched_subbin_hist(_t(cell), _t(sub), _t(w), ncell, s_max)
    assert out.shape == (p, ncell, s_max)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_ref(cell, sub, w, ncell,
                                                  s_max)),
                               rtol=1e-5, atol=1e-5)
    w_in = np.where((cell >= 0) & (cell < ncell) & (sub >= 0)
                    & (sub < s_max), w, 0)
    np.testing.assert_allclose(
        batched_subbin_hist(_t(cell), _t(sub), _t(w_in), ncell,
                            s_max).numpy(),
        np.asarray(jax_subbin(cell, sub, w_in, ncell, s_max,
                              use_pallas=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["k3", "k4"])
@pytest.mark.parametrize("heavy", [0.0, 0.5, 1.0])
def test_plain_integer_counts_exact_on_sorted_runs(kind, heavy):
    """f64 0/1 weights on run-heavy rows (``heavy`` 1.0: one bin a pair):
    exact f64 counts, bit for bit the reference's f64 oracle."""
    import repro.core  # noqa: F401  (enables jax x64 for the f64 oracle)
    from repro.kernels.hist2d import batched_hist2d as jax_hist2d
    from repro.kernels.subbin import batched_subbin_hist as jax_subbin
    rng = np.random.default_rng(int(heavy * 10) + len(kind))
    p, n = 3, 5000
    ka, kb = (24, 24) if kind == "k3" else (64, 16)
    a, b = _sorted_runs(rng, p, n, ka, kb, heavy=heavy)
    w = (rng.random((p, n)) < 0.9).astype(np.float64)
    if kind == "k3":
        out = batched_hist2d(_t(a), _t(b), _t(w), ka, kb).numpy()
        want = np.asarray(jax_hist2d(a, b, w, ka, kb, use_pallas=False))
    else:
        out = batched_subbin_hist(_t(a), _t(b), _t(w), ka, kb).numpy()
        want = np.asarray(jax_subbin(a, b, w, ka, kb, use_pallas=False))
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out.sum(axis=(1, 2)), w.sum(axis=1))


# ----------------------------------------------------------------- on card


def _layout(layout, rng, p, n, ka, kb):
    """(P, N) int64 ids of a test layout."""
    nb = ka * kb
    if layout == "one_bin":
        flat = np.full((p, n), rng.integers(0, nb))
    elif layout == "unsorted":
        flat = rng.integers(0, nb, (p, n))
    else:
        # Runs whose lengths straddle a strip (4 rows), a warp (128), a
        # tile (1024) and any block's or cluster's chunk, sorted by id.
        lengths = rng.choice([1, 3, 4, 5, 127, 129, 1023, 1025, 4099],
                             size=n)
        m = int(np.searchsorted(np.cumsum(lengths), n)) + 1
        ids = np.repeat(np.sort(rng.integers(0, nb, m)), lengths[:m])[:n]
        flat = np.stack([np.sort(np.roll(ids, 17 * i)) for i in range(p)])
    a, b = flat // kb, flat % kb
    if layout == "out_of_range":
        a = rng.integers(-3, ka + 3, (p, n))
        b = rng.integers(-3, kb + 3, (p, n))
    return _t(a.astype(np.int64)), _t(b.astype(np.int64))


def _check(kind, a, b, w, ka, kb):
    fn, ref = (batched_hist2d, batched_hist2d_ref) if kind == "k3" else \
        (batched_subbin_hist, batched_subbin_hist_ref)
    key = "batched_hist2d" if kind == "k3" else "batched_subbin_hist"
    before = launch_counts()[key]
    got = fn(a, b, w, ka, kb)
    torch.cuda.synchronize()
    assert launch_counts()[key] == before + 1
    want = ref(a, b, w, ka, kb)
    assert got.dtype == w.dtype and got.shape == want.shape
    if w.dtype == torch.float64 and bool(((w == 0) | (w == 1)).all()):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["k3", "k4"])
@pytest.mark.parametrize("k2", [64, 128, 256])
@pytest.mark.parametrize("layout", ["one_bin", "runs", "unsorted",
                                    "out_of_range"])
def test_cuda_flat_hist_matches_plain(cuda, kind, k2, layout):
    """8 pairs x 100,003 rows (not a multiple of the tile), f64 0/1 and
    fp32 weights, every layout, at every rung of the capacity ladder."""
    rng = np.random.default_rng(k2 + len(layout) + len(kind))
    p, n = 8, 100_003
    ka, kb = _bins(kind, k2)
    a, b = (x.to(cuda) for x in _layout(layout, rng, p, n, ka, kb))
    w01 = _t((rng.random((p, n)) < 0.9).astype(np.float64)).to(cuda)
    _check(kind, a, b, w01, ka, kb)
    _check(kind, a, b, _f32_weights(rng, layout, p, n).to(cuda), ka, kb)


def _f32_weights(rng, layout, p, n):
    """fp32 weights in [0, 1): uniform draws where bins hold few rows; where
    a bin sums thousands of rows ("one_bin", "runs"), multiples of 1/256,
    whose fp32 sums are exact in any order (the plain version's own
    atomics-order rounding on 100,000 rows in one bin exceeds rtol 1e-5)."""
    if layout in ("one_bin", "runs"):
        return _t((rng.integers(0, 256, (p, n)) / 256).astype(np.float32))
    return _t(rng.random((p, n)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
def test_cuda_flat_hist_few_pairs(cuda, p):
    """1 to 8 pairs (late rounds drain the slots), far fewer blocks than
    the card holds."""
    rng = np.random.default_rng(p)
    for kind, k2 in (("k3", 64), ("k4", 64), ("k3", 256)):
        ka, kb = _bins(kind, k2)
        a, b = (x.to(cuda) for x in _layout("runs", rng, p, 50_001, ka, kb))
        w = _t((rng.random((p, 50_001)) < 0.8).astype(np.float64)).to(cuda)
        _check(kind, a, b, w, ka, kb)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 30_011])
def test_cuda_flat_hist_tile_edges(cuda, n):
    """Row counts around the tile (pairs then start at rows that are not a
    16-byte multiple), runs crossing every boundary, out-of-range ids at
    both ends, f64 0/1, fp32 and all-zero weights."""
    rng = np.random.default_rng(n)
    p = 3
    for kind, k2 in (("k3", 64), ("k4", 16)):
        ka, kb = _bins(kind, k2)
        a, b = (x.to(cuda) for x in _layout("runs", rng, p, n, ka, kb))
        a[:, :5] = -7
        b[:, -5:] = kb + 9
        for w in (_t((rng.random((p, n)) < 0.7).astype(np.float64)),
                  _f32_weights(rng, "runs", p, n),
                  torch.zeros((p, n), dtype=torch.float64)):
            _check(kind, a, b, w.to(cuda), ka, kb)


@pytest.mark.cuda
def test_cuda_flat_hist_edge_inputs(cuda):
    """An unaligned view (copied to 16-byte alignment), int32 ids, fp16
    weights (counted in fp32, returned in fp16), no rows (zeros, no
    launch)."""
    rng = np.random.default_rng(5)
    p, n, ka, kb = 4, 20_000, 64, 64
    a, b = (x.to(cuda) for x in _layout("runs", rng, p, n + 1, ka, kb))
    w = _t((rng.random((p, n + 1)) < 0.9).astype(np.float64)).to(cuda)
    flat_a, flat_b, flat_w = a.reshape(-1), b.reshape(-1), w.reshape(-1)
    view = [x[1:1 + p * n].view(p, n) for x in (flat_a, flat_b, flat_w)]
    assert view[0].data_ptr() % 16 != 0
    _check("k3", *view, ka, kb)
    _check("k4", a.to(torch.int32), b.to(torch.int32),
           w.to(torch.float32), ka, kb)
    got = batched_hist2d(a, b, w.half(), ka, kb)
    assert got.dtype == torch.float16
    assert torch.equal(got, batched_hist2d_ref(a, b, w.float(), ka,
                                               kb).half())
    before = launch_counts()["batched_hist2d"]
    out = batched_hist2d(a[:, :0], b[:, :0], w[:, :0], ka, kb)
    assert out.shape == (p, ka, kb) and not out.any()
    assert launch_counts()["batched_hist2d"] == before


@pytest.mark.cuda
def test_cuda_flat_hist_refused_launch_raises(cuda):
    """The C entry point refuses what it cannot stage (a pointer that is not
    16-byte aligned) and the status raises; nothing falls back to the plain
    version."""
    from repro_torch.kernels import loader
    p, n, ka, kb = 2, 5000, 64, 64
    a = torch.zeros((p, n + 1), dtype=torch.int64, device=cuda)
    w = torch.ones((p, n), dtype=torch.float64, device=cuda)
    out = torch.zeros((p, ka * kb), dtype=torch.float64, device=cuda)
    status = fh._entry()(a.data_ptr() + 8, a.data_ptr(), w.data_ptr(),
                         out.data_ptr(), p, n, ka, kb, 1,
                         torch.cuda.current_stream().cuda_stream)
    assert status != 0
    with pytest.raises(RuntimeError, match="flat_hist_launch"):
        loader.check(status, "flat_hist_launch")
