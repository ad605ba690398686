"""The port's kernel packages against the reference package's oracles.

The plain PyTorch versions (what a CPU tensor runs) are held to the JAX
package's plain references on the same numpy inputs, at the tolerances of
``tests/test_kernels.py``: exact for integer counts, rtol 1e-5 for fp32
sums. The tests marked ``cuda`` hold each hand-written CUDA kernel to its
plain version on the card and skip without one; they import nothing of the
JAX package, so ``python -m pytest -m cuda tests/test_torch_kernels.py``
runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.hist2d import batched_hist2d, hist2d
from repro_torch.kernels.hist2d import ops as hist2d_ops
from repro_torch.kernels.hist2d.ref import batched_hist2d_ref, hist2d_ref
from repro_torch.kernels.subbin import batched_subbin_hist
from repro_torch.kernels.subbin.ref import batched_subbin_hist_ref
from repro_torch.kernels.weightings import (batched_weightings,
                                            fused_weightings, q_bucket)
from repro_torch.kernels.weightings.ref import (batched_weightings_ref,
                                                fused_weightings_ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weightings_inputs(rng, el, k2, k1, q=None):
    H = (rng.random((el, k2, k2)) * 10).astype(np.float32)
    hx = H.sum(2) + 1.0
    fold = np.zeros((el, k1, k2), np.float32)
    idx = np.sort(rng.integers(0, k2, k1))   # 1-D bin -> containing row
    for li in range(el):
        fold[li, np.arange(k1), idx] = 1
    shape = (el, k2) if q is None else (q, el, k2)
    beta = rng.random(shape).astype(np.float32)
    return H, beta, fold, hx


# ----------------------------------------------------------- hist2d (K3)


@pytest.mark.parametrize("p,n,ki,kj", [
    (1, 100, 8, 8), (3, 500, 37, 53), (2, 2048, 128, 256), (4, 1000, 300, 17),
])
def test_batched_hist2d_matches_reference(p, n, ki, kj):
    from repro.kernels.hist2d.ref import batched_hist2d_ref as jax_ref
    rng = np.random.default_rng(p * n + ki)
    bi = rng.integers(0, ki, (p, n)).astype(np.int32)
    bj = rng.integers(0, kj, (p, n)).astype(np.int32)
    w = rng.random((p, n)).astype(np.float32)
    out = batched_hist2d(_t(bi), _t(bj), _t(w), ki, kj)
    want = np.asarray(jax_ref(bi, bj, w, ki, kj))
    assert out.shape == (p, ki, kj) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_batched_hist2d_integer_counts_exact():
    """Construction's f64 0/1 weights give exact f64 counts, equal to the
    reference's dtype-preserving oracle bit for bit."""
    import repro.core  # noqa: F401  (enables jax x64 for the f64 oracle)
    from repro.kernels.hist2d import batched_hist2d as jax_hist2d
    rng = np.random.default_rng(1)
    p, n, k = 3, 4000, 24
    bi = rng.integers(0, k, (p, n)).astype(np.int64)
    bj = rng.integers(0, k, (p, n)).astype(np.int64)
    w = (rng.random((p, n)) < 0.9).astype(np.float64)
    out = batched_hist2d(_t(bi), _t(bj), _t(w), k, k)
    want = np.asarray(jax_hist2d(bi, bj, w, k, k, use_pallas=False))
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), want)
    assert float(out.sum()) == float(w.sum())


def test_batched_hist2d_clips_indices():
    bi = torch.tensor([[-3, 0, 9]])
    bj = torch.tensor([[0, 7, 2]])
    w = torch.ones((1, 3), dtype=torch.float64)
    out = batched_hist2d(bi, bj, w, 4, 3)
    assert out[0, 0, 0] == 1 and out[0, 0, 2] == 1 and out[0, 3, 2] == 1
    assert float(out.sum()) == 3.0


# ----------------------------------------------------------- subbin (K4)


@pytest.mark.parametrize("p,n,ncell,s_max", [
    (1, 100, 9, 8), (3, 500, 64, 16), (2, 2048, 256, 32), (4, 1000, 100, 5),
])
def test_batched_subbin_hist_matches_reference(p, n, ncell, s_max):
    from repro.kernels.subbin.ref import batched_subbin_hist_ref as jax_ref
    rng = np.random.default_rng(p * n + ncell)
    cell = rng.integers(0, ncell, (p, n)).astype(np.int32)
    sub = rng.integers(0, s_max, (p, n)).astype(np.int32)
    w = rng.random((p, n)).astype(np.float32)
    out = batched_subbin_hist(_t(cell), _t(sub), _t(w), ncell, s_max)
    want = np.asarray(jax_ref(cell, sub, w, ncell, s_max))
    assert out.shape == (p, ncell, s_max)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_batched_subbin_hist_integer_counts_exact():
    """f64 validity weights: exact counts equal to the reference's oracle;
    the last-axis sum reproduces the per-cell totals."""
    import repro.core  # noqa: F401
    from repro.kernels.subbin import batched_subbin_hist as jax_subbin
    rng = np.random.default_rng(1)
    p, n, ncell, s_max = 3, 4000, 64, 16
    cell = rng.integers(0, ncell, (p, n)).astype(np.int64)
    sub = rng.integers(0, s_max, (p, n)).astype(np.int64)
    w = (rng.random((p, n)) < 0.9).astype(np.float64)
    out = batched_subbin_hist(_t(cell), _t(sub), _t(w), ncell, s_max).numpy()
    want = np.asarray(jax_subbin(cell, sub, w, ncell, s_max,
                                 use_pallas=False))
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, want)
    totals = np.zeros((p, ncell))
    for pi in range(p):
        np.add.at(totals[pi], cell[pi], w[pi])
    np.testing.assert_array_equal(out.sum(axis=2), totals)


# ------------------------------------------------------- weightings (K1, K2)


@pytest.mark.parametrize("el,k2,k1", [
    (1, 16, 16), (3, 64, 80), (5, 200, 260), (2, 128, 128), (4, 384, 400),
])
def test_fused_weightings_matches_reference(el, k2, k1):
    from repro.kernels.weightings.ref import fused_weightings_ref as jax_ref
    H, beta, fold, hx = _weightings_inputs(np.random.default_rng(el * k2),
                                           el, k2, k1)
    out = fused_weightings(_t(H), beta, _t(fold), _t(hx))
    want = np.asarray(jax_ref(H, beta, fold, hx))
    assert out.shape == (k1,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q,el,k2,k1", [
    (1, 1, 16, 16), (5, 3, 70, 90), (17, 2, 200, 260), (64, 4, 128, 128),
])
def test_batched_weightings_matches_per_query(q, el, k2, k1):
    """Query-batched weightings == the reference's per-query oracle."""
    from repro.kernels.weightings.ref import fused_weightings_ref as jax_ref
    H, beta, fold, hx = _weightings_inputs(
        np.random.default_rng(q * k2 + el), el, k2, k1, q=q)
    seq = np.stack([np.asarray(jax_ref(H, beta[qi], fold, hx))
                    for qi in range(q)])
    out = batched_weightings(_t(H), beta, _t(fold), _t(hx))
    assert out.shape == (q, k1)
    np.testing.assert_allclose(out.numpy(), seq, rtol=1e-5, atol=1e-6)


def test_batched_weightings_ref_reduces_to_single():
    """Q=1 batched plain version == single-query plain version."""
    H, beta, fold, hx = _weightings_inputs(np.random.default_rng(11),
                                           2, 32, 40, q=1)
    one = batched_weightings_ref(_t(H), _t(beta), _t(fold), _t(hx))
    single = fused_weightings_ref(_t(H), _t(beta[0]), _t(fold), _t(hx))
    np.testing.assert_allclose(one[0].numpy(), single.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_fused_weightings_identity_predicate():
    """A beta of all-ones gives probability 1 in every bin."""
    rng = np.random.default_rng(7)
    k2, k1 = 32, 32
    H = rng.integers(0, 5, (1, k2, k2)).astype(np.float32)
    hx = H.sum(2)
    fold = np.zeros((1, k1, k2), np.float32)
    fold[0, np.arange(k1), np.arange(k2)] = 1
    beta = np.ones((1, k2), np.float32)
    out = fused_weightings(_t(H), beta, _t(fold), _t(hx)).numpy()
    mask = hx[0] > 0
    np.testing.assert_allclose(out[mask], 1.0, rtol=1e-6)


def test_q_bucket_matches_reference():
    from repro.kernels.weightings.ops import q_bucket as jax_q_bucket
    for q in (1, 7, 8, 9, 64, 65, 1000):
        assert q_bucket(q) == jax_q_bucket(q)


def test_cpu_tensors_never_launch():
    """CPU tensors run the plain versions and leave the counters alone."""
    reset_launch_counts()
    H, beta, fold, hx = _weightings_inputs(np.random.default_rng(3),
                                           1, 8, 8, q=2)
    batched_weightings(_t(H), beta, _t(fold), _t(hx))
    fused_weightings(_t(H), beta[0], _t(fold), _t(hx))
    idx = torch.zeros((1, 5), dtype=torch.int64)
    w = torch.ones((1, 5), dtype=torch.float64)
    batched_hist2d(idx, idx, w, 2, 2)
    batched_subbin_hist(idx, idx, w, 2, 2)
    hist2d(idx[0], idx[0], w[0], 2, 2)
    assert launch_counts() == {"batched_weightings": 0, "fused_weightings": 0,
                               "batched_hist2d": 0, "hist2d": 0,
                               "batched_subbin_hist": 0}


# ------------------------------------------- CUDA kernels vs plain versions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128, 256])
def test_cuda_hist2d_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    p, n = 8, 100_000
    bi = _t(rng.integers(-2, k + 2, (p, n))).to(cuda)
    bj = _t(rng.integers(-2, k + 2, (p, n))).to(cuda)
    w01 = _t((rng.random((p, n)) < 0.9).astype(np.float64)).to(cuda)
    before = launch_counts()["batched_hist2d"]
    got = batched_hist2d(bi, bj, w01, k, k)
    torch.cuda.synchronize()
    assert launch_counts()["batched_hist2d"] == before + 1
    assert torch.equal(got, batched_hist2d_ref(bi, bj, w01, k, k))
    wf = _t(rng.random((p, n)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(batched_hist2d(bi, bj, wf, k, k),
                               batched_hist2d_ref(bi, bj, wf, k, k),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,ki,kj", [
    (100_000, 256, 256), (64_000, 96, 64), (1024, 512, 512), (4099, 37, 53),
    (2_048 * 5 + 3, 2_048, 256), (1, 256, 256),
    (hist2d_ops.DIRECT_ROWS + 5, 256, 256),
    (hist2d_ops.DIRECT_ROWS + 5, 37, 53),
])
def test_cuda_single_hist2d_matches_plain(cuda, n, ki, kj):
    """K5 through its public entry: exact for 0/1 weights, rtol 1e-5 for
    fp32 ones (atomics add in no fixed order); out-of-range rows clip; a
    view 4 bytes off is read in quads from the 16-byte boundary above it,
    its first rows as edges; no rows, no launch. Up to ``DIRECT_ROWS`` rows
    the plan is the slab-free path, beyond it a slab plan (the last two
    shapes); ``test_cuda_slab_plans_match_plain`` forces slab plans at the
    smaller shapes."""
    rng = np.random.default_rng(n + ki)
    bi = _t(rng.integers(-2, ki + 2, n).astype(np.int32)).to(cuda)
    bj = _t(rng.integers(-2, kj + 2, n).astype(np.int32)).to(cuda)
    w01 = _t((rng.random(n) < 0.9).astype(np.float32)).to(cuda)
    before = launch_counts()["hist2d"]
    got = hist2d(bi, bj, w01, ki, kj)
    torch.cuda.synchronize()
    assert launch_counts()["hist2d"] == before + 1
    assert torch.equal(got, hist2d_ref(bi, bj, w01, ki, kj))
    assert torch.equal(hist2d(bi[1:], bj[1:], w01[1:], ki, kj),
                       hist2d_ref(bi[1:], bj[1:], w01[1:], ki, kj))
    wf = _t(rng.random(n).astype(np.float32)).to(cuda)
    torch.testing.assert_close(hist2d(bi, bj, wf, ki, kj),
                               hist2d_ref(bi, bj, wf, ki, kj),
                               rtol=1e-5, atol=1e-6)
    before = launch_counts()["hist2d"]
    assert not hist2d(bi[:0], bj[:0], wf[:0], ki, kj).any()
    assert launch_counts()["hist2d"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,ki,kj", [(4099, 37, 53),
                                     (2_048 * 5 + 3, 2_048, 256),
                                     (100_000, 256, 256)])
@pytest.mark.parametrize("cy", [1, 2])
def test_cuda_slab_plans_match_plain(cuda, n, ki, kj, cy):
    """K5's slab path forced below ``DIRECT_ROWS`` (``ops._launch`` with
    ``ops._slab_plan``'s slabs): several slabs, more than 8 at 2,048 x 256,
    whose first bins are off a 16-byte boundary at KJ = 53 (the scalar
    reduction); one cluster and three clusters of cy chunks adding into the
    zeroed output; aligned views, views 4 bytes off (edge rows) and arrays
    whose offsets differ (rows one by one). Exact for 0/1 weights, rtol
    1e-5 for fp32 ones."""
    rng = np.random.default_rng(n + cy)
    bi = _t(rng.integers(-2, ki + 2, n + 3).astype(np.int32)).to(cuda)
    bj = _t(rng.integers(-2, kj + 2, n + 3).astype(np.int32)).to(cuda)
    w01 = _t((rng.random(n + 3) < 0.9).astype(np.float32)).to(cuda)
    wf = _t(rng.random(n + 3).astype(np.float32)).to(cuda)
    base = hist2d_ops._slab_plan(
        n, ki, kj, hist2d_ops._device(torch.cuda.current_device()))
    if ki == 2_048:
        assert base.n_slabs > 8
    views = [(slice(0, n),) * 3, (slice(1, n + 1),) * 3,
             (slice(1, n + 1), slice(0, n), slice(3, n + 3))]
    for clusters in (1, 3):
        plan = base._replace(n_chunks=clusters * cy, cy=cy)
        for va, vb, vw in views:
            a, b, c = bi[va], bj[vb], w01[vw]
            before = launch_counts()["hist2d"]
            got = hist2d_ops._launch(a, b, c, ki, kj, plan)
            torch.cuda.synchronize()
            assert launch_counts()["hist2d"] == before + 1
            assert torch.equal(got, hist2d_ref(a, b, c, ki, kj)), (plan, va)
            c = wf[vw]
            torch.testing.assert_close(
                hist2d_ops._launch(a, b, c, ki, kj, plan),
                hist2d_ref(a, b, c, ki, kj), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_single_hist2d_past_2_31_bins(cuda):
    """An output of 2^31 bins and more (8 GiB of fp32 counts): the
    slab-free path indexes it in 64 bits. Rows fall on the first, a middle
    and the last row of H."""
    ki, kj, n = (1 << 23) + 1, 256, 5_000
    rng = np.random.default_rng(31)
    rows = np.array([0, ki // 2, ki - 1])
    pick = rng.integers(0, 3, n)
    bi = _t(rows[pick].astype(np.int32)).to(cuda)
    bj = _t(rng.integers(0, kj, n).astype(np.int32)).to(cuda)
    w = _t((rng.random(n) < 0.9).astype(np.float32)).to(cuda)
    got = hist2d(bi, bj, w, ki, kj)
    want = hist2d_ref(_t(pick.astype(np.int32)).to(cuda), bj, w, 3, kj)
    assert torch.equal(got[_t(rows).to(cuda)], want)
    assert float(got.sum()) == float(w.sum())
    del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("k2", [64, 256])
def test_cuda_subbin_matches_plain(cuda, k2):
    rng = np.random.default_rng(k2)
    p, n, s_max = 8, 100_000, 32
    cell = _t(rng.integers(0, k2 * k2, (p, n))).to(cuda)
    sub = _t(rng.integers(0, s_max, (p, n))).to(cuda)
    w01 = _t((rng.random((p, n)) < 0.9).astype(np.float64)).to(cuda)
    before = launch_counts()["batched_subbin_hist"]
    got = batched_subbin_hist(cell, sub, w01, k2 * k2, s_max)
    torch.cuda.synchronize()
    assert launch_counts()["batched_subbin_hist"] == before + 1
    assert torch.equal(got, batched_subbin_hist_ref(cell, sub, w01,
                                                    k2 * k2, s_max))


@pytest.mark.cuda
@pytest.mark.parametrize("q,el,k2,k1", [(1, 1, 256, 512), (64, 3, 256, 512),
                                        (5, 2, 70, 90)])
def test_cuda_weightings_matches_plain(cuda, q, el, k2, k1):
    H, beta, fold, hx = (_t(a).to(cuda) for a in _weightings_inputs(
        np.random.default_rng(q + k2), el, k2, k1, q=q))
    before = launch_counts()
    got = batched_weightings(H, beta, fold, hx)
    one = fused_weightings(H, beta[0], fold, hx)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["batched_weightings"] == before["batched_weightings"] + 1
    assert after["fused_weightings"] == before["fused_weightings"] + 1
    torch.testing.assert_close(got, batched_weightings_ref(H, beta, fold, hx),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(one, fused_weightings_ref(H, beta[0], fold, hx),
                               rtol=1e-5, atol=1e-6)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no kernels: the build raises instead of falling back."""
    from repro_torch.kernels import loader
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        loader.build()
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").iterdir())
