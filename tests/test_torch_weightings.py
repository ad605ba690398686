"""The weightings kernel (K1 query-batched, K2 single-query) with the fold as
an index.

On the CPU: ``fold_index`` and its checks, the index and dense forms of the
plain versions (equal bit for bit: the fold is one-hot), the port's public
functions in both forms against the reference's Pallas kernels in
interpret mode (rtol 1e-5, atol 1e-6: fp32 sums in another order), the
launch planner and ``FastPath``'s cached index. The tests marked ``cuda``
hold both paths of the CUDA kernel to its plain version on the card and
skip without one; they import nothing of the JAX package, so
``python -m pytest -m cuda tests/test_torch_weightings.py`` runs where JAX
is absent.
"""
import numpy as np
import pytest
import torch
from test_torch_kernels import cuda  # noqa: F401 — the card fixture

from repro_torch.kernels import launch_counts
from repro_torch.kernels.weightings import (batched_weightings, check_stack,
                                            fold_index, fused_weightings,
                                            ops, stacked_weightings)
from repro_torch.kernels.weightings.ref import (batched_weightings_ref,
                                                fused_weightings_ref)

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, q, el, k2, k1, zero_rows=True):
    """H, beta (Q, L, K2), dense one-hot fold, hx; with ``zero_rows`` some
    pair rows are empty (hx = 0) and some 1-D bins fold nowhere (index
    -1), as in the reference's padded stacks."""
    rng = np.random.default_rng(seed)
    H = (rng.random((el, k2, k2)) * 10).astype(np.float32)
    if zero_rows and k2 > 1:
        H[:, rng.integers(0, k2, max(1, k2 // 8))] = 0.0
    hx = H.sum(2).astype(np.float32)
    fold = np.zeros((el, k1, k2), np.float32)
    for li in range(el):
        fold[li, np.arange(k1), np.sort(rng.integers(0, k2, k1))] = 1.0
        if zero_rows:
            fold[li, rng.integers(0, k1, max(1, k1 // 8))] = 0.0
    beta = rng.random((q, el, k2)).astype(np.float32)
    return H, beta, fold, hx


SHAPES = [(q, el, k2, k1) for el in (1, 3) for k2 in (1, 49, 64)
          for k1 in (45, 64) for q in (1, 3, 8)]


# ----------------------------------------------------------------- fold_index


@pytest.mark.parametrize("el,k1,k2", [(1, 45, 49), (3, 64, 1), (2, 7, 64)])
def test_fold_index_round_trip(el, k1, k2):
    _H, _b, fold, _hx = _inputs(el * k1 + k2, 1, el, k2, k1)
    idx = fold_index(_t(fold))
    assert idx.dtype == torch.int32 and idx.shape == (el, k1)
    empty = fold.sum(2) == 0
    assert empty.any()
    np.testing.assert_array_equal(idx.numpy()[empty], -1)
    back = np.zeros_like(fold)
    li, ki = np.nonzero(~empty)
    back[li, ki, idx.numpy()[li, ki]] = 1.0
    np.testing.assert_array_equal(back, fold)


@pytest.mark.parametrize("bad", ["two_nonzeros", "half"])
def test_fold_index_rejects_non_one_hot(bad):
    fold = np.zeros((2, 5, 6), np.float32)
    fold[:, np.arange(5), np.arange(5)] = 1.0
    if bad == "two_nonzeros":
        fold[1, 3, 0] = 1.0
    else:
        fold[0, 2, 2] = 0.5
    with pytest.raises(ValueError, match="not one-hot"):
        fold_index(_t(fold))
    with pytest.raises(ValueError, match="not one-hot"):
        fused_weightings(_t(np.ones((2, 6, 6), np.float32)),
                         np.ones((2, 6), np.float32), _t(fold),
                         _t(np.ones((2, 6), np.float32)))


# ------------------------------------------------------- plain versions


@pytest.mark.parametrize("q,el,k2,k1", SHAPES)
def test_ref_index_form_equals_dense_bit_for_bit(q, el, k2, k1):
    H, beta, fold, hx = (_t(a) for a in _inputs(q + el * k2 + k1, q, el, k2,
                                                 k1))
    idx = fold_index(fold)
    assert torch.equal(batched_weightings_ref(H, beta, idx, hx),
                       batched_weightings_ref(H, beta, fold, hx))
    assert torch.equal(fused_weightings_ref(H, beta[0], idx, hx),
                       fused_weightings_ref(H, beta[0], fold, hx))


# ------------------------------------- the port against the reference's Pallas


@pytest.mark.parametrize("q,el,k2,k1", SHAPES)
def test_port_matches_reference_pallas(q, el, k2, k1):
    """Both forms of the port's public functions on the CPU against the
    reference's Pallas kernels in interpret mode (which pad K1 and K2 to
    128 with zero fold rows)."""
    from repro.kernels.weightings import ops as jax_ops
    H, beta, fold, hx = _inputs(7 * q + el * k2 + k1, q, el, k2, k1)
    want_b = np.asarray(jax_ops.batched_weightings(
        H, beta, fold, hx, use_pallas=True, interpret=True))
    want_f = np.asarray(jax_ops.fused_weightings(
        H, beta[0], fold, hx, use_pallas=True, interpret=True))
    idx = fold_index(_t(fold))
    for f in (_t(fold), idx, idx.numpy().astype(np.int64)):
        got_b = batched_weightings(_t(H), beta, f, _t(hx))
        got_f = fused_weightings(_t(H), beta[0], f, _t(hx))
        assert got_b.shape == (q, k1) and got_f.shape == (k1,)
        np.testing.assert_allclose(got_b.numpy(), want_b, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_f.numpy(), want_f, rtol=RTOL, atol=ATOL)


def test_stacked_weightings_cpu_writes_out():
    H, beta, fold, hx = (_t(a) for a in _inputs(3, 3, 2, 49, 45))
    idx = fold_index(fold)
    assert check_stack(H, idx, hx) == (2, 45, 49)
    out = torch.full((3, 45), -1.0)
    stacked_weightings(H, beta, idx, hx, "fused_weightings", out=out)
    assert torch.equal(out, batched_weightings_ref(H, beta, idx, hx))


@pytest.mark.parametrize("what", ["dtype", "shape", "beta"])
def test_public_functions_check_their_inputs(what):
    H, beta, fold, hx = (_t(a) for a in _inputs(5, 2, 2, 16, 20))
    idx = fold_index(fold)
    if what == "dtype":
        H = H.double()
    elif what == "shape":
        idx = idx[:, :-1].unsqueeze(0)
    else:
        beta = beta[:, :, :-1]
    with pytest.raises(ValueError):
        batched_weightings(H, beta, idx, hx)
    if what == "beta":
        assert check_stack(H, idx, hx) == (2, 20, 16)
    else:
        with pytest.raises(ValueError):
            check_stack(H, idx, hx)


# ------------------------------------------------------------- launch planner


@pytest.mark.parametrize("el,q,k1,k2,want", [
    (2, 1, 45, 49, (1, 8, True)),       # K2 on the main path: 13 row tiles
    (2, 3, 45, 49, (4, 8, True)),       # 135 outputs: phase B in the launch
    (2, 192, 45, 49, (16, 8, False)),   # K1 on the main path: 13 x 12 blocks
    (3, 64, 512, 256, (16, 16, False)),  # the build caps: 48 x 4 blocks
    (3, 1, 512, 256, (1, 8, False)),    # K2 at the caps: 512 outputs
    (5, 1, 256, 256, (1, 8, True)),     # the bench's K2 shape: 160 blocks
    (64, 3, 45, 256, (4, 32, True)),    # many predicates: 512 blocks
    (5000, 2, 16, 1, (2, 32, True)),    # 32-row tiles over 32 predicates
    (200, 3, 45, 30, (4, 32, True)),    # 32-row tiles over two predicates
])
def test_plan_tiles(el, q, k1, k2, want):
    """Query tiles up to 16; the largest row tile that gives each of the
    card's 132 SMs a block, else 8; phase B in the launch when a query
    tile has at most 256 outputs (one a thread)."""
    assert ops._plan(el, q, k1, k2, 132) == want


# ------------------------------------------------------------------- FastPath


def test_fastpath_caches_the_index():
    """The cached stacks hold the (L, K1) int32 index of each pair's
    ``fold_x``, and no dense fold."""
    from types import SimpleNamespace

    from repro_torch.core.fastpath import FastPath
    rng = np.random.default_rng(2)
    k1 = 9
    h = rng.integers(1, 9, k1).astype(np.float64)
    pairs = {}
    for j, kx in ((1, 4), (2, 6)):
        fold_x = np.sort(rng.integers(0, kx, k1))
        pairs[j] = SimpleNamespace(H=rng.random((kx, kx + 1)), kx=kx,
                                   fold_x=fold_x)
    ph = SimpleNamespace(hists={0: SimpleNamespace(k=k1, h=h)},
                         pair=lambda a, j: pairs[j])
    hs, fidx, hxs, k1c, k2max = FastPath(device="cpu")._get_stack(
        ph, 0, (1, 2))
    assert (k1c, k2max) == (k1, 7)
    assert fidx.dtype == torch.int32 and fidx.shape == (2, k1)
    for li, j in enumerate((1, 2)):
        np.testing.assert_array_equal(fidx[li].numpy(), pairs[j].fold_x)
    assert [t.dim() for t in (hs, fidx, hxs)] == [3, 2, 2]


# ------------------------------------------- CUDA kernel vs its plain version


def _cuda_case(cuda, q, el, k2, k1, seed=0):  # noqa: F811
    H, beta, fold, hx = (_t(a).to(cuda)
                         for a in _inputs(seed + q + k2, q, el, k2, k1))
    return H, beta, fold_index(fold), hx, fold


@pytest.mark.cuda
@pytest.mark.parametrize("q,el,k2,k1", [(1, 2, 49, 45), (3, 2, 49, 45),
                                        (192, 2, 49, 45), (3, 1, 1, 64),
                                        (192, 3, 17, 64), (64, 3, 256, 512),
                                        (5, 2, 300, 90), (2, 5000, 1, 16),
                                        (3, 200, 30, 45)])
def test_cuda_matches_plain(cuda, q, el, k2, k1):  # noqa: F811
    """Both phases, phase B in the launch (Q * K1 <= 256 a query tile) and
    as a second launch, at the main path's shapes and the caps; unaligned
    rows (K2 = 49, 17, 300: two column chunks), 32-row tiles spanning two
    or 32 predicates (K2 = 30, 1), empty pair rows (hx = 0) and 1-D bins
    that fold nowhere (index -1); both public functions and both fold
    forms; one launch a call."""
    H, beta, idx, hx, fold = _cuda_case(cuda, q, el, k2, k1)
    want = batched_weightings_ref(H, beta, idx, hx)
    for f in (idx, fold):
        before = launch_counts()
        got = batched_weightings(H, beta, f, hx)
        one = fused_weightings(H, beta[0], f, hx)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["batched_weightings"] == before["batched_weightings"] + 1
        assert after["fused_weightings"] == before["fused_weightings"] + 1
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(one, fused_weightings_ref(H, beta[0], idx,
                                                             hx),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_unaligned_views(cuda):  # noqa: F811
    """Row views at every offset modulo 16 bytes (as FastPath's per-variant
    slices are) written into rows of one ``out``."""
    q, el, k2, k1 = 4, 2, 49, 45
    H, beta, idx, hx, _ = _cuda_case(cuda, q, el, k2, k1)
    out = torch.zeros((q, k1), device=cuda)
    before = launch_counts()["fused_weightings"]
    for i in range(q):
        got = stacked_weightings(H, beta[i:i + 1], idx, hx,
                                 "fused_weightings", out=out[i:i + 1])
        assert got.data_ptr() == out[i].data_ptr()
    torch.cuda.synchronize()
    assert launch_counts()["fused_weightings"] == before + q
    torch.testing.assert_close(out, batched_weightings_ref(H, beta, idx, hx),
                               rtol=RTOL, atol=ATOL)
