"""The port's single 2-D histogram (K5) and its row-sharded form against the
reference package.

Inputs are made with numpy from a seed and handed to both packages. The
reference's ``hist2d`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it on the CPU. The sharded test starts two
``gloo`` ranks in CPU processes. The card's test of the kernel against its
plain version is ``test_torch_kernels.py::test_cuda_single_hist2d_matches_plain``.
"""
import datetime
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.hist2d import hist2d, hist2d_sharded
from repro_torch.kernels.hist2d.ref import hist2d_ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,ki,kj", [
    (100, 8, 8), (1000, 37, 53), (4096, 128, 256), (2048, 300, 17),
    (1024, 512, 512),
])
def test_hist2d_matches_reference(n, ki, kj):
    """The shapes and inputs of the reference's own kernel test, at its
    tolerance: the Pallas kernel (interpret mode) and the oracle."""
    import jax.numpy as jnp
    from repro.kernels.hist2d import hist2d as jax_hist2d
    from repro.kernels.hist2d.ref import hist2d_ref as jax_ref
    rng = np.random.default_rng(n + ki)
    bi = rng.integers(0, ki, n).astype(np.int32)
    bj = rng.integers(0, kj, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    out = hist2d(_t(bi), _t(bj), _t(w), ki, kj)
    assert out.shape == (ki, kj) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jax_hist2d(bi, bj, w, ki, kj)), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(
        jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(w), ki, kj)), rtol=1e-6)


@pytest.mark.parametrize("wdtype", [np.float32, np.float64, np.int32])
def test_hist2d_weight_dtypes(wdtype):
    """Any weight dtype counts as fp32; the counts sum to the weights'."""
    from repro.kernels.hist2d import hist2d as jax_hist2d
    rng = np.random.default_rng(0)
    n, ki, kj = 500, 16, 16
    bi = rng.integers(0, ki, n).astype(np.int32)
    bj = rng.integers(0, kj, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(wdtype)
    out = hist2d(_t(bi), _t(bj), _t(w), ki, kj)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jax_hist2d(bi, bj, w, ki, kj)), rtol=1e-6)
    assert float(out.sum()) == pytest.approx(float(w.sum()))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64, np.int16])
def test_hist2d_zero_one_weights_exact(idx_dtype):
    """0/1 weights give exact integer counts, equal to the reference's
    kernel; padding rows with out-of-range indices and weight 0 add
    nothing; indices of any integer dtype are taken."""
    from repro.kernels.hist2d import hist2d as jax_hist2d
    rng = np.random.default_rng(5)
    n, ki, kj = 20_000, 64, 48
    bi = rng.integers(0, ki, n)
    bj = rng.integers(0, kj, n)
    w = (rng.random(n) < 0.9).astype(np.float32)
    plain = hist2d(_t(bi.astype(idx_dtype)), _t(bj.astype(idx_dtype)), _t(w),
                   ki, kj)
    pad_i = np.concatenate([bi, [-5, -1, ki, ki + 7, 2 * ki]])
    pad_j = np.concatenate([bj, [0, kj + 3, -2, 5, kj]])
    pad_w = np.concatenate([w, np.zeros(5, np.float32)])
    padded = hist2d(_t(pad_i.astype(idx_dtype)), _t(pad_j.astype(idx_dtype)),
                    _t(pad_w), ki, kj)
    want = np.asarray(jax_hist2d(pad_i.astype(np.int32),
                                 pad_j.astype(np.int32), pad_w, ki, kj))
    assert torch.equal(plain, padded)
    np.testing.assert_array_equal(padded.numpy(), want)
    assert float(padded.sum()) == float(w.sum())


def test_hist2d_clips_out_of_range_rows():
    """Out-of-range rows of non-zero weight land in the edge bins, as in
    the reference's oracle (its Pallas path would drop them: such rows are
    outside the contract)."""
    import jax.numpy as jnp
    from repro.kernels.hist2d.ref import hist2d_ref as jax_ref
    rng = np.random.default_rng(9)
    n, ki, kj = 3000, 20, 30
    bi = rng.integers(-4, ki + 4, n).astype(np.int32)
    bj = rng.integers(-4, kj + 4, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    out = hist2d(_t(bi), _t(bj), _t(w), ki, kj)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(
        jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(w), ki, kj)),
        rtol=1e-6)
    assert out[0, 0] > 0 and out[ki - 1, kj - 1] > 0


def test_hist2d_empty_and_bad_inputs():
    before = launch_counts()["hist2d"]
    empty = torch.zeros(0, dtype=torch.int64)
    out = hist2d(empty, empty, torch.zeros(0), 5, 7)
    assert out.shape == (5, 7) and out.dtype == torch.float32
    assert not out.any()
    assert launch_counts()["hist2d"] == before
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="integer"):
        hist2d(idx.float(), idx, torch.ones(4), 2, 2)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        hist2d(idx[:3], idx, torch.ones(4), 2, 2)
    with pytest.raises(ValueError, match="empty"):
        hist2d(idx, idx, torch.ones(4), 0, 2)


def test_hist2d_sharded_needs_a_process_group():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="init_process_group"):
        hist2d_sharded(idx, idx, torch.ones(4), 2, 2)


# ------------------------------------------------- row-sharded, two ranks

N_SHARDED, KI_SHARDED, KJ_SHARDED = 64_000, 96, 64
SPLIT = 23_456          # uneven shards: 23,456 and 40,544 rows


def _sharded_inputs():
    rng = np.random.default_rng(0)
    bi = rng.integers(0, KI_SHARDED, N_SHARDED).astype(np.int32)
    bj = rng.integers(0, KJ_SHARDED, N_SHARDED).astype(np.int32)
    w = rng.random(N_SHARDED).astype(np.float32)
    return bi, bj, w


def _sharded_rank(rank, world, init_file, out_dir):
    """One rank: make the whole input from the seed, bin this rank's
    shard and save the all-reduced counts."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        shard = np.array_split(np.arange(N_SHARDED), [SPLIT])[rank]
        bi, bj, w = (_t(a[shard]) for a in _sharded_inputs())
        before = launch_counts()["hist2d"]
        counts = hist2d_sharded(bi, bj, w, KI_SHARDED, KJ_SHARDED)
        assert launch_counts()["hist2d"] == before   # CPU: plain version
        np.save(f"{out_dir}/rank{rank}.npy", counts.numpy())
    finally:
        dist.destroy_process_group()


def test_hist2d_sharded_two_gloo_ranks(tmp_path):
    """Two CPU processes, uneven row shards, counts all-reduced over gloo:
    every rank holds the counts of the whole input."""
    import jax.numpy as jnp
    from repro.kernels.hist2d.ref import hist2d_ref as jax_ref
    world = 2
    ctx = torch.multiprocessing.spawn(
        _sharded_rank, args=(world, str(tmp_path / "init"), str(tmp_path)),
        nprocs=world, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 240 s")
    got = [np.load(tmp_path / f"rank{r}.npy") for r in range(world)]
    bi, bj, w = _sharded_inputs()
    want = np.asarray(jax_ref(jnp.asarray(bi), jnp.asarray(bj),
                              jnp.asarray(w), KI_SHARDED, KJ_SHARDED))
    np.testing.assert_array_equal(got[0], got[1])
    assert got[0].shape == (KI_SHARDED, KJ_SHARDED)
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    np.testing.assert_allclose(
        got[0], hist2d_ref(_t(bi), _t(bj), _t(w), KI_SHARDED,
                           KJ_SHARDED).numpy(), rtol=1e-5)
