"""The launch plan of the single 2-D histogram kernel (K5,
``csrc/hist2d.cu``), on the CPU.

``ops._plan`` picks the kernel's whole geometry from the shape and from
what the card offers. These tests model the kernel's schedule in NumPy from
a plan, as the kernel walks it: the rows between the arrays' first and
last 16-byte boundaries in chunks of whole quads (one by one when the
three arrays differ in their offset modulo 16 bytes), the few edge rows
outside them added by the first chunk's blocks, each block's slab (or, on
the slab-free path, the whole output), the reduction of a cluster's
partial slabs and the add into the zeroed output. They check that every
row is read by exactly one block of each slab, that every bin has one
writer in a cluster, that clusters and shared memory stay within the
card's limits, that the output is zero-filled before the launch exactly
where the plan has slabs (the slab-free path zeroes it itself), and that
replaying the schedule with ``np.add.at`` gives ``hist2d_ref``. The card's
H100 is modelled (132 SMs, 227 KB a block, one 1,024-thread slab block or
eight 256-thread slab-free blocks an SM); the kernel itself is held to its
plain version on the card by the ``cuda`` tests of
``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hist2d import hist2d
from repro_torch.kernels.hist2d import ops
from repro_torch.kernels.hist2d.ref import hist2d_ref

SMEM_BLOCK, SMEM_SM, SMS = 232_448, 233_472, 132
THREADS = 1024                  # the kernel's kThreads


def _resident(cy, smem):
    """A 1,024-thread block holds all 65,536 registers of an SM; eight
    256-thread blocks of the slab-free path (cy 0) fit one."""
    if cy == 0:
        return 8 * SMS
    per_sm = min(1, SMEM_SM // (smem + 1024))
    return SMS * per_sm // cy * cy


H100 = ops.Device(SMS, SMEM_BLOCK, _resident)

SHAPES = [(8, 8), (96, 64), (256, 256), (512, 512), (2048, 256), (3, 49152)]
ROWS = [1, 5, 1023, 1024, 1025, 100_000, 10_000_000]


def _schedule(plan, n, ki, kj, offsets=(0, 0, 0)):
    """The kernel's walk of ``plan``: per block (x, y), its slab's first row,
    its rows, and the row intervals it adds; the three arrays start
    ``offsets`` elements after a 16-byte boundary. Rows go in 16-byte quads
    from the first boundary when the offsets agree, else one by one."""
    if len(set(offsets)) == 1:
        n_lo = min(n, (4 - offsets[0]) % 4)
        n_hi = n_lo + (n - n_lo) // 4 * 4
    else:
        n_lo, n_hi = 0, n
    quads = -(-(n_hi - n_lo) // 4)
    rpc = -(-quads // plan.n_chunks) * 4
    blocks = {}
    for y in range(plan.n_chunks):
        c0 = n_lo + y * rpc
        c1 = min(n_hi, c0 + rpc)
        spans = [(c0, c1)]
        if len(set(offsets)) == 1:
            assert c0 % 4 == (n_lo % 4) and (c1 - c0) % 4 == 0 or c1 <= c0
        if y == 0:                      # edge rows, one a thread
            assert n_lo + (n - n_hi) <= min(6, THREADS)
            spans += [(0, n_lo), (n_hi, n)]
        for x, (r0, rows) in enumerate(_slabs(plan, ki)):
            blocks[x, y] = (r0, rows, [s for s in spans if s[1] > s[0]])
    return blocks


def _slabs(plan, ki):
    """(first row, rows) of each slab; without slabs, all of H at once."""
    if plan.n_slabs == 0:
        return [(0, ki)]
    return [(x * plan.slab_rows,
             max(0, min(plan.slab_rows, ki - x * plan.slab_rows)))
            for x in range(plan.n_slabs)]


def _shares(nbins, cy):
    """The bins [i0, i1) of a slab that block k of its cy partials writes."""
    quads = (-(-nbins // 4) + cy - 1) // cy
    return [(min(nbins, k * quads * 4), min(nbins, k * quads * 4 + quads * 4))
            for k in range(cy)]


def _check_plan(plan, n, ki, kj):
    assert 1 <= plan.cy <= 8 and plan.n_chunks % plan.cy == 0
    assert plan.n_chunks <= 65535
    if plan.n_slabs == 0:               # direct atomics
        assert plan.slab_rows == 0 and plan.cy == 1 and not plan.zero_fill
        assert plan.n_chunks <= _resident(0, 0)     # one cooperative grid
        return
    assert plan.n_slabs * plan.slab_rows >= ki
    assert (plan.n_slabs - 1) * plan.slab_rows < ki     # no empty slab
    assert plan.slab_rows * kj <= ops.MAX_KJ
    assert plan.smem_bytes(kj) <= SMEM_BLOCK
    assert plan.zero_fill


def _check_partition(plan, n, ki, kj, offsets=(0, 0, 0)):
    """Rows: each read once for each slab, by one block of one cluster;
    bins: each written by one block of a cluster; zero-fill exactly where
    clusters share bins."""
    blocks = _schedule(plan, n, ki, kj, offsets)
    for x in range(max(1, plan.n_slabs)):
        spans = sorted(s for y in range(plan.n_chunks)
                       for s in blocks[x, y][2])
        at = 0
        for s0, s1 in spans:            # disjoint and covering [0, n)
            assert s0 == at
            at = s1
        assert at == n
    writers = np.zeros(ki * kj, np.int64)
    for gy in range(plan.n_chunks // plan.cy):
        for x in range(max(1, plan.n_slabs)):
            r0, rows, _ = blocks[x, gy * plan.cy]
            for i0, i1 in _shares(rows * kj, plan.cy):
                writers[r0 * kj + i0:r0 * kj + i1] += 1
    clusters = plan.n_chunks // plan.cy
    assert (writers == clusters).all()


def _replay(plan, bi, bj, w, ki, kj, offsets=(0, 0, 0)):
    """The histogram the schedule computes, added with np.add.at."""
    n = len(w)
    blocks = _schedule(plan, n, ki, kj, offsets)
    a = np.clip(bi, 0, ki - 1)
    b = np.clip(bj, 0, kj - 1)
    partial = {}
    for (x, y), (r0, rows, spans) in blocks.items():
        slab = np.zeros(max(rows, 0) * kj, np.float32)
        for s0, s1 in spans:
            sel = np.arange(s0, s1)
            sel = sel[(w[sel] != 0) & (a[sel] >= r0) & (a[sel] < r0 + rows)]
            np.add.at(slab, (a[sel] - r0) * kj + b[sel], w[sel])
        partial[x, y] = slab
    out = np.zeros(ki * kj, np.float32)     # zero-filled, or by the kernel
    for gy in range(plan.n_chunks // plan.cy):
        for x in range(max(1, plan.n_slabs)):
            r0, rows, _ = blocks[x, gy * plan.cy]
            ys = range(gy * plan.cy, (gy + 1) * plan.cy)
            total = sum(partial[x, y] for y in ys)
            for i0, i1 in _shares(rows * kj, plan.cy):
                out[r0 * kj + i0:r0 * kj + i1] += total[i0:i1]
    return out.reshape(ki, kj)


@pytest.mark.parametrize("ki,kj", SHAPES)
@pytest.mark.parametrize("n", ROWS)
def test_plan_partitions_rows_and_bins(n, ki, kj):
    plan = ops._plan(n, ki, kj, H100)
    _check_plan(plan, n, ki, kj)
    _check_partition(plan, n, ki, kj)
    # Zero-filled (by a second operation) exactly where slab blocks add
    # into the output; the slab-free path zeroes its output itself, at a
    # grid-wide barrier before any add.
    assert plan.zero_fill == (plan.n_slabs > 0)
    if plan.zero_fill:                  # the card filled at most once
        assert plan.n_slabs * plan.n_chunks <= max(
            plan.n_slabs, _resident(1, plan.smem_bytes(kj)))


@pytest.mark.parametrize("ki,kj", SHAPES)
@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 4099, 100_000])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 0, 2)])
def test_replayed_schedule_equals_plain(n, ki, kj, offsets):
    """Views that start 4, 8 or 12 bytes past a boundary, as ``bi[1:]``
    does; 0/1 weights (exact) with out-of-range rows."""
    rng = np.random.default_rng(n + ki + sum(offsets))
    bi = rng.integers(-2, ki + 2, n).astype(np.int32)
    bj = rng.integers(-2, kj + 2, n).astype(np.int32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    plan = ops._plan(n, ki, kj, H100)
    got = _replay(plan, bi, bj, w, ki, kj, offsets)
    want = hist2d_ref(torch.from_numpy(bi), torch.from_numpy(bj),
                      torch.from_numpy(w), ki, kj).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,ki,kj", [(100_000, 256, 256),
                                     (2_048 * 5 + 3, 2_048, 256),
                                     (300_000, 96, 64), (4099, 37, 53)])
@pytest.mark.parametrize("cy", [1, 2, 4])
@pytest.mark.parametrize("clusters", [1, 3])
def test_replay_of_many_cluster_plans(n, ki, kj, cy, clusters):
    """Slab plans forced at these sizes, as the card tests force them:
    ``_slab_plan``'s slabs (more than 8 at 2,048 x 256; at KJ = 53 slabs
    whose first bin is off a 16-byte boundary), one or three clusters of cy
    chunks adding their reduced partial slabs into the zeroed output; fp32
    weights that are multiples of 1/256 (exact in any order), out-of-range
    rows; aligned views, views 4 bytes off and arrays whose offsets
    differ."""
    rng = np.random.default_rng(cy + ki + clusters)
    bi = rng.integers(-2, ki + 2, n).astype(np.int32)
    bj = rng.integers(-2, kj + 2, n).astype(np.int32)
    w = (rng.integers(0, 256, n) / 256).astype(np.float32)
    plan = ops._slab_plan(n, ki, kj, H100)._replace(
        n_chunks=clusters * cy, cy=cy)
    if ki == 2_048:
        assert plan.n_slabs > 8
    _check_plan(plan, n, ki, kj)
    want = hist2d_ref(torch.from_numpy(bi), torch.from_numpy(bj),
                      torch.from_numpy(w), ki, kj).numpy()
    for offsets in ((0, 0, 0), (1, 1, 1), (1, 2, 3)):
        _check_partition(plan, n, ki, kj, offsets)
        np.testing.assert_array_equal(
            _replay(plan, bi, bj, w, ki, kj, offsets), want)


def test_plan_shapes_of_the_main_cases():
    """At 10,000,000 rows two slabs, the card filled once, in clusters of
    two chunks, add into a zeroed output; more than 8 slabs' worth of bins
    and one 192 KB row fit; up to DIRECT_ROWS rows, no slabs and no
    zero-fill; slabs that fill the card alone take one chunk each."""
    big = ops._plan(10_000_000, 256, 256, H100)
    assert big.zero_fill and big.cy == 2
    assert (big.n_slabs, big.slab_rows) == (2, 128)
    assert big.n_slabs * big.n_chunks == _resident(2, big.smem_bytes(256))
    tall = ops._plan(10_000_000, 2048, 256, H100)
    assert tall.n_slabs >= 11
    wide = ops._plan(10_000_000, 3, 49152, H100)
    assert wide.slab_rows == 1 and wide.smem_bytes(49152) <= SMEM_BLOCK
    for n in (1, 1024, 100_000, ops.DIRECT_ROWS):
        direct = ops._plan(n, 512, 512, H100)
        chunks = max(-(-n // ops.DIRECT_CHUNK_ROWS), 512 * 512 // 2048)
        assert direct == (0, 0, min(chunks, _resident(0, 0)), 1)
        assert not direct.zero_fill
    huge = ops._plan(ops.DIRECT_ROWS + 1, 100_000, 256, H100)
    assert huge.n_chunks == 1 and huge.zero_fill


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="49152"):
        ops._plan(10, 4, ops.MAX_KJ + 1, H100)
    with pytest.raises(ValueError, match="no plan"):
        ops._plan(10, 0, 4, H100)
    with pytest.raises(ValueError, match="no plan"):
        ops._plan(0, 4, 4, H100)


def test_wrapper_argument_checks():
    """KI < 1 and inputs on different devices raise before any launch; on
    the CPU, a KJ above the kernel's limit runs the plain version."""
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="empty"):
        hist2d(idx, idx, torch.ones(4), 0, 3)
    with pytest.raises(ValueError, match="different devices"):
        hist2d(idx.to("meta"), idx, torch.ones(4), 2, 2)
    with pytest.raises(ValueError, match="different devices"):
        hist2d(idx, idx, torch.ones(4, device="meta"), 2, 2)
    out = hist2d(idx, idx, torch.ones(4), 1, ops.MAX_KJ + 1)
    assert out.shape == (1, ops.MAX_KJ + 1) and float(out[0, 0]) == 4.0
