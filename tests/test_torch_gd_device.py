"""The port's GreedyGD (torch, here on the CPU) against the reference
package's NumPy GreedyGD: every ``CompressedTable`` field bit for bit, with
NumPy's dtypes and shapes; and the search step's batched distinct counts
against ``np.unique`` of the masked rows."""
import numpy as np
import pytest
import torch

from repro.gd.greedygd import GreedyGD as RefGD
from repro_torch.gd import greedygd
from repro_torch.gd.greedygd import GreedyGD
from repro_torch.gd.preprocess import preprocess_table

N = 30_000


def _flights_like(rng, n=N):
    dist = rng.integers(60, 2_700, n).astype(float)
    air = np.round(dist / 8 + rng.normal(0, 5, n))
    dep = np.round(rng.gamma(1.5, 12, n) - 10)
    arr = np.round(dep + rng.normal(0, 9, n))
    gone = rng.random(n) < 0.02
    air[gone], arr[gone] = np.nan, np.nan
    dep[rng.random(n) < 0.01] = np.nan
    return preprocess_table({
        "airline": np.array(["AA", "DL", "UA", "WN", "B6"])[
            rng.choice(5, n, p=[0.3, 0.25, 0.2, 0.15, 0.1])],
        "origin": np.array([f"A{i:03d}" for i in range(120)])[
            rng.zipf(1.3, n).clip(1, 120) - 1],
        "month": np.full(n, 3.0), "day_of_week": rng.integers(1, 8, n),
        "distance": dist, "air_time": air, "dep_delay": dep,
        "arr_delay": arr}).data


def _nan_and_constant(rng, n=N):
    return np.stack([rng.integers(0, 900, n).astype(float),
                     np.full(n, np.nan), np.full(n, 42.0),
                     rng.zipf(1.6, n).clip(1, 5_000).astype(float)], 1)


def _wide(rng, n=N):
    # 25 + 24 + 20 + 14 bits: past 64 in all, a 25-bit column as in power.
    cols = [rng.integers(0, 2 ** 25, n), np.round(rng.normal(2 ** 23, 2 ** 20,
                                                             n)).clip(0),
            rng.integers(0, 2 ** 20, n), rng.integers(0, 2 ** 14, n)]
    return np.stack(cols, 1).astype(float)


def _high_low_byte(rng, n=N):
    # Few distinct values above 8 bits, so the search moves the whole column
    # into the base; their low bytes are >= 128 and < 128, so the bases'
    # byte order (np.unique's on row views) and numeric order differ.
    v = rng.choice([0x0180, 0x0201, 0x03FF, 0x0481, 0x0100, 0x05C0, 0x02F0],
                   n)
    return np.stack([v, rng.integers(0, 3, n)], 1).astype(float)


TABLES = {
    "flights_like_nulls": _flights_like,
    "all_nan_and_constant": _nan_and_constant,
    "no_subsample": lambda rng: _flights_like(rng, 4_000),
    "past_64_bits": _wide,
    "byte_order": _high_low_byte,
    "single_column": lambda rng: _nan_and_constant(rng)[:, 3:],
    # Two independent 4-bit columns: either move costs the same, the first
    # column's wins, and then moving the other does not pay.
    "tied_columns": lambda rng: rng.integers(0, 16, (N, 2)).astype(float),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_compress_bit_identical_to_reference(name):
    data = TABLES[name](np.random.default_rng(5))
    if name == "no_subsample":
        assert data.shape[0] <= GreedyGD(device="cpu").search_rows
    want = RefGD().compress(data)
    got = GreedyGD(device="cpu").compress(data)
    for f in ("bases", "base_ids", "base_bits", "total_bits", "null_mask",
              "sentinels"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        np.testing.assert_array_equal(a, b, f)
    assert len(got.deviations) == len(want.deviations)
    for a, b in zip(got.deviations, want.deviations):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)
    if name == "byte_order":
        assert got.base_bits[0] == got.total_bits[0] > 8
    if name == "tied_columns":
        assert list(got.base_bits) == [4, 0]
    if name == "past_64_bits":
        assert got.total_bits.sum() > 64 and got.total_bits[0] == 25


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_counts_match_unique_rows(seed):
    """One search step: with g the dense ids under random base bits b, the
    distinct count of ``g * n_s + rank_i`` is ``np.unique``'s count of the
    rows masked to b with column i one nibble wider, for every column i,
    and the dense ids group the rows as those masked rows do."""
    rng = np.random.default_rng(seed)
    data = _flights_like(rng, 3_000)
    codes = np.where(np.isfinite(data), data, np.nanmax(data, 0) + 1
                     ).astype(np.uint64)
    widths = np.array([max(1, int(v).bit_length()) for v in codes.max(0)])
    bits = rng.integers(0, widths + 1)
    cand = np.minimum(widths, bits + 4)

    def masked(b):
        return codes >> (widths - b).astype(np.uint64)

    g = np.unique(masked(bits), axis=0, return_inverse=True)[1].reshape(-1)
    codes_t = torch.from_numpy(codes.astype(np.int64).T.copy())
    shift = torch.from_numpy(widths - cand)[:, None]
    ranks = greedygd._dense_ids(codes_t >> shift)[0]
    ids, counts = greedygd._dense_ids(torch.from_numpy(g) * len(g) + ranks)
    for i in range(len(widths)):
        b = bits.copy()
        b[i] = cand[i]
        want, inverse = np.unique(masked(b), axis=0, return_inverse=True)
        assert int(counts[i]) == want.shape[0], i
        pairs = np.stack([ids[i].numpy(), inverse.reshape(-1)], 1)
        assert np.unique(pairs, axis=0).shape[0] == want.shape[0], i


@pytest.mark.parametrize("value", [-1.0, 2.0 ** 63, 2.0 ** 64])
def test_compress_rejects_values_int64_codes_cannot_hold(value):
    """Codes are int64: a value below 0 or from 2^63 up raises and names
    its column, where a cast would wrap it into wrong widths."""
    data = np.random.default_rng(1).integers(0, 100, (500, 3)).astype(float)
    data[7, 1] = value
    data[9, 2] = np.nan
    with pytest.raises(ValueError, match=r"columns \[1\]"):
        GreedyGD(device="cpu").compress(data)


def test_compress_takes_the_largest_int64_code():
    """The largest value below 2^63 in float64 stays a valid code, its
    sentinel too, bit for bit as the reference package codes it."""
    data = np.array([[0.0], [2.0 ** 63 - 1024], [np.nan]] * 4)
    got = GreedyGD(device="cpu").compress(data)
    want = RefGD().compress(data)
    np.testing.assert_array_equal(got.sentinels, want.sentinels)
    np.testing.assert_array_equal(got.total_bits, want.total_bits)
    np.testing.assert_array_equal(
        GreedyGD(device="cpu").decompress(got), data)


def test_default_device_is_cuda():
    """No device means CUDA, as everywhere in the port; without CUDA that
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert GreedyGD().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GreedyGD()
    assert GreedyGD(device="cpu").device.type == "cpu"


def test_dedup_without_base_bits_is_one_base():
    """With no column's bits in the base every row has the base 0: one
    base, first seen at row 0, and no sort or read."""
    base = torch.zeros((3, 50), dtype=torch.int64)
    first, ids = greedygd._dedup(base, np.zeros(3, np.int64))
    assert first.tolist() == [0] and not ids.any()
