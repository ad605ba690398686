"""Hypothesis property tests for the port's bit-level storage codecs.

Mirrors tests/test_storage_property.py (and the bit-IO round trips of
tests/test_property.py, here with ``deadline=None``) on
``repro_torch.core.storage``. Complements tests/test_torch_storage.py (structural/query-identity roundtrips on
real synopses) with adversarial fuzzing of the codec layer itself: random
bit-IO interleavings, dyadic-exponent boundaries, dense-vs-sparse count
flips, and full encode/decode of synthetic PairwiseHist shapes the builder
would rarely emit (all-zero counts, single-bin histograms).

Exactness caveat: ``_encode_values``'s dyadic path snaps values within 1e-6
of a dyadic grid onto it, so exact-roundtrip assertions use either genuinely
dyadic values (ints / 2**p) or values far from any dyadic grid of exponent
<= 40 (which take the bit-exact f64 fallback).
"""
import math
import struct

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core.storage import (BitReader, BitWriter,  # noqa: E402
                                IntegrityError, _decode_counts,
                                _decode_values, _encode_counts,
                                _encode_values, blob_info, decode, encode)
from repro_torch.core.types import (BuildParams, ColumnInfo, Hist1D,  # noqa: E402
                              PairHist, PairwiseHist)


# -------------------------------------------- bit IO (tests/test_property.py)

@given(st.lists(st.tuples(st.integers(0, 2**32 - 1), st.integers(1, 33)),
                min_size=1, max_size=200))
@settings(deadline=None)
def test_bitio_roundtrip(pairs):
    w = BitWriter()
    for val, nbits in pairs:
        w.write(val & ((1 << nbits) - 1), nbits)
    r = BitReader(w.getvalue())
    for val, nbits in pairs:
        assert r.read(nbits) == val & ((1 << nbits) - 1)


@given(st.lists(st.integers(0, 2**62), min_size=1, max_size=100))
@settings(deadline=None)
def test_varint_roundtrip(values):
    w = BitWriter()
    for v in values:
        w.write_varint(v)
    r = BitReader(w.getvalue())
    assert [r.read_varint() for _ in values] == values


@given(st.lists(st.integers(-2**40, 2**40), min_size=1, max_size=100))
@settings(deadline=None)
def test_svarint_roundtrip(values):
    w = BitWriter()
    for v in values:
        w.write_svarint(v)
    r = BitReader(w.getvalue())
    assert [r.read_svarint() for _ in values] == values


@given(st.lists(st.integers(0, 10000), min_size=1, max_size=100),
       st.integers(0, 8))
@settings(deadline=None)
def test_golomb_rice_roundtrip(values, b):
    w = BitWriter()
    for v in values:
        w.write_rice(v, b)
    r = BitReader(w.getvalue())
    assert [r.read_rice(b) for _ in values] == values


# ------------------------------------------------------------ bit IO fuzzing

_OPS = st.one_of(
    st.tuples(st.just("bits"), st.integers(0, 2**63 - 1), st.integers(1, 64)),
    st.tuples(st.just("varint"), st.integers(0, 2**62)),
    # Crosses the 2**63 boundary where the old C-idiom zig-zag
    # ((v << 1) ^ (v >> 63)) silently corrupted Python's unbounded ints.
    st.tuples(st.just("svarint"), st.integers(-2**70, 2**70)),
    st.tuples(st.just("rice"), st.integers(0, 20000), st.integers(0, 10)),
    st.tuples(st.just("f64"), st.floats(allow_nan=True, allow_infinity=True)),
)


@given(st.lists(_OPS, min_size=1, max_size=300))
@settings(max_examples=200, deadline=None)
def test_bitio_interleaved_roundtrip(ops):
    """Any interleaving of the five write primitives reads back exactly
    (f64 compared at the bit level so NaN payloads count)."""
    w = BitWriter()
    for op in ops:
        if op[0] == "bits":
            w.write(op[1] & ((1 << op[2]) - 1), op[2])
        elif op[0] == "varint":
            w.write_varint(op[1])
        elif op[0] == "svarint":
            w.write_svarint(op[1])
        elif op[0] == "rice":
            w.write_rice(op[1], op[2])
        else:
            w.write_f64(op[1])
    r = BitReader(w.getvalue())
    for op in ops:
        if op[0] == "bits":
            assert r.read(op[2]) == op[1] & ((1 << op[2]) - 1)
        elif op[0] == "varint":
            assert r.read_varint() == op[1]
        elif op[0] == "svarint":
            assert r.read_svarint() == op[1]
        elif op[0] == "rice":
            assert r.read_rice(op[2]) == op[1]
        else:
            assert struct.pack("<d", r.read_f64()) == struct.pack("<d", op[1])


def test_svarint_boundary_roundtrip():
    """|v| at and past 2**63 roundtrips exactly.

    Regression: the zig-zag used the C idiom ``(v << 1) ^ (v >> 63)``,
    which on arbitrary-precision ints maps every v >= 2**63 to the wrong
    codeword (the ``>> 63`` no longer isolates a sign bit), so the
    roundtrip silently returned a different number instead of raising."""
    boundary = [2**63 - 1, 2**63, 2**63 + 1, -(2**63) + 1, -(2**63),
                -(2**63) - 1, 2**64 + 17, -(2**70) - 3]
    w = BitWriter()
    for v in boundary:
        w.write_svarint(v)
    r = BitReader(w.getvalue())
    assert [r.read_svarint() for _ in boundary] == boundary


@given(st.lists(st.integers(1, 64), min_size=1, max_size=64),
       st.integers(0, 2**31))
@settings(max_examples=100, deadline=None)
def test_bitio_random_widths(widths, seed):
    """Width-1..64 fields packed back to back roundtrip at any alignment."""
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(0, 1 << min(nb, 62))) for nb in widths]
    w = BitWriter()
    for v, nb in zip(vals, widths):
        w.write(v, nb)
    r = BitReader(w.getvalue())
    assert [r.read(nb) for nb in widths] == vals


# --------------------------------------------------------- value-array codec

@given(st.integers(0, 19),
       st.lists(st.integers(-2**20, 2**20), min_size=1, max_size=64))
@settings(max_examples=100, deadline=None)
def test_values_dyadic_exact(p, ints):
    """(2k+1) / 2**p roundtrips bit-exactly through the dyadic delta path.

    Odd numerators keep every value at least 2**-p away from any coarser
    dyadic grid, and p <= 19 keeps 2**-p above the encoder's 1e-6 snap
    tolerance — so the chosen exponent is exactly p and the roundtrip is
    lossless. (Tiny even-numerator values like 3/2**40 legitimately snap
    to a coarser grid; that lossy-by-design case is covered by
    ``test_values_any_floats_roundtrip_exact``.)"""
    arr = (2.0 * np.array(ints, np.float64) + 1.0) / (1 << p)
    w = BitWriter()
    _encode_values(w, arr)
    out = _decode_values(BitReader(w.getvalue()), len(arr))
    assert np.array_equal(out, arr)


@given(st.lists(st.floats(min_value=-1e300, max_value=1e300,
                          allow_nan=False), min_size=1, max_size=32))
@settings(max_examples=100, deadline=None)
def test_values_any_floats_roundtrip_exact(values):
    """Arbitrary finite floats roundtrip bit-exactly UNLESS they sit within
    the 1e-6 dyadic-snap tolerance of a p<=40 grid (then they land on it) —
    either way the decoded array is within 1e-6 * 2**-p of the input."""
    arr = np.array(values, np.float64)
    w = BitWriter()
    _encode_values(w, arr)
    out = _decode_values(BitReader(w.getvalue()), len(arr))
    assert np.allclose(out, arr, rtol=0, atol=2e-6) or np.array_equal(out, arr)


def test_values_dyadic_cap_falls_back_to_f64():
    """Values past the dyadic caps take the bit-exact f64 fallback.

    Two cap edges: an alternating-bit numerator over 2**41 (0.0101...01 in
    binary) is exactly dyadic only at p=41 — one past the p<=40 cap — and
    its fractional part stays >= 0.25 at every p<=40, so no coarser grid
    can snap it; and a magnitude past the 2**62 guard rejects every
    exponent outright. (A *small* numerator over 2**41 like 1/2**41 instead
    snaps to a coarse grid within the 1e-6 tolerance — lossy by design.)"""
    alt_bits = (4**21 - 1) // 3                # 0b0101...01, 41 bits, odd
    arr = np.array([alt_bits / (1 << 41), 2.0**63], np.float64)
    w = BitWriter()
    _encode_values(w, arr)
    r = BitReader(w.getvalue())
    assert r.read(1) == 1                      # f64 fallback flag
    out = _decode_values(BitReader(w.getvalue()), len(arr))
    assert np.array_equal(out, arr)


def test_values_f64_fallback_bit_exact():
    """Values far from every dyadic grid (1/3, pi) take the fallback and
    roundtrip to the exact same bit patterns."""
    arr = np.array([1.0 / 3.0, math.pi, -math.e * 1e17], np.float64)
    w = BitWriter()
    _encode_values(w, arr)
    out = _decode_values(BitReader(w.getvalue()), len(arr))
    assert arr.tobytes() == out.tobytes()


# --------------------------------------------------------------- count codec

@given(st.integers(0, 2**31), st.integers(1, 400), st.floats(0.0, 1.0),
       st.integers(0, 20))
@settings(max_examples=150, deadline=None)
def test_counts_roundtrip_any_density(seed, n, density, log_scale):
    """Count vectors from all-zero through dense roundtrip exactly; the
    dense-vs-sparse flag picks whichever encoding is smaller, and both
    decode identically across the flip boundary."""
    rng = np.random.default_rng(seed)
    flat = np.where(rng.random(n) < density,
                    rng.integers(0, (1 << log_scale) + 1, n), 0)
    H = flat.astype(np.float64)
    w = BitWriter()
    _encode_counts(w, H)
    out = _decode_counts(BitReader(w.getvalue()), (n,))
    assert np.array_equal(out, H)


@given(st.integers(1, 24), st.integers(1, 24), st.integers(0, 2**31))
@settings(max_examples=100, deadline=None)
def test_counts_roundtrip_2d(kx, ky, seed):
    rng = np.random.default_rng(seed)
    H = rng.integers(0, 1000, (kx, ky)).astype(np.float64)
    H[rng.random((kx, ky)) < 0.7] = 0.0        # mostly sparse
    w = BitWriter()
    _encode_counts(w, H)
    out = _decode_counts(BitReader(w.getvalue()), (kx, ky))
    assert np.array_equal(out, H)


def test_counts_all_zero_and_single_nonzero():
    for H in (np.zeros(17), np.zeros((5, 5)),
              np.eye(1) * 7, np.array([0.0, 0, 0, 12345.0, 0])):
        w = BitWriter()
        _encode_counts(w, H)
        out = _decode_counts(BitReader(w.getvalue()), H.shape)
        assert np.array_equal(out, H)


# ----------------------------------------------- adversarial synopsis shapes

def _mk_hist(rng, k, lo=0.0):
    """A structurally valid Hist1D on an integer grid with k bins."""
    edges = lo + np.unique(rng.choice(200, k + 1, replace=False)).astype(float)
    k = edges.size - 1
    h = rng.integers(0, 500, k).astype(float)
    u = np.minimum(rng.integers(0, 50, k), h).astype(float)
    vmin = edges[:-1].copy()
    vmax = np.minimum(edges[1:], vmin + rng.integers(0, 3, k))
    c = 0.5 * (vmin + vmax)
    return Hist1D(edges=edges, k=np.int32(k), h=h, u=u, vmin=vmin, vmax=vmax,
                  c=c, cminus=c, cplus=c)


def _mk_pair(rng, hx_hist, hy_hist, all_zero=False):
    """A structurally valid PairHist consistent with its slice metadata
    (decode re-derives hx/hy as H.sum, so the fixture must agree)."""
    kx, ky = int(hx_hist.k), int(hy_hist.k)
    H = (np.zeros((kx, ky)) if all_zero
         else rng.integers(0, 100, (kx, ky)).astype(float))
    return PairHist(
        ex=hx_hist.edges.copy(), ey=hy_hist.edges.copy(),
        kx=np.int32(kx), ky=np.int32(ky), H=H,
        hx=H.sum(1), ux=hx_hist.u[:kx].copy(),
        vminx=hx_hist.vmin.copy(), vmaxx=hx_hist.vmax.copy(),
        hy=H.sum(0), uy=hy_hist.u[:ky].copy(),
        vminy=hy_hist.vmin.copy(), vmaxy=hy_hist.vmax.copy(),
        fold_x=np.zeros(kx, np.int32), fold_y=np.zeros(ky, np.int32))


@given(st.integers(0, 2**31), st.integers(1, 4), st.booleans(),
       st.booleans())
@settings(max_examples=60, deadline=None)
def test_encode_decode_adversarial_shapes(seed, d, zero_pairs, single_bin):
    """Synthetic synopses — single-bin histograms, all-zero pair counts,
    mixed column kinds — encode/decode with every stored field bit-exact."""
    rng = np.random.default_rng(seed)
    kinds = ["int", "float", "categorical"]
    columns = [
        ColumnInfo(name=f"c{i}", kind=kinds[i % 3],
                   offset=float(rng.integers(0, 100)),
                   scale=float(10 ** rng.integers(0, 3)),
                   categories=(("a", "b", "zz")[: rng.integers(1, 4)]
                               if kinds[i % 3] == "categorical" else ()),
                   n_null=int(rng.integers(0, 10)),
                   mu=float(rng.integers(1, 5)))
        for i in range(d)
    ]
    hists = [_mk_hist(rng, 1 if single_bin else int(rng.integers(1, 12)))
             for _ in range(d)]
    pairs = {}
    for i in range(d):
        for j in range(i + 1, d):
            pairs[(i, j)] = _mk_pair(rng, hists[i], hists[j],
                                     all_zero=zero_pairs)
    params = BuildParams(n_samples=1000, m_frac=0.01, alpha=0.001,
                         s1_max=16, s2_max=8)
    ph = PairwiseHist(params=params, n_rows=5000, n_sampled=1000,
                      columns=columns, hists=hists, pairs=pairs,
                      chi2_table=np.zeros(17))
    blob = encode(ph)

    info = blob_info(blob)
    assert info == {"bytes": len(blob), "n_rows": 5000, "n_sampled": 1000,
                    "d": d, "framed": True}

    ph2 = decode(blob)
    assert ph2.n_rows == ph.n_rows and ph2.n_sampled == ph.n_sampled
    assert ph2.params.min_points == ph.params.min_points
    assert ph2.params.alpha == ph.params.alpha
    for c1, c2 in zip(ph.columns, ph2.columns):
        assert (c1.name, c1.kind, c1.offset, c1.scale, c1.n_null, c1.mu) == \
               (c2.name, c2.kind, c2.offset, c2.scale, c2.n_null, c2.mu)
        assert tuple(str(x) for x in c1.categories) == c2.categories
    for h1, h2 in zip(ph.hists, ph2.hists):
        for field in ("edges", "h", "u", "vmin", "vmax"):
            assert np.array_equal(getattr(h1, field), getattr(h2, field)), field
    assert set(ph2.pairs) == set(ph.pairs)
    for key, p1 in ph.pairs.items():
        p2 = ph2.pairs[key]
        for field in ("ex", "ey", "H", "hx", "hy", "ux", "uy",
                      "vminx", "vmaxx", "vminy", "vmaxy"):
            assert np.array_equal(getattr(p1, field), getattr(p2, field)), field


def test_blob_info_rejects_bad_magic():
    with pytest.raises(ValueError):
        blob_info(b"NOPE" + b"\x00" * 16)


# --------------------------------------------------------- corruption corpus

def _small_ph(seed=123, d=3):
    """A small but real synopsis for corruption fuzzing."""
    rng = np.random.default_rng(seed)
    columns = [ColumnInfo(name=f"c{i}", kind="float", offset=0.0, scale=1.0,
                          categories=(), n_null=0, mu=1.0) for i in range(d)]
    hists = [_mk_hist(rng, int(rng.integers(3, 10))) for _ in range(d)]
    pairs = {(i, j): _mk_pair(rng, hists[i], hists[j])
             for i in range(d) for j in range(i + 1, d)}
    return PairwiseHist(params=BuildParams(n_samples=1000), n_rows=4000,
                        n_sampled=1000, columns=columns, hists=hists,
                        pairs=pairs, chi2_table=np.zeros(17))


@pytest.fixture(scope="module")
def framed_blob():
    return encode(_small_ph())


def _assert_rejected(data):
    """Every reader surface rejects ``data`` with the typed IntegrityError —
    wrong answers and hangs are the failure modes being excluded."""
    for vectorized in (True, False):
        with pytest.raises(IntegrityError):
            decode(data, vectorized=vectorized)
    with pytest.raises(IntegrityError):
        blob_info(data)


@given(st.integers(0, 2**31))
@settings(max_examples=150, deadline=None)
def test_corruption_single_bit_flip_rejected(framed_blob, seed):
    """ANY single-bit flip — header or payload — is caught by the frame
    (CRC over the payload, explicit length, 3-bit magic distance), in both
    the vectorized and the oracle decoder."""
    rng = np.random.default_rng(seed)
    pos = int(rng.integers(0, len(framed_blob)))
    bit = int(rng.integers(0, 8))
    bad = bytearray(framed_blob)
    bad[pos] ^= 1 << bit
    _assert_rejected(bytes(bad))


@given(st.integers(0, 2**31))
@settings(max_examples=100, deadline=None)
def test_corruption_truncation_rejected(framed_blob, seed):
    """Truncation at any point — inside the 12-byte frame header or the
    payload — raises IntegrityError, never decodes garbage."""
    rng = np.random.default_rng(seed)
    cut = int(rng.integers(0, len(framed_blob)))
    _assert_rejected(framed_blob[:cut])


@given(st.integers(0, 2**31), st.integers(1, 64))
@settings(max_examples=100, deadline=None)
def test_corruption_garbage_tail_rejected(framed_blob, seed, n_tail):
    """Appended garbage breaks the frame's length check even when the
    payload itself is intact."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, 256, n_tail, dtype=np.uint8).tobytes()
    _assert_rejected(framed_blob + tail)


@given(st.binary(min_size=0, max_size=64))
@settings(max_examples=100, deadline=None)
def test_corruption_arbitrary_garbage_rejected(garbage):
    """Arbitrary non-synopsis bytes are rejected typed (bad magic / short
    frame), not crashed on or misread."""
    _assert_rejected(garbage)


@given(st.integers(0, 2**31))
@settings(max_examples=60, deadline=None)
def test_corruption_legacy_truncation_rejected(framed_blob, seed):
    """Legacy UNframed streams have no CRC, but truncation still surfaces
    as IntegrityError via the bit-reader overrun guards (both readers) —
    never a hang or a silently short synopsis."""
    ph = _small_ph()
    raw = encode(ph, framed=False)
    assert decode(raw).n_rows == ph.n_rows     # sanity: legacy passthrough
    rng = np.random.default_rng(seed)
    cut = int(rng.integers(4, len(raw) - 1))   # keep the PWH1 magic
    for vectorized in (True, False):
        with pytest.raises(IntegrityError):
            decode(raw[:cut], vectorized=vectorized)


def test_framed_roundtrip_and_info(framed_blob):
    """The frame is transparent: decode returns the same synopsis, and
    blob_info reports framed=True with payload-level fields intact."""
    ph = decode(framed_blob)
    assert ph.n_rows == 4000 and len(ph.hists) == 3
    info = blob_info(framed_blob)
    assert info["framed"] is True and info["d"] == 3
