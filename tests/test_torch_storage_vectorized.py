"""The port's vectorized storage codec vs its scalar BitReader oracle.

Mirrors tests/test_storage_vectorized.py on ``repro_torch.core.storage``.

``storage.decode`` now routes through ``FastBitReader`` (unpacked-bit
numpy gathers) by default; ``BitReader`` remains the per-bit oracle. These
tests hold the two bit-for-bit equal — on raw primitive runs, on the
packed-numpy ``BitWriter.write_run`` path, and on full synopsis blobs
covering the adversarial shapes (dense/sparse count flips, all-zero
pair counts, single-bin histograms) — without requiring hypothesis.
"""
import numpy as np
import pytest

from repro_torch.core.storage import BitReader, BitWriter, FastBitReader, decode, encode
from repro_torch.core.types import (BuildParams, ColumnInfo, Hist1D, PairHist,
                              PairwiseHist)


# ------------------------------------------------------------- primitive runs

def _write_stream(rng, n_ops=24):
    """A random interleaving of all write primitives; returns (blob, ops)."""
    w = BitWriter()
    ops = []
    for _ in range(n_ops):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            nb = int(rng.integers(1, 64))
            v = int(rng.integers(0, 1 << min(nb, 62)))
            w.write(v, nb)
            ops.append(("bits", v, nb))
        elif kind == 1:
            n, nb = int(rng.integers(0, 200)), int(rng.integers(1, 62))
            vals = rng.integers(0, 1 << min(nb, 62), n)
            w.write_run(vals, nb)
            ops.append(("uint_run", vals, nb))
        elif kind == 2:
            vals = [int(rng.integers(0, 2 ** int(rng.integers(1, 62))))
                    for _ in range(int(rng.integers(0, 80)))]
            for v in vals:
                w.write_varint(v)
            ops.append(("varint_run", vals))
        elif kind == 3:
            vals = [int(rng.integers(-2**40, 2**40))
                    for _ in range(int(rng.integers(0, 80)))]
            for v in vals:
                w.write_svarint(v)
            ops.append(("svarint_run", vals))
        elif kind == 4:
            b = int(rng.integers(0, 9))
            vals = [int(rng.integers(0, 4000))
                    for _ in range(int(rng.integers(0, 150)))]
            for v in vals:
                w.write_rice(v, b)
            ops.append(("rice_run", vals, b))
        else:
            data = bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                                      dtype=np.uint8))
            for byte in data:
                w.write(byte, 8)
            ops.append(("bytes", data))
    return w.getvalue(), ops


def _read_stream(r, ops):
    out = []
    for op in ops:
        if op[0] == "bits":
            out.append(r.read(op[2]))
        elif op[0] == "uint_run":
            out.append(r.read_uint_run(len(op[1]), op[2]).tolist())
        elif op[0] == "varint_run":
            out.append(r.read_varint_run(len(op[1])).tolist())
        elif op[0] == "svarint_run":
            out.append(r.read_svarint_run(len(op[1])).tolist())
        elif op[0] == "rice_run":
            out.append(r.read_rice_run(len(op[1]), op[2]).tolist())
        else:
            out.append(r.read_bytes(len(op[1])))
    return out


@pytest.mark.parametrize("seed", range(40))
def test_bulk_readers_match_oracle(seed):
    """Every bulk read method returns identical values (and leaves the
    cursor at the identical bit position) on both reader classes."""
    rng = np.random.default_rng(seed)
    blob, ops = _write_stream(rng)
    oracle, fast = BitReader(blob), FastBitReader(blob)
    got_o = _read_stream(oracle, ops)
    got_f = _read_stream(fast, ops)
    assert got_o == got_f
    assert oracle.pos == fast.pos


def test_write_run_matches_looped_writes():
    """BitWriter.write_run emits the exact bits of the equivalent write
    loop at any alignment, width, and run length (incl. the short-run
    scalar path and the >= 512-bit packed-numpy path)."""
    rng = np.random.default_rng(7)
    for misalign in (0, 1, 3, 7):
        for nbits in (1, 5, 8, 13, 31, 62):
            for n in (0, 1, 17, 600):
                vals = rng.integers(0, 1 << min(nbits, 62), n)
                w1, w2 = BitWriter(), BitWriter()
                for w in (w1, w2):
                    w.write(0b1011011 & ((1 << misalign) - 1) if misalign
                            else 0, max(misalign, 1))
                w1.write_run(vals, nbits)
                for v in vals:
                    w2.write(int(v), nbits)
                assert w1.getvalue() == w2.getvalue(), (misalign, nbits, n)


def test_varint_run_int64_boundary():
    """The vectorized path is exact through the full int64 range (9 LEB
    chunks); values past it raise OverflowError from both readers instead
    of silently truncating (run reads carry int64 arrays by contract —
    scalar read_varint still handles arbitrary magnitude)."""
    vals = [0, 1, 2**62, 2**63 - 1, 5]
    w = BitWriter()
    for v in vals:
        w.write_varint(v)
    assert FastBitReader(w.getvalue()).read_varint_run(len(vals)).tolist() \
        == BitReader(w.getvalue()).read_varint_run(len(vals)).tolist() == vals

    w = BitWriter()
    for v in (1, 2**63, 2):                    # 2**63 needs a 10th chunk
        w.write_varint(v)
    for reader in (BitReader, FastBitReader):
        with pytest.raises(OverflowError):
            reader(w.getvalue()).read_varint_run(3)
    assert BitReader(w.getvalue()).read_varint() == 1  # scalar path is fine


def test_rice_run_window_growth():
    """Rice runs whose unary parts overflow the initial scan window (huge
    quotients) still decode exactly via the window-doubling path."""
    vals = [50_000, 0, 123_456, 7, 99_999]
    for b in (0, 2, 7):
        w = BitWriter()
        for v in vals:
            w.write_rice(v, b)
        got = FastBitReader(w.getvalue()).read_rice_run(len(vals), b)
        assert got.tolist() == vals


def test_truncated_run_raises():
    """Asking for more varints than the stream holds raises instead of
    fabricating values."""
    w = BitWriter()
    w.write_varint(5)
    with pytest.raises(ValueError):
        FastBitReader(w.getvalue()).read_varint_run(3)


# --------------------------------------------------- full synopsis equivalence

def _mk_hist(rng, k):
    edges = np.unique(rng.choice(200, k + 1, replace=False)).astype(float)
    k = edges.size - 1
    h = rng.integers(0, 500, k).astype(float)
    u = np.minimum(rng.integers(0, 50, k), h).astype(float)
    vmin = edges[:-1].copy()
    vmax = np.minimum(edges[1:], vmin + rng.integers(0, 3, k))
    c = 0.5 * (vmin + vmax)
    return Hist1D(edges=edges, k=np.int32(k), h=h, u=u, vmin=vmin, vmax=vmax,
                  c=c, cminus=c, cplus=c)


def _mk_pair(rng, hx_hist, hy_hist, all_zero):
    kx, ky = int(hx_hist.k), int(hy_hist.k)
    H = (np.zeros((kx, ky)) if all_zero
         else rng.integers(0, 100, (kx, ky)).astype(float))
    if not all_zero:                       # force sparse/dense boundary mix
        H[rng.random((kx, ky)) < 0.6] = 0.0
    return PairHist(
        ex=hx_hist.edges.copy(), ey=hy_hist.edges.copy(),
        kx=np.int32(kx), ky=np.int32(ky), H=H,
        hx=H.sum(1), ux=hx_hist.u[:kx].copy(),
        vminx=hx_hist.vmin.copy(), vmaxx=hx_hist.vmax.copy(),
        hy=H.sum(0), uy=hy_hist.u[:ky].copy(),
        vminy=hy_hist.vmin.copy(), vmaxy=hy_hist.vmax.copy(),
        fold_x=np.zeros(kx, np.int32), fold_y=np.zeros(ky, np.int32))


def _mk_synopsis(seed, d, zero_pairs, single_bin):
    rng = np.random.default_rng(seed)
    kinds = ["int", "float", "categorical"]
    columns = [
        ColumnInfo(name=f"c{i}", kind=kinds[i % 3],
                   offset=float(rng.integers(0, 100)),
                   scale=float(10 ** rng.integers(0, 3)),
                   categories=(("a", "b")[: rng.integers(1, 3)]
                               if kinds[i % 3] == "categorical" else ()),
                   n_null=int(rng.integers(0, 10)),
                   mu=float(rng.integers(1, 5)))
        for i in range(d)
    ]
    hists = [_mk_hist(rng, 1 if single_bin else int(rng.integers(1, 12)))
             for _ in range(d)]
    pairs = {(i, j): _mk_pair(rng, hists[i], hists[j], zero_pairs)
             for i in range(d) for j in range(i + 1, d)}
    params = BuildParams(n_samples=1000, m_frac=0.01, alpha=0.001,
                         s1_max=16, s2_max=8)
    return PairwiseHist(params=params, n_rows=5000, n_sampled=1000,
                        columns=columns, hists=hists, pairs=pairs,
                        chi2_table=np.zeros(17))


def _assert_decodes_equal(a, b):
    assert (a.n_rows, a.n_sampled, a.d) == (b.n_rows, b.n_sampled, b.d)
    for c1, c2 in zip(a.columns, b.columns):
        assert (c1.name, c1.kind, c1.offset, c1.scale, c1.categories,
                c1.n_null, c1.mu) == (c2.name, c2.kind, c2.offset, c2.scale,
                                      c2.categories, c2.n_null, c2.mu)
    for h1, h2 in zip(a.hists, b.hists):
        for f in ("edges", "h", "u", "vmin", "vmax", "c", "cminus", "cplus"):
            v1, v2 = getattr(h1, f), getattr(h2, f)
            assert np.asarray(v1).tobytes() == np.asarray(v2).tobytes(), f
    assert set(a.pairs) == set(b.pairs)
    for key, p1 in a.pairs.items():
        p2 = b.pairs[key]
        for f in ("ex", "ey", "H", "hx", "hy", "ux", "uy",
                  "vminx", "vmaxx", "vminy", "vmaxy", "fold_x", "fold_y"):
            v1, v2 = getattr(p1, f), getattr(p2, f)
            assert np.asarray(v1).tobytes() == np.asarray(v2).tobytes(), f
    assert a.chi2_table.tobytes() == b.chi2_table.tobytes()


@pytest.mark.parametrize("seed,d,zero_pairs,single_bin", [
    (0, 1, False, False), (1, 3, False, False), (2, 4, False, False),
    (3, 3, True, False), (4, 2, False, True), (5, 4, True, True),
    (6, 2, True, False), (7, 1, False, True),
])
def test_full_decode_bit_for_bit(seed, d, zero_pairs, single_bin):
    """decode(blob) [FastBitReader] == decode(blob, vectorized=False)
    [BitReader oracle] with every stored field byte-identical, across the
    adversarial corpus: dense/sparse count flips, all-zero pair counts,
    single-bin histograms, mixed column kinds."""
    blob = encode(_mk_synopsis(seed, d, zero_pairs, single_bin))
    _assert_decodes_equal(decode(blob, vectorized=False), decode(blob))
