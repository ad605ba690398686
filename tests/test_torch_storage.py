"""The port's storage codec against the reference package's.

A synopsis built by ``repro`` and copied into the port's types by
``types.synopsis_from_numpy`` must encode to the same bytes in both
packages, and each package must decode the other's blob to a synopsis
equal field by field (``array_equal``, dtypes and ``chi2_table`` included)
to its own decode — at every alpha the repo uses, since decode rebuilds the
crit table from the blob's alpha and recomputes the centre bounds from it.
The rest mirrors tests/test_storage.py on ``repro_torch.core.storage``.
"""
import numpy as np
import pytest

from repro_torch.core import storage
from repro_torch.core.query import QueryEngine
from repro_torch.core.types import synopsis_from_numpy

from test_torch_build import _mixed_table, _ref_build, assert_same_synopsis

ALPHAS = (0.01, 0.001, 0.0001)


@pytest.fixture(scope="module")
def ref_synopses(synopsis):
    """Reference synopses: the shared one (alpha 0.001, 60k rows) and one
    on the mixed table at each alpha the repo uses."""
    mixed = _mixed_table()
    out = {"shared": synopsis}
    for alpha in ALPHAS:
        out[alpha] = _ref_build(mixed, dict(k2_cap=64, s2_max=16,
                                            pair_chunk=4, alpha=alpha,
                                            n_samples=mixed.shape[0]))
    return out


@pytest.fixture(scope="module")
def port_synopsis(synopsis):
    return synopsis_from_numpy(synopsis)


def assert_same_columns(a, b):
    for c1, c2 in zip(a.columns, b.columns, strict=True):
        assert (c1.name, c1.kind, c1.offset, c1.scale, c1.categories,
                c1.n_null, c1.mu) == (c2.name, c2.kind, c2.offset, c2.scale,
                                      c2.categories, c2.n_null, c2.mu)


# ------------------------------------------------------ against the reference


@pytest.mark.parametrize("key", ["shared"] + list(ALPHAS))
@pytest.mark.parametrize("framed", [True, False])
def test_encode_byte_identical_to_reference(ref_synopses, key, framed):
    from repro.core import storage as ref_storage
    ref = ref_synopses[key]
    want = ref_storage.encode(ref, framed=framed)
    assert storage.encode(synopsis_from_numpy(ref), framed=framed) == want


@pytest.mark.parametrize("key", ["shared"] + list(ALPHAS))
@pytest.mark.parametrize("vectorized", [True, False])
def test_cross_package_decode(ref_synopses, key, vectorized):
    """Each package decodes the other's blob to its own decode, exactly."""
    from repro.core import storage as ref_storage
    ref = ref_synopses[key]
    ref_blob = ref_storage.encode(ref)
    port_blob = storage.encode(synopsis_from_numpy(ref))
    for blob in (ref_blob, port_blob):
        want = ref_storage.decode(blob, vectorized=vectorized)
        got = storage.decode(blob, vectorized=vectorized)
        assert_same_synopsis(want, got)
        assert_same_columns(want, got)
        assert got.params == synopsis_from_numpy(want).params
    assert storage.blob_info(port_blob) == ref_storage.blob_info(ref_blob)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_decoded_crit_table_is_the_builds(ref_synopses, alpha):
    """Decode rebuilds the build's crit table from the blob's alpha, bit
    for bit, so the recomputed centre bounds use the build's values."""
    ref = ref_synopses[alpha]
    ph = storage.decode(storage.encode(synopsis_from_numpy(ref)))
    assert ph.params.alpha == alpha
    np.testing.assert_array_equal(ph.chi2_table, ref.chi2_table)


def test_fast_bit_reader_equals_bit_reader(port_synopsis):
    blob = storage.encode(port_synopsis)
    assert_same_synopsis(storage.decode(blob, vectorized=False),
                         storage.decode(blob))


def test_size_report_matches_reference(ref_synopses, port_synopsis):
    from repro.core import storage as ref_storage
    assert storage.synopsis_size_report(port_synopsis) == \
        ref_storage.synopsis_size_report(ref_synopses["shared"])
    assert storage.eq12_bound(port_synopsis) == \
        ref_storage.eq12_bound(ref_synopses["shared"])


def test_framework_storage_report_matches_reference():
    """``AQPFramework.storage_report``/``size_bytes`` on the same table, with
    and without the compressed store, at a non-default alpha."""
    from repro.aqp.engine import AQPFramework as RefFramework
    from repro.core.types import BuildParams as RefParams
    from repro_torch.aqp.engine import AQPFramework
    from repro_torch.core.types import BuildParams
    rng = np.random.default_rng(5)
    n = 4000
    table = {"a": rng.integers(0, 300, n).astype(float),
             "b": np.round(np.abs(rng.normal(100, 30, n)))}
    for use_compression in (True, False):
        kw = dict(n_samples=n, alpha=0.01)
        ref = RefFramework(RefParams(**kw), use_compression=use_compression)
        port = AQPFramework(BuildParams(**kw),
                            use_compression=use_compression, device="cpu")
        ref.ingest(table)
        port.ingest(table)
        assert port.storage_report() == ref.storage_report()
        assert port.size_bytes() == ref.size_bytes()


# --------------------------------------- tests/test_storage.py, on the port


def test_roundtrip_structural(port_synopsis):
    blob = storage.encode(port_synopsis)
    ph2 = storage.decode(blob)
    assert ph2.d == port_synopsis.d
    assert ph2.n_rows == port_synopsis.n_rows
    for h1, h2 in zip(port_synopsis.hists, ph2.hists):
        np.testing.assert_allclose(h1.edges, h2.edges)
        np.testing.assert_allclose(h1.h, h2.h)
        np.testing.assert_allclose(h1.u, h2.u)
        np.testing.assert_allclose(h1.vmin, h2.vmin)
        np.testing.assert_allclose(h1.vmax, h2.vmax)
        # re-derived quantities
        np.testing.assert_allclose(h1.c, h2.c)
        np.testing.assert_allclose(h1.cminus, h2.cminus, rtol=1e-9)
        np.testing.assert_allclose(h1.cplus, h2.cplus, rtol=1e-9)
    for key in port_synopsis.pairs:
        p1, p2 = port_synopsis.pairs[key], ph2.pairs[key]
        np.testing.assert_allclose(p1.H, p2.H)
        np.testing.assert_allclose(p1.hx, p2.hx)
        np.testing.assert_allclose(p1.fold_x, p2.fold_x)
        np.testing.assert_allclose(p1.fold_y, p2.fold_y)


def test_roundtrip_query_identity(port_synopsis):
    ph2 = storage.decode(storage.encode(port_synopsis))
    e1, e2 = QueryEngine(port_synopsis), QueryEngine(ph2)
    for sql in ("SELECT COUNT(c0) FROM t WHERE c1 > 300",
                "SELECT AVG(c2) FROM t WHERE c1 >= 250 AND c1 < 350",
                "SELECT MEDIAN(c1) FROM t WHERE c2 > 600"):
        r1, r2 = e1.query(sql), e2.query(sql)
        np.testing.assert_allclose(r1.as_tuple(), r2.as_tuple(), rtol=1e-9)


def test_size_is_compact(port_synopsis):
    rep = storage.synopsis_size_report(port_synopsis)
    assert rep["total"] < 1_000_000          # sub-MB (paper claim band)
    assert rep["total"] < 0.05 * port_synopsis.n_sampled * \
        port_synopsis.d * 8
    # within 1.5x of the paper's Eq. 12 bound on integer data
    assert rep["total"] <= 1.5 * rep["eq12_bound"]


def test_counts_sparse_vs_dense_selection():
    from repro_torch.core.storage import (BitReader, BitWriter,
                                          _decode_counts, _encode_counts)
    dense = np.ones((40, 40))
    sparse = np.zeros((40, 40))
    sparse[3, 7] = 9
    for mat in (dense, sparse):
        w = BitWriter()
        _encode_counts(w, mat)
        out = _decode_counts(BitReader(w.getvalue()), mat.shape)
        np.testing.assert_allclose(out, mat)


def _assert_rejected(data):
    for vectorized in (True, False):
        with pytest.raises(storage.IntegrityError):
            storage.decode(data, vectorized=vectorized)
    with pytest.raises(storage.IntegrityError):
        storage.blob_info(data)


def test_corruption_bit_flips_rejected(port_synopsis):
    blob = storage.encode(port_synopsis)
    rng = np.random.default_rng(42)
    positions = list(range(12)) + sorted(
        int(p) for p in rng.integers(12, len(blob), 48))
    for pos in positions:
        bad = bytearray(blob)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        _assert_rejected(bytes(bad))


def test_corruption_truncations_rejected(port_synopsis):
    blob = storage.encode(port_synopsis)
    rng = np.random.default_rng(43)
    cuts = list(range(13)) + sorted(
        int(c) for c in rng.integers(13, len(blob), 24))
    for cut in cuts:
        _assert_rejected(blob[:cut])


def test_corruption_garbage_tails_rejected(port_synopsis):
    blob = storage.encode(port_synopsis)
    rng = np.random.default_rng(44)
    for n_tail in (1, 7, 64, 4096):
        tail = rng.integers(0, 256, n_tail, dtype=np.uint8).tobytes()
        _assert_rejected(blob + tail)
    _assert_rejected(b"")
    _assert_rejected(b"NOPE" + bytes(16))


def test_corruption_legacy_truncation_rejected(port_synopsis):
    raw = storage.encode(port_synopsis, framed=False)
    assert storage.decode(raw).n_rows == port_synopsis.n_rows
    rng = np.random.default_rng(45)
    for cut in sorted(int(c) for c in rng.integers(4, len(raw) - 1, 16)):
        for vectorized in (True, False):
            with pytest.raises(storage.IntegrityError):
                storage.decode(raw[:cut], vectorized=vectorized)


def test_framed_blob_info_reports_frame(port_synopsis):
    framed = storage.encode(port_synopsis)
    raw = storage.encode(port_synopsis, framed=False)
    assert storage.blob_info(framed)["framed"] is True
    assert storage.blob_info(raw)["framed"] is False
    assert len(framed) == len(raw) + 12
    assert framed[12:] == raw
