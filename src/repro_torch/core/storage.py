"""Compact synopsis storage encoding (§4.3, Fig. 6, Eq. 11–13).

Re-derivable quantities (bin midpoints c, weighted-centre bounds c±, slice
totals h = H row/column sums, fold maps) are NOT stored. Counts matrices are
stored dense (ℓ_h bits per cell, Eq. 13) or sparse (Golomb–Rice-coded deltas
of non-zero flat indices + ℓ_h-bit counts), whichever is smaller, with a
1-bit flag per histogram — exactly the paper's scheme.

Values (edges / extrema) are integers in the pre-processed domain; edges
gain dyadic fractions from midpoint splits, so each edge array is encoded as
zig-zag varint numerators over a shared power-of-two denominator.

Everything is bit-level (BitWriter/BitReader below); decode reconstructs a
full runtime ``PairwiseHist`` (centre bounds recomputed via Eq. 10).
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from repro_torch.core import chi2 as chi2lib
from repro_torch.core.types import (BuildParams, ColumnInfo, Hist1D, PairHist,
                                    PairwiseHist)

_MAGIC = b"PWH1"
_FRAME_MAGIC = b"PWF1"


class IntegrityError(ValueError):
    """Typed blob-integrity failure: corrupt, truncated, or mangled synopsis.

    Raised by ``decode``/``blob_info`` whenever the integrity frame fails
    verification (checksum mismatch, length mismatch, bad magic) or the
    payload bit-stream turns out to be structurally inconsistent mid-parse.
    Subclasses ``ValueError`` so pre-frame callers that caught ``ValueError``
    keep working. A corrupted blob always raises this — never returns wrong
    data, never hangs.
    """


def _crc32(payload: bytes) -> int:
    # zlib.crc32 (CRC-32/ISO-HDLC) runs in C and needs no new dependency;
    # CRC32C (Castagnoli) is a drop-in here if a native impl lands later.
    return zlib.crc32(payload) & 0xFFFFFFFF


def frame_blob(payload: bytes) -> bytes:
    """Wrap an encoded synopsis stream in the integrity frame.

    Layout: 4-byte frame magic, little-endian u32 payload length,
    little-endian u32 CRC-32 of the payload, then the payload itself.
    12 bytes of overhead per blob; verified by ``unframe_blob`` before any
    bit-level parsing touches the stream.
    """
    return _FRAME_MAGIC + struct.pack("<II", len(payload), _crc32(payload)) \
        + payload


def unframe_blob(data: bytes) -> bytes:
    """Verify and strip the integrity frame; returns the raw payload.

    Framed blobs are checked length-then-checksum and any mismatch raises
    ``IntegrityError``. Legacy unframed streams (leading with the payload
    magic ``PWH1``) pass through unchanged so pre-frame blobs stay
    readable — they simply do not get the checksum guarantee.
    """
    head = bytes(data[:4])
    if head == _FRAME_MAGIC:
        if len(data) < 12:
            raise IntegrityError("truncated synopsis frame header")
        n, crc = struct.unpack("<II", data[4:12])
        payload = bytes(data[12:])
        if len(payload) != n:
            raise IntegrityError(
                f"synopsis frame length mismatch: header says {n} payload "
                f"bytes, got {len(payload)}")
        if _crc32(payload) != crc:
            raise IntegrityError("synopsis frame checksum mismatch")
        return payload
    if head == _MAGIC:
        return bytes(data)
    raise IntegrityError("bad synopsis magic")


# ---------------------------------------------------------------------------
# Bit-level IO
# ---------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self.acc = (self.acc << nbits) | value
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_varint(self, value: int):
        """Unsigned bit-level LEB128 (7-bit chunks + continuation bit)."""
        v = int(value)
        if v < 0:
            raise ValueError("varint is unsigned")
        while True:
            chunk = v & 0x7F
            v >>= 7
            self.write(1 if v else 0, 1)
            self.write(chunk, 7)
            if not v:
                break

    def write_svarint(self, value: int):
        """Zig-zag signed varint (arbitrary-precision safe).

        Python ints are unbounded, so the classic C idiom
        ``(v << 1) ^ (v >> 63)`` silently corrupts ``|v| >= 2**63`` (the
        arithmetic shift is no longer a sign smear). The branchy zig-zag
        below is exact for every int and emits identical bits for the
        64-bit range the old encoding handled correctly.
        """
        v = int(value)
        self.write_varint(v << 1 if v >= 0 else ((-v) << 1) - 1)

    def write_run(self, values, nbits: int):
        """Write ``len(values)`` fields of ``nbits`` bits each — bit-for-bit
        the loop ``for v in values: write(v, nbits)``, but large runs pack
        through one vectorized ``np.packbits`` instead of the per-value
        accumulator (the dense-counts encode hot path)."""
        arr = np.asarray(values, np.int64).reshape(-1)
        n = arr.size
        if nbits == 0 or n == 0:
            return
        if n * nbits < 512 or nbits > 62:
            for v in arr:
                self.write(int(v), nbits)
            return
        arr = arr & ((np.int64(1) << nbits) - np.int64(1))
        bits = ((arr[:, None] >> np.arange(nbits - 1, -1, -1)) & 1) \
            .astype(np.uint8).reshape(-1)
        if self.nbits:      # prepend the pending sub-byte accumulator bits
            pend = np.array([(self.acc >> (self.nbits - 1 - i)) & 1
                             for i in range(self.nbits)], np.uint8)
            bits = np.concatenate([pend, bits])
        whole = (bits.size // 8) * 8
        self.buf.extend(np.packbits(bits[:whole]).tobytes())
        acc = 0
        for bit in bits[whole:]:
            acc = (acc << 1) | int(bit)
        self.acc = acc
        self.nbits = bits.size - whole

    def write_rice(self, value: int, b: int):
        """Golomb–Rice with divisor 2**b: quotient unary + b-bit remainder."""
        q = int(value) >> b
        for _ in range(q):
            self.write(1, 1)
        self.write(0, 1)
        self.write(int(value) & ((1 << b) - 1), b)

    def write_f64(self, value: float):
        for byte in struct.pack("<d", float(value)):
            self.write(byte, 8)

    def getvalue(self) -> bytes:
        out = bytearray(self.buf)
        if self.nbits:
            out.append((self.acc << (8 - self.nbits)) & 0xFF)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read(self, nbits: int) -> int:
        out = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            bit = (byte >> (7 - (self.pos & 7))) & 1
            out = (out << 1) | bit
            self.pos += 1
        return out

    def read_varint(self) -> int:
        shift, out = 0, 0
        while True:
            cont = self.read(1)
            chunk = self.read(7)
            out |= chunk << shift
            shift += 7
            if not cont:
                return out

    def read_svarint(self) -> int:
        z = self.read_varint()
        return (z >> 1) if (z & 1) == 0 else -((z + 1) >> 1)

    def read_rice(self, b: int) -> int:
        q = 0
        while self.read(1):
            q += 1
        return (q << b) | self.read(b)

    def read_f64(self) -> float:
        raw = bytes(self.read(8) for _ in range(8))
        return struct.unpack("<d", raw)[0]

    # Bulk (run) reads. The base-class implementations are the plain loops —
    # the oracle the vectorized FastBitReader is asserted against bit for
    # bit; the decode paths below call only these run methods so both
    # readers share one traversal of the stream layout.

    def read_bytes(self, n: int) -> bytes:
        """``n`` bytes at the current (arbitrary) bit alignment."""
        return bytes(self.read(8) for _ in range(n))

    def read_uint_run(self, n: int, nbits: int) -> np.ndarray:
        """``n`` unsigned ``nbits``-bit fields -> int64 array."""
        return np.array([self.read(nbits) for _ in range(n)], np.int64)

    def read_varint_run(self, n: int) -> np.ndarray:
        """``n`` consecutive varints -> int64 array."""
        return np.array([self.read_varint() for _ in range(n)], np.int64)

    def read_svarint_run(self, n: int) -> np.ndarray:
        """``n`` consecutive zig-zag varints -> int64 array."""
        return np.array([self.read_svarint() for _ in range(n)], np.int64)

    def read_rice_run(self, n: int, b: int) -> np.ndarray:
        """``n`` consecutive Golomb-Rice values -> int64 array."""
        return np.array([self.read_rice(b) for _ in range(n)], np.int64)


class FastBitReader(BitReader):
    """Vectorized drop-in for ``BitReader`` (same stream, same results).

    Decoding cost on a cold-start blob is dominated by long homogeneous
    runs — dense ``l_h``-bit count blocks, non-zero value runs, Rice-coded
    delta runs, varint/svarint arrays. The base class walks those one *bit*
    at a time in Python; this subclass unpacks the whole blob into a bit
    array once (``np.unpackbits``, MSB-first — exactly the writer's order)
    and decodes each run with reshape/dot numpy passes:

      * fixed-width runs: an ``(n, nbits)`` gather @ a power-of-two vector;
      * varint runs: LEB128 chunks are a whole byte of stream each, so a
        run is chunk-aligned from its start — continuation bits land on a
        stride-8 slice, value boundaries fall out of ``flatnonzero``, and
        payload chunks fold with shifted ``np.add.reduceat``;
      * Rice runs: a vectorized unary scan — zero positions in a window,
        each value's terminator found by successor-pointer doubling
        (``searchsorted`` jump table), quotients from position gaps.

    Scalar reads use byte-sliced ``int.from_bytes`` instead of the per-bit
    loop. Runs that could overflow int64 (fields > 62 bits, varints past 9
    chunks) fall back to the exact scalar loop. Bit-for-bit equivalence
    with the oracle is asserted in tests/test_storage_vectorized.py.
    """

    def __init__(self, data: bytes):
        super().__init__(data)
        self._bits = np.unpackbits(np.frombuffer(data, np.uint8))

    # ------------------------------------------------------------- scalar IO

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        pos = self.pos
        end = pos + nbits
        last = (end + 7) >> 3
        if last > len(self.data):
            # A short slice would zero-pad and silently return wrong data
            # on truncated streams; fail like the oracle reader instead.
            raise IndexError("bit read overruns the synopsis stream")
        chunk = int.from_bytes(self.data[pos >> 3:last], "big")
        self.pos = end
        return (chunk >> ((-end) & 7)) & ((1 << nbits) - 1)

    def read_bytes(self, n: int) -> bytes:
        """``n`` bytes at the current (arbitrary) bit alignment."""
        if n == 0:
            return b""
        if (self.pos & 7) == 0:          # aligned: direct slice
            start = self.pos >> 3
            if start + n > len(self.data):
                raise IndexError("byte read overruns the synopsis stream")
            self.pos += 8 * n
            return bytes(self.data[start:start + n])
        return self.read_uint_run(n, 8).astype(np.uint8).tobytes()

    # --------------------------------------------------------------- run IO

    def read_uint_run(self, n: int, nbits: int) -> np.ndarray:
        """``n`` unsigned ``nbits``-bit fields -> int64 array (vectorized)."""
        if n == 0:
            return np.zeros(0, np.int64)
        if nbits == 0:
            return np.zeros(n, np.int64)
        if nbits > 62:                   # int64 headroom: exact scalar path
            return super().read_uint_run(n, nbits)
        pos = self.pos
        field = self._bits[pos:pos + n * nbits].astype(np.int64)
        field = field.reshape(n, nbits)
        weights = np.int64(1) << np.arange(nbits - 1, -1, -1, dtype=np.int64)
        self.pos = pos + n * nbits
        return field @ weights

    def read_varint_run(self, n: int) -> np.ndarray:
        """``n`` consecutive varints -> int64 array (vectorized)."""
        if n == 0:
            return np.zeros(0, np.int64)
        pos = self.pos
        bits = self._bits
        max_chunks = (bits.size - pos) >> 3
        cont = bits[pos:pos + 8 * max_chunks:8]
        ends = np.flatnonzero(cont == 0)
        if ends.size < n:
            raise ValueError("varint run overruns the stream")
        ends = ends[:n]
        starts = np.empty(n, np.int64)
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
        if int((ends - starts).max()) + 1 > 9:
            # 9 chunks (9 * 7 = 63 payload bits) is exactly the int64 range;
            # a 10-chunk varint cannot land in the run's int64 array (the
            # scalar oracle overflows identically, just less legibly).
            raise OverflowError(
                "varint run value exceeds int64; run reads carry int64 arrays")
        total = int(ends[-1]) + 1
        payload = bits[pos:pos + 8 * total].astype(np.int64).reshape(total, 8)
        w7 = np.int64(1) << np.arange(6, -1, -1, dtype=np.int64)
        chunk_vals = payload[:, 1:] @ w7
        shifts = np.arange(total, dtype=np.int64) - np.repeat(
            starts, ends - starts + 1)
        self.pos = pos + 8 * total
        return np.add.reduceat(chunk_vals << (7 * shifts), starts)

    def read_svarint_run(self, n: int) -> np.ndarray:
        """``n`` consecutive zig-zag varints -> int64 array (vectorized)."""
        z = self.read_varint_run(n)
        # -(z >> 1) - 1 (not -((z + 1) >> 1)) so z = 2**63 - 1 cannot
        # overflow int64 before the negation.
        return np.where(z & 1, -(z >> 1) - 1, z >> 1)

    def read_rice_run(self, n: int, b: int) -> np.ndarray:
        """``n`` consecutive Golomb-Rice values -> int64 array.

        Vectorized unary scan: find the zero bits in a window, build a
        successor jump table (``searchsorted``: terminator -> next
        terminator ``1 + b`` bits later at the earliest), extract the chain
        of ``n`` terminators by pointer doubling, then quotients are
        position gaps and remainders a fixed-width gather. The window grows
        (rare: outlier quotients) until the chain fits.
        """
        if n == 0:
            return np.zeros(0, np.int64)
        pos = self.pos
        bits = self._bits
        window = max(1024, n * (b + 8))
        while True:
            zw = np.flatnonzero(bits[pos:pos + window] == 0)
            term = self._rice_chain(zw, n, b)
            if term is not None:
                break
            if pos + window >= bits.size:
                raise ValueError("rice run overruns the stream")
            window *= 4
        term = term + pos                   # absolute terminator positions
        prev_end = np.empty(n, np.int64)
        prev_end[0] = pos
        prev_end[1:] = term[:-1] + 1 + b
        q = term - prev_end
        if b:                               # remainders trail each terminator
            gather = term[:, None] + 1 + np.arange(b, dtype=np.int64)
            weights = np.int64(1) << np.arange(b - 1, -1, -1, dtype=np.int64)
            rem = bits[gather].astype(np.int64) @ weights
        else:
            rem = np.zeros(n, np.int64)
        self.pos = int(term[-1]) + 1 + b
        return (q << b) | rem

    @staticmethod
    def _rice_chain(zw: np.ndarray, n: int, b: int):
        """First ``n`` Rice terminators among window zeros ``zw`` (relative
        positions), or None if the window is too small. Successor-pointer
        doubling: O(log n) numpy passes instead of a per-value loop."""
        nz = zw.size
        if nz == 0:
            return None
        # succ[k]: index of the first zero >= zw[k] + 1 + b (the earliest
        # possible next terminator); nz = exhausted sentinel (maps to self).
        succ = np.empty(nz + 1, np.int64)
        succ[:nz] = np.searchsorted(zw, zw + 1 + b)
        succ[nz] = nz
        chain = np.empty(n, np.int64)
        chain[0] = 0                        # first zero in window terminates v0
        filled = 1
        jump = succ                         # jump == succ^filled
        while filled < n:
            take = min(filled, n - filled)
            chain[filled:filled + take] = jump[chain[:take]]
            filled += take
            if filled < n:
                jump = jump[jump]
        if int(chain[-1]) >= nz:            # ran off the window: grow it
            return None
        return zw[chain]


# ---------------------------------------------------------------------------
# Edge / value array codecs
# ---------------------------------------------------------------------------


def _dyadic_exponent(arr: np.ndarray, cap: int = 40) -> int | None:
    """Smallest p such that arr * 2^p is integral (None if > cap)."""
    a = np.asarray(arr, np.float64)
    for p in range(cap + 1):
        scaled = a * (1 << p)
        if np.all(np.abs(scaled - np.round(scaled)) < 1e-6) and \
           np.all(np.abs(scaled) < 2**62):
            return p
    return None


def _encode_values(w: BitWriter, arr: np.ndarray):
    """Dyadic-rational array as (flag, p, varint deltas); f64 fallback."""
    arr = np.asarray(arr, np.float64)
    p = _dyadic_exponent(arr)
    if p is None:
        w.write(1, 1)
        for v in arr:
            w.write_f64(v)
        return
    w.write(0, 1)
    w.write_varint(p)
    ints = np.round(arr * (1 << p)).astype(np.int64)
    prev = 0
    for v in ints:
        w.write_svarint(int(v) - prev)
        prev = int(v)


def _decode_values(r: BitReader, n: int) -> np.ndarray:
    if r.read(1):
        return np.array([r.read_f64() for _ in range(n)], np.float64)
    p = r.read_varint()
    out = np.cumsum(r.read_svarint_run(n))
    return out.astype(np.float64) / (1 << p)


def _bits_for(max_val: float) -> int:
    """ℓ_h per Eq. 13."""
    return max(1, int(math.ceil(math.log2(1.0 + max(0.0, float(max_val))))))


def _rice_param(mean: float) -> int:
    """Near-optimal Rice divisor exponent for geometric-ish deltas."""
    if mean <= 1.0:
        return 0
    return max(0, int(round(math.log2(mean))))


def _encode_counts(w: BitWriter, H: np.ndarray):
    """Dense (ℓ_h bits/cell) vs sparse (Rice deltas + ℓ_h counts): smaller wins."""
    flat = np.asarray(np.round(H), np.int64).reshape(-1)
    n = flat.size
    lh = _bits_for(flat.max() if n else 0)
    nz = np.flatnonzero(flat)
    theta = nz.size
    dense_bits = n * lh
    mean_delta = (n / max(theta, 1))
    b = _rice_param(mean_delta)
    deltas = np.diff(nz, prepend=-1) - 1  # gaps between non-zeros
    sparse_bits = 32 + theta * lh + int(((deltas >> b) + 1 + b).sum())
    w.write_varint(lh)
    if dense_bits <= sparse_bits:
        w.write(0, 1)  # I_h: dense
        w.write_run(flat, lh)
    else:
        w.write(1, 1)  # I_h: sparse
        w.write_varint(theta)
        w.write_varint(b)
        for d in deltas:
            w.write_rice(int(d), b)
        w.write_run(flat[nz], lh)


def _decode_counts(r: BitReader, shape) -> np.ndarray:
    n = int(np.prod(shape))
    lh = r.read_varint()
    if r.read(1) == 0:
        flat = r.read_uint_run(n, lh)
    else:
        theta = r.read_varint()
        b = r.read_varint()
        idxs = np.cumsum(r.read_rice_run(theta, b) + 1) - 1
        flat = np.zeros(n, np.int64)
        flat[idxs] = r.read_uint_run(theta, lh)
    return flat.astype(np.float64).reshape(shape)


# ---------------------------------------------------------------------------
# Histogram codecs
# ---------------------------------------------------------------------------


def _encode_dim(w: BitWriter, edges, u, vmin, vmax):
    k = len(u)
    w.write_varint(k)
    _encode_values(w, edges)
    _encode_values(w, vmin)
    _encode_values(w, vmax)
    for val in np.asarray(u, np.int64):
        w.write_varint(int(val))


def _decode_dim(r: BitReader):
    k = r.read_varint()
    edges = _decode_values(r, k + 1)
    vmin = _decode_values(r, k)
    vmax = _decode_values(r, k)
    u = r.read_varint_run(k).astype(np.float64)
    return edges, u, vmin, vmax


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


def encode(ph: PairwiseHist, framed: bool = True) -> bytes:
    """Serialize ``ph`` to a synopsis blob.

    By default the bit-stream is wrapped in the CRC integrity frame
    (``frame_blob``); pass ``framed=False`` for the raw legacy stream.
    """
    payload = _encode_payload(ph)
    return frame_blob(payload) if framed else payload


def _encode_payload(ph: PairwiseHist) -> bytes:
    w = BitWriter()
    for byte in _MAGIC:
        w.write(byte, 8)
    w.write_varint(ph.n_rows)
    w.write_varint(ph.n_sampled)
    w.write_varint(ph.d)
    w.write_varint(ph.params.min_points)
    w.write_f64(ph.params.alpha)
    w.write_varint(ph.params.s1_max)
    w.write_varint(ph.params.s2_max)

    for col in ph.columns:
        kind_code = {"int": 0, "float": 1, "categorical": 2}[col.kind]
        w.write(kind_code, 2)
        w.write_f64(col.offset)
        w.write_f64(col.scale)
        w.write_f64(col.mu)
        w.write_varint(col.n_null)
        name = col.name.encode()
        w.write_varint(len(name))
        for byte in name:
            w.write(byte, 8)
        cats = "\x00".join(str(c) for c in col.categories).encode()
        w.write_varint(len(cats))
        for byte in cats:
            w.write(byte, 8)

    for hist in ph.hists:
        _encode_dim(w, hist.edges, hist.u, hist.vmin, hist.vmax)
        _encode_counts(w, hist.h)

    w.write_varint(len(ph.pairs))
    for (i, j), pr in sorted(ph.pairs.items()):
        w.write_varint(i)
        w.write_varint(j)
        _encode_dim(w, pr.ex, pr.ux, pr.vminx, pr.vmaxx)
        _encode_dim(w, pr.ey, pr.uy, pr.vminy, pr.vmaxy)
        _encode_counts(w, pr.H)
    return w.getvalue()


def _centre_bounds_np(h, u, vmin, vmax, min_points, crit_table, mu, s_max):
    """NumPy re-derivation of Eq. 10 (mirror of refine.centre_bounds)."""
    h = np.asarray(h, float)
    u = np.asarray(u, float)
    s = np.clip(np.ceil(np.cbrt(2.0 * np.maximum(u, 0.0))), 1, s_max)
    delta = (vmax - vmin) / np.maximum(s, 1.0)
    chi = crit_table[np.clip(s.astype(int), 0, len(crit_table) - 1)]
    chi = np.where(np.isfinite(chi), chi, 0.0)
    hsafe = np.maximum(h, 1.0)
    spread = (delta / 6.0) * np.sqrt(3.0 * chi * (s**2 - 1.0) / hsafe)
    c_lo_pass = vmin + (s - 1.0) * delta / 2.0 - spread
    c_hi_pass = vmin + (s + 1.0) * delta / 2.0 + spread
    shift = (u - 1.0) * u * mu / (2.0 * hsafe)
    fail = h < min_points
    cminus = np.where(fail, vmin + shift, c_lo_pass)
    cplus = np.where(fail, vmax - shift, c_hi_pass)
    mid = 0.5 * (vmin + vmax)
    degenerate = u <= 1.0
    cminus = np.where(degenerate, mid, cminus)
    cplus = np.where(degenerate, mid, cplus)
    cminus = np.clip(cminus, vmin, vmax)
    cplus = np.clip(cplus, cminus, vmax)
    return cminus, cplus


def decode(data: bytes, vectorized: bool = True) -> PairwiseHist:
    """Reconstruct the runtime ``PairwiseHist`` from an encoded blob.

    ``vectorized=True`` (default) decodes through ``FastBitReader`` —
    numpy bulk passes over the long homogeneous runs, >=10x faster on
    real synopses. ``vectorized=False`` walks the identical stream with
    the pure-Python ``BitReader`` oracle; the two are bit-for-bit equal
    (asserted in tests/test_storage_vectorized.py).

    The integrity frame (when present) is verified *before* any bit-level
    parsing, and structural parse failures are re-raised as
    ``IntegrityError`` — a corrupted blob raises a typed error rather than
    returning wrong data or hanging.
    """
    payload = unframe_blob(data)
    try:
        return _decode_payload(payload, vectorized)
    except IntegrityError:
        raise
    except (ValueError, IndexError, KeyError, OverflowError, MemoryError,
            UnicodeDecodeError, struct.error) as exc:
        raise IntegrityError(f"corrupt synopsis stream: {exc!r}") from exc


def _decode_payload(data: bytes, vectorized: bool) -> PairwiseHist:
    r = (FastBitReader if vectorized else BitReader)(data)
    magic = r.read_bytes(4)
    if magic != _MAGIC:
        raise IntegrityError("bad synopsis magic")
    n_rows = r.read_varint()
    n_sampled = r.read_varint()
    d = r.read_varint()
    min_points = r.read_varint()
    alpha = r.read_f64()
    s1_max = r.read_varint()
    s2_max = r.read_varint()
    params = BuildParams(n_samples=n_sampled, alpha=alpha,
                         m_frac=min_points / max(n_sampled, 1),
                         s1_max=s1_max, s2_max=s2_max)
    crit = chi2lib.build_crit_table(alpha, max(s1_max, s2_max))

    columns = []
    for _ in range(d):
        kind = ("int", "float", "categorical")[r.read(2)]
        offset = r.read_f64()
        scale = r.read_f64()
        mu = r.read_f64()
        n_null = r.read_varint()
        nlen = r.read_varint()
        name = r.read_bytes(nlen).decode()
        clen = r.read_varint()
        raw = r.read_bytes(clen).decode()
        cats = tuple(raw.split("\x00")) if raw else ()
        columns.append(ColumnInfo(name=name, kind=kind, offset=offset,
                                  scale=scale, categories=cats,
                                  n_null=n_null, mu=mu))

    hists = []
    for i in range(d):
        edges, u, vmin, vmax = _decode_dim(r)
        h = _decode_counts(r, (len(u),))
        c = 0.5 * (vmin + vmax)
        cm, cp = _centre_bounds_np(h, u, vmin, vmax, min_points, crit,
                                   columns[i].mu, s1_max)
        hists.append(Hist1D(edges=edges, k=np.int32(len(u)), h=h, u=u,
                            vmin=vmin, vmax=vmax, c=c, cminus=cm, cplus=cp))

    def fold_map(edges1, edges_pair):
        """1-D bin -> containing pair row (pair edges ⊆ 1-D edges)."""
        mids = 0.5 * (edges1[:-1] + edges1[1:])
        idx = np.searchsorted(edges_pair, mids, side="right") - 1
        return np.clip(idx, 0, max(edges_pair.size - 2, 0)).astype(np.int32)

    pairs = {}
    n_pairs = r.read_varint()
    for _ in range(n_pairs):
        i = r.read_varint()
        j = r.read_varint()
        ex, ux, vminx, vmaxx = _decode_dim(r)
        ey, uy, vminy, vmaxy = _decode_dim(r)
        H = _decode_counts(r, (len(ux), len(uy)))
        pairs[(i, j)] = PairHist(
            ex=ex, ey=ey, kx=np.int32(len(ux)), ky=np.int32(len(uy)), H=H,
            hx=H.sum(1), ux=ux, vminx=vminx, vmaxx=vmaxx,
            hy=H.sum(0), uy=uy, vminy=vminy, vmaxy=vmaxy,
            fold_x=fold_map(hists[i].edges, ex),
            fold_y=fold_map(hists[j].edges, ey),
        )

    return PairwiseHist(params=params, n_rows=n_rows, n_sampled=n_sampled,
                        columns=columns, hists=hists, pairs=pairs,
                        chi2_table=crit)


def blob_info(data: bytes) -> dict:
    """Cheap header peek: {bytes, n_rows, n_sampled, d} without full decode.

    Reads only the fixed-size preamble, so the cold catalog can report
    synopsis-bytes telemetry for registered blobs it has not decoded yet.
    Framed blobs are checksum-verified first; corruption raises
    ``IntegrityError``.
    """
    payload = unframe_blob(data)
    try:
        r = BitReader(payload)
        magic = r.read_bytes(4)
        if magic != _MAGIC:
            raise IntegrityError("bad synopsis magic")
        return {
            "bytes": len(data),
            "framed": bytes(data[:4]) == _FRAME_MAGIC,
            "n_rows": r.read_varint(),
            "n_sampled": r.read_varint(),
            "d": r.read_varint(),
        }
    except IntegrityError:
        raise
    except (ValueError, IndexError, OverflowError, struct.error) as exc:
        raise IntegrityError(f"corrupt synopsis header: {exc!r}") from exc


def eq12_bound(ph: PairwiseHist) -> int:
    """The paper's storage upper bound (Eq. 12), in bytes, for comparison."""
    d = ph.d

    def mbytes(col_idx):
        hist = ph.hists[col_idx]
        vmax = max(abs(float(hist.vmax.max() if len(hist.vmax) else 1)), 1.0)
        return max(1, int(math.ceil(math.log2(vmax + 2) / 8)))

    total = 29 + d + 4 * d * d
    for i in range(d):
        k_sum = 0
        for j in range(d):
            if i == j:
                continue
            pr = ph.pair(i, j)
            k_sum += int(pr.kx)
        k_i = int(ph.hists[i].k)
        total += (3 * mbytes(i) + 4) * (k_sum + k_i - (d - 1) * k_i + k_i)
    for (i, j), pr in ph.pairs.items():
        lh = _bits_for(pr.H.max() if pr.H.size else 0)
        total += math.ceil(int(pr.kx) * int(pr.ky) * lh / 8)
    return total


def synopsis_size_report(ph: PairwiseHist) -> dict:
    """Encoded size breakdown (bytes)."""
    blob = encode(ph)
    # Re-encode pieces for a rough breakdown.
    w = BitWriter()
    for hist in ph.hists:
        _encode_dim(w, hist.edges, hist.u, hist.vmin, hist.vmax)
        _encode_counts(w, hist.h)
    size_1d = len(w.getvalue())
    w = BitWriter()
    for pr in ph.pairs.values():
        _encode_dim(w, pr.ex, pr.ux, pr.vminx, pr.vmaxx)
        _encode_dim(w, pr.ey, pr.uy, pr.vminy, pr.vmaxy)
        _encode_counts(w, pr.H)
    size_2d = len(w.getvalue())
    return {
        "total": len(blob),
        "hists_1d": size_1d,
        "hists_2d": size_2d,
        "header_and_dicts": len(blob) - size_1d - size_2d,
        "eq12_bound": eq12_bound(ph),
    }
