"""First-party AV1 entropy core: MSAC coder, bit writer, OBU framing.

This is the entropy layer of the in-process AV1 intra encoder
(av1_intra.py) — the component the reference gets from rav1e via the
`image` crate's AvifEncoder (reference src/transform.rs:138-146).  The
arithmetic coder implements the AV1 spec's symbol coding process
(spec 8.2: 15-bit inverse-CDF multiply-free range coder, EC_PROB_SHIFT=6,
EC_MIN_PROB=4) — the same process libaom's od_ec / dav1d's msac
implement.  The encoder keeps `low` as an arbitrary-precision integer,
which makes carry propagation trivial (no pre-carry buffers); the final
stream is the bitwise complement of the chosen code value, because the
spec's decoder stores its window complemented (spec 8.2.2 init_symbol).

Default CDF tables come from av1_tables.npz — see
tools/extract_av1_tables.py for the cross-validated extraction.

All streams are encoded with disable_cdf_update=1, so CDFs stay at the
spec defaults for the whole frame and no adaptation state is needed on
either side.

The port's copy of ``imagekit_tpu/codecs/av1_entropy.py`` (and of its
``av1_tables.npz``), unchanged.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_TABLES_PATH = os.path.join(os.path.dirname(__file__), "av1_tables.npz")

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4


@lru_cache(maxsize=1)
def tables() -> dict:
    """Load the extracted default tables (numpy arrays, cached once)."""
    raw = np.load(_TABLES_PATH)
    return {k: raw[k] for k in raw.files}


# ---------------------------------------------------------------------------
# MSAC


def _interval(rng: int, f: int, pos_from_end: int) -> int:
    """The spec's interval boundary for an ICDF value f (spec 8.2.6)."""
    return ((rng >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
        + EC_MIN_PROB * pos_from_end


class MsacEncoder:
    """Arbitrary-precision MSAC encoder in libaom od_ec's DIRECT domain:
    `low` is the bottom edge of the interval measured in raw stream
    value space (symbol 0 occupies the TOP of each range, so coding it
    leaves `low` unchanged), and the emitted bytes ARE a value inside
    the final interval — no complement anywhere.  Verified byte-exact
    against libaom's own tile output for 40+ symbol streams
    (tools/av1_validate.py)."""

    def __init__(self):
        self.low = 0
        self.rng = 0x8000
        self.nbits = 15  # the decoder consumes 15 bits at init

    def encode_symbol(self, sym: int, icdf, n: int) -> None:
        """Encode `sym` in 0..n-1 against icdf (>= n-1 ICDF values)."""
        r = self.rng
        u = r if sym == 0 else _interval(r, int(icdf[sym - 1]), n - sym)
        f = 0 if sym == n - 1 else int(icdf[sym])
        v = _interval(r, f, n - 1 - sym)
        # od_ec_encode_q15: l += r - u; r = u - v
        self.low += r - u
        rng = u - v
        # renormalize to [0x8000, 0xFFFF]
        while rng < 0x8000:
            rng <<= 1
            self.low <<= 1
            self.nbits += 1
        self.rng = rng

    def encode_literal(self, value: int, bits: int) -> None:
        """Bypass bits, MSB first (each an equiprobable symbol)."""
        for i in range(bits - 1, -1, -1):
            self.encode_symbol((value >> i) & 1, _HALF_ICDF, 2)

    def encode_golomb(self, value: int) -> None:
        """Exp-Golomb of `value` (spec read_golomb: x-1 with x >= 1)."""
        x = value + 1
        length = x.bit_length()
        self.encode_literal(0, length - 1)
        self.encode_literal(x, length)

    def encode_symbol_adapt(self, sym: int, cdf, n: int) -> None:
        """Symbol + spec 8.3.2 CDF update (rows are mutable
        [icdf 0..n-2, 0, count] arrays)."""
        self.encode_symbol(sym, cdf, n)
        update_cdf(cdf, sym, n)

    def save(self):
        """Opaque state token for trial coding (restore via load)."""
        return (self.low, self.rng, self.nbits)

    def load(self, tok) -> None:
        self.low, self.rng, self.nbits = tok

    def done(self) -> bytes:
        """Terminate exactly as libaom's od_ec_enc_done does: round `low`
        up to the next multiple of 2^14 and set bit 14
        (``e = ((low + 0x3FFF) & ~0x3FFF) | 0x4000``), then emit the top
        ``nbits - 14`` bits, left-aligned and zero-padded to a byte
        boundary.  Since ``e <= low + 0x7FFF < low + rng`` the chosen
        value is always strictly inside the final interval, and a decoder
        that synthesizes stream-zeros past end-of-buffer (dav1d-measured
        behavior) reads back exactly ``e``.  Pinned byte-identical to
        libaom tile output across the full Rosetta corpus
        (tools/av1_rosetta.py) — this is the ecosystem's de-facto
        termination contract, so do not substitute a different interior
        choice without re-running tools/av1_validate.py."""
        e = ((self.low + 0x3FFF) & ~0x3FFF) | 0x4000
        keep = self.nbits - 14           # bits that reach the stream
        if keep <= 0:
            return b"\x40"               # degenerate empty-stream case
        nbytes = (keep + 7) // 8
        stream_val = (e >> 14) << (nbytes * 8 - keep)  # left-align
        return stream_val.to_bytes(nbytes, "big")


_HALF_ICDF = (1 << 14,)


def update_cdf(cdf, sym: int, n: int) -> None:
    """Spec 8.3.2 / dav1d update rule (ICDF domain): entries below the
    coded symbol move toward 32768 (floor shift), entries at/above it
    decay toward 0 — BOTH sides use a floor shift of the positive
    quantity (the single-expression (tmp-v)>>rate form rounds the decay
    side up and desyncs dav1d within a handful of repeated symbols —
    pinned by the adaptive probe trace); rate = 3 + (count>15) +
    (count>31) + (1 if n<=3 else 2) — dav1d's 4+(count>>4)+(nsym>2)
    under its size=n-1 convention — and count saturates at 32."""
    count = int(cdf[n])
    rate = 3 + (count > 15) + (count > 31) + (1 if n <= 3 else 2)
    for i in range(n - 1):
        v = int(cdf[i])
        if i < sym:
            cdf[i] = v + ((32768 - v) >> rate)   # grow: floor
        else:
            cdf[i] = v - (v >> rate)             # decay: floor, NOT the
            #                                      arithmetic-shift ceil
    cdf[n] = count + (count < 32)


class _NativeTok:
    """Owned clone handle returned by NativeMsacEncoder.save()."""

    __slots__ = ("_lib", "h")

    def __init__(self, lib, h):
        self._lib = lib
        self.h = h

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self._lib.ik_msac_free(self.h)
        except Exception:
            pass


class NativeMsacEncoder:
    """C-backed MsacEncoder twin (native/av1_enc.cpp): byte-exact with
    the Python encoder (equality pinned in tests/test_av1_native.py) and
    O(1) snapshot/restore — the RD search's trial mechanism.  Only
    constructed when native/av1_abi.py loads; same public surface."""

    __slots__ = ("_lib", "_h")

    def __init__(self, lib):
        import ctypes

        self._lib = lib
        self._h = ctypes.c_void_p(lib.ik_msac_new())

    def __del__(self):  # pragma: no cover - interpreter teardown order
        try:
            self._lib.ik_msac_free(self._h)
        except Exception:
            pass

    @property
    def nbits(self) -> int:
        return self._lib.ik_msac_nbits(self._h)

    def encode_symbol(self, sym: int, icdf, n: int) -> None:
        if not (isinstance(icdf, np.ndarray) and icdf.dtype == np.uint16
                and icdf.flags["C_CONTIGUOUS"]):
            icdf = np.ascontiguousarray(icdf, np.uint16)
        self._lib.ik_msac_symbol(self._h, icdf.ctypes.data, n, sym)

    def encode_symbol_adapt(self, sym: int, cdf, n: int) -> None:
        self._lib.ik_msac_symbol_adapt(self._h, cdf.ctypes.data, n, sym)

    def encode_literal(self, value: int, bits: int) -> None:
        self._lib.ik_msac_literal(self._h, value, bits)

    def encode_golomb(self, value: int) -> None:
        self._lib.ik_msac_golomb(self._h, value)

    def save(self):
        return _NativeTok(self._lib, self._lib.ik_msac_clone(self._h))

    def load(self, tok) -> None:
        self._lib.ik_msac_assign(self._h, tok.h)

    def done(self) -> bytes:
        import ctypes

        cap = int(self.nbits) // 8 + 16
        buf = (ctypes.c_uint8 * cap)()
        n = self._lib.ik_msac_done(self._h, buf, cap)
        if n < 0:
            raise RuntimeError(f"msac done failed ({n})")
        return bytes(buf[:n])


class MsacDecoder:
    """Mirror decoder (spec 8.2) — used for self-validation and for the
    behavioral table disambiguation harness; dav1d is the external oracle."""

    def __init__(self, data: bytes):
        self._bits = data
        self._pos = 0
        first = self._read_bits(15)
        self.val = ((1 << 15) - 1) ^ first
        self.rng = 0x8000

    def _read_bits(self, n: int) -> int:
        """Stream bits; past the buffer end the decoder behaves as if the
        stream continued with ZEROS (pinned against dav1d: a 1-byte tile
        and the same tile with explicit zero padding decode identically,
        while 0xFF padding decodes differently).  Conformant encoders
        never rely on the synthesized direction — done() emits a prefix
        whose every extension decodes identically."""
        out = 0
        for _ in range(n):
            byte_i, bit_i = self._pos >> 3, 7 - (self._pos & 7)
            bit = (self._bits[byte_i] >> bit_i) & 1 \
                if byte_i < len(self._bits) else 0
            out = (out << 1) | bit
            self._pos += 1
        return out

    def decode_symbol(self, icdf, n: int) -> int:
        r = self.rng
        prev = r
        sym = -1
        while True:
            sym += 1
            f = 0 if sym == n - 1 else int(icdf[sym])
            cur = _interval(r, f, n - 1 - sym)
            if self.val >= cur:
                break
            prev = cur
        self.rng = prev - cur
        self.val -= cur
        while self.rng < 0x8000:
            self.rng <<= 1
            self.val = (self.val << 1) | (1 - self._read_bits(1))
        return sym

    def decode_literal(self, bits: int) -> int:
        out = 0
        for _ in range(bits):
            out = (out << 1) | self.decode_symbol(_HALF_ICDF, 2)
        return out

    def decode_golomb(self) -> int:
        length = 1
        while self.decode_literal(1) == 0:
            length += 1
            if length > 32:
                raise ValueError("bad golomb")
        x = 1
        for _ in range(length - 1):
            x = (x << 1) | self.decode_literal(1)
        return x - 1


# ---------------------------------------------------------------------------
# Raw-bit headers and OBU framing


class BitWriter:
    def __init__(self):
        self._bits = []

    def f(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def byte_align(self) -> None:
        while len(self._bits) % 8:
            self._bits.append(0)

    def trailing_bits(self) -> None:
        self._bits.append(1)
        self.byte_align()

    def bytes(self) -> bytes:
        self.byte_align()
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            b = 0
            for bit in self._bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME = 6


def obu(obu_type: int, payload: bytes) -> bytes:
    """OBU with header + has_size_field + leb128 size (spec 5.3.2)."""
    header = bytes([(obu_type << 3) | 0x02])  # has_size_field=1
    return header + leb128(len(payload)) + payload
