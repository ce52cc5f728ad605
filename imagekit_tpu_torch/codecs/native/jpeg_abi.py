"""ctypes ABI for the native JPEG entropy codec (jpeg_entropy.cpp) and for
the port's decoder beside it (jpeg4_decode.cpp: CMYK and YCCK JPEGs,
baseline frames in several scans, arithmetic-coded and lossless frames,
:func:`parse4`, :func:`decode4` and :func:`decode_lossless`).
:func:`parse_any` and :func:`decode_any` try the first, then the second
where it refuses the frame as unsupported."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


class IkJpegInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("hmax", ctypes.c_int32),
        ("vmax", ctypes.c_int32),
        ("comp_h", ctypes.c_int32 * 4),
        ("comp_v", ctypes.c_int32 * 4),
        ("comp_width", ctypes.c_int32 * 4),
        ("comp_height", ctypes.c_int32 * 4),
        ("blocks_w", ctypes.c_int32 * 4),
        ("blocks_h", ctypes.c_int32 * 4),
        ("comp_tq", ctypes.c_int32 * 4),
        ("progressive", ctypes.c_int32),
    ]


class Ik4Extra(ctypes.Structure):
    """What ``jpeg4_decode.cpp``'s header adds to :class:`IkJpegInfo`."""

    _fields_ = [
        ("adobe_transform", ctypes.c_int32),
        ("coding", ctypes.c_int32),
    ]


#: ``JpegHeader.coding``: the entropy coding of a frame
HUFFMAN, ARITHMETIC, LOSSLESS = 0, 1, 2

ERRORS = {
    -1: "truncated",
    -2: "bad marker",
    -3: "unsupported (12-bit, hierarchical, lossless arithmetic)",
    -4: "bad huffman data",
    -5: "bad dimensions",
    -6: "internal error",
    -7: "buffer too small",
    -8: "sampling factors too large for interleaved scan",
    -9: "arithmetic data past the bytes fed",
}

#: the bytes Pillow's ``ImageFile.load`` hands libjpeg a call
#: (``decodermaxblock``): the feed :func:`decode4` and
#: :func:`decode_libjpeg` model for a JPEG source
PILLOW_BLOCK = 65536


class NativeJpegError(Exception):
    """``four_components``: raised by the port's decoder
    (``jpeg4_decode.cpp``: four components, or a baseline frame in several
    scans), on a frame that the pinned one refused as unsupported."""

    def __init__(self, code: int, four_components: bool = False):
        super().__init__(ERRORS.get(code, f"error {code}"))
        self.code = code
        self.four_components = four_components


def configure(lib: ctypes.CDLL) -> None:
    lib.ik_jpeg_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(IkJpegInfo),
    ]
    lib.ik_jpeg_parse.restype = ctypes.c_int
    lib.ik_jpeg_decode_planes.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ik_jpeg_decode_planes.restype = ctypes.c_int
    lib.ik_jpeg_decode_coeffs.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p,
    ]
    lib.ik_jpeg_decode_coeffs.restype = ctypes.c_int
    if hasattr(lib, "ik_jpeg_decode_coeffs_lowfreq"):
        lib.ik_jpeg_decode_coeffs_lowfreq.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p,
        ]
        lib.ik_jpeg_decode_coeffs_lowfreq.restype = ctypes.c_int
    if hasattr(lib, "ik_jpeg_decode_coeffs_lowfreq_i8"):
        lib.ik_jpeg_decode_coeffs_lowfreq_i8.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),  # dc planes (i16*)
            ctypes.POINTER(ctypes.c_void_p),  # ac planes (i8*)
            ctypes.c_void_p,                  # esc (i32*, cap x 3)
            ctypes.c_int32,                   # esc_cap
            ctypes.c_void_p,                  # esc_count (i32*)
            ctypes.c_void_p,                  # qtabs_out
        ]
        lib.ik_jpeg_decode_coeffs_lowfreq_i8.restype = ctypes.c_int
    lib.ik_jpeg_encode.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # coeff planes
        ctypes.c_int,                      # ncomp
        ctypes.c_int,                      # width
        ctypes.c_int,                      # height
        ctypes.c_void_p,                   # samp_h (i32*)
        ctypes.c_void_p,                   # samp_v (i32*)
        ctypes.c_void_p,                   # qtab_luma (u16*)
        ctypes.c_void_p,                   # qtab_chroma (u16*)
        ctypes.c_void_p,                   # out
        ctypes.c_size_t,                   # out_cap
    ]
    lib.ik_jpeg_encode.restype = ctypes.c_int64
    lib.ik_native_version.restype = ctypes.c_int
    lib.ik_jpeg4_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(IkJpegInfo),
        ctypes.POINTER(Ik4Extra),
    ]
    lib.ik_jpeg4_parse.restype = ctypes.c_int
    lib.ik_jpeg4_decode_coeffs.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p,
    ]
    lib.ik_jpeg4_decode_coeffs.restype = ctypes.c_int
    lib.ik_jpeg4_decode_fed.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p,
    ]
    lib.ik_jpeg4_decode_fed.restype = ctypes.c_int
    lib.ik_jpeg4_decode_libjpeg.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ik_jpeg4_decode_libjpeg.restype = ctypes.c_int
    lib.ik_jpeg4_decode_lossless.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ik_jpeg4_decode_lossless.restype = ctypes.c_int
    lib.ik_jpeg4_huffman_guard.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ik_jpeg4_huffman_guard.restype = ctypes.c_int


def _guard(lib: ctypes.CDLL, data: bytes) -> None:
    """Refuse (-4, a bad Huffman table) a stream with a DHT that would
    overrun the pinned decoder's 8-bit lookup (``jpeg4_decode.cpp``'s
    ``ik_jpeg4_huffman_guard``), before the pinned decoder reads it: every
    path into ``jpeg_entropy.cpp`` from here passes through :func:`parse`
    or this."""
    rc = lib.ik_jpeg4_huffman_guard(data, len(data))
    if rc != 0:
        raise NativeJpegError(rc)


@dataclass
class JpegHeader:
    width: int
    height: int
    ncomp: int
    hmax: int
    vmax: int
    comp_h: Tuple[int, ...]
    comp_v: Tuple[int, ...]
    comp_width: Tuple[int, ...]
    comp_height: Tuple[int, ...]
    blocks_w: Tuple[int, ...]
    blocks_h: Tuple[int, ...]
    comp_tq: Tuple[int, ...]
    progressive: bool
    #: an Adobe APP14 segment's transform flag (0 CMYK, else YCCK), -1
    #: without one; read by :func:`parse4` only
    adobe_transform: int = -1
    #: the frame is one that only the port's decoder takes (:func:`parse4`)
    port_decoder: bool = False
    #: :data:`HUFFMAN`, :data:`ARITHMETIC` (SOF9, SOF10) or :data:`LOSSLESS`
    #: (SOF3: ``comp_width`` x ``comp_height`` samples a component, the
    #: "blocks" its MCU-padded sample grid); read by :func:`parse4` only
    coding: int = HUFFMAN
    #: three components coded as RGB, not YCbCr (libjpeg's choice from the
    #: JFIF and Adobe markers and the component ids): set by
    #: ``codecs/jpeg.py``, which reads those markers
    rgb: bool = False


def _header(info: IkJpegInfo, **extra) -> JpegHeader:
    return JpegHeader(
        width=info.width,
        height=info.height,
        ncomp=info.ncomp,
        hmax=info.hmax,
        vmax=info.vmax,
        comp_h=tuple(info.comp_h[: info.ncomp]),
        comp_v=tuple(info.comp_v[: info.ncomp]),
        comp_width=tuple(info.comp_width[: info.ncomp]),
        comp_height=tuple(info.comp_height[: info.ncomp]),
        blocks_w=tuple(info.blocks_w[: info.ncomp]),
        blocks_h=tuple(info.blocks_h[: info.ncomp]),
        comp_tq=tuple(info.comp_tq[: info.ncomp]),
        progressive=bool(info.progressive),
        **extra,
    )


def parse(lib: ctypes.CDLL, data: bytes) -> JpegHeader:
    _guard(lib, data)
    info = IkJpegInfo()
    rc = lib.ik_jpeg_parse(data, len(data), ctypes.byref(info))
    if rc != 0:
        raise NativeJpegError(rc)
    return _header(info)


def parse4(lib: ctypes.CDLL, data: bytes) -> JpegHeader:
    """The header of a frame the pinned parser refuses with -3 that the
    port's decoder takes: four components (CMYK or YCCK), baseline or
    progressive; two (a JPEG TIFF's gray + alpha segment); a baseline frame
    in several scans; an arithmetic-coded (SOF9, SOF10) or a lossless
    (SOF3) frame of one to four components. With its Adobe transform flag
    and its coding; -3 for anything else the native decoder refuses
    (12-bit, hierarchical, lossless arithmetic, other component counts)."""
    info = IkJpegInfo()
    extra = Ik4Extra(-1, HUFFMAN)
    rc = lib.ik_jpeg4_parse(data, len(data), ctypes.byref(info),
                            ctypes.byref(extra))
    if rc != 0:
        raise NativeJpegError(rc, four_components=True)
    return _header(info, adobe_transform=int(extra.adobe_transform),
                   port_decoder=True, coding=int(extra.coding))


def _band_past_sequential(data: bytes) -> bool:
    """Whether a sequential frame's (SOF0, SOF1) first scan states a
    spectral band past T.81's (Ss or Se over 63, Ss over Se): the pinned
    parser refuses it as a bad marker, where libjpeg only warns
    (JWRN_NOT_SEQUENTIAL) and decodes every block whole, as the port's
    parser does."""
    at, sof = 2, None
    while at + 4 <= len(data) and data[at] == 0xFF:
        marker = data[at + 1]
        if marker == 0xFF:
            at += 1
            continue
        end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            sof = sof or marker
        if marker == 0xDA:
            ns = data[at + 4] if at + 4 < len(data) else 0
            band = data[at + 5 + 2 * ns:at + 7 + 2 * ns]
            return (sof in (0xC0, 0xC1) and len(band) == 2
                    and (band[0] > 63 or band[1] > 63 or band[0] > band[1]))
        at = end
    return False


def parse_any(lib: ctypes.CDLL, data: bytes) -> JpegHeader:
    """:func:`parse`'s header, or where it refuses the frame with -3, or
    with a bad marker for a sequential scan's band
    (:func:`_band_past_sequential`), :func:`parse4`'s (``port_decoder``
    set). Raises the pinned parser's error when neither takes the frame,
    else the failing parser's."""
    try:
        return parse(lib, data)
    except NativeJpegError as e:
        if e.code != -3 and not (e.code == -2 and _band_past_sequential(data)):
            raise
        refused = e
    try:
        return parse4(lib, data)
    except NativeJpegError as e:
        if e.code == -3:
            raise refused from None
        raise


def decode_planes(
    lib: ctypes.CDLL, data: bytes
) -> Tuple[JpegHeader, List[np.ndarray]]:
    """Huffman decode + host IDCT into padded component sample planes.
    Plane c has shape (blocks_h*8, blocks_w*8); the true samples occupy
    [:comp_height, :comp_width]."""
    hdr = parse(lib, data)
    planes = [
        np.empty((hdr.blocks_h[c] * 8, hdr.blocks_w[c] * 8), np.uint8)
        for c in range(hdr.ncomp)
    ]
    # always 4 slots: the C side indexes store[0..3] (nullptr-padded)
    ptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in planes]
    )
    rc = lib.ik_jpeg_decode_planes(data, len(data), ptrs)
    if rc != 0:
        raise NativeJpegError(rc)
    return hdr, planes


def decode(
    lib: ctypes.CDLL, data: bytes
) -> Tuple[JpegHeader, List[np.ndarray], np.ndarray]:
    """Huffman decode to quantised coefficient planes (device does the
    rest). Plane c has shape (blocks_h, blocks_w, 64) i16, natural order;
    also returns the 4x64 quant-table array (natural order). Handles both
    baseline and progressive scans (zero-initialised planes accumulate
    progressive refinement passes)."""
    hdr = parse(lib, data)
    coeffs = [
        np.zeros((hdr.blocks_h[c], hdr.blocks_w[c], 64), np.int16)
        for c in range(hdr.ncomp)
    ]
    qtabs = np.empty((4, 64), np.uint16)
    # always 4 slots: ik_jpeg_decode_coeffs populates store[0..3] before
    # Parse() establishes ncomp, so a shorter array would be over-read
    ptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in coeffs]
    )
    rc = lib.ik_jpeg_decode_coeffs(
        data, len(data), ptrs, qtabs.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise NativeJpegError(rc)
    return hdr, coeffs, qtabs


def _planes(hdr: JpegHeader):
    coeffs = [np.zeros((hdr.blocks_h[c], hdr.blocks_w[c], 64), np.int16)
              for c in range(hdr.ncomp)]
    ptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in coeffs])
    return coeffs, ptrs, np.empty((4, 64), np.uint16)


def decode4(
    lib: ctypes.CDLL, data: bytes, block: int = 0
) -> Tuple[JpegHeader, List[np.ndarray], np.ndarray]:
    """:func:`decode`'s output for a frame :func:`parse4` takes: every scan
    of a progressive one accumulated, every scan of a baseline one in
    several scans decoded (the blocks no scan codes stay zero). With
    ``block`` (:data:`PILLOW_BLOCK`), arithmetic scans are fed as Pillow
    feeds libjpeg, whose QM decoder cannot suspend for more: -9 where one
    needs a byte past those fed."""
    hdr = parse4(lib, data)
    coeffs, ptrs, qtabs = _planes(hdr)
    rc = lib.ik_jpeg4_decode_fed(data, len(data), block, ptrs,
                                 qtabs.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise NativeJpegError(rc, four_components=True)
    return hdr, coeffs, qtabs


def decode_libjpeg(
    lib: ctypes.CDLL, data: bytes, block: int
) -> Tuple[JpegHeader, List[np.ndarray], np.ndarray, Optional[int]]:
    """A DCT frame decoded as libjpeg decodes it, to the byte
    (``jpeg4_decode.cpp``'s ``Lj``): (header, planes, tables, unread).
    ``block`` > 0 feeds a Huffman frame as Pillow does, that many bytes a
    call; ``unread`` is None where libjpeg reads it whole, else the bytes
    Pillow's last call left unconsumed when the data ran out. ``block`` 0
    feeds it whole and then an EOI, as libtiff feeds a JPEG segment: a
    segment cut short decodes, its MCU in flight from zero bits and the
    rest zero (arithmetic frames too, zeros fed at the EOI). Raises the
    frame's error; -3 for a lossless frame, or an arithmetic one with
    ``block``."""
    hdr = parse4(lib, data)
    coeffs, ptrs, qtabs = _planes(hdr)
    unread = ctypes.c_int64(0)
    rc = lib.ik_jpeg4_decode_libjpeg(data, len(data), block, ptrs,
                                     qtabs.ctypes.data_as(ctypes.c_void_p),
                                     ctypes.byref(unread))
    if rc not in (0, 1):
        raise NativeJpegError(rc, four_components=True)
    return hdr, coeffs, qtabs, (unread.value if rc == 1 else None)


def decode_lossless(lib: ctypes.CDLL, data: bytes
                    ) -> Tuple[JpegHeader, List[np.ndarray]]:
    """The samples of a lossless frame (:func:`parse4`'s ``LOSSLESS``):
    one u8 plane a component, (comp_height, comp_width), shifted up by the
    point transform; a component no scan codes stays zero."""
    hdr = parse4(lib, data)
    if hdr.coding != LOSSLESS:
        raise NativeJpegError(-3, four_components=True)
    planes = [np.zeros((hdr.comp_height[c], hdr.comp_width[c]), np.uint8)
              for c in range(hdr.ncomp)]
    ptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in planes])
    rc = lib.ik_jpeg4_decode_lossless(data, len(data), ptrs)
    if rc != 0:
        raise NativeJpegError(rc, four_components=True)
    return hdr, planes


def decode_any(
    lib: ctypes.CDLL, data: bytes
) -> Tuple[JpegHeader, List[np.ndarray], np.ndarray]:
    """:func:`decode` or :func:`decode4`, as :func:`parse_any` finds the
    frame; its errors as there."""
    if parse_any(lib, data).port_decoder:
        return decode4(lib, data)
    return decode(lib, data)


def decode_lowfreq(
    lib: ctypes.CDLL, data: bytes, k: int, hdr: JpegHeader = None
) -> Tuple[JpegHeader, List[np.ndarray], np.ndarray]:
    """Entropy decode keeping only each block's KxK low-frequency
    coefficients (scaled-IDCT thumbnail path): plane c is
    (blocks_h, blocks_w, k*k) i16 natural order."""
    if hdr is None:
        hdr = parse(lib, data)
    else:
        _guard(lib, data)
    coeffs = [
        np.zeros((hdr.blocks_h[c], hdr.blocks_w[c], k * k), np.int16)
        for c in range(hdr.ncomp)
    ]
    qtabs = np.empty((4, 64), np.uint16)
    ptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in coeffs]
    )
    rc = lib.ik_jpeg_decode_coeffs_lowfreq(
        data, len(data), k, ptrs, qtabs.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise NativeJpegError(rc)
    return hdr, coeffs, qtabs


#: per-image escape budget for the int8 transport (48 KB of scratch); an
#: image exceeding it (pathological low-quantiser content) rides the int16
#: transport instead — exactness is never at stake, only wire bytes.
ESC_CAP = 4096


def decode_lowfreq_i8(
    lib: ctypes.CDLL,
    data: bytes,
    k: int,
    hdr: JpegHeader = None,
    esc_cap: int = ESC_CAP,
):
    """Entropy decode with the split int8 transport (wire-size lever for
    bandwidth-limited host<->device links): per plane c,

    - ``dc[c]``: (blocks_h, blocks_w) i16 DC levels
    - ``ac[c]``: (blocks_h, blocks_w, k*k-1) i8 clamped AC levels in
      natural KxK order minus (0,0)
    - ``esc``: (n, 3) i32 rows (comp, flat_ac_index, residual); the device
      reconstructs exact levels by widening + scatter-adding residuals.

    Returns (hdr, dc, ac, esc, qtabs, overflow); ``overflow`` means the
    escape list was truncated and the caller must use the int16 transport.
    """
    if hdr is None:
        hdr = parse(lib, data)
    else:
        _guard(lib, data)
    dc = [
        np.zeros((hdr.blocks_h[c], hdr.blocks_w[c]), np.int16)
        for c in range(hdr.ncomp)
    ]
    ac = [
        np.zeros((hdr.blocks_h[c], hdr.blocks_w[c], k * k - 1), np.int8)
        for c in range(hdr.ncomp)
    ]
    esc = np.zeros((esc_cap, 3), np.int32)
    count = ctypes.c_int32(0)
    qtabs = np.empty((4, 64), np.uint16)
    dptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in dc]
    )
    aptrs = (ctypes.c_void_p * 4)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in ac]
    )
    rc = lib.ik_jpeg_decode_coeffs_lowfreq_i8(
        data,
        len(data),
        k,
        dptrs,
        aptrs,
        esc.ctypes.data_as(ctypes.c_void_p),
        esc_cap,
        ctypes.byref(count),
        qtabs.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise NativeJpegError(rc)
    n = int(count.value)
    overflow = n > esc_cap
    return hdr, dc, ac, esc[: min(n, esc_cap)], qtabs, overflow


def reconstruct_lowfreq_levels(dc, ac, esc, k: int):
    """Rebuild the int16 (blocks_h, blocks_w, k*k) level planes from the
    split transport — the host-side mirror of the device reconstruction,
    used by fallback paths and parity tests."""
    out = []
    for c in range(len(dc)):
        bh, bw = dc[c].shape
        lev = np.empty((bh, bw, k * k), np.int16)
        lev[:, :, 0] = dc[c]
        lev[:, :, 1:] = ac[c].astype(np.int16)
        out.append(lev)
    for comp, flat, resid in np.asarray(esc, np.int64):
        bh, bw = dc[comp].shape
        bi, pos = divmod(flat, k * k - 1)
        out[comp][bi // bw, bi % bw, 1 + pos] += resid
    return out


def encode(
    lib: ctypes.CDLL,
    coeff_planes: List[np.ndarray],
    qtabs: Tuple[np.ndarray, np.ndarray],
    width: int,
    height: int,
    samp: Tuple[Tuple[int, int], ...] = ((2, 2), (1, 1), (1, 1)),
) -> bytes:
    """Entropy-encode quantised coefficient planes into a baseline JFIF
    stream. coeff_planes[c]: (blocks_h, blocks_w, 64) i16 natural order."""
    ncomp = len(coeff_planes)
    planes = [np.ascontiguousarray(p, np.int16) for p in coeff_planes]
    ptrs = (ctypes.c_void_p * ncomp)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in planes]
    )
    samp_h = np.array([s[0] for s in samp[:ncomp]], np.int32)
    samp_v = np.array([s[1] for s in samp[:ncomp]], np.int32)
    ql = np.ascontiguousarray(qtabs[0], np.uint16)
    qc = np.ascontiguousarray(qtabs[1], np.uint16)
    cap = sum(p.nbytes for p in planes) + 65536
    out = np.empty(cap, np.uint8)
    n = lib.ik_jpeg_encode(
        ptrs,
        ncomp,
        width,
        height,
        samp_h.ctypes.data_as(ctypes.c_void_p),
        samp_v.ctypes.data_as(ctypes.c_void_p),
        ql.ctypes.data_as(ctypes.c_void_p),
        qc.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if n < 0:
        raise NativeJpegError(int(n))
    return out[:n].tobytes()
