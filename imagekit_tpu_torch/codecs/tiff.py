"""TIFF decode without Pillow, over the port's native library.

Counterpart of ``imagekit_tpu/codecs/tiff.py``: ``native/tiff_decode.cpp``
(a copy of the reference's) parses the IFD, reassembles strips or tiles,
chunky or planar (none / LZW / deflate / PackBits, horizontal-differencing
predictor) and expands gray, palette and RGB(A) samples of 8 or 16 bits to
8-bit RGB or RGBA. A layout it refuses as unsupported (-3), which the
reference hands to Pillow, goes to the port's own
``native/tiff_ext_decode.cpp``: bilevel (none, PackBits, LZW, deflate and
CCITT modified Huffman, Group 3 and Group 4), 2- and 4-bit gray and
palette, in either FillOrder; 8-bit gray and palette with alpha (Pillow's
LA and PA, to RGBA); float32 and signed or unsigned 32-bit gray (Pillow's
F and I, then its ``convert("RGB")``: truncated or clipped to a byte); and
8-bit CMYK, 16-bit CMYK (the high byte of each sample) and CMYK with one or
two extra samples (dropped), whose inks :func:`decode` turns to RGB as
Pillow's ``convert("RGB")`` does (``ops/color.py::cmyk_to_rgb``, on the
device: run on the host from the codec pool's threads at once, its torch
ops took 20x longer); planar 16-bit CMYK; CIELab, whose samples go
through littleCMS's lattice as Pillow converts them
(``ops/color.py::lab_to_rgb``, on the device); YCbCr compressed without
JPEG, as libtiff's RGBA interface reads it (:class:`YccPage`: the chroma
replicated over each block by K3, then libtiff's ``TIFFYCbCrToRGB``,
``ops/dct.py::decode_ycbcr_page``), and uncompressed where Pillow's raw
reader reads it. The Orientation tag is applied as Pillow applies it to
every layout this decoder takes and to the pages rewritten for the pinned
decoder (:func:`as_deflate`), which the reference hands to Pillow
(``ops/color.py::orient``; the pinned decoder's other pages, which the
reference decodes itself, ignore it).

JPEG-compressed TIFFs (compression 7, 8-bit: YCbCr with
YCbCrSubSampling 1, 2 or 4 an axis, RGB, gray, CMYK, chunky, strips or
tiles; RGB, gray and CMYK planar; RGB with an unspecified, associated or
unassociated extra sample and gray with alpha; Huffman or arithmetic
coded) are decoded as libtiff decodes them, each strip or tile an
independent JPEG:
:func:`entropy_decode` has the native library splice each segment onto the
``JPEGTables``, one at a time, and parse and entropy-decode the page's
segments in two calls (the pinned decoder, or the port's for two and four
components and arithmetic coding; a segment whose data ends early as
libjpeg decodes it under libtiff's fake EOI, its MCU in flight from zero
bits and the rest zero), checks each header against the IFD as libtiff
does, and assembles the segments' coefficients into one plane a component
(:class:`JpegPage`); the device half is ``ops/dct.py::decode_tiff_page``
(one K3 launch a page, two for four components). The colour step follows
the TIFF photometric, never the JPEG stream; a planar gray + alpha page's
alpha is 0, as Pillow reads it. Old-style JPEG (compression 6), which
Pillow reads as YCbCr through libtiff's RGBA interface (one sample: gray),
is one stream a page (``ik_tiffx_ojpeg_stream``: the JPEGInterchangeFormat
stream, or the first strip's, or the tables-in-tags form's, over every
strip as libtiff's OJPEG module feeds them) entropy-decoded the same way;
its page replicates chroma over each subsampling block and takes libtiff's
``TIFFYCbCrToRGB``.

The differences from the reference are those of :mod:`.misc`, whose
binding helpers this uses: a constant pixel ceiling (no Pillow), and
:class:`~imagekit_tpu_torch.errors.NotPortedError` where neither decoder
takes a layout, a guard no mode of Pillow's TIFF reader reaches. What
Pillow refuses answers as the reference does, a
:class:`~imagekit_tpu_torch.errors.TransformError` (a layout it has no mode
for, such as a 16-bit palette or a 12-bit JPEG; YCbCr without compression,
which its raw reader runs out of; a page libtiff's read refuses, "decoder
error -2", :class:`PageRefused` for a JPEG page). Resource bounds, where
libtiff reads
on: a ``JPEGTables`` longer than 64 kB and a page whose splices would copy
more than 64 times the file (``tiff_ext_decode.cpp``), and a segment coded
smaller than its place, which libtiff decodes into the rows it has and
whose other rows Pillow leaves as its buffer held them (the previous
strip's, or memory never written), are 400 here.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from imagekit_tpu_torch.codecs import misc
from imagekit_tpu_torch.codecs.jpeg import sampling_refused
from imagekit_tpu_torch.codecs.native import jpeg_abi
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import color

#: ``IkTiffxInfo.layout``: what the port's decoder of the layouts the
#: pinned one refuses makes of the file
SAMPLES, CMYK, JPEG, LAB, YCC = 0, 1, 2, 3, 4

_SOI, _EOI = b"\xff\xd8", b"\xff\xd9"

# The Huffman tables of ITU T.81 Annex K.3, as one DHT segment: libjpeg
# decodes with these where a stream defines no table 0 or 1 of a class
# (Motion-JPEG segments carry none); the pinned decoder has no such default.
_STD_DHT = bytes.fromhex(
    "ffc401a2"
    "00" "00010501010101010100000000000000" "000102030405060708090a0b"
    "10" "0002010303020403050504040000017d"
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"
    "01" "00030101010101010101010000000000" "000102030405060708090a0b"
    "11" "00020102040403040705040400010277"
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")


#: the Compression tags of LZMA (one .xz stream a strip or tile) and
#: Zstandard (one frame a strip or tile), which the pinned decoder does not
#: take: its layouts' pages go to it through :func:`as_deflate`
PACKED = (34925, 50000)


class _More(ctypes.Structure):
    """``IkTiffxMore`` (``tiff_ext_decode.cpp``)."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "compression", "orientation", "sub_h", "sub_v")] + [
        ("luma", ctypes.c_float * 3), ("refbw", ctypes.c_float * 6),
        ("palette", ctypes.c_uint8 * 768)]


def _more(data: bytes) -> Tuple[int, _More]:
    """``ik_tiffx_more``: its code, and what it read (the Compression tag
    whatever the code)."""
    from imagekit_tpu_torch.codecs.native import loader

    fn = loader.load().ik_tiffx_more
    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_More)]
    more = _More(compression=1, orientation=1, sub_h=1, sub_v=1)
    return fn(data, len(data), ctypes.byref(more)), more


def as_deflate(data: bytes, strips: bool = True) -> bytes:
    """``ik_tiffx_rewrap``: a TIFF of the pinned decoder's layouts (8- and
    16-bit gray, palette, RGB(A)) that it does not take as one it does: an
    LZMA or Zstandard page as deflate, its strips decoded and stored again
    (``strips``, else only its Compression tag changed, for its header);
    an uncompressed page with a PlanarConfiguration or Predictor Pillow's
    raw reader ignores, those tags made 1."""
    from imagekit_tpu_torch.codecs.native import loader

    fn = loader.load().ik_tiffx_rewrap
    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_int]
    fn.restype = ctypes.c_int64
    out = np.empty(len(data) + 4096, np.uint8)
    for _ in range(2):  # the second call with the rewritten file's length
        n = int(fn(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                   out.nbytes, int(strips)))
        if n <= out.nbytes:
            break
        out = np.empty(n, np.uint8)
    misc.check(min(n, 0), "TIFF", "TIFF")
    return out[:n].tobytes()


def _header(data: bytes):
    """``misc.header``'s, then, where the port's decoder took the file or
    it is a page of the pinned decoder's layouts that it reads once
    rewritten (:func:`as_deflate`), ``ik_tiffx_more``'s (None else), and
    whether it is such a page."""
    try:
        head = misc.header(data, "tiff", "TIFF", "TIFF", "tiffx")
    except NotPortedError as refused:
        try:  # a page the pinned decoder takes once rewritten
            header_only = as_deflate(data, strips=False)
        except NotPortedError:
            raise refused from None
        head = misc.header(header_only, "tiff", "TIFF", "TIFF", "tiffx")
        # its Orientation, which the reference's Pillow applies (the
        # parse's code, the port decoder's refusal, does not matter here)
        return (*head, _more(data)[1], True)
    more = None
    if head[3] == "tiffx":
        rc, more = _more(data)
        misc.check(rc, "TIFF", "TIFF")
    return (*head, more, False)


def _orientation(head) -> int:
    """The Orientation Pillow applies: the port's decoder's layouts and the
    rewritten pages only (the pinned decoder's others, which the reference
    decodes itself, ignore it)."""
    return head[5].orientation if head[5] is not None else 1


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of the decoded image."""
    head = _header(data)
    w, h, ch, stem, layout, _, _ = head
    w, h = color.oriented_size(w, h, _orientation(head))
    return w, h, 3 if stem == "tiffx" and layout == CMYK else ch


def _layout(head) -> int:
    return head[4] if head[3] == "tiffx" else SAMPLES


def layout(data: bytes) -> int:
    """Header only: :data:`SAMPLES`, :data:`CMYK` or :data:`JPEG`."""
    return _layout(_header(data))


@dataclass
class YccPage:
    """A YCbCr page compressed without JPEG after the host decode: its Y
    plane (H, W) and its Cb and Cr planes, ``sub`` (horizontal, vertical)
    times coarser, each sample over its block as libtiff's RGBA interface
    replicates it; its YCbCrCoefficients and ReferenceBlackWhite."""

    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    sub: Tuple[int, int]
    luma: Tuple[float, ...]
    refbw: Tuple[float, ...]


def decode_stored(data: bytes) -> Tuple[object, int, int]:
    """The host half of :func:`decode`, its layout and the Orientation
    still to apply: HWC u8 RGB(A) (:data:`SAMPLES`, oriented here, so 1),
    a CMYK TIFF's four samples as
    stored (:data:`CMYK`), a JPEG TIFF's entropy-decoded page
    (:data:`JPEG`), CIELab's three samples as a chunky page stores them
    (:data:`LAB`) or a YCbCr page's planes (:data:`YCC`, a
    :class:`YccPage`)."""
    head = _header(data)
    kind, orientation = _layout(head), _orientation(head)
    if kind == JPEG:
        return entropy_decode(data), JPEG, orientation
    if head[6]:  # a page of the pinned decoder's layouts, rewritten
        data = as_deflate(data)
    out = misc.decode(data, "tiff", "TIFF", corrupt="TIFF", ext="tiffx",
                      head=head[:5])[0]
    if kind == YCC:
        info = head[5]
        (h, w), sh, sv = out.shape[:2], info.sub_h, info.sub_v
        cw, ch = -(-w // sh), -(-h // sv)
        flat = out.reshape(-1)
        planes = (flat[:w * h].reshape(h, w),
                  flat[w * h:w * h + cw * ch].reshape(ch, cw),
                  flat[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw))
        out = YccPage(*planes, (sh, sv), tuple(info.luma), tuple(info.refbw))
    elif kind == SAMPLES:
        return color.orient(out, orientation), kind, 1
    return out, kind, orientation


def finish(stored, kind: int, orientation: int = 1,
           device=None) -> np.ndarray:
    """The device half of :func:`decode`, on ``device`` (the card unless
    named): a CMYK or CIELab TIFF's colour step, a JPEG TIFF's pixel
    decode or a YCbCr page's (its chroma replicated by K3, then libtiff's
    ``TIFFYCbCrToRGB``), then the Orientation; a page of samples, on
    the host."""
    import torch

    from imagekit_tpu_torch.device import resolve_device
    from imagekit_tpu_torch.ops import dct

    if kind == SAMPLES:
        return color.orient(stored, orientation)
    device = resolve_device(device or "cuda")
    if kind == JPEG:
        return dct.decode_tiff_page(stored, device=device,
                                    orientation=orientation)
    if kind == YCC:
        return dct.decode_ycbcr_page(stored, device=device,
                                     orientation=orientation)
    planes = torch.from_numpy(stored).to(device)
    rgb = (color.lab_to_rgb(planes) if kind == LAB
           else color.cmyk_to_rgb(*(255 - planes).unbind(-1)))
    return color.orient(rgb, orientation).cpu().numpy()


def decode(data: bytes, device=None) -> np.ndarray:
    """TIFF -> HWC u8 (RGB, or RGBA for alpha); the colour step of a CMYK
    or CIELab TIFF and the pixel decode of a JPEG or YCbCr TIFF run on
    ``device`` (the card unless the caller names another)."""
    stored, kind, orientation = decode_stored(data)
    return finish(stored, kind, orientation, device=device)


def cmyk_to_rgb(cmyk: np.ndarray, device=None) -> np.ndarray:
    """(H, W, 4) CMYK as a TIFF stores it -> (H, W, 3) RGB, Pillow's
    ``cmyk2rgb``: the JPEG colour step (``ops/color.py::cmyk_to_rgb``) on
    the planes inverted, as an Adobe JPEG stores them, on ``device``."""
    return finish(cmyk, CMYK, device=device)


# -- JPEG-compressed TIFFs -------------------------------------------------------


class _JpegInfo(ctypes.Structure):
    """``IkTiffxJpeg`` (``tiff_ext_decode.cpp``)."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "width", "height", "photometric", "samples", "alpha", "sub_h",
        "sub_v", "seg_w", "seg_h", "rows", "cols", "tiled")] + [
        ("tables_off", ctypes.c_uint64), ("tables_len", ctypes.c_uint64)] + [
        (name, ctypes.c_int32) for name in ("planes", "extra",
                                            "old_style")] + [
        ("luma", ctypes.c_float * 3), ("refbw", ctypes.c_float * 6)]


class _Splice(ctypes.Structure):
    """``IkTiffxSplice`` (``tiff_ext_decode.cpp``): a page's segments, each
    spliced after ``prefix[which[i]]`` in place of its SOI."""

    _fields_ = [("data", ctypes.c_char_p), ("len", ctypes.c_uint64),
                ("prefix", ctypes.c_char_p * 2),
                ("prefix_len", ctypes.c_uint64 * 2),
                ("offsets", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("which", ctypes.c_void_p), ("n", ctypes.c_int32)]


def configure(lib: ctypes.CDLL) -> None:
    """The ``ik_tiffx_jpeg_*`` entries' signatures."""
    lib.ik_tiffx_jpeg_segments.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_JpegInfo),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ik_tiffx_jpeg_segments.restype = ctypes.c_int
    lib.ik_tiffx_jpeg_parse_many.argtypes = [
        ctypes.POINTER(_Splice),
        ctypes.POINTER(jpeg_abi.IkJpegInfo),  # n headers
        ctypes.c_void_p,                      # four-component flags (i32*)
        ctypes.c_void_p]                      # codes (i32*)
    lib.ik_tiffx_jpeg_parse_many.restype = None
    lib.ik_tiffx_jpeg_decode_many.argtypes = [
        ctypes.POINTER(_Splice),
        ctypes.POINTER(ctypes.c_void_p),      # 4 destinations a segment
        ctypes.c_void_p,                      # their row strides (i64*)
        ctypes.c_void_p,                      # qtabs (u16*, n x 4 x 64)
        ctypes.c_void_p]                      # codes (i32*)
    lib.ik_tiffx_jpeg_decode_many.restype = None
    lib.ik_tiffx_ojpeg_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.ik_tiffx_ojpeg_stream.restype = ctypes.c_int64


@dataclass
class JpegPage:
    """A JPEG TIFF page after the host entropy decode: ``coeffs[c]`` is
    component c's (by, bx, 64) i16 levels, the segments' planes placed at
    their grid positions (a planar page's component c is plane c's
    segments'); ``qtabs[c]`` its (64,) table; ``rows[c]`` and ``cols[c]``
    the block rows of each row of segments and the block columns of each
    column of them. ``height`` x ``width`` is the image, which the
    assembled planes cover (their MCU padding and the partial tiles lie
    beyond it). ``extra`` is the ExtraSamples value of a page with one
    (-1 for none). An old-style page holds its ``ycbcr`` colour
    (YCbCrCoefficients and ReferenceBlackWhite, for libtiff's
    ``TIFFYCbCrToRGB``), and its chroma is replicated over each subsampling
    block, not upsampled. An irregular page holds ``segments`` instead: a
    one-segment page each, with its top-left corner, which the device half
    decodes alone."""

    width: int
    height: int
    photometric: int
    coeffs: List[np.ndarray]
    qtabs: np.ndarray
    rows: List[Tuple[int, ...]]
    cols: List[Tuple[int, ...]]
    segments: Optional[List[Tuple["JpegPage", int, int]]] = None
    extra: int = -1
    ycbcr: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    #: a planar gray or palette + alpha page, whose alpha Pillow reads as
    #: 0: its gray or index plane alone, and an alpha of 0
    zero_alpha: bool = False
    #: a palette page's ColorMap, (256, 3) u8, its samples the indices
    palette: Optional[np.ndarray] = None
    #: a page of lossless segments: its (H, W) u8 sample planes, a
    #: component each, in place of ``coeffs``
    samples: Optional[List[np.ndarray]] = None
    #: a planar page: Pillow's bands of it hold CIELab's a* and b*
    #: unsigned
    planar: bool = False


def segments(data: bytes) -> Tuple[_JpegInfo, np.ndarray, np.ndarray]:
    """``ik_tiffx_jpeg_segments``: the layout, and each segment's offset
    and byte count (u64), row by row of the grid."""
    from imagekit_tpu_torch.codecs.native import loader

    fn = loader.load().ik_tiffx_jpeg_segments
    info = _JpegInfo()
    offs = np.zeros(4096, np.uint64)  # a page's grid, mostly: one parse
    for _ in range(2):  # the second call with room for the grid
        cnt = np.zeros_like(offs)
        rc = fn(data, len(data), ctypes.byref(info),
                offs.ctypes.data_as(ctypes.c_void_p),
                cnt.ctypes.data_as(ctypes.c_void_p), len(offs))
        if rc != misc.BUFFER:
            break
        offs = np.zeros(info.rows * info.cols, np.uint64)
    misc.check(rc, "TIFF", "TIFF")
    n = info.rows * info.cols * info.planes
    return info, offs[:n], cnt[:n]


def old_style_stream(data: bytes) -> bytes:
    """``ik_tiffx_ojpeg_stream``: an old-style JPEG page as the one JPEG
    stream libtiff hands to libjpeg."""
    from imagekit_tpu_torch.codecs.native import loader

    fn = loader.load().ik_tiffx_ojpeg_stream
    out = np.empty(2 * len(data) + 4096, np.uint8)  # what a stream takes
    for _ in range(2):  # the second call with its length (RSTs of strips)
        n = int(fn(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                   out.nbytes))
        if n <= out.nbytes:
            break
        out = np.empty(n, np.uint8)
    misc.check(min(n, 0) if n <= out.nbytes else misc.BUFFER, "TIFF", "TIFF")
    return out[:n].tobytes()


def prefixes(tables: bytes) -> Tuple[bytes, bytes]:
    """What each segment is spliced after, in place of its SOI, as libtiff
    reads ``JPEGTables`` ahead of it (an abbreviated stream): an SOI and the
    tables without their SOI and EOI; then the same with the Annex K
    Huffman tables after the SOI, for a segment that lacks one of them with
    the tables (its own, later, replace them)."""
    if tables and tables[:2] != _SOI:  # libtiff: "Bogus JPEGTables field"
        raise TransformError("corrupt TIFF: JPEGTables is not a JPEG stream")
    body = tables[2:-2] if tables[-2:] == _EOI else tables[2:]
    return _SOI + body, _SOI + _STD_DHT + body


class PageRefused(TransformError):
    """A JPEG TIFF page whose read libtiff refuses (a segment that does not
    fit its place or the IFD, or that libjpeg refuses). The message names
    the reason; Pillow's, whatever the reason, is :attr:`pillow`, which
    the engine's decode answers with."""

    pillow = "decoder error -2"


def _segment_error(e, i: int) -> Exception:
    """A segment's native decoder error -> the port's: corrupt data, as
    libtiff refuses it (a sampling factor or precision libjpeg refuses is
    both decoders' -3; a lossless page goes to :func:`_lossless_page`)."""
    return PageRefused(f"corrupt TIFF: JPEG segment {i} ({e})")


def tables_defined(stream) -> Tuple[set, set]:
    """The quantisation table ids and the Huffman tables, (class, id), that
    a JPEG stream's DQT and DHT segments define before its first scan."""
    quant, huff, at = set(), set(), 2
    while at + 4 <= len(stream) and stream[at] == 0xFF:
        marker = stream[at + 1]
        if marker == 0xDA:
            break
        end = at + 2 + int.from_bytes(stream[at + 2:at + 4], "big")
        p = at + 4
        while marker in (0xDB, 0xC4) and p < min(end, len(stream)):
            if marker == 0xDB:
                quant.add(stream[p] & 15)
                p += 1 + 64 * (1 + (stream[p] >> 4))
            else:
                huff.add((stream[p] >> 4, stream[p] & 15))
                p += 17 + sum(stream[p + 1:p + 17])
        at = end
    return quant, huff


_ALL_HUFFMAN = {(0, 0), (0, 1), (1, 0), (1, 1)}


def _segment_tables(segment, tables_defs) -> Tuple[set, bool]:
    """The quantisation tables a segment can use (its own and the
    ``JPEGTables``', ``tables_defs`` = their :func:`tables_defined`), and
    whether it lacks one of the Huffman tables 0 and 1 of a class, which
    libjpeg then takes from Annex K. The pinned decoder leaves an undefined
    quantisation table unset, where libjpeg refuses the stream
    ("Quantization table 0x.. was not defined"): a segment whose tables
    went into a missing ``JPEGTables``."""
    quant, huff = tables_defined(segment)
    quant, huff = quant | tables_defs[0], huff | tables_defs[1]
    return quant, not _ALL_HUFFMAN <= huff


def segment_stream(tables: bytes, segment: bytes) -> bytes:
    """One segment as the whole JPEG that ``ik_tiffx_jpeg_parse_many`` and
    ``decode_many`` splice: the plain statement of their splice."""
    if segment[:2] != _SOI:
        raise TransformError("corrupt TIFF: a JPEG segment has no SOI")
    _, std = _segment_tables(segment, tables_defined(tables))
    return prefixes(tables)[std] + segment[2:]


def _check_segment(hdr, info, sampling, i: int, want: Tuple[int, int],
                   last_strip: bool, ncomp: int) -> None:
    """libtiff's checks of a segment against the IFD (``JPEGPreDecode``), in
    its order, then libjpeg's of its sampling (``jpeg.sampling_refused``:
    a fractional ratio, more than 10 blocks an MCU in one scan). libtiff takes a last strip coded taller than its rows (and
    reads its rows only); here one coded at most a whole strip's height. A
    segment smaller than its place libtiff takes with a warning and leaves
    the rest undefined, which is an error here."""
    w, h = want
    if hdr.width != w or hdr.height != h:
        if not (last_strip and hdr.width == w
                and h < hdr.height <= info.seg_h):
            raise PageRefused(
                f"corrupt TIFF: JPEG segment {i} is {hdr.width}x{hdr.height},"
                f" its place {w}x{h}")
    if hdr.ncomp != ncomp:
        raise PageRefused(f"corrupt TIFF: JPEG segment {i} has "
                             f"{hdr.ncomp} components, the IFD "
                             f"{ncomp} samples")
    if (hdr.comp_h[0], hdr.comp_v[0]) != sampling or any(
            (hh, vv) != (1, 1) for hh, vv in zip(hdr.comp_h[1:],
                                                 hdr.comp_v[1:])):
        raise PageRefused(f"corrupt TIFF: JPEG segment {i} is sampled "
                             f"{hdr.comp_h} x {hdr.comp_v}, the IFD "
                             f"{sampling}")
    if sampling_refused(hdr):
        raise PageRefused(f"corrupt TIFF: JPEG segment {i}: libjpeg "
                             f"refuses its sampling")


def _parse_many(lib, splice: _Splice) -> list:
    """:func:`jpeg_abi.parse_any` of each spliced segment, in one native
    call: each one's :class:`~jpeg_abi.JpegHeader` or the
    :class:`~jpeg_abi.NativeJpegError` ``parse_any`` would raise."""
    n = splice.n
    infos = (jpeg_abi.IkJpegInfo * n)()
    four = np.zeros(n, np.int32)
    rcs = np.zeros(n, np.int32)
    lib.ik_tiffx_jpeg_parse_many(ctypes.byref(splice), infos,
                                 four.ctypes.data_as(ctypes.c_void_p),
                                 rcs.ctypes.data_as(ctypes.c_void_p))
    return [jpeg_abi._header(infos[i]) if rcs[i] == 0
            else jpeg_abi.NativeJpegError(int(rcs[i]), bool(four[i]))
            for i in range(n)]


def _decode_many(lib, splice: _Splice, places) -> Tuple[np.ndarray, list]:
    """:func:`jpeg_abi.decode_any` of each spliced segment, in one native
    call, into ``places[i]``: its components' (blocks_h, blocks_w, 64) i16
    views of the page's planes (rows of whole blocks, each row
    contiguous). Returns the (n, 4, 64) quant tables and each segment's
    :class:`~jpeg_abi.NativeJpegError`, or None."""
    n = splice.n
    ptrs = (ctypes.c_void_p * (4 * n))()
    strides = np.zeros(4 * n, np.int64)
    for i, comps in enumerate(places):
        for c, v in enumerate(comps):
            ptrs[4 * i + c] = v.ctypes.data
            strides[4 * i + c] = v.strides[0] // (64 * v.itemsize)
    qtabs = np.zeros((n, 4, 64), np.uint16)
    rcs = np.zeros(n, np.int32)
    lib.ik_tiffx_jpeg_decode_many(ctypes.byref(splice), ptrs,
                                  strides.ctypes.data_as(ctypes.c_void_p),
                                  qtabs.ctypes.data_as(ctypes.c_void_p),
                                  rcs.ctypes.data_as(ctypes.c_void_p))
    return qtabs, [jpeg_abi.NativeJpegError(int(rc)) if rc else None
                   for rc in rcs]


def _is_lossless(segment: bytes) -> bool:
    """Whether a JPEG segment's frame is lossless (SOF3)."""
    from imagekit_tpu_torch.codecs.jpeg import frame_markers

    return frame_markers(segment).sof == 0xC3


def _lossless_page(lib, data: bytes, tables: bytes, info, offs, cnts,
                   per_segment: int, zero_alpha: bool, palette) -> JpegPage:
    """A page of lossless segments, which libjpeg decodes for libtiff to
    samples: each segment spliced (:func:`segment_stream`), checked against
    its place as libtiff checks it, decoded (``jpeg_abi.decode_lossless``)
    and its samples placed; a planar page's segment i is plane i // (rows
    * cols). libjpeg converts no colour in lossless mode, so a YCbCr page
    is libtiff's refusal."""
    if info.photometric == 6:
        raise PageRefused("corrupt TIFF: a lossless JPEG segment of YCbCr")
    W, H, grid = info.width, info.height, info.rows * info.cols
    ncomp = per_segment if info.planes == 1 else len(offs) // grid
    planes = [np.zeros((H, W), np.uint8) for _ in range(ncomp)]
    for i, (o, n) in enumerate(zip(offs.tolist(), cnts.tolist())):
        g = i % grid
        y0 = (g // info.cols) * info.seg_h
        x0 = (g % info.cols) * info.seg_w
        want = (info.seg_w, info.seg_h if info.tiled
                else min(info.seg_h, H - y0))
        try:
            hdr, samples = jpeg_abi.decode_lossless(
                lib, segment_stream(tables, data[o:o + n]))
        except jpeg_abi.NativeJpegError as e:
            raise PageRefused(f"corrupt TIFF: JPEG segment {i} ({e})") from e
        if (hdr.width, hdr.height) != want or hdr.ncomp != per_segment or (
                set(zip(hdr.comp_h, hdr.comp_v)) != {(1, 1)}):
            raise PageRefused(f"corrupt TIFF: lossless JPEG segment {i} "
                              f"does not fit its place")
        h, w = min(want[1], H - y0), min(want[0], W - x0)
        comps = [i // grid] if info.planes > 1 else range(per_segment)
        for k, c in enumerate(comps):
            planes[c][y0:y0 + h, x0:x0 + w] = samples[k][:h, :w]
    return JpegPage(W, H, info.photometric, [], np.zeros((ncomp, 64)), [],
                    [], extra=info.extra, zero_alpha=zero_alpha,
                    palette=palette, samples=planes,
                    planar=info.planes > 1)


def entropy_decode(data: bytes) -> JpegPage:
    """The host half of a JPEG TIFF's decode: every strip or tile spliced
    onto the tables (:func:`prefixes`), its header read and checked against
    the IFD and the others, then entropy-decoded (the pinned decoder for one
    or three components, ``jpeg4_decode.cpp`` for two or four): the page's
    segments in two native calls, which splice each one in a scratch
    buffer and copy its levels to its place in the page's planes, so that
    the codec pool's threads do not queue on the interpreter lock at each
    segment or copy. Only the last strip, and the last row and column of
    tiles, may be partial, so the planes hold each segment's MCU padding at
    the page's bottom or right edge, which the device half crops. A planar
    page's segments are one component each, plane by plane. An old-style
    page is one segment, its stream (:func:`old_style_stream`). Where the
    segments' tables differ, or a strip that is not a whole number of MCUs
    ends before the last, the page keeps its segments apart, a planar
    page's by grid place, its planes' segments there together. A planar
    gray + alpha page decodes its gray plane alone (:attr:`JpegPage.
    zero_alpha`). Corrupt data raises
    :class:`TransformError`; what the decoders refuse as unsupported,
    :class:`NotPortedError`."""
    from imagekit_tpu_torch.codecs.native import loader

    lib = loader.load()
    info, offs, cnts = segments(data)
    planar, grid, ncomp = info.planes > 1, info.rows * info.cols, info.samples
    zero_alpha = planar and info.photometric in (1, 3) and ncomp == 2
    if zero_alpha:  # Pillow reads the gray or index plane; the alpha is 0
        offs, cnts, ncomp = offs[:grid], cnts[:grid], 1
    if info.old_style:
        data = old_style_stream(data)
        offs = np.zeros(1, np.uint64)
        cnts = np.full(1, len(data), np.uint64)
        tables = b""
    else:
        tables = data[info.tables_off:info.tables_off + info.tables_len]
    W, H = info.width, info.height
    # the segments' whole area, which their planes hold: tiles may pass
    # the image by most of a tile, each side
    padded = info.rows * info.seg_h * info.cols * info.seg_w
    if padded > max(misc.MAX_PIXELS, 2 * W * H):
        raise TransformError(f"corrupt TIFF: {info.rows}x{info.cols} "
                             f"segments of {info.seg_w}x{info.seg_h} for "
                             f"a {W}x{H} image")
    palette = (np.frombuffer(bytes(_more(data)[1].palette), np.uint8)
               .reshape(3, 256).T.copy() if info.photometric == 3 else None)
    if len(offs) and _is_lossless(data[int(offs[0]):int(offs[0] + cnts[0])]):
        return _lossless_page(lib, data, tables, info, offs, cnts,
                              1 if planar else ncomp, zero_alpha, palette)
    heads_p = prefixes(tables)
    defs, view = tables_defined(tables), memoryview(data)
    quants, which = zip(*(_segment_tables(view[o:o + n], defs)
                          for o, n in zip(offs.tolist(), cnts.tolist())))
    which = np.array(which, np.int32)
    splice = _Splice(data, len(data), (ctypes.c_char_p * 2)(*heads_p),
                     (ctypes.c_uint64 * 2)(*map(len, heads_p)),
                     offs.ctypes.data, cnts.ctypes.data, which.ctypes.data,
                     len(offs))
    heads = _parse_many(lib, splice)
    sampling, places = None, []
    for i, hdr in enumerate(heads):
        if isinstance(hdr, jpeg_abi.NativeJpegError):
            raise _segment_error(hdr, i)
        g = i % grid
        y0 = (g // info.cols) * info.seg_h
        x0 = (g % info.cols) * info.seg_w
        # a tile decodes whole and is clipped; a strip holds its rows only
        want = (info.seg_w, info.seg_h if info.tiled
                else min(info.seg_h, H - y0))
        if sampling is None:
            # libtiff takes a missing YCbCrSubSampling from the first
            # segment
            sampling = ((info.sub_h or hdr.comp_h[0],
                         info.sub_v or hdr.comp_v[0])
                        if info.photometric == 6 else (1, 1))
        _check_segment(hdr, info, sampling, i, want,
                       not info.tiled and g == grid - 1,
                       1 if planar else ncomp)
        if not set(hdr.comp_tq) <= quants[i]:
            raise PageRefused(f"corrupt TIFF: JPEG segment {i} uses a "
                                 f"quantisation table it does not define")
        places.append((y0, x0, min(want[0], W - x0), min(want[1], H - y0)))

    def held(c: int, g: int) -> Tuple[int, int]:
        """(segment, its component) of page component c at grid place g."""
        return (c * grid + g, 0) if planar else (g, c)

    # the page's planes: every segment of a row of the grid is as tall as
    # the others (one strip a row; tiles all of a tile's size), and every
    # segment of a column as wide, so each sits at its block offset
    rows = [tuple(heads[i].blocks_h[k] for i, k in (
        held(c, r * info.cols) for r in range(info.rows)))
        for c in range(ncomp)]
    cols = [tuple(heads[i].blocks_w[k] for i, k in (
        held(c, x) for x in range(info.cols))) for c in range(ncomp)]
    coeffs = [np.zeros((sum(rows[c]), sum(cols[c]), 64), np.int16)
              for c in range(ncomp)]
    r0 = [np.cumsum((0,) + r) for r in rows]
    c0 = [np.cumsum((0,) + k) for k in cols]

    def place(c: int, g: int) -> np.ndarray:
        r, x = g // info.cols, g % info.cols
        return coeffs[c][r0[c][r]:r0[c][r + 1], c0[c][x]:c0[c][x + 1]]

    views = [[place(i // grid, i % grid)] if planar
             else [place(c, i) for c in range(ncomp)]
             for i in range(len(heads))]
    qtabs, errors = _decode_many(lib, splice, views)
    for i, e in enumerate(errors):
        if e is not None:
            raise _segment_error(e, i)
    qts = [qtabs[i][list(h.comp_tq)] for i, h in enumerate(heads)]
    page_q = np.stack([qts[i][k] for i, k in (held(c, 0)
                                              for c in range(ncomp))])
    same = all(np.array_equal(q, page_q[i // grid:i // grid + 1] if planar
                              else page_q) for i, q in enumerate(qts))
    # strips whose MCUs do not straddle one another, and tiles (whole MCUs
    # each), of one set of tables: one pixel decode a page
    regular = (info.tiled or grid == 1
               or info.seg_h % (8 * sampling[1]) == 0)
    # libtiff's RGBA interface converts an old-style page and a planar
    # YCbCr one (TIFFYCbCrToRGB)
    ycbcr = ((tuple(info.luma), tuple(info.refbw))
             if (info.old_style or planar) and info.photometric == 6
             else None)
    if regular and same:
        return JpegPage(W, H, info.photometric, coeffs, page_q, rows, cols,
                        extra=info.extra, ycbcr=ycbcr, zero_alpha=zero_alpha,
                        palette=palette, planar=planar)
    # each place of the grid alone: a chunky segment's components, or the
    # segments of every plane at that place
    if planar:
        groups = [([views[c * grid + g][0] for c in range(ncomp)],
                   np.stack([qts[c * grid + g][0] for c in range(ncomp)]),
                   places[g]) for g in range(grid)]
    else:
        groups = list(zip(views, qts, places))
    return JpegPage(W, H, info.photometric, [], page_q, [], [], segments=[
        (JpegPage(w, h, info.photometric,
                  [np.ascontiguousarray(v) for v in vs], q,
                  [(v.shape[0],) for v in vs], [(v.shape[1],) for v in vs],
                  extra=info.extra, ycbcr=ycbcr, zero_alpha=zero_alpha,
                  palette=palette, planar=planar),
         y0, x0)
        for vs, q, (y0, x0, w, h) in groups],
        extra=info.extra, ycbcr=ycbcr, zero_alpha=zero_alpha,
        palette=palette, planar=planar)
