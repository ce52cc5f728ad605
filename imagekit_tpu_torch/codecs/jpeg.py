"""JPEG codec glue of the port: host entropy coding, device DCT and colour.

Counterpart of ``imagekit_tpu/codecs/jpeg.py``: the serial entropy stages
run on the host in native C++ (Huffman decode of scans into quantised DCT
coefficient planes, Huffman encode of quantised levels into a baseline
JPEG), the parallel math on the device
(:func:`imagekit_tpu_torch.ops.dct.decode_components_to_rgb`, one K3 launch
on CUDA, and :func:`~imagekit_tpu_torch.ops.dct.encode_rgb_to_coefficients`).
``device`` is the card unless the caller names another.

The reference's serving path decodes JPEG pixels with Pillow; the port has
none, so :func:`decode_rgb` is its JPEG pixel decode, baseline or
progressive: three components in any sampling Pillow reads (the chroma
ratios of 4:2:0, 4:2:2, 4:4:0, 4:4:4, 4:1:1, 4:1:0 and any other integer
ratio, Cb and Cr sampled alike or not, the luma below the largest
factors), each with its own table, coded as YCbCr or as RGB
(:func:`colour_space`), and grayscale JPEGs; CMYK and YCCK JPEGs,
baseline or progressive, in any integer sampling; baseline frames in
several scans; arithmetic-coded frames (SOF9, SOF10) of 1, 3 or 4
components; and lossless frames (SOF3) of 1, 3 or 4 components. The
pinned native decoder refuses the last four with -3; the port's own
entropy decode (``jpeg_abi.decode4``, ``decode_lossless``) takes them,
then the device decode. What Pillow refuses answers 400 as in the
reference: a frame whose precision is not 8 bits or whose component count
is not 1, 3 or 4, a sampling libjpeg refuses (:func:`sampling_refused`),
hierarchical and lossless arithmetic frames, lossless frames that would
need a colour conversion, and data that runs out where Pillow's feed of
libjpeg does (:func:`decode_to_coefficients`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from imagekit_tpu_torch.errors import (
    NotPortedError,
    SourceDecodeError,
    TransformError,
)

#: the largest side a baseline JPEG's frame header can state
JPEG_MAX_SIDE = 65535


#: Pillow's message where libjpeg refuses a frame Pillow has opened
BROKEN_STREAM = "broken data stream when reading image file"

#: Pillow's message where its JPEG reader has no mode for a frame
UNIDENTIFIED = "cannot identify image file"

#: the SOFn markers of hierarchical frames (SOF5-7, SOF13-15) and of
#: lossless arithmetic ones (SOF11): Pillow opens them, libjpeg refuses
#: them
_LIBJPEG_REFUSES = (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF)


def decode_error(e) -> Exception:
    """Native decoder failure -> the port's error: an unsupported frame
    (-3) is a path not ported yet; a
    frame that only the port's decoder takes (CMYK, YCCK, baseline in
    several scans, arithmetic, lossless) that fails is a
    :class:`~imagekit_tpu_torch.errors.SourceDecodeError`, because the
    reference decodes such a JPEG in full at its fetch stage: with Pillow's
    message where libjpeg refuses it (an interleaved scan of more than 10
    blocks an MCU, -8; a bad marker segment, such as a DAC with L > U;
    data the decoder cannot take), the decoder's own where the data ends
    (-1); anything else is a bad source (400, as the reference's decode
    would give)."""
    if getattr(e, "code", None) == -3:  # source_header answers every -3
        return NotPortedError(
            f"a JPEG the native decoder does not take ({e})", None)
    if getattr(e, "four_components", False):
        return SourceDecodeError(BROKEN_STREAM if e.code != -1
                                 else f"JPEG decode failed: {e}")
    return TransformError(f"JPEG decode failed: {e}")


def sampling_refused(hdr) -> bool:
    """Whether libjpeg refuses the frame's sampling once Pillow has opened
    it: a component whose factors do not divide the largest ("Fractional
    sampling not implemented yet"), or a baseline frame in one interleaved
    scan (the pinned decoder's) of more than 10 blocks an MCU ("Sampling
    factors too large for interleaved scan"; the port's decoder refuses
    such a scan itself, -8)."""
    samp = list(zip(hdr.comp_h, hdr.comp_v))
    if any(hdr.hmax % h or hdr.vmax % v for h, v in samp):
        return True
    return (not hdr.port_decoder and not hdr.progressive and hdr.ncomp > 1
            and sum(h * v for h, v in samp) > 10)


class FrameMarkers(NamedTuple):
    """What libjpeg and Pillow read of a JPEG's markers before its first
    scan: the first SOFn (its marker, precision, component ids and (h, v)
    sampling factors; None where there is none), and whether a JFIF APP0
    and an Adobe APP14 came (the latter's transform flag, else None)."""
    sof: Optional[int]
    precision: Optional[int]
    ids: tuple
    jfif: bool
    adobe: Optional[int]
    factors: tuple = ()


def frame_markers(data: bytes) -> FrameMarkers:
    """The markers from the SOI to the first SOS (or the EOI, or where the
    data ends or stops being markers), as libjpeg's marker reader sees
    them: a JFIF APP0 of at least 14 bytes starting ``JFIF\\0``
    (``examine_app0``), an Adobe APP14 of at least 12 starting ``Adobe``
    (``examine_app14``)."""
    sof = precision = adobe = None
    ids, factors, jfif = (), (), False
    i, n = 2, len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            break
        m = data[i + 1]
        if m == 0xFF:  # fill byte
            i += 1
            continue
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m in (0xD9, 0xDA):
            break
        seg = data[i + 4:i + 2 + ((data[i + 2] << 8) | data[i + 3])]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if sof is None:
                sof = m
                precision = seg[0] if seg else None
                if len(seg) >= 6:
                    ids = tuple(seg[6:6 + 3 * seg[5]:3])
                    factors = tuple((f >> 4, f & 15)
                                    for f in seg[7:6 + 3 * seg[5]:3])
        elif m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
    return FrameMarkers(sof, precision, ids, jfif, adobe, factors)


def colour_space(data: bytes, ncomp: int, lossless: bool = False) -> str:
    """libjpeg's ``jpeg_color_space`` of a frame of ``ncomp`` components
    (``jdapimin.c::default_decompress_parms``, libjpeg-turbo 3): "gray"
    for one; for three, "ycbcr" after a JFIF APP0, else by an Adobe
    APP14's transform (0 "rgb", any other "ycbcr"), else by the component
    ids ('R', 'G', 'B' "rgb"; others "ycbcr", but "rgb" in a lossless
    frame); for four, "cmyk" or, by an Adobe transform other than 0,
    "ycck"."""
    mk = frame_markers(data)
    if ncomp == 1:
        return "gray"
    if ncomp == 4:
        return "cmyk" if mk.adobe in (None, 0) else "ycck"
    if mk.jfif:
        return "ycbcr"
    if mk.adobe is not None:
        return "rgb" if mk.adobe == 0 else "ycbcr"
    if mk.ids == (82, 71, 66) or lossless:
        return "rgb"
    return "ycbcr"


def source_header(lib, data: bytes):
    """``jpeg_abi.parse_any``'s header of a JPEG source, ``rgb`` set for
    three components coded as RGB (:func:`colour_space`). What Pillow
    refuses raises as the reference's fetch stage meets it (a
    :class:`~imagekit_tpu_torch.errors.TransformError`, its 400):

    - "cannot identify image file" (Pillow's JPEG reader opens 8-bit
      frames of 1, 3 or 4 components only): a frame the decoders refuse
      (-3) whose precision is not 8 bits, and a frame of another component
      count (two, which the port's decoder takes for a JPEG TIFF's gray +
      alpha segments; five or more, which both refuse);
    - Pillow's "broken data stream" (libjpeg refuses the frame Pillow has
      opened), a :class:`~imagekit_tpu_torch.errors.SourceDecodeError`:
      hierarchical and lossless arithmetic frames (both decoders' -3), a
      frame with a sampling factor outside 1-4 (both decoders' -3), a
      frame only the port's decoder takes whose sampling libjpeg refuses
      (:func:`sampling_refused`), a lossless frame whose colour space
      would need a conversion (libjpeg converts none in lossless mode);
    - "image is too large": a frame of the new codings (arithmetic,
      lossless) past the pixel ceiling of Pillow's decompression-bomb
      check (:data:`~imagekit_tpu_torch.codecs.png.MAX_PIXELS`)."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi
    from imagekit_tpu_torch.codecs.png import MAX_PIXELS

    try:
        hdr = jpeg_abi.parse_any(lib, data)
    except jpeg_abi.NativeJpegError as e:
        mk = frame_markers(data)
        if any(not (1 <= f <= 4) for hv in mk.factors for f in hv):
            # libjpeg: "Bogus sampling factors"
            raise SourceDecodeError(BROKEN_STREAM) from None
        if e.code != -3:
            raise
        if mk.precision not in (None, 8) or (
                mk.sof is not None and len(mk.ids) not in (1, 3, 4)):
            raise TransformError(UNIDENTIFIED) from None
        if mk.sof in _LIBJPEG_REFUSES:
            raise SourceDecodeError(BROKEN_STREAM) from None
        raise
    if hdr.ncomp == 2:
        raise TransformError(UNIDENTIFIED)
    if not hdr.port_decoder:
        if hdr.ncomp == 3:
            hdr = dataclasses.replace(
                hdr, rgb=colour_space(data, 3) == "rgb")
        return hdr
    if sampling_refused(hdr):
        raise SourceDecodeError(BROKEN_STREAM)
    lossless = hdr.coding == jpeg_abi.LOSSLESS
    if hdr.coding != jpeg_abi.HUFFMAN and (
            hdr.width * hdr.height > MAX_PIXELS):
        raise TransformError(
            f"image is too large ({hdr.width}x{hdr.height} pixels)")
    space = colour_space(data, hdr.ncomp, lossless)
    if lossless and space not in ("gray", "rgb", "cmyk"):
        raise SourceDecodeError(BROKEN_STREAM)
    return dataclasses.replace(hdr, rgb=space == "rgb")


#: Pillow's message where libjpeg's data runs out before its decode ends
TRUNCATED = "image file is truncated ({} bytes not processed)"


def _ends_at_eoi(data: bytes) -> bool:
    """Whether an EOI marker follows the last scan's header (anything after
    it aside): libjpeg's bit reader then never runs out of bytes (it stops
    at the marker and feeds zeros). Entropy-coded data holds 0xFF only
    before 0x00 or an RSTn."""
    return data.rfind(b"\xff\xd9") > data.rfind(b"\xff\xda")


def decode_to_coefficients(data: bytes):
    """Host C++: entropy-decode a JPEG into (header, per-component
    quantised coefficient planes, quant tables), as the reference's Pillow
    decodes it; a frame the native decoder refuses with -3 (four
    components, baseline in several scans, arithmetic coding) through the
    port's own. A lossless frame gives (header, its u8 sample planes, None)
    (``jpeg_abi.decode_lossless``). The header is :func:`source_header`'s.

    Pillow hands libjpeg the file ``jpeg_abi.PILLOW_BLOCK`` bytes at a
    time, and the port answers as Pillow does where that matters:

    - an arithmetic scan that needs a byte past the blocks fed is Pillow's
      "broken data stream" (libjpeg's QM decoder cannot suspend);
    - a Huffman frame whose data ends before libjpeg's decode does (cut
      inside a scan, or, with no EOI, short of the bytes its bit reader
      reads ahead) is Pillow's "image file is truncated (n bytes not
      processed)", n the bytes libjpeg left unconsumed
      (``jpeg_abi.decode_libjpeg``, which follows libjpeg to the byte);
    - a Huffman frame the port's decoders refuse and libjpeg decodes whole
      (an EOB run past a progressive scan's last block) takes libjpeg's
      coefficients.

    Errors as :func:`decode_error` maps them, a frame's as
    :func:`source_header` refuses it, Pillow's as a
    :class:`~imagekit_tpu_torch.errors.SourceDecodeError` for a frame only
    the port's decoders take (the reference meets it at its fetch stage);
    a frame the pinned decoder takes whose sampling libjpeg refuses
    (:func:`sampling_refused`) is Pillow's 400 here, where the reference's
    engine meets it."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader

    lib = loader.load()
    try:
        hdr = source_header(lib, data)
        if sampling_refused(hdr):
            raise TransformError(BROKEN_STREAM)
        if hdr.coding == jpeg_abi.LOSSLESS:
            return hdr, jpeg_abi.decode_lossless(lib, data)[1], None
    except jpeg_abi.NativeJpegError as e:
        raise decode_error(e) from e
    refusal = SourceDecodeError if hdr.port_decoder else TransformError
    out, failed = None, None
    try:
        if hdr.port_decoder:
            out = jpeg_abi.decode4(lib, data, jpeg_abi.PILLOW_BLOCK)[1:]
        else:
            out = jpeg_abi.decode(lib, data)[1:]
    except jpeg_abi.NativeJpegError as e:
        if e.code == -3:
            raise decode_error(e) from e
        failed = e
    if hdr.coding == jpeg_abi.HUFFMAN and (
            failed is not None or not _ends_at_eoi(data)):
        try:
            _, coeffs, qtabs, unread = jpeg_abi.decode_libjpeg(
                lib, data, jpeg_abi.PILLOW_BLOCK)
        except jpeg_abi.NativeJpegError:
            unread, coeffs = None, None
        if unread is not None:
            raise refusal(TRUNCATED.format(unread))
        if failed is not None and coeffs is not None:
            out, failed = (coeffs, qtabs), None
    if failed is not None:
        raise decode_error(failed) from failed
    return (hdr, *out)


def components_to_rgb(comps, device: Optional[torch.device] = None
                      ) -> np.ndarray:
    """The device half of :func:`decode_rgb`: dequant + IDCT + chroma
    upsample + YCbCr (or CMYK, YCCK; none for RGB) -> RGB of
    :func:`decode_to_coefficients`' output, for the layouts of the module
    docstring; a lossless frame's samples to RGB
    (``dct.decode_lossless_planes``)."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi
    from imagekit_tpu_torch.ops import dct as dct_ops

    if comps[0].coding == jpeg_abi.LOSSLESS:
        return dct_ops.decode_lossless_planes(comps, device=device)
    return dct_ops.decode_components_to_rgb(comps, device=device)


def decode_rgb(data: bytes, device: Optional[torch.device] = None
               ) -> np.ndarray:
    """Host entropy decode -> device dequant + IDCT + chroma upsample +
    YCbCr -> RGB: (H, W, 3) u8, grayscale sources too (R = G = B)."""
    return components_to_rgb(decode_to_coefficients(data), device=device)


def encode_levels(img: np.ndarray, quality: int,
                  device: Optional[torch.device] = None):
    """The device half of :func:`encode_rgb`: RGB -> YCbCr + 4:2:0
    subsample + fDCT + quantise; (coefficient planes, quant tables). Any
    size up to the JPEG limit of 65535 a side: the reference hands an image
    beyond its bucket ladder to Pillow, whose failures past that limit are
    a ``TransformError``, as here."""
    from imagekit_tpu_torch.ops import dct as dct_ops

    h, w = img.shape[:2]
    if max(h, w) > JPEG_MAX_SIDE:
        raise TransformError(f"image {w}x{h} exceeds the JPEG limit of "
                             f"{JPEG_MAX_SIDE} pixels a side")
    return dct_ops.encode_rgb_to_coefficients(img, quality, device=device)


def encode_rgb(img: np.ndarray, quality: int,
               device: Optional[torch.device] = None) -> bytes:
    """Device colour, subsample and fDCT (:func:`encode_levels`) -> host
    C++ Huffman bitstream."""
    from imagekit_tpu_torch.codecs.native import loader

    planes, qtabs = encode_levels(img, quality, device=device)
    return loader.encode_jpeg(planes, qtabs, img.shape[1], img.shape[0])
