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
factors), each with its own table, and grayscale JPEGs; CMYK and YCCK
JPEGs, baseline or progressive; and baseline frames in several scans.
The pinned native decoder refuses the last two with -3; the port's own
entropy decode (``jpeg_abi.decode4``) takes them, then the device decode.
A frame whose precision is not 8 bits and one whose sampling libjpeg
refuses (:func:`sampling_refused`) answer 400, as Pillow's refusals do in
the reference; arithmetic coding raises
:class:`~imagekit_tpu_torch.errors.NotPortedError`.
"""

from __future__ import annotations

from typing import Optional

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


def decode_error(e) -> Exception:
    """Native decoder failure -> the port's error: an unsupported coding
    (arithmetic) is a path not ported yet; a frame that only the port's
    decoder takes (CMYK, YCCK, baseline in several scans) that fails is a
    :class:`~imagekit_tpu_torch.errors.SourceDecodeError`, because the
    reference decodes such a JPEG in full at its fetch stage (an
    interleaved scan of more than 10 blocks an MCU, -8, with Pillow's
    message); anything else is a bad source (400, as the reference's decode
    would give)."""
    if getattr(e, "code", None) == -3:
        return NotPortedError(
            f"a JPEG the native decoder does not take ({e})", "queue 1 item 10"
        )
    if getattr(e, "four_components", False):
        return SourceDecodeError(BROKEN_STREAM if e.code == -8
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


def frame_precision(data: bytes) -> Optional[int]:
    """The sample precision of a JPEG's frame header (the first SOFn), None
    where the markers end or a scan starts first."""
    i, n = 2, len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            return None
        m = data[i + 1]
        if m == 0xFF:  # fill byte
            i += 1
            continue
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m in (0xD9, 0xDA):
            return None
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return data[i + 4] if i + 4 < n else None
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
    return None


def source_header(lib, data: bytes):
    """``jpeg_abi.parse_any``'s header of a JPEG source. A frame of two
    components, which the port's decoder takes for a JPEG TIFF's gray +
    alpha segments, raises the decoders' -3: Pillow has no mode for a JPEG
    file of two components, and the port does not serve one. A frame the
    decoders refuse (-3) whose precision is not 8 bits is Pillow's
    "cannot identify image file" (its JPEG reader opens 8-bit frames
    only), a :class:`~imagekit_tpu_torch.errors.TransformError`: the
    reference's fetch stage answers such a source with its 400. So does a
    frame only the port's decoder takes whose sampling libjpeg refuses
    (:func:`sampling_refused`: the reference decodes it at its fetch
    stage), a :class:`~imagekit_tpu_torch.errors.SourceDecodeError` with
    Pillow's message."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi

    try:
        hdr = jpeg_abi.parse_any(lib, data)
    except jpeg_abi.NativeJpegError as e:
        if e.code == -3 and frame_precision(data) not in (None, 8):
            raise TransformError("cannot identify image file") from None
        raise
    if hdr.ncomp == 2:
        raise jpeg_abi.NativeJpegError(-3)
    if hdr.port_decoder and sampling_refused(hdr):
        raise SourceDecodeError(BROKEN_STREAM)
    return hdr


def decode_to_coefficients(data: bytes):
    """Host C++: entropy-decode a JPEG into per-component quantised
    coefficient planes + quant tables + sampling factors; a frame the
    native decoder refuses with -3 (four components, baseline in several
    scans) through the port's own (``jpeg_abi.decode_any``). Errors as
    :func:`decode_error` maps them, a frame's as :func:`source_header`
    refuses it; a frame the pinned decoder takes whose sampling libjpeg
    refuses (:func:`sampling_refused`) is Pillow's 400 here, where the
    reference's engine meets it."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader

    lib = loader.load()
    try:
        if sampling_refused(source_header(lib, data)):
            raise TransformError(BROKEN_STREAM)
        return jpeg_abi.decode_any(lib, data)
    except jpeg_abi.NativeJpegError as e:
        raise decode_error(e) from e


def components_to_rgb(comps, device: Optional[torch.device] = None
                      ) -> np.ndarray:
    """The device half of :func:`decode_rgb`: dequant + IDCT + chroma
    upsample + YCbCr (or CMYK, YCCK) -> RGB of
    :func:`decode_to_coefficients`' output, for the layouts of the module
    docstring (a four-component frame sampled other than 1x or 2x raises
    :class:`~imagekit_tpu_torch.errors.NotPortedError`)."""
    from imagekit_tpu_torch.ops import dct as dct_ops

    try:
        return dct_ops.decode_components_to_rgb(comps, device=device)
    except ValueError as e:
        raise NotPortedError(
            f"a JPEG sampling the JPEG pixel decode does not take ({e})",
            "queue 1 item 10") from None


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
