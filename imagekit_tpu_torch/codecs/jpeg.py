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
progressive: 4:2:0, 4:2:2, 4:4:0 and 4:4:4 JPEGs, their Cb and Cr with
shared or distinct tables, and grayscale JPEGs; and CMYK and YCCK JPEGs,
baseline or progressive (four components, which the native decoder
refuses with -3: the port's own entropy decode, ``jpeg_abi.decode4``, then
the four-component branch of the device decode). 12-bit and arithmetic
coding, Cb and Cr sampled differently and sampling ratios other than 1 or
2 raise :class:`~imagekit_tpu_torch.errors.NotPortedError`.
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


def decode_error(e) -> Exception:
    """Native decoder failure -> the port's error: an unsupported coding
    (arithmetic, 12-bit) is a path not ported yet; a
    CMYK or YCCK JPEG that fails is a
    :class:`~imagekit_tpu_torch.errors.SourceDecodeError`, because the
    reference decodes such a JPEG in full at its fetch stage; anything else
    is a bad source (400, as the reference's decode would give)."""
    if getattr(e, "code", None) == -3:
        return NotPortedError(
            f"a JPEG the native decoder does not take ({e})", "queue 1 item 10"
        )
    if getattr(e, "four_components", False):
        return SourceDecodeError(f"JPEG decode failed: {e}")
    return TransformError(f"JPEG decode failed: {e}")


def source_header(lib, data: bytes):
    """``jpeg_abi.parse_any``'s header of a JPEG source. A frame of two
    components, which the port's decoder takes for a JPEG TIFF's gray +
    alpha segments, raises the decoders' -3: Pillow has no mode for a JPEG
    file of two components, and the port does not serve one."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi

    hdr = jpeg_abi.parse_any(lib, data)
    if hdr.ncomp == 2:
        raise jpeg_abi.NativeJpegError(-3)
    return hdr


def decode_to_coefficients(data: bytes):
    """Host C++: entropy-decode a JPEG into per-component quantised
    coefficient planes + quant tables + sampling factors; a four-component
    frame, which the native decoder refuses with -3, through the port's own
    (``jpeg_abi.decode_any``). Errors as :func:`decode_error` maps them,
    a two-component frame's as :func:`source_header` refuses it."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader

    lib = loader.load()
    try:
        source_header(lib, data)
        return jpeg_abi.decode_any(lib, data)
    except jpeg_abi.NativeJpegError as e:
        raise decode_error(e) from e


def components_to_rgb(comps, device: Optional[torch.device] = None
                      ) -> np.ndarray:
    """The device half of :func:`decode_rgb`: dequant + IDCT + chroma
    upsample + YCbCr (or CMYK, YCCK) -> RGB of
    :func:`decode_to_coefficients`' output, for the layouts of the module
    docstring."""
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
