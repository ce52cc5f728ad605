"""PNG decode without Pillow, over the port's native library.

Counterpart of ``imagekit_tpu/codecs/png.py:73-106``: the C++ decoder
(``ik_png_parse`` / ``ik_png_decode`` of ``native/png_decode.cpp``, a copy
of the reference's, bound here as the reference's ``_lib`` binds it)
inflates IDAT, unfilters the scanlines and expands grayscale and palette
images to RGB, alpha to RGBA. What differs from the reference:

- the decompression-bomb ceiling is a constant (:data:`MAX_PIXELS`, the
  reference's default), so Pillow is never imported;
- where the reference hands a PNG to Pillow (a PNG the native decoder
  does not take), this raises
  :class:`~imagekit_tpu_torch.errors.NotPortedError`, except for the
  IHDR's method bytes, which the native decoder refuses and Pillow reads
  (:func:`_ihdr`): a compression method (byte 10) other than 0, which
  Pillow ignores, is decoded as 0; a filter method (byte 11) other than
  0, which Pillow refuses, is its "cannot identify image file".

A corrupt PNG raises :class:`~imagekit_tpu_torch.errors.TransformError`
with the reference's message.
"""

from __future__ import annotations

import ctypes
import zlib
from typing import Tuple

import numpy as np

from imagekit_tpu_torch.errors import NotPortedError, TransformError

#: twice PIL's default ``MAX_IMAGE_PIXELS`` (89,478,485), where PIL and the
#: reference's native decode refuse an image
MAX_PIXELS = 2 * 89_478_485

_OK = 0
_UNSUPPORTED = -3


def _not_ported(what: str) -> NotPortedError:
    """The pinned decoder's only -3 (a compression or filter method other
    than 0), which :func:`_ihdr` answers or rewrites before it decodes."""
    return NotPortedError(what, None)


class _IkPngInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("color_type", ctypes.c_int32),
        ("bit_depth", ctypes.c_int32),
        ("interlaced", ctypes.c_int32),
    ]


_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    from imagekit_tpu_torch.codecs.native import loader

    lib = loader.load()
    if not _configured:
        lib.ik_png_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(_IkPngInfo),
        ]
        lib.ik_png_parse.restype = ctypes.c_int
        lib.ik_png_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.ik_png_decode.restype = ctypes.c_int
        _configured = True
    return lib


def _check(rc: int) -> None:
    if rc == _UNSUPPORTED:
        raise _not_ported("a PNG the native decoder does not take")
    if rc != _OK:
        raise TransformError(f"corrupt PNG ({rc})")


def _ihdr(data: bytes) -> bytes:
    """The PNG as the native decoder should read it, by the IHDR's method
    bytes as Pillow reads them: filter method (byte 11) not 0 is refused
    (Pillow has no such PNG: "cannot identify image file"); compression
    method (byte 10) not 0 is read as 0 (Pillow never looks at it), the
    byte cleared and the chunk's CRC, where it held, made again."""
    if len(data) < 33 or data[12:16] != b"IHDR":
        return data
    if data[27]:
        raise TransformError("cannot identify image file")
    if not data[26]:
        return data
    fixed = bytearray(data)
    fixed[26] = 0
    if zlib.crc32(data[12:29]) == int.from_bytes(data[29:33], "big"):
        fixed[29:33] = zlib.crc32(fixed[12:29]).to_bytes(4, "big")
    return bytes(fixed)


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of the decoded image, after
    the pixel ceiling."""
    data = _ihdr(data)
    info = _IkPngInfo()
    _check(_lib().ik_png_parse(data, len(data), ctypes.byref(info)))
    if info.width * info.height > MAX_PIXELS:
        raise TransformError(
            f"image is too large ({info.width}x{info.height} pixels)")
    return info.width, info.height, info.channels


def decode(data: bytes) -> np.ndarray:
    """PNG -> (H, W, C) u8: C = 3 for RGB, grayscale and palette sources,
    4 when the source has alpha."""
    w, h, ch = parse(data)
    data = _ihdr(data)
    out = np.empty((h, w, ch), np.uint8)
    _check(_lib().ik_png_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes))
    return out
