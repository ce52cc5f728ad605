"""PNG decode without Pillow, over the reference's native ABI.

Counterpart of ``imagekit_tpu/codecs/png.py:73-106``: the C++ decoder
(``ik_png_parse`` / ``ik_png_decode`` in the reference's native library,
bound by ``imagekit_tpu.codecs.png._lib``) inflates IDAT, unfilters the
scanlines and expands grayscale and palette images to RGB, alpha to RGBA.
What differs from the reference:

- the decompression-bomb ceiling is a constant (:data:`MAX_PIXELS`, the
  reference's default), so Pillow is never imported;
- where the reference hands a PNG to Pillow (a PNG the native decoder
  does not take, or no native library), this raises
  :class:`~imagekit_tpu_torch.errors.NotPortedError`.

A corrupt PNG raises :class:`~imagekit_tpu.errors.TransformError` with the
reference's message.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from imagekit_tpu.codecs import png as _native
from imagekit_tpu.errors import TransformError
from imagekit_tpu_torch.errors import NotPortedError

#: twice PIL's default ``MAX_IMAGE_PIXELS`` (89,478,485), where PIL and the
#: reference's native decode refuse an image
MAX_PIXELS = 2 * 89_478_485

_OK = 0
_UNSUPPORTED = -3


def _not_ported(what: str) -> NotPortedError:
    return NotPortedError(f"{what} (the host-library fallback)",
                          "queue 1 item 9")


def _lib() -> ctypes.CDLL:
    lib = _native._lib()
    if lib is None:
        raise _not_ported("a PNG decode with no native codec library")
    return lib


def _check(rc: int) -> None:
    if rc == _UNSUPPORTED:
        raise _not_ported("a PNG the native decoder does not take")
    if rc != _OK:
        raise TransformError(f"corrupt PNG ({rc})")


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of the decoded image, after
    the pixel ceiling."""
    info = _native._IkPngInfo()
    _check(_lib().ik_png_parse(data, len(data), ctypes.byref(info)))
    if info.width * info.height > MAX_PIXELS:
        raise TransformError(
            f"image is too large ({info.width}x{info.height} pixels)")
    return info.width, info.height, info.channels


def decode(data: bytes) -> np.ndarray:
    """PNG -> (H, W, C) u8: C = 3 for RGB, grayscale and palette sources,
    4 when the source has alpha."""
    w, h, ch = parse(data)
    out = np.empty((h, w, ch), np.uint8)
    _check(_lib().ik_png_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes))
    return out
