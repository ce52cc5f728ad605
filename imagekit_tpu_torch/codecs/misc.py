"""GIF and BMP decode without Pillow, over the port's native library.

Counterpart of ``imagekit_tpu/codecs/misc.py``: ``native/misc_decode.cpp``
(a copy of the reference's) decodes a GIF's first frame (LZW, interlace,
GCE transparency -> RGBA) and uncompressed 24/32 bpp or 8 bpp palette
BMPs. What differs from the reference, as in :mod:`.png`: the
decompression-bomb ceiling is the constant :data:`png.MAX_PIXELS`, so
Pillow is never imported, and a variant the native decoder does not take
(the reference hands it to Pillow) raises
:class:`~imagekit_tpu_torch.errors.NotPortedError`. Corrupt data raises
:class:`~imagekit_tpu_torch.errors.TransformError` with the reference's
message. :mod:`.tiff` binds its decoder through the same helpers: the three
decoders share one info structure and one pair of signatures.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from imagekit_tpu_torch.codecs.png import MAX_PIXELS
from imagekit_tpu_torch.errors import NotPortedError, TransformError

_OK = 0
_UNSUPPORTED = -3


class _IkInfo(ctypes.Structure):
    """``IkMiscInfo`` / ``IkTiffInfo``: the decoded image's geometry."""

    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
    ]


_configured = set()


def _fn(name: str, out_type):
    """``ik_<name>`` of the native library, bound once: parse functions
    take the info structure, decode functions the output buffer and its
    size."""
    from imagekit_tpu_torch.codecs.native import loader

    fn = getattr(loader.load(), name)
    if name not in _configured:
        tail = ([ctypes.POINTER(_IkInfo)] if out_type is _IkInfo
                else [ctypes.c_void_p, ctypes.c_size_t])
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, *tail]
        fn.restype = ctypes.c_int
        _configured.add(name)
    return fn


def _check(rc: int, what: str, corrupt: str) -> None:
    if rc == _UNSUPPORTED:
        raise NotPortedError(
            f"a {what} the native decoder does not take (the host-library "
            f"fallback)", "queue 1 item 9")
    if rc != _OK:
        raise TransformError(f"corrupt {corrupt} ({rc})")


def parse(data: bytes, stem: str, what: str,
          corrupt: str = "image") -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of the decoded image, after
    the pixel ceiling. ``stem`` names the decoder (``ik_<stem>_parse``)."""
    info = _IkInfo()
    _check(_fn(f"ik_{stem}_parse", _IkInfo)(data, len(data),
                                           ctypes.byref(info)), what, corrupt)
    if info.width * info.height > MAX_PIXELS:
        raise TransformError(
            f"image is too large ({info.width}x{info.height} pixels)")
    return info.width, info.height, info.channels


def decode(data: bytes, stem: str, what: str,
           corrupt: str = "image") -> np.ndarray:
    """``data`` -> (H, W, C) u8, C = 3 or 4 (alpha), through
    ``ik_<stem>_parse`` and ``ik_<stem>_decode``."""
    w, h, ch = parse(data, stem, what, corrupt)
    out = np.empty((h, w, ch), np.uint8)
    _check(_fn(f"ik_{stem}_decode", None)(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes),
        what, corrupt)
    return out


def parse_gif(data: bytes) -> Tuple[int, int, int]:
    return parse(data, "gif", "GIF")


def parse_bmp(data: bytes) -> Tuple[int, int, int]:
    return parse(data, "bmp", "BMP")


def decode_gif(data: bytes) -> np.ndarray:
    """First frame of a GIF -> RGB, or RGBA with a transparent index."""
    return decode(data, "gif", "GIF")


def decode_bmp(data: bytes) -> np.ndarray:
    return decode(data, "bmp", "BMP")
