"""GIF and BMP decode without Pillow, over the port's native library.

Counterpart of ``imagekit_tpu/codecs/misc.py``: ``native/misc_decode.cpp``
(a copy of the reference's) decodes a GIF's first frame (LZW, interlace,
GCE transparency -> RGBA) and uncompressed 24/32 bpp or 8 bpp palette
BMPs. A BMP it refuses as unsupported (-3), which the reference hands to
Pillow, goes to the port's own ``native/bmp_ext_decode.cpp``
(BITMAPCOREHEADER, 16 bpp, the bit-field layouts Pillow reads), as a TIFF
goes from ``tiff_decode.cpp`` to ``tiff_ext_decode.cpp``
(:mod:`.tiff`): :func:`parse` and :func:`decode` try a decoder's
``ext`` stem only where its pinned one says -3 (the 4 bpp gray-palette
core BMP among the port's: Pillow's 8-bit reading of its rows). What
differs from the reference, as in :mod:`.png`: the decompression-bomb
ceiling is the constant :data:`png.MAX_PIXELS`, so Pillow is never
imported. A variant neither decoder takes would raise
:class:`~imagekit_tpu_torch.errors.NotPortedError`, a guard: every BMP
header and every mode of Pillow's TIFF reader answers as the reference.
Pillow's messages where its read fails after it opened the file: "decoder
error -2" (:data:`DECODER_ERROR`), "codec configuration error"
(:data:`CODEC_CONFIG`). Corrupt data raises
:class:`~imagekit_tpu_torch.errors.TransformError` with the reference's
message where the pinned decoder finds it. The decoders share one info
structure and one pair of signatures.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from imagekit_tpu_torch.codecs.png import MAX_PIXELS
from imagekit_tpu_torch.errors import NotPortedError, TransformError

_OK = 0
_UNSUPPORTED = -3
BUFFER = -7
#: the port's decoders' code for a layout Pillow refuses (the reference
#: answers it as corrupt data)
REFUSED = -8
#: the port's decoders' code for a file Pillow opens and whose read
#: through libtiff fails
DECODER_ERROR = -9
#: Pillow's message for it
PILLOW_DECODER_ERROR = "decoder error -2"
#: the port's decoders' code for a file whose rows Pillow's raw decoder
#: refuses to unpack, and Pillow's message
CODEC_CONFIG = -10
PILLOW_CODEC_CONFIG = "codec configuration error when reading image file"
#: the port's decoders' code for a planar file Pillow's raw reader has no
#: unpacker for, and Pillow's message
RAW_MODE = -12
PILLOW_RAW_MODE = "unknown raw mode for given image mode"


class _IkInfo(ctypes.Structure):
    """``IkMiscInfo`` / ``IkTiffInfo``: the decoded image's geometry; then
    ``IkTiffxInfo``'s layout (what ``ik_tiffx_decode`` writes, or a JPEG
    TIFF's segments: ``tiff_ext_decode.cpp``) and, where it refuses a YCbCr
    TIFF without compression, the bytes Pillow's read leaves unread (-1
    else), which the other decoders leave as they are."""

    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("layout", ctypes.c_int32),
        ("unread", ctypes.c_int32),
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


def check(rc: int, what: str, corrupt: str) -> None:
    """A decoder's return code -> nothing for 0, else the port's error."""
    if rc == _UNSUPPORTED:  # a guard: no input reaches it (tests)
        raise NotPortedError(
            f"a {what} neither native decoder takes (a guard no input "
            f"reaches)", None)
    if rc == REFUSED:  # Pillow's words, less the address of its buffer
        raise TransformError("cannot identify image file")
    if rc == DECODER_ERROR:
        raise TransformError(PILLOW_DECODER_ERROR)
    if rc == CODEC_CONFIG:
        raise TransformError(PILLOW_CODEC_CONFIG)
    if rc == RAW_MODE:
        raise TransformError(PILLOW_RAW_MODE)
    if rc != _OK:
        raise TransformError(f"corrupt {corrupt} ({rc})")


def header(data: bytes, stem: str, what: str, corrupt: str,
           ext: Optional[str]) -> Tuple[int, int, int, str, int]:
    """(width, height, channels, the stem that took the data, its
    layout). A refusal that counts unread bytes is Pillow's message for a
    file its read runs out of."""
    info = _IkInfo(unread=-1)
    rc = _fn(f"ik_{stem}_parse", _IkInfo)(data, len(data), ctypes.byref(info))
    if rc == _UNSUPPORTED and ext is not None:
        stem = ext
        rc = _fn(f"ik_{ext}_parse", _IkInfo)(data, len(data),
                                             ctypes.byref(info))
    if rc == REFUSED and info.unread >= 0:
        raise TransformError(f"image file is truncated ({info.unread} bytes "
                             f"not processed)")
    check(rc, what, corrupt)
    if info.width * info.height > MAX_PIXELS:
        raise TransformError(
            f"image is too large ({info.width}x{info.height} pixels)")
    return info.width, info.height, info.channels, stem, info.layout


def parse(data: bytes, stem: str, what: str, corrupt: str = "image",
          ext: Optional[str] = None) -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of what the decoder writes,
    after the pixel ceiling. ``stem`` names the decoder
    (``ik_<stem>_parse``), ``ext`` the port's own decoder tried where it
    says -3."""
    return header(data, stem, what, corrupt, ext)[:3]


def decode(data: bytes, stem: str, what: str, corrupt: str = "image",
           ext: Optional[str] = None, head=None) -> Tuple[np.ndarray, str]:
    """``data`` -> ((H, W, C) u8, the stem that decoded it), through
    ``ik_<stem>_parse`` and ``ik_<stem>_decode`` (or ``ext``'s); C = 3, or
    4 for alpha (or for what the ``ext`` decoder says it writes). ``head``
    is :func:`header`'s result, where the caller has read it."""
    w, h, ch, stem, _ = head or header(data, stem, what, corrupt, ext)
    out = np.empty((h, w, ch), np.uint8)
    check(_fn(f"ik_{stem}_decode", None)(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes),
        what, corrupt)
    return out, stem


def parse_gif(data: bytes) -> Tuple[int, int, int]:
    return parse(data, "gif", "GIF")


def parse_bmp(data: bytes) -> Tuple[int, int, int]:
    return parse(data, "bmp", "BMP", ext="bmpx")


def decode_gif(data: bytes) -> np.ndarray:
    """First frame of a GIF -> RGB, or RGBA with a transparent index."""
    return decode(data, "gif", "GIF")[0]


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP -> RGB, or RGBA for the 32 bpp bit-field layouts Pillow reads
    with alpha."""
    return decode(data, "bmp", "BMP", ext="bmpx")[0]
