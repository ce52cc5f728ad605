"""QOI sources without Pillow.

The reference decodes QOI with Pillow (``imagekit_tpu/codecs/pil_backend.py``,
``PIL/QoiImagePlugin.py``); this is the port's decode over
``native/raster_decode.cpp`` (``ik_qoi_decode``, every chunk kind), with the
header read here. As in Pillow, a channel count of 3 is RGB and any other
RGBA (kept as RGBA, alpha and all: Pillow's mode says so), the colour-space
byte and the end marker are not read, and chunks that end before the last
pixel are an error. The decompression-bomb ceiling is
:data:`png.MAX_PIXELS`, after the header.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import numpy as np

from imagekit_tpu_torch.codecs.png import MAX_PIXELS
from imagekit_tpu_torch.errors import TransformError

_HEADER = 14


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels of the decoded image)."""
    if len(data) < 13 or data[:4] != b"qoif":
        raise TransformError("not a QOI file")
    w, h = struct.unpack(">II", data[4:12])
    if w == 0 or h == 0:
        raise TransformError("not identified by this driver")
    if w * h > MAX_PIXELS:
        raise TransformError(f"image is too large ({w}x{h} pixels)")
    return w, h, 3 if data[12] == 3 else 4


def decode(data: bytes) -> np.ndarray:
    """QOI -> (H, W, 3) or (H, W, 4) u8."""
    from imagekit_tpu_torch.codecs.native import loader

    w, h, ch = parse(data)
    out = np.empty((h, w, ch), np.uint8)
    body = data[_HEADER:]
    rc = loader.load().ik_qoi_decode(body, len(body), w, h, ch,
                                     out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise TransformError(f"corrupt QOI data ({rc})")
    return out
