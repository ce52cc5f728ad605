"""ICO sources without Pillow.

The reference decodes Windows icons with Pillow
(``imagekit_tpu/codecs/pil_backend.py``, ``PIL/IcoImagePlugin.py``); this
module gives the same pixels from the port's own decoders:

- the entry is Pillow's choice: the directory stably sorted by colour
  depth, then by area, largest first, and the first taken (so among the
  largest, the lowest depth);
- a PNG entry decodes with :mod:`.png` (RGB, or RGBA where the PNG has
  alpha, as ``pil_backend.decode`` keeps it);
- a BMP entry is a DIB whose header states twice the height (the colour
  image, then the AND mask): it decodes with :mod:`.misc`'s BMP decoder,
  behind a file header made here, at half that height, and always comes
  out RGBA: below 32 bits a pixel the AND mask is the alpha (a set bit
  transparent), at 32 the fourth byte of each pixel is.

The decompression-bomb ceiling is :data:`png.MAX_PIXELS`, after each
header. A BMP entry the native decoder does not take raises
:class:`~imagekit_tpu_torch.errors.NotPortedError`, as a BMP source does.
"""

from __future__ import annotations

import math
import struct
from typing import List, NamedTuple, Tuple

import numpy as np

from imagekit_tpu_torch.codecs import misc, png
from imagekit_tpu_torch.codecs.png import MAX_PIXELS
from imagekit_tpu_torch.errors import TransformError

_PNG = b"\x89PNG\r\n\x1a\n"


class _Entry(NamedTuple):
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    depth: int  # Pillow's ``color_depth``, which orders the entries


def _entries(data: bytes) -> List[_Entry]:
    if len(data) < 6 or data[:4] != b"\x00\x00\x01\x00":
        raise TransformError("not an ICO file")
    (count,) = struct.unpack("<H", data[4:6])
    out = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise TransformError("truncated ICO directory")
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack("<HII", s[6:16])
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        out.append(_Entry(w, h, bpp, size, offset, depth))
    if not out:
        raise TransformError("no images in the ICO directory")
    out.sort(key=lambda e: e.depth)
    out.sort(key=lambda e: e.width * e.height, reverse=True)
    return out


def _dib(data: bytes, e: _Entry):
    """(BMP file of the colour image, width, height, bpp, pixel offset in
    ``data``) of a BMP entry."""
    at = e.offset
    if len(data) < at + 40:
        raise TransformError("truncated ICO bitmap header")
    hsz, w, h2 = struct.unpack("<IiI", data[at:at + 12])
    (bpp,) = struct.unpack("<H", data[at + 14:at + 16])
    (colors,) = struct.unpack("<I", data[at + 32:at + 36])
    h = h2 // 2
    if w <= 0 or h <= 0:
        raise TransformError("not identified by this driver")
    if w * h > MAX_PIXELS:
        raise TransformError(f"image is too large ({w}x{h} pixels)")
    palette = 4 * (colors or 1 << bpp) if bpp <= 8 else 0
    pix = at + hsz + palette
    header = bytearray(data[at:pix])
    header[8:12] = struct.pack("<I", h)
    body = bytes(header) + data[pix:]
    bmp = (b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0,
                               14 + hsz + palette) + body)
    return bmp, w, h, bpp, pix


def _bmp_entry(data: bytes, e: _Entry) -> np.ndarray:
    bmp, w, h, bpp, pix = _dib(data, e)
    rgb = misc.decode_bmp(bmp)
    if bpp == 32:
        raw = data[pix:pix + w * h * 4]
        if len(raw) < w * h * 4:
            raise TransformError("not enough image data")
        alpha = np.frombuffer(raw, np.uint8).reshape(h, w, 4)[::-1, :, 3]
    else:
        stride = (w + 31) // 32 * 4
        start = e.offset + e.size - stride * h
        raw = data[start:start + stride * h] if start >= 0 else b""
        if len(raw) < stride * h:
            raise TransformError("not enough image data")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride),
                             axis=1)[::-1, :w]
        alpha = np.where(bits == 1, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, alpha[:, :, None]], axis=2)


def _png_entry(data: bytes, e: _Entry) -> Tuple[int, int, int]:
    w, h, ch = png.parse(data[e.offset:])
    if w * h > MAX_PIXELS:
        raise TransformError(f"image is too large ({w}x{h} pixels)")
    return w, h, ch


def parse(data: bytes) -> Tuple[int, int, int]:
    """Directory and the chosen entry's header: (width, height, channels)."""
    e = _entries(data)[0]
    if data[e.offset:e.offset + 8] == _PNG:
        return _png_entry(data, e)
    _, w, h, _, _ = _dib(data, e)
    return w, h, 4


def decode(data: bytes) -> np.ndarray:
    """ICO -> (H, W, 3) or (H, W, 4) u8: the entry Pillow loads."""
    e = _entries(data)[0]
    if data[e.offset:e.offset + 8] == _PNG:
        _png_entry(data, e)
        return png.decode(data[e.offset:])
    return _bmp_entry(data, e)
