"""DDS sources without Pillow.

The reference decodes DirectDraw Surfaces with Pillow
(``imagekit_tpu/codecs/pil_backend.py``, ``PIL/DdsImagePlugin.py``); this
module gives the same pixels for the layouts Pillow writes:

- uncompressed RGB and RGBA by their bit masks (each channel
  ``int(v / max * 255)``; like Pillow's reader, a raster cut short reads as
  zeros), 8-bit luminance and 16-bit luminance + alpha;
- DXT1, DXT3 and DXT5 (FourCC, or BC1/BC2/BC3 in a DX10 header) and BC5
  (``BC5U``/``ATI2``, or a DX10 header), decoded block by block in
  ``native/raster_decode.cpp`` (``ik_bcn_decode``), the blocks past the
  right and bottom edges cut.

The output is Pillow's mode after ``pil_backend.decode``: RGBA for RGBA,
luminance + alpha and DXT1/3/5 (alpha kept), RGB for the rest. The
layouts Pillow reads but cannot write, so that no fixture holds them
(palette, BC4, signed BC5, BC6H, BC7, DX10 R8G8B8A8), raise
:class:`~imagekit_tpu_torch.errors.NotPortedError` (ROADMAP queue 1 item
9); what Pillow does not read is a
:class:`~imagekit_tpu_torch.errors.TransformError`. The decompression-bomb
ceiling is :data:`png.MAX_PIXELS`, after the header.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from imagekit_tpu_torch.codecs.png import MAX_PIXELS
from imagekit_tpu_torch.errors import NotPortedError, TransformError

_RGB, _ALPHAPIXELS, _FOURCC, _PALETTE, _LUMINANCE = (
    0x40, 0x1, 0x4, 0x20, 0x20000)
#: FourCC -> BCn kind of ``ik_bcn_decode``
_FOURCC_BCN = {b"DXT1": 1, b"DXT3": 2, b"DXT5": 3, b"BC5U": 5, b"ATI2": 5}
#: DX10 DXGI format -> BCn kind (the unsigned BC1/2/3/5 Pillow reads)
_DXGI_BCN = {70: 1, 71: 1, 73: 2, 74: 2, 76: 3, 77: 3, 82: 5, 83: 5}
_FOURCC_NOT_PORTED = {b"BC4U": "BC4", b"ATI1": "BC4", b"BC5S": "signed BC5"}
_DXGI_NOT_PORTED = {79: "BC4", 80: "BC4", 84: "signed BC5", 95: "BC6H",
                    96: "BC6H", 97: "BC7", 98: "BC7", 99: "BC7",
                    27: "R8G8B8A8", 28: "R8G8B8A8", 29: "R8G8B8A8"}


@dataclass
class _Layout:
    width: int
    height: int
    kind: str          # "masks", "L", "LA" or "bcn"
    offset: int        # where the raster starts
    channels: int      # of the decoded image
    bitcount: int = 0
    masks: Tuple[int, ...] = ()
    bcn: int = 0


def _not_ported(what: str):
    return NotPortedError(f"a DDS in {what} (a layout Pillow reads but no "
                          f"fixture here holds)", "queue 1 item 9")


def _layout(data: bytes) -> _Layout:
    if len(data) < 8 or data[:4] != b"DDS ":
        raise TransformError("not a DDS file")
    (size,) = struct.unpack("<I", data[4:8])
    if size != 124:
        raise TransformError(f"Unsupported header size {size!r}")
    header = data[8:128]
    if len(header) != 120:
        raise TransformError(f"Incomplete header: {len(header)} bytes")
    _, h, w = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<3I", header[72:84])
    if w == 0 or h == 0:
        raise TransformError("not identified by this driver")
    if w * h > MAX_PIXELS:
        raise TransformError(f"image is too large ({w}x{h} pixels)")
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack(f"<{n}I", header[84:84 + 4 * n])
        return _Layout(w, h, "masks", 128, n, bitcount, masks)
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            return _Layout(w, h, "L", 128, 3)
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            return _Layout(w, h, "LA", 128, 4)
        raise TransformError(f"Unsupported bitcount {bitcount} for {pfflags}")
    if pfflags & _PALETTE:
        raise _not_ported("8-bit palette")
    if not pfflags & _FOURCC:
        raise TransformError(f"Unknown pixel format flags {pfflags}")
    code = struct.pack("<I", fourcc)
    if code in _FOURCC_BCN:
        n = _FOURCC_BCN[code]
        return _Layout(w, h, "bcn", 128, 3 if n == 5 else 4, bcn=n)
    if code in _FOURCC_NOT_PORTED:
        raise _not_ported(_FOURCC_NOT_PORTED[code])
    if code != b"DX10":
        raise TransformError(f"Unimplemented pixel format {fourcc!r}")
    if len(data) < 148:
        raise TransformError("Incomplete DX10 header")
    (dxgi,) = struct.unpack("<I", data[128:132])
    if dxgi in _DXGI_BCN:
        n = _DXGI_BCN[dxgi]
        return _Layout(w, h, "bcn", 148, 3 if n == 5 else 4, bcn=n)
    if dxgi in _DXGI_NOT_PORTED:
        raise _not_ported(f"DX10 {_DXGI_NOT_PORTED[dxgi]}")
    raise TransformError(f"Unimplemented DXGI format {dxgi}")


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels of the decoded image)."""
    lay = _layout(data)
    return lay.width, lay.height, lay.channels


def _by_masks(body: bytes, lay: _Layout) -> np.ndarray:
    """Pillow's ``DdsRgbDecoder``: ``bitcount // 8`` little-endian bytes a
    pixel (zeros past the end of the data), each mask's bits scaled to
    ``int(v / max * 255)``."""
    px = lay.width * lay.height
    step = lay.bitcount // 8
    words = np.zeros((px, 8), np.uint8)  # the masks see the low 4 bytes
    if step:
        nb = min(step, 8)
        full = min(len(body) // step, px)
        words[:full, :nb] = np.frombuffer(
            body, np.uint8, full * step).reshape(full, step)[:, :nb]
        rest = body[full * step:full * step + nb]
        if full < px and rest:
            words[full, :len(rest)] = np.frombuffer(rest, np.uint8)
    value = words.view("<u8")[:, 0]
    out = np.zeros((px, len(lay.masks)), np.uint8)
    for i, mask in enumerate(lay.masks):
        if mask == 0:
            continue
        shift = (mask & -mask).bit_length() - 1
        top = mask >> shift
        v = (value & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = (v.astype(np.float64) / top * 255).astype(np.uint8)
    return out.reshape(lay.height, lay.width, len(lay.masks))


def decode(data: bytes) -> np.ndarray:
    """DDS -> (H, W, 3) or (H, W, 4) u8."""
    lay = _layout(data)
    body = data[lay.offset:]
    w, h = lay.width, lay.height
    if lay.kind == "masks":
        return _by_masks(body, lay)
    if lay.kind in ("L", "LA"):
        n = 1 if lay.kind == "L" else 2
        if len(body) < w * h * n:
            raise TransformError("image file is truncated")
        px = np.frombuffer(body, np.uint8, w * h * n).reshape(h, w, n)
        rgb = np.repeat(px[:, :, :1], 3, axis=2)
        return rgb if n == 1 else np.concatenate([rgb, px[:, :, 1:]], axis=2)
    from imagekit_tpu_torch.codecs.native import loader

    out = np.empty((h, w, lay.channels), np.uint8)
    rc = loader.load().ik_bcn_decode(body, len(body), w, h, lay.bcn,
                                     out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise TransformError("image file is truncated")
    return out
