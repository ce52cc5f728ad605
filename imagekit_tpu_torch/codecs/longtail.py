"""Long-tail input formats: Radiance HDR and farbfeld.

A copy of ``imagekit_tpu/codecs/longtail.py`` (pure numpy; only the error
import differs). The reference accepts a superset of the upstream
service's inputs: its native C++ decoders cover
JPEG/PNG/WebP/GIF/BMP/TIFF/AVIF, Pillow covers ICO/QOI/PNM/DDS, and this
module covers the two formats neither handles. The port has the native
decoders and this module, and no Pillow: ICO, QOI, PNM and DDS sources
answer :class:`~imagekit_tpu_torch.errors.NotPortedError`.

- **farbfeld** (suckless): 8-byte magic, u32 BE dims, RGBA u16 BE.
- **Radiance HDR** (RGBE): ASCII header + RGBE scanlines (new-style
  per-component RLE and old-style flat/run encodings). Pixels convert
  the way the upstream service's ``DynamicImage::to_rgb8`` would have
  (``ldexp(c, e-136)`` shared-exponent expansion, then clamp to u8):
  HDR content above 1.0 clips.

OpenEXR is detected (so the error says what it is) but not decoded:
half-float + zip/piz compression is a full library, and the upstream
service rejects EXR too.
"""

from __future__ import annotations

import struct

import numpy as np

from imagekit_tpu_torch.errors import TransformError

FARBFELD_MAGIC = b"farbfeld"
HDR_MAGICS = (b"#?RADIANCE", b"#?RGBE")
EXR_MAGIC = b"\x76\x2f\x31\x01"

_MAX_PIXELS = 100_000_000  # decompression-bomb guard (shared posture
# with the native codecs' _bomb_guard)


def decode_farbfeld(data: bytes) -> np.ndarray:
    """farbfeld -> HWC u8 RGBA (alpha preserved; 16->8 bit via the
    round-to-nearest the format spec recommends, (v*255+32767)//65535)."""
    if len(data) < 16 or data[:8] != FARBFELD_MAGIC:
        raise TransformError("not a farbfeld image")
    w, h = struct.unpack(">II", data[8:16])
    if w == 0 or h == 0 or w * h > _MAX_PIXELS:
        raise TransformError("farbfeld: invalid dimensions")
    need = 16 + w * h * 8
    if len(data) < need:
        raise TransformError("farbfeld: truncated pixel data")
    px = np.frombuffer(data, dtype=">u2", count=w * h * 4, offset=16)
    px = px.reshape(h, w, 4).astype(np.uint32)
    return ((px * 255 + 32767) // 65535).astype(np.uint8)


def _rgbe_to_u8(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) u8 RGB via shared-exponent expansion
    (value = c * 2**(e-136), e==0 -> 0) then the image crate's
    float->u8 mapping (clamp to [0,1], scale 255, round)."""
    c = rgbe[..., :3].astype(np.float32)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(
        e == 0, 0.0, np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    ).astype(np.float32)
    f = c * scale[..., None]
    return np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8)


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance HDR/RGBE -> HWC u8 RGB. Supports the standard ``-Y H +X
    W`` orientation, new-style per-component RLE scanlines and old-style
    (flat RGBE with (1,1,1,n) run markers)."""
    if not data.startswith(HDR_MAGICS):
        raise TransformError("not a Radiance HDR image")
    # -- header: lines to the first empty line, then the resolution line
    pos = 0
    fmt_ok = False
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise TransformError("HDR: unterminated header")
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line.strip() == b"FORMAT=32-bit_rle_rgbe"
        if line == b"":
            break
        if pos > 65536:
            raise TransformError("HDR: oversized header")
    if not fmt_ok:
        raise TransformError("HDR: unsupported FORMAT (want 32-bit_rle_rgbe)")
    nl = data.find(b"\n", pos)
    if nl < 0:
        raise TransformError("HDR: missing resolution line")
    parts = data[pos:nl].split()
    pos = nl + 1
    if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
        raise TransformError("HDR: unsupported orientation")
    try:
        h, w = int(parts[1]), int(parts[3])
    except ValueError as e:
        raise TransformError("HDR: bad resolution line") from e
    if w <= 0 or h <= 0 or w * h > _MAX_PIXELS:
        raise TransformError("HDR: invalid dimensions")

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.empty((h, w, 4), np.uint8)
    i = 0
    for row in range(h):
        if i + 4 > len(buf):
            raise TransformError("HDR: truncated scanline")
        if (
            8 <= w <= 0x7FFF
            and buf[i] == 2
            and buf[i + 1] == 2
            and (int(buf[i + 2]) << 8 | int(buf[i + 3])) == w
        ):
            # new-style: 4 components, each RLE'd independently
            i += 4
            for comp in range(4):
                x = 0
                while x < w:
                    if i >= len(buf):
                        raise TransformError("HDR: truncated RLE")
                    count = int(buf[i])
                    i += 1
                    if count > 128:  # run
                        run = count - 128
                        if x + run > w or i >= len(buf):
                            raise TransformError("HDR: RLE overrun")
                        out[row, x:x + run, comp] = buf[i]
                        i += 1
                    else:  # literals
                        if count == 0 or x + count > w or i + count > len(buf):
                            raise TransformError("HDR: RLE overrun")
                        out[row, x:x + count, comp] = buf[i:i + count]
                        i += count
                    x += count if count <= 128 else count - 128
        else:
            # old-style: flat RGBE; (1,1,1,n) repeats the previous pixel
            # n << (8*consecutive_marker) times
            x = 0
            shift = 0
            while x < w:
                if i + 4 > len(buf):
                    raise TransformError("HDR: truncated scanline")
                px = buf[i:i + 4]
                i += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    if x == 0:
                        raise TransformError("HDR: run with no prior pixel")
                    run = int(px[3]) << shift
                    if x + run > w:
                        raise TransformError("HDR: run overrun")
                    out[row, x:x + run] = out[row, x - 1]
                    x += run
                    shift += 8
                    if shift > 24:
                        raise TransformError("HDR: run marker overflow")
                else:
                    out[row, x] = px
                    x += 1
                    shift = 0
    return _rgbe_to_u8(out)
