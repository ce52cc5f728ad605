"""WebP (VP8, VP8L) encode and decode glue of the port.

A copy of ``imagekit_tpu/codecs/vp8.py``. Encode: the device heads make
studio-range YUV 4:2:0 planes (a single image's come from
:func:`encode_rgb`, by the host colour conversion unless the caller
prefers the device's), and the host C++ encoder
(``native/vp8_encode.cpp``: intra prediction, 4x4 fDCT/WHT, quantisation,
boolean arithmetic coding, RIFF container) turns them into a WebP file.
Quality maps to the quantiser as libwebp's does (sns_strength=0).
:func:`dimensions` is the header-only size parse.

Decode: :func:`decode_yuv420` (lossy WebP -> studio-range planes for the
YUV-source heads, ``native/vp8_decode.cpp``), :func:`decode_lossless`
(``native/vp8l_decode.cpp``) and :func:`decode_rgb` (every still WebP ->
pixels; extended containers and first frames of animations included), all
byte-equal to the reference's. What differs: the chroma upsample weights
come from the port's ``ops/weights.py``, and the decompression-bomb
ceiling is the constant of ``codecs/png.py``, so neither jax nor Pillow is
imported.

Set ``IMAGEKIT_NO_NATIVE_WEBP=1`` to make :func:`available` and
:func:`decode_available` say False.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from imagekit_tpu_torch.errors import TransformError

_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    from imagekit_tpu_torch.codecs.native import loader

    lib = loader.load()
    if not _configured:
        lib.ik_vp8_encode.restype = ctypes.c_int64
        lib.ik_vp8_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        _configured = True
    return lib


def available() -> bool:
    if os.environ.get("IMAGEKIT_NO_NATIVE_WEBP"):
        return False
    try:
        _lib()
        return True
    except Exception:
        return False


def encode_yuv420(
    y: np.ndarray, u: np.ndarray, v: np.ndarray, quality: int
) -> bytes:
    """Encode studio-range YUV 4:2:0 planes to a complete WebP file."""
    lib = _lib()
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    h, w = y.shape
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape:
        raise TransformError("chroma planes must be 4:2:0 geometry")
    cap = w * h * 2 + 65536
    out = np.empty(cap, np.uint8)
    n = lib.ik_vp8_encode(
        y.ctypes.data,
        u.ctypes.data,
        v.ctypes.data,
        w,
        h,
        y.strides[0],
        u.strides[0],
        int(min(max(quality, 1), 100)),
        out.ctypes.data,
        cap,
    )
    if n < 0:
        raise TransformError(f"VP8 encode failed ({n})")
    return out[:n].tobytes()


def encode_rgb(img: np.ndarray, quality: int, *, prefer_device: bool = False,
               device=None) -> bytes:
    """RGB (or RGBA: alpha is dropped) -> WebP via the native VP8 encoder.

    Colour conversion runs on the host by default, as the reference's does
    (a single image's conversion is a few numpy passes, and the batched
    heads produce YUV planes directly); ``prefer_device`` takes
    :func:`imagekit_tpu_torch.ops.color.rgb_to_yuv420` on ``device`` (the
    card unless named) instead."""
    from imagekit_tpu_torch.ops import color

    if prefer_device:
        y, u, v = color.rgb_to_yuv420(img, device=device)
    else:
        y, u, v = color.rgb_to_yuv420_host(img)
    return encode_yuv420(y, u, v, quality)


def dimensions(data: bytes):
    """Header-only WebP dimension parse (no entropy work): returns (w, h)
    or None when the container is exotic/truncated. Lets the fetch layer
    validate dimensions without a full decode, so /img requests keep the
    bytes and the engine decodes ONCE on the native YUV path (the same
    pattern as the JPEG header parse). Shares the RIFF walk with the
    decoder (one truncation/padding policy for both)."""
    chunks = _webp_chunks(data)
    if not chunks:
        return None
    for tag, body in chunks:
        if tag == b"VP8X":
            if len(body) < 10:
                return None
            w = int.from_bytes(body[4:7], "little") + 1
            h = int.from_bytes(body[7:10], "little") + 1
            return w, h
        if tag == b"VP8 ":
            if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
                return None
            w = int.from_bytes(body[6:8], "little") & 0x3FFF
            h = int.from_bytes(body[8:10], "little") & 0x3FFF
            return w, h
        if tag == b"VP8L":
            if len(body) < 5 or body[0] != 0x2F:
                return None
            bits = int.from_bytes(body[1:5], "little")
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    return None


# ---------------------------------------------------------------------------
# Decode: lossy (vp8_decode.cpp) and lossless (vp8l_decode.cpp) WebP
# sources -> pixels for the batched device resize. VP8X (alpha/animation)
# containers return None from decode_yuv420 and go through decode_rgb. Both
# decoders are validated BIT-EXACT against libwebp's decoder by the
# reference's tests, and the port's copies against the reference's.
# ---------------------------------------------------------------------------


class _IkVp8Info(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32)]


class _IkVp8lInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("has_alpha", ctypes.c_int32),
    ]


_dec_configured = False


def _dec_lib() -> ctypes.CDLL:
    global _dec_configured
    from imagekit_tpu_torch.codecs.native import loader

    lib = loader.load()
    if not _dec_configured:
        lib.ik_vp8l_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(_IkVp8lInfo),
        ]
        lib.ik_vp8l_parse.restype = ctypes.c_int
        lib.ik_vp8l_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.ik_vp8l_decode.restype = ctypes.c_int
        lib.ik_webp_decode_alph.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.ik_webp_decode_alph.restype = ctypes.c_int
        lib.ik_webp_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(_IkVp8Info),
        ]
        lib.ik_webp_parse.restype = ctypes.c_int
        lib.ik_webp_decode_yuv.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.ik_webp_decode_yuv.restype = ctypes.c_int
        _dec_configured = True
    return lib


def decode_available() -> bool:
    if os.environ.get("IMAGEKIT_NO_NATIVE_WEBP"):
        return False
    try:
        _dec_lib()
        return True
    except Exception:
        return False


def decode_yuv420(data: bytes):
    """Decode a lossy WebP to cropped studio-range (Y, U, V) planes.
    Returns None for a container that is not plain lossy (VP8L/VP8X),
    which :func:`decode_rgb` takes."""
    lib = _dec_lib()
    info = _IkVp8Info()
    rc = lib.ik_webp_parse(data, len(data), ctypes.byref(info))
    if rc == -3:  # unsupported container/features
        return None
    if rc != 0:
        raise ValueError(f"corrupt WebP ({rc})")
    w, h = info.width, info.height
    _check_pixel_count(w, h)
    W, H = (w + 15) // 16 * 16, (h + 15) // 16 * 16
    y = np.zeros((H, W), np.uint8)
    u = np.zeros((H // 2, W // 2), np.uint8)
    v = np.zeros_like(u)
    rc = lib.ik_webp_decode_yuv(
        data, len(data),
        y.ctypes.data_as(ctypes.c_void_p), W,
        u.ctypes.data_as(ctypes.c_void_p),
        v.ctypes.data_as(ctypes.c_void_p), W // 2,
    )
    if rc == -3:
        return None
    if rc != 0:
        raise ValueError(f"corrupt WebP ({rc})")
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return y[:h, :w], u[:ch, :cw], v[:ch, :cw]


def decode_lossless(data: bytes) -> Optional[np.ndarray]:
    """Lossless WebP (VP8L chunk) -> HWC u8 RGB/RGBA, bit-exact vs libwebp
    (vp8l_decode.cpp). Returns None for non-VP8L containers (lossy VP8 or
    extended VP8X, which the callers route elsewhere)."""
    if len(data) < 16 or data[12:16] != b"VP8L":
        return None  # lossy/extended container: not ours
    lib = _dec_lib()
    info = _IkVp8lInfo()
    rc = lib.ik_vp8l_parse(data, len(data), ctypes.byref(info))
    if rc == -3 or rc == -2:  # VP8X or unsupported version bits
        return None
    if rc != 0:
        raise ValueError(f"corrupt WebP ({rc})")
    w, h = info.width, info.height
    _check_pixel_count(w, h)
    out = np.empty((h, w, 4), np.uint8)
    rc = lib.ik_vp8l_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes
    )
    if rc == -3:
        return None
    if rc != 0:
        raise ValueError(f"corrupt WebP ({rc})")
    return out if info.has_alpha else np.ascontiguousarray(out[:, :, :3])


def _riff(tag: bytes, body: bytes) -> bytes:
    """Wrap one chunk back into a minimal standalone WebP container."""
    chunk = tag + len(body).to_bytes(4, "little") + body
    if len(body) & 1:
        chunk += b"\x00"
    return b"RIFF" + (4 + len(chunk)).to_bytes(4, "little") + b"WEBP" + chunk


def _decode_alpha_plane(alph: bytes, w: int, h: int) -> np.ndarray:
    lib = _dec_lib()
    out = np.empty((h, w), np.uint8)
    rc = lib.ik_webp_decode_alph(
        alph, len(alph), w, h, out.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise ValueError(f"corrupt WebP alpha ({rc})")
    return out


def _decode_vp8x(data: bytes) -> Optional[np.ndarray]:
    """Extended (VP8X) images: VP8L sub-image, or lossy VP8 with an
    optional ALPH alpha plane. Animations decode frame 0 natively when it
    covers the whole canvas (the common case — matching the reference's
    first-frame transform semantics); otherwise None (not decodable
    here)."""
    chunks = _webp_chunks(data)
    if chunks is None:
        raise ValueError("corrupt WebP (bad RIFF)")
    tags = {t for t, _ in chunks}
    if b"ANIM" in tags or b"ANMF" in tags:
        return _decode_first_frame(chunks)
    bodies = {t: b for t, b in chunks}
    if b"VP8L" in bodies:
        # alpha (if any) is inside the lossless stream itself
        return decode_lossless(_riff(b"VP8L", bodies[b"VP8L"]))
    if b"VP8 " not in bodies:
        return None  # nothing we can decode natively
    rgb = decode_rgb(_riff(b"VP8 ", bodies[b"VP8 "]))
    if rgb is None or b"ALPH" not in bodies:
        return rgb
    h, w = rgb.shape[:2]
    alpha = _decode_alpha_plane(bodies[b"ALPH"], w, h)
    return np.dstack([rgb, alpha])


def _decode_first_frame(chunks) -> Optional[np.ndarray]:
    """Animated WebP: decode frame 0. Full-canvas frames return directly;
    partial frames composite onto a transparent-black canvas (the host
    library's frame-0 semantics — the ANIM background colour is a player
    hint, not part of decoded frame 0). ANMF payload (container spec):
    3B x/2, 3B y/2, 3B w-1, 3B h-1, 3B duration, 1B flags, then the
    frame's ALPH?/VP8|VP8L sub-chunks. A frame with neither sub-chunk is
    no frame to libwebp's demuxer, which drops it: frame 0 is the first
    that has one."""
    canvas_w = canvas_h = None
    vp8x_alpha = False
    for tag, body in chunks:
        if tag == b"VP8X" and len(body) >= 10:
            vp8x_alpha = bool(body[0] & 0x10)
            canvas_w = int.from_bytes(body[4:7], "little") + 1
            canvas_h = int.from_bytes(body[7:10], "little") + 1
        if tag != b"ANMF" or len(body) < 16:
            continue
        if canvas_w is None:
            return None
        fx = int.from_bytes(body[0:3], "little") * 2
        fy = int.from_bytes(body[3:6], "little") * 2
        fw = int.from_bytes(body[6:9], "little") + 1
        fh = int.from_bytes(body[9:12], "little") + 1
        if fx + fw > canvas_w or fy + fh > canvas_h:
            raise ValueError("corrupt WebP (frame exceeds canvas)")
        sub = _webp_chunks(
            b"RIFF" + (4 + len(body) - 16).to_bytes(4, "little")
            + b"WEBP" + body[16:]
        )
        if sub is None:
            raise ValueError("corrupt WebP (bad ANMF)")
        frame = {t: b for t, b in sub}
        if b"VP8L" in frame:
            px = decode_lossless(_riff(b"VP8L", frame[b"VP8L"]))
        elif b"VP8 " in frame:
            px = decode_rgb(_riff(b"VP8 ", frame[b"VP8 "]))
            if px is not None and b"ALPH" in frame:
                h, w = px.shape[:2]
                px = np.dstack(
                    [px, _decode_alpha_plane(frame[b"ALPH"], w, h)]
                )
        else:
            continue
        if px is None:
            return None
        if px.shape[0] != fh or px.shape[1] != fw:
            raise ValueError("corrupt WebP (frame geometry mismatch)")
        if (fx, fy) == (0, 0) and (fw, fh) == (canvas_w, canvas_h):
            return px
        # partial frame 0: composite on a transparent-black canvas
        canvas = np.zeros((canvas_h, canvas_w, 4), np.uint8)
        if px.shape[2] == 3:
            canvas[fy:fy + fh, fx:fx + fw, :3] = px
            canvas[fy:fy + fh, fx:fx + fw, 3] = 255
        else:
            canvas[fy:fy + fh, fx:fx + fw] = px
        return canvas if vp8x_alpha else np.ascontiguousarray(
            canvas[:, :, :3]
        )
    return None


def decode_rgb(data: bytes) -> Optional[np.ndarray]:
    """WebP -> HWC u8 pixels. Lossless (VP8L) decodes bit-exactly; lossy
    (VP8) decodes natively + the 'fancy' separable triangle chroma upsample
    (libwebp's default kernel) + studio-range BT.601 inverse; extended
    (VP8X) still images route through both (+ native ALPH alpha decode).
    None where libwebp's demuxer takes no frame (an extended file with no
    image, an animation whose frames have none, a frame that is not a key
    frame), which :func:`undecodable` names as Pillow does."""
    if len(data) >= 16 and data[12:16] == b"VP8L":
        return decode_lossless(data)
    if len(data) >= 16 and data[12:16] == b"VP8X":
        return _decode_vp8x(data)
    planes = decode_yuv420(data)
    if planes is None:
        return None
    y, u, v = planes
    from imagekit_tpu_torch.ops.weights import upsample_weights

    h, w = y.shape
    Uv = upsample_weights(u.shape[0], h)
    Uh = upsample_weights(u.shape[1], w)
    uu = Uv @ u.astype(np.float32) @ Uh.T
    vv = Uv @ v.astype(np.float32) @ Uh.T
    yf = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    cb = (uu - 128.0) * (255.0 / 224.0)
    cr = (vv - 128.0) * (255.0 / 224.0)
    r = yf + 1.402 * cr
    g = yf - 0.344136286 * cb - 0.714136286 * cr
    b = yf + 1.772 * cb
    rgb = np.stack([r, g, b], -1)
    return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)


def _check_pixel_count(w: int, h: int) -> None:
    """Decompression-bomb guard: a tiny compressed file must not allocate
    gigabytes of pixels. The ceiling is the PNG decoder's constant (the
    reference reads Pillow's default, the same number)."""
    from imagekit_tpu_torch.codecs.png import MAX_PIXELS

    if w * h > MAX_PIXELS:
        raise ValueError(f"image is too large ({w}x{h} pixels)")


def _webp_chunks(data: bytes):
    """RIFF chunk walk -> list of (tag, payload). None if not a WebP RIFF
    or a chunk is truncated."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return None
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag = data[pos : pos + 4]
        sz = int.from_bytes(data[pos + 4 : pos + 8], "little")
        body = data[pos + 8 : pos + 8 + sz]
        if len(body) < sz:
            return None  # truncated chunk
        out.append((tag, body))
        pos += 8 + sz + (sz & 1)
    return out


#: the chunks Pillow's WebP reader takes as a file's first
_FIRST_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")


def undecodable(data: bytes) -> str:
    """Pillow's message for a WebP that :func:`decode_rgb` returns None
    for: its reader refuses a file whose first chunk is not an image or an
    extended header, and libwebp's demuxer one that holds no frame."""
    if data[12:16] not in _FIRST_CHUNKS:
        return "cannot identify image file"
    return "could not create decoder object"
