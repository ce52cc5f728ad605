"""WebP (VP8) encode glue of the port.

A copy of the encode side of ``imagekit_tpu/codecs/vp8.py``: the device
heads make studio-range YUV 4:2:0 planes, and the host C++ encoder
(``native/vp8_encode.cpp``: intra prediction, 4x4 fDCT/WHT, quantisation,
boolean arithmetic coding, RIFF container) turns them into a WebP file.
Quality maps to the quantiser as libwebp's does (sns_strength=0).
:func:`dimensions` is the header-only size parse. The reference's
``encode_rgb`` (host colour conversion through its jax module) and its
decoders are not ported.

Set ``IMAGEKIT_NO_NATIVE_WEBP=1`` to make :func:`available` say False.
"""

from __future__ import annotations

import ctypes
import os
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
