"""AVIF encode of the port: the first-party AV1 intra encoder.

The port's copy of the first-party arm of ``imagekit_tpu/codecs/
avif_encode.py``. The fused device heads (``rgbyuv`` for RGB sources, the
JPEG and WebP YUV heads) produce studio-range BT.601 4:2:0 planes, and the
in-process encoder (:func:`.av1_image.encode_avif`: host numpy and the C++
of ``native/av1_enc.cpp``) turns them into an AVIF file, so AVIF output
takes the same no-RGB-round-trip path as WebP output. It needs no system
AV1 library: it is the arm the reference takes when ``libavif.so.15`` does
not load, or when ``IMAGEKIT_AVIF_FIRSTPARTY`` is set.

Alpha: a fully opaque alpha plane is dropped; a real one rides as an
auxiliary AV1 item, near-lossless (``av1_image.encode_avif``).

Threads: the encoder's Python loop makes many short ctypes calls, each of
which gives up the interpreter lock, so encodes running in several threads
wait on each other and take together several times their serial sum
(``python -m imagekit_tpu_torch.tools.avif_probe``). The engine runs them
one at a time, on a thread of their own.

Monochrome: :func:`encode_y400_studio` writes a true YUV400 AVIF
(mono_chrome = 1) with the same encoder's luma-only mode, where the
reference calls libavif.

Left out, and kept so: the reference's libavif ABI arm (``_load``,
``_bind``, ``_selftest``, ``_encode_planes``), whose self-check decodes
through libdav1d. Where libavif loads, the reference's AVIF bodies are
libaom's; the port's are always the first-party encoder's, as the
reference's are where libavif is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def available() -> bool:
    """The encoder is in-process: AVIF output is always available."""
    return True


def quality_to_quantizer(quality: int) -> int:
    """Reference-shaped quality (1-100) -> AV1 quantizer (0-63), the
    linear map modern libavif uses for its quality knob; q=100 hits
    quantizer 0 (aom lossless)."""
    q = min(max(int(quality), 1), 100)
    return ((100 - q) * 63 + 50) // 100


def quantizer_to_qindex(quantizer: int) -> int:
    """AV1 quantizer (0-63) -> base_q_idx (0-255), aom's
    av1_quantizer_to_qindex linear map (qindex = quantizer * 4), floored
    at 1 because the first-party encoder has no lossless mode."""
    return min(max(int(quantizer) * 4, 1), 255)


def encode_firstparty(
    y: np.ndarray,
    cb: np.ndarray,
    cr: np.ndarray,
    quality: int,
    alpha: Optional[np.ndarray] = None,
) -> bytes:
    """First-party AVIF from studio-range BT.601 4:2:0 planes — the
    in-process encoder behind the same plane contract as
    encode_yuv420_studio (arbitrary dims via pad + CleanAperture)."""
    from .av1_image import encode_avif

    return encode_avif(
        y, cb, cr,
        qindex=quantizer_to_qindex(quality_to_quantizer(quality)),
        alpha=alpha)


def encode_yuv420_studio(
    y: np.ndarray,
    cb: np.ndarray,
    cr: np.ndarray,
    quality: int,
    alpha: Optional[np.ndarray] = None,
) -> bytes:
    """Studio-range BT.601 4:2:0 planes (the fused device heads' output
    layout: y (H,W) u8, cb/cr ((H+1)//2,(W+1)//2) u8) -> AVIF bytes
    through the first-party encoder. Raises ValueError on planes outside
    that contract."""
    if y.dtype != np.uint8 or cb.dtype != np.uint8 or cr.dtype != np.uint8:
        raise ValueError("planes must be uint8")
    h, w = y.shape
    if cb.shape != ((h + 1) // 2, (w + 1) // 2) or cr.shape != cb.shape:
        raise ValueError("chroma geometry must be 4:2:0 of the luma plane")
    if alpha is not None and alpha.shape != (h, w):
        raise ValueError("alpha plane must match luma geometry")
    return encode_firstparty(y, cb, cr, quality, alpha=alpha)


def encode_y400_studio(
    y: np.ndarray,
    quality: int,
    speed: Optional[int] = None,
    full_range: bool = False,
) -> bytes:
    """Single Y plane -> true monochrome (YUV400, mono_chrome=1) AVIF
    through the first-party encoder's luma-only mode: the mono source
    class that ``avif_native.decode_yuv_studio`` serves with neutral
    chroma (Pillow writes mode-L images as colour). CICP (1, 13, 6),
    limited range unless ``full_range``. ``speed`` is the reference's
    libavif knob; the first-party encoder has no speed setting, so it is
    accepted and unused. Raises ValueError for a plane that is not a
    2-D uint8 array."""
    del speed
    if y.dtype != np.uint8 or y.ndim != 2:
        raise ValueError("y must be a 2-D uint8 plane")
    from .av1_image import encode_avif_y400

    return encode_avif_y400(
        y, qindex=quantizer_to_qindex(quality_to_quantizer(quality)),
        full_range=full_range)


def _split_rgba(img: np.ndarray):
    """RGB(A) -> (BT.601 studio 4:2:0 planes, real-alpha-or-None): the
    same conversion the device heads apply (ops/color.py); fully-opaque
    alpha planes are dropped."""
    from imagekit_tpu_torch.ops.color import rgb_to_yuv420_host

    alpha = None
    if img.ndim == 3 and img.shape[2] == 4:
        a = img[:, :, 3]
        if not (a == 255).all():
            alpha = np.ascontiguousarray(a)
        img = img[:, :, :3]
    y, cb, cr = rgb_to_yuv420_host(img)
    return y, cb, cr, alpha


def encode_rgb(img: np.ndarray, quality: int) -> bytes:
    """Host-side RGB(A) -> AVIF for the single-image paths: BT.601
    studio conversion, then the direct bitstream encode. Alpha, when
    present and not fully opaque, rides as a near-lossless alpha
    plane."""
    y, cb, cr, alpha = _split_rgba(img)
    return encode_yuv420_studio(y, cb, cr, quality, alpha=alpha)
