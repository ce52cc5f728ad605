"""ctypes binding of ``avif_yuv_rgb.cpp``: an AVIF's decoded planes to the
8-bit RGB(A) that libavif 1.3.0 gives Pillow (its libyuv path where
libyuv covers the matrix, its own float path elsewhere).

:func:`convert` takes the planes at their own depth (uint8 for 8 bits,
uint16 for 10 and 12), the colour description libavif settles on (the
nclx box's, else the sequence header's) and an alpha plane that is full
range already (:func:`limited_to_full` for a stream that says limited, as
libavif's decoder converts it). It raises :class:`Refused` for a matrix
libavif's ``avifPrepareReformatState`` refuses. ``threads`` of
:func:`convert` (0: one a core) changes the time, never the pixels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import loader

OK, REFUSED, BAD = 0, -1, -2
#: the layouts (``av1_dec_abi.I400`` ..)
I400, I420, I422, I444 = 0, 1, 2, 3

_lock = threading.Lock()
_state: dict = {"lib": None}


class Refused(Exception):
    """A colour description libavif does not convert."""


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in (
        "width", "height", "depth", "layout", "full_range", "matrix",
        "primaries", "premultiplied", "threads")] + [
            (name, ctypes.c_void_p) for name in ("y", "u", "v", "a")] + [
            (name, ctypes.c_int64) for name in (
                "y_stride", "uv_stride", "a_stride")]


def load(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """The native library with this file's entries bound (``lib``: another
    build of the same source, for the sanitizer tests)."""
    with _lock:
        if lib is None and _state["lib"] is not None:
            return _state["lib"]
        target = lib if lib is not None else loader.load()
        target.ik_yuvrgb_args_size.restype = ctypes.c_int
        target.ik_yuvrgb_convert.argtypes = [ctypes.POINTER(_Args),
                                             ctypes.c_void_p]
        target.ik_yuvrgb_convert.restype = ctypes.c_int
        if target.ik_yuvrgb_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError(
                f"IkYuvRgb is {target.ik_yuvrgb_args_size()} bytes in the "
                f"library, {ctypes.sizeof(_Args)} in the binding")
        if lib is None:
            _state["lib"] = target
        return target


def limited_to_full(plane: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY, the step its decoder takes for an
    alpha stream whose sequence header says limited range: (v - lo) *
    full + (hi - lo) / 2, divided by hi - lo with C's truncation, clamped
    (lo, hi = 16, 235 at 8 bits, 64, 940 at 10, 256, 3760 at 12)."""
    lo, hi = 16 << (depth - 8), 235 << (depth - 8)
    full = (1 << depth) - 1
    num = (plane.astype(np.int64) - lo) * full + (hi - lo) // 2
    q = np.abs(num) // (hi - lo) * np.sign(num)
    return np.clip(q, 0, full).astype(plane.dtype)


def convert(y: np.ndarray, u: Optional[np.ndarray], v: Optional[np.ndarray],
            alpha: Optional[np.ndarray], depth: int, layout: int,
            full_range: bool, matrix: int, primaries: int,
            premultiplied: bool = False, threads: int = 0,
            lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """Planes (luma h x w, chroma of the layout, alpha h x w or None) ->
    HWC uint8, RGB, or RGBA with an alpha plane. ``premultiplied``: the
    colour is premultiplied by the alpha ('prem'). Raises Refused."""
    lib = lib or load()
    dt = np.uint8 if depth == 8 else np.uint16
    h, w = y.shape
    planes = [np.ascontiguousarray(p, dt) if p is not None else None
              for p in (y, u, v, alpha)]
    for p in planes[1:3]:
        if layout != I400 and (p is None or p.ndim != 2):
            raise ValueError("chroma planes missing")
    if planes[3] is not None and planes[3].shape != (h, w):
        raise ValueError("alpha plane of another size")
    if layout != I400:
        cw = w if layout == I444 else (w + 1) // 2
        ch = (h + 1) // 2 if layout == I420 else h
        if planes[1].shape != (ch, cw) or planes[2].shape != (ch, cw):
            raise ValueError("chroma planes of another size")
    args = _Args(w, h, depth, layout, int(full_range), matrix, primaries,
                 int(premultiplied), threads)
    for name, p in zip("yuva", planes):
        setattr(args, name, p.ctypes.data if p is not None else None)
    args.y_stride = w
    args.uv_stride = planes[1].shape[1] if layout != I400 else 0
    args.a_stride = w
    out = np.empty((h, w, 4 if alpha is not None else 3), np.uint8)
    rc = lib.ik_yuvrgb_convert(ctypes.byref(args), out.ctypes.data)
    if rc == REFUSED:
        raise Refused(f"matrix_coefficients {matrix} at "
                      f"{'full' if full_range else 'limited'} range")
    if rc != OK:
        raise ValueError(f"YUV -> RGB refused its arguments ({rc})")
    return out
