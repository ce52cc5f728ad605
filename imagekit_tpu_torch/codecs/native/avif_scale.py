"""ctypes binding of ``avif_scale.cpp``: an AVIF item's decoded planes
rescaled to the size its ``ispe`` says, as libavif 1.3.0's
``avifImageScaleWithLimit`` rescales them for Pillow (libyuv's
``ScalePlane`` / ``ScalePlane_12`` with ``kFilterBox``).

:func:`check` holds libavif's refusals of the size (:class:`Refused`,
which the caller reports as the item's decode failing);
:func:`scale_plane` scales one plane at its own depth (uint8 for 8 bits,
uint16 for 10 and 12) and can write only a top-left crop of the result.
``threads`` (0: one a core) changes the time, never the samples.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from . import loader

#: libavif's AVIF_DEFAULT_IMAGE_SIZE_LIMIT and dimension limit
SIZE_LIMIT = 16384 * 16384
DIMENSION_LIMIT = 32768
#: avifImageScaleWithLimit's guard of libyuv's 32-bit arithmetic
SOURCE_LIMIT = 16384

_lock = threading.Lock()
_state: dict = {"lib": None}


class Refused(Exception):
    """A size avifImageScaleWithLimit refuses."""


def load(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """The native library with this file's entry bound (``lib``: another
    build of the same source, for the sanitizer tests)."""
    with _lock:
        if lib is None and _state["lib"] is not None:
            return _state["lib"]
        target = lib if lib is not None else loader.load()
        target.ik_avif_scale_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        target.ik_avif_scale_plane.restype = ctypes.c_int
        if lib is None:
            _state["lib"] = target
        return target


def check(src: Tuple[int, int], dst: Tuple[int, int]) -> None:
    """avifImageScaleWithLimit's refusals of scaling a ``src`` (width,
    height) picture to ``dst``, at Pillow's limits (libavif's defaults):
    a target side of 0, a target beyond the size or dimension limit, a
    source side past 16384."""
    (sw, sh), (dw, dh) = src, dst
    if (sw, sh) == (dw, dh):
        return
    if dw == 0 or dh == 0:
        raise Refused(f"invalid dst dimensions [{dw}x{dh}]")
    if dw > SIZE_LIMIT // dh or dw > DIMENSION_LIMIT or dh > DIMENSION_LIMIT:
        raise Refused(f"dst dimensions that are too large [{dw}x{dh}]")
    if sw > SOURCE_LIMIT or sh > SOURCE_LIMIT:
        raise Refused(f"invalid scale for libyuv [{sw}x{sh}]")


def scale_plane(plane: np.ndarray, width: int, height: int,
                crop: Optional[Tuple[int, int]] = None, threads: int = 0,
                lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """``plane`` (uint8, or uint16 of 10 or 12 bits) scaled to ``width`` x
    ``height`` as libyuv scales it; ``crop`` (w, h): only that top-left
    part of the result, which is all that is computed and allocated."""
    src = np.ascontiguousarray(plane)
    if src.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"planes of uint8 or uint16, not {src.dtype}")
    cw, ch = crop if crop is not None else (width, height)
    out = np.empty((ch, cw), src.dtype)
    sh, sw = src.shape
    rc = (lib or load()).ik_avif_scale_plane(
        src.ctypes.data, sw, sw, sh, out.ctypes.data, cw, width, height,
        cw, ch, src.itemsize, threads)
    if rc != 0:
        raise ValueError(f"a {sw}x{sh} plane does not scale to {width}x"
                         f"{height} (crop {cw}x{ch})")
    return out
