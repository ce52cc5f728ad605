"""Baseline-TIFF decode without Pillow, over the port's native library.

Counterpart of ``imagekit_tpu/codecs/tiff.py``: ``native/tiff_decode.cpp``
(a copy of the reference's) parses the IFD, reassembles strips or tiles,
chunky or planar (none / LZW / deflate / PackBits, horizontal-differencing
predictor) and expands gray, palette and RGB(A) samples of 8 or 16 bits to
8-bit RGB or RGBA; other photometrics and compressions it does not take. The
differences from the reference are those of :mod:`.misc`, whose binding
helpers this uses: a constant pixel ceiling (no Pillow), and
:class:`~imagekit_tpu_torch.errors.NotPortedError` where the reference
hands a layout the decoder does not take to Pillow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from imagekit_tpu_torch.codecs import misc


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of the decoded image."""
    return misc.parse(data, "tiff", "TIFF", corrupt="TIFF")


def decode(data: bytes) -> np.ndarray:
    """TIFF -> HWC u8 (RGB, or RGBA for ExtraSamples alpha)."""
    return misc.decode(data, "tiff", "TIFF", corrupt="TIFF")
