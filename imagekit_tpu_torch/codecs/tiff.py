"""TIFF decode without Pillow, over the port's native library.

Counterpart of ``imagekit_tpu/codecs/tiff.py``: ``native/tiff_decode.cpp``
(a copy of the reference's) parses the IFD, reassembles strips or tiles,
chunky or planar (none / LZW / deflate / PackBits, horizontal-differencing
predictor) and expands gray, palette and RGB(A) samples of 8 or 16 bits to
8-bit RGB or RGBA. A layout it refuses as unsupported (-3), which the
reference hands to Pillow, goes to the port's own
``native/tiff_ext_decode.cpp``: bilevel (none, PackBits, LZW, deflate and
CCITT modified Huffman, Group 3 and Group 4), 2- and 4-bit gray and
palette, and 8-bit CMYK, whose samples :func:`decode` turns to RGB as
Pillow's ``convert("RGB")`` does (``ops/color.py::cmyk_to_rgb``, on the
device: run on the host from the codec pool's threads at once, its torch
ops took 20x longer). The differences from the reference are those of
:mod:`.misc`, whose binding helpers this uses: a constant pixel ceiling (no
Pillow), and :class:`~imagekit_tpu_torch.errors.NotPortedError` where
neither decoder takes a layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from imagekit_tpu_torch.codecs import misc


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, channels) of the decoded image."""
    w, h, ch, stem = misc.header(data, "tiff", "TIFF", "TIFF", "tiffx")
    return w, h, 3 if stem == "tiffx" else ch


def decode_stored(data: bytes) -> Tuple[np.ndarray, bool]:
    """The host half of :func:`decode`: HWC u8 RGB(A), or a CMYK TIFF's
    four samples as stored (then True)."""
    out, stem = misc.decode(data, "tiff", "TIFF", corrupt="TIFF", ext="tiffx")
    return out, stem == "tiffx" and out.shape[2] == 4


def decode(data: bytes, device=None) -> np.ndarray:
    """TIFF -> HWC u8 (RGB, or RGBA for ExtraSamples alpha); a CMYK TIFF's
    colour step runs on ``device`` (the card unless the caller names
    another)."""
    out, cmyk = decode_stored(data)
    return cmyk_to_rgb(out, device=device) if cmyk else out


def cmyk_to_rgb(cmyk: np.ndarray, device=None) -> np.ndarray:
    """(H, W, 4) CMYK as a TIFF stores it -> (H, W, 3) RGB, Pillow's
    ``cmyk2rgb``: the JPEG colour step (``ops/color.py::cmyk_to_rgb``) on
    the planes inverted, as an Adobe JPEG stores them, on ``device``."""
    import torch

    from imagekit_tpu_torch.device import resolve_device
    from imagekit_tpu_torch.ops import color

    planes = torch.from_numpy(cmyk).to(resolve_device(device or "cuda"))
    return color.cmyk_to_rgb(*(255 - planes).unbind(-1)).cpu().numpy()
