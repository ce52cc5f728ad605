"""Transform core: decode -> resize -> encode, one image at a time.

Counterpart of ``imagekit_tpu/transform.py`` (API parity with the upstream
service's ``src/transform.rs``):

- :func:`decode_image`: format detection + decode, returning the pixels
  and the detected format when it is one of the three output formats,
  else None;
- :func:`resize_image`: aspect-preserving fit-within Lanczos3 resize, a
  no-op when both dims are None, at least 1 px (one K2 launch on CUDA);
- :func:`encode_image`: JPEG or WebP at a quality clamped to [1, 100].

The serving layer batches decoded images; these are the same pipeline at
batch size 1, and what a request with no resize runs after its decode.
Each takes ``device``: the card unless the caller names another.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.codecs import decode_bytes, encode_bytes
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import TransformError
from imagekit_tpu_torch.ops.resize import resize_image_array
from imagekit_tpu_torch.ops.weights import target_dimensions

Device = Optional[torch.device]


def decode_image(data: bytes, device: Device = None
                 ) -> Tuple[np.ndarray, Optional[ImageFormat]]:
    """Decode raw bytes; returns (HWC uint8 array, detected output format
    or None). Raises TransformError on undetectable or malformed input."""
    arr, src_fmt = decode_bytes(data, device=device)
    return arr, src_fmt.as_output


def resize_image(img: np.ndarray, w: Optional[int] = None,
                 h: Optional[int] = None, *, filter_name: str = "lanczos3",
                 device: Device = None) -> np.ndarray:
    """Aspect-preserving fit-within resize (Lanczos3 by default)."""
    if img.size == 0:
        raise TransformError("empty image")
    return resize_image_array(img, w, h, filter_name, device=device)


def encode_image(img: np.ndarray, fmt: ImageFormat, quality: int,
                 device: Device = None) -> bytes:
    """Encode to the target format at the given quality (clamped 1-100)."""
    if img.size == 0:
        raise TransformError("empty image")
    return encode_bytes(img, fmt, quality, device=device)


def transform_bytes(data: bytes, w: Optional[int], h: Optional[int],
                    fmt: ImageFormat, quality: int,
                    device: Device = None) -> bytes:
    """Full single-image pipeline: decode -> resize -> encode, the /img
    miss path's transform chain at batch 1."""
    img, _ = decode_image(data, device=device)
    resized = resize_image(img, w, h, device=device)
    return encode_image(resized, fmt, quality, device=device)


def output_dimensions(orig_w: int, orig_h: int, w: Optional[int],
                      h: Optional[int]) -> Tuple[int, int]:
    """The exact output-dimension math."""
    return target_dimensions(orig_w, orig_h, w, h)
