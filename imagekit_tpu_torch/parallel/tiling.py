"""Resampling of images beyond the bucket ladder.

Counterpart of the one-device branch of
``imagekit_tpu/parallel/tiling.py::resize_oversized`` (:37-42): the image
is resampled at its exact shape by :func:`~imagekit_tpu_torch.ops.resize.
resize_batch`, whose stacks beyond the ladder are
:func:`~imagekit_tpu_torch.ops.weights.exact_stacks` and whose device
resample is one K2 launch (in column strips where a row is too wide for a
tile of whole rows). The reference's mesh branch, which shards the height
over several devices, has no counterpart: the port drives one card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imagekit_tpu_torch.ops.resize import resize_batch


def resize_oversized(img: np.ndarray, out_h: int, out_w: int,
                     filter_name: str = "lanczos3",
                     device: Optional[torch.device] = None) -> np.ndarray:
    """HWC (or HW) u8 -> (out_h, out_w, C) u8 (C = 1 for HW), on ``device``,
    the card unless the caller names another."""
    if img.ndim == 2:
        img = img[:, :, None]
    return resize_batch(img[None], out_h, out_w, filter_name,
                        device=device)[0]
