"""Batch item types shared by the engine's head modules
(counterpart of ``imagekit_tpu/serving/batch_types.py``)."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from imagekit_tpu.config import ImageFormat
from imagekit_tpu.utils.sized_cache import SizedArrayCache
from imagekit_tpu_torch.ops.weights import padded_weights


@dataclass
class _Item:
    img: np.ndarray
    out_h: int
    out_w: int
    fmt: ImageFormat
    quality: int
    future: asyncio.Future
    enqueued: float = field(default_factory=time.perf_counter)


class _NativeUnsupported(Exception):
    """The JPEG cannot take the native coefficient path."""


# Byte-budgeted host weight cache: each entry is a 0.5-3 MB matrix keyed by
# true dims, so an entry-capped cache would grow without bound under
# random-dimension traffic.
_HOST_WEIGHTS = SizedArrayCache(128 * 1024 * 1024)


def _cached_weights(
    true_in: int, true_out: int, bucket_in: int, bucket_out: int
) -> np.ndarray:
    key = (true_in, true_out, bucket_in, bucket_out)
    return _HOST_WEIGHTS.get_or_build(
        key, lambda: padded_weights(true_in, true_out, bucket_in, bucket_out)
    )
