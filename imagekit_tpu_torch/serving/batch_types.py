"""Batch item types shared by the engine's head modules
(counterpart of ``imagekit_tpu/serving/batch_types.py``)."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops.weights import padded_weights
from imagekit_tpu_torch.utils.sized_cache import SizedArrayCache


@dataclass
class _Item:
    img: np.ndarray
    out_h: int
    out_w: int
    fmt: ImageFormat
    quality: int
    future: asyncio.Future
    enqueued: float = field(default_factory=time.perf_counter)


@dataclass
class _YuvItem:
    """A decoded studio-range YUV source (the native WebP decode, or an
    AVIF's in any chroma factors) bound for a WebP, AVIF or JPEG output:
    resized entirely in YUV space, no RGB anywhere (JPEG outputs ride the
    resize + remap + fDCT head)."""

    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    out_h: int
    out_w: int
    quality: int
    future: asyncio.Future
    fmt: ImageFormat = ImageFormat.webp
    alpha: Optional[np.ndarray] = None  # full-range u8, luma geometry
    mix: bool = False  # BT.709 source: the head applies the 709->601 mix
    enqueued: float = field(default_factory=time.perf_counter)


#: queue key of the RGB-source heads: (bh, bw, obh, obw, channels, okind),
#: okind "yuv" (WebP output) or "jpg" (JPEG output) for 3 channels, "" (the
#: plain head, any output) for 4
_BucketKey = Tuple[int, int, int, int, int, str]


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


async def _settle(it, encode) -> None:
    """Await an item's encode and hand its waiter the result or the
    error."""
    try:
        encoded = await encode
    except Exception as e:  # noqa: BLE001 - the waiter gets every error
        if not it.future.done():
            it.future.set_exception(e)
        return
    if not it.future.done():
        it.future.set_result(encoded)
