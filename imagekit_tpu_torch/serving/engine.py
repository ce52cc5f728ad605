"""Transform execution engines (counterpart of
``imagekit_tpu/serving/engine.py:28-106``).

Two implementations share one interface:

- :class:`ThreadedEngine`: per-request execution of the single-image
  pipeline (:mod:`imagekit_tpu_torch.transform`: decode, resize at batch 1,
  encode) on a thread pool, with an explicit device for its device steps;
  no batching.
- :class:`~imagekit_tpu_torch.serving.batcher.BatchedEngine`: queues
  requests by bucket and runs each queue's device work as one batch; the
  port's serving path, which also serves single images (requests with no
  resize, and images beyond the bucket ladder) through the same functions.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.device import resolve_device
from imagekit_tpu_torch.serving.metrics import METRICS, Metrics
from imagekit_tpu_torch.transform import decode_image, encode_image, resize_image


class TransformEngine:
    """Interface: async decode / resize+encode on pre-decoded pixels."""

    async def transform(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        img = await self.decode(data)
        return await self.resize_encode(img, w, h, fmt, quality)

    async def decode(self, data: bytes) -> np.ndarray:
        raise NotImplementedError

    async def resize_encode(
        self,
        img: np.ndarray,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class ThreadedEngine(TransformEngine):
    """Thread-pool execution of the single-image pipeline. The resize (one
    K2 launch on CUDA; at the image's exact shape beyond the bucket ladder)
    and a JPEG's pixel decode and fDCT run on ``device``, the card unless
    the caller names another; the codecs' host halves on the pool's
    threads."""

    def __init__(
        self,
        config: Optional[ImageKitConfig] = None,
        metrics: Metrics = METRICS,
        max_workers: Optional[int] = None,
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.metrics = metrics
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="ik-transform"
        )

    async def decode(self, data: bytes) -> np.ndarray:
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        img, _ = await loop.run_in_executor(
            self._pool, lambda: decode_image(data, device=self.device))
        self.metrics.add_stage_time("decode", time.perf_counter() - t0)
        return img

    async def resize_encode(
        self,
        img: np.ndarray,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        loop = asyncio.get_running_loop()

        def work() -> bytes:
            t0 = time.perf_counter()
            resized = resize_image(img, w, h, device=self.device)
            t1 = time.perf_counter()
            out = encode_image(resized, fmt, quality, device=self.device)
            t2 = time.perf_counter()
            self.metrics.add_stage_time("resize", t1 - t0)
            self.metrics.add_stage_time("encode", t2 - t1)
            return out

        return await loop.run_in_executor(self._pool, work)

    async def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
