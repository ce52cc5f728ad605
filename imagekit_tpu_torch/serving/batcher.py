"""Dynamic bucketed batching engine on PyTorch.

Counterpart of the core of ``imagekit_tpu/serving/batcher.py`` (:57-232,
:282-351, :364-500, :699-704): concurrent requests queue by (source bucket,
target bucket, head); a queue flushes when it reaches ``max_batch`` or its
oldest item has waited ``max_delay_ms``, and each flush is ONE device call
while the host codec stages run on a thread pool. Admission control, the
split-by-geometry rule and the depth-aware soft flush are the reference's.

What differs is device placement. The engine holds an explicit
``torch.device``: ``"cuda"`` (the default, which raises without a card) or
``"cpu"`` by name, where the heads run their plain PyTorch versions. Each
of the two dispatch threads owns a CUDA stream; a batch's arrays go through
pinned host memory with a non-blocking copy on that stream, its kernels
launch on it, and the stream is synchronised before the planes are read
back. There is no mesh, no compile set and no cold-shape host fallback:
a hand-written kernel has no per-shape compile.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from imagekit_tpu.codecs import SourceFormat, guess_format
from imagekit_tpu.config import ImageFormat, ImageKitConfig
from imagekit_tpu.errors import EngineOverloaded, TransformError
from imagekit_tpu.serving.metrics import METRICS, Metrics
from imagekit_tpu.utils.sized_cache import SizedArrayCache
from imagekit_tpu_torch.device import resolve_device
from imagekit_tpu_torch.errors import NotPortedError
from imagekit_tpu_torch.serving.engine import TransformEngine
from imagekit_tpu_torch.serving.engine_jpeg import JpegPathMixin


class BatchedEngine(JpegPathMixin, TransformEngine):
    MAX_UNIQUE = 4  # fixed unique-geometry slots per device call

    def __init__(
        self,
        config: Optional[ImageKitConfig] = None,
        metrics: Metrics = METRICS,
        codec_workers: Optional[int] = None,
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or ImageKitConfig()
        self.metrics = metrics
        bc = self.config.batch
        self.max_batch = bc.max_batch
        self.max_delay = bc.max_delay_ms / 1000.0
        self.hard_delay = bc.hard_delay_ms / 1000.0
        # admission control: shed when the estimated queue-drain latency
        # exceeds the budget instead of queueing
        self.admit_budget_s = bc.max_queue_latency_s
        self._insystem = 0  # requests admitted and not yet completed
        self._done_times: "deque[float]" = deque(maxlen=256)
        workers = codec_workers or max(2, (os.cpu_count() or 1) * 2)
        self._codec_pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="ik-codec"
        )
        # Two dispatch threads, one CUDA stream each: batch N+1's
        # host->device copy overlaps batch N's kernels and readback.
        self._device_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="ik-device"
        )
        self._tls = threading.local()
        self._jqueues: Dict[tuple, list] = {}
        # folded weight stacks are identical batch to batch for steady
        # traffic: keep them on the device (byte-budgeted; tensors report
        # .nbytes like arrays)
        self._dweights = SizedArrayCache(
            int(os.environ.get("IMAGEKIT_DEVICE_WEIGHT_CACHE_MB", "64"))
            * 1024 * 1024
        )
        self._inflight = 0  # device calls dispatched but not finished
        self._flusher: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

    # -- device placement --------------------------------------------------

    @contextlib.contextmanager
    def _placement(self):
        """Yield ``put(np_array) -> tensor`` on the engine's device. On
        CUDA the copy goes through pinned memory, non-blocking, on this
        dispatch thread's own stream, which stays current for the kernels
        launched inside the block."""
        if self.device.type != "cuda":
            yield torch.from_numpy
            return
        stream = getattr(self._tls, "stream", None)
        if stream is None:
            stream = self._tls.stream = torch.cuda.Stream(self.device)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).pin_memory().to(
                self.device, non_blocking=True
            )

        with torch.cuda.stream(stream):
            yield put

    # -- decode ------------------------------------------------------------

    async def decode(self, data: bytes) -> np.ndarray:
        """The port decodes no source to pixels yet. A JPEG's header is
        still checked, so that a caller can tell a bad source
        (TransformError) from a path not ported (NotPortedError)."""
        if guess_format(data) == SourceFormat.jpeg:
            from imagekit_tpu.codecs.native import jpeg_abi, loader

            lib = loader.load()
            if lib is not None:
                try:
                    jpeg_abi.parse(lib, data)
                except jpeg_abi.NativeJpegError as e:
                    raise TransformError(f"JPEG decode failed: {e}") from e
            raise NotPortedError("JPEG pixel decode", "queue 1 item 10")
        raise NotPortedError("pixel decode", "queue 1 item 9")

    # -- admission control (engine-level load shedding) --------------------

    def _admission_check(self) -> None:
        """Refuse work the engine cannot serve within its latency budget:
        estimated drain time = in-system requests / recent completion
        rate, measured over the busy span; no recent history admits."""
        budget = self.admit_budget_s
        if budget <= 0:
            return
        now = time.monotonic()
        recent = [t for t in self._done_times if now - t <= 30.0]
        if len(recent) < 8:
            return
        newest = max(recent)
        if now - newest > 5.0:
            return
        span = newest - min(recent)
        if span <= 0:
            return
        rate = (len(recent) - 1) / span
        wait = self._insystem / rate
        if wait > budget:
            self.metrics.inc("shed")
            raise EngineOverloaded(max(1.0, wait - budget))

    @contextlib.contextmanager
    def _admission(self):
        self._admission_check()
        self._insystem += 1
        try:
            yield
            self._done_times.append(time.monotonic())
        finally:
            self._insystem -= 1

    async def _pool_run(self, stage: str, fn, *args):
        """Run ``fn`` on the codec pool; ``stage_seconds`` gets the time
        inside the call, ``stage_wait_seconds`` the pool-queue time."""
        loop = asyncio.get_running_loop()
        t_submit = time.perf_counter()

        def timed():
            t_start = time.perf_counter()
            self.metrics.add_stage_wait(stage, t_start - t_submit)
            try:
                return fn(*args)
            finally:
                self.metrics.add_stage_time(
                    stage, time.perf_counter() - t_start
                )

        return await loop.run_in_executor(self._codec_pool, timed)

    # -- entry points ------------------------------------------------------

    async def resize_encode(
        self,
        img: np.ndarray,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        raise NotPortedError("resizing decoded RGB pixels", "queue 1 item 9")

    async def transform(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        with self._admission():
            return await self._transform_inner(data, w, h, fmt, quality)

    async def _transform_inner(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        src = guess_format(data)  # TransformError on undetectable bytes
        if src == SourceFormat.jpeg:
            if w is None and h is None:
                raise NotPortedError("a request with no resize", "queue 1 item 10")
            return await self._transform_jpeg_native(data, w, h, fmt, quality)
        if src in (SourceFormat.webp, SourceFormat.avif):
            raise NotPortedError(f"{src.value} sources", "queue 1 item 8")
        raise NotPortedError(f"{src.value} sources", "queue 1 item 9")

    # -- batching ----------------------------------------------------------

    def _total_queued(self) -> int:
        return sum(len(q) for q in self._jqueues.values())

    @staticmethod
    def _split_by_geometry(items, key_fn, max_unique):
        """Partition into groups containing at most ``max_unique`` distinct
        geometries, preserving order."""
        groups, current, seen = [], [], set()
        for it in items:
            k = key_fn(it)
            if k not in seen and len(seen) >= max_unique:
                groups.append(current)
                current, seen = [], set()
            seen.add(k)
            current.append(it)
        if current:
            groups.append(current)
        return groups

    def _ensure_flusher(self, loop: asyncio.AbstractEventLoop) -> None:
        if self._flusher is None or self._loop is not loop:
            self._loop = loop
            self._flusher = loop.create_task(self._flush_loop())

    def _hold_for_depth(self, queue, now: float) -> bool:
        """Queue-depth-aware soft flush: the device is idle and the oldest
        item passed the soft deadline, but if the measured arrival rate
        projects the queue reaching the next batch-ladder step before the
        HARD deadline, hold to deepen the batch. A paused arrival stream
        flushes at once, and the hard deadline always flushes."""
        n = len(queue)
        if n < 2:
            return False
        from imagekit_tpu.utils.bucketing import BATCH_SIZES

        steps = sorted(
            {b for b in BATCH_SIZES if b < self.max_batch} | {self.max_batch}
        )
        next_step = next((b for b in steps if b > n), None)
        if next_step is None:
            return False
        oldest = queue[0].enqueued
        newest = queue[-1].enqueued
        span = newest - oldest
        if span <= 0:
            return False
        rate = (n - 1) / span
        if now - newest > max(2.0 / rate, self.max_delay):
            return False
        remaining = oldest + self.hard_delay - now
        if remaining <= 0:
            return False
        return n + rate * remaining >= next_step

    async def _flush_loop(self) -> None:
        # Batch-while-busy: while a device call is in flight, partial
        # batches keep accumulating; the soft deadline applies only when
        # the device is idle, the hard deadline always.
        try:
            while not self._closed:
                await asyncio.sleep(self.max_delay / 2)
                now = time.perf_counter()
                queues = self._jqueues
                for key in sorted(
                    list(queues), key=lambda k: -len(queues.get(k) or [])
                ):
                    queue = queues.get(key) or []
                    if not queue:
                        continue
                    age = now - queue[0].enqueued
                    if age >= self.hard_delay:
                        pass  # hard deadline: always flush
                    elif self._inflight == 0 and age >= self.max_delay:
                        if self._hold_for_depth(queue, now):
                            self.metrics.inc("flush_holds")
                            continue
                    else:
                        continue
                    queues[key] = []
                    asyncio.ensure_future(self._flush_jpeg(key, queue))
        except asyncio.CancelledError:
            pass

    async def warmup(self) -> None:
        """Build the CUDA kernels before the first request needs them (a
        hand-written kernel has no per-shape compile to warm)."""
        if self.device.type == "cuda":
            from imagekit_tpu_torch.ops import _build

            await asyncio.get_running_loop().run_in_executor(
                self._device_pool, _build.load
            )

    async def close(self) -> None:
        self._closed = True
        if self._flusher is not None:
            self._flusher.cancel()
        self._codec_pool.shutdown(wait=False, cancel_futures=True)
        self._device_pool.shutdown(wait=False, cancel_futures=True)
