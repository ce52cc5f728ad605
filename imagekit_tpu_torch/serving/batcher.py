"""Dynamic bucketed batching engine on PyTorch.

Counterpart of the core of ``imagekit_tpu/serving/batcher.py`` (:57-351,
:364-500, :699-704): concurrent requests queue by (source bucket, target
bucket, head); a queue flushes when it reaches ``max_batch`` or its oldest
item has waited ``max_delay_ms``, and each flush is ONE device call while
the host codec stages run on a thread pool. Admission control, the
split-by-geometry rule and the depth-aware soft flush are the reference's.
Three heads are served: JPEG sources on their coefficients
(:mod:`.engine_jpeg`, ``_jqueues``), lossy WebP and AVIF sources on their
decoded YUV planes (:mod:`.engine_yuv`, ``_yqueues``), and sources decoded to
pixels (:mod:`.engine_rgb`, ``_queues``): PNGs, the other WebPs, GIF, BMP,
TIFF, HDR and farbfeld, with 3 channels on the fused heads and with 4 on
the plain RGB head. A request with no resize decodes and encodes one image
(:mod:`imagekit_tpu_torch.transform`) without a batch, and so does one
whose source or target passes the bucket ladder's top (``_exact_path``,
the reference's :503-521): its native head turns it away, it decodes to
pixels and is resized at its exact shape
(:func:`imagekit_tpu_torch.parallel.tiling.resize_oversized`).

What differs is device placement. The engine holds an explicit
``torch.device``: ``"cuda"`` (the default, which raises without a card) or
``"cpu"`` by name, where the heads run their plain PyTorch versions. Each
of the two dispatch threads owns a CUDA stream; a batch's arrays go through
pinned host memory with a non-blocking copy on that stream, its kernels
launch on it, and the stream is synchronised before the planes are read
back. With a device grid (``mesh``, :func:`imagekit_tpu_torch.parallel.
mesh.make_mesh`; built over every card where ``"cuda"`` names no index and
more than one is visible, as the reference's ``__init__`` builds its mesh)
a batch whose size splits evenly over the grid's devices runs its head once
per device on its share of the items (``_run_shards``): each dispatch
thread keeps one stream for each place of the grid, every shard is launched
(its head asked for device results, ``host=False``) before any is read
back, and the outputs are gathered in item order. The weight stacks are
built once and cached on each device, under each device's own byte
budget. Other batches, and single images, run on the first device; so
does an image beyond the bucket ladder unless it does not fit there
(``_exact_path``). A
single image's device steps (the JPEG pixel decode, the colour mix and
fDCT of a JPEG encode) go to the same two dispatch threads, not to the
codec-pool thread that holds the image as in the reference: each is
some hundred small device operations issued from Python, and issued from
many threads at once they slow each other down (32 thumbnail fDCTs take
0.15 s from one thread and 0.85 s from sixteen on an H100,
``tools/single_image_probe.py``). Their host halves, the entropy decode
and the Huffman encode, stay on the codec pool. There is no compile set
and no cold-shape host fallback: a hand-written kernel has no per-shape
compile.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from imagekit_tpu_torch.codecs import (
    SourceFormat,
    decode_bytes,
    guess_format,
    jpeg,
    tiff,
)
from imagekit_tpu_torch.codecs.native import loader
from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.device import resolve_device
from imagekit_tpu_torch.errors import (
    EngineOverloaded,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.ops.weights import target_dimensions
from imagekit_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_devices
from imagekit_tpu_torch.parallel.tiling import resize_oversized, split_grid
from imagekit_tpu_torch.transform import encode_image
from imagekit_tpu_torch.serving.batch_types import (
    _BucketKey,
    _Item,
    _NativeUnsupported,
)
from imagekit_tpu_torch.serving.engine import TransformEngine
from imagekit_tpu_torch.serving.engine_jpeg import JpegPathMixin
from imagekit_tpu_torch.serving.engine_rgb import RgbPathMixin
from imagekit_tpu_torch.serving.engine_yuv import YuvPathMixin
from imagekit_tpu_torch.serving.metrics import METRICS, Metrics
from imagekit_tpu_torch.utils.bucketing import bucket_for
from imagekit_tpu_torch.utils.sized_cache import SizedArrayCache


class _Shard(NamedTuple):
    """One device's share of a batch (:meth:`BatchedEngine._run_shards`)."""

    index: int     # its place on the grid, 0 for a batch run unsharded
    rows: slice    # its items of the batch axis
    device: torch.device
    host: bool     # the head reads its result back (False: _run_shards)


def _all_cards(device) -> bool:
    """Does ``device`` ask for every card (``"cuda"`` with no index) on a
    host with more than one?"""
    dev = torch.device(device)
    return (dev.type == "cuda" and dev.index is None
            and torch.cuda.is_available() and len(visible_devices()) > 1)


def _moved(tree, dev: torch.device):
    """A weight tree (tensors, :class:`ResizeTables` and tuples of them,
    None) with every tensor on ``dev``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    moved = [_moved(t, dev) for t in tree]
    return type(tree)(*moved) if hasattr(tree, "_fields") else tuple(moved)


def _copy_out(out):
    """A shard's device results (tensors, or tuples of them) copied into
    pinned host memory on the current stream, without waiting: read them
    once the stream is synchronised."""
    if isinstance(out, tuple):
        return tuple(_copy_out(o) for o in out)
    return out.to("cpu", non_blocking=True)


def _gather(outs):
    """The shards' read-back outputs (CPU tensors, or tuples of them)
    concatenated along the batch axis, as numpy."""
    if isinstance(outs[0], tuple):
        return tuple(_gather([o[i] for o in outs])
                     for i in range(len(outs[0])))
    return np.concatenate([o.numpy() for o in outs])


class BatchedEngine(RgbPathMixin, JpegPathMixin, YuvPathMixin,
                    TransformEngine):
    MAX_UNIQUE = 4  # fixed unique-geometry slots per device call

    def __init__(
        self,
        config: Optional[ImageKitConfig] = None,
        metrics: Metrics = METRICS,
        codec_workers: Optional[int] = None,
        device: "str | torch.device" = "cuda",
        mesh: Optional[Mesh] = None,
    ) -> None:
        if mesh is None and _all_cards(device):
            mesh = make_mesh()  # data parallel over every visible card
        # a grid's first device is the engine's: single images run there
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0][0])
        self._mesh = mesh
        self._grid = (self.device,) if mesh is None else mesh.flat
        self._mesh_ndev = len(self._grid)
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
        # The first-party AV1 encoder runs Python between short C calls:
        # AVIF encodes get one thread of their own, so that a backlog of
        # them neither thrashes the interpreter lock (several encodes in
        # threads take several times their serial sum, tools/avif_probe.py)
        # nor holds the codec threads.
        self._avif_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ik-avif"
        )
        # the AVIF lane's own admission: its requests in the system and
        # the seconds of its recent encodes (_avif_admission_check)
        self._avif_insystem = 0
        self._avif_secs: "deque[float]" = deque(maxlen=16)
        # Two dispatch threads, one CUDA stream each: batch N+1's
        # host->device copy overlaps batch N's kernels and readback.
        self._device_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="ik-device"
        )
        self._tls = threading.local()
        self._queues: Dict[_BucketKey, List[_Item]] = {}
        self._jqueues: Dict[tuple, list] = {}
        self._yqueues: Dict[tuple, list] = {}
        # folded weight stacks are identical batch to batch for steady
        # traffic: keep them on each device (byte-budgeted per device, as
        # the reference's replicated arrays count once; tensors report
        # .nbytes like arrays)
        budget = int(os.environ.get("IMAGEKIT_DEVICE_WEIGHT_CACHE_MB",
                                    "64")) * 1024 * 1024
        self._dweights = {dev: SizedArrayCache(budget)
                          for dev in dict.fromkeys(self._grid)}
        self._inflight = 0  # device calls dispatched but not finished
        self._flusher: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

    # -- device placement --------------------------------------------------

    def _stream(self, place: int):
        """This dispatch thread's CUDA stream for place ``place`` of the
        grid (0: the engine's device), made on first use."""
        streams = getattr(self._tls, "streams", None)
        if streams is None:
            streams = self._tls.streams = {}
        if place not in streams:
            streams[place] = torch.cuda.Stream(self._grid[place])
        return streams[place]

    @contextlib.contextmanager
    def _placement(self, place: int = 0):
        """Yield ``put(np_array) -> tensor`` on the device at place
        ``place`` of the grid (0: the engine's device). On CUDA the copy
        goes through pinned memory, non-blocking, on this dispatch
        thread's own stream for that place, which stays current for the
        kernels launched inside the block."""
        dev = self._grid[place]
        if dev.type != "cuda":
            yield torch.from_numpy
            return

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)

        with torch.cuda.stream(self._stream(place)):
            yield put

    def _use_mesh(self, nb: int) -> bool:
        """Split this batch over the grid? Only where its ``nb`` items
        split evenly over the grid's devices (the reference's rule: a
        sharding needs the axis divisible by the mesh's extent)."""
        return self._mesh is not None and nb % self._mesh_ndev == 0

    def _shard_devices(self, nb: int) -> tuple:
        """The device of each shard of a batch of ``nb``: the grid's, in
        order, or the engine's device alone."""
        return self._grid if self._use_mesh(nb) else (self.device,)

    def _on_device(self, wkey, device: Optional[torch.device], build):
        """``build()`` (CPU tensors, :class:`ResizeTables` and tuples of
        them) on ``device`` (the engine's by default), kept in that
        device's weight cache under ``wkey``. It is built once, on the
        engine's device; another device of the grid takes a copy of that
        tree."""
        home = self._dweights[self.device].get_or_build(
            wkey, lambda: _moved(build(), self.device))
        dev = device or self.device
        if dev == self.device:
            return home
        return self._dweights[dev].get_or_build(wkey,
                                                lambda: _moved(home, dev))

    def _run_shards(self, nb: int, step):
        """A batch's device step on a dispatch thread: ``step(put,
        shard)`` once per :class:`_Shard` of the batch, with ``put``
        placing a host array on the shard's device (its stream current).
        Unsharded, one call on the engine's device with every row, whose
        head reads its result back (``shard.host``). Sharded, each shard's
        head returns device tensors (or tuples of them) and is launched
        before any is read back: each shard's copies are queued
        on its stream, the streams are synchronised, and the outputs are
        concatenated in item order. A shard that raises fails the whole
        batch; it is never run again unsharded."""
        devices = self._shard_devices(nb)
        if len(devices) == 1:
            with self._placement() as put:
                return step(put, _Shard(0, slice(None), self.device, True))
        m = nb // len(devices)
        outs = []
        try:
            for j, dev in enumerate(devices):
                with self._placement(j) as put:
                    outs.append(_copy_out(step(put, _Shard(
                        j, slice(j * m, (j + 1) * m), dev, False))))
        finally:
            for j, dev in enumerate(devices[:len(outs) + 1]):
                if dev.type == "cuda":
                    self._stream(j).synchronize()
        return _gather(outs)

    # -- decode ------------------------------------------------------------

    async def decode(self, data: bytes) -> np.ndarray:
        """Every source the port has a decoder for -> pixels, on the codec
        pool, without Pillow (:func:`imagekit_tpu_torch.codecs.
        decode_bytes`). A JPEG is entropy-decoded there, and its IDCT,
        chroma upsample and colour stages run on the engine's device (K6's
        two launches on CUDA) from a dispatch thread, as do a JPEG-compressed
        TIFF's page (its strips or tiles entropy-decoded on the pool) and
        a CMYK TIFF's colour step. A source that the reference decodes in
        full at its
        fetch stage (everything but JPEG, WebP and AVIF) and whose data does
        not decode raises :class:`SourceDecodeError`."""
        src = guess_format(data)  # TransformError on undetectable bytes
        if src == SourceFormat.jpeg:
            comps = await self._pool_run(
                "entropy_decode", jpeg.decode_to_coefficients, data)
            return await self._device_run(
                "device_decode", jpeg.components_to_rgb, comps)
        at_fetch = src not in (SourceFormat.webp, SourceFormat.avif)

        def run(decode=lambda d: decode_bytes(d)[0]):
            try:
                return decode(data)
            except TransformError as e:
                if at_fetch:  # in Pillow's words where they differ
                    raise SourceDecodeError(
                        getattr(e, "pillow", e.message)) from e
                raise

        if src == SourceFormat.tiff:
            # a JPEG TIFF's segments (an old-style page's one stream) are
            # entropy-decoded on the pool (its time under
            # "entropy_decode") and its page decoded on a dispatch thread,
            # as a JPEG; so is a YCbCr page's (its planes unpacked on the
            # pool); a CMYK or CIELab TIFF's colour step runs there; the
            # other sample layouts end on the pool, oriented there
            stored, kind, orientation = await self._pool_run(
                lambda out: "entropy_decode" if out and out[1] == tiff.JPEG
                else "decode", run, tiff.decode_stored)
            if kind == tiff.SAMPLES:
                return stored
            return await self._device_run("device_decode", tiff.finish,
                                          stored, kind, orientation)
        return await self._pool_run(
            "decode_png" if src == SourceFormat.png else "decode", run)

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

    def _avif_admission_check(self) -> None:
        """Refuse an AVIF request its one encode thread cannot reach within
        the latency budget: drain time = AVIF requests in the system times
        the mean of the recent encodes' seconds. The engine-wide check
        reads a completion rate that faster formats dominate; an AVIF
        encode takes seconds, so without this bound its queue would grow
        unseen until every format is shed. No encode yet admits."""
        budget = self.admit_budget_s
        if budget <= 0 or not self._avif_secs:
            return
        wait = self._avif_insystem * (
            sum(self._avif_secs) / len(self._avif_secs))
        if wait > budget:
            self.metrics.inc("shed")
            raise EngineOverloaded(max(1.0, wait - budget))

    @contextlib.contextmanager
    def _admission(self, fmt: ImageFormat):
        avif = fmt == ImageFormat.avif
        if avif:
            self._avif_admission_check()
        self._admission_check()
        self._insystem += 1
        self._avif_insystem += avif
        try:
            yield
            self._done_times.append(time.monotonic())
        finally:
            self._insystem -= 1
            self._avif_insystem -= avif

    async def _pool_run(self, stage, fn, *args, pool=None):
        """Run ``fn`` on the codec pool (or ``pool``); ``stage_seconds``
        gets the time inside the call, ``stage_wait_seconds`` the
        pool-queue time, under ``stage``: a name, or a function of the
        call's result (None where it raised) that gives one."""
        loop = asyncio.get_running_loop()
        t_submit = time.perf_counter()

        def timed():
            t_start = time.perf_counter()
            out = None
            try:
                out = fn(*args)
                return out
            finally:
                spent = time.perf_counter() - t_start
                name = stage if isinstance(stage, str) else stage(out)
                self.metrics.add_stage_wait(name, t_start - t_submit)
                self.metrics.add_stage_time(name, spent)
                if pool is self._avif_pool:
                    self._avif_secs.append(spent)

        return await loop.run_in_executor(pool or self._codec_pool, timed)

    async def _device_run(self, stage: str, fn, *args):
        """Run a single image's device step, ``fn(*args, device=...)``, on
        a dispatch thread and its stream; ``stage_seconds`` gets the time
        inside the call."""
        def timed():
            t0 = time.perf_counter()
            try:
                with self._placement():
                    return fn(*args, device=self.device)
            finally:
                self.metrics.add_stage_time(stage, time.perf_counter() - t0)

        self._inflight += 1
        try:
            return await asyncio.get_running_loop().run_in_executor(
                self._device_pool, timed)
        finally:
            self._inflight -= 1

    # -- entry points ------------------------------------------------------

    async def resize_encode(
        self,
        img: np.ndarray,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        with self._admission(fmt):
            return await self._resize_encode(img, w, h, fmt, quality)

    async def _resize_encode(
        self,
        img: np.ndarray,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        """Queue decoded pixels for the RGB head: the fused output kinds of
        3-channel sources, WebP or AVIF (``"yuv"``) and JPEG (``"jpg"``),
        or the plain head (``""``) for sources with alpha, whose resized
        pixels go through :func:`~imagekit_tpu_torch.transform.
        encode_image`. With no resize the pixels go straight to that
        encode; beyond the bucket ladder they take :meth:`_exact_path`."""
        loop = asyncio.get_running_loop()
        self._ensure_flusher(loop)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        ih, iw, ch = img.shape
        if w is None and h is None:
            # no-op resize (src/transform.rs:67-69): straight to encode
            return await self._encode(img, fmt, quality)
        out_w, out_h = target_dimensions(iw, ih, w, h)
        try:
            bh, bw = bucket_for(ih), bucket_for(iw)
            obh, obw = bucket_for(out_h), bucket_for(out_w)
        except ValueError:
            # outside the ladder -> exact-shape path
            return await self._exact_path(img, out_h, out_w, fmt, quality)
        from imagekit_tpu_torch.codecs import vp8 as vp8_native

        if ch == 3 and fmt == ImageFormat.webp and vp8_native.available():
            okind = "yuv"
        elif ch == 3 and fmt == ImageFormat.avif:
            okind = "yuv"  # the planes are the AV1 encoder's input too
        elif ch == 3 and fmt == ImageFormat.jpeg:
            okind = "jpg"
        else:
            okind = ""  # 4 channels stay on the plain RGB head
        fut: asyncio.Future = loop.create_future()
        item = _Item(img, out_h, out_w, fmt, quality, fut)
        key = (bh, bw, obh, obw, ch, okind)
        queue = self._queues.setdefault(key, [])
        queue.append(item)
        self.metrics.queue_depth = self._total_queued()
        if len(queue) >= self.max_batch:
            self._queues[key] = []
            asyncio.ensure_future(self._flush(key, queue))
        return await fut

    async def transform(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        with self._admission(fmt):
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
        resize = w is not None or h is not None
        # a native head turns away what its batch cannot take (a source or
        # target beyond the bucket ladder): the request decodes to pixels
        if src == SourceFormat.jpeg and resize:
            try:
                return await self._transform_jpeg_native(
                    data, w, h, fmt, quality
                )
            except _NativeUnsupported:
                pass
        if src == SourceFormat.webp and resize:
            # the native VP8 decode feeds the YUV-domain batch: resize-only
            # for WebP output, resize + remap + fDCT for JPEG output; a
            # lossless or extended container decodes to pixels instead
            try:
                return await self._transform_webp_native(
                    data, w, h, fmt, quality
                )
            except _NativeUnsupported:
                pass
        if src == SourceFormat.avif and resize:
            # the port's AV1 decode feeds the same YUV-domain batch
            # (``batcher.py:335-345``), in any chroma factors, with its
            # alpha plane (AVIF output) and BT.709 mix
            try:
                return await self._transform_avif_native(
                    data, w, h, fmt, quality
                )
            except _NativeUnsupported:
                pass
        img = await self.decode(data)
        return await self._resize_encode(img, w, h, fmt, quality)

    # -- batching ----------------------------------------------------------

    def _total_queued(self) -> int:
        return sum(
            len(q)
            for queues in (self._queues, self._jqueues, self._yqueues)
            for q in queues.values()
        )

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
        from imagekit_tpu_torch.utils.bucketing import BATCH_SIZES

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
                for queues, flush in (
                    (self._queues, self._flush),
                    (self._jqueues, self._flush_jpeg),
                    (self._yqueues, self._flush_yuv),
                ):
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
                        asyncio.ensure_future(flush(key, queue))
        except asyncio.CancelledError:
            pass

    async def _encode(self, img: np.ndarray, fmt: ImageFormat, q: int) -> bytes:
        """One image's encode (:func:`~imagekit_tpu_torch.transform.
        encode_image`, in its two halves for a JPEG): the colour mix and
        fDCT on the engine's device from a dispatch thread, the Huffman or
        VP8 coding on the codec pool, an AVIF on the AVIF thread."""
        img = np.ascontiguousarray(img)
        if fmt != ImageFormat.jpeg:  # WebP and AVIF have no device step
            return await self._pool_run(
                "encode", encode_image, img, fmt, q, self.device,
                pool=self._avif_pool if fmt == ImageFormat.avif else None)
        planes, qtabs = await self._device_run(
            "device_encode", jpeg.encode_levels, img, q)
        return await self._pool_run("encode", loader.encode_jpeg, planes,
                                    qtabs, img.shape[1], img.shape[0])

    async def _exact_path(self, img: np.ndarray, out_h: int, out_w: int,
                          fmt: ImageFormat, quality: int) -> bytes:
        """An image beyond the bucket ladder: resized at its exact shape
        on a dispatch thread (one K2 launch on CUDA; its height split over
        up to 4 of the grid's devices only where it does not fit the
        engine's device, :func:`~imagekit_tpu_torch.parallel.tiling.
        split_grid`), then encoded as one image (:meth:`_encode`)."""
        grid = split_grid(img, out_h, out_w, self._grid)
        resized = await self._device_run(
            "exact_resize", functools.partial(resize_oversized, mesh=grid),
            img, out_h, out_w)
        return await self._encode(resized, fmt, quality)

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
        self._avif_pool.shutdown(wait=False, cancel_futures=True)
        self._device_pool.shutdown(wait=False, cancel_futures=True)

