"""YUV-source head: decoded lossy WebP planes -> K2 on the card -> WebP,
JPEG or AVIF.

Counterpart of ``imagekit_tpu/serving/engine_yuv.py:32-58,111-372`` for
lossy WebP sources (studio-range BT.601 4:2:0, no alpha plane): the native
VP8 decode hands its planes over on the codec pool, a batch is the
reference's flat (B, pad128(bh*bw*3/2)) u8 layout (Y, then Cb, then Cr;
every plane starts on a multiple of 64 bytes, so K2 reads the three in
place), and one call of
:func:`imagekit_tpu_torch.ops.dct.resize_yuv420_batch` (WebP, AVIF output) or
:func:`imagekit_tpu_torch.ops.dct.resize_yuv_jpeg_batch` (JPEG output), one
K2 launch on CUDA, produces what the host VP8, first-party AV1 or Huffman
encoder takes (WebP and AVIF items share a batch).
No RGB anywhere. The weight stacks live on the device with their band and
compact tables. Planes beyond the bucket ladder are turned away
(``_NativeUnsupported``) to the pixel decode and the engine's exact-shape
path, as the reference turns them away.

Not ported: AVIF sources (``_transform_avif_native``) with their BT.709,
4:2:2 / 4:4:4 and alpha variants of the batch; and, by design, the compile
kick and the host fallback for cold shapes (a hand-written kernel has no
per-shape compile).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops.dct import resize_yuv420_batch, resize_yuv_jpeg_batch
from imagekit_tpu_torch.ops.resize_strip import ResizeTables, resize_tables
from imagekit_tpu_torch.ops.weights import (
    combined_chroma_half_weights,
    pad128,
    quality_tables,
    target_dimensions,
)
from imagekit_tpu_torch.serving.batch_types import (
    _cached_weights,
    _NativeUnsupported,
    _YuvItem,
)
from imagekit_tpu_torch.utils.bucketing import batch_bucket, bucket_for


class YuvPathMixin:
    async def _transform_webp_native(
        self, data: bytes, w, h, fmt: ImageFormat, quality: int
    ) -> bytes:
        """Lossy WebP -> WebP, JPEG or AVIF through the YUV-domain batch.
        Raises ``_NativeUnsupported`` for what the pixel decode takes
        instead: a lossless or extended container, and a corrupt stream
        (whose error that decode reports)."""
        from imagekit_tpu_torch.codecs import vp8 as vp8_native

        loop = asyncio.get_running_loop()
        self._ensure_flusher(loop)

        def vp8_decode():
            try:
                return vp8_native.decode_yuv420(data)
            except ValueError as e:
                raise _NativeUnsupported() from e

        planes = await self._pool_run("vp8_decode", vp8_decode)
        if planes is None:  # VP8L / VP8X -> the pixel decode
            raise _NativeUnsupported()
        return await self._enqueue_yuv(planes, w, h, quality, loop, fmt)

    async def _enqueue_yuv(self, planes, w, h, quality: int, loop,
                           fmt: ImageFormat) -> bytes:
        """Queue decoded studio-range planes; the output-format tag keeps
        resize-only (WebP, AVIF) and resize + fDCT (JPEG) batches
        homogeneous."""
        y, cb, cr = planes
        ih, iw = y.shape
        out_w, out_h = target_dimensions(iw, ih, w, h)
        try:
            bh, bw = bucket_for(ih), bucket_for(iw)
            obh, obw = bucket_for(out_h), bucket_for(out_w)
        except ValueError:
            # beyond the ladder: the pixel decode and the exact-shape path
            raise _NativeUnsupported() from None
        if bh % 16 or bw % 16:
            raise _NativeUnsupported()
        fut: asyncio.Future = loop.create_future()
        item = _YuvItem(y, cb, cr, out_h, out_w, quality, fut, fmt=fmt)
        key = (bh, bw, obh, obw, fmt == ImageFormat.jpeg)
        queue = self._yqueues.setdefault(key, [])
        queue.append(item)
        self.metrics.queue_depth = self._total_queued()
        if len(queue) >= self.max_batch:
            self._yqueues[key] = []
            asyncio.ensure_future(self._flush_yuv(key, queue))
        return await fut

    async def _flush_yuv(self, key, items) -> None:
        groups = self._split_by_geometry(
            items,
            lambda it: (it.y.shape[1], it.y.shape[0], it.out_w, it.out_h),
            self.MAX_UNIQUE,
        )
        await asyncio.gather(*(self._flush_yuv_group(key, g) for g in groups))

    async def _flush_yuv_group(self, key, items) -> None:
        loop = asyncio.get_running_loop()
        bh, bw, obh, obw, jq = key
        ch_b, cw_b = bh // 2, bw // 2  # source chroma bucket dims
        try:
            t0 = time.perf_counter()
            nb = batch_bucket(len(items), self.max_batch)
            ny = bh * bw
            nc = ch_b * cw_b
            flat = np.zeros((nb, pad128(ny + 2 * nc)), np.uint8)
            u_keys: Dict[Tuple[int, int, int, int], int] = {
                g: i
                for i, g in enumerate(
                    sorted(
                        {
                            (it.y.shape[1], it.y.shape[0], it.out_w, it.out_h)
                            for it in items
                        }
                    )
                )
            }
            vidx = np.zeros(nb, np.int32)
            qto = np.zeros((nb, 128), np.float32) if jq else None
            for i, it in enumerate(items):
                ihh, iww = it.y.shape
                flat[i, :ny].reshape(bh, bw)[:ihh, :iww] = it.y
                chh, cww = it.cb.shape
                flat[i, ny:ny + nc].reshape(ch_b, cw_b)[:chh, :cww] = it.cb
                flat[i, ny + nc:ny + 2 * nc].reshape(ch_b, cw_b)[
                    :chh, :cww] = it.cr
                vidx[i] = u_keys[(iww, ihh, it.out_w, it.out_h)]
                if jq:
                    qto[i, :64], qto[i, 64:] = quality_tables(it.quality)
            weights, bands = self._yuv_weights(key, u_keys)
            t1 = time.perf_counter()

            def device_step():
                with self._placement() as put:
                    if jq:
                        return resize_yuv_jpeg_batch(
                            put(flat), weights, put(qto), put(vidx),
                            (bh, bw), (obh, obw), bands=bands,
                            device=self.device,
                        )
                    return resize_yuv420_batch(
                        put(flat), weights, put(vidx), (bh, bw), (obh, obw),
                        bands=bands, device=self.device,
                    )

            self._inflight += 1
            try:
                out = await loop.run_in_executor(self._device_pool, device_step)
            finally:
                self._inflight -= 1
            t2 = time.perf_counter()
            self.metrics.add_stage_time("batch_build", t1 - t0)
            self.metrics.add_stage_time("device_resize", t2 - t1)
            self.metrics.record_batch(len(items))
            finish = self._finish_jpg if jq else self._finish_jpeg_yuv
            await asyncio.gather(
                *(finish(out, i, it) for i, it in enumerate(items)))
        except Exception as e:  # noqa: BLE001 - every waiter gets the error
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
        finally:
            self.metrics.queue_depth = self._total_queued()

    def _yuv_weights(self, key, u_keys):
        """The (wv_y, wh_y, wv_c, wh_c) stacks for this set of geometries
        and their (luma, chroma) :class:`ResizeTables`, kept on the
        engine's device across batches (``engine_yuv.py:223-279``): luma
        Lanczos stacks, chroma with subsample, resize and upsample folded to
        HALF output resolution. For JPEG output the rows past the true
        output replicate the last true row up to the MCU grid (the staged
        encoder's ``np.pad(mode="edge")``); the tables are built after
        that."""
        bh, bw, obh, obw, jq = key
        wkey = ("yuvsrc", key, tuple(sorted(u_keys)))
        cached = self._dweights.get(wkey)
        if cached is not None:
            return cached
        nu = self.MAX_UNIQUE
        wv_y = np.zeros((nu, obh, bh), np.float32)
        wh_y = np.zeros((nu, obw, bw), np.float32)
        wv_c = np.zeros((nu, obh // 2, bh // 2), np.float32)
        wh_c = np.zeros((nu, obw // 2, bw // 2), np.float32)
        for (iww, ihh, ow_, oh_), u in u_keys.items():
            ch_, cw_ = (ihh + 1) // 2, (iww + 1) // 2
            wv_y[u] = _cached_weights(ihh, oh_, bh, obh)
            wh_y[u] = _cached_weights(iww, ow_, bw, obw)
            wv_c[u] = combined_chroma_half_weights(
                ch_, ihh, oh_, bh // 2, obh // 2)
            wh_c[u] = combined_chroma_half_weights(
                cw_, iww, ow_, bw // 2, obw // 2)
            if jq:
                m_h = min((oh_ + 15) // 16 * 16, obh)
                m_w = min((ow_ + 15) // 16 * 16, obw)
                wv_y[u, oh_:m_h] = wv_y[u, oh_ - 1]
                wh_y[u, ow_:m_w] = wh_y[u, ow_ - 1]
                ch_t = (oh_ + 1) // 2
                cw_t = (ow_ + 1) // 2
                wv_c[u, ch_t: m_h // 2] = wv_c[u, ch_t - 1]
                wh_c[u, cw_t: m_w // 2] = wh_c[u, cw_t - 1]
        stacks = [torch.from_numpy(w_) for w_ in (wv_y, wh_y, wv_c, wh_c)]
        bands = tuple(ResizeTables(*(t.to(self.device)
                                     for t in resize_tables(*pair)))
                      for pair in (stacks[:2], stacks[2:]))
        cached = (tuple(s.to(self.device) for s in stacks), bands)
        self._dweights.put(wkey, cached)
        return cached
