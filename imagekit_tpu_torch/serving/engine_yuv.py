"""YUV-source head: decoded lossy WebP and AVIF planes -> K2 on the card ->
WebP, JPEG or AVIF.

Counterpart of ``imagekit_tpu/serving/engine_yuv.py:32-372``. A lossy
WebP's planes come from the native VP8 decode (studio-range BT.601 4:2:0);
an AVIF's from the port's AV1 decoder (:mod:`imagekit_tpu_torch.codecs.
avif_native`): studio range, 4:2:0, 4:2:2 or 4:4:4, with an alpha plane
and a BT.709 flag. Both are decoded on the codec pool. A batch is the
reference's flat (B, pad128(bh*bw + 2*(bh/csy)*(bw/csx) [+ bh*bw])) u8
layout (Y, Cb, Cr, then alpha; every plane starts on a multiple of 64
bytes, so K2 reads them in place), keyed by chroma factors, alpha and the
709 mix as the reference keys it, and one call of
:func:`imagekit_tpu_torch.ops.dct.resize_yuv420_batch` (WebP, AVIF output)
or :func:`imagekit_tpu_torch.ops.dct.resize_yuv_jpeg_batch` (JPEG output),
one K2 launch on CUDA, produces what the host VP8, first-party AV1 or
Huffman encoder takes (WebP and AVIF items share a batch). No RGB
anywhere. Only AVIF output keeps an alpha plane; WebP output drops it, and
JPEG output of chroma factors other than 4:2:0 takes the pixel decode, as
at the reference's ``engine_yuv.py:96-106``. The weight stacks live on the
device with their band and compact tables (on each device of the engine's
grid, where a batch splits over one: one call a shard). Planes beyond the
bucket ladder are turned away (``_NativeUnsupported``) to the pixel decode
and the engine's exact-shape path, as the reference turns them away.

Not ported, by design: the compile kick and the host fallback for cold
shapes (a hand-written kernel has no per-shape compile).
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Dict, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops.dct import resize_yuv420_batch, resize_yuv_jpeg_batch
from imagekit_tpu_torch.ops.resize_strip import resize_tables
from imagekit_tpu_torch.ops.weights import (
    combined_chroma_half_weights,
    combined_chroma_weights,
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

    async def _transform_avif_native(
        self, data: bytes, w, h, fmt: ImageFormat, quality: int
    ) -> bytes:
        """AVIF -> WebP, JPEG or AVIF through the YUV-domain batch
        (``engine_yuv.py:60-110``): the container parse and the port's AV1
        decode on the codec pool yield studio-range planes. Raises
        ``_NativeUnsupported`` for what the pixel decode takes instead (a
        file the direct path declines, 4:2:2 or 4:4:4 to JPEG) and lets
        NotPortedError through (a tool the decoder does not build)."""
        from imagekit_tpu_torch.codecs import avif_native

        loop = asyncio.get_running_loop()
        self._ensure_flusher(loop)

        def avif_decode():
            try:
                # only AVIF output keeps alpha: the other outputs skip the
                # alpha item's decode outright
                return avif_native.decode_yuv_studio(
                    data, want_alpha=(fmt == ImageFormat.avif))
            except ValueError as e:
                raise _NativeUnsupported() from e

        out = await self._pool_run("avif_decode", avif_decode)
        if out is None:  # declined or undecodable -> the pixel decode
            raise _NativeUnsupported()
        if (out.csy, out.csx) != (2, 2) and fmt == ImageFormat.jpeg:
            # the fDCT head takes 4:2:0 only; the pixel decode takes these
            raise _NativeUnsupported()
        alpha = out.alpha if fmt == ImageFormat.avif else None
        return await self._enqueue_yuv(
            (out.y, out.u, out.v), w, h, quality, loop, fmt,
            cs=(out.csy, out.csx), alpha=alpha, mix=out.bt709)

    async def _enqueue_yuv(self, planes, w, h, quality: int, loop,
                           fmt: ImageFormat, cs=(2, 2), alpha=None,
                           mix: bool = False) -> bytes:
        """Queue decoded studio-range planes (``engine_yuv.py:111-149``);
        the output-format tag keeps resize-only (WebP, AVIF) and resize +
        fDCT (JPEG) batches homogeneous, and ``cs`` (the source chroma
        factors), ``alpha`` (full-range u8, luma geometry) and ``mix``
        (BT.709 planes) key their own batches of the same head."""
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
        item = _YuvItem(y, cb, cr, out_h, out_w, quality, fut, fmt=fmt,
                        alpha=alpha, mix=mix)
        key = (bh, bw, obh, obw, fmt == ImageFormat.jpeg, cs[0], cs[1], mix,
               alpha is not None)
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
        bh, bw, obh, obw, jq, csy, csx, mix, al = key
        ch_b, cw_b = bh // csy, bw // csx  # source chroma bucket dims
        try:
            t0 = time.perf_counter()
            nb = batch_bucket(len(items), self.max_batch)
            ny = bh * bw
            nc = ch_b * cw_b
            flat = np.zeros((nb, pad128(ny + 2 * nc + (ny if al else 0))),
                            np.uint8)
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
                if al:
                    # the pad region stays 0 (transparent), cropped on host
                    flat[i, ny + 2 * nc:2 * ny + 2 * nc].reshape(bh, bw)[
                        :ihh, :iww] = it.alpha
                vidx[i] = u_keys[(iww, ihh, it.out_w, it.out_h)]
                if jq:
                    qto[i, :64], qto[i, 64:] = quality_tables(it.quality)
            trees = {dev: self._yuv_weights(key, u_keys, dev)
                     for dev in set(self._shard_devices(nb))}
            t1 = time.perf_counter()

            def device_step(put, shard):
                weights, bands = trees[shard.device]
                rows, dev = shard.rows, shard.device
                if jq:
                    return resize_yuv_jpeg_batch(
                        put(flat[rows]), weights, put(qto[rows]),
                        put(vidx[rows]), (bh, bw), (obh, obw), mix=mix,
                        bands=bands, device=dev, host=shard.host,
                    )
                return resize_yuv420_batch(
                    put(flat[rows]), weights, put(vidx[rows]), (bh, bw),
                    (obh, obw), chroma_sub=(csy, csx), mix=mix, alpha=al,
                    bands=bands, device=dev, host=shard.host,
                )

            self._inflight += 1
            try:
                out = await loop.run_in_executor(
                    self._device_pool, self._run_shards, nb, device_step)
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

    def _yuv_weights(self, key, u_keys, device=None):
        """The (wv_y, wh_y, wv_c, wh_c[, wv_cf, wh_cf]) stacks for this set
        of geometries and their (luma, chroma[, chroma full])
        :class:`ResizeTables`, kept on ``device`` (the engine's by default)
        across batches (``engine_yuv.py:223-279``): luma Lanczos stacks,
        chroma with subsample, resize and upsample (the identity on an axis
        the source does not subsample) folded to HALF output resolution,
        and for a BT.709 batch to the FULL output grid too. For JPEG output
        the rows past the true output replicate the last true row up to
        the MCU grid (the staged encoder's ``np.pad(mode="edge")``); the
        tables are built after that."""
        wkey = ("yuvsrc", key, tuple(sorted(u_keys)))
        return self._on_device(wkey, device, functools.partial(
            self._yuv_stacks, key, u_keys))

    def _yuv_stacks(self, key, u_keys):
        """:meth:`_yuv_weights`' stacks and tables, on the CPU."""
        bh, bw, obh, obw, jq, csy, csx, mix, _al = key
        ch_b, cw_b = bh // csy, bw // csx
        nu = self.MAX_UNIQUE
        wv_y = np.zeros((nu, obh, bh), np.float32)
        wh_y = np.zeros((nu, obw, bw), np.float32)
        wv_c = np.zeros((nu, obh // 2, ch_b), np.float32)
        wh_c = np.zeros((nu, obw // 2, cw_b), np.float32)
        if mix:
            wv_cf = np.zeros((nu, obh, ch_b), np.float32)
            wh_cf = np.zeros((nu, obw, cw_b), np.float32)
        for (iww, ihh, ow_, oh_), u in u_keys.items():
            ch_ = (ihh + csy - 1) // csy
            cw_ = (iww + csx - 1) // csx
            wv_y[u] = _cached_weights(ihh, oh_, bh, obh)
            wh_y[u] = _cached_weights(iww, ow_, bw, obw)
            wv_c[u] = combined_chroma_half_weights(
                ch_, ihh, oh_, ch_b, obh // 2)
            wh_c[u] = combined_chroma_half_weights(
                cw_, iww, ow_, cw_b, obw // 2)
            if mix:
                wv_cf[u] = combined_chroma_weights(ch_, ihh, oh_, ch_b, obh)
                wh_cf[u] = combined_chroma_weights(cw_, iww, ow_, cw_b, obw)
            if jq:
                m_h = min((oh_ + 15) // 16 * 16, obh)
                m_w = min((ow_ + 15) // 16 * 16, obw)
                wv_y[u, oh_:m_h] = wv_y[u, oh_ - 1]
                wh_y[u, ow_:m_w] = wh_y[u, ow_ - 1]
                ch_t = (oh_ + 1) // 2
                cw_t = (ow_ + 1) // 2
                wv_c[u, ch_t: m_h // 2] = wv_c[u, ch_t - 1]
                wh_c[u, cw_t: m_w // 2] = wh_c[u, cw_t - 1]
                if mix:
                    wv_cf[u, oh_:m_h] = wv_cf[u, oh_ - 1]
                    wh_cf[u, ow_:m_w] = wh_cf[u, ow_ - 1]
        arrays = (wv_y, wh_y, wv_c, wh_c) + ((wv_cf, wh_cf) if mix else ())
        stacks = tuple(torch.from_numpy(w_) for w_ in arrays)
        bands = tuple(resize_tables(*pair)
                      for pair in (stacks[0:2], stacks[2:4], stacks[4:6])
                      if pair)
        return stacks, bands
