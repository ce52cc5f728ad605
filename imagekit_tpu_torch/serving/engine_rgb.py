"""RGB-source head: decoded pixels -> K2 on the card -> WebP, JPEG or AVIF.

Counterpart of ``imagekit_tpu/serving/engine_rgb.py:23-229``: the two
fused output kinds of 3-channel sources, ``"yuv"`` (resample + studio YUV
4:2:0, WebP or AVIF output) and ``"jpg"`` (resample + YCbCr + fDCT/quantise,
JPEG output), and the plain kind ``""`` of sources with alpha (resample
only; each resized image is cropped and encoded through
:func:`imagekit_tpu_torch.transform.encode_image`, which drops the alpha
for WebP and JPEG and keeps a real one for AVIF).
A batch is the reference's flat (B, H, W*C) u8 layout; the weight stacks
are keyed per axis (``v_keys`` / ``h_keys``), edge-replicated past the true
output for the fused kinds, and kept on the device with their band and
compact tables; one call of
:func:`imagekit_tpu_torch.ops.color.resample_rgb_yuv_batch`,
:func:`imagekit_tpu_torch.ops.dct.resample_rgb_jpeg_batch` or
:func:`imagekit_tpu_torch.ops.resize.resample_bucketed_flat` (one K2
launch on CUDA; once a shard where the batch splits over the engine's
device grid, ``batcher._run_shards``) produces what the host encoders
take. There is no compile
set and no cold-shape host fallback.
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.ops.color import resample_rgb_yuv_batch
from imagekit_tpu_torch.ops.dct import resample_rgb_jpeg_batch
from imagekit_tpu_torch.ops.resize import resample_bucketed_flat
from imagekit_tpu_torch.ops.resize_strip import resize_tables
from imagekit_tpu_torch.ops.weights import quality_tables
from imagekit_tpu_torch.serving.batch_types import (
    _BucketKey,
    _cached_weights,
    _Item,
    _settle,
)
from imagekit_tpu_torch.utils.bucketing import batch_bucket


class RgbPathMixin:
    async def _flush(self, key: _BucketKey, items: List[_Item]) -> None:
        groups = self._split_by_geometry(
            items,
            lambda it: (it.img.shape[0], it.img.shape[1], it.out_h, it.out_w),
            self.MAX_UNIQUE,
        )
        await asyncio.gather(*(self._flush_group(key, g) for g in groups))

    async def _flush_group(self, key: _BucketKey, items: List[_Item]) -> None:
        loop = asyncio.get_running_loop()
        bh, bw, obh, obw, ch, okind = key
        wy = okind == "yuv"
        jq = okind == "jpg"
        try:
            t0 = time.perf_counter()
            nb = batch_bucket(len(items), self.max_batch)
            # flat (B, H, W*C) u8: pad entries stay zero and cost nothing
            batch = np.zeros((nb, bh, bw * ch), dtype=np.uint8)
            # canonical (sorted) per-axis indexing: groups holding the same
            # SETS of geometries share one device-resident weight stack
            v_keys: Dict[Tuple[int, int], int] = {
                k: i for i, k in enumerate(
                    sorted({(it.img.shape[0], it.out_h) for it in items}))
            }
            h_keys: Dict[Tuple[int, int], int] = {
                k: i for i, k in enumerate(
                    sorted({(it.img.shape[1], it.out_w) for it in items}))
            }
            vidx = np.zeros(nb, np.int32)
            hidx = np.zeros(nb, np.int32)
            qto = np.zeros((nb, 128), np.float32) if jq else None
            for i, it in enumerate(items):
                h_i, w_i = it.img.shape[:2]
                batch[i, :h_i, : w_i * ch] = it.img.reshape(h_i, w_i * ch)
                vidx[i] = v_keys[(h_i, it.out_h)]
                hidx[i] = h_keys[(w_i, it.out_w)]
                if jq:
                    qto[i, :64], qto[i, 64:] = quality_tables(it.quality)
            weights = {dev: self._rgb_weights(key, v_keys, h_keys, dev)
                       for dev in set(self._shard_devices(nb))}
            t1 = time.perf_counter()

            def device_step(put, shard):
                wv, wh, tabs = weights[shard.device]
                rows, dev = shard.rows, shard.device
                x, vi, hi = (put(a[rows]) for a in (batch, vidx, hidx))
                if wy:
                    return resample_rgb_yuv_batch(
                        x, (wv, wh), vi, hi, (obh, obw), bands=tabs,
                        device=dev, host=shard.host,
                    )
                if jq:
                    return resample_rgb_jpeg_batch(
                        x, (wv, wh), vi, hi, put(qto[rows]), (obh, obw),
                        bands=tabs, device=dev, host=shard.host,
                    )
                flat = resample_bucketed_flat(
                    x, wv, wh, vi, hi, ch, bands=tabs, device=dev,
                    host=shard.host,
                )
                return flat.reshape(-1, obh, obw, ch)

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
            finish = (self._finish_yuv if wy else self._finish_jpg if jq
                      else self._finish_pixels)
            await asyncio.gather(
                *(finish(out, i, it) for i, it in enumerate(items)))
        except Exception as e:  # noqa: BLE001 - every waiter gets the error
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
        finally:
            self.metrics.queue_depth = self._total_queued()

    async def _finish_yuv(self, out, i: int, it: _Item) -> None:
        yb, ub, vb = out
        ch2 = (it.out_h + 1) // 2
        cw2 = (it.out_w + 1) // 2
        await _settle(it, self._encode_yuv(
            yb[i, : it.out_h, : it.out_w], ub[i, :ch2, :cw2],
            vb[i, :ch2, :cw2], it.quality, it.fmt))

    async def _finish_jpg(self, out, i: int, it: _Item) -> None:
        from imagekit_tpu_torch.codecs.native import loader

        ylv, cblv, crlv = out
        mby = (it.out_h + 15) // 16 * 2
        mbx = (it.out_w + 15) // 16 * 2

        def run():
            planes = [ylv[i, :mby, :mbx], cblv[i, : mby // 2, : mbx // 2],
                      crlv[i, : mby // 2, : mbx // 2]]
            return loader.encode_jpeg(planes, quality_tables(it.quality),
                                      it.out_w, it.out_h)

        await _settle(it, self._pool_run("encode", run))

    async def _finish_pixels(self, out, i: int, it: _Item) -> None:
        await _settle(it, self._encode(
            out[i, : it.out_h, : it.out_w], it.fmt, it.quality))

    def _rgb_weights(self, key: _BucketKey, v_keys, h_keys, device=None):
        """The (U, obh, bh) / (U, obw, bw) stacks and their
        :class:`ResizeTables` (band tables and K2's compact ``Wh``) for
        this set of geometries, kept on ``device`` (the engine's by
        default) across batches. Rows past the true output replicate the
        last true row (the staged paths' ``np.pad(mode="edge")``): to even
        for the 2x2 chroma box of WebP, to the MCU grid for JPEG; the plain
        kind crops at the true output and replicates nothing."""
        wkey = (key, tuple(sorted(v_keys)), tuple(sorted(h_keys)))
        return self._on_device(wkey, device, functools.partial(
            self._rgb_stacks, key, v_keys, h_keys))

    def _rgb_stacks(self, key: _BucketKey, v_keys, h_keys):
        """:meth:`_rgb_weights`' stacks and tables, on the CPU."""
        bh, bw, obh, obw, _ch, okind = key
        if okind == "yuv":
            def rep_to(to):
                return to + (to & 1)
        elif okind == "jpg":
            def rep_to(to):
                return (to + 15) // 16 * 16
        else:
            def rep_to(to):
                return to
        wv = np.zeros((self.MAX_UNIQUE, obh, bh), dtype=np.float32)
        wh = np.zeros((self.MAX_UNIQUE, obw, bw), dtype=np.float32)
        for (ti, to), u in v_keys.items():
            wv[u] = _cached_weights(ti, to, bh, obh)
            wv[u, to: min(rep_to(to), obh)] = wv[u, to - 1]
        for (ti, to), u in h_keys.items():
            wh[u] = _cached_weights(ti, to, bw, obw)
            wh[u, to: min(rep_to(to), obw)] = wh[u, to - 1]
        stacks = [torch.from_numpy(w_) for w_ in (wv, wh)]
        return (*stacks, resize_tables(*stacks))

