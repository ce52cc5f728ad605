"""JPEG-coefficient head: host entropy decode -> K1 on the card -> VP8.

Counterpart of ``imagekit_tpu/serving/engine_jpeg.py:39-195,217-612`` for
the slice the port serves: a 4:2:0 (or grayscale) JPEG source, a resize,
WebP output, a truncated decode (k = 2 or 4) on the split-int8 transport.
The C++ Huffman decoder keeps each block's k×k low-frequency levels, the
batch arrays are packed exactly as the reference packs them, the folded
weight stacks live on the device, and one call of
:func:`imagekit_tpu_torch.ops.dct.decode_resize_yuv_lowfreq_i8_batch`
(three K1 launches on CUDA) produces the packed studio-range planes that
the host VP8 encoder takes. Every other request raises
:class:`~imagekit_tpu_torch.errors.NotPortedError`.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from imagekit_tpu.config import ImageFormat
from imagekit_tpu.errors import TransformError
from imagekit_tpu.utils.bucketing import batch_bucket, bucket_for
from imagekit_tpu_torch.errors import NotPortedError
from imagekit_tpu_torch.ops.dct import decode_resize_yuv_lowfreq_i8_batch
from imagekit_tpu_torch.ops.weights import (
    LOWFREQ_ESC_C,
    LOWFREQ_ESC_Y,
    fold_lowfreq_weights,
    lowfreq_chroma_half_weights,
    lowfreq_luma_weights,
    pad128,
    target_dimensions,
)
from imagekit_tpu_torch.serving import jpeg_transport as _jt
from imagekit_tpu_torch.serving.batch_types import _settle
from imagekit_tpu_torch.serving.jpeg_transport import (
    _esc_batch_rows,
    _GrayAs420,
    _JpegItem,
    _pad_esc,
)


class JpegPathMixin:
    async def _transform_jpeg_native(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        from imagekit_tpu.codecs.native import jpeg_abi, loader

        if fmt != ImageFormat.webp:
            raise NotPortedError(
                f"JPEG -> {fmt.value} output", "queue 1 item 7"
            )
        lib = loader.load()
        if lib is None:
            raise TransformError("native JPEG codec library unavailable")
        loop = asyncio.get_running_loop()
        self._ensure_flusher(loop)

        try:
            pre_hdr = jpeg_abi.parse(lib, data)  # header-only, microseconds
        except jpeg_abi.NativeJpegError as e:
            raise _decode_error(e) from e

        # Truncated-coefficient path: keep each block's KxK low-frequency
        # coefficients, K chosen from the BUCKET geometry (not true dims),
        # as the reference chooses it.
        pre_out_w, pre_out_h = target_dimensions(
            pre_hdr.width, pre_hdr.height, w, h
        )
        try:
            k = self._choose_k(
                bucket_for(pre_hdr.blocks_h[0] * 8),
                bucket_for(pre_hdr.blocks_w[0] * 8),
                bucket_for(pre_out_h),
                bucket_for(pre_out_w),
            )
        except ValueError:
            raise NotPortedError(
                "an image beyond the bucket ladder", "queue 1 item 11"
            ) from None
        if k == 8:
            raise NotPortedError(
                "a downscale under 2x (the k=8 head)", "queue 1 item 7"
            )

        def entropy_decode():
            try:
                hdr2, dc, ac, esc, qt, ovf = jpeg_abi.decode_lowfreq_i8(
                    lib, data, k, pre_hdr
                )
            except jpeg_abi.NativeJpegError as e:
                raise _decode_error(e) from e
            if ovf or not _jt._esc_within_image_budget(esc):
                raise NotPortedError(
                    "an image over the escape budget (the int16 head)",
                    "queue 1 item 7",
                )
            return hdr2, (dc, ac, esc), qt

        hdr, split, qtabs = await self._pool_run(
            "entropy_decode", entropy_decode
        )
        if hdr.ncomp == 1:
            # grayscale: zero chroma planes at 4:2:0 geometry; zero blocks
            # dequantise to zero under any table, so the chroma slot reuses
            # the luma's table
            dc, ac, esc = split
            by, bx = dc[0].shape
            dz = np.zeros(((by + 1) // 2, (bx + 1) // 2), np.int16)
            az = np.zeros(((by + 1) // 2, (bx + 1) // 2, k * k - 1), np.int8)
            split = ([dc[0], dz, dz], [ac[0], az, az], esc)
            qtabs = np.stack([qtabs[hdr.comp_tq[0]], qtabs[hdr.comp_tq[0]]])
            hdr = _GrayAs420(hdr)
        elif (
            hdr.ncomp != 3
            or tuple(hdr.comp_h) != (2, 1, 1)
            or tuple(hdr.comp_v) != (2, 1, 1)
            or hdr.comp_tq[1] != hdr.comp_tq[2]
        ):
            raise NotPortedError(
                "a JPEG that is not 4:2:0 with shared Cb/Cr tables",
                "queue 1 item 9",
            )
        else:
            # index the 4x64 table array by the actual SOF selectors
            qtabs = np.stack([qtabs[hdr.comp_tq[0]], qtabs[hdr.comp_tq[1]]])

        out_w, out_h = target_dimensions(hdr.width, hdr.height, w, h)
        by_y, bx_y = split[0][0].shape
        try:
            yb_h, yb_w = bucket_for(by_y * 8), bucket_for(bx_y * 8)
            obh, obw = bucket_for(out_h), bucket_for(out_w)
        except ValueError:
            raise NotPortedError(
                "an image beyond the bucket ladder", "queue 1 item 11"
            ) from None
        if yb_h % 16 or yb_w % 16:
            raise NotPortedError(
                "a bucket that is not 16-aligned", "queue 1 item 11"
            )

        fut: asyncio.Future = loop.create_future()
        item = _JpegItem(
            hdr, qtabs, out_h, out_w, fmt, quality, fut, k=k, split=split
        )
        key = (yb_h, yb_w, obh, obw, "yuv", k, True)
        queue = self._jqueues.setdefault(key, [])
        queue.append(item)
        self.metrics.queue_depth = self._total_queued()
        if len(queue) >= self.max_batch:
            self._jqueues[key] = []
            asyncio.ensure_future(self._flush_jpeg(key, queue))
        return await fut

    @staticmethod
    def _choose_k(src_bh: int, src_bw: int, out_bh: int, out_bw: int) -> int:
        """Smallest K in {2, 4, 8} whose K/8-scale intermediate still covers
        the target, on BUCKET dims."""
        for cand in (2, 4):
            if src_bh * cand // 8 >= out_bh and src_bw * cand // 8 >= out_bw:
                return cand
        return 8

    async def _flush_jpeg(self, key, items) -> None:
        groups = self._split_by_geometry(
            items,
            lambda it: (it.hdr.width, it.hdr.height, it.out_w, it.out_h),
            self.MAX_UNIQUE,
        )
        await asyncio.gather(
            *(self._flush_jpeg_group(key, g) for g in groups)
        )

    async def _flush_jpeg_group(self, key, items) -> None:
        loop = asyncio.get_running_loop()
        yb_h, yb_w, obh, obw, _kind, k, _t8 = key
        by_b, bx_b = yb_h // 8, yb_w // 8
        cy_b, cx_b = yb_h // 16, yb_w // 16
        na = k * k - 1
        try:
            t0 = time.perf_counter()
            if not _jt._esc_within_batch_budget(items):
                # combined escapes exceed the head's static caps; each item
                # fits alone (enqueue gate), so split until every part fits
                mid = len(items) // 2
                await asyncio.gather(
                    self._flush_jpeg_group(key, items[:mid]),
                    self._flush_jpeg_group(key, items[mid:]),
                )
                return
            nb = batch_bucket(len(items), self.max_batch)
            # split transport, PLANAR AC layout (weights.lowfreq_ac_width):
            # one 128-aligned slice per coefficient plane
            pads = (pad128(bx_b), pad128(cx_b))
            y_dc = np.zeros((nb, by_b, pads[0]), np.int16)
            cb_dc = np.zeros((nb, cy_b, pads[1]), np.int16)
            y_ac = np.zeros((nb, by_b, na * pads[0]), np.int8)
            cb_ac = np.zeros((nb, cy_b, na * pads[1]), np.int8)
            cr_dc = np.zeros_like(cb_dc)
            cr_ac = np.zeros_like(cb_ac)
            esc_idx: list = [[], [], []]
            esc_val: list = [[], [], []]
            qt = np.zeros((nb, 128), np.float32)
            # canonical (sorted) unique-geometry indexing: groups holding the
            # same SET of geometries share one device-resident weight stack
            u_keys: Dict[Tuple[int, int, int, int], int] = {
                g: i
                for i, g in enumerate(
                    sorted(
                        {
                            (it.hdr.width, it.hdr.height, it.out_w, it.out_h)
                            for it in items
                        }
                    )
                )
            }
            vidx = np.zeros(nb, np.int32)
            for i, it in enumerate(items):
                dc, ac, esc = it.split
                byi, bxi = dc[0].shape
                cyi, cxi = dc[1].shape
                y_dc[i, :byi, :bxi] = dc[0]
                cb_dc[i, :cyi, :cxi] = dc[1]
                cr_dc[i, :cyi, :cxi] = dc[2]
                for j in range(na):
                    y_ac[i, :byi, j * pads[0] : j * pads[0] + bxi] = ac[0][:, :, j]
                    cb_ac[i, :cyi, j * pads[1] : j * pads[1] + cxi] = ac[1][:, :, j]
                    cr_ac[i, :cyi, j * pads[1] : j * pads[1] + cxi] = ac[2][:, :, j]
                if len(esc):
                    for c, (ei, ev) in enumerate(
                        _esc_batch_rows(esc, i, bxi, cxi, na, pads)
                    ):
                        esc_idx[c].append(ei)
                        esc_val[c].append(ev)
                qt[i, :64] = it.qtabs[0]
                qt[i, 64:] = it.qtabs[1]
                vidx[i] = u_keys[(it.hdr.width, it.hdr.height, it.out_w, it.out_h)]
            weights = self._folded_weights(key, items, u_keys)
            ey = _pad_esc(esc_idx[0], esc_val[0], LOWFREQ_ESC_Y)
            eb = _pad_esc(esc_idx[1], esc_val[1], LOWFREQ_ESC_C)
            er = _pad_esc(esc_idx[2], esc_val[2], LOWFREQ_ESC_C)
            t1 = time.perf_counter()

            def device_step():
                with self._placement() as put:
                    return decode_resize_yuv_lowfreq_i8_batch(
                        (put(y_dc), put(cb_dc), put(cr_dc)),
                        (put(y_ac), put(cb_ac), put(cr_ac)),
                        tuple((put(i_), put(v_)) for i_, v_ in (ey, eb, er)),
                        put(qt),
                        weights,
                        put(vidx),
                        (by_b, bx_b, cy_b, cx_b),
                        (obh, obw),
                        k,
                        device=self.device,
                    )

            self._inflight += 1
            try:
                yb, cbb, crb = await loop.run_in_executor(
                    self._device_pool, device_step
                )
            finally:
                self._inflight -= 1
            t2 = time.perf_counter()
            self.metrics.add_stage_time("batch_build", t1 - t0)
            self.metrics.add_stage_time("device_decode_resize", t2 - t1)
            self.metrics.record_batch(len(items))

            async def finish(i: int, it) -> None:
                ch = (it.out_h + 1) // 2
                cw = (it.out_w + 1) // 2
                await _settle(it, self._encode_yuv(
                    yb[i, : it.out_h, : it.out_w],
                    cbb[i, :ch, :cw],
                    crb[i, :ch, :cw],
                    it.quality,
                ))

            await asyncio.gather(*(finish(i, it) for i, it in enumerate(items)))
        except Exception as e:  # noqa: BLE001 - every waiter gets the error
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)

    def _folded_weights(self, key, items, u_keys):
        """The (U, k, O, nblk) folded weight stacks for this set of
        geometries, kept on the engine's device across batches."""
        yb_h, yb_w, obh, obw, _kind, k, _t8 = key
        nu = self.MAX_UNIQUE
        wkey = (key, nu, tuple(sorted(u_keys)))
        cached = self._dweights.get(wkey)
        if cached is not None:
            return cached
        chroma_dims = {}
        for it in items:
            ukey = (it.hdr.width, it.hdr.height, it.out_w, it.out_h)
            chroma_dims.setdefault(
                ukey, (it.hdr.comp_height[1], it.hdr.comp_width[1])
            )
        ly, lx = yb_h * k // 8, yb_w * k // 8
        wv_y = np.zeros((nu, obh, ly), np.float32)
        wh_y = np.zeros((nu, obw, lx), np.float32)
        wv_c = np.zeros((nu, obh // 2, ly // 2), np.float32)
        wh_c = np.zeros((nu, obw // 2, lx // 2), np.float32)
        for (iw, ih, ow_, oh_), u in u_keys.items():
            c_h, c_w = chroma_dims[(iw, ih, ow_, oh_)]
            wv_y[u] = lowfreq_luma_weights(ih, oh_, k, yb_h * k // 8, obh)
            wh_y[u] = lowfreq_luma_weights(iw, ow_, k, yb_w * k // 8, obw)
            wv_c[u] = lowfreq_chroma_half_weights(
                c_h, ih, oh_, yb_h * k // 16, obh // 2, k
            )
            wh_c[u] = lowfreq_chroma_half_weights(
                c_w, iw, ow_, yb_w * k // 16, obw // 2, k
            )
        cached = tuple(
            torch.from_numpy(fold_lowfreq_weights(w_, k)).to(self.device)
            for w_ in (wv_y, wh_y, wv_c, wh_c)
        )
        self._dweights.put(wkey, cached)
        return cached

    async def _encode_yuv(self, y, cb, cr, q: int) -> bytes:
        """WebP encode from device-produced studio-range 4:2:0 planes:
        only the VP8 bitstream runs on the host."""
        from imagekit_tpu.codecs import vp8 as vp8_native

        return await self._pool_run(
            "encode", vp8_native.encode_yuv420, y, cb, cr, q
        )


def _decode_error(e) -> Exception:
    """Native decoder failure -> the port's error: an unsupported coding
    (progressive, arithmetic, 12-bit) is a path not ported yet; anything
    else is a bad source (400, as the reference's decode would give)."""
    if getattr(e, "code", None) == -3:
        return NotPortedError(
            f"a JPEG the native decoder does not take ({e})", "queue 1 item 10"
        )
    return TransformError(f"JPEG decode failed: {e}")
