"""JPEG-coefficient head: host entropy decode -> the card -> host encode.

Counterpart of ``imagekit_tpu/serving/engine_jpeg.py:39-195,217-612`` for
the kinds the port serves, from a 4:2:0 (or grayscale) JPEG source with a
resize:

- ``"yuv"``, WebP or AVIF output -> studio-range planes -> host VP8 or
  first-party AV1 encode. A truncated decode (k = 2 or 4) is one K1 launch
  on CUDA:
  :func:`imagekit_tpu_torch.ops.dct.decode_resize_yuv_lowfreq_i8_batch` on
  the split-int8 transport, or, for an image whose escapes overflow it,
  :func:`~imagekit_tpu_torch.ops.dct.decode_resize_yuv_lowfreq_batch` on
  block-grouped int16 levels. A downscale under 2x (k = 8) is the 8x8
  IDCT and one K4 launch:
  :func:`~imagekit_tpu_torch.ops.dct.decode_resize_yuv_i8_batch` (split)
  or :func:`~imagekit_tpu_torch.ops.dct.decode_resize_yuv_batch` (int16);
- ``"jxc"``, JPEG output (the JPEG -> JPEG transcode), k = 2, 4 or 8 on the
  split-int8 transport: one call of
  :func:`imagekit_tpu_torch.ops.dct.transcode_i8_batch` (one K1 launch
  with the centred epilogue for k < 8) -> int16 target levels -> host
  Huffman encode;
- ``"rgb"``, a jxc item whose escapes overflow the split transport: it is
  decoded again in full int16 and demoted to the RGB-output head,
  :func:`imagekit_tpu_torch.ops.dct.decode_resize_rgb_batch` (one K3
  launch on CUDA) -> RGB -> host JPEG encode.

The C++ Huffman decoder and the batch layouts are the reference's, and the
weight stacks live on the device (on each device of the engine's grid,
where a batch splits over one: the head then runs once a shard, on the
shard's items, its escape lists split by ``jpeg_transport._pack_split``).
As the reference does, the head turns away (``_NativeUnsupported``) a
source that is neither 4:2:0 with shared
Cb/Cr tables nor grayscale, a CMYK or YCCK JPEG among them (to the JPEG
pixel decode and the batched RGB head), a source or target beyond the
bucket ladder (to the pixel decode and the engine's exact-shape path), and
a source whose entropy decode fails (to the pixel decode, which answers as
the reference's Pillow fallback does).
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops.dct import (
    decode_resize_rgb_batch,
    decode_resize_yuv_batch,
    decode_resize_yuv_i8_batch,
    decode_resize_yuv_lowfreq_batch,
    decode_resize_yuv_lowfreq_i8_batch,
    gray_chroma,
    transcode_i8_batch,
)
from imagekit_tpu_torch.ops.jpeg8 import folded_bands
from imagekit_tpu_torch.ops.resize_strip import resize_tables
from imagekit_tpu_torch.ops.weights import (
    combined_chroma_half_weights,
    combined_chroma_weights,
    fold_lowfreq_weights,
    host_encode_rgb_to_coefficients,
    lowfreq_chroma_half_weights,
    lowfreq_luma_weights,
    quality_tables,
    target_dimensions,
)
from imagekit_tpu_torch.codecs.jpeg import decode_error as _decode_error
from imagekit_tpu_torch.codecs.jpeg import source_header as _source_header
from imagekit_tpu_torch.serving import jpeg_transport as _jt
from imagekit_tpu_torch.serving.batch_types import (
    _cached_weights,
    _NativeUnsupported,
    _settle,
)
from imagekit_tpu_torch.serving.jpeg_transport import (
    _GrayAs420,
    _JpegItem,
    _pack_int16,
    _pack_split,
)
from imagekit_tpu_torch.utils.bucketing import batch_bucket, bucket_for


class JpegPathMixin:
    async def _transform_jpeg_native(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        from imagekit_tpu_torch.codecs.native import jpeg_abi, loader

        # WebP and AVIF outputs both take the studio-range planes
        kind = "jxc" if fmt == ImageFormat.jpeg else "yuv"
        lib = loader.load()
        loop = asyncio.get_running_loop()
        self._ensure_flusher(loop)

        try:
            pre_hdr = _source_header(lib, data)  # header-only, microseconds
        except jpeg_abi.NativeJpegError as e:
            raise _decode_error(e) from e
        if pre_hdr.port_decoder:
            # CMYK and YCCK, baseline frames in several scans (4:2:0 too),
            # arithmetic-coded and lossless frames: only the port's own
            # entropy decoder takes them, and the JPEG heads' entries are
            # the pinned decoder's; the pixel decode and the RGB head (the
            # reference decodes them with Pillow)
            raise _NativeUnsupported()
        if pre_hdr.ncomp != 1 and (
            tuple(pre_hdr.comp_h) != (2, 1, 1)
            or tuple(pre_hdr.comp_v) != (2, 1, 1)
            or pre_hdr.comp_tq[1] != pre_hdr.comp_tq[2]
        ):
            # the heads carry one luma and one chroma table at 4:2:0, as
            # the reference's; the rest takes the pixel decode and the RGB
            # head (the reference finds it out after its entropy decode)
            raise _NativeUnsupported()

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
            # beyond the ladder: the pixel decode and the exact-shape path
            # (the reference finds it out after its entropy decode)
            raise _NativeUnsupported() from None

        def entropy_decode():
            try:
                hdr2, dc, ac, esc, qt, ovf = jpeg_abi.decode_lowfreq_i8(
                    lib, data, k, pre_hdr
                )
                if not ovf and _jt._esc_within_image_budget(esc):
                    return hdr2, None, (dc, ac, esc), qt
                # over the escape budget: the int16 transport
                if k < 8 and kind != "jxc":
                    h3, ck, qt = jpeg_abi.decode_lowfreq(lib, data, k, pre_hdr)
                else:
                    # the transcode is split-only: a demoted jxc item needs
                    # the full int16 decode for the RGB head
                    h3, ck, qt = jpeg_abi.decode(lib, data)
                return h3, ck, None, qt
            except jpeg_abi.NativeJpegError as e:
                # the pixel decode answers it, as libjpeg under Pillow
                # does in the reference (a scan cut short, an EOB run the
                # pinned decoder refuses)
                raise _NativeUnsupported() from e

        hdr, coeffs, split, qtabs = await self._pool_run(
            "entropy_decode", entropy_decode
        )
        if kind == "jxc" and split is None:
            kind, k = "rgb", 8
        if hdr.ncomp == 1:
            # grayscale: zero chroma planes at 4:2:0 geometry
            if split is not None:
                dc, ac, esc = split
                dz, az = gray_chroma(dc[0]), gray_chroma(ac[0])
                split = ([dc[0], dz, dz], [ac[0], az, az], esc)
            else:
                cz = gray_chroma(coeffs[0])
                coeffs = [coeffs[0], cz, cz]
            qtabs = np.stack([qtabs[hdr.comp_tq[0]], qtabs[hdr.comp_tq[0]]])
            hdr = _GrayAs420(hdr)
        else:
            # index the 4x64 table array by the actual SOF selectors
            qtabs = np.stack([qtabs[hdr.comp_tq[0]], qtabs[hdr.comp_tq[1]]])

        out_w, out_h = target_dimensions(hdr.width, hdr.height, w, h)
        by_y, bx_y = (coeffs if split is None else split[0])[0].shape[:2]
        try:
            yb_h, yb_w = bucket_for(by_y * 8), bucket_for(bx_y * 8)
            obh, obw = bucket_for(out_h), bucket_for(out_w)
        except ValueError:
            raise _NativeUnsupported() from None
        if yb_h % 16 or yb_w % 16:
            raise _NativeUnsupported()

        fut: asyncio.Future = loop.create_future()
        item = _JpegItem(
            hdr, qtabs, out_h, out_w, fmt, quality, fut, k=k, split=split,
            coeffs=coeffs,
        )
        # the transport tag keeps split and int16 items in separate queues,
        # so that every flushed batch is homogeneous
        key = (yb_h, yb_w, obh, obw, kind, k, split is not None)
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
        yb_h, yb_w, obh, obw, kind, k, t8 = key
        block_dims = (yb_h // 8, yb_w // 8, yb_h // 16, yb_w // 16)
        try:
            t0 = time.perf_counter()
            if t8 and not _jt._esc_within_batch_budget(items):
                # combined escapes exceed the head's static caps; each item
                # fits alone (enqueue gate), so split until every part fits
                mid = len(items) // 2
                await asyncio.gather(
                    self._flush_jpeg_group(key, items[:mid]),
                    self._flush_jpeg_group(key, items[mid:]),
                )
                return
            nb = batch_bucket(len(items), self.max_batch)
            devices = self._shard_devices(nb)
            if t8:
                # one set of escape lists a shard (jpeg_transport)
                dcs, acs, escs = _pack_split(items, nb, *block_dims, k,
                                             shards=len(devices))
            else:
                planes = _pack_int16(items, nb, *block_dims, k)
            qt = np.zeros((nb, 128), np.float32)
            # transcode batches also carry per-image OUTPUT quant tables
            qto = np.zeros((nb, 128), np.float32) if kind == "jxc" else None
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
                qt[i, :64] = it.qtabs[0]
                qt[i, 64:] = it.qtabs[1]
                if kind == "jxc":
                    qto[i, :64], qto[i, 64:] = quality_tables(it.quality)
                vidx[i] = u_keys[(it.hdr.width, it.hdr.height, it.out_w, it.out_h)]
            trees = {dev: self._jpeg_weights(key, items, u_keys, dev)
                     for dev in set(devices)}
            t1 = time.perf_counter()

            def device_step(put, shard):
                weights, bands = trees[shard.device]
                rows, dev = shard.rows, shard.device
                vi = put(vidx[rows])
                if not t8:
                    args = (*(put(p[rows]) for p in planes), put(qt[rows]),
                            weights, vi, block_dims, (obh, obw))
                    if kind == "yuv" and k < 8:
                        return decode_resize_yuv_lowfreq_batch(
                            *args, k, bands=bands, device=dev, host=shard.host)
                    head = (decode_resize_rgb_batch if kind == "rgb"
                            else decode_resize_yuv_batch)
                    return head(*args, bands=bands, device=dev,
                                host=shard.host)
                split = (
                    tuple(put(a[rows]) for a in dcs),
                    tuple(put(a[rows]) for a in acs),
                    tuple((put(i_), put(v_)) for i_, v_ in escs[shard.index]),
                    put(qt[rows]),
                )
                if kind == "jxc":
                    return transcode_i8_batch(
                        *split, put(qto[rows]), weights, vi, block_dims,
                        (obh, obw), k, bands=bands, device=dev,
                        host=shard.host,
                    )
                if k == 8:
                    return decode_resize_yuv_i8_batch(
                        *split, weights, vi, block_dims, (obh, obw),
                        bands=bands, device=dev, host=shard.host,
                    )
                return decode_resize_yuv_lowfreq_i8_batch(
                    *split, weights, vi, block_dims, (obh, obw), k,
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
            self.metrics.add_stage_time("device_decode_resize", t2 - t1)
            self.metrics.record_batch(len(items))
            finish = {"yuv": self._finish_jpeg_yuv, "jxc": self._finish_jpg,
                      "rgb": self._finish_rgb_jpeg}[kind]
            await asyncio.gather(
                *(finish(out, i, it) for i, it in enumerate(items)))
        except Exception as e:  # noqa: BLE001 - every waiter gets the error
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)

    async def _finish_jpeg_yuv(self, out, i: int, it) -> None:
        """Crop a YUV head's 4:2:0 planes (and its alpha plane, the fourth
        where there is one) and encode them (WebP or AVIF)."""
        yb, cbb, crb = out[:3]
        ch = (it.out_h + 1) // 2
        cw = (it.out_w + 1) // 2
        alpha = out[3][i, : it.out_h, : it.out_w] if len(out) > 3 else None
        await _settle(it, self._encode_yuv(
            yb[i, : it.out_h, : it.out_w], cbb[i, :ch, :cw], crb[i, :ch, :cw],
            it.quality, it.fmt, alpha=alpha,
        ))

    async def _finish_rgb_jpeg(self, out, i: int, it) -> None:
        """Crop the RGB head's output and encode it as JPEG: the reference's
        ``encode_bytes`` JPEG arm (``codecs/__init__.py:204-219``, quality
        clamped to [1, 100]) through ``codecs/jpeg.py:53-63``, with the
        numpy fDCT mirror it uses for cold shapes (``dct.py:1824``)."""
        from imagekit_tpu_torch.codecs.native import loader

        img = np.ascontiguousarray(out[i, : it.out_h, : it.out_w])
        q = int(min(max(it.quality, 1), 100))

        def run():
            planes, qtabs = host_encode_rgb_to_coefficients(img, q)
            return loader.encode_jpeg(planes, qtabs, img.shape[1], img.shape[0])

        await _settle(it, self._pool_run("encode", run))

    def _jpeg_weights(self, key, items, u_keys, device=None):
        """The weight stacks for this set of geometries, kept on ``device``
        (the engine's by default) across batches
        (``engine_jpeg.py:366-452``), with
        their band tables for K1 (k < 8, :func:`jpeg8.folded_bands`), the
        (luma, chroma) :class:`ResizeTables` for the RGB head's K3 and the
        k = 8 YUV head's K4 (band tables and compact ``Wh``), else None:

        - k < 8: (U, k, O, nblk) folded lowfreq stacks;
        - k = 8: full-resolution luma stacks, and chroma to HALF output
          resolution (``"jxc"``, ``"yuv"``) or to FULL output resolution
          (``"rgb"``).

        For ``"jxc"`` the rows past the true output replicate the last true
        row up to the MCU grid (the staged encoder's ``np.pad(mode="edge")``),
        before folding."""
        wkey = (key, self.MAX_UNIQUE, tuple(sorted(u_keys)))
        return self._on_device(wkey, device, functools.partial(
            self._jpeg_stacks, key, items, u_keys))

    def _jpeg_stacks(self, key, items, u_keys):
        """:meth:`_jpeg_weights`' stacks and bands, on the CPU."""
        yb_h, yb_w, obh, obw, kind, k, _t8 = key
        nu = self.MAX_UNIQUE
        chroma_dims = {}
        for it in items:
            ukey = (it.hdr.width, it.hdr.height, it.out_w, it.out_h)
            chroma_dims.setdefault(
                ukey, (it.hdr.comp_height[1], it.hdr.comp_width[1])
            )
        if k < 8:
            ly, lx = yb_h * k // 8, yb_w * k // 8
            dims = ((obh, ly), (obw, lx), (obh // 2, ly // 2),
                    (obw // 2, lx // 2))
        else:
            c_obh = obh if kind == "rgb" else obh // 2
            c_obw = obw if kind == "rgb" else obw // 2
            dims = ((obh, yb_h), (obw, yb_w), (c_obh, yb_h // 2),
                    (c_obw, yb_w // 2))
        wv_y, wh_y, wv_c, wh_c = (np.zeros((nu,) + d, np.float32)
                                  for d in dims)
        for (iw, ih, ow_, oh_), u in u_keys.items():
            c_h, c_w = chroma_dims[(iw, ih, ow_, oh_)]
            if k < 8:
                wv_y[u] = lowfreq_luma_weights(ih, oh_, k, yb_h * k // 8, obh)
                wh_y[u] = lowfreq_luma_weights(iw, ow_, k, yb_w * k // 8, obw)
                wv_c[u] = lowfreq_chroma_half_weights(
                    c_h, ih, oh_, yb_h * k // 16, obh // 2, k
                )
                wh_c[u] = lowfreq_chroma_half_weights(
                    c_w, iw, ow_, yb_w * k // 16, obw // 2, k
                )
                continue
            wv_y[u] = _cached_weights(ih, oh_, yb_h, obh)
            wh_y[u] = _cached_weights(iw, ow_, yb_w, obw)
            if kind == "rgb":
                wv_c[u] = combined_chroma_weights(c_h, ih, oh_, yb_h // 2, obh)
                wh_c[u] = combined_chroma_weights(c_w, iw, ow_, yb_w // 2, obw)
            else:
                wv_c[u] = combined_chroma_half_weights(
                    c_h, ih, oh_, yb_h // 2, obh // 2
                )
                wh_c[u] = combined_chroma_half_weights(
                    c_w, iw, ow_, yb_w // 2, obw // 2
                )
        if kind == "jxc":
            for (iw, ih, ow_, oh_), u in u_keys.items():
                m_h = min((oh_ + 15) // 16 * 16, obh)
                m_w = min((ow_ + 15) // 16 * 16, obw)
                wv_y[u, oh_:m_h] = wv_y[u, oh_ - 1]
                wh_y[u, ow_:m_w] = wh_y[u, ow_ - 1]
                ch_t = (oh_ + 1) // 2
                cw_t = (ow_ + 1) // 2
                wv_c[u, ch_t: m_h // 2] = wv_c[u, ch_t - 1]
                wh_c[u, cw_t: m_w // 2] = wh_c[u, cw_t - 1]
        stacks = [wv_y, wh_y, wv_c, wh_c]
        if k < 8:
            # folding acts on the column axis only, so the replicated
            # OUTPUT rows stay valid
            stacks = [fold_lowfreq_weights(w_, k) for w_ in stacks]
        stacks = tuple(torch.from_numpy(w_) for w_ in stacks)
        if k < 8:
            bands = tuple(folded_bands(s) for s in stacks)
        elif kind in ("rgb", "yuv"):
            bands = tuple(resize_tables(*pair)
                          for pair in (stacks[:2], stacks[2:]))
        else:
            bands = None
        return stacks, bands

    async def _encode_yuv(self, y, cb, cr, q: int, fmt: ImageFormat,
                          alpha=None) -> bytes:
        """WebP or AVIF encode from device-produced studio-range 4:2:0
        planes: only the VP8 or AV1 bitstream runs on the host
        (``imagekit_tpu/serving/engine_yuv.py:488-517``). ``alpha``
        (full-range, luma geometry) feeds the AVIF encoder's alpha arm;
        WebP output never gets one."""
        if fmt == ImageFormat.avif:
            from imagekit_tpu_torch.codecs import avif_encode

            return await self._pool_run(
                "encode", functools.partial(
                    avif_encode.encode_yuv420_studio, y, cb, cr, q,
                    alpha=np.ascontiguousarray(alpha)
                    if alpha is not None else None),
                pool=self._avif_pool,
            )
        from imagekit_tpu_torch.codecs import vp8 as vp8_native

        return await self._pool_run(
            "encode", vp8_native.encode_yuv420, y, cb, cr, q
        )

