"""JPEG coefficient-transport packing (split-int8 escape budgeting).

Counterpart of ``imagekit_tpu/serving/jpeg_transport.py``: the JPEG queue
item, the escape budgets of the split-int8 head, the scatter-row layout,
and the batch packing of both transports (``engine_jpeg.py:285-358``). The
batch-level int16 widening (``_widen_items``) is not ported: a batch over
the escape caps is split in halves instead (``engine_jpeg``). An ITEM over
the budget rides the int16 transport, as the reference's does: a jxc
request to the RGB head, a WebP request to the int16 YUV heads
(block-grouped k*k levels for k < 8, all 64 for k = 8).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops.weights import LOWFREQ_ESC_C, LOWFREQ_ESC_Y, pad128


class _GrayAs420:
    """Header view presenting a grayscale JPEG as 4:2:0 with synthetic
    (zero) chroma, for the shared batch path."""

    def __init__(self, hdr):
        self._h = hdr
        self.width = hdr.width
        self.height = hdr.height
        self.ncomp = 3
        self.comp_h = (2, 1, 1)
        self.comp_v = (2, 1, 1)
        self.comp_width = (
            hdr.comp_width[0],
            (hdr.comp_width[0] + 1) // 2,
            (hdr.comp_width[0] + 1) // 2,
        )
        self.comp_height = (
            hdr.comp_height[0],
            (hdr.comp_height[0] + 1) // 2,
            (hdr.comp_height[0] + 1) // 2,
        )


@dataclass
class _JpegItem:
    hdr: object
    qtabs: object
    out_h: int
    out_w: int
    fmt: ImageFormat
    quality: int
    future: asyncio.Future
    k: int
    # split int8 transport: (dc_planes, ac_planes, esc) per
    # jpeg_abi.decode_lowfreq_i8; None for an item on the int16 transport
    split: Optional[tuple]
    # int16 transport: the (blocks_h, blocks_w, k*k) level planes of an
    # item over the escape budget per jpeg_abi.decode_lowfreq (k < 8) or
    # jpeg_abi.decode (64 levels); None on the split transport
    coeffs: Optional[List[np.ndarray]] = None
    enqueued: float = field(default_factory=time.perf_counter)


def _esc_comp_counts(esc) -> Tuple[int, int, int]:
    """Escape rows per component of one image's (n, 3) escape array."""
    if len(esc) == 0:
        return 0, 0, 0
    comp = np.asarray(esc)[:, 0]
    return (
        int((comp == 0).sum()),
        int((comp == 1).sum()),
        int((comp == 2).sum()),
    )


def _esc_within_image_budget(esc) -> bool:
    """A single image's escapes must fit the BATCH caps of the split-int8
    head, else no batch containing it could ever ride that head."""
    ny, nb, nr = _esc_comp_counts(esc)
    return ny <= LOWFREQ_ESC_Y and nb <= LOWFREQ_ESC_C and nr <= LOWFREQ_ESC_C


def _esc_within_batch_budget(items) -> bool:
    ny = nb = nr = 0
    for it in items:
        a, b, c = _esc_comp_counts(it.split[2])
        ny, nb, nr = ny + a, nb + b, nr + c
    return ny <= LOWFREQ_ESC_Y and nb <= LOWFREQ_ESC_C and nr <= LOWFREQ_ESC_C


def _esc_batch_rows(esc, img: int, bx: int, cx: int, na: int,
                    pads: tuple = None):
    """Map one image's escape rows (comp, flat_ac_index, residual) to batch
    scatter coordinates (img, block_row, ac_col). Returns
    [(idx (m,3) i32, val (m,) i32)] x 3.

    ``pads`` = (pad128(bx_b), pad128(cx_b)) of the BATCH bucket selects the
    truncated path's PLANAR layout (col = plane * pad + block_col); None
    keeps the full path's block-grouped layout (col = block_col * na +
    plane)."""
    out = []
    esc = np.asarray(esc, np.int64).reshape(-1, 3)
    for c in range(3):
        rows = esc[esc[:, 0] == c]
        bxi = bx if c == 0 else cx
        bi, n = np.divmod(rows[:, 1], na)
        r, b = np.divmod(bi, bxi)
        if pads is not None:
            col = n * (pads[0] if c == 0 else pads[1]) + b
        else:
            col = b * na + n
        idx = np.stack(
            [np.full(len(rows), img, np.int64), r, col], axis=1
        )
        out.append((idx.astype(np.int32), rows[:, 2].astype(np.int32)))
    return out


def _pad_esc(idx_parts, val_parts, cap: int):
    """Concatenate per-image scatter rows and zero-pad to the head's static
    capacity (padding adds 0 at (0, 0, 0) — a no-op)."""
    ei = np.zeros((cap, 3), np.int32)
    ev = np.zeros((cap,), np.int32)
    if idx_parts:
        idx = np.concatenate(idx_parts)
        val = np.concatenate(val_parts)
        ei[: len(idx)] = idx
        ev[: len(val)] = val
    return ei, ev


def _pack_split(items, nb: int, by_b: int, bx_b: int, cy_b: int, cx_b: int,
                k: int, shards: int = 1):
    """Split-int8 batch arrays: ((y, cb, cr) i16 DC, (y, cb, cr) i8 AC,
    [the three padded escape lists of each of ``shards`` equal shards of
    the batch]). The AC layout is PLANAR for k < 8 (one 128-aligned slice
    per coefficient plane) and block-grouped for k = 8
    (``engine_jpeg.py:285-352``). The reference replicates one set of
    escape lists over its mesh and lets GSPMD split the scatter
    (``engine_jpeg.py:470-474``); here each escape goes to the lists of
    the shard that holds its item, the item index rebased to the shard's
    first item, and each shard's lists are padded to the head's caps
    (``_esc_within_batch_budget`` bounds the whole batch first)."""
    na = k * k - 1
    pads = (pad128(bx_b), pad128(cx_b)) if k < 8 else None
    y_dc = np.zeros((nb, by_b, pad128(bx_b)), np.int16)
    cb_dc = np.zeros((nb, cy_b, pad128(cx_b)), np.int16)
    if k < 8:
        y_ac = np.zeros((nb, by_b, na * pads[0]), np.int8)
        cb_ac = np.zeros((nb, cy_b, na * pads[1]), np.int8)
    else:
        y_ac = np.zeros((nb, by_b, pad128(bx_b * na)), np.int8)
        cb_ac = np.zeros((nb, cy_b, pad128(cx_b * na)), np.int8)
    cr_dc = np.zeros_like(cb_dc)
    cr_ac = np.zeros_like(cb_ac)
    m = nb // shards
    esc_idx = [[[], [], []] for _ in range(shards)]
    esc_val = [[[], [], []] for _ in range(shards)]
    for i, it in enumerate(items):
        dc, ac, esc = it.split
        byi, bxi = dc[0].shape
        cyi, cxi = dc[1].shape
        y_dc[i, :byi, :bxi] = dc[0]
        cb_dc[i, :cyi, :cxi] = dc[1]
        cr_dc[i, :cyi, :cxi] = dc[2]
        if k < 8:
            for j in range(na):
                y_ac[i, :byi, j * pads[0]: j * pads[0] + bxi] = ac[0][:, :, j]
                cb_ac[i, :cyi, j * pads[1]: j * pads[1] + cxi] = ac[1][:, :, j]
                cr_ac[i, :cyi, j * pads[1]: j * pads[1] + cxi] = ac[2][:, :, j]
        else:
            y_ac[i, :byi, : bxi * na] = ac[0].reshape(byi, -1)
            cb_ac[i, :cyi, : cxi * na] = ac[1].reshape(cyi, -1)
            cr_ac[i, :cyi, : cxi * na] = ac[2].reshape(cyi, -1)
        if len(esc):
            j = i // m
            for c, (ei, ev) in enumerate(
                _esc_batch_rows(esc, i - j * m, bxi, cxi, na, pads)
            ):
                esc_idx[j][c].append(ei)
                esc_val[j][c].append(ev)
    caps = (LOWFREQ_ESC_Y, LOWFREQ_ESC_C, LOWFREQ_ESC_C)
    escs = [tuple(_pad_esc(idx[c], val[c], caps[c]) for c in range(3))
            for idx, val in zip(esc_idx, esc_val)]
    return (y_dc, cb_dc, cr_dc), (y_ac, cb_ac, cr_ac), escs


def _pack_int16(items, nb: int, by_b: int, bx_b: int, cy_b: int, cx_b: int,
                k: int):
    """int16 batch arrays of items over the escape budget, block-grouped,
    the k*k levels of a block together: (B, by, pad128(bx*k*k)) for k < 8,
    (B, by, bx*64) for k = 8 (``engine_jpeg.py:300-304,353-358``)."""
    nk = k * k
    ym, cm = bx_b * nk, cx_b * nk
    if k < 8:
        ym, cm = pad128(ym), pad128(cm)
    y = np.zeros((nb, by_b, ym), np.int16)
    cb = np.zeros((nb, cy_b, cm), np.int16)
    cr = np.zeros((nb, cy_b, cm), np.int16)
    for i, it in enumerate(items):
        byi, bxi = it.coeffs[0].shape[:2]
        cyi, cxi = it.coeffs[1].shape[:2]
        y[i, :byi, : bxi * nk] = it.coeffs[0].reshape(byi, -1)
        cb[i, :cyi, : cxi * nk] = it.coeffs[1].reshape(cyi, -1)
        cr[i, :cyi, : cxi * nk] = it.coeffs[2].reshape(cyi, -1)
    return y, cb, cr
