"""JPEG coefficient-transport packing (split-int8 escape budgeting).

Counterpart of ``imagekit_tpu/serving/jpeg_transport.py``: the JPEG queue
item, the escape budgets of the split-int8 head, and the scatter-row
layout. The int16 demotion (``_widen_items``) is not ported: a batch over
the escape caps is split in halves instead (``engine_jpeg``).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from imagekit_tpu.config import ImageFormat
from imagekit_tpu_torch.ops.weights import LOWFREQ_ESC_C, LOWFREQ_ESC_Y


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
    # jpeg_abi.decode_lowfreq_i8
    split: tuple
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
