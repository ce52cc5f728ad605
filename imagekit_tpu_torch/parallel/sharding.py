"""Batches split over a device grid: counterpart of
``imagekit_tpu/parallel/sharding.py``.

Data parallelism: the batch axis of the images and of their per-image
stacks splits over the grid's rows (``data``); each piece is one K2 launch
on its device, and nothing crosses devices but the gather of the results.

Spatial parallelism: the image-height axis splits over the grid's columns
(``space``). The vertical pass is a contraction over H, so each column
resizes its own rows with its slice of ``Wv`` through K2's f32 entry
(:func:`~imagekit_tpu_torch.ops.resize_strip.planes_resize_f32`, the
channels as planes, unrounded), and the partial products are summed: the
reference's psum over ``space``, here torch ops in f32 on the grid's first
device in shard order, then clipped to [0, 255] and rounded as
``_sharded_resample_impl`` rounds, ``floor(x + 0.5)``. Output rows whose
Lanczos support lies wholly in another shard have an empty band in a
shard's slice: their partial is exactly 0, so a shard computes only the
run of output rows that have a tap in its rows (:func:`row_spans`), and
the compact table of ``Wh``, which every shard of a row shares, is built
once.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from imagekit_tpu_torch.ops.resize import resample_flat
from imagekit_tpu_torch.ops.resize_strip import (
    BAND_PLANES,
    ResizeTables,
    band_table,
    compact_table,
    planes_resize_f32,
)
from imagekit_tpu_torch.ops.weights import load_aligned
from imagekit_tpu_torch.parallel.mesh import Mesh, get_mesh


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard_batch(arr, mesh: Mesh, *, spatial: bool = False
                ) -> List[List[torch.Tensor]]:
    """The pieces of an NHWC batch (or of a (B, out, in) per-image weight
    stack) on the grid: ``pieces[r][c]`` lies on ``mesh.devices[r][c]``,
    contiguous. The batch axis splits over the ``data`` rows; with
    ``spatial`` H (a stack's ``in`` axis) splits over the ``space``
    columns, else every column of a row holds the row's whole piece."""
    x = _tensor(arr)
    d, s = mesh.shape
    if x.shape[0] % d:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{d} data rows")
    m = x.shape[0] // d
    axis = {4: 1, 3: 2}.get(x.dim()) if spatial else None
    if axis is not None and x.shape[axis] % s:
        raise ValueError(f"{x.shape[axis]} rows do not split over {s} "
                         f"space columns")
    pieces = []
    for r, row in enumerate(mesh.devices):
        part = x[r * m:(r + 1) * m]
        if axis is None:
            pieces.append([part.to(dev).contiguous() for dev in row])
            continue
        n = x.shape[axis] // s
        pieces.append([part.narrow(axis, c * n, n).to(dev).contiguous()
                       for c, dev in enumerate(row)])
    return pieces


def _round_u8(acc: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 255], then round half up, as the reference's
    ``jnp.floor(jnp.clip(x, 0, 255) + 0.5)`` (not ``torch.round``, which
    rounds half to even)."""
    return torch.floor(torch.clamp(acc, 0.0, 255.0) + 0.5).to(torch.uint8)


def row_spans(wv: np.ndarray, space: int) -> list:
    """For each of ``space`` height shards of a (B, OH, H) stack, the
    output rows ``(r0, r1)`` that have a tap in the shard's rows for some
    image ((0, 0) for none): the rest of its partial is exactly 0. A
    Lanczos row's taps are one run, so these rows are too."""
    n = wv.shape[2] // space
    spans = []
    for c in range(space):
        taps = wv[:, :, c * n:(c + 1) * n] != 0
        hit = np.flatnonzero(taps.any(axis=(0, 2)))
        spans.append((int(hit[0]), int(hit[-1]) + 1) if hit.size else (0, 0))
    return spans


def shard_partials(x: torch.Tensor, wv: torch.Tensor, wh: torch.Tensor,
                   bands=None) -> torch.Tensor:
    """One shard's rows: (m, hs, W, C) u8 and its (m, R, hs) rows of the
    Wv slice -> (C, m, R, OW) f32 partial products, the channels as
    planes, up to :data:`BAND_PLANES` a launch (``bands``: the stacks'
    :class:`ResizeTables`, built here where not given)."""
    m = x.shape[0]
    planes = list(x.permute(3, 0, 1, 2).contiguous().unbind(0))
    vidx = torch.arange(m, dtype=torch.int32, device=x.device)
    out = []
    for i in range(0, len(planes), BAND_PLANES):
        out += planes_resize_f32(planes[i:i + BAND_PLANES], wv, wh, vidx,
                                 bands=bands)
    return torch.stack(out)


def sharded_resample(
    imgs,
    wv,
    wh,
    mesh: Optional[Mesh] = None,
    *,
    spatial: bool = False,
) -> torch.Tensor:
    """Resample a bucket-shaped (B, H, W, C) u8 batch with per-image
    (B, OH, H) and (B, OW, W) f32 stacks across the grid: (B, OH, OW, C)
    u8 on the grid's first device.

    Without ``spatial`` each data row's images are one K2 launch on the
    row's first device (the per-image stacks as unique stacks, ``vidx =
    arange``); C is 1, 3 or 4. With ``spatial`` H also splits over the
    ``space`` columns (batches of oversized images), one f32 launch a
    shard, and the partials are summed on the first device. The rows are
    padded to whole 8-byte loads with zero weight columns, which carry
    nothing."""
    if mesh is None:
        mesh = get_mesh()
    x = np.asarray(imgs)
    wv = np.asarray(wv, np.float32)
    wh = np.asarray(wh, np.float32)
    B, H, W, C = x.shape
    wp = load_aligned(W)
    if wp != W:
        x = np.pad(x, ((0, 0), (0, 0), (0, wp - W), (0, 0)))
        wh = np.pad(wh, ((0, 0), (0, 0), (0, wp - W)))
    return resample_pieces(shard_batch(x, mesh, spatial=spatial),
                           shard_batch(wv, mesh, spatial=spatial),
                           shard_batch(wh, mesh), mesh.devices[0][0],
                           row_spans(wv, mesh.shape[1]) if spatial else None)


def resample_pieces(xs, wvs, whs, first: torch.device,
                    spans: Optional[list] = None) -> torch.Tensor:
    """:func:`sharded_resample` on pieces already placed by
    :func:`shard_batch` (images with their rows padded to whole loads, the
    stacks' columns with them): (B, OH, OW, C) u8 on ``first``. With
    ``spans`` (:func:`row_spans`) the pieces are height shards."""
    rows = []
    if spans is None:
        for xr, wvr, whr in zip(xs, wvs, whs):
            m, H, W, C = xr[0].shape
            vidx = torch.arange(m, dtype=torch.int32, device=xr[0].device)
            flat = resample_flat(xr[0].reshape(m, H, W * C), wvr[0], whr[0],
                                 vidx, vidx, C)
            rows.append(flat.reshape(m, wvr[0].shape[1], whr[0].shape[1], C))
        return torch.cat([o.to(first) for o in rows])
    for xr, wvr, whr in zip(xs, wvs, whs):
        start_h, taps_h = compact_table(whr[0])
        # every shard of the row is launched before any partial is summed
        parts = []
        for x, wv, wh, (r0, r1) in zip(xr, wvr, whr, spans):
            if r1 == r0:
                continue
            wv = wv[:, r0:r1].contiguous()
            tabs = ResizeTables(band_table(wv), start_h.to(x.device),
                                taps_h.to(x.device))
            parts.append((r0, r1, shard_partials(x, wv, wh, tabs)))
        m, OW, C = xr[0].shape[0], whr[0].shape[1], xr[0].shape[3]
        acc = torch.zeros((C, m, wvr[0].shape[1], OW), dtype=torch.float32,
                          device=first)
        for r0, r1, p in parts:
            acc[:, :, r0:r1] += p.to(first)
        rows.append(_round_u8(acc).permute(1, 2, 3, 0))
    return torch.cat(rows).contiguous()
