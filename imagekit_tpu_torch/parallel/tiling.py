"""Resampling of images beyond the bucket ladder.

Counterpart of ``imagekit_tpu/parallel/tiling.py::resize_oversized``. On
one device the image is resampled at its exact shape by
:func:`~imagekit_tpu_torch.ops.resize.resize_batch`, whose stacks beyond
the ladder are :func:`~imagekit_tpu_torch.ops.weights.exact_stacks` and
whose device resample is one K2 launch (in column strips where a row is
too wide for a tile of whole rows). On a grid of several devices the
height splits over its ``space`` columns (:func:`~.sharding.
sharded_resample` with ``spatial``): H is padded to a multiple of
``space`` with zero weight columns for the padding rows, each shard
resizes its rows to f32 partials, and the partials are summed on the
first device.

Where no grid is given the split is taken only where it is needed: the
reference splits over up to four of its devices whenever it has several,
but on a card the split (four launches, their partials summed and
rounded) is slower than the one launch on one device (PERF.md §5), so
:func:`split_grid` splits only an image that the first device cannot hold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imagekit_tpu_torch.ops.resize import resize_batch
from imagekit_tpu_torch.ops.weights import load_aligned, resample_weights
from imagekit_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_devices
from imagekit_tpu_torch.parallel.sharding import sharded_resample


def free_bytes(device: torch.device) -> Optional[int]:
    """A card's free memory; None for the CPU, which the port does not
    bound."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def one_device_bytes(shape, out_h: int, out_w: int) -> int:
    """What the one-device resample of an image of ``shape`` (HWC or HW)
    holds on its device: the image with its rows padded to whole loads,
    its exact f32 stacks and its output."""
    h, w = shape[:2]
    c = shape[2] if len(shape) > 2 else 1
    return (h * load_aligned(w) * c + 4 * (out_h * h + out_w * w)
            + out_h * out_w * c)


def split_grid(img: np.ndarray, out_h: int, out_w: int,
               devices) -> Optional[Mesh]:
    """The grid to split the height of ``img`` over where no grid is
    given: ``space = min(n, 4)`` of the n ``devices`` where there are
    several and the one-device resample does not fit the first one's free
    memory; else None (the one-device resample)."""
    devices = list(devices)
    if len(devices) < 2:
        return None
    free = free_bytes(devices[0])
    if free is None or one_device_bytes(img.shape, out_h, out_w) <= free:
        return None
    space = min(len(devices), 4)
    return make_mesh(space, space=space, devices=devices)


def resize_oversized(img: np.ndarray, out_h: int, out_w: int,
                     mesh: Optional[Mesh] = None,
                     filter_name: str = "lanczos3",
                     device: Optional[torch.device] = None) -> np.ndarray:
    """HWC (or HW) u8 -> (out_h, out_w, C) u8 (C = 1 for HW). With ``mesh``
    of several devices the height splits over its ``space`` columns. With
    neither ``mesh`` nor ``device``, the grid is :func:`split_grid`'s over
    the visible cards; with one device (``device``, the card unless the
    caller names another) the one-device resample runs."""
    if img.ndim == 2:
        img = img[:, :, None]
    if mesh is None and device is None:
        mesh = split_grid(img, out_h, out_w, visible_devices())
    if mesh is None or mesh.size <= 1:
        dev = device if mesh is None else mesh.devices[0][0]
        return resize_batch(img[None], out_h, out_w, filter_name,
                            device=dev)[0]
    space = mesh.shape[1]
    h, w = img.shape[:2]
    # pad H so it splits evenly across the space axis; padded rows carry
    # zero weight columns, so they contribute nothing
    hp = (h + space - 1) // space * space
    padded = np.zeros((1, hp, w, img.shape[2]), img.dtype)
    padded[0, :h] = img
    wv = np.zeros((1, out_h, hp), np.float32)
    wv[0, :, :h] = resample_weights(h, out_h, filter_name)
    wh = resample_weights(w, out_w, filter_name)[None]
    out = sharded_resample(padded, wv, wh, mesh, spatial=True)
    return out[0].cpu().numpy()
