"""The plain RGB head and the single-image resize.

Counterpart of ``imagekit_tpu/ops/resize.py:217-393``. The reference runs
these as two fp32 XLA einsums and a rounding pass; here every device
resample is one K2 launch (:mod:`.resize_strip`), whose body is the same
``(Wv @ f32(x)) @ Wh^T``, ``floor(v + 0.5)``, clip to [0, 255]:

- :func:`resample_bucketed_flat`, the batched plain head
  (``_resample_flat_kernel`` :328): a flat (B, H, W*C) u8 batch of decoded
  pixels, with per-image weights picked from deduplicated stacks, to
  (B, OH*OW*C) u8, pixels interleaved. Pixels of four channels (sources
  with alpha) take :func:`resize_strip.rgba_resize`, which stores them
  interleaved; pixels of three take :func:`resize_strip.rgb_resize` and are
  interleaved again on the device; single-channel planes take
  :func:`resize_strip.plane_resize`.
- :func:`resize_batch` and :func:`resize_image_array` (``:234``, ``:252``):
  any shape in, as the reference's. K2 reads rows in whole 8-byte loads, so
  inside the bucket ladder the images are padded into their bucket and the
  true geometry lives in :func:`weights.padded_weights` stacks, as in the
  engine, and the bucket output is cropped; beyond it (a source or target
  side past the ladder's top) the rows are padded to whole loads only and
  the stacks are :func:`weights.exact_stacks`, whose wide rows K2 takes in
  column strips.
- :func:`resample_reference` (``:381``), the numpy golden model.

The entries run on the card unless the caller names another device; on
CPU tensors the K2 wrappers take their plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imagekit_tpu_torch.ops.color import on_device, resolve, tables_on, to_host
from imagekit_tpu_torch.ops.resize_strip import (
    plane_resize,
    rgb_resize,
    rgba_resize,
)
from imagekit_tpu_torch.ops.weights import (
    exact_stacks,
    padded_weights,
    resample_weights,
    target_dimensions,
)
from imagekit_tpu_torch.utils.bucketing import bucket_for


def resample_flat(imgs, wv, wh, vidx, hidx, channels: int = 3, bands=None,
                  resize=None) -> torch.Tensor:
    """(B, H, W*C) u8 tensor -> (B, OH*OW*C) u8, pixels interleaved: one
    K2 launch on CUDA. ``resize`` replaces the K2 entry of this channel
    count (a plain version, where a caller compares the two)."""
    entries = {1: plane_resize, 3: rgb_resize, 4: rgba_resize}
    if channels not in entries:
        raise ValueError(f"pixels of {channels} channels: K2 takes 1, 3 or 4")
    out = (resize or entries[channels])(imgs, wv, wh, vidx, hidx, bands=bands)
    if channels == 3:  # planes -> pixels, on the device
        out = out.permute(0, 2, 3, 1)
    return out.reshape(out.shape[0], -1)


def resample_bucketed_flat(imgs_flat, wv_unique, wh_unique, vidx, hidx,
                           channels: int = 3, bands=None,
                           device: Optional[torch.device] = None,
                           host: bool = True) -> np.ndarray:
    """Run the plain head; returns (B, OHb*OWb*C) u8 numpy, one contiguous
    readback (reshape and crop on the host), or with ``host`` False the
    device tensor (:func:`~.color.to_host`). Inputs are numpy arrays or
    tensors; they are moved to ``device``, the card unless the caller names
    another."""
    device = resolve(device)
    x, wv, wh, vidx, hidx = on_device(
        (imgs_flat, wv_unique, wh_unique, vidx, hidx), device)
    flat = resample_flat(x, wv, wh, vidx, hidx, channels,
                         tables_on(bands, device))
    return to_host(flat.contiguous(), device, host)


def resize_batch(imgs, out_h: int, out_w: int, filter_name: str = "lanczos3",
                 device: Optional[torch.device] = None) -> np.ndarray:
    """Resample a batch of NHWC u8 images of one shape to (out_h, out_w):
    (B, out_h, out_w, C) u8 numpy."""
    imgs = np.asarray(imgs)
    B, h, w, ch = imgs.shape
    try:
        bh, bw = bucket_for(h), bucket_for(w)
        obh, obw = bucket_for(out_h), bucket_for(out_w)
        wv = padded_weights(h, out_h, bh, obh, filter_name)[None]
        wh = padded_weights(w, out_w, bw, obw, filter_name)[None]
    except ValueError:  # beyond the ladder: the exact shape
        wv, wh = exact_stacks(h, w, out_h, out_w, filter_name)
        (_, obh, bh), (_, obw, bw) = wv.shape, wh.shape
    batch = np.zeros((B, bh, bw * ch), np.uint8)
    batch[:, :h, : w * ch] = imgs.reshape(B, h, w * ch)
    idx = np.zeros(B, np.int32)
    flat = resample_bucketed_flat(batch, wv, wh, idx, idx, ch, device=device)
    return np.ascontiguousarray(
        flat.reshape(B, obh, obw, ch)[:, :out_h, :out_w])


def resize_image_array(img: np.ndarray, w: Optional[int], h: Optional[int],
                       filter_name: str = "lanczos3",
                       device: Optional[torch.device] = None) -> np.ndarray:
    """Single image with the full reference semantics
    (``src/transform.rs:62-90``): no-op when both dims are None, aspect
    math + fit-within otherwise. HWC (or HW) uint8 in and out."""
    if w is None and h is None:
        return img
    oh, ow = img.shape[0], img.shape[1]
    tw, th = target_dimensions(ow, oh, w, h)
    if (tw, th) == (ow, oh) and filter_name == "nearest":
        return img
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    out = resize_batch(img[None], th, tw, filter_name, device=device)[0]
    return out[:, :, 0] if squeeze else out


def resample_reference(img: np.ndarray, out_h: int, out_w: int,
                       filter_name: str = "lanczos3") -> np.ndarray:
    """Pure-numpy golden model (vertical pass then horizontal pass with an
    f32 intermediate, clamp + round at the end)."""
    x = img.astype(np.float32)
    wv = resample_weights(x.shape[0], out_h, filter_name)
    x = np.einsum("oh,hwc->owc", wv, x)
    wh = resample_weights(img.shape[1], out_w, filter_name)
    x = np.einsum("pw,owc->opc", wh, x)
    x = np.clip(x, 0.0, 255.0)
    return np.floor(x + 0.5).astype(np.uint8)
