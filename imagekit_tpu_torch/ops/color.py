"""The rgbyuv head: RGB-source batches -> resized studio-range YUV 4:2:0.

Counterpart of ``imagekit_tpu/ops/color.py:72-149`` and of its Pallas
front ``imagekit_tpu/ops/pallas_resize.py:229-266``. One K2 launch reads
the interleaved (B, H, W*3) u8 batch in place, once for the three
channels, and rounds each resized channel to u8 (the einsum head's
hand-off point, which both JAX heads share); the studio-range BT.601 mix,
the 2x2 chroma box and the u8 pack follow as torch ops on the small output
grid. On CPU tensors the resize is K2's plain version
(:func:`resize_strip.rgb_resize_plain`).

The single-image conversion of the WebP encode (``color.py:35-69,152-171``)
sits here too: :func:`rgb_to_yuv420` on the device (torch ops, no kernel:
the reference has none either) and its numpy mirror
:func:`rgb_to_yuv420_host`, which :func:`imagekit_tpu_torch.codecs.vp8.
encode_rgb` takes by default, as the reference's does. So does the colour
step of CMYK and YCCK JPEGs (:func:`cmyk_to_rgb`, integer torch ops on the
device), which the reference leaves to libjpeg and Pillow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.device import resolve_device
from imagekit_tpu_torch.ops.resize_strip import ResizeTables, rgb_resize


def rgb_planes(imgs, wv, wh, vidx, hidx, bands=None, resize=rgb_resize):
    """(B, H, W*3) u8 -> the resized R, G and B planes, rounded to u8 and
    widened to f32: one ``resize`` call for the three channels."""
    return resize(imgs, wv, wh, vidx, hidx, bands=bands).float().unbind(1)


def box2(p: torch.Tensor) -> torch.Tensor:
    """2x2 box average of (B, OH, OW) (bucket dims are even)."""
    B, oh, ow = p.shape
    return p.reshape(B, oh // 2, 2, ow // 2, 2).mean(dim=(2, 4))


def q8(p: torch.Tensor) -> torch.Tensor:
    """Round half up, clip and pack to flat (B, -1) u8."""
    return (torch.clamp(torch.floor(p + 0.5), 0.0, 255.0)
            .to(torch.uint8).reshape(p.shape[0], -1))


def rgb_yuv_head(imgs, wv, wh, vidx, hidx, bands=None, resize=rgb_resize):
    """(B, H, W*3) u8 -> flat (B, OH*OW + 2*(OH/2*OW/2)) u8, Y then U then
    V, in the reference's float order (``color.py:93-110``)."""
    y, u, v = _studio_yuv(*rgb_planes(imgs, wv, wh, vidx, hidx, bands, resize))
    return torch.cat([q8(y), q8(box2(u)), q8(box2(v))], dim=1)


def _studio_yuv(r, g, b):
    """BT.601 studio-range mix (libwebp's), in the reference's float order;
    numpy arrays or tensors."""
    y = 0.25678824 * r + 0.50412941 * g + 0.09790588 * b + 16.0
    u = -0.14822290 * r - 0.29099279 * g + 0.43921569 * b + 128.0
    v = 0.43921569 * r - 0.36778831 * g - 0.07142737 * b + 128.0
    return y, u, v


def _even_padded(img: np.ndarray) -> np.ndarray:
    """The RGB channels, edge-padded to even dimensions (libwebp's
    convention)."""
    h, w = img.shape[:2]
    rgb = img[:, :, :3]
    if (h & 1) or (w & 1):
        rgb = np.pad(rgb, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge")
    return rgb


def rgb_to_yuv420(img: np.ndarray, device: Optional[torch.device] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single image HWC u8 RGB -> (Y, U, V) u8 planes at 4:2:0 geometry,
    studio range, converted on ``device`` (the card unless the caller
    names another). Odd dimensions are edge-padded to even."""
    device = resolve(device)
    h, w = img.shape[:2]
    (x,) = on_device((np.ascontiguousarray(_even_padded(img)),), device)
    y, u, v = _studio_yuv(*x.float().unbind(-1))
    ph, pw = y.shape
    flat = torch.cat([q8(p[None]) for p in (y, box2(u[None]), box2(v[None]))],
                     dim=1)
    yq, uq, vq = split_yuv(to_host(flat, device), ph, pw)
    return yq[0, :h, :w], uq[0], vq[0]


def rgb_to_yuv420_host(img: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy mirror of :func:`rgb_to_yuv420` (same math)."""
    h, w = img.shape[:2]
    rgb = _even_padded(img).astype(np.float32)
    ph, pw = rgb.shape[:2]
    y, u, v = _studio_yuv(rgb[..., 0], rgb[..., 1], rgb[..., 2])

    def sub(p):
        q = p.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
        return np.clip(np.floor(q + 0.5), 0, 255).astype(np.uint8)

    yq = np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8)
    return yq[:h, :w], sub(u), sub(v)


def on_device(arrays, device):
    """numpy arrays or tensors -> tensors on ``device``."""
    return [torch.as_tensor(a, device=device) for a in arrays]


def tables_on(bands, device):
    """A head's ``bands`` (:class:`ResizeTables`, or a tuple of them) on
    ``device``; None stays None."""
    if bands is None:
        return None
    if isinstance(bands[0], (tuple, list)):
        return tuple(tables_on(b, device) for b in bands)
    return ResizeTables(*on_device(bands, device))


def resolve(device) -> torch.device:
    """The device a ``*_batch`` head runs on: the card unless the caller
    names another, whatever the type of its inputs (raises without one)."""
    return resolve_device("cuda" if device is None else device)


def to_host(flat: torch.Tensor, device: torch.device):
    """Wait for the head's kernels on this stream, then copy out to numpy."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return flat.cpu().numpy()


def split_yuv(flat, obh: int, obw: int, block: int = 1):
    """Flat (B, Y then U then V) -> the full-size plane and the two
    half-size ones, each (B, h, w); with ``block`` 8, int16 levels
    (B, h/8, w/8, 64) of 8x8 blocks instead."""
    B = flat.shape[0]
    ny = obh * obw
    nc = (obh // 2) * (obw // 2)

    def shaped(p, h, w):
        if block == 1:
            return p.reshape(B, h, w)
        return p.reshape(B, h // block, w // block, block * block)

    return (shaped(flat[:, :ny], obh, obw),
            shaped(flat[:, ny:ny + nc], obh // 2, obw // 2),
            shaped(flat[:, ny + nc:], obh // 2, obw // 2))


def resample_rgb_yuv_batch(imgs_flat, weights, vidx, hidx, out_shape,
                           bands=None, device: Optional[torch.device] = None):
    """Run the rgbyuv head; returns (Y, U, V) u8 numpy planes of shapes
    (B, OHb, OWb) and (B, OHb/2, OWb/2) x2 (cropped by the caller)."""
    wv, wh = weights
    obh, obw = out_shape
    device = resolve(device)
    x, wv, wh, vidx, hidx = on_device((imgs_flat, wv, wh, vidx, hidx), device)
    flat = to_host(rgb_yuv_head(x, wv, wh, vidx, hidx,
                                tables_on(bands, device)), device)
    return split_yuv(flat, obh, obw)


# -- CMYK and YCCK JPEGs -> RGB (the four-component JPEG pixel decode) ---------


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


# libjpeg's YCC -> RGB tables (jdcolor.c ``build_ycc_rgb_table``), 16-bit
# fixed point, indexed by the u8 sample; the green ones keep their scale
_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix16(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix16(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix16(0.71414) * _X
_CB_G = -_fix16(0.34414) * _X + (1 << 15)


def ycck_to_cmyk(y, cb, cr):
    """libjpeg's ``ycck_cmyk_convert`` on int64 tensors: the inverse of
    the YCC -> RGB mix, subtracted from 255 and clipped: (C, M, Y); K
    passes through."""
    def tab(t):
        return torch.as_tensor(t, device=y.device)

    c = 255 - (y + tab(_CR_R)[cr])
    m = 255 - (y + ((tab(_CB_G)[cb] + tab(_CR_G)[cr]) >> 16))
    yy = 255 - (y + tab(_CB_B)[cb])
    return tuple(torch.clamp(p, 0, 255) for p in (c, m, yy))


def cmyk_to_rgb(c, m, y, k, ycck: bool = False) -> torch.Tensor:
    """Four u8 planes as a CMYK or YCCK JPEG stores them -> (H, W, 3) u8
    RGB, as Pillow serves such a JPEG: libjpeg's YCCK -> CMYK first where
    ``ycck``; then the Adobe inversion (Pillow reads four-component JPEGs
    with rawmode ``CMYK;I``) and ``convert("RGB")``'s ``cmyk2rgb``,
    ``nk - MULDIV255(x, nk)`` with ``nk = 255 - k``, in integers."""
    c, m, y, k = (p.to(torch.int64) for p in (c, m, y, k))
    if ycck:
        c, m, y = ycck_to_cmyk(c, m, y)
    nk = k  # 255 - (255 - k): K after the inversion

    def muldiv255(a, b):
        t = a * b + 128
        return ((t >> 8) + t) >> 8

    rgb = torch.stack([nk - muldiv255(255 - p, nk) for p in (c, m, y)], -1)
    return torch.clamp(rgb, 0, 255).to(torch.uint8)
