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

from pathlib import Path
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


def to_host(flat: torch.Tensor, device: torch.device, host: bool = True):
    """Wait for the head's kernels on this stream, then copy out to numpy.
    With ``host`` False, ``flat`` itself: the heads take ``host`` for a
    caller that reads their results back itself, and whose heads' tails
    (slices and reshapes) then give device views
    (``serving/batcher.py::_run_shards`` launches every shard of a batch
    before it reads any back)."""
    if not host:
        return flat
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
                           bands=None, device: Optional[torch.device] = None,
                           host: bool = True):
    """Run the rgbyuv head; returns (Y, U, V) u8 numpy planes of shapes
    (B, OHb, OWb) and (B, OHb/2, OWb/2) x2 (cropped by the caller); with
    ``host`` False, device views (:func:`to_host`)."""
    wv, wh = weights
    obh, obw = out_shape
    device = resolve(device)
    x, wv, wh, vidx, hidx = on_device((imgs_flat, wv, wh, vidx, hidx), device)
    flat = to_host(rgb_yuv_head(x, wv, wh, vidx, hidx,
                                tables_on(bands, device)), device, host)
    return split_yuv(flat, obh, obw)


# -- CMYK -> RGB, as Pillow converts it ---------------------------------------


def cmyk_to_rgb(c, m, y, k) -> torch.Tensor:
    """Four u8 planes as libjpeg hands a CMYK JPEG to Pillow (a YCCK one
    after its ``ycck_cmyk_convert``, K6's colour step) -> (H, W, 3) u8 RGB,
    as Pillow serves it: the Adobe inversion (Pillow reads four-component
    JPEGs with rawmode ``CMYK;I``) and ``convert("RGB")``'s ``cmyk2rgb``,
    ``nk - MULDIV255(x, nk)`` with ``nk = 255 - k``, in integers."""
    c, m, y, k = (p.to(torch.int64) for p in (c, m, y, k))
    nk = k  # 255 - (255 - k): K after the inversion

    def muldiv255(a, b):
        t = a * b + 128
        return ((t >> 8) + t) >> 8

    rgb = torch.stack([nk - muldiv255(255 - p, nk) for p in (c, m, y)], -1)
    return torch.clamp(rgb, 0, 255).to(torch.uint8)


# -- CIELab, as Pillow converts it ---------------------------------------------

#: Pillow's LAB -> RGB lattice, littleCMS's optimised transform from its
#: built-in Lab profile to its built-in sRGB one: (33, 33, 33, 3) u16 nodes
#: (``tests/fixtures/make_lab_clut.py`` writes it)
_LAB_CLUT = Path(__file__).with_name("lab_srgb_clut.npy")
_LAB_GRID = 33
_lab_nodes = {}


def _lab_table(device: torch.device) -> torch.Tensor:
    """The lattice as (33^3, 3) int64 on ``device``, loaded once a
    device."""
    key = str(device)
    if key not in _lab_nodes:
        nodes = np.load(_LAB_CLUT).reshape(-1, 3).astype(np.int64)
        _lab_nodes[key] = torch.from_numpy(nodes).to(device)
    return _lab_nodes[key]


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 CIELab as a chunky TIFF stores it (L, then a* and b* as
    signed bytes) -> (..., 3) u8 RGB, as Pillow serves such a page: its
    ``LAB`` unpacker (a* and b* plus 128), then ``convert("RGB")``, which
    littleCMS computes as 16-bit words (each byte times 257) interpolated
    tetrahedrally in the lattice (``TetrahedralInterp16``: the corner, then
    the three steps along the axes in order of their fractions, in 16.16
    fixed point), each word then rounded to a byte (``FROM_16_TO_8``).
    Integer torch ops on ``lab``'s device; exact. Where fractions tie, the
    order of their steps does not change the sum (the terms telescope)."""
    nodes = _lab_table(lab.device)
    v = lab.to(torch.int64)
    v = torch.stack([v[..., 0], v[..., 1] ^ 128, v[..., 2] ^ 128], -1) * 257
    f = v * (_LAB_GRID - 1)
    f = f + (f + 0x7FFF) // 0xFFFF            # _cmsToFixedDomain
    base, rest = f >> 16, f & 0xFFFF
    strides = torch.tensor([_LAB_GRID * _LAB_GRID, _LAB_GRID, 1],
                           device=lab.device)
    # a node a step along each axis (none at the lattice's far edge)
    step = strides * (v != 0xFFFF)
    corner = (base * strides).sum(-1)
    hi, first = rest.max(-1)
    lo, last = rest.min(-1)
    mid = rest.sum(-1) - hi - lo
    v1 = corner + step.gather(-1, first[..., None])[..., 0]
    v3 = corner + step.sum(-1)
    v2 = v3 - step.gather(-1, last[..., None])[..., 0]
    c0, c1, c2, c3 = (nodes[i] for i in (corner, v1, v2, v3))
    total = ((c1 - c0) * hi[..., None] + (c2 - c1) * mid[..., None]
             + (c3 - c2) * lo[..., None] + 0x8001)
    out = (c0 + ((total + (total >> 16)) >> 16)) & 0xFFFF
    return ((out * 65281 + 8388608) >> 24).to(torch.uint8)


# -- the TIFF Orientation tag -------------------------------------------------------

#: Orientation -> (the axes to reverse, then whether to swap rows and
#: columns): Pillow's transpose of each value (2 mirrors, 3 turns 180
#: degrees, 4 flips, 5 transposes, 6 turns 90 degrees clockwise, 7
#: transverses, 8 turns 90 degrees anticlockwise); any other value is none
_ORIENT = {2: ((1,), False), 3: ((0, 1), False), 4: ((0,), False),
           5: ((), True), 6: ((0,), True), 7: ((0, 1), True),
           8: ((1,), True)}


def oriented_size(width: int, height: int, orientation: int):
    """(width, height) of an image after :func:`orient`."""
    swap = _ORIENT.get(orientation, ((), False))[1]
    return (height, width) if swap else (width, height)


def orient(img, orientation: int):
    """An (H, W, C) image, numpy or torch, as Pillow serves a TIFF page of
    that Orientation; contiguous."""
    flips, swap = _ORIENT.get(orientation, ((), False))
    if isinstance(img, torch.Tensor):
        if flips:
            img = img.flip(flips)
        return (img.transpose(0, 1) if swap else img).contiguous()
    if flips:
        img = np.flip(img, flips)
    return np.ascontiguousarray(img.transpose(1, 0, 2) if swap else img)
