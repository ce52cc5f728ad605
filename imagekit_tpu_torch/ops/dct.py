"""The JPEG heads: split-int8 or int16 coefficients -> resized planes.

Counterpart of ``imagekit_tpu/ops/dct.py:619-666,711-760``. The flagship
head, :func:`decode_resize_yuv_lowfreq_i8_batch`, keeps the reference's
numpy-in / planes-out signature and makes one call of
:func:`imagekit_tpu_torch.ops.jpeg8.folded_planes_i8`: on CUDA one K1
launch for Y, Cb and Cr (widen, escapes, the folded dequant + k-point
IDCT + resize, studio-range remap and u8 pack), on the CPU K1's plain
version. Every ``*_batch`` head runs on the card unless the caller names
another device.

The rgbjpg head, :func:`resample_rgb_jpeg_batch` (``dct.py:961-1032`` and
its Pallas front ``pallas_resize.py:378-411``), serves JPEG outputs from
RGB sources: one K2 launch for the three channels to the rounded u8
grid, then the JFIF BT.601 mix, the 4:2:0 box and the 8x8 fDCT +
quantise tail :func:`_fdct_quant_flat` (``dct.py:776-787``) as torch ops.

The jxc transcode, :func:`transcode_i8_batch` (``dct.py:884-957,1036`` and
its Pallas front ``pallas_jpeg8.py:224-267``), serves JPEG outputs from
JPEG sources in one device round trip: for k < 8 one K1 launch with its
centred epilogue on the three planes; for k = 8 the
split front (:func:`_widen_split_levels`, :func:`_blocks_to_plane`) and a
plain two-``bmm`` resize; then :func:`_fdct_quant_flat`. A JPEG whose
escapes overflow the split transport is demoted to the RGB-output head,
:func:`decode_resize_rgb_batch` (``dct.py:206-268,1717``): 8x8 IDCT of the
int16 levels to u8 planes, then one K3 launch for Y, Cb and Cr
(:func:`_rgb_tail`) and the JFIF YCbCr -> RGB matrix.

The other WebP outputs of JPEG sources. A downscale under 2x keeps every
coefficient (k = 8): :func:`decode_resize_yuv_i8_batch` (``dct.py:1094``,
split-int8 transport) and :func:`decode_resize_yuv_batch` (``dct.py:329``,
int16 transport) run the 8x8 IDCT to the u8 grid, then :func:`_yuv_tail`
(``dct.py:554``): ONE K4 launch resizes Y, Cb and Cr from those u8 planes
to unrounded f32 (K3 would round before the studio-range remap and move
the last bit of about half the pixels), then :func:`_yuv_range_pack`. An
escape-dense image at k < 8 rides block-grouped int16 levels through
:func:`decode_resize_yuv_lowfreq_batch` (``dct.py:669``): one K1 launch of
its int16 entry.

The YUV-source heads serve decoded lossy WebP and AVIF sources, whose
planes are studio range already: :func:`resize_yuv420_batch`
(``dct.py:1436``, WebP and AVIF out: no remap at either end; chroma in
4:2:0, 4:2:2 or 4:4:4, and an AVIF's alpha plane) and
:func:`resize_yuv_jpeg_batch` (``dct.py:1377``, JPEG out: remap to full
range, centre, fDCT). Each is ONE K2 launch for the planes
(:func:`imagekit_tpu_torch.ops.resize_strip.yuv_resize`), read in place
from the flat batch the engine uploads. BT.709 sources (``mix``) take
K2's f32 entry instead
(:func:`imagekit_tpu_torch.ops.resize_strip.yuv_mix_resize`: Y, the
chroma to the half and the full output grid, and the alpha, in one
launch), then the 709 -> 601 mix :func:`_mix_tail` and the rounding as
torch ops, as the reference computes them outside any Pallas kernel.

The single-image entries of the JPEG codec (``codecs/jpeg.py``):
:func:`encode_rgb_to_coefficients` (``dct.py:1793``, ``_encode_kernel``
:1758: the JFIF mix, the 4:2:0 box and :func:`_fdct_quant_flat` on one
image, for requests with no resize and for the plain RGB head's JPEG
outputs) and :func:`decode_components_to_rgb` (``dct.py:1938``: the JPEG
pixel decode, :func:`decode_resize_rgb_batch` with identity luma stacks
and, per axis, the 2x triangle upsample or the identity as chroma stacks,
so ONE K3 launch on CUDA, for 4:2:0, 4:2:2, 4:4:0, 4:4:4 and grayscale
JPEGs; for three components in any other integer sampling (4:1:1, Cb and
Cr sampled differently, ...), :func:`decode_sampled_components`: each
component's own stacks by libjpeg's choice of upsample, ONE K3 launch; for
CMYK and YCCK JPEGs in any integer sampling, which the reference decodes
with Pillow, :func:`decode_four_components`: the same IDCT and each
component's stacks by libjpeg's choice, TWO K3 launches, then libjpeg's and
Pillow's integer colour steps, :func:`~imagekit_tpu_torch.ops.color.
cmyk_to_rgb`).

A JPEG coded as RGB (``hdr.rgb``: an Adobe transform of 0, or the ids
'R', 'G', 'B' with no marker) skips the YCbCr step in the pixel decode.
A lossless JPEG's samples need no IDCT: :func:`decode_lossless_planes`
takes gray and alike-sampled frames as they are, and runs K3 with
replication stacks where the components are sampled differently (one
launch for three components, two for four); four components are CMYK.

The pixel decode of a JPEG-compressed TIFF page, which the reference
decodes with Pillow: :func:`decode_tiff_page` takes the coefficient planes
``codecs/tiff.py`` assembles from the page's strips or tiles, with
block-diagonal chroma stacks (libjpeg upsamples each segment alone), ONE
K3 launch a page (two for four components) and the colour step of the
TIFF photometric. An old-style JPEG page (compression 6) takes
replication stacks for its chroma and libtiff's ``TIFFYCbCrToRGB``, as
Pillow reads it through libtiff's RGBA interface.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.ops import jpeg8
from imagekit_tpu_torch.ops.color import (
    box2,
    cmyk_to_rgb,
    lab_to_rgb,
    orient,
    on_device,
    q8,
    resolve,
    rgb_planes,
    split_yuv,
    tables_on,
    to_host,
)
from imagekit_tpu_torch.ops.resize_planes import (
    resize_planes3,
    resize_planes3_f32,
    resize_planes_u8,
)
from imagekit_tpu_torch.ops.resize_strip import (
    resize_tables,
    rgb_resize,
    yuv_mix_resize,
    yuv_resize,
)
from imagekit_tpu_torch.ops.weights import (
    TRIANGLE_AXES,
    chroma_axis_weights,
    component_stacks,
    idct_basis,
    libtiff_ycbcr_tables,
    quality_tables,
    replication_axis_weights,
    segment_axis_weights,
    upsample_method,
    upsample_weights,
)


def decode_resize_yuv_lowfreq_i8_batch(
    dc_arrays,   # (y_dc, cb_dc, cr_dc) i16 batch arrays
    ac_arrays,   # (y_ac, cb_ac, cr_ac) i8 batch arrays
    escapes,     # ((ey_idx, ey_val), (eb_idx, eb_val), (er_idx, er_val))
    qtabs,
    weights,
    vidx,
    block_dims,
    out_shape,
    k: int,
    bands=None,
    device: Optional[torch.device] = None,
):
    """Run the split-int8 truncated head (``dct.py:711``); returns (Y, Cb,
    Cr) u8 numpy planes of shapes (B, obh, obw) and (B, obh/2, obw/2) x2.

    Inputs are numpy arrays or tensors; they are moved to ``device``, the
    card unless the caller names another. One K1 launch on CUDA, its plain
    version on the CPU. ``bands`` is the four stacks' band tables, or None.
    ``block_dims`` is fixed by the array shapes, as in the reference."""
    del block_dims
    obh, obw = out_shape
    device = resolve(device)
    dcs, acs, escs, qt, stacks, vidx = _split_on_device(
        dc_arrays, ac_arrays, escapes, qtabs, weights, vidx, device)
    if bands is not None:
        bands = tuple(on_device(bands, device))
    flat = jpeg8.folded_planes_i8(dcs, acs, escs, qt, stacks, bands, vidx, k)
    return split_yuv(to_host(flat, device), obh, obw)


def _split_on_device(dc_arrays, ac_arrays, escapes, qtabs, weights, vidx,
                     device):
    """The split-int8 batch as tensors on ``device``: (dcs, acs, escs, qt,
    stacks, vidx)."""
    dcs = tuple(on_device(dc_arrays, device))
    acs = tuple(on_device(ac_arrays, device))
    escs = tuple(tuple(on_device(e, device)) for e in escapes)
    qt, vidx = on_device((qtabs, vidx), device)
    return dcs, acs, escs, qt, tuple(on_device(weights, device)), vidx


def _dot8(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """f32 ``x (..., 8) @ m (8, n)``, summed in one fixed order: four FMA
    lanes (term k into lane k mod 4), then ``(l0 + l1) + (l2 + l3)``, the
    order XLA's CPU dot sums an 8-term contraction in. Each FMA is one f32
    rounding of the float64 ``a * b + acc`` (the product is exact in
    float64). The 8x8 DCTs need it: their inputs are integers, so exact
    ties at the quantiser's and the u8 grid's half steps are common, and a
    tie's side depends on the summation order. With it the levels are the
    JAX package's, and the same on every device."""
    x64, m64 = x.double(), m.double()
    lanes = []
    for lane in range(4):
        acc = (x64[..., lane, None] * m64[lane]).float()
        lanes.append((x64[..., lane + 4, None] * m64[lane + 4]
                      + acc.double()).float())
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _fdct_quant_flat(plane: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, ph, pw) centred samples -> 8x8 fDCT -> quantise, rounding half
    away from zero (the JPEG convention) -> flat (B, ph/8 * pw/8 * 64)
    int16 levels in natural order. The fDCT sums over x, then y, in
    :func:`_dot8`'s order, as the reference's einsum does."""
    A8 = torch.as_tensor(idct_basis(), device=plane.device)
    B, ph, pw = plane.shape
    blocks = plane.reshape(B, ph // 8, 8, pw // 8, 8).permute(0, 1, 3, 2, 4)
    t = _dot8(blocks.transpose(-1, -2), A8.T)  # [y, u] = sum_x b[x, y] A[u, x]
    c = _dot8(t.transpose(-1, -2), A8.T)  # [u, v] = sum_y t[y, u] A[v, y]
    c = c.reshape(B, ph // 8, pw // 8, 64) / q[:, None, None, :]
    lv = torch.sign(c) * torch.floor(torch.abs(c) + 0.5)
    return lv.to(torch.int16).reshape(B, -1)


def rgb_jpeg_head(imgs, wv, wh, vidx, hidx, qt_out, bands=None,
                  resize=rgb_resize):
    """(B, H, W*3) u8 -> flat int16 levels, Y then Cb then Cr, in the
    reference's float order (``dct.py:968-993``)."""
    return _ycc_levels(*rgb_planes(imgs, wv, wh, vidx, hidx, bands, resize),
                       qt_out)


def _ycc_levels(r, g, b, qt_out) -> torch.Tensor:
    """(B, h, w) f32 R, G, B on the u8 grid (h, w multiples of 16) -> JFIF
    BT.601 YCbCr, centred luma, 2x2 box chroma, fDCT + quantise: flat int16
    levels, Y then Cb then Cr (``dct.py:968-993`` and ``:1763-1790``)."""
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = box2(-0.168735892 * r - 0.331264108 * g + 0.5 * b)
    cr = box2(0.5 * r - 0.418687589 * g - 0.081312411 * b)
    return torch.cat([
        _fdct_quant_flat(y, qt_out[:, :64]),
        _fdct_quant_flat(cb, qt_out[:, 64:]),
        _fdct_quant_flat(cr, qt_out[:, 64:]),
    ], dim=1)


def _widen_split_lowfreq(dc, ac, eidx, evals, by: int, bx: int, na: int):
    """Split int8 transport -> (B, by, bx, na+1) i32 levels: widen the AC
    planes, scatter-ADD the escape residuals (padding rows add 0 at
    (0,0,0), so a plain put would overwrite the real level there), prepend
    the int16 DC lane (``dct.py:790``)."""
    B = dc.shape[0]
    a = ac.to(torch.int32)
    i = eidx.long()
    a.index_put_((i[:, 0], i[:, 1], i[:, 2]), evals.to(torch.int32),
                 accumulate=True)
    a = a[:, :, : bx * na].reshape(B, by, bx, na)
    d = dc[:, :, :bx].to(torch.int32)
    return torch.cat([d[..., None], a], dim=-1)


def _widen_split_levels(dc, ac, eidx, evals, by: int, bx: int):
    """k=8 variant, flattened to the (B, by, bx*64) natural-order layout
    :func:`_blocks_to_plane` takes (``dct.py:802``)."""
    lev = _widen_split_lowfreq(dc, ac, eidx, evals, by, bx, 63)
    return lev.reshape(dc.shape[0], by, bx * 64)


def _blocks_to_plane(coef_flat, by: int, bx: int, qtab) -> torch.Tensor:
    """(B, by, bx*64) levels + (B, 64) table -> dequantise -> 8x8 IDCT ->
    +128 -> round half up and clip to the u8 grid, as a host decoder emits
    samples (``dct.py:180``). Returned as u8, the type K3 takes; the
    values are the reference's f32 ones. The IDCT sums over u, then v, in
    :func:`_dot8`'s order, as the reference's einsum does."""
    A = torch.as_tensor(idct_basis(), device=coef_flat.device)
    B = coef_flat.shape[0]
    c = coef_flat.reshape(B, by, bx, 64).float() * qtab[:, None, None, :]
    c = c.reshape(B, by, bx, 8, 8)
    t = _dot8(c.transpose(-1, -2), A)  # [v, x] = sum_u c[u, v] A[u, x]
    p = _dot8(t.transpose(-1, -2), A) + 128.0  # [x, y] = sum_v t[v, x] A[v, y]
    p = p.permute(0, 1, 3, 2, 4).reshape(B, by * 8, bx * 8)
    return torch.clamp(torch.floor(p + 0.5), 0.0, 255.0).to(torch.uint8)


def _rgb_tail(Y, Cb, Cr, wv_y, wh_y, wv_c, wh_c, vidx, bands=None,
              resize=resize_planes3, ycc: bool = True):
    """Resize the three u8 planes with K3 (one launch) and convert BT.601
    full-range YCbCr -> RGB -> flat (B, OH*OW*3) u8 (``dct.py:228``); with
    ``ycc`` False (a JPEG coded as RGB) the planes are R, G and B as they
    are. K3 rounds each resized plane to u8 at every shape, as the
    reference's TPU head did where K3 fits VMEM (the 1080p bucket does);
    its CPU branch skips that rounding. ``bands`` is the (luma, chroma)
    pair of the stacks' tables (:class:`resize_strip.ResizeTables`), or
    None."""
    planes = resize((Y, Cb, Cr), (wv_y, wh_y, wv_c, wh_c), vidx, bands=bands)
    rgb = _ycc_to_rgb(*planes) if ycc else torch.stack(planes, dim=-1)
    return rgb.reshape(rgb.shape[0], -1)


def _ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    """u8 planes of full-range BT.601 YCbCr -> (..., 3) u8 RGB, rounded
    half up and clipped, in the reference's float order (``dct.py:236``)."""
    y = y.float()
    cb = cb.float() - 128.0
    cr = cr.float() - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.floor(rgb + 0.5), 0.0, 255.0).to(torch.uint8)


def decode_resize_rgb(y_flat, cb_flat, cr_flat, qtabs, wv_y, wh_y, wv_c,
                      wh_c, vidx, by_y: int, bx_y: int, by_c: int, bx_c: int,
                      bands=None, resize=resize_planes3,
                      ycc: bool = True) -> torch.Tensor:
    """The RGB-output head on int16 levels (``_decode_resize_kernel``,
    ``dct.py:206``): flat (B, OH*OW*3) u8. ``qtabs`` is (B, 128), the luma
    table and the one Cb and Cr share, as the batched head carries them, or
    (B, 192), Y, Cb and Cr each with its own (the JPEG pixel decode).
    ``ycc`` as :func:`_rgb_tail` takes it."""
    Y = _blocks_to_plane(y_flat, by_y, bx_y, qtabs[:, :64])
    Cb = _blocks_to_plane(cb_flat, by_c, bx_c, qtabs[:, 64:128])
    Cr = _blocks_to_plane(cr_flat, by_c, bx_c, qtabs[:, -64:])
    return _rgb_tail(Y, Cb, Cr, wv_y, wh_y, wv_c, wh_c, vidx, bands, resize,
                     ycc)


def decode_resize_rgb_batch(y_flat, cb_flat, cr_flat, qtabs, weights, vidx,
                            block_dims, out_shape, bands=None,
                            device: Optional[torch.device] = None,
                            ycc: bool = True):
    """Run the RGB-output head (``dct.py:1717``); returns (B, OHb, OWb, 3)
    u8 numpy (crop on the host). One K3 launch on CUDA, K3's plain
    version on the CPU. ``ycc`` False: planes coded as RGB, no colour
    step (the JPEG pixel decode of such a frame)."""
    wv_y, wh_y, wv_c, wh_c = weights
    obh, obw = out_shape
    device = resolve(device)
    args = on_device((y_flat, cb_flat, cr_flat, qtabs, wv_y, wh_y, wv_c,
                      wh_c, vidx), device)
    flat = to_host(decode_resize_rgb(*args, *block_dims,
                                     bands=tables_on(bands, device), ycc=ycc),
                   device)
    return flat.reshape(flat.shape[0], obh, obw, 3)


def transcode_i8(dcs, acs, escs, qt_in, qt_out, stacks, vidx, block_dims,
                 k: int, bands=None,
                 planes=jpeg8.folded_planes_i8) -> torch.Tensor:
    """The jxc transcode: split-int8 levels in -> flat int16 target levels,
    Y then Cb then Cr. k < 8 is ``_transcode_i8_pallas``
    (``pallas_jpeg8.py:224``): ``planes`` (K1 with the centred epilogue,
    one launch for the three planes; its plain version on the CPU), f32.
    k = 8 is ``_transcode_i8_kernel``'s split front (``dct.py:918-936``):
    widen, 8x8 IDCT to the u8 grid, the resize as a plain product,
    ``u8c``."""
    if k == 8:
        u = vidx.long()
        by_b, bx_b, cy_b, cx_b = block_dims

        def front(p, by, bx, qt, wv, wh):
            lv = _widen_split_levels(dcs[p], acs[p], *escs[p], by, bx)
            P = _blocks_to_plane(lv, by, bx, qt)
            x = torch.bmm(torch.bmm(wv[u], P.float()), wh[u].transpose(1, 2))
            # u8c: round to the u8 grid, centre for the fDCT
            return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0) - 128.0

        wv_y, wh_y, wv_c, wh_c = stacks
        y = front(0, by_b, bx_b, qt_in[:, :64], wv_y, wh_y)
        cb = front(1, cy_b, cx_b, qt_in[:, 64:], wv_c, wh_c)
        cr = front(2, cy_b, cx_b, qt_in[:, 64:], wv_c, wh_c)
    else:
        y, cb, cr = (pl.float() for pl in planes(
            dcs, acs, escs, qt_in, stacks, bands, vidx, k, centered=True))
    return torch.cat([
        _fdct_quant_flat(y, qt_out[:, :64]),
        _fdct_quant_flat(cb, qt_out[:, 64:]),
        _fdct_quant_flat(cr, qt_out[:, 64:]),
    ], dim=1)


def transcode_i8_batch(dc_arrays, ac_arrays, escapes, qt_in, qt_out,
                       weights, vidx, block_dims, out_shape, k: int,
                       bands=None, device: Optional[torch.device] = None):
    """Run the jxc transcode (``dct.py:1036``); returns (y, cb, cr) int16
    numpy levels of shapes (B, OHb/8, OWb/8, 64) and (B, OHb/16, OWb/16,
    64) x2, natural order: slice to the true MCU grid and hand them to the
    host Huffman encoder. ``bands`` is the folded stacks' band tables for
    k < 8, or None."""
    obh, obw = out_shape
    device = resolve(device)
    dcs, acs, escs, qt, stacks, vidx = _split_on_device(
        dc_arrays, ac_arrays, escapes, qt_in, weights, vidx, device)
    (qt_out,) = on_device((qt_out,), device)
    if bands is not None:
        bands = tuple(on_device(bands, device))
    flat = transcode_i8(dcs, acs, escs, qt, qt_out, stacks, vidx, block_dims,
                        k, bands)
    return split_yuv(to_host(flat, device), obh, obw, block=8)


def resample_rgb_jpeg_batch(imgs_flat, weights, vidx, hidx, qt_out,
                            out_shape, bands=None,
                            device: Optional[torch.device] = None):
    """Run the rgbjpg head; returns (y, cb, cr) int16 numpy levels of
    shapes (B, OHb/8, OWb/8, 64) and (B, OHb/16, OWb/16, 64) x2, natural
    order, for the host Huffman encoder."""
    wv, wh = weights
    obh, obw = out_shape
    device = resolve(device)
    x, wv, wh, vidx, hidx, qt_out = on_device(
        (imgs_flat, wv, wh, vidx, hidx, qt_out), device)
    flat = to_host(rgb_jpeg_head(x, wv, wh, vidx, hidx, qt_out,
                                 tables_on(bands, device)), device)
    return split_yuv(flat, obh, obw, block=8)


# -- JPEG -> WebP: the k = 8 heads and the int16 transport -------------------


def _yuv_range_pack(y, cb, cr) -> torch.Tensor:
    """Full-range resized f32 planes -> studio-range remap -> packed
    (B, obh*obw + 2*(obh//2*obw//2)) u8, in the reference's float order
    (``dct.py:533``)."""
    y = y * (219.0 / 255.0) + 16.0
    c_off = 128.0 * (1.0 - 224.0 / 255.0)
    cb = cb * (224.0 / 255.0) + c_off
    cr = cr * (224.0 / 255.0) + c_off
    return torch.cat([q8(y), q8(cb), q8(cr)], dim=1)


def _yuv_tail(Y, Cb, Cr, stacks, vidx, bands=None,
              resize=resize_planes3_f32) -> torch.Tensor:
    """Resize the three u8 planes to unrounded f32 (K4, one launch), remap
    to studio range and pack u8 (``dct.py:554``). ``bands`` is the (luma,
    chroma) pair of the stacks' tables, or None."""
    return _yuv_range_pack(*resize((Y, Cb, Cr), stacks, vidx, bands=bands))


def decode_resize_yuv(y_flat, cb_flat, cr_flat, qtabs, stacks, vidx,
                      block_dims, bands=None,
                      resize=resize_planes3_f32) -> torch.Tensor:
    """The k = 8 YUV head on int16 levels (``_decode_resize_yuv_kernel``,
    ``dct.py:300``): flat packed u8 planes."""
    by_y, bx_y, by_c, bx_c = block_dims
    Y = _blocks_to_plane(y_flat, by_y, bx_y, qtabs[:, :64])
    Cb = _blocks_to_plane(cb_flat, by_c, bx_c, qtabs[:, 64:])
    Cr = _blocks_to_plane(cr_flat, by_c, bx_c, qtabs[:, 64:])
    return _yuv_tail(Y, Cb, Cr, stacks, vidx, bands, resize)


def decode_resize_yuv_i8(dcs, acs, escs, qtabs, stacks, vidx, block_dims,
                         bands=None, resize=resize_planes3_f32):
    """The k = 8 YUV head on the split-int8 transport
    (``_decode_resize_i8_kernel(rgb=False)``, ``dct.py:812``): widen, then
    :func:`decode_resize_yuv`."""
    by_y, bx_y, by_c, bx_c = block_dims
    dims = ((by_y, bx_y), (by_c, bx_c), (by_c, bx_c))
    levels = [_widen_split_levels(dcs[p], acs[p], *escs[p], *dims[p])
              for p in range(3)]
    return decode_resize_yuv(*levels, qtabs, stacks, vidx, block_dims, bands,
                             resize)


def decode_resize_yuv_i8_batch(dc_arrays, ac_arrays, escapes, qtabs, weights,
                               vidx, block_dims, out_shape, bands=None,
                               device: Optional[torch.device] = None):
    """Run the k = 8 split-transport YUV head (``dct.py:1094``); returns
    (Y, Cb, Cr) u8 numpy planes of shapes (B, obh, obw) and (B, obh/2,
    obw/2) x2. One K4 launch on CUDA, K4's plain version on the CPU."""
    obh, obw = out_shape
    device = resolve(device)
    dcs, acs, escs, qt, stacks, vidx = _split_on_device(
        dc_arrays, ac_arrays, escapes, qtabs, weights, vidx, device)
    flat = decode_resize_yuv_i8(dcs, acs, escs, qt, stacks, vidx, block_dims,
                                tables_on(bands, device))
    return split_yuv(to_host(flat, device), obh, obw)


def decode_resize_yuv_batch(y_flat, cb_flat, cr_flat, qtabs, weights, vidx,
                            block_dims, out_shape, bands=None,
                            device: Optional[torch.device] = None):
    """Run the k = 8 int16-transport YUV head (``dct.py:329``); returns
    the planes as :func:`decode_resize_yuv_i8_batch`."""
    obh, obw = out_shape
    device = resolve(device)
    y, cb, cr, qt, vidx = on_device((y_flat, cb_flat, cr_flat, qtabs, vidx),
                                    device)
    flat = decode_resize_yuv(y, cb, cr, qt, tuple(on_device(weights, device)),
                             vidx, block_dims, tables_on(bands, device))
    return split_yuv(to_host(flat, device), obh, obw)


def decode_resize_yuv_lowfreq_batch(y_flat, cb_flat, cr_flat, qtabs, weights,
                                    vidx, block_dims, out_shape, k: int,
                                    bands=None,
                                    device: Optional[torch.device] = None):
    """Run the truncated head on the int16 transport (``dct.py:669``):
    (B, by, pad128(bx*k*k)) block-grouped levels per plane -> (Y, Cb, Cr)
    u8 numpy planes. One K1 launch (its int16 entry) on CUDA, its plain
    version on the CPU. ``bands`` is the four folded stacks' band tables,
    or None."""
    del block_dims
    obh, obw = out_shape
    device = resolve(device)
    flats = tuple(on_device((y_flat, cb_flat, cr_flat), device))
    qt, vidx = on_device((qtabs, vidx), device)
    if bands is not None:
        bands = tuple(on_device(bands, device))
    flat = jpeg8.folded_planes_i16(flats, qt,
                                   tuple(on_device(weights, device)), bands,
                                   vidx, k)
    return split_yuv(to_host(flat, device), obh, obw)


# -- the YUV-source heads (decoded lossy WebP and AVIF) ----------------------

#: the BT.709 -> BT.601 cross-plane mix of studio-range planes
#: (``dct.py:1112-1127``: M = A601 @ inv(A709) over the analog YCbCr
#: matrices; the Y row's chroma terms carry the 219/224 excursion ratio)
MIX_709_YU = 0.09931166
MIX_709_YV = 0.19169955
MIX_709_UU = 0.98985381
MIX_709_UV = -0.11065251
MIX_709_VU = -0.07245296
MIX_709_VV = 0.98339782


def yuv_planes(flat: torch.Tensor, bh: int, bw: int, chroma_sub=(2, 2),
               alpha: bool = False):
    """The (B, bh, bw) Y, (B, bh/csy, bw/csx) Cb, Cr and, with ``alpha``,
    (B, bh, bw) alpha views of the engine's flat batch (``dct.py:1176-1184,
    1198-1201``): rows dense, images a padded row of ``flat`` apart, no
    copy."""
    B = flat.shape[0]
    csy, csx = chroma_sub
    ch, cw = bh // csy, bw // csx
    ny, nc = bh * bw, ch * cw
    views = [flat[:, :ny].view(B, bh, bw),
             flat[:, ny:ny + nc].view(B, ch, cw),
             flat[:, ny + nc:ny + 2 * nc].view(B, ch, cw)]
    if alpha:
        views.append(flat[:, ny + 2 * nc:2 * ny + 2 * nc].view(B, bh, bw))
    return tuple(views)


def _mix_tail(ry, cbf, crf, cbh, crh):
    """The 709 -> 601 mix of the unrounded resizes (``_yuv_mix_tail``,
    ``dct.py:1129``): luma from Y and the full-grid chroma, chroma from
    the half-grid chroma. Offsets commute with the resizes because every
    weight row sums to 1."""
    cbf, crf = cbf - 128.0, crf - 128.0
    cbh, crh = cbh - 128.0, crh - 128.0
    y = ry + MIX_709_YU * cbf + MIX_709_YV * crf
    cb = 128.0 + MIX_709_UU * cbh + MIX_709_UV * crh
    cr = 128.0 + MIX_709_VU * cbh + MIX_709_VV * crh
    return y, cb, cr


def resize_yuv420(flat, stacks, vidx, in_shape, bands=None,
                  resize=yuv_resize, chroma_sub=(2, 2), alpha: bool = False,
                  mix: bool = False,
                  mix_resize=yuv_mix_resize) -> torch.Tensor:
    """Studio-range planes in any chroma factors (and an alpha plane) ->
    resized, rounded u8 4:2:0 planes (and alpha), packed flat
    (``_resize_yuv420_kernel`` and its BT.709 twin
    ``_resize_yuv420_mix_kernel``, ``dct.py:1150,1218``; the Pallas front
    ``pallas_resize.py:177,271``). No remap: both ends are studio range.
    With ``mix`` the resizes come unrounded from K2's f32 entry and the
    709 -> 601 mix runs before the rounding."""
    B = flat.shape[0]
    planes = yuv_planes(flat, *in_shape, chroma_sub, alpha)
    if mix:
        r = mix_resize(planes, stacks, vidx, bands=bands)
        out = [q8(p) for p in _mix_tail(*r[:5])] + [q8(p) for p in r[5:]]
    else:
        out = resize(planes, stacks, vidx, bands=bands)
    return torch.cat([p.reshape(B, -1) for p in out], dim=1)


def _u8c(p: torch.Tensor) -> torch.Tensor:
    """The full-range u8 grid hand-off, centred for the fDCT."""
    return torch.clamp(torch.floor(p + 0.5), 0.0, 255.0) - 128.0


def resize_yuv_jpeg(flat, stacks, qt_out, vidx, in_shape, bands=None,
                    resize=yuv_resize, mix: bool = False,
                    mix_resize=yuv_mix_resize) -> torch.Tensor:
    """Studio-range 4:2:0 planes -> resized, remapped to full range,
    rounded and centred (K2's epilogues) -> fDCT + quantise -> flat int16
    levels, Y then Cb then Cr (``_resize_yuv_jpeg_kernel``, ``dct.py:1280``;
    its Pallas front ``pallas_resize.py:319``). With ``mix`` (BT.709
    sources, ``_resize_yuv_jpeg_mix_kernel``, ``dct.py:1334``) the
    resizes come unrounded from K2's f32 entry and the mix and the remap
    run as torch ops."""
    planes = yuv_planes(flat, *in_shape)
    if mix:
        ym, cbm, crm = _mix_tail(*mix_resize(planes, stacks, vidx,
                                             bands=bands))
        y = _u8c((ym - 16.0) * (255.0 / 219.0))
        cb = _u8c((cbm - 128.0) * (255.0 / 224.0) + 128.0)
        cr = _u8c((crm - 128.0) * (255.0 / 224.0) + 128.0)
    else:
        y, cb, cr = (p.float() for p in resize(planes, stacks, vidx,
                                               jpeg=True, bands=bands))
    return torch.cat([
        _fdct_quant_flat(y, qt_out[:, :64]),
        _fdct_quant_flat(cb, qt_out[:, 64:]),
        _fdct_quant_flat(cr, qt_out[:, 64:]),
    ], dim=1)


def resize_yuv420_batch(flat, weights, vidx, in_shape, out_shape,
                        chroma_sub=(2, 2), mix=False, alpha=False,
                        bands=None, device: Optional[torch.device] = None):
    """Run the YUV-domain resize (``dct.py:1436``): ``flat`` is the (B,
    pad128(bh*bw + 2*(bh/csy)*(bw/csx) [+ bh*bw])) u8 batch, Y, Cb, Cr
    [and alpha]; returns (Y, Cb, Cr[, A]) u8 numpy planes at bucket output
    shapes. ``weights`` is (wv_y, wh_y, wv_c, wh_c), plus the full-grid
    chroma stacks (wv_cf, wh_cf) with ``mix``; ``bands`` the matching
    (luma, chroma[, chroma full]) tables or None. One K2 launch on CUDA:
    the u8 entry, or with ``mix`` the f32 one."""
    obh, obw = out_shape
    device = resolve(device)
    flat, vidx = on_device((flat, vidx), device)
    out = resize_yuv420(flat, tuple(on_device(weights[:6 if mix else 4],
                                              device)),
                        vidx, in_shape, tables_on(bands, device),
                        chroma_sub=tuple(chroma_sub), alpha=alpha, mix=mix)
    host = to_host(out, device)
    planes = split_yuv(host[:, :host.shape[1] - (obh * obw if alpha else 0)],
                       obh, obw)
    if alpha:
        return planes + (host[:, -obh * obw:].reshape(-1, obh, obw),)
    return planes


def resize_yuv_jpeg_batch(flat, weights, qt_out, vidx, in_shape, out_shape,
                          mix=False, bands=None,
                          device: Optional[torch.device] = None):
    """Run the YUV -> JPEG head (``dct.py:1377``); returns (y, cb, cr)
    int16 numpy levels of shapes (B, OHb/8, OWb/8, 64) and (B, OHb/16,
    OWb/16, 64) x2 for the host Huffman encoder. 4:2:0 sources only, as the
    reference's. One K2 launch on CUDA (the f32 entry with ``mix``)."""
    obh, obw = out_shape
    device = resolve(device)
    flat, qt_out, vidx = on_device((flat, qt_out, vidx), device)
    out = resize_yuv_jpeg(flat, tuple(on_device(weights[:6 if mix else 4],
                                                device)),
                          qt_out, vidx, in_shape, tables_on(bands, device),
                          mix=mix)
    return split_yuv(to_host(out, device), obh, obw, block=8)


# -- the single-image JPEG codec entries --------------------------------------


def encode_rgb_to_coefficients(
    img: np.ndarray, quality: int, device: Optional[torch.device] = None
) -> Tuple[List[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Colour + subsample + fDCT + quantise of one HWC u8 image on
    ``device`` (the card unless the caller names another): coefficient
    planes [(byY, bxY, 64), (byC, bxC, 64) x2] int16 and the quant tables,
    for ``loader.encode_jpeg``.

    The image is edge-padded to the MCU grid. The reference pads on to its
    bucket, so that one compiled shape serves many sizes, and slices the
    extra blocks off again; blocks are independent, so the levels of the
    true grid are the same, and the port has no per-shape compile to
    bound. So it takes any size, where the reference raises ``ValueError``
    beyond its bucket ladder and its caller hands the image to Pillow."""
    h, w = img.shape[:2]
    ph = (h + 15) // 16 * 16
    pw = (w + 15) // 16 * 16
    qy, qc = quality_tables(quality)
    device = resolve(device)
    padded = np.pad(img[:, :, :3], ((0, ph - h), (0, pw - w), (0, 0)),
                    mode="edge")
    x, qt = on_device((padded, np.concatenate([qy, qc]).astype(np.float32)),
                      device)
    r, g, b = x.float()[None].unbind(-1)
    flat = to_host(_ycc_levels(r, g, b, qt[None]), device)
    yq, cbq, crq = split_yuv(flat, ph, pw, block=8)
    return [yq[0], cbq[0], crq[0]], (qy, qc)


def gray_chroma(luma: np.ndarray) -> np.ndarray:
    """The zero chroma plane a grayscale JPEG decodes with: the type and
    trailing shape of ``luma``'s (by, bx, ...) levels on the 4:2:0 grid of
    its blocks. Zero levels dequantise to 0 under any table, so the chroma
    planes are exactly 128, R = G = B = Y, and the chroma slot may reuse
    the luma's table."""
    by, bx = luma.shape[:2]
    return np.zeros(((by + 1) // 2, (bx + 1) // 2, *luma.shape[2:]),
                    luma.dtype)


def _batched_head_layout(hdr) -> bool:
    """Three components in a layout of the batched RGB head: Cb and Cr
    sampled alike, each 1x or 2x below the luma on each axis."""
    if hdr.ncomp != 3 or (hdr.comp_h[1], hdr.comp_v[1]) != (
            hdr.comp_h[2], hdr.comp_v[2]):
        return False
    return all(f0 in (f1, 2 * f1) for f0, f1 in (
        (hdr.comp_h[0], hdr.comp_h[1]), (hdr.comp_v[0], hdr.comp_v[1])))


def decode_components_to_rgb(decoded, device: Optional[torch.device] = None
                             ) -> np.ndarray:
    """The JPEG pixel decode of one image: entropy output -> IDCT, chroma
    upsample and colour on ``device`` -> (H, W, 3) u8 RGB at full
    resolution. ``decoded`` is the (header, coeff_planes, qtabs) tuple of
    ``jpeg_abi.decode``. Three components whose Cb and Cr share one
    sampling 1x or 2x below the luma's on each axis (4:2:0, 4:2:2, 4:4:0,
    4:4:4), each with its own table, or grayscale, with
    :func:`gray_chroma`'s planes, take the batched RGB head: identity for
    luma and, per axis, libjpeg's triangle 2x upsample or the identity for
    chroma (:func:`~imagekit_tpu_torch.ops.weights.chroma_axis_weights`),
    ONE K3 launch on CUDA. Three components in any other integer sampling
    take :func:`decode_sampled_components` (one K3 launch too); four
    components (CMYK, YCCK) :func:`decode_four_components`. A frame coded
    as RGB (``hdr.rgb``) skips the colour step. Anything else raises
    ValueError."""
    hdr, coeffs, qtabs = decoded
    if hdr.ncomp == 4:
        return decode_four_components(decoded, device=device)
    if hdr.ncomp == 3 and not _batched_head_layout(hdr):
        return decode_sampled_components(decoded, device=device)
    if hdr.ncomp == 1:
        cz = gray_chroma(coeffs[0])
        coeffs, tq = [coeffs[0], cz, cz], (hdr.comp_tq[0],) * 3
    elif hdr.ncomp == 3:
        tq = tuple(hdr.comp_tq[:3])
    else:
        raise ValueError(
            f"{hdr.ncomp} components sampled {tuple(hdr.comp_h)} x "
            f"{tuple(hdr.comp_v)}: not grayscale, three or four components")
    by_y, bx_y = coeffs[0].shape[:2]
    by_c, bx_c = coeffs[1].shape[:2]
    # the stacks: identity for luma, one axis of the upsample each for chroma
    wv_c = chroma_axis_weights(by_y, by_c)[None]
    wh_c = chroma_axis_weights(bx_y, bx_c)[None]
    wv_y = upsample_weights(by_y * 8, by_y * 8)[None]
    wh_y = upsample_weights(bx_y * 8, bx_y * 8)[None]
    # Y, Cb, Cr tables by the SOF selectors: decode_resize_rgb's 192 wide
    qt = np.concatenate([qtabs[t] for t in tq]).astype(np.float32)[None]
    out = decode_resize_rgb_batch(
        coeffs[0].reshape(1, by_y, -1),
        coeffs[1].reshape(1, by_c, -1),
        coeffs[2].reshape(1, by_c, -1),
        qt,
        (wv_y, wh_y, wv_c, wh_c),
        np.zeros(1, np.int32),
        (by_y, bx_y, by_c, bx_c),
        (by_y * 8, bx_y * 8),
        device=device,
        ycc=not hdr.rgb,
    )
    return out[0, :hdr.height, :hdr.width]


def sampled_inputs(decoded, device: torch.device):
    """:func:`plane_inputs` of a JPEG of three or four components in any
    integer sampling: each component's stacks to the grid of the largest
    factors (:func:`~imagekit_tpu_torch.ops.weights.component_stacks`), by
    the method libjpeg picks from the pair of its ratios to those factors
    (:func:`~imagekit_tpu_torch.ops.weights.upsample_method`: the
    identity, a triangle 2x on one or both axes, or replication on both),
    each stopping at the component's real size; the first component is
    upsampled too where its factors are not the largest. A ratio that is
    not an integer raises ValueError."""
    hdr, coeffs, qtabs = decoded
    grids = [c.shape[:2] for c in coeffs]
    full = (max(g[0] for g in grids), max(g[1] for g in grids))
    keys = []
    for c, grid in enumerate(grids):
        h, v = hdr.comp_h[c], hdr.comp_v[c]
        if hdr.hmax % h or hdr.vmax % v:
            raise ValueError(f"component {c} sampled {h}x{v} under "
                             f"{hdr.hmax}x{hdr.vmax}: a fractional ratio")
        method = upsample_method((hdr.hmax // h, hdr.vmax // v),
                                 hdr.comp_width[c])
        keys.append((grid, (hdr.comp_height[c], hdr.comp_width[c]), method))
    return plane_inputs(
        coeffs, np.stack([qtabs[t] for t in hdr.comp_tq]), keys,
        lambda k: component_stacks(full, *k), device)


def decode_sampled_components(decoded, device: Optional[torch.device] = None
                              ) -> np.ndarray:
    """The JPEG pixel decode of three components in a sampling outside the
    batched head's (4:1:1, 4:1:0, a ratio of 3, Cb and Cr sampled
    differently, a luma below the largest factors): each component's IDCT,
    then its own stacks (:func:`sampled_inputs`) to the full grid in ONE
    K3 launch on CUDA, crop, YCbCr -> RGB as the batched head does (none
    for a frame coded as RGB) -> (H, W, 3) u8, on ``device`` (the card
    unless named)."""
    hdr = decoded[0]
    device = resolve(device)
    planes = resize_components(*sampled_inputs(decoded, device))
    h, w = hdr.height, hdr.width
    planes = [p[0, :h, :w] for p in planes]
    return to_host(torch.stack(planes, dim=-1) if hdr.rgb
                   else _ycc_to_rgb(*planes), device)


def plane_inputs(coeffs, qt, keys, stacks_of, device: torch.device):
    """K3's inputs in a pixel decode of independent components, on
    ``device``: component c's u8 plane after dequantisation (table
    ``qt[c]``) and the 8x8 IDCT (:func:`_blocks_to_plane`), (1, by*8,
    bx*8) at its own block grid; its (wv, wh) stacks, ``stacks_of(keys[c])``
    as numpy, and their band tables (components of one key share them,
    made once); the index."""
    grids = [c.shape[:2] for c in coeffs]
    qt, vidx, *levels = on_device(
        (np.asarray(qt, np.float32), np.zeros(1, np.int32),
         *(c.reshape(1, by, -1) for c, (by, _) in zip(coeffs, grids))),
        device)
    planes = [_blocks_to_plane(lv, by, bx, qt[i:i + 1])
              for i, (lv, (by, bx)) in enumerate(zip(levels, grids))]
    return (planes, *_stack_inputs(keys, stacks_of, device), vidx)


def _stack_inputs(keys, stacks_of, device: torch.device):
    """The (wv, wh) stacks ``stacks_of(keys[c])`` of each plane on
    ``device`` and their band tables, made once a key."""
    per_key = {}
    for key in dict.fromkeys(keys):
        wv, wh = on_device(tuple(a[None] for a in stacks_of(key)), device)
        per_key[key] = (wv, wh), resize_tables(wv, wh)
    return [per_key[k][0] for k in keys], [per_key[k][1] for k in keys]


def resize_components(planes, stacks, tabs, vidx):
    """K3 on the planes of a pixel decode, three at a time: one launch for
    one to three components, two for four."""
    out = []
    for i in range(0, len(planes), 3):
        out += resize_planes_u8(planes[i:i + 3], stacks[i:i + 3], vidx,
                                bands=tabs[i:i + 3])
    return out


def four_component_planes(decoded, device: torch.device):
    """The four u8 planes of a CMYK or YCCK JPEG at the full grid, (1,
    by*8, bx*8) each, uncropped: :func:`sampled_inputs` (any integer
    sampling, each component by libjpeg's upsampling), then TWO K3
    launches on CUDA (:func:`resize_components`: C, M and Y, then K)."""
    return resize_components(*sampled_inputs(decoded, device))


def decode_four_components(decoded, device: Optional[torch.device] = None
                           ) -> np.ndarray:
    """The JPEG pixel decode of a CMYK or YCCK JPEG: ``decoded`` is
    ``jpeg_abi.decode4``'s (header, four coefficient planes, qtabs) ->
    :func:`four_component_planes` (two K3 launches on CUDA) -> crop ->
    :func:`~imagekit_tpu_torch.ops.color.cmyk_to_rgb` (YCCK where the Adobe
    transform flag is not 0) -> (H, W, 3) u8 RGB, on ``device`` (the card
    unless named)."""
    hdr = decoded[0]
    device = resolve(device)
    planes = four_component_planes(decoded, device)
    h, w = hdr.height, hdr.width
    rgb = cmyk_to_rgb(*(p[0, :h, :w] for p in planes),
                      ycck=hdr.adobe_transform > 0)
    return to_host(rgb, device)


# -- lossless JPEGs ------------------------------------------------------------


def lossless_inputs(decoded, device: torch.device):
    """K3's inputs in the pixel decode of a lossless JPEG whose components
    are sampled differently: each component's u8 samples, zero-padded to
    the MCU-padded grid a DCT frame of its sampling has (whole blocks of
    8, so the grids' ratios are the sampling's), uploaded as (1, rows,
    columns); replication stacks to the grid of the largest factors
    (:func:`~imagekit_tpu_torch.ops.weights.component_stacks`, "int":
    weight 1 at floor(i / ratio), stopping at the component's real size;
    libjpeg-turbo upsamples a lossless frame by replication, no triangle)
    and their band tables; the index."""
    hdr, samples, _ = decoded
    mcux = -(-hdr.width // (8 * hdr.hmax))
    mcuy = -(-hdr.height // (8 * hdr.vmax))
    full = (mcuy * hdr.vmax, mcux * hdr.hmax)
    keys, padded = [], []
    for c, p in enumerate(samples):
        grid = (mcuy * hdr.comp_v[c], mcux * hdr.comp_h[c])
        a = np.zeros((1, grid[0] * 8, grid[1] * 8), np.uint8)
        a[0, :p.shape[0], :p.shape[1]] = p
        padded.append(a)
        keys.append((grid, p.shape, "int"))
    vidx, *planes = on_device((np.zeros(1, np.int32), *padded), device)
    return (planes, *_stack_inputs(keys, lambda k: component_stacks(full, *k),
                                   device), vidx)


def decode_lossless_planes(decoded, device: Optional[torch.device] = None
                           ) -> np.ndarray:
    """The pixel decode of a lossless JPEG: ``decoded`` is (header, u8
    sample planes, None) of ``codecs/jpeg.py::decode_to_coefficients``, one,
    three or four components, the samples as they are (libjpeg converts no
    colour in lossless mode: gray, R, G and B, or C, M, Y and K) -> (H, W,
    3) u8. Gray, or three components sampled alike, is the samples
    themselves, on the host (no kernel: the RGB head's K2 comes next);
    components sampled differently take :func:`lossless_inputs` and K3 on
    ``device`` (the card unless named), ONE launch for three components and
    TWO for four, exact: replication on u8. Four components are CMYK as
    Pillow reads them (the samples inverted, ``CMYK;I``, then its
    ``cmyk2rgb``: :func:`~imagekit_tpu_torch.ops.color.cmyk_to_rgb`), on
    ``device`` whether they are sampled alike or not."""
    hdr, samples, _ = decoded
    if hdr.ncomp == 1:
        return np.repeat(samples[0][:, :, None], 3, axis=2)
    alike = len(set(zip(hdr.comp_h, hdr.comp_v))) == 1
    if alike and hdr.ncomp == 3:
        return np.stack(samples, axis=-1)
    device = resolve(device)
    h, w = hdr.height, hdr.width
    if alike:
        planes = on_device(tuple(samples), device)
    else:
        planes = [p[0, :h, :w]
                  for p in resize_components(*lossless_inputs(decoded,
                                                              device))]
    return to_host(cmyk_to_rgb(*planes) if hdr.ncomp == 4
                   else torch.stack(planes, dim=-1), device)


# -- JPEG-compressed TIFF pages ----------------------------------------------


def tiff_page_inputs(page, device: torch.device):
    """:func:`plane_inputs` of a JPEG TIFF page (``codecs/tiff.py::
    JpegPage``): component c's coefficient plane assembled from the
    segments; its stacks per axis :func:`~imagekit_tpu_torch.ops.weights.
    segment_axis_weights`, block-diagonal over the segments along the axis
    against component 0's (the largest) grid: the triangle on the axes
    libjpeg's choice for the pair of ratios takes it (:func:`~imagekit_
    tpu_torch.ops.weights.upsample_method`), replication on the others (a
    ratio of 4 on either axis); an old-style page's (one segment)
    :func:`~imagekit_tpu_torch.ops.weights.replication_axis_weights`,
    chroma replicated over each subsampling block."""
    keys = list(zip(page.rows, page.cols))
    if page.ycbcr is not None:
        def stacks_of(k):
            return (replication_axis_weights(sum(page.rows[0]), sum(k[0])),
                    replication_axis_weights(sum(page.cols[0]), sum(k[1])))
    else:
        def stacks_of(k):
            rv = page.rows[0][0] // k[0][0]
            rh = page.cols[0][0] // k[1][0]
            width = -(-min(page.width, page.cols[0][0] * 8) // rh)
            tri = TRIANGLE_AXES.get(upsample_method((rh, rv), width),
                                    (False, False))
            return (segment_axis_weights(page.rows[0], k[0], not tri[0]),
                    segment_axis_weights(page.cols[0], k[1], not tri[1]))
    return plane_inputs(page.coeffs, page.qtabs, keys, stacks_of, device)


def libtiff_ycbcr_to_rgb(y, cb, cr, luma, refbw) -> torch.Tensor:
    """libtiff's ``TIFFYCbCrtoRGB`` on u8 planes -> (..., 3) u8, through
    the integer tables of :func:`~imagekit_tpu_torch.ops.weights.
    libtiff_ycbcr_tables` (YCbCrCoefficients ``luma``,
    ReferenceBlackWhite ``refbw``), on the planes' device."""
    tab = torch.from_numpy(libtiff_ycbcr_tables(tuple(luma), tuple(refbw))
                           .astype(np.int32)).to(y.device)
    y_t, cr_r, cb_b, cr_g, cb_g = tab.unbind(0)
    yv = y_t[y.long()]
    cb, cr = cb.long(), cr.long()
    rgb = torch.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16),
                       yv + cb_b[cb]], dim=-1)
    return rgb.clamp_(0, 255).to(torch.uint8)


def unpremultiply(r, g, b, a) -> torch.Tensor:
    """Pillow's ``RGBa`` -> ``RGBA`` (``unpackRGBa``): each colour times
    255 over the alpha, truncated and clipped to 255; all four 0 where the
    alpha is 0. u8 planes -> (..., 4) u8."""
    a32 = a.int()
    out = [torch.where(a32 > 0, (p.int() * 255) // a32.clamp(min=1),
                       torch.zeros_like(a32)).clamp_(max=255)
           for p in (r, g, b)]
    return torch.stack(out + [a32], dim=-1).to(torch.uint8)


def _tiff_colour(planes, page) -> torch.Tensor:
    """The page's cropped u8 planes -> (H, W, 3 or 4) u8, by the TIFF
    photometric, not by the JPEG stream (libtiff asks libjpeg for colour
    only for YCbCr): an old-style page by libtiff's ``TIFFYCbCrtoRGB``
    (:func:`libtiff_ycbcr_to_rgb`); YCbCr -> RGB as the JPEG pixel decode
    does; CMYK as an 8-bit CMYK TIFF (:func:`~imagekit_tpu_torch.ops.
    color.cmyk_to_rgb` on the inverted planes); gray (R = G = B), with its
    alpha; palette, the ColorMap at each index, with its alpha (PA) or
    without its unspecified sample (PX); RGB with an extra sample as Pillow
    reads it: dropped where
    unspecified (0), un-premultiplied where associated (1,
    :func:`unpremultiply`), kept where unassociated (2)."""
    if page.ycbcr is not None:
        return libtiff_ycbcr_to_rgb(*planes, *page.ycbcr)
    if page.photometric == 6:
        return _ycc_to_rgb(*planes)
    if page.photometric == 5:
        return cmyk_to_rgb(*(255 - p for p in planes))
    if page.photometric == 8:  # CIELab: Pillow's LAB unpacker and convert
        if page.planar:  # Pillow's bands of a planar page: a*, b* unsigned
            planes = planes[:1] + [p ^ 128 for p in planes[1:]]
        return lab_to_rgb(torch.stack(planes, dim=-1))
    if page.photometric == 0:  # WhiteIsZero gray: Pillow's L;I
        planes = [255 - planes[0]] + planes[1:]
    if page.palette is not None:  # Pillow's P: the ColorMap at each sample
        rgb = torch.from_numpy(page.palette).to(planes[0].device)[
            planes[0].long()]
        if page.zero_alpha:  # planar PA: Pillow's alpha of 0
            alpha = torch.zeros_like(planes[0])
        elif len(planes) == 2 and page.extra == 2:  # PA
            alpha = planes[1]
        else:  # P, and PX's unspecified sample dropped
            return rgb
        return torch.cat([rgb, alpha[..., None]], -1)
    if page.zero_alpha:  # planar gray + alpha: Pillow's alpha of 0
        planes = planes[:1] * 3 + [torch.zeros_like(planes[0])]
    elif len(planes) <= 2:  # gray, gray with alpha
        planes = planes[:1] * 3 + planes[1:]
    elif len(planes) == 4 and page.extra == 0:
        planes = planes[:3]
    elif len(planes) == 4 and page.extra == 1:
        return unpremultiply(*planes)
    return torch.stack(planes, dim=-1)


def _tiff_page_pixels(page, device: torch.device) -> torch.Tensor:
    if page.segments:
        # the fallback of an irregular page: each segment on its own
        out = None
        for seg, y0, x0 in page.segments:
            px = _tiff_page_pixels(seg, device)
            if out is None:
                out = torch.empty((page.height, page.width, px.shape[-1]),
                                  dtype=torch.uint8, device=device)
            out[y0:y0 + seg.height, x0:x0 + seg.width] = px
        return out
    if page.samples is not None:  # lossless segments: samples, no IDCT
        return _tiff_colour(list(on_device(tuple(page.samples), device)),
                            page)
    h, w = page.height, page.width
    planes = resize_components(*tiff_page_inputs(page, device))
    return _tiff_colour([p[0, :h, :w] for p in planes], page)


def decode_tiff_page(page, device: Optional[torch.device] = None,
                     orientation: int = 1) -> np.ndarray:
    """The pixel decode of a JPEG-compressed TIFF page on ``device`` (the
    card unless named): ``page`` is ``codecs/tiff.py``'s host entropy
    decode, its segments' coefficient planes assembled into one plane a
    component. IDCT and, per axis, block-diagonal chroma stacks (libjpeg's
    triangle upsample stops at every strip and tile edge), so ONE K3 launch
    a page for one or three components and TWO for four; crop; the colour
    step of the photometric -> (H, W, 3) u8, or (H, W, 4) with alpha. An
    old-style page (``page.ycbcr``) takes replication stacks and libtiff's
    ``TIFFYCbCrToRGB`` instead (one K3 launch); a planar page's components
    are its planes (one launch for three). An irregular page (its
    segments' tables differ, or a strip that is not a whole number of MCUs
    ends before the last) carries its segments
    instead, each decoded alone (K3 once or twice a segment), cropped and
    stitched. Then the page's TIFF ``orientation``, as Pillow applies it
    (:func:`~imagekit_tpu_torch.ops.color.orient`)."""
    device = resolve(device)
    return to_host(orient(_tiff_page_pixels(page, device), orientation),
                   device)


class _YccFrame:
    """The sampling of a YCbCr TIFF page's planes as :func:`lossless_inputs`
    reads a frame's: the luma at (sub_h, sub_v), the chroma at (1, 1)."""

    def __init__(self, width: int, height: int, sub: Tuple[int, int]):
        self.width, self.height = width, height
        self.hmax, self.vmax = sub
        self.comp_h, self.comp_v = (sub[0], 1, 1), (sub[1], 1, 1)


def decode_ycbcr_page(page, device: Optional[torch.device] = None,
                      orientation: int = 1) -> np.ndarray:
    """The pixel decode of a YCbCr TIFF page compressed without JPEG
    (``codecs/tiff.py::YccPage``), as libtiff's RGBA interface reads it, on
    ``device`` (the card unless named): its Cb and Cr replicated over each
    subsampling block by K3 (:func:`lossless_inputs`' replication stacks on
    the block-padded grid, ONE launch for the three planes, exact on u8;
    none where the chroma is at full resolution), then libtiff's
    ``TIFFYCbCrToRGB`` (:func:`libtiff_ycbcr_to_rgb`) and the page's
    ``orientation`` -> (H, W, 3) u8."""
    device = resolve(device)
    h, w = page.y.shape
    if page.sub == (1, 1):
        planes = on_device((page.y, page.cb, page.cr), device)
    else:
        frame = _YccFrame(w, h, page.sub)
        planes = [p[0, :h, :w] for p in resize_components(*lossless_inputs(
            (frame, (page.y, page.cb, page.cr), None), device))]
    rgb = libtiff_ycbcr_to_rgb(*planes, page.luma, page.refbw)
    return to_host(orient(rgb, orientation), device)

