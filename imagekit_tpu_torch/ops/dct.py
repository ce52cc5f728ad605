"""The flagship JPEG head: split-int8 coefficients -> resized 4:2:0 planes.

Counterpart of ``imagekit_tpu/ops/dct.py:466-551,619-666,711-760``. The
plain PyTorch head :func:`decode_resize_yuv_lowfreq_i8` follows the JAX
einsum head ``_decode_resize_yuv_lowfreq_i8_kernel`` op for op: f32 widen
of the planar AC levels, scatter-add of the escape residuals, the folded
dequant + k-point IDCT + resize contraction, studio-range remap and u8
pack. :func:`decode_resize_yuv_lowfreq_i8_batch` keeps the reference's
numpy-in / planes-out signature and picks the head by device: CUDA tensors
go to K1 (:func:`imagekit_tpu_torch.ops.jpeg8.decode_resize_i8`), CPU
tensors to the plain head.

The rgbjpg head, :func:`resample_rgb_jpeg_batch` (``dct.py:961-1032`` and
its Pallas front ``pallas_resize.py:378-411``), serves JPEG outputs from
RGB sources: K2 once per channel to the rounded u8 grid, then the JFIF
BT.601 mix, the 4:2:0 box and the 8x8 fDCT + quantise tail
:func:`_fdct_quant_flat` (``dct.py:776-787``) as torch ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from imagekit_tpu_torch.ops import jpeg8
from imagekit_tpu_torch.ops.color import (
    box2,
    on_device,
    q8,
    resolve,
    rgb_planes,
    split_yuv,
    to_host,
)
from imagekit_tpu_torch.ops.resize_strip import plane_resize
from imagekit_tpu_torch.ops.weights import idct_basis


def _folded_lowfreq_plane(getC, qt4, wv_f, wh_f, vidx, k):
    """out = sum_{u,v} (Wv@E_u) @ (q_uv * C_uv) @ (Wh@E_v)^T + 128, with
    C_uv = ``getC(u*k+v)`` (B, rows, nblk) and the folded stacks of
    :func:`weights.fold_lowfreq_weights`. The k/8-scale intermediate plane
    is never materialised, and so never clipped (``dct.py:466``)."""
    wv = wv_f[vidx.long()]  # (B, k, O, rows)
    wh = wh_f[vidx.long()]  # (B, k, P, nblk)
    out = None
    for v in range(k):
        Pv = None
        for u in range(k):
            C = getC(u * k + v) * qt4[:, u * k + v][:, None, None]
            t = torch.bmm(wv[:, u], C)
            Pv = t if Pv is None else Pv + t
        t2 = torch.bmm(Pv, wh[:, v].transpose(1, 2))
        out = t2 if out is None else out + t2
    return out + 128.0


def _folded_plane_i8(dc, ac, eidx, evals, nblk, qt4, wv_f, wh_f, vidx, k):
    """Widen the PLANAR i8 AC layout to f32, scatter-ADD the escape
    residuals (padding rows add 0 at (0,0,0)), then one contiguous slice
    per coefficient plane. All values are exact integers in f32."""
    p = ac.shape[2] // (k * k - 1)
    a = ac.float()
    i = eidx.long()
    a.index_put_((i[:, 0], i[:, 1], i[:, 2]), evals.float(), accumulate=True)

    def getC(lin):
        if lin == 0:
            return dc[:, :, :nblk].float()
        j = lin - 1
        return a[:, :, j * p:j * p + nblk]

    return _folded_lowfreq_plane(getC, qt4, wv_f, wh_f, vidx, k)


def _yuv_range_pack(y, cb, cr):
    """Full-range resized planes -> studio-range remap -> packed
    (B, obh*obw + 2*(obh//2*obw//2)) u8."""
    y = y * (219.0 / 255.0) + 16.0
    c_off = 128.0 * (1.0 - 224.0 / 255.0)
    cb = cb * (224.0 / 255.0) + c_off
    cr = cr * (224.0 / 255.0) + c_off
    return torch.cat([q8(y), q8(cb), q8(cr)], dim=1)


def decode_resize_yuv_lowfreq_i8(
    y_dc, y_ac, cb_dc, cb_ac, cr_dc, cr_ac,
    ey_idx, ey_val, eb_idx, eb_val, er_idx, er_val,
    qtabs, wv_y_f, wh_y_f, wv_c_f, wh_c_f, vidx,
    by_b: int, bx_b: int, cy_b: int, cx_b: int, k: int,
) -> torch.Tensor:
    """Plain head with the arguments and flat u8 output of
    ``_decode_resize_yuv_lowfreq_i8_kernel`` (``dct.py:619``)."""
    del by_b, cy_b  # fixed by the array shapes, as in the reference
    qt_l, qt_c = jpeg8.qt_lowfreq(qtabs, k)
    Y = _folded_plane_i8(
        y_dc, y_ac, ey_idx, ey_val, bx_b, qt_l, wv_y_f, wh_y_f, vidx, k
    )
    Cb = _folded_plane_i8(
        cb_dc, cb_ac, eb_idx, eb_val, cx_b, qt_c, wv_c_f, wh_c_f, vidx, k
    )
    Cr = _folded_plane_i8(
        cr_dc, cr_ac, er_idx, er_val, cx_b, qt_c, wv_c_f, wh_c_f, vidx, k
    )
    return _yuv_range_pack(Y, Cb, Cr)


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
    device: Optional[torch.device] = None,
):
    """Run the split-int8 truncated head; returns (Y, Cb, Cr) u8 numpy
    planes of shapes (B, obh, obw) and (B, obh/2, obw/2) x2.

    Inputs are numpy arrays or tensors. They are moved to ``device`` (by
    default the device of the weight stacks; numpy weights mean the CPU).
    On CUDA the head is K1; on the CPU it is the plain head."""
    wv_y, wh_y, wv_c, wh_c = weights
    by_b, bx_b, cy_b, cx_b = block_dims
    obh, obw = out_shape
    (ey_idx, ey_val), (eb_idx, eb_val), (er_idx, er_val) = escapes
    device = resolve(device, wv_y)
    args = on_device((
        dc_arrays[0], ac_arrays[0], dc_arrays[1], ac_arrays[1],
        dc_arrays[2], ac_arrays[2], ey_idx, ey_val, eb_idx, eb_val,
        er_idx, er_val, qtabs, wv_y, wh_y, wv_c, wh_c, vidx,
    ), device)
    if device.type == "cuda":
        flat = jpeg8.decode_resize_i8(*args, k=k)
    elif device.type == "cpu":
        flat = decode_resize_yuv_lowfreq_i8(
            *args, by_b=by_b, bx_b=bx_b, cy_b=cy_b, cx_b=cx_b, k=k
        )
    else:
        raise ValueError(f"no jpeg8 head for device {device}")
    return split_yuv(to_host(flat, device), obh, obw)


def _fdct_quant_flat(plane: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, ph, pw) centred samples -> 8x8 fDCT -> quantise, rounding half
    away from zero (the JPEG convention) -> flat (B, ph/8 * pw/8 * 64)
    int16 levels in natural order."""
    A8 = torch.as_tensor(idct_basis(), device=plane.device)
    B, ph, pw = plane.shape
    blocks = plane.reshape(B, ph // 8, 8, pw // 8, 8).permute(0, 1, 3, 2, 4)
    c = torch.matmul(torch.matmul(A8, blocks), A8.T)  # A @ block @ A^T
    c = c.reshape(B, ph // 8, pw // 8, 64) / q[:, None, None, :]
    lv = torch.sign(c) * torch.floor(torch.abs(c) + 0.5)
    return lv.to(torch.int16).reshape(B, -1)


def rgb_jpeg_head(imgs, wv, wh, vidx, hidx, qt_out, bands=None,
                  resize=plane_resize):
    """(B, H, W*3) u8 -> flat int16 levels, Y then Cb then Cr, in the
    reference's float order (``dct.py:968-993``)."""
    r, g, b = rgb_planes(imgs, wv, wh, vidx, hidx, bands, resize)
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = box2(-0.168735892 * r - 0.331264108 * g + 0.5 * b)
    cr = box2(0.5 * r - 0.418687589 * g - 0.081312411 * b)
    return torch.cat([
        _fdct_quant_flat(y, qt_out[:, :64]),
        _fdct_quant_flat(cb, qt_out[:, 64:]),
        _fdct_quant_flat(cr, qt_out[:, 64:]),
    ], dim=1)


def resample_rgb_jpeg_batch(imgs_flat, weights, vidx, hidx, qt_out,
                            out_shape, bands=None,
                            device: Optional[torch.device] = None):
    """Run the rgbjpg head; returns (y, cb, cr) int16 numpy levels of
    shapes (B, OHb/8, OWb/8, 64) and (B, OHb/16, OWb/16, 64) x2, natural
    order, for the host Huffman encoder."""
    wv, wh = weights
    obh, obw = out_shape
    device = resolve(device, wv)
    x, wv, wh, vidx, hidx, qt_out = on_device(
        (imgs_flat, wv, wh, vidx, hidx, qt_out), device)
    if bands is not None:
        bands = tuple(on_device(bands, device))
    flat = to_host(rgb_jpeg_head(x, wv, wh, vidx, hidx, qt_out, bands),
                   device)
    return split_yuv(flat, obh, obw, block=8)
