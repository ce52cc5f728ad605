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
"""

from __future__ import annotations

from typing import Optional

import torch

from imagekit_tpu_torch.ops import jpeg8


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

    def q8(p):
        B = p.shape[0]
        return (
            torch.clamp(torch.floor(p + 0.5), 0.0, 255.0)
            .to(torch.uint8)
            .reshape(B, -1)
        )

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
    if device is None:
        device = wv_y.device if isinstance(wv_y, torch.Tensor) else "cpu"
    device = torch.device(device)

    def t(x):
        return torch.as_tensor(x, device=device)

    args = [t(x) for x in (
        dc_arrays[0], ac_arrays[0], dc_arrays[1], ac_arrays[1],
        dc_arrays[2], ac_arrays[2], ey_idx, ey_val, eb_idx, eb_val,
        er_idx, er_val, qtabs, wv_y, wh_y, wv_c, wh_c, vidx,
    )]
    if device.type == "cuda":
        flat = jpeg8.decode_resize_i8(*args, k=k)
        torch.cuda.current_stream(device).synchronize()
    elif device.type == "cpu":
        flat = decode_resize_yuv_lowfreq_i8(
            *args, by_b=by_b, bx_b=bx_b, cy_b=cy_b, cx_b=cx_b, k=k
        )
    else:
        raise ValueError(f"no jpeg8 head for device {device}")
    flat = flat.cpu().numpy()
    B = flat.shape[0]
    ny = obh * obw
    nc = (obh // 2) * (obw // 2)
    y = flat[:, :ny].reshape(B, obh, obw)
    cb = flat[:, ny:ny + nc].reshape(B, obh // 2, obw // 2)
    cr = flat[:, ny + nc:].reshape(B, obh // 2, obw // 2)
    return y, cb, cr
