"""K1: the folded jpeg8 plane head, as a hand-written CUDA kernel.

Counterpart of ``imagekit_tpu/ops/pallas_jpeg8.py:81-217``. One call runs
one plane of a batch: i16 DC and planar i16 AC levels (escapes already
added) -> dequantise -> k-point IDCT folded into the resize weights ->
+128 -> studio-range remap -> u8 (or the ``centered`` i8 epilogue of the
JPEG->JPEG transcode front). The kernel is ``csrc/jpeg8_folded.cu``; its
plain PyTorch version, :func:`folded_plane_plain`, sits beside it.

:func:`folded_plane` launches the kernel for CUDA tensors and raises on
anything the kernel does not take. It takes the plain version only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import threading

import torch

from imagekit_tpu_torch.ops.weights import _lowfreq_indices

#: kernel launches made by :func:`folded_plane` (read and reset by callers
#: that must show the main path went through the kernel)
LAUNCHES = 0
_launch_lock = threading.Lock()

_LUMA = (219.0 / 255.0, 16.0)
_CHROMA = (224.0 / 255.0, 128.0 * (1.0 - 224.0 / 255.0))


def _check(dc16, ac16, qt, wv_f, wh_f, vidx, k):
    tensors = {"dc16": dc16, "ac16": ac16, "qt": qt, "wv_f": wv_f,
               "wh_f": wh_f, "vidx": vidx}
    dtypes = {"dc16": torch.int16, "ac16": torch.int16, "qt": torch.float32,
              "wv_f": torch.float32, "wh_f": torch.float32,
              "vidx": torch.int32}
    dev = dc16.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, dc16 on {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k < 2 or k > 7:
        raise ValueError(f"k={k}: the folded head serves 2 <= k < 8")
    B, rows, pw = dc16.shape
    U, kk, O, wrows = wv_f.shape
    U2, kk2, P, nblk = wh_f.shape
    na = k * k - 1
    if kk != k or kk2 != k or U2 != U or wrows != rows:
        raise ValueError(
            f"weight stacks {tuple(wv_f.shape)} / {tuple(wh_f.shape)} do not "
            f"fit k={k}, rows={rows}"
        )
    if ac16.shape[0] != B or ac16.shape[1] != rows or ac16.shape[2] % na:
        raise ValueError(f"ac16 {tuple(ac16.shape)} is not planar for k={k}")
    if nblk > pw or nblk > ac16.shape[2] // na:
        raise ValueError(f"nblk={nblk} exceeds the coefficient planes")
    if tuple(qt.shape) != (B, k * k) or tuple(vidx.shape) != (B,):
        raise ValueError(f"qt {tuple(qt.shape)} / vidx {tuple(vidx.shape)}")
    return B, rows, pw, U, O, P, nblk


def folded_plane(dc16, ac16, qt, wv_f, wh_f, vidx, k: int, luma: bool,
                 centered: bool = False) -> torch.Tensor:
    """dc16 (B, rows, pad128(nblk)) i16, ac16 (B, rows, (k²-1)·pad128(nblk))
    i16 with escapes added, qt (B, k²) f32 dequant scales, wv_f
    (U, k, O, rows) / wh_f (U, k, P, nblk) folded f32 stacks, vidx (B,) i32
    -> (B, O, P) u8 studio-range plane, or i8 centred full-range plane when
    ``centered``."""
    global LAUNCHES
    B, rows, pw, U, O, P, nblk = _check(dc16, ac16, qt, wv_f, wh_f, vidx, k)
    if dc16.device.type == "cpu":
        return folded_plane_plain(dc16, ac16, qt, wv_f, wh_f, vidx, k, luma,
                                  centered)
    if dc16.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dc16.device}")
    from imagekit_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((B, O, P), dtype=torch.int8 if centered else torch.uint8,
                      device=dc16.device)
    with torch.cuda.device(dc16.device):
        stream = torch.cuda.current_stream(dc16.device).cuda_stream
        rc = lib.ik_jpeg8_folded_plane(
            dc16.data_ptr(), ac16.data_ptr(), qt.data_ptr(), wv_f.data_ptr(),
            wh_f.data_ptr(), vidx.data_ptr(), out.data_ptr(),
            B, rows, pw, ac16.shape[2], nblk, O, P, U, k, int(luma),
            int(centered), stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return out


def folded_plane_plain(dc16, ac16, qt, wv_f, wh_f, vidx, k: int, luma: bool,
                       centered: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the reference's float order
    (``pallas_jpeg8.py:89-123``)."""
    nblk = wh_f.shape[3]
    p = ac16.shape[2] // (k * k - 1)
    wv = wv_f[vidx.long()]  # (B, k, O, rows)
    wh = wh_f[vidx.long()]  # (B, k, P, nblk)
    out = None
    for v in range(k):
        Pv = None
        for u in range(k):
            lin = u * k + v
            if lin == 0:
                C = dc16[:, :, :nblk].float()
            else:
                j = lin - 1
                C = ac16[:, :, j * p:j * p + nblk].float()
            C = C * qt[:, lin][:, None, None]
            t = torch.bmm(wv[:, u], C)
            Pv = t if Pv is None else Pv + t
        t2 = torch.bmm(Pv, wh[:, v].transpose(1, 2))
        out = t2 if out is None else out + t2
    if centered:
        return (torch.clamp(torch.floor(out + 128.0 + 0.5), 0.0, 255.0)
                - 128.0).to(torch.int8)
    scale, offset = _LUMA if luma else _CHROMA
    out = (out + 128.0) * scale + offset
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0).to(torch.uint8)


def widen_scatter(ac8: torch.Tensor, eidx: torch.Tensor,
                  evals: torch.Tensor) -> torch.Tensor:
    """i8 planar AC -> i16 with the escape residuals ADDED in place. The
    padding rows all point at (0, 0, 0) with value 0, so the scatter must
    accumulate: a plain put would overwrite the real level there."""
    a = ac8.to(torch.int16)
    i = eidx.long()
    a.index_put_((i[:, 0], i[:, 1], i[:, 2]), evals.to(torch.int16),
                 accumulate=True)
    return a


def qt_lowfreq(qtabs: torch.Tensor, k: int):
    """(B, 128) natural-order tables -> (luma, chroma) (B, k²) dequant
    scales pre-scaled by k/8 (``dct.py:654-656``)."""
    idx = torch.as_tensor(_lowfreq_indices(k), device=qtabs.device).long()
    return (qtabs[:, :64][:, idx] * (k / 8.0),
            qtabs[:, 64:][:, idx] * (k / 8.0))


def decode_resize_i8(y_dc, y_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                     ey_idx, ey_val, eb_idx, eb_val, er_idx, er_val,
                     qtabs, wv_y_f, wh_y_f, wv_c_f, wh_c_f, vidx,
                     k: int) -> torch.Tensor:
    """Counterpart of ``_decode_resize_i8_pallas`` (``pallas_jpeg8.py:180``):
    the i16 widen and escape scatter as torch ops, then K1 once per plane,
    then the packed (B, O·P + 2·Oc·Pc) u8 output."""
    qt_l, qt_c = qt_lowfreq(qtabs, k)
    qt_l, qt_c = qt_l.contiguous(), qt_c.contiguous()
    planes = [
        folded_plane(y_dc, widen_scatter(y_ac, ey_idx, ey_val), qt_l,
                     wv_y_f, wh_y_f, vidx, k, luma=True),
        folded_plane(cb_dc, widen_scatter(cb_ac, eb_idx, eb_val), qt_c,
                     wv_c_f, wh_c_f, vidx, k, luma=False),
        folded_plane(cr_dc, widen_scatter(cr_ac, er_idx, er_val), qt_c,
                     wv_c_f, wh_c_f, vidx, k, luma=False),
    ]
    B = y_dc.shape[0]
    return torch.cat([pl.reshape(B, -1) for pl in planes], dim=1)
