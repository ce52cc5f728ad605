"""K3 and K4: the two-pass resize of contiguous planes, as hand-written CUDA
kernels.

Counterpart of ``imagekit_tpu/ops/pallas/resize_kernel.py``: K3
(``_resize_plane_kernel`` :48, launched by ``pallas_resize_u8`` :124) and
K4 (``_resize_plane_kernel_f32`` :169, launched by
``resize_planes_f32_pallas`` :209). Per image b, with ONE index
``u = vidx[b]`` for both axes:

    acc = Wv[u] @ f32(P[b]) @ Wh[u]^T

K3 takes u8 planes and stores ``floor(clip(acc, 0, 255) + 0.5)`` as u8;
K4 stores ``acc`` as f32, from f32 planes or straight from u8 planes (the
k=8 JPEG -> WebP head hands it the u8 planes its 8x8 IDCT rounds to: the
same sums as on their f32 copies, which are never made). All are
instantiations of the body K2 uses too (``csrc/resize_band.cuh``), entered
from ``csrc/resize_planes.cu``; their plain PyTorch versions sit beside them.
The stacks are banded like K2's, and the kernels take the same
:class:`resize_strip.ResizeTables`.

Entries: :func:`resize_planes3` (K3) and :func:`resize_planes3_f32` (K4,
f32 or u8 planes in) resize the three planes of a JPEG head, Y and the
two chroma planes with their own stacks, in one launch;
:func:`resize_planes_u8` (K3) one to three planes, each with its own
stacks (the four-component JPEG pixel decode). Each launches its
kernel for CUDA tensors and raises on anything it does not take; it takes
the plain version only for tensors that lie on the CPU. The reference pads H and W
to 128 for Mosaic; the zero rows and columns add nothing, so no padding
is made here.
"""

from __future__ import annotations

import threading

import torch

from imagekit_tpu_torch.ops import _build
from imagekit_tpu_torch.ops.resize_strip import (
    check_args,
    check_rows,
    on_device_with_kernel,
    plane_record,
    tables,
)

#: kernel launches made by K3 (:func:`resize_planes3`) and K4
#: (:func:`resize_planes3_f32`), read and reset by callers that must show
#: the main path went through the kernel
LAUNCHES = 0
LAUNCHES_F32 = 0
#: launches of either that took the body's column strips
LAUNCHES_STRIPS = 0
_launch_lock = threading.Lock()


def _check(planes, wv, wh, vidx, tabs, dtype):
    if planes.dtype != dtype or planes.dim() != 3:
        raise TypeError(f"planes must be a (B, H, W) {dtype} stack, got "
                        f"{planes.dtype} {tuple(planes.shape)}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    if wv.dim() == 3 and wh.dim() == 3 and wv.shape[0] != wh.shape[0]:
        raise ValueError(f"weight stacks {tuple(wv.shape)} / {tuple(wh.shape)} "
                         f"do not fit the planes with one index")
    # the stacks, the index and the tables are K2's arguments
    check_args(planes.device, planes.shape, wv, wh, vidx, vidx, tabs)


def _three(kernel: str, fn_name: str, plain, dtype, planes, stacks, vidx,
           bands, out_dtype=None):
    """:func:`_launch` on a JPEG head's (Y, Cb, Cr): Y with the luma
    stacks ``stacks[:2]`` and ``bands[0]``, Cb and Cr with the chroma ones."""
    wv_y, wh_y, wv_c, wh_c = stacks
    luma_b, chroma_b = bands if bands is not None else (None, None)
    return _launch(kernel, fn_name, plain, dtype, planes,
                   [(wv_y, wh_y), (wv_c, wh_c), (wv_c, wh_c)], vidx,
                   [luma_b, chroma_b, chroma_b], out_dtype)


def _launch(kernel: str, fn_name: str, plain, dtype, planes, stacks, vidx,
            bands, out_dtype=None):
    """Check, then launch ``fn_name`` once for the one to three planes
    (CUDA tensors), plane i with ``stacks[i]`` (wv, wh) and ``bands[i]``,
    or take ``plain`` plane by plane (CPU tensors). The outputs have
    ``out_dtype`` (the planes' ``dtype`` when None)."""
    out_dtype = out_dtype or dtype
    planes = list(planes)
    for p in planes:
        on_device_with_kernel(p, kernel)
    tabs = [tables(wv, wh, b) for (wv, wh), b in zip(stacks, bands)]
    for p, (wv, wh), t in zip(planes, stacks, tabs):
        _check(p, wv, wh, vidx, t, dtype)
    if planes[0].device.type == "cpu":
        return tuple(plain(p, wv, wh, vidx)
                     for p, (wv, wh) in zip(planes, stacks))
    cpt = 8 if dtype == torch.uint8 else 4
    recs, outs = [], []
    for p, (wv, wh), t in zip(planes, stacks, tabs):
        B, h, w = p.shape
        check_rows(p.data_ptr(), h * w, w, w, 4 * t.taps_h.shape[1], w, cpt,
                   p.element_size())
        oh, ow = wv.shape[1], wh.shape[1]
        out = torch.empty((B, oh, ow), device=p.device, dtype=out_dtype)
        recs.append(plane_record(p.data_ptr(), h * w, w, 1, wv, t, vidx,
                                 vidx, out, oh * ow, 0, h, w))
        outs.append(out)
    lib = _build.load()
    dev = planes[0].device
    with torch.cuda.device(dev):
        info = _build.launch_band(getattr(lib, fn_name), recs,
                                  planes[0].shape[0],
                                  torch.cuda.current_stream(dev).cuda_stream)
    _count(out_dtype == torch.float32, info)
    return tuple(outs)


def _count(f32: bool, info: _build.BandInfo) -> None:
    global LAUNCHES, LAUNCHES_F32, LAUNCHES_STRIPS
    with _launch_lock:
        if f32:
            LAUNCHES_F32 += 1
        else:
            LAUNCHES += 1
        LAUNCHES_STRIPS += info.strips > 0


def resize_planes3(planes, stacks, vidx: torch.Tensor, *, bands=None):
    """K3 on a JPEG head's three planes in one launch: (Y, Cb, Cr) u8, Y
    resized with the luma stacks ``stacks[:2]`` and Cb, Cr with the chroma
    stacks ``stacks[2:]``, (wv, wh) each, all picked by ``vidx``; returns
    the three (B, OH, OW) u8 outputs. ``bands`` is None or a (luma,
    chroma) pair of ``bands`` values (:mod:`resize_strip`'s convention:
    the engine caches :class:`resize_strip.ResizeTables`)."""
    return _three("K3", "ik_resize_planes_u8", resize_planes_plain,
                  torch.uint8, planes, stacks, vidx, bands)


def resize_planes_u8(planes, stacks, vidx: torch.Tensor, *, bands=None):
    """K3 on one to three u8 planes in one launch, each with its own
    stacks: ``stacks[i]`` is plane i's (wv, wh) and ``bands`` None or one
    ``bands`` value a plane. The four-component JPEG pixel decode takes two
    launches: C, M and Y, then K."""
    if not 1 <= len(planes) <= 3 or len(stacks) != len(planes):
        raise ValueError(f"{len(planes)} planes and {len(stacks)} stacks: "
                         f"K3 takes one to three planes with a stack each")
    return _launch("K3", "ik_resize_planes_u8", resize_planes_plain,
                   torch.uint8, planes, stacks, vidx,
                   bands or [None] * len(planes))


def resize_planes3_f32(planes, stacks, vidx: torch.Tensor, *, bands=None):
    """K4 on three planes in one launch; as :func:`resize_planes3`, with
    no clip or round and f32 out. The planes are all f32 or all u8 (read
    in place, widened in the kernel)."""
    if planes[0].dtype == torch.uint8:
        return _three("K4", "ik_resize_planes_u8_f32",
                      resize_planes_f32_plain, torch.uint8, planes, stacks,
                      vidx, bands, out_dtype=torch.float32)
    return _three("K4", "ik_resize_planes_f32", resize_planes_f32_plain,
                  torch.float32, planes, stacks, vidx, bands)


def resize_planes_f32_plain(planes, wv, wh, vidx, bands=None) -> torch.Tensor:
    """Plain PyTorch version of K4: dense fp32 ``bmm`` over the gathered
    stacks, in full fp32 (TF32 is off: PyTorch's default, pinned by
    :func:`imagekit_tpu_torch.device.resolve_device`). ``bands`` is accepted
    and unused: the dense product is the banded one."""
    del bands
    u = vidx.long()
    return torch.bmm(torch.bmm(wv[u], planes.float()), wh[u].transpose(1, 2))


def resize_planes_plain(planes, wv, wh, vidx, bands=None) -> torch.Tensor:
    """Plain PyTorch version of K3: K4's product, then the epilogue of
    ``_resize_planes_einsum`` (``resize_kernel.py:289-290``)."""
    acc = resize_planes_f32_plain(planes, wv, wh, vidx, bands)
    return torch.floor(torch.clamp(acc, 0.0, 255.0) + 0.5).to(torch.uint8)


def resize_planes3_plain(planes, stacks, vidx, bands=None):
    """Plain PyTorch version of :func:`resize_planes3`."""
    wv_y, wh_y, wv_c, wh_c = stacks
    Y, Cb, Cr = planes
    return (resize_planes_plain(Y, wv_y, wh_y, vidx),
            resize_planes_plain(Cb, wv_c, wh_c, vidx),
            resize_planes_plain(Cr, wv_c, wh_c, vidx))


def resize_planes3_f32_plain(planes, stacks, vidx, bands=None):
    """Plain PyTorch version of :func:`resize_planes3_f32`."""
    wv_y, wh_y, wv_c, wh_c = stacks
    Y, Cb, Cr = planes
    return (resize_planes_f32_plain(Y, wv_y, wh_y, vidx),
            resize_planes_f32_plain(Cb, wv_c, wh_c, vidx),
            resize_planes_f32_plain(Cr, wv_c, wh_c, vidx))
