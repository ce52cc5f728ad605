"""K3 and K4: the two-pass resize of contiguous planes, as hand-written CUDA
kernels.

Counterpart of ``imagekit_tpu/ops/pallas/resize_kernel.py``: K3
(``_resize_plane_kernel`` :48, launched by ``pallas_resize_u8`` :124) and
K4 (``_resize_plane_kernel_f32`` :169, launched by
``resize_planes_f32_pallas`` :209). Per image b, with ONE index
``u = vidx[b]`` for both axes:

    acc = Wv[u] @ f32(P[b]) @ Wh[u]^T

K3 takes u8 planes and stores ``floor(clip(acc, 0, 255) + 0.5)`` as u8;
K4 takes f32 planes and stores ``acc``. Both are instantiations of one
template in ``csrc/resize_planes.cu``; their plain PyTorch versions,
:func:`resize_planes_plain` and :func:`resize_planes_f32_plain`, sit
beside them. The stacks are banded like K2's and the kernels bound their
loops with :func:`resize_strip.band_table`.

:func:`resize_planes` and :func:`resize_planes_f32` launch their kernel for
CUDA tensors and raise on anything it does not take; they take the plain
version only for tensors that lie on the CPU. The reference pads H and W to
128 for Mosaic; the zero rows and columns add nothing, so no padding is
made here.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from imagekit_tpu_torch.ops.resize_strip import band_table

#: kernel launches made by :func:`resize_planes` (K3) and
#: :func:`resize_planes_f32` (K4), read and reset by callers that must show
#: the main path went through the kernel
LAUNCHES = 0
LAUNCHES_F32 = 0
_launch_lock = threading.Lock()


def _check(planes, wv, wh, vidx, bands, dtype):
    dev = planes.device
    if planes.dtype != dtype or planes.dim() != 3:
        raise TypeError(f"planes must be a (B, H, W) {dtype} stack, got "
                        f"{planes.dtype} {tuple(planes.shape)}")
    tensors = {"planes": planes, "wv": wv, "wh": wh, "vidx": vidx,
               "band_v": bands[0], "band_h": bands[1]}
    dtypes = {"planes": dtype, "wv": torch.float32, "wh": torch.float32,
              "vidx": torch.int32, "band_v": torch.int32,
              "band_h": torch.int32}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, h, w = planes.shape
    if (wv.dim() != 3 or wh.dim() != 3 or wv.shape[2] != h or wh.shape[2] != w
            or wv.shape[0] != wh.shape[0]):
        raise ValueError(f"weight stacks {tuple(wv.shape)} / {tuple(wh.shape)} "
                         f"do not fit the ({h}, {w}) planes with one index")
    if tuple(vidx.shape) != (B,):
        raise ValueError(f"vidx {tuple(vidx.shape)} must be ({B},)")
    if (tuple(bands[0].shape) != (*wv.shape[:2], 2)
            or tuple(bands[1].shape) != (*wh.shape[:2], 2)):
        raise ValueError("band tables do not fit the weight stacks")


def _launch(fn_name: str, planes, wv, wh, vidx, bands, out_dtype):
    """Launch one instantiation on the current stream; raise on refusal."""
    B, h, w = planes.shape
    U, oh = wv.shape[:2]
    ow = wh.shape[1]
    if w % 4 or planes.data_ptr() % (4 * planes.element_size()):
        raise ValueError(f"the kernel reads 4 columns per load: W={w} must be "
                         f"a multiple of 4 and the planes aligned to it")
    from imagekit_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((B, oh, ow), device=planes.device, dtype=out_dtype)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = getattr(lib, fn_name)(
            planes.data_ptr(), wv.data_ptr(), wh.data_ptr(), vidx.data_ptr(),
            bands[0].data_ptr(), bands[1].data_ptr(), out.data_ptr(),
            B, h, w, oh, ow, U, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {rc}")
    return out


def _resize(kernel: str, fn_name: str, plain, dtype, planes, wv, wh, vidx,
            bands):
    """Check, then launch ``fn_name`` for CUDA tensors or take ``plain`` for
    CPU tensors; returns (out, launched)."""
    if bands is None:
        bands = (band_table(wv), band_table(wh))
    _check(planes, wv, wh, vidx, bands, dtype)
    if planes.device.type == "cpu":
        return plain(planes, wv, wh, vidx), False
    if planes.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {planes.device}")
    return _launch(fn_name, planes, wv, wh, vidx, bands, dtype), True


def resize_planes(planes: torch.Tensor, wv: torch.Tensor, wh: torch.Tensor,
                  vidx: torch.Tensor, *,
                  bands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  ) -> torch.Tensor:
    """K3: (B, H, W) u8 planes -> (B, OH, OW) u8, weights picked per image
    from the (U, OH, H) / (U, OW, W) f32 stacks by ``vidx``. ``bands`` are
    the stacks' :func:`band_table` pair; they are computed here when not
    given (the engine caches them beside its stacks)."""
    global LAUNCHES
    out, launched = _resize("K3", "ik_resize_planes_u8", resize_planes_plain,
                            torch.uint8, planes, wv, wh, vidx, bands)
    if launched:
        with _launch_lock:
            LAUNCHES += 1
    return out


def resize_planes_f32(planes: torch.Tensor, wv: torch.Tensor,
                      wh: torch.Tensor, vidx: torch.Tensor, *,
                      bands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      ) -> torch.Tensor:
    """K4: (B, H, W) f32 planes -> (B, OH, OW) f32, no clip or round."""
    global LAUNCHES_F32
    out, launched = _resize("K4", "ik_resize_planes_f32",
                            resize_planes_f32_plain, torch.float32, planes,
                            wv, wh, vidx, bands)
    if launched:
        with _launch_lock:
            LAUNCHES_F32 += 1
    return out


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
