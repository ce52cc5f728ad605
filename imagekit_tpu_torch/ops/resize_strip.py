"""K2: the strip resize of one u8 plane, as a hand-written CUDA kernel.

Counterpart of ``imagekit_tpu/ops/pallas_resize.py:82-168``
(``_make_resize_kernel`` launched by ``_plane_resize``). Per image b:

    acc = Wv[vidx[b]] @ f32(x[b]) @ Wh[hidx[b]]^T

then the optional affine remap ``(acc + pre) * scale + post``, round half
up (``floor(v + 0.5)``), clip to [0, 255], and u8 out, or i8 after -128
when ``centered``. The kernel is ``csrc/resize_strip.cu``; its plain
PyTorch version, :func:`plane_resize_plain`, sits beside it.

The Lanczos stacks are banded: a row of ``Wv`` has about 27 nonzero taps
out of 1088 at the 1080p -> 240 bucket, a row of ``Wh`` about 29 out of
1920. :func:`band_table` gives each row's ``[first, last)`` nonzero run,
computed from the stack itself; the kernel bounds its loops with it. The
skipped terms are exact zeros, so the result is the dense product's.

:func:`plane_resize` launches the kernel for CUDA tensors and raises on
anything the kernel does not take. It takes the plain version only for
tensors that lie on the CPU. ``x`` may be a strided view, e.g. one channel
``imgs.reshape(B, H, W, 3)[..., c]`` of an interleaved batch: the kernel
reads it in place through its strides.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

#: kernel launches made by :func:`plane_resize` (read and reset by callers
#: that must show the main path went through the kernel)
LAUNCHES = 0
_launch_lock = threading.Lock()


def band_table(w: torch.Tensor) -> torch.Tensor:
    """(U, O, I) weight stack -> (U, O, 2) int32 ``[first, last)`` of each
    row's nonzero run; an all-zero row (a pad row) gets the empty (0, 0)."""
    nz = w != 0
    n = w.shape[-1]
    has = nz.any(dim=-1)
    first = nz.to(torch.int32).argmax(dim=-1)
    last = n - nz.flip(-1).to(torch.int32).argmax(dim=-1)
    zero = torch.zeros_like(first)
    return torch.stack(
        [torch.where(has, first, zero), torch.where(has, last, zero)], dim=-1
    ).to(torch.int32).contiguous()


def _check(x, wv, wh, vidx, hidx, bands):
    dev = x.device
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise TypeError(f"x must be a (B, IH, IW) uint8 plane stack, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if any(s < 1 for s in x.stride()):
        raise ValueError(f"x strides {x.stride()} must be positive")
    tensors = {"wv": wv, "wh": wh, "vidx": vidx, "hidx": hidx,
               "band_v": bands[0], "band_h": bands[1]}
    dtypes = {"wv": torch.float32, "wh": torch.float32, "vidx": torch.int32,
              "hidx": torch.int32, "band_v": torch.int32,
              "band_h": torch.int32}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, ih, iw = x.shape
    if wv.dim() != 3 or wh.dim() != 3 or wv.shape[2] != ih or wh.shape[2] != iw:
        raise ValueError(f"weight stacks {tuple(wv.shape)} / {tuple(wh.shape)} "
                         f"do not fit the ({ih}, {iw}) planes")
    if tuple(vidx.shape) != (B,) or tuple(hidx.shape) != (B,):
        raise ValueError(f"vidx {tuple(vidx.shape)} / hidx {tuple(hidx.shape)}"
                         f" must be ({B},)")
    if (tuple(bands[0].shape) != (*wv.shape[:2], 2)
            or tuple(bands[1].shape) != (*wh.shape[:2], 2)):
        raise ValueError("band tables do not fit the weight stacks")
    return B, ih, iw, wv.shape[0], wv.shape[1], wh.shape[0], wh.shape[1]


def plane_resize(x: torch.Tensor, wv: torch.Tensor, wh: torch.Tensor,
                 vidx: torch.Tensor, hidx: torch.Tensor, *,
                 scale: float = 1.0, pre: float = 0.0, post: float = 0.0,
                 centered: bool = False,
                 bands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 ) -> torch.Tensor:
    """(B, IH, IW) u8 planes -> (B, OH, OW) u8 (i8 when ``centered``),
    weights picked per image from the (U, OH, IH) / (U2, OW, IW) f32 stacks
    by ``vidx`` and ``hidx``. ``bands`` are the stacks' :func:`band_table`
    pair; they are computed here when not given (the engine caches them
    beside its stacks)."""
    global LAUNCHES
    if bands is None:
        bands = (band_table(wv), band_table(wh))
    B, ih, iw, U, oh, U2, ow = _check(x, wv, wh, vidx, hidx, bands)
    if x.device.type == "cpu":
        return plane_resize_plain(x, wv, wh, vidx, hidx, scale=scale,
                                  pre=pre, post=post, centered=centered)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    from imagekit_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((B, oh, ow), device=x.device,
                      dtype=torch.int8 if centered else torch.uint8)
    affine = scale != 1.0 or pre != 0.0 or post != 0.0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ik_resize_strip_plane(
            x.data_ptr(), wv.data_ptr(), wh.data_ptr(), vidx.data_ptr(),
            hidx.data_ptr(), bands[0].data_ptr(), bands[1].data_ptr(),
            out.data_ptr(), B, ih, iw, oh, ow, U, U2, *x.stride(),
            scale, pre, post, int(affine), int(centered), stream,
        )
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return out


def plane_resize_plain(x, wv, wh, vidx, hidx, *, scale: float = 1.0,
                       pre: float = 0.0, post: float = 0.0,
                       centered: bool = False, bands=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dense fp32 ``bmm`` over the
    gathered stacks, then K2's epilogue (``pallas_resize.py:112-121``).
    ``bands`` is accepted and unused: the dense product is the banded one."""
    del bands
    acc = torch.bmm(torch.bmm(wv[vidx.long()], x.float()),
                    wh[hidx.long()].transpose(1, 2))
    if scale != 1.0 or pre != 0.0 or post != 0.0:
        acc = (acc + pre) * scale + post
    v = torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)
    if centered:
        return (v - 128.0).to(torch.int8)
    return v.to(torch.uint8)
