"""K2: the strip resize of u8 planes, as a hand-written CUDA kernel.

Counterpart of ``imagekit_tpu/ops/pallas_resize.py:82-168``
(``_make_resize_kernel`` launched by ``_plane_resize``). Per image b and
channel:

    acc = Wv[vidx[b]] @ f32(x[b]) @ Wh[hidx[b]]^T

then the optional affine remap ``(acc + pre) * scale + post``, round half
up (``floor(v + 0.5)``), clip to [0, 255], and u8 out, or i8 after -128
when ``centered``. The kernel is ``csrc/resize_strip.cu`` on the body it
shares with K3 (``csrc/resize_band.cuh``); its plain PyTorch versions,
:func:`plane_resize_plain`, :func:`rgb_resize_plain` and
:func:`rgba_resize_plain`, sit beside it.

Six entries launch it:

- :func:`rgb_resize`, the RGB heads' main path: the interleaved (B, H,
  W*3) u8 batch -> the three rounded u8 planes (B, 3, OH, OW), one launch
  that reads each pixel row once for the three channels;
- :func:`rgba_resize`, the plain RGB head's main path
  (``imagekit_tpu/ops/resize.py::_resample_flat_kernel``, which the
  reference leaves to XLA's einsums): an interleaved (B, H, W*4) u8 batch
  of sources with alpha -> (B, OH, OW, 4) u8, rounded, interleaved as it
  came, one launch and one 32-bit store a pixel;
- :func:`plane_resize`, one contiguous (B, IH, IW) plane stack with any
  of the three epilogues (a channel of an interleaved batch goes
  through :func:`rgb_resize`, or as a contiguous copy);
- :func:`yuv_resize`, the YUV-source heads' main path
  (``pallas_resize.py:177-202,271-289,319-353``): the Y, Cb and Cr planes
  of a decoded WebP or AVIF batch, chroma in any factors, and an AVIF's
  alpha plane as a fourth, each shape with its own stacks, in one launch,
  as rounded u8 planes (WebP, AVIF output) or, with ``jpeg=True``,
  remapped from studio to full range (Y and chroma by their own
  constants, :data:`JPEG_REMAP`) and centred to i8 for the fDCT;
- :func:`yuv_mix_resize`, the BT.709 YUV heads' resizes
  (``dct.py:1129-1148``, which the reference runs as XLA einsums): Y,
  both chroma planes to the half and the full output grid and the alpha
  plane, up to six planes in one launch of K2's f32 entry, unrounded for
  the 709 -> 601 mix that follows as torch ops;
- :func:`planes_resize_f32`, a height shard's partial products
  (``imagekit_tpu/parallel/sharding.py``, which the reference leaves to
  XLA's einsums and psum): an image's channels over the shard's rows, as
  planes, through the same f32 entry.

The Lanczos stacks are banded: a row of ``Wv`` has about 27 nonzero taps
out of 1088 at the 1080p -> 240 bucket, a row of ``Wh`` about 29 out of
1920. The kernel takes :class:`ResizeTables`: :func:`band_table` (each
row's ``[first, last)`` nonzero run) for ``Wv``, and for ``Wh`` the
compact table of :func:`compact_table`. The skipped terms are exact
zeros, so the result is the dense product's. ``bands`` is None (computed
here) or the :class:`ResizeTables` of :func:`resize_tables`, which the
engines cache beside their stacks.

Each entry launches the kernel for CUDA tensors and raises on anything the
kernel does not take; it takes the plain version only for tensors that
lie on the CPU.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from imagekit_tpu_torch.ops import _build

#: kernel launches made by :func:`rgb_resize`, :func:`plane_resize`,
#: :func:`yuv_resize`, :func:`yuv_mix_resize` and :func:`planes_resize_f32`
#: (read and reset by callers that must show the main path went through
#: the kernel)
LAUNCHES = 0
#: kernel launches made by :func:`rgba_resize`, counted apart
LAUNCHES_RGBA = 0
#: launches of any entry above that took the body's column strips (rows
#: too wide for a tile of whole rows), counted besides their entry's count
LAUNCHES_STRIPS = 0
#: launches of :func:`yuv_resize` and :func:`yuv_mix_resize` by the entry
#: :func:`yuv_entry` names (also counted in :data:`LAUNCHES`)
YUV_LAUNCHES: dict = {}
_launch_lock = threading.Lock()

#: the yuvjpg head's studio -> full-range remaps, ``(v + pre) * scale +
#: post`` for luma and for chroma (``pallas_resize.py:338-345``)
JPEG_REMAP = (dict(scale=255.0 / 219.0, pre=-16.0, post=0.0),
              dict(scale=255.0 / 224.0, pre=-128.0, post=128.0))


class ResizeTables(NamedTuple):
    """What the banded kernels read beside a (Wv, Wh) stack pair."""

    band_v: torch.Tensor   # (U, OH, 2) i32, band_table(wv)
    start_h: torch.Tensor  # (U2, OW) i32, compact_table(wh)[0]
    taps_h: torch.Tensor   # (U2, T/4, OW, 4) f32, compact_table(wh)[1]


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


def compact_table(w: torch.Tensor, band=None):
    """(U, O, I) stack -> ``(start, taps)``: (U, O) int32 and (U, T/4, O, 4)
    f32 with ``taps[u, t // 4, o, t % 4] = w[u, o, start + t]`` (the four
    taps of a step for neighbouring rows o side by side: one coalesced
    float4 load per thread and step in the kernel). ``start`` is the band's
    first column rounded down to a multiple of 4, and moved left where the
    window would pass the row's end; T is the widest such window rounded
    up to 4 (the kernel reads taps, and tile columns, four at a time). The
    window's taps off the band are the stack's own zeros, and past the
    row's end (a row shorter than T) exact zeros. So ``sum_t taps[t] *
    x[start + t]`` in increasing t adds the band's terms in increasing
    column order, after exact zeros: the dense product's sum. An empty row
    (a pad row) takes the start of the row before it (of the first
    nonempty row where none is before): its taps are zeros wherever its
    window lies, and so the starts of a monotone stack never fall, which
    lets the kernel's column strips bound their windows by their ends."""
    if band is None:
        band = band_table(w)
    n = w.shape[-1]
    first = band[..., 0] // 4 * 4  # aligned: the kernel reads 4 taps at once
    width = int((band[..., 1] - first).max()) if band.numel() else 0
    first = _from_nonempty(first, band[..., 1] > band[..., 0])
    T = max(4, (width + 3) // 4 * 4)
    start = first.clamp(max=max((n + 3) // 4 * 4 - T, 0)).to(torch.int32)
    cols = start.long()[..., None] + torch.arange(T, device=w.device)
    taps = torch.gather(w, 2, cols.clamp(max=n - 1))
    taps = torch.where(cols < n, taps, torch.zeros_like(taps))
    U, O = start.shape
    taps = taps.reshape(U, O, T // 4, 4).transpose(1, 2)
    return start.contiguous(), taps.contiguous()


def _from_nonempty(first: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """(U, O) ``first`` with each row where ``has`` is false taking the
    value of the nearest row before it where it is true, else of the
    first such row after it (0 where a slot has none)."""
    O = first.shape[-1]
    if O == 0:
        return first
    ar = torch.arange(O, device=first.device).expand_as(first)
    before = torch.where(has, ar, torch.full_like(ar, -1)).cummax(-1).values
    after = torch.where(has, ar, torch.full_like(ar, O)).min(
        -1, keepdim=True).values.clamp(max=O - 1).expand_as(first)
    src = torch.where(before >= 0, before, after)
    return torch.where(has.any(-1, keepdim=True), first.gather(-1, src),
                       torch.zeros_like(first))


def resize_tables(wv: torch.Tensor, wh: torch.Tensor) -> ResizeTables:
    """The band table of Wv and the compact table of Wh."""
    return ResizeTables(band_table(wv), *compact_table(wh))


def tables(wv, wh, bands) -> ResizeTables:
    """``bands`` as given to the entries -> :class:`ResizeTables`."""
    return resize_tables(wv, wh) if bands is None else ResizeTables(*bands)


def _check(x, wv, wh, vidx, hidx, tabs: ResizeTables):
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise TypeError(f"x must be a (B, IH, IW) uint8 plane stack, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"x (strides {x.stride()}) must be contiguous: a "
                         f"channel of an interleaved batch goes through "
                         f"rgb_resize, or as a contiguous copy")
    return check_args(x.device, x.shape, wv, wh, vidx, hidx, tabs)


def check_args(dev, shape, wv, wh, vidx, hidx, tabs: ResizeTables):
    """The checks of everything but the planes, of shape (B, IH, IW) on
    ``dev``; returns (B, IH, IW, U, OH, U2, OW)."""
    tensors = {"wv": wv, "wh": wh, "vidx": vidx, "hidx": hidx,
               **tabs._asdict()}
    dtypes = {"wv": torch.float32, "wh": torch.float32, "taps_h": torch.float32}
    for name, t in tensors.items():
        want = dtypes.get(name, torch.int32)
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the planes on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, ih, iw = shape
    if wv.dim() != 3 or wh.dim() != 3 or wv.shape[2] != ih or wh.shape[2] != iw:
        raise ValueError(f"weight stacks {tuple(wv.shape)} / {tuple(wh.shape)} "
                         f"do not fit the ({ih}, {iw}) planes")
    if tuple(vidx.shape) != (B,) or tuple(hidx.shape) != (B,):
        raise ValueError(f"vidx {tuple(vidx.shape)} / hidx {tuple(hidx.shape)}"
                         f" must be ({B},)")
    if tuple(tabs.band_v.shape) != (*wv.shape[:2], 2):
        raise ValueError("band tables do not fit the weight stacks")
    T = 4 * tabs.taps_h.shape[1] if tabs.taps_h.dim() == 4 else 0
    if (tuple(tabs.start_h.shape) != tuple(wh.shape[:2])
            or tuple(tabs.taps_h.shape) != (wh.shape[0], T // 4, wh.shape[1], 4)
            or not 0 < T <= iw + 3):
        raise ValueError("compact tables do not fit the weight stacks")
    return B, ih, iw, wv.shape[0], wv.shape[1], wh.shape[0], wh.shape[1]


def _affine(scale: float, pre: float, post: float) -> bool:
    return scale != 1.0 or pre != 0.0 or post != 0.0


def plane_record(x_ptr: int, sb: int, sh: int, C: int, wv,
                 tabs: ResizeTables, vidx, hidx, out, osb: int, osc: int,
                 ih: int, iw: int, scale: float = 1.0, pre: float = 0.0,
                 post: float = 0.0, strip: int = 0) -> _build.IkPlane:
    """One :class:`_build.IkPlane` of a launch: pixel rows of ``C``
    elements at ``x_ptr`` (strides ``sb``, ``sh`` in elements), channel
    ``ch`` written at ``out + b*osb + ch*osc``, with the plane's own
    affine u8 epilogue. ``strip``: output columns a block takes (0: the
    kernel takes whole rows where they fit and column strips where they do
    not; a width asks for strips where whole rows would fit too)."""
    U, oh = wv.shape[:2]
    U2, ow = tabs.start_h.shape
    T = 4 * tabs.taps_h.shape[1]
    return _build.IkPlane(
        x_ptr, wv.data_ptr(), tabs.band_v.data_ptr(),
        tabs.start_h.data_ptr(), tabs.taps_h.data_ptr(), vidx.data_ptr(),
        hidx.data_ptr(), out.data_ptr(), sb, sh, osb, osc,
        ih, iw, oh, ow, U, U2, T, C, scale, pre, post,
        int(_affine(scale, pre, post)), strip)


def check_rows(ptr: int, sb: int, sh: int, E: int, T: int, iw: int,
               cpt: int, esize: int) -> None:
    """Raise unless the kernel can read these pixel rows: whole loads of
    ``cpt`` elements (row length, strides and address), and compact
    windows no wider than the row."""
    if E % cpt or sh % cpt or sb % cpt or ptr % (cpt * esize) or T > iw:
        raise ValueError(
            f"the kernel reads rows in whole loads of {cpt} elements: a row "
            f"of {E} elements with strides ({sb}, {sh}) at {ptr:#x}, and "
            f"{T} taps over {iw} columns, do not fit")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _count(info: _build.BandInfo, rgba: bool = False) -> None:
    global LAUNCHES, LAUNCHES_RGBA, LAUNCHES_STRIPS
    with _launch_lock:
        if rgba:
            LAUNCHES_RGBA += 1
        else:
            LAUNCHES += 1
        LAUNCHES_STRIPS += info.strips > 0


def on_device_with_kernel(x, what: str) -> None:
    """Raise for a device with neither the kernel nor the plain version."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")


def plane_resize(x: torch.Tensor, wv: torch.Tensor, wh: torch.Tensor,
                 vidx: torch.Tensor, hidx: torch.Tensor, *,
                 scale: float = 1.0, pre: float = 0.0, post: float = 0.0,
                 centered: bool = False, bands=None,
                 strip: int = 0) -> torch.Tensor:
    """Contiguous (B, IH, IW) u8 planes -> (B, OH, OW) u8 (i8 when
    ``centered``), weights picked per image from the (U, OH, IH) / (U2, OW, IW) f32 stacks
    by ``vidx`` and ``hidx``. One K2 launch on CUDA (``strip``: see
    :func:`plane_record`)."""
    on_device_with_kernel(x, "K2")
    tabs = tables(wv, wh, bands)
    B, ih, iw, U, oh, U2, ow = _check(x, wv, wh, vidx, hidx, tabs)
    if x.device.type == "cpu":
        return plane_resize_plain(x, wv, wh, vidx, hidx, scale=scale,
                                  pre=pre, post=post, centered=centered)
    check_rows(x.data_ptr(), ih * iw, iw, iw, 4 * tabs.taps_h.shape[1], iw,
               8, 1)
    lib = _build.load()
    out = torch.empty((B, oh, ow), device=x.device,
                      dtype=torch.int8 if centered else torch.uint8)
    rec = plane_record(x.data_ptr(), ih * iw, iw, 1, wv, tabs, vidx, hidx,
                       out, oh * ow, 0, ih, iw, scale, pre, post, strip)
    with torch.cuda.device(x.device):
        info = _build.launch_band(lib.ik_resize_strip, [rec], B,
                                  int(centered), _stream(x.device))
    _count(info)
    return out


def _check_pixels(imgs, C: int, wv, wh, vidx, hidx, bands):
    """The checks of an interleaved (B, H, W*C) u8 batch and its stacks;
    returns (tables, iw, oh, ow)."""
    if imgs.dim() != 3 or imgs.shape[2] % C:
        raise ValueError(f"imgs must be a (B, H, W*{C}) batch, got "
                         f"{tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    on_device_with_kernel(imgs, "K2")
    if imgs.dtype != torch.uint8:
        raise TypeError(f"imgs must be uint8, got {imgs.dtype}")
    B, H, WC = imgs.shape
    tabs = tables(wv, wh, bands)
    _, _, iw, _, oh, _, ow = check_args(imgs.device, (B, H, WC // C), wv, wh,
                                        vidx, hidx, tabs)
    return tabs, iw, oh, ow


def _launch_pixels(imgs, C: int, wv, tabs, vidx, hidx, out, iw: int,
                   strip: int) -> None:
    """One K2 launch on the pixel rows of ``imgs``: channel ch of image b
    to ``out[b, ch]`` for C = 3, pixels to ``out[b]`` as they came for
    C = 4; counted."""
    B, H, WC = imgs.shape
    check_rows(imgs.data_ptr(), H * WC, WC, WC, 4 * tabs.taps_h.shape[1], iw,
               8, 1)
    lib = _build.load()
    rec = plane_record(imgs.data_ptr(), H * WC, WC, C, wv, tabs, vidx, hidx,
                       out, out.stride(0), out.stride(1) if C == 3 else 1,
                       H, iw, strip=strip)
    with torch.cuda.device(imgs.device):
        info = _build.launch_band(lib.ik_resize_strip, [rec], B, 0,
                                  _stream(imgs.device))
    _count(info, rgba=C == 4)


def rgb_resize(imgs: torch.Tensor, wv: torch.Tensor, wh: torch.Tensor,
               vidx: torch.Tensor, hidx: torch.Tensor, *,
               bands=None, strip: int = 0) -> torch.Tensor:
    """Contiguous (B, H, W*3) u8 interleaved RGB -> (B, 3, OH, OW) u8, the
    three channels resized and rounded (K2's default epilogue). One K2
    launch on CUDA reads each pixel row once for the three channels
    (``strip``: see :func:`plane_record`)."""
    tabs, iw, oh, ow = _check_pixels(imgs, 3, wv, wh, vidx, hidx, bands)
    if imgs.device.type == "cpu":
        return rgb_resize_plain(imgs, wv, wh, vidx, hidx)
    out = torch.empty((imgs.shape[0], 3, oh, ow), device=imgs.device,
                      dtype=torch.uint8)
    _launch_pixels(imgs, 3, wv, tabs, vidx, hidx, out, iw, strip)
    return out


def rgba_resize(imgs: torch.Tensor, wv: torch.Tensor, wh: torch.Tensor,
                vidx: torch.Tensor, hidx: torch.Tensor, *,
                bands=None, strip: int = 0) -> torch.Tensor:
    """Contiguous (B, H, W*4) u8 interleaved RGBA -> (B, OH, OW, 4) u8,
    the four channels resized and rounded (K2's default epilogue), pixels
    interleaved as they came. One K2 launch on CUDA reads each pixel row
    once for the four channels and stores each output pixel as one 32-bit
    word (``strip``: see :func:`plane_record`)."""
    tabs, iw, oh, ow = _check_pixels(imgs, 4, wv, wh, vidx, hidx, bands)
    if imgs.device.type == "cpu":
        return rgba_resize_plain(imgs, wv, wh, vidx, hidx)
    out = torch.empty((imgs.shape[0], oh, ow, 4), device=imgs.device,
                      dtype=torch.uint8)
    _launch_pixels(imgs, 4, wv, tabs, vidx, hidx, out, iw, strip)
    return out


def _remaps(jpeg: bool, n: int = 3):
    """The (Y, Cb, Cr[, A]) epilogue constants of :func:`yuv_resize`: the
    alpha plane (never in a JPEG batch) keeps K2's default epilogue."""
    luma, chroma = JPEG_REMAP if jpeg else ({}, {})
    return (luma, chroma, chroma, {})[:n]


def _yuv_pairs(stacks, n: int):
    """The (wv, wh) pair of each of :func:`yuv_resize`'s planes: luma's for
    Y and alpha, chroma's for Cb and Cr."""
    wv_y, wh_y, wv_c, wh_c = stacks[:4]
    return [(wv_y, wh_y), (wv_c, wh_c), (wv_c, wh_c), (wv_y, wh_y)][:n]


def _count_yuv(entry: str) -> None:
    with _launch_lock:
        YUV_LAUNCHES[entry] = YUV_LAUNCHES.get(entry, 0) + 1


def yuv_entry(planes, mix: bool = False) -> str:
    """The name under which :data:`YUV_LAUNCHES` counts a launch of these
    planes: the chroma factors (``"420"``, ``"422"``, ``"444"``), ``"+a"``
    with an alpha plane, ``"+mix"`` for the BT.709 entry."""
    y, cb = planes[0], planes[1]
    csy, csx = y.shape[1] // max(cb.shape[1], 1), y.shape[2] // max(
        cb.shape[2], 1)
    name = {(2, 2): "420", (1, 2): "422", (1, 1): "444"}.get(
        (csy, csx), f"{csy}x{csx}")
    return name + ("+a" if len(planes) == 4 else "") + ("+mix" if mix else "")


def _check_yuv(planes, pairs, vidx, bands):
    """The checks of :func:`yuv_resize`'s planes and stacks; returns the
    planes' :class:`ResizeTables`."""
    tabs = [tables(wv, wh, b) for (wv, wh), b in zip(pairs, bands)]
    for x, (wv, wh), t in zip(planes, pairs, tabs):
        on_device_with_kernel(x, "K2")
        if x.dtype != torch.uint8 or x.dim() != 3:
            raise TypeError(f"planes must be (B, IH, IW) uint8 stacks, got "
                            f"{x.dtype} {tuple(x.shape)}")
        if x.stride(2) != 1 or x.stride(1) != x.shape[2]:
            raise ValueError(f"a plane's rows (strides {x.stride()}) must "
                             f"be dense; only its images may lie apart")
        check_args(x.device, x.shape, wv, wh, vidx, vidx, t)
    return tabs


def _launch_yuv(planes, pairs, tabs, vidx, remaps, centered: bool,
                f32: bool):
    """One K2 launch over ``planes`` (u8 out with each plane's epilogue, or
    f32); returns the outputs."""
    recs, outs = [], []
    dtype = torch.float32 if f32 else torch.int8 if centered else torch.uint8
    for x, (wv, wh), t, kw in zip(planes, pairs, tabs, remaps):
        B, ih, iw = x.shape
        sb = x.stride(0) if B > 1 else ih * iw
        check_rows(x.data_ptr(), sb, iw, iw, 4 * t.taps_h.shape[1], iw, 8, 1)
        oh, ow = wv.shape[1], wh.shape[1]
        out = torch.empty((B, oh, ow), device=x.device, dtype=dtype)
        recs.append(plane_record(x.data_ptr(), sb, iw, 1, wv, t, vidx, vidx,
                                 out, oh * ow, 0, ih, iw, **kw))
        outs.append(out)
    lib = _build.load()
    dev = planes[0].device
    with torch.cuda.device(dev):
        if f32:
            info = _build.launch_band(lib.ik_resize_strip_f32, recs,
                                      planes[0].shape[0], _stream(dev))
        else:
            info = _build.launch_band(lib.ik_resize_strip, recs,
                                      planes[0].shape[0], int(centered),
                                      _stream(dev))
    _count(info)
    return tuple(outs)


def yuv_resize(planes, stacks, vidx: torch.Tensor, *, jpeg: bool = False,
               bands=None):
    """The Y, Cb and Cr planes of a YUV-source batch, and its alpha plane
    when there are four, in one K2 launch: (B, IH, IW) u8 for Y and alpha
    and (B, IH/csy, IW/csx) for chroma in any factors (4:2:0, 4:2:2, 4:4:4),
    each with dense rows (a plane's images may lie a padded batch row
    apart: the views of the engine's flat batch are read in place). Y and
    alpha are resized with ``stacks[:2]`` and Cb, Cr with ``stacks[2:4]``
    ((wv, wh) each), all picked by ``vidx``. Returns the (B, OH, OW)
    planes: rounded u8, or with ``jpeg`` (three planes) remapped by
    :data:`JPEG_REMAP` (luma's constants for Y, chroma's for Cb and Cr,
    each in its plane's record) and centred to i8. ``bands`` is None or a
    (luma, chroma) pair of :class:`ResizeTables`."""
    planes = list(planes)
    n = len(planes)
    if n not in (3, 4) or (jpeg and n != 3):
        raise ValueError(f"{n} planes: Y, Cb, Cr and at most an alpha plane "
                         f"(none in a JPEG batch)")
    luma_b, chroma_b = bands if bands is not None else (None, None)
    pairs = _yuv_pairs(stacks, n)
    tabs = _check_yuv(planes, pairs, vidx,
                      (luma_b, chroma_b, chroma_b, luma_b)[:n])
    if planes[0].device.type == "cpu":
        return yuv_resize_plain(planes, stacks, vidx, jpeg=jpeg)
    outs = _launch_yuv(planes, pairs, tabs, vidx, _remaps(jpeg, n), jpeg,
                       False)
    _count_yuv(yuv_entry(planes))
    return outs


def _mix_pairs(stacks, n: int):
    """The (wv, wh) pairs of :func:`yuv_mix_resize`'s six resizes: Y with
    luma's, Cb and Cr with the full-grid chroma stacks, then with the
    half-grid ones, alpha with luma's."""
    wv_y, wh_y, wv_c, wh_c, wv_cf, wh_cf = stacks
    pairs = [(wv_y, wh_y), (wv_cf, wh_cf), (wv_cf, wh_cf), (wv_c, wh_c),
             (wv_c, wh_c), (wv_y, wh_y)]
    return pairs[:5 + (n == 4)]


def yuv_mix_resize(planes, stacks, vidx: torch.Tensor, *, bands=None):
    """The resizes of a BT.709 YUV-source batch in one K2 launch, f32 out
    and unrounded, for the 709 -> 601 mix (``dct.py:1129``): Y to the
    output grid, Cb and Cr to the full output grid (the mix's luma row)
    and to the half grid (its chroma block), and the alpha plane when
    there are four. ``stacks`` is (wv_y, wh_y, wv_c, wh_c, wv_cf, wh_cf);
    ``bands`` None or the (luma, chroma half, chroma full)
    :class:`ResizeTables`. Returns (Y, CbF, CrF, Cbh, Crh[, A])."""
    planes = list(planes)
    n = len(planes)
    if n not in (3, 4):
        raise ValueError(f"{n} planes: Y, Cb, Cr and at most an alpha plane")
    luma_b, half_b, full_b = bands if bands is not None else (None,) * 3
    srcs = [planes[0], planes[1], planes[2], planes[1], planes[2]] + planes[3:]
    pairs = _mix_pairs(stacks, n)
    tabs = _check_yuv(srcs, pairs, vidx,
                      [luma_b, full_b, full_b, half_b, half_b, luma_b])
    if planes[0].device.type == "cpu":
        return yuv_mix_resize_plain(planes, stacks, vidx)
    outs = _launch_yuv(srcs, pairs, tabs, vidx, [{}] * len(srcs), False,
                       True)
    _count_yuv(yuv_entry(planes, mix=True))
    return outs


#: planes one launch of the band body takes (``kBandPlanes``,
#: ``csrc/resize_band.cuh``)
BAND_PLANES = 6


def planes_resize_f32(planes, wv: torch.Tensor, wh: torch.Tensor,
                      vidx: torch.Tensor, *, bands=None):
    """Up to :data:`BAND_PLANES` contiguous (B, IH, IW) u8 planes, each
    resized with the one (wv, wh) stack pair picked by ``vidx``, in one
    launch of K2's f32 entry: unrounded f32 (B, OH, OW) each, in column
    strips where a row is too wide for a tile of whole rows. The channels
    of an image, fed as planes, give the partial products of a height
    shard (:func:`imagekit_tpu_torch.parallel.sharding.sharded_resample`:
    each shard resizes its own rows with its slice of ``Wv``)."""
    planes = list(planes)
    if not 1 <= len(planes) <= BAND_PLANES:
        raise ValueError(f"{len(planes)} planes: one launch takes 1 to "
                         f"{BAND_PLANES}")
    for x in planes:
        on_device_with_kernel(x, "K2")
        if not x.is_contiguous():
            raise ValueError("planes must be contiguous")
    t = tables(wv, wh, bands)
    n = len(planes)
    tabs = _check_yuv(planes, [(wv, wh)] * n, vidx, [t] * n)
    if planes[0].device.type == "cpu":
        return tuple(resize_plain_f32(x, wv, wh, vidx) for x in planes)
    return _launch_yuv(planes, [(wv, wh)] * n, tabs, vidx, [{}] * n, False,
                       True)


def plane_resize_plain(x, wv, wh, vidx, hidx, *, scale: float = 1.0,
                       pre: float = 0.0, post: float = 0.0,
                       centered: bool = False, bands=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dense fp32 ``bmm`` over the
    gathered stacks, then K2's epilogue (``pallas_resize.py:112-121``).
    ``bands`` is accepted and unused: the dense product is the banded one."""
    del bands
    acc = torch.bmm(torch.bmm(wv[vidx.long()], x.float()),
                    wh[hidx.long()].transpose(1, 2))
    if _affine(scale, pre, post):
        acc = (acc + pre) * scale + post
    v = torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)
    if centered:
        return (v - 128.0).to(torch.int8)
    return v.to(torch.uint8)


def rgb_resize_plain(imgs, wv, wh, vidx, hidx, bands=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rgb_resize`: K2's plain version on
    each channel, stacked to (B, 3, OH, OW)."""
    B, H, WC = imgs.shape
    x = imgs.reshape(B, H, WC // 3, 3)
    return torch.stack([plane_resize_plain(x[..., c], wv, wh, vidx, hidx,
                                           bands=bands) for c in range(3)],
                       dim=1)


def rgba_resize_plain(imgs, wv, wh, vidx, hidx, bands=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rgba_resize`: K2's plain version on
    each of the four channels, interleaved to (B, OH, OW, 4)."""
    B, H, WC = imgs.shape
    x = imgs.reshape(B, H, WC // 4, 4)
    return torch.stack([plane_resize_plain(x[..., c], wv, wh, vidx, hidx,
                                           bands=bands) for c in range(4)],
                       dim=-1)


def yuv_resize_plain(planes, stacks, vidx, *, jpeg: bool = False, bands=None):
    """Plain PyTorch version of :func:`yuv_resize`: K2's plain version on
    each plane, with the plane's remap."""
    del bands
    planes = list(planes)
    return tuple(
        plane_resize_plain(x, wv, wh, vidx, vidx, centered=jpeg, **kw)
        for x, (wv, wh), kw in zip(planes, _yuv_pairs(stacks, len(planes)),
                                   _remaps(jpeg, len(planes))))


def resize_plain_f32(x, wv, wh, vidx) -> torch.Tensor:
    """K2's f32 entry's plain version on one plane: the dense product,
    unrounded."""
    return torch.bmm(torch.bmm(wv[vidx.long()], x.float()),
                     wh[vidx.long()].transpose(1, 2))


def yuv_mix_resize_plain(planes, stacks, vidx, *, bands=None):
    """Plain PyTorch version of :func:`yuv_mix_resize`."""
    del bands
    planes = list(planes)
    srcs = [planes[0], planes[1], planes[2], planes[1], planes[2]] + planes[3:]
    return tuple(resize_plain_f32(x, wv, wh, vidx)
                 for x, (wv, wh) in zip(srcs, _mix_pairs(stacks, len(planes))))
