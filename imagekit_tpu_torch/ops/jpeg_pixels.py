"""K6: the JPEG pixel decode equal to Pillow's libjpeg-turbo, in a
hand-written CUDA kernel.

It replaces no Pallas kernel. The JAX package decodes every JPEG outside
its batched 4:2:0 heads with Pillow (``imagekit_tpu/codecs/__init__.py``
hands such a source to ``pil_backend.decode``), and Pillow's decode is
libjpeg-turbo's: ``jidctint.c``'s fixed-point islow IDCT, ``jdsample.c``'s
fancy upsamplers and ``jdcolor.c``'s fixed-point colour tables. K6
(``csrc/jpeg_pixels.cu``) computes those steps in integers, so the port
serves such a JPEG with Pillow's pixels byte for byte. Two launches a
decode:

- ``ik_jpeg_idct``: dequantise, islow IDCT and range limit of every 8x8
  block of up to four components, each to its u8 plane;
- ``ik_jpeg_upcolour``: each component upsampled to the output grid through
  its row and column :func:`axis_map`, then the colour step (``YCC``:
  ``ycc_rgb_convert``; ``YCCK``: ``ycck_cmyk_convert``; ``NONE``) -> (H, W,
  C) u8, C the component count.

:func:`decode_pixels` launches both for CUDA tensors and raises on anything
the kernels do not take; it takes the plain version,
:func:`decode_pixels_plain` (int32 tensor ops, the same arithmetic), only
for tensors that lie on the CPU. The maps, built on the host by
:func:`frame_plan` (a JPEG frame) and the TIFF page code, carry libjpeg's
choice of upsampler and its edges, so neither version has special cases:
a component's sample at output ``o`` of an axis is read at ``near`` and,
where the axis takes libjpeg's triangle, at ``far``, with the bias of
``o``'s parity within its segment.

The IDCT is the x86-64 SIMD one Pillow runs (``jidctint-avx2.asm``):
16-bit products and sums where it keeps 16 bits, saturation where the C
version wraps through its range-limit table (the two agree on the levels
of any 8-bit JPEG an encoder writes; probing Pillow with hostile levels
showed the SIMD's answers). The constants are ``jidctint.c``'s and
``jdcolor.c``'s, written out below; nothing is read from a libjpeg.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from imagekit_tpu_torch.ops.weights import TRIANGLE_AXES, upsample_method

#: kernel launches made by :func:`decode_pixels` (two a decode: the IDCT,
#: then the upsample and colour), read and reset by callers that must show
#: the main path went through the kernel
LAUNCHES = 0
_launch_lock = threading.Lock()

#: the colour steps: none, ``ycc_rgb_convert``, ``ycck_cmyk_convert``
NONE, YCC, YCCK = 0, 1, 2

# jidctint.c, CONST_BITS 13
CONST_BITS = 13
PASS1_BITS = 2
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172

# jdcolor.c, SCALEBITS 16
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
FIX_1_40200 = 91881
FIX_1_77200 = 116130
FIX_0_71414 = 46802
FIX_0_34414 = 22554

#: the bits of a component's ``fancy``: libjpeg's triangle on its rows,
#: on its columns
ROWS, COLS = 1, 2


@dataclass
class Plan:
    """One decode as the host plans it: component c's (by, bx, 64) i16
    levels ``coeffs[c]`` and its table ``qtabs[c]`` (natural order), its
    (3, height) row map and (3, width) column map (:func:`axis_map`) and
    its ``fancy`` bits; the colour step; the output size."""

    coeffs: List[np.ndarray]
    qtabs: np.ndarray
    rows: List[np.ndarray]
    cols: List[np.ndarray]
    fancy: Tuple[int, ...]
    colour: int
    height: int
    width: int


@dataclass
class Inputs:
    """A :class:`Plan` on a device: what :func:`decode_pixels` takes."""

    coeffs: List[torch.Tensor]
    qt: torch.Tensor
    rows: List[torch.Tensor]
    cols: List[torch.Tensor]
    fancy: Tuple[int, ...]
    colour: int
    height: int
    width: int

    @property
    def device(self) -> torch.device:
        return self.qt.device


def axis_map(n_out: int, ratio: int, triangle: bool,
             spans: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """(3, n_out) int32 of one axis of a component: for each output
    coordinate the nearer sample (index in the component's plane), the
    farther one and the coordinate's parity in its segment. ``spans`` are
    the segments along the axis, (first output, first sample, real
    samples) each in ascending order: one for a JPEG, a strip or tile
    row (column) of a TIFF page each, where libjpeg decoded each alone.
    The nearer sample is ``o // ratio`` (replication, or the identity at
    ratio 1); with ``triangle`` (ratio 2) the farther is the one before
    for an even ``o``, the one after for an odd, as libjpeg's fancy
    upsamplers take them. Both stop at the segment's real samples, where
    libjpeg repeats its last row and column."""
    o = np.arange(n_out)
    starts = np.array([s[0] for s in spans])
    seg = np.searchsorted(starts, o, side="right") - 1
    out0, first, real = (np.array([s[i] for s in spans])[seg]
                         for i in range(3))
    local = o - out0
    i = local // ratio
    near = first + np.minimum(i, real - 1)
    far = (first + np.clip(np.where(local % 2 == 0, i - 1, i + 1), 0,
                           real - 1) if triangle else near)
    return np.stack([near, far, local % 2]).astype(np.int32)


def fancy_bits(method: str) -> int:
    """:data:`ROWS` / :data:`COLS` of one of
    :func:`~imagekit_tpu_torch.ops.weights.upsample_method`'s methods."""
    rows, cols = TRIANGLE_AXES.get(method, (False, False))
    return ROWS * rows + COLS * cols


def frame_plan(hdr, coeffs, qtabs, colour: int) -> Plan:
    """The :class:`Plan` of one JPEG frame: ``hdr``, ``coeffs`` and
    ``qtabs`` as ``jpeg_abi.decode`` returns them (or ``decode4``), any
    integer sampling: each component upsampled by libjpeg's choice
    (:func:`~imagekit_tpu_torch.ops.weights.upsample_method` of its ratios
    to the largest factors and its real width) with its edges at its real
    size. A ratio that is not an integer raises ValueError."""
    rows, cols, fancy = [], [], []
    for c in range(hdr.ncomp):
        h, v = hdr.comp_h[c], hdr.comp_v[c]
        if hdr.hmax % h or hdr.vmax % v:
            raise ValueError(f"component {c} sampled {h}x{v} under "
                             f"{hdr.hmax}x{hdr.vmax}: a fractional ratio")
        rh, rv = hdr.hmax // h, hdr.vmax // v
        bits = fancy_bits(upsample_method((rh, rv), hdr.comp_width[c]))
        rows.append(axis_map(hdr.height, rv, bool(bits & ROWS),
                             [(0, 0, hdr.comp_height[c])]))
        cols.append(axis_map(hdr.width, rh, bool(bits & COLS),
                             [(0, 0, hdr.comp_width[c])]))
        fancy.append(bits)
    qt = np.stack([qtabs[t] for t in hdr.comp_tq[:hdr.ncomp]])
    return Plan(list(coeffs[:hdr.ncomp]), qt, rows, cols, tuple(fancy),
                colour, hdr.height, hdr.width)


def upload(plan: Plan, device: torch.device) -> Inputs:
    """The plan's arrays on ``device``: the levels as i16, the tables' low
    16 bits as i16 (as the SIMD's 16-bit multiply takes them), the maps as
    i32. Raises ValueError for a map that leaves its component's plane."""
    for c, (lv, r, k) in enumerate(zip(plan.coeffs, plan.rows, plan.cols)):
        if (min(r[:2].min(), k[:2].min()) < 0 or r[:2].max() >= lv.shape[0] * 8
                or k[:2].max() >= lv.shape[1] * 8):
            raise ValueError(f"maps of component {c} leave its "
                             f"{lv.shape[1] * 8}x{lv.shape[0] * 8} plane")
    qt = torch.from_numpy(plan.qtabs.astype(np.int64).astype(np.uint16)
                          .view(np.int16).copy())

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return Inputs([put(c, np.int16) for c in plan.coeffs], qt.to(device),
                  [put(m, np.int32) for m in plan.rows],
                  [put(m, np.int32) for m in plan.cols], plan.fancy,
                  plan.colour, plan.height, plan.width)


# -- the plain version ---------------------------------------------------------


def _w16(x: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32 ``x``, signed."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct8(i):
    """One 8-point islow pass over the eight int32 tensors ``i`` (16-bit
    values), as ``csrc/jpeg_pixels.cu::idct8``: the eight sums before the
    descale."""
    tmp3 = i[2] * (FIX_0_541196100 + FIX_0_765366865) + i[6] * FIX_0_541196100
    tmp2 = i[2] * FIX_0_541196100 + i[6] * (FIX_0_541196100 - FIX_1_847759065)
    tmp0 = _w16(i[0] + i[4]) * (1 << CONST_BITS)
    tmp1 = _w16(i[0] - i[4]) * (1 << CONST_BITS)
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3 = _w16(i[7] + i[3])
    z4 = _w16(i[5] + i[1])
    z3m = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602
    z4m = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644)
    o0 = (i[7] * (FIX_0_298631336 - FIX_0_899976223)
          - i[1] * FIX_0_899976223 + z3m)
    o1 = (i[5] * (FIX_2_053119869 - FIX_2_562915447)
          - i[3] * FIX_2_562915447 + z4m)
    o2 = (-i[5] * FIX_2_562915447
          + i[3] * (FIX_3_072711026 - FIX_2_562915447) + z3m)
    o3 = (-i[7] * FIX_0_899976223
          + i[1] * (FIX_1_501321110 - FIX_0_899976223) + z4m)
    return [tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
            tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]


def idct_plain(levels: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """(by, bx, 64) i16 levels and a (64,) i16 table -> (by*8, bx*8) u8
    plane: K6's first launch for one component."""
    by, bx = levels.shape[:2]
    c = levels.to(torch.int32).reshape(-1, 8, 8)
    d = _w16(c * qt.to(torch.int32).reshape(8, 8))
    cols = _idct8([d[:, r, :] for r in range(8)])
    half1 = 1 << (CONST_BITS - PASS1_BITS - 1)
    ws = torch.stack([torch.clamp((o + half1) >> (CONST_BITS - PASS1_BITS),
                                  -32768, 32767) for o in cols], 1)
    # every AC level of rows 1-7 zero: pass 1 is the DC << PASS1_BITS, in
    # 16 bits
    dc = _w16(d[:, 0, :] * (1 << PASS1_BITS))[:, None, :].expand(-1, 8, 8)
    ws = torch.where((c[:, 1:, :] == 0).all(2).all(1)[:, None, None], dc, ws)
    rows = _idct8([ws[:, :, k] for k in range(8)])
    shift = CONST_BITS + PASS1_BITS + 3
    px = torch.stack([torch.clamp((o + (1 << (shift - 1))) >> shift, -128, 127)
                      for o in rows], 2) + 128
    return (px.to(torch.uint8).reshape(by, bx, 8, 8).permute(0, 2, 1, 3)
            .reshape(by * 8, bx * 8))


def _upsample_plain(plane, rows, cols, fancy: int) -> torch.Tensor:
    """One component's u8 plane -> (H, W) int32 samples on the output grid
    (K6's second launch before the colour step)."""
    p = plane.to(torch.int32)
    rn, rf, ro = rows.long()
    cn, cf, co = cols.long()
    near, far = p[rn], p[rf]
    if fancy == ROWS | COLS:  # h2v2
        sn = 3 * near[:, cn] + far[:, cn]
        sf = 3 * near[:, cf] + far[:, cf]
        return (3 * sn + sf + 8 - co[None]) >> 4
    if fancy == COLS:  # h2v1
        return (3 * near[:, cn] + near[:, cf] + 1 + co[None]) >> 2
    if fancy == ROWS:  # h1v2
        return (3 * near[:, cn] + far[:, cn] + 1 + ro[:, None]) >> 2
    return near[:, cn]


def colour_plain(v: List[torch.Tensor], colour: int) -> torch.Tensor:
    """The colour step on int32 sample planes -> (H, W, C) u8."""
    if colour != NONE:
        y, cb, cr = v[0], v[1] - 128, v[2] - 128
        r = y + ((FIX_1_40200 * cr + ONE_HALF) >> SCALEBITS)
        g = y + ((-FIX_0_34414 * cb + ONE_HALF - FIX_0_71414 * cr)
                 >> SCALEBITS)
        b = y + ((FIX_1_77200 * cb + ONE_HALF) >> SCALEBITS)
        mix = [r, g, b] if colour == YCC else [255 - r, 255 - g, 255 - b]
        v = [torch.clamp(m, 0, 255) for m in mix] + v[3:]
    return torch.stack(v, -1).to(torch.uint8)


def decode_pixels_plain(x: Inputs) -> torch.Tensor:
    """Plain PyTorch version of K6: the same integer arithmetic in int32
    tensor ops -> (H, W, C) u8 on the inputs' device."""
    planes = [idct_plain(c, x.qt[i]) for i, c in enumerate(x.coeffs)]
    v = [_upsample_plain(p, r, k, f)
         for p, r, k, f in zip(planes, x.rows, x.cols, x.fancy)]
    return colour_plain(v, x.colour)


# -- the kernel ----------------------------------------------------------------


class Record(ctypes.Structure):
    """What both entries take: ``Record`` in ``csrc/jpeg_pixels.cu``,
    field for field (device addresses, up to four components)."""

    _fields_ = (
        [(n, ctypes.c_void_p * 4) for n in ("coef", "plane", "rows", "cols")]
        + [(n, ctypes.c_int * 4) for n in ("by", "bx", "fancy")]
        + [("qt", ctypes.c_void_p), ("out", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in ("ncomp", "H", "W", "colour")]
    )


def check(x: Inputs) -> None:
    """Raise on inputs the kernels do not take: types, shapes, devices.
    The maps' values are checked on the host (:func:`upload`); the kernel
    clamps them into the planes."""
    n = len(x.coeffs)
    if not 1 <= n <= 4 or not (len(x.rows) == len(x.cols) == len(x.fancy)
                               == n):
        raise ValueError(f"{n} components: K6 takes one to four, each with "
                         f"its maps")
    if x.colour not in (NONE, YCC, YCCK) or (x.colour == YCC and n != 3) or (
            x.colour == YCCK and n != 4):
        raise ValueError(f"colour step {x.colour} on {n} components")
    if not (1 <= x.height <= 65535 and x.width >= 1):
        raise ValueError(f"an output of {x.width}x{x.height}")
    if x.qt.dtype != torch.int16 or tuple(x.qt.shape) != (n, 64):
        raise TypeError(f"tables must be ({n}, 64) int16, got {x.qt.dtype} "
                        f"{tuple(x.qt.shape)}")
    dev = x.qt.device
    for c in range(n):
        lv, r, k = x.coeffs[c], x.rows[c], x.cols[c]
        if (lv.dtype != torch.int16 or lv.dim() != 3 or lv.shape[2] != 64
                or lv.shape[0] < 1 or lv.shape[1] < 1):
            raise TypeError(f"levels of component {c} must be (by, bx, 64) "
                            f"int16, got {lv.dtype} {tuple(lv.shape)}")
        if (r.dtype != torch.int32 or k.dtype != torch.int32
                or tuple(r.shape) != (3, x.height)
                or tuple(k.shape) != (3, x.width)):
            raise TypeError(f"maps of component {c} must be (3, H) and (3, "
                            f"W) int32")
        if x.fancy[c] not in (0, ROWS, COLS, ROWS | COLS):
            raise ValueError(f"fancy bits {x.fancy[c]}")
        for t in (lv, r, k):
            if t.device != dev:
                raise ValueError(f"component {c} on {t.device}, tables on "
                                 f"{dev}")
            if not t.is_contiguous():
                raise ValueError("K6 takes contiguous tensors")


def decode_pixels(x: Inputs) -> torch.Tensor:
    """K6 on one decode -> (H, W, C) u8 on the inputs' device: its two
    launches for CUDA tensors, its plain version for CPU ones; raises on
    any other device and on inputs the kernels do not take."""
    global LAUNCHES
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K6 kernel for device {dev}")
    check(x)
    if dev.type == "cpu":
        return decode_pixels_plain(x)
    from imagekit_tpu_torch.ops import _build

    n = len(x.coeffs)
    planes = [torch.empty((c.shape[0] * 8, c.shape[1] * 8), dtype=torch.uint8,
                          device=dev) for c in x.coeffs]
    out = torch.empty((x.height, x.width, n), dtype=torch.uint8, device=dev)
    rec = record(x, planes, out)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for fn in (lib.ik_jpeg_idct, lib.ik_jpeg_upcolour):
            rc = fn(ctypes.byref(rec), stream)
            if rc != 0:
                raise RuntimeError(f"{fn.__name__} launch failed: "
                                   f"cudaError_t {rc}")
            with _launch_lock:
                LAUNCHES += 1
    return out


def record(x: Inputs, planes, out) -> Record:
    """The entries' :class:`Record` of ``x``, with its IDCT ``planes`` and
    ``out`` (tensors the caller keeps alive through the launches)."""
    rec = Record()
    for c, lv in enumerate(x.coeffs):
        rec.coef[c] = lv.data_ptr()
        rec.plane[c] = planes[c].data_ptr()
        rec.rows[c] = x.rows[c].data_ptr()
        rec.cols[c] = x.cols[c].data_ptr()
        rec.by[c], rec.bx[c] = lv.shape[0], lv.shape[1]
        rec.fancy[c] = x.fancy[c]
    rec.qt, rec.out = x.qt.data_ptr(), out.data_ptr()
    rec.ncomp, rec.H, rec.W, rec.colour = (len(x.coeffs), x.height, x.width,
                                           x.colour)
    return rec


def decode(plan: Plan, device: torch.device) -> torch.Tensor:
    """:func:`upload` the plan, then :func:`decode_pixels`."""
    return decode_pixels(upload(plan, device))
