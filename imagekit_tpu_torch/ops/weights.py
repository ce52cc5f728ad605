"""Host-side numpy builders for the port's device heads.

Byte-for-byte copies of the pure-numpy builders that the JAX package keeps
in modules which import ``jax`` at load time (``imagekit_tpu/ops/resize.py``
and ``imagekit_tpu/ops/dct.py``). Copying them, rather than importing, keeps
the port free of ``jax``; ``tests/test_torch_weights.py`` pins every builder
here ``np.array_equal`` to its original, so both packages feed their heads
the same weight stacks.

- filter kernels, :func:`resample_weights`, :func:`padded_weights`,
  :func:`fit_within`, :func:`target_dimensions` (``ops/resize.py:43-215,275``);
  and the port's own :func:`exact_stacks` for images beyond the bucket
  ladder, built from them;
- :func:`idct_basis`, :func:`idct_basis_k`, :func:`quality_tables`, the
  full-path chroma weights :func:`combined_chroma_weights` /
  :func:`combined_chroma_half_weights` (``ops/dct.py:125-163,271``), the
  truncated-path weights and their folding (``ops/dct.py:39-178,371-463``),
  ``LOWFREQ_ESC_Y/C`` (``ops/dct.py:612``);
- :func:`host_encode_rgb_to_coefficients` (``ops/dct.py:1864``), which makes
  JPEG coefficient planes from RGB without Pillow.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from imagekit_tpu_torch.utils.sized_cache import SizedArrayCache

# ---------------------------------------------------------------------------
# Filter kernels (ops/resize.py:43-98)
# ---------------------------------------------------------------------------


def _sinc(x: np.ndarray) -> np.ndarray:
    a = (x * np.float32(np.pi)).astype(np.float32)
    out = np.ones_like(x, dtype=np.float32)
    nz = x != 0
    out[nz] = (np.sin(a[nz]) / a[nz]).astype(np.float32)
    return out


def _lanczos3(x: np.ndarray) -> np.ndarray:
    t = np.float32(3.0)
    out = np.zeros_like(x, dtype=np.float32)
    m = np.abs(x) < t
    out[m] = (_sinc(x[m]) * _sinc(x[m] / t)).astype(np.float32)
    return out


def _triangle(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x).astype(np.float32)
    return np.where(ax < 1.0, np.float32(1.0) - ax, np.float32(0.0)).astype(
        np.float32
    )


def _catmull_rom(x: np.ndarray) -> np.ndarray:
    a = np.abs(x).astype(np.float32)
    a2 = a * a
    a3 = a2 * a
    out = np.zeros_like(a)
    m1 = a < 1.0
    m2 = (a >= 1.0) & (a < 2.0)
    out[m1] = (1.5 * a3 - 2.5 * a2 + 1.0)[m1]
    out[m2] = (-0.5 * a3 + 2.5 * a2 - 4.0 * a + 2.0)[m2]
    return out.astype(np.float32)


def _gaussian(x: np.ndarray) -> np.ndarray:
    r = np.float32(0.5)
    return (
        np.exp(-(x.astype(np.float32) ** 2) / (2.0 * r * r))
        / np.float32(np.sqrt(2.0 * np.pi) * r)
    ).astype(np.float32)


def _box(x: np.ndarray) -> np.ndarray:
    return (np.abs(x) <= 0.5).astype(np.float32)


# name -> (support, kernel). "lanczos3" is what the reference always uses.
FILTERS: Dict[str, Tuple[float, Callable[[np.ndarray], np.ndarray]]] = {
    "lanczos3": (3.0, _lanczos3),
    "triangle": (1.0, _triangle),
    "bilinear": (1.0, _triangle),
    "catmullrom": (2.0, _catmull_rom),
    "gaussian": (3.0, _gaussian),
    "nearest": (0.0, _box),
}

# ---------------------------------------------------------------------------
# Weight matrices (ops/resize.py:106-164, 275-298)
# ---------------------------------------------------------------------------

_WEIGHTS_CACHE = SizedArrayCache(64 * 1024 * 1024)


def resample_weights(true_in, true_out, filter_name="lanczos3"):
    """Cached (byte-budgeted) resample weight matrix; see the impl below."""
    key = ("rw", true_in, true_out, filter_name)
    return _WEIGHTS_CACHE.get_or_build(
        key, lambda: _resample_weights_impl(true_in, true_out, filter_name)
    )


def _resample_weights_impl(
    in_size: int, out_size: int, filter_name: str = "lanczos3"
) -> np.ndarray:
    """Dense (out_size, in_size) f32 weight matrix for one axis.

    Per output pixel: window centre ``(o + 0.5) * ratio`` in source space,
    support scaled by ``max(ratio, 1)``, window ``[floor(c - s), ceil(c + s))``
    clamped to the image, kernel evaluated at ``(i - (c - 0.5)) / sratio``,
    weights normalised to sum 1.
    """
    if filter_name not in FILTERS:
        raise ValueError(f"unknown filter: {filter_name}")
    if filter_name == "nearest":
        return _nearest_weights(in_size, out_size)

    support, kernel = FILTERS[filter_name]
    ratio = np.float32(in_size) / np.float32(out_size)
    sratio = ratio if ratio >= 1.0 else np.float32(1.0)
    src_support = np.float32(support) * sratio

    W = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        center = np.float32(np.float32(o) + np.float32(0.5)) * ratio
        left = int(np.floor(np.float32(center - src_support)))
        left = min(max(left, 0), in_size - 1)
        right = int(np.ceil(np.float32(center + src_support)))
        right = min(max(right, left + 1), in_size)
        c = np.float32(center - np.float32(0.5))
        idx = np.arange(left, right, dtype=np.float32)
        w = kernel(((idx - c) / sratio).astype(np.float32))
        s = w.sum(dtype=np.float32)
        if s != 0:
            w = (w / s).astype(np.float32)
        W[o, left:right] = w
    return W


def _nearest_weights(in_size: int, out_size: int) -> np.ndarray:
    """Nearest-neighbour as a 0/1 selection matrix."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    ratio = in_size / out_size
    for o in range(out_size):
        src = min(int((o + 0.5) * ratio), in_size - 1)
        W[o, src] = 1.0
    return W


def padded_weights(
    true_in: int,
    true_out: int,
    bucket_in: int,
    bucket_out: int,
    filter_name: str = "lanczos3",
) -> np.ndarray:
    """Weight matrix for a (true_in -> true_out) resample embedded in a
    (bucket_out, bucket_in) zero matrix: padded input rows contribute
    nothing and output rows beyond ``true_out`` come out zero."""
    if true_in > bucket_in or true_out > bucket_out:
        raise ValueError("true size exceeds bucket")
    w = resample_weights(true_in, true_out, filter_name)
    out = np.zeros((bucket_out, bucket_in), dtype=np.float32)
    out[:true_out, :true_in] = w
    return out


def load_aligned(n: int) -> int:
    """``n`` columns rounded up to a multiple of 8: a row of them is whole
    8-byte loads of the kernels at any channel count, and no compact
    window of its stack is wider than the row."""
    return (n + 7) // 8 * 8


def exact_stacks(h: int, w: int, out_h: int, out_w: int,
                 filter_name: str = "lanczos3") -> Tuple[np.ndarray, np.ndarray]:
    """The (1, out_h, h) and (1, out_w, load_aligned(w)) stacks of a resample
    at its exact shape, for an image beyond the bucket ladder: Wv is
    :func:`resample_weights` (h, out_h), Wh is (w, out_w) with zero
    weights in the pad columns, which carry nothing (as
    ``imagekit_tpu/parallel/tiling.py:49-56`` pads H for its shards)."""
    wv = resample_weights(h, out_h, filter_name)[None]
    wh = padded_weights(w, out_w, load_aligned(w), out_w, filter_name)[None]
    return wv, wh


# ---------------------------------------------------------------------------
# Output-dimension math (ops/resize.py:172-209)
# ---------------------------------------------------------------------------


def _round_f32_half_away(x: np.float32) -> int:
    """Rust f32::round — round half away from zero (positive inputs here)."""
    return int(np.floor(np.float32(x) + np.float32(0.5)))


def _round_f64_half_away(x: float) -> int:
    return int(np.floor(x + 0.5))


def fit_within(
    orig_w: int, orig_h: int, box_w: int, box_h: int
) -> Tuple[int, int]:
    """Aspect-preserving fit inside a bounding box, f64 math with
    round-half-away-from-zero and a floor of 1 px."""
    wratio = box_w / orig_w
    hratio = box_h / orig_h
    ratio = min(wratio, hratio)
    nw = max(_round_f64_half_away(orig_w * ratio), 1)
    nh = max(_round_f64_half_away(orig_h * ratio), 1)
    return nw, nh


def target_dimensions(
    orig_w: int, orig_h: int, w: Optional[int], h: Optional[int]
) -> Tuple[int, int]:
    """Fill in the missing dimension with f32 ratio math, clamp to >= 1,
    then fit-within. Returns the original size when both are None."""
    if w is None and h is None:
        return orig_w, orig_h
    if w is None:
        ratio = np.float32(h) / np.float32(orig_h)
        w = _round_f32_half_away(np.float32(orig_w) * ratio)
    if h is None:
        ratio = np.float32(w) / np.float32(orig_w)
        h = _round_f32_half_away(np.float32(orig_h) * ratio)
    return fit_within(orig_w, orig_h, max(int(w), 1), max(int(h), 1))


# ---------------------------------------------------------------------------
# Bases and quantisation tables (ops/dct.py:38-87)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def idct_basis() -> np.ndarray:
    """A[u, x]: contribution of frequency u to pixel x (1-D, 8-point).
    pixels = A^T @ coeffs @ A for a 2-D block."""
    A = np.zeros((8, 8), np.float32)
    for u in range(8):
        cu = np.sqrt(0.25) if u else np.sqrt(0.125)
        for x in range(8):
            A[u, x] = cu * np.cos((2 * x + 1) * u * np.pi / 16)
    return A


# Annex K base quantisation tables (natural order).
QTAB_LUMA_BASE = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    np.int32,
)
QTAB_CHROMA_BASE = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    np.int32,
)


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg quality->quantiser scaling, quality clamped to 1-100."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    def scaled(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.uint16)
    return scaled(QTAB_LUMA_BASE), scaled(QTAB_CHROMA_BASE)


# ---------------------------------------------------------------------------
# Truncated-path (k/8-scale) weights (ops/dct.py:94-172, 370-463)
# ---------------------------------------------------------------------------

# Chroma/upsample weight matrices run 0.1-7 MB each and are keyed by true
# dims — byte-budgeted LRU instead of entry caps.
_CHROMA_WEIGHTS = SizedArrayCache(64 * 1024 * 1024)


def _chroma_cached(key, build):
    return _CHROMA_WEIGHTS.get_or_build(key, build)


def _upsample_weights_impl(half: int, full: int) -> np.ndarray:
    """(full, half) matrix for libjpeg-style 'fancy' (triangle) 2x chroma
    upsampling along one axis: output 2i   = (3*c[i] + c[i-1]) / 4,
    output 2i+1 = (3*c[i] + c[i+1]) / 4, edges clamped. A non-subsampled
    axis is the identity."""
    if half == full:
        return np.eye(full, dtype=np.float32)
    U = np.zeros((full, half), np.float32)
    for o in range(full):
        i = o // 2
        if o % 2 == 0:
            j = max(i - 1, 0)
            U[o, i] += 0.75
            U[o, j] += 0.25
        else:
            j = min(i + 1, half - 1)
            U[o, i] += 0.75
            U[o, j] += 0.25
    return U


def upsample_weights(half, full):
    return _chroma_cached(("up", half, full), lambda: _upsample_weights_impl(half, full))


def chroma_axis_weights(luma_blocks: int, chroma_blocks: int) -> np.ndarray:
    """The (luma_blocks*8, chroma_blocks*8) chroma stack of one axis, from
    the components' block grids: the triangle 2x upsample where the luma
    grid is twice the chroma grid (to the block grid's edge), the identity
    where the grids are equal. A luma grid one block short of twice is a
    grayscale source's zero chroma (``ops/dct.py::gray_chroma``). Any
    other ratio raises ValueError."""
    if luma_blocks not in (chroma_blocks, 2 * chroma_blocks,
                           2 * chroma_blocks - 1):
        raise ValueError(f"chroma grid of {chroma_blocks} blocks against "
                         f"{luma_blocks} luma blocks: not 1x or 2x")
    return upsample_weights(chroma_blocks * 8, luma_blocks * 8)


def _replication_axis_weights_impl(luma_blocks: int, chroma_blocks: int,
                                   real: int) -> np.ndarray:
    step = luma_blocks // chroma_blocks
    out = np.zeros((luma_blocks * 8, chroma_blocks * 8), np.float32)
    rows = np.arange(luma_blocks * 8)
    out[rows, np.minimum(rows // step, real - 1)] = 1.0
    return out


def replication_axis_weights(luma_blocks: int, chroma_blocks: int,
                             real: int = 0) -> np.ndarray:
    """The (luma_blocks*8, chroma_blocks*8) chroma stack of one axis that
    replicates each sample over its subsampling block: weight 1 at
    ``floor(i / s)`` for output row i, ``s`` the ratio of the grids, any
    integer, no triangle upsample, and at most ``real - 1`` where the
    component's real size ``real`` is given (its samples past that are not
    read). libtiff's RGBA interface reads an old-style JPEG TIFF page this
    way, and libjpeg's ``int_upsample`` (and its plain 2x ones) a JPEG
    component. The identity where the grids are equal. A ratio that is not
    an integer raises ValueError."""
    if chroma_blocks <= 0 or luma_blocks % chroma_blocks:
        raise ValueError(f"chroma grid of {chroma_blocks} blocks against "
                         f"{luma_blocks} luma blocks: not an integer ratio")
    real = real or chroma_blocks * 8
    if luma_blocks == chroma_blocks and real == luma_blocks * 8:
        return upsample_weights(luma_blocks * 8, luma_blocks * 8)
    return _chroma_cached(("rep", luma_blocks, chroma_blocks, real),
                          lambda: _replication_axis_weights_impl(
                              luma_blocks, chroma_blocks, real))


def _triangle_axis_weights_impl(out_blocks: int, in_blocks: int,
                                real: int) -> np.ndarray:
    out = np.zeros((out_blocks * 8, in_blocks * 8), np.float32)
    o = np.arange(out_blocks * 8)
    i = o // 2
    far = np.where(o % 2 == 0, i - 1, i + 1)
    np.add.at(out, (o, np.minimum(i, real - 1)), 0.75)
    np.add.at(out, (o, np.clip(far, 0, real - 1)), 0.25)
    return out


def triangle_axis_weights(out_blocks: int, in_blocks: int,
                          real: int) -> np.ndarray:
    """libjpeg's triangle ("fancy") 2x upsample of one axis of a JPEG
    component of ``real`` samples on a grid of ``in_blocks`` blocks, to
    ``out_blocks = 2 * in_blocks``: :func:`upsample_weights`' taps, with
    the edge at the component's real size, not at its block grid (libjpeg
    upsamples ``downsampled_width`` samples and repeats the last row)."""
    if out_blocks != 2 * in_blocks:
        raise ValueError(f"{out_blocks} blocks from {in_blocks}: not 2x")
    return _chroma_cached(("tri", out_blocks, in_blocks, real),
                          lambda: _triangle_axis_weights_impl(
                              out_blocks, in_blocks, real))


def upsample_method(ratio: Tuple[int, int], width: int) -> str:
    """libjpeg-turbo's choice (``jdsample.c::jinit_upsampler``, which
    Pillow's decode runs) for a JPEG component whose largest factors are
    ``ratio = (rh, rv)`` times its own and whose real width is ``width``
    samples: ``"full"`` (equal grids), the triangles ``"h2v1"`` (2, 1),
    ``"h1v2"`` (1, 2) and ``"h2v2"`` (2, 2), or ``"int"``, replication on
    both axes, for any other pair of integer ratios and for (2, 1) and
    (2, 2) where the component is at most 2 samples wide."""
    rh, rv = ratio
    if (rh, rv) == (1, 1):
        return "full"
    if (rh, rv) == (1, 2):
        return "h1v2"
    if (rh, rv) in ((2, 1), (2, 2)) and width > 2:
        return "h2v1" if rv == 1 else "h2v2"
    return "int"


#: the axes (rows, columns) on which :func:`upsample_method`'s methods take
#: libjpeg's triangle; replication on the others
TRIANGLE_AXES = {"h2v1": (False, True), "h1v2": (True, False),
                 "h2v2": (True, True)}


def component_stacks(full: Tuple[int, int], grid: Tuple[int, int],
                     real: Tuple[int, int], method: str):
    """The (wv, wh) stacks of one JPEG component, (out, in) each, from its
    block grid ``grid`` and real size ``real`` (rows, columns) to the
    ``full`` grid of the largest factors, by :func:`upsample_method`'s
    ``method``: the triangle on the axes it names (:data:`TRIANGLE_AXES`),
    replication (:func:`replication_axis_weights`) on the others."""
    tri = TRIANGLE_AXES.get(method, (False, False))
    return tuple(
        triangle_axis_weights(f, g, r) if t
        else replication_axis_weights(f, g, r)
        for f, g, r, t in zip(full, grid, real, tri))


def _fix16(x: np.float32) -> int:
    """libtiff's FIX: ``(int32_t)(x * (1L << 16) + 0.5)``, x a float."""
    return int(np.float64(np.float32(x) * np.float32(65536)) + 0.5)


def _code2v(c, rb, rw, cr):
    """libtiff's Code2V in float: ``((c - (int32_t)RB) * (float)CR) /
    (float)(RW - RB != 0 ? RW - RB : 1)``, over an array of codes c."""
    den = np.float32(rw) - np.float32(rb)
    num = (np.asarray(c, np.int64) - int(np.float32(rb))).astype(np.float32)
    return (num * np.float32(cr)) / np.float32(den if den != 0 else 1)


def _clamp_trunc(f: np.ndarray) -> np.ndarray:
    """``(int32_t)CLAMP(f, -128 * 32, 128 * 32)`` (NaN to the minimum)."""
    f = np.where(f >= np.float32(-4096), f, np.float32(-4096))
    return np.trunc(np.minimum(f, np.float32(4096))).astype(np.int64)


@functools.lru_cache(maxsize=16)
def libtiff_ycbcr_tables(luma: Tuple[float, float, float],
                         refbw: Tuple[float, ...]) -> np.ndarray:
    """libtiff's ``TIFFYCbCrToRGBInit`` (``tif_color.c``): the (5, 256)
    int64 tables Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab and Cb_g_tab, each
    indexed by the 8-bit sample, from YCbCrCoefficients ``luma`` and
    ReferenceBlackWhite ``refbw`` as floats, in its float and 16-bit
    fixed-point arithmetic. ``TIFFYCbCrtoRGB`` is then R = clip(Y_tab[Y] +
    Cr_r_tab[Cr]), G = clip(Y_tab[Y] + ((Cb_g_tab[Cb] + Cr_g_tab[Cr]) >>
    16)), B = clip(Y_tab[Y] + Cb_b_tab[Cb]), clip to [0, 255]."""
    lr, lg, lb = (np.float32(v) for v in luma)
    rb = [np.float32(v) for v in refbw]

    def clamp2(f):
        f = np.float32(f)
        return np.float32(0) if not f >= 0 else min(f, np.float32(2))

    f1 = np.float32(2) - np.float32(2) * lr
    d1 = _fix16(clamp2(f1))
    d2 = -_fix16(clamp2(lr * f1 / lg))
    f3 = np.float32(2) - np.float32(2) * lb
    d3 = _fix16(clamp2(f3))
    d4 = -_fix16(clamp2(lb * f3 / lg))
    x = np.arange(256) - 128
    cr = _clamp_trunc(_code2v(x, rb[4] - np.float32(128),
                              rb[5] - np.float32(128), 127))
    cb = _clamp_trunc(_code2v(x, rb[2] - np.float32(128),
                              rb[3] - np.float32(128), 127))
    half = 1 << 15
    return np.stack([
        _clamp_trunc(_code2v(x + 128, rb[0], rb[1], 255)),
        (d1 * cr + half) >> 16,
        (d3 * cb + half) >> 16,
        d2 * cr,
        d4 * cb + half,
    ])


def _combined_chroma_weights_impl(
    chroma_true: int,
    full_true: int,
    out_true: int,
    chroma_bucket: int,
    out_bucket: int,
    filter_name: str = "lanczos3",
) -> np.ndarray:
    """One (out_bucket, chroma_bucket) matrix = resize(full->out) ∘
    upsample(chroma->full), zero-padded to bucket shape
    (``ops/dct.py:125``)."""
    W = resample_weights(full_true, out_true, filter_name)  # (out, full)
    U = upsample_weights(chroma_true, full_true)  # (full, chroma)
    C = (W @ U).astype(np.float32)  # (out, chroma)
    out = np.zeros((out_bucket, chroma_bucket), np.float32)
    out[:out_true, :chroma_true] = C
    return out


def combined_chroma_weights(chroma_true, full_true, out_true, chroma_bucket,
                            out_bucket, filter_name="lanczos3"):
    """Chroma to FULL output resolution, for the RGB-output head
    (``ops/dct.py:149``)."""
    key = ("cc", chroma_true, full_true, out_true, chroma_bucket, out_bucket, filter_name)
    return _chroma_cached(key, lambda: _combined_chroma_weights_impl(
        chroma_true, full_true, out_true, chroma_bucket, out_bucket, filter_name))


def _combined_chroma_half_weights_impl(
    chroma_true: int,
    full_true: int,
    out_true: int,
    chroma_bucket: int,
    out_half_bucket: int,
    filter_name: str = "lanczos3",
) -> np.ndarray:
    """One (out_half_bucket, chroma_bucket) matrix = 2x box-subsample ∘
    resize(full->out) ∘ upsample(chroma->full): source half resolution
    straight to target half resolution; an odd target dimension pairs the
    final row with itself (``ops/dct.py:271``)."""
    W = resample_weights(full_true, out_true, filter_name)  # (out, full)
    U = upsample_weights(chroma_true, full_true)  # (full, chroma)
    half = (out_true + 1) // 2
    S = np.zeros((half, out_true), np.float32)
    for i in range(half):
        S[i, 2 * i] += 0.5
        S[i, min(2 * i + 1, out_true - 1)] += 0.5
    C = (S @ W @ U).astype(np.float32)  # (half, chroma)
    out = np.zeros((out_half_bucket, chroma_bucket), np.float32)
    out[:half, :chroma_true] = C
    return out


def combined_chroma_half_weights(chroma_true, full_true, out_true,
                                 chroma_bucket, out_half_bucket,
                                 filter_name="lanczos3"):
    """Chroma to HALF output resolution, for the k=8 YUV/jxc fronts
    (``ops/dct.py:156``)."""
    key = ("cch", chroma_true, full_true, out_true, chroma_bucket,
           out_half_bucket, filter_name)
    return _chroma_cached(key, lambda: _combined_chroma_half_weights_impl(
        chroma_true, full_true, out_true, chroma_bucket, out_half_bucket,
        filter_name))


def lowfreq_chroma_half_weights(chroma_true, full_true, out_true,
                                chroma_inter_bucket, out_half_bucket, k):
    key = ("lch", chroma_true, full_true, out_true, chroma_inter_bucket,
           out_half_bucket, k)
    return _chroma_cached(key, lambda: _lowfreq_chroma_half_weights_impl(
        chroma_true, full_true, out_true, chroma_inter_bucket,
        out_half_bucket, k))


@functools.lru_cache(maxsize=8)
def idct_basis_k(k: int) -> np.ndarray:
    """Orthonormal k-point IDCT basis A_k[u, x]."""
    A = np.zeros((k, k), np.float32)
    for u in range(k):
        cu = np.sqrt(2.0 / k) if u else np.sqrt(1.0 / k)
        for x in range(k):
            A[u, x] = cu * np.cos((2 * x + 1) * u * np.pi / (2 * k))
    return A


def intermediate_dim(true_full: int, k: int) -> int:
    """True sample extent of the k/8-scale intermediate plane."""
    return (true_full * k + 7) // 8


def lowfreq_luma_weights(
    true_full: int, out_true: int, k: int, inter_bucket: int, out_bucket: int
) -> np.ndarray:
    """(out_bucket, inter_bucket) Lanczos weights resampling the k/8-scale
    intermediate plane to the target."""
    inter_true = intermediate_dim(true_full, k)
    W = resample_weights(inter_true, out_true)
    out = np.zeros((out_bucket, inter_bucket), np.float32)
    out[:out_true, :inter_true] = W
    return out


def _lowfreq_chroma_half_weights_impl(
    chroma_true: int,
    full_true: int,
    out_true: int,
    chroma_inter_bucket: int,
    out_half_bucket: int,
    k: int,
) -> np.ndarray:
    """Truncated-path chroma weights: 2x box-subsample ∘ resize ∘ 2x
    upsample on the k/8-scale grids, one matrix per axis."""
    ci = intermediate_dim(chroma_true, k)
    fi = intermediate_dim(full_true, k)
    W = resample_weights(fi, out_true)  # (out, inter-luma)
    U = upsample_weights(ci, fi)  # (inter-luma, inter-chroma)
    half = (out_true + 1) // 2
    S = np.zeros((half, out_true), np.float32)
    for i in range(half):
        S[i, 2 * i] += 0.5
        S[i, min(2 * i + 1, out_true - 1)] += 0.5
    C = (S @ W @ U).astype(np.float32)
    out = np.zeros((out_half_bucket, chroma_inter_bucket), np.float32)
    out[:half, :ci] = C
    return out


def pad128(n: int) -> int:
    return (n + 127) // 128 * 128


def lowfreq_ac_width(nblk: int, k: int) -> int:
    """Minor dim of the PLANAR split-int8 AC batch layout: k*k-1 coefficient
    planes, each 128-aligned, so plane j of block column b sits at
    ``j * pad128(nblk) + b``."""
    return (k * k - 1) * pad128(nblk)


def fold_lowfreq_weights(W: np.ndarray, k: int) -> np.ndarray:
    """Fold the k-point IDCT basis into a truncated-path resize weight
    stack: (U, O, nblk*k) -> (U, k, O, nblk).

    Column ``k*i + x`` of W addresses phase x of block i on the k/8-scale
    intermediate plane; both the per-block IDCT and the resize are linear,
    so ``out[:, u] = W @ E_u`` with ``E_u[k*i + x, i] = A_k[u, x]``."""
    A = idct_basis_k(k)
    U, O, L = W.shape
    nblk = L // k
    Wb = W.reshape(U, O, nblk, k)
    return np.ascontiguousarray(
        np.einsum("zoix,ux->zuoi", Wb, A).astype(np.float32)
    )


# natural-order indices of the KxK low-frequency coefficients
@functools.lru_cache(maxsize=8)
def _lowfreq_indices(k: int) -> np.ndarray:
    return np.array([u * 8 + v for u in range(k) for v in range(k)], np.int32)


#: static escape capacities of the split-int8 batch head: one luma and one
#: per-chroma-plane scatter list per batch (ops/dct.py:612).
LOWFREQ_ESC_Y = 4096
LOWFREQ_ESC_C = 1024


# ---------------------------------------------------------------------------
# Encode direction, host mirror (ops/dct.py:1864)
# ---------------------------------------------------------------------------


def host_encode_rgb_to_coefficients(
    img: np.ndarray, quality: int, samp: Tuple[int, int] = (2, 2)
) -> Tuple[List[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """RGB -> BT.601 YCbCr, chroma box subsample, 8x8 fDCT and quantise:
    coefficient planes [(byY,bxY,64), (byC,bxC,64), ...] i16 and the quant
    tables, ready for ``loader.encode_jpeg``. ``samp`` is the luma's (h, v)
    sampling factors against the chroma's 1: (2, 2) is 4:2:0, (2, 1) 4:2:2,
    (1, 2) 4:4:0 and (1, 1) 4:4:4; ``loader.encode_jpeg`` takes the same
    ``samp``."""
    sh, sv = samp
    h, w = img.shape[:2]
    ph = (h + 8 * sv - 1) // (8 * sv) * 8 * sv
    pw = (w + 8 * sh - 1) // (8 * sh) * 8 * sh
    x = np.pad(
        img[:, :, :3], ((0, ph - h), (0, pw - w), (0, 0)), mode="edge"
    ).astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b
    cb_d = cb.reshape(ph // sv, sv, pw // sh, sh).mean(axis=(1, 3))
    cr_d = cr.reshape(ph // sv, sv, pw // sh, sh).mean(axis=(1, 3))
    A = idct_basis()
    qy, qc = quality_tables(quality)

    def fdct_quant(plane, q):
        hh, ww = plane.shape
        blocks = np.ascontiguousarray(
            plane.reshape(hh // 8, 8, ww // 8, 8).transpose(0, 2, 1, 3)
        ).reshape(-1, 8, 8)
        # c[u,v] = A @ p @ A^T per block, as broadcast BLAS matmuls
        c = A[None] @ blocks @ A.T[None]
        c = c.reshape(hh // 8, ww // 8, 64) / q.astype(np.float32)[None, None]
        return (np.sign(c) * np.floor(np.abs(c) + 0.5)).astype(np.int16)

    return (
        [fdct_quant(y, qy), fdct_quant(cb_d, qc), fdct_quant(cr_d, qc)],
        (qy, qc),
    )
