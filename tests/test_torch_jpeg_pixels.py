"""K6, the JPEG pixel decode equal to Pillow's libjpeg-turbo, on the CPU.

``imagekit_tpu_torch/ops/jpeg_pixels.py`` (plain version here; the kernel,
``csrc/jpeg_pixels.cu``, compiled by g++ under the CPU shim of
``tests/test_torch_kernel_cpu.py``) against:

- numpy transcriptions of libjpeg-turbo's steps, written here from the C
  sources' structure (the first and last columns as their own cases, the
  row loops of ``jdsample.c``, the tables of ``jdcolor.c``): the islow
  IDCT as the x86-64 SIMD computes it (16-bit products and sums,
  saturation), and as ``jidctint.c`` does (64-bit sums, the range-limit
  table), which agree on the levels an encoder writes;
- Pillow itself: blocks of hostile levels (Pillow follows the SIMD, not
  the C table), its YCbCr planes before the colour step (``draft``), and
  through the JAX package's ``decode_bytes`` every DCT JPEG layout and
  JPEG TIFF page layout the port decodes, byte for byte: 4:4:4, 4:2:2,
  4:4:0, 4:2:0, distinct tables, gray, 4:1:1, 4:1:0, a ratio of 3, Cb and
  Cr sampled differently, a luma below the largest factors, CMYK and YCCK
  in several samplings, progressive and arithmetic frames, JPEG TIFF
  strips and tiles, at 203x151, 17x9, 2x5 and 1x1;
- both apps: ``/img`` and ``/upload`` bodies.

Tolerance: none. Every step is integer arithmetic; the kernel source, its
plain version and Pillow give the same bytes.
"""

import ctypes
import io
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import FormData
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu_torch import codecs
from imagekit_tpu_torch.codecs import jpeg, tiff
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.ops import _build, dct
from imagekit_tpu_torch.ops import jpeg_pixels as jp
from imagekit_tpu_torch.tools.sources import make_jpeg_tiff
from tests.conftest import make_test_image
from tests.fixtures import jpeg_arith_writer, jpeg_writer
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_kernel_cpu import SHIM
from tests.test_torch_pillow_sources import _cmyk, _img, _serve, _url

CSRC = Path(__file__).resolve().parents[1] / "imagekit_tpu_torch" / "csrc"


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


# -- numpy transcriptions of libjpeg-turbo ---------------------------------------

#: jidctint.c's FIX_* constants, CONST_BITS 13
F = dict(F298=2446, F390=3196, F541=4433, F765=6270, F899=7373, F1175=9633,
         F1501=12299, F1847=15137, F1961=16069, F2053=16819, F2562=20995,
         F3072=25172)


def _w16(x):
    return ((np.asarray(x, np.int64) + 32768) & 0xFFFF) - 32768


def _idct8_simd(i):
    """One pass of ``jidctint-avx2.asm``'s ``dodct``: pmaddwd pairs, the
    paddw sums in 16 bits."""
    i0, i1, i2, i3, i4, i5, i6, i7 = i
    tmp3 = i2 * (F["F541"] + F["F765"]) + i6 * F["F541"]
    tmp2 = i2 * F["F541"] + i6 * (F["F541"] - F["F1847"])
    t0, t1 = _w16(i0 + i4) << 13, _w16(i0 - i4) << 13
    t10, t13, t11, t12 = t0 + tmp3, t0 - tmp3, t1 + tmp2, t1 - tmp2
    z3, z4 = _w16(i7 + i3), _w16(i5 + i1)
    z3m = z3 * (F["F1175"] - F["F1961"]) + z4 * F["F1175"]
    z4m = z3 * F["F1175"] + z4 * (F["F1175"] - F["F390"])
    o0 = i7 * (F["F298"] - F["F899"]) + i1 * -F["F899"] + z3m
    o1 = i5 * (F["F2053"] - F["F2562"]) + i3 * -F["F2562"] + z4m
    o2 = i5 * -F["F2562"] + i3 * (F["F3072"] - F["F2562"]) + z3m
    o3 = i7 * -F["F899"] + i1 * (F["F1501"] - F["F899"]) + z4m
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def islow_reference(coef, q) -> np.ndarray:
    """(N, 64) levels and a (64,) table -> (N, 8, 8) u8 as Pillow's
    libjpeg-turbo (x86-64 SIMD) computes them: pmullw products, the
    all-AC-zero pass 1 in 16 bits, packssdw after pass 1, packsswb and
    +128 after pass 2."""
    c = np.asarray(coef, np.int64).reshape(-1, 8, 8)
    d = _w16(c * _w16(np.asarray(q, np.int64)).reshape(8, 8))
    cols = _idct8_simd([d[:, r, :] for r in range(8)])
    ws = np.stack([np.clip((o + 1024) >> 11, -32768, 32767) for o in cols], 1)
    dc_only = np.all(c[:, 1:, :] == 0, axis=(1, 2))
    ws = np.where(dc_only[:, None, None],
                  _w16(d[:, 0, :] << 2)[:, None, :].repeat(8, 1), ws)
    rows = _idct8_simd([ws[:, :, k] for k in range(8)])
    out = [np.clip((o + (1 << 17)) >> 18, -128, 127) + 128 for o in rows]
    return np.stack(out, 2).astype(np.uint8)


def _idct8_c(i):
    """One pass of ``jidctint.c::jpeg_idct_islow`` in 64-bit JLONG."""
    i0, i1, i2, i3, i4, i5, i6, i7 = i
    z1 = (i2 + i6) * F["F541"]
    tmp2, tmp3 = z1 - i6 * F["F1847"], z1 + i2 * F["F765"]
    t0, t1 = (i0 + i4) << 13, (i0 - i4) << 13
    t10, t13, t11, t12 = t0 + tmp3, t0 - tmp3, t1 + tmp2, t1 - tmp2
    a0, a1, a2, a3 = i7, i5, i3, i1
    z1, z2, z3, z4 = a0 + a3, a1 + a2, a0 + a2, a1 + a3
    z5 = (z3 + z4) * F["F1175"]
    z1, z2 = z1 * -F["F899"], z2 * -F["F2562"]
    z3, z4 = z3 * -F["F1961"] + z5, z4 * -F["F390"] + z5
    a0 = a0 * F["F298"] + z1 + z3
    a1 = a1 * F["F2053"] + z2 + z4
    a2 = a2 * F["F3072"] + z2 + z3
    a3 = a3 * F["F1501"] + z1 + z4
    return [t10 + a3, t11 + a2, t12 + a1, t13 + a0,
            t13 - a0, t12 - a1, t11 - a2, t10 - a3]


def _range_limit() -> np.ndarray:
    """``prepare_range_limit_table``'s post-IDCT part, indexed by the
    descaled value & RANGE_MASK (1023)."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896)


def islow_c(coef, q) -> np.ndarray:
    """``jidctint.c``'s islow: products and sums in 64 bits, the workspace
    unsaturated, the output through the range-limit table (wrapping)."""
    c = np.asarray(coef, np.int64).reshape(-1, 8, 8)
    d = c * np.asarray(q, np.int64).reshape(8, 8)
    cols = _idct8_c([d[:, r, :] for r in range(8)])
    ws = np.stack([(o + 1024) >> 11 for o in cols], 1)
    rows = _idct8_c([ws[:, :, k] for k in range(8)])
    table = _range_limit()
    out = [table[((o + (1 << 17)) >> 18) & 1023] for o in rows]
    return np.stack(out, 2).astype(np.uint8)


def idct_plane_reference(coeffs, q) -> np.ndarray:
    """A component's (by, bx, 64) levels -> its (by*8, bx*8) u8 plane by
    :func:`islow_reference`."""
    by, bx = coeffs.shape[:2]
    b = islow_reference(coeffs.reshape(-1, 64), q).reshape(by, bx, 8, 8)
    return b.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


def _h2v1_row(row, dw):
    """``h2v1_fancy_upsample`` of one row of ``dw`` samples (> 2)."""
    r = row.astype(np.int64)
    out = np.empty(2 * dw, np.int64)
    out[0] = r[0]
    out[1] = (r[0] * 3 + r[1] + 2) >> 2
    j = np.arange(1, dw - 1)
    out[2 * j] = (3 * r[j] + r[j - 1] + 1) >> 2
    out[2 * j + 1] = (3 * r[j] + r[j + 1] + 2) >> 2
    out[2 * dw - 2] = (r[dw - 1] * 3 + r[dw - 2] + 1) >> 2
    out[2 * dw - 1] = r[dw - 1]
    return out


def _context(plane, dh):
    """The rows ``jdmainct.c`` hands the upsampler: row -1 is row 0, the
    rows past the real height the last real row."""
    return lambda i: plane[min(max(i, 0), dh - 1)].astype(np.int64)


def upsample_reference(plane, method, dh, dw):
    """A component's plane of ``dh`` x ``dw`` real samples upsampled as
    ``jdsample.c`` does it: (rows, columns) of the 2x methods, or
    ``("int", rv, rh)`` replication."""
    row = _context(plane, dh)
    if method == "h2v1":
        return np.stack([_h2v1_row(row(i), dw) for i in range(dh)])
    out = []
    for i in range(dh):
        for v, bias in ((0, 1), (1, 2)):
            near, far = row(i), row(i - 1 if v == 0 else i + 1)
            if method == "h1v2":
                out.append((near[:dw] * 3 + far[:dw] + bias) >> 2)
                continue
            # h2v2: column sums, the first and last columns their own cases
            s = near[:dw] * 3 + far[:dw]
            o = np.empty(2 * dw, np.int64)
            o[0] = (s[0] * 4 + 8) >> 4
            o[1] = (s[0] * 3 + s[1] + 7) >> 4
            j = np.arange(1, dw - 1)
            o[2 * j] = (s[j] * 3 + s[j - 1] + 8) >> 4
            o[2 * j + 1] = (s[j] * 3 + s[j + 1] + 7) >> 4
            o[2 * dw - 2] = (s[dw - 1] * 3 + s[dw - 2] + 8) >> 4
            o[2 * dw - 1] = (s[dw - 1] * 4 + 7) >> 4
            out.append(o)
    return np.stack(out)


def _fix16(x):
    return int(x * 65536 + 0.5)


def colour_reference(y, cb, cr, k=None):
    """``build_ycc_rgb_table`` + ``ycc_rgb_convert``, or
    ``ycck_cmyk_convert`` where ``k`` is given."""
    x = np.arange(256) - 128
    cr_r = (_fix16(1.40200) * x + 32768) >> 16
    cb_b = (_fix16(1.77200) * x + 32768) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + 32768
    y = y.astype(np.int64)
    rgb = [y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]]
    if k is None:
        return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)
    cmy = [np.clip(255 - p, 0, 255) for p in rgb]
    return np.stack(cmy + [k.astype(np.int64)], -1).astype(np.uint8)


# -- the IDCT ------------------------------------------------------------------------


def _blocks(kind, n=512, seed=0):
    """(levels (n, 64) i16, table (64,)) of a kind of block."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 256, 64)
    lv = np.zeros((n, 64), np.int64)
    if kind == "encoder":  # the levels an encoder writes: small, sparse
        q = jpeg_writer.quality_tables(75)[0]
        lv[:, 0] = rng.integers(-64, 64, n)
        mask = rng.random((n, 63)) < 0.2
        lv[:, 1:][mask] = rng.integers(-20, 21, mask.sum())
    elif kind == "extreme":  # products and sums past 16 bits
        mask = rng.random((n, 64)) < 0.6
        lv[mask] = rng.integers(-1023, 1024, mask.sum())
    elif kind == "dc_only":  # pass 1's shortcut, its 16-bit shift
        lv[:, 0] = rng.integers(-2047, 2048, n)
    elif kind == "table_16_bit":  # a 16-bit DQT: pmullw keeps 16 bits
        q = rng.integers(1, 65536, 64)
        mask = rng.random((n, 64)) < 0.3
        lv[mask] = rng.integers(-300, 301, mask.sum())
    else:  # one AC level a block, anywhere
        lv[np.arange(n), rng.integers(1, 64, n)] = rng.integers(-1023, 1024, n)
        lv[:, 0] = rng.integers(-1000, 1000, n)
    return lv.astype(np.int16), q


@pytest.mark.parametrize("kind", ["encoder", "extreme", "dc_only",
                                  "table_16_bit", "one_ac"])
def test_plain_islow_is_the_simd_transcription(kind):
    lv, q = _blocks(kind)
    qt = torch.from_numpy(_w16(q).astype(np.int16))
    got = jp.idct_plain(torch.from_numpy(lv.reshape(8, -1, 64)), qt)
    want = idct_plane_reference(lv.reshape(8, -1, 64), q)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("quality", [50, 90, 100])
def test_simd_and_c_islow_agree_on_encoder_levels(quality):
    """On the levels an encoder writes from 8-bit samples (a noisy 4:4:4
    picture) the two islow versions are one function; on hostile ones they
    part (which is why Pillow was probed)."""
    rng = np.random.default_rng(quality)
    img = np.clip(_picture(96, 64) + rng.normal(0, 40, (64, 96, 3)), 0,
                  255).astype(np.uint8)
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(_pil_jpeg(img, 0,
                                                               quality))
    for c, t in zip(coeffs, hdr.comp_tq):
        lv = c.reshape(-1, 64)
        assert np.array_equal(islow_reference(lv, qtabs[t]),
                              islow_c(lv, qtabs[t]))
    lv, q = _blocks("extreme")
    assert (islow_reference(lv, q) != islow_c(lv, q)).mean() > 0.1


def _gray_jpeg(levels, q) -> bytes:
    by, bx = levels.shape[:2]
    return jpeg_writer.write([levels], [q], bx * 8, by * 8, [(1, 1)])


@pytest.mark.parametrize("kind", ["extreme", "dc_only", "one_ac"])
def test_range_limit_is_pillows(kind):
    """Gray JPEGs of hostile levels (the writer's baseline ranges, 8-bit
    tables): Pillow's decode equals the SIMD transcription and the plain
    version, and differs from ``jidctint.c``'s wrapping table."""
    lv, q = _blocks(kind, 8 * 16, seed=3)
    lv = lv.reshape(8, 16, 64)
    if kind == "dc_only":  # DC differences within 11 bits
        lv[..., 0] = np.clip(np.cumsum(np.random.default_rng(1).integers(
            -900, 900, 128)), -2047, 2047).reshape(8, 16)
    want = np.asarray(Image.open(io.BytesIO(_gray_jpeg(lv, q))))
    assert np.array_equal(idct_plane_reference(lv, q), want)
    got = jp.idct_plain(torch.from_numpy(lv),
                        torch.from_numpy(_w16(q).astype(np.int16)))
    assert np.array_equal(got.numpy(), want)
    by, bx = lv.shape[:2]
    c = islow_c(lv.reshape(-1, 64), q).reshape(by, bx, 8, 8)
    assert (c.transpose(0, 2, 1, 3).reshape(want.shape) != want).any()


# -- the upsample and the colour step --------------------------------------------


UPSAMPLES = [("h2v1", 9, 13), ("h2v1", 5, 3), ("h1v2", 7, 11), ("h1v2", 1, 2),
             ("h2v2", 9, 13), ("h2v2", 3, 3), ("h2v2", 16, 24),
             ("int", 5, 7)]


@pytest.mark.parametrize("method,dh,dw", UPSAMPLES,
                         ids=lambda v: str(v))
def test_upsamplers_are_jdsamples(method, dh, dw):
    """Each upsampler's biases and edges: the maps and the plain version on
    a random plane of ``dh`` x ``dw`` real samples (a grid of whole blocks
    beyond them, filled with noise the edges must not read) against the
    ``jdsample.c`` transcription."""
    rng = np.random.default_rng(dh * 31 + dw)
    plane = rng.integers(0, 256, (-(-dh // 8) * 8, -(-dw // 8) * 8),
                         np.uint8)
    rv, rh = {"h2v1": (1, 2), "h1v2": (2, 1), "h2v2": (2, 2),
              "int": (3, 2)}[method]
    H, W = dh * rv, dw * rh
    bits = jp.fancy_bits(method)
    rows = jp.axis_map(H, rv, bool(bits & jp.ROWS), [(0, 0, dh)])
    cols = jp.axis_map(W, rh, bool(bits & jp.COLS), [(0, 0, dw)])
    got = jp._upsample_plain(torch.from_numpy(plane), torch.from_numpy(rows),
                             torch.from_numpy(cols), bits).numpy()
    if method == "int":
        want = np.repeat(np.repeat(plane[:dh, :dw], rv, 0), rh, 1)
    else:
        want = upsample_reference(plane, method, dh, dw)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_axis_map_restarts_at_each_segment():
    """Two segments of 16 outputs from 8 and 5 real samples: the triangle's
    far sample stops at each segment's edges, the parity restarts."""
    m = jp.axis_map(32, 2, True, [(0, 0, 8), (16, 8, 5)])
    near, far, odd = m
    assert near.tolist() == [i // 2 for i in range(16)] + [
        8 + min(i // 2, 4) for i in range(16)]
    assert far[0] == 0 and far[15] == 7 and far[16] == 8 and far[31] == 12
    assert far[25] == 12 and odd.tolist() == [i % 2 for i in range(32)]


@pytest.mark.parametrize("colour", [jp.YCC, jp.YCCK])
def test_colour_step_is_jdcolors(colour):
    """Every (Cb, Cr) pair at eight luma values, and the K pass-through."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256))
    for y in (0, 1, 37, 128, 200, 254, 255, 17):
        yy = np.full_like(cb, y)
        k = (cb + cr) % 256
        v = [torch.from_numpy(p.astype(np.int32)) for p in (yy, cb, cr, k)]
        got = jp.colour_plain(v[:3] if colour == jp.YCC else v, colour)
        want = colour_reference(yy, cb, cr, None if colour == jp.YCC else k)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_planes_before_the_colour_step_are_libjpegs(subsampling):
    """K6 without its colour step against Pillow's ``draft("YCbCr")``
    (libjpeg's islow and upsample, no colour conversion) of a 203x151
    JPEG."""
    data = _pil_jpeg(make_test_image(203, 151), subsampling=subsampling)
    with Image.open(io.BytesIO(data)) as im:
        im.draft("YCbCr", im.size)
        want = np.asarray(im)
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(data)
    got = jp.decode(jp.frame_plan(hdr, coeffs, qtabs, jp.NONE),
                    torch.device("cpu"))
    assert np.array_equal(got.numpy(), want)


# -- every layout, byte for byte the reference's decode ------------------------


def _pil_jpeg(img, subsampling=0, quality=90, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality,
                              subsampling=subsampling, **kw)
    return buf.getvalue()


def _pil_gray(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert("L").save(buf, "JPEG", quality=85, **kw)
    return buf.getvalue()


def _distinct_tables() -> list:
    base = np.arange(1, 65)
    return [list(base % 20 + 2), list(base % 23 + 3), list(base % 29 + 5)]


#: the writer's samplings, (h, v) of each component
SAMPLED = {
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "410": ((4, 2), (1, 1), (1, 1)),
    "ratio_3": ((3, 1), (1, 1), (1, 1)),
    "ratio_3_vertical": ((1, 3), (1, 1), (1, 1)),
    "cb11_cr21": ((2, 2), (1, 1), (2, 1)),
    "luma_below": ((1, 1), (2, 2), (2, 2)),
    "cmyk_420_k_full": ((2, 2), (1, 1), (1, 1), (2, 2)),
    "cmyk_mixed": ((2, 2), (2, 1), (1, 1), (1, 2)),
    "cmyk_ratio_4": ((4, 1), (1, 1), (1, 1), (4, 1)),
}


def _written(name, img, arithmetic=False, progressive=None, **kw):
    samp = SAMPLED[name]
    colour = "raw" if len(samp) == 4 else "ycbcr"
    pic = (np.concatenate([img, img[..., :1] // 2], -1)
           if len(samp) == 4 else img)
    planes, tabs, tq = jpeg_writer.coefficients(pic, 85, samp, colour)
    h, w = img.shape[:2]
    if arithmetic:
        return jpeg_arith_writer.write(planes, tabs, w, h, samp, tq,
                                       progressive=progressive, **kw)
    return jpeg_writer.write(planes, tabs, w, h, samp, tq, **kw)


LAYOUTS = {
    "444": lambda img: _pil_jpeg(img, 0),
    "422": lambda img: _pil_jpeg(img, 1),
    "420": lambda img: _pil_jpeg(img, 2),
    "420_distinct_tables": lambda img: _pil_jpeg(
        img, 2, qtables=_distinct_tables()),
    "420_progressive": lambda img: _pil_jpeg(img, 2, progressive=True),
    "444_progressive_q97": lambda img: _pil_jpeg(img, 0, 97,
                                                 progressive=True),
    "gray": lambda img: _pil_gray(img),
    "gray_progressive": lambda img: _pil_gray(img, progressive=True),
    "cmyk": lambda img: _cmyk_of(img, -1, False),
    "cmyk_420": lambda img: _cmyk_of(img, 2, False),
    "ycck_422": lambda img: _cmyk_of(img, 1, True),
    "ycck_420_progressive": lambda img: _cmyk_of(img, 2, True,
                                                 progressive=True),
    **{name: (lambda n: lambda img: _written(n, img))(name)
       for name in SAMPLED},
    "ycck_mixed": lambda img: _written("cmyk_mixed", img, adobe_transform=2),
    "411_scan_a_component": lambda img: _written("411", img,
                                                 interleaved=False,
                                                 restart=3),
    "420_arithmetic": lambda img: _arith(img, ((2, 2), (1, 1), (1, 1))),
    "422_arithmetic_progressive": lambda img: _arith(
        img, ((2, 1), (1, 1), (1, 1)), progressive=True),
    "444_arithmetic_restarts": lambda img: _arith(
        img, ((1, 1), (1, 1), (1, 1)), restart=2),
}


def _cmyk_of(img, subsampling, ycck, **kw) -> bytes:
    data = _save_cmyk(img, subsampling, **kw)
    if ycck:
        at = data.index(b"Adobe") + 11
        data = data[:at] + b"\x02" + data[at + 1:]
    return data


def _save_cmyk(img, subsampling, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=90,
                                              subsampling=subsampling, **kw)
    return buf.getvalue()


def _arith(img, samp, **kw) -> bytes:
    planes, tabs, tq = jpeg_writer.coefficients(img, 60, samp)
    h, w = img.shape[:2]
    return jpeg_arith_writer.write(planes, tabs, w, h, samp, tq, **kw)


SIZES = [(203, 151), (17, 9), (2, 5), (1, 1)]
#: the arithmetic writer codes a decision at a time in Python
SMALL_ONLY = ("420_arithmetic", "422_arithmetic_progressive",
              "444_arithmetic_restarts")


def _layout_cases():
    return [(name, size) for name in LAYOUTS for size in SIZES
            if name not in SMALL_ONLY or size != SIZES[0]] + [
        (name, (61, 37)) for name in SMALL_ONLY]


def _case_id(case):
    name, (w, h) = case
    return f"{name}-{w}x{h}"


def _picture(w, h, seed=0):
    rng = np.random.default_rng(seed + w * 7 + h)
    img = make_test_image(w, h).astype(np.int16)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("case", _layout_cases(), ids=_case_id)
def test_layout_decodes_as_the_reference(case):
    name, (w, h) = case
    data = LAYOUTS[name](_picture(w, h))
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (h, w, 3)
    assert np.array_equal(got, want)


#: JPEG TIFF pages: make_jpeg_tiff's options
PAGES = {
    "ycbcr_420_strips_16": dict(samp=(2, 2), rows=16),
    "ycbcr_420_strips_32": dict(samp=(2, 2), rows=32),
    "ycbcr_422_strips_8": dict(samp=(2, 1), rows=8),
    "ycbcr_444_strips_8": dict(samp=(1, 1), rows=8),
    "ycbcr_420_tiles_16": dict(samp=(2, 2), tile=16),
    "ycbcr_420_tiles_32": dict(samp=(2, 2), tile=32),
    "ycbcr_422_tiles_48": dict(samp=(2, 1), tile=48),
    "gray_tiles_16": dict(gray=True, tile=16),
    "gray_strips_8_no_tables": dict(gray=True, rows=8, tables=False),
}


@pytest.mark.parametrize("size", [(203, 151), (17, 9), (37, 50)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(PAGES))
def test_jpeg_tiff_page_decodes_as_the_reference(name, size):
    """Strips (the last one short) and tiles (the edge ones past the image),
    each a JPEG libjpeg upsamples alone."""
    w, h = size
    data = make_jpeg_tiff(_picture(w, h, 5), 85, **PAGES[name])
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (h, w, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rows", [16, 24, 151])
def test_pillows_own_jpeg_tiff_decodes_as_the_reference(rows):
    """Pillow's JPEG TIFF writer (libtiff, YCbCr 4:2:0 strips)."""
    buf = io.BytesIO()
    Image.fromarray(_picture(203, 151, 9)).save(
        buf, "TIFF", compression="jpeg", tiffinfo={278: rows}, quality=85)
    data = buf.getvalue()
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0],
                          ref_codecs.decode_bytes(data)[0])


# -- the engine and the apps -----------------------------------------------------


def count_k6(monkeypatch):
    """Record each K6 decode (two launches on a card) by its component
    count."""
    calls = []
    real = jp.decode_pixels

    def count(x):
        calls.append(len(x.coeffs))
        return real(x)

    monkeypatch.setattr(jp, "decode_pixels", count)
    return calls


@pytest.mark.parametrize("name,want", [("444", [3]), ("gray", [1]),
                                       ("cmyk_420", [4]), ("411", [3]),
                                       ("420_arithmetic", [3])])
def test_one_k6_decode_a_request(monkeypatch, name, want):
    calls = count_k6(monkeypatch)
    before = jp.LAUNCHES
    codecs.decode_bytes(LAYOUTS[name](_picture(61, 37)), device="cpu")
    assert calls == want
    assert jp.LAUNCHES == before  # the plain version on the CPU


#: sources served through both apps
SERVED = {
    "422": lambda: LAYOUTS["422"](_picture(96, 72)),
    "411": lambda: LAYOUTS["411"](_picture(96, 72)),
    "ycck": lambda: _cmyk((96, 72), 2, ycck=True),
    "tiff_tiles": lambda: make_jpeg_tiff(_picture(96, 72, 3), 85, samp=(2, 2),
                                         tile=32),
}


def _jpeg_pixels(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


@pytest.mark.parametrize("name", sorted(SERVED))
def test_http_bodies_are_the_references(tmp_path, name):
    """``/img`` with no resize and at w=48 (JPEG out) and ``/upload`` at
    w=48 through both apps: the same status and type; unresized, the same
    body (the same pixels into the same JPEG encode); resized, decoded
    within K2's band against the JAX resize (+-1 on at most 0.1% before the
    encode, which the JPEG step can grow: here max |d| <= 2)."""
    data = SERVED[name]()

    async def fn(client):
        outs = [await _img(client, url=_url("s"), f="jpeg"),
                await _img(client, url=_url("s"), w=48, f="jpeg")]
        form = FormData()
        form.add_field("file", data, filename="x")
        form.add_field("w", "48")
        form.add_field("f", "jpeg")
        r = await client.post("/upload", data=form)
        return outs + [(r.status, r.headers.get("Content-Type"),
                        await r.read())]

    ref = _serve(tmp_path, "ref", {"s": data}, fn)
    port = _serve(tmp_path, "port", {"s": data}, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) == (200, "image/jpeg"), pb[:200]
    assert port[0][2] == ref[0][2]
    for (_, _, rb), (_, _, pb) in zip(ref[1:], port[1:]):
        a, b = _jpeg_pixels(pb), _jpeg_pixels(rb)
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


# -- the kernel source under the CPU shim -----------------------------------------


@pytest.fixture(scope="module")
def k6_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("k6_cpu")
    (d / "cuda_runtime.h").write_text(SHIM)
    so = d / "libk6_cpu.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-Wall",
                    "-Werror", "-I", str(d), "-x", "c++",
                    str(CSRC / "jpeg_pixels.cu"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    _build.configure_pixels(lib)
    return lib


def _launch(lib, x):
    planes = [torch.full((c.shape[0] * 8, c.shape[1] * 8), 77, dtype=torch.uint8)
              for c in x.coeffs]
    out = torch.empty((x.height, x.width, len(x.coeffs)), dtype=torch.uint8)
    rec = jp.record(x, planes, out)
    for fn in (lib.ik_jpeg_idct, lib.ik_jpeg_upcolour):
        rc = fn(ctypes.byref(rec), None)
        if rc:
            return rc
    return out


KERNEL_CASES = ["420", "422", "444", "gray", "cmyk_420", "ycck_422",
                "411", "luma_below", "cb11_cr21", "ycck_mixed"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_source_matches_plain(k6_lib, name):
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(
        LAYOUTS[name](_picture(75, 41)))
    x = jp.upload(jp.frame_plan(hdr, coeffs, qtabs, dct.frame_colour(hdr)),
                  torch.device("cpu"))
    got = _launch(k6_lib, x)
    assert np.array_equal(got.numpy(), jp.decode_pixels_plain(x).numpy())


@pytest.mark.parametrize("name", ["ycbcr_420_tiles_16", "ycbcr_422_strips_8"])
def test_kernel_source_matches_plain_on_a_page(k6_lib, name):
    page = tiff.entropy_decode(make_jpeg_tiff(_picture(75, 41), 85,
                                              **PAGES[name]))
    x = jp.upload(dct.page_plan(page), torch.device("cpu"))
    assert np.array_equal(_launch(k6_lib, x).numpy(),
                          jp.decode_pixels_plain(x).numpy())


def test_kernel_source_takes_hostile_levels(k6_lib):
    lv, q = _blocks("extreme", 6 * 5)
    hdr_q = np.stack([q])
    plan = jp.Plan([lv.reshape(6, 5, 64)], hdr_q,
                   [jp.axis_map(48, 1, False, [(0, 0, 48)])],
                   [jp.axis_map(40, 1, False, [(0, 0, 40)])], (0,), jp.NONE,
                   48, 40)
    x = jp.upload(plan, torch.device("cpu"))
    got = _launch(k6_lib, x).numpy()[..., 0]
    assert np.array_equal(got, idct_plane_reference(lv.reshape(6, 5, 64), q))


@pytest.mark.parametrize("field,value", [("ncomp", 0), ("ncomp", 5),
                                         ("colour", 3), ("H", 0),
                                         ("H", 70000), ("W", 0)])
def test_kernel_source_refuses_bad_records(k6_lib, field, value):
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(LAYOUTS["420"](
        _picture(32, 16)))
    x = jp.upload(jp.frame_plan(hdr, coeffs, qtabs, jp.YCC),
                  torch.device("cpu"))
    planes = [torch.empty((c.shape[0] * 8, c.shape[1] * 8), dtype=torch.uint8)
              for c in x.coeffs]
    out = torch.empty((16, 32, 3), dtype=torch.uint8)
    rec = jp.record(x, planes, out)
    setattr(rec, field, value)
    for fn in (k6_lib.ik_jpeg_idct, k6_lib.ik_jpeg_upcolour):
        assert fn(ctypes.byref(rec), None) != 0


def test_kernel_source_refuses_ycc_on_four_components(k6_lib):
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(LAYOUTS["cmyk"](
        _picture(16, 16)))
    x = jp.upload(jp.frame_plan(hdr, coeffs, qtabs, jp.NONE),
                  torch.device("cpu"))
    planes = [torch.empty((16, 16), dtype=torch.uint8) for _ in range(4)]
    rec = jp.record(x, planes, torch.empty((16, 16, 4), dtype=torch.uint8))
    rec.colour = jp.YCC
    assert k6_lib.ik_jpeg_idct(ctypes.byref(rec), None) != 0


# -- the wrapper's refusals --------------------------------------------------------


def _inputs(name="420", size=(32, 16)):
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(LAYOUTS[name](
        _picture(*size)))
    return jp.upload(jp.frame_plan(hdr, coeffs, qtabs, dct.frame_colour(hdr)),
                     torch.device("cpu"))


def _with(x, **kw):
    import dataclasses

    return dataclasses.replace(x, **kw)


REFUSALS = {
    "float_levels": lambda x: _with(x, coeffs=[c.float() for c in x.coeffs]),
    "flat_levels": lambda x: _with(x, coeffs=[c.reshape(-1, 64)
                                              for c in x.coeffs]),
    "int32_tables": lambda x: _with(x, qt=x.qt.int()),
    "short_row_map": lambda x: _with(x, rows=[r[:, :-1] for r in x.rows]),
    "strided_map": lambda x: _with(x, cols=[c.t().contiguous().t()
                                            for c in x.cols]),
    "ycck_on_three": lambda x: _with(x, colour=jp.YCCK),
    "five_components": lambda x: _with(
        x, coeffs=x.coeffs + x.coeffs[:2], rows=x.rows + x.rows[:2],
        cols=x.cols + x.cols[:2], fancy=x.fancy + x.fancy[:2]),
    "bad_fancy": lambda x: _with(x, fancy=(4, 0, 0)),
    "meta_device": lambda x: _with(x, qt=x.qt.to("meta")),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernels_do_not_take(name):
    x = REFUSALS[name](_inputs())
    with pytest.raises((TypeError, ValueError)):
        jp.decode_pixels(x)


def test_upload_refuses_maps_that_leave_the_plane():
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(LAYOUTS["420"](
        _picture(32, 16)))
    plan = jp.frame_plan(hdr, coeffs, qtabs, jp.YCC)
    plan.cols[1][0, -1] = 16
    with pytest.raises(ValueError, match="leave"):
        jp.upload(plan, torch.device("cpu"))


def test_frame_plan_refuses_a_fractional_ratio():
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(LAYOUTS["420"](
        _picture(32, 16)))
    import dataclasses

    hdr = dataclasses.replace(hdr, comp_h=(2, 3, 1), hmax=3)
    with pytest.raises(ValueError, match="fractional"):
        jp.frame_plan(hdr, coeffs, qtabs, jp.YCC)


def test_every_entry_decodes_the_same_pixels():
    """``codecs.decode_bytes``, ``jpeg.decode_rgb`` and ``dct.
    decode_components_to_rgb`` on one 4:2:2 JPEG."""
    data = LAYOUTS["422"](_picture(61, 37))
    a = codecs.decode_bytes(data, device="cpu")[0]
    b = jpeg.decode_rgb(data, device="cpu")
    c = dct.decode_components_to_rgb(jpeg_abi.decode(loader.load(), data),
                                     device="cpu")
    assert np.array_equal(a, b) and np.array_equal(a, c)


def test_incomplete_progressive_frame_is_a_known_difference():
    """libjpeg smooths the blocks of a progressive frame whose scans leave
    some of the first AC coefficients unrefined (``jdcoefct.c::
    decompress_smooth_data``), and so does the port
    (``codecs/jpeg_smoothing.py``): Pillow's own progressive 4:2:0 file,
    whole and cut after each of its first 9 of 10 scans (an EOI appended),
    decodes byte for byte. Before the port smoothed, the cuts after 1, 3
    and 8 scans differed by up to 38, 11 and 3 (27.6, 41.7 and 53.7 dB);
    the name is kept from then."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(96, 64)).save(
        buf, "JPEG", quality=90, progressive=True, subsampling=2)
    data = buf.getvalue()
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) == 10
    for cut in [data[:at] + b"\xff\xd9" for at in sos[1:]] + [data]:
        got = codecs.decode_bytes(cut, device="cpu")[0]
        want = ref_codecs.decode_bytes(cut)[0]
        assert got.shape == want.shape and np.array_equal(got, want)


# -- corrupt scans: differences found, not repaired (ROADMAP queue 3) ----------


def _flipped(progressive, at, value) -> bytes:
    """Pillow's 96x64 4:2:0 q90 file with byte ``at`` set to ``value``."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(96, 64)).save(
        buf, "JPEG", quality=90, subsampling=2, progressive=progressive)
    data = bytearray(buf.getvalue())
    data[at] = value
    return bytes(data)


def test_corrupt_refinement_scan_is_a_known_difference():
    """A byte of the last AC refinement scan changed: the pinned entropy
    decoder reads on past the bad code otherwise than libjpeg, and 7
    blocks come out up to 5 off Pillow's pixels. libjpeg's own walk
    (``jpeg_abi.decode_libjpeg``) gives Pillow's pixels: the repair
    ROADMAP names."""
    data = _flipped(True, 2008, 57)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    d = np.abs(got.astype(int) - want.astype(int))
    assert 0 < d.max() <= 5
    blocks = {(y // 8, x // 8) for y, x in zip(*np.nonzero(d.max(-1)))}
    assert len(blocks) == 7
    hdr = jpeg.source_header(loader.load(), data)
    _, coeffs, qtabs, unread = jpeg_abi.decode_libjpeg(
        loader.load(), data, jpeg_abi.PILLOW_BLOCK)
    assert unread is None
    assert np.array_equal(dct.decode_components_to_rgb(
        (hdr, coeffs, qtabs), device="cpu"), want)


def test_marker_inside_a_baseline_scan_is_a_known_difference():
    """0xFF 0x1D written into a baseline scan: libjpeg ends the scan there
    and then refuses the unknown marker, Pillow's "broken data stream"
    (the reference's 400); the port's pinned decoder decodes the file."""
    data = _flipped(False, 632, 255)
    assert data[632:634] == b"\xff\x1d"
    with pytest.raises(Exception, match="broken data stream"):
        ref_codecs.decode_bytes(data)
    assert codecs.decode_bytes(data, device="cpu")[0].shape == (64, 96, 3)
