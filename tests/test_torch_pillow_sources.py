"""The sources the reference decodes only with Pillow, in the port, on the
CPU: ICO, PNM (P1-P6), QOI, DDS, and CMYK and YCCK JPEGs.

The reference hands them to ``pil_backend.decode`` (at its fetch stage for
``/img``); the port decodes them with its own modules (``codecs/ico.py``,
``pnm.py``, ``qoi.py``, ``dds.py`` on ``native/raster_decode.cpp``; CMYK and
YCCK through ``native/jpeg4_decode.cpp``, ``ops/dct.py::
decode_components_to_rgb`` (K6) and ``ops/color.py::cmyk_to_rgb``) and hands the
pixels to the batched RGB head (three channels) or its four-channel entry.
The inputs are made from numpy seeds and written by Pillow, or by hand
where Pillow writes no such file (plain PNM, a maxval other than 255 or
65535, DDS blocks of random bytes, ICO AND masks of random bits).

- ICO, PNM, QOI and DDS: exactly the pixels and channel count of the JAX
  package's ``decode_bytes`` (Pillow), and the header parse gives the
  decoded geometry.
- CMYK and YCCK, at Pillow's default sampling (all 1x1), C at 2x2 and C at
  2x1: (a) the four planes K6 hands the colour step exactly libjpeg's
  (Pillow's ``CMYK;I`` read, inverted back); (b) the colour step exactly
  Pillow's ``Image.frombytes("CMYK", ..., "CMYK;I").convert("RGB")`` on
  the same u8 planes, and YCCK exactly libjpeg's ``ycck_cmyk_convert``
  before it; (c) the whole decode byte for byte against Pillow. The
  committed 1080p fixture the card run reads is checked against its
  recipe.
- Both engines and both apps, at w=64 WebP and JPEG and with no resize:
  statuses, content types and output sizes equal, outputs decoded at
  >= 38 dB; the port's metrics show the RGB head's batch and, for CMYK,
  the pixel decode. ``POST /upload`` of an ICO and a CMYK JPEG. A source
  cut at a third answers as the reference's fetch stage does.
"""

import asyncio
import io
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import config as ref_config
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu.utils.bucketing import bucket_for
from imagekit_tpu_torch import codecs, fetch, transform
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import dds, ico, jpeg, pnm, qoi, vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.errors import (
    InvalidArgumentError,
    NotPortedError,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.ops import color, dct, jpeg_pixels, weights
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.signature import sign
from tests.conftest import make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_rgba_slice import _cfg, _drive, _out_size
from tests.test_torch_webp_slice import _CannedFetcher

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "cmyk_1080p_q80.jpg"
SECRET = "test-secret-key"
MAX_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock, and a
    worker whose first load meets another's half-written build would
    decode through Pillow alone)."""
    _ref_native_lib(monkeypatch)


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))


def _save(im, fmt, **kw) -> bytes:
    if not isinstance(im, Image.Image):
        im = Image.fromarray(im)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _rgb(w=83, h=57, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _photo(w=83, h=57, alpha=False):
    img = make_test_image(w, h)
    if not alpha:
        return img
    a = (np.add.outer(np.arange(h), np.arange(w)) * 255 // (h + w)).astype(
        np.uint8)
    return np.dstack([img, a])


# -- PNM -------------------------------------------------------------------------


def _pnm(magic: bytes, w: int, h: int, maxval, samples, plain=False,
         comments=False) -> bytes:
    """A PNM written by hand: binary (big-endian past 255) or plain, with
    comments in the header and, plain, in the raster."""
    c = b"# a comment\n" if comments else b""
    head = magic + b"\n" + c + b"%d %d\n" % (w, h) + c
    if maxval is not None:
        head += b"%d\n" % maxval
    if not plain:
        return head + samples.astype(">u2" if maxval and maxval > 255
                                     else np.uint8).tobytes()
    flat = samples.ravel()
    sep = b"" if magic == b"P1" else b" "
    rows = [sep.join(b"%d" % v for v in flat[i:i + 17])
            for i in range(0, flat.size, 17)]
    if comments:
        rows.insert(len(rows) // 2, b"#  mid-raster comment")
    return head + b"\n".join(rows) + b"\n"


def _samples(shape, maxval, seed=1):
    return np.random.default_rng(seed).integers(0, maxval + 1, shape)


PNM = {
    "p1_plain": lambda: _pnm(b"P1", 29, 17, None, _samples((17, 29), 1),
                             plain=True, comments=True),
    "p2_plain_m15": lambda: _pnm(b"P2", 29, 17, 15, _samples((17, 29), 15),
                                 plain=True, comments=True),
    "p2_plain_m4095": lambda: _pnm(b"P2", 29, 17, 4095,
                                   _samples((17, 29), 4095), plain=True),
    "p3_plain_m255": lambda: _pnm(b"P3", 29, 17, 255,
                                  _samples((17, 29, 3), 255), plain=True,
                                  comments=True),
    "p3_plain_m1": lambda: _pnm(b"P3", 29, 17, 1, _samples((17, 29, 3), 1),
                                plain=True),
    "p4_pillow": lambda: _save(Image.fromarray(_rgb()).convert("1"), "PPM"),
    "p5_pillow": lambda: _save(Image.fromarray(_rgb()).convert("L"), "PPM"),
    "p5_pillow_16bit": lambda: _save(Image.fromarray(
        _samples((57, 83), 65535).astype(np.uint16)).convert("I;16"), "PPM"),
    "p5_m15": lambda: _pnm(b"P5", 83, 57, 15, _samples((57, 83), 15)),
    "p5_m4095": lambda: _pnm(b"P5", 83, 57, 4095, _samples((57, 83), 4095)),
    "p6_pillow": lambda: _save(_rgb(), "PPM"),
    "p6_m1": lambda: _pnm(b"P6", 83, 57, 1, _samples((57, 83, 3), 1)),
    "p6_m15": lambda: _pnm(b"P6", 83, 57, 15, _samples((57, 83, 3), 15)),
    "p6_m15_over": lambda: _pnm(b"P6", 83, 57, 15,
                                _samples((57, 83, 3), 255)),
    "p6_m4095": lambda: _pnm(b"P6", 83, 57, 4095,
                             _samples((57, 83, 3), 4095)),
    "p6_m65535": lambda: _pnm(b"P6", 83, 57, 65535,
                              _samples((57, 83, 3), 65535)),
    "p6_comments": lambda: _pnm(b"P6", 83, 57, 255,
                                _samples((57, 83, 3), 255), comments=True),
}


# -- QOI -------------------------------------------------------------------------


def _qoi_image(alpha: bool, w=83, h=57):
    """Bands that make Pillow's encoder write every chunk kind: a flat band
    (runs), four colours taking turns (index), steps of 1 (diff), steps of
    9 in green (luma), noise (RGB) and, with alpha, changing alpha (RGBA)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img[0:10] = (40, 90, 200)
    pal = np.array([[10, 20, 30], [200, 10, 10], [0, 255, 0], [9, 9, 9]])
    img[10:20] = pal[np.arange(w) % 4]
    img[20:30] = ((np.arange(w)[:, None] + np.array([5, 60, 120])) % 256)
    img[30:40] = ((np.arange(w)[:, None] * np.array([8, 9, 10])) % 256)
    if not alpha:
        return img
    a = np.full((h, w, 1), 255, np.uint8)
    a[45:] = rng.integers(0, 256, (h - 45, w, 1))
    return np.concatenate([img, a], axis=2)


def _qoi_ops(data: bytes) -> set:
    """The chunk kinds of a QOI stream."""
    w, h = struct.unpack(">II", data[4:12])
    ops, pos, n = set(), 14, 0
    while n < w * h:
        b = data[pos]
        pos += 1
        kind = {0xfe: "rgb", 0xff: "rgba"}.get(
            b, ("index", "diff", "luma", "run")[b >> 6])
        ops.add(kind)
        pos += {"rgb": 3, "rgba": 4, "luma": 1}.get(kind, 0)
        n += (b & 0x3f) + 1 if kind == "run" else 1
    return ops


QOI = {
    "qoi_rgb": lambda: _save(_qoi_image(False), "QOI"),
    "qoi_rgba": lambda: _save(_qoi_image(True), "QOI"),
    "qoi_photo": lambda: _save(_photo(alpha=True), "QOI"),
}


# -- DDS -------------------------------------------------------------------------


def _random_blocks(data: bytes, seed: int) -> bytes:
    """A Pillow-written block-compressed DDS with its blocks replaced by
    random bytes: every colour mode (BC1's transparent index too) and every
    alpha ramp."""
    off = 148 if data[84:88] == b"DX10" else 128
    rnd = np.random.default_rng(seed).integers(0, 256, len(data) - off,
                                               np.uint8)
    return data[:off] + rnd.tobytes()


def _patched(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


DDS = {
    "dds_rgb": lambda: _save(_rgb(), "DDS"),
    "dds_rgba": lambda: _save(np.dstack([_rgb(), _rgb(seed=1)[:, :, 0]]),
                              "DDS"),
    "dds_l": lambda: _save(Image.fromarray(_rgb()).convert("L"), "DDS"),
    "dds_la": lambda: _save(Image.fromarray(_photo(alpha=True)).convert("LA"),
                            "DDS"),
    "dxt1": lambda: _save(_photo(alpha=True), "DDS", pixel_format="DXT1"),
    "dxt1_random": lambda: _random_blocks(
        _save(_photo(alpha=True), "DDS", pixel_format="DXT1"), 1),
    "dxt3": lambda: _save(_photo(alpha=True), "DDS", pixel_format="DXT3"),
    "dxt3_random": lambda: _random_blocks(
        _save(_photo(alpha=True), "DDS", pixel_format="DXT3"), 2),
    "dxt5": lambda: _save(_photo(alpha=True), "DDS", pixel_format="DXT5"),
    "dxt5_random": lambda: _random_blocks(
        _save(_photo(alpha=True), "DDS", pixel_format="DXT5"), 3),
    "bc2_dx10": lambda: _save(_photo(alpha=True), "DDS", pixel_format="BC2"),
    "bc3_dx10": lambda: _save(_photo(alpha=True), "DDS", pixel_format="BC3"),
    "bc5": lambda: _save(_photo(), "DDS", pixel_format="BC5"),
    "bc5_random": lambda: _random_blocks(
        _save(_photo(), "DDS", pixel_format="BC5"), 4),
    "bc5_ati2": lambda: _patched(_random_blocks(
        _save(_photo(), "DDS", pixel_format="BC5"), 5), 84, b"ATI2"),
}


def _dxt1_modes(data: bytes):
    """(four-colour, three-colour) block counts of a DXT1 DDS."""
    c = np.frombuffer(data[128:], "<u2").reshape(-1, 4)
    return int((c[:, 0] > c[:, 1]).sum()), int((c[:, 0] <= c[:, 1]).sum())


def test_dxt1_fixtures_hold_both_colour_modes():
    assert min(_dxt1_modes(DDS["dxt1_random"]())) > 10
    assert _dxt1_modes(DDS["dxt1"]())[0] > 0


# -- ICO -------------------------------------------------------------------------


def _ico_entries(data: bytes):
    n = struct.unpack("<H", data[4:6])[0]
    return [struct.unpack("<BBBBHHII", data[6 + 16 * i:22 + 16 * i])
            for i in range(n)]


def _random_masks(data: bytes, seed: int) -> bytes:
    """Random AND masks in every BMP entry below 32 bits a pixel (Pillow
    writes them all clear)."""
    out = bytearray(data)
    rng = np.random.default_rng(seed)
    for w, h, _, _, _, bpp, size, off in _ico_entries(data):
        if bpp >= 32 or out[off:off + 8] == b"\x89PNG\r\n\x1a\n":
            continue
        w, h = w or 256, h or 256
        total = (w + 31) // 32 * 4 * h
        out[off + size - total:off + size] = rng.integers(
            0, 256, total, np.uint8).tobytes()
    return bytes(out)


def _ico_image(mode, size=64):
    img = Image.fromarray(_photo(size, size, alpha=True))
    return img if mode == "RGBA" else img.convert(mode)


ICO = {
    "ico_png_rgba": lambda: _save(_ico_image("RGBA"), "ICO",
                                  sizes=[(16, 16), (48, 48), (32, 32)]),
    "ico_png_rgb": lambda: _save(_ico_image("RGB"), "ICO",
                                 sizes=[(24, 24), (40, 40)]),
    "ico_bmp32": lambda: _save(_ico_image("RGBA"), "ICO",
                               sizes=[(16, 16), (48, 48)],
                               bitmap_format="bmp"),
    "ico_bmp24_mask": lambda: _random_masks(_save(
        _ico_image("RGB"), "ICO", sizes=[(20, 20), (37, 37)],
        bitmap_format="bmp"), 1),
    "ico_bmp8_mask": lambda: _random_masks(_save(
        _ico_image("L"), "ICO", sizes=[(33, 33)], bitmap_format="bmp"), 2),
    "ico_bmp_palette_mask": lambda: _random_masks(_save(
        _ico_image("P"), "ICO", sizes=[(30, 30)], bitmap_format="bmp"), 3),
    "ico_bmp1_mask": lambda: _random_masks(_save(
        _ico_image("1"), "ICO", sizes=[(35, 35)], bitmap_format="bmp"), 4),
    # one size at two depths: Pillow takes the lower (8 bits, the L entry)
    "ico_bmp_two_depths": lambda: _random_masks(_save(
        _ico_image("RGBA", 48), "ICO", sizes=[(48, 48)], bitmap_format="bmp",
        append_images=[_ico_image("L", 48)]), 5),
}


def test_ico_fixture_with_two_depths_has_them():
    entries = _ico_entries(ICO["ico_bmp_two_depths"]())
    assert sorted(e[5] for e in entries) == [8, 32]


SOURCES = {**PNM, **QOI, **DDS, **ICO}
MODULES = {"p": pnm, "q": qoi, "d": dds, "b": dds, "i": ico}


def _module(name):
    return MODULES[name[0]]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_decode_equals_the_reference(name):
    data = SOURCES[name]()
    want, ref_fmt = ref_codecs.decode_bytes(data)
    got, fmt = codecs.decode_bytes(data, device="cpu")
    assert fmt.value == ref_fmt.value
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape,
                                                             want.shape)
    assert np.array_equal(got, want)
    h, w, ch = got.shape
    assert _module(name).parse(data) == (w, h, ch)
    assert _module(name).decode(data).shape == got.shape


def test_qoi_fixtures_hold_every_chunk_kind():
    assert _qoi_ops(QOI["qoi_rgb"]()) == {"run", "index", "diff", "luma",
                                          "rgb"}
    assert _qoi_ops(QOI["qoi_rgba"]()) == {"run", "index", "diff", "luma",
                                           "rgb", "rgba"}


@pytest.mark.parametrize("name", ["p6_pillow", "p2_plain_m15", "qoi_rgba",
                                  "dxt5", "dds_rgba", "ico_png_rgba",
                                  "ico_bmp24_mask"])
def test_pixel_ceiling_is_the_constant(monkeypatch, name):
    mod = _module(name)
    assert mod.MAX_PIXELS == 2 * 89_478_485
    monkeypatch.setattr(mod, "MAX_PIXELS", 8)
    with pytest.raises(TransformError, match="too large"):
        mod.decode(SOURCES[name]())


def _dx10(dxgi: int) -> bytes:
    return _patched(_save(_photo(alpha=True), "DDS", pixel_format="BC3"), 128,
                    struct.pack("<I", dxgi))


NOT_PORTED = {
    "dds_bc4": lambda: _patched(DDS["bc5"](), 84, b"BC4U"),
    "dds_bc5_signed": lambda: _patched(DDS["bc5"](), 84, b"BC5S"),
    "dds_bc6h": lambda: _dx10(95),
    "dds_bc7": lambda: _dx10(98),
    "dds_dx10_rgba8": lambda: _dx10(28),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_layouts_no_fixture_holds_are_not_ported(name):
    """Pillow reads them and no Pillow here writes them; a header patched
    over another layout's blocks is a file Pillow reads, and the port
    decodes it as the reference does: the same pixels and channel count,
    or (a raw R8G8B8A8 raster over a BC3 file's fewer bytes) the same
    error. ``tests/test_torch_dds_bcn.py`` holds every layout."""
    data = NOT_PORTED[name]()
    try:
        want = ref_codecs.decode_bytes(data)[0]
    except ref_codecs.TransformError as e:
        with pytest.raises(TransformError) as got:
            codecs.decode_bytes(data, device="cpu")
        assert not isinstance(got.value, NotPortedError)
        assert str(got.value) == str(e)
        assert name == "dds_dx10_rgba8"
        return
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)
    h, w, ch = got.shape
    assert dds.parse(data) == (w, h, ch)


BAD = {
    "pnm_p7": lambda: b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\n"
                      b"TUPLTYPE RGB\nENDHDR\n" + bytes(12),
    "pnm_maxval_0": lambda: b"P6\n2 2\n0\n" + bytes(12),
    "pnm_plain_over_maxval": lambda: b"P2\n2 1\n15\n3 16\n",
    "pnm_plain_short": lambda: b"P3\n2 2\n255\n1 2 3\n",
    "pnm_plain_bad_bit": lambda: b"P1\n2 2\n0 1 2 0\n",
    "pnm_header_eof": lambda: b"P6\n83",
    "qoi_zero_width": lambda: b"qoif" + struct.pack(">II", 0, 5) + b"\x03\x00",
    "dds_header_size": lambda: b"DDS " + bytes(128),
    "dds_unknown_fourcc": lambda: _patched(DDS["bc5"](), 84, b"XYZW"),
    "ico_empty": lambda: b"\x00\x00\x01\x00\x00\x00",
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_what_pillow_refuses_is_a_transform_error(name):
    data = BAD[name]()
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


CUT = ["p6_pillow", "p5_m4095", "p3_plain_m255", "qoi_rgba", "dxt1", "bc5",
       "dds_l", "dds_rgb", "ico_png_rgba", "ico_bmp24_mask"]


@pytest.mark.parametrize("name", CUT)
def test_cut_at_a_third_fails_or_pads_as_pillow_does(name):
    """Cut data is an error in both, except an uncompressed RGB DDS, whose
    missing pixels Pillow's reader takes as zeros."""
    data = SOURCES[name]()
    cut = data[:len(data) // 3]
    try:
        want = ref_codecs.decode_bytes(cut)[0]
    except ref_codecs.TransformError:
        want = None
    if want is None:
        with pytest.raises(TransformError):
            codecs.decode_bytes(cut, device="cpu")
    else:
        assert name == "dds_rgb"
        assert np.array_equal(codecs.decode_bytes(cut, device="cpu")[0], want)


# -- CMYK and YCCK JPEGs ---------------------------------------------------------


def _cmyk(size=(203, 151), subsampling=-1, ycck=False, app14=True,
          quality=90) -> bytes:
    data = _save(Image.fromarray(make_test_image(*size)).convert("CMYK"),
                 "JPEG", quality=quality, subsampling=subsampling)
    at = data.index(b"Adobe")
    if ycck:
        data = _patched(data, at + 11, b"\x02")
    if not app14:  # drop the APP14 segment: libjpeg takes CMYK
        seg = at - 4
        n = struct.unpack(">H", data[seg + 2:seg + 4])[0]
        data = data[:seg] + data[seg + 2 + n:]
    return data


#: name -> (C's (h, v) factors, Pillow's subsampling argument)
LAYOUTS = {"1x1": ((1, 1), -1), "c2x2": ((2, 2), 2), "c2x1": ((2, 1), 1)}
CMYK_CASES = [(layout, kind, size) for layout in LAYOUTS
              for kind in ("cmyk", "ycck") for size in ((203, 151), (64, 48))]


def _cmyk_case(case) -> bytes:
    layout, kind, size = case
    return _cmyk(size, LAYOUTS[layout][1], ycck=kind == "ycck")


def _case_id(case):
    layout, kind, (w, h) = case
    return f"{kind}-{layout}-{w}x{h}"


def test_cmyk_fixtures_have_the_layouts_they_name():
    lib = loader.load()
    for case in CMYK_CASES:
        data = _cmyk_case(case)
        with pytest.raises(jpeg_abi.NativeJpegError) as e:
            jpeg_abi.parse(lib, data)  # the pinned decoder refuses four
        assert e.value.code == -3
        hdr = jpeg_abi.parse4(lib, data)
        assert (hdr.comp_h[0], hdr.comp_v[0]) == LAYOUTS[case[0]][0]
        assert hdr.comp_h[1:] == hdr.comp_v[1:] == (1, 1, 1)
        assert hdr.adobe_transform == (2 if case[1] == "ycck" else 0)
    assert jpeg_abi.parse4(lib, _cmyk(app14=False)).adobe_transform == -1


def _pillow_cmyk(data: bytes) -> np.ndarray:
    """libjpeg's four planes of a CMYK or YCCK JPEG (after its YCCK ->
    CMYK step), (H, W, 4) u8: Pillow's CMYK image, which it reads inverted
    (``CMYK;I``), inverted back."""
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "CMYK"
        return 255 - np.asarray(im)


@pytest.mark.parametrize("case", CMYK_CASES, ids=_case_id)
def test_four_planes_match_jax_under_k3(case):
    """The four planes K6 hands the CMYK step against libjpeg's (Pillow's
    ``CMYK;I`` read, inverted back): exactly (the name is kept from when
    the target was the JAX package's IDCT and a K3-semantic resize)."""
    data = _cmyk_case(case)
    before = jpeg_pixels.LAUNCHES
    got = dct.frame_pixels(jpeg_abi.decode4(loader.load(), data),
                           torch.device("cpu")).numpy()
    assert jpeg_pixels.LAUNCHES == before  # the plain version on the CPU
    want = _pillow_cmyk(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def _pillow_cmyk_rgb(planes) -> np.ndarray:
    """Pillow's reading of four stored planes: ``CMYK;I``, then
    ``convert("RGB")``."""
    h, w = planes[0].shape
    raw = np.stack(planes, axis=-1).astype(np.uint8).tobytes()
    return np.asarray(Image.frombytes("CMYK", (w, h), raw, "raw", "CMYK;I")
                      .convert("RGB"))


def _libjpeg_ycck(y, cb, cr):
    """jdcolor.c ``ycck_cmyk_convert`` in Python integers, value by value."""
    def fix(x):
        return int(x * 65536 + 0.5)

    def one(yv, b, r):
        x_b, x_r = int(b) - 128, int(r) - 128
        cr_r = (fix(1.40200) * x_r + 32768) >> 16
        cb_b = (fix(1.77200) * x_b + 32768) >> 16
        g = (-fix(0.34414) * x_b + 32768 - fix(0.71414) * x_r) >> 16
        return [min(255, max(0, 255 - (int(yv) + t))) for t in (cr_r, g, cb_b)]

    flat = [one(*v) for v in zip(y.ravel(), cb.ravel(), cr.ravel())]
    return [np.array(c, np.uint8).reshape(y.shape) for c in zip(*flat)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colour_step_is_pillow_exactly(seed):
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 256, (23, 37), np.uint8) for _ in range(4)]
    planes[3][0], planes[3][1] = 0, 255  # the ends of K
    got = color.cmyk_to_rgb(*(torch.from_numpy(p) for p in planes)).numpy()
    assert np.array_equal(got, _pillow_cmyk_rgb(planes))
    # YCCK: libjpeg's conversion to CMYK (K6's colour step, its plain
    # version here), then the same
    four = jpeg_pixels.colour_plain(
        [torch.from_numpy(p.astype(np.int32)) for p in planes],
        jpeg_pixels.YCCK)
    got = color.cmyk_to_rgb(*four.unbind(-1)).numpy()
    cmy = _libjpeg_ycck(*planes[:3])
    assert np.array_equal(got, _pillow_cmyk_rgb([*cmy, planes[3]]))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("case", CMYK_CASES, ids=_case_id)
def test_cmyk_decode_matches_pillow(case):
    data = _cmyk_case(case)
    got = jpeg.decode_rgb(data, device="cpu")
    pil = _pil_rgb(data)
    assert got.shape == pil.shape and np.array_equal(got, pil)
    arr, fmt = codecs.decode_bytes(data, device="cpu")
    ref_arr, _ = ref_codecs.decode_bytes(data)
    assert fmt == codecs.SourceFormat.jpeg and np.array_equal(arr, got)
    assert ref_arr.shape == got.shape
    assert np.array_equal(transform.decode_image(data, device="cpu")[0], got)


def test_cmyk_without_adobe_segment_is_cmyk():
    data = _cmyk(app14=False)
    assert np.array_equal(jpeg.decode_rgb(data, device="cpu"),
                          _pil_rgb(data))


def test_committed_fixture_is_its_recipe():
    """``tests/fixtures/cmyk_1080p_q80.jpg``, which the card run reads (its
    machine has no Pillow): ``chip_smoke.synth_image(500, noise=False)``,
    converted to CMYK and written by Pillow at q80 with C at 2x2."""
    import chip_smoke

    data = FIXTURE.read_bytes()
    img = chip_smoke.synth_image(500, noise=False)
    remade = _save(Image.fromarray(img).convert("CMYK"), "JPEG", quality=80,
                   subsampling=2)
    assert remade == data
    hdr = jpeg_abi.parse4(loader.load(), data)
    assert (hdr.width, hdr.height, hdr.comp_h, hdr.comp_v,
            hdr.adobe_transform) == (1920, 1080, (2, 1, 1, 1), (2, 1, 1, 1), 0)
    got = jpeg.decode_rgb(data, device="cpu")
    assert np.array_equal(got, _pil_rgb(data)) and psnr(got, img) >= 30.0


def test_progressive_cmyk_stays_not_ported():
    """Progressive CMYK in Huffman coding decodes
    (``tests/test_torch_pillow_fallbacks.py``), and in arithmetic coding
    now too: Pillow's file with its SOF2 marker changed to SOF10, whose
    Huffman bits the QM decoder reads as libjpeg's does, to the pixels
    Pillow gives (the name is kept from when it answered 501). So does a
    lossless CMYK frame, which answered 501 in its place: exactly Pillow's
    pixels."""
    from tests.fixtures import jpeg_lossless_writer

    data = _save(Image.fromarray(make_test_image(64, 48)).convert("CMYK"),
                 "JPEG", progressive=True)
    at = data.index(b"\xff\xc2")
    data = data[:at + 1] + b"\xca" + data[at + 2:]
    got = jpeg.decode_rgb(data, device="cpu")
    want = _pil_rgb(data)
    assert got.shape == want.shape == (48, 64, 3)
    assert np.array_equal(got, want)
    img = make_test_image(64, 48)
    planes = jpeg_lossless_writer.subsample(
        np.dstack([img, img[:, :, 1]]), [(1, 1)] * 4)
    lossless = jpeg_lossless_writer.write(planes, 64, 48, [(1, 1)] * 4)
    assert np.array_equal(jpeg.decode_rgb(lossless, device="cpu"),
                          _pil_rgb(lossless))


def test_cut_cmyk_is_the_fetch_stage_error():
    data = _cmyk()
    with pytest.raises(SourceDecodeError):
        jpeg.decode_to_coefficients(data[:len(data) // 3])


def _oversubscribed_dht(counts: dict) -> bytes:
    """SOI, a 16x16 four-component SOF0, then a DHT whose code counts
    (length -> count) hold more codes than their lengths allow."""
    sof = bytes([8, 0, 16, 0, 16, 4]) + b"".join(
        bytes([c, 0x11, 0]) for c in (1, 2, 3, 4))
    n = [counts.get(length, 0) for length in range(1, 17)]
    dht = bytes([0x00]) + bytes(n) + bytes(i % 256 for i in range(sum(n)))
    return (b"\xff\xd8" + b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
            + b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht)


@pytest.mark.parametrize("counts", [{1: 3}, {1: 255}, {2: 5}, {1: 2, 2: 1},
                                    {1: 2, 9: 1}],
                         ids=["len1_3", "len1_255", "len2_5", "across",
                              "len9"])
def test_oversubscribed_huffman_table_is_refused(counts):
    data = _oversubscribed_dht(counts)
    with pytest.raises(jpeg_abi.NativeJpegError) as e:
        jpeg_abi.parse_any(loader.load(), data)
    assert e.value.code == -4 and e.value.four_components
    with pytest.raises(SourceDecodeError):
        jpeg.decode_to_coefficients(data)
    with pytest.raises(InvalidArgumentError, match="validation"):
        asyncio.run(fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/jpeg", data)})))


# -- the engines -------------------------------------------------------------------


ENGINE_SOURCES = {
    "ico_png": lambda: _save(_ico_image("RGBA", 96), "ICO", sizes=[(96, 96)]),
    "ico_bmp": lambda: _random_masks(_save(_ico_image("RGB", 96), "ICO",
                                           sizes=[(96, 96)],
                                           bitmap_format="bmp"), 6),
    "ppm": lambda: _save(_photo(96, 72), "PPM"),
    "pgm_16bit": lambda: _pnm(b"P5", 96, 72, 65535,
                              _photo(96, 72)[:, :, 0].astype(np.int64) * 257),
    "qoi_rgb": lambda: _save(_photo(96, 72), "QOI"),
    "qoi_rgba": lambda: _save(_photo(96, 72, alpha=True), "QOI"),
    "dds_rgb": lambda: _save(_photo(96, 72), "DDS"),
    "dxt1": lambda: _save(_photo(96, 72, alpha=True), "DDS",
                          pixel_format="DXT1"),
    "dxt5": lambda: _save(_photo(96, 72, alpha=True), "DDS",
                          pixel_format="DXT5"),
    "bc5": lambda: _save(_photo(96, 72), "DDS", pixel_format="BC5"),
    "cmyk": lambda: _cmyk((96, 72), 2),
    "ycck": lambda: _cmyk((96, 72), 2, ycck=True),
}
MODES = [(64, ImageFormat.webp), (64, ImageFormat.jpeg),
         (None, ImageFormat.webp)]


def _mode_id(mode):
    w, fmt = mode
    return f"{fmt.value}-w{w}" if w else f"{fmt.value}-unresized"


def _decoded(out: bytes) -> np.ndarray:
    return vp8.decode_rgb(out) if out[:4] == b"RIFF" else _pil_rgb(out)


def _run_engines(monkeypatch, data, width, fmt):
    """One request through the JAX engine (its RGB head marked compiled
    where it resizes, so that it runs the jitted head and not its host
    mirror) and through the port's on the CPU."""
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    img = ref_codecs.decode_bytes(data)[0]
    (ih, iw), ch = img.shape[:2], img.shape[2]
    _ref_native_lib(monkeypatch)
    ref = RefEngine(_cfg(ref_config, 1), metrics=RefMetrics())
    if width is not None:
        ow, oh = weights.target_dimensions(iw, ih, width, None)
        kind = ("rgb" if ch == 4 else
                "rgbjpg" if fmt == ImageFormat.jpeg else "rgbyuv")
        ref._compiled.add((kind, ref._use_mesh(1), 1, bucket_for(ih),
                           bucket_for(iw), bucket_for(oh), bucket_for(ow),
                           ch))
    (ref_out,) = _drive(ref, [data], [width], fmt)
    port = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    (port_out,) = _drive(port, [data], [width], fmt)
    return ref, port, ref_out, port_out, (iw, ih)


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("name", sorted(ENGINE_SOURCES))
def test_engine_matches_jax_engine(monkeypatch, name, mode):
    width, fmt = mode
    ref, port, ref_out, port_out, (iw, ih) = _run_engines(
        monkeypatch, ENGINE_SOURCES[name](), width, fmt)
    want = weights.target_dimensions(iw, ih, width, None) if width else (iw,
                                                                         ih)
    assert _out_size(port_out) == _out_size(ref_out) == tuple(want)
    a, b = _decoded(port_out), _decoded(ref_out)
    print(f"{name} -> {_mode_id(mode)}: PSNR {psnr(a, b):.2f} dB")
    assert psnr(a, b) >= 38.0
    stages = port.metrics.stage_seconds
    assert port.metrics.batches == ref.metrics.batches == (1 if width else 0)
    assert ("device_resize" in stages) == (width is not None)
    if name in ("cmyk", "ycck"):
        assert stages["entropy_decode"] > 0 and stages["device_decode"] > 0
        assert "device_decode_resize" not in stages  # no JPEG head
    else:
        assert stages["decode"] > 0


# -- HTTP --------------------------------------------------------------------------


def _url(name: str) -> str:
    return f"https://example.com/{name}"


def _serve(tmp_path, which, sources, fn):
    canned = {_url(name): ("image/x-test", data)
              for name, data in sources.items()}

    async def inner():
        if which == "port":
            from imagekit_tpu_torch.serving.app import create_app

            app = create_app(
                ImageKitConfig(secret=SECRET, cache_dir=tmp_path / which),
                fetcher=_CannedFetcher(canned), metrics=Metrics(),
                rate_limit=False, device="cpu")
        else:
            from imagekit_tpu.serving.app import create_app

            app = create_app(
                ref_config.ImageKitConfig(secret=SECRET,
                                          cache_dir=tmp_path / which),
                fetcher=_CannedFetcher(canned), metrics=RefMetrics(),
                rate_limit=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(inner())


async def _img(client, **params):
    params = {k: str(v) for k, v in params.items() if v is not None}
    r = await client.get("/img", params={**params, "sig": sign(params, SECRET)})
    return r.status, r.headers.get("Content-Type"), await r.read()


@pytest.mark.parametrize("name", sorted(ENGINE_SOURCES))
def test_http_serves_as_the_reference(tmp_path, name):
    """``/img`` at w=64 WebP and JPEG and unresized, then the source cut at
    a third, through both apps."""
    data = ENGINE_SOURCES[name]()
    sources = {"ok": data, "cut": data[:len(data) // 3]}

    async def fn(client):
        outs = [await _img(client, url=_url("ok"), w=w,
                           f=fmt.value if fmt != ImageFormat.webp else None)
                for w, fmt in MODES]
        return outs + [await _img(client, url=_url("cut"), w=64)]

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref[:3], port[:3]):
        assert (ps, pct) == (rs, rct) == (200, pct), pbody[:200]
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0
    if name == "dds_rgb":  # Pillow reads the missing pixels as zeros
        assert port[3][:2] == ref[3][:2] == (200, "image/webp")
        assert _out_size(port[3][2]) == _out_size(ref[3][2])
    else:
        assert port[3] == ref[3]
        assert port[3][0] == 400
        assert port[3][2] == (b"Invalid argument: Unable to decode image "
                              b"for validation")


def test_http_upload_of_ico_and_cmyk(tmp_path):
    sources = {"ico": ENGINE_SOURCES["ico_png"](),
               "cmyk": ENGINE_SOURCES["cmyk"]()}

    async def fn(client):
        outs = []
        for name in ("ico", "cmyk"):
            form = FormData()
            form.add_field("file", sources[name], filename=f"x.{name}")
            form.add_field("w", "48")
            form.add_field("f", "jpeg")
            r = await client.post("/upload", data=form)
            outs.append((r.status, r.headers.get("Content-Type"),
                         await r.read()))
        return outs

    ref = _serve(tmp_path, "ref", {}, fn)
    port = _serve(tmp_path, "port", {}, fn)
    for (rs, rct, rbody), (ps, pct, pbody), want in zip(
            ref, port, ((48, 48), (48, 36))):
        assert (ps, pct) == (rs, rct) == (200, "image/jpeg")
        assert _out_size(pbody) == _out_size(rbody) == want
        assert psnr(_pil_rgb(pbody), _pil_rgb(rbody)) >= 38.0


def test_fetch_validates_the_new_formats_by_header():
    async def run(data):
        return await fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/x", data)}))

    for name in ("ppm", "qoi_rgba", "dxt1", "ico_bmp", "cmyk"):
        data = ENGINE_SOURCES[name]()
        assert asyncio.run(run(data))[0] == data
    for bad in ("qoi_zero_width", "pnm_p7", "dds_header_size", "ico_empty"):
        with pytest.raises(InvalidArgumentError, match="validation"):
            asyncio.run(run(BAD[bad]()))
    # a layout no fixture holds is the engine's 501
    assert asyncio.run(run(NOT_PORTED["dds_bc7"]()))[0][:4] == b"DDS "
