"""The last sources that answered 501 in the port, on the CPU: CIELab,
YCbCr compressed without JPEG (and uncompressed where Pillow's raw read
fits the file), planar 16-bit CMYK and the Orientation tag in TIFFs, the
4 bpp gray-palette core BMP, WebPs with no frame libwebp takes, JPEG
frames of sampling factors outside 1-4 or of a sequential scan's spectral
band; and libtiff's recovery in CCITT rows.

The reference decodes these sources with Pillow (libtiff, libjpeg,
libwebp, littleCMS). The port answers as Pillow does:

- CIELab: Pillow's ``LAB`` unpacker (a* and b* signed in a chunky page,
  as stored in a planar or JPEG one), then ``convert("RGB")``, which is
  littleCMS's 33^3 lattice and 16-bit tetrahedral interpolation
  (``ops/color.py::lab_to_rgb``, ``tests/fixtures/make_lab_clut.py``):
  held to Pillow on all 2^24 inputs.
- YCbCr without JPEG: libtiff's RGBA interface, the chroma of each block
  replicated (K3, on the device) and ``TIFFYCbCrToRGB``; the predictor on
  libtiff's scanlines; the block routines libtiff has (others "decoder
  error -2"); an uncompressed page Pillow's raw reader reads as RGBX.
- Planar 16-bit CMYK: the high byte of each sample through libtiff, each
  plane's first bytes through Pillow's raw reader.
- Orientation 2-8: Pillow's transpose, on every layout the port's own
  decoder takes (the pinned decoder's, which the reference decodes
  itself, ignore the tag).
- The gray 4 bpp core BMP: each row's first bytes as 8-bit gray where the
  row holds the width, else Pillow's "codec configuration error".
- CCITT: libtiff's ``EXPAND1D`` / ``EXPAND2D`` state for state: a code it
  does not expect, or an EOL inside a row, ends the row, and the decode
  goes on; Group 3 data without EOLs is read again without them.

Pixels are held to the JAX package's ``decode_bytes`` (Pillow) exactly, a
JPEG page within the pixel decode's band; statuses and bodies to the
reference app's on ``/img`` (w=64 and unresized) and ``/upload``.
"""

import io
import random
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu_torch import codecs
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import png, tiff, vp8
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import color
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from tests.fixtures import jpeg_lossless_writer, jpeg_writer, make_lab_clut
from tests.test_torch_jpeg_cmyk_tiff_remainder import (
    _assert_parity,
    _both_apps,
)
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_fallbacks import _bits, _fax, _tiff
from tests.test_torch_pillow_sources import _decoded, _save, psnr
from tests.test_torch_rgba_slice import _cfg, _drive, _out_size

W, H = 37, 23
LZW = chip_smoke.lzw_literal


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _picture(w=W, h=H, seed=0) -> np.ndarray:
    """A smooth picture with edges (random pixels make poor JPEGs)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 128 + 100 * np.sin(x / 5 + seed) * np.cos(y / 7)
    g = 128 + 90 * np.cos((x + y) / 9 + seed)
    b = np.where((x // 8 + y // 8) % 2, 200.0, 40.0)
    return np.clip(np.dstack([r, g, b]), 0, 255).astype(np.uint8)


def _same(data: bytes) -> np.ndarray:
    """The port's pixels of ``data``, asserted equal to the reference's
    (Pillow's), and its header's geometry theirs."""
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)
    if data[:2] in (b"II", b"MM"):
        assert tiff.parse(data) == (want.shape[1], want.shape[0],
                                    want.shape[2])
    return got


def _message(e) -> str:
    """An error's text, less the address Pillow's names its buffer by; a
    port's error that carries Pillow's words (``pillow``), in them."""
    if getattr(e, "pillow", None):
        return f"Transformation error: {e.pillow}"
    return str(e).split(" <_io.BytesIO")[0]


def _same_refusal(data: bytes) -> str:
    """Both refuse ``data`` with the same message (a TransformError, 400,
    in the port); returns it."""
    with pytest.raises(ref_codecs.TransformError) as want:
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as got:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(got.value, NotPortedError)
    assert _message(got.value) == _message(want.value)
    return _message(got.value)


# -- CIELab ---------------------------------------------------------------------


@pytest.mark.parametrize("quarter", range(4))
def test_lab_conversion_is_pillows_on_every_triple(quarter):
    """``color.lab_to_rgb`` equals Pillow's ``LAB`` -> ``RGB`` on every
    triple (a quarter of the 2^24 a case, by L), as a chunky TIFF's bytes
    (Pillow's ``LAB`` unpacker) give them."""
    v = np.arange(quarter << 22, (quarter + 1) << 22, dtype=np.uint32)
    triples = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8)
    want = np.asarray(Image.frombytes("LAB", (2048, 2048),
                                      triples.tobytes()).convert("RGB"))
    got = color.lab_to_rgb(torch.from_numpy(triples)).numpy()
    assert np.array_equal(got, want.reshape(-1, 3))


def test_lab_lattice_is_its_recipe():
    """The committed lattice is what ``tests/fixtures/make_lab_clut.py``
    asks of littleCMS."""
    committed = np.load(color._LAB_CLUT)
    assert committed.dtype == np.uint16 and committed.shape == (33, 33, 33,
                                                                3)
    assert np.array_equal(make_lab_clut.clut(), committed)


def _lab_image(seed=1, w=W, h=H) -> Image.Image:
    return Image.frombytes("LAB", (w, h), _rng(seed).integers(
        0, 256, (h, w, 3), np.uint8).tobytes())


def _lab_tags(compression, more=None):
    return {258: (3, [8] * 3), 259: (3, [compression]), 262: (3, [8]),
            277: (3, [3]), **(more or {})}


def _lab_planar(compression, encode, le=True):
    raw = np.asarray(_lab_image(2)).copy()  # bands as Pillow holds them
    return _tiff(W, H, _lab_tags(compression, {284: (3, [2])}),
                 [encode(raw[..., c].tobytes()) for c in range(3)], le=le)


def _lab_tiled():
    lab = _rng(3).integers(0, 256, (32, 48, 3), np.uint8)
    tiles = [lab[y:y + 16, x:x + 16].tobytes() for y in (0, 16)
             for x in (0, 16, 32)]
    return _tiff(W, H, _lab_tags(8), [zlib.compress(t) for t in tiles],
                 tiles=(16, 16))


LAB_PAGES = {
    **{f"pillow_{c}": (lambda c=c: _save(_lab_image(), "TIFF",
                                         compression=c))
       for c in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits")},
    "predictor_2": lambda: _save(_lab_image(), "TIFF",
                                 compression="tiff_lzw", tiffinfo={317: 2}),
    "strips_big_endian": lambda: _tiff(W, H, _lab_tags(
        8, {278: (4, [5])}), [zlib.compress(_rng(4).integers(
            0, 256, (min(5, H - y), W, 3), np.uint8).tobytes())
                               for y in range(0, H, 5)], le=False),
    "planar_raw": lambda: _lab_planar(1, bytes),
    "planar_lzw": lambda: _lab_planar(5, LZW),
    "planar_deflate_big_endian": lambda: _lab_planar(8, zlib.compress,
                                                     le=False),
    "tiled_deflate": _lab_tiled,
}


@pytest.mark.parametrize("name", sorted(LAB_PAGES))
def test_cielab_pages_are_pillows(name):
    """8-bit CIELab, chunky or planar, strips or tiles, in the byte
    compressions and with the predictor: exactly Pillow's pixels."""
    got = _same(LAB_PAGES[name]())
    assert got.shape == (H, W, 3)


@pytest.mark.parametrize("quality", [75, 95])
def test_cielab_jpeg_page_is_within_the_band(quality):
    """A JPEG-compressed CIELab page (Pillow's): its bands as libjpeg
    decodes them, then the lattice: Pillow's pixels exactly (the name is
    kept from when the JPEG TIFF pixel decode was held to a band)."""
    data = _save(Image.fromarray(_picture(64, 48)).convert("LAB"), "TIFF",
                 compression="jpeg", quality=quality)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)


def test_cielab_jpeg_of_neutral_chroma_meets_the_contract(tmp_path):
    """Once a known difference (34.13 dB from Pillow's pixels and 37.78 dB
    served, under the 38 dB contract), now closed: an RGB JPEG segment
    labelled CIELab, whose Cb and Cr bands lie near 128. A chunky CIELab
    page's a* and b* bytes are signed, so 127 is a* = +127 and 128 is a* =
    -128, and a decode one off libjpeg's there flipped the colour. K6 is
    libjpeg's decode: the pixels are Pillow's byte for byte, and both apps
    serve the page (200) with outputs at >= 38 dB of each other."""
    from tests.test_torch_tiff_jpeg import _one_segment

    data = _one_segment(8, 0, None)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)
    bands = np.asarray(Image.open(io.BytesIO(data)))
    assert np.isin(bands[..., 1:], (127, 128)).any()  # the flip's bytes
    ref, port = _both_apps(tmp_path, data)
    assert [p[:2] for p in port] == [r[:2] for r in ref]
    assert {p[0] for p in port} == {200}
    served = [psnr(_decoded(p[2]), _decoded(r[2])) for p, r in zip(port, ref)]
    print("served dB:", served)
    assert all(db >= 38.0 for db in served), served


LAB_REFUSED = {
    "icc_lab": lambda: _tiff(W, H, {**_lab_tags(1), 262: (3, [9])},
                             [bytes(W * H * 3)]),
    "itu_lab": lambda: _tiff(W, H, {**_lab_tags(1), 262: (3, [10])},
                             [bytes(W * H * 3)]),
    "lab_16_bit": lambda: _tiff(W, H, {**_lab_tags(1), 258: (3, [16] * 3)},
                                [bytes(W * H * 6)]),
    "lab_with_alpha": lambda: _tiff(W, H, {**_lab_tags(1), 258: (
        3, [8] * 4), 277: (3, [4]), 338: (3, [2])}, [bytes(W * H * 4)]),
    "lab_one_sample": lambda: _tiff(W, H, {**_lab_tags(1), 258: (3, [8]),
                                           277: (3, [1])}, [bytes(W * H)]),
}


@pytest.mark.parametrize("name", sorted(LAB_REFUSED))
def test_cielab_layouts_pillow_has_no_mode_for_are_refused(name):
    """ICCLab, ITULab, 16-bit Lab, Lab with alpha and one-sample Lab have
    no mode in Pillow's TIFF reader: both refuse them alike, from the
    header on (the fetch stage's 400)."""
    data = LAB_REFUSED[name]()
    assert _same_refusal(data) == "Transformation error: cannot identify " \
                                  "image file"
    with pytest.raises(TransformError):
        tiff.parse(data)


# -- YCbCr compressed without JPEG --------------------------------------------------


def _ycc(sub, compression, rows=8, w=W, h=H, seed=5, more=None,
         predictor_rows=None):
    """A YCbCr page of random planes in chunky blocks of ``sub``, strips of
    ``rows`` rows; ``predictor_rows`` the byte length on which horizontal
    differencing (three samples apart) is applied."""
    rng = _rng(seed)
    sh, sv = sub
    y = rng.integers(0, 256, (h, w), np.uint8)
    cb = rng.integers(0, 256, (h, -(-w // sh)), np.uint8)
    cr = rng.integers(0, 256, cb.shape, np.uint8)
    # each strip starts its own blocks, at chroma row y0 // sub_v
    strips = [chip_smoke.ycc_strip(y, cb, cr, sub, y0, min(rows, h - y0))
              for y0 in range(0, h, rows)]
    if predictor_rows:
        def diff(b):
            a = np.frombuffer(b, np.uint8).astype(np.int16)
            out = a.copy()
            for r in range(0, len(a), predictor_rows):
                row = a[r:r + predictor_rows]
                out[r + 3:r + len(row)] = (row[3:] - row[:-3]) & 255
            return out.astype(np.uint8).tobytes()
        strips = [diff(s) for s in strips]
    enc = {5: LZW, 8: zlib.compress, 32773: _packbits}[compression]
    tags = {258: (3, [8] * 3), 259: (3, [compression]), 262: (3, [6]),
            277: (3, [3]), 278: (4, [rows]), 530: (3, list(sub)),
            **(more or {})}
    if predictor_rows:
        tags[317] = (3, [2])
    return _tiff(w, h, tags, [enc(s) for s in strips])


def _packbits(data: bytes) -> bytes:
    """PackBits in literal runs of at most 128 bytes."""
    return b"".join(bytes([len(data[i:i + 128]) - 1]) + data[i:i + 128]
                    for i in range(0, len(data), 128))


SUBS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("compression", [5, 8, 32773])
@pytest.mark.parametrize("sub", SUBS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ycbcr_pages_are_pillows(sub, compression):
    """Every YCbCrSubSampling libtiff's RGBA interface has a routine for,
    in LZW, deflate and PackBits, at a size no block divides: exactly
    Pillow's pixels (the chroma replicated over each block, libtiff's
    YCbCr -> RGB)."""
    _same(_ycc(sub, compression))


def _ycc_tiled():
    rng, sub = _rng(7), (2, 2)
    y = rng.integers(0, 256, (48, 48), np.uint8)
    cb = rng.integers(0, 256, (24, 24), np.uint8)
    cr = rng.integers(0, 256, (24, 24), np.uint8)
    tiles = [chip_smoke.ycc_strip(y[ty:ty + 16, tx:tx + 16],
                                  cb[ty // 2:, tx // 2:tx // 2 + 8],
                                  cr[ty // 2:, tx // 2:tx // 2 + 8], sub, 0,
                                  16)
             for ty in (0, 16, 32) for tx in (0, 16, 32)]
    return _tiff(40, 40, {258: (3, [8] * 3), 259: (3, [8]), 262: (3, [6]),
                          277: (3, [3]), 530: (3, [2, 2])},
                 [zlib.compress(t) for t in tiles], tiles=(16, 16))


def _ycc_planar(sub):
    rng = _rng(8)
    planes = [rng.integers(0, 256, (H, W), np.uint8) for _ in range(3)]
    return _tiff(W, H, {258: (3, [8] * 3), 259: (3, [8]), 262: (3, [6]),
                        277: (3, [3]), 284: (3, [2]), 530: (3, sub)},
                 [zlib.compress(p.tobytes()) for p in planes])


YCC_VARIANTS = {
    # libtiff's blocks start again at each strip
    "rows_not_whole_blocks": lambda: _ycc((2, 2), 8, rows=5),
    "one_strip": lambda: _ycc((4, 2), 5, rows=H),
    # the predictor on libtiff's scanlines (a row of blocks over sub_v):
    # 19 blocks of 6 over 2 rows, whole samples; 10 blocks of 10 over 2
    # rows, not whole samples, which libtiff leaves undone
    "predictor_on_scanlines": lambda: _ycc((2, 2), 8, predictor_rows=57),
    "predictor_left_undone": lambda: _ycc((4, 2), 8, predictor_rows=50),
    "tiled": _ycc_tiled,
    "planar_no_subsampling": lambda: _ycc_planar([1, 1]),
    # YCbCrSubSampling (2, 2) where the tag is missing
    "subsampling_tag_missing": lambda: _tiff(W, H, {
        258: (3, [8] * 3), 259: (3, [8]), 262: (3, [6]), 277: (3, [3]),
        278: (4, [8])}, [zlib.compress(chip_smoke.ycc_strip(
            *_planes22(), (2, 2), y0, min(8, H - y0)))
            for y0 in range(0, H, 8)]),
    "coefficients_and_reference_tags": lambda: _ycc((2, 2), 8, more={
        529: (4, [1, 1, 1]), 532: (4, [0, 255, 100, 230, 90, 240])}),
}


def _planes22():
    rng = _rng(10)
    return (rng.integers(0, 256, (H, W), np.uint8),
            rng.integers(0, 256, (12, 19), np.uint8),
            rng.integers(0, 256, (12, 19), np.uint8))


@pytest.mark.parametrize("name", sorted(YCC_VARIANTS))
def test_ycbcr_page_variants_are_pillows(name):
    """Strips that do not start whole blocks, the predictor where libtiff
    undoes it and where it cannot, tiles, a planar page without
    subsampling, the tag's default and the colour tags: exactly Pillow's
    pixels."""
    _same(YCC_VARIANTS[name]())


YCC_REFUSED = {
    "sub_2x4": lambda: _ycc((2, 4), 5),
    "sub_1x4": lambda: _ycc((1, 4), 8),
    "sub_3x1": lambda: _ycc((3, 1), 8),
    "planar_2x2": lambda: _ycc_planar([2, 2]),
}


@pytest.mark.parametrize("name", sorted(YCC_REFUSED))
def test_ycbcr_layouts_libtiff_refuses_answer_its_error(name):
    """Subsamplings libtiff's RGBA interface has no routine for, and a
    planar page with subsampling: Pillow's "decoder error -2" in both."""
    assert _same_refusal(YCC_REFUSED[name]()).endswith("decoder error -2")


def _raw_ycc(tile=0, rows=H):
    rng = _rng(11)
    if tile:
        chunks = [rng.integers(0, 256, 4 * tile * tile + 64,
                               np.uint8).tobytes() for _ in range(6)]
        return chip_smoke.tiff_file(W, H, {
            258: (3, [8] * 3), 259: (3, [1]), 262: (3, [6]),
            277: (3, [3])}, chunks, tile=tile)
    chunks = [rng.integers(0, 256, 4 * W * rows + 256, np.uint8).tobytes()
              for _ in range(-(-H // rows))]
    return chip_smoke.tiff_file(W, H, {
        258: (3, [8] * 3), 259: (3, [1]), 262: (3, [6]), 277: (3, [3]),
        278: (4, [rows])}, chunks)


@pytest.mark.parametrize("case", ["one_strip", "strips", "tiles"])
def test_uncompressed_ycbcr_pillow_reads_is_its_raw_read(case):
    """An uncompressed YCbCr page whose file holds what Pillow's raw reader
    reads (four bytes a pixel, RGBX, where the page stores three): its
    pixels, exactly."""
    _same({"one_strip": _raw_ycc, "strips": lambda: _raw_ycc(rows=8),
           "tiles": lambda: _raw_ycc(tile=16)}[case]())


# -- planar 16-bit CMYK -----------------------------------------------------------------


def _cmyk16(compression, le=True, rows=H):
    inks = _rng(12).integers(0, 65536, (H, W, 4), np.uint16)
    enc = {1: bytes, 5: LZW, 8: zlib.compress}[compression]
    order = "<u2" if le else ">u2"
    return _tiff(W, H, {258: (3, [16] * 4), 259: (3, [compression]),
                        262: (3, [5]), 277: (3, [4]), 284: (3, [2]),
                        278: (4, [rows])},
                 [enc(inks[y:y + rows, :, c].astype(order).tobytes())
                  for c in range(4) for y in range(0, H, rows)], le=le)


CMYK16 = {
    "raw": lambda: _cmyk16(1),
    "raw_strips": lambda: _cmyk16(1, rows=7),
    "deflate_strips": lambda: _cmyk16(8, rows=7),
    "lzw": lambda: _cmyk16(5),
    "deflate_big_endian": lambda: _cmyk16(8, le=False),
}


@pytest.mark.parametrize("name", sorted(CMYK16))
def test_planar_16bit_cmyk_is_pillows(name):
    """Planar 16-bit CMYK: the high byte of each sample through libtiff
    (every compression), each plane's first bytes through Pillow's raw
    reader (none); exactly Pillow's pixels."""
    _same(CMYK16[name]())


# -- Orientation ---------------------------------------------------------------------


def _oriented(data: bytes, orientation: int) -> bytes:
    return chip_smoke.tiff_with_tag(data, 274, orientation)


def _cmyk_page(kind: str) -> bytes:
    inks = _rng(13).integers(0, 256, (H, W, 4), np.uint8)
    tags = {258: (3, [8] * 4), 262: (3, [5]), 277: (3, [4])}
    if kind == "tiled":
        pad = np.zeros((32, 48, 4), np.uint8)
        pad[:H, :W] = inks
        return chip_smoke.tiff_file(W, H, {**tags, 259: (3, [8])}, [
            zlib.compress(pad[y:y + 16, x:x + 16].tobytes())
            for y in (0, 16) for x in (0, 16, 32)], tile=16)
    if kind == "lzw":
        return chip_smoke.tiff_file(W, H, {**tags, 259: (3, [5])},
                                    [LZW(inks.tobytes())])
    return chip_smoke.tiff_file(W, H, {**tags, 259: (3, [1])},
                                [inks.tobytes()])


@pytest.mark.parametrize("kind", ["none", "lzw", "tiled"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_is_pillows(orientation, kind):
    """Orientation 1-8 on a CMYK page uncompressed, in LZW and in tiles:
    Pillow mirrors, turns or transposes it (5-8 swap the size); exactly
    its pixels, and the header's geometry."""
    got = _same(_oriented(_cmyk_page(kind), orientation))
    assert got.shape[:2] == ((W, H) if orientation >= 5 else (H, W))


def _orientation_sources():
    pic = _picture(64, 40)
    lab = _save(Image.fromarray(pic).convert("LAB"), "TIFF",
                compression="tiff_lzw")
    g4 = _save(Image.fromarray(pic).convert("1"), "TIFF",
               compression="group4")
    la = _save(Image.fromarray(pic).convert("LA"), "TIFF",
               compression="tiff_lzw")
    return {"cielab": lab, "g4": g4, "gray_alpha": la,
            "ycbcr_lzw": _ycc((2, 2), 5),
            "jpeg": chip_smoke.make_jpeg_tiff(pic, 90),
            "old_style_jpeg": chip_smoke.make_old_style_tiff(pic, 90)}


@pytest.mark.parametrize("orientation", [2, 5, 6, 7, 8])
@pytest.mark.parametrize("layout", ["cielab", "g4", "gray_alpha", "ycbcr_lzw",
                                    "jpeg", "old_style_jpeg"])
def test_orientation_on_every_layout_of_the_ports_decoder(layout,
                                                          orientation):
    """The Orientation on the port's other layouts, JPEG and old-style JPEG
    pages among them (libtiff's RGBA interface reads the latter): the same
    transpose of Pillow's, exactly (the JPEG pages too, since K6)."""
    data = _oriented(_orientation_sources()[layout], orientation)
    if "jpeg" not in layout:
        _same(data)
        return
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("orientation", [3, 6])
def test_pinned_layouts_ignore_the_orientation_as_the_reference(orientation):
    """An 8-bit RGB page, which the pinned decoder (the reference's own)
    takes: both ignore the tag."""
    pic = _picture()
    data = _oriented(chip_smoke.tiff_file(W, H, {
        258: (3, [8] * 3), 259: (3, [1]), 262: (3, [2]), 277: (3, [3])},
        [pic.tobytes()]), orientation)
    assert np.array_equal(_same(data), pic)


def _rewritten_pages():
    """Pages of the pinned decoder's layouts that it reads only once
    rewritten (``tiff.as_deflate``), which the reference hands to Pillow."""
    pic = _picture()
    rgb = {258: (3, [8] * 3), 262: (3, [2]), 277: (3, [3])}
    return {
        "lzma": _tiff(W, H, {**rgb, 259: (3, [34925])}, [_xz(pic.tobytes())]),
        "zstd": _zstd_pillow("RGB", False, pic),
        "raw_planar_3": _tiff(W, H, {**rgb, 259: (3, [1]), 284: (3, [3])},
                              [pic.tobytes()]),
        "raw_predictor_5": _tiff(W, H, {**rgb, 259: (3, [1]),
                                        317: (3, [5])}, [pic.tobytes()]),
    }


@pytest.mark.parametrize("orientation", range(2, 9))
@pytest.mark.parametrize("kind", ["lzma", "zstd", "raw_planar_3",
                                  "raw_predictor_5"])
def test_rewritten_pages_take_the_orientation(kind, orientation):
    """An RGB page in LZMA or Zstandard, or uncompressed with a
    PlanarConfiguration or Predictor Pillow's raw reader ignores: Pillow
    reads it and applies its Orientation; exactly its pixels, and the
    header's geometry."""
    got = _same(_oriented(_rewritten_pages()[kind], orientation))
    assert got.shape[:2] == ((W, H) if orientation >= 5 else (H, W))


def test_engine_orients_a_rewritten_page():
    """``BatchedEngine(device="cpu")`` serves an LZMA page of Orientation
    6 unresized at Pillow's turned size."""
    data = _oriented(_rewritten_pages()["lzma"], 6)
    engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                        device="cpu")
    (out,) = _drive(engine, [data], [None], ImageFormat.webp)
    assert _out_size(out) == (H, W)


# -- the 4 bpp gray-palette core BMP ------------------------------------------------------


@pytest.mark.parametrize("width", range(1, 9))
def test_gray_4bpp_core_bmp_is_pillows(width):
    """A BITMAPCOREHEADER BMP of 4 bpp whose palette is the grays 0-15:
    Pillow reads each row's first bytes as 8-bit gray, up to a width its
    stride holds (4), and refuses a wider one ("codec configuration
    error")."""
    data = chip_smoke.make_gray4_bmp(_rng(width).integers(
        0, 16, (5, width), np.uint8))
    if width <= 4:
        _same(data)
    else:
        assert _same_refusal(data).endswith(
            "codec configuration error when reading image file")


# -- WebPs with no frame libwebp takes -----------------------------------------------------


def _chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _riff(*chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(flags, w=8, h=8):
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(
        3, "little") + (h - 1).to_bytes(3, "little"))


def _anmf(x, y, sub, w=8, h=8):
    return _chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                  + (y // 2).to_bytes(3, "little")
                  + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little")
                  + (100).to_bytes(3, "little") + b"\0" + sub)


def _vp8_body(key_frame=True):
    simple = _save(Image.fromarray(np.full((8, 8, 3), 100, np.uint8)),
                   "WEBP", quality=80)
    body = bytearray(simple[20:20 + struct.unpack("<I", simple[16:20])[0]])
    if not key_frame:
        body[0] |= 1
    return bytes(body)


_ANIM = _chunk(b"ANIM", bytes(6))
WEBPS = {
    "extended_no_image": lambda: _riff(_vp8x(0)),
    "animation_no_frames": lambda: _riff(_vp8x(0x02), _ANIM),
    "frame_alpha_only": lambda: _riff(_vp8x(0x12), _ANIM, _anmf(
        0, 0, _chunk(b"ALPH", bytes(65)))),
    "frame_unknown_chunk": lambda: _riff(_vp8x(0x02), _ANIM, _anmf(
        0, 0, _chunk(b"XYZW", bytes(8)))),
    "frame_dropped_then_one": lambda: _riff(_vp8x(0x02), _ANIM, _anmf(
        0, 0, _chunk(b"XYZW", bytes(8))), _anmf(0, 0, _chunk(
            b"VP8 ", _vp8_body()))),
    "frame_dropped_then_one_partial": lambda: _riff(
        _vp8x(0x12, 16, 16), _ANIM, _anmf(0, 0, _chunk(b"XYZW", bytes(8))),
        _anmf(4, 2, _chunk(b"VP8 ", _vp8_body()))),
    "not_a_key_frame": lambda: _riff(_chunk(b"VP8 ", _vp8_body(False))),
    "frame_not_a_key_frame": lambda: _riff(_vp8x(0x02), _ANIM, _anmf(
        0, 0, _chunk(b"VP8 ", _vp8_body(False)))),
    "first_chunk_not_an_image": lambda: _riff(
        _chunk(b"ICCP", bytes(8)), _vp8x(0), _chunk(b"VP8 ", _vp8_body())),
}


@pytest.mark.parametrize("name", sorted(WEBPS))
def test_webps_with_no_frame_libwebp_takes(name):
    """Where the native decoders find no frame, libwebp's demuxer decides:
    frames without an image are dropped (the first that has one is frame
    0), a file with none, or with a frame that is not a key frame, is
    "could not create decoder object", one whose first chunk is no image
    Pillow's "cannot identify image file"."""
    data = WEBPS[name]()
    try:
        want = ref_codecs.decode_bytes(data)[0]
    except ref_codecs.TransformError:
        _same_refusal(data)
        assert vp8.decode_rgb(data) is None
        return
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert np.array_equal(got, want)


# -- JPEG frames of queue 1 item 10 ---------------------------------------------------------


def _jpeg(samp=((1, 1),) * 3, interleaved=True):
    pic = _picture(96, 64)
    return jpeg_writer.encode(pic, 85, samp, interleaved=interleaved)


def _with_sos(data, band, which=0):
    at = -1
    for _ in range(which + 1):
        at = data.index(b"\xff\xda", at + 1)
    at += 5 + 2 * data[at + 4]
    return data[:at] + bytes(band) + data[at + 3:]


def _with_factors(data, comp, hv):
    at = data.index(b"\xff\xc0") + 11 + 3 * comp
    return data[:at] + bytes([hv]) + data[at + 1:]


JPEG_FRAMES = {
    "band_0_20": lambda: _with_sos(_jpeg(), (0, 20, 0)),
    "band_5_2": lambda: _with_sos(_jpeg(), (5, 2, 0)),
    "band_0_70": lambda: _with_sos(_jpeg(), (0, 70, 0)),
    "successive_approximation": lambda: _with_sos(_jpeg(), (0, 63, 0x21)),
    "scan_a_component_band": lambda: _with_sos(_jpeg(
        ((2, 2), (1, 1), (1, 1)), interleaved=False), (0, 20, 0), which=1),
    "scan_a_component_band_past": lambda: _with_sos(_jpeg(
        ((2, 2), (1, 1), (1, 1)), interleaved=False), (9, 3, 0), which=2),
    **{f"factor_{hv:02x}_component_{c}": (
        lambda c=c, hv=hv: _with_factors(_jpeg(), c, hv))
       for c, hv in ((0, 0x51), (0, 0x15), (0, 0x01), (0, 0x10), (1, 0x51),
                     (2, 0x05))},
}


@pytest.mark.parametrize("name", sorted(JPEG_FRAMES))
def test_jpeg_frames_both_native_parsers_refused(name):
    """A sequential scan's spectral band, whatever it states, is libjpeg's
    warning (JWRN_NOT_SEQUENTIAL) and every block decodes whole: Pillow's
    pixels exactly; a sampling factor outside 1-4
    is libjpeg's refusal, "broken data stream" in both."""
    data = JPEG_FRAMES[name]()
    if name.startswith("factor"):
        assert _same_refusal(data).endswith("broken data stream when "
                                            "reading image file")
        return
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)


# -- CCITT: libtiff's recovery ------------------------------------------------------


EOL = "000000000001"
CCITT = {
    # Group 3 2-D: a row with no code of the white table in horizontal
    # mode, an EOL inside a 2-D row, a 2-D row after it
    "g3_2d_no_code": lambda: _fax(_bits(EOL, "1", "1000", "0011", EOL, "0",
                                        "001", "0" * 12), 3, h=2, t4=1),
    "g3_2d_eol_inside_a_row": lambda: _fax(_bits(
        EOL, "1", "0111", "11", EOL, "0", "1", "1"), 3, h=2, t4=1),
    "g3_2d_no_eols": lambda: _fax(_bits("1", "1000", "0011", "0", "1", "1"),
                                  3, h=2, t4=1),
    "g3_1d_no_eols": lambda: _fax(_bits("1000", "0011", "10011"), 3, h=2),
    "g3_1d_no_code": lambda: _fax(_bits(EOL, "0111", "000000001", EOL,
                                        "1000", "0011"), 3, h=2),
    "mh_no_code_then_rows": lambda: _fax(_bits(
        "0111", "11", "000000001000", "0" * 8, "1000", "0011"), 2, h=2),
    "g4_no_code": lambda: _fax(bytes(8), 4),
    "g4_eol_on_row_0": lambda: _fax(_bits("1", "0" * 12), 4, h=2),
}


@pytest.mark.parametrize("name", sorted(CCITT))
def test_ccitt_rows_recover_as_libtiffs(name):
    """CCITT rows libtiff recovers from (a code it does not expect, an EOL
    inside a row, Group 3 data without EOLs) decode to Pillow's pixels;
    what libtiff fails (a Group 4 strip whose first row ends in an EOL)
    both refuse."""
    data = CCITT[name]()
    try:
        ref_codecs.decode_bytes(data)
    except ref_codecs.TransformError:
        _same_refusal(data)
        return
    _same(data)


_WHITE_RUNS = {0: "00110101", 1: "000111", 2: "0111", 3: "1000", 4: "1011",
               5: "1100", 6: "1110", 7: "1111", 8: "10011", 64: "11011"}
_BLACK_RUNS = {0: "0000110111", 1: "010", 2: "11", 3: "10", 4: "011",
               5: "0011", 6: "0010", 7: "00011", 8: "000101",
               64: "0000001111"}
_GARBAGE = [EOL, "0" * 8, "000000001", "0000000001", "0000001", "0" * 13]
_MODES = ["1", "011", "010", "001", "0001", "000011", "000010", "0000011",
          "0000010"]


def _random_row(rng, width, two_d):
    bits = []
    if two_d:
        for _ in range(rng.randint(1, 5)):
            mode = rng.choice(_MODES)
            bits.append(mode)
            if mode == "001":
                bits += [rng.choice(list(_WHITE_RUNS.values())),
                         rng.choice(list(_BLACK_RUNS.values()))]
    else:
        x, black = 0, False
        while x < width and rng.random() > 0.05:
            run = rng.choice([r for r in _WHITE_RUNS if r <= width - x + 3])
            bits.append((_BLACK_RUNS if black else _WHITE_RUNS)[run])
            x, black = x + run, not black
    if rng.random() < 0.3:
        bits.append(rng.choice(_GARBAGE))
    return "".join(bits)


@pytest.mark.parametrize("compression", ["mh", "g3", "g3_2d", "g4"])
def test_random_ccitt_rows_are_libtiffs(compression):
    """Rows of random codes, a third with a code libtiff does not expect
    or an EOL inside, some cut short: one row a page for Group 4 (a strip
    libtiff ends early leaves its later rows as Pillow's buffer held
    them), several for the others; the port serves what Pillow serves,
    with its pixels, and refuses what it refuses."""
    rng = random.Random(compression)
    comp, two_d = {"mh": (2, False), "g3": (3, False), "g3_2d": (3, True),
                   "g4": (4, False)}[compression]
    for _ in range(60):
        w, h = rng.randint(1, 24), 1 if comp == 4 else rng.randint(1, 3)
        s = ""
        for y in range(h):
            if comp == 3:
                s += EOL + (("1" if y == 0 or rng.random() < 0.5 else "0")
                            if two_d else "")
                s += _random_row(rng, w, two_d and s[-1] == "0")
            else:
                s += _random_row(rng, w, comp == 4)
                if comp == 2:
                    s += "0" * (-len(s) % 8)
        if rng.random() < 0.2 and len(s) > 8:
            s = s[:rng.randint(1, len(s))]
        data = _fax(_bits(s), comp, w=w, h=h, t4=1 if two_d else None)
        try:
            want = ref_codecs.decode_bytes(data)[0]
        except ref_codecs.TransformError:
            with pytest.raises(TransformError):
                codecs.decode_bytes(data, device="cpu")
            continue
        assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0],
                              want), s


def _odd_offset(data: bytes) -> bytes:
    """A one-strip TIFF whose strip (written after a pad byte) starts at an
    odd offset: its StripOffsets one more, its StripByteCounts one less."""
    ifd = struct.unpack("<I", data[4:8])[0]
    for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * k
        tag, value = struct.unpack("<H", data[e:e + 2])[0], struct.unpack(
            "<I", data[e + 8:e + 12])[0]
        if tag in (273, 279):
            value += 1 if tag == 273 else -1
            data = data[:e + 8] + struct.pack("<I", value) + data[e + 12:]
    return data


def _pillow_or_refused(data: bytes) -> None:
    """The port serves ``data`` with Pillow's pixels, or refuses it where
    Pillow does."""
    try:
        want = ref_codecs.decode_bytes(data)[0]
    except ref_codecs.TransformError:
        with pytest.raises(TransformError) as e:
            codecs.decode_bytes(data, device="cpu")
        assert not isinstance(e.value, NotPortedError)
        return
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], want)


@pytest.mark.parametrize("seed", range(3))
def test_ccitt_rle_with_word_alignment_is_libtiffs(seed):
    """Compression 32771 (modified Huffman, each row aligned to 16 bits
    from where libtiff reads the strip, which Pillow's copy of the file
    places at the strip's offset, odd or even): random rows, some cut
    short, against Pillow."""
    rng = random.Random(seed)
    for _ in range(60):
        w, h = rng.randint(1, 40), rng.randint(1, 4)
        s = ""
        for _ in range(h):
            s += _random_row(rng, w, False)
            s += "0" * (-len(s) % 16)
        if rng.random() < 0.2 and len(s) > 8:
            s = s[:rng.randint(1, len(s))]
        if not s:  # a strip of no bytes, which libtiff reads otherwise
            continue
        odd = rng.random() < 0.5
        data = _tiff(w, h, {258: (3, [1]), 259: (3, [32771]),
                            262: (3, [rng.choice([0, 1])]), 277: (3, [1])},
                     [b"\0" * odd + _bits(s)])
        _pillow_or_refused(_odd_offset(data) if odd else data)


@pytest.mark.parametrize("seed", range(3))
def test_thunderscan_is_libtiffs(seed):
    """Compression 32809, ThunderScan's 4-bit codes (runs of the last pixel,
    2- and 3-bit deltas, raw pixels), rows of random codes, some short or
    long of their width (libtiff fails the strip), against Pillow."""
    rng = random.Random(seed)
    for _ in range(120):
        w, h = rng.randint(1, 40), rng.randint(1, 4)
        codes = []
        for _ in range(h):
            x = 0
            while x < w and rng.random() > 0.02:
                kind = rng.random()
                if kind < 0.3:
                    run = rng.randint(0, min(63, w - x + rng.choice([0, 0, 2])))
                    codes.append(run)
                    x += run
                else:
                    top = 0x40 if kind < 0.55 else 0x80 if kind < 0.8 else 0xC0
                    codes.append(top | rng.randint(0, 63))
                    x += {0x40: 3, 0x80: 2, 0xC0: 1}[top]
        data = bytes(codes)
        if rng.random() < 0.1:
            data = data[:rng.randint(0, len(data))]
        _pillow_or_refused(_tiff(w, h, {258: (3, [4]), 259: (3, [32809]),
                                        262: (3, [rng.choice([0, 1])]),
                                        277: (3, [1])}, [data]))


def test_thunderscan_of_other_depths_is_libtiffs_refusal():
    """ThunderScan decodes 4-bit samples only: an 8-bit page is Pillow's
    "decoder error -2" in both."""
    data = _tiff(W, H, {258: (3, [8]), 259: (3, [32809]), 262: (3, [1]),
                        277: (3, [1])}, [bytes(W * H)])
    assert _same_refusal(data).endswith("decoder error -2")


def _lzma_pillow(mode: str, predictor: bool) -> bytes:
    pic = _rng(20).integers(0, 256, (H, W, 3), np.uint8)
    im = (Image.frombytes("LAB", (W, H), pic.tobytes()) if mode == "LAB"
          else Image.fromarray(pic).convert(mode))
    return _save(im, "TIFF", compression="lzma",
                 **({"tiffinfo": {317: 2}} if predictor else {}))


def _xz(raw: bytes, **kw) -> bytes:
    import lzma

    return lzma.compress(raw, format=lzma.FORMAT_XZ, **kw)


def _lzma_16(photometric=1, fmt=1, le=True, samples=1) -> bytes:
    rng = _rng(21)
    if fmt == 2:
        v = rng.integers(-300, 600, (H, W, samples)).astype("<i2" if le
                                                             else ">i2")
    else:
        v = rng.integers(0, 65536 if samples > 1 else 600,
                         (H, W, samples)).astype("<u2" if le else ">u2")
    tags = {258: (3, [16] * samples), 259: (3, [34925]),
            262: (3, [photometric]), 277: (3, [samples])}
    if fmt == 2:
        tags[339] = (3, [2])
    return _tiff(W, H, tags, [_xz(v.tobytes())], le=le)


LZMA_PAGES = {
    **{f"pillow_{m}{'_predictor' if p else ''}": (
        lambda m=m, p=p: _lzma_pillow(m, p))
       for m in ("RGB", "RGBA", "L", "P", "1", "CMYK", "LA", "LAB")
       for p in ((False,) if m == "1" else (False, True))},
    "strips_crc64": lambda: _tiff(W, H, {
        258: (3, [8] * 3), 259: (3, [34925]), 262: (3, [2]), 277: (3, [3]),
        278: (4, [8])}, [_xz(_picture()[y:y + 8].tobytes())
                         for y in range(0, H, 8)]),
    "sha256_extreme": lambda: _tiff(W, H, {
        258: (3, [8] * 3), 259: (3, [34925]), 262: (3, [2]),
        277: (3, [3])}, [_xz(_picture().tobytes(),
                             check=__import__("lzma").CHECK_SHA256,
                             preset=9 | __import__("lzma").PRESET_EXTREME)]),
    "gray16": lambda: _lzma_16(),
    "gray16_white_is_zero": lambda: _lzma_16(photometric=0),
    "gray16_big_endian": lambda: _lzma_16(le=False),
    "gray16_signed": lambda: _lzma_16(fmt=2),
    "gray16_signed_big_endian": lambda: _lzma_16(fmt=2, le=False),
    "rgb16": lambda: _lzma_16(photometric=2, samples=3),
    "rgb16_big_endian": lambda: _lzma_16(photometric=2, samples=3, le=False),
}


@pytest.mark.parametrize("name", sorted(LZMA_PAGES))
def test_lzma_pages_are_pillows(name):
    """LZMA (compression 34925, an .xz stream a strip, libtiff's with a
    delta filter ahead of LZMA2, or Python's with CRC64 or SHA-256 checks)
    in every layout: the port's own decoder's layouts decoded from their
    inflated strips, the pinned decoder's through a deflate rewrite of the
    file (8-bit; 16-bit RGB), 16-bit gray as Pillow's I;16; exactly
    Pillow's pixels."""
    _same(LZMA_PAGES[name]())


def test_corrupt_lzma_strip_is_libtiffs_refusal():
    """An .xz stream cut short: libtiff fails the strip, "decoder error -2"
    in both."""
    data = _tiff(W, H, {258: (3, [8] * 3), 259: (3, [34925]),
                        262: (3, [2]), 277: (3, [3])},
                 [_xz(_picture().tobytes())[:90]])
    assert _same_refusal(data).endswith("decoder error -2")


def _zstd_pillow(mode: str, predictor: bool, picture) -> bytes:
    im = (Image.frombytes("LAB", picture.shape[1::-1], picture.tobytes())
          if mode == "LAB" else Image.fromarray(picture).convert(mode))
    return _save(im, "TIFF", compression="zstd",
                 **({"tiffinfo": {317: 2}} if predictor else {}))


_ZSTD_PICTURES = {
    "noise": lambda: _rng(22).integers(0, 256, (H, W, 3), np.uint8),
    "smooth": lambda: chip_smoke.synth_image(23, 200, 120),
    "flat": lambda: np.full((40, 50, 3), 77, np.uint8),
    "large": lambda: chip_smoke.synth_image(24, 640, 400),
}


@pytest.mark.parametrize("predictor", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "CMYK", "LA",
                                  "LAB"])
@pytest.mark.parametrize("picture", sorted(_ZSTD_PICTURES))
def test_zstd_pages_are_pillows(picture, mode, predictor):
    """Zstandard (compression 50000, a frame a strip: raw, RLE and
    compressed blocks, Huffman literals and FSE sequences as libzstd writes
    them for noise, smooth, flat and large pictures), every layout, with
    and without the predictor: exactly Pillow's pixels."""
    _same(_zstd_pillow(mode, predictor, _ZSTD_PICTURES[picture]()))


def test_zstd_gray16_is_pillows():
    """16-bit gray in Zstandard: Pillow's I;16, clipped to a byte."""
    v = _rng(25).integers(0, 600, (H, W)).astype(np.uint16)
    _same(_save(Image.fromarray(v).convert("I;16"), "TIFF",
                compression="zstd"))


def test_corrupt_zstd_strip_is_libtiffs_refusal():
    """A Zstandard frame cut short: "decoder error -2" in both."""
    page = bytearray(_zstd_pillow("CMYK", False, _ZSTD_PICTURES["smooth"]()))
    offset = Image.open(io.BytesIO(bytes(page))).tag_v2[273][0]
    page[offset + 12:offset + 40] = bytes(28)
    assert _same_refusal(bytes(page)).endswith("decoder error -2")


def _rgb_tags(compression, samples=3, more=None):
    return {258: (3, [8] * samples), 259: (3, [compression]), 262: (3, [2]),
            277: (3, [samples]), **(more or {})}


def _extra(samples, extra, compression=1, planar=False):
    px = _rng(30 + samples).integers(0, 256, (H, W, samples), np.uint8)
    enc = zlib.compress if compression == 8 else bytes
    chunks = ([enc(px[..., k].tobytes()) for k in range(samples)] if planar
              else [enc(px.tobytes())])
    more = {338: (3, extra), **({284: (3, [2])} if planar else {})}
    return _tiff(W, H, _rgb_tags(compression, samples, more), chunks)


def _two_samples(photometric, extra, compression=1, planar=False):
    px = _rng(40).integers(0, 256, (H, W, 2), np.uint8)
    enc = zlib.compress if compression == 8 else bytes
    chunks = ([enc(px[..., k].tobytes()) for k in range(2)] if planar
              else [enc(px.tobytes())])
    tags = {258: (3, [8] * 2), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [2]), 338: (3, [extra]),
            **({284: (3, [2])} if planar else {})}
    if photometric == 3:
        tags[320] = (3, [(i * 97 % 256) << 8 for i in range(256)] * 3)
    return _tiff(W, H, tags, chunks)


def _jpeg_gray_page(photometric):
    pic = Image.fromarray(_picture(64, 48)).convert("L")
    tables, seg = chip_smoke.split_jpeg(_save(pic, "JPEG", quality=85))
    return chip_smoke.tiff_file(64, 48, {
        258: (3, [8]), 259: (3, [7]), 262: (3, [photometric]), 277: (3, [1]),
        278: (4, [48]), 347: (7, tables)}, [seg])


def _pack12(v) -> bytes:
    rows = []
    for r in v:
        bits = "".join(format(int(x), "012b") for x in r)
        bits += "0" * (-len(bits) % 8)
        rows.append(int(bits, 2).to_bytes(len(bits) // 8, "big"))
    return b"".join(rows)


def _gray12(compression):
    v = _pack12(_rng(41).integers(0, 600, (H, W)))
    return _tiff(W, H, {258: (3, [12]), 259: (3, [compression]),
                        262: (3, [1]), 277: (3, [1])},
                 [zlib.compress(v) if compression == 8 else v])


RGB8 = _rng(42).integers(0, 256, (H, W, 3), np.uint8)
RESIDUAL = {
    # compressions Pillow has no name for, and those its libtiff fails
    **{f"compression_{c}": (lambda c=c: _tiff(W, H, _rgb_tags(c),
                                              [RGB8.tobytes()]))
       for c in (99, 32766, 32908, 34661, 34676, 34712, 50001)},
    # PlanarConfiguration 0 or 3: chunky to Pillow's raw reader, refused by
    # libtiff; a Predictor of 0 or 4 likewise
    "planar_3_raw": lambda: _tiff(W, H, _rgb_tags(1, more={284: (3, [3])}),
                                  [RGB8.tobytes()]),
    "planar_0_raw": lambda: _tiff(W, H, _rgb_tags(1, more={284: (3, [0])}),
                                  [RGB8.tobytes()]),
    "planar_3_deflate": lambda: _tiff(W, H, _rgb_tags(
        8, more={284: (3, [3])}), [zlib.compress(RGB8.tobytes())]),
    "predictor_4_raw": lambda: _tiff(W, H, _rgb_tags(
        1, more={317: (3, [4])}), [RGB8.tobytes()]),
    "predictor_0_deflate": lambda: _tiff(W, H, _rgb_tags(
        8, more={317: (3, [0])}), [zlib.compress(RGB8.tobytes())]),
    # CCITT of samples other than 1-bit gray
    "ccitt_rgb": lambda: _tiff(W, H, _rgb_tags(3), [RGB8.tobytes()]),
    "ccitt_palette": lambda: _tiff(W, H, {
        258: (3, [1]), 259: (3, [4]), 262: (3, [3]), 277: (3, [1]),
        320: (3, [0, 65535] * 3)}, [bytes(8)]),
    "ccitt_2_bit_gray": lambda: _tiff(W, H, {
        258: (3, [2]), 259: (3, [4]), 262: (3, [1]), 277: (3, [1])},
        [bytes(8)]),
    # 12-bit gray (Pillow's I;12), YCbCr of one sample (Pillow's L)
    "gray_12_raw": lambda: _gray12(1),
    "gray_12_deflate": lambda: _gray12(8),
    "ycbcr_one_sample_raw": lambda: _tiff(W, H, {
        258: (3, [8]), 259: (3, [1]), 262: (3, [6]), 277: (3, [1])},
        [RGB8[..., 0].tobytes()]),
    "ycbcr_one_sample_deflate": lambda: _tiff(W, H, {
        258: (3, [8]), 259: (3, [8]), 262: (3, [6]), 277: (3, [1])},
        [zlib.compress(RGB8[..., 0].tobytes())]),
    # RGB with extra samples the pinned decoder does not take
    **{f"rgb_{n}_extra_{e[0]}{suffix}": (
        lambda n=n, e=e, c=c, pl=pl: _extra(n, e, c, pl))
       for n, e in ((5, [0, 0]), (5, [1, 0]), (5, [2, 0]), (6, [0, 0, 0]),
                    (6, [2, 0, 0]), (4, [999]))
       for suffix, c, pl in (("", 1, False), ("_deflate", 8, False),
                             ("_planar_raw", 1, True),
                             ("_planar_deflate", 8, True))},
    # gray and palette with alpha in planes, palette with an unspecified
    # extra sample
    "la_planar_raw": lambda: _two_samples(1, 2, planar=True),
    "la_planar_deflate": lambda: _two_samples(1, 2, 8, planar=True),
    "pa_planar_raw": lambda: _two_samples(3, 2, planar=True),
    "pa_planar_deflate": lambda: _two_samples(3, 2, 8, planar=True),
    "px_raw": lambda: _two_samples(3, 0),
    # JPEG pages of one sample: WhiteIsZero (Pillow's L;I), YCbCr (no raw
    # mode of Pillow's)
    "jpeg_white_is_zero": lambda: _jpeg_gray_page(0),
    "jpeg_ycbcr_one_sample": lambda: _jpeg_gray_page(6),
    # old-style JPEG: JPEGProc and PlanarConfiguration ignored beside an
    # interchange format
    "old_style_jpeg_proc_14": lambda: chip_smoke.tiff_with_tag(
        chip_smoke.make_old_style_tiff(_picture(160, 96), 80), 512, 14),
    "old_style_jpeg_planar": lambda: chip_smoke.tiff_with_tag(
        chip_smoke.make_old_style_tiff(_picture(160, 96), 80), 284, 2),
}


@pytest.mark.parametrize("name", sorted(RESIDUAL))
def test_layouts_past_the_last_501s_answer_as_the_reference(name):
    """Layouts that reached the port's 501 through the TIFF decoder's
    "unsupported" (found by probing Pillow): each decodes to Pillow's
    pixels exactly (the JPEG pages too), or is refused
    with Pillow's message ("cannot identify image file", "decoder error
    -2", "unknown raw mode for given image mode")."""
    data = RESIDUAL[name]()
    try:
        want = ref_codecs.decode_bytes(data)[0]
    except ref_codecs.TransformError:
        _same_refusal(data)
        return
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tiles", [False, True])
def test_palette_jpeg_page_is_pillows(tiles):
    """A JPEG-compressed palette page, in a strip or in tiles: Pillow looks
    its gray JPEG samples up in the ColorMap (its high bytes); a smooth
    ColorMap, so the page is within the JPEG TIFF pixel decode's band of
    Pillow's pixels."""
    pic = _picture(64, 48)
    cmap = [i << 8 for i in range(256)] + [(255 - i) << 8 for i in range(
        256)] + [(i // 2) << 8 for i in range(256)]
    gray = np.asarray(Image.fromarray(pic).convert("L"))
    if tiles:
        gray = np.pad(gray, ((0, 16), (0, 0)), mode="edge")
        segs = [_save(Image.fromarray(np.ascontiguousarray(
            gray[y:y + 32, x:x + 32])), "JPEG") for y in (0, 32)
            for x in (0, 32)]
    else:
        segs = [_save(Image.fromarray(gray), "JPEG")]
    data = chip_smoke.tiff_file(64, 48, {
        258: (3, [8]), 259: (3, [7]), 262: (3, [3]), 277: (3, [1]),
        320: (3, cmap), **({} if tiles else {278: (4, [48])})}, segs,
        tile=32 if tiles else 0)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (48, 64, 3)
    assert np.array_equal(got, want)


# -- the guards no input reaches ----------------------------------------------------------


def test_png_method_bytes_never_reach_the_guard():
    """The pinned PNG decoder's only -3 is a compression or filter method
    other than 0, which ``png._ihdr`` answers (a filter method: Pillow's
    "cannot identify image file") or rewrites (a compression method,
    which Pillow never reads) first: every value of each byte."""
    base = chip_smoke.make_png(_picture(8, 6))
    for at in (26, 27):
        for value in range(256):
            data = base[:at] + bytes([value]) + base[at + 1:]
            try:
                codecs.decode_bytes(data, device="cpu")
            except NotPortedError:
                raise AssertionError(f"IHDR byte {at} = {value} reached the "
                                     f"guard") from None
            except TransformError:
                assert at == 27 and value != 0


@pytest.mark.parametrize("fmt", list(ImageFormat))
def test_encode_bytes_takes_every_output_format(fmt):
    """``ImageFormat`` holds the three outputs ``encode_bytes`` encodes:
    its last raise is a guard no format reaches."""
    out = codecs.encode_bytes(_picture(16, 16), fmt, 80, device="cpu")
    assert len(out) > 0


def test_jpeg_frames_never_reach_the_not_ported_guard():
    """Frames of every SOFn, precision, component count and sampling
    factor from 0 to 5: each decodes or answers 400, as the reference's
    Pillow does; none reaches ``jpeg.decode_error``'s guard for -3."""
    base = _jpeg()
    sof = base.index(b"\xff\xc0")
    rng = random.Random(18)
    cases = [(m, p, f) for m in range(0xC0, 0xD0) if m not in (0xC4, 0xC8,
                                                                0xCC)
             for p in (8, 12, 16) for f in (0x11, 0x51, 0x22, 0x00, 0x44)]
    for marker, precision, factors in cases + [
            (0xC0, 8, rng.randrange(256)) for _ in range(40)]:
        data = (base[:sof + 1] + bytes([marker]) + base[sof + 2:sof + 4]
                + bytes([precision]) + base[sof + 5:sof + 11]
                + bytes([factors]) + base[sof + 12:])
        try:
            codecs.decode_bytes(data, device="cpu")
        except NotPortedError:
            raise AssertionError(f"SOF {marker:#x}, precision {precision}, "
                                 f"factors {factors:#x}") from None
        except TransformError:
            pass


def _jpeg_tiff(segments, photometric=2):
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [3]), 278: (4, [16]), 284: (3, [1])}
    return chip_smoke.tiff_file(64, 16 * len(segments), tags, segments)


def test_jpeg_tiff_segments_both_decoders_refuse():
    """Segments both native decoders refuse with -3: a sampling factor
    past 4, which libjpeg refuses ("decoder error -2" in both, where the
    port named a queue item once); lossless ones, which libjpeg decodes for
    libtiff to samples: Pillow's pixels, exactly, in strips, in planes
    and in tiles; of YCbCr, libjpeg's refusal (no colour conversion in
    lossless mode)."""
    pic = _picture(64, 32)
    factor5 = [_with_factors(jpeg_writer.encode(
        np.ascontiguousarray(pic[y:y + 16]), 85, ((1, 1),) * 3), 0, 0x51)
        for y in (0, 16)]
    assert _same_refusal(_jpeg_tiff(factor5)).endswith("decoder error -2")
    lossless = [jpeg_lossless_writer.write(jpeg_lossless_writer.subsample(
        pic[y:y + 16], ((1, 1),) * 3), 64, 16, ((1, 1),) * 3, predictor=1)
        for y in (0, 16)]
    _same(_jpeg_tiff(lossless))
    writer = jpeg_lossless_writer
    planar = [writer.write(writer.subsample(pic[y:y + 16, :, c:c + 1],
                                            ((1, 1),)), 64, 16, ((1, 1),),
                           predictor=4)
              for c in range(3) for y in (0, 16)]
    _same(chip_smoke.tiff_file(64, 32, {
        258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]), 277: (3, [3]),
        278: (4, [16]), 284: (3, [2])}, planar))
    tiles = [writer.write(writer.subsample(np.ascontiguousarray(
        pic[y:y + 16, x:x + 16]), ((1, 1),) * 3), 16, 16, ((1, 1),) * 3,
        predictor=1) for y in (0, 16) for x in (0, 16, 32, 48)]
    _same(chip_smoke.tiff_file(64, 32, {
        258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]), 277: (3, [3])},
        tiles, tile=16))
    assert _same_refusal(_jpeg_tiff(lossless, photometric=6)).endswith(
        "decoder error -2")


def _mode_key_pages():
    """A small page of every key of Pillow's TIFF reader (``OPEN_INFO``:
    byte order, photometric, sample format, fill order, bits, extra
    samples) in every compression the port reads bytes of (none, LZW,
    deflate, PackBits, ThunderScan, Group 4), chunky and planar: random
    samples, so most are nonsense, which each side answers its way."""
    from PIL import TiffImagePlugin

    rng = _rng(50)
    encode = {1: bytes, 5: LZW, 8: zlib.compress, 32773: _packbits,
              32809: bytes, 4: bytes}
    for key in TiffImagePlugin.OPEN_INFO:
        order, photometric, fmt, fill, bits, extra = key
        for compression in encode:
            for planar in (1, 2):
                n = len(bits)
                if planar == 2:
                    chunks = [encode[compression](rng.integers(
                        0, 256, (8 * b + 7) // 8 * 4, np.uint8).tobytes())
                        for b in bits]
                else:
                    chunks = [encode[compression](rng.integers(
                        0, 256, (8 * sum(bits) + 7) // 8 * 4,
                        np.uint8).tobytes())]
                tags = {258: (3, list(bits)), 259: (3, [compression]),
                        262: (3, [photometric]), 277: (3, [n]),
                        284: (3, [planar]), 266: (3, [fill]),
                        339: (3, list(fmt) * (n if len(fmt) == 1 else 1))}
                if extra:
                    tags[338] = (3, list(extra))
                if photometric == 3:
                    tags[320] = (3, [(i * 7) % 65536
                                     for i in range(3 << max(bits))])
                yield _tiff(8, 4, tags, chunks, le=order == b"II")


def test_no_pillow_tiff_mode_reaches_the_501():
    """Every mode Pillow's TIFF reader has, in every compression and both
    configurations the port decodes bytes of (the JPEG ones have their
    own tests): served or refused (400), never the "not ported" answer
    ``misc.check`` gives the native decoders' -3."""
    count = 0
    for data in _mode_key_pages():
        count += 1
        try:
            codecs.decode_bytes(data, device="cpu")
        except NotPortedError as e:
            raise AssertionError(f"a 501 for {data[:64].hex()}") from e
        except TransformError:
            pass
    assert count > 1000


def _raw_segment(samples: np.ndarray, quality=90) -> bytes:
    """A baseline JPEG of (H, W, N) u8 samples, each a component as it is,
    unsubsampled: one interleaved scan, or one scan a component past four
    (T.81 interleaves at most four)."""
    n = samples.shape[2]
    h, w = samples.shape[:2]
    planes, tabs, tq = jpeg_writer.coefficients(samples, quality,
                                                [(1, 1)] * n, colour="raw")
    return jpeg_writer.write(planes, tabs, w, h, [(1, 1)] * n, tq,
                             interleaved=n <= 4)


def _smooth(n: int, w=64, h=48, seed=0) -> np.ndarray:
    """(h, w, n) u8 samples, smooth, each sample its own phase."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.clip(np.stack([
        128 + 60 * np.sin(x / 9 + c + seed) + 30 * np.cos(y / 11 + 2 * c)
        for c in range(n)], -1), 0, 255).astype(np.uint8)


_CMAP = ([i << 8 for i in range(256)] + [(255 - i) << 8 for i in range(256)]
         + [(i // 2) << 8 for i in range(256)])


def _jpeg_page(photometric, samples: np.ndarray, planar=False, extra=(),
               more=None, le=True) -> bytes:
    """A one-strip JPEG TIFF page of ``samples``: one segment of every
    sample, or one a plane."""
    n = samples.shape[2]
    h, w = samples.shape[:2]
    segs = ([_raw_segment(samples[..., c:c + 1]) for c in range(n)]
            if planar else [_raw_segment(samples)])
    tags = {258: (3, [8] * n), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [n]), 278: (4, [h]), 284: (3, [2 if planar else 1]),
            **(more or {})}
    if extra:
        tags[338] = (3, list(extra))
    if photometric == 3:
        tags[320] = (3, _CMAP)
    return _tiff(w, h, tags, segs, le=le)


def _jpeg_mode_key_pages():
    """A small JPEG page of every 8-bit key of Pillow's TIFF reader
    (``OPEN_INFO``), chunky and planar, in either byte order: (its key and
    configuration, the page)."""
    from PIL import TiffImagePlugin

    seen = set()
    for order, photometric, fmt, fill, bits, extra in TiffImagePlugin.OPEN_INFO:
        if set(bits) != {8} or fill != 1:
            continue
        for planar in (False, True):
            key = (order, photometric, len(bits), extra, planar, fmt)
            if key in seen:
                continue
            seen.add(key)
            more = {339: (3, list(fmt) * (len(bits) if len(fmt) == 1
                                          else 1))}
            yield key, _jpeg_page(photometric, _smooth(len(bits), 16, 8),
                                  planar, extra, more, le=order == b"II")


def test_no_pillow_jpeg_tiff_mode_reaches_the_501():
    """Every 8-bit mode of Pillow's TIFF reader as a JPEG page, chunky and
    planar: the reference's answer, never the "not ported" one. Five or six
    samples are libtiff's "decoder error -2" (libjpeg-turbo finds no
    component past the fourth in a scan); a planar page of an unspecified
    extra sample too; RGB of four samples and no ExtraSamples is RGBA, PA
    and PX pages are the ColorMap's colours, a planar YCbCr page without
    subsampling libtiff's RGBA interface's. The pixels within the JPEG
    band of Pillow's."""
    count = 0
    for key, data in _jpeg_mode_key_pages():
        count += 1
        try:
            want = ref_codecs.decode_bytes(data)[0]
        except ref_codecs.TransformError as e:
            with pytest.raises(TransformError) as got:
                codecs.decode_bytes(data, device="cpu")
            assert not isinstance(got.value, NotPortedError), key
            assert _message(got.value) == _message(e), key
            continue
        got = codecs.decode_bytes(data, device="cpu")[0]
        assert got.shape == want.shape, key
        assert np.array_equal(got, want), key
    assert count > 50


_JPEG_LAYOUTS = {
    "rgb_four_samples_no_extra": lambda: _jpeg_page(2, _smooth(4)),
    "rgb_four_samples_no_extra_planar": lambda: _jpeg_page(
        2, _smooth(4), planar=True),
    "palette_alpha": lambda: _jpeg_page(3, _smooth(2), extra=(2,)),
    "palette_unspecified_sample": lambda: _jpeg_page(3, _smooth(2),
                                                     extra=(0,)),
    "palette_alpha_planar": lambda: _jpeg_page(3, _smooth(2), planar=True,
                                               extra=(2,)),
    "ycbcr_planar_unsubsampled": lambda: _jpeg_page(
        6, _smooth(3), planar=True, more={530: (3, [1, 1])}),
    "cielab_planar": lambda: _jpeg_page(8, np.asarray(Image.fromarray(
        _picture(64, 48)).convert("LAB")), planar=True),
}


@pytest.mark.parametrize("name", sorted(_JPEG_LAYOUTS))
def test_jpeg_layouts_past_the_last_501s_are_pillows(name):
    """JPEG pages that answered 501: four RGB samples without ExtraSamples
    (Pillow's RGBA: kept chunky, un-premultiplied planar, as libtiff's RGBA
    interface reads it), palette with alpha (PA; planar, an alpha of 0) or
    an unspecified sample (PX, dropped), planar YCbCr without subsampling
    (libtiff's ``TIFFYCbCrToRGB``); and planar CIELab, whose a* and b*
    bands Pillow holds unsigned: Pillow's pixels exactly, and the header's
    geometry."""
    data = _JPEG_LAYOUTS[name]()
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    assert tiff.parse(data) == (want.shape[1], want.shape[0], want.shape[2])


@pytest.mark.parametrize("samples", [5, 6])
@pytest.mark.parametrize("photometric", [2, 5])
def test_jpeg_pages_of_five_or_six_samples_are_libtiffs_refusal(
        photometric, samples):
    """RGB or CMYK with extra samples, as a JPEG of every sample (scans of
    at most four) or planar: "decoder error -2" in both, from the header
    on (the fetch stage's 400)."""
    extra = (0,) * (samples - (3 if photometric == 2 else 4))
    for planar in (False, True):
        data = _jpeg_page(photometric, _smooth(samples), planar, extra)
        assert _same_refusal(data).endswith("decoder error -2")
        with pytest.raises(TransformError, match="decoder error -2"):
            tiff.parse(data)


_SANITIZED = """
import ctypes, json, lzma, sys
lib = ctypes.CDLL(sys.argv[1])

@ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                  ctypes.c_void_p, ctypes.c_size_t)
def xz(src, n, dst, want):  # loader.py's LZMA strip decoder
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            ctypes.string_at(src, n), want)
    except Exception:
        return -4
    if len(out) < want:
        return -1
    ctypes.memmove(dst, out, want)
    return 0

lib.ik_tiffx_set_xz(xz)

class Info(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in ("w", "h", "c", "layout",
                                              "unread")]

class More(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "compression", "orientation", "sub_h", "sub_v")] + [
        ("luma", ctypes.c_float * 3), ("refbw", ctypes.c_float * 6),
        ("palette", ctypes.c_uint8 * 768)]

lib.ik_tiffx_rewrap.restype = ctypes.c_int64
rcs = {}
for name, hexdata in json.loads(sys.stdin.read()).items():
    data = bytes.fromhex(hexdata)
    info, more = Info(), More()
    rc = lib.ik_tiffx_parse(data, len(data), ctypes.byref(info))
    lib.ik_tiffx_more(data, len(data), ctypes.byref(more))
    if rc == 0:
        out = ctypes.create_string_buffer(max(info.w * info.h * info.c, 1))
        rc = lib.ik_tiffx_decode(data, len(data), out, len(out))
    for strips in (0, 1):
        cap = 4 * len(data) + (1 << 16)
        buf = ctypes.create_string_buffer(cap)
        lib.ik_tiffx_rewrap(data, len(data), buf, cap, strips)
    rcs[name] = rc
print(json.dumps(rcs))
"""


def test_new_layouts_under_address_sanitizer(tmp_path):
    """``tiff_ext_decode.cpp`` and ``bmp_ext_decode.cpp`` built with
    ``-fsanitize=address,undefined`` parse, decode and rewrite this file's
    pages (CIELab, YCbCr, CMYK, Orientation, 12-bit gray, RGB with extra
    samples, LZMA, Zstandard, the layouts Pillow refuses) whole and with
    random bytes changed or cut, in a subprocess with the ASan runtime
    preloaded: no report, and the pages the port serves decode."""
    import json
    import os
    import subprocess
    import sys

    native = os.path.join(chip_smoke.ROOT, "imagekit_tpu_torch", "codecs",
                          "native")
    lib = tmp_path / "sanitized.so"
    subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fPIC", "-shared",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer",
         *(os.path.join(native, s) for s in (
             "bmp_ext_decode.cpp", "tiff_ext_decode.cpp", "jpeg4_decode.cpp",
             "jpeg_entropy.cpp")),
         "-o", str(lib), "-lz"], check=True, capture_output=True,
        timeout=300)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    pages = {
        **{f"lab/{k}": v() for k, v in LAB_PAGES.items()},
        **{f"ycc/{k}": v() for k, v in YCC_VARIANTS.items()},
        **{f"cmyk16/{k}": v() for k, v in CMYK16.items()},
        **{f"lzma/{k}": v() for k, v in LZMA_PAGES.items()},
        **{f"residual/{k}": v() for k, v in RESIDUAL.items()
           if "jpeg" not in k},
        "zstd": _zstd_pillow("RGB", True, _ZSTD_PICTURES["smooth"]()),
        "zstd_cmyk": _zstd_pillow("CMYK", False, _ZSTD_PICTURES["noise"]()),
        "oriented": _oriented(_cmyk_page("tiled"), 7),
        "raw_ycc": _raw_ycc(tile=16),
    }
    rng = random.Random(51)
    cases = {}
    for name, data in pages.items():
        cases[name] = data.hex()
        for k in range(12):
            bad = bytearray(data)
            for _ in range(rng.randint(1, 6)):
                at = rng.randrange(8, len(bad))
                bad[at] = rng.randrange(256)
            if k % 3 == 0:
                bad = bad[:rng.randrange(8, len(bad))]
            cases[f"{name}/bad{k}"] = bytes(bad).hex()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _SANITIZED, str(lib)],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr and "runtime error" not in (
        proc.stderr), proc.stderr[-6000:]
    rcs = json.loads(proc.stdout.strip().splitlines()[-1])
    # the pages the port serves decode (-3: the pinned decoder's layouts,
    # which it reads once rewritten)
    served = [n for n in pages if not n.startswith("residual/")]
    assert {n: rcs[n] for n in served if rcs[n] not in (0, -3)} == {}


# -- HTTP and the engine --------------------------------------------------------------------


def _http_sources():
    pic = _picture(96, 64)
    return {
        "cielab_lzw": lambda: _save(Image.fromarray(pic).convert("LAB"),
                                    "TIFF", compression="tiff_lzw"),
        "cielab_jpeg": lambda: _save(Image.fromarray(pic).convert("LAB"),
                                     "TIFF", compression="jpeg"),
        "ycbcr_420_lzw": lambda: chip_smoke.make_ycbcr_tiff(pic),
        "ycbcr_2x4_refused": lambda: _ycc((2, 4), 5),
        "ycbcr_uncompressed_fits": lambda: _raw_ycc(rows=8),
        "cmyk16_planar": lambda: chip_smoke.make_cmyk16_planar_tiff(pic),
        "orientation_6_cmyk": lambda: _oriented(_cmyk_page("lzw"), 6),
        "orientation_8_jpeg": lambda: _oriented(
            chip_smoke.make_jpeg_tiff(pic, 90), 8),
        "gray_bmp_4_wide": lambda: chip_smoke.make_gray4_bmp(
            _rng(1).integers(0, 16, (3, 4), np.uint8)),
        "gray_bmp_8_wide": lambda: chip_smoke.make_gray4_bmp(
            _rng(2).integers(0, 16, (3, 8), np.uint8)),
        "webp_no_frame": WEBPS["animation_no_frames"],
        "webp_frame_dropped": WEBPS["frame_dropped_then_one"],
        "jpeg_factor_5": JPEG_FRAMES["factor_51_component_0"],
        "jpeg_band_0_70": JPEG_FRAMES["band_0_70"],
        "jpeg_palette_alpha": _JPEG_LAYOUTS["palette_alpha"],
        "jpeg_ycbcr_planar_unsubsampled": _JPEG_LAYOUTS[
            "ycbcr_planar_unsubsampled"],
        "jpeg_rgb_five_samples": lambda: _jpeg_page(2, _smooth(5),
                                                    extra=(0, 0)),
        "ccitt_no_code_mh": lambda: _fax(bytes(4), 2),
        "ccitt_g3_2d_no_eols": CCITT["g3_2d_no_eols"],
    }


@pytest.mark.parametrize("name", sorted(_http_sources()))
def test_http_answers_as_the_reference(tmp_path, name):
    """``/img`` at w=64 and unresized and ``/upload`` at w=64 and
    unresized, through both apps: the same statuses and content types,
    400 bodies byte for byte, 200s within 38 dB."""
    data = _http_sources()[name]()
    ref, port = _both_apps(tmp_path, data)
    _assert_parity(ref, port)
    assert all(p[0] in (200, 400) for p in port)


def test_engine_serves_the_new_sources_and_their_orientation():
    """``BatchedEngine(device="cpu")``: each new source resized to w=32, an
    Orientation of 6 turning the page, and served unresized at its
    Pillow-oriented size."""
    sources = {k: v() for k, v in _http_sources().items()
               if k in ("cielab_lzw", "ycbcr_420_lzw", "cmyk16_planar",
                        "orientation_6_cmyk", "gray_bmp_4_wide")}
    for name, data in sources.items():
        want = ref_codecs.decode_bytes(data)[0]
        for width in (32, None):
            engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                                device="cpu")
            (out,) = _drive(engine, [data], [width], ImageFormat.webp)
            h, w = want.shape[:2]
            assert _out_size(out) == ((w, h) if width is None
                                      else (32, max(1, round(h * 32 / w)))
                                      ), name


def test_ycbcr_page_replicates_its_chroma_once(monkeypatch):
    """A subsampled YCbCr page replicates its chroma in one call of K3's
    entry for its three planes (replication stacks; identity for Y), none
    where the chroma is at full resolution."""
    from imagekit_tpu_torch.ops import dct

    calls = []
    real = dct.resize_planes_u8
    monkeypatch.setattr(dct, "resize_planes_u8",
                        lambda *a, **k: calls.append(len(a[0])) or real(
                            *a, **k))
    codecs.decode_bytes(_ycc((2, 2), 8), device="cpu")
    assert calls == [3]
    calls.clear()
    codecs.decode_bytes(_ycc((1, 1), 8), device="cpu")
    assert calls == []


def test_png_guard_message_names_no_queue_item():
    """The guards' 501 names no open queue item."""
    e = png._not_ported("a PNG the native decoder does not take")
    assert isinstance(e, NotPortedError) and e.roadmap_item is None
    assert "ROADMAP" not in str(e) and "guard" in str(e)


def test_native_decoders_guard_names_no_queue_item():
    """``misc.check``'s -3, where neither native decoder takes a file: a
    guard (the mode sweeps above, and the BMP sweep below, reach it with
    no input), whose 501 names no open queue item."""
    from imagekit_tpu_torch.codecs import misc

    with pytest.raises(NotPortedError) as e:
        misc.check(-3, "TIFF", "TIFF")
    assert e.value.roadmap_item is None
    assert "ROADMAP" not in str(e.value) and "guard" in str(e.value)


def test_no_bmp_header_reaches_the_native_decoders_guard():
    """Every BMP header size (core, OS/2, info, v2-v5), bit depth and
    compression, bottom-up and top-down, over random pixels: served or
    refused (400), never ``misc.check``'s guard."""
    rng = _rng(52)
    count = 0
    for hsz in (12, 16, 40, 52, 56, 64, 108, 124):
        for bits in (1, 2, 4, 8, 16, 24, 32):
            for comp in range(7):
                for h in (3, -3):
                    if hsz == 12:
                        hdr = struct.pack("<IHHHH", 12, 5, h & 0xFFFF, 1,
                                          bits)
                    else:
                        hdr = struct.pack("<IiiHHIIiiII", hsz, 5, h, 1, bits,
                                          comp, 0, 2835, 2835, 0, 0)
                        hdr = (hdr + bytes(hsz))[:hsz]
                    pal = rng.integers(0, 256, 4 << bits if bits <= 8 else 0,
                                       np.uint8).tobytes()
                    px = rng.integers(0, 256, 200, np.uint8).tobytes()
                    off = 14 + len(hdr) + len(pal)
                    data = (b"BM" + struct.pack("<IHHI", off + len(px), 0, 0,
                                                off) + hdr + pal + px)
                    count += 1
                    try:
                        codecs.decode_bytes(data, device="cpu")
                    except NotPortedError as e:
                        raise AssertionError(f"a 501 for {hsz} {bits} "
                                             f"{comp} {h}") from e
                    except TransformError:
                        pass
    assert count == 8 * 7 * 7 * 2
