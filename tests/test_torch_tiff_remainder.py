"""The TIFF layouts the reference still decodes with Pillow, in the port,
on the CPU.

The reference's pinned ``tiff_decode.cpp`` refuses these with -3 and the
reference decodes them with Pillow; the port's own
``codecs/native/tiff_ext_decode.cpp`` takes them:

- sample layouts, decoded to 8 bits on the host: FillOrder 2 (each byte's
  bits reversed before any decompression), 16-bit CMYK (the high byte of
  each sample), CMYK with one or two unspecified extra samples (dropped),
  float32 gray and signed or unsigned 32-bit gray (Pillow's F and I, then
  its ``convert("RGB")``), in the byte-oriented compressions with their
  predictors. Held to exactly the pixels and channels of the JAX package's
  ``decode_bytes`` (Pillow).
- old-style JPEG (compression 6), read as libtiff's RGBA interface reads
  it: the JPEGInterchangeFormat stream (or the strip's, or the
  tables-in-tags form's) entropy-decoded on the host; on the device K6:
  libjpeg's islow IDCT, the identity for luma and replication for chroma,
  then libtiff's ``TIFFYCbCrToRGB`` (``weights.libtiff_ycbcr_tables``).
  Held to: the coefficient planes exactly those of the pinned decoder on
  the whole stream; the IDCT planes exactly libjpeg's islow; the
  replicated planes and the colour step exactly numpy mirrors (a
  transcription of libtiff's ``tif_color.c``, itself exactly Pillow on
  4:4:4 pages); the page byte for byte Pillow's.
- planar JPEG pages (one-component segments a plane), gray with alpha and
  RGB with an unspecified or associated extra sample: the same bars;
  Pillow's ``RGBa`` un-premultiply exactly a mirror of ``unpackRGBa``.
- what Pillow refuses (YCbCr without compression, a 16-bit palette, 12-bit
  JPEG, ...): a TransformError (400) in both, with the reference's message
  where it holds no address; through both apps, equal ``/img`` and
  ``/upload`` statuses.
- both engines and both apps: outputs within 38 dB, ``/img`` statuses
  equal.
"""

import asyncio
import io
import json
import re
import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import FormData
from PIL import Image, TiffImagePlugin

import chip_smoke
from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import tiff as ref_tiff
from imagekit_tpu_torch import codecs, fetch, transform
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import jpeg, tiff
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import (
    InvalidArgumentError,
    NotPortedError,
    TransformError,
)
from imagekit_tpu_torch.ops import dct, jpeg_pixels, weights
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from tests.conftest import make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_fallbacks import (
    _bilevel,
    _pack,
    _packbits,
    _pil_tiff,
)
from tests.test_torch_pillow_sources import (
    MODES,
    _decoded,
    _img,
    _mode_id,
    _run_engines,
    _save,
    _serve,
    _url,
    psnr,
)
from tests.test_torch_rgba_slice import _cfg, _drive, _out_size
from tests.test_torch_webp_slice import _CannedFetcher

ROOT = Path(__file__).resolve().parents[1]
MAX_SHARE = 1e-3
VALIDATION = b"Invalid argument: Unable to decode image for validation"
W, H = 48, 32


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


# -- writers -----------------------------------------------------------------------


def _tiff(w, h, tags, chunks, le=True, tile=0, blobs=()) -> bytes:
    """A TIFF of one IFD by hand: ``chunks`` (strips, or ``tile``-px square
    tiles) after the header, then ``blobs``, then the IFD of ``tags``
    {tag: (type, values)}: 3 SHORT, 4 LONG, 5 RATIONAL (values (num,
    den)), 7 UNDEFINED (values as bytes); a callable's values are made from
    the blobs' offsets. The size and chunk tags are added."""
    e = "<" if le else ">"
    body, offs = b"", []
    for c in chunks:
        offs.append(8 + len(body))
        body += c + b"\0" * (len(c) % 2)
    blob_at = []
    for b in blobs:
        blob_at.append(8 + len(body))
        body += b + b"\0" * (len(b) % 2)
    tags = {256: (4, [w]), 257: (4, [h]),
            **{t: (typ, v(blob_at) if callable(v) else v)
               for t, (typ, v) in tags.items()}}
    lens = [len(c) for c in chunks]
    if tile:
        tags.update({322: (3, [tile]), 323: (3, [tile]), 324: (4, offs),
                     325: (4, lens)})
    else:
        tags.update({273: (4, offs), 279: (4, lens)})
    ifd_off = 8 + len(body)
    tail_off = ifd_off + 2 + 12 * len(tags) + 4
    ifd, tail = struct.pack(e + "H", len(tags)), b""
    for t in sorted(tags):
        typ, vals = tags[t]
        if typ == 7:
            raw, n = bytes(vals), len(vals)
        elif typ == 5:
            raw, n = b"".join(struct.pack(e + "II", *v) for v in vals), len(
                vals)
        else:
            raw = b"".join(struct.pack(e + {3: "H", 4: "I"}[typ], v)
                           for v in vals)
            n = len(vals)
        ifd += struct.pack(e + "HHI", t, typ, n)
        if len(raw) <= 4:
            ifd += raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "I", tail_off + len(tail))
            tail += raw + b"\0" * (len(raw) % 2)
    head = (b"II*\0" if le else b"MM\0*") + struct.pack(e + "I", ifd_off)
    return head + body + ifd + b"\0" * 4 + tail


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _reverse_bits(data: bytes) -> bytes:
    """FillOrder 2: each byte's bits in the other order."""
    return _REVERSED[np.frombuffer(data, np.uint8)].tobytes()


def _rng(seed=0):
    return np.random.default_rng(1000 + seed)


def _strips_of(data: bytes):
    """(tags, strips) of a little-endian TIFF Pillow wrote: its IFD's
    values, and the bytes of each strip."""
    with Image.open(io.BytesIO(data)) as im:
        tags = dict(im.tag_v2)
    strips = [data[o:o + n] for o, n in zip(tags[273], tags[279])]
    return tags, strips


def _fill_order_2_fax(compression: str, t4=None) -> bytes:
    """Pillow's CCITT page of a random bilevel image, its strips' bits
    reversed and FillOrder 2 set."""
    page = _bilevel(300, 40, 7)
    kw = {"tiffinfo": {292: t4}} if t4 is not None else {}
    tags, strips = _strips_of(_pil_tiff(page, compression, **kw))
    out = {258: (3, [1]), 259: (3, [tags[259]]), 262: (3, [tags[262]]),
           266: (3, [2]), 277: (3, [1]), 278: (4, [tags[278]])}
    if t4 is not None:
        out[292] = (4, [t4])
    return _tiff(300, 40, out, [_reverse_bits(s) for s in strips])


def _gray_fo2(bits, photo, compression, palette=False):
    s = _rng(bits + photo).integers(0, 1 << bits, (H, W)).astype(np.uint8)
    raw = _pack(s, bits)
    body = {1: raw, 32773: _packbits(raw), 8: zlib.compress(raw)}[compression]
    tags = {258: (3, [bits]), 259: (3, [compression]),
            262: (3, [3 if palette else photo]), 266: (3, [2]),
            277: (3, [1])}
    if palette:
        tags[320] = (3, [int(v) for v in _rng(9).integers(0, 65536,
                                                          3 << bits)])
    return _tiff(W, H, tags, [_reverse_bits(body)])


def _diff(rows: np.ndarray) -> np.ndarray:
    """Horizontal differencing (predictor 2) along each row's samples."""
    out = rows.copy()
    out[:, 1:] = rows[:, 1:] - rows[:, :-1]
    return out


def _fp_predicted(values: np.ndarray) -> bytes:
    """libtiff's floating-point predictor (3) on (h, w) float32: each row's
    big-endian bytes as four byte planes, most significant first, then
    differenced byte by byte."""
    h, w = values.shape
    b = values.astype(">f4").view(np.uint8).reshape(h, w, 4)
    planes = np.concatenate([b[:, :, k] for k in range(4)], axis=1)
    return _diff(planes).tobytes()


def _cmyk16(le=True, compression=1, predictor=1, tile=0):
    px = _rng(16).integers(0, 65536, (H, W, 4)).astype(np.uint16)
    tags = {258: (3, [16] * 4), 259: (3, [compression]), 262: (3, [5]),
            277: (3, [4])}
    order = "<u2" if le else ">u2"
    if tile:
        chunks = []
        for ty in range(0, H, tile):
            for tx in range(0, W, tile):
                t = np.zeros((tile, tile, 4), np.uint16)
                part = px[ty:ty + tile, tx:tx + tile]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(t.astype(order).tobytes())
        return _tiff(W, H, tags, chunks, le=le, tile=tile)
    rows = px.reshape(H, W * 4)
    if predictor == 2:
        tags[317] = (3, [2])
        rows = _diff(px).reshape(H, W * 4)
    raw = rows.astype(order).tobytes()
    body = {1: raw, 8: zlib.compress(raw), 32773: _packbits(raw)}[compression]
    return _tiff(W, H, tags, [body], le=le)


def _cmyk_extra(n_extra=1, compression=1, predictor=1):
    spp = 4 + n_extra
    px = _rng(5).integers(0, 256, (H, W, spp)).astype(np.uint8)
    tags = {258: (3, [8] * spp), 259: (3, [compression]), 262: (3, [5]),
            277: (3, [spp]), 338: (3, [0] * n_extra)}
    if predictor == 2:
        tags[317] = (3, [2])
        px = _diff(px)
    raw = px.tobytes()
    return _tiff(W, H, tags, [zlib.compress(raw) if compression == 8
                              else raw])


SPECIAL = np.array([np.nan, np.inf, -np.inf, -0.5, -0.0, 0.0, 0.2, 0.5,
                    0.9999, 1.0, 1.5, 127.5, 254.5, 254.9999, 255.0, 255.5,
                    256.0, 1e10, -1e10, 3.4e38, 1e-40], np.float32)


def _elevation(seed=0, h=H, w=W) -> np.ndarray:
    """A float32 raster like an elevation model's, with values past both
    ends of a byte and a few NaN (no data)."""
    rng = _rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    z = (128 + 110 * np.sin(x / 7) * np.cos(y / 5)
         + rng.normal(0, 30, (h, w))).astype(np.float32)
    z.flat[rng.integers(0, h * w, 8)] = np.nan
    return z


def _float32(le=True, compression=1, predictor=1, photo=1, values=None):
    v = _elevation() if values is None else values
    h, w = v.shape
    tags = {258: (3, [32]), 259: (3, [compression]), 262: (3, [photo]),
            277: (3, [1]), 339: (3, [3])}
    if predictor == 3:
        tags[317] = (3, [3])
        raw = _fp_predicted(v)
    else:
        raw = v.astype("<f4" if le else ">f4").tobytes()
    return _tiff(w, h, tags, [zlib.compress(raw) if compression == 8
                              else raw], le=le)


def _int32(le=True, compression=1, predictor=1, signed=True):
    v = _rng(32).integers(-300, 600, (H, W)).astype(np.int32)
    v[0, :4] = [-2 ** 31, 2 ** 31 - 1, 255, 256]
    tags = {258: (3, [32]), 259: (3, [compression]), 262: (3, [1]),
            277: (3, [1]), 339: (3, [2 if signed else 1])}
    if predictor == 2:
        tags[317] = (3, [2])
        v = _diff(v)
    raw = v.astype("<i4" if le else ">i4").tobytes()
    return _tiff(W, H, tags, [zlib.compress(raw) if compression == 8
                              else raw], le=le)


SAMPLES = {
    # FillOrder 2
    "fill_order_2_bilevel_none": lambda: _tiff(
        W, H, {258: (3, [1]), 259: (3, [1]), 262: (3, [1]), 266: (3, [2])},
        [_rng(1).integers(0, 256, H * ((W + 7) // 8), np.uint8).tobytes()]),
    "fill_order_2_bilevel_packbits": lambda: _tiff(
        W, H, {258: (3, [1]), 259: (3, [32773]), 262: (3, [0]),
               266: (3, [2])},
        [_reverse_bits(_packbits(_pack(_bilevel(W, H, 2).astype(np.uint8),
                                       1)))]),
    "fill_order_2_g4": lambda: _fill_order_2_fax("group4"),
    "fill_order_2_g3_2d": lambda: _fill_order_2_fax("group3", 1),
    "fill_order_2_mh": lambda: _fill_order_2_fax("tiff_ccitt"),
    "fill_order_2_gray4_deflate": lambda: _gray_fo2(4, 1, 8),
    "fill_order_2_gray2_white_is_zero": lambda: _gray_fo2(2, 0, 1),
    "fill_order_2_palette4_packbits": lambda: _gray_fo2(4, 1, 32773, True),
    # 16-bit CMYK, CMYK with extra samples
    "cmyk16_le": _cmyk16,
    "cmyk16_be": lambda: _cmyk16(le=False),
    "cmyk16_deflate_predictor": lambda: _cmyk16(compression=8, predictor=2),
    "cmyk16_be_deflate_predictor": lambda: _cmyk16(False, 8, 2),
    "cmyk16_packbits": lambda: _cmyk16(compression=32773),
    "cmyk16_tiles": lambda: _cmyk16(tile=16),
    "cmyk_extra": _cmyk_extra,
    "cmyk_two_extras": lambda: _cmyk_extra(2),
    "cmyk_extra_deflate_predictor": lambda: _cmyk_extra(1, 8, 2),
    # float32 and 32-bit integer gray
    "float32": _float32,
    "float32_be": lambda: _float32(le=False),
    "float32_white_is_zero": lambda: _float32(photo=0),
    "float32_special_values": lambda: _float32(values=SPECIAL[None]),
    "float32_deflate": lambda: _float32(compression=8),
    "float32_deflate_fp_predictor": lambda: _float32(compression=8,
                                                     predictor=3),
    # big-endian through libtiff: Pillow reads the samples byte-swapped
    "float32_be_deflate": lambda: _float32(False, 8),
    "float32_be_fp_predictor": lambda: _float32(False, 8, 3),
    "int32": _int32,
    "int32_be": lambda: _int32(le=False),
    "uint32": lambda: _int32(signed=False),
    "int32_deflate_predictor": lambda: _int32(compression=8, predictor=2),
    "int32_be_deflate": lambda: _int32(False, 8),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_sample_layouts_equal_the_reference(name):
    """The pinned decoder refuses them (the reference asks Pillow); the
    port's own gives exactly Pillow's pixels and channels, its header parse
    the decoded geometry, the single-image path the same."""
    data = SAMPLES[name]()
    assert ref_tiff.decode(data) is None
    want, ref_fmt = ref_codecs.decode_bytes(data)
    got, fmt = codecs.decode_bytes(data, device="cpu")
    assert fmt.value == ref_fmt.value == "tiff"
    assert got.shape == want.shape and np.array_equal(got, want), (
        np.abs(got.astype(int) - want).max())
    assert tiff.parse(data) == (got.shape[1], got.shape[0], got.shape[2])
    assert np.array_equal(transform.decode_image(data, device="cpu")[0], got)


def test_fixtures_hold_their_layouts():
    """What Pillow makes of them: the modes and raw modes the names say."""
    def info(name):
        with Image.open(io.BytesIO(SAMPLES[name]())) as im:
            return im.mode, im.tile[0][3][0], im.tag_v2.get(266, 1)

    assert info("fill_order_2_bilevel_none") == ("1", "1;R", 2)
    assert info("cmyk16_be") == ("CMYK", "CMYK;16B", 1)
    assert info("cmyk_extra") == ("CMYK", "CMYKX", 1)
    assert info("float32")[:2] == ("F", "F;32F")
    assert info("int32_be")[:2] == ("I", "I;32BS")
    assert info("uint32")[:2] == ("I", "I;32N")
    with Image.open(io.BytesIO(SAMPLES["float32_deflate_fp_predictor"]())
                    ) as im:
        assert im.tag_v2[317] == 3


def test_float_and_integer_samples_convert_as_pillow():
    """Pillow's F and I to a byte (its ``convert("RGB")``), the reference's
    pixels: a float truncated, NaN and what is not above 0 to 0, 255 and
    above to 255; an integer clipped."""
    got = codecs.decode_bytes(SAMPLES["float32_special_values"](),
                              device="cpu")[0][0, :, 0]
    v = SPECIAL.astype(np.float64)
    want = np.where(~(v > 0), 0, np.where(v >= 255, 255,
                                          np.trunc(np.nan_to_num(v))))
    assert got.tolist() == want.astype(int).tolist()
    got = codecs.decode_bytes(SAMPLES["int32"](), device="cpu")[0][0, :4, 0]
    assert got.tolist() == [0, 255, 255, 255]


def test_signed_16_bit_gray_is_the_pinned_decoders():
    """Signed 16-bit gray (SampleFormat 2), which Pillow reads as I;16S, is
    decoded by the pinned decoder in the reference (its high byte), and so
    in the port: both equal."""
    v = _rng(3).integers(-2 ** 15, 2 ** 15, (H, W)).astype("<i2")
    data = _tiff(W, H, {258: (3, [16]), 259: (3, [1]), 262: (3, [1]),
                        277: (3, [1]), 339: (3, [2])}, [v.tobytes()])
    want = ref_tiff.decode(data)
    assert want is not None
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], want)


def test_pillow_keys_are_pillows():
    """``tiff_ext_decode.cpp``'s table of the modes Pillow reads is
    ``TiffImagePlugin.OPEN_INFO``'s keys."""
    src = (ROOT / "imagekit_tpu_torch" / "codecs" / "native"
           / "tiff_ext_decode.cpp").read_text()
    body = src[src.index("kPillowKeys[] = {"):]
    body = body[:body.index("};")]
    got = set()
    for m in re.finditer(r"\{(\d+), (\d+), (\d+), (\d+), (\d+), \{([\d, ]*)\}"
                         r", (\d+), \{([\d, ]*)\}\}", body):
        orders, photo, fmt, fill, n, bps, nx, extra = m.groups()
        bps = tuple(int(b) for b in bps.split(",") if b.strip())
        extra = tuple(int(x) for x in extra.split(",") if x.strip())
        assert len(bps) == int(n) and len(extra) == int(nx)
        for bit, order in ((1, TiffImagePlugin.II), (2, TiffImagePlugin.MM)):
            if int(orders) & bit:
                got.add((order, int(photo), (int(fmt),), int(fill), bps,
                         extra))
    assert got == set(TiffImagePlugin.OPEN_INFO)


# -- old-style JPEG ------------------------------------------------------------------


OJ_SIZE = (64, 48)


def _jfif(size=OJ_SIZE, sampling=2, quality=85, seed=0, **kw) -> bytes:
    img = make_test_image(*size)
    if seed:
        img = np.roll(img, 7 * seed, axis=1)
    return _save(Image.fromarray(img), "JPEG", quality=quality,
                 subsampling=sampling, **kw)


def _sos_end(jpeg: bytes) -> int:
    at = 2
    while jpeg[at + 1] != 0xDA:
        at += 2 + struct.unpack(">H", jpeg[at + 2:at + 4])[0]
    return at + 2 + struct.unpack(">H", jpeg[at + 2:at + 4])[0]


def _ojpeg(jpeg=None, size=OJ_SIZE, jif=(8, None), strip=None, extra=None,
           le=True) -> bytes:
    """Old-style JPEG (compression 6) of a JFIF stream: the stream is the
    one strip, behind JPEGInterchangeFormat ``jif`` = (offset, length; None
    for the stream's); ``strip`` = (offset, count) sets the strip's range
    instead."""
    jpeg = jpeg or _jfif(size)
    w, h = size
    off, n = jif
    tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [h]), 513: (4, [off]),
            514: (4, [len(jpeg) if n is None else n]), **(extra or {})}
    data = _tiff(w, h, tags, [jpeg], le=le)
    if strip is not None:
        e = "<" if le else ">"
        for tag, value in zip((273, 279), strip):
            at = data.index(struct.pack(e + "HHI", tag, 4, 1))
            data = data[:at + 8] + struct.pack(e + "I", value) + data[at + 12:]
    return data


def _tables_of(j: bytes):
    """A JPEG's quantisation tables (id -> 64 bytes, zigzag) and DC and AC
    Huffman tables (id -> 16 counts and the symbols), as its DQT and DHT
    segments hold them."""
    q, dc, ac, at = {}, {}, {}, 2
    while j[at + 1] != 0xDA:
        n = struct.unpack(">H", j[at + 2:at + 4])[0]
        p = j[at + 4:at + 2 + n]
        i = 0
        while j[at + 1] in (0xDB, 0xC4) and i < len(p):
            if j[at + 1] == 0xDB:
                q[p[i] & 15] = p[i + 1:i + 65]
                i += 65
            else:
                k = 17 + sum(p[i + 1:i + 17])
                (ac if p[i] >> 4 else dc)[p[i] & 15] = p[i + 1:i + k]
                i += k
        at += 2 + n
    return q, dc, ac


def _tables_form(sampling=2, restart=0) -> bytes:
    """The tables-in-tags form: a Pillow JPEG's quantisation and Huffman
    tables at offsets in JPEGQTables, JPEGDCTables and JPEGACTables (one a
    component: Y, then Cb and Cr sharing the chroma ones), its frame in
    the tags (YCbCrSubSampling, JPEGRestartInterval) and its entropy-coded
    data alone in the strip."""
    kw = {"restart_marker_blocks": restart} if restart else {}
    j = _jfif(sampling=sampling, **kw)
    q, dc, ac = _tables_of(j)
    sub = {2: (2, 2), 1: (2, 1), 0: (1, 1)}[sampling]
    tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [OJ_SIZE[1]]), 512: (3, [1]), 530: (3, list(sub)),
            519: (4, lambda o: o[0:3]), 520: (4, lambda o: o[3:6]),
            521: (4, lambda o: o[6:9])}
    if restart:
        # Pillow's restart interval, in MCUs (its DRI segment)
        dri = j.index(b"\xff\xdd")
        tags[515] = (3, [struct.unpack(">H", j[dri + 4:dri + 6])[0]])
    return _tiff(*OJ_SIZE, tags, [j[_sos_end(j):-2]],
                 blobs=[q[0], q[1], q[1], dc[0], dc[1], dc[1], ac[0], ac[1],
                        ac[1]])


OLD_STYLE = {
    "jif_420": _ojpeg,
    "jif_422": lambda: _ojpeg(_jfif(sampling=1)),
    "jif_444": lambda: _ojpeg(_jfif(sampling=0)),
    "jif_big_endian": lambda: _ojpeg(le=False),
    "jif_odd_size": lambda: _ojpeg(_jfif((61, 45)), size=(61, 45)),
    # the strip at the scan data after the stream's SOS
    "strip_after_the_sos": lambda: _ojpeg(strip=(8 + _sos_end(_jfif()),
                                                 len(_jfif()) - _sos_end(
                                                     _jfif()))),
    # JPEGInterchangeFormat of the header alone: its scan runs on into the
    # strip, which holds the entropy-coded data
    "jif_header_only": lambda: _ojpeg(
        _jfif()[:_sos_end(_jfif())] + _jfif()[_sos_end(_jfif()):],
        jif=(8, _sos_end(_jfif())),
        strip=(8 + _sos_end(_jfif()), len(_jfif()) - _sos_end(_jfif()))),
    # what libtiff corrects: a length of 0 (to the file's end), an
    # interchange format past the file (none: the strip's stream), a strip
    # inside the stream's header (unused: the stream is whole)
    "jif_length_0": lambda: _ojpeg(jif=(8, 0)),
    "jif_past_the_file": lambda: _ojpeg(jif=(1 << 20, None)),
    "strip_inside_the_header": lambda: _ojpeg(strip=(28, 100)),
    # Pillow and libtiff read an old-style JPEG as YCbCr whatever its
    # photometric
    "photometric_rgb": lambda: _ojpeg(extra={262: (3, [2])}),
    "tables_in_tags": _tables_form,
    "tables_in_tags_422": lambda: _tables_form(1),
    "tables_in_tags_restarts": lambda: _tables_form(restart=3),
    # YCbCrCoefficients (Rec. 709) and ReferenceBlackWhite (studio range)
    "coefficients_709_studio_range": lambda: _ojpeg(extra={
        529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
        532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                  (240, 1)])}),
}


def _stream_of(name) -> bytes:
    """The JPEG stream each old-style fixture holds, whole."""
    return {"jif_422": lambda: _jfif(sampling=1),
            "jif_444": lambda: _jfif(sampling=0),
            "jif_odd_size": lambda: _jfif((61, 45)),
            "tables_in_tags": _jfif,
            "tables_in_tags_422": lambda: _jfif(sampling=1),
            "tables_in_tags_restarts": lambda: _jfif(
                restart_marker_blocks=3)}.get(name, _jfif)()


def test_old_style_fixtures_hold_their_layouts():
    for name, make in OLD_STYLE.items():
        data = make()
        assert ref_tiff.decode(data) is None, name
        with Image.open(io.BytesIO(data)) as im:
            assert im.tag_v2[259] == 6, name
            assert im.tile[0][3][:2] == ("RGBX", "tiff_jpeg"), name
            assert (513 in im.tag_v2) == ("tables" not in name), name
        info = tiff.segments(data)[0]
        assert info.old_style == 1 and (info.rows, info.cols) == (1, 1)


@pytest.mark.parametrize("name", sorted(OLD_STYLE))
def test_old_style_coefficients_are_the_whole_streams(name):
    """The page's planes and tables are the pinned decoder's on the whole
    JFIF stream the fixture was made from, exactly."""
    page = tiff.entropy_decode(OLD_STYLE[name]())
    hdr, coeffs, qtabs = jpeg_abi.decode(loader.load(), _stream_of(name))
    assert page.ycbcr is not None and page.segments is None
    for c in range(3):
        assert np.array_equal(page.coeffs[c], coeffs[c]), (name, c)
        assert np.array_equal(page.qtabs[c], qtabs[hdr.comp_tq[c]])


def _page_planes(page):
    """K6's IDCT planes of the page and its output planes before the colour
    step of the photometric (its plain version, here), each (H, W)."""
    x = jpeg_pixels.upload(dct.page_plan(page), torch.device("cpu"))
    before = jpeg_pixels.LAUNCHES
    out = jpeg_pixels.decode_pixels(x).numpy()
    assert jpeg_pixels.LAUNCHES == before  # the plain version on the CPU
    return ([jpeg_pixels.idct_plain(c, x.qt[i]).numpy()
             for i, c in enumerate(x.coeffs)],
            [out[..., c] for c in range(out.shape[-1])])


@pytest.mark.parametrize("name", ["jif_420", "jif_422", "jif_444",
                                  "jif_odd_size", "tables_in_tags"])
def test_old_style_planes(name):
    """The IDCT planes exactly libjpeg's islow (``tests/
    test_torch_jpeg_pixels.py::idct_plane_reference``; within +-1 of the
    JAX package's float IDCT before); the planes after the upsample exactly
    the IDCT planes with chroma replicated over each subsampling block
    (np.repeat), cropped to the page."""
    from tests.test_torch_jpeg_pixels import idct_plane_reference

    page = tiff.entropy_decode(OLD_STYLE[name]())
    idct, out = _page_planes(page)
    for c in range(3):
        want = idct_plane_reference(page.coeffs[c], page.qtabs[c])
        assert np.array_equal(idct[c], want), (name, c)
    full = idct[0].shape
    h, w = page.height, page.width
    for c in range(3):
        sv, sh = full[0] // idct[c].shape[0], full[1] // idct[c].shape[1]
        want = np.repeat(np.repeat(idct[c], sv, 0), sh, 1)[:h, :w]
        assert out[c].shape == (h, w) and np.array_equal(out[c], want), c


@pytest.mark.parametrize("luma,chroma", [(4, 2), (3, 3), (34, 17), (1, 1)])
def test_replication_axis_weights_are_libtiffs(luma, chroma):
    """Weight 1 at floor(i / s) of each output row i, s the ratio of the
    grids: a numpy mirror; a ratio that is not an integer raises."""
    got = weights.replication_axis_weights(luma, chroma)
    s = luma // chroma
    want = np.zeros((luma * 8, chroma * 8), np.float32)
    for i in range(luma * 8):
        want[i, i // s] = 1
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError):
        weights.replication_axis_weights(3, 2)


def _libtiff_tables(luma=(0.299, 0.587, 0.114),
                    refbw=(0.0, 255.0, 128.0, 255.0, 128.0, 255.0)):
    """``TIFFYCbCrToRGBInit`` transcribed from libtiff's ``tif_color.c`` a
    value at a time, its float arithmetic in numpy float32: Y_tab,
    Cr_r_tab, Cb_b_tab, Cr_g_tab, Cb_g_tab."""
    f = np.float32

    def fix(x):  # (int32_t)((x) * (1L << SHIFT) + 0.5)
        return int(float(f(x) * f(65536)) + 0.5)

    def clamp(v, lo, hi):  # !((f) >= (min)) ? min : f > max ? max : f
        return lo if not v >= lo else (hi if v > hi else v)

    def code2v(c, rb, rw, cr):
        den = f(rw) - f(rb)
        return f(f(c - int(f(rb))) * f(cr)) / (den if den != 0 else f(1))

    lr, lg, lb = (f(v) for v in luma)
    rb = [f(v) for v in refbw]
    f1 = f(2) - f(2) * lr
    d1 = fix(clamp(f1, f(0), f(2)))
    d2 = -fix(clamp(lr * f1 / lg, f(0), f(2)))
    f3 = f(2) - f(2) * lb
    d3 = fix(clamp(f3, f(0), f(2)))
    d4 = -fix(clamp(lb * f3 / lg, f(0), f(2)))
    tabs = [[], [], [], [], []]
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, rb[4] - f(128), rb[5] - f(128), 127),
                       f(-4096), f(4096)))
        cb = int(clamp(code2v(x, rb[2] - f(128), rb[3] - f(128), 127),
                       f(-4096), f(4096)))
        tabs[1].append((d1 * cr + 32768) >> 16)
        tabs[2].append((d3 * cb + 32768) >> 16)
        tabs[3].append(d2 * cr)
        tabs[4].append(d4 * cb + 32768)
        tabs[0].append(int(clamp(code2v(x + 128, rb[0], rb[1], 255),
                                 f(-4096), f(4096))))
    return [np.array(t, np.int64) for t in tabs]


def _libtiff_rgb(y, cb, cr, luma=(0.299, 0.587, 0.114),
                 refbw=(0.0, 255.0, 128.0, 255.0, 128.0, 255.0)):
    """``TIFFYCbCrtoRGB`` on u8 planes through :func:`_libtiff_tables`."""
    ytab, cr_r, cb_b, cr_g, cb_g = _libtiff_tables(luma, refbw)
    yv = ytab[y]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16),
                    yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


LIBTIFF_COLOURS = {
    "default": ((0.299, 0.587, 0.114), (0, 255, 128, 255, 128, 255)),
    "rec709": ((0.2126, 0.7152, 0.0722), (0, 255, 128, 255, 128, 255)),
    "studio_range": ((0.299, 0.587, 0.114), (16, 235, 128, 240, 128, 240)),
    "both": ((0.2126, 0.7152, 0.0722), (16, 235, 128, 240, 128, 240)),
    "unsigned_chroma": ((0.299, 0.587, 0.114), (0, 255, 0, 255, 0, 255)),
}


def _rational_tags(luma, refbw):
    return {529: (5, [(round(v * 10000), 10000) for v in luma]),
            532: (5, [(int(v), 1) for v in refbw])}


@pytest.mark.parametrize("name", sorted(LIBTIFF_COLOURS))
def test_libtiff_colour_step(name):
    """The port's tables and its colour step on every (Y, Cb, Cr) of a
    random page exactly the transcription; the transcription exactly
    Pillow's old-style decode of a 4:4:4 page (no upsample: its samples are
    libjpeg's YCbCr decode of the stream)."""
    luma, refbw = LIBTIFF_COLOURS[name]
    luma_f = tuple(float(np.float32(round(v * 10000)) / np.float32(10000))
                   for v in luma)
    got = weights.libtiff_ycbcr_tables(luma_f, tuple(map(float, refbw)))
    for g, w in zip(got, _libtiff_tables(luma_f, refbw)):
        assert np.array_equal(g, w)
    rng = _rng(7)
    planes = rng.integers(0, 256, (3, 64, 96), np.uint8)
    out = dct.libtiff_ycbcr_to_rgb(*torch.from_numpy(planes), luma_f, refbw)
    assert np.array_equal(out.numpy(), _libtiff_rgb(*planes, luma_f, refbw))
    # the oracle: noise at 4:4:4, q95
    img = rng.integers(0, 256, (64, 96, 3), np.uint8)
    jpeg = _save(Image.fromarray(img), "JPEG", quality=95, subsampling=0)
    with Image.open(io.BytesIO(jpeg)) as im:
        im.draft("YCbCr", im.size)
        ycc = np.asarray(im)
    data = _ojpeg(jpeg, size=(96, 64), extra=_rational_tags(luma, refbw))
    want = ref_codecs.decode_bytes(data)[0]
    mirror = _libtiff_rgb(*np.moveaxis(ycc, -1, 0), luma_f, refbw)
    assert np.array_equal(mirror, want)


@pytest.mark.parametrize("name", sorted(OLD_STYLE))
def test_old_style_page_matches_pillow(name):
    """The page (K6's plain version, then libtiff's colour step on the
    replicated planes, exactly the mirror) against Pillow: the same shape,
    byte for byte."""
    data = OLD_STYLE[name]()
    page = tiff.entropy_decode(data)
    _, out = _page_planes(page)
    h, w = page.height, page.width
    mirror = _libtiff_rgb(*(p[:h, :w] for p in out), *page.ycbcr)
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert np.array_equal(got, mirror)
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape == (h, w, 3)
    assert np.array_equal(got, want)
    assert tiff.parse(data) == (w, h, 3) and tiff.layout(data) == tiff.JPEG


def test_old_style_1080p_page_matches_pillow():
    """A 1920x1080 4:2:0 page (``chip_smoke``'s picture, Pillow's JFIF
    behind 513/514): one segment of 136x240 luma blocks, against
    Pillow."""
    jpeg = _save(Image.fromarray(chip_smoke.synth_image(5, noise=False)),
                 "JPEG", quality=80, subsampling=2)
    data = _ojpeg(jpeg, size=(1920, 1080))
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape == (1080, 1920, 3)
    assert np.array_equal(got, want)


def test_chip_smoke_old_style_writer_decodes_as_pillow():
    """Phase 22's writer, without Pillow (the port's encoder, JFIF behind
    513/514): Pillow reads its file, and the port decodes it to Pillow's
    pixels exactly."""
    img = chip_smoke.synth_image(3, 160, 96, noise=False)
    data = chip_smoke.make_old_style_tiff(img, 80)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (96, 160, 3)
    assert np.array_equal(got, want)
    d = np.abs(got.astype(int) - want.astype(int))
    assert psnr(got, want) >= 40.0 and d.max() <= 12


# -- planar, extra-sample and gray-with-alpha JPEG pages ---------------------------


def _planar(size=(64, 48), rows=16, alpha=None, photometric=2) -> bytes:
    """PlanarConfiguration 2, photometric RGB: each plane's strips
    one-component JPEGs of Pillow's, one JPEGTables (the planes share a
    quality, so a table); with ``alpha`` (an ExtraSamples value), a fourth
    plane, the green. Photometric 5 takes four planes (CMYK)."""
    w, h = size
    img = make_test_image(w, h)
    n = {2: 3, 5: 4}[photometric]
    chans = [img[..., c % 3] for c in range(n)] + (
        [img[..., 1]] if alpha is not None else [])
    segs, tables = [], b""
    for plane in chans:
        for y in range(0, h, rows):
            tables, seg = chip_smoke.split_jpeg(_save(
                Image.fromarray(np.ascontiguousarray(plane[y:y + rows])),
                "JPEG", quality=85))
            segs.append(seg)
    spp = len(chans)
    tags = {258: (3, [8] * spp), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [spp]), 278: (4, [rows]), 284: (3, [2]),
            347: (7, tables)}
    if alpha is not None:
        tags[338] = (3, [alpha])
    return chip_smoke.tiff_file(w, h, tags, segs)


def _with_extra_sample(kind: int, size=(64, 48)) -> bytes:
    """Pillow's RGBA JPEG TIFF (its green as alpha) with ExtraSamples set
    to ``kind``: 0 (unspecified) or 1 (associated alpha)."""
    img = make_test_image(*size)
    data = _save(Image.fromarray(np.dstack([img, img[..., 1] // 2 + 60])),
                 "TIFF", compression="jpeg", quality=85)
    at = data.index(b"\x52\x01\x03\x00\x01\x00\x00\x00\x02\x00")
    return data[:at + 8] + bytes([kind]) + data[at + 9:]


JPEG_PAGES = {
    "planar_rgb": _planar,
    "planar_rgb_one_strip": lambda: _planar(rows=48),
    "planar_rgba": lambda: _planar(alpha=2),
    "planar_rgb_associated_alpha": lambda: _planar(alpha=1),
    "planar_cmyk": lambda: _planar(photometric=5),
    "gray_with_alpha": lambda: _save(Image.fromarray(make_test_image(
        64, 48)).convert("LA"), "TIFF", compression="jpeg", quality=85),
    "rgb_unspecified_extra": lambda: _with_extra_sample(0),
    "rgb_associated_alpha": lambda: _with_extra_sample(1),
    # FillOrder 2 on a JPEG page: libtiff leaves JPEG data as it is
    "rgb_fill_order_2": lambda: _save(Image.fromarray(make_test_image(
        64, 48)), "TIFF", compression="jpeg", quality=85,
        tiffinfo={266: 2}),
}
ALPHA = ("planar_rgba", "planar_rgb_associated_alpha", "gray_with_alpha",
         "rgb_associated_alpha")


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's ``unpackRGBa`` a pixel at a time: each colour * 255 / alpha
    in C's integer division, clipped to 255; all 0 where the alpha is 0."""
    out = np.zeros_like(px)
    for idx in np.ndindex(px.shape[:-1]):
        r, g, b, a = (int(v) for v in px[idx])
        if a == 255:
            out[idx] = (r, g, b, a)
        elif a:
            out[idx] = [min(c * 255 // a, 255) for c in (r, g, b)] + [a]
    return out


def test_unpremultiply_is_pillows():
    """The port's un-premultiply (torch) exactly the mirror, the mirror
    exactly Pillow's ``RGBa`` raw mode on every alpha."""
    rng = _rng(11)
    px = rng.integers(0, 256, (64, 64, 4), np.uint8)
    px[..., 3] = np.arange(64 * 64).reshape(64, 64) % 256
    got = dct.unpremultiply(*torch.from_numpy(px).unbind(-1)).numpy()
    mirror = _unpremultiply(px)
    assert np.array_equal(got, mirror)
    want = np.asarray(Image.frombytes("RGBA", (64, 64), px.tobytes(),
                                      "raw", "RGBa"))
    assert np.array_equal(mirror, want)


def _segment_planes(data):
    """Each segment's ``decode_any`` and its page component: planes by
    plane, one component a segment; chunky, every component."""
    info, offs, cnts = tiff.segments(data)
    tables = data[info.tables_off:info.tables_off + info.tables_len]
    grid = info.rows * info.cols
    out = []
    for i, (off, n) in enumerate(zip(offs.tolist(), cnts.tolist())):
        dec = jpeg_abi.decode_any(loader.load(), tiff.segment_stream(
            tables, data[off:off + n]))
        out.append((dec, i // grid if info.planes > 1 else None,
                    (i % grid) // info.cols * info.seg_h))
    return info, out


def test_two_component_jpeg_source_stays_not_ported():
    """A gray + alpha page's segment on its own is a JPEG file of two
    components. The decoder takes it inside a TIFF page; as a source the
    JPEG layer refuses it as Pillow does (its JPEG reader has no mode for
    two components: "cannot identify image file"), a 400 in the JPEG
    decode, ``decode_bytes``, the engine and the fetch stage's header
    check, as in the reference (the name is kept from when it answered
    501; ``tests/test_torch_jpeg_arith_lossless.py`` holds the HTTP
    answers to the reference app's)."""
    data = JPEG_PAGES["gray_with_alpha"]()
    info, offs, cnts = tiff.segments(data)
    off, n = int(offs[0]), int(cnts[0])
    stream = tiff.segment_stream(
        data[info.tables_off:info.tables_off + info.tables_len],
        data[off:off + n])
    assert jpeg_abi.decode_any(loader.load(), stream)[0].ncomp == 2
    with pytest.raises(TransformError, match="cannot identify image file"):
        jpeg.source_header(loader.load(), stream)
    for decode in (jpeg.decode_to_coefficients,
                   lambda d: codecs.decode_bytes(d, device="cpu")):
        with pytest.raises(TransformError, match="cannot identify") as e:
            decode(stream)
        assert not isinstance(e.value, NotPortedError)
    with pytest.raises(TransformError, match="cannot identify"):
        fetch._jpeg_header(stream)
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(stream)
    engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    with pytest.raises(TransformError) as e:
        _drive(engine, [stream], [48], ImageFormat.webp)
    assert not isinstance(e.value, NotPortedError)


@pytest.mark.parametrize("name", sorted(JPEG_PAGES))
def test_jpeg_page_coefficients_and_planes(name):
    """The page's planes are its segments' levels at their places, exactly;
    the IDCT planes exactly libjpeg's islow (within +-1 of the JAX
    package's float IDCT before); K6's output (the identity upsample)
    exactly the IDCT planes, cropped."""
    from tests.test_torch_jpeg_pixels import idct_plane_reference

    data = JPEG_PAGES[name]()
    assert ref_tiff.decode(data) is None
    page = tiff.entropy_decode(data)
    info, segs = _segment_planes(data)
    for (hdr, coeffs, qtabs), plane, y0 in segs:
        comps = [plane] if plane is not None else range(hdr.ncomp)
        for k, c in enumerate(comps):
            by = sum(page.rows[c][:y0 // info.seg_h])
            got = page.coeffs[c][by:by + coeffs[k].shape[0],
                                 :coeffs[k].shape[1]]
            assert np.array_equal(got, coeffs[k]), (name, c, y0)
            assert np.array_equal(page.qtabs[c], qtabs[hdr.comp_tq[k]])
    idct, out = _page_planes(page)
    for c, (p, o) in enumerate(zip(idct, out)):
        want = idct_plane_reference(page.coeffs[c], page.qtabs[c])
        assert np.array_equal(p, want), (name, c)
        assert np.array_equal(o, p[:page.height, :page.width]), (name, c)


@pytest.mark.parametrize("name", sorted(JPEG_PAGES))
def test_jpeg_page_matches_pillow(name):
    """Against Pillow: the same shape and channels, byte for byte (the
    associated alpha's colour too, whose un-premultiply multiplies an IDCT
    step by up to 255 / alpha); the associated alpha's colour exactly the
    mirror of ``unpackRGBa`` on the port's planes."""
    data = JPEG_PAGES[name]()
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (48, 64, 4 if name in ALPHA else 3)
    assert tiff.parse(data) == (64, 48, got.shape[2])
    if "associated" in name:
        page = tiff.entropy_decode(data)
        _, out = _page_planes(page)
        planes = np.stack([p[:48, :64] for p in out], -1)
        assert np.array_equal(got, _unpremultiply(planes))
    assert np.array_equal(got, want)


def _count_k3(monkeypatch):
    calls = []
    real = dct.resize_planes_u8

    def count(planes, *a, **k):
        calls.append(len(planes))
        return real(planes, *a, **k)

    monkeypatch.setattr(dct, "resize_planes_u8", count)
    return calls


@pytest.mark.parametrize("source,want", [
    (lambda: OLD_STYLE["jif_420"](), [3]),
    (lambda: OLD_STYLE["tables_in_tags"](), [3]),
    (lambda: JPEG_PAGES["planar_rgb"](), [3]),
    (lambda: JPEG_PAGES["planar_rgba"](), [4]),
    (lambda: JPEG_PAGES["gray_with_alpha"](), [2]),
    (lambda: JPEG_PAGES["rgb_unspecified_extra"](), [4]),
], ids=["old_style", "old_style_tables", "planar", "planar_rgba", "la",
        "rgbx"])
def test_one_k3_launch_a_page(monkeypatch, source, want):
    """One K6 decode a page, its components together (the old-style page's
    luma and replicated chroma too; two launches on a card), and K3 never
    (the name is kept from when K3 ran the upsample)."""
    from tests.test_torch_jpeg_pixels import count_k6

    calls, k6 = _count_k3(monkeypatch), count_k6(monkeypatch)
    codecs.decode_bytes(source(), device="cpu")
    assert calls == [] and k6 == want


# -- what Pillow refuses, and corrupt data --------------------------------------------


def _raw_ycbcr(rows=None, tile=0):
    px = _rng(6).integers(0, 256, (H, W, 3)).astype(np.uint8)
    tags = {258: (3, [8] * 3), 259: (3, [1]), 262: (3, [6]), 277: (3, [3])}
    if tile:
        chunks = []
        for ty in range(0, H, tile):
            for tx in range(0, W, tile):
                t = np.zeros((tile, tile, 3), np.uint8)
                part = px[ty:ty + tile, tx:tx + tile]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(t.tobytes())
        return _tiff(W, H, tags, chunks, tile=tile)
    if rows:
        tags[278] = (4, [rows])
        return _tiff(W, H, tags, [px[y:y + rows].tobytes()
                                  for y in range(0, H, rows)])
    return _tiff(W, H, tags, [px.tobytes()])


def _jpeg_segments_with(tags_update, planes=1, size=(64, 48)):
    """A one-strip JPEG TIFF of Pillow's segments (one a plane), with the
    tags ``tags_update``."""
    img = make_test_image(*size)
    segs, tables = [], b""
    for c in range(planes):
        tables, seg = chip_smoke.split_jpeg(_save(Image.fromarray(
            img if planes == 1 else img[..., c]), "JPEG", quality=85))
        segs.append(seg)
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [size[1]]), 347: (7, tables), **tags_update}
    return chip_smoke.tiff_file(*size, tags, segs)


REFUSED = {
    # Pillow's raw reader takes four bytes a pixel (RGBX) where the file
    # holds three, and runs out of the file
    "ycbcr_uncompressed": _raw_ycbcr,
    "ycbcr_uncompressed_strips": lambda: _raw_ycbcr(rows=8),
    "ycbcr_uncompressed_tiles": lambda: _raw_ycbcr(tile=16),
    # no mode of Pillow's
    "palette16": lambda: _tiff(W, H, {
        258: (3, [16]), 259: (3, [1]), 262: (3, [3]), 277: (3, [1]),
        320: (3, [i % 65536 for i in range(3 << 16)])},
        [_rng(2).integers(0, 65536, (H, W)).astype("<u2").tobytes()]),
    "jpeg_12_bit": lambda: _jpeg_segments_with({258: (3, [12] * 3)}),
    "jpeg_gray_12_bit": lambda: _jpeg_segments_with(
        {258: (3, [12]), 262: (3, [1]), 277: (3, [1])}),
    "jpeg_ycbcr_fill_order_2": lambda: _jpeg_segments_with({266: (3, [2])}),
    "cmyk_with_alpha": lambda: _tiff(W, H, {
        258: (3, [8] * 5), 259: (3, [1]), 262: (3, [5]), 277: (3, [5]),
        338: (3, [2])}, [bytes(W * H * 5)]),
    "cmyk_fill_order_2": lambda: _tiff(W, H, {
        258: (3, [8] * 4), 259: (3, [32773]), 262: (3, [5]), 266: (3, [2]),
        277: (3, [4])}, [_packbits(bytes(W * H * 4))]),
    "float64": lambda: _tiff(W, H, {258: (3, [64]), 259: (3, [1]),
                                    262: (3, [1]), 277: (3, [1]),
                                    339: (3, [3])}, [bytes(W * H * 8)]),
    "int32_white_is_zero": lambda: _tiff(W, H, {
        258: (3, [32]), 259: (3, [1]), 262: (3, [0]), 277: (3, [1]),
        339: (3, [2])}, [bytes(W * H * 4)]),
    "uint32_big_endian": lambda: _tiff(W, H, {
        258: (3, [32]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1])},
        [bytes(W * H * 4)], le=False),
    "rgb_float32": lambda: _tiff(W, H, {
        258: (3, [32] * 3), 259: (3, [1]), 262: (3, [2]), 277: (3, [3]),
        339: (3, [3] * 3)}, [bytes(W * H * 12)]),
    # Pillow has a mode, and its read fails
    "jpeg_ycbcr_planar": lambda: _jpeg_segments_with(
        {284: (3, [2])}, planes=3),
    "cmyk_extra_planar": lambda: _tiff(W, H, {
        258: (3, [8] * 5), 259: (3, [1]), 262: (3, [5]), 277: (3, [5]),
        284: (3, [2]), 338: (3, [0])}, [bytes(W * H)] * 5),
}
TRUNCATED = ("ycbcr_uncompressed", "ycbcr_uncompressed_strips",
             "ycbcr_uncompressed_tiles")


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_pillow_refuses_answers_as_the_reference(name):
    """A TransformError (400) in both, from the header on (what the fetch
    stage reads); the reference's message where it names no address."""
    data = REFUSED[name]()
    assert ref_tiff.decode(data) is None
    with pytest.raises(ref_codecs.TransformError) as ref_e:
        ref_codecs.decode_bytes(data)
    for decode in (lambda d: codecs.decode_bytes(d, device="cpu"),
                   tiff.parse):
        with pytest.raises(TransformError) as e:
            decode(data)
        assert not isinstance(e.value, NotPortedError), name
        if name in TRUNCATED:
            assert e.value.message == ref_e.value.message
            assert "truncated" in e.value.message


def _patched_first(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with the first value of ``tag`` (LONGs held
    past the IFD) set to ``value``."""
    ifd = struct.unpack("<I", data[4:8])[0]
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == tag:
            off = struct.unpack("<I", data[at + 8:at + 12])[0]
            return data[:off] + struct.pack("<I", value) + data[off + 4:]
    raise KeyError(tag)


CORRUPT = {
    # neither the interchange format nor the strip holds a JPEG
    "old_style_no_jpeg": lambda: _ojpeg(b"\x00" * 600),
    # a frame the IFD does not describe
    "old_style_frame_of_another_size": lambda: _ojpeg(
        _jfif((32, 48)), size=(64, 48)),
    # the tables-in-tags form with a quantisation table past the file
    "old_style_table_past_the_file": lambda: _patched_first(
        _tables_form(), 519, 1 << 20),
}


def fill_order_2_ccitt_row_overshoots() -> bytes:
    """A FillOrder 2 CCITT row whose runs overshoot (the hostile row of
    test_torch_pillow_fallbacks, bits reversed)."""
    return _tiff(8, 1, {
        258: (3, [1]), 259: (3, [2]), 262: (3, [0]), 266: (3, [2]),
        277: (3, [1])}, [_reverse_bits(bytes([0b11011101, 0b10000000]))])


def test_fill_order_2_ccitt_row_overshoots_is_served():
    """The overshooting row, refused here once: libtiff drops the runs past
    the row and ends it white (CLEANUP_RUNS), and so does the port, every
    write bounded by the row: Pillow's pixels."""
    data = fill_order_2_ccitt_row_overshoots()
    want = ref_codecs.decode_bytes(data)[0]
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], want)


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_corrupt_inputs_are_transform_errors(name):
    """Refused, never a crash: a TransformError (400) in both."""
    data = CORRUPT[name]()
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


# -- the engines and the apps ----------------------------------------------------------


ENGINE_SOURCES = {
    "fill_order_2_g4": lambda: _fill_order_2_fax("group4"),
    "cmyk16": lambda: _cmyk16(compression=8, predictor=2),
    "float32_elevation": lambda: _float32(compression=8, predictor=3,
                                          values=_elevation(1, 72, 96)),
    "old_style": lambda: _ojpeg(_jfif((96, 72)), size=(96, 72)),
    "planar_rgb": lambda: _planar((96, 72)),
    "rgb_associated_alpha": lambda: _with_extra_sample(1, (96, 72)),
}


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
    jpeg_coded = name in ("old_style", "planar_rgb", "rgb_associated_alpha")
    # JPEG-coded pages: the host half on the codec pool, the pixel decode
    # on a dispatch thread; the sample layouts decode on the pool, CMYK's
    # colour step on a dispatch thread
    assert ("entropy_decode" in stages) == jpeg_coded
    assert ("decode" in stages) != jpeg_coded
    assert ("device_decode" in stages) == (jpeg_coded or name == "cmyk16")


def test_engine_launches_k3_once_a_page(monkeypatch):
    """An old-style page, a planar page and an RGB page with associated
    alpha: one K6 decode each, K3 never (the name is kept from when K3 ran
    the upsample); the RGB heads one batch for the two pages without
    alpha."""
    from tests.test_torch_jpeg_pixels import count_k6

    calls, k6 = _count_k3(monkeypatch), count_k6(monkeypatch)
    engine = PortEngine(_cfg(port_config, 2), metrics=Metrics(), device="cpu")
    datas = [ENGINE_SOURCES[n]() for n in ("old_style", "planar_rgb")]
    outs = _drive(engine, datas, [48, 48], ImageFormat.webp)
    assert calls == [] and k6 == [3, 3]
    assert engine.metrics.batches == 1
    assert [_out_size(o) for o in outs] == [(48, 36)] * 2
    k6.clear()
    engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    _drive(engine, [ENGINE_SOURCES["rgb_associated_alpha"]()], [48],
           ImageFormat.webp)
    assert calls == [] and k6 == [4]


HTTP_SOURCES = ("fill_order_2_g4", "float32_elevation", "old_style",
                "planar_rgb")


@pytest.mark.parametrize("name", HTTP_SOURCES)
def test_http_serves_as_the_reference(tmp_path, name):
    """``/img`` at w=64 WebP and JPEG and unresized, through both apps."""
    sources = {"ok": ENGINE_SOURCES[name]()}

    async def fn(client):
        return [await _img(client, url=_url("ok"), w=w,
                           f=fmt.value if fmt != ImageFormat.webp else None)
                for w, fmt in MODES]

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref, port):
        assert (ps, pct) == (rs, rct) == (200, pct), pbody[:200]
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0


def test_http_refusals_answer_as_the_reference(tmp_path):
    """What Pillow refuses and corrupt old-style pages: ``/img`` gives the
    reference's status and body (the fetch stage's 400), ``/upload`` its
    status, and its body where that holds no address (the raw YCbCr
    pages': Pillow's "image file is truncated (n bytes not processed)";
    "cannot identify image file <... at 0x...>" names an object's
    address)."""
    names = sorted(REFUSED) + ["old_style_no_jpeg"]
    sources = {n: (REFUSED.get(n) or CORRUPT[n])() for n in names}

    async def fn(client):
        outs = []
        for name in names:
            img = await _img(client, url=_url(name), w=64)
            form = FormData()
            form.add_field("file", sources[name], filename="x")
            form.add_field("w", "48")
            r = await client.post("/upload", data=form)
            outs.append((img, (r.status, await r.read())))
        return outs

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for name, (r_img, r_up), (p_img, p_up) in zip(names, ref, port):
        assert p_img == r_img, name
        assert p_img[0] == 400 and p_img[2] == VALIDATION, name
        assert p_up[0] == r_up[0] == 400, (name, p_up, r_up)
        if name in TRUNCATED:
            assert p_up == r_up, name


def test_http_upload_of_the_new_layouts(tmp_path):
    names = ("cmyk16", "old_style", "rgb_associated_alpha")

    async def fn(client):
        outs = []
        for name in names:
            form = FormData()
            form.add_field("file", ENGINE_SOURCES[name](), filename="x")
            form.add_field("w", "48")
            form.add_field("f", "jpeg")
            r = await client.post("/upload", data=form)
            outs.append((r.status, r.headers.get("Content-Type"),
                         await r.read()))
        return outs

    ref = _serve(tmp_path, "ref", {}, fn)
    port = _serve(tmp_path, "port", {}, fn)
    for name, (rs, rct, rbody), (ps, pct, pbody) in zip(names, ref, port):
        assert (ps, pct) == (rs, rct) == (200, "image/jpeg"), name
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0


def test_fetch_validates_the_new_layouts_by_header():
    """The fetch stage takes each new layout by its header and reports
    its geometry; what Pillow refuses is its 400."""
    async def run(data):
        return await fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/tiff", data)}))

    for make in (*ENGINE_SOURCES.values(), OLD_STYLE["tables_in_tags"],
                 JPEG_PAGES["gray_with_alpha"], SAMPLES["uint32"]):
        data = make()
        assert asyncio.run(run(data))[0] == data
    for name in ("ycbcr_uncompressed", "palette16", "jpeg_12_bit",
                 "cmyk_with_alpha"):
        with pytest.raises(InvalidArgumentError, match="validation"):
            asyncio.run(run(REFUSED[name]()))


def test_port_serves_the_new_layouts_without_pillow(tmp_path):
    """A FillOrder 2 G4 page, a 16-bit CMYK page, a float32 raster, an
    old-style JPEG and a planar JPEG page, written here, through
    ``BatchedEngine(device="cpu")`` in a subprocess that then holds no
    Pillow, no ``jax`` and no ``imagekit_tpu`` module."""
    names = ("fill_order_2_g4", "cmyk16", "float32_elevation", "old_style",
             "planar_rgb")
    for name in names:
        (tmp_path / name).write_bytes(ENGINE_SOURCES[name]())
    script = textwrap.dedent("""
        import asyncio, json, sys
        from pathlib import Path
        from imagekit_tpu_torch.codecs import vp8
        from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
        from imagekit_tpu_torch.serving.batcher import BatchedEngine
        from imagekit_tpu_torch.serving.metrics import Metrics

        datas = [(Path(sys.argv[1]) / n).read_bytes() for n in sys.argv[2:]]
        engine = BatchedEngine(ImageKitConfig(secret="s", batch=BatchConfig(
            max_batch=1)), metrics=Metrics(), device="cpu")

        async def run():
            try:
                return await asyncio.gather(*(
                    engine.transform(d, 32, None, ImageFormat.webp, 80)
                    for d in datas))
            finally:
                await engine.close()

        outs = asyncio.run(run())
        print(json.dumps({
            "sizes": [list(vp8.dimensions(o)) for o in outs],
            "mods": sorted(m for m in sys.modules if m.split(".")[0] in (
                "PIL", "jax", "imagekit_tpu"))}))
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path),
                           *names], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    sizes = {"fill_order_2_g4": (300, 40), "cmyk16": (W, H)}
    assert res["sizes"] == [
        list(weights.target_dimensions(*sizes.get(n, (96, 72)), 32, None))
        for n in names]
    assert res["mods"] == []
