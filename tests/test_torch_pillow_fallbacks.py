"""The BMP, TIFF and progressive CMYK sources the reference still hands to
Pillow, in the port, on the CPU.

The reference's native BMP and TIFF decoders (``misc_decode.cpp``,
``tiff_decode.cpp``, pinned byte-equal in the port) refuse these layouts
with -3 and the reference decodes them with Pillow; the port tries its own
(``codecs/native/bmp_ext_decode.cpp``, ``tiff_ext_decode.cpp``) there.
Progressive CMYK and YCCK JPEGs go through the port's four-component
decoder (``jpeg4_decode.cpp``), now with SOF2. Fixtures are written by
Pillow from numpy seeds, or by hand with ``struct`` where Pillow writes no
such file (2- and 4-bit TIFFs, planar and tiled CMYK, every BMP layout).

- Every BMP and TIFF layout: exactly the pixels and channel count of the
  JAX package's ``decode_bytes`` (Pillow), after its pinned decoder said
  -3; the header parse gives the decoded geometry.
- Progressive CMYK: the coefficient planes and quant tables of ``decode4``
  on Pillow's progressive save equal those of its baseline save, exactly;
  the four planes within +-1 on at most 0.1% of the JAX package's
  ``_blocks_to_plane`` under K3's semantics, the decode >= 40 dB with
  |d| <= 12 against Pillow.
- Both engines and both apps: outputs within 38 dB of the reference's;
  ``/img`` statuses and bodies equal the reference's for a corrupt source
  of each new decoder, for what Pillow refuses and for the bilevel TIFF
  without BitsPerSample.
- Hostile inputs are refused, and refused without an out-of-bounds access:
  the three port-only decoders built with AddressSanitizer and
  UndefinedBehaviorSanitizer decode every fixture and every hostile input
  in a subprocess that must report nothing.
"""

import asyncio
import io
import json
import os
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
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import misc as ref_misc
from imagekit_tpu.codecs import tiff as ref_tiff
from imagekit_tpu_torch import codecs, fetch, transform
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import jpeg, misc, tiff
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import (
    InvalidArgumentError,
    NotPortedError,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.ops import dct, weights
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from tests.conftest import make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import (
    LAYOUTS,
    MODES,
    _decoded,
    _img,
    _jax_planes,
    _mode_id,
    _pil_rgb,
    _run_engines,
    _save,
    _serve,
    _url,
    psnr,
)
from tests.test_torch_rgba_slice import _cfg, _drive, _out_size
from tests.test_torch_webp_slice import _CannedFetcher

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders: it is built in place with no lock, and a worker whose first
    load meets another's half-written build would decode through Pillow
    alone (``_ref_native_lib`` retries the load)."""
    _ref_native_lib(monkeypatch)


MAX_SHARE = 1e-3
VALIDATION = b"Invalid argument: Unable to decode image for validation"


# -- writers -----------------------------------------------------------------------


def _tiff(w, h, tags, strips, le=True, tiles=None) -> bytes:
    """A TIFF by hand: ``tags`` {tag: (type, [values])} (types 3 SHORT, 4
    LONG), ``strips`` the strip (or, with ``tiles`` = (tw, th), tile)
    payloads, whose offsets and counts are filled in."""
    e = "<" if le else ">"
    data, offs = b"", []
    for s in strips:
        offs.append(8 + len(data))
        data += s + b"\0" * (len(s) % 2)
    tags = {256: (4, [w]), 257: (4, [h]), **tags}
    if tiles:
        tags.update({322: (3, [tiles[0]]), 323: (3, [tiles[1]]),
                     324: (4, offs), 325: (4, [len(s) for s in strips])})
    else:
        tags.update({273: (4, offs), 279: (4, [len(s) for s in strips])})
    ifd_off = 8 + len(data)
    extra_off = ifd_off + 2 + 12 * len(tags) + 4
    ifd, extra = struct.pack(e + "H", len(tags)), b""
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = b"".join(struct.pack(e + {3: "H", 4: "I"}[typ], v) for v in vals)
        ifd += struct.pack(e + "HHI", t, typ, len(vals))
        if len(raw) <= 4:
            ifd += raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "I", extra_off + len(extra))
            extra += raw
    head = (b"II*\0" if le else b"MM\0*") + struct.pack(e + "I", ifd_off)
    return head + data + ifd + struct.pack(e + "I", 0) + extra


def _pack(samples: np.ndarray, bits: int) -> bytes:
    """Rows of samples of 1, 2, 4 or 8 bits, MSB first, each row padded to
    a byte."""
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // bits
    h, w = samples.shape
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = samples
    g = padded.reshape(h, -1, per)
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
    return (g << shifts).sum(axis=2, dtype=np.uint16).astype(np.uint8).tobytes()


def _packbits(data: bytes) -> bytes:
    """PackBits with repeat packets for runs of three or more."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _bilevel(w: int, h: int, seed: int) -> np.ndarray:
    """True for white: rows of random runs (long ones too, for the
    make-up codes up to 2560), every other row the one above shifted by a
    few pixels (the 2-D modes' vertical codes)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((h, w), bool)
    for y in range(h):
        if y % 2 and y > 0:
            a[y] = np.roll(a[y - 1], int(rng.integers(-3, 4)))
            continue
        x, c = 0, bool(rng.integers(2))
        while x < w:
            n = int(rng.integers(0, 3000) if rng.random() < 0.2
                    else rng.integers(0, 70))
            a[y, x:x + n] = c
            x, c = x + n, not c
    return a


def _pil_tiff(img, compression, **kw) -> bytes:
    return _save(Image.fromarray(img), "TIFF", compression=compression, **kw)


def _set_short(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with the inline SHORT value of ``tag`` set."""
    ifd = struct.unpack("<I", data[4:8])[0]
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == tag:
            return (data[:at + 8] + struct.pack("<H", value)
                    + data[at + 10:])
    raise KeyError(tag)


def _bmp(w, h, bits, comp, rows, hsz=40, masks=None, palette=b"",
         top_down=False) -> bytes:
    """A BMP by hand: ``rows`` bottom-up (top-down where ``top_down``),
    each padded to 4 bytes; masks in the header (52 bytes and more) or
    after a 40-byte one."""
    if hsz == 12:
        header = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        header = struct.pack("<IiiHHIIiiII", hsz, w, -h if top_down else h,
                             1, bits, comp, len(rows), 2835, 2835, 0, 0)
        if hsz > 40:
            m = list(masks or ()) + [0] * 4
            header += struct.pack("<IIII", *m[:4])[:hsz - 40]
            header += bytes(hsz - len(header))
    after = (struct.pack("<III", *masks[:3])
             if hsz == 40 and comp == 3 else b"")
    off = 14 + len(header) + len(after) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + header
            + after + palette + rows)


def _bmp_rows(values: np.ndarray, bits: int, top_down=False) -> bytes:
    """(h, w) pixel values of ``bits`` (16, 24 or 32, little-endian), or
    palette indices of 1, 4 or 8 bits, as BMP rows."""
    h, w = values.shape
    if bits <= 8:
        rows = np.frombuffer(_pack(values, bits), np.uint8).reshape(h, -1)
    else:
        rows = (values.astype("<u4").view(np.uint8).reshape(h, w, 4)
                [:, :, :bits // 8].reshape(h, -1))
    pad = (-rows.shape[1]) % 4
    rows = np.pad(rows, ((0, 0), (0, pad)))
    return (rows if top_down else rows[::-1]).tobytes()


W, H = 29, 11


def _values(bits, seed=0, shape=(H, W)):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape,
                                                dtype=np.uint64)


MASKS32 = {"bgrx": (0xFF0000, 0xFF00, 0xFF, 0),
           "xbgr": (0xFF000000, 0xFF0000, 0xFF00, 0),
           "bgxr": (0xFF000000, 0xFF00, 0xFF, 0),
           "abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
           "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           "bgar": (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
           "zero": (0, 0, 0, 0)}


def _core(bits):
    if bits <= 8:
        pal = np.random.default_rng(bits).integers(
            0, 256, 3 << bits).astype(np.uint8).tobytes()
        return _bmp(W, H, bits, 0, _bmp_rows(_values(bits), bits), hsz=12,
                    palette=pal)
    return _bmp(W, H, bits, 0, _bmp_rows(_values(bits), bits), hsz=12)


BMPS = {
    **{f"core{b}": (lambda b=b: _core(b)) for b in (1, 4, 8, 16, 24, 32)},
    "rgb16": lambda: _bmp(W, H, 16, 0, _bmp_rows(_values(16), 16)),
    "bf565": lambda: _bmp(W, H, 16, 3, _bmp_rows(_values(16), 16),
                          masks=(0xF800, 0x7E0, 0x1F)),
    "bf555": lambda: _bmp(W, H, 16, 3, _bmp_rows(_values(16), 16),
                          masks=(0x7C00, 0x3E0, 0x1F)),
    "bf565_v4_top_down": lambda: _bmp(
        W, H, 16, 3, _bmp_rows(_values(16), 16, top_down=True), hsz=108,
        masks=(0xF800, 0x7E0, 0x1F), top_down=True),
    "bf24": lambda: _bmp(W, H, 24, 3, _bmp_rows(_values(24), 24),
                         masks=(0xFF0000, 0xFF00, 0xFF)),
    **{f"bf32_{name}_h{hsz}": (lambda m=m, hsz=hsz: _bmp(
        W, H, 32, 3, _bmp_rows(_values(32), 32), hsz=hsz, masks=m))
       for name, m in MASKS32.items() for hsz in (40, 52, 56, 64, 108, 124)
       # Pillow takes a 40- or 52-byte header's alpha mask as 0, so these
       # two mask sets are no layout it reads there
       if not (hsz in (40, 52) and name in ("rgba",))},
    "bf32_bgra_v5_top_down": lambda: _bmp(
        W, H, 32, 3, _bmp_rows(_values(32), 32, top_down=True), hsz=124,
        masks=MASKS32["bgra"], top_down=True),
}


def _gray_tiff(bits, photo, compression, le=True):
    s = _values(bits, seed=bits + photo).astype(np.uint8)
    raw = _pack(s, bits)
    body = {1: raw, 32773: _packbits(raw), 8: zlib.compress(raw)}[compression]
    tags = {258: (3, [bits]), 259: (3, [compression]), 262: (3, [photo]),
            277: (3, [1]), 278: (3, [H])}
    if photo == 3:
        tags[320] = (3, [int(v) for v in np.random.default_rng(9).integers(
            0, 65536, 3 << bits)])
    return _tiff(W, H, tags, [body], le=le)


def _alpha_img(mode, w=37, h=23):
    """A test image as Pillow's LA or PA, its alpha a ramp of every
    value."""
    img = Image.fromarray(make_test_image(w, h))
    pic = img.convert("L") if mode == "LA" else img.convert("P")
    pic = pic.convert(mode)
    pic.putalpha(Image.fromarray(
        (np.arange(w * h) % 256).astype(np.uint8).reshape(h, w)))
    return pic


def _cmyk_img(w=37, h=23):
    return Image.fromarray(make_test_image(w, h)).convert("CMYK")


def _cmyk_planar():
    px = np.asarray(_cmyk_img())
    h, w = px.shape[:2]
    return _tiff(w, h, {258: (3, [8] * 4), 259: (3, [1]), 262: (3, [5]),
                        277: (3, [4]), 278: (3, [h]), 284: (3, [2])},
                 [px[..., c].tobytes() for c in range(4)])


def _cmyk_tiled():
    px = np.asarray(_cmyk_img(37, 23))
    tiles = []
    for ty in range(0, 32, 16):
        for tx in range(0, 48, 16):
            t = np.zeros((16, 16, 4), np.uint8)
            part = px[ty:ty + 16, tx:tx + 16]
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(t.tobytes())
    return _tiff(37, 23, {258: (3, [8] * 4), 259: (3, [1]), 262: (3, [5]),
                          277: (3, [4])}, tiles, tiles=(16, 16))


PAGE = _bilevel(2700, 24, 0)
SMALL_PAGE = _bilevel(300, 40, 1)
CCITT = {"mh": "tiff_ccitt", "g3": "group3", "g4": "group4"}

TIFFS = {
    **{f"bilevel_{k}": (lambda c=c: _pil_tiff(PAGE, c))
       for k, c in (("packbits", "packbits"), ("lzw", "tiff_lzw"),
                    ("deflate", "tiff_adobe_deflate"), *CCITT.items())},
    "bilevel_g3_2d": lambda: _pil_tiff(PAGE, "group3", tiffinfo={292: 1}),
    "bilevel_g3_fill": lambda: _pil_tiff(PAGE, "group3", tiffinfo={292: 4}),
    "bilevel_g3_2d_fill": lambda: _pil_tiff(PAGE, "group3",
                                            tiffinfo={292: 5}),
    **{f"bilevel_{k}_strips": (lambda c=c: _pil_tiff(
        SMALL_PAGE, c, tiffinfo={278: 8}))
       for k, c in (("g3", "group3"), ("g4", "group4"), ("mh", "tiff_ccitt"))},
    "bilevel_g3_2d_strips": lambda: _pil_tiff(
        SMALL_PAGE, "group3", tiffinfo={278: 8, 292: 1}),
    **{f"bilevel_{k}_white_is_zero": (lambda c=c: _set_short(
        _pil_tiff(PAGE, c), 262, 0)) for k, c in (
            ("packbits", "packbits"), *CCITT.items())},
    "bilevel_none": lambda: _tiff(
        W, H, {258: (3, [1]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1])},
        [_pack(_values(1), 1)]),
    "bilevel_none_big_endian": lambda: _tiff(
        W, H, {258: (3, [1]), 259: (3, [1]), 262: (3, [0])},
        [_pack(_values(1), 1)], le=False),
    **{f"{'palette' if p == 3 else 'gray'}{b}_{p}_{k}": (
        lambda b=b, p=p, c=c: _gray_tiff(b, p, c))
       for b in (2, 4) for p in (0, 1, 3)
       for k, c in (("none", 1), ("packbits", 32773), ("deflate", 8))},
    "palette1_none": lambda: _gray_tiff(1, 3, 1),
    "gray4_big_endian": lambda: _gray_tiff(4, 1, 1, le=False),
    **{f"cmyk_{k}": (lambda c=c: _save(_cmyk_img(), "TIFF", compression=c))
       for k, c in (("none", "raw"), ("packbits", "packbits"),
                    ("lzw", "tiff_lzw"), ("deflate", "tiff_adobe_deflate"))},
    "cmyk_lzw_predictor": lambda: _save(_cmyk_img(), "TIFF",
                                        compression="tiff_lzw",
                                        tiffinfo={317: 2}),
    "cmyk_strips": lambda: _save(_cmyk_img(), "TIFF", compression="packbits",
                                 tiffinfo={278: 4}),
    "cmyk_planar": _cmyk_planar,
    "cmyk_tiled": _cmyk_tiled,
    # Pillow's LA and PA (gray and palette with unassociated alpha): RGBA
    **{f"{name}_{k}": (lambda m=mode, c=c, kw=kw: _save(
        _alpha_img(m), "TIFF", compression=c, **kw))
       for name, mode in (("gray_alpha", "LA"), ("palette_alpha", "PA"))
       for k, c, kw in (("none", "raw", {}), ("packbits", "packbits", {}),
                        ("lzw", "tiff_lzw", {}),
                        ("deflate", "tiff_adobe_deflate", {}),
                        ("lzw_predictor", "tiff_lzw", {"tiffinfo": {317: 2}}),
                        ("strips", "packbits", {"tiffinfo": {278: 4}}))},
}
SOURCES = {**{f"bmp_{k}": v for k, v in BMPS.items()},
           **{f"tiff_{k}": v for k, v in TIFFS.items()}}


def _pinned(name):
    return ref_misc.decode_bmp if name.startswith("bmp") else ref_tiff.decode


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_decode_equals_the_reference(name):
    """The reference's pinned decoder refuses the layout (None: Pillow
    decodes it); the port's own gives Pillow's pixels and channels, and its
    header parse the decoded geometry."""
    data = SOURCES[name]()
    assert _pinned(name)(data) is None
    want, ref_fmt = ref_codecs.decode_bytes(data)
    got, fmt = codecs.decode_bytes(data, device="cpu")
    assert fmt.value == ref_fmt.value
    assert got.shape == want.shape and np.array_equal(got, want)
    parse = misc.parse_bmp if name.startswith("bmp") else tiff.parse
    h, w, ch = got.shape
    assert parse(data) == (w, h, ch)


def test_the_cases_hold_their_layouts():
    """The fixtures are what their names say: the CCITT ones in their
    compressions and T4Options, the strips several, the BMPs with alpha
    where Pillow reads it."""
    def tags(data):
        with Image.open(io.BytesIO(data)) as im:
            return dict(im.tag_v2)

    for k, c in (("mh", 2), ("g3", 3), ("g4", 4), ("g3_2d", 3)):
        t = tags(SOURCES[f"tiff_bilevel_{k}"]())
        assert t[259] == c and t[262] == 1
    assert tags(SOURCES["tiff_bilevel_g3_2d_fill"]())[292] == 5
    assert len(tags(SOURCES["tiff_bilevel_g4_strips"]())[273]) == 5
    assert tags(SOURCES["tiff_bilevel_g4_white_is_zero"]())[262] == 0
    assert tags(SOURCES["tiff_cmyk_lzw_predictor"]())[317] == 2
    for name in ("bf32_bgra_h56", "bf32_zero_h40", "bf32_rgba_h124"):
        assert misc.parse_bmp(SOURCES[f"bmp_{name}"]())[2] == 4
    for name in ("bf32_bgra_h52", "bf32_bgrx_h124", "bf565", "core24"):
        assert misc.parse_bmp(SOURCES[f"bmp_{name}"]())[2] == 3


@pytest.mark.parametrize("bits", [15, 16])
def test_565_and_555_widen_as_pillow(bits):
    """Every 16-bit value through both layouts: Pillow's v * 255 / 31 and
    v * 255 / 63, truncated."""
    v = np.arange(65536, dtype=np.uint64).reshape(256, 256)
    masks = (0xF800, 0x7E0, 0x1F) if bits == 16 else (0x7C00, 0x3E0, 0x1F)
    data = _bmp(256, 256, 16, 3, _bmp_rows(v, 16), masks=masks)
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert np.array_equal(got, ref_codecs.decode_bytes(data)[0])


def test_tiff_cmyk_colour_is_cmyk_to_rgb_on_inverted_planes():
    """The TIFF's stored CMYK through ``ops/color.py::cmyk_to_rgb`` (the
    one colour step of the port) equals Pillow's ``convert("RGB")``."""
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, (19, 31, 4), np.uint8)
    px[0, :, 3], px[1, :, 3] = 0, 255
    want = np.asarray(Image.frombytes("CMYK", (31, 19), px.tobytes())
                      .convert("RGB"))
    assert np.array_equal(tiff.cmyk_to_rgb(px, device="cpu"), want)


# -- what Pillow refuses, what stays 501 ---------------------------------------------


def _patch(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


REFUSED = {
    "bmp_alphabitfields": lambda: _bmp(W, H, 32, 6, _bmp_rows(_values(32),
                                                              32),
                                       masks=(0xFF0000, 0xFF00, 0xFF)),
    "bmp_unknown_masks": lambda: _bmp(W, H, 32, 3, _bmp_rows(_values(32), 32),
                                      masks=(0xFF, 0xFF00, 0xFF0000)),
    "bmp_2bit": lambda: _bmp(W, H, 2, 0, _bmp_rows(_values(2), 2),
                             palette=bytes(16)),
    "bmp_zero_width_mask": lambda: _bmp(W, H, 16, 3,
                                        _bmp_rows(_values(16), 16),
                                        masks=(0, 0x7E0, 0x1F)),
    "bmp_header_16": lambda: _patch(BMPS["rgb16"](), 14,
                                    struct.pack("<I", 16)),
    "bmp_jpeg_compression": lambda: _bmp(W, H, 24, 4,
                                         _bmp_rows(_values(24), 24)),
    "bmp_bitfields_8bpp": lambda: _bmp(W, H, 8, 3, _bmp_rows(_values(8), 8),
                                       masks=(0xE0, 0x1C, 0x3), palette=bytes(
                                           1024)),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_pillow_refuses_is_a_transform_error(name):
    data = REFUSED[name]()
    assert _pinned(name)(data) is None  # the reference asks Pillow
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


def test_bilevel_tiff_without_bits_per_sample_keeps_its_parity_trap():
    """Pillow writes an uncompressed bilevel TIFF without BitsPerSample; the
    pinned parser takes 8 bits and finds the strip short (-1) before any
    fallback, in the reference as in the port."""
    data = _pil_tiff(PAGE, "raw")
    with Image.open(io.BytesIO(data)) as im:
        assert 258 not in im.tag_v2
    with pytest.raises(ValueError, match="-1"):
        ref_tiff.decode(data)
    for decode, error in ((ref_codecs.decode_bytes, ref_codecs.TransformError),
                          (lambda d: codecs.decode_bytes(d, device="cpu"),
                           TransformError)):
        with pytest.raises(error) as e:
            decode(data)
        assert "(-1)" in str(e.value)


def _fill_order_2():
    """A raw bilevel TIFF in FillOrder 2: decoded by the port's own decoder
    (``tests/test_torch_tiff_remainder.py`` holds its pixels to Pillow's)."""
    return _tiff(W, H, {258: (3, [1]), 259: (3, [1]), 262: (3, [1]),
                        266: (3, [2])}, [_pack(_values(1), 1)])


#: layouts that answered 501 here, decoded now
#: (``tests/test_torch_tiff_lab_ycbcr.py`` holds them and their kin)
STILL_501 = {
    # CIELab: Pillow's LAB unpacker, then littleCMS's LAB -> sRGB
    "tiff_cielab": lambda: _tiff(W, H, {258: (3, [8] * 3), 259: (3, [1]),
                                        262: (3, [8]), 277: (3, [3])},
                                 [_values(8, shape=(H, W, 3)).astype(
                                     np.uint8).tobytes()]),
    # YCbCr compressed without JPEG: libtiff's RGBA interface decodes it
    "tiff_ycbcr_deflate": lambda: _tiff(
        W, H, {258: (3, [8] * 3), 259: (3, [8]), 262: (3, [6]),
               277: (3, [3]), 530: (3, [1, 1])},
        [zlib.compress(_values(8, shape=(H, W, 3)).astype(
            np.uint8).tobytes())]),
    # 16-bit CMYK in planes: Pillow reads each plane as 8-bit samples
    "tiff_cmyk16_planar": lambda: _tiff(
        W, H, {258: (3, [16] * 4), 259: (3, [1]), 262: (3, [5]),
               277: (3, [4]), 284: (3, [2])},
        [_values(16, seed=c).astype("<u2").tobytes() for c in range(4)]),
}


@pytest.mark.parametrize("name", sorted(STILL_501))
def test_layouts_neither_decoder_takes_stay_not_ported(name):
    """Pillow reads them (the reference serves them); the port, which
    answered 501 here (the name is kept), decodes them to Pillow's pixels
    exactly, the header giving their geometry. (FillOrder 2, CMYK with an
    extra sample, old-style and planar JPEG, once here, are decoded too:
    ``tests/test_torch_tiff_remainder.py``.)"""
    data = STILL_501[name]()
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and np.array_equal(got, want)
    assert tiff.parse(data) == (want.shape[1], want.shape[0], want.shape[2])


@pytest.mark.parametrize("name", ["tiff_jpeg_rgb", "tiff_gray_alpha"])
def test_layouts_that_left_the_501s_are_served(name):
    """Pillow's JPEG TIFF (photometric RGB, not YCbCr: Pillow writes an RGB
    image's components as they are) and its LA TIFF, once 501 here, are
    served: the JPEG within the pixel decode's bounds of Pillow's pixels,
    the LA exactly, as RGBA."""
    img = Image.fromarray(make_test_image(48, 32))
    data = _save(img if name == "tiff_jpeg_rgb" else img.convert("LA"),
                 "TIFF", **({"compression": "jpeg"}
                            if name == "tiff_jpeg_rgb" else {}))
    with Image.open(io.BytesIO(data)) as im:
        assert im.tag_v2[262] == (2 if name == "tiff_jpeg_rgb" else 1)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (32, 48, 3 if name == "tiff_jpeg_rgb"
                                       else 4)
    if name == "tiff_jpeg_rgb":
        assert psnr(got, want) >= 40.0
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 12
    else:
        assert np.array_equal(got, want)
    assert tiff.parse(data) == (48, 32, got.shape[2])


@pytest.mark.parametrize("name", ["bmp_core24", "tiff_bilevel_g4"])
def test_pixel_ceiling_is_the_constant(monkeypatch, name):
    data = SOURCES[name]()
    monkeypatch.setattr(misc, "MAX_PIXELS", 20)
    with pytest.raises(TransformError, match="too large"):
        codecs.decode_bytes(data, device="cpu")


# -- hostile inputs ---------------------------------------------------------------

# (code, length) of a few T.4 codes, for writing CCITT streams by hand
WHITE = {0: ("00110101", 8), 4: ("1011", 4), 64: ("11011", 5)}
BLACK = {0: ("0000110111", 10), 3: ("10", 2)}


def _bits(*codes: str) -> bytes:
    s = "".join(codes)
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def _fax(bits: bytes, compression: int, w=8, h=1, t4=None) -> bytes:
    tags = {258: (3, [1]), 259: (3, [compression]), 262: (3, [0]),
            277: (3, [1])}
    if t4 is not None:
        tags[292] = (4, [t4])
    return _tiff(w, h, tags, [bits])


def _palette_past_colormap():
    tags = {258: (3, [2]), 259: (3, [1]), 262: (3, [3]), 277: (3, [1]),
            320: (3, [0, 1 << 8, 2 << 8, 3 << 8, 4 << 8, 5 << 8])}
    return _tiff(4, 1, tags, [_pack(np.array([[0, 1, 3, 2]]), 2)])


def _sof2_dht(dht: bytes, scans=()) -> bytes:
    """SOI, DQT, a 16x16 four-component SOF2 (every component 1x1), a DHT
    segment and then the scans (SOS header bytes, entropy bytes), EOI."""
    q = b"\x00" + bytes([1] * 64)
    sof = bytes([8, 0, 16, 0, 16, 4]) + b"".join(
        bytes([c, 0x11, 0]) for c in (1, 2, 3, 4))
    out = (b"\xff\xd8" + b"\xff\xdb" + struct.pack(">H", 2 + len(q)) + q
           + b"\xff\xc2" + struct.pack(">H", 2 + len(sof)) + sof
           + b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht)
    for header, data in scans:
        out += b"\xff\xda" + struct.pack(">H", 2 + len(header)) + header + data
    return out + b"\xff\xd9"


def _table(tc_th: int, symbols) -> bytes:
    """A DHT table of 2-bit codes (00, 01, 10) for up to three symbols."""
    counts = [0] * 16
    counts[1] = len(symbols)
    return bytes([tc_th]) + bytes(counts) + bytes(symbols)


# DC table 0: 00 -> category 0; AC table 0: 00 EOB, 01 EOB run of 2^14
# and 14 bits, 10 EOB run of 2^2 and 2 bits
_TABLES = _table(0x00, [0]) + _table(0x10, [0x00, 0xE0, 0x20])
_DC_SCAN = (bytes([4, 1, 0, 2, 0, 3, 0, 4, 0, 0, 0, 0]), bytes(4))


def _ac_scan(*codes) -> tuple:
    return (bytes([1, 1, 0, 1, 63, 0]), _bits(*codes).replace(
        b"\xff", b"\xff\x00"))


def _progressive(*scans) -> bytes:
    return _sof2_dht(_TABLES, (_DC_SCAN, *scans))


HOSTILE = {
    # CCITT: a white run of 64 + 4 in a row 8 pixels wide (MH, G3 1-D)
    "ccitt_run_past_the_row_mh": lambda: _fax(
        _bits(WHITE[64][0], WHITE[4][0]), 2),
    "ccitt_run_past_the_row_g3": lambda: _fax(
        _bits("000000000001", WHITE[64][0], WHITE[4][0]), 3),
    # G4: horizontal mode, white 4 then black 3 + ... past 8
    "ccitt_run_past_the_row_g4": lambda: _fax(
        _bits("001", WHITE[4][0], BLACK[3][0], "001", WHITE[4][0],
              BLACK[3][0]), 4),
    # a row of 12 zero bits: no code of the white table
    "ccitt_no_code_mh": lambda: _fax(bytes(4), 2),
    # G4 uncompressed-mode extension (0000001xxx), and no mode code at all
    "ccitt_extension_g4": lambda: _fax(_bits("0000001111"), 4),
    "ccitt_no_code_g4": lambda: _fax(bytes(8), 4),
    # horizontal runs of 0 and 0 that never advance a0
    "ccitt_runs_that_do_not_advance": lambda: _fax(
        _bits(*["001", WHITE[0][0], BLACK[0][0]] * 64), 4),
    # an EOL inside a row
    "ccitt_eol_inside_a_row": lambda: _fax(
        _bits("000000000001", WHITE[4][0], "000000000001"), 3),
    "ccitt_cut_mid_row": lambda: _fax(_bits(WHITE[4][0]), 4, w=64, h=2),
    "tiff_palette_index_past_the_colormap": _palette_past_colormap,
    "bmp_zero_width_mask": REFUSED["bmp_zero_width_mask"],
    "bmp_core_palette_cut": lambda: _core(8)[:26 + 300],
    "bmp_pixels_cut": lambda: BMPS["bf565"]()[:-7],
    # progressive JPEGs: an EOB run of 2^14 + 16383 blocks in a scan of 4
    "jpeg_eob_run_past_the_scan": lambda: _progressive(
        _ac_scan("01", "1" * 14)),
    # an AC scan of Se < Ss, and an AC scan of two components
    "jpeg_bad_spectral_band": lambda: _sof2_dht(_TABLES, (
        _DC_SCAN, (bytes([1, 1, 0, 9, 3, 0]), bytes(2)))),
    "jpeg_interleaved_ac_scan": lambda: _sof2_dht(_TABLES, (
        _DC_SCAN, (bytes([2, 1, 0, 2, 0, 1, 63, 0]), bytes(2)))),
    # refinement of more than one bit at once
    "jpeg_refinement_of_two_bits": lambda: _sof2_dht(_TABLES, (
        _DC_SCAN, (bytes([1, 1, 0, 1, 63, 0x20]), bytes(2)))),
    "jpeg_oversubscribed_table": lambda: _sof2_dht(
        bytes([0x10]) + bytes([3] + [0] * 15) + bytes(3)),
    "jpeg_no_scan": lambda: _sof2_dht(_TABLES)[:-2],
}


#: the hostile inputs libtiff and libjpeg decode leniently, which the
#: reference serves and the port now decodes to Pillow's pixels: CCITT rows
#: whose runs pass the row (libtiff's CLEANUP_RUNS drops them and ends the
#: row white), a G4 uncompressed-mode extension (libtiff ends the row in
#: the colour at a0), a row with no code of the table and an EOL inside a
#: row (libtiff ends the row there and decodes on), an EOB run past a
#: progressive scan's last block (libjpeg ends it with the scan)
SERVED = ("ccitt_run_past_the_row_mh", "ccitt_run_past_the_row_g3",
          "ccitt_run_past_the_row_g4", "ccitt_extension_g4",
          "ccitt_cut_mid_row", "ccitt_no_code_mh", "ccitt_eol_inside_a_row",
          "jpeg_eob_run_past_the_scan")


def test_progressive_writer_makes_a_valid_jpeg():
    """The hand-made progressive frame the hostile cases vary decodes when
    its EOB run covers the scan's other three blocks exactly."""
    data = _progressive(_ac_scan("10", "00"))
    hdr, coeffs, _ = jpeg_abi.decode_any(loader.load(), data)
    assert hdr.progressive and hdr.ncomp == 4
    assert all(not c.any() for c in coeffs)


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_inputs_are_refused(name):
    """Refused, as Pillow refuses them; those of :data:`SERVED` (refused
    here once, the name is kept) decode to Pillow's pixels: exactly for
    CCITT, within the JPEG pixel decode's band of them for the JPEG."""
    data = HOSTILE[name]()
    if name in SERVED:
        want = ref_codecs.decode_bytes(data)[0]
        got = codecs.decode_bytes(data, device="cpu")[0]
        assert got.shape == want.shape
        if name.startswith("ccitt"):
            assert np.array_equal(got, want)
        else:
            assert psnr(got, want) >= 40.0
        return
    if name.startswith("jpeg"):
        with pytest.raises(jpeg_abi.NativeJpegError) as e:
            jpeg_abi.decode_any(loader.load(), data)
        assert e.value.code != -3
        with pytest.raises(SourceDecodeError):
            jpeg.decode_to_coefficients(data)
        return
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


_SANITIZED = textwrap.dedent("""
    import ctypes, json, sys
    lib = ctypes.CDLL(sys.argv[1])
    cases = json.loads(sys.stdin.read())

    class Info(ctypes.Structure):
        _fields_ = [(n, ctypes.c_int32) for n in ("w", "h", "c", "layout",
                                                  "unread")]

    rcs = {}
    for name, hexdata in cases.items():
        data = bytes.fromhex(hexdata)
        if data[:2] == b"\\xff\\xd8":
            info = (ctypes.c_int32 * 64)()
            extra = (ctypes.c_int32 * 2)()  # the Adobe flag, the coding
            rc = lib.ik_jpeg4_parse(data, len(data), info, extra)
            if rc == 0:
                nb = [info[21 + c] * info[25 + c] for c in range(4)]
                planes = [(ctypes.c_int16 * (64 * n))() for n in nb]
                ptrs = (ctypes.c_void_p * 4)(*[ctypes.addressof(p)
                                               for p in planes])
                q = (ctypes.c_uint16 * 256)()
                rc = lib.ik_jpeg4_decode_coeffs(data, len(data), ptrs, q)
                unread = ctypes.c_int64()
                for part in (data, data[:len(data) // 2]):
                    for block in (65536, 0):
                        lib.ik_jpeg4_decode_libjpeg(
                            part, len(part), ctypes.c_size_t(block), ptrs,
                            q, ctypes.byref(unread))
                    lib.ik_jpeg4_decode_fed(part, len(part),
                                            ctypes.c_size_t(65536), ptrs, q)
        else:
            stem = "bmpx" if data[:2] == b"BM" else "tiffx"
            info = Info()
            rc = getattr(lib, f"ik_{stem}_parse")(data, len(data),
                                                  ctypes.byref(info))
            if rc == 0:
                out = ctypes.create_string_buffer(info.w * info.h * info.c)
                rc = getattr(lib, f"ik_{stem}_decode")(data, len(data), out,
                                                       len(out))
        rcs[name] = rc
    print(json.dumps(rcs))
""")


def test_port_only_decoders_under_address_sanitizer(tmp_path):
    """``bmp_ext_decode.cpp``, ``tiff_ext_decode.cpp`` and
    ``jpeg4_decode.cpp`` built with ``-fsanitize=address,undefined`` decode
    every fixture and every hostile input in a subprocess with the ASan
    runtime preloaded: the fixtures decode (rc 0), the hostile inputs are
    refused (rc < 0) but those libtiff and libjpeg decode (:data:`SERVED`,
    rc 0), and the sanitizers report nothing. Each JPEG also goes, whole
    and cut in half, through libjpeg's reader (``ik_jpeg4_decode_libjpeg``,
    fed as Pillow and as libtiff feed it) and the Pillow-fed arithmetic
    decode (``ik_jpeg4_decode_fed``)."""
    native = ROOT / "imagekit_tpu_torch" / "codecs" / "native"
    lib = tmp_path / "sanitized.so"
    subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fPIC", "-shared",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer",
         *(str(native / s) for s in ("bmp_ext_decode.cpp",
                                     "tiff_ext_decode.cpp",
                                     "jpeg4_decode.cpp",
                                     # the JPEG TIFF entries call it
                                     "jpeg_entropy.cpp")),
         "-o", str(lib), "-lz"], check=True, capture_output=True, timeout=300)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    good = {name: SOURCES[name]() for name in SOURCES
            if "bilevel_packbits" in name or "ccitt" in name
            or not name.startswith("tiff_bilevel")}
    good.update({f"tiff_bilevel_{k}": TIFFS[f"bilevel_{k}"]() for k in (
        "mh", "g3", "g3_2d", "g4", "g4_strips", "g3_2d_strips")})
    good["progressive_cmyk"] = _cmyk_jpeg((64, 48), 2, 0)
    good["progressive_restarts"] = _cmyk_jpeg(
        (64, 48), -1, 0, restart_marker_blocks=3)
    cases = {**{f"good/{k}": v.hex() for k, v in good.items()},
             **{f"hostile/{k}": v().hex() for k, v in HOSTILE.items()}}
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
    assert {k: v for k, v in rcs.items() if k.startswith("good/") and v} == {}
    assert sorted(k for k, v in rcs.items()
                  if k.startswith("hostile/") and v >= 0) == sorted(
        f"hostile/{k}" for k in SERVED)


# -- progressive CMYK and YCCK ---------------------------------------------------------


def _cmyk_jpeg(size, subsampling, ycck, progressive=True, **kw) -> bytes:
    """Pillow's CMYK JPEG of a test image at q85, progressive unless asked
    otherwise; read as YCCK by its APP14 flag where ``ycck``."""
    data = _save(Image.fromarray(make_test_image(*size)).convert("CMYK"),
                 "JPEG", quality=85, subsampling=subsampling,
                 progressive=progressive, **kw)
    if ycck:
        data = _patch(data, data.index(b"Adobe") + 11, b"\x02")
    return data


PROGRESSIVE = [(layout, kind, size) for layout in LAYOUTS
               for kind in ("cmyk", "ycck") for size in ((203, 151), (64, 48))]


def _case(case, **kw) -> bytes:
    layout, kind, size = case
    return _cmyk_jpeg(size, LAYOUTS[layout][1], kind == "ycck", **kw)


def _case_id(case):
    layout, kind, (w, h) = case
    return f"{kind}-{layout}-{w}x{h}"


@pytest.mark.parametrize("restarts", [{}, {"restart_marker_blocks": 3},
                                      {"restart_marker_rows": 1}],
                         ids=["no_restarts", "every_3_blocks", "every_row"])
@pytest.mark.parametrize("case", PROGRESSIVE, ids=_case_id)
def test_progressive_coefficients_equal_the_baseline_save(case, restarts):
    """Pillow's progressive and baseline saves of one picture at one
    quality hold the same quantised coefficients: ``decode4`` gives the
    same planes and quant tables from both (the pinned parser refuses both
    with -3)."""
    lib = loader.load()
    prog = _case(case, **restarts)
    base = _case(case, progressive=False, **restarts)
    assert b"\xff\xc2" in prog and (b"\xff\xdd" in prog) == bool(restarts)
    with pytest.raises(jpeg_abi.NativeJpegError) as e:
        jpeg_abi.parse(lib, prog)
    assert e.value.code == -3
    hp, cp, qp = jpeg_abi.decode_any(lib, prog)
    hb, cb, qb = jpeg_abi.decode_any(lib, base)
    assert hp.progressive and not hb.progressive
    assert hp.adobe_transform == hb.adobe_transform
    assert np.array_equal(qp, qb)
    for a, b in zip(cp, cb):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("case", PROGRESSIVE, ids=_case_id)
def test_progressive_planes_match_jax_under_k3(case):
    decoded = jpeg_abi.decode4(loader.load(), _case(case))
    want = _jax_planes(decoded)
    got = dct.four_component_planes(decoded, torch.device("cpu"))
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.uint8 and g.shape == w.shape
        d = np.abs(g.astype(int) - w.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE


@pytest.mark.parametrize("case", PROGRESSIVE, ids=_case_id)
def test_progressive_decode_matches_pillow(case):
    data = _case(case)
    got = jpeg.decode_rgb(data, device="cpu")
    pil = _pil_rgb(data)
    d = np.abs(got.astype(int) - pil.astype(int))
    print(f"{_case_id(case)}: PSNR {psnr(got, pil):.2f} dB, max |d| {d.max()}")
    assert got.shape == pil.shape and psnr(got, pil) >= 40.0 and d.max() <= 12
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], got)
    assert np.array_equal(transform.decode_image(data, device="cpu")[0], got)


def test_committed_fixtures_are_their_recipes():
    """``tests/fixtures/g4_a4_300dpi.tif`` and
    ``cmyk_1080p_q80_progressive.jpg``, which the card run reads, are what
    ``tests/fixtures/make_pillow_fallbacks.py`` writes; the page decodes to
    ``chip_smoke.text_page`` exactly, the progressive JPEG holds the
    coefficients of ``cmyk_1080p_q80.jpg``."""
    sys.path.insert(0, str(FIXTURES))
    try:
        import make_pillow_fallbacks as recipe
    finally:
        sys.path.remove(str(FIXTURES))
    import chip_smoke

    for name, make in recipe.FIXTURES.items():
        data = (FIXTURES / name).read_bytes()
        # the 1080p JPEG TIFFs of phase 21 are checked in
        # tests/test_torch_tiff_jpeg.py, under 400 kB each
        assert make() == data and len(data) < (
            400_000 if name.startswith("tiff_jpeg") else 200_000)
    page = chip_smoke.text_page(chip_smoke.G4_SEED)
    got = codecs.decode_bytes((FIXTURES / "g4_a4_300dpi.tif").read_bytes(),
                              device="cpu")[0]
    assert got.shape == (3508, 2480, 3)
    assert np.array_equal(got[..., 0], np.where(page, 255, 0))
    lib = loader.load()
    prog = jpeg_abi.decode_any(
        lib, (FIXTURES / "cmyk_1080p_q80_progressive.jpg").read_bytes())
    base = jpeg_abi.decode_any(lib, (FIXTURES / "cmyk_1080p_q80.jpg")
                               .read_bytes())
    assert prog[0].progressive and np.array_equal(prog[2], base[2])
    assert all(np.array_equal(a, b) for a, b in zip(prog[1], base[1]))


# -- chip_smoke's writers ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bilevel", "cmyk", "v5_bgra", "565",
                                  "core24"])
def test_chip_smoke_writers_decode_as_pillow(kind):
    """Phase 20's sources, written without Pillow, decode in the port to
    what Pillow reads from them and to what the phase checks them
    against."""
    import chip_smoke

    img = chip_smoke.synth_image(3, 160, 96, noise=False)
    if kind == "bilevel":
        page = chip_smoke.text_page(5, 640, 560)
        data = chip_smoke.make_bilevel_tiff(page)
        want = np.repeat(np.where(page, 255, 0).astype(np.uint8)[..., None],
                         3, 2)
    elif kind == "cmyk":
        data, want = chip_smoke.make_cmyk_tiff(img), img
    elif kind == "v5_bgra":
        rgba = chip_smoke.ramp_alpha(img)
        data, want = chip_smoke.make_bmp_fields(rgba, kind), rgba
    elif kind == "565":
        data = chip_smoke.make_bmp_fields(img, kind)
        want = chip_smoke.widened_565(img)
    else:
        data, want = chip_smoke.make_bmp_fields(img, kind), img
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert np.array_equal(got, want)
    assert np.array_equal(ref_codecs.decode_bytes(data)[0], want)


# -- the engines and the apps ----------------------------------------------------------


ENGINE_SOURCES = {
    "tiff_g4": lambda: _pil_tiff(_bilevel(512, 384, 3), "group4"),
    "tiff_g3_2d": lambda: _pil_tiff(_bilevel(512, 384, 3), "group3",
                                    tiffinfo={292: 1}),
    "tiff_cmyk_lzw": lambda: _save(_cmyk_img(96, 72), "TIFF",
                                   compression="tiff_lzw"),
    "tiff_gray4": lambda: _tiff(96, 72, {258: (3, [4]), 259: (3, [1]),
                                         262: (3, [1])},
                                [_pack((make_test_image(96, 72)[..., 1] >> 4),
                                       4)]),
    "bmp_565": lambda: _bmp(96, 72, 16, 3, _bmp_rows(
        (make_test_image(96, 72)[..., 0].astype(np.uint64) << 8), 16),
        masks=(0xF800, 0x7E0, 0x1F)),
    "bmp_core24": lambda: _bmp(96, 72, 24, 0, _bmp_rows(
        make_test_image(96, 72).astype(np.uint64) @ np.array(
            [1, 256, 65536], np.uint64), 24), hsz=12),
    "bmp_bgra_v5": lambda: _bmp(96, 72, 32, 3, _bmp_rows(
        np.dstack([make_test_image(96, 72), np.full((72, 96), 200)])
        .astype(np.uint64) @ np.array([1 << 16, 1 << 8, 1, 1 << 24],
                                      np.uint64), 32),
        hsz=124, masks=MASKS32["bgra"]),
    "progressive_cmyk": lambda: _cmyk_jpeg((96, 72), 2, 0),
    "progressive_ycck": lambda: _cmyk_jpeg((96, 72), 2, 1),
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
    assert ("device_resize" in stages) == (width is not None)
    if name.startswith("progressive"):
        assert stages["entropy_decode"] > 0 and stages["device_decode"] > 0
        assert "device_decode_resize" not in stages  # no JPEG head
    else:
        assert stages["decode"] > 0


def test_progressive_request_launches_the_pixel_decode(monkeypatch):
    """The engine on the CPU calls K3's wrapper twice a progressive CMYK
    request (C, M and Y, then K), as for a baseline one."""
    calls = []
    real = dct.resize_planes_u8

    def count(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(dct, "resize_planes_u8", count)
    engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                        device="cpu")
    _drive(engine, [ENGINE_SOURCES["progressive_cmyk"]()], [64],
           ImageFormat.webp)
    assert calls == [3, 1]


HTTP_SOURCES = ("tiff_g4", "tiff_cmyk_lzw", "bmp_565", "bmp_bgra_v5",
                "bmp_core24", "progressive_cmyk")


@pytest.mark.parametrize("name", HTTP_SOURCES)
def test_http_serves_as_the_reference(tmp_path, name):
    """``/img`` at w=64 WebP and JPEG and unresized, then the source cut at
    a third (a corrupt source of each new decoder), through both apps."""
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
    assert port[3] == ref[3]
    assert port[3][0] == 400 and port[3][2] == VALIDATION


HTTP_REFUSED = {**{k: REFUSED[k] for k in ("bmp_alphabitfields",
                                           "bmp_unknown_masks", "bmp_2bit")},
                "tiff_bilevel_without_bits_per_sample": lambda: _pil_tiff(
                    _bilevel(512, 384, 3), "raw"),
                "tiff_g4_garbage_after_the_header": lambda: _patch(
                    ENGINE_SOURCES["tiff_g4"](), 8, bytes(64)),
                "bmp_core24_pixels_cut": lambda: ENGINE_SOURCES[
                    "bmp_core24"]()[:-100]}


def test_http_refusals_answer_as_the_reference(tmp_path):
    """What Pillow refuses, the parity trap and corrupt data past a valid
    header: ``/img`` gives the reference's status and body (the fetch
    stage's, which the port gives from its engine where the header
    parses)."""
    async def fn(client):
        return [await _img(client, url=_url(name), w=64)
                for name in HTTP_REFUSED]

    sources = {name: make() for name, make in HTTP_REFUSED.items()}
    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for name, r, p in zip(HTTP_REFUSED, ref, port):
        assert p == r, name
        assert p[0] == 400 and p[2] == VALIDATION, name


def test_http_upload_of_the_new_sources(tmp_path):
    names = ("tiff_g4", "bmp_bgra_v5", "progressive_cmyk")

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
        assert psnr(_pil_rgb(pbody), _pil_rgb(rbody)) >= 38.0


def test_fetch_validates_the_new_layouts_by_header():
    async def run(data):
        return await fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/x", data)}))

    for name in ("tiff_g4", "tiff_cmyk_lzw", "bmp_565", "bmp_core24",
                 "progressive_ycck"):
        data = ENGINE_SOURCES[name]()
        assert asyncio.run(run(data))[0] == data
    for name in ("bmp_alphabitfields", "bmp_2bit", "bmp_unknown_masks"):
        with pytest.raises(InvalidArgumentError, match="validation"):
            asyncio.run(run(REFUSED[name]()))
    # FillOrder 2, once a 501, is validated by its header as the others
    data = _fill_order_2()
    assert asyncio.run(run(data))[0] == data
    # CIELab, once the engine's 501, is validated by its header too
    data = STILL_501["tiff_cielab"]()
    assert asyncio.run(run(data))[0] == data


# -- standing alone --------------------------------------------------------------------


def test_port_serves_the_new_sources_without_pillow(tmp_path):
    """G4 and CMYK TIFFs, bit-field and core-header BMPs and a progressive
    CMYK JPEG, written here, through ``BatchedEngine(device="cpu")`` in a
    subprocess that then holds no Pillow, no ``jax`` and no
    ``imagekit_tpu`` module."""
    names = ("tiff_g4", "tiff_cmyk_lzw", "bmp_565", "bmp_bgra_v5",
             "bmp_core24", "progressive_cmyk")
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
    assert res["sizes"] == [[32, 24]] * len(names)
    assert res["mods"] == []
