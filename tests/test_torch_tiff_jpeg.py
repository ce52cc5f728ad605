"""JPEG-compressed TIFFs in the port, on the CPU.

The reference decodes them with Pillow (its pinned ``tiff_decode.cpp``
refuses compression 7 with -3), whose libtiff decodes each strip or tile as
an independent JPEG: the segment spliced onto ``JPEGTables``, libjpeg's
colour step only for photometric 6 (YCbCr), the components as they are for
RGB, RGB with alpha, gray and CMYK. The port reads the segment grid with
``native/tiff_ext_decode.cpp::ik_tiffx_jpeg_segments``, entropy-decodes the
segments on the host (``codecs/tiff.py::entropy_decode``), assembles one
coefficient plane a component and decodes the page on the device
(``ops/dct.py::decode_tiff_page``: one K3 launch, two for four components,
with block-diagonal chroma stacks, ``weights.segment_axis_weights``).

Fixtures: the five layouts Pillow writes (``compression="jpeg"``), and
YCbCr files made by hand (``chip_smoke.make_jpeg_tiff``: the port's encoder
a segment, YCbCrSubSampling (2, 2), (2, 1), (1, 2) and (1, 1), in strips
and in tiles, at sizes whose last strip and right tiles are partial, one
with no ``JPEGTables``), and irregular pages (a strip height that is not a
whole number of MCUs, segments with their own tables of two qualities).

- Coefficients: the page's planes are the segments' ``decode_any`` planes
  placed at their grid positions, exactly.
- Planes: photometric 6 against the JAX package's ``decode_resize_rgb_batch``
  under K3's semantics a segment, stitched (+-2 on at most 0.1%);
  photometric 1, 2 and 5 against its ``_blocks_to_plane`` a segment (+-1 on
  at most 0.1%).
- Against Pillow (the JAX package's ``decode_bytes``): the same shape and
  channels, PSNR >= 40 dB and |d| <= 12.
- Both engines and both apps: outputs within 38 dB; ``/img`` statuses and
  bodies equal for the corrupt files the reference refuses; what stays 501.
"""

import asyncio
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import FormData
from PIL import Image

import chip_smoke
from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import tiff as ref_tiff
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu_torch import codecs, fetch, transform
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import tiff
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import (
    InvalidArgumentError,
    NotPortedError,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.ops import dct, resize_planes, weights
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from tests.conftest import make_test_image
from tests.test_torch_jpeg_layouts import _jax_pixel_decode
from tests.test_torch_jxc_slice import _ref_native_lib, k3_semantics  # noqa: F401
from tests.test_torch_pillow_sources import (
    MODES,
    _decoded,
    _img,
    _jax_planes,
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
SIZE = (203, 141)  # the last 16-row strip is 13 rows, the right tiles partial


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)



def _img_rgb(size=SIZE, seed=0):
    return make_test_image(*size) if seed == 0 else np.roll(
        make_test_image(*size), seed * 7, axis=1)


def _pil(mode: str, size=SIZE, **kw) -> bytes:
    """Pillow's JPEG TIFF of a test image in ``mode`` (RGBA: its green as
    alpha)."""
    img = _img_rgb(size)
    if mode == "RGBA":
        pic = Image.fromarray(np.dstack([img, img[..., 1]]))
    else:
        pic = Image.fromarray(img).convert(mode)
    return _save(pic, "TIFF", compression="jpeg", quality=85, **kw)


def _hand(samp=(2, 2), size=SIZE, **kw) -> bytes:
    return chip_smoke.make_jpeg_tiff(_img_rgb(size), 85, samp=samp, **kw)


def _pil_strips(rows: int, qualities=(85,), size=SIZE,
                huffman: bool = True) -> bytes:
    """A YCbCr (2, 2) file in strips of ``rows`` rows, each Pillow's JPEG
    of its rows, strip i at ``qualities[i % len]``: with one quality the
    tables (Pillow's, the same for every strip) go into ``JPEGTables``;
    with more, each strip keeps its own. Without ``huffman`` no DHT is
    kept anywhere (a decoder takes T.81's Annex K tables, which Pillow's
    are)."""
    img = _img_rgb(size)
    shared = len(qualities) == 1
    segs, tables = [], b""
    for i, y in enumerate(range(0, size[1], rows)):
        data = _save(Image.fromarray(img[y:y + rows]), "JPEG",
                     quality=qualities[i % len(qualities)], subsampling=2)
        tables, seg = chip_smoke.split_jpeg(data, (0xDB, 0xC4) if shared
                                            else ())
        if not huffman:
            tables = chip_smoke.split_jpeg(data, (0xDB,))[0]
        segs.append(seg)
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [rows]), 284: (3, [1]), 530: (3, [2, 2])}
    if shared:
        tags[347] = (7, tables)
    return chip_smoke.tiff_file(size[0], size[1], tags, segs)


def _without_subsampling_tag(data: bytes) -> bytes:
    """The file with its YCbCrSubSampling entry's tag renumbered to a tag
    no reader knows (65000): libtiff then takes the first segment's
    sampling."""
    at = data.index(b"\x12\x02\x03\x00\x02\x00\x00\x00")  # 530 SHORT x2
    return data[:at] + b"\xe8\xfd" + data[at + 2:]


CASES = {
    # the five layouts Pillow writes, in strips of 16 rows
    "pil_rgb": lambda: _pil("RGB", tiffinfo={278: 16}),
    "pil_ycbcr": lambda: _pil("YCbCr", tiffinfo={278: 16}),
    "pil_gray": lambda: _pil("L", tiffinfo={278: 16}),
    "pil_cmyk": lambda: _pil("CMYK", tiffinfo={278: 16}),
    "pil_rgba": lambda: _pil("RGBA", tiffinfo={278: 16}),
    "pil_rgb_one_strip": lambda: _pil("RGB", size=(64, 72)),
    # hand-made YCbCr: every subsampling, strips and tiles
    **{f"ycbcr_{h}{v}_strips": (lambda s=(h, v): _hand(s))
       for h, v in ((2, 2), (2, 1), (1, 2), (1, 1))},
    **{f"ycbcr_{h}{v}_tiles": (lambda s=(h, v): _hand(s, tile=32))
       for h, v in ((2, 2), (2, 1), (1, 2))},
    "ycbcr_22_tiles_16": lambda: _hand((2, 2), tile=16, size=(64, 72)),
    "ycbcr_11_strips_8_rows": lambda: _hand((1, 1), rows=8, size=(64, 72)),
    "ycbcr_22_no_tables": lambda: _hand((2, 2), tables=False),
    "ycbcr_22_no_subsampling_tag": lambda: _without_subsampling_tag(
        _hand((2, 2))),
    "gray_tiles": lambda: _hand(gray=True, tile=32),
    "ycbcr_22_no_huffman_tables": lambda: _pil_strips(16, huffman=False),
    # irregular pages, decoded segment by segment
    "irregular_strip_of_24_rows": lambda: _pil_strips(24),
    "irregular_tables": lambda: _pil_strips(16, (50, 90)),
}
IRREGULAR = ("irregular_strip_of_24_rows", "irregular_tables")
REGULAR = [n for n in CASES if n not in IRREGULAR]
PHOTOMETRIC = {"pil_rgb": 2, "pil_ycbcr": 6, "pil_gray": 1, "pil_cmyk": 5,
               "pil_rgba": 2, "pil_rgb_one_strip": 2, "gray_tiles": 1}


def _photometric(name):
    return PHOTOMETRIC.get(name, 6)


def _segments(data):
    """Each segment's ``decode_any`` output and its top-left corner."""
    info, offs, cnts = tiff.segments(data)
    tables = data[info.tables_off:info.tables_off + info.tables_len]
    out = []
    for i, (off, n) in enumerate(zip(offs.tolist(), cnts.tolist())):
        dec = jpeg_abi.decode_any(loader.load(), tiff.segment_stream(
            tables, data[off:off + n]))
        out.append((dec, (i // info.cols) * info.seg_h,
                    (i % info.cols) * info.seg_w))
    return info, out


# -- the fixtures ------------------------------------------------------------------


def test_fixtures_hold_their_layouts():
    """Compression 7; the photometric each name says; several segments,
    tiles where named; YCbCrSubSampling as written; the pinned decoder of
    both packages refuses them."""
    for name, make in CASES.items():
        data = make()
        assert ref_tiff.decode(data) is None, name  # Pillow decodes it
        with Image.open(io.BytesIO(data)) as im:
            tags = im.tag_v2
            assert tags[259] == 7 and tags[262] == _photometric(name), name
            assert (322 in tags) == ("tiles" in name), name
            chunks = len(tags[324 if 322 in tags else 273])
            assert chunks > 1 or name == "pil_rgb_one_strip", name
            if name.startswith("pil") or "no_tables" in name or (
                    name == "irregular_tables"):
                continue
            assert 347 in tags, name
        info = tiff.segments(data)[0]
        if name.startswith("ycbcr") and "no_subsampling" not in name:
            assert (info.sub_h, info.sub_v) == (int(name[6]), int(name[7]))
    assert tiff.segments(CASES["ycbcr_22_no_subsampling_tag"]())[0].sub_h == 0
    assert tiff.segments(CASES["pil_rgba"]())[0].alpha == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_header_parse_gives_the_decoded_geometry(name):
    data = CASES[name]()
    want = ref_codecs.decode_bytes(data)[0]
    assert tiff.parse(data) == (want.shape[1], want.shape[0], want.shape[2])
    assert tiff.layout(data) == tiff.JPEG


# -- the coefficients ----------------------------------------------------------------


@pytest.mark.parametrize("name", REGULAR)
def test_coefficients_are_the_segments_at_their_places(name):
    data = CASES[name]()
    page = tiff.entropy_decode(data)
    info, segs = _segments(data)
    assert page.segments is None and len(segs) == info.rows * info.cols
    for (hdr, coeffs, qtabs), y0, x0 in segs:
        for c, plane in enumerate(coeffs):
            # the segment's block offset in component c's page plane
            r, k = y0 // info.seg_h, x0 // info.seg_w
            by = sum(page.rows[c][:r])
            bx = sum(page.cols[c][:k])
            got = page.coeffs[c][by:by + plane.shape[0],
                                 bx:bx + plane.shape[1]]
            assert np.array_equal(got, plane), (name, c, y0, x0)
            assert np.array_equal(page.qtabs[c], qtabs[hdr.comp_tq[c]])
    assert [c.shape[0] for c in page.coeffs] == [sum(r) for r in page.rows]
    assert [c.shape[1] for c in page.coeffs] == [sum(k) for k in page.cols]


@pytest.mark.parametrize("name", IRREGULAR)
def test_irregular_pages_keep_their_segments(name):
    data = CASES[name]()
    page = tiff.entropy_decode(data)
    info, segs = _segments(data)
    assert page.segments is not None and len(page.segments) == len(segs)
    for (seg, y0, x0), ((_, coeffs, _), y1, x1) in zip(page.segments, segs):
        assert (y0, x0) == (y1, x1)
        assert all(np.array_equal(a, b) for a, b in zip(seg.coeffs, coeffs))
        assert seg.height == min(info.seg_h, info.height - y0)


def _huffman_tables(stream: bytes) -> dict:
    """Each table of a stream's DHT segments: {Tc/Th byte: its bytes}."""
    out, at = {}, 2
    while stream[at + 1] != 0xDA and stream[at + 1] != 0xD9:
        end = at + 2 + int.from_bytes(stream[at + 2:at + 4], "big")
        p = at + 4
        while stream[at + 1] == 0xC4 and p < end:
            n = 17 + sum(stream[p + 1:p + 17])
            out[stream[p]] = stream[p:p + n]
            p += n
        at = end
    return out


def test_default_huffman_tables_are_annex_k():
    """The tables the port puts ahead of a segment that defines none are
    the Annex K ones that Pillow writes (and libjpeg decodes with)."""
    data = _save(Image.fromarray(_img_rgb((16, 16))), "JPEG", quality=85)
    std = b"\xff\xd8" + tiff._STD_DHT + b"\xff\xd9"
    assert _huffman_tables(std) == _huffman_tables(data)
    assert sorted(_huffman_tables(std)) == [0x00, 0x01, 0x10, 0x11]
    assert tiff.tables_defined(std) == (set(), {(0, 0), (0, 1), (1, 0),
                                                (1, 1)})
    assert tiff.tables_defined(data)[0] == {0, 1}


# -- ops/weights.py -----------------------------------------------------------------


@pytest.mark.parametrize("luma,chroma", [((2, 2, 1), (1, 1, 1)),
                                         ((4, 4), (4, 4)),
                                         ((2, 2, 2), (1, 1, 1)),
                                         ((4, 3), (2, 2))])
def test_segment_axis_weights_are_block_diagonal(luma, chroma):
    got = weights.segment_axis_weights(luma, chroma).copy()  # cached
    assert got.shape == (sum(luma) * 8, sum(chroma) * 8)
    o = i = 0
    for lb, cb in zip(luma, chroma):
        block = ref_dct.upsample_weights(cb * 8, lb * 8)
        assert np.array_equal(got[o:o + lb * 8, i:i + cb * 8], block)
        got[o:o + lb * 8, i:i + cb * 8] = 0
        o, i = o + lb * 8, i + cb * 8
    assert not got.any()  # nothing off the blocks
    with pytest.raises(ValueError):
        weights.segment_axis_weights((2, 2), (1,))


# -- the planes against the JAX package ---------------------------------------------


def _stitched(segs, page_shape, channels, decode):
    out = np.zeros((*page_shape, channels), np.uint8)
    for dec, y0, x0 in segs:
        px = decode(dec)
        h = min(px.shape[0], page_shape[0] - y0)
        w = min(px.shape[1], page_shape[1] - x0)
        out[y0:y0 + h, x0:x0 + w] = px[:h, :w]
    return out


@pytest.mark.parametrize("name", [n for n in CASES if _photometric(n) == 6])
def test_ycbcr_page_matches_jax_under_k3(k3_semantics, name):
    """One K3 (plain, here) over the page's block-diagonal stacks against
    the JAX RGB-output head a segment, with its own identity and upsample
    stacks, stitched: the upsample stops at every segment edge."""
    data = CASES[name]()
    info, segs = _segments(data)
    want = _stitched(segs, (info.height, info.width), 3, _jax_pixel_decode)
    before = resize_planes.LAUNCHES
    got = dct.decode_tiff_page(tiff.entropy_decode(data), device="cpu")
    assert resize_planes.LAUNCHES == before  # the plain version on the CPU
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"{name}: max |d| {d.max()}, {(d > 0).sum()} of {d.size} differ")
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@pytest.mark.parametrize("name", [n for n in REGULAR if _photometric(n) != 6])
def test_planes_match_jax_blocks_to_plane(name):
    """Photometric 1, 2 and 5 have no colour step before the planes: K3's
    identity stacks (plain, here) against the JAX package's 8x8 IDCT a
    segment, placed at the segment's block offset."""
    data = CASES[name]()
    page = tiff.entropy_decode(data)
    got = dct.resize_components(*dct.tiff_page_inputs(page, torch.device(
        "cpu")))
    info, segs = _segments(data)
    for c, plane in enumerate(got):
        plane = plane[0].numpy()
        assert plane.shape == (sum(page.rows[c]) * 8, sum(page.cols[c]) * 8)
        want = np.zeros_like(plane)
        for dec, y0, x0 in segs:
            p = _jax_planes(dec, libjpeg=False)[c]
            by = sum(page.rows[c][:y0 // info.seg_h]) * 8
            bx = sum(page.cols[c][:x0 // info.seg_w]) * 8
            want[by:by + p.shape[1], bx:bx + p.shape[2]] = p[0]
        d = np.abs(plane.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE, (name, c)


# -- against Pillow ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_pillow(name):
    data = CASES[name]()
    want, ref_fmt = ref_codecs.decode_bytes(data)
    got, fmt = codecs.decode_bytes(data, device="cpu")
    assert fmt.value == ref_fmt.value == "tiff"
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"{name}: PSNR {psnr(got, want):.2f} dB, max |d| {d.max()}")
    assert psnr(got, want) >= 40.0 and d.max() <= 12
    assert np.array_equal(transform.decode_image(data, device="cpu")[0], got)
    if name == "pil_rgba":  # the alpha is the stored fourth component
        assert psnr(got[..., 3], want[..., 3]) >= 40.0


def test_gray_is_r_equals_g_equals_b():
    got = codecs.decode_bytes(CASES["pil_gray"](), device="cpu")[0]
    assert (got == got[..., :1]).all()


def _count_k3(monkeypatch):
    calls = []
    real = dct.resize_planes_u8

    def count(planes, *a, **k):
        calls.append(len(planes))
        return real(planes, *a, **k)

    monkeypatch.setattr(dct, "resize_planes_u8", count)
    return calls


@pytest.mark.parametrize("name,want", [
    ("pil_ycbcr", [3]), ("pil_rgb", [3]), ("pil_gray", [1]),
    ("pil_cmyk", [3, 1]), ("pil_rgba", [3, 1]), ("ycbcr_22_tiles", [3]),
    ("irregular_strip_of_24_rows", [3] * 6), ("irregular_tables", [3] * 9)])
def test_one_k3_launch_a_page(monkeypatch, name, want):
    """K3's wrapper once a page for one or three components, twice for four,
    whatever the number of segments; an irregular page once (or twice) a
    segment."""
    calls = _count_k3(monkeypatch)
    codecs.decode_bytes(CASES[name](), device="cpu")
    assert calls == want


def test_last_strip_coded_at_full_height_is_cropped():
    """libtiff takes a last strip whose JPEG holds a whole strip's rows (the
    rows past the image are dropped); so does the port."""
    img = _img_rgb((64, 40))
    full = np.concatenate([img, img[-8:]])  # 48 rows, 3 strips of 16
    tall = chip_smoke.make_jpeg_tiff(full, 85, samp=(2, 2))
    data = tall.replace(b"\x01\x01\x04\x00\x01\x00\x00\x00\x30\x00",
                        b"\x01\x01\x04\x00\x01\x00\x00\x00\x28\x00")  # H 40
    assert data != tall
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (40, 64, 3)
    assert psnr(got, want) >= 40.0


# -- what the reference refuses, and what stays 501 ---------------------------------


def _strips(samp=(2, 2)):
    """(tags, tables, segments) of a 64x72 YCbCr file in 16-row strips."""
    data = _hand(samp, size=(64, 72))
    info, offs, cnts = tiff.segments(data)
    tables = data[info.tables_off:info.tables_off + info.tables_len]
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [16]), 284: (3, [1]), 530: (3, list(samp)),
            347: (7, tables)}
    return tags, tables, [data[o:o + n]
                          for o, n in zip(offs.tolist(), cnts.tolist())]


def _padded(tables: bytes, size: int) -> bytes:
    """``tables`` grown to ``size`` bytes by COM segments after the SOI,
    which libjpeg skips."""
    out, left = tables[:2], size - len(tables)
    while left:
        n = min(left, 60_000)  # marker, length, then n - 4 bytes
        out += b"\xff\xfe" + (n - 2).to_bytes(2, "big") + bytes(n - 4)
        left -= n
    return out + tables[2:]


def _corrupt(kind: str) -> bytes:
    tags, tables, segs = _strips()
    if kind == "segment_cut_in_its_header":
        segs[1] = segs[1][:12]
    elif kind == "sof_disagrees_with_the_ifd":
        tags[530] = (3, [1, 1])
    elif kind == "segment_taller_than_its_strip":
        tags[278] = (4, [8])
        segs = [segs[0][:]] * 9
    elif kind == "missing_tables":
        del tags[347]
    elif kind == "component_count":  # gray in the IFD, three components
        tags.update({258: (3, [8]), 277: (3, [1]), 262: (3, [1])})
        del tags[530]
    elif kind == "tables_not_a_jpeg":
        tags[347] = (7, b"\xff")
    elif kind == "splices_amplified":
        # one-row strips of a bare SOI over 60 kB of tables: their splices
        # would copy 72 times the tables, past 64 times the file
        tags.update({278: (4, [1]), 347: (7, _padded(tables, 60_000))})
        segs = [b"\xff\xd8"] * 72
    data = chip_smoke.tiff_file(64, 72, tags, segs)
    if kind == "strip_byte_counts_past_the_end":
        at = data.index(b"\x17\x01\x04\x00")  # StripByteCounts, LONG
        off = int.from_bytes(data[at + 8:at + 12], "little")
        data = data[:off + 16] + (len(data)).to_bytes(4, "little") + data[
            off + 20:]
    return data


CORRUPT = ("segment_cut_in_its_header", "sof_disagrees_with_the_ifd",
           "segment_taller_than_its_strip", "missing_tables",
           "component_count", "tables_not_a_jpeg",
           "strip_byte_counts_past_the_end", "splices_amplified")


@pytest.mark.parametrize("kind", CORRUPT)
def test_what_libtiff_refuses_is_a_transform_error(kind):
    data = _corrupt(kind)
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


def test_splices_are_bounded_from_the_header():
    """Each segment is decoded from a copy spliced onto the tables: a page
    whose splices would copy more than 64 times the file is refused by its
    header parse, before any segment is read; a page of the same kind
    under the bound parses, and its bare segments are refused one by
    one."""
    data = _corrupt("splices_amplified")
    assert 72 * 60_000 > 64 * len(data)
    with pytest.raises(TransformError, match=r"corrupt TIFF \(-4\)"):
        tiff.parse(data)
    tags, tables, _ = _strips()
    tags.update({278: (4, [2]), 347: (7, _padded(tables, 60_000))})
    data = chip_smoke.tiff_file(64, 72, tags, [b"\xff\xd8"] * 36)
    assert 36 * 60_000 < 64 * len(data) and tiff.parse(data)
    with pytest.raises(TransformError, match="JPEG segment 0"):
        codecs.decode_bytes(data, device="cpu")


def test_tables_longer_than_64_kb_are_refused():
    """A known difference: real tables (four DQT and four DHT segments)
    stay under 2.5 kB, and the port refuses a ``JPEGTables`` longer than
    64 kB, which libtiff reads (here 70 kB of them COM segments); tables
    padded to 60 kB decode as the plain ones."""
    tags, tables, segs = _strips()
    plain = codecs.decode_bytes(chip_smoke.tiff_file(64, 72, tags, segs),
                                device="cpu")[0]
    tags[347] = (7, _padded(tables, 60_000))
    data = chip_smoke.tiff_file(64, 72, tags, segs)
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], plain)
    tags[347] = (7, _padded(tables, 70_000))
    data = chip_smoke.tiff_file(64, 72, tags, segs)
    assert ref_codecs.decode_bytes(data)[0].shape == plain.shape
    with pytest.raises(TransformError, match=r"corrupt TIFF \(-4\)"):
        codecs.decode_bytes(data, device="cpu")


def test_entropy_data_cut_short_is_refused_where_libjpeg_fills_gray():
    """A segment whose entropy-coded data ends early: libtiff hands libjpeg
    the segment and then a fake EOI, so its MCU in flight decodes from zero
    bits and the rest of the segment is zero (the name is kept from when
    the port refused it). The port decodes it so (``jpeg4_decode.cpp``'s
    libjpeg reader): within the JPEG TIFF band of Pillow's pixels, and the
    segment's coefficients past the cut zero."""
    tags, _, segs = _strips()
    whole = list(segs)
    segs[1] = segs[1][:len(segs[1]) // 2]
    data = chip_smoke.tiff_file(64, 72, tags, segs)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (72, 64, 3)
    assert psnr(got, want) >= 40.0
    assert np.abs(got.astype(int) - want).max() <= 12
    page = tiff.entropy_decode(data)
    full = tiff.entropy_decode(chip_smoke.tiff_file(64, 72, tags, whole))
    # the cut strip's luma: one row of four 2x2-block MCUs, the first
    # whole, the last zero
    cut, whole_y = page.coeffs[0][2:4], full.coeffs[0][2:4]
    assert np.array_equal(cut[:, :2], whole_y[:, :2])
    assert not cut[:, 6:].any() and whole_y[:, 6:].any()


def _old_style_gray() -> bytes:
    """Old-style JPEG (compression 6) of one sample: a gray JFIF stream
    behind JPEGInterchangeFormat (513, 514)."""
    whole = _save(Image.fromarray(_img_rgb((64, 48))[..., 0]), "JPEG",
                  quality=85)
    return chip_smoke.tiff_file(64, 48, {
        258: (3, [8]), 259: (3, [6]), 262: (3, [1]), 277: (3, [1]),
        278: (4, [48]), 513: (4, [8]), 514: (4, [len(whole)])}, [whole])


def _one_segment(photometric: int, sampling, sub) -> bytes:
    """A 64x48 page in one strip of Pillow's JPEG at ``sampling``, its
    tables in ``JPEGTables``, photometric ``photometric``."""
    tables, seg = chip_smoke.split_jpeg(_save(
        Image.fromarray(_img_rgb((64, 48))), "JPEG", quality=85,
        subsampling=sampling))
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [3]), 278: (4, [48]), 284: (3, [1]), 347: (7, tables)}
    if sub:
        tags[530] = (3, list(sub))
    return chip_smoke.tiff_file(64, 48, tags, [seg])


def _planar_gray_with_alpha() -> bytes:
    """Planar gray with alpha: two one-component JPEGs, the red and the
    green (Pillow reads its alpha as 0)."""
    img, segs, tables = _img_rgb((64, 48)), [], b""
    for c in range(2):
        tables, seg = chip_smoke.split_jpeg(_save(
            Image.fromarray(img[..., c]), "JPEG", quality=85))
        segs.append(seg)
    return chip_smoke.tiff_file(64, 48, {
        258: (3, [8] * 2), 259: (3, [7]), 262: (3, [1]), 277: (3, [2]),
        278: (4, [48]), 284: (3, [2]), 338: (3, [2]), 347: (7, tables)},
        segs)


#: no JPEG TIFF layout answers 501 now
STILL_501 = {}
#: layouts that answered 501 here and are decoded now
#: (``tests/test_torch_jpeg_cmyk_tiff_remainder.py`` and
#: ``tests/test_torch_tiff_lab_ycbcr.py`` hold them and their kin to
#: Pillow)
SERVED_NOW = {
    "old_style_gray": _old_style_gray,
    "planar_gray_with_alpha": _planar_gray_with_alpha,
    # CIELab (Pillow's JPEG TIFF of a LAB picture): its bands as libjpeg
    # decodes them, then littleCMS's LAB -> sRGB
    "cielab_jpeg": lambda: _save(Image.fromarray(_img_rgb((64, 48))).convert(
        "LAB"), "TIFF", compression="jpeg"),
}


def test_jpeg_subsampling_4_stays_not_ported():
    """YCbCrSubSampling 4 over a segment sampled otherwise (Pillow's
    "4:1:1", which is its 4:2:0): libtiff refuses it ("Improper JPEG
    sampling factors"), and so does the port now, a TransformError (400)
    from the decode on, where it answered 501 from the header (the name is
    kept). Segments sampled 4 are decoded
    (``tests/test_torch_jpeg_cmyk_tiff_remainder.py``)."""
    data = _one_segment(6, "4:1:1", (4, 1))
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    assert tiff.parse(data) == (64, 48, 3)
    with pytest.raises(TransformError, match="sampled") as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


@pytest.mark.parametrize("name", sorted({**STILL_501, **SERVED_NOW}))
def test_jpeg_layouts_no_decoder_takes_stay_not_ported(name):
    """Pillow reads them (the reference serves them). Old-style gray,
    planar gray with alpha and CIELab, 501 once (the name is kept), decode
    within the JPEG TIFF band of Pillow's pixels, the planar page's alpha
    0 as Pillow reads it."""
    data = {**STILL_501, **SERVED_NOW}[name]()
    want = ref_codecs.decode_bytes(data)[0]
    if name in SERVED_NOW:
        got = codecs.decode_bytes(data, device="cpu")[0]
        assert got.shape == want.shape and psnr(got, want) >= 40.0
        assert np.abs(got.astype(int) - want).max() <= 12
        return
    with pytest.raises(NotPortedError, match="queue 1 item 9"):
        codecs.decode_bytes(data, device="cpu")
    with pytest.raises(NotPortedError, match="queue 1 item 9"):
        tiff.parse(data)


def test_twelve_bit_jpeg_tiff_stays_not_ported():
    """BitsPerSample 12: Pillow cannot open it (the reference answers 400).
    The port, which once answered 501 here, refuses it as Pillow does: a
    TransformError (400), from the header on."""
    tags, _, segs = _strips()
    tags[258] = (3, [12] * 3)
    data = chip_smoke.tiff_file(64, 72, tags, segs)
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    for decode in (lambda d: codecs.decode_bytes(d, device="cpu"),
                   tiff.parse):
        with pytest.raises(TransformError) as e:
            decode(data)
        assert not isinstance(e.value, NotPortedError)


def test_segment_the_jpeg_decoders_refuse_stays_not_ported():
    """A segment marked arithmetic-coded (SOF9) over Huffman bits, 501 once
    (the name is kept): libjpeg's QM decoder reads the bits as its
    arithmetic data, and so does the port's (``jpeg4_decode.cpp``), to
    Pillow's pixels within the JPEG TIFF band."""
    tags, tables, segs = _strips((1, 1))
    segs = [s.replace(b"\xff\xc0", b"\xff\xc9", 1) for s in segs]
    data = chip_smoke.tiff_file(64, 72, tags, segs)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape and psnr(got, want) >= 40.0
    assert np.abs(got.astype(int) - want).max() <= 12


def test_tiles_far_larger_than_the_image_are_refused():
    """A 16x16 image in one 65520x65520 tile: its segment's planes would
    hold 4.3 G pixels; refused from the IFD, before any segment is read."""
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            284: (3, [1]), 530: (3, [2, 2])}
    data = chip_smoke.tiff_file(16, 16, tags, [b"\xff\xd8\xff\xd9"],
                                tile=65520)
    assert tiff.parse(data) == (16, 16, 3)
    with pytest.raises(TransformError, match="segments of 65520x65520"):
        codecs.decode_bytes(data, device="cpu")


def test_pixel_ceiling_is_the_constant(monkeypatch):
    from imagekit_tpu_torch.codecs import misc

    monkeypatch.setattr(misc, "MAX_PIXELS", 20)
    with pytest.raises(TransformError, match="too large"):
        codecs.decode_bytes(CASES["pil_ycbcr"](), device="cpu")


# -- the engines and the apps ------------------------------------------------------------


ENGINE_SOURCES = {
    "pil_rgb": lambda: _pil("RGB", size=(96, 72)),
    "pil_cmyk": lambda: _pil("CMYK", size=(96, 72)),
    "pil_rgba": lambda: _pil("RGBA", size=(96, 72)),
    "pil_gray": lambda: _pil("L", size=(96, 72)),
    "ycbcr_22_strips": lambda: _hand((2, 2), size=(96, 72)),
    "ycbcr_21_tiles": lambda: _hand((2, 1), size=(96, 72), tile=32),
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
    # the segments on the codec pool, the page on a dispatch thread
    assert stages["entropy_decode"] > 0 and stages["device_decode"] > 0
    assert "decode" not in stages and "device_decode_resize" not in stages


def test_engine_launches_k3_once_a_page(monkeypatch):
    """Two requests of a 4:2:0 page in strips and one CMYK page: K3's
    wrapper once a YCbCr page, twice a CMYK one; the RGB head one batch."""
    calls = _count_k3(monkeypatch)
    engine = PortEngine(_cfg(port_config, 3), metrics=Metrics(), device="cpu")
    datas = [ENGINE_SOURCES[n]() for n in ("ycbcr_22_strips",
                                           "ycbcr_22_strips", "pil_cmyk")]
    outs = _drive(engine, datas, [48] * 3, ImageFormat.webp)
    assert sorted(calls) == [1, 3, 3, 3]
    assert engine.metrics.batches == 1
    assert [_out_size(o) for o in outs] == [(48, 36)] * 3


HTTP_SOURCES = ("pil_rgb", "pil_cmyk", "ycbcr_22_strips", "ycbcr_21_tiles")


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


def test_http_corrupt_files_answer_as_the_reference(tmp_path):
    """Every corrupt file the reference's Pillow refuses: ``/img`` gives the
    reference's status and body, the fetch stage's 400 (the port's from
    its header parse, or from its engine where the header parses)."""
    sources = {kind: _corrupt(kind) for kind in CORRUPT}

    async def fn(client):
        return [await _img(client, url=_url(kind), w=64) for kind in CORRUPT]

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for kind, r, p in zip(CORRUPT, ref, port):
        assert p == r, kind
        assert p[0] == 400 and p[2] == VALIDATION, kind


def test_http_still_501(tmp_path):
    """The layouts that answered 501 here (the name is kept) are served as
    the reference serves them: 200, within 38 dB of its output."""
    sources = {name: make() for name, make in SERVED_NOW.items()}

    async def fn(client):
        return [await _img(client, url=_url(name), w=64)
                for name in SERVED_NOW]

    port = _serve(tmp_path, "port", sources, fn)
    ref = _serve(tmp_path, "ref", sources, fn)
    for name, (status, _, body), (rstatus, _, rbody) in zip(
            SERVED_NOW, port, ref):
        assert status == rstatus == 200, name
        assert psnr(_decoded(body), _decoded(rbody)) >= 38.0, name


def test_http_upload_of_jpeg_tiffs(tmp_path):
    names = ("pil_rgba", "ycbcr_22_strips")

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


def test_fetch_validates_jpeg_tiffs_by_header():
    async def run(data):
        return await fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/tiff", data)}))

    for name in ("pil_rgb", "ycbcr_21_tiles"):
        data = ENGINE_SOURCES[name]()
        assert asyncio.run(run(data))[0] == data
    with pytest.raises(InvalidArgumentError, match="validation"):
        asyncio.run(run(_corrupt("strip_byte_counts_past_the_end")))
    # a header that parses: the engine decodes it, and its segment fails
    data = _corrupt("missing_tables")
    assert asyncio.run(run(data))[0] == data
    with pytest.raises(SourceDecodeError):
        engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                            device="cpu")
        _drive(engine, [data], [32], ImageFormat.webp)


# -- the committed fixtures and chip_smoke's writer --------------------------------------


def test_committed_fixtures_are_their_recipes():
    """``tests/fixtures/tiff_jpeg_rgb_1080p_q80.tif`` and
    ``tiff_jpeg_cmyk_1080p_q80.tif``, which the card run reads (its machine
    has no Pillow), are what ``tests/fixtures/make_pillow_fallbacks.py``
    writes from ``chip_smoke.synth_image(800, noise=False)``; they hold the
    layouts Pillow writes at 1080p."""
    sys.path.insert(0, str(ROOT / "tests" / "fixtures"))
    try:
        import make_pillow_fallbacks as recipe
    finally:
        sys.path.remove(str(ROOT / "tests" / "fixtures"))
    for name, photo, rows in (("tiff_jpeg_rgb_1080p_q80.tif", 2, 16),
                              ("tiff_jpeg_cmyk_1080p_q80.tif", 5, 8)):
        data = (ROOT / "tests" / "fixtures" / name).read_bytes()
        assert recipe.FIXTURES[name]() == data and len(data) < 400_000
        info, offs, _ = tiff.segments(data)
        assert (info.width, info.height, info.photometric, info.seg_h) == (
            1920, 1080, photo, rows)
        assert len(offs) == -(-1080 // rows)


@pytest.mark.parametrize("kw", [{"samp": (2, 2)}, {"samp": (1, 2), "tile": 16},
                                {"gray": True}],
                         ids=["strips_22", "tiles_12", "gray"])
def test_chip_smoke_writer_decodes_as_pillow(kw):
    """Phase 21's writer, without Pillow: Pillow reads its files, and the
    port decodes them to within the pixel decode's bounds of that."""
    img = chip_smoke.synth_image(3, 160, 96, noise=False)
    data = chip_smoke.make_jpeg_tiff(img, 80, **kw)
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (96, 160, 3)
    assert psnr(got, want) >= 40.0
    assert psnr(got, img if not kw.get("gray") else got) >= 30.0
