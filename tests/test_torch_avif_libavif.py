"""The AVIFs the reference hands to Pillow, through the port on the CPU.

The reference's native path declines grids, files with no ``nclx`` box or
with a matrix other than BT.601 / BT.709, and premultiplied alpha; its
``decode_bytes`` then decodes them with Pillow 12.1 (libavif 1.3.0 with
libyuv inside). The port decodes them itself
(``codecs/avif_libavif.py``, ``codecs/native/avif_yuv_rgb.cpp``). Every
test holds ``decode_bytes(..., device="cpu")`` to the reference's
``decode_bytes`` (Pillow): the same array and mode, or the same words of
a refusal. The files are written with the system's libavif 0.11.1
(``tests/fixtures/make_avif_sources.py``), which is a writer here only.

- every matrix libavif converts, at limited and full range, in 4:0:0,
  4:2:0, 4:2:2 and 4:4:4, at 8, 10 and 12 bits, at odd sizes, with and
  without alpha; the matrices it refuses;
- grids (1 x 2, 3 x 2; 8 x 6 in the committed 12 MP file) with crops, an
  alpha grid and ``prem``, and hostile grids;
- no ``nclx``: ``prof``, ``rICC`` or no ``colr``, over sequence headers of
  BT.601, BT.709 and BT.2020; premultiplied, limited-range and doubled
  alpha items; monochrome files with no nclx or matrix 0, which the port
  refused before (a 400 where the reference serves);
- the committed fixtures of ``chip_smoke.py``'s phase 28 against the
  digests of Pillow's arrays; the 12 MP grid into the RGB head's bucket;
- ``/img`` and ``/upload`` through both apps; threads.
"""

import asyncio
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch.codecs import avif_libavif
from imagekit_tpu_torch.codecs.native import av1_dec_abi, avif_yuv_rgb
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError
from tests.conftest import psnr
from tests.fixtures import make_avif_sources as M
from tests.test_torch_avif_sources import _upload
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import _decoded, _img, _serve, _url
from tests.test_torch_rgba_slice import _out_size

pytest.importorskip("PIL.AvifImagePlugin")
needs_writer = pytest.mark.skipif(M._avif_lib() is None,
                                  reason="libavif.so.15 (the writer) absent")
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "avif"


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


def planes(w, h, depth, layout, seed=0):
    """Seeded Y, U, V samples of a layout: smooth waves and noise over
    the whole range of the depth."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16

    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        wave = np.sin(xx / 5.0 + rng.random() * 6) * np.cos(yy / 7.0)
        return np.clip((0.5 * rng.random((ph, pw)) + 0.25 * wave + 0.25)
                       * top, 0, top).astype(dt)

    y = plane(h, w)
    if layout == "400":
        return y, None, None
    cw = (w + 1) // 2 if layout in ("420", "422") else w
    ch = (h + 1) // 2 if layout == "420" else h
    return y, plane(ch, cw), plane(ch, cw)


def avif(w, h, depth=8, layout="420", matrix=6, full=False, alpha=False,
         prem=False, primaries=1, seed=0, quantizer=10):
    """A small AVIF of :func:`planes`; matrices libaom does not write on
    the layout (identity on subsampled chroma) or libavif refuses are
    re-tagged into the nclx box after the encode."""
    retag = matrix == 0 and layout not in ("444", "400") or matrix in (
        3, 10, 11, 13, 14, 15, 16, 17) or (matrix == 8 and not full)
    a = planes(w, h, depth, "400", seed + 50)[0] if alpha else None
    data = M.encode_avif_hbd(*planes(w, h, depth, layout, seed), depth,
                             layout, quantizer, alpha=a,
                             cicp=(primaries, 13, 6 if retag else matrix),
                             full_range=full, premultiplied=prem)
    return M.retag_matrix(data, matrix) if retag else data


def decode_both(data):
    """(reference's array or message, port's array or message)."""
    try:
        want = ref_codecs.decode_bytes(data)[0]
    except Exception as e:  # noqa: BLE001 (the reference's TransformError)
        want = str(e)
    try:
        got = port_codecs.decode_bytes(data, device="cpu")[0]
    except NotPortedError as e:
        got = f"501 {e}"
    except Exception as e:  # noqa: BLE001
        got = str(e)
    return want, got


def assert_same(data):
    want, got = decode_both(data)
    if isinstance(want, str):
        assert isinstance(got, str) and want.startswith(got), (want, got)
        return want
    assert isinstance(got, np.ndarray), (want.shape, got)
    assert got.shape == want.shape and np.array_equal(got, want), (
        got.shape, want.shape, int(np.abs(got.astype(int) - want).max())
        if got.shape == want.shape else None)
    return want


# -- the colour step ----------------------------------------------------------


ACCEPTED = (0, 1, 2, 4, 5, 6, 7, 8, 9, 12)


@needs_writer
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("matrix", ACCEPTED)
def test_every_matrix_layout_and_range(matrix, depth):
    """Each accepted matrix in every layout at both ranges, 23 x 17 (odd
    sides: the bilinear chroma's last column and row), with and without
    alpha: the array libavif gives, or its refusal (identity outside 4:4:4
    and 4:0:0, YCgCo at limited range)."""
    served = 0
    for layout in ("400", "420", "422", "444"):
        for full in (False, True):
            for alpha in (False, True):
                want = assert_same(avif(23, 17, depth, layout, matrix, full,
                                        alpha, seed=matrix + depth))
                served += not isinstance(want, str)
    assert served >= 8


@needs_writer
@pytest.mark.parametrize("primaries", [1, 2, 4, 6, 7, 9, 12, 22])
def test_chroma_derived_ncl_takes_its_primaries(primaries):
    """Matrix 12 goes to libyuv's tables for BT.709, BT.601 and BT.2020
    primaries, and to libavif's float path with kr, kb derived from the
    others."""
    for depth, layout in ((8, "420"), (10, "444")):
        assert not isinstance(assert_same(avif(
            33, 21, depth, layout, 12, primaries == 4, primaries=primaries,
            seed=primaries)), str)


@needs_writer
@pytest.mark.parametrize("matrix", [3, 10, 11, 13, 14, 17, 40])
def test_refused_matrices_answer_the_reference_words(matrix):
    for layout in ("420", "444"):
        want = assert_same(avif(24, 16, 8, layout, matrix, True))
        assert want.endswith("Conversion from YUV failed: Reformat failed")


@needs_writer
def test_matrices_15_and_16():
    """15 converts with libavif's default coefficients (BT.601's); 16,
    YCgCo-Re, at 10 bits and full range only."""
    assert not isinstance(assert_same(avif(24, 16, 8, "420", 15)), str)
    assert not isinstance(assert_same(avif(24, 16, 10, "444", 16, True)),
                          str)
    assert isinstance(assert_same(avif(24, 16, 8, "444", 16, True)), str)


@needs_writer
@pytest.mark.parametrize("size", [(1, 1), (2, 1), (1, 2), (3, 3), (65, 2)])
def test_the_smallest_pictures(size):
    for layout in ("420", "422", "444"):
        for depth in (8, 10):
            assert_same(avif(*size, depth, layout, seed=sum(size),
                             alpha=depth == 10))


@needs_writer
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_premultiplied_alpha(depth):
    """``prem``: libyuv's ARGBUnattenuate after its own rows and libavif's
    fast paths (alpha 1 included, where the x86 rows' saturation gives
    0), the float unmultiply of libavif's slow path (4:2:0 and 4:2:2 off
    libyuv's matrices)."""
    for layout, matrix in (("420", 6), ("444", 1), ("420", 4), ("444", 4),
                           ("400", 6), ("422", 9)):
        data = avif(40, 30, depth, layout, matrix, True, alpha=True,
                    prem=True, seed=depth)
        assert assert_same(data).shape[2] == 4


@needs_writer
def test_limited_range_and_doubled_alpha():
    """An alpha stream that says limited range is taken to full range
    (libavif's avifLimitedToFullY) before the rest; of two alpha items,
    libavif takes the first in its order of items."""
    data = avif(48, 32, 8, "420", alpha=True, seed=3)
    doc = M.demux(data)
    aid = next(f for t, f, to in doc["refs"] if t == b"auxl")
    M.item(doc, aid)["payload"] = M.with_range_flipped(
        M.item(doc, aid)["payload"])
    limited = M.mux(doc)
    for d in (limited, M.add_prem(limited)):
        assert assert_same(d).shape[2] == 4
    other = M.demux(avif(48, 32, 8, "420", alpha=True, seed=4))
    obu = M.item(other, next(f for t, f, to in other["refs"]
                             if t == b"auxl"))["payload"]
    for first in (False, True):
        two = M.add_alpha_item(data, obu, first=first)
        assert assert_same(two).shape[2] == 4
        assert assert_same(M.add_prem(two)).shape[2] == 4
    a_first = port_codecs.decode_bytes(M.add_alpha_item(data, obu, True),
                                       device="cpu")[0]
    a_last = port_codecs.decode_bytes(M.add_alpha_item(data, obu),
                                      device="cpu")[0]
    assert not np.array_equal(a_first[..., 3], a_last[..., 3])


# -- no nclx --------------------------------------------------------------------


@needs_writer
@pytest.mark.parametrize("colr", ["prof", "rICC", "none"])
@pytest.mark.parametrize("matrix", [6, 1, 9])
def test_no_nclx_takes_the_sequence_header(matrix, colr):
    """With no nclx, libavif takes the matrix, primaries and range of the
    stream's sequence header (not a BT.601 default): headers of BT.601,
    BT.709 and BT.2020 at both ranges."""
    boxes = [] if colr == "none" else [M.colr_icc(M.srgb_icc(),
                                                  colr.encode())]
    for full in (False, True):
        data = M.set_colr(avif(31, 23, 10, "420", matrix, full,
                               primaries=matrix, seed=matrix), boxes)
        assert not isinstance(assert_same(data), str)
    # an ICC profile beside the nclx: the nclx's description
    both = M.set_colr(avif(31, 23, 8, "444", 6), boxes + [
        M.colr_nclx(1, 13, 1, True)])
    assert_same(both)


@needs_writer
@pytest.mark.parametrize("case", ["no_nclx", "matrix_0", "matrix_0_full"])
def test_monochrome_files_decode(case):
    """A 4:0:0 AVIF with no nclx or with matrix 0 decodes in the reference
    (Pillow); the port answered them "Decoding of color planes failed"
    (its native path declines them, as the reference's does, and the 501
    guard let them through). They reach ``decode_bytes`` through every
    request without a resize and through ``batcher.decode``."""
    mono = M.encode_avif_hbd(planes(47, 33, 8, "400", 5)[0], None, None, 8,
                             "400", 20)
    data = {"no_nclx": M.set_colr(mono, []),
            "matrix_0": M.retag_matrix(mono, 0),
            "matrix_0_full": M.set_colr(mono, [M.colr_nclx(1, 13, 0, True)])
            }[case]
    want, got = decode_both(data)
    assert isinstance(want, np.ndarray) and isinstance(got, np.ndarray), got
    assert np.array_equal(got, want)


@needs_writer
def test_clap_irot_and_imir_leave_the_pixels():
    """libavif does not apply a clean aperture on this path, and Pillow
    turns irot / imir into an EXIF orientation: the pixels stay as coded
    (the reference's native path, which crops to a valid clap, declines
    these files for their missing nclx)."""
    data = M.set_colr(avif(64, 48, seed=21), [])
    clap = M._box(b"clap", struct.pack(">8i", 32, 1, 24, 1, -8, 1, -4, 1))
    for boxes in ([clap], [M._box(b"irot", b"\x01")],
                  [M._box(b"imir", b"\x01")],
                  [clap, M._box(b"irot", b"\x03"),
                   M._box(b"imir", b"\x00")]):
        edited = _edit(data, 1, lambda it: it["props"].extend(
            (b, True) for b in boxes))
        assert assert_same(edited).shape == (48, 64, 3)


# -- grids ------------------------------------------------------------------------


def grid(cols, rows, cw=64, ch=64, layout="420", depth=8, alpha=False,
         prem=False, matrix=6, full=False, seed=0):
    cells = [planes(cw, ch, depth, layout, seed + k)
             for k in range(cols * rows)]
    alphas = [planes(cw, ch, depth, "400", seed + 100 + k)[0]
              for k in range(cols * rows)] if alpha else None
    return M.encode_avif_grid(cells, cols, rows, depth, layout, 20,
                              alpha_cells=alphas, premultiplied=prem,
                              cicp=(1, 13, matrix), full_range=full)


GRIDS = {
    "1x2": lambda: grid(1, 2),
    "3x2": lambda: grid(3, 2),
    "3x2_crop": lambda: M.set_grid_output(grid(3, 2), 130, 100),
    "3x2_alpha": lambda: grid(3, 2, alpha=True),
    "2x2_alpha_prem_crop": lambda: M.set_grid_output(
        grid(2, 2, alpha=True, prem=True), 100, 70),
    "2x2_10bit_alpha": lambda: grid(2, 2, depth=10, alpha=True),
    "2x2_12bit_444_prem": lambda: grid(2, 2, layout="444", depth=12,
                                       alpha=True, prem=True),
    "2x1_444_odd": lambda: M.set_grid_output(grid(2, 1, 65, 67, "444"), 129,
                                             60),
    "2x2_422": lambda: grid(2, 2, 66, 65, "422"),
    "2x2_mono": lambda: grid(2, 2, layout="400"),
    "2x2_709_full": lambda: grid(2, 2, matrix=1, full=True),
    "2x2_no_nclx": lambda: M.set_colr(grid(2, 2, matrix=9, full=True), []),
    "dimg_reversed": lambda: _refs(grid(2, 2), lambda to: to[::-1]),
}


def _refs(data, fn):
    doc = M.demux(data)
    doc["refs"] = [(t, f, fn(to)) if t == b"dimg" else (t, f, to)
                   for t, f, to in doc["refs"]]
    return M.mux(doc)


def _replace_cell(data, k, other):
    doc, od = M.demux(data), M.demux(other)
    cell = M.item(doc, k)
    cell["payload"], cell["props"] = (od["items"][0]["payload"],
                                      od["items"][0]["props"])
    return M.mux(doc)


def _extra_cell(data):
    """A seventh cell item (a copy of the first) among the grid's dimg
    references."""
    doc = M.demux(data)
    cell = dict(M.item(doc, 2), id=max(it["id"] for it in doc["items"]) + 1)
    doc["items"].append(cell)
    doc["refs"] = [(t, f, to + [cell["id"]]) if t == b"dimg" else (t, f, to)
                   for t, f, to in doc["refs"]]
    return M.mux(doc)


def _edit(data, iid, fn):
    doc = M.demux(data)
    fn(M.item(doc, iid))
    return M.mux(doc)


def _ispe(w, h):
    def fn(it):
        it["props"] = [(M._full(b"ispe", struct.pack(">II", w, h)), e)
                       if b[4:8] == b"ispe" else (b, e)
                       for b, e in it["props"]]
    return fn


HOSTILE = {
    "output_beyond_the_cells": lambda g: M.set_grid_output(g, 200, 128),
    "last_column_unused": lambda g: M.set_grid_output(g, 128, 128),
    "odd_output_width": lambda g: M.set_grid_output(g, 191, 128),
    "too_few_dimg": lambda g: _refs(g, lambda to: to[:-1]),
    "dimg_twice": lambda g: _refs(g, lambda to: to[:-1] + to[:1]),
    "unequal_cells": lambda g: _replace_cell(g, 3, M.encode_avif_hbd(
        *planes(64, 48, 8, "420", 9), 8, "420", 20)),
    "444_cell": lambda g: _replace_cell(g, 3, M.encode_avif_hbd(
        *planes(64, 64, 8, "444", 9), 8, "444", 20)),
    "709_cell": lambda g: _replace_cell(g, 3, M.encode_avif_hbd(
        *planes(64, 64, 8, "420", 9), 8, "420", 20, cicp=(1, 13, 1))),
    "grid_version_1": lambda g: _edit(g, 1, lambda it: it.update(
        payload=b"\x01" + it["payload"][1:])),
    "grid_trailing_byte": lambda g: _edit(g, 1, lambda it: it.update(
        payload=it["payload"] + b"\0")),
    "grid_ispe_smaller": lambda g: _edit(g, 1, _ispe(100, 100)),
    "grid_ispe_larger": lambda g: _edit(g, 1, _ispe(200, 200)),
    "cell_ispe_smaller": lambda g: _edit(g, 3, _ispe(64, 48)),
    "first_cell_without_av1C": lambda g: _edit(g, 2, lambda it: it.update(
        props=[p for p in it["props"] if p[0][4:8] != b"av1C"])),
    "cell_without_av1C": lambda g: _edit(g, 3, lambda it: it.update(
        props=[p for p in it["props"] if p[0][4:8] != b"av1C"])),
    "empty_cell": lambda g: _edit(g, 3, lambda it: it.update(payload=b"")),
    "corrupt_cell": lambda g: _edit(g, 3, lambda it: it.update(
        payload=it["payload"][:40] + bytes(x ^ 0x55
                                           for x in it["payload"][40:]))),
    "too_many_dimg": lambda g: _extra_cell(g),
    "cut_short": lambda g: g[:-100],
    "48_pixel_cells": lambda g: grid(2, 2, 48, 48),
    "odd_cell_height_420": lambda g: grid(2, 2, 64, 65),
}


@needs_writer
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grids(name):
    """Cells decoded, stitched in YUV (the chroma upsampling crosses the
    seams) and cropped as libavif does."""
    assert not isinstance(assert_same(GRIDS[name]()), str)


@needs_writer
@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_grids_answer_as_the_reference(name):
    """Each answers the reference's array or words, never a crash; a cell
    that libavif rescales (its ispe is not its stream's size) decodes to
    its array too."""
    data = HOSTILE[name](grid(3, 2, seed=7))
    assert_same(data)


@needs_writer
def test_a_cell_libavif_rescales_is_not_ported():
    """libavif rescales a cell whose stream is smaller than its ispe (it
    answered 501 before the port's scaler, ``native/avif_scale.cpp``); the
    port decodes it to Pillow's array."""
    g = grid(3, 2, seed=7)
    doc, od = M.demux(g), M.demux(M.encode_avif_hbd(
        *planes(64, 48, 8, "420", 9), 8, "420", 20))
    M.item(doc, 3)["payload"] = od["items"][0]["payload"]
    data = M.mux(doc)
    want = ref_codecs.decode_bytes(data)[0]
    got = port_codecs.decode_bytes(data, device="cpu")[0]
    assert isinstance(want, np.ndarray) and np.array_equal(got, want)


# -- the committed fixtures of phase 28 ----------------------------------------


def _pillow_table() -> dict:
    return json.loads((FIXTURES / "pillow_arrays.json").read_text())


@pytest.mark.parametrize("name", sorted(_pillow_table()))
def test_committed_fixtures_equal_pillow(name):
    """Each committed file decodes to the array whose digest was taken
    from Pillow where the file was made, and to the reference's now."""
    entry = _pillow_table()[name]
    data = (FIXTURES / entry["file"]).read_bytes()
    got = port_codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == (entry["height"], entry["width"],
                         4 if entry["mode"] == "RGBA" else 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    want = ref_codecs.decode_bytes(data)[0]
    assert np.array_equal(got, want)
    assert ref_avif.decode_rgb(data) is None


def test_the_grid_takes_the_rgb_heads_bucket(monkeypatch):
    """The 12 MP grid to w=400 WebP: the RGB head's (3424, 4352) ->
    (368, 400) bucket through ``batcher.decode`` and ``_resize_encode``,
    not the exact-shape path; one ``rgb_resize`` (K2) a batch, whose
    plain version serves the CPU's tensors here."""
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.ops import resize_strip
    from imagekit_tpu_torch.serving import batcher as port_batcher

    data = (FIXTURES / "4032x3024_grid.avif").read_bytes()
    keys, calls = [], []
    real_flush = port_batcher.BatchedEngine._flush
    real_rgb = resize_strip.rgb_resize_plain

    async def flush(self, key, items):
        keys.append(key)
        return await real_flush(self, key, items)

    def rgb(*a, **kw):
        calls.append(a[0].shape)
        return real_rgb(*a, **kw)

    async def no_exact(*a, **kw):
        raise AssertionError("the grid took the exact-shape path")

    monkeypatch.setattr(port_batcher.BatchedEngine, "_flush", flush)
    monkeypatch.setattr(port_batcher.BatchedEngine, "_exact_path", no_exact)
    # K2's wrapper takes its plain version for the CPU tensors of the test
    monkeypatch.setattr(resize_strip, "rgb_resize_plain", rgb)

    async def run():
        eng = port_batcher.BatchedEngine(device="cpu")
        try:
            return await eng.transform(data, 400, None, ImageFormat.webp, 80)
        finally:
            await eng.close()

    out = asyncio.run(run())
    assert vp8.dimensions(out) == (400, 300)
    assert (3424, 4352, 368, 400, 3, "yuv") in keys
    assert len(calls) == 1


# -- threads ----------------------------------------------------------------------


def test_threads_give_the_same_pixels():
    """The cells on the pool and the colour step's row bands: one worker
    and many give the same array (4:2:0 crosses band edges)."""
    data = (FIXTURES / "4032x3024_grid.avif").read_bytes()
    one = avif_libavif.decode_pillow_rgb(data, threads=1)
    assert np.array_equal(avif_libavif.decode_pillow_rgb(data, threads=0),
                          one)
    y, u, v = planes(301, 203, 10, "420", 1)
    a = planes(301, 203, 10, "400", 2)[0]
    for matrix, prem in ((6, False), (6, True), (4, True), (0, False)):
        layout = av1_dec_abi.I444 if matrix == 0 else av1_dec_abi.I420
        uu, vv = (planes(301, 203, 10, "444", 3)[1:] if matrix == 0
                  else (u, v))
        outs = [avif_yuv_rgb.convert(y, uu, vv, a, 10, layout, True, matrix,
                                     1, prem, threads=t) for t in (1, 3, 8)]
        assert all(np.array_equal(outs[0], o) for o in outs[1:])


# -- the apps ---------------------------------------------------------------------


HTTP_CLASSES = {
    "grid": lambda: grid(3, 2, alpha=True, seed=11),
    "hdr_2020": lambda: avif(160, 96, 10, "420", 9, primaries=9, seed=12),
    "identity_lossless": lambda: M.encode_avif_hbd(
        *planes(160, 96, 8, "444", 13), 8, "444", 0, cicp=(1, 13, 0),
        full_range=True),
    "icc_only": lambda: M.set_colr(avif(160, 96, seed=14),
                                   [M.colr_icc(M.srgb_icc())]),
    "premultiplied": lambda: avif(160, 96, alpha=True, prem=True, seed=15),
    "monochrome_no_nclx": lambda: M.set_colr(M.encode_avif_hbd(
        planes(160, 96, 8, "400", 16)[0], None, None, 8, "400", 20), []),
}


@needs_writer
@pytest.mark.parametrize("name", sorted(HTTP_CLASSES))
def test_img_and_upload_serve_as_the_reference(tmp_path, name):
    """``/img`` at w=64 WebP and with no resize, and ``/upload`` at w=48
    JPEG: the reference app's statuses and types, bodies of the same size
    within 38 dB."""
    data = HTTP_CLASSES[name]()
    assert ref_avif.decode_rgb(data) is None

    async def fn(client):
        return [await _img(client, url=_url("x"), w=64),
                await _img(client, url=_url("x")),
                await _upload(client, data, w=48, f="jpeg")]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        assert _out_size(pb) == _out_size(rb)
        assert psnr(_decoded(pb), _decoded(rb)) >= 38.0
