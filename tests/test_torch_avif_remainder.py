"""The last AVIFs that answered 501 without inter prediction, against
their oracles (CPU tests; no card needed):

- items, alpha items and grid cells whose stream is not their ``ispe``'s
  size, which libavif 1.3.0 rescales with libyuv's ``ScalePlane``
  (``codecs/native/avif_scale.cpp``): the scaler alone against Pillow's
  own libavif (``avifImageScale`` of the copy in Pillow's wheel, through
  ctypes) on seeded planes at every depth, layout and path of libyuv, and
  whole files against Pillow 12.1's arrays (the reference's
  ``decode_bytes``), byte for byte;
- grids whose alpha is one ``auxl`` item a colour cell
  (``avifMetaFindAlphaItem``), against Pillow;
- layered streams (two spatial layers, both key frames, spliced from
  libaom's stills: ``make_avif_sources.layered_stream``): a base at the
  full size, which the reference's native path serves with libdav1d's
  first picture, and a base at half size, which it hands to Pillow, whose
  libavif returns the top layer; ``a1op``, ``lsel`` and ``a1lx``;
- a hidden key frame shown by ``show_existing_frame``
  (``make_avif_sources.hidden_key_stream``), against libdav1d's planes
  through the reference's ``_decode_obu``;
- what was left, a stream whose output frame is an INTER frame, now
  served: the top layer of a same-size layered file through the Pillow
  path equals Pillow's array (``test_torch_av1_inter.py`` and
  ``test_torch_avif_inter.py`` hold inter frames to libdav1d and Pillow);
- ``/img`` and ``/upload`` through both apps, and the committed files of
  ``chip_smoke.py``'s phase 28 (``remainder_arrays.json``).
"""

import ctypes
import glob
import hashlib
import json
import os
import struct
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch.codecs.native import av1_dec_abi, avif_scale
from tests.fixtures import make_avif_sources as M
from tests.test_torch_avif_libavif import assert_same, decode_both, grid, planes
from tests.test_torch_av1_decode import remainder_avif
from tests.test_torch_avif_sources import _upload
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import _img, _serve, _url

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "avif"
needs_libs = pytest.mark.skipif(
    not (ref_avif.decode_available() and M._aom_lib() is not None
         and M._avif_lib() is not None),
    reason="libdav1d (the oracle), libaom.so.3 or libavif.so.15 (the "
           "writers) unavailable")


@lru_cache(maxsize=1)
def _plain_avif() -> bytes:
    return M.encode_avif_hbd(*planes(64, 64, 8, "420"), 8, "420", 30)


@pytest.fixture(autouse=True)
def _reference(monkeypatch):
    """The reference's native library loaded, and its libdav1d path
    validated by a plain file first, with its state kept to this test: the
    path turns itself off for good where the first picture it checks is
    not its container's size (its ABI guard), which these files are
    made to be."""
    _ref_native_lib(monkeypatch)
    for key, value in (("disabled", False), ("validated", False)):
        monkeypatch.setitem(ref_avif._state, key, value)
    if ref_avif.decode_available():
        assert ref_avif.decode_rgb(_plain_avif()) is not None
        assert ref_avif._state["validated"]


# -- the scaler alone, against Pillow's libavif ------------------------------------


@lru_cache(maxsize=1)
def _pillow_libavif():
    """The libavif 1.3.0 in Pillow's wheel (libyuv inside), or None."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libavif-*.so*"))
    if not libs:
        return None
    lib = ctypes.CDLL(libs[0])
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    lib.avifImageScale.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                   ctypes.c_uint32, ctypes.c_void_p]
    return lib


_FORMAT = {"444": 1, "422": 2, "420": 3, "400": 4}
_SUB = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": (1, 1)}


def _put(addr: int, row_bytes: int, arr: np.ndarray) -> None:
    for r in range(arr.shape[0]):
        ctypes.memmove(addr + r * row_bytes,
                       arr.ctypes.data + r * arr.strides[0],
                       arr.shape[1] * arr.itemsize)


def _get(addr: int, row_bytes: int, h: int, w: int, dt) -> np.ndarray:
    raw = np.frombuffer(ctypes.string_at(addr, row_bytes * h), np.uint8)
    rows = raw.reshape(h, row_bytes)[:, :w * np.dtype(dt).itemsize]
    return np.ascontiguousarray(rows).view(dt).reshape(h, w)


def pillow_scale(y, u, v, a, depth: int, layout: str, width: int,
                 height: int):
    """libavif's avifImageScale of an image of these planes (``a`` its
    alpha or None), at the avifImage offsets of libavif 1.x (planes at 24,
    their row bytes at 48, alpha at 64 and 72) -> (result, planes): result
    0 or libavif's error code, then (y, u, v, a) as scaled."""
    lib = _pillow_libavif()
    h, w = y.shape
    dt = np.uint8 if depth == 8 else np.uint16
    img = lib.avifImageCreate(w, h, depth, _FORMAT[layout])
    try:
        assert lib.avifImageAllocatePlanes(img, 1 | (2 if a is not None
                                                     else 0)) == 0
        ptr = (ctypes.c_void_p * 3).from_address(img + 24)
        rb = (ctypes.c_uint32 * 3).from_address(img + 48)
        alpha_at = lambda: (ctypes.c_void_p.from_address(img + 64).value,
                            ctypes.c_uint32.from_address(img + 72).value)
        _put(ptr[0], rb[0], y)
        if layout != "400":
            _put(ptr[1], rb[1], u)
            _put(ptr[2], rb[2], v)
        if a is not None:
            _put(*alpha_at(), a)
        rc = lib.avifImageScale(img, width, height,
                                ctypes.create_string_buffer(512))
        if rc:
            return rc, None
        sx, sy = _SUB[layout]
        cw, ch = (width + sx) >> sx, (height + sy) >> sy
        out = [_get(ptr[0], rb[0], height, width, dt), None, None, None]
        if layout != "400":
            out[1] = _get(ptr[1], rb[1], ch, cw, dt)
            out[2] = _get(ptr[2], rb[2], ch, cw, dt)
        if a is not None:
            out[3] = _get(*alpha_at(), height, width, dt)
        return 0, out
    finally:
        lib.avifImageDestroy(img)


def port_scale(y, u, v, a, layout: str, width: int, height: int,
               threads: int = 0):
    sx, sy = _SUB[layout]
    dims = ((width + sx) >> sx, (height + sy) >> sy)
    return [avif_scale.scale_plane(y, width, height, threads=threads),
            None if u is None else avif_scale.scale_plane(u, *dims,
                                                          threads=threads),
            None if v is None else avif_scale.scale_plane(v, *dims,
                                                          threads=threads),
            None if a is None else avif_scale.scale_plane(a, width, height,
                                                          threads=threads)]


#: (source, target) sizes that take every path of libyuv's ScalePlane, by
#: the name of the path the luma takes
SCALES = {
    "vertical_down": ((40, 90), (40, 37)),
    "vertical_up": ((40, 30), (40, 71)),
    "three_quarters": ((96, 64), (72, 48)),
    "three_quarters_simd": ((128, 64), (96, 48)),
    "half": ((96, 64), (48, 32)),
    "half_odd": ((98, 66), (49, 33)),
    "three_eighths": ((128, 64), (48, 24)),
    "three_eighths_simd": ((160, 96), (60, 36)),
    "quarter": ((96, 64), (24, 16)),
    "box": ((200, 120), (61, 37)),
    "box_whole": ((150, 90), (50, 30)),
    "up2_even": ((48, 32), (96, 64)),
    "up2_odd": ((48, 32), (95, 63)),
    "up2_linear": ((48, 32), (95, 32)),
    "bilinear_up": ((48, 32), (131, 83)),
    "bilinear_up_one_row": ((40, 1), (90, 7)),
    "bilinear_down": ((96, 64), (61, 41)),
    "bilinear_down_width_up": ((96, 64), (150, 50)),
    "linear_third": ((90, 60), (70, 20)),
    "simple": ((90, 60), (30, 60)),
    "one_column": ((1, 40), (5, 17)),
    "large_up": ((480, 270), (1927, 1075)),
}


@pytest.mark.skipif(_pillow_libavif() is None,
                    reason="Pillow's wheel has no libavif")
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("name", sorted(SCALES))
def test_scaler_equals_pillows_libavif(name, depth):
    """Every plane of every layout, alpha included, equals libavif's
    avifImageScale (libyuv's ScalePlane / ScalePlane_12 with kFilterBox)
    on seeded planes over the depth's whole range; the same at one thread
    as on many."""
    (sw, sh), (dw, dh) = SCALES[name]
    rng = np.random.default_rng(sw * 1000 + dw + depth)
    dt = np.uint8 if depth == 8 else np.uint16
    top = 1 << depth
    for layout in ("400", "420", "422", "444"):
        sx, sy = _SUB[layout]
        y = rng.integers(0, top, (sh, sw)).astype(dt)
        cshape = ((sh + sy) >> sy, (sw + sx) >> sx)
        u = v = None
        if layout != "400":
            u = rng.integers(0, top, cshape).astype(dt)
            v = rng.integers(0, top, cshape).astype(dt)
        a = rng.integers(0, top, (sh, sw)).astype(dt)
        rc, want = pillow_scale(y, u, v, a, depth, layout, dw, dh)
        assert rc == 0
        got = port_scale(y, u, v, a, layout, dw, dh)
        for g, w, plane in zip(got, want, "YUVA"):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.shape == w.shape, plane
            assert np.array_equal(g, w), (layout, plane, int(np.argmax(
                (g != w).reshape(-1))))
    one = port_scale(y, u, v, a, layout, dw, dh, threads=1)
    assert all(np.array_equal(p, q) for p, q in zip(one, got))


@pytest.mark.skipif(_pillow_libavif() is None,
                    reason="Pillow's wheel has no libavif")
def test_scaler_crops_and_refusals():
    """A crop is the top-left of the whole scaled plane; the sizes
    avifImageScaleWithLimit refuses are :func:`avif_scale.check`'s."""
    rng = np.random.default_rng(4)
    p = rng.integers(0, 256, (37, 51)).astype(np.uint8)
    for dw, dh in ((130, 90), (20, 15), (51, 80), (40, 37)):
        whole = avif_scale.scale_plane(p, dw, dh)
        for cw, ch in ((1, 1), (dw // 2 + 1, dh // 3 + 1), (dw, dh)):
            crop = avif_scale.scale_plane(p, dw, dh, (cw, ch))
            assert np.array_equal(crop, whole[:ch, :cw])
    # (source, target, refused); libavif answers a refusal before it
    # allocates, so Pillow's copy is asked wherever the target is refused
    # or small (16384 x 16384 would be 256 MB)
    cases = [((51, 37), (0, 10), True), ((51, 37), (32769, 2), True),
             ((51, 37), (16384, 16385), True),
             ((51, 37), (16384, 16384), False),
             ((16385, 1), (8, 8), True), ((1, 16385), (8, 8), True),
             ((16384, 1), (4, 1), False)]
    for (sw, sh), (dw, dh), refused in cases:
        if refused or dw * dh <= 64:
            src = np.zeros((sh, sw), np.uint8)
            rc = pillow_scale(src, None, None, None, 8, "400", dw, dh)[0]
            assert (rc != 0) == refused, ((sw, sh), (dw, dh), rc)
        try:
            avif_scale.check((sw, sh), (dw, dh))
            assert not refused, ((sw, sh), (dw, dh))
        except avif_scale.Refused:
            assert refused, ((sw, sh), (dw, dh))


# -- items, alpha items and cells rescaled: files against Pillow ---------------


#: target sizes of a 96 x 64 item's ispe
ISPE = {"up2": (192, 128), "down2": (48, 32), "three_quarters": (72, 48),
        "three_eighths": (36, 24), "odd_up": (101, 67),
        "odd_down": (61, 41), "box": (30, 21), "non_integer_up": (150, 100)}


@lru_cache(maxsize=None)
def _item(depth: int, layout: str, alpha: bool) -> bytes:
    a = planes(96, 64, depth, "400", 77)[0] if alpha else None
    return M.encode_avif_hbd(*planes(96, 64, depth, layout, 7), depth,
                             layout, 12, alpha=a)


@needs_libs
@pytest.mark.parametrize("layout", ["400", "420", "422", "444"])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_rescaled_items_equal_pillow(depth, layout):
    """An item coded at 96 x 64 under each ispe of :data:`ISPE` (and its
    alpha item under the same, or alone under another) decodes to
    Pillow's array, byte for byte."""
    plain = _item(depth, layout, False)
    with_alpha = _item(depth, layout, True)
    colour = M.demux(plain)["primary"]
    doc = M.demux(with_alpha)
    alpha = next(frm for t, frm, to in doc["refs"] if t == b"auxl")
    for name, (w, h) in ISPE.items():
        arr = assert_same(M.set_ispe(plain, [colour], w, h))
        assert not isinstance(arr, str) and arr.shape[:2] == (h, w), name
        both = M.set_ispe(with_alpha, [doc["primary"], alpha], w, h)
        arr = assert_same(both)
        assert not isinstance(arr, str) and arr.shape == (h, w, 4), name
    # the alpha item alone under another ispe: libavif scales it to that
    # size, then the planes differ and the frame fails
    assert isinstance(assert_same(M.set_ispe(with_alpha, [alpha], 48, 32)),
                      str)


@needs_libs
@pytest.mark.parametrize("size", [(20000, 20000), (40000, 8), (16384, 16385),
                                  (0, 64), (13000, 1)])
def test_a_tiny_stream_under_a_huge_ispe(size):
    """A 96 x 64 stream under an ispe past Pillow's bomb ceiling, libavif's
    dimension or size limit, or of a side 0, answers Pillow's words
    before anything of that size is allocated; one within every limit is
    scaled as libavif scales it."""
    plain = _item(8, "420", False)
    data = M.set_ispe(plain, [M.demux(plain)["primary"]], *size)
    want, got = decode_both(data)
    if size == (13000, 1):
        assert isinstance(want, np.ndarray) and want.shape[:2] == (1, 13000)
    else:
        assert isinstance(want, str)
    assert_same(data)


def _cells_ispe(data: bytes, w: int, h: int, alpha: bool = False) -> bytes:
    doc = M.demux(data)
    grids = [doc["primary"]] + [frm for t, frm, to in doc["refs"]
                                if t == b"auxl"] if alpha else \
        [doc["primary"]]
    cells = [c for t, frm, to in doc["refs"] if t == b"dimg" and frm in grids
             for c in to]
    return M.set_ispe(data, cells, w, h)


GRID_CASES = {
    "cells_up": lambda: _cells_ispe(grid(3, 2), 96, 80),
    "cells_down": lambda: _cells_ispe(grid(2, 2, 128, 128), 64, 64),
    "cells_up_cropped": lambda: M.set_grid_output(
        _cells_ispe(grid(3, 2), 96, 96), 250, 150),
    "cells_10bit_422": lambda: _cells_ispe(grid(2, 2, 64, 64, "422", 10),
                                           100, 70),
    "cells_12bit_444_alpha": lambda: _cells_ispe(
        grid(2, 2, 64, 64, "444", 12, alpha=True), 90, 66, alpha=True),
    "cells_mono_box": lambda: _cells_ispe(grid(2, 2, 200, 200, "400"),
                                          64, 64),
    "colour_cells_alone": lambda: _cells_ispe(grid(2, 2, alpha=True), 80, 80),
    "cells_beyond_the_canvas": lambda: _cells_ispe(grid(3, 2), 200, 200),
    "cells_of_no_width": lambda: _cells_ispe(grid(3, 2), 0, 64),
    "cells_one_wide": lambda: M.set_grid_output(_cells_ispe(grid(1, 2), 1,
                                                            64), 1, 100),
}


@needs_libs
@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_rescaled_grid_cells_equal_pillow(name):
    """Cells scaled to their ispe before they are stitched, alpha cells
    too: Pillow's array or words."""
    assert_same(GRID_CASES[name]())


# -- grids with one alpha item a cell -------------------------------------------


def _alpha_refs(data: bytes, fn) -> bytes:
    doc = M.demux(data)
    fn(doc)
    return M.mux(doc)


def _second_alpha(doc):
    first = next(r for r in doc["refs"] if r[0] == b"auxl")
    extra = dict(M.item(doc, first[1]), id=90)
    doc["items"].append(extra)
    doc["refs"].append((b"auxl", 90, first[2]))


CELL_ALPHA = {
    "3x2": lambda: M.per_cell_alpha(grid(3, 2, alpha=True)),
    "3x2_cropped": lambda: M.set_grid_output(
        M.per_cell_alpha(grid(3, 2, alpha=True)), 150, 100),
    "2x2_10bit": lambda: M.per_cell_alpha(grid(2, 2, depth=10, alpha=True)),
    "2x2_444_12bit": lambda: M.per_cell_alpha(
        grid(2, 2, 64, 64, "444", 12, alpha=True)),
    "alpha_cells_rescaled": lambda: _cells_ispe(
        M.per_cell_alpha(grid(2, 2, alpha=True)), 64, 64),
    "one_cell_without_alpha": lambda: _alpha_refs(
        M.per_cell_alpha(grid(2, 2, alpha=True)),
        lambda d: d["refs"].remove(next(r for r in d["refs"]
                                        if r[0] == b"auxl"))),
    "two_alphas_for_a_cell": lambda: _alpha_refs(
        M.per_cell_alpha(grid(2, 2, alpha=True)), _second_alpha),
}


@needs_libs
@pytest.mark.parametrize("name", sorted(CELL_ALPHA))
def test_grids_with_an_alpha_item_a_cell_equal_pillow(name):
    """avifMetaFindAlphaItem's alpha grid of one auxl item a colour cell
    (RGBA), a cell without one (RGB), two for one cell (Pillow's 400):
    Pillow's array or words."""
    data = CELL_ALPHA[name]()
    assert ref_avif.decode_rgb(data) is None  # the reference hands it on
    want = assert_same(data)
    if name.startswith(("3x2", "2x2", "alpha")):
        assert want.shape[2] == 4


# -- layered streams ------------------------------------------------------------


def _layer(w: int, h: int, seed: int, q: int, full=(96, 64), **kw) -> bytes:
    return M.encode_av1_libaom(*planes(w, h, 8, "420", seed), 8, "420", q,
                               limit=2, forced_max=full,
                               options={"sb-size": "64"}, **kw)


@lru_cache(maxsize=None)
def layered(base: str) -> bytes:
    """A 96 x 64 file of two spatial layers, both key frames: the base at
    96 x 64 ("full") or 48 x 32 ("half")."""
    top = _layer(96, 64, 31, 20)
    low = _layer(96, 64, 32, 40) if base == "full" else _layer(48, 32, 33,
                                                               40)
    return M.av1_avif(M.layered_stream(low, top), 96, 64, 8, "420")


def _props(data: bytes, props) -> bytes:
    doc = M.demux(data)
    it = M.item(doc, doc["primary"])
    it["props"] = it["props"] + props
    return M.mux(doc)


def _base_end(data: bytes) -> int:
    """The bytes of the sequence header and the base layer's frame."""
    obus = list(M._obus(M.demux(data)["items"][0]["payload"]))
    return len(obus[0][1]) + len(obus[1][1])


def _lsel(layer: int):
    return (M._box(b"lsel", struct.pack(">H", layer)), True)


def _a1lx(*sizes):
    return (M._box(b"a1lx", b"\0" + struct.pack(">HHH", *sizes)), False)


@needs_libs
def test_layered_full_base_is_libdav1ds_first_picture():
    """The reference's native path (libdav1d at all_layers 1) serves the
    base layer, the first picture; the port's decoder returns the same
    planes, and the same array through ``decode_bytes``."""
    data = layered("full")
    obu = ref_avif.parse_container(data).obu
    want = ref_avif._decode_obu(obu, 96, 64)
    y, u, v, info = av1_dec_abi.decode(obu)
    assert (info.spatial_id, info.frames) == (0, 1)
    assert all(np.array_equal(p, q) for p, q in zip((y, u, v), want[:3]))
    assert av1_dec_abi.probe(obu, select=av1_dec_abi.HIGHEST).spatial_id == 1
    assert ref_avif.decode_rgb(data) is not None
    assert_same(data)


LAYERED = {
    "half_base": lambda: layered("half"),
    "lsel_0_scaled": lambda: _props(layered("half"), [_lsel(0)]),
    "lsel_1": lambda: _props(layered("half"), [_lsel(1)]),
    "lsel_2_absent": lambda: _props(layered("half"), [_lsel(2)]),
    "lsel_4": lambda: _props(layered("half"), [_lsel(4)]),
    "lsel_not_essential": lambda: _props(
        layered("half"), [(_lsel(0)[0], False)]),
    "lsel_ffff": lambda: _props(layered("half"), [_lsel(0xFFFF)]),
    "a1op_1_base_alone": lambda: _props(
        layered("half"), [(M._box(b"a1op", b"\x01"), True)]),
    "a1op_5_no_such_point": lambda: _props(
        layered("half"), [(M._box(b"a1op", b"\x05"), True)]),
    "a1op_32": lambda: _props(layered("half"),
                              [(M._box(b"a1op", b"\x20"), True)]),
    "a1lx_lsel_0": lambda: _props(layered("half"), [
        _a1lx(_base_end(layered("half")), 0, 0), _lsel(0)]),
    "a1lx_lsel_1": lambda: _props(layered("half"), [
        _a1lx(_base_end(layered("half")), 0, 0), _lsel(1)]),
    "a1lx_cut_in_the_top": lambda: _props(layered("half"), [
        _a1lx(_base_end(layered("half")) + 9, 0, 0), _lsel(0)]),
    "a1lx_too_large": lambda: _props(layered("half"), [_a1lx(60000, 0, 0)]),
    "a1lx_essential": lambda: _props(layered("half"), [
        (_a1lx(10, 0, 0)[0], True)]),
}


@needs_libs
@pytest.mark.parametrize("name", sorted(LAYERED))
def test_layered_files_equal_pillow(name):
    """A base at half size: the reference's native path declines the
    first picture (not the ispe's size) and Pillow's libavif returns the
    highest layer at all_layers 0, or the ``lsel`` layer (scaled to the
    ispe), at the ``a1op`` point, fed the bytes ``a1lx`` gives; its
    refusals in Pillow's words."""
    data = LAYERED[name]()
    assert ref_avif.decode_rgb(data) is None
    assert_same(data)


# -- hidden key frames ---------------------------------------------------------


def hidden_key(depth: int = 8, layout: str = "420", **options) -> bytes:
    obu = M.encode_av1_libaom(*planes(96, 64, depth, layout, 41), depth,
                              layout, 30, limit=2,
                              options={"num-tile-groups": 2,
                                       "tile-columns": 1, **options})
    return M.hidden_key_stream(obu)


@needs_libs
@pytest.mark.parametrize("case", ["8bit_420", "10bit_444", "grain"])
def test_hidden_key_frame_equals_libdav1d(case):
    """A KEY_FRAME with show_frame 0, shown by show_existing_frame (its
    slot refreshed, its film grain loaded): the port's planes equal
    libdav1d's, and the file's array the reference's."""
    obu = {"8bit_420": lambda: hidden_key(),
           "10bit_444": lambda: hidden_key(10, "444"),
           "grain": lambda: hidden_key(**{"film-grain-test": 4})}[case]()
    info = av1_dec_abi.probe(obu)
    assert info.shown_existing and info.frames == 1
    assert info.film_grain == (case == "grain")
    got = av1_dec_abi.decode_samples(obu)
    want = M.dav1d_samples(obu)
    assert all(np.array_equal(p, q) for p, q in zip(got[:3], want[:3]))
    ref = ref_avif._decode_obu(obu, 96, 64)  # the reference's 8-bit planes
    assert all(np.array_equal(p, q)
               for p, q in zip(av1_dec_abi.decode(obu)[:3], ref[:3]))
    depth = 10 if case == "10bit_444" else 8
    layout = "444" if case == "10bit_444" else "420"
    assert_same(M.av1_avif(obu, 96, 64, depth, layout))


# -- what was left: an inter frame as the output -------------------------------


def progressive(nclx: bool = True) -> bytes:
    """Two spatial layers of one size, the top an INTER frame predicted
    from the base (libaom's GOOD usage, a second frame of the same
    picture): a progressive AVIF's layout."""
    obu = M.encode_av1_libaom(*planes(96, 64, 8, "420", 51), 8, "420", 30,
                              limit=2, frames=2, good=True,
                              options={"sb-size": "64"})
    seq = next(o for t, o in M._obus(obu) if t == 1)
    frames = [o for t, o in M._obus(obu) if t == 6]
    data = M.av1_avif(M.with_operating_points(seq, (0x301, 0x101))
                      + M.with_layer(frames[0], 0, 0)
                      + M.with_layer(frames[1], 0, 1), 96, 64, 8, "420")
    return data if nclx else M.set_colr(data, [])


@needs_libs
def test_an_inter_output_frame_is_the_remainder():
    """What was left is served: the native path's first picture is the key
    frame, served as the reference serves it; where the reference hands
    the file to Pillow (no nclx), libavif returns the top layer, an INTER
    frame, which the port now decodes to Pillow's array. An INTER frame of
    no reference fails in the reference's words, with no 501."""
    assert_same(progressive())
    data = progressive(nclx=False)
    want = assert_same(data)
    assert isinstance(want, np.ndarray) and want.shape == (64, 96, 3)
    info = av1_dec_abi.probe(ref_avif.parse_container(data).obu,
                             select=av1_dec_abi.HIGHEST)
    assert info.inter and info.spatial_id == 1
    want, got = decode_both(remainder_avif())
    assert isinstance(want, str) and want == got


# -- the apps --------------------------------------------------------------------


@needs_libs
def test_img_and_upload_as_the_reference_app(tmp_path):
    """``/img`` and ``/upload`` at w=48 to WebP: the same statuses, types
    and bodies through both apps for a rescaled item, a grid with an alpha
    item a cell, both layered files and a hidden key frame."""
    plain = _item(8, "420", False)
    sources = {
        "scaled": M.set_ispe(plain, [M.demux(plain)["primary"]], 150, 100),
        "cell_alpha": M.per_cell_alpha(grid(2, 2, alpha=True)),
        "full": layered("full"),
        "half": layered("half"),
        "hidden": M.av1_avif(hidden_key(), 96, 64, 8, "420"),
    }

    async def fn(client):
        outs = []
        for name, data in sources.items():
            outs.append(await _img(client, url=_url(name), w=48))
            outs.append(await _upload(client, data, w=48))
        return outs

    # the reference's app decodes in this process: its libdav1d path is
    # validated by the plain file of the fixture above
    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        assert pb == rb


# -- the committed files of phase 28 ------------------------------------------------


def _table() -> dict:
    return json.loads((FIXTURES / "remainder_arrays.json").read_text())


@pytest.mark.parametrize("name", sorted(_table()))
def test_committed_remainder_fixtures(name):
    """Each committed file decodes to the array whose digest was taken from
    the reference where it was made (libdav1d's planes too, for the file
    its native path serves), and to the reference's array now."""
    entry = _table()[name]
    data = (FIXTURES / entry["file"]).read_bytes()
    got = port_codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == (entry["height"], entry["width"],
                         4 if entry["mode"] == "RGBA" else 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    assert np.array_equal(got, ref_codecs.decode_bytes(data)[0])
    native = ref_avif.decode_rgb(data) is not None
    assert native == (entry["path"] == "native")
    if native:
        info = ref_avif.parse_container(data)
        h = hashlib.sha256()
        for p in av1_dec_abi.decode(info.obu)[:3]:
            h.update(np.ascontiguousarray(p).tobytes())
        assert h.hexdigest() == entry["planes_sha256"]
