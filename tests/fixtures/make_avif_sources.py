"""Write the AVIF sources of ``chip_smoke.py``'s phase 27 into
``tests/fixtures/avif/``, with the SHA-256 of libdav1d's planes of each
(``avif_planes.json``).

The card's machine has neither Pillow's AVIF writer nor libdav1d, so the
files and the planes the port's AV1 decoder must reproduce there are
made here, all 1920x1080:

- seven pictures (``chip_smoke.synth_image``, its mild noise included)
  written at quality 60 by Pillow (libavif with libaom) as the writer's
  users would: 4:2:0 at its default speed; 4:4:4; 4:2:2; RGBA with
  ``chip_smoke.ramp_alpha``'s plane; 4:2:0 re-tagged BT.709 (the planes
  stay, the nclx matrix says 709); ``enable-cdef``; and speed 4, where the
  encoder turns loop restoration on;
- screen content at Pillow's default settings, where libaom finds it on
  its own and codes palette blocks and intra block copy: a UI screenshot
  (:func:`ui_screenshot`) and a logo sheet (:func:`logo_sheet`), whose
  frame headers must set ``allow_intrabc``, and an RGBA logo sheet at
  quality 60 with ``chip_smoke.with_alpha``'s plane (flat opaque
  rectangles over a ramp), whose alpha item codes palette blocks;
- high bit depth through libavif (:func:`encode_avif_hbd`, the recipe of
  ``tests/test_avif_native.py::_encode_avif_10bit`` with the depth, the
  layout and the quantizer as arguments): a 10-bit 4:2:0 and a 12-bit
  4:4:4 picture (:func:`hbd_planes`);
- quantizer matrices and film grain: 4:2:0 with libaom's still-image
  tuning (``tune=iq``, which turns quantizer matrices on; at quality 40,
  where its file is as large as the others at 60), 4:2:0 with
  libaom's film grain test vector 4 (auto-regressive lag 3, overlap on,
  nine scaling points a plane), and a 10-bit 4:4:4 picture through
  libavif with both (``enable-qm``, test vector 10).

Each entry of the JSON holds the file's name, the decoded width and
height, and the digest of the Y, U and V planes (then the alpha item's Y
plane) of libdav1d, read through the JAX package's
``avif_native._decode_obu``, which rounds a 10- or 12-bit picture to 8
bits; for those, ``sha256_samples`` is the digest of libdav1d's own
16-bit planes (little-endian), read with the reference's ``_PIC_*``
offsets (:func:`dav1d_samples`). The hashes are of libdav1d's output, not
the port's: the smoke phase holds the port to them, and
``tests/test_torch_avif_sources.py`` holds them to libdav1d.

Phase 28's five files (``python tests/fixtures/make_avif_sources.py
--pillow``, :data:`PILLOW_FILES`) are the AVIFs the reference hands to
Pillow: a 12 MP grid written by libavif's ``avifEncoderAddImageGrid``
and cropped (:func:`set_grid_output`), a 10-bit BT.2020 picture, a
lossless identity-matrix screenshot and a premultiplied cut-out
(:func:`encode_avif_hbd`), and a file whose nclx box is replaced by an
sRGB ICC profile (:func:`set_colr`). ``pillow_arrays.json`` holds the
SHA-256 of the array each decodes to through the JAX package's
``decode_bytes``, that is Pillow 12.1 with its bundled libavif 1.3.0:
the oracle of the port's decode (``codecs/avif_libavif.py``).

Which library writes what: Pillow (libavif 1.3.0 with libaom) the
phase-27 pictures it can write; the system's ``libavif.so.15`` (libavif
0.11.1 with libaom, through ctypes: :func:`encode_avif_hbd`,
:func:`encode_avif_grid`) the high-bit-depth, grid, alpha and re-tagged
files; :func:`demux` / :func:`mux` the container edits no writer makes
(no nclx, ``prem``, a second alpha item, cropped grids, hostile grids).
0.11.1 only writes: every decode these files are held to is Pillow's
1.3.0 (or libdav1d's, for the planes of phase 27).

Phase 27's superres files (``--superres``, :data:`SUPERRES`) are
written by the system's libaom 3 directly (:func:`encode_av1_libaom`,
ctypes with no headers), since no libavif here takes ``superres-mode``,
and wrapped by the port's container writer (:func:`av1_avif`): an 8-bit
4:2:0 picture at SuperresDenom 16 with CDEF and loop restoration, a
10-bit 4:4:4 one at 11 in 4 tile columns, and an 8-bit 4:2:0 one at 13
with film grain. Every entry of ``avif_planes.json`` records the
stream's ``superres_denom`` (8 without superres).

Phase 28's files of the last remainder (``--remainder``,
:data:`REMAINDER_FILES`, digests in ``remainder_arrays.json``): an item
coded at half its ``ispe``, the 12 MP grid with its cells coded at half
their ``ispe`` (libavif rescales both), a grid whose alpha is one item a
cell (:func:`per_cell_alpha`), and two streams of two spatial layers
spliced from libaom's key frames (:func:`layered_stream`), one with its
base at the full size (libdav1d's first picture: the reference's native
path) and one with its base at half size (libavif's highest layer).

Phase 29's files (``--inter``, :data:`INTER_FILES`, digests in
``inter_arrays.json``) have an INTER frame as their output frame: libaom's
GOOD usage through ctypes (:func:`inter_obu`) over a texture in motion
(:func:`moving_planes`), spliced into spatial layers (:func:`as_layers`):
two progressive files whose base key frame is coded at half size
(libaom's fixed resize mode), 8-bit 4:2:0 and 10-bit 4:4:4, a
three-layer file whose top frame uses compound prediction, and a hidden
key frame under the INTER frame it predicts (:func:`hidden_key_inter`,
the native path). :data:`INTER_CASES` are the small streams of
``tests/test_torch_av1_inter.py``, one a tool, and
:func:`dav1d_pictures` every picture libdav1d returns, their oracle.

Run from the repository root: ``python tests/fixtures/make_avif_sources.py``
(phase 27's files), with ``--superres`` (its superres files alone, the
others left as they are), ``--pillow`` (phase 28's), ``--remainder``
(phase 28's last files) or ``--inter`` (phase 29's).
"""

import ctypes
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "fixtures", "avif")
QUALITY = 60

#: name -> (picture seed, Pillow's keywords, alpha, nclx matrix re-tag)
RECIPES = {
    "1080p_420": (2701, {}, False, None),
    "1080p_444": (2702, {"subsampling": "4:4:4"}, False, None),
    "1080p_422": (2707, {"subsampling": "4:2:2"}, False, None),
    "1080p_rgba": (2703, {}, True, None),
    "1080p_bt709": (2704, {}, False, 1),
    "1080p_cdef": (2705, {"advanced": [("enable-cdef", "1")]}, False, None),
    "1080p_speed4_lr": (2706, {"speed": 4}, False, None),
    "1080p_qm": (2713, {"quality": 40, "advanced": [("tune", "iq")]}, False,
                 None),
    "1080p_grain": (2714, {"advanced": [("film-grain-test", "4")]}, False,
                    None),
}
#: the files whose frame headers must use quantizer matrices, film grain
#: (recorded as ``qmatrix`` / ``film_grain`` in each entry of the table)
QM_FILES = {"1080p_qm", "1080p_10bit_grain_444"}
GRAIN_FILES = {"1080p_grain", "1080p_10bit_grain_444"}
#: screen content: name -> (picture, seed, Pillow's keywords (none: its
#: defaults), alpha)
SCREEN = {
    "1080p_screenshot": ("ui_screenshot", 2708, {}, False),
    "1080p_logos": ("logo_sheet", 2709, {}, False),
    "1080p_rgba_logo": ("logo_sheet", 2710, {"quality": QUALITY}, True),
}
#: high bit depth through libavif: name -> (seed, depth, layout,
#: quantizer, speed, libaom's options): CDEF in the 10-bit file, loop
#: restoration (speed 4) in the 12-bit one
HBD = {
    "1080p_10bit_420": (2711, 10, "420", 24, 6, {"enable-cdef": "1"}),
    "1080p_12bit_444": (2712, 12, "444", 24, 4, None),
    "1080p_10bit_grain_444": (2715, 10, "444", 24, 6,
                              {"enable-qm": "1", "film-grain-test": "10"}),
}
#: superres through libaom (:func:`encode_av1_libaom`, ``--superres``):
#: name -> (seed, depth, layout, quantizer, SuperresDenom, speed, libaom's
#: options). Speed 4 turns loop restoration on (switchable and
#: self-guided in both files); the 10-bit file codes 4 tile columns.
SUPERRES = {
    "1080p_superres": (2716, 8, "420", 24, 16, 4, {"enable-cdef": 1}),
    "1080p_10bit_superres_444": (2717, 10, "444", 28, 11, 4,
                                 {"enable-cdef": 1, "tile-columns": 2}),
    "1080p_superres_grain": (2718, 8, "420", 24, 13, 6,
                             {"film-grain-test": 4}),
}


def glyphs(rng, n: int = 48, h: int = 12, w: int = 7) -> list:
    """A seeded 'font': ``n`` random glyph bitmaps of h x w."""
    out = []
    for _ in range(n):
        g = rng.random((h, w)) < 0.35
        g[:, 0] = False
        out.append(g)
    return out


def ui_screenshot(seed: int, w: int = 1920, h: int = 1080) -> np.ndarray:
    """A seeded desktop application window: title bar, a sidebar of
    icons, a toolbar of buttons and paragraphs of text set in one
    glyph set, and a photo-like panel (a gradient with noise)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 246, np.uint8)
    img[:44] = (48, 56, 74)
    img[44:96] = (232, 235, 240)
    img[96:, :280] = (238, 240, 244)
    icons = [rng.integers(40, 220, (28, 28, 3)).astype(np.uint8)
             for _ in range(6)]
    for i, y in enumerate(range(120, h - 40, 52)):
        img[y:y + 28, 24:52] = icons[i % len(icons)]
        img[y + 8:y + 20, 64:64 + 8 * int(rng.integers(8, 22))] = (90, 96, 110)
    for x in range(300, w - 200, 160):
        img[56:84, x:x + 140] = (66, 133, 244) if x % 320 == 300 else (
            255, 255, 255)
        img[56:84, x:x + 1] = img[56:84, x + 139:x + 140] = (160, 168, 180)
    font = glyphs(rng)
    ink = np.array([(32, 33, 36), (26, 115, 232), (60, 64, 67)], np.uint8)
    y = 120
    while y < h - 30:
        color = ink[int(rng.integers(0, 3))]
        x = 310
        end = int(rng.integers(900, w - 440))
        while x < end:
            for _ in range(int(rng.integers(2, 10))):
                g = font[int(rng.integers(0, len(font)))]
                img[y:y + 12, x:x + 7][g] = color
                x += 8
            x += 8
        y += 22 if rng.random() < 0.85 else 44
    # a photo panel, natural content beside the flat regions
    py, px = np.mgrid[0:300, 0:400]
    photo = np.stack([px * 0.5 + 40, py * 0.6 + 60, (px + py) * 0.3 + 30], -1)
    photo += rng.normal(0, 10, photo.shape)
    img[700:1000, 1480:1880] = np.clip(photo, 0, 255).astype(np.uint8)
    return img


def logo_sheet(seed: int, w: int = 1920, h: int = 1080) -> np.ndarray:
    """A seeded sheet of flat logos on white: a few marks (discs,
    bars, rings in two or three colours) repeated on a grid, some with a
    word under them."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:120, 0:120]
    r = np.hypot(yy - 60, xx - 60)
    marks = []
    for _ in range(5):
        c1, c2, c3 = (rng.integers(0, 256, 3).astype(np.uint8)
                      for _ in range(3))
        m = np.full((120, 120, 3), 255, np.uint8)
        kind = int(rng.integers(0, 3))
        if kind == 0:
            m[r < 50] = c1
            m[r < 26] = c2
        elif kind == 1:
            m[20:100, 20:100] = c1
            m[44:76, 10:110] = c2
        else:
            m[(r < 52) & (r > 36)] = c1
            m[50:70, 30:90] = c3
        marks.append(m)
    font = glyphs(rng, 30)
    for gy in range(20, h - 150, 170):
        for gx in range(20, w - 130, 150):
            m = marks[int(rng.integers(0, len(marks)))]
            img[gy:gy + 120, gx:gx + 120] = m
            if rng.random() < 0.6:
                x = gx + 10
                for _ in range(int(rng.integers(4, 12))):
                    g = font[int(rng.integers(0, len(font)))]
                    img[gy + 128:gy + 140, x:x + 7][g] = (40, 40, 40)
                    x += 8
    return img


def hbd_planes(seed: int, depth: int, layout: str):
    """``chip_smoke.synth_image``'s picture at ``depth`` bits, BT.601
    limited range (the matrix ``encode_avif_hbd`` tags), chroma averaged
    to the layout's grid, with a fine ramp that uses the low bits."""
    import chip_smoke

    rgb = chip_smoke.synth_image(seed).astype(np.float64) / 255.0
    h, w = rgb.shape[:2]
    rgb += (np.arange(w)[None, :, None] % 16) / (255.0 * 16)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) / 1.772
    cr = (r - y) / 1.402
    if layout == "420":
        cb = cb.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        cr = cr.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    s = 1 << (depth - 8)
    top = (1 << depth) - 1

    def q(v, off, scale):
        return np.clip(np.round((off + v * scale) * s), 0, top).astype(
            np.uint16)

    return q(y, 16, 219), q(cb, 128, 224), q(cr, 128, 224)


def _avif_lib():
    """libavif.so.15 (the system's 0.11.1, a writer only here) with the
    signatures this module calls, or None where it is not installed."""
    try:
        lib = ctypes.CDLL("libavif.so.15")
    except OSError:
        return None
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    lib.avifEncoderCreate.restype = ctypes.c_void_p
    lib.avifEncoderDestroy.argtypes = [ctypes.c_void_p]
    lib.avifEncoderSetCodecSpecificOption.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.avifEncoderWrite.restype = ctypes.c_int
    lib.avifEncoderWrite.argtypes = [ctypes.c_void_p] * 3
    lib.avifEncoderAddImageGrid.restype = ctypes.c_int
    lib.avifEncoderAddImageGrid.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32]
    lib.avifEncoderFinish.restype = ctypes.c_int
    lib.avifEncoderFinish.argtypes = [ctypes.c_void_p] * 2
    lib.avifRWDataFree.argtypes = [ctypes.c_void_p]
    return lib


class _RW(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]


def _avif_image(lib, y, u, v, depth: int, layout: str, alpha=None,
                cicp=(1, 13, 6), full_range: bool = False,
                premultiplied: bool = False):
    """An ``avifImage`` of libavif 0.11.1 holding the planes, at the ABI
    offsets of ``avifImage``: yuvRange at 16, the Y/U/V plane pointers at
    24 and their row bytes at 48, the alpha plane at 64 and its row bytes
    at 72, alphaPremultiplied at 80, colour primaries, transfer and matrix
    (uint16) at 104, 106, 108. None where the planes do not allocate."""
    h, w = y.shape
    img = lib.avifImageCreate(w, h, depth, {"444": 1, "422": 2, "420": 3,
                                            "400": 4}[layout])
    ctypes.c_int32.from_address(img + 16).value = int(full_range)
    for off, val in zip((104, 106, 108), cicp):
        ctypes.c_uint16.from_address(img + off).value = val
    # AVIF_PLANES_YUV = 1, AVIF_PLANES_ALL = 0xff
    if lib.avifImageAllocatePlanes(img, 1 if alpha is None else 0xFF) != 0:
        lib.avifImageDestroy(img)
        return None
    ctypes.c_int32.from_address(img + 80).value = int(premultiplied)
    planes = (ctypes.c_void_p * 3).from_address(img + 24)
    rb = (ctypes.c_uint32 * 3).from_address(img + 48)
    dst = [(planes[i], rb[i], arr) for i, arr in
           ((0, y), (1, u), (2, v))[:1 if layout == "400" else 3]]
    if alpha is not None:
        dst.append((ctypes.c_void_p.from_address(img + 64).value,
                    ctypes.c_uint32.from_address(img + 72).value, alpha))
    size = 1 if depth == 8 else 2
    for addr, rowb, arr in dst:
        src = np.ascontiguousarray(arr, np.uint8 if size == 1 else np.uint16)
        ph, pw = src.shape
        for row in range(ph):
            ctypes.memmove(addr + row * rowb,
                           src.ctypes.data + row * pw * size, pw * size)
    return img


def _encoder(lib, quantizer: int, speed: int, options,
             alpha_quantizer=None):
    """An ``avifEncoder``: maxThreads at 4, speed at 8, min and max
    quantizer at 24 and 28, alpha's at 32 and 36; ``options`` libaom's
    codec-specific keys."""
    enc = lib.avifEncoderCreate()
    aq = quantizer if alpha_quantizer is None else alpha_quantizer
    for off, val in ((4, 1), (8, speed), (24, quantizer), (28, quantizer),
                     (32, aq), (36, aq)):
        ctypes.c_int32.from_address(enc + off).value = val
    for key, val in (options or {}).items():
        lib.avifEncoderSetCodecSpecificOption(enc, key.encode(),
                                              val.encode())
    return enc


def encode_avif_hbd(y, u, v, depth: int, layout: str, quantizer: int,
                    speed: int = 8, options=None, alpha=None,
                    cicp=(1, 13, 6), full_range: bool = False,
                    premultiplied: bool = False):
    """An AVIF through libavif's C API (libaom inside), over the pinned
    ABI of ``tests/test_avif_native.py::_encode_avif_10bit``: ``layout``
    "420", "422", "444" or "400" (monochrome: ``u`` and ``v`` unused),
    ``depth`` 8 (uint8 rows), 10 or 12, ``quantizer`` 0..63 for both
    bounds, ``options`` libaom's codec-specific keys; ``alpha`` a plane
    at the picture's depth (``premultiplied`` writes libavif's ``prem``
    reference), ``cicp`` the (primaries, transfer, matrix) of the nclx box
    and the sequence header, limited range unless ``full_range``. None
    where libavif is not installed. libaom refuses the identity matrix
    on a subsampled layout (an assertion that ends the process):
    re-tag such a file with :func:`retag_matrix`."""
    lib = _avif_lib()
    if lib is None:
        return None
    if cicp[2] == 0 and layout not in ("444", "400"):
        raise ValueError("libaom writes the identity matrix in 4:4:4 only")
    img = _avif_image(lib, y, u, v, depth, layout, alpha, cicp, full_range,
                      premultiplied)
    if img is None:
        return None
    enc = None
    try:
        enc = _encoder(lib, quantizer, speed, options)
        out = _RW()
        if lib.avifEncoderWrite(enc, img, ctypes.byref(out)) != 0:
            return None
        data = ctypes.string_at(out.data, out.size)
        lib.avifRWDataFree(ctypes.byref(out))
        return data
    finally:
        if enc:
            lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)


def encode_avif_grid(cells, cols: int, rows: int, depth: int, layout: str,
                     quantizer: int, speed: int = 8, alpha_cells=None,
                     cicp=(1, 13, 6), full_range: bool = False,
                     premultiplied: bool = False, options=None):
    """A grid AVIF through libavif's ``avifEncoderAddImageGrid``: ``cells``
    the (y, u, v) planes of each cell in raster order, all of one size
    (libavif 0.11.1 sets the canvas to the cells' whole area; crop it
    with :func:`set_grid_output`), ``alpha_cells`` their alpha planes
    (an alpha grid beside the colour grid). None where libavif is not
    installed or refuses the grid."""
    lib = _avif_lib()
    if lib is None:
        return None
    imgs = []
    enc = None
    try:
        for i, (y, u, v) in enumerate(cells):
            a = None if alpha_cells is None else alpha_cells[i]
            img = _avif_image(lib, y, u, v, depth, layout, a, cicp,
                              full_range, premultiplied)
            if img is None:
                return None
            imgs.append(img)
        enc = _encoder(lib, quantizer, speed, options)
        arr = (ctypes.c_void_p * len(imgs))(*imgs)
        # AVIF_ADD_IMAGE_FLAG_SINGLE
        if lib.avifEncoderAddImageGrid(enc, cols, rows, arr, 2) != 0:
            return None
        out = _RW()
        if lib.avifEncoderFinish(enc, ctypes.byref(out)) != 0:
            return None
        data = ctypes.string_at(out.data, out.size)
        lib.avifRWDataFree(ctypes.byref(out))
        return data
    finally:
        if enc:
            lib.avifEncoderDestroy(enc)
        for img in imgs:
            lib.avifImageDestroy(img)


#: libaom 3's ABI, read off its headers' layout (no headers are needed):
#: the ALL_INTRA usage, the encoder ABI version ``aom_codec_enc_init_ver``
#: checks, the flag for 16-bit images, and the planar image formats
#: (``AOM_IMG_FMT_HIGHBITDEPTH`` added for 16-bit samples)
_AOM_USAGE_GOOD_QUALITY, _AOM_USAGE_ALL_INTRA = 0, 2
_AOM_ENCODER_ABI_VERSION = 25
_AOM_CODEC_USE_HIGHBITDEPTH = 0x40000
_AOM_IMG_FMT = {"420": 0x102, "400": 0x102, "422": 0x105, "444": 0x106}
_AOM_IMG_FMT_HIGHBITDEPTH = 0x800
#: indices of ``aom_codec_enc_cfg_t`` read as uint32
_CFG = {"g_profile": 2, "g_w": 3, "g_h": 4, "g_limit": 5, "g_bit_depth": 8,
        "g_input_bit_depth": 9, "rc_resize_mode": 16,
        "rc_resize_denominator": 17, "rc_resize_kf_denominator": 18,
        "rc_superres_mode": 19,
        "rc_superres_denominator": 20, "rc_superres_kf_denominator": 21,
        "rc_min_quantizer": 35, "rc_max_quantizer": 36, "monochrome": 52}


def moving_planes(w: int, h: int, depth: int, layout: str, seed: int,
                  frames: int, shift=(0.0, 0.0), zoom: float = 1.0,
                  turn: float = 0.0):
    """``frames`` pictures of one texture that moves: frame k samples it at
    the points of frame 0 shifted by k * ``shift`` (x, y) pixels, scaled
    by ``zoom`` ** k and turned by k * ``turn`` degrees about the centre.
    The texture is a function of the position (waves, a grid of soft
    discs and hard-edged bars, seeded), so each frame is drawn exactly,
    not resampled. -> [(y, u, v)] at ``depth`` (uint8 or uint16), chroma
    at the ``layout``'s size."""
    rng = np.random.default_rng(seed)
    waves = rng.uniform(-1, 1, (6, 4))
    discs = rng.uniform(0, 1, (24, 3))
    top = (1 << depth) - 1
    sx, sy = {"420": (2, 2), "422": (2, 1), "444": (1, 1),
              "400": (2, 2)}[layout]

    def texture(x, y):
        v = np.zeros_like(x)
        for a, b, c, d in waves:
            v += 0.15 * np.sin((a * x + b * y) * 0.35 + 6 * c) * (0.6 + 0.4 * d)
        for cx, cy, r in discs:
            dd = np.hypot(x - cx * w, y - cy * h) / (4 + 10 * r)
            v += 0.5 * np.exp(-dd * dd)
        v += 0.3 * (np.floor(x / 11 + np.floor(y / 9)) % 2)
        return v

    out = []
    for k in range(frames):
        ang = np.deg2rad(turn * k)
        z = zoom ** k
        cos, sin = np.cos(ang) / z, np.sin(ang) / z

        def sample(ww, hh, step_x, step_y, phase):
            yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float64)
            xx = xx * step_x + (step_x - 1) / 2 - w / 2
            yy = yy * step_y + (step_y - 1) / 2 - h / 2
            px = cos * xx - sin * yy + w / 2 + shift[0] * k
            py = sin * xx + cos * yy + h / 2 + shift[1] * k
            t = texture(px + phase, py - phase)
            return np.clip(np.round((0.2 + 0.6 * t / 1.6) * top), 0,
                           top).astype(np.uint8 if depth == 8 else np.uint16)

        yp = sample(w, h, 1, 1, 0.0)
        cw, ch = -(-w // sx), -(-h // sy)
        out.append((yp, sample(cw, ch, sx, sy, 7.0),
                    sample(cw, ch, sx, sy, -5.0)))
    return out


def _aom_lib():
    """The system's ``libaom.so.3`` with the signatures this module calls,
    or None where it is not installed."""
    try:
        lib = ctypes.CDLL("libaom.so.3")
    except OSError:
        return None
    lib.aom_codec_av1_cx.restype = ctypes.c_void_p
    lib.aom_codec_enc_config_default.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int]
    lib.aom_codec_set_option.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
    lib.aom_codec_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_ulong,
                                     ctypes.c_long]
    lib.aom_codec_get_cx_data.restype = ctypes.c_void_p
    lib.aom_codec_get_cx_data.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
    lib.aom_img_alloc.restype = ctypes.c_void_p
    lib.aom_img_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]
    lib.aom_img_free.argtypes = [ctypes.c_void_p]
    return lib


def _obus(stream: bytes):
    """(type, whole OBU bytes) of a stream of OBUs that carry their size."""
    i = 0
    while i < len(stream):
        head = stream[i]
        j = i + (2 if head & 4 else 1)
        size, shift = 0, 0
        while True:
            size |= (stream[j] & 0x7F) << shift
            shift += 7
            j += 1
            if not stream[j - 1] & 0x80:
                break
        yield head >> 3 & 15, stream[i:j + size]
        i = j + size


def encode_av1_libaom(y, u, v, depth: int, layout: str, quantizer: int,
                      superres_denom: int = 8, speed: int = 6, options=None,
                      limit: int = 1, forced_max=None, frames: int = 1,
                      good: bool = False, later=(), resize_denom: int = 8,
                      resize_kf_denom: int = 8, lag: int = 0):
    """An AV1 still (sequence header and one key frame, the temporal
    delimiter dropped) of the planes, written by the system's libaom 3
    through ctypes with no headers: the ALL_INTRA usage with ``g_limit``
    1, as libavif writes an AVIF item (a reduced still-picture header).
    ``layout`` "420", "422", "444" or "400" (monochrome: ``u`` and ``v``
    unused); ``depth`` 8 (uint8 planes), 10 or 12 (uint16, through
    ``AOM_CODEC_USE_HIGHBITDEPTH`` and a 16-bit image); ``quantizer``
    0..63 for both bounds; ``superres_denom`` 9..16 codes the frame at
    width * 8 / superres_denom (``rc_superres_mode`` 1, fixed, for key
    frames too), 8 leaves superres off; ``options`` libaom's keys by name
    (``tile-columns``, ``enable-cdef``, ``enable-restoration``,
    ``film-grain-test``, ...), ``cpu-used`` from ``speed``. Neither
    Pillow's libavif nor the system's takes ``superres-mode``, so this is
    how superres files are made. ``limit`` > 1 writes a full sequence
    header (not a still picture), which the splices below need;
    ``forced_max`` (width, height) sets the sequence header's largest frame
    size, so a smaller picture codes its own (frame_size_override_flag);
    ``frames`` submits the picture that many times, and ``good`` takes
    libaom's GOOD usage with no lag, whose frames after the first are INTER
    frames; ``later`` are the (y, u, v) planes of the last frames (content
    that moves: they take the place of the picture's repeats);
    ``lag`` frames of look-ahead (GOOD usage) let libaom code hidden
    alt-ref frames, shown later by show_existing_frame, and predict from
    both sides; ``resize_denom`` and ``resize_kf_denom`` (9..16) turn libaom's fixed
    resize mode on, which codes inter and key frames at width and height *
    8 / denominator (a key frame at half size and its inter frames at the
    full size are the progressive layout of a downscaled base). None where
    libaom is not installed.
    libaom asserts and ends the process on a lossless request with
    superres (quantizer 0 for both bounds): ask for quantizer bounds of
    (0, 1) with ``cq-level`` 0 instead, which codes the frame at
    base_q_idx 0 without the request."""
    lib = _aom_lib()
    if lib is None:
        return None
    h, w = y.shape
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    cfg = (ctypes.c_uint32 * 1024)()  # the struct is about 1.4 kB
    if lib.aom_codec_enc_config_default(
            iface, cfg, _AOM_USAGE_GOOD_QUALITY if good
            else _AOM_USAGE_ALL_INTRA):
        return None
    profile = 2 if depth == 12 or layout == "422" else int(layout == "444")
    lo, hi = quantizer if isinstance(quantizer, tuple) else (quantizer,) * 2
    for key, val in (("g_profile", profile), ("g_w", w), ("g_h", h),
                     ("g_limit", limit), ("g_bit_depth", depth),
                     ("g_input_bit_depth", depth),
                     ("rc_superres_mode", int(superres_denom != 8)),
                     ("rc_superres_denominator", superres_denom),
                     ("rc_superres_kf_denominator", superres_denom),
                     ("rc_resize_mode",
                      int(resize_denom != 8 or resize_kf_denom != 8)),
                     ("rc_resize_denominator", resize_denom),
                     ("rc_resize_kf_denominator", resize_kf_denom),
                     ("rc_min_quantizer", lo), ("rc_max_quantizer", hi),
                     ("monochrome", int(layout == "400"))):
        cfg[_CFG[key]] = val
    if forced_max is not None:
        cfg[6], cfg[7] = forced_max  # g_forced_max_frame_width / height
    if good:
        cfg[14] = lag  # g_lag_in_frames (0: each frame coded as it comes)
    ctx = ctypes.create_string_buffer(256)
    hbd = depth > 8
    if lib.aom_codec_enc_init_ver(ctx, iface, cfg,
                                  _AOM_CODEC_USE_HIGHBITDEPTH if hbd else 0,
                                  _AOM_ENCODER_ABI_VERSION):
        return None
    img = None
    try:
        for key, val in {"cpu-used": str(speed), **(options or {})}.items():
            if lib.aom_codec_set_option(ctx, key.encode(), str(val).encode()):
                raise ValueError(f"libaom refuses {key}={val}")
        fmt = _AOM_IMG_FMT[layout] | (_AOM_IMG_FMT_HIGHBITDEPTH if hbd else 0)
        img = lib.aom_img_alloc(None, fmt, w, h, 16)
        planes = (ctypes.c_void_p * 3).from_address(img + 64)
        strides = (ctypes.c_int * 3).from_address(img + 88)

        def put(y, u, v):
            if layout == "400":
                mid = 1 << (depth - 1)
                u = v = np.full(((h + 1) // 2, (w + 1) // 2), mid,
                                np.uint16 if hbd else np.uint8)
            for i, arr in enumerate((y, u, v)):
                src = np.ascontiguousarray(arr, np.uint16 if hbd else np.uint8)
                for row in range(src.shape[0]):
                    ctypes.memmove(planes[i] + row * strides[i],
                                   src.ctypes.data + row * src.strides[0],
                                   src.shape[1] * src.itemsize)

        pictures = [(y, u, v)] * (frames - len(later)) + list(later)
        out = b""
        # then flush, once a frame of look-ahead more
        for pts in range(len(pictures) + 1 + (lag if good else 0)):
            frame = None
            if pts < len(pictures):
                put(*pictures[pts])
                frame = img
            if lib.aom_codec_encode(ctx, frame, pts, 1, 0):
                return None
            it = ctypes.c_void_p()
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if ctypes.c_int.from_address(pkt).value == 0:  # a frame
                    buf = ctypes.c_void_p.from_address(pkt + 8).value
                    n = ctypes.c_size_t.from_address(pkt + 16).value
                    out += ctypes.string_at(buf, n)
        return b"".join(o for t, o in _obus(out) if t != 2)
    finally:
        if img:
            lib.aom_img_free(img)
        lib.aom_codec_destroy(ctx)


# -- inter frames ---------------------------------------------------------------


def inter_obu(w: int, h: int, depth: int, layout: str, seed: int,
              frames: int, quantizer: int = 30, speed: int = 6,
              options=None, lag: int = 0, resize_kf_denom: int = 8,
              superres_denom: int = 8, shift=(0.0, 0.0), zoom: float = 1.0,
              turn: float = 0.0):
    """A stream of ``frames`` frames of :func:`moving_planes`' texture in
    motion, by libaom's GOOD usage (:func:`encode_av1_libaom`): a key
    frame, then INTER frames predicted from it and from each other, 64 x 64
    superblocks; ``resize_kf_denom`` 16 codes the key frame at half size
    (libaom's fixed resize mode), so the inter frames predict across
    sizes; ``options`` are libaom's keys (``enable-obmc``,
    ``enable-warped-motion``, ``enable-global-motion``,
    ``enable-dual-filter``, ``enable-interintra-comp``,
    ``enable-masked-comp``, ``enable-dist-wtd-comp``,
    ``enable-onesided-comp``, ``enable-ref-frame-mvs``, ...)."""
    pics = moving_planes(w, h, depth, layout, seed, frames, shift, zoom, turn)
    return encode_av1_libaom(
        *pics[0], depth, layout, quantizer, superres_denom=superres_denom,
        speed=speed, options={"sb-size": "64", **(options or {})},
        limit=max(2, frames), frames=frames, good=True, later=pics[1:],
        lag=lag, resize_kf_denom=resize_kf_denom)


def as_layers(obu: bytes) -> bytes:
    """The frames of a stream (at most four) as spatial layers 0, 1, ...
    of one temporal unit, under its sequence header with operating points
    of all of them, then of one fewer, and so on: a progressive AVIF's
    layout, whose highest layer libavif returns."""
    seq = next(o for t, o in _obus(obu) if t == 1)
    frames = [o for t, o in _obus(obu) if t in (3, 4, 6)]
    n = len(frames)
    if not 2 <= n <= 4:
        raise ValueError("two to four frames make layers")
    idcs = [((1 << k) - 1) << 8 | 1 for k in range(n, 0, -1)]
    return with_operating_points(seq, idcs) + b"".join(
        with_layer(f, 0, i) for i, f in enumerate(frames))


#: the streams of ``tests/test_torch_av1_inter.py``: name -> (the
#: arguments of :func:`inter_obu`, the inter tools (``av1_dec_abi.TOOLS``)
#: the stream must use). Each is 64..192 px, its frames spliced into
#: layers (:func:`as_layers`) or, past four frames, decoded whole.
INTER_CASES = {
    "shift_8bit_420": (dict(w=96, h=64, depth=8, layout="420", seed=1,
                            frames=2, shift=(2.3, -1.6)), ("newmv",)),
    "shift_10bit_444": (dict(w=96, h=64, depth=10, layout="444", seed=2,
                             frames=2, shift=(1.7, 0.9)), ("newmv",)),
    "shift_12bit_422": (dict(w=96, h=64, depth=12, layout="422", seed=3,
                             frames=2, shift=(-1.2, 2.1)), ("local_warp",)),
    "mono": (dict(w=96, h=64, depth=8, layout="400", seed=6, frames=2,
                  shift=(3.1, 0.4)), ("newmv",)),
    "zoom_local_warp": (dict(w=128, h=96, depth=8, layout="420", seed=4,
                             frames=2, zoom=1.04), ("local_warp",)),
    "turn_local_warp": (dict(w=128, h=96, depth=8, layout="420", seed=5,
                             frames=2, turn=3.0), ("local_warp",)),
    "global_motion": (dict(w=160, h=128, depth=8, layout="420", seed=14,
                           frames=2, zoom=1.05, turn=2.0, speed=2,
                           options={"enable-global-motion": 1,
                                    "enable-warped-motion": 0}),
                      ("global_warp", "globalmv", "obmc")),
    "dual_filter": (dict(w=192, h=128, depth=8, layout="420", seed=23,
                         frames=3, quantizer=20, speed=1, shift=(1.37, 2.71),
                         options={"enable-dual-filter": 1}),
                    ("dual_filter", "switchable_filter")),
    "obmc_compound": (dict(w=192, h=128, depth=8, layout="420", seed=21,
                           frames=3, quantizer=40, speed=1, shift=(3.3, 1.7),
                           turn=1.0, options={"enable-warped-motion": 0}),
                      ("obmc", "compound", "compound_distance",
                       "compound_wedge", "interintra")),
    "interintra_diffwtd": (dict(w=192, h=128, depth=8, layout="420",
                                seed=22, frames=3, quantizer=40, speed=1,
                                shift=(2.2, 1.3), zoom=1.02,
                                options={"enable-interintra-comp": 1,
                                         "enable-warped-motion": 0,
                                         "enable-obmc": 0}),
                           ("interintra", "wedge_interintra",
                            "compound_diffwtd")),
    "ref_frame_mvs": (dict(w=128, h=96, depth=8, layout="420", seed=16,
                           frames=4, shift=(2.1, 1.1),
                           options={"enable-ref-frame-mvs": 1}),
                      ("temporal_mv",)),
    "skip_mode": (dict(w=128, h=96, depth=8, layout="420", seed=52,
                       frames=6, quantizer=45, speed=0, shift=(0.5, 0.25)),
                  ("skip_mode", "compound")),
    "half_size_base": (dict(w=128, h=96, depth=8, layout="420", seed=17,
                            frames=2, shift=(1.5, 0.5), resize_kf_denom=16),
                       ("scaled",)),
    "half_size_base_10bit_444": (dict(w=128, h=96, depth=10, layout="444",
                                      seed=20, frames=2, shift=(1.5, 0.5),
                                      resize_kf_denom=16), ("scaled",)),
    "superres_reference": (dict(w=128, h=96, depth=8, layout="420",
                                seed=36, frames=3, superres_denom=12,
                                shift=(1.0, 2.0)), ("scaled",)),
    "tiles": (dict(w=192, h=128, depth=8, layout="420", seed=18, frames=2,
                   shift=(2.5, -1.5),
                   options={"tile-columns": 1, "tile-rows": 1}),
              ("inter", "newmv")),
    "film_grain": (dict(w=96, h=64, depth=8, layout="420", seed=19,
                        frames=2, shift=(1.5, 0.5),
                        options={"film-grain-test": 4}), ("inter",)),
    "twelve_bit_chain": (dict(w=96, h=64, depth=12, layout="444", seed=33,
                              frames=7, shift=(1.1, -0.6), zoom=1.01),
                         ("temporal_mv", "local_warp")),
}


# -- OBU splicing: layered streams and hidden key frames ----------------------


def _bits(payload: bytes) -> str:
    """An OBU payload's bits before its trailing one bit."""
    b = "".join(f"{x:08b}" for x in payload)
    return b[:b.rindex("1")]


def obu_of(typ: int, bits: str, layer=None) -> bytes:
    """An OBU of ``typ`` carrying ``bits`` then its trailing bits, with its
    size, and with an extension header of (temporal_id, spatial_id) where
    ``layer`` gives one."""
    bits += "1" + "0" * ((-len(bits) - 1) % 8)
    payload = int(bits, 2).to_bytes(len(bits) // 8, "big")
    head = bytes([typ << 3 | 2 | (4 if layer is not None else 0)])
    if layer is not None:
        head += bytes([layer[0] << 5 | layer[1] << 3])
    n, size = len(payload), b""
    while True:
        size += bytes([(n & 0x7F) | (0x80 if n > 0x7F else 0)])
        n >>= 7
        if not n:
            break
    return head + size + payload


def _payload(obu: bytes) -> bytes:
    j = 2 if obu[0] & 4 else 1
    while obu[j] & 0x80:
        j += 1
    return obu[j + 1:]


def with_layer(obu: bytes, temporal_id: int, spatial_id: int) -> bytes:
    """An OBU with an extension header naming its layer (its size field
    counts the payload alone, so it stays)."""
    if obu[0] & 4:
        raise ValueError("the OBU has an extension already")
    return bytes([obu[0] | 4, temporal_id << 5 | spatial_id << 3]) + obu[1:]


class SeqFields:
    """The fields of a full (not reduced) sequence header (spec 5.5) that
    the splices below need, and where its operating points lie."""

    def __init__(self, payload: bytes):
        self.bits = _bits(payload)
        self.pos = 0
        f = self.f
        self.profile = f(3)
        f(1)
        if f(1):
            raise ValueError("a reduced still-picture header")
        if f(1) or f(1):
            raise ValueError("timing or display-delay info: not spliced here")
        self.op_at = self.pos
        self.levels = []
        for _ in range(f(5) + 1):
            f(12)
            self.levels.append(f(5))
            if self.levels[-1] > 7:
                f(1)
        self.op_end = self.pos
        self.wbits, self.hbits = f(4) + 1, f(4) + 1
        f(self.wbits)
        f(self.hbits)
        self.frame_ids = f(1)
        if self.frame_ids:
            raise ValueError("frame ids: not spliced here")
        f(3)   # 128x128 superblocks, filter intra, intra edge
        f(4)   # interintra, masked compound, warped motion, dual filter
        self.order_hint = f(1)
        if self.order_hint:
            f(2)
        self.force_sct = 2 if f(1) else f(1)
        self.force_integer_mv = 2
        if self.force_sct > 0:
            self.force_integer_mv = 2 if f(1) else f(1)
        self.order_hint_bits = f(3) + 1 if self.order_hint else 0

    def f(self, n: int) -> int:
        v = int(self.bits[self.pos:self.pos + n] or "0", 2)
        self.pos += n
        return v


def with_operating_points(seq_obu: bytes, idcs) -> bytes:
    """The sequence header with operating points of these
    operating_point_idc values, each at the first point's level."""
    s = SeqFields(_payload(seq_obu))
    ops = f"{len(idcs) - 1:05b}"
    for idc in idcs:
        ops += f"{idc:012b}{s.levels[0]:05b}" + ("0" if s.levels[0] > 7
                                                  else "")
    return obu_of(1, s.bits[:s.op_at] + ops + s.bits[s.op_end:])


def layered_stream(base: bytes, top: bytes, idcs=(0x301, 0x101)) -> bytes:
    """A stream of two spatial layers of one temporal unit: ``base``'s
    frame as spatial layer 0 and ``top``'s as layer 1, under ``top``'s
    sequence header with operating points ``idcs`` (by default point 0
    decodes both layers, point 1 the base alone). Both streams must be
    written with full sequence headers that agree but for their levels
    (:func:`encode_av1_libaom` with ``limit`` 2 and the same
    ``forced_max``): a base of another size then codes its own."""
    bseq = next(o for t, o in _obus(base) if t == 1)
    tseq = next(o for t, o in _obus(top) if t == 1)
    sb, st = SeqFields(_payload(bseq)), SeqFields(_payload(tseq))
    if sb.bits[sb.op_end:] != st.bits[st.op_end:]:
        raise ValueError("the layers' sequence headers differ")
    frames = [with_layer(o, 0, 0) for t, o in _obus(base) if t in (3, 4, 6)]
    frames += [with_layer(o, 0, 1) for t, o in _obus(top) if t in (3, 4, 6)]
    return with_operating_points(tseq, idcs) + b"".join(frames)


def hidden_key_stream(stream: bytes) -> bytes:
    """``stream``'s key frame made a hidden one (show_frame 0,
    showable_frame 1, error resilient, refreshing every slot), then shown
    by a show_existing_frame header of slot 0: one temporal unit whose
    output frame is the same picture. ``stream`` must carry a full
    sequence header and its frame header in an OBU of its own
    (:func:`encode_av1_libaom` with ``limit`` 2 and libaom's
    ``num-tile-groups`` 2)."""
    obus = list(_obus(stream))
    seq = next(o for t, o in obus if t == 1)
    at = next(i for i, (t, _) in enumerate(obus) if t == 3)
    show = "1" + "000"  # show_existing_frame of slot 0
    return b"".join([seq, _hidden_key(seq, obus[at][1])]
                    + [o for t, o in obus[at + 1:] if t == 4]
                    + [obu_of(3, show)])


def _hidden_key(seq: bytes, header: bytes) -> bytes:
    """A shown KEY_FRAME's frame header OBU made a hidden one (show_frame 0,
    showable_frame 1, error resilient, refresh_frame_flags 0xFF)."""
    s = SeqFields(_payload(seq))
    h = _bits(_payload(header))
    if h[:4] != "0001":
        raise ValueError("not a shown KEY_FRAME header")
    pos = 4
    pos += 1  # disable_cdf_update
    allow_sct = int(h[pos]) if s.force_sct == 2 else s.force_sct
    pos += s.force_sct == 2
    pos += allow_sct and s.force_integer_mv == 2
    pos += 1  # frame_size_override_flag
    pos += s.order_hint_bits
    return obu_of(3, "0000" + "11" + h[4:pos] + "11111111" + h[pos:])


def hidden_key_inter(stream: bytes) -> bytes:
    """``stream``'s key frame made a hidden one (:func:`_hidden_key`), the
    frames after it kept: one temporal unit whose first shown frame, the
    picture libdav1d returns first, is the INTER frame that follows (the
    reference's native path then serves an inter frame). ``stream`` must
    carry its frame headers in OBUs of their own (libaom's
    ``num-tile-groups`` 2)."""
    obus = list(_obus(stream))
    seq = next(o for t, o in obus if t == 1)
    at = next(i for i, (t, _) in enumerate(obus) if t == 3)
    return b"".join([seq, _hidden_key(seq, obus[at][1])]
                    + [o for t, o in obus[at + 1:] if t != 1])


def av1_avif(obu: bytes, w: int, h: int, depth: int, layout: str,
             cicp=(1, 13, 6), full_range: bool = False) -> bytes:
    """An AVIF file around an AV1 still: the port's first-party container
    (``codecs/av1_container.py::write_avif``) with the sequence header in
    ``av1C`` and its profile, depth and subsampling bits, and ``pixi``'s
    depth, set to the stream's."""
    from imagekit_tpu_torch.codecs.av1_container import write_avif

    seq = next(o for t, o in _obus(obu) if t == 1)
    data = bytearray(write_avif(obu, w, h, seq_obu=seq, mono=layout == "400",
                                cicp=cicp, full_range=full_range))
    profile = 2 if depth == 12 or layout == "422" else int(layout == "444")
    ssx, ssy = {"420": (1, 1), "400": (1, 1), "422": (1, 0),
                "444": (0, 0)}[layout]
    at = data.find(b"av1C") + 4
    data[at + 1] = (profile << 5) | (data[at + 1] & 31)
    data[at + 2] = (int(depth > 8) << 6 | int(depth == 12) << 5
                    | int(layout == "400") << 4 | ssx << 3 | ssy << 2)
    at = data.find(b"pixi") + 8
    for i in range(data[at]):
        data[at + 1 + i] = depth
    return bytes(data)


# -- the container, item by item --------------------------------------------------


def _boxes(data: bytes, start: int, end: int):
    i = start
    while i + 8 <= end:
        size = int.from_bytes(data[i:i + 4], "big")
        hdr = 8
        if size == 1:
            size = int.from_bytes(data[i + 8:i + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - i
        yield data[i + 4:i + 8], i + hdr, i + size
        i += size


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, version: int = 0,
          flags: int = 0) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def demux(data: bytes) -> dict:
    """A still AVIF as editable items: ``{"ftyp": bytes, "primary": id,
    "items": [{"id", "type", "name", "payload", "props": [(box bytes,
    essential)]}], "refs": [(type, from id, [to ids])]}`` in the file's
    order (iloc extents read with construction methods 0 and 1)."""
    top = {t: (a, b) for t, a, b in _boxes(data, 0, len(data))}
    ma, mb = top[b"meta"]
    meta = {t: (a, b) for t, a, b in _boxes(data, ma + 4, mb)}
    pa = meta[b"pitm"][0]
    primary = int.from_bytes(data[pa + 4:pa + 6], "big")
    idat = meta.get(b"idat", (0, 0))[0]
    la, _ = meta[b"iloc"]
    v = data[la]
    o = la + 4
    osz, lsz = data[o] >> 4, data[o] & 15
    bsz, isz = data[o + 1] >> 4, (data[o + 1] & 15) if v else 0
    o += 2
    n = int.from_bytes(data[o:o + (2 if v < 2 else 4)], "big")
    o += 2 if v < 2 else 4
    payloads = {}
    order = []
    for _ in range(n):
        iid = int.from_bytes(data[o:o + (2 if v < 2 else 4)], "big")
        o += 2 if v < 2 else 4
        method = 0
        if v:
            method = int.from_bytes(data[o:o + 2], "big") & 15
            o += 2
        o += 2
        base = int.from_bytes(data[o:o + bsz], "big")
        o += bsz
        ec = int.from_bytes(data[o:o + 2], "big")
        o += 2
        chunks = []
        for _ in range(ec):
            o += isz
            eo = int.from_bytes(data[o:o + osz], "big")
            o += osz
            el = int.from_bytes(data[o:o + lsz], "big")
            o += lsz
            start = base + eo + (idat if method == 1 else 0)
            chunks.append(data[start:start + el])
        payloads[iid] = b"".join(chunks)
        order.append(iid)
    items = {}
    ia, ib = meta[b"iinf"]
    for t, a, b in _boxes(data, ia + 4 + (2 if data[ia] == 0 else 4), ib):
        iid = int.from_bytes(data[a + 4:a + 6], "big")
        typ = data[a + 8:a + 12]
        items[iid] = {"id": iid, "type": typ, "name": data[a + 12:b],
                      "payload": payloads.get(iid, b""), "props": []}
    ra, rb = meta[b"iprp"]
    sub = {t: (a, b) for t, a, b in _boxes(data, ra, rb)}
    props = [data[a - 8:b] for _, a, b in _boxes(data, *sub[b"ipco"])]
    aa, _ = sub[b"ipma"]
    v2, flags = data[aa], int.from_bytes(data[aa + 1:aa + 4], "big")
    count = int.from_bytes(data[aa + 4:aa + 8], "big")
    o = aa + 8
    for _ in range(count):
        iid = int.from_bytes(data[o:o + (2 if v2 < 1 else 4)], "big")
        o += 2 if v2 < 1 else 4
        k = data[o]
        o += 1
        for _ in range(k):
            if flags & 1:
                x = int.from_bytes(data[o:o + 2], "big")
                o += 2
                ess, idx = bool(x & 0x8000), x & 0x7FFF
            else:
                ess, idx = bool(data[o] & 0x80), data[o] & 0x7F
                o += 1
            items[iid]["props"].append((props[idx - 1], ess))
    refs = []
    if b"iref" in meta:
        fa, fb = meta[b"iref"]
        wide = data[fa] != 0
        for t, a, b in _boxes(data, fa + 4, fb):
            w = 4 if wide else 2
            frm = int.from_bytes(data[a:a + w], "big")
            cnt = int.from_bytes(data[a + w:a + w + 2], "big")
            to = [int.from_bytes(data[a + w + 2 + w * k:a + 2 * w + 2 + w * k],
                                 "big") for k in range(cnt)]
            refs.append((t, frm, to))
    ftyp = data[top[b"ftyp"][0] - 8:top[b"ftyp"][1]]
    return {"ftyp": ftyp, "primary": primary,
            "items": [items[i] for i in order if i in items]
            + [it for i, it in items.items() if i not in payloads],
            "refs": refs}


def mux(doc: dict) -> bytes:
    """The inverse of :func:`demux`: ftyp, meta (hdlr, pitm, iloc v1 with
    32-bit offsets, iinf, iref, iprp with one property box per
    association, its ipma by ascending item ID as libavif requires) and
    one mdat holding every payload in item order (which is libavif's
    order of the items: that of their first mention, iloc's)."""
    items = doc["items"]
    hdlr = _full(b"hdlr", b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", struct.pack(">H", doc["primary"]))

    def iloc(base: int) -> bytes:
        body = struct.pack(">BBH", 0x44, 0x00, len(items))
        off = base
        for it in items:
            body += struct.pack(">HHHHII", it["id"], 0, 0, 1, off,
                                len(it["payload"]))
            off += len(it["payload"])
        return _full(b"iloc", body, version=1)

    iinf = _full(b"iinf", struct.pack(">H", len(items)) + b"".join(
        _full(b"infe", struct.pack(">HH", it["id"], 0) + it["type"]
              + it["name"], version=2) for it in items))
    iref = b""
    if doc["refs"]:
        iref = _full(b"iref", b"".join(
            _box(t, struct.pack(">HH", frm, len(to))
                 + b"".join(struct.pack(">H", x) for x in to))
            for t, frm, to in doc["refs"]))
    boxes, assoc = [], b""
    for it in sorted(items, key=lambda it: it["id"]):  # libavif's order
        idx = b""
        for box, ess in it["props"]:
            boxes.append(box)
            idx += struct.pack(">H", (0x8000 if ess else 0) | len(boxes))
        assoc += struct.pack(">HB", it["id"], len(it["props"])) + idx
    ipma = _full(b"ipma", struct.pack(">I", len(items)) + assoc, flags=1)
    iprp = _box(b"iprp", _box(b"ipco", b"".join(boxes)) + ipma)

    def meta(base: int) -> bytes:
        return _full(b"meta", hdlr + pitm + iloc(base) + iinf + iref + iprp)

    head = len(doc["ftyp"]) + len(meta(0)) + 8
    return doc["ftyp"] + meta(head) + _box(
        b"mdat", b"".join(it["payload"] for it in items))


def item(doc: dict, iid: int) -> dict:
    return next(it for it in doc["items"] if it["id"] == iid)


def set_grid_output(data: bytes, width: int, height: int) -> bytes:
    """A grid AVIF with its canvas cropped to ``width`` x ``height``: the
    ImageGrid payload's output size (16-bit fields where they fit) and
    the grid items' ``ispe``."""
    doc = demux(data)
    for it in doc["items"]:
        if it["type"] != b"grid":
            continue
        wide = width > 0xFFFF or height > 0xFFFF
        p = it["payload"]
        it["payload"] = bytes((0, int(wide), p[2], p[3])) + struct.pack(
            ">II" if wide else ">HH", width, height)
        it["props"] = [
            (_full(b"ispe", struct.pack(">II", width, height)), ess)
            if box[4:8] == b"ispe" else (box, ess) for box, ess in it["props"]]
    return mux(doc)


def colr_nclx(primaries: int, transfer: int, matrix: int,
              full_range: bool) -> bytes:
    return _box(b"colr", b"nclx" + struct.pack(
        ">HHHB", primaries, transfer, matrix, 0x80 if full_range else 0))


def set_colr(data: bytes, boxes) -> bytes:
    """The file with the colour item's ``colr`` properties replaced by
    ``boxes`` (none: no colr at all)."""
    doc = demux(data)
    it = item(doc, doc["primary"])
    it["props"] = [p for p in it["props"] if p[0][4:8] != b"colr"] + [
        (b, False) for b in boxes]
    return mux(doc)


def colr_icc(icc: bytes, kind: bytes = b"prof") -> bytes:
    return _box(b"colr", kind + icc)


def srgb_icc() -> bytes:
    """An sRGB profile of littleCMS (Pillow's ``ImageCms``)."""
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def add_prem(data: bytes) -> bytes:
    """The file with libavif's ``prem`` reference from the colour item to
    its alpha item (the colour is premultiplied by the alpha)."""
    doc = demux(data)
    alpha = next(frm for t, frm, to in doc["refs"]
                 if t == b"auxl" and doc["primary"] in to)
    doc["refs"].append((b"prem", doc["primary"], [alpha]))
    return mux(doc)


def add_alpha_item(data: bytes, obu: bytes, first: bool = False) -> bytes:
    """The file with another alpha auxiliary item (``obu``'s AV1 stream,
    the first alpha item's properties) for its colour item: after the
    alpha item it has, or before it with ``first``."""
    doc = demux(data)
    alpha = next(frm for t, frm, to in doc["refs"]
                 if t == b"auxl" and doc["primary"] in to)
    old = item(doc, alpha)
    new = dict(old, id=max(it["id"] for it in doc["items"]) + 1,
               payload=obu)
    at = doc["items"].index(old) + (0 if first else 1)
    doc["items"].insert(at, new)
    doc["refs"].append((b"auxl", new["id"], [doc["primary"]]))
    return mux(doc)


def per_cell_alpha(data: bytes) -> bytes:
    """A grid file with an alpha grid (:func:`encode_avif_grid` with
    ``alpha_cells``) whose alpha is one ``auxl`` item a colour cell
    instead: the alpha grid item and its references dropped, each alpha
    cell an auxiliary image of the colour cell at its place."""
    doc = demux(data)
    agrid = next(frm for t, frm, to in doc["refs"]
                 if t == b"auxl" and doc["primary"] in to)
    cells = next(to for t, frm, to in doc["refs"]
                 if t == b"dimg" and frm == doc["primary"])
    alphas = next(to for t, frm, to in doc["refs"]
                  if t == b"dimg" and frm == agrid)
    doc["items"] = [it for it in doc["items"] if it["id"] != agrid]
    doc["refs"] = [r for r in doc["refs"] if agrid not in (r[1], *r[2])
                   and r[0] != b"prem"]
    doc["refs"] += [(b"auxl", a, [c]) for a, c in zip(alphas, cells)]
    return mux(doc)


def dav1d_pictures(obu: bytes):
    """Every picture libdav1d returns for ``obu`` at its defaults
    (``all_layers`` 1: each shown frame, each layer's too), one thread and
    no frame delay -> [(y, u | None, v | None, bitdepth)], None where
    libdav1d is absent, [] where it fails the stream."""
    from imagekit_tpu.codecs import avif_native as ref_avif

    lib = ref_avif._dav1d()
    if lib is None:
        return None
    settings = ctypes.create_string_buffer(256)
    lib.dav1d_default_settings(settings)
    struct.pack_into("<ii", settings, 0, 1, 1)  # n_threads, max_frame_delay
    ctx = ctypes.c_void_p()
    if lib.dav1d_open(ctypes.byref(ctx), settings) != 0:
        return None
    out = []
    try:
        dd = ctypes.create_string_buffer(128)
        buf = (ctypes.c_uint8 * len(obu)).from_buffer_copy(obu)
        if lib.dav1d_data_wrap(dd, buf, len(obu), ref_avif._NOFREE,
                               None) != 0:
            return None
        pic = ctypes.create_string_buffer(512)
        sent = False
        for _ in range(1000):
            if not sent:
                rc = lib.dav1d_send_data(ctx, dd)
                if rc == 0:
                    sent = True
                elif rc != -11:
                    return []
            rc = lib.dav1d_get_picture(ctx, pic)
            if rc == -11 and sent:
                break
            if rc == -11:
                continue
            if rc != 0:
                return []
            try:
                out.append(_dav1d_planes(pic))
            finally:
                lib.dav1d_picture_unref(pic)
        return out
    finally:
        lib.dav1d_close(ctypes.byref(ctx))


def _dav1d_planes(pic):
    """(y, u | None, v | None, bitdepth) of a Dav1dPicture, read with the
    reference's ``_PIC_*`` offsets."""
    from imagekit_tpu.codecs import avif_native as ref_avif

    datap = struct.unpack_from("<3Q", pic, ref_avif._PIC_DATA_OFF)
    stride = struct.unpack_from("<2q", pic, ref_avif._PIC_STRIDE_OFF)
    w, h, layout, bpc = struct.unpack_from("<4i", pic, ref_avif._PIC_P_OFF)
    ct = ctypes.c_uint8 if bpc == 8 else ctypes.c_uint16

    def plane(addr, st, ph, pw):
        n = st // ctypes.sizeof(ct)
        a = np.ctypeslib.as_array((ct * (n * ph)).from_address(addr))
        return a.reshape(ph, n)[:, :pw].copy()

    y = plane(datap[0], stride[0], h, w)
    u = v = None
    if layout != 0:
        cw = (w + 1) // 2 if layout in (1, 2) else w
        ch = (h + 1) // 2 if layout == 1 else h
        u = plane(datap[1], stride[1], ch, cw)
        v = plane(datap[2], stride[1], ch, cw)
    return y, u, v, bpc


def dav1d_samples(obu: bytes, apply_grain: bool = True):
    """libdav1d's picture of ``obu`` at its own depth -> (y, u | None,
    v | None, bitdepth): uint16 planes for 10 and 12 bits, read with the
    reference's ``_PIC_*`` offsets of ``Dav1dPicture`` (the reference's
    ``_decode_obu`` rounds them to 8 bits). None where libdav1d is
    absent or fails. ``apply_grain`` False turns libdav1d's setting of
    that name off (byte 8 of ``Dav1dSettings``): the picture before its
    film grain."""
    from imagekit_tpu.codecs import avif_native as ref_avif

    lib = ref_avif._dav1d()
    if lib is None:
        return None
    settings = ctypes.create_string_buffer(256)
    lib.dav1d_default_settings(settings)
    struct.pack_into("<i", settings, 8, int(apply_grain))
    ctx = ctypes.c_void_p()
    if lib.dav1d_open(ctypes.byref(ctx), settings) != 0:
        return None
    try:
        dd = ctypes.create_string_buffer(128)
        buf = (ctypes.c_uint8 * len(obu)).from_buffer_copy(obu)
        if lib.dav1d_data_wrap(dd, buf, len(obu), ref_avif._NOFREE,
                               None) != 0:
            return None
        if lib.dav1d_send_data(ctx, dd) not in (0, -11):
            return None
        pic = ctypes.create_string_buffer(512)
        for _ in range(8):
            rc = lib.dav1d_get_picture(ctx, pic)
            if rc != -11:
                break
        if rc != 0:
            return None
        try:
            datap = struct.unpack_from("<3Q", pic, ref_avif._PIC_DATA_OFF)
            stride = struct.unpack_from("<2q", pic, ref_avif._PIC_STRIDE_OFF)
            w, h, layout, bpc = struct.unpack_from("<4i", pic,
                                                   ref_avif._PIC_P_OFF)
            ct = ctypes.c_uint8 if bpc == 8 else ctypes.c_uint16

            def plane(addr, st, ph, pw):
                n = st // ctypes.sizeof(ct)
                a = np.ctypeslib.as_array((ct * (n * ph)).from_address(addr))
                return a.reshape(ph, n)[:, :pw].copy()

            y = plane(datap[0], stride[0], h, w)
            u = v = None
            if layout != 0:
                cw = (w + 1) // 2 if layout in (1, 2) else w
                ch = (h + 1) // 2 if layout == 1 else h
                u = plane(datap[1], stride[1], ch, cw)
                v = plane(datap[2], stride[1], ch, cw)
            return y, u, v, bpc
        finally:
            lib.dav1d_picture_unref(pic)
    finally:
        lib.dav1d_close(ctypes.byref(ctx))


def samples_digest(data: bytes) -> str:
    """SHA-256 of libdav1d's planes of the colour item at their own depth
    (uint16 little-endian for 10 and 12 bits)."""
    from imagekit_tpu.codecs import avif_native as ref_avif

    info = ref_avif.parse_container(data)
    h = hashlib.sha256()
    for p in dav1d_samples(info.obu)[:3]:
        if p is not None:
            h.update(np.ascontiguousarray(p).astype("<u2").tobytes())
    return h.hexdigest()


def retag_matrix(data: bytes, matrix: int) -> bytes:
    """The file with its colr/nclx matrix_coefficients set to ``matrix``."""
    i = data.find(b"colrnclx")
    off = i + 8 + 4
    return data[:off] + matrix.to_bytes(2, "big") + data[off + 2:]


def planes_digest(data: bytes):
    """(width, height, SHA-256 of libdav1d's planes of the colour item and
    of the alpha item's luma)."""
    from imagekit_tpu.codecs import avif_native as ref_avif

    info = ref_avif.parse_container(data)
    h = hashlib.sha256()
    y, u, v = ref_avif._decode_obu(info.obu, info.width, info.height)[:3]
    for p in (y, u, v):
        h.update(np.ascontiguousarray(p).tobytes())
    if info.alpha_obu:
        a = ref_avif._decode_obu(info.alpha_obu, info.width, info.height)[0]
        h.update(np.ascontiguousarray(a).tobytes())
    return info.width, info.height, h.hexdigest()


def with_range_flipped(obu: bytes) -> bytes:
    """An AV1 stream with its sequence header's color_range flipped (a
    reduced still-picture header, as libaom writes for AVIF items; the
    reconstruction does not read the bit): a limited-range alpha item,
    which no writer here makes."""
    i = 0
    while True:  # OBUs up to the sequence header (type 1)
        head = obu[i]
        if not head & 2:
            raise ValueError("an OBU without its size")
        i += 2 if head & 4 else 1
        size, shift = 0, 0
        while True:
            size |= (obu[i] & 0x7F) << shift
            shift += 7
            i += 1
            if not obu[i - 1] & 0x80:
                break
        if head >> 3 & 15 == 1:
            break
        i += size
    pos = 8 * i

    def f(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | (obu[pos >> 3] >> (7 - (pos & 7)) & 1)
            pos += 1
        return v

    profile = f(3)
    f(1)
    if not f(1):
        raise ValueError("not a reduced still-picture header")
    f(5)
    wb, hb = f(4) + 1, f(4) + 1
    f(wb + hb + 3 + 3)  # sizes; 128x128, filter intra, intra edge;
    #                     superres, CDEF, restoration
    high = f(1)
    if profile == 2 and high:
        f(1)
    mono = f(1) if profile != 1 else 0
    if f(1):
        prim, trc, mtx = f(8), f(8), f(8)
        if not mono and (prim, trc, mtx) == (1, 13, 0):
            raise ValueError("an sRGB identity header has no color_range")
    b = bytearray(obu)
    b[pos >> 3] ^= 0x80 >> (pos & 7)
    return bytes(b)


#: the AVIFs the reference hands to Pillow (phase 28 of chip_smoke.py):
#: name -> what the recipe in :func:`pillow_files` writes
PILLOW_FILES = {
    "4032x3024_grid": "12 MP, 8-bit 4:2:0 BT.601, 8 x 6 cells of 512 x 512 "
                      "cropped to 4032 x 3024, a synthesized photo",
    "1080p_hdr_2020": "10-bit 4:2:0, CICP 9/16/9, limited range",
    "1080p_lossless_identity": "8-bit 4:4:4, identity matrix, full range, "
                               "lossless, the UI screenshot",
    "1080p_icc_only": "8-bit 4:2:0, an sRGB colr prof and no nclx",
    "1080p_rgba_premultiplied": "8-bit 4:2:0 with alpha and prem",
}
#: the grid's quantizer, at which its file stays under 400 kB
GRID_QUANTIZER = 20


def yuv_planes(rgb: np.ndarray, depth: int, layout: str, kr: float,
               kb: float, full_range: bool = False):
    """Y'CbCr samples of an RGB picture (u8 or float in [0, 1]) at
    ``depth`` bits for the matrix (kr, kb), chroma averaged to the
    layout's grid (4:2:0 needs even sides)."""
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = kr * r + (1 - kr - kb) * g + kb * b
    cb = (b - y) / (2 * (1 - kb))
    cr = (r - y) / (2 * (1 - kr))
    h, w = y.shape
    if layout == "420":
        cb = cb.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        cr = cr.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    top = (1 << depth) - 1
    s = 1 << (depth - 8)
    if full_range:
        ys, yo, cs = top, 0.0, top
    else:
        ys, yo, cs = 219 * s, 16 * s, 224 * s
    dt = np.uint8 if depth == 8 else np.uint16

    def q(v):
        return np.clip(np.round(v), 0, top).astype(dt)

    mid = 1 << (depth - 1)
    return q(yo + y * ys), q(mid + cb * cs), q(mid + cr * cs)


def pillow_files() -> dict:
    """The five files of :data:`PILLOW_FILES`, written by libavif 0.11.1
    (``libavif.so.15``, libaom inside) and edited item by item."""
    import chip_smoke

    out = {}
    # 4096 x 3072 in 512 x 512 cells through avifEncoderAddImageGrid, then
    # the canvas cropped to 4032 x 3024
    photo = chip_smoke.synth_image(2801, 4096, 3072)
    y, u, v = yuv_planes(photo, 8, "420", 0.299, 0.114)
    cells = [(y[r:r + 512, c:c + 512], u[r // 2:r // 2 + 256,
                                         c // 2:c // 2 + 256],
              v[r // 2:r // 2 + 256, c // 2:c // 2 + 256])
             for r in range(0, 3072, 512) for c in range(0, 4096, 512)]
    grid = encode_avif_grid(cells, 8, 6, 8, "420", GRID_QUANTIZER)
    out["4032x3024_grid"] = set_grid_output(grid, 4032, 3024)
    # HDR: BT.2020 primaries, PQ, BT.2020 NCL at 10 bits
    hdr = chip_smoke.synth_image(2802).astype(np.float64) / 255.0
    out["1080p_hdr_2020"] = encode_avif_hbd(
        *yuv_planes(hdr, 10, "420", 0.2627, 0.0593), 10, "420", 24,
        cicp=(9, 16, 9))
    # lossless: libavif --lossless writes G, B, R as Y, U, V (matrix 0)
    ui = ui_screenshot(2803)
    out["1080p_lossless_identity"] = encode_avif_hbd(
        ui[..., 1], ui[..., 2], ui[..., 0], 8, "444", 0, cicp=(1, 13, 0),
        full_range=True)
    # an older writer's file: an ICC profile and no nclx (the stream's
    # sequence header says BT.601, limited range)
    icc = encode_avif_hbd(*yuv_planes(chip_smoke.synth_image(2804), 8,
                                      "420", 0.299, 0.114), 8, "420", 28)
    out["1080p_icc_only"] = set_colr(icc, [colr_icc(srgb_icc())])
    # a cut-out: the colour premultiplied by a diagonal alpha ramp
    rgba = chip_smoke.ramp_alpha(chip_smoke.synth_image(2805))
    a = rgba[..., 3].astype(np.float64) / 255.0
    pre = rgba[..., :3].astype(np.float64) / 255.0 * a[..., None]
    out["1080p_rgba_premultiplied"] = encode_avif_hbd(
        *yuv_planes(pre, 8, "420", 0.299, 0.114), 8, "420", 28,
        alpha=rgba[..., 3], premultiplied=True)
    for name, data in out.items():
        if data is None:
            raise SystemExit(f"ABORT: libavif did not write {name}")
    return out


def pillow_digest(data: bytes) -> dict:
    """Pillow 12.1's decode of a file (its bundled libavif 1.3.0), through
    the JAX package's ``decode_bytes``, as the reference serves it: mode,
    size and the SHA-256 of the HWC u8 array."""
    from imagekit_tpu import codecs as ref_codecs
    from imagekit_tpu.codecs import avif_native as ref_avif

    if ref_avif.decode_rgb(data) is not None:
        raise SystemExit("ABORT: the reference's native path decodes a file "
                         "meant for Pillow")
    arr, _ = ref_codecs.decode_bytes(data)
    return {"mode": "RGBA" if arr.shape[2] == 4 else "RGB",
            "width": int(arr.shape[1]), "height": int(arr.shape[0]),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes())
            .hexdigest()}


def write_pillow_files() -> None:
    """:func:`pillow_files` into ``tests/fixtures/avif/`` with
    ``pillow_arrays.json``: each file's name, recipe, size in bytes and
    :func:`pillow_digest`."""
    table = {}
    for name, data in pillow_files().items():
        with open(os.path.join(OUT, f"{name}.avif"), "wb") as f:
            f.write(data)
        table[name] = {"file": f"{name}.avif", "recipe": PILLOW_FILES[name],
                       "bytes": len(data), **pillow_digest(data)}
        print(f"{name}: {len(data) / 1e3:.1f} kB, {table[name]['mode']} "
              f"{table[name]['width']}x{table[name]['height']}")
    with open(os.path.join(OUT, "pillow_arrays.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


def main() -> int:
    sys.path.insert(0, ROOT)
    from PIL import Image

    import chip_smoke

    from imagekit_tpu.codecs import avif_native as ref_avif
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    os.makedirs(OUT, exist_ok=True)
    files = {}
    for name, (seed, kw, alpha, matrix) in RECIPES.items():
        img = chip_smoke.synth_image(seed)
        if alpha:
            img = chip_smoke.ramp_alpha(img)
        buf = io.BytesIO()
        Image.fromarray(img, "RGBA" if alpha else "RGB").save(
            buf, "AVIF", **{"quality": QUALITY, **kw})
        data = buf.getvalue()
        if matrix is not None:
            data = retag_matrix(data, matrix)
        files[name] = data
    for name, (picture, seed, kw, alpha) in SCREEN.items():
        img = globals()[picture](seed)
        if alpha:
            img = chip_smoke.with_alpha(img, seed)
        buf = io.BytesIO()
        Image.fromarray(img, "RGBA" if alpha else "RGB").save(buf, "AVIF",
                                                              **kw)
        data = buf.getvalue()
        info = ref_avif.parse_container(data)
        head = av1_dec_abi.decode(info.obu)[3]
        if not alpha and not head.intrabc:
            raise SystemExit(f"ABORT: {name}'s frame header does not set "
                             "allow_intrabc")
        if alpha and not av1_dec_abi.decode(info.alpha_obu)[3].palette_blocks:
            raise SystemExit(f"ABORT: {name}'s alpha item codes no palette")
        files[name] = data
    for name, (seed, depth, layout, qz, speed, opts) in HBD.items():
        data = encode_avif_hbd(*hbd_planes(seed, depth, layout), depth,
                               layout, qz, speed, opts)
        if data is None:
            raise SystemExit("ABORT: libavif's high-bit-depth encode failed")
        files[name] = data
    for name, data in files.items():
        head = av1_dec_abi.probe(ref_avif.parse_container(data).obu)
        if head.qmatrix != (name in QM_FILES) or \
                head.film_grain != (name in GRAIN_FILES):
            raise SystemExit(f"ABORT: {name}'s frame header: quantizer "
                             f"matrices {head.qmatrix}, film grain "
                             f"{head.film_grain}")
    table = {}
    for name, data in files.items():
        with open(os.path.join(OUT, f"{name}.avif"), "wb") as f:
            f.write(data)
        w, h, digest = planes_digest(data)
        table[name] = {"file": f"{name}.avif", "width": w, "height": h,
                       "sha256": digest, "qmatrix": name in QM_FILES,
                       "film_grain": name in GRAIN_FILES}
        if name in HBD:
            table[name]["sha256_samples"] = samples_digest(data)
        print(f"{name}: {len(data) / 1e3:.1f} kB, {w}x{h}")
    write_table(table)
    write_superres_files()
    return 0


def superres_files() -> dict:
    """The files of :data:`SUPERRES`: ``chip_smoke.synth_image``'s picture
    as BT.601 planes (:func:`yuv_planes`) at 8 bits, :func:`hbd_planes`'
    at 10, through :func:`encode_av1_libaom` and :func:`av1_avif`."""
    import chip_smoke

    out = {}
    for name, (seed, depth, layout, q, denom, speed, opts) in \
            SUPERRES.items():
        if depth == 8:
            planes = yuv_planes(chip_smoke.synth_image(seed), 8, layout,
                                0.299, 0.114)
        else:
            planes = hbd_planes(seed, depth, layout)
        h, w = planes[0].shape
        obu = encode_av1_libaom(*planes, depth, layout, q, denom, speed, opts)
        if obu is None:
            raise SystemExit(f"ABORT: libaom did not write {name}")
        out[name] = av1_avif(obu, w, h, depth, layout)
    return out


def write_table(entries: dict) -> None:
    """Merges ``entries`` into ``avif_planes.json``, each entry with the
    probe's ``superres_denom`` (8 without superres)."""
    from imagekit_tpu.codecs import avif_native as ref_avif
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    path = os.path.join(OUT, "avif_planes.json")
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    table.update(entries)
    for name, entry in table.items():
        with open(os.path.join(OUT, entry["file"]), "rb") as f:
            obu = ref_avif.parse_container(f.read()).obu
        entry["superres_denom"] = av1_dec_abi.probe(obu).superres_denom
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


def write_superres_files() -> None:
    """:func:`superres_files` into ``tests/fixtures/avif/``, their entries
    (libdav1d's digests, raw samples too at 10 bits) merged into
    ``avif_planes.json``; the files of the other recipes stay as they
    are."""
    from imagekit_tpu.codecs import avif_native as ref_avif
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    table = {}
    for name, data in superres_files().items():
        head = av1_dec_abi.probe(ref_avif.parse_container(data).obu)
        if head.superres_denom != SUPERRES[name][4]:
            raise SystemExit(f"ABORT: {name} does not code superres")
        with open(os.path.join(OUT, f"{name}.avif"), "wb") as f:
            f.write(data)
        w, h, digest = planes_digest(data)
        table[name] = {"file": f"{name}.avif", "width": w, "height": h,
                       "sha256": digest, "qmatrix": head.qmatrix,
                       "film_grain": head.film_grain}
        if SUPERRES[name][1] > 8:
            table[name]["sha256_samples"] = samples_digest(data)
        print(f"{name}: {len(data) / 1e3:.1f} kB, {w}x{h}")
    write_table(table)


#: phase 28's files of the last remainder (``--remainder``): name -> what
#: the recipe in :func:`remainder_files` writes
REMAINDER_FILES = {
    "1080p_coded_540p": "8-bit 4:2:0 coded at 960 x 540 under a 1920 x 1080 "
                        "ispe: libavif scales it up 2x",
    "4032x3024_grid_half_cells": "the 12 MP grid, each 512 x 512 cell coded "
                                 "at 256 x 256 under its ispe",
    "1080p_grid_cell_alpha": "4 x 3 cells of 480 x 360 with one alpha item "
                             "a cell, 8-bit 4:2:0",
    "1080p_layered_full_base": "two spatial layers of 1920 x 1080, both key "
                               "frames; libdav1d's first picture is the "
                               "base",
    "1080p_layered_half_base": "a 960 x 540 base and a 1920 x 1080 top "
                               "layer, both key frames; libavif returns "
                               "the top",
}
#: the files of :data:`REMAINDER_FILES` the reference decodes with
#: libdav1d (its native path) rather than with Pillow
REMAINDER_NATIVE = {"1080p_layered_full_base"}


def set_ispe(data: bytes, iids, width: int, height: int) -> bytes:
    """The file with the ``ispe`` of the items ``iids`` set to width x
    height (the streams stay: libavif rescales them)."""
    doc = demux(data)
    for iid in iids:
        it = item(doc, iid)
        it["props"] = [
            (_full(b"ispe", struct.pack(">II", width, height)), ess)
            if box[4:8] == b"ispe" else (box, ess) for box, ess in it["props"]]
    return mux(doc)


def layered_pair(top_rgb: np.ndarray, base_rgb: np.ndarray, top_q: int,
                 base_q: int) -> bytes:
    """A two-layer stream (:func:`layered_stream`) of 8-bit 4:2:0 BT.601
    key frames, the base coded at its own size under the top's."""
    h, w = top_rgb.shape[:2]
    opts = {"sb-size": "64"}
    top = encode_av1_libaom(*yuv_planes(top_rgb, 8, "420", 0.299, 0.114), 8,
                            "420", top_q, limit=2, forced_max=(w, h),
                            options=opts)
    base = encode_av1_libaom(*yuv_planes(base_rgb, 8, "420", 0.299, 0.114),
                             8, "420", base_q, limit=2, forced_max=(w, h),
                             options=opts)
    return layered_stream(base, top)


def remainder_files() -> dict:
    """The files of :data:`REMAINDER_FILES`: ``chip_smoke``'s synthesized
    photos, written by libavif 0.11.1 (items, grids) or libaom (the
    layers) and edited: the ispe of items and cells, the alpha grid split
    into one item a cell, the layers spliced."""
    import chip_smoke

    out = {}
    small = chip_smoke.synth_image(2901, 960, 540)
    f = encode_avif_hbd(*yuv_planes(small, 8, "420", 0.299, 0.114), 8,
                        "420", 28)
    out["1080p_coded_540p"] = set_ispe(f, [demux(f)["primary"]], 1920, 1080)
    photo = chip_smoke.synth_image(2902, 2048, 1536)
    y, u, v = yuv_planes(photo, 8, "420", 0.299, 0.114)
    cells = [(y[r:r + 256, c:c + 256], u[r // 2:r // 2 + 128,
                                         c // 2:c // 2 + 128],
              v[r // 2:r // 2 + 128, c // 2:c // 2 + 128])
             for r in range(0, 1536, 256) for c in range(0, 2048, 256)]
    g = encode_avif_grid(cells, 8, 6, 8, "420", GRID_QUANTIZER)
    doc = demux(g)
    cell_ids = next(to for t, frm, to in doc["refs"]
                    if t == b"dimg" and frm == doc["primary"])
    g = set_ispe(g, cell_ids, 512, 512)
    out["4032x3024_grid_half_cells"] = set_grid_output(g, 4032, 3024)
    rgba = chip_smoke.ramp_alpha(chip_smoke.synth_image(2903))
    y, u, v = yuv_planes(rgba[..., :3], 8, "420", 0.299, 0.114)
    a = rgba[..., 3]
    box = [(r, c) for r in range(0, 1080, 360) for c in range(0, 1920, 480)]
    out["1080p_grid_cell_alpha"] = per_cell_alpha(encode_avif_grid(
        [(y[r:r + 360, c:c + 480], u[r // 2:r // 2 + 180, c // 2:c // 2 + 240],
          v[r // 2:r // 2 + 180, c // 2:c // 2 + 240]) for r, c in box],
        4, 3, 8, "420", 28, alpha_cells=[a[r:r + 360, c:c + 480]
                                         for r, c in box]))
    top = chip_smoke.synth_image(2904)
    out["1080p_layered_full_base"] = av1_avif(
        layered_pair(top, top, 24, 44), 1920, 1080, 8, "420")
    out["1080p_layered_half_base"] = av1_avif(
        layered_pair(top, chip_smoke.synth_image(2905, 960, 540), 24, 40),
        1920, 1080, 8, "420")
    for name, data in out.items():
        if data is None:
            raise SystemExit(f"ABORT: no writer made {name}")
    return out


def write_remainder_files() -> None:
    """:func:`remainder_files` into ``tests/fixtures/avif/`` with
    ``remainder_arrays.json``: each file's name, recipe, size in bytes,
    the path the reference takes (``native``: libdav1d, whose planes'
    digest is ``planes_sha256``; ``pillow``) and the digest of the array
    the reference's ``decode_bytes`` returns (:func:`pillow_digest`'s
    fields)."""
    from imagekit_tpu import codecs as ref_codecs
    from imagekit_tpu.codecs import avif_native as ref_avif

    files = remainder_files()
    # the reference's native path validates libdav1d's ABI on its first
    # picture, and turns itself off for good where that picture is not
    # the container's size: give it a plain file first
    plain = encode_avif_hbd(np.full((64, 64), 128, np.uint8),
                            np.full((32, 32), 128, np.uint8),
                            np.full((32, 32), 128, np.uint8), 8, "420", 30)
    if ref_avif.decode_rgb(plain) is None:
        raise SystemExit("ABORT: the reference's native path is off")
    table = {}
    for name, data in files.items():
        native = name in REMAINDER_NATIVE
        if (ref_avif.decode_rgb(data) is not None) != native:
            raise SystemExit(f"ABORT: the reference's native path "
                             f"{'declines' if native else 'decodes'} {name}")
        with open(os.path.join(OUT, f"{name}.avif"), "wb") as f:
            f.write(data)
        arr, _ = ref_codecs.decode_bytes(data)
        table[name] = {
            "file": f"{name}.avif", "recipe": REMAINDER_FILES[name],
            "bytes": len(data), "path": "native" if native else "pillow",
            "mode": "RGBA" if arr.shape[2] == 4 else "RGB",
            "width": int(arr.shape[1]), "height": int(arr.shape[0]),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes())
            .hexdigest()}
        if native:
            table[name]["planes_sha256"] = planes_digest(data)[2]
        print(f"{name}: {len(data) / 1e3:.1f} kB, {table[name]['mode']} "
              f"{table[name]['width']}x{table[name]['height']}")
    with open(os.path.join(OUT, "remainder_arrays.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


# -- phase 29: inter frames at 1080p ----------------------------------------------

#: the files of ``chip_smoke.py``'s phase 29 (``--inter``): name -> recipe
INTER_FILES = {
    "1080p_inter_progressive":
        "8-bit 4:2:0, two spatial layers: a key frame coded at half size "
        "(libaom's fixed resize mode), then an INTER frame at 1920x1080 "
        "predicted across sizes (libavif's progressive layout); nclx, "
        "whose first picture is not the ispe's size: the Pillow path",
    "1080p_inter_10bit_444_progressive":
        "10-bit 4:4:4, the same layout: the Pillow path",
    "1080p_inter_compound_3layer":
        "8-bit 4:2:0, three spatial layers of 1920x1080: a key frame, then "
        "two INTER frames, the last with compound prediction (libaom "
        "speed 2); no colr box, so the Pillow path",
    "1080p_inter_hidden_key":
        "8-bit 4:2:0, a hidden key frame then the INTER frame it predicts, "
        "shown: libdav1d's first picture is the inter frame, the native "
        "path",
}
#: the files the reference serves on its native path (libdav1d)
INTER_NATIVE = {"1080p_inter_hidden_key"}


def inter_files() -> dict:
    """:data:`INTER_FILES` by :func:`inter_obu` over :func:`moving_planes`'
    texture, shifted, zoomed and turned between the frames."""
    out = {}
    move = dict(shift=(6.5, 3.25), zoom=1.01, turn=0.5)
    obu = inter_obu(1920, 1080, 8, "420", 2911, 2, quantizer=32,
                    resize_kf_denom=16, **move)
    out["1080p_inter_progressive"] = av1_avif(as_layers(obu), 1920, 1080, 8,
                                              "420")
    obu = inter_obu(1920, 1080, 10, "444", 2912, 2, quantizer=32,
                    resize_kf_denom=16, **move)
    out["1080p_inter_10bit_444_progressive"] = av1_avif(
        as_layers(obu), 1920, 1080, 10, "444")
    obu = inter_obu(1920, 1080, 8, "420", 2913, 3, quantizer=36, speed=2,
                    **move)
    out["1080p_inter_compound_3layer"] = set_colr(
        av1_avif(as_layers(obu), 1920, 1080, 8, "420"), [])
    obu = inter_obu(1920, 1080, 8, "420", 2914, 2, quantizer=32,
                    options={"num-tile-groups": 2}, **move)
    out["1080p_inter_hidden_key"] = av1_avif(hidden_key_inter(obu), 1920,
                                             1080, 8, "420")
    return out


def write_inter_files() -> None:
    """:func:`inter_files` into ``tests/fixtures/avif/`` with
    ``inter_arrays.json``: each file's name, recipe, size in bytes, path
    (``native`` or ``pillow``), the digest of the array the reference's
    ``decode_bytes`` returns (:func:`write_remainder_files`' fields), the
    digest of libdav1d's planes of the output frame rounded to 8 bits as
    the reference rounds them (``planes_sha256``) and of its raw samples
    (``samples_sha256``, little-endian 16-bit for 10 bits), and the inter
    tools its decode uses (``tools``: blocks of each, by the port's
    decoder, whose planes must equal libdav1d's before they are
    recorded)."""
    from imagekit_tpu import codecs as ref_codecs
    from imagekit_tpu.codecs import avif_native as ref_avif
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    files = inter_files()
    plain = encode_avif_hbd(np.full((64, 64), 128, np.uint8),
                            np.full((32, 32), 128, np.uint8),
                            np.full((32, 32), 128, np.uint8), 8, "420", 30)
    if ref_avif.decode_rgb(plain) is None:
        raise SystemExit("ABORT: the reference's native path is off")
    table = {}
    for name, data in files.items():
        native = name in INTER_NATIVE
        if (ref_avif.decode_rgb(data) is not None) != native:
            raise SystemExit(f"ABORT: the reference's native path "
                             f"{'declines' if native else 'decodes'} {name}")
        obu = ref_avif.parse_container(data).obu
        select = av1_dec_abi.FIRST if native else av1_dec_abi.HIGHEST
        pics = dav1d_pictures(obu)
        want = pics[0] if native else pics[-1]
        y, u, v, info = av1_dec_abi.decode_samples(obu, select=select)
        if not (info.inter and all(np.array_equal(p, q) for p, q in zip(
                (y, u, v), want[:3]))):
            raise SystemExit(f"ABORT: the port's planes of {name} are not "
                             "libdav1d's")
        with open(os.path.join(OUT, f"{name}.avif"), "wb") as f:
            f.write(data)
        arr, _ = ref_codecs.decode_bytes(data)
        h8, hs = hashlib.sha256(), hashlib.sha256()
        for p in want[:3]:
            h8.update(np.ascontiguousarray(
                av1_dec_abi.to_8bit(p, want[3])).tobytes())
            hs.update(np.ascontiguousarray(p).astype(
                "<u2" if want[3] > 8 else np.uint8).tobytes())
        table[name] = {
            "file": f"{name}.avif", "recipe": INTER_FILES[name],
            "bytes": len(data), "path": "native" if native else "pillow",
            "mode": "RGBA" if arr.shape[2] == 4 else "RGB",
            "width": int(arr.shape[1]), "height": int(arr.shape[0]),
            "bitdepth": int(want[3]),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes())
            .hexdigest(),
            "planes_sha256": h8.hexdigest(), "samples_sha256": hs.hexdigest(),
            "frames": info.frames, "decoded": info.decoded,
            "tools": {k: v for k, v in info.tools.items() if v}}
        print(f"{name}: {len(data) / 1e3:.1f} kB, {table[name]['tools']}")
    with open(os.path.join(OUT, "inter_arrays.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1:] == ["--pillow"]:
        write_pillow_files()
        sys.exit(0)
    if sys.argv[1:] == ["--superres"]:
        write_superres_files()
        sys.exit(0)
    if sys.argv[1:] == ["--remainder"]:
        write_remainder_files()
        sys.exit(0)
    if sys.argv[1:] == ["--inter"]:
        write_inter_files()
        sys.exit(0)
    sys.exit(main())
