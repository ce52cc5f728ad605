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

Run from the repository root: ``python tests/fixtures/make_avif_sources.py``.
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


def encode_avif_hbd(y, u, v, depth: int, layout: str, quantizer: int,
                    speed: int = 8, options=None):
    """A 10- or 12-bit AVIF through libavif's C API (libaom inside), over
    the pinned ABI of ``tests/test_avif_native.py::_encode_avif_10bit``:
    ``layout`` "420", "422", "444" or "400" (monochrome: ``u`` and ``v``
    unused), ``depth`` 8 too (uint8 rows), limited range, BT.601 tags,
    ``quantizer`` 0..63 for both bounds, ``options`` libaom's
    codec-specific keys. None where libavif is not installed."""
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
    lib.avifRWDataFree.argtypes = [ctypes.c_void_p]

    class RW(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]

    h, w = y.shape
    img = lib.avifImageCreate(w, h, depth, {"444": 1, "422": 2, "420": 3,
                                            "400": 4}[layout])
    enc = None
    try:
        ctypes.c_int32.from_address(img + 16).value = 0  # limited range
        for off, val in ((104, 1), (106, 13), (108, 6)):
            ctypes.c_uint16.from_address(img + off).value = val
        if lib.avifImageAllocatePlanes(img, 1) != 0:
            return None
        planes = (ctypes.c_void_p * 3).from_address(img + 24)
        rb = (ctypes.c_uint32 * 3).from_address(img + 48)
        size = 1 if depth == 8 else 2
        for i, arr in ((0, y), (1, u), (2, v))[:1 if layout == "400" else 3]:
            src = np.ascontiguousarray(arr, np.uint8 if size == 1
                                       else np.uint16)
            ph, pw = src.shape
            for row in range(ph):
                ctypes.memmove(planes[i] + row * rb[i],
                               src.ctypes.data + row * pw * size, pw * size)
        enc = lib.avifEncoderCreate()
        # maxThreads, speed, min and max quantizer
        for off, val in ((4, 1), (8, speed), (24, quantizer),
                         (28, quantizer)):
            ctypes.c_int32.from_address(enc + off).value = val
        for key, val in (options or {}).items():
            lib.avifEncoderSetCodecSpecificOption(enc, key.encode(),
                                                  val.encode())
        out = RW()
        if lib.avifEncoderWrite(enc, img, ctypes.byref(out)) != 0:
            return None
        data = ctypes.string_at(out.data, out.size)
        lib.avifRWDataFree(ctypes.byref(out))
        return data
    finally:
        if enc:
            lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)


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
    with open(os.path.join(OUT, "avif_planes.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
