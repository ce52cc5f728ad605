"""The port stands alone from the JAX package.

- A subprocess imports every module of ``imagekit_tpu_torch``, serves one
  JPEG -> WebP, one PNG -> JPEG and one JPEG -> JPEG request, then the
  WebP it made as a source (lossy WebP -> WebP and -> JPEG, and its pixel
  decode), then an RGBA PNG (the plain RGB head), a BMP, the JPEG with no
  resize (the JPEG pixel decode and the single-image encode), the JPEG and
  the RGBA PNG to AVIF (the first-party AV1 encoder) and
  ``transform_bytes`` through ``BatchedEngine(device="cpu")`` (so that every
  lazy import runs), and then holds no ``imagekit_tpu`` module, no ``jax`` and
  no ``PIL``.
- The port's copies of the reference's host modules are pinned to the
  reference: the C++ codec sources byte for byte, and the signature, the
  cache key, the edge-cache headers, format detection and bucketing equal
  on the same inputs.
- The ``*_batch`` device heads run on the card unless the caller names
  another device: without a card, naming none raises.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from imagekit_tpu import cache as ref_cache
from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import signature as ref_signature
from imagekit_tpu.utils import bucketing as ref_bucketing
from imagekit_tpu_torch import cache as port_cache
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch import signature as port_signature
from imagekit_tpu_torch.utils import bucketing as port_bucketing

ROOT = Path(__file__).resolve().parents[1]


def test_port_serves_three_kinds_without_the_reference():
    script = textwrap.dedent("""
        import asyncio, importlib, json, pkgutil, struct, sys, zlib
        import numpy as np
        import imagekit_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            imagekit_tpu_torch.__path__, "imagekit_tpu_torch.")]
        for name in mods:
            importlib.import_module(name)
        from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
        from imagekit_tpu_torch.codecs import vp8
        from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
        from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients
        from imagekit_tpu_torch.serving.batcher import BatchedEngine
        from imagekit_tpu_torch.serving.metrics import Metrics

        x = np.linspace(0, 255, 320, dtype=np.float32)[None, :, None]
        y = np.linspace(0, 255, 240, dtype=np.float32)[:, None, None]
        img = np.broadcast_to(0.5 * (x + y), (240, 320, 3)).astype(np.uint8)
        planes, qt = host_encode_rgb_to_coefficients(img, 85)
        jpeg = loader.encode_jpeg(planes, qt, 320, 240)
        raw = b"".join(b"\\x00" + img[r].tobytes() for r in range(240))
        chunk = lambda t, b: (struct.pack(">I", len(b)) + t + b
                              + struct.pack(">I", zlib.crc32(t + b)))
        png = (b"\\x89PNG\\r\\n\\x1a\\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", 320, 240, 8, 2, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
        rgba = np.dstack([img, img[:, :, :1]])
        raw4 = b"".join(b"\\x00" + rgba[r].tobytes() for r in range(240))
        png4 = (b"\\x89PNG\\r\\n\\x1a\\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 320, 240, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw4, 1)) + chunk(b"IEND", b""))
        rows = img[::-1, :, ::-1].tobytes()  # 320 * 3 bytes a row: no padding
        bmp = (b"BM" + struct.pack("<IHHI", 54 + len(rows), 0, 0, 54)
               + struct.pack("<IiiHHIIiiII", 40, 320, 240, 1, 24, 0, len(rows),
                             2835, 2835, 0, 0) + rows)
        engine = BatchedEngine(ImageKitConfig(secret="s", batch=BatchConfig(
            max_batch=1)), metrics=Metrics(), device="cpu")

        async def run():
            try:
                first = await asyncio.gather(
                    engine.transform(jpeg, 64, None, ImageFormat.webp, 80),
                    engine.transform(png, 64, None, ImageFormat.jpeg, 80),
                    engine.transform(jpeg, 64, None, ImageFormat.jpeg, 80))
                # the WebP just made, as a source
                second = await asyncio.gather(
                    engine.transform(first[0], 32, None, ImageFormat.webp, 80),
                    engine.transform(first[0], 32, None, ImageFormat.jpeg, 80))
                third = await asyncio.gather(
                    engine.transform(png4, 64, None, ImageFormat.webp, 80),
                    engine.transform(bmp, 64, None, ImageFormat.jpeg, 80),
                    engine.transform(jpeg, None, None, ImageFormat.jpeg, 80))
                avif = await asyncio.gather(
                    engine.transform(jpeg, 32, None, ImageFormat.avif, 80),
                    engine.transform(png4, 32, None, ImageFormat.avif, 80))
                return first + second + third + avif
            finally:
                await engine.close()

        (webp, png_jpeg, jpeg_jpeg, webp_webp, webp_jpeg, rgba_webp, bmp_jpeg,
         same_size, jpeg_avif, rgba_avif) = asyncio.run(run())
        lib = loader.load()
        from imagekit_tpu_torch.transform import transform_bytes
        whole = transform_bytes(png4, 32, None, ImageFormat.jpeg, 80,
                                device="cpu")
        print(json.dumps({
            "n_mods": len(mods),
            "webp": vp8.dimensions(webp),
            "jpegs": [[h.width, h.height] for h in (
                jpeg_abi.parse(lib, png_jpeg), jpeg_abi.parse(lib, jpeg_jpeg))],
            "from_webp": [vp8.dimensions(webp_webp),
                          [getattr(jpeg_abi.parse(lib, webp_jpeg), a)
                           for a in ("width", "height")],
                          list(vp8.decode_rgb(webp).shape)],
            "new": [vp8.dimensions(rgba_webp)] + [
                [h.width, h.height] for h in (
                    jpeg_abi.parse(lib, bmp_jpeg), jpeg_abi.parse(lib, same_size),
                    jpeg_abi.parse(lib, whole))],
            "avif": [[o[4:12].decode(), b"auxC" in o, len(o) > 100]
                     for o in (jpeg_avif, rgba_avif)],
            "batches": engine.metrics.batches,
            "mods": sorted(sys.modules)}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert res["n_mods"] > 30
    assert res["webp"] == [64, 48] and res["jpegs"] == [[64, 48], [64, 48]]
    assert res["from_webp"] == [[32, 24], [32, 24], [48, 64, 3]]
    assert res["new"] == [[64, 48], [64, 48], [320, 240], [32, 24]]
    # the first-party AV1 encoder: alpha kept where the source has it
    assert res["avif"] == [["ftypavif", False, True], ["ftypavif", True, True]]
    assert res["batches"] == 9  # the request with no resize is no batch
    mods = res["mods"]
    assert [m for m in mods if m == "imagekit_tpu"
            or m.startswith("imagekit_tpu.")] == []
    assert [m for m in mods if m == "jax" or m.startswith("jax.")] == []
    assert [m for m in mods if m == "PIL" or m.startswith("PIL.")] == []
    assert not any(m.startswith("rust_image_transform_tpu") for m in mods)


def test_port_serves_pillow_sources_without_pillow(tmp_path):
    """ICO, PNM, QOI, DDS and CMYK / YCCK JPEG sources, written here by
    Pillow, through ``BatchedEngine(device="cpu")`` in a subprocess that
    then holds no Pillow, no ``jax`` and no ``imagekit_tpu`` module."""
    import io
    import json

    from PIL import Image

    from tests.conftest import make_test_image

    img = Image.fromarray(make_test_image(96, 72))
    rgba = img.convert("RGBA")
    made = {}
    for name, (im, fmt, kw) in {
            "ico": (rgba.resize((96, 96)), "ICO", {"sizes": [(96, 96)]}),
            "ppm": (img, "PPM", {}), "qoi": (rgba, "QOI", {}),
            "dds": (rgba, "DDS", {"pixel_format": "DXT5"}),
            "cmyk": (img.convert("CMYK"), "JPEG", {"subsampling": 2})}.items():
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        made[name] = buf.getvalue()
    ycck = bytearray(made["cmyk"])
    ycck[ycck.index(b"Adobe") + 11] = 2
    made["ycck"] = bytes(ycck)
    for name, data in made.items():
        (tmp_path / name).write_bytes(data)
    script = textwrap.dedent("""
        import asyncio, json, sys
        from pathlib import Path
        from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
        from imagekit_tpu_torch.codecs import vp8
        from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
        from imagekit_tpu_torch.serving.batcher import BatchedEngine
        from imagekit_tpu_torch.serving.metrics import Metrics

        names = ["ico", "ppm", "qoi", "dds", "cmyk", "ycck"]
        datas = [(Path(sys.argv[1]) / n).read_bytes() for n in names]
        engine = BatchedEngine(ImageKitConfig(secret="s", batch=BatchConfig(
            max_batch=1)), metrics=Metrics(), device="cpu")

        async def run():
            try:
                return await asyncio.gather(*(
                    engine.transform(d, 32, None, f, 80) for d in datas
                    for f in (ImageFormat.webp, ImageFormat.jpeg)))
            finally:
                await engine.close()

        outs = asyncio.run(run())
        lib = loader.load()
        print(json.dumps({
            "sizes": [list(vp8.dimensions(o)) if o[:4] == b"RIFF" else
                      [jpeg_abi.parse(lib, o).width,
                       jpeg_abi.parse(lib, o).height] for o in outs],
            "mods": sorted(m for m in sys.modules if m.split(".")[0] in (
                "PIL", "jax", "imagekit_tpu"))}))
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["sizes"] == [[32, 32]] * 2 + [[32, 24]] * 10
    assert res["mods"] == []


# -- the copies against the reference ------------------------------------------------

NATIVE = ("jpeg_entropy.cpp", "vp8_encode.cpp", "vp8_decode.cpp",
          "vp8l_decode.cpp", "vp8_common.h", "vp8_tables.h", "png_decode.cpp",
          "misc_decode.cpp", "tiff_decode.cpp", "av1_enc.cpp")


@pytest.mark.parametrize("name", NATIVE)
def test_native_sources_byte_equal(name):
    ref = ROOT / "imagekit_tpu" / "codecs" / "native" / name
    port = ROOT / "imagekit_tpu_torch" / "codecs" / "native" / name
    assert port.read_bytes() == ref.read_bytes()


def test_port_only_native_sources_are_built_and_not_copies():
    """The port's own decoders of what the reference hands to Pillow are
    linked into the library beside the pinned copies; they are no copy of a
    reference source, so nothing pins them."""
    from imagekit_tpu_torch.codecs.native import loader

    own = ("raster_decode.cpp", "jpeg4_decode.cpp")
    for name in own:
        assert name in loader._SOURCES and name not in NATIVE
        assert not (ROOT / "imagekit_tpu" / "codecs" / "native" / name).exists()
    lib = loader.load()
    for fn in ("ik_qoi_decode", "ik_bcn_decode", "ik_jpeg4_parse",
               "ik_jpeg4_decode_coeffs"):
        assert hasattr(lib, fn)


def test_native_library_builds_in_the_port_build_dir():
    from imagekit_tpu_torch.codecs.native import loader

    lib = loader.load()
    assert Path(lib._name) == ROOT / "build" / "imagekit_tpu_torch" / "libik_native.so"
    assert not (ROOT / "imagekit_tpu_torch" / "codecs" / "native"
                / "libik_native.so").exists()


SIGNED = [
    {"url": "https://example.com/a.jpg", "w": "400"},
    {"url": "https://example.com/a b.png?x=1&y=2", "w": "256", "h": "99",
     "f": "jpeg", "q": "80"},
    {"url": "http://x/ä.webp", "t": "1700000000", "fit": "cover"},
    {},
]


@pytest.mark.parametrize("params", SIGNED)
def test_signature_equal(params):
    secret = "k3y"
    assert (port_signature.canonical_string(params)
            == ref_signature.canonical_string(params))
    sig = port_signature.sign(params, secret)
    assert sig == ref_signature.sign(params, secret)
    for verify, err in ((port_signature.verify_signature,
                         port_signature.SignatureError),
                        (ref_signature.verify_signature,
                         ref_signature.SignatureError)):
        outcomes = []
        for s in (sig, sig[:-1] + ("0" if sig[-1] != "0" else "1"), None):
            try:
                verify(params, s, secret)
                outcomes.append("ok")
            except err as e:
                outcomes.append(type(e).__name__)
        assert outcomes[0] == "ok" or "t" in params
        if verify is port_signature.verify_signature:
            port_outcomes = outcomes
        else:
            assert outcomes == port_outcomes


@pytest.mark.parametrize("params", SIGNED)
def test_cache_key_equal(params):
    assert port_cache.key_for_params(params) == ref_cache.key_for_params(params)
    key = port_cache.key_for_params(params)
    assert port_cache.etag_for_key(key) == ref_cache.etag_for_key(key)


@pytest.mark.parametrize("status", [200, 304, 400, 401, 404, 410, 429, 500, 501])
def test_cloudflare_cache_headers_equal(status):
    assert (port_cache.cloudflare_cache_headers(status)
            == ref_cache.cloudflare_cache_headers(status))


MAGIC = [b"\xff\xd8\xff\xe0", b"\x89PNG\r\n\x1a\n", b"RIFF\0\0\0\0WEBPVP8 ",
         b"\0\0\0\x1cftypavif", b"GIF89a", b"BMxx", b"II*\x00", b"MM\x00*",
         b"\x00\x00\x01\x00", b"qoif", b"P6\n", b"DDS ", b"#?RADIANCE",
         b"\x76\x2f\x31\x01", b"farbfeld", b"garbage!", b""]


@pytest.mark.parametrize("data", MAGIC)
def test_guess_format_equal(data):
    def run(mod):
        try:
            return mod.guess_format(data).value
        except Exception as e:  # noqa: BLE001 - the error kind is compared
            return type(e).__name__

    assert run(port_codecs) == run(ref_codecs)


def test_bucketing_equal_over_the_ladder():
    ladder = ref_bucketing.bucket_ladder()
    assert port_bucketing.bucket_ladder() == ladder
    for size in sorted({1, *ladder, *(s + 1 for s in ladder[:-1]),
                        *(s - 1 for s in ladder)}):
        assert port_bucketing.bucket_for(size) == ref_bucketing.bucket_for(size)
    for n in range(1, 80):
        for mb in (1, 4, 16, 32, 64):
            assert (port_bucketing.batch_bucket(n, mb)
                    == ref_bucketing.batch_bucket(n, mb))


# -- the device heads default to the card ------------------------------------------


def _heads():
    from imagekit_tpu_torch.ops import color, dct, resize
    from tests.test_pallas_jpeg8 import _mk
    from tests.test_torch_jxc_slice import _k8_inputs
    from tests.test_torch_resize import _inputs
    from tests.test_torch_yuv_heads import BH, BW, OBH, OBW, _yuv_inputs

    mk = _mk(2, seed=1)
    k8 = _k8_inputs(seed=1)
    flat, yuv_w, yuv_v = _yuv_inputs(seed=1)
    # block-grouped int16 levels of mk's geometry (16x32 and 8x16 blocks)
    y2 = np.zeros((3, 16, 128), np.int16)
    c2 = np.zeros((3, 8, 128), np.int16)
    qt_out = np.ones((3, 128), np.float32)
    imgs, wv, wh, vidx, hidx = _inputs(seed=1)
    y = np.zeros((1, 8, 16 * 64), np.int16)
    c = np.zeros((1, 4, 8 * 64), np.int16)
    # luma 64x128 and chroma 32x64 pixels, both to 16x32
    w = [np.zeros((1, 16, n), np.float32) if i % 2 == 0
         else np.zeros((1, 32, n), np.float32)
         for i, n in enumerate((64, 128, 32, 64))]
    return {
        "decode_resize_yuv_lowfreq_i8_batch": lambda **kw:
            dct.decode_resize_yuv_lowfreq_i8_batch(*mk, **kw),
        "transcode_i8_batch": lambda **kw: dct.transcode_i8_batch(
            *mk[:4], qt_out, *mk[4:], **kw),
        "decode_resize_rgb_batch": lambda **kw: dct.decode_resize_rgb_batch(
            y, c, c, np.ones((1, 128), np.float32), tuple(w),
            np.zeros(1, np.int32), (8, 16, 4, 8), (16, 32), **kw),
        "resample_rgb_jpeg_batch": lambda **kw: dct.resample_rgb_jpeg_batch(
            imgs, (wv, wh), vidx, hidx, qt_out, (32, 128), **kw),
        "resample_rgb_yuv_batch": lambda **kw: color.resample_rgb_yuv_batch(
            imgs, (wv, wh), vidx, hidx, (32, 128), **kw),
        "decode_resize_yuv_i8_batch": lambda **kw:
            dct.decode_resize_yuv_i8_batch(*k8, **kw),
        "decode_resize_yuv_batch": lambda **kw: dct.decode_resize_yuv_batch(
            y, c, c, np.ones((1, 128), np.float32),
            (w[0], w[1], w[2][:, :8], w[3][:, :16]), np.zeros(1, np.int32),
            (8, 16, 4, 8), (16, 32), **kw),
        "decode_resize_yuv_lowfreq_batch": lambda **kw:
            dct.decode_resize_yuv_lowfreq_batch(y2, c2, c2, *mk[3:], **kw),
        "resample_bucketed_flat": lambda **kw: resize.resample_bucketed_flat(
            imgs, wv, wh, vidx, hidx, 3, **kw),
        "resize_yuv420_batch": lambda **kw: dct.resize_yuv420_batch(
            flat, yuv_w, yuv_v, (BH, BW), (OBH, OBW), **kw),
        "resize_yuv_jpeg_batch": lambda **kw: dct.resize_yuv_jpeg_batch(
            flat, yuv_w, qt_out, yuv_v, (BH, BW), (OBH, OBW), **kw),
    }


@pytest.mark.parametrize("head", sorted(_heads()))
def test_batch_heads_default_to_the_card(monkeypatch, head):
    """Numpy inputs and no device named: the head asks for the card, and
    raises on a machine without one; ``device="cpu"`` runs the plain
    version."""
    fn = _heads()[head]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        fn()
    out = fn(device="cpu")
    assert all(isinstance(o, np.ndarray) for o in
               (out if isinstance(out, tuple) else (out,)))
