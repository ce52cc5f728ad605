"""The port's RGB-source slice (PNG -> WebP / JPEG) against the JAX package.

- The rgbyuv head (``ops.color.resample_rgb_yuv_batch``) and the rgbjpg
  head (``ops.dct.resample_rgb_jpeg_batch``) against the JAX heads, each
  run both through its einsum form and through its Pallas front (K2) in
  interpret mode, on seeded inputs with ``vidx != hidx``.
- The port's ``BatchedEngine(device="cpu")`` against the JAX engine on the
  same PNGs (RGB, grayscale, palette), in one batch of two geometries with
  odd output sizes: the planes handed to the VP8 encoder and the levels
  handed to the JPEG encoder.
- The port's PNG decoder (its own copy of the native decoder) against the
  reference's, and that it never imports Pillow.

Tolerance: u8 planes and int16 levels within max |d| <= 1 on at most 0.1%
of elements, the reference's band (tests/test_pallas_jpeg8.py:72). Seen on
the CPU: exact everywhere.
"""

import asyncio
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import png as ref_png
from imagekit_tpu.codecs import vp8 as ref_vp8
from imagekit_tpu.codecs.native import loader as ref_loader
from imagekit_tpu.ops import color as ref_color
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.ops import pallas_resize
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import png, vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import color, dct, resize_strip
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.conftest import make_test_image
from tests.test_torch_cuda import zlib_png
from tests.test_torch_resize import _inputs, assert_band


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    from tests.test_torch_jxc_slice import _ref_native_lib

    _ref_native_lib(monkeypatch)


@pytest.mark.parametrize("pallas", ["", "interpret"])
def test_rgbyuv_head_matches_jax(monkeypatch, pallas):
    imgs, wv, wh, vidx, hidx = _inputs(seed=4)
    monkeypatch.setenv("IMAGEKIT_PALLAS_RGB", pallas)
    assert pallas_resize.rgb_enabled() == bool(pallas)
    want = ref_color.resample_rgb_yuv_batch(imgs, (wv, wh), vidx, hidx,
                                            (32, 128))
    got = color.resample_rgb_yuv_batch(imgs, (wv, wh), vidx, hidx, (32, 128),
                                       device="cpu")
    for name, g, w in zip("yuv", got, want):
        assert g.dtype == np.uint8
        assert_band(g, w, name)


@pytest.mark.parametrize("pallas", ["", "interpret"])
def test_rgbjpg_head_matches_jax(monkeypatch, pallas):
    imgs, wv, wh, vidx, hidx = _inputs(seed=5)
    qt = (np.random.default_rng(5).random((3, 128)) * 20 + 1).astype(np.float32)
    monkeypatch.setenv("IMAGEKIT_PALLAS_RGBJPG", pallas)
    assert pallas_resize.rgbjpg_enabled() == bool(pallas)
    args = (imgs, (wv, wh), vidx, hidx, qt, (32, 128))
    want = ref_dct.resample_rgb_jpeg_batch(*args)
    got = dct.resample_rgb_jpeg_batch(*args, device="cpu")
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.int16 and g.shape == w.shape
        assert_band(g, w, name)


def test_fdct_quant_matches_jax():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(6)
    plane = (rng.random((2, 32, 48)) * 255 - 128).astype(np.float32)
    q = (rng.random((2, 64)) * 30 + 1).astype(np.float32)
    want = np.asarray(ref_dct._fdct_quant_flat(jnp.asarray(plane),
                                               jnp.asarray(q)))
    got = dct._fdct_quant_flat(torch.from_numpy(plane),
                               torch.from_numpy(q)).numpy()
    assert got.dtype == np.int16
    assert_band(got, want)


def test_heads_on_cpu_launch_no_kernel():
    imgs, wv, wh, vidx, hidx = _inputs(seed=7)
    before = resize_strip.LAUNCHES
    color.resample_rgb_yuv_batch(imgs, (wv, wh), vidx, hidx, (32, 128),
                                 device="cpu")
    assert resize_strip.LAUNCHES == before


# -- the engine ----------------------------------------------------------------


def _png(img, mode):
    """PNG bytes with Pillow: RGB, grayscale ("L") or palette ("P")."""
    import io

    from PIL import Image

    im = Image.fromarray(img)
    if mode == "L":
        im = im.convert("L")
    elif mode == "P":
        im = im.convert("P", palette=Image.ADAPTIVE, colors=64)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


# two geometries of one bucket pair (src 256x368 -> out 96x128), so that one
# batch carries vidx != hidx; both outputs have odd sides
GEOMS = [((321, 241), 99), ((301, 251), 97)]


def _capture(monkeypatch):
    """Record what each engine hands the host encoders (the reference's
    and the port's copies of them), keyed by the output size (the encodes
    of one batch finish in any order)."""
    got = {}

    for vp8_mod, loader_mod in ((ref_vp8, ref_loader), (vp8, loader)):
        real_vp8, real_jpeg = vp8_mod.encode_yuv420, loader_mod.encode_jpeg

        def rec_vp8(y, u, v, q, real_vp8=real_vp8):
            got.setdefault(y.shape, []).append((y.copy(), u.copy(), v.copy()))
            return real_vp8(y, u, v, q)

        def rec_jpeg(planes, qtabs, width, height, real_jpeg=real_jpeg):
            got.setdefault((height, width), []).append(
                tuple(np.array(p) for p in planes))
            return real_jpeg(planes, qtabs, width, height)

        monkeypatch.setattr(vp8_mod, "encode_yuv420", rec_vp8)
        monkeypatch.setattr(loader_mod, "encode_jpeg", rec_jpeg)
    return got


def _drive(engine, datas, fmt):
    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, w, None, fmt, 85)
                for d, (_, w) in zip(datas, GEOMS)))
        finally:
            await engine.close()

    return asyncio.run(run())


def _cfg(mod=port_config):
    return mod.ImageKitConfig(secret="s", batch=mod.BatchConfig(
        max_batch=2, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))


@pytest.mark.parametrize("fmt", [ImageFormat.webp, ImageFormat.jpeg])
@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_port_engine_matches_jax_engine_on_pngs(monkeypatch, mode, fmt):
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine
    from tests.test_torch_jxc_slice import _ref_native_lib

    _ref_native_lib(monkeypatch)
    datas = [_png(make_test_image(w, h), mode) for (w, h), _ in GEOMS]
    got = _capture(monkeypatch)

    ref = RefEngine(_cfg(ref_config), metrics=RefMetrics())
    (bw, bh), (obw, obh) = (bucket_for(321), bucket_for(241)), (128, 96)
    head = "rgbyuv" if fmt == ImageFormat.webp else "rgbjpg"
    # mark the batch's signature compiled, so the JAX engine runs its device
    # head (compiling it on the spot) and not its cold-shape host fallback
    ref._compiled.add((head, ref._use_mesh(2), 2, bh, bw, obh, obw, 3))
    ref_out = _drive(ref, datas, fmt)
    assert ref.metrics.host_fallbacks == 0 and ref.metrics.batches == 1

    port = PortEngine(_cfg(), metrics=Metrics(), device="cpu")
    port_out = _drive(port, datas, fmt)
    assert port.metrics.batches == 1

    for ((w, h), tw), a, b in zip(GEOMS, ref_out, port_out):
        oh = int(np.floor(h * tw / w + 0.5))
        if fmt == ImageFormat.webp:
            assert vp8.dimensions(a) == vp8.dimensions(b) == (tw, oh)
        else:
            hdr = jpeg_abi.parse(loader.load(), b)
            assert (hdr.width, hdr.height) == (tw, oh)
            assert a[:3] == b[:3] == b"\xff\xd8\xff"
    assert len(got) == 2
    for shape, (want_planes, got_planes) in got.items():
        for name, w_, g_ in zip(("y", "cb", "cr"), want_planes, got_planes):
            assert_band(g_, w_, f"{shape} {name}")


# -- the PNG decoder -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "RGBA", "zlib"])
def test_png_decode_matches_reference(mode):
    img = make_test_image(67, 45)
    if mode == "RGBA":
        data = _png(np.dstack([img, img[:, :, :1]]), "RGB")
    elif mode == "zlib":
        data = zlib_png(img)
    else:
        data = _png(img, mode)
    want = ref_png.decode(data)
    got = png.decode(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert got.shape == (45, 67, 4 if mode == "RGBA" else 3)
    assert png.parse(data) == (67, 45, got.shape[2])


def test_png_decode_errors():
    data = zlib_png(make_test_image(16, 8))
    with pytest.raises(TransformError, match="corrupt PNG"):
        png.decode(data[:40] + b"\x00" * 8 + data[48:])
    ihdr = b"IHDR" + struct.pack(">IIBBBBB", 20000, 20000, 8, 2, 0, 0, 0)
    huge = (data[:8] + struct.pack(">I", 13) + ihdr
            + struct.pack(">I", zlib.crc32(ihdr)) + data[33:])
    assert 20000 * 20000 > png.MAX_PIXELS
    with pytest.raises(TransformError, match="too large"):
        png.parse(huge)


def test_png_decoder_never_imports_pil():
    img = make_test_image(24, 10)
    script = textwrap.dedent("""
        import json, sys
        import numpy as np
        from imagekit_tpu_torch.codecs import png
        out = png.decode(sys.stdin.buffer.read())
        print(json.dumps({"shape": list(out.shape), "sum": int(out.sum()),
                          "pil": sorted(m for m in sys.modules
                                        if m == "PIL" or m.startswith("PIL."))}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], input=zlib_png(img),
                          capture_output=True, timeout=300, check=True)
    res = __import__("json").loads(proc.stdout.decode().strip().splitlines()[-1])
    assert res == {"shape": [10, 24, 3], "sum": int(img.sum()), "pil": []}


@pytest.mark.parametrize("case", ["unsupported", "no_library"])
def test_unsupported_png_is_not_ported(monkeypatch, case):
    """Where the reference falls back to Pillow on a PNG its decoder does
    not take, the port answers 501; where the native library cannot be
    built, the port's loader raises with the compiler's message (the
    reference's returned None and fell back to Pillow)."""
    data = zlib_png(np.zeros((2, 2, 3), np.uint8))
    if case == "unsupported":
        class _Lib:
            def ik_png_parse(self, data, n, info):
                return -3

        monkeypatch.setattr(png, "_lib", lambda: _Lib())
        with pytest.raises(NotPortedError, match="a guard"):
            png.decode(data)
        return

    def failed_build():
        raise RuntimeError("native codec build failed (1): g++ ...\n"
                           "fatal error: zlib.h: No such file or directory")

    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_stale", lambda: True)
    monkeypatch.setattr(loader, "_build", failed_build)
    with pytest.raises(RuntimeError, match="zlib.h"):
        png.decode(data)
