"""The single-image paths of the port against the JAX package, on the CPU:
requests with no resize, the JPEG pixel decode, ``transform.py``.

- ``ops/color.py``: ``rgb_to_yuv420_host`` byte-equal; ``rgb_to_yuv420``
  (torch) within +-1 on at most 0.1% of values of the jitted reference.
- ``ops/dct.py::encode_rgb_to_coefficients``: the levels against the
  reference's numpy mirror and its jitted ``_encode_kernel`` (exact: the
  8x8 fDCT sums in XLA's CPU order), so ``codecs/jpeg.py::encode_rgb`` makes
  the reference's bytes.
- ``ops/dct.py::decode_components_to_rgb`` (the JPEG pixel decode, K6):
  against the JAX package's served decode (``decode_bytes``: Pillow's
  libjpeg-turbo), byte for byte.
- ``codecs/__init__.py`` and ``transform.py``: ``encode_bytes``,
  ``decode_bytes`` and ``transform_bytes`` against the reference's.
  4:4:4 and grayscale JPEGs decode (every layout:
  ``tests/test_torch_jpeg_layouts.py``); a progressive 4:2:0 one decodes.
- The engine: PNG, WebP and JPEG sources with no ``w`` and no ``h`` to WebP
  and to JPEG through both engines. From a PNG or a WebP every stage is
  exact and the outputs are byte-equal; from a JPEG the reference decodes
  with Pillow, so the outputs are decoded and compared by PSNR (>= 38 dB).
- HTTP: ``/upload`` of an RGBA PNG with no sizes answers 200 in both apps.
"""

import io

import numpy as np
import pytest
from aiohttp import FormData
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import config as ref_config
from imagekit_tpu import transform as ref_transform
from imagekit_tpu.codecs import jpeg as ref_jpeg
from imagekit_tpu.codecs import vp8 as ref_vp8
from imagekit_tpu.ops import color as ref_color
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu.utils.bucketing import bucket_for
from imagekit_tpu_torch import codecs, transform
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import jpeg, vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import color, dct, jpeg_pixels
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from tests.conftest import encode_jpeg_pil, encode_png, make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_resize import assert_band
from tests.test_torch_rgba_slice import _cfg, _diff, _drive
from tests.test_vp8_decode import _libwebp

MAX_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock, and a
    worker whose first load meets another's half-written build would
    decode through Pillow alone)."""
    _ref_native_lib(monkeypatch)


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# -- ops/color.py ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 51, 3), (64, 48, 4), (1, 1, 3),
                                   (2, 7, 3)])
def test_rgb_to_yuv420_matches_reference(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    want_host = ref_color.rgb_to_yuv420_host(img)
    got_host = color.rgb_to_yuv420_host(img)
    for w_, g_ in zip(want_host, got_host):
        assert g_.dtype == np.uint8 and np.array_equal(g_, w_)
    want = ref_color.rgb_to_yuv420(img)
    got = color.rgb_to_yuv420(img, device="cpu")
    for name, w_, g_ in zip("yuv", want, got):
        _diff(g_, w_, f"rgb_to_yuv420 {shape} {name}")


def test_vp8_encode_rgb_makes_the_reference_bytes():
    img = make_test_image(161, 97)
    assert vp8.encode_rgb(img, 80) == ref_vp8.encode_rgb(img, 80)
    rgba = np.dstack([img, img[:, :, :1]])
    assert vp8.encode_rgb(rgba, 60) == ref_vp8.encode_rgb(rgba, 60)
    dev = vp8.encode_rgb(img, 80, prefer_device=True, device="cpu")
    assert vp8.dimensions(dev) == (161, 97)


# -- ops/dct.py: encode ---------------------------------------------------------------


@pytest.mark.parametrize("size,quality", [((200, 150), 80), ((64, 48), 95),
                                          ((33, 17), 30)])
def test_encode_rgb_to_coefficients_matches_reference(size, quality):
    img = make_test_image(*size)
    planes, qt = dct.encode_rgb_to_coefficients(img, quality, device="cpu")
    host, host_qt = ref_dct.host_encode_rgb_to_coefficients(img, quality)
    ph, pw = ((s + 15) // 16 * 16 for s in size[::-1])
    ref_dct.warm_encode_shape(bucket_for(ph), bucket_for(pw))
    jit, _ = ref_dct.encode_rgb_to_coefficients(img, quality)
    for name, g, h_, j in zip(("y", "cb", "cr"), planes, host, jit):
        assert g.dtype == np.int16 and g.shape == h_.shape == j.shape
        n_host, n_jit = int((g != h_).sum()), int((g != np.asarray(j)).sum())
        print(f"{size} q{quality} {name}: {n_host} levels differ from the "
              f"numpy mirror, {n_jit} from _encode_kernel, of {g.size}")
        assert n_jit == 0  # the fDCT sums in XLA's CPU order
        assert_band(g, h_, name)
    assert all(np.array_equal(a, b) for a, b in zip(qt, host_qt))
    assert jpeg.encode_rgb(img, quality, device="cpu") == \
        ref_jpeg.encode_rgb(img, quality)


def test_encode_beyond_the_ladder_raises_as_the_reference():
    """The reference's encoder raises beyond its bucket ladder (its caller
    hands the image to Pillow); the port's has no per-shape compile and
    encodes it (its levels: ``tests/test_torch_oversized.py``), up to the
    JPEG limit of 65535 a side (Pillow, the reference's arm there, stops at
    65500); past it both raise a TransformError."""
    img = np.zeros((8, 9000, 3), np.uint8)
    with pytest.raises(ValueError, match="exceeds the native encode ladder"):
        ref_dct.encode_rgb_to_coefficients(img, 80)
    planes, _ = dct.encode_rgb_to_coefficients(img, 80, device="cpu")
    assert [p.shape for p in planes] == [(2, 1126, 64), (1, 563, 64),
                                         (1, 563, 64)]
    body = codecs.encode_bytes(img, ImageFormat.jpeg, 80, device="cpu")
    hdr = jpeg_abi.parse(loader.load(), body)
    assert (hdr.width, hdr.height) == (9000, 8)
    with pytest.raises(TransformError, match="65535"):
        codecs.encode_bytes(np.zeros((1, 65536, 3), np.uint8),
                            ImageFormat.jpeg, 80, device="cpu")


# -- ops/dct.py: the JPEG pixel decode ----------------------------------------------------


@pytest.mark.parametrize("size,quality", [((320, 240), 85), ((203, 151), 95)])
def test_decode_components_to_rgb_matches_jax_under_k3(size, quality):
    """The pixel decode of a 4:2:0 JPEG against the JAX package's served
    decode of it (``decode_bytes``: Pillow) byte for byte; K6's plain
    version on the CPU. The name is kept from when the target was the JAX
    ``decode_components_to_rgb`` under K3's semantics, which the reference
    serves no source with."""
    data = encode_jpeg_pil(make_test_image(*size), quality)
    want = ref_codecs.decode_bytes(data)[0]
    before = jpeg_pixels.LAUNCHES
    got = dct.decode_components_to_rgb(jpeg_abi.decode(loader.load(), data),
                                       device="cpu")
    assert jpeg_pixels.LAUNCHES == before  # the plain version on the CPU
    assert got.dtype == np.uint8 and got.shape == want.shape == (*size[::-1], 3)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _pil_rgb(data))
    assert np.array_equal(jpeg.decode_rgb(data, device="cpu"), got)
    arr, fmt = codecs.decode_bytes(data, device="cpu")
    assert fmt == codecs.SourceFormat.jpeg and np.array_equal(arr, got)


def _jpeg_444():
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).save(buf, "JPEG", quality=85,
                                                   subsampling=0)
    return buf.getvalue()


def _jpeg_progressive():
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).save(buf, "JPEG", quality=85,
                                                   progressive=True)
    return buf.getvalue()


def _jpeg_gray():
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).convert("L").save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("make", [_jpeg_444, _jpeg_gray], ids=["444", "gray"])
def test_jpeg_pixel_decode_outside_420_is_not_ported(make):
    """A 4:4:4 and a grayscale JPEG, which answered 501 before the pixel
    decode took every chroma layout, decode to Pillow's pixels exactly
    and go through the engine with no resize, the pixel decode first."""
    data = make()
    got = jpeg.decode_rgb(data, device="cpu")
    assert got.shape == (48, 64, 3) and np.array_equal(got, _pil_rgb(data))
    engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    (out,) = _drive(engine, [data], [None], ImageFormat.webp)
    assert vp8.dimensions(out) == (64, 48)
    assert engine.metrics.stage_seconds["device_decode"] > 0


def test_progressive_420_jpeg_decodes_to_pixels():
    """The native int16 decode accumulates progressive scans, so a
    progressive 4:2:0 JPEG takes the same pixel decode."""
    data = _jpeg_progressive()
    assert jpeg_abi.parse(loader.load(), data).progressive
    got = jpeg.decode_rgb(data, device="cpu")
    assert got.shape == (48, 64, 3) and np.array_equal(got, _pil_rgb(data))


def test_truncated_jpeg_is_a_transform_error():
    data = encode_jpeg_pil(make_test_image(64, 48), 85)
    with pytest.raises(TransformError, match="JPEG decode failed") as e:
        jpeg.decode_rgb(data[:200], device="cpu")
    assert not isinstance(e.value, NotPortedError)


# -- codecs/__init__.py and transform.py ------------------------------------------------


@pytest.mark.parametrize("fmt", [ImageFormat.jpeg, ImageFormat.webp])
@pytest.mark.parametrize("channels", [3, 4])
def test_encode_bytes_makes_the_reference_bytes(fmt, channels):
    img = make_test_image(97, 61)
    if channels == 4:
        img = np.dstack([img, img[:, :, 1:2]])
    ph, pw = ((s + 15) // 16 * 16 for s in img.shape[:2])
    ref_dct.warm_encode_shape(bucket_for(ph), bucket_for(pw))
    for q in (0, 80, 101):  # clamped to [1, 100]
        assert codecs.encode_bytes(img, fmt, q, device="cpu") == \
            ref_codecs.encode_bytes(img, fmt, q)
    assert transform.encode_image(img, fmt, 80, device="cpu") == \
        ref_transform.encode_image(img, fmt, 80)


def test_encode_bytes_avif_and_empty(monkeypatch):
    """AVIF: the reference's bytes through its first-party arm (its own
    switch), alpha kept where it is real and dropped at 255."""
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    img = make_test_image(16, 16)
    for x in (img, np.dstack([img, img[:, :, :1]]),
              np.dstack([img, np.full((16, 16, 1), 255, np.uint8)]),
              img[:, :, 0]):
        for q in (0, 80):
            got = codecs.encode_bytes(x, ImageFormat.avif, q, device="cpu")
            assert got == ref_codecs.encode_bytes(x, ImageFormat.avif, q)
            assert got[4:12] == b"ftypavif"
    assert transform.encode_image(img, ImageFormat.avif, 80, device="cpu") \
        == ref_transform.encode_image(img, ImageFormat.avif, 80)
    with pytest.raises(TransformError, match="empty image"):
        transform.encode_image(img[:0], ImageFormat.webp, 80, device="cpu")
    with pytest.raises(TransformError, match="empty image"):
        transform.resize_image(img[:0], 8, None, device="cpu")


@pytest.mark.parametrize("src", ["png", "rgba_png", "webp", "lossless_webp"])
@pytest.mark.parametrize("w,h", [(40, None), (None, None), (30, 50)])
def test_transform_bytes_matches_reference(src, w, h):
    img = make_test_image(121, 83)
    data = {"png": lambda: encode_png(img),
            "rgba_png": lambda: encode_png(np.dstack([img, img[:, :, :1]])),
            "webp": lambda: _libwebp(img, 85),
            "lossless_webp": lambda: _save_webp_lossless(img)}[src]()
    px, fmt = transform.decode_image(data, device="cpu")
    ref_px, ref_fmt = ref_transform.decode_image(data)
    assert fmt == ref_fmt and np.array_equal(px, ref_px)
    assert transform.output_dimensions(121, 83, w, h) == \
        ref_transform.output_dimensions(121, 83, w, h)
    _diff(transform.resize_image(px, w, h, device="cpu"),
          ref_transform.resize_image(ref_px, w, h), f"{src} resize {w}x{h}")
    ow, oh = transform.output_dimensions(121, 83, w, h)
    ref_dct.warm_encode_shape(bucket_for((oh + 15) // 16 * 16),
                              bucket_for((ow + 15) // 16 * 16))
    for out_fmt in (ImageFormat.webp, ImageFormat.jpeg):
        got = transform.transform_bytes(data, w, h, out_fmt, 80, device="cpu")
        want = ref_transform.transform_bytes(data, w, h, out_fmt, 80)
        assert got == want  # every stage exact on the CPU


def _save_webp_lossless(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True)
    return buf.getvalue()


def test_single_image_entries_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = make_test_image(32, 32)
    data = encode_jpeg_pil(img, 85)
    for call in (lambda: color.rgb_to_yuv420(img),
                 lambda: dct.encode_rgb_to_coefficients(img, 80),
                 lambda: dct.decode_components_to_rgb(
                     jpeg_abi.decode(loader.load(), data)),
                 lambda: transform.resize_image(img, 16, None),
                 lambda: transform.transform_bytes(data, None, None,
                                                   ImageFormat.jpeg, 80)):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


# -- the engine: requests with no resize ---------------------------------------------------


def _run_no_resize(monkeypatch, data, fmt):
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    _ref_native_lib(monkeypatch)
    ref = RefEngine(_cfg(ref_config, 1), metrics=RefMetrics())
    (ref_out,) = _drive(ref, [data], [None], fmt)
    port = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    (port_out,) = _drive(port, [data], [None], fmt)
    # one image's decode and encode: no batch in either engine
    assert ref.metrics.batches == port.metrics.batches == 0
    assert port.metrics.stage_seconds["encode"] > 0
    return ref_out, port_out


@pytest.mark.parametrize("fmt", [ImageFormat.webp, ImageFormat.jpeg])
@pytest.mark.parametrize("src", ["png", "rgba_png", "webp", "jpeg"])
def test_no_resize_engine_matches_jax_engine(monkeypatch, src, fmt):
    img = make_test_image(203, 151)
    data = {"png": lambda: encode_png(img),
            "rgba_png": lambda: encode_png(np.dstack([img, img[:, :, :1]])),
            "webp": lambda: _libwebp(img, 85),
            "jpeg": lambda: encode_jpeg_pil(img, 90)}[src]()
    ref_dct.warm_encode_shape(bucket_for(160), bucket_for(208))
    ref_out, port_out = _run_no_resize(monkeypatch, data, fmt)
    if fmt == ImageFormat.webp:
        assert vp8.dimensions(port_out) == vp8.dimensions(ref_out) == (203, 151)
        a, b = vp8.decode_rgb(port_out), vp8.decode_rgb(ref_out)
    else:
        hdr = jpeg_abi.parse(loader.load(), port_out)
        assert (hdr.width, hdr.height) == (203, 151)
        a, b = _pil_rgb(port_out), _pil_rgb(ref_out)
    if src == "jpeg":
        # the reference's pixels are Pillow's, the port's its device decode
        print(f"{src} -> {fmt.value}: PSNR {psnr(a, b):.2f} dB")
        assert psnr(a, b) >= 38.0
    else:
        assert port_out == ref_out


def test_http_upload_rgba_png_without_sizes(tmp_path):
    from tests.test_torch_formats import SECRET, _serve

    rgba = np.dstack([make_test_image(120, 90), np.full((90, 120, 1), 200,
                                                        np.uint8)])
    body = encode_png(rgba)

    async def fn(client):
        form = FormData()
        form.add_field("file", body, filename="logo.png")
        r = await client.post("/upload", data=form)
        return r.status, r.headers.get("Content-Type"), await r.read()

    assert SECRET
    port = _serve(tmp_path, "port", fn)
    ref = _serve(tmp_path, "ref", fn)
    assert port[:2] == ref[:2] == (200, "image/webp")
    assert vp8.dimensions(port[2]) == (120, 90)
    assert port[2] == ref[2]
