"""Images beyond the bucket ladder: the port's exact-shape path against the
JAX package's, on the CPU.

The JAX package resizes them at their exact shape
(``imagekit_tpu/parallel/tiling.py::resize_oversized``), over a mesh where
it has more than one device. Here (``tests/conftest.py``) it has eight
virtual CPU devices, so every call below names a one-device mesh: the port
has the one-device branch only. Sizes are small, with one side past the
ladder's top of 8192 (24x8400, 8400x24).

- ``parallel.tiling.resize_oversized`` and ``ops.resize.resize_batch`` at
  exact shapes for RGB, RGBA and gray; ``weights.exact_stacks`` byte-equal
  to the reference's ``resample_weights``.
- ``BatchedEngine(device="cpu")`` against the JAX engine: a 24x8400 PNG to
  WebP and JPEG (what each resizes is compared, and the bodies where it is
  equal); a 8400x32 4:2:0 JPEG to WebP, which the port decodes with its
  JPEG pixel decode and the reference with Pillow (PSNR); an upscale past
  8192 to JPEG, which the port encodes itself and the reference with
  Pillow (PSNR); a WebP over 16383 pixels, which both refuse alike; an RGBA
  PNG 6400 pixels wide through the batched plain head.
- A JPEG beyond the reference's encode ladder: the port's levels are the
  reference's on the two halves of the image.
- ``serving.engine.ThreadedEngine`` against the JAX one, inside and beyond
  the ladder; ``/upload`` of an oversized PNG.

Tolerance: u8 within max |d| <= 1 on at most 0.1% of values (fp32 sums in
another order; the reference's own band, tests/test_pallas_jpeg8.py:72),
expected 0; decoded bodies of two different codecs at >= 40 dB.
"""

import asyncio
import functools
import io

import jax
import numpy as np
import pytest
from PIL import Image

from imagekit_tpu import config as ref_config
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.ops import resize as ref_resize
from imagekit_tpu.parallel import tiling as ref_tiling
from imagekit_tpu.parallel.mesh import make_mesh
from imagekit_tpu.serving import engine as ref_engine
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu.utils.bucketing import bucket_for
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import jpeg, vp8
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import TransformError
from imagekit_tpu_torch.ops import dct, resize
from imagekit_tpu_torch.ops import weights as port_w
from imagekit_tpu_torch.parallel import tiling
from imagekit_tpu_torch.serving import batcher, engine
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from tests.conftest import encode_jpeg_pil, encode_png, make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_rgba_slice import _capture, _cfg, _diff, _drive, _out_size
from tests.test_torch_rgba_slice import _rgba, run_both_plain


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@functools.lru_cache(maxsize=1)
def _one_device():
    return make_mesh(1, devices=jax.devices("cpu")[:1])


def _ref_oversized(img, out_h, out_w, filter_name="lanczos3"):
    return ref_tiling.resize_oversized(img, out_h, out_w, mesh=_one_device(),
                                       filter_name=filter_name)


def _image(h, w, ch, seed):
    if ch == 3:
        return make_test_image(w, h)
    if ch == 4:
        return _rgba(w, h, seed)
    return make_test_image(w, h)[:, :, seed % 3].copy()


# (source h, w, target h, w): one side past the ladder's top
SHAPES = [(8400, 24, 4200, 12), (24, 8400, 12, 4200), (40, 24, 20, 8500)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ch", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_resize_oversized_matches_jax_one_device(shape, ch):
    h, w, oh, ow = shape
    img = _image(h, w, ch, seed=h + ch)
    want = np.asarray(_ref_oversized(img, oh, ow))
    got = tiling.resize_oversized(img, oh, ow, device="cpu")
    assert got.dtype == np.uint8
    assert got.shape == want.shape == (oh, ow, ch)
    _diff(got, want, f"resize_oversized {shape} {ch}ch")


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["tall", "wide"])
def test_resize_batch_at_exact_shapes_matches_jax(shape):
    h, w, oh, ow = shape
    imgs = np.stack([_image(h, w, 3, seed=s) for s in (1, 2)])
    imgs[1] = imgs[1][::-1]
    want = np.asarray(ref_resize.resize_batch(imgs, oh, ow))
    got = resize.resize_batch(imgs, oh, ow, device="cpu")
    assert got.shape == want.shape == (2, oh, ow, 3)
    _diff(got, want, f"resize_batch {shape}")
    # resize_image_array, a fit-within target of one side
    one = resize.resize_image_array(imgs[0], ow, None, device="cpu")
    _diff(one, ref_resize.resize_image_array(imgs[0], ow, None),
          f"resize_image_array {shape}")


@pytest.mark.parametrize("geom", [(8400, 24, 4200, 12), (21, 8403, 5, 2101),
                                  (7, 9, 9000, 3)])
def test_exact_stacks_are_the_reference_weights(geom):
    """Wv is the reference's ``resample_weights`` as it is; Wh the same
    with zero weights in the columns that pad a row to whole 8-byte loads."""
    h, w, oh, ow = geom
    wv, wh = port_w.exact_stacks(h, w, oh, ow)
    assert wv.dtype == wh.dtype == np.float32
    assert wv.shape == (1, oh, h) and wh.shape == (1, ow, (w + 7) // 8 * 8)
    assert np.array_equal(wv[0], ref_resize.resample_weights(h, oh))
    assert np.array_equal(wh[0, :, :w], ref_resize.resample_weights(w, ow))
    assert not wh[0, :, w:].any()


# -- the engine ----------------------------------------------------------------


def _record(monkeypatch, module, name, calls, **kw):
    real = getattr(module, name)

    def rec(*args, **kwargs):
        out = np.asarray(real(*args, **{**kwargs, **kw}))
        calls.append(out.copy())
        return out

    monkeypatch.setattr(module, name, rec)


def _engines(monkeypatch):
    """The JAX engine with its exact-shape path on one device, and the
    port's on the CPU, each recording what its exact-shape path resized."""
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    _ref_native_lib(monkeypatch)
    ref_calls, port_calls = [], []
    _record(monkeypatch, ref_tiling, "resize_oversized", ref_calls,
            mesh=_one_device())
    _record(monkeypatch, batcher, "resize_oversized", port_calls)
    ref = RefEngine(_cfg(ref_config, 1), metrics=RefMetrics())
    port = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    return ref, port, ref_calls, port_calls


@pytest.mark.parametrize("fmt", [ImageFormat.webp, ImageFormat.jpeg])
def test_tall_png_engine_matches_jax_engine(monkeypatch, fmt):
    """A 24x8400 PNG to w=12: the pixels each exact-shape path resized, and
    the bodies where they are equal (the same encoders on the same
    pixels)."""
    data = encode_png(make_test_image(24, 8400))
    ref, port, ref_calls, port_calls = _engines(monkeypatch)
    (a,) = _drive(ref, [data], [12], fmt)
    (b,) = _drive(port, [data], [12], fmt)
    assert _out_size(a) == _out_size(b) == (12, 4200)
    assert port.metrics.batches == 0 and port.metrics.stage_seconds[
        "exact_resize"] > 0
    (want,), (got,) = ref_calls, port_calls
    assert got.shape == want.shape == (4200, 12, 3)
    if _diff(got, want, f"24x8400 -> {fmt.value}") == 0:
        assert a == b


def test_wide_jpeg_to_webp_takes_the_pixel_decode(monkeypatch):
    """A 8400x32 4:2:0 JPEG: both native heads turn it away; the port
    decodes it with its JPEG pixel decode (entropy decode, then K3's plain
    version here), the reference with Pillow."""
    data = encode_jpeg_pil(make_test_image(8400, 32), 90)
    ref, port, ref_calls, port_calls = _engines(monkeypatch)
    (a,) = _drive(ref, [data], [2100], ImageFormat.webp)
    (b,) = _drive(port, [data], [2100], ImageFormat.webp)
    assert vp8.dimensions(a) == vp8.dimensions(b) == (2100, 8)
    assert port.metrics.stage_seconds["entropy_decode"] > 0
    assert port.metrics.stage_seconds["device_decode"] > 0
    assert port.metrics.batches == 0
    db = psnr(_pil(b), _pil(a))
    print(f"8400x32 JPEG -> w=2100 WebP: {db:.2f} dB")
    assert db >= 40.0


def test_upscale_past_the_ladder_to_jpeg(monkeypatch):
    """A 64x2 PNG to w=8400 (8400x263): the port encodes the JPEG itself,
    the reference hands it to Pillow past its encode ladder."""
    data = encode_png(make_test_image(64, 2))
    ref, port, ref_calls, port_calls = _engines(monkeypatch)
    (a,) = _drive(ref, [data], [8400], ImageFormat.jpeg)
    (b,) = _drive(port, [data], [8400], ImageFormat.jpeg)
    assert _out_size(a) == _out_size(b) == (8400, 263)
    _diff(port_calls[0], ref_calls[0], "64x2 -> w=8400")
    db = psnr(_pil(b), _pil(a))
    print(f"64x2 PNG -> w=8400 JPEG: {db:.2f} dB")
    assert db >= 40.0


def test_webp_past_its_limit_fails_as_the_jax_engine(monkeypatch):
    """VP8 takes at most 16383 pixels a side: a 64x2 PNG to a w=16400 WebP
    is a TransformError in both engines (HTTP 400 in both apps)."""
    from imagekit_tpu.errors import TransformError as RefTransformError

    data = encode_png(make_test_image(64, 2))
    ref, port, _, port_calls = _engines(monkeypatch)
    with pytest.raises(RefTransformError, match="VP8"):
        _drive(ref, [data], [16400], ImageFormat.webp)
    with pytest.raises(TransformError, match="VP8 encode failed"):
        _drive(port, [data], [16400], ImageFormat.webp)
    assert port_calls[0].shape == (513, 16400, 3)


def test_rgba_png_at_the_8192_bucket_takes_the_batched_plain_head(
        monkeypatch):
    """An RGBA PNG 6400 pixels wide: the plain head's 8192 bucket, one
    batch in both engines (on a card, K2's column strips: a row of 8192
    RGBA pixels is too wide for a tile of whole rows)."""
    data = encode_png(_rgba(6400, 16, seed=5))
    got = _capture(monkeypatch)
    ref_out, port_out = run_both_plain(
        monkeypatch, [data], [400], ImageFormat.webp, (16, 6400), (1, 400))
    assert vp8.dimensions(ref_out[0]) == vp8.dimensions(port_out[0]) == (400, 1)
    assert bucket_for(6400) == 8192
    ((want, got_planes),) = got.values()
    if sum(_diff(g, w_, f"rgba 6400 {n}")
           for n, w_, g in zip("yuv", want, got_planes)) == 0:
        assert ref_out == port_out


# -- JPEG encode beyond the reference's encode ladder --------------------------


def test_jpeg_levels_beyond_the_encode_ladder_are_the_halves_levels():
    """A 8432x40 image: the reference's encoder refuses it; the port's
    levels are the reference's on its two halves, split at a 16-pixel
    boundary (blocks are independent, and each half keeps its edge)."""
    img = make_test_image(8432, 40)
    with pytest.raises(ValueError, match="exceeds the native encode ladder"):
        ref_dct.encode_rgb_to_coefficients(img, 80)
    planes, qt = dct.encode_rgb_to_coefficients(img, 80, device="cpu")
    split = 4224
    halves = []
    for part in (img[:, :split], img[:, split:]):
        ph, pw = ((s + 15) // 16 * 16 for s in part.shape[:2])
        ref_dct.warm_encode_shape(bucket_for(ph), bucket_for(pw))
        lv, ref_qt = ref_dct.encode_rgb_to_coefficients(part, 80)
        halves.append([np.asarray(p) for p in lv])
    for c, (got, left, right) in enumerate(zip(planes, *halves)):
        assert np.array_equal(got, np.concatenate([left, right], axis=1)), c
    assert all(np.array_equal(a, b) for a, b in zip(qt, ref_qt))
    # the levels make a JPEG that Pillow decodes (q80 of a source with
    # sigma-12 noise: about 27 dB from the source)
    body = jpeg.encode_rgb(img, 80, device="cpu")
    assert _out_size(body) == (8432, 40)
    assert psnr(_pil(body), img) > 25.0


# -- ThreadedEngine ------------------------------------------------------------


@pytest.mark.parametrize("size,width", [((320, 240), 100), ((24, 8400), 12)],
                         ids=["inside", "beyond"])
def test_threaded_engine_matches_jax_threaded_engine(monkeypatch, size,
                                                     width):
    """The per-request engines on a PNG inside and beyond the ladder: the
    resized pixels, and the WebP bodies where they are equal."""
    data = encode_png(make_test_image(*size))
    ref_calls, port_calls = [], []
    _record(monkeypatch, ref_engine, "resize_image", ref_calls)
    _record(monkeypatch, engine, "resize_image", port_calls)

    async def run(eng):
        try:
            return await eng.transform(data, width, None, ImageFormat.webp, 80)
        finally:
            await eng.close()

    a = asyncio.run(run(ref_engine.ThreadedEngine(metrics=RefMetrics())))
    port = engine.ThreadedEngine(metrics=Metrics(), device="cpu")
    b = asyncio.run(run(port))
    want = port_w.target_dimensions(*size, width, None)
    assert vp8.dimensions(a) == vp8.dimensions(b) == want
    assert port.metrics.stage_seconds["resize"] > 0
    if _diff(port_calls[0], ref_calls[0], f"threaded {size}") == 0:
        assert a == b


# -- HTTP ----------------------------------------------------------------------


def test_http_upload_of_an_oversized_png(tmp_path):
    from aiohttp import FormData

    from tests.test_torch_slice import _http

    upload = encode_png(make_test_image(24, 8400))

    async def fn(client, metrics):
        form = FormData()
        form.add_field("file", upload, filename="page.png")
        form.add_field("w", "12")
        r = await client.post("/upload", data=form)
        body = await r.read()
        assert r.status == 200, body[:200]
        assert vp8.dimensions(body) == (12, 4200)

    _http(tmp_path, fn)
