"""The port's JPEG -> WebP slice end to end on the CPU, against the JAX
package, and the HTTP contract of the port's app (the RGB PNG slice is held
against the JAX engine in ``test_torch_rgb_slice.py``).

- The port's ``BatchedEngine(device="cpu")`` against the JAX
  ``BatchedEngine`` warmed for the same shape: the studio-range YUV planes
  handed to the VP8 encoder are within the reference's band (max |d| <= 1
  on at most 0.1% of pixels; expected exact, since both heads sum fp32 in
  almost the same order) and the WebP dimensions are equal.
- The port's HTTP app: ``/sign`` -> ``/img`` -> 200 ``image/webp`` with the
  reference's cache headers for JPEG and PNG sources, and the reference's
  400 for an AVIF that does not decode.

The 1080p flagship geometry runs on the card in ``chip_smoke.py``; its
weight stacks are pinned here in ``test_torch_weights.py``.
"""

import asyncio
from typing import Dict, Tuple

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import vp8 as ref_vp8
from imagekit_tpu.errors import TransformError as RefTransformError
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch.cache import cloudflare_cache_headers
from imagekit_tpu_torch.codecs import vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.fetch import Fetcher, _BodyStream
from imagekit_tpu_torch.serving import jpeg_transport
from imagekit_tpu_torch.serving.app import create_app
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.signature import sign
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.conftest import encode_jpeg_pil, encode_png, make_test_image
from tests.test_torch_av1_decode import remainder_avif

MAX_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    from tests.test_torch_jxc_slice import _ref_native_lib

    _ref_native_lib(monkeypatch)


def _cfg(max_batch=8, delay_ms=5.0):
    return ImageKitConfig(
        secret="s", batch=BatchConfig(max_batch=max_batch, max_delay_ms=delay_ms)
    )


@pytest.fixture
def captured_planes(monkeypatch):
    """Record the (Y, Cb, Cr) planes each engine hands the VP8 encoder
    (the reference's, or the port's copy of it)."""
    planes = []
    for mod in (ref_vp8, vp8):
        real = mod.encode_yuv420

        def rec(y, u, v, q, real=real):
            planes.append((y.copy(), u.copy(), v.copy()))
            return real(y, u, v, q)

        monkeypatch.setattr(mod, "encode_yuv420", rec)
    return planes


def _run_ref(monkeypatch, data, w, shape):
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine
    from tests.test_torch_jxc_slice import _ref_native_lib

    _ref_native_lib(monkeypatch)  # else the JAX engine decodes by other means
    engine = RefEngine(ref_config.ImageKitConfig(
        secret="s", batch=ref_config.BatchConfig(max_batch=8, max_delay_ms=5.0)),
        metrics=RefMetrics())

    async def run():
        try:
            await engine.warmup(shapes=[shape], paths=("jpeg",))
            return await engine.transform(data, w, None, ImageFormat.webp, 85)
        finally:
            await engine.close()

    out = asyncio.run(run())
    assert engine.metrics.host_fallbacks == 0  # the device head ran
    return out


def _run_port(datas, w, **cfg):
    engine = PortEngine(_cfg(**cfg), metrics=Metrics(), device="cpu")

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, w, None, ImageFormat.webp, 85) for d in datas))
        finally:
            await engine.close()

    return asyncio.run(run()), engine


@pytest.mark.parametrize("src,w,k", [((1280, 720), 256, 2), ((640, 480), 256, 4)])
@pytest.mark.parametrize("gray", [False, True])
def test_port_engine_matches_jax_engine(monkeypatch, captured_planes, src, w, k,
                                        gray):
    sw, sh = src
    img = make_test_image(sw, sh)
    if gray:
        img = img[:, :, :1].repeat(3, axis=2)[:, :, 0]
    data = encode_jpeg_pil(img, 88)
    ow = w
    oh = int(np.floor(sh * w / sw + 0.5))
    assert PortEngine._choose_k(bucket_for(sh), bucket_for(sw),
                                bucket_for(oh), bucket_for(ow)) == k
    shape = (1, bucket_for(sh), bucket_for(sw), bucket_for(oh), bucket_for(ow), 3)
    ref_out = _run_ref(monkeypatch, data, w, shape)
    (port_out,), engine = _run_port([data], w)
    assert engine.metrics.batches == 1
    assert len(captured_planes) == 2
    for name, a, b in zip(("y", "cb", "cr"), captured_planes[0], captured_planes[1]):
        assert a.shape == b.shape, name
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE, name
    assert vp8.dimensions(port_out) == vp8.dimensions(ref_out) == (ow, oh)
    assert port_out[:4] == b"RIFF" and port_out[8:12] == b"WEBP"


def test_batch_over_escape_caps_splits_in_halves(captured_planes, monkeypatch):
    """A batch whose combined escapes exceed the caps is split until every
    part fits, never widened to another head; the planes are unchanged."""
    img = make_test_image(640, 480)
    img[96:176, 200:328] = 255
    img[300:380, 400:520] = 0
    data = encode_jpeg_pil(img, 95)
    (alone,), _ = _run_port([data], 256)
    esc = jpeg_abi.decode_lowfreq_i8(loader.load(), data, 4)[3]
    n_y = int((esc[:, 0] == 0).sum())
    assert n_y > 0
    monkeypatch.setattr(jpeg_transport, "LOWFREQ_ESC_Y", n_y)  # one image fits
    outs, engine = _run_port([data] * 4, 256, max_batch=4, delay_ms=60_000.0)
    assert engine.metrics.batches == 4
    assert all(o == alone for o in outs)
    for p in captured_planes[1:]:
        for a, b in zip(p, captured_planes[0]):
            assert np.array_equal(a, b)


def test_cuda_device_is_never_implicit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        PortEngine(_cfg())


@pytest.mark.parametrize("case", ["png", "jpeg_out", "avif_out", "no_resize",
                                  "upscale_k8", "webp_src", "rgba_png",
                                  "avif_src"])
def test_off_slice_requests_raise_not_ported(case):
    """Requests that were once outside the ported slices: an RGB PNG, a
    JPEG to JPEG, AVIF output, a downscale under 2x (k=8), a lossy WebP
    source, an RGBA PNG (the plain RGB head) and a request with no resize
    are now served; an AVIF source whose output frame is an INTER frame,
    the decoder's last remainder, decodes since inter prediction is built,
    so the one kept here, an INTER frame of no reference, fails as the
    reference fails it (a TransformError in the same words, not a 501)."""
    img = make_test_image(320, 240)
    data, fmt, w = encode_jpeg_pil(img), ImageFormat.webp, 64
    if case == "png":
        data = encode_png(img)
    elif case == "rgba_png":
        data = encode_png(np.dstack([img, img[:, :, :1]]))
    elif case == "jpeg_out":
        fmt = ImageFormat.jpeg
    elif case == "avif_out":
        fmt = ImageFormat.avif
    elif case == "no_resize":
        w = None
    elif case == "upscale_k8":
        w = 300
    elif case == "webp_src":
        data = ref_vp8.encode_rgb(img, 80)
    elif case == "avif_src":
        data = remainder_avif()
    engine = PortEngine(_cfg(), metrics=Metrics(), device="cpu")

    async def run():
        try:
            return await engine.transform(data, w, None, fmt, 80)
        finally:
            await engine.close()

    if case in ("png", "upscale_k8", "webp_src", "rgba_png", "no_resize"):
        size = {"upscale_k8": (300, 225), "no_resize": (320, 240)}.get(
            case, (64, 48))
        assert vp8.dimensions(asyncio.run(run())) == size
        # a request with no resize is one image's decode and encode
        assert engine.metrics.batches == (0 if case == "no_resize" else 1)
        return
    if case == "jpeg_out":
        hdr = jpeg_abi.parse(loader.load(), asyncio.run(run()))
        assert (hdr.width, hdr.height) == (64, 48)
        return
    if case == "avif_out":
        out = asyncio.run(run())
        assert out[4:12] == b"ftypavif" and engine.metrics.batches == 1
        return
    with pytest.raises(TransformError) as e:
        asyncio.run(run())
    assert not isinstance(e.value, NotPortedError)
    with pytest.raises(RefTransformError) as want:
        ref_codecs.decode_bytes(data)
    assert str(e.value) == str(want.value)


# -- HTTP --------------------------------------------------------------------


class _Body(_BodyStream):
    def __init__(self, data: bytes):
        self._data = data

    async def content_length(self):
        return len(self._data)

    async def chunks(self):
        yield self._data


class _OfflineFetcher(Fetcher):
    """Serves canned bodies keyed by URL; no network."""

    def __init__(self, responses: Dict[str, Tuple[str, bytes]]):
        super().__init__()
        self.responses = responses

    async def fetch(self, url: str):
        ct, data = self.responses.get(url, ("text/plain", b"nope"))
        return (200 if url in self.responses else 404), ct, _Body(data)

    async def close(self):
        pass


SECRET = "test-secret-key"
JPG = "https://example.com/a.jpg"
PNG = "https://example.com/a.png"
BMP = "https://example.com/a.bmp"
AVIF = "https://example.com/a.avif"


def _encode_bmp(img):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "BMP")
    return buf.getvalue()


def _http(tmp_path, fn):
    img = make_test_image(1280, 720)
    fetcher = _OfflineFetcher({
        JPG: ("image/jpeg", encode_jpeg_pil(img, 88)),
        PNG: ("image/png", encode_png(make_test_image(320, 240))),
        BMP: ("image/bmp", _encode_bmp(make_test_image(320, 240))),
        AVIF: ("image/avif", remainder_avif()),
    })
    metrics = Metrics()

    async def inner():
        app = create_app(
            ImageKitConfig(secret=SECRET, cache_dir=tmp_path / "cache"),
            fetcher=fetcher, metrics=metrics, rate_limit=False, device="cpu",
        )
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client, metrics)
        finally:
            await client.close()

    return asyncio.run(inner())


def test_http_sign_then_img_serves_webp_then_hits_cache(tmp_path):
    async def fn(client, metrics):
        r = await client.get("/sign", params={"url": JPG, "w": "256", "q": "80"})
        assert r.status == 200
        signed = (await r.json())["signed_url"]
        r1 = await client.get(signed)
        body1 = await r1.read()
        assert r1.status == 200
        assert r1.headers["Content-Type"] == "image/webp"
        assert "ETag" in r1.headers
        # the reference's middleware rewrites the cache headers on 2xx
        for key, value in cloudflare_cache_headers(200).items():
            assert r1.headers[key] == value
        assert vp8.dimensions(body1) == (256, 144)
        r2 = await client.get(signed)
        assert r2.status == 200 and await r2.read() == body1
        assert metrics.cache_hits == 1 and metrics.cache_misses == 1
        r3 = await client.get(signed, headers={"If-None-Match": r1.headers["ETag"]})
        assert r3.status == 304
        health = await (await client.get("/health")).json()
        assert health["device"]["platform"] == "cpu"

    _http(tmp_path, fn)


@pytest.mark.parametrize("params,status", [
    ({"url": BMP, "w": "64"}, 200),          # BMP source: served
    ({"url": JPG, "w": "256", "f": "jpeg"}, 200),  # JPEG -> JPEG: served
    ({"url": JPG}, 200),                      # no resize: served
    ({"url": AVIF, "w": "256"}, 400),        # AVIF of no reference: 400
    ({"url": JPG, "w": "256", "q": "0"}, 400),  # the reference's own 400
    ({"url": PNG, "w": "64"}, 200),          # RGB PNG source: served
])
def test_http_off_slice_answers_501(tmp_path, params, status):
    async def fn(client, metrics):
        sig = sign(params, SECRET)
        r = await client.get("/img", params={**params, "sig": sig})
        assert r.status == status, await r.text()
        if status == 501:
            assert "ROADMAP" in await r.text()
        if status == 200 and params.get("f") == "jpeg":
            assert r.headers["Content-Type"] == "image/jpeg"
            hdr = jpeg_abi.parse(loader.load(), await r.read())
            assert (hdr.width, hdr.height) == (256, 144)
        elif status == 200:
            assert r.headers["Content-Type"] == "image/webp"
            assert vp8.dimensions(await r.read()) == (
                (64, 48) if "w" in params else (1280, 720))
        bad = await client.get("/img", params={**params, "sig": "0" * 64})
        assert bad.status == 401

    _http(tmp_path, fn)


@pytest.mark.parametrize("kind,status", [("jpeg", 200), ("png", 200),
                                         ("garbage", 400), ("rgba_png", 200)])
def test_http_upload(tmp_path, kind, status):
    from aiohttp import FormData

    img = make_test_image(640, 480)
    body = {"jpeg": encode_jpeg_pil(img, 90), "png": encode_png(img),
            "garbage": b"not an image",
            "rgba_png": encode_png(np.dstack([img, img[:, :, :1]]))}[kind]

    async def fn(client, metrics):
        form = FormData()
        form.add_field("file", body, filename="x")
        form.add_field("w", "256")
        r = await client.post("/upload", data=form)
        text = await r.read()
        assert r.status == status, text
        if status == 200:
            assert r.headers["Content-Type"] == "image/webp"
            # the reference's middleware rewrites 2xx cache headers on
            # every transform route, /upload included
            for key, value in cloudflare_cache_headers(200).items():
                assert r.headers[key] == value
            assert vp8.dimensions(text) == (256, 192)
        elif status == 400:
            assert text.startswith(b"Decode error")
        else:
            assert b"ROADMAP" in text

    _http(tmp_path, fn)


def test_http_debug_trace_writes_a_torch_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("IMAGEKIT_DEBUG_ENDPOINTS", "1")
    monkeypatch.setenv("IMAGEKIT_TRACE_DIR", str(tmp_path / "traces"))

    async def fn(client, metrics):
        r = await client.post("/debug/trace", params={"seconds": "0.05"})
        assert r.status == 200
        out = await r.json()
        trace = __import__("pathlib").Path(out["trace_dir"]) / "trace.json"
        assert trace.is_file() and trace.stat().st_size > 0

    _http(tmp_path, fn)
