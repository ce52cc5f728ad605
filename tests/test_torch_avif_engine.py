"""AVIF output through the port's engine and app on the CPU, against the JAX
engine.

- One batch of each AVIF path through the JAX ``BatchedEngine`` (the
  batch's signature marked compiled, so that it runs its device head, and
  ``IMAGEKIT_AVIF_FIRSTPARTY`` set: its own switch to the first-party
  encoder the port copies) and through the port's
  ``BatchedEngine(device="cpu")``: JPEG at k=2 (K1's split entry on the
  card) and k=8 (K4), an escape-dense JPEG (K1's int16 entry), an RGB PNG
  (the rgbyuv head on K2), a lossy WebP (K2's ``yuv_resize``) and an RGBA
  PNG with its alpha (the plain head on K2's four-channel entry). The YUV
  planes of these heads are held exact by the WebP tests of the same paths
  (``test_torch_webp_slice.py``, ``test_torch_rgb_slice.py``,
  ``test_torch_rgba_slice.py``); here the AVIF bodies are BYTE-EQUAL.
- A JPEG with no resize: the port decodes its pixels with K3's semantics,
  the reference with Pillow (within +-2 on <= 0.1%,
  ``test_torch_single_image.py``), so the bodies differ; both decode
  through libdav1d (the reference's ``avif_native``, a test-only oracle)
  to pictures at >= 40 dB of each other.
- BMP and TIFF sources make the PNG source's bytes; a GIF takes the same
  rgbyuv head.
- The HTTP app: a signed ``/img?...&f=avif`` answers 200 ``image/avif``
  with an ETag and a ``.avif`` disk-cache entry, then hits that entry; an
  AVIF source and a 10-bit one are served (200) and one whose output
  frame is an INTER frame of no reference answers the reference's 400.
"""

import asyncio
import io
import struct

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import avif_native
from imagekit_tpu.errors import TransformError as RefTransformError
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch.codecs import avif_encode, vp8
from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.ops.weights import target_dimensions
from imagekit_tpu_torch.serving import engine_jpeg, engine_rgb, engine_yuv
from imagekit_tpu_torch.serving.app import create_app
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.signature import sign
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.conftest import encode_jpeg_pil, encode_png, make_test_image
from tests.test_batcher import _noisy_jpeg
from tests.test_torch_jxc_slice import (
    _capture,
    _cfg,
    _drive,
    _ref_native_lib,
    jpeg_sig,
    run_engines,
)
from tests.test_torch_av1_decode import remainder_avif
from tests.test_torch_slice import _OfflineFetcher
from tests.test_vp8_decode import _libwebp

needs_dav1d = pytest.mark.skipif(
    not avif_native.decode_available(),
    reason="libdav1d unavailable (the decode oracle of these tests)")


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


def avif_info(data: bytes):
    """(major brand, [ispe (w, h)], alpha auxiliary item?) of an AVIF body,
    from its ftyp and meta/iprp/ipco boxes."""
    def boxes(start, end):
        i = start
        while i + 8 <= end:
            size, typ = struct.unpack(">I4s", data[i:i + 8])
            assert 8 <= size <= end - i, "malformed box"
            yield typ, i + 8, i + size
            i += size

    top = {t: (a, b) for t, a, b in boxes(0, len(data))}
    brand = data[top[b"ftyp"][0]:top[b"ftyp"][0] + 4]
    meta = {t: (a, b) for t, a, b in boxes(top[b"meta"][0] + 4,
                                            top[b"meta"][1])}
    iprp = {t: (a, b) for t, a, b in boxes(*meta[b"iprp"])}
    ispe, alpha = [], False
    for t, a, b in boxes(*iprp[b"ipco"]):
        if t == b"ispe":
            ispe.append(struct.unpack(">II", data[a + 4:a + 12]))
        elif t == b"auxC":
            alpha = b"auxiliary:alpha" in data[a:b]
    return brand, ispe, alpha


def _rgba(w, h):
    """An RGBA image with a smooth, real alpha plane."""
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip(40 + xx * 200 // w + (yy // 30) * 5, 0, 255)
    return np.dstack([make_test_image(w, h), alpha.astype(np.uint8)])


def _sig_rgb(kind, ch, src_hw, width):
    ih, iw = src_hw
    ow, oh = target_dimensions(iw, ih, width, None)

    def sig(ref, nb):
        return (kind, ref._use_mesh(nb), nb, bucket_for(ih), bucket_for(iw),
                bucket_for(oh), bucket_for(ow), ch)
    return sig


def _sig_webp(src_hw, width):
    ih, iw = src_hw
    ow, oh = target_dimensions(iw, ih, width, None)

    def sig(ref, nb):
        return ("yuvsrc", ref._use_mesh(nb), nb, bucket_for(ih),
                bucket_for(iw), bucket_for(oh), bucket_for(ow), 2, 2, False,
                False)
    return sig


def _jpeg(src_hw, width, k, split=True):
    return lambda ref, nb: jpeg_sig(ref, nb, "yuv", k, src_hw, width,
                                    split=split)


# name: (source, (h, w), target width, JAX signature, the port's head
# module and function)
CASES = {
    "jpeg_k2": (lambda: encode_jpeg_pil(make_test_image(640, 480), 85),
                (480, 640), 120, lambda: _jpeg((480, 640), 120, 2),
                (engine_jpeg, "decode_resize_yuv_lowfreq_i8_batch")),
    "jpeg_k8": (lambda: encode_jpeg_pil(make_test_image(480, 272), 85),
                (272, 480), 300, lambda: _jpeg((272, 480), 300, 8),
                (engine_jpeg, "decode_resize_yuv_i8_batch")),
    "jpeg_dense_k4": (lambda: _noisy_jpeg(640, 480, 100), (480, 640), 240,
                      lambda: _jpeg((480, 640), 240, 4, split=False),
                      (engine_jpeg, "decode_resize_yuv_lowfreq_batch")),
    "rgb_png": (lambda: encode_png(make_test_image(480, 272)), (272, 480),
                120, lambda: _sig_rgb("rgbyuv", 3, (272, 480), 120),
                (engine_rgb, "resample_rgb_yuv_batch")),
    "lossy_webp": (lambda: _libwebp(make_test_image(480, 272), 85),
                   (272, 480), 120, lambda: _sig_webp((272, 480), 120),
                   (engine_yuv, "resize_yuv420_batch")),
    "rgba_png": (lambda: encode_png(_rgba(480, 272)), (272, 480), 120,
                 lambda: _sig_rgb("rgb", 4, (272, 480), 120),
                 (engine_rgb, "resample_bucketed_flat")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_avif_engine_matches_jax_engine(monkeypatch, case):
    make, (ih, iw), tw, sig, (module, head) = CASES[case]
    data = make()
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    calls = _capture(monkeypatch, module, head)
    (ref_out,), (port_out,) = run_engines(monkeypatch, [data], [tw],
                                          ImageFormat.avif, sig())
    assert len(calls) == 1  # the port served it on the head named
    size = target_dimensions(iw, ih, tw, None)
    # the alpha item shares the colour item's ispe
    assert avif_info(port_out) == (b"avif", [size], case == "rgba_png")
    assert port_out == ref_out


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@needs_dav1d
def test_no_resize_jpeg_to_avif_against_jax_engine(monkeypatch):
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    _ref_native_lib(monkeypatch)
    data = encode_jpeg_pil(make_test_image(203, 151), 90)
    ref = RefEngine(_cfg(1, ref_config), metrics=RefMetrics())
    (ref_out,) = _drive(ref, [data], [None], ImageFormat.avif)
    port = PortEngine(_cfg(1), metrics=Metrics(), device="cpu")
    (port_out,) = _drive(port, [data], [None], ImageFormat.avif)
    assert ref.metrics.batches == port.metrics.batches == 0
    assert avif_info(port_out) == (b"avif", [(203, 151)], False)
    a, b = (avif_native.decode_yuv_studio(x) for x in (port_out, ref_out))
    for name in ("y", "u", "v"):
        got, want = getattr(a, name), getattr(b, name)
        assert got.shape == want.shape
        db = _psnr(got, want)
        print(f"no-resize JPEG -> AVIF, {name}: {db:.2f} dB")
        assert db >= 40.0, name


def test_bmp_tiff_gif_sources_take_the_rgbyuv_head(monkeypatch):
    img = make_test_image(480, 272)

    def pil(fmt, mode="RGB"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, fmt)
        return buf.getvalue()

    datas = [encode_png(img), pil("BMP"), pil("TIFF"), pil("GIF", "P")]
    calls = _capture(monkeypatch, engine_rgb, "resample_rgb_yuv_batch")
    engine = PortEngine(_cfg(4), metrics=Metrics(), device="cpu")
    outs = _drive(engine, datas, [120] * 4, ImageFormat.avif)
    assert engine.metrics.batches == len(calls) == 1
    for out in outs:
        assert avif_info(out) == (b"avif", [(120, 68)], False)
    assert outs[1] == outs[2] == outs[0]  # the same pixels, the same bytes


def test_avif_encodes_run_one_at_a_time_on_their_thread(monkeypatch):
    """The engine's AVIF encodes (the fused heads' planes and a request with
    no resize) run on its one AVIF thread, never two at once, so that they
    do not thrash the interpreter lock or hold the codec threads."""
    import threading
    import time

    seen, active = [], []
    real = avif_encode.encode_firstparty

    def rec(*args, **kw):
        active.append(1)
        seen.append((threading.current_thread().name, len(active)))
        time.sleep(0.01)
        try:
            return real(*args, **kw)
        finally:
            active.pop()

    monkeypatch.setattr(avif_encode, "encode_firstparty", rec)
    data = encode_png(make_test_image(96, 64))
    engine = PortEngine(_cfg(3), metrics=Metrics(), device="cpu")
    outs = _drive(engine, [data] * 4, [48, 48, 48, None], ImageFormat.avif)
    assert [avif_info(o)[1] for o in outs] == [[(48, 32)]] * 3 + [[(96, 64)]]
    assert len(seen) == 4
    assert all(name.startswith("ik-avif") and n == 1 for name, n in seen)


def test_avif_lane_sheds_beyond_its_latency_budget(monkeypatch):
    """AVIF requests have an admission bound of their own: their one
    encode thread sheds a request once the AVIF requests ahead of it times
    the mean of the recent encodes' seconds exceed the latency budget. The
    engine-wide check reads a completion rate that WebP and JPEG dominate,
    so it alone would let the AVIF queue grow. No encode yet admits; other
    formats are not held back by the AVIF lane."""
    import time

    from imagekit_tpu_torch.config import BatchConfig
    from imagekit_tpu_torch.errors import EngineOverloaded

    def slow(*args, **kw):
        time.sleep(0.2)
        return b"avif"

    monkeypatch.setattr(avif_encode, "encode_firstparty", slow)
    engine = PortEngine(
        ImageKitConfig(secret="s",
                       batch=BatchConfig(max_queue_latency_s=0.3)),
        metrics=Metrics(), device="cpu")
    data = encode_png(make_test_image(32, 24))
    fmts = [ImageFormat.avif] * 4 + [ImageFormat.webp]

    async def run():
        try:
            first = await asyncio.gather(*(
                engine.transform(data, None, None, ImageFormat.avif, 80)
                for _ in range(3)))
            second = await asyncio.gather(*(
                engine.transform(data, None, None, f, 80) for f in fmts),
                return_exceptions=True)
            return first, second
        finally:
            await engine.close()

    first, second = asyncio.run(run())
    assert first == [b"avif"] * 3  # no encode measured yet: all admitted
    # 0 and 1 AVIF requests ahead: 0 and ~0.2 s <= 0.3 s; 2 and 3: shed
    assert second[:2] == [b"avif"] * 2
    assert all(isinstance(e, EngineOverloaded) for e in second[2:4])
    assert second[4][:4] == b"RIFF"
    assert engine.metrics.shed == 2
    assert engine._avif_insystem == 0 and engine._insystem == 0


# -- HTTP ---------------------------------------------------------------------------

SECRET = "test-secret-key"
JPG = "https://example.com/a.jpg"
AVIF = "https://example.com/a.avif"


AVIF_REMAINDER = "https://example.com/b.avif"
AVIF_10BIT = "https://example.com/c.avif"


def _ten_bit_avif():
    """A 10-bit 4:2:0 AVIF by libavif, or None without it."""
    from tests.fixtures.make_avif_sources import encode_avif_hbd
    from tests.test_torch_av1_screen_hbd import hbd_picture

    return encode_avif_hbd(*hbd_picture(64, 48, 10, "420", 3), 10, "420", 20)


def _serve(tmp_path, fn):
    canned = {
        JPG: ("image/jpeg", encode_jpeg_pil(make_test_image(640, 360), 88)),
        AVIF: ("image/avif", avif_encode.encode_rgb(make_test_image(64, 48),
                                                    80)),
        AVIF_REMAINDER: ("image/avif", remainder_avif()),
    }
    ten = _ten_bit_avif()
    if ten is not None:
        canned[AVIF_10BIT] = ("image/avif", ten)
    fetcher = _OfflineFetcher(canned)
    metrics = Metrics()

    async def inner():
        app = create_app(
            ImageKitConfig(secret=SECRET, cache_dir=tmp_path / "cache"),
            fetcher=fetcher, metrics=metrics, rate_limit=False, device="cpu")
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client, metrics)
        finally:
            await client.close()

    return asyncio.run(inner())


def test_http_img_serves_avif_then_hits_cache(tmp_path):
    params = {"url": JPG, "w": "160", "f": "avif", "q": "70"}

    async def fn(client, metrics):
        r1 = await client.get("/img", params={**params,
                                              "sig": sign(params, SECRET)})
        body = await r1.read()
        assert r1.status == 200, body[:200]
        assert r1.headers["Content-Type"] == "image/avif"
        assert "ETag" in r1.headers
        assert avif_info(body) == (b"avif", [(160, 90)], False)
        cached = list((tmp_path / "cache").glob("*.avif"))
        assert len(cached) == 1 and cached[0].read_bytes() == body
        r2 = await client.get("/img", params={**params,
                                              "sig": sign(params, SECRET)})
        assert r2.status == 200 and await r2.read() == body
        assert metrics.cache_hits == 1 and metrics.cache_misses == 1

    _serve(tmp_path, fn)


def test_http_avif_source_answers_501(tmp_path):
    """AVIF sources are served since the port decodes AV1 itself: the
    port's own AVIF and a 10-bit one by libavif (which answered 501 before
    the decoder built high bit depth) at w=32 are 200 WebPs, as the
    reference serves them; the stream that stood for the decoder's last
    remainder (an INTER frame as its output frame, one of no reference)
    now fails as it fails the reference: 400 in libavif's words, no
    501."""
    if _ten_bit_avif() is None:
        pytest.skip("libavif's high-bit-depth encode unavailable")

    async def fn(client, metrics):
        for url in (AVIF, AVIF_10BIT):
            params = {"url": url, "w": "32"}
            r = await client.get("/img", params={**params,
                                                 "sig": sign(params, SECRET)})
            body = await r.read()
            assert r.status == 200, body[:200]
            assert r.headers["Content-Type"] == "image/webp"
            assert vp8.dimensions(body) == (32, 24)
        params = {"url": AVIF_REMAINDER, "w": "32"}
        r = await client.get("/img", params={**params,
                                             "sig": sign(params, SECRET)})
        text = await r.text()
        assert r.status == 400, text
        with pytest.raises(RefTransformError) as want:
            ref_codecs.decode_bytes(remainder_avif())
        assert str(want.value) in text and "ROADMAP" not in text

    _serve(tmp_path, fn)
