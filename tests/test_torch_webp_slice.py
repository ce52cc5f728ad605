"""The port's WebP-source slice and the rest of JPEG -> WebP, end to end on
the CPU, against the JAX package.

- The port's WebP decoders (``codecs.vp8.decode_yuv420``,
  ``decode_lossless``, ``decode_rgb``, its own copies of the native
  decoders) are byte-equal to the reference's on the vectors of
  ``tests/test_vp8_decode.py`` and ``tests/test_vp8l.py``: libwebp-encoded
  lossy photos of even and odd sizes, lossless images at four encoder
  efforts, RGBA, extended containers with an ALPH plane, animations.
- One batch of each newly served request through the JAX engine (the
  batch's signature marked compiled, so that it runs its device head) and
  the port's ``BatchedEngine(device="cpu")``: lossy WebP -> WebP and ->
  JPEG (two geometries in one batch), lossless WebP -> WebP through the RGB
  head, JPEG -> WebP at k = 8, and escape-dense JPEG -> WebP at k = 4 and
  k = 8 on the int16 transport. What each engine hands its host encoder is
  compared.
- The HTTP contract: ``/img`` and ``/upload`` serve WebP sources; a PNG
  whose data is damaged answers ``/img`` with the reference's body; an
  AVIF that does not decode fails in the reference's words.

Tolerance: u8 planes and the int16 levels of WebP -> JPEG within max |d|
<= 1 on at most 0.1% of elements, the reference's band
(tests/test_pallas_jpeg8.py:72; fp32 sums in another order). The heads
themselves are held exact where they are (``test_torch_yuv_heads.py``).
Seen on the CPU: exact everywhere, the JPEG bytes included.
"""

import asyncio
import io
import zlib

import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import vp8 as ref_vp8
from imagekit_tpu.codecs.native import loader as ref_loader
from imagekit_tpu.errors import TransformError as RefTransformError
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch.codecs import vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import jpeg8, resize_planes, resize_strip
from imagekit_tpu_torch.ops.weights import target_dimensions
from imagekit_tpu_torch.serving import engine_jpeg, engine_yuv
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.signature import sign
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.conftest import encode_jpeg_pil, encode_png, make_test_image
from tests.test_torch_av1_decode import remainder_avif
from tests.test_batcher import _noisy_jpeg
from tests.test_torch_jxc_slice import (
    _capture,
    _cfg,
    _drive,
    _ref_native_lib,
    jpeg_sig,
    run_engines,
)
from tests.test_torch_resize import assert_band
from tests.test_vp8_decode import _libwebp, _photo
from tests.test_vp8l import _images, _lossless


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


# -- the decoders ----------------------------------------------------------------


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("w,h,q", [(400, 225, 80), (80, 48, 50), (17, 31, 95),
                                   (1, 1, 80), (333, 87, 30)])
def test_lossy_decode_byte_equal_to_reference(w, h, q):
    data = _libwebp(_photo(w, h), q)
    assert vp8.dimensions(data) == ref_vp8.dimensions(data) == (w, h)
    want, got = ref_vp8.decode_yuv420(data), vp8.decode_yuv420(data)
    for a, b in zip(got, want):
        _same(a, b)
    assert got[0].shape == (h, w) and got[1].shape == ((h + 1) // 2, (w + 1) // 2)
    _same(vp8.decode_rgb(data), ref_vp8.decode_rgb(data))
    assert vp8.decode_lossless(data) is None  # a lossy container is not its


@pytest.mark.parametrize("method", [0, 2, 4, 6])
@pytest.mark.parametrize("name", ["photo", "noise", "pal2", "pal13", "rows"])
def test_lossless_decode_byte_equal_to_reference(name, method):
    img = _images()[name]
    data = _lossless(img, method)
    got = vp8.decode_lossless(data)
    _same(got, ref_vp8.decode_lossless(data))
    assert np.array_equal(got[:, :, :3], img)  # lossless: the source pixels
    assert vp8.decode_yuv420(data) is None  # the YUV path hands it on
    _same(vp8.decode_rgb(data), got)


def _rgba(seed=3, h=29, w=43):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 4), np.uint8)


def _anim(lossless):
    f0, f1 = _rgba(6, 40, 52), _rgba(7, 40, 52)
    buf = io.BytesIO()
    kw = {"lossless": True} if lossless else {"quality": 80}
    Image.fromarray(f0, "RGBA").save(
        buf, "WEBP", save_all=True, append_images=[Image.fromarray(f1, "RGBA")],
        duration=90, **kw)
    return buf.getvalue()


def _vp8x_alpha():
    buf = io.BytesIO()
    Image.fromarray(_rgba(17, 60, 80), "RGBA").save(buf, "WEBP", quality=80)
    assert buf.getvalue()[12:16] == b"VP8X"
    return buf.getvalue()


EXTENDED = {
    "rgba_lossless": lambda: _lossless(_rgba(), 4, mode="RGBA"),
    "vp8x_alph": _vp8x_alpha,
    "anim_lossy": lambda: _anim(False),
    "anim_lossless": lambda: _anim(True),
}


@pytest.mark.parametrize("kind", sorted(EXTENDED))
def test_extended_decode_byte_equal_to_reference(kind):
    data = EXTENDED[kind]()
    got = vp8.decode_rgb(data)
    _same(got, ref_vp8.decode_rgb(data))
    assert got.shape[2] == 4
    assert vp8.dimensions(data) == ref_vp8.dimensions(data)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "riff"])
def test_corrupt_webp_raises_as_the_reference(kind):
    if kind == "lossy":
        data = bytearray(_libwebp(_photo(80, 48), 80))
        data[30:] = b"\xff" * (len(data) - 30)
        fns = ("decode_yuv420", "decode_rgb")
    elif kind == "lossless":
        good = _lossless(_images()["photo"], 2)
        data, fns = good[: len(good) // 2], ("decode_lossless", "decode_rgb")
    else:  # an extended container whose chunk runs past the file
        data = b"RIFF\x20\x00\x00\x00WEBPVP8X\x40\x00\x00\x00" + b"\x00" * 5
        fns = ("decode_rgb",)
    for fn in fns:
        outcomes = []
        for mod in (ref_vp8, vp8):
            try:
                out = getattr(mod, fn)(bytes(data))
                outcomes.append(None if out is None else out.tobytes())
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], fn
    assert any(isinstance(o, str) for o in outcomes)


def test_pixel_ceiling_needs_no_pillow(monkeypatch):
    """The decompression-bomb guard is the PNG decoder's constant: the
    reference reads Pillow's and doubles it, the same number."""
    from imagekit_tpu_torch.codecs import png

    assert png.MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS  # where PIL errors
    monkeypatch.setattr(png, "MAX_PIXELS", 100)
    with pytest.raises(ValueError, match="too large"):
        vp8.decode_yuv420(_libwebp(_photo(80, 48), 80))
    with pytest.raises(ValueError, match="too large"):
        vp8.decode_lossless(_lossless(_images()["photo"], 0))


# -- the engines -------------------------------------------------------------------

# two sources of one bucket pair (src 256x368 -> out 96x128), odd sides
YUV_GEOMS = [((321, 241), 99), ((301, 251), 97)]


def _capture_encoders(monkeypatch):
    """What each engine hands its host encoders, (reference's, port's):
    the VP8 encoder's planes and the JPEG encoder's levels, by output size
    (the encodes of one batch finish in any order)."""
    got = {"ref": {}, "port": {}}
    for who, vp8_mod, loader_mod in (("ref", ref_vp8, ref_loader),
                                     ("port", vp8, loader)):
        real_vp8, real_jpeg = vp8_mod.encode_yuv420, loader_mod.encode_jpeg

        def rec_vp8(y, u, v, q, real=real_vp8, who=who):
            got[who][y.shape[::-1]] = (y.copy(), u.copy(), v.copy())
            return real(y, u, v, q)

        def rec_jpeg(planes, qtabs, width, height, real=real_jpeg, who=who):
            got[who][(width, height)] = tuple(np.array(p) for p in planes)
            return real(planes, qtabs, width, height)

        monkeypatch.setattr(vp8_mod, "encode_yuv420", rec_vp8)
        monkeypatch.setattr(loader_mod, "encode_jpeg", rec_jpeg)
    return got


def _assert_encoder_inputs(got, sizes):
    assert sorted(got["ref"]) == sorted(got["port"]) == sorted(sizes)
    for size in sizes:
        for name, w, g in zip(("y", "cb", "cr"), got["ref"][size],
                              got["port"][size]):
            assert w.dtype == g.dtype and w.shape == g.shape, (size, name)
            assert_band(g, w, f"{size} {name}")


def _out_size(data: bytes):
    if data[:4] == b"RIFF":
        return vp8.dimensions(data)
    hdr = jpeg_abi.parse(loader.load(), data)
    return hdr.width, hdr.height


def _launches():
    return (jpeg8.LAUNCHES, resize_strip.LAUNCHES, resize_planes.LAUNCHES,
            resize_planes.LAUNCHES_F32)


@pytest.mark.parametrize("fmt", [ImageFormat.webp, ImageFormat.jpeg])
def test_lossy_webp_engine_matches_jax_engine(monkeypatch, fmt):
    datas = [_libwebp(make_test_image(w, h), 85) for (w, h), _ in YUV_GEOMS]
    widths = [tw for _, tw in YUV_GEOMS]
    sizes = [target_dimensions(w, h, tw, None) for (w, h), tw in YUV_GEOMS]
    got = _capture_encoders(monkeypatch)
    heads = [_capture(monkeypatch, engine_yuv, name) for name in
             ("resize_yuv420_batch", "resize_yuv_jpeg_batch")]
    jq = fmt == ImageFormat.jpeg
    before = _launches()

    def sig(ref, nb):
        return ("yuvjpg" if jq else "yuvsrc", ref._use_mesh(nb), nb,
                bucket_for(241), bucket_for(321), 96, 128, 2, 2, False, False)

    ref_out, port_out = run_engines(monkeypatch, datas, widths, fmt, sig)
    assert _launches() == before  # the CPU takes the plain versions
    assert [len(h) for h in heads] == [int(not jq), int(jq)]  # one head call
    for size, a, b in zip(sizes, ref_out, port_out):
        assert _out_size(a) == _out_size(b) == size
        assert (b[:4] == b"RIFF") == (not jq)
    _assert_encoder_inputs(got, sizes)


def test_lossless_webp_takes_the_rgb_head(monkeypatch):
    """A VP8L source is nothing the YUV path takes: it decodes to pixels
    and rides the RGB head (K2's plain version here), as in the JAX
    engine."""
    img = make_test_image(321, 241)
    data = _lossless(img, 2)
    got = _capture_encoders(monkeypatch)
    yuv = _capture(monkeypatch, engine_yuv, "resize_yuv420_batch")

    def sig(ref, nb):
        return ("rgbyuv", ref._use_mesh(nb), nb, bucket_for(241),
                bucket_for(321), 96, 128, 3)

    ref_out, port_out = run_engines(monkeypatch, [data], [99],
                                    ImageFormat.webp, sig)
    assert not yuv
    size = target_dimensions(321, 241, 99, None)
    assert _out_size(ref_out[0]) == _out_size(port_out[0]) == size
    _assert_encoder_inputs(got, [size])


# (name, source, target width, k, split transport, the port's head)
def _jpeg_cases():
    return {
        "k8_1080p_w1280": (encode_jpeg_pil(make_test_image(1920, 1080), 80),
                           (1080, 1920), 1280, 8, True,
                           "decode_resize_yuv_i8_batch"),
        "k8_small": (encode_jpeg_pil(make_test_image(640, 480), 85),
                     (480, 640), 400, 8, True, "decode_resize_yuv_i8_batch"),
        "dense_k4": (_noisy_jpeg(640, 480, 100), (480, 640), 240, 4, False,
                     "decode_resize_yuv_lowfreq_batch"),
        "dense_k8": (_noisy_jpeg(640, 480, 100), (480, 640), 400, 8, False,
                     "decode_resize_yuv_batch"),
    }


@pytest.mark.parametrize("case", ["k8_1080p_w1280", "k8_small", "dense_k4",
                                  "dense_k8"])
def test_jpeg_to_webp_engine_matches_jax_engine(monkeypatch, case):
    """JPEG -> WebP beyond the truncated split head: a downscale under 2x
    (k = 8, K4's plain version here) and escape-dense sources, which ride
    the int16 transport (K1's int16 entry at k < 8, K4 at k = 8)."""
    data, src_hw, tw, k, split, head = _jpeg_cases()[case]
    ovf = jpeg_abi.decode_lowfreq_i8(loader.load(), data, k)[5]
    assert bool(ovf) == (not split)  # which transport the source takes
    got = _capture_encoders(monkeypatch)
    calls = {name: _capture(monkeypatch, engine_jpeg, name) for name in (
        "decode_resize_yuv_i8_batch", "decode_resize_yuv_batch",
        "decode_resize_yuv_lowfreq_batch", "decode_resize_yuv_lowfreq_i8_batch",
        "decode_resize_rgb_batch")}
    before = _launches()
    ref_out, port_out = run_engines(
        monkeypatch, [data], [tw], ImageFormat.webp,
        lambda ref, nb: jpeg_sig(ref, nb, "yuv", k, src_hw, tw, split=split))
    assert _launches() == before
    assert {n: len(c) for n, c in calls.items() if c} == {head: 1}
    size = target_dimensions(src_hw[1], src_hw[0], tw, None)
    assert _out_size(ref_out[0]) == _out_size(port_out[0]) == size
    _assert_encoder_inputs(got, [size])
    y = got["port"][size][0]
    assert 0.5 < ((y > 16) & (y < 235)).mean()  # not met by saturation


def test_int16_pack_is_the_reference_layout():
    """Block-grouped int16 rows: (B, by, pad128(bx*k*k)) at k < 8, (B, by,
    bx*64) at k = 8, the levels of a block together."""
    from imagekit_tpu_torch.serving.jpeg_transport import _JpegItem, _pack_int16

    lib = loader.load()
    data = _noisy_jpeg(64, 48, 100)
    for k, nk, ym in ((4, 16, 128), (2, 4, 128), (8, 64, 8 * 64)):
        if k < 8:
            hdr, coeffs, qt = jpeg_abi.decode_lowfreq(lib, data, k)
        else:
            hdr, coeffs, qt = jpeg_abi.decode(lib, data)
        assert coeffs[0].shape == (6, 8, nk) and coeffs[1].shape == (3, 4, nk)
        item = _JpegItem(hdr, qt, 12, 16, ImageFormat.webp, 80, None, k=k,
                         split=None, coeffs=coeffs)
        y, cb, cr = _pack_int16([item], 2, 8, 8, 4, 4, k)
        assert y.shape == (2, 8, ym) and cb.shape == cr.shape
        assert cb.shape == (2, 4, 128 if k < 8 else 4 * 64)
        assert y.dtype == np.int16 and not y[1].any()
        assert np.array_equal(y[0, :6, : 8 * nk].reshape(6, 8, nk), coeffs[0])
        assert np.array_equal(cr[0, :3, : 4 * nk].reshape(3, 4, nk), coeffs[2])
        assert not y[0, 6:].any() and not y[0, :, 8 * nk:].any()


def test_yuv_batches_split_by_output_format():
    """WebP and JPEG outputs of WebP sources queue apart (one head each),
    and a full queue flushes at once."""
    data = _libwebp(make_test_image(320, 240), 85)
    engine = PortEngine(_cfg(2), metrics=Metrics(), device="cpu")

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(data, 64, None, fmt, 80)
                for fmt in (ImageFormat.webp, ImageFormat.jpeg) * 2))
        finally:
            await engine.close()

    outs = asyncio.run(run())
    assert [o[:4] == b"RIFF" for o in outs] == [True, False, True, False]
    assert all(_out_size(o) == (64, 48) for o in outs)
    assert engine.metrics.batches == 2
    assert engine.metrics.stage_seconds["vp8_decode"] > 0


@pytest.mark.parametrize("case", ["rgba_lossless", "vp8x_alph", "avif_src",
                                  "avif_out", "no_resize"])
def test_webp_requests_outside_the_slice_are_not_ported(case):
    """WebPs with alpha (the plain RGB head), a request with no resize and
    AVIF output (the YUV head and the first-party AV1 encoder), once here,
    are served; the AVIF source once left (an INTER frame as its output
    frame, here one of no reference) fails as the reference fails it, a
    TransformError in the same words, not a 501."""
    fmt, w = ImageFormat.webp, 32
    engine = PortEngine(_cfg(1), metrics=Metrics(), device="cpu")
    if case in EXTENDED or case == "no_resize":
        data = (EXTENDED[case]() if case in EXTENDED
                else _libwebp(make_test_image(320, 240), 85))
        w = None if case == "no_resize" else w
        (out,) = _drive(engine, [data], [w], fmt)
        iw, ih = vp8.dimensions(data)
        assert vp8.dimensions(out) == ((iw, ih) if w is None else
                                       target_dimensions(iw, ih, w, None))
        assert engine.metrics.batches == (0 if w is None else 1)
        return
    if case == "avif_out":
        data = _libwebp(make_test_image(320, 240), 85)
        (out,) = _drive(engine, [data], [w], ImageFormat.avif)
        assert out[4:12] == b"ftypavif" and engine.metrics.batches == 1
        return
    data = remainder_avif()
    with pytest.raises(TransformError) as e:
        _drive(engine, [data], [w], fmt)
    assert not isinstance(e.value, NotPortedError)
    with pytest.raises(RefTransformError) as want:
        ref_codecs.decode_bytes(data)
    assert str(e.value) == str(want.value)


def test_corrupt_lossy_webp_is_a_transform_error():
    data = bytearray(_libwebp(_photo(80, 48), 80))
    data[30:] = b"\xff" * (len(data) - 30)
    engine = PortEngine(_cfg(1), metrics=Metrics(), device="cpu")
    with pytest.raises(TransformError, match="corrupt WebP") as e:
        _drive(engine, [bytes(data)], [32], ImageFormat.webp)
    assert not isinstance(e.value, NotPortedError)


# -- HTTP ------------------------------------------------------------------------------

SECRET = "test-secret-key"
WEBP = "https://example.com/a.webp"
VP8L = "https://example.com/lossless.webp"
BAD_PNG = "https://example.com/damaged.png"
BAD_WEBP = "https://example.com/damaged.webp"


class _Body:
    """A canned response body, as both packages' ``fetch_source`` read one."""

    def __init__(self, data: bytes):
        self._data = data

    async def content_length(self):
        return len(self._data)

    async def chunks(self):
        yield self._data

    async def release(self):
        pass


class _CannedFetcher:
    def __init__(self, responses):
        self.responses = responses

    async def fetch(self, url: str):
        ct, data = self.responses[url]
        return 200, ct, _Body(data)

    async def close(self):
        pass


def _damaged_png() -> bytes:
    """A PNG whose header parses and whose IDAT stream is cut short."""
    good = encode_png(make_test_image(64, 48))
    at = good.index(b"IDAT")
    n = int.from_bytes(good[at - 4:at], "big")
    body = good[at + 4:at + 4 + n // 2]  # half of the deflate stream
    chunk = b"IDAT" + body
    return (good[:at - 4] + len(body).to_bytes(4, "big") + chunk
            + zlib.crc32(chunk).to_bytes(4, "big") + good[at + 8 + n:])


def _sources():
    lossy = bytearray(_libwebp(_photo(80, 48), 80))
    lossy[30:] = b"\xff" * (len(lossy) - 30)
    return {
        WEBP: ("image/webp", _libwebp(make_test_image(640, 480), 85)),
        VP8L: ("image/webp", _lossless(make_test_image(320, 240), 2)),
        BAD_PNG: ("image/png", _damaged_png()),
        BAD_WEBP: ("image/webp", bytes(lossy)),
    }


def _serve(tmp_path, which, fn):
    """Run ``fn(client)`` against the port's app (on the CPU) or the
    reference's, both on the canned sources."""
    async def inner():
        if which == "port":
            from imagekit_tpu_torch.serving.app import create_app

            app = create_app(
                ImageKitConfig(secret=SECRET, cache_dir=tmp_path / which),
                fetcher=_CannedFetcher(_sources()), metrics=Metrics(),
                rate_limit=False, device="cpu")
        else:
            from imagekit_tpu.serving.app import create_app

            app = create_app(
                ref_config.ImageKitConfig(secret=SECRET,
                                          cache_dir=tmp_path / which),
                fetcher=_CannedFetcher(_sources()), metrics=RefMetrics(),
                rate_limit=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(inner())


async def _img(client, **params):
    params = {k: str(v) for k, v in params.items()}
    r = await client.get("/img", params={**params, "sig": sign(params, SECRET)})
    return r.status, r.headers.get("Content-Type"), await r.read()


def test_http_serves_webp_sources(tmp_path):
    upload = _libwebp(make_test_image(320, 240), 85)

    async def fn(client):
        status, ct, body = await _img(client, url=WEBP, w=240)
        assert (status, ct) == (200, "image/webp")
        assert vp8.dimensions(body) == (240, 180)
        status, ct, body = await _img(client, url=WEBP, w=240, f="jpeg", q=80)
        assert (status, ct) == (200, "image/jpeg")
        assert _out_size(body) == (240, 180)
        status, ct, body = await _img(client, url=VP8L, w=64)
        assert (status, ct) == (200, "image/webp")
        assert vp8.dimensions(body) == (64, 48)
        form = FormData()
        form.add_field("file", upload, filename="x.webp")
        form.add_field("w", "64")
        form.add_field("f", "jpeg")
        r = await client.post("/upload", data=form)
        assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
        assert _out_size(await r.read()) == (64, 48)

    _serve(tmp_path, "port", fn)


@pytest.mark.parametrize("url", [BAD_PNG, BAD_WEBP], ids=["png", "webp"])
def test_http_damaged_source_answers_as_the_reference(tmp_path, url):
    """A source whose header parses and whose data does not decode. The
    reference decodes a PNG in full at its fetch stage and answers from
    there; the port decodes it once, on the engine's codec pool, and
    answers with that stage's body. A WebP is validated by its header in
    both, and its decode error comes from the transform stage."""
    async def fn(client):
        return await _img(client, url=url, w=32)

    ref = _serve(tmp_path, "ref", fn)
    port = _serve(tmp_path, "port", fn)
    assert ref[0] == port[0] == 400
    if url == BAD_PNG:
        assert port == ref
        assert port[2] == b"Invalid argument: Unable to decode image for validation"
    else:
        assert port[2].startswith(b"Transform error:")
        assert ref[2].startswith(b"Transform error:")
