"""JPEG sources in every chroma layout the JPEG pixel decode serves, on the
CPU: 4:4:4, 4:2:2, 4:4:0, 4:2:0 with distinct Cb/Cr tables, and grayscale.

The reference serves them with Pillow (its native head turns them away,
``imagekit_tpu/serving/engine_jpeg.py:154-162``, and its generic decode
calls ``pil_backend.decode``); the port decodes them with its own pixel
decode, ``ops/dct.py::decode_components_to_rgb`` (one K3 launch on CUDA,
K3's plain version here), and hands the pixels to the batched RGB head.

- (a) Against the JAX package: its RGB-output head
  ``decode_resize_rgb_batch``, under K3's semantics (``k3_semantics``,
  ``tests/test_torch_jxc_slice.py``), with stacks of the JAX package's own
  ``padded_weights`` and ``upsample_weights`` at the same block grids:
  within +-2 on at most 0.1% of values, the band of the demoted RGB head
  (a chroma step times 1.772). Distinct Cb/Cr tables: the levels are
  dequantised on the host and the JAX head gets unit tables (the f32
  products are exact, so it computes the same planes).
- (b) Against Pillow, the JAX package's serving decode: PSNR >= 40 dB and
  |d| <= 12, as for 4:2:0 (``tests/test_torch_single_image.py``).
- (c) The engines: a 4:4:4 and a 4:2:2 source to w=64 WebP and JPEG, and a
  grayscale one with no resize, through both; the outputs decoded and
  compared at >= 38 dB. The port's metrics show the pixel decode
  (``device_decode``) and, with a resize, one batch of the RGB head
  (``device_resize``), never the JPEG heads (``device_decode_resize``).
  AVIF output, a source beyond the bucket ladder and HTTP answer too.
- (d) What stays 501 (``NotPortedError``, queue 1 item 10): lossless
  CMYK. Arithmetic coding is served (progressive CMYK among it; the
  coding has its own tests, ``tests/test_torch_jpeg_arith_lossless.py``).
  A 12-bit frame is Pillow's "cannot identify image file", a lossless
  arithmetic one (SOF11) libjpeg's "broken data stream", 400s as in the
  reference; Cb and Cr sampled differently and a chroma ratio of 4 (4:1:1)
  are served (``tests/test_torch_jpeg_sampling.py`` has the layouts and
  their fixtures, from ``tests/fixtures/jpeg_writer.py``). Baseline CMYK
  and YCCK JPEGs are served (``tests/test_torch_pillow_sources.py``).

4:4:0 sources come from the port's native encoder
(``loader.encode_jpeg(samp=(1, 2))``), the others from Pillow.
"""

import dataclasses
import io
import struct

import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imagekit_tpu import config as ref_config
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.ops import resize as ref_resize
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu.utils.bucketing import bucket_for
from imagekit_tpu_torch import codecs, transform
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import jpeg, vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import dct, resize_planes, weights
from imagekit_tpu_torch.serving.app import create_app
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.signature import sign
from tests.conftest import make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib, k3_semantics  # noqa: F401
from tests.test_torch_rgba_slice import _cfg, _drive, _out_size
from tests.test_torch_slice import _OfflineFetcher

MAX_SHARE = 1e-3
SECRET = "test-secret-key"
SIZES = [(320, 240), (203, 151)]


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_jpeg(img, subsampling=0, gray=False, **kw) -> bytes:
    buf = io.BytesIO()
    pic = Image.fromarray(img)
    if gray:
        pic.convert("L").save(buf, "JPEG", quality=90, **kw)
    else:
        pic.save(buf, "JPEG", quality=90, subsampling=subsampling, **kw)
    return buf.getvalue()


def _native_jpeg(img, samp, quality=90) -> bytes:
    planes, qt = weights.host_encode_rgb_to_coefficients(img, quality, samp)
    return loader.encode_jpeg(planes, qt, img.shape[1], img.shape[0], samp)


def _distinct_tables() -> list:
    """Three tables, Cb's and Cr's unlike each other and the luma's."""
    base = np.arange(1, 65)
    return [list(base % 20 + 2), list(base % 23 + 3), list(base % 29 + 5)]


LAYOUTS = {
    "444": lambda img: _pil_jpeg(img, 0),
    "422": lambda img: _pil_jpeg(img, 1),
    "440": lambda img: _native_jpeg(img, (1, 2)),
    "420_distinct": lambda img: _pil_jpeg(img, 2, qtables=_distinct_tables()),
    "gray": lambda img: _pil_jpeg(img, gray=True),
}
#: (h, v) factors of Y, Cb, Cr as the SOF states them
SAMPLING = {
    "444": ((1, 1, 1), (1, 1, 1)),
    "422": ((2, 1, 1), (1, 1, 1)),
    "440": ((1, 1, 1), (2, 1, 1)),
    "420_distinct": ((2, 1, 1), (2, 1, 1)),
    "gray": ((1,), (1,)),
}
CASES = [(name, size) for name in LAYOUTS for size in SIZES] + [
    ("444_progressive", SIZES[0])]


def _source(name, size) -> bytes:
    img = make_test_image(*size)
    if name == "444_progressive":
        return _pil_jpeg(img, 0, progressive=True)
    return LAYOUTS[name](img)


def _case_id(case):
    name, (w, h) = case
    return f"{name}-{w}x{h}"


def test_fixtures_have_the_layouts_they_name():
    for name in LAYOUTS:
        hdr = jpeg_abi.parse(loader.load(), _source(name, SIZES[1]))
        assert (tuple(hdr.comp_h), tuple(hdr.comp_v)) == SAMPLING[name], name
        if name == "420_distinct":
            assert len(set(hdr.comp_tq)) == 3
        else:
            assert len(set(hdr.comp_tq[1:])) <= 1
    assert jpeg_abi.parse(loader.load(),
                          _source("444_progressive", SIZES[0])).progressive


# -- ops/weights.py ------------------------------------------------------------


@pytest.mark.parametrize("luma,chroma", [(30, 15), (29, 15), (30, 30),
                                         (1, 1), (2, 1)])
def test_chroma_axis_weights_are_the_reference_upsample(luma, chroma):
    got = weights.chroma_axis_weights(luma, chroma)
    want = ref_dct.upsample_weights(chroma * 8, luma * 8)
    assert got.shape == (luma * 8, chroma * 8)
    assert np.array_equal(got, want)
    if luma == chroma:
        assert np.array_equal(got, np.eye(luma * 8, dtype=np.float32))


@pytest.mark.parametrize("luma,chroma", [(45, 15), (60, 15), (15, 30),
                                         (28, 15)])
def test_chroma_axis_weights_refuse_other_ratios(luma, chroma):
    with pytest.raises(ValueError, match="not 1x or 2x"):
        weights.chroma_axis_weights(luma, chroma)


@pytest.mark.parametrize("samp", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_host_encoder_writes_the_sampling_it_is_given(samp):
    img = make_test_image(75, 43)
    planes, _ = weights.host_encode_rgb_to_coefficients(img, 85, samp)
    data = _native_jpeg(img, samp, 85)
    hdr = jpeg_abi.parse(loader.load(), data)
    assert (hdr.comp_h[0], hdr.comp_v[0]) == samp
    assert tuple(hdr.comp_h[1:]) == tuple(hdr.comp_v[1:]) == (1, 1)
    for c, p in enumerate(planes):
        assert p.shape == (hdr.blocks_h[c], hdr.blocks_w[c], 64)
    # Pillow reads them back close to the source
    assert psnr(_pil_rgb(data), img) >= 25.0


# -- (a) ops/dct.py::decode_components_to_rgb against the JAX head -------------


def _jax_pixel_decode(decoded) -> np.ndarray:
    """The JAX RGB-output head run as the pixel decode of ``decoded``: its
    own identity and upsample stacks at the block grids, zero chroma at the
    4:2:0 grid for grayscale; tables 128 wide, so distinct Cb/Cr tables go
    in dequantised, with unit tables."""
    hdr, coeffs, qtabs = decoded
    if hdr.ncomp == 1:
        by, bx = coeffs[0].shape[:2]
        cz = np.zeros(((by + 1) // 2, (bx + 1) // 2, 64), np.int16)
        coeffs, tq = [coeffs[0], cz, cz], (hdr.comp_tq[0],) * 3
    else:
        tq = tuple(hdr.comp_tq[:3])
    if tq[1] == tq[2]:
        qt = np.concatenate([qtabs[tq[0]], qtabs[tq[1]]]).astype(np.float32)
    else:
        coeffs = [(c.astype(np.int32) * qtabs[t]).astype(np.int16)
                  for c, t in zip(coeffs, tq)]
        qt = np.ones(128, np.float32)
    (by_y, bx_y), (by_c, bx_c) = coeffs[0].shape[:2], coeffs[1].shape[:2]

    def ident(n):
        return ref_resize.padded_weights(n, n, n, n, "nearest")[None]

    stacks = (ident(by_y * 8), ident(bx_y * 8),
              ref_dct.upsample_weights(by_c * 8, by_y * 8)[None],
              ref_dct.upsample_weights(bx_c * 8, bx_y * 8)[None])
    out = ref_dct.decode_resize_rgb_batch(
        coeffs[0].reshape(1, by_y, -1), coeffs[1].reshape(1, by_c, -1),
        coeffs[2].reshape(1, by_c, -1), qt[None], stacks,
        np.zeros(1, np.int32), (by_y, bx_y, by_c, bx_c), (by_y * 8, bx_y * 8))
    return out[0, :hdr.height, :hdr.width]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pixel_decode_matches_jax_head_under_k3(k3_semantics, case):
    name, size = case
    data = _source(name, size)
    want = _jax_pixel_decode(jpeg_abi.decode(loader.load(), data))
    before = resize_planes.LAUNCHES
    got = dct.decode_components_to_rgb(jpeg_abi.decode(loader.load(), data),
                                       device="cpu")
    assert resize_planes.LAUNCHES == before  # the plain version on the CPU
    assert got.dtype == np.uint8 and got.shape == want.shape == (*size[::-1], 3)
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"{name} {size}: max |d| {d.max()}, {(d > 0).sum()} of {d.size} "
          f"values differ")
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE
    if name == "gray":
        assert (got == got[..., :1]).all()  # R = G = B = Y


# -- (b) against Pillow, the reference's serving decode ------------------------


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pixel_decode_matches_pillow(case):
    name, size = case
    data = _source(name, size)
    got = jpeg.decode_rgb(data, device="cpu")
    pil = _pil_rgb(data)
    d = np.abs(got.astype(int) - pil.astype(int))
    print(f"{name} {size}: PSNR {psnr(got, pil):.2f} dB, max |d| {d.max()}")
    assert got.shape == pil.shape and psnr(got, pil) >= 40.0 and d.max() <= 12
    # the entries users call decode the same pixels
    arr, fmt = codecs.decode_bytes(data, device="cpu")
    assert fmt == codecs.SourceFormat.jpeg and np.array_equal(arr, got)
    px, _ = transform.decode_image(data, device="cpu")
    assert np.array_equal(px, got)


def test_transform_bytes_serves_the_layouts():
    img = make_test_image(203, 151)
    for name in LAYOUTS:
        data = LAYOUTS[name](img)
        for w, want in ((64, (64, 48)), (None, (203, 151))):
            out = transform.transform_bytes(data, w, None, ImageFormat.webp,
                                            80, device="cpu")
            assert vp8.dimensions(out) == want, (name, w)


# -- (c) the engines -------------------------------------------------------------


def _run_engines(monkeypatch, data, width, fmt, src_hw):
    """One request through the JAX engine (its RGB head marked compiled
    where it resizes, so that it runs the jitted head and not its host
    mirror) and through the port's on the CPU."""
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    _ref_native_lib(monkeypatch)
    ref = RefEngine(_cfg(ref_config, 1), metrics=RefMetrics())
    if width is not None:
        ow, oh = weights.target_dimensions(src_hw[1], src_hw[0], width, None)
        kind = "rgbjpg" if fmt == ImageFormat.jpeg else "rgbyuv"
        ref._compiled.add((kind, ref._use_mesh(1), 1, bucket_for(src_hw[0]),
                           bucket_for(src_hw[1]), bucket_for(oh),
                           bucket_for(ow), 3))
    (ref_out,) = _drive(ref, [data], [width], fmt)
    port = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    (port_out,) = _drive(port, [data], [width], fmt)
    return ref, port, ref_out, port_out


@pytest.mark.parametrize("fmt", [ImageFormat.webp, ImageFormat.jpeg])
@pytest.mark.parametrize("name,width", [("444", 64), ("422", 64),
                                        ("gray", None)])
def test_engine_matches_jax_engine(monkeypatch, name, width, fmt):
    img = make_test_image(203, 151)
    data = LAYOUTS[name](img)
    ref, port, ref_out, port_out = _run_engines(monkeypatch, data, width, fmt,
                                                (151, 203))
    want = (64, 48) if width else (203, 151)
    assert _out_size(port_out) == _out_size(ref_out) == want
    if fmt == ImageFormat.webp:
        a, b = vp8.decode_rgb(port_out), vp8.decode_rgb(ref_out)
    else:
        a, b = _pil_rgb(port_out), _pil_rgb(ref_out)
    print(f"{name} -> {fmt.value} w={width}: PSNR {psnr(a, b):.2f} dB")
    assert psnr(a, b) >= 38.0
    stages = port.metrics.stage_seconds
    assert stages["entropy_decode"] > 0 and stages["device_decode"] > 0
    assert "device_decode_resize" not in stages  # no JPEG head, no K1
    # the RGB head batches a resized request; one with no resize is encoded
    assert port.metrics.batches == ref.metrics.batches == (1 if width else 0)
    assert ("device_resize" in stages) == (width is not None)


def test_engine_440_and_distinct_tables_to_avif():
    """AVIF output takes the RGB head's yuv kind, then the AV1 encoder."""
    img = make_test_image(96, 64)
    port = PortEngine(_cfg(port_config, 2), metrics=Metrics(), device="cpu")
    outs = _drive(port, [LAYOUTS["440"](img), LAYOUTS["420_distinct"](img)],
                  [48, 48], ImageFormat.avif)
    for out in outs:
        assert out[4:12] == b"ftypavif"
        assert struct.pack(">II", 48, 32) in out[:out.find(b"mdat")]  # ispe
    assert port.metrics.batches == 1
    assert port.metrics.stage_seconds["device_decode"] > 0


def test_engine_beyond_the_ladder_takes_the_exact_path():
    """A 8400x24 4:4:4 JPEG: the pixel decode, then the exact-shape path."""
    data = _pil_jpeg(make_test_image(8400, 24), 0)
    port = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
    (out,) = _drive(port, [data], [2100], ImageFormat.webp)
    assert vp8.dimensions(out) == (2100, 6)
    stages = port.metrics.stage_seconds
    assert stages["device_decode"] > 0 and stages["exact_resize"] > 0
    assert port.metrics.batches == 0
    small = transform.resize_image(_pil_rgb(data), 2100, None, device="cpu")
    assert psnr(vp8.decode_rgb(out), small) >= 30.0


# -- HTTP ------------------------------------------------------------------------


def _serve(tmp_path, sources, fn):
    import asyncio

    urls = {f"https://example.com/{name}.jpg": ("image/jpeg", body)
            for name, body in sources.items()}

    metrics = Metrics()

    async def inner():
        app = create_app(ImageKitConfig(secret=SECRET,
                                        cache_dir=tmp_path / "cache"),
                         fetcher=_OfflineFetcher(urls), metrics=metrics,
                         rate_limit=False, device="cpu")
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client, metrics)
        finally:
            await client.close()

    return asyncio.run(inner())


def test_http_img_and_upload(tmp_path):
    img = make_test_image(160, 120)
    sources = {"s444": LAYOUTS["444"](img), "s422": LAYOUTS["422"](img),
               "gray": LAYOUTS["gray"](img)}

    async def fn(client, metrics):
        params = {"url": "https://example.com/s444.jpg", "w": "64"}
        params["sig"] = sign(params, SECRET)
        r1 = await client.get("/img", params=params)
        body = await r1.read()
        assert r1.status == 200 and vp8.dimensions(body) == (64, 48)
        r2 = await client.get("/img", params=params)
        assert r2.status == 200 and await r2.read() == body
        assert metrics.cache_hits == 1 and metrics.cache_misses == 1
        params = {"url": "https://example.com/gray.jpg", "f": "jpeg"}
        params["sig"] = sign(params, SECRET)
        r3 = await client.get("/img", params=params)
        assert r3.status == 200 and _out_size(await r3.read()) == (160, 120)
        form = FormData()
        form.add_field("file", sources["s422"], filename="camera.jpg")
        form.add_field("w", "80")
        form.add_field("f", "jpeg")
        r4 = await client.post("/upload", data=form)
        assert r4.status == 200 and _out_size(await r4.read()) == (80, 60)

    _serve(tmp_path, sources, fn)


# -- (d) what stays 501 ------------------------------------------------------------


def _cmyk_progressive() -> bytes:
    """A progressive CMYK JPEG in arithmetic coding (Pillow's Huffman one
    with its SOF2 marker made SOF10): the QM decoder reads its Huffman bits
    as libjpeg's does."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).convert("CMYK").save(
        buf, "JPEG", progressive=True)
    data = buf.getvalue()
    at = data.index(b"\xff\xc2")
    return data[:at + 1] + b"\xca" + data[at + 2:]


def _sof_patched(offset_in_sof: int, value: int, marker=None) -> bytes:
    """A 4:2:0 JPEG with one byte of its SOF0 segment (or its marker)
    changed."""
    data = bytearray(_native_jpeg(make_test_image(64, 48), (2, 2)))
    at = data.index(b"\xff\xc0")
    if marker is not None:
        data[at + 1] = marker
    else:
        data[at + 4 + offset_in_sof] = value
    return bytes(data)


def _mixed_chroma() -> bytes:
    """Y 2x2, Cb 1x1, Cr 2x1: the native encoder writes any factors 1-2."""
    planes = [np.zeros((6, 8, 64), np.int16), np.zeros((3, 4, 64), np.int16),
              np.zeros((3, 8, 64), np.int16)]
    for p in planes:
        p[..., 0] = 7
    q = np.ones(64, np.uint16)
    return jpeg_abi.encode(loader.load(), planes, (q, q), 64, 48,
                           ((2, 2), (1, 1), (2, 1)))


def _lossless(ncomp: int, marker: int = 0xC3) -> bytes:
    """A lossless JPEG (``tests/fixtures/jpeg_lossless_writer.py``) of
    ``ncomp`` components at 1x1, its SOF3 marker made ``marker``."""
    from tests.fixtures import jpeg_lossless_writer

    img = make_test_image(64, 48)
    planes = jpeg_lossless_writer.subsample(
        np.dstack([img, img[:, :, 1]])[:, :, :ncomp], [(1, 1)] * ncomp)
    data = bytearray(jpeg_lossless_writer.write(planes, 64, 48,
                                                [(1, 1)] * ncomp))
    data[data.index(b"\xff\xc3") + 1] = marker
    return bytes(data)


NOT_PORTED = {
    "cmyk_progressive": _cmyk_progressive,
    "12bit": lambda: _sof_patched(0, 12),
    "arithmetic": lambda: _sof_patched(0, 0, marker=0xC9),
    "mixed_chroma": _mixed_chroma,
    "lossless_cmyk": lambda: _lossless(4),
    "lossless_arithmetic": lambda: _lossless(3, marker=0xCB),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_layouts_outside_the_decode_stay_not_ported(name):
    """Cb and Cr sampled differently and arithmetic coding (progressive
    CMYK among it: Huffman bits behind SOF9 and SOF10, which the QM
    decoder reads as libjpeg's does) decode, to the pixels Pillow gives,
    with a resize and without (the name is kept from when arithmetic
    coding answered 501). A lossless CMYK frame stays 501 naming its queue
    item. A 12-bit frame is Pillow's "cannot identify image file", and a
    lossless arithmetic one (SOF11) libjpeg's refusal, "broken data
    stream", in the decode and both engine paths (400, as the reference
    answers)."""
    data = NOT_PORTED[name]()
    if name in ("mixed_chroma", "arithmetic", "cmyk_progressive"):
        got = jpeg.decode_rgb(data, device="cpu")
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert got.shape == want.shape == (48, 64, 3)
        assert psnr(got, want) >= 40.0
        assert np.abs(got.astype(int) - want).max() <= 12
        for width in (64, None):
            engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                                device="cpu")
            (out,) = _drive(engine, [data], [width], ImageFormat.webp)
            assert _out_size(out) == (64, 48)
        return
    if name == "12bit":
        raised, match = TransformError, "cannot identify image file"
    elif name == "lossless_arithmetic":
        raised, match = TransformError, "broken data stream"
    else:
        raised, match = NotPortedError, "queue 1 item 10"
    with pytest.raises(raised, match=match) as e:
        jpeg.decode_rgb(data, device="cpu")
    assert isinstance(e.value, NotPortedError) == (raised is NotPortedError)
    for width in (64, None):
        engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                            device="cpu")
        with pytest.raises(raised, match=match) as e:
            _drive(engine, [data], [width], ImageFormat.webp)
        if raised is NotPortedError:
            assert e.value.roadmap_item == "queue 1 item 10"
        else:
            assert not isinstance(e.value, NotPortedError)


def test_411_header_is_not_ported():
    """4:1:1 (a chroma ratio of 4): the decoded tuple of a 4:2:2 JPEG given
    a 4:1:1 header and grid (zero luma at twice the width) is a 4:1:1
    frame; the pixel decode replicates its chroma 4x across, as libjpeg's
    ``int_upsample`` does, and agrees with Pillow on the same coefficients
    written as a file (``tests/fixtures/jpeg_writer.py``)."""
    from tests.fixtures import jpeg_writer

    hdr, coeffs, qtabs = jpeg_abi.decode(loader.load(),
                                         _pil_jpeg(make_test_image(64, 48), 1))
    hdr = dataclasses.replace(hdr, comp_h=(4, 1, 1), hmax=4, width=128,
                              comp_width=(128, 32, 32))
    by, bx = coeffs[0].shape[:2]
    coeffs = [np.zeros((by, 2 * bx, 64), np.int16), coeffs[1], coeffs[2]]
    got = jpeg.components_to_rgb((hdr, coeffs, qtabs), device="cpu")
    data = jpeg_writer.write(coeffs, qtabs, 128, 48,
                             ((4, 1), (1, 1), (1, 1)), hdr.comp_tq)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.shape == want.shape == (48, 128, 3)
    assert psnr(got, want) >= 40.0
    assert np.abs(got.astype(int) - want).max() <= 12
    # replication: each chroma sample over four columns
    assert (got[:, 0::4] == got[:, 3::4]).mean() > 0.99
