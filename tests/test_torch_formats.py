"""GIF, BMP, TIFF, Radiance HDR and farbfeld sources in the port, against the
JAX package, on the CPU.

- The decoders (``codecs/misc.py``, ``codecs/tiff.py``, ``codecs/longtail.py``
  on the port's copies of ``misc_decode.cpp`` and ``tiff_decode.cpp``) are
  byte-equal to the reference's on the same bytes. Pillow writes most of the
  inputs here; the port's modules never import it (a subprocess checks).
- Where the reference's native decoder returns None and falls to Pillow, the
  port raises ``NotPortedError``; corrupt data is a ``TransformError`` where
  the reference raises ``ValueError``. ICO, QOI, PNM and DDS, which the
  reference decodes only with Pillow, have decoders of the port's own
  (``tests/test_torch_pillow_sources.py`` holds them to it); a file that is
  no more than their magic is the reference's ``TransformError`` here too.
- The slice: a GIF, a BMP and a TIFF through the JAX engine and the port's
  engine to WebP (3 channels: the fused head; a GIF with transparency: the
  plain head), the planes each hands its encoder compared within the band
  of ``tests/test_torch_rgba_slice.py``.
- HTTP: a truncated GIF or TIFF, and a JPEG cut before its SOS marker,
  answer ``/img`` with the fetch stage's body in both apps; an ICO is
  served; lossless CMYK JPEGs answer 501, 12-bit ones 400 as in the
  reference; EXR answers 400.
"""

import io
import json
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import longtail as ref_longtail
from imagekit_tpu.codecs import misc as ref_misc
from imagekit_tpu.codecs import tiff as ref_tiff
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch import codecs, fetch
from imagekit_tpu_torch.codecs import avif_encode, longtail, misc, png, tiff, vp8
from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
from imagekit_tpu_torch.errors import (
    InvalidArgumentError,
    NotPortedError,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.signature import sign
from tests.conftest import make_test_image
from tests.test_longtail_formats import (
    _farbfeld,
    _hdr_new_rle,
    _hdr_old_flat,
    _rand_rgbe,
)
from tests.test_tiff import _be_gray_tiff, _craft_planar, _craft_tiled
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_rgba_slice import _capture, _diff, run_both_plain
from tests.test_torch_webp_slice import _Body, _CannedFetcher

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock, and a
    worker whose first load meets another's half-written build would
    decode through Pillow alone)."""
    _ref_native_lib(monkeypatch)


def _save(arr_or_img, fmt, **kw) -> bytes:
    im = (arr_or_img if isinstance(arr_or_img, Image.Image)
          else Image.fromarray(arr_or_img))
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _rgb(w=83, h=57, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _rgba(w=83, h=57, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)


def _gif(transparency=None, interlace=False, h=57):
    im = Image.fromarray(_rgb(h=h)).quantize(64)
    kw = {"interlace": interlace}
    if transparency is not None:
        kw["transparency"] = transparency
    return _save(im, "GIF", **kw)


def _bmp32():
    """A 32 bpp BI_RGB bottom-up BMP, written by hand."""
    px = _rgba(40, 30)
    rows = px[::-1, :, [2, 1, 0, 3]].tobytes()
    hdr = struct.pack("<IiiHHIIiiII", 40, 40, 30, 1, 32, 0, len(rows), 2835,
                      2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + len(rows), 0, 0, 54) + hdr
            + rows)


def _tiff16():
    g16 = np.random.default_rng(6).integers(0, 65535, (25, 31), np.uint16)
    im = Image.new("I;16", (31, 25))
    im.frombytes(g16.astype("<u2").tobytes())
    return _save(im, "TIFF")


SOURCES = {
    "gif": lambda: _gif(),
    "gif_interlaced": lambda: _gif(interlace=True, h=61),
    "gif_transparent": lambda: _gif(transparency=3),
    "bmp24": lambda: _save(_rgb(), "BMP"),
    "bmp_palette": lambda: _save(Image.fromarray(_rgb()).quantize(32), "BMP"),
    "bmp32": _bmp32,
    "tiff_rgb": lambda: _save(_rgb(), "TIFF"),
    "tiff_rgba_lzw": lambda: _save(_rgba(), "TIFF", compression="tiff_lzw"),
    "tiff_gray_packbits": lambda: _save(
        Image.fromarray(_rgb()).convert("L"), "TIFF", compression="packbits"),
    "tiff_palette": lambda: _save(Image.fromarray(_rgb()).quantize(16), "TIFF"),
    "tiff_deflate": lambda: _save(_rgb(), "TIFF", compression="tiff_adobe_deflate"),
    "tiff_big_endian": lambda: _be_gray_tiff(_rgb()[:, :, 0].copy()),
    "tiff_tiled_lzw": lambda: _craft_tiled(_rgb(50, 37), 16, 16, 5),
    "tiff_planar": lambda: _craft_planar(_rgb(50, 37), 8, 1),
    "tiff_16bit": _tiff16,
    "hdr_rle": lambda: _hdr_new_rle(_rand_rgbe()),
    "hdr_flat": lambda: _hdr_old_flat(_rand_rgbe(seed=2)),
    "farbfeld": lambda: _farbfeld(_rgba(21, 13)),
}


def _ref_decoder(name):
    if name.startswith("gif"):
        return ref_misc.decode_gif
    if name.startswith("bmp"):
        return ref_misc.decode_bmp
    if name.startswith("tiff"):
        return ref_tiff.decode
    return (ref_longtail.decode_farbfeld if name == "farbfeld"
            else ref_longtail.decode_hdr)


def _port_decoder(name):
    if name.startswith("gif"):
        return misc.decode_gif
    if name.startswith("bmp"):
        return misc.decode_bmp
    if name.startswith("tiff"):
        return tiff.decode
    return (longtail.decode_farbfeld if name == "farbfeld"
            else longtail.decode_hdr)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_decoder_byte_equal_to_reference(name):
    data = SOURCES[name]()
    want = _ref_decoder(name)(data)
    assert want is not None, "the reference's native decoder takes this one"
    got = _port_decoder(name)(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    # the dispatchers route it the same way
    arr, fmt = codecs.decode_bytes(data, device="cpu")
    ref_arr, ref_fmt = ref_codecs.decode_bytes(data)
    assert fmt.value == ref_fmt.value and np.array_equal(arr, ref_arr)
    assert got.shape[2] == (4 if name in (
        "gif_transparent", "tiff_rgba_lzw", "farbfeld") else 3)


@pytest.mark.parametrize("name", ["gif", "bmp24", "tiff_rgba_lzw"])
def test_header_parse_gives_the_decoded_geometry(name):
    data = SOURCES[name]()
    parse = {"gif": misc.parse_gif, "bmp24": misc.parse_bmp,
             "tiff_rgba_lzw": tiff.parse}[name]
    h, w, ch = _port_decoder(name)(data).shape
    assert parse(data) == (w, h, ch)


def _cmyk_tiff():
    return _save(Image.fromarray(_rgba()).convert("CMYK"), "TIFF")


def _bitfields_bmp():
    """A 16 bpp BI_BITFIELDS BMP."""
    rows = np.zeros((8, 8), "<u2").tobytes()
    hdr = struct.pack("<IiiHHIIiiII", 40, 8, 8, 1, 16, 3, len(rows), 2835,
                      2835, 0, 0)
    masks = struct.pack("<III", 0xF800, 0x07E0, 0x001F)
    return (b"BM" + struct.pack("<IHHI", 66 + len(rows), 0, 0, 66) + hdr
            + masks + rows)


@pytest.mark.parametrize("name,make,ref_decode,decode", [
    ("tiff_cmyk", _cmyk_tiff, ref_tiff.decode, tiff.decode),
    ("bmp_bitfields", _bitfields_bmp, ref_misc.decode_bmp, misc.decode_bmp),
])
def test_variant_the_native_decoder_refuses_is_not_ported(name, make,
                                                          ref_decode, decode):
    """None in the reference (then Pillow). The name is kept from when the
    port answered these 501: the port's own decoder of the layouts the
    pinned one refuses (``bmp_ext_decode.cpp``, ``tiff_ext_decode.cpp``)
    now gives Pillow's pixels, through the module and the dispatcher."""
    data = make()
    assert ref_decode(data) is None
    want = ref_codecs.decode_bytes(data)[0]
    got = decode(data, device="cpu") if decode is tiff.decode else decode(data)
    assert np.array_equal(got, want)
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], want)


@pytest.mark.parametrize("name", ["gif", "tiff_rgba_lzw", "bmp24"])
def test_corrupt_data_is_a_transform_error(name):
    data = SOURCES[name]()
    cut = data[: len(data) // 3]
    with pytest.raises(ValueError) as ref_e:
        _ref_decoder(name)(cut)
    with pytest.raises(TransformError) as e:
        _port_decoder(name)(cut)
    assert not isinstance(e.value, NotPortedError)
    assert e.value.message == str(ref_e.value)


def test_pixel_ceiling_is_the_constant(monkeypatch):
    """The decompression-bomb guard is ``png.MAX_PIXELS`` (the reference
    asks Pillow for the same figure), applied after the header parse."""
    assert misc.MAX_PIXELS == png.MAX_PIXELS == 2 * 89_478_485
    monkeypatch.setattr(misc, "MAX_PIXELS", 83 * 57 - 1)
    for name in ("gif", "bmp24", "tiff_rgb"):
        with pytest.raises(TransformError, match="too large"):
            _port_decoder(name)(SOURCES[name]())


@pytest.mark.parametrize("magic,status", [
    (b"\x00\x00\x01\x00" + b"\0" * 32, 400), (b"qoif" + b"\0" * 32, 400),
    (b"P6\n2 2\n255\n" + b"\0" * 12, 200), (b"DDS " + b"\0" * 128, 400),
    (b"\x76\x2f\x31\x01" + b"\0" * 32, 400),
], ids=["ico", "qoi", "pnm", "dds", "exr"])
def test_pillow_only_formats_answer_as_decided(magic, status):
    """ICO, QOI, PNM and DDS are Pillow's in the reference and the port's
    own decoders' here: a header with nothing behind it is the reference's
    TransformError (an ICO of no entries, a QOI of width 0, a DDS header of
    size 0), and the 2x2 PPM of zeros decodes to the reference's pixels.
    EXR is a TransformError in both."""
    if status == 200:
        got, fmt = codecs.decode_bytes(magic, device="cpu")
        want, ref_fmt = ref_codecs.decode_bytes(magic)
        assert fmt.value == ref_fmt.value and np.array_equal(got, want)
        return
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(magic)
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(magic, device="cpu")
    assert not isinstance(e.value, NotPortedError)
    if magic.startswith(b"\x76"):
        assert e.value.message == "EXR input is not supported"


def test_format_modules_never_import_pil():
    script = textwrap.dedent("""
        import json, sys
        from imagekit_tpu_torch import codecs
        out = codecs.decode_bytes(sys.stdin.buffer.read(), device="cpu")[0]
        from imagekit_tpu_torch.codecs import longtail, misc, tiff
        print(json.dumps({"shape": list(out.shape), "bad": sorted(
            m for m in sys.modules if m.split(".")[0] in
            ("PIL", "jax", "imagekit_tpu"))}))
    """)
    proc = subprocess.run([sys.executable, "-c", script],
                          input=SOURCES["tiff_rgba_lzw"](), capture_output=True,
                          timeout=300, check=True, cwd=ROOT)
    res = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    assert res == {"shape": [57, 83, 4], "bad": []}


# -- the slice ---------------------------------------------------------------------


def _photo_like(kind):
    img = make_test_image(321, 241)
    if kind == "gif":
        return _save(Image.fromarray(img).quantize(128), "GIF")
    if kind == "gif_transparent":
        return _save(Image.fromarray(img).quantize(64), "GIF", transparency=5)
    if kind == "bmp":
        return _save(img, "BMP")
    return _save(img, "TIFF", compression="tiff_lzw")


@pytest.mark.parametrize("kind", ["gif", "bmp", "tiff", "gif_transparent"])
def test_engine_matches_jax_engine(monkeypatch, kind):
    """One source through both engines to a 99 px WebP: the fused rgbyuv
    head for 3 channels, the plain head for the GIF with transparency."""
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine
    from imagekit_tpu.utils.bucketing import bucket_for
    from tests.test_torch_jxc_slice import _ref_native_lib
    from tests.test_torch_rgba_slice import _cfg, _drive
    from imagekit_tpu_torch import config as port_config

    data = _photo_like(kind)
    got = _capture(monkeypatch)
    if kind == "gif_transparent":
        ref_out, port_out = run_both_plain(
            monkeypatch, [data], [99], ImageFormat.webp, (241, 321), (74, 99))
    else:
        _ref_native_lib(monkeypatch)
        ref = RefEngine(_cfg(ref_config, 1), metrics=RefMetrics())
        ref._compiled.add(("rgbyuv", ref._use_mesh(1), 1, bucket_for(241),
                           bucket_for(321), bucket_for(74), bucket_for(99), 3))
        ref_out = _drive(ref, [data], [99], ImageFormat.webp)
        assert ref.metrics.host_fallbacks == 0 and ref.metrics.batches == 1
        port = PortEngine(_cfg(port_config, 1), metrics=Metrics(), device="cpu")
        port_out = _drive(port, [data], [99], ImageFormat.webp)
        assert port.metrics.batches == 1
        assert port.metrics.stage_seconds["decode"] > 0
    assert vp8.dimensions(ref_out[0]) == vp8.dimensions(port_out[0]) == (99, 74)
    ((want_planes, got_planes),) = got.values()
    n = sum(_diff(g_, w_, f"{kind} {name}")
            for name, w_, g_ in zip("yuv", want_planes, got_planes))
    if n == 0:
        assert ref_out == port_out


# -- fetch and HTTP ------------------------------------------------------------------

SECRET = "test-secret-key"
URLS = {name: f"https://example.com/{name}" for name in (
    "ok.gif", "cut.gif", "cut.tiff", "ok.bmp", "ok.tiff", "x.ico",
    "cut_sos.jpg", "12bit.jpg", "arithmetic.jpg", "lossless_cmyk.jpg",
    "sof11.jpg")}


def _cut_before_sos() -> bytes:
    """A q80 JPEG cut 10 bytes before its SOS marker: its header does not
    parse."""
    data = _save(make_test_image(160, 120), "JPEG", quality=80)
    return data[:data.index(b"\xff\xda") - 10]


def _canned():
    from tests.test_torch_jpeg_layouts import _lossless, _sof_patched

    gif = _photo_like("gif")
    tif = _photo_like("tiff")
    icon = Image.fromarray(np.dstack([make_test_image(96, 96),
                                      _rgb(96, 96)[:, :, 0]]))
    return {
        URLS["cut_sos.jpg"]: ("image/jpeg", _cut_before_sos()),
        URLS["12bit.jpg"]: ("image/jpeg", _sof_patched(0, 12)),
        URLS["arithmetic.jpg"]: ("image/jpeg",
                                 _sof_patched(0, 0, marker=0xC9)),
        URLS["lossless_cmyk.jpg"]: ("image/jpeg", _lossless(4)),
        URLS["sof11.jpg"]: ("image/jpeg", _lossless(3, marker=0xCB)),
        URLS["ok.gif"]: ("image/gif", gif),
        URLS["cut.gif"]: ("image/gif", gif[: len(gif) // 2]),
        URLS["cut.tiff"]: ("image/tiff", tif[: len(tif) // 2]),
        URLS["ok.bmp"]: ("image/bmp", _photo_like("bmp")),
        URLS["ok.tiff"]: ("image/tiff", tif),
        URLS["x.ico"]: ("image/x-icon", _save(icon, "ICO",
                                              sizes=[(32, 32), (96, 96)])),
    }


def _serve(tmp_path, which, fn):
    import asyncio

    async def inner():
        if which == "port":
            from imagekit_tpu_torch.serving.app import create_app

            app = create_app(
                ImageKitConfig(secret=SECRET, cache_dir=tmp_path / which),
                fetcher=_CannedFetcher(_canned()), metrics=Metrics(),
                rate_limit=False, device="cpu")
        else:
            from imagekit_tpu.serving.app import create_app

            app = create_app(
                ref_config.ImageKitConfig(secret=SECRET,
                                          cache_dir=tmp_path / which),
                fetcher=_CannedFetcher(_canned()), metrics=RefMetrics(),
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


@pytest.mark.parametrize("name", ["cut.gif", "cut.tiff", "cut_sos.jpg"])
def test_http_truncated_source_answers_as_the_reference(tmp_path, name):
    """The reference decodes such a source in full at its fetch stage; the
    port validates the header there, decodes once in the engine, and
    answers with the fetch stage's body. A JPEG whose header does not parse
    fails at the port's fetch stage itself (the reference's fetch falls
    through to Pillow, which fails too), at w=64 and with no resize."""
    widths = (64, None) if name.endswith(".jpg") else (32,)

    async def fn(client):
        return [await _img(client, url=URLS[name], **(
            {"w": w} if w else {})) for w in widths]

    ref = _serve(tmp_path, "ref", fn)
    port = _serve(tmp_path, "port", fn)
    assert port == ref
    for status, _, body in port:
        assert status == 400
        assert body == b"Invalid argument: Unable to decode image for validation"


@pytest.mark.parametrize("name", ["12bit.jpg", "arithmetic.jpg",
                                  "lossless_cmyk.jpg", "sof11.jpg"])
def test_http_unsupported_jpeg_coding_answers_501(tmp_path, name):
    """With a resize and without: a lossless CMYK JPEG, which answered 501
    here, is served by both apps, its pixels exactly Pillow's. The
    hand-patched arithmetic file, whose scan is Huffman
    behind SOF9, answers 200 in both apps now, the QM decoder reading it as
    libjpeg's does (the name is kept from when these answered 501). A 12-bit
    JPEG and a lossless arithmetic one (SOF11) answer as the reference
    does: Pillow opens 8-bit frames only, and libjpeg refuses SOF11, so its
    fetch stage answers 400, and so does the port's."""
    async def fn(client):
        return [await _img(client, url=URLS[name], **({"w": w} if w else {}))
                for w in (64, None)]

    port = _serve(tmp_path, "port", fn)
    if name in ("12bit.jpg", "sof11.jpg"):
        assert port == _serve(tmp_path, "ref", fn)
        for status, _, body in port:
            assert status == 400
            assert body == (b"Invalid argument: Unable to decode image for "
                            b"validation")
        return
    if name in ("arithmetic.jpg", "lossless_cmyk.jpg"):
        ref = _serve(tmp_path, "ref", fn)
        for (ps, pct, pbody), (rs, rct, rbody) in zip(port, ref):
            assert (ps, pct) == (rs, rct) == (200, "image/webp")
            a, b = vp8.decode_rgb(pbody), vp8.decode_rgb(rbody)
            assert a.shape == b.shape
            err = ((a.astype(float) - b) ** 2).mean()
            assert err == 0 or 10 * np.log10(255.0 ** 2 / err) >= 38.0


@pytest.mark.parametrize("name", ["ok.gif", "ok.bmp", "ok.tiff"])
def test_http_serves_gif_bmp_tiff(tmp_path, name):
    async def fn(client):
        return await _img(client, url=URLS[name], w=64)

    for which in ("port", "ref"):
        status, ct, body = _serve(tmp_path, which, fn)
        assert (status, ct) == (200, "image/webp"), (which, body[:200])
        assert vp8.dimensions(body) == (64, 48)


def test_http_pillow_only_source_answers_501(tmp_path):
    """An ICO, which the reference decodes only with Pillow, is served by
    the port's own decoder now (the name is kept from when it answered
    501): its largest entry, 96x96, to a 64 px WebP in both apps."""
    async def fn(client):
        return await _img(client, url=URLS["x.ico"], w=64)

    for which in ("port", "ref"):
        status, ct, body = _serve(tmp_path, which, fn)
        assert (status, ct) == (200, "image/webp"), (which, body[:200])
        assert vp8.dimensions(body) == (64, 64)


def test_fetch_validates_by_header_and_engine_raises_source_decode_error():
    import asyncio

    canned = _canned()

    async def run():
        ok = await fetch.fetch_source(URLS["ok.gif"], 1 << 24,
                                      fetcher=_CannedFetcher(canned))
        assert ok[0] == canned[URLS["ok.gif"]][1]
        with pytest.raises(InvalidArgumentError, match="validation"):
            await fetch.fetch_source("bad", 1 << 24, fetcher=_CannedFetcher(
                {"bad": ("image/gif", b"GIF89a\x00")}))
        # an ICO is validated by its header now, and one with no entries
        # fails there; an AVIF is probed for its dimensions as the
        # reference probes it (``fetch.py:172-183``): one the probe cannot
        # place fails here, as it fails the reference's full decode, and a
        # whole one is left to the engine
        ico = await fetch.fetch_source(URLS["x.ico"], 1 << 24,
                                       fetcher=_CannedFetcher(canned))
        assert ico[0].startswith(b"\x00\x00\x01\x00")
        with pytest.raises(InvalidArgumentError, match="validation"):
            await fetch.fetch_source("bad", 1 << 24, fetcher=_CannedFetcher(
                {"bad": ("image/x-icon", b"\x00\x00\x01\x00" + b"\0" * 64)}))
        with pytest.raises(InvalidArgumentError, match="validation"):
            await fetch.fetch_source("avif", 1 << 24, fetcher=_CannedFetcher(
                {"avif": ("image/avif", b"\0\0\0\x1cftypavif" + b"\0" * 64)}))
        avif = avif_encode.encode_rgb(make_test_image(32, 24), 70)
        left = await fetch.fetch_source("avif", 1 << 24, fetcher=_CannedFetcher(
            {"avif": ("image/avif", avif)}))
        assert left[0] == avif
        engine = PortEngine(metrics=Metrics(), device="cpu")
        try:
            with pytest.raises(SourceDecodeError):
                await engine.decode(canned[URLS["cut.gif"]][1])
        finally:
            await engine.close()

    asyncio.run(run())
    assert _Body(b"x")  # the canned body type both packages' fetch reads
