"""The port's JPEG -> JPEG slice on the CPU, against the JAX package.

- ``combined_chroma_weights`` / ``combined_chroma_half_weights`` are
  byte-equal to the JAX builders over the slice's bucket geometries.
- ``ops.dct.transcode_i8_batch`` against the JAX ``transcode_i8_batch``
  (its einsum kernel), k in {2, 4, 8}, on seeded split-int8 inputs with the
  escapes live: int16 levels EXACT, as the reference's own CPU pin
  (tests/test_pallas_jpeg8.py:117).
- ``ops.dct.decode_resize_rgb_batch`` (the demoted RGB head, K3's plain
  version) against the JAX head run with K3's semantics on a real JPEG: u8
  RGB within max |d| <= 2 on at most 0.1% of values. The resized planes
  are K3's, within its band of +-1 (fp32 sums of ~1000 terms taken in
  another order than XLA's), and the YCbCr -> RGB matrix scales a step of
  a chroma plane by up to 1.772: one such step is a 2 in B (seen: one
  value).
- The port's ``BatchedEngine(device="cpu")`` against the JAX engine with
  the batch's signature marked compiled (so that it runs its device head,
  not its cold-shape host mirror): the levels handed to the JPEG encoder are EXACT
  at w=400 (k=2) and w=1280 (k=8) from 1080p sources, at k=4, and for a
  grayscale source; an escape-dense JPEG takes the RGB head, whose RGB is
  within the band of the JAX head under K3's semantics.
- A 4:4:4 JPEG leaves the JPEG heads for the JPEG pixel decode and the
  RGB head, as the reference's leaves them for Pillow.

K3's semantics: the reference's ``dct._rgb_tail`` takes K3 on its
accelerator (which rounds each resized plane to u8) and an einsum without
that rounding on the CPU. The port serves K3's semantics at every shape, so
the JAX head is run here with ``_pallas_ok`` returning True and
``pallas_resize_u8`` replaced by ``_resize_planes_einsum``, K3's own plain
reference; jax's caches are cleared around it because the jitted head may
have been traced with the real branch by another test.
"""

import asyncio
import struct

import numpy as np
import pytest

from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs.native import loader as ref_loader
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.serving.batch_types import _cached_weights
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops import dct, jpeg8, resize_planes
from imagekit_tpu_torch.ops import weights as port_w
from imagekit_tpu_torch.ops.weights import pad128
from imagekit_tpu_torch.serving import engine_jpeg
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.utils.bucketing import batch_bucket, bucket_for
from tests.conftest import encode_jpeg_pil, make_test_image
from tests.test_batcher import _noisy_jpeg
from tests.test_torch_cuda import _inputs as _lowfreq_inputs
from tests.test_torch_resize import assert_band


# -- the weights -----------------------------------------------------------------

# (source w, h, target w): the slice's 1080p pair at w=400 and w=1280, and
# smaller ladder pairs, odd sides included
CHROMA_GEOMS = [(1920, 1080, 400), (1920, 1080, 1280), (1280, 720, 256),
                (641, 479, 160), (320, 240, 200)]


@pytest.mark.parametrize("geom", CHROMA_GEOMS)
def test_combined_chroma_weights_byte_equal(geom):
    iw, ih, tw = geom
    ow, oh = port_w.target_dimensions(iw, ih, tw, None)
    yb_h = bucket_for((ih + 15) // 16 * 16)
    yb_w = bucket_for((iw + 15) // 16 * 16)
    obh, obw = bucket_for(oh), bucket_for(ow)
    for true, full, out, cb, ob in (((ih + 1) // 2, ih, oh, yb_h // 2, obh),
                                    ((iw + 1) // 2, iw, ow, yb_w // 2, obw)):
        for name, half in (("combined_chroma_weights", 1),
                           ("combined_chroma_half_weights", 2)):
            got = getattr(port_w, name)(true, full, out, cb, ob // half)
            want = getattr(ref_dct, name)(true, full, out, cb, ob // half)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), (name, true, out)


# -- the transcode head ------------------------------------------------------------


def _k8_inputs(seed, B=3, U=4, by=16, bx=32, obh=64, obw=128):
    """Seeded k=8 split batch in the engine's block-grouped layout, escapes
    live, and yuv-kind stacks (chroma to half output resolution) that keep
    the output mostly unclipped."""
    rng = np.random.default_rng(seed)
    cy, cx = by // 2, bx // 2
    y_dc = rng.integers(-300, 300, (B, by, pad128(bx))).astype(np.int16)
    c_dc = rng.integers(-300, 300, (B, cy, pad128(cx))).astype(np.int16)
    y_ac = rng.integers(-20, 20, (B, by, pad128(bx * 63))).astype(np.int8)
    cb_ac = rng.integers(-20, 20, (B, cy, pad128(cx * 63))).astype(np.int8)
    cr_ac = rng.integers(-20, 20, (B, cy, pad128(cx * 63))).astype(np.int8)
    ey_idx = np.zeros((port_w.LOWFREQ_ESC_Y, 3), np.int32)
    ey_val = np.zeros(port_w.LOWFREQ_ESC_Y, np.int32)
    ey_idx[:4] = [[0, 2, 3], [1, 5, 63 + 7], [2, 0, 0], [0, by - 1, 2 * 63]]
    ey_val[:4] = [300, -250, 128, -512]
    eb_idx = np.zeros((port_w.LOWFREQ_ESC_C, 3), np.int32)
    eb_val = np.zeros(port_w.LOWFREQ_ESC_C, np.int32)
    eb_idx[:2] = [[0, 1, 2], [2, cy - 1, 63 + 1]]
    eb_val[:2] = [212, -300]
    er_idx = np.zeros((port_w.LOWFREQ_ESC_C, 3), np.int32)
    er_val = np.zeros(port_w.LOWFREQ_ESC_C, np.int32)
    qt = (rng.random((B, 128)) * 8 + 1).astype(np.float32)

    def w(o, n):
        m = rng.random((U, o, n * 8)).astype(np.float32)
        return m / m.sum(axis=2, keepdims=True)

    vidx = (np.arange(B) % U).astype(np.int32)
    return ((y_dc, c_dc, c_dc), (y_ac, cb_ac, cr_ac),
            ((ey_idx, ey_val), (eb_idx, eb_val), (er_idx, er_val)), qt,
            (w(obh, by), w(obw, bx), w(obh // 2, cy), w(obw // 2, cx)), vidx,
            (by, bx, cy, cx), (obh, obw))


def _transcode_args(k, seed):
    if k == 8:
        dcs, acs, escs, qt, ws, vidx, bd, os_ = _k8_inputs(seed)
    else:
        a, bd = _lowfreq_inputs(k, seed=seed)
        dcs, acs = (a[0], a[2], a[4]), (a[1], a[3], a[5])
        escs = ((a[6], a[7]), (a[8], a[9]), (a[10], a[11]))
        qt, ws, vidx, os_ = a[12], tuple(a[13:17]), a[17], (64, 128)
    qt_out = (np.random.default_rng(seed + 1).random((3, 128)) * 20 + 1
              ).astype(np.float32)
    return [dcs, acs, escs, qt, qt_out, ws, vidx, bd, os_, k]


@pytest.mark.parametrize("k", [2, 4, 8])
def test_transcode_levels_exact_against_jax(monkeypatch, k):
    monkeypatch.setenv("IMAGEKIT_PALLAS_JXC", "")  # the einsum kernel
    args = _transcode_args(k, seed=20 + k)
    want = ref_dct.transcode_i8_batch(*args)
    before = jpeg8.LAUNCHES
    got = dct.transcode_i8_batch(*args, device="cpu")
    assert jpeg8.LAUNCHES == before  # the CPU takes K1's plain version
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.int16 and g.shape == w.shape, name
        assert np.array_equal(g, w), (name, int(np.abs(
            g.astype(int) - w.astype(int)).max()))
    # the escape residuals are live: without them the levels change
    args[2] = tuple((np.zeros_like(i), np.zeros_like(v)) for i, v in args[2])
    without = dct.transcode_i8_batch(*args, device="cpu")
    assert any((a != b).any() for a, b in zip(got, without))
    assert (got[0][..., 1:] != 0).mean() > 0.02  # AC levels, not only DC


# -- the RGB head under K3's semantics ------------------------------------------------


def assert_rgb_band(got, want):
    """RGB within max |d| <= 2 on at most 0.1% of values (module docstring)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 2 and (d > 0).mean() <= 1e-3, (int(d.max()),
                                                     float((d > 0).mean()))


@pytest.fixture
def k3_semantics(monkeypatch):
    """The JAX RGB head with K3 on every plane (see the module docstring)."""
    import jax

    from imagekit_tpu.ops.pallas import resize_kernel

    jax.clear_caches()
    monkeypatch.setattr(resize_kernel, "_pallas_ok", lambda: True)
    monkeypatch.setattr(resize_kernel, "pallas_resize_u8",
                        resize_kernel._resize_planes_einsum)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_decode_resize_rgb_matches_jax_under_k3(k3_semantics):
    data = encode_jpeg_pil(make_test_image(640, 480), 90)
    hdr, coeffs, qtabs = jpeg_abi.decode(loader.load(), data)
    ow, oh = port_w.target_dimensions(640, 480, 240, None)
    yb_h, yb_w, obh, obw = (bucket_for(480), bucket_for(640), bucket_for(oh),
                            bucket_for(ow))
    by, bx, cy, cx = yb_h // 8, yb_w // 8, yb_h // 16, yb_w // 16
    y = np.zeros((2, by, bx * 64), np.int16)
    cb = np.zeros((2, cy, cx * 64), np.int16)
    cr = np.zeros((2, cy, cx * 64), np.int16)
    y[1, :60, :80 * 64] = coeffs[0].reshape(60, -1)
    cb[1, :30, :40 * 64] = coeffs[1].reshape(30, -1)
    cr[1, :30, :40 * 64] = coeffs[2].reshape(30, -1)
    qt = np.zeros((2, 128), np.float32)
    qt[:, :64], qt[:, 64:] = qtabs[hdr.comp_tq[0]], qtabs[hdr.comp_tq[1]]
    w = np.zeros((2, obh, yb_h), np.float32), np.zeros((2, obw, yb_w), np.float32)
    wc = np.zeros((2, obh, yb_h // 2), np.float32), np.zeros((2, obw, yb_w // 2), np.float32)
    w[0][1], w[1][1] = _cached_weights(480, oh, yb_h, obh), _cached_weights(640, ow, yb_w, obw)
    wc[0][1] = ref_dct.combined_chroma_weights(240, 480, oh, yb_h // 2, obh)
    wc[1][1] = ref_dct.combined_chroma_weights(320, 640, ow, yb_w // 2, obw)
    args = (y, cb, cr, qt, (w[0], w[1], wc[0], wc[1]), np.array([0, 1], np.int32),
            (by, bx, cy, cx), (obh, obw))
    want = ref_dct.decode_resize_rgb_batch(*args)
    before = resize_planes.LAUNCHES
    got = dct.decode_resize_rgb_batch(*args, device="cpu")
    assert resize_planes.LAUNCHES == before  # the CPU takes K3's plain version
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, obh, obw, 3)
    assert_rgb_band(got, want)
    assert 100 < got[1, :oh, :ow].mean() < 160


# -- the engine ---------------------------------------------------------------------------


def _cfg(n, mod=port_config):
    """A config that flushes only full batches of ``n``, built from the
    port's config module (or the reference's, for the JAX engine)."""
    return mod.ImageKitConfig(secret="s", batch=mod.BatchConfig(
        max_batch=n, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))


def _drive(engine, datas, widths, fmt=ImageFormat.jpeg):
    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, w, None, fmt, 85)
                for d, w in zip(datas, widths)))
        finally:
            await engine.close()

    return asyncio.run(run())


def _capture(monkeypatch, target, name):
    """Record what ``target.name`` is handed or returns, call by call."""
    calls = []
    real = getattr(target, name)

    def rec(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out

    monkeypatch.setattr(target, name, rec)
    return calls


def _ref_native_lib(monkeypatch):
    """The reference's native codec library, loaded in this process. The
    reference builds it in place at first use, with no lock: a process whose
    first load meets another process's half-written build gets ``None``, once
    and for good, and its engine then serves JPEG and WebP sources through
    its generic decode and the host fallback without a word. Load again
    (the loader's own retry switch) and fail with the reason if it stays
    away."""
    lib = ref_loader.load()
    if lib is None:
        monkeypatch.setenv("IMAGEKIT_NATIVE_RETRY", "1")
        lib = ref_loader.load()
    assert lib is not None, "the reference's native codec library is missing"
    return lib


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


def jpeg_sig(ref, nb, sig_kind, k, src_hw, width, split=True):
    """The JAX engine's signature of a JPEG-source batch of ``nb`` images of
    ``src_hw`` resized to ``width`` (``engine_jpeg.py:271-274``)."""
    ih, iw = src_hw
    ow, oh = port_w.target_dimensions(iw, ih, width, None)
    return ("jpeg8" if split else "jpeg", sig_kind, k, ref._use_mesh(nb), nb,
            bucket_for((ih + 15) // 16 * 16), bucket_for((iw + 15) // 16 * 16),
            bucket_for(oh), bucket_for(ow))


def run_engines(monkeypatch, datas, widths, fmt, sig):
    """One full batch of ``datas`` through the JAX engine, then through the
    port's on the CPU; returns both outputs. ``sig(ref, nb)`` is the batch's
    signature in the JAX engine: it is marked compiled, so that engine runs
    its device head (compiling it on the spot, in its own device thread)
    and not its cold-shape host mirror. What the engine then did is
    asserted with what it saw, so that a failure says why."""
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    _ref_native_lib(monkeypatch)
    n = len(datas)
    ref = RefEngine(_cfg(n, ref_config), metrics=RefMetrics())
    marked = sig(ref, batch_bucket(n, n))
    ref._compiled.add(marked)
    ref_out = _drive(ref, datas, widths, fmt)
    seen = (marked, sorted(ref._compiled - {marked}, key=repr),
            sorted(ref._compiling, key=repr), ref.metrics.snapshot())
    assert ref.metrics.host_fallbacks == 0 and ref.metrics.batches == 1, seen
    port = PortEngine(_cfg(n), metrics=Metrics(), device="cpu")
    port_out = _drive(port, datas, widths, fmt)
    assert port.metrics.batches == 1, port.metrics.snapshot()
    return ref_out, port_out


def _run_both(monkeypatch, datas, widths, sig_kind, k, src_hw):
    """One batch of ``datas`` through the JAX engine and through the port
    (:func:`run_engines`), both to JPEG; returns both engines' encoder calls
    (levels in, width, height) in order, and the outputs."""
    ref_enc = _capture(monkeypatch, ref_loader, "encode_jpeg")
    port_enc = _capture(monkeypatch, loader, "encode_jpeg")
    ref_out, port_out = run_engines(
        monkeypatch, datas, widths, ImageFormat.jpeg,
        lambda ref, nb: jpeg_sig(ref, nb, sig_kind, k, src_hw, widths[0],
                                 split=sig_kind == "jxc"))
    return ref_enc, port_enc, ref_out, port_out


def _by_size(calls):
    return {(a[3], a[2]): a[0] for a, _ in calls}


def _assert_levels_exact(ref_calls, port_calls):
    want, got = _by_size(ref_calls), _by_size(port_calls)
    assert sorted(want) == sorted(got) and len(got) == len(port_calls)
    for size in want:
        for name, w, g in zip(("y", "cb", "cr"), want[size], got[size]):
            assert w.shape == g.shape, (size, name)
            assert np.array_equal(np.asarray(w), np.asarray(g)), (size, name)


# (sources (w, h), target width, k): a 1080p pair of two geometries in one
# batch at w=400, the same source at w=1280, and a k=4 pair
JXC_CASES = [
    ([(1920, 1080), (1888, 1080)], 400, 2),
    ([(1920, 1080)], 1280, 8),
    ([(1280, 720)], 400, 4),
]


@pytest.mark.parametrize("case", JXC_CASES, ids=["w400_k2", "w1280_k8", "k4"])
def test_jxc_engine_levels_exact_against_jax_engine(monkeypatch, case):
    srcs, tw, k = case
    datas = [encode_jpeg_pil(make_test_image(w, h), 80) for w, h in srcs]
    iw, ih = srcs[0]
    assert PortEngine._choose_k(
        bucket_for(ih), bucket_for(iw),
        *(bucket_for(s) for s in port_w.target_dimensions(iw, ih, tw, None)[::-1]),
    ) == k
    before = jpeg8.LAUNCHES
    ref_calls, port_calls, ref_out, port_out = _run_both(
        monkeypatch, datas, [tw] * len(datas), "jxc", k, (ih, iw))
    assert jpeg8.LAUNCHES == before
    _assert_levels_exact(ref_calls, port_calls)
    lib = loader.load()
    for (w, h), a, b in zip(srcs, ref_out, port_out):
        hdr = jpeg_abi.parse(lib, b)
        assert (hdr.width, hdr.height) == port_w.target_dimensions(w, h, tw, None)
        assert a == b  # the same levels make the same bytes


def test_jxc_engine_grayscale_exact_against_jax_engine(monkeypatch):
    img = make_test_image(1280, 720)[:, :, 0]
    data = encode_jpeg_pil(img, 85)
    ref_calls, port_calls, _, port_out = _run_both(
        monkeypatch, [data], [256], "jxc", 2, (720, 1280))
    _assert_levels_exact(ref_calls, port_calls)
    # zero chroma in, neutral chroma out: only the DC of 0 survives
    (cb, cr) = _by_size(port_calls)[(144, 256)][1:]
    assert not np.asarray(cb).any() and not np.asarray(cr).any()
    assert jpeg_abi.parse(loader.load(), port_out[0]).ncomp == 3


def test_escape_dense_jpeg_takes_the_rgb_head(monkeypatch, k3_semantics):
    import imagekit_tpu.ops.dct as jax_dct

    data = _noisy_jpeg(640, 480, 100)
    assert jpeg_abi.decode_lowfreq_i8(loader.load(), data, 4)[5]  # overflows
    ref_rgb = _capture(monkeypatch, jax_dct, "decode_resize_rgb_batch")
    port_rgb = _capture(monkeypatch, engine_jpeg, "decode_resize_rgb_batch")
    jxc = _capture(monkeypatch, engine_jpeg, "transcode_i8_batch")
    before = resize_planes.LAUNCHES
    _, port_calls, ref_out, port_out = _run_both(
        monkeypatch, [data], [240], "rgb", 8, (480, 640))
    assert resize_planes.LAUNCHES == before
    assert len(ref_rgb) == 1 and len(port_rgb) == 1 and not jxc
    want, got = ref_rgb[0][1], port_rgb[0][1]
    assert got.shape == want.shape == (1, bucket_for(180), 240, 3)
    assert_rgb_band(got, want)
    hdr = jpeg_abi.parse(loader.load(), port_out[0])
    assert (hdr.width, hdr.height) == (240, 180)
    assert [(a[2], a[3]) for a, _ in port_calls] == [(240, 180)]


@pytest.mark.parametrize("case", ["avif_out"])
def test_jpeg_requests_outside_the_slice_are_not_ported(case):
    """AVIF output, once here, is served: the YUV head and the first-party
    AV1 encoder (``test_torch_avif_engine.py``), as are a downscale under 2x
    and an escape-dense source to WebP (``test_torch_webp_slice.py``)."""
    data = encode_jpeg_pil(make_test_image(640, 480), 85)
    engine = PortEngine(_cfg(1), metrics=Metrics(), device="cpu")
    (out,) = _drive(engine, [data], [240], ImageFormat.avif)
    assert out[4:12] == b"ftypavif"
    assert engine.metrics.batches == 1
    assert struct.pack(">II", 240, 180) in out[:out.find(b"mdat")]  # ispe


def test_jpeg_that_is_not_420_names_the_pixel_decode():
    """A 4:4:4 JPEG, turned away by the JPEG heads as the reference turns it
    away, takes the JPEG pixel decode and then the RGB head's batch."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(make_test_image(320, 240)).save(buf, "JPEG", quality=85,
                                                     subsampling=0)
    hdr = jpeg_abi.parse(loader.load(), buf.getvalue())
    assert tuple(hdr.comp_h) == (1, 1, 1)
    engine = PortEngine(_cfg(1), metrics=Metrics(), device="cpu")
    (out,) = _drive(engine, [buf.getvalue()], [64], ImageFormat.webp)
    assert vp8.dimensions(out) == (64, 48)
    stages = engine.metrics.stage_seconds
    assert stages["device_decode"] > 0 and stages["device_resize"] > 0
    assert "device_decode_resize" not in stages
    assert engine.metrics.batches == 1


# -- HTTP ---------------------------------------------------------------------------------


def test_http_img_and_upload_serve_jpeg_to_jpeg(tmp_path):
    from aiohttp import FormData

    from imagekit_tpu_torch.signature import sign
    from tests.test_torch_slice import JPG, SECRET, _http

    upload = encode_jpeg_pil(make_test_image(640, 480), 90)

    async def fn(client, metrics):
        params = {"url": JPG, "w": "400", "f": "jpeg", "q": "80"}
        r = await client.get("/img", params={**params, "sig": sign(params, SECRET)})
        body = await r.read()
        assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
        hdr = jpeg_abi.parse(loader.load(), body)
        assert (hdr.width, hdr.height) == (400, 225)
        form = FormData()
        form.add_field("file", upload, filename="x.jpg")
        form.add_field("w", "256")
        form.add_field("f", "jpeg")
        r = await client.post("/upload", data=form)
        body = await r.read()
        assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
        hdr = jpeg_abi.parse(loader.load(), body)
        assert (hdr.width, hdr.height) == (256, 192)

    _http(tmp_path, fn)
