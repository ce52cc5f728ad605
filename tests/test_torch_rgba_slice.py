"""The plain RGB head of the port (sources with alpha) against the JAX
package, on the CPU.

- ``ops/resize.py``: ``resample_bucketed_flat`` for 3 and 4 channels (and
  single-channel planes) against the reference's XLA einsum head on the
  same numpy inputs; ``resize_batch`` / ``resize_image_array`` (exact
  shapes, padded into their bucket) against the reference's;
  ``resample_reference`` byte-equal.
- The stacks the head is fed: the engine's ``""``-kind stacks (no edge
  replication) byte-equal to the reference's construction, and the band and
  compact tables on one-tap stacks (the identity and nearest stacks of the
  JPEG pixel decode).
- The slice: RGBA PNGs and a WebP with alpha through the JAX engine and the
  port's engine, one batch each, to WebP and to JPEG at two widths; what
  each hands its host encoder is compared.

Tolerance: u8 within max |d| <= 1 on at most 0.1% of values (fp32 sums in
another order; the reference's own band, tests/test_pallas_jpeg8.py:72);
the count of differing values is printed. On the CPU the wrappers take
K2's plain version, so no launch is counted.
"""

import asyncio

import numpy as np
import pytest
import torch

from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import vp8 as ref_vp8
from imagekit_tpu.codecs.native import loader as ref_loader
from imagekit_tpu.ops import resize as ref_resize
from imagekit_tpu.serving.batch_types import _cached_weights as ref_cached
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import vp8
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops import resize, resize_strip
from imagekit_tpu_torch.ops import weights as port_w
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.conftest import encode_png, make_test_image
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_resize import _stacks, assert_band
from tests.test_vp8l import _lossless


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


def _diff(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert_band(got, want, what)
    n = int((got != want).sum())
    print(f"{what}: {n} of {got.size} values differ")
    return n


# -- ops/resize.py -------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resample_bucketed_flat_matches_jax(channels, seed):
    rng = np.random.default_rng(seed)
    B, bh, bw, obh, obw = 4, 64, 256, 32, 128
    imgs = rng.integers(0, 256, (B, bh, bw * channels), dtype=np.uint8)
    wv, wh = _stacks(bh, bw, obh, obw)
    vidx = rng.integers(0, 4, B).astype(np.int32)
    hidx = ((vidx + 1 + seed) % 4).astype(np.int32)  # vidx != hidx
    want = np.asarray(ref_resize.resample_bucketed_flat(
        imgs, wv, wh, vidx, hidx, channels))
    before = (resize_strip.LAUNCHES, resize_strip.LAUNCHES_RGBA)
    got = resize.resample_bucketed_flat(imgs, wv, wh, vidx, hidx, channels,
                                        device="cpu")
    assert (resize_strip.LAUNCHES, resize_strip.LAUNCHES_RGBA) == before
    assert got.dtype == np.uint8 and got.shape == (B, obh * obw * channels)
    assert got.flags["C_CONTIGUOUS"]
    _diff(got, want, f"{channels} channels, seed {seed}")
    # the cached tables change nothing
    tabs = resize_strip.resize_tables(torch.from_numpy(wv),
                                      torch.from_numpy(wh))
    again = resize.resample_bucketed_flat(imgs, wv, wh, vidx, hidx, channels,
                                          bands=tabs, device="cpu")
    assert np.array_equal(again, got)


def test_resample_flat_refuses_other_channel_counts():
    x = torch.zeros((1, 16, 32), dtype=torch.uint8)
    w = torch.zeros((1, 8, 16)), torch.zeros((1, 8, 16))
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="2 channels"):
        resize.resample_flat(x, *w, idx, idx, channels=2)


def test_rgba_plain_is_the_plane_version_on_each_channel():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 64, 256 * 4),
                                         dtype=np.uint8))
    wv, wh = (torch.from_numpy(w) for w in _stacks(64, 256, 32, 128))
    vidx = torch.tensor([1, 3], dtype=torch.int32)
    hidx = torch.tensor([0, 2], dtype=torch.int32)
    out = resize_strip.rgba_resize(imgs, wv, wh, vidx, hidx)
    assert out.shape == (2, 32, 128, 4) and out.is_contiguous()
    px = imgs.reshape(2, 64, 256, 4)
    for c in range(4):
        assert torch.equal(out[..., c], resize_strip.plane_resize_plain(
            px[..., c], wv, wh, vidx, hidx))
    with pytest.raises(ValueError, match=r"W\*4"):
        resize_strip.rgba_resize(imgs[:, :, :-1], wv, wh, vidx, hidx)
    with pytest.raises(TypeError, match="uint8"):
        resize_strip.rgba_resize(imgs.float(), wv, wh, vidx, hidx)


@pytest.mark.parametrize("shape,w,h", [
    ((75, 101, 4), 40, None), ((75, 101, 3), None, 33), ((48, 64), 100, None),
    ((75, 101, 4), 101, 75)])
def test_resize_image_array_matches_jax(shape, w, h):
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    want = ref_resize.resize_image_array(img, w, h)
    got = resize.resize_image_array(img, w, h, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    _diff(got, want, f"{shape} -> w={w} h={h}")
    assert resize.resize_image_array(img, None, None, device="cpu") is img
    assert np.array_equal(resize.resample_reference(img[..., None] if
                          img.ndim == 2 else img, *want.shape[:2]),
                          ref_resize.resample_reference(
                              img[..., None] if img.ndim == 2 else img,
                              *want.shape[:2]))


def test_resize_batch_other_filters_match_jax():
    imgs = np.random.default_rng(6).integers(0, 256, (2, 40, 56, 4),
                                             dtype=np.uint8)
    for name in ("nearest", "bilinear", "catmullrom"):
        want = np.asarray(ref_resize.resize_batch(imgs, 17, 23, name))
        got = resize.resize_batch(imgs, 17, 23, name, device="cpu")
        _diff(got, want, name)


# -- the stacks ------------------------------------------------------------------


def test_plain_kind_stacks_byte_equal_and_not_replicated():
    """The ``""`` kind's stacks are the reference's ``_cached_weights`` with
    ``rep_to`` the identity: rows past the true output stay zero."""
    engine = PortEngine(metrics=Metrics(), device="cpu")
    v_keys, h_keys = {(241, 72): 0, (251, 81): 1}, {(321, 99): 0, (301, 97): 1}
    key = (256, 368, 96, 128, 4, "")
    try:
        wv, wh, tabs = engine._rgb_weights(key, v_keys, h_keys)
    finally:
        asyncio.run(engine.close())
    for (ti, to), u in v_keys.items():
        assert np.array_equal(wv[u].numpy(), ref_cached(ti, to, 256, 96))
        assert not wv[u, to:].any()
    for (ti, to), u in h_keys.items():
        assert np.array_equal(wh[u].numpy(), ref_cached(ti, to, 368, 128))
    assert not wv[2:].any() and not wh[2:].any()
    assert torch.equal(tabs.band_v, resize_strip.band_table(wv))


@pytest.mark.parametrize("kind", ["identity", "upsample", "nearest_down"])
def test_tables_take_one_and_two_tap_stacks(kind):
    """The JPEG pixel decode's stacks: the identity (one tap a row), the 2x
    triangle upsample (two) and a nearest downscale, byte-equal to the
    reference's numpy arrays, and through ``band_table`` /
    ``compact_table``: the compact product is the dense one."""
    from imagekit_tpu.ops import dct as ref_dct

    n = 48
    if kind == "identity":
        w = port_w.padded_weights(n, n, n, n, "nearest")
        ref = ref_resize.padded_weights(n, n, n, n, "nearest")
        assert np.array_equal(w, np.eye(n, dtype=np.float32))
    elif kind == "upsample":
        w = port_w.upsample_weights(n // 2, n)
        ref = ref_dct.upsample_weights(n // 2, n)
    else:
        w = port_w.padded_weights(n, 13, n, 16, "nearest")
        ref = ref_resize.padded_weights(n, 13, n, 16, "nearest")
    assert np.array_equal(w, ref)
    stack = torch.from_numpy(w[None])
    band = resize_strip.band_table(stack)
    width = band[0, :, 1] - band[0, :, 0]
    assert int(width.max()) == (2 if kind == "upsample" else 1)
    start, taps = resize_strip.compact_table(stack, band)
    T = 4 * taps.shape[1]
    # two taps may straddle an aligned group of four: two groups then
    assert T == (8 if kind == "upsample" else 4) and (start % 4 == 0).all()
    x = torch.from_numpy(np.random.default_rng(7).random(
        (stack.shape[2], 5)).astype(np.float32))
    dense = stack[0] @ x
    t = taps[0].permute(1, 0, 2).reshape(stack.shape[1], T)
    cols = (start[0].long()[:, None] + torch.arange(T)).clamp(
        max=stack.shape[2] - 1)
    # one product a row for the one-tap stacks; two, whose sum may round
    # apart from the matrix product's FMA
    torch.testing.assert_close((t[:, :, None] * x[cols]).sum(1), dense,
                               rtol=0, atol=1e-6)


# -- the slice ---------------------------------------------------------------------

# two geometries of one bucket pair (256x368 -> 96x128): vidx != hidx
GEOMS = [((321, 241), 99), ((301, 251), 97)]


def _rgba(w, h, seed=0):
    img = make_test_image(w, h)
    alpha = np.random.default_rng(seed).integers(0, 256, (h, w, 1),
                                                 dtype=np.uint8)
    return np.dstack([img, alpha])


def _cfg(mod, n):
    return mod.ImageKitConfig(secret="s", batch=mod.BatchConfig(
        max_batch=n, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))


def _drive(engine, datas, widths, fmt):
    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, w, None, fmt, 85)
                for d, w in zip(datas, widths)))
        finally:
            await engine.close()

    return asyncio.run(run())


def _capture(monkeypatch):
    """What each engine hands the host encoders (the reference's and the
    port's copies of them), keyed by the output size."""
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


def run_both_plain(monkeypatch, datas, widths, fmt, src_hw, out_hw, ch=4):
    """One batch through the JAX engine's plain rgb head (its signature
    marked compiled, so that it runs the einsum head and not its host
    mirror), then through the port's on the CPU."""
    from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine

    _ref_native_lib(monkeypatch)
    n = len(datas)
    ref = RefEngine(_cfg(ref_config, n), metrics=RefMetrics())
    (bh, bw), (obh, obw) = map(lambda hw: tuple(map(bucket_for, hw)),
                               (src_hw, out_hw))
    ref._compiled.add(("rgb", ref._use_mesh(n), n, bh, bw, obh, obw, ch))
    ref_out = _drive(ref, datas, widths, fmt)
    assert ref.metrics.host_fallbacks == 0 and ref.metrics.batches == 1, \
        ref.metrics.snapshot()
    port = PortEngine(_cfg(port_config, n), metrics=Metrics(), device="cpu")
    port_out = _drive(port, datas, widths, fmt)
    assert port.metrics.batches == 1, port.metrics.snapshot()
    return ref_out, port_out


def _out_size(data: bytes):
    if data[:4] == b"RIFF":
        return vp8.dimensions(data)
    hdr = jpeg_abi.parse(loader.load(), data)
    return hdr.width, hdr.height


@pytest.mark.parametrize("fmt", [ImageFormat.webp, ImageFormat.jpeg])
def test_rgba_png_engine_matches_jax_engine(monkeypatch, fmt):
    """Two RGBA PNGs of two geometries, two widths, one batch: the YUV
    planes (WebP) or the levels (JPEG) each engine hands its encoder."""
    datas = [encode_png(_rgba(w, h, seed=i))
             for i, ((w, h), _) in enumerate(GEOMS)]
    got = _capture(monkeypatch)
    ref_out, port_out = run_both_plain(
        monkeypatch, datas, [tw for _, tw in GEOMS], fmt, (241, 321),
        (74, 99))
    for ((w, h), tw), a, b in zip(GEOMS, ref_out, port_out):
        size = port_w.target_dimensions(w, h, tw, None)
        assert _out_size(a) == _out_size(b) == size
        assert (a[:4] == b"RIFF") == (fmt == ImageFormat.webp)
    assert len(got) == 2
    n = 0
    for shape, (want_planes, got_planes) in got.items():
        for name, w_, g_ in zip(("y", "cb", "cr"), want_planes, got_planes):
            n += _diff(g_, w_, f"{fmt.value} {shape} {name}")
    if n == 0:  # the same planes or levels make the same bytes
        assert ref_out == port_out


def test_webp_with_alpha_engine_matches_jax_engine(monkeypatch):
    data = _lossless(_rgba(160, 120), 3, mode="RGBA")
    assert vp8.decode_rgb(data).shape == (120, 160, 4)
    got = _capture(monkeypatch)
    ref_out, port_out = run_both_plain(
        monkeypatch, [data], [64], ImageFormat.webp, (120, 160), (48, 64))
    assert vp8.dimensions(ref_out[0]) == vp8.dimensions(port_out[0]) == (64, 48)
    ((want_planes, got_planes),) = got.values()
    for name, w_, g_ in zip("yuv", want_planes, got_planes):
        _diff(g_, w_, f"webp alpha {name}")


def test_rgba_batches_queue_apart_from_rgb():
    """Sources of 3 and of 4 channels of one bucket pair are two batches
    (the channel count is part of the queue key), each one device call."""
    rgb = encode_png(make_test_image(321, 241))
    rgba = encode_png(_rgba(321, 241))
    engine = PortEngine(_cfg(port_config, 2), metrics=Metrics(), device="cpu")
    outs = _drive(engine, [rgb, rgba, rgb, rgba], [99] * 4, ImageFormat.webp)
    assert all(vp8.dimensions(o) == (99, 74) for o in outs)
    assert engine.metrics.batches == 2
    assert outs[0] == outs[2] and outs[1] == outs[3]
