"""The port's jpeg8 head (K1's plain version) against the JAX package's, on
identical inputs.

``ops.jpeg8.folded_planes_i8`` takes its plain version for CPU tensors (an
i16 widen and escape scatter, then ``folded_plane_plain`` per plane, then
the u8 pack or the three centred planes). It is held against the JAX
einsum head ``_decode_resize_yuv_lowfreq_i8_kernel`` and against the
Pallas K1 in interpret mode, on ``_mk``'s seeded inputs with escapes live
and on batches packed from real JPEGs; its centred planes against the
JAX jxc transcode's levels (exact at k = 2 and 4). The band tables the
kernel loops over are checked to cover every nonzero of the folded stacks
over the bucket ladder.

Tolerance: u8 planes within max |d| <= 1 on at most 0.1% of pixels — the
reference's own band (tests/test_pallas_jpeg8.py:72). On the CPU the two
are expected to agree exactly; ±1 is allowed only because torch and XLA
take the fp32 sums in different orders. The CUDA kernel itself is held
against its plain version on a card in ``test_torch_cuda.py``.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagekit_tpu.ops import pallas_jpeg8
from imagekit_tpu.ops.dct import _decode_resize_yuv_lowfreq_i8_kernel
from imagekit_tpu.ops.dct import decode_resize_yuv_lowfreq_i8_batch as ref_batch
from imagekit_tpu.ops.dct import transcode_i8_batch as ref_transcode
from imagekit_tpu_torch.ops import dct as port_dct
from imagekit_tpu_torch.ops import jpeg8
from imagekit_tpu_torch.ops import weights as port_w
from imagekit_tpu_torch.utils.bucketing import bucket_for, bucket_ladder
from imagekit_tpu_torch.weights_io import to_port
from tests.test_pallas_jpeg8 import _mk

MAX_SHARE = 1e-3


def assert_band(a, b, what=""):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape, what
    d = np.abs(a - b)
    assert d.max() <= 1, (what, int(d.max()))
    assert (d > 0).mean() <= MAX_SHARE, (what, float((d > 0).mean()))


def _ref(monkeypatch, mode, args):
    monkeypatch.setenv("IMAGEKIT_PALLAS_JPEG8", mode)
    assert pallas_jpeg8.enabled() == (mode == "interpret")
    return ref_batch(*args)


def _grouped(args):
    """``_mk``'s arrays as the port's tensors, grouped as
    ``folded_planes_i8`` takes them: (dcs, acs, escs, qtabs, stacks,
    vidx)."""
    dc, ac, esc, qt, w, vidx = args[:6]
    t = lambda xs: tuple(to_port(list(xs)))  # noqa: E731
    return (t(dc), t(ac), tuple(t(e) for e in esc), to_port([qt])[0], t(w),
            to_port([vidx])[0])


@pytest.mark.parametrize("mode", ["", "interpret"])
@pytest.mark.parametrize("k", [2, 4])
def test_plain_head_matches_reference_on_mk(monkeypatch, k, mode):
    args = _mk(k, seed=k)
    want = _ref(monkeypatch, mode, args)
    got = port_dct.decode_resize_yuv_lowfreq_i8_batch(*args, device="cpu")
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w, name)


@pytest.mark.parametrize("k", [2, 4])
def test_kernel_route_matches_plain_head_on_cpu(k):
    """folded_planes_i8 on CPU tensors (one call for the three planes, the
    packed u8 layout) against the JAX einsum kernel's flat output."""
    args = _mk(k, seed=10 + k)
    dc, ac, esc, qt, w, vidx, (by, bx, cy, cx), os_, kk = args
    want = np.asarray(_decode_resize_yuv_lowfreq_i8_kernel(
        *map(jnp.asarray, (dc[0], ac[0], dc[1], ac[1], dc[2], ac[2],
                           esc[0][0], esc[0][1], esc[1][0], esc[1][1],
                           esc[2][0], esc[2][1], qt, *w, vidx)),
        by_b=by, bx_b=bx, cy_b=cy, cx_b=cx, k=k))
    g = _grouped(args)
    before = jpeg8.LAUNCHES
    got = jpeg8.folded_planes_i8(*g[:5], None, g[5], k)
    assert jpeg8.LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == torch.uint8
    assert_band(got.numpy(), want)


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("k", [2, 4])
def test_folded_plane_matches_pallas_interpret(k, luma, centered):
    """Each plane of folded_planes_i8 (plain version on the CPU), both
    epilogues, against the Pallas K1 body in interpret mode fed the
    reference's own i16 widen + scatter. The centred case is the front of
    ``_transcode_i8_pallas``."""
    args = _mk(k, seed=20 + k)
    dc, ac, esc, qt, w, vidx, bd, os_, kk = args
    p = 0 if luma else 1
    eidx, evals = esc[p]
    ac16 = jnp.asarray(ac[p]).astype(jnp.int16).at[
        eidx[:, 0], eidx[:, 1], eidx[:, 2]].add(evals.astype(np.int16))
    from imagekit_tpu.ops.dct import _lowfreq_indices

    idx = _lowfreq_indices(k)
    qt4 = (qt[:, :64] if luma else qt[:, 64:])[:, idx] * np.float32(k / 8.0)
    wv, wh = (w[0], w[1]) if luma else (w[2], w[3])
    want = np.asarray(pallas_jpeg8._folded_plane_pallas(
        jnp.asarray(dc[p]), ac16, jnp.asarray(qt4), jnp.asarray(wv),
        jnp.asarray(wh), jnp.asarray(vidx), k, luma=luma, interpret=True,
        centered=centered))
    g = _grouped(args)
    out = jpeg8.folded_planes_i8(*g[:5], None, g[5], k, centered=centered)
    if centered:
        got = out[p].numpy()
    else:
        B, O, P = want.shape
        start = 0 if luma else os_[0] * os_[1]
        got = out[:, start:start + O * P].reshape(B, O, P).numpy()
    assert got.dtype == (np.int8 if centered else np.uint8)
    assert_band(got, want)


def test_widen_scatter_accumulates_and_zeroed_escapes_change_output():
    """The escape scatter adds (padding rows add 0 at (0,0,0) on top of the
    real level there), and the residuals are live: zeroing them changes
    the planes."""
    ac8 = torch.tensor([[[5, -3, 7]]], dtype=torch.int8)
    eidx = torch.tensor([[0, 0, 0], [0, 0, 2], [0, 0, 0]], dtype=torch.int32)
    evals = torch.tensor([300, -200, 0], dtype=torch.int32)
    out = jpeg8.widen_scatter(ac8, eidx, evals)
    assert out.dtype == torch.int16
    assert out.tolist() == [[[305, -3, -193]]]

    args = _mk(2, seed=9)
    with_esc = port_dct.decode_resize_yuv_lowfreq_i8_batch(*args, device="cpu")
    no_esc = list(args)
    no_esc[2] = tuple((np.zeros_like(i), np.zeros_like(v)) for i, v in args[2])
    without = port_dct.decode_resize_yuv_lowfreq_i8_batch(*no_esc, device="cpu")
    assert any((a != b).any() for a, b in zip(with_esc, without))


@pytest.mark.parametrize("mode", ["", "interpret"])
@pytest.mark.parametrize("k", [2, 4])
def test_centred_planes_give_the_jax_jxc_levels(monkeypatch, k, mode):
    """The centred epilogue, through the transcode's fDCT tail: the port's
    int16 levels equal the JAX transcode's, einsum and Pallas fronts, on
    ``_mk``'s inputs with escapes live."""
    dc, ac, esc, qt, w, vidx, bd, os_, kk = _mk(k, seed=40 + k)
    qt_out = (np.random.default_rng(k).random((3, 128)) * 20 + 1
              ).astype(np.float32)
    args = (dc, ac, esc, qt, qt_out, w, vidx, bd, os_, k)
    monkeypatch.setenv("IMAGEKIT_PALLAS_JXC", mode)
    assert pallas_jpeg8.jxc_enabled() == (mode == "interpret")
    want = ref_transcode(*args)
    got = port_dct.transcode_i8_batch(*args, device="cpu")
    for name, g, w_ in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.int16 and g.shape == w_.shape, name
        assert np.array_equal(g, w_), name


def _real_batch(width, quality=95, n=2):
    """Batch arrays packed by the port's engine from real JPEGs (native
    i8 decode), captured at the head call."""
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics
    from tests.conftest import encode_jpeg_pil, make_test_image

    img = make_test_image(640, 480)
    # hard edges: luma and chroma escapes at q95
    img[96:176, 200:328] = 255
    img[300:380, 400:520] = 0
    img[200:260, 40:140] = (0, 0, 255)
    datas = [encode_jpeg_pil(img, quality), encode_jpeg_pil(img[:, ::-1].copy(), quality)]
    calls = []
    real = engine_jpeg.decode_resize_yuv_lowfreq_i8_batch

    def rec(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    cfg = ImageKitConfig(secret="s", batch=BatchConfig(
        max_batch=n, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))
    engine = BatchedEngine(cfg, metrics=Metrics(), device="cpu")

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(datas[i % 2], width, None, ImageFormat.webp, 80)
                for i in range(n)))
        finally:
            await engine.close()

    engine_jpeg.decode_resize_yuv_lowfreq_i8_batch = rec
    try:
        asyncio.run(run())
    finally:
        engine_jpeg.decode_resize_yuv_lowfreq_i8_batch = real
    assert len(calls) == 1
    dcs, acs, escs, qt, w, vidx, bd, os_, k = calls[0]
    npy = lambda t: t.numpy()  # noqa: E731
    return ((tuple(map(npy, dcs)), tuple(map(npy, acs)),
             tuple((npy(i), npy(v)) for i, v in escs), npy(qt),
             tuple(map(npy, w)), npy(vidx), bd, os_, k))


@pytest.mark.parametrize("mode", ["", "interpret"])
@pytest.mark.parametrize("width,k", [(256, 4), (120, 2)])
def test_plain_head_matches_reference_on_real_jpegs(monkeypatch, width, k, mode):
    args = _real_batch(width)
    assert args[-1] == k
    assert int((args[2][0][1] != 0).sum()) > 0  # luma escapes are present
    assert int((args[2][1][1] != 0).sum()) > 0  # and Cb escapes
    want = _ref(monkeypatch, mode, args)
    got = port_dct.decode_resize_yuv_lowfreq_i8_batch(*args, device="cpu")
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w, name)
        assert 0 < (g > 20).mean() and (g < 250).mean() > 0.5  # not clipped


@pytest.mark.parametrize("width,k", [(256, 4), (120, 2)])
def test_int16_head_matches_reference_on_escape_dense_jpegs(width, k):
    """An escape-dense JPEG overflows the split transport and rides
    block-grouped int16 levels: the batch the port's engine packs, through
    ``decode_resize_yuv_lowfreq_batch`` (K1's int16 entry, its plain
    version here), against the JAX head on the same arrays."""
    from imagekit_tpu.ops.dct import decode_resize_yuv_lowfreq_batch as ref16
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics
    from tests.test_batcher import _noisy_jpeg
    from tests.test_torch_cuda import block_edge_image, native_jpeg

    if k == 4:
        datas = [_noisy_jpeg(640, 480, 100), _noisy_jpeg(640, 480, 100, seed=8)]
    else:  # noise leaves too few levels at k=2 to overflow: hard edges do
        datas = [native_jpeg(block_edge_image(s, 640, 480), 100) for s in (1, 2)]
    assert all(jpeg_abi.decode_lowfreq_i8(loader.load(), d, k)[5] for d in datas)
    calls = []
    real = engine_jpeg.decode_resize_yuv_lowfreq_batch

    def rec(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    cfg = ImageKitConfig(secret="s", batch=BatchConfig(
        max_batch=2, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))
    engine = BatchedEngine(cfg, metrics=Metrics(), device="cpu")

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, width, None, ImageFormat.webp, 80)
                for d in datas))
        finally:
            await engine.close()

    engine_jpeg.decode_resize_yuv_lowfreq_batch = rec
    try:
        asyncio.run(run())
    finally:
        engine_jpeg.decode_resize_yuv_lowfreq_batch = real
    assert len(calls) == 1
    y, cb, cr, qt, w, vidx, bd, os_, kk = calls[0]
    assert kk == k and y.dtype == torch.int16
    assert y.shape[2] == port_w.pad128(bd[1] * k * k)
    assert int(y.abs().max()) > 127  # levels past int8: why it rides int16
    args = (y.numpy(), cb.numpy(), cr.numpy(), qt.numpy(),
            tuple(x.cpu().numpy() for x in w), vidx.numpy(), bd, os_, k)
    want = ref16(*args)
    got = port_dct.decode_resize_yuv_lowfreq_batch(*args, device="cpu")
    for name, g, w_ in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w_, name)
        assert (g < 250).mean() > 0.5  # not clipped


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """folded_planes_i8 on a non-CPU tensor goes to the kernel or raises; it
    never falls back to the plain version."""
    monkeypatch.setattr(jpeg8, "folded_planes_i8_plain",
                        lambda *a, **k: pytest.fail("plain version taken"))
    g = _grouped(_mk(2, seed=1))
    meta = lambda xs: tuple(x.to("meta") for x in xs)  # noqa: E731
    bands = tuple(jpeg8.folded_bands(s).to("meta") for s in g[4])
    with pytest.raises(ValueError, match="no K1 kernel"):
        jpeg8.folded_planes_i8(meta(g[0]), meta(g[1]),
                               tuple(meta(e) for e in g[2]), g[3].to("meta"),
                               meta(g[4]), bands, g[5].to("meta"), 2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "band_shape",
                                 "escape_shape", "k"])
def test_folded_plane_rejects_what_the_kernel_does_not_take(bad):
    dcs, acs, escs, qt, w, vidx = (list(x) if isinstance(x, tuple) else x
                                   for x in _grouped(_mk(2, seed=2)))
    bands = [jpeg8.folded_bands(s) for s in w]
    k = 2
    if bad == "dtype":
        acs[0] = acs[0].to(torch.int16)
    elif bad == "shape":
        qt = qt[:, :64].contiguous()
    elif bad == "device":
        w[1] = w[1].to("meta")
    elif bad == "band_shape":
        bands[3] = bands[3][:, :-1].contiguous()
    elif bad == "escape_shape":
        escs[1] = (escs[1][0][:, :2].contiguous(), escs[1][1])
    else:
        k = 8
    with pytest.raises((TypeError, ValueError)):
        jpeg8.folded_planes_i8(dcs, acs, escs, qt, w, bands, vidx, k)


# (source w, h, target w): bucket pairs of the ladder at k = 2 and 4, from
# thumbnails of 4K sources to the flagship and its k=4 neighbour
BAND_GEOMS = [(1920, 1080, 400), (1920, 1080, 800), (3840, 2160, 100),
              (1280, 720, 256), (640, 480, 256), (4000, 3000, 640),
              (1000, 700, 333), (64, 48, 16)]


@pytest.mark.parametrize("geom", BAND_GEOMS)
def test_folded_bands_cover_every_nonzero(geom):
    """Each band table holds every nonzero of its folded stack (so the
    banded loops are the dense sums), and is tight: its ends are nonzero."""
    iw, ih, tw = geom
    ow, oh = port_w.target_dimensions(iw, ih, tw, None)
    yb_h = bucket_for((ih + 15) // 16 * 16)
    yb_w = bucket_for((iw + 15) // 16 * 16)
    obh, obw = bucket_for(oh), bucket_for(ow)
    assert yb_h in bucket_ladder() and obw in bucket_ladder()
    k = 2 if yb_h * 2 // 8 >= obh and yb_w * 2 // 8 >= obw else 4
    raw = (port_w.lowfreq_luma_weights(ih, oh, k, yb_h * k // 8, obh),
           port_w.lowfreq_luma_weights(iw, ow, k, yb_w * k // 8, obw),
           port_w.lowfreq_chroma_half_weights((ih + 1) // 2, ih, oh,
                                              yb_h * k // 16, obh // 2, k),
           port_w.lowfreq_chroma_half_weights((iw + 1) // 2, iw, ow,
                                              yb_w * k // 16, obw // 2, k))
    for w in raw:
        f = torch.from_numpy(port_w.fold_lowfreq_weights(w[None], k))
        band = jpeg8.folded_bands(f)
        assert band.dtype == torch.int32 and band.shape == (1, w.shape[0], 2)
        nz = (f != 0).any(dim=1)[0]  # (O, n)
        cols = torch.arange(nz.shape[1])
        first, last = band[0, :, 0, None], band[0, :, 1, None]
        inside = (cols >= first) & (cols < last)
        assert not (nz & ~inside).any()  # every nonzero lies in its run
        rows = nz.any(dim=1)
        assert (band[0, ~rows] == 0).all()  # empty rows get (0, 0)
        o = torch.nonzero(rows).flatten()
        assert nz[o, band[0, o, 0].long()].all()
        assert nz[o, band[0, o, 1].long() - 1].all()
