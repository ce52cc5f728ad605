"""The port's jpeg8 head against the JAX package's, on identical inputs.

The plain PyTorch head (``imagekit_tpu_torch.ops.dct``) and the plain
version of K1 (``ops.jpeg8.folded_plane_plain``, which ``folded_plane``
takes for CPU tensors) are held against ``decode_resize_yuv_lowfreq_i8_batch``
with the einsum head and with the Pallas K1 in interpret mode.

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
from imagekit_tpu.ops.dct import decode_resize_yuv_lowfreq_i8_batch as ref_batch
from imagekit_tpu_torch.ops import dct as port_dct
from imagekit_tpu_torch.ops import jpeg8
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


@pytest.mark.parametrize("mode", ["", "interpret"])
@pytest.mark.parametrize("k", [2, 4])
def test_plain_head_matches_reference_on_mk(monkeypatch, k, mode):
    args = _mk(k, seed=k)
    want = _ref(monkeypatch, mode, args)
    got = port_dct.decode_resize_yuv_lowfreq_i8_batch(*args)
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w, name)


@pytest.mark.parametrize("k", [2, 4])
def test_kernel_route_matches_plain_head_on_cpu(k):
    """decode_resize_i8 (i16 widen + scatter, three folded_plane calls)
    on CPU tensors equals the plain head (f32 widen, einsum order)."""
    dc, ac, esc, qt, w, vidx, bd, os_, kk = _mk(k, seed=10 + k)
    flat_args = to_port([dc[0], ac[0], dc[1], ac[1], dc[2], ac[2],
                         esc[0][0], esc[0][1], esc[1][0], esc[1][1],
                         esc[2][0], esc[2][1], qt, *w, vidx])
    got = jpeg8.decode_resize_i8(*flat_args, k=k)
    want = port_dct.decode_resize_yuv_lowfreq_i8(
        *flat_args, by_b=bd[0], bx_b=bd[1], cy_b=bd[2], cx_b=bd[3], k=k)
    assert got.dtype == torch.uint8
    assert_band(got.numpy(), want.numpy())


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("k", [2, 4])
def test_folded_plane_matches_pallas_interpret(k, luma, centered):
    """One plane, both epilogues: the port's folded_plane (plain version on
    CPU) against the Pallas K1 body in interpret mode. The centred case is
    the front of ``_transcode_i8_pallas``."""
    dc, ac, esc, qt, w, vidx, bd, os_, kk = _mk(k, seed=20 + k)
    p = 0 if luma else 1
    eidx, evals = esc[p]
    ac16 = np.array(
        jnp.asarray(ac[p]).astype(jnp.int16)
        .at[eidx[:, 0], eidx[:, 1], eidx[:, 2]].add(evals.astype(np.int16)))
    from imagekit_tpu.ops.dct import _lowfreq_indices

    idx = _lowfreq_indices(k)
    qt4 = (qt[:, :64] if luma else qt[:, 64:])[:, idx] * np.float32(k / 8.0)
    wv, wh = (w[0], w[1]) if luma else (w[2], w[3])
    want = np.asarray(pallas_jpeg8._folded_plane_pallas(
        jnp.asarray(dc[p]), jnp.asarray(ac16), jnp.asarray(qt4),
        jnp.asarray(wv), jnp.asarray(wh), jnp.asarray(vidx), k, luma=luma,
        interpret=True, centered=centered))
    t = to_port([dc[p], ac16, np.ascontiguousarray(qt4), wv, wh, vidx])
    got = jpeg8.folded_plane(*t, k, luma, centered).numpy()
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
    with_esc = port_dct.decode_resize_yuv_lowfreq_i8_batch(*args)
    no_esc = list(args)
    no_esc[2] = tuple((np.zeros_like(i), np.zeros_like(v)) for i, v in args[2])
    without = port_dct.decode_resize_yuv_lowfreq_i8_batch(*no_esc)
    assert any((a != b).any() for a, b in zip(with_esc, without))


def _real_batch(width, quality=95, n=2):
    """Batch arrays packed by the port's engine from real JPEGs (native
    i8 decode), captured at the head call."""
    from imagekit_tpu.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
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
    got = port_dct.decode_resize_yuv_lowfreq_i8_batch(*args)
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w, name)
        assert 0 < (g > 20).mean() and (g < 250).mean() > 0.5  # not clipped


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """folded_plane on a non-CPU tensor goes to the kernel or raises; it
    never falls back to the plain version."""
    monkeypatch.setattr(jpeg8, "folded_plane_plain",
                        lambda *a, **k: pytest.fail("plain version taken"))
    dc, ac, esc, qt, w, vidx, bd, os_, kk = _mk(2, seed=1)
    t = to_port([dc[0], ac[0].astype(np.int16), qt[:, :4].copy(), w[0], w[1], vidx])
    t = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="no K1 kernel"):
        jpeg8.folded_plane(*t, 2, True)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_folded_plane_rejects_what_the_kernel_does_not_take(bad):
    dc, ac, esc, qt, w, vidx, bd, os_, kk = _mk(2, seed=2)
    t = to_port([dc[0], ac[0].astype(np.int16), qt[:, :4].copy(), w[0], w[1], vidx])
    if bad == "dtype":
        t[1] = t[1].to(torch.int32)
    elif bad == "shape":
        t[2] = t[2][:, :3].contiguous()
    else:
        t[3] = t[3].to("meta")
    with pytest.raises((TypeError, ValueError)):
        jpeg8.folded_plane(*t, 2, True)
