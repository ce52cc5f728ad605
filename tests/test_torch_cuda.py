"""Tests of the port that need an NVIDIA GPU: K1 (a CUDA kernel, with no
CPU mode) against its plain PyTorch version, and the engine on the card
against the engine on the CPU.

Each test skips where ``torch.cuda.is_available()`` is false; the
condition is a string, evaluated when the test runs, never at import.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: u8/i8 planes within max |d| <= 1 on at most 0.1% of elements —
fp32 sums taken in another order than the plain version's.
"""

import asyncio

import numpy as np
import pytest
import torch

from imagekit_tpu_torch.ops import dct, jpeg8
from imagekit_tpu_torch.ops.weights import (
    LOWFREQ_ESC_C,
    LOWFREQ_ESC_Y,
    fold_lowfreq_weights,
    lowfreq_ac_width,
    pad128,
)
from imagekit_tpu_torch.weights_io import to_port

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU (CUDA kernel, no CPU mode)",
)
MAX_SHARE = 1e-3


def assert_band(a, b):
    d = (a.cpu().to(torch.int32) - b.cpu().to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= MAX_SHARE


def _inputs(k, B=3, U=4, by=16, bx=32, cy=8, cx=16, obh=64, obw=128, seed=0):
    """Seeded batch in the split-int8 layout, escapes live (the shapes of
    tests/test_pallas_jpeg8.py::_mk, with weights that keep the output
    mostly unclipped)."""
    rng = np.random.default_rng(seed)
    y_dc = rng.integers(-300, 300, (B, by, pad128(bx))).astype(np.int16)
    c_dc = rng.integers(-300, 300, (B, cy, pad128(cx))).astype(np.int16)
    y_ac = rng.integers(-60, 60, (B, by, lowfreq_ac_width(bx, k))).astype(np.int8)
    cb_ac = rng.integers(-60, 60, (B, cy, lowfreq_ac_width(cx, k))).astype(np.int8)
    cr_ac = rng.integers(-60, 60, (B, cy, lowfreq_ac_width(cx, k))).astype(np.int8)
    ey_idx = np.zeros((LOWFREQ_ESC_Y, 3), np.int32)
    ey_val = np.zeros(LOWFREQ_ESC_Y, np.int32)
    ey_idx[:4] = [[0, 2, 3], [1, 5, bx + 7], [2, 0, 0], [0, by - 1, 2 * bx]]
    ey_val[:4] = [300, -250, 128, -512]
    eb_idx = np.zeros((LOWFREQ_ESC_C, 3), np.int32)
    eb_val = np.zeros(LOWFREQ_ESC_C, np.int32)
    eb_idx[:2] = [[0, 1, 2], [2, cy - 1, cx + 1]]
    eb_val[:2] = [212, -300]
    er_idx = np.zeros((LOWFREQ_ESC_C, 3), np.int32)
    er_val = np.zeros(LOWFREQ_ESC_C, np.int32)
    qt = (rng.random((B, 128)) * 8 + 1).astype(np.float32)

    def w(o, n):
        m = rng.random((U, o, n * k)).astype(np.float32)
        return fold_lowfreq_weights(m / m.sum(axis=2, keepdims=True), k)

    vidx = (np.arange(B) % U).astype(np.int32)
    return [y_dc, y_ac, c_dc, cb_ac, c_dc, cr_ac, ey_idx, ey_val, eb_idx,
            eb_val, er_idx, er_val, qt, w(obh, by), w(obw, bx),
            w(obh // 2, cy), w(obw // 2, cx), vidx], (by, bx, cy, cx)


@needs_card
@pytest.mark.parametrize("k", [2, 4])
def test_kernel_head_matches_plain_head(k):
    arrays, (by, bx, cy, cx) = _inputs(k, seed=k)
    flat = to_port(arrays, "cuda")
    before = jpeg8.LAUNCHES
    got = jpeg8.decode_resize_i8(*flat, k=k)
    torch.cuda.synchronize()
    assert jpeg8.LAUNCHES == before + 3
    want = dct.decode_resize_yuv_lowfreq_i8(
        *flat, by_b=by, bx_b=bx, cy_b=cy, cx_b=cx, k=k)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert_band(got, want)
    assert 0.2 < float(((got > 0) & (got < 255)).float().mean())  # unclipped


@needs_card
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("k", [2, 4])
def test_kernel_plane_matches_plain_plane(k, luma, centered):
    arrays, _ = _inputs(k, seed=10 + k)
    f = to_port(arrays, "cuda")
    dc, ac, (ei, ev) = (f[0], f[1], f[6:8]) if luma else (f[2], f[3], f[8:10])
    qt = jpeg8.qt_lowfreq(f[12], k)[0 if luma else 1].contiguous()
    wv, wh = (f[13], f[14]) if luma else (f[15], f[16])
    args = (dc, jpeg8.widen_scatter(ac, ei, ev), qt, wv, wh, f[17])
    got = jpeg8.folded_plane(*args, k, luma, centered)
    want = jpeg8.folded_plane_plain(*args, k, luma, centered)
    assert got.dtype == (torch.int8 if centered else torch.uint8)
    assert_band(got, want)


@needs_card
def test_kernel_refuses_non_contiguous_input():
    arrays, _ = _inputs(2)
    f = to_port(arrays, "cuda")
    ac16 = jpeg8.widen_scatter(f[1], f[6], f[7])
    wide = torch.cat([ac16, ac16], dim=2)[:, :, : ac16.shape[2]]
    with pytest.raises(ValueError, match="contiguous"):
        jpeg8.folded_plane(f[0], wide, jpeg8.qt_lowfreq(f[12], 2)[0].contiguous(),
                           f[13], f[14], f[17], 2, True)


@needs_card
def test_engine_on_card_matches_engine_on_cpu(monkeypatch):
    """One 1280x720 JPEG -> w=256 WebP through BatchedEngine on the card and
    on the CPU: the planes handed to the VP8 encoder agree within the band
    and the card's run launched K1 three times."""
    from imagekit_tpu.codecs import vp8
    from imagekit_tpu.codecs.native import loader
    from imagekit_tpu.config import ImageFormat, ImageKitConfig
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    rng = np.random.default_rng(3)
    x = np.linspace(0, 255, 1280, dtype=np.float32)[None, :, None]
    y = np.linspace(0, 255, 720, dtype=np.float32)[:, None, None]
    img = np.clip(0.5 * (x + y) + rng.normal(0, 10, (720, 1280, 3)), 0, 255)
    planes_q, qt = host_encode_rgb_to_coefficients(img.astype(np.uint8), 88)
    data = loader.encode_jpeg(planes_q, qt, 1280, 720)

    planes = []
    real = vp8.encode_yuv420

    def rec(yp, u, v, q):
        planes.append((yp.copy(), u.copy(), v.copy()))
        return real(yp, u, v, q)

    monkeypatch.setattr(vp8, "encode_yuv420", rec)
    outs = []
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s"), metrics=Metrics(),
                               device=device)

        async def run():
            try:
                return await engine.transform(data, 256, None, ImageFormat.webp, 80)
            finally:
                await engine.close()

        before = jpeg8.LAUNCHES
        outs.append(asyncio.run(run()))
        assert jpeg8.LAUNCHES - before == (3 if device == "cuda" else 0)
    assert vp8.dimensions(outs[0]) == vp8.dimensions(outs[1]) == (256, 144)
    for a, b in zip(*planes):
        assert_band(torch.from_numpy(a), torch.from_numpy(b))
