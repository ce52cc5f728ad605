"""Tests of the port that need an NVIDIA GPU: K1, K2, K3 and K4 (CUDA
kernels, with no CPU mode) against their plain PyTorch versions, and the
engine on the card against the engine on the CPU, for JPEG and PNG sources.
K2's one-launch RGB entry (``rgb_resize``) and K3/K4's three-plane entries
(``resize_planes3``, ``resize_planes3_f32``) are asserted to launch once a
call; the single-plane entries are held too, and K2's four-channel entry
(``rgba_resize``) with the engine paths that run it and the JPEG pixel
decode.

Each test skips where ``torch.cuda.is_available()`` is false; the
condition is a string, evaluated when the test runs, never at import.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: u8/i8 planes within max |d| <= 1 on at most 0.1% of elements —
fp32 sums taken in another order than the plain version's.
"""

import asyncio
import struct
import zlib

import numpy as np
import pytest
import torch

from imagekit_tpu_torch.ops import jpeg8, resize_strip
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


def _grouped(arrays, device="cuda"):
    """``_inputs``' flat arrays as ``folded_planes_i8`` takes them:
    (dcs, acs, escs, qtabs, stacks, vidx), on ``device``."""
    f = to_port(arrays, device)
    return ((f[0], f[2], f[4]), (f[1], f[3], f[5]),
            ((f[6], f[7]), (f[8], f[9]), (f[10], f[11])), f[12],
            tuple(f[13:17]), f[17])


def _flagship(k, B, seed):
    """The flagship bucket's real folded stacks (1088x1920 -> 240x400, four
    geometries, built as the engine builds them) and seeded levels."""
    from imagekit_tpu_torch.ops.weights import (
        lowfreq_chroma_half_weights,
        lowfreq_luma_weights,
    )

    rng = np.random.default_rng(seed)
    geoms = [(1920, 1080, 400, 225), (1904, 1072, 397, 223),
             (1888, 1064, 393, 222), (1872, 1056, 390, 220)]
    raw = [np.zeros((4, 240, 272 * k // 2), np.float32),
           np.zeros((4, 400, 480 * k // 2), np.float32),
           np.zeros((4, 120, 136 * k // 2), np.float32),
           np.zeros((4, 200, 240 * k // 2), np.float32)]
    for u, (iw, ih, ow, oh) in enumerate(geoms):
        raw[0][u] = lowfreq_luma_weights(ih, oh, k, 1088 * k // 8, 240)
        raw[1][u] = lowfreq_luma_weights(iw, ow, k, 1920 * k // 8, 400)
        raw[2][u] = lowfreq_chroma_half_weights((ih + 1) // 2, ih, oh,
                                                1088 * k // 16, 120, k)
        raw[3][u] = lowfreq_chroma_half_weights((iw + 1) // 2, iw, ow,
                                                1920 * k // 16, 200, k)
    stacks = [fold_lowfreq_weights(w, k) for w in raw]
    by, bx, cy, cx = 136, 240, 68, 120
    arrays = [rng.integers(-600, 600, (B, by, pad128(bx))).astype(np.int16),
              rng.integers(-40, 40, (B, by, lowfreq_ac_width(bx, k))).astype(np.int8)]
    for _ in range(2):
        arrays += [rng.integers(-300, 300, (B, cy, pad128(cx))).astype(np.int16),
                   rng.integers(-30, 30, (B, cy, lowfreq_ac_width(cx, k))).astype(np.int8)]
    for cap in (LOWFREQ_ESC_Y, LOWFREQ_ESC_C, LOWFREQ_ESC_C):
        arrays += [np.zeros((cap, 3), np.int32), np.zeros(cap, np.int32)]
    arrays += [(rng.random((B, 128)) * 8 + 1).astype(np.float32), *stacks,
               (np.arange(B) % 4).astype(np.int32)]
    return arrays, (by, bx, cy, cx)


def _fill_escapes(arrays, dims, k, case, seed=0):
    """Escape lists for the card-only cases: ``full`` fills every list to
    capacity at random sites; ``one_row`` puts all 4096 luma escapes in one
    image's one row (shared-memory atomic contention); ``band_edge`` puts
    them on the first and last rows of some output rows' bands."""
    rng = np.random.default_rng(seed)
    B = arrays[0].shape[0]
    na = k * k - 1
    by, bx, cy, cx = dims
    planes = ((6, by, bx), (8, cy, cx), (10, cy, cx))
    for i, (at, rows, nblk) in enumerate(planes):
        idx, val = arrays[at], arrays[at + 1]
        n = len(val)
        if case == "full" or (case != "none" and i > 0):
            idx[:, 0] = rng.integers(0, B, n)
            idx[:, 1] = rng.integers(0, rows, n)
        elif case == "one_row":
            idx[:, 0] = B - 1
            idx[:, 1] = rows // 2
        elif case == "band_edge":
            band = jpeg8.folded_bands(torch.from_numpy(arrays[13]))[0]
            edges = torch.cat([band[:, 0], band[:, 1] - 1]).clamp(0, rows - 1)
            idx[:, 0] = rng.integers(0, B, n)
            idx[:, 1] = edges.numpy()[rng.integers(0, len(edges), n)]
        if case == "none":
            continue
        # distinct (plane, column) sites per row keep the i16 plain scatter
        # in range; several per site where the list is longer than the row
        site = rng.permutation(n) if case != "one_row" else np.arange(n)
        idx[:, 2] = (site % na) * pad128(nblk) + (site // na) % nblk
        val[:] = rng.integers(-200, 200, n)


@needs_card
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("k", [2, 4])
def test_kernel_head_matches_plain_head(k, batch, centered):
    """One K1 launch for the three planes against the plain version, at
    the flagship's real banded stacks, escapes live, both epilogues."""
    arrays, dims = _flagship(k, batch, seed=k + batch)
    _fill_escapes(arrays, dims, k, "full", seed=k)
    g = _grouped(arrays)
    before = jpeg8.LAUNCHES
    got = jpeg8.folded_planes_i8(*g[:5], None, g[5], k, centered=centered)
    torch.cuda.synchronize()
    assert jpeg8.LAUNCHES == before + 1
    want = jpeg8.folded_planes_i8_plain(*g[:5], None, g[5], k, centered)
    pairs = zip(got, want) if centered else [(got, want)]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert_band(a, b)
        if not centered:
            assert 0.2 < float(((a > 0) & (a < 255)).float().mean())


@needs_card
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("case", ["full", "one_row", "band_edge", "vidx_oob",
                                  "dense_small"])
def test_kernel_plane_matches_plain_plane(case, centered):
    """The escape and index corner cases: lists filled to capacity, all
    4096 luma escapes in one row, escapes on band-edge rows, ``vidx``
    outside the stacks (clamped by both), and dense (unbanded) stacks at
    small shapes; k=2 at B=32, and k=4 for the dense case."""
    if case == "dense_small":
        arrays, dims = _inputs(4, B=32, seed=7)
        k = 4
    else:
        k = 2
        arrays, dims = _flagship(k, 32, seed=3)
        if case == "vidx_oob":
            arrays[17] = np.array([-5, 0, 3, 4, 99] * 6 + [1, 2], np.int32)
    _fill_escapes(arrays, dims, k, "full" if case in ("vidx_oob", "dense_small")
                  else case, seed=11)
    g = _grouped(arrays)
    got = jpeg8.folded_planes_i8(*g[:5], None, g[5], k, centered=centered)
    want = jpeg8.folded_planes_i8_plain(*g[:5], None, g[5], k, centered)
    torch.cuda.synchronize()
    for a, b in (zip(got, want) if centered else [(got, want)]):
        assert_band(a, b)


@needs_card
def test_kernel_refuses_non_contiguous_input():
    arrays, _ = _inputs(2)
    dcs, acs, escs, qt, stacks, vidx = _grouped(arrays)
    wide = torch.cat([acs[0], acs[0]], dim=2)[:, :, : acs[0].shape[2]]
    with pytest.raises(ValueError, match="contiguous"):
        jpeg8.folded_planes_i8(dcs, (wide, *acs[1:]), escs, qt, stacks, None,
                               vidx, 2)


@needs_card
def test_engine_on_card_matches_engine_on_cpu(monkeypatch):
    """One 1280x720 JPEG -> w=256 WebP through BatchedEngine on the card and
    on the CPU: the planes handed to the VP8 encoder agree within the band
    and the card's run launched K1 once."""
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

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
        assert jpeg8.LAUNCHES - before == (1 if device == "cuda" else 0)
    assert vp8.dimensions(outs[0]) == vp8.dimensions(outs[1]) == (256, 144)
    for a, b in zip(*planes):
        assert_band(torch.from_numpy(a), torch.from_numpy(b))


def zlib_png(img: np.ndarray) -> bytes:
    """RGB (or, with four channels, RGBA) PNG with the standard library
    only: filter 0 on every row, zlib level 1."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if img.shape[2] == 4 else 2,
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _k2_inputs(B=5, bh=272, bw=480, obh=96, obw=144, U=4, seed=0):
    """An interleaved (B, bh, bw*3) batch with smooth content, and per-axis
    Lanczos stacks of U geometries (edge row replicated)."""
    from imagekit_tpu_torch.ops.weights import padded_weights

    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, bw, dtype=np.float32)[None, :, None]
    y = np.linspace(0, 255, bh, dtype=np.float32)[:, None, None]
    img = 0.5 * (x + y) + rng.normal(0, 25, (B, bh, bw, 3))
    imgs = np.clip(img, 0, 255).astype(np.uint8).reshape(B, bh, bw * 3)
    wv = np.zeros((U, obh, bh), np.float32)
    wh = np.zeros((U, obw, bw), np.float32)
    for u in range(U):
        to_h, to_w = obh - 2 * u - 1, obw - 3 * u - 1
        wv[u] = padded_weights(bh - 5 * u, to_h, bh, obh)
        wh[u] = padded_weights(bw - 7 * u, to_w, bw, obw)
        wv[u, to_h] = wv[u, to_h - 1]
        wh[u, to_w] = wh[u, to_w - 1]
    vidx = (np.arange(B) % U).astype(np.int32)
    hidx = ((vidx + 1) % U).astype(np.int32)  # the axes keyed separately
    return to_port([imgs, wv, wh, vidx, hidx], "cuda")


K2_EPILOGUES = {
    "u8": dict(),
    "luma_jfif": dict(scale=255.0 / 219.0, pre=-16.0, centered=True),
    "chroma_jfif": dict(scale=255.0 / 224.0, pre=-128.0, post=128.0,
                        centered=True),
}


@needs_card
@pytest.mark.parametrize("epilogue", sorted(K2_EPILOGUES))
def test_k2_matches_plain(epilogue):
    kw = K2_EPILOGUES[epilogue]
    imgs, wv, wh, vidx, hidx = _k2_inputs(seed=len(epilogue))
    B, bh, bw3 = imgs.shape
    x = imgs.reshape(B, bh, bw3 // 3, 3)
    for c in range(3):
        plane = x[..., c].contiguous()
        before = resize_strip.LAUNCHES
        got = resize_strip.plane_resize(plane, wv, wh, vidx, hidx, **kw)
        torch.cuda.synchronize()
        assert resize_strip.LAUNCHES == before + 1
        want = resize_strip.plane_resize_plain(plane, wv, wh, vidx, hidx,
                                               **kw)
        assert got.dtype == want.dtype and got.shape == (B, 96, 144)
        assert_band(got, want)


def _flagship_rgb(batch: int):
    """The flagship RGB bucket (1088x1920 -> 240x400) with four slots per
    axis built as the engine builds them (edge rows replicated)."""
    from imagekit_tpu_torch.ops.weights import padded_weights

    geoms_v = ((1080, 225), (1072, 223), (1064, 222), (1056, 220))
    geoms_h = ((1920, 400), (1904, 397), (1888, 393), (1872, 390))
    wv = np.zeros((4, 240, 1088), np.float32)
    wh = np.zeros((4, 400, 1920), np.float32)
    for u, ((ti, to), (tj, tp)) in enumerate(zip(geoms_v, geoms_h)):
        wv[u] = padded_weights(ti, to, 1088, 240)
        wh[u] = padded_weights(tj, tp, 1920, 400)
        wv[u, to] = wv[u, to - 1]
        wh[u, tp:tp + 1] = wh[u, tp - 1]
    rng = np.random.default_rng(batch)
    x = np.linspace(0, 255, 1920 * 3, dtype=np.float32)[None, None, :]
    y = np.linspace(0, 255, 1088, dtype=np.float32)[None, :, None]
    imgs = np.clip(0.5 * (x + y) + rng.normal(0, 25, (batch, 1088, 1920 * 3)),
                   0, 255).astype(np.uint8)
    vidx = (np.arange(batch) % 4).astype(np.int32)
    return to_port([imgs, wv, wh, vidx, (vidx + 1) % 4], "cuda")


@needs_card
@pytest.mark.parametrize("shape", ["small_b5", "flagship_b1", "flagship_b32"])
def test_k2_rgb_matches_plain(shape):
    """One K2 launch for the three channels of an interleaved batch against
    the plain version, per channel."""
    if shape == "small_b5":
        imgs, wv, wh, vidx, hidx = _k2_inputs(seed=5)
    else:
        imgs, wv, wh, vidx, hidx = _flagship_rgb(int(shape.split("_b")[1]))
    bands = resize_strip.resize_tables(wv, wh)
    before = resize_strip.LAUNCHES
    got = resize_strip.rgb_resize(imgs, wv, wh, vidx, hidx, bands=bands)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES == before + 1
    want = resize_strip.rgb_resize_plain(imgs, wv, wh, vidx, hidx)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    for c in range(3):
        assert_band(got[:, c], want[:, c])
    assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


@needs_card
@pytest.mark.parametrize("channels", [3, 4])
def test_k2_strips_equal_whole_rows_at_the_flagship(channels):
    """K2's column strips asked for (128 output columns a block) where
    whole rows fit: each output sums the same terms in the same order, so
    the bytes are the whole-row body's."""
    imgs, wv, wh, vidx, hidx = _flagship_rgb(8)
    entry = resize_strip.rgb_resize
    if channels == 4:
        px = imgs.reshape(8, 1088, 1920, 3)
        imgs = torch.cat([px, px[..., :1].flip(1)], -1).reshape(8, 1088, -1)
        entry = resize_strip.rgba_resize
    bands = resize_strip.resize_tables(wv, wh)
    whole = entry(imgs, wv, wh, vidx, hidx, bands=bands)
    before = resize_strip.LAUNCHES_STRIPS
    got = entry(imgs, wv, wh, vidx, hidx, bands=bands, strip=128)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES_STRIPS == before + 1
    assert torch.equal(got, whole)


@needs_card
@pytest.mark.parametrize("channels,width", [(3, 9600), (4, 8192)])
def test_k2_strips_on_rows_past_the_whole_row_ceiling(channels, width):
    """Rows too wide for a tile of whole rows (9600 RGB pixels, an RGBA
    row of the 8192 bucket) take the strips on their own, within the band
    of the plain version."""
    from imagekit_tpu_torch.ops.weights import exact_stacks

    wv, wh = exact_stacks(96, width, 24, width // 16)
    rng = np.random.default_rng(channels)
    x = np.linspace(0, 255, width * channels, dtype=np.float32)[None, None]
    imgs = np.clip(x + rng.normal(0, 25, (2, 96, width * channels)), 0,
                   255).astype(np.uint8)
    idx = np.zeros(2, np.int32)
    imgs, wv, wh, vidx, hidx = to_port([imgs, wv, wh, idx, idx], "cuda")
    entry, plain = ((resize_strip.rgb_resize, resize_strip.rgb_resize_plain)
                    if channels == 3 else
                    (resize_strip.rgba_resize, resize_strip.rgba_resize_plain))
    before = resize_strip.LAUNCHES_STRIPS
    got = entry(imgs, wv, wh, vidx, hidx)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES_STRIPS == before + 1
    assert_band(got, plain(imgs, wv, wh, vidx, hidx))


@needs_card
@pytest.mark.parametrize("epilogue", sorted(K2_EPILOGUES))
def test_k2_plane_at_the_yuvjpg_chroma_shape(epilogue):
    """A contiguous 544x960 plane -> 120x200, the yuvjpg chroma shape,
    whose tile, weights and ring take exactly 48 KB of dynamic shared
    memory (the launch must raise the limit for the static arrays)."""
    from imagekit_tpu_torch.ops.weights import padded_weights

    kw = K2_EPILOGUES[epilogue]
    wv = np.zeros((2, 120, 544), np.float32)
    wh = np.zeros((2, 200, 960), np.float32)
    for u in range(2):
        wv[u] = padded_weights(540 - 4 * u, 113 - u, 544, 120)
        wh[u] = padded_weights(960 - 8 * u, 200 - 2 * u, 960, 200)
    planes = _k3_planes(2, 544, 960, seed=6)
    x, wv, wh = to_port([planes, wv, wh], "cuda")
    vidx = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    before = resize_strip.LAUNCHES
    got = resize_strip.plane_resize(x, wv, wh, vidx, 1 - vidx, **kw)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES == before + 1
    assert_band(got, resize_strip.plane_resize_plain(x, wv, wh, vidx,
                                                     1 - vidx, **kw))


@needs_card
def test_k2_refuses_a_channel_view():
    """``plane_resize`` reads contiguous planes: a channel view of an
    interleaved batch on the card is refused before any launch (its three
    channels go through ``rgb_resize``)."""
    imgs, wv, wh, vidx, hidx = _k2_inputs(seed=3)
    B, bh, bw3 = imgs.shape
    view = imgs.reshape(B, bh, bw3 // 3, 3)[..., 2]
    before = resize_strip.LAUNCHES
    with pytest.raises(ValueError, match="must be contiguous"):
        resize_strip.plane_resize(view, wv, wh, vidx, hidx)
    assert resize_strip.LAUNCHES == before


@needs_card
@pytest.mark.parametrize("fmt", ["webp", "jpeg"])
def test_png_engine_on_card_matches_engine_on_cpu(monkeypatch, fmt):
    """One 960x540 PNG -> w=200 through BatchedEngine on the card and on the
    CPU: what the host encoder gets agrees within the band, and the card's
    run launched K2 once."""
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops.weights import target_dimensions
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    imgs, *_ = _k2_inputs(B=1, bh=540, bw=960)
    data = zlib_png(imgs[0].cpu().numpy().reshape(540, 960, 3))
    seen = []
    real_vp8, real_jpeg = vp8.encode_yuv420, loader.encode_jpeg

    def rec_vp8(yp, u, v, q):
        seen.append((yp.copy(), u.copy(), v.copy()))
        return real_vp8(yp, u, v, q)

    def rec_jpeg(planes, qtabs, width, height):
        seen.append(tuple(np.array(p) for p in planes))
        return real_jpeg(planes, qtabs, width, height)

    monkeypatch.setattr(vp8, "encode_yuv420", rec_vp8)
    monkeypatch.setattr(loader, "encode_jpeg", rec_jpeg)
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s"), metrics=Metrics(),
                               device=device)

        async def run():
            try:
                return await engine.transform(data, 200, None,
                                              ImageFormat(fmt), 80)
            finally:
                await engine.close()

        before = resize_strip.LAUNCHES
        out = asyncio.run(run())
        assert resize_strip.LAUNCHES - before == (1 if device == "cuda" else 0)
        if fmt == "webp":
            assert vp8.dimensions(out) == target_dimensions(960, 540, 200, None)
    for a, b in zip(*seen):
        assert_band(torch.from_numpy(a), torch.from_numpy(b))


# -- K3 and K4 ---------------------------------------------------------------------

# four (source w, h, target w, h) slots of the slice's bucket pair,
# 1088x1920 -> 240x400: the RGB head's luma stacks and its chroma stacks to
# FULL output resolution (544x960 -> 240x400)
K3_GEOMS = [(1920, 1080, 400, 225), (1904, 1072, 397, 223),
            (1888, 1064, 393, 222), (1872, 1056, 390, 220)]


def _k3_stacks(plane: str):
    from imagekit_tpu_torch.ops.weights import (
        combined_chroma_weights,
        padded_weights,
    )

    ih, iw = (1088, 1920) if plane == "luma" else (544, 960)
    wv = np.zeros((4, 240, ih), np.float32)
    wh = np.zeros((4, 400, iw), np.float32)
    for u, (sw, sh, ow, oh) in enumerate(K3_GEOMS):
        if plane == "luma":
            wv[u] = padded_weights(sh, oh, ih, 240)
            wh[u] = padded_weights(sw, ow, iw, 400)
        else:
            wv[u] = combined_chroma_weights((sh + 1) // 2, sh, oh, ih, 240)
            wh[u] = combined_chroma_weights((sw + 1) // 2, sw, ow, iw, 400)
    return wv, wh


def _k3_planes(batch: int, ih: int, iw: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, iw, dtype=np.float32)[None, None, :]
    y = np.linspace(0, 255, ih, dtype=np.float32)[None, :, None]
    img = 0.5 * (x + y) + rng.normal(0, 25, (batch, ih, iw))
    return np.clip(img, 0, 255).astype(np.uint8)


@needs_card
@pytest.mark.parametrize("f32", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("batch", [1, 32])
def test_k3_k4_match_plain(batch, plane, f32):
    """K3 (u8) and K4 (f32) against their plain versions at the demoted
    head's shapes, four vidx slots: one plane shape, as all three planes of
    one launch."""
    from imagekit_tpu_torch.ops import resize_planes as rp

    wv, wh = _k3_stacks(plane)
    planes = _k3_planes(batch, wv.shape[2], wh.shape[2], seed=batch)
    x, wv, wh = to_port([planes, wv, wh], "cuda")
    if f32:
        x = x.float() + 0.25
    vidx = torch.arange(batch, dtype=torch.int32, device="cuda") % 4
    fn, plain = ((rp.resize_planes3_f32, rp.resize_planes_f32_plain) if f32
                 else (rp.resize_planes3, rp.resize_planes_plain))
    counter = "LAUNCHES_F32" if f32 else "LAUNCHES"
    before = getattr(rp, counter)
    outs = fn((x, x, x), (wv, wh, wv, wh), vidx)
    torch.cuda.synchronize()
    assert getattr(rp, counter) == before + 1
    want = plain(x, wv, wh, vidx)
    for got in outs:
        assert got.dtype == want.dtype and got.shape == (batch, 240, 400)
        if f32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=255e-5)
        else:
            assert_band(got, want)
            assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


@needs_card
@pytest.mark.parametrize("f32", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("batch", [1, 32])
def test_k3_k4_three_planes_match_plain(batch, f32):
    """Y (1088x1920) and Cb, Cr (544x960) to 240x400 with their own stacks,
    the demoted head's shapes: one launch of K3 (u8) or K4 (f32) against
    the plain version, plane by plane."""
    from imagekit_tpu_torch.ops import resize_planes as rp

    luma, chroma = _k3_stacks("luma"), _k3_stacks("chroma")
    stacks = to_port([*luma, *chroma], "cuda")
    planes = to_port([_k3_planes(batch, 1088, 1920, seed=batch),
                      _k3_planes(batch, 544, 960, seed=batch + 1),
                      _k3_planes(batch, 544, 960, seed=batch + 2)], "cuda")
    if f32:
        planes = [p.float() + 0.25 for p in planes]
    vidx = torch.arange(batch, dtype=torch.int32, device="cuda") % 4
    bands = (resize_strip.resize_tables(*stacks[:2]),
             resize_strip.resize_tables(*stacks[2:]))
    fn, plain = ((rp.resize_planes3_f32, rp.resize_planes3_f32_plain) if f32
                 else (rp.resize_planes3, rp.resize_planes3_plain))
    counter = "LAUNCHES_F32" if f32 else "LAUNCHES"
    before = getattr(rp, counter)
    got = fn(planes, stacks, vidx, bands=bands)
    torch.cuda.synchronize()
    assert getattr(rp, counter) == before + 1
    for a, b in zip(got, plain(planes, stacks, vidx)):
        assert a.dtype == b.dtype and a.shape == (batch, 240, 400)
        if f32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=255e-5)
        else:
            assert_band(a, b)


@needs_card
@pytest.mark.parametrize("layout", ["444", "422"])
def test_k3_at_the_pixel_decode_geometries_beyond_420(layout):
    """K3 as the JPEG pixel decode of a 1080p source beyond 4:2:0 (a luma
    MCU of 8 rows: 135 block rows), one launch against the plain version:
    4:4:4 (three 1080x1920 planes, identity stacks) and 4:2:2 (chroma
    1080x960 -> 1080x1920, the upsample on the horizontal axis only)."""
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops.weights import chroma_axis_weights

    cx = 240 if layout == "444" else 120  # chroma blocks a row
    stacks = to_port([chroma_axis_weights(135, 135)[None],
                      chroma_axis_weights(240, 240)[None],
                      chroma_axis_weights(135, 135)[None],
                      chroma_axis_weights(240, cx)[None]], "cuda")
    planes = to_port([_k3_planes(1, 1080, 1920, seed=5),
                      _k3_planes(1, 1080, cx * 8, seed=6),
                      _k3_planes(1, 1080, cx * 8, seed=7)], "cuda")
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    before = rp.LAUNCHES
    got = rp.resize_planes3(planes, stacks, vidx)
    torch.cuda.synchronize()
    assert rp.LAUNCHES == before + 1
    for a, b in zip(got, rp.resize_planes3_plain(planes, stacks, vidx)):
        assert a.dtype == b.dtype == torch.uint8 and a.shape == (1, 1080, 1920)
        assert_band(a, b)
    assert torch.equal(got[0], planes[0])  # the identity, exactly


def block_edge_image(seed: int, w: int, h: int) -> np.ndarray:
    """Escape-dense content: each 8x8 block holds a hard edge between two
    random colours, so its lowest AC levels pass int8 at q100."""
    rng = np.random.default_rng(seed)
    by, bx = h // 8, w // 8
    a = rng.integers(0, 256, (by, bx, 1, 1, 3))
    b = rng.integers(0, 256, (by, bx, 1, 1, 3))
    left = (np.arange(8) < 4)[None, None, None, :, None]
    blk = np.broadcast_to(np.where(left, a, b), (by, bx, 8, 8, 3)).copy()
    flip = rng.random((by, bx)) < 0.5
    blk[flip] = blk[flip].transpose(0, 2, 1, 3)
    img = blk.transpose(0, 2, 1, 3, 4).reshape(h, w, 3)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def native_jpeg(img: np.ndarray, quality: int, samp=(2, 2)) -> bytes:
    """A JPEG without Pillow: the port's numpy fDCT + the native encoder;
    ``samp`` is the luma's sampling factors (4:2:0 by default)."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    planes, qt = host_encode_rgb_to_coefficients(img, quality, samp)
    return loader.encode_jpeg(planes, qt, img.shape[1], img.shape[0], samp)


@needs_card
@pytest.mark.parametrize("samp", [(1, 1), (2, 1), (1, 2), "gray"],
                         ids=["444", "422", "440", "gray"])
def test_pixel_decode_layouts_on_card_match_cpu(samp):
    """The JPEG pixel decode of a 4:4:4, 4:2:2, 4:4:0 and grayscale JPEG on
    the card (one K3 launch) against the CPU (K3's plain version): RGB
    within the pixel decode's band, +-2 on at most 0.1% of values."""
    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops import resize_planes
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    imgs, *_ = _k2_inputs(B=1, bh=544, bw=960)
    img = imgs[0].cpu().numpy().reshape(544, 960, 3)[:539, :957]
    if samp == "gray":
        planes, qt = host_encode_rgb_to_coefficients(img, 90, (1, 1))
        data = loader.encode_jpeg(planes[:1], qt, 957, 539, (1, 1))
    else:
        data = native_jpeg(img, 90, samp)
    before = resize_planes.LAUNCHES
    got = jpeg.decode_rgb(data, device="cuda")
    assert resize_planes.LAUNCHES == before + 1
    want = jpeg.decode_rgb(data, device="cpu")
    assert got.shape == want.shape == (539, 957, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["jxc_k2", "jxc_k8", "demoted"])
def test_jpeg_to_jpeg_engine_on_card_matches_engine_on_cpu(monkeypatch, case):
    """One JPEG -> JPEG batch through BatchedEngine on the card and on the
    CPU: a jxc batch (K1, centred epilogue, one launch at k=2), a k=8
    one, and an escape-dense source demoted to the RGB head (one K3
    launch). Levels handed to the encoder within the band; the demoted
    RGB within +-2 (a chroma step times the 1.772 of the matrix)."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    if case == "demoted":
        data, w, size = native_jpeg(block_edge_image(1, 640, 480), 100), 240, (240, 180)
    else:
        x = np.linspace(0, 255, 1280, dtype=np.float32)[None, :, None]
        y = np.linspace(0, 255, 720, dtype=np.float32)[:, None, None]
        rng = np.random.default_rng(4)
        img = np.clip(0.5 * (x + y) + rng.normal(0, 10, (720, 1280, 3)), 0, 255)
        w = 256 if case == "jxc_k2" else 960
        data, size = native_jpeg(img.astype(np.uint8), 85), (w, w * 9 // 16)
    levels, rgb = [], []
    real_jpeg, real_rgb = loader.encode_jpeg, engine_jpeg.decode_resize_rgb_batch

    def rec_jpeg(planes, qtabs, width, height):
        levels.append(tuple(np.array(p) for p in planes))
        return real_jpeg(planes, qtabs, width, height)

    def rec_rgb(*args, **kw):
        rgb.append(real_rgb(*args, **kw))
        return rgb[-1]

    monkeypatch.setattr(loader, "encode_jpeg", rec_jpeg)
    monkeypatch.setattr(engine_jpeg, "decode_resize_rgb_batch", rec_rgb)
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s"), metrics=Metrics(),
                               device=device)

        async def run():
            try:
                return await engine.transform(data, w, None, ImageFormat.jpeg, 80)
            finally:
                await engine.close()

        k1, k3 = jpeg8.LAUNCHES, rp.LAUNCHES
        out = asyncio.run(run())
        on_card = device == "cuda"
        assert jpeg8.LAUNCHES - k1 == (1 if on_card and case == "jxc_k2" else 0)
        assert rp.LAUNCHES - k3 == (1 if on_card and case == "demoted" else 0)
        hdr = jpeg_abi.parse(loader.load(), out)
        assert (hdr.width, hdr.height) == size
    assert len(rgb) == (2 if case == "demoted" else 0)
    if rgb:
        d = np.abs(rgb[0].astype(np.int32) - rgb[1].astype(np.int32))
        assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE
    for a, b in zip(*levels):
        assert_band(torch.from_numpy(a), torch.from_numpy(b))


# -- the int16 entry of K1, K4 on u8 planes, K2 on the three planes of a
# YUV-source batch, and the engine paths that launch them ---------------------


def _grouped_levels(arrays, dims, k):
    """``_flagship``'s planar split arrays regrouped to the int16
    transport: per plane (B, rows, pad128(nblk*k*k)) block-grouped levels
    (level lin of block column c at c*k*k + lin), with levels past int8."""
    by, bx, cy, cx = dims
    nk, na = k * k, k * k - 1
    flats = []
    for dc, ac, rows, nblk in ((arrays[0], arrays[1], by, bx),
                               (arrays[2], arrays[3], cy, cx),
                               (arrays[4], arrays[5], cy, cx)):
        B, p = dc.shape[0], pad128(nblk)
        lev = np.zeros((B, rows, nblk, nk), np.int16)
        lev[..., 0] = dc[:, :, :nblk]
        for j in range(na):
            lev[..., j + 1] = ac[:, :, j * p:j * p + nblk]
        lev[..., 1] *= 9  # past int8: what this transport carries
        flat = np.full((B, rows, pad128(nblk * nk)), 777, np.int16)
        flat[:, :, : nblk * nk] = lev.reshape(B, rows, -1)
        flats.append(flat)
    return flats


@needs_card
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("k", [2, 4])
def test_int16_entry_matches_plain(k, batch, centered):
    """K1's int16 entry, one launch for the three planes, against its plain
    version at the flagship's real banded stacks."""
    arrays, dims = _flagship(k, batch, seed=k + batch)
    flats = to_port(_grouped_levels(arrays, dims, k), "cuda")
    qt, *stacks, vidx = to_port(arrays[12:], "cuda")
    before = jpeg8.LAUNCHES
    got = jpeg8.folded_planes_i16(flats, qt, stacks, None, vidx, k, centered)
    torch.cuda.synchronize()
    assert jpeg8.LAUNCHES == before + 1
    want = jpeg8.folded_planes_i16_plain(flats, qt, stacks, None, vidx, k,
                                         centered)
    for a, b in (zip(got, want) if centered else [(got, want)]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert_band(a, b)
        if not centered:
            assert 0.2 < float(((a > 0) & (a < 255)).float().mean())


def _yuv_head_stacks(jq: bool):
    """The k = 8 YUV head's and the YUV-source heads' stacks at the flagship
    bucket pair: luma 1088x1920 -> 240x400, chroma 544x960 -> HALF output
    resolution 120x200; for JPEG output the rows past the true output
    replicate the last true row up to the MCU grid."""
    from imagekit_tpu_torch.ops.weights import (
        combined_chroma_half_weights,
        padded_weights,
    )

    geoms = [(1920, 1080, 400, 225), (1904, 1072, 397, 223),
             (1888, 1064, 393, 222), (1872, 1056, 390, 220)]
    wv_y = np.zeros((4, 240, 1088), np.float32)
    wh_y = np.zeros((4, 400, 1920), np.float32)
    wv_c = np.zeros((4, 120, 544), np.float32)
    wh_c = np.zeros((4, 200, 960), np.float32)
    for u, (iw, ih, ow, oh) in enumerate(geoms):
        wv_y[u] = padded_weights(ih, oh, 1088, 240)
        wh_y[u] = padded_weights(iw, ow, 1920, 400)
        wv_c[u] = combined_chroma_half_weights((ih + 1) // 2, ih, oh, 544, 120)
        wh_c[u] = combined_chroma_half_weights((iw + 1) // 2, iw, ow, 960, 200)
        if jq:
            m_h, m_w = min((oh + 15) // 16 * 16, 240), min((ow + 15) // 16 * 16, 400)
            wv_y[u, oh:m_h] = wv_y[u, oh - 1]
            wh_y[u, ow:m_w] = wh_y[u, ow - 1]
            wv_c[u, (oh + 1) // 2: m_h // 2] = wv_c[u, (oh + 1) // 2 - 1]
            wh_c[u, (ow + 1) // 2: m_w // 2] = wh_c[u, (ow + 1) // 2 - 1]
    return to_port([wv_y, wh_y, wv_c, wh_c], "cuda")


@needs_card
@pytest.mark.parametrize("batch", [1, 32])
def test_k4_on_u8_planes_matches_plain(batch):
    """K4's u8-in / f32-out instantiation (the k = 8 JPEG -> WebP head's):
    Y and the two chroma planes in one launch, against the plain version and
    against K4 on the planes widened to f32 (the same sums)."""
    from imagekit_tpu_torch.ops import resize_planes as rp

    stacks = _yuv_head_stacks(False)
    planes = to_port([_k3_planes(batch, 1088, 1920, seed=batch),
                      _k3_planes(batch, 544, 960, seed=batch + 1),
                      _k3_planes(batch, 544, 960, seed=batch + 2)], "cuda")
    vidx = torch.arange(batch, dtype=torch.int32, device="cuda") % 4
    bands = (resize_strip.resize_tables(*stacks[:2]),
             resize_strip.resize_tables(*stacks[2:]))
    before = rp.LAUNCHES_F32
    got = rp.resize_planes3_f32(planes, stacks, vidx, bands=bands)
    wide = rp.resize_planes3_f32([p.float() for p in planes], stacks, vidx,
                                 bands=bands)
    torch.cuda.synchronize()
    assert rp.LAUNCHES_F32 == before + 2
    want = rp.resize_planes3_f32_plain(planes, stacks, vidx)
    for a, b, c, shape in zip(got, want, wide, ((240, 400), (120, 200),
                                                (120, 200))):
        assert a.dtype == torch.float32 and a.shape == (batch, *shape)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=255e-5)
        assert torch.equal(a, c)


@needs_card
@pytest.mark.parametrize("jpeg", [False, True], ids=["webp_out", "jpeg_out"])
@pytest.mark.parametrize("batch", [1, 32])
def test_k2_three_yuv_planes_match_plain(batch, jpeg):
    """The YUV-source heads' launch: the Y, Cb and Cr views of one flat
    (B, pad128(1088*1920*3/2)) batch in ONE K2 launch, rounded u8 (WebP
    output) or remapped by each plane's own constants and centred (JPEG
    output), against the plain version; then the whole heads."""
    from imagekit_tpu_torch.ops import dct

    stacks = _yuv_head_stacks(jpeg)
    ny, nc = 1088 * 1920, 544 * 960
    rng = np.random.default_rng(batch)
    host = np.zeros((batch, pad128(ny + 2 * nc)), np.uint8)
    for at, (h, w) in ((0, (1088, 1920)), (ny, (544, 960)), (ny + nc, (544, 960))):
        host[:, at:at + h * w] = _k3_planes(batch, h, w, seed=at % 7).reshape(
            batch, -1)
    host[:, ny + 2 * nc:] = rng.integers(0, 256, host.shape[1] - ny - 2 * nc)
    flat = torch.from_numpy(host).cuda()
    vidx = torch.arange(batch, dtype=torch.int32, device="cuda") % 4
    bands = (resize_strip.resize_tables(*stacks[:2]),
             resize_strip.resize_tables(*stacks[2:]))
    planes = dct.yuv_planes(flat, 1088, 1920)
    before = resize_strip.LAUNCHES
    got = resize_strip.yuv_resize(planes, stacks, vidx, jpeg=jpeg, bands=bands)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES == before + 1
    want = resize_strip.yuv_resize_plain(planes, stacks, vidx, jpeg=jpeg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == (torch.int8 if jpeg else torch.uint8)
        assert_band(a, b)
    lo, hi = (-128, 127) if jpeg else (0, 255)
    assert 0.2 < float(((got[0] > lo) & (got[0] < hi)).float().mean())
    if jpeg:
        qt = torch.full((batch, 128), 8.0, device="cuda")
        a = dct.resize_yuv_jpeg(flat, stacks, qt, vidx, (1088, 1920), bands)
        b = dct.resize_yuv_jpeg(flat, stacks, qt, vidx, (1088, 1920), bands,
                                resize=resize_strip.yuv_resize_plain)
    else:
        a = dct.resize_yuv420(flat, stacks, vidx, (1088, 1920), bands)
        b = dct.resize_yuv420(flat, stacks, vidx, (1088, 1920), bands,
                              resize=resize_strip.yuv_resize_plain)
    assert_band(a, b)


def native_webp(img: np.ndarray, quality: int) -> bytes:
    """A lossy WebP without Pillow: BT.601 studio-range planes (a 2x2 box for
    the chroma) through the port's VP8 encoder."""
    from imagekit_tpu_torch.codecs import vp8

    rgb = img.astype(np.float32)
    h, w = rgb.shape[:2]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0

    def half(c):
        c = np.pad(c, ((0, h & 1), (0, w & 1)), mode="edge")
        return c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))

    q8 = lambda p: np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8)  # noqa: E731
    return vp8.encode_yuv420(q8(y), q8(half(cb)), q8(half(cr)), quality)


@needs_card
@pytest.mark.parametrize("case", ["jpeg_k8", "dense_k2", "dense_k8",
                                  "webp_webp", "webp_jpeg"])
def test_new_paths_on_card_match_engine_on_cpu(monkeypatch, case):
    """One batch of each request this slice added, through BatchedEngine on
    the card and on the CPU: JPEG -> WebP at k = 8 (one K4 launch),
    escape-dense JPEG -> WebP at k = 2 (one launch of K1's int16 entry) and
    at k = 8 (K4), lossy WebP -> WebP and -> JPEG (one K2 launch each). What
    the host encoders are handed agrees within the band."""
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    x = np.linspace(0, 255, 1280, dtype=np.float32)[None, :, None]
    y = np.linspace(0, 255, 720, dtype=np.float32)[:, None, None]
    img = np.clip(0.5 * (x + y) + np.random.default_rng(4).normal(
        0, 10, (720, 1280, 3)), 0, 255).astype(np.uint8)
    fmt = ImageFormat.jpeg if case == "webp_jpeg" else ImageFormat.webp
    if case == "jpeg_k8":
        data, w, want = native_jpeg(img, 85), 960, (0, 0, 1)
    elif case.startswith("dense"):
        data = native_jpeg(block_edge_image(1, 640, 480), 100)
        w, want = (120, (1, 0, 0)) if case == "dense_k2" else (400, (0, 0, 1))
    else:
        data, w, want = native_webp(img, 80), 256, (0, 1, 0)
    handed = []
    real_vp8, real_jpeg = vp8.encode_yuv420, loader.encode_jpeg

    def rec_vp8(yp, u, v, q):
        handed.append((yp.copy(), u.copy(), v.copy()))
        return real_vp8(yp, u, v, q)

    def rec_jpeg(planes, qtabs, width, height):
        handed.append(tuple(np.array(p) for p in planes))
        return real_jpeg(planes, qtabs, width, height)

    monkeypatch.setattr(vp8, "encode_yuv420", rec_vp8)
    monkeypatch.setattr(loader, "encode_jpeg", rec_jpeg)
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s"), metrics=Metrics(),
                               device=device)

        async def run():
            try:
                return await engine.transform(data, w, None, fmt, 80)
            finally:
                await engine.close()

        before = (jpeg8.LAUNCHES, resize_strip.LAUNCHES, rp.LAUNCHES_F32)
        out = asyncio.run(run())
        after = (jpeg8.LAUNCHES, resize_strip.LAUNCHES, rp.LAUNCHES_F32)
        assert tuple(a - b for a, b in zip(after, before)) == (
            want if device == "cuda" else (0, 0, 0))
        assert (out[:4] == b"RIFF") == (fmt == ImageFormat.webp)
    assert len(handed) == 2
    for a, b in zip(*handed):
        assert_band(torch.from_numpy(a), torch.from_numpy(b))


# -- K2 with four channels a pixel, and the single-image paths --------------------------


def _rgba_inputs(shape: str):
    """An interleaved RGBA batch with its stacks: a small mixed bucket
    (B=5), or the flagship bucket at B=1 / B=32."""
    if shape == "small_b5":
        imgs, wv, wh, vidx, hidx = _k2_inputs(seed=7)
    else:
        imgs, wv, wh, vidx, hidx = _flagship_rgb(int(shape.split("_b")[1]))
    B, H, WC = imgs.shape
    px = imgs.reshape(B, H, WC // 3, 3)
    alpha = px.flip(2)[..., :1]  # the image mirrored: varies in both axes
    return torch.cat([px, alpha], dim=-1).reshape(B, H, -1), wv, wh, vidx, hidx


@needs_card
@pytest.mark.parametrize("shape", ["small_b5", "flagship_b1", "flagship_b32"])
def test_k2_rgba_matches_plain(shape):
    """One K2 launch for the four channels of an interleaved RGBA batch,
    stored interleaved, against the plain version; the launch is counted
    apart from the three-channel entry's."""
    imgs, wv, wh, vidx, hidx = _rgba_inputs(shape)
    bands = resize_strip.resize_tables(wv, wh)
    before = (resize_strip.LAUNCHES, resize_strip.LAUNCHES_RGBA)
    got = resize_strip.rgba_resize(imgs, wv, wh, vidx, hidx, bands=bands)
    torch.cuda.synchronize()
    assert (resize_strip.LAUNCHES, resize_strip.LAUNCHES_RGBA) == (
        before[0], before[1] + 1)
    want = resize_strip.rgba_resize_plain(imgs, wv, wh, vidx, hidx)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert got.shape[-1] == 4 and got.is_contiguous()
    assert_band(got, want)
    # the RGB channels are the three-channel entry's, bit for bit: the same
    # sums in the same order at another tile height
    B, H, WC = imgs.shape
    rgb = imgs.reshape(B, H, WC // 4, 4)[..., :3].reshape(B, H, -1).contiguous()
    planes = resize_strip.rgb_resize(rgb, wv, wh, vidx, hidx, bands=bands)
    assert torch.equal(got[..., :3], planes.permute(0, 2, 3, 1))
    assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


@needs_card
def test_k2_rgba_refuses_what_it_does_not_take():
    imgs, wv, wh, vidx, hidx = _rgba_inputs("small_b5")
    with pytest.raises(ValueError, match="contiguous"):
        resize_strip.rgba_resize(imgs.transpose(0, 1).contiguous().transpose(0, 1),
                                 wv, wh, vidx, hidx)
    with pytest.raises(ValueError, match="is on"):
        resize_strip.rgba_resize(imgs, wv.cpu(), wh, vidx, hidx)
    before = resize_strip.LAUNCHES_RGBA
    with pytest.raises(TypeError, match="int32"):
        resize_strip.rgba_resize(imgs, wv, wh, vidx.long(), hidx)
    assert resize_strip.LAUNCHES_RGBA == before


@needs_card
@pytest.mark.parametrize("case", ["rgba_webp", "rgba_jpeg", "jpeg_no_resize",
                                  "png_no_resize_jpeg"])
def test_alpha_and_single_image_paths_on_card_match_cpu(monkeypatch, case):
    """An RGBA PNG -> w=200 (the plain RGB head: one launch of K2's
    four-channel entry), and requests with no resize (from a JPEG: one K3
    launch, the pixel decode), through the engine on the card and on the
    CPU: what the host encoder gets agrees within the band."""
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import resize_planes
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    imgs, *_ = _k2_inputs(B=1, bh=540, bw=960)
    img = imgs[0].cpu().numpy().reshape(540, 960, 3)
    if case.startswith("rgba"):
        data = zlib_png(np.dstack([img, img[::-1, :, :1]]))
        w, fmt = 200, ImageFormat(case.split("_")[1])
    elif case == "jpeg_no_resize":
        data, w, fmt = native_jpeg(img, 90), None, ImageFormat.webp
    else:
        data, w, fmt = zlib_png(img), None, ImageFormat.jpeg
    seen = []
    real_vp8, real_jpeg = vp8.encode_yuv420, loader.encode_jpeg

    def rec_vp8(yp, u, v, q):
        seen.append((yp.copy(), u.copy(), v.copy()))
        return real_vp8(yp, u, v, q)

    def rec_jpeg(planes, qtabs, width, height):
        seen.append(tuple(np.array(p) for p in planes))
        return real_jpeg(planes, qtabs, width, height)

    monkeypatch.setattr(vp8, "encode_yuv420", rec_vp8)
    monkeypatch.setattr(loader, "encode_jpeg", rec_jpeg)
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s"), metrics=Metrics(),
                               device=device)

        async def run():
            try:
                return await engine.transform(data, w, None, fmt, 80)
            finally:
                await engine.close()

        before = (resize_strip.LAUNCHES_RGBA, resize_planes.LAUNCHES)
        asyncio.run(run())
        after = (resize_strip.LAUNCHES_RGBA, resize_planes.LAUNCHES)
        on_card = device == "cuda"
        assert after[0] - before[0] == int(on_card and case.startswith("rgba"))
        assert after[1] - before[1] == int(on_card and case == "jpeg_no_resize")
    assert len(seen) == 2
    for a, b in zip(*seen):
        d = (torch.from_numpy(a).int() - torch.from_numpy(b).int()).abs()
        # the pixel decode's band: a chroma step times 1.772 (+-2 in RGB)
        # reaches the encoder's planes as at most +-1 after the colour mix
        assert int(d.max()) <= (2 if case == "jpeg_no_resize" else 1)
        assert float((d > 0).float().mean()) <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("n", [1, 2, 3])
def test_k3_planes_with_their_own_stacks_match_plain(n):
    """K3's entry for one to three planes, each with its own stacks (the
    four-component pixel decode's): one launch a call, each plane within
    the band of its plain version."""
    from imagekit_tpu_torch.ops import resize_planes
    from imagekit_tpu_torch.ops.weights import chroma_axis_weights

    rng = np.random.default_rng(n)
    grids = [(34, 60), (17, 30), (34, 30)][:n]
    planes = [torch.from_numpy(rng.integers(0, 256, (1, by * 8, bx * 8),
                                            np.uint8)).cuda()
              for by, bx in grids]
    stacks = [(torch.from_numpy(chroma_axis_weights(34, by)[None]).cuda(),
               torch.from_numpy(chroma_axis_weights(60, bx)[None]).cuda())
              for by, bx in grids]
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    before = resize_planes.LAUNCHES
    got = resize_planes.resize_planes_u8(planes, stacks, vidx)
    assert resize_planes.LAUNCHES == before + 1
    for p, (wv, wh), g in zip(planes, stacks, got):
        assert g.shape == (1, 272, 480)
        assert_band(g, resize_planes.resize_planes_plain(p, wv, wh, vidx))


@needs_card
@pytest.mark.parametrize("ycck", [False, True], ids=["cmyk", "ycck"])
def test_four_component_pixel_decode_on_card_matches_cpu(ycck):
    """The committed 1080p CMYK JPEG (and the same bytes read as YCCK) on
    the card: two K3 launches, and RGB within +-2 on at most 0.1% of the
    CPU's plain decode."""
    from pathlib import Path

    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.ops import resize_planes

    data = (Path(__file__).parent / "fixtures" / "cmyk_1080p_q80.jpg"
            ).read_bytes()
    if ycck:
        at = data.index(b"Adobe") + 11
        data = data[:at] + b"\x02" + data[at + 1:]
    before = resize_planes.LAUNCHES
    got = jpeg.decode_rgb(data, device="cuda")
    assert resize_planes.LAUNCHES == before + 2
    want = jpeg.decode_rgb(data, device="cpu")
    assert got.shape == want.shape == (1080, 1920, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["ppm", "qoi_rgba", "dxt5", "ico"])
def test_pillow_sources_on_card_match_cpu(monkeypatch, case):
    """P6, RGBA QOI, DXT5 DDS and ICO sources made without Pillow
    (``chip_smoke.py``'s writers) -> w=200 WebP through the engine on the
    card and on the CPU: one K2 launch (three or four channels) on the
    card, and the planes handed to the VP8 encoder within the band."""
    import chip_smoke
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    img = chip_smoke.synth_image(7, 512, 256, noise=False)
    rgba = chip_smoke.ramp_alpha(img)
    data = {"ppm": lambda: chip_smoke.make_pnm(img),
            "qoi_rgba": lambda: chip_smoke.make_qoi(rgba),
            "dxt5": lambda: chip_smoke.make_dds(rgba, b"DXT5")[0],
            "ico": lambda: chip_smoke.make_ico(rgba[:, :256], rgba[:48, :48]),
            }[case]()
    seen = []
    real_vp8 = vp8.encode_yuv420

    def rec_vp8(yp, u, v, q):
        seen.append((yp.copy(), u.copy(), v.copy()))
        return real_vp8(yp, u, v, q)

    monkeypatch.setattr(vp8, "encode_yuv420", rec_vp8)
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s"), metrics=Metrics(),
                               device=device)

        async def run():
            try:
                return await engine.transform(data, 200, None,
                                              ImageFormat.webp, 80)
            finally:
                await engine.close()

        before = resize_strip.LAUNCHES + resize_strip.LAUNCHES_RGBA
        asyncio.run(run())
        after = resize_strip.LAUNCHES + resize_strip.LAUNCHES_RGBA
        assert after - before == int(device == "cuda")
    assert len(seen) == 2
    for a, b in zip(*seen):
        d = (torch.from_numpy(a).int() - torch.from_numpy(b).int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("ycck", [False, True], ids=["cmyk", "ycck"])
def test_progressive_four_component_decode_on_card_matches_cpu(ycck):
    """The committed progressive 1080p CMYK JPEG (and the same bytes read as
    YCCK) on the card: two K3 launches, and RGB within +-2 on at most 0.1%
    of the CPU's plain decode."""
    from pathlib import Path

    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.ops import resize_planes

    data = (Path(__file__).parent / "fixtures"
            / "cmyk_1080p_q80_progressive.jpg").read_bytes()
    if ycck:
        at = data.index(b"Adobe") + 11
        data = data[:at] + b"\x02" + data[at + 1:]
    before = resize_planes.LAUNCHES
    got = jpeg.decode_rgb(data, device="cuda")
    assert resize_planes.LAUNCHES == before + 2
    want = jpeg.decode_rgb(data, device="cpu")
    assert got.shape == want.shape == (1080, 1920, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["g4_page", "bilevel_page", "cmyk_tiff",
                                  "bmp_bgra_v5", "bmp_565", "bmp_core24",
                                  "progressive_cmyk"])
def test_pillow_fallbacks_on_card_match_cpu(monkeypatch, case):
    """Phase 20's sources (``chip_smoke.py``'s writers and the committed
    fixtures) in one batch of two requests -> w=200 WebP through the engine
    on the card and on the CPU: one K2 launch for the batch (four channels
    for the BGRA BMP), two K3 launches a progressive CMYK request, and the
    planes handed to the VP8 encoder within the band."""
    from pathlib import Path

    import chip_smoke
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import resize_planes
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    fixtures = Path(__file__).parent / "fixtures"
    img = chip_smoke.synth_image(9, 640, 360, noise=False)
    data = {
        "g4_page": lambda: (fixtures / "g4_a4_300dpi.tif").read_bytes(),
        "bilevel_page": lambda: chip_smoke.make_bilevel_tiff(
            chip_smoke.text_page(chip_smoke.G4_SEED)),
        "cmyk_tiff": lambda: chip_smoke.make_cmyk_tiff(img),
        "bmp_bgra_v5": lambda: chip_smoke.make_bmp_fields(
            chip_smoke.ramp_alpha(img), "v5_bgra"),
        "bmp_565": lambda: chip_smoke.make_bmp_fields(img, "565"),
        "bmp_core24": lambda: chip_smoke.make_bmp_fields(img, "core24"),
        "progressive_cmyk": lambda: (
            fixtures / "cmyk_1080p_q80_progressive.jpg").read_bytes(),
    }[case]()
    seen = []
    real_vp8 = vp8.encode_yuv420

    def rec_vp8(yp, u, v, q):
        seen.append((yp.copy(), u.copy(), v.copy()))
        return real_vp8(yp, u, v, q)

    monkeypatch.setattr(vp8, "encode_yuv420", rec_vp8)
    for device in ("cuda", "cpu"):
        engine = BatchedEngine(ImageKitConfig(secret="s", batch=BatchConfig(
            max_batch=2, max_delay_ms=60_000.0, hard_delay_ms=60_000.0)),
            metrics=Metrics(), device=device)

        async def run():
            try:
                return await asyncio.gather(*(engine.transform(
                    data, 200, None, ImageFormat.webp, 80) for _ in range(2)))
            finally:
                await engine.close()

        k2 = resize_strip.LAUNCHES + resize_strip.LAUNCHES_RGBA
        k3 = resize_planes.LAUNCHES
        asyncio.run(run())
        on_card = int(device == "cuda")
        assert engine.metrics.batches == 1
        assert resize_strip.LAUNCHES + resize_strip.LAUNCHES_RGBA - k2 == on_card
        assert resize_planes.LAUNCHES - k3 == on_card * (
            4 if case == "progressive_cmyk" else 0)
    assert len(seen) == 4
    for a, b in zip(seen[:2], seen[2:]):  # the same source, card vs CPU
        for p, q in zip(a, b):
            d = (torch.from_numpy(p).int() - torch.from_numpy(q).int()).abs()
            assert int(d.max()) <= 1
            assert float((d > 0).float().mean()) <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["rgb_fixture", "cmyk_fixture", "strips_22",
                                  "tiles_21", "strips_12", "gray"])
def test_tiff_jpeg_pages_on_card_match_cpu(case):
    """JPEG-compressed TIFFs (the committed Pillow-written 1080p RGB and
    CMYK files; YCbCr and gray files from ``chip_smoke.make_jpeg_tiff``) on
    the card: one K3 launch a page, two for CMYK, whatever the number of
    strips or tiles, and pixels within +-2 on at most 0.1% of the CPU's
    plain decode."""
    from pathlib import Path

    import chip_smoke
    from imagekit_tpu_torch import codecs
    from imagekit_tpu_torch.ops import resize_planes

    fixtures = Path(__file__).parent / "fixtures"
    img = chip_smoke.synth_image(11, 640, 360, noise=False)
    data = {
        "rgb_fixture": lambda: (fixtures / "tiff_jpeg_rgb_1080p_q80.tif")
        .read_bytes(),
        "cmyk_fixture": lambda: (fixtures / "tiff_jpeg_cmyk_1080p_q80.tif")
        .read_bytes(),
        "strips_22": lambda: chip_smoke.make_jpeg_tiff(img, 80),
        "tiles_21": lambda: chip_smoke.make_jpeg_tiff(img, 80, samp=(2, 1),
                                                      tile=64),
        "strips_12": lambda: chip_smoke.make_jpeg_tiff(img, 80, samp=(1, 2)),
        "gray": lambda: chip_smoke.make_jpeg_tiff(img, 80, gray=True),
    }[case]()
    before = resize_planes.LAUNCHES
    got = codecs.decode_bytes(data, device="cuda")[0]
    assert resize_planes.LAUNCHES - before == (2 if case == "cmyk_fixture"
                                               else 1)
    want = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["old_style", "planar", "rgb_extra",
                                  "cmyk16", "float32"])
def test_tiff_remainder_pages_on_card_match_cpu(case):
    """The TIFF layouts the reference decoded with Pillow, written by
    ``chip_smoke``'s writers, on the card: one K3 launch an old-style or
    planar page (identity and replication stacks for the old-style one),
    two for an RGB page with an extra sample, none for the sample layouts;
    pixels within +-2 on at most 0.1% of the CPU's plain decode (exact for
    the sample layouts)."""
    from pathlib import Path

    import chip_smoke
    from imagekit_tpu_torch import codecs
    from imagekit_tpu_torch.ops import resize_planes

    fixtures = Path(__file__).parent / "fixtures"
    img = chip_smoke.synth_image(12, 640, 360, noise=False)
    data = {
        "old_style": lambda: chip_smoke.make_old_style_tiff(img),
        "planar": lambda: chip_smoke.make_planar_jpeg_tiff(img),
        "rgb_extra": lambda: chip_smoke.with_unspecified_extra(
            (fixtures / "tiff_jpeg_cmyk_1080p_q80.tif").read_bytes()),
        "cmyk16": lambda: chip_smoke.make_cmyk16_tiff(img),
        "float32": lambda: chip_smoke.make_float_tiff(
            chip_smoke.elevation(3, 640, 360)),
    }[case]()
    before = resize_planes.LAUNCHES
    got = codecs.decode_bytes(data, device="cuda")[0]
    assert resize_planes.LAUNCHES - before == {"rgb_extra": 2, "cmyk16": 0,
                                               "float32": 0}.get(case, 1)
    want = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    if case in ("cmyk16", "float32"):
        assert d.max() == 0
    else:
        assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["arith_420", "arith_progressive_444",
                                  "arith_cmyk", "lossless_gray",
                                  "lossless_rgb_420"])
def test_arith_lossless_on_card_match_cpu(case):
    """Arithmetic-coded and lossless JPEGs written by the numpy writers of
    ``tests/fixtures/`` (``chip_smoke.jpeg_writer`` loads them by path), on
    the card: one K3 launch a DCT frame (two for CMYK) and a lossless frame
    of subsampled components, none for lossless gray; pixels within +-2 on
    at most 0.1% of the CPU's plain decode (exact for lossless)."""
    import chip_smoke
    from imagekit_tpu_torch import codecs
    from imagekit_tpu_torch.ops import resize_planes

    jw, aw, lw = (chip_smoke.jpeg_writer(n) for n in (
        "jpeg_writer", "jpeg_arith_writer", "jpeg_lossless_writer"))
    img = chip_smoke.synth_image(13, 640, 360, noise=False)
    s420, s444 = chip_smoke.S420, chip_smoke.S444
    if case.startswith("arith"):
        samp = s444 if "444" in case else s420
        planes, tabs, tq = jw.coefficients(
            img, 80, samp, colour="rgb" if case == "arith_cmyk" else "ycbcr")
        if case == "arith_cmyk":  # R, G and B as Adobe's inverted inks
            white = jw.coefficients(np.full_like(img, 255), 80, samp)[0]
            planes, samp, tq = planes + white[:1], chip_smoke.SCMYK, tq + [0]
        data = aw.write(planes, tabs, 640, 360, samp, tq,
                        progressive="progressive" in case, restart=40,
                        adobe_transform=0 if case == "arith_cmyk" else None)
    else:
        samp = ((1, 1),) if case == "lossless_gray" else s420
        data = lw.write(lw.subsample(img[:, :, :len(samp)], samp), 640, 360,
                        samp, predictor=5)
    before = resize_planes.LAUNCHES
    got = codecs.decode_bytes(data, device="cuda")[0]
    assert resize_planes.LAUNCHES - before == {
        "arith_cmyk": 2, "lossless_gray": 0}.get(case, 1)
    want = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (360, 640, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    if case.startswith("lossless"):
        assert d.max() == 0
    else:
        assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["cmyk_411", "cmyk_ratio_3", "ycck_411",
                                  "lossless_cmyk", "lossless_cmyk_2x2",
                                  "arith_tiff", "planar_straddling_tiff"])
def test_cmyk_and_tiff_remainder_on_card_match_cpu(case):
    """CMYK JPEGs at ratios of 4 and 3, lossless CMYK and the JPEG TIFF
    pages of the last slice (``chip_smoke.make_remainder_sources``' kinds,
    640x360), on the card: two K3 launches a CMYK request and a lossless
    CMYK one sampled differently, none sampled alike, one an arithmetic
    TIFF page, one a strip of the planar page; pixels within +-2 on at most
    0.1% of the CPU's plain decode (exact for lossless)."""
    import chip_smoke
    from imagekit_tpu_torch import codecs
    from imagekit_tpu_torch.ops import resize_planes

    jw, aw, lw = (chip_smoke.jpeg_writer(n) for n in (
        "jpeg_writer", "jpeg_arith_writer", "jpeg_lossless_writer"))
    img = chip_smoke.synth_image(17, 640, 360, noise=False)
    four = np.dstack([img, np.full((360, 640), 255, np.uint8)])
    samp = {"cmyk_411": chip_smoke.S411K, "ycck_411": chip_smoke.S411K,
            "cmyk_ratio_3": chip_smoke.S3K, "lossless_cmyk": ((1, 1),) * 4,
            "lossless_cmyk_2x2": chip_smoke.SCMYK}.get(case)
    if case.startswith(("cmyk", "ycck")):
        planes, tabs, tq = jw.coefficients(four, 80, samp, colour="raw")
        data = jw.write(planes, tabs, 640, 360, samp, tq,
                        adobe_transform=2 if case == "ycck_411" else 0)
        launches = 2
    elif case.startswith("lossless"):
        data = lw.write(lw.subsample(four, samp), 640, 360, samp)
        launches = 0 if case == "lossless_cmyk" else 2
    elif case == "arith_tiff":
        segs = []
        for y in range(0, 360, 16):
            part = img[y:y + 16]
            planes, tabs, tq = jw.coefficients(part, 80, chip_smoke.S420)
            segs.append(aw.write(planes, tabs, 640, part.shape[0],
                                 chip_smoke.S420, tq))
        data = chip_smoke.tiff_file(640, 360, {
            258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [16]), 284: (3, [1]), 530: (3, [2, 2])}, segs)
        launches = 1
    else:
        segs = []
        for c in range(3):
            for y in range(0, 360, 36):
                planes, tabs, tq = jw.coefficients(
                    img[y:y + 36, :, c:c + 1], 80, ((1, 1),), colour="raw")
                segs.append(jw.write(planes, tabs, 640, 36, ((1, 1),), tq))
        data = chip_smoke.tiff_file(640, 360, {
            258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]), 277: (3, [3]),
            278: (4, [36]), 284: (3, [2])}, segs)
        launches = 10
    before = resize_planes.LAUNCHES
    got = codecs.decode_bytes(data, device="cuda")[0]
    assert resize_planes.LAUNCHES - before == launches
    want = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape == (360, 640, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    if case.startswith("lossless"):
        assert d.max() == 0
    else:
        assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@needs_card
@pytest.mark.parametrize("case", ["cielab", "ycbcr_420", "ycbcr_42_rows_5",
                                  "cmyk16_planar", "orientation_6_jpeg",
                                  "orientation_7_cmyk16", "gray4_bmp"])
def test_lab_ycbcr_sources_on_card_match_cpu(case):
    """CIELab, YCbCr without JPEG, planar 16-bit CMYK, the Orientation and
    the gray 4 bpp BMP (``chip_smoke.make_lab_ycbcr_sources``' kinds,
    640x360) on the card: one K3 launch a subsampled YCbCr page (none where
    its strips restart the blocks: the chroma comes at full resolution)
    and a JPEG TIFF page; pixels equal to the CPU's plain decode (the JPEG
    page within +-2 on at most 0.1%)."""
    import chip_smoke
    from imagekit_tpu_torch import codecs
    from imagekit_tpu_torch.ops import resize_planes

    img = chip_smoke.synth_image(18, 640, 360, noise=False)
    data, launches = {
        "cielab": lambda: (chip_smoke.make_lab_tiff(img), 0),
        "ycbcr_420": lambda: (chip_smoke.make_ycbcr_tiff(img), 1),
        "ycbcr_42_rows_5": lambda: (_ycbcr_rows_not_blocks(img), 0),
        "cmyk16_planar": lambda: (chip_smoke.make_cmyk16_planar_tiff(img), 0),
        "orientation_6_jpeg": lambda: (chip_smoke.tiff_with_tag(
            chip_smoke.make_jpeg_tiff(img, 90), 274, 6), 1),
        "orientation_7_cmyk16": lambda: (chip_smoke.tiff_with_tag(
            chip_smoke.make_cmyk16_planar_tiff(img), 274, 7), 0),
        "gray4_bmp": lambda: (chip_smoke.make_gray4_bmp(np.arange(
            12, dtype=np.uint8).reshape(3, 4)), 0),
    }[case]()
    before = resize_planes.LAUNCHES
    got = codecs.decode_bytes(data, device="cuda")[0]
    assert resize_planes.LAUNCHES - before == launches
    want = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    if case == "orientation_6_jpeg":
        assert got.shape == (640, 360, 3)
        assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE
    else:
        assert d.max() == 0


def _ycbcr_rows_not_blocks(img):
    """A YCbCr 4:2 LZW page in 5-row strips: libtiff's blocks start again
    at each strip, so the decode takes its chroma at full resolution."""
    import chip_smoke

    h, w = img.shape[:2]
    y, cb, cr = chip_smoke.ycc_planes(img, (4, 2))
    full_cb = np.repeat(cb, 2, axis=0)  # a chroma row a strip's block row
    full_cr = np.repeat(cr, 2, axis=0)
    strips = [chip_smoke.lzw_literal(chip_smoke.ycc_strip(
        y, full_cb, full_cr, (4, 2), y0, min(5, h - y0)))
        for y0 in range(0, h, 5)]
    return chip_smoke.tiff_file(w, h, {
        258: (3, [8] * 3), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]),
        278: (4, [5]), 530: (3, [4, 2])}, strips)


@needs_card
def test_lab_conversion_on_card_equals_cpu():
    """``color.lab_to_rgb`` on the card against the CPU on all 2^24 CIELab
    triples: integer ops, equal."""
    from imagekit_tpu_torch.ops import color

    v = torch.arange(1 << 24, dtype=torch.int64)
    lab = torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1).to(torch.uint8)
    got = color.lab_to_rgb(lab.cuda()).cpu()
    want = torch.cat([color.lab_to_rgb(p) for p in lab.split(1 << 22)])
    assert torch.equal(got, want)


# -- AVIF sources: K2's YUV entries in any chroma layout, with alpha, and its
# f32 entry for BT.709 batches; the port's AV1 decoder on the card's host --


def _avif_stacks(cs, mix: bool):
    """The YUV head's stacks at the flagship pair for chroma of factors
    ``cs``: luma 1088x1920 -> 240x400, chroma to HALF output resolution
    (and to the full one with ``mix``), as ``engine_yuv._yuv_weights``."""
    from imagekit_tpu_torch.ops.weights import (
        combined_chroma_half_weights,
        combined_chroma_weights,
        padded_weights,
    )

    csy, csx = cs
    ch, cw = 1088 // csy, 1920 // csx
    geoms = [(1920, 1080, 400, 225), (1904, 1072, 397, 223)]
    s = [np.zeros((2, 240, 1088), np.float32),
         np.zeros((2, 400, 1920), np.float32),
         np.zeros((2, 120, ch), np.float32), np.zeros((2, 200, cw), np.float32),
         np.zeros((2, 240, ch), np.float32), np.zeros((2, 400, cw), np.float32)]
    for u, (iw, ih, ow, oh) in enumerate(geoms):
        cht, cwt = (ih + csy - 1) // csy, (iw + csx - 1) // csx
        s[0][u] = padded_weights(ih, oh, 1088, 240)
        s[1][u] = padded_weights(iw, ow, 1920, 400)
        s[2][u] = combined_chroma_half_weights(cht, ih, oh, ch, 120)
        s[3][u] = combined_chroma_half_weights(cwt, iw, ow, cw, 200)
        s[4][u] = combined_chroma_weights(cht, ih, oh, ch, 240)
        s[5][u] = combined_chroma_weights(cwt, iw, ow, cw, 400)
    return tuple(torch.from_numpy(x).cuda() for x in s[:6 if mix else 4])


def _avif_flat(batch: int, cs, alpha: bool):
    from imagekit_tpu_torch.ops.weights import pad128

    ch, cw = 1088 // cs[0], 1920 // cs[1]
    ny, nc = 1088 * 1920, ch * cw
    host = np.zeros((batch, pad128(ny * (1 + alpha) + 2 * nc)), np.uint8)
    parts = [(0, (1088, 1920)), (ny, (ch, cw)), (ny + nc, (ch, cw))]
    if alpha:
        parts.append((ny + 2 * nc, (1088, 1920)))
    for at, (h, w) in parts:
        host[:, at:at + h * w] = _k3_planes(batch, h, w, seed=at % 5).reshape(
            batch, -1)
    return torch.from_numpy(host).cuda()


@needs_card
@pytest.mark.parametrize("cs, alpha", [((1, 1), False), ((1, 2), False),
                                       ((2, 2), True), ((1, 1), True)],
                         ids=["444", "422", "420_alpha", "444_alpha"])
def test_k2_avif_planes_in_one_launch_match_plain(cs, alpha):
    """An AVIF batch's Y, Cb, Cr of any chroma factors and its alpha plane
    as views of one flat batch, in ONE launch of K2's u8 entry, against
    ``yuv_resize_plain``; then the whole head."""
    from imagekit_tpu_torch.ops import dct

    flat = _avif_flat(8, cs, alpha)
    stacks = _avif_stacks(cs, False)
    vidx = torch.arange(8, dtype=torch.int32, device="cuda") % 2
    bands = (resize_strip.resize_tables(*stacks[:2]),
             resize_strip.resize_tables(*stacks[2:4]))
    planes = dct.yuv_planes(flat, 1088, 1920, cs, alpha)
    before = resize_strip.LAUNCHES
    got = resize_strip.yuv_resize(planes, stacks, vidx, bands=bands)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES == before + 1
    want = resize_strip.yuv_resize_plain(planes, stacks, vidx)
    assert len(got) == 3 + alpha
    for a, b in zip(got, want):
        assert_band(a, b)
    a = dct.resize_yuv420(flat, stacks, vidx, (1088, 1920), bands,
                          chroma_sub=cs, alpha=alpha)
    b = dct.resize_yuv420(flat, stacks, vidx, (1088, 1920), bands,
                          resize=resize_strip.yuv_resize_plain, chroma_sub=cs,
                          alpha=alpha)
    assert_band(a, b)


@needs_card
@pytest.mark.parametrize("alpha", [False, True])
def test_k2_f32_entry_for_bt709_batches_matches_plain(alpha):
    """A BT.709 batch's six resizes (Y, chroma to the half and the full
    grid, alpha) in ONE launch of K2's f32 entry, against
    ``yuv_mix_resize_plain``; then the mixed head to WebP and JPEG."""
    from imagekit_tpu_torch.ops import dct

    cs = (2, 2)
    flat = _avif_flat(8, cs, alpha)
    stacks = _avif_stacks(cs, True)
    vidx = torch.arange(8, dtype=torch.int32, device="cuda") % 2
    bands = tuple(resize_strip.resize_tables(*stacks[i:i + 2])
                  for i in (0, 2, 4))
    planes = dct.yuv_planes(flat, 1088, 1920, cs, alpha)
    before = resize_strip.LAUNCHES
    got = resize_strip.yuv_mix_resize(planes, stacks, vidx, bands=bands)
    torch.cuda.synchronize()
    assert resize_strip.LAUNCHES == before + 1
    want = resize_strip.yuv_mix_resize_plain(planes, stacks, vidx)
    assert len(got) == 5 + alpha
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=255e-5)
    a = dct.resize_yuv420(flat, stacks, vidx, (1088, 1920), bands,
                          alpha=alpha, mix=True)
    b = dct.resize_yuv420(flat, stacks, vidx, (1088, 1920), bands,
                          alpha=alpha, mix=True,
                          mix_resize=resize_strip.yuv_mix_resize_plain)
    assert_band(a, b)
    if not alpha:
        qt = torch.full((8, 128), 8.0, device="cuda")
        a = dct.resize_yuv_jpeg(flat, stacks, qt, vidx, (1088, 1920), bands,
                                mix=True)
        b = dct.resize_yuv_jpeg(flat, stacks, qt, vidx, (1088, 1920), bands,
                                mix=True,
                                mix_resize=resize_strip.yuv_mix_resize_plain)
        assert_band(a, b)


@needs_card
def test_av1_decoder_gives_libdav1d_planes_on_the_cards_host():
    """The committed AVIFs of ``tests/fixtures/avif/`` (palette blocks,
    intra block copy, 10- and 12-bit files, quantizer matrices and film
    grain among them) decode on the
    card's host (which has no libdav1d) to the planes whose SHA-256
    libdav1d gave where they were made, the raw 16-bit ones too; then one
    through the engine on the card."""
    import hashlib
    import json
    from pathlib import Path

    from imagekit_tpu_torch.codecs import avif_native, vp8
    from imagekit_tpu_torch.codecs.native import av1_dec_abi
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    root = Path(__file__).resolve().parent / "fixtures" / "avif"
    table = json.loads((root / "avif_planes.json").read_text())
    for name, entry in table.items():
        data = (root / entry["file"]).read_bytes()
        info = avif_native.parse_container(data)
        digest = hashlib.sha256()
        for p in av1_dec_abi.decode(info.obu)[:3]:
            digest.update(p.tobytes())
        if info.alpha_obu:
            digest.update(av1_dec_abi.decode(info.alpha_obu)[0].tobytes())
        assert digest.hexdigest() == entry["sha256"], name
        assert av1_dec_abi.probe(info.obu).superres_denom == entry[
            "superres_denom"], name
        if "sha256_samples" in entry:  # 10 and 12 bits: the raw planes
            raw = hashlib.sha256()
            for p in av1_dec_abi.decode_samples(info.obu)[:3]:
                raw.update(p.astype("<u2").tobytes())
            assert raw.hexdigest() == entry["sha256_samples"], name
    data = (root / table["1080p_444"]["file"]).read_bytes()

    async def run():
        engine = BatchedEngine(device="cuda")
        try:
            return await engine.transform(data, 400, None, ImageFormat.webp,
                                          80)
        finally:
            await engine.close()

    before = resize_strip.YUV_LAUNCHES.get("444", 0)
    assert vp8.dimensions(asyncio.run(run())) == (400, 225)
    assert resize_strip.YUV_LAUNCHES["444"] == before + 1
