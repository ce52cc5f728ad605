"""K2's plain version and its band tables against the JAX package's K2.

``imagekit_tpu_torch.ops.resize_strip.plane_resize`` takes its plain
version (``plane_resize_plain``) for CPU tensors. It is held against
``pallas_resize._plane_resize`` run by the Pallas interpreter and against
the einsum form of the same resize, for all three epilogues (default u8,
and the yuvjpg luma and chroma remaps with the centred i8 store), with
``vidx != hidx``, on a plane and on one channel of an interleaved batch
(refused as a strided view, taken as a contiguous copy). The CUDA kernel
itself is held against the plain version on a card in
``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance: u8/i8 within max |d| <= 1 on at most 0.1% of elements, the
reference's own band (tests/test_pallas_jpeg8.py:72); on the CPU the two
are expected to agree exactly (seen: exact).

The band tables are checked exactly: every weight off a row's band is 0,
and a product summed over the band only is bit-equal to the dense product
summed in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagekit_tpu.ops import pallas_resize
from imagekit_tpu.ops.resize import padded_weights
from imagekit_tpu_torch.ops import resize_strip

MAX_SHARE = 1e-3

# (scale, pre, post, centered): K2's default epilogue and the yuvjpg luma
# and chroma remaps (imagekit_tpu/ops/pallas_resize.py:338-345)
EPILOGUES = {
    "u8": dict(),
    "luma_jfif": dict(scale=255.0 / 219.0, pre=-16.0, centered=True),
    "chroma_jfif": dict(scale=255.0 / 224.0, pre=-128.0, post=128.0,
                        centered=True),
}


def assert_band(a, b, what=""):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape, what
    d = np.abs(a - b)
    assert d.max() <= 1, (what, int(d.max()))
    assert (d > 0).mean() <= MAX_SHARE, (what, float((d > 0).mean()))


def _stacks(bh, bw, obh, obw, U=4):
    """Per-axis Lanczos stacks of U geometries in one bucket; rows past each
    true output replicate the last true row (the engine's edge rows), the
    rest stay zero."""
    wv = np.zeros((U, obh, bh), np.float32)
    wh = np.zeros((U, obw, bw), np.float32)
    for u in range(U):
        th, to_h = bh - 2 * u - 3, obh // 2 - u + 1
        tw, to_w = bw - 3 * u - 5, obw // 2 - 2 * u + 3
        wv[u] = padded_weights(th, to_h, bh, obh)
        wh[u] = padded_weights(tw, to_w, bw, obw)
        wv[u, to_h:to_h + 1] = wv[u, to_h - 1]
        wh[u, to_w:to_w + 1] = wh[u, to_w - 1]
    return wv, wh


def _inputs(seed, B=3, bh=64, bw=256, obh=32, obw=128):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, bh, bw * 3), dtype=np.uint8)
    wv, wh = _stacks(bh, bw, obh, obw)
    vidx = np.array([0, 3, 1], np.int32)[:B]
    hidx = np.array([2, 0, 3], np.int32)[:B]  # the axes keyed separately
    return imgs, wv, wh, vidx, hidx


def _einsum_resize(x, wv, wh, vidx, hidx, scale=1.0, pre=0.0, post=0.0,
                   centered=False):
    """The einsum form of K2: both contractions in one pass each, then the
    kernel's epilogue (pallas_resize.py:112-121)."""
    hp = jax.lax.Precision.HIGHEST
    t = jnp.einsum("boh,bhw->bow", jnp.asarray(wv)[vidx],
                   jnp.asarray(x).astype(jnp.float32), precision=hp)
    v = jnp.einsum("bpw,bow->bop", jnp.asarray(wh)[hidx], t, precision=hp)
    if scale != 1.0 or pre != 0.0 or post != 0.0:
        v = (v + pre) * scale + post
    v = jnp.clip(jnp.floor(v + 0.5), 0.0, 255.0)
    return np.asarray((v - 128.0).astype(jnp.int8) if centered
                      else v.astype(jnp.uint8))


@pytest.mark.parametrize("layout", ["plane", "interleaved"])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_plain_matches_pallas_k2_and_einsum(epilogue, layout):
    kw = EPILOGUES[epilogue]
    imgs, wv, wh, vidx, hidx = _inputs(seed=1)
    B, bh, bw3 = imgs.shape
    if layout == "plane":
        x_np = np.ascontiguousarray(imgs[:, :, : bw3 // 3])
        x_t = torch.from_numpy(x_np)
    else:  # the green channel: refused in place, taken as a copy
        x_np = imgs.reshape(B, bh, bw3 // 3, 3)[..., 1]
        view = torch.from_numpy(imgs).reshape(B, bh, bw3 // 3, 3)[..., 1]
        assert view.stride() == (bh * bw3, bw3, 3)
        with pytest.raises(ValueError, match="must be contiguous"):
            resize_strip.plane_resize(
                view, torch.from_numpy(wv), torch.from_numpy(wh),
                torch.from_numpy(vidx), torch.from_numpy(hidx), **kw)
        x_t = view.contiguous()
    before = resize_strip.LAUNCHES
    got = resize_strip.plane_resize(
        x_t, torch.from_numpy(wv), torch.from_numpy(wh),
        torch.from_numpy(vidx), torch.from_numpy(hidx), **kw).numpy()
    assert resize_strip.LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == (np.int8 if kw.get("centered") else np.uint8)
    pallas = np.asarray(pallas_resize._plane_resize(
        jnp.asarray(x_np), jnp.asarray(wv), jnp.asarray(wh),
        jnp.asarray(vidx), True, hidx=jnp.asarray(hidx), **kw))
    einsum = _einsum_resize(x_np, wv, wh, vidx, hidx, **kw)
    assert_band(got, pallas, "pallas")
    assert_band(got, einsum, "einsum")
    assert 0.2 < float(((got > -128) & (got < 127)).mean())  # unclipped


def _first_last(row):
    nz = np.flatnonzero(row)
    return (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)


@pytest.mark.parametrize("geom", [
    (1080, 225, 1088, 240),   # the slice's vertical axis
    (1920, 400, 1920, 400),   # the slice's horizontal axis
    (60, 31, 64, 32),         # upscale-free small bucket
    (40, 90, 64, 96),         # an upscale
])
def test_band_table_is_the_nonzero_run(geom):
    ti, to, bi, bo = geom
    w = np.zeros((2, bo, bi), np.float32)
    w[0] = padded_weights(ti, to, bi, bo)
    w[0, to:to + 1] = w[0, to - 1]  # an edge-replicated row
    got = resize_strip.band_table(torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32 and got.shape == (2, bo, 2)
    for u in range(2):
        for o in range(bo):
            f, l = _first_last(w[u, o])
            assert tuple(got[u, o]) == (f, l), (u, o)
            assert not w[u, o, :f].any() and not w[u, o, l:].any()
    assert (got[1] == 0).all()  # an all-zero stack slot: empty bands
    widths = got[0, :, 1] - got[0, :, 0]
    if geom[0] == 1080:
        assert widths[:to].max() <= 30  # at most ~29 taps of 1088 per row


def _sequential(w, x, band=None):
    """out[o] = sum over i of w[o, i] * x[i], in increasing i, in float32;
    over the row's band only when ``band`` is given."""
    out = np.zeros((w.shape[0], x.shape[1]), np.float32)
    for o in range(w.shape[0]):
        lo, hi = band[o] if band is not None else (0, w.shape[1])
        for i in range(lo, hi):
            out[o] = out[o] + w[o, i] * x[i]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_product_is_the_dense_product(seed):
    """Skipping the zero band changes no bit: both passes of K2, summed in
    the kernel's order over the band only, equal the dense sums in the same
    order, and round to the plain version's u8 plane within the band."""
    imgs, wv, wh, vidx, hidx = _inputs(seed, B=2)
    bv = resize_strip.band_table(torch.from_numpy(wv)).numpy()
    bh = resize_strip.band_table(torch.from_numpy(wh)).numpy()
    x = imgs.reshape(2, 64, 256, 3)[..., 0]
    plain = resize_strip.plane_resize_plain(
        torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(wv),
        torch.from_numpy(wh), torch.from_numpy(vidx),
        torch.from_numpy(hidx)).numpy()
    for b in range(2):
        xf = x[b].astype(np.float32)
        v_band = _sequential(wv[vidx[b]], xf, bv[vidx[b]])
        v_dense = _sequential(wv[vidx[b]], xf)
        assert np.array_equal(v_band, v_dense)
        h_band = _sequential(wh[hidx[b]], v_band.T, bh[hidx[b]]).T
        h_dense = _sequential(wh[hidx[b]], v_dense.T).T
        assert np.array_equal(h_band, h_dense)
        u8 = np.clip(np.floor(h_band + np.float32(0.5)), 0, 255).astype(np.uint8)
        assert_band(u8, plain[b], f"image {b}")


def test_plane_resize_refuses_what_the_kernel_does_not_take():
    imgs, wv, wh, vidx, hidx = _inputs(seed=2)
    view = torch.from_numpy(imgs).reshape(3, 64, 256, 3)[..., 0]
    x = view.contiguous()
    wv_t, wh_t = torch.from_numpy(wv), torch.from_numpy(wh)
    v, h = torch.from_numpy(vidx), torch.from_numpy(hidx)
    with pytest.raises(ValueError, match="must be contiguous"):
        resize_strip.plane_resize(view, wv_t, wh_t, v, h)
    with pytest.raises(TypeError, match="uint8"):
        resize_strip.plane_resize(x.float(), wv_t, wh_t, v, h)
    with pytest.raises(TypeError, match="int32"):
        resize_strip.plane_resize(x, wv_t, wh_t, v.long(), h)
    with pytest.raises(ValueError, match="contiguous"):
        resize_strip.plane_resize(x, wv_t.transpose(1, 2).contiguous()
                                  .transpose(1, 2), wh_t, v, h)
    with pytest.raises(ValueError, match="do not fit"):
        resize_strip.plane_resize(x[:, :32].contiguous(), wv_t, wh_t, v, h)
    with pytest.raises(ValueError, match="band tables"):
        resize_strip.plane_resize(x, wv_t, wh_t, v, h,
                                  bands=resize_strip.resize_tables(wh_t, wh_t))
    meta = [t.to("meta") for t in (x, wv_t, wh_t, v, h)]
    bands = tuple(torch.empty((4, n, 2), dtype=torch.int32, device="meta")
                  for n in (32, 128))
    with pytest.raises(ValueError, match="no K2 kernel"):
        resize_strip.plane_resize(*meta, bands=bands)


# -- the one-launch RGB entry and the compact Wh table -------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_rgb_resize_is_three_plain_planes_and_pallas_k2(seed):
    """``rgb_resize`` on CPU tensors (its plain version, no launch) equals
    three ``plane_resize_plain`` calls bit for bit, and the planes of the
    JAX package's ``_resample_rgb_yuv_pallas`` (``_plane_resize`` per
    channel, interpret mode) within the band; the rgbyuv head on it equals
    ``_resample_rgb_yuv_pallas`` itself within the band."""
    from imagekit_tpu_torch.ops import color

    imgs, wv, wh, vidx, hidx = _inputs(seed)
    B, bh, bw3 = imgs.shape
    args = [torch.from_numpy(a) for a in (wv, wh, vidx, hidx)]
    before = resize_strip.LAUNCHES
    got = resize_strip.rgb_resize(torch.from_numpy(imgs), *args).numpy()
    assert resize_strip.LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == np.uint8 and got.shape == (B, 3, 32, 128)
    chans = imgs.reshape(B, bh, bw3 // 3, 3)
    for c in range(3):
        x = np.ascontiguousarray(chans[..., c])
        plain = resize_strip.plane_resize_plain(torch.from_numpy(x), *args)
        assert np.array_equal(got[:, c], plain.numpy())
        pallas = np.asarray(pallas_resize._plane_resize(
            jnp.asarray(x), jnp.asarray(wv), jnp.asarray(wh),
            jnp.asarray(vidx), True, hidx=jnp.asarray(hidx)))
        assert_band(got[:, c], pallas, f"channel {c}")
    head = color.rgb_yuv_head(torch.from_numpy(imgs), *args).numpy()
    want = np.asarray(pallas_resize._resample_rgb_yuv_pallas(
        jnp.asarray(imgs), jnp.asarray(wv), jnp.asarray(wh),
        jnp.asarray(vidx), jnp.asarray(hidx), interpret=True))
    assert_band(head, want, "rgbyuv head")


@pytest.mark.parametrize("geom", [
    (1920, 400, 1920, 400),   # the slice's horizontal axis (T = 32)
    (960, 200, 960, 200),     # the yuvjpg chroma axis
    (60, 31, 64, 32),         # a small bucket
    (40, 90, 64, 96),         # an upscale
    (13, 13, 16, 16),         # an identity: one tap per row
])
def test_compact_table_reproduces_the_banded_product(geom):
    """The compact Wh table (aligned start, T taps) summed in increasing t
    equals the product summed over ``band_table``'s run in increasing j,
    bit for bit, on every row, and its window stays inside the row."""
    ti, to, bi, bo = geom
    w = np.zeros((2, bo, bi), np.float32)
    w[0] = padded_weights(ti, to, bi, bo)
    w[0, to:to + 1] = w[0, to - 1]
    w[1, : bo // 2] = padded_weights(ti // 2 + 1, bo // 2, bi, bo // 2)
    band = resize_strip.band_table(torch.from_numpy(w)).numpy()
    start, taps = (t.numpy() for t in resize_strip.compact_table(
        torch.from_numpy(w)))
    T = 4 * taps.shape[1]
    assert taps.shape == (2, T // 4, bo, 4) and (start % 4 == 0).all()
    assert (start >= 0).all() and (start + T <= (bi + 3) // 4 * 4).all()
    rng = np.random.default_rng(bo)
    x = rng.integers(0, 256, (bi, 7)).astype(np.float32)
    for u in range(2):
        banded = _sequential(w[u], x, band[u])
        compact = np.zeros_like(banded)
        for o in range(bo):
            for t in range(T):
                j = start[u, o] + t
                if j < bi:
                    compact[o] = compact[o] + taps[u, t // 4, o, t % 4] * x[j]
                else:
                    assert taps[u, t // 4, o, t % 4] == 0.0
        assert np.array_equal(compact, banded), u


def test_rgb_resize_refuses_what_the_kernel_does_not_take():
    imgs, wv, wh, vidx, hidx = _inputs(seed=5)
    x = torch.from_numpy(imgs)
    args = [torch.from_numpy(a) for a in (wv, wh, vidx, hidx)]
    with pytest.raises(ValueError, match="W\\*3"):
        resize_strip.rgb_resize(x[:, :, :-1], *args)
    with pytest.raises(ValueError, match="contiguous"):
        resize_strip.rgb_resize(x[:, ::2], *args)
    with pytest.raises(TypeError, match="uint8"):
        resize_strip.rgb_resize(x.float(), *args)
    with pytest.raises(ValueError, match="compact tables"):
        resize_strip.rgb_resize(x, *args, bands=(
            *resize_strip.resize_tables(*args[:2])[:2],
            torch.zeros((4, 2, 128, 3), dtype=torch.float32)))
    meta = [t.to("meta") for t in (x, *args)]
    with pytest.raises(ValueError, match="no K2 kernel"):
        resize_strip.rgb_resize(*meta)
