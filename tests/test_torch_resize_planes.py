"""K3's and K4's plain versions and their band tables against the JAX package.

``imagekit_tpu_torch.ops.resize_planes.resize_planes3`` (K3) and
``resize_planes3_f32`` (K4) take their plain versions for CPU tensors, one
plane at a time. K3's is held against
``imagekit_tpu.ops.pallas.resize_kernel._resize_planes_einsum``, K3's own
plain reference (``resize_kernel.py:281``), on random u8 planes with real
Lanczos stacks, B=3 and ``vidx != 0``; K4's against a float64 numpy
product. The CUDA kernels themselves are held against the plain versions on
a card in ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances:
- K3: u8 within max |d| <= 1 on at most 0.1% of pixels, the reference's own
  band (tests/test_pallas_jpeg8.py:72); on the CPU expected exact (seen:
  exact).
- K4: within rtol 1e-5 of the float64 product, with an absolute floor of
  1e-5 of the planes' 0..255 range (fp32 sums of ~1000 terms).
- band tables: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagekit_tpu.ops.pallas import resize_kernel
from imagekit_tpu_torch.ops import resize_planes as rp
from imagekit_tpu_torch.ops.resize_strip import band_table, resize_tables
from imagekit_tpu_torch.ops.weights import combined_chroma_weights, padded_weights
from tests.test_torch_resize import assert_band

# (true input, true output) slots of one bucket pair per axis; the stack is
# (U, bucket_out, bucket_in) with zero pad rows, as the RGB head's stacks
V_SLOTS = ((60, 23), (57, 22), (52, 20), (64, 24))
H_SLOTS = ((120, 46), (113, 43), (104, 40), (128, 48))


def _stacks(bh=64, bw=128, obh=24, obw=48):
    wv = np.zeros((4, obh, bh), np.float32)
    wh = np.zeros((4, obw, bw), np.float32)
    for u, ((ti, to), (tj, tp)) in enumerate(zip(V_SLOTS, H_SLOTS)):
        wv[u] = padded_weights(ti, to, bh, obh)
        wh[u] = padded_weights(tj, tp, bw, obw)
    return wv, wh


def _inputs(seed, dtype=np.uint8, B=3):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, (B, 64, 128)).astype(dtype)
    wv, wh = _stacks()
    vidx = np.array([2, 0, 3], np.int32)[:B]
    return planes, wv, wh, vidx


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _on_one_plane(entry):
    """A three-plane entry on one plane: the plane as Y, Cb and Cr with one
    stack pair; returns the first output after checking that the three
    agree."""
    def call(planes, wv, wh, vidx, bands=None):
        outs = entry((planes,) * 3, (wv, wh, wv, wh), vidx,
                     bands=None if bands is None else (bands, bands))
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        return outs[0]
    return call


K3_ONE = _on_one_plane(rp.resize_planes3)
K4_ONE = _on_one_plane(rp.resize_planes3_f32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3_plain_matches_resize_planes_einsum(seed):
    planes, wv, wh, vidx = _inputs(seed)
    before = rp.LAUNCHES
    got = K3_ONE(*_t(planes, wv, wh, vidx)).numpy()
    assert rp.LAUNCHES == before  # the CPU takes the plain version
    want = np.asarray(resize_kernel._resize_planes_einsum(
        jnp.asarray(planes), jnp.asarray(wv), jnp.asarray(wh),
        jnp.asarray(vidx)))
    assert got.dtype == np.uint8 and got.shape == (3, 24, 48)
    assert_band(got, want, "K3")
    assert 0.2 < float(((got > 0) & (got < 255)).mean())  # unclipped
    # the image past each slot's true output is the stack's zero rows
    for b, u in enumerate(vidx):
        to, tp = V_SLOTS[u][1], H_SLOTS[u][1]
        assert not got[b, to:].any() and not got[b, :, tp:].any()


@pytest.mark.parametrize("seed", [3, 4])
def test_k4_plain_matches_float64_product(seed):
    planes, wv, wh, vidx = _inputs(seed, np.float32)
    planes = planes * np.float32(0.1) + np.float32(0.25)  # dark, off the grid
    planes[:, :, ::16] = 255.0  # bright bars: the negative lobes ring
    before = rp.LAUNCHES_F32
    got = K4_ONE(*_t(planes, wv, wh, vidx)).numpy()
    assert rp.LAUNCHES_F32 == before
    want = np.stack([
        wv[u].astype(np.float64) @ planes[b].astype(np.float64)
        @ wh[u].astype(np.float64).T for b, u in enumerate(vidx)])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=255e-5)
    assert (got < 0).any()  # no clip: Lanczos' negative lobes show


@pytest.mark.parametrize("seed", [5, 6])
def test_k4_on_u8_planes_is_k4_on_their_f32_copies(seed):
    """The k = 8 JPEG -> WebP head hands K4 the u8 planes of its IDCT: the
    same unrounded f32 sums as on those planes widened, which is what the
    JAX head's ``_yuv_tail`` resizes (an f32 einsum of the u8 grid)."""
    planes, wv, wh, vidx = _inputs(seed)
    before = rp.LAUNCHES_F32
    got = K4_ONE(*_t(planes, wv, wh, vidx))
    assert rp.LAUNCHES_F32 == before
    assert got.dtype == torch.float32
    widened = K4_ONE(*_t(planes.astype(np.float32), wv, wh, vidx))
    assert torch.equal(got, widened)
    u = jnp.asarray(vidx)
    want = np.asarray(jnp.einsum(
        "boh,bhw,bpw->bop", jnp.asarray(wv)[u],
        jnp.asarray(planes, jnp.float32), jnp.asarray(wh)[u],
        precision="highest"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=255e-5)
    frac = got.numpy() - np.floor(got.numpy())
    assert ((frac > 0.01) & (frac < 0.99)).mean() > 0.5  # not rounded


def test_k3_epilogue_is_k2s_rounding():
    """floor(clip(v) + 0.5) == clip(floor(v + 0.5)) on every f32 value of
    the edges: why K3 is K2's function with one index."""
    v = torch.tensor([-1.0, -0.5, -0.49999997, 0.0, 0.5, 1.49999994, 254.5,
                      254.49998, 255.0, 255.49998, 255.5, 300.0])
    a = torch.floor(torch.clamp(v, 0.0, 255.0) + 0.5)
    b = torch.clamp(torch.floor(v + 0.5), 0.0, 255.0)
    assert torch.equal(a, b)


# the RGB head's stacks at the slice's bucket pair (1088x1920 -> 240x400):
# luma (U, 240, 1088) / (U, 400, 1920), chroma to FULL output resolution
# (U, 240, 544) / (U, 400, 960)
RGB_GEOMS = [(1920, 1080, 400, 225), (1904, 1072, 397, 223),
             (1888, 1064, 393, 222), (1872, 1056, 390, 220)]


def _rgb_chroma_stacks():
    wv = np.zeros((4, 240, 544), np.float32)
    wh = np.zeros((4, 400, 960), np.float32)
    for u, (iw, ih, ow, oh) in enumerate(RGB_GEOMS):
        wv[u] = combined_chroma_weights((ih + 1) // 2, ih, oh, 544, 240)
        wh[u] = combined_chroma_weights((iw + 1) // 2, iw, ow, 960, 400)
    return wv, wh


def test_band_table_bounds_on_rgb_chroma_stacks():
    for axis, w in zip((3, 2), _rgb_chroma_stacks()):
        got = band_table(torch.from_numpy(w)).numpy()
        for u in range(w.shape[0]):
            for o in range(w.shape[1]):
                nz = np.flatnonzero(w[u, o])
                want = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
                assert tuple(got[u, o]) == want, (u, o)
            # pad rows past each true output are empty bands
            true_out = RGB_GEOMS[u][axis]
            assert (got[u, true_out:] == 0).all()
            assert (got[u, :true_out, 1] > got[u, :true_out, 0]).all()
        assert (got[..., 1] - got[..., 0]).max() <= 16  # banded


def test_k3_on_rgb_chroma_stacks_matches_einsum():
    """The chroma planes of the demoted head: 2x upsample folded into the
    resize, 544x960 -> 240x400, at a reduced batch."""
    wv, wh = _rgb_chroma_stacks()
    rng = np.random.default_rng(8)
    planes = rng.integers(0, 256, (2, 544, 960)).astype(np.uint8)
    vidx = np.array([3, 1], np.int32)
    got = K3_ONE(*_t(planes, wv, wh, vidx)).numpy()
    want = np.asarray(resize_kernel._resize_planes_einsum(
        jnp.asarray(planes), jnp.asarray(wv), jnp.asarray(wh),
        jnp.asarray(vidx)))
    assert_band(got, want, "chroma")


@pytest.mark.parametrize("fn,dtype,name", [
    (K3_ONE, torch.uint8, "K3"),
    (K4_ONE, torch.float32, "K4"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, dtype, name):
    planes, wv, wh, vidx = _t(*_inputs(5))
    planes = planes.to(dtype)
    # K4 takes u8 planes too (the k=8 JPEG -> WebP head's): int16 is what
    # neither of its instantiations reads
    other = torch.float32 if dtype == torch.uint8 else torch.int16
    with pytest.raises(TypeError, match=str(dtype).split(".")[1]):
        fn(planes.to(other), wv, wh, vidx)
    with pytest.raises(TypeError, match="int32"):
        fn(planes, wv, wh, vidx.long())
    with pytest.raises(ValueError, match="contiguous"):
        fn(planes.transpose(1, 2).contiguous().transpose(1, 2), wv, wh, vidx)
    with pytest.raises(ValueError, match="one index"):
        fn(planes, wv, wh[:2].contiguous(), vidx)
    with pytest.raises(ValueError, match="do not fit"):
        fn(planes[:, :32].contiguous(), wv, wh, vidx)
    with pytest.raises(ValueError, match="band tables"):
        fn(planes, wv, wh, vidx, bands=resize_tables(wh, wh))
    meta = [t.to("meta") for t in (planes, wv, wh, vidx)]
    bands = tuple(torch.empty((4, n, 2), dtype=torch.int32, device="meta")
                  for n in (24, 48))
    with pytest.raises(ValueError, match=f"no {name} kernel"):
        fn(*meta, bands=bands)


# -- the three-plane entries (one launch on a card) ---------------------------


def _three_planes(seed, dtype=np.uint8, B=3):
    """Y (64x128) with the luma stacks and Cb, Cr (32x64) with chroma
    stacks that fold the 2x upsample in, all to 24x48 (the demoted head's
    shape relation at a reduced size)."""
    rng = np.random.default_rng(seed)
    wv_y, wh_y = _stacks()
    wv_c = np.zeros((4, 24, 32), np.float32)
    wh_c = np.zeros((4, 48, 64), np.float32)
    for u, ((ti, to), (tj, tp)) in enumerate(zip(V_SLOTS, H_SLOTS)):
        wv_c[u] = combined_chroma_weights((ti + 1) // 2, ti, to, 32, 24)
        wh_c[u] = combined_chroma_weights((tj + 1) // 2, tj, tp, 64, 48)
    planes = [rng.integers(0, 256, (B, h, w)).astype(dtype)
              for h, w in ((64, 128), (32, 64), (32, 64))]
    return planes, (wv_y, wh_y, wv_c, wh_c), np.array([2, 0, 3], np.int32)[:B]


@pytest.mark.parametrize("seed", [6, 7])
def test_k3_three_planes_match_resize_planes_einsum(seed):
    """``resize_planes3`` on CPU tensors (its plain version, no launch)
    against the JAX package's ``_resize_planes_einsum`` (K3's reference
    semantics, ``resize_kernel.py:282``) plane by plane, each plane with
    its own stacks."""
    planes, stacks, vidx = _three_planes(seed)
    before = rp.LAUNCHES
    got = rp.resize_planes3(_t(*planes), _t(*stacks), torch.from_numpy(vidx),
                            bands=(None, None))
    assert rp.LAUNCHES == before
    pairs = (stacks[:2], stacks[2:], stacks[2:])
    for g, p, (wv, wh) in zip(got, planes, pairs):
        want = np.asarray(resize_kernel._resize_planes_einsum(
            jnp.asarray(p), jnp.asarray(wv), jnp.asarray(wh),
            jnp.asarray(vidx)))
        assert g.dtype == torch.uint8 and g.shape == (3, 24, 48)
        assert_band(g.numpy(), want, "K3 plane")
        assert 0.2 < float(((g > 0) & (g < 255)).float().mean())


def test_k4_three_planes_match_float64_product():
    planes, stacks, vidx = _three_planes(8, np.float32)
    planes = [p * np.float32(0.1) + np.float32(0.25) for p in planes]
    before = rp.LAUNCHES_F32
    got = rp.resize_planes3_f32(_t(*planes), _t(*stacks),
                                torch.from_numpy(vidx))
    assert rp.LAUNCHES_F32 == before
    pairs = (stacks[:2], stacks[2:], stacks[2:])
    for g, p, (wv, wh) in zip(got, planes, pairs):
        want = np.stack([
            wv[u].astype(np.float64) @ p[b].astype(np.float64)
            @ wh[u].astype(np.float64).T for b, u in enumerate(vidx)])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=255e-5)


def test_three_plane_entry_refuses_what_the_kernel_does_not_take():
    planes, stacks, vidx = _three_planes(9)
    p, s, v = _t(*planes), _t(*stacks), torch.from_numpy(vidx)
    with pytest.raises(ValueError, match="do not fit"):
        rp.resize_planes3([p[0], p[0], p[2]], s, v)  # Cb of luma's shape
    with pytest.raises(TypeError, match="uint8"):
        rp.resize_planes3([p[0], p[1].float(), p[2]], s, v)
    with pytest.raises(ValueError, match="one index"):
        rp.resize_planes3(p, (s[0], s[1], s[2][:2].contiguous(), s[3]), v)
    with pytest.raises(ValueError, match="no K3 kernel"):
        rp.resize_planes3([t.to("meta") for t in p], s, v)
