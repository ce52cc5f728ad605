"""The port's YUV heads (their plain versions, on the CPU) against the JAX
package's, on identical seeded inputs.

- JPEG -> WebP at k = 8: ``decode_resize_yuv_i8_batch`` (split-int8
  transport) and ``decode_resize_yuv_batch`` (int16 transport) against the
  JAX heads; the resize is K4's plain version, fed the u8 planes of the 8x8
  IDCT and storing unrounded f32 before the studio-range remap.
- The truncated head on the int16 transport,
  ``decode_resize_yuv_lowfreq_batch`` (K1's int16 entry, its plain version
  here), against the JAX head, and against the port's split-int8 head on the
  same levels regrouped (both transports carry the same integers).
- The YUV-source heads ``resize_yuv420_batch`` and ``resize_yuv_jpeg_batch``
  (K2's plain version on the three planes, read in place from the flat
  batch) against the JAX heads, each through its einsum form and through its
  Pallas front (K2) in interpret mode.

Tolerance: u8 planes within max |d| <= 1 on at most 0.1% of pixels, the
reference's own band (tests/test_pallas_jpeg8.py:72): torch and XLA take
the fp32 sums in different orders. The int16 levels of ``resize_yuv_jpeg``
are exact on the CPU: the fDCT sums in XLA's CPU order (``ops/dct.py::
_dot8``) and the resized planes agree before it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.ops import pallas_resize
from imagekit_tpu.ops.resize import padded_weights
from imagekit_tpu_torch.ops import dct, jpeg8, resize_planes, resize_strip
from imagekit_tpu_torch.ops.weights import (
    combined_chroma_half_weights,
    fold_lowfreq_weights,
    pad128,
)
from tests.test_torch_jxc_slice import _k8_inputs
from tests.test_torch_resize import assert_band


def _unclipped(planes):
    """Most of the output lies inside the u8 range: the band is not met by
    saturation."""
    y = np.asarray(planes[0])
    return ((y > 0) & (y < 255)).mean() > 0.5


# -- JPEG -> WebP at k = 8 ------------------------------------------------------


def test_k8_split_head_matches_jax():
    args = _k8_inputs(seed=31)
    want = ref_dct.decode_resize_yuv_i8_batch(*args)
    before = resize_planes.LAUNCHES_F32
    got = dct.decode_resize_yuv_i8_batch(*args, device="cpu")
    assert resize_planes.LAUNCHES_F32 == before  # the CPU takes K4's plain version
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.uint8
        assert_band(g, w, name)
    assert _unclipped(got)
    # the escape residuals are live
    dcs, acs, escs, *rest = args
    escs = tuple((np.zeros_like(i), np.zeros_like(v)) for i, v in escs)
    without = dct.decode_resize_yuv_i8_batch(dcs, acs, escs, *rest, device="cpu")
    assert any((a != b).any() for a, b in zip(got, without))


def _k8_levels(seed):
    """``_k8_inputs`` widened to the int16 transport: (B, by, bx*64)
    block-grouped levels per plane, escapes added in."""
    dcs, acs, escs, qt, ws, vidx, bd, os_ = _k8_inputs(seed)
    by, bx, cy, cx = bd
    dims = ((by, bx), (cy, cx), (cy, cx))
    t = torch.from_numpy
    flats = [dct._widen_split_levels(t(dcs[p]), t(acs[p]), t(escs[p][0]),
                                     t(escs[p][1]), *dims[p]).to(torch.int16).numpy()
             for p in range(3)]
    return flats, qt, ws, vidx, bd, os_


def test_k8_int16_head_matches_jax_and_the_split_head():
    flats, qt, ws, vidx, bd, os_ = _k8_levels(seed=32)
    assert all(f.dtype == np.int16 for f in flats)
    want = ref_dct.decode_resize_yuv_batch(*flats, qt, ws, vidx, bd, os_)
    got = dct.decode_resize_yuv_batch(*flats, qt, ws, vidx, bd, os_,
                                      device="cpu")
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w, name)
    assert _unclipped(got)
    # the two transports carry the same integers: bit-identical planes
    split = dct.decode_resize_yuv_i8_batch(*_k8_inputs(seed=32), device="cpu")
    for a, b in zip(got, split):
        assert np.array_equal(a, b)


def test_k8_head_resizes_unrounded_planes():
    """K3 in K4's place rounds the resized planes before the remap and moves
    the last bit of a large share of the pixels: the head must not."""
    dcs, acs, escs, qt, ws, vidx, bd, os_ = _k8_inputs(seed=33)
    t = torch.from_numpy
    args = (tuple(map(t, dcs)), tuple(map(t, acs)),
            tuple((t(i), t(v)) for i, v in escs), t(qt), tuple(map(t, ws)),
            t(vidx), bd)
    k4 = dct.decode_resize_yuv_i8(*args)

    def rounded(planes, stacks, vidx, bands=None):
        return tuple(p.float() for p in resize_planes.resize_planes3(
            planes, stacks, vidx, bands=bands))

    k3 = dct.decode_resize_yuv_i8(*args, resize=rounded)
    assert float((k4 != k3).float().mean()) > 0.05


# -- the truncated head on the int16 transport -----------------------------------


def _lowfreq_inputs(k, seed, B=3, U=4, by=16, bx=32, obh=64, obw=128):
    """Seeded block-grouped int16 levels (B, rows, pad128(nblk*k*k)), level
    u*k+v of block column c at c*k*k + u*k+v, the padding columns filled
    with junk the head must not read, and folded stacks that keep the
    output mostly unclipped."""
    rng = np.random.default_rng(seed)
    cy, cx = by // 2, bx // 2
    nk = k * k

    def levels(rows, nblk):
        lev = rng.integers(-12, 12, (B, rows, nblk, nk))
        lev[..., 0] = rng.integers(-60, 60, (B, rows, nblk))
        flat = rng.integers(-999, 999, (B, rows, pad128(nblk * nk)))
        flat[:, :, : nblk * nk] = lev.reshape(B, rows, -1)
        return flat.astype(np.int16)

    def w(o, n):
        m = rng.random((U, o, n * k)).astype(np.float32)
        return fold_lowfreq_weights(m / m.sum(axis=2, keepdims=True), k)

    qt = (rng.random((B, 128)) * 8 + 1).astype(np.float32)
    vidx = (np.arange(B) % U).astype(np.int32)
    return ((levels(by, bx), levels(cy, cx), levels(cy, cx)), qt,
            (w(obh, by), w(obw, bx), w(obh // 2, cy), w(obw // 2, cx)), vidx,
            (by, bx, cy, cx), (obh, obw))


@pytest.mark.parametrize("k", [2, 4])
def test_lowfreq_int16_head_matches_jax(k):
    flats, qt, ws, vidx, bd, os_ = _lowfreq_inputs(k, seed=40 + k)
    want = ref_dct.decode_resize_yuv_lowfreq_batch(*flats, qt, ws, vidx, bd,
                                                   os_, k)
    before = jpeg8.LAUNCHES
    got = dct.decode_resize_yuv_lowfreq_batch(*flats, qt, ws, vidx, bd, os_,
                                              k, device="cpu")
    assert jpeg8.LAUNCHES == before  # the CPU takes K1's plain version
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.uint8
        assert_band(g, w, name)
    assert _unclipped(got)


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_int16_entry_equals_the_split_entry_on_the_same_levels(k, centered):
    """Block-grouped int16 levels regrouped to the planar split layout (no
    escapes needed: the values fit int8 and int16 DC) give the same planes
    through ``folded_planes_i8``: the two entries differ in staging only."""
    flats, qt, ws, vidx, bd, _ = _lowfreq_inputs(k, seed=50 + k)
    nk, na = k * k, k * k - 1
    t = torch.from_numpy
    dcs, acs, escs = [], [], []
    for flat, nblk in zip(flats, (bd[1], bd[3], bd[3])):
        B, rows, _ = flat.shape
        lev = flat[:, :, : nblk * nk].reshape(B, rows, nblk, nk)
        p = pad128(nblk)
        dc = np.zeros((B, rows, p), np.int16)
        dc[:, :, :nblk] = lev[..., 0]
        ac = np.zeros((B, rows, na * p), np.int8)
        for j in range(na):
            ac[:, :, j * p: j * p + nblk] = lev[..., j + 1]
        dcs.append(t(dc))
        acs.append(t(ac))
        escs.append((torch.zeros((8, 3), dtype=torch.int32),
                     torch.zeros(8, dtype=torch.int32)))
    stacks = tuple(map(t, ws))
    got = jpeg8.folded_planes_i16(tuple(map(t, flats)), t(qt), stacks, None,
                                  t(vidx), k, centered)
    want = jpeg8.folded_planes_i8(dcs, acs, escs, t(qt), stacks, None,
                                  t(vidx), k, centered)
    pairs = zip(got, want) if centered else [(got, want)]
    for g, w in pairs:
        assert g.dtype == w.dtype == (torch.int8 if centered else torch.uint8)
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["dtype", "narrow", "rows", "device", "k"])
def test_int16_entry_rejects_what_the_kernel_does_not_take(bad):
    flats, qt, ws, vidx, _, _ = _lowfreq_inputs(2, seed=3)
    t = torch.from_numpy
    flats, stacks, k = list(map(t, flats)), list(map(t, ws)), 2
    if bad == "dtype":
        flats[1] = flats[1].to(torch.int32)
    elif bad == "narrow":
        flats[0] = flats[0][:, :, :100].contiguous()  # 32 blocks need 128
    elif bad == "rows":
        flats[2] = flats[2][:, :-1].contiguous()
    elif bad == "device":
        stacks[2] = stacks[2].to("meta")
    else:
        k = 8
    with pytest.raises((TypeError, ValueError)):
        jpeg8.folded_planes_i16(flats, t(qt), stacks, None, t(vidx), k)


def test_int16_entry_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    monkeypatch.setattr(jpeg8, "folded_planes_i16_plain",
                        lambda *a, **k: pytest.fail("plain version taken"))
    flats, qt, ws, vidx, _, _ = _lowfreq_inputs(2, seed=4)
    meta = lambda xs: tuple(torch.from_numpy(x).to("meta") for x in xs)  # noqa: E731
    bands = tuple(jpeg8.folded_bands(torch.from_numpy(s)).to("meta")
                  for s in ws)
    with pytest.raises(ValueError, match="no K1 kernel"):
        jpeg8.folded_planes_i16(meta(flats), meta([qt])[0], meta(ws), bands,
                                meta([vidx])[0], 2)


# -- the YUV-source heads -----------------------------------------------------------

BH, BW, OBH, OBW = 64, 256, 32, 128
# (true w, h, out w, out h) of the four slots
GEOMS = [(240, 60, 120, 30), (200, 56, 104, 28), (256, 64, 128, 32),
         (130, 34, 66, 18)]


def _yuv_inputs(seed, jq=False, B=3):
    """A flat (B, pad128(bh*bw*3/2)) studio-range batch, smooth enough to
    stay inside the range after the resize, and the engine's stacks for
    four geometries (for JPEG output the rows past the true output
    replicate the last true row up to the MCU grid)."""
    rng = np.random.default_rng(seed)
    ny, nc = BH * BW, (BH // 2) * (BW // 2)
    x = np.linspace(0, 1, ny + 2 * nc, dtype=np.float32)[None]
    flat = np.zeros((B, pad128(ny + 2 * nc)), np.uint8)
    flat[:, : ny + 2 * nc] = np.clip(
        126 + 90 * np.sin(40 * x + rng.random((B, 1)) * 6)
        + rng.normal(0, 12, (B, ny + 2 * nc)), 16, 240).astype(np.uint8)
    wv_y = np.zeros((4, OBH, BH), np.float32)
    wh_y = np.zeros((4, OBW, BW), np.float32)
    wv_c = np.zeros((4, OBH // 2, BH // 2), np.float32)
    wh_c = np.zeros((4, OBW // 2, BW // 2), np.float32)
    for u, (iw, ih, ow, oh) in enumerate(GEOMS):
        wv_y[u] = padded_weights(ih, oh, BH, OBH)
        wh_y[u] = padded_weights(iw, ow, BW, OBW)
        wv_c[u] = combined_chroma_half_weights((ih + 1) // 2, ih, oh,
                                               BH // 2, OBH // 2)
        wh_c[u] = combined_chroma_half_weights((iw + 1) // 2, iw, ow,
                                               BW // 2, OBW // 2)
        if jq:
            m_h, m_w = min((oh + 15) // 16 * 16, OBH), min((ow + 15) // 16 * 16, OBW)
            wv_y[u, oh:m_h] = wv_y[u, oh - 1]
            wh_y[u, ow:m_w] = wh_y[u, ow - 1]
            wv_c[u, (oh + 1) // 2: m_h // 2] = wv_c[u, (oh + 1) // 2 - 1]
            wh_c[u, (ow + 1) // 2: m_w // 2] = wh_c[u, (ow + 1) // 2 - 1]
    vidx = np.array([0, 3, 1], np.int32)[:B]
    return flat, (wv_y, wh_y, wv_c, wh_c), vidx


@pytest.mark.parametrize("pallas", ["", "interpret"])
def test_resize_yuv420_matches_jax(monkeypatch, pallas):
    flat, ws, vidx = _yuv_inputs(seed=60)
    monkeypatch.setenv("IMAGEKIT_PALLAS_YUV", pallas)
    assert pallas_resize.enabled() == bool(pallas)
    want = ref_dct.resize_yuv420_batch(flat, ws, vidx, (BH, BW), (OBH, OBW))
    before = resize_strip.LAUNCHES
    got = dct.resize_yuv420_batch(flat, ws, vidx, (BH, BW), (OBH, OBW),
                                  device="cpu")
    assert resize_strip.LAUNCHES == before  # the CPU takes K2's plain version
    assert [g.shape for g in got] == [(3, OBH, OBW)] + [(3, OBH // 2, OBW // 2)] * 2
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.uint8
        assert_band(g, np.asarray(w), name)
    assert _unclipped(got)


@pytest.mark.parametrize("pallas", ["", "interpret"])
def test_resize_yuv_jpeg_levels_exact_against_jax(monkeypatch, pallas):
    flat, ws, vidx = _yuv_inputs(seed=61, jq=True)
    qt_out = (np.random.default_rng(61).random((3, 128)) * 20 + 1).astype(
        np.float32)
    monkeypatch.setenv("IMAGEKIT_PALLAS_YUVJPG", pallas)
    assert pallas_resize.yuvjpg_enabled() == bool(pallas)
    args = (flat, ws, qt_out, vidx, (BH, BW), (OBH, OBW))
    want = ref_dct.resize_yuv_jpeg_batch(*args)
    got = dct.resize_yuv_jpeg_batch(*args, device="cpu")
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == np.int16 and g.shape == np.asarray(w).shape, name
        assert np.array_equal(g, np.asarray(w)), (name, int(np.abs(
            g.astype(int) - np.asarray(w).astype(int)).max()))
    assert (got[0][..., 1:] != 0).mean() > 0.01  # AC levels, not only DC


def test_yuv_jpeg_front_remaps_luma_and_chroma_apart():
    """The centred planes K2 hands the fDCT are the JAX kernel's ``u8c`` of
    the remapped planes: luma by 255/219 after -16, chroma by 255/224
    about 128."""
    flat, ws, vidx = _yuv_inputs(seed=62, jq=True)
    t = torch.from_numpy
    stacks, v = tuple(map(t, ws)), t(vidx)
    y, cb, cr = resize_strip.yuv_resize(dct.yuv_planes(t(flat), BH, BW),
                                        stacks, v, jpeg=True)
    assert y.dtype == cb.dtype == cr.dtype == torch.int8
    planes = dct.yuv_planes(t(flat), BH, BW)
    for got, x, (wv, wh), (scale, pre, post) in zip(
            (y, cb, cr), planes, (ws[:2], ws[2:], ws[2:]),
            ((255.0 / 219.0, -16.0, 0.0), (255.0 / 224.0, -128.0, 128.0),
             (255.0 / 224.0, -128.0, 128.0))):
        acc = jnp.einsum("boh,bhw,bpw->bop", jnp.asarray(wv)[vidx],
                         jnp.asarray(x.numpy(), jnp.float32),
                         jnp.asarray(wh)[vidx], precision="highest")
        want = np.clip(np.floor((np.asarray(acc) + np.float32(pre))
                                * np.float32(scale) + np.float32(post)
                                + np.float32(0.5)), 0, 255) - 128
        assert_band(got.numpy(), want.astype(np.int8))


def test_yuv_planes_are_views_of_the_flat_batch():
    flat, ws, vidx = _yuv_inputs(seed=63)
    f = torch.from_numpy(flat)
    y, cb, cr = dct.yuv_planes(f, BH, BW)
    ny, nc = BH * BW, (BH // 2) * (BW // 2)
    assert y.data_ptr() == f.data_ptr()
    assert cb.data_ptr() == f.data_ptr() + ny
    assert cr.data_ptr() == f.data_ptr() + ny + nc
    assert y.stride() == (f.shape[1], BW, 1) and cb.stride() == (f.shape[1], BW // 2, 1)
    # a plane whose rows are not dense is refused, not copied
    stacks, v = tuple(map(torch.from_numpy, ws)), torch.from_numpy(vidx)
    with pytest.raises(ValueError, match="dense"):
        resize_strip.yuv_resize((y[:, :, ::1], cb[:, :, ::2], cr), stacks, v)
    with pytest.raises(TypeError, match="uint8"):
        resize_strip.yuv_resize((y.float(), cb, cr), stacks, v)


@pytest.mark.parametrize("variant", ["mix", "alpha", "chroma_sub", "jpeg_mix"])
def test_avif_source_variants_are_not_ported(variant):
    """The AVIF-source variants of the YUV heads, refused with queue 1
    item 8 until AVIF sources were ported, now run (their values against
    the JAX heads: ``test_torch_avif_sources.py``): the BT.709 mix with the
    full-grid chroma stacks, a fourth (alpha) plane, 4:4:4 chroma, and the
    mix to JPEG levels."""
    flat, ws, vidx = _yuv_inputs(seed=64)
    B = flat.shape[0]
    # chroma to the full output grid: each half-grid row twice
    full = (np.repeat(ws[2], 2, axis=1), np.repeat(ws[3], 2, axis=1))
    if variant == "jpeg_mix":
        y, cb, cr = dct.resize_yuv_jpeg_batch(
            flat, ws + full, np.ones((B, 128), np.float32), vidx, (BH, BW),
            (OBH, OBW), mix=True, device="cpu")
        assert y.shape == (B, OBH // 8, OBW // 8, 64)
        assert cb.shape == cr.shape == (B, OBH // 16, OBW // 16, 64)
        return
    kw, weights = {}, ws
    if variant == "mix":
        kw, weights = {"mix": True}, ws + full
    elif variant == "alpha":
        kw = {"alpha": True}
        ny = BH * BW
        flat = np.concatenate([flat, flat[:, :ny]], axis=1)
    else:
        kw = {"chroma_sub": (1, 1)}
        ny = BH * BW
        flat = np.concatenate([flat[:, :ny]] * 3, axis=1)
        # full-size chroma to the half output grid: every other luma row
        weights = ws[:2] + (np.ascontiguousarray(ws[0][:, ::2]),
                            np.ascontiguousarray(ws[1][:, ::2]))
    out = dct.resize_yuv420_batch(flat, weights, vidx, (BH, BW), (OBH, OBW),
                                  device="cpu", **kw)
    assert len(out) == 4 if variant == "alpha" else len(out) == 3
    assert out[0].shape == (B, OBH, OBW)
    assert out[1].shape == out[2].shape == (B, OBH // 2, OBW // 2)
