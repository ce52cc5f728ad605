"""The port's first-party AV1 intra encoder (AVIF output) on the CPU,
against the JAX package.

- ``avif_encode.encode_firstparty`` and ``encode_rgb`` of the port are
  byte-equal to the reference's first-party arm (``IMAGEKIT_AVIF_FIRSTPARTY``
  set on the reference's side, its own switch) on seeded planes: odd sizes
  (1x1, 17x33, 63x65) and a smooth 225x400, q in {1, 50, 80, 100}, with no
  alpha, a real alpha plane, and (``encode_rgb``) an all-255 one, which
  drops the alpha item. Both encoders run on their C entropy engine and
  leaf evaluation (``native/av1_enc.cpp``): the fixture asserts the
  libraries loaded, so no case passes on the numpy fallback alone.
- Decodability: the port's output decodes through libdav1d (the
  reference's ``avif_native``, a test-only oracle here) at the request's
  dims, within the PSNR band of ``tests/test_av1_native.py`` (> 34 dB at
  qindex <= 80 on smooth content), with an alpha item exactly when the
  source had real alpha (alpha within 4 of the source,
  ``tests/test_av1_native.py:256``).
- The cases of ``tests/test_av1_native.py`` and ``tests/test_av1_container.py``
  that hold the encoder, run on the port's modules: each output is
  byte-equal to the reference's and reconstructs through dav1d exactly as
  the encoder's own reconstruction predicts.
"""

import struct

import numpy as np
import pytest

from imagekit_tpu.codecs import av1_image as ref_image
from imagekit_tpu.codecs import av1_intra as ref_intra
from imagekit_tpu.codecs import avif_encode as ref_avif
from imagekit_tpu.codecs import avif_native
from imagekit_tpu.codecs.av1_container import write_avif as ref_write_avif
from imagekit_tpu.codecs.native import av1_abi as ref_av1_abi
from imagekit_tpu_torch.codecs import av1_entropy, av1_image, av1_intra
from imagekit_tpu_torch.codecs import avif_encode
from imagekit_tpu_torch.codecs.av1_container import write_avif
from imagekit_tpu_torch.codecs.native import av1_abi
from imagekit_tpu_torch.errors import NotPortedError
from tests.test_torch_jxc_slice import _ref_native_lib


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


needs_dav1d = pytest.mark.skipif(
    not avif_native.decode_available(),
    reason="libdav1d unavailable (the decode oracle of these tests)")


@pytest.fixture
def native(monkeypatch):
    """Both encoders on their C paths, the reference's first-party arm
    selected. The reference builds its library in place with no lock: a
    process whose first load failed is given another (``_ref_native_lib``)
    and its AV1 binding is reset, as ``tests/test_av1_native.py`` resets it."""
    _ref_native_lib(monkeypatch)
    if ref_av1_abi.load() is None:
        ref_av1_abi._state.update({"attempted": False, "lib": None})
    assert ref_av1_abi.load() is not None
    assert ref_image._leaf_lib() is not None
    assert av1_abi.load() is not None and av1_image._leaf_lib() is not None
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")


def _planes(h, w, seed=3, smooth=False):
    """Studio-range 4:2:0 planes: waves, plus noise unless ``smooth``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 128 + 60 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
    if not smooth:
        y = y + rng.normal(0, 6, (h, w))
    ch, cw = (h + 1) // 2, (w + 1) // 2
    cy, cx = np.mgrid[0:ch, 0:cw]
    cb = 128 + 30 * np.sin(cx / 7.0) + (0 if smooth else rng.normal(0, 3, (ch, cw)))
    cr = 120 + 25 * np.cos(cy / 5.0)
    return (np.clip(y, 16, 235).astype(np.uint8),
            np.clip(cb, 16, 240).astype(np.uint8),
            np.clip(cr, 16, 240).astype(np.uint8))


def _container_planes(h, w, seed=9):
    """The planes of ``tests/test_av1_container.py``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 60 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
                + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    u = np.clip(128 + np.mgrid[0:ch, 0:cw][0], 0, 255).astype(np.uint8)
    v = np.full((ch, cw), 110, np.uint8)
    return y, u, v


def _alpha(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    a = ((xx * 7 + yy * 3) % 256).astype(np.uint8)
    a[: h // 3] = 255
    return a


def _rgb(h, w, seed=5):
    """A smooth RGB image (the heads' studio conversion makes its planes)."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    return np.clip(np.stack([
        120 + 90 * np.sin(xx / 17.0 + yy / 23.0),
        110 + 70 * np.cos(yy / 11.0),
        140 + 60 * np.sin((xx - yy) / 19.0),
    ], axis=2) + rng.normal(0, 1.5, (h, w, 3)), 0, 255).astype(np.uint8)


def _with_alpha(img, kind):
    h, w = img.shape[:2]
    if kind == "rgb":
        return img
    a = _alpha(h, w) if kind == "rgba" else np.full((h, w), 255, np.uint8)
    return np.dstack([img, a])


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


# -- the encoder against the reference, byte for byte ----------------------------

ODD_DIMS = [(1, 1), (17, 33), (63, 65)]
QUALITIES = [1, 50, 80, 100]


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("dims", ODD_DIMS)
@pytest.mark.parametrize("with_alpha", [False, True])
def test_encode_firstparty_byte_equal(native, dims, q, with_alpha):
    h, w = dims
    y, cb, cr = _planes(h, w, seed=h * 100 + w)
    alpha = _alpha(h, w) if with_alpha else None
    got = avif_encode.encode_firstparty(y, cb, cr, q, alpha=alpha)
    assert got == ref_avif.encode_firstparty(y, cb, cr, q, alpha=alpha)
    assert got == avif_encode.encode_yuv420_studio(y, cb, cr, q, alpha=alpha)
    assert got == ref_avif.encode_yuv420_studio(y, cb, cr, q, alpha=alpha)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("dims", ODD_DIMS)
@pytest.mark.parametrize("kind", ["rgb", "rgba", "opaque"])
def test_encode_rgb_byte_equal(native, dims, q, kind):
    """RGB, RGBA with a real alpha plane, and RGBA at 255 everywhere, whose
    alpha item is dropped: its bytes are the RGB image's."""
    h, w = dims
    rgb = _rgb(h, w)
    img = _with_alpha(rgb, kind)
    got = avif_encode.encode_rgb(img, q)
    assert got == ref_avif.encode_rgb(img, q)
    has_alpha = b"auxC" in got[:got.find(b"mdat")]
    assert has_alpha == (kind == "rgba")
    if kind == "opaque":
        assert got == avif_encode.encode_rgb(rgb, q)


@pytest.mark.parametrize("case", ["q1", "q50", "q80", "q100", "alpha_q80",
                                  "rgba_q80"])
def test_smooth_225x400_byte_equal(native, case):
    y, cb, cr = _planes(225, 400, smooth=True)
    if case == "rgba_q80":
        img = _with_alpha(_rgb(225, 400), "rgba")
        assert avif_encode.encode_rgb(img, 80) == ref_avif.encode_rgb(img, 80)
        return
    alpha = _alpha(225, 400) if case.startswith("alpha") else None
    q = int(case.rsplit("q", 1)[1])
    assert (avif_encode.encode_firstparty(y, cb, cr, q, alpha=alpha)
            == ref_avif.encode_firstparty(y, cb, cr, q, alpha=alpha))


def test_plane_contract_and_what_is_not_ported():
    y, cb, cr = _planes(16, 16)
    assert avif_encode.available()
    with pytest.raises(ValueError, match="uint8"):
        avif_encode.encode_yuv420_studio(y.astype(np.int16), cb, cr, 80)
    with pytest.raises(ValueError, match="4:2:0"):
        avif_encode.encode_yuv420_studio(y, cb[:4], cr, 80)
    with pytest.raises(ValueError, match="alpha"):
        avif_encode.encode_yuv420_studio(y, cb, cr, 80, alpha=y[:4])
    with pytest.raises(NotPortedError, match="Y400") as e:
        avif_encode.encode_y400_studio(y, 80)
    assert e.value.roadmap_item == "queue 1 item 8"


# -- decodability (libdav1d as the oracle) ----------------------------------------


@needs_dav1d
@pytest.mark.parametrize("dims", [(17, 33), (63, 65), (225, 400)])
@pytest.mark.parametrize("kind", ["rgb", "rgba", "opaque"])
def test_port_avif_decodes_through_dav1d(native, dims, kind):
    h, w = dims
    img = _with_alpha(_rgb(h, w), kind)
    data = avif_encode.encode_rgb(img, 80)   # qindex 52
    info = avif_native.parse_container(data)
    assert (info.width, info.height) == (w, h) and info.crop is None
    assert info.has_nclx and info.matrix == 6 and not info.full_range
    assert info.has_alpha == (kind == "rgba")
    yd = avif_native.decode_yuv_studio(data)
    y, cb, cr, alpha = avif_encode._split_rgba(img)
    assert yd is not None and yd.y.shape == (h, w)
    assert yd.u.shape == yd.v.shape == cb.shape
    for name, got, want in (("y", yd.y, y), ("cb", yd.u, cb), ("cr", yd.v, cr)):
        assert _psnr(got, want) > 34.0, name
    if kind == "rgba":
        assert int(np.abs(yd.alpha.astype(int) - alpha.astype(int)).max()) <= 4
    else:
        assert yd.alpha is None


# -- the reference's encoder cases on the port's modules -------------------------------
# (tests/test_av1_native.py and tests/test_av1_container.py)


def _contents(h, w, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return {
        "gradient": (xx * 2 + yy + 40).astype(np.uint8),
        "noise": rng.integers(0, 256, (h, w)).astype(np.uint8),
        "waves": np.clip(
            128 + 60 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8),
    }


def _exact_via_dav1d(stream, recon, w, h):
    dec = avif_native._decode_obu(stream, w, h)
    assert dec is not None, "dav1d rejected the stream"
    for got, want in zip(dec[:3], recon):
        assert np.array_equal(np.asarray(got), want)


def _frame(args, **kw):
    """The port's encode_frame, held byte-equal to the reference's."""
    out = av1_image.encode_frame(*args, **kw)
    ref = ref_image.encode_frame(*args, **kw)
    assert out[0] == ref[0]
    for a, b in zip(out[1:], ref[1:]):
        assert np.array_equal(a, b)
    return out


def test_tables_present_and_shaped():
    T = av1_entropy.tables()
    assert T["partition"].shape == (20, 11)
    assert T["kf_y_mode"].shape == (5, 5, 14)
    assert T["uv_mode"].shape == (2, 13, 15)
    assert T["skip"].shape == (3, 3)
    assert T["filter_intra"].shape == (22, 3)
    assert [int(r[0]) for r in T["skip"]] == [1097, 16253, 28192]
    from imagekit_tpu.codecs.av1_entropy import tables as ref_tables

    R = ref_tables()
    assert sorted(T) == sorted(R)
    for k in R:
        assert np.array_equal(T[k], R[k]), k


def test_msac_roundtrip_mixed_symbols():
    T = av1_entropy.tables()
    chains = [
        (T["partition"][12], 10, 3), (T["partition"][8], 10, 0),
        (T["skip"][0], 2, 0), (T["kf_y_mode"][0][0], 13, 0),
        (T["uv_mode"][0][0], 13, 0), (T["filter_intra"][9], 2, 0),
        (T["kf_y_mode"][2][3], 13, 7), (T["partition"][4], 10, 2),
        (T["skip"][2], 2, 1),
    ]
    m = av1_entropy.MsacEncoder()
    for icdf, n, s in chains:
        m.encode_symbol(s, icdf, n)
    m.encode_literal(0x2B5, 10)
    data = m.done()
    d = av1_entropy.MsacDecoder(data)
    for icdf, n, s in chains:
        assert d.decode_symbol(icdf, n) == s
    got = 0
    for _ in range(10):
        got = (got << 1) | d.decode_symbol((1 << 14,), 2)
    assert got == 0x2B5


def test_leb128_and_obu_framing():
    assert av1_entropy.leb128(0) == b"\x00"
    assert av1_entropy.leb128(127) == b"\x7f"
    assert av1_entropy.leb128(128) == b"\x80\x01"
    out = av1_entropy.obu(1, b"\x12\x34")
    assert out[0] == (1 << 3) | 0x02 and out[1] == 2 and out[2:] == b"\x12\x34"


@needs_dav1d
@pytest.mark.parametrize("dims", [(64, 64), (128, 64), (64, 128), (256, 192)])
def test_gray_frame_bit_exact_via_dav1d(native, dims):
    w, h = dims
    stream = av1_intra.encode_gray_frame(w, h)
    assert stream == ref_intra.encode_gray_frame(w, h)
    r = avif_native._decode_obu(stream, w, h)
    assert r is not None, "dav1d rejected the stream"
    assert all((p == 128).all() for p in r[:3])


@needs_dav1d
@pytest.mark.parametrize("content", ["gradient", "noise", "waves"])
@pytest.mark.parametrize("qindex", [20, 80, 160])
def test_image_encode_bit_exact_via_dav1d(native, content, qindex):
    y = _contents(64, 64)[content]
    u = _contents(32, 32, seed=5)[content]
    v = _contents(32, 32, seed=7)[content]
    stream, ry, ru, rv = _frame((y, u, v), qindex=qindex)
    _exact_via_dav1d(stream, (ry, ru, rv), 64, 64)
    if qindex <= 80 and content != "noise":
        assert _psnr(ry, y) > 34.0


@needs_dav1d
@pytest.mark.parametrize("content", ["gradient", "waves"])
@pytest.mark.parametrize("rd", [False, True])
def test_multi_superblock_frames_bit_exact(native, content, rd):
    """Multi-SB frames on the fixed tree and the RD tree (tiles decode
    independently, recon bit-exact)."""
    y = _contents(128, 192)[content]
    u = _contents(64, 96, seed=5)["gradient"]
    v = np.full((64, 96), 110, np.uint8)
    for q in ((60,) if not rd else (40, 120)):
        stream, ry, ru, rv = _frame((y, u, v), qindex=q, rd=rd)
        _exact_via_dav1d(stream, (ry, ru, rv), 192, 128)


def test_image_encode_rejects_bad_geometry():
    y = np.zeros((60, 64), np.uint8)
    u = v = np.zeros((30, 32), np.uint8)
    with pytest.raises(ValueError):
        av1_image.encode_frame(y, u, v, rd=False)
    with pytest.raises(ValueError):
        av1_image.encode_frame(np.zeros((64, 64), np.uint8), u,
                               np.zeros((31, 32), np.uint8))
    with pytest.raises(ValueError):
        av1_image.encode_frame(np.zeros((8, 4104), np.uint8),
                               np.zeros((4, 2052), np.uint8),
                               np.zeros((4, 2052), np.uint8))


@needs_dav1d
@pytest.mark.parametrize("dims", [(150, 100), (65, 65), (20, 12), (5, 3),
                                  (1, 1), (63, 63)])
def test_image_encode_arbitrary_dims_bit_exact(native, dims):
    w, h = dims
    rng = np.random.default_rng(w * 1000 + h)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2) % 256
         + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.uint8)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    u = np.full((ch, cw), 120, np.uint8)
    v = np.full((ch, cw), 135, np.uint8)
    stream, ry, ru, rv = _frame((y, u, v), qindex=60)
    assert ry.shape == (h, w)
    _exact_via_dav1d(stream, (ry, ru, rv), w, h)


@needs_dav1d
def test_itx_recon_matches_dav1d_oracle_in_full_tiles(native):
    """The port's encode_superblock reconstructs through its integer inverse
    transforms; the reference's dav1d oracle (left out of the port) drives
    the same port encoder to the same tiles and planes."""
    rng = np.random.default_rng(17)
    y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    u = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    v = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    for q in (20, 120, 220):
        t1, *p1 = av1_image.encode_superblock(y, u, v, q)
        t2, *p2 = av1_image.encode_superblock(y, u, v, q,
                                              oracle=ref_image._OracleRecon(q))
        assert t1 == t2 == ref_image.encode_superblock(y, u, v, q)[0]
        assert all(np.array_equal(a, b) for a, b in zip(p1, p2))


@needs_dav1d
def test_rd_directional_modes_win_on_stripes(native):
    xx = np.tile(np.arange(192)[None, :], (128, 1))
    vstripe = np.where((xx // 4) % 2 == 0, 30, 220).astype(np.uint8)
    u = np.full((64, 96), 128, np.uint8)
    fixed, *_ = _frame((vstripe, u, u), qindex=60, rd=False)
    rd, ry, ru, rv = _frame((vstripe, u, u), qindex=60, rd=True)
    assert len(rd) < 0.7 * len(fixed)
    _exact_via_dav1d(rd, (ry, ru, rv), 192, 128)


@needs_dav1d
def test_idtx_wins_on_sparse_screen_content(native):
    h, w = 128, 192
    scr = np.full((h, w), 240, np.uint8)
    rng = np.random.default_rng(3)
    for _ in range(60):
        r, c = rng.integers(0, h - 8), rng.integers(0, w - 8)
        scr[r:r + 6, c] = 16
        scr[r, c:c + 5] = 16
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 135, np.uint8)
    stream, ry, ru, rv = _frame((scr, u, v), qindex=30)
    _exact_via_dav1d(stream, (ry, ru, rv), w, h)
    assert _psnr(ry, scr) > 55.0
    assert len(stream) < 3500


@needs_dav1d
def test_cdf_adaptation_smaller_and_bit_exact(native):
    y = _contents(128, 64)["waves"]
    u = _contents(64, 32, seed=5)["gradient"]
    v = np.full((64, 32), 110, np.uint8)
    static, *_ = _frame((y, u, v), qindex=60, adapt=False)
    adapt, ra, ua, va = _frame((y, u, v), qindex=60, adapt=True)
    assert len(adapt) < len(static)
    _exact_via_dav1d(adapt, (ra, ua, va), 64, 128)


@needs_dav1d
def test_smooth_modes_bit_exact(native):
    w = av1_entropy.tables()["sm_weights"]
    assert w.shape == (124,)
    assert [int(w[o]) for o in (0, 4, 12, 28, 60)] == [255] * 5
    assert int(w[123]) == 4
    yy, xx = np.mgrid[0:128, 0:192]
    grad = ((xx + yy) * 1.1 % 256).astype(np.uint8)
    u = np.full((64, 96), 120, np.uint8)
    v = np.full((64, 96), 135, np.uint8)
    stream, ry, ru, rv = _frame((grad, u, v), qindex=60)
    _exact_via_dav1d(stream, (ry, ru, rv), 192, 128)
    assert _psnr(ry, grad) > 45.0


@pytest.mark.parametrize("leaf", ["native_leaf", "numpy_leaf"])
def test_python_entropy_engine_byte_equals_native(native, monkeypatch, leaf):
    """The port's C entropy engine (av1_enc.cpp) against its pure-Python
    MsacEncoder (``av1_abi._state["native"]`` False): the same bytes, with
    the C leaf evaluation and with the numpy one (``_LEAF_LIB`` of
    ``[None]``)."""
    y = _contents(64, 128)["waves"]
    u = _contents(32, 64, seed=5)["gradient"]
    v = np.full((32, 64), 110, np.uint8)
    nat = av1_image.encode_frame(y, u, v, qindex=60)
    monkeypatch.setitem(av1_abi._state, "native", False)
    if leaf == "numpy_leaf":
        monkeypatch.setattr(av1_image, "_LEAF_LIB", [None])
    py = av1_image.encode_frame(y, u, v, qindex=60)
    assert nat[0] == py[0]
    assert all(np.array_equal(a, b) for a, b in zip(nat[1:], py[1:]))


@pytest.mark.parametrize("binding", ["entropy_engine", "leaf_eval"])
def test_native_binding_raises_without_its_symbols(monkeypatch, binding):
    """Where the reference drops to its pure-Python engine or numpy leaf
    evaluation (~40x slower) on a library without the AV1 symbols, the
    port raises: a card run cannot serve AVIF on the slow path unseen."""
    class Bare:
        _name = "libik_native.so"

    monkeypatch.setattr(av1_abi.loader, "load", lambda: Bare())
    monkeypatch.setitem(av1_abi._state, "lib", None)
    monkeypatch.setattr(av1_image, "_LEAF_LIB", [])
    with pytest.raises(RuntimeError, match="lacks the AV1"):
        if binding == "entropy_engine":
            av1_abi.load()
        else:
            av1_image._leaf_lib()


def test_quantizer_to_qindex_map():
    assert avif_encode.quantizer_to_qindex(0) == 1
    assert avif_encode.quantizer_to_qindex(63) == 252
    assert avif_encode.quantizer_to_qindex(
        avif_encode.quality_to_quantizer(60)) == 100
    for q in range(-2, 104):
        assert (avif_encode.quality_to_quantizer(q)
                == ref_avif.quality_to_quantizer(q))
        assert (avif_encode.quantizer_to_qindex(q)
                == ref_avif.quantizer_to_qindex(q))


@needs_dav1d
def test_firstparty_avif_alpha_odd_dims_roundtrip(native):
    rng = np.random.default_rng(3)
    h, w = 100, 150
    y = (np.linspace(40, 200, w)[None, :]
         + rng.normal(0, 6, (h, w))).clip(16, 235).astype(np.uint8)
    cb = np.full(((h + 1) // 2, (w + 1) // 2), 110, np.uint8)
    cr = np.full(((h + 1) // 2, (w + 1) // 2), 140, np.uint8)
    alpha = np.zeros((h, w), np.uint8)
    alpha[20:80, 30:120] = 255
    alpha[50:, :] = 128
    data = av1_image.encode_avif(y, cb, cr, qindex=60, alpha=alpha)
    assert data == ref_image.encode_avif(y, cb, cr, qindex=60, alpha=alpha)
    info = avif_native.parse_container(data)
    assert info.has_alpha and info.alpha_obu
    rgb = avif_native.decode_rgb(data)
    assert rgb is not None and rgb.shape == (h, w, 4)
    assert int(np.abs(rgb[..., 3].astype(int) - alpha.astype(int)).max()) <= 4


@needs_dav1d
def test_container_roundtrip_own_parser(native):
    y, u, v = _container_planes(64, 64)
    stream, *_ = _frame((y, u, v), qindex=60)
    data = write_avif(stream, 64, 64)
    assert data == ref_write_avif(stream, 64, 64)
    info = avif_native.parse_container(data)
    assert (info.width, info.height) == (64, 64) and info.crop is None
    assert info.has_nclx and info.matrix == 6 and not info.full_range
    assert not info.monochrome and info.chroma_sub_x and info.chroma_sub_y
    assert info.obu == stream


@needs_dav1d
@pytest.mark.parametrize("dims", [(64, 64), (100, 150), (37, 61)])
def test_encode_avif_arbitrary_dims(native, dims):
    h, w = dims
    y, u, v = _container_planes(h, w)
    data = av1_image.encode_avif(y, u, v, qindex=60)
    assert data == ref_image.encode_avif(y, u, v, qindex=60)
    info = avif_native.parse_container(data)
    assert info.crop is None and (info.width, info.height) == (w, h)
    yd = avif_native.decode_yuv_studio(data)
    assert yd is not None and yd.y.shape == (h, w)
    assert yd.u.shape == ((h + 1) // 2, (w + 1) // 2)


@needs_dav1d
def test_encode_avif_pixels_cross_decoder(native):
    """Pillow's AVIF plugin (libavif) reads the port's output at its dims."""
    pil = pytest.importorskip("PIL.Image")
    import io

    y, u, v = _container_planes(64, 64)
    data = av1_image.encode_avif(y, u, v, qindex=40)
    rgb = avif_native.decode_rgb(data)
    img = pil.open(io.BytesIO(data))
    img.load()
    assert img.size == (64, 64)
    y2, u2, v2 = _container_planes(37, 61)
    img2 = pil.open(io.BytesIO(av1_image.encode_avif(y2, u2, v2, qindex=40)))
    img2.load()
    assert img2.size == (61, 37)
    diff = np.abs(np.asarray(img.convert("RGB"), int) - rgb[..., :3])
    assert diff.max() <= 4


@needs_dav1d
@pytest.mark.parametrize("raw,crop", [
    ((32, 1, 32, 1, 0, 1, 0, 1), (16, 16, 32, 32)),    # centred
    ((33, 2, 32, 1, -31, 2, -32, 2), None),             # w = 16.5
    ((48, 0, 32, 1, -16, 2, -32, 2), None),             # div by zero
    ((48, 1, 32, 1, 1000, 2, -32, 2), None),            # x0 out of range
])
def test_clap_apertures(native, raw, crop):
    """write_avif with a display size writes a clap box; the reference's
    parser takes a valid aperture and ignores a hostile one."""
    y, u, v = _container_planes(64, 64)
    stream, *_ = _frame((y, u, v), qindex=200)
    data = bytearray(write_avif(stream, 64, 64, display_w=48, display_h=32))
    assert bytes(data) == ref_write_avif(stream, 64, 64, display_w=48,
                                         display_h=32)
    i = bytes(data).find(b"clap")
    assert i > 0
    data[i + 4:i + 36] = struct.pack(">8i", *raw)
    info = avif_native.parse_container(bytes(data))
    assert info.crop == crop
    rgb = avif_native.decode_rgb(bytes(data))
    assert rgb is not None
    assert rgb.shape[:2] == ((64, 64) if crop is None else crop[2:][::-1])
