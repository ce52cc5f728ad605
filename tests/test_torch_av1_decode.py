"""The port's AV1 intra decoder (``codecs/native/av1_decode.cpp``) against
libdav1d, byte for byte.

AV1 reconstruction is normative, so the planes of every stream here must
equal libdav1d's exactly: libdav1d through the JAX package's
``avif_native._decode_obu`` (a test-only oracle), the streams from
Pillow's AVIF writer (libavif with libaom) over sweeps of quality, speed
(speed 4 and lower turn loop restoration on), chroma layout, size, alpha,
``enable-cdef`` and screen content, from the port's own first-party
encoder, and true monochrome streams as the JAX package's own tests make
them (``tests/test_avif_native.py::_mono_avif``). The streams that use a
tool the decoder does not build answer ``Av1NotPorted`` (the app's 501):
palette blocks, film grain, quantizer matrices from Pillow's writer;
superres, intra block copy and 10-bit from headers written here bit by
bit. Hostile streams raise ValueError or decode, and never crash (the
sanitizer run of the same cases is in ``test_torch_kernel_asan.py``).
The 1-D inverse transforms are held against the encoder's certified
``av1_itx`` (DCT 4-32, bit-exact) and against float references (DCT64 and
the ADSTs). Speed-0 and speed-2 streams stay at most 256 x 256.
"""

import io
import math

import numpy as np
import pytest

from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch.codecs import av1_itx, avif_encode
from imagekit_tpu_torch.codecs.av1_entropy import BitWriter, leb128
from imagekit_tpu_torch.codecs.native import av1_dec_abi

try:
    from PIL import Image as PIL
except ImportError:  # the oracles' tests skip
    PIL = None


def _have_pillow_avif() -> bool:
    try:
        PIL.fromarray(np.zeros((8, 8, 3), np.uint8)).save(io.BytesIO(), "AVIF")
        return True
    except Exception:
        return False


needs_oracles = pytest.mark.skipif(
    not (ref_avif.decode_available() and _have_pillow_avif()),
    reason="libdav1d or Pillow's AVIF writer unavailable (the oracles)")


def synth(w: int, h: int, seed: int = 0, kind: str = "noise") -> np.ndarray:
    """A seeded RGB picture: gradients with noise, or with hard edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(w + h - 2, 1)], -1).astype(
                         np.float32)
    if kind == "noise":
        base += rng.normal(0, 25, base.shape)
    else:
        base += ((xx // 7 + yy // 5) % 2)[..., None] * 80
        base += rng.normal(0, 6, base.shape)
    return np.clip(base, 0, 255).astype(np.uint8)


def pillow_avif(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.fromarray(arr).save(buf, "AVIF", **kw)
    return buf.getvalue()


def assert_planes_equal(obu: bytes, w: int, h: int, what: str = "") -> None:
    """The decoder's planes of ``obu`` byte-equal to libdav1d's."""
    want = ref_avif._decode_obu(obu, w, h)
    assert want is not None, f"libdav1d does not decode {what}"
    y, u, v, info = av1_dec_abi.decode(obu)
    assert (info.width, info.height) == (w, h), what
    for name, got, exp in zip("YUV", (y, u, v), want[:3]):
        if exp is None:
            assert got is None, (what, name)
            continue
        assert got.shape == exp.shape, (what, name)
        diff = np.argwhere(got != exp)
        assert not len(diff), (what, name, len(diff), diff[0].tolist())


def assert_file_equal(data: bytes, what: str = "") -> None:
    """The colour item, and the alpha item where there is one."""
    info = ref_avif.parse_container(data)
    assert_planes_equal(info.obu, info.width, info.height, what)
    if info.alpha_obu:
        aw, ah = info.alpha_size if info.alpha_size != (0, 0) else (
            info.width, info.height)
        assert_planes_equal(info.alpha_obu, aw, ah, what + " alpha")


# -- sweeps of Pillow's writer --------------------------------------------------


@needs_oracles
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("quality", [10, 30, 50, 70, 90, 100])
def test_quality_and_layout_sweep(quality, sub):
    data = pillow_avif(synth(120, 72, seed=quality), quality=quality,
                       subsampling=sub)
    assert_file_equal(data, f"q{quality} {sub}")


@needs_oracles
@pytest.mark.parametrize("speed", [0, 2, 4, 6, 10])
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
def test_speed_sweep(speed, sub):
    """Speeds 4 and lower turn loop restoration on (Wiener, self-guided
    and switchable units); speed 0 searches the most tools."""
    for q in (20, 60):
        data = pillow_avif(synth(200, 136, seed=speed + q, kind="edges"),
                           quality=q, subsampling=sub, speed=speed)
        assert_file_equal(data, f"speed {speed} q{q} {sub}")


@needs_oracles
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (1000, 3), (3, 300),
                                  (130, 70)])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_odd_sizes(size, sub):
    """Frames padded to the 8-pixel MI grid, chroma of odd widths rounded
    up, partitions cut by the frame's edges."""
    w, h = size
    data = pillow_avif(synth(w, h, seed=w * h), quality=55, subsampling=sub)
    assert_file_equal(data, f"{w}x{h} {sub}")


@needs_oracles
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2"])
def test_1080p(sub):
    data = pillow_avif(synth(1920, 1080, seed=3, kind="edges"), quality=50,
                       subsampling=sub, speed=10)
    assert_file_equal(data, f"1080p {sub}")


@needs_oracles
@pytest.mark.parametrize("speed", [4, 6])
def test_cdef(speed):
    data = pillow_avif(synth(256, 200, seed=speed, kind="edges"), quality=40,
                       speed=speed, advanced=[("enable-cdef", "1")])
    info = av1_dec_abi.probe(ref_avif.parse_container(data).obu)
    assert info.layout == av1_dec_abi.I420
    assert_file_equal(data, f"cdef speed {speed}")


@needs_oracles
@pytest.mark.parametrize("quality", [20, 60, 95])
def test_rgba(quality):
    rgba = np.dstack([synth(160, 96, seed=quality),
                      (np.arange(160)[None, :] * np.ones((96, 1))).astype(
                          np.uint8)])
    buf = io.BytesIO()
    PIL.fromarray(rgba, "RGBA").save(buf, "AVIF", quality=quality)
    info = ref_avif.parse_container(buf.getvalue())
    assert info.alpha_obu
    assert_file_equal(buf.getvalue(), f"rgba q{quality}")


@needs_oracles
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
def test_screen_content_exact_or_501(sub):
    """``tune-content=screen`` turns the screen-content tools on: a frame
    that codes no palette decodes exactly, one that does answers 501."""
    natural = pillow_avif(synth(128, 96, seed=1), quality=60, subsampling=sub,
                          advanced=[("tune-content", "screen")])
    assert_file_equal(natural, "screen content, natural picture")
    flat = np.zeros((96, 128, 3), np.uint8)
    flat[::8] = 255
    flat[:, ::16] = (200, 30, 30)
    data = pillow_avif(flat, quality=60, subsampling=sub,
                       advanced=[("tune-content", "screen")])
    with pytest.raises(av1_dec_abi.Av1NotPorted, match="palette"):
        av1_dec_abi.decode(ref_avif.parse_container(data).obu)


@needs_oracles
def test_image_sequence_first_frame():
    """An ``avis`` file: its primary item is the first frame."""
    frames = [PIL.fromarray(np.roll(synth(64, 48), i * 8, axis=1))
              for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   duration=100, quality=80)
    data = buf.getvalue()
    assert data[8:12] == b"avis"
    assert_file_equal(data, "avis")


# -- other writers ----------------------------------------------------------------


@needs_oracles
@pytest.mark.parametrize("size", [(64, 48), (97, 33), (256, 144)])
def test_the_ports_own_encoder(size):
    w, h = size
    img = synth(w, h, seed=w)
    assert_file_equal(avif_encode.encode_rgb(img, 70), f"own {w}x{h}")
    rgba = np.dstack([img, np.full((h, w), 90, np.uint8)])
    assert_file_equal(avif_encode.encode_rgb(rgba, 70), f"own rgba {w}x{h}")


@needs_oracles
@pytest.mark.parametrize("full_range", [False, True])
def test_monochrome(full_range):
    from tests.test_avif_native import _mono_avif

    yy = synth(96, 64, seed=5)[:, :, 0]
    data = _mono_avif(yy, q=85, full_range=full_range)
    info = ref_avif.parse_container(data)
    assert info.monochrome
    head = av1_dec_abi.probe(info.obu)
    assert head.mono and head.layout == av1_dec_abi.I400
    assert_file_equal(data, "mono")


# -- the remainder: 501 ---------------------------------------------------------


@needs_oracles
@pytest.mark.parametrize("case, advanced, reason", [
    ("film grain", [("denoise-noise-level", "50")], "film grain"),
    ("quantizer matrices", [("enable-qm", "1")], "quantizer matrices"),
])
def test_remainder_from_pillow(case, advanced, reason):
    data = pillow_avif(synth(256, 192, seed=9), quality=60, advanced=advanced)
    with pytest.raises(av1_dec_abi.Av1NotPorted, match=reason):
        av1_dec_abi.decode(ref_avif.parse_container(data).obu)


def obu(kind: int, payload: bytes) -> bytes:
    return bytes([kind << 3 | 2]) + leb128(len(payload)) + payload


def seq_header(w: int = 64, h: int = 64, high_bitdepth: int = 0,
               superres: int = 0, profile: int = 0) -> bytes:
    """A reduced still-picture sequence header (spec 5.5)."""
    b = BitWriter()
    b.f(profile, 3)
    b.f(1, 1)   # still_picture
    b.f(1, 1)   # reduced_still_picture_header
    b.f(0, 5)   # seq_level_idx
    b.f(15, 4)
    b.f(15, 4)  # frame width / height bits - 1
    b.f(w - 1, 16)
    b.f(h - 1, 16)
    b.f(0, 1)   # use_128x128_superblock
    b.f(0, 1)   # enable_filter_intra
    b.f(0, 1)   # enable_intra_edge_filter
    b.f(superres, 1)
    b.f(0, 1)   # enable_cdef
    b.f(0, 1)   # enable_restoration
    b.f(high_bitdepth, 1)
    if profile != 1:
        b.f(0, 1)  # mono_chrome
    b.f(0, 1)   # color_description_present_flag
    b.f(0, 1)   # color_range
    if profile == 0:
        b.f(0, 2)  # chroma_sample_position
    b.f(0, 1)   # separate_uv_delta_q
    b.f(0, 1)   # film_grain_params_present
    b.trailing_bits()
    return obu(1, b.bytes())


def frame_header(allow_sct: int = 0, allow_intrabc: int = 0,
                 use_superres: int = 0) -> bytes:
    """The first bits of a reduced header's KEY_FRAME (spec 5.9)."""
    b = BitWriter()
    b.f(0, 1)  # disable_cdf_update
    b.f(allow_sct, 1)
    if allow_sct:
        b.f(0, 1)  # force_integer_mv
    if use_superres:
        b.f(1, 1)  # use_superres
        b.f(7, 3)  # coded_denom
    b.f(0, 1)  # render_and_frame_size_different
    if allow_sct:
        b.f(allow_intrabc, 1)
    b.f(0, 64)
    b.trailing_bits()
    return obu(3, b.bytes())


def remainder_avif(w: int = 64, h: int = 48) -> bytes:
    """A whole AVIF file whose stream is 10-bit: a source of the
    remainder, which the port answers with 501 (the container is the
    port's first-party writer's)."""
    from imagekit_tpu_torch.codecs.av1_container import write_avif

    return write_avif(seq_header(w, h, high_bitdepth=1) + frame_header(),
                      w, h)


@pytest.mark.parametrize("stream, reason", [
    (lambda: seq_header(high_bitdepth=1) + frame_header(), "10- and 12-bit"),
    (lambda: seq_header(superres=1) + frame_header(use_superres=1),
     "superres"),
    (lambda: seq_header() + frame_header(allow_sct=1, allow_intrabc=1),
     "intra block copy"),
], ids=["10-bit", "superres", "intrabc"])
def test_remainder_from_headers(stream, reason):
    """Tools gated at the headers answer before any tile decodes."""
    with pytest.raises(av1_dec_abi.Av1NotPorted, match=reason):
        av1_dec_abi.probe(stream())
    with pytest.raises(av1_dec_abi.Av1NotPorted, match=reason):
        av1_dec_abi.decode(stream())


def test_probe_reads_the_headers():
    head = av1_dec_abi.probe(seq_header(48, 40) + frame_header())
    assert (head.width, head.height, head.layout, head.bitdepth) == (
        48, 40, av1_dec_abi.I420, 8)
    assert not head.mono and not head.full_range


# -- hostile streams ---------------------------------------------------------------


def hostile_streams():
    """Truncations and byte flips of a real stream, and garbage."""
    data = avif_encode.encode_rgb(synth(96, 64, seed=2), 60)
    from imagekit_tpu_torch.codecs.avif_native import parse_container

    stream = parse_container(data).obu
    rng = np.random.default_rng(7)
    out = [b"", b"\x00", b"\x12\x00", stream[:3], stream[:len(stream) // 2],
           stream[:-1], bytes(rng.integers(0, 256, 300, dtype=np.uint8))]
    for _ in range(24):
        m = bytearray(stream)
        for i in rng.integers(0, len(m), 3):
            m[i] ^= int(rng.integers(1, 256))
        out.append(bytes(m))
    return out


def test_hostile_streams_never_crash():
    for s in hostile_streams():
        try:
            y, _u, _v, info = av1_dec_abi.decode(s)
            assert y.shape == (info.height, info.width)
        except (ValueError, av1_dec_abi.Av1NotPorted):
            pass


# -- inverse transforms ---------------------------------------------------------------


def _tx(vals, kind: int, n: int) -> np.ndarray:
    a = np.array(vals, np.int64)
    av1_dec_abi.load().ik_av1d_tx1d(a.ctypes.data, kind, n)
    return a


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_idct_bit_exact_against_av1_itx(n):
    rng = np.random.default_rng(n)
    f = av1_itx._IDCT[1 << n]
    for _ in range(200):
        x = rng.integers(-4000, 4000, 1 << n).tolist()
        assert _tx(x, 0, n).tolist() == f(x)


@pytest.mark.parametrize("n, kind", [(6, 0), (2, 1), (3, 1), (4, 1)],
                         ids=["dct64", "adst4", "adst8", "adst16"])
def test_transforms_against_float(n, kind):
    """Each basis vector within 2.5 of the real transform's (2048 in)."""
    N = 1 << n
    for k in range(N):
        x = [0] * N
        x[k] = 2048
        got = _tx(x, kind, n)
        if kind == 0:
            ref = [2048 * math.cos(math.pi * k * (2 * i + 1) / (2 * N))
                   * (math.sqrt(0.5) if k == 0 else 1) for i in range(N)]
        elif N == 4:
            ref = [2048 * 2 * math.sqrt(2) / 3 * math.sin(
                math.pi * (i + 1) * (2 * k + 1) / 9) for i in range(N)]
        else:
            ref = [2048 * math.sin(math.pi * (2 * i + 1) * (2 * k + 1)
                                   / (4 * N)) for i in range(N)]
        assert np.abs(got - np.array(ref)).max() < 2.5, (n, kind, k)


def test_walsh_hadamard_of_a_dc():
    """The lossless 4-point WHT spreads a DC evenly (shift 2 in)."""
    assert _tx([64, 0, 0, 0], 3, 2).tolist() == [8, 8, 8, 8]
