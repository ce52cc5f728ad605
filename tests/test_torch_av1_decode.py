"""The port's AV1 intra decoder (``codecs/native/av1_decode.cpp``) against
libdav1d, byte for byte.

AV1 reconstruction is normative, so the planes of every stream here must
equal libdav1d's exactly: libdav1d through the JAX package's
``avif_native._decode_obu`` (a test-only oracle), the streams from
Pillow's AVIF writer (libavif with libaom) over sweeps of quality, speed
(speed 4 and lower turn loop restoration on), chroma layout, size, alpha,
``enable-cdef`` and screen content, from the port's own first-party
encoder, and true monochrome streams as the JAX package's own tests make
them (``tests/test_avif_native.py::_mono_avif``); the sweeps of palette
blocks, intra block copy and 10- and 12-bit streams are in
``test_torch_av1_screen_hbd.py``, those of quantizer matrices and film
grain in ``test_torch_av1_qm_grain.py``, those of inter frames in
``test_torch_av1_inter.py``. The decoder builds every tool of a still
and an inter frame: it has no "not ported" answer. A
layered stream, from headers written here bit by bit (superres, the 501 of
these headers before the decoder built it, now probes and wants its
tiles; its streams are in ``test_torch_av1_superres.py``); a
quantizer-matrix and a film-grain
stream from Pillow's writer, which answered 501 before the decoder built
them, decode exactly. Hostile streams (truncations and
byte flips of an own, a palette, an intrabc and a 10-bit stream, and an
intrabc vector that reaches outside its tile) raise ValueError or decode,
and never crash (the sanitizer run of the same cases is in
``test_torch_kernel_asan.py``).
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
    that codes no palette and one that codes palette blocks both decode
    exactly (palettes answered 501 before the decoder built them)."""
    natural = pillow_avif(synth(128, 96, seed=1), quality=60, subsampling=sub,
                          advanced=[("tune-content", "screen")])
    assert_file_equal(natural, "screen content, natural picture")
    flat = np.zeros((96, 128, 3), np.uint8)
    flat[::8] = 255
    flat[:, ::16] = (200, 30, 30)
    data = pillow_avif(flat, quality=60, subsampling=sub,
                       advanced=[("tune-content", "screen")])
    assert_file_equal(data, "screen content, flat lines")
    assert av1_dec_abi.decode(
        ref_avif.parse_container(data).obu)[3].palette_blocks > 0


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
    ("film grain", [("film-grain-test", "4")], "film grain"),
    ("quantizer matrices", [("enable-qm", "1")], "quantizer matrices"),
])
def test_remainder_from_pillow(case, advanced, reason):
    """Film grain and quantizer matrices answered 501 before the decoder
    built them: both decode to libdav1d's planes, and the header says
    which tool the stream uses."""
    data = pillow_avif(synth(256, 192, seed=9), quality=60, advanced=advanced)
    assert_file_equal(data, case)
    info = av1_dec_abi.probe(ref_avif.parse_container(data).obu)
    assert (info.film_grain, info.qmatrix) == (reason == "film grain",
                                               reason != "film grain")


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
                 use_superres: int = 0, qm: int = 0) -> bytes:
    """The first bits of a reduced header's KEY_FRAME (spec 5.9) of a
    frame of one superblock; with ``qm`` its tile info (uniform) and
    quantizer params up to using_qmatrix = 1."""
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
    if qm:
        b.f(1, 1)    # uniform_tile_spacing_flag (one superblock: no more)
        b.f(100, 8)  # base_q_idx
        b.f(0, 3)    # no DC / U delta q
        b.f(1, 1)    # using_qmatrix
    b.f(0, 64)
    b.trailing_bits()
    return obu(3, b.bytes())


def layered_stream(w: int = 64, h: int = 64) -> bytes:
    """A stream of a full (not reduced) sequence header whose operating
    point 0 selects temporal layer 0 of spatial layer 0
    (operating_point_idc 0x101: a layered, scalable stream), then the
    first bits of a shown KEY_FRAME's header."""
    b = BitWriter()
    b.f(0, 3)       # seq_profile
    b.f(1, 1)       # still_picture
    b.f(0, 1)       # reduced_still_picture_header
    b.f(0, 1)       # timing_info_present_flag
    b.f(0, 1)       # initial_display_delay_present_flag
    b.f(0, 5)       # operating_points_cnt_minus_1
    b.f(0x101, 12)  # operating_point_idc[0]
    b.f(0, 5)       # seq_level_idx[0]
    b.f(15, 4)
    b.f(15, 4)      # frame width / height bits - 1
    b.f(w - 1, 16)
    b.f(h - 1, 16)
    b.f(0, 1)       # frame_id_numbers_present_flag
    b.f(0, 3)       # 128x128 superblocks, filter intra, intra edge filter
    b.f(0, 4)       # interintra, masked compound, warped motion, dual filter
    b.f(0, 1)       # enable_order_hint
    b.f(0, 1)       # seq_choose_screen_content_tools
    b.f(0, 1)       # seq_force_screen_content_tools
    b.f(0, 3)       # superres, CDEF, restoration
    b.f(0, 1)       # high_bitdepth
    b.f(0, 1)       # mono_chrome
    b.f(0, 1)       # color_description_present_flag
    b.f(0, 1)       # color_range
    b.f(0, 2)       # chroma_sample_position
    b.f(0, 1)       # separate_uv_delta_q
    b.f(0, 1)       # film_grain_params_present
    b.trailing_bits()
    f = BitWriter()
    f.f(0, 1)  # show_existing_frame
    f.f(0, 2)  # KEY_FRAME
    f.f(1, 1)  # show_frame
    f.f(0, 1)  # disable_cdf_update
    f.f(0, 1)  # frame_size_override_flag
    f.f(0, 1)  # render_and_frame_size_different
    f.f(0, 64)
    f.trailing_bits()
    return obu(1, b.bytes()) + obu(3, f.bytes())


def inter_stream(w: int = 64, h: int = 64) -> bytes:
    """A stream of a full sequence header (not a still picture) whose first
    frame is a shown INTER frame: the first bits of its header, up to
    refresh_frame_flags, then its reference slots, all empty, which fail
    the stream (as they fail libdav1d's) before the rest is read."""
    b = BitWriter()
    b.f(0, 3)       # seq_profile
    b.f(0, 1)       # still_picture
    b.f(0, 1)       # reduced_still_picture_header
    b.f(0, 1)       # timing_info_present_flag
    b.f(0, 1)       # initial_display_delay_present_flag
    b.f(0, 5)       # operating_points_cnt_minus_1
    b.f(0, 12)      # operating_point_idc[0]
    b.f(0, 5)       # seq_level_idx[0]
    b.f(15, 4)
    b.f(15, 4)      # frame width / height bits - 1
    b.f(w - 1, 16)
    b.f(h - 1, 16)
    b.f(0, 1)       # frame_id_numbers_present_flag
    b.f(0, 3)       # 128x128 superblocks, filter intra, intra edge filter
    b.f(0, 4)       # interintra, masked compound, warped motion, dual filter
    b.f(0, 1)       # enable_order_hint
    b.f(0, 1)       # seq_choose_screen_content_tools
    b.f(0, 1)       # seq_force_screen_content_tools
    b.f(0, 3)       # superres, CDEF, restoration
    b.f(0, 1)       # high_bitdepth
    b.f(0, 1)       # mono_chrome
    b.f(0, 1)       # color_description_present_flag
    b.f(0, 1)       # color_range
    b.f(0, 2)       # chroma_sample_position
    b.f(0, 1)       # separate_uv_delta_q
    b.f(0, 1)       # film_grain_params_present
    b.trailing_bits()
    f = BitWriter()
    f.f(0, 1)     # show_existing_frame
    f.f(1, 2)     # INTER_FRAME
    f.f(1, 1)     # show_frame
    f.f(0, 1)     # error_resilient_mode
    f.f(0, 1)     # disable_cdf_update
    f.f(0, 1)     # frame_size_override_flag
    f.f(7, 3)     # primary_ref_frame: none
    f.f(1, 8)     # refresh_frame_flags
    f.f(0, 64)
    f.trailing_bits()
    return obu(1, b.bytes()) + obu(3, f.bytes())


def remainder_avif(w: int = 64, h: int = 48) -> bytes:
    """A whole AVIF file whose stream's output frame is an INTER frame of
    no reference (:func:`inter_stream`), once the source of the remainder
    (inter prediction, a 501): now a stream that does not decode, which
    the port answers as the reference answers it, with libavif's words (a
    400). The container is the port's first-party writer's."""
    from imagekit_tpu_torch.codecs.av1_container import write_avif

    return write_avif(inter_stream(w, h), w, h)


def intrabc_outside_tile() -> bytes:
    """A 64 x 64 frame with intra block copy whose first block takes the
    default vector (0, -320 samples) with no difference: a vector to the
    left of its tile, which is_mv_valid refuses. Written symbol by symbol
    with the port's encoder's MSAC coder over the default CDFs."""
    from imagekit_tpu_torch.codecs.av1_entropy import MsacEncoder

    b = BitWriter()
    b.f(0, 1)    # disable_cdf_update
    b.f(1, 1)    # allow_screen_content_tools
    b.f(0, 1)    # force_integer_mv (1 in an intra frame all the same)
    b.f(0, 1)    # render_and_frame_size_different
    b.f(1, 1)    # allow_intrabc
    b.f(1, 1)    # uniform_tile_spacing_flag
    b.f(100, 8)  # base_q_idx
    b.f(0, 3)    # no DC / U delta q
    b.f(0, 1)    # using_qmatrix
    b.f(0, 1)    # segmentation_enabled
    b.f(0, 1)    # delta_q_present
    # no loop filter, CDEF or restoration params with intra block copy
    b.f(0, 1)    # tx_mode_select
    b.f(0, 1)    # reduced_tx_set
    b.trailing_bits()
    cdf = av1_dec_abi._cdf_arrays()
    ms = MsacEncoder()
    ms.encode_symbol(0, cdf["partition"][3 * 4], 10)  # PARTITION_NONE
    ms.encode_symbol(1, cdf["skip"][0], 2)            # skip
    ms.encode_symbol(1, cdf["intrabc"], 2)            # use_intrabc
    ms.encode_symbol(0, cdf["mv_joint"], 4)           # MV_JOINT_ZERO
    return (seq_header(64, 64) + obu(3, b.bytes())
            + obu(4, ms.done()))


@pytest.mark.parametrize("stream", [
    lambda: seq_header(high_bitdepth=1) + frame_header(),
    lambda: seq_header(superres=1) + frame_header(use_superres=1),
    lambda: seq_header() + frame_header(allow_sct=1, allow_intrabc=1),
    lambda: seq_header() + frame_header(qm=1),
    layered_stream,
], ids=["10-bit", "superres", "intrabc", "quantizer matrices", "layered"])
def test_remainder_from_headers(stream):
    """10-bit streams, superres (here SuperresDenom 16 of a 64-wide frame:
    a coded width of 32), intra block copy, quantizer matrices and layered
    streams (operating point 0 of spatial layer 0) are built: their
    headers probe, and these streams, which carry no tile, do not decode
    (as in libdav1d). No tool of an intra frame is gated at the headers."""
    head = av1_dec_abi.probe(stream())
    assert (head.bitdepth, head.screen_content, head.intrabc,
            head.qmatrix, head.superres_denom) in (
                (10, False, False, False, 8), (8, False, False, False, 16),
                (8, True, True, False, 8), (8, False, False, True, 8),
                (8, False, False, False, 8))
    assert head.width == 64 and head.spatial_id == 0
    with pytest.raises(ValueError, match="missing tiles"):
        av1_dec_abi.decode(stream())
    if ref_avif.decode_available():
        assert ref_avif._decode_obu(stream(), 64, 64) is None


def test_probe_reads_the_headers():
    head = av1_dec_abi.probe(seq_header(48, 40) + frame_header())
    assert (head.width, head.height, head.layout, head.bitdepth) == (
        48, 40, av1_dec_abi.I420, 8)
    assert not head.mono and not head.full_range


# -- hostile streams ---------------------------------------------------------------


def tool_streams() -> dict:
    """Small streams of a palette, an intrabc and a 10-bit frame, where
    Pillow's writer and libavif are at hand, and of a superres frame with
    CDEF and loop restoration, where libaom is (the hostile cases'
    seeds)."""
    from imagekit_tpu_torch.codecs.avif_native import parse_container
    from tests.fixtures.make_avif_sources import _aom_lib, encode_avif_hbd
    from tests.test_torch_av1_screen_hbd import flat_logo, ui_text

    out = {}
    try:
        out["palette"] = pillow_avif(flat_logo(96, 64, 2), quality=60)
        out["intrabc"] = pillow_avif(ui_text(256, 64, 2), quality=60)
    except Exception:  # no AVIF writer
        pass
    rng = np.random.default_rng(3)
    y = rng.integers(64, 940, (48, 64)).astype(np.uint16)
    c = np.full((24, 32), 512, np.uint16)
    ten = encode_avif_hbd(y, c, c, 10, "420", 30)
    if ten is not None:
        out["10bit"] = ten
    streams = {k: parse_container(v).obu for k, v in out.items()}
    if _aom_lib() is not None:
        from tests.test_torch_av1_superres import stream

        streams["superres"] = stream(160, 96, denom=12, seed=4, speed=4,
                                     **{"enable-cdef": 1})
    return streams


def hostile_streams():
    """Truncations and byte flips of real streams (the port's own encoder's,
    and a palette, an intrabc, a 10-bit and a superres one where their
    writers are at hand), an intrabc vector outside its tile, garbage, and
    superres headers spliced to denominators and widths their tiles were
    not coded for (``test_torch_av1_superres.hostile_superres_streams``)."""
    data = avif_encode.encode_rgb(synth(96, 64, seed=2), 60)
    from imagekit_tpu_torch.codecs.avif_native import parse_container

    rng = np.random.default_rng(7)
    out = [b"", b"\x00", b"\x12\x00",
           bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
           intrabc_outside_tile()]
    streams = [parse_container(data).obu] + list(tool_streams().values())
    for stream in streams:
        out += [stream[:3], stream[:len(stream) // 2], stream[:-1]]
        for _ in range(24 if len(out) < 40 else 12):
            m = bytearray(stream)
            for i in rng.integers(0, len(m), 3):
                m[i] ^= int(rng.integers(1, 256))
            out.append(bytes(m))
    from tests.fixtures.make_avif_sources import _aom_lib

    if _aom_lib() is not None:
        from tests.test_torch_av1_superres import hostile_superres_streams

        out += hostile_superres_streams()
    return out


def test_hostile_streams_never_crash():
    for s in hostile_streams():
        try:
            y, _u, _v, info = av1_dec_abi.decode(s)
            assert y.shape == (info.height, info.width)
        except ValueError:
            pass


def test_intrabc_vector_outside_its_tile_is_refused():
    with pytest.raises(ValueError, match="outside its tile"):
        av1_dec_abi.decode(intrabc_outside_tile())


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
