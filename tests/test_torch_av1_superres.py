"""Superres in the port's AV1 decoder (``codecs/native/av1_decode.cpp``):
the upscaling process (spec 7.16) and loop restoration on the upscaled
frame, against libdav1d, byte for byte.

The streams are libaom's (``tests/fixtures/make_avif_sources.py::
encode_av1_libaom``: the system's ``libaom.so.3`` through ctypes, the
ALL_INTRA usage with a fixed superres denominator), since neither
Pillow's libavif nor the system's takes ``superres-mode``; libdav1d
(``dav1d_samples``) is the oracle, at each stream's own depth:

- every denominator 9-16; 4:0:0, 4:2:0, 4:2:2 and 4:4:4 at 8, 10 and 12
  bits; widths that round oddly and widths under 16 (the Min(16,
  UpscaledWidth) floor of the coded width); 1, 2 and 4 tile columns;
- Wiener, self-guided and switchable restoration (the frame header's
  types, read by ``HeaderReader``), CDEF on and off, the in-loop filters
  off (the tiles and the upscale alone), film grain on the upscaled
  frame, and a coded-lossless superres frame, which still reads and
  applies loop restoration (AllLossless needs FrameWidth ==
  UpscaledWidth);
- the decoder's threads (tiles, CDEF rows, the upscale's bands) do not
  change the planes; headers spliced to other denominators and widths
  answer ValueError (400) or decode, and never crash;
- one file each through ``decode_bytes``, ``/img`` and ``/upload`` against
  the reference app, and the committed superres fixtures of phase 27
  against their recorded digests.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch.codecs.native import av1_dec_abi
from tests.conftest import psnr
from tests.fixtures.make_avif_sources import (
    _aom_lib,
    av1_avif,
    dav1d_samples,
    encode_av1_libaom,
)
from tests.test_torch_av1_qm_grain import HeaderReader, _obus, _to_bytes
from tests.test_torch_av1_decode import obu as make_obu
from tests.test_torch_av1_screen_hbd import hbd_picture
from tests.test_torch_avif_sources import _upload
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import _decoded, _img, _serve, _url
from tests.test_torch_rgba_slice import _out_size

needs_libs = pytest.mark.skipif(
    not (ref_avif.decode_available() and _aom_lib() is not None),
    reason="libdav1d (the oracle) or libaom.so.3 (the writer) unavailable")
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "avif"


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


def photo_planes(w: int, h: int, depth: int, layout: str, seed: int):
    """``chip_smoke.synth_image``'s picture as BT.601 planes (4:2:0 or
    4:4:4): broad regions of unlike texture."""
    import chip_smoke
    from tests.fixtures.make_avif_sources import yuv_planes

    return yuv_planes(chip_smoke.synth_image(seed, w, h), depth, layout,
                      0.299, 0.114)


def stream(w: int, h: int, depth: int = 8, layout: str = "420",
           denom: int = 13, quantizer=30, seed: int = 0, speed: int = 6,
           photo: bool = False, **options) -> bytes:
    """libaom's superres still of :func:`hbd_picture`'s planes (of
    :func:`photo_planes`' with ``photo``)."""
    planes = (photo_planes if photo else hbd_picture)(w, h, depth, layout,
                                                     seed)
    obu = encode_av1_libaom(*planes, depth, layout, quantizer, denom, speed,
                            options)
    assert obu is not None, "libaom refused the stream"
    return obu


def header(obu: bytes):
    """(sequence fields, frame fields) of a stream, as HeaderReader reads
    them."""
    kinds = _obus(obu)
    seq = HeaderReader(next(p for k, p in kinds if k == 1)).seq()
    frame = HeaderReader(next(p for k, p in kinds if k == 6))
    frame.frame(seq)
    return seq, frame.info


def assert_equal(obu: bytes, what: str = "",
                 apply_grain: bool = True) -> av1_dec_abi.StreamInfo:
    """The port's planes of a bare stream equal libdav1d's at their own
    depth, and its u8 planes the reference's rounding of them."""
    want = dav1d_samples(obu, apply_grain)
    assert want is not None, f"libdav1d does not decode {what}"
    y, u, v, info = av1_dec_abi._decode_samples(obu, apply_grain=apply_grain)
    assert info.bitdepth == want[3], what
    for name, got, exp in zip("YUV", (y, u, v), want[:3]):
        if exp is None:
            assert got is None, (what, name)
            continue
        assert got.dtype == exp.dtype and got.shape == exp.shape, (what, name)
        diff = np.argwhere(got != exp)
        assert not len(diff), (what, name, len(diff), diff[0].tolist())
    if apply_grain:
        u8 = av1_dec_abi.decode(obu)
        for got, exp in zip(u8[:3], want[:3]):
            assert exp is None or np.array_equal(
                got, av1_dec_abi.to_8bit(exp, want[3]))
    return info


def coded_width(width: int, denom: int) -> int:
    """FrameWidth of superres_params (5.9.8) with libdav1d's and libaom's
    floor of Min(16, UpscaledWidth)."""
    return max((width * 8 + denom // 2) // denom, min(16, width))


# -- the upscale -----------------------------------------------------------------


@needs_libs
@pytest.mark.parametrize("denom", range(9, 17))
def test_every_denominator(denom):
    """Each SuperresDenom, with CDEF and loop restoration (speed 4)."""
    obu = stream(160, 96, denom=denom, seed=denom, speed=4,
                 **{"enable-cdef": 1})
    seq, frame = header(obu)
    assert seq["superres"] and frame["superres_denom"] == denom
    assert frame["frame_width"] == coded_width(160, denom)
    info = assert_equal(obu, f"denominator {denom}")
    assert (info.width, info.height, info.superres_denom) == (160, 96, denom)
    assert info.filters & av1_dec_abi.FILTER_CDEF


@needs_libs
@pytest.mark.parametrize("layout", ["400", "420", "422", "444"])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_layouts_and_depths(layout, depth):
    """Every chroma layout at every depth, at a width whose chroma planes
    round (171 -> a coded 124 at 11: chroma 62 upscaled to 86)."""
    obu = stream(171, 75, depth, layout, denom=11, seed=depth,
                 **{"enable-cdef": 1})
    info = assert_equal(obu, f"{depth}-bit {layout}")
    assert (info.bitdepth, info.mono) == (depth, layout == "400")
    assert header(obu)[1]["frame_width"] == 124


@needs_libs
@pytest.mark.parametrize("width, denom", [
    (12, 16), (15, 9), (16, 16), (20, 16), (31, 12), (33, 15), (97, 13),
    (333, 13), (333, 16)], ids=lambda v: str(v))
def test_widths_that_round(width, denom):
    """Coded widths that round, odd chroma widths, and widths under 16,
    where the coded width is floored at Min(16, UpscaledWidth) (so a frame
    of 12 uses superres at the width it has). 333 at 13 and 16 are where
    halving initialSubpelX's odd negative error by a shift, as libdav1d
    does, and not by a division, moves a chroma column's phase."""
    obu = stream(width, 40, layout="422" if width % 2 else "420",
                 denom=denom, seed=width, quantizer=20)
    assert header(obu)[1]["frame_width"] == coded_width(width, denom)
    info = assert_equal(obu, f"{width} at {denom}")
    assert info.width == width


@needs_libs
@pytest.mark.parametrize("log2_cols", [0, 1, 2])
def test_tile_columns(log2_cols):
    """1, 2 and 4 tile columns of the coded width: libaom upscales by
    tile column, libdav1d and the spec by whole rows."""
    obu = stream(1024, 96, 10, "444", denom=16, seed=log2_cols, speed=4,
                 **{"tile-columns": log2_cols, "enable-cdef": 1})
    assert_equal(obu, f"{1 << log2_cols} tile columns")


# -- the in-loop filters around it --------------------------------------------------

#: a recipe (quantizer, speed, options) that makes libaom code each
#: restoration type (the header's FrameRestorationType of some plane) in
#: a 4:2:0 frame of 256 x 128 at 12
LR_KINDS = {
    "wiener": (1, (10, 4, {})),
    "self-guided": (2, (50, 4, {})),
    "switchable": (3, ((0, 1), 2, {"cq-level": 0, "photo": True})),
}


@needs_libs
@pytest.mark.parametrize("kind", sorted(LR_KINDS))
def test_restoration_types(kind):
    """Restoration's stripes read the upscaled CDEF output and, beyond
    their edges, the upscaled deblocked frame; the units' columns map to
    superblocks through SuperresDenom (5.11.57)."""
    want, (q, speed, options) = LR_KINDS[kind]
    obu = stream(256, 128, denom=12, quantizer=q, seed=31, speed=speed,
                 **{"enable-cdef": 1, **options})
    assert want in header(obu)[1]["lr_types"], kind
    assert assert_equal(obu, kind).filters & av1_dec_abi.FILTER_LR


@needs_libs
@pytest.mark.parametrize("case", ["cdef", "no cdef", "filters off"])
def test_cdef_on_and_off(case):
    """CDEF on (its upscaled output is the picture when restoration is
    off), off, and every in-loop filter off: the tiles and the upscale
    alone."""
    options = {"enable-cdef": int(case == "cdef"),
               "enable-restoration": int(case == "no cdef")}
    q = 2 if case == "filters off" else 36
    obu = stream(144, 80, denom=15, quantizer=q, seed=8, speed=4, **options)
    info = assert_equal(obu, case)
    assert bool(info.filters & av1_dec_abi.FILTER_CDEF) == (case == "cdef")
    if case == "filters off":
        assert info.filters == 0


@needs_libs
@pytest.mark.parametrize("depth, layout, vector", [(8, "420", 4),
                                                   (10, "444", 10)])
def test_film_grain_on_the_upscaled_frame(depth, layout, vector):
    """Grain is synthesized over the upscaled width; with libdav1d's
    apply_grain off the reconstruction equals the port's."""
    obu = stream(120, 64, depth, layout, denom=12, seed=vector,
                 **{"film-grain-test": vector})
    info = assert_equal(obu, f"grain vector {vector}")
    assert info.film_grain and info.superres_denom == 12
    assert_equal(obu, "without its grain", apply_grain=False)
    with_g = dav1d_samples(obu)[0]
    assert not np.array_equal(with_g, dav1d_samples(obu, False)[0])


@needs_libs
def test_coded_lossless_superres_reads_restoration():
    """base_q_idx 0 with superres is coded lossless but not all lossless:
    the frame has no deblocking or CDEF params, and still reads loop
    restoration's, and applies them on the upscaled frame. (libaom asserts
    on a lossless request with superres; quantizer bounds (0, 1) with
    cq-level 0 code the frame at base_q_idx 0 all the same.)"""
    obu = stream(200, 120, denom=12, quantizer=(0, 1), seed=5, speed=2,
                 **{"cq-level": 0})
    frame = header(obu)[1]
    assert frame["coded_lossless"] and frame["base_q_idx"] == 0
    assert any(frame["lr_types"])
    info = assert_equal(obu, "coded lossless")
    assert info.filters == av1_dec_abi.FILTER_LR


@needs_libs
def test_threads_do_not_change_the_planes():
    obu = stream(1024, 192, denom=11, seed=3, speed=4,
                 **{"tile-columns": 2, "enable-cdef": 1})
    many = av1_dec_abi.decode_samples(obu)
    av1_dec_abi._set_threads(1)
    try:
        one = av1_dec_abi.decode_samples(obu)
    finally:
        av1_dec_abi._set_threads(0)
    for a, b in zip(one[:3], many[:3]):
        assert np.array_equal(a, b)


# -- hostile headers ---------------------------------------------------------------


def respliced(obu: bytes, denom=None, width=None) -> bytes:
    """A superres stream with its frame header's coded_denom set to
    ``denom`` - 9, or its sequence header's frame width to ``width``: the
    tiles stay those of the coded width they were written for."""
    out = b""
    seq = None
    for kind, payload in _obus(obu):
        r = HeaderReader(payload)
        if kind == 1:
            seq = r.seq()
            if width is not None:
                # profile, still, reduced, level (10 bits), the width's
                # bits less 1 (4), the height's (4), then the width: 16
                # bits of it here
                wb = seq["width_bits"]
                bits = (r.bits[:10] + "1111" + r.bits[14:18]
                        + format(width - 1, "016b") + r.bits[18 + wb:])
                payload = _to_bytes(bits)
        elif kind == 6 and denom is not None:
            r.frame(seq)
            at = r.info["denom_bit"]
            bits = r.bits[:at] + format(denom - 9, "03b") + r.bits[at + 3:]
            payload = bytes(_to_bytes(bits)[:len(payload)])
        out += make_obu(kind, payload)
    return out


def hostile_superres_streams() -> list:
    """Superres streams whose headers no longer fit their tiles: every
    other denominator, and upscaled widths from 1 to far past the coded
    one (the last past the decoder's frame area limit)."""
    obu = stream(96, 48, denom=12, seed=11, speed=4, **{"enable-cdef": 1})
    out = [respliced(obu, denom=d) for d in range(9, 17) if d != 12]
    out += [respliced(obu, width=w) for w in (1, 15, 17, 64, 200, 65535)]
    return out


@needs_libs
def test_hostile_superres_headers_answer_400_or_decode():
    """A denominator or width the tiles were not coded for: ValueError
    (the app's 400) where libdav1d refuses the stream, else planes of the
    header's size; never a crash."""
    for s in hostile_superres_streams():
        try:
            y, _u, _v, info = av1_dec_abi.decode_samples(s)
        except ValueError:
            continue
        assert y.shape == (info.height, info.width)
        if dav1d_samples(s) is None:
            pytest.fail("libdav1d refuses a stream the port decodes")


# -- through the entry points ---------------------------------------------------


def superres_file(layout: str = "420") -> bytes:
    obu = stream(160, 96, 8, layout, denom=14, seed=21, speed=4,
                 **{"enable-cdef": 1})
    return av1_avif(obu, 160, 96, 8, layout)


@needs_libs
@pytest.mark.parametrize("layout", ["420", "444"])
def test_decode_bytes_as_the_reference(layout):
    data = superres_file(layout)
    want, _ = ref_codecs.decode_bytes(data)
    got, fmt = port_codecs.decode_bytes(data, device="cpu")
    assert fmt == port_codecs.SourceFormat.avif
    assert np.array_equal(got, want)


@needs_libs
def test_img_and_upload_as_the_reference_app(monkeypatch, tmp_path):
    """``/img`` and ``/upload`` at w=64 to WebP, JPEG and AVIF: the same
    statuses, types and bodies through both apps (JPEG within 45 dB, as
    ``test_torch_avif_sources.py`` holds its AVIF sources)."""
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    data = superres_file()

    async def fn(client):
        outs = []
        for fmt in ("webp", "jpeg", "avif"):
            outs.append(await _img(client, url=_url("x"), w=64, f=fmt))
            outs.append(await _upload(client, data, w=64, f=fmt))
        return outs

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        if pct == "image/jpeg":
            assert _out_size(pb) == _out_size(rb)
            assert psnr(_decoded(pb), _decoded(rb)) >= 45.0
        else:
            assert pb == rb


# -- the committed fixtures ----------------------------------------------------------


def _superres_fixtures() -> dict:
    table = json.loads((FIXTURES / "avif_planes.json").read_text())
    return {k: v for k, v in table.items() if v.get("superres_denom", 8) != 8}


@pytest.mark.parametrize("name", sorted(_superres_fixtures()))
def test_committed_superres_fixtures(name):
    """Phase 27's superres files: the header's denominator is the one
    ``avif_planes.json`` records, the coded width is the upscaled one's by
    it, and the port's planes (raw samples too) give the recorded libdav1d
    digests."""
    entry = _superres_fixtures()[name]
    info = ref_avif.parse_container((FIXTURES / entry["file"]).read_bytes())
    head = av1_dec_abi.probe(info.obu)
    assert head.superres_denom == entry["superres_denom"]
    assert header(info.obu)[1]["frame_width"] == coded_width(
        entry["width"], entry["superres_denom"])
    ours = hashlib.sha256()
    for p in av1_dec_abi.decode(info.obu)[:3]:
        ours.update(p.tobytes())
    assert ours.hexdigest() == entry["sha256"]
    if "sha256_samples" in entry:
        raw = hashlib.sha256()
        for p in av1_dec_abi.decode_samples(info.obu)[:3]:
            raw.update(p.astype("<u2").tobytes())
        assert raw.hexdigest() == entry["sha256_samples"]
