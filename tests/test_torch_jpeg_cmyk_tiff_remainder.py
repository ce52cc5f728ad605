"""CMYK JPEGs in every sampling, lossless CMYK, the last JPEG TIFF layouts
and CCITT's uncompressed-mode flag in the port, on the CPU, and the six
answers that differed from the reference's before them.

The reference decodes these sources with Pillow: libjpeg-turbo for JPEGs,
fed 64 KiB at a time by ``ImageFile.load``, and libtiff for TIFFs, which
hands libjpeg each JPEG segment whole and then a fake EOI. The port
answers as that pair does:

- Repairs (each with an HTTP parity test, ``/img`` at w=64 and unresized
  and ``/upload`` at w=64 and unresized, through both apps):
  1. an arithmetic scan that needs a byte past the blocks Pillow has fed
     is "broken data stream" (libjpeg's QM decoder cannot suspend), at the
     exact boundary Pillow has;
  2. a JPEG cut inside its scan is Pillow's "image file is truncated (n
     bytes not processed)", n to the byte (``jpeg4_decode.cpp``'s ``Lj``
     follows libjpeg's bit reader and Pillow's feed), below and above 64
     KiB, baseline and progressive;
  3. a JPEG without its EOI is that message where the reference decodes
     with Pillow (no resize, ``/upload``), and served with a resize;
  4. a JPEG TIFF segment whose data ends early decodes as libjpeg decodes
     it under libtiff's fake EOI;
  5. a CCITT row whose runs pass its width is cut as libtiff cuts it;
  6. an EOB run past a progressive scan's last block ends with the scan,
     and a restart ends one.
- Layouts (pixels against the JAX package's ``decode_bytes``, i.e.
  Pillow): CCITT files that flag uncompressed mode (exact) and a G4 row
  that reaches its extension (exact); arithmetic-coded JPEG TIFF segments;
  CMYK and YCCK JPEGs at ratios of 3 and 4, a first component below the
  largest factors and chroma of at most two samples (>= 40 dB, |d| <= 12;
  against the JAX package's IDCT and K3-semantic resize with libjpeg's
  stacks, +-2 on at most 0.1%; two K3 launches); lossless CMYK (exact; K3
  twice where the components are sampled differently, never otherwise);
  planar JPEG TIFF pages whose strips straddle blocks or whose tables
  differ, planar gray + alpha (its alpha 0), old-style pages of one sample
  or of several strips, YCbCrSubSampling 4 (>= 40 dB, |d| <= 12).
- What Pillow refuses answers 400 in both: YCbCrSubSampling (4, 4) (more
  than 10 blocks an MCU), a segment coded narrower than its place.
- Recorded, not matched: a segment coded shorter than its place is served
  by the reference with the rows libjpeg does not write left as Pillow's
  buffer held them (the strip before's); the port answers 400.
"""

import io
import re
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu_torch import codecs
from imagekit_tpu_torch.codecs import jpeg, tiff
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.errors import (
    NotPortedError,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.ops import color, dct
from tests.fixtures import jpeg_arith_writer, jpeg_lossless_writer
from tests.fixtures import jpeg_writer
from tests.test_torch_jpeg_arith_lossless import _picture
from tests.test_torch_jpeg_sampling import _both, _photo
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_fallbacks import (
    BLACK,
    SMALL_PAGE,
    WHITE,
    _bits,
    _fax,
    _pil_tiff,
)
from tests.test_torch_pillow_sources import (
    _decoded,
    _jax_planes,
    _save,
    _serve,
    psnr,
)
from tests.test_torch_tiff_jpeg import (
    _img_rgb,
    _old_style_gray,
    _planar_gray_with_alpha,
    _strips,
)
from tests.test_torch_tiff_remainder import (
    _jfif,
    _planar,
    _sos_end,
    _tables_of,
    _tiff,
)

MAX_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


def _pillow_error(data: bytes):
    """Pillow's message where its decode fails, else None."""
    try:
        Image.open(io.BytesIO(data)).load()
    except OSError as e:
        return str(e)
    return None


def _both_apps(tmp_path, data):
    """``/img`` at w=64 and unresized, ``/upload`` at w=64 and unresized,
    through the reference's app and the port's."""
    ref = _serve(tmp_path, "ref", {"x": data}, lambda c: _both(c, data))
    port = _serve(tmp_path, "port", {"x": data}, lambda c: _both(c, data))
    return ref, port


def _assert_parity(ref, port, statuses=None):
    """Statuses and content types equal; bodies equal where they are 400s
    (a JPEG TIFF that libtiff refuses is Pillow's "decoder error -2" on
    ``/upload`` in both); the outputs of 200s within 38 dB of each
    other."""
    assert [p[:2] for p in port] == [r[:2] for r in ref]
    if statuses is not None:
        assert [p[0] for p in port] == statuses
    for (ps, _, pbody), (_, _, rbody) in zip(port, ref):
        if ps == 200:
            assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0
        else:
            assert pbody == rbody


def _band(got, want, db=40.0, most=12):
    assert got.shape == want.shape
    assert psnr(got, want) >= db
    assert np.abs(got.astype(int) - want).max() <= most


# -- 1. arithmetic scans past Pillow's read block -------------------------------------


def _arith(size=(96, 64), samp=((2, 2), (1, 1), (1, 1)), seed=4, **kw):
    planes, tabs, tq = jpeg_writer.coefficients(_photo(*size, seed), 85, samp)
    return jpeg_arith_writer.write(planes, tabs, *size, samp, tq, **kw)


def _app_ahead(data: bytes, size: int) -> bytes:
    """``data`` with an APP1 segment of ``size`` bytes (marker included)
    after its SOI."""
    return (data[:2] + b"\xff\xe1" + (size - 2).to_bytes(2, "big")
            + bytes(size - 4) + data[2:])


def _flip(data: bytes) -> int:
    """An APP1 size ahead of ``data`` at which Pillow's decode starts to
    fail, one less decoding: a scan then needs a byte past the first 64
    KiB. Between the file ending inside the block and its first scan's
    header ending at the block's last byte (the marker reader suspends for
    a header, so one that passes the block moves it)."""
    sos = data.index(b"\xff\xda")
    sos_end = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    lo = 65536 - len(data) - 200  # decodes
    hi = 65536 - sos_end - 1      # fails
    assert _pillow_error(_app_ahead(data, lo)) is None
    assert "broken data stream" in _pillow_error(_app_ahead(data, hi))
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _pillow_error(_app_ahead(data, mid)) is None:
            lo = mid
        else:
            hi = mid
    return hi


WINDOW_FILES = {
    "sof9_420": lambda: _arith(),
    "sof9_444_rst": lambda: _arith(samp=((1, 1),) * 3, restart=3),
    "sof10_420": lambda: _arith(progressive=True),
}


@pytest.mark.parametrize("offset", [-3, -1, 0, 2])
@pytest.mark.parametrize("name", sorted(WINDOW_FILES))
def test_arithmetic_scan_at_pillows_read_block(name, offset):
    """A small arithmetic file behind a large APP1, its scans ending just
    before and just after the first 64 KiB: where Pillow decodes it, the
    port does, to its planes; where Pillow's QM decoder needs a byte past
    the block (JERR_CANT_SUSPEND), the port answers "broken data stream",
    a SourceDecodeError (the reference meets it at its fetch stage)."""
    base = WINDOW_FILES[name]()
    data = _app_ahead(base, _flip(base) + offset)
    pil = _pillow_error(data)
    if offset < 0:
        assert pil is None
        hdr, planes, _ = jpeg.decode_to_coefficients(data)
        for a, b in zip(planes, jpeg_abi.decode4(loader.load(), base)[1]):
            assert np.array_equal(a, b)
        return
    assert "broken data stream" in pil
    with pytest.raises(SourceDecodeError, match="broken data stream"):
        jpeg.decode_to_coefficients(data)
    with pytest.raises(jpeg_abi.NativeJpegError) as e:
        jpeg_abi.decode4(loader.load(), data, jpeg_abi.PILLOW_BLOCK)
    assert e.value.code == -9


@pytest.mark.parametrize("name", ["sof9_420_app", "sof10_420_app"])
def test_http_arithmetic_past_the_read_block_answers_as_the_reference(
        tmp_path, name):
    base = WINDOW_FILES[name[:-4]]()
    data = _app_ahead(base, _flip(base) + 1)
    ref, port = _both_apps(tmp_path, data)
    _assert_parity(ref, port, [400] * 4)
    assert b"broken data stream" in port[2][2]


# -- 2. and 3. JPEGs cut inside a scan, and without an EOI ---------------------------


def _pil_jpeg(size, quality, progressive, seed=3, mode="RGB") -> bytes:
    img = Image.fromarray(_photo(*size, seed)).convert(mode)
    return _save(img, "JPEG", quality=quality, progressive=progressive,
                 subsampling=2)


#: Pillow's 4:2:0 JPEGs, below and above 64 KiB
CUT_FILES = {
    "baseline_small": lambda: _pil_jpeg((160, 120), 90, False),
    "progressive_small": lambda: _pil_jpeg((160, 120), 90, True),
    "baseline_large": lambda: _pil_jpeg((900, 700), 95, False),
    "progressive_large": lambda: _pil_jpeg((900, 700), 95, True),
}
_CUT_CACHE = {}


def _cut_file(name) -> bytes:
    if name not in _CUT_CACHE:
        _CUT_CACHE[name] = CUT_FILES[name]()
    return _CUT_CACHE[name]


def _cuts(data: bytes):
    """Cut points inside the scans: a spread over the data, and around the
    64 KiB Pillow's first read holds where the file passes it."""
    sos = data.index(b"\xff\xda")
    points = list(np.linspace(sos + 40, len(data) - 40, 6).astype(int))
    if len(data) > 70000:
        points += [65536 - 3, 65536, 65536 + 5]
    return points


@pytest.mark.parametrize("name,at", [
    (name, at) for name in sorted(CUT_FILES)
    for at in range(9 if name.endswith("large") else 6)])
def test_cut_inside_a_scan_is_pillows_truncated_message(name, at):
    """Pillow's "image file is truncated (n bytes not processed)", n to the
    byte: the port's decode raises that message (libjpeg's reader fed as
    Pillow feeds it), a TransformError for the frames the pinned decoder
    takes."""
    data = _cut_file(name)
    cut = data[:_cuts(data)[at]]
    want = _pillow_error(cut)
    assert re.fullmatch(r"image file is truncated \(\d+ bytes not "
                        r"processed\)", want)
    with pytest.raises(TransformError) as e:
        jpeg.decode_to_coefficients(cut)
    assert e.value.message == want
    assert not isinstance(e.value, (NotPortedError, SourceDecodeError))


NO_EOI = {
    "baseline_420": lambda: _pil_jpeg((160, 120), 90, False)[:-2],
    "progressive_420": lambda: _pil_jpeg((160, 120), 90, True)[:-2],
    "cmyk_baseline": lambda: _pil_jpeg((160, 120), 90, False,
                                       mode="CMYK")[:-2],
    "cmyk_progressive": lambda: _pil_jpeg((160, 120), 90, True,
                                          mode="CMYK")[:-2],
}


@pytest.mark.parametrize("name", sorted(NO_EOI))
def test_no_eoi_is_pillows_truncated_message(name):
    """A file without its EOI: libjpeg's bit reader, reading ahead for 57
    bits at a time, runs out of data before the last MCUs decode (a frame
    of several scans needs the EOI besides), so Pillow's decode fails with
    its count; so does the port's, a SourceDecodeError for a CMYK frame."""
    data = NO_EOI[name]()
    want = _pillow_error(data)
    assert want.startswith("image file is truncated")
    raised = SourceDecodeError if name.startswith("cmyk") else TransformError
    with pytest.raises(raised) as e:
        jpeg.decode_to_coefficients(data)
    assert e.value.message == want


def test_libjpeg_reader_decodes_what_it_reads_whole():
    """Where the data is whole, the libjpeg-faithful reader's planes are
    the decoders' own, baseline and progressive, with restarts."""
    lib = loader.load()
    for data in (_pil_jpeg((96, 64), 90, False), _pil_jpeg((96, 64), 90, True),
                 _save(Image.fromarray(_photo(96, 64, 2)), "JPEG",
                       quality=80, progressive=True,
                       restart_marker_blocks=3)):
        _, got, qt, unread = jpeg_abi.decode_libjpeg(lib, data,
                                                     jpeg_abi.PILLOW_BLOCK)
        assert unread is None
        _, want, wq = jpeg_abi.decode(lib, data)
        assert np.array_equal(qt, wq)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


HTTP_CUT = {
    "baseline_cut": lambda: _pil_jpeg((160, 120), 90, False)[:2600],
    "progressive_cut": lambda: _pil_jpeg((160, 120), 90, True)[:2200],
    "cmyk_cut": lambda: (lambda d: d[:len(d) * 2 // 3])(
        _pil_jpeg((160, 120), 90, False, mode="CMYK")),
    **{f"no_eoi_{k}": v for k, v in NO_EOI.items()},
}


@pytest.mark.parametrize("name", sorted(HTTP_CUT))
def test_http_cut_and_no_eoi_answer_as_the_reference(tmp_path, name):
    """Statuses and bodies equal in both apps. A 4:2:0 file without its
    EOI is served with a resize (the batched JPEG head's decoder needs no
    EOI, in both apps) and is Pillow's 400 unresized and on ``/upload``
    without one; everything else is 400 on every path."""
    data = HTTP_CUT[name]()
    ref, port = _both_apps(tmp_path, data)
    want = ([200, 400, 200, 400] if name == "no_eoi_baseline_420"
            else [400] * 4)
    _assert_parity(ref, port, want)


# -- 4. a JPEG TIFF segment whose data ends early --------------------------------------


def _cut_strip(fraction=0.5, arithmetic=False) -> bytes:
    tags, _, segs = _strips()
    if arithmetic:
        tags, segs = _arith_strips()
    segs[1] = segs[1][:int(len(segs[1]) * fraction)]
    return chip_smoke.tiff_file(64, 72, tags, segs)


@pytest.mark.parametrize("fraction", [0.5, 0.9])
def test_http_tiff_segment_cut_short_answers_as_the_reference(tmp_path,
                                                              fraction):
    ref, port = _both_apps(tmp_path, _cut_strip(fraction))
    _assert_parity(ref, port, [200] * 4)


def test_tiff_segment_cut_in_its_header_stays_refused():
    """A segment cut before its scan: libjpeg has no frame to decode, and
    Pillow refuses the page ("decoder error -2"); so does the port."""
    data = _cut_strip(0.3)
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


def _short_segments(first_full: bool) -> bytes:
    """A 64x72 YCbCr page of 16-row strips whose strips after the first
    are coded 8 rows high (the first too unless ``first_full``)."""
    tags, _, segs = _strips()
    small = chip_smoke.split_jpeg(_save(
        Image.fromarray(_img_rgb((64, 48))[:8]), "JPEG", quality=85,
        subsampling=2), ())[1]
    chunks = [segs[0] if first_full else small] + [small] * 4
    return chip_smoke.tiff_file(64, 72, tags, chunks)


def test_segment_shorter_than_its_place_is_recorded_not_matched():
    """Recorded, not matched: libtiff decodes a segment coded shorter than
    its strip into the rows it has and leaves the others, and Pillow
    serves them as its buffer held them, here the rows the strip before
    left there, so no pixels of the file's own can be pinned; the port
    answers 400."""
    data = _short_segments(first_full=True)
    got = ref_codecs.decode_bytes(data)[0]
    assert np.array_equal(got[24:32], got[8:16])  # strip 0's rows again
    with pytest.raises(TransformError, match="its place") as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)


def test_http_segment_narrower_than_its_place_answers_as_the_reference(
        tmp_path):
    """A segment coded narrower than its place: Pillow's read fails
    ("decoder error -2"), 400 in both apps, the fetch stage's body."""
    tags, _, _ = _strips()
    narrow = chip_smoke.split_jpeg(_save(
        Image.fromarray(_img_rgb((64, 48))[:16, :32]), "JPEG", quality=85,
        subsampling=2), ())[1]
    data = chip_smoke.tiff_file(64, 72, {k: v for k, v in tags.items()
                                         if k != 347}, [narrow] * 5)
    ref, port = _both_apps(tmp_path, data)
    _assert_parity(ref, port, [400] * 4)


# -- 5. CCITT rows that overshoot; 6. EOB runs -------------------------------------------


OVERSHOOT = {
    "mh": lambda: _fax(_bits(WHITE[64][0], WHITE[4][0]), 2),
    "g4_horizontal": lambda: _fax(_bits(
        "001", WHITE[4][0], BLACK[3][0], "001", WHITE[4][0], BLACK[3][0],
        "1", "1", "1"), 4, h=2),
    "g4_vertical": lambda: _fax(_bits(
        "001", WHITE[4][0], BLACK[3][0], "1", "1", "0000011", "000011"), 4,
        h=2),
}


@pytest.mark.parametrize("name", sorted(OVERSHOOT))
def test_ccitt_rows_that_overshoot_are_libtiffs(tmp_path, name):
    """The runs past the row dropped and the row ended white, as libtiff's
    CLEANUP_RUNS ends it, the rows after decoding on: Pillow's pixels
    exactly, and the same answers from both apps."""
    data = OVERSHOOT[name]()
    want = ref_codecs.decode_bytes(data)[0]
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], want)
    if name == "g4_horizontal":
        ref, port = _both_apps(tmp_path, data)
        _assert_parity(ref, port, [200] * 4)


def _sof2(scans, dri=0, size=16) -> bytes:
    """A three-component progressive frame (every component 1x1, q 40), the
    DC table 00 -> category 0 and the AC table 00 EOB, 01 EOB run of 2^14,
    10 EOB run of 2^2 and 2 bits, 110 value 1 of size 1 (run 0), then
    ``scans`` (header, entropy bytes)."""
    q = b"\x00" + bytes([40] * 64)
    sof = bytes([8, 0, size, 0, size, 3]) + b"".join(
        bytes([c, 0x11, 0]) for c in (1, 2, 3))

    def table(tc_th, counts, symbols):
        c = [0] * 16
        for length, n in counts:
            c[length - 1] = n
        return bytes([tc_th]) + bytes(c) + bytes(symbols)

    dht = table(0x00, [(2, 1)], [0]) + table(
        0x10, [(2, 3), (3, 1)], [0x00, 0xE0, 0x20, 0x01])
    out = (b"\xff\xd8" + b"\xff\xdb" + struct.pack(">H", 2 + len(q)) + q
           + b"\xff\xc2" + struct.pack(">H", 2 + len(sof)) + sof
           + b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht)
    if dri:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", dri)
    for header, data in scans:
        out += (b"\xff\xda" + struct.pack(">H", 2 + len(header)) + header
                + data)
    return out + b"\xff\xd9"


_DC3 = (bytes([3, 1, 0, 2, 0, 3, 0, 0, 0, 0]), bytes(8))


def _ac(*codes, band=(1, 1)):
    return (bytes([1, 1, 0, band[0], band[1], 0]),
            _bits(*codes).replace(b"\xff", b"\xff\x00"))


EOB_RUNS = {
    # four blocks of coefficient 1 at k=1: a value, then an EOB run of
    # 2^2 + 3 = 7 blocks where 3 are left
    "past_the_scan": lambda: _sof2([_DC3, _ac("110", "1", "10", "11")]),
    # restarts every 2 blocks: an EOB run of 4 from block 0, cut by the
    # restart; blocks 2 and 3 then take their own values
    "across_a_restart": lambda: _sof2([_DC3, (
        bytes([1, 1, 0, 1, 1, 0]),
        _bits("10", "00") + b"\xff\xd0" + _bits("110", "1", "110", "1"))],
        dri=2),
}


@pytest.mark.parametrize("name", sorted(EOB_RUNS))
def test_eob_runs_are_libjpegs(tmp_path, name):
    """An EOB run past a progressive scan's last block ends with the scan,
    and a restart marker ends a run (libjpeg's process_restart): Pillow's
    pixels within the JPEG pixel decode's band, and the same answers from
    both apps (the pinned decoder refuses the restart case; the port then
    takes libjpeg's reading)."""
    data = EOB_RUNS[name]()
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    _band(got, want)
    assert want.std() > 0  # the blocks hold values, not only the run
    ref, port = _both_apps(tmp_path, data)
    _assert_parity(ref, port, [200] * 4)


# -- CCITT uncompressed mode ------------------------------------------------------------


UNCOMPRESSED_FLAG = {
    "g3_1d": lambda: _pil_tiff(SMALL_PAGE, "group3", tiffinfo={292: 2}),
    "g3_2d": lambda: _pil_tiff(SMALL_PAGE, "group3", tiffinfo={292: 3}),
    "g3_2d_fill": lambda: _pil_tiff(SMALL_PAGE, "group3",
                                    tiffinfo={292: 7}),
    "g4": lambda: _pil_tiff(SMALL_PAGE, "group4", tiffinfo={293: 2}),
    "mh": lambda: _pil_tiff(SMALL_PAGE, "tiff_ccitt", tiffinfo={292: 2}),
    # a G4 row that reaches the extension: the row ends white, the next
    # rows decode from the bits after its seven
    "g4_extension_then_rows": lambda: _fax(_bits(
        "001", WHITE[4][0], BLACK[3][0], "0000001", "111", "1", "1", "1"),
        4, w=16, h=3),
    # the same after a pass: the colour at a0 for the row's width past a0,
    # then the other
    "g4_extension_after_a_pass": lambda: _fax(_bits(
        "001", WHITE[4][0], BLACK[3][0], "1", "1", "1", "0001", "0000001"),
        4, w=16, h=2),
}


@pytest.mark.parametrize("name", sorted(UNCOMPRESSED_FLAG))
def test_ccitt_uncompressed_mode_is_libtiffs(name):
    """T4Options or T6Options bit 1 (uncompressed mode) no longer refuses
    the file from its tag: files that flag it and never use it, and rows
    that reach an extension (which libtiff does not decode: it ends the
    row), decode to Pillow's pixels exactly."""
    data = UNCOMPRESSED_FLAG[name]()
    if name.startswith("g4_extension"):
        data = chip_smoke.tiff_with_tag(data, 293, 2)  # T6Options
    assert tiff.parse(data)[:2] == ref_codecs.decode_bytes(data)[0].shape[
        1::-1]
    want = ref_codecs.decode_bytes(data)[0]
    assert np.array_equal(codecs.decode_bytes(data, device="cpu")[0], want)


def test_http_ccitt_uncompressed_flag_serves_as_the_reference(tmp_path):
    ref, port = _both_apps(tmp_path, UNCOMPRESSED_FLAG["g4"]())
    _assert_parity(ref, port, [200] * 4)


# -- arithmetic-coded JPEG TIFF segments ------------------------------------------------


def _arith_strips(samp=((2, 2), (1, 1), (1, 1)), size=(64, 72), rows=16):
    """A YCbCr page in strips of ``rows`` rows, each strip arithmetic-coded
    by the numpy writer (its own tables in it): (tags, segments)."""
    img = _img_rgb(size)
    segs = []
    for y in range(0, size[1], rows):
        part = img[y:y + rows]
        planes, tabs, tq = jpeg_writer.coefficients(part, 85, samp)
        segs.append(jpeg_arith_writer.write(planes, tabs, size[0],
                                            part.shape[0], samp, tq))
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [rows]), 284: (3, [1]), 530: (3, list(samp[0]))}
    return tags, segs


ARITH_TIFFS = {
    "strips_420": lambda: chip_smoke.tiff_file(64, 72, *_arith_strips()),
    "strips_420_one_cut": lambda: _cut_strip(0.6, arithmetic=True),
    "huffman_bits_behind_sof9": lambda: chip_smoke.tiff_file(
        64, 72, _strips()[0], [s.replace(b"\xff\xc0", b"\xff\xc9", 1)
                               for s in _strips()[2]]),
}


@pytest.mark.parametrize("name", sorted(ARITH_TIFFS))
def test_arithmetic_tiff_segments_decode_as_pillow(name):
    """Segments the pinned decoder refuses with -3 for arithmetic coding go
    through the port's QM decoder in the same two native calls a page; no
    64 KiB window applies (libtiff hands libjpeg the strip whole), and a
    segment cut short gets zeros after libtiff's fake EOI, as libjpeg
    reads them: within the JPEG TIFF band of Pillow's pixels."""
    data = ARITH_TIFFS[name]()
    _band(codecs.decode_bytes(data, device="cpu")[0],
          ref_codecs.decode_bytes(data)[0])


def test_http_arithmetic_tiff_serves_as_the_reference(tmp_path):
    ref, port = _both_apps(tmp_path, ARITH_TIFFS["strips_420"]())
    _assert_parity(ref, port, [200] * 4)


# -- CMYK and YCCK JPEGs in every sampling -----------------------------------------------


def _cmyk_file(samp, size=(77, 53), adobe=0, seed=3, progressive=False):
    """A four-component JPEG (``jpeg_writer``, or Pillow's progressive
    save where ``progressive``) of a picture's R, G, B and G as C, M, Y, K,
    in ``samp``; Adobe transform ``adobe`` (2: YCCK)."""
    img = _photo(*size, seed)
    four = np.dstack([img, img[..., 1]])
    planes, tabs, tq = jpeg_writer.coefficients(four, 85, samp, colour="raw")
    return jpeg_writer.write(planes, tabs, *size, samp, tq,
                             adobe_transform=adobe)


CMYK_SAMPLINGS = {
    "411_like": ((4, 1), (1, 1), (1, 1), (4, 1)),
    "ratio_3": ((3, 1), (1, 1), (1, 1), (3, 1)),
    "ratio_3_vertical": ((1, 3), (1, 1), (1, 1), (1, 1)),
    "first_below": ((1, 1), (2, 2), (2, 2), (1, 1)),
    "ratios_4_and_2": ((4, 1), (2, 1), (1, 1), (2, 1)),
    "420_k_full": ((2, 2), (1, 1), (1, 1), (2, 2)),
}
CMYK_CASES = [(name, adobe, size) for name in CMYK_SAMPLINGS
              for adobe in (0, 2) for size in ((77, 53), (3, 20))]


def _cmyk_id(case):
    name, adobe, (w, h) = case
    return f"{name}-{'ycck' if adobe else 'cmyk'}-{w}x{h}"


def _count_k3(monkeypatch):
    """K3 launches: calls of its entry (its plain version on the CPU)."""
    calls = []
    entry = dct.resize_planes_u8

    def counted(*a, **k):
        calls.append(1)
        return entry(*a, **k)

    monkeypatch.setattr(dct, "resize_planes_u8", counted)
    return calls


@pytest.mark.parametrize("case", CMYK_CASES, ids=_cmyk_id)
def test_cmyk_samplings_decode_as_pillow(case, monkeypatch):
    """Each component's stacks by libjpeg's upsampling (replication at
    ratios of 3 and 4, and for chroma of at most two samples at a ratio of
    2), two K3 launches (C, M and Y, then K), then the CMYK or YCCK colour
    step: within the JPEG pixel decode's band of Pillow's pixels."""
    name, adobe, size = case
    data = _cmyk_file(CMYK_SAMPLINGS[name], size, adobe)
    calls = _count_k3(monkeypatch)
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert len(calls) == 2
    _band(got, ref_codecs.decode_bytes(data)[0])


@pytest.mark.parametrize("name", sorted(CMYK_SAMPLINGS))
def test_cmyk_planes_match_jax_under_k3(name):
    """The four planes against the JAX package's IDCT and K3-semantic
    resize with the same libjpeg stacks: +-2 on at most 0.1%."""
    decoded = jpeg.decode_to_coefficients(
        _cmyk_file(CMYK_SAMPLINGS[name], (77, 53)))
    want = _jax_planes(decoded)
    got = dct.four_component_planes(decoded, "cpu")
    for g, w in zip(got, want):
        d = np.abs(g.numpy().astype(int) - w.astype(int))
        assert g.shape == w.shape and d.max() <= 2
        assert (d > 0).mean() <= MAX_SHARE


def test_cmyk_over_ten_blocks_is_refused_as_pillow_refuses_it():
    """A four-component frame of more than 10 blocks an MCU in one scan:
    libjpeg's "broken data stream" in both."""
    data = _cmyk_file(((1, 1), (2, 2), (2, 2), (2, 2)))
    assert "broken data stream" in _pillow_error(data)
    with pytest.raises(SourceDecodeError, match="broken data stream"):
        jpeg.decode_to_coefficients(data)


@pytest.mark.parametrize("name", ["411_like", "ratio_3"])
def test_http_cmyk_samplings_serve_as_the_reference(tmp_path, name):
    ref, port = _both_apps(tmp_path, _cmyk_file(CMYK_SAMPLINGS[name],
                                                (96, 64)))
    _assert_parity(ref, port, [200] * 4)


# -- lossless CMYK ----------------------------------------------------------------------


LOSSLESS_CMYK = {
    "alike": [(1, 1)] * 4,
    "c_and_k_at_2x2": ((2, 2), (1, 1), (1, 1), (2, 2)),
    "ratio_2x1": ((2, 1), (1, 1), (1, 1), (1, 1)),
    "first_below": ((1, 1), (2, 2), (2, 2), (1, 1)),
    "ratio_3": ((3, 1), (1, 1), (1, 1), (1, 1)),
}


def _lossless_cmyk(samp, size=(67, 45), predictor=4, adobe=None, seed=3):
    planes = jpeg_lossless_writer.subsample(_picture(*size, 4, seed), samp)
    kw = {} if adobe is None else {"adobe_transform": adobe}
    return jpeg_lossless_writer.write(planes, *size, samp,
                                      predictor=predictor, **kw)


@pytest.mark.parametrize("adobe", [None, 0], ids=["no_app14", "adobe_0"])
@pytest.mark.parametrize("name", sorted(LOSSLESS_CMYK))
def test_lossless_cmyk_equals_pillows(name, adobe, monkeypatch):
    """Pillow's CMYK reading of the samples (inverted, then cmyk2rgb)
    exactly; K3 twice where the components are sampled differently
    (replication, exact on u8), never where they are sampled alike."""
    samp = LOSSLESS_CMYK[name]
    data = _lossless_cmyk(samp, adobe=adobe)
    calls = _count_k3(monkeypatch)
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert len(calls) == (0 if name == "alike" else 2)
    assert np.array_equal(got, ref_codecs.decode_bytes(data)[0])


def test_lossless_cmyk_colour_is_pillows_cmyk2rgb():
    """The colour step on the samples, against Pillow's ``CMYK;I`` and
    ``convert("RGB")`` of the same four planes."""
    hdr, samples, _ = jpeg.decode_to_coefficients(
        _lossless_cmyk(LOSSLESS_CMYK["alike"]))
    raw = np.stack(samples, -1)
    want = np.asarray(Image.frombytes("CMYK", raw.shape[1::-1],
                                      raw.tobytes(), "raw", "CMYK;I")
                      .convert("RGB"))
    import torch
    got = color.cmyk_to_rgb(*(torch.from_numpy(p) for p in samples)).numpy()
    assert np.array_equal(got, want)


def test_lossless_ycck_is_pillows_broken_stream():
    data = _lossless_cmyk(LOSSLESS_CMYK["alike"], adobe=2)
    assert "broken data stream" in _pillow_error(data)
    with pytest.raises(SourceDecodeError, match="broken data stream"):
        jpeg.decode_to_coefficients(data)


@pytest.mark.parametrize("name", ["alike", "c_and_k_at_2x2"])
def test_http_lossless_cmyk_serves_as_the_reference(tmp_path, name):
    data = _lossless_cmyk(LOSSLESS_CMYK[name], size=(96, 64))
    ref, port = _both_apps(tmp_path, data)
    _assert_parity(ref, port, [200] * 4)


# -- the JPEG TIFF remainder ------------------------------------------------------------


def _planar_tables_differ(size=(64, 48), rows=16) -> bytes:
    """Planar RGB, each strip a one-component JPEG of its own tables, the
    qualities 50 and 90 in turn: no ``JPEGTables``."""
    w, h = size
    img = _img_rgb(size)
    segs = []
    for c in range(3):
        for k, y in enumerate(range(0, h, rows)):
            segs.append(chip_smoke.split_jpeg(_save(
                Image.fromarray(np.ascontiguousarray(img[y:y + rows, :, c])),
                "JPEG", quality=(50, 90)[k % 2]), ())[1])
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]), 277: (3, [3]),
            278: (4, [rows]), 284: (3, [2])}
    return chip_smoke.tiff_file(w, h, tags, segs)


def _sub4(samp, size=(64, 48), rows=None) -> bytes:
    """A YCbCr page whose segments (``jpeg_writer``) are sampled ``samp``,
    YCbCrSubSampling the luma's factors, in one strip or in strips of
    ``rows`` rows."""
    w, h = size
    img = _img_rgb(size)
    rows = rows or h
    segs, tables = [], b""
    for y in range(0, h, rows):
        part = img[y:y + rows]
        planes, tabs, tq = jpeg_writer.coefficients(part, 85, samp)
        tables, seg = chip_smoke.split_jpeg(jpeg_writer.write(
            planes, tabs, w, part.shape[0], samp, tq))
        segs.append(seg)
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [rows]), 284: (3, [1]), 347: (7, tables),
            530: (3, list(samp[0]))}
    return chip_smoke.tiff_file(w, h, tags, segs)


def _parts(jfif: bytes):
    """A JPEG with restart markers -> (its header up to the SOS's end, the
    entropy-coded data between the markers)."""
    sos = _sos_end(jfif)
    return sos, re.split(rb"\xff[\xd0-\xd7]", jfif[sos:-2])


def _old_style_strips(form: str, rows=16, size=(64, 48)) -> bytes:
    """An old-style JPEG page in strips of ``rows`` rows, as old writers
    made them: a JFIF with a restart marker every strip, its entropy data
    cut at the markers into the strips; its header behind
    JPEGInterchangeFormat ("jif"), or its tables in the tags ("tables",
    JPEGRestartInterval the DRI's)."""
    w, h = size
    j = _jfif(size, sampling=2, restart_marker_rows=rows // 16)
    sos, parts = _parts(j)
    if form == "jif":
        tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]),
                277: (3, [3]), 278: (4, [rows]),
                513: (4, lambda o: o[0:1]), 514: (4, [sos])}
        return _tiff(w, h, tags, parts, blobs=[j[:sos]])
    q, dc, ac = _tables_of(j)
    dri = j.index(b"\xff\xdd")
    tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [rows]), 512: (3, [1]), 530: (3, [2, 2]),
            515: (3, [struct.unpack(">H", j[dri + 4:dri + 6])[0]]),
            519: (4, lambda o: o[0:3]), 520: (4, lambda o: o[3:6]),
            521: (4, lambda o: o[6:9])}
    return _tiff(w, h, tags, parts, blobs=[q[0], q[1], q[1], dc[0], dc[1],
                                           dc[1], ac[0], ac[1], ac[1]])


TIFF_REMAINDER = {
    "planar_rgb_straddling": lambda: _planar((64, 48), rows=12),
    "planar_cmyk_straddling": lambda: _planar((64, 48), rows=12,
                                              photometric=5),
    "planar_tables_differ": _planar_tables_differ,
    "planar_gray_with_alpha": _planar_gray_with_alpha,
    "old_style_gray": _old_style_gray,
    "old_style_jif_strips": lambda: _old_style_strips("jif"),
    "old_style_jif_strips_odd_size": lambda: _old_style_strips(
        "jif", 16, (61, 45)),
    "old_style_tables_strips": lambda: _old_style_strips("tables", 32),
    "sub_41": lambda: _sub4(((4, 1), (1, 1), (1, 1))),
    "sub_42": lambda: _sub4(((4, 2), (1, 1), (1, 1))),
    "sub_24": lambda: _sub4(((2, 4), (1, 1), (1, 1))),
    "sub_14": lambda: _sub4(((1, 4), (1, 1), (1, 1))),
    "sub_41_strips": lambda: _sub4(((4, 1), (1, 1), (1, 1)), (64, 72), 16),
}


@pytest.mark.parametrize("name", sorted(TIFF_REMAINDER))
def test_tiff_remainder_decodes_as_pillow(name):
    """The layouts of queue 1 item 9 that answered 501: within the JPEG
    TIFF band of Pillow's pixels (a planar page straddling blocks or of
    differing tables segment by segment; planar gray + alpha with its
    alpha 0, as Pillow reads it; old-style gray as the JPEG's gray; an
    old-style page of several strips assembled with an RSTn between each
    two, as libtiff's OJPEG module does; YCbCrSubSampling 4 with libjpeg's
    replication of such chroma)."""
    data = TIFF_REMAINDER[name]()
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    _band(got, want)
    if name == "planar_gray_with_alpha":
        assert got.shape[-1] == 4 and not got[..., 3].any()


def test_subsampling_4_on_both_axes_is_refused_as_pillow_refuses_it(
        tmp_path):
    """YCbCrSubSampling (4, 4): 18 blocks an MCU, which libjpeg refuses
    ("Sampling factors too large for interleaved scan"): 400 in both."""
    data = _sub4(((4, 4), (1, 1), (1, 1)))
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError, match="refuses its sampling") as e:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)
    ref, port = _both_apps(tmp_path, data)
    _assert_parity(ref, port, [400] * 4)


@pytest.mark.parametrize("name", ["planar_rgb_straddling", "sub_41",
                                  "old_style_jif_strips"])
def test_http_tiff_remainder_serves_as_the_reference(tmp_path, name):
    ref, port = _both_apps(tmp_path, TIFF_REMAINDER[name]())
    _assert_parity(ref, port, [200] * 4)


def test_old_style_stream_of_strips_has_libtiffs_restarts():
    """The assembled stream: the interchange format's header, the strips
    with RST0, RST1, ... between them, an EOI; the JPEG of the same data
    read whole."""
    j = _jfif((64, 48), sampling=2, restart_marker_rows=1)
    stream = tiff.old_style_stream(_old_style_strips("jif"))
    assert stream == j


def test_planar_straddling_page_keeps_its_segments():
    page = tiff.entropy_decode(TIFF_REMAINDER["planar_rgb_straddling"]())
    assert page.segments is not None and len(page.segments) == 4
    assert all(len(seg.coeffs) == 3 for seg, _, _ in page.segments)


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_bytes_after_the_eoi_are_libjpegs_to_ignore(progressive):
    """Bytes after the EOI (padding some writers leave): libjpeg reads no
    further, Pillow decodes the file, and so does the port, to the planes
    of the file without them."""
    data = _pil_jpeg((96, 64), 85, progressive)
    padded = data + bytes(range(200))
    assert _pillow_error(padded) is None
    hdr, got, _ = jpeg.decode_to_coefficients(padded)
    for a, b in zip(got, jpeg.decode_to_coefficients(data)[1]):
        assert np.array_equal(a, b)
