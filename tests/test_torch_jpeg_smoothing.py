"""libjpeg's block smoothing of progressive JPEGs whose scans stop early.

``imagekit_tpu_torch/codecs/jpeg_smoothing.py`` (run by
``codecs/jpeg.py::decode_to_coefficients`` before K6's plain version
here) against Pillow, through the JAX package's ``decode_bytes``: byte for
byte, on

- Pillow's own progressive files (4:4:4, 4:2:2, 4:2:0, gray, CMYK) cut
  after each of their scans (an EOI appended), at sizes whose block grids
  are one, two and many blocks wide and whose last iMCU row is partial;
- arithmetic-coded progressive files (``tests/fixtures/
  jpeg_arith_writer.py``) whose scripts stop early in ways Pillow's never
  do: DC only, spectral selection without refinement, AC coefficients
  shifted by a point transform, a DC shifted by 3, in 4:2:0, 4:1:1, mixed
  chroma, a 2x2 gray and CMYK;

and its pieces: the scan bits, where libjpeg turns smoothing off, the
block rows of a small image's last iMCU row, the kernels' symmetries.

Tolerance: none.
"""

import io

import numpy as np
import pytest
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu_torch import codecs
from imagekit_tpu_torch.codecs import jpeg
from imagekit_tpu_torch.codecs import jpeg_smoothing as js
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from tests.conftest import make_test_image
from tests.fixtures import jpeg_arith_writer, jpeg_writer
from tests.test_torch_jxc_slice import _ref_native_lib


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


def _progressive(mode, size, quality=75) -> bytes:
    w, h = size
    rng = np.random.default_rng(w * 31 + h)
    img = np.clip(make_test_image(w, h) + rng.normal(0, 10, (h, w, 3)),
                  0, 255).astype(np.uint8)
    pic = Image.fromarray(img)
    kw = {}
    if mode in ("444", "422", "420"):
        kw["subsampling"] = ("444", "422", "420").index(mode)
    else:
        pic = pic.convert({"gray": "L", "cmyk": "CMYK"}[mode])
    buf = io.BytesIO()
    pic.save(buf, "JPEG", quality=quality, progressive=True, **kw)
    return buf.getvalue()


def _cuts(data: bytes):
    """The file cut before each of its scans but the first, an EOI
    appended, and whole."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return [data[:at] + b"\xff\xd9" for at in sos[1:]] + [data]


def _assert_pillows(data: bytes, label) -> None:
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == want.shape, label
    d = np.abs(got.astype(int) - want.astype(int))
    assert not d.any(), (label, int(d.max()), int((d > 0).sum()))


PILLOW_MODES = ("444", "422", "420", "gray", "cmyk")
#: one, two and many blocks wide; a last iMCU row of one block row
SIZES = [(9, 23), (16, 40), (17, 9), (96, 64)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", PILLOW_MODES)
def test_pillows_progressive_cut_after_each_scan_decodes_as_pillow(mode,
                                                                   size):
    cuts = _cuts(_progressive(mode, size))
    assert len(cuts) in (6, 10, 18)  # gray, YCbCr, CMYK scripts
    for keep, data in enumerate(cuts, 1):
        _assert_pillows(data, keep)


ARITH_SAMPLINGS = {
    "420": ((2, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "cb11_cr21": ((2, 2), (1, 1), (2, 1)),
    "gray22": ((2, 2),),
    "cmyk": ((2, 2), (1, 1), (1, 1), (2, 2)),
}


def _scripts(n):
    comps = tuple(range(n))
    return {
        "dc_only": ((comps, 0, 0, 0, 1),),
        "dc_then_luma_1_5": jpeg_arith_writer.simple_progression(n)[:2],
        "spectral_only_luma": ((comps, 0, 0, 0, 0), ((0,), 1, 63, 0, 0)),
        "ac_1_9_shifted": ((comps, 0, 0, 0, 0),) + tuple(
            ((c,), 1, 9, 0, 1) for c in comps),
        "dc_shifted_3_luma_1_2": ((comps, 0, 0, 0, 3), ((0,), 1, 2, 0, 0)),
    }


@pytest.mark.parametrize("script", list(_scripts(3)))
@pytest.mark.parametrize("sampling", list(ARITH_SAMPLINGS))
def test_arithmetic_script_that_stops_early_decodes_as_pillow(sampling,
                                                              script):
    samp = ARITH_SAMPLINGS[sampling]
    w, h = 37, 23
    img = make_test_image(w, h)
    three = samp[:3] if len(samp) >= 3 else (samp[0], (1, 1), (1, 1))
    planes, tabs, tq = jpeg_writer.coefficients(img, 85, three)
    if len(samp) == 1:
        planes, tq = planes[:1], tq[:1]
    elif len(samp) == 4:
        planes, tq = planes + [planes[0].copy()], tq + [0]
    extra = {"adobe_transform": 0} if len(samp) == 4 else {}
    data = jpeg_arith_writer.write(planes, tabs, w, h, samp, tq,
                                   progressive=_scripts(len(samp))[script],
                                   **extra)
    _assert_pillows(data, (sampling, script))


def test_scan_bits_follow_pillows_script():
    """libjpeg's simple progression for YCbCr: the DC of all three shifted
    by 1, the luma's AC 1-5 by 2, the chroma's AC by 1, then the
    refinements to 0."""
    cuts = _cuts(_progressive("420", (32, 16)))
    ids = jpeg.frame_markers(cuts[-1]).ids
    first = js.scan_bits(cuts[0], ids)
    assert (first[:, 0] == 1).all() and (first[:, 1:] == -1).all()
    second = js.scan_bits(cuts[1], ids)
    assert second[0].tolist() == [1, 2, 2, 2, 2, 2, -1, -1, -1, -1]
    assert (second[1:] == first[1:]).all()
    third = js.scan_bits(cuts[2], ids)
    assert third[2].tolist() == [1] * 10 and (third[1, 1:] == -1).all()
    assert not js.scan_bits(cuts[-1], ids).any()


def _decoded(data):
    return jpeg_abi.decode(loader.load(), data)


def test_smoothing_is_off_where_libjpeg_turns_it_off():
    """A complete file (every coefficient refined), a baseline one, a zero
    quantiser among the ten, a component without its DC: the planes come
    back as they are."""
    cut = _cuts(_progressive("420", (32, 16)))[2]
    hdr, coeffs, qtabs = _decoded(cut)
    ids = jpeg.frame_markers(cut).ids
    bits = js.scan_bits(cut, ids)
    assert js.smoothing_ok(hdr, qtabs, bits)
    assert js.smooth_blocks(hdr, coeffs, qtabs, bits) is not coeffs
    done = np.zeros_like(bits)
    assert js.smooth_blocks(hdr, coeffs, qtabs, done) is coeffs
    import dataclasses

    baseline = dataclasses.replace(hdr, progressive=False)
    assert js.smooth_blocks(baseline, coeffs, qtabs, bits) is coeffs
    zero = qtabs.copy()
    zero[hdr.comp_tq[1], js.SAVED[7]] = 0
    assert js.smooth_blocks(hdr, coeffs, zero, bits) is coeffs
    no_dc = bits.copy()
    no_dc[2, 0] = -1
    assert js.smooth_blocks(hdr, coeffs, qtabs, no_dc) is coeffs


def test_smoothing_keeps_coded_coefficients_and_the_padding():
    """Only coefficients decoded as 0 take an estimate, and only the blocks
    of the component's real size change."""
    cut = _cuts(_progressive("420", (40, 24)))[1]
    hdr, coeffs, qtabs = _decoded(cut)
    bits = js.scan_bits(cut, jpeg.frame_markers(cut).ids)
    out = js.smooth_blocks(hdr, coeffs, qtabs, bits)
    for c, (a, b) in enumerate(zip(coeffs, out)):
        hb, wb = -(-hdr.comp_height[c] // 8), -(-hdr.comp_width[c] // 8)
        assert np.array_equal(a[hb:], b[hb:])
        assert np.array_equal(a[:, wb:], b[:, wb:])
        coded = a[:hb, :wb] != 0
        coded[..., 0] &= bits[c, 1:].max() >= 0  # interpolated DCs change
        assert np.array_equal(a[:hb, :wb][coded], b[:hb, :wb][coded])
    assert any(not np.array_equal(a, b) for a, b in zip(coeffs, out))


def test_block_rows_of_a_small_image_keep_libjpegs_numbering():
    """Three block rows in iMCU rows of two: the last iMCU row numbers its
    one row as row 1, so its row two above is the row above again; a row
    of the iMCU row before reads the MCU's padding row below the image."""
    rows = js._rows(3, 2, 2)
    assert rows[2].tolist() == [1, 1, 2, 2, 2]
    assert rows[0].tolist() == [0, 0, 0, 1, 2]
    assert js._rows(5, 2, 3)[3].tolist() == [1, 2, 3, 4, 5]
    assert js._rows(4, 1, 4)[3].tolist() == [1, 2, 3, 3, 3]


def test_kernels_are_libjpegs_symmetries():
    """The DC interpolation averages (its weights sum to 256); each
    vertical estimate is its horizontal one transposed."""
    di, ac = js.DC_INTERPOLATION, js.AC_ESTIMATE
    assert di[0].sum() == 256 and np.array_equal(di[0], di[0].T)
    for a, b in ((1, 2), (3, 5), (6, 9), (7, 8)):
        assert np.array_equal(di[a], di[b].T)
    for a, b in ((1, 2), (3, 5)):
        assert np.array_equal(ac[a], ac[b].T)
    assert np.array_equal(di[4], di[4].T) and np.array_equal(ac[4], ac[4].T)
