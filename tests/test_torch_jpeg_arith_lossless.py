"""Arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEGs in the port, on
the CPU, and the four JPEG and PNG answers that differed from the
reference's before them.

The reference's pinned parser refuses these frames, so it decodes them
with Pillow (libjpeg-turbo 3) and hands the pixels to its RGB head. The
port entropy-decodes them in its own C++ (``codecs/native/
jpeg4_decode.cpp``: the QM decoder of T.81 Annex D as libjpeg's
``jdarith.c`` runs it, and the lossless decoder of Annex H), then runs its
pixel decode (K3's plain version here) and the RGB head. No encoder here
writes these files: ``tests/fixtures/jpeg_arith_writer.py`` and
``jpeg_lossless_writer.py`` (numpy) do, and each writer is held to Pillow
first.

- The writers: Pillow decodes every arithmetic file to the pixels of the
  Huffman file of the same planes, and every lossless file to its samples
  (gray, or R, G and B as they are, chroma replicated).
- Arithmetic: the port's decode returns exactly the planes written (the
  blocks a scan does not code zero), which are those the pinned Huffman
  decoder returns for the Huffman file of the same planes: SOF9 and SOF10
  with successive approximation, 1, 3 and 4 components, 4:2:0, 4:2:2 and
  4:4:4, restart intervals, DAC segments of other L, U and K. The pixel
  decode within +-2 on at most 0.1% of values of the JAX package's RGB
  head under K3's semantics, and at >= 40 dB of Pillow.
- Lossless: pixels and channels equal to the JAX package's
  ``decode_bytes`` (Pillow) for every predictor, Pt > 0, restarts,
  one-component scans and chroma ratios of 2, 3 and 4; one K3 launch only
  where the components are sampled differently.
- Both apps: statuses, bodies where the reference's carry no object's
  address, outputs within 38 dB. What Pillow refuses answers 400 in both:
  two- and five-component frames, hierarchical ones, a PNG whose IHDR
  filter method is not 0, a DAC with L > U, a lossless frame that needs a
  colour conversion, has a restart interval of part of a row, an MCU of
  more than 10 samples or a fractional ratio. A PNG whose compression method byte is not 0 is
  served by both; an RGB-coded JPEG is served as RGB.
- Recorded, not matched: libjpeg's arithmetic decoder cannot suspend for
  more data, and Pillow feeds it 64 KiB at a time, so the reference
  refuses an arithmetic file whose scan runs past its first read block;
  the port serves it.
"""

import io
import zlib

import numpy as np
import pytest
from aiohttp import FormData
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu_torch import codecs, fetch
from imagekit_tpu_torch.codecs import jpeg, png
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import (
    NotPortedError,
    SourceDecodeError,
    TransformError,
)
from imagekit_tpu_torch.ops import dct, resize_planes
from tests.conftest import make_test_image
from tests.fixtures import jpeg_arith_writer, jpeg_lossless_writer
from tests.fixtures import jpeg_writer
from tests.test_torch_jpeg_layouts import _jax_pixel_decode
from tests.test_torch_jpeg_sampling import _both, _photo
from tests.test_torch_jxc_slice import _ref_native_lib, k3_semantics  # noqa: F401
from tests.test_torch_pillow_sources import (
    MODES,
    _decoded,
    _img,
    _out_size,
    _serve,
    _url,
    psnr,
)

MAX_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


# -- fixtures ----------------------------------------------------------------------

#: name -> the (h, v) factors of each component
SAMPLINGS = {
    "420": ((2, 2), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "444": ((1, 1), (1, 1), (1, 1)),
    "gray": ((1, 1),),
    "cmyk": ((2, 2), (1, 1), (1, 1), (2, 2)),
}
#: writer options of the arithmetic cases: a DAC of other L, U and K
DAC = {("dc", 0): (2, 6), ("ac", 0): 12, ("dc", 1): (0, 0), ("ac", 1): 63}
ARITH_OPTIONS = {
    "sof9": {},
    "sof9_rst2": {"restart": 2},
    "sof9_a_scan_each": {"interleaved": False},
    "sof9_dac": {"dac": DAC},
    "sof10": {"progressive": True},
    "sof10_rst3_dac": {"progressive": True, "restart": 3, "dac": DAC},
}
ARITH_CASES = [(s, o) for s in SAMPLINGS for o in ARITH_OPTIONS]


def _arith_id(case):
    return "-".join(case)


def _picture(w, h, ncomp, seed=0):
    img = make_test_image(w, h) if seed == 0 else _photo(w, h, seed)
    if ncomp == 1:
        return img[:, :, :1]
    return np.dstack([img, img[:, :, 1]]) if ncomp == 4 else img


def _planes(samp, size, seed=0, quality=85):
    """Quantised planes of a test picture at ``samp`` (one to four
    components), the tables and selectors: ``jpeg_writer.coefficients``
    of its first three channels, the fourth component a second copy of the
    luma's, grayscale the luma alone."""
    w, h = size
    img = _picture(w, h, 3, seed)
    three = tuple(samp[:3]) if len(samp) >= 3 else (samp[0], (1, 1), (1, 1))
    planes, tabs, tq = jpeg_writer.coefficients(img, quality, three)
    if len(samp) == 1:
        return planes[:1], tabs, tq[:1]
    if len(samp) == 4:
        return planes + [planes[0].copy()], tabs, tq + [0]
    return planes, tabs, tq


def _coded(planes, size, samp, options):
    """The planes a decoder returns: where a component has a scan of its
    own (every AC scan of a progressive frame), its MCU-padding blocks are
    not coded and stay zero (their DC too, unless an interleaved scan codes
    it)."""
    if options.get("interleaved", True) and not options.get("progressive"):
        return planes
    _, real = jpeg_writer.grids(*size, samp)
    out = []
    dc_coded = options.get("progressive") and len(samp) > 1
    for p, (ch, cw) in zip(planes, real):
        q = np.zeros_like(p)
        rows, cols = -(-ch // 8), -(-cw // 8)
        q[:rows, :cols] = p[:rows, :cols]
        if dc_coded:  # the DC scans are interleaved
            q[..., 0] = p[..., 0]
        out.append(q)
    return out


def arith_written(case, size=(77, 53), seed=0):
    """(arithmetic file, Huffman file of the same planes, the planes as a
    decoder returns them, sampling). CMYK files carry an Adobe APP14 of
    transform 0."""
    name, option = case
    samp, options = SAMPLINGS[name], ARITH_OPTIONS[option]
    planes, tabs, tq = _planes(samp, size, seed)
    w, h = size
    adobe = {"adobe_transform": 0} if len(samp) == 4 else {}
    data = jpeg_arith_writer.write(planes, tabs, w, h, samp, tq, **options,
                                   **adobe)
    coded = _coded(planes, size, samp, options)
    huffman = jpeg_writer.write(coded, tabs, w, h, samp, tq, **adobe)
    return data, huffman, coded, samp


#: lossless cases: (sampling, predictor, Pt, restart rows, interleaved)
LOSSLESS_CASES = (
    [("444", p, 0, 0, True) for p in range(1, 8)]
    + [("gray", p, 0, 0, True) for p in (1, 4, 7)]
    + [("420", p, pt, 0, True) for p, pt in ((1, 0), (5, 2), (6, 7))]
    + [("444", 2, 3, 1, True), ("420", 4, 0, 2, True),
       ("444", 3, 1, 1, False), ("gray", 6, 5, 2, True)]
    + [(s, 7, 0, 0, inter) for s in ("y3x1", "411", "410", "cb11_cr21",
                                     "y11_under_c22")
       for inter in (True, False)])
LOSSLESS_SAMPLINGS = {
    **SAMPLINGS,
    "y3x1": ((3, 1), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "410": ((4, 2), (1, 1), (1, 1)),
    "cb11_cr21": ((2, 2), (1, 1), (2, 1)),
    "y11_under_c22": ((1, 1), (2, 2), (2, 2)),
}


def _lossless_id(case):
    name, pred, pt, rows, inter = case
    return (f"{name}-p{pred}-pt{pt}-rst{rows}"
            f"-{'one_scan' if inter else 'a_scan_each'}")


def lossless_written(case, size=(67, 45), seed=0, **kw):
    """(file, the sample planes coded (after Pt), sampling)."""
    name, pred, pt, rows, inter = case
    samp = LOSSLESS_SAMPLINGS[name]
    w, h = size
    planes = jpeg_lossless_writer.subsample(_picture(w, h, len(samp), seed),
                                            samp)
    hmax = max(s[0] for s in samp)
    per_row = -(-w // hmax) if inter else jpeg_lossless_writer.\
        component_sizes(w, h, samp)[0][1]
    restart = rows * per_row if (inter or len(set(samp)) == 1) else 0
    data = jpeg_lossless_writer.write(planes, w, h, samp, predictor=pred,
                                      pt=pt, restart=restart,
                                      interleaved=inter, **kw)
    return data, [(p >> pt) << pt for p in planes], samp


def _replicated(planes, samp, size):
    """Pillow's pixels of a lossless frame: each component replicated over
    the largest factors, cropped; gray as it is."""
    w, h = size
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    out = [np.repeat(np.repeat(p, vmax // sv, 0), hmax // sh, 1)[:h, :w]
           for p, (sh, sv) in zip(planes, samp)]
    return out[0] if len(out) == 1 else np.stack(out, -1)


# -- the writers against Pillow ------------------------------------------------------


@pytest.mark.parametrize("case", ARITH_CASES, ids=_arith_id)
def test_arithmetic_writer_is_read_by_pillow_as_its_huffman_twin(case):
    data, huffman, _, samp = arith_written(case)
    marker = 0xCA if ARITH_OPTIONS[case[1]].get("progressive") else 0xC9
    assert bytes((0xFF, marker)) in data and len(data) < 1 << 16
    assert np.array_equal(_pil(data), _pil(huffman))


@pytest.mark.parametrize("case", LOSSLESS_CASES, ids=_lossless_id)
def test_lossless_writer_is_read_by_pillow_as_its_samples(case):
    data, planes, samp = lossless_written(case)
    got = _pil(data)
    assert np.array_equal(got, _replicated(planes, samp, (67, 45)))


# -- arithmetic coding ---------------------------------------------------------------


@pytest.mark.parametrize("case", ARITH_CASES, ids=_arith_id)
def test_arithmetic_decode_returns_the_planes_written(case):
    data, huffman, planes, samp = arith_written(case)
    lib = loader.load()
    hdr = jpeg_abi.parse4(lib, data)
    assert hdr.coding == jpeg_abi.ARITHMETIC and hdr.port_decoder
    assert hdr.progressive == bool(ARITH_OPTIONS[case[1]].get("progressive"))
    _, got, qtabs = jpeg_abi.decode4(lib, data)
    assert len(got) == len(planes)
    for g, p in zip(got, planes):
        assert np.array_equal(g, p)
    # the Huffman file of the same planes, through the pinned decoder
    # where it takes the frame (one interleaved scan of 1 or 3
    # components), else through the port's
    pinned = len(samp) != 4
    _, twin, twin_q = (jpeg_abi.decode if pinned else jpeg_abi.decode4)(
        lib, huffman)
    for g, t in zip(got, twin):
        assert np.array_equal(g, t)
    assert np.array_equal(qtabs[:2], twin_q[:2])


@pytest.mark.parametrize("case", [c for c in ARITH_CASES if c[0] != "cmyk"],
                         ids=_arith_id)
def test_arithmetic_pixel_decode_matches_jax_head_under_k3(k3_semantics,
                                                           case):
    data = arith_written(case)[0]
    decoded = jpeg.decode_to_coefficients(data)
    want = _jax_pixel_decode(decoded)
    got = dct.decode_components_to_rgb(decoded, device="cpu")
    assert got.shape == want.shape == (53, 77, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 2 and (d > 0).mean() <= MAX_SHARE


@pytest.mark.parametrize("case", ARITH_CASES, ids=_arith_id)
def test_arithmetic_decode_against_pillow(case):
    data = arith_written(case, (96, 64), seed=4)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape == (64, 96, 3)
    assert psnr(got, want) >= 40.0
    assert np.abs(got.astype(int) - want).max() <= 12


def _rst_out_of_order(data: bytes) -> bytes:
    """The file with its first two RSTn markers swapped."""
    out = bytearray(data)
    at = [i for i in range(len(out) - 1)
          if out[i] == 0xFF and 0xD0 <= out[i + 1] <= 0xD7][:2]
    out[at[0] + 1], out[at[1] + 1] = out[at[1] + 1], out[at[0] + 1]
    return bytes(out)


def _cut_after_marker(data: bytes) -> bytes:
    """The file with its first scan's data cut short by an EOI marker."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return data[:start + 40] + b"\xff\xd9"


@pytest.mark.parametrize("mangle", [_rst_out_of_order, _cut_after_marker],
                         ids=["rst_out_of_order", "eoi_in_scan"])
def test_arithmetic_decode_is_as_lenient_as_libjpeg(mangle):
    """Restart markers out of sequence (jpeg_resync_to_restart) and a scan
    cut by a marker (zeros fed from there): the pixels Pillow gives."""
    data = mangle(arith_written(("420", "sof9_rst2"), (96, 64), seed=4)[0])
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape
    assert psnr(got, want) >= 40.0


def test_arithmetic_decode_of_a_scan_ending_in_no_marker_is_refused():
    """Data that ends inside a scan: libjpeg's arithmetic decoder cannot
    suspend for more, so Pillow fails, and the port refuses it (the fetch
    stage takes the header; the decode is the engine's 400)."""
    data = arith_written(("444", "sof9"), (96, 64), seed=4)[0]
    cut = data[:len(data) // 2]
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(cut)
    with pytest.raises(SourceDecodeError):
        jpeg.decode_to_coefficients(cut)


def test_arithmetic_past_pillows_read_block_is_served():
    """Recorded, not matched: Pillow hands libjpeg a file 64 KiB at a time,
    and libjpeg's arithmetic decoder cannot suspend when a block runs out
    (JERR_CANT_SUSPEND), so the reference refuses ("broken data stream")
    an arithmetic JPEG whose scan runs past its first block. The port
    decodes it whole, to the planes written (and the pixels Pillow gives
    when it is handed the file in one block)."""
    planes, tabs, tq = jpeg_writer.coefficients(_photo(800, 480, 9), 95,
                                                SAMPLINGS["420"])
    data = jpeg_arith_writer.write(planes, tabs, 800, 480, SAMPLINGS["420"],
                                   tq)
    assert len(data) > 1 << 16
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(data)).load()
    whole = Image.open(io.BytesIO(data))
    whole.decodermaxblock = 1 << 30
    want = np.asarray(whole.convert("RGB"))
    _, got, _ = jpeg_abi.decode4(loader.load(), data)
    for g, p in zip(got, planes):
        assert np.array_equal(g, p)
    pixels = codecs.decode_bytes(data, device="cpu")[0]
    assert psnr(pixels, want) >= 40.0


@pytest.mark.parametrize("case", [("420", "sof9_rst2"), ("444", "sof10"),
                                  ("gray", "sof10_rst3_dac"),
                                  ("cmyk", "sof9")], ids=_arith_id)
def test_http_arithmetic_serves_as_the_reference(tmp_path, case):
    """``/img`` at w=64 WebP and JPEG and unresized, and ``POST /upload``,
    through both apps: statuses and content types equal, outputs within
    38 dB."""
    data = arith_written(case, (96, 64), seed=6)[0]

    async def fn(client):
        outs = [await _img(client, url=_url("x"), w=w,
                           f=fmt.value if fmt != ImageFormat.webp else None)
                for w, fmt in MODES]
        form = FormData()
        form.add_field("file", data, filename="x.jpg")
        form.add_field("w", "48")
        r = await client.post("/upload", data=form)
        return outs + [(r.status, r.headers.get("Content-Type"),
                        await r.read())]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pbody[:200]
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0


# -- lossless ------------------------------------------------------------------------


@pytest.mark.parametrize("case", LOSSLESS_CASES, ids=_lossless_id)
def test_lossless_decode_equals_pillows(case, monkeypatch):
    """Pixels and channels exactly the JAX package's ``decode_bytes``
    (Pillow): gray (to RGB), R, G and B as they are, subsampled components
    replicated; K3 launched once where the components are sampled
    differently, never otherwise (its plain version here)."""
    data, planes, samp = lossless_written(case, seed=3)
    calls = []
    plain = resize_planes.resize_planes_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(resize_planes, "resize_planes_plain", counted)
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape and np.array_equal(got, want)
    sampled_alike = len(set(samp)) == 1
    assert len(calls) == (0 if sampled_alike else 3)
    hdr, samples = jpeg_abi.decode_lossless(loader.load(), data)
    assert hdr.coding == jpeg_abi.LOSSLESS
    for s, p in zip(samples, planes):
        assert np.array_equal(s, p)


@pytest.mark.parametrize("case", [("444", 1, 0, 0, True),
                                  ("420", 7, 1, 1, True),
                                  ("gray", 4, 0, 0, True)],
                         ids=_lossless_id)
def test_http_lossless_serves_as_the_reference(tmp_path, case):
    data = lossless_written(case, (96, 64), seed=6)[0]

    async def fn(client):
        outs = [await _img(client, url=_url("x"), w=w,
                           f=fmt.value if fmt != ImageFormat.webp else None)
                for w, fmt in MODES]
        form = FormData()
        form.add_field("file", data, filename="x.jpg")
        form.add_field("w", "48")
        r = await client.post("/upload", data=form)
        return outs + [(r.status, r.headers.get("Content-Type"),
                        await r.read())]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pbody[:200]
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0


# -- what Pillow refuses, and the repairs -------------------------------------------


def _hierarchical(marker: int) -> bytes:
    data = bytearray(jpeg_writer.encode(make_test_image(64, 48), 85,
                                        SAMPLINGS["420"]))
    data[data.index(b"\xff\xc0") + 1] = marker
    return bytes(data)


def _components(n: int, interleaved: bool) -> bytes:
    planes, tabs, tq = _planes(SAMPLINGS["444"], (64, 48))
    planes = (planes * 2)[:n]
    return jpeg_writer.write(planes, tabs, 64, 48, [(1, 1)] * n,
                             (tq * 2)[:n], interleaved=interleaved)


def _lossless_restart_of_part_of_a_row() -> bytes:
    """A lossless file whose restart interval (one row of 67 MCUs) is made
    33 MCUs: libjpeg takes whole MCU rows only."""
    data = bytearray(lossless_written(("444", 1, 0, 1, True))[0])
    at = data.index(b"\xff\xdd")
    data[at + 4:at + 6] = (33).to_bytes(2, "big")
    return bytes(data)


def _dac_l_over_u() -> bytes:
    planes, tabs, tq = _planes(SAMPLINGS["420"], (64, 48))
    return jpeg_arith_writer.write(planes, tabs, 64, 48, SAMPLINGS["420"],
                                   tq, dac={("dc", 0): (5, 2)})


REFUSED = {
    **{f"sof{m - 0xC0}": (lambda m=m: _hierarchical(m))
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "two_components": lambda: _components(2, True),
    "two_components_a_scan_each": lambda: _components(2, False),
    "five_components": lambda: _components(5, False),
    "dac_l_over_u": _dac_l_over_u,
    "lossless_jfif": lambda: lossless_written(("444", 1, 0, 0, True),
                                              jfif=True)[0],
    "lossless_adobe_1": lambda: lossless_written(
        ("444", 1, 0, 0, True), adobe_transform=1)[0],
    "lossless_cmyk_adobe_2": lambda: lossless_written(
        ("cmyk", 1, 0, 0, True), adobe_transform=2)[0],
    "lossless_restart_of_part_of_a_row": _lossless_restart_of_part_of_a_row,
    "lossless_mcu_of_11": lambda: jpeg_lossless_writer.write(
        jpeg_lossless_writer.subsample(_picture(64, 48, 3),
                                       ((3, 3), (1, 1), (1, 1))),
        64, 48, ((3, 3), (1, 1), (1, 1))),
    "lossless_fractional": lambda: jpeg_lossless_writer.write(
        jpeg_lossless_writer.subsample(_picture(64, 48, 3),
                                       ((3, 1), (2, 1), (2, 1))),
        64, 48, ((3, 1), (2, 1), (2, 1))),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_pillow_refuses_answers_as_the_reference(tmp_path, name):
    """``/img`` at w=64 and unresized, ``/upload`` at w=64 and unresized:
    400 in both apps, the bodies equal (Pillow's "cannot identify image
    file" names a BytesIO's address on ``/upload``: there the message
    without it)."""
    data = REFUSED[name]()
    sources = {"x": data}
    ref = _serve(tmp_path, "ref", sources, lambda c: _both(c, data))
    port = _serve(tmp_path, "port", sources, lambda c: _both(c, data))
    assert [o[0] for o in port] == [o[0] for o in ref] == [400] * 4
    if "components" in name:
        assert port[:2] == ref[:2]
        assert all(b"cannot identify image file" in o[2] for o in port[2:])
        assert all(b"cannot identify image file" in o[2] for o in ref[2:])
    else:
        assert port == ref


def test_two_and_five_components_are_pillows_unidentified_frame():
    for data in (_components(2, True), _components(5, False)):
        with pytest.raises(TransformError, match="cannot identify") as e:
            jpeg.source_header(loader.load(), data)
        assert not isinstance(e.value, (NotPortedError, SourceDecodeError))
        with pytest.raises(TransformError, match="cannot identify"):
            fetch._jpeg_header(data)


@pytest.mark.parametrize("layout,marker", [
    ("444", {"adobe_transform": 0}), ("420", {"adobe_transform": 0}),
    ("444", {"ids": (82, 71, 66)}), ("422", {"ids": (82, 71, 66)})],
    ids=["444_adobe0", "420_adobe0", "444_ids_rgb", "422_ids_rgb"])
def test_rgb_coded_jpeg_is_decoded_as_rgb(layout, marker):
    """libjpeg decodes three components as RGB after an Adobe transform of
    0, or with the ids 'R', 'G', 'B' and no marker; so does the port's
    pixel decode now (it was 10.8 dB off): within the JPEG pixel decode's
    bar of Pillow, and the colour space read as libjpeg reads it."""
    samp = SAMPLINGS[layout]
    img = _photo(96, 64, 2)
    planes, tabs, tq = jpeg_writer.coefficients(img, 90, samp, colour="rgb")
    data = jpeg_writer.write(planes, tabs, 96, 64, samp, tq, **marker)
    assert jpeg.colour_space(data, 3) == "rgb"
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert psnr(got, want) >= 40.0
    assert np.abs(got.astype(int) - want).max() <= 12
    assert psnr(got, img) >= 30.0


def test_colour_space_is_libjpegs_rule():
    def jpg(**kw):
        planes, tabs, tq = _planes(SAMPLINGS["444"], (16, 16))
        return jpeg_writer.write(planes, tabs, 16, 16, SAMPLINGS["444"], tq,
                                 **kw)

    jfif = jpeg_lossless_writer.write(
        jpeg_lossless_writer.subsample(_picture(16, 16, 3), [(1, 1)] * 3),
        16, 16, [(1, 1)] * 3, jfif=True, adobe_transform=0)
    assert jpeg.colour_space(jfif, 3) == "ycbcr"  # JFIF first
    assert jpeg.colour_space(jpg(), 3) == "ycbcr"
    assert jpeg.colour_space(jpg(), 3, lossless=True) == "rgb"
    assert jpeg.colour_space(jpg(ids=(82, 71, 66)), 3) == "rgb"
    assert jpeg.colour_space(jpg(adobe_transform=0), 3) == "rgb"
    assert jpeg.colour_space(jpg(adobe_transform=1), 3) == "ycbcr"
    assert jpeg.colour_space(jpg(adobe_transform=2), 3) == "ycbcr"
    assert jpeg.colour_space(jpg(), 1) == "gray"
    assert jpeg.colour_space(jpg(), 4) == "cmyk"
    assert jpeg.colour_space(jpg(adobe_transform=2), 4) == "ycck"


@pytest.mark.parametrize("layout,marker", [
    ("444", {"adobe_transform": 0}), ("420", {"adobe_transform": 0}),
    ("444", {"ids": (82, 71, 66)})],
    ids=["444_adobe0", "420_adobe0", "444_ids_rgb"])
def test_http_rgb_coded_jpeg_serves_as_the_reference(tmp_path, layout,
                                                     marker):
    """``/img`` at w=64 and unresized and ``/upload`` at w=64 (unresized
    for the 4:2:0 file): statuses equal, outputs within 38 dB of the
    reference. With a resize a 4:2:0 file takes the batched JPEG heads in
    both apps, which convert from YCbCr whatever the markers say (left as
    they are: the same step in both, but on such colours their outputs
    differ by more than the band), so it is compared unresized."""
    samp = SAMPLINGS[layout]
    planes, tabs, tq = jpeg_writer.coefficients(_photo(96, 64, 5), 90, samp,
                                                colour="rgb")
    data = jpeg_writer.write(planes, tabs, 96, 64, samp, tq, **marker)

    width = None if layout == "420" else 64

    async def fn(client):
        outs = [await _img(client, url=_url("x"), w=w) for w in (width, None)]
        form = FormData()
        form.add_field("file", data, filename="x.jpg")
        if width:
            form.add_field("w", str(width))
        r = await client.post("/upload", data=form)
        return outs + [(r.status, r.headers.get("Content-Type"),
                        await r.read())]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pbody[:200]
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0


def _png_with_method(byte: int, value: int) -> bytes:
    """A Pillow PNG with IHDR byte ``byte`` (10 compression, 11 filter
    method) set to ``value`` and the chunk's CRC made again."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(48, 40)).save(buf, "PNG")
    data = bytearray(buf.getvalue())
    data[16 + byte] = value
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    return bytes(data)


@pytest.mark.parametrize("byte,status", [(10, 200), (11, 400)],
                         ids=["compression_method", "filter_method"])
def test_http_png_method_bytes_answer_as_the_reference(tmp_path, byte,
                                                       status):
    """IHDR compression method 1 (Pillow never reads the byte: served) and
    filter method 1 (Pillow has no such PNG: 400): ``/img`` at w=32 and
    unresized, ``/upload`` at w=32, through both apps."""
    data = _png_with_method(byte, 1)

    async def fn(client):
        outs = [await _img(client, url=_url("x"), w=w) for w in (32, None)]
        form = FormData()
        form.add_field("file", data, filename="x.png")
        form.add_field("w", "32")
        r = await client.post("/upload", data=form)
        return outs + [(r.status, r.headers.get("Content-Type"),
                        await r.read())]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    assert [o[0] for o in port] == [o[0] for o in ref] == [status] * 3
    if status == 400:
        assert port[0] == ref[0] and port[1] == ref[1]
        assert all(b"cannot identify image file" in o[2]
                   for o in (port[2], ref[2]))
    else:
        for (_, _, pbody), (_, _, rbody) in zip(port, ref):
            assert np.array_equal(_decoded(pbody), _decoded(rbody))
        assert np.array_equal(png.decode(data), make_test_image(48, 40))
