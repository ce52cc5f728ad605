"""AVIF sources through the port on the CPU, against the JAX package.

- ``codecs/avif_native.py``: the container parse, the dimension probe, the
  studio-range planes (4:2:0, 4:2:2, 4:4:4, monochrome, alpha, BT.709) and
  the RGB decode equal the JAX package's ``avif_native`` (libdav1d), since
  the port's AV1 decoder's planes are byte-equal to libdav1d's
  (``test_torch_av1_decode.py``, ``test_torch_av1_screen_hbd.py``), for
  screen content (palette blocks, intra block copy) and 10- and 12-bit
  streams too; what it does not build answers 501, what does not decode
  400 in libavif's words.
- The YUV heads for every chroma layout, alpha and the BT.709 mix against
  the JAX heads (``ops/dct.py::resize_yuv420_batch`` and
  ``resize_yuv_jpeg_batch``): within +-1 on <= 0.1%.
- K2's new entries under the CPU shim of ``test_torch_kernel_cpu.py``: the
  four planes of an alpha batch and chroma of 4:4:4 and 4:2:2 in one
  launch, and the six f32 planes of a BT.709 batch, against
  ``yuv_resize_plain`` / ``yuv_mix_resize_plain``.
- Both engines (``BatchedEngine.transform``) and both apps (``/img``,
  ``/upload``) on the same AVIFs: WebP, JPEG and AVIF out, alpha kept only
  in AVIF, 4:4:4 and 4:2:2 to JPEG on the pixel decode.
"""

import asyncio
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import FormData

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu.ops.dct import combined_chroma_half_weights as ref_half
from imagekit_tpu.ops.dct import combined_chroma_weights as ref_full
from imagekit_tpu.ops.resize import padded_weights as ref_padded
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch.codecs import avif_encode, avif_native, vp8
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import _build, dct, resize_strip
from imagekit_tpu_torch.ops.resize_strip import plane_record, resize_tables
from imagekit_tpu_torch.ops.weights import pad128, target_dimensions
from imagekit_tpu_torch.serving import engine_yuv
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.test_torch_av1_decode import needs_oracles, pillow_avif, synth
from tests.test_torch_jpeg8 import assert_band
from tests.test_torch_jxc_slice import (
    _capture,
    _ref_native_lib,
    run_engines,
)
from tests.test_torch_kernel_cpu import _images, _stack, lib  # noqa: F401
from tests.conftest import psnr
from tests.test_torch_pillow_sources import _decoded, _img, _serve, _url
from tests.test_torch_rgba_slice import _out_size

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


def _patch_colr_matrix(data: bytes, matrix: int) -> bytes:
    """Re-tag an AVIF's nclx matrix (``tests/test_avif_native.py``)."""
    i = data.find(b"colrnclx")
    assert i > 0
    off = i + 8 + 4
    return data[:off] + matrix.to_bytes(2, "big") + data[off + 2:]


def _rgba_avif(w=96, h=64, q=85) -> bytes:
    rng = np.random.default_rng(5)
    a = np.clip(rng.normal(170, 60, (h, w)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.fromarray(np.dstack([synth(w, h, seed=4), a]), "RGBA").save(
        buf, "AVIF", quality=q)
    return buf.getvalue()


def _mono(w=96, h=64, full_range=False) -> bytes:
    from tests.test_avif_native import _mono_avif

    return _mono_avif(synth(w, h, seed=6)[:, :, 0], q=85,
                      full_range=full_range)


SOURCES = {
    "420": lambda: pillow_avif(synth(160, 96, seed=1), quality=70),
    "422": lambda: pillow_avif(synth(160, 96, seed=2), quality=70,
                               subsampling="4:2:2"),
    "444": lambda: pillow_avif(synth(160, 96, seed=3), quality=70,
                               subsampling="4:4:4"),
    "odd_420": lambda: pillow_avif(synth(97, 51, seed=7), quality=60),
    "rgba": _rgba_avif,
    "bt709": lambda: _patch_colr_matrix(
        pillow_avif(synth(160, 96, seed=8), quality=80), 1),
    "mono": _mono,
    "mono_full": lambda: _mono(full_range=True),
    "own": lambda: avif_encode.encode_rgb(synth(120, 80, seed=9), 70),
    "own_rgba": lambda: avif_encode.encode_rgb(np.dstack(
        [synth(120, 80, seed=10), np.full((80, 120), 77, np.uint8)]), 70),
    "palette": lambda: _palette(),
    "intrabc": lambda: _intrabc(),
    "10bit_420": lambda: _ten_bit(),
    "12bit_444": lambda: _hbd(12, "444"),
}


# -- the module -----------------------------------------------------------------


@needs_oracles
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_container_and_probe_match_the_reference(name):
    data = SOURCES[name]()
    a, b = avif_native.parse_container(data), ref_avif.parse_container(data)
    for f in ("width", "height", "obu", "has_alpha", "alpha_obu",
              "alpha_size", "matrix", "full_range", "has_nclx",
              "high_bitdepth", "monochrome", "chroma_sub_x", "chroma_sub_y",
              "crop"):
        assert getattr(a, f) == getattr(b, f), f
    assert avif_native.header_dimensions(data) == ref_avif.header_dimensions(
        data)
    got, _ = port_codecs.decode_bytes(data, device="cpu")
    assert np.array_equal(got, ref_codecs.decode_bytes(data)[0])


@needs_oracles
@pytest.mark.parametrize("want_alpha", [True, False])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_studio_planes_match_the_reference(name, want_alpha):
    data = SOURCES[name]()
    got = avif_native.decode_yuv_studio(data, want_alpha=want_alpha)
    want = ref_avif.decode_yuv_studio(data, want_alpha=want_alpha)
    assert got is not None and want is not None
    for f in ("y", "u", "v", "alpha"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert np.array_equal(g, w), f
    assert (got.csy, got.csx, got.bt709) == (want.csy, want.csx, want.bt709)
    assert (avif_native.decode_yuv420_studio(data) is None) == (
        ref_avif.decode_yuv420_studio(data) is None)


@needs_oracles
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_pixels_match_the_reference(name):
    data = SOURCES[name]()
    got, fmt = port_codecs.decode_bytes(data, device="cpu")
    want, _ = ref_codecs.decode_bytes(data)
    assert fmt == port_codecs.SourceFormat.avif
    assert np.array_equal(got, want)
    assert np.array_equal(avif_native.decode_rgb(data),
                          ref_avif.decode_rgb(data))


def _premultiplied() -> bytes:
    data = _rgba_avif(64, 48)
    i = data.find(b"auxl")
    return data[:i] + b"prem" + data[i + 4:]


def _rescaled() -> bytes:
    """A 64 x 48 stream in an item whose ispe says 96 x 64: libavif (and
    so the reference, through Pillow) rescales it, and so does the port."""
    from tests.fixtures.make_avif_sources import demux, mux

    doc = demux(pillow_avif(synth(64, 48), quality=60))
    doc["items"][0]["props"] = [
        (b"\0\0\0\x14ispe\0\0\0\0\0\0\0\x60\0\0\0\x40", e)
        if box[4:8] == b"ispe" else (box, e)
        for box, e in doc["items"][0]["props"]]
    return mux(doc)


def _palette() -> bytes:
    flat = np.zeros((96, 128, 3), np.uint8)
    flat[::8] = 255
    flat[:, ::16] = (200, 30, 30)
    return pillow_avif(flat, quality=60, advanced=[("tune-content", "screen")])


def _intrabc() -> bytes:
    from tests.test_torch_av1_screen_hbd import ui_text

    return pillow_avif(ui_text(256, 96, seed=4), quality=60)


def _hbd(depth: int, layout: str) -> bytes:
    from tests.test_torch_av1_screen_hbd import hbd_file

    return hbd_file(120, 88, depth, layout, 20, depth)


def _ten_bit() -> bytes:
    """A 10-bit AVIF by libavif (the JAX package's test writer)."""
    from tests.test_avif_native import _encode_avif_10bit

    rng = np.random.default_rng(9)
    y10 = (np.linspace(64, 940, 120)[None, :] + rng.normal(0, 10, (88, 120))
           ).clip(64, 940).astype(np.uint16)
    data = _encode_avif_10bit(y10, np.full((44, 60), 440, np.uint16),
                              np.full((44, 60), 560, np.uint16))
    if data is None:
        pytest.skip("libavif's 10-bit encode unavailable")
    return data


#: name -> (writer, the reason of the 501, or None for a file the port
#: now serves as the reference does)
REMAINDER = {
    "palette": (_palette, None),
    "intrabc": (_intrabc, None),
    "film_grain": (lambda: pillow_avif(synth(256, 192, seed=9), quality=60,
                                       advanced=[("film-grain-test",
                                                  "4")]), None),
    "qm": (lambda: pillow_avif(synth(128, 96), quality=60,
                               advanced=[("enable-qm", "1")]), None),
    "premultiplied": (_premultiplied, None),
    "10bit": (lambda: _ten_bit(), None),
    "identity_matrix": (lambda: _patch_colr_matrix(
        pillow_avif(synth(64, 48), quality=70, subsampling="4:4:4"), 0),
        None),
}


@needs_oracles
@pytest.mark.parametrize("name", sorted(REMAINDER))
def test_the_remainder_answers_501(name):
    """Palette blocks, intra block copy, 10-bit streams, film grain and
    quantizer matrices, which answered 501 before the decoder built them,
    and the files the reference's native path hands to Pillow's libavif
    (premultiplied alpha, the identity matrix), which answered 501 before
    ``codecs/avif_libavif.py``, decode as the reference decodes them."""
    make, reason = REMAINDER[name]
    data = make()
    arr, _ = ref_codecs.decode_bytes(data)
    assert arr.ndim == 3
    if reason is None:
        got, fmt = port_codecs.decode_bytes(data, device="cpu")
        assert fmt == port_codecs.SourceFormat.avif
        assert np.array_equal(got, arr)
        return
    with pytest.raises(NotPortedError, match=reason) as e:
        port_codecs.decode_bytes(data, device="cpu")
    assert "queue 1 item 8" in str(e.value)


@needs_oracles
@pytest.mark.parametrize("cut", ["truncated", "zeroed", "flipped",
                                 "no_meta"])
def test_undecodable_files_fail_as_the_reference(cut):
    data = pillow_avif(synth(64, 48), quality=60)
    obu = ref_avif.parse_container(data).obu
    bad = {
        "truncated": data[:-20],
        "zeroed": data[:-len(obu)] + b"\0" * len(obu),
        "flipped": data[:-len(obu) + 10]
        + bytes(x ^ 0x55 for x in data[-len(obu) + 10:]),
        "no_meta": data[:32],
    }[cut]
    with pytest.raises(TransformError) as got:
        port_codecs.decode_bytes(bad, device="cpu")
    with pytest.raises(Exception) as want:
        ref_codecs.decode_bytes(bad)
    assert str(want.value).startswith(str(got.value))


# -- the heads against the JAX heads -----------------------------------------------

BH, BW, OBH, OBW = 96, 160, 48, 80
IH, IW, OH, OW = 95, 157, 44, 73


def _flat(cs, alpha, B=2, seed=0):
    rng = np.random.default_rng(seed)
    ch, cw = BH // cs[0], BW // cs[1]
    ny, nc = BH * BW, ch * cw
    flat = np.zeros((B, pad128(ny + 2 * nc + (ny if alpha else 0))), np.uint8)
    flat[:, :ny + 2 * nc + (ny if alpha else 0)] = rng.integers(
        16, 236, (B, ny + 2 * nc + (ny if alpha else 0)))
    return flat


def _weights(cs, mix, jpeg=False):
    """The JAX engine's stacks for one geometry (``engine_yuv.py:223``)."""
    ch_b, cw_b = BH // cs[0], BW // cs[1]
    ch_, cw_ = (IH + cs[0] - 1) // cs[0], (IW + cs[1] - 1) // cs[1]
    w = [ref_padded(IH, OH, BH, OBH)[None], ref_padded(IW, OW, BW, OBW)[None],
         ref_half(ch_, IH, OH, ch_b, OBH // 2)[None],
         ref_half(cw_, IW, OW, cw_b, OBW // 2)[None]]
    if mix:
        w += [ref_full(ch_, IH, OH, ch_b, OBH)[None],
              ref_full(cw_, IW, OW, cw_b, OBW)[None]]
    return [np.ascontiguousarray(x, np.float32) for x in w]


@pytest.mark.parametrize("mix", [False, True], ids=["601", "709"])
@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha"])
@pytest.mark.parametrize("cs", [(2, 2), (1, 2), (1, 1)],
                         ids=["420", "422", "444"])
def test_yuv420_head_against_the_jax_head(cs, alpha, mix):
    flat = _flat(cs, alpha)
    weights = _weights(cs, mix)
    vidx = np.zeros(2, np.int32)
    want = ref_dct.resize_yuv420_batch(flat, weights, vidx, (BH, BW),
                                       (OBH, OBW), chroma_sub=cs, mix=mix,
                                       alpha=alpha)
    got = dct.resize_yuv420_batch(flat, weights, vidx, (BH, BW), (OBH, OBW),
                                  chroma_sub=cs, mix=mix, alpha=alpha,
                                  device="cpu")
    B = flat.shape[0]
    want = np.asarray(want).reshape(B, -1) if not isinstance(
        want, tuple) else np.concatenate(
            [np.asarray(p).reshape(B, -1) for p in want], 1)
    got = np.concatenate([np.asarray(p).reshape(B, -1) for p in got], 1)
    assert_band(got, want, f"{cs} alpha={alpha} mix={mix}")


@pytest.mark.parametrize("mix", [False, True], ids=["601", "709"])
def test_yuv_jpeg_head_against_the_jax_head(mix):
    from imagekit_tpu_torch.ops.weights import quality_tables

    flat = _flat((2, 2), False, seed=3)
    weights = _weights((2, 2), mix)
    # the engine's JPEG stacks replicate the last true row to the MCU grid
    for w, n in zip(weights, (OH, OW, (OH + 1) // 2, (OW + 1) // 2, OH, OW)):
        w[0, n:] = w[0, n - 1]
    qto = np.zeros((2, 128), np.float32)
    qto[:, :64], qto[:, 64:] = quality_tables(80)
    vidx = np.zeros(2, np.int32)
    want = ref_dct.resize_yuv_jpeg_batch(flat, weights, qto, vidx, (BH, BW),
                                         (OBH, OBW), mix=mix)
    got = dct.resize_yuv_jpeg_batch(flat, weights, qto, vidx, (BH, BW),
                                    (OBH, OBW), mix=mix, device="cpu")
    for name, g, w in zip(("y", "cb", "cr"), got, want):
        assert_band(g, w, f"{name} mix={mix}")


# -- K2's new entries under the CPU shim --------------------------------------------


def _views(B, cs, alpha, seed):
    ch, cw = 48 // cs[0], 64 // cs[1]
    ny, nc = 48 * 64, ch * cw
    flat = torch.from_numpy(
        _images(B, 1, 2 * ny + 2 * nc + 128, seed=seed)[:, 0])
    return flat, dct.yuv_planes(flat, 48, 64, cs, alpha)


def _launch(lib, entry, planes, pairs, v, f32):  # noqa: F811
    recs, outs, tabs = [], [], []
    for p, (wv, wh) in zip(planes, pairs):
        oh, ow = wv.shape[1], wh.shape[1]
        out = torch.empty((p.shape[0], oh, ow),
                          dtype=torch.float32 if f32 else torch.uint8)
        tabs.append(resize_tables(wv, wh))
        recs.append(plane_record(p.data_ptr(), p.stride(0), p.shape[2], 1,
                                 wv, tabs[-1], v, v, out, oh * ow, 0,
                                 *p.shape[1:]))
        outs.append(out)
    args = (None,) if f32 else (0, None)
    _build.launch_band(getattr(lib, entry), recs, planes[0].shape[0], *args)
    return outs


def _k2_stacks(cs, mix):
    ch, cw = 48 // cs[0], 64 // cs[1]
    s = [_stack(48, 20, 48, 20, 3), _stack(64, 27, 64, 28, 3),
         _stack(ch, 10, ch, 10, 3), _stack(cw, 14, cw, 14, 3)]
    if mix:
        s += [_stack(ch, 20, ch, 20, 3), _stack(cw, 27, cw, 28, 3)]
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in s]


@pytest.mark.parametrize("cs, alpha", [((1, 1), True), ((1, 2), True),
                                       ((1, 1), False), ((2, 2), True)],
                         ids=["444_alpha", "422_alpha", "444", "420_alpha"])
def test_k2_yuv_planes_in_any_layout_with_alpha(lib, cs, alpha):  # noqa: F811
    """Y, Cb, Cr of any chroma factors and the alpha plane, as views of
    one flat batch, in one launch of K2's u8 entry: equal to
    ``yuv_resize_plain``."""
    v = torch.tensor([0, 2, 1], dtype=torch.int32)
    _flat_, planes = _views(3, cs, alpha, seed=21)
    stacks = _k2_stacks(cs, False)
    pairs = resize_strip._yuv_pairs(stacks, len(planes))
    outs = _launch(lib, "ik_resize_strip", planes, pairs, v, False)
    wants = resize_strip.yuv_resize_plain(planes, stacks, v)
    again = resize_strip.yuv_resize(planes, stacks, v)
    assert len(outs) == len(wants) == 3 + alpha
    for got, want, w2 in zip(outs, wants, again):
        assert torch.equal(got, want) and torch.equal(w2, want)


@pytest.mark.parametrize("alpha", [False, True])
def test_k2_f32_entry_takes_a_bt709_batch(lib, alpha):  # noqa: F811
    """The six resizes of a BT.709 batch (Y, chroma to the full and the
    half grid, alpha) in one launch of K2's f32 entry, against
    ``yuv_mix_resize_plain``."""
    cs = (2, 2)
    v = torch.tensor([1, 0], dtype=torch.int32)
    _flat_, planes = _views(2, cs, alpha, seed=22)
    stacks = _k2_stacks(cs, True)
    srcs = [planes[0], planes[1], planes[2], planes[1], planes[2]] + list(
        planes[3:])
    pairs = resize_strip._mix_pairs(stacks, len(planes))
    outs = _launch(lib, "ik_resize_strip_f32", srcs, pairs, v, True)
    wants = resize_strip.yuv_mix_resize_plain(planes, stacks, v)
    assert len(outs) == len(wants) == 5 + alpha
    for got, want in zip(outs, wants):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=255e-5)


def test_yuv_entry_names():
    y = torch.zeros(1, 32, 64, dtype=torch.uint8)
    c420 = torch.zeros(1, 16, 32, dtype=torch.uint8)
    c444 = torch.zeros(1, 32, 64, dtype=torch.uint8)
    c422 = torch.zeros(1, 32, 32, dtype=torch.uint8)
    assert resize_strip.yuv_entry((y, c420, c420)) == "420"
    assert resize_strip.yuv_entry((y, c422, c422, y)) == "422+a"
    assert resize_strip.yuv_entry((y, c444, c444), mix=True) == "444+mix"


# -- the engines -------------------------------------------------------------------


def _sig(name, data, width, jq):
    info = ref_avif.parse_container(data)
    out = ref_avif.decode_yuv_studio(data, want_alpha=False)
    ow, oh = target_dimensions(info.width, info.height, width, None)

    def sig(ref, nb):
        return ("yuvjpg" if jq else "yuvsrc", ref._use_mesh(nb), nb,
                bucket_for(info.height), bucket_for(info.width),
                bucket_for(oh), bucket_for(ow), out.csy, out.csx, out.bt709,
                name == "rgba_avif")
    return sig


ENGINE_CASES = {
    "420_webp": ("420", ImageFormat.webp),
    "420_jpeg": ("420", ImageFormat.jpeg),
    "422_webp": ("422", ImageFormat.webp),
    "444_avif": ("444", ImageFormat.avif),
    "rgba_avif": ("rgba", ImageFormat.avif),
    "rgba_webp": ("rgba", ImageFormat.webp),
    "bt709_webp": ("bt709", ImageFormat.webp),
    "bt709_jpeg": ("bt709", ImageFormat.jpeg),
    "mono_webp": ("mono", ImageFormat.webp),
}


@needs_oracles
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_the_jax_engine(monkeypatch, case):
    """One batch of an AVIF source through both engines' YUV heads: the
    same bodies (the port's plain heads and the JAX heads agree on these
    planes), alpha kept in AVIF output only."""
    src, fmt = ENGINE_CASES[case]
    data = SOURCES[src]()
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    calls = _capture(monkeypatch, engine_yuv,
                     "resize_yuv_jpeg_batch" if fmt == ImageFormat.jpeg
                     else "resize_yuv420_batch")
    width = 64
    sig = _sig("rgba_avif" if case == "rgba_avif" else case, data, width,
               fmt == ImageFormat.jpeg)
    (ref_out,), (port_out,) = run_engines(monkeypatch, [data], [width], fmt,
                                          sig)
    assert len(calls) == 1
    assert port_out == ref_out
    if fmt == ImageFormat.avif:
        out = avif_native.parse_container(port_out)
        assert out.has_alpha == (src == "rgba")


@needs_oracles
def test_444_to_jpeg_takes_the_pixel_decode(monkeypatch):
    """The fDCT head takes 4:2:0 only: 4:4:4 to JPEG decodes to pixels and
    rides the RGB head, in both engines."""
    data = SOURCES["444"]()
    yuv = _capture(monkeypatch, engine_yuv, "resize_yuv_jpeg_batch")

    def sig(ref, nb):
        return ("rgbjpg", ref._use_mesh(nb), nb, bucket_for(96),
                bucket_for(160), bucket_for(38), bucket_for(64), 3)

    (ref_out,), (port_out,) = run_engines(monkeypatch, [data], [64],
                                          ImageFormat.jpeg, sig)
    assert not yuv
    assert port_out[:2] == ref_out[:2] == b"\xff\xd8"


# -- the apps -----------------------------------------------------------------------


async def _upload(client, data, **fields):
    form = FormData()
    form.add_field("file", data, filename="x.avif")
    for k, v in fields.items():
        form.add_field(k, str(v))
    r = await client.post("/upload", data=form)
    return r.status, r.headers.get("Content-Type"), await r.read()


@needs_oracles
@pytest.mark.parametrize("name", ["420", "rgba", "bt709"])
def test_img_and_upload_serve_as_the_reference(monkeypatch, tmp_path, name):
    """``/img`` and ``/upload`` at w=64 to WebP, JPEG and AVIF: the same
    statuses, types and bodies through both apps."""
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    data = SOURCES[name]()

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
            # the JPEG heads agree within +-1 on <= 0.1% of their levels
            # (test_yuv_jpeg_head_against_the_jax_head), and the Huffman
            # tables are the image's own: the bodies may differ
            assert _out_size(pb) == _out_size(rb)
            assert psnr(_decoded(pb), _decoded(rb)) >= 45.0
        else:
            assert pb == rb


@needs_oracles
def test_the_remainder_and_hostile_files_over_http(tmp_path):
    """A palette AVIF is served through both apps alike (it answered 501
    before the decoder built palettes), and so is one whose stream is
    smaller than its ispe (the reference serves it through Pillow's
    libavif, which rescales it; the port answered 501 before its scaler);
    a truncated one 400 through both apps, in the same words."""
    good = pillow_avif(synth(64, 48), quality=60)
    sources = {"pal": _palette(), "cut": good[:-20],
               "scaled": _rescaled()}

    async def fn(client):
        return [await _img(client, url=_url("pal"), w=32),
                await _img(client, url=_url("cut"), w=32),
                await _img(client, url=_url("scaled"), w=32)]

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    assert ref[0][:2] == port[0][:2] and port[0][0] == 200
    assert _out_size(port[0][2]) == _out_size(ref[0][2])
    if port[0][2] != ref[0][2]:
        assert psnr(_decoded(port[0][2]), _decoded(ref[0][2])) >= 45.0
    assert port[1] == ref[1] and port[1][0] == 400
    assert ref[2][:2] == port[2][:2] and port[2][0] == 200
    assert port[2][2] == ref[2][2]


def test_fetch_probes_avif_dimensions():
    from imagekit_tpu_torch import fetch
    from imagekit_tpu_torch.errors import InvalidArgumentError
    from tests.test_torch_pillow_sources import _CannedFetcher

    data = avif_encode.encode_rgb(synth(40, 30), 60)

    async def run(d):
        return await fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/avif", d)}))

    assert asyncio.run(run(data))[0] == data
    with pytest.raises(InvalidArgumentError, match="validation"):
        asyncio.run(run(data[:40]))


def test_webp_output_drops_alpha_on_the_cpu():
    """Straight through the port's engine: an alpha AVIF to WebP has no
    alpha (VP8 out), to AVIF keeps it."""
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    data = avif_encode.encode_rgb(np.dstack(
        [synth(96, 64), np.full((64, 96), 60, np.uint8)]), 70)

    async def run():
        eng = BatchedEngine(device="cpu")
        try:
            return [await eng.transform(data, 48, None, f, 80)
                    for f in (ImageFormat.webp, ImageFormat.avif)]
        finally:
            await eng.close()

    webp, avif = asyncio.run(run())
    assert webp[:4] == b"RIFF" and vp8.dimensions(webp) == (48, 32)
    assert avif_native.parse_container(avif).has_alpha


# -- the committed sources of chip_smoke.py's phase 27 ------------------------------

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "avif"


def _fixture_table() -> dict:
    return json.loads((FIXTURES / "avif_planes.json").read_text())


@pytest.mark.parametrize("name", sorted(_fixture_table()))
def test_committed_fixtures_hold_the_port_to_libdav1d(name):
    """``tests/fixtures/avif/`` (``make_avif_sources.py``): the recorded
    digests are libdav1d's planes of each file, and the port's decoder
    gives the same planes (phase 27 checks the latter on the card's host,
    where there is no libdav1d)."""
    import hashlib

    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    entry = _fixture_table()[name]
    data = (FIXTURES / entry["file"]).read_bytes()
    info = avif_native.parse_container(data)
    assert (info.width, info.height) == (entry["width"], entry["height"])
    head = av1_dec_abi.probe(info.obu)
    assert (head.qmatrix, head.film_grain, head.superres_denom) == (
        entry["qmatrix"], entry["film_grain"], entry["superres_denom"])
    ours = hashlib.sha256()
    for p in av1_dec_abi.decode(info.obu)[:3]:
        ours.update(p.tobytes())
    if info.alpha_obu:
        ours.update(av1_dec_abi.decode(info.alpha_obu)[0].tobytes())
    assert ours.hexdigest() == entry["sha256"]
    if "sha256_samples" in entry:  # 10 and 12 bits: the raw planes too
        raw = hashlib.sha256()
        for p in av1_dec_abi.decode_samples(info.obu)[:3]:
            raw.update(p.astype("<u2").tobytes())
        assert raw.hexdigest() == entry["sha256_samples"]
        if ref_avif.decode_available():
            from tests.fixtures.make_avif_sources import samples_digest

            assert samples_digest(data) == entry["sha256_samples"]
    if ref_avif.decode_available():
        want = hashlib.sha256()
        y, u, v = ref_avif._decode_obu(info.obu, info.width, info.height)[:3]
        for p in (y, u, v):
            want.update(p.tobytes())
        if info.alpha_obu:
            want.update(ref_avif._decode_obu(info.alpha_obu, info.width,
                                             info.height)[0].tobytes())
        assert want.hexdigest() == entry["sha256"]
