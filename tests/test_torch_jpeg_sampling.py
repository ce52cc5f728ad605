"""JPEG layouts the reference decoded with Pillow that the port answered 501
for, in the port, on the CPU: chroma ratios of 3 and 4 (4:1:1 is Y 4x1,
4:1:0 Y 4x2, and Y 3x1), Cb and Cr sampled differently (Cb 1x1 and Cr 2x1
under Y 2x2), a luma below the largest factors (Y 1x1 under Cb 2x2), and
baseline frames in one scan a component (4:2:0, 4:4:4, CMYK), with and
without restart intervals; and what Pillow refuses (a fractional ratio, an
interleaved scan of more than 10 blocks an MCU, a 12-bit frame), which
answers 400 as in the reference.

No encoder here writes these files, so ``tests/fixtures/jpeg_writer.py``
(numpy) writes them from coefficients; the oracle of the pixels is the JAX
package's ``decode_bytes`` (Pillow, through ``pil_backend.decode``).

- The writer: where the pinned decoder takes a file, it returns the
  coefficients written, exactly; the port's decoder returns them for the
  files in several scans, the blocks no scan codes zero.
- The k=8 heads' float IDCT (``_blocks_to_plane``) within +-1 on <= 0.1%
  of values of the JAX package's; the stacks of the lossless frames
  exactly their numpy mirrors (libjpeg's choice of upsample from the pair
  of ratios, replication at floor(i / r), the triangle stopping at the
  component's real size); K6's replication exact.
- The decode against Pillow byte for byte (K6 is libjpeg-turbo's integer
  decode), at 48x32 to 96x64 and at 1080p.
- Both engines and both apps, at w=64 and with no resize, WebP and JPEG
  out: statuses equal, outputs decoded within 38 dB.
- Fractional ratios, over-large MCUs and 12-bit frames: status and body
  equal to the reference app's on ``/img`` and ``/upload`` (Pillow's
  message on ``/upload`` of a 12-bit frame carries an object's address, so
  there the status alone).
- ``jpeg4_decode.cpp``'s scans under AddressSanitizer and UBSan.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu_torch import codecs, fetch
from imagekit_tpu_torch.codecs import jpeg
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import InvalidArgumentError, SourceDecodeError
from imagekit_tpu_torch.ops import dct, jpeg_pixels, weights
from tests.conftest import make_test_image
from tests.fixtures import jpeg_writer
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import (
    MODES,
    _decoded,
    _img,
    _mode_id,
    _out_size,
    _run_engines,
    _serve,
    _url,
    psnr,
)
from tests.test_torch_webp_slice import _CannedFetcher

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "imagekit_tpu_torch" / "codecs" / "native"
MAX_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


#: name -> the (h, v) factors of Y, Cb, Cr
SAMPLINGS = {
    "411": ((4, 1), (1, 1), (1, 1)),
    "410": ((4, 2), (1, 1), (1, 1)),
    "y3x1": ((3, 1), (1, 1), (1, 1)),
    "cb11_cr21": ((2, 2), (1, 1), (2, 1)),
    "y11_under_c22": ((1, 1), (2, 2), (2, 2)),
    "420": ((2, 2), (1, 1), (1, 1)),
    "444": ((1, 1), (1, 1), (1, 1)),
}
#: layouts of one interleaved scan the pinned decoder takes (the first
#: five), and the frames in one scan a component only the port's takes
CASES = ([(n, True, 0) for n in list(SAMPLINGS)[:5]]
         + [(n, False, r) for n in SAMPLINGS for r in (0, 3)])
SIZES = [(96, 64), (61, 37), (48, 32)]


def _case_id(case):
    name, inter, restart = case
    return f"{name}-{'one_scan' if inter else 'a_scan_each'}-rst{restart}"


def written(case, size=(96, 64), quality=90, seed=0):
    """The case's file from a test picture: (bytes, the planes written,
    their geometry)."""
    name, inter, restart = case
    w, h = size
    img = make_test_image(w, h) if seed == 0 else _photo(w, h, seed)
    planes, tabs, tq = jpeg_writer.coefficients(img, quality,
                                                SAMPLINGS[name])
    data = jpeg_writer.write(planes, tabs, w, h, SAMPLINGS[name], tq, inter,
                             restart)
    return data, planes, img


def _photo(w, h, seed):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, w)[None, :, None]
    y = np.linspace(0, 1, h)[:, None, None]
    ph = rng.random(3)
    img = 128 + 90 * np.sin(2 * np.pi * (x * (1 + ph) + y * (1.5 - ph)))
    return np.clip(img + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)


def _coded(planes, size, samp, inter):
    """The planes a decoder returns: a component in a scan of its own has
    its MCU-padding blocks uncoded, zero."""
    if inter:
        return planes
    _, real = jpeg_writer.grids(*size, samp)
    out = []
    for p, (ch, cw) in zip(planes, real):
        p = p.copy()
        p[-(-ch // 8):] = 0
        p[:, -(-cw // 8):] = 0
        out.append(p)
    return out


# -- the writer and the entropy decode -----------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decoders_return_the_coefficients_written(case, size):
    name, inter, _ = case
    data, planes, _ = written(case, size)
    hdr, coeffs, _ = jpeg.decode_to_coefficients(data)
    assert hdr.port_decoder is not inter
    want = _coded(planes, size, SAMPLINGS[name], inter)
    for c in range(3):
        assert np.array_equal(coeffs[c], want[c]), c
    if inter:  # the pinned decoder itself
        _, pinned, _ = jpeg_abi.decode(loader.load(), data)
        assert all(np.array_equal(a, b) for a, b in zip(pinned, planes))
    else:
        with pytest.raises(jpeg_abi.NativeJpegError) as e:
            jpeg_abi.parse(loader.load(), data)
        assert e.value.code == -3


def test_cmyk_in_a_scan_a_component():
    """A Pillow CMYK JPEG's coefficients and tables rewritten in one scan a
    component (and with restarts) decode to the same coefficients and the
    same pixels as Pillow's file."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(96, 64)).convert("CMYK").save(
        buf, "JPEG", quality=90, subsampling=2)
    src = buf.getvalue()
    hdr, coeffs, qtabs = jpeg_abi.decode4(loader.load(), src)
    samp = list(zip(hdr.comp_h, hdr.comp_v))
    for restart in (0, 2):
        data = jpeg_writer.write(coeffs, qtabs, 96, 64, samp, hdr.comp_tq,
                                 interleaved=False, restart=restart,
                                 adobe_transform=hdr.adobe_transform)
        h2, c2, _ = jpeg.decode_to_coefficients(data)
        assert h2.port_decoder and h2.ncomp == 4
        want = _coded(coeffs, (96, 64), samp, False)
        assert all(np.array_equal(a, b) for a, b in zip(c2, want))
        got = codecs.decode_bytes(data, device="cpu")[0]
        ref = ref_codecs.decode_bytes(data)[0]
        assert np.array_equal(got, codecs.decode_bytes(src, device="cpu")[0])
        assert np.array_equal(got, ref)


# -- the pixel decode --------------------------------------------------------------


def _jax_idct(coeffs, qtab) -> np.ndarray:
    import jax.numpy as jnp

    by, bx = coeffs.shape[:2]
    return np.asarray(ref_dct._blocks_to_plane(
        jnp.asarray(coeffs.reshape(1, by, -1)), by, bx,
        jnp.asarray(qtab[None], jnp.float32),
        jnp.asarray(ref_dct.idct_basis())).astype(jnp.uint8))[0]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_idct_planes_are_the_jax_packages(case):
    data, _, _ = written(case, (61, 37))
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(data)
    for c in range(3):
        by, bx = coeffs[c].shape[:2]
        qt = qtabs[hdr.comp_tq[c]]
        got = dct._blocks_to_plane(
            torch.from_numpy(coeffs[c].reshape(1, by, -1)), by, bx,
            torch.from_numpy(qt[None].astype(np.float32)))[0].numpy()
        want = _jax_idct(coeffs[c], qt)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE, c


def _mirror(full, grid, real, method):
    """numpy mirrors of the stacks of one component: replication at
    floor(i / r) up to the real size; the triangle 3/4 near, 1/4 far, its
    edges at the real size."""
    out = []
    tri = {"h2v1": (False, True), "h1v2": (True, False),
           "h2v2": (True, True)}.get(method, (False, False))
    for f, g, r, t in zip(full, grid, real, tri):
        m = np.zeros((f * 8, g * 8), np.float32)
        for o in range(f * 8):
            if t:
                i = o // 2
                far = i - 1 if o % 2 == 0 else i + 1
                m[o, min(i, r - 1)] += 0.75
                m[o, min(max(far, 0), r - 1)] += 0.25
            else:
                m[o, min(o // (f // g), r - 1)] = 1
        out.append(m)
    return out


#: (ratio, width) -> libjpeg-turbo's choice (jdsample.c::jinit_upsampler)
METHODS = {((1, 1), 9): "full", ((2, 1), 9): "h2v1", ((2, 1), 2): "int",
           ((1, 2), 1): "h1v2", ((2, 2), 9): "h2v2", ((2, 2), 2): "int",
           ((4, 1), 9): "int", ((3, 1), 9): "int", ((2, 4), 9): "int",
           ((4, 2), 9): "int", ((1, 4), 9): "int"}


@pytest.mark.parametrize("ratio,width", list(METHODS),
                         ids=lambda x: str(x))
def test_upsample_method_is_libjpegs(ratio, width):
    assert weights.upsample_method(ratio, width) == METHODS[(ratio, width)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_stacks_are_their_numpy_mirrors(case):
    data, _, _ = written(case, (61, 37))
    hdr, coeffs, _ = jpeg.decode_to_coefficients(data)
    grids = [c.shape[:2] for c in coeffs]
    full = (max(g[0] for g in grids), max(g[1] for g in grids))
    for c, grid in enumerate(grids):
        ratio = (hdr.hmax // hdr.comp_h[c], hdr.vmax // hdr.comp_v[c])
        method = weights.upsample_method(ratio, hdr.comp_width[c])
        real = (hdr.comp_height[c], hdr.comp_width[c])
        got = weights.component_stacks(full, grid, real, method)
        for a, b in zip(got, _mirror(full, grid, real, method)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


def test_replication_stacks_on_k3s_plain_version_are_exact():
    """Replication moves samples exactly: K6's plain version on a 4:1:1
    frame (no colour step) is the luma's IDCT plane and the numpy repeat of
    the chroma's, 4x across (libjpeg's ``int_upsample``; the name is kept
    from when K3 ran the replication stacks)."""
    data, _, _ = written(("411", True, 0), (96, 64))
    hdr, coeffs, qtabs = jpeg.decode_to_coefficients(data)
    x = jpeg_pixels.upload(jpeg_pixels.frame_plan(hdr, coeffs, qtabs,
                                                  jpeg_pixels.NONE),
                           torch.device("cpu"))
    out = jpeg_pixels.decode_pixels_plain(x).numpy()
    for c in range(3):
        p = jpeg_pixels.idct_plain(x.coeffs[c], x.qt[c]).numpy()
        want = np.repeat(p, 4 if c else 1, 1)[:64, :96]
        assert np.array_equal(out[..., c], want), c


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decode_against_pillow(case, size):
    data, _, _ = written(case, size, seed=7)
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape == (size[1], size[0], 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", [("411", True, 0), ("420", False, 0)],
                         ids=_case_id)
def test_decode_against_pillow_at_1080p(case):
    data, _, _ = written(case, (1920, 1080), quality=80, seed=3)
    got = codecs.decode_bytes(data, device="cpu")[0]
    want = ref_codecs.decode_bytes(data)[0]
    assert got.shape == want.shape == (1080, 1920, 3)
    assert np.array_equal(got, want)


def test_one_k3_launch_a_request(monkeypatch):
    """The pixel decode of each layout runs K6 once, three components in
    one decode (two launches on a card, its plain version on the CPU; the
    name is kept from when K3 ran it)."""
    from tests.test_torch_jpeg_pixels import count_k6

    calls = count_k6(monkeypatch)
    for case in CASES:
        calls.clear()
        codecs.decode_bytes(written(case, (48, 32))[0], device="cpu")
        assert calls == [3], case


# -- what Pillow refuses -------------------------------------------------------------


REFUSED = {
    "fractional": lambda: jpeg_writer.encode(
        make_test_image(64, 48), 85, ((3, 1), (2, 1), (2, 1))),
    "fractional_a_scan_each": lambda: jpeg_writer.encode(
        make_test_image(64, 48), 85, ((3, 1), (2, 1), (2, 1)),
        interleaved=False),
    "mcu_18_blocks": lambda: jpeg_writer.encode(
        make_test_image(64, 48), 85, ((4, 4), (1, 1), (1, 1))),
    "mcu_11_blocks": lambda: jpeg_writer.encode(
        make_test_image(64, 48), 85, ((3, 3), (1, 1), (1, 1))),
    "12bit": lambda: _sof_precision(12),
}


def _sof_precision(bits):
    from tests.test_torch_jpeg_layouts import _sof_patched

    return _sof_patched(0, bits)


async def _both(client, data):
    from aiohttp import FormData

    outs = [await _img(client, url=_url("x"), w=w) for w in (64, None)]
    for w in ("64", None):
        form = FormData()
        form.add_field("file", data, filename="x.jpg")
        if w:
            form.add_field("w", w)
        r = await client.post("/upload", data=form)
        outs.append((r.status, r.headers.get("Content-Type"),
                     await r.read()))
    return outs


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_pillow_refuses_answers_as_the_reference(tmp_path, name):
    data = REFUSED[name]()
    sources = {"x": data}
    ref = _serve(tmp_path, "ref", sources, lambda c: _both(c, data))
    port = _serve(tmp_path, "port", sources, lambda c: _both(c, data))
    assert [o[0] for o in port] == [o[0] for o in ref] == [400] * 4
    if name == "12bit":  # Pillow's message names a BytesIO's address
        assert port[:2] == ref[:2]
        assert all(b"cannot identify image file" in o[2] for o in port[2:])
    else:
        assert port == ref


def test_a_scan_with_more_than_10_blocks_is_refused_by_the_port_decoder():
    """A CMYK frame in one interleaved scan of 16 blocks an MCU (every
    component 2x2): -8 at the header, the fetch stage's 400, Pillow's
    message in the engine."""
    coeffs = [np.zeros((4, 6, 64), np.int16) for _ in range(4)]
    q = np.ones(64, np.uint16)
    data = jpeg_writer.write(coeffs, (q, q), 48, 32, [(2, 2)] * 4)
    with pytest.raises(jpeg_abi.NativeJpegError) as e:
        jpeg_abi.parse_any(loader.load(), data)
    assert e.value.code == -8 and e.value.four_components
    with pytest.raises(SourceDecodeError, match="broken data stream"):
        jpeg.decode_to_coefficients(data)
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    import asyncio

    with pytest.raises(InvalidArgumentError, match="validation"):
        asyncio.run(fetch.fetch_source(
            "u", 1 << 24, fetcher=_CannedFetcher({"u": ("image/jpeg", data)})))


def test_sampling_refused_is_libjpegs_rule():
    def hdr(samp, port=False, progressive=False):
        h, v = zip(*samp)
        return jpeg_abi.JpegHeader(
            64, 48, len(samp), max(h), max(v), h, v, (0,) * len(samp),
            (0,) * len(samp), (0,) * len(samp), (0,) * len(samp),
            (0,) * len(samp), progressive, port_decoder=port)

    assert jpeg.sampling_refused(hdr([(3, 1), (2, 1), (2, 1)]))
    assert jpeg.sampling_refused(hdr([(4, 4), (1, 1), (1, 1)]))
    assert not jpeg.sampling_refused(hdr([(4, 4), (1, 1), (1, 1)], port=True))
    assert not jpeg.sampling_refused(hdr([(2, 2), (1, 1), (1, 1)] + [(2, 2)]))
    assert not jpeg.sampling_refused(hdr([(4, 2), (1, 1), (1, 1)]))
    assert not jpeg.sampling_refused(hdr([(4, 4)]))  # one component


# -- the engines and the apps ------------------------------------------------------


ENGINE_CASES = [("411", True, 0), ("cb11_cr21", True, 0),
                ("y11_under_c22", True, 0), ("420", False, 3),
                ("444", False, 0)]


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("case", ENGINE_CASES, ids=_case_id)
def test_engine_matches_jax_engine(monkeypatch, case, mode):
    width, fmt = mode
    ref, port, ref_out, port_out, (iw, ih) = _run_engines(
        monkeypatch, written(case, (96, 64), seed=5)[0], width, fmt)
    assert _out_size(port_out) == _out_size(ref_out)
    a, b = _decoded(port_out), _decoded(ref_out)
    print(f"{_case_id(case)} -> {_mode_id(mode)}: PSNR {psnr(a, b):.2f} dB")
    assert psnr(a, b) >= 38.0
    stages = port.metrics.stage_seconds
    assert stages["entropy_decode"] > 0 and stages["device_decode"] > 0
    assert "device_decode_resize" not in stages  # no JPEG head (K1)
    assert port.metrics.batches == (1 if width else 0)


@pytest.mark.parametrize("case", ENGINE_CASES, ids=_case_id)
def test_http_serves_as_the_reference(tmp_path, case):
    """``/img`` at w=64 WebP and JPEG and unresized, and ``POST /upload``,
    through both apps: statuses and content types equal, outputs within
    38 dB."""
    data = written(case, (96, 64), seed=6)[0]

    async def fn(client):
        from aiohttp import FormData

        outs = [await _img(client, url=_url("x"), w=w,
                           f=fmt.value if fmt != ImageFormat.webp else None)
                for w, fmt in MODES]
        form = FormData()
        form.add_field("file", data, filename="x.jpg")
        form.add_field("w", "48")
        form.add_field("f", "jpeg")
        r = await client.post("/upload", data=form)
        return outs + [(r.status, r.headers.get("Content-Type"),
                        await r.read())]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pbody[:200]
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0


def test_a_cut_scan_a_component_answers_as_the_reference(tmp_path):
    """A file in one scan a component cut inside its second scan: the
    reference's fetch stage decodes it with Pillow, which refuses it; the
    port's fetch stage passes its header and its decoder refuses it
    (``SourceDecodeError``), the fetch stage's body: ``/img`` equal, and
    ``POST /upload`` 400 in both (each decoder names its own error)."""
    data = written(("420", False, 0), (96, 64))[0]
    cut = data[:len(data) * 2 // 3]
    with pytest.raises(SourceDecodeError):
        jpeg.decode_to_coefficients(cut)

    ref = _serve(tmp_path, "ref", {"x": cut}, lambda c: _both(c, cut))
    port = _serve(tmp_path, "port", {"x": cut}, lambda c: _both(c, cut))
    assert port[:2] == ref[:2]
    assert [o[0] for o in port] == [o[0] for o in ref] == [400] * 4


# -- the scans under the sanitizers ------------------------------------------------


_SANITIZED = r"""
import ctypes, json, sys
lib = ctypes.CDLL(sys.argv[1])
class Info(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in ("w", "h", "n", "hmax", "vmax")] + [
        (n, ctypes.c_int32 * 4) for n in ("ch", "cv", "cw", "chh", "bw", "bh",
                                           "tq")] + [("prog", ctypes.c_int32)]
rcs = {}
for name, hexdata in json.loads(sys.stdin.read()).items():
    data = bytes.fromhex(hexdata)
    info, extra = Info(), (ctypes.c_int32 * 2)()  # Adobe flag, coding
    rc = lib.ik_jpeg4_parse(data, len(data), ctypes.byref(info), extra)
    if rc == 0:
        bufs = [ctypes.create_string_buffer(info.bw[c] * info.bh[c] * 128)
                for c in range(info.n)]
        ptrs = (ctypes.c_void_p * 4)(*[ctypes.addressof(b) for b in bufs])
        q = ctypes.create_string_buffer(512)
        rc = lib.ik_jpeg4_decode_coeffs(data, len(data), ptrs, q)
    rcs[name] = rc
print(json.dumps(rcs))
"""


def test_scans_under_address_sanitizer(tmp_path):
    """``jpeg4_decode.cpp`` built with ``-fsanitize=address,undefined``
    decodes every frame in several scans (rc 0) and refuses the cut and
    corrupted ones (rc < 0), and the sanitizers report nothing."""
    lib = tmp_path / "jpeg4.so"
    subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fPIC", "-shared",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer", str(NATIVE / "jpeg4_decode.cpp"),
         "-o", str(lib)], check=True, capture_output=True, timeout=300)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    cases = {}
    for case in CASES:
        if case[1]:
            continue
        data = written(case, (61, 37))[0]
        cases[f"good/{_case_id(case)}"] = data.hex()
        cases[f"hostile/{_case_id(case)}/cut"] = data[:len(data) // 2].hex()
        sos = data.rindex(b"\xff\xda")
        bad = bytearray(data)
        bad[sos + 5] = 9  # a component id no frame has
        cases[f"hostile/{_case_id(case)}/bad_id"] = bytes(bad).hex()
        bad = bytearray(data)
        bad[sos + 6] = 0x44  # Huffman tables never defined
        cases[f"hostile/{_case_id(case)}/no_table"] = bytes(bad).hex()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _SANITIZED, str(lib)],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr and "runtime error" not in (
        proc.stderr), proc.stderr[-6000:]
    rcs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {k: v for k, v in rcs.items() if k.startswith("good/") and v} == {}
    assert [k for k, v in rcs.items()
            if k.startswith("hostile/") and v >= 0] == []
