"""The DDS layouts the reference decoded with Pillow that the port answered
501 for, in the port, on the CPU: BC4 (``BC4U``, ``ATI1``, DXGI 79/80),
signed BC5 (``BC5S``, DXGI 84), BC6H unsigned and signed (DXGI 95/96), BC7
(DXGI 97/98/99), DX10 R8G8B8A8 (DXGI 27/28/29) and the 8-bit palette.

Pillow writes none of them; a DDS header written by hand over block bytes
is a file Pillow reads, so the fixtures are headers over random blocks
(numpy seeds), with the first byte of each BC6H and BC7 block set to spread
the blocks over every mode, the reserved BC6H modes and a BC7 block whose
mode byte is 0 included. The oracle is the JAX package's ``decode_bytes``
(Pillow, through ``pil_backend.decode``).

- Every layout, at sizes that are multiples of 4 and that are not, with
  mipmaps and in a DX10 array: exactly the reference's pixels and channel
  count; ``dds.parse`` gives the decoded geometry.
- A body cut short: the reference's error, Pillow's "image file is
  truncated (n bytes not processed)" with its count.
- Both engines and both apps, at w=64 WebP and JPEG and with no resize:
  statuses, content types and output sizes equal, outputs decoded at
  >= 38 dB; BC7 and R8G8B8A8 take K2's four-channel entry, the rest its
  three-channel one.
- ``raster_decode.cpp`` and ``bcn_ext_decode.cpp`` under AddressSanitizer
  and UBSan decode every layout and refuse short bodies.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu_torch import codecs, transform
from imagekit_tpu_torch.codecs import dds
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError, TransformError
from imagekit_tpu_torch.ops import resize_strip
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

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "imagekit_tpu_torch" / "codecs" / "native"


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``)."""
    _ref_native_lib(monkeypatch)


def dds_file(w, h, body, fourcc=b"DX10", dxgi=0, pfflags=0x4, bitcount=0,
             mipmaps=0, array=1, extra=b""):
    """A DDS header by hand (a DX10 one after it for ``fourcc`` DX10),
    then ``extra`` (a palette) and the body."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, mipmaps)
            + bytes(44) + struct.pack("<4I", 32, pfflags,
                                      struct.unpack("<I", fourcc)[0],
                                      bitcount)
            + bytes(16) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if fourcc == b"DX10":
        head += struct.pack("<5I", dxgi, 3, 0, array, 0)
    return head + extra + body


def _blocks(n, size, seed, first=None):
    """n random blocks of ``size`` bytes; ``first(i, byte)`` sets block
    i's first byte."""
    body = np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8)
    if first is not None:
        body[:, 0] = [first(i, int(b)) for i, b in enumerate(body[:, 0])]
    return body


def bc7_mode(i, byte):
    """Modes 0-7 in turn, every ninth block a mode byte of 0."""
    m = i % 9
    return 0 if m == 8 else ((byte >> (m + 1)) << (m + 1)) | (1 << m)


#: the 2-bit and 5-bit mode fields of BC6H: modes 1-14, then the reserved
BC6H_CODES = [0, 1] + [2 + 4 * k for k in range(8)] + [3 + 4 * k
                                                       for k in range(8)]


def bc6h_mode(i, byte):
    c = BC6H_CODES[i % len(BC6H_CODES)]
    return (byte & ~3) | c if c < 2 else (byte & ~31) | c


#: layout -> (header arguments, block bytes, first-byte setter); None for
#: the raw layouts
BCN = {
    "bc4_fourcc": (dict(fourcc=b"BC4U"), 8, None),
    "bc4_ati1": (dict(fourcc=b"ATI1"), 8, None),
    "bc4_dx10": (dict(dxgi=80), 8, None),
    "bc4_dx10_typeless": (dict(dxgi=79), 8, None),
    "bc5_signed": (dict(fourcc=b"BC5S"), 16, None),
    "bc5_signed_dx10": (dict(dxgi=84), 16, None),
    "bc6h_unsigned": (dict(dxgi=95), 16, bc6h_mode),
    "bc6h_signed": (dict(dxgi=96), 16, bc6h_mode),
    "bc7": (dict(dxgi=98), 16, bc7_mode),
    "bc7_typeless": (dict(dxgi=97), 16, bc7_mode),
    "bc7_srgb": (dict(dxgi=99), 16, bc7_mode),
}
RAW = ("rgba8", "rgba8_typeless", "rgba8_srgb", "palette")
LAYOUTS = sorted(BCN) + list(RAW)
SIZES = [(64, 48), (96, 64), (61, 37), (10, 7)]


def source(name, w=64, h=48, seed=0, mipmaps=0, array=1, cut=0):
    """The layout's file at w x h from seeded random bytes; ``mipmaps``
    more surfaces after the first (a quarter of its bytes each, at
    least one block), ``cut`` bytes dropped from its end."""
    rng = np.random.default_rng(seed + 1000)
    if name in BCN:
        args, size, first = BCN[name]
        n = ((w + 3) // 4) * ((h + 3) // 4)
        body = _blocks(n, size, seed, first).tobytes()
        tail = sum(max(n >> (2 * k), 1) for k in range(1, mipmaps + 1))
        body += rng.integers(0, 256, tail * size, np.uint8).tobytes()
        if array > 1:
            body += rng.integers(0, 256, (array - 1) * len(body),
                                 np.uint8).tobytes()
        data = dds_file(w, h, body, mipmaps=mipmaps, array=array, **args)
    elif name == "palette":
        pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
        body = rng.integers(0, 256, w * h * (1 + mipmaps), np.uint8).tobytes()
        data = dds_file(w, h, body, fourcc=b"\0\0\0\0", pfflags=0x20,
                        bitcount=8, mipmaps=mipmaps, extra=pal)
    else:
        dxgi = {"rgba8": 28, "rgba8_typeless": 27, "rgba8_srgb": 29}[name]
        body = rng.integers(0, 256, w * h * 4 * (1 + mipmaps) * array,
                            np.uint8).tobytes()
        data = dds_file(w, h, body, dxgi=dxgi, mipmaps=mipmaps, array=array)
    return data[:len(data) - cut]


def _channels(name):
    return 4 if name.startswith(("bc7", "rgba8")) else 3


def _same_as_reference(data):
    want = ref_codecs.decode_bytes(data)[0]
    got = codecs.decode_bytes(data, device="cpu")[0]
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape,
                                                             want.shape)
    assert np.array_equal(got, want)
    return got


# -- pixels --------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", LAYOUTS)
def test_every_layout_decodes_to_the_reference_pixels(name, size):
    w, h = size
    data = source(name, w, h, seed=w * h)
    got = _same_as_reference(data)
    assert got.shape == (h, w, _channels(name))
    assert dds.parse(data) == (w, h, _channels(name))
    assert transform.decode_image(data, device="cpu")[0].shape == got.shape


@pytest.mark.parametrize("mode", range(9), ids=lambda m: f"mode{m}"
                         if m < 8 else "mode_byte_0")
def test_every_bc7_mode(mode):
    """96x64 of one BC7 mode (or a mode byte of 0: opaque black)."""
    body = _blocks(24 * 16, 16, 70 + mode,
                   lambda i, b: bc7_mode(mode, b)).tobytes()
    got = _same_as_reference(dds_file(96, 64, body, dxgi=98))
    if mode == 8:
        assert (got[..., :3] == 0).all() and (got[..., 3] == 255).all()


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
@pytest.mark.parametrize("code", BC6H_CODES, ids=lambda c: f"m{c:05b}")
def test_every_bc6h_mode(code, signed):
    """96x64 of one BC6H mode field, the reserved ones (10011, 10111,
    11011, 11111) included: black."""
    body = _blocks(24 * 16, 16, 80 + code,
                   lambda i, b: bc6h_mode(BC6H_CODES.index(code), b))
    got = _same_as_reference(dds_file(96, 64, body.tobytes(),
                                      dxgi=96 if signed else 95))
    if code in (19, 23, 27, 31):
        assert (got == 0).all()


def test_signed_bc5_reads_each_endpoint_plus_128():
    """A signed BC5 block's endpoint bytes are signed values: -128 reads
    as 0, 127 as 255, and blue is a signed 0, 128."""
    block = bytes([0x7F, 0x80]) + bytes(6)  # every index 0: the first
    data = dds_file(4, 4, block + bytes([0x80, 0x7F]) + bytes(6),
                    fourcc=b"BC5S")
    got = _same_as_reference(data)
    assert (got.reshape(-1, 3) == (255, 0, 128)).all()


@pytest.mark.parametrize("name", ["bc7", "bc6h_unsigned", "bc4_fourcc",
                                  "rgba8", "palette"])
def test_mipmaps_and_arrays_read_the_first_surface(name):
    plain = codecs.decode_bytes(source(name, 64, 48, seed=5), device="cpu")[0]
    for kw in (dict(mipmaps=3), dict(array=3)):
        if name == "palette" and "array" in kw:
            continue
        data = source(name, 64, 48, seed=5, **kw)
        assert np.array_equal(_same_as_reference(data), plain)


def test_srgb_formats_decode_to_the_same_pixels():
    for a, b in (("bc7", "bc7_srgb"), ("rgba8", "rgba8_srgb")):
        assert np.array_equal(
            codecs.decode_bytes(source(a, seed=9), device="cpu")[0],
            codecs.decode_bytes(source(b, seed=9), device="cpu")[0])


CUTS = [("bc7", 40), ("bc7", 16), ("bc7", 1), ("bc6h_signed", 100),
        ("bc4_fourcc", 3), ("bc5_signed", 8), ("rgba8", 1), ("rgba8", 1000),
        ("palette", 5), ("palette", 64 * 48), ("palette", 64 * 48 + 500)]


@pytest.mark.parametrize("name,cut", CUTS, ids=lambda x: str(x))
def test_short_body_is_pillows_error(name, cut):
    data = source(name, 64, 48, seed=3, cut=cut)
    with pytest.raises(ref_codecs.TransformError) as want:
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError) as got:
        codecs.decode_bytes(data, device="cpu")
    assert not isinstance(got.value, NotPortedError)
    assert str(got.value) == str(want.value)
    assert "bytes not processed" in str(got.value)


def test_unknown_dxgi_format_is_still_refused():
    data = dds_file(8, 8, bytes(64), dxgi=10)
    with pytest.raises(ref_codecs.TransformError):
        ref_codecs.decode_bytes(data)
    with pytest.raises(TransformError, match="Unimplemented DXGI format 10"):
        codecs.decode_bytes(data, device="cpu")


# -- the engines and the apps ------------------------------------------------------


ENGINE_LAYOUTS = ["bc4_fourcc", "bc5_signed", "bc6h_unsigned", "bc6h_signed",
                  "bc7", "rgba8", "palette"]


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("name", ENGINE_LAYOUTS)
def test_engine_matches_jax_engine(monkeypatch, name, mode):
    """One request through both engines: K2's four-channel entry for BC7
    and R8G8B8A8, its three-channel one for the rest (counted on the CPU
    through the plain version each entry runs there)."""
    width, fmt = mode
    calls = {"rgb_resize": 0, "rgba_resize": 0}
    for entry in calls:
        fn = getattr(resize_strip, f"{entry}_plain")

        def counted(*a, _fn=fn, _entry=entry, **k):
            calls[_entry] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(resize_strip, f"{entry}_plain", counted)
    ref, port, ref_out, port_out, (iw, ih) = _run_engines(
        monkeypatch, source(name, 96, 72, seed=11), width, fmt)
    assert _out_size(port_out) == _out_size(ref_out)
    a, b = _decoded(port_out), _decoded(ref_out)
    print(f"{name} -> {_mode_id(mode)}: PSNR {psnr(a, b):.2f} dB")
    assert psnr(a, b) >= 38.0
    assert port.metrics.batches == ref.metrics.batches == (1 if width else 0)
    assert port.metrics.stage_seconds["decode"] > 0
    four = _channels(name) == 4 and width is not None
    want = {"rgba_resize": int(four),
            "rgb_resize": int(width is not None and not four)}
    assert calls == want


@pytest.mark.parametrize("name", ENGINE_LAYOUTS)
def test_http_serves_as_the_reference(tmp_path, name):
    """``/img`` at w=64 WebP and JPEG and unresized, the body cut by 40
    bytes, and ``POST /upload``, through both apps."""
    data = source(name, 96, 72, seed=12)
    sources = {"ok": data, "cut": data[:-40]}

    async def fn(client):
        from aiohttp import FormData

        outs = [await _img(client, url=_url("ok"), w=w,
                           f=fmt.value if fmt != ImageFormat.webp else None)
                for w, fmt in MODES]
        outs.append(await _img(client, url=_url("cut"), w=64))
        form = FormData()
        form.add_field("file", data, filename="x.dds")
        form.add_field("w", "48")
        r = await client.post("/upload", data=form)
        outs.append((r.status, r.headers.get("Content-Type"),
                     await r.read()))
        return outs

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for (rs, rct, rbody), (ps, pct, pbody) in zip(ref[:3] + ref[4:],
                                                  port[:3] + port[4:]):
        assert (ps, pct) == (rs, rct) and ps == 200, pbody[:200]
        assert _out_size(pbody) == _out_size(rbody)
        assert psnr(_decoded(pbody), _decoded(rbody)) >= 38.0
    assert port[3] == ref[3]
    assert port[3][0] == 400
    assert port[3][2] == (b"Invalid argument: Unable to decode image for "
                          b"validation")


# -- the native loops under the sanitizers -----------------------------------------


_SANITIZED = r"""
import ctypes, json, sys
lib = ctypes.CDLL(sys.argv[1])
lib.ik_bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
rcs = {}
for name, (hexdata, w, h, kind, ch) in json.loads(sys.stdin.read()).items():
    data = bytes.fromhex(hexdata)
    out = ctypes.create_string_buffer(w * h * ch)
    rcs[name] = lib.ik_bcn_decode(data, len(data), w, h, kind, out)
print(json.dumps(rcs))
"""


def test_block_decoders_under_address_sanitizer(tmp_path):
    """``raster_decode.cpp`` and ``bcn_ext_decode.cpp`` built with
    ``-fsanitize=address,undefined``: every kind over random blocks (every
    BC6H and BC7 mode) decodes (rc 0), bodies a byte short and bad kinds
    are refused (rc < 0), and the sanitizers report nothing."""
    lib = tmp_path / "bcn.so"
    subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fPIC", "-shared",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer", str(NATIVE / "raster_decode.cpp"),
         str(NATIVE / "bcn_ext_decode.cpp"), "-o", str(lib)],
        check=True, capture_output=True, timeout=300)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    kinds = {1: (8, 4, None), 2: (16, 4, None), 3: (16, 4, None),
             4: (8, 3, None), 5: (16, 3, None), 6: (16, 3, None),
             7: (16, 3, bc6h_mode), 8: (16, 3, bc6h_mode), 9: (16, 4, bc7_mode)}
    cases = {}
    for kind, (size, ch, first) in kinds.items():
        for w, h in ((61, 37), (4, 4), (1, 1)):
            n = ((w + 3) // 4) * ((h + 3) // 4)
            body = _blocks(max(n, 40), size, kind, first)[:n].tobytes()
            cases[f"good/{kind}/{w}x{h}"] = (body.hex(), w, h, kind, ch)
            cases[f"hostile/{kind}/{w}x{h}/short"] = (body[:-1].hex(), w, h,
                                                      kind, ch)
    cases["hostile/kind0"] = ("00" * 16, 4, 4, 0, 4)
    cases["hostile/kind10"] = ("00" * 16, 4, 4, 10, 4)
    cases["hostile/zero_width"] = ("00" * 16, 0, 4, 9, 4)
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
