"""Palette blocks, intra block copy and 10- and 12-bit streams in the
port's AV1 decoder (``codecs/native/av1_decode.cpp``), against libdav1d,
byte for byte.

- Screen content from Pillow's AVIF writer (libavif with libaom), which
  finds flat graphics on its own at its default settings and codes
  palette blocks (spec 5.11.46, 5.11.49) and intra block copy (5.11.7,
  7.10.2, 7.11.3): logos of flat rectangles and UI text at quality
  30/60/90, speeds 4/6/8, 4:2:0 and 4:4:4, sizes up to 256 x 192 and odd
  ones, a natural picture with ``tune-content=screen``, an RGBA logo whose
  alpha item codes palette blocks, and files of 4 x 2 tiles. Each is held
  to libdav1d's u8 planes through the JAX package's
  ``avif_native._decode_obu``, and each sweep asserts that the tool it is
  about was coded (the decoder's counts of palette and intrabc blocks).
- 10- and 12-bit streams through libavif's C API
  (``tests/fixtures/make_avif_sources.py::encode_avif_hbd``, the recipe of
  ``tests/test_avif_native.py::_encode_avif_10bit`` with the depth and the
  layout as arguments): 10-bit 4:2:0, 4:2:2 and 4:4:4 and 12-bit 4:2:0 and
  4:4:4 at two quantizers, then with deblocking and CDEF, with loop
  restoration, and with screen content. The raw 16-bit planes are held to
  libdav1d's own (read with the reference's ``_PIC_*`` offsets,
  ``make_avif_sources.dav1d_samples``), and the u8 planes of
  ``av1_dec_abi.decode`` to the reference's rounding of them.
- One file of each kind through ``decode_bytes``, ``/img`` (w=64 and no
  resize) and ``/upload`` against the reference app.
"""

import io

import numpy as np
import pytest

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch.codecs.native import av1_dec_abi
from tests.conftest import psnr
from tests.fixtures.make_avif_sources import (
    dav1d_samples,
    encode_avif_hbd,
    glyphs,
)
from tests.test_torch_av1_decode import (
    PIL,
    assert_file_equal,
    needs_oracles,
    pillow_avif,
    synth,
)
from tests.test_torch_pillow_sources import _decoded, _img, _serve, _url
from tests.test_torch_rgba_slice import _out_size


def flat_logo(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Flat rectangles of a few colours on white, with thin dark strokes:
    what libaom codes with palettes."""
    rng = np.random.default_rng(seed)
    a = np.full((h, w, 3), 240, np.uint8)
    for _ in range(12):
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        a[y0:y0 + rng.integers(4, max(5, h // 2)),
          x0:x0 + rng.integers(4, max(5, w // 2))] = rng.integers(0, 256, 3)
    for _ in range(30):
        x0, y0 = rng.integers(0, max(1, w - 8)), rng.integers(0, max(1, h - 3))
        a[y0:y0 + 2, x0:x0 + rng.integers(2, 8)] = 20
    return a


def ui_text(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Rows of text in one glyph set: repeats that intra block copy
    finds."""
    rng = np.random.default_rng(seed)
    font = glyphs(rng, 12, 10, 7)
    a = np.full((h, w, 3), 250, np.uint8)
    for r in range(4, h - 12, 14):
        for c in range(4, w - 8, 8):
            g = font[rng.integers(0, len(font))]
            a[r:r + 10, c:c + 7][g] = (30, 30, 60)
    return a


def stream_info(obu: bytes) -> av1_dec_abi.StreamInfo:
    return av1_dec_abi.decode(obu)[3]


def tools(data: bytes):
    """(palette blocks, intrabc blocks) of the colour item."""
    info = stream_info(ref_avif.parse_container(data).obu)
    return info.palette_blocks, info.intrabc_blocks


def hbd_picture(w: int, h: int, depth: int, layout: str, seed: int):
    """Seeded Y, U, V planes at ``depth`` bits: a ramp with edges and
    noise in luma, slopes in chroma."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    y = xx * top / max(w - 1, 1) + rng.normal(0, top / 40, (h, w))
    y += ((xx // 9 + yy // 7) % 2) * top / 5
    cw = (w + 1) // 2 if layout in ("420", "422") else w
    ch = (h + 1) // 2 if layout == "420" else h
    cy, cx = np.mgrid[0:ch, 0:cw]
    u = top / 2 + (cx - cw / 2) * top / (2 * cw) + rng.normal(0, top / 60,
                                                               (ch, cw))
    v = top / 2 + (cy - ch / 2) * top / (2 * ch)
    return tuple(np.clip(p, 0, top).astype(np.uint16) for p in (y, u, v))


def hbd_file(w, h, depth, layout, quantizer, seed, **kw) -> bytes:
    data = encode_avif_hbd(*hbd_picture(w, h, depth, layout, seed), depth,
                           layout, quantizer, **kw)
    if data is None:
        pytest.skip("libavif's high-bit-depth encode unavailable")
    return data


def screen_hbd_file(depth: int, picture) -> bytes:
    """``picture`` (an 8-bit RGB screen) at ``depth`` bits, 4:2:0, with
    libaom's screen-content tuning."""
    src = picture.astype(np.uint16) << (depth - 8)
    data = encode_avif_hbd(src[..., 0], src[::2, ::2, 1], src[::2, ::2, 2],
                           depth, "420", 20, speed=6,
                           options={"tune-content": "screen"})
    if data is None:
        pytest.skip("libavif's high-bit-depth encode unavailable")
    return data


def assert_samples_equal(data: bytes, what: str = "") -> av1_dec_abi.StreamInfo:
    """The raw planes of the colour item equal libdav1d's at their own
    depth, and ``decode``'s u8 planes the reference's rounding of them."""
    info = ref_avif.parse_container(data)
    want = dav1d_samples(info.obu)
    assert want is not None, f"libdav1d does not decode {what}"
    y, u, v, head = av1_dec_abi.decode_samples(info.obu)
    assert head.bitdepth == want[3], what
    for name, got, exp in zip("YUV", (y, u, v), want[:3]):
        if exp is None:
            assert got is None, (what, name)
            continue
        assert got.dtype == exp.dtype and got.shape == exp.shape, (what, name)
        diff = np.argwhere(got != exp)
        assert not len(diff), (what, name, len(diff), diff[0].tolist())
    assert_file_equal(data, what)
    return head


# -- screen content from Pillow's writer --------------------------------------------


@needs_oracles
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("speed", [4, 6, 8])
@pytest.mark.parametrize("quality", [30, 60, 90])
def test_flat_graphics_sweep(quality, speed, sub):
    """Flat graphics at Pillow's defaults but for the swept setting: libaom
    turns the screen-content tools on by itself and codes palettes."""
    data = pillow_avif(flat_logo(192, 128, seed=quality + speed),
                       quality=quality, speed=speed, subsampling=sub)
    assert_file_equal(data, f"flat q{quality} speed {speed} {sub}")
    info = stream_info(ref_avif.parse_container(data).obu)
    assert info.screen_content and info.palette_blocks > 0


@needs_oracles
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("quality", [30, 60, 90, 100])
def test_ui_text_codes_intra_block_copy(quality, sub):
    """Rows of text at the default speed: intra block copy from the
    frame's own samples, the var-tx tree and the inter transform sets,
    chroma at half samples in 4:2:0."""
    data = pillow_avif(ui_text(256, 192, seed=quality), quality=quality,
                       subsampling=sub)
    assert_file_equal(data, f"text q{quality} {sub}")
    info = stream_info(ref_avif.parse_container(data).obu)
    assert info.intrabc and info.intrabc_blocks > 0


@needs_oracles
@pytest.mark.parametrize("size", [(255, 191), (97, 33), (130, 70), (17, 9),
                                  (203, 129)])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_screen_content_at_odd_sizes(size, sub):
    """Colour index maps copied past the frame's edge, blocks cut by it,
    4xN chroma of 4:2:2."""
    w, h = size
    data = pillow_avif(ui_text(w, h, seed=w), quality=60, subsampling=sub)
    assert_file_equal(data, f"text {w}x{h} {sub}")
    data = pillow_avif(flat_logo(w, h, seed=h), quality=60, subsampling=sub)
    assert_file_equal(data, f"flat {w}x{h} {sub}")


@needs_oracles
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
def test_natural_picture_tuned_for_screen(sub):
    data = pillow_avif(synth(128, 96, seed=1), quality=60, subsampling=sub,
                       advanced=[("tune-content", "screen")])
    assert stream_info(ref_avif.parse_container(data).obu).screen_content
    assert_file_equal(data, f"natural, screen tuning, {sub}")


@needs_oracles
@pytest.mark.parametrize("quality", [30, 60, 90])
def test_rgba_logo_alpha_codes_palettes(quality):
    rgba = np.dstack([flat_logo(200, 120, seed=quality),
                      np.zeros((120, 200), np.uint8)])
    rgba[20:100, 30:170, 3] = 255
    rgba[40:80, 60:140, 3] = 128
    buf = io.BytesIO()
    PIL.fromarray(rgba, "RGBA").save(buf, "AVIF", quality=quality)
    data = buf.getvalue()
    assert_file_equal(data, f"rgba logo q{quality}")
    info = ref_avif.parse_container(data)
    assert stream_info(info.alpha_obu).palette_blocks > 0


@needs_oracles
@pytest.mark.parametrize("size, tools_used", [
    ((256, 192), "palette"), ((1024, 512), "intrabc")])
def test_four_by_two_tiles(size, tools_used):
    """4 x 2 tiles on their threads: palette caches and intrabc vectors
    stay inside their tile (at 256 x 192 the tiles are too small for
    intra block copy's 256-sample delay; at 1024 x 512 it is coded)."""
    w, h = size
    data = pillow_avif(ui_text(w, h, seed=7), quality=70,
                       advanced=[("tile-columns", "2"), ("tile-rows", "1")])
    assert_file_equal(data, f"4x2 tiles {w}x{h}")
    palette, intrabc = tools(data)
    assert palette > 0
    if tools_used == "intrabc":
        assert intrabc > 0


# -- 10- and 12-bit ---------------------------------------------------------------------


@needs_oracles
@pytest.mark.parametrize("quantizer", [10, 40])
@pytest.mark.parametrize("depth, layout", [(10, "420"), (10, "422"),
                                           (10, "444"), (12, "420"),
                                           (12, "444")])
def test_high_bit_depth(depth, layout, quantizer):
    data = hbd_file(97, 72, depth, layout, quantizer, depth + quantizer)
    head = assert_samples_equal(data, f"{depth}-bit {layout} q{quantizer}")
    assert head.bitdepth == depth


@needs_oracles
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("layout", ["420", "444"])
@pytest.mark.parametrize("filters", ["cdef", "restoration"])
def test_high_bit_depth_in_loop_filters(depth, layout, filters):
    """Deblocking limits, CDEF strengths and direction search, Wiener and
    self-guided rounding at the bit depth."""
    kw = ({"speed": 6, "options": {"enable-cdef": "1"}}
          if filters == "cdef" else {"speed": 4})
    data = hbd_file(130, 70, depth, layout, 30, depth, **kw)
    head = assert_samples_equal(data, f"{depth}-bit {layout} {filters}")
    want = (av1_dec_abi.FILTER_CDEF if filters == "cdef"
            else av1_dec_abi.FILTER_LR)
    assert head.filters & want


@needs_oracles
@pytest.mark.parametrize("depth", [10, 12])
def test_high_bit_depth_screen_content(depth):
    """Palette literals of BitDepth bits, and intra block copy at 10 and
    12 bits."""
    text = assert_samples_equal(
        screen_hbd_file(depth, ui_text(192, 128, depth)), f"{depth} text")
    assert text.palette_blocks > 0 and text.intrabc_blocks > 0
    flat = assert_samples_equal(
        screen_hbd_file(depth, flat_logo(192, 128, depth)), f"{depth} flat")
    assert flat.palette_blocks > 0


@needs_oracles
def test_eight_bit_rounding_of_high_bit_depth():
    """``decode`` rounds (v + 2^(s-1)) >> s and clips to 255 on every
    plane, as the reference's ``_decode_obu``."""
    data = hbd_file(64, 48, 12, "444", 10, 5)
    obu = ref_avif.parse_container(data).obu
    samples = av1_dec_abi.decode_samples(obu)
    rounded = av1_dec_abi.decode(obu)
    for raw, r8 in zip(samples[:3], rounded[:3]):
        assert r8.dtype == np.uint8
        assert np.array_equal(
            r8, np.minimum((raw.astype(np.int64) + 8) >> 4, 255))
    top = np.full((4, 4), 4095, np.uint16)
    assert av1_dec_abi.to_8bit(top, 12).max() == 255


# -- through the entry points ------------------------------------------------------------


def _kinds() -> dict:
    return {
        "palette": lambda: pillow_avif(flat_logo(192, 128, seed=3),
                                       quality=60),
        "intrabc": lambda: pillow_avif(ui_text(256, 192, seed=3),
                                       quality=60),
        "rgba_logo": lambda: _rgba_logo(),
        "10bit": lambda: hbd_file(120, 88, 10, "420", 20, 1),
        "12bit_444": lambda: hbd_file(120, 88, 12, "444", 20, 2),
    }


def _rgba_logo() -> bytes:
    rgba = np.dstack([flat_logo(160, 96, seed=5),
                      np.zeros((96, 160), np.uint8)])
    rgba[10:80, 20:140, 3] = 255
    buf = io.BytesIO()
    PIL.fromarray(rgba, "RGBA").save(buf, "AVIF", quality=60)
    return buf.getvalue()


@needs_oracles
@pytest.mark.parametrize("kind", sorted(_kinds()))
def test_decode_bytes_as_the_reference(kind):
    data = _kinds()[kind]()
    got, fmt = port_codecs.decode_bytes(data, device="cpu")
    want, _ = ref_codecs.decode_bytes(data)
    assert fmt == port_codecs.SourceFormat.avif
    assert np.array_equal(got, want)


@needs_oracles
@pytest.mark.parametrize("kind", sorted(_kinds()))
def test_img_and_upload_as_the_reference_app(tmp_path, kind):
    """``/img`` at w=64 and with no resize, and ``/upload`` at w=64: the
    same statuses and types through both apps, the same output size, and
    WebP bodies within the AVIF contract of ``test_torch_avif_sources``
    (JPEG heads within +-1, so 45 dB here)."""
    from tests.test_torch_avif_sources import _upload

    data = _kinds()[kind]()

    async def fn(client):
        return [await _img(client, url=_url("x"), w=64),
                await _img(client, url=_url("x")),
                await _upload(client, data, w=64)]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        assert _out_size(pb) == _out_size(rb)
        if pb != rb:
            assert psnr(_decoded(pb), _decoded(rb)) >= 45.0


def test_decode_timing_tool_times_each_tree(tmp_path):
    """``tools/av1_decode_timing.py`` decodes every AVIF of a directory in
    a process a checkout and records the least time, or the error of a
    file that tree does not decode."""
    import json
    from pathlib import Path

    from imagekit_tpu_torch.codecs import avif_encode
    from imagekit_tpu_torch.tools import av1_decode_timing

    (tmp_path / "own.avif").write_bytes(
        avif_encode.encode_rgb(synth(64, 48, seed=1), 60))
    (tmp_path / "junk.avif").write_bytes(b"\0" * 64)
    root = str(Path(__file__).resolve().parents[1])
    out = tmp_path / "ab.json"
    assert av1_decode_timing.main(["--fixtures", str(tmp_path), "--repeat",
                                   "1", "--out", str(out), root]) == 0
    (run,) = json.loads(out.read_text())["runs"]
    assert run["decode"]["own"]["ms"] > 0
    assert run["decode"]["own"]["bitdepth"] == 8
    assert "error" in run["decode"]["junk"]
