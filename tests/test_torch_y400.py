"""The monochrome (YUV400) AVIF encode of the port, on the CPU.

The reference writes a true monochrome AVIF (mono_chrome = 1) through
libavif (``imagekit_tpu/codecs/avif_encode.py::encode_y400_studio``); the
port writes it with the first-party encoder's luma-only mode
(``av1_intra``'s ``mono``, ``av1_image.encode_frame`` with no chroma,
``encode_avif_y400``). So the bytes differ from the reference's, and what
is held is:

- the stream: random planes at odd sizes (1x1 up to 65x33) and
  q 1/50/80/100 decode byte for byte to the encoder's own reconstruction
  through the port's AV1 decoder and through libdav1d (the reference's
  ``avif_native._decode_obu``, a test-only oracle), as one-plane frames;
- the container: one-channel ``pixi``, the ``av1C`` mono bit, CICP (1, 13,
  6) and the range flag the caller asked for, the same in the sequence
  header, read alike by both packages' parsers;
- the serving: the reference's app and the port's answer ``/img`` and
  ``/upload`` of such a file with equal statuses and bodies (the
  reference's ``decode_yuv_studio`` gives the plane neutral chroma, as the
  port's does);
- the 4:2:0 encode is untouched: its bytes equal the reference's
  first-party arm's with the chroma given (``test_torch_avif_encode.py``
  holds it at every size; here at the sizes of the mono cases).
"""

import numpy as np
import pytest

from imagekit_tpu.codecs import avif_encode as ref_avif
from imagekit_tpu.codecs import avif_native as ref_native
from imagekit_tpu_torch.codecs import av1_image, avif_encode, avif_native
from imagekit_tpu_torch.codecs.native import av1_dec_abi
from tests.conftest import psnr
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import _decoded, _img, _serve, _url
from tests.test_torch_rgba_slice import _out_size


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


needs_dav1d = pytest.mark.skipif(
    not ref_native.decode_available(),
    reason="libdav1d unavailable (the decode oracle of these tests)")

DIMS = [(1, 1), (1, 17), (33, 1), (17, 9), (33, 65), (65, 33)]
QUALITIES = [1, 50, 80, 100]


def _plane(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w),
                                                dtype=np.uint8)


def _qindex(q):
    return avif_encode.quantizer_to_qindex(avif_encode.quality_to_quantizer(q))


@needs_dav1d
@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("dims", DIMS)
def test_decodes_to_the_encoders_reconstruction(dims, q):
    h, w = dims
    y = _plane(h, w, seed=h * 131 + w + q)
    data = avif_encode.encode_y400_studio(y, q)
    stream, recon, ru, rv = av1_image.encode_frame(y, qindex=_qindex(q))
    assert ru is None and rv is None and recon.shape == (h, w)
    info = avif_native.parse_container(data)
    assert info.obu == stream and info.monochrome
    py, pu, pv, si = av1_dec_abi.decode(stream)
    assert si.mono and pu is None and pv is None
    assert np.array_equal(py, recon)
    dy, du, dv, layout, _ = ref_native._decode_obu(stream, w, h)
    assert layout == 0 and du is None and dv is None  # libdav1d's I400
    assert np.array_equal(dy, recon)
    if q >= 80:  # the encoder keeps the picture, not only the stream
        assert psnr(recon, y) > 20.0


@pytest.mark.parametrize("full_range", [False, True])
def test_container_and_headers(full_range):
    y = _plane(45, 61, seed=3)
    data = avif_encode.encode_y400_studio(y, 70, speed=6,
                                          full_range=full_range)
    head = data[:data.find(b"mdat")]
    assert head.count(b"pixi") == 1
    pixi = head.index(b"pixi") + 4
    assert head[pixi + 4:pixi + 6] == bytes((1, 8))  # one channel of 8 bits
    av1c = head.index(b"av1C") + 4
    assert head[av1c + 2] & 0x10 and head[av1c + 2] & 0x0C == 0x0C  # mono
    colr = head.index(b"colrnclx") + 8
    assert head[colr:colr + 7] == bytes((0, 1, 0, 13, 0, 6,
                                         0x80 if full_range else 0))
    for parse in (avif_native.parse_container, ref_native.parse_container):
        info = parse(data)
        assert (info.width, info.height) == (61, 45)
        assert info.monochrome and info.full_range == full_range
        assert not info.has_alpha
    si = av1_dec_abi.probe(avif_native.parse_container(data).obu)
    assert si.mono and si.full_range == full_range and si.layout == 0
    # speed is the reference's libavif knob: accepted, and no part of the
    # first-party encode
    assert data == avif_encode.encode_y400_studio(y, 70,
                                                  full_range=full_range)


def test_plane_contract():
    y = _plane(16, 16, seed=1)
    for bad in (y.astype(np.int16), np.dstack([y, y, y]), y[0]):
        with pytest.raises(ValueError, match="2-D uint8"):
            avif_encode.encode_y400_studio(bad, 80)


@pytest.mark.parametrize("dims", [(17, 9), (65, 33)])
def test_the_420_encode_is_unchanged(monkeypatch, dims):
    """With chroma given, the frame and file are the reference's first-party
    arm's, byte for byte: the mono mode leaves the 4:2:0 path as it was."""
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    h, w = dims
    y = _plane(h, w, seed=7)
    c = _plane((h + 1) // 2, (w + 1) // 2, seed=8)
    assert (avif_encode.encode_yuv420_studio(y, c, c, 60)
            == ref_avif.encode_yuv420_studio(y, c, c, 60))
    from imagekit_tpu.codecs import av1_image as ref_image

    got, want = (m.encode_frame(y, c, c, qindex=60)
                 for m in (av1_image, ref_image))
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


@needs_dav1d
@pytest.mark.parametrize("full_range", [False, True])
def test_served_as_the_reference_serves_it(monkeypatch, tmp_path, full_range):
    """``/img`` and ``/upload`` of a Y400 AVIF through both apps: the
    reference's ``decode_yuv_studio`` reads it with neutral chroma, as the
    port's does; WebP and AVIF bodies equal, JPEG at its size within the
    JPEG heads' band."""
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    yy, xx = np.mgrid[0:69, 0:95]
    y = ((xx * 2 + yy * 3) % 256).astype(np.uint8)
    data = avif_encode.encode_y400_studio(y, 75, full_range=full_range)
    assert ref_native.decode_yuv_studio(data) is not None

    from tests.test_torch_avif_sources import _upload

    async def fn(client):
        outs = []
        for fmt in ("webp", "jpeg", "avif"):
            outs.append(await _img(client, url=_url("m"), w=40, f=fmt))
            outs.append(await _upload(client, data, w=40, f=fmt))
        return outs

    ref = _serve(tmp_path, "ref", {"m": data}, fn)
    port = _serve(tmp_path, "port", {"m": data}, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        if pct == "image/jpeg":
            assert _out_size(pb) == _out_size(rb)
            assert psnr(_decoded(pb), _decoded(rb)) >= 45.0
        else:
            assert pb == rb
