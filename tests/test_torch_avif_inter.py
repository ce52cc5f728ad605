"""AVIFs whose output frame is an INTER frame, through the port's codecs and
apps against the reference (CPU tests; no card needed):

- progressive files on the Pillow path, where the reference's native path
  declines them and Pillow's libavif returns the highest layer: a base key
  frame at half size under an INTER frame at the full size (prediction
  across sizes, libavif's progressive layout) at 8 bits 4:2:0 and 10 bits
  4:4:4, two layers of one size and three with compound prediction with no
  ``colr`` box: ``decode_bytes`` gives Pillow 12.1's array, byte for byte;
- a hidden key frame, then the INTER frame it predicts, on the native path
  (libdav1d's first picture is the inter frame): the reference's array;
- ``/img`` and ``/upload`` to WebP through both apps on both paths: the
  same statuses, types and bodies;
- the committed 1920x1080 files of ``chip_smoke.py``'s phase 29
  (``inter_arrays.json``): the arrays and libdav1d's planes whose digests
  were taken where they were made, the reference's array now, and the
  tools each decode uses.
"""

import hashlib
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from imagekit_tpu import codecs as ref_codecs
from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch import codecs as port_codecs
from imagekit_tpu_torch.codecs.native import av1_dec_abi
from tests.fixtures import make_avif_sources as M
from tests.test_torch_avif_libavif import assert_same
from tests.test_torch_avif_sources import _upload
from tests.test_torch_jxc_slice import _ref_native_lib
from tests.test_torch_pillow_sources import _img, _serve, _url

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "avif"
needs_libs = pytest.mark.skipif(
    not (ref_avif.decode_available() and M._aom_lib() is not None
         and M._avif_lib() is not None),
    reason="libdav1d (the oracle), libaom.so.3 or libavif.so.15 (the "
           "writers) unavailable")


@lru_cache(maxsize=1)
def _plain_avif() -> bytes:
    return M.encode_avif_hbd(np.full((64, 64), 128, np.uint8),
                             np.full((32, 32), 128, np.uint8),
                             np.full((32, 32), 128, np.uint8), 8, "420", 30)


@pytest.fixture(autouse=True)
def _reference(monkeypatch):
    """The reference's native library loaded, its libdav1d path validated
    by a plain file first, its state kept to this test (the path turns
    itself off for good where the first picture it checks is not its
    container's size, which half-size bases are)."""
    _ref_native_lib(monkeypatch)
    for key, value in (("disabled", False), ("validated", False)):
        monkeypatch.setitem(ref_avif._state, key, value)
    if ref_avif.decode_available():
        assert ref_avif.decode_rgb(_plain_avif()) is not None


def _layers(w, h, depth, layout, seed, frames=2, **kw) -> bytes:
    obu = M.inter_obu(w, h, depth, layout, seed, frames,
                      shift=(2.1, -1.3), **kw)
    return M.av1_avif(M.as_layers(obu), w, h, depth, layout)


#: name -> (file, the path the reference takes)
FILES = {
    "half_base_8bit_420": (lambda: _layers(128, 96, 8, "420", 91,
                                           resize_kf_denom=16), "pillow"),
    "half_base_10bit_444": (lambda: _layers(128, 96, 10, "444", 92,
                                            resize_kf_denom=16), "pillow"),
    "same_size_no_colr": (lambda: M.set_colr(_layers(96, 64, 8, "420", 93),
                                             []), "pillow"),
    "compound_3layer_no_colr": (lambda: M.set_colr(M.av1_avif(
        M.as_layers(M.inter_obu(**M.INTER_CASES["obmc_compound"][0])),
        192, 128, 8, "420"), []), "pillow"),
    "hidden_key_native": (lambda: M.av1_avif(M.hidden_key_inter(
        M.inter_obu(96, 64, 8, "420", 94, 2, shift=(1.5, 1.0),
                    options={"num-tile-groups": 2})), 96, 64, 8, "420"),
        "native"),
}


@lru_cache(maxsize=None)
def file(name: str) -> bytes:
    return FILES[name][0]()


@needs_libs
@pytest.mark.parametrize("name", sorted(FILES))
def test_inter_avifs_equal_the_reference(name):
    """The reference's path (native: libdav1d's first picture; pillow:
    libavif's highest layer), and the same array from the port."""
    data = file(name)
    native = ref_avif.decode_rgb(data) is not None
    assert native == (FILES[name][1] == "native")
    want = assert_same(data)
    assert isinstance(want, np.ndarray)
    obu = ref_avif.parse_container(data).obu
    info = av1_dec_abi.probe(obu, select=av1_dec_abi.FIRST if native
                             else av1_dec_abi.HIGHEST)
    assert info.inter


@needs_libs
def test_img_and_upload_as_the_reference_app(tmp_path):
    """``/img`` and ``/upload`` at w=48 to WebP: the same statuses, types
    and bodies through both apps, on both paths."""
    sources = {name: file(name) for name in FILES}

    async def fn(client):
        outs = []
        for name, data in sources.items():
            outs.append(await _img(client, url=_url(name), w=48))
            outs.append(await _upload(client, data, w=48))
        return outs

    ref = _serve(tmp_path, "ref", sources, fn)
    port = _serve(tmp_path, "port", sources, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        assert pb == rb


def _table() -> dict:
    return json.loads((FIXTURES / "inter_arrays.json").read_text())


@pytest.mark.parametrize("name", sorted(_table()))
def test_committed_inter_fixtures(name):
    """Each committed file decodes to the array whose digest was taken from
    the reference where it was made, and to the reference's array now; the
    port's planes of its output frame are libdav1d's (digests of the raw
    samples and of the 8-bit planes), and its decode uses the tools it
    was recorded with."""
    entry = _table()[name]
    data = (FIXTURES / entry["file"]).read_bytes()
    got = port_codecs.decode_bytes(data, device="cpu")[0]
    assert got.shape == (entry["height"], entry["width"], 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    assert np.array_equal(got, ref_codecs.decode_bytes(data)[0])
    native = entry["path"] == "native"
    if ref_avif.decode_available():
        assert (ref_avif.decode_rgb(data) is not None) == native
    obu = ref_avif.parse_container(data).obu
    y, u, v, info = av1_dec_abi.decode_samples(
        obu, select=av1_dec_abi.FIRST if native else av1_dec_abi.HIGHEST)
    h8, hs = hashlib.sha256(), hashlib.sha256()
    for p in (y, u, v):
        h8.update(np.ascontiguousarray(
            av1_dec_abi.to_8bit(p, info.bitdepth)).tobytes())
        hs.update(np.ascontiguousarray(p).astype(
            "<u2" if info.bitdepth > 8 else np.uint8).tobytes())
    assert h8.hexdigest() == entry["planes_sha256"]
    assert hs.hexdigest() == entry["samples_sha256"]
    assert (info.frames, info.decoded) == (entry["frames"], entry["decoded"])
    assert {k: v for k, v in info.tools.items() if v} == entry["tools"]
