"""The RGB-output head on the k = 8 split-int8 transport, on the CPU.

``ops/dct.py::decode_resize_rgb_i8_batch`` (the reference's
``decode_resize_rgb_i8_batch``, ``imagekit_tpu/ops/dct.py:869``) widens the
AC planes and scatters the escapes, then runs the demoted RGB head's IDCT
and K3 (one launch). No engine path reaches it: the reference takes it only
where a native encoder or the split entropy entry is missing, and the
port's loader raises there. What is held, on real JPEGs packed by the
engine's own ``jpeg_transport._pack_split`` (escapes live):

- against the JAX ``decode_resize_rgb_i8_batch`` run with K3's semantics
  (``tests/test_torch_jxc_slice.py::k3_semantics``): u8 RGB within max
  |d| <= 2 on at most 0.1% of values, the demoted-RGB contract;
- against the port's ``decode_resize_rgb_batch`` on the same images' int16
  levels (``jpeg_abi.decode``): byte for byte, since the widen gives those
  levels exactly;
- the escapes matter (without them the output changes), and on the CPU the
  head takes K3's plain version (no launch counted).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from imagekit_tpu.ops import dct as ref_dct
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.ops import dct, resize_planes
from imagekit_tpu_torch.ops import weights as port_w
from imagekit_tpu_torch.serving.batch_types import _cached_weights
from imagekit_tpu_torch.serving.jpeg_transport import _pack_split
from imagekit_tpu_torch.utils.bucketing import bucket_for
from tests.conftest import encode_jpeg_pil
from tests.test_batcher import _noisy_jpeg
from tests.test_torch_cuda import block_edge_image
from tests.test_torch_jxc_slice import (  # noqa: F401
    _ref_native_lib,
    assert_rgb_band,
    k3_semantics,
)


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


def split_batch(datas, width: int, pad: int = 1):
    """The engine's k = 8 split batch of ``datas`` (one geometry) with
    ``pad`` empty items after them, the RGB head's stacks (chroma to full
    output resolution), and the same images' int16 levels: (split args,
    int16 args, true output (h, w))."""
    lib = loader.load()
    items, levels = [], []
    for d in datas:
        hdr, dc, ac, esc, qtabs, overflow = jpeg_abi.decode_lowfreq_i8(
            lib, d, 8)
        assert not overflow
        items.append(SimpleNamespace(split=(dc, ac, esc), hdr=hdr,
                                     qtabs=(qtabs[hdr.comp_tq[0]],
                                            qtabs[hdr.comp_tq[1]])))
        levels.append(jpeg_abi.decode(lib, d)[1])
    hdr = items[0].hdr
    iw, ih = hdr.width, hdr.height
    ow, oh = port_w.target_dimensions(iw, ih, width, None)
    yb_h = bucket_for((ih + 15) // 16 * 16)
    yb_w = bucket_for((iw + 15) // 16 * 16)
    obh, obw = bucket_for(oh), bucket_for(ow)
    block_dims = (yb_h // 8, yb_w // 8, yb_h // 16, yb_w // 16)
    nb = len(items) + pad
    dcs, acs, (escs,) = _pack_split(items, nb, *block_dims, 8)
    qt = np.zeros((nb, 128), np.float32)
    for i, it in enumerate(items):
        qt[i, :64], qt[i, 64:] = it.qtabs
    c_h, c_w = hdr.comp_height[1], hdr.comp_width[1]
    weights = tuple(w[None] for w in (
        _cached_weights(ih, oh, yb_h, obh), _cached_weights(iw, ow, yb_w, obw),
        port_w.combined_chroma_weights(c_h, ih, oh, yb_h // 2, obh),
        port_w.combined_chroma_weights(c_w, iw, ow, yb_w // 2, obw)))
    vidx = np.zeros(nb, np.int32)
    by, bx, cy, cx = block_dims
    flat = [np.zeros((nb, by, bx * 64), np.int16),
            np.zeros((nb, cy, cx * 64), np.int16),
            np.zeros((nb, cy, cx * 64), np.int16)]
    for i, lv in enumerate(levels):
        for p in range(3):
            rows, cols = lv[p].shape[:2]
            flat[p][i, :rows, :cols * 64] = lv[p].reshape(rows, -1)
    tail = (weights, vidx, block_dims, (obh, obw))
    return ((dcs, acs, escs, qt, *tail), (*flat, qt, *tail), (oh, ow))


CASES = {
    # (images, width): a noisy 4:2:0 photo-like JPEG with 1616 escapes, and
    # two block-edge JPEGs of one geometry (432 and more escapes a batch)
    "noisy_q92": (lambda: [_noisy_jpeg(640, 480, 92)], 240),
    "edges_q85": (lambda: [encode_jpeg_pil(block_edge_image(s, 640, 480), 85)
                           for s in (1, 2)], 400),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_under_k3(k3_semantics, case):
    make, width = CASES[case]
    split, _, (oh, ow) = split_batch(make(), width)
    want = ref_dct.decode_resize_rgb_i8_batch(*split)
    before = resize_planes.LAUNCHES
    got = dct.decode_resize_rgb_i8_batch(*split, device="cpu")
    assert resize_planes.LAUNCHES == before  # the CPU takes K3's plain version
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert_rgb_band(got, want)
    assert 40 < got[0, :oh, :ow].mean() < 215


@pytest.mark.parametrize("case", sorted(CASES))
def test_equals_the_int16_head_on_the_same_levels(case):
    make, width = CASES[case]
    split, int16, _ = split_batch(make(), width)
    got = dct.decode_resize_rgb_i8_batch(*split, device="cpu")
    assert np.array_equal(got, dct.decode_resize_rgb_batch(*int16,
                                                           device="cpu"))
    # the escapes are live: without them the picture changes
    dcs, acs, escs, *rest = split
    none = tuple((np.zeros_like(i), np.zeros_like(v)) for i, v in escs)
    assert int(np.abs(escs[0][1]).sum()) > 0
    assert not np.array_equal(
        got, dct.decode_resize_rgb_i8_batch(dcs, acs, none, *rest,
                                            device="cpu"))


def test_device_view_and_bands():
    """``host=False`` gives the device tensor of the same bytes; the band
    tables the engine builds for the RGB head give the same output."""
    import torch

    from imagekit_tpu_torch.ops.resize_strip import resize_tables

    split, _, _ = split_batch([_noisy_jpeg(640, 480, 92)], 240, pad=0)
    got = dct.decode_resize_rgb_i8_batch(*split, device="cpu")
    view = dct.decode_resize_rgb_i8_batch(*split, device="cpu", host=False)
    assert isinstance(view, torch.Tensor)
    assert np.array_equal(view.numpy().reshape(got.shape), got)
    stacks = [torch.from_numpy(w) for w in split[4]]
    bands = tuple(resize_tables(*pair) for pair in (stacks[:2], stacks[2:]))
    assert np.array_equal(
        dct.decode_resize_rgb_i8_batch(*split, bands=bands, device="cpu"),
        got)
