"""The port's AV1 decoder on INTER frames (``codecs/native/av1_decode.cpp``)
against libdav1d, byte for byte.

Each stream is libaom's GOOD usage over a texture in motion
(``make_avif_sources.inter_obu``: shifted, zoomed and turned, 64..192 px),
with libaom's switches set so that it codes the tool the stream is named
for (``make_avif_sources.INTER_CASES``): NEWMV and local warp at 8, 10 and
12 bits in every layout and in monochrome, global motion, dual filters,
OBMC, interintra (smooth and wedge), compound prediction (distance
weights, wedge and difference-weighted masks, skip mode), the temporal
candidates of the motion field, prediction across sizes (a key frame at
half size, a superres reference), tiles and film grain. Up to four frames
are spliced into spatial layers of one temporal unit
(``make_avif_sources.as_layers``, the layout of a progressive AVIF) and
decoded at the highest layer; longer chains are decoded whole to their
last frame (``av1_dec_abi.LAST``). The oracle is every picture libdav1d
returns (``make_avif_sources.dav1d_pictures``); the port's last must equal
libdav1d's last at the stream's own depth (the raw 10- and 12-bit
samples), and the decode must report the tool (``StreamInfo.tools``).

Also: the frames the output frame does not depend on stay undecoded; a
shown INTER frame of empty reference slots, and references past twice or
under a sixteenth of the frame's size, fail the stream (400) as libdav1d
fails it, those at the limits predict as libdav1d predicts; hostile inter
streams (truncations, byte flips) raise ValueError or decode, never crash
(under ASan and UBSan in ``test_torch_kernel_asan.py``).
"""

from functools import lru_cache

import numpy as np
import pytest

from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch.codecs.native import av1_dec_abi
from tests.fixtures import make_avif_sources as M
from tests.test_torch_av1_decode import inter_stream

needs_libs = pytest.mark.skipif(
    not (ref_avif.decode_available() and M._aom_lib() is not None),
    reason="libdav1d (the oracle) or libaom.so.3 (the writer) unavailable")


def frames(obu: bytes) -> int:
    return sum(1 for t, _ in M._obus(obu) if t in (3, 6))


@lru_cache(maxsize=None)
def stream(name: str):
    """The named case's stream as the decoder is given it, and the frame
    to ask for: its frames as spatial layers (the highest), or the whole
    chain past four frames (the last)."""
    obu = M.inter_obu(**M.INTER_CASES[name][0])
    if frames(obu) <= 4:
        return M.as_layers(obu), av1_dec_abi.HIGHEST
    return obu, av1_dec_abi.LAST


@needs_libs
@pytest.mark.parametrize("name", sorted(M.INTER_CASES))
def test_inter_planes_equal_libdav1d(name):
    obu, sel = stream(name)
    want = M.dav1d_pictures(obu)[-1]
    y, u, v, info = av1_dec_abi.decode_samples(obu, select=sel)
    depth = M.INTER_CASES[name][0]["depth"]
    assert y.dtype == (np.uint8 if depth == 8 else np.uint16)
    assert info.bitdepth == want[3] == depth
    for got, ref in zip((y, u, v), want[:3]):
        assert (got is None) == (ref is None)
        if got is not None:
            assert np.array_equal(got, ref)
    assert info.inter and info.decoded == frames(obu) == info.frames
    for tool in M.INTER_CASES[name][1]:
        assert info.tools[tool] > 0, tool
    # the 8-bit planes are the raw samples rounded as the reference rounds
    # libdav1d's
    y8 = av1_dec_abi.decode(obu, select=sel)[0]
    assert np.array_equal(y8, av1_dec_abi.to_8bit(want[0], depth))


@needs_libs
def test_probe_reports_the_inter_output_frame():
    obu = stream("half_size_base")[0]
    head = av1_dec_abi.probe(obu, select=av1_dec_abi.HIGHEST)
    base = av1_dec_abi.probe(obu)
    assert (head.inter, head.width, head.height, head.spatial_id) == (
        True, 128, 96, 1)
    assert (base.inter, base.width, base.height) == (False, 64, 48)
    # the probe reads no tiles: the tool counts are a decode's
    assert not any(head.tools.values())


@needs_libs
def test_frames_the_output_does_not_need_stay_undecoded():
    """Two key frames, then an INTER frame of the second: the first key
    frame is read and skipped (the second refreshed every slot), and the
    second layer's picture is libdav1d's."""
    a = M.inter_obu(96, 64, 8, "420", 71, 2, shift=(1.0, 0.5))
    b = M.inter_obu(96, 64, 8, "420", 72, 2, shift=(-1.5, 1.0))
    key_a = [o for t, o in M._obus(a) if t in (3, 4, 6)][0]
    frames_b = [o for t, o in M._obus(b) if t in (3, 4, 6)]
    seq = next(o for t, o in M._obus(b) if t == 1)
    obu = M.with_operating_points(seq, (0x701, 0x301, 0x101)) + b"".join(
        M.with_layer(f, 0, i) for i, f in enumerate([key_a] + frames_b))
    y, u, v, info = av1_dec_abi.decode_samples(obu,
                                               select=av1_dec_abi.HIGHEST)
    assert (info.frames, info.decoded) == (3, 2)
    want = M.dav1d_pictures(obu)[-1]
    assert all(np.array_equal(p, q) for p, q in zip((y, u, v), want[:3]))


@needs_libs
def test_a_hidden_key_frame_then_an_inter_frame():
    """A hidden KEY_FRAME, then the INTER frame it predicts, shown: the
    first picture libdav1d returns (the reference's native path) is the
    inter frame."""
    obu = M.hidden_key_inter(M.inter_obu(
        96, 64, 8, "420", 61, 2, shift=(1.5, 1.0),
        options={"num-tile-groups": 2}))
    y, u, v, info = av1_dec_abi.decode_samples(obu)
    assert info.inter and not info.shown_existing and info.decoded == 2
    want = ref_avif._decode_obu(obu, 96, 64)
    assert all(np.array_equal(p, q) for p, q in zip((y, u, v), want[:3]))


def test_an_inter_frame_of_empty_slots_fails_the_stream():
    with pytest.raises(ValueError, match="reference slot is empty"):
        av1_dec_abi.probe(inter_stream())
    if ref_avif.decode_available():
        assert ref_avif._decode_obu(inter_stream(), 64, 64) is None


def size_splice(ref_wh, frame_wh, seed: int = 81) -> bytes:
    """A key frame of ``ref_wh``, then the INTER frame of a stream of
    ``frame_wh``, as two spatial layers: both written for the larger
    size, so their sequence headers agree, the second with its key frame
    at half size, so that the inter frame's header codes its own size
    (none of its references has it). Its references are then the first
    key frame, of another size than the one it was written against."""
    big = tuple(max(a, b) for a, b in zip(ref_wh, frame_wh))

    def write(wh, sd, kf_denom):
        pics = M.moving_planes(*wh, 8, "420", sd, 2, shift=(1.0, 0.5))
        return M.encode_av1_libaom(*pics[0], 8, "420", 30, limit=2,
                                   forced_max=big, frames=2, good=True,
                                   later=pics[1:], options={"sb-size": "64"},
                                   resize_kf_denom=kf_denom)

    key = [o for t, o in M._obus(write(ref_wh, seed, 8))
           if t in (3, 4, 6)][0]
    obu = write(frame_wh, seed + 1, 16)
    inter = [o for t, o in M._obus(obu) if t in (3, 4, 6)][1]
    seq = next(o for t, o in M._obus(obu) if t == 1)
    return M.with_operating_points(seq, (0x301, 0x101)) + M.with_layer(
        key, 0, 0) + M.with_layer(inter, 0, 1)


#: (reference, frame) sizes at and past the rule of references at most
#: twice and at least a sixteenth of the frame's size
SIZE_RULE = {"2x_larger": ((128, 96), (64, 48)),
             "past_2x": ((160, 128), (64, 48)),
             "16x_smaller": ((10, 8), (160, 128)),
             "past_16x": ((8, 8), (160, 128))}


@needs_libs
@pytest.mark.parametrize("case", sorted(SIZE_RULE))
def test_references_at_and_past_the_size_rule(case):
    """A reference twice the frame's size, or a sixteenth of it, predicts
    (scaled: libdav1d's picture); one past either fails the stream, in
    libdav1d too."""
    obu = size_splice(*SIZE_RULE[case])
    pics = M.dav1d_pictures(obu)
    if case.startswith("past"):
        with pytest.raises(ValueError, match="2x / 16x"):
            av1_dec_abi.decode_samples(obu, select=av1_dec_abi.HIGHEST)
        assert pics[1:] == []
        return
    y, u, v, info = av1_dec_abi.decode_samples(obu,
                                               select=av1_dec_abi.HIGHEST)
    assert info.tools["scaled"] > 0
    assert all(np.array_equal(p, q) for p, q in zip((y, u, v), pics[-1][:3]))


def hostile_inter_streams() -> dict:
    """name -> stream: cuts and byte flips of four inter streams (local
    warp, compound prediction, prediction across sizes, a 12-bit chain):
    their tiles cut short, their symbols turned to noise (vectors far
    outside the frame, local warps of invalid shears, any reference); the
    references at and past the size rule (:data:`SIZE_RULE`); an INTER
    frame of empty slots."""
    rng = np.random.default_rng(25)
    out = {f"size_{k}": size_splice(*v) for k, v in SIZE_RULE.items()}
    out["empty_slots"] = inter_stream()
    for name in ("zoom_local_warp", "obmc_compound", "half_size_base",
                 "twelve_bit_chain"):
        obu = stream(name)[0]
        for i, cut in enumerate((0.55, 0.8, 0.95)):
            out[f"{name}_cut{i}"] = obu[:int(len(obu) * cut)]
        for i in range(6):
            b = bytearray(obu)
            for at in rng.integers(len(b) // 3, len(b), 6):
                b[at] ^= int(rng.integers(1, 256))
            out[f"{name}_flip{i}"] = bytes(b)
    return out


@needs_libs
def test_hostile_inter_streams_never_crash():
    """Each decodes or fails the stream (ValueError); among the noise,
    blocks predicted wholly from outside their reference and local warps
    of invalid shears."""
    seen = {"mv_outside": 0, "warp_invalid": 0}
    for s in hostile_inter_streams().values():
        try:
            y, _u, _v, info = av1_dec_abi.decode_samples(
                s, select=av1_dec_abi.LAST)
            assert y.shape == (info.height, info.width)
            for k in seen:
                seen[k] += info.tools[k]
        except ValueError:
            pass
    assert all(seen.values()), seen
