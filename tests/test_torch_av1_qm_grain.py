"""Quantizer matrices and film grain in the port's AV1 decoder
(``codecs/native/av1_decode.cpp``), against libdav1d, byte for byte.

- Quantizer matrices (spec 7.12.3, Quantizer_Matrix): Pillow's writer
  (libavif with libaom) with ``enable-qm`` and ``qm-min`` = ``qm-max``
  swept over the levels 0-15, and with libaom's still-image tuning
  ``tune=iq``, in each chroma layout and at odd sizes; 10- and 12-bit
  streams through libavif's C API.
- Film grain synthesis (spec 7.18.3): libaom's sixteen built-in test
  vectors (``film-grain-test``) in 4:2:0, 4:2:2, 4:4:4 and monochrome, at
  10 and 12 bits, with screen content (palettes and intra block copy),
  and in an alpha item. What no vector sets (``clip_to_restricted_range``,
  ``chroma_scaling_from_luma``, ``overlap_flag`` 0, chroma points with no
  luma points, lags 0 and 1, the identity matrix's restricted range,
  random params) is written into
  real streams here: :func:`with_grain` reads a reduced still-picture
  header up to its film grain params (:class:`HeaderReader`) and splices
  params of its own in (:func:`grain_bits`), checked first by writing a
  stream's own params back to the same bytes. Hostile params answer 400
  where libdav1d refuses them, and never crash.
- libdav1d with ``apply_grain`` off (:func:`dav1d_planes`) shows that each
  grain stream's grain changed the picture, and equals the port's decode
  with its own ``apply_grain`` off; the threaded stripes give the planes
  of one worker.
- One file of each tool through ``/img`` and ``/upload`` against the
  reference app.
"""

import io

import numpy as np
import pytest

from imagekit_tpu.codecs import avif_native as ref_avif
from imagekit_tpu_torch.codecs.native import av1_dec_abi
from tests.conftest import psnr
from tests.fixtures.make_avif_sources import dav1d_samples, encode_avif_hbd
from tests.test_torch_av1_decode import (
    PIL,
    assert_file_equal,
    needs_oracles,
    obu,
    pillow_avif,
    synth,
)
from tests.test_torch_av1_screen_hbd import (
    assert_samples_equal,
    flat_logo,
    hbd_picture,
    ui_text,
)
from tests.test_torch_pillow_sources import _decoded, _img, _serve, _url
from tests.test_torch_rgba_slice import _out_size

LAYOUTS = ["4:2:0", "4:2:2", "4:4:4"]


def dav1d_planes(obu: bytes, apply_grain: bool = True):
    """libdav1d's u8 planes of ``obu`` (None where it refuses the stream),
    with its ``apply_grain`` setting as asked: off, its picture is the
    reconstruction before the grain."""
    got = dav1d_samples(obu, apply_grain)
    if got is None:
        return None
    return [av1_dec_abi.to_8bit(p, got[3]) for p in got[:3]]


def assert_obu_equal(obu: bytes, what: str = "") -> av1_dec_abi.StreamInfo:
    """The port's u8 planes of a bare OBU stream equal libdav1d's."""
    want = dav1d_planes(obu)
    assert want is not None, f"libdav1d does not decode {what}"
    y, u, v, info = av1_dec_abi.decode(obu)
    for name, got, exp in zip("YUV", (y, u, v), want):
        if exp is None:
            assert got is None, (what, name)
            continue
        assert got.shape == exp.shape, (what, name)
        diff = np.argwhere(got != exp)
        assert not len(diff), (what, name, len(diff), diff[0].tolist())
    return info


def grain_changes(obu: bytes) -> bool:
    """Whether libdav1d's picture with its grain differs from the one
    without."""
    with_g, without = dav1d_planes(obu), dav1d_planes(obu, False)
    return any(a is not None and not np.array_equal(a, b)
               for a, b in zip(with_g, without))


def colour_obu(data: bytes) -> bytes:
    return ref_avif.parse_container(data).obu


# -- headers, read and written bit by bit -------------------------------------


class HeaderReader:
    """The bits of a reduced still-picture sequence header and of its
    KEY_FRAME's uncompressed header, read as the specification (5.5, 5.9)
    orders them, as far as the film grain params: the syntax that
    Pillow's writer and the port's encoder use (no frame ids, no
    timing)."""

    def __init__(self, payload: bytes, pos: int = 0):
        self.bits = "".join(f"{b:08b}" for b in payload)
        self.pos = pos

    def f(self, n: int) -> int:
        v = int(self.bits[self.pos:self.pos + n] or "0", 2)
        self.pos += n
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def seq(self) -> dict:
        s = {"profile": self.f(3)}
        self.f(1)
        assert self.f(1), "not a reduced still-picture header"
        self.f(5)
        wb, hb = self.f(4) + 1, self.f(4) + 1
        s["width_bits"] = wb
        s["w"], s["h"] = self.f(wb) + 1, self.f(hb) + 1
        s["sb128"], _, _ = self.f(1), self.f(1), self.f(1)
        s["superres"], s["cdef"], s["lr"] = self.f(1), self.f(1), self.f(1)
        hbd = self.f(1)
        twelve = self.f(1) if s["profile"] == 2 and hbd else 0
        s["mono"] = 0 if s["profile"] == 1 else self.f(1)
        mc = 2
        s["colour_bit"] = self.pos
        if self.f(1):
            cp, tc, mc = self.f(8), self.f(8), self.f(8)
        s["matrix"] = mc
        if s["mono"]:
            self.f(1)
            s["ssx"] = s["ssy"] = 1
            s["sep_uv"] = 0
        else:
            if mc == 0 and cp == 1 and tc == 13:
                s["ssx"] = s["ssy"] = 0
            else:
                s["range_bit"] = self.pos
                self.f(1)
                if s["profile"] == 0:
                    s["ssx"] = s["ssy"] = 1
                elif s["profile"] == 1:
                    s["ssx"] = s["ssy"] = 0
                elif twelve:
                    s["ssx"] = self.f(1)
                    s["ssy"] = self.f(1) if s["ssx"] else 0
                else:
                    s["ssx"], s["ssy"] = 1, 0
                if s["ssx"] and s["ssy"]:
                    self.f(2)
            s["sep_uv"] = self.f(1)
        s["grain_bit"] = self.pos
        s["film_grain"] = self.f(1)
        return s

    def frame(self, s: dict) -> int:
        """Reads up to the film grain params; returns where they start.
        ``self.info`` then holds what was read of the frame: the coded
        width (``frame_width``, downscaled by superres), ``superres_denom``,
        ``base_q_idx``, ``coded_lossless`` and the planes' restoration
        types (``lr_types``: 0 none, 1 Wiener, 2 self-guided, 3
        switchable)."""
        planes = 1 if s["mono"] else 3
        self.f(1)
        sct = self.f(1)
        if sct:
            self.f(1)
        width, denom, denom_bit = s["w"], 8, None
        if s["superres"] and self.f(1):
            denom_bit = self.pos
            denom = self.f(3) + 9
            width = max((s["w"] * 8 + denom // 2) // denom, min(16, s["w"]))
        if self.f(1):
            self.f(32)
        intrabc = self.f(1) if sct and width == s["w"] else 0
        mi_cols = 2 * ((width + 7) >> 3)
        mi_rows = 2 * ((s["h"] + 7) >> 3)
        shift = 5 if s["sb128"] else 4
        sb_cols = (mi_cols + (1 << shift) - 1) >> shift
        sb_rows = (mi_rows + (1 << shift) - 1) >> shift
        sb_size = shift + 2

        def log2(blk, target):
            k = 0
            while (blk << k) < target:
                k += 1
            return k

        max_w = 4096 >> sb_size
        min_cols = log2(max_w, sb_cols)
        max_cols, max_rows = log2(1, min(sb_cols, 64)), log2(1, min(sb_rows,
                                                                    64))
        min_tiles = max(min_cols, log2((4096 * 2304) >> (2 * sb_size),
                                       sb_rows * sb_cols))
        if self.f(1):
            cols = min_cols
            while cols < max_cols and self.f(1):
                cols += 1
            rows = max(min_tiles - cols, 0)
            while rows < max_rows and self.f(1):
                rows += 1
        else:
            start, widest, n = 0, 0, 0
            while start < sb_cols:
                size = self.ns(min(sb_cols - start, max_w)) + 1
                widest, start, n = max(widest, size), start + size, n + 1
            cols = log2(1, n)
            area = ((sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles
                    else sb_rows * sb_cols)
            max_h = max(area // widest, 1)
            start, n = 0, 0
            while start < sb_rows:
                start, n = start + self.ns(min(sb_rows - start, max_h)) + 1, \
                    n + 1
            rows = log2(1, n)
        if cols or rows:
            self.f(cols + rows)
            self.f(2)
        base_q = self.f(8)
        deltas = [self.su(7) if self.f(1) else 0]
        if planes > 1:
            diff = self.f(1) if s["sep_uv"] else 0
            deltas += [self.su(7) if self.f(1) else 0 for _ in range(
                4 if diff else 2)]
        if self.f(1):
            self.f(8 if not s["sep_uv"] else 12)
        seg_q = [0] * 8
        if self.f(1):
            for i in range(8):
                for j, (bits, signed) in enumerate(
                        [(8, 1), (6, 1), (6, 1), (6, 1), (6, 1), (3, 0),
                         (0, 0), (0, 0)]):
                    if self.f(1):
                        v = self.su(1 + bits) if signed else self.f(bits)
                        if j == 0:
                            seg_q[i] = max(-255, min(255, v))
        dq = self.f(1) if base_q > 0 else 0
        if dq:
            self.f(2)
            if not intrabc and self.f(1):
                self.f(3)
        coded_lossless = all(
            max(0, min(255, base_q + q)) == 0 for q in seg_q) and not any(
                deltas)
        if not coded_lossless and not intrabc:
            l0, l1 = self.f(6), self.f(6)
            if planes > 1 and (l0 or l1):
                self.f(12)
            self.f(3)
            if self.f(1) and self.f(1):
                for _ in range(10):
                    if self.f(1):
                        self.f(7)
        if not coded_lossless and not intrabc and s["cdef"]:
            self.f(2)
            for _ in range(1 << self.f(2)):
                self.f(6 if planes == 1 else 12)
        types = [0] * planes
        if not (coded_lossless and width == s["w"]) and not intrabc \
                and s["lr"]:
            types = [self.f(2) for _ in range(planes)]
            if any(types):
                if s["sb128"]:
                    self.f(1)
                elif self.f(1):
                    self.f(1)
                if s["ssx"] and s["ssy"] and any(types[1:]):
                    self.f(1)
        if not coded_lossless:
            self.f(1)
        self.f(1)
        self.info = {"frame_width": width, "superres_denom": denom,
                     "denom_bit": denom_bit,
                     "base_q_idx": base_q, "coded_lossless": coded_lossless,
                     "lr_types": [(0, 3, 1, 2)[t] for t in types]}
        return self.pos

    def grain(self, s: dict) -> dict:
        """film_grain_params() of an intra frame, once present."""
        if not self.f(1):
            return {"apply": 0}
        g = {"apply": 1, "seed": self.f(16)}

        def points():
            return [(self.f(8), self.f(8)) for _ in range(self.f(4))]

        g["y"] = points()
        g["cfl"] = 0 if s["mono"] else self.f(1)
        g["cb"] = g["cr"] = []
        if not (s["mono"] or g["cfl"] or (s["ssx"] and s["ssy"]
                                          and not g["y"])):
            g["cb"], g["cr"] = points(), points()
        g["scaling_shift"] = self.f(2) + 8
        g["lag"] = self.f(2)
        n = 2 * g["lag"] * (g["lag"] + 1)
        g["ar_y"] = [self.f(8) - 128 for _ in range(n)] if g["y"] else []
        for c in ("cb", "cr"):
            g["ar_" + c] = ([self.f(8) - 128 for _ in range(n + bool(g["y"]))]
                            if g[c] or g["cfl"] else [])
        g["ar_shift"] = self.f(2) + 6
        g["grain_scale_shift"] = self.f(2)
        for c in ("cb", "cr"):
            if g[c]:
                g[c + "_mult"] = (self.f(8), self.f(8), self.f(9))
        g["overlap"], g["clip"] = self.f(1), self.f(1)
        return g


def grain_bits(g: dict, seq: dict) -> str:
    """film_grain_params() of ``g`` (the keys :meth:`HeaderReader.grain`
    returns) for a stream of sequence ``seq``, as a string of bits, in the
    order the reader reads them and with no check of the values: hostile
    params are written as asked. The auto-regressive coefficients are
    taken from the front of each list, as many as the lag and the points
    read."""
    b = []

    def f(v, n):
        b.append(format(v & ((1 << n) - 1), f"0{n}b"))

    f(g["apply"], 1)
    if not g["apply"]:
        return "".join(b)
    f(g["seed"], 16)

    def points(pts):
        f(len(pts), 4)
        for x, s in pts:
            f(x, 8)
            f(s, 8)

    points(g["y"])
    cfl = 0 if seq["mono"] else g["cfl"]
    if not seq["mono"]:
        f(cfl, 1)
    chroma = not (seq["mono"] or cfl or (seq["ssx"] and seq["ssy"]
                                         and not g["y"]))
    cb, cr = (g["cb"], g["cr"]) if chroma else ([], [])
    if chroma:
        points(cb)
        points(cr)
    f(g["scaling_shift"] - 8, 2)
    f(g["lag"], 2)
    n = 2 * g["lag"] * (g["lag"] + 1)
    if g["y"]:
        for c in g["ar_y"][:n]:
            f(c + 128, 8)
    for pts, key in ((cb, "ar_cb"), (cr, "ar_cr")):
        if pts or cfl:
            for c in g[key][:n + bool(g["y"])]:
                f(c + 128, 8)
    f(g["ar_shift"] - 6, 2)
    f(g["grain_scale_shift"], 2)
    for pts, key in ((cb, "cb_mult"), (cr, "cr_mult")):
        if pts:
            m, lm, off = g[key]
            f(m, 8)
            f(lm, 8)
            f(off, 9)
    f(g["overlap"], 1)
    f(g["clip"], 1)
    return "".join(b)


def _obus(stream: bytes):
    """(type, payload) of each OBU (header byte with the size flag, no
    extension)."""
    out, p = [], 0
    while p < len(stream):
        kind = (stream[p] >> 3) & 15
        p += 1
        size, i = 0, 0
        while True:
            byte = stream[p]
            p += 1
            size |= (byte & 0x7F) << (7 * i)
            i += 1
            if not byte & 0x80:
                break
        out.append((kind, stream[p:p + size]))
        p += size
    return out


def _to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def read_grain(stream: bytes):
    """(sequence fields, the frame's grain params or None) of a stream."""
    kinds = _obus(stream)
    seq = HeaderReader(next(p for k, p in kinds if k == 1)).seq()
    frame = HeaderReader(next(p for k, p in kinds if k == 6))
    frame.frame(seq)
    return seq, (frame.grain(seq) if seq["film_grain"] else None)


def with_grain(stream: bytes, g: dict, identity: bool = False) -> bytes:
    """``stream`` (a sequence header and one frame OBU) with
    film_grain_params_present set and the frame's grain params replaced
    by ``g``'s bits; with ``identity`` (a profile-1 stream with no colour
    description) its sequence header also says BT.709 primaries, sRGB
    transfer and the identity matrix, which the reconstruction ignores
    and the grain's restricted range does not."""
    out = b""
    seq = None
    for kind, payload in _obus(stream):
        if kind == 1:
            r = HeaderReader(payload)
            seq = r.seq()
            bits = r.bits[:seq["grain_bit"]] + "1" + "1"
            if identity:
                assert seq["profile"] == 1 and seq["matrix"] == 2
                bits = (bits[:seq["colour_bit"]] + "1" + "00000001"
                        + "00001101" + "00000000"
                        + bits[seq["range_bit"] + 1:])
                seq["matrix"] = 0
            payload = _to_bytes(bits)
        elif kind == 6:
            r = HeaderReader(payload)
            start = r.frame(seq)
            if seq["film_grain"]:
                r.grain(seq)
            tiles = (r.pos + 7) // 8
            body = grain_bits(g, seq)
            payload = _to_bytes(r.bits[:start] + body) + payload[tiles:]
        out += obu(kind, payload)
    return out


def params(**kw) -> dict:
    """Grain params: a luma curve, Cb and Cr points of their own, lag 2,
    overlap on, unless ``kw`` says otherwise; seeded coefficients."""
    g = {"apply": 1, "seed": 4321, "y": [(0, 20), (128, 60), (255, 30)],
         "cfl": 0, "cb": [(0, 30), (255, 50)], "cr": [(40, 20), (200, 70)],
         "scaling_shift": 9, "lag": 2, "ar_shift": 7,
         "grain_scale_shift": 0, "cb_mult": (140, 100, 300),
         "cr_mult": (120, 150, 200), "overlap": 1, "clip": 0}
    g.update(kw)
    rng = np.random.default_rng(g["seed"])
    for key in ("ar_y", "ar_cb", "ar_cr"):
        g.setdefault(key, rng.integers(-40, 40, 25).tolist())
    return g


# -- quantizer matrices -------------------------------------------------------


@needs_oracles
@pytest.mark.parametrize("sub", LAYOUTS)
@pytest.mark.parametrize("level", range(16))
def test_quantizer_matrix_levels(level, sub):
    """One level for every plane (``qm-min`` = ``qm-max``): the matrices
    of each transform size and type at that level (15: flat)."""
    data = pillow_avif(synth(96, 64, seed=level, kind="edges"), quality=50,
                       subsampling=sub,
                       advanced=[("enable-qm", "1"), ("qm-min", str(level)),
                                 ("qm-max", str(level))])
    assert av1_dec_abi.probe(colour_obu(data)).qmatrix
    assert_file_equal(data, f"qm {level} {sub}")


@needs_oracles
@pytest.mark.parametrize("size", [(255, 191), (97, 33), (17, 9)])
@pytest.mark.parametrize("sub", LAYOUTS)
def test_tune_iq(sub, size):
    """libaom's still-image tuning turns quantizer matrices on, with its
    own levels by quality, at sizes cut by the MI grid."""
    w, h = size
    for quality in (30, 80):
        data = pillow_avif(synth(w, h, seed=quality), quality=quality,
                           subsampling=sub, advanced=[("tune", "iq")])
        assert av1_dec_abi.probe(colour_obu(data)).qmatrix
        assert_file_equal(data, f"tune=iq q{quality} {w}x{h} {sub}")


@needs_oracles
@pytest.mark.parametrize("depth, layout", [(10, "420"), (10, "444"),
                                           (12, "422")])
def test_quantizer_matrices_high_bit_depth(depth, layout):
    data = encode_avif_hbd(*hbd_picture(99, 67, depth, layout, depth),
                           depth, layout, 30, 6,
                           {"enable-qm": "1", "qm-min": "2", "qm-max": "9"})
    if data is None:
        pytest.skip("libavif's high-bit-depth encode unavailable")
    assert assert_samples_equal(data, f"qm {depth} {layout}").qmatrix


@needs_oracles
def test_quantizer_matrices_with_intra_block_copy():
    """Screen content with quantizer matrices: intra block copy's inter
    transform sets reach IDTX and the 1-D types, which stay flat."""
    data = pillow_avif(ui_text(256, 192, seed=4), quality=60,
                       advanced=[("enable-qm", "1"), ("qm-min", "0"),
                                 ("qm-max", "4")])
    assert_file_equal(data, "qm with intrabc")
    info = av1_dec_abi.decode(colour_obu(data))[3]
    assert info.qmatrix and info.intrabc_blocks > 0


# -- film grain: libaom's test vectors ----------------------------------------


def mono_avif(w: int, h: int, seed: int, options=None) -> bytes:
    """A true monochrome (YUV400) 8-bit AVIF through libavif's C API:
    Pillow's writer codes an L picture as 4:2:0 with grey chroma."""
    data = encode_avif_hbd(synth(w, h, seed=seed)[:, :, 0], None, None, 8,
                           "400", 30, 6, options)
    if data is None:
        pytest.skip("libavif's C API unavailable")
    return data


def grain_file(vector: int, sub: str, w: int = 97, h: int = 61) -> bytes:
    """A picture with libaom's film grain test vector ``vector``
    ("mono": monochrome, through :func:`mono_avif`)."""
    opt = ("film-grain-test", str(vector))
    if sub == "mono":
        return mono_avif(w, h, vector, dict([opt]))
    return pillow_avif(synth(w, h, seed=vector), subsampling=sub,
                       quality=50, advanced=[opt])


@needs_oracles
@pytest.mark.parametrize("sub", LAYOUTS + ["mono"])
@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_test_vectors(vector, sub):
    """Every test vector (its lag, its points, its overlap) in every
    layout, at a size whose stripes and blocks the frame's edges cut."""
    data = grain_file(vector, sub)
    obu = colour_obu(data)
    head = av1_dec_abi.probe(obu)
    assert head.film_grain and head.mono == (sub == "mono")
    assert_file_equal(data, f"grain {vector} {sub}")
    assert grain_changes(obu)
    # the reconstruction alone, as libdav1d's with apply_grain off
    bare = av1_dec_abi._decode_samples(obu, apply_grain=False)
    for got, want in zip((av1_dec_abi.to_8bit(p, bare[3].bitdepth)
                          for p in bare[:3]), dav1d_planes(obu, False)):
        assert (got is None and want is None) or np.array_equal(got, want)


@needs_oracles
@pytest.mark.parametrize("size", [(256, 192), (33, 65), (1, 1), (130, 3)])
def test_film_grain_sizes(size):
    """Several stripes and blocks, and frames of one block or one row."""
    w, h = size
    for sub in ("4:2:0", "4:2:2"):
        data = grain_file(10, sub, w, h)
        assert_file_equal(data, f"grain {w}x{h} {sub}")


@needs_oracles
@pytest.mark.parametrize("depth, layout", [(10, "420"), (10, "422"),
                                           (10, "444"), (12, "420"),
                                           (12, "444")])
@pytest.mark.parametrize("vector", [3, 10])
def test_film_grain_high_bit_depth(depth, layout, vector):
    """The grain at 10 and 12 bits (the scaling interpolated between
    lookup entries), before the rounding to 8; with quantizer matrices
    too."""
    data = encode_avif_hbd(*hbd_picture(97, 67, depth, layout, vector),
                           depth, layout, 30, 6,
                           {"film-grain-test": str(vector),
                            "enable-qm": "1"})
    if data is None:
        pytest.skip("libavif's high-bit-depth encode unavailable")
    head = assert_samples_equal(data, f"grain {vector} {depth} {layout}")
    assert head.film_grain and head.qmatrix
    assert grain_changes(colour_obu(data))


@needs_oracles
@pytest.mark.parametrize("picture", ["text", "logo"])
def test_film_grain_with_screen_content(picture):
    """Grain over a frame of palette blocks and intra block copy, which
    reads the frame before its grain."""
    img = (ui_text(256, 192, seed=8) if picture == "text"
           else flat_logo(192, 128, seed=8))
    data = pillow_avif(img, quality=60,
                       advanced=[("film-grain-test", "6")])
    assert_file_equal(data, f"grain over {picture}")
    info = av1_dec_abi.decode(colour_obu(data))[3]
    assert info.film_grain and info.palette_blocks > 0
    if picture == "text":
        assert info.intrabc_blocks > 0


@needs_oracles
def test_film_grain_in_the_alpha_item():
    """The reference decodes alpha through the same libdav1d call: its
    grain too."""
    rgba = np.dstack([synth(96, 64, seed=3),
                      (np.arange(96)[None, :] * 2 * np.ones((64, 1))).astype(
                          np.uint8)])
    buf = io.BytesIO()
    PIL.fromarray(rgba, "RGBA").save(buf, "AVIF", quality=60,
                                     advanced=[("film-grain-test", "2")])
    info = ref_avif.parse_container(buf.getvalue())
    assert av1_dec_abi.probe(info.alpha_obu).film_grain
    assert_file_equal(buf.getvalue(), "grain rgba")


# -- film grain: params written here ------------------------------------------


def _base_stream(sub: str) -> bytes:
    """A grain-free stream of Pillow's writer (or libavif's, for
    monochrome) to splice params into."""
    if sub == "mono":
        return colour_obu(mono_avif(90, 70, 11))
    return colour_obu(pillow_avif(synth(90, 70, seed=11), quality=55,
                                  subsampling=sub))


@needs_oracles
@pytest.mark.parametrize("vector", [1, 4, 9, 16])
def test_header_reader_rewrites_a_vector_to_its_own_bytes(vector):
    """The reader finds the params where they are: a test vector's read
    and written back gives the stream's own bytes."""
    obu = colour_obu(grain_file(vector, "4:2:0"))
    seq, g = read_grain(obu)
    assert g["apply"]
    assert with_grain(obu, g) == obu


@needs_oracles
@pytest.mark.parametrize("sub", LAYOUTS + ["mono"])
@pytest.mark.parametrize("case", [
    "clip", "cfl", "cfl_clip", "no_overlap", "lag3", "lag0",
    "chroma_only", "luma_only", "scale_shift", "extreme_points"])
def test_written_grain_params(case, sub):
    """Params no test vector sets, held to libdav1d."""
    g = {
        "clip": params(clip=1),
        "cfl": params(cfl=1, cb=[], cr=[]),
        "cfl_clip": params(cfl=1, cb=[], cr=[], clip=1),
        "no_overlap": params(overlap=0),
        "lag3": params(lag=3, ar_shift=9),
        "lag0": params(lag=0),
        # 4:2:0 reads no chroma points without luma points
        "chroma_only": params(y=[], lag=1),
        "luma_only": params(cb=[], cr=[]),
        "scale_shift": params(scaling_shift=11, grain_scale_shift=3),
        "extreme_points": params(y=[(0, 255), (255, 255)],
                                 cb=[(0, 255)], cr=[(255, 0)],
                                 scaling_shift=8),
    }[case]
    obu = with_grain(_base_stream(sub), g)
    info = assert_obu_equal(obu, f"{case} {sub}")
    # monochrome and 4:2:0 read no chroma points without luma points
    read = read_grain(obu)[1]
    assert info.film_grain
    assert grain_changes(obu) == bool(read["y"] or read["cb"] or read["cr"])


@needs_oracles
def test_restricted_range_of_the_identity_matrix():
    """With the identity matrix, chroma clips to the luma's 235 (240
    otherwise)."""
    g = params(clip=1, cb=[(0, 255), (255, 255)], cr=[(0, 255)],
               cb_mult=(128, 192, 320), scaling_shift=8)
    base = _base_stream("4:4:4")
    identity = with_grain(base, g, identity=True)
    assert read_grain(identity)[0]["matrix"] == 0
    info = assert_obu_equal(identity, "identity, restricted range")
    assert info.matrix == 0
    planes = av1_dec_abi.decode(identity)
    other = av1_dec_abi.decode(with_grain(base, g))
    assert max(planes[1].max(), planes[2].max()) <= 235
    assert max(other[1].max(), other[2].max()) > 235


@needs_oracles
def test_clip_with_no_points_leaves_the_frame():
    """chroma_scaling_from_luma and clip_to_restricted_range with no luma
    points adds no noise; the spec would still clip the chroma, libdav1d
    leaves the frame as it was, and so does the port."""
    g = params(y=[], cfl=1, cb=[], cr=[], clip=1, lag=0)
    obu = with_grain(_base_stream("4:4:4"), g)
    assert_obu_equal(obu, "clip only")
    assert not grain_changes(obu)


@needs_oracles
def test_random_grain_params():
    """Seeded random params in each layout."""
    rng = np.random.default_rng(21)
    for i in range(24):
        sub = ["4:2:0", "4:2:2", "4:4:4", "mono"][i % 4]

        def pts(n):
            xs = sorted(rng.choice(256, n, replace=False).tolist())
            return [(x, int(rng.integers(0, 256))) for x in xs]

        ny = int(rng.integers(0, 15))
        cfl = int(rng.integers(0, 2)) if sub != "mono" else 0
        chroma = sub != "mono" and not cfl and not (sub == "4:2:0" and not ny)
        ncb = int(rng.integers(0, 11)) if chroma else 0
        ncr = int(rng.integers(0, 11)) if chroma else 0
        if sub == "4:2:0" and bool(ncb) != bool(ncr):
            ncr = ncb
        g = params(seed=int(rng.integers(0, 65536)), y=pts(ny), cfl=cfl,
                   cb=pts(ncb), cr=pts(ncr),
                   scaling_shift=int(rng.integers(8, 12)),
                   lag=int(rng.integers(0, 4)),
                   ar_shift=int(rng.integers(6, 10)),
                   grain_scale_shift=int(rng.integers(0, 4)),
                   cb_mult=tuple(int(v) for v in rng.integers(0, 256, 2))
                   + (int(rng.integers(0, 512)),),
                   cr_mult=tuple(int(v) for v in rng.integers(0, 256, 2))
                   + (int(rng.integers(0, 512)),),
                   overlap=int(rng.integers(0, 2)),
                   clip=int(rng.integers(0, 2)))
        assert_obu_equal(with_grain(_base_stream(sub), g), f"random {i} {sub}")


def hostile_grain():
    """Params libdav1d refuses, and random bytes over the params."""
    out = {
        "15 luma points": params(y=[(i * 10, 50) for i in range(15)]),
        "luma points repeat": params(y=[(10, 50), (10, 60)]),
        "luma points fall": params(y=[(100, 50), (20, 60)]),
        "11 cb points": params(cb=[(i * 20, 50) for i in range(11)]),
        "cr points fall": params(cr=[(200, 1), (100, 2)]),
        "4:2:0 cb without cr": params(cr=[]),
        "4:2:0 cr without cb": params(cb=[]),
    }
    return out


@needs_oracles
@pytest.mark.parametrize("case", sorted(hostile_grain()))
def test_hostile_grain_params_answer_400(case):
    obu = with_grain(_base_stream("4:2:0"), hostile_grain()[case])
    assert dav1d_planes(obu) is None
    with pytest.raises(ValueError, match="film grain"):
        av1_dec_abi.decode(obu)


@needs_oracles
def test_byte_flips_over_grain_params_never_crash():
    """Flips in the bytes of a frame header's grain params: the port
    decodes what libdav1d decodes, byte-equal, and refuses (400) only
    what libdav1d refuses."""
    obu = colour_obu(grain_file(10, "4:2:0", 64, 48))
    kinds = _obus(obu)
    seq = HeaderReader(next(p for k, p in kinds if k == 1)).seq()
    frame = next(p for k, p in kinds if k == 6)
    frame_at = obu.rfind(frame)
    r = HeaderReader(frame)
    start = r.frame(seq) // 8
    r.grain(seq)
    end = (r.pos + 7) // 8
    rng = np.random.default_rng(5)
    for _ in range(40):
        m = bytearray(obu)
        i = frame_at + int(rng.integers(start, end))
        m[i] ^= int(rng.integers(1, 256))
        want = dav1d_planes(bytes(m))
        try:
            got = av1_dec_abi.decode(bytes(m))
        except ValueError:
            assert want is None
            continue
        assert want is not None
        for a, b in zip(got[:3], want):
            assert (a is None and b is None) or np.array_equal(a, b)


# -- threads ------------------------------------------------------------------


@needs_oracles
def test_grain_stripes_on_one_worker_and_on_many():
    obu = colour_obu(grain_file(10, "4:2:0", 256, 192))
    many = av1_dec_abi.decode_samples(obu)
    av1_dec_abi._set_threads(1)
    try:
        one = av1_dec_abi.decode_samples(obu)
    finally:
        av1_dec_abi._set_threads(0)
    for a, b in zip(one[:3], many[:3]):
        assert np.array_equal(a, b)


# -- through the entry points -------------------------------------------------


def _kinds() -> dict:
    return {
        "qm": lambda: pillow_avif(synth(120, 88, seed=6), quality=60,
                                  advanced=[("tune", "iq")]),
        "grain": lambda: pillow_avif(synth(120, 88, seed=7), quality=60,
                                     advanced=[("film-grain-test", "3")]),
    }


@needs_oracles
@pytest.mark.parametrize("kind", sorted(_kinds()))
def test_img_and_upload_as_the_reference_app(tmp_path, kind):
    """``/img`` at w=64 and ``/upload`` at w=64: the same statuses and
    types through both apps, the same output size, WebP bodies within
    45 dB of the reference's (its AVIF contract is 38 dB)."""
    from tests.test_torch_avif_sources import _upload

    data = _kinds()[kind]()

    async def fn(client):
        return [await _img(client, url=_url("x"), w=64),
                await _upload(client, data, w=64)]

    ref = _serve(tmp_path, "ref", {"x": data}, fn)
    port = _serve(tmp_path, "port", {"x": data}, fn)
    for (rs, rct, rb), (ps, pct, pb) in zip(ref, port):
        assert (ps, pct) == (rs, rct) and ps == 200, pb[:200]
        assert _out_size(pb) == _out_size(rb)
        if pb != rb:
            assert psnr(_decoded(pb), _decoded(rb)) >= 45.0
