"""AVIF sources: the ISOBMFF container parse and the AV1 decode, without
libdav1d, libavif or Pillow.

The port's counterpart of ``imagekit_tpu/codecs/avif_native.py``. The
container layer (ftyp/meta/pitm/iinf/iloc/iprp walking, the clean
aperture, the alpha auxiliary item, the colour tags) and the colour and
range handling are the reference's, unchanged. Where the reference hands
the AV1 OBU payload to libdav1d over ctypes (``_decode_obu``), the port
decodes it with its own decoder, ``native/av1_decode.cpp`` (through
:mod:`.native.av1_dec_abi`), whose planes are byte-equal to libdav1d's,
intra and inter frames alike.
The return contract stays: the same planes, chroma factors, alpha and
``bt709`` flag, and None where the reference's path returns None.

What differs, because the port has no host library behind it:

- a layered stream whose first picture is not the
  container's size returns None, as the reference's ``_decode_obu`` does
  once its ABI guard has passed (the guard, which turns the reference's
  native path off for good where the first picture it validates has
  another size, is libdav1d's state and has no counterpart here);
- a file that the reference's native path declines (premultiplied or
  several alpha items, no ``nclx`` colour box, a matrix other than
  BT.601 / BT.709, a grid) returns None here as there; where the
  reference then hands it to Pillow's libavif, the port's
  ``decode_bytes`` hands it to :mod:`.avif_libavif`, which decodes it as
  libavif 1.3.0 does, and so does a stream that does not decode, which
  answers libavif's words (a 400).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from imagekit_tpu_torch.errors import NotPortedError

_I400, _I420, _I422, _I444 = 0, 1, 2, 3
#: the ROADMAP item a tool the decoder would not build names (inter
#: prediction's; none is left)
INTER_ITEM = "queue 1 item 12"


# ---------------------------------------------------------------------------
# ISOBMFF container
# ---------------------------------------------------------------------------


@dataclass
class AvifInfo:
    width: int
    height: int
    obu: bytes                    # primary (colour) item's AV1 payload
    has_alpha: bool = False
    alpha_obu: bytes = b""        # alpha aux item's AV1 payload (when
    #                               extractable and 8-bit, non-premul)
    alpha_size: Tuple[int, int] = (0, 0)  # alpha item's own ispe
    #                               ((0,0) = assume primary dims)
    matrix: int = 2               # nclx matrix_coefficients (2 = unspecified)
    full_range: bool = True
    has_nclx: bool = False        # colr/nclx present (else colour config is
    #                               in the AV1 sequence header we don't read)
    # av1C bits (container-declared, known BEFORE any decode)
    high_bitdepth: bool = False
    monochrome: bool = False
    chroma_sub_x: bool = True
    chroma_sub_y: bool = True
    properties: Dict[int, list] = field(default_factory=dict)
    # CleanAperture crop (x0, y0, w, h) in luma pixels, already validated
    # against the coded dims; None when absent or unusable (non-integer
    # or out-of-bounds apertures are ignored, matching the pre-clap
    # behaviour of decoding the full coded picture)
    crop: Optional[Tuple[int, int, int, int]] = None
    # the primary item's extents run past the end of the file (the port's
    # field: libavif's "Truncated data", :func:`undecodable_message`)
    truncated: bool = False


_MAX_BOXES = 4096  # a legal still AVIF has dozens; bound hostile walks


def _boxes(buf: bytes, start: int, end: int):
    i = start
    n = 0
    while i + 8 <= end:
        n += 1
        if n > _MAX_BOXES:
            raise ValueError("implausible box count")
        sz = int.from_bytes(buf[i:i + 4], "big")
        typ = buf[i + 4:i + 8]
        hdr = 8
        if sz == 1:
            if i + 16 > end:
                raise ValueError("truncated largesize box")
            sz = int.from_bytes(buf[i + 8:i + 16], "big")
            hdr = 16
        elif sz == 0:
            sz = end - i
        if sz < hdr or i + sz > end:
            raise ValueError("bad box size")
        yield typ, i + hdr, i + sz
        i += sz


def parse_container(data: bytes) -> AvifInfo:
    """Walk the AVIF/HEIF structure and pull out the primary item's AV1
    payload plus the properties that matter for colour reconstruction.
    Raises ValueError on anything unexpected (callers fall back)."""
    try:
        return _parse_container(data)
    except ValueError:
        raise
    except (IndexError, struct.error, OverflowError, MemoryError) as e:
        raise ValueError(f"malformed avif container: {e}") from e


def _parse_container(data: bytes) -> AvifInfo:
    if len(data) < 16 or data[4:8] != b"ftyp":
        raise ValueError("not an ISOBMFF file")
    top = {}
    for t, a, b in _boxes(data, 0, len(data)):
        top.setdefault(t, (a, b))
    if b"meta" not in top:
        raise ValueError("no meta box")
    ma, mb = top[b"meta"]
    ma += 4  # fullbox version/flags
    meta = {}
    for t, a, b in _boxes(data, ma, mb):
        meta.setdefault(t, (a, b))
    for req in (b"pitm", b"iinf", b"iloc"):
        if req not in meta:
            raise ValueError(f"missing {req.decode()}")

    pa, _pb = meta[b"pitm"]
    pitm = (
        int.from_bytes(data[pa + 4:pa + 6], "big")
        if data[pa] == 0
        else int.from_bytes(data[pa + 4:pa + 8], "big")
    )

    ia, ib = meta[b"iinf"]
    off = ia + 4
    if data[ia] == 0:
        off += 2
    else:
        off += 4
    item_types: Dict[int, bytes] = {}
    for t, a, b in _boxes(data, off, ib):
        if t != b"infe":
            continue
        v = data[a]
        if v < 2:
            continue
        iid = (
            int.from_bytes(data[a + 4:a + 6], "big")
            if v == 2
            else int.from_bytes(data[a + 4:a + 8], "big")
        )
        o = (a + 6 if v == 2 else a + 8) + 2  # + protection index
        item_types[iid] = data[o:o + 4]
    if item_types.get(pitm) != b"av01":
        raise ValueError("primary item is not av01")

    la, lb = meta[b"iloc"]
    v = data[la]
    off = la + 4
    offset_size = data[off] >> 4
    length_size = data[off] & 15
    base_offset_size = data[off + 1] >> 4
    index_size = (data[off + 1] & 15) if v in (1, 2) else 0
    off += 2
    if v < 2:
        item_count = int.from_bytes(data[off:off + 2], "big")
        off += 2
    else:
        item_count = int.from_bytes(data[off:off + 4], "big")
        off += 4
    if item_count > 4096:
        raise ValueError("implausible iloc item count")
    locs: Dict[int, Tuple[int, List[Tuple[int, int]]]] = {}
    for _ in range(item_count):
        if v < 2:
            iid = int.from_bytes(data[off:off + 2], "big")
            off += 2
        else:
            iid = int.from_bytes(data[off:off + 4], "big")
            off += 4
        cm = 0
        if v in (1, 2):
            cm = int.from_bytes(data[off:off + 2], "big") & 15
            off += 2
        off += 2  # data reference index
        base = int.from_bytes(data[off:off + base_offset_size], "big")
        off += base_offset_size
        ec = int.from_bytes(data[off:off + 2], "big")
        off += 2
        if ec > 1024:
            raise ValueError("implausible extent count")
        extents = []
        for _ in range(ec):
            off += index_size
            eo = int.from_bytes(data[off:off + offset_size], "big")
            off += offset_size
            el = int.from_bytes(data[off:off + length_size], "big")
            off += length_size
            extents.append((base + eo, el))
        locs[iid] = (cm, extents)

    # properties: ipco (ordered list) + ipma (item -> 1-based indices)
    width = height = 0
    matrix, full_range = 2, True
    has_nclx = False
    has_alpha = False
    high_bd = mono = False
    sub_x = sub_y = True
    alpha_ids: List[int] = []
    alpha_size = (0, 0)
    clap_raw = None
    if b"iprp" in meta:
        pa2, pb2 = meta[b"iprp"]
        sub = {}
        for t, a, b in _boxes(data, pa2, pb2):
            sub.setdefault(t, (a, b))
        props: List[Tuple[bytes, int, int]] = []
        if b"ipco" in sub:
            ca, cb = sub[b"ipco"]
            props = list(_boxes(data, ca, cb))
        assoc: Dict[int, List[int]] = {}
        if b"ipma" in sub:
            aa, ab = sub[b"ipma"]
            v2 = data[aa]
            flags = int.from_bytes(data[aa + 1:aa + 4], "big")
            o = aa + 4
            ec2 = int.from_bytes(data[o:o + 4], "big")
            o += 4
            if ec2 > 4096:
                raise ValueError("implausible ipma entry count")
            for _ in range(ec2):
                if v2 < 1:
                    iid = int.from_bytes(data[o:o + 2], "big")
                    o += 2
                else:
                    iid = int.from_bytes(data[o:o + 4], "big")
                    o += 4
                ac = data[o]
                o += 1
                idxs = []
                for _ in range(ac):
                    if flags & 1:
                        pi = int.from_bytes(data[o:o + 2], "big") & 0x7FFF
                        o += 2
                    else:
                        pi = data[o] & 0x7F
                        o += 1
                    idxs.append(pi)
                assoc[iid] = idxs
        # alpha: any av01 item whose auxC names the alpha aux type
        for iid, typ in item_types.items():
            if iid == pitm or typ != b"av01":
                continue
            is_alpha = False
            for pi in assoc.get(iid, []):
                if 1 <= pi <= len(props):
                    t, a, b = props[pi - 1]
                    if t == b"auxC" and b"alpha" in data[a:b]:
                        is_alpha = True
            if is_alpha:
                has_alpha = True
                alpha_ids.append(iid)
                for pi in assoc.get(iid, []):
                    if 1 <= pi <= len(props):
                        t, a, b = props[pi - 1]
                        if t == b"ispe":
                            alpha_size = (
                                int.from_bytes(data[a + 4:a + 8], "big"),
                                int.from_bytes(data[a + 8:a + 12], "big"),
                            )
        for pi in assoc.get(pitm, range(1, len(props) + 1)):
            if not (1 <= pi <= len(props)):
                continue
            t, a, b = props[pi - 1]
            if t == b"ispe":
                width = int.from_bytes(data[a + 4:a + 8], "big")
                height = int.from_bytes(data[a + 8:a + 12], "big")
            elif t == b"colr" and data[a:a + 4] == b"nclx":
                matrix = int.from_bytes(data[a + 8:a + 10], "big")
                full_range = bool(data[a + 10] & 0x80)
                has_nclx = True
            elif t == b"av1C" and b - a >= 3:
                cfg = data[a + 2]
                high_bd = bool(cfg & 0x40)
                mono = bool(cfg & 0x10)
                sub_x = bool(cfg & 0x08)
                sub_y = bool(cfg & 0x04)
            elif t == b"clap" and b - a >= 32:
                clap_raw = tuple(
                    int.from_bytes(data[a + 4 * i:a + 4 * i + 4], "big",
                                   signed=True) for i in range(8))
    if width <= 0 or height <= 0:
        raise ValueError("missing ispe dimensions")
    crop = _clap_to_crop(clap_raw, width, height) if clap_raw else None

    cm, extents = locs.get(pitm, (None, []))
    if cm != 0 or not extents:
        raise ValueError("unsupported iloc construction")
    obu = b"".join(data[o:o + l] for o, l in extents)
    if not obu:
        raise ValueError("empty av01 payload")
    truncated = len(obu) < sum(l for _, l in extents)
    # alpha payload, when it can take the native path: exactly one
    # 8-bit alpha aux item and NO premultiply reference (a `prem` iref
    # needs un-multiplication the host library handles)
    alpha_obu = b""
    if len(alpha_ids) == 1 and b"iref" not in meta:
        acm, aextents = locs.get(alpha_ids[0], (None, []))
        if acm == 0 and aextents:
            alpha_obu = b"".join(data[o:o + l] for o, l in aextents)
    elif alpha_ids and b"iref" in meta:
        ra, rb = meta[b"iref"]
        if b"prem" not in data[ra:rb] and len(alpha_ids) == 1:
            acm, aextents = locs.get(alpha_ids[0], (None, []))
            if acm == 0 and aextents:
                alpha_obu = b"".join(data[o:o + l] for o, l in aextents)
    return AvifInfo(
        width, height, obu, has_alpha, alpha_obu, alpha_size, matrix,
        full_range, has_nclx, high_bd, mono, sub_x, sub_y, crop=crop,
        truncated=truncated,
    )


def _clap_to_crop(raw, width: int, height: int):
    """CleanApertureBox fractions -> integer (x0, y0, w, h), or None.

    ISO 14496-12 12.1.4: the aperture is cw x ch centred at
    ((width-1)/2 + hoff, (height-1)/2 + voff); equivalently
    x0 = (width - cw)/2 + hoff.  Apertures that aren't integral,
    positive, and fully inside the coded picture are ignored (the file
    still decodes at coded size, the pre-clap behaviour)."""
    from fractions import Fraction

    cwn, cwd, chn, chd, hon, hod, von, vod = raw
    if cwd == 0 or chd == 0 or hod == 0 or vod == 0:
        return None
    try:
        cw = Fraction(cwn, cwd)
        ch = Fraction(chn, chd)
        x0 = Fraction(width - cw, 2) + Fraction(hon, hod)
        y0 = Fraction(height - ch, 2) + Fraction(von, vod)
    except (ZeroDivisionError, OverflowError):
        return None
    if cw.denominator != 1 or ch.denominator != 1 \
            or x0.denominator != 1 or y0.denominator != 1:
        return None
    cw, ch, x0, y0 = int(cw), int(ch), int(x0), int(y0)
    if cw <= 0 or ch <= 0 or x0 < 0 or y0 < 0 \
            or x0 + cw > width or y0 + ch > height:
        return None
    if (cw, ch, x0, y0) == (width, height, 0, 0):
        return None  # no-op aperture
    return (x0, y0, cw, ch)


def header_dimensions(data: bytes):
    """Dims-only container probe for fetch-layer validation: walks
    ftyp/meta/iprp for the ispe property WITHOUT touching iloc or
    assembling the AV1 payload — microsecond-class and bounded, safe to
    run on the event loop (the full parse_container runs later, in the
    engine's codec pool). Returns (w, h) or None."""
    try:
        if len(data) < 16 or data[4:8] != b"ftyp":
            return None
        meta = None
        for t, a, b in _boxes(data, 0, len(data)):
            if t == b"meta":
                meta = (a + 4, b)
                break
        if meta is None:
            return None
        iprp = None
        saw_av01 = False
        for t, a, b in _boxes(data, meta[0], meta[1]):
            if t == b"iprp":
                iprp = (a, b)
            elif t == b"iinf":
                off = a + 4 + (2 if data[a] == 0 else 4)
                for t2, a2, b2 in _boxes(data, off, b):
                    if t2 == b"infe" and data[a2] >= 2:
                        o = (a2 + 6 if data[a2] == 2 else a2 + 8) + 2
                        if data[o:o + 4] == b"av01":
                            saw_av01 = True
        if iprp is None or not saw_av01:
            return None
        for t, a, b in _boxes(data, iprp[0], iprp[1]):
            if t == b"ipco":
                for t2, a2, b2 in _boxes(data, a, b):
                    if t2 == b"ispe" and b2 - a2 >= 12:
                        w = int.from_bytes(data[a2 + 4:a2 + 8], "big")
                        h = int.from_bytes(data[a2 + 8:a2 + 12], "big")
                        return (w, h) if w > 0 and h > 0 else None
        return None
    except (ValueError, IndexError, struct.error):
        return None


# ---------------------------------------------------------------------------
# AV1 decode
# ---------------------------------------------------------------------------


def _decode_obu(obu: bytes, want_w: int, want_h: int):
    """One still frame through the port's AV1 decoder -> (y, u|None,
    v|None, layout, 8), or None where the stream does not decode or its
    picture's size is not the container's (the reference rejects such a
    file too). A 10- or 12-bit stream's planes come rounded to 8 bits as
    the reference rounds libdav1d's (``av1_dec_abi.to_8bit``). An inter
    frame decodes with the frames it depends on; NotPortedError would name a
    tool the decoder does not build."""
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    try:
        y, u, v, info = av1_dec_abi.decode(obu, expect=(want_w, want_h))
    except av1_dec_abi.Av1NotPorted as e:
        raise NotPortedError(f"AVIF sources with {e}", INTER_ITEM) from None
    except ValueError:
        return None
    return y, u, v, info.layout, 8


def undecodable_message(data: bytes) -> str:
    """What the reference's Pillow fallback says of an AVIF it cannot read
    either (libavif's words, as Pillow 12 reports them): a container that
    does not parse is not identified; a stream that does not decode fails
    its colour planes."""
    truncated = "Failed to decode frame 0: Truncated data"
    try:
        info = parse_container(data)
    except ValueError:
        return truncated if _mdat_cut(data) else "cannot identify image file"
    if info.truncated:
        return truncated
    return "Failed to decode frame 0: Decoding of color planes failed"


def _mdat_cut(data: bytes) -> bool:
    """The file's top-level boxes are whole but for an ``mdat`` that runs
    past its end (a file cut short in its payload, which libavif reads as
    far as it goes)."""
    i = 0
    while i + 8 <= len(data):
        size = int.from_bytes(data[i:i + 4], "big")
        if size == 1 and i + 16 <= len(data):
            size = int.from_bytes(data[i + 8:i + 16], "big")
        if size < 8:
            return False
        if i + size > len(data):
            return data[i + 4:i + 8] == b"mdat"
        i += size
    return False


_BT709 = (0.2126, 0.7152, 0.0722)
_BT601 = (0.299, 0.587, 0.114)


def _bomb_guard(info: AvifInfo) -> None:
    """Decompression-bomb ceiling: twice Pillow's default
    ``MAX_IMAGE_PIXELS`` (89,478,485), the reference's own limit, kept
    here as a constant since the port does not load Pillow."""
    limit = 89_478_485
    if info.width * info.height > 2 * limit:
        raise ValueError(
            f"image is too large ({info.width}x{info.height} pixels)"
        )


def decode_rgb(data: bytes) -> Optional[np.ndarray]:
    """Container parse + the AV1 decoder -> RGB(A) u8, the alpha item's
    OBU through the same decoder (8-bit, not premultiplied). Returns None
    whenever the reference's native path returns None: a file the
    decoder cannot read, or one the reference hands to Pillow (its caller
    takes both to :func:`.avif_libavif.decode_pillow_rgb`). Raises
    ValueError only for the decompression-bomb ceiling, NotPortedError
    for a tool the decoder does not build."""
    try:
        info = parse_container(data)
    except ValueError:
        return None
    if info.has_alpha and not info.alpha_obu:
        return None  # premultiplied / multi-aux / unextractable
    # colour interpretation must be explicit: without nclx it lives in the
    # AV1 sequence header, and matrix 0 is identity/GBR — the reference
    # leaves both to its host library
    if not info.has_nclx or info.matrix not in (1, 2, 5, 6):
        return None
    _bomb_guard(info)
    out = _decode_obu(info.obu, info.width, info.height)
    if out is None:
        return None
    y, u, v, layout, _bpc = out
    h, w = info.height, info.width
    yf = y.astype(np.float32)
    if not info.full_range:
        yf = (yf - 16.0) * (255.0 / 219.0)
    if layout == _I400 or u is None:
        g8 = np.clip(np.floor(yf + 0.5), 0, 255).astype(np.uint8)
        return _crop_rgb(
            _maybe_alpha(np.repeat(g8[:, :, None], 3, axis=2), info), info)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    if not info.full_range:
        uf *= 255.0 / 224.0
        vf *= 255.0 / 224.0
    # nearest-neighbour chroma upsample (documented tolerance)
    if layout == _I420:
        uf = np.repeat(np.repeat(uf, 2, 0), 2, 1)[:h, :w]
        vf = np.repeat(np.repeat(vf, 2, 0), 2, 1)[:h, :w]
    elif layout == _I422:
        uf = np.repeat(uf, 2, 1)[:, :w]
        vf = np.repeat(vf, 2, 1)[:, :w]
    kr, kg, kb = _BT709 if info.matrix == 1 else _BT601
    r = yf + 2.0 * (1.0 - kr) * vf
    b = yf + 2.0 * (1.0 - kb) * uf
    g = (yf - kr * r - kb * b) / kg
    rgb = np.stack([r, g, b], axis=-1)
    rgb8 = np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)
    return _crop_rgb(_maybe_alpha(rgb8, info), info)


def _crop_rgb(arr, info: AvifInfo):
    """Apply the container's validated clean-aperture crop (no-op
    without one; pixel-domain slice, so any aperture alignment works)."""
    if arr is None or info.crop is None:
        return arr
    x0, y0, cw, ch = info.crop
    return arr[y0:y0 + ch, x0:x0 + cw]


class _Bits:
    """MSB-first bit reader for the AV1 sequence-header parse below."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit position

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3]  # IndexError -> caller's None
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        zeros = 0
        while self.f(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("uvlc overrun")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.f(zeros)


def _seq_header_color_range(obu_stream: bytes) -> Optional[tuple]:
    """Walk the OBU stream for the sequence header and parse it (AV1 spec
    §5.5) just far enough to reach color_config's color_range bit.
    Returns (mono_chrome, full_range) or None when the stream can't be
    parsed — callers treat None as "unprovable" and fall back,
    consistent with the nclx/identity-matrix gating above (ADVICE r3);
    each caller applies its own mono requirement (the grey gate needs a
    mono stream; the alpha gate also accepts 4:2:0 neutral-chroma alpha,
    the rav1e-family and first-party layout)."""
    try:
        i = 0
        payload = None
        for _ in range(64):  # bound hostile OBU walks
            if i >= len(obu_stream):
                break
            hdr = obu_stream[i]
            if hdr & 0x80:  # forbidden bit
                return None
            obu_type = (hdr >> 3) & 0xF
            ext = bool(hdr & 0x04)
            has_size = bool(hdr & 0x02)
            i += 1 + (1 if ext else 0)
            if has_size:
                size, shift = 0, 0
                for _ in range(8):  # leb128
                    b = obu_stream[i]
                    i += 1
                    size |= (b & 0x7F) << shift
                    shift += 7
                    if not (b & 0x80):
                        break
                else:
                    return None
                body = obu_stream[i:i + size]
                i += size
            else:
                body = obu_stream[i:]
                i = len(obu_stream)
            if obu_type == 1:  # OBU_SEQUENCE_HEADER
                payload = body
                break
        if payload is None:
            return None

        r = _Bits(payload)
        seq_profile = r.f(3)
        r.f(1)  # still_picture
        reduced = r.f(1)
        if reduced:
            r.f(5)  # seq_level_idx[0]
            decoder_model_info = False
        else:
            if r.f(1):  # timing_info_present_flag
                r.f(32)  # num_units_in_display_tick
                r.f(32)  # time_scale
                if r.f(1):  # equal_picture_interval
                    r.uvlc()  # num_ticks_per_picture_minus_1
                decoder_model_info = bool(r.f(1))
                if decoder_model_info:
                    buffer_delay_bits = r.f(5) + 1
                    r.f(32)  # num_units_in_decoding_tick
                    r.f(5)   # buffer_removal_time_length_minus_1
                    r.f(5)   # frame_presentation_time_length_minus_1
            else:
                decoder_model_info = False
            initial_display_delay = bool(r.f(1))
            op_cnt = r.f(5) + 1
            for _ in range(op_cnt):
                r.f(12)  # operating_point_idc
                lvl = r.f(5)
                if lvl > 7:
                    r.f(1)  # seq_tier
                if decoder_model_info and r.f(1):
                    r.f(buffer_delay_bits)  # decoder_buffer_delay
                    r.f(buffer_delay_bits)  # encoder_buffer_delay
                    r.f(1)                  # low_delay_mode_flag
                if initial_display_delay and r.f(1):
                    r.f(4)  # initial_display_delay_minus_1
        wbits = r.f(4) + 1
        hbits = r.f(4) + 1
        r.f(wbits)  # max_frame_width_minus_1
        r.f(hbits)  # max_frame_height_minus_1
        if not reduced and r.f(1):  # frame_id_numbers_present_flag
            r.f(4)  # delta_frame_id_length_minus_2
            r.f(3)  # additional_frame_id_length_minus_1
        r.f(3)  # use_128x128_superblock, enable_filter_intra,
        #         enable_intra_edge_filter
        if not reduced:
            r.f(4)  # interintra/masked compound, warped motion, dual filter
            order_hint = bool(r.f(1))
            if order_hint:
                r.f(2)  # enable_jnt_comp, enable_ref_frame_mvs
            force_sct = 2 if r.f(1) else r.f(1)  # seq_choose/force sct
            if force_sct > 0:
                if not r.f(1):  # seq_choose_integer_mv
                    r.f(1)      # seq_force_integer_mv
            if order_hint:
                r.f(3)  # order_hint_bits_minus_1
        r.f(3)  # enable_superres, enable_cdef, enable_restoration
        # color_config()
        high_bd = r.f(1)
        if seq_profile == 2 and high_bd:
            r.f(1)  # twelve_bit
        mono = r.f(1) if seq_profile != 1 else 0
        if r.f(1):  # color_description_present_flag
            primaries = r.f(8)
            transfer = r.f(8)
            matrix = r.f(8)
            # spec 5.5.2: the sRGB identity triple (1, 13, 0) on a
            # non-mono stream OMITS color_range — it is implied FULL
            if not mono and (primaries, transfer, matrix) == (1, 13, 0):
                return False, True
        return bool(mono), bool(r.f(1))  # color_range follows otherwise
    except (IndexError, ValueError):
        return None


def _alpha_plane(info: AvifInfo) -> Optional[np.ndarray]:
    """Decode the alpha aux item's plane (same AV1 decoder) to a
    FULL-RANGE u8 (h, w) array; None when the native path cannot serve
    it (decode failure / unprovable sample range)."""
    aw, ah = info.alpha_size
    if (aw, ah) == (0, 0):
        aw, ah = info.width, info.height
    out = _decode_obu(info.alpha_obu, aw, ah)
    if out is None:
        return None
    ay, _au, _av, _layout, bpc = out
    if bpc != 8:
        return None
    # The alpha OBU's own sequence header signals its sample range
    # (libavif writes full range, but a legal limited-range alpha OBU
    # from another encoder would arrive squeezed into 16..235). Scale
    # limited-range planes; decline the file when the header can't be
    # parsed — never guess pixel values.
    parsed = _seq_header_color_range(info.alpha_obu)
    if parsed is None:
        return None
    _mono, rng = parsed  # mono AND 4:2:0 neutral-chroma alpha both legal
    if not rng:  # limited -> full, same remap as the luma path above
        ay = np.clip(
            np.floor((ay.astype(np.float32) - 16.0) * (255.0 / 219.0) + 0.5),
            0, 255,
        ).astype(np.uint8)
    return ay


def _maybe_alpha(rgb8: np.ndarray, info: AvifInfo) -> Optional[np.ndarray]:
    """Attach the alpha aux item's plane (decoded through the same AV1
    decoder) when present; None declines the whole file rather than
    emitting RGB for an image that has alpha."""
    if not info.has_alpha:
        return rgb8
    ay = _alpha_plane(info)
    if ay is None or ay.shape != rgb8.shape[:2]:
        return None
    return np.dstack([rgb8, ay])


def _to_studio(y, u, v, full_range: bool):
    """Full-range 601 -> studio range (the affine remap commutes with
    the linear resize, same argument as the JPEG->WebP path); studio
    sources pass through untouched."""
    if not full_range:
        return y, u, v
    y = np.clip(
        np.floor(y.astype(np.float32) * (219.0 / 255.0) + 16.0 + 0.5),
        0, 255,
    ).astype(np.uint8)
    c_off = 128.0 * (1.0 - 224.0 / 255.0)
    u = np.clip(
        np.floor(u.astype(np.float32) * (224.0 / 255.0) + c_off + 0.5),
        0, 255,
    ).astype(np.uint8)
    v = np.clip(
        np.floor(v.astype(np.float32) * (224.0 / 255.0) + c_off + 0.5),
        0, 255,
    ).astype(np.uint8)
    return y, u, v


class YuvDirect(NamedTuple):
    """A natively-decoded AVIF bound for the YUV-domain batched path."""

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    csy: int
    csx: int
    alpha: Optional[np.ndarray] = None  # full-range u8, luma geometry
    bt709: bool = False  # planes are BT.709 YUV (head applies the mix)


def decode_yuv_studio(
    data: bytes, want_alpha: bool = True
) -> Optional[YuvDirect]:
    """Container parse + the AV1 decoder -> studio-range YUV planes PLUS
    the source chroma-subsample factors for the serving engine's
    YUV-domain batched resize: 4:2:0 ((2,2)), 4:2:2 ((1,2)) and 4:4:4
    ((1,1)), the head folding the source chroma geometry into its resize
    weights. Monochrome (YUV400) sources pair their Y plane with
    synthesized studio-neutral 4:2:0 chroma (a flat 128 plane is a fixed
    point of the combined upsample∘resize weights, whose rows sum to 1,
    and of every YCbCr matrix). Alpha-bearing sources return the aux
    plane (full-range, luma geometry) for the head's fourth plane, and
    BT.709-tagged sources return ``bt709=True`` for the head's 709->601
    mix. Returns None when this file can't take the direct path (as the
    reference's, whose caller then decodes pixels); raises
    NotPortedError for a tool the decoder does not build."""
    try:
        info = parse_container(data)
    except ValueError:
        return None
    if info.has_alpha and not info.alpha_obu:
        return None  # premultiplied / multi-aux / unextractable
    if info.monochrome:
        # Grey gates: chroma is synthesized neutral so the matrix is
        # irrelevant; the sample range comes from nclx when present,
        # else from the stream's own sequence header (the same bounded
        # AV1 §5.5 parse the alpha plane uses — it answers for mono
        # streams only). Unprovable range -> host fallback.
        if info.has_nclx:
            full_range = info.full_range
        else:
            parsed = _seq_header_color_range(info.obu)
            if parsed is None or not parsed[0]:
                return None  # non-mono OBU: the grey gate can't prove it
            full_range = parsed[1]
        bt709 = False
    elif not info.has_nclx or info.matrix not in (1, 2, 5, 6):
        return None
    else:
        full_range = info.full_range
        bt709 = info.matrix == 1
    _bomb_guard(info)
    out = _decode_obu(info.obu, info.width, info.height)
    if out is None:
        return None
    y, u, v, layout, _bpc = out
    alpha = None
    if info.has_alpha and want_alpha:
        # ``want_alpha=False`` skips the aux-plane decode entirely:
        # webp/jpeg outputs drop alpha anyway (reference parity — lossy
        # webp encode is from_rgb), so decoding it would double the
        # decode work on the alpha-AVIF -> webp hot path for nothing
        # (round-5 review finding)
        alpha = _alpha_plane(info)
        if alpha is None or alpha.shape != y.shape:
            return None
    if info.crop is not None:
        # clean-aperture crop in the YUV domain: only chroma-grid-aligned
        # apertures keep the direct path (misaligned ones would need a
        # half-sample chroma shift -> host fallback)
        x0, y0, cw, ch = info.crop
        sx = 2 if layout in (_I420, _I422) else 1
        sy = 2 if layout == _I420 else 1
        if u is not None and (x0 % sx or y0 % sy):
            return None
        y = y[y0:y0 + ch, x0:x0 + cw]
        if alpha is not None:
            alpha = alpha[y0:y0 + ch, x0:x0 + cw]
        if u is not None:
            u = u[y0 // sy:(y0 + ch + sy - 1) // sy,
                  x0 // sx:(x0 + cw + sx - 1) // sx]
            v = v[y0 // sy:(y0 + ch + sy - 1) // sy,
                  x0 // sx:(x0 + cw + sx - 1) // sx]
    if u is None or layout == _I400:
        # Only when the container DECLARED mono; a container/stream
        # disagreement (either direction) is malformed -> host fallback.
        if not info.monochrome:
            return None
        h, w = y.shape
        u = np.full(((h + 1) // 2, (w + 1) // 2), 128, np.uint8)
        v = u.copy()
        y, u, v = _to_studio(y, u, v, full_range)
        return YuvDirect(y, u, v, 2, 2, alpha=alpha)
    if info.monochrome:
        return None
    if layout == _I420:
        csy, csx = 2, 2
    elif layout == _I422:
        csy, csx = 1, 2  # full height, half width
    elif layout == _I444:
        csy, csx = 1, 1
    else:
        return None
    y, u, v = _to_studio(y, u, v, full_range)
    return YuvDirect(y, u, v, csy, csx, alpha=alpha, bt709=bt709)


def decode_yuv420_studio(data: bytes):
    """4:2:0-only wrapper over :func:`decode_yuv_studio` (kept for the
    pre-round-4 contract: BT.601 opaque planes only, None otherwise)."""
    out = decode_yuv_studio(data)
    if (
        out is None
        or (out.csy, out.csx) != (2, 2)
        or out.alpha is not None
        or out.bt709
    ):
        return None
    return out.y, out.u, out.v
