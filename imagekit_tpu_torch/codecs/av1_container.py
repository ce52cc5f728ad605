"""First-party AVIF (HEIF/MIAF) container writer.

Wraps an AV1 OBU stream from the in-process encoder (av1_image.py) into
a standalone .avif file: ftyp / meta(hdlr, pitm, iloc, iinf, iprp) /
mdat, with ispe + pixi + av1C + colr(nclx) properties and — when the
display size differs from the coded size — a CleanAperture crop, which
is how the encoder serves arbitrary dimensions from its certified
multiple-of-64 coding geometry (pad + clap; see av1_image.py).  An
optional second AV1 stream rides as an alpha auxiliary item (infe av01
+ auxC urn:...:alpha + iref auxl -> colour item), the same two-item
layout libavif/rav1e write.

The reference gets this layer from the `image` crate's AvifSerializer
(reference src/transform.rs:138-146); box layout here follows ISO
14496-12 + the AVIF spec §4, and is validated in tests against BOTH our
own parser (avif_native.parse_container) and the system libavif/PIL
decoder when present.

The port's copy of ``imagekit_tpu/codecs/av1_container.py``, unchanged.
"""

from __future__ import annotations

import struct

_ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, version: int = 0,
          flags: int = 0) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def _av1c(seq_obu: bytes, seq_profile: int = 0, seq_level: int = 0,
          high_bd: bool = False, mono: bool = False,
          ssx: int = 1, ssy: int = 1, csp: int = 0) -> bytes:
    cfg = bytes((
        0x81,                                   # marker=1, version=1
        (seq_profile << 5) | seq_level,
        (0 << 7) | (int(high_bd) << 6) | (0 << 5) | (int(mono) << 4)
        | (ssx << 3) | (ssy << 2) | csp,
        0,                                      # no presentation delay
    ))
    return _box(b"av1C", cfg + seq_obu)


def _clap(coded_w: int, coded_h: int, w: int, h: int) -> bytes:
    """Top-left-anchored aperture: offset = (aperture - coded) / 2."""
    vals = (w, 1, h, 1, w - coded_w, 2, h - coded_h, 2)
    return _box(b"clap", struct.pack(">8i", *vals))


def _infe(item_id: int, name: bytes = b"\0") -> bytes:
    return _full(b"infe", struct.pack(">HH", item_id, 0) + b"av01" + name,
                 version=2)


def write_avif(obu_stream: bytes, coded_w: int, coded_h: int,
               display_w: int | None = None, display_h: int | None = None,
               seq_obu: bytes = b"", mono: bool = False,
               cicp: tuple = (1, 13, 6), full_range: bool = False,
               alpha_obu_stream: bytes | None = None,
               alpha_seq_obu: bytes = b"") -> bytes:
    """Assemble a complete still AVIF around one av01 item (+ optional
    alpha auxiliary item).

    `obu_stream` is the full colour stream (sequence header + frame
    OBUs); `seq_obu` optionally carries just the sequence-header OBU for
    the av1C configOBUs field (decoders accept it empty).  When display
    dims are given and smaller than the coded dims, a clap property
    crops the top-left aperture.  `alpha_obu_stream`, when given, is a
    second full AV1 stream at the same coded geometry whose luma plane
    is the (full-range) alpha channel.
    """
    display_w = coded_w if display_w is None else display_w
    display_h = coded_h if display_h is None else display_h
    if not (0 < display_w <= coded_w and 0 < display_h <= coded_h):
        raise ValueError("display dims must fit inside coded dims")

    ftyp = _box(b"ftyp", b"avif" + struct.pack(">I", 0)
                + b"avif" + b"mif1" + b"miaf")

    items = [(1, obu_stream)]
    if alpha_obu_stream is not None:
        items.append((2, alpha_obu_stream))

    hdlr = _full(b"hdlr", struct.pack(">I", 0) + b"pict"
                 + b"\0" * 12 + b"\0")
    pitm = _full(b"pitm", struct.pack(">H", 1))

    # iloc v0: 4-byte offsets/lengths, one extent per item; built twice
    # — the absolute file offsets need meta's size, which doesn't depend
    # on the offsets' VALUES (fixed-width fields)
    def iloc(base: int) -> bytes:
        body = struct.pack(">BBH", 0x44, 0x00, len(items))
        off = base
        for iid, payload in items:
            body += struct.pack(">HHH", iid, 0, 1)
            body += struct.pack(">II", off, len(payload))
            off += len(payload)
        return _full(b"iloc", body)

    iinf = _full(b"iinf", struct.pack(">H", len(items))
                 + _infe(1)
                 + (_infe(2, b"Alpha\0") if len(items) > 1 else b""))

    # single-ItemReferenceBox: alpha item references the colour item
    iref = b""
    if len(items) > 1:
        iref = _full(b"iref", _box(
            b"auxl", struct.pack(">HHH", 2, 1, 1)))

    props = [
        ("ispe", False,
         _full(b"ispe", struct.pack(">II", coded_w, coded_h))),
        ("pixi", False,
         _full(b"pixi", bytes((1 if mono else 3,))
               + bytes((8,) * (1 if mono else 3)))),
        ("av1C", True, _av1c(seq_obu, mono=mono)),
        ("colr", False,
         _box(b"colr", b"nclx" + struct.pack(">HHH", *cicp)
              + bytes((0x80 if full_range else 0x00,)))),
    ]
    if (display_w, display_h) != (coded_w, coded_h):
        props.append(("clap", True,
                      _clap(coded_w, coded_h, display_w, display_h)))
    n_colour = len(props)
    if len(items) > 1:
        # alpha item properties: its own av1C, a 1-channel pixi, auxC;
        # ispe (and clap, identical aperture) are shared by index
        props.append(("av1C", True, _av1c(alpha_seq_obu)))
        props.append(("pixi", False, _full(b"pixi", bytes((1, 8)))))
        props.append(("auxC", False, _full(b"auxC", _ALPHA_URN)))
    ipco = _box(b"ipco", b"".join(p[2] for p in props))

    def assoc(indices) -> bytes:
        return bytes((0x80 if props[i][1] else 0) | (i + 1)
                     for i in indices)

    entries = struct.pack(">H", 1) + bytes((n_colour,)) \
        + assoc(range(n_colour))
    n_entries = 1
    if len(items) > 1:
        alpha_idx = [0] + list(range(n_colour, len(props)))  # share ispe
        if props[n_colour - 1][0] == "clap":
            alpha_idx.insert(1, n_colour - 1)                # share clap
        entries += struct.pack(">H", 2) + bytes((len(alpha_idx),)) \
            + assoc(alpha_idx)
        n_entries = 2
    ipma = _full(b"ipma", struct.pack(">I", n_entries) + entries)
    iprp = _box(b"iprp", ipco + ipma)

    meta = _full(b"meta", hdlr + pitm + iloc(0) + iinf + iref + iprp)
    mdat_off = len(ftyp) + len(meta) + 8   # payload starts after mdat hdr
    meta = _full(b"meta", hdlr + pitm + iloc(mdat_off) + iinf + iref + iprp)
    mdat = _box(b"mdat", b"".join(p for _, p in items))
    return ftyp + meta + mdat
