"""ctypes binding of the port's AV1 decoder (``av1_decode.cpp``): intra
and inter frames.

The decoder takes its default tables once, packed here into the one
struct it declares (``Tables`` in ``av1_decode.cpp``): the CDFs of
``av1_tables.npz`` (the encoder's, extracted by
``tools/extract_av1_tables.py``) and of ``av1_dec_tables.npz`` (written by
``tests/fixtures/make_av1_dec_tables.py``), one copy per coefficient q
context, then the quantizer lookups of the three bit depths, smooth
weights, filter-intra taps, directional derivatives, coefficient context
offsets, self-guided parameters, scans, the BILINEAR filter, the
Gaussian sequence of film grain, Qm_Offset, superres' Upscale_Filter, the
palette colour contexts and the quantizer matrices. The struct's size is checked against the
library's, so a packing that drifts from the C declaration fails at load
and never decodes.

:func:`probe` parses the sequence header and the output frame's header
(of the first temporal unit: the first shown frame, as libdav1d returns
it by default, or the highest spatial layer's or one layer's, as libavif
asks for it: ``select``); :func:`decode_samples` returns that frame's
planes at the stream's depth (uint8 for 8-bit, uint16 for 10- and 12-bit
streams), decoding first the frames it depends on where it is an inter
frame, and :func:`decode` returns u8 planes, those of a
high-bit-depth stream rounded to 8 bits as the reference's
``avif_native._decode_obu`` rounds libdav1d's. All raise
:class:`ValueError` for a malformed stream (an inter frame of an empty
reference slot among them), and would raise :class:`Av1NotPorted` for a
tool the decoder does not build (none is left). The decode reports the
inter tools its blocks used (``StreamInfo.tools``, :data:`TOOLS`). Two
settings serve tests and timing only, never
the engine: :func:`_decode_samples` can leave a stream's film grain out,
and :func:`_set_threads` caps the decoder's threads.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from . import loader

_HERE = Path(__file__).resolve().parent
_lock = threading.Lock()
_state: dict = {"lib": None}

OK, BAD, NOT_PORTED = 0, -1, -2
#: the output frame of a stream (``select`` of :func:`probe` and
#: :func:`decode_samples`): libdav1d's first picture at its default
#: ``all_layers`` 1 (the reference's native path); the one it returns at
#: ``all_layers`` 0, libavif's setting: the first frame of the operating
#: point's highest spatial layer, else the last shown; 0..3: the first
#: frame of that spatial layer (libavif's ``lsel``)
FIRST, HIGHEST = -1, -2
#: the last frame shown in the first temporal unit (of a stream with no
#: temporal delimiters, the last frame shown: for tests and diagnostics)
LAST = -3
#: the layouts of ``IkAv1dInfo.layout``
I400, I420, I422, I444 = 0, 1, 2, 3
#: the bits of ``StreamInfo.filters``
FILTER_DEBLOCK, FILTER_CDEF, FILTER_LR = 1, 2, 4


#: the inter tools whose blocks a decode counts (``ToolCounts.tools``, in
#: the order of the decoder's TOOL_*): inter blocks, intra blocks of inter
#: frames, NEWMV and GLOBALMV blocks, blocks predicted from a reference of
#: another size, blocks that read their interpolation filter and those
#: whose two filters differ, OBMC, local warp and global warp blocks,
#: interintra (wedge too), the temporal candidates of the motion field,
#: segment ids taken from the previous frame, compound blocks (skip mode,
#: distance weights, wedge and difference-weighted masks among them), and
#: two that only hostile streams show: blocks predicted wholly from
#: outside their reference (the clamped edge), and local warps whose model
#: is degenerate or whose shears are too large (predicted by translation)
TOOLS = ("inter", "intra_in_inter", "newmv", "globalmv", "scaled",
         "switchable_filter", "dual_filter", "obmc", "local_warp",
         "global_warp", "interintra", "wedge_interintra", "temporal_mv",
         "seg_temporal", "compound", "skip_mode", "compound_distance",
         "compound_wedge", "compound_diffwtd", "mv_outside", "warp_invalid")


class Av1NotPorted(Exception):
    """A stream that uses a tool the decoder does not build."""


class _Info(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in (
        "width", "height", "layout", "bitdepth", "mono", "color_range",
        "matrix", "primaries", "transfer", "allow_sct", "allow_intrabc",
        "palette_blocks", "intrabc_blocks", "filters", "qmatrix",
        "film_grain", "superres_denom", "spatial_id", "shown_existing",
        "frames", "inter", "decoded")] + [
            ("tools", ctypes.c_int32 * len(TOOLS)),
            ("reason", ctypes.c_char * 120)]


class StreamInfo(NamedTuple):
    width: int
    height: int
    layout: int
    bitdepth: int
    mono: bool
    full_range: bool
    matrix: int
    primaries: int
    transfer: int
    #: the frame header's allow_screen_content_tools and allow_intrabc
    screen_content: bool = False
    intrabc: bool = False
    #: after a decode, the blocks that coded a palette or intra block copy
    palette_blocks: int = 0
    intrabc_blocks: int = 0
    #: the frame's in-loop filters: 1 deblocking, 2 CDEF, 4 loop
    #: restoration (FILTER_*)
    filters: int = 0
    #: the frame header's using_qmatrix and apply_grain
    qmatrix: bool = False
    film_grain: bool = False
    #: the frame header's SuperresDenom: 8 without superres, else 9..16
    #: (the tiles code a width of width * 8 / superres_denom, rounded;
    #: ``width`` is the upscaled one)
    superres_denom: int = 8
    #: the output frame's spatial_id; whether a show_existing_frame header
    #: showed it (a hidden KEY_FRAME); the frames of the temporal unit read
    #: before it was known
    spatial_id: int = 0
    shown_existing: bool = False
    frames: int = 1
    #: the output frame is an INTER or SWITCH frame; the frames of the
    #: temporal unit decoded for it (itself included)
    inter: bool = False
    decoded: int = 1
    #: after a decode, the blocks of those frames that used each inter
    #: tool, by name (:data:`TOOLS`)
    tools: Optional[dict] = None


# (name in the npz files, C record shape per q context); coefficient
# tables carry a leading q dimension of 4 in av1_tables.npz
_CDF_LAYOUT = (
    ("txb_skip", (5, 13, 3), True),
    ("eob_extra", (5, 2, 9, 3), True),
    ("dc_sign", (2, 3, 3), True),
    ("coeff_base", (5, 2, 42, 5), True),
    ("coeff_br", (5, 2, 21, 5), True),
    ("coeff_base_eob", (5, 2, 4, 4), True),
    ("eob_pt_16", (2, 2, 6), True),
    ("eob_pt_32", (2, 2, 7), True),
    ("eob_pt_64", (2, 2, 8), True),
    ("eob_pt_128", (2, 2, 9), True),
    ("eob_pt_256", (2, 2, 10), True),
    ("eob_pt_512", (2, 11), True),
    ("eob_pt_1024", (2, 12), True),
    ("kf_y_mode", (5, 5, 14), False),
    ("uv_mode_cfl", (13, 15), False),
    ("uv_mode_nocfl", (13, 14), False),
    ("partition", (20, 11), False),
    ("use_filter_intra", (22, 3), False),
    ("filter_intra_mode", (6,), False),
    ("angle_delta", (8, 8), False),
    ("intra_tx1", (4, 13, 8), False),
    ("intra_tx2", (4, 13, 6), False),
    ("skip", (3, 3), False),
    ("segment_id", (3, 9), False),
    ("delta_q", (5,), False),
    ("delta_lf", (5,), False),
    ("delta_lf_multi", (4, 5), False),
    ("cfl_sign", (9,), False),
    ("cfl_alpha", (6, 17), False),
    ("pal_y_mode", (7, 3, 3), False),
    ("pal_uv_mode", (2, 3), False),
    ("tx_8x8", (3, 3), False),
    ("tx_depth", (3, 3, 4), False),
    ("switchable_restore", (4,), False),
    ("wiener_restore", (3,), False),
    ("sgrproj_restore", (3,), False),
    ("pal_y_size", (7, 8), False),
    ("pal_uv_size", (7, 8), False),
    ("pal_color", (2, 7, 5, 9), False),
    ("intrabc", (3,), False),
    ("mv_joint", (5,), False),
    ("mv_class", (2, 12), False),
    ("mv_class0", (2, 3), False),
    ("mv_bits", (2, 10, 3), False),
    ("mv_sign", (2, 3), False),
    ("txfm_split", (21, 3), False),
    ("inter_tx1", (2, 17), False),
    ("inter_tx2", (13,), False),
    ("inter_tx3", (4, 3), False),
    ("y_mode", (4, 14), False),
    ("is_inter", (4, 3), False),
    ("seg_pred", (3, 3), False),
    ("single_ref", (3, 6, 3), False),
    ("new_mv", (6, 3), False),
    ("zero_mv", (2, 3), False),
    ("ref_mv", (6, 3), False),
    ("drl_mode", (3, 3), False),
    ("interp_filter", (16, 4), False),
    ("motion_mode", (22, 4), False),
    ("use_obmc", (22, 3), False),
    ("interintra", (4, 3), False),
    ("interintra_mode", (4, 5), False),
    ("wedge_interintra", (22, 3), False),
    ("wedge_index", (22, 17), False),
    ("mv_joint", (5,), False),
    ("mv_class", (2, 12), False),
    ("mv_class0", (2, 3), False),
    ("mv_bits", (2, 10, 3), False),
    ("mv_sign", (2, 3), False),
    ("mv_class0_fr", (2, 2, 5), False),
    ("mv_fr", (2, 5), False),
    ("mv_class0_hp", (2, 3), False),
    ("mv_hp", (2, 3), False),
    ("skip_mode", (3, 3), False),
    ("comp_mode", (5, 3), False),
    ("comp_ref_type", (5, 3), False),
    ("uni_comp_ref", (3, 3, 3), False),
    ("comp_ref", (3, 3, 3), False),
    ("comp_bwd_ref", (3, 2, 3), False),
    ("compound_mode", (8, 9), False),
    ("comp_group_idx", (6, 3), False),
    ("compound_idx", (6, 3), False),
    ("compound_type", (22, 3), False),
)
_SCANS = ("4x4", "8x8", "16x16", "32x32", "4x8", "8x4", "8x16", "16x8",
          "16x32", "32x16", "4x16", "16x4", "8x32", "32x8")


def _cdf_arrays() -> dict:
    """Every CDF of the layout, as the decoder reads it."""
    enc = np.load(_HERE.parent / "av1_tables.npz")
    dec = np.load(_HERE.parent / "av1_dec_tables.npz")
    out = {k: enc[k] for k in enc.files}
    out.update({k: dec[k] for k in dec.files})
    # eob_pt_512/1024: libaom keeps a context dimension that only its
    # first entry uses
    out["eob_pt_512"] = out["eob_pt_512"][:, :, 0]
    out["eob_pt_1024"] = out["eob_pt_1024"][:, :, 0]
    # uv_mode: [0] CfL not allowed (13 symbols), [1] allowed (14)
    out["uv_mode_cfl"] = out["uv_mode"][1]
    out["uv_mode_nocfl"] = out["uv_mode"][0][:, :14]
    # intra_ext_tx1 comes without its counter
    tx1 = out["intra_ext_tx1"]
    out["intra_tx1"] = np.concatenate(
        [tx1, np.zeros(tx1.shape[:-1] + (1,), tx1.dtype)], axis=-1)
    out["intra_tx2"] = out["intra_ext_tx2"]
    out["tx_depth"] = np.stack([out["tx_16x16"], out["tx_32x32"],
                                out["tx_64x64"]])
    # the colour-index CDFs of every palette size, each record padded to
    # that of 8 colours
    pal = np.zeros((2, 7, 5, 9), np.uint16)
    for t, plane in enumerate(("y", "uv")):
        for n in range(2, 9):
            pal[t, n - 2, :, :n + 1] = out[f"pal_{plane}_color_{n}"]
    out["pal_color"] = pal
    # one copy of each motion vector CDF per component
    for name in ("mv_class", "mv_class0", "mv_bits", "mv_sign",
                 "mv_class0_fr", "mv_fr", "mv_class0_hp", "mv_hp"):
        out[name] = np.stack([out[name]] * 2)
    return out


def tables_blob() -> bytes:
    """The packed ``Tables`` struct of ``av1_decode.cpp``."""
    T = _cdf_arrays()
    parts = []
    for q in range(4):
        for name, shape, per_q in _CDF_LAYOUT:
            a = np.asarray(T[name][q] if per_q else T[name], np.uint16)
            if a.shape != shape:
                raise RuntimeError(f"AV1 table {name} has shape {a.shape}, "
                                   f"the decoder's is {shape}")
            parts.append(a.astype("<u2").tobytes())
    for kind in ("dc", "ac"):
        rows = np.concatenate([np.asarray(T[f"{kind}_qlookup"])[None],
                               np.asarray(T[f"{kind}_qlookup_hbd"])])
        parts.append(rows.astype("<i2").tobytes())
    parts.append(np.asarray(T["dr_intra_derivative"], "<i2").tobytes())
    parts.append(np.asarray(T["sgr_params"], "<i2").tobytes())
    for s in _SCANS:
        parts.append(np.asarray(T[f"scan_{s}"], "<i2").tobytes())
    parts.append(np.asarray(T["bilinear"], "<i2").tobytes())
    parts.append(np.asarray(T["gaussian_sequence"], "<i2").tobytes())
    parts.append(np.asarray(T["qm_offset"], "<i2").tobytes())
    parts.append(np.asarray(T["upscale_filter"], "<i2").tobytes())
    sm = np.zeros(128, np.uint8)
    sm[:124] = T["sm_weights"]
    parts.append(sm.tobytes())
    taps = np.zeros((5, 8, 8), np.int8)
    taps[:, :, :7] = T["filter_intra_taps"]
    parts.append(taps.tobytes())
    parts.append(np.asarray(T["coeff_base_ctx_offset"], np.int8).tobytes())
    parts.append(np.asarray(T["palette_color_context"], np.int8).tobytes())
    parts.append(np.asarray(T["palette_hash_mult"], np.int8).tobytes())
    parts.append(b"\0")  # the struct's pad_ byte
    parts.append(np.asarray(T["quantizer_matrix"], np.uint8).tobytes())
    parts.append(np.asarray(T["subpel_filters"], "<i2").tobytes())
    parts.append(np.asarray(T["warped_filters"], "<i2").tobytes())
    parts.append(np.asarray(T["div_lut"], "<i2").tobytes())
    parts.append(b"\0\0")  # pad2_
    for name in ("obmc_masks", "wedge_master", "wedge_codebook", "ii_weights",
                 "quant_dist_weight", "quant_dist_lookup"):
        parts.append(np.asarray(T[name], np.uint8).tobytes())
    # where each CDF record keeps its counter: after the 0 that ends its
    # inverse cdf (records padded to a wider kind end in more zeros)
    mask = []
    for name, shape, per_q in _CDF_LAYOUT:
        a = np.asarray(T[name][0] if per_q else T[name], np.uint16)
        for rec in a.reshape(-1, shape[-1]):
            m = np.zeros(shape[-1], np.uint8)
            m[int(np.flatnonzero(rec == 0)[0]) + 1] = 1
            mask.append(m)
    mask = np.concatenate(mask)
    parts.append(mask.tobytes() + b"\0" * (len(mask) % 2))
    return b"".join(parts)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ik_av1d_tables_size.restype = ctypes.c_int
    lib.ik_av1d_set_tables.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ik_av1d_set_tables.restype = ctypes.c_int
    lib.ik_av1d_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(_Info)]
    lib.ik_av1d_probe.restype = ctypes.c_int
    lib.ik_av1d_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Info)]
    lib.ik_av1d_decode.restype = ctypes.c_int
    lib.ik_av1d_tx1d.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ik_av1d_set_threads.argtypes = [ctypes.c_int]


def load(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """The native library with the decoder's tables set (``lib``: another
    build of the same sources, for the sanitizer tests)."""
    with _lock:
        if lib is None and _state["lib"] is not None:
            return _state["lib"]
        target = lib if lib is not None else loader.load()
        _bind(target)
        blob = tables_blob()
        if len(blob) != target.ik_av1d_tables_size():
            raise RuntimeError(
                f"AV1 decoder tables packed to {len(blob)} bytes, the "
                f"library declares {target.ik_av1d_tables_size()}")
        if target.ik_av1d_set_tables(blob, len(blob)) != OK:
            raise RuntimeError("the AV1 decoder refused its tables")
        if lib is None:
            _state["lib"] = target
        return target


def _set_threads(n: int, lib: Optional[ctypes.CDLL] = None) -> None:
    """The threads a decode takes for its tiles, CDEF's rows and film
    grain's stripes, for the whole process: at most ``n``, 0 for one a
    core (the default). The planes are the same at any count."""
    (lib or load()).ik_av1d_set_threads(n)


def _raise(rc: int, info: _Info) -> None:
    why = info.reason.decode("ascii", "replace")
    if rc == NOT_PORTED:
        raise Av1NotPorted(why)
    raise ValueError(f"AV1 stream does not decode: {why}")


def _info(info: _Info) -> StreamInfo:
    return StreamInfo(info.width, info.height, info.layout, info.bitdepth,
                      bool(info.mono), bool(info.color_range), info.matrix,
                      info.primaries, info.transfer, bool(info.allow_sct),
                      bool(info.allow_intrabc), info.palette_blocks,
                      info.intrabc_blocks, info.filters, bool(info.qmatrix),
                      bool(info.film_grain), info.superres_denom,
                      info.spatial_id, bool(info.shown_existing), info.frames,
                      bool(info.inter), info.decoded,
                      dict(zip(TOOLS, info.tools)))


def probe(obu: bytes, lib: Optional[ctypes.CDLL] = None,
          select: int = FIRST, op: int = 0) -> StreamInfo:
    """The stream's sequence header and output frame's header (``select``
    as :data:`FIRST`, ``op`` the operating point, libavif's ``a1op``)."""
    lib = lib or load()
    info = _Info()
    rc = lib.ik_av1d_probe(obu, len(obu), select, op, ctypes.byref(info))
    if rc != OK:
        _raise(rc, info)
    return _info(info)


def decode_samples(obu: bytes, lib: Optional[ctypes.CDLL] = None,
                   expect: Optional[tuple] = None, select: int = FIRST,
                   op: int = 0):
    """The output frame of an AV1 OBU stream (``select`` and ``op`` as for
    :func:`probe`) at its own depth -> (y, u | None, v | None,
    StreamInfo): uint8 planes for an 8-bit stream, uint16 for a 10- or
    12-bit one, width x height luma, chroma rounded up by the layout's
    subsampling (None for monochrome). ``expect``: the (width, height) the
    container gives; a frame of another size raises ValueError before
    anything is allocated for it."""
    return _decode_samples(obu, lib, expect, True, select, op)


def _decode_samples(obu: bytes, lib: Optional[ctypes.CDLL] = None,
                    expect: Optional[tuple] = None, apply_grain: bool = True,
                    select: int = FIRST, op: int = 0):
    """:func:`decode_samples`; ``apply_grain`` False leaves a stream's film
    grain out (libdav1d's setting of that name): the reconstruction alone,
    for diagnostics and timing."""
    lib = lib or load()
    head = probe(obu, lib, select, op)
    w, h = head.width, head.height
    if expect is not None and (w, h) != tuple(expect):
        raise ValueError(f"AV1 stream of {w}x{h} in a {expect[0]}x"
                         f"{expect[1]} item")
    dt = np.uint8 if head.bitdepth == 8 else np.uint16
    y = np.empty((h, w), dt)
    cw = ch = 1
    if head.layout != I400:
        cw = (w + 1) // 2 if head.layout in (I420, I422) else w
        ch = (h + 1) // 2 if head.layout == I420 else h
    u = np.empty((ch, cw), dt)
    v = np.empty((ch, cw), dt)
    info = _Info()
    rc = lib.ik_av1d_decode(obu, len(obu), head.bitdepth, y.ctypes.data, w,
                            u.ctypes.data, v.ctypes.data, cw,
                            int(apply_grain), select, op, ctypes.byref(info))
    if rc != OK:
        _raise(rc, info)
    if head.layout == I400:
        u = v = None
    return y, u, v, _info(info)


def to_8bit(plane: Optional[np.ndarray], bitdepth: int):
    """A plane of ``bitdepth`` samples rounded to 8 bits as the
    reference's ``_decode_obu`` rounds libdav1d's: (v + 2^(s-1)) >> s,
    clipped to 255, s = bitdepth - 8."""
    if plane is None or bitdepth == 8:
        return plane
    s = bitdepth - 8
    return np.minimum((plane + (1 << (s - 1))) >> s, 255).astype(np.uint8)


def decode(obu: bytes, lib: Optional[ctypes.CDLL] = None,
           expect: Optional[tuple] = None, select: int = FIRST, op: int = 0):
    """:func:`decode_samples` with u8 planes: a 10- or 12-bit stream's
    rounded by :func:`to_8bit`."""
    y, u, v, info = decode_samples(obu, lib, expect, select, op)
    return (to_8bit(y, info.bitdepth), to_8bit(u, info.bitdepth),
            to_8bit(v, info.bitdepth), info)
