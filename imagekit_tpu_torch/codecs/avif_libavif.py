"""The AVIFs the reference hands to Pillow, decoded as Pillow 12.1's
libavif 1.3.0 decodes them, without Pillow, libavif or libdav1d.

The reference's native path (``imagekit_tpu/codecs/avif_native.py``,
:mod:`.avif_native` here) declines a file whose primary item is a grid,
whose colour item has no ``nclx`` box or a matrix other than BT.601 /
BT.709, or whose alpha is premultiplied or found twice; its
``decode_bytes`` then decodes the file with ``pil_backend.decode``. This
module is the port's counterpart of that call, in four steps:

1. the container as libavif's ``read.c`` reads it (:func:`_read`): items
   in libavif's order, ``iloc`` extents (file or ``idat``), ``iref``
   (``dimg`` with its cell order, ``auxl``, ``prem``), properties;
   ``grid`` items and their ImageGrid payload; the alpha item libavif
   takes (the first ``auxl`` item for the colour item whose ``auxC`` names
   alpha); ``colr`` ``nclx``, ``prof`` and ``rICC``;
2. each AV1 item or cell through the port's decoder
   (:mod:`.native.av1_dec_abi`) at the stream's own depth, with the layer
   choice libavif makes when Pillow leaves progressive decoding off: the
   ``a1op`` operating point, and the highest spatial layer (libdav1d's
   ``all_layers`` off) or the one ``lsel`` names, fed the bytes ``a1lx``
   gives that layer; a limited-range alpha stream taken to full range;
   a stream that is not its item's ``ispe`` size rescaled to it as libavif
   rescales it (:mod:`.native.avif_scale`, libyuv's ``ScalePlane``); a
   grid's cells on threads, stitched in YUV as libavif stitches them
   (chroma upsampling then crosses the cells' seams) and cropped to the
   output size; an alpha grid made of one ``auxl`` item a colour cell
   where the colour grid has no alpha item of its own
   (``avifMetaFindAlphaItem``);
3. YUV -> RGB(A) in :mod:`.native.avif_yuv_rgb`, libavif's and libyuv's
   arithmetic, with the colour description libavif settles on: the
   ``nclx`` box's, else the first stream's sequence header's;
4. Pillow's own steps: RGBA where libavif found alpha, RGB otherwise; the
   decompression-bomb ceiling (``Image.MAX_IMAGE_PIXELS``) on the
   ``ispe`` size; the pixels read at that size. ``clap``, ``irot`` and
   ``imir`` leave the pixels as they are (libavif does not apply them on
   this path, and Pillow turns the rotation into an EXIF orientation).

Files libavif refuses raise TransformError with the words Pillow reports
(the reference's 400). A stream whose output frame is an inter frame
(libavif's highest layer of a progressive file) decodes with the frames it
depends on.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from imagekit_tpu_torch.codecs.avif_native import (
    _boxes,
    undecodable_message,
)
from imagekit_tpu_torch.codecs.native.avif_scale import (
    DIMENSION_LIMIT,
    SIZE_LIMIT,
)
from imagekit_tpu_torch.errors import TransformError

#: Pillow's ``Image.MAX_IMAGE_PIXELS``: twice this is its ceiling
PILLOW_MAX_PIXELS = 89_478_485
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")
_I400, _I420, _I422, _I444 = 0, 1, 2, 3

UNIDENTIFIED = "cannot identify image file"


class _Fail(Exception):
    """libavif's result at the open ("Failed to decode image: ...") or the
    frame's decode ("Failed to decode frame 0: ..."), or Pillow's words."""


def _open_error(result: str) -> _Fail:
    return _Fail(f"Failed to decode image: {result}")


def _frame_error(result: str) -> _Fail:
    return _Fail(f"Failed to decode frame 0: {result}")


GRID = "Invalid image grid"


@dataclass
class _Item:
    id: int
    type: bytes = b""
    extents: List[Tuple[int, int]] = field(default_factory=list)
    idat: bool = False
    size: int = 0
    props: List[Tuple[bytes, int, int]] = field(default_factory=list)
    dimg_for: int = 0
    dimg_idx: int = 0
    aux_for: int = 0
    prem_by: int = 0
    #: an alpha grid libavif makes of one auxl item a colour cell: the
    #: colour grid's (rows, cols, width, height) and the alpha cells
    synth: Optional[Tuple[Tuple[int, int, int, int], List["_Item"]]] = None

    def prop(self, typ: bytes):
        """The first associated property of that type, or None."""
        return next((p for p in self.props if p[0] == typ), None)


@dataclass
class _File:
    data: bytes
    primary: int
    items: Dict[int, _Item]      # in libavif's order (first mention)
    idat: Tuple[int, int] = (0, 0)

    def payload(self, item: _Item) -> bytes:
        base = self.idat[0] if item.idat else 0
        end = self.idat[1] if item.idat else len(self.data)
        out = b"".join(self.data[base + o:min(base + o + n, end)]
                       for o, n in item.extents)
        if len(out) < item.size:
            raise _frame_error("Truncated data")
        return out


def _u(data: bytes, o: int, n: int) -> int:
    if o + n > len(data):
        raise ValueError("box runs past its end")
    return int.from_bytes(data[o:o + n], "big")


def _read(data: bytes) -> _File:
    """The meta box as libavif reads it; ValueError where it does not."""
    if len(data) < 16 or data[4:8] != b"ftyp":
        raise ValueError("not an ISOBMFF file")
    meta = next(((a, b) for t, a, b in _boxes(data, 0, len(data))
                 if t == b"meta"), None)
    if meta is None:
        raise ValueError("no meta box")
    items: Dict[int, _Item] = {}

    def get(iid: int) -> _Item:
        if iid not in items:
            if len(items) >= 4096:
                raise ValueError("implausible item count")
            items[iid] = _Item(iid)
        return items[iid]

    primary = None
    idat = (0, 0)
    props: List[Tuple[bytes, int, int]] = []
    assoc: List[Tuple[int, List[Tuple[int, bool]]]] = []
    for t, a, b in _boxes(data, meta[0] + 4, meta[1]):
        if t == b"pitm":
            primary = _u(data, a + 4, 2 if data[a] == 0 else 4)
        elif t == b"idat":
            idat = (a, b)
        elif t == b"iloc":
            _read_iloc(data, a, b, get)
        elif t == b"iinf":
            off = a + 4 + (2 if data[a] == 0 else 4)
            for t2, a2, b2 in _boxes(data, off, b):
                if t2 != b"infe" or data[a2] < 2:
                    continue
                w = 2 if data[a2] == 2 else 4
                it = get(_u(data, a2 + 4, w))
                o = a2 + 4 + w + 2
                it.type = data[o:o + 4]
        elif t == b"iref":
            w = 2 if data[a] == 0 else 4
            for t2, a2, b2 in _boxes(data, a + 4, b):
                frm = get(_u(data, a2, w))
                n = _u(data, a2 + w, 2)
                for k in range(n):
                    to = _u(data, a2 + w + 2 + w * k, w)
                    if t2 == b"auxl":
                        frm.aux_for = to
                    elif t2 == b"prem":
                        frm.prem_by = to
                    elif t2 == b"dimg":
                        cell = get(to)
                        cell.dimg_for, cell.dimg_idx = frm.id, k
        elif t == b"iprp":
            for t2, a2, b2 in _boxes(data, a, b):
                if t2 == b"ipco":
                    props = list(_boxes(data, a2, b2))
                elif t2 == b"ipma":
                    assoc += _read_ipma(data, a2, b2)
    if primary is None:
        raise ValueError("no pitm")
    for t, a, b in props:
        _check_layer_property(data, t, a, b)
    seen = set()
    for iid, idxs in assoc:
        if iid in seen:
            raise ValueError("an item associated twice in ipma")
        seen.add(iid)
        it = get(iid)
        for idx, essential in idxs:
            if idx == 0:
                continue
            if idx > len(props):
                raise ValueError("ipma names a property ipco lacks")
            # a1op and lsel must be essential, a1lx must not be
            if (props[idx - 1][0] in (b"a1op", b"lsel")) != essential and \
                    props[idx - 1][0] in (b"a1op", b"lsel", b"a1lx"):
                raise _Fail(UNIDENTIFIED)
            it.props.append(props[idx - 1])
    return _File(data, primary, items, idat)


def _check_layer_property(data: bytes, t: bytes, a: int, b: int) -> None:
    """libavif's parse of the AV1 layer properties in ipco: an a1op's
    operating point at most 31, an lsel's layer id, an a1lx's reserved
    bits 0 and its three sizes; Pillow reports a failure as an
    unidentified file."""
    need = {b"a1op": 1, b"lsel": 2, b"a1lx": 1}.get(t)
    if need is None:
        return
    if b - a < need:
        raise _Fail(UNIDENTIFIED)
    if t == b"a1op" and data[a] > 31:
        raise _Fail(UNIDENTIFIED)
    if t == b"a1lx" and (data[a] & 0xFE or
                         b - a < 1 + 3 * (4 if data[a] & 1 else 2)):
        raise _Fail(UNIDENTIFIED)


def _read_iloc(data: bytes, a: int, b: int, get) -> None:
    v = data[a]
    if v > 2:
        raise ValueError("iloc version")
    o = a + 4
    osz, lsz = data[o] >> 4, data[o] & 15
    bsz = data[o + 1] >> 4
    isz = (data[o + 1] & 15) if v in (1, 2) else 0
    o += 2
    w = 2 if v < 2 else 4
    count = _u(data, o, w)
    o += w
    for _ in range(count):
        it = get(_u(data, o, w))
        o += w
        method = 0
        if v in (1, 2):
            method = _u(data, o, 2) & 15
            o += 2
        if method > 1:
            raise ValueError("iloc construction method")
        o += 2
        base = _u(data, o, bsz) if bsz else 0
        o += bsz
        n = _u(data, o, 2)
        o += 2
        if n > 1024:
            raise ValueError("implausible extent count")
        it.idat = method == 1
        for _ in range(n):
            o += isz
            off = _u(data, o, osz) if osz else 0
            o += osz
            length = _u(data, o, lsz) if lsz else 0
            o += lsz
            it.extents.append((base + off, length))
            it.size += length
        if o > b:
            raise ValueError("iloc runs past its box")


def _read_ipma(data: bytes, a: int, b: int):
    v, flags = data[a], _u(data, a + 1, 3)
    o = a + 4
    count = _u(data, o, 4)
    o += 4
    if count > 4096:
        raise ValueError("implausible ipma entry count")
    out = []
    last = -1
    for _ in range(count):
        w = 2 if v < 1 else 4
        iid = _u(data, o, w)
        o += w
        if iid <= last:
            raise ValueError("ipma's item IDs out of order")
        last = iid
        k = _u(data, o, 1)
        o += 1
        idxs = []
        for _ in range(k):
            if flags & 1:
                x = _u(data, o, 2)
                o += 2
                idxs.append((x & 0x7FFF, bool(x & 0x8000)))
            else:
                x = _u(data, o, 1)
                o += 1
                idxs.append((x & 0x7F, bool(x & 0x80)))
        out.append((iid, idxs))
    if o > b:
        raise ValueError("ipma runs past its box")
    return out


# ---------------------------------------------------------------------------
# properties


def _ispe(f: _File, item: _Item) -> Tuple[int, int]:
    p = item.prop(b"ispe")
    if p is None or p[2] - p[1] < 12:
        raise _Fail(UNIDENTIFIED)  # libavif: the mandatory ispe is missing
    w, h = _u(f.data, p[1] + 4, 4), _u(f.data, p[1] + 8, 4)
    if w == 0 or h == 0:
        raise _Fail(UNIDENTIFIED)  # an image of no size
    return w, h


def _av1c(f: _File, item: _Item) -> Optional[bytes]:
    p = item.prop(b"av1C")
    return None if p is None else f.data[p[1]:p[1] + 4]


@dataclass
class _Colour:
    """What libavif's colour description of the file holds."""

    nclx: Optional[Tuple[int, int, int, bool]] = None  # (prim, trc, mtx, full)
    icc: bool = False


def _colour(f: _File, item: _Item) -> _Colour:
    """avifReadColorProperties: one nclx and one ICC box at most."""
    out = _Colour()
    for t, a, b in item.props:
        if t != b"colr" or b - a < 4:
            continue
        kind = f.data[a:a + 4]
        if kind in (b"rICC", b"prof"):
            if out.icc:
                raise _Fail(UNIDENTIFIED)
            out.icc = True
        elif kind == b"nclx":
            if out.nclx is not None or b - a < 11:
                raise _Fail(UNIDENTIFIED)
            out.nclx = (_u(f.data, a + 4, 2), _u(f.data, a + 6, 2),
                        _u(f.data, a + 8, 2), bool(f.data[a + 10] & 0x80))
    return out


def _is_alpha(f: _File, item: _Item) -> bool:
    p = item.prop(b"auxC")
    if p is None:
        return False
    urn = f.data[p[1] + 4:p[2]].split(b"\0", 1)[0]
    return urn in _ALPHA_URNS


# ---------------------------------------------------------------------------
# images: one AV1 item, or a grid of them


@dataclass
class _Grid:
    rows: int
    cols: int
    width: int
    height: int
    cells: List[_Item]


def _grid(f: _File, item: _Item) -> _Grid:
    """avifParseImageGridBox and the dimg checks of
    avifDecoderItemReadAndParse / avifDecoderGenerateImageGridTiles."""
    if item.synth is not None:
        (rows, cols, ow, oh), order = item.synth
        return _grid_cells(f, rows, cols, ow, oh, order)
    p = f.payload(item)
    if len(p) < 8 or p[0] != 0:
        raise _open_error(GRID)
    wide = p[1] & 1
    rows, cols = p[2] + 1, p[3] + 1
    if len(p) != (12 if wide else 8):
        raise _open_error(GRID)
    if wide:
        ow, oh = struct.unpack(">II", p[4:12])
    else:
        ow, oh = struct.unpack(">HH", p[4:8])
    if ow == 0 or oh == 0 or ow > DIMENSION_LIMIT or oh > DIMENSION_LIMIT \
            or ow * oh > SIZE_LIMIT:
        raise _open_error(GRID)
    cells = [it for it in f.items.values() if it.dimg_for == item.id]
    if len(cells) != rows * cols:
        raise _open_error(GRID)
    order: List[Optional[_Item]] = [None] * len(cells)
    for c in cells:
        if c.dimg_idx >= len(order) or order[c.dimg_idx] is not None:
            raise _open_error(GRID)
        order[c.dimg_idx] = c
    return _grid_cells(f, rows, cols, ow, oh, order)


def _grid_cells(f: _File, rows: int, cols: int, ow: int, oh: int,
                order: List[_Item]) -> _Grid:
    """The checks of a grid's cells, in their order."""
    first = None
    for c in order:
        if c.type != b"av01":
            raise _open_error(GRID)
        if c.size == 0:
            raise _Fail(UNIDENTIFIED)
        cfg = _av1c(f, c)
        if first is None:
            if cfg is None:
                raise _open_error(GRID)
            first = cfg
        elif cfg != first:
            raise _Fail(UNIDENTIFIED)  # the tiles' av1C differ
        _ispe(f, c)
    # the first cell's coded size against MIAF's rules: at least 64, even
    # where the chroma is subsampled in that direction (its ispe's, once
    # scaled, at the frame's decode: _picture)
    tw, th = _coded_size(f, order[0])
    mono, sx, sy = first[2] & 0x10, first[2] & 0x08, first[2] & 0x04
    if tw < 64 or th < 64 or (not mono and sx and tw % 2) or \
            (not mono and sy and th % 2):
        raise _Fail(UNIDENTIFIED)
    return _Grid(rows, cols, ow, oh, order)


def _coded_size(f: _File, item: _Item) -> Tuple[int, int]:
    """The size of the frame libavif's codec returns for the item, read
    from its headers; its ispe where they do not parse (the decode fails
    later)."""
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    try:
        cut, select, op = _layer_choice(f, item)
        head = av1_dec_abi.probe(f.payload(item)[:cut], select=select, op=op)
    except (ValueError, _Fail):
        return _ispe(f, item)
    return head.width, head.height


@dataclass
class _Picture:
    """Decoded samples of an item or a stitched grid, libavif's image."""

    y: np.ndarray
    u: Optional[np.ndarray]
    v: Optional[np.ndarray]
    layout: int
    depth: int
    full_range: bool   # the (first) stream's sequence header's
    cicp: Tuple[int, int, int]  # the same header's (prim, trc, mtx)


def _layer_choice(f: _File, item: _Item) -> Tuple[Optional[int], int, int]:
    """What libavif feeds its codec for an item with progressive decoding
    off (avifCodecDecodeInputFillFromDecoderItem): (the bytes of the
    payload it feeds, None for all of them; the frame to return; the
    operating point). The point is ``a1op``'s (0 without one); an ``lsel``
    layer other than 0xFFFF selects that spatial layer and, where ``a1lx``
    gives the layers' sizes, only the bytes up to that layer's end;
    otherwise the highest spatial layer (libdav1d's ``all_layers`` off)
    of the whole payload. Its refusals are the open's."""
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    p = item.prop(b"a1op")
    op = f.data[p[1]] if p is not None else 0
    sizes: List[int] = []
    p = item.prop(b"a1lx")
    if p is not None:
        n = 4 if f.data[p[1]] & 1 else 2
        rest = item.size
        for i in range(3):
            size = _u(f.data, p[1] + 1 + i * n, n)
            if not size:
                sizes.append(rest)
                rest = 0
                break
            if size >= rest:  # room must be left for the last layer
                raise _Fail(UNIDENTIFIED)
            sizes.append(size)
            rest -= size
        if rest:
            sizes.append(rest)
    p = item.prop(b"lsel")
    layer = _u(f.data, p[1], 2) if p is not None else 0xFFFF
    if layer == 0xFFFF:
        return None, av1_dec_abi.HIGHEST, op
    if sizes and layer >= len(sizes) or layer > 3:
        raise _Fail(UNIDENTIFIED)
    return (sum(sizes[:layer + 1]) if sizes else None), layer, op


def _decode_one(f: _File, item: _Item, alpha: bool,
                crop: Optional[Tuple[int, int]] = None, threads: int = 0):
    """One AV1 item as libavif's codec gives it, at its own depth, scaled
    to its ispe as avifDecoderDecodeTiles scales it (an alpha stream taken
    to full range first); ``crop``: only that top-left part of the scaled
    planes (the part of a grid's last cells the canvas keeps) -> (y, u, v,
    StreamInfo of the scaled size)."""
    from imagekit_tpu_torch.codecs.native import (
        av1_dec_abi,
        avif_scale,
        avif_yuv_rgb,
    )

    fail = _frame_error("Decoding of alpha plane failed" if alpha
                        else "Decoding of color planes failed")
    cut, select, op = _layer_choice(f, item)
    obu = f.payload(item)[:cut]
    try:
        y, u, v, info = av1_dec_abi.decode_samples(obu, select=select, op=op)
    except ValueError:
        raise fail from None
    if alpha:
        u = v = None
        if not info.full_range:
            y = avif_yuv_rgb.limited_to_full(y, info.bitdepth)
    size = _ispe(f, item)
    if (info.width, info.height) == size and crop in (None, size):
        return y, u, v, info
    try:
        avif_scale.check((info.width, info.height), size)
    except avif_scale.Refused:
        raise fail from None
    w, h = size
    cw, ch = crop or size
    y = avif_scale.scale_plane(y, w, h, (cw, ch), threads)
    if u is not None:
        sx = 1 if info.layout in (_I420, _I422) else 0
        sy = 1 if info.layout == _I420 else 0
        dims = ((w + sx) >> sx, (h + sy) >> sy)
        c = ((cw + sx) >> sx, (ch + sy) >> sy)
        u = avif_scale.scale_plane(u, *dims, c, threads)
        v = avif_scale.scale_plane(v, *dims, c, threads)
    return y, u, v, info._replace(width=w, height=h)


def _pool_map(fn, args: list, threads: int):
    if len(args) == 1 or threads == 1:
        return [fn(a) for a in args]
    import os

    workers = min(len(args), threads or os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, args))


def _picture(f: _File, item: _Item, alpha: bool, threads: int) -> _Picture:
    """The item's samples: an av01 item decoded (and scaled to its ispe),
    or a grid's cells decoded on threads, each scaled to its ispe, and
    stitched (avifDecoderDataCopyTileToImage) into the output canvas at
    the cells' depth and layout."""
    if item.type != b"grid":
        y, u, v, info = _decode_one(f, item, alpha, threads=threads)
        return _Picture(y, u, v, info.layout, info.bitdepth, info.full_range,
                        (info.primaries, info.transfer, info.matrix))
    g = _grid(f, item)
    sizes = [_ispe(f, c) for c in g.cells]
    if len(set(sizes)) != 1:
        raise _frame_error(GRID)  # rescaled cells of several sizes
    tw, th = sizes[0]
    # avifDecoderDataAllocateImagePlanes, on the first cell as scaled: the
    # cells cover the canvas, the last row and column reach into it
    if tw * g.cols < g.width or th * g.rows < g.height or \
            tw * (g.cols - 1) >= g.width or th * (g.rows - 1) >= g.height:
        _decode_one(f, g.cells[0], alpha, (1, 1))  # its failure comes first
        raise _frame_error(GRID)
    crops = [(min(tw, g.width - tw * (k % g.cols)),
              min(th, g.height - th * (k // g.cols)))
             for k in range(len(g.cells))]
    cells = _pool_map(
        lambda k: _decode_one(f, g.cells[k], alpha, crops[k]),
        list(range(len(g.cells))), threads)
    keys = {(i.width, i.height, i.bitdepth, i.layout, i.full_range,
             i.primaries, i.transfer, i.matrix) for *_, i in cells}
    if len(keys) != 1:
        raise _frame_error(GRID)  # "Grid image contains mismatched tiles"
    info = cells[0][3]
    layout = info.layout
    # avifAreGridDimensionsValid on the cells as scaled
    sx = 1 if layout in (_I420, _I422) else 0
    sy = 1 if layout == _I420 else 0
    if tw < 64 or th < 64 or layout != _I400 and (
            (sx and (g.width % 2 or tw % 2))
            or (sy and (g.height % 2 or th % 2))):
        raise _frame_error(GRID)
    dt = cells[0][0].dtype
    y = np.empty((g.height, g.width), dt)
    u = v = None
    if layout != _I400 and not alpha:
        cshape = ((g.height + sy) >> sy, (g.width + sx) >> sx)
        u, v = np.empty(cshape, dt), np.empty(cshape, dt)
    for k, (cy, cu, cv, _) in enumerate(cells):
        x0, y0 = tw * (k % g.cols), th * (k // g.cols)
        w, h = crops[k]
        y[y0:y0 + h, x0:x0 + w] = cy[:h, :w]
        if u is not None:
            cw, chh = (w + sx) >> sx, (h + sy) >> sy
            u[y0 >> sy:(y0 >> sy) + chh, x0 >> sx:(x0 >> sx) + cw] = \
                cu[:chh, :cw]
            v[y0 >> sy:(y0 >> sy) + chh, x0 >> sx:(x0 >> sx) + cw] = \
                cv[:chh, :cw]
    return _Picture(y, u, v, layout, info.bitdepth, info.full_range,
                    (info.primaries, info.transfer, info.matrix))


def _alpha_item(f: _File, colour: _Item) -> Optional[_Item]:
    """avifMetaFindAlphaItem: the first item, in libavif's order, that is
    an auxiliary image of the colour item with an alpha auxC; else, for a
    colour grid, a grid libavif makes of the alpha items of its cells (one
    each, in the cells' item order, on the colour grid's layout), where
    every cell has one."""
    for it in f.items.values():
        if it.size == 0 or it.type not in (b"av01", b"grid"):
            continue
        if it.aux_for == colour.id and _is_alpha(f, it):
            return it
    if colour.type != b"grid":
        return None
    g = _grid(f, colour)
    alphas: List[_Item] = []
    for cell in f.items.values():
        if cell.dimg_for != colour.id:
            continue
        mine = [a for a in f.items.values()
                if a.aux_for == cell.id and _is_alpha(f, a)]
        if not mine:
            return None  # a cell without alpha: an image without alpha
        if len(mine) > 1 or mine[0].dimg_for != 0 or \
                len(alphas) >= g.rows * g.cols:
            raise _open_error(GRID)
        alphas.append(mine[0])
    if len(alphas) != g.rows * g.cols:
        raise _open_error(GRID)
    return _Item(max(f.items) + 1, b"grid", size=1,
                 synth=((g.rows, g.cols, g.width, g.height), alphas))


# ---------------------------------------------------------------------------
# the decode


class Planes(NamedTuple):
    """A file's samples and the description libavif converts them with:
    what :func:`decode_pillow_rgb` hands to the colour step."""

    y: np.ndarray
    u: Optional[np.ndarray]
    v: Optional[np.ndarray]
    alpha: Optional[np.ndarray]   # full range, or None
    depth: int
    layout: int
    full_range: bool
    matrix: int
    primaries: int
    premultiplied: bool
    width: int                     # the ispe's, which Pillow reads at
    height: int


def decode_pillow_rgb(data: bytes, threads: int = 0) -> np.ndarray:
    """The file as the reference's ``pil_backend.decode`` returns it: HWC
    u8, RGBA where libavif finds an alpha item, RGB otherwise. Raises
    TransformError with Pillow's words where libavif or Pillow refuses the
    file. ``threads``
    (tests and timing): the workers of the cells and of the colour step,
    0 for one a core."""
    from imagekit_tpu_torch.codecs.native import avif_yuv_rgb

    p = planes_of(data, threads)
    try:
        rgb = avif_yuv_rgb.convert(p.y, p.u, p.v, p.alpha, p.depth,
                                   p.layout, p.full_range, p.matrix,
                                   p.primaries, p.premultiplied, threads)
    except avif_yuv_rgb.Refused:
        raise TransformError(
            "Conversion from YUV failed: Reformat failed") from None
    try:
        return _as_pillow_reads(rgb, p.width, p.height)
    except _Fail as e:
        raise TransformError(str(e)) from None


def planes_of(data: bytes, threads: int = 0) -> Planes:
    """Steps 1 and 2 of :func:`decode_pillow_rgb`: the container read, the
    items decoded (a grid's cells stitched), the alpha at full range and
    the colour description; its errors."""
    try:
        return _planes(data, threads)
    except _Fail as e:
        raise TransformError(str(e)) from None


def _planes(data: bytes, threads: int) -> Planes:
    try:
        f = _read(data)
    except (ValueError, IndexError, struct.error) as e:
        raise _Fail(undecodable_message(data)) from e
    colour = f.items.get(f.primary)
    if colour is None or colour.type not in (b"av01", b"grid") or \
            colour.size == 0:
        raise _open_error("Missing or empty image item")
    if colour.type == b"av01" and _av1c(f, colour) is None:
        raise _Fail(UNIDENTIFIED)
    width, height = _ispe(f, colour)
    if width > DIMENSION_LIMIT or height > DIMENSION_LIMIT or \
            width * height > SIZE_LIMIT:
        raise _Fail(UNIDENTIFIED)
    desc = _colour(f, colour)
    if colour.type == b"grid":
        _grid(f, colour)  # its refusals come at the open, before alpha's
    alpha_item = _alpha_item(f, colour)
    if alpha_item is not None and alpha_item.type == b"grid":
        _grid(f, alpha_item)
    for it in (colour, alpha_item):  # the codecs' inputs, filled at the open
        if it is not None:
            for c in _grid(f, it).cells if it.type == b"grid" else [it]:
                _layer_choice(f, c)
    # Pillow's decompression-bomb check, once the file opened
    if width * height > 2 * PILLOW_MAX_PIXELS:
        raise _Fail(
            f"Image size ({width * height} pixels) exceeds limit of "
            f"{2 * PILLOW_MAX_PIXELS} pixels, could be decompression bomb "
            "DOS attack.")
    pic = _picture(f, colour, False, threads)
    a = None
    if alpha_item is not None:
        ap = _picture(f, alpha_item, True, threads)
        if ap.y.shape != pic.y.shape or ap.depth != pic.depth:
            raise _frame_error(
                "Invalid argument" if alpha_item.type == b"grid"
                else "Decoding of alpha plane failed")
        a = ap.y  # full range already (_decode_one)
    if desc.nclx is not None:
        prim, _trc, mtx, full = desc.nclx
    else:
        (prim, _trc, mtx), full = pic.cicp, pic.full_range
    prem = alpha_item is not None and colour.prem_by == alpha_item.id
    return Planes(pic.y, pic.u, pic.v, a, pic.depth, pic.layout, full, mtx,
                  prim, prem, width, height)


def _as_pillow_reads(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow sizes the image by the ``ispe`` and reads the decoded bytes
    row by row at that size: a grid whose output is another size comes
    out re-strided, or short ("image file is truncated")."""
    h, w, ch = rgb.shape
    if (w, h) == (width, height):
        return rgb
    flat = rgb.reshape(-1)
    need = width * height * ch
    if flat.size < need:
        raise _Fail(f"image file is truncated "
                    f"({flat.size % (width * ch)} bytes not processed)")
    return flat[:need].reshape(height, width, ch).copy()
