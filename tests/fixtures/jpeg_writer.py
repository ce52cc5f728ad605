"""A baseline Huffman JPEG writer in numpy, for fixtures no encoder here
writes: any sampling factors 1-4 a component, one interleaved scan or one
scan a component, an optional restart interval.

Pillow's and libjpeg's writers take factors of 1 and 2 only, the port's
native encoder too, and neither writes a baseline frame in several scans;
``chip_smoke.py`` needs the fixtures on a machine with no Pillow. So this
module needs numpy alone (``chip_smoke.py`` loads it by its path):

- :func:`write` entropy-codes quantised coefficient planes, laid out as
  the decoders return them (``(blocks_h, blocks_w, 64)`` int16 a
  component, natural order, the grid padded to whole MCUs), with the
  Annex K Huffman tables (K.3: component 0 on the luminance tables, the
  others on the chrominance ones). In a scan of one component its blocks
  run over ``ceil(cw / 8) x ceil(ch / 8)`` in raster order (T.81 A.2.2):
  the MCU-padding blocks are not coded.
- :func:`coefficients` gives such planes for an RGB picture: BT.601
  full-range YCbCr, each component box-filtered down to its factors, the
  8x8 forward DCT, the Annex K tables scaled to a quality as libjpeg does.

Coefficients past the baseline ranges (a DC difference of 11 bits, an AC
value of 10) are refused with ValueError.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

#: Annex K.1 quantisation tables, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] +
    [99] * 32)

#: Annex K.3 Huffman tables: (code counts of lengths 1-16, symbols)
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _codes(table) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical Huffman codes of a table: (code, length) by symbol."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_quality_scaling`` of the Annex K tables, baseline
    (each entry 1-255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.uint16)
                 for t in (LUMA_Q, CHROMA_Q))


def _dct_matrix() -> np.ndarray:
    a = np.zeros((8, 8))
    for u in range(8):
        for x in range(8):
            cu = math.sqrt(0.5) if u == 0 else 1.0
            a[u, x] = 0.5 * cu * math.cos((2 * x + 1) * u * math.pi / 16)
    return a


def grids(width: int, height: int, samp: Sequence[Tuple[int, int]]):
    """Each component's padded block grid (blocks_h, blocks_w) and real
    size (ch, cw), as T.81 A.1.1 has them."""
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    return ([(mcuy * v, mcux * h) for h, v in samp],
            [(-(-height * v // vmax), -(-width * h // hmax)) for h, v in samp])


def coefficients(rgb: np.ndarray, quality: int,
                 samp: Sequence[Tuple[int, int]], colour: str = "ycbcr"):
    """(H, W, 3) u8 RGB -> (quantised planes, tables, the tables'
    selectors): YCbCr (BT.601, full range; R, G and B as they are with
    ``colour="rgb"``; with ``colour="raw"``, (H, W, N) u8 of any N
    channels, each a component as it is), component c box-filtered to
    ``samp[c]`` of the largest factors (a fractional ratio takes the
    nearest sample; its real size edge-replicated to its padded grid),
    level-shifted, 8x8 forward DCT, quantised (rounded half away from
    zero). Component 0 takes the luminance table."""
    h, w = rgb.shape[:2]
    f = rgb.astype(np.float64)
    if colour == "raw":
        planes = [f[..., c] for c in range(f.shape[2])]
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        planes = [r, g, b] if colour == "rgb" else [
            0.299 * r + 0.587 * g + 0.114 * b,
            -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
            0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    tabs = quality_tables(quality)
    blocks, real = grids(w, h, samp)
    dct = _dct_matrix()
    out = []
    for c, ((sh, sv), (bh, bw)) in enumerate(zip(samp, blocks)):
        p = planes[c]
        if vmax % sv or hmax % sh:  # a fractional ratio: the nearest sample
            ch, cw = real[c]
            rows = ((np.arange(ch) + 0.5) * vmax / sv).astype(int)
            cols = ((np.arange(cw) + 0.5) * hmax / sh).astype(int)
            p = p[rows.clip(0, h - 1)][:, cols.clip(0, w - 1)]
        else:  # pad to whole factor cells, then average each cell
            fy, fx = vmax // sv, hmax // sh
            p = np.pad(p, ((0, -h % fy), (0, -w % fx)), mode="edge")
            p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx,
                          fx).mean((1, 3))
        p = np.pad(p, ((0, bh * 8 - p.shape[0]), (0, bw * 8 - p.shape[1])),
                   mode="edge") - 128.0
        blk = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        co = dct @ blk @ dct.T
        q = tabs[0 if c == 0 else 1].reshape(8, 8)
        lev = np.sign(co) * np.floor(np.abs(co) / q + 0.5)
        out.append(lev.reshape(bh, bw, 64).astype(np.int16))
    return out, tabs, [0] + [1] * (len(samp) - 1)


def _category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (T.81 F.1.2.1's SSSS)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _scan_units(grid_blocks, real_blocks, comps, samp):
    """(component, by, bx, mcu index) of every block of one scan, in
    coding order."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = real_blocks[c]
        by, bx = np.divmod(np.arange(rows * cols), cols)
        return (np.full(by.size, c), by, bx, np.arange(by.size))
    mcuy = grid_blocks[0][0] // samp[0][1]
    mcux = grid_blocks[0][1] // samp[0][0]
    parts = []
    for c in comps:
        sh, sv = samp[c]
        my, mx, v, h = np.meshgrid(np.arange(mcuy), np.arange(mcux),
                                   np.arange(sv), np.arange(sh),
                                   indexing="ij")
        parts.append((np.full(my.size, c), (my * sv + v).ravel(),
                      (mx * sh + h).ravel(), (my * mcux + mx).ravel()))
    # order: MCU, then component in scan order, then the component's
    # blocks row by row
    comp = np.concatenate([p[0] for p in parts])
    by = np.concatenate([p[1] for p in parts])
    bx = np.concatenate([p[2] for p in parts])
    mcu = np.concatenate([p[3] for p in parts])
    rank = np.concatenate([np.full(p[0].size, i) for i, p in enumerate(parts)])
    within = np.concatenate([np.arange(p[0].size) % (samp[c][0] * samp[c][1])
                             for p, c in zip(parts, comps)])
    order = np.lexsort((within, rank, mcu))
    return comp[order], by[order], bx[order], mcu[order]


def _scan_bytes(planes, comp, by, bx, mcu, tables, restart: int) -> bytes:
    """Entropy-coded data of one scan, restart markers included."""
    n = comp.size
    zz = np.empty((n, 64), np.int64)
    for c in np.unique(comp):
        sel = comp == c
        zz[sel] = planes[c][by[sel], bx[sel]][:, ZIGZAG]
    interval = mcu // restart if restart else np.zeros(n, np.int64)
    # DC differences, the prediction reset at each interval
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        dc = zz[idx, 0]
        prev = np.concatenate([[0], dc[:-1]])
        ivl = interval[idx]
        first = np.concatenate([[True], ivl[1:] != ivl[:-1]])
        diff[idx] = dc - np.where(first, 0, prev)
    if np.abs(diff).max(initial=0) >= 2048:
        raise ValueError("a DC difference past 11 bits")
    ac = zz[:, 1:]
    if np.abs(ac).max(initial=0) >= 1024:
        raise ValueError("an AC value past 10 bits")
    dc_code, dc_len, ac_code, ac_len = (np.stack(t) for t in zip(*tables))
    tab = np.where(comp == 0, 0, 1)  # luminance tables for component 0
    keys, vals, nbits = [], [], []

    def emit(key, code, clen, extra, elen):
        keys.append(key)
        vals.append((code << elen) | (extra & ((1 << elen) - 1)))
        nbits.append(clen + elen)

    seq = np.arange(n)
    s = _category(diff)
    emit(seq * 256, dc_code[tab, s], dc_len[tab, s],
         np.where(diff < 0, diff - 1, diff), s)
    blk, pos = np.nonzero(ac)
    v = ac[blk, pos]
    prev = np.concatenate([[-1], pos[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = -1
    run = pos - prev - 1
    zrl = run // 16
    if zrl.any():  # 16 zeros a ZRL (0xF0) before the value
        zb = np.repeat(np.arange(blk.size), zrl)
        t = tab[blk[zb]]
        emit(blk[zb] * 256 + 2 * pos[zb] + 1, ac_code[t, 0xF0],
             ac_len[t, 0xF0], np.zeros(zb.size, np.int64),
             np.zeros(zb.size, np.int64))
    s = _category(v)
    sym = (run % 16) * 16 + s
    t = tab[blk]
    emit(blk * 256 + 2 * pos + 2, ac_code[t, sym], ac_len[t, sym],
         np.where(v < 0, v - 1, v), s)
    last = np.full(n, -1)
    last[blk] = pos  # the last value of each block (pos ascends in a block)
    eob = np.nonzero(last < 62)[0]
    t = tab[eob]
    emit(eob * 256 + 200, ac_code[t, 0], ac_len[t, 0],
         np.zeros(eob.size, np.int64), np.zeros(eob.size, np.int64))
    key = np.concatenate(keys)
    val = np.concatenate(vals)
    nb = np.concatenate(nbits)
    # each interval padded with 1-bits to a byte
    ivl = interval[key // 256]
    bits_in = np.bincount(ivl, weights=nb).astype(np.int64)
    pad = -bits_in % 8
    ends = np.array([np.nonzero(interval == i)[0].max()
                     for i in range(bits_in.size)])
    key = np.concatenate([key, ends * 256 + 255])
    val = np.concatenate([val, (1 << pad) - 1])
    nb = np.concatenate([nb, pad])
    order = np.argsort(key, kind="stable")
    val, nb = val[order], nb[order]
    total = int(nb.sum())
    start = np.cumsum(nb) - nb
    rep = np.repeat(np.arange(nb.size), nb)
    shift = nb[rep] - 1 - (np.arange(total) - start[rep])
    bits = ((val[rep] >> shift) & 1).astype(np.uint8)
    packed = np.packbits(bits)
    cuts = np.cumsum((bits_in + pad) // 8)[:-1]
    out = bytearray()
    for i, part in enumerate(np.split(packed, cuts)):
        if i:
            out += bytes((0xFF, 0xD0 + (i - 1) % 8))
        ff = np.nonzero(part == 0xFF)[0]
        out += np.insert(part, ff + 1, 0).tobytes()
    return bytes(out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + (len(body) + 2).to_bytes(2, "big") + body


def _dht(tc: int, th: int, table) -> bytes:
    counts, symbols = table
    return bytes([(tc << 4) | th, *counts]) + bytes(symbols)


def write(planes, qtabs, width: int, height: int,
          samp: Sequence[Tuple[int, int]], tq: Optional[Sequence[int]] = None,
          interleaved: bool = True, restart: int = 0,
          adobe_transform: Optional[int] = None,
          ids: Optional[Sequence[int]] = None) -> bytes:
    """A baseline JPEG (SOF0) of 1, 3 or 4 components: ``planes[c]`` the
    quantised coefficients of component c on its padded grid
    (:func:`grids`), ``qtabs`` 64-entry tables in natural order, ``tq[c]``
    component c's table (0, then 1, by default), ``samp[c]`` its (h, v)
    factors (1-4). One scan of every component in MCU order, or one scan
    a component; ``restart`` MCUs (a component scan's blocks) a restart
    interval; ``adobe_transform`` writes an Adobe APP14 segment with that
    flag; ``ids`` are the component ids (1, 2, ... by default)."""
    ncomp = len(planes)
    ids = list(ids) if ids is not None else [c + 1 for c in range(ncomp)]
    tq = list(tq) if tq is not None else [0] + [1] * (ncomp - 1)
    blocks, real = grids(width, height, samp)
    for p, (bh, bw) in zip(planes, blocks):
        if p.shape != (bh, bw, 64):
            raise ValueError(f"a plane of {p.shape[:2]} blocks, not "
                             f"{(bh, bw)}")
    real_blocks = [(-(-ch // 8), -(-cw // 8)) for ch, cw in real]
    out = bytearray(b"\xff\xd8")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                adobe_transform]))
    for t in sorted(set(tq)):
        q = np.asarray(qtabs[t]).astype(np.int64)[ZIGZAG]
        out += _segment(0xDB, bytes([t]) + bytes(q.clip(1, 255).tolist()))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([ncomp])
    for c, (h, v) in enumerate(samp):
        sof += bytes([ids[c], (h << 4) | v, tq[c]])
    out += _segment(0xC0, sof)
    out += _segment(0xC4, _dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA)
                    + _dht(0, 1, DC_CHROMA) + _dht(1, 1, AC_CHROMA))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    tables = [_codes(DC_LUMA) + _codes(AC_LUMA),
              _codes(DC_CHROMA) + _codes(AC_CHROMA)]
    scans = [list(range(ncomp))] if interleaved else [[c] for c in
                                                       range(ncomp)]
    planes = [np.asarray(p, np.int64) for p in planes]
    for comps in scans:
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([ids[c], 0x00 if c == 0 else 0x11])
        out += _segment(0xDA, sos + bytes([0, 63, 0]))
        out += _scan_bytes(planes, *_scan_units(blocks, real_blocks, comps,
                                                samp), tables, restart)
    return bytes(out + b"\xff\xd9")


def encode(rgb: np.ndarray, quality: int, samp: Sequence[Tuple[int, int]],
           interleaved: bool = True, restart: int = 0) -> bytes:
    """:func:`coefficients` of an RGB picture through :func:`write`."""
    planes, tabs, tq = coefficients(rgb, quality, samp)
    h, w = rgb.shape[:2]
    return write(planes, tabs, w, h, samp, tq, interleaved, restart)
