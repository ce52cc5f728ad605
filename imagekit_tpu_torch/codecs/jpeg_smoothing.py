"""libjpeg's block smoothing of a progressive JPEG whose scans stop early.

Where the scans of a progressive frame leave some of a component's first
nine AC coefficients unrefined (a file cut after its first scans, or a
script that never codes them), libjpeg-turbo estimates them before the
IDCT from the DC values of the 5x5 blocks around each block
(``jdcoefct.c``: ``smoothing_ok`` decides, ``decompress_smooth_data``
estimates). Where no AC coefficient of the nine has been coded at all, it
interpolates the DC too, with a Gaussian-like kernel. Pillow decodes with
it on (libjpeg's default ``do_block_smoothing``), so the port's pixel
decode runs it on the host, on the coefficient planes the entropy decode
returns, before K6 takes them.

Everything is integer, as in libjpeg: an estimate is
``((q << 7) + |num|) // (q << 8)`` with ``num``'s sign, ``num`` the
quantised DC values weighted by a kernel below and multiplied by the DC's
quantiser, ``q`` the estimated coefficient's quantiser; below ``1 << Al``
where the coefficient's last scan shifted it by ``Al`` > 0; written only
where the decoded coefficient is 0. Every estimate reads the planes' DC
values as decoded, never one already smoothed. A frame that is not
progressive, or whose scans refined every coefficient, is returned as
it is.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

#: libjpeg's ``SAVED_COEFS``: the DC and the first nine AC coefficients in
#: zigzag order, at these natural-order positions (``Q01_POS`` ...)
SAVED = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)


def _k(*rows) -> np.ndarray:
    """A 5x5 kernel over libjpeg's DC01 ... DC25: rows the block rows two
    above to two below, columns two to the left to two to the right."""
    return np.array(rows, np.int64)


_0 = (0, 0, 0, 0, 0)

#: zigzag index -> the kernel libjpeg weights the DC values with where the
#: component's scans coded none of the nine AC coefficients (its DC
#: interpolation, ``change_dc``); index 0 is the DC's own
DC_INTERPOLATION = {
    0: _k((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8),
          (-6, 6, 42, 6, -6), (-2, -6, -8, -6, -2)),
    1: _k((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
          (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1)),
    2: _k((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), _0,
          (1, -13, -38, -13, 1), (1, 3, 3, 3, 1)),
    3: _k((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
          (0, 2, 7, 2, 0), (0, 0, 1, 0, 0)),
    4: _k((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), _0, (0, -9, 0, 9, 0),
          (1, 0, 0, 0, -1)),
    5: _k(_0, (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0), _0),
    6: _k(_0, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0), _0),
    7: _k(_0, (0, 1, -3, 1, 0), _0, (0, -1, 3, -1, 0), _0),
    8: _k(_0, (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0), _0),
    9: _k(_0, (0, 1, 2, 1, 0), _0, (0, -1, -2, -1, 0), _0),
}

#: zigzag index -> the kernel of libjpeg's estimate where some of the nine
#: AC coefficients were coded (T.81 K.8 on a 5x5 window): the first five
#: only, the DC kept
AC_ESTIMATE = {
    1: _k(_0, _0, (-7, 50, 0, -50, 7), _0, _0),
    2: _k((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), _0, (0, 0, -50, 0, 0),
          (0, 0, 7, 0, 0)),
    3: _k((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
          (0, 0, 13, 0, 0), (0, 0, -1, 0, 0)),
    4: _k((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), _0, (1, -10, 0, 10, -1),
          (0, 1, 0, -1, 0)),
    5: _k(_0, _0, (-1, 13, -24, 13, -1), _0, _0),
}

# a marker after entropy-coded data: 0xFF (fill bytes too) and a code that
# is neither a stuffed zero nor a restart
_MARKER = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")


def scan_bits(data: bytes, ids: Sequence[int]) -> np.ndarray:
    """libjpeg's ``coef_bits`` of the first ten zigzag coefficients after
    every scan of ``data``: (components, 10) int, -1 where no scan coded
    the coefficient, else the point transform Al of the last scan that
    did. ``ids`` are the frame's component ids in order; a scan's id that
    is not among them is skipped."""
    bits = np.full((len(ids), len(SAVED)), -1, np.int64)
    i, n = 2, len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            break
        m = data[i + 1]
        if m == 0xFF or m == 0x01 or 0xD0 <= m <= 0xD8:
            i += 1 if m == 0xFF else 2
            continue
        if m == 0xD9:
            break
        end = i + 2 + ((data[i + 2] << 8) | data[i + 3])
        if m == 0xDA:
            seg = data[i + 4:end]
            ns = seg[0] if seg else 0
            if len(seg) < 4 + 2 * ns:
                break
            ss, se, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] & 15
            for j in range(ns):
                if seg[1 + 2 * j] in ids:
                    c = list(ids).index(seg[1 + 2 * j])
                    bits[c, ss:min(se, len(SAVED) - 1) + 1] = al
            found = _MARKER.search(data, end)
            if found is None:
                break
            i = found.end() - 2
            continue
        i = end
    return bits


def smoothing_ok(hdr, qtabs, bits) -> bool:
    """``jdcoefct.c::smoothing_ok``: a progressive frame whose every
    component has its DC coded and nonzero quantisers at the ten
    positions, and some component with one of the nine AC coefficients
    not fully refined (its bits not 0). Bits of another component count
    than the header's turn it off."""
    if not hdr.progressive or len(bits) != hdr.ncomp:
        return False
    for c in range(hdr.ncomp):
        if bits[c, 0] < 0 or not qtabs[hdr.comp_tq[c]][list(SAVED)].all():
            return False
    return bool((bits[:, 1:] != 0).any())


def _rows(blocks: int, v: int, imcu_rows: int) -> np.ndarray:
    """(blocks, 5) block rows two above to two below each block row, as
    ``decompress_smooth_data`` takes them: the row itself past the image's
    first and last block rows; in the last iMCU row it numbers its rows as
    if every iMCU row held as few as that one, and libjpeg keeps that
    numbering (a small image's last rows then see their row above twice).
    Rows below the last real one (an MCU's padding) are read as decoded."""
    out = np.empty((blocks, 5), np.int64)
    last = blocks % v or v
    for r in range(blocks):
        m, br = divmod(r, v)
        at, count = ((r, v * imcu_rows) if m < imcu_rows - 1
                     else (m * last + br, last * imcu_rows))
        prev = r - 1 if at > 0 else r
        nxt = r + 1 if at < count - 1 else r
        out[r] = (r - 2 if at > 1 else prev, prev, r, nxt,
                  r + 2 if at < count - 2 else nxt)
    return out


def _estimate(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """libjpeg's rounded division of ``num`` by ``q << 8``, its magnitude
    below ``1 << al`` where ``al`` > 0."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num >= 0, pred, -pred)


def smooth_blocks(hdr, coeffs: List[np.ndarray], qtabs: np.ndarray,
                  bits: np.ndarray) -> List[np.ndarray]:
    """``decompress_smooth_data`` on a frame's (blocks_h, blocks_w, 64) i16
    planes (natural order, ``jpeg_abi.decode`` / ``decode4``'s), ``bits``
    :func:`scan_bits`' of its data: new planes where :func:`smoothing_ok`,
    else ``coeffs`` as they are. Only the blocks of each component's real
    size change."""
    if not smoothing_ok(hdr, qtabs, bits):
        return coeffs
    imcu_rows = -(-hdr.height // (hdr.vmax * 8))
    out = []
    for c, plane in enumerate(coeffs):
        hb = -(-hdr.comp_height[c] // 8)
        wb = -(-hdr.comp_width[c] // 8)
        rows = _rows(hb, hdr.comp_v[c], imcu_rows)
        cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
        dc = np.zeros((max(plane.shape[0], int(rows.max()) + 1), wb),
                      np.int64)
        dc[:plane.shape[0]] = plane[:, :wb, 0]
        # (hb, wb, 5, 5): DC01 ... DC25 around each block
        around = dc[rows[:, None, :, None], cols[None, :, None, :]]
        q = qtabs[hdr.comp_tq[c]].astype(np.int64)
        cb = bits[c]
        interpolate = bool((cb[1:] == -1).all())
        kernels = DC_INTERPOLATION if interpolate else AC_ESTIMATE
        block = plane[:hb, :wb].astype(np.int64)
        new = block.copy()
        for k, kernel in kernels.items():
            pos = SAVED[k]
            num = q[0] * np.einsum("hwab,ab->hw", around, kernel)
            if k == 0:
                new[..., 0] = _estimate(num, int(q[0]), 0)
            elif cb[k] != 0:
                new[..., pos] = np.where(block[..., pos] == 0,
                                         _estimate(num, int(q[pos]),
                                                   int(cb[k])),
                                         block[..., pos])
        smoothed = plane.copy()
        smoothed[:hb, :wb] = new.astype(np.int16)
        out.append(smoothed)
    return out
