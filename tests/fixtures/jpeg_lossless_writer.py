"""A lossless JPEG writer in numpy (T.81 Annex H, Huffman coded, SOF3),
for fixtures no encoder here writes: 8-bit samples of 1, 3 or 4
components at any sampling factors 1-4, predictors 1-7 (Table H.1), a
point transform Pt, restart intervals of whole MCU rows, and one
interleaved scan or one scan a component.

Each component's samples are predicted from their left, upper and
upper-left neighbours on the component's own grid (the first row of the
scan and of each restart interval from the left one, its first sample
from 2^(P - Pt - 1); the first column from the upper one), the
differences coded as a DC difference is (category, then its bits) with
the Annex K DC tables: component 0 on the luminance one, the others on
the chrominance one. An interleaved scan runs over whole MCUs, so a
component's grid is padded (by its edge samples) to whole MCUs; a
component's own scan runs over its real size. ``chip_smoke.py`` loads
this module by its path (numpy only).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np


def _sibling(name: str):
    """A module beside this one, loaded by its path."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


jw = _sibling("jpeg_writer")


def component_sizes(width: int, height: int,
                    samp: Sequence[Tuple[int, int]]):
    """(rows, columns) of each component's samples (T.81 A.1.1)."""
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    return [(-(-height * v // vmax), -(-width * h // hmax)) for h, v in samp]


def subsample(img: np.ndarray, samp: Sequence[Tuple[int, int]]):
    """The sample planes of an (H, W) or (H, W, C) u8 picture at
    ``samp``: component c is channel c, averaged over each cell of the
    largest factors over its own (the mean rounded half up; the nearest
    sample where the ratio is not an integer)."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w = img.shape[:2]
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    out = []
    for c, ((sh, sv), (ch, cw)) in enumerate(
            zip(samp, component_sizes(w, h, samp))):
        if vmax % sv or hmax % sh:  # a fractional ratio: the nearest
            rows = ((np.arange(ch) + 0.5) * vmax / sv).astype(int)
            cols = ((np.arange(cw) + 0.5) * hmax / sh).astype(int)
            out.append(img[rows.clip(0, h - 1)][:, cols.clip(0, w - 1), c])
            continue
        fy, fx = vmax // sv, hmax // sh
        p = np.pad(img[:, :, c].astype(np.int64),
                   ((0, ch * fy - h), (0, cw * fx - w)), mode="edge")
        p = p.reshape(ch, fy, cw, fx).sum((1, 3))
        out.append(((p + fy * fx // 2) // (fy * fx)).astype(np.uint8))
    return out


def _predict(x: np.ndarray, predictor: int, pt: int,
             rows_a_interval: int) -> np.ndarray:
    """Table H.1's prediction of every sample of ``x`` (reduced
    precision), with H.1.2.1's rules at the first row of each interval
    and the first column."""
    x = x.astype(np.int64)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {
        1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
        5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
        7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    first = (np.arange(x.shape[0]) % rows_a_interval) == 0
    pred[first, 1:] = ra[first, 1:]
    pred[first, 0] = 1 << (8 - pt - 1)
    return pred


def _pack(val: np.ndarray, nb: np.ndarray, interval: np.ndarray) -> bytes:
    """Bits in coding order into bytes: each restart interval padded with
    1-bits to a byte, RSTn between intervals, 0xFF stuffed."""
    n_int = int(interval.max()) + 1 if interval.size else 1
    out = bytearray()
    for i in range(n_int):
        sel = interval == i
        v, b = val[sel], nb[sel]
        pad = -int(b.sum()) % 8
        v = np.concatenate([v, [(1 << pad) - 1]])
        b = np.concatenate([b, [pad]])
        total = int(b.sum())
        start = np.cumsum(b) - b
        rep = np.repeat(np.arange(b.size), b)
        shift = b[rep] - 1 - (np.arange(total) - start[rep])
        packed = np.packbits(((v[rep] >> shift) & 1).astype(np.uint8))
        if i:
            out += bytes((0xFF, 0xD0 + (i - 1) % 8))
        ff = np.nonzero(packed == 0xFF)[0]
        out += np.insert(packed, ff + 1, 0).tobytes()
    return bytes(out)


def write(planes, width: int, height: int, samp: Sequence[Tuple[int, int]],
          *, predictor: int = 1, pt: int = 0, restart: int = 0,
          interleaved: bool = True, jfif: bool = False,
          adobe_transform: Optional[int] = None) -> bytes:
    """A lossless JPEG (SOF3, 8-bit) of ``planes[c]``, component c's u8
    samples at :func:`component_sizes`, sampled ``samp[c]``. Coded at
    ``planes >> pt``, so a decoder returns ``(planes >> pt) << pt``.
    ``restart`` MCUs an interval, a whole number of MCU rows (one sample a
    MCU in a component's own scan). ``jfif`` writes a JFIF APP0,
    ``adobe_transform`` an Adobe APP14 segment with that flag."""
    ncomp = len(planes)
    sizes = component_sizes(width, height, samp)
    for p, s in zip(planes, sizes):
        if p.shape != s:
            raise ValueError(f"a plane of {p.shape}, not {s}")
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    codes = [jw._codes(jw.DC_LUMA), jw._codes(jw.DC_CHROMA)]
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += jw._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += jw._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                   adobe_transform]))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([ncomp])
    for c, (h, v) in enumerate(samp):
        sof += bytes([c + 1, (h << 4) | v, 0])
    out += jw._segment(0xC3, sof)
    out += jw._segment(0xC4, jw._dht(0, 0, jw.DC_LUMA)
                       + jw._dht(0, 1, jw.DC_CHROMA))
    if restart:
        out += jw._segment(0xDD, restart.to_bytes(2, "big"))
    scans = [list(range(ncomp))] if interleaved else [[c] for c in
                                                       range(ncomp)]
    for comps in scans:
        one = len(comps) == 1
        per_row = sizes[comps[0]][1] if one else -(-width // hmax)
        if restart and restart % per_row:
            raise ValueError(f"a restart interval of {restart} MCUs is not "
                             f"whole rows of {per_row}")
        mcu_rows = sizes[comps[0]][0] if one else -(-height // vmax)
        vals, nbits, mcu_of, order = [], [], [], []
        for rank, c in enumerate(comps):
            sh, sv = (1, 1) if one else samp[c]
            rows, cols = mcu_rows * sv, per_row * sh
            x = np.pad(planes[c] >> pt, ((0, rows - sizes[c][0]),
                                         (0, cols - sizes[c][1])),
                       mode="edge").astype(np.int64)
            rows_int = (restart // per_row) * sv if restart else rows
            diff = x - _predict(x, predictor, pt, rows_int)
            cat = np.frexp(np.abs(diff).astype(np.float64))[1].astype(
                np.int64)
            code, clen = codes[0 if c == 0 else 1][:2]
            extra = np.where(diff < 0, diff - 1, diff) & ((1 << cat) - 1)
            vals.append((code[cat] << cat) | extra)
            nbits.append(clen[cat] + cat)
            y, xx = np.divmod(np.arange(rows * cols), cols)
            mcu = (y // sv) * per_row + xx // sh
            mcu_of.append(mcu)
            # coding order: the MCU, the component, its samples row by row
            order.append(mcu * 64 * 16 + rank * 16 + (y % sv) * sh + xx % sh)
        key = np.concatenate(order)
        srt = np.argsort(key, kind="stable")
        val = np.concatenate([v.ravel() for v in vals])[srt]
        nb = np.concatenate([b.ravel() for b in nbits])[srt]
        mcu = np.concatenate(mcu_of)[srt]
        interval = mcu // restart if restart else np.zeros_like(mcu)
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([c + 1, (0 if c == 0 else 1) << 4])
        out += jw._segment(0xDA, sos + bytes([predictor, 0, pt]))
        out += _pack(val, nb, interval)
    return bytes(out + b"\xff\xd9")
