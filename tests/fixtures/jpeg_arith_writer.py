"""An arithmetic-coded JPEG writer in numpy and plain Python, for fixtures
no encoder here writes: sequential (SOF9) and progressive (SOF10) DCT
frames of 1, 3 or 4 components, with successive approximation, DAC
segments of any L, U and K, and restart intervals.

It takes the coefficient planes :func:`jpeg_writer.write` takes
(``(blocks_h, blocks_w, 64)`` int16 a component, natural order, on the
grid padded to whole MCUs) and codes them with the QM coder of T.81 Annex
D and the statistics of F.1.4 and G.1.3, decision for decision as
libjpeg's ``jcarith.c`` does (its termination and its handling of carries
and of stacked 0xFF bytes included), so that libjpeg decodes the file to
those planes. ``chip_smoke.py`` loads it by its path (numpy only).

The coder runs in two steps: the decisions of a scan are listed first
(statistics bin and value, one int each), then one loop codes them: about
half a microsecond a decision, listing included a little under two. A
smooth 1080p 4:2:0 picture at q50 has about 370,000 decisions; noise and
higher qualities many more.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _sibling(name: str):
    """A module beside this one, loaded by its path (the card's machine
    runs this file outside the test package)."""
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

#: T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1),
    # the fixed estimate of 0.5 (T.851 10.3) of sign and refinement bits
    (0x5A1D, 113, 113, 0),
)
FIXED_STATE = 113

# statistics areas: 16 DC tables of 64 bins, 16 AC tables of 256, the
# fixed bin last
_DC0, _AC0 = 0, 16 * 64
_FIXED = _AC0 + 16 * 256
_NBINS = _FIXED + 1

#: libjpeg's defaults of a DAC-less frame: (L, U) a DC table, K an AC one
DEFAULT_DC = (0, 1)
DEFAULT_AC = 5


def _qm_code(tokens: List[int]) -> bytes:
    """Code one scan's decisions: ``bin << 1 | value``; a negative token
    ``-1 - n`` ends a restart interval with RSTn. jcarith.c's
    ``arith_encode``, ``finish_pass`` and ``emit_restart``."""
    qe_of = [t[0] for t in QE_TABLE]
    nmps = [t[2] for t in QE_TABLE]
    nlps = [t[1] | (t[3] << 7) for t in QE_TABLE]
    out = bytearray()
    emit = out.append

    def fresh():
        st = bytearray(_NBINS)
        st[_FIXED] = FIXED_STATE
        return st

    def flush(c, a, sc, zc, ct, buffer):
        # T.81 D.1.8, as finish_pass: the value of the interval with the
        # most trailing zero bits, then the bytes still held
        temp = (a - 1 + c) & 0xFFFF0000
        c = temp + 0x8000 if temp < c else temp
        c <<= ct
        if c & 0xF8000000:
            if buffer >= 0:
                out.extend(b"\x00" * zc)
                zc = 0
                emit(buffer + 1)
                if buffer + 1 == 0xFF:
                    emit(0)
            zc += sc
            sc = 0
        else:
            if buffer == 0:
                zc += 1
            elif buffer >= 0:
                out.extend(b"\x00" * zc)
                zc = 0
                emit(buffer)
            if sc:
                out.extend(b"\x00" * zc)
                zc = 0
                out.extend(b"\xff\x00" * sc)
                sc = 0
        if c & 0x7FFF800:
            out.extend(b"\x00" * zc)
            b1 = (c >> 19) & 0xFF
            emit(b1)
            if b1 == 0xFF:
                emit(0)
            if c & 0x7F800:
                b2 = (c >> 11) & 0xFF
                emit(b2)
                if b2 == 0xFF:
                    emit(0)

    st = fresh()
    c, a, sc, zc, ct, buffer = 0, 0x10000, 0, 0, 11, -1
    for tok in tokens:
        if tok < 0:
            flush(c, a, sc, zc, ct, buffer)
            out.extend((0xFF, 0xD0 + (-1 - tok) % 8))
            st = fresh()
            c, a, sc, zc, ct, buffer = 0, 0x10000, 0, 0, 11, -1
            continue
        b = tok >> 1
        sv = st[b]
        i = sv & 0x7F
        qe = qe_of[i]
        a -= qe
        if (tok & 1) != (sv >> 7):  # the less probable symbol
            if a >= qe:
                c += a
                a = qe
            st[b] = (sv & 0x80) ^ nlps[i]
        else:
            if a >= 0x8000:
                continue
            if a < qe:
                c += a
                a = qe
            st[b] = (sv & 0x80) ^ nmps[i]
        while True:  # renormalise, T.81 D.1.6, a byte out every 8 shifts
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:  # a carry into every stacked 0xFF
                    if buffer >= 0:
                        if zc:
                            out.extend(b"\x00" * zc)
                            zc = 0
                        emit(buffer + 1)
                        if buffer + 1 == 0xFF:
                            emit(0)
                    zc += sc
                    sc = 0
                    buffer = temp & 0xFF
                elif temp == 0xFF:
                    sc += 1
                else:
                    if buffer == 0:
                        zc += 1
                    elif buffer >= 0:
                        if zc:
                            out.extend(b"\x00" * zc)
                            zc = 0
                        emit(buffer)
                    if sc:
                        if zc:
                            out.extend(b"\x00" * zc)
                            zc = 0
                        out.extend(b"\xff\x00" * sc)
                        sc = 0
                    buffer = temp & 0xFF
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
    flush(c, a, sc, zc, ct, buffer)
    return bytes(out)


def _dc_decisions(out: list, diff: int, tbl: int, ctx: int,
                  lu: Tuple[int, int]) -> int:
    """The decisions of one DC difference (T.81 F.1.4.1, jcarith.c): its
    statistics from the component's context; the new context."""
    base = _DC0 + 64 * tbl
    st = base + ctx
    if diff == 0:
        out.append(st << 1)
        return 0
    out.append(st << 1 | 1)
    if diff > 0:
        out.append((st + 1) << 1)
        st += 2
        ctx = 4
    else:
        diff = -diff
        out.append((st + 1) << 1 | 1)
        st += 3
        ctx = 8
    v = diff - 1
    m = 0
    if v:
        out.append(st << 1 | 1)
        m = 1
        st = base + 20
        v2 = v >> 1
        while v2:
            out.append(st << 1 | 1)
            m <<= 1
            st += 1
            v2 >>= 1
    out.append(st << 1)
    lo, hi = lu
    if m < (1 << lo) >> 1:
        ctx = 0
    elif m > (1 << hi) >> 1:
        ctx += 8
    st += 14
    m >>= 1
    while m:
        out.append(st << 1 | (1 if v & m else 0))
        m >>= 1
    return ctx


def _ac_value(out: list, st: int, v: int, k: int, tbl: int, kx: int):
    """The sign, magnitude category and bits of one AC value (F.1.4.4.2)
    after its nonzero decision; ``st`` is its SE bin (3 * (k - 1))."""
    if v > 0:
        out.append(_FIXED << 1)
    else:
        v = -v
        out.append(_FIXED << 1 | 1)
    st += 2
    v -= 1
    m = 0
    if v:
        out.append(st << 1 | 1)
        m = 1
        v2 = v >> 1
        if v2:
            out.append(st << 1 | 1)
            m <<= 1
            st = _AC0 + 256 * tbl + (189 if k <= kx else 217)
            v2 >>= 1
            while v2:
                out.append(st << 1 | 1)
                m <<= 1
                st += 1
                v2 >>= 1
    out.append(st << 1)
    st += 14
    m >>= 1
    while m:
        out.append(st << 1 | (1 if v & m else 0))
        m >>= 1


def _shifted(v: int, al: int) -> int:
    """The point transform of an AC value: |v| >> Al with its sign."""
    return (v >> al) if v >= 0 else -((-v) >> al)


def _ac_first(out: list, zz, ss: int, se: int, al: int, tbl: int,
              kx: int) -> None:
    """An AC band's decisions, sequential (1..63, Al 0) or a progressive
    first scan (F.1.4.2, G.1.3.2; jcarith.c ``encode_mcu_AC_first``)."""
    vals = zz if al == 0 else [_shifted(v, al) for v in zz]
    ke = se
    while ke >= ss and vals[ke] == 0:
        ke -= 1
    base = _AC0 + 256 * tbl
    k = ss
    while k <= ke:
        st = base + 3 * (k - 1)
        out.append(st << 1)  # not the end of the block
        while vals[k] == 0:
            out.append((st + 1) << 1)
            st += 3
            k += 1
        out.append((st + 1) << 1 | 1)
        _ac_value(out, st, vals[k], k, tbl, kx)
        k += 1
    if k <= se:
        out.append((base + 3 * (k - 1)) << 1 | 1)  # end of block


def _ac_refine(out: list, zz, ss: int, se: int, ah: int, al: int,
               tbl: int) -> None:
    """A band's refinement decisions (G.1.3.3; jcarith.c
    ``encode_mcu_AC_refine``): one bit more of each value already nonzero,
    the new values of +-1 among the others, and the end of the block past
    the previous stage's last nonzero value."""
    absv = [abs(v) for v in zz]
    ke = se
    while ke >= ss and absv[ke] >> al == 0:
        ke -= 1
    kex = ke
    while kex >= ss and absv[kex] >> ah == 0:
        kex -= 1
    base = _AC0 + 256 * tbl
    k = ss
    while k <= ke:
        st = base + 3 * (k - 1)
        if k > kex:
            out.append(st << 1)
        while True:
            v = absv[k] >> al
            if v:
                if v >> 1:  # previously nonzero: its next bit
                    out.append((st + 2) << 1 | (v & 1))
                else:
                    out.append((st + 1) << 1 | 1)
                    out.append(_FIXED << 1 | (1 if zz[k] < 0 else 0))
                break
            out.append((st + 1) << 1)
            st += 3
            k += 1
        k += 1
    if k <= se:
        out.append((base + 3 * (k - 1)) << 1 | 1)


#: libjpeg's ``jpeg_simple_progression`` for 3 components (YCbCr), as
#: (components, Ss, Se, Ah, Al): spectral selection and successive
#: approximation
SIMPLE_PROGRESSION_3 = (
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0),
)


def simple_progression(ncomp: int):
    """A progressive script with spectral selection and successive
    approximation for ``ncomp`` components: libjpeg's for three, the same
    shape (DC in two steps, AC in a first and two refinement steps) for
    one and four."""
    if ncomp == 3:
        return SIMPLE_PROGRESSION_3
    comps = tuple(range(ncomp))
    script = [(comps, 0, 0, 0, 1)]
    script += [((c,), 1, 5, 0, 2) for c in comps]
    script += [((c,), 6, 63, 0, 2) for c in comps]
    script += [((c,), 1, 63, 2, 1) for c in comps]
    script.append((comps, 0, 0, 1, 0))
    script += [((c,), 1, 63, 1, 0) for c in comps]
    return tuple(script)


def _scan_decisions(planes, units, comps, scan, restart: int, dac_dc,
                    dac_ac, tables) -> List[int]:
    """The decisions of one scan over its blocks in coding order
    (``jpeg_writer._scan_units``), restart tokens included."""
    _, ss, se, ah, al = scan
    comp, by, bx, mcu = units
    out: List[int] = []
    last = {c: 0 for c in comps}
    ctx = {c: 0 for c in comps}
    interval = -1
    zz_of = {c: planes[c][:, :, jw.ZIGZAG].tolist() for c in comps}
    comp_l, by_l, bx_l, mcu_l = (a.tolist() for a in (comp, by, bx, mcu))
    for c, y, x, m in zip(comp_l, by_l, bx_l, mcu_l):
        if restart:
            ivl = m // restart
            if ivl != interval:
                if interval >= 0:
                    out.append(-1 - interval)
                    last = {c2: 0 for c2 in comps}
                    ctx = {c2: 0 for c2 in comps}
                interval = ivl
        zz = zz_of[c][y][x]
        dtab, atab = tables[c]
        if ss == 0:
            dc = zz[0]
            if ah == 0:
                v = dc >> al
                ctx[c] = _dc_decisions(out, v - last[c], dtab, ctx[c],
                                       dac_dc[dtab])
                last[c] = v
            else:
                out.append(_FIXED << 1 | ((dc >> al) & 1))
            if se == 0:
                continue
            ss_ac = 1
        else:
            ss_ac = ss
        if ah == 0:
            _ac_first(out, zz, ss_ac, se, al, atab, dac_ac[atab])
        else:
            _ac_refine(out, zz, ss_ac, se, ah, al, atab)
    return out


def _dac(dac_dc, dac_ac, used_dc, used_ac) -> bytes:
    body = b""
    for t in sorted(used_dc):
        lo, hi = dac_dc[t]
        body += bytes((t, (hi << 4) | lo))
    for t in sorted(used_ac):
        body += bytes((0x10 | t, dac_ac[t]))
    return jw._segment(0xCC, body)


def write(planes, qtabs, width: int, height: int,
          samp: Sequence[Tuple[int, int]], tq: Optional[Sequence[int]] = None,
          *, progressive=None, interleaved: bool = True, restart: int = 0,
          dac: Optional[dict] = None,
          adobe_transform: Optional[int] = None) -> bytes:
    """An arithmetic-coded JPEG of 1, 3 or 4 components from quantised
    coefficient planes, as :func:`jpeg_writer.write` takes them.

    ``progressive`` is None for a sequential frame (SOF9: one scan of every
    component in MCU order, or one scan a component), True for
    :func:`simple_progression`, or a script of (components, Ss, Se, Ah, Al)
    scans (SOF10). ``restart`` MCUs an interval (a one-component scan's
    blocks). ``dac`` maps ``("dc", t)`` to (L, U) and ``("ac", t)`` to K
    for the tables of component 0 (0) and the others (1); a frame with
    only libjpeg's defaults (0, 1 and 5) writes no DAC segment.
    ``adobe_transform`` writes an Adobe APP14 segment with that flag."""
    ncomp = len(planes)
    tq = list(tq) if tq is not None else [0] + [1] * (ncomp - 1)
    tables = [(0, 0)] + [(1, 1)] * (ncomp - 1)
    blocks, real = jw.grids(width, height, samp)
    for p, (bh, bw) in zip(planes, blocks):
        if p.shape != (bh, bw, 64):
            raise ValueError(f"a plane of {p.shape[:2]} blocks, not "
                             f"{(bh, bw)}")
    real_blocks = [(-(-ch // 8), -(-cw // 8)) for ch, cw in real]
    dac_dc = {t: DEFAULT_DC for t in range(16)}
    dac_ac = {t: DEFAULT_AC for t in range(16)}
    for (kind, t), value in (dac or {}).items():
        (dac_dc if kind == "dc" else dac_ac)[t] = value
    out = bytearray(b"\xff\xd8")
    if adobe_transform is not None:
        out += jw._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                   adobe_transform]))
    for t in sorted(set(tq)):
        q = np.asarray(qtabs[t]).astype(np.int64)[jw.ZIGZAG]
        out += jw._segment(0xDB, bytes([t]) + bytes(q.clip(1, 255).tolist()))
    if progressive is True:
        script = simple_progression(ncomp)
    elif progressive:
        script = tuple(progressive)
    else:
        comps = [tuple(range(ncomp))] if interleaved else [
            (c,) for c in range(ncomp)]
        script = tuple((cs, 0, 63, 0, 0) for cs in comps)
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([ncomp])
    for c, (h, v) in enumerate(samp):
        sof += bytes([c + 1, (h << 4) | v, tq[c]])
    out += jw._segment(0xCA if progressive else 0xC9, sof)
    if dac:
        out += _dac(dac_dc, dac_ac, {t for t, _ in tables},
                    {t for _, t in tables})
    if restart:
        out += jw._segment(0xDD, restart.to_bytes(2, "big"))
    planes = [np.asarray(p, np.int64) for p in planes]
    for scan in script:
        comps = scan[0]
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([c + 1, (tables[c][0] << 4) | tables[c][1]])
        _, ss, se, ah, al = scan
        out += jw._segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        units = jw._scan_units(blocks, real_blocks, list(comps), samp)
        out += _qm_code(_scan_decisions(planes, units, comps, scan, restart,
                                        dac_dc, dac_ac, tables))
    return bytes(out + b"\xff\xd9")

