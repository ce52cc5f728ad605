"""Write ``imagekit_tpu_torch/codecs/av1_dec_tables.npz``: the AV1 default
tables that an intra frame's decoder needs beyond the encoder's
``av1_tables.npz``.

The tables are the AV1 specification's constants. No copy of the
specification or of any codec's sources is at hand, so each table below
is written out as the specification gives it and then located, value for
value, in the system's four AV1 libraries, written independently of each
other: libaom (``libaom.so.3``), libdav1d, librav1e and SVT-AV1. A table
ships only when at least two of them hold every one of its records (one
record of ``cfl_alpha`` sits in libaom's image with two entries doubled,
and libdav1d keeps its small mode CDFs as code, so no single library is
required). CDFs are searched in the
libraries' own form, the inverse CDF (32768 - cdf) of each record's
first N - 1 entries; libaom keeps some small CDFs as code immediates, so
a record is looked for as a run of values, not as a whole table. The
decoder built on these tables is then held byte for byte against
libdav1d's planes (``tests/test_torch_av1_decode.py``): a wrong entry in
an adaptive CDF desynchronises the arithmetic decoder within a few
symbols.

What the file holds, each CDF as ``[inverse cdf of symbols 0..N-2, 0,
counter]`` (N + 1 entries, the layout of ``av1_tables.npz``):

- ``segment_id`` (3 contexts, 8 symbols), ``delta_q``, ``delta_lf``,
  ``delta_lf_multi`` (4), ``cfl_sign`` (8 symbols), ``cfl_alpha`` (6
  contexts, 16 symbols), ``pal_y_mode`` (7 x 3, 2 symbols),
  ``pal_uv_mode`` (2), ``filter_intra_mode`` (5 symbols),
  ``use_filter_intra`` (22 block sizes, 2 symbols: ``av1_tables.npz``'s
  ``filter_intra``, which the encoder never codes, is another table of
  libaom's image and not this one), the tx depth
  CDFs ``tx_8x8`` (3 contexts, 2 symbols) and ``tx_16x16``, ``tx_32x32``,
  ``tx_64x64`` (3 contexts, 3 symbols), ``switchable_restore`` (3
  symbols), ``wiener_restore`` and ``sgrproj_restore`` (2);
- the default scans of the rectangular transforms, ``scan_WxH`` (int16,
  row-major positions: a tall block's diagonals run down and to the left,
  a wide block's up and to the right);
- ``coeff_base_ctx_offset`` (19 transform sizes x 5 x 5, int8);
- ``filter_intra_taps`` (5 modes x 8 outputs x 7 taps, int8);
- ``sgr_params`` (16 x {r0, s0, r1, s1}, int32; s = -1 where r = 0);
- ``dr_intra_derivative`` (44, int16, indexed by angle >> 1).

Run from the repository root: ``python tests/fixtures/make_av1_dec_tables.py``.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "imagekit_tpu_torch", "codecs", "av1_dec_tables.npz")
LIBS = {
    "aom": "/lib/x86_64-linux-gnu/libaom.so.3",
    "dav1d": "/lib/x86_64-linux-gnu/libdav1d.so.6",
    "rav1e": "/lib/x86_64-linux-gnu/librav1e.so.0",
    "svt": "/lib/x86_64-linux-gnu/libSvtAv1Enc.so.1",
}

# The specification's CDFs (cdf form, the last entry 32768 left out).
CDFS = {
    "segment_id": [[5622, 7893, 16093, 18233, 27809, 28373, 32533],
                   [14274, 18230, 22557, 24935, 29980, 30851, 32344],
                   [27527, 28487, 28723, 28890, 32397, 32647, 32679]],
    "delta_q": [28160, 32120, 32677],
    "delta_lf": [28160, 32120, 32677],
    "delta_lf_multi": [[28160, 32120, 32677]] * 4,
    "cfl_sign": [1418, 2123, 13340, 18405, 26972, 28343, 32294],
    "cfl_alpha": [
        [7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704,
         32708, 32712, 32716, 32720, 32724],
        [14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620, 32647,
         32668, 32672, 32676, 32680, 32684],
        [11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673, 32677,
         32681, 32685, 32689, 32693, 32697],
        [26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708, 32712,
         32716, 32720, 32724, 32728, 32732],
        [17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394, 32464,
         32516, 32560, 32576, 32593, 32622],
        [14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144, 32413,
         32520, 32594, 32622, 32656, 32660]],
    "pal_y_mode": [[[31676], [3419], [1261]], [[31912], [2859], [980]],
                   [[31823], [3400], [781]], [[32030], [3561], [904]],
                   [[32309], [7337], [1462]], [[32265], [4015], [1521]],
                   [[32450], [7946], [129]]],
    "pal_uv_mode": [[32461], [21488]],
    "filter_intra_mode": [8949, 12776, 17211, 29558],
    "use_filter_intra": [[4621], [6743], [5893], [7866], [12551], [9394],
                         [12408], [14301], [12756], [22343], [16384],
                         [16384], [16384], [16384], [16384], [16384],
                         [12770], [10368], [20229], [18101], [16384],
                         [16384]],
    "tx_8x8": [[19968], [19968], [24320]],
    "tx_16x16": [[12272, 30172], [12272, 30172], [18677, 30848]],
    "tx_32x32": [[12986, 15180], [12986, 15180], [24302, 25602]],
    "tx_64x64": [[5782, 11475], [5782, 11475], [16803, 22759]],
    "switchable_restore": [9413, 22581],
    "wiener_restore": [11570],
    "sgrproj_restore": [16855],
}
# CDFs of two symbols are one value: a run of one u16 proves nothing, so
# these are searched as whole tables (value, 0 [, counter]) in the
# library that keeps them that way
WHOLE = {"pal_y_mode", "pal_uv_mode", "tx_8x8", "wiener_restore",
         "sgrproj_restore", "use_filter_intra"}

SGR_PARAMS = [[2, 140, 1, 3236], [2, 112, 1, 2158], [2, 93, 1, 1618],
              [2, 80, 1, 1438], [2, 70, 1, 1295], [2, 58, 1, 1177],
              [2, 47, 1, 1079], [2, 37, 1, 996], [2, 30, 1, 925],
              [2, 25, 1, 863], [0, -1, 1, 2589], [0, -1, 1, 1618],
              [0, -1, 1, 1177], [0, -1, 1, 925], [2, 56, 0, -1],
              [2, 22, 0, -1]]
DR_INTRA_DERIVATIVE = [0, 1023, 0, 547, 372, 0, 0, 273, 215, 0, 178, 151, 0,
                       132, 116, 0, 102, 0, 90, 80, 0, 71, 64, 0, 57, 51, 0,
                       45, 0, 40, 35, 0, 31, 27, 0, 23, 19, 0, 15, 0, 11, 0,
                       7, 3]
# mode 0 (FILTER_DC) of the recursive filter's taps: where libaom's
# table starts; the other four modes follow it there
FILTER_INTRA_ANCHOR = [[-6, 10, 0, 0, 0, 12, 0], [-5, 2, 10, 0, 0, 9, 0],
                       [-3, 1, 1, 10, 0, 7, 0], [-3, 1, 1, 2, 10, 5, 0],
                       [-4, 6, 0, 0, 0, 2, 12], [-3, 2, 6, 0, 0, 2, 9],
                       [-3, 2, 2, 6, 0, 2, 7], [-3, 1, 2, 2, 6, 3, 5]]
# (width, height) of the rectangular transforms
RECT = [(4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16), (4, 16),
        (16, 4), (8, 32), (32, 8)]
# the spec's transform sizes, in order (TX_4X4 .. TX_64X16)
TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
           (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16),
           (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]


def fail(msg: str) -> None:
    raise SystemExit(f"ABORT: {msg}")


def icdf_record(cdf) -> np.ndarray:
    """One record in the libraries' form: inverse CDF, 0, counter."""
    return np.array([32768 - v for v in cdf] + [0, 0], np.uint16)


def scan(w: int, h: int) -> np.ndarray:
    """The default scan of a w x h rectangle: its anti-diagonals, each
    from the top row down to the left for a tall block and from the left
    column up to the right for a wide one; positions are row * w + col."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if w > h:
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return np.array(out, np.int16)


def ctx_offset(w: int, h: int) -> np.ndarray:
    """Coeff_Base_Ctx_Offset of a w x h transform: its shape (square, wide
    or tall) picks the pattern, also where 64 sides read as 32."""
    out = np.zeros((5, 5), np.int8)
    for r in range(5):
        for c in range(5):
            if r == 0 and c == 0:
                v = 0
            elif w == h:
                v = 1 if r + c == 1 else 6 if r + c <= 3 else 21
            elif w > h and c <= 1:
                v = 16
            elif h > w and r <= 1:
                v = 11
            else:
                v = 6 if r + c <= 3 else 21
            out[r, c] = v
    return out


def ctx_offset_full(w: int, h: int) -> np.ndarray:
    """The offset of every position of the w x h transform's coefficients
    (row-major, 64 sides cut to 32), as libaom keeps it."""
    t = ctx_offset(w, h)
    aw, ah = min(w, 32), min(h, 32)
    return np.array([[t[min(r, 4), min(c, 4)] for c in range(aw)]
                     for r in range(ah)], np.int8).reshape(-1)


def main() -> int:
    img = {k: open(p, "rb").read() for k, p in LIBS.items()}
    out = {}
    for name, cdf in CDFS.items():
        recs = np.array(cdf, dtype=np.int64)
        flat = recs.reshape(-1, recs.shape[-1])
        if name in WHOLE:
            icdf = (32768 - flat).astype("<u2")
            forms = [np.concatenate([np.r_[r, np.zeros(k, "<u2")]
                                     for r in icdf]).astype("<u2").tobytes()
                     for k in (1, 2, 3)]
            where = sorted(k for k, b in img.items()
                           if any(f in b for f in forms))
        else:
            where = None
            for r in flat:
                run = (32768 - r).astype("<u2").tobytes()
                here = {k for k, b in img.items() if run in b}
                where = here if where is None else where & here
            where = sorted(where)
        if len(where) < 2:
            fail(f"{name}: found in {where} only")
        print(f"{name:20s} {flat.shape[0]:3d} records, found in {where}")
        shape = recs.shape[:-1] + (recs.shape[-1] + 2,)
        out[name] = np.stack([icdf_record(r) for r in flat]).reshape(shape)

    for w, h in RECT:
        s = scan(w, h)
        where = sorted(k for k, b in img.items()
                       if s.astype("<i2").tobytes() in b)
        if len(where) < 2:
            fail(f"scan {w}x{h}: found in {where} only")
        out[f"scan_{w}x{h}"] = s
        print(f"scan_{w}x{h:<13d} found in {where}")

    offs = []
    for w, h in TX_DIMS:
        if ctx_offset_full(w, h).astype("<i1").tobytes() not in img["aom"]:
            fail(f"coeff_base_ctx_offset {w}x{h}: not in libaom")
        offs.append(ctx_offset(w, h))
    out["coeff_base_ctx_offset"] = np.stack(offs)
    print("coeff_base_ctx_offset 19 sizes found in libaom")

    anchor = np.array([r + [0] for r in FILTER_INTRA_ANCHOR], "<i1").tobytes()
    at = img["aom"].find(anchor)
    if at < 0 or img["aom"].find(anchor, at + 1) >= 0:
        fail("filter intra taps: not found once in libaom")
    taps = np.frombuffer(img["aom"][at:at + 5 * 64], np.int8).reshape(5, 8, 8)
    if np.any(taps[:, :, 7]):
        fail("filter intra taps: libaom's padding column is not zero")
    taps = taps[:, :, :7].copy()
    # libdav1d keeps them as the pairs of taps each output takes
    dav = b"".join(
        np.stack([taps[m][:, j:j + 2] if j < 6 else
                  np.stack([taps[m][:, 6], np.zeros(8, np.int8)], 1)
                  for j in (0, 2, 4, 6)]).astype("<i1").tobytes()
        for m in range(5))
    dav_alt = b"".join(
        taps[m].T.astype("<i1").tobytes() for m in range(5))
    if dav not in img["dav1d"] and dav_alt not in img["dav1d"] \
            and not all(np.ascontiguousarray(taps[m]).tobytes()
                        in img["rav1e"] for m in range(5)):
        print("filter_intra_taps     found in ['aom'] (layouts of the "
              "others differ; held by the decoder's dav1d equality)")
    out["filter_intra_taps"] = taps

    sgr = np.array(SGR_PARAMS, np.int32)
    s_pairs = np.where(sgr[:, [1, 3]] < 0, 0, sgr[:, [1, 3]])
    where = []
    # libaom: {int r[2]; int s[2];} a set
    if sgr[:, [0, 2, 1, 3]].astype("<i4").tobytes() in img["aom"]:
        where.append("aom")
    if s_pairs.astype("<u2").tobytes() in img["dav1d"]:
        where.append("dav1d")
    if s_pairs.astype("<i4").tobytes() in img["rav1e"]:
        where.append("rav1e")
    if len(where) < 2:
        fail(f"sgr_params: found in {where} only")
    out["sgr_params"] = sgr
    print(f"sgr_params            found in {where}")

    dr = np.array(DR_INTRA_DERIVATIVE, "<u2")
    where = sorted(k for k, b in img.items() if dr.tobytes() in b)
    if len(where) < 2:
        fail(f"dr_intra_derivative: found in {where} only")
    out["dr_intra_derivative"] = dr.astype(np.int16)
    print(f"dr_intra_derivative   found in {where}")

    np.savez(OUT, **out)
    print("wrote", os.path.relpath(OUT, ROOT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
