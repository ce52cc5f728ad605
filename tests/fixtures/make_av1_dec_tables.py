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
- ``dr_intra_derivative`` (44, int16, indexed by angle >> 1);
- the screen-content and inter-style tools of intra frames: the palette
  size CDFs ``pal_y_size`` and ``pal_uv_size`` (7 block-size contexts, 7
  symbols), the colour-index CDFs ``pal_y_color_N`` and ``pal_uv_color_N``
  (N = 2..8 colours, 5 contexts each), ``intrabc``, the motion vector CDFs
  of ``MV_INTRABC_CONTEXT`` (``mv_joint``, ``mv_class``, ``mv_class0``,
  ``mv_bits`` for the 10 bits, ``mv_sign``), ``txfm_split`` (21
  contexts), the inter transform-type CDFs ``inter_tx1`` (2 square sizes,
  16 symbols), ``inter_tx2`` (12 symbols) and ``inter_tx3`` (4, 2);
- ``palette_color_context`` (9, int8), ``palette_hash_mult`` (3, int8) and
  ``bilinear`` (the BILINEAR row of Subpel_Filters, 16 x 8, int16);
- ``dc_qlookup_hbd`` and ``ac_qlookup_hbd`` (2 x 256, int16): the 10- and
  12-bit rows of Dc_Qlookup and Ac_Qlookup (``av1_tables.npz`` holds the
  8-bit row). These 1024 values are not retyped: they are read from
  libdav1d's table of (dc, ac) pairs, found by the 8-bit row it starts
  with, then each row must be found whole in libaom's image, and its
  first and last entries must be the specification's.
- ``quantizer_matrix`` (15 levels x 2 (luma, chroma) x 3344, uint8): the
  specification's Quantizer_Matrix, the decoder's weights of each
  coefficient's quantizer step (5 fractional bits). Not retyped: found
  in libaom's image as the inverse weights it dequantises with
  (``iwt_matrix_ref``), by the level-0 luma 4x4 matrix it starts with
  (the first sixteen entries, which must be the specification's), then
  found whole in SVT-AV1's (``libSvtAv1Enc.so.1``), whose encoder
  reconstructs with the same table. libdav1d keeps its matrices
  compressed (a triangle of each and the transposes left out), so it
  holds no copy to compare. The last entry must be the specification's
  32; every square matrix must be symmetric and each wide matrix the
  transpose of its tall twin, which places every offset of ``qm_offset``.
- ``qm_offset`` (19, int16): Qm_Offset, where each transform size's
  matrix starts in a level's 3344 entries, as the specification gives
  it: the sizes in the order of TX_4X4 .. TX_64X16, each of a side of
  64 on the matrix of its side cut to 32 (libaom's
  ``av1_get_adjusted_tx_size``). No library keeps it as a table (libaom
  walks the sizes when it sets its pointers up); it is held by the
  matrices' symmetries above and by summing to 3344.
- ``gaussian_sequence`` (2048, int16): Gaussian_Sequence, the film grain
  synthesis' white noise. Not retyped: read from libdav1d's image (int16)
  by its first eight entries, which must be the specification's, as must
  its last; then found whole in libaom's and SVT-AV1's (as int32) and in
  librav1e's (int16).

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
    "pal_y_size": [[7952, 13000, 18149, 21478, 25527, 29241],
                   [7139, 11421, 16195, 19544, 23666, 28073],
                   [7788, 12741, 17325, 20500, 24315, 28530],
                   [8271, 14064, 18246, 21564, 25071, 28533],
                   [12725, 19180, 21863, 24839, 27535, 30120],
                   [9711, 14888, 16923, 21052, 25661, 27875],
                   [14940, 20797, 21678, 24186, 27033, 28999]],
    "pal_uv_size": [[8713, 19979, 27128, 29609, 31331, 32272],
                    [5839, 15573, 23581, 26947, 29848, 31700],
                    [4426, 11260, 17999, 21483, 25863, 29430],
                    [3228, 9464, 14993, 18089, 22523, 27420],
                    [3768, 8886, 13091, 17852, 22495, 27207],
                    [2464, 8451, 12861, 21632, 25525, 28555],
                    [1269, 5435, 10433, 18963, 21700, 25865]],
    "pal_y_color_2": [[28710], [16384], [10553], [27036], [31603]],
    "pal_y_color_3": [[27877, 30490], [11532, 25697], [6544, 30234],
                      [23018, 28072], [31915, 32385]],
    "pal_y_color_4": [[25572, 28046, 30045], [9478, 21590, 27256],
                      [7248, 26837, 29824], [19167, 24486, 28349],
                      [31400, 31825, 32250]],
    "pal_y_color_5": [[24779, 26955, 28576, 30282],
                      [8669, 20364, 24073, 28093],
                      [4255, 27565, 29377, 31067],
                      [19864, 23674, 26716, 29530],
                      [31646, 31893, 32147, 32426]],
    "pal_y_color_6": [[23132, 25407, 26970, 28435, 30073],
                      [7443, 17242, 20717, 24762, 27982],
                      [6300, 24862, 26944, 28784, 30671],
                      [18916, 22895, 25267, 27435, 29652],
                      [31270, 31550, 31808, 32059, 32353]],
    "pal_y_color_7": [[23105, 25199, 26464, 27684, 28931, 30318],
                      [6950, 15447, 18952, 22681, 25567, 28563],
                      [7560, 23474, 25490, 27203, 28921, 30708],
                      [18544, 22373, 24457, 26195, 28119, 30045],
                      [31198, 31451, 31670, 31882, 32123, 32391]],
    "pal_y_color_8": [[21689, 23883, 25163, 26352, 27506, 28827, 30195],
                      [6892, 15385, 17840, 21606, 24287, 26753, 29204],
                      [5651, 23182, 25042, 26518, 27982, 29392, 30900],
                      [19349, 22578, 24418, 25994, 27524, 29031, 30448],
                      [31028, 31270, 31504, 31705, 31927, 32153, 32392]],
    "pal_uv_color_2": [[29089], [16384], [8713], [29257], [31610]],
    "pal_uv_color_3": [[25257, 29145], [12287, 27293], [7033, 27960],
                       [20145, 25405], [30608, 31639]],
    "pal_uv_color_4": [[24210, 27175, 29903], [9888, 22386, 27214],
                       [5901, 26053, 29293], [18318, 22152, 28333],
                       [30459, 31136, 31926]],
    "pal_uv_color_5": [[22980, 25479, 27781, 29986],
                       [8413, 21408, 24859, 28874],
                       [2257, 29449, 30594, 31598],
                       [19189, 21202, 25915, 28620],
                       [31844, 32044, 32281, 32518]],
    "pal_uv_color_6": [[22217, 24567, 26637, 28683, 30548],
                       [7307, 16406, 19636, 24632, 28424],
                       [4441, 25064, 26879, 28942, 30919],
                       [17210, 20528, 23319, 26750, 29582],
                       [30674, 30953, 31396, 31735, 32207]],
    "pal_uv_color_7": [[21239, 23168, 25044, 26962, 28705, 30506],
                       [6545, 15012, 18004, 21817, 25503, 28701],
                       [3448, 26295, 27437, 28704, 30126, 31442],
                       [15889, 18323, 21704, 24698, 26976, 29690],
                       [30988, 31204, 31479, 31734, 31983, 32325]],
    "pal_uv_color_8": [[21442, 23288, 24758, 26246, 27649, 28980, 30563],
                       [5863, 14933, 17552, 20668, 23683, 26411, 29273],
                       [3415, 25810, 26877, 27990, 29223, 30394, 31618],
                       [17965, 20084, 22232, 23974, 26274, 28402, 30390],
                       [31190, 31329, 31516, 31679, 31825, 32026, 32322]],
    "intrabc": [30531],
    "mv_joint": [4096, 11264, 19328],
    "mv_class": [28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757,
                 32762, 32767],
    "mv_class0": [27648],
    "mv_bits": [[17408], [17920], [18944], [20480], [22528], [24576],
                [28672], [29952], [29952], [30720]],
    "mv_sign": [16384],
    "txfm_split": [[28581], [23846], [20847], [24315], [18196], [12133],
                   [18791], [10887], [11005], [27179], [20004], [11281],
                   [26549], [19308], [14224], [28015], [21546], [14400],
                   [28165], [22401], [16088]],
    "inter_tx1": [[4458, 5560, 7695, 9709, 13330, 14789, 17537, 20266, 21504,
                   22848, 23934, 25474, 27727, 28915, 30631],
                  [1645, 2573, 4778, 5711, 7807, 8622, 10522, 15357, 17674,
                   20408, 22517, 25010, 27116, 28856, 30749]],
    "inter_tx2": [770, 2421, 5225, 12907, 15819, 18927, 21561, 24089, 26595,
                  28526, 30529],
    "inter_tx3": [[16384], [4167], [1998], [748]],
}
# CDFs of two symbols are one value: a run of one u16 proves nothing, so
# these are searched as whole tables (value, 0 [, counter]) in the
# library that keeps them that way
WHOLE = {"pal_y_mode", "pal_uv_mode", "tx_8x8", "wiener_restore",
         "sgrproj_restore", "use_filter_intra", "pal_y_color_2",
         "pal_uv_color_2", "intrabc", "mv_class0", "mv_bits", "mv_sign",
         "txfm_split", "inter_tx3"}
# a library may pad a record to the width of the largest of its kind (the
# colour-index CDFs to 8 symbols, the inter transform types to 16)
MAX_PAD = 16

PALETTE_COLOR_CONTEXT = [-1, -1, 0, -1, -1, 4, 3, 2, 1]
PALETTE_HASH_MULT = [1, 2, 2]
# Subpel_Filters[BILINEAR]: phase k takes 128 - 8k of the sample and 8k
# of the next one
BILINEAR = [[0, 0, 0, 128 - 8 * k, 8 * k, 0, 0, 0] for k in range(16)]
# the specification's first eight and last entries of each high-bit-depth
# quantizer row: 10-bit DC, 10-bit AC, 12-bit DC, 12-bit AC
Q_ANCHORS = {
    "dc10": ([4, 9, 10, 13, 15, 17, 20, 22], 5347),
    "ac10": ([4, 9, 11, 13, 16, 18, 21, 24], 7312),
    "dc12": ([4, 12, 18, 25, 33, 41, 50, 60], 21387),
    "ac12": ([4, 13, 19, 27, 35, 44, 54, 64], 29247),
}

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
# the specification's first sixteen entries of Quantizer_Matrix (level 0,
# luma, 4x4) and its last (level 14, chroma, the last of 32x8)
QM_FIRST = [32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110,
            150, 200]
QM_LAST = 32
QM_SIZE = 3344
# Qm_Offset of the specification, TX_4X4 .. TX_64X16
QM_OFFSET = [0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680, 2192, 336,
             336, 2704, 2768, 2832, 3088, 1680, 2192]
# the specification's first eight and last entries of Gaussian_Sequence
GAUSS_FIRST = [56, 568, -180, 172, 124, -84, 172, -64]
GAUSS_LAST = -484
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


def quantizer_matrix(img: dict):
    """(Quantizer_Matrix, Qm_Offset): the matrices read from libaom's
    image and checked as the docstring says."""
    first = np.array(QM_FIRST, np.uint8).tobytes()
    at = img["aom"].find(first)
    if at < 0 or img["aom"].find(first, at + 1) >= 0:
        fail("quantizer matrices: not found once in libaom")
    raw = img["aom"][at:at + 15 * 2 * QM_SIZE]
    if raw not in img["svt"]:
        fail("quantizer matrices: libaom's are not in SVT-AV1")
    qm = np.frombuffer(raw, np.uint8).reshape(15, 2, QM_SIZE)
    if int(qm[-1, -1, -1]) != QM_LAST:
        fail("quantizer matrices: the last entry is not the specification's")
    # each size not of a 64 side holds its own matrix, in order
    at = 0
    for t, (w, h) in enumerate(TX_DIMS):
        if max(w, h) == 64:
            continue
        if QM_OFFSET[t] != at:
            fail(f"Qm_Offset of {w}x{h}: {QM_OFFSET[t]}, the sizes say {at}")
        at += w * h
    if at != QM_SIZE:
        fail(f"Qm_Offset: the matrices take {at} entries, not {QM_SIZE}")

    def matrix(level, chroma, t):
        w, h = (min(v, 32) for v in TX_DIMS[t])
        return qm[level, chroma, QM_OFFSET[t]:QM_OFFSET[t] + w * h].reshape(
            h, w)

    for level in range(15):
        for chroma in range(2):
            for t, (w, h) in enumerate(TX_DIMS):
                m = matrix(level, chroma, t)
                if w == h and not np.array_equal(m, m.T):
                    fail(f"quantizer matrix {level}/{chroma} {w}x{h}: "
                         "not symmetric")
                if w < h and not np.array_equal(
                        m, matrix(level, chroma, TX_DIMS.index((h, w))).T):
                    fail(f"quantizer matrix {level}/{chroma} {w}x{h}: not "
                         f"the transpose of {h}x{w}'s")
    return qm.copy(), np.array(QM_OFFSET, np.int16)


def gaussian_sequence(img: dict) -> np.ndarray:
    """Gaussian_Sequence, read from libdav1d and found in the others."""
    first = np.array(GAUSS_FIRST, "<i2").tobytes()
    at = img["dav1d"].find(first)
    if at < 0:
        fail("gaussian sequence: not in libdav1d")
    g = np.frombuffer(img["dav1d"][at:at + 4096], "<i2").copy()
    if int(g[-1]) != GAUSS_LAST:
        fail("gaussian sequence: the last entry is not the specification's")
    for lib, dt in (("aom", "<i4"), ("svt", "<i4"), ("rav1e", "<i2")):
        if g.astype(dt).tobytes() not in img[lib]:
            fail(f"gaussian sequence: not whole in {lib}")
    return g.astype(np.int16)


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
                     for k in range(1, MAX_PAD + 1)]
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

    for name, vals, dt in (
            ("palette_color_context", PALETTE_COLOR_CONTEXT, "<i4"),
            ("palette_hash_mult", PALETTE_HASH_MULT, "<i4"),
            ("bilinear", BILINEAR, "<i2")):
        a = np.array(vals)
        # rav1e keeps its filters as int32
        where = [k for k, b in img.items()
                 if a.astype(dt).tobytes() in b
                 or a.astype("<i4").tobytes() in b]
        if len(where) < 2:
            fail(f"{name}: found in {sorted(where)} only")
        out[name] = a.astype(np.int16 if name == "bilinear" else np.int8)
        print(f"{name:21s} found in {sorted(where)}")

    enc = np.load(os.path.join(os.path.dirname(OUT), "av1_tables.npz"))
    pairs = np.stack([enc["dc_qlookup"], enc["ac_qlookup"]], 1)
    dav = img["dav1d"]
    at = dav.find(pairs.astype("<u2").tobytes())
    if at < 0:
        fail("quantizer lookups: libdav1d's (dc, ac) table not found")
    rows = np.frombuffer(dav[at:at + 3 * 256 * 4], "<u2").reshape(3, 256, 2)
    hbd = {"dc10": rows[1, :, 0], "ac10": rows[1, :, 1],
           "dc12": rows[2, :, 0], "ac12": rows[2, :, 1]}
    for name, row in hbd.items():
        first, last = Q_ANCHORS[name]
        if row[:8].tolist() != first or int(row[-1]) != last:
            fail(f"quantizer lookup {name}: not the specification's")
        if np.any(np.diff(row.astype(np.int64)) < 0):
            fail(f"quantizer lookup {name}: not monotonic")
        if row.astype("<i2").tobytes() not in img["aom"]:
            fail(f"quantizer lookup {name}: not in libaom")
    out["dc_qlookup_hbd"] = np.stack([hbd["dc10"], hbd["dc12"]]).astype(
        np.int16)
    out["ac_qlookup_hbd"] = np.stack([hbd["ac10"], hbd["ac12"]]).astype(
        np.int16)
    print("dc/ac_qlookup_hbd     found in ['aom', 'dav1d']")

    out["quantizer_matrix"], out["qm_offset"] = quantizer_matrix(img)
    print("quantizer_matrix      found in ['aom', 'svt']")
    out["gaussian_sequence"] = gaussian_sequence(img)
    print("gaussian_sequence     found in ['aom', 'dav1d', 'rav1e', 'svt']")

    np.savez_compressed(OUT, **out)
    print("wrote", os.path.relpath(OUT, ROOT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
