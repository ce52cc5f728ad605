"""First-party AV1 intra still-image encoder (spec-conformant subset).

The in-process AV1 entropy core the reference gets by compiling rav1e
(`image` crate AvifEncoder — reference src/transform.rs:138-146).
Scope: 8-bit 4:2:0 keyframes at ANY dims 1..4096, one tile per 64x64
superblock (free decoder parallelism), full partition tree down to 8x8
incl. the frame-edge forced-split syntax, DC/directional/PAETH/SMOOTH
intra modes, DCT + IDTX transforms at block size (TX_MODE_LARGEST),
the complete residual coefficient chain, and per-tile CDF adaptation
(disable_cdf_update=0) or the static-default regime — both certified.
Loop filter / CDEF / restoration / superres / screen-content tools are
off (our streams reconstruct exactly without them).

Conformance oracle: tools/av1_validate.py decodes every stream with the
system libdav1d (and libaom) and requires bit-exact agreement with this
module's own predicted reconstruction — a single wrong CDF entry or
context derails the arithmetic decode, so agreement on varied content
certifies the tables (imagekit_tpu/codecs/av1_tables.npz) and contexts.

The port's copy of ``imagekit_tpu/codecs/av1_intra.py``, with a
monochrome mode beside it (``mono``: mono_chrome = 1 in the sequence
header, no chroma delta-q flags in the frame header, blocks with no
uv_mode and no chroma residual), which the reference gets from libavif;
the 4:2:0 streams are unchanged, byte for byte.
"""

from __future__ import annotations

import numpy as np

from .av1_entropy import (
    BitWriter, MsacDecoder, MsacEncoder, NativeMsacEncoder, OBU_FRAME,
    OBU_SEQUENCE_HEADER, obu, tables,
)

# Partition symbols (spec 6.10.4)
PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3
PARTITION_HORZ_A = 4
PARTITION_HORZ_B = 5
PARTITION_VERT_A = 6
PARTITION_VERT_B = 7
PARTITION_HORZ_4 = 8
PARTITION_VERT_4 = 9


def _nsyms_partition(size: int) -> int:
    if size == 8:
        return 4
    if size == 128:
        return 8
    return 10


# ---------------------------------------------------------------------------
# Headers


def sequence_header(w: int, h: int, full_range: bool = False,
                    mono: bool = False) -> bytes:
    """The reduced still-picture sequence header; ``mono`` writes
    mono_chrome = 1 (one plane: no subsampling bits, no chroma sample
    position, no separate_uv_delta_q)."""
    b = BitWriter()
    b.f(0, 3)            # seq_profile = 0 (8-bit 4:2:0 or monochrome)
    b.f(1, 1)            # still_picture
    b.f(1, 1)            # reduced_still_picture_header
    b.f(0, 5)            # seq_level_idx[0]
    wbits = max((w - 1).bit_length(), 1)
    hbits = max((h - 1).bit_length(), 1)
    b.f(wbits - 1, 4)
    b.f(hbits - 1, 4)
    b.f(w - 1, wbits)
    b.f(h - 1, hbits)
    b.f(0, 1)            # use_128x128_superblock = 0 -> 64x64
    b.f(0, 1)            # enable_filter_intra
    b.f(0, 1)            # enable_intra_edge_filter
    b.f(0, 1)            # enable_superres
    b.f(0, 1)            # enable_cdef
    b.f(0, 1)            # enable_restoration
    # color_config
    b.f(0, 1)            # high_bitdepth
    b.f(int(mono), 1)    # mono_chrome
    b.f(0, 1)            # color_description_present_flag
    b.f(int(full_range), 1)  # color_range (full for alpha streams)
    if not mono:
        b.f(0, 2)        # chroma_sample_position = unknown
        b.f(0, 1)        # separate_uv_delta_q
    b.f(0, 1)            # film_grain_params_present
    b.trailing_bits()
    return b.bytes()


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header_bits(qindex: int, w: int, h: int,
                      adapt: bool = False, mono: bool = False) -> BitWriter:
    """Uncompressed frame header under reduced_still_picture_header
    (frame_type=KEY, show_frame=1 implied).  Validated bit-for-bit
    against a libaom still-picture frame header (tools/av1_validate.py
    parses one live).  ``mono``: one plane, so no chroma delta-q flags."""
    b = BitWriter()
    # disable_cdf_update: 0 = per-tile CDF adaptation from the defaults
    # (each tile resets — matching our tile-per-superblock regime), 1 =
    # static default CDFs (no adaptation state on either side)
    b.f(0 if adapt else 1, 1)
    b.f(0, 1)            # allow_screen_content_tools = 0
    b.f(0, 1)            # render_and_frame_size_different
    # tile_info (spec 5.9.15): ONE TILE PER SUPERBLOCK.  Each 64x64 tile
    # carries its own MSAC stream with its own termination — the regime
    # certified bit-exact against dav1d (single-SB streams); it also
    # gives decoders free tile parallelism.  The increment loops run
    # while TileColsLog2 < maxLog2TileCols, so we emit 1-bits until the
    # log2 reaches sbCols/sbRows rounded up, then a 0 stop bit if short
    # of the max.
    b.f(1, 1)            # uniform_tile_spacing_flag
    sb_cols = (w + 63) // 64
    sb_rows = (h + 63) // 64
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    want_cols = _tile_log2(1, sb_cols)
    want_rows = _tile_log2(1, sb_rows)
    cur = 0
    while cur < max_log2_cols:
        if cur < want_cols:
            b.f(1, 1)    # increment_tile_cols_log2
            cur += 1
        else:
            b.f(0, 1)
            break
    cur = 0
    while cur < max_log2_rows:
        if cur < want_rows:
            b.f(1, 1)    # increment_tile_rows_log2
            cur += 1
        else:
            b.f(0, 1)
            break
    if want_cols + want_rows > 0:
        b.f(0, want_cols + want_rows)  # context_update_tile_id = 0
        b.f(3, 2)        # tile_size_bytes_minus_1 = 3 (4-byte sizes)
    # quantization_params
    b.f(qindex, 8)       # base_q_idx
    b.f(0, 1)            # DeltaQYDc coded flag
    if not mono:
        b.f(0, 1)        # DeltaQUDc
        b.f(0, 1)        # DeltaQUAc
    b.f(0, 1)            # using_qmatrix
    b.f(0, 1)            # segmentation_enabled
    b.f(0, 1)            # delta_q_present
    # loop_filter_params: levels [2]/[3] are present only when
    # [0] or [1] is nonzero (pinned against a real lf=0 libaom header)
    b.f(0, 6)            # loop_filter_level[0]
    b.f(0, 6)            # loop_filter_level[1]
    b.f(0, 3)            # loop_filter_sharpness
    b.f(0, 1)            # loop_filter_delta_enabled
    # cdef: seq-disabled; lr: seq-disabled
    b.f(0, 1)            # tx_mode_select = 0 -> TX_MODE_LARGEST
    # reduced_tx_set = 1: every sub-32 intra luma tx uses TX_SET_INTRA_2,
    # whose 5-symbol tx_type CDF (intra_ext_tx2) is Rosetta-certified
    # with DCT_DCT = symbol 1; 32x32 stays in the DCT-only set either way
    b.f(1, 1)
    return b


# tile_info note: increment_tile_cols_log2 loops only while
# (1 << TileColsLog2) < max tiles; for frames <= 4096 wide one stop bit
# each is the exact syntax (minLog2 == 0 when sbCols <= 16? see
# tools/av1_validate.py which exercises this live against dav1d).


# ---------------------------------------------------------------------------
# Tile coding


class TileEncoder:
    """Codes one tile's superblock tree.

    Syntax model pinned by tools/av1_rosetta.py: controlled libaom
    streams (static CDFs, forced 32x32 partitions) are mirror-parsed
    symbol by symbol and RE-ENCODED byte-identically, so every symbol's
    table, context, and order below is certified against aom itself:
      - the skip symbol IS the skip flag (symbol 1 = skip, symbol 0 =
        not-skip followed by residual txbs); neighbor context sums the
        two neighbors' skip flags;
      - CFL-flavoured uv_mode CDFs (14 symbols) apply to blocks with
        width AND height <= 32 under 4:2:0 (spec cfl_allowed);
      - use_filter_intra is coded only when the sequence header enables
        filter intra (ours doesn't, so it is never coded);
      - partition context bits mean "neighbor leaf SMALLER than this
        size", so a same-size NONE neighbor contributes 0.

    (The round-5 notes' earlier inverted pins came from all-gray
    parse-tolerance — gray decodes bit-exact under many wrong models —
    and are superseded by the Rosetta byte-roundtrip evidence.)
    """

    # CDF tables that adapt within a tile when disable_cdf_update=0
    # (order of the first 11 = the C engine's per-call pointer block)
    _ADAPT_TABLES = (
        "txb_skip", "intra_ext_tx2", "eob_pt_16", "eob_pt_64",
        "eob_pt_256", "eob_pt_1024", "eob_extra", "coeff_base_eob",
        "coeff_base", "coeff_br", "dc_sign",
        "partition", "skip", "kf_y_mode", "uv_mode", "angle_delta",
    )

    def __init__(self, w: int, h: int, qctx: int = 1,
                 split_gather: str = "A", skip_idx: int = 0,
                 adapt: bool = False, mono: bool = False):
        self.w, self.h = w, h
        self.qctx = qctx
        # monochrome (mono_chrome = 1): blocks code no uv_mode and no
        # chroma residual (spec HasChroma = 0)
        self.mono = mono
        # spec 5.9.9: the mi grid rounds to 8-px multiples (MiCols =
        # 2*((width+7)>>3)), so 8x8 nodes are always fully inside the
        # grid and the partition tree never needs 4x4 leaves
        self.mi_cols = 2 * ((w + 7) >> 3)
        self.mi_rows = 2 * ((h + 7) >> 3)
        self.T = tables()
        self.adapt = adapt
        # per-tile mutable CDF copies when adapting (each tile starts
        # from the spec defaults and adapts independently — matching
        # the decoder, which resets at every tile boundary)
        self.cdf = ({k: self.T[k].copy() for k in self._ADAPT_TABLES}
                    if adapt else {k: self.T[k]
                                   for k in self._ADAPT_TABLES})
        self.skip_cdf = self.cdf["skip"]
        self.split_gather = split_gather
        # C entropy engine when available (byte-exact twin, ~40x the
        # symbol throughput; None only where its equality test turns it off)
        from .native import av1_abi

        self._nlib = av1_abi.load()
        self.msac = (NativeMsacEncoder(self._nlib) if self._nlib
                     else MsacEncoder())
        if self._nlib is not None:
            import ctypes

            self._ctabs = (ctypes.c_void_p * 11)(*[
                self.cdf[k].ctypes.data
                for k in self._ADAPT_TABLES[:11]])
        else:
            self._ctabs = None
        # context arrays (per 4x4)
        self.above_part = np.zeros(self.mi_cols + 32, dtype=np.uint8)
        self.left_part = np.zeros(self.mi_rows + 32, dtype=np.uint8)
        self.above_skip = np.zeros(self.mi_cols + 32, dtype=np.uint8)
        self.left_skip = np.zeros(self.mi_rows + 32, dtype=np.uint8)
        self.above_mode = np.zeros(self.mi_cols + 32, dtype=np.uint8)
        self.left_mode = np.zeros(self.mi_rows + 32, dtype=np.uint8)
        self.above_valid = np.zeros(self.mi_cols + 32, dtype=bool)
        self.left_valid = np.zeros(self.mi_rows + 32, dtype=bool)
        # per-plane coefficient entropy contexts (cul_level | dc_cat<<6);
        # luma indexed in luma 4x4 units, chroma in chroma 4x4 units
        self.above_ent = [np.zeros(self.mi_cols + 32, dtype=np.uint8)
                          for _ in range(3)]
        self.left_ent = [np.zeros(self.mi_rows + 32, dtype=np.uint8)
                         for _ in range(3)]

    def snapshot(self) -> dict:
        """Copy of all mutable coding state (the MSAC integers, every
        context array, and — when adapting — the CDF tables), enabling
        finalize-and-peek flows and RD trials."""
        s = {"msac": self.msac.save()}
        if self.adapt:
            s["cdf"] = {k: v.copy() for k, v in self.cdf.items()}
        for name in ("above_part", "left_part", "above_skip", "left_skip",
                     "above_mode", "left_mode", "above_valid", "left_valid"):
            s[name] = getattr(self, name).copy()
        s["above_ent"] = [a.copy() for a in self.above_ent]
        s["left_ent"] = [a.copy() for a in self.left_ent]
        return s

    def restore(self, s: dict) -> None:
        self.msac.load(s["msac"])
        if self.adapt:
            # write back IN PLACE: the native pointer block (_ctabs)
            # and self.skip_cdf alias these buffers
            for k, v in s["cdf"].items():
                self.cdf[k][...] = v
        for name in ("above_part", "left_part", "above_skip", "left_skip",
                     "above_mode", "left_mode", "above_valid", "left_valid"):
            setattr(self, name, s[name].copy())
        self.above_ent = [a.copy() for a in s["above_ent"]]
        self.left_ent = [a.copy() for a in s["left_ent"]]

    # -- partition ---------------------------------------------------------

    def _part_ctx(self, mi_r: int, mi_c: int, size: int) -> int:
        bsl = size.bit_length() - 4  # 8->0, 16->1, 32->2, 64->3
        above = (int(self.above_part[mi_c]) >> bsl) & 1
        left = (int(self.left_part[mi_r]) >> bsl) & 1
        return bsl * 4 + left * 2 + above

    def _update_part_ctx(self, mi_r: int, mi_c: int, size: int,
                         leaf_size: int) -> None:
        n4 = size >> 2
        # aom partition_context_lookup semantics: bit k set means "the
        # coded leaf is SMALLER than block size 2^(k+3)", so a ctx read
        # at the leaf's own size yields 0 (spec 9.3: above/left compare
        # the neighbor's Mi_Width_Log2 with the current bSize via
        # strictly-less).  leaf 8 -> 0b1110, 16 -> 0b1100, 32 -> 0b1000,
        # 64 -> 0b0000 (nothing above 64 is coded under a 64px SB).
        v = (0xF << (leaf_size.bit_length() - 3)) & 0xF
        self.above_part[mi_c:mi_c + n4] = v
        self.left_part[mi_r:mi_r + n4] = v

    def _sym(self, row, n: int, sym: int) -> None:
        """Symbol + in-place CDF update when adapting (the decoder
        adapts after every adaptive-CDF symbol when
        disable_cdf_update=0, so the encoder must mirror it 1:1)."""
        if self.adapt:
            self.msac.encode_symbol_adapt(sym, row, n)
        else:
            self.msac.encode_symbol(sym, row, n)

    def _encode_partition_symbol(self, ctx_row: int, sym: int, size: int):
        self._sym(self.cdf["partition"][ctx_row], _nsyms_partition(size),
                  sym)

    def _split_bool_icdf(self, ctx_row: int, size: int, horz: bool) -> tuple:
        """Derived CDF2 for split_or_{horz,vert} at partial nodes.

        No adaptation: the decoder derives this bool per use and never
        updates the underlying partition CDF for it.

        The bool's icdf[0] is the summed probability of the partition
        types whose VISIBLE half edge looks split: for split_or_horz
        (bottom half outside) that is the set that splits the top edge
        vertically {VERT, SPLIT, VERT_A, VERT_B, HORZ_A, VERT_4}, and
        the mirrored set for split_or_vert.  Certified bit-exact
        against dav1d on sub-64 edge frames (the earlier swapped
        mapping decoded gray frames "without error but wrong samples" —
        ROADMAP 1b — because gray is parse-tolerant; the edge-geometry
        validator now pins this).  split_gather="B" swaps the sets (the
        refuted alternative, kept for the A/B instrument)."""
        icdf = self.cdf["partition"][ctx_row]
        n = _nsyms_partition(size)

        def prob(sym):
            hi = 32768 if sym == 0 else int(icdf[sym - 1])
            lo = 0 if sym == n - 1 else int(icdf[sym])
            return hi - lo

        horz_set = [PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A,
                    PARTITION_HORZ_B, PARTITION_VERT_A]
        vert_set = [PARTITION_VERT, PARTITION_SPLIT, PARTITION_VERT_A,
                    PARTITION_VERT_B, PARTITION_HORZ_A]
        if size != 128:
            horz_set.append(PARTITION_HORZ_4)
            vert_set.append(PARTITION_VERT_4)
        use = vert_set if horz else horz_set
        if self.split_gather == "B":
            use = horz_set if horz else vert_set
        s = sum(prob(x) for x in use if x < n)
        return (s,)

    # -- residual coefficients ----------------------------------------------

    def _dc_sign_ctx(self, plane: int, er: int, ec: int, n4: int) -> int:
        a = self.above_ent[plane][ec:ec + n4] >> 6
        l = self.left_ent[plane][er:er + n4] >> 6
        dcsum = 0
        for v in list(a) + list(l):
            if v == 1:
                dcsum -= 1
            elif v == 2:
                dcsum += 1
        if dcsum < 0:
            return 1
        if dcsum > 0:
            return 2
        return 0

    def encode_txb(self, plane: int, px_r: int, px_c: int,
                   txsz_log2: int, quant, ymode: int = 0,
                   txtype_sym: int = 1) -> None:
        """One transform block with arbitrary quantized coefficients.

        `quant` maps raster position -> signed level (dict, or a 2-D
        array in tx raster order).  px_r/px_c are PLANE-pixel coords;
        txsz_log2 = log2 of the (square) tx dimension.  Symbol order,
        tables, and every context derivation mirror tools/av1_rosetta.py's
        parse_txb, which re-encodes real aom tiles byte-identically —
        the two are independent implementations cross-checked by bytes.
        """
        T, q, m = self.T, self.qctx, self.msac
        C = self.cdf
        ptype = 1 if plane else 0
        txs_ctx = txsz_log2 - 2
        n4 = 1 << (txsz_log2 - 2)
        er, ec = px_r >> 2, px_c >> 2
        a_ent, l_ent = self.above_ent[plane], self.left_ent[plane]
        side = 1 << txsz_log2
        # native engine: the whole coefficient chain in C (byte-exact
        # twin — equality pinned by tests), contexts fed/consumed here
        if self._nlib is not None:
            if isinstance(quant, dict):
                arr = np.zeros((side, side), np.int32)
                for pos, vv in quant.items():
                    if vv:
                        arr[pos // side, pos % side] = vv
            else:
                arr = np.ascontiguousarray(np.asarray(quant, np.int32))
            if plane == 0:
                skip_ctx = 0
            else:
                skip_ctx = 7 + int((a_ent[ec:ec + n4] != 0).any()) \
                    + int((l_ent[er:er + n4] != 0).any())
            dcctx = self._dc_sign_ctx(plane, er, ec, n4)
            ent = self._nlib.ik_av1_txb(
                m._h, plane, q, txsz_log2, arr.ctypes.data,
                skip_ctx, dcctx, ymode, txtype_sym, self._ctabs,
                int(self.adapt))
            if ent < 0:
                raise RuntimeError(f"native txb failed ({ent})")
            a_ent[ec:ec + n4] = ent
            l_ent[er:er + n4] = ent
            return
        nc = min(side, 32) * min(side, 32)
        if not isinstance(quant, dict):
            arr = np.asarray(quant)
            quant = {int(r * side + c): int(arr[r, c])
                     for r, c in zip(*np.nonzero(arr))}
        quant = {p: int(v) for p, v in quant.items() if v}
        # txb_skip (all_zero): symbol 1 = no coefficients
        if plane == 0:
            skip_ctx = 0  # luma tx spans its whole block in this encoder
        else:
            above_nz = int((a_ent[ec:ec + n4] != 0).any())
            left_nz = int((l_ent[er:er + n4] != 0).any())
            skip_ctx = 7 + above_nz + left_nz
        if not quant:
            self._sym(C["txb_skip"][q][txs_ctx][skip_ctx], 2, 1)
            a_ent[ec:ec + n4] = 0
            l_ent[er:er + n4] = 0
            return
        self._sym(C["txb_skip"][q][txs_ctx][skip_ctx], 2, 0)
        # tx_type: coded for luma tx < 32x32 with coefficients, between
        # all_zero and eob_pt (Rosetta-pinned).  With the frame header's
        # reduced_tx_set=1 the set is TX_SET_INTRA_2 and DCT_DCT is
        # symbol 1; chroma derives its tx_type (never coded); 32x32 is
        # the DCT-only set.
        if plane == 0 and txsz_log2 < 5:
            self._sym(C["intra_ext_tx2"][txsz_log2 - 2][ymode], 5,
                      txtype_sym)
        scan = {16: T["scan_4x4"], 64: T["scan_8x8"],
                256: T["scan_16x16"], 1024: T["scan_32x32"]}[nc]
        pos_to_c = {int(p): c for c, p in enumerate(scan)}
        eob = 1 + max(pos_to_c[p] for p in quant)
        # eob_pt + extras
        name = {16: "eob_pt_16", 64: "eob_pt_64", 256: "eob_pt_256",
                1024: "eob_pt_1024"}[nc]
        eob_pt = eob if eob <= 2 else (eob - 1).bit_length() + 1
        nsyms = T[name].shape[-1] - 1
        self._sym(C[name][q][ptype][0], nsyms, eob_pt - 1)
        if eob_pt >= 3:
            rem = eob - 1 - (1 << (eob_pt - 2))
            self._sym(C["eob_extra"][q][txs_ctx][ptype][eob_pt - 3], 2,
                      (rem >> (eob_pt - 3)) & 1)
            for i in range(eob_pt - 4, -1, -1):
                m.encode_literal((rem >> i) & 1, 1)
        # reverse scan: base magnitudes (capped at 15 via br increments)
        bwl = min(txsz_log2, 5)
        stride = (1 << bwl) + 4          # TX_PAD_HOR
        levels = np.zeros((min(side, 32) + 4) * stride + 16, np.int32)
        for c in range(eob - 1, -1, -1):
            pos = int(scan[c])
            level = min(abs(quant.get(pos, 0)), 15)
            row, col = pos >> bwl, pos & ((1 << bwl) - 1)
            lp = row * stride + col
            if c == eob - 1:
                if c == 0:
                    bctx = 0
                elif c <= nc // 8:
                    bctx = 1
                elif c <= nc // 4:
                    bctx = 2
                else:
                    bctx = 3
                self._sym(C["coeff_base_eob"][q][txs_ctx][ptype][bctx],
                          3, min(level, 3) - 1)
            else:
                mag = (min(int(levels[lp + 1]), 3)
                       + min(int(levels[lp + stride]), 3)
                       + min(int(levels[lp + stride + 1]), 3)
                       + min(int(levels[lp + 2]), 3)
                       + min(int(levels[lp + 2 * stride]), 3))
                bctx = min((mag + 1) >> 1, 4)
                if pos == 0:
                    bctx = 0
                elif row + col < 2:
                    bctx += 1
                elif row + col < 4:
                    bctx += 6
                else:
                    bctx += 21
                self._sym(C["coeff_base"][q][txs_ctx][ptype][bctx], 4,
                          min(level, 3))
            if level > 2:
                mag = (min(int(levels[lp + 1]), 15)
                       + min(int(levels[lp + stride]), 15)
                       + min(int(levels[lp + stride + 1]), 15))
                brctx = min((mag + 1) >> 1, 6)
                if pos != 0:
                    brctx += 7 if (row < 2 and col < 2) else 14
                remaining = level - 3
                for _ in range(4):
                    sym = min(remaining, 3)
                    self._sym(
                        C["coeff_br"][q][min(txs_ctx, 3)][ptype][brctx],
                        4, sym)
                    remaining -= sym
                    if sym < 3:
                        break
            levels[lp] = level
        # forward pass: signs + exp-Golomb residues for saturated levels
        for c in range(eob):
            pos = int(scan[c])
            v = quant.get(pos, 0)
            if not v:
                continue
            sign = 1 if v < 0 else 0
            if c == 0:
                dcctx = self._dc_sign_ctx(plane, er, ec, n4)
                self._sym(C["dc_sign"][q][ptype][dcctx], 2, sign)
            else:
                m.encode_literal(sign, 1)
            if abs(v) > 14:
                m.encode_golomb(abs(v) - 15)
        # entropy context: cul_level + dc category
        cul = min(63, sum(abs(v) for v in quant.values()))
        dc = quant.get(0, 0)
        cat = (1 if dc < 0 else 2) if dc else 0
        ent = cul | (cat << 6)
        a_ent[ec:ec + n4] = ent
        l_ent[er:er + n4] = ent

    # -- block layer -------------------------------------------------------

    def encode_block(self, mi_r: int, mi_c: int, size: int,
                     txbs=None, ymode: int = 0, uvmode: int = 0,
                     txtype_sym: int = 1) -> None:
        """One DC/directional intra block.  `txbs=(qy, qu, qv)` carries
        the three planes' quantized coefficients (dicts pos->level or
        2-D arrays; all-empty coefficients may also be passed — the
        block is then coded not-skip with three all_zero txbs, which is
        what aom itself emits); txbs=None codes a skip block.  A
        monochrome tile takes `txbs=(qy,)` and codes no uv_mode."""
        n4 = size >> 2
        skip = 0 if txbs is not None else 1
        # skip symbol = the skip flag; neighbor ctx sums neighbor skips
        actx = int(self.above_skip[mi_c]) if self.above_valid[mi_c] else 0
        lctx = int(self.left_skip[mi_r]) if self.left_valid[mi_r] else 0
        self._sym(self.skip_cdf[actx + lctx], 2, skip)
        # intra_frame_y_mode (kf): ctx from neighbor modes (DC when absent)
        am = _INTRA_MODE_CTX[int(self.above_mode[mi_c])] \
            if self.above_valid[mi_c] else 0
        lm = _INTRA_MODE_CTX[int(self.left_mode[mi_r])] \
            if self.left_valid[mi_r] else 0
        self._sym(self.cdf["kf_y_mode"][am][lm], 13, ymode)
        if 1 <= ymode <= 8 and size >= 8:
            # directional mode: angle_delta is always coded (delta 0 is
            # symbol 3 — MAX_ANGLE_DELTA)
            self._sym(self.cdf["angle_delta"][ymode - 1], 7, 3)
        # uv_mode: CFL-flavoured 14-symbol CDF when cfl is allowed
        # (w and h <= 32 — includes 32x32; Rosetta-certified)
        if not self.mono:
            if size <= 32:
                self._sym(self.cdf["uv_mode"][1][ymode], 14, uvmode)
            else:
                self._sym(self.cdf["uv_mode"][0][ymode], 13, uvmode)
            if 1 <= uvmode <= 8 and size >= 8:
                self._sym(self.cdf["angle_delta"][uvmode - 1], 7, 3)
        # use_filter_intra: only coded when the sequence header enables
        # filter intra; ours sets enable_filter_intra=0, so never coded.
        if txbs is not None:
            # residual: luma tx = block size (TX_MODE_LARGEST, <= 32),
            # then U, then V at half size (4:2:0)
            y_txl = size.bit_length() - 1
            self.encode_txb(0, mi_r * 4, mi_c * 4, y_txl, txbs[0],
                            ymode=ymode, txtype_sym=txtype_sym)
            if not self.mono:
                _, qu, qv = txbs
                uv_txl = y_txl - 1
                self.encode_txb(1, mi_r * 2, mi_c * 2, uv_txl, qu)
                self.encode_txb(2, mi_r * 2, mi_c * 2, uv_txl, qv)
        else:
            # skip blocks clear the coefficient entropy contexts
            self.above_ent[0][mi_c:mi_c + n4] = 0
            self.left_ent[0][mi_r:mi_r + n4] = 0
            cn4 = max(n4 >> 1, 1)
            for pl in (1, 2):
                self.above_ent[pl][mi_c // 2:mi_c // 2 + cn4] = 0
                self.left_ent[pl][mi_r // 2:mi_r // 2 + cn4] = 0
        # context updates (skip ctx arrays store the skip flag)
        self.above_skip[mi_c:mi_c + n4] = skip
        self.left_skip[mi_r:mi_r + n4] = skip
        self.above_mode[mi_c:mi_c + n4] = ymode
        self.left_mode[mi_r:mi_r + n4] = ymode
        self.above_valid[mi_c:mi_c + n4] = True
        self.left_valid[mi_r:mi_r + n4] = True

    def encode_partition(self, mi_r: int, mi_c: int, size: int) -> None:
        if mi_r >= self.mi_rows or mi_c >= self.mi_cols:
            return
        n4 = size >> 2
        half = n4 >> 1
        has_rows = (mi_r + half) < self.mi_rows
        has_cols = (mi_c + half) < self.mi_cols
        full = (mi_r + n4) <= self.mi_rows and (mi_c + n4) <= self.mi_cols
        ctx_row = self._part_ctx(mi_r, mi_c, size)
        if full and size <= 32:
            self._encode_partition_symbol(ctx_row, PARTITION_NONE, size)
            self.encode_block(mi_r, mi_c, size)
            self._update_part_ctx(mi_r, mi_c, size, size)
            return
        # split (coded or implied)
        if full:
            self._encode_partition_symbol(ctx_row, PARTITION_SPLIT, size)
        elif has_rows and has_cols:
            self._encode_partition_symbol(ctx_row, PARTITION_SPLIT, size)
        elif has_cols:  # bottom half out: split_or_horz
            icdf = self._split_bool_icdf(ctx_row, size, horz=True)
            self.msac.encode_symbol(1, icdf, 2)  # 1 = SPLIT
        elif has_rows:  # right half out: split_or_vert
            icdf = self._split_bool_icdf(ctx_row, size, horz=False)
            self.msac.encode_symbol(1, icdf, 2)
        # else: both out -> implied SPLIT, no bits
        sub = size >> 1
        h4 = half
        self.encode_partition(mi_r, mi_c, sub)
        self.encode_partition(mi_r, mi_c + h4, sub)
        self.encode_partition(mi_r + h4, mi_c, sub)
        self.encode_partition(mi_r + h4, mi_c + h4, sub)

    def encode_tile(self) -> bytes:
        for sb_r in range(0, self.mi_rows, 16):
            for sb_c in range(0, self.mi_cols, 16):
                self.encode_partition(sb_r, sb_c, 64)
        return self.msac.done()


# Intra_Mode_Context (spec 9.3): mode -> neighbor context bucket
_INTRA_MODE_CTX = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]


def encode_tiles(w: int, h: int, tile_fn) -> bytes:
    """Assemble the tile-group payload: one tile PER SUPERBLOCK (matching
    frame_header_bits' tile_info), raster order, 4-byte little-endian
    size prefix on every tile but the last (tile_size_bytes_minus_1=3).
    tile_fn(tw, th) -> tile bytes for a tile of the given pixel dims."""
    sb_cols = (w + 63) // 64
    sb_rows = (h + 63) // 64
    tiles = []
    for tr in range(sb_rows):
        for tc in range(sb_cols):
            tw = min(64, w - tc * 64)
            th = min(64, h - tr * 64)
            tiles.append(tile_fn(tw, th))
    out = bytearray()
    if len(tiles) > 1:
        # tile_group header: tile_start_and_end_present_flag = 0 (frame
        # OBUs carry every tile) + byte_alignment (spec 5.11.1)
        out.append(0x00)
    for i, t in enumerate(tiles):
        if i < len(tiles) - 1:
            out += (len(t) - 1).to_bytes(4, "little")
        out += t
    return bytes(out)


def encode_gray_frame(w: int, h: int, qindex: int = 60,
                      split_gather: str = "A", skip_idx: int = 0) -> bytes:
    """Full OBU stream (seq header + frame) of an all-skip gray frame.

    Conformance-certified for ANY dims 1..4096 (bit-exact through
    libdav1d, tools/av1_validate.py — edge superblocks ride the
    forced-split syntax, whose split_or_horz/vert gather sets the
    edge-geometry sweep pins).  qindex must be lossy (1..255):
    base_q_idx==0 flips the frame to CodedLossless, whose header omits
    the delta-q/loop-filter/tx-mode fields this writer emits.  Dims
    above 4096 need the multi-level tile_info increment loop
    (minLog2TileCols > 0) that this writer doesn't emit.
    """
    if w < 1 or h < 1:
        raise ValueError("dims must be positive")
    if not 1 <= qindex <= 255:
        raise ValueError("qindex must be in 1..255 (0 = lossless, "
                         "which needs a different header layout)")
    if w > 4096 or h > 4096:
        raise ValueError("dims above 4096 need multi-level tile_info")
    seq = obu(OBU_SEQUENCE_HEADER, sequence_header(w, h))
    hdr = frame_header_bits(qindex, w, h)
    hdr.byte_align()
    tg = encode_tiles(
        w, h,
        lambda tw, th: TileEncoder(tw, th, split_gather=split_gather,
                                   skip_idx=skip_idx).encode_tile())
    frame = obu(OBU_FRAME, hdr.bytes() + tg)
    return seq + frame
