// AV1 decoder of the port's own: the still picture (or the output frame
// of the first temporal unit of an image sequence or a layered stream) of
// an AVIF item, 8-, 10- or 12-bit, intra or inter, in place of libdav1d,
// which the reference's avif_native.py calls over ctypes.
//
// It follows the AV1 specification's decoding process section by section
// (the names of its variables and processes are kept: decode_partition,
// intra_frame_mode_info, find_mv_stack, block_inter_prediction,
// edge_loop_filter, cdef_block, ...), since reconstruction is normative:
// the planes must be byte-equal to any conforming decoder's, libdav1d's
// included (tests/test_torch_av1_decode.py, test_torch_av1_screen_hbd.py
// and test_torch_av1_inter.py hold them so). Where the specification
// leaves a choice of arithmetic to the decoder (the warp model's products,
// the distance weights' comparison), libdav1d's and libaom's is taken.
// Tools:
//
//   - OBUs: temporal delimiter, sequence header (reduced or full), frame
//     header and tile groups, or frame OBUs; padding and metadata skipped;
//     the layers an operating point leaves out dropped; the frames of the
//     first temporal unit walked with their reference slots (hidden
//     frames, show_existing_frame of a stored KEY_FRAME) to the output
//     frame libdav1d returns (parse_stream): the first shown, or the
//     highest spatial layer's, or one layer's; the frames it depends on
//     (its references, theirs, ...) decoded before it, in decode order,
//     each kept in its slots (7.20: the frame after its filters, its
//     header, frame-end CDFs, segment ids and the vectors of the motion
//     field), and no other;
//   - frame header of every frame type: frame size and superres params
//     (the tiles code the downscaled width), of an inter frame its
//     references (ref_frame_idx, or frame_refs_short_signaling and
//     set_frame_refs), frame_size_with_refs, the vector precision, the
//     interpolation filter, motion modes, use_ref_frame_mvs, the primary
//     reference's CDFs, loop filter deltas, segmentation features and
//     global motion (load_previous), reference_select, skip_mode_params,
//     allow_warped_motion, global motion params and film grain loaded from
//     a reference; tile info (uniform or explicit, several tiles and tile
//     groups), quantizer params with DC/AC/U/V deltas, segmentation (with
//     update_map and temporal_update), delta q / lf, loop filter, CDEF and
//     loop restoration params, allow_intrabc, tx mode, reduced tx set,
//     quantizer matrices (using_qmatrix, qm_y, qm_u, qm_v) and film grain
//     params;
//   - symbol decoder with CDF adaptation (spec 8.2), the default CDFs
//     handed over by av1_dec_abi.py at load (av1_tables.npz and
//     av1_dec_tables.npz);
//   - block syntax of 64 and 128 superblocks, all 22 block sizes, the
//     intra mode info (skip, cdef_idx, delta q and lf, segment ids with
//     spatial prediction, y and uv modes, angle deltas, CfL alphas,
//     palette mode info and colour index maps, filter intra), the inter
//     frame mode info (segment ids predicted from the previous frame,
//     skip mode, is_inter, intra blocks of inter frames, single and
//     compound references, the single and compound modes and drl, read_mv
//     at high, quarter and integer precision, interintra, motion modes,
//     compound types, switchable and dual interpolation filters), tx depth
//     and the var-tx tree, the intra and inter tx sets, coefficients of all
//     19 tx sizes, dequantisation, weighted by Quantizer_Matrix where the
//     frame uses quantizer matrices;
//   - motion vector prediction (7.10.2): the spatial candidates, the
//     temporal ones from the motion field of the references (7.9,
//     projected as libaom keeps it), the extra search, global motion's
//     vectors, the contexts and clamping; intra block copy's stack;
//   - inter prediction (7.11.3): the motion vector scaling of references
//     of another size (a smaller base layer, a superres reference) and the
//     8-tap and 4-tap Subpel_Filters, clamped to the reference's upscaled
//     frame; local warp (find_warp_samples, the least-squares model,
//     setupShear) and global motion by Warped_Filters; OBMC; interintra
//     (smooth and wedge); compound average, distance weights, wedge and
//     difference-weighted masks; intra block copy, a vector that reaches
//     outside its tile or into samples not yet decoded refused (the
//     conformance rule is_mv_valid), so tiles stay on their threads;
//   - inverse DCT 4-64, ADST 4/8/16 (and flipped), identity 4-32 and the
//     4x4 WHT of lossless blocks, rectangular scaling, intermediate clamps;
//   - intra prediction: DC, V, H, Paeth, smooth, directional with edge
//     filter and upsampling, CfL, recursive filter intra, palette;
//   - deblocking (4, 6, 8 and 14 taps, the reference and mode deltas of
//     inter blocks, only the block's edges inside an inter block with no
//     residual), CDEF, the upscaling process of superres (8-tap
//     Upscale_Filter of 64 phases over the CDEF output and, for
//     restoration's stripe edges, the deblocked frame), loop restoration
//     (Wiener and self-guided, on the upscaled frame, stripes reading the
//     deblocked rows);
//   - film grain synthesis (7.18.3) on the shown frame: grain templates
//     with auto-regressive filtering, scaling lookups, noise stripes with
//     overlap blending, chroma scaled from luma, clipping to the range.
//
// Everything from the tiles on is a template over the sample type:
// uint8_t for 8-bit streams, uint16_t for 10- and 12-bit ones, whose
// BitDepth-dependent steps (quantizer rows, clamps, edge base values,
// inter rounding, deblocking limits, CDEF strengths, Wiener and
// self-guided rounding, palette literals, grain ranges) follow the spec.
// Tiles decode on threads of their own (decode_tiles; an inter frame's
// references are whole frames decoded before it, read only), and so do
// CDEF's rows of 64x64 units, the upscale's bands of 32 rows, loop
// restoration's runs of rows (a stripe's rows in one row of units) and
// film grain's stripes of 32 rows; deblocking runs on the calling thread.
// Malformed streams answer IK_AV1D_BAD (400): every read is bounds
// checked, a reference slot that is empty or of a size out of the 2x / 16x
// rule fails the stream (as in libdav1d), and a symbol decoder that runs
// past its tile reads zeros as the spec says, so a truncated tile decodes
// to something, as in libdav1d.

#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum { IK_AV1D_OK = 0, IK_AV1D_BAD = -1, IK_AV1D_NO_TABLES = -3 };

// ---------------------------------------------------------------------------
// Default tables, as av1_dec_abi.py packs them (one struct of uint16 CDF
// records [icdf 0..N-2, 0, counter], then the other constants).

struct Cdfs {
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t coeff_base[5][2][42][5];
  uint16_t coeff_br[5][2][21][5];
  uint16_t coeff_base_eob[5][2][4][4];
  uint16_t eob_pt_16[2][2][6];
  uint16_t eob_pt_32[2][2][7];
  uint16_t eob_pt_64[2][2][8];
  uint16_t eob_pt_128[2][2][9];
  uint16_t eob_pt_256[2][2][10];
  uint16_t eob_pt_512[2][11];
  uint16_t eob_pt_1024[2][12];
  uint16_t kf_y_mode[5][5][14];
  uint16_t uv_mode_cfl[13][15];
  uint16_t uv_mode_nocfl[13][14];
  uint16_t partition[20][11];
  uint16_t use_filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t angle_delta[8][8];
  uint16_t intra_tx1[4][13][8];
  uint16_t intra_tx2[4][13][6];
  uint16_t skip[3][3];
  uint16_t segment_id[3][9];
  uint16_t delta_q[5];
  uint16_t delta_lf[5];
  uint16_t delta_lf_multi[4][5];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t pal_y_mode[7][3][3];
  uint16_t pal_uv_mode[2][3];
  uint16_t tx_8x8[3][3];
  uint16_t tx_depth[3][3][4];  // 16x16, 32x32, 64x64 categories
  uint16_t switchable_restore[4];
  uint16_t wiener_restore[3];
  uint16_t sgrproj_restore[3];
  uint16_t pal_y_size[7][8];
  uint16_t pal_uv_size[7][8];
  // [plane type][palette size - 2][context]: N = size symbols, the record
  // padded to the largest (8 symbols)
  uint16_t pal_color[2][7][5][9];
  uint16_t intrabc[3];
  // MV_INTRABC_CONTEXT's motion vector CDFs, [comp] row then column
  uint16_t mv_joint[5];
  uint16_t mv_class[2][12];
  uint16_t mv_class0[2][3];
  uint16_t mv_bits[2][10][3];
  uint16_t mv_sign[2][3];
  uint16_t txfm_split[21][3];
  uint16_t inter_tx1[2][17];
  uint16_t inter_tx2[13];
  uint16_t inter_tx3[4][3];
  // inter frames: the y mode of intra blocks by size group, is_inter,
  // seg_id_predicted, the single references (p1 .. p6), the inter modes,
  // drl_mode, the interpolation filters, motion modes, interintra
  uint16_t y_mode[4][14];
  uint16_t is_inter[4][3];
  uint16_t seg_pred[3][3];
  uint16_t single_ref[3][6][3];
  uint16_t new_mv[6][3];
  uint16_t zero_mv[2][3];
  uint16_t ref_mv[6][3];
  uint16_t drl_mode[3][3];
  uint16_t interp_filter[16][4];
  uint16_t motion_mode[22][4];
  uint16_t use_obmc[22][3];
  uint16_t interintra[4][3];
  uint16_t interintra_mode[4][5];
  uint16_t wedge_interintra[22][3];
  uint16_t wedge_index[22][17];
  // MvCtx 0's motion vector CDFs (those of intra block copy are above),
  // [comp] row then column
  uint16_t mv0_joint[5];
  uint16_t mv0_class[2][12];
  uint16_t mv0_class0[2][3];
  uint16_t mv0_bits[2][10][3];
  uint16_t mv0_sign[2][3];
  uint16_t mv0_class0_fr[2][2][5];
  uint16_t mv0_fr[2][5];
  uint16_t mv0_class0_hp[2][3];
  uint16_t mv0_hp[2][3];
  // compound prediction
  uint16_t skip_mode[3][3];
  uint16_t comp_mode[5][3];
  uint16_t comp_ref_type[5][3];
  uint16_t uni_comp_ref[3][3][3];
  uint16_t comp_ref[3][3][3];
  uint16_t comp_bwd_ref[3][2][3];
  uint16_t compound_mode[8][9];
  uint16_t comp_group_idx[6][3];
  uint16_t compound_idx[6][3];
  uint16_t compound_type[22][3];
};

struct Tables {
  Cdfs cdf[4];  // one per coefficient q context
  // 16-bit members first, then bytes: no padding anywhere
  int16_t dc_q[3][256];  // BitDepth 8, 10, 12
  int16_t ac_q[3][256];
  int16_t dr_deriv[44];
  int16_t sgr[16][4];  // r0, s0, r1, s1
  int16_t scan4x4[16], scan8x8[64], scan16x16[256], scan32x32[1024];
  int16_t scan4x8[32], scan8x4[32], scan8x16[128], scan16x8[128];
  int16_t scan16x32[512], scan32x16[512], scan4x16[64], scan16x4[64];
  int16_t scan8x32[256], scan32x8[256];
  int16_t bilinear[16][8];  // Subpel_Filters[BILINEAR]
  int16_t gaussian[2048];   // Gaussian_Sequence
  int16_t qm_offset[19];    // Qm_Offset
  int16_t upscale[64][8];   // Upscale_Filter
  uint8_t sm_weights[128];  // 124 used: sizes 4, 8, 16, 32, 64 in turn
  int8_t filter_taps[5][8][8];  // 7 used
  int8_t ctx_offset[19][5][5];
  int8_t palette_color_context[9];
  int8_t palette_hash_mult[3];
  int8_t pad_[1];
  uint8_t qm[15][2][3344];  // Quantizer_Matrix [level][plane > 0]
  // inter prediction
  int16_t subpel[6][16][8];  // Subpel_Filters
  int16_t warped[193][8];    // Warped_Filters
  int16_t div_lut[257];      // Div_Lut
  int16_t pad2_;
  uint8_t obmc_mask[64];     // Obmc_Mask_N at [N .. 2N)
  uint8_t wedge_master[3][64];  // oblique even, oblique odd, vertical
  uint8_t wedge_codebook[3][16][3];  // [h > w, h < w, h == w]
  uint8_t ii_weights[128];   // Ii_Weights_1d
  uint8_t quant_dist_weight[4][2], quant_dist_lookup[4][2];
  // 1 where a uint16 of Cdfs is a symbol counter (zeroed when a frame's
  // CDFs are saved)
  uint8_t cdf_counter[sizeof(Cdfs) / 2];
};



Tables g_tab;
bool g_ready = false;

// The frame-end CDFs as a slot keeps them: the counters zeroed
inline void clear_counters(Cdfs& c) {
  uint16_t* v = reinterpret_cast<uint16_t*>(&c);
  for (size_t i = 0; i < sizeof(Cdfs) / 2; ++i)
    if (g_tab.cdf_counter[i]) v[i] = 0;
}
int g_cos128[65];

// ---------------------------------------------------------------------------
// Constants of the specification

enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_INVALID = 22 };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A,
       PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 };
enum { TX_SET_INTER_1 = 1, TX_SET_INTER_2, TX_SET_INTER_3 };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
enum { TX_MODE_ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT };
enum { SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_REF_FRAME = 5,
       SEG_LVL_SKIP = 6, SEG_LVL_MAX = 8 };

enum { NEARESTMV = 13, NEARMV, GLOBALMV, NEWMV, NEAREST_NEARESTMV,
       NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV, NEAR_NEWMV, NEW_NEARMV,
       GLOBAL_GLOBALMV, NEW_NEWMV };
enum { SIMPLE, OBMC, LOCALWARP };
enum { COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE, COMPOUND_INTRA,
       COMPOUND_DISTANCE };
enum { SEG_LVL_GLOBALMV = 7 };
// the blocks that used each inter tool (IkAv1dInfo.tools)
enum { TOOL_INTER, TOOL_INTRA_IN_INTER, TOOL_NEWMV, TOOL_GLOBALMV,
       TOOL_SCALED, TOOL_SWITCHABLE, TOOL_DUAL_FILTER, TOOL_OBMC,
       TOOL_LOCAL_WARP, TOOL_GLOBAL_WARP, TOOL_INTERINTRA,
       TOOL_WEDGE_INTERINTRA, TOOL_TEMPORAL_MV, TOOL_SEG_TEMPORAL,
       TOOL_COMPOUND, TOOL_SKIP_MODE, TOOL_COMPOUND_DISTANCE,
       TOOL_COMPOUND_WEDGE, TOOL_COMPOUND_DIFFWTD, TOOL_MV_OUTSIDE,
       TOOL_WARP_INVALID, kNumTools };

const uint8_t kNum4x4W[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8,
                              16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const uint8_t kNum4x4H[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16,
                              8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const uint8_t kMiWLog2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                              4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const uint8_t kMiHLog2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4,
                              3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
const uint8_t kSubsize[10][22] = {
    // NONE
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21},
    // HORZ
    {22, 22, 22, BLOCK_8X4, 22, 22, BLOCK_16X8, 22, 22, BLOCK_32X16, 22, 22,
     BLOCK_64X32, 22, 22, BLOCK_128X64, 22, 22, 22, 22, 22, 22},
    // VERT
    {22, 22, 22, BLOCK_4X8, 22, 22, BLOCK_8X16, 22, 22, BLOCK_16X32, 22, 22,
     BLOCK_32X64, 22, 22, BLOCK_64X128, 22, 22, 22, 22, 22, 22},
    // SPLIT
    {22, 22, 22, BLOCK_4X4, 22, 22, BLOCK_8X8, 22, 22, BLOCK_16X16, 22, 22,
     BLOCK_32X32, 22, 22, BLOCK_64X64, 22, 22, 22, 22, 22, 22},
    // HORZ_A, HORZ_B
    {22, 22, 22, BLOCK_8X4, 22, 22, BLOCK_16X8, 22, 22, BLOCK_32X16, 22, 22,
     BLOCK_64X32, 22, 22, BLOCK_128X64, 22, 22, 22, 22, 22, 22},
    {22, 22, 22, BLOCK_8X4, 22, 22, BLOCK_16X8, 22, 22, BLOCK_32X16, 22, 22,
     BLOCK_64X32, 22, 22, BLOCK_128X64, 22, 22, 22, 22, 22, 22},
    // VERT_A, VERT_B
    {22, 22, 22, BLOCK_4X8, 22, 22, BLOCK_8X16, 22, 22, BLOCK_16X32, 22, 22,
     BLOCK_32X64, 22, 22, BLOCK_64X128, 22, 22, 22, 22, 22, 22},
    {22, 22, 22, BLOCK_4X8, 22, 22, BLOCK_8X16, 22, 22, BLOCK_16X32, 22, 22,
     BLOCK_32X64, 22, 22, BLOCK_64X128, 22, 22, 22, 22, 22, 22},
    // HORZ_4
    {22, 22, 22, 22, 22, 22, BLOCK_16X4, 22, 22, BLOCK_32X8, 22, 22,
     BLOCK_64X16, 22, 22, 22, 22, 22, 22, 22, 22, 22},
    // VERT_4
    {22, 22, 22, 22, 22, 22, BLOCK_4X16, 22, 22, BLOCK_8X32, 22, 22,
     BLOCK_16X64, 22, 22, 22, 22, 22, 22, 22, 22, 22},
};
// Subsampled_Size[bsize][subx][suby]
const uint8_t kSsSize[22][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
};
const uint8_t kSizeGroup[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3,
                                3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};
const uint8_t kWedgeBits[22] = {0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0,
                                0, 0, 0, 0, 0, 0, 0, 4, 4, 0, 0};
const uint8_t kMaxTxRect[22] = {
    TX_4X4,   TX_4X8,   TX_8X4,   TX_8X8,   TX_8X16,  TX_16X8,
    TX_16X16, TX_16X32, TX_32X16, TX_32X32, TX_32X64, TX_64X32,
    TX_64X64, TX_64X64, TX_64X64, TX_64X64, TX_4X16,  TX_16X4,
    TX_8X32,  TX_32X8,  TX_16X64, TX_64X16};
const uint8_t kMaxTxDepth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4,
                                 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
const uint8_t kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16,
                          32, 32, 64, 4, 16, 8, 32, 16, 64};
const uint8_t kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32,
                          16, 64, 32, 16, 4, 32, 8, 64, 16};
const uint8_t kTxWLog2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4,
                              5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t kTxHLog2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5,
                              4, 6, 5, 4, 2, 5, 3, 6, 4};
const uint8_t kSplitTx[19] = {
    TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,  TX_4X4,
    TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
const uint8_t kTxSqr[19] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2,
                            2, 3, 3, 0, 0, 1, 1, 2, 2};
const uint8_t kTxSqrUp[19] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3,
                              3, 4, 4, 2, 2, 3, 3, 4, 4};
const uint8_t kTxRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                 1, 1, 1, 1, 1, 2, 2, 2, 2};
// Adjusted_Tx_Size: 64 sides count as 32
const uint8_t kAdjTx[19] = {
    TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_32X32, TX_4X8,   TX_8X4,
    TX_8X16,  TX_16X8,  TX_16X32, TX_32X16, TX_32X32, TX_32X32, TX_4X16,
    TX_16X4,  TX_8X32,  TX_32X8,  TX_16X32, TX_32X16};
const uint8_t kIntraModeCtx[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const uint8_t kModeToTxfm[14] = {
    DCT_DCT,  ADST_DCT, DCT_ADST,  DCT_DCT,  ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,  ADST_ADST, DCT_DCT};
const uint8_t kTxInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT,
                               ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t kTxInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t kTxInterInvSet1[16] = {
    IDTX,     V_DCT,        H_DCT,        V_ADST,
    H_ADST,   V_FLIPADST,   H_FLIPADST,   DCT_DCT,
    ADST_DCT, DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
    ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const uint8_t kTxInterInvSet2[12] = {
    IDTX,         V_DCT,        H_DCT,     DCT_DCT,
    ADST_DCT,     DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
    ADST_ADST,    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const uint8_t kTxInterInvSet3[2] = {IDTX, DCT_DCT};
// Tx_Type_In_Set_Inter of sets 1, 2 and 3, as bit masks over the types
const uint16_t kTxInSetInter[4] = {1u << DCT_DCT, 0xFFFF, 0x0FFF,
                                   (1u << DCT_DCT) | (1u << IDTX)};
const uint8_t kFilterIntraToDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED,
                                      DC_PRED};
const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                              0, 0, 0, 0};
const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
const int kSigRefDiff[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int kMagRefOffset[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                                    {{0, 1}, {1, 0}, {0, 2}},
                                    {{0, 1}, {1, 0}, {2, 0}}};
const int kWienerTapsMin[3] = {-5, -23, -17};
const int kWienerTapsMax[3] = {10, 8, 46};
const int kWienerTapsK[3] = {1, 2, 3};
const int kSgrprojXqdMin[2] = {-96, -32};
const int kSgrprojXqdMax[2] = {31, 95};
const int kCdefUvDir[2][2][8] = {
    {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
    {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
const int kCdefDirections[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
const int kCdefDivTable[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
const int kIntraEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0},
                                    {2, 4, 4, 4, 2}};

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int64_t clip3l(int64_t lo, int64_t hi, int64_t v) {
  return v < lo ? lo : v > hi ? hi : v;
}
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
inline int64_t round2l(int64_t x, int n) {
  return n ? (x + ((int64_t)1 << (n - 1))) >> n : x;
}
inline int floor_log2(uint32_t x) { return 31 - __builtin_clz(x); }

// Errors leave the decode by exception: one try in each entry point.
struct Fail {
  int code;
  const char* why;
};
[[noreturn]] void bad(const char* why) { throw Fail{IK_AV1D_BAD, why}; }

// The workers of parallel_for: 0 for one a core (ik_av1d_set_threads).
std::atomic<int> g_threads{0};

// fn(0) .. fn(n - 1) on up to one thread a core (or g_threads), this one
// included; fn must not throw.
template <typename F>
void parallel_for(int n, F fn) {
  int most = g_threads.load();
  if (most <= 0) most = std::max(1u, std::thread::hardware_concurrency());
  int workers = std::min<int>(n, most);
  std::atomic<int> next{0};
  auto work = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) fn(i);
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < workers; ++i) pool.emplace_back(work);
  work();
  for (std::thread& t : pool) t.join();
}

// ---------------------------------------------------------------------------
// Bit reader of the headers (spec 4.10, 8.1)

struct Bits {
  const uint8_t* p;
  size_t n;      // bytes
  size_t pos;    // bit position
  uint32_t f(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      if ((pos >> 3) >= n) bad("header runs past its OBU");
      v = (v << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return v;
  }
  int su(int k) {
    int v = (int)f(k);
    int sign = 1 << (k - 1);
    return (v & sign) ? v - 2 * sign : v;
  }
  uint32_t uvlc() {
    int zeros = 0;
    while (!f(1)) {
      if (++zeros >= 32) bad("uvlc");
    }
    return zeros ? (uint32_t)((1ull << zeros) - 1 + f(zeros)) : 0;
  }
  uint32_t ns(uint32_t nn) {
    int w = floor_log2(nn) + 1;
    uint32_t m = (1u << w) - nn;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  void byte_align() { pos = (pos + 7) & ~(size_t)7; }
};

// ---------------------------------------------------------------------------
// Sequence and frame headers

struct SeqHdr {
  int profile = 0, still = 0, reduced = 0;
  int timing_info = 0, decoder_model_info = 0, equal_picture_interval = 0;
  int buffer_delay_len = 0, buffer_removal_time_len = 0,
      frame_presentation_time_len = 0;
  int op_cnt = 1;
  int op_idc[32] = {0};
  int decoder_model_present[32] = {0};
  int wbits = 0, hbits = 0, max_w = 0, max_h = 0;
  int frame_id_numbers = 0, delta_frame_id_len = 0, frame_id_len = 0;
  int sb128 = 0, filter_intra = 0, intra_edge = 0;
  int interintra = 0, masked_compound = 0, warped_motion = 0, dual_filter = 0;
  int jnt_comp = 0, ref_frame_mvs = 0;
  int order_hint = 0, order_hint_bits = 0;
  int force_sct = 2, force_integer_mv = 2;
  int superres = 0, cdef = 0, restoration = 0;
  int bitdepth = 8, mono = 0, ssx = 1, ssy = 1;
  int primaries = 2, transfer = 2, matrix = 2, color_range = 0;
  int separate_uv_delta_q = 0, film_grain = 0;
};

void parse_seq(Bits& b, SeqHdr& s) {
  s.profile = b.f(3);
  if (s.profile > 2) bad("sequence profile");
  s.still = b.f(1);
  s.reduced = b.f(1);
  if (s.reduced) {
    b.f(5);  // seq_level_idx[0]
  } else {
    s.timing_info = b.f(1);
    if (s.timing_info) {
      b.f(32);
      b.f(32);
      s.equal_picture_interval = b.f(1);
      if (s.equal_picture_interval) b.uvlc();
      s.decoder_model_info = b.f(1);
      if (s.decoder_model_info) {
        s.buffer_delay_len = b.f(5) + 1;
        b.f(32);
        s.buffer_removal_time_len = b.f(5) + 1;
        s.frame_presentation_time_len = b.f(5) + 1;
      }
    }
    int initial_display_delay = b.f(1);
    s.op_cnt = b.f(5) + 1;
    for (int i = 0; i < s.op_cnt; ++i) {
      s.op_idc[i] = b.f(12);
      int lvl = b.f(5);
      if (lvl > 7) b.f(1);
      if (s.decoder_model_info) {
        s.decoder_model_present[i] = b.f(1);
        if (s.decoder_model_present[i]) {
          b.f(s.buffer_delay_len);
          b.f(s.buffer_delay_len);
          b.f(1);
        }
      }
      if (initial_display_delay && b.f(1)) b.f(4);
    }
  }
  s.wbits = b.f(4) + 1;
  s.hbits = b.f(4) + 1;
  s.max_w = b.f(s.wbits) + 1;
  s.max_h = b.f(s.hbits) + 1;
  if (!s.reduced) s.frame_id_numbers = b.f(1);
  if (s.frame_id_numbers) {
    s.delta_frame_id_len = b.f(4) + 2;
    s.frame_id_len = b.f(3) + 1 + s.delta_frame_id_len;
  }
  s.sb128 = b.f(1);
  s.filter_intra = b.f(1);
  s.intra_edge = b.f(1);
  if (!s.reduced) {
    s.interintra = b.f(1);
    s.masked_compound = b.f(1);
    s.warped_motion = b.f(1);
    s.dual_filter = b.f(1);
    s.order_hint = b.f(1);
    if (s.order_hint) {
      s.jnt_comp = b.f(1);
      s.ref_frame_mvs = b.f(1);
    }
    int choose_sct = b.f(1);
    s.force_sct = choose_sct ? 2 : (int)b.f(1);
    if (s.force_sct > 0) {
      int choose_imv = b.f(1);
      s.force_integer_mv = choose_imv ? 2 : (int)b.f(1);
    } else {
      s.force_integer_mv = 2;
    }
    if (s.order_hint) s.order_hint_bits = b.f(3) + 1;
  }
  s.superres = b.f(1);
  s.cdef = b.f(1);
  s.restoration = b.f(1);
  // color_config
  int high_bd = b.f(1);
  if (s.profile == 2 && high_bd)
    s.bitdepth = b.f(1) ? 12 : 10;
  else
    s.bitdepth = high_bd ? 10 : 8;
  s.mono = s.profile == 1 ? 0 : (int)b.f(1);
  if (b.f(1)) {
    s.primaries = b.f(8);
    s.transfer = b.f(8);
    s.matrix = b.f(8);
  }
  if (s.mono) {
    s.color_range = b.f(1);
    s.ssx = s.ssy = 1;
    s.separate_uv_delta_q = 0;
  } else {
    if (s.primaries == 1 && s.transfer == 13 && s.matrix == 0) {
      s.color_range = 1;
      s.ssx = s.ssy = 0;
    } else {
      s.color_range = b.f(1);
      if (s.profile == 0) {
        s.ssx = s.ssy = 1;
      } else if (s.profile == 1) {
        s.ssx = s.ssy = 0;
      } else if (s.bitdepth == 12) {
        s.ssx = b.f(1);
        s.ssy = s.ssx ? (int)b.f(1) : 0;
      } else {
        s.ssx = 1;
        s.ssy = 0;
      }
      if (s.ssx && s.ssy) b.f(2);  // chroma_sample_position
    }
    s.separate_uv_delta_q = b.f(1);
  }
  s.film_grain = b.f(1);
}

// film_grain_params() of an intra frame (update_grain is 1): the scaling
// points of Y, Cb and Cr, the auto-regressive coefficients (each minus
// 128), and the Cb / Cr multipliers and offsets, each less its bias
struct FilmGrain {
  int apply = 0, seed = 0;
  int num[3] = {0, 0, 0};   // num_y_points, num_cb_points, num_cr_points
  int points[3][14][2] = {};  // [plane][i] = {value, scaling}
  int cfl = 0;              // chroma_scaling_from_luma
  int scaling_shift = 8, ar_lag = 0, ar_shift = 6, grain_scale_shift = 0;
  int ar[3][25] = {};
  int mult[3] = {0, 0, 0}, luma_mult[3] = {0, 0, 0}, offset[3] = {0, 0, 0};
  int overlap = 0, clip_restricted = 0;
};

enum { INTRA_FRAME = 0, LAST_FRAME = 1, LAST2_FRAME, LAST3_FRAME,
       GOLDEN_FRAME, BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME, NONE_FRAME = -1 };
enum { GM_IDENTITY, GM_TRANSLATION, GM_ROTZOOM, GM_AFFINE };
enum { PRIMARY_REF_NONE = 7 };
constexpr int kWmBits = 16;  // WARPEDMODEL_PREC_BITS

struct FrameHdr {
  int frame_type = 0, show_frame = 1, showable = 0, error_resilient = 1;
  // an INTER or SWITCH frame, and the reference slots the frame refreshes
  int inter = 0, refresh = 0xFF;
  int disable_cdf_update = 0, allow_sct = 0, allow_intrabc = 0;
  int force_integer_mv = 0, disable_frame_end_update_cdf = 1;
  int context_update_tile_id = 0;
  // order hints: the frame's, and OrderHints[] of its references (saved
  // with the frame for the motion field of later ones)
  int order_hint = 0;
  int order_hints[8] = {0};
  // an inter frame's references: the slots of LAST_FRAME .. ALTREF_FRAME,
  // the slot its CDFs and other context come from (7: none)
  int primary_ref_frame = PRIMARY_REF_NONE;
  int ref_frame_idx[7] = {0};
  int ref_sign_bias[8] = {0};
  int allow_high_precision_mv = 0, interp_filter = 0, motion_switchable = 0;
  int use_ref_frame_mvs = 0, reference_select = 0, skip_mode_present = 0;
  int skip_mode_frame[2] = {0, 0};
  int allow_warped_motion = 0;
  // global motion: GmType and gm_params of each reference
  int gm_type[8] = {0};
  int gm_params[8][6];
  int seg_update_map = 1, seg_temporal_update = 0;
  // FrameWidth (the coded width, downscaled where superres is used),
  // UpscaledWidth and SuperresDenom; use_superres where the two widths
  // differ (a frame under 16 wide reads the flag and keeps its width: as in
  // libdav1d and libaom, it is neither upscaled nor mapped to restoration
  // units through the denominator)
  int width = 0, height = 0, upscaled_width = 0;
  int use_superres = 0, superres_denom = 8;
  int mi_cols = 0, mi_rows = 0;
  // tiles
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  int mi_col_starts[65], mi_row_starts[65];
  int tile_size_bytes = 4;
  // quantizer
  int base_q_idx = 0, dq_ydc = 0, dq_udc = 0, dq_uac = 0, dq_vdc = 0,
      dq_vac = 0;
  // quantizer matrices: each plane's level in each segment (SegQMLevel,
  // 15 = flat)
  int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
  int seg_qm_level[3][8];
  // segmentation
  int seg_enabled = 0, seg_preskip = 0, last_active_seg = 0;
  int feature_enabled[8][8] = {{0}};
  int feature_data[8][8] = {{0}};
  int lossless[8] = {0};
  int coded_lossless = 0, all_lossless = 0;
  // deltas
  int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0,
      delta_lf_res = 0, delta_lf_multi = 0;
  // loop filter
  int lf_level[4] = {0}, lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
  int lf_mode_deltas[2] = {0, 0};
  // cdef
  int cdef_damping = 3, cdef_bits = 0;
  int cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0}, cdef_uv_pri[8] = {0},
      cdef_uv_sec[8] = {0};
  int cdef_on = 0;
  // loop restoration
  int lr_type[3] = {0, 0, 0};
  int lr_size[3] = {64, 64, 64};
  int uses_lr = 0;
  int tx_mode = TX_MODE_LARGEST, reduced_tx_set = 0;
  FilmGrain grain;
};

// film_grain_params() once apply_grain, grain_seed and (an INTER
// frame's) update_grain are read, refusing what
// libdav1d refuses: more than 14 luma or 10 chroma points, points whose
// values do not increase, and Cb points without Cr points (or the
// reverse) in 4:2:0.
void parse_film_grain(Bits& b, const SeqHdr& s, FilmGrain& g) {
  auto read_points = [&](int pl, int most) {
    g.num[pl] = b.f(4);
    if (g.num[pl] > most) bad("film grain: too many scaling points");
    for (int i = 0; i < g.num[pl]; ++i) {
      g.points[pl][i][0] = b.f(8);
      if (i && g.points[pl][i - 1][0] >= g.points[pl][i][0])
        bad("film grain: scaling points do not increase");
      g.points[pl][i][1] = b.f(8);
    }
  };
  read_points(0, 14);
  g.cfl = s.mono ? 0 : (int)b.f(1);
  if (!(s.mono || g.cfl || (s.ssx && s.ssy && !g.num[0]))) {
    read_points(1, 10);
    read_points(2, 10);
  }
  if (s.ssx && s.ssy && !g.num[1] != !g.num[2])
    bad("film grain: Cb and Cr points differ in 4:2:0");
  g.scaling_shift = b.f(2) + 8;
  g.ar_lag = b.f(2);
  int num_pos = 2 * g.ar_lag * (g.ar_lag + 1);
  if (g.num[0])
    for (int i = 0; i < num_pos; ++i) g.ar[0][i] = (int)b.f(8) - 128;
  for (int pl = 1; pl < 3; ++pl)
    if (g.num[pl] || g.cfl)
      for (int i = 0; i < num_pos + (g.num[0] > 0); ++i)
        g.ar[pl][i] = (int)b.f(8) - 128;
  g.ar_shift = b.f(2) + 6;
  g.grain_scale_shift = b.f(2);
  for (int pl = 1; pl < 3; ++pl)
    if (g.num[pl]) {
      g.mult[pl] = (int)b.f(8) - 128;
      g.luma_mult[pl] = (int)b.f(8) - 128;
      g.offset[pl] = (int)b.f(9) - 256;
    }
  g.overlap = b.f(1);
  g.clip_restricted = b.f(1);
}

inline int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) ++k;
  return k;
}

inline int get_relative_dist(const SeqHdr& s, int a, int b) {
  if (!s.order_hint) return 0;
  int diff = a - b;
  int m = 1 << (s.order_hint_bits - 1);
  return (diff & (m - 1)) - (diff & m);
}

inline void reset_gm(int gm[8][6]) {
  for (int r = 0; r < 8; ++r)
    for (int i = 0; i < 6; ++i) gm[r][i] = (i % 3 == 2) ? 1 << kWmBits : 0;
}

int inverse_recenter(int r, int v) {
  if (v > 2 * r) return v;
  if (v & 1) return r - ((v + 1) >> 1);
  return r + (v >> 1);
}

// decode_signed_subexp_with_ref of the global motion parameters (5.9.26,
// 5.9.27), from the header's bits
int header_subexp_with_ref(Bits& b, int low, int high, int r) {
  int mx = high - low;
  r -= low;
  int v, i = 0, mk = 0;
  const int k = 3;
  for (;;) {
    int b2 = i ? k + i - 1 : k;
    int a = 1 << b2;
    if (mx <= mk + 3 * a) {
      v = (int)b.ns((uint32_t)(mx - mk)) + mk;
      break;
    }
    if (b.f(1)) {
      ++i;
      mk += a;
    } else {
      v = (int)b.f(b2) + mk;
      break;
    }
  }
  int x = (r << 1) <= mx ? inverse_recenter(r, v)
                         : mx - 1 - inverse_recenter(mx - 1 - r, v);
  return x + low;
}

// set_frame_refs (7.8): the references of frame_refs_short_signaling from
// the last and golden slots and the slots' order hints
void set_frame_refs(const SeqHdr& s, FrameHdr& h, int last_idx, int gold_idx,
                    const FrameHdr* const* slots) {
  int used[8] = {0}, shifted[8];
  for (int i = 0; i < 7; ++i) h.ref_frame_idx[i] = -1;
  h.ref_frame_idx[0] = last_idx;
  h.ref_frame_idx[GOLDEN_FRAME - LAST_FRAME] = gold_idx;
  used[last_idx] = used[gold_idx] = 1;
  int cur = 1 << (s.order_hint_bits - 1);
  for (int i = 0; i < 8; ++i)
    shifted[i] = cur + get_relative_dist(s, slots[i] ? slots[i]->order_hint : 0,
                                         h.order_hint);
  auto pick = [&](bool backward, bool latest) {
    int ref = -1, best = 0;
    for (int i = 0; i < 8; ++i) {
      int hint = shifted[i];
      if (used[i] || (backward ? hint < cur : hint >= cur)) continue;
      if (ref < 0 || (latest ? hint >= best : hint < best)) {
        ref = i;
        best = hint;
      }
    }
    return ref;
  };
  int ref = pick(true, true);
  if (ref >= 0) {
    h.ref_frame_idx[ALTREF_FRAME - LAST_FRAME] = ref;
    used[ref] = 1;
  }
  ref = pick(true, false);
  if (ref >= 0) {
    h.ref_frame_idx[BWDREF_FRAME - LAST_FRAME] = ref;
    used[ref] = 1;
  }
  ref = pick(true, false);
  if (ref >= 0) {
    h.ref_frame_idx[ALTREF2_FRAME - LAST_FRAME] = ref;
    used[ref] = 1;
  }
  static const int kList[5] = {LAST2_FRAME, LAST3_FRAME, BWDREF_FRAME,
                               ALTREF2_FRAME, ALTREF_FRAME};
  for (int i = 0; i < 5; ++i) {
    if (h.ref_frame_idx[kList[i] - LAST_FRAME] >= 0) continue;
    ref = pick(false, true);
    if (ref >= 0) {
      h.ref_frame_idx[kList[i] - LAST_FRAME] = ref;
      used[ref] = 1;
    }
  }
  ref = -1;
  int earliest = 0;
  for (int i = 0; i < 8; ++i)
    if (ref < 0 || shifted[i] < earliest) {
      ref = i;
      earliest = shifted[i];
    }
  for (int i = 0; i < 7; ++i)
    if (h.ref_frame_idx[i] < 0) h.ref_frame_idx[i] = ref;
}

// uncompressed_header() of a frame that is not shown from a slot (the
// caller reads show_existing_frame first). `slots` are the headers of the
// frames in the eight reference slots (null where a slot is empty), which
// an inter frame's header reads: their sizes, order hints, loop filter
// deltas, segmentation features, global motion and film grain. A
// reference slot that is empty, or whose frame is over twice or under a
// sixteenth of this one's size, fails the stream, as in libdav1d.
void parse_frame_header(Bits& b, const SeqHdr& s, FrameHdr& h,
                        int temporal_id, int spatial_id,
                        const FrameHdr* const* slots) {
  int id_len = s.frame_id_numbers ? s.frame_id_len : 0;
  reset_gm(h.gm_params);
  if (s.reduced) {
    h.frame_type = 0;
    h.show_frame = 1;
  } else {
    h.frame_type = b.f(2);
    h.inter = h.frame_type == 1 || h.frame_type == 3;
    h.show_frame = b.f(1);
    if (h.show_frame && s.decoder_model_info && !s.equal_picture_interval)
      b.f(s.frame_presentation_time_len);
    if (!h.show_frame) h.showable = b.f(1);
    else h.showable = h.frame_type != 0;
    if (h.frame_type == 3 || (h.frame_type == 0 && h.show_frame))
      h.error_resilient = 1;
    else
      h.error_resilient = b.f(1);
  }
  h.disable_cdf_update = b.f(1);
  h.allow_sct = s.force_sct == 2 ? (int)b.f(1) : s.force_sct;
  if (h.allow_sct)
    h.force_integer_mv =
        s.force_integer_mv == 2 ? (int)b.f(1) : s.force_integer_mv;
  if (!h.inter) h.force_integer_mv = 1;
  if (s.frame_id_numbers) b.f(id_len);  // current_frame_id
  int size_override = 0;
  if (h.frame_type == 3) size_override = 1;
  else if (!s.reduced) size_override = b.f(1);
  if (s.order_hint_bits) h.order_hint = b.f(s.order_hint_bits);
  // primary_ref_frame: none for intra frames and error resilient ones
  if (h.inter && !h.error_resilient) h.primary_ref_frame = b.f(3);
  if (s.decoder_model_info) {
    if (b.f(1)) {  // buffer_removal_time_present_flag
      for (int op = 0; op < s.op_cnt; ++op) {
        if (!s.decoder_model_present[op]) continue;
        int idc = s.op_idc[op];
        int in_t = (idc >> temporal_id) & 1;
        int in_s = (idc >> (spatial_id + 8)) & 1;
        if (idc == 0 || (in_t && in_s)) b.f(s.buffer_removal_time_len);
      }
    }
  }
  int refresh = 0xFF;
  if (!(h.frame_type == 3 || (h.frame_type == 0 && h.show_frame)))
    refresh = b.f(8);
  h.refresh = refresh;
  if ((h.inter || refresh != 0xFF) && h.error_resilient && s.order_hint)
    for (int i = 0; i < 8; ++i) b.f(s.order_hint_bits);  // ref_order_hint
  // superres_params and compute_image_size (5.9.8, 5.9.9): the tiles code
  // the downscaled width, at least Min(16, UpscaledWidth) as libdav1d and
  // libaom have it
  auto superres = [&]() {
    h.width = h.upscaled_width;
    if (s.superres && b.f(1)) {
      h.superres_denom = b.f(3) + 9;
      h.width = std::max(
          (h.upscaled_width * 8 + h.superres_denom / 2) / h.superres_denom,
          std::min(16, h.upscaled_width));
      h.use_superres = h.width != h.upscaled_width;
    }
    h.mi_cols = 2 * ((h.width + 7) >> 3);
    h.mi_rows = 2 * ((h.height + 7) >> 3);
  };
  auto frame_size = [&]() {
    if (size_override) {
      h.upscaled_width = b.f(s.wbits) + 1;
      h.height = b.f(s.hbits) + 1;
    } else {
      h.upscaled_width = s.max_w;
      h.height = s.max_h;
    }
    superres();
    if (b.f(1)) {  // render_and_frame_size_different
      b.f(16);
      b.f(16);
    }
  };
  if (!h.inter) {
    frame_size();
    if (h.allow_sct && h.upscaled_width == h.width) h.allow_intrabc = b.f(1);
  } else {
    int short_signaling = s.order_hint ? (int)b.f(1) : 0;
    if (short_signaling) {
      int last_idx = b.f(3), gold_idx = b.f(3);
      set_frame_refs(s, h, last_idx, gold_idx, slots);
    }
    for (int i = 0; i < 7; ++i) {
      if (!short_signaling) h.ref_frame_idx[i] = b.f(3);
      if (s.frame_id_numbers) b.f(s.delta_frame_id_len);
    }
    for (int i = 0; i < 7; ++i)
      if (!slots[h.ref_frame_idx[i]]) bad("a reference slot is empty");
    int found = 0;
    if (size_override && !h.error_resilient) {
      for (int i = 0; i < 7 && !found; ++i) {
        found = b.f(1);
        if (found) {
          const FrameHdr& r = *slots[h.ref_frame_idx[i]];
          h.upscaled_width = r.upscaled_width;
          h.height = r.height;
        }
      }
    }
    if (found)
      superres();
    else
      frame_size();
    h.allow_high_precision_mv = h.force_integer_mv ? 0 : (int)b.f(1);
    h.interp_filter = b.f(1) ? 4 : (int)b.f(2);  // 4: SWITCHABLE
    h.motion_switchable = b.f(1);
    h.use_ref_frame_mvs =
        (h.error_resilient || !s.ref_frame_mvs) ? 0 : (int)b.f(1);
    for (int i = 0; i < 7; ++i) {
      const FrameHdr& r = *slots[h.ref_frame_idx[i]];
      h.order_hints[LAST_FRAME + i] = r.order_hint;
      h.ref_sign_bias[LAST_FRAME + i] =
          s.order_hint && get_relative_dist(s, r.order_hint, h.order_hint) > 0;
      // each reference at most twice and at least a sixteenth of this
      // frame's size (libdav1d's check: the coded width against the
      // reference's upscaled one)
      if (2 * h.width < r.upscaled_width || 2 * h.height < r.height ||
          h.width > 16 * r.upscaled_width || h.height > 16 * r.height)
        bad("a reference of a size out of the 2x / 16x range");
    }
  }
  h.disable_frame_end_update_cdf =
      (s.reduced || h.disable_cdf_update) ? 1 : (int)b.f(1);
  // load_previous (the primary reference's loop filter deltas, segmentation
  // features and global motion, which this header reads against), else
  // setup_past_independence's defaults (those of FrameHdr)
  int prev_gm[8][6];
  reset_gm(prev_gm);
  const FrameHdr* prev = nullptr;
  if (h.primary_ref_frame != PRIMARY_REF_NONE) {
    prev = slots[h.ref_frame_idx[h.primary_ref_frame]];
    memcpy(h.lf_ref_deltas, prev->lf_ref_deltas, sizeof(h.lf_ref_deltas));
    memcpy(h.lf_mode_deltas, prev->lf_mode_deltas, sizeof(h.lf_mode_deltas));
    memcpy(h.feature_enabled, prev->feature_enabled,
           sizeof(h.feature_enabled));
    memcpy(h.feature_data, prev->feature_data, sizeof(h.feature_data));
    memcpy(prev_gm, prev->gm_params, sizeof(prev_gm));
  }
  // tile_info
  int sb_cols = s.sb128 ? (h.mi_cols + 31) >> 5 : (h.mi_cols + 15) >> 4;
  int sb_rows = s.sb128 ? (h.mi_rows + 31) >> 5 : (h.mi_rows + 15) >> 4;
  int sb_shift = s.sb128 ? 5 : 4;
  int sb_size = sb_shift + 2;
  int max_tile_w_sb = 4096 >> sb_size;
  int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
  int min_log2_cols = tile_log2(max_tile_w_sb, sb_cols);
  int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
  int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
  int min_log2_tiles =
      std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
  if (b.f(1)) {  // uniform
    h.tile_cols_log2 = min_log2_cols;
    while (h.tile_cols_log2 < max_log2_cols && b.f(1)) ++h.tile_cols_log2;
    int tw = (sb_cols + (1 << h.tile_cols_log2) - 1) >> h.tile_cols_log2;
    int i = 0;
    for (int start = 0; start < sb_cols; start += tw) {
      if (i >= 64) bad("tile columns");
      h.mi_col_starts[i++] = start << sb_shift;
    }
    h.mi_col_starts[i] = h.mi_cols;
    h.tile_cols = i;
    int min_log2_rows = std::max(min_log2_tiles - h.tile_cols_log2, 0);
    h.tile_rows_log2 = min_log2_rows;
    while (h.tile_rows_log2 < max_log2_rows && b.f(1)) ++h.tile_rows_log2;
    int th = (sb_rows + (1 << h.tile_rows_log2) - 1) >> h.tile_rows_log2;
    i = 0;
    for (int start = 0; start < sb_rows; start += th) {
      if (i >= 64) bad("tile rows");
      h.mi_row_starts[i++] = start << sb_shift;
    }
    h.mi_row_starts[i] = h.mi_rows;
    h.tile_rows = i;
  } else {
    int widest = 0, start = 0, i = 0;
    for (; start < sb_cols; ++i) {
      if (i >= 64) bad("tile columns");
      h.mi_col_starts[i] = start << sb_shift;
      int maxw = std::min(sb_cols - start, max_tile_w_sb);
      int size = b.ns(maxw) + 1;
      widest = std::max(size, widest);
      start += size;
    }
    h.mi_col_starts[i] = h.mi_cols;
    h.tile_cols = i;
    h.tile_cols_log2 = tile_log2(1, h.tile_cols);
    int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                  : sb_rows * sb_cols;
    int max_th = std::max(area / widest, 1);
    start = 0;
    i = 0;
    for (; start < sb_rows; ++i) {
      if (i >= 64) bad("tile rows");
      h.mi_row_starts[i] = start << sb_shift;
      int maxh = std::min(sb_rows - start, max_th);
      start += b.ns(maxh) + 1;
    }
    h.mi_row_starts[i] = h.mi_rows;
    h.tile_rows = i;
    h.tile_rows_log2 = tile_log2(1, h.tile_rows);
  }
  if (h.tile_cols_log2 > 0 || h.tile_rows_log2 > 0) {
    h.context_update_tile_id = b.f(h.tile_rows_log2 + h.tile_cols_log2);
    if (h.context_update_tile_id >= h.tile_cols * h.tile_rows)
      bad("context_update_tile_id");
    h.tile_size_bytes = b.f(2) + 1;
  }
  // quantization_params
  int planes = s.mono ? 1 : 3;
  h.base_q_idx = b.f(8);
  auto read_delta_q = [&]() { return b.f(1) ? b.su(7) : 0; };
  h.dq_ydc = read_delta_q();
  if (planes > 1) {
    int diff_uv = s.separate_uv_delta_q ? (int)b.f(1) : 0;
    h.dq_udc = read_delta_q();
    h.dq_uac = read_delta_q();
    if (diff_uv) {
      h.dq_vdc = read_delta_q();
      h.dq_vac = read_delta_q();
    } else {
      h.dq_vdc = h.dq_udc;
      h.dq_vac = h.dq_uac;
    }
  }
  h.using_qmatrix = b.f(1);
  if (h.using_qmatrix) {
    h.qm_y = b.f(4);
    h.qm_u = b.f(4);
    h.qm_v = s.separate_uv_delta_q ? (int)b.f(4) : h.qm_u;
  }
  // segmentation_params: the map and the features are updated, or the
  // primary reference's kept
  h.seg_enabled = b.f(1);
  int update_data = 1;
  if (h.seg_enabled && h.primary_ref_frame != PRIMARY_REF_NONE) {
    h.seg_update_map = b.f(1);
    h.seg_temporal_update = h.seg_update_map ? (int)b.f(1) : 0;
    update_data = b.f(1);
  }
  if (!h.seg_enabled || update_data) {
    memset(h.feature_enabled, 0, sizeof(h.feature_enabled));
    memset(h.feature_data, 0, sizeof(h.feature_data));
  }
  if (h.seg_enabled && update_data) {
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < SEG_LVL_MAX; ++j) {
        int v = 0;
        h.feature_enabled[i][j] = b.f(1);
        if (h.feature_enabled[i][j]) {
          int bits = kSegFeatureBits[j], lim = kSegFeatureMax[j];
          if (kSegFeatureSigned[j])
            v = clip3(-lim, lim, b.su(1 + bits));
          else
            v = clip3(0, lim, (int)b.f(bits));
        }
        h.feature_data[i][j] = v;
      }
  }
  if (h.seg_enabled)
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < SEG_LVL_MAX; ++j)
        if (h.feature_enabled[i][j]) {
          h.last_active_seg = i;
          if (j >= SEG_LVL_REF_FRAME) h.seg_preskip = 1;
        }
  // delta_q_params, delta_lf_params
  if (h.base_q_idx > 0) h.delta_q_present = b.f(1);
  if (h.delta_q_present) {
    h.delta_q_res = b.f(2);
    if (!h.allow_intrabc) h.delta_lf_present = b.f(1);
    if (h.delta_lf_present) {
      h.delta_lf_res = b.f(2);
      h.delta_lf_multi = b.f(1);
    }
  }
  h.coded_lossless = 1;
  for (int sid = 0; sid < 8; ++sid) {
    int q = h.base_q_idx;
    if (h.seg_enabled && h.feature_enabled[sid][SEG_LVL_ALT_Q])
      q = clip3(0, 255, q + h.feature_data[sid][SEG_LVL_ALT_Q]);
    h.lossless[sid] = q == 0 && !h.dq_ydc && !h.dq_uac && !h.dq_udc &&
                      !h.dq_vac && !h.dq_vdc;
    if (!h.lossless[sid]) h.coded_lossless = 0;
    bool flat = !h.using_qmatrix || h.lossless[sid];
    h.seg_qm_level[0][sid] = flat ? 15 : h.qm_y;
    h.seg_qm_level[1][sid] = flat ? 15 : h.qm_u;
    h.seg_qm_level[2][sid] = flat ? 15 : h.qm_v;
  }
  h.all_lossless = h.coded_lossless && h.width == h.upscaled_width;
  // loop_filter_params, cdef_params and lr_params: none with intra block
  // copy, whose frames are not filtered (and the deltas are the defaults)
  if (h.coded_lossless || h.allow_intrabc) {
    static const int kRefDeltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    memcpy(h.lf_ref_deltas, kRefDeltas, sizeof(kRefDeltas));
    h.lf_mode_deltas[0] = h.lf_mode_deltas[1] = 0;
  } else {
    h.lf_level[0] = b.f(6);
    h.lf_level[1] = b.f(6);
    if (planes > 1 && (h.lf_level[0] || h.lf_level[1])) {
      h.lf_level[2] = b.f(6);
      h.lf_level[3] = b.f(6);
    }
    h.lf_sharpness = b.f(3);
    h.lf_delta_enabled = b.f(1);
    if (h.lf_delta_enabled && b.f(1)) {
      for (int i = 0; i < 8; ++i)
        if (b.f(1)) h.lf_ref_deltas[i] = b.su(7);
      for (int i = 0; i < 2; ++i)
        if (b.f(1)) h.lf_mode_deltas[i] = b.su(7);
    }
  }
  // cdef_params
  if (!h.coded_lossless && !h.allow_intrabc && s.cdef) {
    h.cdef_on = 1;
    h.cdef_damping = b.f(2) + 3;
    h.cdef_bits = b.f(2);
    for (int i = 0; i < (1 << h.cdef_bits); ++i) {
      h.cdef_y_pri[i] = b.f(4);
      h.cdef_y_sec[i] = b.f(2);
      if (h.cdef_y_sec[i] == 3) h.cdef_y_sec[i] = 4;
      if (planes > 1) {
        h.cdef_uv_pri[i] = b.f(4);
        h.cdef_uv_sec[i] = b.f(2);
        if (h.cdef_uv_sec[i] == 3) h.cdef_uv_sec[i] = 4;
      }
    }
  }
  // lr_params
  if (!h.all_lossless && !h.allow_intrabc && s.restoration) {
    static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE,
                                 RESTORE_WIENER, RESTORE_SGRPROJ};
    int chroma_lr = 0;
    for (int i = 0; i < planes; ++i) {
      h.lr_type[i] = remap[b.f(2)];
      if (h.lr_type[i] != RESTORE_NONE) {
        h.uses_lr = 1;
        if (i > 0) chroma_lr = 1;
      }
    }
    if (h.uses_lr) {
      int shift;
      if (s.sb128) {
        shift = b.f(1) + 1;
      } else {
        shift = b.f(1);
        if (shift) shift += b.f(1);
      }
      h.lr_size[0] = 256 >> (2 - shift);
      int uv_shift = (s.ssx && s.ssy && chroma_lr) ? (int)b.f(1) : 0;
      h.lr_size[1] = h.lr_size[2] = h.lr_size[0] >> uv_shift;
    }
  }
  // read_tx_mode
  if (h.coded_lossless)
    h.tx_mode = TX_MODE_ONLY_4X4;
  else
    h.tx_mode = b.f(1) ? TX_MODE_SELECT : TX_MODE_LARGEST;
  if (h.inter) {
    h.reference_select = b.f(1);
    // skip_mode_params: the nearest forward reference and the nearest
    // backward one (or the second nearest forward)
    if (h.reference_select && s.order_hint) {
      int fwd = -1, bwd = -1, fwd_hint = 0, bwd_hint = 0;
      for (int i = 0; i < 7; ++i) {
        int hint = h.order_hints[LAST_FRAME + i];
        int d = get_relative_dist(s, hint, h.order_hint);
        if (d < 0) {
          if (fwd < 0 || get_relative_dist(s, hint, fwd_hint) > 0) {
            fwd = i;
            fwd_hint = hint;
          }
        } else if (d > 0) {
          if (bwd < 0 || get_relative_dist(s, hint, bwd_hint) < 0) {
            bwd = i;
            bwd_hint = hint;
          }
        }
      }
      int allowed = 0;
      if (fwd >= 0 && bwd >= 0) {
        allowed = 1;
        h.skip_mode_frame[0] = LAST_FRAME + std::min(fwd, bwd);
        h.skip_mode_frame[1] = LAST_FRAME + std::max(fwd, bwd);
      } else if (fwd >= 0) {
        int fwd2 = -1, fwd2_hint = 0;
        for (int i = 0; i < 7; ++i) {
          int hint = h.order_hints[LAST_FRAME + i];
          if (get_relative_dist(s, hint, fwd_hint) < 0 &&
              (fwd2 < 0 || get_relative_dist(s, hint, fwd2_hint) > 0)) {
            fwd2 = i;
            fwd2_hint = hint;
          }
        }
        if (fwd2 >= 0) {
          allowed = 1;
          h.skip_mode_frame[0] = LAST_FRAME + std::min(fwd, fwd2);
          h.skip_mode_frame[1] = LAST_FRAME + std::max(fwd, fwd2);
        }
      }
      if (allowed) h.skip_mode_present = b.f(1);
    }
    h.allow_warped_motion =
        (h.error_resilient || !s.warped_motion) ? 0 : (int)b.f(1);
  }
  h.reduced_tx_set = b.f(1);
  // global_motion_params, each parameter read against the primary
  // reference's
  if (h.inter)
    for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ++ref) {
      int type = GM_IDENTITY;
      if (b.f(1)) {
        if (b.f(1))
          type = GM_ROTZOOM;
        else
          type = b.f(1) ? GM_TRANSLATION : GM_AFFINE;
      }
      h.gm_type[ref] = type;
      auto param = [&](int idx) {
        int abs_bits = 12, prec_bits = 15;
        if (idx < 2) {
          if (type == GM_TRANSLATION) {
            abs_bits = 9 - !h.allow_high_precision_mv;
            prec_bits = 3 - !h.allow_high_precision_mv;
          } else {
            abs_bits = 12;
            prec_bits = 6;
          }
        }
        int prec_diff = kWmBits - prec_bits;
        int round = (idx % 3) == 2 ? (1 << kWmBits) : 0;
        int sub = (idx % 3) == 2 ? (1 << prec_bits) : 0;
        int mx = 1 << abs_bits;
        int r = (prev_gm[ref][idx] >> prec_diff) - sub;
        h.gm_params[ref][idx] =
            (header_subexp_with_ref(b, -mx, mx + 1, r) * (1 << prec_diff)) +
            round;
      };
      if (type >= GM_ROTZOOM) {
        param(2);
        param(3);
        if (type == GM_AFFINE) {
          param(4);
          param(5);
        } else {
          h.gm_params[ref][4] = -h.gm_params[ref][3];
          h.gm_params[ref][5] = h.gm_params[ref][2];
        }
      }
      if (type >= GM_TRANSLATION) {
        param(0);
        param(1);
      }
    }
  // film_grain_params: an INTER frame may load a reference's
  if (s.film_grain && (h.show_frame || h.showable) && b.f(1)) {
    h.grain.apply = 1;
    h.grain.seed = b.f(16);
    if (h.frame_type == 1 && !b.f(1)) {  // update_grain 0
      int idx = b.f(3);
      bool listed = false;
      for (int i = 0; i < 7; ++i) listed |= h.ref_frame_idx[i] == idx;
      if (!listed || !slots[idx]) bad("film grain from a slot that is no reference");
      int seed = h.grain.seed;
      h.grain = slots[idx]->grain;
      h.grain.apply = 1;
      h.grain.seed = seed;
    } else {
      parse_film_grain(b, s, h.grain);
    }
  }
}

// ---------------------------------------------------------------------------
// Symbol decoder (spec 8.2), in libaom's windowed form

struct Msac {
  const uint8_t* bptr;
  const uint8_t* end;
  uint64_t dif;
  uint32_t rng;
  int cnt;
  int allow_update;

  void refill() {
    int s = 64 - 9 - (cnt + 15);
    for (; s >= 0 && bptr < end; s -= 8, ++bptr) {
      dif ^= (uint64_t)bptr[0] << s;
      cnt += 8;
    }
    if (bptr >= end) cnt = 0x4000;
  }
  void init(const uint8_t* p, size_t n, int disable_update) {
    bptr = p;
    end = p + n;
    dif = ((uint64_t)1 << 63) - 1;
    rng = 0x8000;
    cnt = -15;
    allow_update = !disable_update;
    refill();
  }
  int normalize(uint64_t d, uint32_t r, int ret) {
    int sh = 15 - floor_log2(r);
    cnt -= sh;
    dif = ((d + 1) << sh) - 1;
    rng = r << sh;
    if (cnt < 0) refill();
    return ret;
  }
  // a symbol of an N-symbol icdf, no adaptation
  int decode(const uint16_t* icdf, int N) {
    uint32_t c = (uint32_t)(dif >> 48);
    uint32_t u, v = rng;
    int ret = -1;
    do {
      u = v;
      ++ret;
      v = ((rng >> 8) * (uint32_t)(icdf[ret] >> 6) >> 1) + 4 * (N - 1 - ret);
    } while (c < v);
    return normalize(dif - ((uint64_t)v << 48), u - v, ret);
  }
  int symbol(uint16_t* cdf, int N) {
    int v = decode(cdf, N);
    if (allow_update) {
      int count = cdf[N];
      int rate = 3 + (count > 15) + (count > 31) + (N > 3 ? 2 : 1);
      for (int i = 0; i < N - 1; ++i) {
        if (i < v)
          cdf[i] = (uint16_t)(cdf[i] + ((32768 - cdf[i]) >> rate));
        else
          cdf[i] = (uint16_t)(cdf[i] - (cdf[i] >> rate));
      }
      cdf[N] = (uint16_t)(count + (count < 32));
    }
    return v;
  }
  int bool_equi() {
    static const uint16_t half[2] = {16384, 0};
    return decode(half, 2);
  }
  int literal(int n) {
    int x = 0;
    for (int i = 0; i < n; ++i) x = 2 * x + bool_equi();
    return x;
  }
  int ns(int n) {
    int w = floor_log2((uint32_t)n) + 1;
    int m = (1 << w) - n;
    int v = literal(w - 1);
    if (v < m) return v;
    return (v << 1) - m + literal(1);
  }
};

// ---------------------------------------------------------------------------
// Inverse transforms (spec 7.13.2), int64 throughout

inline int64_t cos128(int angle) {
  int a = angle & 255;
  if (a <= 64) return g_cos128[a];
  if (a <= 128) return -g_cos128[128 - a];
  if (a <= 192) return -g_cos128[a - 128];
  return g_cos128[256 - a];
}
inline int64_t sin128(int angle) { return cos128(angle - 64); }

inline void B(int64_t* T, int a, int b, int angle, int flip) {
  int64_t x = T[a] * cos128(angle) - T[b] * sin128(angle);
  int64_t y = T[a] * sin128(angle) + T[b] * cos128(angle);
  T[a] = round2l(x, 12);
  T[b] = round2l(y, 12);
  if (flip) std::swap(T[a], T[b]);
}
inline void H(int64_t* T, int a, int b, int flip) {
  if (flip) std::swap(a, b);
  int64_t x = T[a], y = T[b];
  T[a] = x + y;
  T[b] = x - y;
}
inline int brev(int bits, int x) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

void idct(int64_t* T, int n) {
  int n0 = 1 << n;
  int64_t copy[64];
  memcpy(copy, T, n0 * sizeof(int64_t));
  for (int i = 0; i < n0; ++i) T[i] = copy[brev(n, i)];
  if (n == 6)
    for (int i = 0; i < 16; ++i) B(T, 32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
  if (n >= 5)
    for (int i = 0; i < 8; ++i)
      B(T, 16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
  if (n == 6)
    for (int i = 0; i < 16; ++i) H(T, 32 + i * 2, 33 + i * 2, i & 1);
  if (n >= 4)
    for (int i = 0; i < 4; ++i)
      B(T, 8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
  if (n >= 5)
    for (int i = 0; i < 8; ++i) H(T, 16 + 2 * i, 17 + 2 * i, i & 1);
  if (n == 6)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 2; ++j)
        B(T, 62 - i * 4 - j, 33 + i * 4 + j,
          60 - 16 * brev(2, i) + 64 * j, 1);
  if (n >= 3)
    for (int i = 0; i < 2; ++i) B(T, 4 + i, 7 - i, 56 - 32 * i, 0);
  if (n >= 4)
    for (int i = 0; i < 4; ++i) H(T, 8 + 2 * i, 9 + 2 * i, i & 1);
  if (n >= 5)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        B(T, 30 - 4 * i - j, 17 + 4 * i + j,
          24 + (j << 6) + ((1 - i) << 5), 1);
  if (n == 6)
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 2; ++j) H(T, 32 + i * 4 + j, 35 + i * 4 - j, i & 1);
  for (int i = 0; i < 2; ++i) B(T, 2 * i, 2 * i + 1, 32 + 16 * i, 1 - i);
  if (n >= 3)
    for (int i = 0; i < 2; ++i) H(T, 4 + 2 * i, 5 + 2 * i, i);
  if (n >= 4)
    for (int i = 0; i < 2; ++i) B(T, 14 - i, 9 + i, 48 + 64 * i, 1);
  if (n >= 5)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 2; ++j) H(T, 16 + 4 * i + j, 19 + 4 * i - j, i & 1);
  if (n == 6)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j)
        B(T, 61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
  for (int i = 0; i < 2; ++i) H(T, i, 3 - i, 0);
  if (n >= 3) B(T, 6, 5, 32, 1);
  if (n >= 4)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) H(T, 8 + 4 * i + j, 11 + 4 * i - j, i);
  if (n >= 5)
    for (int i = 0; i < 4; ++i) B(T, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
  if (n == 6)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) H(T, 32 + 8 * i + j, 39 + 8 * i - j, i & 1);
  if (n >= 3)
    for (int i = 0; i < 4; ++i) H(T, i, 7 - i, 0);
  if (n >= 4)
    for (int i = 0; i < 2; ++i) B(T, 13 - i, 10 + i, 32, 1);
  if (n >= 5)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) H(T, 16 + i * 8 + j, 23 + i * 8 - j, i);
  if (n == 6)
    for (int i = 0; i < 8; ++i) B(T, 59 - i, 36 + i, i < 4 ? 48 : 112, 1);
  if (n >= 4)
    for (int i = 0; i < 8; ++i) H(T, i, 15 - i, 0);
  if (n >= 5)
    for (int i = 0; i < 4; ++i) B(T, 27 - i, 20 + i, 32, 1);
  if (n == 6) {
    for (int i = 0; i < 8; ++i) H(T, 32 + i, 47 - i, 0);
    for (int i = 0; i < 8; ++i) H(T, 48 + i, 63 - i, 1);
  }
  if (n >= 5)
    for (int i = 0; i < 16; ++i) H(T, i, 31 - i, 0);
  if (n == 6)
    for (int i = 0; i < 8; ++i) B(T, 55 - i, 40 + i, 32, 1);
  if (n == 6)
    for (int i = 0; i < 32; ++i) H(T, i, 63 - i, 0);
}

inline int64_t hbtf(int w0, int64_t x0, int w1, int64_t x1) {
  return round2l((int64_t)w0 * x0 + (int64_t)w1 * x1, 12);
}

void iadst4(int64_t* T) {
  static const int64_t S1 = 1321, S2 = 2482, S3 = 3344, S4 = 3803;
  int64_t s0 = S1 * T[0], s1 = S2 * T[0], s2 = S3 * T[1], s3 = S4 * T[2];
  int64_t s4 = S1 * T[2], s5 = S2 * T[3], s6 = S4 * T[3];
  int64_t a7 = T[0] - T[2];
  int64_t b7 = a7 + T[3];
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = S3 * b7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  int64_t x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1;
  x3 = x3 - s3;
  T[0] = round2l(x0, 12);
  T[1] = round2l(x1, 12);
  T[2] = round2l(x2, 12);
  T[3] = round2l(x3, 12);
}

void iadst8(int64_t* T) {
  const int* c = g_cos128;
  int64_t b[8], a[8];
  b[0] = T[7]; b[1] = T[0]; b[2] = T[5]; b[3] = T[2];
  b[4] = T[3]; b[5] = T[4]; b[6] = T[1]; b[7] = T[6];
  a[0] = hbtf(c[4], b[0], c[60], b[1]);
  a[1] = hbtf(c[60], b[0], -c[4], b[1]);
  a[2] = hbtf(c[20], b[2], c[44], b[3]);
  a[3] = hbtf(c[44], b[2], -c[20], b[3]);
  a[4] = hbtf(c[36], b[4], c[28], b[5]);
  a[5] = hbtf(c[28], b[4], -c[36], b[5]);
  a[6] = hbtf(c[52], b[6], c[12], b[7]);
  a[7] = hbtf(c[12], b[6], -c[52], b[7]);
  for (int i = 0; i < 4; ++i) {
    b[i] = a[i] + a[i + 4];
    b[i + 4] = a[i] - a[i + 4];
  }
  a[0] = b[0]; a[1] = b[1]; a[2] = b[2]; a[3] = b[3];
  a[4] = hbtf(c[16], b[4], c[48], b[5]);
  a[5] = hbtf(c[48], b[4], -c[16], b[5]);
  a[6] = hbtf(-c[48], b[6], c[16], b[7]);
  a[7] = hbtf(c[16], b[6], c[48], b[7]);
  b[0] = a[0] + a[2]; b[1] = a[1] + a[3]; b[2] = a[0] - a[2];
  b[3] = a[1] - a[3]; b[4] = a[4] + a[6]; b[5] = a[5] + a[7];
  b[6] = a[4] - a[6]; b[7] = a[5] - a[7];
  a[0] = b[0]; a[1] = b[1]; a[4] = b[4]; a[5] = b[5];
  a[2] = hbtf(c[32], b[2], c[32], b[3]);
  a[3] = hbtf(c[32], b[2], -c[32], b[3]);
  a[6] = hbtf(c[32], b[6], c[32], b[7]);
  a[7] = hbtf(c[32], b[6], -c[32], b[7]);
  T[0] = a[0]; T[1] = -a[4]; T[2] = a[6]; T[3] = -a[2];
  T[4] = a[3]; T[5] = -a[7]; T[6] = a[5]; T[7] = -a[1];
}

void iadst16(int64_t* T) {
  const int* c = g_cos128;
  int64_t b[16], a[16];
  static const int in_idx[16] = {15, 0, 13, 2, 11, 4, 9, 6,
                                 7, 8, 5, 10, 3, 12, 1, 14};
  for (int i = 0; i < 16; ++i) b[i] = T[in_idx[i]];
  static const int ang[8] = {2, 10, 18, 26, 34, 42, 50, 58};
  for (int i = 0; i < 8; ++i) {
    int k = ang[i];
    a[2 * i] = hbtf(c[k], b[2 * i], c[64 - k], b[2 * i + 1]);
    a[2 * i + 1] = hbtf(c[64 - k], b[2 * i], -c[k], b[2 * i + 1]);
  }
  for (int i = 0; i < 8; ++i) {
    b[i] = a[i] + a[i + 8];
    b[i + 8] = a[i] - a[i + 8];
  }
  for (int i = 0; i < 8; ++i) a[i] = b[i];
  a[8] = hbtf(c[8], b[8], c[56], b[9]);
  a[9] = hbtf(c[56], b[8], -c[8], b[9]);
  a[10] = hbtf(c[40], b[10], c[24], b[11]);
  a[11] = hbtf(c[24], b[10], -c[40], b[11]);
  a[12] = hbtf(-c[56], b[12], c[8], b[13]);
  a[13] = hbtf(c[8], b[12], c[56], b[13]);
  a[14] = hbtf(-c[24], b[14], c[40], b[15]);
  a[15] = hbtf(c[40], b[14], c[24], b[15]);
  for (int g = 0; g < 16; g += 8)
    for (int i = 0; i < 4; ++i) {
      b[g + i] = a[g + i] + a[g + i + 4];
      b[g + i + 4] = a[g + i] - a[g + i + 4];
    }
  for (int g = 0; g < 16; g += 8) {
    a[g + 0] = b[g + 0]; a[g + 1] = b[g + 1];
    a[g + 2] = b[g + 2]; a[g + 3] = b[g + 3];
    a[g + 4] = hbtf(c[16], b[g + 4], c[48], b[g + 5]);
    a[g + 5] = hbtf(c[48], b[g + 4], -c[16], b[g + 5]);
    a[g + 6] = hbtf(-c[48], b[g + 6], c[16], b[g + 7]);
    a[g + 7] = hbtf(c[16], b[g + 6], c[48], b[g + 7]);
  }
  for (int g = 0; g < 16; g += 4) {
    b[g + 0] = a[g + 0] + a[g + 2];
    b[g + 1] = a[g + 1] + a[g + 3];
    b[g + 2] = a[g + 0] - a[g + 2];
    b[g + 3] = a[g + 1] - a[g + 3];
  }
  for (int g = 0; g < 16; g += 4) {
    a[g + 0] = b[g + 0];
    a[g + 1] = b[g + 1];
    a[g + 2] = hbtf(c[32], b[g + 2], c[32], b[g + 3]);
    a[g + 3] = hbtf(c[32], b[g + 2], -c[32], b[g + 3]);
  }
  T[0] = a[0]; T[1] = -a[8]; T[2] = a[12]; T[3] = -a[4];
  T[4] = a[6]; T[5] = -a[14]; T[6] = a[10]; T[7] = -a[2];
  T[8] = a[3]; T[9] = -a[11]; T[10] = a[15]; T[11] = -a[7];
  T[12] = a[5]; T[13] = -a[13]; T[14] = a[9]; T[15] = -a[1];
}

void iidentity(int64_t* T, int n) {
  int n0 = 1 << n;
  for (int i = 0; i < n0; ++i) {
    if (n == 2) T[i] = round2l(T[i] * 5793, 12);
    else if (n == 3) T[i] = T[i] * 2;
    else if (n == 4) T[i] = round2l(T[i] * 11586, 12);
    else T[i] = T[i] * 4;
  }
}

void iwht(int64_t* T, int shift) {
  int64_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift,
          b = T[3] >> shift;
  a += c;
  d -= b;
  int64_t e = (a - d) >> 1;
  b = e - b;
  c = e - c;
  a -= b;
  d += c;
  T[0] = a; T[1] = b; T[2] = c; T[3] = d;
}

enum { T1D_DCT, T1D_ADST, T1D_IDTX };

void tx1d(int64_t* T, int kind, int n) {
  if (kind == T1D_IDTX) return iidentity(T, n);
  if (kind == T1D_DCT) return idct(T, n);
  if (n == 2) return iadst4(T);
  if (n == 3) return iadst8(T);
  return iadst16(T);
}

// ---------------------------------------------------------------------------
// Frame state

template <typename Pixel>
struct Plane {
  std::vector<Pixel> buf;
  int stride = 0;
  Pixel* row(int y) { return buf.data() + (size_t)y * stride; }
  Pixel& at(int x, int y) { return buf[(size_t)y * stride + x]; }
};

struct LrUnit {
  int8_t type;
  int8_t wiener[2][3];
  int8_t sgr_set;
  int16_t xqd[2];
};

// The headers and what the tiles write beside the samples: the same for
// every bit depth.
struct FrameInfo {
  SeqHdr seq;
  FrameHdr fh;
  int planes = 3, ssx = 1, ssy = 1;
  int mi_rows = 0, mi_cols = 0;
  int bitdepth = 8;
  // MI arrays
  std::vector<uint8_t> mi_size, skips, inter_tx_sizes, y_modes, uv_modes,
      seg_ids, is_inters;
  std::vector<int8_t> delta_lfs;  // 4 per MI
  // frames with intra block copy only: the luma TxTypes (chroma of an
  // intrabc block takes its co-located one) and each MI's vector
  std::vector<uint8_t> tx_types;
  std::vector<int16_t> mvs;  // row, column
  std::vector<uint8_t> lf_tx[3];  // per plane 4x4 unit
  int lf_tx_stride[3] = {0, 0, 0};
  std::vector<int8_t> cdef_idx;  // per 64x64
  int cdef_stride = 0;
  std::vector<LrUnit> lr[3];
  int lr_rows[3] = {0, 0, 0}, lr_cols[3] = {0, 0, 0};
  // inter frames: each MI's references (RefFrames, INTRA_FRAME and
  // NONE_FRAME for an intra block), vectors ([list][row, column]),
  // interpolation filters ([0] vertical, [1] horizontal), skip_mode and
  // seg_id_predicted
  std::vector<int8_t> ref_frames;
  std::vector<int32_t> mvs4;
  std::vector<uint8_t> interp, skip_modes, seg_preds, comp_groups, comp_idxs;
  // PrevSegmentIds (empty: all 0)
  std::vector<uint8_t> prev_seg_ids;
  // the projected motion field (7.9), per 8x8: the vector and its
  // reference's distance (libaom's mfmv0 and ref_frame_offset; 0 where
  // no vector lands)
  std::vector<int32_t> tpl_mv;
  std::vector<int8_t> tpl_off;
  // the frame's CDFs at its start, and at its end (the
  // context_update_tile_id tile's)
  Cdfs init_cdf, end_cdf;

  uint8_t& MI(std::vector<uint8_t>& v, int r, int c) {
    return v[(size_t)r * mi_cols + c];
  }
};

// A frame in a reference slot (7.20): its planes after the in-loop
// filters and before film grain, at the upscaled width; its header (sizes,
// order hints, global motion, ...); its frame-end CDFs, segment ids and
// the vectors the motion field of later frames projects (MfRefFrames,
// MfMvs, 7.19; an intra frame has none)
// get_mv_projection: a vector of the motion field scaled from the
// distance `den` of its own reference to `num` (Div_Mult is 16384 / den)
inline void mv_projection(const int32_t* mv, int num, int den, int* out) {
  den = std::min(den, 31);
  num = clip3(-31, 31, num);
  for (int i = 0; i < 2; ++i) {
    int64_t v = (int64_t)mv[i] * num * (16384 / den);
    int64_t a = v < 0 ? -v : v;
    int r = (int)((a + (1 << 13)) >> 14);
    out[i] = clip3(-(1 << 14) + 1, (1 << 14) - 1, v < 0 ? -r : r);
  }
}

template <typename Pixel>
struct RefPic {
  FrameHdr fh;
  Plane<Pixel> planes[3];
  Cdfs cdf;
  int mi_rows = 0, mi_cols = 0;
  std::vector<uint8_t> seg_ids;
  std::vector<int8_t> mf_ref;
  std::vector<int32_t> mf_mv;
};

template <typename Pixel>
struct Decoder : FrameInfo {
  Plane<Pixel> cur[3];
  int pmax = 255;  // (1 << BitDepth) - 1
  // an inter frame's references, by reference frame (LAST_FRAME ..
  // ALTREF_FRAME), and their scale factors (xScale, yScale of 7.11.3.3)
  const RefPic<Pixel>* refs[8] = {nullptr};
  int x_scale[8] = {0}, y_scale[8] = {0};

  // Clip1 of the spec
  Pixel clip1(int v) const {
    if (sizeof(Pixel) == 1) return (Pixel)(v < 0 ? 0 : v > 255 ? 255 : v);
    return (Pixel)(v < 0 ? 0 : v > pmax ? pmax : v);
  }
  void alloc() {
    planes = seq.mono ? 1 : 3;
    ssx = seq.ssx;
    ssy = seq.ssy;
    bitdepth = seq.bitdepth;
    pmax = (1 << bitdepth) - 1;
    mi_rows = fh.mi_rows;
    mi_cols = fh.mi_cols;
    size_t n = (size_t)mi_rows * mi_cols;
    mi_size.assign(n, 0);
    skips.assign(n, 0);
    inter_tx_sizes.assign(n, 0);
    y_modes.assign(n, 0);
    uv_modes.assign(n, 0);
    seg_ids.assign(n, 0);
    is_inters.assign(n, 0);
    delta_lfs.assign(n * 4, 0);
    if (fh.allow_intrabc) {
      tx_types.assign(n, 0);
      mvs.assign(n * 2, 0);
    }
    if (fh.inter) {
      tx_types.assign(n, 0);
      ref_frames.assign(n * 2, 0);
      mvs4.assign(n * 4, 0);
      interp.assign(n * 2, 0);
      skip_modes.assign(n, 0);
      seg_preds.assign(n, 0);
      comp_groups.assign(n, 0);
      comp_idxs.assign(n, 0);
    }
    cdef_stride = (mi_cols + 15) >> 4;
    cdef_idx.assign((size_t)cdef_stride * ((mi_rows + 15) >> 4), -1);
    for (int p = 0; p < planes; ++p) {
      int sx = p ? ssx : 0, sy = p ? ssy : 0;
      int w = (mi_cols * 4) >> sx, hh = (mi_rows * 4) >> sy;
      cur[p].stride = w + 160;
      cur[p].buf.assign((size_t)cur[p].stride * (hh + 160), 0);
      lf_tx_stride[p] = (w >> 2) + 32;
      lf_tx[p].assign((size_t)lf_tx_stride[p] * ((hh >> 2) + 32), 0);
    }
  }
};

inline int count_units(int unit, int size) {
  return std::max((size + (unit >> 1)) / unit, 1);
}

// ---------------------------------------------------------------------------
// Tile decoding

template <typename Pixel>
struct Tile {
  Decoder<Pixel>& d;
  const FrameHdr& fh;
  Cdfs cdf;
  Msac ms;
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  int current_q;
  int delta_lf[4];
  int ref_sgr_xqd[3][2];
  int ref_wiener[3][2][3];
  // entropy contexts, absolute indices in each plane's 4x4 units
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3],
      left_dc[3];
  // BlockDecoded[plane][-1..32][-1..32]
  uint8_t block_decoded[3][35][35];
  // the current block
  int mi_row, mi_col, mi_sz, bw4, bh4;
  int has_chroma, avail_u, avail_l, avail_u_chroma, avail_l_chroma;
  int skip, segment_id, lossless, read_deltas;
  int y_mode, uv_mode, angle_delta_y, angle_delta_uv;
  int cfl_alpha_u, cfl_alpha_v;
  int use_filter_intra, filter_intra_mode;
  int tx_size;
  int max_luma_w, max_luma_h;
  int partition;  // the parent's, for has_top_right
  // palette: the block's sizes, colours (Y, U, V) and colour index maps;
  // the sizes and colours of the blocks above and to the left, by MI
  // column and row (8 colours each), for the caches
  int pal_size_y, pal_size_uv;
  uint16_t pal_colors[3][8];
  int map_w[2];
  uint8_t color_map[2][64 * 64];
  std::vector<uint8_t> above_pal_n[2], left_pal_n[2];
  std::vector<uint16_t> above_pal[2], left_pal[2];
  // intra block copy
  int use_intrabc, is_inter;
  int mv[2];  // row, column in 1/8 samples
  int num_mv;
  // blocks of the tile that code a palette (Y or UV) and intra block copy
  int n_palette = 0, n_intrabc = 0;
  int stack_mv[8][2];
  int stack_weight[8];
  // coefficient scratch
  int32_t quant[1024];
  int64_t resid[64 * 64];
  // intra block copy's horizontal pass, (128 + 1) x 128
  int32_t inter_buf[129 * 128];
  // inter frames: the block's references, vectors ([list][row, column]),
  // interpolation filters ([0] vertical, [1] horizontal), motion mode,
  // interintra, skip_mode and seg_id_predicted; the neighbours'
  // references
  int ref_frame[2] = {0, -1};
  int bmv[2][2];
  int interp_filter[2];
  int motion_mode = 0, interintra = 0, interintra_mode = 0;
  int wedge_interintra = 0, wedge_index = 0, skip_mode = 0;
  int seg_id_predicted = 0;
  int left_ref[2], above_ref[2], left_intra, above_intra;
  // compound prediction: the type, its mask's wedge or difference weights
  int is_compound = 0, compound_type = 0, comp_group_idx = 0;
  int compound_idx = 1, wedge_sign = 0, mask_type = 0;
  uint8_t diff_mask[128 * 128];
  // the motion vector stack (7.10.2) and its contexts, [idx][list]
  int num_mv_found, new_mv_count, found_match;
  int ref_stack[8][2][2];
  int weight_stack[8], drl_ctx[8];
  int global_mvs[2][2];
  int new_mv_ctx, ref_mv_ctx, zero_mv_ctx, ref_mv_idx;
  // local warp: the samples and the model
  int num_samples, num_samples_scanned;
  int cand_list[8][4];
  int local_warp[6];
  int local_valid = 0;
  // the blocks of the tile that used each tool (ToolCounts), and the
  // temporal candidates it found
  int n_tool[kNumTools] = {0};
  int n_temporal = 0;
  // inter prediction scratch: predictions, the horizontal pass of a
  // (scaled) block
  int32_t preds[2][128 * 128];
  int32_t inter_tmp[(2 * 128 + 16) * 128];

  Tile(Decoder<Pixel>& dd) : d(dd), fh(dd.fh) {}

  int is_inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start &&
           r < mi_row_end;
  }
  uint8_t& bd(int plane, int y, int x) {
    return block_decoded[plane][y + 1][x + 1];
  }

  // -- superblock-level --------------------------------------------------
  void clear_block_decoded_flags(int r, int c, int sb4) {
    for (int p = 0; p < d.planes; ++p) {
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      int sbw4 = (mi_col_end - c) >> sx;
      int sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); ++y)
        for (int x = -1; x <= (sb4 >> sx); ++x) {
          if (y < 0 && x < sbw4)
            bd(p, y, x) = 1;
          else if (x < 0 && y < sbh4)
            bd(p, y, x) = 1;
          else
            bd(p, y, x) = 0;
        }
      bd(p, sb4 >> sy, -1) = 0;
    }
  }

  int decode_signed_subexp_with_ref(int low, int high, int k, int r) {
    int x = decode_unsigned_subexp_with_ref(high - low, k, r - low);
    return x + low;
  }
  int decode_unsigned_subexp_with_ref(int mx, int k, int r) {
    int v = decode_subexp(mx, k);
    if ((r << 1) <= mx) return inverse_recenter(r, v);
    return mx - 1 - inverse_recenter(mx - 1 - r, v);
  }
  int decode_subexp(int num_syms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (num_syms <= mk + 3 * a) return ms.ns(num_syms - mk) + mk;
      if (ms.literal(1)) {
        ++i;
        mk += a;
      } else {
        return ms.literal(b2) + mk;
      }
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }

  void read_lr_unit(int plane, int unit_row, int unit_col) {
    LrUnit& u = d.lr[plane][(size_t)unit_row * d.lr_cols[plane] + unit_col];
    int t = fh.lr_type[plane];
    int rtype;
    if (t == RESTORE_WIENER)
      rtype = ms.symbol(cdf.wiener_restore, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (t == RESTORE_SGRPROJ)
      rtype = ms.symbol(cdf.sgrproj_restore, 2) ? RESTORE_SGRPROJ
                                                : RESTORE_NONE;
    else
      rtype = ms.symbol(cdf.switchable_restore, 3);
    u.type = (int8_t)rtype;
    if (rtype == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; ++pass) {
        int first = 0;
        if (plane) {
          first = 1;
          u.wiener[pass][0] = 0;
        }
        for (int j = first; j < 3; ++j) {
          int v = decode_signed_subexp_with_ref(
              kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j],
              ref_wiener[plane][pass][j]);
          u.wiener[pass][j] = (int8_t)v;
          ref_wiener[plane][pass][j] = v;
        }
      }
    } else if (rtype == RESTORE_SGRPROJ) {
      int set = ms.literal(4);
      u.sgr_set = (int8_t)set;
      for (int i = 0; i < 2; ++i) {
        int radius = g_tab.sgr[set][i * 2];
        int mn = kSgrprojXqdMin[i], mx = kSgrprojXqdMax[i];
        int v;
        if (radius) {
          v = decode_signed_subexp_with_ref(mn, mx + 1, 4,
                                            ref_sgr_xqd[plane][i]);
        } else {
          v = 0;
          if (i == 1) v = clip3(mn, mx, 128 - ref_sgr_xqd[plane][0]);
        }
        u.xqd[i] = (int16_t)v;
        ref_sgr_xqd[plane][i] = v;
      }
    }
  }

  void read_lr(int r, int c, int bsize) {
    int w = kNum4x4W[bsize], h = kNum4x4H[bsize];
    for (int p = 0; p < d.planes; ++p) {
      if (fh.lr_type[p] == RESTORE_NONE) continue;
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      int unit = fh.lr_size[p];
      int rows = d.lr_rows[p], cols = d.lr_cols[p];
      int row_start = (r * (4 >> sy) + unit - 1) / unit;
      int row_end = std::min(rows, ((r + h) * (4 >> sy) + unit - 1) / unit);
      // the columns in the upscaled frame (5.11.57)
      int num = (4 >> sx) * (fh.use_superres ? fh.superres_denom : 8);
      int den = unit * 8;
      int col_start = (c * num + den - 1) / den;
      int col_end = std::min(cols, ((c + w) * num + den - 1) / den);
      for (int ur = row_start; ur < row_end; ++ur)
        for (int uc = col_start; uc < col_end; ++uc) read_lr_unit(p, ur, uc);
    }
  }

  void decode() {
    const int planes = d.planes;
    for (int p = 0; p < planes; ++p) {
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      size_t wc = ((size_t)d.mi_cols >> sx) + 40;
      size_t hc = ((size_t)d.mi_rows >> sy) + 40;
      above_level[p].assign(wc, 0);
      above_dc[p].assign(wc, 0);
      left_level[p].assign(hc, 0);
      left_dc[p].assign(hc, 0);
    }
    if (fh.allow_sct)
      for (int p = 0; p < 2; ++p) {
        above_pal_n[p].assign((size_t)d.mi_cols + 32, 0);
        above_pal[p].assign(((size_t)d.mi_cols + 32) * 8, 0);
        left_pal_n[p].assign((size_t)d.mi_rows + 32, 0);
        left_pal[p].assign(((size_t)d.mi_rows + 32) * 8, 0);
      }
    for (int i = 0; i < 4; ++i) delta_lf[i] = 0;
    for (int p = 0; p < planes; ++p) {
      ref_sgr_xqd[p][0] = -32;
      ref_sgr_xqd[p][1] = 31;
      for (int pass = 0; pass < 2; ++pass) {
        ref_wiener[p][pass][0] = 3;
        ref_wiener[p][pass][1] = -7;
        ref_wiener[p][pass][2] = 15;
      }
    }
    int sb_size = d.seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    int sb4 = kNum4x4W[sb_size];
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < planes; ++p) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = fh.delta_q_present;
        // clear_cdef
        int cr = r >> 4, cc = c >> 4;
        d.cdef_idx[(size_t)cr * d.cdef_stride + cc] = -1;
        if (d.seq.sb128) {
          if (cc + 1 < d.cdef_stride)
            d.cdef_idx[(size_t)cr * d.cdef_stride + cc + 1] = -1;
          if ((size_t)(cr + 1) * d.cdef_stride < d.cdef_idx.size()) {
            d.cdef_idx[(size_t)(cr + 1) * d.cdef_stride + cc] = -1;
            if (cc + 1 < d.cdef_stride)
              d.cdef_idx[(size_t)(cr + 1) * d.cdef_stride + cc + 1] = -1;
          }
        }
        clear_block_decoded_flags(r, c, sb4);
        read_lr(r, c, sb_size);
        decode_partition(r, c, sb_size);
      }
    }
  }

  // -- partitions ----------------------------------------------------------
  void decode_partition(int r, int c, int bsize) {
    if (r >= d.mi_rows || c >= d.mi_cols) return;
    int avail_u = is_inside(r - 1, c), avail_l = is_inside(r, c - 1);
    int num4x4 = kNum4x4W[bsize];
    int half = num4x4 >> 1, quarter = half >> 1;
    int has_rows = (r + half) < d.mi_rows;
    int has_cols = (c + half) < d.mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int bsl = kMiWLog2[bsize];
      int above = avail_u && kMiWLog2[d.MI(d.mi_size, r - 1, c)] < bsl;
      int left = avail_l && kMiHLog2[d.MI(d.mi_size, r, c - 1)] < bsl;
      int ctx = left * 2 + above;
      int cls = bsize == BLOCK_8X8     ? 0
                : bsize == BLOCK_16X16 ? 1
                : bsize == BLOCK_32X32 ? 2
                : bsize == BLOCK_64X64 ? 3
                                       : 4;
      uint16_t* pcdf = cdf.partition[cls * 4 + ctx];
      int nsym = cls == 0 ? 4 : cls == 4 ? 8 : 10;
      auto prob = [&](int e) {
        return (e > 0 ? pcdf[e - 1] : 32768) - pcdf[e];
      };
      if (has_rows && has_cols) {
        partition = ms.symbol(pcdf, nsym);
      } else if (has_cols) {
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT);
        if (bsize != BLOCK_8X8)
          psum += prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
                  prob(PARTITION_VERT_B);
        if (bsize != BLOCK_8X8 && bsize != BLOCK_128X128)
          psum += prob(PARTITION_VERT_4);
        uint16_t bcdf[2] = {(uint16_t)psum, 0};
        partition = ms.decode(bcdf, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
      } else if (has_rows) {
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT);
        if (bsize != BLOCK_8X8)
          psum += prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
                  prob(PARTITION_VERT_A);
        if (bsize != BLOCK_8X8 && bsize != BLOCK_128X128)
          psum += prob(PARTITION_HORZ_4);
        uint16_t bcdf[2] = {(uint16_t)psum, 0};
        partition = ms.decode(bcdf, 2) ? PARTITION_SPLIT : PARTITION_VERT;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int sub = kSubsize[partition][bsize];
    int split = kSubsize[PARTITION_SPLIT][bsize];
    if (sub == BLOCK_INVALID) bad("partition");
    switch (partition) {
      case PARTITION_NONE:
        decode_block(r, c, sub, partition);
        break;
      case PARTITION_HORZ:
        decode_block(r, c, sub, partition);
        if (has_rows) decode_block(r + half, c, sub, partition);
        break;
      case PARTITION_VERT:
        decode_block(r, c, sub, partition);
        if (has_cols) decode_block(r, c + half, sub, partition);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split, partition);
        decode_block(r, c + half, split, partition);
        decode_block(r + half, c, sub, partition);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, sub, partition);
        decode_block(r + half, c, split, partition);
        decode_block(r + half, c + half, split, partition);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split, partition);
        decode_block(r + half, c, split, partition);
        decode_block(r, c + half, sub, partition);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, sub, partition);
        decode_block(r, c + half, split, partition);
        decode_block(r + half, c + half, split, partition);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || r + quarter * 3 < d.mi_rows)
            decode_block(r + quarter * i, c, sub, partition);
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || c + quarter * 3 < d.mi_cols)
            decode_block(r, c + quarter * i, sub, partition);
        break;
    }
  }

  // -- mode info -----------------------------------------------------------
  int seg_feature_active(int feature) const {
    return fh.seg_enabled && fh.feature_enabled[segment_id][feature];
  }
  int get_qindex(int ignore_delta_q) const {
    if (seg_feature_active(SEG_LVL_ALT_Q)) {
      int data = fh.feature_data[segment_id][SEG_LVL_ALT_Q];
      int q = fh.base_q_idx + data;
      if (!ignore_delta_q && fh.delta_q_present) q = current_q + data;
      return clip3(0, 255, q);
    }
    if (!ignore_delta_q && fh.delta_q_present) return current_q;
    return fh.base_q_idx;
  }

  void read_segment_id() {
    int prev_ul = -1, prev_u = -1, prev_l = -1;
    if (avail_u && avail_l)
      prev_ul = d.MI(d.seg_ids, mi_row - 1, mi_col - 1);
    if (avail_u) prev_u = d.MI(d.seg_ids, mi_row - 1, mi_col);
    if (avail_l) prev_l = d.MI(d.seg_ids, mi_row, mi_col - 1);
    int ctx;
    if (prev_ul < 0)
      ctx = 0;
    else if (prev_ul == prev_u && prev_ul == prev_l)
      ctx = 2;
    else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l)
      ctx = 1;
    else
      ctx = 0;
    int pred;
    if (prev_u == -1)
      pred = prev_l == -1 ? 0 : prev_l;
    else if (prev_l == -1)
      pred = prev_u;
    else
      pred = prev_ul == prev_u ? prev_u : prev_l;
    if (skip) {
      segment_id = pred;
      return;
    }
    int v = ms.symbol(cdf.segment_id[ctx], 8);
    int mx = fh.last_active_seg + 1;
    // neg_deinterleave
    int out;
    if (!pred)
      out = v;
    else if (pred >= mx - 1)
      out = mx - v - 1;
    else if (2 * pred < mx) {
      if (v <= 2 * pred)
        out = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
      else
        out = v;
    } else {
      if (v <= 2 * (mx - pred - 1))
        out = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
      else
        out = mx - (v + 1);
    }
    segment_id = clip3(0, fh.last_active_seg, out);
  }

  void intra_segment_id() {
    if (fh.seg_enabled)
      read_segment_id();
    else
      segment_id = 0;
    lossless = fh.lossless[segment_id];
  }

  void read_cdef() {
    if (skip || fh.coded_lossless || !d.seq.cdef || fh.allow_intrabc) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    int8_t& idx = d.cdef_idx[(size_t)(r >> 4) * d.cdef_stride + (c >> 4)];
    if (idx == -1) {
      idx = (int8_t)ms.literal(fh.cdef_bits);
      int w4 = kNum4x4W[mi_sz], h4 = kNum4x4H[mi_sz];
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16)
          if ((y >> 4) < ((d.mi_rows + 15) >> 4) && (x >> 4) < d.cdef_stride)
            d.cdef_idx[(size_t)(y >> 4) * d.cdef_stride + (x >> 4)] = idx;
    }
  }

  void read_delta_qindex() {
    int sb_size = d.seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_sz == sb_size && skip) return;
    if (read_deltas) {
      int abs = ms.symbol(cdf.delta_q, 4);
      if (abs == 3) {
        int rem = ms.literal(3) + 1;
        abs = ms.literal(rem) + (1 << rem) + 1;
      }
      if (abs) {
        int sign = ms.literal(1);
        int reduced = sign ? -abs : abs;
        current_q = clip3(1, 255, current_q + reduced * (1 << fh.delta_q_res));
      }
    }
  }

  void read_delta_lf() {
    int sb_size = d.seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_sz == sb_size && skip) return;
    if (read_deltas && fh.delta_lf_present) {
      int count = 1;
      if (fh.delta_lf_multi) count = d.planes > 1 ? 4 : 2;
      for (int i = 0; i < count; ++i) {
        uint16_t* c = fh.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
        int abs = ms.symbol(c, 4);
        if (abs == 3) {
          int n = ms.literal(3) + 1;
          abs = ms.literal(n) + (1 << n) + 1;
        }
        if (abs) {
          int sign = ms.literal(1);
          int reduced = sign ? -abs : abs;
          delta_lf[i] =
              clip3(-63, 63, delta_lf[i] + reduced * (1 << fh.delta_lf_res));
        }
      }
    }
  }

  static int is_directional(int mode) {
    return mode >= V_PRED && mode <= D67_PRED;
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (fh.seg_preskip) intra_segment_id();
    read_skip();
    if (!fh.seg_preskip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = 0;
    use_intrabc = fh.allow_intrabc ? ms.symbol(cdf.intrabc, 2) : 0;
    is_inter = use_intrabc;
    y_mode = uv_mode = DC_PRED;
    angle_delta_y = angle_delta_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    pal_size_y = pal_size_uv = 0;
    use_filter_intra = 0;
    if (use_intrabc) {
      find_mv_stack();
      assign_mv();
      return;
    }
    // intra_frame_y_mode
    int above = avail_u ? d.MI(d.y_modes, mi_row - 1, mi_col) : DC_PRED;
    int left = avail_l ? d.MI(d.y_modes, mi_row, mi_col - 1) : DC_PRED;
    y_mode = ms.symbol(
        cdf.kf_y_mode[kIntraModeCtx[above]][kIntraModeCtx[left]], 13);
    intra_mode_rest();
  }

  // the mode info of an intra block after its y mode: angle deltas, the
  // uv mode and CfL, palette and filter intra
  void intra_mode_rest() {
    if (mi_sz >= BLOCK_8X8 && is_directional(y_mode))
      angle_delta_y = ms.symbol(cdf.angle_delta[y_mode - V_PRED], 7) - 3;
    if (has_chroma) {
      int cfl_allowed;
      if (lossless && kSsSize[mi_sz][d.ssx][d.ssy] == BLOCK_4X4)
        cfl_allowed = 1;
      else if (!lossless &&
               std::max(kNum4x4W[mi_sz], kNum4x4H[mi_sz]) * 4 <= 32)
        cfl_allowed = 1;
      else
        cfl_allowed = 0;
      if (cfl_allowed)
        uv_mode = ms.symbol(cdf.uv_mode_cfl[y_mode], 14);
      else
        uv_mode = ms.symbol(cdf.uv_mode_nocfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) {
        int signs = ms.symbol(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
          int ctx = (sign_u - 1) * 3 + sign_v;
          cfl_alpha_u = 1 + ms.symbol(cdf.cfl_alpha[ctx], 16);
          if (sign_u == 1) cfl_alpha_u = -cfl_alpha_u;
        }
        if (sign_v) {
          int ctx = (sign_v - 1) * 3 + sign_u;
          cfl_alpha_v = 1 + ms.symbol(cdf.cfl_alpha[ctx], 16);
          if (sign_v == 1) cfl_alpha_v = -cfl_alpha_v;
        }
      }
      if (mi_sz >= BLOCK_8X8 && is_directional(uv_mode))
        angle_delta_uv = ms.symbol(cdf.angle_delta[uv_mode - V_PRED], 7) - 3;
    }
    if (mi_sz >= BLOCK_8X8 && kNum4x4W[mi_sz] <= 16 && kNum4x4H[mi_sz] <= 16 &&
        fh.allow_sct)
      palette_mode_info();
    // filter_intra_mode_info
    if (d.seq.filter_intra && y_mode == DC_PRED && pal_size_y == 0 &&
        std::max(kNum4x4W[mi_sz], kNum4x4H[mi_sz]) * 4 <= 32) {
      use_filter_intra = ms.symbol(cdf.use_filter_intra[mi_sz], 2);
      if (use_filter_intra)
        filter_intra_mode = ms.symbol(cdf.filter_intra_mode, 5);
    }
  }

  // -- palette (spec 5.11.46, 5.11.49, 7.11.4) ----------------------------
  static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) {
      ++i;
      p <<= 1;
    }
    return i;
  }

  int get_palette_cache(int plane, uint16_t* cache) {
    int above_n = 0, left_n = 0;
    if (((mi_row * 4) % 64) && avail_u) above_n = above_pal_n[plane][mi_col];
    if (avail_l) left_n = left_pal_n[plane][mi_row];
    const uint16_t* above = &above_pal[plane][(size_t)mi_col * 8];
    const uint16_t* left = &left_pal[plane][(size_t)mi_row * 8];
    int ai = 0, li = 0, n = 0;
    while (ai < above_n && li < left_n) {
      int a = above[ai], l = left[li];
      if (l < a) {
        if (n == 0 || l != cache[n - 1]) cache[n++] = (uint16_t)l;
        ++li;
      } else {
        if (n == 0 || a != cache[n - 1]) cache[n++] = (uint16_t)a;
        ++ai;
        if (l == a) ++li;
      }
    }
    for (; ai < above_n; ++ai)
      if (n == 0 || above[ai] != cache[n - 1]) cache[n++] = above[ai];
    for (; li < left_n; ++li)
      if (n == 0 || left[li] != cache[n - 1]) cache[n++] = left[li];
    return n;
  }

  // The Y (plane 0) or U (plane 1) colours: from the cache, a literal, then
  // ascending deltas (at least 1 apart for Y)
  void read_palette_colors(int plane, int n, uint16_t* colors) {
    int bd = d.bitdepth;
    uint16_t cache[16];
    int cache_n = get_palette_cache(plane, cache);
    int idx = 0;
    for (int i = 0; i < cache_n && idx < n; ++i)
      if (ms.literal(1)) colors[idx++] = cache[i];
    if (idx < n) colors[idx++] = (uint16_t)ms.literal(bd);
    int bits = 0;
    if (idx < n) bits = bd - 3 + ms.literal(2);
    for (; idx < n; ++idx) {
      int delta = ms.literal(bits) + (plane == 0);
      colors[idx] = d.clip1(colors[idx - 1] + delta);
      int range = (1 << bd) - colors[idx] - (plane == 0);
      bits = std::min(bits, ceil_log2(range));
    }
    std::sort(colors, colors + n);
  }

  void palette_mode_info() {
    int bsize_ctx = kMiWLog2[mi_sz] + kMiHLog2[mi_sz] - 2;
    int bd = d.bitdepth;
    if (y_mode == DC_PRED) {
      int ctx = (avail_u && above_pal_n[0][mi_col] > 0) +
                (avail_l && left_pal_n[0][mi_row] > 0);
      if (ms.symbol(cdf.pal_y_mode[bsize_ctx][ctx], 2)) {
        pal_size_y = ms.symbol(cdf.pal_y_size[bsize_ctx], 7) + 2;
        read_palette_colors(0, pal_size_y, pal_colors[0]);
      }
    }
    if (has_chroma && uv_mode == DC_PRED) {
      if (ms.symbol(cdf.pal_uv_mode[pal_size_y > 0], 2)) {
        int n = pal_size_uv = ms.symbol(cdf.pal_uv_size[bsize_ctx], 7) + 2;
        read_palette_colors(1, n, pal_colors[1]);
        uint16_t* v = pal_colors[2];
        if (ms.literal(1)) {  // delta_encode_palette_colors_v
          int max_val = 1 << bd;
          int bits = bd - 4 + ms.literal(2);
          v[0] = (uint16_t)ms.literal(bd);
          for (int i = 1; i < n; ++i) {
            int delta = ms.literal(bits);
            if (delta && ms.literal(1)) delta = -delta;
            int val = v[i - 1] + delta;
            if (val < 0) val += max_val;
            if (val >= max_val) val -= max_val;
            v[i] = d.clip1(val);
          }
        } else {
          for (int i = 0; i < n; ++i) v[i] = (uint16_t)ms.literal(bd);
        }
      }
    }
  }

  // get_palette_color_context: the neighbours' scores, the colour order
  // they give and the context of their hash
  int palette_color_context(const uint8_t* map, int stride, int r, int c,
                            int n, int* order) {
    int scores[8] = {0};
    for (int i = 0; i < 8; ++i) order[i] = i;
    if (c > 0) scores[map[r * stride + c - 1]] += 2;
    if (r > 0 && c > 0) scores[map[(r - 1) * stride + c - 1]] += 1;
    if (r > 0) scores[map[(r - 1) * stride + c]] += 2;
    for (int i = 0; i < 3; ++i) {
      int max_score = scores[i], max_idx = i;
      for (int j = i + 1; j < n; ++j)
        if (scores[j] > max_score) {
          max_score = scores[j];
          max_idx = j;
        }
      if (max_idx != i) {
        int max_order = order[max_idx];
        for (int k = max_idx; k > i; --k) {
          scores[k] = scores[k - 1];
          order[k] = order[k - 1];
        }
        scores[i] = max_score;
        order[i] = max_order;
      }
    }
    int hash = 0;
    for (int i = 0; i < 3; ++i) hash += scores[i] * g_tab.palette_hash_mult[i];
    int ctx = g_tab.palette_color_context[hash];
    if (ctx < 0) bad("palette colour context");
    return ctx;
  }

  void read_color_map(int ptype, int n, int bw, int bh, int on_w, int on_h) {
    uint8_t* map = color_map[ptype];
    map_w[ptype] = bw;
    map[0] = (uint8_t)ms.ns(n);
    int order[8];
    for (int i = 1; i < on_h + on_w - 1; ++i)
      for (int j = std::min(i, on_w - 1); j >= std::max(0, i - on_h + 1); --j) {
        int ctx = palette_color_context(map, bw, i - j, j, n, order);
        int idx = ms.symbol(cdf.pal_color[ptype][n - 2][ctx], n);
        map[(i - j) * bw + j] = (uint8_t)order[idx];
      }
    for (int i = 0; i < on_h; ++i)
      for (int j = on_w; j < bw; ++j) map[i * bw + j] = map[i * bw + on_w - 1];
    for (int i = on_h; i < bh; ++i)
      memcpy(map + i * bw, map + (on_h - 1) * bw, bw);
  }

  void palette_tokens() {
    int bw = bw4 * 4, bh = bh4 * 4;
    int on_h = std::min(bh, (d.mi_rows - mi_row) * 4);
    int on_w = std::min(bw, (d.mi_cols - mi_col) * 4);
    if (pal_size_y) read_color_map(0, pal_size_y, bw, bh, on_w, on_h);
    if (pal_size_uv) {
      bw >>= d.ssx;
      bh >>= d.ssy;
      on_w >>= d.ssx;
      on_h >>= d.ssy;
      if (bw < 4) {
        bw += 2;
        on_w += 2;
      }
      if (bh < 4) {
        bh += 2;
        on_h += 2;
      }
      read_color_map(1, pal_size_uv, bw, bh, on_w, on_h);
    }
  }

  void predict_palette(int plane, int start_x, int start_y, int x, int y,
                       int txsz) {
    int w = kTxW[txsz], h = kTxH[txsz];
    const uint16_t* pal = pal_colors[plane];
    int ptype = plane > 0;
    const uint8_t* map = color_map[ptype];
    int stride = map_w[ptype];
    auto& P = d.cur[plane];
    for (int i = 0; i < h; ++i) {
      const uint8_t* m = map + (y * 4 + i) * stride + x * 4;
      Pixel* out = P.row(start_y + i) + start_x;
      for (int j = 0; j < w; ++j) out[j] = (Pixel)pal[m[j]];
    }
  }

  // The palette sizes and colours of the block, for the caches and
  // contexts of the blocks below it and to its right
  void store_palette() {
    int cols = std::min(bw4, d.mi_cols - mi_col);
    int rows = std::min(bh4, d.mi_rows - mi_row);
    int sizes[2] = {pal_size_y, pal_size_uv};
    for (int p = 0; p < 2; ++p) {
      for (int c = mi_col; c < mi_col + cols; ++c) {
        above_pal_n[p][c] = (uint8_t)sizes[p];
        if (sizes[p])
          memcpy(&above_pal[p][(size_t)c * 8], pal_colors[p],
                 sizeof(uint16_t) * sizes[p]);
      }
      for (int r = mi_row; r < mi_row + rows; ++r) {
        left_pal_n[p][r] = (uint8_t)sizes[p];
        if (sizes[p])
          memcpy(&left_pal[p][(size_t)r * 8], pal_colors[p],
                 sizeof(uint16_t) * sizes[p]);
      }
    }
  }

  // -- intra block copy (spec 7.10.2, 5.11.26, 7.11.3) --------------------
  // has_top_right of libaom's motion vector search: whether the block
  // above and to the right is decoded before this one
  int has_top_right() const {
    int sb_mi = d.seq.sb128 ? 32 : 16;
    int mask_row = mi_row & (sb_mi - 1), mask_col = mi_col & (sb_mi - 1);
    int bs = std::max(bw4, bh4);
    if (bs > 16) return 0;
    int has_tr = !((mask_row & bs) && (mask_col & bs));
    while (bs < sb_mi) {
      if (!(mask_col & bs)) break;
      if ((mask_col & (2 * bs)) && (mask_row & (2 * bs))) {
        has_tr = 0;
        break;
      }
      bs <<= 1;
    }
    // the parts of a vertical split but the last have one (the block
    // above is decoded); the parts of a horizontal split but the first
    // have none (the block to the right is not)
    if (bw4 < bh4 && ((mi_col + bw4) & (bh4 - 1))) has_tr = 1;
    if (bw4 > bh4 && (mi_row & (bw4 - 1))) has_tr = 0;
    if (partition == PARTITION_VERT_A && bw4 == bh4 && (mask_row & bs))
      has_tr = 0;
    return has_tr;
  }

  void add_ref_mv_candidate(int r, int c, int weight) {
    if (fh.inter) {
      add_inter_candidate(r, c, weight);
      return;
    }
    size_t i = (size_t)r * d.mi_cols + c;
    if (!d.is_inters[i]) return;
    int cand[2] = {d.mvs[2 * i], d.mvs[2 * i + 1]};
    // an intra frame's vectors are whole samples: lower_mv_precision
    // changes none
    int idx = 0;
    for (; idx < num_mv; ++idx)
      if (stack_mv[idx][0] == cand[0] && stack_mv[idx][1] == cand[1]) break;
    if (idx < num_mv) {
      stack_weight[idx] += weight;
    } else if (num_mv < 8) {
      stack_mv[num_mv][0] = cand[0];
      stack_mv[num_mv][1] = cand[1];
      stack_weight[num_mv] = weight;
      ++num_mv;
    }
  }

  void scan_row(int delta_row) {
    int end4 = std::min(std::min(bw4, d.mi_cols - mi_col), 16);
    int delta_col = 0;
    int use_step16 = bw4 >= 16;
    if (std::abs(delta_row) > 1) {
      delta_row += mi_row & 1;
      delta_col = 1 - (mi_col & 1);
    }
    for (int i = 0; i < end4;) {
      int r = mi_row + delta_row, c = mi_col + delta_col + i;
      if (!is_inside(r, c)) break;
      int len = std::min(bw4, (int)kNum4x4W[d.MI(d.mi_size, r, c)]);
      if (std::abs(delta_row) > 1) len = std::max(2, len);
      if (use_step16) len = std::max(4, len);
      add_ref_mv_candidate(r, c, len * 2);
      i += len;
    }
  }

  void scan_col(int delta_col) {
    int end4 = std::min(std::min(bh4, d.mi_rows - mi_row), 16);
    int delta_row = 0;
    int use_step16 = bh4 >= 16;
    if (std::abs(delta_col) > 1) {
      delta_row = 1 - (mi_row & 1);
      delta_col += mi_col & 1;
    }
    for (int i = 0; i < end4;) {
      int r = mi_row + delta_row + i, c = mi_col + delta_col;
      if (!is_inside(r, c)) break;
      int len = std::min(bh4, (int)kNum4x4H[d.MI(d.mi_size, r, c)]);
      if (std::abs(delta_col) > 1) len = std::max(2, len);
      if (use_step16) len = std::max(4, len);
      add_ref_mv_candidate(r, c, len * 2);
      i += len;
    }
  }

  void scan_point(int delta_row, int delta_col) {
    int r = mi_row + delta_row, c = mi_col + delta_col;
    if (is_inside(r, c)) add_ref_mv_candidate(r, c, 4);
  }

  void sort_stack(int start, int end) {
    while (end > start) {
      int new_end = start;
      for (int idx = start + 1; idx < end; ++idx)
        if (stack_weight[idx - 1] < stack_weight[idx]) {
          std::swap(stack_weight[idx - 1], stack_weight[idx]);
          std::swap(stack_mv[idx - 1][0], stack_mv[idx][0]);
          std::swap(stack_mv[idx - 1][1], stack_mv[idx][1]);
          new_end = idx;
        }
      end = new_end;
    }
  }

  // find_mv_stack for INTRA_FRAME: the spatial candidates only (no
  // temporal ones in an intra frame, and the extra search adds none, its
  // candidates being inter references)
  void find_mv_stack() {
    num_mv = 0;
    scan_row(-1);
    scan_col(-1);
    if (std::max(bw4, bh4) <= 16 && has_top_right()) scan_point(-1, bw4);
    int num_nearest = num_mv;
    for (int i = 0; i < num_nearest; ++i) stack_weight[i] += 640;  // REF_CAT_LEVEL
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    sort_stack(0, num_nearest);
    sort_stack(num_nearest, num_mv);
    // context_and_clamping: each vector kept within MV_BORDER of the frame
    for (int i = 0; i < num_mv; ++i) {
      int top = -(mi_row * 4 * 8), bottom = (d.mi_rows - bh4 - mi_row) * 4 * 8;
      int left = -(mi_col * 4 * 8), right = (d.mi_cols - bw4 - mi_col) * 4 * 8;
      int brow = 128 + bh4 * 4 * 8, bcol = 128 + bw4 * 4 * 8;
      stack_mv[i][0] = clip3(top - brow, bottom + brow, stack_mv[i][0]);
      stack_mv[i][1] = clip3(left - bcol, right + bcol, stack_mv[i][1]);
    }
  }

  int read_mv_component(int comp) {
    int sign = ms.symbol(cdf.mv_sign[comp], 2);
    int cls = ms.symbol(cdf.mv_class[comp], 11);
    int mag;
    // force_integer_mv: the fraction is 3 and the high precision bit 1
    if (cls == 0) {
      int bit = ms.symbol(cdf.mv_class0[comp], 2);
      mag = ((bit << 3) | (3 << 1) | 1) + 1;
    } else {
      int dd = 0;
      for (int i = 0; i < cls; ++i)
        dd |= ms.symbol(cdf.mv_bits[comp][i], 2) << i;
      mag = (2 << (cls + 2)) + ((dd << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
  }

  // is_mv_valid for intra block copy: a whole-sample vector to samples of
  // this tile that are decoded (the superblocks 256 samples to the left
  // and above, along the wavefront)
  bool intrabc_mv_valid() const {
    if (std::abs(mv[0]) >= (1 << 14) || std::abs(mv[1]) >= (1 << 14))
      return false;
    if ((mv[0] & 7) || (mv[1] & 7)) return false;
    int top = mi_row * 4 + (mv[0] >> 3), left = mi_col * 4 + (mv[1] >> 3);
    int bottom = top + bh4 * 4, right = left + bw4 * 4;
    if (has_chroma) {
      if (bw4 < 2 && d.ssx) left -= 4;
      if (bh4 < 2 && d.ssy) top -= 4;
    }
    if (top < mi_row_start * 4 || left < mi_col_start * 4 ||
        bottom > mi_row_end * 4 || right > mi_col_end * 4)
      return false;
    int sb_h = d.seq.sb128 ? 128 : 64;
    int active_sb_row = (mi_row * 4) / sb_h;
    int active_sb64_col = (mi_col * 4) >> 6;
    int src_sb_row = (bottom - 1) / sb_h;
    int src_sb64_col = (right - 1) >> 6;
    int per_row = ((mi_col_end - mi_col_start - 1) >> 4) + 1;
    int active_sb64 = active_sb_row * per_row + active_sb64_col;
    int src_sb64 = src_sb_row * per_row + src_sb64_col;
    if (src_sb64 >= active_sb64 - 4) return false;  // INTRABC_DELAY_SB64
    int gradient = 1 + 4 + (sb_h == 128);
    int wf_offset = gradient * (active_sb_row - src_sb_row);
    if (src_sb_row > active_sb_row ||
        src_sb64_col >= active_sb64_col - 4 + wf_offset)
      return false;
    return true;
  }

  void assign_mv() {
    int pred[2] = {0, 0};
    if (num_mv > 0) {
      pred[0] = stack_mv[0][0];
      pred[1] = stack_mv[0][1];
    }
    if (!pred[0] && !pred[1] && num_mv > 1) {
      pred[0] = stack_mv[1][0];
      pred[1] = stack_mv[1][1];
    }
    if (!pred[0] && !pred[1]) {
      int sb4 = d.seq.sb128 ? 32 : 16;
      if (mi_row - sb4 < mi_row_start) {
        pred[0] = 0;
        pred[1] = -(sb4 * 4 + 256) * 8;  // INTRABC_DELAY_PIXELS
      } else {
        pred[0] = -(sb4 * 4 * 8);
        pred[1] = 0;
      }
    }
    // read_mv under MV_INTRABC_CONTEXT
    int joint = ms.symbol(cdf.mv_joint, 4);
    int diff[2] = {0, 0};
    if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
    if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
    mv[0] = pred[0] + diff[0];
    mv[1] = pred[1] + diff[1];
    if (!intrabc_mv_valid()) bad("intra block copy vector outside its tile");
  }

  // The prediction of an intrabc block (7.11.3.1 with someUseIntra: one
  // block a plane, with its own vector) from the frame's unfiltered
  // samples: motion_vector_scaling without scaling, then
  // block_inter_prediction with BILINEAR, whose taps 3 and 4 are the only
  // ones not 0; the rounding variables of a single prediction
  void predict_intrabc(int plane, int x, int y, int w, int h) {
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    auto& P = d.cur[plane];
    int pos_x = (x << 4) + ((2 * mv[1]) >> sx);  // 1/16 sample
    int pos_y = (y << 4) + ((2 * mv[0]) >> sy);
    int ix = pos_x >> 4, fx = pos_x & 15, iy = pos_y >> 4, fy = pos_y & 15;
    int last_x = ((d.mi_cols * 4 + sx) >> sx) - 1;
    int last_y = ((d.mi_rows * 4 + sy) >> sy) - 1;
    int round0 = d.bitdepth == 12 ? 5 : 3, round1 = d.bitdepth == 12 ? 9 : 11;
    const int16_t* hf = g_tab.bilinear[fx];
    const int16_t* vf = g_tab.bilinear[fy];
    int rows = h + (fy != 0);
    for (int r = 0; r < rows; ++r) {
      const Pixel* src = P.row(clip3(0, last_y, iy + r));
      int32_t* out = inter_buf + r * w;
      for (int c = 0; c < w; ++c) {
        int s = hf[3] * src[clip3(0, last_x, ix + c)];
        if (fx) s += hf[4] * src[clip3(0, last_x, ix + c + 1)];
        out[c] = round2(s, round0);
      }
    }
    for (int r = 0; r < h; ++r) {
      Pixel* dst = P.row(y + r) + x;
      const int32_t* a = inter_buf + r * w;
      for (int c = 0; c < w; ++c) {
        int s = vf[3] * a[c];
        if (fy) s += vf[4] * a[c + w];
        dst[c] = d.clip1(round2(s, round1));
      }
    }
  }

  // compute_prediction of an intrabc block: the whole block, each plane
  void compute_prediction() {
    for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      int plane_sz = kSsSize[mi_sz][sx][sy];
      predict_intrabc(p, (mi_col >> sx) * 4, (mi_row >> sy) * 4,
                      kNum4x4W[plane_sz] * 4, kNum4x4H[plane_sz] * 4);
    }
  }

  // -- inter frames: mode info (spec 5.11.7, 5.11.19 .. 5.11.33) ----------
  int RF(int r, int c, int list) const {
    return d.ref_frames[((size_t)r * d.mi_cols + c) * 2 + list];
  }
  const int32_t* MV4(int r, int c, int list) const {
    return &d.mvs4[((size_t)r * d.mi_cols + c) * 4 + list * 2];
  }

  void read_skip() {
    if (fh.seg_preskip && seg_feature_active(SEG_LVL_SKIP)) {
      skip = 1;
    } else {
      int ctx = (avail_u ? d.MI(d.skips, mi_row - 1, mi_col) : 0) +
                (avail_l ? d.MI(d.skips, mi_row, mi_col - 1) : 0);
      skip = ms.symbol(cdf.skip[ctx], 2);
    }
  }

  // get_segment_id: the least of PrevSegmentIds over the block
  int predicted_segment_id() const {
    if (d.prev_seg_ids.empty()) return 0;
    int rows = std::min(bh4, d.mi_rows - mi_row);
    int cols = std::min(bw4, d.mi_cols - mi_col);
    int seg = 7;
    for (int y = 0; y < rows; ++y)
      for (int x = 0; x < cols; ++x)
        seg = std::min(seg, (int)d.prev_seg_ids[(size_t)(mi_row + y) *
                                                    d.mi_cols + mi_col + x]);
    return seg;
  }

  void inter_segment_id(int pre_skip) {
    if (!fh.seg_enabled) {
      segment_id = 0;
      return;
    }
    int pred = predicted_segment_id();
    if (!fh.seg_update_map) {
      segment_id = pred;
      return;
    }
    if (pre_skip && !fh.seg_preskip) {
      segment_id = 0;
      return;
    }
    if (!pre_skip && skip) {
      seg_id_predicted = 0;
      read_segment_id();  // skip: the spatial prediction
      return;
    }
    if (fh.seg_temporal_update) {
      int ctx = (avail_l ? d.MI(d.seg_preds, mi_row, mi_col - 1) : 0) +
                (avail_u ? d.MI(d.seg_preds, mi_row - 1, mi_col) : 0);
      seg_id_predicted = ms.symbol(cdf.seg_pred[ctx], 2);
      if (seg_id_predicted)
        segment_id = pred;
      else
        read_segment_id();
    } else {
      read_segment_id();
    }
  }

  void read_skip_mode() {
    skip_mode = 0;
    if (seg_feature_active(SEG_LVL_SKIP) ||
        seg_feature_active(SEG_LVL_REF_FRAME) ||
        seg_feature_active(SEG_LVL_GLOBALMV) || !fh.skip_mode_present ||
        bw4 < 2 || bh4 < 2)
      return;
    int ctx = (avail_u ? d.MI(d.skip_modes, mi_row - 1, mi_col) : 0) +
              (avail_l ? d.MI(d.skip_modes, mi_row, mi_col - 1) : 0);
    skip_mode = ms.symbol(cdf.skip_mode[ctx], 2);
  }

  void read_is_inter() {
    if (skip_mode) {
      is_inter = 1;
    } else if (seg_feature_active(SEG_LVL_REF_FRAME)) {
      is_inter = fh.feature_data[segment_id][SEG_LVL_REF_FRAME] != INTRA_FRAME;
    } else if (seg_feature_active(SEG_LVL_GLOBALMV)) {
      is_inter = 1;
    } else {
      int ctx;
      if (avail_u && avail_l)
        ctx = (left_intra && above_intra) ? 3 : (left_intra || above_intra);
      else if (avail_u || avail_l)
        ctx = 2 * (avail_u ? above_intra : left_intra);
      else
        ctx = 0;
      is_inter = ms.symbol(cdf.is_inter[ctx], 2);
    }
  }

  void inter_frame_mode_info() {
    use_intrabc = 0;
    left_ref[0] = avail_l ? RF(mi_row, mi_col - 1, 0) : INTRA_FRAME;
    above_ref[0] = avail_u ? RF(mi_row - 1, mi_col, 0) : INTRA_FRAME;
    left_ref[1] = avail_l ? RF(mi_row, mi_col - 1, 1) : NONE_FRAME;
    above_ref[1] = avail_u ? RF(mi_row - 1, mi_col, 1) : NONE_FRAME;
    left_intra = left_ref[0] <= INTRA_FRAME;
    above_intra = above_ref[0] <= INTRA_FRAME;
    is_compound = 0;
    skip = 0;
    seg_id_predicted = 0;
    inter_segment_id(1);
    read_skip_mode();
    if (skip_mode)
      skip = 1;
    else
      read_skip();
    if (!fh.seg_preskip) inter_segment_id(0);
    lossless = fh.lossless[segment_id];
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = 0;
    read_is_inter();
    y_mode = uv_mode = DC_PRED;
    angle_delta_y = angle_delta_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    pal_size_y = pal_size_uv = 0;
    use_filter_intra = 0;
    motion_mode = 0;
    interintra = wedge_interintra = 0;
    interp_filter[0] = interp_filter[1] = 0;
    bmv[0][0] = bmv[0][1] = bmv[1][0] = bmv[1][1] = 0;
    if (is_inter) {
      inter_block_mode_info();
    } else {
      ref_frame[0] = INTRA_FRAME;
      ref_frame[1] = NONE_FRAME;
      y_mode = ms.symbol(cdf.y_mode[kSizeGroup[mi_sz]], 13);
      intra_mode_rest();
    }
  }

  int count_refs(int type) const {
    int c = 0;
    if (avail_u) c += (above_ref[0] == type) + (above_ref[1] == type);
    if (avail_l) c += (left_ref[0] == type) + (left_ref[1] == type);
    return c;
  }
  static int ref_count_ctx(int c0, int c1) {
    return c0 < c1 ? 0 : c0 == c1 ? 1 : 2;
  }
  int bit(uint16_t* c) { return ms.symbol(c, 2); }
  static int backward(int ref) { return ref >= BWDREF_FRAME; }

  // comp_mode's context (libaom's av1_get_reference_mode_context)
  int comp_mode_ctx() const {
    int as = above_ref[1] <= INTRA_FRAME, ls = left_ref[1] <= INTRA_FRAME;
    if (avail_u && avail_l) {
      if (as && ls) return backward(above_ref[0]) ^ backward(left_ref[0]);
      if (as) return 2 + (backward(above_ref[0]) || above_intra);
      if (ls) return 2 + (backward(left_ref[0]) || left_intra);
      return 4;
    }
    if (avail_u) return as ? backward(above_ref[0]) : 3;
    if (avail_l) return ls ? backward(left_ref[0]) : 3;
    return 1;
  }

  // comp_ref_type's context (av1_get_comp_reference_type_context)
  int comp_ref_type_ctx() const {
    auto uni = [](const int* r) {
      return r[1] > INTRA_FRAME && !(backward(r[0]) ^ backward(r[1]));
    };
    if (avail_u && avail_l) {
      if (above_intra && left_intra) return 2;
      if (above_intra || left_intra) {
        const int* r = above_intra ? left_ref : above_ref;
        return r[1] <= INTRA_FRAME ? 2 : 1 + 2 * uni(r);
      }
      int asg = above_ref[1] <= INTRA_FRAME, lsg = left_ref[1] <= INTRA_FRAME;
      int fa = above_ref[0], fl = left_ref[0];
      if (asg && lsg) return 1 + 2 * !(backward(fa) ^ backward(fl));
      if (asg || lsg) {
        if (!uni(asg ? left_ref : above_ref)) return 1;
        return 3 + !(backward(fa) ^ backward(fl));
      }
      int au = uni(above_ref), lu = uni(left_ref);
      if (!au && !lu) return 0;
      if (!au || !lu) return 2;
      return 3 + !((fa == BWDREF_FRAME) ^ (fl == BWDREF_FRAME));
    }
    if (avail_u || avail_l) {
      const int* r = avail_u ? above_ref : left_ref;
      if ((avail_u ? above_intra : left_intra) || r[1] <= INTRA_FRAME) return 2;
      return 4 * uni(r);
    }
    return 2;
  }

  void read_ref_frames() {
    ref_frame[1] = NONE_FRAME;
    if (skip_mode) {
      ref_frame[0] = fh.skip_mode_frame[0];
      ref_frame[1] = fh.skip_mode_frame[1];
      return;
    }
    if (seg_feature_active(SEG_LVL_REF_FRAME)) {
      ref_frame[0] = fh.feature_data[segment_id][SEG_LVL_REF_FRAME];
      return;
    }
    if (seg_feature_active(SEG_LVL_SKIP) ||
        seg_feature_active(SEG_LVL_GLOBALMV)) {
      ref_frame[0] = LAST_FRAME;
      return;
    }
    int last = count_refs(LAST_FRAME), last2 = count_refs(LAST2_FRAME),
        last3 = count_refs(LAST3_FRAME), gold = count_refs(GOLDEN_FRAME),
        bwd = count_refs(BWDREF_FRAME), alt2 = count_refs(ALTREF2_FRAME),
        alt = count_refs(ALTREF_FRAME);
    int ctx_fb = ref_count_ctx(last + last2 + last3 + gold, bwd + alt2 + alt);
    int ctx_bwd = ref_count_ctx(bwd + alt2, alt);
    int ctx_bwd1 = ref_count_ctx(bwd, alt2);
    int ctx_l12 = ref_count_ctx(last + last2, last3 + gold);
    int ctx_l1 = ref_count_ctx(last, last2);
    int ctx_l3g = ref_count_ctx(last3, gold);
    int comp = fh.reference_select && std::min(bw4, bh4) >= 2 &&
               bit(cdf.comp_mode[comp_mode_ctx()]);
    if (comp) {
      if (!bit(cdf.comp_ref_type[comp_ref_type_ctx()])) {
        // UNIDIR_COMPOUND_REFERENCE
        if (bit(cdf.uni_comp_ref[ctx_fb][0])) {
          ref_frame[0] = BWDREF_FRAME;
          ref_frame[1] = ALTREF_FRAME;
        } else if (bit(cdf.uni_comp_ref[ref_count_ctx(last2, last3 + gold)]
                                       [1])) {
          ref_frame[0] = LAST_FRAME;
          ref_frame[1] = bit(cdf.uni_comp_ref[ctx_l3g][2]) ? GOLDEN_FRAME
                                                           : LAST3_FRAME;
        } else {
          ref_frame[0] = LAST_FRAME;
          ref_frame[1] = LAST2_FRAME;
        }
      } else {
        if (!bit(cdf.comp_ref[ctx_l12][0]))
          ref_frame[0] = bit(cdf.comp_ref[ctx_l1][1]) ? LAST2_FRAME : LAST_FRAME;
        else
          ref_frame[0] = bit(cdf.comp_ref[ctx_l3g][2]) ? GOLDEN_FRAME
                                                       : LAST3_FRAME;
        if (!bit(cdf.comp_bwd_ref[ctx_bwd][0]))
          ref_frame[1] = bit(cdf.comp_bwd_ref[ctx_bwd1][1]) ? ALTREF2_FRAME
                                                            : BWDREF_FRAME;
        else
          ref_frame[1] = ALTREF_FRAME;
      }
      return;
    }
    if (bit(cdf.single_ref[ctx_fb][0])) {
      if (!bit(cdf.single_ref[ctx_bwd][1]))
        ref_frame[0] = bit(cdf.single_ref[ctx_bwd1][5]) ? ALTREF2_FRAME
                                                         : BWDREF_FRAME;
      else
        ref_frame[0] = ALTREF_FRAME;
    } else if (bit(cdf.single_ref[ctx_l12][2])) {
      ref_frame[0] = bit(cdf.single_ref[ctx_l3g][4]) ? GOLDEN_FRAME
                                                     : LAST3_FRAME;
    } else {
      ref_frame[0] = bit(cdf.single_ref[ctx_l1][3]) ? LAST2_FRAME : LAST_FRAME;
    }
  }

  void lower_mv_precision(int* mv) const {
    if (fh.allow_high_precision_mv) return;
    for (int i = 0; i < 2; ++i) {
      if (fh.force_integer_mv) {
        int a = std::abs(mv[i]), a_int = (a + 3) >> 3;
        mv[i] = mv[i] > 0 ? a_int << 3 : -(a_int << 3);
      } else if (mv[i] & 1) {
        mv[i] += mv[i] > 0 ? -1 : 1;
      }
    }
  }
  static int round2signed(int64_t x, int n) {
    return (int)(x >= 0 ? round2l(x, n) : -round2l(-x, n));
  }

  void setup_global_mv(int list, int* mv) {
    int ref = ref_frame[list];
    int typ = ref > INTRA_FRAME ? fh.gm_type[ref] : GM_IDENTITY;
    mv[0] = mv[1] = 0;
    if (typ == GM_TRANSLATION) {
      mv[0] = fh.gm_params[ref][0] >> (kWmBits - 3);
      mv[1] = fh.gm_params[ref][1] >> (kWmBits - 3);
    } else if (typ != GM_IDENTITY) {
      const int* gm = fh.gm_params[ref];
      int x = mi_col * 4 + bw4 * 2 - 1, y = mi_row * 4 + bh4 * 2 - 1;
      int64_t xc = (int64_t)(gm[2] - (1 << kWmBits)) * x + (int64_t)gm[3] * y +
                   gm[0];
      int64_t yc = (int64_t)gm[4] * x +
                   (int64_t)(gm[5] - (1 << kWmBits)) * y + gm[1];
      if (fh.allow_high_precision_mv) {
        mv[0] = round2signed(yc, kWmBits - 3);
        mv[1] = round2signed(xc, kWmBits - 3);
      } else {
        mv[0] = round2signed(yc, kWmBits - 2) * 2;
        mv[1] = round2signed(xc, kWmBits - 2) * 2;
      }
    }
    lower_mv_precision(mv);
  }

  static int has_newmv(int mode) {
    return mode == NEWMV || mode == NEW_NEWMV || mode == NEAR_NEWMV ||
           mode == NEW_NEARMV || mode == NEAREST_NEWMV || mode == NEW_NEARESTMV;
  }

  // a candidate (one vector, or a compound block's two) added to the
  // stack, or its weight to the same candidate's
  void push_mv(const int* c0, const int* c1, int weight) {
    int idx = 0;
    for (; idx < num_mv_found; ++idx)
      if (ref_stack[idx][0][0] == c0[0] && ref_stack[idx][0][1] == c0[1] &&
          (!c1 || (ref_stack[idx][1][0] == c1[0] &&
                   ref_stack[idx][1][1] == c1[1])))
        break;
    if (idx < num_mv_found) {
      weight_stack[idx] += weight;
    } else if (num_mv_found < 8) {
      ref_stack[num_mv_found][0][0] = c0[0];
      ref_stack[num_mv_found][0][1] = c0[1];
      if (c1) {
        ref_stack[num_mv_found][1][0] = c1[0];
        ref_stack[num_mv_found][1][1] = c1[1];
      }
      weight_stack[num_mv_found] = weight;
      ++num_mv_found;
    }
  }

  // add_ref_mv_candidate of an inter frame (search_stack and
  // compound_search_stack)
  void add_inter_candidate(int r, int c, int weight) {
    size_t i = (size_t)r * d.mi_cols + c;
    if (!d.is_inters[i]) return;
    int mode = d.y_modes[i], size = d.mi_size[i];
    int large = std::min(kNum4x4W[size], kNum4x4H[size]) >= 2;
    int global = (mode == GLOBALMV || mode == GLOBAL_GLOBALMV) && large;
    if (!is_compound) {
      for (int list = 0; list < 2; ++list) {
        if (d.ref_frames[i * 2 + list] != ref_frame[0]) continue;
        int cand[2];
        if (global && fh.gm_type[ref_frame[0]] > GM_TRANSLATION) {
          cand[0] = global_mvs[0][0];
          cand[1] = global_mvs[0][1];
        } else {
          cand[0] = d.mvs4[i * 4 + list * 2];
          cand[1] = d.mvs4[i * 4 + list * 2 + 1];
        }
        lower_mv_precision(cand);
        if (has_newmv(mode)) ++new_mv_count;
        found_match = 1;
        push_mv(cand, nullptr, weight);
      }
      return;
    }
    if (d.ref_frames[i * 2] != ref_frame[0] ||
        d.ref_frames[i * 2 + 1] != ref_frame[1])
      return;
    int cand[2][2];
    for (int list = 0; list < 2; ++list) {
      if (global && fh.gm_type[ref_frame[list]] > GM_TRANSLATION) {
        cand[list][0] = global_mvs[list][0];
        cand[list][1] = global_mvs[list][1];
      } else {
        cand[list][0] = d.mvs4[i * 4 + list * 2];
        cand[list][1] = d.mvs4[i * 4 + list * 2 + 1];
      }
      lower_mv_precision(cand[list]);
    }
    found_match = 1;
    push_mv(cand[0], cand[1], weight);
    if (has_newmv(mode)) ++new_mv_count;
  }

  void add_tpl_ref_mv(int delta_row, int delta_col) {
    int r = (mi_row + delta_row) | 1, c = (mi_col + delta_col) | 1;
    if (!is_inside(r, c)) return;
    size_t at = (size_t)(r >> 1) * (d.mi_cols >> 1) + (c >> 1);
    if (delta_row == 0 && delta_col == 0) zero_mv_ctx = 1;
    int off = d.tpl_off[at];
    if (!off) return;
    int cand[2][2];
    for (int list = 0; list < 1 + is_compound; ++list) {
      int cur_off = get_relative_dist(d.seq, fh.order_hint,
                                      fh.order_hints[ref_frame[list]]);
      mv_projection(&d.tpl_mv[at * 2], cur_off, off, cand[list]);
      lower_mv_precision(cand[list]);
    }
    if (delta_row == 0 && delta_col == 0) {
      zero_mv_ctx = 0;
      for (int list = 0; list < 1 + is_compound; ++list)
        if (std::abs(cand[list][0] - global_mvs[list][0]) >= 16 ||
            std::abs(cand[list][1] - global_mvs[list][1]) >= 16)
          zero_mv_ctx = 1;
    }
    ++n_temporal;
    push_mv(cand[0], is_compound ? cand[1] : nullptr, 2);
  }

  void temporal_scan() {
    int step_w = bw4 >= 16 ? 4 : 2, step_h = bh4 >= 16 ? 4 : 2;
    for (int dr = 0; dr < std::min((int)bh4, 16); dr += step_h)
      for (int dc = 0; dc < std::min((int)bw4, 16); dc += step_w)
        add_tpl_ref_mv(dr, dc);
    if (bh4 >= 2 && bh4 < 16 && bw4 >= 2 && bw4 < 16) {
      const int pos[3][2] = {{bh4, -2}, {bh4, bw4}, {bh4 - 2, bw4}};
      for (int i = 0; i < 3; ++i) {
        int row = (mi_row & 15) + pos[i][0], col = (mi_col & 15) + pos[i][1];
        if (row >= 0 && row < 16 && col >= 0 && col < 16)
          add_tpl_ref_mv(pos[i][0], pos[i][1]);
      }
    }
  }

  // the extra search (7.10.2.12): the vectors of the neighbours' other
  // references, sign-flipped across the current frame; a compound block's
  // combined with the global vectors
  void extra_search() {
    int w4 = std::min(std::min(16, (int)bw4), d.mi_cols - mi_col);
    int h4 = std::min(std::min(16, (int)bh4), d.mi_rows - mi_row);
    int num4x4 = std::min(w4, h4);
    int id_mvs[2][2][2], diff_mvs[2][2][2], id_n[2] = {0, 0},
        diff_n[2] = {0, 0};
    for (int pass = 0; pass < 2 && num_mv_found < 2; ++pass) {
      int idx = 0;
      while (idx < num4x4 && num_mv_found < 2) {
        int r = pass == 0 ? mi_row - 1 : mi_row + idx;
        int c = pass == 0 ? mi_col + idx : mi_col - 1;
        if (!is_inside(r, c)) break;
        size_t i = (size_t)r * d.mi_cols + c;
        for (int cl = 0; cl < 2; ++cl) {
          int cref = d.ref_frames[i * 2 + cl];
          if (cref <= INTRA_FRAME) continue;
          const int32_t* m = &d.mvs4[i * 4 + cl * 2];
          if (is_compound) {
            for (int list = 0; list < 2; ++list) {
              int cand[2] = {m[0], m[1]};
              if (cref == ref_frame[list] && id_n[list] < 2) {
                id_mvs[list][id_n[list]][0] = cand[0];
                id_mvs[list][id_n[list]][1] = cand[1];
                ++id_n[list];
              } else if (diff_n[list] < 2) {
                if (fh.ref_sign_bias[cref] !=
                    fh.ref_sign_bias[ref_frame[list]]) {
                  cand[0] = -cand[0];
                  cand[1] = -cand[1];
                }
                diff_mvs[list][diff_n[list]][0] = cand[0];
                diff_mvs[list][diff_n[list]][1] = cand[1];
                ++diff_n[list];
              }
            }
            continue;
          }
          int cand[2] = {m[0], m[1]};
          if (fh.ref_sign_bias[cref] != fh.ref_sign_bias[ref_frame[0]]) {
            cand[0] = -cand[0];
            cand[1] = -cand[1];
          }
          int k = 0;
          for (; k < num_mv_found; ++k)
            if (ref_stack[k][0][0] == cand[0] && ref_stack[k][0][1] == cand[1])
              break;
          if (k == num_mv_found) {
            ref_stack[k][0][0] = cand[0];
            ref_stack[k][0][1] = cand[1];
            weight_stack[k] = 2;
            ++num_mv_found;
          }
        }
        idx += pass == 0 ? kNum4x4W[d.mi_size[i]] : kNum4x4H[d.mi_size[i]];
      }
    }
    if (!is_compound) {
      for (int k = num_mv_found; k < 2; ++k) {
        ref_stack[k][0][0] = global_mvs[0][0];
        ref_stack[k][0][1] = global_mvs[0][1];
      }
      return;
    }
    int comb[2][2][2];
    for (int list = 0; list < 2; ++list) {
      int n = 0;
      for (int k = 0; k < id_n[list]; ++k, ++n) {
        comb[n][list][0] = id_mvs[list][k][0];
        comb[n][list][1] = id_mvs[list][k][1];
      }
      for (int k = 0; k < diff_n[list] && n < 2; ++k, ++n) {
        comb[n][list][0] = diff_mvs[list][k][0];
        comb[n][list][1] = diff_mvs[list][k][1];
      }
      for (; n < 2; ++n) {
        comb[n][list][0] = global_mvs[list][0];
        comb[n][list][1] = global_mvs[list][1];
      }
    }
    if (num_mv_found == 1) {
      int pick = (comb[0][0][0] == ref_stack[0][0][0] &&
                  comb[0][0][1] == ref_stack[0][0][1] &&
                  comb[0][1][0] == ref_stack[0][1][0] &&
                  comb[0][1][1] == ref_stack[0][1][1]) ? 1 : 0;
      memcpy(ref_stack[1], comb[pick], sizeof(comb[0]));
      weight_stack[1] = 2;
      num_mv_found = 2;
    } else {
      for (int k = 0; k < 2; ++k) {
        memcpy(ref_stack[num_mv_found], comb[k], sizeof(comb[0]));
        weight_stack[num_mv_found] = 2;
        ++num_mv_found;
      }
    }
  }

  // find_mv_stack (7.10.2) of an inter block
  void find_mv_stack_inter() {
    num_mv_found = new_mv_count = 0;
    setup_global_mv(0, global_mvs[0]);
    if (is_compound) setup_global_mv(1, global_mvs[1]);
    found_match = 0;
    scan_row(-1);
    int found_above = found_match;
    found_match = 0;
    scan_col(-1);
    int found_left = found_match;
    found_match = 0;
    if (std::max(bw4, bh4) <= 16 && has_top_right()) scan_point(-1, bw4);
    if (found_match) found_above = 1;
    int close = found_above + found_left;
    int num_nearest = num_mv_found, num_new = new_mv_count;
    for (int i = 0; i < num_nearest; ++i) weight_stack[i] += 640;
    zero_mv_ctx = 0;
    if (fh.use_ref_frame_mvs) temporal_scan();
    scan_point(-1, -1);
    if (found_match) found_above = 1;
    found_match = 0;
    scan_row(-3);
    if (found_match) found_above = 1;
    found_match = 0;
    scan_col(-3);
    if (found_match) found_left = 1;
    found_match = 0;
    if (bh4 > 1) scan_row(-5);
    if (found_match) found_above = 1;
    found_match = 0;
    if (bw4 > 1) scan_col(-5);
    if (found_match) found_left = 1;
    int total = found_above + found_left;
    sort_stack_inter(0, num_nearest);
    sort_stack_inter(num_nearest, num_mv_found);
    if (num_mv_found < 2) extra_search();
    // context_and_clamping
    for (int i = 0; i < num_mv_found; ++i) {
      int z = 0;
      if (i + 1 < num_mv_found) {
        int w0 = weight_stack[i], w1 = weight_stack[i + 1];
        if (w0 >= 640) {
          if (w1 < 640) z = 1;
        } else {
          z = 2;
        }
      }
      drl_ctx[i] = z;
    }
    int top = -(mi_row * 32), bottom = (d.mi_rows - bh4 - mi_row) * 32;
    int left = -(mi_col * 32), right = (d.mi_cols - bw4 - mi_col) * 32;
    for (int list = 0; list < 1 + is_compound; ++list)
      for (int i = 0; i < num_mv_found; ++i) {
        int* m = ref_stack[i][list];
        m[0] = clip3(top - 128 - bh4 * 32, bottom + 128 + bh4 * 32, m[0]);
        m[1] = clip3(left - 128 - bw4 * 32, right + 128 + bw4 * 32, m[1]);
      }
    if (close == 0) {
      new_mv_ctx = std::min(total, 1);
      ref_mv_ctx = total;
    } else if (close == 1) {
      new_mv_ctx = 3 - std::min(num_new, 1);
      ref_mv_ctx = 2 + total;
    } else {
      new_mv_ctx = 5 - std::min(num_new, 1);
      ref_mv_ctx = 5;
    }
  }

  void sort_stack_inter(int start, int end) {
    while (end > start) {
      int new_end = start;
      for (int idx = start + 1; idx < end; ++idx)
        if (weight_stack[idx - 1] < weight_stack[idx]) {
          std::swap(weight_stack[idx - 1], weight_stack[idx]);
          int t[2][2];
          memcpy(t, ref_stack[idx - 1], sizeof(t));
          memcpy(ref_stack[idx - 1], ref_stack[idx], sizeof(t));
          memcpy(ref_stack[idx], t, sizeof(t));
          new_end = idx;
        }
      end = new_end;
    }
  }

  int read_mv_component0(int comp) {
    int sign = ms.symbol(cdf.mv0_sign[comp], 2);
    int cls = ms.symbol(cdf.mv0_class[comp], 11);
    int mag;
    if (cls == 0) {
      int bit = ms.symbol(cdf.mv0_class0[comp], 2);
      int fr = fh.force_integer_mv ? 3
                                   : ms.symbol(cdf.mv0_class0_fr[comp][bit], 4);
      int hp = fh.allow_high_precision_mv
                   ? ms.symbol(cdf.mv0_class0_hp[comp], 2)
                   : 1;
      mag = ((bit << 3) | (fr << 1) | hp) + 1;
    } else {
      int dd = 0;
      for (int i = 0; i < cls; ++i)
        dd |= ms.symbol(cdf.mv0_bits[comp][i], 2) << i;
      mag = 2 << (cls + 2);
      int fr = fh.force_integer_mv ? 3 : ms.symbol(cdf.mv0_fr[comp], 4);
      int hp = fh.allow_high_precision_mv ? ms.symbol(cdf.mv0_hp[comp], 2)
                                          : 1;
      mag += ((dd << 3) | (fr << 1) | hp) + 1;
    }
    return sign ? -mag : mag;
  }

  // get_mode: the single mode of each reference of a compound mode
  int get_mode(int list) const {
    if (y_mode < NEAREST_NEARESTMV) return y_mode;
    switch (y_mode) {
      case NEW_NEWMV: return NEWMV;
      case NEAREST_NEARESTMV: return NEARESTMV;
      case NEAR_NEARMV: return NEARMV;
      case GLOBAL_GLOBALMV: return GLOBALMV;
      case NEAREST_NEWMV: return list ? NEWMV : NEARESTMV;
      case NEW_NEARESTMV: return list ? NEARESTMV : NEWMV;
      case NEAR_NEWMV: return list ? NEWMV : NEARMV;
      default: return list ? NEARMV : NEWMV;  // NEW_NEARMV
    }
  }
  static int has_nearmv(int mode) {
    return mode == NEARMV || mode == NEAR_NEARMV || mode == NEAR_NEWMV ||
           mode == NEW_NEARMV;
  }

  void inter_block_mode_info() {
    read_ref_frames();
    is_compound = ref_frame[1] > INTRA_FRAME;
    find_mv_stack_inter();
    if (skip_mode) {
      y_mode = NEAREST_NEARESTMV;
    } else if (seg_feature_active(SEG_LVL_SKIP) ||
               seg_feature_active(SEG_LVL_GLOBALMV)) {
      y_mode = GLOBALMV;
    } else if (is_compound) {
      static const int kMap[3][5] = {
          {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};
      int ctx = kMap[ref_mv_ctx >> 1][std::min(new_mv_ctx, 4)];
      y_mode = NEAREST_NEARESTMV + ms.symbol(cdf.compound_mode[ctx], 8);
    } else if (!ms.symbol(cdf.new_mv[new_mv_ctx], 2)) {
      y_mode = NEWMV;
    } else if (!ms.symbol(cdf.zero_mv[zero_mv_ctx], 2)) {
      y_mode = GLOBALMV;
    } else {
      y_mode = ms.symbol(cdf.ref_mv[ref_mv_ctx], 2) ? NEARMV : NEARESTMV;
    }
    ref_mv_idx = 0;
    if (y_mode == NEWMV || y_mode == NEW_NEWMV) {
      for (int idx = 0; idx < 2; ++idx)
        if (num_mv_found > idx + 1) {
          if (!ms.symbol(cdf.drl_mode[drl_ctx[idx]], 2)) {
            ref_mv_idx = idx;
            break;
          }
          ref_mv_idx = idx + 1;
        }
    } else if (has_nearmv(y_mode)) {
      ref_mv_idx = 1;
      for (int idx = 1; idx < 3; ++idx)
        if (num_mv_found > idx + 1) {
          if (!ms.symbol(cdf.drl_mode[drl_ctx[idx]], 2)) {
            ref_mv_idx = idx;
            break;
          }
          ref_mv_idx = idx + 1;
        }
    }
    // assign_mv
    for (int list = 0; list < 1 + is_compound; ++list) {
      int mode = get_mode(list);
      int pred[2];
      if (mode == GLOBALMV) {
        pred[0] = global_mvs[list][0];
        pred[1] = global_mvs[list][1];
      } else {
        int pos = mode == NEARESTMV ? 0 : ref_mv_idx;
        if (mode == NEWMV && num_mv_found <= 1) pos = 0;
        pred[0] = ref_stack[pos][list][0];
        pred[1] = ref_stack[pos][list][1];
      }
      bmv[list][0] = pred[0];
      bmv[list][1] = pred[1];
      if (mode == NEWMV) {
        int joint = ms.symbol(cdf.mv0_joint, 4);
        if (joint == 2 || joint == 3) bmv[list][0] += read_mv_component0(0);
        if (joint == 1 || joint == 3) bmv[list][1] += read_mv_component0(1);
      }
    }
    // read_interintra_mode
    if (!skip_mode && d.seq.interintra && !is_compound &&
        mi_sz >= BLOCK_8X8 && mi_sz <= BLOCK_32X32) {
      int g = kSizeGroup[mi_sz];
      interintra = ms.symbol(cdf.interintra[g], 2);
      if (interintra) {
        interintra_mode = ms.symbol(cdf.interintra_mode[g], 4);
        ref_frame[1] = INTRA_FRAME;
        wedge_interintra = ms.symbol(cdf.wedge_interintra[mi_sz], 2);
        if (wedge_interintra)
          wedge_index = ms.symbol(cdf.wedge_index[mi_sz], 16);
      }
    }
    // read_motion_mode
    motion_mode = SIMPLE;
    num_samples = 0;
    if (!skip_mode && fh.motion_switchable && std::min(bw4, bh4) >= 2 &&
        !(!fh.force_integer_mv &&
          (y_mode == GLOBALMV || y_mode == GLOBAL_GLOBALMV) &&
          fh.gm_type[ref_frame[0]] > GM_TRANSLATION) &&
        !is_compound && ref_frame[1] != INTRA_FRAME &&
        has_overlappable_candidates()) {
      find_warp_samples();
      if (fh.force_integer_mv || num_samples == 0 ||
          !fh.allow_warped_motion || is_scaled(ref_frame[0]))
        motion_mode = ms.symbol(cdf.use_obmc[mi_sz], 2) ? OBMC : SIMPLE;
      else
        motion_mode = ms.symbol(cdf.motion_mode[mi_sz], 3);
    }
    // read_compound_type
    comp_group_idx = 0;
    compound_idx = 1;
    compound_type = COMPOUND_AVERAGE;
    if (is_compound && !skip_mode) {
      if (d.seq.masked_compound) {
        int ac = 0, lc = 0;
        if (avail_u) {
          size_t i = (size_t)(mi_row - 1) * d.mi_cols + mi_col;
          if (above_ref[1] > INTRA_FRAME) ac = d.comp_groups[i];
          else if (above_ref[0] == ALTREF_FRAME) ac = 3;
        }
        if (avail_l) {
          size_t i = (size_t)mi_row * d.mi_cols + mi_col - 1;
          if (left_ref[1] > INTRA_FRAME) lc = d.comp_groups[i];
          else if (left_ref[0] == ALTREF_FRAME) lc = 3;
        }
        comp_group_idx = ms.symbol(cdf.comp_group_idx[std::min(5, ac + lc)], 2);
      }
      if (comp_group_idx == 0) {
        if (d.seq.jnt_comp) {
          int fwd = std::abs(get_relative_dist(
              d.seq, fh.order_hints[ref_frame[1]], fh.order_hint));
          int bck = std::abs(get_relative_dist(
              d.seq, fh.order_hint, fh.order_hints[ref_frame[0]]));
          int ac = 0, lc = 0;
          if (avail_u) {
            size_t i = (size_t)(mi_row - 1) * d.mi_cols + mi_col;
            if (above_ref[1] > INTRA_FRAME) ac = d.comp_idxs[i];
            else if (above_ref[0] == ALTREF_FRAME) ac = 1;
          }
          if (avail_l) {
            size_t i = (size_t)mi_row * d.mi_cols + mi_col - 1;
            if (left_ref[1] > INTRA_FRAME) lc = d.comp_idxs[i];
            else if (left_ref[0] == ALTREF_FRAME) lc = 1;
          }
          compound_idx =
              ms.symbol(cdf.compound_idx[ac + lc + 3 * (fwd == bck)], 2);
          compound_type = compound_idx ? COMPOUND_AVERAGE : COMPOUND_DISTANCE;
        }
      } else if (!kWedgeBits[mi_sz]) {
        compound_type = COMPOUND_DIFFWTD;
      } else {
        compound_type = ms.symbol(cdf.compound_type[mi_sz], 2)
                            ? COMPOUND_DIFFWTD
                            : COMPOUND_WEDGE;
      }
      if (compound_type == COMPOUND_WEDGE) {
        wedge_index = ms.symbol(cdf.wedge_index[mi_sz], 16);
        wedge_sign = ms.literal(1);
      } else if (compound_type == COMPOUND_DIFFWTD) {
        mask_type = ms.literal(1);
      }
    }
    // the interpolation filters
    if (fh.interp_filter == 4) {
      for (int dir = 0; dir < (d.seq.dual_filter ? 2 : 1); ++dir) {
        interp_filter[dir] = 0;
        int large = std::min(bw4, bh4) >= 2;
        bool needed = !skip_mode && motion_mode != LOCALWARP;
        if (needed && large && (y_mode == GLOBALMV || y_mode == GLOBAL_GLOBALMV)) {
          needed = fh.gm_type[ref_frame[0]] == GM_TRANSLATION ||
                   (is_compound && fh.gm_type[ref_frame[1]] == GM_TRANSLATION);
        }
        if (!needed) continue;
        int ctx = ((dir & 1) * 2 + is_compound) * 4;
        int lt = 3, at = 3;
        if (avail_l && (RF(mi_row, mi_col - 1, 0) == ref_frame[0] ||
                        RF(mi_row, mi_col - 1, 1) == ref_frame[0]))
          lt = d.interp[((size_t)mi_row * d.mi_cols + mi_col - 1) * 2 + dir];
        if (avail_u && (RF(mi_row - 1, mi_col, 0) == ref_frame[0] ||
                        RF(mi_row - 1, mi_col, 1) == ref_frame[0]))
          at = d.interp[((size_t)(mi_row - 1) * d.mi_cols + mi_col) * 2 + dir];
        if (lt == at)
          ctx += lt;
        else if (lt == 3)
          ctx += at;
        else if (at == 3)
          ctx += lt;
        else
          ctx += 3;
        interp_filter[dir] = ms.symbol(cdf.interp_filter[ctx], 3);
      }
      if (!d.seq.dual_filter) interp_filter[1] = interp_filter[0];
    } else {
      interp_filter[0] = interp_filter[1] = fh.interp_filter;
    }
  }

  int has_overlappable_candidates() const {
    if (avail_u)
      for (int x = mi_col; x < std::min(d.mi_cols, mi_col + bw4); x += 2) {
        int x5 = std::min(x | 1, d.mi_cols - 1);
        if (RF(mi_row - 1, x5, 0) > INTRA_FRAME) return 1;
      }
    if (avail_l)
      for (int y = mi_row; y < std::min(d.mi_rows, mi_row + bh4); y += 2) {
        int y5 = std::min(y | 1, d.mi_rows - 1);
        if (RF(y5, mi_col - 1, 0) > INTRA_FRAME) return 1;
      }
    return 0;
  }

  int is_scaled(int ref) const {
    return d.x_scale[ref] != (1 << 14) || d.y_scale[ref] != (1 << 14);
  }

  // find_warp_samples (7.10.4), as libaom and libdav1d walk the
  // neighbours (a row or column of smaller blocks by their own steps)
  void add_sample(int dr, int dc) {
    if (num_samples_scanned >= 8) return;
    int r = mi_row + dr, c = mi_col + dc;
    if (!is_inside(r, c)) return;
    if (RF(r, c, 0) != ref_frame[0] || RF(r, c, 1) != NONE_FRAME) return;
    int sz = d.MI(d.mi_size, r, c);
    int w4 = kNum4x4W[sz], h4 = kNum4x4H[sz];
    int cand_row = r & ~(h4 - 1), cand_col = c & ~(w4 - 1);
    int mid_y = cand_row * 4 + h4 * 2 - 1, mid_x = cand_col * 4 + w4 * 2 - 1;
    int threshold = clip3(16, 112, std::max(bw4, bh4) * 4);
    const int32_t* mv = MV4(r, c, 0);
    int diff = std::abs(mv[0] - bmv[0][0]) + std::abs(mv[1] - bmv[0][1]);
    int valid = diff <= threshold;
    ++num_samples_scanned;
    if (!valid && num_samples_scanned > 1) return;
    cand_list[num_samples][0] = mid_y * 8;
    cand_list[num_samples][1] = mid_x * 8;
    cand_list[num_samples][2] = mid_y * 8 + mv[0];
    cand_list[num_samples][3] = mid_x * 8 + mv[1];
    if (valid) ++num_samples;
  }

  void find_warp_samples() {
    num_samples = num_samples_scanned = 0;
    int do_top_left = 1, do_top_right = 1;
    if (avail_u) {
      int src_w = kNum4x4W[d.MI(d.mi_size, mi_row - 1, mi_col)];
      if (bw4 <= src_w) {
        int col_offset = -(mi_col & (src_w - 1));
        if (col_offset < 0) do_top_left = 0;
        if (col_offset + src_w > bw4) do_top_right = 0;
        add_sample(-1, 0);
      } else {
        for (int i = 0; i < std::min((int)bw4, d.mi_cols - mi_col);) {
          int step = kNum4x4W[d.MI(d.mi_size, mi_row - 1, mi_col + i)];
          add_sample(-1, i);
          i += step;
        }
      }
    }
    if (avail_l) {
      int src_h = kNum4x4H[d.MI(d.mi_size, mi_row, mi_col - 1)];
      if (bh4 <= src_h) {
        int row_offset = -(mi_row & (src_h - 1));
        if (row_offset < 0) do_top_left = 0;
        add_sample(0, -1);
      } else {
        for (int i = 0; i < std::min((int)bh4, d.mi_rows - mi_row);) {
          int step = kNum4x4H[d.MI(d.mi_size, mi_row + i, mi_col - 1)];
          add_sample(i, -1);
          i += step;
        }
      }
    }
    if (do_top_left) add_sample(-1, -1);
    if (do_top_right && std::max(bw4, bh4) <= 16 && has_top_right())
      add_sample(-1, bw4);
    if (num_samples == 0 && num_samples_scanned > 0) num_samples = 1;
  }

  // -- inter prediction (spec 7.11.3) --------------------------------------
  // the rounding variables (7.11.3.2) of a prediction with one reference
  int round0() const { return d.bitdepth == 12 ? 5 : 3; }
  int round1() const { return d.bitdepth == 12 ? 9 : 11; }

  // motion_vector_scaling (7.11.3.3): the prediction's first position and
  // steps in 1/1024 of a sample of the reference
  void mv_scaling(int plane, int ref, int x, int y, const int* mv,
                  int& start_x, int& start_y, int& step_x, int& step_y) const {
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int64_t orig_x = ((int64_t)x << 4) + ((2 * mv[1]) >> sx) + 8;
    int64_t orig_y = ((int64_t)y << 4) + ((2 * mv[0]) >> sy) + 8;
    int64_t base_x = orig_x * d.x_scale[ref] - ((int64_t)8 << 14);
    int64_t base_y = orig_y * d.y_scale[ref] - ((int64_t)8 << 14);
    start_x = round2signed(base_x, 14 + 4 - 10) + 32;
    start_y = round2signed(base_y, 14 + 4 - 10) + 32;
    step_x = round2signed(d.x_scale[ref], 14 - 10);
    step_y = round2signed(d.y_scale[ref], 14 - 10);
  }

  // block_inter_prediction (7.11.3.4): the reference's samples (clamped to
  // its upscaled frame) through the filters of the block at (cand_row,
  // cand_col), 4-tap where the prediction is 4 wide or high
  void block_inter(int ref, int plane, int x, int y, int step_x, int step_y,
                   int w, int h, int cand_row, int cand_col, int r1,
                   int32_t* out) {
    const RefPic<Pixel>& R = *d.refs[ref];
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    const Plane<Pixel>& P = R.planes[plane];
    int last_x = ((R.fh.upscaled_width + sx) >> sx) - 1;
    int last_y = ((R.fh.height + sy) >> sy) - 1;
    int ih = (((h - 1) * step_y + (1 << 10) - 1) >> 10) + 8;
    size_t at = ((size_t)cand_row * d.mi_cols + cand_col) * 2;
    int fh_idx = d.interp[at + 1], fv_idx = d.interp[at];
    if (w <= 4) fh_idx = (fh_idx == 0 || fh_idx == 2) ? 4 : fh_idx == 1 ? 5 : fh_idx;
    if (h <= 4) fv_idx = (fv_idx == 0 || fv_idx == 2) ? 4 : fv_idx == 1 ? 5 : fv_idx;
    int r0 = round0();
    int32_t* tmp = inter_tmp;
    for (int r = 0; r < ih; ++r) {
      const Pixel* row =
          P.buf.data() + (size_t)clip3(0, last_y, (y >> 10) + r - 3) * P.stride;
      for (int c = 0; c < w; ++c) {
        int p = x + step_x * c;
        const int16_t* f = g_tab.subpel[fh_idx][(p >> 6) & 15];
        int base = (p >> 10) - 3;
        int s = 0;
        if (base >= 0 && base + 7 <= last_x) {
          for (int t = 0; t < 8; ++t) s += f[t] * row[base + t];
        } else {
          for (int t = 0; t < 8; ++t) s += f[t] * row[clip3(0, last_x, base + t)];
        }
        tmp[r * w + c] = round2(s, r0);
      }
    }
    for (int r = 0; r < h; ++r) {
      int p = (y & 1023) + step_y * r;
      const int16_t* f = g_tab.subpel[fv_idx][(p >> 6) & 15];
      const int32_t* col = tmp + (p >> 10) * w;
      for (int c = 0; c < w; ++c) {
        int s = 0;
        for (int t = 0; t < 8; ++t) s += f[t] * col[t * w + c];
        out[r * w + c] = round2(s, r1);
      }
    }
  }

  // resolve_divisor (7.11.3.7): Div_Lut's factor and shift of d
  static int resolve_divisor(int64_t dv, int* shift) {
    int n = 63 - __builtin_clzll((uint64_t)dv);
    int64_t e = dv - ((int64_t)1 << n);
    int64_t f = n > 8 ? round2l(e, n - 8) : e << (8 - n);
    *shift = n + 14;
    return g_tab.div_lut[f];
  }

  // setupShear (7.11.3.6): the warp's shears, false where they are too
  // large for the filter (or the model degenerate)
  static bool setup_shear(const int* wm, int* abcd) {
    if (wm[2] <= 0) return false;
    auto reduce = [](int64_t v) {
      int c = (int)clip3l(-32768, 32767, v);
      int a = (std::abs(c) + 32) >> 6;
      return (c < 0 ? -a : a) * 64;
    };
    int alpha = reduce(wm[2] - (1 << kWmBits));
    int beta = reduce(wm[3]);
    int shift;
    int64_t y = resolve_divisor(wm[2], &shift);
    int64_t v1 = (int64_t)wm[4] * (1 << kWmBits) * y;
    int gamma = reduce(round2signed64(v1, shift));
    int64_t v2 = ((int64_t)wm[3] * wm[4]) * y;
    int delta = reduce(wm[5] - round2signed64(v2, shift) - (1 << kWmBits));
    abcd[0] = alpha;
    abcd[1] = beta;
    abcd[2] = gamma;
    abcd[3] = delta;
    return 4 * std::abs(alpha) + 7 * std::abs(beta) < (1 << kWmBits) &&
           4 * std::abs(gamma) + 4 * std::abs(delta) < (1 << kWmBits);
  }
  // Round2Signed of a 64-bit product, its magnitude taken as an int as
  // libdav1d takes it
  static int64_t round2signed64(int64_t x, int n) {
    uint64_t a = x < 0 ? (uint64_t)0 - (uint64_t)x : (uint64_t)x;
    int v = (int)(uint32_t)((a + (((uint64_t)1 << n) >> 1)) >> n);
    return x < 0 ? -(int64_t)v : v;
  }

  // warpEstimation (7.11.3.8): the local warp's least-squares model from
  // the samples, false where it is degenerate or its shears invalid
  bool warp_estimation() {
    int64_t A[2][2] = {{0, 0}, {0, 0}}, Bx[2] = {0, 0}, By[2] = {0, 0};
    int mid_y = mi_row * 4 + bh4 * 2 - 1, mid_x = mi_col * 4 + bw4 * 2 - 1;
    int suy = mid_y * 8, sux = mid_x * 8;
    int duy = suy + bmv[0][0], dux = sux + bmv[0][1];
    auto ls = [](int64_t a, int64_t b) { return ((a * b) >> 2) + (a + b); };
    for (int i = 0; i < num_samples; ++i) {
      int sy = cand_list[i][0] - suy, sx = cand_list[i][1] - sux;
      int dy = cand_list[i][2] - duy, dx = cand_list[i][3] - dux;
      if (std::abs(sx - dx) < 256 && std::abs(sy - dy) < 256) {
        A[0][0] += ls(sx, sx) + 8;
        A[0][1] += ls(sx, sy) + 4;
        A[1][1] += ls(sy, sy) + 8;
        Bx[0] += ls(sx, dx) + 8;
        Bx[1] += ls(sy, dx) + 4;
        By[0] += ls(sx, dy) + 4;
        By[1] += ls(sy, dy) + 8;
      }
    }
    int64_t det = A[0][0] * A[1][1] - A[0][1] * A[0][1];
    if (det == 0) return false;
    int shift;
    int64_t div = resolve_divisor(det < 0 ? -det : det, &shift);
    if (det < 0) div = -div;
    shift -= kWmBits;
    if (shift < 0) {
      div *= (int64_t)1 << -shift;
      shift = 0;
    }
    auto diag = [&](int64_t v) {
      return (int)clip3l((1 << kWmBits) - (1 << 13) + 1,
                         (1 << kWmBits) + (1 << 13) - 1,
                         round2signed64(v * div, shift));
    };
    auto nondiag = [&](int64_t v) {
      return (int)clip3l(-(1 << 13) + 1, (1 << 13) - 1,
                         round2signed64(v * div, shift));
    };
    int* wm = local_warp;
    wm[2] = diag(A[1][1] * Bx[0] - A[0][1] * Bx[1]);
    wm[3] = nondiag(-A[0][1] * Bx[0] + A[0][0] * Bx[1]);
    wm[4] = nondiag(A[1][1] * By[0] - A[0][1] * By[1]);
    wm[5] = diag(-A[0][1] * By[0] + A[0][0] * By[1]);
    int vx = bmv[0][1] * (1 << (kWmBits - 3)) -
             (mid_x * (wm[2] - (1 << kWmBits)) + mid_y * wm[3]);
    int vy = bmv[0][0] * (1 << (kWmBits - 3)) -
             (mid_x * wm[4] + mid_y * (wm[5] - (1 << kWmBits)));
    wm[0] = clip3(-(1 << 23), (1 << 23) - 1, vx);
    wm[1] = clip3(-(1 << 23), (1 << 23) - 1, vy);
    int abcd[4];
    return setup_shear(wm, abcd);
  }

  // block_warp (7.11.3.5): the 8x8 block (i8, j8) of a warped prediction,
  // the filters' positions on libaom's 64-step grid
  void block_warp(const int* wm, int ref, int plane, int x, int y, int i8,
                  int j8, int w, int h, int r1, int32_t* out) {
    const RefPic<Pixel>& R = *d.refs[ref];
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    const Plane<Pixel>& P = R.planes[plane];
    int last_x = ((R.fh.upscaled_width + sx) >> sx) - 1;
    int last_y = ((R.fh.height + sy) >> sy) - 1;
    int abcd[4];
    setup_shear(wm, abcd);
    int64_t src_x = (x + j8 * 8 + 4) << sx;
    int64_t src_y = (y + i8 * 8 + 4) << sy;
    int64_t dst_x = (int64_t)wm[2] * src_x + (int64_t)wm[3] * src_y + wm[0];
    int64_t dst_y = (int64_t)wm[4] * src_x + (int64_t)wm[5] * src_y + wm[1];
    int64_t x4 = dst_x >> sx, y4 = dst_y >> sy;
    int ix4 = (int)(x4 >> kWmBits), iy4 = (int)(y4 >> kWmBits);
    int sx4 = (int)(x4 & ((1 << kWmBits) - 1)) & ~63;
    int sy4 = (int)(y4 & ((1 << kWmBits) - 1)) & ~63;
    int r0 = round0();
    int tmp[15][8];
    for (int i1 = -7; i1 < 8; ++i1) {
      const Pixel* row = P.buf.data() +
                         (size_t)clip3(0, last_y, iy4 + i1) * P.stride;
      for (int i2 = -4; i2 < 4; ++i2) {
        int s4 = sx4 + abcd[0] * i2 + abcd[1] * i1;
        const int16_t* f = g_tab.warped[((s4 + 512) >> 10) + 64];
        int s = 0;
        for (int i3 = 0; i3 < 8; ++i3)
          s += f[i3] * row[clip3(0, last_x, ix4 + i2 - 3 + i3)];
        tmp[i1 + 7][i2 + 4] = round2(s, r0);
      }
    }
    for (int i1 = -4; i1 < std::min(4, h - i8 * 8 - 4); ++i1)
      for (int i2 = -4; i2 < std::min(4, w - j8 * 8 - 4); ++i2) {
        int s4 = sy4 + abcd[2] * i2 + abcd[3] * i1;
        const int16_t* f = g_tab.warped[((s4 + 512) >> 10) + 64];
        int s = 0;
        for (int i3 = 0; i3 < 8; ++i3) s += f[i3] * tmp[i1 + i3 + 4][i2 + 4];
        out[(i8 * 8 + i1 + 4) * w + j8 * 8 + i2 + 4] = round2(s, r1);
      }
  }

  // predict_inter (7.11.3.1): each reference's prediction from the
  // block's (or, for chroma of a small block, its neighbour's) vector,
  // warped where the local or global model allows, then the compound
  // average, distance weights or mask, or interintra's blend
  void predict_inter(int plane, int base_x, int base_y, int w, int h,
                     int cand_row, int cand_col) {
    int compound = RF(cand_row, cand_col, 1) > INTRA_FRAME;
    int r1 = compound ? 7 : round1();
    int post = 14 - round0() - r1;  // InterPostRound
    for (int list = 0; list < 1 + compound; ++list) {
      int ref = RF(cand_row, cand_col, list);
      const int32_t* mvp = MV4(cand_row, cand_col, list);
      int mv[2] = {mvp[0], mvp[1]};
      int32_t* pred = preds[list];
      int use_warp = 0, abcd[4];
      int global = (y_mode == GLOBALMV || y_mode == GLOBAL_GLOBALMV) &&
                   fh.gm_type[ref] > GM_TRANSLATION;
      if (w >= 8 && h >= 8 && !fh.force_integer_mv) {
        if (motion_mode == LOCALWARP && local_valid)
          use_warp = 1;
        else if (global && !is_scaled(ref) &&
                 setup_shear(fh.gm_params[ref], abcd))
          use_warp = 2;
      }
      if (use_warp) {
        const int* wm = use_warp == 1 ? local_warp : fh.gm_params[ref];
        for (int i8 = 0; i8 <= ((h - 1) >> 3); ++i8)
          for (int j8 = 0; j8 <= ((w - 1) >> 3); ++j8)
            block_warp(wm, ref, plane, base_x, base_y, i8, j8, w, h, r1, pred);
        if (plane == 0 && list == 0)
          ++n_tool[use_warp == 1 ? TOOL_LOCAL_WARP : TOOL_GLOBAL_WARP];
      } else {
        int x0, y0, stx, sty;
        mv_scaling(plane, ref, base_x, base_y, mv, x0, y0, stx, sty);
        block_inter(ref, plane, x0, y0, stx, sty, w, h, cand_row, cand_col,
                    r1, pred);
        // a block predicted wholly from outside its reference (the clamped
        // edge samples)
        if (plane == 0 && list == 0) {
          int64_t left = x0 >> 10, top = y0 >> 10;
          int64_t right = (x0 + (int64_t)(w - 1) * stx) >> 10;
          int64_t bottom = (y0 + (int64_t)(h - 1) * sty) >> 10;
          const FrameHdr& rh = d.refs[ref]->fh;
          n_tool[TOOL_MV_OUTSIDE] += right + 4 < 0 || bottom + 4 < 0 ||
                                     left - 3 >= rh.upscaled_width ||
                                     top - 3 >= rh.height;
        }
      }
    }
    auto& P = d.cur[plane];
    const int32_t* p0 = preds[0];
    const int32_t* p1 = preds[1];
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    if (compound) {
      if (compound_type == COMPOUND_AVERAGE) {
        for (int i = 0; i < h; ++i) {
          Pixel* dst = P.row(base_y + i) + base_x;
          for (int j = 0; j < w; ++j)
            dst[j] = d.clip1(round2(p0[i * w + j] + p1[i * w + j], 1 + post));
        }
        return;
      }
      if (compound_type == COMPOUND_DISTANCE) {
        int fwd, bck;
        distance_weights(&fwd, &bck);
        for (int i = 0; i < h; ++i) {
          Pixel* dst = P.row(base_y + i) + base_x;
          for (int j = 0; j < w; ++j)
            dst[j] = d.clip1(
                round2(fwd * p0[i * w + j] + bck * p1[i * w + j], 4 + post));
        }
        return;
      }
      // the masks of the luma block, subsampled for chroma
      int mw = bw4 * 4;
      const uint8_t* mk;
      if (compound_type == COMPOUND_WEDGE) {
        mk = wedge_mask(mi_sz, wedge_sign, wedge_index);
      } else {
        if (plane == 0)
          for (int i = 0; i < h * w; ++i) {
            int diff = round2(std::abs(p0[i] - p1[i]), d.bitdepth - 8 + post);
            int m = clip3(0, 64, 38 + diff / 16);
            diff_mask[i] = (uint8_t)(mask_type ? 64 - m : m);
          }
        mk = diff_mask;
      }
      for (int i = 0; i < h; ++i) {
        Pixel* dst = P.row(base_y + i) + base_x;
        for (int j = 0; j < w; ++j) {
          int m = sub_mask(mk, mw, i, j, sx, sy);
          dst[j] = d.clip1(round2(m * p0[i * w + j] + (64 - m) * p1[i * w + j],
                                  6 + post));
        }
      }
      return;
    }
    if (!(interintra && is_inter)) {
      for (int i = 0; i < h; ++i) {
        Pixel* dst = P.row(base_y + i) + base_x;
        for (int j = 0; j < w; ++j) dst[j] = d.clip1(p0[i * w + j]);
      }
      return;
    }
    // interintra: the intra prediction is in the frame, blended by the
    // smooth mask of its mode at the plane's size, or the wedge's of the
    // luma block, subsampled for chroma
    const uint8_t* mk = wedge_interintra ? wedge_mask(mi_sz, 0, wedge_index)
                                         : nullptr;
    int scale = 128 / std::max(h, w);
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int m = 32;
        if (mk)
          m = sub_mask(mk, bw4 * 4, i, j, sx, sy);
        else if (interintra_mode == 1)
          m = g_tab.ii_weights[i * scale];
        else if (interintra_mode == 2)
          m = g_tab.ii_weights[j * scale];
        else if (interintra_mode == 3)
          m = g_tab.ii_weights[std::min(i, j) * scale];
        Pixel& px = P.at(base_x + j, base_y + i);
        px = (Pixel)round2(m * px + (64 - m) * d.clip1(p0[i * w + j]), 6);
      }
  }

  // a luma mask at a plane's position (7.11.3.14)
  static int sub_mask(const uint8_t* mk, int mw, int i, int j, int sx,
                      int sy) {
    const uint8_t* a = mk + (size_t)(i << sy) * mw + (j << sx);
    if (!sx && !sy) return a[0];
    if (sx && !sy) return round2(a[0] + a[1], 1);
    if (!sx && sy) return round2(a[0] + a[mw], 1);
    return round2(a[0] + a[1] + a[mw] + a[mw + 1], 2);
  }

  // the distance weights (7.11.3.15) of a COMPOUND_DISTANCE block, as
  // libaom's av1_dist_wtd_comp_weight_assign compares the distances
  void distance_weights(int* fwd, int* bck) const {
    int d0 = clip3(0, 31, std::abs(get_relative_dist(
                              d.seq, fh.order_hints[ref_frame[1]],
                              fh.order_hint)));
    int d1 = clip3(0, 31, std::abs(get_relative_dist(
                              d.seq, fh.order_hint,
                              fh.order_hints[ref_frame[0]])));
    int order = d0 <= d1;
    int i = 3;
    if (d0 && d1)
      for (i = 0; i < 3; ++i) {
        int c0 = g_tab.quant_dist_weight[i][order];
        int c1 = g_tab.quant_dist_weight[i][!order];
        if ((d0 > d1 && d0 * c0 < d1 * c1) || (d0 <= d1 && d0 * c0 > d1 * c1))
          break;
      }
    *fwd = g_tab.quant_dist_lookup[i][order];
    *bck = g_tab.quant_dist_lookup[i][1 - order];
  }

  // the wedge masks (7.11.3.11): MasterMask built once, then
  // WedgeMasks[bsize][sign][index]
  static const uint8_t* wedge_mask(int bsize, int sign, int index) {
    static std::once_flag once;
    static std::vector<uint8_t> masks[22][2][16];
    std::call_once(once, []() {
      static uint8_t master[6][64][64];
      enum { HORZ, VERT, O27, O63, O117, O153 };
      for (int j = 0; j < 64; ++j) {
        int shift = 16;
        for (int i = 0; i < 64; i += 2) {
          master[O63][i][j] = g_tab.wedge_master[0][clip3(0, 63, j - shift)];
          --shift;
          master[O63][i + 1][j] = g_tab.wedge_master[1][clip3(0, 63, j - shift)];
          master[VERT][i][j] = g_tab.wedge_master[2][j];
          master[VERT][i + 1][j] = g_tab.wedge_master[2][j];
        }
      }
      for (int i = 0; i < 64; ++i)
        for (int j = 0; j < 64; ++j) {
          int msk = master[O63][i][j];
          master[O27][j][i] = (uint8_t)msk;
          master[O117][i][63 - j] = (uint8_t)(64 - msk);
          master[O153][63 - j][i] = (uint8_t)(64 - msk);
          master[HORZ][j][i] = master[VERT][i][j];
        }
      for (int bs = BLOCK_8X8; bs < 22; ++bs) {
        if (!kWedgeBits[bs]) continue;
        int w = kNum4x4W[bs] * 4, h = kNum4x4H[bs] * 4;
        int shape = h > w ? 0 : h < w ? 1 : 2;
        for (int wedge = 0; wedge < 16; ++wedge) {
          const uint8_t* code = g_tab.wedge_codebook[shape][wedge];
          int dir = code[0];
          int xoff = 32 - ((code[1] * w) >> 3);
          int yoff = 32 - ((code[2] * h) >> 3);
          int sum = 0;
          for (int i = 0; i < w; ++i) sum += master[dir][yoff][xoff + i];
          for (int i = 1; i < h; ++i) sum += master[dir][yoff + i][xoff];
          int avg = (sum + (w + h - 1) / 2) / (w + h - 1);
          int flip = avg < 32;
          masks[bs][flip][wedge].resize((size_t)w * h);
          masks[bs][!flip][wedge].resize((size_t)w * h);
          for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) {
              int m = master[dir][yoff + i][xoff + j];
              masks[bs][flip][wedge][(size_t)i * w + j] = (uint8_t)m;
              masks[bs][!flip][wedge][(size_t)i * w + j] = (uint8_t)(64 - m);
            }
        }
      }
    });
    return masks[bsize][sign][index].data();
  }

  // overlapped motion compensation (7.11.3.10): the above and left
  // neighbours' predictions blended into the block's edges
  void obmc(int plane, int w, int h) {
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    auto& P = d.cur[plane];
    int32_t* pred = preds[1];
    if (avail_u && kSsSize[mi_sz][sx][sy] >= BLOCK_8X8) {
      int n = 0, limit = std::min(4, (int)kMiWLog2[mi_sz]);
      for (int x4 = mi_col; n < limit && x4 < std::min(d.mi_cols, mi_col + bw4);) {
        int cand_row = mi_row - 1, cand_col = x4 | 1;
        int step = clip3(2, 16, (int)kNum4x4W[d.MI(d.mi_size, cand_row, cand_col)]);
        if (RF(cand_row, cand_col, 0) > INTRA_FRAME) {
          ++n;
          int pw = std::min(w, (step * 4) >> sx);
          int ph = std::min(h >> 1, 32 >> sy);
          overlap(plane, cand_row, cand_col, x4, mi_row, pw, ph, pred);
          const uint8_t* mask = g_tab.obmc_mask + ph;
          int px = (x4 * 4) >> sx, py = (mi_row * 4) >> sy;
          for (int i = 0; i < ph; ++i)
            for (int j = 0; j < pw; ++j) {
              Pixel& v = P.at(px + j, py + i);
              v = (Pixel)round2(mask[i] * v + (64 - mask[i]) * pred[i * pw + j], 6);
            }
        }
        x4 += step;
      }
    }
    if (avail_l) {
      int n = 0, limit = std::min(4, (int)kMiHLog2[mi_sz]);
      for (int y4 = mi_row; n < limit && y4 < std::min(d.mi_rows, mi_row + bh4);) {
        int cand_col = mi_col - 1, cand_row = y4 | 1;
        int step = clip3(2, 16, (int)kNum4x4H[d.MI(d.mi_size, cand_row, cand_col)]);
        if (RF(cand_row, cand_col, 0) > INTRA_FRAME) {
          ++n;
          int pw = std::min(w >> 1, 32 >> sx);
          int ph = std::min(h, (step * 4) >> sy);
          overlap(plane, cand_row, cand_col, mi_col, y4, pw, ph, pred);
          const uint8_t* mask = g_tab.obmc_mask + pw;
          int px = (mi_col * 4) >> sx, py = (y4 * 4) >> sy;
          for (int i = 0; i < ph; ++i)
            for (int j = 0; j < pw; ++j) {
              Pixel& v = P.at(px + j, py + i);
              v = (Pixel)round2(mask[j] * v + (64 - mask[j]) * pred[i * pw + j], 6);
            }
        }
        y4 += step;
      }
    }
  }

  // predict_overlap: the neighbour's prediction over the block's edge
  void overlap(int plane, int cand_row, int cand_col, int x4, int y4, int w,
               int h, int32_t* out) {
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int ref = RF(cand_row, cand_col, 0);
    const int32_t* mvp = MV4(cand_row, cand_col, 0);
    int mv[2] = {mvp[0], mvp[1]};
    int px = (x4 * 4) >> sx, py = (y4 * 4) >> sy;
    int x0, y0, stx, sty;
    mv_scaling(plane, ref, px, py, mv, x0, y0, stx, sty);
    block_inter(ref, plane, x0, y0, stx, sty, w, h, cand_row, cand_col,
                round1(), out);
    for (int i = 0; i < w * h; ++i) out[i] = d.clip1(out[i]);
  }

  // compute_prediction of an inter frame's inter block: interintra's intra
  // prediction first, then each plane's inter prediction (a chroma block
  // that covers several small luma blocks takes each one's vector, unless
  // one of them is intra), then OBMC
  void predict_inter_block() {
    int sb_mask = d.seq.sb128 ? 31 : 15;
    int sub_r = mi_row & sb_mask, sub_c = mi_col & sb_mask;
    local_valid = motion_mode == LOCALWARP && warp_estimation();
    n_tool[TOOL_WARP_INVALID] += motion_mode == LOCALWARP && !local_valid;
    for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      int psz = kSsSize[mi_sz][sx][sy];
      int n4w = kNum4x4W[psz], n4h = kNum4x4H[psz];
      int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
      int cand_row = (mi_row >> sy) << sy, cand_col = (mi_col >> sx) << sx;
      if (interintra) {
        static const int kIiMode[4] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED};
        int have_ar = bd(p, (sub_r >> sy) - 1, (sub_c >> sx) + n4w);
        int have_bl = bd(p, (sub_r >> sy) + n4h, (sub_c >> sx) - 1);
        predict_intra(p, base_x, base_y, p == 0 ? avail_l : avail_l_chroma,
                      p == 0 ? avail_u : avail_u_chroma, have_ar, have_bl,
                      kIiMode[interintra_mode], kMiWLog2[psz] + 2,
                      kMiHLog2[psz] + 2);
      }
      int pred_w = bw4 * 4 >> sx, pred_h = bh4 * 4 >> sy;
      // (a block that crosses the frame's edge: the MIs past it are those
      // of the blocks at its last row and column)
      int some_intra = 0;
      for (int r = 0; r < (n4h << sy); ++r)
        for (int c = 0; c < (n4w << sx); ++c)
          if (RF(std::min(cand_row + r, d.mi_rows - 1),
                 std::min(cand_col + c, d.mi_cols - 1), 0) == INTRA_FRAME)
            some_intra = 1;
      if (some_intra) {
        pred_w = n4w * 4;
        pred_h = n4h * 4;
        cand_row = mi_row;
        cand_col = mi_col;
      }
      int r = 0;
      for (int y = 0; y < n4h * 4; y += pred_h, ++r) {
        int c = 0;
        for (int x = 0; x < n4w * 4; x += pred_w, ++c)
          predict_inter(p, base_x + x, base_y + y, pred_w, pred_h,
                        cand_row + r, cand_col + c);
      }
      if (motion_mode == OBMC) obmc(p, n4w * 4, n4h * 4);
    }
  }

  // -- tx size -------------------------------------------------------------
  int get_above_tx_width(int row, int col) {
    if (row == mi_row) {
      if (!avail_u) return 64;
      size_t i = (size_t)(row - 1) * d.mi_cols + col;
      if (d.skips[i] && d.is_inters[i]) return kNum4x4W[d.mi_size[i]] * 4;
    }
    return kTxW[d.MI(d.inter_tx_sizes, row - 1, col)];
  }
  int get_left_tx_height(int row, int col) {
    if (col == mi_col) {
      if (!avail_l) return 64;
      size_t i = (size_t)row * d.mi_cols + col - 1;
      if (d.skips[i] && d.is_inters[i]) return kNum4x4H[d.mi_size[i]] * 4;
    }
    return kTxH[d.MI(d.inter_tx_sizes, row, col - 1)];
  }

  void read_tx_size(int allow_select) {
    if (lossless) {
      tx_size = TX_4X4;
      return;
    }
    int max_rect = kMaxTxRect[mi_sz];
    int max_depth = kMaxTxDepth[mi_sz];
    tx_size = max_rect;
    if (mi_sz > BLOCK_4X4 && allow_select && fh.tx_mode == TX_MODE_SELECT) {
      int maxw = kTxW[max_rect], maxh = kTxH[max_rect];
      int above_w = 0, left_h = 0;
      if (avail_u) {
        size_t i = (size_t)(mi_row - 1) * d.mi_cols + mi_col;
        above_w = d.is_inters[i] ? kNum4x4W[d.mi_size[i]] * 4
                                 : get_above_tx_width(mi_row, mi_col);
      }
      if (avail_l) {
        size_t i = (size_t)mi_row * d.mi_cols + mi_col - 1;
        left_h = d.is_inters[i] ? kNum4x4H[d.mi_size[i]] * 4
                                : get_left_tx_height(mi_row, mi_col);
      }
      int ctx = (above_w >= maxw) + (left_h >= maxh);
      int depth;
      if (max_depth > 1) {
        int cat = max_depth == 4 ? 2 : max_depth == 3 ? 1 : 0;
        depth = ms.symbol(cdf.tx_depth[cat][ctx], 3);
      } else {
        depth = ms.symbol(cdf.tx_8x8[ctx], 2);
      }
      for (int i = 0; i < depth; ++i) tx_size = kSplitTx[tx_size];
    }
  }

  void read_var_tx_size(int row, int col, int txsz, int depth) {
    if (row >= d.mi_rows || col >= d.mi_cols) return;
    int split = 0;
    if (txsz != TX_4X4 && depth != 2) {  // MAX_VARTX_DEPTH
      int above = get_above_tx_width(row, col) < kTxW[txsz];
      int left = get_left_tx_height(row, col) < kTxH[txsz];
      int size = std::min(64, std::max(kNum4x4W[mi_sz], kNum4x4H[mi_sz]) * 4);
      int max_tx = size == 64 ? TX_64X64 : size == 32 ? TX_32X32
                   : size == 16 ? TX_16X16 : TX_8X8;
      int ctx = (kTxSqrUp[txsz] != max_tx) * 3 + (TX_64X64 - max_tx) * 6 +
                above + left;
      split = ms.symbol(cdf.txfm_split[ctx], 2);
    }
    int w4 = kTxW[txsz] >> 2, h4 = kTxH[txsz] >> 2;
    if (split) {
      int sub = kSplitTx[txsz];
      int sw = kTxW[sub] >> 2, sh = kTxH[sub] >> 2;
      for (int i = 0; i < h4; i += sh)
        for (int j = 0; j < w4; j += sw)
          read_var_tx_size(row + i, col + j, sub, depth + 1);
    } else {
      for (int i = 0; i < h4 && row + i < d.mi_rows; ++i)
        for (int j = 0; j < w4 && col + j < d.mi_cols; ++j)
          d.MI(d.inter_tx_sizes, row + i, col + j) = (uint8_t)txsz;
      tx_size = txsz;
    }
  }

  void read_block_tx_size() {
    if (fh.tx_mode == TX_MODE_SELECT && mi_sz > BLOCK_4X4 && is_inter &&
        !skip && !lossless) {
      int max_tx = kMaxTxRect[mi_sz];
      int tw4 = kTxW[max_tx] >> 2, th4 = kTxH[max_tx] >> 2;
      for (int row = mi_row; row < mi_row + bh4; row += th4)
        for (int col = mi_col; col < mi_col + bw4; col += tw4)
          read_var_tx_size(row, col, max_tx, 0);
    } else {
      read_tx_size(!skip || !is_inter);
      int rows = std::min(bh4, d.mi_rows - mi_row);
      int cols = std::min(bw4, d.mi_cols - mi_col);
      for (int y = 0; y < rows; ++y)
        memset(&d.MI(d.inter_tx_sizes, mi_row + y, mi_col), tx_size, cols);
    }
  }

  void reset_block_context() {
    for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); ++i) {
        above_level[p][i] = 0;
        above_dc[p][i] = 0;
      }
      for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); ++i) {
        left_level[p][i] = 0;
        left_dc[p][i] = 0;
      }
    }
  }

  // -- block ---------------------------------------------------------------
  void decode_block(int r, int c, int sub, int part) {
    mi_row = r;
    mi_col = c;
    mi_sz = sub;
    partition = part;
    bw4 = kNum4x4W[sub];
    bh4 = kNum4x4H[sub];
    if (bh4 == 1 && d.ssy && (mi_row & 1) == 0)
      has_chroma = 0;
    else if (bw4 == 1 && d.ssx && (mi_col & 1) == 0)
      has_chroma = 0;
    else
      has_chroma = d.planes > 1;
    if (has_chroma && kSsSize[sub][d.ssx][d.ssy] == BLOCK_INVALID)
      bad("block size invalid for the chroma subsampling");
    avail_u = is_inside(r - 1, c);
    avail_l = is_inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (d.ssy && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
      if (d.ssx && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    if (fh.inter)
      inter_frame_mode_info();
    else
      intra_frame_mode_info();
    if (pal_size_y || pal_size_uv) palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context();
    int rows = std::min(bh4, d.mi_rows - r), cols = std::min(bw4, d.mi_cols - c);
    for (int y = 0; y < rows; ++y)
      for (int x = 0; x < cols; ++x) {
        size_t i = (size_t)(r + y) * d.mi_cols + c + x;
        d.y_modes[i] = (uint8_t)y_mode;
        if (has_chroma) d.uv_modes[i] = (uint8_t)uv_mode;
        d.skips[i] = (uint8_t)skip;
        d.mi_size[i] = (uint8_t)mi_sz;
        d.seg_ids[i] = (uint8_t)segment_id;
        d.is_inters[i] = (uint8_t)is_inter;
        for (int k = 0; k < 4; ++k) d.delta_lfs[i * 4 + k] = (int8_t)delta_lf[k];
        if (fh.allow_intrabc) {
          d.mvs[2 * i] = (int16_t)(is_inter ? mv[0] : 0);
          d.mvs[2 * i + 1] = (int16_t)(is_inter ? mv[1] : 0);
        }
        if (fh.inter) {
          d.ref_frames[i * 2] = (int8_t)ref_frame[0];
          d.ref_frames[i * 2 + 1] = (int8_t)ref_frame[1];
          d.mvs4[i * 4] = bmv[0][0];
          d.mvs4[i * 4 + 1] = bmv[0][1];
          d.mvs4[i * 4 + 2] = bmv[1][0];
          d.mvs4[i * 4 + 3] = bmv[1][1];
          d.interp[i * 2] = (uint8_t)interp_filter[0];
          d.interp[i * 2 + 1] = (uint8_t)interp_filter[1];
          d.skip_modes[i] = (uint8_t)skip_mode;
          d.seg_preds[i] = (uint8_t)seg_id_predicted;
          d.comp_groups[i] = (uint8_t)comp_group_idx;
          d.comp_idxs[i] = (uint8_t)compound_idx;
        }
      }
    if (fh.allow_sct) store_palette();
    n_palette += pal_size_y || pal_size_uv;
    n_intrabc += use_intrabc;
    if (fh.inter) {
      n_tool[TOOL_INTER] += is_inter;
      n_tool[TOOL_INTRA_IN_INTER] += !is_inter;
      n_tool[TOOL_SEG_TEMPORAL] += seg_id_predicted;
      if (is_inter) {
        n_tool[TOOL_NEWMV] += y_mode == NEWMV;
        n_tool[TOOL_GLOBALMV] += y_mode == GLOBALMV;
        n_tool[TOOL_SCALED] += is_scaled(ref_frame[0]);
        n_tool[TOOL_SWITCHABLE] += fh.interp_filter == 4;
        n_tool[TOOL_DUAL_FILTER] += interp_filter[0] != interp_filter[1];
        n_tool[TOOL_OBMC] += motion_mode == OBMC;
        n_tool[TOOL_INTERINTRA] += interintra;
        n_tool[TOOL_WEDGE_INTERINTRA] += interintra && wedge_interintra;
        n_tool[TOOL_COMPOUND] += is_compound;
        n_tool[TOOL_SKIP_MODE] += skip_mode;
        if (is_compound) {
          n_tool[TOOL_COMPOUND_DISTANCE] += compound_type == COMPOUND_DISTANCE;
          n_tool[TOOL_COMPOUND_WEDGE] += compound_type == COMPOUND_WEDGE;
          n_tool[TOOL_COMPOUND_DIFFWTD] += compound_type == COMPOUND_DIFFWTD;
        }
      }
    }
    if (is_inter) {
      if (fh.inter)
        predict_inter_block();
      else
        compute_prediction();
    }
    residual();
  }

  int get_tx_size(int plane, int txsz) {
    if (plane == 0) return txsz;
    int uv = kMaxTxRect[kSsSize[mi_sz][d.ssx][d.ssy]];
    if (kTxW[uv] == 64 || kTxH[uv] == 64) {
      if (kTxW[uv] == 16) return TX_16X32;
      if (kTxH[uv] == 16) return TX_32X16;
      return TX_32X32;
    }
    return uv;
  }

  void residual() {
    int sb_mask = d.seq.sb128 ? 31 : 15;
    int width_chunks = std::max(1, (bw4 * 4) >> 6);
    int height_chunks = std::max(1, (bh4 * 4) >> 6);
    int size_chunk =
        (width_chunks > 1 || height_chunks > 1) ? BLOCK_64X64 : mi_sz;
    for (int cy = 0; cy < height_chunks; ++cy)
      for (int cx = 0; cx < width_chunks; ++cx) {
        for (int p = 0; p < 1 + has_chroma * 2; ++p) {
          int txsz = lossless ? TX_4X4 : get_tx_size(p, tx_size);
          int step_x = kTxW[txsz] >> 2, step_y = kTxH[txsz] >> 2;
          int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
          int plane_sz = kSsSize[size_chunk][sx][sy];
          int n4w = kNum4x4W[plane_sz], n4h = kNum4x4H[plane_sz];
          int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          if (is_inter && !lossless && !p) {
            transform_tree(base_x + cx * 64, base_y + cy * 64, n4w * 4,
                           n4h * 4, sb_mask);
            continue;
          }
          for (int y = 0; y < n4h; y += step_y)
            for (int x = 0; x < n4w; x += step_x)
              transform_block(p, base_x, base_y, txsz,
                              x + ((cx << 4) >> sx), y + ((cy << 4) >> sy),
                              sb_mask);
        }
      }
  }

  // The luma transform blocks of an inter block: the var-tx tree's leaves
  void transform_tree(int start_x, int start_y, int w, int h, int sb_mask) {
    if (start_x >= d.mi_cols * 4 || start_y >= d.mi_rows * 4) return;
    int txsz = d.MI(d.inter_tx_sizes, start_y >> 2, start_x >> 2);
    if (w <= kTxW[txsz] && h <= kTxH[txsz]) {
      transform_block(0, start_x, start_y, txsz, 0, 0, sb_mask);
    } else if (w > h) {
      transform_tree(start_x, start_y, w / 2, h, sb_mask);
      transform_tree(start_x + w / 2, start_y, w / 2, h, sb_mask);
    } else if (w < h) {
      transform_tree(start_x, start_y, w, h / 2, sb_mask);
      transform_tree(start_x, start_y + h / 2, w, h / 2, sb_mask);
    } else {
      transform_tree(start_x, start_y, w / 2, h / 2, sb_mask);
      transform_tree(start_x + w / 2, start_y, w / 2, h / 2, sb_mask);
      transform_tree(start_x, start_y + h / 2, w / 2, h / 2, sb_mask);
      transform_tree(start_x + w / 2, start_y + h / 2, w / 2, h / 2, sb_mask);
    }
  }

  void transform_block(int plane, int base_x, int base_y, int txsz, int x,
                       int y, int sb_mask) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sub_r = row & sb_mask, sub_c = col & sb_mask;
    int step_x = kTxW[txsz] >> 2, step_y = kTxH[txsz] >> 2;
    int max_x = (d.mi_cols * 4) >> sx, max_y = (d.mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    if (!is_inter) {
      if (plane == 0 ? pal_size_y : pal_size_uv) {
        predict_palette(plane, start_x, start_y, x, y, txsz);
      } else {
        int is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
        int mode = plane == 0 ? y_mode : is_cfl ? DC_PRED : uv_mode;
        int have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
        int have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
        int have_ar = bd(plane, (sub_r >> sy) - 1, (sub_c >> sx) + step_x);
        int have_bl = bd(plane, (sub_r >> sy) + step_y, (sub_c >> sx) - 1);
        predict_intra(plane, start_x, start_y, have_left, have_above, have_ar,
                      have_bl, mode, kTxWLog2[txsz], kTxHLog2[txsz]);
        if (is_cfl) predict_cfl(plane, start_x, start_y, txsz);
      }
      if (plane == 0) {
        max_luma_w = start_x + step_x * 4;
        max_luma_h = start_y + step_y * 4;
      }
    }
    if (!skip) {
      int tx_type;
      int eob = coeffs(plane, start_x, start_y, txsz, &tx_type);
      if (eob > 0) reconstruct(plane, start_x, start_y, txsz, tx_type);
    }
    for (int i = 0; i < step_y; ++i)
      for (int j = 0; j < step_x; ++j) {
        size_t li = (size_t)((row >> sy) + i) * d.lf_tx_stride[plane] +
                    (col >> sx) + j;
        if (li < d.lf_tx[plane].size()) d.lf_tx[plane][li] = (uint8_t)txsz;
        int by = (sub_r >> sy) + i, bx = (sub_c >> sx) + j;
        if (by < 34 && bx < 34) bd(plane, by, bx) = 1;
      }
  }

  // -- coefficients --------------------------------------------------------
  int get_tx_set(int txsz) const {
    if (kTxSqrUp[txsz] > TX_32X32) return TX_SET_DCTONLY;
    if (is_inter) {
      if (fh.reduced_tx_set || kTxSqrUp[txsz] == TX_32X32)
        return TX_SET_INTER_3;
      if (kTxSqr[txsz] == TX_16X16) return TX_SET_INTER_2;
      return TX_SET_INTER_1;
    }
    if (kTxSqrUp[txsz] == TX_32X32) return TX_SET_DCTONLY;
    if (fh.reduced_tx_set) return TX_SET_INTRA_2;
    if (kTxSqr[txsz] == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  static int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return 2;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return 1;
    return 0;
  }

  const int16_t* default_scan(int txsz) const {
    switch (txsz) {
      case TX_4X4: return g_tab.scan4x4;
      case TX_8X8: return g_tab.scan8x8;
      case TX_16X16: return g_tab.scan16x16;
      case TX_4X8: return g_tab.scan4x8;
      case TX_8X4: return g_tab.scan8x4;
      case TX_8X16: return g_tab.scan8x16;
      case TX_16X8: return g_tab.scan16x8;
      case TX_16X32: return g_tab.scan16x32;
      case TX_32X16: return g_tab.scan32x16;
      case TX_4X16: return g_tab.scan4x16;
      case TX_16X4: return g_tab.scan16x4;
      case TX_8X32: return g_tab.scan8x32;
      case TX_32X8: return g_tab.scan32x8;
      default: return g_tab.scan32x32;
    }
  }

  int coeffs(int plane, int start_x, int start_y, int txsz, int* out_type) {
    int x4 = start_x >> 2, y4 = start_y >> 2;
    int w4 = kTxW[txsz] >> 2, h4 = kTxH[txsz] >> 2;
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int max_x4 = d.mi_cols >> sx, max_y4 = d.mi_rows >> sy;
    int tx_sz_ctx = (kTxSqr[txsz] + kTxSqrUp[txsz] + 1) >> 1;
    int ptype = plane > 0;
    int adj = kAdjTx[txsz];
    int bwl = kTxWLog2[adj];
    int txw = kTxW[adj], txh = kTxH[adj];
    int seg_eob = txw * txh;
    memset(quant, 0, sizeof(int32_t) * seg_eob);
    int eob = 0, cul_level = 0, dc_category = 0;
    // all_zero context
    int ctx;
    int plane_bsize = kSsSize[mi_sz][sx][sy];
    int bw = kNum4x4W[plane_bsize] * 4, bh = kNum4x4H[plane_bsize] * 4;
    int w = kTxW[txsz], h = kTxH[txsz];
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; ++k)
        if (x4 + k < max_x4) top = std::max(top, (int)above_level[0][x4 + k]);
      for (int k = 0; k < h4; ++k)
        if (y4 + k < max_y4)
          left = std::max(left, (int)left_level[0][y4 + k]);
      top = std::min(top, 255);
      left = std::min(left, 255);
      if (bw == w && bh == h)
        ctx = 0;
      else if (top == 0 && left == 0)
        ctx = 1;
      else if (top == 0 || left == 0)
        ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3)
        ctx = 4;
      else if (std::min(top, left) <= 3)
        ctx = 5;
      else
        ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; ++i)
        if (x4 + i < max_x4)
          above |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
      for (int i = 0; i < h4; ++i)
        if (y4 + i < max_y4)
          left |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
      ctx = (above != 0) + (left != 0) + 7;
      if (bw * bh > w * h) ctx += 3;
    }
    int all_zero = ms.symbol(cdf.txb_skip[tx_sz_ctx][ctx], 2);
    int tx_type = DCT_DCT;
    if (!all_zero) {
      // transform_type (luma) / compute_tx_type
      int set = get_tx_set(txsz);
      if (lossless || kTxSqrUp[txsz] > TX_32X32) {
        tx_type = DCT_DCT;
      } else if (plane == 0) {
        int qi = fh.seg_enabled ? get_qindex(1) : fh.base_q_idx;
        int sqr = kTxSqr[txsz];
        if (set > 0 && qi > 0 && is_inter) {
          if (set == TX_SET_INTER_1)
            tx_type = kTxInterInvSet1[ms.symbol(cdf.inter_tx1[sqr], 16)];
          else if (set == TX_SET_INTER_2)
            tx_type = kTxInterInvSet2[ms.symbol(cdf.inter_tx2, 12)];
          else
            tx_type = kTxInterInvSet3[ms.symbol(cdf.inter_tx3[sqr], 2)];
        } else if (set > 0 && qi > 0) {
          int dir = use_filter_intra ? kFilterIntraToDir[filter_intra_mode]
                                     : y_mode;
          if (set == TX_SET_INTRA_1)
            tx_type = kTxInvSet1[ms.symbol(cdf.intra_tx1[sqr][dir], 7)];
          else
            tx_type = kTxInvSet2[ms.symbol(cdf.intra_tx2[sqr][dir], 5)];
        }
      } else if (is_inter) {
        // the co-located luma TxType, where the chroma size's set has it
        int lx = std::max(mi_col, x4 << sx), ly = std::max(mi_row, y4 << sy);
        tx_type = d.MI(d.tx_types, ly, lx);
        if (!((kTxInSetInter[set] >> tx_type) & 1)) tx_type = DCT_DCT;
      } else {
        tx_type = set == TX_SET_DCTONLY ? DCT_DCT : kModeToTxfm[uv_mode];
      }
      int cls = tx_class(tx_type);
      const int16_t* scan;
      int16_t lin[1024];
      if (kTxSqrUp[txsz] == TX_64X64 || tx_type == IDTX || cls == 0) {
        scan = default_scan(adj);
      } else {
        // mrow (V_*: raster) or mcol (H_*: column by column)
        for (int i = 0; i < seg_eob; ++i)
          lin[i] = (int16_t)(cls == 2 ? i : (i % txh) * txw + i / txh);
        scan = lin;
      }
      int eob_multisize = std::min((int)kTxWLog2[txsz], 5) +
                          std::min((int)kTxHLog2[txsz], 5) - 4;
      int c2 = cls == 0 ? 0 : 1;
      int eob_pt;
      switch (eob_multisize) {
        case 0: eob_pt = ms.symbol(cdf.eob_pt_16[ptype][c2], 5) + 1; break;
        case 1: eob_pt = ms.symbol(cdf.eob_pt_32[ptype][c2], 6) + 1; break;
        case 2: eob_pt = ms.symbol(cdf.eob_pt_64[ptype][c2], 7) + 1; break;
        case 3: eob_pt = ms.symbol(cdf.eob_pt_128[ptype][c2], 8) + 1; break;
        case 4: eob_pt = ms.symbol(cdf.eob_pt_256[ptype][c2], 9) + 1; break;
        case 5: eob_pt = ms.symbol(cdf.eob_pt_512[ptype], 10) + 1; break;
        default: eob_pt = ms.symbol(cdf.eob_pt_1024[ptype], 11) + 1; break;
      }
      eob = eob_pt < 2 ? eob_pt : ((1 << (eob_pt - 2)) + 1);
      int eob_shift = eob_pt - 3;
      if (eob_shift >= 0) {
        if (ms.symbol(cdf.eob_extra[tx_sz_ctx][ptype][eob_pt - 3], 2))
          eob += 1 << eob_shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); ++i) {
          eob_shift = std::max(0, eob_pt - 2) - 1 - i;
          if (ms.literal(1)) eob += 1 << eob_shift;
        }
      }
      if (eob > seg_eob) bad("eob");
      for (int c = eob - 1; c >= 0; --c) {
        int pos = scan[c];
        int level;
        if (c == eob - 1) {
          int ectx;
          if (c == 0)
            ectx = 0;
          else if (c <= (txh << bwl) / 8)
            ectx = 1;
          else if (c <= (txh << bwl) / 4)
            ectx = 2;
          else
            ectx = 3;
          level = ms.symbol(cdf.coeff_base_eob[tx_sz_ctx][ptype][ectx], 3) + 1;
        } else {
          level = ms.symbol(
              cdf.coeff_base[tx_sz_ctx][ptype]
                            [coeff_base_ctx(txsz, bwl, txh, cls, pos)],
              4);
        }
        if (level > 2) {
          int bctx = coeff_br_ctx(bwl, txh, cls, pos);
          for (int idx = 0; idx < 4; ++idx) {
            int br = ms.symbol(
                cdf.coeff_br[std::min(tx_sz_ctx, 3)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; ++c) {
        int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dctx = dc_sign_ctx(plane, x4, y4, w4, h4, max_x4, max_y4);
            sign = ms.symbol(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = ms.literal(1);
          }
        }
        if (quant[pos] > 14) {
          int length = 0;
          int bit;
          do {
            ++length;
            bit = ms.literal(1);
            if (length > 32) bad("golomb");
          } while (!bit);
          uint32_t xg = 1;
          for (int i = length - 2; i >= 0; --i) xg = (xg << 1) | ms.literal(1);
          quant[pos] = (int32_t)((xg + 14) & 0xFFFFF);
        }
        if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul_level += quant[pos];
        if (cul_level > (1 << 30)) cul_level = 1 << 30;
        if (sign) quant[pos] = -quant[pos];
      }
      cul_level = std::min(63, cul_level);
    }
    if (plane == 0 && (fh.allow_intrabc || fh.inter))
      for (int i = 0; i < h4 && y4 + i < max_y4; ++i)
        for (int j = 0; j < w4 && x4 + j < max_x4; ++j)
          d.MI(d.tx_types, y4 + i, x4 + j) = (uint8_t)tx_type;
    for (int i = 0; i < w4; ++i) {
      above_level[plane][x4 + i] = (uint8_t)cul_level;
      above_dc[plane][x4 + i] = (uint8_t)dc_category;
    }
    for (int i = 0; i < h4; ++i) {
      left_level[plane][y4 + i] = (uint8_t)cul_level;
      left_dc[plane][y4 + i] = (uint8_t)dc_category;
    }
    *out_type = tx_type;
    return eob;
  }

  int coeff_base_ctx(int txsz, int bwl, int txh, int cls, int pos) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int idx = 0; idx < 5; ++idx) {
      int rr = row + kSigRefDiff[cls][idx][0];
      int cc = col + kSigRefDiff[cls][idx][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
        mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (cls == 0) {
      if (row == 0 && col == 0) return 0;
      return ctx + g_tab.ctx_offset[txsz][std::min(row, 4)][std::min(col, 4)];
    }
    int idx = cls == 2 ? row : col;
    static const int pos_off[3] = {26, 31, 36};
    return ctx + pos_off[std::min(idx, 2)];
  }

  int coeff_br_ctx(int bwl, int txh, int cls, int pos) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int txw = 1 << bwl;
    int mag = 0;
    for (int idx = 0; idx < 3; ++idx) {
      int rr = row + kMagRefOffset[cls][idx][0];
      int cc = col + kMagRefOffset[cls][idx][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < txw)
        mag += std::min(quant[rr * txw + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == 0) {
      if (row < 2 && col < 2) return mag + 7;
    } else if (cls == 1) {
      if (col == 0) return mag + 7;
    } else {
      if (row == 0) return mag + 7;
    }
    return mag + 14;
  }

  int dc_sign_ctx(int plane, int x4, int y4, int w4, int h4, int max_x4,
                  int max_y4) {
    int s = 0;
    for (int k = 0; k < w4; ++k)
      if (x4 + k < max_x4) {
        int v = above_dc[plane][x4 + k];
        if (v == 1) --s;
        else if (v == 2) ++s;
      }
    for (int k = 0; k < h4; ++k)
      if (y4 + k < max_y4) {
        int v = left_dc[plane][y4 + k];
        if (v == 1) --s;
        else if (v == 2) ++s;
      }
    return s < 0 ? 1 : s > 0 ? 2 : 0;
  }

  // -- reconstruction --------------------------------------------------------
  void reconstruct(int plane, int x, int y, int txsz, int tx_type) {
    int log2w = kTxWLog2[txsz], log2h = kTxHLog2[txsz];
    int w = 1 << log2w, h = 1 << log2h;
    int tw = std::min(32, w), th = std::min(32, h);
    // dqDenom, from the size's context (the mean of its square sizes):
    // 1 for 32x32, 16x32, 32x16, 16x64, 64x16; 2 for 32x64, 64x32, 64x64;
    // 0 for 8x32 and 32x8
    int dq_denom = std::max(0, ((kTxSqr[txsz] + kTxSqrUp[txsz] + 1) >> 1) - 2);
    int qindex = get_qindex(0);
    int dc_delta = plane == 0 ? fh.dq_ydc : plane == 1 ? fh.dq_udc : fh.dq_vdc;
    int ac_delta = plane == 0 ? 0 : plane == 1 ? fh.dq_uac : fh.dq_vac;
    int bdi = (d.bitdepth - 8) >> 1;
    int64_t dcq = g_tab.dc_q[bdi][clip3(0, 255, qindex + dc_delta)];
    int64_t acq = g_tab.ac_q[bdi][clip3(0, 255, qindex + ac_delta)];
    // the quantizer matrix, which weights the step of each position (5
    // fractional bits): 2-D transform types only, below level 15; the
    // sizes with a side of 64 take the matrix of the side cut to 32, whose
    // positions row * tw + col the coefficients keep
    const uint8_t* qm = nullptr;
    int qm_level = fh.seg_qm_level[plane][segment_id];
    if (fh.using_qmatrix && qm_level < 15 && tx_type < IDTX)
      qm = g_tab.qm[qm_level][plane > 0] + g_tab.qm_offset[txsz];
    // the clamps of the coefficients (BitDepth + 8 bits) and of the row
    // transforms' output (Max(BitDepth + 6, 16) bits)
    const int64_t hi1 = ((int64_t)1 << (d.bitdepth + 7)) - 1;
    const int64_t hi2 = ((int64_t)1 << (std::max(d.bitdepth + 6, 16) - 1)) - 1;
    // row and column transform kinds, and the flips of FLIPADST
    int row_kind, col_kind, flip_ud = 0, flip_lr = 0;
    switch (tx_type) {
      case ADST_DCT: col_kind = T1D_ADST; row_kind = T1D_DCT; break;
      case DCT_ADST: col_kind = T1D_DCT; row_kind = T1D_ADST; break;
      case ADST_ADST: col_kind = T1D_ADST; row_kind = T1D_ADST; break;
      case IDTX: col_kind = T1D_IDTX; row_kind = T1D_IDTX; break;
      case V_DCT: col_kind = T1D_DCT; row_kind = T1D_IDTX; break;
      case H_DCT: col_kind = T1D_IDTX; row_kind = T1D_DCT; break;
      case V_ADST: col_kind = T1D_ADST; row_kind = T1D_IDTX; break;
      case H_ADST: col_kind = T1D_IDTX; row_kind = T1D_ADST; break;
      case V_FLIPADST:
        col_kind = T1D_ADST; row_kind = T1D_IDTX; flip_ud = 1; break;
      case H_FLIPADST:
        col_kind = T1D_IDTX; row_kind = T1D_ADST; flip_lr = 1; break;
      case FLIPADST_DCT:
        col_kind = T1D_ADST; row_kind = T1D_DCT; flip_ud = 1; break;
      case DCT_FLIPADST:
        col_kind = T1D_DCT; row_kind = T1D_ADST; flip_lr = 1; break;
      case FLIPADST_FLIPADST:
        col_kind = T1D_ADST; row_kind = T1D_ADST; flip_ud = flip_lr = 1;
        break;
      case ADST_FLIPADST:
        col_kind = T1D_ADST; row_kind = T1D_ADST; flip_lr = 1; break;
      case FLIPADST_ADST:
        col_kind = T1D_ADST; row_kind = T1D_ADST; flip_ud = 1; break;
      default: col_kind = T1D_DCT; row_kind = T1D_DCT; break;
    }
    int row_shift = lossless ? 0 : kTxRowShift[txsz];
    int col_shift = lossless ? 0 : 4;
    int rect2 = std::abs(log2w - log2h) == 1;
    int64_t T[64];
    for (int i = 0; i < h; ++i) {
      int64_t* out = resid + (size_t)i * w;
      bool nz = false;
      if (i < th)
        for (int j = 0; j < tw; ++j)
          if (quant[i * tw + j]) {
            nz = true;
            break;
          }
      if (!nz) {
        for (int j = 0; j < w; ++j) out[j] = 0;
        continue;
      }
      for (int j = 0; j < w; ++j) {
        int64_t v = 0;
        if (j < tw) {
          int32_t qv = quant[i * tw + j];
          if (qv) {
            int64_t q = (i == 0 && j == 0) ? dcq : acq;
            if (qm) q = round2l(q * qm[i * tw + j], 5);
            int64_t a = ((int64_t)std::abs(qv) * q) & 0xFFFFFF;
            a >>= dq_denom;
            v = qv < 0 ? -a : a;
            v = clip3l(-hi1 - 1, hi1, v);
          }
        }
        T[j] = v;
      }
      if (rect2)
        for (int j = 0; j < w; ++j) T[j] = round2l(T[j] * 2896, 12);
      if (lossless) {
        iwht(T, 2);
      } else {
        for (int j = 0; j < w; ++j) T[j] = clip3l(-hi1 - 1, hi1, T[j]);
        tx1d(T, row_kind, log2w);
      }
      for (int j = 0; j < w; ++j) {
        int64_t v = round2l(T[j], row_shift);
        if (!lossless) v = clip3l(-hi2 - 1, hi2, v);
        out[j] = v;
      }
    }
    auto& P = d.cur[plane];
    for (int j = 0; j < w; ++j) {
      for (int i = 0; i < h; ++i) T[i] = resid[(size_t)i * w + j];
      if (lossless)
        iwht(T, 0);
      else
        tx1d(T, col_kind, log2h);
      int xx = flip_lr ? w - 1 - j : j;
      for (int i = 0; i < h; ++i) {
        int64_t r = round2l(T[i], col_shift);
        r = clip3l(-100000, 100000, r);
        Pixel& px = P.at(x + xx, y + (flip_ud ? h - 1 - i : i));
        px = d.clip1((int)(px + r));
      }
    }
  }

  // -- intra prediction ------------------------------------------------------
  int is_smooth(int row, int col, int plane) {
    int mode = plane == 0 ? d.MI(d.y_modes, row, col)
                          : d.MI(d.uv_modes, row, col);
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED ||
           mode == SMOOTH_H_PRED;
  }
  int get_filter_type(int plane) {
    int above_smooth = 0, left_smooth = 0;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (d.ssx && !(mi_col & 1)) ++c;
        if (d.ssy && (mi_row & 1)) --r;
      }
      above_smooth = is_smooth(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (d.ssx && (mi_col & 1)) --c;
        if (d.ssy && !(mi_row & 1)) ++r;
      }
      left_smooth = is_smooth(r, c, plane);
    }
    return above_smooth || left_smooth;
  }
  static int edge_filter_strength(int w, int h, int filter_type, int delta) {
    int dd = std::abs(delta);
    int blk = w + h;
    int s = 0;
    if (filter_type == 0) {
      if (blk <= 8) {
        if (dd >= 56) s = 1;
      } else if (blk <= 12) {
        if (dd >= 40) s = 1;
      } else if (blk <= 16) {
        if (dd >= 40) s = 1;
      } else if (blk <= 24) {
        if (dd >= 8) s = 1;
        if (dd >= 16) s = 2;
        if (dd >= 32) s = 3;
      } else if (blk <= 32) {
        if (dd >= 1) s = 1;
        if (dd >= 4) s = 2;
        if (dd >= 32) s = 3;
      } else {
        if (dd >= 1) s = 3;
      }
    } else {
      if (blk <= 8) {
        if (dd >= 40) s = 1;
        if (dd >= 64) s = 2;
      } else if (blk <= 16) {
        if (dd >= 20) s = 1;
        if (dd >= 48) s = 2;
      } else if (blk <= 24) {
        if (dd >= 4) s = 3;
      } else {
        if (dd >= 1) s = 3;
      }
    }
    return s;
  }
  static int use_upsample(int w, int h, int filter_type, int delta) {
    int dd = std::abs(delta);
    int blk = w + h;
    if (dd <= 0 || dd >= 40) return 0;
    return filter_type == 0 ? blk <= 16 : blk <= 8;
  }
  // edge arrays: index i stored at [i + 16]
  static void edge_filter(int* buf, int sz, int strength) {
    if (!strength) return;
    int edge[300];
    for (int i = 0; i < sz; ++i) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; ++i) {
      int s = 0;
      for (int j = 0; j < 5; ++j) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += kIntraEdgeKernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }
  void edge_upsample(int* buf, int num_px) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; ++i) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num_px; ++i) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = d.clip1(round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int have_left, int have_above,
                     int have_ar, int have_bl, int mode, int log2w,
                     int log2h) {
    auto& P = d.cur[plane];
    int w = 1 << log2w, h = 1 << log2h;
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    const int base = 1 << (d.bitdepth - 1);
    int max_x = ((d.mi_cols * 4) >> sx) - 1;
    int max_y = ((d.mi_rows * 4) >> sy) - 1;
    int above_buf[320], left_buf[320];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
    int n = w + h;
    if (!have_above && have_left) {
      int v = P.at(x - 1, y);
      for (int i = -1; i < n; ++i) above[i] = v;
    } else if (!have_above && !have_left) {
      for (int i = -1; i < n; ++i) above[i] = base - 1;
    } else {
      int limit = std::min(max_x, x + (have_ar ? 2 * w : w) - 1);
      const Pixel* rowp = P.row(y - 1);
      for (int i = 0; i < n; ++i) above[i] = rowp[std::min(limit, x + i)];
    }
    if (!have_left && have_above) {
      int v = P.at(x, y - 1);
      for (int i = -1; i < n; ++i) left[i] = v;
    } else if (!have_left && !have_above) {
      for (int i = -1; i < n; ++i) left[i] = base + 1;
    } else {
      int limit = std::min(max_y, y + (have_bl ? 2 * h : h) - 1);
      for (int i = 0; i < n; ++i) left[i] = P.at(x - 1, std::min(limit, y + i));
    }
    int corner;
    if (have_above && have_left)
      corner = P.at(x - 1, y - 1);
    else if (have_above)
      corner = P.at(x, y - 1);
    else if (have_left)
      corner = P.at(x - 1, y);
    else
      corner = base;
    above[-1] = corner;
    left[-1] = corner;

    Pixel pred[64 * 64];
    if (plane == 0 && use_filter_intra) {
      recursive_intra(pred, above, left, w, h);
    } else if (is_directional(mode)) {
      int angle_delta = plane == 0 ? angle_delta_y : angle_delta_uv;
      int p_angle = kModeToAngle[mode] + angle_delta * 3;
      directional(plane, pred, above, left, w, h, x, y, max_x, max_y,
                  have_left, have_above, p_angle);
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED ||
               mode == SMOOTH_H_PRED) {
      const uint8_t* wx = g_tab.sm_weights + (w - 4);
      const uint8_t* wy = g_tab.sm_weights + (h - 4);
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          int v;
          if (mode == SMOOTH_PRED)
            v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                           wx[j] * left[i] + (256 - wx[j]) * above[w - 1],
                       9);
          else if (mode == SMOOTH_V_PRED)
            v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
          else
            v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
          pred[i * w + j] = (Pixel)v;
        }
    } else if (mode == DC_PRED) {
      int avg;
      if (have_above && have_left) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = (sum + (h >> 1)) >> log2h;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        avg = (sum + (w >> 1)) >> log2w;
      } else {
        avg = base;
      }
      std::fill_n(pred, (size_t)w * h, (Pixel)avg);
    } else {  // PAETH
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          int base = above[j] + left[i] - corner;
          int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]),
              ptl = std::abs(base - corner);
          int v;
          if (pl <= pt && pl <= ptl)
            v = left[i];
          else if (pt <= ptl)
            v = above[j];
          else
            v = corner;
          pred[i * w + j] = (Pixel)v;
        }
    }
    for (int i = 0; i < h; ++i)
      memcpy(P.row(y + i) + x, pred + i * w, w * sizeof(Pixel));
  }

  void recursive_intra(Pixel* pred, const int* above, const int* left,
                       int w, int h) {
    int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; ++i2)
      for (int j4 = 0; j4 < w4; ++j4) {
        int p[7];
        for (int i = 0; i < 7; ++i) {
          if (i < 5) {
            if (i2 == 0)
              p[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0)
              p[i] = left[(i2 << 1) - 1];
            else
              p[i] = pred[((i2 << 1) - 1) * w + (j4 << 2) + i - 1];
          } else {
            if (j4 == 0)
              p[i] = left[(i2 << 1) + i - 5];
            else
              p[i] = pred[((i2 << 1) + i - 5) * w + (j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; ++i) {
          int pr = 0;
          for (int j = 0; j < 7; ++j)
            pr += g_tab.filter_taps[filter_intra_mode][i][j] * p[j];
          // Round2Signed(pr, 4)
          int v = pr >= 0 ? round2(pr, 4) : -round2(-pr, 4);
          pred[((i2 << 1) + (i >> 2)) * w + (j4 << 2) + (i & 3)] = d.clip1(v);
        }
      }
  }

  void directional(int plane, Pixel* pred, int* above, int* left, int w,
                   int h, int x, int y, int max_x, int max_y, int have_left,
                   int have_above, int p_angle) {
    int up_above = 0, up_left = 0;
    if (d.seq.intra_edge) {
      int filter_type = get_filter_type(plane);
      if (p_angle != 90 && p_angle != 180) {
        if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
          int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
          left[-1] = v;
          above[-1] = v;
        }
        if (have_above) {
          int strength = edge_filter_strength(w, h, filter_type, p_angle - 90);
          int num = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
          edge_filter(above, num, strength);
        }
        if (have_left) {
          int strength = edge_filter_strength(w, h, filter_type, p_angle - 180);
          int num = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
          edge_filter(left, num, strength);
        }
      }
      up_above = use_upsample(w, h, filter_type, p_angle - 90);
      if (up_above) edge_upsample(above, w + (p_angle < 90 ? h : 0));
      up_left = use_upsample(w, h, filter_type, p_angle - 180);
      if (up_left) edge_upsample(left, h + (p_angle > 180 ? w : 0));
    }
    int dx = 0, dy = 0;
    if (p_angle < 90)
      dx = g_tab.dr_deriv[p_angle >> 1];
    else if (p_angle > 90 && p_angle < 180)
      dx = g_tab.dr_deriv[(180 - p_angle) >> 1];
    if (p_angle > 90 && p_angle < 180)
      dy = g_tab.dr_deriv[(p_angle - 90) >> 1];
    else if (p_angle > 180)
      dy = g_tab.dr_deriv[(270 - p_angle) >> 1];
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int v;
        if (p_angle < 90) {
          int idx = (i + 1) * dx;
          int base = (idx >> (6 - up_above)) + (j << up_above);
          int shift = ((idx << up_above) >> 1) & 0x1F;
          int max_base = (w + h - 1) << up_above;
          if (base < max_base)
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          else
            v = above[max_base];
        } else if (p_angle > 90 && p_angle < 180) {
          int idx = (j << 6) - (i + 1) * dx;
          int base = idx >> (6 - up_above);
          if (base >= -(1 << up_above)) {
            int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          } else {
            idx = (i << 6) - (j + 1) * dy;
            base = idx >> (6 - up_left);
            int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          }
        } else if (p_angle > 180) {
          int idx = (j + 1) * dy;
          int base = (idx >> (6 - up_left)) + (i << up_left);
          int shift = ((idx << up_left) >> 1) & 0x1F;
          v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
        } else if (p_angle == 90) {
          v = above[j];
        } else {
          v = left[i];
        }
        pred[i * w + j] = (Pixel)v;
      }
  }

  void predict_cfl(int plane, int start_x, int start_y, int txsz) {
    int w = kTxW[txsz], h = kTxH[txsz];
    int sx = d.ssx, sy = d.ssy;
    int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    auto& L = d.cur[0];
    auto& P = d.cur[plane];
    static thread_local int lum[32 * 32];
    int sum = 0;
    for (int i = 0; i < h; ++i) {
      int ly = (start_y + i) << sy;
      ly = std::min(ly, max_luma_h - (1 << sy));
      for (int j = 0; j < w; ++j) {
        int lx = (start_x + j) << sx;
        lx = std::min(lx, max_luma_w - (1 << sx));
        int t = 0;
        for (int dy = 0; dy <= sy; ++dy)
          for (int dx = 0; dx <= sx; ++dx) t += L.at(lx + dx, ly + dy);
        int v = t << (3 - sx - sy);
        lum[i * w + j] = v;
        sum += v;
      }
    }
    int avg = round2(sum, kTxWLog2[txsz] + kTxHLog2[txsz]);
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        Pixel& px = P.at(start_x + j, start_y + i);
        int sc = alpha * (lum[i * w + j] - avg);
        int scaled = sc >= 0 ? round2(sc, 6) : -round2(-sc, 6);
        px = d.clip1(px + scaled);
      }
  }
};

// ---------------------------------------------------------------------------
// Loop filter (spec 7.14)

template <typename Pixel>
struct LoopFilter {
  Decoder<Pixel>& d;
  const FrameHdr& fh;
  explicit LoopFilter(Decoder<Pixel>& dd) : d(dd), fh(dd.fh) {}

  int filter_level(int row, int col, int plane, int pass) {
    size_t i = (size_t)row * d.mi_cols + col;
    int segment = d.seg_ids[i];
    int idx = plane == 0 ? pass : plane + 1;
    int delta = d.delta_lfs[i * 4 + (fh.delta_lf_multi ? idx : 0)];
    int base = clip3(0, 63, delta + fh.lf_level[idx]);
    int lvl = base;
    int feature = SEG_LVL_ALT_LF_Y_V + idx;
    if (fh.seg_enabled && fh.feature_enabled[segment][feature])
      lvl = clip3(0, 63, lvl + fh.feature_data[segment][feature]);
    if (fh.lf_delta_enabled) {
      int nshift = lvl >> 5;
      // an inter block's reference and mode deltas (7.14.4)
      int ref = fh.inter ? d.ref_frames[i * 2] : INTRA_FRAME;
      if (ref <= INTRA_FRAME) {
        lvl += fh.lf_ref_deltas[INTRA_FRAME] * (1 << nshift);
      } else {
        int mode = d.y_modes[i];
        int mode_type = mode >= NEARESTMV && mode != GLOBALMV &&
                        mode != GLOBAL_GLOBALMV;
        lvl += (fh.lf_ref_deltas[ref] + fh.lf_mode_deltas[mode_type]) *
               (1 << nshift);
      }
      lvl = clip3(0, 63, lvl);
    }
    return lvl;
  }

  void edge(int plane, int pass, int row, int col) {
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int dx = pass == 0, dy = pass == 1;
    int x = col * 4, y = row * 4;
    row |= sy;
    col |= sx;
    if (x >= fh.width || y >= fh.height) return;
    if (pass == 0 && x == 0) return;
    if (pass == 1 && y == 0) return;
    int xp = x >> sx, yp = y >> sy;
    int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
    const std::vector<uint8_t>& lt = d.lf_tx[plane];
    int ls = d.lf_tx_stride[plane];
    int txsz = lt[(size_t)(row >> sy) * ls + (col >> sx)];
    int prev_tx = lt[(size_t)(prev_row >> sy) * ls + (prev_col >> sx)];
    if (pass == 0 ? xp % kTxW[txsz] : yp % kTxH[txsz]) return;
    // inside an inter block that codes no residual only the block's own
    // edges are filtered
    size_t mi = (size_t)row * d.mi_cols + col;
    if (fh.inter && d.skips[mi] && d.is_inters[mi]) {
      int psz = kSsSize[d.mi_size[mi]][sx][sy];
      if (pass == 0 ? xp % (kNum4x4W[psz] * 4) : yp % (kNum4x4H[psz] * 4))
        return;
    }
    int base = pass == 0 ? std::min(kTxW[prev_tx], kTxW[txsz])
                         : std::min(kTxH[prev_tx], kTxH[txsz]);
    int filter_size = plane == 0 ? std::min(16, base) : std::min(8, base);
    int lvl = filter_level(row, col, plane, pass);
    if (lvl == 0) lvl = filter_level(prev_row, prev_col, plane, pass);
    if (lvl == 0) return;
    int shift = fh.lf_sharpness > 4 ? 2 : fh.lf_sharpness > 0 ? 1 : 0;
    int limit = fh.lf_sharpness > 0
                    ? clip3(1, 9 - fh.lf_sharpness, lvl >> shift)
                    : std::max(1, lvl >> shift);
    int blimit = 2 * (lvl + 2) + limit;
    int thresh = lvl >> 4;
    // the limits at the bit depth (7.14.6.2)
    int bd_shift = d.bitdepth - 8;
    auto& P = d.cur[plane];
    for (int i = 0; i < 4; ++i)
      sample(P, xp + dy * i, yp + dx * i, plane, limit << bd_shift,
             blimit << bd_shift, thresh << bd_shift, dx, dy, filter_size);
  }

  void sample(Plane<Pixel>& P, int x, int y, int plane, int limit,
              int blimit, int thresh, int dx, int dy, int fsize) {
    auto px = [&](int k) -> Pixel& {  // k >= 0: q_k, k < 0: p_(-k-1)
      return P.at(x + dx * k, y + dy * k);
    };
    const int shift = d.bitdepth - 8, one = 1 << shift;
    int q0 = px(0), q1 = px(1), q2 = px(2), q3 = px(3);
    int p0 = px(-1), p1 = px(-2), p2 = px(-3), p3 = px(-4);
    int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int flen = fsize == 4 ? 4 : plane != 0 ? 6 : fsize == 8 ? 8 : 16;
    int mask = 0;
    mask |= std::abs(p1 - p0) > limit;
    mask |= std::abs(q1 - q0) > limit;
    mask |= std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    if (flen >= 6) {
      mask |= std::abs(p2 - p1) > limit;
      mask |= std::abs(q2 - q1) > limit;
    }
    if (flen >= 8) {
      mask |= std::abs(p3 - p2) > limit;
      mask |= std::abs(q3 - q2) > limit;
    }
    if (mask) return;
    int flat = 0, flat2 = 0;
    if (flen >= 6) {
      int m = 0;
      m |= std::abs(p1 - p0) > one;
      m |= std::abs(q1 - q0) > one;
      m |= std::abs(p2 - p0) > one;
      m |= std::abs(q2 - q0) > one;
      if (flen >= 8) {
        m |= std::abs(p3 - p0) > one;
        m |= std::abs(q3 - q0) > one;
      }
      flat = !m;
    }
    if (flen >= 16) {
      int q4 = px(4), q5 = px(5), q6 = px(6);
      int p4 = px(-5), p5 = px(-6), p6 = px(-7);
      int m = 0;
      m |= std::abs(p6 - p0) > one;
      m |= std::abs(q6 - q0) > one;
      m |= std::abs(p5 - p0) > one;
      m |= std::abs(q5 - q0) > one;
      m |= std::abs(p4 - p0) > one;
      m |= std::abs(q4 - q0) > one;
      flat2 = !m;
    }
    if (fsize == 4 || !flat) {
      // narrow filter
      const int half = 0x80 << shift;
      auto c4 = [&](int v) { return clip3(-half, half - 1, v); };
      int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
      int f = hev ? c4(ps1 - qs1) : 0;
      f = c4(f + 3 * (qs0 - ps0));
      int f1 = c4(f + 4) >> 3;
      int f2 = c4(f + 3) >> 3;
      px(0) = (Pixel)(c4(qs0 - f1) + half);
      px(-1) = (Pixel)(c4(ps0 + f2) + half);
      if (!hev) {
        f = round2(f1, 1);
        px(1) = (Pixel)(c4(qs1 - f) + half);
        px(-2) = (Pixel)(c4(ps1 + f) + half);
      }
    } else {
      int log2size = (fsize == 8 || !flat2) ? 3 : 4;
      int n = log2size == 4 ? 6 : plane == 0 ? 3 : 2;
      int n2 = (log2size == 3 && plane == 0) ? 0 : 1;
      int F[14], F2[14];
      for (int k = -(n + 1); k <= n; ++k) F[k + 7] = px(k);
      for (int i = -n; i < n; ++i) {
        int t = 0;
        for (int j = -n; j <= n; ++j) {
          int p = clip3(-(n + 1), n, i + j);
          int tap = std::abs(j) <= n2 ? 2 : 1;
          t += F[p + 7] * tap;
        }
        F2[i + 7] = round2(t, log2size);
      }
      for (int i = -n; i < n; ++i) px(i) = (Pixel)F2[i + 7];
    }
  }

  void run() {
    if (!fh.lf_level[0] && !fh.lf_level[1]) return;
    for (int plane = 0; plane < d.planes; ++plane) {
      if (plane > 0 && !fh.lf_level[1 + plane]) continue;
      int rstep = plane == 0 ? 1 : 1 << d.ssy;
      int cstep = plane == 0 ? 1 : 1 << d.ssx;
      for (int pass = 0; pass < 2; ++pass)
        for (int row = 0; row < d.mi_rows; row += rstep)
          for (int col = 0; col < d.mi_cols; col += cstep)
            edge(plane, pass, row, col);
    }
  }
};

// ---------------------------------------------------------------------------
// CDEF (spec 7.15)

template <typename Pixel>
struct Cdef {
  Decoder<Pixel>& d;
  const FrameHdr& fh;
  Plane<Pixel> out[3];
  explicit Cdef(Decoder<Pixel>& dd) : d(dd), fh(dd.fh) {}

  // constrain() of the spec with its damping shift worked out once a
  // block: adj = Max(0, damping - FloorLog2(threshold))
  static inline int constrain(int diff, int threshold, int adj) {
    if (!threshold) return 0;
    int a = diff < 0 ? -diff : diff;
    int v = std::min(a, std::max(0, threshold - (a >> adj)));
    return diff < 0 ? -v : v;
  }
  static int damping_adj(int threshold, int damping) {
    return threshold ? std::max(0, damping - floor_log2((uint32_t)threshold))
                     : 0;
  }

  void direction(int r, int c, int* ydir, int* var) {
    int cost[8] = {0};
    int partial[8][15] = {{0}};
    int x0 = c * 4, y0 = r * 4;
    auto& P = d.cur[0];
    const int shift = d.bitdepth - 8;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) {
        int x = (P.at(x0 + j, y0 + i) >> shift) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    for (int i = 0; i < 8; ++i) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= kCdefDivTable[8];
    cost[6] *= kCdefDivTable[8];
    for (int i = 0; i < 7; ++i) {
      cost[0] += (partial[0][i] * partial[0][i] +
                  partial[0][14 - i] * partial[0][14 - i]) *
                 kCdefDivTable[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] +
                  partial[4][14 - i] * partial[4][14 - i]) *
                 kCdefDivTable[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * kCdefDivTable[8];
    cost[4] += partial[4][7] * partial[4][7] * kCdefDivTable[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; ++j)
        cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= kCdefDivTable[8];
      for (int j = 0; j < 3; ++j)
        cost[i] += (partial[i][j] * partial[i][j] +
                    partial[i][10 - j] * partial[i][10 - j]) *
                   kCdefDivTable[2 * j + 2];
    }
    int best = 0, dir = 0;
    for (int i = 0; i < 8; ++i)
      if (cost[i] > best) {
        best = cost[i];
        dir = i;
      }
    *ydir = dir;
    *var = (best - cost[(dir + 4) & 7]) >> 10;
  }

  void filter(int plane, int r, int c, int pri, int sec, int damping,
              int dir) {
    if (!pri && !sec) return;  // the sum is 0: the copy stands
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
    int w = 8 >> sx, h = 8 >> sy;
    auto& P = d.cur[plane];
    auto& O = out[plane];
    // the taps' table follows the strength before its scaling to the bit
    // depth
    int pri_tap = (pri >> (d.bitdepth - 8)) & 1;
    static const int pri_taps[2][2] = {{4, 2}, {3, 3}};
    static const int sec_taps[2][2] = {{2, 1}, {2, 1}};
    int pri_adj = damping_adj(pri, damping), sec_adj = damping_adj(sec, damping);
    // the taps' (row, column) offsets: the primary direction's and the two
    // secondary ones', for k = 0, 1
    int off[2][3][2];
    for (int k = 0; k < 2; ++k)
      for (int t = 0; t < 3; ++t) {
        int dd = t == 0 ? dir : (dir + (t == 1 ? -2 : 2)) & 7;
        off[k][t][0] = kCdefDirections[dd][k][0];
        off[k][t][1] = kCdefDirections[dd][k][1];
      }
    // a block whose taps (at most 2 away) all lie inside the frame's MI
    // area reads them with no check
    int pw = (d.mi_cols * 4) >> sx, ph = (d.mi_rows * 4) >> sy;
    bool inside = x0 >= 2 && y0 >= 2 && x0 + w + 2 <= pw && y0 + h + 2 <= ph;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int x = P.at(x0 + j, y0 + i);
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; ++k)
          for (int sign = -1; sign <= 1; sign += 2)
            for (int t = 0; t < 3; ++t) {
              int avail = 1, v;
              int yy = i + sign * off[k][t][0], xx = j + sign * off[k][t][1];
              if (inside)
                v = P.at(x0 + xx, y0 + yy);
              else
                v = get(plane, x0, y0, yy, xx, &avail);
              if (!avail) continue;
              if (t == 0)
                sum += pri_taps[pri_tap][k] * constrain(v - x, pri, pri_adj);
              else
                sum += sec_taps[pri_tap][k] * constrain(v - x, sec, sec_adj);
              mx = std::max(v, mx);
              mn = std::min(v, mn);
            }
        O.at(x0 + j, y0 + i) =
            (Pixel)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
      }
  }

  int get(int plane, int x0, int y0, int i, int j, int* avail) {
    int sx = plane ? d.ssx : 0, sy = plane ? d.ssy : 0;
    int y = y0 + i, x = x0 + j;
    if (y < 0 || x < 0 || ((y << sy) >> 2) >= d.mi_rows ||
        ((x << sx) >> 2) >= d.mi_cols) {
      *avail = 0;
      return 0;
    }
    *avail = 1;
    return d.cur[plane].at(x, y);
  }

  void block(int r, int c, int idx) {
    if (idx == -1) return;
    size_t mi = (size_t)r * d.mi_cols + c;
    int skip = d.skips[mi] && d.skips[mi + 1] && d.skips[mi + d.mi_cols] &&
               d.skips[mi + d.mi_cols + 1];
    if (skip) return;
    int ydir, var;
    direction(r, c, &ydir, &var);
    // strengths and damping at the bit depth
    const int shift = d.bitdepth - 8;
    int pri = fh.cdef_y_pri[idx] << shift, sec = fh.cdef_y_sec[idx] << shift;
    int dir = pri == 0 ? 0 : ydir;
    int var_str = (var >> 6) ? std::min(floor_log2((uint32_t)(var >> 6)), 12) : 0;
    pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
    int damping = fh.cdef_damping + shift;
    filter(0, r, c, pri, sec, damping, dir);
    if (d.planes == 1) return;
    pri = fh.cdef_uv_pri[idx] << shift;
    sec = fh.cdef_uv_sec[idx] << shift;
    dir = pri == 0 ? 0 : kCdefUvDir[d.ssx][d.ssy][ydir];
    damping = fh.cdef_damping - 1 + shift;
    filter(1, r, c, pri, sec, damping, dir);
    filter(2, r, c, pri, sec, damping, dir);
  }

  // Each 8x8 block reads the deblocked frame and writes its own pixels of
  // the copy, so rows of 64x64 units run on threads of their own.
  void run() {
    for (int p = 0; p < d.planes; ++p) out[p] = d.cur[p];
    parallel_for((d.mi_rows + 15) >> 4, [&](int unit_row) {
      for (int r = unit_row * 16; r < std::min(d.mi_rows, unit_row * 16 + 16);
           r += 2)
        for (int c = 0; c < d.mi_cols; c += 2) {
          int idx = d.cdef_idx[(size_t)(r >> 4) * d.cdef_stride + (c >> 4)];
          block(r, c, idx);
        }
    });
  }
};

// ---------------------------------------------------------------------------
// Loop restoration (spec 7.17)

// A run of rows of one plane that lie in one stripe and one row of units:
// the rows [y, y + h), the row of units, the stripe's first and last rows
// and the plane's last column and row.
struct LrRows {
  int plane, y, h, unit_row, stripe_start, stripe_end, plane_end_x,
      plane_end_y;
};

template <typename Pixel>
struct Restoration {
  Decoder<Pixel>& d;
  const FrameHdr& fh;
  Plane<Pixel>* deblocked;  // before CDEF
  Plane<Pixel>* cdefed;     // after CDEF
  Plane<Pixel> out[3];
  Restoration(Decoder<Pixel>& dd, Plane<Pixel>* deb, Plane<Pixel>* cd)
      : d(dd), fh(dd.fh), deblocked(deb), cdefed(cd) {}

  inline int src(const LrRows& r, int x, int y) const {
    x = std::max(0, std::min(r.plane_end_x, x));
    y = std::max(0, std::min(r.plane_end_y, y));
    if (y < r.stripe_start) {
      y = std::max(r.stripe_start - 2, y);
      return deblocked[r.plane].at(x, y);
    }
    if (y > r.stripe_end) {
      y = std::min(r.stripe_end + 2, y);
      return deblocked[r.plane].at(x, y);
    }
    return cdefed[r.plane].at(x, y);
  }

  void wiener(const LrRows& rr, const LrUnit& u, int x, int w) {
    const int plane = rr.plane, y = rr.y, h = rr.h;
    int vf[7], hf[7];
    auto get_filter = [](const int8_t* c, int* f) {
      f[3] = 128;
      for (int i = 0; i < 3; ++i) {
        f[i] = c[i];
        f[6 - i] = c[i];
        f[3] -= 2 * c[i];
      }
    };
    get_filter(u.wiener[0], vf);
    get_filter(u.wiener[1], hf);
    // the rounding variables of a single prediction (7.11.3.2)
    const int bd = d.bitdepth;
    const int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
    const int offset = 1 << (bd + 7 - round0 - 1);
    const int limit = (1 << (bd + 1 + 7 - round0)) - 1;
    std::vector<int> inter((size_t)(h + 6) * w);
    for (int r = 0; r < h + 6; ++r)
      for (int c = 0; c < w; ++c) {
        int s = 0;
        for (int t = 0; t < 7; ++t)
          s += hf[t] * src(rr, x + c + t - 3, y + r - 3);
        int v = round2(s, round0);
        inter[(size_t)r * w + c] = clip3(-offset, limit - offset, v);
      }
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        int s = 0;
        for (int t = 0; t < 7; ++t) s += vf[t] * inter[(size_t)(r + t) * w + c];
        out[plane].at(x + c, y + r) = d.clip1(round2(s, round1));
      }
  }

  void box_filter(const LrRows& rr, int x, int w, int set, int pass,
                  std::vector<int>& F) {
    const int plane = rr.plane, y = rr.y, h = rr.h;
    int r = g_tab.sgr[set][pass * 2];
    uint32_t s = (uint32_t)g_tab.sgr[set][pass * 2 + 1];
    int n = (2 * r + 1) * (2 * r + 1);
    int one_over_n = ((1 << 12) + (n / 2)) / n;
    int aw = w + 2;
    const int shift = d.bitdepth - 8;
    std::vector<int> A((size_t)(h + 2) * aw), Bv((size_t)(h + 2) * aw);
    for (int i = -1; i < h + 1; ++i) {
      for (int j = -1; j < w + 1; ++j) {
        // at most 25 samples of 12 bits: a fits an int
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; ++dy)
          for (int dx = -r; dx <= r; ++dx) {
            int c = src(rr, x + j + dx, y + i + dy);
            a += c * c;
            b += c;
          }
        a = round2(a, 2 * shift);
        int64_t db = round2(b, shift);
        int64_t p = std::max<int64_t>(0, (int64_t)a * n - db * db);
        int64_t z = (p * s + (1 << 19)) >> 20;
        int a2;
        if (z >= 255)
          a2 = 256;
        else if (z == 0)
          a2 = 1;
        else
          a2 = (int)(((z << 8) + (z / 2)) / (z + 1));
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * one_over_n;
        A[(size_t)(i + 1) * aw + j + 1] = a2;
        Bv[(size_t)(i + 1) * aw + j + 1] = (int)round2l(b2, 12);
      }
    }
    for (int i = 0; i < h; ++i) {
      int shift = 5;
      if (pass == 0 && ((y + i) & 1)) shift = 4;
      for (int j = 0; j < w; ++j) {
        int64_t a = 0, b = 0;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            int weight;
            if (pass == 0)
              weight = ((y + i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else
              weight = (dx == 0 || dy == 0) ? 4 : 3;
            size_t k = (size_t)(i + 1 + dy) * aw + j + 1 + dx;
            a += weight * A[k];
            b += weight * Bv[k];
          }
        int64_t v = a * cdefed[plane].at(x + j, y + i) + b;
        F[(size_t)i * w + j] = (int)round2l(v, 8 + shift - 4);
      }
    }
  }

  void self_guided(const LrRows& rr, const LrUnit& u, int x, int w) {
    const int plane = rr.plane, y = rr.y, h = rr.h;
    int set = u.sgr_set;
    int r0 = g_tab.sgr[set][0], r1 = g_tab.sgr[set][2];
    std::vector<int> f0((size_t)w * h), f1((size_t)w * h);
    if (r0) box_filter(rr, x, w, set, 0, f0);
    if (r1) box_filter(rr, x, w, set, 1, f1);
    int w0 = u.xqd[0], w1 = u.xqd[1];
    int w2 = 128 - w0 - w1;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int64_t uu = (int64_t)cdefed[plane].at(x + j, y + i) << 4;
        int64_t v = w1 * uu;
        v += r0 ? (int64_t)w0 * f0[(size_t)i * w + j] : w0 * uu;
        v += r1 ? (int64_t)w2 * f1[(size_t)i * w + j] : w2 * uu;
        int s = (int)round2l(v, 4 + 7);
        out[plane].at(x + j, y + i) = d.clip1(s);
      }
  }

  // Each run of rows reads the CDEF output and the deblocked frame and
  // writes its own rows of the copy, so the runs of every plane go to
  // parallel_for's threads.
  void run() {
    std::vector<LrRows> runs;
    for (int p = 0; p < d.planes; ++p) {
      out[p] = cdefed[p];
      if (fh.lr_type[p] == RESTORE_NONE) continue;
      int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
      int unit = fh.lr_size[p];
      int unit_rows = d.lr_rows[p];
      int plane_end_x = round2(fh.upscaled_width, sx) - 1;
      int plane_end_y = round2(fh.height, sy) - 1;
      int bh = 4 >> sy;
      // rows of 4x4 (luma) blocks grouped by stripe and unit row
      int y = 0;
      while (y <= plane_end_y) {
        int luma_y = y << sy;
        int stripe = (luma_y + 8) / 64;
        int unit_row = std::min(unit_rows - 1, ((luma_y + 8) >> sy) / unit);
        int y_end = y;
        while (y_end <= plane_end_y) {
          int ly = y_end << sy;
          if ((ly + 8) / 64 != stripe ||
              std::min(unit_rows - 1, ((ly + 8) >> sy) / unit) != unit_row)
            break;
          y_end += bh;
        }
        int stripe_start = (-8 + stripe * 64) >> sy;
        runs.push_back(LrRows{p, y, std::min(y_end, plane_end_y + 1) - y,
                              unit_row, stripe_start,
                              stripe_start + (64 >> sy) - 1, plane_end_x,
                              plane_end_y});
        y = y_end;
      }
    }
    parallel_for((int)runs.size(), [&](int i) { units(runs[i]); });
  }

  // the units of a run of rows, left to right
  void units(const LrRows& rr) {
    int p = rr.plane;
    int unit = fh.lr_size[p], unit_cols = d.lr_cols[p];
    int bw = 4 >> (p ? d.ssx : 0);
    int x = 0;
    while (x <= rr.plane_end_x) {
      int unit_col = std::min(unit_cols - 1, x / unit);
      int x_end = x;
      while (x_end <= rr.plane_end_x &&
             std::min(unit_cols - 1, x_end / unit) == unit_col)
        x_end += bw;
      int w = std::min(x_end, rr.plane_end_x + 1) - x;
      const LrUnit& u = d.lr[p][(size_t)rr.unit_row * unit_cols + unit_col];
      if (u.type == RESTORE_WIENER)
        wiener(rr, u, x, w);
      else if (u.type == RESTORE_SGRPROJ)
        self_guided(rr, u, x, w);
      x = x_end;
    }
  }
};

// ---------------------------------------------------------------------------
// OBU walk and the frame

struct Obu {
  int type, ext, temporal_id, spatial_id;
  const uint8_t* p;
  size_t n;
};

// Splits the stream into OBUs; returns false on a malformed one.
bool next_obu(const uint8_t*& p, const uint8_t* end, Obu& o) {
  if (p >= end) return false;
  uint8_t hdr = *p++;
  if (hdr & 0x80) bad("OBU forbidden bit");
  o.type = (hdr >> 3) & 15;
  int ext = (hdr >> 2) & 1, has_size = (hdr >> 1) & 1;
  o.ext = ext;
  o.temporal_id = o.spatial_id = 0;
  if (ext) {
    if (p >= end) bad("truncated OBU extension");
    o.temporal_id = *p >> 5;
    o.spatial_id = (*p >> 3) & 3;
    ++p;
  }
  size_t size;
  if (has_size) {
    uint64_t v = 0;
    int i = 0;
    for (;; ++i) {
      if (i >= 8 || p >= end) bad("OBU size");
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7F) << (7 * i);
      if (!(b & 0x80)) break;
    }
    if (v > (uint64_t)(end - p)) bad("OBU runs past the data");
    size = (size_t)v;
  } else {
    size = (size_t)(end - p);
  }
  o.p = p;
  o.n = size;
  p += size;
  return true;
}

struct Result {
  int width, height, layout, bitdepth, mono, color_range, matrix, primaries,
      transfer, allow_sct, allow_intrabc, palette_blocks, intrabc_blocks,
      filters, qmatrix, film_grain, superres_denom, spatial_id, shown_existing,
      frames;
  // the output frame is an INTER or SWITCH frame; the frames decoded for
  // it (itself included); the tools its decode met (ToolCounts)
  int inter, decoded;
  int tools[kNumTools];
};

struct TileJob {
  const uint8_t* p;
  size_t n;
  int t;  // the tile's number, in raster order
};

// The frame a decode returns (ik_av1d_probe / ik_av1d_decode's `select`):
// libdav1d's first picture at all_layers = 1, its default; the picture it
// returns at all_layers = 0, which libavif asks for (the highest spatial
// layer of the operating point); or, at 0..3, the first picture of that
// spatial layer (libavif's 'lsel')
// ; or, at kSelectLast, the last frame shown in the temporal unit (every
// frame of a stream that carries no temporal delimiters: for tests)
enum { kSelectFirst = -1, kSelectHighest = -2, kSelectLast = -3 };

// A frame of the temporal unit's walk: its header, layer and tiles, and
// the frames in its reference slots (LAST_FRAME .. ALTREF_FRAME) when its
// header was read
struct FrameRec {
  FrameHdr fh;
  int spatial_id = 0;
  int num_tiles = 0, tiles_done = 0;
  std::vector<TileJob> jobs;
  int refs[7] = {-1, -1, -1, -1, -1, -1, -1};
};

// The frames of the stream's first temporal unit, in decode order; the
// output frame's headers; which frames it depends on (itself included)
struct Stream {
  SeqHdr seq;
  FrameHdr fh;
  Result res{};
  std::vector<std::unique_ptr<FrameRec>> recs;
  std::vector<char> needed;
  int chosen = -1;
};

// the tiles' counts of palette and intrabc blocks
// the tiles' counts of palette and intrabc blocks and of the inter tools
// (the output frame's and those of the frames it depends on)
struct ToolCounts {
  std::atomic<int> palette{0}, intrabc{0};
  std::atomic<int> tools[kNumTools];
  ToolCounts() {
    for (auto& t : tools) t = 0;
  }
};

template <typename Pixel>
void decode_tile(Decoder<Pixel>& d, const TileJob& job, ToolCounts& counts) {
  const FrameHdr& fh = d.fh;
  int tr = job.t / fh.tile_cols, tc = job.t % fh.tile_cols;
  std::unique_ptr<Tile<Pixel>> tile(new Tile<Pixel>(d));
  tile->cdf = d.init_cdf;
  tile->mi_row_start = fh.mi_row_starts[tr];
  tile->mi_row_end = fh.mi_row_starts[tr + 1];
  tile->mi_col_start = fh.mi_col_starts[tc];
  tile->mi_col_end = fh.mi_col_starts[tc + 1];
  tile->current_q = fh.base_q_idx;
  tile->ms.init(job.p, job.n, fh.disable_cdf_update);
  tile->decode();
  if (job.t == fh.context_update_tile_id) d.end_cdf = tile->cdf;
  counts.palette += tile->n_palette;
  counts.intrabc += tile->n_intrabc;
  for (int i = 0; i < kNumTools; ++i) counts.tools[i] += tile->n_tool[i];
  counts.tools[TOOL_TEMPORAL_MV] += tile->n_temporal;
}

// Tiles share no state but the frame's arrays, each writing its own
// region of them (and intra block copy reading only its own), so they
// decode on threads of their own; the error of the first tile in raster
// order that fails is the stream's.
template <typename Pixel>
void decode_tiles(Decoder<Pixel>& d, const std::vector<TileJob>& jobs,
                  ToolCounts& counts) {
  int n = (int)jobs.size();
  std::vector<int> codes(n, IK_AV1D_OK);
  std::vector<const char*> whys(n, nullptr);
  parallel_for(n, [&](int i) {
    try {
      decode_tile(d, jobs[i], counts);
    } catch (const Fail& f) {
      codes[i] = f.code;
      whys[i] = f.why;
    } catch (const std::bad_alloc&) {
      codes[i] = IK_AV1D_BAD;
      whys[i] = "out of memory";
    }
  });
  for (int i = 0; i < n; ++i)
    if (codes[i] != IK_AV1D_OK) throw Fail{codes[i], whys[i]};
}

// Walks the stream's first temporal unit as libdav1d does at operating
// point `op` (the sequence header's first where it has no such point):
// the OBUs of the layers the point leaves out are dropped, by their
// extension's temporal_id and spatial_id (dav1d_parse_obus); each frame
// header is read against the frames in its slots, which the reference
// frame update process (spec 7.20) refreshes; a frame shown from a slot
// (show_existing_frame) is the frame stored there, and a KEY_FRAME shown
// so refreshes every slot (the frame loading process, spec 7.21). The
// output frame is the one `select` names (kSelectFirst, kSelectHighest,
// or a spatial layer): libdav1d returns, at all_layers = 0, the first
// shown frame of the point's highest spatial layer, else the last frame
// shown before the temporal unit ends. The frames it depends on are its
// references, theirs, and so on: those, and no others, are decoded
// (`st.needed`). Their headers, and their tiles where `tiles` is set,
// land in `st`. The OBUs after the output frame are only split: one that
// runs past the data fails the stream, as in libdav1d.
void parse_stream(const uint8_t* data, size_t n, Stream& st, bool tiles,
                  int select = kSelectFirst, int op = 0) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  bool have_seq = false, any_frame = false, shown_existing = false;
  int op_idc = 0, max_sid = 0;
  std::vector<std::unique_ptr<FrameRec>>& recs = st.recs;
  int slot[8];
  std::fill(slot, slot + 8, -1);
  int cur = -1;        // the frame whose tile groups come next
  int chosen = -1;     // the output frame, once known
  int candidate = -1;  // kSelectHighest: the last frame shown
  // a frame shown: true once it settles the output
  auto shown = [&](int k, bool existing) {
    if (select == kSelectLast) {
      candidate = k;
      shown_existing = existing;
      return false;
    }
    int sid = recs[k]->spatial_id;
    bool first = select == kSelectFirst ||
                 (select == kSelectHighest && max_sid == 0);
    if (first || (select == kSelectHighest ? sid == max_sid : sid == select)) {
      chosen = k;
      shown_existing = existing;
      return true;
    }
    if (select == kSelectHighest) {
      candidate = k;
      shown_existing = existing;
    }
    return false;
  };
  auto settled = [&]() {
    if (chosen < 0) return false;
    const FrameRec& r = *recs[chosen];
    return !tiles || r.tiles_done == r.num_tiles;
  };
  Obu o;
  while (!settled() && next_obu(p, end, o)) {
    if (o.type == 2) {  // temporal delimiter: a new temporal unit
      if (any_frame) break;
      continue;
    }
    if (o.type == 1) {  // sequence header
      if (any_frame) break;
      Bits b{o.p, o.n, 0};
      st.seq = SeqHdr();
      parse_seq(b, st.seq);
      have_seq = true;
      op_idc = st.seq.op_idc[op < st.seq.op_cnt ? op : 0];
      int spatial = op_idc >> 8;
      max_sid = spatial ? floor_log2(spatial) : 0;
      continue;
    }
    if (o.ext && op_idc &&
        (!((op_idc >> o.temporal_id) & 1) ||
         !((op_idc >> (o.spatial_id + 8)) & 1)))
      continue;  // a layer the operating point leaves out
    if (o.type == 3 || o.type == 6 || o.type == 7) {  // frame (header)
      if (cur >= 0) {
        if (o.type != 6) continue;  // a copy of the header
        bad("a frame before its last tile group");
      }
      if (o.type == 7) continue;  // a redundant header of no frame
      if (!have_seq) bad("frame before any sequence header");
      any_frame = true;
      Bits b{o.p, o.n, 0};
      if (!st.seq.reduced && b.f(1)) {  // show_existing_frame
        if (o.type == 6) bad("an OBU_FRAME that shows an existing frame");
        int idx = b.f(3);
        if (st.seq.decoder_model_info && !st.seq.equal_picture_interval)
          b.f(st.seq.frame_presentation_time_len);
        if (st.seq.frame_id_numbers) b.f(st.seq.frame_id_len);
        int k = slot[idx];
        if (k < 0) bad("a frame shown from an empty slot");
        const FrameRec& r = *recs[k];
        if (r.tiles_done != r.num_tiles && tiles) bad("missing tiles");
        if (r.fh.frame_type == 0)
          std::fill(slot, slot + 8, k);  // a KEY_FRAME refreshes every slot
        shown(k, true);
        continue;
      }
      if (recs.size() >= 64) bad("too many frames in a temporal unit");
      recs.emplace_back(new FrameRec());
      int k = (int)recs.size() - 1;
      FrameRec& r = *recs[k];
      r.spatial_id = o.spatial_id;
      const FrameHdr* slot_hdr[8];
      for (int i = 0; i < 8; ++i)
        slot_hdr[i] = slot[i] < 0 ? nullptr : &recs[slot[i]]->fh;
      parse_frame_header(b, st.seq, r.fh, o.temporal_id, o.spatial_id,
                         slot_hdr);
      if (r.fh.inter)
        for (int i = 0; i < 7; ++i) r.refs[i] = slot[r.fh.ref_frame_idx[i]];
      for (int i = 0; i < 8; ++i)
        if ((r.fh.refresh >> i) & 1) slot[i] = k;
      if (r.fh.show_frame) shown(k, false);
      if (tiles &&
          (size_t)r.fh.upscaled_width * r.fh.height > ((size_t)1 << 28))
        bad("frame too large");
      r.num_tiles = r.fh.tile_cols * r.fh.tile_rows;
      cur = k;
      if (o.type != 6) continue;
      b.byte_align();
      size_t hb = b.pos >> 3;
      if (hb > o.n) bad("frame header");
      o.p += hb;
      o.n -= hb;
      o.type = 4;
    }
    if (o.type == 4) {  // tile group
      if (cur < 0) bad("tile group before its frame header");
      FrameRec& r = *recs[cur];
      Bits b{o.p, o.n, 0};
      int tg_start = 0, tg_end = r.num_tiles - 1;
      if (r.num_tiles > 1 && b.f(1)) {
        int bits = r.fh.tile_cols_log2 + r.fh.tile_rows_log2;
        tg_start = b.f(bits);
        tg_end = b.f(bits);
      }
      b.byte_align();
      if (tg_start != r.tiles_done || tg_end < tg_start ||
          tg_end >= r.num_tiles)
        bad("tile group order");
      size_t pos = b.pos >> 3;
      for (int t = tg_start; t <= tg_end; ++t) {
        size_t tile_size;
        if (t == tg_end) {
          if (pos > o.n) bad("tile data");
          tile_size = o.n - pos;
        } else {
          int tsb = r.fh.tile_size_bytes;
          if (pos + tsb > o.n) bad("tile size");
          size_t v = 0;
          for (int i = 0; i < tsb; ++i) v |= (size_t)o.p[pos + i] << (8 * i);
          pos += tsb;
          tile_size = v + 1;
          if (tile_size > o.n - pos) bad("tile runs past its group");
        }
        if (tiles) r.jobs.push_back(TileJob{o.p + pos, tile_size, t});
        pos += tile_size;
      }
      r.tiles_done = tg_end + 1;
      if (r.tiles_done == r.num_tiles) cur = -1;
      continue;
    }
    // metadata, padding, tile list: skipped
  }
  // libdav1d reads the whole of the data it is given before it returns a
  // picture: an OBU cut short after the output frame fails the decode
  while (next_obu(p, end, o)) {
  }
  if (chosen < 0) chosen = candidate;
  if (chosen < 0) {
    if (!any_frame) bad("no frame in the stream");
    bad(select >= 0 ? "no shown frame of the selected spatial layer"
                    : "no shown frame in the temporal unit");
  }
  // the frames the output depends on: its references, transitively (each
  // earlier in decode order)
  st.needed.assign(recs.size(), 0);
  st.needed[chosen] = 1;
  for (int k = chosen; k >= 0; --k) {
    if (!st.needed[k]) continue;
    const FrameRec& r = *recs[k];
    if (tiles && r.tiles_done != r.num_tiles) bad("missing tiles");
    for (int i = 0; i < 7; ++i)
      if (r.refs[i] >= 0) st.needed[r.refs[i]] = 1;
  }
  st.chosen = chosen;
  FrameRec& r = *recs[chosen];
  st.fh = r.fh;
  Result& res = st.res;
  res.width = st.fh.upscaled_width;
  res.superres_denom = st.fh.superres_denom;
  res.height = st.fh.height;
  res.mono = st.seq.mono;
  res.layout = st.seq.mono ? 0
               : (st.seq.ssx && st.seq.ssy) ? 1
               : st.seq.ssx                 ? 2
                                            : 3;
  res.bitdepth = st.seq.bitdepth;
  res.color_range = st.seq.color_range;
  res.matrix = st.seq.matrix;
  res.primaries = st.seq.primaries;
  res.transfer = st.seq.transfer;
  res.allow_sct = st.fh.allow_sct;
  res.allow_intrabc = st.fh.allow_intrabc;
  res.filters = (st.fh.lf_level[0] || st.fh.lf_level[1]) |
                st.fh.cdef_on << 1 | st.fh.uses_lr << 2;
  res.qmatrix = st.fh.using_qmatrix;
  res.film_grain = st.fh.grain.apply;
  res.spatial_id = r.spatial_id;
  res.shown_existing = shown_existing;
  res.frames = (int)recs.size();
  res.inter = st.fh.inter;
  for (size_t k = 0; k < recs.size(); ++k) res.decoded += st.needed[k];
}

// ---------------------------------------------------------------------------
// Upscaling process (spec 7.16): each row of a plane widened from the
// coded width to UpscaledWidth by the 8-tap Upscale_Filter of 64 phases.
// The source position steps by stepX in 1/16384 of a sample from
// initialSubpelX, which centres the rounding error across the row; taps
// are clamped to the decoded area (MiCols wide, so the columns decoded
// past FrameWidth take part, as in libdav1d). Rows are independent and run
// on parallel_for's threads, a band of 32 at a time.

template <typename Pixel>
void upscale(Decoder<Pixel>& d, Plane<Pixel>* in, Plane<Pixel>* out) {
  const FrameHdr& fh = d.fh;
  for (int p = 0; p < d.planes; ++p) {
    int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
    int down_w = round2(fh.width, sx), up_w = round2(fh.upscaled_width, sx);
    int plane_h = round2(fh.height, sy);
    int step = ((down_w << 14) + up_w / 2) / up_w;
    int err = up_w * step - (down_w << 14);
    // err halved by a shift (down where it is odd and negative), as
    // libdav1d has it
    int x0 = (-((up_w - down_w) << 13) + up_w / 2) / up_w + 128 - (err >> 1);
    x0 &= 0x3FFF;
    int max_x = ((d.mi_cols * 4) >> sx) - 1;
    // each output column's first tap and filter phase
    std::vector<int> first(up_w);
    std::vector<uint8_t> phase(up_w);
    for (int x = 0; x < up_w; ++x) {
      int64_t pos = -(1 << 14) + x0 + (int64_t)x * step;
      first[x] = (int)(pos >> 14) - 3;
      phase[x] = (uint8_t)((pos & 0x3FFF) >> 8);
    }
    Plane<Pixel>& O = out[p];
    Plane<Pixel>& I = in[p];
    O.stride = up_w;
    O.buf.assign((size_t)O.stride * plane_h, 0);
    parallel_for((plane_h + 31) >> 5, [&](int band) {
      for (int y = band * 32; y < std::min(plane_h, band * 32 + 32); ++y) {
        const Pixel* src = I.row(y);
        Pixel* dst = O.row(y);
        for (int x = 0; x < up_w; ++x) {
          const int16_t* f = g_tab.upscale[phase[x]];
          int sum = 0;
          for (int k = 0; k < 8; ++k)
            sum += f[k] * src[clip3(0, max_x, first[x] + k)];
          dst[x] = d.clip1(round2(sum, 7));
        }
      }
    });
  }
}

template <typename Pixel>
void postfilter(Decoder<Pixel>& d) {
  LoopFilter<Pixel> lf(d);
  lf.run();
  Plane<Pixel>* deblocked = d.cur;
  std::unique_ptr<Cdef<Pixel>> cdef;
  Plane<Pixel>* cdefed = d.cur;
  if (d.fh.cdef_on) {
    cdef.reset(new Cdef<Pixel>(d));
    cdef->run();
    cdefed = cdef->out;
  }
  // superres: the spec's UpscaledCdefFrame (the output where loop
  // restoration is off) and UpscaledCurrFrame, the deblocked rows that
  // restoration's stripes take beyond their edges
  std::unique_ptr<Plane<Pixel>[]> up_cdef, up_deb;
  if (d.fh.use_superres) {
    up_cdef.reset(new Plane<Pixel>[3]);
    upscale(d, cdefed, up_cdef.get());
    if (d.fh.uses_lr && cdefed != deblocked) {
      up_deb.reset(new Plane<Pixel>[3]);
      upscale(d, deblocked, up_deb.get());
      deblocked = up_deb.get();
    } else {
      deblocked = up_cdef.get();
    }
    cdefed = up_cdef.get();
  }
  if (d.fh.uses_lr) {
    std::unique_ptr<Restoration<Pixel>> lr(
        new Restoration<Pixel>(d, deblocked, cdefed));
    lr->run();
    for (int p = 0; p < d.planes; ++p) d.cur[p] = std::move(lr->out[p]);
  } else if (cdefed != d.cur) {
    for (int p = 0; p < d.planes; ++p) d.cur[p] = std::move(cdefed[p]);
  }
}

// ---------------------------------------------------------------------------
// Film grain synthesis (spec 7.18.3), applied to the shown frame on its
// way to the caller's planes: the grain templates (a 73 x 82 luma block of
// Gaussian noise filtered auto-regressively, the chroma blocks sized by
// the subsampling), the scaling lookups, then the noise of each stripe of
// 32 luma rows: blocks of 32 x 32 at random offsets of the templates,
// blended across their seams where overlap_flag says so, scaled by the
// lookup of the sample (chroma by the luma beside it) and added with a
// clip to the full or the restricted range. A stripe draws its offsets
// from a seed of its own (and redraws its upper neighbour's for the
// seam), so stripes run on parallel_for's threads, each writing its own
// rows: the planes do not depend on the number of workers.

// get_random_number of the spec: the 16-bit register's next `bits`
inline int grain_random(uint32_t& r, int bits) {
  uint32_t bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
  r = (r >> 1) | (bit << 15);
  return (int)((r >> (16 - bits)) & ((1u << bits) - 1));
}

struct GrainSynth {
  const FilmGrain& g;
  int bitdepth, ssx, ssy, planes, width, height, matrix;
  int gmin, gmax;  // GrainMin, GrainMax
  // LumaGrain, CbGrain, CrGrain (chroma in their top-left 38 x 44 where
  // subsampled)
  int16_t tmpl[3][73][82];
  // the scaling of every sample value: scale_lut(plane, v) for v below
  // 1 << BitDepth
  std::vector<uint8_t> scale[3];
  bool active[3];

  GrainSynth(const FilmGrain& fg, int bd, int sx, int sy, int np, int w,
             int h, int mc)
      : g(fg), bitdepth(bd), ssx(sx), ssy(sy), planes(np), width(w),
        height(h), matrix(mc) {
    gmin = -(128 << (bd - 8));
    gmax = (128 << (bd - 8)) - 1;
    active[0] = g.num[0] > 0;
    for (int p = 1; p < 3; ++p) active[p] = p < np && (g.num[p] || g.cfl);
    generate();
    for (int p = 0; p < np; ++p) scaling_lookup(p);
  }

  // generate_grain
  void generate() {
    memset(tmpl, 0, sizeof(tmpl));
    int shift = 12 - bitdepth + g.grain_scale_shift;
    uint32_t r = (uint32_t)g.seed;
    if (g.num[0])
      for (int y = 0; y < 73; ++y)
        for (int x = 0; x < 82; ++x)
          tmpl[0][y][x] = (int16_t)round2(g_tab.gaussian[grain_random(r, 11)],
                                          shift);
    int lag = g.ar_lag, ar_shift = g.ar_shift;
    if (g.num[0])
      for (int y = 3; y < 73; ++y)
        for (int x = 3; x < 82 - 3; ++x) {
          int sum = 0, pos = 0;
          for (int dr = -lag; dr <= 0; ++dr)
            for (int dc = -lag; dc <= lag; ++dc) {
              if (dr == 0 && dc == 0) break;
              sum += tmpl[0][y + dr][x + dc] * g.ar[0][pos++];
            }
          tmpl[0][y][x] = (int16_t)clip3(gmin, gmax,
                                         tmpl[0][y][x] + round2(sum, ar_shift));
        }
    int cw = ssx ? 44 : 82, ch = ssy ? 38 : 73;
    for (int p = 1; p < 3; ++p) {
      if (!active[p]) continue;
      r = (uint32_t)g.seed ^ (p == 1 ? 0xb524u : 0x49d8u);
      for (int y = 0; y < ch; ++y)
        for (int x = 0; x < cw; ++x)
          tmpl[p][y][x] = (int16_t)round2(g_tab.gaussian[grain_random(r, 11)],
                                          shift);
      for (int y = 3; y < ch; ++y)
        for (int x = 3; x < cw - 3; ++x) {
          int sum = 0, pos = 0;
          for (int dr = -lag; dr <= 0; ++dr)
            for (int dc = -lag; dc <= lag; ++dc) {
              int c = g.ar[p][pos];
              if (dr == 0 && dc == 0) {
                if (g.num[0]) {
                  // the co-located luma grain, averaged over the subsampling
                  int luma = 0;
                  int lx = ((x - 3) << ssx) + 3, ly = ((y - 3) << ssy) + 3;
                  for (int i = 0; i <= ssy; ++i)
                    for (int j = 0; j <= ssx; ++j)
                      luma += tmpl[0][ly + i][lx + j];
                  sum += round2(luma, ssx + ssy) * c;
                }
                break;
              }
              sum += c * tmpl[p][y + dr][x + dc];
              ++pos;
            }
          tmpl[p][y][x] = (int16_t)clip3(gmin, gmax,
                                         tmpl[p][y][x] + round2(sum, ar_shift));
        }
    }
  }

  // scaling_lookup_init, then scale_lut's interpolation above 8 bits
  void scaling_lookup(int p) {
    const int pl = (p == 0 || g.cfl) ? 0 : p;
    const int n = g.num[pl];
    const int(*pt)[2] = g.points[pl];
    int lut[256];
    if (n == 0) {
      for (int i = 0; i < 256; ++i) lut[i] = 0;
    } else {
      for (int i = 0; i < pt[0][0]; ++i) lut[i] = pt[0][1];
      for (int i = 0; i < n - 1; ++i) {
        int dy = pt[i + 1][1] - pt[i][1], dx = pt[i + 1][0] - pt[i][0];
        int delta = dy * ((65536 + (dx >> 1)) / dx);
        for (int x = 0; x < dx; ++x)
          lut[pt[i][0] + x] = pt[i][1] + ((x * delta + 32768) >> 16);
      }
      for (int i = pt[n - 1][0]; i < 256; ++i) lut[i] = pt[n - 1][1];
    }
    int shift = bitdepth - 8;
    scale[p].resize((size_t)1 << bitdepth);
    for (int v = 0; v < (1 << bitdepth); ++v) {
      int x = v >> shift, rem = v - (x << shift);
      if (bitdepth == 8 || x == 255)
        scale[p][v] = (uint8_t)lut[x];
      else
        scale[p][v] = (uint8_t)(lut[x] + round2((lut[x + 1] - lut[x]) * rem,
                                                shift));
    }
  }

  // Rows i0 .. i1 - 1 of plane p's noise stripe `num` (noiseStripe of the
  // spec, before the seams between stripes), `stride` columns a row.
  void stripe(int num, int p, int i0, int i1, int* out, int stride) const {
    int sx = p ? ssx : 0, sy = p ? ssy : 0;
    uint32_t r = (uint32_t)g.seed;
    r ^= (uint32_t)(((num * 37 + 178) & 255) << 8);
    r ^= (uint32_t)((num * 173 + 105) & 255);
    int rows = std::min(i1, 34 >> sy), cols = 34 >> sx;
    for (int x = 0; x < (width + 1) / 2; x += 16) {
      int rnd = grain_random(r, 8);
      int ox = rnd >> 4, oy = rnd & 15;
      int px = sx ? 6 + ox : 9 + ox * 2, py = sy ? 6 + oy : 9 + oy * 2;
      int col0 = sx ? x : x * 2;
      for (int i = i0; i < rows; ++i) {
        int* o = out + (size_t)(i - i0) * stride + col0;
        const int16_t* t = tmpl[p][py + i] + px;
        for (int j = 0; j < cols; ++j) {
          int v = t[j];
          if (g.overlap && x > 0 && j < (2 >> sx)) {
            int old = o[j];
            v = sx ? old * 23 + v * 22
                   : j == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
            v = clip3(gmin, gmax, round2(v, 5));
          }
          o[j] = v;
        }
      }
    }
  }

  // add_noise for the rows of luma stripe `num`: from the frame `in`
  // (the reconstructed planes) into the caller's planes
  template <typename Pixel>
  void add_noise(int num, Plane<Pixel>* in, Pixel* const* out,
                 const int* ostride) const {
    int min_v = 0, max_luma = (256 << (bitdepth - 8)) - 1;
    int max_chroma = max_luma;
    if (g.clip_restricted) {
      min_v = 16 << (bitdepth - 8);
      max_luma = 235 << (bitdepth - 8);
      max_chroma = matrix == 0 ? max_luma : 240 << (bitdepth - 8);
    }
    const int pmax = (1 << bitdepth) - 1;
    for (int p = 0; p < planes; ++p) {
      int sx = p ? ssx : 0, sy = p ? ssy : 0;
      int pw = (width + sx) >> sx, ph = (height + sy) >> sy;
      int sh = 32 >> sy;  // the stripe's rows in this plane
      int y0 = num * sh, y1 = std::min(y0 + sh, ph);
      if (y0 >= y1) continue;
      if (!active[p]) {
        for (int y = y0; y < y1; ++y)
          memcpy(out[p] + (size_t)y * ostride[p], in[p].row(y),
                 pw * sizeof(Pixel));
        continue;
      }
      int stride = pw + 48;
      std::vector<int> cur((size_t)(y1 - y0) * stride);
      stripe(num, p, 0, y1 - y0, cur.data(), stride);
      int seam = (g.overlap && num > 0) ? std::min(2 >> sy, y1 - y0) : 0;
      if (seam) {
        // the upper stripe's rows below its 32 (16): blended into this
        // stripe's first rows
        std::vector<int> up((size_t)seam * stride);
        stripe(num - 1, p, sh, sh + seam, up.data(), stride);
        for (int i = 0; i < seam; ++i)
          for (int x = 0; x < pw; ++x) {
            int old = up[(size_t)i * stride + x];
            int& v = cur[(size_t)i * stride + x];
            int w = sy ? old * 23 + v * 22
                       : i == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
            v = clip3(gmin, gmax, round2(w, 5));
          }
      }
      const uint8_t* lut = scale[p].data();
      int shift = g.scaling_shift;
      int max_v = p ? max_chroma : max_luma;
      for (int y = y0; y < y1; ++y) {
        const int* noise = cur.data() + (size_t)(y - y0) * stride;
        const Pixel* src = in[p].row(y);
        Pixel* dst = out[p] + (size_t)y * ostride[p];
        if (p == 0) {
          for (int x = 0; x < pw; ++x) {
            int v = src[x];
            dst[x] = (Pixel)clip3(min_v, max_v,
                                  v + round2(lut[v] * noise[x], shift));
          }
          continue;
        }
        const Pixel* luma = in[0].row(y << sy);
        for (int x = 0; x < pw; ++x) {
          int lx = x << sx;
          int avg = luma[lx];
          if (sx) avg = round2(avg + luma[std::min(lx + 1, width - 1)], 1);
          int v = src[x];
          int merged = avg;
          if (!g.cfl) {
            int combined = avg * g.luma_mult[p] + v * g.mult[p];
            merged = clip3(0, pmax, (combined >> 6) +
                                        g.offset[p] * (1 << (bitdepth - 8)));
          }
          dst[x] = (Pixel)clip3(min_v, max_v,
                                v + round2(lut[merged] * noise[x], shift));
        }
      }
    }
  }
};

// Whether the film grain synthesis runs: as libdav1d decides it, where
// some plane has scaling points. (A frame with chroma_scaling_from_luma,
// clip_to_restricted_range and no luma points gets no noise but the
// spec's clip; libdav1d leaves it as it was, and so does the port.)
inline bool grain_applies(const FilmGrain& g) {
  return g.apply && (g.num[0] || g.num[1] || g.num[2]);
}

// The motion field estimation process (7.9): the vectors the references'
// frames kept (MfMvs) projected onto this frame, per 8x8, as libaom keeps
// them (the vector and its own reference's distance; a later projection
// overwrites an earlier one). LAST_FRAME unless it is an overlay of
// GOLDEN_FRAME, the backward references, then LAST2_FRAME while fewer
// than three have been projected.
template <typename Pixel>
void motion_field(Decoder<Pixel>& d) {
  const FrameHdr& fh = d.fh;
  const SeqHdr& s = d.seq;
  int w8 = d.mi_cols >> 1, h8 = d.mi_rows >> 1;
  d.tpl_mv.assign((size_t)w8 * h8 * 2, 0);
  d.tpl_off.assign((size_t)w8 * h8, 0);
  auto project = [&](int src, int dir) -> bool {
    const RefPic<Pixel>& R = *d.refs[src];
    if (R.mf_ref.empty() || R.mi_rows != d.mi_rows || R.mi_cols != d.mi_cols)
      return false;
    int to_cur = get_relative_dist(s, R.fh.order_hint, fh.order_hint);
    if (dir == 2) to_cur = -to_cur;
    int ref_offset[8] = {0};
    for (int rf = LAST_FRAME; rf <= ALTREF_FRAME; ++rf)
      ref_offset[rf] =
          get_relative_dist(s, R.fh.order_hint, R.fh.order_hints[rf]);
    for (int y8 = 0; y8 < h8; ++y8)
      for (int x8 = 0; x8 < w8; ++x8) {
        size_t mi = (size_t)(2 * y8 + 1) * d.mi_cols + 2 * x8 + 1;
        int rf = R.mf_ref[mi];
        if (rf <= INTRA_FRAME) continue;
        int off = ref_offset[rf];
        if (off <= 0 || off > 31 || std::abs(to_cur) > 31) continue;
        const int32_t* mv = &R.mf_mv[mi * 2];
        int proj[2];
        mv_projection(mv, to_cur, off, proj);
        int ro = proj[0] >= 0 ? proj[0] >> 6 : -((-proj[0]) >> 6);
        int co = proj[1] >= 0 ? proj[1] >> 6 : -((-proj[1]) >> 6);
        int row = dir == 2 ? y8 - ro : y8 + ro;
        int col = dir == 2 ? x8 - co : x8 + co;
        int base_r = (y8 >> 3) << 3, base_c = (x8 >> 3) << 3;
        if (row < 0 || row >= h8 || col < 0 || col >= w8) continue;
        if (row < base_r || row >= base_r + 8 || col < base_c - 8 ||
            col >= base_c + 16)
          continue;
        size_t at = (size_t)row * w8 + col;
        d.tpl_mv[at * 2] = mv[0];
        d.tpl_mv[at * 2 + 1] = mv[1];
        d.tpl_off[at] = (int8_t)off;
      }
    return true;
  };
  int stamp = 2;
  if (d.refs[LAST_FRAME]->fh.order_hints[ALTREF_FRAME] !=
      fh.order_hints[GOLDEN_FRAME])
    project(LAST_FRAME, 2);
  --stamp;
  auto ahead = [&](int rf) {
    return get_relative_dist(s, fh.order_hints[rf], fh.order_hint) > 0;
  };
  if (ahead(BWDREF_FRAME) && project(BWDREF_FRAME, 0)) --stamp;
  if (ahead(ALTREF2_FRAME) && project(ALTREF2_FRAME, 0)) --stamp;
  if (ahead(ALTREF_FRAME) && stamp >= 0 && project(ALTREF_FRAME, 0)) --stamp;
  if (stamp >= 0) project(LAST2_FRAME, 2);
}

// Decodes frame k of the walk (its references decoded before it, in
// `pics`) into the picture its slots keep: the tiles from the frame's
// starting CDFs (the defaults of its q context, or the primary
// reference's), then the in-loop filters; then its frame-end CDFs,
// segment ids and the vectors later frames project (7.19).
template <typename Pixel>
std::shared_ptr<RefPic<Pixel>> decode_one(
    Stream& st, int k, std::vector<std::shared_ptr<RefPic<Pixel>>>& pics,
    ToolCounts& counts) {
  const FrameRec& r = *st.recs[k];
  std::unique_ptr<Decoder<Pixel>> dp(new Decoder<Pixel>());
  Decoder<Pixel>& d = *dp;
  d.seq = st.seq;
  d.fh = r.fh;
  const FrameHdr& fh = d.fh;
  d.alloc();
  for (int pl = 0; pl < d.planes; ++pl) {
    int sx = pl ? d.ssx : 0, sy = pl ? d.ssy : 0;
    if (fh.lr_type[pl] != RESTORE_NONE) {
      int unit = fh.lr_size[pl];
      d.lr_rows[pl] = count_units(unit, round2(fh.height, sy));
      d.lr_cols[pl] = count_units(unit, round2(fh.upscaled_width, sx));
      d.lr[pl].assign((size_t)d.lr_rows[pl] * d.lr_cols[pl], LrUnit{});
    }
  }
  if (fh.inter)
    for (int i = 0; i < 7; ++i) {
      const RefPic<Pixel>* ref = pics[r.refs[i]].get();
      if (!ref) bad("a reference frame is not decoded");
      d.refs[LAST_FRAME + i] = ref;
      d.x_scale[LAST_FRAME + i] =
          ((ref->fh.upscaled_width << 14) + fh.width / 2) / fh.width;
      d.y_scale[LAST_FRAME + i] =
          ((ref->fh.height << 14) + fh.height / 2) / fh.height;
    }
  const RefPic<Pixel>* prev =
      fh.primary_ref_frame == PRIMARY_REF_NONE
          ? nullptr
          : d.refs[LAST_FRAME + fh.primary_ref_frame];
  if (prev) {
    d.init_cdf = prev->cdf;
  } else {
    int qctx = fh.base_q_idx <= 20 ? 0 : fh.base_q_idx <= 60 ? 1
               : fh.base_q_idx <= 120 ? 2 : 3;
    d.init_cdf = g_tab.cdf[qctx];
  }
  d.end_cdf = d.init_cdf;
  if (prev && fh.seg_enabled && prev->mi_rows == d.mi_rows &&
      prev->mi_cols == d.mi_cols)
    d.prev_seg_ids = prev->seg_ids;
  if (fh.use_ref_frame_mvs) motion_field(d);
  decode_tiles(d, r.jobs, counts);
  postfilter(d);
  std::shared_ptr<RefPic<Pixel>> pic(new RefPic<Pixel>());
  pic->fh = fh;
  for (int p = 0; p < d.planes; ++p) pic->planes[p] = std::move(d.cur[p]);
  pic->cdf = fh.disable_frame_end_update_cdf ? d.init_cdf : d.end_cdf;
  clear_counters(pic->cdf);
  pic->mi_rows = d.mi_rows;
  pic->mi_cols = d.mi_cols;
  if (fh.seg_enabled)
    pic->seg_ids = fh.seg_update_map ? std::move(d.seg_ids) : d.prev_seg_ids;
  if (fh.inter) {
    size_t n = (size_t)d.mi_rows * d.mi_cols;
    pic->mf_ref.assign(n, NONE_FRAME);
    pic->mf_mv.assign(n * 2, 0);
    for (size_t i = 0; i < n; ++i)
      for (int list = 0; list < 2; ++list) {
        int rf = d.ref_frames[i * 2 + list];
        if (rf <= INTRA_FRAME) continue;
        if (get_relative_dist(d.seq, fh.order_hints[rf], fh.order_hint) >= 0)
          continue;
        int mr = d.mvs4[i * 4 + list * 2], mc = d.mvs4[i * 4 + list * 2 + 1];
        if (std::abs(mr) > 4095 || std::abs(mc) > 4095) continue;
        pic->mf_ref[i] = (int8_t)rf;
        pic->mf_mv[i * 2] = mr;
        pic->mf_mv[i * 2 + 1] = mc;
      }
  }
  return pic;
}

// Decodes the stream's output frame into the caller's planes (samples of
// type Pixel, strides in samples): the frames it depends on first, in
// decode order, each kept while a later one may reference it.
template <typename Pixel>
void decode_frame(Stream& st, Pixel* y, int ystride, Pixel* u, Pixel* v,
                  int cstride, bool apply_grain) {
  int n = (int)st.recs.size();
  std::vector<std::shared_ptr<RefPic<Pixel>>> pics(n);
  // the last needed frame that references each one
  std::vector<int> last_use(n, -1);
  for (int k = 0; k < n; ++k)
    if (st.needed[k])
      for (int i = 0; i < 7; ++i)
        if (st.recs[k]->refs[i] >= 0) last_use[st.recs[k]->refs[i]] = k;
  ToolCounts counts;
  for (int k = 0; k <= st.chosen; ++k) {
    if (!st.needed[k]) continue;
    pics[k] = decode_one<Pixel>(st, k, pics, counts);
    for (int j = 0; j < k; ++j)
      if (pics[j] && last_use[j] <= k && j != st.chosen) pics[j].reset();
  }
  st.res.palette_blocks = counts.palette;
  st.res.intrabc_blocks = counts.intrabc;
  for (int i = 0; i < kNumTools; ++i) st.res.tools[i] = counts.tools[i];
  RefPic<Pixel>& out = *pics[st.chosen];
  const FrameHdr& fh = out.fh;
  int planes = st.seq.mono ? 1 : 3, ssx = st.seq.ssx, ssy = st.seq.ssy;
  int w = fh.upscaled_width, h = fh.height;
  Plane<Pixel>* cur = out.planes;
  if (apply_grain && grain_applies(fh.grain)) {
    std::unique_ptr<GrainSynth> gs(new GrainSynth(
        fh.grain, st.seq.bitdepth, ssx, ssy, planes, w, h, st.seq.matrix));
    Pixel* outp[3] = {y, u, v};
    int ostride[3] = {ystride, cstride, cstride};
    int stripes = ((h + 1) / 2 + 15) / 16;
    parallel_for(stripes,
                 [&](int i) { gs->add_noise(i, cur, outp, ostride); });
    return;
  }
  for (int i = 0; i < h; ++i)
    memcpy(y + (size_t)i * ystride, cur[0].row(i), w * sizeof(Pixel));
  if (!st.seq.mono) {
    int cw = (w + ssx) >> ssx, ch = (h + ssy) >> ssy;
    for (int i = 0; i < ch; ++i) {
      memcpy(u + (size_t)i * cstride, cur[1].row(i), cw * sizeof(Pixel));
      memcpy(v + (size_t)i * cstride, cur[2].row(i), cw * sizeof(Pixel));
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI

struct IkAv1dInfo {
  int32_t width, height, layout, bitdepth, mono, color_range, matrix,
      primaries, transfer;
  // the frame header's allow_screen_content_tools and allow_intrabc, and
  // after a decode the blocks that coded a palette or intra block copy
  int32_t allow_sct, allow_intrabc, palette_blocks, intrabc_blocks;
  // the frame's in-loop filters: 1 deblocking, 2 CDEF, 4 loop restoration
  int32_t filters;
  // the frame header's using_qmatrix and apply_grain
  int32_t qmatrix, film_grain;
  // SuperresDenom: 8 without superres, else 9..16 (the coded width is
  // width * 8 / superres_denom, rounded)
  int32_t superres_denom;
  // the output frame's spatial_id, whether it was shown from a slot
  // (show_existing_frame), and the frames read before it was known
  int32_t spatial_id, shown_existing, frames;
  // the output frame is an INTER or SWITCH frame; the frames decoded for
  // it; after a decode, the blocks of those frames that used each inter
  // tool (TOOL_*)
  int32_t inter, decoded;
  int32_t tools[kNumTools];
  char reason[120];
};

static int finish(const Fail& f, IkAv1dInfo* info) {
  if (info) {
    strncpy(info->reason, f.why, sizeof(info->reason) - 1);
    info->reason[sizeof(info->reason) - 1] = 0;
  }
  return f.code;
}

static void fill(const Result& r, IkAv1dInfo* info) {
  info->width = r.width;
  info->height = r.height;
  info->layout = r.layout;
  info->bitdepth = r.bitdepth;
  info->mono = r.mono;
  info->color_range = r.color_range;
  info->matrix = r.matrix;
  info->primaries = r.primaries;
  info->transfer = r.transfer;
  info->allow_sct = r.allow_sct;
  info->allow_intrabc = r.allow_intrabc;
  info->palette_blocks = r.palette_blocks;
  info->intrabc_blocks = r.intrabc_blocks;
  info->filters = r.filters;
  info->qmatrix = r.qmatrix;
  info->film_grain = r.film_grain;
  info->superres_denom = r.superres_denom;
  info->spatial_id = r.spatial_id;
  info->shown_existing = r.shown_existing;
  info->frames = r.frames;
  info->inter = r.inter;
  info->decoded = r.decoded;
  for (int i = 0; i < kNumTools; ++i) info->tools[i] = r.tools[i];
}

IK_EXPORT int ik_av1d_tables_size() { return (int)sizeof(Tables); }

// The threads that tiles, CDEF's rows and film grain's stripes take: 0 for
// one a core, else at most n.
IK_EXPORT void ik_av1d_set_threads(int n) { g_threads = n; }

IK_EXPORT int ik_av1d_set_tables(const void* blob, int size) {
  if (size != (int)sizeof(Tables)) return IK_AV1D_NO_TABLES;
  memcpy(&g_tab, blob, sizeof(Tables));
  for (int k = 0; k <= 64; ++k)
    g_cos128[k] = (int)(4096 * std::cos(k * M_PI / 128) + 0.5);
  g_ready = true;
  return IK_AV1D_OK;
}

// The sequence header and the output frame's header (`select`: -1 the
// first shown frame, -2 the highest spatial layer's, 0..3 that layer's;
// `op` the operating point): dimensions, layout, bit depth and colour
// description, without decoding tiles.
IK_EXPORT int ik_av1d_probe(const uint8_t* data, size_t n, int select, int op,
                            IkAv1dInfo* info) {
  memset(info, 0, sizeof(*info));
  try {
    if (select < kSelectLast || select > 3 || op < 0 || op > 31)
      bad("frame selection");
    Stream st;
    parse_stream(data, n, st, false, select, op);
    fill(st.res, info);
    return IK_AV1D_OK;
  } catch (const Fail& f) {
    return finish(f, info);
  } catch (const std::bad_alloc&) {
    return finish(Fail{IK_AV1D_BAD, "out of memory"}, info);
  }
}

// Decodes the output frame (`select` and `op` as for ik_av1d_probe) into y
// (ystride) and u, v (cstride), whose sizes
// the caller takes from ik_av1d_probe: width x height luma, chroma rounded
// up by the layout's subsampling; u and v are unused for monochrome. The
// samples are uint8_t for an 8-bit stream and uint16_t for a 10- or
// 12-bit one (the probe's bitdepth), strides in samples; `bitdepth` is the
// depth the caller allocated for, and a stream of another answers
// IK_AV1D_BAD. `apply_grain` 0 leaves the film grain out (libdav1d's
// setting of that name): the frame as reconstructed, for diagnostics.
IK_EXPORT int ik_av1d_decode(const uint8_t* data, size_t n, int bitdepth,
                             void* y, int ystride, void* u, void* v,
                             int cstride, int apply_grain, int select, int op,
                             IkAv1dInfo* info) {
  memset(info, 0, sizeof(*info));
  if (!g_ready) return IK_AV1D_NO_TABLES;
  if (select < kSelectLast || select > 3 || op < 0 || op > 31)
    return finish(Fail{IK_AV1D_BAD, "frame selection"}, info);
  try {
    Stream st;
    parse_stream(data, n, st, true, select, op);
    if (st.seq.bitdepth != bitdepth) bad("bit depth differs from the probe's");
    if (bitdepth == 8)
      decode_frame<uint8_t>(st, (uint8_t*)y, ystride, (uint8_t*)u,
                            (uint8_t*)v, cstride, apply_grain != 0);
    else
      decode_frame<uint16_t>(st, (uint16_t*)y, ystride, (uint16_t*)u,
                             (uint16_t*)v, cstride, apply_grain != 0);
    fill(st.res, info);
    return IK_AV1D_OK;
  } catch (const Fail& f) {
    return finish(f, info);
  } catch (const std::bad_alloc&) {
    return finish(Fail{IK_AV1D_BAD, "out of memory"}, info);
  }
}

// One 1-D inverse transform, for the tests: kind 0 DCT, 1 ADST, 2 identity,
// 3 WHT (shift in n); n = log2 of the length.
IK_EXPORT void ik_av1d_tx1d(int64_t* T, int kind, int n) {
  if (!g_ready)
    for (int k = 0; k <= 64; ++k)
      g_cos128[k] = (int)(4096 * std::cos(k * M_PI / 128) + 0.5);
  if (kind == 3) return iwht(T, n);
  tx1d(T, kind, n);
}
