// The banded two-pass resize body that K2 (resize_strip.cu) and K3/K4
// (resize_planes.cu) share: up to six planes of a batch in one launch,
// each a plane of pixel rows of C elements (C = 1, 3 for an interleaved RGB
// batch or 4 for an RGBA one, every channel read), per image b and channel ch
//
//   acc[ch] = Wv[vidx[b]] @ f32(x[b][:, :, ch]) @ Wh[hidx[b]]^T
//
// then the u8 epilogue (optional (acc + pre) * scale + post with the plane's
// own constants, floor(v + 0.5), clip to [0, 255], u8, or i8 after -128 when
// centred) or the f32 store. The input and output types are chosen apart:
// u8 planes can be stored as unrounded f32 with no widened copy of them in
// device memory. Pixels of one or three channels leave as planes (channel ch
// of image b at out + b*osb + ch*osc); pixels of four leave as they came,
// interleaved (B, OH, OW, 4), one 32-bit store a pixel: the plain RGB head's
// host encoders take pixels, and its readback is one contiguous copy.
//
// What bounds it on an H100: at the flagship bucket (1088x1920 -> 240x400)
// a row of Wv has about 27 nonzero taps, a row of Wh about 29. Over the band
// the three channels of a B=32 RGB batch are about 2.9 GFLOP (44 us at
// 67 TFLOP/s fp32) for 200 MB of u8 read once (63 us at 3.35 TB/s): bytes
// first, but the FMAs are close behind, so the design wastes neither.
// Rows must be whole loads (W*C and the strides multiples of CPT), which
// every bucket of the engines is.
//
// Design, and what each point answers:
// - One grid for every plane: blockIdx.x walks plane 0's (image, tile of
//   TR output rows, strip of output columns), then plane 1's, and so on
//   (up to six: the Y, Cb, Cr and alpha planes of an AVIF batch, or a
//   BT.709 batch's Y, its chroma to two grids and its alpha); each
//   plane's pointers,
//   strides and shapes come by value in the kernel's parameter block
//   (__grid_constant__). A plane's tiles of one image are neighbours in the
//   grid, so the rows two tiles share come from L2 the second time.
// - Pass 1 (vertical) reads the pixel rows in place, whole (all C elements
//   of a pixel, so an interleaved RGB batch is read once for its three
//   channels, with no de-interleave copy): each thread takes CPT
//   neighbouring elements of a row (8 bytes of u8, 16 of f32), neighbouring
//   threads on neighbouring addresses, through its own ring of kSlots
//   shared-memory slots filled by cp.async kDepth rows ahead (the thread
//   reads only its own slots, so the ring needs its own wait and no
//   barrier). The vertical pass does not mix elements, so channels need no
//   care until pass 2.
// - Exact per-row bands in pass 1: an input row i feeds only the tile rows
//   whose own [first, last) holds it. With monotone bands (every Lanczos
//   stack; empty pad rows take a neighbour's band and zero weights) those
//   rows are a run [a, b) that changes only at band edges, so the i loop is
//   cut into segments and each segment runs a loop compiled for its run
//   (dispatch_run): no FMA is spent off a row's band, and each row still
//   sums its taps in increasing i, as the dense loop did (the skipped terms
//   are exact zeros: fmaf(0, x, t) == t for finite x). Stacks whose bands
//   are not monotone take one segment over the tile's band union, with the
//   zero weights in it: the same sums, more FMAs. Samples are widened once
//   per row and tile (byte_perm into 2^23 + x, minus 2^23: exact, two
//   full-rate instructions instead of a quarter-rate I2F).
// - The (TR, W*C) f32 intermediate stays in shared memory; TR is the
//   largest of 8, 4, 2 whose tile and ring leave 512 threads an SM: two
//   blocks of 256 for RGB rows (the flagship batch takes TR 4: 109 KB),
//   four of 128 for u8 planes (a 960-wide chroma plane has 120 column
//   groups, so a wider block would idle). So the tile is shorter than the
//   earlier kernel's 8 rows, where taller tiles (16-32 rows) were the aim:
//   a whole 5760-float RGB row of f32 is 23 KB, and two blocks an SM leave
//   room for 4 of them. An RGBA row of 1920 pixels is 30 KB of f32: two
//   blocks an SM leave room for 2 of them (TR 2, 77 KB a block), so each
//   input row is widened for about 16 rows' worth of tiles where RGB's TR 4
//   widens it for about 10; four rows need 137 KB, one block an SM
//   (PERF.md, section 6, has both measured).
// - Column strips, where whole rows do not fit even at TR 2 in the largest
//   budget (rows past about 26,700 elements: a 9600-px RGB row of an image
//   beyond the bucket ladder, an RGBA row of the 8192 bucket; a row held
//   whole would need shared memory growing with IW). A block then takes
//   one strip of output columns [q, q_end), and pass 1 widens only the
//   input elements that the strip's compact windows cover, [start_q
//   rounded down to a whole load, start_{q_end-1} + T rounded up), into a
//   tile whose pitch follows the strip's width and the horizontal scale,
//   not IW (band_geometry picks the tallest TR and the widest strip that
//   fit the preferred budget, strips no narrower than kMinStrip). Each
//   output sums the same terms in the same order as with whole rows, so
//   the bytes are the whole-row body's (held under the CPU shim and on the
//   card). Starts that never fall are bounded by the window ends
//   (compact_table gives pad columns a neighbour's start so that they do
//   not fall); other stacks search their span column by column, more than
//   one span a strip where the windows spread. Tile elements past the row
//   (an upscale's last windows) are zeros. Launches with no plane in
//   strips take an instantiation without them (kStrips), whose code is the
//   whole-row body's alone.
// - Pass 2 (horizontal) reads Wh through a compact table: output column p
//   takes Wh[p][start_p : start_p + T], start_p the band's first
//   column rounded down to a multiple of 4, T the widest such window
//   rounded up to 4, zero off the band, stored (U2, T/4, OW, 4) so that a
//   warp's float4 loads of a step are contiguous. One thread per output
//   column takes every channel and tile row (each tap loaded once, for
//   C * TR sums) and reads the tile four taps at a time (C aligned
//   float4s); the leading zero taps add exact zeros, so each sum is the
//   dense product's in increasing j.
// - The epilogue's adds and products are kept apart (__fadd_rn, __fmul_rn)
//   so nvcc cannot contract them into FMAs.
//
// Measured on an H100 (PERF.md, section 6): pass 1 is bound by its instruction
// issue (per row and thread: the wait, the slot load, the widen and the
// refill, around 8 to 27 FMAs), pass 2 costs about a third of the kernel.
// Tried and not kept: deeper or shallower rings, 16-byte u8 loads, 192 or
// 384 threads, 8-row tiles at one block per SM, a runtime row predicate in
// place of the compiled runs, batched tap loads in pass 2.
// Not done: column strips where whole rows fit (at the flagship slower
// for RGB rows, about even for RGBA: PERF.md section 6), TMA, tensor cores
// (split-bf16 wgmma would hold the band; TF32 would not).
//
// The body also compiles as plain C++ under a small shim (one thread per
// block) for the CPU tests: launches go through IK_LAUNCH, dynamic shared
// memory through IK_DYN_SMEM and the cp.async ring through IK_CP_*.

#pragma once

#include <stdint.h>

#include <algorithm>

#ifndef IK_DYN_SMEM
#define IK_DYN_SMEM(type, name) extern __shared__ __align__(16) type name[]
#endif
#ifndef IK_LAUNCH
#define IK_LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<grid, block, smem, stream>>>
#endif
#ifndef IK_CP_ASYNC
template <int N>
__device__ __forceinline__ void ik_cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N)
                 : "memory");
}
#define IK_CP_ASYNC(dst, src, bytes) ik_cp_async<bytes>(dst, src)
#define IK_CP_COMMIT() asm volatile("cp.async.commit_group;\n" ::: "memory")
#define IK_CP_WAIT(n) asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory")
#endif

namespace {

// threads per block: 128 for a u8 plane (a 960-wide chroma plane has 120
// column groups of 8), else 256
template <typename Tin, int NCH>
constexpr int band_threads() {
  return sizeof(Tin) == 1 && NCH == 1 ? 128 : 256;
}
constexpr int kBandChunk = 64;  // input rows of Wv staged per step of pass 1
constexpr int kBandPlanes = 6;
constexpr int kSlots = 8;  // ring slots per thread in pass 1 (a power of 2)
constexpr int kDepth = kSlots - 1;  // row loads in flight per thread
// at most this much shared memory a block, so that 512 threads (two blocks
// of 256 or four of 128) fit an SM
constexpr size_t band_preferred_smem(int threads) {
  return (threads == 256 ? 110 : 54) * 1024;
}
constexpr size_t kBandMaxSmem = 225 * 1024;

// One plane of a launch, as the host fills it (the layout of the ctypes
// structure in ops/_build.py).
struct IkPlane {
  const void* x;           // pixel row i of image b at x + b*sb + i*sh
  const float* wv;         // (U, OH, IH)
  const int32_t* band_v;   // (U, OH, 2) [first, last) of each row of Wv
  const int32_t* start_h;  // (U2, OW) first column of each compact row
  const float* taps_h;     // (U2, T/4, OW, 4): Wh[p][start_p + t] at
                           // [t / 4][p][t % 4]
  const int32_t* vidx;     // (B,)
  const int32_t* hidx;     // (B,)
  void* out;               // out + b*osb + ch*osc + o*OW + p
  long long sb, sh, osb, osc;  // in elements
  int IH, IW, OH, OW, U, U2, T;
  int C;  // elements per pixel, all read (1, 3 for an interleaved RGB row,
          // 4 for an RGBA row, whose output is interleaved too)
  // the plane's own u8 epilogue: (acc + pre) * scale + post where affine is
  // set (Y and chroma of one launch remap with different constants)
  float scale, pre, post;
  int affine;
  // output columns a block takes: 0 lets band_resize choose (whole rows
  // where they fit, else strips); a caller may ask for strips of this
  // width where whole rows would fit (to hold the two bodies against each
  // other)
  int strip;
};

struct IkBandLaunch {
  IkPlane p[kBandPlanes];
  int block0[kBandPlanes + 1];  // first block of each plane; total last
  int tiles[kBandPlanes];       // row tiles per image
  int strips[kBandPlanes];      // column strips per row tile
  int sw[kBandPlanes];          // output columns per strip
  int spans[kBandPlanes];       // 0: whole rows; 1: strips, windows searched
  int pitch[kBandPlanes];       // tile row pitch in floats
  int centered;
};

template <typename T>
struct Vec;  // CPT elements per load
template <>
struct Vec<uint8_t> {
  static constexpr int kCpt = 8;
  using type = uint2;
};
template <>
struct Vec<float> {
  static constexpr int kCpt = 4;
  using type = float4;
};

__device__ __forceinline__ float u8f(uint32_t word, int k) {
  // 0x4B0000xx is 2^23 + xx as a float: exact for every byte
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | k)),
                   8388608.0f);
}

__device__ __forceinline__ void widen(const uint2& v, float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = u8f(v.x, k);
#pragma unroll
  for (int k = 0; k < 4; ++k) f[4 + k] = u8f(v.y, k);
}

__device__ __forceinline__ void widen(const float4& v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// the u8 epilogue: the byte stored for v (two's complement when centred)
__device__ __forceinline__ uint8_t quant_u8(float v, const IkPlane& P,
                                            int centered) {
  if (P.affine) v = __fadd_rn(__fmul_rn(__fadd_rn(v, P.pre), P.scale), P.post);
  v = floorf(__fadd_rn(v, 0.5f));
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  const int q = static_cast<int>(v);
  return static_cast<uint8_t>(centered ? q - 128 : q);
}

__device__ __forceinline__ void store_out(uint8_t* p, float v,
                                          const IkPlane& P, int centered) {
  *p = quant_u8(v, P, centered);
}

__device__ __forceinline__ void store_out(float* p, float v, const IkPlane&,
                                          int) {
  *p = v;
}

// Pass 1 over one column group: the accumulators of TR rows x CPT elements,
// the staged weights, and this thread's ring of kSlots row loads in shared
// memory, kDepth of them in flight (cp.async: the thread reads only its own
// slots, so no barrier is needed, only its own wait). A slot is refilled
// one row after it was read, once its value is in registers.
template <typename Tin, int TR>
struct Pass1 {
  using V = typename Vec<Tin>::type;
  static constexpr int kCpt = Vec<Tin>::kCpt;
  float (&acc)[TR][kCpt];
  V* ring;         // slot s of this thread at ring[s * stride]
  int stride;
  const Tin* src;  // the next row to fetch, at this group's elements
  long long sh;
  const float* w;  // staged Wv of the next row to take: [i - c0][TR]
  int left;        // rows of the chunk still to fetch
  int rs = 0, ws = 0;

  __device__ __forceinline__ void fetch() {
    if (left > 0) IK_CP_ASYNC(ring + ws * stride, src, sizeof(V));
    --left;
    src += sh;
    ws = (ws + 1) & (kSlots - 1);
    IK_CP_COMMIT();
  }

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) fetch();
  }

  // the next row's samples and weights; its slot is refilled kDepth rows
  // ahead
  __device__ __forceinline__ const float* take(float* xv) {
    IK_CP_WAIT(kDepth - 1);
    const V v = ring[rs * stride];
    rs = (rs + 1) & (kSlots - 1);
    widen(v, xv);
    fetch();
    const float* wi = w;
    w += TR;
    return wi;
  }

  // input rows i0 .. i1-1 that no tile row reads
  __device__ __forceinline__ void skip(int i0, int i1) {
    float xv[kCpt];
    for (int i = i0; i < i1; ++i) take(xv);
  }

  // rows A .. B-1 take input rows i0 .. i1-1
  template <int A, int B>
  __device__ __forceinline__ void run(int i0, int i1) {
    for (int i = i0; i < i1; ++i) {
      float xv[kCpt];
      const float* wi = take(xv);
      float wr[TR];
      if constexpr (TR % 4 == 0) {
#pragma unroll
        for (int q = A / 4; q <= (B - 1) / 4; ++q) {
          const float4 t = reinterpret_cast<const float4*>(wi)[q];
          wr[4 * q] = t.x;
          wr[4 * q + 1] = t.y;
          wr[4 * q + 2] = t.z;
          wr[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int r = A; r < B; ++r) wr[r] = wi[r];
      }
#pragma unroll
      for (int r = A; r < B; ++r)
#pragma unroll
        for (int c = 0; c < kCpt; ++c)
          acc[r][c] = fmaf(wr[r], xv[c], acc[r][c]);
    }
  }
};

// Calls body.run<A, B>(i0, i1) for the run [a, b) given at run time.
template <int TR, int A, int B, typename Body>
__device__ __forceinline__ void dispatch_run(int a, int b, Body& body, int i0,
                                             int i1) {
  if constexpr (A < TR) {
    if constexpr (B > TR) {
      dispatch_run<TR, A + 1, A + 2>(a, b, body, i0, i1);
    } else {
      if (a == A && b == B)
        body.template run<A, B>(i0, i1);
      else
        dispatch_run<TR, A, B + 1>(a, b, body, i0, i1);
    }
  }
}

// The span of a strip's output columns from q: the longest run [q, q1)
// whose compact windows [start_p, start_p + T) fit a tile row of pitch
// floats, and the input elements [e_lo, e_lo + e_n) they cover, both whole
// loads, into span[] for every thread. Starts that never fall (the stacks
// compact_table makes) are searched by halves, others column by column;
// one column always fits (band_resize sizes the pitch so).
template <int NCH, int kCpt>
__device__ __forceinline__ void strip_span(const int32_t* st, int T, int q,
                                           int q_end, int pitch, int* span) {
  int falls = 0;
  for (int p = q + threadIdx.x; p + 1 < q_end; p += blockDim.x)
    falls |= st[p + 1] < st[p];
  falls = __syncthreads_or(falls);
  if (threadIdx.x == 0) {
    auto e_floor = [](int col) { return col * NCH / kCpt * kCpt; };
    auto e_ceil = [](int col) { return (col * NCH + kCpt - 1) / kCpt * kCpt; };
    int lo = st[q], hi = st[q] + T, q1 = q + 1;
    if (!falls) {
      int a = q + 1, z = q_end;  // the last end that fits lies in [a, z]
      while (a < z) {
        const int m = (a + z + 1) / 2;
        if (e_ceil(st[m - 1] + T) - e_floor(lo) <= pitch)
          a = m;
        else
          z = m - 1;
      }
      q1 = a;
      hi = st[q1 - 1] + T;
    } else {
      for (; q1 < q_end; ++q1) {
        const int nlo = min(lo, st[q1]);
        const int nhi = max(hi, st[q1] + T);
        if (e_ceil(nhi) - e_floor(nlo) > pitch) break;
        lo = nlo;
        hi = nhi;
      }
    }
    span[0] = e_floor(lo);
    span[1] = e_ceil(hi) - span[0];
    span[2] = q1;
  }
  __syncthreads();
}

// kStrips: the launch has a plane in column strips. A launch of whole
// rows only takes the instantiation without them, whose code is the
// whole-row body's alone (the strips' bookkeeping costs registers, and
// spills where a tile row's accumulators already fill them).
template <typename Tin, typename Tout, int TR, int NCH, bool kStrips>
__global__ void __launch_bounds__(band_threads<Tin, NCH>(),
                                  512 / band_threads<Tin, NCH>())
band_resize_kernel(const __grid_constant__ IkBandLaunch L) {
  static_assert(TR >= 1 && TR <= 8, "TR rows of accumulators");
  static_assert(NCH == 1 || NCH == 3 || NCH == 4,
                "one channel, the three of RGB or the four of RGBA");
  static_assert(NCH != 4 || sizeof(Tout) == 1, "RGBA pixels leave as u8");
  // NCH is every plane's C (band_resize checks it)
  constexpr int kCpt = Vec<Tin>::kCpt;
  IK_DYN_SMEM(float, smem);
  __shared__ int rows_f[TR], rows_l[TR], window[2], span[3];

  int pi = 0;
  while (pi + 1 < kBandPlanes && (int)blockIdx.x >= L.block0[pi + 1]) ++pi;
  const IkPlane& P = L.p[pi];
  const int nstrips = kStrips ? L.strips[pi] : 1;
  const int rel = (blockIdx.x - L.block0[pi]) / nstrips;
  const int strip = blockIdx.x - L.block0[pi] - rel * nstrips;
  const int b = rel / L.tiles[pi];
  const int o0 = (rel - b * L.tiles[pi]) * TR;
  const int pitch = L.pitch[pi];
  float* tile = smem;                                  // [TR][pitch]
  float* w_s = tile + (size_t)TR * pitch;              // [kBandChunk][TR]
  using V = typename Vec<Tin>::type;
  V* ring = reinterpret_cast<V*>(w_s + kBandChunk * TR);  // [kSlots][threads]
  // an index outside the stack is clamped, as a JAX gather clamps it
  const int uv = min(max(P.vidx[b], 0), P.U - 1);
  const int uh = min(max(P.hidx[b], 0), P.U2 - 1);
  const float* wv_b = P.wv + (size_t)uv * P.OH * P.IH;

  // The tile rows' bands. Rows past OH and empty (pad) rows take a
  // neighbour's band (their weights are zero); bands that are not monotone
  // become the union for every row.
  if (threadIdx.x == 0) {
    const int32_t* bv = P.band_v + (size_t)uv * P.OH * 2;
    int f[TR], l[TR], lo = P.IH, hi = 0, first = -1;
    for (int r = 0; r < TR; ++r) {
      const int o = o0 + r;
      f[r] = o < P.OH ? max(bv[2 * o], 0) : 0;
      l[r] = o < P.OH ? min(bv[2 * o + 1], P.IH) : 0;
      if (f[r] < l[r]) {
        if (first < 0) first = r;
        lo = min(lo, f[r]);
        hi = max(hi, l[r]);
      }
    }
    bool mono = true;
    for (int r = 0; r < TR; ++r) {
      if (first < 0) {
        f[r] = l[r] = 0;
        continue;
      }
      if (f[r] >= l[r]) {
        const int s = r < first ? first : r - 1;
        f[r] = f[s];
        l[r] = l[s];
      }
      if (r > 0 && (f[r] < f[r - 1] || l[r] < l[r - 1])) mono = false;
    }
    for (int r = 0; r < TR; ++r) {
      rows_f[r] = mono ? f[r] : lo;
      rows_l[r] = mono ? l[r] : hi;
    }
    window[0] = first < 0 ? 0 : lo;
    window[1] = first < 0 ? 0 : hi;
  }
  __syncthreads();
  const int lo = window[0];
  const int hi = window[1];

  const Tin* xb = static_cast<const Tin*>(P.x) + (size_t)b * P.sb;

  // The block's output columns [q, q_end) go in spans, each a pass 1 over
  // the input elements [e_lo, e_lo + e_n) that its compact windows cover
  // and a pass 2 over its columns. Whole rows: one span, every element.
  // A strip: as many columns a span as the tile's pitch holds (all of them
  // where the strip's windows fit, as band_resize sized them).
  // (Without strips nothing of this is live through pass 1: q and e_lo
  // are 0, and pass 2 reads its end from P.)
  int q = 0, q_end = 0;
  if constexpr (kStrips) {
    q = strip * L.sw[pi];
    q_end = min(P.OW, q + L.sw[pi]);
  }
  do {
    int e_lo = 0, e_n = pitch, q1 = q_end;
    if (kStrips && L.spans[pi]) {
      strip_span<NCH, kCpt>(P.start_h + (size_t)uh * P.OW, P.T, q, q_end,
                            pitch, span);
      e_lo = span[0];
      e_n = span[1];
      q1 = span[2];
    }

    // Pass 1: tile[r][e - e_lo] = sum over i in row r's band of
    // Wv[o0 + r][i] * x[i][e]; elements past the row (a window's zero
    // taps may reach there) are zeros
    const int ngroups = e_n / kCpt;
    const int nchunks = max(1, (hi - lo + kBandChunk - 1) / kBandChunk);
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = lo + ci * kBandChunk;
      const int c1 = min(hi, c0 + kBandChunk);
      __syncthreads();  // the previous chunk's weights are no longer read
      for (int k = threadIdx.x; k < (c1 - c0) * TR; k += blockDim.x) {
        const int i = k / TR;
        const int o = o0 + (k - i * TR);
        w_s[k] = o < P.OH ? wv_b[(size_t)o * P.IH + c0 + i] : 0.0f;
      }
      __syncthreads();
      for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
        const int t0 = g * kCpt;  // the group's first column of the tile
        const int e0 = e_lo + t0;
        if (kStrips && e0 >= P.IW * NCH) {
          if (ci == 0)
#pragma unroll
            for (int r = 0; r < TR; ++r)
#pragma unroll
              for (int c = 0; c < kCpt; ++c) tile[(size_t)r * pitch + t0 + c] = 0.0f;
          continue;
        }
        float acc[TR][kCpt];
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < kCpt; ++c)
            acc[r][c] = ci == 0 ? 0.0f : tile[(size_t)r * pitch + t0 + c];
        Pass1<Tin, TR> body{acc, ring + threadIdx.x, (int)blockDim.x,
                            xb + (size_t)c0 * P.sh + e0, P.sh, w_s, c1 - c0};
        body.start();
        int i = c0, a = 0, nb = 0;
        while (i < c1) {
          while (nb < TR && rows_f[nb] <= i) ++nb;
          while (a < TR && rows_l[a] <= i) ++a;
          int nxt = c1;
          if (nb < TR) nxt = min(nxt, rows_f[nb]);
          if (a < TR) nxt = min(nxt, rows_l[a]);
          if (a < nb)
            dispatch_run<TR, 0, 1>(a, nb, body, i, nxt);
          else
            body.skip(i, nxt);  // a gap: no tile row reads these input rows
          i = nxt;
        }
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < kCpt; ++c) tile[(size_t)r * pitch + t0 + c] = acc[r][c];
      }
    }
    __syncthreads();

    // Pass 2: out[ch][o0 + r][p] = sum_t taps[p][t] *
    // tile[r][(start_p + t)*C + ch - e_lo]. One thread per output column p
    // takes every channel and every row of the tile, so each tap is loaded
    // once for NCH * TR sums. (Its pointers are made here, not before pass
    // 1, where they would hold registers through its loops.)
    const int32_t* st = P.start_h + (size_t)uh * P.OW;
    const int nr = min(TR, P.OH - o0);
    const float4* taps = reinterpret_cast<const float4*>(P.taps_h) +
                         (size_t)uh * (P.T / 4) * P.OW;
    Tout* out_b = static_cast<Tout*>(P.out) + (size_t)b * P.osb +
                  (size_t)o0 * P.OW;
    const int p_end = kStrips ? q1 : P.OW;
    for (int p = q + threadIdx.x; p < p_end; p += blockDim.x) {
      const float* t0 = tile + ((size_t)st[p] * NCH - e_lo);
      const float4* w4 = taps + p;  // step s at w4[s * OW]
      float acc[NCH][TR];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[ch][r] = 0.0f;
      // four taps from t on: start_p % 4 == 0 (compact_table) and e_lo a
      // whole load, so they are NCH aligned float4s of each tile row
      auto step = [&](const float4 w, int t) {
        const float wt[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          float v[4 * NCH];
          const float4* tv =
              reinterpret_cast<const float4*>(t0 + (size_t)r * pitch + t * NCH);
#pragma unroll
          for (int qq = 0; qq < NCH; ++qq) {
            const float4 f = tv[qq];
            v[4 * qq] = f.x;
            v[4 * qq + 1] = f.y;
            v[4 * qq + 2] = f.z;
            v[4 * qq + 3] = f.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              acc[ch][r] = fmaf(wt[k], v[k * NCH + ch], acc[ch][r]);
        }
      };
      for (int t = 0; t < P.T; t += 4) step(__ldg(w4 + (size_t)(t / 4) * P.OW), t);
      if constexpr (NCH == 4) {
        // the pixel's four bytes in one store: out is (B, OH, OW, 4), osb a
        // multiple of 4 (band_resize checks both)
        uint32_t* o = reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(P.out) +
                                                  (size_t)b * P.osb) +
                      (size_t)o0 * P.OW + p;
#pragma unroll
        for (int r = 0; r < TR; ++r)
          if (r < nr) {
            uint32_t px = 0;
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              px |= (uint32_t)quant_u8(acc[ch][r], P, L.centered) << (8 * ch);
            o[(size_t)r * P.OW] = px;
          }
      } else {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          Tout* o = out_b + (size_t)ch * P.osc + p;
#pragma unroll
          for (int r = 0; r < TR; ++r)
            if (r < nr) store_out(o + (size_t)r * P.OW, acc[ch][r], P, L.centered);
        }
      }
    }
    q = q1;
  } while (kStrips && q < q_end);
}

template <typename Tin>
size_t band_smem(int tr, int pitch, int threads) {
  return sizeof(float) * ((size_t)tr * pitch + (size_t)kBandChunk * tr) +
         sizeof(typename Vec<Tin>::type) * kSlots * threads;
}

// Input elements that the compact windows of sw neighbouring output
// columns of plane P cover, rounded out to whole loads, for a stack whose
// starts step by the plane's scale: the input columns an output column
// advances (IW / OW, or (T - 8) / 6 where the windows say more: a Lanczos
// window spans six of them), the window T, and slack for the rounding of
// starts to 4 and of both ends to loads. A strip whose windows need more
// (a stack of another kind) takes more spans (strip_span).
template <typename Tin>
int strip_pitch(const IkPlane& P, int sw) {
  constexpr int kCpt = Vec<Tin>::kCpt;
  const double step = std::max((double)P.IW / P.OW, (P.T - 8) / 6.0);
  const double cols = (sw - 1) * step + P.T + 8;
  const long long e = (long long)(cols * P.C + 0.999999);
  return (int)std::min<long long>((e + kCpt - 1) / kCpt * kCpt + kCpt,
                                   1 << 30);
}

template <typename Tin, typename Tout, int TR, int NCH>
int band_launch(IkBandLaunch& L, int nplanes, int B, size_t smem,
                cudaStream_t stream) {
  bool strips = false;
  for (int i = 0; i < kBandPlanes; ++i) {
    const int n = i < nplanes ? B * L.tiles[i] * L.strips[i] : 0;
    L.block0[i + 1] = L.block0[i] + n;
    strips |= i < nplanes && L.spans[i];
  }
  auto* kernel = strips ? band_resize_kernel<Tin, Tout, TR, NCH, true>
                        : band_resize_kernel<Tin, Tout, TR, NCH, false>;
  // always: past 48 KB of dynamic plus static shared memory a launch needs
  // it, and the static arrays are not in smem
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  IK_LAUNCH(kernel, dim3(L.block0[kBandPlanes]), dim3(band_threads<Tin, NCH>()), smem,
            stream)(L);
  return static_cast<int>(cudaGetLastError());
}

// Picks the tile height and each plane's strips: whole rows where every
// plane's rows fit (the tallest tile that leaves a full SM of threads,
// else the tallest that fits at all), else column strips (a plane whose
// rows fit stays whole): the tallest tile whose strips are at least
// kMinStrip columns wide at the preferred budget, then at the largest.
// A plane's `strip` asks for strips of that width. Returns the tile
// height, 0 when nothing fits.
constexpr int kMinStrip = 64;
template <typename Tin>
int band_geometry(IkBandLaunch& L, int nplanes, int threads) {
  constexpr int kCpt = Vec<Tin>::kCpt;
  bool asked = false;
  int max_pitch = 0;
  for (int i = 0; i < nplanes; ++i) {
    asked |= L.p[i].strip > 0 && L.p[i].strip < L.p[i].OW;
    max_pitch = std::max(max_pitch, L.p[i].IW * L.p[i].C);
  }
  auto whole = [&](int tr) {
    for (int i = 0; i < nplanes; ++i) {
      L.strips[i] = 1;
      L.sw[i] = L.p[i].OW;
      L.spans[i] = 0;
      L.pitch[i] = L.p[i].IW * L.p[i].C;
    }
    return tr;
  };
  if (!asked) {
    for (int tr = 8; tr >= 2; tr /= 2)
      if (band_smem<Tin>(tr, max_pitch, threads) <= band_preferred_smem(threads))
        return whole(tr);
    for (int tr = 8; tr >= 2; tr /= 2)
      if (band_smem<Tin>(tr, max_pitch, threads) <= kBandMaxSmem)
        return whole(tr);
  }
  const size_t budgets[2] = {band_preferred_smem(threads), kBandMaxSmem};
  for (int pass = 0; pass < 3; ++pass) {
    const size_t budget = budgets[pass == 0 ? 0 : 1];
    const int min_sw = pass < 2 ? kMinStrip : 1;
    for (int tr = 8; tr >= 2; tr /= 2) {
      const size_t fixed = band_smem<Tin>(tr, 0, threads);
      if (fixed >= budget) continue;
      const int cap = (int)((budget - fixed) / sizeof(float) / tr) / kCpt * kCpt;
      bool ok = true;
      for (int i = 0; i < nplanes && ok; ++i) {
        const IkPlane& P = L.p[i];
        int sw;
        if (P.strip > 0) {
          sw = std::min(P.strip, P.OW);
          ok = strip_pitch<Tin>(P, sw) <= cap;
        } else if (P.IW * P.C <= cap) {
          L.strips[i] = 1;  // this plane's rows fit whole
          L.sw[i] = P.OW;
          L.spans[i] = 0;
          L.pitch[i] = P.IW * P.C;
          continue;
        } else {
          // the widest strip whose windows fit: by halves over [1, OW]
          int a = 0, z = P.OW;
          while (a < z) {
            const int m = (a + z + 1) / 2;
            if (strip_pitch<Tin>(P, m) <= cap)
              a = m;
            else
              z = m - 1;
          }
          sw = a;
          ok = sw >= std::min(min_sw, P.OW) && sw > 0;
        }
        if (!ok) break;
        // equal strips: as many as sw needs, then as narrow as they allow
        L.strips[i] = (P.OW + sw - 1) / sw;
        L.sw[i] = (P.OW + L.strips[i] - 1) / L.strips[i];
        L.spans[i] = 1;
        L.pitch[i] = strip_pitch<Tin>(P, L.sw[i]);
      }
      if (ok) return tr;
    }
  }
  return 0;
}

// Checks the planes, picks the tile height and the strips, and launches;
// returns a cudaError_t. info, where given, gets the tile height and the
// most strips a plane's row tile took (0: every plane in whole rows).
template <typename Tin, typename Tout>
int band_resize(const IkPlane* planes, int nplanes, int B, int centered,
                void* stream, int* info) {
  constexpr int kCpt = Vec<Tin>::kCpt;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nplanes < 1 || nplanes > kBandPlanes || B <= 0) return bad;
  IkBandLaunch L{};
  const int nch = planes[0].C;  // every plane has as many channels
  for (int i = 0; i < nplanes; ++i) {
    const IkPlane& P = planes[i];
    if (P.IH <= 0 || P.IW <= 0 || P.OH <= 0 || P.OW <= 0 || P.U <= 0 ||
        P.U2 <= 0 || P.T <= 0 || P.T % 4 != 0 || P.T > P.IW ||
        P.strip < 0 || P.C != nch || (nch != 1 && nch != 3 && nch != 4) ||
        (nch == 4 && (P.osb % 4 != 0 ||
                      reinterpret_cast<uintptr_t>(P.out) % 4 != 0)) ||
        P.sb < 0 || P.sh < (long long)P.IW * P.C || P.sb % kCpt != 0 ||
        P.sh % kCpt != 0 || P.IW * P.C % kCpt != 0 ||
        reinterpret_cast<uintptr_t>(P.x) % (kCpt * sizeof(Tin)) != 0 ||
        reinterpret_cast<uintptr_t>(P.taps_h) % 16 != 0)
      return bad;
    L.p[i] = P;
  }
  for (int i = nplanes; i < kBandPlanes; ++i) L.p[i] = L.p[0];
  L.centered = centered;
  const int threads =
      nch == 1 ? band_threads<Tin, 1>() : band_threads<Tin, 3>();
  const int tr = band_geometry<Tin>(L, nplanes, threads);
  if (!tr) return bad;
  long long blocks = 0;
  int max_pitch = 0, most = 0;
  for (int i = 0; i < nplanes; ++i) {
    L.tiles[i] = (L.p[i].OH + tr - 1) / tr;
    blocks += (long long)B * L.tiles[i] * L.strips[i];
    max_pitch = std::max(max_pitch, L.pitch[i]);
    if (L.spans[i]) most = std::max(most, L.strips[i]);
  }
  if (blocks > 0x7fffffffLL) return bad;
  if (info) {
    info[0] = tr;
    info[1] = most;
  }
  const size_t smem = band_smem<Tin>(tr, max_pitch, threads);
  auto s = static_cast<cudaStream_t>(stream);
  if (nch != 1) {
    // interleaved RGB and RGBA rows are u8 in and out only
    if constexpr (sizeof(Tin) == 1 && sizeof(Tout) == 1) {
      if (nch == 4) {
        if (tr == 8) return band_launch<Tin, Tout, 8, 4>(L, nplanes, B, smem, s);
        if (tr == 4) return band_launch<Tin, Tout, 4, 4>(L, nplanes, B, smem, s);
        return band_launch<Tin, Tout, 2, 4>(L, nplanes, B, smem, s);
      }
      if (tr == 8) return band_launch<Tin, Tout, 8, 3>(L, nplanes, B, smem, s);
      if (tr == 4) return band_launch<Tin, Tout, 4, 3>(L, nplanes, B, smem, s);
      return band_launch<Tin, Tout, 2, 3>(L, nplanes, B, smem, s);
    }
    return bad;
  }
  if (tr == 8) return band_launch<Tin, Tout, 8, 1>(L, nplanes, B, smem, s);
  if (tr == 4) return band_launch<Tin, Tout, 4, 1>(L, nplanes, B, smem, s);
  return band_launch<Tin, Tout, 2, 1>(L, nplanes, B, smem, s);
}

}  // namespace
