// K1 on Hopper: the folded jpeg8 head, Y, Cb and Cr of a batch in one launch.
//
// Replaces imagekit_tpu/ops/pallas_jpeg8.py::_make_plane_kernel (the body
// launched by _folded_plane_pallas through pl.pallas_call) together with
// the int16 widen and escape scatter of its fronts (_decode_resize_i8_pallas,
// _transcode_i8_pallas). For each image b and plane:
//
//   out = sum_v ( sum_u Wv_f[vidx[b], u] @ (q[b, u*k+v] * C_uv) ) @ Wh_f[vidx[b], v]^T
//
// with C_uv the (rows, nblk) plane of coefficient (u, v): the i16 DC plane
// (u = v = 0) or plane u*k+v-1 of the planar i8 AC layout (column
// (u*k+v-1)*p), plus the escape residuals that land there. A second entry
// takes the int16 transport of an escape-dense image instead
// (imagekit_tpu/ops/dct.py::_folded_plane_i16): one (B, rows, pw) i16 array
// per plane, block-grouped (level u*k+v of block column c at c*k*k + u*k+v),
// no escapes; only the staging differs. Epilogues:
//   decode   : floor((out + 128) * scale + offset + 0.5) clipped to u8
//              (luma 219/255 and 16, chroma 224/255 and 128*(1-224/255)),
//              written into the packed (B, O*P + 2*Oc*Pc) u8 batch;
//   centered : clip(floor(out + 128 + 0.5), 0, 255) - 128 as i8, one
//              (B, O, P) plane each.
//
// What bounds it: the folded stacks are banded (Lanczos taps times the
// k-point IDCT basis): at the flagship k=2 bucket (1088x1920 -> 240x400) a
// luma output row has at most 5 nonzero block rows of 136 and a column at
// most 5 nonzero block columns of 240. Over the band a B=32 batch is about
// 0.19 GFLOP (3 us at 67 TFLOP/s fp32) for about 14 MB of levels, stacks
// and output (4.3 us at 3.35 TB/s): it is bound by bytes, and tensor cores
// would buy nothing. Design: one block per (image, plane, stripe of TO
// output rows), all three planes in one grid. The block takes its stripe's
// band (the union of its rows' [first, last) from the band table) and, for
// each u, stages the band's levels of the k planes (u, v) in shared memory
// as int32 (DC widened from i16, AC sign-extended from i8), scans the
// plane's escape list and adds each residual in its rows with a
// shared-memory atomicAdd (integer adds: exact and order-free), then runs
// pass 1 over the band only, dequantising each level as it is read
// (__fmul_rn(float(level), q), after the escapes, as the reference). The
// (k, nblk, TO) first pass stays in shared memory, in slabs of four output
// rows (a float4 per block column: conflict-free in both passes). Skipped
// terms are exact zeros, so over a band that fits the staging rows pass 1
// sums as the dense loop over all rows did (fmaf(0, x, t) == t for finite
// x); a taller band is walked in chunks, each chunk's sum added to the
// first pass (another fp32 order, within the parity band). Pass 2 gives
// one thread to each output column; it reads its column's band of Wh_f
// from global memory (L1/L2-resident) and sums in ascending (v, c) order,
// no butterfly; the u8/i8 stores are coalesced.
// All arithmetic is fp32 FMA; the epilogue keeps its additions and
// products apart (no contraction) to follow the reference's order.
//
// The source also compiles as plain C++ under a small shim (one thread per
// block) for the CPU tests: the launch goes through IK_LAUNCH and the
// dynamic shared memory through IK_DYN_SMEM, as in resize_band.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef IK_DYN_SMEM
#define IK_DYN_SMEM(type, name) extern __shared__ __align__(16) type name[]
#endif
#ifndef IK_LAUNCH
#define IK_LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<grid, block, smem, stream>>>
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 3;
constexpr size_t kPreferredSmem = 100 * 1024;  // two blocks per SM
constexpr size_t kMaxSmem = 222 * 1024;  // leaves room for the static arrays

// floats of the staged levels, rounded up so that the Wv_f stripe after
// them is 16-byte aligned for float4 reads
__host__ __device__ inline size_t levels_len(int r, int k, int nblk) {
  return ((size_t)k * r * nblk + 3) & ~(size_t)3;
}

struct Plane {
  const int16_t* dc;    // (B, rows, pw); the block-grouped levels when grouped
  const int8_t* ac;     // (B, rows, acw), plane j at column j * p
  const int32_t* eidx;  // (ne, 3): image, row, planar column
  const int32_t* eval;  // (ne,) residuals
  const float* wv;      // (U, k, O, rows)
  const float* wh;      // (U, k, P, nblk)
  const int32_t* bv;    // (U, O, 2) [first, last) rows of each output row
  const int32_t* bh;    // (U, P, 2) [first, last) columns of each column
  uint8_t* out;         // image b's (O, P) plane at out + b * out_stride
  long long out_stride;
  int rows, pw, acw, p, nblk, O, P, ne, qoff, stripes;
  float scale, offset;
};

struct Args {
  Plane pl[kPlanes];
  const float* qt;      // (B, 128) natural order: luma at 0, chroma at 64
  const int32_t* vidx;  // (B,)
  int U, k, centered, R;
  int grouped;  // the int16 transport: dc holds every level, block-grouped
};

size_t smem_bytes(int to, int r, int k, int nblk) {
  return sizeof(float) * (levels_len(r, k, nblk) + (size_t)r * to +
                          (size_t)k * to * nblk);
}

// the most staging rows that keep a stripe of ``to`` rows within ``budget``
int rows_that_fit(int to, int k, int nblk, size_t budget) {
  if (smem_bytes(to, 0, k, nblk) >= budget) return 0;
  int r = static_cast<int>((budget - smem_bytes(to, 0, k, nblk)) /
                           (sizeof(float) * ((size_t)k * nblk + to)));
  while (r > 0 && smem_bytes(to, r, k, nblk) > budget) --r;
  return r;
}

__device__ __forceinline__ float decode_epilogue(float acc, float scale,
                                                 float offset) {
  float y = __fadd_rn(__fmul_rn(__fadd_rn(acc, 128.0f), scale), offset);
  y = floorf(__fadd_rn(y, 0.5f));
  return fminf(fmaxf(y, 0.0f), 255.0f);
}

__device__ __forceinline__ float centered_epilogue(float acc) {
  float y = floorf(__fadd_rn(__fadd_rn(acc, 128.0f), 0.5f));
  return fminf(fmaxf(y, 0.0f), 255.0f) - 128.0f;
}

// The block's global loads are few and small: every loop over global
// memory below issues a batch of independent loads (kBatch per thread)
// before it uses any of them.
constexpr int kBatch = 4;
constexpr int kEscBatch = 8;
constexpr int kTaps = 8;
// escapes of one stripe kept in shared memory after a single scan of the
// list; a stripe with more rescans the list for each u and chunk
constexpr int kEscCap = 512;

// four neighbouring levels of one coefficient plane row, widened to int
__device__ __forceinline__ int4 load_levels4(const int16_t* dc_row,
                                             const int8_t* ac_row, int c) {
  if (dc_row != nullptr) {
    const short4 v = __ldg(reinterpret_cast<const short4*>(dc_row + c));
    return make_int4(v.x, v.y, v.z, v.w);
  }
  const char4 v = __ldg(reinterpret_cast<const char4*>(ac_row + c));
  return make_int4(v.x, v.y, v.z, v.w);
}

// The first pass keeps plane v's (nblk, TO) values as TO/4 slabs of
// (nblk, 4) floats (TO slabs of (nblk, 1) where TO is not a multiple of 4):
// block column c's values sit at c in every slab, so threads on neighbouring
// columns touch neighbouring float4s and neither pass's shared-memory
// accesses conflict. These read and write column c of plane base p.
__device__ __forceinline__ float4 slab4(const float* p, int c, int nblk, int m) {
  return reinterpret_cast<const float4*>(p)[(size_t)m * nblk + c];
}

template <int TO>
__device__ __forceinline__ void load_row(float (&t)[TO], const float* p, int c,
                                         int nblk) {
  if constexpr (TO % 4 == 0) {
#pragma unroll
    for (int m = 0; m < TO / 4; ++m) {
      const float4 q = slab4(p, c, nblk, m);
      t[4 * m + 0] = q.x;
      t[4 * m + 1] = q.y;
      t[4 * m + 2] = q.z;
      t[4 * m + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int o = 0; o < TO; ++o) t[o] = p[(size_t)o * nblk + c];
  }
}

template <int TO>
__device__ __forceinline__ void store_row(float* p, int c, int nblk,
                                          const float (&t)[TO]) {
  if constexpr (TO % 4 == 0) {
#pragma unroll
    for (int m = 0; m < TO / 4; ++m)
      reinterpret_cast<float4*>(p)[(size_t)m * nblk + c] =
          make_float4(t[4 * m + 0], t[4 * m + 1], t[4 * m + 2], t[4 * m + 3]);
  } else {
#pragma unroll
    for (int o = 0; o < TO; ++o) p[(size_t)o * nblk + c] = t[o];
  }
}

// acc[o] += pass1[o][c] * w over the TO rows of block column c
template <int TO>
__device__ __forceinline__ void fma_row(float (&acc)[TO], const float* p, int c,
                                        int nblk, float w) {
  if constexpr (TO % 4 == 0) {
#pragma unroll
    for (int m = 0; m < TO / 4; ++m) {
      const float4 q = slab4(p, c, nblk, m);
      acc[4 * m + 0] = fmaf(q.x, w, acc[4 * m + 0]);
      acc[4 * m + 1] = fmaf(q.y, w, acc[4 * m + 1]);
      acc[4 * m + 2] = fmaf(q.z, w, acc[4 * m + 2]);
      acc[4 * m + 3] = fmaf(q.w, w, acc[4 * m + 3]);
    }
  } else {
#pragma unroll
    for (int o = 0; o < TO; ++o)
      acc[o] = fmaf(p[(size_t)o * nblk + c], w, acc[o]);
  }
}

template <int TO>
__global__ void __launch_bounds__(kThreads, 2)
folded_planes_kernel(const Args a) {
  IK_DYN_SMEM(float, smem);
  __shared__ int band[2];
  __shared__ int n_esc;
  __shared__ int esc_pos[kEscCap];  // (row - lo) * acw + planar column
  __shared__ int esc_val[kEscCap];

  // blockIdx.x runs over the stripes of Y, then Cb, then Cr
  int s = blockIdx.x;
  int pi = 0;
  if (s >= a.pl[0].stripes) {
    s -= a.pl[0].stripes;
    pi = 1;
    if (s >= a.pl[1].stripes) {
      s -= a.pl[1].stripes;
      pi = 2;
    }
  }
  const Plane pl = pi == 0 ? a.pl[0] : (pi == 1 ? a.pl[1] : a.pl[2]);
  const int b = blockIdx.y;
  const int k = a.k;
  const int R = a.R;
  const int nblk = pl.nblk;
  const int rows = pl.rows;
  const int o0 = s * TO;
  // per-image weight slab (the analogue of the Pallas scalar prefetch);
  // an index outside the stack is clamped, as a JAX gather clamps it
  const int ui = min(max(__ldg(a.vidx + b), 0), a.U - 1);

  int* xs = reinterpret_cast<int*>(smem);         // [k][R][nblk] levels
  float* wv_s = smem + levels_len(R, k, nblk);    // [R][TO]
  float* pv_s = wv_s + (size_t)R * TO;            // [k] slabs, pass 1

  // the stripe's band: the union of its rows' runs, reduced in warp 0
  if (threadIdx.x < 32) {
    int lo = rows, hi = 0;
    const int lanes = min(32, static_cast<int>(blockDim.x));
    for (int o = threadIdx.x; o < TO && o0 + o < pl.O; o += lanes) {
      const int32_t* e = pl.bv + ((size_t)ui * pl.O + o0 + o) * 2;
      const int f = max(__ldg(e), 0);
      const int l = min(__ldg(e + 1), rows);
      if (f < l) {
        lo = min(lo, f);
        hi = max(hi, l);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (threadIdx.x == 0) {
      band[0] = lo;
      band[1] = hi;
      n_esc = 0;
    }
  }
  for (int i = threadIdx.x; i < k * TO * nblk; i += blockDim.x) pv_s[i] = 0.0f;
  __syncthreads();
  const int lo = band[0];
  const int hi = band[1];

  // one scan of the escape list for the residuals in the stripe's band
  for (int base = threadIdx.x; base < pl.ne; base += kEscBatch * blockDim.x) {
    int img[kEscBatch], erow[kEscBatch], col[kEscBatch], val[kEscBatch];
#pragma unroll
    for (int j = 0; j < kEscBatch; ++j) {
      const int e = base + j * blockDim.x;
      img[j] = -1;
      if (e < pl.ne) {
        img[j] = __ldg(pl.eidx + (size_t)e * 3);
        erow[j] = __ldg(pl.eidx + (size_t)e * 3 + 1);
        col[j] = __ldg(pl.eidx + (size_t)e * 3 + 2);
        val[j] = __ldg(pl.eval + e);
      }
    }
#pragma unroll
    for (int j = 0; j < kEscBatch; ++j) {
      if (img[j] != b || erow[j] < lo || erow[j] >= hi || col[j] < 0 ||
          col[j] >= pl.acw || col[j] % pl.p >= nblk)
        continue;
      const int slot = atomicAdd(&n_esc, 1);
      if (slot < kEscCap) {
        esc_pos[slot] = (erow[j] - lo) * pl.acw + col[j];
        esc_val[slot] = val[j];
      }
    }
  }
  __syncthreads();
  const int n_kept = n_esc;

  const float kq = 0.125f * k;  // k/8, exact
  const float* qt_b = a.qt + (size_t)b * 128 + pl.qoff;
  const int16_t* dc_b = pl.dc + (size_t)b * rows * pl.pw;
  const int8_t* ac_b = pl.ac + (size_t)b * rows * pl.acw;
  const float* wv_b = pl.wv + (size_t)ui * k * pl.O * rows;
  const int nvec = (nblk + 3) / 4;  // 4-level groups of a plane row
  // Staging item i = t * nvec + g is group g of staged row t = v * nr + r.
  // A thread's items lie blockDim.x apart: it walks them by adding
  // (dt rows, dg groups) with a carry, not by dividing each i.
  const int dt = blockDim.x / nvec;
  const int dg = blockDim.x - dt * nvec;
  const int t_first = threadIdx.x / nvec;
  const int g_first = threadIdx.x - t_first * nvec;
  const bool vec_rows = (nblk & 3) == 0;  // staged rows start on int4s

  for (int u = 0; u < k; ++u) {
    for (int r0 = lo; r0 < hi; r0 += R) {
      const int nr = min(R, hi - r0);
      // stage the levels of planes (u, v), v < k, rows r0 .. r0 + nr
      if (a.grouped) {
        // int16 transport: block c's levels (u, 0..k-1) are neighbours
        const int nk = k * k;
        for (int i = threadIdx.x; i < nr * nblk * k; i += blockDim.x) {
          const int v = i % k;
          const int rc = i / k;
          const int c = rc % nblk;
          const int r = rc / nblk;
          xs[(v * R + r) * nblk + c] =
              __ldg(dc_b + (size_t)(r0 + r) * pl.pw + c * nk + u * k + v);
        }
      }
      const int ngroups = a.grouped ? 0 : k * nr * nvec;
      const int dv = dt / nr;
      const int dr = dt - dv * nr;
      int v = t_first / nr;
      int r = t_first - v * nr;
      int g = g_first;
      for (int base = threadIdx.x; base < ngroups; base += kBatch * blockDim.x) {
        int4 lv[kBatch];
        int off[kBatch];  // (v * R + r) * nblk + 4 * g in the staged rows
        int c4[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (base + j * blockDim.x < ngroups) {
            const int lin = u * k + v;
            const size_t row = (size_t)(r0 + r);
            lv[j] = lin == 0
                        ? load_levels4(dc_b + row * pl.pw, nullptr, 4 * g)
                        : load_levels4(nullptr, ac_b + row * pl.acw + (size_t)(lin - 1) * pl.p, 4 * g);
            off[j] = (v * R + r) * nblk + 4 * g;
            c4[j] = 4 * g;
          }
          g += dg;
          r += dr;
          v += dv;
          if (g >= nvec) {
            g -= nvec;
            ++r;
          }
          if (r >= nr) {
            r -= nr;
            ++v;
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (base + j * blockDim.x >= ngroups) continue;
          int* dst = xs + off[j];
          if (vec_rows && c4[j] + 3 < nblk) {
            *reinterpret_cast<int4*>(dst) = lv[j];
          } else {
            dst[0] = lv[j].x;
            if (c4[j] + 1 < nblk) dst[1] = lv[j].y;
            if (c4[j] + 2 < nblk) dst[2] = lv[j].z;
            if (c4[j] + 3 < nblk) dst[3] = lv[j].w;
          }
        }
      }
      // and the Wv_f stripe of these rows, as [r][o]
      for (int base = threadIdx.x; base < nr * TO; base += kBatch * blockDim.x) {
        float w[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = base + j * blockDim.x;
          const int og = o0 + i / nr;
          w[j] = i < nr * TO && og < pl.O
                     ? __ldg(wv_b + ((size_t)u * pl.O + og) * rows + r0 + i % nr)
                     : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = base + j * blockDim.x;
          if (i < nr * TO) wv_s[(i % nr) * TO + i / nr] = w[j];
        }
      }
      __syncthreads();
      // escape residuals that land in these rows and planes
      if (n_kept <= kEscCap) {
        for (int i = threadIdx.x; i < n_kept; i += blockDim.x) {
          const int r = esc_pos[i] / pl.acw + lo - r0;
          const int col = esc_pos[i] % pl.acw;
          const int lin = col / pl.p + 1;
          if (r < 0 || r >= nr || lin / k != u) continue;
          atomicAdd(&xs[((lin - u * k) * R + r) * nblk + col % pl.p], esc_val[i]);
        }
      } else {
        for (int base = threadIdx.x; base < pl.ne; base += kEscBatch * blockDim.x) {
          int img[kEscBatch], erow[kEscBatch], col[kEscBatch], val[kEscBatch];
#pragma unroll
          for (int j = 0; j < kEscBatch; ++j) {
            const int e = base + j * blockDim.x;
            img[j] = -1;
            if (e < pl.ne) {
              img[j] = __ldg(pl.eidx + (size_t)e * 3);
              erow[j] = __ldg(pl.eidx + (size_t)e * 3 + 1);
              col[j] = __ldg(pl.eidx + (size_t)e * 3 + 2);
              val[j] = __ldg(pl.eval + e);
            }
          }
#pragma unroll
          for (int j = 0; j < kEscBatch; ++j) {
            if (img[j] != b) continue;
            const int r = erow[j] - r0;
            if (r < 0 || r >= nr || col[j] < 0 || col[j] >= pl.acw) continue;
            const int jp = col[j] / pl.p;
            const int c = col[j] - jp * pl.p;
            const int lin = jp + 1;
            if (lin / k != u || c >= nblk) continue;
            atomicAdd(&xs[((lin - u * k) * R + r) * nblk + c], val[j]);
          }
        }
      }
      __syncthreads();
      // pass 1: Pv[v][o][c] += sum_r Wv[u][o][r] * (q_uv * C_uv[r][c])
      for (int item = threadIdx.x; item < k * nblk; item += blockDim.x) {
        const int v = item / nblk;
        const int c = item - v * nblk;
        const float q = __fmul_rn(__ldg(qt_b + u * 8 + v), kq);
        float t[TO];
#pragma unroll
        for (int o = 0; o < TO; ++o) t[o] = 0.0f;
        const int* xp = xs + (size_t)v * R * nblk + c;
        for (int r = 0; r < nr; ++r) {
          const float x = __fmul_rn(static_cast<float>(xp[(size_t)r * nblk]), q);
          if constexpr (TO % 4 == 0) {
            const float4* w4 = reinterpret_cast<const float4*>(wv_s + r * TO);
#pragma unroll
            for (int o4 = 0; o4 < TO / 4; ++o4) {
              const float4 w = w4[o4];
              t[4 * o4 + 0] = fmaf(w.x, x, t[4 * o4 + 0]);
              t[4 * o4 + 1] = fmaf(w.y, x, t[4 * o4 + 1]);
              t[4 * o4 + 2] = fmaf(w.z, x, t[4 * o4 + 2]);
              t[4 * o4 + 3] = fmaf(w.w, x, t[4 * o4 + 3]);
            }
          } else {
#pragma unroll
            for (int o = 0; o < TO; ++o) t[o] = fmaf(wv_s[r * TO + o], x, t[o]);
          }
        }
        float* pv = pv_s + (size_t)v * nblk * TO;
        float s[TO];
        load_row<TO>(s, pv, c, nblk);
#pragma unroll
        for (int o = 0; o < TO; ++o) s[o] += t[o];
        store_row<TO>(pv, c, nblk, s);
      }
      __syncthreads();
    }
  }

  // Pass 2: out[o][col] = sum_v sum_c Pv[v][o][c] * Wh_f[ui][v][col][c]
  // over the column's band, one thread per output column; the first kTaps
  // taps of two planes are loaded together before they are used.
  const float* wh_b = pl.wh + (size_t)ui * k * pl.P * nblk;
  const int32_t* bh_b = pl.bh + (size_t)ui * pl.P * 2;
  const int n_o = min(TO, pl.O - o0);
  uint8_t* out_b = pl.out + (size_t)b * pl.out_stride + (size_t)o0 * pl.P;
  for (int col = threadIdx.x; col < pl.P; col += blockDim.x) {
    const int f = max(__ldg(bh_b + 2 * col), 0);
    const int l = min(__ldg(bh_b + 2 * col + 1), nblk);
    float acc[TO];
#pragma unroll
    for (int o = 0; o < TO; ++o) acc[o] = 0.0f;
    for (int v0 = 0; v0 < k; v0 += 2) {
      // the first kTaps taps of planes v0 and v0 + 1, loaded together
      float w[2][kTaps];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* wr = wh_b + ((size_t)(v0 + h) * pl.P + col) * nblk;
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          w[h][j] = v0 + h < k && f + j < l ? __ldg(wr + f + j) : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (v0 + h >= k) break;
        const float* pv = pv_s + (size_t)(v0 + h) * nblk * TO;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          if (f + j < l) fma_row<TO>(acc, pv, f + j, nblk, w[h][j]);
        }
        // a band wider than kTaps: the rest, in order
        const float* wr = wh_b + ((size_t)(v0 + h) * pl.P + col) * nblk;
        for (int c = f + kTaps; c < l; ++c) {
          const float wc = __ldg(wr + c);
          fma_row<TO>(acc, pv, c, nblk, wc);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < TO; ++o) {
      if (o < n_o) {
        const uint8_t byte =
            a.centered
                ? static_cast<uint8_t>(static_cast<int8_t>(centered_epilogue(acc[o])))
                : static_cast<uint8_t>(decode_epilogue(acc[o], pl.scale, pl.offset));
        out_b[(size_t)o * pl.P + col] = byte;
      }
    }
  }
}

template <int TO>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        folded_planes_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.pl[0].stripes + a.pl[1].stripes + a.pl[2].stripes, B);
  IK_LAUNCH(folded_planes_kernel<TO>, grid, dim3(kThreads), smem, stream)(a);
  return cudaGetLastError();
}

// Picks the stripe height and the staging rows, and launches.
cudaError_t launch_planes(Args& a, int B, int rows_max, int nblk_max,
                          void* stream) {
  const int k = a.k;
  // The largest stripe whose staging rows fit two blocks per SM, with at
  // least 8 rows (or all of them); else one output row per block and the
  // whole of the shared memory.
  const int r_min = rows_max < 8 ? rows_max : 8;
  int to = 0, R = 0;
  for (int cand = 16; cand >= 1 && to == 0; cand /= 2) {
    const int fit = rows_that_fit(cand, k, nblk_max, kPreferredSmem);
    if (fit >= r_min) {
      to = cand;
      R = fit < rows_max ? fit : rows_max;
    }
  }
  if (to == 0) {
    to = 1;
    const int fit = rows_that_fit(1, k, nblk_max, kMaxSmem);
    if (fit < 1) return cudaErrorInvalidValue;
    R = fit < rows_max ? fit : rows_max;
  }
  a.R = R;
  for (int i = 0; i < kPlanes; ++i) a.pl[i].stripes = (a.pl[i].O + to - 1) / to;
  const size_t smem = smem_bytes(to, R, k, nblk_max);
  auto s = static_cast<cudaStream_t>(stream);
  switch (to) {
    case 16: return launch<16>(a, B, smem, s);
    case 8: return launch<8>(a, B, smem, s);
    case 4: return launch<4>(a, B, smem, s);
    case 2: return launch<2>(a, B, smem, s);
    default: return launch<1>(a, B, smem, s);
  }
}

void set_epilogue(Plane& pl, bool luma) {
  pl.qoff = luma ? 0 : 64;
  pl.scale = luma ? static_cast<float>(219.0 / 255.0)
                  : static_cast<float>(224.0 / 255.0);
  pl.offset = luma ? 16.0f : static_cast<float>(128.0 * (1.0 - 224.0 / 255.0));
}

}  // namespace

// ptrs: per plane (Y, Cb, Cr) nine device pointers: dc (B, rows, pw) i16,
// ac (B, rows, acw) i8, escape idx (ne, 3) i32, escape val (ne,) i32,
// wv (U, k, O, rows) f32, wh (U, k, P, nblk) f32, band tables (U, O, 2) and
// (U, P, 2) i32, out (u8, or i8 when centered).
// dims: per plane nine integers: rows, pw, acw, nblk, O, P, ne, luma,
// out_stride (bytes between two images' planes).
// qt (B, 128) f32, vidx (B,) i32. All contiguous.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ik_jpeg8_folded_planes(const void* const* ptrs,
                                      const long long* dims, const void* qt,
                                      const void* vidx, int B, int U, int k,
                                      int centered, void* stream) {
  if (B <= 0 || B > 65535 || U <= 0 || k < 2 || k > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qt = static_cast<const float*>(qt);
  a.vidx = static_cast<const int32_t*>(vidx);
  a.U = U;
  a.k = k;
  a.centered = centered;
  a.grouped = 0;
  const int na = k * k - 1;
  int rows_max = 0, nblk_max = 0;
  for (int i = 0; i < kPlanes; ++i) {
    const void* const* pp = ptrs + 9 * i;
    const long long* d = dims + 9 * i;
    Plane& pl = a.pl[i];
    pl.dc = static_cast<const int16_t*>(pp[0]);
    pl.ac = static_cast<const int8_t*>(pp[1]);
    pl.eidx = static_cast<const int32_t*>(pp[2]);
    pl.eval = static_cast<const int32_t*>(pp[3]);
    pl.wv = static_cast<const float*>(pp[4]);
    pl.wh = static_cast<const float*>(pp[5]);
    pl.bv = static_cast<const int32_t*>(pp[6]);
    pl.bh = static_cast<const int32_t*>(pp[7]);
    pl.out = static_cast<uint8_t*>(const_cast<void*>(pp[8]));
    pl.rows = static_cast<int>(d[0]);
    pl.pw = static_cast<int>(d[1]);
    pl.acw = static_cast<int>(d[2]);
    pl.nblk = static_cast<int>(d[3]);
    pl.O = static_cast<int>(d[4]);
    pl.P = static_cast<int>(d[5]);
    pl.ne = static_cast<int>(d[6]);
    pl.out_stride = d[8];
    if (pl.rows <= 0 || pl.nblk <= 0 || pl.O <= 0 || pl.P <= 0 || pl.ne < 0 ||
        pl.acw <= 0 || pl.acw % na != 0 || pl.nblk > pl.pw ||
        pl.nblk > pl.acw / na || pl.pw % 4 != 0 || (pl.acw / na) % 4 != 0 ||
        pl.out_stride < (long long)pl.O * pl.P)
      return static_cast<int>(cudaErrorInvalidValue);
    pl.p = pl.acw / na;
    set_epilogue(pl, d[7] != 0);
    rows_max = pl.rows > rows_max ? pl.rows : rows_max;
    nblk_max = pl.nblk > nblk_max ? pl.nblk : nblk_max;
  }
  return static_cast<int>(launch_planes(a, B, rows_max, nblk_max, stream));
}

// The int16 transport. ptrs: per plane (Y, Cb, Cr) six device pointers:
// levels (B, rows, pw) i16, block-grouped (level lin of block column c at
// c*k*k + lin), wv, wh, the two band tables, out. dims: per plane seven
// integers: rows, pw, nblk, O, P, luma, out_stride. The rest as above.
extern "C" int ik_jpeg8_folded_planes_i16(const void* const* ptrs,
                                          const long long* dims,
                                          const void* qt, const void* vidx,
                                          int B, int U, int k, int centered,
                                          void* stream) {
  if (B <= 0 || B > 65535 || U <= 0 || k < 2 || k > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qt = static_cast<const float*>(qt);
  a.vidx = static_cast<const int32_t*>(vidx);
  a.U = U;
  a.k = k;
  a.centered = centered;
  a.grouped = 1;
  int rows_max = 0, nblk_max = 0;
  for (int i = 0; i < kPlanes; ++i) {
    const void* const* pp = ptrs + 6 * i;
    const long long* d = dims + 7 * i;
    Plane& pl = a.pl[i];
    pl.dc = static_cast<const int16_t*>(pp[0]);
    pl.ac = nullptr;
    pl.eidx = nullptr;
    pl.eval = nullptr;
    pl.wv = static_cast<const float*>(pp[1]);
    pl.wh = static_cast<const float*>(pp[2]);
    pl.bv = static_cast<const int32_t*>(pp[3]);
    pl.bh = static_cast<const int32_t*>(pp[4]);
    pl.out = static_cast<uint8_t*>(const_cast<void*>(pp[5]));
    pl.rows = static_cast<int>(d[0]);
    pl.pw = static_cast<int>(d[1]);
    pl.nblk = static_cast<int>(d[2]);
    pl.O = static_cast<int>(d[3]);
    pl.P = static_cast<int>(d[4]);
    pl.out_stride = d[6];
    pl.acw = 0;
    pl.p = 0;
    pl.ne = 0;
    if (pl.rows <= 0 || pl.nblk <= 0 || pl.O <= 0 || pl.P <= 0 ||
        (long long)pl.nblk * k * k > pl.pw ||
        pl.out_stride < (long long)pl.O * pl.P)
      return static_cast<int>(cudaErrorInvalidValue);
    set_epilogue(pl, d[5] != 0);
    rows_max = pl.rows > rows_max ? pl.rows : rows_max;
    nblk_max = pl.nblk > nblk_max ? pl.nblk : nblk_max;
  }
  return static_cast<int>(launch_planes(a, B, rows_max, nblk_max, stream));
}
