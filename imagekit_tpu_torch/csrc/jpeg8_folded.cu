// K1 on Hopper: the folded jpeg8 decode head for one plane.
//
// Replaces imagekit_tpu/ops/pallas_jpeg8.py::_make_plane_kernel (the body
// launched by _folded_plane_pallas through pl.pallas_call). Per image b:
//
//   out = sum_v ( sum_u Wv_f[vidx[b], u] @ (q[b, u*k+v] * C_uv) ) @ Wh_f[vidx[b], v]^T
//
// with C_uv the (rows, nblk) plane of coefficient (u, v) read from the i16
// DC plane (u = v = 0) or the planar i16 AC layout (plane u*k+v-1 starts at
// column (u*k+v-1)*p). Epilogues:
//   decode   : floor((out + 128) * scale + offset + 0.5) clipped to u8
//              (luma 219/255 and 16, chroma 224/255 and 128*(1-224/255));
//   centered : clip(floor(out + 128 + 0.5), 0, 255) - 128 as i8.
//
// What bounds it: at the flagship k=2 shape (luma rows 136, nblk 240, out
// 240x400) an image costs ~155 MFLOP of fp32 FMA for ~261 KB read and 96 KB
// written, so it is bound by fp32 issue rate, not by device memory.
// Design: one block per (image, stripe of TO output rows). The block reads
// vidx[b] itself, stages its stripe of Wv_f in shared memory as [u][r][o]
// (one float4 broadcast feeds four FMAs), widens the i16 levels to f32 in
// registers, and keeps the (k, TO, nblk) first-pass stripe in shared memory,
// so the (O, nblk) intermediate never reaches device memory and nothing is
// recomputed. The second pass gives one warp to each output column: lanes
// stride the contraction axis (coalesced Wh_f rows) and a butterfly reduces
// the TO partial sums. The u8/i8 stripe is staged in shared memory and
// written back contiguously. All arithmetic is fp32 FMA; rounding is
// floor(x + 0.5) (half up), as in the reference, with the epilogue's
// additions and products kept apart (no contraction) to follow its order.
// Tensor cores (wgmma), TMA and fusing the widen/escape scatter are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kPreferredSmem = 100 * 1024;  // two blocks per SM
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int to, int k, int rows, int nblk, int P) {
  return sizeof(float) * ((size_t)k * rows * to + (size_t)k * to * nblk) +
         (size_t)to * P;
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

template <int TO>
__global__ void __launch_bounds__(kThreads)
folded_plane_kernel(const int16_t* __restrict__ dc,
                    const int16_t* __restrict__ ac,
                    const float* __restrict__ qt,
                    const float* __restrict__ wv,
                    const float* __restrict__ wh,
                    const int32_t* __restrict__ vidx,
                    uint8_t* __restrict__ out,
                    int rows, int pw, int acw, int p, int nblk, int O, int P,
                    int U, int k, float scale, float offset, int centered) {
  extern __shared__ __align__(16) float smem[];
  float* wv_s = smem;                       // [k][rows][TO]
  float* pv_s = wv_s + (size_t)k * rows * TO;  // [k][TO][nblk]
  uint8_t* out_s = reinterpret_cast<uint8_t*>(pv_s + (size_t)k * TO * nblk);

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TO;
  const int nk = k * k;
  // per-image weight slab (the analogue of the Pallas scalar prefetch);
  // an index outside the stack is clamped, as a JAX gather clamps it
  const int ui = min(max(vidx[b], 0), U - 1);

  // Stage the stripe Wv_f[ui][u][o0:o0+TO][:rows] as [u][r][o].
  const float* wv_b = wv + (size_t)ui * k * O * rows;
  for (int i = threadIdx.x; i < k * TO * rows; i += blockDim.x) {
    const int r = i % rows;
    const int t = i / rows;
    const int o = t % TO;
    const int u = t / TO;
    const int og = o0 + o;
    wv_s[((size_t)u * rows + r) * TO + o] =
        og < O ? wv_b[((size_t)u * O + og) * rows + r] : 0.0f;
  }
  __syncthreads();

  // Pass 1: Pv[v][o][c] = sum_u sum_r Wv[u][o][r] * (q_uv * C_uv[r][c]).
  const int16_t* dc_b = dc + (size_t)b * rows * pw;
  const int16_t* ac_b = ac + (size_t)b * rows * acw;
  const float* qt_b = qt + (size_t)b * nk;
  for (int item = threadIdx.x; item < k * nblk; item += blockDim.x) {
    const int v = item / nblk;
    const int c = item - v * nblk;
    float acc[TO];
#pragma unroll
    for (int o = 0; o < TO; ++o) acc[o] = 0.0f;
    for (int u = 0; u < k; ++u) {
      const int lin = u * k + v;
      const float q = qt_b[lin];
      const int16_t* src = lin == 0 ? dc_b + c : ac_b + (size_t)(lin - 1) * p + c;
      const int stride = lin == 0 ? pw : acw;
      const float4* w4 = reinterpret_cast<const float4*>(wv_s + (size_t)u * rows * TO);
      float t[TO];
#pragma unroll
      for (int o = 0; o < TO; ++o) t[o] = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float x = __fmul_rn(static_cast<float>(src[(size_t)r * stride]), q);
#pragma unroll
        for (int o4 = 0; o4 < TO / 4; ++o4) {
          const float4 w = w4[r * (TO / 4) + o4];
          t[4 * o4 + 0] = fmaf(w.x, x, t[4 * o4 + 0]);
          t[4 * o4 + 1] = fmaf(w.y, x, t[4 * o4 + 1]);
          t[4 * o4 + 2] = fmaf(w.z, x, t[4 * o4 + 2]);
          t[4 * o4 + 3] = fmaf(w.w, x, t[4 * o4 + 3]);
        }
      }
#pragma unroll
      for (int o = 0; o < TO; ++o) acc[o] += t[o];
    }
#pragma unroll
    for (int o = 0; o < TO; ++o) pv_s[((size_t)v * TO + o) * nblk + c] = acc[o];
  }
  __syncthreads();

  // Pass 2: out[o][col] = sum_v sum_c Pv[v][o][c] * Wh_f[ui][v][col][c],
  // one warp per output column.
  const float* wh_b = wh + (size_t)ui * k * P * nblk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int col = warp; col < P; col += nwarps) {
    float acc[TO];
#pragma unroll
    for (int o = 0; o < TO; ++o) acc[o] = 0.0f;
    for (int v = 0; v < k; ++v) {
      const float* whr = wh_b + ((size_t)v * P + col) * nblk;
      const float* pv = pv_s + (size_t)v * TO * nblk;
      for (int c = lane; c < nblk; c += 32) {
        const float w = whr[c];
#pragma unroll
        for (int o = 0; o < TO; ++o) acc[o] = fmaf(pv[(size_t)o * nblk + c], w, acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < TO; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
    }
    if (lane < TO) {
      float val = 0.0f;
#pragma unroll
      for (int o = 0; o < TO; ++o)
        if (o == lane) val = acc[o];
      uint8_t byte;
      if (centered) {
        byte = static_cast<uint8_t>(static_cast<int8_t>(centered_epilogue(val)));
      } else {
        byte = static_cast<uint8_t>(decode_epilogue(val, scale, offset));
      }
      out_s[(size_t)lane * P + col] = byte;
    }
  }
  __syncthreads();

  // Rows o0 .. o0+n of the (O, P) plane are contiguous in device memory.
  const int n = min(TO, O - o0);
  uint8_t* out_b = out + ((size_t)b * O + o0) * P;
  for (int i = threadIdx.x; i < n * P; i += blockDim.x) out_b[i] = out_s[i];
}

template <int TO>
cudaError_t launch(const int16_t* dc, const int16_t* ac, const float* qt,
                   const float* wv, const float* wh, const int32_t* vidx,
                   uint8_t* out, int B, int rows, int pw, int acw, int p,
                   int nblk, int O, int P, int U, int k, float scale,
                   float offset, int centered, cudaStream_t stream) {
  const size_t smem = smem_bytes(TO, k, rows, nblk, P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        folded_plane_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((O + TO - 1) / TO, B);
  folded_plane_kernel<TO><<<grid, kThreads, smem, stream>>>(
      dc, ac, qt, wv, wh, vidx, out, rows, pw, acw, p, nblk, O, P, U, k,
      scale, offset, centered);
  return cudaGetLastError();
}

}  // namespace

// Shapes: dc (B, rows, pw) i16; ac (B, rows, acw) i16 with acw = (k*k-1)*p;
// qt (B, k*k) f32; wv (U, k, O, rows) f32; wh (U, k, P, nblk) f32;
// vidx (B,) i32; out (B, O, P) u8 (i8 when centered). All contiguous.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ik_jpeg8_folded_plane(const void* dc, const void* ac,
                                     const void* qt, const void* wv,
                                     const void* wh, const void* vidx,
                                     void* out, int B, int rows, int pw,
                                     int acw, int nblk, int O, int P, int U,
                                     int k, int luma, int centered,
                                     void* stream) {
  if (B <= 0 || rows <= 0 || nblk <= 0 || O <= 0 || P <= 0 || U <= 0 ||
      k < 2 || k > 7 || acw % (k * k - 1) != 0 || nblk > pw ||
      nblk > acw / (k * k - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int p = acw / (k * k - 1);
  int to = 16;
  while (to > 4 && smem_bytes(to, k, rows, nblk, P) > kPreferredSmem) to /= 2;
  if (smem_bytes(to, k, rows, nblk, P) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = luma ? static_cast<float>(219.0 / 255.0)
                           : static_cast<float>(224.0 / 255.0);
  const float offset = luma ? 16.0f
                            : static_cast<float>(128.0 * (1.0 - 224.0 / 255.0));
  const auto* dc16 = static_cast<const int16_t*>(dc);
  const auto* ac16 = static_cast<const int16_t*>(ac);
  const auto* qtf = static_cast<const float*>(qt);
  const auto* wvf = static_cast<const float*>(wv);
  const auto* whf = static_cast<const float*>(wh);
  const auto* vi = static_cast<const int32_t*>(vidx);
  auto* o8 = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (to) {
    case 16:
      e = launch<16>(dc16, ac16, qtf, wvf, whf, vi, o8, B, rows, pw, acw, p,
                     nblk, O, P, U, k, scale, offset, centered, s);
      break;
    case 8:
      e = launch<8>(dc16, ac16, qtf, wvf, whf, vi, o8, B, rows, pw, acw, p,
                    nblk, O, P, U, k, scale, offset, centered, s);
      break;
    default:
      e = launch<4>(dc16, ac16, qtf, wvf, whf, vi, o8, B, rows, pw, acw, p,
                    nblk, O, P, U, k, scale, offset, centered, s);
      break;
  }
  return static_cast<int>(e);
}
