// K3 and K4 on Hopper: the two-pass resize of Y, Cb and Cr in one launch.
//
// Replaces imagekit_tpu/ops/pallas/resize_kernel.py::_resize_plane_kernel
// (K3, launched by pallas_resize_u8 through pl.pallas_call) and
// ::_resize_plane_kernel_f32 (K4, launched by resize_planes_f32_pallas).
// Per plane and image b, with one index u = vidx[b] for both axes:
//
//   acc = Wv[u] @ f32(P[b]) @ Wh[u]^T                        (OH x OW)
//
// K3 (u8 in, u8 out): floor(clip(acc, 0, 255) + 0.5), which equals K2's
// clip(floor(acc + 0.5)) for every f32 value, so K3 runs K2's epilogue
// with no remap. K4 (f32 out): acc as it is, from f32 planes or, for the
// k=8 JPEG -> WebP head, straight from the u8 planes the 8x8 IDCT rounds to
// (the same sums as on those planes widened to f32, without the widened
// copy: a B=32 1080p batch is about 100 MB of u8 planes, 400 MB as f32).
//
// The body is resize_band.cuh (its note says what bounds it and what the
// design does), the same as K2's. What is K3's own: the demoted JPEG head's
// three planes, a luma plane and two chroma planes of another shape with
// their own stacks, go in one launch (blockIdx.x walks Y's tiles, then
// Cb's, then Cr's); the Pallas kernel and this port's earlier version ran
// one launch per plane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resize_band.cuh"

// planes: nplanes (1..3) IkPlane records (resize_band.cuh) with hidx ==
// vidx and no affine epilogue; u8 in and out (K3), f32 in and out (K4), or
// u8 in and f32 out (K4 on u8 planes). Returns a cudaError_t: 0 when the
// launch was accepted; info as ik_resize_strip's.
extern "C" int ik_resize_planes_u8(const void* planes, int nplanes, int B,
                                   void* stream, int* info) {
  return band_resize<uint8_t, uint8_t>(static_cast<const IkPlane*>(planes),
                                       nplanes, B, 0, stream, info);
}

extern "C" int ik_resize_planes_f32(const void* planes, int nplanes, int B,
                                    void* stream, int* info) {
  return band_resize<float, float>(static_cast<const IkPlane*>(planes),
                                   nplanes, B, 0, stream, info);
}

extern "C" int ik_resize_planes_u8_f32(const void* planes, int nplanes, int B,
                                       void* stream, int* info) {
  return band_resize<uint8_t, float>(static_cast<const IkPlane*>(planes),
                                     nplanes, B, 0, stream, info);
}
