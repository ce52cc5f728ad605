// K2 on Hopper: the strip resize, the three channels of an interleaved RGB
// batch in one launch, the four of an RGBA batch, or up to three planes.
//
// Replaces imagekit_tpu/ops/pallas_resize.py::_make_resize_kernel (the body
// launched by _plane_resize through pl.pallas_call, once per channel by
// _resample_rgb_yuv_pallas and _resample_rgb_jpeg_pallas). Per image b and
// channel:
//
//   acc = Wv[vidx[b]] @ f32(x[b]) @ Wh[hidx[b]]^T          (OH x OW)
//
// Epilogue: optional (acc + pre) * scale + post with each plane's own
// constants, then floor(v + 0.5) (round half up), clip to [0, 255], and u8
// out, or i8 after -128 when centered.
//
// The body is resize_band.cuh (its note says what bounds it and what the
// design does). What is K2's own: one launch reads each pixel row of the
// (B, H, W*3) batch once, whole, and writes the three resized channels as
// (B, 3, OH, OW); the Pallas kernel and this port's earlier version ran one
// launch per channel, each reading the whole interleaved batch. The same
// entry takes the Y, Cb and Cr planes of a YUV-source batch in one launch
// (imagekit_tpu/ops/pallas_resize.py::_resize_yuv420_pallas and
// ::_resize_yuv_jpeg_pallas ran _plane_resize once per plane): the studio to
// full-range remap of the JPEG output differs between Y and chroma, so its
// constants ride in each plane's record. With four elements a pixel it is
// the plain RGB head of sources with alpha
// (imagekit_tpu/ops/resize.py::_resample_flat_kernel, two XLA einsums and a
// rounding pass in the reference): the (B, H, W*4) batch in, the rounded
// (B, OH, OW, 4) pixels out, interleaved for the host encoders.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resize_band.cuh"

// planes: nplanes (1..6) IkPlane records (resize_band.cuh), u8 in and out,
// each with its own affine epilogue; C = 1, 3 or 4 elements a pixel, the
// same in every plane. Returns a cudaError_t: 0 when the launch was
// accepted; info (two ints, or null) gets the tile height and the column
// strips a row tile took (0: whole rows).
extern "C" int ik_resize_strip(const void* planes, int nplanes, int B,
                               int centered, void* stream, int* info) {
  return band_resize<uint8_t, uint8_t>(static_cast<const IkPlane*>(planes),
                                       nplanes, B, centered, stream, info);
}

// The same body with u8 planes in and unrounded f32 out (no epilogue): the
// resizes of a BT.709 AVIF batch, whose 709 -> 601 mix of Y, Cb and Cr
// needs the planes before rounding (the reference computes it between its
// einsums and its rounding, imagekit_tpu/ops/dct.py::_yuv_mix_tail).
extern "C" int ik_resize_strip_f32(const void* planes, int nplanes, int B,
                                   void* stream, int* info) {
  return band_resize<uint8_t, float>(static_cast<const IkPlane*>(planes),
                                     nplanes, B, 0, stream, info);
}
