"""K1's, K2's, K3's and K4's CUDA source, compiled for the CPU and held
against the plain versions.

The sources (``imagekit_tpu_torch/csrc/jpeg8_folded.cu``,
``resize_strip.cu``, ``resize_planes.cu`` and the body these two share,
``resize_band.cuh``) are
compiled by ``g++`` under a small shim that stands in for
``cuda_runtime.h``: one thread per block, ``__shared__`` arrays static,
``__syncthreads`` a no-op (``__syncthreads_or`` the thread's own
value), a warp shuffle the lane's own value, an atomic
add a plain one, ``IK_LAUNCH`` a loop over the grid's blocks,
``IK_DYN_SMEM`` a buffer filled with NaN before each launch (a read of
shared memory that no pass wrote would show), the ``cp.async`` staging
(``IK_CP_ASYNC``) a plain copy, and the few intrinsics the
body uses (``__ldg``, ``__byte_perm``, ``__fadd_rn``, ...) as plain C++.
The launch records are built by the wrappers' own helpers
(``resize_strip.plane_record``, ``jpeg8._launch`` and ``_launch_i16``) on
CPU tensors. This checks the indexing,
the per-row band segments, the chunked weight staging, the ragged tiles
and groups, the pixel-row reads of an interleaved batch and both passes'
sums; it does not check races or anything of the card's compiler (those
are ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on a card).

Tolerance: u8/i8 within max |d| <= 1 on at most 0.1% of elements of the
plain version (fp32 sums in another order; the reference's own band,
tests/test_pallas_jpeg8.py:72); f32 within rtol 1e-5 and 1e-5 of the
0..255 range, as K4 on the card.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from imagekit_tpu_torch.ops import _build, jpeg8, resize_planes as rp, resize_strip
from imagekit_tpu_torch.ops.resize_strip import plane_record, resize_tables
from imagekit_tpu_torch.ops.weights import combined_chroma_weights, padded_weights
from tests.test_torch_resize import EPILOGUES, assert_band

CSRC = Path(__file__).resolve().parents[1] / "imagekit_tpu_torch" / "csrc"

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 threadIdx(0), blockIdx(0), blockDim(1), gridDim(1);
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) short4 { short x, y, z, w; };
struct alignas(4) char4 { signed char x, y, z, w; };
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p += v;
  return old;
}
inline int __shfl_xor_sync(unsigned, int v, int) { return v; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)x | ((uint64_t)y << 32);
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

namespace ik_shim {
inline std::vector<float>& smem() {
  static std::vector<float> buf;
  return buf;
}
template <class K>
struct Launcher {
  K kernel;
  dim3 grid;
  size_t bytes;
  template <class... A>
  void operator()(const A&... args) {
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        smem().assign(bytes / 4 + 4, NAN);
        blockIdx = dim3(bx, by);
        threadIdx = dim3(0);
        blockDim = dim3(1);
        gridDim = grid;
        kernel(args...);
      }
  }
};
template <class K>
Launcher<K> launcher(K k, dim3 g, size_t bytes) { return {k, g, bytes}; }
}  // namespace ik_shim

#define IK_LAUNCH(kernel, grid, block, smem, stream) \
  ik_shim::launcher(kernel, grid, smem)
#define IK_DYN_SMEM(type, name) \
  type* name = reinterpret_cast<type*>(ik_shim::smem().data())
#define IK_CP_ASYNC(dst, src, bytes) memcpy(dst, src, bytes)
#define IK_CP_COMMIT()
#define IK_CP_WAIT(n)
"""


def _build_cpu(d: Path, csrc: Path):
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's native codecs too"
    (d / "cuda_runtime.h").write_text(SHIM)
    so = d / "libik_band_cpu.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", str(d), "-x", "c++", str(csrc / "resize_strip.cu"),
         str(csrc / "resize_planes.cu"), str(csrc / "jpeg8_folded.cu"),
         "-o", str(so)],
        check=True, capture_output=True, text=True, timeout=300)
    out = ctypes.CDLL(str(so))
    _build.configure_band(out)
    _build.configure_folded(out)
    return out


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build_cpu(tmp_path_factory.mktemp("kernel_cpu"), CSRC)


#: the body's largest shared-memory budget a block, as committed
MAX_SMEM = "constexpr size_t kBandMaxSmem = 225 * 1024;"


@pytest.fixture(scope="module")
def roomy_lib(tmp_path_factory):
    """The same sources with the largest shared-memory budget raised to
    64 MB: rows too wide for a tile of whole rows on a card take whole rows
    here, the body the strips must equal bit for bit."""
    d = tmp_path_factory.mktemp("kernel_cpu_roomy")
    body = (CSRC / "resize_band.cuh").read_text()
    assert body.count(MAX_SMEM) == 1
    (d / "resize_band.cuh").write_text(body.replace(
        MAX_SMEM, "constexpr size_t kBandMaxSmem = 64 << 20;"))
    for name in ("resize_strip.cu", "resize_planes.cu", "jpeg8_folded.cu"):
        shutil.copy(CSRC / name, d / name)
    return _build_cpu(d, d)


def _stack(ti, to, bi, bo, U, replicate=True, hole=None):
    """(U, bo, bi) Lanczos slots of decreasing true sizes; the row after each
    true output replicates the last (the engine's edge rows), the rest stay
    zero (empty bands); ``hole`` zeroes one row inside the output."""
    w = np.zeros((U, bo, bi), np.float32)
    for u in range(U):
        t_i, t_o = ti - 3 * u, to - u
        w[u] = padded_weights(t_i, t_o, bi, bo)
        if replicate and t_o < bo:
            w[u, t_o] = w[u, t_o - 1]
        if hole is not None:
            w[u, hole] = 0.0
    return w


def _images(B, H, WC, seed):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, WC, dtype=np.float32)[None, None, :]
    y = np.linspace(0, 255, H, dtype=np.float32)[None, :, None]
    img = 0.5 * (x + y) + rng.normal(0, 40, (B, H, WC))
    return np.clip(img, 0, 255).astype(np.uint8)


def _strip_launch(lib, x, wv, wh, vidx, hidx, C, kw=None, strip=0,
                  info=None):
    """K2's source on (B, H, W*C) pixel rows ``x`` -> (B, C, OH, OW), or
    (B, OH, OW, 4) for C = 4, whose pixels leave interleaved; ``strip``
    asks for column strips of that width, ``info`` (a list) gets what the
    launch took."""
    kw = kw or {}
    B, H, WC = x.shape
    tabs = resize_tables(wv, wh)
    oh, ow = wv.shape[1], wh.shape[1]
    centered = kw.get("centered", False)
    out = torch.empty((B, oh, ow, 4) if C == 4 else (B, C, oh, ow),
                      dtype=torch.int8 if centered else torch.uint8)
    remap = {k: kw[k] for k in ("scale", "pre", "post") if k in kw}
    rec = plane_record(x.data_ptr(), H * WC, WC, C, wv, tabs, vidx, hidx,
                       out, C * oh * ow, 1 if C == 4 else oh * ow, H, WC // C,
                       **remap, strip=strip)
    got = _build.launch_band(lib.ik_resize_strip, [rec], B, int(centered), None)
    if info is not None:
        info.append((got.tr, got.strips))
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (B, H, W, OH, OW, U, vidx, hidx, stack options): what each case holds
K2_CASES = {
    # one image, a tile count that does not divide OH
    "b1": (1, 40, 64, 19, 24, 2, [1], [0], {}),
    # mixed slots, an index outside the stack on each axis (clamped), the
    # engine's replicated rows and empty pad rows, ragged last tiles
    "b5_mixed": (5, 48, 80, 21, 30, 3, [2, 0, -1, 1, 7], [0, 2, 1, 9, -3], {}),
    # an empty row inside the output: its tile row takes a neighbour's band
    "hole": (3, 40, 64, 17, 26, 2, [0, 1, 1], [1, 0, 1], {"hole": 5}),
    # bands taller than one staged chunk of 64 rows (a 12x downscale)
    "tall_band": (2, 360, 24, 30, 8, 2, [0, 1], [1, 1], {}),
    # an upscale: narrow bands, many tile rows per input row
    "upscale": (2, 12, 16, 30, 37, 2, [1, 0], [0, 1], {}),
    # rows wide enough that the tile takes 4 rows (and 2) of the kernel
    "tr4": (1, 16, 1200, 7, 300, 1, [0], [0], {}),
    "tr2": (1, 10, 4800, 3, 1200, 1, [0], [0], {}),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_rgb_source_matches_plain(lib, case):
    """The one-launch RGB entry's source: three channels of an interleaved
    batch against ``rgb_resize_plain``."""
    B, H, W, OH, OW, U, vidx, hidx, opts = K2_CASES[case]
    wv = _stack(H, OH - 1, H, OH, U, **opts)
    wh = _stack(W, OW - 2, W, OW, U, **opts)
    imgs = _images(B, H, W * 3, seed=len(case))
    x, wv_t, wh_t, v, h = _t(imgs, wv, wh, np.int32(vidx), np.int32(hidx))
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, 3)
    want = resize_strip.rgb_resize_plain(
        x, wv_t, wh_t, v.clamp(0, U - 1), h.clamp(0, U - 1))
    assert got.shape == want.shape == (B, 3, OH, OW)
    assert_band(got.numpy(), want.numpy(), case)
    assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_rgba_source_matches_plain(lib, case):
    """The four-channel entry's source: the pixels of an interleaved RGBA
    batch, stored interleaved, against ``rgba_resize_plain`` (the band), and
    exactly equal, channel by channel, to the same source's launch on a
    contiguous copy of the channel: the same sums in the same order,
    whatever tile height the row width gives each."""
    B, H, W, OH, OW, U, vidx, hidx, opts = K2_CASES[case]
    wv = _stack(H, OH - 1, H, OH, U, **opts)
    wh = _stack(W, OW - 2, W, OW, U, **opts)
    imgs = _images(B, H, W * 4, seed=40 + len(case))
    x, wv_t, wh_t, v, h = _t(imgs, wv, wh, np.int32(vidx), np.int32(hidx))
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, 4)
    vc, hc = v.clamp(0, U - 1), h.clamp(0, U - 1)
    want = resize_strip.rgba_resize_plain(x, wv_t, wh_t, vc, hc)
    assert got.shape == want.shape == (B, OH, OW, 4)
    assert_band(got.numpy(), want.numpy(), case)
    # the wrapper on CPU tensors takes the plain version
    assert torch.equal(resize_strip.rgba_resize(x, wv_t, wh_t, vc, hc), want)
    assert 0.2 < float(((got > 0) & (got < 255)).float().mean())
    for c in range(4):
        plane = x.reshape(B, H, W, 4)[..., c].contiguous()
        alone = _strip_launch(lib, plane, wv_t, wh_t, v, h, 1)
        assert torch.equal(got[..., c], alone[:, 0]), (case, c)


def test_k2_rgba_source_centres_every_channel(lib):
    """The centred epilogue through the packed store: each byte is the
    two's-complement i8 of its channel."""
    wv, wh = _stack(40, 16, 40, 18, 2), _stack(64, 24, 64, 26, 2)
    x, wv_t, wh_t, v, h = _t(_images(2, 40, 256, seed=6), wv, wh,
                              np.int32([0, 1]), np.int32([1, 0]))
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, 4, {"centered": True})
    want = resize_strip.rgba_resize_plain(x, wv_t, wh_t, v, h)
    assert got.dtype == torch.int8
    assert_band(got.numpy().astype(int) + 128, want.numpy())


def test_k2_non_monotone_bands_take_the_union(lib):
    """Rows of Wv in reversed order (their bands fall as the row index
    grows): the tile runs one segment over the union, with zero weights."""
    wv = _stack(40, 16, 40, 16, 2)[:, ::-1].copy()
    wh = _stack(64, 24, 64, 24, 2)
    imgs = _images(2, 40, 64 * 3, seed=9)
    x, wv_t, wh_t, v, h = _t(imgs, wv, wh, np.int32([0, 1]), np.int32([1, 0]))
    bands = resize_strip.band_table(wv_t)[0, :8, 0]
    assert (bands[1:] < bands[:-1]).any()
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, 3)
    assert_band(got.numpy(), resize_strip.rgb_resize_plain(
        x, wv_t, wh_t, v, h).numpy())


def test_k2_empty_stack_slot_gives_zeros(lib):
    wv = _stack(40, 16, 40, 16, 2)
    wh = _stack(64, 24, 64, 24, 2)
    wv[1] = 0.0
    x, wv_t, wh_t, v, h = _t(_images(2, 40, 192, seed=3), wv, wh,
                              np.int32([1, 0]), np.int32([0, 0]))
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, 3)
    assert not got[0].any() and got[1].any()
    assert_band(got.numpy(), resize_strip.rgb_resize_plain(
        x, wv_t, wh_t, v, h).numpy())


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("batch", [1, 5])
def test_k2_plane_source_matches_plain(lib, epilogue, batch):
    """``plane_resize``'s records: a contiguous plane (C=1), all three
    epilogues, one image or five with mixed indices."""
    kw = EPILOGUES[epilogue]
    wv = _stack(48, 20, 48, 22, 3)
    wh = _stack(72, 30, 72, 33, 3)
    planes = _images(batch, 48, 72, seed=4 + batch)
    x, wv_t, wh_t, v, h = _t(planes, wv, wh, np.int32([2, 0, 1, 1, 0][:batch]),
                              np.int32([0, 1, 2, 0, 2][:batch]))
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, 1, kw)
    want = resize_strip.plane_resize_plain(x, wv_t, wh_t, v, h, **kw)
    assert got.dtype == want.dtype
    assert_band(got[:, 0].numpy(), want.numpy(), epilogue)


# -- column strips ------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_strips_equal_whole_rows_on_narrow_rows(lib, case, C):
    """Column strips asked for where whole rows fit: each output is the
    same terms in the same order, so the bytes are the whole-row body's, at
    strips of 5 columns (ragged, and windows that reach past the row's end
    in the upscale) and of 16."""
    B, H, W, OH, OW, U, vidx, hidx, opts = K2_CASES[case]
    wv = _stack(H, OH - 1, H, OH, U, **opts)
    wh = _stack(W, OW - 2, W, OW, U, **opts)
    x, wv_t, wh_t, v, h = _t(_images(B, H, W * C, seed=60 + C), wv, wh,
                              np.int32(vidx), np.int32(hidx))
    info = []
    whole = _strip_launch(lib, x, wv_t, wh_t, v, h, C, info=info)
    for sw in (5, 16):
        got = _strip_launch(lib, x, wv_t, wh_t, v, h, C, strip=sw, info=info)
        assert torch.equal(got, whole), (case, C, sw)
    assert [n > 0 for _, n in info] == [False, True, 16 < OW]


def test_k2_strips_zero_the_window_past_the_row(lib):
    """RGBA rows of 30 pixels: the last windows, 4-aligned, reach 2 pixels
    past the row, where a strip's tile holds zeros for their zero taps (a
    whole row's tile holds the next row's samples)."""
    wv, wh = _stack(20, 9, 20, 10, 2), _stack(30, 11, 30, 12, 2)
    x, wv_t, wh_t, v, h = _t(_images(2, 20, 30 * 4, seed=13), wv, wh,
                              np.int32([0, 1]), np.int32([1, 1]))
    start, taps = resize_strip.compact_table(wh_t)
    assert int(start.max()) + 4 * taps.shape[1] > 30
    whole = _strip_launch(lib, x, wv_t, wh_t, v, h, 4)
    for sw in (1, 4):
        assert torch.equal(_strip_launch(lib, x, wv_t, wh_t, v, h, 4,
                                         strip=sw), whole)


def test_k2_strips_take_falling_starts_column_by_column(lib):
    """A Wh whose rows run backwards (the starts fall as the column grows):
    a strip's span is searched column by column, with the same bytes."""
    wv = _stack(40, 16, 40, 16, 2)
    wh = _stack(64, 24, 64, 24, 2)[:, ::-1].copy()
    x, wv_t, wh_t, v, h = _t(_images(2, 40, 64 * 3, seed=12), wv, wh,
                              np.int32([0, 1]), np.int32([1, 0]))
    start = resize_strip.compact_table(wh_t)[0]
    assert (start[:, 1:] < start[:, :-1]).any()
    whole = _strip_launch(lib, x, wv_t, wh_t, v, h, 3)
    for sw in (3, 9):
        assert torch.equal(_strip_launch(lib, x, wv_t, wh_t, v, h, 3,
                                         strip=sw), whole)


# (C, W, OW) of rows wider than a tile of whole rows takes on a card (the
# body's largest budget holds 2 rows of some 26,700 floats beside its ring)
WIDE = {"plane": (1, 28000, 300), "rgb": (3, 9000, 400), "rgba": (4, 6800, 300)}


@pytest.mark.parametrize("kind", sorted(WIDE))
def test_k2_strips_on_rows_past_the_whole_row_ceiling(lib, roomy_lib, kind):
    """The source on a card's budget takes column strips for these rows;
    the same sources with room for whole rows take whole rows: the bytes
    are equal, and within the band of the plain version."""
    C, W, OW = WIDE[kind]
    B, H, OH = 2, 12, 5
    wv = _stack(H, OH - 1, H, OH, 2)
    wh = _stack(W, OW - 1, W, OW, 2)
    x, wv_t, wh_t, v, h = _t(_images(B, H, W * C, seed=C), wv, wh,
                              np.int32([0, 1]), np.int32([1, 0]))
    info = []
    got = _strip_launch(lib, x, wv_t, wh_t, v, h, C, info=info)
    whole = _strip_launch(roomy_lib, x, wv_t, wh_t, v, h, C, info=info)
    assert info[0][1] > 0 and info[1][1] == 0, info
    assert torch.equal(got, whole)
    plain = {1: resize_strip.plane_resize_plain, 3: resize_strip.rgb_resize_plain,
             4: resize_strip.rgba_resize_plain}[C](x, wv_t, wh_t, v, h)
    assert_band((got[:, 0] if C == 1 else got).numpy(), plain.numpy(), kind)
    assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


def _k3_stacks(U=3):
    """Luma 48x64 -> 20x28 and chroma 24x32 -> the same 20x28 (the demoted
    head's 2x upsample folded into the chroma stacks)."""
    wv_y = np.zeros((U, 20, 48), np.float32)
    wh_y = np.zeros((U, 28, 64), np.float32)
    wv_c = np.zeros((U, 20, 24), np.float32)
    wh_c = np.zeros((U, 28, 32), np.float32)
    for u in range(U):
        ih, iw, oh, ow = 48 - 4 * u, 64 - 8 * u, 20 - u, 28 - 2 * u
        wv_y[u] = padded_weights(ih, oh, 48, 20)
        wh_y[u] = padded_weights(iw, ow, 64, 28)
        wv_c[u] = combined_chroma_weights((ih + 1) // 2, ih, oh, 24, 20)
        wh_c[u] = combined_chroma_weights((iw + 1) // 2, iw, ow, 32, 28)
    return wv_y, wh_y, wv_c, wh_c


# (planes in, planes out, entry) of the K3/K4 source
PLANE_ENTRIES = {
    "K3": (torch.uint8, torch.uint8, "ik_resize_planes_u8"),
    "K4": (torch.float32, torch.float32, "ik_resize_planes_f32"),
    # K4 on the u8 planes of the k=8 JPEG -> WebP head, widened in the kernel
    "K4_u8": (torch.uint8, torch.float32, "ik_resize_planes_u8_f32"),
}


def _planes_launch(lib, entry, planes, stacks, v, strips=(0, 0, 0)):
    """The three planes in one launch of ``entry``'s source, each plane's
    record asking for its own strips; returns the outputs and what the
    launch took."""
    _, out_dtype, fn_name = PLANE_ENTRIES[entry]
    B = v.shape[0]
    pairs = (stacks[:2], stacks[2:], stacks[2:])
    recs, outs, tabs = [], [], []
    for p, (wv, wh), sw in zip(planes, pairs, strips):
        out = torch.empty((B, 20, 28), dtype=out_dtype)
        tabs.append(resize_tables(wv, wh))  # alive until the launch
        recs.append(plane_record(p.data_ptr(), p.shape[1] * p.shape[2],
                                 p.shape[2], 1, wv, tabs[-1], v, v, out,
                                 20 * 28, 0, *p.shape[1:], strip=sw))
        outs.append(out)
    info = _build.launch_band(getattr(lib, fn_name), recs, B, None)
    return outs, info.strips


def _k3_inputs(entry, vidx):
    in_dtype = PLANE_ENTRIES[entry][0]
    B = len(vidx)
    planes = [torch.from_numpy(_images(B, h, w, seed=h + w))
              for h, w in ((48, 64), (24, 32), (24, 32))]
    if in_dtype == torch.float32:
        planes = [p.float() + 0.25 for p in planes]
    return planes, _t(*_k3_stacks()), torch.tensor(vidx, dtype=torch.int32)


@pytest.mark.parametrize("entry", sorted(PLANE_ENTRIES))
@pytest.mark.parametrize("vidx", [[1], [0, 2, 1, -4, 6]], ids=["b1", "b5"])
def test_k3_k4_three_planes_match_plain(lib, entry, vidx):
    """Y and the two chroma planes, of another shape and with their own
    stacks, in one launch of K3's (u8) or K4's (f32 out) source."""
    f32 = PLANE_ENTRIES[entry][1] == torch.float32
    planes, stacks, v = _k3_inputs(entry, vidx)
    outs, _ = _planes_launch(lib, entry, planes, stacks, v)
    plain = rp.resize_planes3_f32_plain if f32 else rp.resize_planes3_plain
    wants = plain(planes, stacks, v.clamp(0, 2))
    for got, want in zip(outs, wants):
        if f32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=255e-5)
        else:
            assert_band(got.numpy(), want.numpy())
            assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


@pytest.mark.parametrize("entry", sorted(PLANE_ENTRIES))
@pytest.mark.parametrize("strips", [(6, 0, 0), (0, 5, 11), (7, 7, 7)])
def test_k3_k4_strips_equal_whole_rows(lib, entry, strips):
    """K3's and K4's entries on the same body: column strips asked for in
    some planes of a launch (the others stay whole) give the whole-row
    body's values exactly."""
    planes, stacks, v = _k3_inputs(entry, [0, 2, 1, -4, 6])
    whole, n0 = _planes_launch(lib, entry, planes, stacks, v)
    got, n = _planes_launch(lib, entry, planes, stacks, v, strips)
    assert n0 == 0 and n == (28 + min(s_ for s_ in strips if s_) - 1) // min(
        s_ for s_ in strips if s_)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("jpeg", [False, True], ids=["webp_out", "jpeg_out"])
@pytest.mark.parametrize("vidx", [[1], [0, 2, 1, -4, 6]], ids=["b1", "b5"])
def test_k2_three_yuv_planes_with_their_own_epilogues(lib, jpeg, vidx):
    """The YUV-source heads' launch: Y, Cb and Cr as views of one flat
    4:2:0 batch (images a padded row apart), with their own stacks, and for
    JPEG output luma's remap in Y's record and chroma's in Cb's and Cr's,
    against ``yuv_resize_plain``."""
    B = len(vidx)
    wv_y, wh_y, _, _ = _k3_stacks()
    # chroma to HALF output resolution, as the YUV heads' stacks are
    wv_c = _stack(24, 9, 24, 10, 3)
    wh_c = _stack(32, 13, 32, 14, 3)
    stacks = _t(wv_y, wh_y, wv_c, wh_c)
    v = torch.tensor(vidx, dtype=torch.int32)
    ny, nc = 48 * 64, 24 * 32
    flat = torch.from_numpy(_images(B, 1, ny + 2 * nc + 128, seed=11)[:, 0])
    planes = (flat[:, :ny].view(B, 48, 64),
              flat[:, ny:ny + nc].view(B, 24, 32),
              flat[:, ny + nc:ny + 2 * nc].view(B, 24, 32))
    pairs = (stacks[:2], stacks[2:], stacks[2:])
    recs, outs, tabs = [], [], []
    for p, (wv, wh), kw in zip(planes, pairs, resize_strip._remaps(jpeg)):
        oh, ow = wv.shape[1], wh.shape[1]
        out = torch.empty((B, oh, ow),
                          dtype=torch.int8 if jpeg else torch.uint8)
        tabs.append(resize_tables(wv, wh))  # alive until the launch
        recs.append(plane_record(p.data_ptr(), flat.shape[1], p.shape[2], 1,
                                 wv, tabs[-1], v, v, out, oh * ow, 0,
                                 *p.shape[1:], **kw))
        outs.append(out)
    assert all(bool(r.affine) == jpeg for r in recs)
    assert not jpeg or (recs[0].pre, recs[1].pre) == (-16.0, -128.0)
    _build.launch_band(lib.ik_resize_strip, recs, B, int(jpeg), None)
    wants = resize_strip.yuv_resize_plain(planes, stacks, v.clamp(0, 2),
                                          jpeg=jpeg)
    # the wrapper on CPU tensors takes the same plain version, views and all
    again = resize_strip.yuv_resize(planes, stacks, v.clamp(0, 2), jpeg=jpeg)
    for got, want, w2 in zip(outs, wants, again):
        assert got.dtype == want.dtype and torch.equal(want, w2)
        assert_band(got.numpy(), want.numpy())
    lo, hi = (-128, 127) if jpeg else (0, 255)  # mostly unclipped
    assert 0.2 < float(((outs[0] > lo) & (outs[0] < hi)).float().mean())


# (W, C of each plane): records the source refuses
REFUSED = {
    # a row pitch (60 bytes) that is not a whole number of 8-byte loads
    "misaligned_rows": (20, (3,)),
    # only pixels of 1, 3 or 4 channels, every channel read
    "two_channels": (24, (2,)),
    # four-channel pixels leave as 32-bit words: the output must be aligned
    "rgba_out_unaligned": (24, (4,)),
    # every plane of a launch has as many channels
    "mixed_channels": (24, (3, 1)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_source_refuses_what_it_does_not_take(lib, case):
    """What the source does not take is refused with
    cudaErrorInvalidValue, before any block runs."""
    W, chans = REFUSED[case]
    wv, wh = _t(_stack(16, 8, 16, 8, 1), _stack(W, 8, W, 8, 1))
    v = torch.zeros(1, dtype=torch.int32)
    tabs = resize_tables(wv, wh)
    keep, recs = [], []
    for C in chans:
        x = torch.zeros((1, 16, W * C), dtype=torch.uint8)
        out = torch.empty((1, C, 8, 8), dtype=torch.uint8)
        if case == "rgba_out_unaligned":
            out = torch.empty(1 + C * 64, dtype=torch.uint8)[1:]
        keep += [x, out]
        recs.append(plane_record(x.data_ptr(), 16 * W * C, W * C, C, wv, tabs,
                                 v, v, out, C * 64, 64, 16, W))
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.launch_band(lib.ik_resize_strip, recs, 1, 0, None)


# -- K1 ----------------------------------------------------------------------


def _k1_stacks(rng, k, U, rows, nblk, O, P):
    """Folded (U, k, O, rows) / (U, k, P, nblk) stacks with a band of
    nonzero block rows and columns about each output's centre (empty rows
    past the slot's true output), rows summing to about 1 per plane."""
    def stack(o_n, n):
        w = np.zeros((U, k, o_n, n), np.float32)
        for u in range(U):
            true_o = o_n - 2 * u
            for o in range(true_o):
                c = int(o * n / true_o)
                lo, hi = max(c - 2, 0), min(c + 3, n)
                w[u, :, o, lo:hi] = rng.random((k, hi - lo)) / (hi - lo)
        return torch.from_numpy(w)

    return stack(O, rows), stack(P, nblk)


def _k1_common(k, seed, B=3, U=3):
    """Stacks for a luma plane of 18 x 35 blocks -> 21 x 50 and chroma
    planes of 9 x 18 blocks -> 11 x 26 (ragged stripes and 4-level groups),
    tables and an index with a slot out of range (clamped)."""
    rng = np.random.default_rng(seed)
    wv_y, wh_y = _k1_stacks(rng, k, U, 18, 35, 21, 50)
    wv_c, wh_c = _k1_stacks(rng, k, U, 9, 18, 11, 26)
    stacks = (wv_y, wh_y, wv_c, wh_c)
    bands = tuple(jpeg8.folded_bands(s_) for s_ in stacks)
    qt = torch.from_numpy((rng.random((B, 128)) * 6 + 1).astype(np.float32))
    vidx = torch.tensor([1, U + 3, 0][:B], dtype=torch.int32)
    return rng, stacks, bands, qt, vidx


def _assert_k1(got, want, centered):
    pairs = zip(got, want) if centered else [(got, want)]
    for g, w in pairs:
        assert g.dtype == w.dtype
        assert_band(g.numpy(), w.numpy())
        lo, hi = (-128, 127) if centered else (0, 255)  # mostly unclipped
        assert 0.3 < float(((g > lo) & (g < hi)).float().mean())


@pytest.mark.parametrize("centered", [False, True], ids=["decode", "centred"])
@pytest.mark.parametrize("k", [2, 4])
def test_k1_split_entry_matches_plain(lib, k, centered):
    """K1's split-int8 entry: planar i8 AC, i16 DC and escape residuals in
    every plane, against ``folded_planes_i8_plain``."""
    B = 3
    rng, stacks, bands, qt, vidx = _k1_common(k, seed=70 + k, B=B)
    na = k * k - 1
    dcs, acs, escs = [], [], []
    for rows, nblk in ((18, 35), (9, 18), (9, 18)):
        p = 128
        dcs.append(torch.from_numpy(
            rng.integers(-60, 60, (B, rows, p)).astype(np.int16)))
        acs.append(torch.from_numpy(
            rng.integers(-10, 10, (B, rows, na * p)).astype(np.int8)))
        ei = np.zeros((16, 3), np.int32)  # the rest are padding rows
        ev = np.zeros(16, np.int32)
        for e in range(6):
            ei[e] = (e % B, rng.integers(rows),
                     rng.integers(na) * p + rng.integers(nblk))
            ev[e] = rng.integers(-300, 300)
        escs.append((torch.from_numpy(ei), torch.from_numpy(ev)))
    Bc, U, dims = jpeg8._check(dcs, acs, escs, qt, stacks, bands, vidx, k)
    got, rc = jpeg8._launch(lib, None, dcs, acs, escs, qt, stacks, bands,
                            vidx, k, centered, Bc, U, dims)
    assert rc == 0
    want = jpeg8.folded_planes_i8_plain(dcs, acs, escs, qt, stacks, bands,
                                        vidx, k, centered)
    _assert_k1(got, want, centered)
    without = jpeg8.folded_planes_i8_plain(
        dcs, acs, [(i, torch.zeros_like(v)) for i, v in escs], qt, stacks,
        bands, vidx, k, centered)
    first = want[0] if centered else want
    assert (first != (without[0] if centered else without)).any()


@pytest.mark.parametrize("centered", [False, True], ids=["decode", "centred"])
@pytest.mark.parametrize("k", [2, 4])
def test_k1_int16_entry_matches_plain(lib, k, centered):
    """K1's int16 entry: block-grouped levels (level u*k+v of block column
    c at c*k*k + u*k+v), junk in the padding columns, no escapes, against
    ``folded_planes_i16_plain``."""
    B = 3
    rng, stacks, bands, qt, vidx = _k1_common(k, seed=80 + k, B=B)
    nk = k * k
    flats = []
    for rows, nblk in ((18, 35), (9, 18), (9, 18)):
        pw = (nblk * nk + 127) // 128 * 128
        flat = rng.integers(-999, 999, (B, rows, pw))
        lev = rng.integers(-10, 10, (B, rows, nblk, nk))
        lev[..., 0] = rng.integers(-60, 60, (B, rows, nblk))
        lev[0, 0, 0, 1] = 700  # past int8: what this transport is for
        flat[:, :, : nblk * nk] = lev.reshape(B, rows, -1)
        flats.append(torch.from_numpy(flat.astype(np.int16)))
    Bc, U, dims = jpeg8._check_i16(flats, qt, stacks, bands, vidx, k)
    got, rc = jpeg8._launch_i16(lib, None, flats, qt, stacks, bands, vidx, k,
                                centered, Bc, U, dims)
    assert rc == 0
    want = jpeg8.folded_planes_i16_plain(flats, qt, stacks, bands, vidx, k,
                                         centered)
    _assert_k1(got, want, centered)


def test_k1_entries_refuse_what_they_do_not_take(lib):
    _, stacks, bands, qt, vidx = _k1_common(2, seed=5)
    flats = [torch.zeros((3, rows, 128), dtype=torch.int16)
             for rows in (18, 9, 9)]  # 35 blocks of 4 levels need 140
    dims = [(18, 128, 35, 21, 50), (9, 128, 18, 11, 26), (9, 128, 18, 11, 26)]
    _, rc = jpeg8._launch_i16(lib, None, flats, qt, stacks, bands, vidx, 2,
                              False, 3, 3, dims)
    assert rc == 1  # cudaErrorInvalidValue
    flats[0] = torch.zeros((3, 18, 256), dtype=torch.int16)
    dims[0] = (18, 256, 35, 21, 50)
    _, rc = jpeg8._launch_i16(lib, None, flats, qt, stacks, bands, vidx, 8,
                              False, 3, 3, dims)
    assert rc == 1  # k = 8 has no folded head
