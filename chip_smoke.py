#!/usr/bin/env python3
"""Smoke run of imagekit_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``imagekit_tpu_torch/csrc`` and
drives the port's two paths through ``BatchedEngine.transform`` on the
card: a 1920x1080 JPEG resized to fit 400 px and encoded as WebP q80 (K1),
and a 1920x1080 RGB PNG resized to fit 400 px and encoded as WebP q80 or
JPEG q80 (K2):

1. environment: the card (``nvidia-smi``), torch and CUDA versions;
2. build: the kernel library (one nvcc per source, started together), the
   host codecs, 16 synthesized 1080p JPEGs and the same 16 images as PNGs
   (written with ``zlib`` and ``struct``: no Pillow);
3. K1 against its plain PyTorch version on the card, at B in {1, 32},
   k in {2, 4}, luma and chroma, both epilogues, on coefficients decoded
   from synthesized 1080p JPEGs (escapes included) and real folded Lanczos
   stacks; the median of 20 CUDA-event timings of each at B=32, k=2;
4. K2 against its plain PyTorch version on the card: the three channels
   of an interleaved 1088x1920 batch -> 240x400 at B in {1, 32} with
   vidx != hidx (default epilogue), and a 544x960 -> 120x200 plane with the
   yuvjpg luma and chroma remaps (affine + centred epilogues); the median
   of 20 CUDA-event timings of each at B=32;
5. the JPEG engine slice: >=32 concurrent requests over 16 distinct
   JPEGs, outputs checked, K1's launch count checked against the batch
   count, one batch's planes checked against the plain head, requests/s
   and p50/p99 latency;
6. the PNG engine slice: 64 WebP and 64 JPEG requests at once over the 16
   PNGs, outputs decoded to their size, K2's launch count checked against
   the batch count, one batch's planes and one batch's levels checked
   against the plain heads, requests/s, p50/p99 and the host stages;
7. HTTP ``/sign`` -> ``/img`` for JPEG and PNG sources and a PNG
   ``/upload`` through the port's app, where aiohttp is installed.

Any failed phase raises, and the script exits non-zero. The last lines are
the card's name and power limit, one JSON line describing each kernel, and
``{"ok": true, "device": {...}}``. Without a card (or outside a checkout)
it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import struct
import subprocess
import sys
import time
import traceback
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SECRET = "chip-smoke-secret"
# parity band of the reference (tests/test_pallas_jpeg8.py:72): |d| <= 1
# on at most 0.1% of pixels — fp32 sums taken in another order
MAX_ABS = 1
MAX_SHARE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def synth_image(seed: int, w: int = 1920, h: int = 1080) -> np.ndarray:
    """Seeded RGB image: a smooth gradient, hard-edged rectangles (their
    edges give low-frequency AC levels beyond int8 at high quality, i.e.
    escapes) and mild noise."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    phase = rng.random(3).astype(np.float32)
    img = 127.5 + 100.0 * np.sin(
        2 * np.pi * (x * (1 + phase) + y * (1.5 - phase))
    )
    img = np.broadcast_to(img, (h, w, 3)).copy()
    for _ in range(24):
        x0, y0 = rng.integers(0, w - 64), rng.integers(0, h - 64)
        x1 = x0 + rng.integers(32, 400)
        y1 = y0 + rng.integers(32, 300)
        img[y0:y1, x0:x1] = rng.integers(0, 256, 3)
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_jpeg(seed: int, quality: int) -> bytes:
    """JPEG without Pillow: the port's numpy fDCT + the native Huffman
    encoder."""
    from imagekit_tpu.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    img = synth_image(seed)
    planes, qt = host_encode_rgb_to_coefficients(img, quality)
    return loader.encode_jpeg(planes, qt, img.shape[1], img.shape[0])


def make_png(img: np.ndarray) -> bytes:
    """RGB PNG without Pillow: filter 0 on every row, zlib level 1."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def native_codecs() -> str:
    """Load the host codec library through the reference's loader; when
    that fails, show the compiler's error and, if only zlib is missing,
    build the two codecs this path needs (JPEG entropy, VP8 encode)."""
    import ctypes

    from imagekit_tpu.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.ops._build import BUILD_DIR

    if loader.load() is not None:
        return "imagekit_tpu.codecs.native.loader"
    src = os.path.join(ROOT, "imagekit_tpu", "codecs", "native")
    flags = ["g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17",
             "-shared", "-fPIC", "-fvisibility=hidden"]
    full = [os.path.join(src, s) for s in loader._SOURCES]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        flags + full + ["-o", str(BUILD_DIR / "probe.so"), "-lz"],
        capture_output=True, text=True, timeout=300,
    )
    log("native loader build failed; g++ said:\n" + proc.stderr[-4000:])
    if "zlib.h" not in proc.stderr:
        raise RuntimeError("native codec build failed")
    out = BUILD_DIR / "libik_native_min.so"
    subprocess.run(
        flags + [os.path.join(src, "jpeg_entropy.cpp"),
                 os.path.join(src, "vp8_encode.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    jpeg_abi.configure(lib)
    loader._lib = lib  # the reference codecs resolve the library here
    return f"{out} (jpeg_entropy + vp8_encode, no zlib)"


class Recorder:
    """Wraps one of the engine's head calls and keeps the device inputs and
    the outputs of every batch."""

    def __init__(self, module, name: str = "decode_resize_yuv_lowfreq_i8_batch"):
        self.module = module
        self.name = name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kw):
            out = self.fn(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def capture_batch(jpegs, width: int, batch: int):
    """Drive ``batch`` requests through an engine that flushes only full
    batches; return the recorded device inputs of that one batch."""
    from imagekit_tpu.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    cfg = ImageKitConfig(secret=SECRET, batch=BatchConfig(
        max_batch=batch, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))
    engine = BatchedEngine(cfg, metrics=Metrics(), device="cuda")

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(jpegs[i % len(jpegs)], width, None,
                                 ImageFormat.webp, 80)
                for i in range(batch)
            ))
        finally:
            await engine.close()

    with Recorder(engine_jpeg) as rec:
        asyncio.run(run())
    if len(rec.calls) != 1:
        raise RuntimeError(f"expected one batch, got {len(rec.calls)}")
    return rec.calls[0]


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------


def compare(a, b):
    """max |a - b|, the share of elements at |d| = 1, and the share beyond
    the band."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), float((d == 1).float().mean()), float(
        (d > MAX_ABS).float().mean())


def plane_inputs(args, k: int):
    """The per-plane K1 inputs of a recorded batch: i16 widen + escape
    scatter, dequant scales, folded stacks."""
    from imagekit_tpu_torch.ops import jpeg8

    (y_dc, cb_dc, cr_dc), (y_ac, cb_ac, cr_ac), esc, qt, w, vidx = args[:6]
    qt_l, qt_c = (q.contiguous() for q in jpeg8.qt_lowfreq(qt, k))
    (ey, eyv), (eb, ebv), _ = esc
    luma = (y_dc, jpeg8.widen_scatter(y_ac, ey, eyv), qt_l, w[0], w[1], vidx)
    chroma = (cb_dc, jpeg8.widen_scatter(cb_ac, eb, ebv), qt_c, w[2], w[3],
              vidx)
    return luma, chroma


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def latency(res):
    """p50 and p99 in ms of the (output, seconds) results of a round."""
    lat = sorted(t for _, t in res)
    return (lat[len(lat) // 2] * 1e3,
            lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3)


def phase_kernel(jpegs, jpegs_hq) -> dict:
    from imagekit_tpu_torch.ops import jpeg8

    result = {"max_abs_err": 0}
    # B=32: two escape-heavy q95 images among q80 ones, so that the batch
    # carries escapes and still fits the head's escape caps in one batch
    mixed = list(jpegs_hq) + list(jpegs) * 2
    for k, width in ((2, 400), (4, 800)):
        for batch in (1, 32):
            src = mixed[:32] if batch == 32 else jpegs_hq[:1]
            args, _, planes = capture_batch(src, width, batch)
            k_rec = args[8]
            if k_rec != k:
                raise RuntimeError(f"width {width}: engine chose k={k_rec}")
            n_esc = int((args[2][0][1] != 0).sum())
            luma, chroma = plane_inputs(args, k)
            for name, inp, is_luma in (("luma", luma, True),
                                       ("chroma", chroma, False)):
                for centered in (False, True):
                    got = jpeg8.folded_plane(*inp, k, is_luma, centered)
                    ref = jpeg8.folded_plane_plain(*inp, k, is_luma, centered)
                    torch.cuda.synchronize()
                    mx, share1, over = compare(got, ref)
                    log(f"  K1 vs plain B={batch} k={k} {name} "
                        f"{'centered' if centered else 'decode'} "
                        f"shape={tuple(got.shape)} luma_escapes={n_esc}: "
                        f"max|d|={mx} share(|d|=1)={share1:.3e}")
                    if mx > MAX_ABS or share1 > MAX_SHARE or over:
                        raise RuntimeError("K1 disagrees with its plain version")
                    result["max_abs_err"] = max(result["max_abs_err"], mx)
            mx, share1 = check_head(args, planes)
            log(f"  head (engine, K1) vs plain head B={batch} k={k}: "
                f"max|d|={mx} share(|d|=1)={share1:.3e}")
            if batch == 32 and k == 2:
                three = ((luma, True), (chroma, False), (chroma, False))
                ms = cuda_ms(lambda: [jpeg8.folded_plane(*i, k, lu)
                                      for i, lu in three])
                plain_ms = cuda_ms(lambda: [jpeg8.folded_plane_plain(*i, k, lu)
                                            for i, lu in three])
                fa = _flat_args(args)
                head_ms = cuda_ms(lambda: jpeg8.decode_resize_i8(*fa, k=k))
                head_plain_ms = cuda_ms(lambda: plain_head(args))
                log(f"  timing B=32 k=2, 3 planes (median of 20, CUDA events): "
                    f"K1 {ms:.4f} ms, plain {plain_ms:.4f} ms; whole head "
                    f"(widen+scatter+3 planes+pack): K1 route {head_ms:.4f} ms, "
                    f"plain head {head_plain_ms:.4f} ms")
                result.update(ms=ms, plain_ms=plain_ms, head_ms=head_ms,
                              head_plain_ms=head_plain_ms)
    return result


def _flat_args(args):
    (y_dc, cb_dc, cr_dc), (y_ac, cb_ac, cr_ac), esc, qt, w, vidx = args[:6]
    (ey, eyv), (eb, ebv), (er, erv) = esc
    return (y_dc, y_ac, cb_dc, cb_ac, cr_dc, cr_ac, ey, eyv, eb, ebv, er, erv,
            qt, w[0], w[1], w[2], w[3], vidx)


def plain_head(args):
    """The plain PyTorch head on a recorded batch's device inputs."""
    from imagekit_tpu_torch.ops import dct

    by_b, bx_b, cy_b, cx_b = args[6]
    return dct.decode_resize_yuv_lowfreq_i8(
        *_flat_args(args), by_b=by_b, bx_b=bx_b, cy_b=cy_b, cx_b=cx_b,
        k=args[8])


def check_head(args, planes):
    """A recorded batch's planes (the K1 route) against the plain head on
    the same inputs; raises outside the band."""
    plain = plain_head(args)
    flat = torch.cat([torch.from_numpy(p.reshape(p.shape[0], -1))
                      for p in planes], dim=1).to(plain.device)
    mx, share1, over = compare(flat, plain)
    if mx > MAX_ABS or share1 > MAX_SHARE or over:
        raise RuntimeError(
            f"K1 head disagrees with the plain head: max|d|={mx}, "
            f"share(|d|=1)={share1:.3e}")
    return mx, share1


# ---------------------------------------------------------------------------
# phase 4: K2 against its plain version
# ---------------------------------------------------------------------------

# four (true input, true output) slots per axis in the slice's bucket pair;
# image b takes vertical slot b % 4 and horizontal slot (b + 1) % 4
SLICE_V = ((1080, 225), (1072, 223), (1064, 222), (1056, 220))
SLICE_H = ((1920, 400), (1904, 397), (1888, 393), (1872, 390))
CHROMA_V = ((540, 113), (536, 112), (532, 111), (528, 110))
CHROMA_H = ((960, 200), (952, 198), (944, 197), (936, 195))


def k2_stacks(key, v_slots, h_slots):
    """Weight stacks and band tables on the card, built by the engine's own
    builder (edge rows replicated as the engine replicates them)."""
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    engine = BatchedEngine(metrics=Metrics(), device="cuda")
    try:
        return engine._rgb_weights(
            key, {k: i for i, k in enumerate(v_slots)},
            {k: i for i, k in enumerate(h_slots)})
    finally:
        asyncio.run(engine.close())


def k2_index(batch: int):
    vidx = torch.arange(batch, dtype=torch.int32, device="cuda") % 4
    return vidx, (vidx + 1) % 4


def phase_k2(images) -> dict:
    """``images``: the 16 synthesized 1920x1080 RGB images of the PNGs."""
    from imagekit_tpu_torch.ops import color, resize_strip

    result = {"max_abs_err": 0}

    def check(what, got, ref):
        mx, share1, over = compare(got, ref)
        log(f"  K2 vs plain {what} shape={tuple(got.shape)} "
            f"dtype={got.dtype}: max|d|={mx} share(|d|=1)={share1:.3e}")
        if mx > MAX_ABS or share1 > MAX_SHARE or over:
            raise RuntimeError("K2 disagrees with its plain version")
        result["max_abs_err"] = max(result["max_abs_err"], mx)

    wv, wh, bv, bh = k2_stacks((1088, 1920, 240, 400, 3, "yuv"),
                               SLICE_V, SLICE_H)
    host = np.zeros((32, 1088, 1920 * 3), np.uint8)
    for i in range(32):
        host[i, :1080] = images[i % len(images)].reshape(1080, -1)
    full = torch.from_numpy(host).cuda().reshape(32, 1088, 1920, 3)
    for batch in (1, 32):
        x = full[:batch]
        vidx, hidx = k2_index(batch)
        for c in range(3):
            got = resize_strip.plane_resize(x[..., c], wv, wh, vidx, hidx,
                                            bands=(bv, bh))
            ref = resize_strip.plane_resize_plain(x[..., c], wv, wh, vidx,
                                                  hidx)
            torch.cuda.synchronize()
            check(f"B={batch} channel {'RGB'[c]} (u8)", got, ref)
    vidx, hidx = k2_index(32)

    def three(fn):
        return lambda: [fn(full[..., c], wv, wh, vidx, hidx, bands=(bv, bh))
                        for c in range(3)]

    ms = cuda_ms(three(resize_strip.plane_resize))
    plain_ms = cuda_ms(three(resize_strip.plane_resize_plain))
    flat = full.reshape(32, 1088, -1)
    head_ms = cuda_ms(lambda: color.rgb_yuv_head(flat, wv, wh, vidx, hidx,
                                                 (bv, bh)))
    head_plain_ms = cuda_ms(lambda: color.rgb_yuv_head(
        flat, wv, wh, vidx, hidx, (bv, bh),
        resize=resize_strip.plane_resize_plain))
    log(f"  timing B=32 1088x1920 -> 240x400, 3 channels (median of 20, CUDA "
        f"events): K2 {ms:.4f} ms, plain {plain_ms:.4f} ms; whole rgbyuv "
        f"head (3 resizes + mix + box + pack): K2 route {head_ms:.4f} ms, "
        f"plain {head_plain_ms:.4f} ms")
    result.update(ms=ms, plain_ms=plain_ms, head_ms=head_ms,
                  head_plain_ms=head_plain_ms)
    del full, flat, x

    wv, wh, bv, bh = k2_stacks((544, 960, 120, 200, 1, "yuv"),
                               CHROMA_V, CHROMA_H)
    planes = np.zeros((32, 544, 960), np.uint8)
    for i in range(32):
        planes[i, :540] = images[i % len(images)][::2, ::2, i % 3]
    planes = torch.from_numpy(planes).cuda()
    epilogues = (("luma remap", dict(scale=255.0 / 219.0, pre=-16.0,
                                     centered=True)),
                 ("chroma remap", dict(scale=255.0 / 224.0, pre=-128.0,
                                       post=128.0, centered=True)))
    for name, kw in epilogues:
        for batch in (1, 32):
            vidx, hidx = k2_index(batch)
            got = resize_strip.plane_resize(planes[:batch], wv, wh, vidx,
                                            hidx, bands=(bv, bh), **kw)
            ref = resize_strip.plane_resize_plain(planes[:batch], wv, wh,
                                                  vidx, hidx, **kw)
            torch.cuda.synchronize()
            check(f"B={batch} 544x960 {name} (centred i8)", got, ref)
        t_k = cuda_ms(lambda: resize_strip.plane_resize(
            planes, wv, wh, vidx, hidx, bands=(bv, bh), **kw))
        t_p = cuda_ms(lambda: resize_strip.plane_resize_plain(
            planes, wv, wh, vidx, hidx, **kw))
        log(f"  timing B=32 544x960 -> 120x200 {name}: K2 {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
    return result


# ---------------------------------------------------------------------------
# phase 5: the JPEG engine slice
# ---------------------------------------------------------------------------


def phase_engine(jpegs, card: str) -> dict:
    from imagekit_tpu.codecs import vp8
    from imagekit_tpu.config import ImageFormat, ImageKitConfig
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu.signature import sign, verify_signature
    from imagekit_tpu_torch.ops import jpeg8
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    n_req = 64
    reqs = []
    for i in range(n_req):
        params = {"url": f"http://127.0.0.1/src{i % len(jpegs)}.jpg",
                  "w": "400", "f": "webp", "q": "80"}
        verify_signature(params, sign(params, SECRET), SECRET)
        reqs.append((jpegs[i % len(jpegs)], int(params["w"])))

    metrics = Metrics()
    engine = BatchedEngine(ImageKitConfig(secret=SECRET), metrics=metrics,
                           device="cuda")

    async def one(data, w):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, ImageFormat.webp, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            await asyncio.gather(*(one(d, w) for d, w in reqs[:len(jpegs)]))
            batches0 = metrics.batches
            jpeg8.LAUNCHES = 0  # count only the measured run
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(d, w) for d, w in reqs))
            wall = time.perf_counter() - t0
            launches = jpeg8.LAUNCHES
            return res, wall, launches, metrics.batches - batches0
        finally:
            await engine.close()

    with Recorder(engine_jpeg) as rec:
        res, wall, launches, batches = asyncio.run(drive())
    for out, _ in res:
        if out[:4] != b"RIFF" or out[8:12] != b"WEBP":
            raise RuntimeError("engine output is not a RIFF/WEBP file")
        if vp8.dimensions(out) != (400, 225):
            raise RuntimeError(f"WebP is {vp8.dimensions(out)}, not 400x225")
    if batches <= 0 or launches != 3 * batches:
        raise RuntimeError(
            f"K1 launches {launches} != 3 x {batches} batches on the engine path")
    args, _, planes = rec.calls[-1]
    mx, share1 = check_head(args, planes)
    p50, p99 = latency(res)
    rps = n_req / wall
    log(f"  engine: {n_req} concurrent requests in {wall:.4f} s -> "
        f"{rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
        f"{batches} batches, {launches} K1 launches; last batch vs plain head "
        f"max|d|={mx} share(|d|=1)={share1:.3e} [{card}]")
    return {"launches": launches, "batches": batches, "rps": rps,
            "p50_ms": p50, "p99_ms": p99}


# ---------------------------------------------------------------------------
# phase 6: the PNG engine slice
# ---------------------------------------------------------------------------


def phase_png_engine(pngs, card: str) -> dict:
    from imagekit_tpu.codecs import vp8
    from imagekit_tpu.codecs.native import jpeg_abi, loader
    from imagekit_tpu.config import ImageFormat, ImageKitConfig
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu_torch.ops import color, dct, resize_strip
    from imagekit_tpu_torch.serving import engine_rgb
    from imagekit_tpu_torch.serving.batcher import BatchedEngine

    n_each = 64
    reqs = [(pngs[i % len(pngs)], fmt) for i in range(n_each)
            for fmt in (ImageFormat.webp, ImageFormat.jpeg)]
    metrics = Metrics()
    engine = BatchedEngine(ImageKitConfig(secret=SECRET), metrics=metrics,
                           device="cuda")
    stages = ("decode_png", "batch_build", "device_resize", "encode")

    async def one(data, fmt):
        t0 = time.perf_counter()
        out = await engine.transform(data, 400, None, fmt, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            await asyncio.gather(*(one(d, f) for d, f in reqs[:32]))
            batches0 = metrics.batches
            stage0 = {k: metrics.stage_seconds[k] for k in stages}
            resize_strip.LAUNCHES = 0  # count only the measured run
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(d, f) for d, f in reqs))
            wall = time.perf_counter() - t0
            launches = resize_strip.LAUNCHES
            spent = {k: metrics.stage_seconds[k] - stage0[k] for k in stages}
            return res, wall, launches, metrics.batches - batches0, spent
        finally:
            await engine.close()

    with Recorder(engine_rgb, "resample_rgb_yuv_batch") as rec_y, \
            Recorder(engine_rgb, "resample_rgb_jpeg_batch") as rec_j:
        res, wall, launches, batches, spent = asyncio.run(drive())
    lib = loader.load()
    for (out, _), (_, fmt) in zip(res, reqs):
        if fmt == ImageFormat.webp:
            dims = vp8.dimensions(out) if out[8:12] == b"WEBP" else None
        else:
            hdr = jpeg_abi.parse(lib, out)
            dims = (hdr.width, hdr.height)
        if dims != (400, 225):
            raise RuntimeError(f"{fmt.value} output is {dims}, not 400x225")
    if batches <= 0 or launches != 3 * batches:
        raise RuntimeError(
            f"K2 launches {launches} != 3 x {batches} batches on the PNG path")

    args, kw, planes = rec_y.calls[-1]
    x, (wv, wh), vidx, hidx = args[:4]
    plain = color.rgb_yuv_head(x, wv, wh, vidx, hidx, kw["bands"],
                               resize=resize_strip.plane_resize_plain)
    got = torch.cat([torch.from_numpy(p.reshape(p.shape[0], -1))
                     for p in planes], dim=1).to(plain.device)
    mx_y, share_y, over = compare(got, plain)
    if mx_y > MAX_ABS or share_y > MAX_SHARE or over:
        raise RuntimeError("rgbyuv head (K2) disagrees with the plain head")
    args, kw, levels = rec_j.calls[-1]
    x, (wv, wh), vidx, hidx, qto = args[:5]
    plain = dct.rgb_jpeg_head(x, wv, wh, vidx, hidx, qto, kw["bands"],
                              resize=resize_strip.plane_resize_plain)
    got = torch.cat([torch.from_numpy(lv.reshape(lv.shape[0], -1))
                     for lv in levels], dim=1).to(plain.device)
    mx_j, share_j, over = compare(got, plain)
    n_diff = int((got != plain).sum())
    if mx_j > MAX_ABS or share_j > MAX_SHARE or over:
        raise RuntimeError("rgbjpg head (K2) disagrees with the plain head")

    n_req = len(reqs)
    rps = n_req / wall
    p50, p99 = latency(res)
    by_fmt = {f: latency([r for r, (_, g) in zip(res, reqs) if g == f])
              for f in (ImageFormat.webp, ImageFormat.jpeg)}
    log(f"  PNG engine: {n_req} concurrent requests ({n_each} WebP + {n_each} "
        f"JPEG) in {wall:.4f} s -> {rps:.2f} req/s, p50 {p50:.2f} ms, p99 "
        f"{p99:.2f} ms (WebP p50/p99 {by_fmt[ImageFormat.webp][0]:.2f}/"
        f"{by_fmt[ImageFormat.webp][1]:.2f} ms, JPEG "
        f"{by_fmt[ImageFormat.jpeg][0]:.2f}/{by_fmt[ImageFormat.jpeg][1]:.2f}"
        f" ms), {batches} batches, {launches} K2 launches [{card}]")
    log(f"  last WebP batch vs plain head: max|d|={mx_y} share(|d|=1)="
        f"{share_y:.3e}; last JPEG batch levels vs plain head: max|d|={mx_j}"
        f" share(|d|=1)={share_j:.3e} ({n_diff} levels differ)")
    log("  host seconds in the measured round: " + ", ".join(
        f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
        for k, v in spent.items()))
    return {"launches": launches, "batches": batches, "rps": rps,
            "p50_ms": p50, "p99_ms": p99}


# ---------------------------------------------------------------------------
# phase 7: HTTP
# ---------------------------------------------------------------------------


def phase_http(jpegs, png_bytes: bytes) -> str:
    try:
        import aiohttp
        from aiohttp import web
    except ImportError as e:
        return f"NOT RUN: aiohttp is not installed ({e})"

    import shutil

    from imagekit_tpu.codecs import vp8
    from imagekit_tpu.config import ImageKitConfig
    from imagekit_tpu.fetch import Fetcher
    from imagekit_tpu.serving.metrics import Metrics
    from imagekit_tpu_torch.ops._build import BUILD_DIR
    from imagekit_tpu_torch.serving.app import create_app

    cache_dir = BUILD_DIR / "smoke_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)

    async def run():
        src = web.Application()

        async def serve(request):
            i = int(request.match_info["i"])
            return web.Response(body=jpegs[i], content_type="image/jpeg")

        async def serve_png(request):
            return web.Response(body=png_bytes, content_type="image/png")

        src.router.add_get("/src{i}.jpg", serve)
        src.router.add_get("/src.png", serve_png)
        src_runner = web.AppRunner(src)
        await src_runner.setup()
        src_site = web.TCPSite(src_runner, "127.0.0.1", 0)
        await src_site.start()
        src_port = src_runner.addresses[0][1]
        metrics = Metrics()
        app = create_app(ImageKitConfig(secret=SECRET, cache_dir=cache_dir),
                         fetcher=Fetcher(), metrics=metrics,
                         rate_limit=False, device="cuda")
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = runner.addresses[0][1]
        base = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as s:
                urls = [f"http://127.0.0.1:{src_port}/src{i}.jpg"
                        for i in range(4)]
                for url in urls + [f"http://127.0.0.1:{src_port}/src.png"]:
                    async with s.get(f"{base}/sign", params={
                            "url": url, "w": "400", "f": "webp", "q": "80"}) as r:
                        signed = (await r.json())["signed_url"]
                    for attempt in range(2):
                        async with s.get(base + signed) as r:
                            body = await r.read()
                            if (r.status != 200
                                    or r.headers["Content-Type"] != "image/webp"
                                    or "ETag" not in r.headers
                                    or body[8:12] != b"WEBP"):
                                raise RuntimeError(
                                    f"/img answered {r.status} {dict(r.headers)}")
                form = aiohttp.FormData()
                form.add_field("file", png_bytes, filename="src.png")
                form.add_field("w", "400")
                async with s.post(base + "/upload", data=form) as r:
                    body = await r.read()
                    if (r.status != 200
                            or r.headers["Content-Type"] != "image/webp"
                            or vp8.dimensions(body) != (400, 225)):
                        raise RuntimeError(f"PNG /upload answered {r.status}")
            if metrics.cache_hits != 5 or metrics.cache_misses != 5:
                raise RuntimeError(
                    f"cache hits {metrics.cache_hits}, misses "
                    f"{metrics.cache_misses}; expected 5 and 5")
        finally:
            await runner.cleanup()
            await src_runner.cleanup()
        return ("passed: 4 JPEG and 1 PNG x (/sign -> /img 200 image/webp "
                "with ETag, then a cache HIT); PNG /upload 200 image/webp "
                "400x225")

    return asyncio.run(run())


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import imagekit_tpu_torch  # noqa: F401  (fails outside a checkout)
    from imagekit_tpu_torch.device import resolve_device
    from imagekit_tpu_torch.ops import _build

    t_start = time.perf_counter()
    resolve_device("cuda")
    card = nvidia_smi()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    _build.load()
    log(f"[2] K1 and K2 built by nvcc in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "bytes stack" in line or "smem" in line:
            log("    ptxas: " + line.strip())
    t0 = time.perf_counter()
    log(f"    host codecs: {native_codecs()} "
        f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    jpegs = [make_jpeg(seed, 80) for seed in range(16)]
    jpegs_hq = [make_jpeg(100 + seed, 95) for seed in range(2)]
    log(f"    made {len(jpegs)} q80 and {len(jpegs_hq)} q95 1920x1080 JPEGs "
        f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    images = [synth_image(seed) for seed in range(16)]
    pngs = [make_png(img) for img in images]
    log(f"    made {len(pngs)} 1920x1080 RGB PNGs (zlib level 1, "
        f"{sum(map(len, pngs)) / len(pngs) / 1e6:.2f} MB each) in "
        f"{time.perf_counter() - t0:.2f} s")

    log("[3] K1 against its plain PyTorch version on the card")
    kern = phase_kernel(jpegs, jpegs_hq)

    log("[4] K2 against its plain PyTorch version on the card")
    k2 = phase_k2(images)

    log("[5] JPEG engine slice: BatchedEngine(device='cuda').transform, "
        "1920x1080 JPEG -> w=400 WebP q80")
    eng = phase_engine(jpegs, card)

    log("[6] PNG engine slice: BatchedEngine(device='cuda').transform, "
        "1920x1080 RGB PNG -> w=400 WebP q80 and JPEG q80")
    png_eng = phase_png_engine(pngs, card)

    log(f"[7] HTTP: {phase_http(jpegs, pngs[0])}")
    log(f"    total {time.perf_counter() - t_start:.2f} s")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "jpeg8_folded_plane (K1)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/jpeg8_folded.cu",
        "replaces": "imagekit_tpu/ops/pallas_jpeg8.py:159",
        "launches": eng["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }, {
        "name": "resize_strip_plane (K2)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_strip.cu",
        "replaces": "imagekit_tpu/ops/pallas_resize.py:155",
        "launches": png_eng["launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failure is a failed smoke run
        traceback.print_exc()
        sys.exit(1)
