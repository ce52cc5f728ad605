#!/usr/bin/env python3
"""Smoke run of imagekit_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``imagekit_tpu_torch/csrc`` and
drives the port's main path, a 1920x1080 JPEG resized to fit 400 px and
encoded as WebP q80, through ``BatchedEngine.transform`` on the card:

1. environment: the card (``nvidia-smi``), torch and CUDA versions;
2. build: the K1 kernel library and the host codecs;
3. K1 against its plain PyTorch version on the card, at B in {1, 32},
   k in {2, 4}, luma and chroma, both epilogues, on coefficients decoded
   from synthesized 1080p JPEGs (escapes included) and real folded Lanczos
   stacks; the median of 20 CUDA-event timings of each at B=32, k=2;
4. the engine slice: >=32 concurrent requests over 16 distinct JPEGs,
   outputs checked, K1's launch count checked against the batch count,
   one batch's planes checked against the plain head, requests/s and
   p50/p99 latency;
5. HTTP ``/sign`` -> ``/img`` through the port's app, where aiohttp is
   installed.

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
import subprocess
import sys
import time
import traceback

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
    """Wraps the engine's head call and keeps the device inputs and the
    planes of every batch."""

    def __init__(self, module):
        self.module = module
        self.fn = module.decode_resize_yuv_lowfreq_i8_batch
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kw):
            out = self.fn(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        self.module.decode_resize_yuv_lowfreq_i8_batch = wrapped
        return self

    def __exit__(self, *exc):
        self.module.decode_resize_yuv_lowfreq_i8_batch = self.fn


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
# phase 4: the engine slice
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
    lat = sorted(t for _, t in res)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3
    rps = n_req / wall
    log(f"  engine: {n_req} concurrent requests in {wall:.4f} s -> "
        f"{rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
        f"{batches} batches, {launches} K1 launches; last batch vs plain head "
        f"max|d|={mx} share(|d|=1)={share1:.3e} [{card}]")
    return {"launches": launches, "batches": batches, "rps": rps,
            "p50_ms": p50, "p99_ms": p99}


# ---------------------------------------------------------------------------
# phase 5: HTTP
# ---------------------------------------------------------------------------


def phase_http(jpegs) -> str:
    try:
        import aiohttp
        from aiohttp import web
    except ImportError as e:
        return f"NOT RUN: aiohttp is not installed ({e})"

    import shutil

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

        src.router.add_get("/src{i}.jpg", serve)
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
                for i in range(4):
                    url = f"http://127.0.0.1:{src_port}/src{i}.jpg"
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
            if metrics.cache_hits != 4 or metrics.cache_misses != 4:
                raise RuntimeError(
                    f"cache hits {metrics.cache_hits}, misses "
                    f"{metrics.cache_misses}; expected 4 and 4")
        finally:
            await runner.cleanup()
            await src_runner.cleanup()
        return "passed: 4 x (/sign -> /img 200 image/webp with ETag, then a cache HIT)"

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
    log(f"[2] K1 built by nvcc in {time.perf_counter() - t0:.2f} s")
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

    log("[3] K1 against its plain PyTorch version on the card")
    kern = phase_kernel(jpegs, jpegs_hq)

    log("[4] engine slice: BatchedEngine(device='cuda').transform, "
        "1920x1080 JPEG -> w=400 WebP q80")
    eng = phase_engine(jpegs, card)

    log(f"[5] HTTP: {phase_http(jpegs)}")
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
