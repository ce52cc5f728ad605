"""Where a single image's device steps should run: a probe on a card.

A request with no resize, and every output of the plain RGB head, encodes
one image at a time; a JPEG encode runs its colour mix and 8x8 fDCT on the
device, and a JPEG source with no resize runs its pixel decode there (K6:
two launches). Each is some hundred small device
operations issued from Python. This times N such calls (a 400x225 encode, a
1920x1080 encode, a 1920x1080 pixel decode, the pixel decode of the
committed 1920x1080 CMYK JPEG) issued from 1, 2, 4 and 16 threads, each
thread on a CUDA stream of its own, as the engine's pools would issue
them: the wall time of the N calls and the median time of one. Then the
``device_decode`` stage of a 1080p 4:2:0 and of the CMYK source step by
step, one thread (entropy decode, K6's maps, upload, K6, readback; the
device steps by CUDA events; the median of 10).

Run from the root of a checkout, on a machine with one card and nvcc:

    python -m imagekit_tpu_torch.tools.single_image_probe [--out chiprun_out/single_image_probe.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch


def _image(w: int, h: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
    y = np.linspace(0, 255, h, dtype=np.float32)[:, None, None]
    img = 0.5 * (x + y) + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def run(fn, n: int, threads: int) -> dict:
    """``n`` calls of ``fn`` from ``threads`` threads, each on its own
    stream: wall seconds and the median seconds of one call."""
    tls = threading.local()
    times = []

    def call(_):
        stream = getattr(tls, "stream", None)
        if stream is None:
            stream = tls.stream = torch.cuda.Stream()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            fn()
        times.append(time.perf_counter() - t0)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(call, range(threads * 2)))  # streams, allocator
        times.clear()
        t0 = time.perf_counter()
        list(pool.map(call, range(n)))
        wall = time.perf_counter() - t0
    return {"threads": threads, "wall_s": wall,
            "median_call_ms": statistics.median(times) * 1e3}


def decode_steps(data: bytes, reps: int = 10) -> dict:
    """Median ms of each step of one pixel-decoded request's
    ``device_decode`` stage (``codecs/jpeg.py::decode_to_coefficients``
    then ``components_to_rgb``), one thread: the host entropy decode, the
    host plan of K6's maps, the upload of the levels and maps, K6's two
    launches, the colour tail (Pillow's CMYK step for a CMYK source), the
    readback; the device steps timed with CUDA events on the stream, each
    step ended by a synchronise. Then the whole stage as the engine calls
    it, on the host's clock."""
    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.ops import color, dct, jpeg_pixels

    dev = torch.device("cuda")
    steps = {}

    def host(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        steps.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def device(name, fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        steps.setdefault(name, []).append(start.elapsed_time(end))
        return out

    for _ in range(reps):
        decoded = host("entropy decode (host)",
                       lambda: jpeg.decode_to_coefficients(data))
        hdr = decoded[0]
        plan = host("K6 maps (host)", lambda: jpeg_pixels.frame_plan(
            *decoded, dct.frame_colour(hdr)))
        x = device("upload", lambda: jpeg_pixels.upload(plan, dev))
        px = device("K6, two launches", lambda: jpeg_pixels.decode_pixels(x))
        if hdr.ncomp == 4:
            px = device("CMYK step", lambda: color.cmyk_to_rgb(
                *px.unbind(-1)))
        device("readback", lambda: color.to_host(px, dev))
        host("whole device_decode stage (components_to_rgb, host clock)",
             lambda: jpeg.components_to_rgb(decoded, device=dev))
    return {k: statistics.median(v) for k, v in steps.items()}


def main(argv=None) -> int:
    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops import _build, dct
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients
    from imagekit_tpu_torch.tools.band_probe import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/single_image_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("single_image_probe: no CUDA device", file=sys.stderr)
        return 2
    _build.load()
    small, large = _image(400, 225), _image(1920, 1080, 1)
    planes, qt = host_encode_rgb_to_coefficients(large, 80)
    source = loader.encode_jpeg(planes, qt, 1920, 1080)
    decoded = loader.decode_jpeg(source)
    cmyk = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
            / "cmyk_1080p_q80.jpg").read_bytes()
    cmyk_decoded = jpeg.decode_to_coefficients(cmyk)
    cases = {
        "fDCT of a 400x225 encode (encode_rgb_to_coefficients)":
            lambda: dct.encode_rgb_to_coefficients(small, 80, device="cuda"),
        "whole 400x225 JPEG encode (jpeg.encode_rgb)":
            lambda: jpeg.encode_rgb(small, 80, device="cuda"),
        "whole 1920x1080 JPEG encode (jpeg.encode_rgb)":
            lambda: jpeg.encode_rgb(large, 80, device="cuda"),
        "1920x1080 pixel decode, device part (decode_components_to_rgb)":
            lambda: dct.decode_components_to_rgb(decoded, device="cuda"),
        "1920x1080 CMYK pixel decode, device part (decode_components_to_rgb)":
            lambda: dct.decode_components_to_rgb(cmyk_decoded, device="cuda"),
    }
    print(f"card: {card()}", flush=True)
    rows = []
    for name, fn in cases.items():
        for threads in (1, 2, 4, 16):
            row = {"case": name, "calls": 32, **run(fn, 32, threads)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    steps = {"420": decode_steps(source), "cmyk": decode_steps(cmyk)}
    print(json.dumps({"decode_steps_ms": steps}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "rows": rows,
                               "decode_steps_ms": steps}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
