"""Where a single image's device steps should run: a probe on a card.

A request with no resize, and every output of the plain RGB head, encodes
one image at a time; a JPEG encode runs its colour mix and 8x8 fDCT on the
device, and a JPEG source with no resize runs its pixel decode there (one
K3 launch; two for a CMYK JPEG). Each is some hundred small device
operations issued from Python. This times N such calls (a 400x225 encode, a
1920x1080 encode, a 1920x1080 pixel decode, the pixel decode of the
committed 1920x1080 CMYK JPEG) issued from 1, 2, 4 and 16 threads, each
thread on a CUDA stream of its own, as the engine's pools would issue
them: the wall time of the N calls and the median time of one. Then the
CMYK decode step by step, one thread, each step ended by a synchronise
(the median of 10).

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


def cmyk_steps(data: bytes, reps: int = 10) -> dict:
    """Median ms of each step of the pixel decode of a CMYK JPEG
    (``dct.decode_four_components``), each ended by a synchronise."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.ops import color, dct, resize_planes
    from imagekit_tpu_torch.ops.resize_strip import resize_tables
    from imagekit_tpu_torch.ops.weights import (
        component_stacks,
        upsample_method,
    )

    dev = torch.device("cuda")
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        hdr, coeffs, qtabs = step("entropy decode (host)",
                                  lambda: jpeg_abi.decode4(loader.load(), data))
        grids = [c.shape[:2] for c in coeffs]
        full = max(g[0] for g in grids), max(g[1] for g in grids)
        keys = list(dict.fromkeys(
            (g, (hdr.comp_height[c], hdr.comp_width[c]),
             upsample_method((hdr.hmax // hdr.comp_h[c],
                              hdr.vmax // hdr.comp_v[c]), hdr.comp_width[c]))
            for c, g in enumerate(grids)))
        host = step("stacks, host (LRU)", lambda: [
            tuple(a[None] for a in component_stacks(full, *k)) for k in keys])
        dev_stacks = step("stacks, upload", lambda: [
            tuple(torch.as_tensor(a, device=dev) for a in st) for st in host])
        step("band tables", lambda: [resize_tables(*st) for st in dev_stacks])
        planes, stacks, tabs, vidx = step(
            "all of the above + levels' upload + IDCT (sampled_inputs)",
            lambda: dct.sampled_inputs((hdr, coeffs, qtabs), dev))
        out = step("K3, two launches", lambda: (
            resize_planes.resize_planes_u8(planes[:3], stacks[:3], vidx,
                                           bands=tabs[:3])
            + resize_planes.resize_planes_u8(planes[3:], stacks[3:], vidx,
                                             bands=tabs[3:])))
        step("colour + readback", lambda: color.to_host(color.cmyk_to_rgb(
            *(p[0, :hdr.height, :hdr.width] for p in out)), dev))
        step("whole device part (decode_four_components)",
             lambda: dct.decode_four_components((hdr, coeffs, qtabs), dev))
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
        "1920x1080 CMYK pixel decode, device part (decode_four_components)":
            lambda: dct.decode_four_components(cmyk_decoded, device="cuda"),
    }
    print(f"card: {card()}", flush=True)
    rows = []
    for name, fn in cases.items():
        for threads in (1, 2, 4, 16):
            row = {"case": name, "calls": 32, **run(fn, 32, threads)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    steps = cmyk_steps(cmyk)
    print(json.dumps({"cmyk_steps_ms": steps}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "rows": rows,
                               "cmyk_steps_ms": steps}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
