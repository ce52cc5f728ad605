"""How the first-party AVIF encoder behaves under concurrency: a host probe.

The engine runs its host codecs on a pool of threads. The AV1 encoder's
Python loop makes many short ctypes calls, each of which gives up the GIL,
so encodes in several threads slow each other down; the engine gives AVIF
encodes one thread of their own (``serving/batcher.py``). This times N
encodes of 400x225 studio-range planes (a w=400 thumbnail of a 1080p
photo, q80) one after another, as that thread runs them, and issued at
once from N threads: the wall seconds of each.

Run from the root of a checkout (no card needed):

    python -m imagekit_tpu_torch.tools.avif_probe [--counts 1,2,4,8] [--out avif_probe.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _planes(seed: int, h: int = 225, w: int = 400):
    """Studio-range 4:2:0 planes: a smooth field, hard-edged rectangles and
    mild noise, as a resized photo has."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = 126 + 90 * np.sin(2 * np.pi * (xx / w * (1 + rng.random())
                                       + yy / h * 1.5))
    for _ in range(12):
        x0, y0 = rng.integers(0, w - 16), rng.integers(0, h - 16)
        y[y0:y0 + rng.integers(8, 80), x0:x0 + rng.integers(8, 100)] = \
            rng.integers(16, 236)
    y = y + rng.normal(0, 3, (h, w))
    ch, cw = (h + 1) // 2, (w + 1) // 2
    cb = 128 + 40 * np.sin(np.arange(cw) / 9.0)[None, :] + np.zeros((ch, 1))
    cr = 128 + 30 * np.cos(np.arange(ch) / 7.0)[:, None] + np.zeros((1, cw))
    return tuple(np.clip(p, 16, 235).astype(np.uint8) for p in (y, cb, cr))


def main(argv=None) -> int:
    from imagekit_tpu_torch.codecs import avif_encode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", default="1,2,4,8")
    ap.add_argument("--quality", type=int, default=80)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    counts = [int(c) for c in args.counts.split(",")]
    planes = [_planes(seed) for seed in range(max(counts))]
    y, cb, cr = planes[0]
    # the first encode builds the native library
    avif_encode.encode_firstparty(y[:16, :16], cb[:8, :8], cr[:8, :8],
                                  args.quality)

    def encode(p):
        return avif_encode.encode_firstparty(*p, args.quality)

    def at_once(n):
        with ThreadPoolExecutor(n) as pool:
            t0 = time.perf_counter()
            list(pool.map(encode, planes[:n]))
            return time.perf_counter() - t0

    rows = []
    for n in counts:
        t0 = time.perf_counter()
        for p in planes[:n]:
            encode(p)
        serial = time.perf_counter() - t0
        threads = at_once(n)
        rows.append({"n": n, "serial_s": serial, "threads_s": threads})
        print(f"{n} encodes of 400x225 q{args.quality}: one after another "
              f"{serial:.4f} s, from {n} threads at once {threads:.4f} s",
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
