"""Decode time of the port's AV1 decoder on the committed 1080p AVIFs,
one checkout after another: an A/B of two trees of the repo in one run.

    python -m imagekit_tpu_torch.tools.av1_decode_timing \\
        [--fixtures DIR] [--repeat N] [--out FILE] ROOT [ROOT ...]

Each ROOT is a checkout (or an unpacked ``git archive``) of the repo; pass
them in the order to run, e.g. parent, change, change, parent, so that a
drift of the host's clock over the run shows. Each runs in a process of
its own, with that tree's ``imagekit_tpu_torch`` first on ``sys.path``
(its native library built into its own ``build/``): every ``*.avif`` of
the fixture directory (``tests/fixtures/avif`` of the first ROOT by
default) is parsed, decoded once to warm up, then ``N`` times (5), and the
least time of the colour item's decode is kept, in ms, beside the stream's
bit depth and layout; a file that tree does not decode is recorded as its
error. Where a tree's decoder reports film grain (``StreamInfo.film_grain``)
the file is also timed with the grain left out (``apply_grain=False``) and
both on one thread (``_set_threads(1)``): the synthesis' own cost, on the
stripes' threads and alone. The host needs no card. Prints one JSON line
a ROOT, then one line that joins them, and writes the joined object to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import glob, json, os, sys, time
root, fixtures, repeat = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
from imagekit_tpu_torch.codecs.avif_native import parse_container
from imagekit_tpu_torch.codecs.native import av1_dec_abi

av1_dec_abi.load()


def decode(obu, grain):
    y, u, v, info = av1_dec_abi._decode_samples(obu, apply_grain=grain)
    return [av1_dec_abi.to_8bit(p, info.bitdepth) for p in (y, u, v)]


out = {}
for path in sorted(glob.glob(os.path.join(fixtures, "*.avif"))):
    name = os.path.basename(path)[:-5]
    try:
        obu = parse_container(open(path, "rb").read()).obu
        head = av1_dec_abi.decode(obu)[3]
        times = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            av1_dec_abi.decode(obu)
            times.append(time.perf_counter() - t0)
        out[name] = {"ms": min(times) * 1e3, "bitdepth": head.bitdepth,
                     "layout": head.layout}
        if getattr(head, "film_grain", False):
            for key, grain, threads in (
                    ("no_grain_ms", False, 0), ("one_thread_ms", True, 1),
                    ("one_thread_no_grain_ms", False, 1)):
                av1_dec_abi._set_threads(threads)
                try:
                    times = []
                    for _ in range(repeat):
                        t0 = time.perf_counter()
                        decode(obu, grain)
                        times.append(time.perf_counter() - t0)
                finally:
                    av1_dec_abi._set_threads(0)
                out[name][key] = min(times) * 1e3
    except Exception as e:
        out[name] = {"error": f"{type(e).__name__}: {e}"}
print(json.dumps(out))
"""


def time_tree(root: str, fixtures: str, repeat: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, os.path.abspath(root), fixtures,
         str(repeat)], capture_output=True, text=True, cwd=root,
        timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--fixtures")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    fixtures = os.path.abspath(args.fixtures or os.path.join(
        args.roots[0], "tests", "fixtures", "avif"))
    runs = []
    for root in args.roots:
        res = time_tree(root, fixtures, args.repeat)
        runs.append({"root": root, "decode": res})
        print(json.dumps(runs[-1]), flush=True)
    joined = {"fixtures": fixtures, "repeat": args.repeat, "runs": runs}
    print(json.dumps(joined))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(joined, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
