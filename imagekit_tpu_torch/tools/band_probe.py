"""Knock-out probe of the banded resize body (K2, K3) on a card.

Builds variants of ``csrc/resize_band.cuh``, each with one part of the
kernel taken out or one choice changed, next to the committed body, and
times K2's three channels of the flagship RGB batch (B=32, 1088x1920 ->
240x400), its four channels of the same batch as RGBA, and K3's three
planes of the demoted head (Y 1088x1920, Cb and Cr 544x960, all ->
240x400) through the port's own wrappers on each, with ``--strips``
K2's RGB and RGBA batches in column strips of the widths named, and the
rows too wide for whole rows that K2 always takes in strips (a 9600x2400
RGB image at its exact shape, the RGBA 8192 bucket). A
variant's outputs are wrong by design; only its time is read. The time a
part costs is the committed body's time less the variant's, so what bounds
the kernel shows without ``ncu``.

Run from the root of a checkout, on a machine with one card and nvcc:

    python -m imagekit_tpu_torch.tools.band_probe [--out chiprun_out/band_probe.json]
        [--variants committed,...] [--strips 64,128,256] [--smooth]

It prints one line per variant and writes the times, with the card's name
and power limit, as JSON. The variants are textual patches of the body:
a patch that no longer applies raises, so the probe follows the source or
fails.

With ``--sanitize`` it only runs the committed body once on small cases,
for a run under ``compute-sanitizer`` (``--tool memcheck`` or
``racecheck``): K2 with three and four channels at B=2, in whole rows and
in column strips of 128, and K6's two launches on the four-component
pixel decode of the committed progressive CMYK fixture:

    compute-sanitizer --tool memcheck python -m imagekit_tpu_torch.tools.band_probe --sanitize
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from imagekit_tpu_torch.ops import _build

# name -> (what it takes out or changes, [(exact text, replacement)])
VARIANTS = {
    "committed": ("the body as committed", []),
    "no_pass1_loads": (
        "pass 1 issues no global loads (the ring is never filled)",
        [("if (left > 0) IK_CP_ASYNC(ring + ws * stride, src, sizeof(V));",
          "(void)src;")]),
    "no_pass1": (
        "pass 1 does nothing (no loads, widens or FMAs; the tile is zeroed)",
        [("      body.start();\n", ""),
         ("      while (i < c1) {", "      while (false) {")]),
    "no_pass2_taps": (
        "pass 2 reads no taps and no tile (it stores zeros)",
        [("for (int t = 0; t < P.T; t += 4) step(",
          "for (int t = 0; t < 0; t += 4) step(")]),
    "tr8_one_block": (
        "8-row tiles at one block an SM (RGB rows; planes keep their TR)",
        [("return (threads == 256 ? 110 : 54) * 1024;",
          "return (threads == 256 ? 225 : 54) * 1024;")]),
    "tr4_one_block_rgba": (
        "4-row tiles at one block an SM for RGBA rows (137 KB; RGB rows "
        "keep TR 4 at two blocks, planes their TR)",
        [("return (threads == 256 ? 110 : 54) * 1024;",
          "return (threads == 256 ? 140 : 54) * 1024;")]),
}

K2_V = ((1080, 225), (1072, 223), (1064, 222), (1056, 220))
K2_H = ((1920, 400), (1904, 397), (1888, 393), (1872, 390))
# (source w, h, target w, h) of the demoted head's four slots
K3_GEOMS = ((1920, 1080, 400, 225), (1904, 1072, 397, 223),
            (1888, 1064, 393, 222), (1872, 1056, 390, 220))


def _variant_source(body: str, patches) -> str:
    for old, new in patches:
        if body.count(old) != 1:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        body = body.replace(old, new)
    return body


def build_variants(names) -> dict:
    """One library of the K2/K3/K4 entries per variant, built by one nvcc
    per source, all started together; returns name -> ctypes.CDLL."""
    import ctypes

    csrc = Path(_build.__file__).resolve().parents[1] / "csrc"
    body = (csrc / "resize_band.cuh").read_text()
    root = _build.BUILD_DIR / "probe"
    shutil.rmtree(root, ignore_errors=True)
    nvcc = _build._nvcc()
    arch = "-gencode=arch=compute_90a,code=sm_90a"
    units = ("resize_strip.cu", "resize_planes.cu")
    procs = []
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        (d / "resize_band.cuh").write_text(
            _variant_source(body, VARIANTS[name][1]))
        for u in units:
            shutil.copy(csrc / u, d / u)
            procs.append(subprocess.Popen(
                [nvcc, arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c",
                 str(d / u), "-o", str(d / (u + ".o"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate(timeout=600)[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{out[-4000:]}")
    libs = {}
    for name in names:
        d = root / name
        so = d / "libik_probe.so"
        subprocess.run([nvcc, arch, "-shared", "-o", str(so),
                        *(str(d / (u + ".o")) for u in units)], check=True,
                       capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(so))
        _build.configure_band(lib)
        libs[name] = lib
    return libs


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one call of ``fn`` (the kernels it launches, summed
    by ``torch.profiler`` over ``reps`` calls after a warm-up). A trace
    with fewer device records than calls, which CUPTI returns now and then,
    is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.time_range.elapsed_us() for e in events)
        if total > 0 and len(events) >= reps:
            return total / reps / 1e3
    raise RuntimeError("the profiler's traces held fewer device records "
                       "than calls")


def _stack(slots, bi, bo, weights, dev):
    w = np.zeros((len(slots), bo, bi), np.float32)
    for u, args in enumerate(slots):
        w[u] = weights(*args)
    return torch.from_numpy(w).to(dev)


def k2_case(dev="cuda", channels: int = 3, strip: int = 0,
            smooth: bool = False, batch: int = 32):
    """The flagship RGB batch (or, with 4 ``channels``, the same batch as
    RGBA) and its stacks (edge rows replicated, as the engine builds
    them); returns a call of ``rgb_resize`` (``rgba_resize``), in column
    strips of ``strip`` output columns where that is not 0. Samples are
    uniform random bytes, or with ``smooth`` a ramp with mild noise, as
    photographs are."""
    from imagekit_tpu_torch.ops import resize_strip
    from imagekit_tpu_torch.ops.weights import padded_weights

    def edge(ti, to, bi, bo):
        w = padded_weights(ti, to, bi, bo)
        if to < bo:
            w[to] = w[to - 1]
        return w

    wv = _stack([(ti, to, 1088, 240) for ti, to in K2_V], 1088, 240, edge,
                dev)
    wh = _stack([(ti, to, 1920, 400) for ti, to in K2_H], 1920, 400, edge,
                dev)
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, 1088, 1920 * channels)
    if smooth:
        ramp = torch.linspace(0, 200, shape[2], device=dev)
        x = (ramp + 8 * torch.randn(shape, generator=g, device=dev)).clamp(
            0, 255).to(torch.uint8)
    else:
        x = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8)
    vidx = torch.arange(batch, dtype=torch.int32, device=dev) % 4
    hidx = (vidx + 1) % 4
    tabs = resize_strip.resize_tables(wv, wh)
    resize = (resize_strip.rgba_resize if channels == 4
              else resize_strip.rgb_resize)
    return lambda: resize(x, wv, wh, vidx, hidx, bands=tabs, strip=strip)


def wide_case(dev="cuda", channels: int = 3):
    """Rows too wide for a tile of whole rows, which K2 takes in column
    strips: a 9600x2400 RGB image -> 1280x320 at its exact shape (B=1,
    28,800-element rows), or with 4 ``channels`` the plain head's 8192 RGBA
    bucket, 7200x1800 images -> 400x100 in 1872x8192 -> 128x400 (B=4);
    returns a call of ``rgb_resize`` (``rgba_resize``)."""
    from imagekit_tpu_torch.ops import resize_strip
    from imagekit_tpu_torch.ops.weights import exact_stacks, padded_weights

    if channels == 3:
        B, (wv, wh) = 1, exact_stacks(2400, 9600, 320, 1280)
        resize = resize_strip.rgb_resize
    else:
        B = 4
        wv = padded_weights(1800, 100, 1872, 128)[None]
        wh = padded_weights(7200, 400, 8192, 400)[None]
        resize = resize_strip.rgba_resize
    wv, wh = (torch.from_numpy(w).to(dev) for w in (wv, wh))
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(0, 256, (B, wv.shape[2], wh.shape[2] * channels),
                      generator=g, device=dev, dtype=torch.uint8)
    idx = torch.zeros(B, dtype=torch.int32, device=dev)
    tabs = resize_strip.resize_tables(wv, wh)
    return lambda: resize(x, wv, wh, idx, idx, bands=tabs)


def k3_case(dev="cuda"):
    """The demoted head's Y, Cb and Cr at B=32; returns a call of
    ``resize_planes3``."""
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops.resize_strip import resize_tables
    from imagekit_tpu_torch.ops.weights import (
        combined_chroma_weights,
        padded_weights,
    )

    def luma(sw, sh, ow, oh, axis):
        return (padded_weights(sh, oh, 1088, 240) if axis == 0
                else padded_weights(sw, ow, 1920, 400))

    def chroma(sw, sh, ow, oh, axis):
        return (combined_chroma_weights((sh + 1) // 2, sh, oh, 544, 240)
                if axis == 0 else
                combined_chroma_weights((sw + 1) // 2, sw, ow, 960, 400))

    stacks = []
    for fn, ih, iw in ((luma, 1088, 1920), (chroma, 544, 960)):
        stacks.append(_stack([(*g, 0) for g in K3_GEOMS], ih, 240, fn, dev))
        stacks.append(_stack([(*g, 1) for g in K3_GEOMS], iw, 400, fn, dev))
    g = torch.Generator(device=dev).manual_seed(1)
    planes = [torch.randint(0, 256, (32, h, w), generator=g, device=dev,
                            dtype=torch.uint8)
              for h, w in ((1088, 1920), (544, 960), (544, 960))]
    vidx = torch.arange(32, dtype=torch.int32, device=dev) % 4
    tabs = (resize_tables(*stacks[:2]), resize_tables(*stacks[2:]))
    return lambda: rp.resize_planes3(planes, stacks, vidx, bands=tabs)


def cmyk_case(dev="cuda"):
    """K6's two launches on the four-component pixel decode of the
    committed progressive 1080p CMYK fixture."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.ops import dct

    data = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
            / "cmyk_1080p_q80_progressive.jpg").read_bytes()
    return lambda: dct.frame_pixels(
        jpeg_abi.decode4(loader.load(), data), torch.device(dev))


def sanitize_cases() -> int:
    """Each small case once, synchronised (see the module docstring)."""
    _build.load()
    cases = {"K2 rgb B=2": k2_case(batch=2),
             "K2 rgba B=2": k2_case(channels=4, batch=2),
             "K2 rgb B=2 strips of 128": k2_case(strip=128, batch=2),
             "K2 rgba B=2 strips of 128": k2_case(channels=4, strip=128,
                                                  batch=2),
             "K6 CMYK pixel decode (two launches)": cmyk_case()}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        print(f"ran {name}", flush=True)
    return 0


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/band_probe.json")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--strips", default="",
                    help="output columns a block of K2's column strips "
                         "takes, comma-separated: each adds the RGB and RGBA "
                         "cases in strips of that width")
    ap.add_argument("--smooth", action="store_true",
                    help="K2's batches a ramp with mild noise, not uniform "
                         "random bytes")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the committed body once on small cases only, "
                         "for compute-sanitizer")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("band_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.sanitize:
        return sanitize_cases()
    names = args.variants.split(",")
    print(f"card: {card()}", flush=True)
    libs = build_variants(names)
    smooth = args.smooth
    cases = {"K2 rgb B=32": k2_case(smooth=smooth),
             "K2 rgba B=32": k2_case(channels=4, smooth=smooth),
             "K3 Y+Cb+Cr B=32": k3_case()}
    for sw in filter(None, args.strips.split(",")):
        cases[f"K2 rgb B=32 strips of {sw}"] = k2_case(strip=int(sw),
                                                       smooth=smooth)
        cases[f"K2 rgba B=32 strips of {sw}"] = k2_case(
            channels=4, strip=int(sw), smooth=smooth)
    cases["K2 rgb 9600x2400 B=1 (strips)"] = wide_case()
    cases["K2 rgba 8192 bucket B=4 (strips)"] = wide_case(channels=4)
    saved = _build._lib
    rows = []
    try:
        for name in names:
            _build._lib = libs[name]  # the wrappers launch through _build.load()
            row = {"variant": name, "what": VARIANTS[name][0]}
            for case, fn in cases.items():
                row[case] = device_ms(fn)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        _build._lib = saved
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "timing": "device ms per "
                               "call, torch.profiler over 20 calls",
                               "samples": "smooth" if smooth else "random",
                               "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
