"""Mutation fuzz of the port's native decoders, and of what the app makes
of their errors.

The port of the reference's ``tools/fuzz_codecs.py``. Seeds of every
layout the native sources decode are written here without Pillow
(:mod:`imagekit_tpu_torch.tools.sources`; the CMYK, arithmetic and
lossless JPEGs by the numpy writers of ``tests/fixtures/``, loaded by
their path where the checkout has them), and each iteration mutates one
seed (the kinds in turn, each kind's seeds in turn) from a seeded
generator (bytes flipped, the file cut short, a block
overwritten, or the head of one file spliced to the tail of another) and
feeds it to every entry of its kind:

- the pinned decoders, as the reference fuzzes them: ``jpeg_abi.parse``,
  ``decode``, ``decode_lowfreq``, ``decode_lowfreq_i8`` (a cap of 4
  escapes), ``decode_planes``; ``png.decode``; the GIF and BMP decodes;
  ``tiff.decode``; ``vp8.decode_yuv420``, ``decode_lossless`` and
  ``decode_rgb``;
- the port-only sources: ``raster_decode`` and ``bcn_ext_decode`` (QOI,
  DDS), ``jpeg4_decode`` (``decode4``, fed whole and in Pillow's blocks,
  ``decode_libjpeg``, ``decode_lossless``), ``bmp_ext_decode`` and
  ``tiff_ext_decode`` (the layouts the pinned decoders refuse),
  ``av1_decode``, ``avif_yuv_rgb`` and ``avif_scale`` (AVIFs through
  ``avif_native`` and ``avif_libavif``: 4:2:0, alpha, monochrome, no
  ``nclx``, an item smaller than its ``ispe``).

A decoder's own refusal (``NativeJpegError``, ``ValueError`` or an
``ImageKitError``) is the expected outcome. Then the app's view of the
same bytes: the fetch stage's header parse (``fetch.fetch_source``) and
``codecs.decode_bytes`` may raise only what the app answers 400, an
``ImageKitError`` other than ``NotPortedError`` (501); any other exception
would be a 500. Each such exception, and any other exception out of an
entry, is a finding: printed, counted in the summary, and the exit code is
1. A memory error is ASan's report and the process aborts.

    python -m imagekit_tpu_torch.tools.fuzz_codecs --asan --iters 2000

``--asan`` builds the sources with AddressSanitizer and UBSan
(``loader.sanitizer_build``, into ``build/imagekit_tpu_torch/``) and runs
the fuzz in a child process with the ASan runtime preloaded
(``loader.sanitizer_env``); ``--lib PATH`` loads a given build in this
process instead; neither runs on the optimised library. ``--save DIR``
writes each input to ``DIR/last`` before it is fed, so that an abort
leaves its reproducer there, and keeps each finding's input as
``DIR/<iteration>.<kind>``. The reproducers of earlier findings
(``tests/fixtures/fuzz/``) are seeds of every run. The last line is a
JSON summary: iterations, calls a kind, calls an entry, findings.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
FIXTURES = ROOT / "tests" / "fixtures"
#: the reproducers of earlier findings, seeds of every run
REPRODUCERS = FIXTURES / "fuzz"


def _writer(name: str):
    """``tests/fixtures/<name>.py`` by its path, or None outside a
    checkout."""
    path = FIXTURES / f"{name}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(name, mod)  # the writers import their siblings
    spec.loader.exec_module(mod)
    return mod


def _patched(data: bytes, box: bytes, at: int, value: bytes) -> bytes:
    i = data.index(box) + len(box) + at
    return data[:i] + value + data[i + len(value):]


def _rgb_tiff(img: np.ndarray, compression: int, strip: bytes) -> bytes:
    """An RGB TIFF of one strip coded by the pinned decoder's
    ``compression`` (8 deflate, 32773 PackBits)."""
    from imagekit_tpu_torch.tools.sources import tiff_ifd

    h, w = img.shape[:2]
    return tiff_ifd(w, h, [(258, 3, 3, None), (259, 3, 1, compression),
                           (262, 3, 1, 2), (277, 3, 1, 3)], strip,
                    struct.pack("<HHH", 8, 8, 8))


def make_corpus() -> List[Tuple[str, bytes]]:
    """(kind, bytes) seeds; odd sizes on purpose (a mod-4 slip in the
    reference's GIF interlacer escaped a corpus of multiples of 8)."""
    from imagekit_tpu_torch.codecs import avif_encode
    from imagekit_tpu_torch.tools import sources as S

    rng = np.random.default_rng(0)
    pic = S.soak_image(rng, 128, 99)
    rgba = np.dstack([pic, rng.integers(0, 256, pic.shape[:2],
                                        dtype=np.uint8)])
    small = pic[:45, :61]
    corpus = [
        ("jpeg", S.make_jpeg(0, 85, image=lambda _: pic)),
        ("jpeg", S.make_jpeg(0, 90, image=lambda _: pic, samp=(1, 1))),
        ("jpeg", S.make_jpeg(0, 80, image=lambda _: pic, gray=True)),
        ("png", S.make_png(pic)),
        ("png", S.make_png(rgba)),
        ("png", S.make_png_palette(pic)),
        ("gif", S.make_gif(pic)),
        ("bmp", S.make_bmp(pic)),
        ("bmp", S.make_bmp_fields(rgba, "v5_bgra")),
        ("bmp", S.make_bmp_fields(pic, "565")),
        ("bmp", S.make_bmp_fields(pic, "core24")),
        ("tiff", S.make_tiff(pic)),
        ("tiff", _rgb_tiff(pic, 32773, S.packbits(pic.reshape(99, -1)))),
        ("tiff", _rgb_tiff(pic, 8, zlib.compress(pic.tobytes()))),
        ("tiff", S.make_cmyk_tiff(pic)),
        ("tiff", S.make_bilevel_tiff(pic[..., 0] > 128)),
        ("tiff", S.make_jpeg_tiff(pic, 80, rows=32)),
        ("tiff", S.make_jpeg_tiff(pic, 80, tile=32)),
        ("webp", S.make_webp(pic, 80)),
        ("webp", S.make_webp_lossless(small)),
        ("webp", S.make_webp_alpha(rgba[:64, :64], 75)),
        ("qoi", S.make_qoi(rgba)),
        ("dds", S.make_dds(rgba[:96, :128], b"DXT1")[0]),
        ("dds", S.make_dds(rgba[:96, :128], b"DXT5")[0]),
    ]
    # the BCn layouts of bcn_ext_decode.cpp: random blocks of BC4, BC5,
    # BC6H and BC7 (DXGI 80, 83, 95, 98), 32 x 32
    for dxgi, block in ((80, 8), (83, 16), (95, 16), (98, 16)):
        body = rng.integers(0, 256, 64 * block, dtype=np.uint8).tobytes()
        corpus.append(("dds", S.dds_file(32, 32, body, dxgi=dxgi)))
    avif = avif_encode.encode_rgb(small, 70)
    corpus += [
        ("avif", avif),
        ("avif", avif_encode.encode_rgb(rgba[:33, :47], 70)),
        ("avif", avif_encode.encode_y400_studio(small[..., 0], 70)),
        # no nclx: libavif's read and YUV -> RGB (avif_libavif)
        ("avif", avif.replace(b"colrnclx", b"freenclx", 1)),
        # BT.2020 matrix: outside the native path's matrices
        ("avif", _patched(avif, b"colrnclx", 4, b"\x00\x09")),
        # an ispe twice the coded size: libavif's scaling (avif_scale)
        ("avif", _patched(avif, b"ispe", 4, (122).to_bytes(4, "big")
                          + (90).to_bytes(4, "big"))),
    ]
    jw, aw, lw = (_writer(n) for n in ("jpeg_writer", "jpeg_arith_writer",
                                       "jpeg_lossless_writer"))
    if jw is not None:
        p = pic[:48, :64]
        s420 = ((2, 2), (1, 1), (1, 1))
        q, tabs, tq = jw.coefficients(p, 85, s420)
        corpus += [
            ("jpeg", jw.write(q, tabs, 64, 48, s420, tq, restart=2)),
            ("jpeg4", jw.write(q, tabs, 64, 48, s420, tq, interleaved=False)),
        ]
        four = np.dstack([p, p[..., :1]])
        scmyk = ((2, 2), (1, 1), (1, 1), (2, 2))
        q4, tabs4, tq4 = jw.coefficients(four, 85, scmyk, colour="raw")
        corpus.append(("jpeg4", jw.write(q4, tabs4, 64, 48, scmyk, tq4)))
        if aw is not None:
            corpus += [
                ("jpeg4", aw.write(q, tabs, 64, 48, s420, tq, restart=2)),
                ("jpeg4", aw.write(q, tabs, 64, 48, s420, tq,
                                   progressive=True)),
            ]
        if lw is not None:
            corpus += [
                ("jpeg4", lw.write([p[..., 0]], 64, 48, ((1, 1),),
                                   predictor=1)),
                ("jpeg4", lw.write(lw.subsample(p, s420), 64, 48, s420,
                                   predictor=4, pt=1)),
            ]
    return corpus


def kind_of(data: bytes) -> str:
    """The corpus kind of a file, by its format."""
    from imagekit_tpu_torch.codecs import guess_format

    return {"jpeg": "jpeg", "png": "png", "gif": "gif", "bmp": "bmp",
            "tiff": "tiff", "webp": "webp", "qoi": "qoi", "dds": "dds",
            "avif": "avif"}.get(guess_format(data).value, "other")


def entries() -> Dict[str, List[Tuple[str, Callable]]]:
    """Each kind's entries, by name."""
    from imagekit_tpu_torch.codecs import (
        avif_libavif, avif_native, dds, misc, png, qoi, tiff, vp8,
    )
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader

    lib = loader.load()
    block = jpeg_abi.PILLOW_BLOCK
    fed = [("jpeg_abi.decode4", lambda d: jpeg_abi.decode4(lib, d)),
           ("jpeg_abi.decode4/fed", lambda d: jpeg_abi.decode4(lib, d, block)),
           ("jpeg_abi.decode_libjpeg/0",
            lambda d: jpeg_abi.decode_libjpeg(lib, d, 0)),
           ("jpeg_abi.decode_libjpeg/fed",
            lambda d: jpeg_abi.decode_libjpeg(lib, d, block))]
    return {
        "jpeg": [
            ("jpeg_abi.parse", lambda d: jpeg_abi.parse(lib, d)),
            ("jpeg_abi.decode", lambda d: jpeg_abi.decode(lib, d)),
            ("jpeg_abi.decode_lowfreq",
             lambda d: jpeg_abi.decode_lowfreq(lib, d, 2)),
            # a tiny escape cap works the count-past-cap bookkeeping
            ("jpeg_abi.decode_lowfreq_i8",
             lambda d: jpeg_abi.decode_lowfreq_i8(lib, d, 3, esc_cap=4)),
            ("jpeg_abi.decode_planes",
             lambda d: jpeg_abi.decode_planes(lib, d)),
            *fed],
        "jpeg4": [*fed, ("jpeg_abi.decode_lossless",
                         lambda d: jpeg_abi.decode_lossless(lib, d))],
        "png": [("png.decode", png.decode)],
        "gif": [("misc.decode_gif", misc.decode_gif)],
        "bmp": [("misc.decode_bmp", misc.decode_bmp)],
        "tiff": [("tiff.decode", lambda d: tiff.decode(d, device="cpu"))],
        "webp": [("vp8.decode_yuv420", vp8.decode_yuv420),
                 ("vp8.decode_lossless", vp8.decode_lossless),
                 ("vp8.decode_rgb", vp8.decode_rgb)],
        "qoi": [("qoi.decode", qoi.decode)],
        "dds": [("dds.decode", dds.decode)],
        "avif": [("avif_native.decode_rgb", avif_native.decode_rgb),
                 ("avif_native.decode_yuv_studio",
                  avif_native.decode_yuv_studio),
                 ("avif_libavif.decode_pillow_rgb",
                  avif_libavif.decode_pillow_rgb)],
        "other": [],
    }


def mutate(rng: np.random.Generator, base: bytes, other: bytes) -> bytes:
    """One of: 1-15 bytes overwritten, the file cut short, a block of up to
    64 random bytes, or ``base``'s head spliced to ``other``'s tail."""
    data = bytearray(base)
    op = int(rng.integers(0, 4))
    if op == 0:
        for _ in range(int(rng.integers(1, 16))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
    elif op == 1:
        data = data[: int(rng.integers(1, len(data)))]
    elif op == 2:
        a = int(rng.integers(0, len(data)))
        b = min(len(data), a + int(rng.integers(1, 64)))
        data[a:b] = rng.integers(0, 256, b - a, dtype=np.uint8).tobytes()
    else:
        cut = int(rng.integers(1, len(data)))
        data = data[:cut] + other[int(rng.integers(0, len(other))):]
    return bytes(data)


class _Bytes:
    """A fetcher of one body, for the fetch stage's parse."""

    def __init__(self, data: bytes):
        self.data = data

    async def fetch(self, url: str):
        from imagekit_tpu_torch.fetch import _BodyStream

        data = self.data

        class Body(_BodyStream):
            async def content_length(self):
                return len(data)

            async def chunks(self):
                yield data

        return 200, "image/x-fuzz", Body()


def _app_errors(data: bytes) -> List[str]:
    """What the app would answer with a 500 or a 501 for ``data``: the
    exceptions of the fetch stage's parse and of ``decode_bytes`` that are
    not an ``ImageKitError`` other than ``NotPortedError``."""
    from imagekit_tpu_torch.codecs import decode_bytes
    from imagekit_tpu_torch.config import DEFAULT_MAX_INPUT_SIZE
    from imagekit_tpu_torch.errors import ImageKitError, NotPortedError
    from imagekit_tpu_torch.fetch import fetch_source

    out = []
    for stage, fn in (
            ("fetch", lambda: asyncio.run(fetch_source(
                "fuzz", DEFAULT_MAX_INPUT_SIZE, fetcher=_Bytes(data)))),
            ("decode_bytes", lambda: decode_bytes(data, device="cpu"))):
        try:
            fn()
        except NotPortedError as e:
            out.append(f"{stage}: 501 {e}")
        except ImageKitError:
            pass
        except Exception as e:  # noqa: BLE001 - the finding itself
            out.append(f"{stage}: {type(e).__name__}: {e}")
    return out


def feed(kind: str, data: bytes, table, counts) -> List[str]:
    """Every entry of ``kind`` and the app's view on ``data``; returns the
    findings."""
    from imagekit_tpu_torch.codecs.native.jpeg_abi import NativeJpegError
    from imagekit_tpu_torch.errors import ImageKitError

    found = []
    for name, fn in table[kind]:
        counts[name] = counts.get(name, 0) + 1
        try:
            fn(data)
        except (NativeJpegError, ValueError, ImageKitError):
            pass  # the decoder refused it: the expected outcome
        except Exception as e:  # noqa: BLE001 - the finding itself
            found.append(f"{name}: {type(e).__name__}: {e}")
    return found + _app_errors(data)


def fuzz(iters: int, seed: int, save=None) -> dict:
    corpus = make_corpus()
    if REPRODUCERS.is_dir():
        for path in sorted(REPRODUCERS.iterdir()):
            data = path.read_bytes()
            corpus.append((kind_of(data), data))
    if save is not None:
        save = Path(save)
        save.mkdir(parents=True, exist_ok=True)
    table = entries()
    by_kind: Dict[str, List[bytes]] = {}
    for kind, data in corpus:
        by_kind.setdefault(kind, []).append(data)
    order = sorted(by_kind)
    rng = np.random.default_rng(seed)
    kinds: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    findings = []
    for i in range(iters):
        # the kinds in turn, each kind's seeds in turn
        kind = order[i % len(order)]
        seeds = by_kind[kind]
        base = seeds[(i // len(order)) % len(seeds)]
        other = corpus[int(rng.integers(0, len(corpus)))][1]
        data = mutate(rng, base, other)
        if save is not None:
            (save / "last").write_bytes(data)
        kinds[kind] = kinds.get(kind, 0) + 1
        for f in feed(kind, data, table, counts):
            findings.append({"iter": i, "kind": kind, "finding": f})
            print(f"FINDING iter {i} ({kind}): {f}", flush=True)
            if save is not None:
                (save / f"{i}.{kind}").write_bytes(data)
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{iters} mutations", flush=True)
    return {"iters": iters, "seed": seed, "corpus": len(corpus),
            "kinds": kinds, "entries": counts, "findings": findings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--asan", action="store_true",
                    help="build the sanitizer library and fuzz it in a "
                         "child process")
    ap.add_argument("--lib", help="load this build of the native sources")
    ap.add_argument("--save", help="a directory for the input in flight "
                                   "and each finding's")
    args = ap.parse_args(argv)
    from imagekit_tpu_torch.codecs.native import loader

    if args.asan:
        so = loader.sanitizer_build()
        rest = [a for a in (argv if argv is not None else sys.argv[1:])
                if a != "--asan"]
        return subprocess.run(
            [sys.executable, "-m", "imagekit_tpu_torch.tools.fuzz_codecs",
             "--lib", str(so), *rest],
            env=loader.sanitizer_env(), cwd=ROOT).returncode
    if args.lib is None:
        ap.error("name the build to fuzz: --asan, or --lib PATH")
    loader.load(Path(args.lib))
    summary = fuzz(args.iters, args.seed, args.save)
    print(f"fuzz complete: {summary['iters']} mutations over "
          f"{summary['corpus']} seeds, {len(summary['findings'])} findings")
    print(json.dumps(summary))
    return 1 if summary["findings"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
