#!/usr/bin/env python3
"""Smoke run of imagekit_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``imagekit_tpu_torch/csrc`` and
drives the port's paths through ``BatchedEngine.transform`` on the card,
from 1920x1080 sources: a JPEG resized to fit 400 px and encoded as WebP
q80 (K1); an RGB PNG to WebP q80 or JPEG q80 (K2); a JPEG re-encoded as
JPEG q80 (the jxc transcode on K1, and its escape-dense demotion through
the RGB head on K3); a JPEG to a 1280 px WebP (the k=8 head on K4);
escape-dense JPEGs to WebP on the int16 transport (K1's int16 entry at
k<8, K4 at k=8); a lossy WebP to WebP or JPEG (K2 on the decoded Y, Cb
and Cr planes); an RGBA PNG to WebP or JPEG (the plain RGB head on K2's
four-channel entry); BMP, TIFF and GIF sources; requests with no
resize (one image's decode and encode: from a JPEG, the pixel decode on
K3); AVIF output through every one of those heads (the first-party AV1
intra encoder on the host); images beyond the bucket ladder (their
exact-shape path, K2 in column strips where a row is too wide for a tile of
whole rows); and JPEG sources beyond 4:2:0 (4:4:4, 4:2:2, 4:4:0,
grayscale: the JPEG pixel decode on K3, then the RGB head on K2); and
the sources the reference decodes with Pillow (ICO, PNM, QOI, DDS, CMYK
and YCCK JPEGs baseline and progressive, BMP and TIFF layouts its native
decoders refuse, JPEG-compressed TIFFs, and the TIFF layouts it still
decoded with Pillow: old-style, planar and extra-sample JPEG pages,
16-bit CMYK, float32 rasters, FillOrder 2):

1. environment: the card (``nvidia-smi``), torch and CUDA versions;
2. build: the kernel library (one nvcc per source, started together) and,
   beside it, the port's host codecs (one g++ per source, into
   ``build/imagekit_tpu_torch``), 16
   synthesized 1080p JPEGs, the same 16 images as PNGs (written with
   ``zlib`` and ``struct``: no Pillow) and 8 of them as lossy WebPs (the
   port's own VP8 encoder);
3. K1 against its plain PyTorch version on the card: one launch for Y, Cb
   and Cr at B in {1, 32}, k in {2, 4}, both epilogues, on the split-int8
   batch the engine packs from synthesized 1080p JPEGs (escapes included)
   with its folded stacks and band tables; at B=32, k=2 the device time
   of the kernel, of its plain version and of a ``torch.einsum``
   yardstick, and the bound computed from the batch;
4. K2 against its plain PyTorch version on the card: the three channels
   of an interleaved 1088x1920 batch -> 240x400 in one launch at B in
   {1, 32} with vidx != hidx (default epilogue), the rgbyuv and rgbjpg
   heads on it, and a 544x960 -> 120x200 plane with the yuvjpg luma and
   chroma remaps (affine + centred epilogues); the device time of each at
   B=32, an einsum yardstick and the bound;
5. K3 and K4 against their plain PyTorch versions on the card: the
   demoted RGB head's luma 1088x1920 and two chroma 544x960 planes ->
   240x400 in one launch at B in {1, 32} with four vidx slots, u8 (K3) and
   f32 (K4); the device time of each at B=32, an einsum yardstick and the
   bound, and the H2D of one B=32 int16 batch of the demoted head;
6. the JPEG engine slice: >=32 concurrent requests over 16 distinct
   JPEGs, outputs checked, K1's launch count checked against the batch
   count (one launch per batch), one batch's planes checked against the
   plain head, requests/s and p50/p99 latency;
7. the PNG engine slice: 64 WebP and 64 JPEG requests at once over the 16
   PNGs, outputs decoded to their size, K2's launch count checked against
   the batch count (one launch per batch), one batch's planes and one
   batch's levels checked against the plain heads, requests/s, p50/p99
   and the host stages;
8. the JPEG -> JPEG engine slice, three rounds, counts reset before each:
   64 concurrent w=400 requests over the 16 q80 JPEGs (jxc, k=2, one K1
   launch per batch, one batch's levels against
   the plain head with the differing levels counted); 16 w=1280 requests
   (k=8); 16 requests over 4 escape-dense q100 JPEGs, which must demote to
   the RGB head (K3 launches checked against one per demoted batch, one
   batch's RGB against the plain head). Outputs parsed to their size
   (400x225, 1280x720), requests/s, p50/p99 and the host stages;
9. K1's int16 entry against its plain version: the block-grouped int16
   batches the engine packs from the escape-dense JPEGs at B in {1, 32},
   k in {2, 4}, both epilogues; device times and the bound at B=32, k=2;
10. K4 on u8 planes (u8 in, f32 out) against its plain version: the planes
    the k=8 head's 8x8 IDCT makes of an engine batch, 1088x1920 -> 720x1280
    and 2 x 544x960 -> 360x640 in one launch at B in {1, 32}; device
    times and the bound at B=32;
11. K2 on the Y, Cb and Cr views of the flat batch the engine packs from
    decoded 1080p WebPs, one launch, rounded u8 (WebP output) and each
    plane's own remap + centred i8 (JPEG output), at B in {1, 32}; device
    times and the bound at B=32;
12. the engine paths of this slice, five rounds of 32 requests, counts
    reset before each: JPEG -> w=1280 WebP (one K4 launch per batch);
    escape-dense JPEG -> w=400 WebP (one K1 launch per batch) and -> w=1280
    WebP (K4); lossy WebP -> w=400 WebP and -> JPEG (one K2 launch per
    batch). Outputs parsed to their size and format, the last batch of each
    head against the plain head, requests/s, p50/p99, the host stages, and
    the device's idle share from the round, run once, traced;
13. K2's four-channel entry against its plain version: an interleaved
    RGBA batch 1088x1920 -> 240x400 at B in {1, 32}, vidx != hidx, stored
    interleaved; device times, an einsum yardstick, the bound and the H2D
    of the batch at B=32;
14. the engine paths of sources with alpha, of BMP, TIFF and GIF sources
    and of requests with no resize, counts reset before each round: 32
    RGBA PNGs -> w=400 WebP and -> JPEG (one launch of K2's four-channel
    entry per batch, the last batch against the plain head); 4 BMPs, 4
    TIFFs and 4 GIFs -> w=400 WebP (K2, three channels); 16 requests with
    no resize each from a JPEG (one K3 launch per request: the JPEG pixel
    decode), a PNG and a WebP, to WebP and to JPEG. Outputs parsed to
    their size and format, requests/s, p50/p99, the host stages and the
    device's idle share from the round, run once, traced;
15. AVIF output through the engine, one round a head, counts reset before
    each: 2 JPEGs -> w=400 (K1), 2 escape-dense JPEGs -> w=400 (K1's int16
    entry), a 640x360 JPEG -> w=480 (k=8, K4), 2 RGB PNGs -> w=400 (K2,
    rgbyuv), 2 lossy WebPs -> w=400 (K2, ``yuv_resize``), 2 RGBA PNGs ->
    w=400 with their alpha (K2, ``rgba_resize``) and a 320x240 JPEG with no
    resize (K3). Each body's ftyp brand, ispe dims and alpha item checked,
    each batch against the plain head, the AV1 encode seconds a picture,
    the wait in the AVIF thread's queue and the device's idle share (each
    round traced once); the encoder's C engine must have loaded. Then, at
    the default latency budget, 32 JPEG -> w=400 WebP alone and with 2
    AVIF among them (WebP p50/p99), and a burst of 4 AVIF that the AVIF
    lane's admission bound must shed by its rule;
16. images beyond the bucket ladder. K2's column strips first: at the
    flagship shapes (B=32, RGB and RGBA 1088x1920 -> 240x400) in strips of
    128 columns against the whole-row body (max |d| = 0) and the plain
    version, timed; on the 28,800-element rows of a 9600x2400 RGB image ->
    1280x320 (B=1, the exact stacks) and at the plain head's 8192 RGBA
    bucket (B=4), where whole rows do not fit, against the plain version,
    timed, with an einsum yardstick and the bound; the host build and
    upload of the exact path's dense stacks. Then, counts reset before
    each round: a 1440x12000 page PNG -> w=400 WebP and JPEG, a 9600x2400
    q80 JPEG (made by the port's encoder past the encode ladder) -> w=1280
    WebP (K3's pixel decode, K2 in strips), two 7200x1800 RGBA PNGs ->
    w=400 WebP (the batched plain head, K2 in strips), a 1080p JPEG ->
    w=9000 JPEG and the 9600x2400 JPEG -> JPEG with no resize; outputs
    parsed to their size, launches checked (strips where the rows need
    them, whole rows where they fit), each exact-shape resize and the RGBA
    batch against the plain version, wall times and host stages;
17. JPEG sources in every chroma layout, from 1080p q80 JPEGs made by the
    port's encoder (``make_jpeg(samp=...)``), counts reset before each
    round: 32 4:4:4 -> w=400 WebP and -> w=400 JPEG, 16 4:2:2 and 16 4:4:0
    -> w=400 WebP (one K3 launch a request, the pixel decode; one K2 launch
    a batch, the RGB head; no K1), 32 4:2:0 -> w=400 WebP in the same phase
    (K1, the other route, for the cliff between them), 16 4:4:4 -> JPEG and
    4 grayscale -> WebP with no resize (one K3 a request) and one 4:4:4 ->
    w=400 AVIF. Outputs parsed to their size, requests/s, p50/p99, the host
    stages and the idle share; each layout's pixel decode against the plain
    head and against its source image; K3 on the planes of a 4:4:4 and of
    a 4:2:2 pixel decode (B=1, 1080x1920 out) against its plain version,
    timed, with an einsum yardstick and the bound;
18. HTTP ``/sign`` -> ``/img`` for JPEG, PNG and WebP sources and a 4:4:4
    JPEG to WebP, a JPEG to a 1280 px WebP, a JPEG to JPEG, a JPEG to
    AVIF, a JPEG with no sizes, the 1440x12000 page PNG at w=400, a PNG
    ``/upload`` and an RGBA PNG ``/upload`` with no sizes through the
    port's app, where aiohttp is installed;
19. the sources the reference decodes with Pillow, made here without
    Pillow (seeded P6, RGBA QOI of runs and RGB/RGBA chunks, DXT1 and DXT5
    DDS from a numpy block encoder, ICOs of a 256x256 PNG entry and a
    48x48 BMP entry) and read from the committed 1080p CMYK JPEG
    (``tests/fixtures/cmyk_1080p_q80.jpg``; YCCK by its APP14 flag),
    each decode checked against its source or its encoder's own plain
    decode; counts reset before each round, each round run once, traced:
    16 ICOs -> w=64 WebP and 16 RGBA QOIs -> w=400 WebP (K2's four-channel
    entry a batch), 16 P6 -> w=400 WebP and JPEG (K2 a batch), 8 DXT1 + 8
    DXT5 2048x2048 DDS -> w=400 WebP (K2 four-channel), 16 CMYK -> w=400
    WebP and JPEG (two K3 launches a request, the four-component pixel
    decode, and K2 a batch) and -> JPEG with no resize (K3 only), 4 YCCK
    -> w=400 WebP: requests/s, p50/p99, host stages, idle share. K3 on the
    four planes of a CMYK decode (C 1088x1920, M, Y, K 544x960 -> 1088x1920,
    B=1) against its plain version, timed, with an einsum yardstick and
    the bound;
20. the BMP, TIFF and progressive CMYK sources the reference still hands
    to Pillow: the committed Group 4 A4 page (2480x3508, 300 dpi,
    ``tests/fixtures/g4_a4_300dpi.tif``) and the same page as an
    uncompressed 1-bit TIFF, 1080p CMYK PackBits TIFFs, 32 bpp BGRA
    BI_BITFIELDS (v5 header), 16 bpp 5-6-5 and BITMAPCOREHEADER 24 bpp
    BMPs, all written here, and the committed progressive 1080p CMYK JPEG
    (``tests/fixtures/cmyk_1080p_q80_progressive.jpg``; YCCK by its APP14
    flag), each decode checked against its source (the progressive one's
    coefficients against its baseline twin's, its pixels on the card
    against the host's plain decode); counts reset before each round, each
    round run once, traced: 16 G4 and 16 1-bit pages -> w=400 WebP, 16
    CMYK TIFFs -> w=400 JPEG, 16 of each BMP -> w=400 WebP (K2 a batch,
    four channels for BGRA), 16 progressive CMYK -> w=400 WebP and -> JPEG
    with no resize, 4 progressive YCCK -> w=400 WebP (two K3 launches a
    request): requests/s, p50/p99, host stages (the decode ms a request),
    idle share. K3 on the four planes of the progressive CMYK decode
    against its plain version (max |d| 0), timed, with an einsum
    yardstick and the bound;
21. JPEG-compressed TIFFs: the committed Pillow-written 1080p RGB (16-row
    strips) and CMYK (8-row strips) files
    (``tests/fixtures/tiff_jpeg_*_1080p_q80.tif``), and, written here
    without Pillow (``make_jpeg_tiff``: the port's encoder a segment, the
    DQT in ``JPEGTables``), a 1080p YCbCr 4:2:0 file in 16-row strips and
    in 256x256 tiles, a gray one and an A4 300 dpi YCbCr page in 16-row
    strips; each decode checked against its picture and, on the card,
    against the host's plain decode; the A4 page's stack bytes and their
    build + upload time; counts reset before each round, each round run
    once, traced: RGB -> w=400 WebP, the strips -> w=400 JPEG and WebP, the
    tiles -> WebP, CMYK -> WebP, gray -> JPEG with no resize, the A4 page
    -> w=400 WebP (one K3 launch a page, two for CMYK, never one a strip;
    one K2 launch a batch; K3's column strips counted): requests/s,
    p50/p99, host stages, idle share. K3 on the 1080p strip page's
    block-diagonal stacks against its plain version, timed, with an einsum
    yardstick and the bound;
22. the TIFF layouts the reference still decoded with Pillow, written here
    without Pillow: a 1080p old-style JPEG page (JFIF behind 513/514), a
    planar RGB JPEG page in 16-row strips, the committed CMYK JPEG TIFF
    rewritten as RGB with an unspecified extra sample, a 16-bit CMYK page,
    a float32 elevation raster (deflate, floating-point predictor) and the
    committed A4 G4 page in FillOrder 2; each decode checked against its
    picture (exactly for the sample layouts) and, for the JPEG pages,
    against the host's plain decode; counts reset before each round, each
    round run once, traced, -> w=400 WebP (the planar page -> JPEG): one K3
    launch an old-style or planar page, two an extra-sample page, none for
    the sample layouts, one K2 launch a batch; requests/s, p50/p99, host
    stages, idle share. K3 at the old-style page's replication stacks
    against its plain version (max |d| 0), timed, with an einsum yardstick
    and the bound;
23. the DDS and JPEG layouts the reference still decoded with Pillow,
    written here without Pillow: DDS textures of the sizes games and tools
    ship (2048x2048 BC7 in mode 6 fitted to a picture, BC6H in mode 11
    and a signed BC5 normal map; 1024x1024 BC4, R8G8B8A8 and an 8-bit
    palette), each decode checked exactly against the numpy model of its
    blocks; 1080p JPEGs from ``tests/fixtures/jpeg_writer.py`` (4:1:1, Cb
    1x1 with Cr 2x1, 4:2:0 and 4:4:4 in one scan a component), each checked
    against its picture and against the host's plain decode; counts reset
    before each round, each round run once, traced: the RGB and the RGBA
    DDS layouts -> w=400 WebP (one K2 launch a batch, three or four
    channels), the JPEGs -> w=400 WebP and -> w=400 JPEG (one K3 launch a
    request, one K2 a batch, no K1): requests/s, p50/p99, host stages, idle
    share. K3 at the 4:1:1 page's identity and replication stacks against
    its plain version (max |d| 0), timed, with an einsum yardstick and the
    bound;
24. arithmetic-coded and lossless JPEGs, written here without Pillow by
    ``tests/fixtures/jpeg_arith_writer.py`` and ``jpeg_lossless_writer.py``
    from one 1080p picture: arithmetic 4:2:0 with restart intervals,
    progressive 4:4:4 with successive approximation and CMYK, lossless
    gray and lossless RGB with G and B at half size; on the card's host
    each entropy decode equal to what its writer was given (coefficients,
    or samples), and the pixels on the card against the host's plain
    decode; counts reset before each round, each round run once, traced,
    -> w=400 WebP (the progressive one -> JPEG): one K3 launch a request
    (two for CMYK, none for lossless gray), one K2 a batch, no K1:
    requests/s, p50/p99, host stages, idle share. K3 at the lossless RGB
    page's replication stacks against its plain version (max |d| 0), timed,
    with an einsum yardstick and the bound;
25. CMYK JPEGs at a 4:1:1-like sampling and at ratios of 3, lossless CMYK
    sampled alike and with C and K at 2x2, a 1080p YCbCr JPEG TIFF page of
    arithmetic-coded strips, a planar RGB JPEG TIFF page whose 36-row
    strips straddle blocks (all written here without Pillow, by the numpy
    writers of ``tests/fixtures/``) and the committed G4 A4 page with
    T6Options 2; each decode on the card checked against the host's plain
    decode (the lossless ones and the G4 page exactly) and against its
    picture; counts reset before each round (16 requests; 8 of the planar
    page), each round run once, traced,
    -> w=400 WebP or JPEG: two K3 launches a CMYK request and a lossless
    CMYK one sampled differently, none sampled alike, one an arithmetic
    TIFF page, one a strip of the planar page, none for the G4 page, one K2
    a batch, no K1: requests/s, p50/p99, host stages, idle share. K3 at the
    4:1:1-like CMYK planes and at the lossless CMYK page's replication
    stacks against its plain version (max |d| 0), timed, with an einsum
    yardstick and the bound;
26. a 1080p CIELab LZW page, a YCbCr 4:2:0 LZW page, a planar 16-bit CMYK
    page, an RGB picture's YCbCr JPEG TIFF page with Orientation 6 and a
    4x3 gray-palette 4 bpp BMP, written here without Pillow; each decode
    on the card checked against the host's plain decode and its picture;
    the CIELab conversion on the card against the host's on all 2^24
    triples (the off-by-one and worse counts); counts reset before each
    round (8 requests), each round run once, traced, -> w=400 WebP: one K3
    launch a YCbCr page and a JPEG TIFF page, one K2 a batch: requests/s,
    p50/p99, host stages, idle share. K3 at the YCbCr page's replication
    stacks against its plain version (max |d| 0), timed, with an einsum
    yardstick and the bound;
27. AVIF sources: the committed 1080p AVIFs (``tests/fixtures/avif``:
    4:2:0, 4:4:4, 4:2:2, RGBA, BT.709, CDEF, loop restoration; a UI
    screenshot and a logo sheet with palette blocks and intra block copy,
    an RGBA logo whose alpha codes palettes; a 10-bit 4:2:0 and a 12-bit
    4:4:4 picture) decoded on the host by the port's AV1 decoder, the
    planes held to libdav1d's digests (the raw 16-bit planes too for 10
    and 12 bits) and the decode timed alone; K2's YUV entries at each
    file's captured batch against their plain versions, timed; rounds of 8
    requests (warmed by 4), counts reset before each, run once, traced,
    -> w=400 WebP or JPEG, the alpha files -> w=160 AVIF: requests/s,
    p50/p99, host stages, idle share;
28. the AVIFs the reference hands to Pillow (``phase_pillow_avifs``);
29. AVIFs whose output frame is an INTER frame (``inter_arrays.json``:
    progressive files, a half-size base key frame under a 1080p INTER
    frame, at 8 bits 4:2:0 and 10 bits 4:4:4; three layers with compound
    prediction; a hidden key frame under the INTER frame libdav1d returns
    first): the port's AV1 decoder with inter prediction on the host, the
    arrays, planes and raw samples held to the digests taken where the
    files were made, the decode timed alone and 8 at once; K2 at each
    file's batch against its plain version; rounds -> w=400 WebP (8 a
    round), one -> w=400 JPEG (8) and one -> w=160 AVIF (2): requests/s,
    p50/p99, host stages, idle share.

Rounds of phases 26 and 27 take 8 requests each (warmed by 4); every
phase's sources are made while nvcc builds the kernels.

Device times are the kernels' own, summed by ``torch.profiler`` over 20
calls (the host's launch cost excluded); the bound is the larger of the
bytes the work must move over 3.35 TB/s and its fp32 FLOPs over 67
TFLOP/s, counted from the batch's shapes and band tables.

The seconds of each phase, heading to heading, are logged before the
total. Any failed phase raises, and the script exits non-zero. Nothing of JAX or
of the JAX package is imported. The last lines are the card's name and
power limit, one JSON line describing each kernel (with its bound, its
einsum yardstick's time and its launches on the AVIF rounds), and
``{"ok": true, "device": {...}}``. Without a card (or outside a checkout)
it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import functools
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


#: seconds from each phase's heading to the next heading (or to the end)
PHASE_S: dict = {}
_PHASE = {"name": None, "t0": 0.0}


def begin(heading: str) -> None:
    """Log a phase's heading ("[n] ...") and start its clock; the clock of
    the phase before it stops here."""
    end_phase()
    log(heading)
    _PHASE.update(name=heading[1:heading.index("]")], t0=time.perf_counter())


def end_phase() -> None:
    if _PHASE["name"] is not None:
        PHASE_S[_PHASE["name"]] = time.perf_counter() - _PHASE["t0"]
        _PHASE["name"] = None


def timed(fn, *args):
    """(fn(*args), its seconds)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def synth_image(seed: int, w: int = 1920, h: int = 1080,
                noise: bool = True) -> np.ndarray:
    """Seeded RGB image: a smooth gradient, hard-edged rectangles (their
    edges give low-frequency AC levels beyond int8 at high quality, i.e.
    escapes) and, unless ``noise`` is False, mild noise."""
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
    if noise:
        img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_jpeg(seed: int, quality: int, image=synth_image, samp=(2, 2),
              gray: bool = False) -> bytes:
    """JPEG without Pillow: the port's numpy fDCT + the native Huffman
    encoder. ``samp`` is the luma's (h, v) sampling factors against the
    chroma's 1: (2, 2) 4:2:0, (2, 1) 4:2:2, (1, 2) 4:4:0, (1, 1) 4:4:4;
    ``gray`` writes the luma alone."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    img = image(seed)
    planes, qt = host_encode_rgb_to_coefficients(img, quality, samp)
    return loader.encode_jpeg(planes[:1] if gray else planes, qt,
                              img.shape[1], img.shape[0], samp)


def dense_image(seed: int, w: int = 1920, h: int = 1080) -> np.ndarray:
    """Seeded escape-dense RGB image: each 8x8 block holds a hard edge
    between two random colours, so at q100 its lowest AC levels pass int8
    in every plane and the split transport overflows."""
    rng = np.random.default_rng(seed)
    by, bx = h // 8, w // 8
    a = rng.integers(0, 256, (by, bx, 1, 1, 3))
    b = rng.integers(0, 256, (by, bx, 1, 1, 3))
    left = (np.arange(8) < 4)[None, None, None, :, None]
    blk = np.broadcast_to(np.where(left, a, b), (by, bx, 8, 8, 3)).copy()
    flip = rng.random((by, bx)) < 0.5
    blk[flip] = blk[flip].transpose(0, 2, 1, 3)
    img = blk.transpose(0, 2, 1, 3, 4).reshape(h, w, 3)
    return np.clip(img + rng.normal(0.0, 8.0, img.shape), 0, 255).astype(np.uint8)


def make_png(img: np.ndarray) -> bytes:
    """RGB or RGBA PNG (colour type 2 or 6, by the channel count) without
    Pillow: filter 0 on every row, zlib level 1."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if img.shape[2] == 4 else 2,
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def with_alpha(img: np.ndarray, seed: int) -> np.ndarray:
    """``img`` with a seeded alpha channel: a diagonal ramp under two
    opaque rectangles, as a logo or a screenshot has."""
    rng = np.random.default_rng(1000 + seed)
    h, w = img.shape[:2]
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * 255 // (h + w - 2))
    alpha = ramp.astype(np.uint8)
    for _ in range(2):
        x0, y0 = rng.integers(0, w - 400), rng.integers(0, h - 300)
        alpha[y0:y0 + 300, x0:x0 + 400] = 255
    return np.dstack([img, alpha])


def ramp_alpha(img: np.ndarray) -> np.ndarray:
    """``img`` with a diagonal alpha ramp (an icon's soft edge)."""
    h, w = img.shape[:2]
    ramp = np.add.outer(np.arange(h), np.arange(w)) * 255 // (h + w - 2)
    return np.dstack([img, ramp.astype(np.uint8)])


def make_bmp(img: np.ndarray) -> bytes:
    """24 bpp bottom-up BI_RGB BMP, written with ``struct``."""
    h, w = img.shape[:2]
    pad = (-3 * w) % 4
    rows = np.zeros((h, 3 * w + pad), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    body = rows.tobytes()
    return (b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 2835,
                          2835, 0, 0) + body)


def make_tiff(img: np.ndarray) -> bytes:
    """Uncompressed little-endian RGB TIFF, one strip, written with
    ``struct``."""
    h, w = img.shape[:2]
    body = img.tobytes()
    bits_off = 8 + len(body)
    ifd_off = bits_off + 6
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, bits_off),
               (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, 8), (277, 3, 1, 3),
               (278, 3, 1, h), (279, 4, 1, len(body)), (284, 3, 1, 1)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", *e) for e in entries) + struct.pack("<I", 0)
    return (b"II*\x00" + struct.pack("<I", ifd_off) + body
            + struct.pack("<HHH", 8, 8, 8) + ifd)


def make_gif(img: np.ndarray) -> bytes:
    """GIF87a without Pillow: a 3-3-2 bit RGB palette and LZW with a clear
    code before the table can grow (every code stays 9 bits wide, so the
    stream packs with numpy)."""
    h, w = img.shape[:2]
    idx = ((img[..., 0] >> 5) << 5 | (img[..., 1] >> 5) << 2
           | img[..., 2] >> 6).astype(np.uint16).ravel()
    pal = np.array([[(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3] for i in range(256)], np.uint8)
    run = 250  # data codes between clear codes: 258 + run < 512
    n = len(idx)
    groups = -(-n // run)
    codes = np.full((groups, run + 1), 256, np.uint16)  # 256: clear
    padded = np.full(groups * run, 257, np.uint16)
    padded[:n] = idx
    codes[:, 1:] = padded.reshape(groups, run)
    codes = np.concatenate([codes.ravel()[: groups + n], [257]])  # 257: end
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).ravel()
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"GIF87a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + pal.tobytes()
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + blocks
            + b"\x00;")


def make_webp(img: np.ndarray, quality: int) -> bytes:
    """Lossy WebP without Pillow: BT.601 studio-range planes (a 2x2 box for
    the chroma) through the port's own VP8 encoder."""
    from imagekit_tpu_torch.codecs import vp8

    rgb = img.astype(np.float32)
    h, w = rgb.shape[:2]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0

    def half(c):
        c = np.pad(c, ((0, h & 1), (0, w & 1)), mode="edge")
        return c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))

    def q8(p):
        return np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8)

    return vp8.encode_yuv420(q8(y), q8(half(cb)), q8(half(cr)), quality)


def native_codecs() -> str:
    """Build and load the port's host codec library
    (``imagekit_tpu_torch/codecs/native``, into ``build/imagekit_tpu_torch``);
    when that fails, show the compiler's error and, if only zlib is
    missing, build the codecs the JPEG paths need (JPEG entropy, the
    four-component JPEG decode, VP8 encode, the QOI and BCn decodes) from
    the same sources."""
    import ctypes

    from imagekit_tpu_torch.codecs.native import loader

    try:
        return (f"{loader.load()._name} ("
                + " + ".join(s[:-4] for s in loader._SOURCES) + ")")
    except RuntimeError as e:
        log(f"native loader build failed:\n{str(e)[-4000:]}")
        if "zlib.h" not in str(e):
            raise
    src = os.path.join(ROOT, "imagekit_tpu_torch", "codecs", "native")
    out = loader.BUILD_DIR / "libik_native_min.so"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17",
         "-shared", "-fPIC", "-fvisibility=hidden",
         *(os.path.join(src, f) for f in (
             "jpeg_entropy.cpp", "jpeg4_decode.cpp", "vp8_encode.cpp",
             "raster_decode.cpp")), "-o", str(out)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    loader._configure(lib)
    loader._lib = lib  # the port's codecs resolve the library here
    return f"{out} (jpeg_entropy + jpeg4_decode + vp8_encode + raster_decode, no zlib)"


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


def capture_batch(jpegs, width: int, batch: int,
                  name: str = "decode_resize_yuv_lowfreq_i8_batch",
                  module=None, fmt=None):
    """Drive ``batch`` requests (to WebP, or ``fmt``) through an engine that
    flushes only full batches; return the recorded device inputs of that one
    batch, taken at the head ``name`` of ``module`` (``engine_jpeg``)."""
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    fmt = fmt or ImageFormat.webp

    cfg = ImageKitConfig(secret=SECRET, batch=BatchConfig(
        max_batch=batch, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))
    engine = BatchedEngine(cfg, metrics=Metrics(), device="cuda")

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(jpegs[i % len(jpegs)], width, None, fmt, 80)
                for i in range(batch)
            ))
        finally:
            await engine.close()

    with Recorder(module or engine_jpeg, name) as rec:
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


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` from CUDA events around ``reps``
    calls queued behind a spin kernel (``torch.cuda._sleep``, ≈ 25 ms on
    an H100): the card waits while the host launches them, so their
    kernels run back to back and the host's launch time, which exceeds a
    small kernel's own, is not counted (a call that waits for the card
    counts its gaps as plain CUDA events do)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the kernels it launches, summed
    by ``torch.profiler`` (CUPTI) over ``reps`` calls after a warm-up, so
    that the host's time to launch them is not counted. CUPTI now and then
    hands back a trace with no device record in it, or with fewer records
    than calls (every call launches at least one kernel; on an H100 80GB
    HBM3 at 700 W such a trace once summed a kernel to 0.0125 ms, under its
    0.0211 ms bound): the trace is then taken
    once more, and after a second short one the calls are timed with CUDA
    events instead, queued behind a spin kernel (:func:`queued_ms`; the
    gaps between a call's own kernels count there)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # the device's own activities (kernels, copies, fills); an
        # operator's device time repeats its kernels' and is not counted again
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.time_range.elapsed_us() for e in events)
        if total > 0 and len(events) >= reps:
            return total / reps / 1e3
    ms = queued_ms(fn, reps)
    log(f"    (two traces held fewer device records than calls: {ms:.4f} ms "
        f"is from CUDA events around {reps} calls queued behind a spin "
        f"kernel)")
    return ms


def latency(res):
    """p50 and p99 in ms of the (output, seconds) results of a round."""
    lat = sorted(t for _, t in res)
    return (lat[len(lat) // 2] * 1e3,
            lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3)


# The least time an H100 SXM could take for a kernel's work: the larger of
# the bytes it must move (each input read once, each output written once)
# over 3.35 TB/s and its fp32 FMAs (2 FLOP each) over 67 TFLOP/s. The
# Lanczos and folded stacks are banded, so the work is counted over each
# row's band, for the slots this batch uses.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float):
    """(bound ms, what sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def band_sum(band, idx) -> torch.Tensor:
    """(B,) total run length over the rows of each image's band table."""
    sel = band[idx.long().clamp(0, band.shape[0] - 1)]
    return (sel[..., 1] - sel[..., 0]).clamp(min=0).sum(dim=1).double()


def k1_bound(dcs, acs, escs, qt, stacks, bands, vidx, k):
    """K1's bound for one batch: the levels of the block columns in use,
    the escape lists, the stacks' bands of the slots in use and the packed
    output; pass 1 over each output row's band of block rows for the k²
    coefficient planes, pass 2 over each column's band for the k planes.
    ``escs`` None is the int16 transport: every level two bytes, no lists."""
    used = torch.unique(vidx)
    nbytes = qt.numel() * 4 + vidx.numel() * 4
    flops = 0.0
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        bv, bh = bands[:2] if p == 0 else bands[2:]
        B, rows, O, P, nblk = vidx.numel(), wv.shape[3], wv.shape[2], \
            wh.shape[2], wh.shape[3]
        if escs is None:
            nbytes += B * rows * nblk * 2 * k * k
        else:
            nbytes += B * rows * nblk * (2 + k * k - 1)  # i16 DC, i8 AC
            nbytes += escs[p][0].numel() * 4 + escs[p][1].numel() * 4
        nbytes += 4 * k * float(band_sum(bv, used).sum() + band_sum(bh, used).sum())
        nbytes += B * O * P
        flops += 2 * (k * k * nblk * float(band_sum(bv, vidx).sum())
                      + k * O * float(band_sum(bh, vidx).sum()))
    return bound(nbytes, flops)


def resize_bound(in_bytes, out_bytes, wv, bv, bh, vidx, hidx, in_w):
    """A two-pass banded resize: pass 1 over each output row's band for
    every input column, pass 2 over each output column's band."""
    O = wv.shape[1]
    flops = 2 * (in_w * float(band_sum(bv, vidx).sum())
                 + O * float(band_sum(bh, hidx).sum()))
    nbytes = (in_bytes + out_bytes
              + 4 * float(band_sum(bv, torch.unique(vidx)).sum()
                          + band_sum(bh, torch.unique(hidx)).sum()))
    return nbytes, flops


def k1_inputs(call):
    """A recorded head call's K1 inputs, as ``folded_planes_i8`` takes
    them: (dcs, acs, escs, qtabs, stacks, bands, vidx), and its k."""
    args, kw, _ = call
    dcs, acs, escs, qt, stacks, vidx = args[:6]
    return (dcs, acs, escs, qt, stacks, kw["bands"], vidx), args[8]


def k1_library(dcs, acs, escs, qt, stacks, bands, vidx, k):
    """Yardstick: one fp32 ``torch.einsum`` per plane of the folded
    contraction over the gathered stacks and the dequantised coefficient
    planes (widened, escapes added and dequantised beforehand, untimed;
    the epilogue excluded). The port never calls it."""
    from imagekit_tpu_torch.ops import jpeg8

    qt_l, qt_c = jpeg8.qt_lowfreq(qt, k)
    ui = vidx.long()
    operands = []
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        nblk = wh.shape[3]
        pw = acs[p].shape[2] // (k * k - 1)
        ac16 = jpeg8.widen_scatter(acs[p], *escs[p])
        q = qt_l if p == 0 else qt_c
        C = torch.stack([
            dcs[p][:, :, :nblk].float() if lin == 0 else
            ac16[:, :, (lin - 1) * pw:(lin - 1) * pw + nblk].float()
            for lin in range(k * k)], dim=1) * q[:, :, None, None]
        B, _, rows, _ = C.shape
        operands.append((wv[ui], C.reshape(B, k, k, rows, nblk), wh[ui]))
    return lambda: [torch.einsum("buor,buvrc,bvpc->bop", *ops)
                    for ops in operands]


def phase_kernel(jpegs, jpegs_hq) -> dict:
    """K1 (one launch for Y, Cb and Cr) against its plain version, on the
    engine's own inputs of one recorded batch."""
    from imagekit_tpu_torch.ops import jpeg8

    result = {"max_abs_err": 0}
    # B=32: two escape-heavy q95 images among q80 ones, so that the batch
    # carries escapes and still fits the head's escape caps in one batch
    mixed = list(jpegs_hq) + list(jpegs) * 2
    for k, width in ((2, 400), (4, 800)):
        for batch in (1, 32):
            src = mixed[:32] if batch == 32 else jpegs_hq[:1]
            call = capture_batch(src, width, batch)
            inp, k_rec = k1_inputs(call)
            if k_rec != k:
                raise RuntimeError(f"width {width}: engine chose k={k_rec}")
            n_esc = int((inp[2][0][1] != 0).sum())
            for centered in (False, True):
                got = jpeg8.folded_planes_i8(*inp, k, centered=centered)
                ref = jpeg8.folded_planes_i8_plain(*inp, k, centered)
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if centered else [(got, ref)]
                for a, b in pairs:
                    mx, share1, over = compare(a, b)
                    n_diff = int((a != b).sum())
                    log(f"  K1 vs plain B={batch} k={k} "
                        f"{'centred i8' if centered else 'decode u8'} "
                        f"shape={tuple(a.shape)} luma_escapes={n_esc}: "
                        f"max|d|={mx} share(|d|=1)={share1:.3e} "
                        f"({n_diff} of {a.numel()} differ)")
                    if mx > MAX_ABS or share1 > MAX_SHARE or over:
                        raise RuntimeError("K1 disagrees with its plain version")
                    result["max_abs_err"] = max(result["max_abs_err"], mx)
            mx, share1 = check_head(call)
            log(f"  head (engine, K1) vs plain head B={batch} k={k}: "
                f"max|d|={mx} share(|d|=1)={share1:.3e}")
            if batch == 32 and k == 2:
                def kernel():
                    return jpeg8.folded_planes_i8(*inp, k)

                def plain():
                    return jpeg8.folded_planes_i8_plain(*inp, k)

                library = k1_library(*inp, k)
                ms, plain_ms, library_ms = (device_ms(f) for f in
                                            (kernel, plain, library))
                call_ms = cuda_ms(kernel)
                bound_ms, bound_by = k1_bound(*inp, k)
                log(f"  timing B=32 k=2, 3 planes in one launch (device time "
                    f"per call, torch.profiler over 20): K1 {ms:.4f} ms, plain"
                    f" {plain_ms:.4f} ms, library (3 fp32 einsums of the "
                    f"folded contraction on dequantised planes, no epilogue)"
                    f" {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
                    f"({bound_by}), K1 at {bound_ms / ms:.1%} of it; one "
                    f"wrapper call as CUDA events see it (host launch "
                    f"included, median of 20): {call_ms:.4f} ms")
                result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              call_ms=call_ms)
    return result


def check_head(call):
    """A recorded batch's planes (the K1 route) against the plain version
    on the same inputs; raises outside the band."""
    from imagekit_tpu_torch.ops import jpeg8

    inp, k = k1_inputs(call)
    plain = jpeg8.folded_planes_i8_plain(*inp, k)
    planes = call[2]
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
    """Weight stacks and their tables (band tables and compact ``Wh``) on
    the card, built by the engine's own builder (edge rows replicated as
    the engine replicates them): (wv, wh, tables)."""
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

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
    from imagekit_tpu_torch.ops import color, dct, resize_strip
    from imagekit_tpu_torch.ops.resize_strip import band_table

    result = {"max_abs_err": 0}

    def check(what, got, ref, band=True):
        mx, share1, over = compare(got, ref)
        n_diff = int((got != ref).sum())
        log(f"  K2 vs plain {what} shape={tuple(got.shape)} "
            f"dtype={got.dtype}: max|d|={mx} share(|d|=1)={share1:.3e} "
            f"({n_diff} of {got.numel()} differ)")
        if mx > MAX_ABS or share1 > MAX_SHARE or over:
            raise RuntimeError("K2 disagrees with its plain version")
        if band:
            result["max_abs_err"] = max(result["max_abs_err"], mx)

    wv, wh, tabs = k2_stacks((1088, 1920, 240, 400, 3, "yuv"), SLICE_V,
                             SLICE_H)
    host = np.zeros((32, 1088, 1920 * 3), np.uint8)
    for i in range(32):
        host[i, :1080] = images[i % len(images)].reshape(1080, -1)
    flat = torch.from_numpy(host).cuda()
    from imagekit_tpu_torch.ops.weights import quality_tables

    qt = torch.from_numpy(np.concatenate(quality_tables(80)).astype(
        np.float32)).cuda()
    for batch in (1, 32):
        x = flat[:batch]
        vidx, hidx = k2_index(batch)
        before = resize_strip.LAUNCHES
        got = resize_strip.rgb_resize(x, wv, wh, vidx, hidx, bands=tabs)
        torch.cuda.synchronize()
        if resize_strip.LAUNCHES != before + 1:
            raise RuntimeError("rgb_resize did not launch K2 once")
        ref = resize_strip.rgb_resize_plain(x, wv, wh, vidx, hidx)
        for c in range(3):
            check(f"B={batch} channel {'RGB'[c]} (u8, one launch)", got[:, c],
                  ref[:, c])
        check(f"B={batch} rgbyuv head", color.rgb_yuv_head(
            x, wv, wh, vidx, hidx, tabs), color.rgb_yuv_head(
            x, wv, wh, vidx, hidx, tabs, resize=resize_strip.rgb_resize_plain),
            band=False)
        qto = qt.expand(batch, 128).contiguous()
        check(f"B={batch} rgbjpg head levels", dct.rgb_jpeg_head(
            x, wv, wh, vidx, hidx, qto, tabs), dct.rgb_jpeg_head(
            x, wv, wh, vidx, hidx, qto, tabs,
            resize=resize_strip.rgb_resize_plain), band=False)
    vidx, hidx = k2_index(32)
    ms = device_ms(lambda: resize_strip.rgb_resize(flat, wv, wh, vidx, hidx,
                                                   bands=tabs))
    plain_ms = device_ms(lambda: resize_strip.rgb_resize_plain(
        flat, wv, wh, vidx, hidx))
    # yardstick: one fp32 einsum per channel over the gathered stacks and
    # the channel widened to f32 beforehand (untimed), no epilogue
    wv_g, wh_g = wv[vidx.long()], wh[hidx.long()]
    full = flat.reshape(32, 1088, 1920, 3)
    chans = [full[..., c].float() for c in range(3)]
    library_ms = device_ms(lambda: [torch.einsum("boh,bhw,bpw->bop", wv_g, x_,
                                               wh_g) for x_ in chans])
    del chans, wv_g, wh_g
    nbytes, flops = resize_bound(flat.numel(), 3 * 32 * 240 * 400, wv,
                                 tabs.band_v, band_table(wh), vidx, hidx,
                                 1920)
    bound_ms, bound_by = bound(nbytes, 3 * flops)
    head_ms = device_ms(lambda: color.rgb_yuv_head(flat, wv, wh, vidx, hidx,
                                                 tabs))
    head_plain_ms = device_ms(lambda: color.rgb_yuv_head(
        flat, wv, wh, vidx, hidx, tabs,
        resize=resize_strip.rgb_resize_plain))
    log(f"  timing B=32 1088x1920 -> 240x400, 3 channels in one launch "
        f"(device time per call, torch.profiler over 20): K2 {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (3 fp32 einsums, no epilogue) "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), K2 at "
        f"{bound_ms / ms:.1%} of it; whole rgbyuv head (resize + mix + box "
        f"+ pack): K2 route {head_ms:.4f} ms, plain {head_plain_ms:.4f} ms")
    result.update(ms=ms, plain_ms=plain_ms, head_ms=head_ms,
                  head_plain_ms=head_plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by)
    del full, flat, x

    wv, wh, tabs = k2_stacks((544, 960, 120, 200, 1, "yuv"), CHROMA_V,
                             CHROMA_H)
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
                                            hidx, bands=tabs, **kw)
            ref = resize_strip.plane_resize_plain(planes[:batch], wv, wh,
                                                  vidx, hidx, **kw)
            torch.cuda.synchronize()
            check(f"B={batch} 544x960 {name} (centred i8)", got, ref)
        t_k = device_ms(lambda: resize_strip.plane_resize(
            planes, wv, wh, vidx, hidx, bands=tabs, **kw))
        t_p = device_ms(lambda: resize_strip.plane_resize_plain(
            planes, wv, wh, vidx, hidx, **kw))
        log(f"  timing B=32 544x960 -> 120x200 {name}: K2 {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
    return result


# ---------------------------------------------------------------------------
# phase 5: K3 and K4 against their plain versions
# ---------------------------------------------------------------------------

# four (source w, h, target w, h) slots of the slice's bucket pair
K3_GEOMS = ((1920, 1080, 400, 225), (1904, 1072, 397, 223),
            (1888, 1064, 393, 222), (1872, 1056, 390, 220))


def k3_stacks():
    """The demoted RGB head's stacks on the card, from the builders the
    engine uses for kind "rgb": luma 1088x1920 -> 240x400, chroma 544x960
    -> FULL output resolution; (wv_y, wh_y, wv_c, wh_c) and the (luma,
    chroma) tables."""
    from imagekit_tpu_torch.ops.resize_strip import resize_tables
    from imagekit_tpu_torch.ops.weights import (
        combined_chroma_weights,
        padded_weights,
    )

    stacks = []
    for ih, iw in ((1088, 1920), (544, 960)):
        wv = np.zeros((4, 240, ih), np.float32)
        wh = np.zeros((4, 400, iw), np.float32)
        for u, (sw, sh, ow, oh) in enumerate(K3_GEOMS):
            if ih == 1088:
                wv[u] = padded_weights(sh, oh, ih, 240)
                wh[u] = padded_weights(sw, ow, iw, 400)
            else:
                wv[u] = combined_chroma_weights((sh + 1) // 2, sh, oh, ih, 240)
                wh[u] = combined_chroma_weights((sw + 1) // 2, sw, ow, iw, 400)
        stacks += [torch.from_numpy(w_).cuda() for w_ in (wv, wh)]
    return stacks, (resize_tables(*stacks[:2]), resize_tables(*stacks[2:]))


def phase_k3(images) -> dict:
    """``images``: the 16 synthesized 1920x1080 RGB images."""
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops.resize_strip import band_table

    result = {"max_abs_err": 0, "max_abs_err_f32": 0.0}
    luma = np.zeros((32, 1088, 1920), np.uint8)
    chroma = [np.zeros((32, 544, 960), np.uint8) for _ in range(2)]
    for i in range(32):
        img = images[i % len(images)]
        luma[i, :1080] = img[..., 0]
        for c in range(2):
            chroma[c][i, :540] = img[::2, ::2, 1 + c]
    stacks, tabs = k3_stacks()
    x8 = [torch.from_numpy(p).cuda() for p in [luma] + chroma]
    xf = [p.float() + 0.25 for p in x8]  # off the integer grid
    for batch in (1, 32):
        vidx = torch.arange(batch, dtype=torch.int32, device="cuda") % 4
        k3_0, k4_0 = rp.LAUNCHES, rp.LAUNCHES_F32
        got = rp.resize_planes3([p[:batch] for p in x8], stacks, vidx,
                                bands=tabs)
        got_f = rp.resize_planes3_f32([p[:batch] for p in xf], stacks, vidx,
                                      bands=tabs)
        torch.cuda.synchronize()
        if rp.LAUNCHES != k3_0 + 1 or rp.LAUNCHES_F32 != k4_0 + 1:
            raise RuntimeError("the three planes did not take one launch")
        ref = rp.resize_planes3_plain([p[:batch] for p in x8], stacks, vidx)
        ref_f = rp.resize_planes3_f32_plain([p[:batch] for p in xf], stacks,
                                            vidx)
        for name, a, b, af, bf in zip(("Y", "Cb", "Cr"), got, ref, got_f,
                                      ref_f):
            mx, share1, over = compare(a, b)
            err_f = float((af - bf).abs().max())
            log(f"  K3 vs plain B={batch} {name} -> {tuple(a.shape[1:])}: "
                f"max|d|={mx} share(|d|=1)={share1:.3e} ({int((a != b).sum())}"
                f" of {a.numel()} differ); K4 (f32) max|d|={err_f:.3e}")
            if mx > MAX_ABS or share1 > MAX_SHARE or over:
                raise RuntimeError("K3 disagrees with its plain version")
            # K4: fp32 sums of ~1000 terms in another order
            torch.testing.assert_close(af, bf, rtol=1e-5, atol=255e-5)
            result["max_abs_err"] = max(result["max_abs_err"], mx)
            result["max_abs_err_f32"] = max(result["max_abs_err_f32"], err_f)
    # B=32 timings of the three planes; yardstick: one fp32 einsum per
    # plane over the gathered stacks and the plane (widened to f32
    # beforehand for K3, untimed), no epilogue
    u = vidx.long()
    pairs = [(stacks[0][u], stacks[1][u])] + [(stacks[2][u], stacks[3][u])] * 2
    x8f = [p.float() for p in x8]

    def einsums(xs):
        return lambda: [torch.einsum("boh,bhw,bpw->bop", wv_g, x_, wh_g)
                        for (wv_g, wh_g), x_ in zip(pairs, xs)]

    ts = [device_ms(lambda: rp.resize_planes3(x8, stacks, vidx, bands=tabs)),
          device_ms(lambda: rp.resize_planes3_plain(x8, stacks, vidx)),
          device_ms(lambda: rp.resize_planes3_f32(xf, stacks, vidx,
                                                  bands=tabs)),
          device_ms(lambda: rp.resize_planes3_f32_plain(xf, stacks, vidx)),
          device_ms(einsums(x8f)), device_ms(einsums(xf))]
    for key, t in zip(("ms", "plain_ms", "ms_f32", "plain_ms_f32",
                       "library_ms", "library_ms_f32"), ts):
        result[key] = t
    out_px = 32 * 240 * 400
    for kind, elem, suffix in (("u8", 1, ""), ("f32", 4, "_f32")):
        nbytes = flops = 0.0
        for p, (wv, wh), t in zip(x8, (stacks[:2], stacks[2:], stacks[2:]),
                                  (tabs[0], tabs[1], tabs[1])):
            nb, fl = resize_bound(p.numel() * elem, out_px * elem, wv,
                                  t.band_v, band_table(wh), vidx, vidx,
                                  p.shape[2])
            nbytes += nb
            flops += fl
        result["bound_ms" + suffix], result["bound_by" + suffix] = bound(
            nbytes, flops)
    log(f"  timing B=32, Y + Cb + Cr in one launch (device time per call, "
        f"torch.profiler over 20): K3 {result['ms']:.4f} ms vs plain "
        f"{result['plain_ms']:.4f} ms vs einsum {result['library_ms']:.4f} "
        f"ms, bound {result['bound_ms']:.4f} ms ({result['bound_by']}), K3 "
        f"at {result['bound_ms'] / result['ms']:.1%} of it; K4 "
        f"{result['ms_f32']:.4f} ms vs plain {result['plain_ms_f32']:.4f} ms "
        f"vs einsum {result['library_ms_f32']:.4f} ms, bound "
        f"{result['bound_ms_f32']:.4f} ms ({result['bound_by_f32']}), K4 at "
        f"{result['bound_ms_f32'] / result['ms_f32']:.1%} of it")
    del x8, xf, x8f, pairs
    # the demoted head's upload: one B=32 int16 batch, (32, 136, 240*64)
    # luma and 2 x (32, 68, 120*64) chroma, as the engine's _placement
    # copies it (pin, then a non-blocking copy)
    arrays = [np.ones((32, 136, 240 * 64), np.int16)] + [
        np.ones((32, 68, 120 * 64), np.int16) for _ in range(2)]
    mb = sum(a.nbytes for a in arrays) / 1e6
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        _ = [torch.from_numpy(a).pin_memory().to("cuda", non_blocking=True)
             for a in arrays]
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
    pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
    dma = cuda_ms(lambda: [p.to("cuda", non_blocking=True) for p in pinned],
                  reps=5)
    log(f"  demoted head's H2D, one B=32 int16 batch ({mb:.1f} MB): pin + "
        f"copy {statistics.median(host_s) * 1e3:.2f} ms (host clock, median "
        f"of 3), DMA of pinned memory {dma:.4f} ms (CUDA events, median of 5)")
    result.update(h2d_ms=dma, pin_h2d_ms=statistics.median(host_s) * 1e3)
    return result


# ---------------------------------------------------------------------------
# phase 6: the JPEG engine slice
# ---------------------------------------------------------------------------


def phase_engine(jpegs, card: str) -> dict:
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import jpeg8
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics
    from imagekit_tpu_torch.signature import sign, verify_signature

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
    stages = ("entropy_decode", "batch_build", "device_decode_resize",
              "encode")

    async def one(data, w):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, ImageFormat.webp, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            await asyncio.gather(*(one(d, w) for d, w in reqs[:len(jpegs)]))
            batches0 = metrics.batches
            stage0 = {k: metrics.stage_seconds[k] for k in stages}
            jpeg8.LAUNCHES = 0  # count only the measured run
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(d, w) for d, w in reqs))
            wall = time.perf_counter() - t0
            launches = jpeg8.LAUNCHES
            spent = {k: metrics.stage_seconds[k] - stage0[k] for k in stages}
            return res, wall, launches, metrics.batches - batches0, spent
        finally:
            await engine.close()

    with Recorder(engine_jpeg) as rec:
        res, wall, launches, batches, spent = asyncio.run(drive())
    for out, _ in res:
        if out[:4] != b"RIFF" or out[8:12] != b"WEBP":
            raise RuntimeError("engine output is not a RIFF/WEBP file")
        if vp8.dimensions(out) != (400, 225):
            raise RuntimeError(f"WebP is {vp8.dimensions(out)}, not 400x225")
    if batches <= 0 or launches != batches:
        raise RuntimeError(
            f"K1 launches {launches} != {batches} batches on the engine path")
    mx, share1 = check_head(rec.calls[-1])
    p50, p99 = latency(res)
    rps = n_req / wall
    log(f"  engine: {n_req} concurrent requests in {wall:.4f} s -> "
        f"{rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
        f"{batches} batches, {launches} K1 launches; last batch vs plain head "
        f"max|d|={mx} share(|d|=1)={share1:.3e} [{card}]")
    log("  host seconds in the measured round: " + ", ".join(
        f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
        for k, v in spent.items()))
    return {"launches": launches, "batches": batches, "rps": rps,
            "p50_ms": p50, "p99_ms": p99}


# ---------------------------------------------------------------------------
# phase 7: the PNG engine slice
# ---------------------------------------------------------------------------


def phase_png_engine(pngs, card: str) -> dict:
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import color, dct, resize_strip
    from imagekit_tpu_torch.serving import engine_rgb
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

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
    if batches <= 0 or launches != batches:
        raise RuntimeError(
            f"K2 launches {launches} != {batches} batches on the PNG path")

    args, kw, planes = rec_y.calls[-1]
    x, (wv, wh), vidx, hidx = args[:4]
    plain = color.rgb_yuv_head(x, wv, wh, vidx, hidx, kw["bands"],
                               resize=resize_strip.rgb_resize_plain)
    got = torch.cat([torch.from_numpy(p.reshape(p.shape[0], -1))
                     for p in planes], dim=1).to(plain.device)
    mx_y, share_y, over = compare(got, plain)
    if mx_y > MAX_ABS or share_y > MAX_SHARE or over:
        raise RuntimeError("rgbyuv head (K2) disagrees with the plain head")
    args, kw, levels = rec_j.calls[-1]
    x, (wv, wh), vidx, hidx, qto = args[:5]
    plain = dct.rgb_jpeg_head(x, wv, wh, vidx, hidx, qto, kw["bands"],
                              resize=resize_strip.rgb_resize_plain)
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
        f" ms), {batches} batches, {launches} K2 launches "
        f"({launches / batches:.2f} per batch) [{card}]")
    log(f"  last WebP batch vs plain head: max|d|={mx_y} share(|d|=1)="
        f"{share_y:.3e}; last JPEG batch levels vs plain head: max|d|={mx_j}"
        f" share(|d|=1)={share_j:.3e} ({n_diff} levels differ)")
    log("  host seconds in the measured round: " + ", ".join(
        f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
        for k, v in spent.items()))
    return {"launches": launches, "batches": batches, "rps": rps,
            "p50_ms": p50, "p99_ms": p99}


# ---------------------------------------------------------------------------
# phase 8: the JPEG -> JPEG engine slice
# ---------------------------------------------------------------------------


def check_jxc_batch(call) -> tuple:
    """A recorded k=2 jxc batch's levels (K1 route) against the plain head
    on the same inputs: (max |d|, share(|d|=1), levels that differ)."""
    from imagekit_tpu_torch.ops import dct, jpeg8

    args, kw, levels = call
    dcs, acs, escs, qt, qto, w, vidx, block_dims, _, k = args
    plain = dct.transcode_i8(dcs, acs, escs, qt, qto, w, vidx, block_dims, k,
                             kw["bands"], planes=jpeg8.folded_planes_i8_plain)
    got = torch.cat([torch.from_numpy(lv.reshape(lv.shape[0], -1))
                     for lv in levels], dim=1).to(plain.device)
    mx, share1, over = compare(got, plain)
    if mx > MAX_ABS or share1 > MAX_SHARE or over:
        raise RuntimeError(f"jxc head (K1) disagrees with the plain head: "
                           f"max|d|={mx}, share(|d|=1)={share1:.3e}")
    return mx, share1, int((got != plain).sum())


def check_rgb_batch(call) -> tuple:
    """A recorded demoted batch's RGB (K3 route) against the plain head on
    the same inputs. Band: |d| <= 2 on at most 0.1% of values: K3's +-1 on
    a resized chroma plane is scaled by up to 1.772 by the YCbCr -> RGB
    matrix."""
    from imagekit_tpu_torch.ops import dct
    from imagekit_tpu_torch.ops import resize_planes as rp

    from imagekit_tpu_torch.ops.color import on_device

    args, kw, rgb = call
    y, cb, cr, qt, w, vidx, block_dims, _ = args
    # a single image's call (the JPEG pixel decode) hands the head numpy
    y, cb, cr, qt, vidx, *w = on_device((y, cb, cr, qt, vidx, *w),
                                        device="cuda")
    plain = dct.decode_resize_rgb(y, cb, cr, qt, *w, vidx, *block_dims,
                                  bands=kw.get("bands"),
                                  resize=rp.resize_planes3_plain)
    got = torch.from_numpy(rgb.reshape(rgb.shape[0], -1)).to(plain.device)
    d = (got.to(torch.int32) - plain.to(torch.int32)).abs()
    mx, share = int(d.max()), float((d > 0).float().mean())
    if mx > 2 or share > MAX_SHARE:
        raise RuntimeError(f"RGB head (K3) disagrees with the plain head: "
                           f"max|d|={mx}, share(|d|>0)={share:.3e}")
    return mx, share


def phase_jxc_engine(jpegs, dense, card: str) -> dict:
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import jpeg8
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving import engine_jpeg
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    rounds = (
        ("w=400, q80 sources (jxc k=2)",
         [(jpegs[i % len(jpegs)], 400) for i in range(64)], (400, 225)),
        ("w=1280, q80 sources (jxc k=8)",
         [(jpegs[i % len(jpegs)], 1280) for i in range(16)], (1280, 720)),
        ("w=400, escape-dense q100 sources (demoted to the RGB head)",
         [(dense[i % len(dense)], 400) for i in range(16)], (400, 225)),
    )
    metrics = Metrics()
    # no load shedding: every request of a round is served and measured
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("entropy_decode", "batch_build", "device_decode_resize",
              "encode")

    async def one(data, w):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, ImageFormat.jpeg, 80)
        return out, time.perf_counter() - t0

    async def drive(rec_rgb):
        try:
            await engine.warmup()
            for _, reqs, _ in rounds:  # weights, allocator, native codecs
                await asyncio.gather(*(one(d, w) for d, w in reqs[:4]))
            runs = []
            for _, reqs, _ in rounds:
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                rgb0 = len(rec_rgb.calls)
                jpeg8.LAUNCHES = 0  # count only the measured round
                rp.LAUNCHES = 0
                t0 = time.perf_counter()
                res = await asyncio.gather(*(one(d, w) for d, w in reqs))
                wall = time.perf_counter() - t0
                runs.append({
                    "res": res, "wall": wall, "k1": jpeg8.LAUNCHES,
                    "k3": rp.LAUNCHES, "batches": metrics.batches - batches0,
                    "rgb_batches": len(rec_rgb.calls) - rgb0,
                    "spent": {k: metrics.stage_seconds[k] - stage0[k]
                              for k in stages}})
            return runs
        finally:
            await engine.close()

    with Recorder(engine_jpeg, "transcode_i8_batch") as rec_x, \
            Recorder(engine_jpeg, "decode_resize_rgb_batch") as rec_rgb:
        runs = asyncio.run(drive(rec_rgb))
    lib = loader.load()
    for (name, reqs, size), run in zip(rounds, runs):
        for out, _ in run["res"]:
            hdr = jpeg_abi.parse(lib, out)
            if (hdr.width, hdr.height) != size:
                raise RuntimeError(f"{name}: JPEG is {hdr.width}x{hdr.height}"
                                   f", not {size[0]}x{size[1]}")
        n = len(reqs)
        p50, p99 = latency(run["res"])
        run.update(rps=n / run["wall"], p50_ms=p50, p99_ms=p99)
        log(f"  {name}: {n} concurrent requests in {run['wall']:.4f} s -> "
            f"{run['rps']:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
            f"{run['batches']} batches ({run['rgb_batches']} demoted), "
            f"{run['k1']} K1 launches, {run['k3']} K3 launches [{card}]")
        if run["rgb_batches"]:
            log(f"    K3 launches per demoted batch: "
                f"{run['k3'] / run['rgb_batches']:.2f}")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s ({v / n * 1e3:.2f} ms/request)"
            for k, v in run["spent"].items()))
    k2_run, k8_run, dense_run = runs
    if k2_run["batches"] <= 0 or k2_run["k1"] != k2_run["batches"] \
            or k2_run["rgb_batches"] or k2_run["k3"]:
        raise RuntimeError("the w=400 round did not run K1 once a batch, "
                           "or demoted")
    if k8_run["k1"] or k8_run["k3"] or k8_run["rgb_batches"]:
        raise RuntimeError("the k=8 round launched K1 or K3, or demoted")
    if (dense_run["rgb_batches"] <= 0
            or dense_run["rgb_batches"] != dense_run["batches"]
            or dense_run["k3"] != dense_run["rgb_batches"]
            or dense_run["k1"]):
        raise RuntimeError(
            f"escape-dense round: {dense_run['rgb_batches']} demoted of "
            f"{dense_run['batches']} batches, {dense_run['k3']} K3 launches")
    k2_calls = [c for c in rec_x.calls if c[0][9] == 2]
    mx, share1, n_diff = check_jxc_batch(k2_calls[-1])
    n_lv = sum(lv.size for lv in k2_calls[-1][2])
    log(f"  last k=2 jxc batch vs plain head: max|d|={mx} share(|d|=1)="
        f"{share1:.3e}, {n_diff} of {n_lv} levels differ (K1's fp32 sums in "
        f"another order than cuBLAS's)")
    mx_rgb, share_rgb = check_rgb_batch(rec_rgb.calls[-1])
    log(f"  last demoted batch's RGB vs plain head: max|d|={mx_rgb} "
        f"share(|d|>0)={share_rgb:.3e}")
    return {"k1_launches": k2_run["k1"], "k3_launches": dense_run["k3"],
            "demoted_batches": dense_run["rgb_batches"],
            "levels_differ": n_diff,
            "rounds": [{k: r[k] for k in ("rps", "p50_ms", "p99_ms",
                                           "batches")} for r in runs]}


# ---------------------------------------------------------------------------
# phases 9-11: K1's int16 entry, K4 on u8 planes and K2 on three YUV planes
# against their plain versions, on batches the engine packs
# ---------------------------------------------------------------------------


def flat_planes(planes, like):
    """Host (Y, Cb, Cr) arrays of a head -> one flat tensor beside ``like``."""
    return torch.cat([torch.from_numpy(p.reshape(p.shape[0], -1))
                      for p in planes], dim=1).to(like.device)


def check_band(what: str, got, ref) -> tuple:
    mx, share1, over = compare(got, ref)
    if mx > MAX_ABS or share1 > MAX_SHARE or over:
        raise RuntimeError(f"{what} disagrees with its plain version: "
                           f"max|d|={mx}, share(|d|=1)={share1:.3e}")
    return mx, share1


def k1_i16_inputs(call):
    """A recorded ``decode_resize_yuv_lowfreq_batch`` call's K1 inputs, as
    ``folded_planes_i16`` takes them: (flats, qtabs, stacks, bands, vidx),
    and its k."""
    args, kw, _ = call
    y, cb, cr, qt, stacks, vidx = args[:6]
    return ((y, cb, cr), qt, stacks, kw["bands"], vidx), args[8]


def k1_i16_library(flats, qt, stacks, bands, vidx, k):
    """Yardstick of the int16 entry: :func:`k1_library`'s einsum on the
    block-grouped levels split by ``reshape`` and dequantised beforehand
    (untimed). The port never calls it."""
    from imagekit_tpu_torch.ops import jpeg8

    qt_l, qt_c = jpeg8.qt_lowfreq(qt, k)
    ui = vidx.long()
    operands = []
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        nblk = wh.shape[3]
        B, rows, _ = flats[p].shape
        lev = flats[p][:, :, :nblk * k * k].reshape(B, rows, nblk, k, k)
        q = (qt_l if p == 0 else qt_c).reshape(B, 1, 1, k, k)
        C = (lev.float() * q).permute(0, 3, 4, 1, 2).contiguous()
        operands.append((wv[ui], C, wh[ui]))
    return lambda: [torch.einsum("buor,buvrc,bvpc->bop", *ops)
                    for ops in operands]


def phase_k1_i16(dense) -> dict:
    """K1's int16 entry (block-grouped levels, no escapes) against its
    plain version, on the batches the engine packs from escape-dense
    JPEGs."""
    from imagekit_tpu_torch.ops import jpeg8

    result = {"max_abs_err": 0}
    for k, width in ((2, 400), (4, 800)):
        for batch in (1, 32):
            call = capture_batch(dense, width, batch,
                                 "decode_resize_yuv_lowfreq_batch")
            inp, k_rec = k1_i16_inputs(call)
            if k_rec != k:
                raise RuntimeError(f"width {width}: engine chose k={k_rec}")
            past_i8 = int((inp[0][0].abs() > 127).sum())
            if not past_i8:
                raise RuntimeError("the int16 batch holds no level past int8")
            for centered in (False, True):
                before = jpeg8.LAUNCHES
                got = jpeg8.folded_planes_i16(*inp, k, centered=centered)
                torch.cuda.synchronize()
                if jpeg8.LAUNCHES != before + 1:
                    raise RuntimeError("folded_planes_i16 did not launch once")
                ref = jpeg8.folded_planes_i16_plain(*inp, k, centered)
                for a, b in (zip(got, ref) if centered else [(got, ref)]):
                    mx, share1 = check_band("K1 (int16 entry)", a, b)
                    log(f"  K1 int16 vs plain B={batch} k={k} "
                        f"{'centred i8' if centered else 'decode u8'} "
                        f"shape={tuple(a.shape)} luma levels past int8="
                        f"{past_i8}: max|d|={mx} share(|d|=1)={share1:.3e} "
                        f"({int((a != b).sum())} of {a.numel()} differ)")
                    result["max_abs_err"] = max(result["max_abs_err"], mx)
            plain = jpeg8.folded_planes_i16_plain(*inp, k)
            mx, share1 = check_band("int16 lowfreq head",
                                    flat_planes(call[2], plain), plain)
            log(f"  head (engine, K1 int16) vs plain head B={batch} k={k}: "
                f"max|d|={mx} share(|d|=1)={share1:.3e}")
            if batch == 32 and k == 2:
                ms, plain_ms, library_ms = (device_ms(f) for f in (
                    lambda: jpeg8.folded_planes_i16(*inp, k),
                    lambda: jpeg8.folded_planes_i16_plain(*inp, k),
                    k1_i16_library(*inp, k)))
                flats, qt, stacks, bands, vidx = inp
                bound_ms, bound_by = k1_bound(None, None, None, qt, stacks,
                                              bands, vidx, k)
                log(f"  timing B=32 k=2, 3 planes in one launch (device time "
                    f"per call, torch.profiler over 20): K1 int16 {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms, library (3 fp32 einsums on "
                    f"dequantised planes, no epilogue) {library_ms:.4f} ms; "
                    f"bound {bound_ms:.4f} ms ({bound_by}), at "
                    f"{bound_ms / ms:.1%} of it")
                result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    return result


def k8_planes(call):
    """A recorded k = 8 split batch's u8 planes, as the head hands them to
    K4: widen + escapes, dequantise, 8x8 IDCT to the u8 grid. Returns
    (planes, stacks, vidx, tables)."""
    from imagekit_tpu_torch.ops import dct

    args, kw, _ = call
    dcs, acs, escs, qt, stacks, vidx, (by, bx, cy, cx) = args[:7]
    dims = ((by, bx), (cy, cx), (cy, cx))
    planes = []
    for p in range(3):
        lev = dct._widen_split_levels(dcs[p], acs[p], *escs[p], *dims[p])
        planes.append(dct._blocks_to_plane(
            lev, *dims[p], qt[:, :64] if p == 0 else qt[:, 64:]))
        del lev
    return planes, stacks, vidx, kw["bands"]


def planes_bound(planes, out_elem, stacks, tabs, vidx):
    """Bound of one three-plane launch: u8 planes in, ``out_elem`` bytes an
    output pixel."""
    return plane_list_bound(planes, (stacks[:2], stacks[2:], stacks[2:]),
                            (tabs[0], tabs[1], tabs[1]), vidx, out_elem)


def plane_list_bound(planes, pairs, tabs, vidx, out_elem=1):
    """Bound of resizing ``planes``, plane i with the (wv, wh) ``pairs[i]``
    and the tables ``tabs[i]``, in one or more launches."""
    from imagekit_tpu_torch.ops.resize_strip import band_table

    nbytes = flops = 0.0
    for x, (wv, wh), t in zip(planes, pairs, tabs):
        out_px = x.shape[0] * wv.shape[1] * wh.shape[1]
        nb, fl = resize_bound(x.numel() * x.element_size(),
                              out_px * out_elem, wv, t.band_v,
                              band_table(wh), vidx, vidx, x.shape[2])
        nbytes += nb
        flops += fl
    return bound(nbytes, flops)


def planes_einsums(planes, stacks, vidx):
    """Yardstick: one fp32 einsum per plane over the gathered stacks and
    the plane widened to f32 beforehand (untimed), no epilogue."""
    return plane_list_einsums(planes, [stacks[:2]] + [stacks[2:]] * 2, vidx)


def plane_list_einsums(planes, pairs, vidx):
    """:func:`planes_einsums` with plane i's (wv, wh) ``pairs[i]``."""
    u = vidx.long()
    pairs = [(wv[u], wh[u]) for wv, wh in pairs]
    xs = [p.float() for p in planes]
    return lambda: [torch.einsum("boh,bhw,bpw->bop", wv_g, x_, wh_g)
                    for (wv_g, wh_g), x_ in zip(pairs, xs)]


def phase_k4_u8(jpegs) -> dict:
    """K4's u8-in / f32-out instantiation against its plain version, on
    the planes of the k = 8 JPEG -> WebP head: 1088x1920 luma -> 720x1280
    and 544x960 chroma -> 360x640 (half output resolution)."""
    from imagekit_tpu_torch.ops import resize_planes as rp

    result = {"max_abs_err": 0.0}
    for batch in (1, 32):
        call = capture_batch(jpegs, 1280, batch, "decode_resize_yuv_i8_batch")
        planes, stacks, vidx, tabs = k8_planes(call)
        if any(p.dtype != torch.uint8 for p in planes):
            raise RuntimeError("the IDCT's planes are not u8")
        before = rp.LAUNCHES_F32
        got = rp.resize_planes3_f32(planes, stacks, vidx, bands=tabs)
        torch.cuda.synchronize()
        if rp.LAUNCHES_F32 != before + 1:
            raise RuntimeError("the three planes did not take one K4 launch")
        ref = rp.resize_planes3_f32_plain(planes, stacks, vidx)
        for name, a, b in zip(("Y", "Cb", "Cr"), got, ref):
            err = float((a - b).abs().max())
            src = planes[0 if name == "Y" else 1]
            log(f"  K4 (u8 in, f32 out) vs plain B={batch} {name} "
                f"{tuple(src.shape[1:])} -> {tuple(a.shape[1:])}: "
                f"max|d|={err:.3e}")
            # fp32 sums of ~1000 terms in another order
            torch.testing.assert_close(a, b, rtol=1e-5, atol=255e-5)
            result["max_abs_err"] = max(result["max_abs_err"], err)
        del got, ref
    ms = device_ms(lambda: rp.resize_planes3_f32(planes, stacks, vidx,
                                                 bands=tabs))
    plain_ms = device_ms(lambda: rp.resize_planes3_f32_plain(planes, stacks,
                                                             vidx), reps=5)
    library_ms = device_ms(planes_einsums(planes, stacks, vidx), reps=5)
    bound_ms, bound_by = planes_bound(planes, 4, stacks, tabs, vidx)
    log(f"  timing B=32 1088x1920 -> 720x1280 (+ 2 x 544x960 -> 360x640), u8 "
        f"planes in, f32 out, one launch (device time per call): K4 {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, library (3 fp32 einsums on widened "
        f"planes) {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
        f"K4 at {bound_ms / ms:.1%} of it")
    result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by)
    return result


def phase_k2_yuv(webps) -> dict:
    """K2 on the Y, Cb and Cr views of a YUV-source batch, one launch, with
    the plain (WebP output) and the per-plane remap + centred (JPEG output)
    epilogues, against the plain version, on the batches the engine packs
    from decoded 1080p WebPs."""
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import dct, resize_strip
    from imagekit_tpu_torch.serving import engine_yuv

    result = {"max_abs_err": 0}
    timed = {}
    for jpeg in (False, True):
        what = "remap + centred i8" if jpeg else "rounded u8"
        for batch in (1, 32):
            call = capture_batch(
                webps, 400, batch,
                "resize_yuv_jpeg_batch" if jpeg else "resize_yuv420_batch",
                module=engine_yuv,
                fmt=ImageFormat.jpeg if jpeg else ImageFormat.webp)
            args, kw, _ = call
            flat, stacks, vidx = args[0], args[1], args[3 if jpeg else 2]
            in_shape = args[4 if jpeg else 3]
            planes = dct.yuv_planes(flat, *in_shape)
            before = resize_strip.LAUNCHES
            got = resize_strip.yuv_resize(planes, stacks, vidx, jpeg=jpeg,
                                          bands=kw["bands"])
            torch.cuda.synchronize()
            if resize_strip.LAUNCHES != before + 1:
                raise RuntimeError("yuv_resize did not launch K2 once")
            ref = resize_strip.yuv_resize_plain(planes, stacks, vidx,
                                                jpeg=jpeg)
            for name, a, b in zip(("Y", "Cb", "Cr"), got, ref):
                mx, share1 = check_band("K2 (three YUV planes)", a, b)
                log(f"  K2 vs plain B={batch} {name} {what} -> "
                    f"{tuple(a.shape[1:])} {a.dtype}: max|d|={mx} "
                    f"share(|d|=1)={share1:.3e} ({int((a != b).sum())} of "
                    f"{a.numel()} differ)")
                result["max_abs_err"] = max(result["max_abs_err"], mx)
        t_k = device_ms(lambda: resize_strip.yuv_resize(
            planes, stacks, vidx, jpeg=jpeg, bands=kw["bands"]))
        t_p = device_ms(lambda: resize_strip.yuv_resize_plain(
            planes, stacks, vidx, jpeg=jpeg))
        timed[jpeg] = (t_k, t_p)
        if not jpeg:
            library_ms = device_ms(planes_einsums(planes, stacks, vidx))
            bound_ms, bound_by = planes_bound(planes, 1, stacks, kw["bands"],
                                              vidx)
    (ms, plain_ms), (ms_j, plain_j) = timed[False], timed[True]
    log(f"  timing B=32 1088x1920 -> 240x400 (+ 2 x 544x960 -> 120x200), "
        f"three planes of the flat batch in one launch (device time per "
        f"call): K2 {ms:.4f} ms, plain {plain_ms:.4f} ms, library (3 fp32 "
        f"einsums on widened planes, no epilogue) {library_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}), K2 at {bound_ms / ms:.1%} of it; "
        f"with the per-plane remap + centred epilogue: K2 {ms_j:.4f} ms, "
        f"plain {plain_j:.4f} ms")
    result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by, ms_jpeg=ms_j,
                  plain_ms_jpeg=plain_j)
    return result


# ---------------------------------------------------------------------------
# phase 12: the engine paths of JPEG -> WebP at every downscale and of lossy
# WebP sources
# ---------------------------------------------------------------------------


def device_busy_s(prof):
    """Seconds in which the card ran at least one kernel or copy: the union
    of the device activities' intervals of a ``torch.profiler`` trace, read
    from its raw kineto records (``prof.events()`` builds every host op's
    event tree first, which took seconds a round of pixel decodes, up to
    23 s on an H100 for a round of segment-by-segment TIFF pages). None
    where the trace holds no device record."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)
    if not spans:
        return None
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e9


def idle_share(run, on_card: bool = True, traced: str = "this"):
    """(the device's idle share in a round's traced run, its log line).
    ``on_card``: whether the round's requests use the card at all; a round
    that does not is idle throughout. A round that does and whose trace
    holds no device record (CUPTI now and then returns such a trace) has no
    idle share: the launch counts, not the trace, prove its kernels ran."""
    busy = run["busy"] if on_card else (run["busy"] or 0.0)
    if busy is None:
        return None, ("    device idle share not measured (the traced round's "
                      "trace holds no device record)")
    idle = 1.0 - busy / run["traced_wall"]
    return idle, (f"    device idle share {idle:.1%} (busy {busy:.4f} s of "
                  f"{run['traced_wall']:.4f} s in {traced} round)")


def check_path_batch(head: str, call) -> tuple:
    """A recorded batch of one of the new heads against the plain head on
    the same inputs: (max |d|, share(|d|=1))."""
    from imagekit_tpu_torch.ops import color, dct, jpeg8, resize, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp

    args, kw, out = call
    bands = kw["bands"]
    if head == "decode_resize_yuv_lowfreq_i8_batch":
        inp, k = k1_inputs(call)
        plain = jpeg8.folded_planes_i8_plain(*inp, k)
    elif head == "resample_rgb_yuv_batch":
        x, (wv, wh), vidx, hidx = args[:4]
        plain = color.rgb_yuv_head(x, wv, wh, vidx, hidx, bands,
                                   resize=resize_strip.rgb_resize_plain)
    elif head == "resample_bucketed_flat":
        x, wv, wh, vidx, hidx, ch = args
        plain = resize.resample_flat(x, wv, wh, vidx, hidx, ch, bands,
                                     resize=resize_strip.rgba_resize_plain)
        return check_band(f"the head {head}", torch.from_numpy(
            out.reshape(out.shape[0], -1)).to(plain.device), plain)
    elif head == "decode_resize_yuv_i8_batch":
        dcs, acs, escs, qt, stacks, vidx, block_dims = args[:7]
        plain = dct.decode_resize_yuv_i8(
            dcs, acs, escs, qt, stacks, vidx, block_dims, bands,
            resize=rp.resize_planes3_f32_plain)
    elif head == "decode_resize_yuv_batch":
        y, cb, cr, qt, stacks, vidx, block_dims = args[:7]
        plain = dct.decode_resize_yuv(y, cb, cr, qt, stacks, vidx, block_dims,
                                      bands, resize=rp.resize_planes3_f32_plain)
    elif head == "decode_resize_yuv_lowfreq_batch":
        inp, k = k1_i16_inputs(call)
        plain = jpeg8.folded_planes_i16_plain(*inp, k)
    elif head == "resize_yuv420_batch":
        flat, stacks, vidx, in_shape = args[:4]
        plain = dct.resize_yuv420(flat, stacks, vidx, in_shape, bands,
                                  resize=resize_strip.yuv_resize_plain)
    else:
        flat, stacks, qto, vidx, in_shape = args[:5]
        plain = dct.resize_yuv_jpeg(flat, stacks, qto, vidx, in_shape, bands,
                                    resize=resize_strip.yuv_resize_plain)
    return check_band(f"the head {head}", flat_planes(out, plain), plain)


def phase_new_paths(jpegs, dense, webps, card: str) -> dict:
    """Five rounds of 32 concurrent requests through one engine, the launch
    counts set to 0 before each and read after it: 1080p JPEG -> w=1280 WebP
    (k = 8, K4); escape-dense JPEG -> w=400 WebP (int16 transport, K1) and
    -> w=1280 WebP (int16, K4); 1080p lossy WebP -> w=400 WebP and -> JPEG
    (K2). Each round runs once, under ``torch.profiler`` for the device's
    idle share."""
    from torch.profiler import ProfilerActivity, profile

    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import jpeg8, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving import engine_jpeg, engine_yuv
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    W, J = ImageFormat.webp, ImageFormat.jpeg
    # (name, sources, width, format, output size, head, the kernel it launches)
    rounds = (
        ("1080p JPEG -> w=1280 WebP (k=8, split int8)", jpegs, 1280, W,
         (1280, 720), "decode_resize_yuv_i8_batch", "k4"),
        ("escape-dense JPEG -> w=400 WebP (k=2, int16)", dense, 400, W,
         (400, 225), "decode_resize_yuv_lowfreq_batch", "k1"),
        ("escape-dense JPEG -> w=1280 WebP (k=8, int16)", dense, 1280, W,
         (1280, 720), "decode_resize_yuv_batch", "k4"),
        ("1080p lossy WebP -> w=400 WebP", webps, 400, W, (400, 225),
         "resize_yuv420_batch", "k2"),
        ("1080p lossy WebP -> w=400 JPEG", webps, 400, J, (400, 225),
         "resize_yuv_jpeg_batch", "k2"),
    )
    n_req = 32
    metrics = Metrics()
    # no load shedding: every request of a round is served and measured
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("entropy_decode", "vp8_decode", "batch_build",
              "device_decode_resize", "device_resize", "encode")

    def counts():
        return {"k1": jpeg8.LAUNCHES, "k2": resize_strip.LAUNCHES,
                "k3": rp.LAUNCHES, "k4": rp.LAUNCHES_F32}

    async def one(data, w, fmt):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, fmt, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            runs = []
            for _, srcs, w, fmt, *_ in rounds:
                reqs = [(srcs[i % len(srcs)], w, fmt) for i in range(n_req)]
                await asyncio.gather(*(one(*r) for r in reqs[:4]))  # warm
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                jpeg8.LAUNCHES = resize_strip.LAUNCHES = 0
                rp.LAUNCHES = rp.LAUNCHES_F32 = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    res = await asyncio.gather(*(one(*r) for r in reqs))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                runs.append({"res": res, "wall": wall, "traced_wall": wall,
                             **counts(), "busy": device_busy_s(prof),
                             "batches": metrics.batches - batches0,
                             "spent": {k: metrics.stage_seconds[k] - stage0[k]
                                       for k in stages}})
            return runs
        finally:
            await engine.close()

    heads = sorted({r[5] for r in rounds})
    recs = {h: Recorder(engine_yuv if h.startswith("resize_yuv")
                        else engine_jpeg, h) for h in heads}
    for rec in recs.values():
        rec.__enter__()
    try:
        runs = asyncio.run(drive())
    finally:
        for rec in recs.values():
            rec.__exit__()
    lib = loader.load()
    summary = {}
    for (name, _, _, fmt, size, head, kern), run in zip(rounds, runs):
        for out, _ in run["res"]:
            if fmt == W:
                dims = vp8.dimensions(out) if out[8:12] == b"WEBP" else None
            else:
                hdr = jpeg_abi.parse(lib, out)
                dims = (hdr.width, hdr.height)
            if dims != size:
                raise RuntimeError(f"{name}: {fmt.value} output is {dims}, "
                                   f"not {size}")
        p50, p99 = latency(run["res"])
        rps = n_req / run["wall"]
        idle, idle_line = idle_share(run)
        launched = {k: run[k] for k in ("k1", "k2", "k3", "k4")}
        log(f"  {name}: {n_req} concurrent requests in {run['wall']:.4f} s "
            f"(traced) "
            f"-> {rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
            f"{run['batches']} batches, launches {launched} [{card}]")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
            for k, v in run["spent"].items() if v > 0))
        log(idle_line)
        others = [k for k in launched if k != kern and launched[k]]
        if run["batches"] <= 0 or launched[kern] != run["batches"] or others:
            raise RuntimeError(
                f"{name}: {launched} launches for {run['batches']} batches; "
                f"expected one {kern.upper()} launch per batch and no other")
        calls = recs[head].calls
        if not calls:
            raise RuntimeError(f"{name}: the head {head} was not called")
        mx, share1 = check_path_batch(head, calls[-1])
        log(f"    last batch ({head}) vs plain head: max|d|={mx} "
            f"share(|d|=1)={share1:.3e}")
        summary[head] = {"launches": launched[kern], "batches": run["batches"],
                         "rps": rps, "p50_ms": p50, "p99_ms": p99,
                         "idle_share": idle}
    return summary


# ---------------------------------------------------------------------------
# phase 13: K2's four-channel entry against its plain version
# ---------------------------------------------------------------------------


def phase_k2_rgba(rgba_images) -> dict:
    """``rgba_images``: synthesized 1920x1080 RGBA images."""
    from imagekit_tpu_torch.ops import resize, resize_strip
    from imagekit_tpu_torch.ops.resize_strip import band_table

    result = {"max_abs_err": 0}
    wv, wh, tabs = k2_stacks((1088, 1920, 240, 400, 4, ""), SLICE_V, SLICE_H)
    host = np.zeros((32, 1088, 1920 * 4), np.uint8)
    for i in range(32):
        host[i, :1080] = rgba_images[i % len(rgba_images)].reshape(1080, -1)
    flat = torch.from_numpy(host).cuda()
    for batch in (1, 32):
        x = flat[:batch]
        vidx, hidx = k2_index(batch)
        before = resize_strip.LAUNCHES_RGBA
        got = resize_strip.rgba_resize(x, wv, wh, vidx, hidx, bands=tabs)
        torch.cuda.synchronize()
        if resize_strip.LAUNCHES_RGBA != before + 1:
            raise RuntimeError("rgba_resize did not launch K2 once")
        ref = resize_strip.rgba_resize_plain(x, wv, wh, vidx, hidx)
        mx, share1 = check_band("K2 (four channels)", got, ref)
        log(f"  K2 (4 channels) vs plain B={batch} -> {tuple(got.shape)} "
            f"{got.dtype}, interleaved: max|d|={mx} share(|d|=1)={share1:.3e}"
            f" ({int((got != ref).sum())} of {got.numel()} differ)")
        result["max_abs_err"] = max(result["max_abs_err"], mx)
        head = resize.resample_flat(x, wv, wh, vidx, hidx, 4, tabs)
        if not torch.equal(head, got.reshape(batch, -1)):
            raise RuntimeError("the plain RGB head is not K2's output")
    vidx, hidx = k2_index(32)
    ms = device_ms(lambda: resize_strip.rgba_resize(flat, wv, wh, vidx, hidx,
                                                    bands=tabs))
    plain_ms = device_ms(lambda: resize_strip.rgba_resize_plain(
        flat, wv, wh, vidx, hidx), reps=5)
    # yardstick: one fp32 einsum per channel over the gathered stacks and
    # the channel widened to f32 beforehand (untimed), no epilogue
    wv_g, wh_g = wv[vidx.long()], wh[hidx.long()]
    full = flat.reshape(32, 1088, 1920, 4)
    chans = [full[..., c].float() for c in range(4)]
    library_ms = device_ms(lambda: [torch.einsum("boh,bhw,bpw->bop", wv_g, x_,
                                               wh_g) for x_ in chans], reps=5)
    del chans, wv_g, wh_g, full
    nbytes, flops = resize_bound(flat.numel(), 4 * 32 * 240 * 400, wv,
                                 tabs.band_v, band_table(wh), vidx, hidx,
                                 1920)
    bound_ms, bound_by = bound(nbytes, 4 * flops)
    # the batch's upload, as the engine's _placement copies it
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        _ = torch.from_numpy(host).pin_memory().to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
    pinned = torch.from_numpy(host).pin_memory()
    dma = cuda_ms(lambda: pinned.to("cuda", non_blocking=True), reps=5)
    log(f"  timing B=32 1088x1920x4 -> 240x400x4, one launch (device time "
        f"per call, torch.profiler over 20): K2 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (4 fp32 einsums, no epilogue) "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), K2 at "
        f"{bound_ms / ms:.1%} of it; H2D of the {host.nbytes / 1e6:.1f} MB "
        f"batch: pin + copy {statistics.median(host_s) * 1e3:.2f} ms (host "
        f"clock, median of 3), DMA of pinned memory {dma:.4f} ms")
    result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by, h2d_ms=dma,
                  pin_h2d_ms=statistics.median(host_s) * 1e3)
    return result


# ---------------------------------------------------------------------------
# phase 14: sources with alpha, BMP / TIFF / GIF sources, no-resize requests
# ---------------------------------------------------------------------------


def out_dims(out: bytes):
    """(format, width, height) of an encoded output."""
    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader

    if out[:4] == b"RIFF" and out[8:12] == b"WEBP":
        return ("webp", *vp8.dimensions(out))
    if out[4:8] == b"ftyp":
        from imagekit_tpu_torch.codecs import avif_native

        return ("avif", *avif_native.header_dimensions(out))
    hdr = jpeg_abi.parse(loader.load(), out)
    return ("jpeg", hdr.width, hdr.height)


def phase_alpha_and_single(rgba_pngs, others, jpegs, pngs, webps,
                           card: str) -> dict:
    """Rounds through one engine, the launch counts set to 0 before each and
    read after it; each round runs once, traced.
    ``others``: BMP, TIFF and GIF sources of 1920x1080."""
    from torch.profiler import ProfilerActivity, profile

    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import dct, jpeg8, resize, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving import engine_rgb
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    W, J = ImageFormat.webp, ImageFormat.jpeg
    full = (1920, 1080)
    # (name, sources, requests, width, format, output size, the kernel it
    # launches, launches expected: "batch" one a batch, "request" one a
    # request, None none)
    rounds = [
        ("1080p RGBA PNG -> w=400 WebP (plain RGB head)", rgba_pngs, 32, 400,
         W, (400, 225), "k2_rgba", "batch"),
        ("1080p RGBA PNG -> w=400 JPEG (plain RGB head)", rgba_pngs, 32, 400,
         J, (400, 225), "k2_rgba", "batch"),
        ("1080p BMP, TIFF and GIF -> w=400 WebP (rgbyuv head)", others, 12,
         400, W, (400, 225), "k2", "batch"),
    ]
    for src_name, srcs in (("JPEG", jpegs), ("PNG", pngs), ("WebP", webps)):
        for fmt in (W, J):
            rounds.append((
                f"1080p {src_name} -> {fmt.value}, no resize", srcs, 16, None,
                fmt, full, "k3" if src_name == "JPEG" else None,
                "request" if src_name == "JPEG" else None))
    metrics = Metrics()
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("decode_png", "decode", "entropy_decode", "device_decode",
              "batch_build", "device_resize", "device_encode", "encode")

    def counts():
        return {"k1": jpeg8.LAUNCHES, "k2": resize_strip.LAUNCHES,
                "k2_rgba": resize_strip.LAUNCHES_RGBA, "k3": rp.LAUNCHES,
                "k4": rp.LAUNCHES_F32}

    async def one(data, w, fmt):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, fmt, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            runs = []
            for _, srcs, n_req, w, fmt, *_ in rounds:
                reqs = [(srcs[i % len(srcs)], w, fmt) for i in range(n_req)]
                await asyncio.gather(*(one(*r) for r in reqs[:4]))  # warm
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                jpeg8.LAUNCHES = resize_strip.LAUNCHES = 0
                resize_strip.LAUNCHES_RGBA = 0
                rp.LAUNCHES = rp.LAUNCHES_F32 = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    res = await asyncio.gather(*(one(*r) for r in reqs))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                # busy None for a WebP from a PNG or a WebP with no resize,
                # which never touches the card
                runs.append({"res": res, "wall": wall, "traced_wall": wall,
                             **counts(), "busy": device_busy_s(prof),
                             "batches": metrics.batches - batches0,
                             "spent": {k: metrics.stage_seconds[k] - stage0[k]
                                       for k in stages}})
            return runs
        finally:
            await engine.close()

    with Recorder(engine_rgb, "resample_bucketed_flat") as rec_flat, \
            Recorder(engine_rgb, "resample_rgb_yuv_batch") as rec_yuv, \
            Recorder(dct, "decode_resize_rgb_batch") as rec_rgb:
        runs = asyncio.run(drive())
    summary = {}
    for (name, _, n_req, _, fmt, size, kern, per), run in zip(rounds, runs):
        for out, _ in run["res"]:
            if out_dims(out) != (fmt.value, *size):
                raise RuntimeError(f"{name}: output is {out_dims(out)}, not "
                                   f"{fmt.value} {size}")
        p50, p99 = latency(run["res"])
        rps = n_req / run["wall"]
        idle, idle_line = idle_share(run, bool(kern) or any(
            v > 0 for k, v in run["spent"].items() if k.startswith("device")))
        launched = {k: run[k] for k in ("k1", "k2", "k2_rgba", "k3", "k4")}
        log(f"  {name}: {n_req} concurrent requests in {run['wall']:.4f} s "
            f"(traced) "
            f"-> {rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
            f"{run['batches']} batches, launches {launched} [{card}]")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
            for k, v in run["spent"].items() if v > 0))
        log(idle_line)
        want = {"batch": run["batches"], "request": n_req, None: 0}[per]
        others_launched = [k for k in launched if k != kern and launched[k]]
        if (per == "batch" and run["batches"] <= 0) or others_launched or (
                kern and launched[kern] != want) or (
                per != "batch" and run["batches"]):
            raise RuntimeError(
                f"{name}: {launched} launches and {run['batches']} batches; "
                f"expected {want} of {kern} and no other")
        summary[name] = {"launches": launched[kern] if kern else 0,
                         "batches": run["batches"], "rps": rps,
                         "p50_ms": p50, "p99_ms": p99, "idle_share": idle}

    # the last RGBA batch against the plain head on the same inputs
    args, kw, out = rec_flat.calls[-1]
    x, wv, wh, vidx, hidx, ch = args
    plain = resize.resample_flat(x, wv, wh, vidx, hidx, ch, kw["bands"],
                                 resize=resize_strip.rgba_resize_plain)
    mx, share1 = check_band(
        "the plain RGB head",
        torch.from_numpy(out.reshape(out.shape[0], -1)).to(plain.device),
        plain)
    log(f"  last RGBA batch (resample_bucketed_flat, {ch} channels) vs plain "
        f"head: max|d|={mx} share(|d|=1)={share1:.3e}")
    if not rec_yuv.calls:
        raise RuntimeError("the BMP / TIFF / GIF round did not reach the "
                           "rgbyuv head")
    # the last JPEG pixel decode (K3) against the plain head, and one
    # no-resize JPEG -> JPEG output against its source
    mx_rgb, share_rgb = check_rgb_batch(rec_rgb.calls[-1])
    src_px = jpeg.decode_rgb(jpegs[0], device="cuda")
    j_round = runs[[r[0] for r in rounds].index(
        "1080p JPEG -> jpeg, no resize")]
    out_px = jpeg.decode_rgb(j_round["res"][0][0], device="cuda")
    err = src_px.astype(np.float64) - out_px.astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / max(float((err ** 2).mean()), 1e-12))
    log(f"  last JPEG pixel decode (K3) vs plain head: max|d|={mx_rgb} "
        f"share(|d|>0)={share_rgb:.3e}; no-resize JPEG -> JPEG q80 against "
        f"its source: PSNR {psnr:.2f} dB")
    if src_px.shape != (1080, 1920, 3) or psnr < 30.0:
        raise RuntimeError("the no-resize JPEG output is not its source")
    summary["rgba_launches"] = sum(
        summary[r[0]]["launches"] for r in rounds if r[6] == "k2_rgba")
    summary["pixel_decode_launches"] = sum(
        summary[r[0]]["launches"] for r in rounds if r[6] == "k3")
    return summary


# ---------------------------------------------------------------------------
# phase 15: AVIF output through every head
# ---------------------------------------------------------------------------


def avif_info(data: bytes):
    """(major brand, [ispe (w, h)], alpha auxiliary item?) of an AVIF body,
    from its ftyp and meta/iprp/ipco boxes."""
    def boxes(start, end):
        i = start
        while i + 8 <= end:
            size, typ = struct.unpack(">I4s", data[i:i + 8])
            if not 8 <= size <= end - i:
                raise RuntimeError(f"malformed AVIF box {typ!r}")
            yield typ, i + 8, i + size
            i += size

    top = {t: (a, b) for t, a, b in boxes(0, len(data))}
    if b"ftyp" not in top or b"meta" not in top:
        raise RuntimeError(f"not an AVIF file: {data[:16]!r}")
    brand = data[top[b"ftyp"][0]:top[b"ftyp"][0] + 4]
    meta = {t: (a, b) for t, a, b in boxes(top[b"meta"][0] + 4,
                                            top[b"meta"][1])}
    iprp = {t: (a, b) for t, a, b in boxes(*meta[b"iprp"])}
    ispe, alpha = [], False
    for t, a, b in boxes(*iprp[b"ipco"]):
        if t == b"ispe":
            ispe.append(struct.unpack(">II", data[a + 4:a + 12]))
        elif t == b"auxC":
            alpha = b"auxiliary:alpha" in data[a:b]
    return brand, ispe, alpha


def phase_avif(jpegs, dense, pngs, webps, rgba_pngs, card: str) -> dict:
    """One round a head through one engine, AVIF output, the launch counts
    set to 0 before each round and read after it. Each round runs once,
    under ``torch.profiler`` (CUDA activity only) for the device's idle
    share: the first-party AV1 encoder on the host takes seconds a picture,
    so a second, untraced round would double the phase for no new number."""
    from torch.profiler import ProfilerActivity, profile

    from imagekit_tpu_torch.codecs import av1_image
    from imagekit_tpu_torch.codecs.native import av1_abi
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import dct, jpeg8, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving import engine_jpeg, engine_rgb, engine_yuv
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    # the encoder's C entropy engine and leaf evaluation (both raise where
    # they cannot load); without them it would run ~40x slower in Python
    if av1_abi.load() is None or av1_image._leaf_lib() is None:
        raise RuntimeError("the AV1 encoder's C engine is not loaded")
    small = make_jpeg(300, 80, lambda s: synth_image(s, 640, 360))
    still = make_jpeg(301, 80, lambda s: synth_image(s, 320, 240))
    # (name, sources, width, output size, head module and function, the
    # kernel it launches, one launch a "batch" or a "request", alpha?)
    rounds = (
        ("1080p JPEG -> w=400 AVIF (k=2, split int8)", jpegs[:1], 400,
         (400, 225), (engine_jpeg, "decode_resize_yuv_lowfreq_i8_batch"),
         "k1", "batch", False),
        ("escape-dense JPEG -> w=400 AVIF (k=2, int16)", dense[:1], 400,
         (400, 225), (engine_jpeg, "decode_resize_yuv_lowfreq_batch"), "k1",
         "batch", False),
        ("640x360 JPEG -> w=480 AVIF (k=8)", [small], 480, (480, 270),
         (engine_jpeg, "decode_resize_yuv_i8_batch"), "k4", "batch", False),
        ("1080p RGB PNG -> w=400 AVIF (rgbyuv head)", pngs[:1], 400,
         (400, 225), (engine_rgb, "resample_rgb_yuv_batch"), "k2", "batch",
         False),
        ("1080p lossy WebP -> w=400 AVIF (yuv_resize)", webps[:1], 400,
         (400, 225), (engine_yuv, "resize_yuv420_batch"), "k2", "batch",
         False),
        ("1080p RGBA PNG -> w=400 AVIF with alpha (plain RGB head)",
         rgba_pngs[:1], 400, (400, 225),
         (engine_rgb, "resample_bucketed_flat"), "k2_rgba", "batch", True),
        ("320x240 JPEG -> AVIF, no resize (the pixel decode)", [still], None,
         (320, 240), (dct, "decode_resize_rgb_batch"), "k3", "request",
         False),
    )
    metrics = Metrics()
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("decode_png", "vp8_decode", "entropy_decode", "device_decode",
              "batch_build", "device_decode_resize", "device_resize",
              "encode")

    def counts():
        return {"k1": jpeg8.LAUNCHES, "k2": resize_strip.LAUNCHES,
                "k2_rgba": resize_strip.LAUNCHES_RGBA, "k3": rp.LAUNCHES,
                "k4": rp.LAUNCHES_F32}

    async def one(data, w):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, ImageFormat.avif, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            runs = []
            for _, srcs, w, *_ in rounds:
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                wait0 = metrics.stage_wait_seconds["encode"]
                jpeg8.LAUNCHES = resize_strip.LAUNCHES = 0
                resize_strip.LAUNCHES_RGBA = 0
                rp.LAUNCHES = rp.LAUNCHES_F32 = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    res = await asyncio.gather(*(one(d, w) for d in srcs))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                runs.append({"res": res, "wall": wall, "traced_wall": wall,
                             **counts(), "busy": device_busy_s(prof),
                             "batches": metrics.batches - batches0,
                             "encode_wait": metrics.stage_wait_seconds[
                                 "encode"] - wait0,
                             "spent": {k: metrics.stage_seconds[k] - stage0[k]
                                       for k in stages}})
            return runs
        finally:
            await engine.close()

    recs = [Recorder(*r[4]) for r in rounds]
    for rec in recs:
        rec.__enter__()
    try:
        runs = asyncio.run(drive())
    finally:
        for rec in reversed(recs):
            rec.__exit__()
    summary = {}
    for (name, srcs, _, size, (_, head), kern, per, alpha), run, rec in zip(
            rounds, runs, recs):
        n_req = len(srcs)
        for out, _ in run["res"]:
            info = avif_info(out)
            if info != (b"avif", [size], alpha):
                raise RuntimeError(f"{name}: (brand, ispe, alpha item) "
                                   f"{info}, not (avif, {[size]}, {alpha})")
        p50, p99 = latency(run["res"])
        rps = n_req / run["wall"]
        idle, idle_line = idle_share(run, traced="the")
        launched = {k: run[k] for k in ("k1", "k2", "k2_rgba", "k3", "k4")}
        want = run["batches"] if per == "batch" else n_req
        others = [k for k in launched if k != kern and launched[k]]
        if want <= 0 or launched[kern] != want or others or (
                per == "request" and run["batches"]):
            raise RuntimeError(
                f"{name}: {launched} launches and {run['batches']} batches; "
                f"expected one {kern} launch a {per} and no other")
        if not rec.calls:
            raise RuntimeError(f"{name}: the head {head} was not called")
        if kern == "k3":
            mx, share1 = check_rgb_batch(rec.calls[-1])
        else:
            mx, share1 = check_path_batch(head, rec.calls[-1])
        enc, wait = run["spent"]["encode"], run["encode_wait"]
        log(f"  {name}: AV1 encode {enc / n_req:.4f} s a picture, "
            f"{wait / n_req:.4f} s a request in the AVIF thread's queue; "
            f"{n_req} concurrent requests in {run['wall']:.4f} s, "
            f"{run['batches']} batches, launches {launched} [{card}]")
        log(f"    one encode a request on one thread, not a throughput: "
            f"{rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms (of "
            f"{n_req}: the slowest)")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
            for k, v in run["spent"].items() if v > 0))
        log(idle_line)
        log(f"    last batch ({head}) vs plain head: max|d|={mx} "
            f"share(|d|{'>0' if kern == 'k3' else '=1'})={share1:.3e}; "
            f"{sum(len(o) for o, _ in run['res']) / n_req / 1e3:.1f} kB a "
            f"body")
        summary[head] = {
            "launches": launched[kern], "batches": run["batches"],
            "encode_s": enc / n_req, "encode_wait_s": wait / n_req,
            "idle_share": idle}
    return summary


def phase_avif_mixed(jpegs, card: str) -> dict:
    """WebP traffic with AVIF requests among it, through one engine at the
    default latency budget (2 s): 32 JPEG -> w=400 WebP alone, then the
    same 32 with 2 AVIF requests at once (what an AVIF backlog does to
    WebP latency), then 4 AVIF requests at once, which the AVIF lane's
    own admission bound must shed as its rule says: the k-th is admitted
    while k AVIF requests ahead times the mean measured encode seconds
    stay within the budget."""
    from imagekit_tpu_torch.config import ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.errors import EngineOverloaded
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    engine = BatchedEngine(ImageKitConfig(secret=SECRET), metrics=Metrics(),
                           device="cuda")
    webp = [(jpegs[i % len(jpegs)], ImageFormat.webp) for i in range(32)]
    avif = [(jpegs[i], ImageFormat.avif) for i in range(4)]

    async def one(data, fmt):
        t0 = time.perf_counter()
        try:
            out = await engine.transform(data, 400, None, fmt, 80)
        except EngineOverloaded:
            out = None
        return out, time.perf_counter() - t0, fmt

    async def drive():
        try:
            await engine.warmup()
            await asyncio.gather(*(one(d, f) for d, f in webp))  # warm
            alone = await asyncio.gather(*(one(d, f) for d, f in webp))
            mixed = await asyncio.gather(*(one(d, f)
                                           for d, f in avif[:2] + webp))
            secs = list(engine._avif_secs)
            burst = await asyncio.gather(*(one(d, f) for d, f in avif))
            return alone, mixed, secs, burst
        finally:
            await engine.close()

    alone, mixed, secs, burst = asyncio.run(drive())
    for out, _, fmt in alone + mixed + burst:
        if out is None:
            continue
        want = (b"WEBP", b"avif")[fmt == ImageFormat.avif]
        if want not in out[:16]:
            raise RuntimeError(f"mixed round: a {fmt.value} body is "
                               f"{out[:16]!r}")
    if any(out is None for out, _, _ in alone + mixed):
        raise RuntimeError("mixed round: a request was shed below the "
                           "AVIF lane's bound")
    est = sum(secs) / len(secs)
    admit = sum(k * est <= engine.admit_budget_s for k in range(len(avif)))
    served = [out is not None for out, _, _ in burst]
    if served != [k < admit for k in range(len(avif))]:
        raise RuntimeError(f"AVIF burst: served {served}, the bound admits "
                           f"the first {admit} at {est:.4f} s an encode")
    w_alone = latency([(o, t) for o, t, _ in alone])
    w_mixed = latency([(o, t) for o, t, f in mixed
                       if f == ImageFormat.webp])
    a_mixed = [t for _, t, f in mixed if f == ImageFormat.avif]
    log(f"  mixed: 32 JPEG -> w=400 WebP alone p50 {w_alone[0]:.2f} ms, "
        f"p99 {w_alone[1]:.2f} ms; with 2 AVIF among them p50 "
        f"{w_mixed[0]:.2f} ms, p99 {w_mixed[1]:.2f} ms (single rounds); "
        f"the 2 AVIF in {', '.join(f'{t:.4f}' for t in a_mixed)} s [{card}]")
    log(f"  AVIF burst of {len(avif)} at a {engine.admit_budget_s} s budget "
        f"and {est:.4f} s an encode (mean of {len(secs)}): served "
        f"{sum(served)}, shed {len(avif) - sum(served)} (429), as the "
        f"AVIF lane's bound says")
    return {"webp_alone_ms": w_alone, "webp_mixed_ms": w_mixed,
            "avif_mixed_s": a_mixed, "encode_s": est,
            "served": sum(served)}


# ---------------------------------------------------------------------------
# phase 16: images beyond the bucket ladder
# ---------------------------------------------------------------------------

# the shapes of the phase: a full-page screenshot, a panorama, an RGBA
# banner at the plain head's 8192 bucket, a 1080p upscale past the ladder
PAGE = (1440, 12000)     # w, h
PANORAMA = (9600, 2400)
BANNER = (7200, 1800)
UPSCALE_W = 9000
MAX_INPUT = 8 * 1024 * 1024  # the service's input cap (config.py)


def page_image(w: int, h: int, seed: int, alpha: bool = False) -> np.ndarray:
    """Seeded page-like image, as a full-page screenshot or a tall
    infographic is: a near-white page, flat coloured panels and lines of
    dark text-like glyph cells; with ``alpha`` a fourth channel, a ramp
    under the opaque panels (a banner over a page). No noise: its PNG stays
    under the service's 8 MB input cap."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 248, np.uint8)
    alpha_ch = (np.add.outer(np.arange(h), np.arange(w)) * 200
                // (h + w)).astype(np.uint8) + 40
    for _ in range(max(12, h * w // 600_000)):
        pw, ph = int(rng.integers(64, w // 2)), int(rng.integers(32, 600))
        x0, y0 = int(rng.integers(0, w - pw)), int(rng.integers(0, h - ph))
        img[y0:y0 + ph, x0:x0 + pw] = rng.integers(0, 256, 3)
        alpha_ch[y0:y0 + ph, x0:x0 + pw] = 255
    cells = (w + 5) // 6
    for y in range(24, h - 16, 18):  # a text line every 18 rows
        if rng.random() < 0.25:
            continue  # paragraph gaps
        glyphs = np.repeat(rng.random(cells) < 0.55, 6)[:w]
        glyphs[: int(rng.integers(20, 80))] = False  # margins
        glyphs[w - int(rng.integers(20, w // 3)):] = False
        img[y:y + 11, glyphs] = rng.integers(0, 90, 3)
    return np.dstack([img, alpha_ch]) if alpha else img


def exact_plain(img: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
    """K2's plain version at the exact shape on the card, from the stacks
    the exact-shape path builds: (out_h, out_w, C) u8."""
    from imagekit_tpu_torch.ops import resize_strip
    from imagekit_tpu_torch.ops.weights import exact_stacks

    h, w, ch = img.shape
    wv, wh = (torch.from_numpy(a).cuda() for a in exact_stacks(h, w, out_h,
                                                                out_w))
    x = torch.zeros((1, h, wh.shape[2] * ch), dtype=torch.uint8,
                    device="cuda")
    x.view(1, h, -1, ch)[0, :, :w] = torch.from_numpy(img).cuda()
    idx = torch.zeros(1, dtype=torch.int32, device="cuda")
    if ch == 4:
        return resize_strip.rgba_resize_plain(x, wv, wh, idx, idx)[0]
    return resize_strip.rgb_resize_plain(x, wv, wh, idx, idx)[0].permute(
        1, 2, 0)


def strip_case(x, wv, wh, vidx, hidx, channels: int, strip: int = 0):
    """One of the phase's K2 cases: checks, times and bounds the kernel
    (column strips where ``strip`` asks or the rows need them) against its
    plain version and one fp32 einsum per channel; returns its numbers."""
    from imagekit_tpu_torch.ops import resize_strip
    from imagekit_tpu_torch.ops.resize_strip import band_table, resize_tables

    tabs = resize_tables(wv, wh)
    entry = resize_strip.rgba_resize if channels == 4 else resize_strip.rgb_resize
    plain = (resize_strip.rgba_resize_plain if channels == 4
             else resize_strip.rgb_resize_plain)
    before = resize_strip.LAUNCHES_STRIPS
    got = entry(x, wv, wh, vidx, hidx, bands=tabs, strip=strip)
    torch.cuda.synchronize()
    if resize_strip.LAUNCHES_STRIPS != before + 1:
        raise RuntimeError("K2 did not take its column strips")
    ref = plain(x, wv, wh, vidx, hidx)
    mx, share1 = check_band("K2 in column strips", got, ref)
    B, H, WC = x.shape
    W = WC // channels
    oh, ow = wv.shape[1], wh.shape[1]
    ms = device_ms(lambda: entry(x, wv, wh, vidx, hidx, bands=tabs,
                                 strip=strip))
    plain_ms = device_ms(lambda: plain(x, wv, wh, vidx, hidx), reps=5)
    wv_g, wh_g = wv[vidx.long()], wh[hidx.long()]
    chans = [x.reshape(B, H, W, channels)[..., c].float()
             for c in range(channels)]
    library_ms = device_ms(lambda: [torch.einsum("boh,bhw,bpw->bop", wv_g,
                                                 x_, wh_g) for x_ in chans],
                           reps=5)
    del chans, wv_g, wh_g
    nbytes, flops = resize_bound(x.numel(), channels * B * oh * ow, wv,
                                 tabs.band_v, band_table(wh), vidx, hidx, W)
    bound_ms, bound_by = bound(nbytes, channels * flops)
    return {"got": got, "max_abs_err": mx, "share1": share1, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_oversized(images, rgba_images, jpeg_1080: bytes, k2: dict,
                    k2_rgba: dict, card: str) -> dict:
    """K2's column strips (against whole rows at the flagship shapes,
    against the plain version at the wide shapes), then requests beyond the
    bucket ladder through one engine, the launch counts set to 0 before
    each round and read after it. Returns the strip entry's numbers and the
    page PNG (for the HTTP phase)."""
    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import jpeg8, resize, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops import weights
    from imagekit_tpu_torch.serving import batcher, engine_rgb
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics
    from imagekit_tpu_torch.utils.bucketing import bucket_for

    out = {}
    # -- strips against whole rows at the flagship shapes (B=32)
    for channels, imgs, whole in ((3, images, k2), (4, rgba_images, k2_rgba)):
        key = (1088, 1920, 240, 400, channels, "yuv" if channels == 3 else "")
        wv, wh, _ = k2_stacks(key, SLICE_V, SLICE_H)
        host = np.zeros((32, 1088, 1920 * channels), np.uint8)
        for i in range(32):
            host[i, :1080] = imgs[i % len(imgs)].reshape(1080, -1)
        x = torch.from_numpy(host).cuda()
        vidx, hidx = k2_index(32)
        tabs = resize_strip.resize_tables(wv, wh)
        entry = (resize_strip.rgba_resize if channels == 4
                 else resize_strip.rgb_resize)
        rows = entry(x, wv, wh, vidx, hidx, bands=tabs)
        case = strip_case(x, wv, wh, vidx, hidx, channels, strip=128)
        d = int((case["got"].to(torch.int32) - rows.to(torch.int32)).abs().max())
        log(f"  K2 in strips of 128 columns vs whole rows, B=32 1088x1920x"
            f"{channels} -> 240x400: max|d|={d}; vs plain max|d|="
            f"{case['max_abs_err']}; device ms per call (torch.profiler over "
            f"20): strips {case['ms']:.4f}, whole rows {whole['ms']:.4f} "
            f"(phase {4 if channels == 3 else 13}), plain {case['plain_ms']:.4f}"
            f", library {case['library_ms']:.4f}; bound {case['bound_ms']:.4f}"
            f" ms ({case['bound_by']}) [{card}]")
        if d != 0:
            raise RuntimeError("K2's column strips differ from its whole rows")
        out[f"flagship_{channels}ch"] = {k: v for k, v in case.items()
                                         if k != "got"}
        del x, rows, case

    # -- the wide RGB rows of the panorama (B=1) and the RGBA 8192 bucket
    pano_px = synth_image(7, *PANORAMA)
    pw, ph = PANORAMA
    ow, oh = weights.target_dimensions(pw, ph, 1280, None)
    wv, wh = (torch.from_numpy(a).cuda()
              for a in weights.exact_stacks(ph, pw, oh, ow))
    x = torch.from_numpy(pano_px.reshape(1, ph, -1)).cuda()
    idx = torch.zeros(1, dtype=torch.int32, device="cuda")
    wide = strip_case(x, wv, wh, idx, idx, 3)
    log(f"  K2 on {pw}x{ph} RGB rows ({pw * 3} elements) -> {ow}x{oh}, B=1, "
        f"exact stacks, column strips: max|d|={wide['max_abs_err']} "
        f"share(|d|=1)={wide['share1']:.3e}; device ms {wide['ms']:.4f}, plain"
        f" {wide['plain_ms']:.4f}, library {wide['library_ms']:.4f}, bound "
        f"{wide['bound_ms']:.4f} ({wide['bound_by']}) [{card}]")
    out["wide_rgb"] = {k: v for k, v in wide.items() if k != "got"}
    bw_, bh_ = BANNER
    bo_w, bo_h = weights.target_dimensions(bw_, bh_, 400, None)
    key = (bucket_for(bh_), bucket_for(bw_), bucket_for(bo_h),
           bucket_for(bo_w), 4, "")
    wv, wh, _ = k2_stacks(key, ((bh_, bo_h),), ((bw_, bo_w),))
    banner_px = page_image(bw_, bh_, 3, alpha=True)
    B = 4
    host = np.zeros((B, key[0], key[1] * 4), np.uint8)
    host[:, :bh_, : bw_ * 4] = banner_px.reshape(bh_, -1)
    x = torch.from_numpy(host).cuda()
    idx = torch.zeros(B, dtype=torch.int32, device="cuda")
    bucket = strip_case(x, wv, wh, idx, idx, 4)
    log(f"  K2 (4 channels) at the {key[0]}x{key[1]} bucket -> {key[2]}x"
        f"{key[3]}, B={B} ({key[1] * 4}-element rows), column strips: "
        f"max|d|={bucket['max_abs_err']}; device ms {bucket['ms']:.4f}, plain "
        f"{bucket['plain_ms']:.4f}, library {bucket['library_ms']:.4f}, bound"
        f" {bucket['bound_ms']:.4f} ({bucket['bound_by']}) [{card}]")
    out["rgba_8192"] = {k: v for k, v in bucket.items() if k != "got"}
    del x, wv, wh, host, bucket, wide
    out["max_abs_err"] = max(out["wide_rgb"]["max_abs_err"],
                             out["rgba_8192"]["max_abs_err"])

    # -- the dense stacks of the exact-shape path: host build, upload
    page_w, page_h = PAGE
    src = jpeg_abi.parse(loader.load(), jpeg_1080)
    up_w, up_h = weights.target_dimensions(src.width, src.height, UPSCALE_W,
                                           None)
    stack_geoms = {
        "page Wv": (page_h, weights.target_dimensions(page_w, page_h, 400,
                                                      None)[1]),
        "upscale Wh": (src.width, up_w),
        "panorama pixel-decode Wh (identity)": (pw, pw),
    }
    for name, (n_in, n_out) in stack_geoms.items():
        filt = "nearest" if "identity" in name else "lanczos3"
        t0 = time.perf_counter()
        w_np = weights._resample_weights_impl(n_in, n_out, filt)
        t1 = time.perf_counter()
        w_dev = torch.as_tensor(w_np, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"    stack {name} ({n_out}x{n_in} f32, {w_np.nbytes / 1e6:.1f} "
            f"MB): numpy build {t1 - t0:.4f} s, pageable upload "
            f"{t2 - t1:.4f} s (host clock)")
        del w_dev, w_np

    # -- the requests
    t0 = time.perf_counter()
    page = make_png(page_image(page_w, page_h, 1))
    banner = make_png(banner_px)
    pano = jpeg.encode_rgb(pano_px, 80, device="cuda")
    log(f"    made a {page_w}x{page_h} page PNG ({len(page) / 1e6:.2f} MB), a "
        f"{bw_}x{bh_} RGBA banner PNG ({len(banner) / 1e6:.2f} MB) and a "
        f"{pw}x{ph} q80 JPEG ({len(pano) / 1e6:.2f} MB, the port's encoder "
        f"past the encode ladder) in {time.perf_counter() - t0:.2f} s")
    if max(len(page), len(banner), len(pano)) > MAX_INPUT:
        raise RuntimeError("a source passes the service's 8 MB input cap")
    W, J = ImageFormat.webp, ImageFormat.jpeg
    # (name, source, requests, width, format, output size, K2 launches in
    # strips?, K3 launches?)
    page_size = weights.target_dimensions(page_w, page_h, 400, None)
    rounds = [
        (f"{page_w}x{page_h} page PNG -> w=400 WebP", page, 1, 400, W,
         page_size, False, False),
        (f"{page_w}x{page_h} page PNG -> w=400 JPEG", page, 1, 400, J,
         page_size, False, False),
        (f"{pw}x{ph} JPEG -> w=1280 WebP", pano, 1, 1280, W, (ow, oh), True,
         True),
        (f"{bw_}x{bh_} RGBA PNG -> w=400 WebP (8192 bucket)", banner, 2, 400,
         W, (bo_w, bo_h), True, False),
        (f"{src.width}x{src.height} JPEG -> w={UPSCALE_W} JPEG", jpeg_1080, 1,
         UPSCALE_W, J, (up_w, up_h), False, True),
        (f"{pw}x{ph} JPEG -> JPEG, no resize", pano, 1, None, J, (pw, ph),
         None, True),
    ]
    metrics = Metrics()
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("decode_png", "entropy_decode", "device_decode", "exact_resize",
              "batch_build", "device_resize", "device_encode", "encode")

    def counts():
        return {"k1": jpeg8.LAUNCHES, "k2": resize_strip.LAUNCHES,
                "k2_rgba": resize_strip.LAUNCHES_RGBA,
                "k2_strips": resize_strip.LAUNCHES_STRIPS, "k3": rp.LAUNCHES,
                "k3_strips": rp.LAUNCHES_STRIPS, "k4": rp.LAUNCHES_F32}

    async def one(data, w, fmt):
        t0 = time.perf_counter()
        body = await engine.transform(data, w, None, fmt, 80)
        return body, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            runs = []
            for _, data, n_req, w, fmt, *_ in rounds:
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                jpeg8.LAUNCHES = resize_strip.LAUNCHES = 0
                resize_strip.LAUNCHES_RGBA = resize_strip.LAUNCHES_STRIPS = 0
                rp.LAUNCHES = rp.LAUNCHES_F32 = rp.LAUNCHES_STRIPS = 0
                t0 = time.perf_counter()
                res = await asyncio.gather(*(one(data, w, fmt)
                                             for _ in range(n_req)))
                runs.append({"res": res, "wall": time.perf_counter() - t0,
                             **counts(),
                             "batches": metrics.batches - batches0,
                             "spent": {k: metrics.stage_seconds[k] - stage0[k]
                                       for k in stages}})
            return runs
        finally:
            await engine.close()

    with Recorder(batcher, "resize_oversized") as rec_exact, \
            Recorder(engine_rgb, "resample_bucketed_flat") as rec_flat:
        runs = asyncio.run(drive())
    rounds_out = {}
    for (name, _, n_req, _, fmt, size, strips, k3), run in zip(rounds, runs):
        for body, _ in run["res"]:
            if out_dims(body) != (fmt.value, *size):
                raise RuntimeError(f"{name}: output is {out_dims(body)}, not "
                                   f"{fmt.value} {size}")
        k2_n = run["k2"] + run["k2_rgba"]
        log(f"  {name}: {n_req} request(s) in {run['wall']:.4f} s, "
            f"{run['batches']} batches, launches "
            f"{ {k: v for k, v in run.items() if k in counts()} } [{card}]")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in run["spent"].items() if v > 0))
        if (strips is None and k2_n) or (strips is not None and k2_n <= 0) \
                or (k3 and run["k3"] <= 0) or (not k3 and run["k3"]) \
                or (strips and run["k2_strips"] <= 0) \
                or (strips is False and run["k2_strips"]) or run["k1"] \
                or run["k4"]:
            raise RuntimeError(f"{name}: launches {run}")
        rounds_out[name] = {"wall_s": run["wall"], "launches": k2_n,
                            "strip_launches": run["k2_strips"],
                            "k3_launches": run["k3"],
                            "batches": run["batches"],
                            "spent": run["spent"]}
    # what each exact-shape path resized, and the RGBA batch, against the
    # plain version on the card
    worst = 0
    for args, _, got in rec_exact.calls:
        img, out_h, out_w = args
        ref = exact_plain(img, out_h, out_w)
        mx, share1 = check_band("the exact-shape path",
                                torch.from_numpy(got).cuda(), ref)
        worst = max(worst, mx)
        log(f"  exact-shape path {img.shape[1]}x{img.shape[0]} -> "
            f"{out_w}x{out_h} vs plain: max|d|={mx} share(|d|=1)="
            f"{share1:.3e}")
    args, kw, flat_out = rec_flat.calls[-1]
    xb, wv, wh, vidx, hidx, ch = args
    plain = resize.resample_flat(xb, wv, wh, vidx, hidx, ch, kw["bands"],
                                 resize=resize_strip.rgba_resize_plain)
    mx, share1 = check_band(
        "the plain RGB head at the 8192 bucket",
        torch.from_numpy(flat_out.reshape(flat_out.shape[0], -1)).to(
            plain.device), plain)
    log(f"  RGBA batch at the 8192 bucket (resample_bucketed_flat) vs plain "
        f"head: max|d|={mx} share(|d|=1)={share1:.3e}")
    worst = max(worst, mx)
    if len(rec_exact.calls) != 4:
        raise RuntimeError(f"{len(rec_exact.calls)} exact-shape resizes, "
                           f"expected 4")
    out.update(rounds=rounds_out, page=page,
               launches=sum(r["launches"] for r in rounds_out.values()),
               strip_launches=sum(r["strip_launches"]
                                  for r in rounds_out.values()),
               engine_max_abs_err=worst)
    out["max_abs_err"] = max(out["max_abs_err"], worst)
    return out


# ---------------------------------------------------------------------------
# phase 17: JPEG sources in every chroma layout
# ---------------------------------------------------------------------------

# (luma's sampling factors, chroma blocks of a 1080p source: rows, columns;
# a luma MCU of 8 rows makes 135 block rows, one of 16 makes 136)
LAYOUTS = {"4:4:4": ((1, 1), (135, 240)), "4:2:2": ((2, 1), (135, 120)),
           "4:4:0": ((1, 2), (68, 240))}


def k3_layout_case(call) -> dict:
    """K3 on the three planes one recorded JPEG pixel decode hands it (B=1,
    identity luma stacks, per-axis upsample or identity chroma stacks)
    against its plain version, each plane compared; device ms of K3, of the
    plain version and of one fp32 einsum a plane; the bound."""
    from imagekit_tpu_torch.ops import dct
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops.color import on_device
    from imagekit_tpu_torch.ops.resize_strip import resize_tables

    args = call[0]
    y, cb, cr, qt, w, vidx, (by, bx, cy, cx), _ = args
    y, cb, cr, qt, vidx, *stacks = on_device((y, cb, cr, qt, vidx, *w),
                                             device="cuda")
    planes = [dct._blocks_to_plane(y, by, bx, qt[:, :64]),
              dct._blocks_to_plane(cb, cy, cx, qt[:, 64:128]),
              dct._blocks_to_plane(cr, cy, cx, qt[:, -64:])]
    tabs = (resize_tables(*stacks[:2]), resize_tables(*stacks[2:]))
    got = rp.resize_planes3(planes, stacks, vidx, bands=tabs)
    ref = rp.resize_planes3_plain(planes, stacks, vidx)
    case = {"max_abs_err": 0, "share_differ": 0.0,
            "planes": [tuple(p.shape[1:]) for p in planes]}
    for a, b in zip(got, ref):
        mx, share1, over = compare(a, b)
        if mx > MAX_ABS or share1 > MAX_SHARE or over:
            raise RuntimeError(f"K3 at {case['planes']} disagrees with its "
                               f"plain version: max|d|={mx}, "
                               f"share(|d|=1)={share1:.3e}")
        case["max_abs_err"] = max(case["max_abs_err"], mx)
        case["share_differ"] = max(case["share_differ"],
                                   float((a != b).float().mean()))
    case["ms"] = device_ms(lambda: rp.resize_planes3(planes, stacks, vidx,
                                                     bands=tabs))
    case["plain_ms"] = device_ms(
        lambda: rp.resize_planes3_plain(planes, stacks, vidx))
    case["library_ms"] = device_ms(planes_einsums(planes, stacks, vidx))
    case["bound_ms"], case["bound_by"] = planes_bound(planes, 1, stacks, tabs,
                                                      vidx)
    return case


def phase_jpeg_layouts(layout_jpegs, gray_jpegs, jpegs, sources,
                       card: str) -> dict:
    """JPEG sources beyond 4:2:0 with shared tables through one engine: the
    native heads turn them away, the JPEG pixel decode (one K3 launch a
    request) and the batched RGB head (one K2 launch a batch) serve them.
    ``layout_jpegs``: layout -> 1080p q80 JPEGs; ``sources``: the images
    they were made from. Rounds, the launch counts set to 0 before each
    and read after it, each run once, traced: 32 4:4:4 ->
    w=400 WebP and -> w=400 JPEG; 16 4:2:2 and 16 4:4:0 -> w=400 WebP; 32
    4:2:0 -> w=400 WebP (K1, the route the others do not take); 16 4:4:4 ->
    JPEG and 4 grayscale -> WebP with no resize; one 4:4:4 -> w=400 AVIF
    (untraced: its encode takes seconds). Then K3 on the planes of a
    4:4:4 and of a 4:2:2 pixel decode against its plain version, timed."""
    from torch.profiler import ProfilerActivity, profile

    from imagekit_tpu_torch.codecs import jpeg
    from imagekit_tpu_torch.config import BatchConfig, ImageFormat, ImageKitConfig
    from imagekit_tpu_torch.ops import dct, jpeg8, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    W, J, A = ImageFormat.webp, ImageFormat.jpeg, ImageFormat.avif
    full, small = (1920, 1080), (400, 225)
    s444, s422, s440 = (layout_jpegs[k] for k in ("4:4:4", "4:2:2", "4:4:0"))
    # (name, sources, requests, width, format, output size, launches
    # expected: kernel -> "request" (one a request) or "batch" (one a batch))
    pixel_head = {"k3": "request", "k2": "batch"}
    rounds = [
        ("1080p 4:4:4 JPEG -> w=400 WebP", s444, 32, 400, W, small,
         pixel_head),
        ("1080p 4:4:4 JPEG -> w=400 JPEG", s444, 32, 400, J, small,
         pixel_head),
        ("1080p 4:2:2 JPEG -> w=400 WebP", s422, 16, 400, W, small,
         pixel_head),
        ("1080p 4:4:0 JPEG -> w=400 WebP", s440, 16, 400, W, small,
         pixel_head),
        ("1080p 4:2:0 JPEG -> w=400 WebP (the JPEG head)", jpegs, 32, 400, W,
         small, {"k1": "batch"}),
        ("1080p 4:4:4 JPEG -> JPEG, no resize", s444, 16, None, J, full,
         {"k3": "request"}),
        ("1080p grayscale JPEG -> WebP, no resize", gray_jpegs, 4, None, W,
         full, {"k3": "request"}),
        ("1080p 4:4:4 JPEG -> w=400 AVIF", s444, 1, 400, A, small,
         pixel_head),
    ]
    metrics = Metrics()
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("entropy_decode", "device_decode", "batch_build",
              "device_resize", "device_decode_resize", "device_encode",
              "encode")

    def counts():
        return {"k1": jpeg8.LAUNCHES, "k2": resize_strip.LAUNCHES,
                "k2_rgba": resize_strip.LAUNCHES_RGBA, "k3": rp.LAUNCHES,
                "k4": rp.LAUNCHES_F32}

    async def one(data, w, fmt):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, fmt, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            runs = []
            for _, srcs, n_req, w, fmt, *_ in rounds:
                reqs = [(srcs[i % len(srcs)], w, fmt) for i in range(n_req)]
                if fmt != A:
                    await asyncio.gather(*(one(*r) for r in reqs[:4]))  # warm
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                jpeg8.LAUNCHES = resize_strip.LAUNCHES = 0
                resize_strip.LAUNCHES_RGBA = 0
                rp.LAUNCHES = rp.LAUNCHES_F32 = 0
                # traced, but for the AVIF round (its encode takes seconds)
                with (profile(activities=[ProfilerActivity.CUDA])
                      if fmt != A else contextlib.nullcontext()) as prof:
                    t0 = time.perf_counter()
                    res = await asyncio.gather(*(one(*r) for r in reqs))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                runs.append({"res": res, "wall": wall, "traced_wall": wall,
                             **counts(),
                             "busy": device_busy_s(prof) if prof else None,
                             "batches": metrics.batches - batches0,
                             "spent": {k: metrics.stage_seconds[k] - stage0[k]
                                       for k in stages}})
            return runs
        finally:
            await engine.close()

    with Recorder(dct, "decode_resize_rgb_batch") as rec_rgb:
        runs = asyncio.run(drive())
    summary = {"rounds": {}}
    for (name, _, n_req, _, fmt, size, want), run in zip(rounds, runs):
        for out, _ in run["res"]:
            dims = ((avif_info(out)[0], avif_info(out)[1]) if fmt == A
                    else out_dims(out))
            if dims != ((b"avif", [size]) if fmt == A else (fmt.value, *size)):
                raise RuntimeError(f"{name}: output is {dims}, not "
                                   f"{fmt.value} {size}")
        p50, p99 = latency(run["res"])
        rps = n_req / run["wall"]
        launched = {k: run[k] for k in ("k1", "k2", "k2_rgba", "k3", "k4")}
        log(f"  {name}: {n_req} concurrent requests in {run['wall']:.4f} s "
            f"({'untraced' if fmt == A else 'traced'}) "
            f"-> {rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
            f"{run['batches']} batches, launches {launched} [{card}]")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
            for k, v in run["spent"].items() if v > 0))
        idle = None
        if fmt != A:
            idle, idle_line = idle_share(run)
            log(idle_line)
        expected = {k: {"request": n_req, "batch": run["batches"]}[per]
                    for k, per in want.items()}
        batched = "batch" in want.values()
        if launched != {k: expected.get(k, 0) for k in launched} or (
                batched != (run["batches"] > 0)):
            raise RuntimeError(
                f"{name}: {launched} launches and {run['batches']} batches; "
                f"expected {expected} and no other")
        summary["rounds"][name] = {
            "launches": launched, "batches": run["batches"], "rps": rps,
            "p50_ms": p50, "p99_ms": p99, "idle_share": idle,
            "stage_s_per_request": {k: v / n_req
                                    for k, v in run["spent"].items() if v}}
    summary["k3_launches"] = sum(
        r["launches"]["k3"] for r in summary["rounds"].values())
    # every pixel decode's RGB (K3) against the plain head on the same
    # inputs, one a layout; each layout's pixels against the image the JPEG
    # was made from
    by_dims = {}
    for call in rec_rgb.calls:
        by_dims.setdefault(tuple(call[0][6][2:]), call)
    for layout, (_, grid) in LAYOUTS.items():
        if grid not in by_dims:
            raise RuntimeError(f"no {layout} pixel decode was recorded")
        mx, share = check_rgb_batch(by_dims[grid])
        px = jpeg.decode_rgb(layout_jpegs[layout][0], device="cuda")
        err = px.astype(np.float64) - sources[0].astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / max(float((err ** 2).mean()),
                                               1e-12))
        log(f"  {layout} pixel decode (K3) vs plain head: max|d|={mx} "
            f"share(|d|>0)={share:.3e}; against the source image: PSNR "
            f"{psnr:.2f} dB")
        if px.shape != (1080, 1920, 3) or psnr < 30.0:
            raise RuntimeError(f"the {layout} pixel decode is not its source")
    gray = jpeg.decode_rgb(gray_jpegs[0], device="cuda")
    if gray.shape != (1080, 1920, 3) or not (gray == gray[..., :1]).all():
        raise RuntimeError("a grayscale pixel decode is not R = G = B")
    # K3 at the two new geometries, on the planes of a recorded decode
    for layout in ("4:4:4", "4:2:2"):
        case = k3_layout_case(by_dims[LAYOUTS[layout][1]])
        log(f"  K3 at the {layout} pixel decode ({case['planes']} -> "
            f"1080x1920, B=1) vs plain: max|d|={case['max_abs_err']} "
            f"share(differ)={case['share_differ']:.3e}; device time per call "
            f"(torch.profiler over 20) K3 {case['ms']:.4f} ms vs plain "
            f"{case['plain_ms']:.4f} ms vs einsum {case['library_ms']:.4f} "
            f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}), K3 "
            f"at {case['bound_ms'] / case['ms']:.1%} of it [{card}]")
        summary[layout] = case
    return summary


# ---------------------------------------------------------------------------
# phase 18: HTTP
# ---------------------------------------------------------------------------


def phase_http(jpegs, png_bytes: bytes, webp_bytes: bytes,
               rgba_png: bytes, page_png: bytes, jpeg_444: bytes) -> str:
    try:
        import aiohttp
        from aiohttp import web
    except ImportError as e:
        return f"NOT RUN: aiohttp is not installed ({e})"

    import shutil

    from imagekit_tpu_torch.codecs import vp8
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import ImageKitConfig
    from imagekit_tpu_torch.fetch import Fetcher
    from imagekit_tpu_torch.ops._build import BUILD_DIR
    from imagekit_tpu_torch.ops.weights import target_dimensions
    from imagekit_tpu_torch.serving.app import create_app
    from imagekit_tpu_torch.serving.metrics import Metrics

    cache_dir = BUILD_DIR / "smoke_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)

    def jpeg_size(body: bytes):
        hdr = jpeg_abi.parse(loader.load(), body)
        return hdr.width, hdr.height

    async def run():
        src = web.Application()

        async def serve(request):
            i = int(request.match_info["i"])
            return web.Response(body=jpegs[i], content_type="image/jpeg")

        async def serve_png(request):
            return web.Response(body=png_bytes, content_type="image/png")

        async def serve_webp(request):
            return web.Response(body=webp_bytes, content_type="image/webp")

        async def serve_page(request):
            return web.Response(body=page_png, content_type="image/png")

        async def serve_444(request):
            return web.Response(body=jpeg_444, content_type="image/jpeg")

        src.router.add_get("/src{i}.jpg", serve)
        src.router.add_get("/src.png", serve_png)
        src.router.add_get("/src.webp", serve_webp)
        src.router.add_get("/page.png", serve_page)
        src.router.add_get("/src444.jpg", serve_444)
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
                local = f"http://127.0.0.1:{src_port}"
                # (source, width): the JPEGs, the PNG, the WebP and a 4:4:4
                # JPEG (the pixel decode and the RGB head) at w=400, and a
                # JPEG at w=1280 (the k=8 head)
                wanted = [(url, "400") for url in urls + [
                    f"{local}/src.png", f"{local}/src.webp",
                    f"{local}/src444.jpg"]] + [(urls[1], "1280")]
                for url, width in wanted:
                    async with s.get(f"{base}/sign", params={
                            "url": url, "w": width, "f": "webp", "q": "80"}) as r:
                        signed = (await r.json())["signed_url"]
                    for attempt in range(2):
                        async with s.get(base + signed) as r:
                            body = await r.read()
                            size = (int(width), int(width) * 9 // 16)
                            if (r.status != 200
                                    or r.headers["Content-Type"] != "image/webp"
                                    or "ETag" not in r.headers
                                    or body[8:12] != b"WEBP"
                                    or vp8.dimensions(body) != size):
                                raise RuntimeError(
                                    f"/img {url} w={width} answered "
                                    f"{r.status} {dict(r.headers)}")
                async with s.get(f"{base}/sign", params={
                        "url": urls[0], "w": "400", "f": "jpeg",
                        "q": "80"}) as r:
                    signed = (await r.json())["signed_url"]
                for attempt in range(2):
                    async with s.get(base + signed) as r:
                        body = await r.read()
                        if (r.status != 200
                                or r.headers["Content-Type"] != "image/jpeg"
                                or jpeg_size(body) != (400, 225)):
                            raise RuntimeError(
                                f"/img f=jpeg answered {r.status} "
                                f"{dict(r.headers)}")
                async with s.get(f"{base}/sign", params={
                        "url": urls[3], "w": "400", "f": "avif",
                        "q": "80"}) as r:
                    signed = (await r.json())["signed_url"]
                for attempt in range(2):
                    async with s.get(base + signed) as r:
                        body = await r.read()
                        if (r.status != 200
                                or r.headers["Content-Type"] != "image/avif"
                                or "ETag" not in r.headers
                                or avif_info(body) != (b"avif", [(400, 225)],
                                                       False)):
                            raise RuntimeError(
                                f"/img f=avif answered {r.status} "
                                f"{dict(r.headers)} {body[:64]!r}")
                if len(list(cache_dir.glob("*.avif"))) != 1:
                    raise RuntimeError("no .avif entry in the disk cache")
                form = aiohttp.FormData()
                form.add_field("file", png_bytes, filename="src.png")
                form.add_field("w", "400")
                async with s.post(base + "/upload", data=form) as r:
                    body = await r.read()
                    if (r.status != 200
                            or r.headers["Content-Type"] != "image/webp"
                            or vp8.dimensions(body) != (400, 225)):
                        raise RuntimeError(f"PNG /upload answered {r.status}")
                # no sizes: a JPEG through /img (the pixel decode on K3),
                # an RGBA PNG through /upload
                async with s.get(f"{base}/sign",
                                 params={"url": urls[2]}) as r:
                    signed = (await r.json())["signed_url"]
                for attempt in range(2):
                    async with s.get(base + signed) as r:
                        body = await r.read()
                        if (r.status != 200
                                or r.headers["Content-Type"] != "image/webp"
                                or vp8.dimensions(body) != (1920, 1080)):
                            raise RuntimeError(
                                f"/img with no sizes answered {r.status} "
                                f"{body[:200]!r}")
                # an image beyond the bucket ladder: the exact-shape path
                async with s.get(f"{base}/sign", params={
                        "url": f"{local}/page.png", "w": "400"}) as r:
                    signed = (await r.json())["signed_url"]
                page_size = target_dimensions(*PAGE, 400, None)
                for attempt in range(2):
                    async with s.get(base + signed) as r:
                        body = await r.read()
                        if (r.status != 200
                                or r.headers["Content-Type"] != "image/webp"
                                or vp8.dimensions(body) != page_size):
                            raise RuntimeError(
                                f"/img of the {PAGE[0]}x{PAGE[1]} page "
                                f"answered {r.status} {body[:200]!r}")
                form = aiohttp.FormData()
                form.add_field("file", rgba_png, filename="logo.png")
                async with s.post(base + "/upload", data=form) as r:
                    body = await r.read()
                    if (r.status != 200
                            or r.headers["Content-Type"] != "image/webp"
                            or vp8.dimensions(body) != (1920, 1080)):
                        raise RuntimeError(
                            f"RGBA PNG /upload with no sizes answered "
                            f"{r.status} {body[:200]!r}")
            if metrics.cache_hits != 12 or metrics.cache_misses != 12:
                raise RuntimeError(
                    f"cache hits {metrics.cache_hits}, misses "
                    f"{metrics.cache_misses}; expected 12 and 12")
        finally:
            await runner.cleanup()
            await src_runner.cleanup()
        return ("passed: 4 JPEG, 1 PNG, 1 WebP and 1 4:4:4 JPEG at w=400 "
                "and 1 JPEG at w=1280 x (/sign -> /img 200 image/webp of the right size "
                "with ETag, then a cache HIT); 1 JPEG /sign -> /img f=jpeg "
                "200 image/jpeg 400x225, then a cache HIT; 1 JPEG /sign -> "
                "/img f=avif 200 image/avif 400x225 with ETag and a .avif "
                "disk-cache entry, then a cache HIT; PNG /upload 200 "
                "image/webp 400x225; 1 JPEG /img with no sizes 200 image/webp "
                "1920x1080, then a cache HIT; a 1440x12000 page PNG /img "
                "w=400 200 image/webp 400x3333 (the exact-shape path), then "
                "a cache HIT; RGBA PNG /upload with no sizes 200 image/webp "
                "1920x1080")

    return asyncio.run(run())


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 19: the sources the reference decodes with Pillow
# ---------------------------------------------------------------------------

CMYK_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "cmyk_1080p_q80.jpg")
CMYK_SEED = 500  # the fixture is synth_image(500, noise=False) in CMYK, q80


def make_pnm(img: np.ndarray) -> bytes:
    """Binary PPM (P6, maxval 255)."""
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes()


def make_qoi(img: np.ndarray) -> bytes:
    """RGBA QOI without Pillow: a QOI_OP_RUN (62 pixels at most) for each
    stretch of repeats, else QOI_OP_RGB where the alpha is the previous
    pixel's and QOI_OP_RGBA where it is not, built with numpy."""
    h, w = img.shape[:2]
    px = np.ascontiguousarray(img).reshape(-1, 4)
    prev = np.vstack([np.array([[0, 0, 0, 255]], np.uint8), px[:-1]])
    same = (px == prev).all(axis=1)
    edge = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    lens = ends - starts
    k = (lens + 61) // 62
    rid = np.repeat(np.arange(len(starts)), k)
    j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    run_pos = starts[rid] + 62 * j
    run_len = np.minimum(62, lens[rid] - 62 * j)
    lit = np.flatnonzero(~same)
    rgba = px[lit, 3] != prev[lit, 3]
    rows = np.zeros((len(lit) + len(run_pos), 5), np.uint8)
    size = np.ones(len(rows), np.int64)
    rows[:len(lit), 0] = np.where(rgba, 0xFF, 0xFE)
    rows[:len(lit), 1:] = px[lit]
    size[:len(lit)] = np.where(rgba, 5, 4)
    rows[len(lit):, 0] = 0xC0 | (run_len - 1)
    order = np.argsort(np.concatenate([lit, run_pos]), kind="stable")
    rows, size = rows[order], size[order]
    body = rows[np.arange(5)[None, :] < size[:, None]].tobytes()
    return (b"qoif" + struct.pack(">IIBB", w, h, 4, 0) + body
            + b"\0" * 7 + b"\1")


def _blocks4(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H/4 * W/4, 16, C): 4x4 blocks, row-major."""
    h, w, c = img.shape
    return (img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
            .reshape(-1, 16, c))


def _unblocks4(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    c = blocks.shape[-1]
    return (blocks.reshape(h // 4, w // 4, 4, 4, c).transpose(0, 2, 1, 3, 4)
            .reshape(h, w, c))


def _bc1_colour(rgb: np.ndarray, four: bool):
    """A numpy BC1 colour encoder: the block's channel-wise max and min as
    565 endpoints, each texel the palette entry (bit-replicated 565, thirds
    truncated toward zero, as a decoder makes them) nearest its projection
    on the line between them. ``four`` is the block's mode: always four
    colours in BC3; in BC1 where c0 > c1 (equal endpoints take index 0).
    Returns (the 8-byte blocks, what a decoder gives: (N, 16, 3))."""
    def to565(c):
        c = c.astype(np.uint16)
        return (c[..., 0] >> 3) << 11 | (c[..., 1] >> 2) << 5 | c[..., 2] >> 3

    def from565(v):
        v = v.astype(np.int32)
        r, g, b = (v & 0xF800) >> 8, (v & 0x7E0) >> 3, (v & 0x1F) << 3
        return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], axis=-1)

    a, b = to565(rgb.max(axis=1)), to565(rgb.min(axis=1))
    c0, c1 = np.maximum(a, b), np.minimum(a, b)
    e0, e1 = from565(c0), from565(c1)
    pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], axis=1)
    d = (e0 - e1).astype(np.float32)
    t = ((rgb - e1[:, None]) * d[:, None]).sum(-1) / np.maximum(
        (d * d).sum(-1), 1.0)[:, None]  # 0 at e1, 1 at e0
    idx = np.array([1, 3, 2, 0])[np.clip(np.rint(3 * t), 0, 3).astype(int)]
    if not four:
        idx[c0 == c1] = 0
    lut = (idx.astype(np.uint32) << (2 * np.arange(16, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32)
    out = np.zeros((len(rgb), 8), np.uint8)
    out[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = lut.astype("<u4").view(np.uint8).reshape(-1, 4)
    return out, np.take_along_axis(pal, idx[:, :, None], axis=1)


def _bc3_alpha(alpha: np.ndarray):
    """A numpy BC3 alpha encoder: max and min as endpoints, each texel the
    nearest step of the eight-level ramp (index 0 where they are equal).
    Returns (the 8-byte blocks, the decoded (N, 16) alpha)."""
    a0 = alpha.max(axis=1).astype(np.int32)
    a1 = alpha.min(axis=1).astype(np.int32)
    i = np.arange(1, 7)
    ramp = ((7 - i) * a0[:, None] + i * a1[:, None]) // 7
    pal = np.concatenate([a0[:, None], a1[:, None], ramp], axis=1)
    step = np.rint((a0[:, None] - alpha) * 7 / np.maximum(a0 - a1, 1)[:, None])
    idx = np.array([0, 2, 3, 4, 5, 6, 7, 1])[np.clip(step, 0, 7).astype(int)]
    idx[a0 == a1] = 0
    bits = (idx.astype(np.uint64) << (3 * np.arange(16, dtype=np.uint64))).sum(
        axis=1, dtype=np.uint64)
    out = np.zeros((len(alpha), 8), np.uint8)
    out[:, 0], out[:, 1] = a0, a1
    out[:, 2:] = bits.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6]
    return out, np.take_along_axis(pal, idx, axis=1)


def make_dds(img: np.ndarray, fourcc: bytes):
    """DXT1 or DXT5 DDS without Pillow (sides multiples of 4): the header
    from :func:`dds_file`, the blocks from :func:`_bc1_colour` and
    :func:`_bc3_alpha`. Returns (the file, the RGBA pixels a decoder must
    give)."""
    h, w = img.shape[:2]
    blocks = _blocks4(img)
    colour, rgb = _bc1_colour(blocks[..., :3], fourcc != b"DXT1")
    if fourcc == b"DXT1":
        data, alpha = colour, np.full(rgb.shape[:2], 255)
    else:
        abytes, alpha = _bc3_alpha(blocks[..., 3])
        data = np.concatenate([abytes, colour], axis=1)
    want = _unblocks4(np.concatenate([rgb, alpha[..., None]], axis=2), h, w)
    return (dds_file(w, h, data.tobytes(), fourcc=fourcc),
            want.astype(np.uint8))


def make_ico(big: np.ndarray, small: np.ndarray, with_big: bool = True):
    """ICO without Pillow: a PNG entry of ``big`` (RGBA, 256x256) and a
    32 bpp BMP entry of ``small`` (RGBA, 48x48: a DIB of twice the height,
    BGRA rows bottom-up, then an all-clear AND mask)."""
    h, w = small.shape[:2]
    rows = small[::-1][:, :, [2, 1, 0, 3]].tobytes()
    mask = bytes((w + 31) // 32 * 4 * h)
    dib = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 32, 0,
                      len(rows) + len(mask), 0, 0, 0, 0) + rows + mask
    images = ([(big.shape[1], big.shape[0], make_png(big))] if with_big
              else []) + [(w, h, dib)]
    out = b"\x00\x00\x01\x00" + struct.pack("<H", len(images))
    offset = 6 + 16 * len(images)
    body = b""
    for iw, ih, data in images:
        out += struct.pack("<BBBBHHII", iw % 256, ih % 256, 0, 0, 1, 32,
                           len(data), offset + len(body))
        body += data
    return out + body


def ycck_of(cmyk: bytes) -> bytes:
    """The same JPEG read as YCCK: its Adobe APP14 transform flag set to 2."""
    at = cmyk.index(b"Adobe") + 11
    return cmyk[:at] + b"\x02" + cmyk[at + 1:]


def k3_planes_case(planes, stacks, tabs, vidx, what: str) -> dict:
    """K3 on the planes of one pixel decode (``dct.resize_components``: one
    launch a three planes) against its plain version, each plane compared;
    device ms of the launches, of the plain version and of one fp32 einsum
    a plane; the bound."""
    from imagekit_tpu_torch.ops import dct
    from imagekit_tpu_torch.ops import resize_planes as rp

    def kernel():
        return dct.resize_components(planes, stacks, tabs, vidx)

    def plain():
        return [rp.resize_planes_plain(p, wv, wh, vidx)
                for p, (wv, wh) in zip(planes, stacks)]

    case = {"max_abs_err": 0, "share_differ": 0.0,
            "planes": [tuple(p.shape[1:]) for p in planes]}
    for a, b in zip(kernel(), plain()):
        mx, share1, over = compare(a, b)
        if mx > MAX_ABS or share1 > MAX_SHARE or over:
            raise RuntimeError(f"K3 at the {what} planes {case['planes']} "
                               f"disagrees with its plain version: "
                               f"max|d|={mx}, share(|d|=1)={share1:.3e}")
        case["max_abs_err"] = max(case["max_abs_err"], mx)
        case["share_differ"] = max(case["share_differ"],
                                   float((a != b).float().mean()))
    case["ms"] = device_ms(kernel)
    case["plain_ms"] = device_ms(plain)
    case["library_ms"] = device_ms(plane_list_einsums(planes, stacks, vidx))
    case["bound_ms"], case["bound_by"] = plane_list_bound(planes, stacks,
                                                          tabs, vidx)
    return case


def k3_cmyk_case(data: bytes) -> dict:
    """:func:`k3_planes_case` at the four planes of one CMYK pixel decode
    (its two launches: C, M and Y, then K)."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.ops import dct

    return k3_planes_case(*dct.sampled_inputs(
        jpeg_abi.decode4(loader.load(), data), torch.device("cuda")), "CMYK")


def drive_rounds(rounds, card: str, steps: dict) -> dict:
    """Rounds of requests through one ``BatchedEngine(device="cuda")``: each
    warmed by 4 requests, then run once, traced, with every launch count set
    to 0 just before it and read just after. A round is (name, sources,
    requests, width, format, output size, launches: kernel -> "batch" (one
    a batch) or n (n a request)); each output is parsed to its format and
    size, and the launches must be those and no other. Logs requests/s,
    p50/p99, the host stages and the idle share of each; returns them, with
    the launches of K2 (three and four channels) and K3 summed over the
    rounds. ``steps`` gets the seconds of each round."""
    from torch.profiler import ProfilerActivity, profile

    from imagekit_tpu_torch.config import BatchConfig, ImageKitConfig
    from imagekit_tpu_torch.ops import jpeg8, resize_strip
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    metrics = Metrics()
    engine = BatchedEngine(
        ImageKitConfig(secret=SECRET,
                       batch=BatchConfig(max_queue_latency_s=0.0)),
        metrics=metrics, device="cuda")
    stages = ("decode", "entropy_decode", "avif_decode", "device_decode",
              "batch_build", "device_resize", "device_encode", "encode")
    kinds = ("k1", "k2", "k2_rgba", "k3", "k4")

    def counts():
        return dict(zip(kinds, (jpeg8.LAUNCHES, resize_strip.LAUNCHES,
                                resize_strip.LAUNCHES_RGBA, rp.LAUNCHES,
                                rp.LAUNCHES_F32)))

    async def one(data, w, fmt):
        t0 = time.perf_counter()
        out = await engine.transform(data, w, None, fmt, 80)
        return out, time.perf_counter() - t0

    async def drive():
        try:
            await engine.warmup()
            runs = []
            for name, srcs, n_req, w, fmt, *_ in rounds:
                t_round = time.perf_counter()
                reqs = [(srcs[i % len(srcs)], w, fmt) for i in range(n_req)]
                await asyncio.gather(*(one(*r) for r in reqs[:4]))  # warm
                steps[f"warm: {name}"] = time.perf_counter() - t_round
                batches0 = metrics.batches
                stage0 = {k: metrics.stage_seconds[k] for k in stages}
                jpeg8.LAUNCHES = resize_strip.LAUNCHES = 0
                resize_strip.LAUNCHES_RGBA = 0
                resize_strip.YUV_LAUNCHES.clear()
                rp.LAUNCHES = rp.LAUNCHES_F32 = rp.LAUNCHES_STRIPS = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    res = await asyncio.gather(*(one(*r) for r in reqs))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                runs.append({"res": res, "wall": wall, "traced_wall": wall,
                             **counts(), "k3_strips": rp.LAUNCHES_STRIPS,
                             "yuv": dict(resize_strip.YUV_LAUNCHES),
                             "batches": metrics.batches - batches0,
                             "spent": {k: metrics.stage_seconds[k] - stage0[k]
                                       for k in stages},
                             "busy": device_busy_s(prof)})
                steps[name] = time.perf_counter() - t_round
            return runs
        finally:
            await engine.close()

    runs = asyncio.run(drive())
    summary = {"rounds": {}}
    for (name, _, n_req, _, fmt, size, want), run in zip(rounds, runs):
        for out, _ in run["res"]:
            if out_dims(out) != (fmt.value, *size):
                raise RuntimeError(f"{name}: output is {out_dims(out)}, not "
                                   f"{fmt.value} {size}")
        p50, p99 = latency(run["res"])
        rps = n_req / run["wall"]
        launched = {k: run[k] for k in kinds}
        log(f"  {name}: {n_req} concurrent requests in {run['wall']:.4f} s "
            f"(traced) -> {rps:.2f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} "
            f"ms, {run['batches']} batches, launches {launched} [{card}]")
        log("    host seconds: " + ", ".join(
            f"{k} {v:.4f} s ({v / n_req * 1e3:.2f} ms/request)"
            for k, v in run["spent"].items() if v > 0))
        idle, idle_line = idle_share(run, traced="this")
        log(idle_line)
        expected = {k: run["batches"] if per == "batch" else per * n_req
                    for k, per in want.items()}
        batched = "batch" in want.values()
        if launched != {k: expected.get(k, 0) for k in kinds} or (
                batched != (run["batches"] > 0)):
            raise RuntimeError(
                f"{name}: {launched} launches and {run['batches']} batches; "
                f"expected {expected} and no other")
        summary["rounds"][name] = {
            "launches": launched, "k3_strips": run["k3_strips"],
            "yuv_launches": run["yuv"],
            "batches": run["batches"], "rps": rps,
            "p50_ms": p50, "p99_ms": p99, "idle_share": idle,
            "stage_s_per_request": {k: v / n_req
                                    for k, v in run["spent"].items() if v}}
    for key in ("k2", "k2_rgba", "k3"):
        summary[f"{key}_launches"] = sum(
            r["launches"][key] for r in summary["rounds"].values())
    summary["yuv_launches"] = {}
    for r in summary["rounds"].values():
        for entry, n in r["yuv_launches"].items():
            summary["yuv_launches"][entry] = summary["yuv_launches"].get(
                entry, 0) + n
    return summary


@functools.lru_cache(maxsize=None)
def make_pillow_sources():
    """Phase 19's sources: four 1080p pictures as P6 and RGBA QOI, four
    256x256 ICOs (a PNG entry and a 48x48 BMP one), a DXT1 and a DXT5
    2048x2048 DDS, and the committed CMYK JPEG with its YCCK twin."""
    images = [synth_image(600 + i, noise=False) for i in range(4)]
    pnms = [make_pnm(img) for img in images]
    qois = [make_qoi(with_alpha(img, i)) for i, img in enumerate(images)]
    icons = [ramp_alpha(synth_image(620 + i, 256, 256)) for i in range(4)]
    small = ramp_alpha(synth_image(630, 256, 256)[:48, :48])
    icos = [make_ico(big, small) for big in icons]
    dxt = [make_dds(with_alpha(synth_image(640 + i, 2048, 2048), i), cc)
           for i, cc in enumerate((b"DXT1", b"DXT5"))]
    with open(CMYK_FIXTURE, "rb") as f:
        cmyk = f.read()
    return images, pnms, qois, icons, small, icos, dxt, cmyk, ycck_of(cmyk)


def phase_pillow_sources(card: str) -> dict:
    """The sources the reference decodes with Pillow, through one engine:
    ICO, P6, QOI and DDS decode on the codec pool and take the batched RGB
    head (K2, three or four channels); CMYK and YCCK JPEGs take the
    four-component pixel decode (two K3 launches a request) and the RGB
    head. Sources are made here without Pillow, and each decode is checked
    first: P6, QOI and the ICOs' PNG and BMP entries exactly against their
    pixels, the DDS against the pixels their block encoder chose, CMYK and
    YCCK against the plain decode on the host's CPU (and CMYK against the
    image the fixture was made from). Rounds, the launch counts set to 0
    before each and read after it, each run once, traced (warmed by 4
    requests first). Then K3 at the CMYK geometry against its plain
    version. The seconds of each step are logged."""
    from imagekit_tpu_torch.codecs import decode_bytes, jpeg
    from imagekit_tpu_torch.config import ImageFormat

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    images, pnms, qois, icons, small, icos, dxt, cmyk, ycck = (
        make_pillow_sources())
    log(f"    made 4 1920x1080 P6 and RGBA QOI ({len(qois[0]) / 1e6:.2f} MB), "
        f"4 ICOs (256x256 PNG + 48x48 BMP), a DXT1 and a DXT5 2048x2048 "
        f"DDS, read the {len(cmyk) / 1e3:.0f} kB CMYK fixture in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}
    t0 = time.perf_counter()
    # every decode against what it must give
    for name, data, want in (
            ("P6", pnms[0], images[0]), ("QOI", qois[1],
                                         with_alpha(images[1], 1)),
            ("ICO (PNG entry)", icos[2], icons[2]),
            ("ICO (BMP entry)", make_ico(None, small, with_big=False), small),
            ("DXT1", *dxt[0]), ("DXT5", *dxt[1])):
        got = decode_bytes(data, device="cuda")[0]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"the {name} decode is not its source")
    against_plain = []
    for name, data in (("CMYK", cmyk), ("YCCK", ycck)):
        card_rgb = jpeg.decode_rgb(data, device="cuda")
        diff = np.abs(card_rgb.astype(int)
                      - jpeg.decode_rgb(data, device="cpu").astype(int))
        against_plain.append(f"{name} max|d|={diff.max()} on "
                             f"{(diff > 0).mean():.3e} of values")
        if card_rgb.shape != (1080, 1920, 3) or diff.max() > 2 or (
                (diff > 0).mean() > MAX_SHARE):
            raise RuntimeError(f"the {name} decode on the card is not the "
                               f"plain one on the host's CPU")
        if name == "CMYK":
            err = card_rgb - synth_image(CMYK_SEED, noise=False).astype(float)
            cmyk_psnr = 10 * np.log10(
                255.0 ** 2 / max(float((err ** 2).mean()), 1e-12))
    log(f"    P6, QOI, ICO (PNG, BMP), DXT1, DXT5 decodes equal their pixels;"
        f" on the card against the host's plain decode: "
        f"{'; '.join(against_plain)}; CMYK against its source image: PSNR "
        f"{cmyk_psnr:.2f} dB")
    if cmyk_psnr < 30.0:
        raise RuntimeError("the CMYK decode is not its source image")
    steps["decode checks"] = time.perf_counter() - t0

    full, small_out = (1920, 1080), (400, 225)
    rgb_head, rgba_head = {"k2": "batch"}, {"k2_rgba": "batch"}
    cmyk_head = {"k3": 2, "k2": "batch"}
    # (name, sources, requests, width, format, output size, launches: kernel
    # -> "batch" (one a batch) or n (n a request))
    rounds = [
        ("256x256 ICO -> w=64 WebP", icos, 16, 64, W, (64, 64), rgba_head),
        ("1080p P6 -> w=400 WebP", pnms, 16, 400, W, small_out, rgb_head),
        ("1080p P6 -> w=400 JPEG", pnms, 16, 400, J, small_out, rgb_head),
        ("1080p RGBA QOI -> w=400 WebP", qois, 16, 400, W, small_out,
         rgba_head),
        ("2048x2048 DXT1 + DXT5 DDS -> w=400 WebP",
         [dxt[0][0], dxt[1][0]], 16, 400, W, (400, 400), rgba_head),
        ("1080p CMYK JPEG -> w=400 WebP", [cmyk], 16, 400, W, small_out,
         cmyk_head),
        ("1080p CMYK JPEG -> w=400 JPEG", [cmyk], 16, 400, J, small_out,
         cmyk_head),
        ("1080p CMYK JPEG -> JPEG, no resize", [cmyk], 16, None, J, full,
         {"k3": 2}),
        ("1080p YCCK JPEG -> w=400 WebP", [ycck], 4, 400, W, small_out,
         cmyk_head),
    ]
    summary = drive_rounds(rounds, card, steps)
    case, steps["K3 at the CMYK planes"] = timed(k3_cmyk_case, cmyk)
    log(f"  K3 at the CMYK pixel decode ({case['planes']} -> 1088x1920, B=1, "
        f"two launches) vs plain: max|d|={case['max_abs_err']} "
        f"share(differ)={case['share_differ']:.3e}; device time per call "
        f"(torch.profiler over 20) K3 {case['ms']:.4f} ms vs plain "
        f"{case['plain_ms']:.4f} ms vs einsum {case['library_ms']:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}), K3 at "
        f"{case['bound_ms'] / case['ms']:.1%} of it [{card}]")
    summary["k3_cmyk"] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 20: the BMP, TIFF and progressive CMYK sources Pillow still decoded
# ---------------------------------------------------------------------------

G4_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "g4_a4_300dpi.tif")
G4_SEED = 700  # the fixture is text_page(700), Group 4, written by Pillow
PROGRESSIVE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                   "cmyk_1080p_q80_progressive.jpg")
A4 = (2480, 3508)  # 300 dpi


def text_page(seed: int, w: int = A4[0], h: int = A4[1]) -> np.ndarray:
    """A seeded bilevel page of text-like strokes, True for white (Pillow's
    mode "1"): lines of words of 20x28 glyphs of 2-4 bars 3 px thick, 50 px
    apart, inside 236 px margins, some lines short or blank."""
    rng = np.random.default_rng(seed)
    bars = []
    for x0, x1, y0, y1 in ((0, 3, 0, 28), (8, 11, 0, 28), (17, 20, 0, 28),
                           (0, 20, 0, 3), (0, 20, 12, 15), (0, 20, 25, 28),
                           (0, 3, 0, 14), (17, 20, 14, 28)):
        bar = np.zeros((28, 20), bool)
        bar[y0:y1, x0:x1] = True
        bars.append(bar)
    glyphs = [np.any([bars[i] for i in rng.choice(
        len(bars), int(rng.integers(2, 5)), replace=False)], axis=0)
        for _ in range(48)]
    ink = np.zeros((h, w), bool)
    margin = 236
    for y in range(margin, h - margin - 28, 50):
        if rng.random() < 0.08:
            continue  # a blank line between paragraphs
        end = w - margin - (int(rng.integers(0, 600))
                            if rng.random() < 0.15 else 0)
        x = margin
        while x + 24 < end:
            for g in rng.integers(0, len(glyphs), int(rng.integers(2, 11))):
                if x + 24 >= end:
                    break
                ink[y:y + 28, x:x + 20] |= glyphs[g]
                x += 24
            x += 24  # a space
    return ~ink


def tiff_ifd(w: int, h: int, entries, body: bytes, tail: bytes = b"") -> bytes:
    """A little-endian TIFF of one strip, ``body``, with the IFD entries
    (tag, type, count, value) besides the size and strip tags, and ``tail``
    after the IFD: a value of None is the offset of the tail."""
    entries = sorted(entries + [
        (256, 4, 1, w), (257, 4, 1, h), (273, 4, 1, 8), (278, 4, 1, h),
        (279, 4, 1, len(body))])
    ifd_off = 8 + len(body)
    tail_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", t, k, n, tail_off if v is None else v)
        for t, k, n, v in entries) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", ifd_off) + body + ifd + tail


def make_bilevel_tiff(page: np.ndarray) -> bytes:
    """Uncompressed 1-bit TIFF (BlackIsZero, BitsPerSample 1), by numpy."""
    h, w = page.shape
    return tiff_ifd(w, h, [(258, 3, 1, 1), (259, 3, 1, 1), (262, 3, 1, 1),
                           (277, 3, 1, 1)], np.packbits(page, axis=1).tobytes())


def packbits(rows: np.ndarray) -> bytes:
    """PackBits of each row of (h, n) u8, as literal packets of at most 128
    bytes: a valid stream that decodes through the literal arm."""
    h, n = rows.shape
    out = []
    for at in range(0, n, 128):
        chunk = rows[:, at:at + 128]
        head = np.full((h, 1), chunk.shape[1] - 1, np.uint8)
        out.append(np.concatenate([head, chunk], axis=1))
    return np.concatenate(out, axis=1).tobytes()


def make_cmyk_tiff(img: np.ndarray) -> bytes:
    """8-bit CMYK TIFF (photometric 5, chunky, PackBits) of an RGB image, as
    Pillow converts RGB to CMYK (C, M, Y = 255 - R, G, B; K = 0), so that
    the decode gives the image back exactly."""
    h, w = img.shape[:2]
    cmyk = np.concatenate([255 - img, np.zeros((h, w, 1), np.uint8)], 2)
    return tiff_ifd(w, h, [(258, 3, 4, None), (259, 3, 1, 32773),
                           (262, 3, 1, 5), (277, 3, 1, 4)],
                    packbits(cmyk.reshape(h, 4 * w)),
                    struct.pack("<HHHH", 8, 8, 8, 8))


def make_bmp_fields(img: np.ndarray, kind: str) -> bytes:
    """A BMP of an RGB or RGBA image, by ``struct`` and numpy: "v5_bgra" (32
    bpp BI_BITFIELDS, BGRA masks in a 124-byte header), "565" (16 bpp
    BI_BITFIELDS 5-6-5 after a 40-byte header) or "core24" (a 12-byte
    BITMAPCOREHEADER, 24 bpp)."""
    h, w = img.shape[:2]
    if kind == "v5_bgra":
        px = img[..., [2, 1, 0, 3]].reshape(h, 4 * w)
        header = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 32, 3, px.size,
                             2835, 2835, 0, 0) + struct.pack(
            "<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + bytes(68)
    elif kind == "565":
        v = ((img[..., 0].astype(np.uint16) >> 3) << 11
             | (img[..., 1].astype(np.uint16) >> 2) << 5
             | img[..., 2].astype(np.uint16) >> 3)
        px = v.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 3, 0, 2835,
                             2835, 0, 0) + struct.pack(
            "<III", 0xF800, 0x7E0, 0x1F)
    else:
        px = img[..., ::-1].reshape(h, 3 * w)
        header = struct.pack("<IHHHH", 12, w, h, 1, 24)
    pad = (-px.shape[1]) % 4
    body = np.pad(px[::-1], ((0, 0), (0, pad))).tobytes()
    off = 14 + len(header)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + \
        header + body


def widened_565(img: np.ndarray) -> np.ndarray:
    """What a 5-6-5 BMP of ``img`` decodes to: Pillow's v * 255 / 31 and
    v * 255 / 63."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    return np.stack([(r >> 3) * 255 // 31, (g >> 2) * 255 // 63,
                     (b >> 3) * 255 // 31], -1).astype(np.uint8)


def phase_pillow_fallbacks(card: str) -> dict:
    """The BMP, TIFF and progressive CMYK sources the reference still hands
    to Pillow, through one engine: BMP and TIFF decode on the codec pool
    (the port's own decoders of what the pinned ones refuse) and take the
    RGB head (K2, three or four channels); progressive CMYK and YCCK take
    the four-component pixel decode (two K3 launches a request) and the RGB
    head. The G4 page and the progressive CMYK JPEG are committed fixtures
    (the card's machine has no Pillow); the rest is written here. Each
    decode is checked first: the G4 and 1-bit pages against the page they
    were made from, the BMPs and the CMYK TIFF against their pixels, the
    progressive CMYK's coefficients against its baseline twin's and its
    pixels on the card against the plain decode on the host's CPU. Then
    the rounds (``drive_rounds``), and K3 at the progressive planes against
    its plain version. The seconds of each step are logged."""
    from imagekit_tpu_torch.codecs import decode_bytes, jpeg
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.utils.bucketing import bucket_for

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    g4 = open(G4_FIXTURE, "rb").read()
    page = text_page(G4_SEED)
    pages = [make_bilevel_tiff(page)]
    images = [synth_image(710 + i, noise=False) for i in range(4)]
    cmyk_tiffs = [make_cmyk_tiff(img) for img in images]
    bgra = [make_bmp_fields(with_alpha(img, i), "v5_bgra")
            for i, img in enumerate(images)]
    bmp565 = [make_bmp_fields(img, "565") for img in images]
    core = [make_bmp_fields(img, "core24") for img in images]
    prog = open(PROGRESSIVE_FIXTURE, "rb").read()
    yprog = ycck_of(prog)
    log(f"    read the {len(g4) / 1e3:.1f} kB G4 A4 page and the "
        f"{len(prog) / 1e3:.0f} kB progressive CMYK fixture; made the page "
        f"as an uncompressed 1-bit TIFF ({len(pages[0]) / 1e6:.2f} MB), 4 "
        f"1080p CMYK PackBits TIFFs, 4 each of 32 bpp BGRA v5, 16 bpp 5-6-5 "
        f"and BITMAPCOREHEADER 24 bpp BMPs in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}
    t0 = time.perf_counter()
    white = np.repeat(np.where(page, 255, 0).astype(np.uint8)[..., None], 3, 2)
    for name, data, want in (
            ("G4 page", g4, white), ("1-bit page", pages[0], white),
            ("CMYK TIFF", cmyk_tiffs[0], images[0]),
            ("BGRA v5 BMP", bgra[1], with_alpha(images[1], 1)),
            ("5-6-5 BMP", bmp565[2], widened_565(images[2])),
            ("core 24 bpp BMP", core[3], images[3])):
        decode_bytes(data, device="cuda")  # a first call loads its modules
        t1 = time.perf_counter()
        got = decode_bytes(data, device="cuda")[0]
        steps[f"decode {name}"] = time.perf_counter() - t1
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"the {name} decode is not its source")
    lib = loader.load()
    base = open(CMYK_FIXTURE, "rb").read()
    hb, cb, qb = jpeg_abi.decode_any(lib, base)
    hp, cp, qp = jpeg_abi.decode_any(lib, prog)
    if not (hp.progressive and not hb.progressive and np.array_equal(qb, qp)
            and all(np.array_equal(a, b) for a, b in zip(cb, cp))):
        raise RuntimeError("the progressive CMYK's coefficients are not its "
                           "baseline twin's")
    against_plain = []
    for name, data in (("progressive CMYK", prog), ("progressive YCCK", yprog)):
        card_rgb = jpeg.decode_rgb(data, device="cuda")
        diff = np.abs(card_rgb.astype(int)
                      - jpeg.decode_rgb(data, device="cpu").astype(int))
        against_plain.append(f"{name} max|d|={diff.max()} on "
                             f"{(diff > 0).mean():.3e} of values")
        if card_rgb.shape != (1080, 1920, 3) or diff.max() > 2 or (
                (diff > 0).mean() > MAX_SHARE):
            raise RuntimeError(f"the {name} decode on the card is not the "
                               f"plain one on the host's CPU")
    log(f"    the G4 and 1-bit pages, the CMYK TIFF and the three BMP "
        f"layouts decode to their pixels (host ms: " + ", ".join(
            f"{k[7:]} {v * 1e3:.1f}" for k, v in steps.items()
            if k.startswith("decode ")) + "); the progressive CMYK's "
        f"coefficients equal its baseline twin's; on the card against the "
        f"host's plain decode: {'; '.join(against_plain)}")
    log(f"    a {A4[0]}x{A4[1]} page takes the ladder bucket "
        f"{bucket_for(A4[1])}x{bucket_for(A4[0])} (not the exact-shape path:"
        f" both sides are within the ladder's 8192)")
    steps["decode checks"] = time.perf_counter() - t0

    small_out, a4_out = (400, 225), (400, 566)
    rgb_head, rgba_head = {"k2": "batch"}, {"k2_rgba": "batch"}
    cmyk_head = {"k3": 2, "k2": "batch"}
    rounds = [
        ("A4 300 dpi G4 TIFF -> w=400 WebP", [g4], 16, 400, W, a4_out,
         rgb_head),
        ("A4 300 dpi 1-bit TIFF -> w=400 WebP", pages, 16, 400, W, a4_out,
         rgb_head),
        ("1080p CMYK PackBits TIFF -> w=400 JPEG", cmyk_tiffs, 16, 400, J,
         small_out, rgb_head),
        ("1080p 32 bpp BGRA v5 BMP -> w=400 WebP", bgra, 16, 400, W,
         small_out, rgba_head),
        ("1080p 16 bpp 5-6-5 BMP -> w=400 WebP", bmp565, 16, 400, W,
         small_out, rgb_head),
        ("1080p BITMAPCOREHEADER 24 bpp BMP -> w=400 WebP", core, 16, 400, W,
         small_out, rgb_head),
        ("1080p progressive CMYK JPEG -> w=400 WebP", [prog], 16, 400, W,
         small_out, cmyk_head),
        ("1080p progressive CMYK JPEG -> JPEG, no resize", [prog], 16, None,
         J, (1920, 1080), {"k3": 2}),
        ("1080p progressive YCCK JPEG -> w=400 WebP", [yprog], 4, 400, W,
         small_out, cmyk_head),
    ]
    summary = drive_rounds(rounds, card, steps)
    case, steps["K3 at the progressive CMYK planes"] = timed(k3_cmyk_case,
                                                             prog)
    log(f"  K3 at the progressive CMYK pixel decode ({case['planes']} -> "
        f"1088x1920, B=1, two launches) vs plain: max|d|="
        f"{case['max_abs_err']} share(differ)={case['share_differ']:.3e}; "
        f"device time per call K3 {case['ms']:.4f} ms vs plain "
        f"{case['plain_ms']:.4f} ms vs einsum {case['library_ms']:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}), K3 at "
        f"{case['bound_ms'] / case['ms']:.1%} of it [{card}]")
    if case["max_abs_err"] != 0:
        raise RuntimeError("K3 at the progressive CMYK planes is not its "
                           "plain version exactly")
    summary["k3_progressive"] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 21: JPEG-compressed TIFFs
# ---------------------------------------------------------------------------

TIFF_JPEG_RGB_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                     "tiff_jpeg_rgb_1080p_q80.tif")
TIFF_JPEG_CMYK_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                      "tiff_jpeg_cmyk_1080p_q80.tif")
TIFF_JPEG_SEED = 800  # the fixtures are synth_image(800, noise=False)


def tiff_file(w: int, h: int, tags: dict, chunks, tile: int = 0) -> bytes:
    """A little-endian TIFF of one IFD: ``chunks`` (strips, or ``tile``-px
    square tiles row by row) after the header, then the IFD of ``tags``
    {tag: (type, values)} (3 SHORT, 4 LONG, 7 UNDEFINED with the values as
    bytes) with the size and chunk tags added, then the values that do not
    fit in their entries."""
    body, offs = b"", []
    for c in chunks:
        offs.append(8 + len(body))
        body += c + b"\0" * (len(c) % 2)
    lens = [len(c) for c in chunks]
    tags = {256: (4, [w]), 257: (4, [h]), **tags}
    if tile:
        tags.update({322: (3, [tile]), 323: (3, [tile]), 324: (4, offs),
                     325: (4, lens)})
    else:
        tags.update({273: (4, offs), 279: (4, lens)})
    ifd_off = 8 + len(body)
    tail_off = ifd_off + 2 + 12 * len(tags) + 4
    ifd, tail = struct.pack("<H", len(tags)), b""
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = bytes(vals) if typ == 7 else b"".join(
            struct.pack("<" + {3: "H", 4: "I"}[typ], v) for v in vals)
        ifd += struct.pack("<HHI", t, typ, len(raw) if typ == 7 else len(vals))
        if len(raw) <= 4:
            ifd += raw.ljust(4, b"\0")
        else:
            ifd += struct.pack("<I", tail_off + len(tail))
            tail += raw + b"\0" * (len(raw) % 2)
    return (b"II*\x00" + struct.pack("<I", ifd_off) + body + ifd
            + struct.pack("<I", 0) + tail)


def split_jpeg(data: bytes, moved=(0xDB, 0xC4)):
    """A whole baseline JPEG -> (tables, segment) as a JPEG TIFF holds them:
    SOI, its segments of the ``moved`` markers (DQT and DHT), EOI
    (``JPEGTables``); SOI, its other segments but the APPn ones, the scan,
    EOI (a strip or a tile)."""
    tables, rest, at = [], [], 2
    while data[at + 1] != 0xDA:
        n = struct.unpack(">H", data[at + 2:at + 4])[0]
        seg = data[at:at + 2 + n]
        if data[at + 1] in moved:
            tables.append(seg)
        elif not 0xE0 <= data[at + 1] <= 0xEF:
            rest.append(seg)
        at += 2 + n
    return (b"\xff\xd8" + b"".join(tables) + b"\xff\xd9",
            b"\xff\xd8" + b"".join(rest) + data[at:])


def make_jpeg_tiff(img: np.ndarray, quality: int = 80, samp=(2, 2),
                   rows: int = 16, tile: int = 0, gray: bool = False,
                   tables: bool = True) -> bytes:
    """A JPEG-compressed TIFF of an RGB image without Pillow: YCbCr
    (photometric 6, ``samp`` the YCbCrSubSampling), or gray (photometric 1)
    where ``gray``; in strips of ``rows`` rows (a multiple of the MCU
    height), or in ``tile``-px square tiles, the edge tiles padded by
    replicating the image's edge. The image is encoded once by the port's
    encoder (``make_jpeg``'s); each strip or tile is then the JPEG of its
    blocks (an MCU does not straddle a segment, so these are the segment's
    own JPEG's coefficients), its DQT moved into ``JPEGTables`` (tag 347)
    unless ``tables`` is False. The encoder's Huffman tables are optimised
    for each segment, so each keeps its DHT."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    h, w = img.shape[:2]
    sh, sv = (1, 1) if gray else samp
    if tile:
        gh, gw = -(-h // tile), -(-w // tile)
        img = np.pad(img, ((0, gh * tile - h), (0, gw * tile - w), (0, 0)),
                     mode="edge")
        seg_w, seg_h = tile, tile
    else:
        gh, gw, seg_w, seg_h = -(-h // rows), 1, w, rows
    planes, qt = host_encode_rgb_to_coefficients(img, quality, (sh, sv))
    factors = [(sh, sv), (1, 1), (1, 1)]
    if gray:
        planes, factors = planes[:1], factors[:1]
    tab, segs = None, []
    for i in range(gh):
        sh_px = seg_h if tile else min(rows, h - i * rows)
        for j in range(gw):
            my, mx = i * seg_h // (8 * sv), j * seg_w // (8 * sh)
            ny, nx = -(-sh_px // (8 * sv)), -(-seg_w // (8 * sh))
            part = [p[my * fv:(my + ny) * fv, mx * fh:(mx + nx) * fh]
                    for p, (fh, fv) in zip(planes, factors)]
            tab, seg = split_jpeg(loader.encode_jpeg(part, qt, seg_w, sh_px,
                                                     (sh, sv)), (0xDB,))
            segs.append(seg if tables else tab[:-2] + seg[2:])
    n = 1 if gray else 3
    tags = {258: (3, [8] * n), 259: (3, [7]), 262: (3, [1 if gray else 6]),
            277: (3, [n]), 284: (3, [1])}
    if not gray:
        tags[530] = (3, [sh, sv])
    if not tile:
        tags[278] = (4, [rows])
    if tables:
        tags[347] = (7, tab)
    return tiff_file(w, h, tags, segs, tile)


def phase_tiff_jpeg(card: str) -> dict:
    """JPEG-compressed TIFFs through one engine: each strip or tile
    entropy-decoded on the codec pool, then one pixel decode a page on a
    dispatch thread (one K3 launch a page of one or three components, two
    for four, with block-diagonal chroma stacks), then the RGB head (K2, one
    launch a batch). The RGB and CMYK files are Pillow's, committed (the
    card's machine has no Pillow); the YCbCr strips and tiles, the gray
    page and the A4 page are written here (``make_jpeg_tiff``). Each decode
    is checked first: against the picture it was made from, and on the card
    against the plain decode on the host's CPU. Then the rounds
    (``drive_rounds``), the A4 page's stacks (bytes and build + upload
    time), and K3 at the 1080p strip page's block-diagonal stacks against
    its plain version. The seconds of each step are logged."""
    from imagekit_tpu_torch.codecs import decode_bytes, tiff
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import dct

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    rgb = open(TIFF_JPEG_RGB_FIXTURE, "rb").read()
    cmyk = open(TIFF_JPEG_CMYK_FIXTURE, "rb").read()
    picture = synth_image(TIFF_JPEG_SEED, noise=False)
    image = synth_image(810, noise=False)
    strips = make_jpeg_tiff(image, 80)
    tiles = make_jpeg_tiff(image, 80, tile=256)
    gray = make_jpeg_tiff(image, 80, gray=True)
    page = synth_image(820, *A4, noise=False)
    a4 = make_jpeg_tiff(page, 80)
    log(f"    read the Pillow-written 1080p RGB ({len(rgb) / 1e3:.0f} kB, "
        f"68 strips) and CMYK ({len(cmyk) / 1e3:.0f} kB, 135 strips) JPEG "
        f"TIFFs; made a 1080p YCbCr 4:2:0 JPEG TIFF in 16-row strips "
        f"({len(strips) / 1e3:.0f} kB, 68) and in 256x256 tiles "
        f"({len(tiles) / 1e3:.0f} kB, 40), a gray one and a {A4[0]}x{A4[1]}"
        f" YCbCr page in 16-row strips ({len(a4) / 1e3:.0f} kB, "
        f"{-(-A4[1] // 16)}) in {time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}
    t0 = time.perf_counter()
    luma = np.clip(np.floor(image.astype(np.float32) @ np.float32(
        [0.299, 0.587, 0.114]) + 0.5), 0, 255).astype(np.uint8)
    checks = []
    for name, data, want in (
            ("RGB", rgb, picture), ("CMYK", cmyk, picture),
            ("YCbCr strips", strips, image), ("YCbCr tiles", tiles, image),
            ("gray", gray, np.repeat(luma[..., None], 3, 2)),
            ("A4 page", a4, page)):
        decode_bytes(data, device="cuda")  # a first call loads its modules
        t1 = time.perf_counter()
        got = decode_bytes(data, device="cuda")[0]
        steps[f"decode {name}"] = time.perf_counter() - t1
        err = got.astype(np.float64) - want
        p = 10 * np.log10(255.0 ** 2 / max(float((err ** 2).mean()), 1e-12))
        checks.append(f"{name} {p:.2f} dB")
        if got.shape != want.shape or p < 30.0:
            raise RuntimeError(f"the {name} JPEG TIFF decode is not its "
                               f"picture ({got.shape}, PSNR {p:.2f} dB)")
    against_plain = []
    for name, data in (("YCbCr strips", strips), ("YCbCr tiles", tiles),
                       ("CMYK", cmyk)):
        diff = np.abs(decode_bytes(data, device="cuda")[0].astype(int)
                      - decode_bytes(data, device="cpu")[0].astype(int))
        against_plain.append(f"{name} max|d|={diff.max()} on "
                             f"{(diff > 0).mean():.3e} of values")
        if diff.max() > 2 or (diff > 0).mean() > MAX_SHARE:
            raise RuntimeError(f"the {name} JPEG TIFF decode on the card is "
                               f"not the plain one on the host's CPU")
    log(f"    decodes against their pictures: {', '.join(checks)} (host + "
        f"card ms: " + ", ".join(f"{k[7:]} {v * 1e3:.1f}" for k, v in
                                 steps.items() if k.startswith("decode "))
        + f"); on the card against the host's plain decode: "
        f"{'; '.join(against_plain)}")
    steps["decode checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    a4_page = tiff.entropy_decode(a4)
    entropy_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, a4_stacks, _, _ = dct.tiff_page_inputs(a4_page, torch.device("cuda"))
    torch.cuda.synchronize()
    stacks_s = time.perf_counter() - t0
    stack_mb = sum(t.numel() * t.element_size() for t in {
        id(x): x for pair in a4_stacks for x in pair}.values()) / 1e6
    log(f"    the A4 page: {-(-A4[1] // 16)} segments entropy-decoded in "
        f"{entropy_s * 1e3:.1f} ms; its dense stacks (luma identity, "
        f"block-diagonal chroma) {stack_mb:.1f} MB, built on the host and "
        f"uploaded with the IDCT planes in {stacks_s * 1e3:.1f} ms a request")
    steps["A4 stacks"] = entropy_s + stacks_s

    small_out = (400, 225)
    head, cmyk_head = {"k3": 1, "k2": "batch"}, {"k3": 2, "k2": "batch"}
    rounds = [
        ("1080p RGB JPEG TIFF (Pillow, 16-row strips) -> w=400 WebP", [rgb],
         16, 400, W, small_out, head),
        ("1080p YCbCr 4:2:0 JPEG TIFF, 16-row strips -> w=400 JPEG",
         [strips], 16, 400, J, small_out, head),
        ("1080p YCbCr 4:2:0 JPEG TIFF, 16-row strips -> w=400 WebP",
         [strips], 16, 400, W, small_out, head),
        ("1080p YCbCr 4:2:0 JPEG TIFF, 256x256 tiles -> w=400 WebP",
         [tiles], 16, 400, W, small_out, head),
        ("1080p CMYK JPEG TIFF (Pillow, 8-row strips) -> w=400 WebP",
         [cmyk], 16, 400, W, small_out, cmyk_head),
        ("1080p gray JPEG TIFF -> JPEG, no resize", [gray], 16, None, J,
         (1920, 1080), {"k3": 1}),
        ("A4 300 dpi YCbCr 4:2:0 JPEG TIFF, 16-row strips -> w=400 WebP",
         [a4], 16, 400, W, (400, 566), head),
    ]
    summary = drive_rounds(rounds, card, steps)
    log("    K3 launches in column strips: " + ", ".join(
        f"{name.split(' JPEG')[0]} {r['k3_strips']} of "
        f"{r['launches']['k3']}" for name, r in summary["rounds"].items()))
    case, steps["K3 at the strip page"] = timed(
        lambda: k3_planes_case(*dct.tiff_page_inputs(
            tiff.entropy_decode(strips), torch.device("cuda")),
            "JPEG TIFF page"))
    log(f"  K3 at the 1080p YCbCr 4:2:0 JPEG TIFF page (68 strips, "
        f"{case['planes']} -> 1088x1920, block-diagonal vertical chroma "
        f"stacks, B=1, one launch) vs plain: max|d|={case['max_abs_err']} "
        f"share(differ)={case['share_differ']:.3e}; device time per call K3 "
        f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), K3 at {case['bound_ms'] / case['ms']:.1%} "
        f"of it [{card}]")
    summary["k3_page"] = case
    summary["a4_stacks"] = {"mb": stack_mb, "ms": stacks_s * 1e3,
                            "entropy_ms": entropy_s * 1e3}
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# phase 22: the TIFF layouts the reference still decoded with Pillow
# ---------------------------------------------------------------------------


def read_ifd(data: bytes) -> dict:
    """The SHORT and LONG entries of a little-endian TIFF's first IFD:
    {tag: (type, values)}."""
    ifd = struct.unpack("<I", data[4:8])[0]
    tags = {}
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        tag, typ, n, raw = struct.unpack(
            "<HHII", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if typ not in (3, 4):
            continue
        size = 2 if typ == 3 else 4
        at = ifd + 10 + 12 * i if n * size <= 4 else raw
        tags[tag] = (typ, list(struct.unpack(f"<{n}{'HI'[typ == 4]}",
                                             data[at:at + n * size])))
    return tags


REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                         np.uint8)


def fill_order_2(data: bytes) -> bytes:
    """A little-endian strip TIFF of SHORT and LONG tags in FillOrder 2:
    each strip's bits reversed, FillOrder (266) set to 2."""
    tags = read_ifd(data)
    w, h = tags.pop(256)[1][0], tags.pop(257)[1][0]
    strips = [REVERSED_BITS[np.frombuffer(data[o:o + n], np.uint8)]
              .tobytes() for o, n in zip(tags.pop(273)[1], tags.pop(279)[1])]
    tags[266] = (3, [2])
    return tiff_file(w, h, tags, strips)


def make_old_style_tiff(img: np.ndarray, quality: int = 80) -> bytes:
    """An old-style JPEG TIFF (compression 6) without Pillow: the image's
    4:2:0 JFIF stream (the port's encoder) as the one strip and behind
    JPEGInterchangeFormat (513, 514), as old scanners wrote them."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    h, w = img.shape[:2]
    planes, qt = host_encode_rgb_to_coefficients(img, quality, (2, 2))
    jpeg = loader.encode_jpeg(planes, qt, w, h, (2, 2))
    return tiff_file(w, h, {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]),
                            277: (3, [3]), 278: (4, [h]), 513: (4, [8]),
                            514: (4, [len(jpeg)])}, [jpeg])


def make_planar_jpeg_tiff(img: np.ndarray, quality: int = 80,
                          rows: int = 16) -> bytes:
    """A planar (PlanarConfiguration 2) RGB JPEG TIFF without Pillow: each
    channel's strips one-component JPEGs (``make_jpeg_tiff``'s gray
    segments of the channel), plane after plane, the planes' one
    ``JPEGTables``."""
    from imagekit_tpu_torch.codecs import tiff

    h, w = img.shape[:2]
    segs, tables = [], b""
    for c in range(3):
        plane = np.repeat(img[..., c:c + 1], 3, 2)
        data = make_jpeg_tiff(plane, quality, rows=rows, gray=True)
        info, offs, cnts = tiff.segments(data)
        tables = data[info.tables_off:info.tables_off + info.tables_len]
        segs += [data[o:o + n] for o, n in zip(offs.tolist(), cnts.tolist())]
    return tiff_file(w, h, {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]),
                            277: (3, [3]), 278: (4, [rows]), 284: (3, [2]),
                            347: (7, tables)}, segs)


def with_unspecified_extra(cmyk_jpeg_tiff: bytes) -> bytes:
    """Pillow's CMYK JPEG TIFF rewritten as RGB with one unspecified extra
    sample (photometric 2, ExtraSamples 0): its four-component segments and
    tables as they are, the fourth component dropped in the decode."""
    from imagekit_tpu_torch.codecs import tiff

    info, offs, cnts = tiff.segments(cmyk_jpeg_tiff)
    tables = cmyk_jpeg_tiff[info.tables_off:info.tables_off + info.tables_len]
    segs = [cmyk_jpeg_tiff[o:o + n] for o, n in zip(offs.tolist(),
                                                    cnts.tolist())]
    return tiff_file(info.width, info.height, {
        258: (3, [8] * 4), 259: (3, [7]), 262: (3, [2]), 277: (3, [4]),
        278: (4, [info.seg_h]), 284: (3, [1]), 338: (3, [0]),
        347: (7, tables)}, segs)


def make_cmyk16_tiff(img: np.ndarray) -> bytes:
    """A 16-bit CMYK TIFF (chunky, little-endian, uncompressed), as a
    prepress tool writes one: C, M, Y = (255 - R, G, B) * 257 plus a
    seeded low byte, K = 0; its high bytes are Pillow's CMYK."""
    h, w = img.shape[:2]
    ink = np.concatenate([255 - img, np.zeros((h, w, 1), np.uint8)], 2)
    low = np.random.default_rng(16).integers(0, 256, ink.shape, np.uint16)
    px = (ink.astype(np.uint16) << 8) | low
    return tiff_file(w, h, {258: (3, [16] * 4), 259: (3, [1]), 262: (3, [5]),
                            277: (3, [4]), 278: (4, [h])},
                     [px.astype("<u2").tobytes()])


def elevation(seed: int, w: int = 1920, h: int = 1080) -> np.ndarray:
    """A seeded float32 raster like a digital elevation model's tile: ridges
    and noise from -40 to 300 m, with no-data NaN holes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    z = (130 + 120 * np.sin(x / 97) * np.cos(y / 61)
         + 40 * np.sin((x + y) / 23) + rng.normal(0, 4, (h, w)))
    z[rng.random((h, w)) < 1e-3] = np.nan
    return z.astype(np.float32)


def make_float_tiff(z: np.ndarray) -> bytes:
    """A float32 gray TIFF as GDAL writes elevation: deflate with the
    floating-point predictor (3), in strips of 16 rows: each row's
    big-endian bytes as four byte planes, differenced byte by byte."""
    h, w = z.shape
    b = z.astype(">f4").view(np.uint8).reshape(h, w, 4)
    planes = np.concatenate([b[:, :, k] for k in range(4)], axis=1)
    planes[:, 1:] = planes[:, 1:] - planes[:, :-1]
    strips = [zlib.compress(planes[y:y + 16].tobytes(), 1)
              for y in range(0, h, 16)]
    return tiff_file(w, h, {258: (3, [32]), 259: (3, [8]), 262: (3, [1]),
                            277: (3, [1]), 278: (4, [16]), 317: (3, [3]),
                            339: (3, [3])}, strips)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    err = a.astype(np.float64) - b
    return 10 * np.log10(255.0 ** 2 / max(float((err ** 2).mean()), 1e-12))


def float_bytes(z: np.ndarray) -> np.ndarray:
    """Pillow's F -> RGB of a float raster: truncated to a byte, NaN and
    what is not above 0 to 0, 255 and above to 255; (h, w, 3) u8."""
    v = np.where(z > 0, z, 0)
    g = np.where(v >= 255, 255, np.trunc(np.nan_to_num(v))).astype(np.uint8)
    return np.repeat(g[..., None], 3, 2)


def phase_tiff_remainder(card: str) -> dict:
    """The TIFF layouts the reference still decoded with Pillow, through one
    engine: an old-style JPEG page (the JFIF stream behind 513/514
    entropy-decoded on the codec pool; on a dispatch thread the IDCT, ONE
    K3 launch with replication stacks for chroma, libtiff's YCbCr to RGB),
    a planar RGB JPEG page (ONE K3 launch for its three planes), an RGB
    JPEG page with an unspecified extra sample (TWO), a 16-bit CMYK page
    (high bytes on the pool, the CMYK colour step on a dispatch thread), a
    float32 elevation raster (deflate, floating-point predictor: to bytes
    on the pool) and an A4 G4 page in FillOrder 2; the RGB head (K2) a
    batch. Each decode is checked first, against its picture or Pillow's
    rule and, for the JPEG pages, against the plain decode on the host's
    CPU. Then the rounds (``drive_rounds``), and K3 at the old-style page's
    replication stacks against its plain version (exact: weights of 1 on
    u8)."""
    from imagekit_tpu_torch.codecs import decode_bytes, tiff
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import dct

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    picture = synth_image(830, noise=False)
    old = make_old_style_tiff(picture)
    planar = make_planar_jpeg_tiff(picture)
    rgbx = with_unspecified_extra(open(TIFF_JPEG_CMYK_FIXTURE, "rb").read())
    cmyk16 = make_cmyk16_tiff(picture)
    z = elevation(840)
    raster = make_float_tiff(z)
    g4 = fill_order_2(open(G4_FIXTURE, "rb").read())
    log(f"    made a 1080p old-style JPEG TIFF ({len(old) / 1e3:.0f} kB, "
        f"JFIF behind 513/514), a planar RGB JPEG TIFF in 16-row strips "
        f"({len(planar) / 1e3:.0f} kB, 3 x 68), an RGB + unspecified extra "
        f"sample JPEG TIFF ({len(rgbx) / 1e3:.0f} kB), a 16-bit CMYK TIFF "
        f"({len(cmyk16) / 1e6:.1f} MB), a float32 elevation raster "
        f"(deflate, predictor 3, {len(raster) / 1e6:.1f} MB) and the A4 G4 "
        f"page in FillOrder 2 ({len(g4) / 1e3:.1f} kB) in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    page = text_page(G4_SEED)
    exact = {"16-bit CMYK": (cmyk16, picture),
             "float32 raster": (raster, float_bytes(z)),
             "FillOrder 2 G4": (g4, np.repeat(np.where(
                 page, 255, 0).astype(np.uint8)[..., None], 3, 2))}
    checks = []
    for name, (data, want) in exact.items():
        got = decode_bytes(data, device="cuda")[0]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"the {name} TIFF decode is not its picture")
        checks.append(f"{name} exact")
    for name, data in (("old-style", old), ("planar", planar),
                       ("RGB + extra", rgbx)):
        got = decode_bytes(data, device="cuda")[0]
        if name != "RGB + extra":
            p = psnr(got, picture)
            checks.append(f"{name} {p:.2f} dB")
            if got.shape != picture.shape or p < 30.0:
                raise RuntimeError(f"the {name} JPEG TIFF decode is not its "
                                   f"picture (PSNR {p:.2f} dB)")
        diff = np.abs(got.astype(int) - decode_bytes(
            data, device="cpu")[0].astype(int))
        checks.append(f"{name} vs the host's plain decode max|d|="
                      f"{diff.max()} on {(diff > 0).mean():.3e}")
        if got.shape[:2] != (1080, 1920) or diff.max() > 2 or (
                diff > 0).mean() > MAX_SHARE:
            raise RuntimeError(f"the {name} JPEG TIFF decode on the card is "
                               f"not the plain one on the host's CPU")
    log(f"    decodes: {'; '.join(checks)}")
    steps["decode checks"] = time.perf_counter() - t0

    small_out = (400, 225)
    head = {"k3": 1, "k2": "batch"}
    rounds = [
        ("1080p old-style JPEG TIFF (JFIF behind 513/514) -> w=400 WebP",
         [old], 16, 400, W, small_out, head),
        ("1080p planar RGB JPEG TIFF, 16-row strips -> w=400 JPEG",
         [planar], 16, 400, J, small_out, head),
        ("1080p RGB JPEG TIFF + unspecified extra sample -> w=400 WebP",
         [rgbx], 16, 400, W, small_out, {"k3": 2, "k2": "batch"}),
        ("1080p 16-bit CMYK TIFF -> w=400 WebP", [cmyk16], 16, 400, W,
         small_out, {"k2": "batch"}),
        ("1080p float32 elevation raster (deflate, predictor 3) -> w=400 "
         "WebP", [raster], 16, 400, W, small_out, {"k2": "batch"}),
        ("A4 300 dpi G4 page, FillOrder 2 -> w=400 WebP", [g4], 16, 400, W,
         (400, 566), {"k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    case, steps["K3 at the old-style page"] = timed(
        lambda: k3_planes_case(*dct.tiff_page_inputs(
            tiff.entropy_decode(old), torch.device("cuda")),
            "old-style page"))
    if case["max_abs_err"] != 0:
        raise RuntimeError(f"K3 at the replication stacks is not exact: "
                           f"max|d|={case['max_abs_err']}")
    log(f"  K3 at the 1080p old-style JPEG TIFF page ({case['planes']} -> "
        f"1088x1920, identity luma and replication chroma stacks, B=1, one "
        f"launch) vs plain: max|d|={case['max_abs_err']}; device time per "
        f"call K3 {case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs "
        f"einsum {case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} "
        f"ms ({case['bound_by']}), K3 at "
        f"{case['bound_ms'] / case['ms']:.1%} of it [{card}]")
    summary["k3_page"] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 23: the DDS and JPEG layouts the reference still decoded with Pillow
# ---------------------------------------------------------------------------

JPEG_WRITER = os.path.join(ROOT, "tests", "fixtures", "jpeg_writer.py")
#: the 1080p JPEG layouts of the phase: (h, v) factors of Y, Cb, Cr, and
#: whether each component has a scan of its own
JPEG_LAYOUTS = {
    "4:1:1": (((4, 1), (1, 1), (1, 1)), True),
    "Cb 1x1, Cr 2x1": (((2, 2), (1, 1), (2, 1)), True),
    "4:2:0, a scan a component": (((2, 2), (1, 1), (1, 1)), False),
    "4:4:4, a scan a component": (((1, 1), (1, 1), (1, 1)), False),
}
BC_WEIGHTS4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                        60, 64])


@functools.lru_cache(maxsize=None)
def jpeg_writer(name: str = "jpeg_writer"):
    """``tests/fixtures/<name>.py`` (``jpeg_writer``, ``jpeg_arith_writer``
    or ``jpeg_lossless_writer``), loaded by its path (numpy only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(JPEG_WRITER), name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dds_file(w: int, h: int, body: bytes, fourcc: bytes = b"DX10",
             dxgi: int = 0, pfflags: int = 0x4, bitcount: int = 0,
             extra: bytes = b"") -> bytes:
    """A DDS header (and a DX10 one for ``fourcc`` DX10) before ``extra``
    (a palette) and the body."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x81007, h, w, len(body), 0, 0)
            + bytes(44) + struct.pack("<4I", 32, pfflags,
                                      struct.unpack("<I", fourcc)[0],
                                      bitcount)
            + bytes(16) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if fourcc == b"DX10":
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + extra + body


def _pack_bits(fields, n: int) -> np.ndarray:
    """(value array, bits) pairs of N blocks, LSB first -> (N, 16) u8."""
    lo = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)
    pos = 0
    for val, bits in fields:
        val = np.asarray(val, np.uint64) & np.uint64((1 << bits) - 1)
        for b in range(bits):
            bit = (val >> np.uint64(b)) & np.uint64(1)
            if pos < 64:
                lo |= bit << np.uint64(pos)
            else:
                hi |= bit << np.uint64(pos - 64)
            pos += 1
    return np.concatenate([lo.astype("<u8").view(np.uint8).reshape(n, 8),
                           hi.astype("<u8").view(np.uint8).reshape(n, 8)], 1)


def _indices4(target, e0, e1):
    """4-bit BC6H / BC7 indices of each texel: the weight (of
    BC_WEIGHTS4 / 64) nearest its projection on the line e0 -> e1; texel 0's
    index must be below 8, else the endpoints swap. target (N, 16, C), e0
    and e1 (N, C) -> (indices (N, 16), e0, e1)."""
    d = (e1 - e0).astype(np.float64)
    t = ((target - e0[:, None]) * d[:, None]).sum(-1) / np.maximum(
        (d * d).sum(-1), 1e-9)[:, None]
    idx = np.abs(t[..., None] * 64 - BC_WEIGHTS4).argmin(-1)
    swap = idx[:, 0] >= 8
    idx[swap] = 15 - idx[swap]
    e0, e1 = np.where(swap[:, None], e1, e0), np.where(swap[:, None], e0, e1)
    return idx, e0, e1


def make_bc7(img: np.ndarray):
    """An RGBA BC7 texture in mode 6 (one subset, 7-bit endpoints and a
    p-bit each, 4-bit indices): each block's channel-wise min (p-bit 0) and
    max (p-bit 1) as its endpoints. Returns (the blocks, what a decoder
    gives)."""
    h, w = img.shape[:2]
    px = _blocks4(img).astype(np.int64)
    lo, hi = px.min(1) >> 1, np.minimum(px.max(1) >> 1, 127)
    e0, e1 = lo << 1, (hi << 1) | 1
    idx, e0, e1 = _indices4(px, e0, e1)
    p0, p1 = e0[:, 0] & 1, e1[:, 0] & 1
    n = len(px)
    fields = [(np.full(n, 1 << 6), 7)]
    for c in range(4):
        fields += [(e0[:, c] >> 1, 7), (e1[:, c] >> 1, 7)]
    fields += [(p0, 1), (p1, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    wgt = BC_WEIGHTS4[idx][..., None]
    out = ((64 - wgt) * e0[:, None] + wgt * e1[:, None] + 32) >> 6
    return (_pack_bits(fields, n).tobytes(),
            _unblocks4(out.astype(np.uint8), h, w))


def _bc6_value(x: np.ndarray) -> np.ndarray:
    """What an unsigned BC6H texel decodes to for an interpolated
    unquantised value x: x * 31 >> 6 as a half float, clipped to [0, 1],
    times 255 truncated."""
    half = ((x * 31) >> 6).astype(np.uint16).view(np.float16)
    f = np.clip(half.astype(np.float32), 0, 1)
    return (f * np.float32(255)).astype(np.uint8)


def make_bc6h(img: np.ndarray):
    """An unsigned BC6H texture in mode 11 (one region, 10-bit endpoints,
    4-bit indices): each channel's byte v mapped to the least 10-bit
    endpoint that decodes to at least v, each block's channel-wise min and
    max of those as its endpoints. Returns (the blocks, what a decoder
    gives)."""
    h, w = img.shape[:2]
    x = np.arange(1023, dtype=np.int64)
    unq = np.where(x == 0, 0, ((x << 15) + 0x4000) >> 9)
    table = np.searchsorted(_bc6_value(unq), np.arange(256))
    px = table[_blocks4(img)]
    e0, e1 = px.min(1), px.max(1)
    idx, e0, e1 = _indices4(px, e0, e1)
    n = len(px)
    fields = [(np.full(n, 3), 5)]
    fields += [(e0[:, c], 10) for c in range(3)]
    fields += [(e1[:, c], 10) for c in range(3)]
    fields += [(idx[:, 0], 3)] + [(idx[:, i], 4) for i in range(1, 16)]

    def unquantise(e):
        return np.where(e == 0, 0, np.where(e == 1023, 0xFFFF,
                                            ((e << 15) + 0x4000) >> 9))

    wgt = BC_WEIGHTS4[idx][..., None]
    v = ((64 - wgt) * unquantise(e0)[:, None]
         + wgt * unquantise(e1)[:, None]) >> 6
    return _pack_bits(fields, n).tobytes(), _unblocks4(_bc6_value(v), h, w)


def make_bc4(plane: np.ndarray, signed: bool = False):
    """BC4 blocks of one u8 plane (:func:`_bc3_alpha`); ``signed`` writes
    the endpoints as signed BC5 reads them, each byte its value minus 128.
    Returns (the (N, 8) blocks, the decoded plane)."""
    h, w = plane.shape
    blocks, dec = _bc3_alpha(_blocks4(plane[..., None])[..., 0])
    if signed:
        blocks[:, :2] ^= 0x80
    return blocks, _unblocks4(dec[..., None].astype(np.uint8), h, w)[..., 0]


def normal_map(seed: int, n: int = 2048) -> np.ndarray:
    """A tangent-space normal map's X and Y of a seeded height field, as
    signed BC5 stores them plus 128: (n, n, 2) u8 in 1..255."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    z = (np.sin(x / 37 + rng.random() * 6) * np.cos(y / 53)
         + 0.3 * np.sin((x + 2 * y) / 11))
    gy, gx = np.gradient(z * 8)
    norm = np.sqrt(gx * gx + gy * gy + 1)
    return np.stack([np.rint(127 * -gx / norm) + 128,
                     np.rint(127 * -gy / norm) + 128], -1).astype(np.uint8)


def make_palette(img: np.ndarray):
    """An 8-bit palette of a 6 x 7 x 6 colour cube (RGBA, the rest zero)
    and each pixel's nearest entry. Returns (the palette, the indices, what
    a decoder gives)."""
    levels = (6, 7, 6)
    q = [np.rint(img[..., c].astype(np.float32) * (n - 1) / 255).astype(int)
         for c, n in enumerate(levels)]
    index = (q[0] * 7 + q[1]) * 6 + q[2]
    r, g, b = np.meshgrid(*(np.rint(np.arange(n) * 255 / (n - 1))
                            for n in levels), indexing="ij")
    pal = np.zeros((256, 4), np.uint8)
    pal[:252] = np.stack([r.ravel(), g.ravel(), b.ravel(),
                          np.full(252, 255)], -1)
    return pal, index.astype(np.uint8), pal[index, :3]


@functools.lru_cache(maxsize=None)
def make_dds_textures():
    """The phase's DDS files and the pixels each must decode to."""
    out = {}
    body, want = make_bc7(ramp_alpha(synth_image(910, 2048, 2048,
                                                 noise=False)))
    out["2048x2048 BC7 (mode 6)"] = (dds_file(2048, 2048, body, dxgi=98),
                                     want)
    body, want = make_bc6h(synth_image(920, 2048, 2048, noise=False))
    out["2048x2048 BC6H (UF16, mode 11)"] = (
        dds_file(2048, 2048, body, dxgi=95), want)
    nm = normal_map(930)
    bx, dx = make_bc4(nm[..., 0], signed=True)
    by, dy = make_bc4(nm[..., 1], signed=True)
    out["2048x2048 signed BC5 normal map"] = (
        dds_file(2048, 2048, np.concatenate([bx, by], 1).tobytes(),
                 fourcc=b"BC5S"),
        np.stack([dx, dy, np.full_like(dx, 128)], -1))
    small = synth_image(940, 1024, 1024, noise=False)
    blocks, dec = make_bc4(small[..., 1])
    out["1024x1024 BC4"] = (dds_file(1024, 1024, blocks.tobytes(),
                                     fourcc=b"BC4U"),
                            np.repeat(dec[..., None], 3, 2))
    raw = ramp_alpha(small)
    out["1024x1024 R8G8B8A8"] = (dds_file(1024, 1024, raw.tobytes(),
                                          dxgi=28), raw)
    pal, index, want = make_palette(small)
    out["1024x1024 8-bit palette"] = (
        dds_file(1024, 1024, index.tobytes(), fourcc=b"\0\0\0\0",
                 pfflags=0x20, bitcount=8, extra=pal.tobytes()), want)
    return out


@functools.lru_cache(maxsize=None)
def make_jpeg_layouts(writer) -> dict:
    """The phase's 1080p JPEGs (q80, from :data:`JPEG_LAYOUTS`) and their
    picture."""
    picture = synth_image(950, noise=False)
    return {name: writer.encode(picture, 80, samp, interleaved=inter)
            for name, (samp, inter) in JPEG_LAYOUTS.items()}, picture


def phase_dds_jpeg_layouts(card: str) -> dict:
    """The DDS and JPEG layouts the reference still decoded with Pillow,
    through one engine: DDS textures decode on the codec pool
    (``codecs/dds.py``, ``native/raster_decode.cpp`` and
    ``bcn_ext_decode.cpp``) and take the batched RGB head (K2, three or
    four channels); JPEGs in 4:1:1, with Cb and Cr sampled differently or
    in one scan a component are entropy-decoded on the pool (the pinned
    decoder, or the port's ``jpeg4_decode.cpp`` for the non-interleaved
    ones), then on a dispatch thread the IDCT and ONE K3 launch with each
    component's own stacks, then the RGB head. Each decode is checked
    first: the DDS ones exactly against the numpy model of their blocks,
    the JPEGs against their picture and the host's plain decode. Then the
    rounds (``drive_rounds``), and K3 at the 4:1:1 page's identity and
    replication stacks against its plain version (exact: weights of 1 on
    u8)."""
    from imagekit_tpu_torch.codecs import decode_bytes, jpeg
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import dct

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    textures = make_dds_textures()
    writer = jpeg_writer()
    layouts, picture = make_jpeg_layouts(writer)
    log(f"    made {len(textures)} DDS textures ("
        + ", ".join(f"{k} {len(d) / 1e6:.2f} MB"
                    for k, (d, _) in textures.items())
        + f") and {len(layouts)} 1080p q80 JPEGs ("
        + ", ".join(f"{k} {len(d) / 1e3:.0f} kB" for k, d in layouts.items())
        + f") in {time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    checks = []
    for name, (data, want) in textures.items():
        got = decode_bytes(data, device="cuda")[0]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"the {name} DDS decode is not its blocks' "
                               f"model")
        checks.append(f"{name} exact")
    for name, data in layouts.items():
        got = decode_bytes(data, device="cuda")[0]
        p = psnr(got, picture)
        diff = np.abs(got.astype(int) - decode_bytes(
            data, device="cpu")[0].astype(int))
        checks.append(f"{name} {p:.2f} dB, vs the host's plain decode "
                      f"max|d|={diff.max()} on {(diff > 0).mean():.3e}")
        if got.shape != picture.shape or p < 30.0:
            raise RuntimeError(f"the {name} JPEG decode is not its picture "
                               f"(PSNR {p:.2f} dB)")
        if diff.max() > 2 or (diff > 0).mean() > MAX_SHARE:
            raise RuntimeError(f"the {name} JPEG decode on the card is not "
                               f"the plain one on the host's CPU")
    log(f"    decodes: {'; '.join(checks)}")
    steps["decode checks"] = time.perf_counter() - t0

    names = list(textures)
    rgb_dds = [textures[k][0] for k in names if "BC7" not in k
               and "R8G8B8A8" not in k]
    rgba_dds = [textures[k][0] for k in names if "BC7" in k
                or "R8G8B8A8" in k]
    out = (400, 400)
    head = {"k3": 1, "k2": "batch"}
    rounds = [
        ("DDS BC6H, signed BC5, BC4, palette -> w=400 WebP", rgb_dds, 16,
         400, W, out, {"k2": "batch"}),
        ("DDS BC7, R8G8B8A8 -> w=400 WebP", rgba_dds, 16, 400, W, out,
         {"k2_rgba": "batch"}),
        ("1080p JPEG 4:1:1, Cb 1x1 / Cr 2x1, 4:2:0 and 4:4:4 a scan a "
         "component -> w=400 WebP", list(layouts.values()), 16, 400, W,
         (400, 225), head),
        ("1080p JPEG 4:1:1, Cb 1x1 / Cr 2x1, 4:2:0 and 4:4:4 a scan a "
         "component -> w=400 JPEG", list(layouts.values()), 16, 400, J,
         (400, 225), head),
    ]
    summary = drive_rounds(rounds, card, steps)
    case, steps["K3 at the 4:1:1 page"] = timed(
        lambda: k3_planes_case(*dct.sampled_inputs(
            jpeg.decode_to_coefficients(layouts["4:1:1"]),
            torch.device("cuda")), "4:1:1 page"))
    if case["max_abs_err"] != 0:
        raise RuntimeError(f"K3 at the identity and replication stacks is "
                           f"not exact: max|d|={case['max_abs_err']}")
    log(f"  K3 at the 1080p 4:1:1 page ({case['planes']} -> 1080x1920, "
        f"identity luma and replication chroma stacks, B=1, one launch) vs "
        f"plain: max|d|={case['max_abs_err']}; device time per call K3 "
        f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), K3 at {case['bound_ms'] / case['ms']:.1%} of "
        f"it [{card}]")
    summary["k3_page"] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 24: arithmetic-coded and lossless JPEGs
# ---------------------------------------------------------------------------

S420 = ((2, 2), (1, 1), (1, 1))
S444 = ((1, 1), (1, 1), (1, 1))
SCMYK = ((2, 2), (1, 1), (1, 1), (2, 2))


@functools.lru_cache(maxsize=None)
def make_arith_lossless():
    """The phase's 1080p sources, from one seeded picture, by the numpy
    writers of ``tests/fixtures/``: arithmetic 4:2:0 (SOF9, restart
    intervals of a row of MCUs), arithmetic progressive 4:4:4 with
    successive approximation (SOF10), arithmetic CMYK with an Adobe APP14
    (SOF9; C and K at 2x2; stored as Adobe's inverted inks, the picture's
    R, G and B over a K of 255, so that it decodes to the picture), all at
    q50 (fewer coded coefficients: the writer's QM coder is a Python loop),
    lossless gray (predictor 1) and lossless RGB with its G and B at half
    size (predictor 4, Pt 1; the samples as they are, no colour step).
    Returns name -> (bytes, what the decoders must give: coefficient planes,
    or sample planes; the picture it shows)."""
    jw, aw, lw = (jpeg_writer(n) for n in (
        "jpeg_writer", "jpeg_arith_writer", "jpeg_lossless_writer"))
    picture = synth_image(980, noise=False)
    w, h = picture.shape[1], picture.shape[0]
    p420, tabs, tq = jw.coefficients(picture, 50, S420)
    p444, tabs444, tq444 = jw.coefficients(picture, 50, S444)
    inks, _, _ = jw.coefficients(picture, 50, S420, colour="rgb")
    white, _, _ = jw.coefficients(np.full_like(picture, 255), 50, S420)
    pcmyk = inks + white[:1]
    gray = picture.mean(axis=2).round().astype(np.uint8)
    rgb = lw.subsample(picture, S420)
    return {
        "arithmetic 4:2:0": (aw.write(p420, tabs, w, h, S420, tq,
                                      restart=w // 16), p420, picture),
        "arithmetic progressive 4:4:4": (aw.write(
            p444, tabs444, w, h, S444, tq444, progressive=True), p444,
            picture),
        "arithmetic CMYK": (aw.write(pcmyk, tabs, w, h, SCMYK, tq + [0],
                                     adobe_transform=0), pcmyk, picture),
        "lossless gray": (lw.write([gray], w, h, ((1, 1),), predictor=1),
                          [gray], np.repeat(gray[:, :, None], 3, axis=2)),
        "lossless RGB, G and B at 1/2": (lw.write(
            rgb, w, h, S420, predictor=4, pt=1), [(p >> 1) << 1
                                                  for p in rgb], picture),
    }


def phase_arith_lossless(card: str) -> dict:
    """Arithmetic-coded and lossless JPEGs through one engine: the port's
    ``jpeg4_decode.cpp`` entropy-decodes them on the codec pool (the QM
    decoder; the lossless decoder, samples out), then on a dispatch thread
    the pixel decode (the IDCT and ONE K3 launch a request, TWO for CMYK;
    for the lossless RGB frame ONE K3 launch of replication stacks, none
    for lossless gray), then the RGB head (K2, one launch a batch). Each
    decode is checked first: the arithmetic decodes' coefficients exactly
    the planes the writer was given and the lossless decodes' samples
    exactly its samples, on the card's host; the pixels on the card against
    the host's plain decode. Then the rounds (``drive_rounds``), and K3 at
    the lossless page's replication stacks against its plain version
    (exact: weights of 1 on u8)."""
    from imagekit_tpu_torch.codecs import decode_bytes, jpeg
    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import dct

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    sources = make_arith_lossless()
    log("    made 1080p sources (" + ", ".join(
        f"{k} {len(d) / 1e3:.0f} kB" for k, (d, _, _) in sources.items())
        + f") in {time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    lib = loader.load()
    checks = []
    for name, (data, want, picture) in sources.items():
        t1 = time.perf_counter()
        if name.startswith("lossless"):
            got = jpeg_abi.decode_lossless(lib, data)[1]
        else:
            got = jpeg_abi.decode4(lib, data)[1]
        host_s = time.perf_counter() - t1
        if len(got) != len(want) or not all(
                np.array_equal(g, x) for g, x in zip(got, want)):
            raise RuntimeError(f"the {name} entropy decode is not what its "
                               f"writer was given")
        card_rgb = decode_bytes(data, device="cuda")[0]
        diff = np.abs(card_rgb.astype(int) - decode_bytes(
            data, device="cpu")[0].astype(int))
        p = psnr(card_rgb, picture)
        checks.append(f"{name}: {'samples' if name.startswith('lossless') else 'coefficients'}"
                      f" exact (host decode {host_s * 1e3:.1f} ms), "
                      f"{p:.2f} dB to the picture, vs the host's plain "
                      f"decode max|d|={diff.max()}")
        if card_rgb.shape != picture.shape or diff.max() > 2 or (
                (diff > 0).mean() > MAX_SHARE):
            raise RuntimeError(f"the {name} decode on the card is not the "
                               f"plain one on the host's CPU")
        if p < 25.0:
            raise RuntimeError(f"the {name} decode is not its picture "
                               f"(PSNR {p:.2f} dB)")
    log(f"    decodes: {'; '.join(checks)}")
    steps["decode checks"] = time.perf_counter() - t0

    out = (400, 225)
    rounds = [
        ("1080p arithmetic 4:2:0 -> w=400 WebP",
         [sources["arithmetic 4:2:0"][0]], 16, 400, W, out,
         {"k3": 1, "k2": "batch"}),
        ("1080p arithmetic progressive 4:4:4 -> w=400 JPEG",
         [sources["arithmetic progressive 4:4:4"][0]], 16, 400, J, out,
         {"k3": 1, "k2": "batch"}),
        ("1080p arithmetic CMYK -> w=400 WebP",
         [sources["arithmetic CMYK"][0]], 16, 400, W, out,
         {"k3": 2, "k2": "batch"}),
        ("1080p lossless gray -> w=400 WebP",
         [sources["lossless gray"][0]], 16, 400, W, out, {"k2": "batch"}),
        ("1080p lossless RGB, G and B at 1/2 -> w=400 WebP",
         [sources["lossless RGB, G and B at 1/2"][0]], 16, 400, W, out,
         {"k3": 1, "k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    case, steps["K3 at the lossless page"] = timed(
        lambda: k3_planes_case(*dct.lossless_inputs(
            jpeg.decode_to_coefficients(
                sources["lossless RGB, G and B at 1/2"][0]),
            torch.device("cuda")), "lossless page"))
    if case["max_abs_err"] != 0:
        raise RuntimeError(f"K3 at the replication stacks is not exact: "
                           f"max|d|={case['max_abs_err']}")
    log(f"  K3 at the 1080p lossless page ({case['planes']} -> 1088x1920, "
        f"identity and replication stacks, B=1, one launch) vs plain: "
        f"max|d|={case['max_abs_err']}; device time per call K3 "
        f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), K3 at {case['bound_ms'] / case['ms']:.1%} of "
        f"it [{card}]")
    summary["k3_page"] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 25: CMYK JPEGs in every sampling, lossless CMYK, the last JPEG TIFF
# layouts and CCITT's uncompressed-mode flag
# ---------------------------------------------------------------------------

S411K = ((4, 1), (1, 1), (1, 1), (4, 1))  # C and K 4x1: M and Y at 1/4
S3K = ((3, 1), (1, 1), (1, 1), (3, 1))    # ratios of 3


def tiff_with_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with a LONG entry ``tag`` = ``value`` added: its
    IFD written again after the data (word-aligned), one entry more."""
    if data[:2] != b"II":
        raise RuntimeError("tiff_with_tag takes little-endian TIFFs")
    data += b"\0" * (len(data) % 2)
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    entries = [data[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
    entries.append(struct.pack("<HHII", tag, 4, 1, value))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    return (data[:4] + struct.pack("<I", len(data)) + data[8:]
            + struct.pack("<H", n + 1) + b"".join(entries) + b"\0\0\0\0")


@functools.lru_cache(maxsize=None)
def make_remainder_sources():
    """The phase's sources, without Pillow, from one seeded 1080p picture:
    CMYK JPEGs (``tests/fixtures/jpeg_writer.py``, q80, an Adobe APP14 of
    transform 0; the picture's R, G and B as C, M and Y over a K of 255,
    stored as Adobe's inverted inks, so that they decode to the picture) at
    a 4:1:1-like sampling (``S411K``) and at ratios of 3 (``S3K``);
    lossless CMYK (``jpeg_lossless_writer.py``, predictor 1) sampled alike
    and with C and K at 2x2; a YCbCr 4:2:0 JPEG TIFF page of 16-row strips,
    each arithmetic-coded (``jpeg_arith_writer.py``, q50: the writer's QM
    coder is a Python loop); a planar RGB JPEG TIFF page whose 36-row
    strips straddle blocks, each a one-component JPEG of its own tables
    (``jpeg_writer.py``, q80); and the committed Group 4 A4 page with
    T6Options 2 (the uncompressed-mode bit; its rows use no such code).
    Returns name -> (bytes, the picture it shows)."""
    jw, aw, lw = (jpeg_writer(n) for n in (
        "jpeg_writer", "jpeg_arith_writer", "jpeg_lossless_writer"))
    picture = synth_image(990, noise=False)
    h, w = picture.shape[:2]
    four = np.dstack([picture, np.full((h, w), 255, np.uint8)])

    def cmyk(samp):
        planes, tabs, tq = jw.coefficients(four, 80, samp, colour="raw")
        return jw.write(planes, tabs, w, h, samp, tq, adobe_transform=0)

    def lossless(samp):
        return lw.write(lw.subsample(four, samp), w, h, samp, predictor=1)

    def strips(rows, seg):
        return [seg(y, picture[y:y + rows]) for y in range(0, h, rows)]

    def arith_strip(_, part):
        planes, tabs, tq = jw.coefficients(part, 50, S420)
        return aw.write(planes, tabs, w, part.shape[0], S420, tq)

    def gray_strip(c):
        def seg(_, part):
            planes, tabs, tq = jw.coefficients(part[:, :, c:c + 1], 80,
                                               ((1, 1),), colour="raw")
            return jw.write(planes, tabs, w, part.shape[0], ((1, 1),), tq)
        return seg

    arith_tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]),
                  277: (3, [3]), 278: (4, [16]), 284: (3, [1]),
                  530: (3, [2, 2])}
    planar_tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]),
                   277: (3, [3]), 278: (4, [36]), 284: (3, [2])}
    with open(G4_FIXTURE, "rb") as f:
        g4 = f.read()
    page = np.repeat(np.where(text_page(G4_SEED), 255, 0).astype(
        np.uint8)[:, :, None], 3, axis=2)
    return {
        "CMYK 4:1:1-like": (cmyk(S411K), picture),
        "CMYK ratio 3": (cmyk(S3K), picture),
        "lossless CMYK": (lossless(((1, 1),) * 4), picture),
        "lossless CMYK, C and K at 2x2": (lossless(SCMYK), picture),
        "arithmetic JPEG TIFF": (tiff_file(w, h, arith_tags, strips(
            16, arith_strip)), picture),
        "planar JPEG TIFF, 36-row strips": (tiff_file(
            w, h, planar_tags, [s for c in range(3)
                                for s in strips(36, gray_strip(c))]),
            picture),
        "G4 page, uncompressed-mode bit": (tiff_with_tag(g4, 293, 2), page),
    }


def phase_cmyk_tiff_remainder(card: str) -> dict:
    """CMYK JPEGs in every sampling, lossless CMYK, arithmetic and planar
    JPEG TIFF pages and a G4 page that flags uncompressed mode, through one
    engine: the CMYK JPEGs' pixel decode takes each component's stacks by
    libjpeg's upsampling (replication at ratios of 3 and 4) in TWO K3
    launches a request; lossless CMYK sampled alike needs no K3, sampled
    differently TWO launches on replication stacks; the arithmetic TIFF
    page's segments go through the QM decoder, then ONE K3 launch a page;
    the planar page, whose strips straddle blocks, decodes segment by
    segment, ONE launch for its three planes a strip; the G4 page decodes on
    the host; then the RGB head (K2, one launch a batch). Each decode is
    checked first on the card against the host's plain decode (the lossless
    ones and the G4 page exactly) and against its picture. Then the rounds
    (``drive_rounds``; the planar page's of 8 requests, each of which
    takes 0.7-0.8 s of the dispatch threads), and K3 at the 4:1:1-like
    CMYK planes (identity and replication) and at the lossless CMYK page's
    replication stacks against its plain version (exact: weights of 1 on
    u8)."""
    from imagekit_tpu_torch.codecs import decode_bytes, jpeg
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import dct

    W, J = ImageFormat.webp, ImageFormat.jpeg
    t0 = time.perf_counter()
    sources = make_remainder_sources()
    log("    made the sources (" + ", ".join(
        f"{k} {len(d) / 1e3:.0f} kB" for k, (d, _) in sources.items())
        + f") in {time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    checks = []
    for name, (data, picture) in sources.items():
        card_rgb = decode_bytes(data, device="cuda")[0]
        host = decode_bytes(data, device="cpu")[0]
        diff = np.abs(card_rgb.astype(int) - host.astype(int))
        exact = name.startswith(("lossless", "G4"))
        p = psnr(card_rgb, picture)
        checks.append(f"{name}: vs the host's plain decode max|d|="
                      f"{diff.max()}, {p:.2f} dB to the picture")
        if card_rgb.shape != picture.shape or (
                diff.max() > (0 if exact else 2)) or (
                (diff > 0).mean() > MAX_SHARE):
            raise RuntimeError(f"the {name} decode on the card is not the "
                               f"plain one on the host's CPU")
        if exact and name != "lossless CMYK, C and K at 2x2" and (
                not np.array_equal(card_rgb, picture)):
            raise RuntimeError(f"the {name} decode is not its picture")
        if p < 25.0:
            raise RuntimeError(f"the {name} decode is not its picture "
                               f"(PSNR {p:.2f} dB)")
    log(f"    decodes: {'; '.join(checks)}")
    steps["decode checks"] = time.perf_counter() - t0

    out = (400, 225)
    strips = -(-1080 // 36)
    rounds = [
        ("1080p CMYK 4:1:1-like -> w=400 WebP",
         [sources["CMYK 4:1:1-like"][0]], 16, 400, W, out,
         {"k3": 2, "k2": "batch"}),
        ("1080p CMYK at ratios of 3 -> w=400 JPEG",
         [sources["CMYK ratio 3"][0]], 16, 400, J, out,
         {"k3": 2, "k2": "batch"}),
        ("1080p lossless CMYK sampled alike (no K3) -> w=400 WebP",
         [sources["lossless CMYK"][0]], 16, 400, W, out, {"k2": "batch"}),
        ("1080p lossless CMYK, C and K at 2x2 -> w=400 WebP",
         [sources["lossless CMYK, C and K at 2x2"][0]], 16, 400, W, out,
         {"k3": 2, "k2": "batch"}),
        ("1080p arithmetic JPEG TIFF, 68 strips -> w=400 WebP",
         [sources["arithmetic JPEG TIFF"][0]], 16, 400, W, out,
         {"k3": 1, "k2": "batch"}),
        (f"1080p planar JPEG TIFF, 3 x {strips} straddling strips "
         f"-> w=400 JPEG",
         [sources["planar JPEG TIFF, 36-row strips"][0]], 8, 400, J, out,
         {"k3": strips, "k2": "batch"}),
        ("A4 G4 page, uncompressed-mode bit -> w=400 WebP",
         [sources["G4 page, uncompressed-mode bit"][0]], 16, 400, W,
         (400, 566), {"k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    cases = {}
    for key, what, make in (
            ("k3_cmyk_411", "CMYK 4:1:1-like", lambda: dct.sampled_inputs(
                jpeg.decode_to_coefficients(sources["CMYK 4:1:1-like"][0]),
                torch.device("cuda"))),
            ("k3_lossless_cmyk", "lossless CMYK", lambda: dct.lossless_inputs(
                jpeg.decode_to_coefficients(
                    sources["lossless CMYK, C and K at 2x2"][0]),
                torch.device("cuda")))):
        case, steps[f"K3 at the {what} planes"] = timed(
            lambda: k3_planes_case(*make(), what))
        if case["max_abs_err"] != 0:
            raise RuntimeError(f"K3 at the {what} planes (identity and "
                               f"replication stacks) is not exact: "
                               f"max|d|={case['max_abs_err']}")
        log(f"  K3 at the 1080p {what} planes ({case['planes']} -> "
            f"1088x1920, identity and replication stacks, B=1, two "
            f"launches) vs plain: max|d|={case['max_abs_err']}; device time "
            f"per call K3 {case['ms']:.4f} ms vs plain "
            f"{case['plain_ms']:.4f} ms vs einsum {case['library_ms']:.4f} "
            f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}), K3 "
            f"at {case['bound_ms'] / case['ms']:.1%} of it [{card}]")
        summary[key] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# -- phase 26: CIELab, YCbCr without JPEG, planar 16-bit CMYK, Orientation --


def lzw_literal(data: bytes) -> bytes:
    """TIFF LZW of ``data`` in literal codes only: a Clear, at most 253
    byte codes (so the table stops short of 511 entries and every code
    stays 9 bits), again, then EOI. A stream any TIFF LZW decoder reads;
    numpy alone, fast enough for a 1080p page."""
    raw = np.frombuffer(data, np.uint8).astype(np.uint16)
    n = len(raw)
    codes = np.full(n + -(-n // 253) + 1, 256, np.uint16)  # Clear codes
    codes[np.arange(n) + np.arange(n) // 253 + 1] = raw
    codes[-1] = 257
    bits = (codes[:, None] >> np.arange(8, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()


def lab_bytes(img: np.ndarray) -> np.ndarray:
    """A picture's CIELab samples as a chunky TIFF stores them, by a rough
    mapping (the card's machine has no colour management to ask): L the
    BT.601 luma, a* and b* half the red-green and green-blue differences,
    as signed bytes."""
    f = img.astype(np.int32)
    lum = (299 * f[..., 0] + 587 * f[..., 1] + 114 * f[..., 2] + 500) // 1000
    a = np.clip((f[..., 0] - f[..., 1]) // 2, -128, 127)
    b = np.clip((f[..., 1] - f[..., 2]) // 2, -128, 127)
    return np.stack([lum, a & 255, b & 255], -1).astype(np.uint8)


def make_lab_tiff(img: np.ndarray, rows: int = 16) -> bytes:
    """A CIELab TIFF (photometric 8) of ``lab_bytes(img)``, LZW strips of
    ``rows`` rows."""
    h, w = img.shape[:2]
    lab = lab_bytes(img)
    tags = {258: (3, [8] * 3), 259: (3, [5]), 262: (3, [8]), 277: (3, [3]),
            278: (4, [rows]), 284: (3, [1])}
    return tiff_file(w, h, tags, [lzw_literal(lab[y:y + rows].tobytes())
                                  for y in range(0, h, rows)])


def ycc_planes(img: np.ndarray, sub=(2, 2)):
    """BT.601 full-range Y, Cb and Cr of a picture, the chroma averaged over
    each ``sub`` (horizontal, vertical) block: (H, W), then (ceil(H / v),
    ceil(W / h)) each, u8."""
    f = img.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = 128 - 0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2]
    cr = 128 + 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2]
    sh, sv = sub
    h, w = y.shape
    ch, cw = -(-h // sv), -(-w // sh)

    def box(p):
        p = np.pad(p, ((0, ch * sv - h), (0, cw * sh - w)), mode="edge")
        return p.reshape(ch, sv, cw, sh).mean(axis=(1, 3))

    def u8(p):
        return np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8)

    return u8(y), u8(box(cb)), u8(box(cr))


def ycc_strip(y, cb, cr, sub, y0: int, rows: int) -> bytes:
    """Rows [y0, y0 + rows) of a YCbCr page as a chunky TIFF stores them:
    blocks of sub_h x sub_v luma samples, row by row, then Cb and Cr, whole
    blocks past the image's edges (the luma replicated there)."""
    sh, sv = sub
    w = y.shape[1]
    bw, bh = -(-w // sh), -(-rows // sv)
    yy = np.pad(y[y0:y0 + rows], ((0, bh * sv - rows), (0, bw * sh - w)),
                mode="edge")
    blocks = yy.reshape(bh, sv, bw, sh).transpose(0, 2, 1, 3).reshape(
        bh, bw, sv * sh)
    c0 = y0 // sv
    return np.concatenate([blocks, cb[c0:c0 + bh, :, None],
                           cr[c0:c0 + bh, :, None]], -1).tobytes()


def make_ycbcr_tiff(img: np.ndarray, sub=(2, 2), rows: int = 16) -> bytes:
    """A YCbCr TIFF compressed without JPEG: the picture's ``ycc_planes``
    in LZW strips of ``rows`` rows (a multiple of the vertical
    subsampling), YCbCrSubSampling ``sub``."""
    h, w = img.shape[:2]
    y, cb, cr = ycc_planes(img, sub)
    tags = {258: (3, [8] * 3), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [rows]), 284: (3, [1]), 530: (3, list(sub))}
    return tiff_file(w, h, tags, [
        lzw_literal(ycc_strip(y, cb, cr, sub, y0, min(rows, h - y0)))
        for y0 in range(0, h, rows)])


def make_cmyk16_planar_tiff(img: np.ndarray, rows: int = 64) -> bytes:
    """A planar 16-bit CMYK TIFF of a picture (C, M, Y the inverted R, G,
    B, K 0, each sample its byte times 257), deflate strips of ``rows``
    rows, plane by plane."""
    h, w = img.shape[:2]
    inks = np.dstack([255 - img, np.zeros((h, w), np.uint8)]).astype(
        np.uint16) * 257
    tags = {258: (3, [16] * 4), 259: (3, [8]), 262: (3, [5]), 277: (3, [4]),
            278: (4, [rows]), 284: (3, [2])}
    return tiff_file(w, h, tags, [
        zlib.compress(inks[y:y + rows, :, c].astype("<u2").tobytes())
        for c in range(4) for y in range(0, h, rows)])


def make_gray4_bmp(values: np.ndarray) -> bytes:
    """A BITMAPCOREHEADER BMP of 4 bpp whose palette is the grays 0-15
    (which Pillow reads as 8-bit gray: each row's first bytes, a byte a
    pixel), of ``values`` (h, w) in 0-15, w at most 4."""
    h, w = values.shape
    stride = ((w * 4 + 31) // 32) * 4
    rows = np.zeros((h, stride), np.uint8)
    packed = np.zeros((h, (w + 1) // 2 * 2), np.uint8)
    packed[:, :w] = values
    rows[:, :packed.shape[1] // 2] = (packed[:, 0::2] << 4) | packed[:, 1::2]
    body = rows[::-1].tobytes()
    palette = bytes(v for i in range(16) for v in (i, i, i))
    off = 14 + 12 + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off)
            + struct.pack("<IHHHH", 12, w, h, 1, 4) + palette + body)


@functools.lru_cache(maxsize=None)
def make_lab_ycbcr_sources():
    """The phase's sources, without Pillow, from one seeded 1080p picture:
    a CIELab LZW page, a YCbCr 4:2:0 LZW page, a planar 16-bit CMYK page,
    an RGB picture's YCbCr JPEG TIFF page with Orientation 6, and a 4 x 3
    gray-palette 4 bpp BMP (Pillow serves that BMP up to 4 pixels wide).
    Returns name -> (bytes, the picture it shows, or None)."""
    picture = synth_image(1260, noise=False)
    values = np.arange(12, dtype=np.uint8).reshape(3, 4)
    # what Pillow reads of that BMP: each row's first four bytes
    bmp_px = np.zeros((3, 4), np.uint8)
    bmp_px[:, :2] = (values[:, 0::2] << 4) | values[:, 1::2]
    bmp_px = np.repeat(bmp_px[:, :, None], 3, axis=2)
    return {
        "CIELab": (make_lab_tiff(picture), None),
        "YCbCr 4:2:0": (make_ycbcr_tiff(picture), picture),
        "planar 16-bit CMYK": (make_cmyk16_planar_tiff(picture), picture),
        "Orientation 6": (tiff_with_tag(make_jpeg_tiff(picture, 90), 274, 6),
                          np.ascontiguousarray(np.rot90(picture, -1))),
        "gray 4 bpp BMP": (make_gray4_bmp(values), bmp_px),
    }


def phase_lab_ycbcr(card: str) -> dict:
    """CIELab, YCbCr compressed without JPEG, planar 16-bit CMYK, an
    Orientation 6 page and the gray-palette 4 bpp BMP through one engine:
    the CIELab page's colour step (littleCMS's lattice, integer torch ops
    on the card) on a dispatch thread; the YCbCr page's chroma replicated
    by K3 (ONE launch a page), then libtiff's YCbCr -> RGB; the CMYK page's
    colour step on the card; the JPEG TIFF page's pixel decode (ONE K3
    launch), then the Orientation, on the card; the BMP on the host; then
    the RGB head (K2, one launch a batch). Each decode is checked first on
    the card against the host's plain decode (exact but the JPEG page's)
    and against its picture. The CIELab conversion on the card is held to
    the host's on all 2^24 triples; K3 at the YCbCr page's replication
    stacks against its plain version (exact)."""
    from imagekit_tpu_torch.codecs import decode_bytes, tiff
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.ops import color, dct
    from imagekit_tpu_torch.ops.weights import target_dimensions

    W = ImageFormat.webp
    t0 = time.perf_counter()
    sources = make_lab_ycbcr_sources()
    log("    made the sources (" + ", ".join(
        f"{k} {len(d) / 1e3:.0f} kB" for k, (d, _) in sources.items())
        + f") in {time.perf_counter() - t0:.2f} s")
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    checks = []
    for name, (data, picture) in sources.items():
        card_rgb = decode_bytes(data, device="cuda")[0]
        host = decode_bytes(data, device="cpu")[0]
        diff = np.abs(card_rgb.astype(int) - host.astype(int))
        exact = name != "Orientation 6"
        line = f"{name}: vs the host's plain decode max|d|={diff.max()}"
        if card_rgb.shape != host.shape or (
                diff.max() > (0 if exact else 2)) or (
                (diff > 0).mean() > MAX_SHARE):
            raise RuntimeError(f"the {name} decode on the card is not the "
                               f"plain one on the host's CPU ({line})")
        if picture is not None:
            p = psnr(card_rgb, picture)
            line += f", {p:.2f} dB to the picture"
            if card_rgb.shape != picture.shape or p < 30.0:
                raise RuntimeError(f"the {name} decode is not its picture "
                                   f"({line})")
        checks.append(line)
    log(f"    decodes: {'; '.join(checks)}")
    steps["decode checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    triples = torch.arange(1 << 24, dtype=torch.int64)
    triples = torch.stack([triples >> 16, (triples >> 8) & 255,
                           triples & 255], -1).to(torch.uint8)
    on_card = color.lab_to_rgb(triples.cuda()).cpu()
    on_host = torch.cat([color.lab_to_rgb(part)
                         for part in triples.split(1 << 22)])
    off = (on_card.int() - on_host.int()).abs().amax(-1)
    lab = {"triples": 1 << 24, "off_by_1": int((off == 1).sum()),
           "off_by_more": int((off > 1).sum())}
    log(f"    CIELab -> RGB on the card against the host on all 2^24 "
        f"triples: {lab['off_by_1']} off by 1, {lab['off_by_more']} by "
        f"more [{card}]")
    if lab["off_by_more"] or lab["off_by_1"] > 1e-3 * (1 << 24):
        raise RuntimeError(f"the CIELab conversion on the card is not the "
                           f"host's: {lab}")
    steps["CIELab table"] = time.perf_counter() - t0

    out = (400, 225)
    portrait = target_dimensions(1080, 1920, 400, None)
    rounds = [
        ("1080p CIELab LZW page -> w=400 WebP", [sources["CIELab"][0]], 8,
         400, W, out, {"k2": "batch"}),
        ("1080p YCbCr 4:2:0 LZW page -> w=400 WebP",
         [sources["YCbCr 4:2:0"][0]], 8, 400, W, out,
         {"k3": 1, "k2": "batch"}),
        ("1080p planar 16-bit CMYK page -> w=400 WebP",
         [sources["planar 16-bit CMYK"][0]], 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p JPEG TIFF page, Orientation 6 -> w=400 WebP",
         [sources["Orientation 6"][0]], 8, 400, W, portrait,
         {"k3": 1, "k2": "batch"}),
        ("4x3 gray-palette 4 bpp BMP -> w=400 WebP",
         [sources["gray 4 bpp BMP"][0]], 8, 400, W, (400, 300),
         {"k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    summary["lab"] = lab
    page, kind, _ = tiff.decode_stored(sources["YCbCr 4:2:0"][0])
    h, w = page.y.shape
    frame = dct._YccFrame(w, h, page.sub)
    case, steps["K3 at the YCbCr planes"] = timed(
        lambda: k3_planes_case(*dct.lossless_inputs(
            (frame, (page.y, page.cb, page.cr), None), torch.device("cuda")),
            "YCbCr 4:2:0"))
    if case["max_abs_err"] != 0:
        raise RuntimeError(f"K3 at the YCbCr planes (identity and "
                           f"replication stacks) is not exact: "
                           f"max|d|={case['max_abs_err']}")
    log(f"  K3 at the 1080p YCbCr 4:2:0 planes ({case['planes']} -> "
        f"1088x1920, identity and replication stacks, B=1, one launch) vs "
        f"plain: max|d|={case['max_abs_err']}; device time per call K3 "
        f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), K3 at {case['bound_ms'] / case['ms']:.1%} "
        f"of it [{card}]")
    summary["k3_ycbcr"] = case
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 27: AVIF sources, the port's AV1 decoder and K2's YUV entries
# ---------------------------------------------------------------------------

AVIF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "avif")
#: the screen-content fixtures: the screenshot and the logo sheet code
#: palettes and intra block copy, the RGBA logo palettes in its alpha
AVIF_SCREEN = ("1080p_screenshot", "1080p_logos", "1080p_rgba_logo")
#: the superres fixtures (libaom's, SuperresDenom 16, 11 and 13): their
#: decodes are also timed 8 at once
AVIF_SUPERRES = ("1080p_superres", "1080p_10bit_superres_444",
                 "1080p_superres_grain")


@functools.lru_cache(maxsize=None)
def avif_sources() -> dict:
    """Phase 27's committed AVIFs (``tests/fixtures/make_avif_sources.py``:
    Pillow's writer, the card's machine has none) with the SHA-256 of
    libdav1d's planes of each and its quantizer-matrix and film-grain
    flags: name -> (bytes, entry)."""
    with open(os.path.join(AVIF_FIXTURES, "avif_planes.json")) as f:
        table = json.load(f)
    out = {}
    for name, entry in table.items():
        with open(os.path.join(AVIF_FIXTURES, entry["file"]), "rb") as f:
            out[name] = (f.read(), entry)
    return out


def avif_decode_case(data: bytes) -> dict:
    """The port's AV1 decode of one file on the host: the digest of its
    planes (colour item, rounded to 8 bits, then the alpha item's luma;
    for 10 and 12 bits also of the raw planes, little-endian) and the
    colour item's decode time (the least of three), with its bit depth,
    the palette and intrabc blocks it coded (the alpha item's palettes
    too), whether its frame header uses quantizer matrices and film grain,
    and its SuperresDenom (8 without superres)."""
    import hashlib

    from imagekit_tpu_torch.codecs import avif_native
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    info = avif_native.parse_container(data)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        y, u, v, head = av1_dec_abi.decode(info.obu)
        times.append(time.perf_counter() - t0)
    digest = hashlib.sha256()
    for p in (y, u, v):
        digest.update(np.ascontiguousarray(p).tobytes())
    alpha_palettes = 0
    if info.alpha_obu:
        ay, _au, _av, ahead = av1_dec_abi.decode(info.alpha_obu)
        digest.update(ay.tobytes())
        alpha_palettes = ahead.palette_blocks
    samples = None
    if head.bitdepth > 8:
        raw = hashlib.sha256()
        for p in av1_dec_abi.decode_samples(info.obu)[:3]:
            raw.update(p.astype("<u2").tobytes())
        samples = raw.hexdigest()
    layout = {0: "4:0:0", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}[head.layout]
    return {"sha256": digest.hexdigest(), "sha256_samples": samples,
            "superres_denom": head.superres_denom,
            "decode_ms": min(times) * 1e3, "layout": layout,
            "alpha": bool(info.alpha_obu), "bytes": len(data),
            "bitdepth": head.bitdepth, "palette_blocks": head.palette_blocks,
            "intrabc_blocks": head.intrabc_blocks,
            "alpha_palette_blocks": alpha_palettes,
            "qmatrix": head.qmatrix, "film_grain": head.film_grain}


def avif_decodes_at_once(data: bytes, n: int = 8) -> float:
    """Milliseconds of wall time for ``n`` decodes of the colour item on
    ``n`` threads at once (the engine's codec pool decodes a batch's files
    so; the decoder's own threads compete), the least of three."""
    from concurrent.futures import ThreadPoolExecutor

    from imagekit_tpu_torch.codecs import avif_native
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    obu = avif_native.parse_container(data).obu
    best = float("inf")
    with ThreadPoolExecutor(n) as pool:
        for _ in range(3):
            t0 = time.perf_counter()
            list(pool.map(av1_dec_abi.decode, [obu] * n))
            best = min(best, time.perf_counter() - t0)
    return best * 1e3


@contextlib.contextmanager
def quick_avif_encodes():
    """AVIF encodes stubbed while a batch is captured: the capture keeps the
    head's device inputs, and the first-party encoder's seconds (1-6 s an
    image on the card's host) are not what it measures."""
    from imagekit_tpu_torch.codecs import avif_encode

    real = avif_encode.encode_yuv420_studio
    avif_encode.encode_yuv420_studio = lambda *a, **kw: b""
    try:
        yield
    finally:
        avif_encode.encode_yuv420_studio = real


def k2_avif_case(call, what: str) -> dict:
    """K2 at a captured AVIF batch's planes (``resize_yuv420_batch``'s
    inputs): the u8 entry with Y, Cb, Cr (any chroma factors) and alpha in
    one launch, or with ``mix`` the f32 entry's six resizes, against the
    plain version, timed, with the einsum yardstick and the bound."""
    from imagekit_tpu_torch.ops import dct, resize_strip

    args, kw, _ = call
    flat, weights, vidx, in_shape = args[0], args[1], args[2], args[3]
    cs, alpha, mix = tuple(kw["chroma_sub"]), kw["alpha"], kw["mix"]
    bands = kw["bands"]
    planes = dct.yuv_planes(flat, *in_shape, cs, alpha)
    n = len(planes)
    if mix:
        fn = lambda: resize_strip.yuv_mix_resize(planes, weights, vidx,
                                                 bands=bands)
        plain = lambda: resize_strip.yuv_mix_resize_plain(planes, weights,
                                                          vidx)
        srcs = [planes[0], planes[1], planes[2], planes[1], planes[2]] + list(
            planes[3:])
        pairs = resize_strip._mix_pairs(weights, n)
        luma, half, full = bands
        tabs = [luma, full, full, half, half, luma][:len(srcs)]
        fresh = [True, True, True, False, False, True][:len(srcs)]
    else:
        fn = lambda: resize_strip.yuv_resize(planes, weights, vidx,
                                             bands=bands)
        plain = lambda: resize_strip.yuv_resize_plain(planes, weights, vidx)
        srcs, pairs = list(planes), resize_strip._yuv_pairs(weights, n)
        luma, chroma = bands
        tabs = [luma, chroma, chroma, luma][:n]
        fresh = [True] * n
    before = resize_strip.LAUNCHES
    got = fn()
    torch.cuda.synchronize()
    if resize_strip.LAUNCHES != before + 1:
        raise RuntimeError(f"K2 ({what}) did not launch once")
    ref = plain()
    worst = 0.0
    for a, b in zip(got, ref):
        if mix:
            d = float((a - b).abs().max())
            if d > 1e-3:
                raise RuntimeError(f"K2's f32 entry ({what}) disagrees with "
                                   f"its plain version: max|d|={d}")
            worst = max(worst, d)
        else:
            mx, _ = check_band(f"K2 ({what})", a, b)
            worst = max(worst, mx)
    ms = device_ms(fn)
    plain_ms = device_ms(plain)
    library_ms = device_ms(plane_list_einsums(srcs, pairs, vidx))
    from imagekit_tpu_torch.ops.resize_strip import band_table

    nbytes = flops = 0.0
    for x, (wv, wh), t, first in zip(srcs, pairs, tabs, fresh):
        out_px = x.shape[0] * wv.shape[1] * wh.shape[1]
        # each input plane read once, each output written once
        nb, fl = resize_bound(x.numel() if first else 0,
                              out_px * (4 if mix else 1), wv, t.band_v,
                              band_table(wh), vidx, vidx, x.shape[2])
        nbytes += nb
        flops += fl
    bound_ms, bound_by = bound(nbytes, flops)
    shapes = ", ".join(f"{tuple(x.shape[1:])}->{(wv.shape[1], wh.shape[1])}"
                       for x, (wv, wh) in zip(srcs, pairs))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "planes": shapes, "B": int(flat.shape[0])}


def phase_avif_sources(card: str) -> dict:
    """AVIF sources: the port's AV1 decoder on the host, then K2.

    The committed 1080p AVIFs (4:2:0, 4:4:4, 4:2:2, RGBA, BT.709, CDEF and
    speed 4 with loop restoration, 4x2 tiles each; a UI screenshot and a
    logo sheet at Pillow's defaults, which code palette blocks and intra
    block copy, and an RGBA logo sheet whose alpha item codes palettes; a
    10-bit 4:2:0 picture with CDEF and a 12-bit 4:4:4 one with loop
    restoration; a 4:2:0 picture with quantizer matrices (libaom's
    ``tune=iq``), one with film grain (test vector 4: lag 3, overlap) and
    a 10-bit 4:4:4 one with both; libaom's superres files: 4:2:0 at
    SuperresDenom 16 with CDEF and switchable restoration, 10-bit 4:4:4
    at 11 in 4 tile columns, 4:2:0 at 13 with film grain) decode on the
    host with the port's decoder (``codecs/native/av1_decode.cpp``): the
    planes' SHA-256 must be libdav1d's, recorded where the fixtures were
    made (for 10 and 12 bits both the 8-bit planes' and the raw 16-bit
    planes'; with the grain synthesized), the screen files must have coded
    their tools, exactly the files made with quantizer matrices, film
    grain and superres must say so in their frame headers (the
    denominator the one recorded), and the superres files' decodes are
    also timed 8 at once. K2's entries for these batches,
    captured from the engine at B=8 (the AVIF encodes stubbed for the
    capture), against their plain versions and timed: the u8 entry with
    4:4:4 and 4:2:2 chroma, with the alpha plane as a fourth, and the f32
    entry's six resizes of a BT.709 batch; then the batch of each file of
    this slice. Then rounds of 8 requests through one engine (2 for AVIF
    output, which its one encode thread bounds), counts reset before
    each, each run once, traced: the decode on the codec pool, ONE K2
    launch a batch, and the VP8, Huffman or first-party AV1 encode."""
    from imagekit_tpu_torch.codecs import avif_native
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.serving import engine_yuv

    W, J, A = ImageFormat.webp, ImageFormat.jpeg, ImageFormat.avif
    t0 = time.perf_counter()
    sources = avif_sources()
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    decodes = {}
    for name, (data, entry) in sources.items():
        case = avif_decode_case(data)
        if case["sha256"] != entry["sha256"]:
            raise RuntimeError(f"the port's AV1 decode of {name} is not "
                               f"libdav1d's planes ({case['sha256']} != "
                               f"{entry['sha256']})")
        if case["sha256_samples"] != entry.get("sha256_samples"):
            raise RuntimeError(f"the port's {case['bitdepth']}-bit samples of "
                               f"{name} are not libdav1d's")
        if name in AVIF_SCREEN and not (
                case["palette_blocks"] or case["alpha_palette_blocks"]):
            raise RuntimeError(f"{name} coded no palette block")
        if name in AVIF_SCREEN[:2] and not case["intrabc_blocks"]:
            raise RuntimeError(f"{name} coded no intra block copy")
        if (case["qmatrix"], case["film_grain"]) != (entry["qmatrix"],
                                                     entry["film_grain"]):
            raise RuntimeError(f"{name}'s frame header: quantizer matrices "
                               f"{case['qmatrix']}, film grain "
                               f"{case['film_grain']}")
        if case["superres_denom"] != entry["superres_denom"]:
            raise RuntimeError(f"{name}'s frame header: SuperresDenom "
                               f"{case['superres_denom']}, the fixture's "
                               f"{entry['superres_denom']}")
        if (name in AVIF_SUPERRES) != (case["superres_denom"] != 8):
            raise RuntimeError(f"{name}: superres {case['superres_denom']}")
        if name in AVIF_SUPERRES:
            case["decode8_ms"] = avif_decodes_at_once(data)
        decodes[name] = case
        tools = (f", quantizer matrices {'yes' if case['qmatrix'] else 'no'}"
                 f", film grain {'yes' if case['film_grain'] else 'no'}")
        if case["superres_denom"] != 8:
            d, w = case["superres_denom"], entry["width"]
            tools += (f", superres: SuperresDenom {d} (coded "
                      f"{max((w * 8 + d // 2) // d, min(16, w))} px wide, "
                      f"upscaled to {w}); 8 decodes at once "
                      f"{case['decode8_ms']:.2f} ms wall "
                      f"({case['decode8_ms'] / 8:.2f} ms a frame)")
        if case["bitdepth"] > 8:
            tools += (f", {case['bitdepth']}-bit: raw planes = libdav1d's "
                     f"(SHA-256 {case['sha256_samples'][:16]}...)")
        if case["palette_blocks"] or case["alpha_palette_blocks"]:
            tools += (f", {case['palette_blocks']} palette and "
                      f"{case['intrabc_blocks']} intrabc blocks (alpha: "
                      f"{case['alpha_palette_blocks']} palette)")
        log(f"    {name} ({case['layout']}{', alpha' if case['alpha'] else ''}"
            f", {case['bytes'] / 1e3:.1f} kB{tools}): planes = libdav1d's "
            f"(SHA-256 {case['sha256'][:16]}...), avif_decode "
            f"{case['decode_ms']:.2f} ms a frame on the host [{card}]")
    steps["decode checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    k2 = {}
    captures = (("444", "1080p_444", W, "4:4:4, three planes"),
                ("422", "1080p_422", W, "4:2:2, three planes"),
                ("420+a", "1080p_rgba", A, "4:2:0 and alpha, four planes"),
                ("420+mix", "1080p_bt709", W,
                 "BT.709: Y, chroma to two grids, f32"),
                ("screenshot", "1080p_screenshot", W,
                 "UI screenshot (palette, intrabc), 4:2:0"),
                ("logos", "1080p_logos", W,
                 "logo sheet (palette, intrabc), 4:2:0"),
                ("rgba_logo", "1080p_rgba_logo", A,
                 "RGBA logo sheet (palettes in the alpha), four planes"),
                ("10bit", "1080p_10bit_420", W, "10-bit 4:2:0, rounded"),
                ("12bit_444", "1080p_12bit_444", W, "12-bit 4:4:4, rounded"),
                ("qm", "1080p_qm", W, "quantizer matrices (tune=iq), 4:2:0"),
                ("grain", "1080p_grain", W,
                 "film grain (lag 3, overlap), 4:2:0"),
                ("10bit_grain_444", "1080p_10bit_grain_444", W,
                 "10-bit 4:4:4, quantizer matrices and film grain, "
                 "rounded"),
                ("superres", "1080p_superres", W,
                 "superres 16 with CDEF and restoration, 4:2:0"),
                ("superres_444", "1080p_10bit_superres_444", W,
                 "10-bit 4:4:4 superres 11 in 4 tile columns, rounded"),
                ("superres_grain", "1080p_superres_grain", W,
                 "superres 13 with film grain, 4:2:0"))
    for entry, name, fmt, what in captures:
        with quick_avif_encodes():
            call = capture_batch([sources[name][0]], 400, 8,
                                 "resize_yuv420_batch", module=engine_yuv,
                                 fmt=fmt)
        case = k2_avif_case(call, what)
        k2[entry] = case
        log(f"  K2 vs plain, {what} (B={case['B']}: {case['planes']}): "
            f"max|d|={case['max_abs_err']}; device time per call K2 "
            f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
            f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']}), K2 at {case['bound_ms'] / case['ms']:.1%} "
            f"of it [{card}]")
    steps["K2 entries"] = time.perf_counter() - t0

    def src(name):
        return [sources[name][0]]

    out, small = (400, 225), (160, 90)
    rounds = [
        ("1080p 4:2:0 AVIF -> w=400 WebP", src("1080p_420"), 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p 4:4:4 AVIF -> w=400 WebP", src("1080p_444"), 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p 4:2:2 AVIF -> w=400 WebP", src("1080p_422"), 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p RGBA AVIF -> w=160 AVIF, alpha kept", src("1080p_rgba"), 2,
         160, A, small, {"k2": "batch"}),
        ("1080p BT.709 AVIF -> w=400 WebP", src("1080p_bt709"), 8, 400, W,
         out, {"k2": "batch"}),
        ("1080p BT.709 AVIF -> w=400 JPEG", src("1080p_bt709"), 8, 400, J,
         out, {"k2": "batch"}),
        ("1080p CDEF AVIF -> w=400 JPEG", src("1080p_cdef"), 8, 400, J, out,
         {"k2": "batch"}),
        ("1080p speed-4 AVIF (loop restoration) -> w=160 AVIF",
         src("1080p_speed4_lr"), 2, 160, A, small, {"k2": "batch"}),
        ("1080p UI screenshot AVIF (palette, intrabc) -> w=400 WebP",
         src("1080p_screenshot"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p logo sheet AVIF (palette, intrabc) -> w=400 JPEG",
         src("1080p_logos"), 8, 400, J, out, {"k2": "batch"}),
        ("1080p RGBA logo AVIF (palettes in the alpha) -> w=160 AVIF",
         src("1080p_rgba_logo"), 2, 160, A, small, {"k2": "batch"}),
        ("1080p 10-bit 4:2:0 AVIF -> w=400 WebP", src("1080p_10bit_420"), 8,
         400, W, out, {"k2": "batch"}),
        ("1080p 12-bit 4:4:4 AVIF -> w=400 JPEG", src("1080p_12bit_444"), 8,
         400, J, out, {"k2": "batch"}),
        ("1080p AVIF with quantizer matrices (tune=iq) -> w=400 WebP",
         src("1080p_qm"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p AVIF with film grain -> w=400 JPEG", src("1080p_grain"), 8,
         400, J, out, {"k2": "batch"}),
        ("1080p 10-bit 4:4:4 AVIF, quantizer matrices and film grain -> "
         "w=400 JPEG", src("1080p_10bit_grain_444"), 8, 400, J, out,
         {"k2": "batch"}),
        ("1080p superres AVIF (16, CDEF, restoration) -> w=400 WebP",
         src("1080p_superres"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p 10-bit 4:4:4 superres AVIF (11, 4 tile columns) -> w=400 "
         "WebP", src("1080p_10bit_superres_444"), 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p superres AVIF with film grain (13) -> w=400 WebP",
         src("1080p_superres_grain"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p 10-bit 4:4:4 superres AVIF (11) -> w=400 JPEG",
         src("1080p_10bit_superres_444"), 8, 400, J, out, {"k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    summary["decodes"] = decodes
    summary["k2"] = k2
    for entry in ("444", "422", "420+a", "420+mix"):
        if summary["yuv_launches"].get(entry, 0) <= 0:
            raise RuntimeError(f"no round launched K2's {entry} entry")
    log(f"    K2's YUV entries launched by the rounds: "
        f"{summary['yuv_launches']}")

    # the alpha survives into AVIF output, and only there
    from imagekit_tpu_torch.config import ImageKitConfig
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    async def alpha_outputs():
        engine = BatchedEngine(ImageKitConfig(secret=SECRET),
                               metrics=Metrics(), device="cuda")
        try:
            return [await engine.transform(sources["1080p_rgba"][0], 160,
                                           None, fmt, 80) for fmt in (A, W)]
        finally:
            await engine.close()

    avif_out, webp_out = asyncio.run(alpha_outputs())
    if not avif_native.parse_container(avif_out).has_alpha or (
            webp_out[:4] != b"RIFF"):
        raise RuntimeError("an RGBA AVIF's alpha is not kept in AVIF output "
                           "alone")
    log("    an RGBA AVIF at w=160: AVIF output keeps its alpha item, WebP "
        "output has none")
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 28: the AVIFs the reference hands to Pillow
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pillow_avif_sources() -> dict:
    """Phase 28's committed AVIFs (``tests/fixtures/make_avif_sources.py
    --pillow``: libavif 0.11.1's writer, which the card's machine lacks,
    as Pillow and libavif themselves) with the SHA-256 of the array that
    Pillow 12.1's libavif 1.3.0 decodes from each, taken where they were
    made: name -> (bytes, entry)."""
    with open(os.path.join(AVIF_FIXTURES, "pillow_arrays.json")) as f:
        table = json.load(f)
    out = {}
    for name, entry in table.items():
        with open(os.path.join(AVIF_FIXTURES, entry["file"]), "rb") as f:
            out[name] = (f.read(), entry)
    return out


def pillow_avif_case(data: bytes) -> dict:
    """The port's decode of one file on the host (``avif_libavif``): the
    digest of its array, the whole decode's ms alone (the least of three,
    the cells and the colour step on threads), and the colour step's
    (``avif_yuv_rgb.convert`` on the decoded planes) threaded and on one
    thread."""
    import hashlib

    from imagekit_tpu_torch.codecs import avif_libavif
    from imagekit_tpu_torch.codecs.native import avif_yuv_rgb

    def least(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, min(times) * 1e3

    arr, decode_ms = least(lambda: avif_libavif.decode_pillow_rgb(data))
    p = avif_libavif.planes_of(data)
    colour = {}
    for threads in (0, 1):
        _, colour[threads] = least(lambda: avif_yuv_rgb.convert(
            p.y, p.u, p.v, p.alpha, p.depth, p.layout, p.full_range,
            p.matrix, p.primaries, p.premultiplied, threads))
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "mode": "RGBA" if arr.shape[2] == 4 else "RGB",
            "shape": arr.shape, "decode_ms": decode_ms,
            "yuv_rgb_ms": colour[0], "yuv_rgb_one_thread_ms": colour[1],
            "depth": p.depth, "layout": p.layout, "matrix": p.matrix,
            "bytes": len(data)}


@functools.lru_cache(maxsize=None)
def remainder_avif_sources() -> dict:
    """Phase 28's files of the last remainder (``tests/fixtures/
    make_avif_sources.py --remainder``: libavif 0.11.1's and libaom's
    writers, spliced), with the path the reference takes for each
    (``native``: libdav1d's first picture; ``pillow``) and the digest of
    the array it decodes, taken where they were made: name -> (bytes,
    entry)."""
    with open(os.path.join(AVIF_FIXTURES, "remainder_arrays.json")) as f:
        table = json.load(f)
    out = {}
    for name, entry in table.items():
        with open(os.path.join(AVIF_FIXTURES, entry["file"]), "rb") as f:
            out[name] = (f.read(), entry)
    return out


def remainder_avif_case(data: bytes, entry: dict) -> dict:
    """The port's decode of one file of the last remainder on the host:
    the array's digest (through ``avif_native.decode_rgb`` for the file
    the native path serves, whose planes' digest is libdav1d's too, else
    ``avif_libavif``), the decode's ms alone (the least of three) and of 8
    decodes at once on 8 threads (the least of three: the engine's codec
    pool decodes a batch's files so)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from imagekit_tpu_torch.codecs import avif_libavif, avif_native
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    native = entry["path"] == "native"
    decode = (avif_native.decode_rgb if native
              else avif_libavif.decode_pillow_rgb)
    arr = decode(data)
    if arr is None:
        raise RuntimeError("the port's native path declines a file it serves")
    case = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "mode": "RGBA" if arr.shape[2] == 4 else "RGB",
            "shape": arr.shape, "bytes": len(data)}
    if native:
        h = hashlib.sha256()
        obu = avif_native.parse_container(data).obu
        y, u, v, info = av1_dec_abi.decode(obu)
        for p in (y, u, v):
            h.update(np.ascontiguousarray(p).tobytes())
        case["planes_sha256"] = h.hexdigest()
        case["frames"], case["spatial_id"] = info.frames, info.spatial_id
    best1 = best8 = float("inf")
    with ThreadPoolExecutor(8) as pool:
        for _ in range(3):
            t0 = time.perf_counter()
            decode(data)
            best1 = min(best1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            list(pool.map(decode, [data] * 8))
            best8 = min(best8, time.perf_counter() - t0)
    case["decode_ms"], case["decode8_ms"] = best1 * 1e3, best8 * 1e3
    return case


def k2_pixels_case(call, head: str, what: str) -> dict:
    """K2 at a captured RGB-head batch: ``rgb_resize`` (``head`` "yuv" or
    "jpg": ``resample_rgb_yuv_batch`` / ``resample_rgb_jpeg_batch``'s
    inputs) or ``rgba_resize`` ("flat": ``resample_bucketed_flat``'s)
    against its plain version on the same inputs, timed, with the einsum
    yardstick (one fp32 einsum a channel) and the bound."""
    from imagekit_tpu_torch.ops import resize_strip
    from imagekit_tpu_torch.ops.resize_strip import band_table, resize_tables

    args, kw, _ = call
    if head == "flat":
        x, wv, wh, vidx, hidx, ch = args[:6]
    else:
        x, (wv, wh), vidx, hidx = args[:4]
        ch = 3
    from imagekit_tpu_torch.ops.color import on_device, tables_on

    x, wv, wh, vidx, hidx = on_device((x, wv, wh, vidx, hidx), "cuda")
    tabs = kw.get("bands")
    tabs = (resize_tables(wv, wh) if tabs is None
            else tables_on(tabs, torch.device("cuda")))
    entry = resize_strip.rgba_resize if ch == 4 else resize_strip.rgb_resize
    plain_fn = (resize_strip.rgba_resize_plain if ch == 4
                else resize_strip.rgb_resize_plain)
    fn = lambda: entry(x, wv, wh, vidx, hidx, bands=tabs)
    plain = lambda: plain_fn(x, wv, wh, vidx, hidx)
    counter = "LAUNCHES_RGBA" if ch == 4 else "LAUNCHES"
    before = getattr(resize_strip, counter)
    got = fn()
    torch.cuda.synchronize()
    if getattr(resize_strip, counter) != before + 1:
        raise RuntimeError(f"K2 ({what}) did not launch once")
    mx, share1 = check_band(f"K2 ({what})", got, plain())
    ms = device_ms(fn)
    plain_ms = device_ms(plain)
    B, H = x.shape[0], x.shape[1]
    W = x.shape[2] // ch
    wv_g, wh_g = wv[vidx.long()], wh[hidx.long()]
    full = x.reshape(B, H, W, ch)
    chans = [full[..., c].float() for c in range(ch)]
    library_ms = device_ms(lambda: [torch.einsum("boh,bhw,bpw->bop", wv_g,
                                                 c_, wh_g) for c_ in chans])
    del chans, wv_g, wh_g
    oh, ow = wv.shape[1], wh.shape[1]
    nbytes, flops = resize_bound(x.numel(), ch * B * oh * ow, wv,
                                 tabs.band_v, band_table(wh), vidx, hidx, W)
    bound_ms, bound_by = bound(nbytes, ch * flops)
    return {"max_abs_err": mx, "share_differ": share1, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"{H}x{W}x{ch} -> {oh}x{ow}", "B": int(B)}


def phase_pillow_avifs(card: str) -> dict:
    """The AVIFs the reference hands to Pillow: a 12 MP grid (8 x 6 cells
    of 512 x 512 cropped to 4032 x 3024), a 10-bit BT.2020 HDR picture, a
    lossless identity-matrix screenshot, a file with an ICC profile and no
    nclx, and a cut-out with premultiplied alpha. Each decodes on the host
    through the port's ``avif_libavif`` (the container as libavif reads
    it, the cells on threads and stitched in YUV, the port's AV1 decoder,
    then ``avif_yuv_rgb.cpp``: libavif 1.3.0's and libyuv's YUV -> RGB):
    its array's SHA-256 must be Pillow's, taken where the files were
    made. K2 against its plain version at each file's RGB-head batch,
    the grid's 3424 x 4352 -> 368 x 400 bucket included. Then the files
    of the last remainder (``remainder_arrays.json``): a 1080p item coded
    at 960 x 540 and the 12 MP grid with its cells coded at half size
    (libavif scales both to their ispe: ``avif_scale.cpp``), a 1080p grid
    with an alpha item a cell, and two layered streams, whose base layer
    is at the full size (the reference's native path, libdav1d's first
    picture: the YUV head) or at half size (libavif's top layer): each
    array against the reference's digest (and libdav1d's planes for the
    native one), decoded alone and 8 at once, K2 at each one's batch. Then
    rounds through one engine (the first grid at 4 requests, the AVIF
    outputs at 2, the others at 8), counts reset before each, each run
    once, traced: the decode on the codec pool (``batcher.decode``, or
    ``avif_decode`` for the native file), ONE K2 launch a batch
    (``rgb_resize``, ``rgba_resize`` for the alpha, ``yuv_resize`` for
    the native file), the encode."""
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.serving import engine_rgb, engine_yuv

    W, J, A = ImageFormat.webp, ImageFormat.jpeg, ImageFormat.avif
    t0 = time.perf_counter()
    sources = pillow_avif_sources()
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    decodes = {}
    for name, (data, entry) in sources.items():
        case = pillow_avif_case(data)
        if case["sha256"] != entry["sha256"] or case["mode"] != entry["mode"]:
            raise RuntimeError(f"the port's decode of {name} is not Pillow's "
                               f"array ({case['mode']} {case['sha256']} != "
                               f"{entry['mode']} {entry['sha256']})")
        decodes[name] = case
        log(f"    {name} ({entry['recipe']}; {case['bytes'] / 1e3:.1f} kB, "
            f"{case['mode']} {case['shape'][1]}x{case['shape'][0]}): array = "
            f"Pillow's (SHA-256 {case['sha256'][:16]}...), decode "
            f"{case['decode_ms']:.2f} ms alone, of it YUV -> RGB "
            f"{case['yuv_rgb_ms']:.2f} ms threaded, "
            f"{case['yuv_rgb_one_thread_ms']:.2f} ms on one thread, on the "
            f"host [{card}]")
    steps["decode checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    k2 = {}
    captures = (("grid", "4032x3024_grid", W, 4, "resample_rgb_yuv_batch",
                 "yuv", "12 MP grid, RGB"),
                ("hdr_2020", "1080p_hdr_2020", W, 8, "resample_rgb_yuv_batch",
                 "yuv", "10-bit BT.2020, RGB"),
                ("identity", "1080p_lossless_identity", J, 8,
                 "resample_rgb_jpeg_batch", "jpg",
                 "lossless identity matrix, RGB to JPEG"),
                ("icc_only", "1080p_icc_only", W, 8, "resample_rgb_yuv_batch",
                 "yuv", "ICC profile, no nclx, RGB"),
                ("premultiplied", "1080p_rgba_premultiplied", W, 8,
                 "resample_bucketed_flat", "flat",
                 "premultiplied alpha, RGBA"),
                ("premultiplied_avif", "1080p_rgba_premultiplied", A, 2,
                 "resample_bucketed_flat", "flat",
                 "premultiplied alpha, RGBA to w=160 AVIF"))
    for entry, name, fmt, batch, fn_name, head, what in captures:
        width = 160 if fmt == A else 400
        with quick_avif_encodes():
            call = capture_batch([sources[name][0]], width, batch, fn_name,
                                 module=engine_rgb, fmt=fmt)
        case = k2_pixels_case(call, head, what)
        k2[entry] = case
        log(f"  K2 vs plain, {what} (B={case['B']}: {case['shape']}): "
            f"max|d|={case['max_abs_err']}; device time per call K2 "
            f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
            f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']}), K2 at {case['bound_ms'] / case['ms']:.1%} "
            f"of it [{card}]")
    steps["K2 batches"] = time.perf_counter() - t0

    def src(name):
        return [sources[name][0]]

    out = (400, 225)
    rounds = [
        ("12 MP grid AVIF (8x6 cells) -> w=400 WebP", src("4032x3024_grid"),
         4, 400, W, (400, 300), {"k2": "batch"}),
        ("1080p 10-bit BT.2020 AVIF -> w=400 WebP", src("1080p_hdr_2020"), 8,
         400, W, out, {"k2": "batch"}),
        ("1080p lossless identity-matrix AVIF -> w=400 JPEG",
         src("1080p_lossless_identity"), 8, 400, J, out, {"k2": "batch"}),
        ("1080p AVIF with an ICC profile and no nclx -> w=400 WebP",
         src("1080p_icc_only"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p premultiplied RGBA AVIF -> w=400 WebP",
         src("1080p_rgba_premultiplied"), 8, 400, W, out,
         {"k2_rgba": "batch"}),
        ("1080p premultiplied RGBA AVIF -> w=160 AVIF, alpha kept",
         src("1080p_rgba_premultiplied"), 2, 160, A, (160, 90),
         {"k2_rgba": "batch"}),
    ]
    # the last remainder: items and cells libavif rescales to their ispe,
    # a grid with an alpha item a cell, two layered streams
    t0 = time.perf_counter()
    rest = remainder_avif_sources()
    steps["remainder sources"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, (data, entry) in rest.items():
        case = remainder_avif_case(data, entry)
        if (case["sha256"], case["mode"]) != (entry["sha256"], entry["mode"]):
            raise RuntimeError(f"the port's decode of {name} is not the "
                               f"reference's array ({case['mode']} "
                               f"{case['sha256']} != {entry['mode']} "
                               f"{entry['sha256']})")
        if case.get("planes_sha256") != entry.get("planes_sha256"):
            raise RuntimeError(f"the port's planes of {name} are not "
                               "libdav1d's")
        decodes[name] = case
        how = ("libdav1d's first picture (the base layer), planes = "
               "libdav1d's" if entry["path"] == "native" else
               "array = Pillow's")
        log(f"    {name} ({entry['recipe']}; {case['bytes'] / 1e3:.1f} kB, "
            f"{case['mode']} {case['shape'][1]}x{case['shape'][0]}): {how} "
            f"(SHA-256 {case['sha256'][:16]}...), decode "
            f"{case['decode_ms']:.2f} ms alone, 8 at once "
            f"{case['decode8_ms']:.2f} ms wall on 8 threads, on the host "
            f"[{card}]")
    steps["remainder decode checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    captures = (("coded_540p", "1080p_coded_540p", W, 8,
                 "resample_rgb_yuv_batch", "yuv",
                 "960x540 stream under a 1080p ispe, scaled, RGB"),
                ("grid_half_cells", "4032x3024_grid_half_cells", W, 8,
                 "resample_rgb_yuv_batch", "yuv",
                 "12 MP grid of half-size cells, scaled, RGB"),
                ("cell_alpha", "1080p_grid_cell_alpha", W, 8,
                 "resample_bucketed_flat", "flat",
                 "grid with an alpha item a cell, RGBA"),
                ("cell_alpha_avif", "1080p_grid_cell_alpha", A, 2,
                 "resample_bucketed_flat", "flat",
                 "grid with an alpha item a cell, RGBA to w=160 AVIF"),
                ("layered_half", "1080p_layered_half_base", W, 8,
                 "resample_rgb_yuv_batch", "yuv",
                 "layered, half-size base: the top layer, RGB"))
    for entry, name, fmt, batch, fn_name, head, what in captures:
        width = 160 if fmt == A else 400
        with quick_avif_encodes():
            call = capture_batch([rest[name][0]], width, batch, fn_name,
                                 module=engine_rgb, fmt=fmt)
        case = k2_pixels_case(call, head, what)
        k2[entry] = case
        log(f"  K2 vs plain, {what} (B={case['B']}: {case['shape']}): "
            f"max|d|={case['max_abs_err']}; device time per call K2 "
            f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
            f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']}), K2 at {case['bound_ms'] / case['ms']:.1%} "
            f"of it [{card}]")
    with quick_avif_encodes():
        call = capture_batch([rest["1080p_layered_full_base"][0]], 400, 8,
                             "resize_yuv420_batch", module=engine_yuv, fmt=W)
    what = "layered, full-size base: the base layer, 4:2:0"
    case = k2_avif_case(call, what)
    k2["layered_full"] = case
    log(f"  K2 vs plain, {what} (B={case['B']}: {case['planes']}): "
        f"max|d|={case['max_abs_err']}; device time per call K2 "
        f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), K2 at {case['bound_ms'] / case['ms']:.1%} "
        f"of it [{card}]")
    steps["remainder K2 batches"] = time.perf_counter() - t0

    def rsrc(name):
        return [rest[name][0]]

    rounds += [
        ("1080p AVIF coded at 960x540 (libavif scales it) -> w=400 WebP",
         rsrc("1080p_coded_540p"), 8, 400, W, out, {"k2": "batch"}),
        ("12 MP grid AVIF of half-size cells -> w=400 WebP",
         rsrc("4032x3024_grid_half_cells"), 8, 400, W, (400, 300),
         {"k2": "batch"}),
        ("1080p grid AVIF with an alpha item a cell -> w=400 WebP",
         rsrc("1080p_grid_cell_alpha"), 8, 400, W, out,
         {"k2_rgba": "batch"}),
        ("1080p grid AVIF with an alpha item a cell -> w=160 AVIF, alpha "
         "kept", rsrc("1080p_grid_cell_alpha"), 2, 160, A, (160, 90),
         {"k2_rgba": "batch"}),
        ("1080p layered AVIF, full-size base (native path) -> w=400 WebP",
         rsrc("1080p_layered_full_base"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p layered AVIF, half-size base (the top layer) -> w=400 WebP",
         rsrc("1080p_layered_half_base"), 8, 400, W, out, {"k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    summary["decodes"] = decodes
    summary["k2"] = k2
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


# ---------------------------------------------------------------------------
# phase 29: AVIFs whose output frame is an INTER frame
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def inter_avif_sources() -> dict:
    """Phase 29's committed AVIFs (``tests/fixtures/make_avif_sources.py
    --inter``: libaom's GOOD usage over a texture in motion, spliced into
    layers), with the path the reference takes for each (``native``:
    libdav1d's first picture; ``pillow``: libavif's highest layer), the
    digest of the array it decodes, of libdav1d's planes of the output
    frame and of its raw samples, taken where they were made, and the
    inter tools the decode uses: name -> (bytes, entry)."""
    with open(os.path.join(AVIF_FIXTURES, "inter_arrays.json")) as f:
        table = json.load(f)
    out = {}
    for name, entry in table.items():
        with open(os.path.join(AVIF_FIXTURES, entry["file"]), "rb") as f:
            out[name] = (f.read(), entry)
    return out


def inter_avif_case(data: bytes, entry: dict) -> dict:
    """The port's decode of one inter file on the host: the array's digest
    (``avif_native.decode_rgb`` on the native path, else
    ``avif_libavif``) and that decode's ms alone; the output frame's
    planes (8-bit and raw samples), frames and tools from the AV1 decoder
    and its ms alone (every frame the output depends on, the base layer
    included); the file's decode 8 at once on 8 threads (the engine's
    codec pool decodes a batch's files so). One of each: a 1080p inter
    file takes about a second on a host of the card (single-tile frames,
    loop restoration)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from imagekit_tpu_torch.codecs import avif_libavif, avif_native
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    native = entry["path"] == "native"
    decode = (avif_native.decode_rgb if native
              else avif_libavif.decode_pillow_rgb)
    t0 = time.perf_counter()
    arr = decode(data)
    decode_ms = (time.perf_counter() - t0) * 1e3
    if arr is None:
        raise RuntimeError("the port's native path declines a file it serves")
    obu = avif_native.parse_container(data).obu
    t0 = time.perf_counter()
    y, u, v, info = av1_dec_abi.decode_samples(
        obu, select=av1_dec_abi.FIRST if native else av1_dec_abi.HIGHEST)
    av1_ms = (time.perf_counter() - t0) * 1e3
    h8, hs = hashlib.sha256(), hashlib.sha256()
    for p in (y, u, v):
        h8.update(np.ascontiguousarray(
            av1_dec_abi.to_8bit(p, info.bitdepth)).tobytes())
        hs.update(np.ascontiguousarray(p).astype(
            "<u2" if info.bitdepth > 8 else np.uint8).tobytes())
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode, [data] * 8))
        decode8_ms = (time.perf_counter() - t0) * 1e3
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "mode": "RGBA" if arr.shape[2] == 4 else "RGB",
            "shape": arr.shape, "bytes": len(data),
            "planes_sha256": h8.hexdigest(), "samples_sha256": hs.hexdigest(),
            "frames": info.frames, "decoded": info.decoded,
            "tools": {k: n for k, n in info.tools.items() if n},
            "decode_ms": decode_ms, "decode8_ms": decode8_ms,
            "av1_ms": av1_ms}


def phase_inter_avifs(card: str) -> dict:
    """AVIFs whose output frame is an INTER frame (``inter_arrays.json``):
    a progressive 8-bit 4:2:0 file and a 10-bit 4:4:4 one, each a half-size
    base key frame under a 1920x1080 INTER frame predicted across sizes
    (libavif's highest layer, the Pillow path), a three-layer file whose
    top frame uses compound prediction (no colr box: the Pillow path) and
    a hidden key frame under the INTER frame libdav1d returns first (the
    native path). Each decodes on the host through the port's AV1 decoder
    (every frame the output depends on, inter prediction included): its
    array, its output frame's planes and raw samples against the digests
    taken where the files were made, its tools as recorded, decoded alone
    and 8 at once. K2 against its plain version at each file's batch (the
    RGB head of the Pillow path, to WebP and to JPEG, and the YUV head of
    the native one). Then rounds through one engine: each file -> w=400
    WebP (8 a round), one -> w=400 JPEG (8), one -> w=160 AVIF (2); counts
    reset before each, each run once, traced: the decode on the codec pool,
    ONE K2 launch a batch, the encode."""
    from imagekit_tpu_torch.config import ImageFormat
    from imagekit_tpu_torch.serving import engine_rgb, engine_yuv

    W, J, A = ImageFormat.webp, ImageFormat.jpeg, ImageFormat.avif
    t0 = time.perf_counter()
    sources = inter_avif_sources()
    steps = {"sources": time.perf_counter() - t0}

    t0 = time.perf_counter()
    decodes = {}
    for name, (data, entry) in sources.items():
        case = inter_avif_case(data, entry)
        for key in ("sha256", "mode", "planes_sha256", "samples_sha256",
                    "frames", "decoded", "tools"):
            if case[key] != entry[key]:
                raise RuntimeError(f"the port's decode of {name} differs from "
                                   f"the recorded {key} ({case[key]} != "
                                   f"{entry[key]})")
        decodes[name] = case
        how = ("libdav1d's first picture" if entry["path"] == "native"
               else "libavif's highest layer")
        log(f"    {name} ({entry['recipe']}; {case['bytes'] / 1e3:.1f} kB, "
            f"{case['mode']} {case['shape'][1]}x{case['shape'][0]}, "
            f"{entry['bitdepth']}-bit): {how}, array = the reference's "
            f"(SHA-256 {case['sha256'][:16]}...), planes and raw samples = "
            f"libdav1d's, {case['decoded']} of {case['frames']} frames "
            f"decoded, tools {case['tools']}; decode {case['decode_ms']:.2f} "
            f"ms alone, 8 at once {case['decode8_ms']:.2f} ms wall on 8 "
            f"threads; the AV1 decode {case['av1_ms']:.2f} ms alone, on the "
            f"host [{card}]")
    steps["decode checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    k2 = {}
    # the Pillow path's files share the RGB head's 1080p batch shape: one
    # of them to WebP and to JPEG
    captures = (("progressive", "1080p_inter_progressive", W,
                 "resample_rgb_yuv_batch", "yuv",
                 "progressive inter top layer, RGB"),
                ("progressive_jpeg", "1080p_inter_progressive", J,
                 "resample_rgb_jpeg_batch", "jpg",
                 "progressive inter top layer, RGB to JPEG"))
    for entry, name, fmt, fn_name, head, what in captures:
        with quick_avif_encodes():
            call = capture_batch([sources[name][0]], 400, 8, fn_name,
                                 module=engine_rgb, fmt=fmt)
        case = k2_pixels_case(call, head, what)
        k2[entry] = case
        log(f"  K2 vs plain, {what} (B={case['B']}: {case['shape']}): "
            f"max|d|={case['max_abs_err']}; device time per call K2 "
            f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
            f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']}), K2 at {case['bound_ms'] / case['ms']:.1%} "
            f"of it [{card}]")
    with quick_avif_encodes():
        call = capture_batch([sources["1080p_inter_hidden_key"][0]], 400, 8,
                             "resize_yuv420_batch", module=engine_yuv, fmt=W)
    what = "hidden key frame's INTER frame (native path), 4:2:0"
    case = k2_avif_case(call, what)
    k2["hidden_key"] = case
    log(f"  K2 vs plain, {what} (B={case['B']}: {case['planes']}): "
        f"max|d|={case['max_abs_err']}; device time per call K2 "
        f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms vs einsum "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), K2 at {case['bound_ms'] / case['ms']:.1%} "
        f"of it [{card}]")
    steps["K2 batches"] = time.perf_counter() - t0

    def src(name):
        return [sources[name][0]]

    out = (400, 225)
    rounds = [
        ("1080p progressive AVIF, INTER top layer -> w=400 WebP",
         src("1080p_inter_progressive"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p 10-bit 4:4:4 progressive AVIF, INTER top layer -> w=400 "
         "WebP", src("1080p_inter_10bit_444_progressive"), 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p three-layer AVIF, compound INTER top layer -> w=400 WebP",
         src("1080p_inter_compound_3layer"), 8, 400, W, out, {"k2": "batch"}),
        ("1080p AVIF, hidden key then INTER frame (native path) -> w=400 "
         "WebP", src("1080p_inter_hidden_key"), 8, 400, W, out,
         {"k2": "batch"}),
        ("1080p progressive AVIF, INTER top layer -> w=400 JPEG",
         src("1080p_inter_progressive"), 8, 400, J, out, {"k2": "batch"}),
        ("1080p progressive AVIF, INTER top layer -> w=160 AVIF",
         src("1080p_inter_progressive"), 2, 160, A, (160, 90),
         {"k2": "batch"}),
    ]
    summary = drive_rounds(rounds, card, steps)
    summary["decodes"] = decodes
    summary["k2"] = k2
    log("    seconds a step (a round's include its warm-up and trace): "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    summary["step_s"] = steps
    return summary


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
    # nvcc on a thread, the host codecs' g++ on another (the two builds
    # share nothing); once the codecs are built, the sources of every phase
    # are made here while nvcc runs (they need the host codecs, not the
    # kernels)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        build = pool.submit(timed, _build.load)
        codecs_name, codecs_s = pool.submit(timed, native_codecs).result()
        made, t1 = {}, time.perf_counter()
        jpegs = [make_jpeg(seed, 80) for seed in range(16)]
        jpegs_hq = [make_jpeg(100 + seed, 95) for seed in range(2)]
        dense = [make_jpeg(200 + seed, 100, dense_image) for seed in range(4)]
        made["jpegs"], t1 = time.perf_counter() - t1, time.perf_counter()
        images = [synth_image(seed) for seed in range(16)]
        pngs = [make_png(img) for img in images]
        made["pngs"], t1 = time.perf_counter() - t1, time.perf_counter()
        webps = [make_webp(img, 80) for img in images[:8]]
        made["webps"], t1 = time.perf_counter() - t1, time.perf_counter()
        # the later phases' own sources (memoized; each phase logs its
        # step "sources" as the time to fetch them)
        for make in (make_pillow_sources, make_dds_textures,
                     make_arith_lossless, make_remainder_sources,
                     make_lab_ycbcr_sources):
            make()
        make_jpeg_layouts(jpeg_writer())
        made["later"] = time.perf_counter() - t1
        _, nvcc_s = build.result()
    begin(f"[2] K1, K2 (1, 3 and 4 channels), K3 and K4 built by nvcc in "
          f"{nvcc_s:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "bytes stack" in line or "smem" in line:
            log("    ptxas: " + line.strip())
    log(f"    host codecs: {codecs_name} ({codecs_s:.2f} s, g++ beside nvcc;"
        f" both built, and the sources below made, in "
        f"{time.perf_counter() - t0:.2f} s)")
    log(f"    made while nvcc ran: {len(jpegs)} q80, {len(jpegs_hq)} q95 and "
        f"{len(dense)} escape-dense q100 1920x1080 JPEGs in "
        f"{made['jpegs']:.2f} s; {len(pngs)} 1920x1080 RGB PNGs (zlib level "
        f"1, {sum(map(len, pngs)) / len(pngs) / 1e6:.2f} MB each) in "
        f"{made['pngs']:.2f} s; {len(webps)} 1920x1080 lossy WebPs with the "
        f"port's VP8 encoder ({sum(map(len, webps)) / len(webps) / 1e3:.0f} "
        f"kB each) in {made['webps']:.2f} s; the sources of phases 19 and "
        f"23-26 in {made['later']:.2f} s")

    begin("[3] K1 against its plain PyTorch version on the card")
    kern = phase_kernel(jpegs, jpegs_hq)

    begin("[4] K2 against its plain PyTorch version on the card")
    k2 = phase_k2(images)

    begin("[5] K3 and K4 against their plain PyTorch versions on the card")
    k3 = phase_k3(images)

    begin("[6] JPEG engine slice: BatchedEngine(device='cuda').transform, "
          "1920x1080 JPEG -> w=400 WebP q80")
    eng = phase_engine(jpegs, card)

    begin("[7] PNG engine slice: BatchedEngine(device='cuda').transform, "
          "1920x1080 RGB PNG -> w=400 WebP q80 and JPEG q80")
    png_eng = phase_png_engine(pngs, card)

    begin("[8] JPEG -> JPEG engine slice: BatchedEngine(device='cuda')"
          ".transform, 1920x1080 JPEG -> JPEG q80")
    jxc = phase_jxc_engine(jpegs, dense, card)

    begin("[9] K1's int16 entry against its plain PyTorch version on the "
          "card")
    k1_i16 = phase_k1_i16(dense)

    begin("[10] K4 on u8 planes (u8 in, f32 out) against its plain PyTorch "
          "version on the card")
    k4_u8 = phase_k4_u8(jpegs)

    begin("[11] K2 on the three planes of a YUV-source batch against its "
          "plain PyTorch version on the card")
    k2_yuv = phase_k2_yuv(webps)

    begin("[12] JPEG -> WebP at k=8 and from escape-dense sources, lossy WebP "
          "-> WebP / JPEG: BatchedEngine(device='cuda').transform")
    paths = phase_new_paths(jpegs, dense, webps, card)

    t0 = time.perf_counter()
    rgba_images = [with_alpha(img, i) for i, img in enumerate(images[:8])]
    rgba_pngs = [make_png(img) for img in rgba_images]
    others = [make(img) for make in (make_bmp, make_tiff, make_gif)
              for img in images[:4]]
    log(f"    made {len(rgba_pngs)} 1920x1080 RGBA PNGs "
        f"({sum(map(len, rgba_pngs)) / len(rgba_pngs) / 1e6:.2f} MB each), 4 "
        f"BMPs, 4 uncompressed TIFFs and 4 GIFs in "
        f"{time.perf_counter() - t0:.2f} s")

    begin("[13] K2's four-channel entry against its plain PyTorch version on "
          "the card")
    k2_rgba = phase_k2_rgba(rgba_images)

    begin("[14] sources with alpha, BMP / TIFF / GIF sources and requests "
          "with no resize: BatchedEngine(device='cuda').transform")
    alpha = phase_alpha_and_single(rgba_pngs, others, jpegs, pngs, webps,
                                   card)

    begin("[15] AVIF output through every head: BatchedEngine(device='cuda')"
          ".transform, the first-party AV1 encoder on the host")
    avif = phase_avif(jpegs, dense, pngs, webps, rgba_pngs, card)
    phase_avif_mixed(jpegs, card)

    begin("[16] images beyond the bucket ladder: K2's column strips, then "
          "BatchedEngine(device='cuda').transform at exact shapes")
    over = phase_oversized(images, rgba_images, jpegs[0], k2, k2_rgba, card)

    t0 = time.perf_counter()
    layout_jpegs = {name: [make_jpeg(300 + seed, 80, samp=samp)
                           for seed in range(4)]
                    for name, (samp, _) in LAYOUTS.items()}
    gray_jpegs = [make_jpeg(400 + seed, 80, gray=True) for seed in range(2)]
    log(f"    made 4 q80 1920x1080 JPEGs in each of "
        f"{', '.join(LAYOUTS)} and 2 grayscale ones in "
        f"{time.perf_counter() - t0:.2f} s")
    begin("[17] JPEG sources in every chroma layout: the JPEG pixel decode "
          "(K3) and the RGB head (K2), BatchedEngine(device='cuda').transform")
    layouts = phase_jpeg_layouts(layout_jpegs, gray_jpegs, jpegs,
                                 [synth_image(300)], card)

    begin("[18] HTTP")
    log("    " + phase_http(jpegs, pngs[0], webps[0], rgba_pngs[0],
                            over["page"], layout_jpegs["4:4:4"][0]))

    begin("[19] the sources the reference decodes with Pillow: ICO, P6, QOI, "
          "DDS, CMYK and YCCK JPEGs, BatchedEngine(device='cuda').transform")
    pillow = phase_pillow_sources(card)

    begin("[20] the BMP, TIFF and progressive CMYK sources the reference "
          "still hands to Pillow: G4 and 1-bit A4 pages, CMYK TIFFs, bit-field"
          " and core-header BMPs, progressive CMYK and YCCK JPEGs, "
          "BatchedEngine(device='cuda').transform")
    fallbacks = phase_pillow_fallbacks(card)

    begin("[21] JPEG-compressed TIFFs: strips and tiles entropy-decoded on "
          "the host, one K3 pixel decode a page, the RGB head on K2, "
          "BatchedEngine(device='cuda').transform")
    tiffj = phase_tiff_jpeg(card)

    begin("[22] the TIFF layouts the reference still decoded with Pillow: "
          "old-style, planar and extra-sample JPEG pages (K3), 16-bit CMYK, "
          "a float32 raster and a FillOrder 2 G4 page, the RGB head on K2, "
          "BatchedEngine(device='cuda').transform")
    remainder = phase_tiff_remainder(card)

    begin("[23] the DDS and JPEG layouts the reference still decoded with "
          "Pillow: BC4, signed BC5, BC6H, BC7, R8G8B8A8 and palette DDS (K2),"
          " 4:1:1, mixed-chroma and one-scan-a-component JPEGs (K3, then K2),"
          " BatchedEngine(device='cuda').transform")
    layouts23 = phase_dds_jpeg_layouts(card)

    begin("[24] arithmetic-coded and lossless JPEGs: the QM and lossless "
          "decoders on the host, the pixel decode (K3), the RGB head (K2), "
          "BatchedEngine(device='cuda').transform")
    arith = phase_arith_lossless(card)

    begin("[25] CMYK JPEGs in every sampling, lossless CMYK, arithmetic and "
          "planar JPEG TIFF pages and a G4 page flagging uncompressed mode: "
          "the pixel decode (K3), the RGB head (K2), "
          "BatchedEngine(device='cuda').transform")
    remainder25 = phase_cmyk_tiff_remainder(card)

    begin("[26] CIELab, YCbCr without JPEG, planar 16-bit CMYK and "
          "Orientation 6 TIFFs and the gray 4 bpp BMP: the colour steps and "
          "the YCbCr chroma (K3), the RGB head (K2), "
          "BatchedEngine(device='cuda').transform")
    lab26 = phase_lab_ycbcr(card)

    begin("[27] AVIF sources: the port's AV1 decoder on the host (planes "
          "against libdav1d's digests; palette blocks, intra block copy, "
          "10- and 12-bit streams, quantizer matrices, film grain, "
          "superres), K2's "
          "YUV entries for 4:4:4, 4:2:2, alpha and BT.709 batches and each "
          "file's batch, BatchedEngine(device='cuda').transform")
    avif27 = phase_avif_sources(card)

    begin("[28] the AVIFs the reference hands to Pillow: a 12 MP grid, "
          "10-bit BT.2020, a lossless identity-matrix file, an ICC profile "
          "with no nclx, premultiplied alpha; items and grid cells libavif "
          "rescales, a grid with an alpha item a cell, layered streams; "
          "libavif's container, scaler and YUV -> RGB on the host (arrays "
          "against Pillow's digests), the RGB and YUV heads (K2), "
          "BatchedEngine(device='cuda').transform")
    avif28 = phase_pillow_avifs(card)

    begin("[29] AVIFs whose output frame is an INTER frame: progressive "
          "files (a half-size base under a 1080p INTER frame, 8-bit 4:2:0 "
          "and 10-bit 4:4:4), three layers with compound prediction, a "
          "hidden key frame under an INTER frame; the port's AV1 inter "
          "prediction on the host (planes and raw samples against "
          "libdav1d's digests), the RGB and YUV heads (K2), "
          "BatchedEngine(device='cuda').transform")
    inter29 = phase_inter_avifs(card)
    end_phase()
    log("    seconds a phase (heading to heading): " + ", ".join(
        f"[{k}] {v:.2f}" for k, v in PHASE_S.items()))
    log(f"    total {time.perf_counter() - t_start:.2f} s")

    avif_n = {head: r["launches"] for head, r in avif.items()}
    kernels = [{
        "name": "jpeg8_folded_planes (K1)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/jpeg8_folded.cu",
        "replaces": "imagekit_tpu/ops/pallas_jpeg8.py:159",
        "launches": eng["launches"],
        "avif_launches": avif_n["decode_resize_yuv_lowfreq_i8_batch"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
    }, {
        "name": "rgb_resize (K2, 3 channels in one launch)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_strip.cu",
        "replaces": "imagekit_tpu/ops/pallas_resize.py:155",
        "launches": png_eng["launches"],
        "avif_launches": avif_n["resample_rgb_yuv_batch"],
        "pillow_source_launches": pillow["k2_launches"],
        "pillow_fallback_launches": fallbacks["k2_launches"],
        "tiff_jpeg_launches": tiffj["k2_launches"],
        "tiff_remainder_launches": remainder["k2_launches"],
        "dds_jpeg_layout_launches": layouts23["k2_launches"],
        "arith_lossless_launches": arith["k2_launches"],
        "cmyk_tiff_remainder_launches": remainder25["k2_launches"],
        "lab_ycbcr_launches": lab26["k2_launches"],
        "pillow_avif_launches": avif28["k2_launches"],
        # phase 28's RGB-head batches: the 12 MP grid's 3424x4352 bucket
        # (B=4) and the 1080p files' (B=8)
        **{f"pillow_avif_{entry}": {key: avif28["k2"][entry][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for entry in ("grid", "hdr_2020", "identity",
                                         "icc_only", "coded_540p",
                                         "grid_half_cells", "layered_half")},
        # phase 29's (both heads' launches) and its RGB-head batches of
        # INTER top layers (B=8)
        "inter_avif_launches": inter29["k2_launches"],
        **{f"inter_avif_{entry}": {key: inter29["k2"][entry][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for entry in ("progressive", "progressive_jpeg")},
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "resize_planes3 (K3, Y + Cb + Cr in one launch)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_planes.cu",
        "replaces": "imagekit_tpu/ops/pallas/resize_kernel.py:157",
        "launches": jxc["k3_launches"],
        "avif_launches": avif_n["decode_resize_rgb_batch"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        # the JPEG pixel decode beyond 4:2:0 (phase 17): launches on its
        # rounds, and K3 at its two new geometries (B=1)
        "layout_launches": layouts["k3_launches"],
        **{f"pixel_decode_{name[0]}{name[2]}{name[4]}": {
            key: layouts[name][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for name in ("4:4:4", "4:2:2")},
        # the four-component pixel decode (phase 19): two launches a CMYK
        # or YCCK request, and K3 at its planes (both launches timed)
        "cmyk_launches": pillow["k3_launches"],
        "pixel_decode_cmyk": {key: pillow["k3_cmyk"][key] for key in (
            "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        # the progressive four-component decode (phase 20): two launches a
        # progressive CMYK or YCCK request, and K3 at its planes
        "progressive_cmyk_launches": fallbacks["k3_launches"],
        "pixel_decode_progressive_cmyk": {
            key: fallbacks["k3_progressive"][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
        # JPEG-compressed TIFFs (phase 21): one launch a page (two for
        # CMYK), and K3 at a strip page's block-diagonal stacks
        "tiff_jpeg_launches": tiffj["k3_launches"],
        "pixel_decode_tiff_jpeg_page": {
            key: tiffj["k3_page"][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
        # the TIFF layouts of phase 22: one launch an old-style or planar
        # page, two an RGB page with an extra sample, and K3 at the
        # old-style page's replication stacks
        "tiff_remainder_launches": remainder["k3_launches"],
        "pixel_decode_old_style_page": {
            key: remainder["k3_page"][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
        # the JPEG layouts of phase 23: one launch a request, and K3 at the
        # 4:1:1 page's identity and replication stacks
        "jpeg_layout_launches": layouts23["k3_launches"],
        "pixel_decode_411_page": {
            key: layouts23["k3_page"][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
        # the arithmetic and lossless JPEGs of phase 24: one launch a
        # request (two for CMYK, none for lossless gray), and K3 at the
        # lossless RGB page's replication stacks
        "arith_lossless_launches": arith["k3_launches"],
        "pixel_decode_lossless_page": {
            key: arith["k3_page"][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
        # phase 25: two launches a CMYK JPEG request and a lossless CMYK one
        # sampled differently, none sampled alike, one an arithmetic TIFF
        # page, one a strip of the planar page; K3 at the 4:1:1-like CMYK
        # planes and at the lossless CMYK page's replication stacks
        "cmyk_tiff_remainder_launches": remainder25["k3_launches"],
        **{f"pixel_decode_{key[3:]}": {
            k: remainder25[key][k] for k in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
           for key in ("k3_cmyk_411", "k3_lossless_cmyk")},
        # phase 26: one launch a YCbCr page and an Orientation 6 JPEG TIFF
        # page, and K3 at the YCbCr page's replication stacks
        "lab_ycbcr_launches": lab26["k3_launches"],
        "pixel_decode_ycbcr_page": {
            key: lab26["k3_ycbcr"][key] for key in (
                "max_abs_err", "share_differ", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
    }, {
        "name": "resize_planes3_f32 (K4, Y + Cb + Cr in one launch; u8 planes "
                "in, f32 out on the k=8 JPEG -> WebP heads)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_planes.cu",
        "replaces": "imagekit_tpu/ops/pallas/resize_kernel.py:235",
        "launches": (paths["decode_resize_yuv_i8_batch"]["launches"]
                     + paths["decode_resize_yuv_batch"]["launches"]),
        "avif_launches": avif_n["decode_resize_yuv_i8_batch"],
        "max_abs_err": max(k4_u8["max_abs_err"], k3["max_abs_err_f32"]),
        **{key: k4_u8[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        # the f32-in instantiation, which no engine path takes, at the
        # demoted head's shapes (phase 5)
        "f32_in": {"max_abs_err": k3["max_abs_err_f32"], "ms": k3["ms_f32"],
                   "plain_ms": k3["plain_ms_f32"],
                   "bound_ms": k3["bound_ms_f32"],
                   "bound_by": k3["bound_by_f32"],
                   "library_ms": k3["library_ms_f32"]},
    }, {
        "name": "folded_planes_i16 (K1, int16 entry: escape-dense JPEG -> "
                "WebP at k<8)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/jpeg8_folded.cu",
        "replaces": "imagekit_tpu/ops/pallas_jpeg8.py:159",
        "launches": paths["decode_resize_yuv_lowfreq_batch"]["launches"],
        "avif_launches": avif_n["decode_resize_yuv_lowfreq_batch"],
        **{key: k1_i16[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "yuv_resize (K2, Y + Cb + Cr of a YUV-source batch in one "
                "launch, per-plane epilogue)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_strip.cu",
        "replaces": "imagekit_tpu/ops/pallas_resize.py:155",
        "launches": (paths["resize_yuv420_batch"]["launches"]
                     + paths["resize_yuv_jpeg_batch"]["launches"]),
        "avif_launches": avif_n["resize_yuv420_batch"],
        **{key: k2_yuv[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")},
        # phase 27's AVIF batches at B=8: 4:2:0 (screen content, 10-bit,
        # quantizer matrices, film grain, superres with restoration and with
        # grain), the 10-bit 4:4:4 one with QM and grain and the 10-bit
        # 4:4:4 superres one
        **{f"avif_{entry}_b8": {key: avif27["k2"][entry][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for entry in ("screenshot", "logos", "10bit", "qm",
                                         "grain", "10bit_grain_444",
                                         "superres", "superres_444",
                                         "superres_grain")},
        # phase 28's layered file with a full-size base (the native path)
        "avif_layered_full_b8": {key: avif28["k2"]["layered_full"][key]
                                 for key in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")},
        # phase 29's native-path INTER frame (a hidden key frame's)
        "avif_inter_hidden_key_b8": {key: inter29["k2"]["hidden_key"][key]
                                     for key in ("max_abs_err", "ms",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")},
    }, {
        "name": "rgba_resize (K2, 4 channels in one launch, interleaved out: "
                "the plain RGB head of sources with alpha)",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_strip.cu",
        "replaces": "imagekit_tpu/ops/pallas_resize.py:155",
        "launches": alpha["rgba_launches"],
        "avif_launches": avif_n["resample_bucketed_flat"],
        "pillow_source_launches": pillow["k2_rgba_launches"],
        "pillow_fallback_launches": fallbacks["k2_rgba_launches"],
        "dds_launches": layouts23["k2_rgba_launches"],
        "pillow_avif_launches": avif28["k2_rgba_launches"],
        **{f"pillow_avif_{entry}": {key: avif28["k2"][entry][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for entry in ("premultiplied",
                                         "premultiplied_avif", "cell_alpha",
                                         "cell_alpha_avif")},
        **{key: k2_rgba[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "rgb_resize / rgba_resize in column strips (K2's body on rows "
                "too wide for a tile of whole rows: images beyond the bucket "
                "ladder, RGBA at the 8192 bucket); numbers of the 9600x2400 "
                "RGB rows -> 1280x320",
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_strip.cu",
        "replaces": "imagekit_tpu/ops/pallas_resize.py:155",
        "launches": over["strip_launches"],
        "max_abs_err": over["max_abs_err"],
        **{key: over["wide_rgb"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "rgba_8192_bucket": {key: over["rgba_8192"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "flagship_strips_of_128": {
            f"{ch}ch": {key: over[f"flagship_{ch}ch"][key] for key in (
                "ms", "bound_ms", "library_ms")} for ch in (3, 4)},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "imagekit_tpu_torch/csrc/resize_strip.cu",
        "replaces": "imagekit_tpu/ops/pallas_resize.py:155",
        "launches": avif27["yuv_launches"].get(entry, 0),
        **{key: avif27["k2"][entry][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for entry, name in (
        ("444", "yuv_resize, 4:4:4 (K2, Y + full-size Cb + Cr of an AVIF "
                "batch in one launch)"),
        ("422", "yuv_resize, 4:2:2 (K2, Y + half-width Cb + Cr of an AVIF "
                "batch in one launch)"),
        ("420+a", "yuv_resize, four planes (K2, Y + Cb + Cr + alpha of an "
                  "AVIF batch in one launch)"),
        ("420+mix", "yuv_mix_resize (K2's f32 entry: Y, Cb and Cr to the "
                    "half and the full grid of a BT.709 AVIF batch, six "
                    "resizes in one launch)"))]
    # K3 also ran once per JPEG request with no resize (the pixel decode)
    if alpha["pixel_decode_launches"] <= 0:
        raise RuntimeError("no JPEG pixel decode launched K3")
    idle = [k["name"] for k in kernels
            if k["launches"] <= 0 or k.get("avif_launches", 1) <= 0]
    if idle:
        raise RuntimeError(
            f"no engine path (or no AVIF round) launched {idle}")
    if over["launches"] <= 0:
        raise RuntimeError("no path beyond the bucket ladder launched K2")
    if layouts["k3_launches"] <= 0:
        raise RuntimeError("no JPEG layout round launched K3")
    if min(pillow[f"{k}_launches"] for k in ("k2", "k2_rgba", "k3")) <= 0:
        raise RuntimeError("a Pillow-source round launched no K2 or K3")
    if min(fallbacks[f"{k}_launches"] for k in ("k2", "k2_rgba", "k3")) <= 0:
        raise RuntimeError("a BMP, TIFF or progressive CMYK round launched "
                           "no K2 or K3")
    if min(tiffj[f"{k}_launches"] for k in ("k2", "k3")) <= 0:
        raise RuntimeError("a JPEG TIFF round launched no K2 or K3")
    if min(remainder[f"{k}_launches"] for k in ("k2", "k3")) <= 0:
        raise RuntimeError("a round of phase 22 launched no K2 or K3")
    if min(layouts23[f"{k}_launches"] for k in ("k2", "k2_rgba", "k3")) <= 0:
        raise RuntimeError("a round of phase 23 launched no K2 or K3")
    if min(arith[f"{k}_launches"] for k in ("k2", "k3")) <= 0:
        raise RuntimeError("a round of phase 24 launched no K2 or K3")
    if min(remainder25[f"{k}_launches"] for k in ("k2", "k3")) <= 0:
        raise RuntimeError("a round of phase 25 launched no K2 or K3")
    if min(lab26[f"{k}_launches"] for k in ("k2", "k3")) <= 0:
        raise RuntimeError("a round of phase 26 launched no K2 or K3")
    if min(avif28[f"{k}_launches"] for k in ("k2", "k2_rgba")) <= 0:
        raise RuntimeError("a round of phase 28 launched no K2")
    if inter29["k2_launches"] <= 0:
        raise RuntimeError("a round of phase 29 launched no K2")
    log(card)
    log(json.dumps({"kernels": kernels}))
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
