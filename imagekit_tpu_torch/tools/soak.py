"""Chaos soak of a live server of the port: ``POST /upload`` and ``GET /img``.

The port of the reference's ``tools/soak.py``. Its corpus is the
reference's source classes, written here without Pillow
(:mod:`imagekit_tpu_torch.tools.sources`) at the reference's odd sizes,
and its hostile classes as the reference makes them (empty, garbage, a
JPEG cut at a third, one with 24 bytes overwritten, an EXR header). A
class no writer here produces is printed as skipped, as the reference
skips what Pillow cannot write; ``--fixtures`` adds committed files (such
as ``tests/fixtures/avif/1080p_444.avif``) as classes of their own.

Each request is drawn before any is sent, from a seeded generator, so a
plan is the same on every run and can be sent to two servers:

- ``/upload`` (:func:`run`): the reference's mix of ``w`` (none, 1, 17,
  100, 301, 640, 1200), ``h`` (none, 51, 150), ``f`` (webp, jpeg, avif,
  none, an unknown name) and ``q`` (none, 0, 1, 50, 85, 101, 255);
- ``/img`` (:func:`run_img`): ``/sign`` then ``/img`` of a source served
  by a local origin, ``w`` 64/100/150 to WebP or JPEG, with tampered
  signatures (401) and expired ones (410); a share of the 200s fetched
  again (a cache hit, 200) and revalidated with their ETag (304).

Status rules, the reference's: a decodable source answers 200, or 429
with a ``Retry-After`` of at least 1; an undecodable one 400; a corrupt one
200 or 400; never a 5xx and never 501. A seeded fifth of the 200 bodies is
decoded by the port's own decoders (``codecs.decode_bytes`` on the CPU)
and its format and dimensions checked against the request
(``ops.weights.target_dimensions``).

    IMAGEKIT_SECRET=s DISABLE_RATE_LIMIT=1 \\
        python -m imagekit_tpu_torch.serving --port 18099 [--device cpu] &
    python -m imagekit_tpu_torch.tools.soak --base http://127.0.0.1:18099 \\
        --n 3000 [--img] [--fixtures tests/fixtures/avif]

Per-class status counts, the rate and p50/p99 latency are printed on the
lines before the last, which is a JSON summary. Exit 0 = clean; any miss
= 1.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

#: the reference's upload mix (``tools/soak.py:146-158``)
UPLOAD_W = [None, 1, 17, 100, 301, 640, 1200]
UPLOAD_H = [None, None, 51, 150]
UPLOAD_F = ["webp", "jpeg", "avif", "", "bogus"]
UPLOAD_Q = [None, 0, 1, 50, 85, 101, 255]
#: the reference's /img mix (``tools/soak.py:273-282``)
IMG_MODES = ["ok", "ok", "ok", "tamper", "expired"]
IMG_W = [64, 100, 150]
IMG_F = ["webp", "jpeg"]
#: the share of 200 bodies decoded and sized
CHECK_SHARE = 0.2
#: seconds a request may take, as the reference's soak allows them
UPLOAD_TIMEOUT_S, IMG_TIMEOUT_S = 120.0, 150.0
#: the classes of the reference's corpus no writer here produces
NO_WRITER = ("jpeg_prog", "avif_444", "avif_422")
_FIXTURE_SUFFIXES = {".avif", ".jpg", ".jpeg", ".png", ".webp", ".gif",
                     ".bmp", ".tif", ".tiff", ".ico", ".qoi", ".dds", ".ppm",
                     ".pgm", ".pnm", ".hdr", ".ff"}


@dataclass
class Source:
    name: str
    data: bytes
    #: True: must decode (200); False: must not (400); None: either
    decodable: Optional[bool]
    #: (width, height) of a decodable source
    dims: Optional[Tuple[int, int]] = None


@dataclass
class Request:
    index: int
    source: Source
    fields: Dict[str, str]
    #: the output format the server must answer in a 200
    fmt: str
    check_body: bool
    #: /img only: "ok", "tamper" or "expired"; and whether to re-fetch
    mode: str = "ok"
    revalidate: bool = False


@dataclass
class Report:
    kind: str
    #: (request, status, seconds) in plan order (a request lost to a
    #: transport error has none, and a miss)
    results: List[Tuple[Request, int, float]] = field(default_factory=list)
    misses: List[str] = field(default_factory=list)
    checked: int = 0
    shed: int = 0
    revalidated: int = 0
    seconds: float = 0.0

    def statuses(self) -> List[int]:
        return [st for _, st, _ in self.results]

    def by_class(self) -> Dict[str, Dict[int, int]]:
        out: Dict[str, Dict[int, int]] = {}
        for req, st, _ in self.results:
            row = out.setdefault(req.source.name, {})
            row[st] = row.get(st, 0) + 1
        return out

    def summary(self) -> dict:
        lat = [s for _, _, s in self.results]
        n = len(self.results)
        return {
            "kind": self.kind, "requests": n, "misses": len(self.misses),
            "statuses": dict(sorted(
                (str(k), v) for k, v in _counts(self.statuses()).items())),
            "bodies_decoded": self.checked, "shed": self.shed,
            "revalidated": self.revalidated,
            "req_s": n / self.seconds if self.seconds else 0.0,
            "p50_ms": 1e3 * _quantile(lat, 0.50),
            "p99_ms": 1e3 * _quantile(lat, 0.99),
        }

    def lines(self) -> List[str]:
        out = [f"  {name}: " + ", ".join(f"{st} x{c}" for st, c in
                                         sorted(row.items()))
               for name, row in sorted(self.by_class().items())]
        s = self.summary()
        out.append(
            f"{self.kind} soak: {s['requests']} requests in "
            f"{self.seconds:.2f} s ({s['req_s']:.2f} req/s), p50 "
            f"{s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, statuses "
            f"{s['statuses']}, {self.checked} bodies decoded, "
            f"{self.revalidated} hit+304 checks, {self.shed} shed (429), "
            f"{len(self.misses)} misses")
        return out + [f"MISS {m}" for m in self.misses]


def _counts(values) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for v in values:
        out[v] = out.get(v, 0) + 1
    return out


def _quantile(values: List[float], q: float) -> float:
    return float(np.percentile(values, 100 * q)) if values else 0.0


# -- the corpus ---------------------------------------------------------------


def make_sources(fixtures=()):
    """The corpus: ([:class:`Source`], [skipped class names]), the
    reference's classes in its order (``tools/soak.py:30-135``), then the
    fixture files, then the hostile classes."""
    from imagekit_tpu_torch.codecs import avif_encode
    from imagekit_tpu_torch.tools import sources as S

    rng = np.random.default_rng(99)  # the reference's

    def img(w, h, gray=False):
        return S.soak_image(rng, w, h, gray)

    out: List[Source] = []

    def add(name, data, w, h):
        out.append(Source(name, data, True, (w, h)))

    add("jpeg_base", S.make_jpeg(0, 85, image=lambda _: img(321, 243)),
        321, 243)
    gray = img(203, 149, gray=True)
    add("jpeg_gray", S.make_jpeg(0, 75, image=lambda _: np.dstack([gray] * 3),
                                 gray=True), 203, 149)
    add("png_rgb", S.make_png(img(199, 151)), 199, 151)
    add("png_rgba", S.make_png(np.dstack(
        [img(97, 73), np.full((73, 97), 200, np.uint8)])), 97, 73)
    add("png_pal", S.make_png_palette(img(101, 67)), 101, 67)
    add("gif", S.make_gif(img(83, 59)), 83, 59)
    add("bmp", S.make_bmp(img(111, 77)), 111, 77)
    add("tiff", S.make_tiff(img(93, 65)), 93, 65)
    add("webp_lossy", S.make_webp(img(151, 103), 80), 151, 103)
    add("webp_ll", S.make_webp_lossless(img(75, 49)), 75, 49)
    add("avif", avif_encode.encode_rgb(img(105, 71), 75), 105, 71)
    add("avif_alpha", avif_encode.encode_rgb(np.dstack(
        [img(98, 66), np.full((66, 98), 120, np.uint8)]), 75), 98, 66)
    add("avif_mono", avif_encode.encode_y400_studio(img(95, 69, gray=True),
                                                    75), 95, 69)
    add("ico", S.make_ico(None, np.dstack(
        [img(63, 45), np.full((45, 63), 255, np.uint8)]), with_big=False),
        63, 45)
    add("qoi", S.make_qoi(np.dstack(
        [img(63, 45), np.full((45, 63), 255, np.uint8)])), 63, 45)
    add("pnm", S.make_pnm(img(63, 45)), 63, 45)
    dds, _ = S.make_dds(np.dstack(
        [img(64, 44), np.full((44, 64), 255, np.uint8)]), b"DXT1")
    add("dds", dds, 64, 44)
    add("farbfeld", S.make_farbfeld(img(57, 41)), 57, 41)
    add("hdr", S.make_hdr(np.dstack(
        [img(6, 5) // 2, np.full((5, 6), 128, np.uint8)])), 6, 5)
    for path in _fixture_files(fixtures):
        data = path.read_bytes()
        add(f"fixture:{path.name}", data, *_dims(data))
    out.append(Source("exr_rejected", b"\x76\x2f\x31\x01" + b"\x00" * 64,
                      False))
    base = out[0].data
    out.append(Source("empty", b"", False))
    out.append(Source("garbage", bytes(rng.integers(0, 256, 4096,
                                                    dtype=np.uint8)), False))
    out.append(Source("truncated", base[: len(base) // 3], False))
    corrupt = bytearray(base)
    for _ in range(24):
        corrupt[int(rng.integers(32, len(corrupt)))] = int(
            rng.integers(0, 256))
    out.append(Source("corrupt", bytes(corrupt), None))
    return out, list(NO_WRITER)


def _fixture_files(paths) -> List[Path]:
    files: List[Path] = []
    for p in map(Path, paths):
        if p.is_dir():
            files += sorted(f for f in p.iterdir()
                            if f.suffix.lower() in _FIXTURE_SUFFIXES)
        else:
            files.append(p)
    return files


def _dims(data: bytes) -> Tuple[int, int]:
    from imagekit_tpu_torch.codecs import decode_bytes

    arr, _ = decode_bytes(data, device="cpu")
    return arr.shape[1], arr.shape[0]


# -- the plans ----------------------------------------------------------------


def upload_plan(sources: List[Source], n: int, seed: int = 7
                ) -> List[Request]:
    """``n`` /upload requests over ``sources`` in turn, the reference's mix
    drawn from ``seed``."""
    rng = random.Random(seed)
    plan = []
    for i in range(n):
        src = sources[i % len(sources)]
        w, h = rng.choice(UPLOAD_W), rng.choice(UPLOAD_H)
        f, q = rng.choice(UPLOAD_F), rng.choice(UPLOAD_Q)
        fields = {k: str(v) for k, v in (("w", w), ("h", h), ("q", q))
                  if v is not None}
        if f:
            fields["f"] = f
        fmt = f if f in ("webp", "jpeg", "avif") else "webp"
        plan.append(Request(i, src, fields, fmt,
                            rng.random() < CHECK_SHARE))
    return plan


def img_plan(sources: List[Source], n: int, seed: int = 11
             ) -> List[Request]:
    """``n`` /sign -> /img requests over ``sources`` in turn, the
    reference's modes and mix drawn from ``seed``."""
    rng = random.Random(seed)
    plan = []
    for i in range(n):
        src = sources[i % len(sources)]
        mode = rng.choice(IMG_MODES)
        w, f = rng.choice(IMG_W), rng.choice(IMG_F)
        plan.append(Request(i, src, {"w": str(w), "f": f}, f,
                            rng.random() < CHECK_SHARE, mode=mode,
                            revalidate=rng.random() < 0.25))
    return plan


# -- the checks ---------------------------------------------------------------


_MAGIC = {"webp": lambda b: b[:4] == b"RIFF" and b[8:12] == b"WEBP",
          "jpeg": lambda b: b[:2] == b"\xff\xd8",
          "avif": lambda b: b[4:12] == b"ftypavif"}


def body_miss(req: Request, body: bytes) -> Optional[str]:
    """Why a 200 body is wrong for its request, or None: its format, and
    the dimensions the port's own decoders read against
    ``target_dimensions``."""
    from imagekit_tpu_torch.codecs import decode_bytes
    from imagekit_tpu_torch.errors import ImageKitError
    from imagekit_tpu_torch.ops.weights import target_dimensions

    if not body:
        return "empty 200 body"
    if not _MAGIC[req.fmt](body):
        return f"200 body is not {req.fmt}: {body[:16]!r}"
    try:
        arr, _ = decode_bytes(body, device="cpu")
    except ImageKitError as e:
        return f"200 body undecodable ({e})"
    sw, sh = req.source.dims
    w = int(req.fields["w"]) if "w" in req.fields else None
    h = int(req.fields["h"]) if "h" in req.fields else None
    want = target_dimensions(sw, sh, w, h)
    got = (arr.shape[1], arr.shape[0])
    if got != tuple(want):
        return f"200 body is {got[0]}x{got[1]}, want {want[0]}x{want[1]}"
    return None


def status_miss(req: Request, status: int, retry_after) -> Optional[str]:
    """The reference's status rules, as a message where they are broken."""
    if status >= 500:
        return f"status {status}"
    if status == 429:
        if not retry_after or not str(retry_after).isdigit() \
                or int(retry_after) < 1:
            return "429 without a sane Retry-After"
        return None
    if req.mode == "tamper":
        want: Tuple[int, ...] = (401,)
    elif req.mode == "expired":
        want = (410,)
    else:
        want = {True: (200,), False: (400,), None: (200, 400)}[
            req.source.decodable]
    if status not in want:
        return f"status {status}, expected {want}"
    return None


def _label(req: Request) -> str:
    return (f"#{req.index} {req.source.name} {req.mode} "
            + " ".join(f"{k}={v}" for k, v in req.fields.items()))


# -- the runs -----------------------------------------------------------------


async def run(base: str, n: int = 3000, concurrency: int = 16,
              sources: Optional[List[Source]] = None,
              plan: Optional[List[Request]] = None) -> Report:
    """``POST /upload`` soak of the server at ``base``."""
    import aiohttp

    if plan is None:
        plan = upload_plan(sources or make_sources()[0], n)
    report = Report("upload")
    sem = asyncio.Semaphore(concurrency)
    slots: List = [None] * len(plan)

    async def one(session, pos: int, req: Request):
        form = aiohttp.FormData()
        form.add_field("file", req.source.data, filename="x",
                       content_type="image/any")
        for k, v in req.fields.items():
            form.add_field(k, v)
        async with sem:
            t0 = time.perf_counter()
            try:
                async with session.post(
                        base + "/upload", data=form,
                        timeout=aiohttp.ClientTimeout(
                            total=UPLOAD_TIMEOUT_S)) as r:
                    body = await r.read()
                    status = r.status
                    retry = r.headers.get("Retry-After")
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                report.misses.append(f"{_label(req)}: transport error {e!r}")
                return
            slots[pos] = (req, status, time.perf_counter() - t0)
        await _judge(report, req, status, retry, body)

    t0 = time.perf_counter()
    async with aiohttp.ClientSession() as session:
        await asyncio.gather(*(one(session, i, r) for i, r in enumerate(plan)))
    report.seconds = time.perf_counter() - t0
    report.results = [s for s in slots if s is not None]
    return report


async def _judge(report: Report, req: Request, status: int, retry,
                 body: bytes) -> None:
    miss = status_miss(req, status, retry)
    if status == 429:
        report.shed += 1
    if miss is None and status == 200 and req.mode == "ok" \
            and req.source.dims is not None and req.check_body:
        miss = await asyncio.get_running_loop().run_in_executor(
            None, body_miss, req, body)
        report.checked += 1
    if miss is not None:
        report.misses.append(f"{_label(req)}: {miss}")


async def run_img(base: str, n: int = 3000, concurrency: int = 16,
                  sources: Optional[List[Source]] = None,
                  plan: Optional[List[Request]] = None) -> Report:
    """``/sign`` -> ``GET /img`` soak of the server at ``base``; the sources
    are served by an origin on a free local port for the run."""
    import aiohttp
    from aiohttp import web

    if plan is None:
        plan = img_plan(sources or make_sources()[0], n)
    blobs = {f"/src{r.index}": r.source.data for r in plan}

    async def serve(request):
        data = blobs.get(request.path)
        if data is None:
            return web.Response(status=404)
        return web.Response(body=data, content_type="image/jpeg")

    origin = web.Application()
    origin.router.add_get("/{name}", serve)
    runner = web.AppRunner(origin)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    src_port = runner.addresses[0][1]
    report = Report("img")
    sem = asyncio.Semaphore(concurrency)
    slots: List = [None] * len(plan)

    async def one(session, pos: int, req: Request):
        params = {"url": f"http://127.0.0.1:{src_port}/src{req.index}",
                  **req.fields}
        if req.mode == "expired":
            params["t"] = str(int(time.time()) - 3600)
        to = aiohttp.ClientTimeout(total=IMG_TIMEOUT_S)
        async with sem:
            t0 = time.perf_counter()
            try:
                async with session.get(base + "/sign", params=params,
                                       timeout=to) as r:
                    signed = (await r.json())["signed_url"]
                if req.mode == "tamper":  # flip the signature's last digit
                    signed = signed[:-1] + ("0" if signed[-1] != "0" else "1")
                async with session.get(base + signed, timeout=to) as r:
                    body = await r.read()
                    status = r.status
                    retry = r.headers.get("Retry-After")
                    etag = r.headers.get("ETag")
                slots[pos] = (req, status, time.perf_counter() - t0)
                if req.mode == "ok" and status == 200 and req.revalidate:
                    async with session.get(base + signed, timeout=to) as r2:
                        await r2.read()
                        if r2.status != 200:
                            report.misses.append(
                                f"{_label(req)}: cache hit status "
                                f"{r2.status}")
                    if etag:
                        async with session.get(
                                base + signed, timeout=to,
                                headers={"If-None-Match": etag}) as r3:
                            await r3.read()
                            if r3.status != 304:
                                report.misses.append(
                                    f"{_label(req)}: expected 304, got "
                                    f"{r3.status}")
                    report.revalidated += 1
            except (aiohttp.ClientError, asyncio.TimeoutError, KeyError,
                    ValueError) as e:
                report.misses.append(f"{_label(req)}: transport error {e!r}")
                return
        await _judge(report, req, status, retry, body)

    t0 = time.perf_counter()
    try:
        async with aiohttp.ClientSession() as session:
            await asyncio.gather(*(one(session, i, r)
                                   for i, r in enumerate(plan)))
    finally:
        await runner.cleanup()
    report.seconds = time.perf_counter() - t0
    report.results = [s for s in slots if s is not None]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", default="http://127.0.0.1:18099")
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--img", action="store_true",
                    help="soak the /sign -> /img path instead of /upload")
    ap.add_argument("--fixtures", nargs="*", default=[],
                    help="files, or directories of them, added as classes")
    args = ap.parse_args(argv)
    sources, skipped = make_sources(args.fixtures)
    for name in skipped:
        print(f"  {name}: skipped (no writer here)")
    fn = run_img if args.img else run
    report = asyncio.run(fn(args.base, args.n, args.concurrency, sources))
    for line in report.lines():
        print(line)
    print(json.dumps(report.summary()))
    return 1 if report.misses else 0


if __name__ == "__main__":
    raise SystemExit(main())
