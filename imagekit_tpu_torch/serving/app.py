"""HTTP application on the port's engine.

A copy of ``imagekit_tpu/serving/app.py`` (``create_app``/``run``) with the
port's :class:`~imagekit_tpu_torch.serving.batcher.BatchedEngine` as the
default engine. Routes, middleware, query parsing, status mapping, cache
keys, ETags and headers are the reference's; they are host code, so the
HTTP contract holds by construction. What differs:

- ``/health`` reports the device as ``cuda:<card name>`` (or ``cpu``):
  the engine's first device where it runs on a grid, as the reference
  reports ``jax.devices()[0]``;
- ``/debug/trace`` records a ``torch.profiler`` trace instead of a
  ``jax.profiler`` one;
- :class:`~imagekit_tpu_torch.errors.NotPortedError` (a request outside the
  ported slice) answers 501;
- the fetched source is validated by its header only
  (:func:`imagekit_tpu_torch.fetch.fetch_source`) and always reaches the
  engine as bytes: the reference decodes a PNG in the fetch stage through
  a decoder that imports Pillow.
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import time
from pathlib import Path
from typing import Mapping, Optional, Tuple

from aiohttp import web

from imagekit_tpu_torch import __version__
from imagekit_tpu_torch.cache import (
    Cache,
    DiskCache,
    KVCache,
    cloudflare_cache_headers,
)
from imagekit_tpu_torch.config import (
    DEFAULT_CACHE_CONTROL,
    DEFAULT_QUALITY,
    NO_CACHE_CONTROL,
    ImageFormat,
    ImageKitConfig,
)
from imagekit_tpu_torch.errors import (
    EngineOverloaded,
    ImageKitError,
    InvalidArgumentError,
    NotPortedError,
    SourceDecodeError,
)
from imagekit_tpu_torch.fetch import Fetcher, fetch_source
from imagekit_tpu_torch.serving.engine import TransformEngine
from imagekit_tpu_torch.serving.metrics import METRICS, Metrics
from imagekit_tpu_torch.serving.ratelimit import GcraLimiter

logger = logging.getLogger("imagekit")

TRANSFORM_ROUTES = ("/img", "/upload", "/sign")
_U32_MAX = 2**32 - 1
_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


class QueryError(Exception):
    """Deserialization failure -> 400."""


def _overloaded_response(e: EngineOverloaded) -> web.Response:
    """Engine admission control -> 429 + Retry-After."""
    after = str(max(1, int(e.retry_after + 0.999)))
    return web.Response(
        status=429,
        text="Server overloaded, retry later",
        headers={"retry-after": after},
    )


def _not_ported_response(e: NotPortedError) -> web.Response:
    return web.Response(status=501, text=str(e))


# Python's int() accepts '+5', ' 5 ', '1_0' — serde's integer parsers do
# not; validate with strict digit regexes first.
_UDIGITS = re.compile(r"^[0-9]+$")
_IDIGITS = re.compile(r"^-?[0-9]+$")


def _parse_u32(raw: str, name: str) -> int:
    if not _UDIGITS.match(raw):
        raise QueryError(f"invalid {name}")
    v = int(raw)
    if not (0 <= v <= _U32_MAX):
        raise QueryError(f"invalid {name}")
    return v


def _parse_u8(raw: str, name: str) -> int:
    if not _UDIGITS.match(raw):
        raise QueryError(f"invalid {name}")
    v = int(raw)
    if not (0 <= v <= 255):
        raise QueryError(f"invalid {name}")
    return v


def _parse_i64(raw: str, name: str) -> int:
    if not _IDIGITS.match(raw):
        raise QueryError(f"invalid {name}")
    v = int(raw)
    if not (_I64_MIN <= v <= _I64_MAX):
        raise QueryError(f"invalid {name}")
    return v


def parse_transform_query(
    query: Mapping[str, str], *, require_sig: bool
) -> Tuple[dict, Optional[str]]:
    """Parse /img and /sign query params with serde-equivalent strictness.
    Returns the canonical param map (re-stringified from parsed values) and
    the raw sig."""
    if "url" not in query:
        raise QueryError("missing url")
    params = {"url": query["url"]}
    if (raw := query.get("w")) is not None:
        params["w"] = str(_parse_u32(raw, "w"))
    if (raw := query.get("h")) is not None:
        params["h"] = str(_parse_u32(raw, "h"))
    if (raw := query.get("f")) is not None:
        fmt = ImageFormat.parse(raw)
        if fmt is None:
            raise QueryError("invalid f")
        params["f"] = fmt.value
    if (raw := query.get("q")) is not None:
        params["q"] = str(_parse_u8(raw, "q"))
    if (raw := query.get("t")) is not None:
        params["t"] = str(_parse_i64(raw, "t"))
    sig = query.get("sig")
    if require_sig and sig is None:
        raise QueryError("missing sig")
    return params, sig


class AppState:
    def __init__(
        self,
        config: ImageKitConfig,
        *,
        cache: Optional[Cache] = None,
        engine: Optional[TransformEngine] = None,
        fetcher: Optional[Fetcher] = None,
        metrics: Metrics = METRICS,
        device: str = "cuda",
    ) -> None:
        self.config = config
        if cache is None:
            if getattr(config, "cache_backend", "disk") == "kv":
                cache = KVCache(config.cache_dir, config.max_cache_size)
            else:
                cache = DiskCache(config.cache_dir)
        self.cache = cache
        if engine is None:
            from imagekit_tpu_torch.serving.batcher import BatchedEngine

            engine = BatchedEngine(config, metrics=metrics, device=device)
        self.engine = engine
        self.fetcher = fetcher
        self.metrics = metrics
        self._stats_cache: Optional[KVCache] = None

    def stats_cache(self) -> KVCache:
        """The /stats/cache backend: KV store over the cache dir."""
        if self._stats_cache is None:
            self._stats_cache = KVCache(
                self.config.cache_dir, self.config.max_cache_size
            )
        return self._stats_cache

    async def close(self) -> None:
        await self.engine.close()
        if self.fetcher is not None:
            await self.fetcher.close()
        if self._stats_cache is not None:
            self._stats_cache.close()


def _state(request: web.Request) -> AppState:
    return request.app["state"]


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------


def _etag_matches(if_none_match: "str | None", etag: str) -> bool:
    """RFC 9110 §13.1.2 weak comparison for If-None-Match."""
    if not if_none_match:
        return False
    if if_none_match.strip() == "*":
        return True
    bare = etag[2:] if etag.startswith("W/") else etag
    for candidate in if_none_match.split(","):
        c = candidate.strip()
        if c.startswith("W/"):
            c = c[2:]
        if c == bare:
            return True
    return False


async def img_handler(request: web.Request) -> web.Response:
    """``GET /img``: verify, look up the cache, fetch, transform, store."""
    state = _state(request)
    try:
        params, sig = parse_transform_query(request.query, require_sig=True)
    except QueryError as e:
        return web.Response(status=400, text=f"Failed to deserialize query string: {e}")

    from imagekit_tpu_torch.signature import (
        SignatureError,
        error_to_http,
        verify_signature,
    )

    try:
        verify_signature(params, sig, state.config.secret)
    except SignatureError as e:
        status, _ = error_to_http(e)
        state.metrics.inc("errors")
        logger.warning(
            "signature verification failed url=%s: %s", params.get("url"), e
        )
        return web.Response(status=status, text=str(e))

    q_param = params.get("q")
    if q_param is not None:
        qv = int(q_param)
        if qv == 0 or qv > 100:
            state.metrics.inc("errors")
            return web.Response(status=400, text="Invalid quality")

    cache = state.cache
    key = cache.key_for(params)
    target_format = (
        ImageFormat.parse(params["f"])
        if "f" in params
        else (state.config.default_format or ImageFormat.webp)
    )

    # serve hits with the STORED format's Content-Type
    if hasattr(cache, "get_with_format"):
        hit = await cache.get_with_format(key)
        cached, stored_fmt = hit if hit is not None else (None, None)
    else:
        cached, stored_fmt = await cache.get(key), None
    if cached is not None:
        state.metrics.inc("cache_hits")
        etag = cache.etag_for(key)
        if _etag_matches(request.headers.get("If-None-Match"), etag):
            return web.Response(
                status=304,
                headers={"Cache-Control": DEFAULT_CACHE_CONTROL, "ETag": etag},
            )
        return web.Response(
            status=200,
            body=cached,
            headers={
                "Cache-Control": DEFAULT_CACHE_CONTROL,
                "ETag": etag,
                "Content-Type": (stored_fmt or target_format).mime,
            },
        )

    state.metrics.inc("cache_misses")
    state.metrics.inc("transforms")
    try:
        data, _ct = await fetch_source(
            params["url"], state.config.max_input_size, fetcher=state.fetcher
        )
    except NotPortedError as e:
        return _not_ported_response(e)
    except ImageKitError as e:
        state.metrics.inc("errors")
        return web.Response(status=400, text=str(e))

    w = int(params["w"]) if "w" in params else None
    h = int(params["h"]) if "h" in params else None
    quality = int(params["q"]) if "q" in params else DEFAULT_QUALITY

    try:
        encoded = await state.engine.transform(data, w, h, target_format, quality)
    except EngineOverloaded as e:
        return _overloaded_response(e)
    except NotPortedError as e:
        return _not_ported_response(e)
    except SourceDecodeError:
        # the reference finds this at its fetch stage, which decodes such a
        # source in full: the same status and body from here
        state.metrics.inc("errors")
        return web.Response(status=400, text=str(InvalidArgumentError(
            "Unable to decode image for validation")))
    except ImageKitError as e:
        state.metrics.inc("errors")
        return web.Response(status=400, text=f"Transform error: {e}")

    canonical = "&".join(f"{k}={params[k]}" for k in sorted(params))
    try:
        await cache.put(key, encoded, target_format, canonical)
    except Exception as e:  # noqa: BLE001 - a cache-put failure is non-fatal
        logger.warning("failed to cache transformed image: %s", e)

    return web.Response(
        status=200,
        body=encoded,
        headers={
            "Cache-Control": DEFAULT_CACHE_CONTROL,
            "ETag": cache.etag_for(key),
            "Content-Type": target_format.mime,
        },
    )


async def sign_handler(request: web.Request) -> web.Response:
    """``GET /sign``: HMAC-sign the canonical params."""
    state = _state(request)
    try:
        params, _ = parse_transform_query(request.query, require_sig=False)
    except QueryError as e:
        return web.Response(status=400, text=f"Failed to deserialize query string: {e}")

    from imagekit_tpu_torch.signature import canonical_string, sign

    canonical = canonical_string(params)
    sig = sign(params, state.config.secret)
    return web.json_response(
        {
            "canonical": canonical,
            "sig": sig,
            "signed_url": f"/img?{canonical}&sig={sig}",
        }
    )


async def upload_handler(request: web.Request) -> web.Response:
    """``POST /upload``: multipart transform, raw bytes, no-store."""
    state = _state(request)
    file_bytes: Optional[bytes] = None
    w: Optional[int] = None
    h: Optional[int] = None
    f: Optional[ImageFormat] = None
    q: Optional[int] = None

    try:
        reader = await request.multipart()
        while True:
            field = await reader.next()
            if field is None:
                break
            name = field.name or ""
            if name == "file":
                chunks = bytearray()
                while True:
                    chunk = await field.read_chunk(64 * 1024)
                    if not chunk:
                        break
                    chunks.extend(chunk)
                    if (
                        state.config.enforce_upload_cap
                        and len(chunks) > state.config.max_input_size
                    ):
                        return web.Response(
                            status=413, text="Input exceeds size limit"
                        )
                file_bytes = bytes(chunks)
            elif name == "w":
                text = (await field.read()).decode(errors="replace")
                w = int(text) if text.isdigit() else None
            elif name == "h":
                text = (await field.read()).decode(errors="replace")
                h = int(text) if text.isdigit() else None
            elif name == "f":
                text = (await field.read()).decode(errors="replace")
                f = ImageFormat.parse(text)
            elif name == "q":
                text = (await field.read()).decode(errors="replace")
                q = int(text) if text.isdigit() and int(text) <= 255 else None
    except web.HTTPException:
        raise
    except Exception:  # noqa: BLE001 - any malformed body is a 400
        return web.Response(status=400, text="Invalid multipart")

    if file_bytes is None:
        return web.Response(status=400, text="Missing file")

    target_format = f or state.config.default_format or ImageFormat.webp
    quality = q if q is not None else DEFAULT_QUALITY

    try:
        encoded = await state.engine.transform(
            file_bytes, w, h, target_format, quality
        )
    except EngineOverloaded as e:
        return _overloaded_response(e)
    except NotPortedError as e:
        return _not_ported_response(e)
    except ImageKitError as e:
        state.metrics.inc("errors")
        # undecodable source -> "Decode error", later stages -> "Transform"
        try:
            await state.engine.decode(file_bytes)
        except NotPortedError:
            pass
        except ImageKitError as de:
            return web.Response(status=400, text=f"Decode error: {de}")
        return web.Response(status=400, text=f"Transform error: {e}")

    state.metrics.inc("transforms")
    return web.Response(
        status=200,
        body=encoded,
        headers={
            "Content-Type": target_format.mime,
            "Cache-Control": NO_CACHE_CONTROL,
        },
    )


def _device_name(engine: TransformEngine) -> str:
    device = getattr(engine, "device", None)
    if device is None or device.type != "cuda":
        return "cpu"
    import torch

    return f"cuda:{torch.cuda.get_device_name(device)}"


async def health_handler(request: web.Request) -> web.Response:
    """``GET /health``: status plus device liveness (the engine's device
    and the age of the last successful device step)."""
    state = _state(request)
    device = {"platform": _device_name(state.engine)}
    last_ok = getattr(state.metrics, "last_device_ok", 0.0)
    if last_ok:
        device["last_device_success_age_s"] = round(time.time() - last_ok, 1)
    return web.json_response(
        {
            "status": "healthy",
            "version": __version__,
            "service": "imagekit",
            "device": device,
        }
    )


async def debug_trace_handler(request: web.Request) -> web.Response:
    """``POST /debug/trace``: record a torch.profiler trace (CPU and, on a
    card, CUDA activity) for N seconds and write it as a Chrome trace.
    Gated by IMAGEKIT_DEBUG_ENDPOINTS."""
    if not os.environ.get("IMAGEKIT_DEBUG_ENDPOINTS"):
        return web.Response(status=404, text="Not found")
    import torch
    from torch.profiler import ProfilerActivity, profile

    seconds = min(float(request.query.get("seconds", "2")), 30.0)
    out_dir = os.path.join(
        os.environ.get("IMAGEKIT_TRACE_DIR", "traces"), str(int(time.time()))
    )
    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        await asyncio.sleep(seconds)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return web.json_response({"trace_dir": out_dir, "seconds": seconds})


async def pipelines_handler(request: web.Request) -> web.Response:
    """``GET /stats/pipelines``: the declarative stage split per output
    family."""
    from imagekit_tpu_torch.models.pipelines import describe

    return web.json_response(describe())


async def cache_stats_handler(request: web.Request) -> web.Response:
    """``GET /stats/cache``: KV cache stats + hit rate JSON."""
    state = _state(request)
    try:
        stats = await state.stats_cache().stats()
    except Exception as e:  # noqa: BLE001 - reported as a 500 body
        return web.Response(status=500, text=f"Cache error: {e}")
    snap = state.metrics.snapshot()
    hits = int(snap["cache_hits"])
    misses = int(snap["cache_misses"])
    total = hits + misses
    hit_rate = (hits / total * 100.0) if total > 0 else 0.0
    max_bytes = stats.max_size_bytes
    return web.json_response(
        {
            "cache": {
                "total_size_bytes": stats.total_size_bytes,
                "total_size_mb": stats.total_size_bytes / 1024.0 / 1024.0,
                "entry_count": stats.entry_count,
                "max_size_bytes": max_bytes,
                "max_size_mb": max_bytes / 1024.0 / 1024.0,
                "usage_percent": (
                    (stats.total_size_bytes / max_bytes * 100.0) if max_bytes else 0.0
                ),
            },
            "requests": {
                "cache_hits": hits,
                "cache_misses": misses,
                "total": total,
                "hit_rate_percent": hit_rate,
            },
            "transforms": {
                "total": int(snap["transforms"]),
                "errors": int(snap["errors"]),
            },
        }
    )


async def metrics_handler(request: web.Request) -> web.Response:
    """``GET /metrics``: Prometheus text exposition."""
    state = _state(request)
    return web.Response(
        status=200,
        text=state.metrics.prometheus_text(),
        content_type="text/plain",
        charset="utf-8",
        headers={"X-Prometheus-Version": "0.0.4"},
    )


async def index_handler(request: web.Request) -> web.StreamResponse:
    index = request.app["frontend_dir"] / "index.html"
    if index.is_file():
        return web.FileResponse(index)
    return web.Response(status=404, text="Not found")


# ---------------------------------------------------------------------------
# App assembly
# ---------------------------------------------------------------------------


def create_app(
    config: Optional[ImageKitConfig] = None,
    *,
    cache: Optional[Cache] = None,
    engine: Optional[TransformEngine] = None,
    fetcher: Optional[Fetcher] = None,
    metrics: Metrics = METRICS,
    frontend_dir: Optional[Path] = None,
    rate_limit: Optional[bool] = None,
    device: str = "cuda",
) -> web.Application:
    """Assemble the application. Without an injected ``engine`` it builds
    the port's BatchedEngine on ``device``: with ``"cuda"`` and several
    visible cards, on a grid over them all, as the reference's engine
    builds its mesh."""
    config = config or ImageKitConfig.from_env()
    config.validate()
    state = AppState(
        config, cache=cache, engine=engine, fetcher=fetcher, metrics=metrics,
        device=device,
    )

    if rate_limit is None:
        rate_limit = "DISABLE_RATE_LIMIT" not in os.environ
    limiter = GcraLimiter(per_second=10.0, burst=30) if rate_limit else None

    @web.middleware
    async def transform_middleware(request: web.Request, handler):
        is_transform = request.path in TRANSFORM_ROUTES
        if is_transform and limiter is not None:
            peer = ""
            if config.trust_proxy:
                peer = (
                    request.headers.get("X-Forwarded-For", "")
                    .split(",")[0]
                    .strip()
                )
            if not peer:
                peer = request.remote or "unknown"
            allowed, retry_after = limiter.check(peer)
            if not allowed:
                return web.Response(
                    status=429,
                    text="Too Many Requests",
                    headers={
                        "x-ratelimit-after": str(max(1, int(retry_after + 0.999))),
                        "retry-after": str(max(1, int(retry_after + 0.999))),
                    },
                )
        response = await handler(request)
        if is_transform:
            for k, v in cloudflare_cache_headers(response.status).items():
                response.headers[k] = v
            if limiter is not None:
                response.headers["x-ratelimit-limit"] = "30"
        return response

    app = web.Application(middlewares=[transform_middleware])
    app["state"] = state

    fdir = frontend_dir or (Path(__file__).resolve().parents[2] / "frontend")
    app["frontend_dir"] = fdir

    # observability routes: no rate limit, no cache headers
    app.router.add_get("/health", health_handler)
    app.router.add_post("/debug/trace", debug_trace_handler)
    app.router.add_get("/stats/cache", cache_stats_handler)
    app.router.add_get("/stats/pipelines", pipelines_handler)
    app.router.add_get("/metrics", metrics_handler)
    # transform routes
    app.router.add_get("/img", img_handler)
    app.router.add_post("/upload", upload_handler)
    app.router.add_get("/sign", sign_handler)
    # static frontend
    app.router.add_get("/", index_handler)
    if fdir.is_dir():
        app.router.add_static("/static", fdir)

    async def on_startup(app):
        if hasattr(state.engine, "warmup") and not os.environ.get(
            "IMAGEKIT_NO_WARMUP"
        ):
            app["warmup_task"] = asyncio.ensure_future(state.engine.warmup())

        async def trim_loop():
            # return freed arena memory to the OS periodically
            from imagekit_tpu_torch.utils import malloc_trim

            while True:
                await asyncio.sleep(30.0)
                malloc_trim()

        app["trim_task"] = asyncio.ensure_future(trim_loop())

    async def on_cleanup(app):
        for name in ("warmup_task", "trim_task"):
            task = app.get(name)
            if task is not None:
                task.cancel()
        await state.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def run(port: Optional[int] = None, device: str = "cuda") -> None:
    """Process entry: env config -> validate -> serve on 0.0.0.0:$PORT
    (default 8080)."""
    logging.basicConfig(
        level=os.environ.get("IMAGEKIT_LOG", "INFO").upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from imagekit_tpu_torch.utils import limit_malloc_arenas

    limit_malloc_arenas()  # before any thread pool spawns
    config = ImageKitConfig.from_env()
    config.validate()
    app = create_app(config, device=device)
    port = port or int(os.environ.get("PORT", "8080"))
    loop = asyncio.new_event_loop()
    if hasattr(asyncio, "eager_task_factory"):
        loop.set_task_factory(asyncio.eager_task_factory)
    web.run_app(app, host="0.0.0.0", port=port, loop=loop)
