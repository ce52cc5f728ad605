"""Cache backends.

Parity with the reference ``src/cache/``:

- ``Cache`` abstract backend with ``key_for`` / ``get`` / ``put``
  (``src/cache/mod.rs:14-24``)
- ``etag_for_key`` -> ``"<key>"`` quoted string (``src/cache/mod.rs:27-29``)
- MIME/extension helpers (``src/cache/mod.rs:32-48``)
- :class:`DiskCache` — flat-file cache on the live ``/img`` path
- :class:`KVCache` — the ``SledCache`` equivalent: LRU eviction + stats
- :mod:`imagekit_tpu_torch.cache.cloudflare` — edge-cache header middleware
"""

from __future__ import annotations

import abc
import hashlib
from typing import Mapping, Optional

from imagekit_tpu_torch.config import ImageFormat


def key_for_params(params: Mapping[str, str]) -> str:
    """hex(SHA-256(canonical params)) — byte-identical to the reference
    (``src/cache/disk.rs:74-84``). NOTE: unlike the signature canonical
    string, ``sig`` is *not* excluded here; the reference hashes whatever
    map it is given (the /img handler passes the sig-free map,
    ``src/lib.rs:112-118,137``)."""
    canonical = "&".join(f"{k}={params[k]}" for k in sorted(params))
    return hashlib.sha256(canonical.encode()).hexdigest()


def etag_for_key(key: str) -> str:
    """Quoted-string ETag per RFC 7232 (``src/cache/mod.rs:27-29``)."""
    return f'"{key}"'


def content_type_from_format(fmt: ImageFormat) -> str:
    """(``src/cache/mod.rs:32-38``)"""
    return fmt.mime


def format_from_extension(ext: str) -> Optional[ImageFormat]:
    """(``src/cache/mod.rs:41-48``)"""
    return {
        "webp": ImageFormat.webp,
        "jpeg": ImageFormat.jpeg,
        "jpg": ImageFormat.jpeg,
        "avif": ImageFormat.avif,
    }.get(ext)


class Cache(abc.ABC):
    """Backend abstraction (``src/cache/mod.rs:14-24``)."""

    def key_for(self, params: Mapping[str, str]) -> str:
        return key_for_params(params)

    def etag_for(self, key: str) -> str:
        return etag_for_key(key)

    @abc.abstractmethod
    async def get(self, key: str) -> Optional[bytes]:
        """Return cached bytes or None on miss."""

    @abc.abstractmethod
    async def put(
        self, key: str, data: bytes, fmt: ImageFormat, params: str
    ) -> None:
        """Store transformed bytes under key."""


from imagekit_tpu_torch.cache.disk import DiskCache  # noqa: E402,F401
from imagekit_tpu_torch.cache.kv import CacheStats, KVCache  # noqa: E402,F401
from imagekit_tpu_torch.cache.cloudflare import (  # noqa: E402,F401
    CloudflareCacheConfig,
    cloudflare_cache_headers,
)
