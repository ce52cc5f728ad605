"""Cloudflare-compatible edge-cache header middleware.

Parity with the reference ``src/cache/cloudflare.rs``:

- ``CloudflareCacheConfig`` with identical fields and defaults: edge 1 day,
  browser 1 year, public, immutable, stale-if-error 1 day, SWR 60 s
  (``src/cache/cloudflare.rs:12-49``)
- presets ``for_images`` / ``for_dynamic`` / ``no_cache``
  (``src/cache/cloudflare.rs:56-88``)
- ``cache_control_value()`` / ``cdn_cache_control_value()`` string assembly
  (``src/cache/cloudflare.rs:94-134``)
- middleware behaviour: on 2xx responses from the transform routes, *overwrite*
  ``Cache-Control``, set ``CDN-Cache-Control`` and ``Vary: Accept-Encoding``
  (``src/cache/cloudflare.rs:147-174``). This deliberately reproduces the
  reference quirk (SURVEY.md §2.4.3) where /upload's ``no-store`` and /sign's
  JSON also receive cacheable headers — the reference's own E2E script
  asserts this output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class CloudflareCacheConfig:
    edge_max_age: int = 86400
    browser_max_age: int = 31536000
    public: bool = True
    stale_if_error: Optional[int] = 86400
    stale_while_revalidate: Optional[int] = 60
    immutable: bool = True

    @classmethod
    def for_images(cls) -> "CloudflareCacheConfig":
        """(``src/cache/cloudflare.rs:56-58``)"""
        return cls()

    @classmethod
    def for_dynamic(cls, ttl_seconds: int) -> "CloudflareCacheConfig":
        """(``src/cache/cloudflare.rs:64-73``)"""
        return cls(
            edge_max_age=ttl_seconds,
            browser_max_age=ttl_seconds,
            public=True,
            stale_if_error=ttl_seconds * 2,
            stale_while_revalidate=60,
            immutable=False,
        )

    @classmethod
    def no_cache(cls) -> "CloudflareCacheConfig":
        """(``src/cache/cloudflare.rs:79-88``)"""
        return cls(
            edge_max_age=0,
            browser_max_age=0,
            public=False,
            stale_if_error=None,
            stale_while_revalidate=None,
            immutable=False,
        )

    def cache_control_value(self) -> str:
        """(``src/cache/cloudflare.rs:94-122``)"""
        if self.edge_max_age == 0:
            return "no-store, no-cache, must-revalidate"
        parts = ["public" if self.public else "private"]
        parts.append(f"max-age={self.browser_max_age}")
        parts.append(f"s-maxage={self.edge_max_age}")
        if self.immutable:
            parts.append("immutable")
        if self.stale_if_error is not None:
            parts.append(f"stale-if-error={self.stale_if_error}")
        if self.stale_while_revalidate is not None:
            parts.append(f"stale-while-revalidate={self.stale_while_revalidate}")
        return ", ".join(parts)

    def cdn_cache_control_value(self) -> str:
        """(``src/cache/cloudflare.rs:128-134``)"""
        if self.edge_max_age == 0:
            return "no-store"
        return f"max-age={self.edge_max_age}"


def cloudflare_cache_headers(status: int) -> Dict[str, str]:
    """Headers the middleware injects on success responses
    (``src/cache/cloudflare.rs:147-174``); empty dict for non-2xx."""
    if not (200 <= status < 300):
        return {}
    cfg = CloudflareCacheConfig.for_images()
    return {
        "Cache-Control": cfg.cache_control_value(),
        "CDN-Cache-Control": cfg.cdn_cache_control_value(),
        "Vary": "Accept-Encoding",
    }
