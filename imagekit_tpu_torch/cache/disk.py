"""Flat-file disk cache.

Parity with the reference ``src/cache/disk.rs`` with one deliberate fix
(SURVEY.md §2.4.1): the reference's ``put`` writes ``<dir>/<key>.<ext>``
(``src/cache/disk.rs:129-137``) while ``get`` reads ``<dir>/<key>``
(``src/cache/disk.rs:41-43,90-95``), so its live path never hits. We keep
both behaviours compatible: ``put`` writes ``<key>.<ext>`` (inspectability
preserved) and ``get`` looks for ``<key>`` first (reference behaviour) and
then the known extensions — so keys, ETags, and on-disk filenames are all
identical to the reference, but hits actually happen.

Reads/writes go through a thread pool so the event loop is never blocked
(the reference uses ``tokio::fs`` for the same reason).
"""

from __future__ import annotations

import asyncio
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

from imagekit_tpu_torch.cache import Cache, format_from_extension
from imagekit_tpu_torch.config import ImageFormat

_EXTS = ("webp", "jpeg", "avif", "jpg")


class DiskCache(Cache):
    def __init__(self, directory: Path | str):
        self.dir = Path(directory)

    def path_for(self, key: str) -> Path:
        """(``src/cache/disk.rs:41-43``)"""
        return self.dir / key

    def content_type_for_path(self, path: Path) -> Optional[str]:
        """MIME from file extension (``src/cache/disk.rs:57-64``)."""
        fmt = format_from_extension(path.suffix.lstrip("."))
        return fmt.mime if fmt is not None else None

    def _find(self, key: str) -> Optional[Path]:
        # Reference-exact location first, then the put() naming.
        p = self.path_for(key)
        if p.is_file():
            return p
        for ext in _EXTS:
            q = self.dir / f"{key}.{ext}"
            if q.is_file():
                return q
        return None

    async def get(self, key: str) -> Optional[bytes]:
        return await asyncio.to_thread(self._get_sync, key)

    def _get_sync(self, key: str) -> Optional[bytes]:
        p = self._find(key)
        if p is None:
            return None
        try:
            return p.read_bytes()
        except FileNotFoundError:
            return None

    async def get_with_format(
        self, key: str
    ) -> Optional[Tuple[bytes, Optional[ImageFormat]]]:
        """Like get() but also reports the stored format (from the extension),
        so hits can be served with the *stored* Content-Type rather than the
        query's requested format."""

        def inner():
            p = self._find(key)
            if p is None:
                return None
            try:
                data = p.read_bytes()
            except FileNotFoundError:
                return None
            return data, format_from_extension(p.suffix.lstrip("."))

        return await asyncio.to_thread(inner)

    async def put(
        self, key: str, data: bytes, fmt: ImageFormat, params: str
    ) -> None:
        await asyncio.to_thread(self._put_sync, key, data, fmt)

    def _put_sync(self, key: str, data: bytes, fmt: ImageFormat) -> None:
        # mkdir on first write (src/cache/disk.rs:123-127)
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"{key}.{fmt.extension}"
        # Atomic replace fixes the reference's documented concurrent-write
        # corruption risk (src/cache/disk.rs:13,115) without changing the
        # on-disk layout.
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=f".{key[:16]}.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise
