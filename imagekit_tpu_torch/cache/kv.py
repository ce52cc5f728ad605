"""Embedded KV cache with LRU eviction and statistics.

Equivalent of the reference's ``SledCache`` (``src/cache/sled_cache.rs``),
built on stdlib sqlite3 (the sled analogue available here): a single-file
embedded store holding data and metadata rows keyed with ``data:``/``meta:``
prefixes exactly like the reference's key schema
(``src/cache/sled_cache.rs:63-70``). Behaviours mirrored:

- metadata fields key/format/size/created_at/accessed_at/params
  (``src/cache/sled_cache.rs:14-22``)
- ``get`` updates ``accessed_at`` (``src/cache/sled_cache.rs:186-213``)
- ``put`` writes data+meta, flushes, then evicts if over the limit
  (``src/cache/sled_cache.rs:215-252``)
- LRU eviction sorted by ``accessed_at`` down to 90% of max
  (``src/cache/sled_cache.rs:92-148``)
- ``stats()`` -> total size / entry count / max size
  (``src/cache/sled_cache.rs:151-171``)
- default max size 10 GB (``src/cache/sled_cache.rs:11``)

Unlike the reference — where SledCache exists but is orphaned from the
serving path (SURVEY.md §2.4.8) — this backend is actually usable by the
/img handler via configuration.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from imagekit_tpu_torch.cache import Cache
from imagekit_tpu_torch.config import ImageFormat

DEFAULT_MAX_SIZE = 10 * 1024 * 1024 * 1024  # 10 GB (sled_cache.rs:11)
EVICT_TO_FRACTION = 0.90  # evict down to 90% of max (sled_cache.rs:121)


@dataclass
class CacheStats:
    """(``src/cache/sled_cache.rs:151-171``)"""

    total_size_bytes: int
    entry_count: int
    max_size_bytes: int


class KVCache(Cache):
    def __init__(self, directory: Path | str, max_size: Optional[int] = None):
        self.dir = Path(directory)
        self.max_size = DEFAULT_MAX_SIZE if max_size is None else max_size
        self.dir.mkdir(parents=True, exist_ok=True)
        self._db_path = self.dir / "imagekit_kv.sqlite"
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(self._db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)"
        )
        self._conn.commit()

    # -- key schema (sled_cache.rs:63-70) --
    @staticmethod
    def _data_key(key: str) -> str:
        return f"data:{key}"

    @staticmethod
    def _meta_key(key: str) -> str:
        return f"meta:{key}"

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- raw KV ops (single-writer discipline via lock; SURVEY.md §5.2) --
    def _kv_get(self, k: str) -> Optional[bytes]:
        cur = self._conn.execute("SELECT v FROM kv WHERE k=?", (k,))
        row = cur.fetchone()
        return None if row is None else row[0]

    def _kv_put(self, k: str, v: bytes) -> None:
        self._conn.execute(
            "INSERT INTO kv (k, v) VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
            (k, v),
        )

    def _kv_del(self, k: str) -> None:
        self._conn.execute("DELETE FROM kv WHERE k=?", (k,))

    def _all_meta(self):
        cur = self._conn.execute(
            "SELECT k, v FROM kv WHERE k LIKE 'meta:%'"
        )
        for k, v in cur.fetchall():
            try:
                yield k[len("meta:"):], json.loads(v)
            except (ValueError, TypeError):
                continue

    def _current_size(self) -> int:
        """Full scan of meta entries (``src/cache/sled_cache.rs:73-89``)."""
        return sum(int(m.get("size", 0)) for _, m in self._all_meta())

    def _entry_count(self) -> int:
        cur = self._conn.execute(
            "SELECT COUNT(*) FROM kv WHERE k LIKE 'meta:%'"
        )
        return int(cur.fetchone()[0])

    # -- public API --
    async def get(self, key: str) -> Optional[bytes]:
        return await asyncio.to_thread(self._get_sync, key)

    def _get_sync(self, key: str) -> Optional[bytes]:
        with self._lock:
            data = self._kv_get(self._data_key(key))
            if data is None:
                return None
            # touch accessed_at (sled_cache.rs:186-213)
            mk = self._meta_key(key)
            raw = self._kv_get(mk)
            if raw is not None:
                try:
                    meta = json.loads(raw)
                    meta["accessed_at"] = int(time.time())
                    self._kv_put(mk, json.dumps(meta).encode())
                except (ValueError, TypeError):
                    pass
            self._conn.commit()
            return data

    async def get_with_format(self, key: str):
        """Like get() but also reports the stored format (from the meta
        entry) so hits serve the Content-Type the bytes were written with."""

        def inner():
            with self._lock:
                data = self._kv_get(self._data_key(key))
                if data is None:
                    return None
                fmt = None
                raw = self._kv_get(self._meta_key(key))
                if raw is not None:
                    try:
                        meta = json.loads(raw)
                        fmt = ImageFormat.parse(meta.get("format", ""))
                        meta["accessed_at"] = int(time.time())
                        self._kv_put(self._meta_key(key), json.dumps(meta).encode())
                    except (ValueError, TypeError):
                        pass
                self._conn.commit()
                return data, fmt

        return await asyncio.to_thread(inner)

    async def put(
        self, key: str, data: bytes, fmt: ImageFormat, params: str
    ) -> None:
        await asyncio.to_thread(self._put_sync, key, data, fmt, params)

    def _put_sync(
        self, key: str, data: bytes, fmt: ImageFormat, params: str
    ) -> None:
        now = int(time.time())
        meta = {
            "key": key,
            "format": fmt.value,
            "size": len(data),
            "created_at": now,
            "accessed_at": now,
            "params": params,
        }
        with self._lock:
            self._kv_put(self._data_key(key), data)
            self._kv_put(self._meta_key(key), json.dumps(meta).encode())
            self._conn.commit()  # sled flushes on every put (sled_cache.rs:246)
            self._maybe_evict()

    def _maybe_evict(self) -> None:
        """LRU eviction to 90% of max (``src/cache/sled_cache.rs:92-148``)."""
        if self.max_size is None:
            return
        total = self._current_size()
        if total <= self.max_size:
            return
        target = int(self.max_size * EVICT_TO_FRACTION)
        entries = sorted(
            self._all_meta(), key=lambda kv: int(kv[1].get("accessed_at", 0))
        )
        for key, meta in entries:
            if total <= target:
                break
            self._kv_del(self._data_key(key))
            self._kv_del(self._meta_key(key))
            total -= int(meta.get("size", 0))
        self._conn.commit()

    async def stats(self) -> CacheStats:
        return await asyncio.to_thread(self._stats_sync)

    def _stats_sync(self) -> CacheStats:
        with self._lock:
            return CacheStats(
                total_size_bytes=self._current_size(),
                entry_count=self._entry_count(),
                max_size_bytes=self.max_size if self.max_size else 0,
            )
