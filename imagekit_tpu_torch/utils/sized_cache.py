"""Byte-budgeted LRU cache for weight arrays.

``functools.lru_cache`` bounds ENTRY counts, but resample-weight matrices
run 0.5-20 MB each and their keys include true image dimensions — under
adversarial/random-dimension traffic an entry-capped cache grows to
gigabytes (observed: the serving process leaked to 6.7 GB RSS in a
2-minute random-dimension soak). This cache evicts by total payload bytes
instead, in LRU order.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional


def _nbytes(value: Any) -> int:
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    return 64  # opaque small object


class SizedArrayCache:
    """Thread-safe LRU keyed by hashable tuples, bounded by payload bytes."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._sizes: dict = {}
        self._total = 0
        self._lock = threading.Lock()

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key: Hashable, value: Any) -> Any:
        size = _nbytes(value)
        with self._lock:
            if key in self._data:
                self._total -= self._sizes[key]
                del self._data[key]
            self._data[key] = value
            self._sizes[key] = size
            self._total += size
            while self._total > self.max_bytes and len(self._data) > 1:
                old_key, _ = self._data.popitem(last=False)
                self._total -= self._sizes.pop(old_key)
        return value

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        found = self.get(key)
        if found is not None:
            return found
        return self.put(key, build())

    def __len__(self) -> int:
        return len(self._data)

    @property
    def total_bytes(self) -> int:
        return self._total
