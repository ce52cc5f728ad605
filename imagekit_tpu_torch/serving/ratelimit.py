"""Per-IP rate limiting.

Parity with the reference's tower-governor layer (``src/lib.rs:450-467``):
10 requests/second per IP with a burst of 30, applied to the transform
routes only; ``DISABLE_RATE_LIMIT`` env bypasses it. Implemented as GCRA
(the same algorithm the governor crate uses) so sustained-rate and burst
semantics match.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple


class GcraLimiter:
    def __init__(self, per_second: float = 10.0, burst: int = 30):
        self.emission_interval = 1.0 / per_second
        # GCRA delay-variation tolerance: a burst of N costs (N-1) intervals.
        self.tolerance = (burst - 1) * self.emission_interval
        self._tat: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._last_gc = time.monotonic()

    def check(self, key: str, now: Optional[float] = None) -> Tuple[bool, float]:
        """Return (allowed, retry_after_seconds)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            self._maybe_gc(t)
            tat = self._tat.get(key, t)
            allow_at = tat - self.tolerance
            if t < allow_at:
                return False, allow_at - t
            self._tat[key] = max(tat, t) + self.emission_interval
            return True, 0.0

    def _maybe_gc(self, now: float) -> None:
        # Drop idle entries so the table doesn't grow unboundedly.
        if now - self._last_gc < 60.0:
            return
        self._last_gc = now
        horizon = now - self.tolerance - 60.0
        stale = [k for k, tat in self._tat.items() if tat < horizon]
        for k in stale:
            del self._tat[k]
