"""Shared utilities: bucketing, the sized cache, and the malloc knobs of
``imagekit_tpu/utils/__init__.py`` (the XLA compile cache is not ported:
the port compiles nothing per shape)."""

from __future__ import annotations


def limit_malloc_arenas(n: int = 2) -> bool:
    """Cap glibc malloc arenas (mallopt M_ARENA_MAX).

    The serving process allocates large short-lived buffers from several
    threads (codec pool, device dispatch, HTTP); with default arena
    settings glibc retains freed memory per-arena up to the high-water
    mark — measured at ~3 GB resident under a shape-diverse soak, vs
    ~500 MB with two arenas (throughput unchanged on small hosts). Must
    run before the thread pools spawn. Returns True when applied."""
    import ctypes

    try:
        libc = ctypes.CDLL(None)
        M_ARENA_MAX = -8
        return bool(libc.mallopt(M_ARENA_MAX, int(n)))
    except Exception:  # noqa: BLE001 - non-glibc platforms
        return False


def malloc_trim() -> bool:
    """Return freed arena memory to the OS (glibc malloc_trim). Called
    periodically by the serving app: large transient codec buffers push
    the allocator high-water mark up under load spikes, and glibc holds
    that memory otherwise."""
    import ctypes

    try:
        return bool(ctypes.CDLL(None).malloc_trim(0))
    except Exception:  # noqa: BLE001
        return False
