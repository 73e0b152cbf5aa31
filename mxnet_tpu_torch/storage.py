"""Storage-manager facade (parity: mxnet_tpu/storage.py, the reference's
src/storage/ PooledStorageManager and its pool statistics).

The card's allocator is torch's caching allocator; the host-side pool
that is the framework's own is the native batch-staging pool of
``cpp/mxtpu_runtime.cc`` (``native``).  This module reports its
statistics and releases it.
"""
from __future__ import annotations

from . import native as _native

__all__ = ["pool_stats", "release_all", "available"]


def available():
    """True when the native pooled storage manager is loaded."""
    return _native.available()


def pool_stats():
    """Allocation counters: bytes_allocated (live), bytes_pooled (idle in
    the free list), n_alloc / n_reuse / n_free; zeros without the native
    runtime."""
    if not _native.available():
        return {"bytes_allocated": 0, "bytes_pooled": 0, "n_alloc": 0,
                "n_reuse": 0, "n_free": 0}
    return _native.pool_stats()


def release_all():
    """Drop every pooled buffer back to the OS (reference
    Storage::ReleaseAll / MXStorageEmptyCache)."""
    if _native.available():
        _native.pool_clear()
