"""A bounded cache of tensors built on the host and kept on their device.

The banded kernels' plans (the presmooth's and the resample's windows,
``ops/banded.py``) are read by every stream of a device: the mesh's
positions each have one. A tensor is made by a copy from
pageable memory, which has completed when the copy returns, so any stream
may read it at once. Its memory may go back to the allocator only when no
stream still has a read of it queued: the allocator knows only the stream
it was made on, so evicting an entry first waits for its device.
"""

from __future__ import annotations

import collections
import functools
import threading

import torch


def device_cached(maxsize: int):
    """``functools.lru_cache`` for functions that return a tensor: the
    least recently used entry goes once ``maxsize`` are held, after its
    device has finished all the work queued on it."""
    def decorate(fn):
        cache: collections.OrderedDict = collections.OrderedDict()
        lock = threading.Lock()
        stats = {"hits": 0, "misses": 0}

        @functools.wraps(fn)
        def cached(*args):
            with lock:
                if args in cache:
                    cache.move_to_end(args)
                    stats["hits"] += 1
                    return cache[args]
                stats["misses"] += 1
            value = fn(*args)
            with lock:
                cache[args] = value
                while len(cache) > maxsize:
                    _, old = cache.popitem(last=False)
                    if old.is_cuda:
                        torch.cuda.synchronize(old.device)
            return value

        def cache_info():
            return functools._CacheInfo(stats["hits"], stats["misses"], maxsize, len(cache))

        cached.cache_info = cache_info
        return cached
    return decorate
