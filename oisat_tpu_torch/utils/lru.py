"""A small thread-safe LRU used by the host-side plan/upscaler caches.

fleet_map can run readers from a thread pool (num_job > 1 on multi-core
hosts), so every cache that the regrid path touches must guard its
get/move-to-end/insert/evict sequences.  One shared implementation keeps
the three call sites (granule plans, regrid upscalers, CTM→sat upscalers)
from drifting apart.

The port's own copy of :mod:`oisat_tpu.utils.lru` (same names and
behaviour): the port imports nothing of ``oisat_tpu``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

__all__ = ["LockedLRU"]


class LockedLRU:
    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        """The cached value (refreshing its recency), or None."""
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
