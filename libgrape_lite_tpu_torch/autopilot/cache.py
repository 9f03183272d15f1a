"""Fence-epoch result cache: point queries that skip the device.

Counterpart of `libgrape_lite_tpu/autopilot/cache.py`.  A repeat of an
answered (graph, point query) pair needs no device work.  Two contracts
make a hit sound:

  * the **key** carries every field of `policy.compat_key` (app, round
    limit, guard, non-lane args, lane-arg presence, tenant) plus the
    lane source: equal keys run the same loop from the same source, so
    their answers are byte-identical;
  * the **epoch** is the fleet's graph-version fence (a bare session's
    ingest counter stands in for it).  Every ingest moves the fence
    behind a drain barrier, so an entry stored at fence F was computed
    on version F, a lookup at F' > F misses, and `invalidate_stale(F')`
    drops the dead epoch wholesale.

A hit still comes back as a ServeResult with zeroed stages and still
counts against its SLO (serve/session.py `_deliver_cached`).  Counters
ride the federated ``autopilot`` namespace beside per-instance fields.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from libgrape_lite_tpu_torch.autopilot.signals import AUTOPILOT_STATS

#: the identity of a cache key: the compat key, the lane source, the fence
CACHE_KEY_FIELDS: Tuple[str, ...] = ("compat", "source", "fence")


class ResultCache:
    """Bounded LRU of (compat_key, source, fence) -> a finished result.
    Thread-safe: a feeder thread may look up while the pump stores."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(compat, source, fence):
        return (compat, source, int(fence))

    def lookup(self, compat, source, fence) -> Optional[tuple]:
        """`(values, rounds, terminate_code)` of a finished query of this
        identity at this fence, or None.  An unhashable key is a miss."""
        try:
            k = self._key(compat, source, fence)
            with self._lock:
                ent = self._entries.get(k)
                if ent is not None:
                    self._entries.move_to_end(k)
        except TypeError:
            ent = None
        if ent is None:
            self.misses += 1
            AUTOPILOT_STATS["cache_misses"] += 1
            return None
        self.hits += 1
        AUTOPILOT_STATS["cache_hits"] += 1
        return ent

    def store(self, compat, source, fence, result) -> bool:
        """Store one ok ServeResult under its identity; False when it is
        not cacheable (failed, deferred, value-less, unhashable key)."""
        if result is None or not result.ok:
            return False
        if getattr(result, "deferred", False):
            # a lazily harvested result stays lazy: storing must not
            # force the copy the window defers
            return False
        try:
            vals = result.values
        except Exception:
            return False
        if vals is None:
            return False
        try:
            k = self._key(compat, source, fence)
            with self._lock:
                self._entries[k] = (vals, result.rounds,
                                    result.terminate_code)
                self._entries.move_to_end(k)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
                    AUTOPILOT_STATS["cache_evictions"] += 1
        except TypeError:
            return False
        self.stores += 1
        AUTOPILOT_STATS["cache_stores"] += 1
        return True

    def invalidate_stale(self, fence) -> int:
        """Drop every entry of another epoch than `fence` (the router
        calls this after an ingest moved the fence); returns how many."""
        fence = int(fence)
        with self._lock:
            stale = [k for k in self._entries if k[2] != fence]
            for k in stale:
                del self._entries[k]
        if stale:
            self.invalidations += len(stale)
            AUTOPILOT_STATS["cache_invalidations"] += len(stale)
        return len(stale)

    def snapshot(self) -> dict:
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "stores": self.stores,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }
