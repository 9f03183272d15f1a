"""Per-fragment oid -> lid indexers.

Counterpart of `libgrape_lite_tpu/vertex_map/idxer.py` (reference
`grape/vertex_map/idxers/`, dispatch at `idxers.h:26-110`), selected by
`--idxer_type`: `hashmap` (the default), `sorted_array`, `pthash` and
`local`.  Each assigns the JAX package's lids, oid for oid.  Integer oids
go through the native id table and perfect hash (`io/native.py`) where
the library built; otherwise, and for string oids, lookups are one
`searchsorted` over a sorted copy of the oids (no Python dict).
"""

from __future__ import annotations

import numpy as np

from libgrape_lite_tpu_torch.io.native import NativeIdTable, NativeMph


def _is_text(a: np.ndarray) -> bool:
    return a.dtype == object or a.dtype.kind in "US"


def sorted_lookup(sorted_oids: np.ndarray, value_of_rank: np.ndarray,
                  q) -> np.ndarray:
    """value_of_rank[rank of q in sorted_oids], -1 where q is absent.  A
    numeric query of a string table (or the reverse) finds nothing."""
    q = np.asarray(q)
    if len(sorted_oids) == 0 or len(q) == 0 or (
            _is_text(q) != _is_text(sorted_oids)):
        return np.full(len(q), -1, dtype=np.int64)
    pos = np.searchsorted(sorted_oids, q)
    pos_c = np.clip(pos, 0, len(sorted_oids) - 1)
    ok = sorted_oids[pos_c] == q
    return np.where(ok, value_of_rank[pos_c], -1).astype(np.int64)


class IdxerBase:
    type_name = "base"

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        """Return lids; -1 for unknown oids."""
        raise NotImplementedError

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


class _SortedIndex:
    """oid -> lid by binary search; lid = position in `oids`."""

    def __init__(self, oids: np.ndarray):
        order = np.argsort(oids, kind="stable")
        self.sorted = oids[order]
        self.lid_of_rank = order.astype(np.int64)

    def lookup(self, q) -> np.ndarray:
        return sorted_lookup(self.sorted, self.lid_of_rank, q)


class HashMapIdxer(IdxerBase):
    """lid = insertion (vfile) order (reference `hashmap_idxer.h` over
    `IdIndexer`); the native open-addressing table for integer oids."""

    type_name = "hashmap"

    def __init__(self, oids: np.ndarray):
        self._oids = np.asarray(oids)
        self._native = NativeIdTable.build(self._oids)
        self._index = None if self._native else _SortedIndex(self._oids)

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.lookup(oids)
        return self._index.lookup(oids)

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        return self._oids[np.asarray(lids)]

    def size(self) -> int:
        return len(self._oids)


class SortedArrayIdxer(IdxerBase):
    """lid = rank in sorted oid order (reference `sorted_array_idxer.h`)."""

    type_name = "sorted_array"

    def __init__(self, oids: np.ndarray):
        self._oids = np.sort(np.asarray(oids))
        self._rank = np.arange(len(self._oids), dtype=np.int64)

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        return sorted_lookup(self._oids, self._rank, oids)

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        return self._oids[np.asarray(lids)]

    def size(self) -> int:
        return len(self._oids)


class LocalIdxer(IdxerBase):
    """Idxer of vfile-less loading (reference `local_idxer.h`): oids are
    added on first sight, lid = order of first arrival."""

    type_name = "local"

    def __init__(self, oids=None):
        self._oids = np.zeros(0, dtype=np.int64)
        self._native = None
        self._index = None
        if oids is not None:
            self.add(oids)

    def add(self, oids: np.ndarray) -> None:
        arr = np.asarray(oids)
        if not len(self._oids) and not _is_text(arr):
            self._native = NativeIdTable.build(arr[:0])
        if self._native is not None and not _is_text(arr):
            self._native.insert(arr)
            self._oids = self._native.oids()
            return
        if self._native is not None:  # string oids after integer ones
            self._native = None
        # first arrivals of new oids, in order (dedup within the batch
        # and against what is already there)
        _, first = np.unique(arr, return_index=True)
        fresh = arr[np.sort(first)]
        if len(self._oids):
            fresh = fresh[_SortedIndex(self._oids).lookup(fresh) < 0]
            self._oids = np.concatenate(
                [self._oids.astype(object) if _is_text(arr)
                 else self._oids, fresh])
        else:
            self._oids = fresh
        self._index = _SortedIndex(self._oids)

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.lookup(oids)
        if self._index is None:
            return np.full(len(np.asarray(oids)), -1, dtype=np.int64)
        return self._index.lookup(oids)

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        return self._oids[np.asarray(lids)]

    def size(self) -> int:
        return len(self._oids)


class PerfectHashIdxer(IdxerBase):
    """Minimal-perfect-hash idxer (reference `pthash_idxer.h`): lid = the
    key's hash position, a query checked against the lid -> oid array.
    Without the library, or for string oids, the JAX package's
    binary-search emulation with lid = vfile order."""

    type_name = "pthash"

    def __init__(self, oids: np.ndarray):
        oids = np.asarray(oids)
        self._mph = NativeMph.build(oids)
        if self._mph is not None:
            table = np.empty(len(oids), dtype=np.int64)
            table[self._mph.positions(oids)] = oids
            self._oid_by_lid = table
            return
        self._oid_by_lid = oids
        self._index = _SortedIndex(oids)

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        q = np.asarray(oids)
        if self._mph is None:
            return self._index.lookup(q)
        if len(q) == 0 or not np.issubdtype(q.dtype, np.integer):
            return np.full(len(q), -1, dtype=np.int64)
        pos = self._mph.positions(q)
        return np.where(self._oid_by_lid[pos] == q, pos, -1).astype(np.int64)

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        return self._oid_by_lid[np.asarray(lids)]

    def size(self) -> int:
        return len(self._oid_by_lid)


IDXERS = {
    "hashmap": HashMapIdxer,
    "sorted_array": SortedArrayIdxer,
    "local": LocalIdxer,
    "pthash": PerfectHashIdxer,
}


def make_idxer(kind: str, oids: np.ndarray) -> IdxerBase:
    if kind not in IDXERS:
        raise ValueError(f"unknown idxer type {kind!r}")
    return IDXERS[kind](oids)
