"""Per-fragment oid -> lid indexers.

Counterpart of `libgrape_lite_tpu/vertex_map/idxer.py` (reference
`grape/vertex_map/idxers/`), the hashmap and sorted-array kinds.  Both
answer batch lookups with one `searchsorted` over a sorted copy of the
oids, so no native table and no Python dict is needed.
"""

from __future__ import annotations

import numpy as np


class IdxerBase:
    type_name = "base"

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        """Return lids; -1 for unknown oids."""
        raise NotImplementedError

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


def _sorted_lookup(sorted_oids, lid_of_rank, q):
    q = np.asarray(q)
    if len(sorted_oids) == 0:
        return np.full(len(q), -1, dtype=np.int64)
    pos = np.searchsorted(sorted_oids, q)
    pos_c = np.clip(pos, 0, len(sorted_oids) - 1)
    ok = sorted_oids[pos_c] == q
    return np.where(ok, lid_of_rank[pos_c], -1).astype(np.int64)


class HashMapIdxer(IdxerBase):
    """lid = insertion (vfile) order, as the reference `hashmap_idxer.h`."""

    type_name = "hashmap"

    def __init__(self, oids: np.ndarray):
        self._oids = np.asarray(oids)
        order = np.argsort(self._oids, kind="stable")
        self._sorted = self._oids[order]
        self._lid_of_rank = order.astype(np.int64)

    def get_index(self, oids: np.ndarray) -> np.ndarray:
        return _sorted_lookup(self._sorted, self._lid_of_rank, oids)

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
        return _sorted_lookup(self._oids, self._rank, oids)

    def get_oid(self, lids: np.ndarray) -> np.ndarray:
        return self._oids[np.asarray(lids)]

    def size(self) -> int:
        return len(self._oids)


def make_idxer(kind: str, oids: np.ndarray) -> IdxerBase:
    table = {"hashmap": HashMapIdxer, "sorted_array": SortedArrayIdxer}
    if kind not in table:
        raise ValueError(f"unknown idxer type {kind!r}")
    return table[kind](oids)
