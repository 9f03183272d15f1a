"""Vertex partitioners: oid -> fragment id.

Counterpart of `libgrape_lite_tpu/vertex_map/partitioner.py` (reference
`grape/vertex_map/partitioner.h:66-243`) for integer oids.  Every
partitioner maps whole numpy arrays at once; the map partitioner looks
oids up by binary search over the sorted vfile order instead of a Python
dict, so an RMAT-20 edge list (33 M endpoint lookups) partitions in
seconds.  The assignment is the JAX package's, oid for oid.
"""

from __future__ import annotations

import numpy as np


class PartitionerBase:
    type_name = "base"

    def get_partition_id(self, oids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_fnum(self) -> int:
        return self.fnum


class HashPartitioner(PartitionerBase):
    """fid = murmur3-finalizer(oid) % fnum (reference `partitioner.h:66-100`)."""

    type_name = "hash"

    def __init__(self, fnum: int):
        self.fnum = fnum

    def get_partition_id(self, oids: np.ndarray) -> np.ndarray:
        x = np.asarray(oids).astype(np.uint64, copy=True)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
        return (x % np.uint64(self.fnum)).astype(np.int64)


class MapPartitioner(PartitionerBase):
    """Contiguous blocks of ceil(n/fnum) vertices in vfile order
    (reference `partitioner.h:102-174`); unknown oids map to -1."""

    type_name = "map"

    def __init__(self, fnum: int, oid_list: np.ndarray):
        self.fnum = fnum
        oids = np.asarray(oid_list)
        n = len(oids)
        frag_vnum = max((n + fnum - 1) // fnum, 1)
        order = np.argsort(oids, kind="stable")
        self._sorted_oids = oids[order]
        self._sorted_fids = order.astype(np.int64) // frag_vnum

    def get_partition_id(self, oids: np.ndarray) -> np.ndarray:
        q = np.asarray(oids)
        if len(self._sorted_oids) == 0:
            return np.full(len(q), -1, dtype=np.int64)
        pos = np.searchsorted(self._sorted_oids, q)
        pos_c = np.clip(pos, 0, len(self._sorted_oids) - 1)
        ok = self._sorted_oids[pos_c] == q
        return np.where(ok, self._sorted_fids[pos_c], -1).astype(np.int64)


class SegmentedPartitioner(PartitionerBase):
    """Range partitioner over the sorted oid space
    (reference `partitioner.h:175-243`)."""

    type_name = "segment"

    def __init__(self, fnum: int, sorted_oids: np.ndarray):
        self.fnum = fnum
        n = len(sorted_oids)
        frag_vnum = (n + fnum - 1) // fnum
        cuts = [sorted_oids[min(i * frag_vnum, n - 1)] for i in range(1, fnum)]
        self.boundaries = np.asarray(cuts)

    def get_partition_id(self, oids: np.ndarray) -> np.ndarray:
        return np.searchsorted(
            self.boundaries, np.asarray(oids), side="right"
        ).astype(np.int64)


def make_partitioner(kind: str, fnum: int, oid_list=None):
    if kind == "hash":
        return HashPartitioner(fnum)
    if kind == "map":
        if oid_list is None:
            raise ValueError("map partitioner needs the vfile oid list")
        return MapPartitioner(fnum, oid_list)
    if kind == "segment":
        if oid_list is None:
            raise ValueError("segment partitioner needs the oid list")
        return SegmentedPartitioner(fnum, np.sort(np.asarray(oid_list)))
    raise ValueError(f"unknown partitioner type {kind!r}")
