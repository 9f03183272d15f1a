"""Global oid <-> gid directory.

Counterpart of `libgrape_lite_tpu/vertex_map/vertex_map.py` (reference
`grape/vertex_map/vertex_map.h:32-557`): a partitioner plus one idxer per
fragment; gid = IdParser(fid, lid).  Batch-vectorised over numpy arrays.
"""

from __future__ import annotations

from typing import List

import numpy as np

from libgrape_lite_tpu_torch.utils.id_parser import IdParser
from libgrape_lite_tpu_torch.vertex_map.idxer import HashMapIdxer, IdxerBase
from libgrape_lite_tpu_torch.vertex_map.partitioner import PartitionerBase


class VertexMap:
    def __init__(
        self,
        partitioner: PartitionerBase,
        idxers: List[IdxerBase],
        id_parser: IdParser,
    ):
        self.partitioner = partitioner
        self.idxers = idxers
        self.id_parser = id_parser
        self.fnum = len(idxers)

    @classmethod
    def build(
        cls,
        oids: np.ndarray,
        partitioner: PartitionerBase,
    ) -> "VertexMap":
        """Partition the oid universe, then build one hashmap idxer per
        fragment; lids follow vfile order within a fragment."""
        fnum = partitioner.get_fnum()
        oids_arr = np.asarray(oids)
        if len(oids_arr) and len(np.unique(oids_arr)) != len(oids_arr):
            raise ValueError("duplicate vertex oids in the vertex file")
        fids = partitioner.get_partition_id(oids_arr)
        idxers = []
        max_ivnum = 0
        for f in range(fnum):
            f_oids = oids_arr[fids == f]
            idxers.append(HashMapIdxer(f_oids))
            max_ivnum = max(max_ivnum, len(f_oids))
        return cls(partitioner, idxers, IdParser(fnum, max(max_ivnum * 2, 2)))

    def get_gid(self, oids: np.ndarray) -> np.ndarray:
        """oid -> gid; -1 for unknown."""
        oids = np.asarray(oids)
        fids = self.partitioner.get_partition_id(oids)
        gids = np.full(len(oids), -1, dtype=np.int64)
        for f in range(self.fnum):
            m = fids == f
            if not m.any():
                continue
            lids = self.idxers[f].get_index(oids[m])
            g = self.id_parser.generate(np.int64(f), lids)
            g[lids < 0] = -1
            gids[m] = g
        return gids

    def inner_vertex_num(self, fid: int) -> int:
        return self.idxers[fid].size()

    def total_vertex_num(self) -> int:
        return sum(ix.size() for ix in self.idxers)

    def inner_oids(self, fid: int) -> np.ndarray:
        lids = np.arange(self.idxers[fid].size())
        return np.asarray(self.idxers[fid].get_oid(lids))
