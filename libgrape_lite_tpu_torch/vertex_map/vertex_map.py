"""Global oid <-> gid directory.

Counterpart of `libgrape_lite_tpu/vertex_map/vertex_map.py` (reference
`grape/vertex_map/vertex_map.h:32-557`): a partitioner plus one idxer per
fragment (`--idxer_type`); gid = IdParser(fid, lid).  Batch-vectorised
over numpy arrays; oids are int64, or `str` objects on `--string_id`
graphs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from libgrape_lite_tpu_torch.utils.id_parser import IdParser
from libgrape_lite_tpu_torch.vertex_map.idxer import (
    IdxerBase,
    _is_text,
    make_idxer,
)
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

    def is_string_keyed(self) -> bool:
        """True when the oids are strings (`--string_id` graphs)."""
        return any(ix.size() and _is_text(np.asarray(
            ix.get_oid(np.array([0])))) for ix in self.idxers)

    @classmethod
    def build(
        cls,
        oids: np.ndarray,
        partitioner: PartitionerBase,
        idxer_type: str = "hashmap",
    ) -> "VertexMap":
        """Partition the oid universe, then build one idxer per fragment
        (reference `VertexMapBuilder`, `vertex_map.h:146-220`)."""
        fnum = partitioner.get_fnum()
        oids_arr = np.asarray(oids)
        if len(oids_arr) and len(np.unique(oids_arr)) != len(oids_arr):
            raise ValueError(
                "duplicate vertex oids in the vertex file; if the ids are "
                "strings, load with string_id=True (--string_id)")
        fids = partitioner.get_partition_id(oids_arr)
        idxers = []
        max_ivnum = 0
        for f in range(fnum):
            f_oids = oids_arr[fids == f]
            idxers.append(make_idxer(idxer_type, f_oids))
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

    def get_oid(self, gids: np.ndarray) -> np.ndarray:
        gids = np.asarray(gids)
        fids = self.id_parser.get_fid(gids)
        lids = self.id_parser.get_lid(gids)
        res = np.full(len(gids), -1,
                      dtype=object if self.is_string_keyed() else np.int64)
        for f in range(self.fnum):
            m = fids == f
            if m.any():
                res[m] = np.asarray(self.idxers[f].get_oid(lids[m]))
        return res

    def inner_vertex_num(self, fid: int) -> int:
        return self.idxers[fid].size()

    def total_vertex_num(self) -> int:
        return sum(ix.size() for ix in self.idxers)

    def inner_oids(self, fid: int) -> np.ndarray:
        lids = np.arange(self.idxers[fid].size())
        return np.asarray(self.idxers[fid].get_oid(lids))
