"""Degree-weighted rebalancing of the vertex partition (`--rebalance`).

Counterpart of `libgrape_lite_tpu/fragment/rebalancer.py` (reference
`grape/fragment/rebalancer.h:27-130`): cut the vfile-ordered vertex
universe into fnum contiguous blocks of equal weight, weight(v) =
vertex_factor + degree(v), so heavy vertices pull the block boundaries
tighter.  The result is an explicit oid -> fid partitioner that feeds
`VertexMap.build` before the fragments are built.
"""

from __future__ import annotations

import numpy as np

from libgrape_lite_tpu_torch.vertex_map.partitioner import ExplicitPartitioner


class Rebalancer:
    def __init__(self, vertex_factor: int = 0):
        self.vertex_factor = vertex_factor

    def partition(self, oids: np.ndarray, src_oid: np.ndarray,
                  dst_oid: np.ndarray, fnum: int) -> ExplicitPartitioner:
        """Degree-balanced contiguous blocks over the given oid order."""
        oids = np.asarray(oids)
        order = np.argsort(oids, kind="stable")
        sorted_oids = oids[order]
        deg = np.zeros(len(oids), dtype=np.int64)
        for arr in (src_oid, dst_oid):
            q = np.asarray(arr)
            pos = np.searchsorted(sorted_oids, q)
            pos_c = np.clip(pos, 0, max(len(sorted_oids) - 1, 0))
            ok = sorted_oids[pos_c] == q
            deg += np.bincount(order[pos_c[ok]], minlength=len(oids))

        cum = np.cumsum(deg + self.vertex_factor)
        total = int(cum[-1]) if len(cum) else 0
        # block boundaries at equal weight quantiles
        cuts = np.searchsorted(cum, (np.arange(1, fnum) * total) // fnum,
                               side="left")
        fids = np.zeros(len(oids), dtype=np.int64)
        start = 0
        for f, c in enumerate(np.append(cuts, len(oids))):
            fids[start:c] = f
            start = c
        return ExplicitPartitioner(oids, fids, fnum=fnum)
