"""LCCDirected -- clustering coefficient of a directed graph.

Counterpart of `libgrape_lite_tpu/models/lcc_directed.py` (reference
`examples/analytical_apps/lcc/lcc_directed.h`, context
`lcc_directed_context.h:52-63`): N(v) is the deduplicated union of in-
and out-neighbours without self-loops; tricnt(v) counts every directed
edge (u, w) with u, w in N(v), so reciprocal pairs count twice; lcc(v) =
tricnt(v) / (d (d - 1)) with d = |N(v)|.

Two bitmap families (`utils/bitset.py`): NB, the union neighbourhoods,
and OUT, the deduplicated out-adjacency.  For every pair (v, u in N(v))
T[v] += |NB[v] & OUT[u]|, in the row AND-popcount kernel
(`ops/intersect.py`, indexed form) over the kept pairs only.  NB and OUT
hold the rows of a rank's slab of fragments (`[fl * vp, words]`, every
fragment in one process); OUT rides a ring of rank blocks
(`Communicator.ring_shift`, the JAX package's `ppermute` of OUT between
shards): at step s a rank holds rank (r + s)'s OUT block and intersects
the pairs whose u lies in it.  Every credit lands on v, a slab row, so
no fold is needed; the degrees the hub cap reads are gathered.  One
process runs one step.  The degree d is the plain popcount of each NB
row, once per query.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.models.lcc import (
    dedup_mask,
    pairs_by_block,
    row_pids,
)
from libgrape_lite_tpu_torch.ops import intersect, spgemm_pack
from libgrape_lite_tpu_torch.utils.bitset import pack_bits, popcount_rows
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class LCCDirected(ParallelAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    result_format = "float"

    def __init__(self):
        self.degree_threshold = 0

    def init_state(self, frag, degree_threshold: int = 0, **_):
        # GRAPE_LCC_BACKEND = spgemm / auto: directed counts weigh
        # reciprocal pairs twice, not the masked-SpGEMM credit algebra; a
        # recorded decline, the results stay intersect's
        spgemm_pack.resolve_lcc_backend(
            type(self).__name__, frag, supported=False,
            unsupported_reason="directed tricnt (direction-weighted "
            "pairs) has no spgemm lowering")
        # hub cap like the undirected app; the directed degree is out + in
        # with multiplicity (reference lcc.h:234-238)
        self.degree_threshold = int(degree_threshold)
        return {"lcc": torch.zeros((getattr(frag, "fl", frag.fnum), frag.vp),
                                   dtype=torch.float64, device=frag.device)}

    def peval(self, ctx: StepContext, dev, state):
        tri, deg = self.tricnt(dev, ctx)
        denom = (deg * (deg - 1)).to(torch.float64)
        lcc = torch.where(
            dev.inner_mask & (deg >= 2),
            tri.to(torch.float64) / denom.clamp(min=1),
            torch.zeros((), dtype=torch.float64, device=tri.device))
        return dict(state, lcc=lcc), 0

    def pair_operands(self, dev, ctx=None):
        """The slab's bitmaps NB and OUT (rows `fid_lo * vp ..`, the
        whole stack in one process) and the kept pairs (v, u in N(v)),
        int32 global pids with v a slab row.  `ctx` gathers the degrees
        across ranks (the single-process context by default)."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        n_pad = dev.fnum * dev.vp
        oe, ie = dev.oe, dev.ie
        rows = oe.edge_src.shape[0] * dev.vp
        base = getattr(dev, "fid_lo", 0) * dev.vp
        thr = self.degree_threshold

        # union pairs (v, u): both CSRs, self-loops dropped, deduplicated
        src = torch.cat([row_pids(dev, oe), row_pids(dev, ie)], 1).reshape(-1)
        nbr = torch.cat([oe.edge_nbr, ie.edge_nbr], 1).reshape(-1)
        msk = torch.cat([oe.edge_mask, ie.edge_mask], 1).reshape(-1)
        msk &= nbr != src
        key = torch.unique(src[msk].long() * n_pad + nbr[msk].long())
        v, u = (key // n_pad).to(torch.int32), (key % n_pad).to(torch.int32)

        # OUT: deduplicated out-adjacency, self-loops dropped
        o_row = row_pids(dev, oe)
        keep_out = dedup_mask(oe) & (oe.edge_nbr != o_row)
        if thr > 0:
            # a filtered vertex contributes no neighbour list: drop its NB
            # row (apex) and its OUT row (middle), lcc.h:98,164; u's
            # degree may be another rank's
            deg_dir = ctx.gather_state(dev.out_degree + dev.in_degree)
            kv = deg_dir[v.long()] <= thr
            v, u = v[kv], u[kv]
            keep_out &= deg_dir[o_row.long()] <= thr

        nb_bm = pack_bits(u, torch.ones_like(v, dtype=torch.bool), rows,
                          v - base, n_pad)
        out_bm = pack_bits(oe.edge_nbr, keep_out, rows, o_row - base, n_pad)
        return nb_bm, out_bm, (v, u)

    def tricnt(self, dev, ctx=None):
        """([fl, vp] int32 tricnt, [fl, vp] int32 |N(v)|) of the slab's
        vertices: K3 over a ring of the ranks' OUT blocks -- step s
        intersects the pairs whose u lies in the block held (rank r +
        s's), then shifts it on (`world` steps, one in one process)."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        nb_bm, out_bm, (v, u) = self.pair_operands(dev, ctx)
        rows = nb_bm.shape[0]
        base = getattr(dev, "fid_lo", 0) * dev.vp
        steps = ctx.ring_size()
        parts = pairs_by_block(v, u, rows, steps)
        tri = torch.zeros(rows, dtype=torch.int32, device=nb_bm.device)
        block = out_bm
        for s in range(steps):
            if s:
                block = ctx.ring_shift(block)
            q = ctx.ring_block(s)
            vq, uq = parts[q]
            cnt = intersect.row_and_popcount_indexed(nb_bm, vq - base, block,
                                                     uq - q * rows)
            tri.index_add_(0, (vq - base).long(), cnt)

        deg = popcount_rows(nb_bm).view(-1, dev.vp)
        return tri.view(-1, dev.vp), deg

    def inceval(self, ctx, dev, state):
        return state, 0

    def finalize(self, frag, state):
        return np.asarray(state["lcc"].numpy())
