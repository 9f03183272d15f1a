"""LCCBeta -- LCC by merge intersection of sorted neighbour lists.

Counterpart of `libgrape_lite_tpu/models/lcc_beta.py` (reference
`examples/analytical_apps/lcc/lcc_beta.h`), the app the registry name
`lcc` runs.  The deduplicated graph is oriented into a DAG by (degree,
pid) -- "lo" (edges point to the higher endpoint, so a row's width is
bounded by the graph's degeneracy) unless a degree threshold is set,
which switches to the reference's "hi" convention -- and the oriented
out-lists become a padded ELL block `[fnum * vp, D]` int32, each row
ascending, padded with the sentinel fnum * vp (a rank's slab of rows, `[fl * vp, D]`, under a
process group).  The JAX package builds it on the host in `init_state`;
here it is scattered on the device from the kept pairs at the start of
the pass (at RMAT-20 the host build cost more than the pass; PERF.md).

For every oriented edge (v, u) a batched `torch.searchsorted` of N+(v)
into N+(u) finds the common members w; one pass credits v and u by the
count and every w by one.  In apex mode (`credit_mode = "apex"`,
`ApexTriangleCount` and the clique apps) only v is credited: each
triangle counts once, at its (degree, pid)-minimal corner, and the
orientation stays "lo" whatever the threshold.  Rows are read by pid
within a process; across processes the ranks' ELL blocks and their row
lengths ride a ring (`Communicator.ring_shift`, the JAX package's
`ppermute` between shards): at step s a rank holds rank (r + s)'s block
and runs the pairs whose u lies in it, and the credits of every rank
fold through `ctx.sum`.  D is the widest row of any rank, so every
block has one shape.  In apex mode (`ApexTriangleCount`, kclique k 3)
the ring is the same and every credit lands on the apex, a slab row, so
the rank keeps its own rows with no fold.
Edges run in groups by row width (see `_merge_pass`), each in chunks
of about 2^22 lanes.  Triangle counts are
int32 sums, exact in any order; lcc values equal the JAX package's bit
for bit.  There is no Pallas kernel here: the JAX package runs this
pass in XLA.  Its host-built tiered edge schedule (`_build_tier_perm`)
is not ported; the width groups are this port's simpler counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.models.lcc import (
    LCC,
    dedup_mask,
    emit_counts,
    pairs_by_block,
    row_pids,
)
from libgrape_lite_tpu_torch.ops import spgemm_pack
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class LCCBeta(ParallelAppBase):
    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    result_format = "float"
    # "lcc": apex, middle and far credits and the coefficient; "apex":
    # apex credits only, int32 counts (k = 3 clique counting)
    credit_mode = "lcc"

    def __init__(self):
        self.degree_threshold = 0

    @property
    def orientation(self) -> str:
        # the reference's filter semantics (`lcc.h:234-243`) are defined
        # on lower-degree neighbour lists, so a threshold selects "hi";
        # apex mode pins "lo", on which per-apex attribution and the
        # clique apps' hub cap are defined
        if self.credit_mode == "lcc" and self.degree_threshold > 0:
            return "hi"
        return "lo"

    def init_state(self, frag, degree_threshold: int = 0, **_):
        # GRAPE_LCC_BACKEND = spgemm / auto: the merge intersection has no
        # spgemm lowering; a recorded decline, the results stay intersect's
        spgemm_pack.resolve_lcc_backend(
            type(self).__name__, frag, supported=False,
            unsupported_reason="merge-intersection ELL kernel has no "
            "spgemm lowering (use lcc_bitmap/lcc_opt)")
        # degree_threshold > 0 drops hub vertices' lists (the reference's
        # LCC cost cap, `lcc.h:234-243`); 0 disables it
        self.degree_threshold = int(degree_threshold)
        return {"lcc": torch.zeros((getattr(frag, "fl", frag.fnum), frag.vp),
                                   dtype=torch.float64, device=frag.device)}

    @staticmethod
    def _ell(v, u, n_rows, sentinel=None, d=None):
        """([n_rows, D] int32 ELL rows, [n_rows] row lengths) from the
        kept pairs, sorted by (v, u), v the row: row v lists N+(v)
        ascending, padded with `sentinel` (default n_rows, the pid count
        of one process's stack) to width `d` (default the widest row)."""
        vl = v.long()
        cnt = torch.bincount(vl, minlength=n_rows)
        d = max(1, int(cnt.max())) if d is None else d
        ell = torch.full((n_rows, d), n_rows if sentinel is None
                         else sentinel, dtype=torch.int32, device=v.device)
        col = torch.arange(v.numel(), device=v.device) - (
            torch.cumsum(cnt, 0) - cnt)[vl]
        ell[vl, col] = u
        return ell, cnt

    def _oriented_edges(self, dev, ctx=None):
        """(v, u) int32 global pids of the kept oriented edges of the
        slab's frag.oe, sorted by (v, u) as the CSR is (`ctx` gathers the
        degrees across ranks)."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        oe = dev.oe
        deg = ctx.gather_state(dev.out_degree)
        row, nbr = row_pids(dev, oe), oe.edge_nbr
        d_row, d_nbr = deg[row.long()], deg[nbr.long()]
        if self.orientation == "lo":
            keep = (d_nbr > d_row) | ((d_nbr == d_row) & (nbr > row))
        else:
            keep = (d_nbr < d_row) | ((d_nbr == d_row) & (nbr < row))
        keep &= dedup_mask(oe) & (nbr != row)
        if self.degree_threshold > 0:
            keep &= d_row <= self.degree_threshold
        return row[keep], nbr[keep]

    _emit = LCC._emit

    def peval(self, ctx: StepContext, dev, state):
        return self._emit(dev, state, self.triangles(dev, state, ctx)), 0

    def triangles(self, dev, state, ctx=None) -> torch.Tensor:
        """[fl, vp] int32 triangle credits per vertex of the slab: the
        merge pass over a ring of the ranks' ELL blocks (`world` steps,
        two shifts a step after the first -- the block and its row
        lengths; one step in one process)."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        steps = ctx.ring_size()
        n_pad = dev.fnum * dev.vp
        rows = dev.oe.edge_src.shape[0] * dev.vp
        base = getattr(dev, "fid_lo", 0) * dev.vp
        v, u = self._oriented_edges(dev, ctx)
        d = None
        if steps > 1:  # one block shape on every rank: the widest row
            widest = torch.bincount((v - base).long(), minlength=1).max()
            d = max(1, int(ctx.max(widest.reshape(1, 1))[0]))
        ell, cnt = self._ell(v - base, u, rows, n_pad, d)
        parts = pairs_by_block(v, u, rows, steps)
        cred = torch.zeros(n_pad, dtype=torch.int32, device=ell.device)
        blk_ell, blk_cnt = ell, cnt
        for s in range(steps):
            if s:
                blk_ell = ctx.ring_shift(blk_ell)
                blk_cnt = ctx.ring_shift(blk_cnt)
            q = ctx.ring_block(s)
            self._merge_pass(cred, *parts[q], (ell, cnt, base),
                             (blk_ell, blk_cnt, q * rows))
        if self.credit_mode != "apex":  # middle and far credits cross ranks
            cred = ctx.sum(cred.unsqueeze(0))
        # the slab's rows (every credit of apex mode is already one)
        return cred[base:base + rows].to(torch.int32).view(-1, dev.vp)

    def _merge_pass(self, cred, v, u, own, visiting) -> None:
        """Credit the pairs (v, u) into the pid-indexed `cred`: N+(v) is
        row v - base of `own` (ell, cnt, base), N+(u) row u - base of
        `visiting`.

        Pairs are grouped by the wider of their two ELL rows, rounded up
        to a power of two, and each group runs at that width W in chunks
        of about 2^22 lanes: the lanes cut off are padding in both rows
        (a query lane past cnt[v] never hits; N+(u) lies whole in its
        first W entries), so the credits are those of the full width D,
        at a cost that follows the rows' real lengths."""
        ell, cnt, base = own
        vis_ell, vis_cnt, vis_base = visiting
        d = ell.shape[1]
        width = torch.maximum(cnt[(v - base).long()],
                              vis_cnt[(u - vis_base).long()]).clamp(min=1)
        n_groups = max(1, (d - 1).bit_length() + 1)
        pow2 = 2 ** torch.arange(n_groups, device=ell.device)
        group = torch.searchsorted(pow2, width)  # 2^group >= width
        order = torch.argsort(group, stable=True)
        v, u = v[order], u[order]
        sizes = torch.bincount(group, minlength=n_groups).tolist()
        start = 0
        for g, size in enumerate(sizes):
            w = min(1 << g, d)
            ell_w, vis_w = ell[:, :w], vis_ell[:, :w]
            lanes = torch.arange(w, device=ell.device)
            chunk = max(1, (1 << 22) // w)
            for s in range(start, start + size, chunk):
                e = min(s + chunk, start + size)
                vv, uu = v[s:e].long(), u[s:e].long()
                vr, ur = vv - base, uu - vis_base
                q = ell_w[vr]  # [C, W] queries: N+(v)
                tgt = vis_w[ur]  # [C, W] sorted targets: N+(u)
                pos = torch.searchsorted(tgt, q)
                hit = ((tgt.gather(1, pos.clamp(max=w - 1)) == q)
                       & (pos < vis_cnt[ur].unsqueeze(1))
                       & (lanes < cnt[vr].unsqueeze(1)))
                c1 = hit.sum(1, dtype=torch.int32)
                cred.index_add_(0, vv, c1)  # apex
                if self.credit_mode == "apex":
                    continue
                cred.index_add_(0, uu, c1)  # middle
                far = q[hit].long()
                cred.index_add_(0, far,
                                torch.ones_like(far, dtype=torch.int32))
            start += size

    def inceval(self, ctx, dev, state):
        return state, 0

    def finalize(self, frag, state):
        return np.asarray(state["lcc"].numpy())


class ApexTriangleCount(LCCBeta):
    """k = 3 clique counting (used by models/kclique.py): the merge pass in
    apex mode, int32 counts per apex, each triangle counted once at its
    (degree, pid)-minimal corner, as every k of the clique apps counts."""

    credit_mode = "apex"
    result_format = "int"

    def init_state(self, frag, **kw):
        state = super().init_state(frag, **kw)
        state["tri"] = torch.zeros((getattr(frag, "fl", frag.fnum), frag.vp),
                                   dtype=torch.int32, device=frag.device)
        return state

    _emit = emit_counts

    def finalize(self, frag, state):
        return state["tri"].numpy().astype(np.int64)
