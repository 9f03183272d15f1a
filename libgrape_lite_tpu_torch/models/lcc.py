"""LCC -- local clustering coefficient on packed adjacency bitmaps.

Counterpart of `libgrape_lite_tpu/models/lcc.py` (reference
`examples/analytical_apps/lcc/lcc.h` and the set intersection of
`lcc_opt.h:26-41`).  The deduplicated undirected
graph is oriented into a DAG by (degree, pid): u is in N+(v) iff
deg(u) < deg(v), or the degrees tie and pid(u) < pid(v).  Every triangle
then has one apex v with v->u, v->w, u->w, and each corner earns one
credit:

  * for each oriented edge v->u, |N+(v) & N+(u)| credits v (apex) and u
    (middle);
  * for each oriented edge u->w (u in N-(w)), |N-(w) & N+(u)| credits w
    (far end).

lcc(v) = 2 T(v) / (deg(v) (deg(v) - 1)), deg the raw out-degree with
multiplicity (`lcc_context.h:52-68`).

N+ and N- are packed bitmaps `[fl * vp, words]` over a rank's slab of
fragments (`utils/bitset.py`; every fragment, `fl = fnum`, in one
process), with `words` covering all `fnum * vp` pids, and the
intersections run in the row AND-popcount kernel (`ops/intersect.py`,
indexed form).  The JAX package rings bitmap blocks between shards
(`ppermute`); here the ring runs between ranks (`Communicator.
ring_shift`): at step s a rank holds rank (r + s)'s N+ block and
intersects the kept pairs whose neighbour lies in it, so one process's
single step reads every row by pid directly.  Apex and far-end credits
land on the slab's rows, middle credits on the visiting block's; one
pid-indexed vector folded across ranks (`ctx.sum`) holds them all.  The
kernel runs over the kept (oriented, deduplicated) edges only, compacted
once.  Triangle counts are int32 sums, exact in any order, so counts and
lcc values equal the JAX package's bit for bit at every process count.

Bitmaps cost (fnum * vp)^2 / 8 bytes each: 8 GiB at 2^18 vertices, which
is why `lcc` (LCCBeta, sorted neighbour lists) is the registry default.

`GRAPE_LCC_BACKEND` = intersect (default) | spgemm | auto picks how the
credits are counted (`ops/spgemm_pack.py`): `spgemm` resolves a host plan
of pruned [128, 128]-bit tile products at `init_state`, ships its streams
as ephemeral state, and takes the credits from the device pass over them.
Both backends give the same int32 per-vertex counts and feed the same
emit tail, so every output bit is backend-independent.  Under a process
group every rank plans (or loads) the whole host plan, keeps its
fragments' rows of the streams (the items whose apex is one of its
rows), and folds the pid-indexed credits across ranks (`ctx.sum`, the
JAX package's psum), cut to its slab.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.ops import intersect, spgemm_pack
from libgrape_lite_tpu_torch.utils.bitset import pack_bits
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


def row_pids(dev, csr) -> torch.Tensor:
    """[fl, Ep] int32 global pid of each edge's row on the slab's
    fragments `fid_lo ..` (pad edges clamp to the last row of their
    fragment; callers mask them out)."""
    fl = csr.edge_src.shape[0]
    base = (torch.arange(fl, dtype=torch.int32, device=csr.edge_src.device)
            + getattr(dev, "fid_lo", 0)).unsqueeze(1) * dev.vp
    return base + csr.edge_src.clamp(max=dev.vp - 1)


def pairs_by_block(a, b, rows: int, blocks: int) -> list:
    """The pairs (a, b) cut by the ring block of `b` (block q holds pids
    `[q * rows, (q + 1) * rows)`): a list of `blocks` (a, b) pairs, each
    in the input's order.  One block is the input itself."""
    if blocks == 1:
        return [(a, b)]
    blk = b.div(rows, rounding_mode="floor")
    order = torch.argsort(blk, stable=True)
    sizes = torch.bincount(blk, minlength=blocks).tolist()
    return list(zip(a[order].split(sizes), b[order].split(sizes)))


def dedup_mask(csr) -> torch.Tensor:
    """Real edges that do not repeat the (src, nbr) pair before them;
    the CSR is sorted by (src, nbr), so multi-edges are adjacent."""
    s, n = csr.edge_src, csr.edge_nbr
    dup = torch.zeros_like(csr.edge_mask)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (n[:, 1:] == n[:, :-1])
    return csr.edge_mask & ~dup


def slab_credits(ctx, dev, cred) -> torch.Tensor:
    """[fl, vp] int32: a rank's pid-indexed [fnum * vp] credits folded
    with every rank's (`ctx.sum`), cut to the slab's rows (the whole
    stack in one process)."""
    rows = dev.oe.edge_src.shape[0] * dev.vp
    base = getattr(dev, "fid_lo", 0) * dev.vp
    tri = ctx.sum(cred.unsqueeze(0))[base:base + rows]
    return tri.to(torch.int32).view(-1, dev.vp)


def emit_counts(self, dev, state, tri):
    """An `_emit` that keeps the [fl, vp] int32 triangle counts of the
    slab's inner vertices as state["tri"] (the counting apps' result)."""
    return dict(state, tri=torch.where(dev.inner_mask, tri, 0))


class LCC(ParallelAppBase):
    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    result_format = "float"

    def __init__(self):
        self.degree_threshold = 0
        self.lcc_backend = "intersect"
        self._spgemm = None  # the spgemm dispatch, when that backend runs

    def init_state(self, frag, degree_threshold: int = 0, **_):
        # degree_threshold > 0 drops hub vertices' neighbour lists (the
        # reference's cost cap, `lcc.h:234-243`); 0 disables it
        self.degree_threshold = int(degree_threshold)
        fl = getattr(frag, "fl", frag.fnum)
        state = {"lcc": torch.zeros((fl, frag.vp),
                                    dtype=torch.float64, device=frag.device)}
        self.lcc_backend = spgemm_pack.resolve_lcc_backend(
            type(self).__name__, frag,
            degree_threshold=self.degree_threshold)
        self._spgemm = None
        self.ephemeral_keys = frozenset()
        if self.lcc_backend == "spgemm":
            self._spgemm = spgemm_pack.resolve_spgemm_dispatch(
                frag, degree_threshold=self.degree_threshold)
            # this rank's fragments' rows of the plan's [fnum, ...] streams
            entries = self._spgemm.state_entries(
                getattr(frag, "fid_lo", 0), fl)
            state.update(entries)
            self.ephemeral_keys = frozenset(entries)
        return state

    def peval(self, ctx: StepContext, dev, state):
        if self.lcc_backend == "spgemm":
            tri = slab_credits(ctx, dev, self._spgemm.credits(state))
        else:
            tri = self.triangles(dev, state, ctx)
        return self._emit(dev, state, tri), 0

    def inceval(self, ctx: StepContext, dev, state):
        return state, 0

    def _emit(self, dev, state, tri):
        """The result state from the slab's [fl, vp] int32 credits:
        here the clustering coefficient (TriangleCount keeps the counts)."""
        deg = dev.out_degree
        d = deg.to(torch.float64)
        denom = d * (d - 1)
        lcc = torch.where(dev.inner_mask & (deg >= 2),
                          2.0 * tri.to(torch.float64) / denom.clamp(min=1),
                          torch.zeros((), dtype=torch.float64,
                                      device=d.device))
        return dict(state, lcc=lcc.to(state["lcc"].dtype))

    def _oriented(self, dev, csr, deg, toward_nbr: bool):
        """(keep [fl, Ep] bool, row pid [fl, Ep]): toward_nbr keeps
        edges oriented row -> nbr, otherwise nbr -> row; `deg` is the
        whole graph's [fnum * vp] degree."""
        row = row_pids(dev, csr)
        nbr = csr.edge_nbr
        d_row, d_nbr = deg[row.long()], deg[nbr.long()]
        if toward_nbr:
            k = (d_nbr < d_row) | ((d_nbr == d_row) & (nbr < row))
        else:
            k = (d_row < d_nbr) | ((d_nbr == d_row) & (row < nbr))
        if self.degree_threshold > 0:
            # a filtered vertex contributes no N+ list (lcc.h:98,164): its
            # owner is the row when orienting row -> nbr, else the nbr
            owner = d_row if toward_nbr else d_nbr
            k &= owner <= self.degree_threshold
        return dedup_mask(csr) & k, row

    def pair_operands(self, dev, ctx=None):
        """The slab's bitmaps N+ and N- (rows `fid_lo * vp ..`, the whole
        stack in one process) and the kept pairs of the two passes:
        (bplus, bminus, (v, u) oriented oe edges v -> u, (w, t) oriented
        ie edges t -> w), pairs as int32 global pids.  `ctx` gathers the
        degrees across ranks (the single-process context by default)."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        n_pad = dev.fnum * dev.vp
        deg = ctx.gather_state(dev.out_degree)
        oe, ie = dev.oe, dev.ie
        rows = oe.edge_src.shape[0] * dev.vp
        base = getattr(dev, "fid_lo", 0) * dev.vp
        keep_oe, row_oe = self._oriented(dev, oe, deg, True)
        keep_ie, row_ie = self._oriented(dev, ie, deg, False)
        bplus = pack_bits(oe.edge_nbr, keep_oe, rows, row_oe - base, n_pad)
        bminus = pack_bits(ie.edge_nbr, keep_ie, rows, row_ie - base, n_pad)
        return (bplus, bminus, (row_oe[keep_oe], oe.edge_nbr[keep_oe]),
                (row_ie[keep_ie], ie.edge_nbr[keep_ie]))

    def triangles(self, dev, state, ctx=None) -> torch.Tensor:
        """[fl, vp] int32 triangle credits per vertex of the slab (the
        JAX package's `_tri_intersect`), over a ring of the ranks' N+
        blocks: step s intersects the pairs whose neighbour lies in the
        block held (rank r + s's), then shifts it on -- `world` steps,
        `world - 1` shifts, one step in one process.  AND commutes, so
        the visiting block, indexed by the neighbour, is the first
        operand: the one whose non-zero words the plain version
        expands (the lower endpoint of each oe pair)."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        bplus, bminus, (v, u), (w, t) = self.pair_operands(dev, ctx)
        rows = bplus.shape[0]
        base = getattr(dev, "fid_lo", 0) * dev.vp
        steps = ctx.ring_size()
        oe_parts = pairs_by_block(v, u, rows, steps)
        ie_parts = pairs_by_block(w, t, rows, steps)
        cred = torch.zeros(dev.fnum * dev.vp, dtype=torch.int32,
                           device=bplus.device)
        block = bplus
        for s in range(steps):
            if s:
                block = ctx.ring_shift(block)
            q = ctx.ring_block(s)
            (vq, uq), (wq, tq) = oe_parts[q], ie_parts[q]
            cnt = intersect.row_and_popcount_indexed(block, uq - q * rows,
                                                     bplus, vq - base)
            cred.index_add_(0, vq.long(), cnt)  # apex
            cred.index_add_(0, uq.long(), cnt)  # middle
            cnt = intersect.row_and_popcount_indexed(block, tq - q * rows,
                                                     bminus, wq - base)
            cred.index_add_(0, wq.long(), cnt)  # far end
        return slab_credits(ctx, dev, cred)


    def invariants(self, frag, state):
        # a clustering coefficient is a triangle fraction: [0, 1] on a
        # deduplicated simple graph (in_range also rejects NaN)
        from libgrape_lite_tpu_torch.guard.invariants import in_range

        return [in_range("lcc", lo=0.0, hi=1.0)]

    def finalize(self, frag, state):
        return np.asarray(state["lcc"].numpy())
