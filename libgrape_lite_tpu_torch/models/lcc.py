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

N+ and N- are packed bitmaps `[fnum * vp, words]` (`utils/bitset.py`)
and the intersections run in the row AND-popcount kernel
(`ops/intersect.py`, indexed form).  All fragments sit on one device, so
the JAX package's ring of bitmap blocks (`ppermute` between shards)
becomes a pid index: each edge reads the row of its neighbour's pid
directly, and the far-end credits land in one pid-indexed vector.  The
kernel runs over the kept (oriented, deduplicated) edges only, compacted
once.  Triangle counts are int32 sums, exact in any order, so counts and
lcc values equal the JAX package's bit for bit.

Bitmaps cost (fnum * vp)^2 / 8 bytes each: 8 GiB at 2^18 vertices, which
is why `lcc` (LCCBeta, sorted neighbour lists) is the registry default.

`GRAPE_LCC_BACKEND` = intersect (default) | spgemm | auto picks how the
credits are counted (`ops/spgemm_pack.py`): `spgemm` resolves a host plan
of pruned [128, 128]-bit tile products at `init_state`, ships its streams
as ephemeral state, and takes the credits from the device pass over them.
Both backends give the same int32 per-vertex counts and feed the same
emit tail, so every output bit is backend-independent.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.ops import intersect, spgemm_pack
from libgrape_lite_tpu_torch.utils.bitset import pack_bits
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


def row_pids(dev, csr) -> torch.Tensor:
    """[fnum, Ep] int32 pid of each edge's row (pad edges clamp to the
    last row of their fragment; callers mask them out)."""
    base = torch.arange(dev.fnum, dtype=torch.int32,
                        device=csr.edge_src.device).unsqueeze(1) * dev.vp
    return base + csr.edge_src.clamp(max=dev.vp - 1)


def dedup_mask(csr) -> torch.Tensor:
    """Real edges that do not repeat the (src, nbr) pair before them;
    the CSR is sorted by (src, nbr), so multi-edges are adjacent."""
    s, n = csr.edge_src, csr.edge_nbr
    dup = torch.zeros_like(csr.edge_mask)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (n[:, 1:] == n[:, :-1])
    return csr.edge_mask & ~dup


def emit_counts(self, dev, state, tri):
    """An `_emit` that keeps the [fnum, vp] int32 triangle counts of the
    inner vertices as state["tri"] (the counting apps' result)."""
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
        state = {"lcc": torch.zeros((frag.fnum, frag.vp),
                                    dtype=torch.float64, device=frag.device)}
        self.lcc_backend = spgemm_pack.resolve_lcc_backend(
            type(self).__name__, frag,
            degree_threshold=self.degree_threshold)
        self._spgemm = None
        self.ephemeral_keys = frozenset()
        if self.lcc_backend == "spgemm":
            self._spgemm = spgemm_pack.resolve_spgemm_dispatch(
                frag, degree_threshold=self.degree_threshold)
            entries = self._spgemm.state_entries()
            state.update(entries)
            self.ephemeral_keys = frozenset(entries)
        return state

    def peval(self, ctx: StepContext, dev, state):
        if self.lcc_backend == "spgemm":
            tri = self._spgemm.credits(state).view(dev.fnum, dev.vp)
        else:
            tri = self.triangles(dev, state)
        return self._emit(dev, state, tri), 0

    def inceval(self, ctx: StepContext, dev, state):
        return state, 0

    def _emit(self, dev, state, tri):
        """The result state from the [fnum, vp] int32 triangle credits:
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
        """(keep [fnum, Ep] bool, row pid [fnum, Ep]): toward_nbr keeps
        edges oriented row -> nbr, otherwise nbr -> row."""
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

    def pair_operands(self, dev):
        """The bitmaps N+ and N- and the kept pairs of the two passes:
        (bplus, bminus, (v, u) oriented oe edges v -> u, (w, t) oriented
        ie edges t -> w), pairs as int32 pids."""
        n_pad = dev.fnum * dev.vp
        deg = dev.out_degree.reshape(-1)
        oe, ie = dev.oe, dev.ie
        keep_oe, row_oe = self._oriented(dev, oe, deg, True)
        keep_ie, row_ie = self._oriented(dev, ie, deg, False)
        bplus = pack_bits(oe.edge_nbr, keep_oe, n_pad, row_oe, n_pad)
        bminus = pack_bits(ie.edge_nbr, keep_ie, n_pad, row_ie, n_pad)
        return (bplus, bminus, (row_oe[keep_oe], oe.edge_nbr[keep_oe]),
                (row_ie[keep_ie], ie.edge_nbr[keep_ie]))

    def triangles(self, dev, state) -> torch.Tensor:
        """[fnum, vp] int32 triangle credits per vertex (the JAX
        package's `_tri_intersect`).  AND commutes, so the lower endpoint
        of each pair indexes the first operand: the one whose non-zero
        words the plain version expands."""
        bplus, bminus, (v, u), (w, t) = self.pair_operands(dev)
        tri = torch.zeros(dev.fnum * dev.vp, dtype=torch.int32,
                          device=bplus.device)
        cnt = intersect.row_and_popcount_indexed(bplus, u, bplus, v)
        tri.index_add_(0, v.long(), cnt)  # apex
        tri.index_add_(0, u.long(), cnt)  # middle
        cnt = intersect.row_and_popcount_indexed(bplus, t, bminus, w)
        tri.index_add_(0, w.long(), cnt)  # far end
        return tri.view(dev.fnum, dev.vp)


    def invariants(self, frag, state):
        # a clustering coefficient is a triangle fraction: [0, 1] on a
        # deduplicated simple graph (in_range also rejects NaN)
        from libgrape_lite_tpu_torch.guard.invariants import in_range

        return [in_range("lcc", lo=0.0, hi=1.0)]

    def finalize(self, frag, state):
        return np.asarray(state["lcc"].numpy())
