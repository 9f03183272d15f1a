"""Triangle counts and the 2-hop common-neighbour query.

Counterpart of `libgrape_lite_tpu/models/triangle_count.py`:

  * `TriangleCount` -- per-vertex triangle counts T(v) and the global
    count T = sum T(v) / 3.  It is the bitmap LCC's credit pass (two
    `row_and_popcount_indexed` calls of the AND-popcount kernel, or the
    spgemm credit pass) with another emit tail: the counts instead of
    the coefficient, so they are integer-identical to the LCC credits by
    construction, under either `GRAPE_LCC_BACKEND`.  Under a process
    group a rank keeps its slab's counts (the N+ ring of `LCC.triangles`,
    or its fragments' spgemm items) and `finalize` reads the gathered
    ones, so `global_triangles` is the same on every rank.
  * `CommonNeighbors` -- cn(v) = |N(u) & N(v)| for a source u: two pulls
    of the one-hot source vector over the deduplicated out-adjacency
    (cn = A (A e_u)), each a gather-reduce (int32 kind `sum`); the final
    hop zeroes the source's own row (cn(u, u) is a degree).  The JAX
    package masks duplicate edges per edge; the kernel takes no per-edge
    mask for int32, so the deduplicated out-CSR is built once per
    fragment on the device and cached (`dedup_csr`), as the push CSR of
    models/auto_apps.py is.  Lane-native: a sequence of sources builds
    k one-hot lanes, and each hop pulls them all with one
    `gather_reduce_lanes` call (serve/, `Worker.query_batch`).  Under a
    process group each rank pulls its own rows of the deduplicated CSR
    from the gathered vector.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    ParallelAppBase,
    StepContext,
    source_lane_array,
)
from libgrape_lite_tpu_torch.models.lcc import LCC, dedup_mask, emit_counts
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class TriangleCount(LCC):
    """Per-vertex triangle counts; `global_triangles` after finalize (each
    triangle credits its three corners once)."""

    result_format = "int"

    def init_state(self, frag, degree_threshold: int = 0, **_):
        state = super().init_state(frag, degree_threshold=degree_threshold)
        state.pop("lcc")
        # the slab's rows under a process group (`LCC.triangles` and the
        # spgemm pass cut their credits to them)
        state["tri"] = torch.zeros((getattr(frag, "fl", frag.fnum), frag.vp),
                                   dtype=torch.int32, device=frag.device)
        return state

    _emit = emit_counts


    def invariants(self, frag, state):
        from libgrape_lite_tpu_torch.guard.invariants import in_range

        # a triangle count is a non-negative cardinality
        return [in_range("tri", lo=0)]

    def finalize(self, frag, state):
        # the gathered [fnum, vp] counts (`Worker.result_values`): the
        # same global count on every rank
        vals = state["tri"].numpy().astype(np.int64)
        self.global_triangles = int(vals[frag.host_inner_mask()].sum() // 3)
        return vals


_DEDUP: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def dedup_csr(frag):
    """(indptr [fl, vp + 1] int32, nbr [fl, E'] int32) of frag.dev.oe
    without repeated (src, nbr) pairs, edges in CSR order: this process's
    rows (every fragment single-process, the rank's slab under a group),
    columns global pids.  Built once per fragment on the device and
    cached."""
    if frag not in _DEDUP:
        oe = frag.dev.oe
        fl, vp = oe.edge_src.shape[0], frag.vp
        keep = dedup_mask(oe)
        rows = torch.where(keep, oe.edge_src, vp).long()
        deg = torch.zeros((fl, vp + 1), dtype=torch.int64,
                          device=keep.device)
        deg.scatter_add_(1, rows, torch.ones_like(rows))
        indptr = torch.zeros((fl, vp + 1), dtype=torch.int32,
                             device=keep.device)
        indptr[:, 1:] = torch.cumsum(deg[:, :vp], dim=1)
        f, e = keep.nonzero(as_tuple=True)
        slot = torch.cumsum(keep, dim=1)[f, e] - 1
        nbr = torch.zeros((fl, max(1, int(deg[:, :vp].sum(1).max()))),
                          dtype=torch.int32, device=keep.device)
        nbr[f, slot] = oe.edge_nbr[f, e]
        _DEDUP[frag] = (indptr, nbr)
    return _DEDUP[frag]


class CommonNeighbors(ParallelAppBase):
    """cn(v) = |N(u) & N(v)| for a query source u (neighbours, not
    parallel edges, as the LCC family counts)."""

    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"
    replicated_keys = frozenset({"hop"})
    max_rounds = 8  # 2 pull rounds; the vote ends the query after hop 2
    # the round vote is the hop counter's, the same on every rank
    replicated_vote = True
    batch_query_key = "source"  # serve/: k sources, one pull a hop
    lane_native = True

    def init_state(self, frag, source=-1, **_):
        self._csr = dedup_csr(frag)
        batched, seed = source_lane_array(frag, source, "CommonNeighbors",
                                          0, 1, torch.int32)
        seed = seed if batched else seed[0]
        return {"cn": seed.clone(), "seed": seed,
                "hop": torch.zeros(seed.shape[:-2], dtype=torch.int32,
                                   device=frag.device)}

    def peval(self, ctx: StepContext, dev, state):
        return state, 1

    def inceval(self, ctx: StepContext, dev, state):
        indptr, nbr = self._csr
        pulled = spmv.pull(indptr, nbr, None, ctx.gather_lanes(state["cn"]),
                           "sum")
        hop = state["hop"] + 1
        done = hop >= 2
        # the final hop zeroes the source row and masks padding
        last = torch.where(dev.inner_mask & (state["seed"] == 0), pulled, 0)
        cn = torch.where(done[..., None, None], last, pulled)
        return dict(state, cn=cn, hop=hop), torch.where(done, 0, 1)


    def invariants(self, frag, state):
        from libgrape_lite_tpu_torch.guard.invariants import in_range

        return [in_range("cn", lo=0)]

    def finalize(self, frag, state):
        return state["cn"].numpy().astype(np.int64)
