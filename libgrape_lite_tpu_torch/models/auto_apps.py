"""Auto-parallel app variants: `sssp_auto`, `bfs_auto`, `wcc_auto` and
`pagerank_auto` (with `pagerank_push`, `pagerank_push_opt`).

Counterpart of `libgrape_lite_tpu/models/auto_apps.py` (reference
`sssp_auto.h`, `bfs_auto.h`, `wcc_auto.h`, `pagerank_auto.h`).  These run
the SyncBuffer path: each fragment *pushes* its values along its
out-edges into proposals for all `fnum * vp` pids, the proposals of all
fragments are folded with the buffer's op (`AutoAppBase`,
`AutoParallelMessageManager.sync`) and each fragment adopts its slice.
Across processes a rank pushes from its slab of fragments into all
`fnum * vp` pids, and the sync's all_to_all brings each rank the
proposals for its own rows.
Results equal the base apps'; the execution differs, as the reference's
variants differ from theirs.

The push reads no staged delta overlay (dyn/), so `sssp_auto`,
`bfs_auto` and `wcc_auto` declare no overlay contract
(`dyn_overlay_support = False`): `Worker.query` refuses them while an
overlay holds staged edges, and they run on the repacked graph after
`DynGraph.fold_now()`.  The JAX package's classes inherit the contract
from SSSP, BFS and WCC and there compute on the stale base graph.  Their
incremental contract is kept: seeding on a repacked graph is sound.

The push is the gather-reduce kernel (K1) over a *push CSR*: per
fragment, its out-edges sorted stably by destination pid, so that row p
of fragment f lists the source pids `f * vp + src` of f's edges into p
(indptr `[fnum, fnum * vp + 1]`, weights permuted alike).  The push CSR
is built once per fragment on the device and cached (`push_csr`); a
query does not pay for it.  PageRank's proposals are per-row sums,
folded over fragments in fragment order: no float atomics.
"""

from __future__ import annotations

import torch

from libgrape_lite_tpu_torch.app.base import (
    AutoAppBase,
    StepContext,
    local_frags,
)
from libgrape_lite_tpu_torch.fragment.edgecut import (
    device_cache,
    device_cache_filled,
)
from libgrape_lite_tpu_torch.models.bfs import BFS, _SENTINEL
from libgrape_lite_tpu_torch.models.pagerank import PageRank
from libgrape_lite_tpu_torch.models.sssp import SSSP
from libgrape_lite_tpu_torch.models.wcc import WCC
from libgrape_lite_tpu_torch.ops import spmv

_PUSH = device_cache()


def push_csr(frag, side: str = "oe", dtype: torch.dtype | None = None):
    """The push CSR of `frag.dev.<side>`: (indptr [fl, fnum * vp + 1]
    int32, nbr [fl, Ep] int32 source pids, w [fl, Ep] in `dtype` or None
    without `dtype`), rows in destination pid order, each row's edges in
    their CSR order; `fl` is fnum single-process, the rank's slab
    `fid_lo ..` under a process group (source pids stay global).  Cached
    per (fragment, side, dtype)."""
    per = _PUSH.setdefault(frag, {})
    key = (side, dtype)
    if key not in per:
        csr = getattr(frag.dev, side)
        fnum, vp = frag.fnum, frag.vp
        fl, lo = local_frags(frag)
        n = fnum * vp
        dev = csr.indptr.device
        indptr = torch.zeros((fl, n + 1), dtype=torch.int32, device=dev)
        nbr = torch.zeros_like(csr.edge_nbr)
        w = (None if dtype is None else
             torch.zeros(csr.edge_nbr.shape, dtype=dtype, device=dev))
        for f, ne in enumerate(csr.indptr[:, -1].tolist()):
            dst = csr.edge_nbr[f, :ne]
            order = torch.sort(dst, stable=True).indices
            nbr[f, :ne] = (lo + f) * vp + csr.edge_src[f, :ne][order]
            if w is not None:
                w[f, :ne] = csr.edge_w[f, :ne][order].to(dtype)
            indptr[f, 1:] = torch.cumsum(
                torch.bincount(dst.long(), minlength=n), 0)
        per[key] = (indptr, nbr, w)
        device_cache_filled()
    return per[key]


def _push(csr, x, kind):
    indptr, nbr, w = csr
    return spmv.gather_reduce(indptr, nbr, w, x, kind)


def _own_slice_min(prop, local, fid_lo: int = 0):
    """Fold each fragment's own values into its slice of its proposals
    (a vertex always proposes its current value to itself): local
    fragment l's own slice is destination block `fid_lo + l`."""
    fl, vp = local.shape
    blocks = prop.view(fl, -1, vp)[:, fid_lo:fid_lo + fl]
    own = blocks.diagonal(dim1=0, dim2=1)  # [vp, fl]
    own.copy_(torch.minimum(own, local.T))
    return prop


class SSSPAuto(AutoAppBase, SSSP):
    """SSSP via SyncBuffer<dist, min> (reference sssp_auto.h)."""

    sync_buffers = {"dist": "min"}
    ephemeral_keys = frozenset()
    dyn_overlay_support = False  # the push reads no overlay
    lane_native = False  # its sources batch as per-lane states

    def init_state(self, frag, source=0):
        self._oe = push_csr(frag, "oe", self.dtype)
        return {"dist": self.initial_dist(frag, source)}

    def propose(self, ctx: StepContext, dev, state):
        dist = state["dist"]
        prop = _push(self._oe, ctx.gather_state(dist), "min")
        return {"dist": _own_slice_min(prop, dist, ctx.fid_lo)}


class BFSAuto(AutoAppBase, BFS):
    """BFS via SyncBuffer<depth, min> (reference bfs_auto.h)."""

    sync_buffers = {"depth": "min"}
    dyn_overlay_support = False  # the push reads no overlay
    lane_native = False  # its sources batch as per-lane states

    def init_state(self, frag, source=0):
        self._oe = push_csr(frag, "oe")
        return BFS.init_state(self, frag, source)

    def propose(self, ctx: StepContext, dev, state):
        depth = state["depth"]
        near = _push(self._oe, ctx.gather_state(depth), "min")
        prop = torch.where(near != _SENTINEL, near + 1, near)
        return {"depth": _own_slice_min(prop, depth, ctx.fid_lo)}


class WCCAuto(AutoAppBase, WCC):
    """WCC via SyncBuffer<comp, min> (reference wcc_auto.h): labels are
    pushed along both edge directions, each from the round's old labels
    (unlike WCC, whose second pull reads the labels the first folded)."""

    sync_buffers = {"comp": "min"}
    dyn_overlay_support = False  # the push reads no overlay

    def init_state(self, frag, **_):
        self._sides = [push_csr(frag, "oe")]
        if frag.directed:
            self._sides.append(push_csr(frag, "ie"))
        return WCC.init_state(self, frag)

    def propose(self, ctx: StepContext, dev, state):
        comp = state["comp"]
        full = ctx.gather_state(comp)
        prop = _push(self._sides[0], full, "min")
        for side in self._sides[1:]:
            prop = torch.minimum(prop, _push(side, full, "min"))
        return {"comp": _own_slice_min(prop, comp, ctx.fid_lo)}


class PageRankAuto(AutoAppBase, PageRank):
    """PageRank via SyncBuffer<rank, sum> (reference pagerank_auto.h):
    contributions are pushed along out-edges and summed over fragments."""

    sync_buffers = {"rank": "sum"}
    ephemeral_keys = frozenset()
    lane_native = False  # its lanes batch as per-lane states

    # PageRank's PEval (degree / dangling set-up) applies unchanged
    peval = PageRank.peval

    def init_state(self, frag, delta: float | None = None,
                   max_round: int | None = None, source=None):
        self._oe = push_csr(frag, "oe")
        state = PageRank.init_state(self, frag, delta, max_round, source)
        state.pop("spmv_row_lo", None)  # no pull, so no strict plan
        return state

    def propose(self, ctx: StepContext, dev, state):
        return {"rank": _push(self._oe, ctx.gather_state(state["rank"]),
                              "sum")}

    def update(self, ctx: StepContext, dev, state, combined):
        # the fold of the pushed contributions is the in-neighbour sum
        return self.round_update(dev, state, combined["rank"])


__all__ = ["BFSAuto", "PageRankAuto", "SSSPAuto", "WCCAuto", "push_csr"]
