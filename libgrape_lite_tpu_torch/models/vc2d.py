"""2-D vertex-cut min-fold apps: SSSP, BFS and WCC on the k x k tiles.

Counterpart of `libgrape_lite_tpu/models/vc2d.py`.  Tile (i, j) holds the
edges with src in chunk i and dst in chunk j (undirected graphs are
symmetrised at build, so one dst-side pull a round covers both
directions); the master carry (`dist` / `depth` / `comp`) is gpid-indexed
by tile row: the chunks of the tile rows a context holds, [nr * vc]
(one [k * vc] vector with one process).

A round (`inceval`):

  1. the tile partials: ONE K1 call (`ops/spmv.py::pull`, kind min) over
     the fragment's concatenated ie tile CSR gathers each edge's source
     value (plus its weight for SSSP) into its tile's dst row -- [k, k,
     vc] partials, tile (i, j) folding chunk j's rows;
  2. the row-axis min (`VCStepContext.row_min`, the JAX package's pmin
     over `VC_ROW_AXIS`) folds the k partials of each column, completing
     chunk j, and `cols_to_rows` re-aligns it to the carry's tile rows
     (the JAX package's transpose; the identity with one process);
  3. directed WCC also pulls the src side over the oe tile CSR from the
     carry's column copy (`rows_to_cols`) and folds it over the column
     axis (`col_min`, `VC_COL_AXIS`);
  4. the master fold `min(val, relax)` and the vote, the changed real
     vertices counted once (`count_rows`).

Across ranks (a CommSpec with a process group) the carry keeps that
layout, the JAX package's P(VC_ROW_AXIS): a rank holds the chunks of its
tile rows, nr * vc values, and its slab's ie CSR reads them locally.  A round
moves the rank's [nc, vc] column partials through one all_reduce over
its row-axis group and, where the rank does not hold every tile column,
one tile transpose of its fl [vc] blocks (`CommSpec.vc_transpose`); the
vote is one int64 all_reduce over the row-axis group.  At 4-byte values
that is 4 * nc * vc + 4 * fl * vc + 8 bytes a rank a round (RMAT-20, k
2, vc 524,288: 2 ranks 4 MiB + 8 B, 4 ranks 4 MiB + 8 B), against the
JAX mesh's vc reduction and vc transpose a tile.  Directed WCC adds its
column copy's transpose and a column-axis all_reduce.  The result gather
(`Worker.result_values`) joins the row chunks of the row-axis group.

min is exact in any grouping and every candidate is computed from the
operands the 1-D pull uses, so SSSP, BFS and WCC are bit-equal to the
1-D apps (gpid order is oid order, so WCC's representative is the
min-oid member there too).  A sequence of sources (SSSP, BFS) builds
[B, k * vc] lanes pulled by one `gather_reduce_lanes` call a round.

`GRAPE_PIPELINE` (parallel/pipeline.py::resolve_vc2d_pipeline) runs the
pipelined round (`inceval_pipelined`): two K1 calls over a static phase
split of the rank's tile CSR, the phase-0 row reduction kicked on a side
stream (across ranks the row-axis all_reduce, issued asynchronously)
while the phase-1 K1 pulls, joined by min(r0, r1) -- bit-equal, as min
regroups exactly.  Directed WCC's src pull declines (a dependent chain),
as in the JAX package; pagerank_vc resolves no plan.

Not carried over: the TPU pack plans of the tiles (`_resolve_tile_packs`,
`GRAPE_SPMV=pack`: TPU data movement; K1 is the port's pull).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    GatherScatterAppBase,
    VCStepContext,
    is_lane_sequence,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel.pipeline import resolve_vc2d_pipeline
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_INT_SENT = np.iinfo(np.int32).max
_OUT_SENTINEL = np.iinfo(np.int64).max  # BFS prints the reference's max
_LOG = logging.getLogger(__name__)


def vc_source_carry(frag, source, app_name: str, fill, hit,
                    dtype: torch.dtype) -> torch.Tensor:
    """The gpid-space carry of the fragment's tile rows ([nr * vc], [k *
    vc] with one process) seeded at `source` -- or [B, nr * vc] for a
    sequence of B sources (the batched lanes), on the fragment's device.
    A source outside the oid space leaves its lane all `fill`, logged as
    the 1-D apps log an absent source."""
    batched = is_lane_sequence(source)
    srcs = np.asarray(source if batched else [source],
                      dtype=np.int64).reshape(-1)
    arr = torch.full((len(srcs), frag.k * frag.vc), fill, dtype=dtype,
                     device=frag.device)
    for b, s in enumerate(srcs.tolist()):
        if 0 <= s < frag.k * frag.chunk:
            arr[b, int(frag.oid_to_gpid(np.array([s]))[0])] = hit
        else:
            _LOG.warning("%s: source %r is outside the oid space; all "
                         "vertices will be unreachable", app_name, s)
    lo, hi = frag.chunk_span("row")
    arr = arr[:, lo:hi].contiguous()
    return arr if batched else arr[0]


def vc_finalize_rows(frag, flat) -> np.ndarray:
    """A gpid-space [k * vc] result (every chunk: across ranks the
    gathered carry) as [fnum, vc] rows in inner_oids order (masters on
    the diagonal tiles): the Worker's output contract for every
    vertex-cut app."""
    vals = np.asarray(flat).reshape(frag.k, frag.vc)
    out = np.zeros((frag.fnum, frag.vc), dtype=vals.dtype)
    for c in range(frag.k):
        oids = frag.inner_oids(c * frag.k + c)
        out[c * frag.k + c, :len(oids)] = vals[c, oids % frag.chunk]
    return out


def tile_pull(ctx: VCStepContext, side, w, x: torch.Tensor,
              kind: str) -> torch.Tensor:
    """One K1 call over an orientation's concatenated tile CSR: x [N] or
    [B, N] gathered by gpid -> the [..., k, k, vc] tile partials."""
    if side is None:
        raise ValueError(
            "this app pulls the src side of the tiles, which symmetrised "
            "storage does not place; build the vertex-cut fragment with "
            "symmetrize=False")
    return ctx.tiles(spmv.pull(side.indptr, side.nbr, w, x, kind))


class VC2DMinAppBase(GatherScatterAppBase):
    """The shared scaffolding of the tropical-min vertex-cut apps: the
    carry, the round and the diagonal-master finalize.  Subclasses
    declare `state_key` and the tile partials."""

    load_strategy = LoadStrategy.kNullLoadStrategy
    message_strategy = MessageStrategy.kGatherScatter
    mesh_kind = "vc2d"
    state_key = ""  # the carry leaf ("dist" / "depth" / "comp")

    @property
    def vc_row_keys(self) -> frozenset:
        """The carry leaves chunk-indexed by tile row (the worker gathers
        and cuts them by the grid)."""
        return frozenset({self.state_key})

    def _init_common(self, frag, carry: torch.Tensor, eph=None):
        """The carry and ephemeral leaves, the pipelined round's plan (a
        single query's; batched lanes keep the serial round) and the
        partition record the query span carries (trace_report's tile
        table)."""
        self._partition = "2d"
        self._mesh_k = frag.k
        self._partition_stats = frag.tile_stats()
        self._src_pull = self._wants_src_pull(frag)
        eph = dict(eph or {})
        self._pipeline = None
        if carry.dim() == 1:
            w = eph.get("w_eff")
            self._pipeline = resolve_vc2d_pipeline(
                frag, app_name=type(self).__name__, src_pull=self._src_pull,
                dtype_bytes=carry.element_size(), weighted=w is not None,
                w_dtype=None if w is None else w.dtype)
            if self._pipeline is not None:
                eph.update(self._pipeline.host_entries)
        self.ephemeral_keys = frozenset(eph)
        return {self.state_key: carry, **eph}

    def _wants_src_pull(self, frag) -> bool:
        """Directed WCC pulls the src side too; undirected tiles are
        symmetrised instead."""
        return False

    def peval(self, ctx, dev, state):
        # as the 1-D pull apps: the first pull round subsumes the
        # reference's source-only PEval
        return state, 1

    def _tile_fold(self, ctx, indptr, nbr, w, val) -> torch.Tensor:
        """[..., k, k, vc] partials of one K1 call over a tile CSR of the
        pull into dst (all the tiles' edges, or a phase's)."""
        return ctx.tiles(spmv.pull(indptr, nbr, w, val, "min"))

    def _dst_partial(self, ctx, dev, val, state) -> torch.Tensor:
        """[..., k, k, vc] partials of the pull into dst: one K1 call."""
        return self._tile_fold(ctx, dev.ie.indptr, dev.ie.nbr,
                               state.get("w_eff"), val)

    def _src_partial(self, ctx, dev, val, state) -> torch.Tensor:
        """[..., k, k, vc] partials of the pull into src (directed WCC)."""
        raise NotImplementedError

    def inceval(self, ctx: VCStepContext, dev, state):
        val = state[self.state_key]
        relax = ctx.flat(ctx.cols_to_rows(ctx.row_min(
            self._dst_partial(ctx, dev, val, state))))
        if self._src_pull:
            val_col = ctx.flat(ctx.rows_to_cols(ctx.chunks(val)))
            relax = torch.minimum(relax, ctx.flat(ctx.col_min(
                self._src_partial(ctx, dev, val_col, state))))
        new = torch.minimum(val, relax)
        changed = (new < val) & dev.vmask
        return {**state, self.state_key: new}, ctx.count_rows(changed)

    def pipeline_exchange(self, ctx, dev, state):
        """The vertex-cut round carries no buffer across rounds: the row
        reduction completes inside the round."""
        return None

    def inceval_pipelined(self, ctx: VCStepContext, dev, state, xbuf):
        """The two-phase round: the phase-0 K1 pull, its row reduction
        kicked off on the side stream (across ranks the row-axis group's
        all_reduce, issued asynchronously), the phase-1 K1 pull under
        it, the join, min(r0, r1).  min over disjoint edge sets of the
        same candidates is the serial row_min bit for bit."""
        pl = self._pipeline
        val = state[self.state_key]
        p0 = self._tile_fold(ctx, state["pl_p0_indptr"], state["pl_p0_nbr"],
                             state.get("pl_p0_w"), val)
        r0 = pl.kickoff(ctx, p0)
        # ---- pipelined window: every carry read below is named in
        # parallel/pipeline.PIPELINE_WINDOW_READS (grape-lint R6) ----
        w1 = state["pl_p1_w"] if "pl_p1_w" in state else None
        r1 = ctx.row_min(self._tile_fold(ctx, state["pl_p1_indptr"],
                                         state["pl_p1_nbr"], w1, val))
        pl.join()
        new = torch.minimum(val, ctx.flat(ctx.cols_to_rows(
            torch.minimum(r0, r1))))
        changed = (new < val) & dev.vmask
        return {self.state_key: new}, ctx.count_rows(changed), xbuf

    def finalize(self, frag, state):
        return vc_finalize_rows(frag, state[self.state_key].numpy())


class SSSPVC2D(VC2DMinAppBase):
    """SSSP on the tiles: `min(dist[src] + w)` a tile (K1 float32 min
    with weights), completed by the row-axis min -- bit-equal to the
    1-D pull."""

    state_key = "dist"
    result_format = "sssp_infinity"
    needs_edata = True
    batch_query_key = "source"
    lane_native = True

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def init_state(self, frag, source=0):
        if not frag.weighted:
            raise ValueError(
                "SSSP requires edge weights; build the vertex-cut fragment "
                "with weights (use bfs_vc for unit-weight traversal)")
        dist = vc_source_carry(frag, source, "SSSPVC2D", float("inf"), 0.0,
                               self.dtype)
        # K1 takes the weights in the carry's type: cast once a query
        return self._init_common(frag, dist,
                                 {"w_eff": frag.dev.ie.w.to(self.dtype)})

    def invariants(self, frag, state):
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [in_range("dist", lo=0.0), monotone_non_increasing("dist")]


def _plus_one(near: torch.Tensor) -> torch.Tensor:
    """min(d) + 1 == min(d + 1); the sentinel (no reached neighbour)
    stays the sentinel."""
    return torch.where(near != _INT_SENT, near + 1, near)


class BFSVC2D(VC2DMinAppBase):
    """BFS levels on the tiles: int32 min of the neighbours' depths (K1
    int32 min), plus the hop -- bit-equal to the 1-D pull."""

    state_key = "depth"
    result_format = "int"
    batch_query_key = "source"
    lane_native = True

    def init_state(self, frag, source=0):
        depth = vc_source_carry(frag, source, "BFSVC2D", _INT_SENT, 0,
                                torch.int32)
        return self._init_common(frag, depth)

    def _tile_fold(self, ctx, indptr, nbr, w, val):
        return _plus_one(super()._tile_fold(ctx, indptr, nbr, w, val))

    def invariants(self, frag, state):
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [in_range("depth", lo=0, hi=_INT_SENT),
                monotone_non_increasing("depth")]

    def finalize(self, frag, state):
        out = vc_finalize_rows(frag, state["depth"].numpy().astype(np.int64))
        return np.where(out == _INT_SENT, _OUT_SENTINEL, out)


class WCCVC2D(VC2DMinAppBase):
    """WCC on the tiles: min-gpid label propagation (K1 int32 min).  gpid
    order is oid order, so the converged representative is the min-oid
    member, the vertex the 1-D path canonicalises to.

    Directed raw storage pulls both tile orientations a round from the
    same carry; the fixed point is the same, but round counts can differ
    from the 1-D path's dependent second pull, so the bit-equality holds
    for the symmetrised form (run_app always symmetrises wcc_vc)."""

    state_key = "comp"
    result_format = "int"

    def _wants_src_pull(self, frag) -> bool:
        return bool(frag.directed) and not frag.symmetrized

    def init_state(self, frag, **_):
        lo, hi = frag.chunk_span("row")
        gpids = torch.arange(lo, hi, dtype=torch.int32, device=frag.device)
        comp = torch.where(frag.dev.vmask, gpids,
                           torch.full_like(gpids, _INT_SENT))
        return self._init_common(frag, comp)

    def _src_partial(self, ctx, dev, val, state):
        return tile_pull(ctx, dev.oe, None, val, "min")

    def invariants(self, frag, state):
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [in_range("comp", lo=0, hi=_INT_SENT),
                monotone_non_increasing("comp")]

    def finalize(self, frag, state):
        out = vc_finalize_rows(frag, state["comp"].numpy().astype(np.int64))
        # label -> representative oid: gpid encodes the oid
        return np.where(out == _INT_SENT, -1, frag.gpid_to_oid(out))
