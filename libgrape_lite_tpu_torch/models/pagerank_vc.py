"""PageRankVC: PageRank on vertex-cut storage by gather-scatter.

Counterpart of `libgrape_lite_tpu/models/pagerank_vc.py` (reference
`examples/analytical_apps/pagerank/pagerank_vc.h` and
`GatherScatterMessageManager`,
`grape/parallel/gather_scatter_message_manager.h:28-399`):

  * a vertex's degree counts each of its appearances as src or dst in
    the raw (unsymmetrised) edge list;
  * a round sends `rank[src]` to dst and `rank[dst]` to src over every
    edge, sums the partials at the masters and updates
    `(base + d * sum) / deg` (the last round: `d * sum + base`).

`into_dst` is one K1 float-sum call over the ie tile CSR, its [nr, nc,
vc] partials summed over the row axis (dst chunk j complete) and
re-aligned to the tile rows (`cols_to_rows`); `into_src` is one over the
oe tile CSR, summed over the column axis (src chunk i).  The degrees are
the two CSRs' row lengths, summed the same way.  As in the JAX package
the master state (`*_row`) is chunk-indexed by tile row and the oe pull
reads a column copy (`*_col`, `rows_to_cols`); with one process both
copies of a [k * vc] vector are the same vector.  Across ranks the sums
are each group's all_reduce and the transposes `CommSpec.vc_transpose`,
the vertex and dangling counts `count_rows`; `replicated_keys` hold the
same values on every rank.

`PageRankVCReplicated` (`pagerank_vc_rep`) keeps the replicated
formulation: each tile's full [k * vc] partial vector (its dst and src
sums placed by chunk), summed over the tiles by the fragment stack's
`StepContext.sum`, the JAX package's psum over the fragment axis.
Across ranks that sum is one all_reduce of the rank's tiles' sum (the
JAX psum), never a gather of the tile stack.  Float sums regroup against
the JAX package's (and across ranks), so both agree with it to float
eps, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    GatherScatterAppBase,
    StepContext,
    VCStepContext,
)
from libgrape_lite_tpu_torch.models.vc2d import tile_pull, vc_finalize_rows
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


def _degrees(ctx: VCStepContext, dev) -> torch.Tensor:
    """[nr * vc] int32: appearances as dst (the ie CSR's row lengths over
    the row axis) plus as src (the oe CSR's over the column axis)."""
    if dev.oe is None:
        raise ValueError(
            "PageRankVC accumulates both directions over raw storage; "
            "build the vertex-cut fragment with symmetrize=False")

    def lengths(side):
        return ctx.tiles(torch.diff(side.indptr, dim=-1))

    return (ctx.flat(ctx.cols_to_rows(ctx.row_sum(lengths(dev.ie))))
            + ctx.flat(ctx.col_sum(lengths(dev.oe)))).to(torch.int32)


def _update(d: float, dt, rank, deg, vmask, step, dangling_sum,
            total_dangling, n, gathered, max_round):
    """The master update of one round (JAX `pagerank_vc.py:136-180`)."""
    step = step + 1
    base = (1.0 - d) / n + d * dangling_sum / n
    new_dangling = base * total_dangling
    is_last = step >= max_round
    iter_val = torch.where(deg > 0,
                           (base + d * gathered) / deg.clamp(min=1).to(dt),
                           base)
    final_val = gathered * d + base
    new = torch.where(vmask, torch.where(is_last, final_val, iter_val),
                      torch.zeros((), dtype=dt, device=rank.device))
    return new, step, new_dangling, torch.where(is_last, 0, 1)


def _initial(dt, deg, vmask, count=torch.sum):
    """(rank, dangling mass, dangling count) after PEval; `count` sums a
    mask over every vertex (`VCStepContext.count_rows` across ranks)."""
    n = count(vmask).to(dt)
    p = 1.0 / n
    total_dangling = count(vmask & (deg == 0)).to(dt)
    rank = torch.where(vmask,
                       torch.where(deg > 0, p / deg.clamp(min=1).to(dt), p),
                       torch.zeros((), dtype=dt, device=deg.device))
    return rank, p * total_dangling, total_dangling


class PageRankVC(GatherScatterAppBase):
    load_strategy = LoadStrategy.kNullLoadStrategy
    message_strategy = MessageStrategy.kGatherScatter
    result_format = "float"
    mesh_kind = "vc2d"
    replicated_keys = frozenset({"step", "dangling_sum", "total_dangling"})
    # chunk-indexed by tile row / by tile column (the worker gathers and
    # cuts them by the grid)
    vc_row_keys = frozenset({"rank_row", "deg_row", "vmask_row"})
    vc_col_keys = frozenset({"rank_col", "deg_col", "vmask_col"})

    def __init__(self, delta: float = 0.85, max_round: int = 10,
                 dtype: torch.dtype = torch.float32):
        self.delta = delta
        self.max_round = max_round
        self.dtype = dtype

    def init_state(self, frag, delta: float | None = None,
                   max_round: int | None = None):
        if delta is not None:
            self.delta = delta
        if max_round is not None:
            self.max_round = max_round
        self._partition = "2d"
        self._mesh_k = frag.k
        self._partition_stats = frag.tile_stats()
        dev, dt = frag.device, self.dtype
        vmask = frag.dev.vmask
        lo, hi = frag.chunk_span("col")
        vmask_col = (vmask if frag.chunk_span("row") == (lo, hi) else
                     torch.from_numpy(frag.vertex_mask()[lo:hi]).to(dev))
        rank = torch.zeros(vmask.shape, dtype=dt, device=dev)
        deg = torch.zeros(vmask.shape, dtype=torch.int32, device=dev)
        rank_c = torch.zeros(vmask_col.shape, dtype=dt, device=dev)
        deg_c = torch.zeros(vmask_col.shape, dtype=torch.int32, device=dev)
        return {
            "rank_col": rank_c, "rank_row": rank,
            "deg_col": deg_c, "deg_row": deg,
            "vmask_col": vmask_col, "vmask_row": vmask,
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "dangling_sum": torch.zeros((), dtype=dt, device=dev),
            "total_dangling": torch.zeros((), dtype=dt, device=dev),
        }

    def peval(self, ctx: VCStepContext, dev, state):
        deg = _degrees(ctx, dev)
        rank, dangling_sum, total_dangling = _initial(
            self.dtype, deg, state["vmask_row"], ctx.count_rows)
        return dict(
            state, rank_col=self._col(ctx, rank), rank_row=rank,
            deg_col=self._col(ctx, deg), deg_row=deg,
            dangling_sum=dangling_sum, total_dangling=total_dangling,
            step=torch.zeros_like(state["step"]),
        ), (1 if self.max_round > 0 else 0)

    @staticmethod
    def _col(ctx: VCStepContext, x: torch.Tensor) -> torch.Tensor:
        """The column copy of a row-chunk vector (the same vector with one
        process)."""
        return ctx.flat(ctx.rows_to_cols(ctx.chunks(x)))

    def inceval(self, ctx: VCStepContext, dev, state):
        into_dst = ctx.flat(ctx.cols_to_rows(ctx.row_sum(
            tile_pull(ctx, dev.ie, None, state["rank_row"], "sum"))))
        into_src = ctx.flat(ctx.col_sum(
            tile_pull(ctx, dev.oe, None, state["rank_col"], "sum")))
        vmask = state["vmask_row"]
        n = ctx.count_rows(vmask).to(self.dtype)
        rank, step, dangling_sum, vote = _update(
            self.delta, self.dtype, state["rank_row"], state["deg_row"],
            vmask, state["step"], state["dangling_sum"],
            state["total_dangling"], n, into_dst + into_src, self.max_round)
        return dict(state, rank_col=self._col(ctx, rank), rank_row=rank,
                    step=step, dangling_sum=dangling_sum), vote

    def finalize(self, frag, state):
        return vc_finalize_rows(frag, state["rank_row"].numpy())


class PageRankVCReplicated(GatherScatterAppBase):
    """The replicated formulation (`pagerank_vc_rep`): master state as
    whole [k * vc] vectors, the gather one sum over the tile stack --
    kept for A/B against the SUMMA-sharded default, as in the JAX
    package."""

    load_strategy = LoadStrategy.kNullLoadStrategy
    message_strategy = MessageStrategy.kGatherScatter
    result_format = "float"
    replicated_keys = frozenset(
        {"rank", "deg", "vmask", "step", "dangling_sum", "total_dangling"})
    # the vote is a round constant, the same on every rank
    replicated_vote = True

    def __init__(self, delta: float = 0.85, max_round: int = 10,
                 dtype: torch.dtype = torch.float32):
        self.delta = delta
        self.max_round = max_round
        self.dtype = dtype

    def init_state(self, frag, delta: float | None = None,
                   max_round: int | None = None):
        if delta is not None:
            self.delta = delta
        if max_round is not None:
            self.max_round = max_round
        dev, n_pad, dt = frag.device, frag.k * frag.vc, self.dtype
        self._vc = VCStepContext(frag.k, spec=frag.comm_spec)
        self._spans = (frag.chunk_span("row"), frag.chunk_span("col"))
        return {
            "rank": torch.zeros(n_pad, dtype=dt, device=dev),
            "deg": torch.zeros(n_pad, dtype=torch.int32, device=dev),
            "vmask": torch.from_numpy(frag.vertex_mask()).to(dev),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "dangling_sum": torch.zeros((), dtype=dt, device=dev),
            "total_dangling": torch.zeros((), dtype=dt, device=dev),
        }

    def _per_tile(self, into_dst: torch.Tensor,
                  into_src: torch.Tensor) -> torch.Tensor:
        """[fl, k * vc]: each local tile (i, j)'s full partial vector, its
        dst sums at chunk j and its src sums at chunk i (every tile with
        one process)."""
        vcx = self._vc
        k, nr, nc = vcx.k, vcx.nr, vcx.nc
        r_lo, c_lo = (0, 0) if vcx.grid is None else (vcx.grid.r_lo,
                                                      vcx.grid.c_lo)
        vc = into_dst.shape[-1]
        full = into_dst.new_zeros((nr, nc, k, vc))
        i, j = torch.meshgrid(torch.arange(nr), torch.arange(nc),
                              indexing="ij")
        i, j = i.to(full.device), j.to(full.device)
        full[i, j, j + c_lo] = into_dst
        full.index_put_((i, j, i + r_lo), into_src, accumulate=True)
        return full.reshape(nr * nc, k * vc)

    @staticmethod
    def _psum(ctx: StepContext, x: torch.Tensor) -> torch.Tensor:
        """The tiles' sum (the JAX psum over the fragment axis): across
        ranks one all_reduce of the rank's tiles' sum."""
        if ctx.spec is None:
            return ctx.sum(x)
        return ctx.spec.all_reduce(x.sum(dim=0), "sum")

    def _tables(self, rank: torch.Tensor) -> tuple:
        """The chunks of `rank` the rank's ie and oe pulls read."""
        (a, b), (c, d) = self._spans
        return rank[a:b], rank[c:d]

    def peval(self, ctx: StepContext, dev, state):
        vc = self._vc

        def lengths(side):
            return vc.tiles(torch.diff(side.indptr, dim=-1))

        if dev.oe is None:
            _degrees(vc, dev)  # raises: raw storage needed
        deg = self._psum(ctx, self._per_tile(
            lengths(dev.ie), lengths(dev.oe))).to(torch.int32)
        rank, dangling_sum, total_dangling = _initial(
            self.dtype, deg, state["vmask"])
        return dict(state, rank=rank, deg=deg, dangling_sum=dangling_sum,
                    total_dangling=total_dangling,
                    step=torch.zeros_like(state["step"])), (
            1 if self.max_round > 0 else 0)

    def inceval(self, ctx: StepContext, dev, state):
        vc = self._vc
        rank = state["rank"]
        x_ie, x_oe = self._tables(rank)
        gathered = self._psum(ctx, self._per_tile(
            tile_pull(vc, dev.ie, None, x_ie, "sum"),
            tile_pull(vc, dev.oe, None, x_oe, "sum")))
        vmask = state["vmask"]
        n = vmask.sum().to(self.dtype)
        rank, step, dangling_sum, vote = _update(
            self.delta, self.dtype, rank, state["deg"], vmask,
            state["step"], state["dangling_sum"], state["total_dangling"],
            n, gathered, self.max_round)
        return dict(state, rank=rank, step=step,
                    dangling_sum=dangling_sum), vote

    def finalize(self, frag, state):
        return vc_finalize_rows(frag, state["rank"].numpy())
