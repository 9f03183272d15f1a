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

On one card: `into_dst` is one K1 float-sum call over the ie tile CSR,
its [k, k, vc] partials summed over the row axis (dst chunk j
complete); `into_src` is one over the oe tile CSR, summed over the
column axis (src chunk i).  The degrees are the two CSRs' row lengths,
summed the same way.  The JAX package keeps row and column copies of
rank, degree and mask on its SUMMA mesh; on one card the two copies of
a [k * vc] vector are the same vector, so `rank_row` is `rank_col` (the
carry keeps both names, so a lineage's keys match the JAX package's).

`PageRankVCReplicated` (`pagerank_vc_rep`) keeps the replicated
formulation: each tile's full [k * vc] partial vector (its dst and src
sums placed by chunk), summed over the tiles by the fragment stack's
`StepContext.sum`, the JAX package's psum over the fragment axis.
Float sums regroup against the JAX package's, so both agree with it to
float eps, not bitwise.
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
    """[k * vc] int32: appearances as dst (the ie CSR's row lengths over
    the row axis) plus as src (the oe CSR's over the column axis)."""
    if dev.oe is None:
        raise ValueError(
            "PageRankVC accumulates both directions over raw storage; "
            "build the vertex-cut fragment with symmetrize=False")

    def lengths(side):
        return ctx.tiles(torch.diff(side.indptr, dim=-1))

    return (ctx.flat(ctx.row_sum(lengths(dev.ie)))
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


def _initial(dt, deg, vmask):
    """(rank, dangling mass, dangling count, n) after PEval."""
    n = vmask.sum().to(dt)
    p = 1.0 / n
    total_dangling = (vmask & (deg == 0)).sum().to(dt)
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
        dev, n_pad, dt = frag.device, frag.dev.n_pad, self.dtype
        rank = torch.zeros(n_pad, dtype=dt, device=dev)
        deg = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        vmask = frag.dev.vmask
        return {
            "rank_col": rank, "rank_row": rank,
            "deg_col": deg, "deg_row": deg,
            "vmask_col": vmask, "vmask_row": vmask,
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "dangling_sum": torch.zeros((), dtype=dt, device=dev),
            "total_dangling": torch.zeros((), dtype=dt, device=dev),
        }

    def peval(self, ctx: VCStepContext, dev, state):
        deg = _degrees(ctx, dev)
        rank, dangling_sum, total_dangling = _initial(
            self.dtype, deg, state["vmask_col"])
        return dict(
            state, rank_col=rank, rank_row=rank, deg_col=deg, deg_row=deg,
            dangling_sum=dangling_sum, total_dangling=total_dangling,
            step=torch.zeros_like(state["step"]),
        ), (1 if self.max_round > 0 else 0)

    def inceval(self, ctx: VCStepContext, dev, state):
        into_dst = ctx.flat(ctx.row_sum(
            tile_pull(ctx, dev.ie, None, state["rank_row"], "sum")))
        into_src = ctx.flat(ctx.col_sum(
            tile_pull(ctx, dev.oe, None, state["rank_col"], "sum")))
        vmask = state["vmask_col"]
        n = vmask.sum().to(self.dtype)
        rank, step, dangling_sum, vote = _update(
            self.delta, self.dtype, state["rank_col"], state["deg_col"],
            vmask, state["step"], state["dangling_sum"],
            state["total_dangling"], n, into_dst + into_src, self.max_round)
        return dict(state, rank_col=rank, rank_row=rank, step=step,
                    dangling_sum=dangling_sum), vote

    def finalize(self, frag, state):
        return vc_finalize_rows(frag, state["rank_col"].numpy())


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
        dev, n_pad, dt = frag.device, frag.dev.n_pad, self.dtype
        self._vc = VCStepContext(frag.k)
        return {
            "rank": torch.zeros(n_pad, dtype=dt, device=dev),
            "deg": torch.zeros(n_pad, dtype=torch.int32, device=dev),
            "vmask": frag.dev.vmask,
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "dangling_sum": torch.zeros((), dtype=dt, device=dev),
            "total_dangling": torch.zeros((), dtype=dt, device=dev),
        }

    def _per_tile(self, into_dst: torch.Tensor,
                  into_src: torch.Tensor) -> torch.Tensor:
        """[fnum, k * vc]: tile (i, j)'s full partial vector, its dst sums
        at chunk j and its src sums at chunk i."""
        k = self._vc.k
        vc = into_dst.shape[-1]
        full = into_dst.new_zeros((k, k, k, vc))
        i, j = torch.meshgrid(torch.arange(k), torch.arange(k), indexing="ij")
        i, j = i.to(full.device), j.to(full.device)
        full[i, j, j] = into_dst
        full.index_put_((i, j, i), into_src, accumulate=True)
        return full.reshape(k * k, k * vc)

    def peval(self, ctx: StepContext, dev, state):
        vc = self._vc

        def lengths(side):
            return vc.tiles(torch.diff(side.indptr, dim=-1))

        if dev.oe is None:
            _degrees(vc, dev)  # raises: raw storage needed
        deg = ctx.sum(self._per_tile(lengths(dev.ie),
                                     lengths(dev.oe))).to(torch.int32)
        rank, dangling_sum, total_dangling = _initial(
            self.dtype, deg, state["vmask"])
        return dict(state, rank=rank, deg=deg, dangling_sum=dangling_sum,
                    total_dangling=total_dangling,
                    step=torch.zeros_like(state["step"])), (
            1 if self.max_round > 0 else 0)

    def inceval(self, ctx: StepContext, dev, state):
        vc = self._vc
        rank = state["rank"]
        gathered = ctx.sum(self._per_tile(
            tile_pull(vc, dev.ie, None, rank, "sum"),
            tile_pull(vc, dev.oe, None, rank, "sum")))
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
