"""PageRank -- LDBC variant with dangling-mass approximation.

Counterpart of `libgrape_lite_tpu/models/pagerank.py` (the global, not
personalized, variant; reference
`examples/analytical_apps/pagerank/pagerank.h:34-160`).  During iteration
the state holds rank/degree; each round pulls the in-neighbour sum and
applies

    base = (1-d)/n + d * dangling_sum / n
    next[v] = deg > 0 ? (d * sum + base) / deg : base
    dangling_sum' = base * total_dangling

and the last round multiplies the degree back in.

The pull is one SpMV over the in-edge CSR: the strict-tile kernel when
`plan_for_app` accepts a strict plan (or `spmv_mode="strict"`), the
gather-reduce kernel otherwise.  Both regroup the float sums relative to
the JAX package, so results agree to a tolerance, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import BatchShuffleAppBase, StepContext
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class PageRank(BatchShuffleAppBase):
    # kBothOutIn like pagerank_parallel.h:46: the pull reads incoming
    # edges, the normalisation uses the out-degree
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    need_split_edges = True
    result_format = "float"
    ephemeral_keys = frozenset({"spmv_row_lo"})
    replicated_keys = frozenset({"step", "dangling_sum", "total_dangling"})
    # dyn/: a fixed-round iteration has no fixed point to reuse, so an
    # incremental query is a counted cold run
    inc_mode = "restart"

    def __init__(self, delta: float = 0.85, max_round: int = 10,
                 spmv_mode: str = "auto", dtype: torch.dtype = torch.float32):
        self.delta = delta
        self.max_round = max_round
        self.spmv_mode = spmv_mode
        self.dtype = dtype
        self._spmv_tile = self._spmv_rmax = 0
        self._const = {}

    def init_state(self, frag, delta: float | None = None,
                   max_round: int | None = None):
        if delta is not None:
            self.delta = delta
        if max_round is not None:
            self.max_round = max_round
        dev, dt = frag.device, self.dtype
        state = {
            "rank": torch.zeros((frag.fnum, frag.vp), dtype=dt, device=dev),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "dangling_sum": torch.zeros((), dtype=dt, device=dev),
            "total_dangling": torch.zeros((), dtype=dt, device=dev),
        }
        plan = spmv.plan_for_app(frag, frag.vp, dt, mode=self.spmv_mode)
        self._spmv_tile = plan[1] if plan else 0
        self._spmv_rmax = plan[2] if plan else 0
        if plan:
            state["spmv_row_lo"] = torch.from_numpy(plan[0]).to(dev)
        return state

    def peval(self, ctx: StepContext, dev, state):
        dt = state["rank"].dtype
        deg = dev.out_degree
        dangling = dev.inner_mask & (deg == 0)
        n, d = dev.total_vnum, self.delta

        def c(v):
            return torch.tensor(v, dtype=dt, device=deg.device)

        # the round's constants, rounded to the state type once per
        # query, as the JAX package rounds them with jnp.asarray
        self._const = {"teleport": c((1.0 - d) / n), "d_over_n": c(d / n),
                       "d": c(d), "zero": c(0.0)}
        p = c(1.0 / n)
        zero = self._const["zero"]
        rank = torch.where(
            dev.inner_mask,
            torch.where(deg > 0, p / deg.clamp(min=1).to(dt), p),
            zero,
        )
        total_dangling = ctx.sum(dangling.sum(dim=-1).to(dt))
        state = dict(
            state,
            rank=rank,
            step=torch.zeros((), dtype=torch.int32, device=deg.device),
            dangling_sum=p * total_dangling,
            total_dangling=total_dangling,
        )
        return state, 1 if self.max_round > 0 else 0

    def round_update(self, dev, state, cur):
        """One round given the in-neighbour rank sum `cur`
        (pagerank.h:102-156), including the final rank*deg assemble."""
        k = self._const
        dt = state["rank"].dtype
        step = state["step"] + 1
        base = k["teleport"] + k["d_over_n"] * state["dangling_sum"]
        dangling_sum = base * state["total_dangling"]
        deg = dev.out_degree
        nxt = torch.where(
            deg > 0, (k["d"] * cur + base) / deg.clamp(min=1).to(dt), base)
        nxt = torch.where(dev.inner_mask, nxt, k["zero"])
        is_last = step >= self.max_round
        finald = torch.where(deg > 0, nxt * deg.to(dt), nxt)
        new_state = dict(
            state,
            rank=torch.where(is_last, finald, nxt),
            step=step,
            dangling_sum=dangling_sum,
        )
        return new_state, torch.where(is_last, 0, 1)

    def inceval(self, ctx: StepContext, dev, state):
        # pull over incoming edges (pagerank_parallel.h:128-136)
        rank = state["rank"]
        ie = dev.ie
        full = ctx.gather_state(rank)
        if "spmv_row_lo" in state:
            contrib = torch.where(ie.edge_mask, full[ie.edge_nbr],
                                  self._const["zero"])
            cur = spmv.spmv_strict(contrib, ie.edge_src, state["spmv_row_lo"],
                                   dev.vp, self._spmv_tile, self._spmv_rmax)
        else:
            cur = spmv.gather_reduce(ie.indptr, ie.edge_nbr, None, full, "sum")
        return self.round_update(dev, state, cur.to(rank.dtype))

    def finalize(self, frag, state):
        return np.asarray(state["rank"].cpu().numpy())
