"""PageRankLocal -- the unnormalised PageRank of the competitor numbers.

Counterpart of `libgrape_lite_tpu/models/pagerank_local.py` (reference
`examples/analytical_apps/pagerank/pagerank_local.h`, with
`pagerank_local_parallel` the same app): r' = (1 - d) + d * sum of
r[nbr] / deg[nbr] over in-neighbours, with no dangling redistribution,
for a fixed number of rounds.  The state holds r / deg; the last round
multiplies the degree back in.

Each round is one gather-reduce (float kind `sum`) of the state over the
in-edge CSR.  The state's type is float32 on the card (the kernel's
type) and float64 where the caller asks for it (the tests, against the
JAX package's x64 state); the sums regroup relative to the JAX package,
so ranks agree to a tolerance, not bitwise.  Under a process group a
rank holds its slab of `rank` and pulls from the gathered state; each
row's sum reads the same edges in the same order as in one process.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    BatchShuffleAppBase,
    StepContext,
    local_frags,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class PageRankLocal(BatchShuffleAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    result_format = "float"
    replicated_keys = frozenset({"step"})
    # the round vote is the step counter's, the same on every rank
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
        dev = frag.device
        fl, _ = local_frags(frag)
        return {
            "rank": torch.zeros((fl, frag.vp), dtype=self.dtype,
                                device=dev),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _c(self, v, like):
        return torch.tensor(v, dtype=like.dtype, device=like.device)

    def peval(self, ctx: StepContext, dev, state):
        deg = dev.out_degree
        one = self._c(1.0, state["rank"])
        rank = torch.where(
            dev.inner_mask,
            torch.where(deg > 0, one / deg.clamp(min=1).to(one.dtype), one),
            self._c(0.0, one))
        step = torch.zeros_like(state["step"])
        return dict(rank=rank, step=step), 1 if self.max_round > 0 else 0

    def inceval(self, ctx: StepContext, dev, state):
        rank = state["rank"]
        step = state["step"] + 1
        ie = dev.ie
        cur = spmv.gather_reduce(ie.indptr, ie.edge_nbr, None,
                                 ctx.gather_state(rank), "sum")
        deg = dev.out_degree
        degf = deg.clamp(min=1).to(rank.dtype)
        val = self._c(1.0 - self.delta, rank) + self._c(self.delta, rank) * cur
        nxt = torch.where(deg > 0, val / degf, self._c(1.0, rank))
        nxt = torch.where(dev.inner_mask, nxt, self._c(0.0, rank))
        is_last = step >= self.max_round
        finald = torch.where(deg > 0, nxt * deg.to(rank.dtype), nxt)
        return (dict(rank=torch.where(is_last, finald, nxt), step=step),
                torch.where(is_last, 0, 1))

    def finalize(self, frag, state):
        return np.asarray(state["rank"].numpy())
