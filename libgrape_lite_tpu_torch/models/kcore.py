"""KCore -- k-core membership by synchronous peeling.

Counterpart of `libgrape_lite_tpu/models/kcore.py` (reference
`examples/analytical_apps/kcore/kcore.h`): vertices whose residual degree
falls below k are removed, every under-k vertex of a round at once, until
a round removes nothing.  Each round counts a vertex's alive in-neighbours
with the gather-reduce kernel (int32 kind `sum`, no weights) over the
in-edge CSR of the alive bitmap; the count is bounded by the in-degree,
and an int32 sum is exact in any order, so memberships and round counts
equal the JAX package's.

Result: 1 for a member of the k-core, else 0 (`kcore_context.h` counts
`result >= k`).

Under a process group a rank holds its slab of `alive` and pulls from
the gathered bitmap; the round's removed count is global (`ctx.sum`), so
the vote is the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


def alive_neighbours(ctx: StepContext, dev, alive: torch.Tensor):
    """[fnum, vp] int32 count of each vertex's alive in-neighbours."""
    ie = dev.ie
    return spmv.gather_reduce(ie.indptr, ie.edge_nbr, None,
                              ctx.gather_state(alive.to(torch.int32)), "sum")


class KCore(ParallelAppBase):
    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"
    # the round vote is the global removed count, the same on every rank
    replicated_vote = True

    def __init__(self, k: int = 0):
        self.k = k

    def init_state(self, frag, k: int | None = None):
        if k is not None:
            self.k = k
        # this process's fragments (the rank's slab under a group)
        return {"alive": frag.dev.inner_mask.clone()}

    def peval(self, ctx: StepContext, dev, state):
        # the initial cut: degree < k (kcore.h PEval)
        return {"alive": state["alive"] & (dev.out_degree >= self.k)}, 1

    def inceval(self, ctx: StepContext, dev, state):
        alive = state["alive"]
        removed = alive & (alive_neighbours(ctx, dev, alive) < self.k)
        return {"alive": alive & ~removed}, ctx.sum(removed.sum(dim=-1))


    def invariants(self, frag, state):
        # peeling only removes: a dead vertex never resurrects (monotone
        # across any probe cadence -- removal is transitive)
        from libgrape_lite_tpu_torch.guard.invariants import (
            monotone_non_increasing,
        )

        return [monotone_non_increasing("alive")]

    def finalize(self, frag, state):
        return state["alive"].numpy().astype(np.int64)
