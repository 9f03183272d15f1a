"""BFS -- breadth-first search levels, dense pull.

Counterpart of `libgrape_lite_tpu/models/bfs.py` (reference
`examples/analytical_apps/bfs/bfs.h:30-150`): pull-mode unit-weight
Bellman-Ford over int32 depths.  Each round takes

    relaxed[v] = min_{e in in(v)} depth[nbr_e] + 1

through the gather-reduce kernel (int32 kind `min`, no weights): the
minimum of the neighbours' depths, plus one where it is not the
INT32_MAX sentinel (min(d) + 1 == min(d + 1), and a reached depth never
reaches the sentinel).  Rows without in-edges come back as the sentinel.
Unreached vertices print as the reference's int64 maximum
(`bfs_context.h:44`, golden `p2p-31-BFS`).  Integer min is exact in any
order, so depths and round counts equal the JAX package's.  A staged
delta overlay (dyn/) folds in through one int32 `overlay_fold` pass over
its slots with the same +1 a slot, and the previous depths can seed an
incremental query.  A sequence of sources builds k lanes, relaxed
together by one `gather_reduce_lanes` call a round.  `GRAPE_EXCHANGE`
and `GRAPE_PIPELINE` pick the mirror exchange and the pipelined round,
as in models/sssp.py.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    ParallelAppBase,
    StepContext,
    exchange_table,
    source_lane_array,
)
from libgrape_lite_tpu_torch.dyn.ingest import overlay_state_entries
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_SENTINEL = np.iinfo(np.int32).max
_OUT_SENTINEL = np.iinfo(np.int64).max  # printed for unreachable


def _plus_one(near: torch.Tensor) -> torch.Tensor:
    """min(d) + 1 == min(d + 1); the sentinel (no reached neighbour)
    stays the sentinel."""
    return torch.where(near != _SENTINEL, near + 1, near)


class BFS(ParallelAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"
    # dyn/: unit-weight min relax -- additive deltas fold exactly, and
    # the previous depths seed incremental IncEval
    dyn_overlay_support = True
    inc_mode = "monotone-min"
    inc_seed_keys = {"depth": "min"}
    batch_query_key = "source"  # serve/: k sources, one pull a round
    lane_native = True
    k1_pull = "plain"  # ops/calibration.py: one K1 pull a round
    # parallel/pipeline.py: integer min folds split bit-stably
    pipeline_state_key = "depth"
    _mx = None

    def init_state(self, frag, source=0):
        batched, depth = source_lane_array(frag, source, "BFS", _SENTINEL, 0,
                                           torch.int32)
        depth = depth if batched else depth[0]
        state = {"depth": depth,
                 **overlay_state_entries(frag, "ie", None, "dyn_ie_")}
        # the exchange and the pipeline (models/sssp.py's rules)
        self._mx = self.resolve_exchange(frag, state)
        self._pipeline = None
        if not batched:
            self.attach_pipeline(frag, state, app_name="BFS",
                                 mirror=self._mx, fold="min")
        self.ephemeral_keys = frozenset(state) - {"depth"}
        return state

    def peval(self, ctx: StepContext, dev, state):
        return state, 1

    def inceval(self, ctx: StepContext, dev, state):
        depth = state["depth"]
        ie = dev.ie
        full, nbr = exchange_table(ctx, depth, ie, state, self._mx)
        relaxed = _plus_one(spmv.pull(ie.indptr, nbr, None, full, "min"))
        if "dyn_ie_src" in state:
            relaxed = self.dyn_min_fold(relaxed, state, "dyn_ie_", full,
                                        plus_one=True)
        new = torch.minimum(depth, relaxed)
        changed = (new < depth) & dev.inner_mask
        return dict(state, depth=new), changed.sum(dim=(-2, -1))

    def inceval_pipelined(self, ctx: StepContext, dev, state, xbuf):
        """The pipelined round (models/sssp.py's): boundary relax,
        kickoff, interior relax, join -- bit-equal to `inceval`."""
        new, improved, xbuf2 = self.pipelined_min_round(ctx, state, xbuf,
                                                        post=_plus_one)
        changed = improved & dev.inner_mask
        return {"depth": new}, changed.sum(dim=(-2, -1)), xbuf2


    def invariants(self, frag, state):
        # levels live in [0, SENTINEL] and only ever improve (pull-mode
        # unit-weight relaxation is tropical-min, like SSSP)
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [
            in_range("depth", lo=0, hi=_SENTINEL),
            monotone_non_increasing("depth"),
        ]

    def finalize(self, frag, state):
        d = state["depth"].numpy().astype(np.int64)
        return np.where(d == _SENTINEL, _OUT_SENTINEL, d)
