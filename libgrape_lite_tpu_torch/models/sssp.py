"""SSSP -- single-source shortest paths, dense pull.

Counterpart of `libgrape_lite_tpu/models/sssp.py` (reference
`examples/analytical_apps/sssp/sssp.h:36-170`): pull-mode Bellman-Ford.
Each round relaxes every in-edge at once,

    relaxed[v] = min_{e in in(v)} dist[nbr_e] + w_e,

through the gather-reduce kernel (kind `min`), and votes the number of
improved inner vertices.  The weight stream is pre-masked once at init
(`wf_eff`, +inf on pad edges), as in the JAX package.  `min` is exact in
any order, so the result is bit-identical to the JAX package's.

On a fragment carrying a staged delta overlay (dyn/), each round also
folds the overlay's edges in with one `overlay_fold` pass over its slots
(`dyn_min_fold`),
and the previous fixed point can seed an incremental query
(`inc_mode = "monotone-min"`).

A sequence of sources builds k lanes ([k, fnum, vp] distances, the
weight stream shared); a round then relaxes every lane with one
`gather_reduce_lanes` call and votes each lane's improved count.

`GRAPE_EXCHANGE` (parallel/mirror.py) picks the exchange of the pull:
the gathered state, or the mirror tables under the plan's remapped
columns.  `GRAPE_PIPELINE` (parallel/pipeline.py) runs a single-source
query's rounds pipelined (`inceval_pipelined`): the boundary K1 pull,
the exchange kickoff on a side stream, the interior K1 pull, the join.
min is exact in any grouping, so both are bit-equal to the serial
gather round.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    ParallelAppBase,
    StepContext,
    exchange_table,
    is_lane_sequence,
    source_lane_array,
)
from libgrape_lite_tpu_torch.dyn.ingest import overlay_state_entries
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class SSSP(ParallelAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "sssp_infinity"
    needs_edata = True  # double edata (run_app.cc:48-52)
    ephemeral_keys = frozenset({"wf_eff"})
    # dyn/: staged additive deltas fold exactly into the min relax, and
    # the previous fixed point seeds incremental IncEval
    dyn_overlay_support = True
    inc_mode = "monotone-min"
    inc_seed_keys = {"dist": "min"}
    batch_query_key = "source"  # serve/: k sources, one pull a round
    lane_native = True
    k1_pull = "weighted"  # ops/calibration.py: one K1 pull a round
    # parallel/pipeline.py: min folds split bit-stably
    pipeline_state_key = "dist"

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype
        self._mx = None

    def initial_dist(self, frag, source) -> torch.Tensor:
        """[fnum, vp] distances: 0 at the source, +inf elsewhere; a
        sequence of k sources gives [k, fnum, vp]."""
        if not frag.weighted:
            raise ValueError(
                "SSSP requires edge weights; load the graph with "
                "weighted=True"
            )
        batched, dist = source_lane_array(frag, source, type(self).__name__,
                                          float("inf"), 0, self.dtype)
        return dist if batched else dist[0]

    def init_state(self, frag, source=0):
        dev, dt = frag.device, self.dtype
        dist = self.initial_dist(frag, source)
        ie = frag.dev.ie
        wf_eff = torch.where(
            ie.edge_mask, ie.edge_w.to(dt),
            torch.tensor(float("inf"), dtype=dt, device=dev),
        )
        state = {"dist": dist, "wf_eff": wf_eff}
        # the overlay's side arrays, only while it holds staged edges
        overlay = overlay_state_entries(
            frag, "ie", torch.empty((), dtype=dt).numpy().dtype, "dyn_ie_")
        state.update(overlay)
        # the exchange and the pipeline (a single source); the overlay's
        # columns are pids, so an attached overlay keeps the gather
        self._mx = self.resolve_exchange(frag, state)
        self._pipeline = None
        if not is_lane_sequence(source):
            self.attach_pipeline(frag, state, app_name="SSSP",
                                 mirror=self._mx, fold="min",
                                 with_weights=True, w_dtype=dt)
        self.ephemeral_keys = frozenset(state) - {"dist"}
        return state

    def peval(self, ctx: StepContext, dev, state):
        # the first pull round subsumes the reference PEval's source
        # relaxation (sssp.h:68-83); ForceContinue (sssp.h:90)
        return state, 1

    def inceval(self, ctx: StepContext, dev, state):
        dist = state["dist"]
        ie = dev.ie
        full, nbr = exchange_table(ctx, dist, ie, state, self._mx)
        relaxed = spmv.pull(ie.indptr, nbr, state["wf_eff"], full, "min")
        if "dyn_ie_src" in state:
            relaxed = self.dyn_min_fold(relaxed, state, "dyn_ie_", full)
        new = torch.minimum(dist, relaxed)
        changed = (new < dist) & dev.inner_mask
        return dict(state, dist=new), changed.sum(dim=(-2, -1))

    def inceval_pipelined(self, ctx: StepContext, dev, state, xbuf):
        """The pipelined round (parallel/pipeline.py): the boundary rows'
        relax, the exchange kickoff on the side stream, the interior
        rows' relax overlapping it, the join (`pipelined_min_round`):
        bit-equal to `inceval`."""
        new, improved, xbuf2 = self.pipelined_min_round(ctx, state, xbuf)
        changed = improved & dev.inner_mask
        return {"dist": new}, changed.sum(dim=(-2, -1)), xbuf2


    def invariants(self, frag, state):
        # distances are tropical-min state: never negative, never NaN
        # (in_range(lo=0) rejects NaN), and only ever improving; +inf is
        # the unreached sentinel
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [
            in_range("dist", lo=0.0),
            monotone_non_increasing("dist"),
        ]

    def finalize(self, frag, state):
        return np.asarray(state["dist"].cpu().numpy())
