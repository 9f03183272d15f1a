"""WCC -- weakly connected components by min-label propagation.

Counterpart of `libgrape_lite_tpu/models/wcc.py` (reference
`examples/analytical_apps/wcc/wcc.h`): labels start as pids (padded rows
hold the INT32_MAX sentinel, so they never win a min) and each round
pulls the minimum label over the in-neighbourhood, then, on directed
graphs, over the out-neighbourhood of the labels just folded -- both
through the gather-reduce kernel (int32 kind `min`, no weights; rows
without edges come back as the sentinel, which never lowers a label).
Undirected graphs store one symmetrised CSR, so one pull suffices.  A
staged delta overlay (dyn/) folds into each pull through one int32
`overlay_fold` pass over its slots, and the previous labels can seed an incremental query
(`inc_value_map` re-addresses them across a repack).
Labels are canonicalised on the host to the representative's oid (the
LDBC check is partition isomorphism, `misc/wcc_check.cc`).  A round
votes its local count of changed labels; the worker's `ctx.vote` sums it
across ranks under a process group.  Integer min
is exact in any order, so labels and round counts equal the JAX
package's.

`GRAPE_EXCHANGE` picks each pull's exchange (the oe pull's mirror plan
only with the ie pull's, as in the JAX package) and `GRAPE_PIPELINE` the
pipelined round: the single pull's split on undirected graphs, on
directed ones the double pull of two kickoffs over the joint ie + oe
boundary mask -- the oe exchange kicked from the ie boundary fold and
hidden under the ie interior fold, the next round's ie exchange kicked
from the oe boundary fold (`_inceval_pipelined_directed`).  WCCOpt's
pointer jumping reads the folded labels again, a third exchange the
split cannot hide: it declines.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    ParallelAppBase,
    StepContext,
    exchange_table,
    local_frags,
)
from libgrape_lite_tpu_torch.dyn.ingest import overlay_state_entries
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_SENTINEL = np.iinfo(np.int32).max


class WCC(ParallelAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"
    # dyn/: min-label propagation is a min fold -- additive deltas merge
    # exactly, and the previous labels seed incremental IncEval
    dyn_overlay_support = True
    inc_mode = "monotone-min"
    inc_seed_keys = {"comp": "min"}
    # parallel/pipeline.py: integer min folds split bit-stably
    pipeline_state_key = "comp"
    _mx_ie = _mx_oe = None

    def init_state(self, frag, **_):
        # the labels of this process's fragments (all single-process,
        # the rank's slab under a process group)
        fl, lo = local_frags(frag)
        pids = torch.arange(lo * frag.vp, (lo + fl) * frag.vp,
                            dtype=torch.int32,
                            device=frag.device).view(fl, frag.vp)
        comp = torch.where(frag.dev.inner_mask, pids,
                           torch.tensor(_SENTINEL, dtype=torch.int32,
                                        device=frag.device))
        state = {"comp": comp,
                 **overlay_state_entries(frag, "ie", None, "dyn_ie_")}
        if frag.directed:
            state.update(overlay_state_entries(frag, "oe", None, "dyn_oe_"))
        # the exchange per pull direction and the pipeline
        # (models/sssp.py's rules)
        self._mx_ie = self.resolve_exchange(frag, state, "ie", "mx_ie_")
        self._mx_oe = None
        if self._mx_ie is not None and frag.directed:
            self._mx_oe = self.resolve_exchange(frag, state, "oe", "mx_oe_")
        self.attach_pipeline(
            frag, state, app_name="WCC", mirror=self._mx_ie,
            mx_prefix="mx_ie_", fold="min",
            direction2="oe" if frag.directed else None, mirror2=self._mx_oe,
            eligible=type(self)._post_pull is WCC._post_pull,
            reason="_post_pull overrides (WCCOpt pointer jumping) "
                   "gather the folded labels again \u2014 a dependent "
                   "third exchange the split cannot hide")
        self.ephemeral_keys = frozenset(state) - {"comp"}
        return state

    def peval(self, ctx: StepContext, dev, state):
        return state, 1

    def _pull(self, ctx, comp, csr, state, dyn_prefix, mx, mx_prefix):
        full, nbr = exchange_table(ctx, comp, csr, state, mx, mx_prefix)
        red = spmv.gather_reduce(csr.indptr, nbr, None, full, "min")
        if dyn_prefix + "src" in state:
            red = self.dyn_min_fold(red, state, dyn_prefix, full)
        return red

    def _post_pull(self, ctx: StepContext, dev, new):
        """Hook between the neighbour pulls and the change count; WCCOpt
        puts pointer jumping here."""
        return new

    def inceval(self, ctx: StepContext, dev, state):
        comp = state["comp"]
        new = torch.minimum(comp, self._pull(ctx, comp, dev.ie, state,
                                             "dyn_ie_", self._mx_ie,
                                             "mx_ie_"))
        if dev.directed:
            new = torch.minimum(new, self._pull(ctx, new, dev.oe, state,
                                                "dyn_oe_", self._mx_oe,
                                                "mx_oe_"))
        new = self._post_pull(ctx, dev, new)
        changed = (new < comp) & dev.inner_mask
        return dict(state, comp=new), changed.sum(dim=(-2, -1))

    def inceval_pipelined(self, ctx: StepContext, dev, state, xbuf):
        """The pipelined round of the single pull (models/sssp.py's);
        directed graphs take `_inceval_pipelined_directed`."""
        if self._pipeline.mode2 is not None:
            return self._inceval_pipelined_directed(ctx, dev, state, xbuf)
        new, improved, xbuf2 = self.pipelined_min_round(ctx, state, xbuf)
        changed = improved & dev.inner_mask
        return {"comp": new}, changed.sum(dim=(-2, -1)), xbuf2

    def _inceval_pipelined_directed(self, ctx: StepContext, dev, state,
                                    xbuf):
        """The double pull of two kickoffs.  The serial round's oe pull
        reads the labels the ie pull folded.  Under the joint ie + oe
        boundary mask the ie boundary fold is complete at every row any
        other fragment reads, so the oe exchange kicks right after it
        and hides under the ie interior fold; the next round's ie
        exchange kicks from the oe boundary fold the same way.  The
        joins select over disjoint rows: bit-equal to the serial
        round."""
        pl = self._pipeline
        comp = state["comp"]
        bmask = state["pl_bmask"]
        # leg 1 (ie): last round kicked its exchange
        full1 = pl.splice(comp, xbuf)
        new1_b = torch.minimum(comp, spmv.gather_reduce(
            state["pl_b_indptr"], state["pl_b_nbr"], None, full1, "min"))
        x_oe = pl.kickoff(ctx, torch.where(bmask, new1_b, comp), state,
                          leg=2)
        # ---- pipelined window: every carry read below is named in
        # parallel/pipeline.PIPELINE_WINDOW_READS (grape-lint R6) ----
        new1 = torch.where(bmask, new1_b, torch.minimum(
            comp, spmv.gather_reduce(state["pl_i_indptr"],
                                     state["pl_i_nbr"], None, full1,
                                     "min")))
        pl.join(leg=2)
        # leg 2 (oe): remote rows from x_oe, current at every boundary row
        full2 = pl.splice(new1, x_oe)
        new2_b = torch.minimum(new1, spmv.gather_reduce(
            state["pl2_b_indptr"], state["pl2_b_nbr"], None, full2, "min"))
        xbuf2 = pl.kickoff(ctx, torch.where(bmask, new2_b, new1), state)
        new = torch.where(bmask, new2_b, torch.minimum(
            new1, spmv.gather_reduce(state["pl2_i_indptr"],
                                     state["pl2_i_nbr"], None, full2,
                                     "min")))
        changed = (new < comp) & dev.inner_mask
        pl.join()
        return {"comp": new}, changed.sum(dim=(-2, -1)), xbuf2

    def inc_value_map(self, key, values, old_frag, new_frag):
        """Labels are pids, so a repack (which renumbers the pid space)
        re-addresses the label values: old representative pid -> its oid
        -> its new pid.  A representative missing from the new map falls
        back to the sentinel, and the fresh init wins."""
        if old_frag is new_frag or key != "comp":
            return values
        flat = np.asarray(values).reshape(-1)
        valid = flat != _SENTINEL
        if not valid.any():
            return values
        reps = np.unique(flat[valid])
        new_reps = new_frag.oid_to_pid(np.asarray(old_frag.pid_to_oid(reps)))
        new_reps = np.where(new_reps < 0, _SENTINEL, new_reps).astype(
            values.dtype)
        out = flat.copy()
        out[valid] = new_reps[np.searchsorted(reps, flat[valid])]
        return out.reshape(np.asarray(values).shape)


    def invariants(self, frag, state):
        # min-gid propagation: labels are pids (or the pad sentinel) and
        # only ever shrink toward the component representative
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [
            in_range("comp", lo=0, hi=np.iinfo(np.int32).max),
            monotone_non_increasing("comp"),
        ]

    def finalize(self, frag, state):
        comp = state["comp"].numpy().astype(np.int64)
        flat = comp.reshape(-1)
        real = flat != _SENTINEL
        reps, inv = np.unique(flat[real], return_inverse=True)
        # the representative's oid: a str on string-keyed graphs
        out = np.full(flat.shape, -1, dtype=(
            object if frag.is_string_keyed() else np.int64))
        out[real] = frag.pid_to_oid(reps)[inv]
        return out.reshape(comp.shape)
