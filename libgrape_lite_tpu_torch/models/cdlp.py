"""CDLP -- community detection by synchronous label propagation.

Counterpart of `libgrape_lite_tpu/models/cdlp.py` (reference
`examples/analytical_apps/cdlp/cdlp.h` + `cdlp_utils.h`): labels start as
vertex ids; each of `max_round` rounds every vertex with out-edges adopts
the most frequent label among its out-neighbours (previous-round values),
ties broken toward the smallest label.  Multi-edges count with their
multiplicity.

The mode fold (`_mode_fold`) is the JAX package's sort / run-length
pipeline on one int64 key per edge,

    key = (row << rank_bits) | rank(label),

where `row` is the edge's row on the slab (f * vp + src for the slab's
fragment f, or fl * vp for a pad edge; fl = fnum in one process) and
`rank` the label's position in the static sorted label universe `lut`
(labels only ever move between existing ids).  The universe is the
whole graph's: under a process group it is built once from an
all_gather of every rank's initial labels, so a label that arrives from
another rank ranks as it does in one process.  One
`torch.sort` of the keys orders the edges by (row, label) -- the total
order all three branches of the JAX fold sort by (its packed 32-bit key,
its variadic wide sort and its per-round dynamic universe exist only
because its keys are 32 bits wide) -- so equal (row, label) pairs form
runs.  The longest run per row wins, ties to the smallest label.  No
Pallas kernel is involved: the JAX package runs this in XLA.

`GRAPE_PIPELINE` (parallel/pipeline.py) runs the rounds after PEval
pipelined over the oe pull's boundary / interior split: the boundary
rows' mode fold, the label exchange kicked off on a side stream, the
interior rows' fold, the join.  The fold only groups edges of one row,
so each part's fold equals the whole fold on its rows: bit-equal to the
serial round.  The exchange is the gather (int64 labels), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.ops.segment import segment_reduce
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_BIG = np.iinfo(np.int64).max


class CDLP(ParallelAppBase):
    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    result_format = "int"
    ephemeral_keys = frozenset({"lut"})
    replicated_keys = frozenset({"step", "lut"})
    # parallel/pipeline.py: the mode fold splits by row, bit-stably
    pipeline_state_key = "labels"

    def __init__(self, max_round: int = 10):
        self.max_round = max_round

    def init_state(self, frag, max_round: int | None = None):
        if max_round is not None:
            self.max_round = max_round
        oids = frag.dev.oids
        big = torch.tensor(_BIG, dtype=torch.int64, device=frag.device)
        labels = torch.where(oids >= 0, oids, big)
        # the static sorted label universe of the whole graph (every
        # rank's labels), +1 sentinel slot
        every = StepContext(frag.fnum, spec=getattr(frag, "comm_spec", None)
                            ).gather_state(labels)
        lut = torch.sort(torch.cat([every, big.view(1)]))[0]
        # the largest id of the universe (the guard's bound; pads hold big)
        self._label_max = torch.where(lut < big, lut, -1).max()
        state = {"labels": labels,
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=frag.device),
                 "lut": lut}
        # the gather exchange over the oe pull; CDLPOpt inherits (its
        # shortcut replaces PEval only)
        self.attach_pipeline(frag, state, app_name=type(self).__name__,
                             direction="oe", fold="min", with_rows=True)
        self.ephemeral_keys = frozenset(state) - {"labels", "step"}
        return state

    @staticmethod
    def _mode_fold(row, lab, lut, n_rows):
        """Per-row mode label of the (row, label) edge multiset: rows
        [0, n_rows), pad edges on row n_rows.  Rows without edges get
        the int64 maximum."""
        rank_bits = max(1, int(np.ceil(np.log2(lut.numel() + 1))))
        row_bits = max(1, int(np.ceil(np.log2(n_rows + 2))))
        if rank_bits + row_bits > 63:
            raise ValueError(f"CDLP: {n_rows} rows x {lut.numel()} labels "
                             "do not fit one int64 sort key")
        rank = torch.searchsorted(lut, lab)
        key = torch.sort((row.long() << rank_bits) | rank)[0]
        rows = key >> rank_bits
        sorted_lab = lut[key & ((1 << rank_bits) - 1)]
        valid = rows != n_rows
        # run-length encode equal keys
        first = torch.ones_like(valid)
        first[1:] = key[1:] != key[:-1]
        run_id = torch.cumsum(first.long(), 0) - 1
        run_len = segment_reduce(valid.long(), run_id, key.numel(), "sum")
        count = run_len[run_id]
        cmax = segment_reduce(count, rows, n_rows, "max")
        best = valid & (count == cmax[rows.clamp(max=n_rows - 1)])
        big = torch.tensor(_BIG, dtype=lut.dtype, device=lut.device)
        return segment_reduce(torch.where(best, sorted_lab, big), rows,
                              n_rows, "min")

    def _part_fold(self, dev, full, row, nbr, lut, labels):
        """The mode fold over one part's edges (rows [fl, Ep_part],
        pads on row vp), applied as `_propagate` applies it; rows
        without edges in the part keep their label.  (Host scalars only:
        a scalar placed on the card would add a host sync a part.)"""
        fl, vp = labels.shape
        valid = row < vp
        lab = torch.where(valid, full[nbr.long()], _BIG)
        base = torch.arange(fl, device=labels.device).unsqueeze(1) * vp
        grow = torch.where(valid, row.long() + base, fl * vp)
        new = self._mode_fold(grow.reshape(-1), lab.reshape(-1), lut,
                              fl * vp).view(fl, vp)
        keep = ~dev.inner_mask | (dev.out_degree == 0) | (new == _BIG)
        return torch.where(keep, labels, new)

    def inceval_pipelined(self, ctx: StepContext, dev, state, xbuf):
        """The pipelined round: the boundary rows' mode fold, the label
        kickoff on the side stream, the interior rows' fold under it,
        the join -- bit-equal to `inceval` (the fold groups by row)."""
        pl = self._pipeline
        labels = state["labels"]
        lut = state["lut"]
        step = state["step"] + 1
        bmask = state["pl_bmask"]
        full = pl.splice(labels, xbuf)
        new_b = self._part_fold(dev, full, state["pl_b_row"],
                                state["pl_b_nbr"], lut, labels)
        xbuf2 = pl.kickoff(ctx, torch.where(bmask, new_b, labels), state)
        # ---- pipelined window: every carry read below is named in
        # parallel/pipeline.PIPELINE_WINDOW_READS (grape-lint R6) ----
        new_i = self._part_fold(dev, full, state["pl_i_row"],
                                state["pl_i_nbr"], lut, labels)
        new = torch.where(bmask, new_b, new_i)
        active = (step < self.max_round).to(torch.int32)
        pl.join()
        return {"labels": new, "step": step}, active, xbuf2

    def _propagate(self, ctx, dev, labels, lut):
        oe = dev.oe
        fl, vp = labels.shape  # the slab's rows (every fragment's alone)
        big = torch.tensor(_BIG, dtype=labels.dtype, device=labels.device)
        full = ctx.gather_state(labels)
        lab = torch.where(oe.edge_mask, full[oe.edge_nbr], big)
        base = torch.arange(fl, device=labels.device).unsqueeze(1) * vp
        row = torch.where(oe.edge_mask, oe.edge_src.long() + base, fl * vp)
        new = self._mode_fold(row.reshape(-1), lab.reshape(-1), lut,
                              fl * vp).view(fl, vp)
        keep = ~dev.inner_mask | (dev.out_degree == 0) | (new == big)
        return torch.where(keep, labels, new)

    def peval(self, ctx: StepContext, dev, state):
        # reference PEval: step 1, one propagation
        labels = self._propagate(ctx, dev, state["labels"], state["lut"])
        step = torch.ones((), dtype=torch.int32, device=labels.device)
        return (dict(state, labels=labels, step=step),
                1 if self.max_round > 1 else 0)

    def inceval(self, ctx: StepContext, dev, state):
        step = state["step"] + 1
        labels = self._propagate(ctx, dev, state["labels"], state["lut"])
        active = (step < self.max_round).to(torch.int32)
        return dict(state, labels=labels, step=step), active


    def invariants(self, frag, state):
        # labels are NOT monotone under mode adoption (the most frequent
        # neighbour label can exceed the current one), so the invariant
        # is universe membership: every label is an id that existed at
        # init (at most the universe's largest id) or the pad sentinel.
        # The JAX package reads that id off its carried `lut`; here the
        # lut is an ephemeral leaf, so init_state keeps its largest id.
        # Across ranks a probe sums the slabs' counts of bad labels.
        from libgrape_lite_tpu_torch.guard.invariants import Invariant

        app = self

        def bad(prev, cur):
            lab = cur["labels"]
            big = torch.iinfo(lab.dtype).max
            max_id = app._label_max.to(lab.dtype)
            return ~((lab >= 0) & ((lab <= max_id) | (lab == big)))

        def in_universe(dev, prev, cur):
            nbad = bad(prev, cur).sum()
            return nbad == 0, nbad.to(torch.float32)

        return [Invariant(
            "cdlp_label_universe", in_universe, ("labels",),
            "labels stay within the initial id universe (or the pad "
            "sentinel)", bad=bad,
        )]

    def finalize(self, frag, state):
        labels = state["labels"].numpy()
        if not frag.is_string_keyed():
            return labels
        # the device labels are pid surrogates: map them back to the
        # string oids (JAX `models/cdlp.py:319`)
        out = np.full(labels.shape, -1, dtype=object)
        real = (labels >= 0) & (labels < frag.fnum * frag.vp)  # not pads
        out[real] = frag.pid_to_oid(labels[real])
        return out


class CDLPOpt(CDLP):
    """CDLP with the reference's first-round shortcut (`cdlp_opt`,
    `cdlp_opt_ud`, `cdlp_opt_ud_dense`; reference `cdlp_opt.h:139-162`,
    `cdlp_opt_ud.h:148-162`; JAX `models/cdlp.py:334-372`): the initial
    labels are all distinct, so "most frequent, ties to the smallest"
    is the plain neighbour minimum, one O(E) pull instead of the sort
    for round 1.  Like the reference's, the shortcut assumes a simple
    graph: a parallel edge (or an undirected self-loop, stored twice)
    gives its label multiplicity 2 in round 1, and the mode can then
    differ from the minimum.

    The pull runs on the gather-reduce kernel, which takes int32: it
    takes the minimum of each neighbour label's int32 rank in the static
    sorted universe `lut` and maps it back through `lut`.  Ranks keep the
    labels' order, so the result is exact.  Later rounds are CDLP's."""

    def peval(self, ctx: StepContext, dev, state):
        labels, lut = state["labels"], state["lut"]
        rank = torch.searchsorted(lut, labels).to(torch.int32)
        mn = spmv.gather_reduce(dev.oe.indptr, dev.oe.edge_nbr, None,
                                ctx.gather_state(rank), "min")
        none = mn == np.iinfo(np.int32).max  # rows without out-edges
        keep = ~dev.inner_mask | (dev.out_degree == 0) | none
        new = torch.where(keep, labels,
                          lut[torch.where(none, 0, mn).long()])
        step = torch.ones((), dtype=torch.int32, device=labels.device)
        return (dict(state, labels=new, step=step),
                1 if self.max_round > 1 else 0)
