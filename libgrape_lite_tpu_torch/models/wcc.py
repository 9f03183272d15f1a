"""WCC -- weakly connected components by min-label propagation.

Counterpart of `libgrape_lite_tpu/models/wcc.py` (reference
`examples/analytical_apps/wcc/wcc.h`): labels start as pids (padded rows
hold the INT32_MAX sentinel, so they never win a min) and each round
pulls the minimum label over the in-neighbourhood, then, on directed
graphs, over the out-neighbourhood of the labels just folded -- both
through the gather-reduce kernel (int32 kind `min`, no weights; rows
without edges come back as the sentinel, which never lowers a label).
Undirected graphs store one symmetrised CSR, so one pull suffices.
Labels are canonicalised on the host to the representative's oid (the
LDBC check is partition isomorphism, `misc/wcc_check.cc`).  Integer min
is exact in any order, so labels and round counts equal the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_SENTINEL = np.iinfo(np.int32).max


class WCC(ParallelAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"

    def init_state(self, frag, **_):
        pids = torch.arange(frag.fnum * frag.vp, dtype=torch.int32,
                            device=frag.device).view(frag.fnum, frag.vp)
        comp = torch.where(frag.dev.inner_mask, pids,
                           torch.tensor(_SENTINEL, dtype=torch.int32,
                                        device=frag.device))
        return {"comp": comp}

    def peval(self, ctx: StepContext, dev, state):
        return state, 1

    @staticmethod
    def _pull(ctx, comp, csr):
        return spmv.gather_reduce(csr.indptr, csr.edge_nbr, None,
                                  ctx.gather_state(comp), "min")

    def _post_pull(self, ctx: StepContext, dev, new):
        """Hook between the neighbour pulls and the change count; WCCOpt
        puts pointer jumping here."""
        return new

    def inceval(self, ctx: StepContext, dev, state):
        comp = state["comp"]
        new = torch.minimum(comp, self._pull(ctx, comp, dev.ie))
        if dev.directed:
            new = torch.minimum(new, self._pull(ctx, new, dev.oe))
        new = self._post_pull(ctx, dev, new)
        changed = (new < comp) & dev.inner_mask
        return {"comp": new}, ctx.sum(changed.sum(dim=-1))

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
