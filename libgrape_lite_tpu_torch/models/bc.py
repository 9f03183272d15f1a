"""BC -- single-source betweenness centrality (Brandes).

Counterpart of `libgrape_lite_tpu/models/bc.py` (reference
`examples/analytical_apps/bc/bc.h`, forward path counting then a backward
dependency sweep, `bc.h:162-178, 199-220`; `bc`, `staged_bc` and
`staged_bc_bfs` all name it).  PEval runs both stages level by level:

  forward d -> d+1:   pn[v] = sum of pn[u] over in-neighbours u at depth d;
                      vertices first reached get depth d + 1;
  backward d+1 -> d:  delta[u] = pn[u] * sum over in-neighbours v at depth
                      d + 1 of (1 + delta[v]) / pn[v].

Each level is one gather-reduce (float kind `sum`) over the in-edge CSR.
The per-edge mask of the JAX package (the neighbour's depth) depends only
on the neighbour, so it becomes a masked state vector: x = pn where
depth == d, else 0.  The JAX package's two `lax.while_loop`s become host
loops: the forward loop reads the count of newly reached vertices once a
level; the backward loop knows its levels and reads nothing.

The state's type is float32 on the card and float64 on the CPU, unless
the caller names one (`dtype`).  Path counts are integers: exact in any order while
they stay below 2^24 (float32) or 2^53 (float64), so `pn` equals the JAX
package's bit for bit there; the dependencies regroup float sums and
agree to a tolerance.  Output value: the dependency (the reference's
`centrality_value`).

Under a process group a rank holds its slab of `depth`, `pn` and
`delta` and pulls from the gathered state; the forward loop's count of
newly reached vertices is global (`ctx.sum`), so every rank runs the same
levels, and the backward sweep accumulates on the slab.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    ParallelAppBase,
    StepContext,
    local_frags,
    resolve_source,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_SENT = np.iinfo(np.int32).max


class BC(ParallelAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "float"

    def __init__(self, dtype: torch.dtype | None = None):
        self.dtype = dtype
        self.levels = 0

    def init_state(self, frag, source=0):
        vp, dev = frag.vp, frag.device
        fl, lo = local_frags(frag)
        dt = self.dtype or (torch.float32 if torch.device(dev).type == "cuda"
                            else torch.float64)
        depth = torch.full((fl, vp), _SENT, dtype=torch.int32, device=dev)
        pn = torch.zeros((fl, vp), dtype=dt, device=dev)
        pid = resolve_source(frag, source, "BC")
        if pid >= 0 and lo <= pid // vp < lo + fl:  # the owner's slab
            depth[pid // vp - lo, pid % vp] = 0
            pn[pid // vp - lo, pid % vp] = 1.0
        return {"depth": depth, "pn": pn, "delta": torch.zeros_like(pn)}

    def peval(self, ctx: StepContext, dev, state):
        ie = dev.ie
        depth, pn = state["depth"], state["pn"]
        zero = pn.new_zeros(())

        def pull(x):
            return spmv.gather_reduce(ie.indptr, ie.edge_nbr, None,
                                      ctx.gather_state(x), "sum")

        d, n_new = 0, 1
        while n_new > 0:
            acc = pull(torch.where(depth == d, pn, zero))
            newly = (depth == _SENT) & (acc > 0)
            depth = torch.where(newly, d + 1, depth)
            pn = torch.where((depth == d + 1) & dev.inner_mask, acc, pn)
            d += 1
            n_new = int(ctx.sum((newly & dev.inner_mask).sum(dim=-1)))
        self.levels = d

        pn_floor = pn.clamp(min=torch.finfo(pn.dtype).tiny)
        delta = torch.zeros_like(pn)
        for d in range(self.levels, 0, -1):
            acc = pull(torch.where(depth == d, (1.0 + delta) / pn_floor, zero))
            delta = torch.where((depth == d - 1) & dev.inner_mask, pn * acc,
                                delta)
        return {"depth": depth, "pn": pn, "delta": delta}, 0

    def inceval(self, ctx, dev, state):
        return state, 0


    def invariants(self, frag, state):
        # Brandes partials: shortest-path counts and dependencies are
        # finite and nonnegative (in_range(lo=0) rejects NaN); depth is
        # the BFS level or the untouched sentinel
        from libgrape_lite_tpu_torch.guard.invariants import (
            finite, in_range,
        )

        return [
            finite("pn"),
            in_range("pn", lo=0),
            finite("delta"),
            in_range("delta", lo=0),
            in_range("depth", lo=0, hi=_SENT),
        ]

    def finalize(self, frag, state):
        return np.asarray(state["delta"].numpy())
