"""SSSPMsg -- SSSP over the point-to-point message path; BFSMsg, its
unit-weight twin.

Counterpart of `libgrape_lite_tpu/models/sssp_msg.py` (reference
`sssp.h`, whose frontier vertices push relaxations to the owners of
their out-neighbours).  Each round the vertices whose distance improved
in the previous round send `dist + w` along their out-edges, and every
vertex keeps the minimum it receives: `exchange_relax`, a masked pull
through the gather-reduce kernel on one device.  When a round's
messages would overflow the per-destination capacity, the JAX app
discards the round and re-runs it with the capacity doubled (the
reference's `EstimateMessageSize` role).  The pull here is exact at any
capacity, so the round is kept and only the capacity and the retries
grow as the JAX app's do (`ExchangeAppBase._fit_cap`).  One host read a
round: the largest message count and the active count together
(`round_scalars`; across processes one all_gather first, so every rank
doubles and stops in the same rounds).

The result equals models/sssp.py's; rounds are the push Bellman-Ford
rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import make_context, resolve_source
from libgrape_lite_tpu_torch.models.exchange_base import (
    ExchangeAppBase,
    dest_degree,
    exchange_relax,
    round_scalars,
    source_slab,
)
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class SSSPMsg(ExchangeAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongEdgeToOuterVertex
    result_format = "sssp_infinity"
    needs_edata = True

    def _relax(self, ctx, frag, dist, changed, dest_deg, w):
        """Minimum received candidate per vertex, and the largest
        per-fragment-pair message count."""
        return exchange_relax(frag.dev, dist, changed, dest_deg, w, ctx)

    def _weights(self, frag, dt):
        return frag.dev.ie.edge_w.to(dt)

    def host_compute(self, frag, source=0, max_rounds: int | None = None,
                     ctx=None):
        ctx = make_context(self, frag) if ctx is None else ctx
        dt = self.dtype
        pid = resolve_source(frag, source, type(self).__name__)
        dist, changed = source_slab(frag, pid, float("inf"), dt)
        w = self._weights(frag, dt)
        dest_deg = dest_degree(frag)
        inner = frag.dev.inner_mask
        cap = self._initial_cap(frag)
        self.rounds = self.retries = 0
        limit = max_rounds if (max_rounds and max_rounds > 0) else None
        active = 1
        # guard/ft hooks at round boundaries (the loop's consistent cuts)
        hooks = self._round_hooks(frag, {"dist": dist})
        while active > 0 and (limit is None or self.rounds < limit):
            relaxed, sent = self._relax(ctx, frag, dist, changed, dest_deg,
                                        w)
            new = torch.minimum(dist, relaxed)
            new_changed = (new < dist) & inner
            sent, n_active = round_scalars(
                ctx, [("max", sent), ("sum", new_changed.sum())])
            cap = self._fit_cap(cap, sent)
            dist, changed, active = new, new_changed, n_active
            self.rounds += 1
            if hooks.armed:
                dist = hooks.observe({"dist": dist}, self.rounds,
                                     active)["dist"]
        self._save_cap(frag, cap)
        return {"dist": dist}

    def finalize(self, frag, state):
        return np.asarray(state["dist"].numpy())


class BFSMsg(SSSPMsg):
    """BFS levels over the message path (unit-weight Bellman-Ford, the
    frontier messages of the reference's `bfs.h`).  Levels are float32
    distances, exact to 2^24 levels; the output is the reference's
    integer depths with the int64 maximum for unreached vertices
    (`bfs_context.h:44`)."""

    result_format = "int"
    needs_edata = False

    def __init__(self, initial_capacity: int | None = None):
        # levels never depend on edge data
        super().__init__(initial_capacity, torch.float32)

    def _weights(self, frag, dt):
        return None

    def _relax(self, ctx, frag, dist, changed, dest_deg, w):
        # min(d) + 1 == min(d + 1): float addition is monotone, inf stays
        relaxed, sent = exchange_relax(frag.dev, dist, changed, dest_deg,
                                       None, ctx)
        return relaxed + 1, sent

    def finalize(self, frag, state):
        d = state["dist"].numpy()
        out = np.full(d.shape, np.iinfo(np.int64).max, dtype=np.int64)
        finite = np.isfinite(d)
        out[finite] = d[finite].astype(np.int64)
        return out
