"""BFSOpt -- direction-optimizing BFS (Beamer push/pull switching).

Counterpart of `libgrape_lite_tpu/models/bfs_opt.py` (reference
`examples/analytical_apps/bfs/bfs_opt.h`): level-synchronous BFS that
pushes while the frontier is sparse and pulls once the frontier's
out-edge volume approaches the unexplored edge volume, switching back
when the frontier thins out:

    push -> pull  when  m_f > m_u // alpha
    pull -> push  when  n_f < n // beta

with m_f the frontier's out-edges, m_u the out-edges of unvisited
vertices, n_f the frontier's vertices, and Beamer's alpha 14, beta 24.

Both directions run on the gather-reduce kernel (int32 min, no
weights).  A push round sends `where(frontier, depth + 1, sentinel)`
through `exchange_relax` (a masked pull on one device) with the
capacity accounting of sssp_msg; a pull round takes the
minimum depth over every in-neighbour, plus one.  Both are the same
monotone min relaxation, so depths are exact whatever the switch points;
the switch decides only the work.  The host reads the largest message
count and n_f, m_f, m_u with one `.tolist()` a round (`round_scalars`:
across processes the whole graph's, through one all_gather, so every
rank switches in the same rounds).
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
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_SENTINEL = np.iinfo(np.int32).max
_OUT_SENTINEL = np.iinfo(np.int64).max


class BFSOpt(ExchangeAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    result_format = "int"
    _ALPHA = 14
    _BETA = 24

    def __init__(self, initial_capacity: int | None = None):
        super().__init__(initial_capacity)
        self.pull_rounds = 0
        self.push_rounds = 0

    @staticmethod
    def _pull(ctx, dev, depth):
        near = spmv.gather_reduce(dev.ie.indptr, dev.ie.edge_nbr, None,
                                  ctx.gather_state(depth), "min")
        return torch.where(near != _SENTINEL, near + 1, near)

    def host_compute(self, frag, source=0, max_rounds: int | None = None,
                     ctx=None):
        ctx = make_context(self, frag) if ctx is None else ctx
        device, dev = frag.device, frag.dev
        pid = resolve_source(frag, source, "BFSOpt")
        depth, frontier = source_slab(frag, pid, _SENTINEL, torch.int32)
        deg = dev.out_degree.to(torch.int64)
        dest_deg = dest_degree(frag)
        total_v = frag.total_vertices_num
        limit = max_rounds if (max_rounds and max_rounds > 0) else None

        cap = self._initial_cap(frag)
        self.rounds = self.retries = self.push_rounds = self.pull_rounds = 0
        # pre-round stats for the first decision
        n_f, m_f = (1, 0) if pid >= 0 else (0, 0)
        m_u = frag.total_edges_num * (1 if frag.directed else 2)
        pulling = False
        while n_f > 0 and (limit is None or self.rounds < limit):
            # Beamer switch on the current frontier
            if not pulling and m_f > m_u // self._ALPHA:
                pulling = True
            elif pulling and n_f < total_v // self._BETA:
                pulling = False
            if pulling:
                relaxed, sent = self._pull(ctx, dev, depth), torch.zeros(
                    (), dtype=torch.int64, device=device)
            else:
                cand = torch.where(frontier, depth + 1, _SENTINEL)
                relaxed, sent = exchange_relax(dev, cand, frontier, dest_deg,
                                               None, ctx)
            new = torch.minimum(depth, relaxed)
            new_frontier = (new < depth) & dev.inner_mask
            unvisited = dev.inner_mask & (new == _SENTINEL)
            sent, n_f_d, m_f_d, m_u_d = round_scalars(ctx, [
                ("max", sent), ("sum", new_frontier.sum()),
                ("sum", torch.where(new_frontier, deg, 0).sum()),
                ("sum", torch.where(unvisited, deg, 0).sum())])
            cap = self._fit_cap(cap, sent)
            depth, frontier = new, new_frontier
            n_f, m_f, m_u = n_f_d, m_f_d, m_u_d
            self.rounds += 1
            if pulling:
                self.pull_rounds += 1
            else:
                self.push_rounds += 1
        self._save_cap(frag, cap)
        return {"depth": depth}

    def finalize(self, frag, state):
        d = state["depth"].numpy().astype(np.int64)
        return np.where(d == _SENTINEL, _OUT_SENTINEL, d)
