"""WCCOpt -- label propagation with pointer jumping (`wcc_opt`).

Counterpart of `libgrape_lite_tpu/models/wcc_opt.py` (reference
`examples/analytical_apps/wcc/wcc_opt.h`, which compresses label chains
while propagating).  Each round does WCC's neighbour-min pulls (the
gather-reduce kernel) and then the jump `comp[v] <- comp[comp[v]]`:
labels are pids, so the jump is one gather on the gathered label
vector.  Rounds drop from O(diameter) to O(log diameter) on chain-heavy
graphs; the fixed point and the output are WCC's.
"""

from __future__ import annotations

import torch

from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.models.wcc import WCC


class WCCOpt(WCC):
    def _post_pull(self, ctx: StepContext, dev, new):
        # follow the representative's representative; padded rows hold
        # the int32 sentinel, so clamp the index, and `jumped < new`
        # keeps the sentinel out of real rows
        full = ctx.gather_state(new)
        jumped = full[new.clamp(max=dev.n_pad - 1).long()]
        return torch.where(dev.inner_mask & (jumped < new), jumped, new)
