"""CoreDecomposition -- per-vertex core numbers by level peeling.

Counterpart of `libgrape_lite_tpu/models/core_decomposition.py`
(reference `examples/analytical_apps/core_decomposition/
core_decomposition.h`): at level L, every alive vertex whose residual
degree is at most L is pinned to core number L, sub-round after
sub-round, until the level drains; then the level advances.  One IncEval
is one synchronous sub-round: the residual degrees are one gather-reduce
(int32 kind `sum`) of the alive bitmap over the in-edge CSR.  On a
sub-round that pins nothing the level jumps to max(level + 1, the
smallest residual degree still alive), skipping empty levels, exactly as
in the JAX package.

The level stays on the device: the pinned and alive counts and the
smallest residual degree feed it there, so the round's only host read is
the worker's vote (alive vertices remain).  Core numbers and round
counts equal the JAX package's.  Under a process group a rank holds
its slab of `core` and `alive`; the counts and the smallest residual are
global (`ctx.sum`, `ctx.min`), so `level` and the vote agree on every
rank.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import ParallelAppBase, StepContext
from libgrape_lite_tpu_torch.models.kcore import alive_neighbours
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_INT32_MAX = np.iinfo(np.int32).max


class CoreDecomposition(ParallelAppBase):
    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"
    replicated_keys = frozenset({"level"})
    # the round vote is global (alive vertices remain anywhere)
    replicated_vote = True

    def init_state(self, frag, **_):
        dev = frag.device
        alive = frag.dev.inner_mask.clone()  # the rank's slab under a group
        return {
            "core": torch.zeros(alive.shape, dtype=torch.int32, device=dev),
            "alive": alive,
            "level": torch.ones((), dtype=torch.int32, device=dev),
        }

    def peval(self, ctx: StepContext, dev, state):
        return dict(state, alive=state["alive"] & (dev.out_degree > 0)), 1

    def inceval(self, ctx: StepContext, dev, state):
        core, alive, level = state["core"], state["alive"], state["level"]
        resid = alive_neighbours(ctx, dev, alive)
        pin = alive & (resid <= level)
        alive2 = alive & ~pin
        n_pinned = ctx.sum(pin.sum(dim=-1))
        min_resid = ctx.min(torch.where(
            alive2, resid, _INT32_MAX).amin(dim=-1))
        level2 = torch.where(n_pinned == 0,
                             torch.maximum(level + 1, min_resid), level)
        state = {"core": torch.where(pin, level, core), "alive": alive2,
                 "level": level2}
        return state, ctx.sum(alive2.sum(dim=-1)) > 0


    def invariants(self, frag, state):
        # coreness algebra: core numbers are written exactly once
        # (0 -> level) and never negative; the peeling level only
        # advances; dead vertices never resurrect
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range,
            monotone_non_decreasing,
            monotone_non_increasing,
            set_once,
        )

        return [
            in_range("core", lo=0),
            set_once("core", unset=0),
            monotone_non_decreasing("level"),
            monotone_non_increasing("alive"),
        ]

    def finalize(self, frag, state):
        return state["core"].numpy().astype(np.int64)
