"""App-framework API: the PIE model on stacked fragments.

Counterpart of `libgrape_lite_tpu/app/base.py` (reference `grape/app/*`).
An app provides

  * `init_state(frag, **query_args)` -- host side: the initial state, a
    dict of numpy arrays or tensors stacked `[fnum, ...]`;
  * `peval(ctx, dev, state) -> (state, active)` -- the first superstep;
  * `inceval(ctx, dev, state) -> (state, active)` -- repeated while the
    active vote is positive and the round limit is not reached;
  * `finalize(frag, state) -> np.ndarray [fnum, vp]`.

`dev` is the fragment's `DeviceFragment`; all fragments sit stacked on
one device, so the JAX package's per-shard collectives become operations
over the leading axis (`StepContext`).
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet

import numpy as np
import torch

from libgrape_lite_tpu_torch.parallel.message_manager import (
    AutoParallelMessageManager,
)
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_LOG = logging.getLogger(__name__)


class StepContext:
    """Per-superstep toolkit.  Per-fragment values carry the stacked
    `[fnum, ...]` axis first; the reductions fold it away (the JAX
    package's psum/pmin/pmax over the fragment mesh axis)."""

    @staticmethod
    def gather_state(x: torch.Tensor) -> torch.Tensor:
        """[fnum, vp, ...] -> the full pid-indexed [fnum * vp, ...]."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    @staticmethod
    def sum(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    @staticmethod
    def min(x: torch.Tensor) -> torch.Tensor:
        return x.amin(dim=0)

    @staticmethod
    def max(x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)


def resolve_source(frag, source, app_name: str) -> int:
    """oid -> pid for a query source; logs when the oid is absent."""
    pid = int(frag.oid_to_pid(np.array([source]))[0])
    if pid < 0:
        _LOG.warning("%s: source %r is not in the vertex map; all "
                     "vertices will be unreachable", app_name, source)
    return pid


class AppBase:
    # trait parity (parallel_app_base.h:42-46)
    load_strategy: LoadStrategy = LoadStrategy.kBothOutIn
    message_strategy: MessageStrategy = MessageStrategy.kSyncOnOuterVertex
    need_split_edges: bool = False

    # state keys that are read-only inputs of every round rather than
    # loop state; the worker leaves them out of the result state
    ephemeral_keys: FrozenSet[str] = frozenset()

    # 0 means "run until the termination vote fires"
    max_rounds: int = 0

    # output formatting: float | int | sssp_infinity
    result_format: str = "float"

    def init_state(self, frag, **query_args) -> Dict:
        raise NotImplementedError

    def peval(self, ctx: StepContext, dev, state: Dict):
        raise NotImplementedError

    def inceval(self, ctx: StepContext, dev, state: Dict):
        raise NotImplementedError

    def finalize(self, frag, state: Dict) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def segment_reduce(values, edge_src, vp, kind="sum"):
        """Reduce per-edge values into per-vertex rows; padded edges fall
        into the overflow row `vp`, which is sliced off."""
        from libgrape_lite_tpu_torch.ops.segment import segment_reduce

        return segment_reduce(values, edge_src, vp, kind)


class ParallelAppBase(AppBase):
    """Explicit-messaging superstep app (reference ParallelAppBase)."""


class BatchShuffleAppBase(AppBase):
    """Whole-array mirror-sync app (PageRank-style)."""

    message_strategy = MessageStrategy.kSyncOnOuterVertex


class AutoAppBase(AppBase):
    """Auto-messaging app (reference `auto_app_base.h:38-84` +
    `auto_parallel_message_manager.h:47-365`; JAX `app/base.py:377-418`):
    the app registers SyncBuffers (state key -> aggregate op) and writes
    only the local compute; messaging is implicit.

    `propose(ctx, dev, state)` returns, per synced key, each fragment's
    pid-indexed proposals `[fnum, fnum * vp]` (the neutral element where
    a fragment has nothing to say: the push of generateAutoMessages);
    `AutoParallelMessageManager.sync` folds them with the buffer's op
    (aggregateAutoMessages) and hands each fragment its slice to
    `update` (by default: adopt it, vote the changed inner vertices)."""

    sync_buffers: Dict[str, str] = {}

    def propose(self, ctx: StepContext, dev, state: Dict) -> Dict:
        raise NotImplementedError

    def update(self, ctx: StepContext, dev, state: Dict, combined: Dict):
        changed_any = 0
        new_state = dict(state)
        for k in self.sync_buffers:
            new = combined[k]
            changed = (new != state[k]) & dev.inner_mask
            changed_any = changed_any + changed.sum()
            new_state[k] = new
        return new_state, changed_any

    def peval(self, ctx: StepContext, dev, state: Dict):
        return state, 1

    def inceval(self, ctx: StepContext, dev, state: Dict):
        combined = AutoParallelMessageManager.sync(
            dev, self.propose(ctx, dev, state), self.sync_buffers)
        return self.update(ctx, dev, state, combined)
