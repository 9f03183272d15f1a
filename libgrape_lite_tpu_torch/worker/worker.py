"""Superstep driver.

Counterpart of `libgrape_lite_tpu/worker/worker.py` (reference
`grape/worker/worker.h:48-232`).  `query` runs PEval, then IncEval while
the active vote is positive and fewer than the round limit have run --
the semantics of the JAX package's fused `while_loop` runner, with
`rounds` counting IncEval calls.  Here the loop runs on the host and
reads the vote back each round.  Apps with `host_only` set run their
own round loop (`host_compute`) instead.

The dynamic-graph hooks of the JAX worker sit in the same loop: a
MutationContext app (`collect_mutations`) has its staged edits applied
after PEval and after every round, the fragment rebuilt and the state
migrated by oid; `query` refuses an app without an overlay contract
while the fragment holds staged delta edges; and `query_incremental`
seeds a query from a previous result (dyn/incremental.py).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import AppBase, StepContext
from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment

_INT32_MAX = np.iinfo(np.int32).max
_LOG = logging.getLogger(__name__)


def _to_host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _place(v, device: torch.device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v, order="C")).to(device)
    return torch.as_tensor(v, device=device)


class Worker:
    """Binds an app to a fragment and runs queries
    (reference `Worker<APP_T, MESSAGE_MANAGER_T>`)."""

    def __init__(self, app: AppBase, fragment: ShardedEdgecutFragment):
        self.app = app
        self.fragment = fragment
        self.rounds = 0
        self._result_state = None
        # the fragment each result was computed on: query_incremental's
        # prev_fragment default once a repack rebinds self.fragment
        self._result_fragment = None
        # dyn/: incremental-IncEval accounting -- seeded versus counted
        # cold runs, and the last call's plan
        self.inc_stats = {"seeded": 0, "cold": 0}
        self.inc_report = None
        self._seed_fn = None  # set only inside query_incremental

    def _check_dyn_view(self) -> None:
        """An app without an overlay contract must not run while the
        fragment holds staged delta edges: it would compute on the stale
        base graph."""
        ov = getattr(self.fragment, "dyn_overlay", None)
        if (ov is not None and ov.count > 0
                and not getattr(self.app, "dyn_overlay_support", False)):
            raise ValueError(
                f"{type(self.app).__name__} has no dyn-overlay contract "
                f"and the fragment carries {ov.count} staged delta "
                "edge(s); fold them first (DynGraph.fold_now)")

    def query(self, max_rounds: int | None = None, *,
              initial_state: Dict | None = None, **query_args):
        """Run one query (reference `Worker::Query`, worker.h:104-146).

        `initial_state` (numpy arrays or tensors) replaces entries of the
        state `init_state` built, before PEval runs; every key must be
        one that `init_state` produced."""
        self._check_dyn_view()
        app, frag = self.app, self.fragment
        mr = app.max_rounds if max_rounds is None else max_rounds
        if getattr(app, "host_only", False):
            return self._query_host(mr, initial_state, query_args)
        state = app.init_state(frag, **query_args)
        if self._seed_fn is not None:  # inside query_incremental
            state = self._seed_fn(state)
        for k, v in (initial_state or {}).items():
            if k not in state:
                raise KeyError(f"initial_state key {k!r} is not a state key "
                               f"of {type(app).__name__}")
            state[k] = v
        state = {k: _place(v, frag.device) for k, v in state.items()}

        mutating = hasattr(app, "collect_mutations")
        ctx = StepContext()
        state, active = app.peval(ctx, frag.dev, state)
        active = int(active)
        if mutating:
            # edits staged during PEval apply even when the query would
            # converge at once (worker.h:211-222); a ForceTerminate vote
            # (negative) still wins
            state, frag, changed = self._apply_mutations(
                state, frag, 0, query_args)
            if changed and active >= 0:
                active = 1
        limit = mr if mr > 0 else _INT32_MAX
        rounds = 0
        while active > 0 and rounds < limit:
            state, active = app.inceval(ctx, frag.dev, state)
            active = int(active)  # the termination vote, read back
            rounds += 1
            if mutating:
                state, frag, changed = self._apply_mutations(
                    state, frag, rounds, query_args)
                if changed and active >= 0:
                    active = 1  # the new topology must be evaluated
                    if rounds >= limit:
                        _LOG.info("mutation applied on the final permitted "
                                  "round; the rebuilt topology was NOT "
                                  "re-evaluated -- raise max_rounds")
        self.rounds = rounds
        return self._keep(state)

    def _apply_mutations(self, state: Dict, frag, rounds: int,
                         query_args: Dict):
        """MutationContext (reference worker.h:211-222, JAX
        `worker.py:2164-2200`): the app's staged edits rebuild the
        fragment, which this worker adopts; the state is re-initialised
        on it and the old rows migrate by oid.  Returns
        (state, fragment, changed)."""
        app = self.app
        host_state = {k: _to_host(v) for k, v in state.items()}
        mutator = app.collect_mutations(frag, host_state, rounds)
        if mutator is None:
            return state, frag, False
        old_frag = frag
        frag = mutator.mutate(frag)
        self.fragment = frag
        fresh = {k: _to_host(v)
                 for k, v in app.init_state(frag, **query_args).items()}
        migrated = app.migrate_state(old_frag, frag, host_state, fresh)
        _LOG.debug("applied mutations after round %d", rounds)
        return ({k: _place(v, frag.device) for k, v in migrated.items()},
                frag, True)

    def query_incremental(self, prev_result: Dict, delta=None,
                          max_rounds: int | None = None, *,
                          prev_fragment=None, **query_args):
        """Incremental IncEval (dyn/): run this query seeded from
        `prev_result` -- the state a previous query of the SAME app and
        arguments returned on the pre-delta graph.

        `delta` describes the change (a dyn.DeltaBuffer or its
        `summary()`, or an ingest report's "delta"); the app's `inc_mode`
        decides: "monotone-min" with an additive delta seeds the carry
        with min(fresh init, migrated prev) per `inc_seed_keys` key --
        equal to a cold query on the mutated graph, usually in fewer
        rounds; anything else runs the cold query, counted in
        `inc_stats["cold"]`.

        `prev_fragment` is the fragment `prev_result` was computed on,
        when a repack replaced it (rows migrate by oid, values through
        the app's `inc_value_map`).  By default it is the fragment this
        worker's last query ran on."""
        from libgrape_lite_tpu_torch.dyn.incremental import (
            incremental_plan,
            reseed_fold,
        )

        app = self.app
        mode, reason = incremental_plan(app, delta)
        self.inc_report = {"mode": mode, "reason": reason}
        self.inc_stats[mode] += 1
        if mode == "cold":
            _LOG.debug("query_incremental: cold recompute (%s)", reason)
            return self.query(max_rounds, **query_args)
        prev_frag = prev_fragment or self._result_fragment or self.fragment
        prev = {k: v for k, v in prev_result.items()
                if k in app.inc_seed_keys}
        self._seed_fn = lambda fresh: {
            **fresh,
            **reseed_fold(app, self.fragment, fresh, prev_frag, prev),
        }
        try:
            return self.query(max_rounds, **query_args)
        finally:
            self._seed_fn = None

    def _query_host(self, mr: int, initial_state, query_args):
        """Host-driven apps (the exchange apps: capacity retries, bucket
        advances and push/pull switches decide each round on the host)
        run their own loop, under the same round limit (JAX
        `worker.py:1208-1230`)."""
        app = self.app
        if initial_state:
            raise ValueError(f"{type(app).__name__} runs its own host loop "
                             "and takes no initial_state")
        state = app.host_compute(self.fragment, max_rounds=mr, **query_args)
        self.rounds = app.rounds
        return self._keep(state)

    def _keep(self, state: Dict) -> Dict:
        eph = self.app.ephemeral_keys
        self._result_state = {
            k: v for k, v in state.items() if k not in eph
        }
        self._result_fragment = self.fragment
        return self._result_state

    # ---- Output / Assemble (reference worker.h:148-154, ctx.Output) ----

    def result_values(self) -> np.ndarray:
        """Per-vertex assembled values, [fnum, vp] numpy."""
        if self._result_state is None:
            raise RuntimeError("query() first")
        host = {k: v.cpu() for k, v in self._result_state.items()}
        return self.app.finalize(self.fragment, host)

    def output(self, prefix: str) -> None:
        """Write per-fragment result files `result_frag_<fid>` with
        `oid value` lines (reference `GetResultFilename` + ctx Output)."""
        values = self.result_values()
        os.makedirs(prefix, exist_ok=True)
        fmt = self.app.result_format
        for f in range(self.fragment.fnum):
            n = self.fragment.inner_vertices_num(f)
            oids = self.fragment.inner_oids(f)
            path = os.path.join(prefix, f"result_frag_{f}")
            with open(path, "w") as out:
                out.write(format_result_lines(oids, values[f, :n], fmt))


def format_result_lines(oids, vals, fmt: str) -> str:
    if len(oids) == 0:
        return ""
    lines = []
    if fmt == "int":
        for o, v in zip(oids.tolist(), np.asarray(vals).tolist()):
            # string-keyed graphs carry str component / community ids
            lines.append(f"{o} {v if isinstance(v, str) else int(v)}")
    elif fmt == "sssp_infinity":
        for o, v in zip(oids.tolist(), np.asarray(vals).tolist()):
            if not np.isfinite(v):
                lines.append(f"{o} infinity")
            else:
                lines.append(f"{o} {v:.15e}")
    else:
        for o, v in zip(oids.tolist(), np.asarray(vals).tolist()):
            lines.append(f"{o} {v:.15e}")
    return "\n".join(lines) + "\n"
