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

Batched queries (serve/, the JAX worker's `query_batch` and its vmapped
runner): k point queries of one app share one round loop over the
fragment.  An app with native lanes runs all k in each superstep (one
`gather_reduce_lanes` pull a round); any other runs each live lane's
single-lane superstep in the same loop.  A lane whose vote has reached
0 (or a negative abort) keeps its carry pinned, so every lane executes
exactly the supersteps of its own sequential query and its result is
byte-identical to `Worker.query`.  The k votes are read back as one [k]
vector a round.  `query_batch_prepare` does the host half (checks,
state built and placed); its `launch()` runs the loop in a thread of
its own, on a CUDA stream of its own, so the async serve pump
(serve/pipeline.py) can prepare and harvest other batches meanwhile.

With obs/ armed (the JAX worker's `query_stepwise` spans, `_query_
stepwise_impl`): `query` emits a `query` span (mode "host"), a `peval`
span and one `superstep` span a round, each with its `round` and its
`active` vote, mirrored onto per-fragment rows at fnum > 1, plus the
`active_vertices` counter, the `grape_active_per_round` series and
`grape_supersteps_total`; `query_batch` emits a `query` span (mode
"batched").  Each round's span is marked `dispatched` between the app's
call returning and the read of its vote, the read that already ends the
round, so arming adds no host synchronisation; every span arg is a value
the loop already holds on the host.  `--profile` (vlog level 1) logs
each round's seconds and vote.

Fault tolerance and the guards (ft/, guard/; JAX `query_stepwise` and
`resume`): the same loop takes `checkpoint_every` / `checkpoint_dir` (a
snapshot of the carry every K supersteps, copied off the card on the
loop's stream and written by a thread), `fault_plan` (GRAPE_FT_FAULTS)
and `guard` (invariant probes on the card, the divergence watchdog,
rollback to the last snapshot); `Worker.resume` continues a lineage
byte-identically.  Off, they cost one flag test a round.  The JAX
package's fused path and its degrade to stepwise have no counterpart
here: this loop is its stepwise loop.

Under a process group (the JAX worker's `jax.distributed` block) the
same hooks run across ranks: the lineage is sharded (ft/distributed.py:
a shard a rank, a two-phase commit) and a resume whose geometry differs
(another fnum or world) reshards it onto this mesh (`restore_resharded`);
the guard's probe is global (guard/monitor.py); and each round's hooks
run under the breach vote (guard/vote.py), so one rank's halt -- a
breach, an injected fault, an IO error -- halts every rank at the same
cut, with the gang's sidecars and postmortem under one incident id
(obs/gang.py).  A query folds a staged dyn overlay's `[fl, capacity]`
rows, and `query_incremental` seeds from a rank's previous result (on
the slab, or gathered, migrated by oid and cut back when the layout
changed).  Batched queries stay in one process, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    AppBase,
    is_lane_sequence,
    make_context,
)
from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.ops import _build
from libgrape_lite_tpu_torch.ops.spmv import PLAN_STATS
from libgrape_lite_tpu_torch.parallel.comm_spec import is_slab
from libgrape_lite_tpu_torch.utils import logging as glog

_INT32_MAX = np.iinfo(np.int32).max
_LOG = logging.getLogger(__name__)


def _to_host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def build_counts() -> Dict[str, int]:
    """The builds that stand for a jit-cache miss in this package: CUDA
    libraries built or loaded, and strict plan cache misses."""
    return {"library_loads": _build.LOAD_EVENTS,
            "plans": PLAN_STATS["planned"]}


def _built_marker() -> int:
    """Moves when any of `build_counts()` moves."""
    return sum(build_counts().values())


def _place(v, device: torch.device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v, order="C")).to(device)
    return torch.as_tensor(v, device=device)


def _tensors(state):
    """Every tensor of a state dict, or of a list of them."""
    states = state if isinstance(state, list) else [state]
    return [v for st in states for v in st.values()
            if isinstance(v, torch.Tensor)]


def _lane_votes(active, batch: int, device) -> torch.Tensor:
    """A lane-stacked superstep's vote as a [k] int64 tensor."""
    if isinstance(active, torch.Tensor):
        return active.to(torch.int64).reshape(-1).expand(batch)
    return torch.full((batch,), int(active), dtype=torch.int64,
                      device=device)


def _read_votes(votes: list, device) -> List[int]:
    """Per-lane votes (tensors or ints) read back in one transfer."""
    if not any(isinstance(v, torch.Tensor) for v in votes):
        return [int(v) for v in votes]
    return torch.stack([
        v.to(torch.int64).reshape(()) if isinstance(v, torch.Tensor)
        else torch.tensor(int(v), device=device) for v in votes]).tolist()


class _LaneLoop:
    """k lanes' PEval and IncEval rounds with the freeze mask (JAX
    `_lane_body`), one round at a time.  `state` is one lane-stacked dict
    (native lanes) or a list of per-lane dicts.  A lane whose vote is not
    positive -- settled, aborted, or frozen by the guard (`freeze`) --
    keeps its carry pinned, so every lane runs exactly its own
    sequential query's supersteps.  Each round reads the k votes back in
    one transfer."""

    def __init__(self, app: AppBase, frag, state, eph: frozenset,
                 batch: int):
        self.app = app
        self.dev = frag.dev
        self.ctx = make_context(app, frag)
        self.eph = eph
        self.batch = batch
        self.native = not isinstance(state, list)
        self.device = frag.dev.inner_mask.device
        self.rounds = [0] * batch
        self.r = 0
        self.act: List[int] = []
        self._act_d = None
        if self.native:
            self.eph_part = {k: v for k, v in state.items() if k in eph}
            self._carry = self._strip(state)
        else:
            self.lanes = list(state)

    def _strip(self, st: Dict) -> Dict:
        return {k: v for k, v in st.items() if k not in self.eph}

    # ---- the carry, as the guard reads and the fault hooks replace it --

    def carry(self):
        """The lane-stacked carry dict, or the k per-lane carries."""
        if self.native:
            return self._carry
        return [self._strip(st) for st in self.lanes]

    def replace(self, new) -> None:
        """Adopt replacement carry leaves: a dict of lane-stacked leaves,
        or a list with a dict (or None) a lane; values are placed on the
        fragment's device."""
        if isinstance(new, dict):
            self._carry = {**self._carry, **{
                k: _place(v, self.device) for k, v in new.items()}}
            return
        for b, lane in enumerate(new):
            if lane:
                self.lanes[b] = {**self.lanes[b], **{
                    k: _place(v, self.device) for k, v in lane.items()}}

    def freeze(self, lane: int) -> None:
        """Pin lane `lane` where it stands: its vote becomes 0."""
        self.act[lane] = 0
        if self.native:
            # a copy first (the votes may be a broadcast view), then a
            # fill on the card: no host sync
            self._act_d = self._act_d.clone()
            self._act_d[lane] = 0

    def live(self) -> bool:
        return any(a > 0 for a in self.act)

    # ---- rounds ----

    def peval(self) -> None:
        app, ctx, dev = self.app, self.ctx, self.dev
        if not self.native:
            votes = []
            for b, st in enumerate(self.lanes):
                self.lanes[b], a = app.peval(ctx, dev, st)
                votes.append(a)
            self.act = _read_votes(votes, self.device)
            return
        carry, a = app.peval(ctx, dev, {**self._carry, **self.eph_part})
        self._carry = self._strip(carry)
        self._act_d = _lane_votes(a, self.batch, self.device)
        self.act = self._act_d.tolist()

    def step(self) -> None:
        """One IncEval round of every live lane."""
        app, ctx, dev, batch = self.app, self.ctx, self.dev, self.batch
        live = [b for b in range(batch) if self.act[b] > 0]
        self.r += 1
        if not self.native:
            votes = []
            for b in live:
                self.lanes[b], a = app.inceval(ctx, dev, self.lanes[b])
                votes.append(a)
            for b, a in zip(live, _read_votes(votes, self.device)):
                self.act[b] = a
                self.rounds[b] = self.r
            return
        new, a = app.inceval(ctx, dev, {**self._carry, **self.eph_part})
        new = self._strip(new)
        a = _lane_votes(a, batch, self.device)
        if len(live) == batch:
            self._carry, self._act_d = new, a
        else:  # pin the settled and frozen lanes' carries and votes
            keep = self._act_d > 0

            def sel(v, old):
                return torch.where(
                    keep.reshape((batch,) + (1,) * (v.dim() - 1)), v, old)

            self._carry = {k: sel(v, self._carry[k]) for k, v in new.items()}
            self._act_d = torch.where(keep, a, self._act_d)
        for b in live:
            self.rounds[b] = self.r
        self.act = self._act_d.tolist()

    def result(self):
        """(state, rounds [k], votes [k])."""
        if self.native:
            return {**self._carry, **self.eph_part}, self.rounds, self.act
        return self.lanes, self.rounds, self.act


def _lane_loop(app: AppBase, frag, state, eph: frozenset, max_rounds: int,
               batch: int):
    """PEval, then IncEval while any lane's vote is positive and fewer
    than `max_rounds` rounds ran.  Returns (state, rounds [k], votes
    [k])."""
    loop = _LaneLoop(app, frag, state, eph, batch)
    limit = max_rounds if max_rounds > 0 else _INT32_MAX
    loop.peval()
    while loop.r < limit and loop.live():
        loop.step()
    return loop.result()


class BatchDispatch:
    """One launched batched query (JAX `BatchDispatch`): its outputs
    held self-contained, so a window of dispatches can coexist without
    touching the worker's own result fields.  `is_ready()` polls,
    `wait()` joins the batch's thread (and re-raises its failure),
    `lane_values(b)` moves one lane to the host and finalizes it.  A
    guarded batch also carries its verdicts: `breaches` (a diagnostic
    bundle or None a lane) and `monitors` (a GuardMonitor a lane)."""

    __slots__ = ("app", "fragment", "eph", "state", "_thread", "_error",
                 "_rounds", "_active", "breaches", "monitors")

    def __init__(self, *, app, fragment, eph):
        self.app = app
        self.fragment = fragment
        self.eph = frozenset(eph)
        self.state = None  # one lane-stacked dict, or k per-lane dicts
        self._thread = None
        self._error = None
        self._rounds = None
        self._active = None
        self.breaches = None
        self.monitors = None

    def _finish(self, state, rounds, active, breaches=None,
                monitors=None) -> None:
        self.state = state
        self._rounds = np.asarray(rounds, dtype=np.int32)
        self._active = np.asarray(active, dtype=np.int64)
        self.breaches = breaches
        self.monitors = monitors

    def is_ready(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self) -> "BatchDispatch":
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
        return self

    @property
    def rounds(self) -> np.ndarray:
        return self.wait()._rounds

    @property
    def terminate(self) -> np.ndarray:
        return np.minimum(0, self.wait()._active)

    def lane_state(self, lane: int) -> Dict:
        """Lane `lane`'s state (ephemeral leaves are shared)."""
        self.wait()
        if isinstance(self.state, list):
            return self.state[lane]
        return {k: (v if k in self.eph else v[lane])
                for k, v in self.state.items()}

    def lane_values(self, lane: int) -> np.ndarray:
        """Lane `lane`'s assembled values, [fnum, vp] numpy: its carry
        to the host (ephemeral leaves stay on the card, as
        `Worker.result_values` leaves them), then finalize."""
        host = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in self.lane_state(lane).items()
                if k not in self.eph}
        return self.app.finalize(self.fragment, host)


class PreparedBatch:
    """A batched query with its host half done -- checks passed, state
    built and placed -- and its round loop not yet started (JAX
    `PreparedBatch`).  `run()` runs the loop here; `launch()` runs it in
    a thread of its own, on a CUDA stream of its own that first waits
    for the preparing stream, and returns at once.  The stream comes
    from the worker's `idle_streams`, where finished batches put theirs
    back: the caching allocator keeps its blocks per stream, so a stream
    that served a batch already holds the memory the next one asks for.
    The batch runs on a copy of the worker's app, so batches in flight
    together never share the attributes an app sets per query.

    With `guard_cfg` enabled the loop is the guarded chunk loop
    (serve/batch.py): a probe of every lane at each chunk boundary, a
    breached lane frozen, its verdict snapshot into the dispatch; the
    values still harvest lazily, lane by lane."""

    __slots__ = ("app", "fragment", "state", "eph", "batch", "max_rounds",
                 "idle_streams", "guard_cfg", "chunk_hook")

    def __init__(self, *, app, fragment, state, eph, batch, max_rounds,
                 idle_streams, guard_cfg=None, chunk_hook=None):
        self.app = app
        self.fragment = fragment
        self.state = state
        self.eph = frozenset(eph)
        self.batch = batch
        self.max_rounds = max_rounds
        self.idle_streams = idle_streams
        self.guard_cfg = guard_cfg
        self.chunk_hook = chunk_hook

    @property
    def guarded(self) -> bool:
        return self.guard_cfg is not None and self.guard_cfg.enabled

    def _dispatch(self) -> BatchDispatch:
        return BatchDispatch(app=self.app, fragment=self.fragment,
                             eph=self.eph)

    def _loop(self):
        if self.guarded:
            from libgrape_lite_tpu_torch.serve.batch import guarded_lane_loop

            return guarded_lane_loop(
                self.app, self.fragment, self.state, self.eph,
                self.max_rounds, self.batch, self.guard_cfg,
                chunk_hook=self.chunk_hook)
        return _lane_loop(self.app, self.fragment, self.state, self.eph,
                          self.max_rounds, self.batch)

    def run(self) -> BatchDispatch:
        d = self._dispatch()
        d._finish(*self._loop())
        return d

    def launch(self) -> BatchDispatch:
        d = self._dispatch()
        device = torch.device(self.fragment.device)
        stream = None
        if device.type == "cuda":
            try:
                stream = self.idle_streams.pop()
            except IndexError:
                stream = torch.cuda.Stream(device=device)
            stream.wait_stream(torch.cuda.current_stream(device))
            # inputs made on the preparing stream stay allocated until
            # this stream's work on them is done
            for t in _tensors(self.state):
                t.record_stream(stream)

        def body():
            try:
                # a guarded batch's probe reads wait on this stream only
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    out = self._loop()
                d._finish(*out)
            except Exception as e:  # re-raised by wait()
                d._error = e
            finally:
                if stream is not None:
                    stream.synchronize()
                    self.idle_streams.append(stream)

        d._thread = threading.Thread(target=body, name="grape-batch",
                                     daemon=True)
        d._thread.start()
        return d


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
        # the last query's negative (abort) vote, else 0
        self._terminate_code = 0
        # query_batch: per-lane rounds and terminate codes, the dispatch;
        # the CUDA streams of finished launched batches (PreparedBatch)
        self.batch_rounds = None
        self.batch_terminate = None
        # a guarded batch's verdicts: a breach bundle or None a lane
        self.batch_breaches = None
        self._batch = None
        self.idle_streams: List = []
        # guard/: the last query's monitor (guard_report), None when off
        self._guard_monitor = None

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

    @property
    def guard_report(self):
        """The last query's guard statistics (probes, breaches,
        rollbacks), or None when guards were off."""
        return (None if self._guard_monitor is None
                else self._guard_monitor.report())

    def query(self, max_rounds: int | None = None, *,
              initial_state: Dict | None = None,
              checkpoint_every: int | None = None,
              checkpoint_dir: str | None = None,
              fault_plan=None, guard=None, _resume: bool = False,
              **query_args):
        """Run one query (reference `Worker::Query`, worker.h:104-146).

        `initial_state` (numpy arrays or tensors) replaces entries of the
        state `init_state` built, before PEval runs; every key must be
        one that `init_state` produced.

        ft/ and guard/ (JAX `query_stepwise`): `checkpoint_every=K`
        snapshots the carry into `checkpoint_dir` every K supersteps
        (ft/checkpoint.py; `resume` continues such a lineage);
        `fault_plan` (default: GRAPE_FT_FAULTS) injects faults at round
        boundaries; `guard` (a policy string or GuardConfig; default
        GRAPE_GUARD) probes the app's invariants and the divergence
        watchdog on the card, and under "rollback" heals from the last
        snapshot.  Off, the hooks cost one flag test a round."""
        from libgrape_lite_tpu_torch.guard.config import GuardConfig

        self._check_dyn_view()
        app, frag = self.app, self.fragment
        key = app.batch_query_key
        if key is not None and is_lane_sequence(query_args.get(key)):
            raise ValueError(
                f"{type(app).__name__}.query takes one {key} a query; run "
                f"a list of {key}s through Worker.query_batch")
        if checkpoint_dir and checkpoint_every is None and not _resume:
            raise ValueError(
                "checkpoint_dir requires checkpoint_every (a dir alone "
                "would run stepwise while writing no snapshots); to "
                "continue a previous run use Worker.resume")
        checkpointing = checkpoint_every is not None or _resume
        if checkpointing:
            if getattr(app, "host_only", False):
                raise ValueError(
                    "checkpointing requires the superstep path; "
                    f"{type(app).__name__} is a host-only app")
            if hasattr(app, "collect_mutations"):
                raise ValueError(
                    "checkpointing MutationContext apps is not supported "
                    "(the fragment itself changes between rounds)")
            if not checkpoint_dir:
                raise ValueError("checkpoint_every requires checkpoint_dir")
            if checkpoint_every is not None and checkpoint_every <= 0:
                raise ValueError(
                    f"checkpoint_every must be >= 1, got {checkpoint_every}")
        guard_cfg = GuardConfig.resolve(guard)
        self._guard_monitor = None
        mr = app.max_rounds if max_rounds is None else max_rounds
        self._check_across_ranks()
        if getattr(app, "host_only", False):
            return self._query_host(mr, initial_state, query_args, guard_cfg)
        if fault_plan is None:
            from libgrape_lite_tpu_torch.ft.faults import active_plan

            fault_plan = active_plan()
        if fault_plan.is_noop():
            fault_plan = None
        tr = obs.tracer()
        try:
            with tr.span("query", mode="host", app=type(app).__name__) as sp:
                out = self._query_rounds(
                    mr, initial_state, query_args, tr,
                    checkpoint_every=checkpoint_every,
                    checkpoint_dir=checkpoint_dir if checkpointing else None,
                    fault_plan=fault_plan, guard_cfg=guard_cfg,
                    resume=_resume)
                self._finish_query_obs(sp)
        finally:
            # a raise out of the loop still lands its spans in the sinks
            if tr.enabled:
                obs.flush()
        return out

    def _check_across_ranks(self) -> None:
        """What a query across processes (world > 1) runs: the superstep
        of the `dist_apps`, with its checkpoints, guards, fault plans
        and a staged dyn overlay (each rank folds its `[fl, capacity]`
        rows).  Any other app (a subclass, an app of the caller's)
        raises: a run never drops to one process silently."""
        world = _world(self.fragment)
        if world > 1 and type(self.app) not in dist_apps():
            raise ValueError(
                f"the app {type(self.app).__name__} does not run across "
                f"processes (world {world} > 1): it is not one of "
                "worker.dist_apps()")

    def _vc_side(self, k: str):
        """"row" / "col" for a vertex-cut carry leaf chunk-indexed by
        tile row / column (the app's `vc_row_keys` / `vc_col_keys`),
        else None."""
        if k in getattr(self.app, "vc_row_keys", ()):
            return "row"
        if k in getattr(self.app, "vc_col_keys", ()):
            return "col"
        return None

    def _slab_leaf(self, k: str, v) -> bool:
        """Whether carry leaf `k` (this rank's value `v`) is a slab of the
        fragment stack (`comm_spec.is_slab`); a vertex-cut carry has
        none."""
        if getattr(self.app, "mesh_kind", "frag") == "vc2d":
            return False
        rep = getattr(self.app, "replicated_keys", frozenset())
        return is_slab(v, self.fragment.comm_spec.fl, k in rep)

    def _whole_leaf(self, spec, k: str, v):
        """Leaf `k` of this rank's carry gathered whole: a slab leaf over
        the fragment stack, a vertex-cut chunk leaf over the grid axis
        whose ranks hold every chunk once (`CommSpec.axis_gather`); any
        other leaf as it is."""
        side = self._vc_side(k)
        if side is not None:
            from libgrape_lite_tpu_torch.parallel.comm_spec import (
                VC_COL_AXIS,
                VC_ROW_AXIS,
            )

            frag = self.fragment
            axis = VC_ROW_AXIS if side == "row" else VC_COL_AXIS
            x = v.to(torch.uint8) if v.dtype == torch.bool else v
            whole = spec.axis_gather(x.reshape(-1, frag.vc), frag.k,
                                     axis).reshape(-1)
            return whole.bool() if v.dtype == torch.bool else whole
        return _gather_leaf(spec, v) if self._slab_leaf(k, v) else v

    def _slab_of(self, full: Dict, like: Dict) -> Dict:
        """A restored whole carry cut to this rank's part: the rows
        `fid_lo .. fid_lo + fl - 1` of the leaves that are slabs in
        `like`, a vertex-cut chunk leaf's chunks of this rank's tile rows
        or columns; unchanged with one process."""
        spec = getattr(self.fragment, "comm_spec", None)
        if getattr(spec, "world", 1) <= 1:
            return full
        lo, hi = spec.fid_lo, spec.fid_lo + spec.fl

        def cut(k, v):
            side = self._vc_side(k)
            if side is not None:
                a, b = self.fragment.chunk_span(side)
                return v[..., a:b]
            if k in like and self._slab_leaf(k, like[k]):
                return v[lo:hi]
            return v

        return {k: cut(k, v) for k, v in full.items()}

    def _whole_of(self, carry: Dict) -> Dict:
        """This rank's carry with every slab or chunk leaf gathered whole
        (a collective every rank joins, in key order); unchanged with one
        process."""
        spec = getattr(self.fragment, "comm_spec", None)
        if getattr(spec, "world", 1) <= 1:
            return carry
        return {k: self._whole_leaf(spec, k, v)
                for k, v in sorted(carry.items())}

    def _open_lineage(self, state: Dict, carry: Dict, query_args: Dict, *,
                      checkpoint_every, checkpoint_dir: str, resume: bool):
        """The checkpoint side of a query (JAX `_query_stepwise_impl`):
        on a resume, the newest usable snapshot restored into `state` --
        resharded onto this mesh when a sharded lineage's geometry
        differs (a lost rank, another fnum or cut); then the manager that
        writes this run's snapshots, if a cadence is set: sharded under a
        process group.  Returns (state, resume meta or None, manager or
        None, cadence)."""
        from libgrape_lite_tpu_torch.ft.checkpoint import (
            CheckpointManager,
            CheckpointMismatchError,
            latest_meta,
            restore_latest,
        )
        from libgrape_lite_tpu_torch.ft.distributed import (
            GEOMETRY_KEYS,
            ShardedCheckpointManager,
            decline_vc_reshard,
            restore_resharded,
        )
        from libgrape_lite_tpu_torch.ft.fingerprint import (
            canonical_query_args,
            compute_fingerprint,
        )

        frag = self.fragment
        fingerprint = compute_fingerprint(self.app, frag, query_args,
                                          carry=carry)
        meta = None
        if resume:
            meta0 = latest_meta(checkpoint_dir)
            fp0 = meta0.get("fingerprint", {})
            if meta0.get("layout") == "sharded" and any(
                    fp0.get(k) != fingerprint.get(k) for k in GEOMETRY_KEYS):
                if getattr(self.app, "mesh_kind", "frag") == "vc2d":
                    decline_vc_reshard(self.app, frag, fp0, fingerprint)
                # the snapshot was written by another mesh: gather the
                # shard files and scatter the carry onto this layout.
                # Pid-valued leaves (WCC's labels) are re-addressed by the
                # app; a min-folded leaf takes the fresh init's minimum
                # too, so its fixed point is this mesh's (the incremental
                # seed's rule)
                app = self.app
                base = {k: _to_host(v)
                        for k, v in self._whole_of(carry).items()}
                restored, meta = restore_resharded(
                    checkpoint_dir, frag, fingerprint, base_state=base,
                    value_map=app.inc_value_map)
                for k, fold in getattr(app, "inc_seed_keys", {}).items():
                    if fold == "min" and k in restored:
                        restored[k] = np.minimum(base[k], restored[k])
            else:
                restored, meta = restore_latest(checkpoint_dir, fingerprint)
            if set(restored) != set(carry):
                raise CheckpointMismatchError(
                    f"checkpoint carry keys {sorted(restored)} != this "
                    f"query's carry keys {sorted(carry)}")
            restored = self._slab_of(restored, carry)
            state = {**state, **{k: _place(v, frag.device)
                                 for k, v in restored.items()}}
            if checkpoint_every is None:
                checkpoint_every = meta.get("checkpoint_every") or None
        ckpt = None
        if checkpoint_every is not None:
            kw = dict(fingerprint=fingerprint,
                      query_args=canonical_query_args(query_args),
                      checkpoint_every=checkpoint_every,
                      # a new query starts a new lineage: stale
                      # checkpoints in a reused dir must not shadow it
                      fresh_start=not resume)
            if _gang(frag):
                # a shard a rank, committed under the two-phase barrier
                ckpt = ShardedCheckpointManager(
                    checkpoint_dir, frag=frag, replicated_keys=getattr(
                        self.app, "replicated_keys", frozenset()), **kw)
            else:
                ckpt = CheckpointManager(checkpoint_dir, **kw)
        return state, meta, ckpt, checkpoint_every

    def _query_rounds(self, mr: int, initial_state, query_args: Dict, tr, *,
                      checkpoint_every=None, checkpoint_dir=None,
                      fault_plan=None, guard_cfg=None, resume=False):
        """PEval, then IncEval rounds while the vote is positive (the
        body of `query`), each round in its span when `tr` is armed.

        A round's hooks keep the JAX package's order: injected carry
        corruption, then the guard probe (forced on checkpoint rounds, so
        a corrupt state never becomes a snapshot), then the snapshot,
        then the kill and shard-corruption hooks."""
        app, frag = self.app, self.fragment
        state = app.init_state(frag, **query_args)
        if self._seed_fn is not None:  # inside query_incremental
            state = self._seed_fn(state)
        for k, v in (initial_state or {}).items():
            if k not in state:
                raise KeyError(f"initial_state key {k!r} is not a state key "
                               f"of {type(app).__name__}")
            state[k] = v
        state = {k: _place(v, frag.device) for k, v in state.items()}
        # read after init_state: apps set their ephemeral keys there
        eph = frozenset(getattr(app, "ephemeral_keys", ()) or ())
        mutating = hasattr(app, "collect_mutations")
        # the pipelined round (parallel/pipeline.py) when the app resolved
        # a plan; incremental and mutating queries keep the serial round
        if self._seed_fn is not None or mutating:
            app._pipeline = None
        pl = getattr(app, "_pipeline", None)

        def carry_of(st):
            return {k: v for k, v in st.items() if k not in eph}

        # what the checkpoint, the guard and the fault hooks see: the
        # carry, gathered whole on a vertex-cut gang (every leaf then the
        # same on every rank; `_slab_of` cuts a restore back)
        hook_carry = carry_of
        if _gang(frag) and getattr(app, "mesh_kind", "frag") == "vc2d":
            def hook_carry(st):
                return self._whole_of(carry_of(st))

        ckpt = meta = None
        if checkpoint_dir:
            state, meta, ckpt, checkpoint_every = self._open_lineage(
                state, hook_carry(state), query_args,
                checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir, resume=resume)
        monitor = None
        if guard_cfg is not None and guard_cfg.enabled:
            from libgrape_lite_tpu_torch.guard.monitor import GuardMonitor

            monitor = GuardMonitor(app=app, frag=frag, config=guard_cfg,
                                   ckpt=ckpt)
            self._guard_monitor = monitor
            glog.vlog(1, "guard: probes every %d round(s) (policy=%s)",
                      guard_cfg.every, guard_cfg.policy)
        hooked = ckpt is not None or monitor is not None or (
            fault_plan is not None)
        # the breach vote (guard/vote.py): armed under a process group
        # when a hazard hook exists (each the same on every rank)
        vote = None
        if hooked and _gang(frag):
            from libgrape_lite_tpu_torch.guard.vote import BreachVote

            vote = BreachVote.for_current_process()
        # the gang's trace sidecars (obs/gang.py): the clock handshake and
        # a first sidecar before the first vote, so even a round-0 halt
        # leaves a file for the assembler
        gang_armed = vote is not None and tr.enabled
        if gang_armed:
            obs.gang.ensure_handshake()
            obs.gang.write_sidecar()
        # corrupt_carry poisons global fragment row 0: the rank holding it
        corrupts = (fault_plan is not None
                    and getattr(frag, "fid_lo", 0) == 0)

        def place(host: Dict) -> Dict:
            return {k: _place(v, frag.device) for k, v in host.items()}

        def voted_hooks(rounds: int, hooks):
            """Run one superstep boundary's hooks under the breach vote:
            every rank exchanges a verdict at this cut, so a one-rank halt
            halts every rank instead of stranding its siblings in the next
            collective; a halt first dumps the gang's postmortem under the
            vote's incident id."""
            if vote is None:
                return hooks()
            err = out = None
            try:
                out = hooks()
            except Exception as e:
                err = e
            try:
                vote.round_vote(rounds, err)  # re-raises err
            except BaseException as halt:
                if gang_armed:
                    obs.gang.on_breach_halt(halt, rounds)
                raise
            return out

        def round_hooks(state, rounds: int, active: int, guard_prev):
            """Probe, snapshot and inject after superstep `rounds`.
            Returns (state, guard_prev, rollback (restored, meta) or
            None)."""
            if corrupts:
                corrupted = fault_plan.maybe_corrupt_carry(hook_carry(state),
                                                           rounds)
                if corrupted is not None:
                    state = {**state, **place(self._slab_of(
                        corrupted, carry_of(state)))}
            ckpt_round = (ckpt is not None
                          and rounds % checkpoint_every == 0)
            if (monitor is not None and active >= 0
                    and (monitor.due(rounds) or ckpt_round)):
                cur = hook_carry(state)
                breach = monitor.check(guard_prev, cur, rounds, active)
                if breach is not None:
                    if breach.action == "rollback" and rounds > 0:
                        return state, guard_prev, monitor.rollback(breach)
                    monitor.raise_breach(breach)
                guard_prev = cur
            if ckpt_round:
                ckpt.save_async(hook_carry(state), rounds, active)
            if fault_plan is not None:
                fault_plan.on_superstep(rounds, ckpt)
            return state, guard_prev, None

        ctx = make_context(app, frag)
        replicated = getattr(app, "replicated_vote", False)
        limit = mr if mr > 0 else _INT32_MAX
        try:
            if meta is not None:  # resumed: PEval ran before the kill
                rounds, active = int(meta["rounds"]), int(meta["active"])
                guard_prev = hook_carry(state) if hooked else None
                glog.vlog(1, "resumed from superstep %d (active=%d, dir=%s)",
                          rounds, active, checkpoint_dir)
                tr.instant("resume", round=rounds, active=active)
            else:
                guard_prev = hook_carry(state) if hooked else None
                t0 = time.perf_counter()
                built = _built_marker() if tr.enabled else 0
                with tr.span("peval", round=0) as sp:
                    state, active = app.peval(ctx, frag.dev, state)
                    if tr.enabled:
                        self._mark_dispatched(sp, built)
                    # the vote across ranks, read back: the sync
                    active = int(ctx.vote(active, replicated))
                    sp.set(active=active)
                glog.vlog(1, "PEval: %.6fs active=%d",
                          time.perf_counter() - t0, active)
                if tr.enabled:
                    self._round_obs(tr, sp, 0, "peval", active)
                rounds = 0
                if hooked:
                    # a PEval breach has no snapshot to restore: any
                    # verdict but warn halts (round_hooks never rolls
                    # back round 0)
                    state, guard_prev, _ = voted_hooks(
                        0, lambda: round_hooks(state, 0, active, guard_prev))
                    if gang_armed:
                        # this rank's spans so far survive a later kill
                        obs.gang.write_sidecar()
                if mutating:
                    # edits staged during PEval apply even when the query
                    # would converge at once (worker.h:211-222); a
                    # ForceTerminate vote (negative) still wins
                    state, frag, changed = self._apply_mutations(
                        state, frag, 0, query_args)
                    if changed:
                        eph = frozenset(app.ephemeral_keys or ())
                        if monitor is not None:
                            monitor.on_mutation(frag)
                            guard_prev = hook_carry(state)
                        if active >= 0:
                            active = 1
            # the pipelined round's exchange buffer: a pure function of
            # the carry, rebuilt whenever the carry is rewritten, never
            # part of the carry, a snapshot, a digest or a probe
            xbuf = (app.pipeline_exchange(ctx, frag.dev, state)
                    if pl is not None else None)
            while active > 0 and rounds < limit:
                t0 = time.perf_counter()
                built = _built_marker() if tr.enabled else 0
                with tr.span("superstep", round=rounds + 1) as sp:
                    if pl is not None:
                        new, active, xbuf = app.inceval_pipelined(
                            ctx, frag.dev, state, xbuf)
                        state = {**state, **new}
                    else:
                        state, active = app.inceval(ctx, frag.dev, state)
                    if tr.enabled:
                        self._mark_dispatched(sp, built)
                    # the termination vote across ranks, read back: every
                    # rank runs the same rounds
                    active = int(ctx.vote(active, replicated))
                    sp.set(active=active)
                rounds += 1
                glog.vlog(1, "IncEval round %d: %.6fs active=%d", rounds,
                          time.perf_counter() - t0, active)
                if tr.enabled:
                    self._round_obs(tr, sp, rounds, "superstep", active)
                if hooked:
                    hooked_in = state
                    state, guard_prev, rolled = voted_hooks(
                        rounds, lambda: round_hooks(state, rounds, active,
                                                    guard_prev))
                    if gang_armed:
                        obs.gang.write_sidecar()
                    if rolled is not None:
                        restored, rmeta = rolled
                        state = {**state, **place(self._slab_of(
                            restored, carry_of(state)))}
                        rounds = int(rmeta["rounds"])
                        active = int(rmeta["active"])
                        guard_prev = hook_carry(state)
                    if pl is not None and state is not hooked_in:
                        # a corruption or a rollback rewrote the carry
                        xbuf = app.pipeline_exchange(ctx, frag.dev, state)
                    if rolled is not None:
                        continue
                if mutating:
                    state, frag, changed = self._apply_mutations(
                        state, frag, rounds, query_args)
                    if changed:
                        eph = frozenset(app.ephemeral_keys or ())
                        if monitor is not None:
                            # the graph and its superstep operator
                            # changed: no digest match across it proves a
                            # cycle, no monotone comparison spans it
                            monitor.on_mutation(frag)
                            guard_prev = hook_carry(state)
                    if changed and active >= 0:
                        active = 1  # the new topology must be evaluated
                        if rounds >= limit:
                            _LOG.info("mutation applied on the final "
                                      "permitted round; the rebuilt "
                                      "topology was NOT re-evaluated -- "
                                      "raise max_rounds")
        finally:
            # the in-flight snapshot lands even on a raise (an injected
            # raise-mode kill must leave a durable checkpoint)
            if ckpt is not None:
                ckpt.close()
        self.rounds = rounds
        self._terminate_code = min(0, active)
        return self._keep(state)

    def resume(self, checkpoint_dir: str, max_rounds: int | None = None, *,
               checkpoint_every: int | None = None, fault_plan=None,
               guard=None):
        """Continue a checkpointed query from the last complete superstep
        (JAX `Worker.resume`).  The config fingerprint is validated
        before any state is adopted (a mismatch raises
        CheckpointMismatchError); a corrupt newest shard falls back to
        the previous complete superstep.  The query args replay from the
        checkpoint's metadata, so the resumed run finishes byte-identical
        to an uninterrupted one.  Checkpointing continues at the recorded
        cadence unless `checkpoint_every` overrides it."""
        from libgrape_lite_tpu_torch.ft.checkpoint import (
            CheckpointMismatchError,
            latest_meta,
        )
        from libgrape_lite_tpu_torch.ft.fingerprint import app_registry_name

        meta = latest_meta(checkpoint_dir)
        # a wrong-app resume fails before its query args reach this
        # app's init_state (an opaque TypeError otherwise)
        recorded = (meta.get("fingerprint") or {}).get("app")
        mine = app_registry_name(self.app)
        if recorded is not None and recorded != mine:
            raise CheckpointMismatchError(
                f"checkpoint {checkpoint_dir!r} does not match this "
                f"query: app: checkpoint has {recorded!r}, query has "
                f"{mine!r}")
        query_args = meta.get("query_args") or {}
        return self.query(
            max_rounds, checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, fault_plan=fault_plan,
            guard=guard, _resume=True, **query_args)

    @staticmethod
    def _mark_dispatched(sp, built: int) -> None:
        """The round's launches are queued: mark `compiled` when a CUDA
        library was built or loaded or a plan cache missed since `built`
        was read, then `dispatched` (the vote's read follows)."""
        if _built_marker() != built:
            sp.mark("compiled")
        sp.mark("dispatched")

    def _round_obs(self, tr, sp, rounds: int, name: str, active: int) -> None:
        """An armed round's records after its span closed: the
        per-fragment mirrors, the active counter and series, the
        superstep count."""
        self._mirror_superstep(tr, sp, rounds, name)
        tr.counter("active_vertices", value=active)
        m = obs.metrics()
        m.series("grape_active_per_round").append(active)
        m.counter("grape_supersteps_total").inc()

    def _mirror_superstep(self, tr, sp, rounds: int, name: str) -> None:
        """Re-emit a closed round span on every per-fragment track: the
        stacked fragments run each round together, so the host interval
        is each fragment's."""
        if self.fragment.fnum <= 1:
            return
        for f in range(self.fragment.fnum):
            tr.emit_span_raw(name, t0_ns=sp.t0_ns, dur_ns=sp.dur_ns,
                             tid=tr.frag_tid(f), round=rounds, frag=f)

    def _finish_query_obs(self, sp) -> None:
        """An armed query's close-out: rounds and terminate code on the
        query span, the query counters.  (The JAX package's pack-ledger
        gauges belong to its TPU pack planner, which is not ported.)"""
        if not obs.armed():
            return
        sp.set(rounds=self.rounds, terminate_code=self._terminate_code)
        # a vertex-cut query carries its tile layout (trace_report's tile
        # table reads this record)
        part = getattr(self.app, "_partition_stats", None)
        if part is not None:
            sp.set(partition={
                "mode": getattr(self.app, "_partition", "2d"),
                "k": part["k"],
                "max_tile_edges": part["max_tile_edges"],
                "mean_tile_edges": part["mean_tile_edges"],
                "tile_skew": part["tile_skew"],
                "per_tile": part["per_tile"],
            })
        # a pipelined query carries its plan's brief and the modeled
        # exchange time it hid (trace_report's overlap column and the
        # truth meter, obs/truth.py, read them)
        pl = getattr(self.app, "_pipeline", None)
        if pl is not None:
            sp.set(pipeline=pl.span_brief(),
                   overlap_hidden_us=round(
                       pl.hidden_us_per_round() * self.rounds, 1))
        m = obs.metrics()
        m.counter("grape_queries_total").inc()
        m.gauge("grape_query_rounds").set(self.rounds)

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
        glog.vlog(1, "applied mutations after round %d", rounds)
        obs.tracer().instant("apply_mutations", round=rounds)
        return ({k: _place(v, frag.device) for k, v in migrated.items()},
                frag, True)

    def query_incremental(self, prev_result: Dict, delta=None,
                          max_rounds: int | None = None, *,
                          prev_fragment=None, guard=None,
                          checkpoint_every: int | None = None,
                          checkpoint_dir: str | None = None,
                          fault_plan=None, **query_args):
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
        worker's last query ran on.

        `guard`, `checkpoint_every`, `checkpoint_dir` and `fault_plan`
        pass through to `query`: the seeded run is an ordinary query with
        another starting carry.

        Under a process group `prev_result` is this rank's result (its
        slab).  When every vertex kept its row the fold runs on the
        slab; when the layout changed, rows migrate by oid, which needs
        the whole previous result: the fresh carry and `prev_result` are
        gathered across ranks (`_whole_of`), migrated on the host, and
        the seeded carry cut back to this rank's slab (`_slab_of`)."""
        from libgrape_lite_tpu_torch.dyn.incremental import (
            incremental_plan,
            reseed_fold,
        )
        from libgrape_lite_tpu_torch.fragment.mutation import same_layout

        app = self.app
        mode, reason = incremental_plan(app, delta)
        self.inc_report = {"mode": mode, "reason": reason}
        self.inc_stats[mode] += 1
        obs.tracer().instant("query_incremental", mode=mode)
        ft_kw = dict(guard=guard, checkpoint_every=checkpoint_every,
                     checkpoint_dir=checkpoint_dir, fault_plan=fault_plan)
        if mode == "cold":
            glog.vlog(1, "query_incremental: cold recompute (%s)", reason)
            return self.query(max_rounds, **ft_kw, **query_args)
        prev_frag = prev_fragment or self._result_fragment or self.fragment
        prev = {k: v for k, v in prev_result.items()
                if k in app.inc_seed_keys}

        def seed(fresh: Dict) -> Dict:
            frag = self.fragment
            if _world(frag) <= 1 or same_layout(prev_frag, frag):
                return {**fresh, **reseed_fold(app, frag, fresh, prev_frag,
                                               prev)}
            # every rank joins the gathers, in key order
            keys = sorted(k for k in app.inc_seed_keys if k in fresh)
            whole = self._whole_of({k: fresh[k] for k in keys})
            whole_prev = self._whole_of({k: _place(v, frag.device)
                                         for k, v in prev.items()})
            seeded = reseed_fold(app, frag, whole, prev_frag, whole_prev)
            return {**fresh, **self._slab_of(seeded, fresh)}

        self._seed_fn = seed
        try:
            return self.query(max_rounds, **ft_kw, **query_args)
        finally:
            self._seed_fn = None

    def _query_host(self, mr: int, initial_state, query_args, guard_cfg):
        """Host-driven apps (the exchange apps: capacity retries, bucket
        advances and push/pull switches decide each round on the host)
        run their own loop, under the same round limit (JAX
        `worker.py:1208-1230`), on the rank's StepContext: under a
        process group the loop holds the rank's slab and folds each
        round's host scalars across ranks, so every rank takes the same
        decisions; `result_values` gathers the slab result.  An app with
        `host_guard` probes its own round boundaries
        (`ExchangeAppBase._round_hooks`; across ranks the global probe)
        under this query's resolved guard config, a disabled one
        included (so guard="off" disarms an env-armed GRAPE_GUARD);
        other host apps have no carry to guard."""
        app = self.app
        if initial_state:
            raise ValueError(f"{type(app).__name__} runs its own host loop "
                             "and takes no initial_state")
        if getattr(app, "host_guard", False):
            app._host_guard_cfg = guard_cfg
        elif guard_cfg.enabled:
            glog.log_info("guard: host-only apps have no superstep carry "
                          "to monitor; guards are inert for "
                          f"{type(app).__name__}")
        tr = obs.tracer()
        try:
            with tr.span("query", mode="host", app=type(app).__name__) as sp:
                state = app.host_compute(
                    self.fragment, max_rounds=mr,
                    ctx=make_context(app, self.fragment), **query_args)
                self.rounds = app.rounds
                glog.vlog(1, "host loop: %s", " ".join(
                    f"{k}={v}" for k, v in host_loop_stats(app).items()))
                mon = getattr(app, "_host_guard_monitor", None)
                if mon is not None:
                    glog.vlog(1, "guard: host loop probed %d round(s) "
                              "(policy=%s), %d breach(es)", mon.probes,
                              mon.config.policy, len(mon.breaches))
                self._finish_query_obs(sp)
        finally:
            # a breach raise still surfaces the monitor (guard_report)
            self._guard_monitor = getattr(app, "_host_guard_monitor", None)
            if tr.enabled:
                obs.flush()
        return self._keep(state)

    def _keep(self, state: Dict) -> Dict:
        eph = self.app.ephemeral_keys
        self._result_state = {
            k: v for k, v in state.items() if k not in eph
        }
        self._result_fragment = self.fragment
        return self._result_state

    # ---- batched multi-source queries (serve/) ----

    def _check_batchable(self) -> None:
        """Batched queries cover superstep apps on the fragment stack and
        on the vertex cut's tiles; everything else fails loudly before
        any state is built (JAX `Worker._check_batchable`)."""
        app = self.app
        if getattr(app, "host_only", False):
            raise ValueError(
                f"{type(app).__name__} is a host-only app: its data-"
                "dependent host loop has no superstep carry to batch")
        if hasattr(app, "collect_mutations"):
            raise ValueError(
                "MutationContext apps rebuild the fragment between rounds "
                "and cannot share one batched query")
        if app.mesh_kind not in ("frag", "vc2d"):
            raise ValueError(
                "batched queries support the frag and vc2d meshes only "
                f"(app mesh_kind={app.mesh_kind!r})")

    def query_batch_prepare(self, args_list,
                            max_rounds: int | None = None, *, guard=None,
                            chunk_hook=None) -> PreparedBatch:
        """The host half of a batched query: the checks, then the k
        lanes' state built (`init_state_batch`, on a copy of the app) and
        placed on the fragment's device.  Leaves this worker's result
        fields alone, so prepared batches can coexist.  `guard` (a
        policy or GuardConfig; default GRAPE_GUARD) arms the guarded
        chunk loop; `chunk_hook` is its test seam (serve/batch.py)."""
        from libgrape_lite_tpu_torch.guard.config import GuardConfig

        world = _world(self.fragment)
        if world > 1:
            raise ValueError(
                f"batched queries (query_batch, serve) do not run across "
                f"processes (world {world} > 1), as in the JAX package: "
                "its batch_result_values reads a lane with "
                "jax.device_get, which cannot read a leaf spanning "
                "processes (libgrape_lite_tpu/worker/worker.py:1061-1064), "
                "and its serve parser takes no --coordinator / "
                "--num_processes / --process_id (libgrape_lite_tpu/"
                "cli.py:133); ROADMAP, not carried over")
        self._check_batchable()
        # before the guard routing: a guarded batch refuses a stale dyn
        # view as the plain one does
        self._check_dyn_view()
        guard_cfg = GuardConfig.resolve(guard)
        if not args_list:
            raise ValueError("query_batch needs at least one lane")
        app = copy.copy(self.app)
        frag = self.fragment
        mr = app.max_rounds if max_rounds is None else max_rounds
        state = app.init_state_batch(frag, list(args_list))
        app._pipeline = None  # a batch keeps the serial round
        if isinstance(state, list):
            state = [{k: _place(v, frag.device) for k, v in st.items()}
                     for st in state]
        else:
            state = {k: _place(v, frag.device) for k, v in state.items()}
        # read after init_state_batch: apps extend it there (the overlay)
        eph = frozenset(getattr(app, "ephemeral_keys", ()) or ())
        return PreparedBatch(app=app, fragment=frag, state=state, eph=eph,
                             batch=len(args_list), max_rounds=mr,
                             idle_streams=self.idle_streams,
                             guard_cfg=guard_cfg if guard_cfg.enabled
                             else None, chunk_hook=chunk_hook)

    def query_batch_dispatch(self, args_list, max_rounds: int | None = None,
                             *, guard=None) -> BatchDispatch:
        """Prepare and launch in one call: the batch runs in its own
        thread and stream while this one returns."""
        return self.query_batch_prepare(args_list, max_rounds,
                                        guard=guard).launch()

    def query_batch(self, args_list, max_rounds: int | None = None, *,
                    guard=None):
        """Run k point queries as one batch over the shared fragment:
        `args_list` holds one query-argument dict per lane (e.g.
        [{"source": 3}, {"source": 9}]).  Each lane's result is
        byte-identical to its own `Worker.query`; per-lane round counts
        land in `batch_rounds`, terminate codes in `batch_terminate`,
        lane b's state in `batch_lane_state(b)`.

        With `guard` armed (a policy or GuardConfig; default
        GRAPE_GUARD) the batch runs serve/batch.py's guarded chunk loop:
        per-lane verdicts in `batch_breaches`, a breached lane frozen
        while its batchmates run on."""
        from libgrape_lite_tpu_torch.guard.config import GuardConfig

        self._guard_monitor = None
        self.batch_breaches = None
        guard_cfg = GuardConfig.resolve(guard)
        if guard_cfg.enabled:
            from libgrape_lite_tpu_torch.serve.batch import run_guarded_batch

            mr = self.app.max_rounds if max_rounds is None else max_rounds
            return run_guarded_batch(self, args_list, mr, guard_cfg)
        prepared = self.query_batch_prepare(args_list, max_rounds,
                                            guard=guard_cfg)
        batch = prepared.batch
        tr = obs.tracer()
        try:
            with tr.span("query", mode="batched",
                         app=type(self.app).__name__, batch=batch) as sp:
                d = prepared.run()
                self.batch_rounds = d.rounds
                self.batch_terminate = d.terminate
                self.rounds = int(d.rounds.max())
                self._terminate_code = int(d.terminate.min())
                if tr.enabled:
                    # every lane runs PEval and its own counted rounds
                    obs.metrics().counter("grape_supersteps_total").inc(
                        int(d.rounds.sum()) + batch)
                    sp.set(lane_rounds=[int(x) for x in d.rounds])
                self._finish_query_obs(sp)
        finally:
            if tr.enabled:
                obs.flush()
        self._batch = d
        self._result_state = d.state
        self._result_fragment = self.fragment
        return d.state

    def batch_lane_state(self, lane: int) -> Dict:
        """Lane `lane`'s state of the last query_batch (ephemeral leaves
        shared)."""
        if self._batch is None:
            raise RuntimeError("query_batch() first")
        return self._batch.lane_state(lane)

    def batch_result_values(self, lane: int) -> np.ndarray:
        """Per-vertex assembled values for one lane, [fnum, vp] numpy."""
        if self._batch is None:
            raise RuntimeError("query_batch() first")
        return self._batch.lane_values(lane)

    def pack_ledger(self):
        """The app's per-round pull bill (JAX `Worker.pack_ledger`): the
        K1 columns of its pull (`AppBase.k1_pull`, ops/calibration.py)
        under "totals", and with a pipeline resolved its split under
        "pipeline" (boundary and interior vertex and edge totals, the
        exchange mode and its modeled bytes).  None when it has
        neither."""
        from libgrape_lite_tpu_torch.ops.calibration import k1_columns

        led = {}
        pull = getattr(self.app, "k1_pull", None)
        if pull is not None:
            cols = k1_columns(self.fragment, weighted=pull == "weighted")
            if cols:
                led["totals"] = cols
        pl = getattr(self.app, "_pipeline", None)
        if pl is not None:
            led["pipeline"] = {**pl.stats.get("totals", {}), "mode": pl.mode,
                               "exchange_bytes": pl.exchange_bytes}
        return led or None

    def release_buffers(self) -> None:
        """Drop the device references of the last results (a serving
        session's `release_device`)."""
        self._result_state = None
        self._result_fragment = None
        self._batch = None
        self.batch_rounds = None
        self.batch_terminate = None
        self.batch_breaches = None

    # ---- Output / Assemble (reference worker.h:148-154, ctx.Output) ----

    def result_values(self) -> np.ndarray:
        """Per-vertex assembled values, [fnum, vp] numpy.  Under a process
        group each rank's [fl, vp] state leaves are all-gathered into
        [fnum, vp] first (JAX `worker.py:2439-2456`): a collective every
        rank joins, in the state's key order; replicated leaves (scalars
        and tables) pass as they are."""
        if self._result_state is None:
            raise RuntimeError("query() first")
        spec = getattr(self.fragment, "comm_spec", None)
        state = self._result_state
        if getattr(spec, "group", None) is not None:
            state = {k: self._whole_leaf(spec, k, v)
                     for k, v in state.items()}
        host = {k: v.cpu() for k, v in state.items()}
        return self.app.finalize(self.fragment, host)

    def output(self, prefix: str) -> None:
        """Write per-fragment result files `result_frag_<fid>` with
        `oid value` lines (reference `GetResultFilename` + ctx Output).
        Under a process group every rank joins the result gather and
        only the coordinator writes (JAX `worker.py:2463-2469`)."""
        values = self.result_values()
        spec = getattr(self.fragment, "comm_spec", None)
        if spec is not None and not spec.is_coordinator:
            return
        os.makedirs(prefix, exist_ok=True)
        fmt = self.app.result_format
        for f in range(self.fragment.fnum):
            n = self.fragment.inner_vertices_num(f)
            oids = self.fragment.inner_oids(f)
            path = os.path.join(prefix, f"result_frag_{f}")
            with open(path, "w") as out:
                out.write(format_result_lines(oids, values[f, :n], fmt))


def _world(frag) -> int:
    """The process count of `frag`'s CommSpec (1 without one)."""
    return getattr(getattr(frag, "comm_spec", None), "world", 1)


def _gang(frag) -> bool:
    """Whether `frag` lives under a process group (any world size): its
    lineage is sharded and its hooks run under the breach vote."""
    return getattr(getattr(frag, "comm_spec", None), "group", None) is not None


def _gather_leaf(spec, v: torch.Tensor) -> torch.Tensor:
    """A rank's [fl, ...] state leaf -> every rank's, [fnum, ...]."""
    if v.dtype == torch.bool:
        return spec.all_gather_into(v.to(torch.uint8)).bool()
    return spec.all_gather_into(v)


#: the host-loop decisions an exchange app records (`host_loop_stats`)
HOST_LOOP_DECISIONS = ("rounds", "retries", "buckets", "push_rounds",
                   "pull_rounds", "final_capacity")


def host_loop_stats(app) -> Dict[str, int]:
    """The decisions of a host-driven app's last loop: its rounds,
    capacity retries, bucket advances, push and pull rounds and settled
    capacity (those the app keeps).  Every rank of a gang takes the same
    ones (the `--profile` line "host loop: ...")."""
    return {k: int(getattr(app, k)) for k in HOST_LOOP_DECISIONS
            if hasattr(app, k)}


def dist_apps() -> tuple:
    """The app classes whose superstep runs across processes (world >
    1), by exact class (a subclass declines): the edge-cut pulls of SSSP,
    BFS, WCC and PageRank (K1 or the strict tiles), CDLP's mode fold over
    the global label universe, the two LCCs' rings of rank blocks (K3
    over bitmaps, the merge pass over ELL rows), the K1 library apps
    (KCore, CoreDecomposition, PageRankLocal, KHopNeighborhood,
    CommonNeighbors, BC: a pull of the gathered state a round or a
    level, their counts through `ctx.sum` / `ctx.min`), and the edge-cut
    variants: the SyncBuffer apps (a push over the slab's push CSR, the
    proposals crossing ranks in one all_to_all), the exchange apps' host
    loops (the masked candidates gathered a round, the round's scalars
    folded across ranks in one all_gather), WCCOpt's pointer jump and
    CDLPOpt's first-round K1 over the gathered state; and the counting
    apps: TriangleCount (LCC's N+ ring, or its spgemm items folded),
    LCCDirected (K3 over a ring of OUT blocks), ApexTriangleCount
    (LCCBeta's ring in apex mode), KClique4Device and KCliqueDevice (the
    stacked ELL gathered from the ranks' blocks) and KClique's dispatch
    (its nested workers, or the host recursion over the slab's
    apexes); and the vertex cut: SSSPVC2D, BFSVC2D, WCCVC2D and
    PageRankVC on a rank's tiles of the k x k grid (its row- and
    column-axis groups, the tile transpose), PageRankVCReplicated's
    all_reduce of the tiles' sum."""
    from libgrape_lite_tpu_torch.models.auto_apps import (
        BFSAuto,
        PageRankAuto,
        SSSPAuto,
        WCCAuto,
    )
    from libgrape_lite_tpu_torch.models.bc import BC
    from libgrape_lite_tpu_torch.models.bfs import BFS
    from libgrape_lite_tpu_torch.models.bfs_opt import BFSOpt
    from libgrape_lite_tpu_torch.models.cdlp import CDLP, CDLPOpt
    from libgrape_lite_tpu_torch.models.core_decomposition import (
        CoreDecomposition,
    )
    from libgrape_lite_tpu_torch.models.kclique import KClique
    from libgrape_lite_tpu_torch.models.kclique_device import (
        KClique4Device,
        KCliqueDevice,
    )
    from libgrape_lite_tpu_torch.models.kcore import KCore
    from libgrape_lite_tpu_torch.models.khop import KHopNeighborhood
    from libgrape_lite_tpu_torch.models.lcc import LCC
    from libgrape_lite_tpu_torch.models.lcc_beta import (
        ApexTriangleCount,
        LCCBeta,
    )
    from libgrape_lite_tpu_torch.models.lcc_directed import LCCDirected
    from libgrape_lite_tpu_torch.models.pagerank import PageRank
    from libgrape_lite_tpu_torch.models.pagerank_local import PageRankLocal
    from libgrape_lite_tpu_torch.models.pagerank_vc import (
        PageRankVC,
        PageRankVCReplicated,
    )
    from libgrape_lite_tpu_torch.models.sssp import SSSP
    from libgrape_lite_tpu_torch.models.sssp_delta import SSSPDelta
    from libgrape_lite_tpu_torch.models.sssp_msg import BFSMsg, SSSPMsg
    from libgrape_lite_tpu_torch.models.triangle_count import (
        CommonNeighbors,
        TriangleCount,
    )
    from libgrape_lite_tpu_torch.models.vc2d import BFSVC2D, SSSPVC2D, WCCVC2D
    from libgrape_lite_tpu_torch.models.wcc import WCC
    from libgrape_lite_tpu_torch.models.wcc_opt import WCCOpt

    return (SSSP, BFS, WCC, PageRank, CDLP, LCC, LCCBeta, KCore,
            CoreDecomposition, PageRankLocal, KHopNeighborhood,
            CommonNeighbors, BC, SSSPAuto, BFSAuto, WCCAuto, PageRankAuto,
            SSSPMsg, BFSMsg, SSSPDelta, BFSOpt, WCCOpt, CDLPOpt,
            TriangleCount, LCCDirected, ApexTriangleCount, KClique,
            KClique4Device, KCliqueDevice, SSSPVC2D, BFSVC2D, WCCVC2D,
            PageRankVC, PageRankVCReplicated)


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
