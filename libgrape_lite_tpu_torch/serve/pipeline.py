"""Async serving pump: admission, execution and harvest overlapped.

Counterpart of `libgrape_lite_tpu/serve/pipeline.py`.  The synchronous
loop (`AdmissionQueue.pump` -> `ServeSession._dispatch`) runs one batch,
pulls every lane's result to the host, and only then picks the next
batch: the card idles during admission and extraction, the host while
the card runs.  The pump keeps a window of W batches admitted and not
yet harvested:

* **dispatch** (`_fill` / `_dispatch_stage`): pop ready batches with the
  queue's own decision (`AdmissionQueue._pop_ready`: the same batch
  composition and FIFO order), do their host half
  (`Worker.query_batch_prepare`) and launch up to `launch_cap` of them.
  A launched batch runs its round loop in a thread of its own, on a
  CUDA stream of its own (`PreparedBatch.launch`): the JAX pump relies
  on asynchronous dispatch instead, but this port's loop reads each
  round's vote on the host.  The thread releases the interpreter lock
  while it waits on the card, so this thread meanwhile prepares the
  next batches and harvests finished ones.
* **harvest** (`_harvest_head`): FIFO -- the head batch's thread is
  joined, the next prepared batch launched, and then the head's lanes
  are copied out and finalized while the successor runs.  FIFO harvest
  makes the result order the synchronous loop's.
* **ingest barrier** (`ingest`): a delta apply quiesces the window first,
  so every batch lands on the graph it was admitted against.

With obs/ armed each admission is a `serve_dispatch` span and each
harvest a `serve_harvest` span (window, occupancy, overlap), each
harvested query a `serve_query` span on its lane's row from dispatch to
harvest; `grape_serve_window_depth`, the queue-depth series and
`grape_supersteps_total` follow the window.

W = 1 is byte- and order-identical to the synchronous loop.  Batches the
window cannot hold -- host-only or MutationContext apps (the sequential
fallback), unknown apps, a forced repack of the overlay, a guarded
single query (`Worker.query`'s guard machinery) -- run through the
session's own synchronous dispatch, each decline recorded in
`PUMP_STATS`.  A guarded batch rides the window: its launched thread
runs serve/batch.py's chunk loop, its verdicts land in the dispatch
handle, and at harvest a breached lane becomes a failed result with its
bundle while its batchmates' values harvest lazily as any batch's.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.serve.queue import QueryRequest, ServeResult
from libgrape_lite_tpu_torch.serve.session import lane_results, queue_wait_us

#: env override of the window depth (recorded in PUMP_STATS)
INFLIGHT_ENV = "GRAPE_SERVE_INFLIGHT"
#: env override of how many window batches run at once
LAUNCH_CAP_ENV = "GRAPE_SERVE_LAUNCH_CAP"

#: the audited harvest contract (grape-lint R7 `sync-in-pump`,
#: analysis/astlint.py): the only methods of this module that may force a
#: host sync.  R7 walks every self-call chain rooted at a dispatch-stage
#: method (`_fill*` / `_dispatch*`) and flags a sync forcer reached
#: outside these names.  The JAX contract's `harvest` has no counterpart
#: here
PUMP_HARVEST_SYNCS = frozenset({
    "_harvest_head",
    "_results_from_dispatch",
    "_run_declined",
    "drain",
    "quiesce",
})


class PumpStats:
    """Every engage and decline of the window: a batch that could not
    ride it, or a window forced narrower than asked, is counted with its
    reason."""

    MAX_EVENTS = 256  # a long-lived server keeps a bounded history

    def __init__(self):
        self.engaged = 0
        self.declines = {}
        self.events: List[dict] = []

    def _record(self, ev: dict) -> None:
        self.events.append(ev)
        if len(self.events) > self.MAX_EVENTS:
            del self.events[: self.MAX_EVENTS // 2]

    def engage(self, **detail) -> None:
        self.engaged += 1
        self._record({"kind": "engage", **detail})

    def decline(self, reason: str, **detail) -> None:
        self.declines[reason] = self.declines.get(reason, 0) + 1
        self._record({"kind": "decline", "reason": reason, **detail})

    def snapshot(self) -> dict:
        return {"engaged": self.engaged, "declines": dict(self.declines)}

    def reset(self) -> None:
        self.engaged = 0
        self.declines = {}
        self.events = []


#: one record for every pump of the process; reset() between runs
PUMP_STATS = PumpStats()

# federated as "pump" (obs/federation.py); the class keeps its own
# snapshot() / reset()
from libgrape_lite_tpu_torch.obs import federation as _federation  # noqa: E402

_federation.register("pump", PUMP_STATS.snapshot, PUMP_STATS.reset,
                     module=__name__)


class PendingBatch:
    """One admitted batch in the window: its requests plus either ready
    results (a declined batch ran synchronously) or a prepared batch,
    launched once the launch cap lets it (`dispatch`)."""

    __slots__ = ("batch", "mode", "results", "prepared", "dispatch",
                 "reason", "t_admit_ns", "t_launch_ns", "disp_ns", "t0_ns")

    def __init__(self, batch: List[QueryRequest], mode: str,
                 results: Optional[List[ServeResult]] = None,
                 prepared=None, reason: str = ""):
        self.batch = batch
        self.mode = mode  # "ready" | "deferred"
        self.results = results
        self.prepared = prepared
        self.dispatch = None
        self.reason = reason
        # host stamps (perf_counter_ns): admission, launch, and the host
        # work of prepare + launch -- each lane's stages at harvest
        self.t_admit_ns = 0
        self.t_launch_ns = 0
        self.disp_ns = 0
        self.t0_ns = 0  # the serve_dispatch span's start (armed)

    def ready(self) -> bool:
        if self.mode == "ready":
            return True
        return self.dispatch is not None and self.dispatch.is_ready()


class AsyncServePump:
    """Overlapped admission, execution and harvest over one
    ServeSession.  Construction attaches the pump to the session, so
    `session.ingest` quiesces it whichever surface calls it.  `window`
    defaults to `session.policy.inflight`; GRAPE_SERVE_INFLIGHT
    overrides it (recorded).  `pump()` steps, `drain()` finishes,
    `ingest()` is the barrier; results come back in dispatch order."""

    def __init__(self, session, window: int | None = None, *,
                 eager_values: bool = True):
        self.session = session
        w = int(window if window is not None
                else getattr(session.policy, "inflight", 1))
        env = os.environ.get(INFLIGHT_ENV, "")
        if env:
            w_env = max(1, int(env))
            if w_env != w:
                PUMP_STATS.decline("inflight_env", asked=w, forced=w_env)
            w = w_env
        if w < 1:
            raise ValueError(f"window must be >= 1, got {w}")
        self.window = w
        # how many window batches run at once: one, while the others are
        # prepared or harvested.  Batches running at once on their own
        # streams contend for the card (on an H100, `serve --inflight 4`
        # with every window batch running was 2.3-2.9x slower than
        # `--inflight 1`) and on the CPU for the same cores
        cap_env = os.environ.get(LAUNCH_CAP_ENV, "")
        self.launch_cap = max(1, int(cap_env)) if cap_env else 1
        # True: the harvest resolves every lane's values; False leaves
        # them deferred until first read (ServeResult.values)
        self.eager_values = eager_values
        self._inflight: List[PendingBatch] = []
        # queries dispatched so far: a streaming caller pins its ingest
        # points on it (`max_dispatch`), so the batch / graph-version
        # interleave is the same at every window depth
        self.dispatched_queries = 0
        self.stats = {
            "dispatched": 0, "harvested": 0, "max_inflight": 0,
            "overlapped_harvests": 0, "quiesces": 0,
        }
        session._pump = self

    # ---- bookkeeping ----

    def inflight(self) -> int:
        return len(self._inflight)

    def pending(self) -> int:
        return self.session.queue.pending()

    def close(self) -> None:
        """Detach from the session, after draining the window."""
        self.quiesce(reason="close")
        if self.session._pump is self:
            self.session._pump = None

    # ---- dispatch stage ----

    def _fill(self, now: float | None = None, *, force: bool = False,
              max_dispatch: int | None = None) -> int:
        """Admit ready batches until the window is full, nothing is
        ready, or `max_dispatch` queries have been dispatched in all
        (checked before each batch: batches stay whole)."""
        n = 0
        while len(self._inflight) < self.window:
            if (max_dispatch is not None
                    and self.dispatched_queries >= max_dispatch):
                break
            batch = self.session.queue._pop_ready(now, force=force)
            if not batch:
                break
            self._dispatch(batch)
            n += 1
        return n

    def _dispatch(self, batch: List[QueryRequest]) -> None:
        tr = obs.tracer()
        t_admit = time.perf_counter_ns()
        with tr.span("serve_dispatch", app=batch[0].app_key,
                     batch=len(batch), window=self.window,
                     inflight=len(self._inflight),
                     queue_depth=self.session.queue.pending()) as sp:
            pb = self._dispatch_stage(batch)
            sp.set(mode=pb.mode, reason=pb.reason)
        pb.t_admit_ns = t_admit
        pb.disp_ns = time.perf_counter_ns() - t_admit
        if tr.enabled:
            pb.t0_ns = sp.t0_ns
        self._inflight.append(pb)
        self.dispatched_queries += len(batch)
        self.stats["dispatched"] += 1
        self.stats["max_inflight"] = max(self.stats["max_inflight"],
                                         len(self._inflight))
        self._launch_next()
        if tr.enabled:
            m = obs.metrics()
            m.gauge("grape_serve_window_depth").set(len(self._inflight))
            m.series("grape_serve_queue_depth_series").append(
                self.session.queue.pending())

    def _fail_batch(self, pb: PendingBatch, e: Exception) -> None:
        """One failed batch becomes per-lane error results; the pump and
        the rest of the window go on."""
        self.session.stats["failed"] += len(pb.batch)
        pb.mode = "ready"
        pb.dispatch = None
        pb.results = [
            ServeResult(request_id=req.id, app_key=req.app_key, ok=False,
                        error={"error": f"{type(e).__name__}: {e}"},
                        lane=b, batch_size=len(pb.batch))
            for b, req in enumerate(pb.batch)
        ]

    def _launch(self, pb: PendingBatch) -> None:
        t_l0 = time.perf_counter_ns()
        pb.dispatch = pb.prepared.launch()
        pb.t_launch_ns = time.perf_counter_ns()
        pb.disp_ns += pb.t_launch_ns - t_l0

    def _launch_next(self) -> None:
        """Launch prepared batches, head first, until `launch_cap` run;
        a launch that raises fails its batch only."""
        running = sum(1 for p in self._inflight
                      if p.mode == "deferred" and p.dispatch is not None
                      and not p.dispatch.is_ready())
        for p in self._inflight:
            if running >= self.launch_cap:
                break
            if p.mode == "deferred" and p.dispatch is None:
                try:
                    self._launch(p)
                except Exception as e:
                    self._fail_batch(p, e)
                    continue
                running += 1

    def _dispatch_stage(self, batch: List[QueryRequest]) -> PendingBatch:
        """Route one popped batch: into the window when the batched loop
        can hold it, otherwise through the session's synchronous
        dispatch with the decline recorded."""
        sess = self.session
        app_key = batch[0].app_key
        if app_key not in sess.apps:
            return self._run_declined(batch, "unknown_app")
        w = sess.worker(app_key)
        if (sess.dyn is not None and sess.dyn.overlay_count > 0
                and not getattr(w.app, "dyn_overlay_support", False)):
            # the forced fold rebuilds the fragment under every worker:
            # a window barrier, not a window item
            return self._run_declined(batch, "dyn_force_repack")
        try:
            w._check_batchable()
        except ValueError:
            return self._run_declined(batch, "sequential_fallback")
        guard = batch[0].guard or sess.guard
        from libgrape_lite_tpu_torch.guard.config import GuardConfig

        if len(batch) == 1 and GuardConfig.resolve(guard).enabled:
            # a single guarded query runs Worker.query's guard machinery
            return self._run_declined(batch, "guarded_single")
        sess.stats["batches"] += 1
        sess.stats["queries"] += len(batch)
        # None leaves the policy to GRAPE_GUARD, read where the batch is
        # prepared
        guard_kw = {} if guard is None else {"guard": guard}
        try:
            prepared = w.query_batch_prepare(
                [req.args for req in batch], batch[0].max_rounds,
                **guard_kw)
        except Exception as e:  # the whole batch fails, lane by lane
            pb = PendingBatch(batch, "deferred", reason="dispatch_error")
            self._fail_batch(pb, e)
            return pb
        PUMP_STATS.engage(app=app_key, batch=len(batch))
        return PendingBatch(batch, "deferred", prepared=prepared)

    def _run_declined(self, batch: List[QueryRequest],
                      reason: str) -> PendingBatch:
        """The session's synchronous dispatch, the decline recorded; a
        forced repack quiesces the window first (in-flight batches land
        on the graph they were admitted against)."""
        if reason == "dyn_force_repack":
            self.quiesce(reason=reason)
        PUMP_STATS.decline(reason, app=batch[0].app_key, batch=len(batch))
        return PendingBatch(batch, "ready",
                            results=self.session._dispatch(batch),
                            reason=reason)

    # ---- harvest stage ----

    def _harvest_head(self, *, block: bool = True) -> List[ServeResult]:
        """Deliver the window's head (FIFO).  With `block=False` an
        unfinished head stays and [] returns."""
        if not self._inflight:
            return []
        pb = self._inflight[0]
        if not block and not pb.ready():
            return []
        self._inflight.pop(0)
        tr = obs.tracer()
        overlapped = bool(self._inflight)
        with tr.span("serve_harvest", app=pb.batch[0].app_key,
                     batch=len(pb.batch), window=self.window,
                     inflight=len(self._inflight), overlapped=overlapped,
                     mode=pb.mode):
            results = (pb.results if pb.mode == "ready"
                       else self._results_from_dispatch(pb))
        delivered = self.session.queue.deliver(pb.batch, results)
        self.stats["harvested"] += 1
        if overlapped:
            self.stats["overlapped_harvests"] += 1
        if tr.enabled:
            obs.metrics().gauge("grape_serve_window_depth").set(
                len(self._inflight))
        return delivered

    def _results_from_dispatch(self, pb: PendingBatch) -> List[ServeResult]:
        """One deferred batch -> results: launch it if the cap held it
        back, join it, launch the next prepared batch, and only then
        copy out the lanes, while the successor runs."""
        sess = self.session
        try:
            if pb.dispatch is None:
                self._launch(pb)
            d = pb.dispatch.wait()
            t_sync = time.perf_counter_ns()
        except Exception as e:
            self._fail_batch(pb, e)
            self._launch_next()
            return pb.results
        self._launch_next()
        batch = pb.batch
        tr = obs.tracer()
        if tr.enabled:
            obs.metrics().counter("grape_supersteps_total").inc(
                int(d.rounds.sum()) + len(batch))
        results = lane_results(batch, d.rounds, d.terminate, d.breaches,
                               d.lane_values, None, deferred=True)
        sess.stats["failed"] += sum(not r.ok for r in results)
        if self.eager_values:
            for r in results:
                if not r.ok:
                    continue
                try:
                    r.resolve()
                except Exception as e:  # one lane's extraction failing
                    sess.stats["failed"] += 1
                    r.ok = False
                    r.values = None
                    r.error = {"error": f"{type(e).__name__}: {e}"}
        t_h1 = time.perf_counter_ns()
        # window_wait overlaps the dispatch stage (admit -> launch holds
        # the host prepare): an attribution aid, not a partition
        stages = {
            "window_wait_us": max(0, pb.t_launch_ns - pb.t_admit_ns) // 1000,
            "dispatch_us": pb.disp_ns // 1000,
            "device_us": max(0, t_sync - pb.t_launch_ns) // 1000,
            "harvest_us": max(0, t_h1 - t_sync) // 1000,
        }
        for r in results:
            r.stages = dict(stages)
        if tr.enabled:
            now_ns = time.perf_counter_ns()
            for b, (req, res) in enumerate(zip(batch, results)):
                # each query's lane row, dispatch to harvest
                tr.emit_span_raw(
                    "serve_query", t0_ns=pb.t0_ns,
                    dur_ns=max(0, now_ns - pb.t0_ns), tid=tr.lane_tid(b),
                    query_id=req.id, app=req.app_key, lane=b,
                    rounds=res.rounds, ok=res.ok, tenant=req.tenant or "",
                    queue_wait_us=queue_wait_us(req))
        return results

    # ---- driving ----

    def pump(self, now: float | None = None, *, force: bool = False,
             block: bool = False,
             max_dispatch: int | None = None) -> List[ServeResult]:
        """One step: fill the window, deliver every batch that has
        finished, and -- when the window is full with admitted work
        waiting, or `block` -- harvest the head to make room, so a
        waiting batch never starves behind a full window.  Returns the
        results delivered by this call."""
        out: List[ServeResult] = []
        self._fill(now, force=force, max_dispatch=max_dispatch)
        out.extend(self.session.queue.take_expired())
        while True:
            got = self._harvest_head(block=False)
            if not got:
                break
            out.extend(got)
            self._fill(now, force=force, max_dispatch=max_dispatch)
        if self._inflight and (
            block or (len(self._inflight) >= self.window
                      and self.session.queue.pending() > 0)):
            out.extend(self._harvest_head(block=True))
            self._fill(now, force=force, max_dispatch=max_dispatch)
        return out

    def drain(self) -> List[ServeResult]:
        """Dispatch and harvest until the queue and the window are empty
        (partial batches forced)."""
        out: List[ServeResult] = []
        while self.session.queue.pending() or self._inflight:
            self._fill(force=True)
            out.extend(self.session.queue.take_expired())
            out.extend(self._harvest_head(block=True))
        out.extend(self.session.queue.take_expired())
        return out

    def quiesce(self, reason: str = "quiesce") -> List[ServeResult]:
        """Drain the window without admitting new batches: the barrier
        `ingest` relies on.  Results are delivered as usual."""
        if not self._inflight:
            return []
        self.stats["quiesces"] += 1
        PUMP_STATS._record({"kind": "quiesce", "reason": reason,
                            "inflight": len(self._inflight)})
        out: List[ServeResult] = []
        while self._inflight:
            out.extend(self._harvest_head(block=True))
        return out

    def ingest(self, ops, *, force_repack: bool = False) -> dict:
        """The barrier item: quiesce, then apply the delta through the
        session.  The window refills on the next pump() / drain(), so
        batches admitted after the barrier see the new graph."""
        self.quiesce(reason="ingest")
        return self.session.ingest(ops, force_repack=force_repack)
