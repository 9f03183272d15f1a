"""ServeSession: one resident graph serving many queries.

Counterpart of `libgrape_lite_tpu/serve/session.py`.  A session pins the
expensive per-graph artifacts once and every query reuses them:

  * the fragment's device tensors (`frag.dev`), and the per-fragment
    caches the apps build on them (strict plans, deduplicated and push
    CSRs);
  * one resident Worker per app (`worker`), so the second query of an
    app builds no worker and no plan -- `cache_stats()` counts both,
    the port's counterpart of the JAX session's compiled-runner and
    pack-plan counters (PyTorch runs eagerly: nothing is compiled).

Queries arrive through the AdmissionQueue (serve/queue.py) and coalesce
into batched queries (`Worker.query_batch`) under the BatchPolicy.
`ingest` applies a delta stream between dispatches (dyn/): staged edges
ride the overlay that the min-fold apps fold each round, until the
repack policy folds them into a rebuilt fragment.

Typical use::

    sess = ServeSession(frag)
    reqs = [sess.submit("sssp", {"source": s}) for s in sources]
    sess.drain()                      # or pump() under a wait policy
    values = reqs[0].result.values

The autopilot's hooks: `attach_result_cache` (a fence-epoch result
cache looked up at submit, filled at delivery) and `attach_admission`
(the queue sheds or defers over-budget tenants).

With obs/ armed each synchronous dispatch is a `serve_batch` span, and
each of its queries a `serve_query` span on its lane's row with the
query id, tenant and queue wait (a cache hit too, with `cached`).

Guards (guard/, serve/batch.py): `guard` is the session's default
policy and a request's own `guard=` wins over it.  A guarded batch
isolates breaches: a lane whose invariants fail comes back as a failed
ServeResult carrying its diagnostic bundle while its batchmates return
their own queries' bytes; a guarded single query that breaches fails
the same way.  A guarded request is never cached (its verdicts are
part of the answer).  A vertex-cut fragment takes no `dyn`: its tile
pulls do not read the delta overlay.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.ops.spmv import plan_stats
from libgrape_lite_tpu_torch.serve.policy import BatchPolicy, compat_key
from libgrape_lite_tpu_torch.serve.queue import (
    AdmissionQueue,
    QueryRequest,
    ServeResult,
)
from libgrape_lite_tpu_torch.worker.worker import Worker


def _calibration_harvester():
    """The live-harvest hook (ops/calibration.py): when
    GRAPE_CALIBRATE_HARVEST is armed, the callable that joins an
    execution's measured wall to its worker's K1 columns; None (the
    common case) costs one environment read."""
    from libgrape_lite_tpu_torch.ops import calibration

    if not calibration.harvest_armed():
        return None
    return calibration.harvest_from_worker


def check_guard(guard) -> None:
    """Refuse an unknown guard policy at the door (None reads
    GRAPE_GUARD at dispatch; a GuardConfig passes as it is)."""
    from libgrape_lite_tpu_torch.guard.config import POLICIES, GuardConfig

    if guard is None or isinstance(guard, GuardConfig):
        return
    if (str(guard) or "off") not in POLICIES:
        raise ValueError(f"unknown guard policy {guard!r} (expected one "
                         f"of {POLICIES})")


def queue_wait_us(req: QueryRequest) -> int:
    """Submit -> pop microseconds of one request (0 before its pop)."""
    if not req.popped_s:
        return 0
    return int(max(0.0, req.popped_s - req.submitted_s) * 1e6)


def lane_results(batch: List[QueryRequest], rounds, terminate, breaches,
                 values, stages: dict | None,
                 deferred: bool = False) -> List[ServeResult]:
    """A batch's results, a lane each: a breached lane (its bundle in
    `breaches`) fails with the bundle, every other lane carries its
    values -- `values(b)` now, or on first read when `deferred`."""
    out = []
    for b, req in enumerate(batch):
        common = dict(request_id=req.id, app_key=req.app_key,
                      rounds=int(rounds[b]), lane=b, batch_size=len(batch),
                      stages=None if stages is None else dict(stages))
        if breaches is not None and breaches[b] is not None:
            out.append(ServeResult(ok=False, error=breaches[b], **common))
        elif deferred:
            out.append(ServeResult(
                ok=True, values_fn=(lambda bb=b: values(bb)),
                terminate_code=int(terminate[b]), **common))
        else:
            out.append(ServeResult(ok=True, values=values(b),
                                   terminate_code=int(terminate[b]),
                                   **common))
    return out


def _error_results(batch: List[QueryRequest], error: str):
    return [ServeResult(request_id=req.id, app_key=req.app_key, ok=False,
                        error={"error": error}, lane=b,
                        batch_size=len(batch))
            for b, req in enumerate(batch)]


class ServeSession:
    def __init__(self, fragment, apps: Dict | None = None,
                 policy: BatchPolicy | None = None,
                 guard: Optional[str] = None, dyn=None):
        """`apps` maps app_key -> app factory (default: the whole
        APP_REGISTRY).  `dyn` enables live ingest: True (RepackPolicy
        from the environment), a RepackPolicy, or a DynGraph; the
        fragment must keep its edge list (retain_edge_list=True) for
        the repack path."""
        check_guard(guard)
        if apps is None:
            from libgrape_lite_tpu_torch.models import APP_REGISTRY

            apps = dict(APP_REGISTRY)
        self.dyn = None
        if dyn is not None and dyn is not False:
            if getattr(fragment, "mesh_kind", "frag") == "vc2d":
                # the 2-D tile pulls never read the overlay: staged edges
                # would be silently invisible
                raise ValueError(
                    "dyn ingest is not supported on a vertex-cut "
                    "fragment: the 2-D tile pulls do not read the delta "
                    "overlay, so staged edges would be silently "
                    "invisible; repack into a new fragment instead")
            from libgrape_lite_tpu_torch.dyn import DynGraph

            self.dyn = (dyn if isinstance(dyn, DynGraph) else DynGraph(
                fragment, policy=None if dyn is True else dyn))
            fragment = self.dyn.fragment
        self.fragment = fragment
        self.apps = apps
        self.policy = policy or BatchPolicy()
        self.guard = guard
        self.queue = AdmissionQueue(self._dispatch, self.policy,
                                    self._compat_key)
        self._workers: Dict[str, Worker] = {}
        self._worker_stats = {"hits": 0, "misses": 0}
        self._pump = None  # the attached AsyncServePump, if any
        self._closed = False
        # the result cache (autopilot/cache.py) and its epoch source: a
        # bare session's own ingest counter, or a fleet replica's router
        # fence (attach_result_cache)
        self._cache = None
        self._cache_epoch = None
        self._ingest_epoch = 0
        self.stats = {
            "queries": 0, "batches": 0, "failed": 0,
            "sequential_fallbacks": 0, "cache_hits": 0, "ingested_ops": 0,
            "overlay_applies": 0, "repacks": 0, "forced_repacks": 0,
        }

    # ---- resident workers ----

    def worker(self, app_key: str) -> Worker:
        """The resident Worker of one app: built on first use, then
        reused by every query."""
        w = self._workers.get(app_key)
        if w is None:
            if app_key not in self.apps:
                raise ValueError(
                    f"unknown application {app_key!r}; session serves: "
                    f"{sorted(self.apps)}")
            w = Worker(self.apps[app_key](), self.fragment)
            self._workers[app_key] = w
            self._worker_stats["misses"] += 1
        else:
            self._worker_stats["hits"] += 1
        return w

    def cache_stats(self) -> dict:
        """{"runner": resident-worker hits and misses, "pack": the
        strict planner's counters (ops/spmv.py::plan_stats)} -- the JAX
        session's keys."""
        return {"runner": dict(self._worker_stats), "pack": plan_stats()}

    # ---- eviction, re-admission, close ----

    @property
    def resident(self) -> bool:
        """True while the fragment's device tensors are placed."""
        return self.fragment.dev is not None

    def release_device(self, *, release_fragment: bool = True) -> dict:
        """Evict: quiesce an attached pump, drop each resident worker's
        result buffers and -- unless the fragment is shared with
        another session -- the fragment's device tensors.  The host
        side stays, so `restore_device` builds no worker and no plan."""
        if self._pump is not None and self._pump.inflight():
            self._pump.quiesce(reason="release_device")
        for w in self._workers.values():
            w.release_buffers()
        released = False
        if release_fragment:
            released = self.fragment.release_device()
        return {"fragment_released": released,
                "workers": len(self._workers)}

    def restore_device(self) -> bool:
        """Re-admit an evicted session: place the device tensors from the
        host CSRs again.  False when already resident."""
        if self._closed:
            raise RuntimeError("session is closed")
        return self.fragment.restore_device()

    def close(self) -> None:
        """Drain and detach the pump, release the device, drop the
        workers; later submits raise.  Idempotent."""
        if self._closed:
            return
        if self._pump is not None:
            self._pump.close()
        self.release_device()
        self._workers.clear()
        self._closed = True

    # ---- live ingest (dyn/) ----

    def ingest(self, ops, *, force_repack: bool = False) -> dict:
        """Apply a batch of delta ops between dispatches (a superstep
        boundary: no query is in flight; an attached pump is quiesced
        first).  Below the repack threshold the staged edges ride the
        overlay; a repack's rebuilt fragment goes to every resident
        worker.  Returns the DynGraph's report."""
        if self.dyn is None:
            raise RuntimeError(
                "session was built without dyn=; pass dyn=True (or a "
                "RepackPolicy / DynGraph) to enable live ingest")
        if self._pump is not None and self._pump.inflight():
            self._pump.quiesce(reason="ingest")
        # one ingest can fold more than once (a buffer at capacity), so
        # count from the DynGraph's own counters
        before_r = self.dyn.stats["repacks"]
        before_o = self.dyn.stats["overlay_applies"]
        report = self.dyn.ingest(ops, force_repack=force_repack)
        self.stats["ingested_ops"] += report.get("staged", 0)
        self.stats["repacks"] += self.dyn.stats["repacks"] - before_r
        self.stats["overlay_applies"] += (
            self.dyn.stats["overlay_applies"] - before_o)
        if self.dyn.fragment is not self.fragment:
            self._adopt_fragment()
        if report.get("staged", 0):
            # a content-changing ingest moves the cache epoch (an empty
            # forced repack keeps every answer); a session owning its
            # epoch drops the stale one here, a fleet replica's router
            # does it when the fence moves
            self._ingest_epoch += 1
            if self._cache is not None:
                self._cache.invalidate_stale(self._cache_epoch())
        return report

    def _adopt_fragment(self) -> None:
        """Point the session and every resident worker at the rebuilt
        fragment."""
        self.fragment = self.dyn.fragment
        for w in self._workers.values():
            w.fragment = self.dyn.fragment

    def _ensure_dyn_view(self, app_key: str, w: Worker) -> None:
        """An app without an overlay contract must see a consistent
        graph: fold the staged overlay first, a counted forced repack."""
        if self.dyn is None or self.dyn.overlay_count == 0:
            return
        if getattr(w.app, "dyn_overlay_support", False):
            return
        self.dyn.fold_now(reason=f"{app_key} has no dyn-overlay contract")
        self.stats["repacks"] += 1
        self.stats["forced_repacks"] += 1
        self._adopt_fragment()

    # ---- admission ----

    def _compat_for(self, app_key: str, args: dict, max_rounds, guard,
                    tenant) -> tuple:
        # an unknown app must not raise while the queue picks a batch
        # (it would wedge the head); dispatch fails it as a result.  The
        # lane key is read off the app's class: no worker is built here
        if app_key not in self.apps:
            return (app_key, "?unknown", tenant)
        app_cls = self.apps[app_key]
        return compat_key(
            app_key, args, max_rounds, guard or self.guard,
            getattr(app_cls, "batch_query_key", None),
            getattr(app_cls, "mesh_kind", "frag"),
        ) + (tenant,)

    def _compat_key(self, req: QueryRequest) -> tuple:
        return self._compat_for(req.app_key, req.args, req.max_rounds,
                                req.guard, req.tenant)

    # ---- result cache and admission control (autopilot/) ----

    def attach_result_cache(self, cache, epoch=None) -> None:
        """Wire a ResultCache (autopilot/cache.py): `submit` looks it up
        before the request enters the queue, and the queue's `deliver`
        stores every cacheable ok result.  `epoch` gives the
        invalidation fence (a FleetRouter passes `lambda: router.fence`);
        by default the session's ingest counter, which every
        content-changing ingest moves."""
        self._cache = cache
        self._cache_epoch = epoch or (lambda: self._ingest_epoch)
        self.queue.result_cache = cache
        self.queue.cache_meta = self._cache_meta
        self.queue.cache_epoch = self._cache_epoch

    def attach_admission(self, controller) -> None:
        """Wire an AdmissionController (autopilot/admission.py): the
        queue's pop sheds or defers over-budget tenants first."""
        self.queue.admission = controller.review

    def _cacheable(self, app_key: str, args: dict, guard):
        """The lane source when the query is cacheable -- a point query
        (the app's `batch_query_key`) with its lane argument and no guard
        named, as in the JAX session -- else None."""
        if self._cache is None or (guard or self.guard) is not None:
            return None
        app = self.apps.get(app_key)
        bq = getattr(app, "batch_query_key", None) if app else None
        if bq is None:
            return None
        return args.get(bq)

    def _cache_meta(self, req: QueryRequest):
        """(compat, source) of a cacheable request, else None: the
        queue's store hook."""
        source = self._cacheable(req.app_key, req.args, req.guard)
        if source is None:
            return None
        return (self._compat_key(req), source)

    def _deliver_cached(self, app_key: str, args: dict, entry, *,
                        max_rounds, priority, deadline_s,
                        tenant) -> QueryRequest:
        """Serve one cache hit without dispatching: a request and its
        result with zeroed stages (no queue wait, no device time), the
        same `slo.observe` as a delivered result, pushed on the queue's
        out-of-band channel so every pump and drain returns it."""
        from libgrape_lite_tpu_torch.obs import slo

        t0_ns = time.perf_counter_ns()
        req = QueryRequest(
            app_key=app_key, args=dict(args), max_rounds=max_rounds,
            priority=int(priority), deadline_s=deadline_s, tenant=tenant)
        req.popped_s = req.submitted_s
        vals, rounds, code = entry
        res = ServeResult(
            request_id=req.id, app_key=app_key, ok=True, values=vals,
            rounds=rounds, terminate_code=code, batch_size=1,
            stages={"queue_wait_us": 0, "window_wait_us": 0,
                    "dispatch_us": 0, "device_us": 0, "harvest_us": 0})
        res.latency_s = time.perf_counter() - req.submitted_s
        req.result = res
        self.stats["cache_hits"] += 1
        slo.observe(app_key, tenant, res.latency_s, True)
        tr = obs.tracer()
        if tr.enabled:
            tr.emit_span_raw(
                "serve_query", t0_ns=t0_ns,
                dur_ns=time.perf_counter_ns() - t0_ns, tid=tr.lane_tid(0),
                query_id=req.id, app=app_key, lane=0, rounds=rounds,
                ok=True, cached=True, tenant=tenant or "", queue_wait_us=0)
        self.queue.push_oob(res)
        return req

    def submit(self, app_key: str, args: dict | None = None, *,
               max_rounds: int | None = None,
               guard: str | None = None, priority: int = 0,
               deadline_s: float | None = None,
               tenant: str | None = None) -> QueryRequest:
        if self._closed:
            raise RuntimeError("session is closed")
        check_guard(guard)
        args = dict(args or {})
        # the result cache first: a hit never enters the queue
        source = self._cacheable(app_key, args, guard)
        if source is not None:
            compat = self._compat_for(app_key, args, max_rounds, guard,
                                      tenant)
            entry = self._cache.lookup(compat, source, self._cache_epoch())
            if entry is not None:
                return self._deliver_cached(
                    app_key, args, entry, max_rounds=max_rounds,
                    priority=priority, deadline_s=deadline_s, tenant=tenant)
        return self.queue.submit(
            app_key, args, max_rounds=max_rounds, guard=guard,
            priority=priority, deadline_s=deadline_s, tenant=tenant)

    def pump(self, **kw) -> List[ServeResult]:
        return self.queue.pump(**kw)

    def drain(self) -> List[ServeResult]:
        return self.queue.drain()

    def async_pump(self, window: int | None = None):
        """An AsyncServePump over this session (serve/pipeline.py): up
        to `window` batches admitted and not yet harvested at once
        (default `policy.inflight`).  W = 1 is byte- and order-identical
        to the synchronous `pump` / `drain`."""
        from libgrape_lite_tpu_torch.serve.pipeline import AsyncServePump

        return AsyncServePump(self, window=window)

    def serve(self, stream) -> List[ServeResult]:
        """Submit every item of a scripted stream, drain, and return the
        results in completion order.  Items are (app_key, args) pairs or
        {"app", "args", "max_rounds", "guard", "priority", "deadline_s",
        "tenant"} dicts."""
        for item in stream:
            if isinstance(item, dict):
                self.submit(
                    item["app"], item.get("args"),
                    max_rounds=item.get("max_rounds"),
                    guard=item.get("guard"),
                    priority=item.get("priority", 0),
                    deadline_s=item.get("deadline_s"),
                    tenant=item.get("tenant"),
                )
            else:
                app_key, args = item
                self.submit(app_key, args)
        return self.drain()

    # ---- dispatch ----

    def _dispatch(self, batch: List[QueryRequest]) -> List[ServeResult]:
        """Run one coalesced batch: one query through `Worker.query`,
        several through `Worker.query_batch`, with a sequential fallback
        for apps that cannot batch (host-only loops, MutationContext).
        Failures become error results; nothing raises out of the loop."""
        self.stats["batches"] += 1
        self.stats["queries"] += len(batch)
        try:
            w = self.worker(batch[0].app_key)
        except ValueError as e:
            self.stats["failed"] += len(batch)
            return _error_results(batch, str(e))
        try:
            self._ensure_dyn_view(batch[0].app_key, w)
        except Exception as e:  # a forced repack that failed
            self.stats["failed"] += len(batch)
            return _error_results(batch, f"{type(e).__name__}: {e}")
        guard = batch[0].guard or self.guard
        tr = obs.tracer()
        if len(batch) > 1:
            try:
                w._check_batchable()
            except ValueError:
                self.stats["sequential_fallbacks"] += 1
                return [self._run_single(w, req, guard) for req in batch]
            with tr.span("serve_batch", app=batch[0].app_key,
                         batch=len(batch)) as sp:
                results = self._run_batched(w, batch, batch[0].max_rounds,
                                            guard)
        else:
            with tr.span("serve_batch", app=batch[0].app_key,
                         batch=1) as sp:
                results = [self._run_single(w, batch[0], guard)]
        if tr.enabled:
            # one row a query: the lane's interval is the batch's, tagged
            # with its request id so the timeline stays attributable
            for b, (req, res) in enumerate(zip(batch, results)):
                tr.emit_span_raw(
                    "serve_query", t0_ns=sp.t0_ns, dur_ns=sp.dur_ns,
                    tid=tr.lane_tid(b), query_id=req.id, app=req.app_key,
                    lane=b, rounds=res.rounds, ok=res.ok,
                    tenant=req.tenant or "",
                    queue_wait_us=queue_wait_us(req))
        return results

    @staticmethod
    def _exec_stages(total_ns: int) -> dict:
        """The stages of one synchronous execution.  The host loop
        enqueues and waits on the card in turns every round, so the
        whole of it counts as dispatch, as the JAX session counts paths
        it cannot split."""
        return {"window_wait_us": 0, "dispatch_us": total_ns // 1000,
                "device_us": 0}

    def _run_single(self, w: Worker, req: QueryRequest,
                    guard=None) -> ServeResult:
        from libgrape_lite_tpu_torch.guard.monitor import GuardError

        try:
            t0 = time.perf_counter_ns()
            w.query(req.max_rounds, guard=guard, **req.args)
            t_exec = time.perf_counter_ns()
            vals = w.result_values()
            stages = self._exec_stages(t_exec - t0)
            stages["harvest_us"] = (time.perf_counter_ns() - t_exec) // 1000
            harvest = _calibration_harvester()
            if harvest is not None:
                # the query's last vote read ended its wall: device_us is
                # 0 here, the execution is timed whole
                harvest(w, (t_exec - t0) / 1e9, w.rounds)
            return ServeResult(
                request_id=req.id, app_key=req.app_key, ok=True,
                values=vals, rounds=w.rounds,
                terminate_code=w._terminate_code, batch_size=1,
                stages=stages)
        except GuardError as e:  # a breach fails this query alone
            self.stats["failed"] += 1
            return ServeResult(
                request_id=req.id, app_key=req.app_key, ok=False,
                error=e.bundle, rounds=w.rounds, batch_size=1)
        except Exception as e:  # one bad query must not stop the loop
            self.stats["failed"] += 1
            return ServeResult(
                request_id=req.id, app_key=req.app_key, ok=False,
                error={"error": f"{type(e).__name__}: {e}"}, batch_size=1)

    def _run_batched(self, w: Worker, batch: List[QueryRequest], mr,
                     guard=None) -> List[ServeResult]:
        try:
            t0 = time.perf_counter_ns()
            w.query_batch([req.args for req in batch], mr, guard=guard)
            t_exec = time.perf_counter_ns()
        except Exception as e:  # the whole batch fails, lane by lane
            self.stats["failed"] += len(batch)
            return _error_results(batch, f"{type(e).__name__}: {e}")
        stages = self._exec_stages(t_exec - t0)
        harvest = _calibration_harvester()
        if harvest is not None:
            # the lanes run in lockstep to the longest lane's rounds
            br = w.batch_rounds
            rounds = (max(int(r) for r in br) if br is not None and len(br)
                      else w.rounds)
            harvest(w, (t_exec - t0) / 1e9, rounds, lanes=len(batch))
        results = lane_results(batch, w.batch_rounds, w.batch_terminate,
                               w.batch_breaches, w.batch_result_values,
                               stages)
        self.stats["failed"] += sum(not r.ok for r in results)
        harvest_us = (time.perf_counter_ns() - t_exec) // 1000
        for r in results:
            r.stages["harvest_us"] = harvest_us
        return results
