"""Admission queue: accept queries, coalesce compatible ones, dispatch.

Counterpart of `libgrape_lite_tpu/serve/queue.py`.  The queue is a host
FIFO pumped by the caller (a scripted stream, the CLI's `serve`, a
feeder thread's consumer): `submit` enqueues, `pump` ships at most one
batch when the policy says it is ready (full, or the head has waited
`max_wait_s`), `drain` pumps until empty.  FIFO order holds within a
compatibility class; a batch is the head request plus the next
compatible requests in arrival order (those between them stay queued),
and `drain` forces partial batches, so an incompatible head never waits
forever.

Requests carry an optional `priority` class -- the queue serves the
highest class present, FIFO within it, and classes never coalesce --
and an optional `deadline_s`: a request whose deadline passes before it
dispatches fails as a ServeResult with the reason (`take_expired` hands
those out through every pump and drain), never silently.  `submit` and
`_pop_ready` share a lock, so a feeder thread can submit while the pump
pops.

`_pop_ready` / the dispatch callback / `deliver` are split for the
async pump (serve/pipeline.py), which pops with the same decision and
delivers through the same bookkeeping: batch composition, FIFO order,
the batch-size histogram and the admission-wait record are one
implementation however many batches are in flight.

The autopilot's hooks: `admission` (a callable(req) -> "admit" |
"defer" | "shed", consulted before a batch is picked: a shed request
fails with its reason, a deferred tenant queues behind in-budget ones)
and `result_cache` (`deliver` stores every cacheable ok result).  Every
finished query, delivered or failed undispatched, is counted against
its SLO (`obs.slo.observe`).

The flight recorder (obs/recorder.py) gets a `deadline_expired` record
for each sweep that fails requests, and a `deadline_storm` trigger (a
postmortem bundle when a sink is set) when one sweep fails at least
`DEADLINE_STORM_THRESHOLD`; a shed records `shed_over_budget`.  With
obs/ armed each popped request's admission wait goes into the
`grape_serve_admission_wait_seconds` histogram.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.obs import slo
from libgrape_lite_tpu_torch.obs.recorder import (
    DEADLINE_STORM_THRESHOLD,
    RECORDER,
)
from libgrape_lite_tpu_torch.serve.policy import BatchPolicy

_IDS = itertools.count()


def latency_summary_ms(latencies) -> dict:
    """{n, p50_ms, p99_ms} of latencies in seconds: sorted ascending,
    index `min(n - 1, int(n * p))` -- the one percentile convention of
    the queue's record and the CLI summary."""
    if not latencies:
        return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0}
    lat = sorted(latencies)
    return {
        "n": len(lat),
        "p50_ms": round(1e3 * lat[len(lat) // 2], 3),
        "p99_ms": round(
            1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3),
    }


@dataclass
class QueryRequest:
    """One admitted query: app, arguments, and the limits that decide
    coalescing (policy.compat_key).  `priority` picks the scheduling
    class; `deadline_s` (seconds from submission) fails a request that
    has not dispatched in time; `tenant` tags its owner -- requests of
    two tenants never share a batch."""

    app_key: str
    args: dict
    max_rounds: Optional[int] = None
    guard: Optional[str] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    tenant: Optional[str] = None
    id: int = field(default_factory=lambda: next(_IDS))
    submitted_s: float = field(default_factory=time.perf_counter)
    # stamped by _pop_ready: submit -> pop is the request's queue wait
    popped_s: float = 0.0
    result: Optional["ServeResult"] = None

    @property
    def done(self) -> bool:
        return self.result is not None


class ServeResult:
    """One query's outcome: assembled values, or an error.

    `values` has a deferred form for the async pump: built with
    `values_fn` instead of `values`, the [fnum, vp] assembly (the lane's
    copy to the host and finalize) runs the first time `values` is read
    or when the harvest stage resolves it, once.  A resolved result is
    indistinguishable from an eager one."""

    __slots__ = ("request_id", "app_key", "ok", "rounds",
                 "terminate_code", "error", "lane", "batch_size",
                 "latency_s", "stages", "_values", "_values_fn")

    def __init__(self, request_id: int, app_key: str, ok: bool,
                 values: Optional[np.ndarray] = None, rounds: int = 0,
                 terminate_code: int = 0, error: Optional[dict] = None,
                 lane: int = 0, batch_size: int = 1,
                 latency_s: float = 0.0,
                 values_fn: Optional[Callable[[], np.ndarray]] = None,
                 stages: Optional[dict] = None):
        self.request_id = request_id
        self.app_key = app_key
        self.ok = ok
        self.rounds = rounds
        self.terminate_code = terminate_code
        self.error = error
        self.lane = lane  # position in its batch
        self.batch_size = batch_size
        self.latency_s = latency_s  # submit -> delivery
        # the latency in stages (integer us): queue_wait_us (submit ->
        # pop, per request), then window_wait_us / dispatch_us /
        # device_us / harvest_us (the batch's, the same for its lanes)
        self.stages = stages
        self._values = values
        self._values_fn = values_fn

    @property
    def values(self) -> Optional[np.ndarray]:
        if self._values is None and self._values_fn is not None:
            fn, self._values_fn = self._values_fn, None
            self._values = fn()
        return self._values

    @values.setter
    def values(self, v) -> None:
        self._values = v
        self._values_fn = None

    @property
    def deferred(self) -> bool:
        """True while the values are still an unresolved thunk."""
        return self._values_fn is not None

    def resolve(self) -> "ServeResult":
        """Resolve deferred values now (the harvest stage)."""
        self.values
        return self


class AdmissionQueue:
    """FIFO and coalescing front of a ServeSession.  `dispatch(batch)`
    is the session's executor: one ServeResult per request, in batch
    order.  The queue keeps a batch-size histogram (all-1 bars: the
    stream never coalesced) and each request's submit -> dispatch wait."""

    def __init__(self, dispatch: Callable[[List[QueryRequest]],
                                          List[ServeResult]],
                 policy: BatchPolicy | None = None,
                 compat_key: Callable[[QueryRequest], tuple] | None = None):
        self._dispatch = dispatch
        self.policy = policy or BatchPolicy()
        self._compat = compat_key or (
            lambda r: (r.app_key, r.max_rounds, r.guard or "", r.tenant))
        self._pending: List[QueryRequest] = []
        # _pending and the expired results against a feeder thread
        self._lock = threading.Lock()
        self.batch_hist: Dict[int, int] = {}
        self.completed = 0
        # deadline-expired and shed requests, failed with their reason
        # and returned by the next pump / drain (take_expired)
        self.expired = 0
        self.shed = 0
        self._expired_out: List[ServeResult] = []
        # the admission hook (autopilot/admission.py): callable(req) ->
        # "admit" | "defer" | "shed", run before a batch is picked
        self.admission = None
        # the result cache (autopilot/cache.py): deliver() stores every
        # ok result that cache_meta(req) -> (compat, source) names, under
        # the epoch cache_epoch(); ServeSession.attach_result_cache wires
        # all three
        self.result_cache = None
        self.cache_meta = None
        self.cache_epoch = None
        # each popped request's submit -> dispatch wait, seconds
        self.admission_waits: List[float] = []

    def submit(self, app_key: str, args: dict | None = None, *,
               max_rounds: int | None = None,
               guard: str | None = None, priority: int = 0,
               deadline_s: float | None = None,
               tenant: str | None = None) -> QueryRequest:
        req = QueryRequest(
            app_key=app_key, args=dict(args or {}),
            max_rounds=max_rounds, guard=guard,
            priority=int(priority), deadline_s=deadline_s, tenant=tenant,
        )
        with self._lock:
            self._pending.append(req)
        return req

    def pending(self) -> int:
        return len(self._pending)

    def _fail_undispatched(self, req: QueryRequest, waited: float,
                           error: dict) -> None:
        """Fail one request that never dispatched: an error result with
        its reason, out through take_expired, counted against its SLO
        like any finished query.  The caller holds the lock."""
        res = ServeResult(
            request_id=req.id, app_key=req.app_key, ok=False,
            error={**error, "waited_s": round(waited, 6)},
            latency_s=waited, stages={"queue_wait_us": int(waited * 1e6)})
        req.result = res
        self._expired_out.append(res)
        self.completed += 1
        slo.observe(req.app_key, req.tenant, waited, ok=False)

    def _expire_overdue(self, now: float) -> None:
        """Fail every pending request whose deadline passed before it
        dispatched.  The caller holds the lock."""
        live: List[QueryRequest] = []
        swept: List[int] = []
        for req in self._pending:
            if (req.deadline_s is not None
                    and now - req.submitted_s > req.deadline_s):
                self._fail_undispatched(req, now - req.submitted_s, {
                    "error": "deadline expired before dispatch",
                    "reason": "deadline_expired",
                    "deadline_s": req.deadline_s})
                self.expired += 1
                swept.append(req.id)
            else:
                live.append(req)
        self._pending = live
        if swept:
            # the recorder never raises and takes no queue lock
            RECORDER.record("deadline_expired", n=len(swept),
                            ids=swept[:16])
            if len(swept) >= DEADLINE_STORM_THRESHOLD:
                # a window's worth failing in one sweep is a postmortem
                # trigger, not just a count
                RECORDER.trigger("deadline_storm", extra={
                    "expired_in_sweep": len(swept),
                    "request_ids": swept[:64],
                    "pending": len(self._pending),
                })

    def _review_admission(self) -> set:
        """Run the admission hook over the pending requests: a shed one
        fails with its reason; a deferred one stays, and its tenant is
        returned so `_head_batch` serves in-budget tenants first.  The
        caller holds the lock."""
        deferred: set = set()
        if self.admission is None:
            return deferred
        live: List[QueryRequest] = []
        shed_n = 0
        for req in self._pending:
            try:
                verdict = self.admission(req)
            except Exception:
                verdict = "admit"  # a broken hook must not wedge the queue
            if verdict == "shed":
                self._fail_undispatched(
                    req, time.perf_counter() - req.submitted_s, {
                        "error": "shed: tenant over error budget",
                        "reason": "shed_over_budget",
                        "tenant": req.tenant or ""})
                self.shed += 1
                shed_n += 1
            else:
                if verdict == "defer":
                    deferred.add(req.tenant)
                live.append(req)
        self._pending = live
        if shed_n:
            RECORDER.record("shed_over_budget", n=shed_n)
        return deferred

    def take_expired(self) -> List[ServeResult]:
        """The out-of-band results since the last call: deadline-expired
        and shed failures, and cache hits that never dispatched."""
        with self._lock:
            out, self._expired_out = self._expired_out, []
        return out

    def push_oob(self, res: ServeResult) -> None:
        """Append one out-of-band result (a cache hit served without a
        dispatch, serve/session.py) to the take_expired channel."""
        with self._lock:
            self._expired_out.append(res)
            self.completed += 1

    def _head_batch(self, deferred: set = frozenset()) -> List[QueryRequest]:
        """The head -- the first request of the highest priority class
        present -- plus the next compatible requests of that class in
        FIFO order, up to max_batch lanes.  Tenants in `deferred` head a
        batch only when nothing in budget is pending."""
        cands = [r for r in self._pending if r.tenant not in deferred]
        if not cands:
            cands = self._pending
        top = max(r.priority for r in cands)
        head = next(r for r in cands if r.priority == top)
        key = self._compat(head)
        batch = [head]
        for req in self._pending[self._pending.index(head) + 1:]:
            if len(batch) >= self.policy.max_batch:
                break
            if req.priority == top and self._compat(req) == key:
                batch.append(req)
        return batch

    def _pop_ready(self, now: float | None = None, *,
                   force: bool = False) -> List[QueryRequest]:
        """Pop at most one ready batch -- full, its head waited
        `max_wait_s`, or `force`d -- after expiring overdue deadlines;
        records each popped request's wait.  [] when nothing is ready.
        The decision the sync `pump` and the async pump share."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            self._expire_overdue(now)
            deferred = self._review_admission()
            if not self._pending:
                return []
            batch = self._head_batch(deferred)
            if not force and len(batch) < self.policy.max_batch:
                if now - batch[0].submitted_s < self.policy.max_wait_s:
                    return []
            ids = {r.id for r in batch}
            self._pending = [r for r in self._pending if r.id not in ids]
        t_pop = time.perf_counter()
        hist = obs.metrics().histogram(
            "grape_serve_admission_wait_seconds",
            help="per-request submit->dispatch wait in the admission queue")
        for req in batch:
            req.popped_s = t_pop
            wait = t_pop - req.submitted_s
            self.admission_waits.append(wait)
            hist.observe(wait)
        return batch

    def deliver(self, batch: List[QueryRequest],
                results: List[ServeResult]) -> List[ServeResult]:
        """Bind one batch's results to its requests: latency and queue
        wait stamps, the histogram, the completion count.  Shared by the
        sync `pump` and the async pump's harvest."""
        if len(results) != len(batch):
            raise RuntimeError(
                f"dispatch returned {len(results)} results for a "
                f"{len(batch)}-lane batch")
        t_done = time.perf_counter()
        for req, res in zip(batch, results):
            res.latency_s = t_done - req.submitted_s
            st = res.stages
            if st is None:
                st = res.stages = {}
            if "queue_wait_us" not in st and req.popped_s:
                st["queue_wait_us"] = int(
                    (req.popped_s - req.submitted_s) * 1e6)
            req.result = res
            slo.observe(req.app_key, req.tenant, res.latency_s, res.ok)
            if self.result_cache is not None and res.ok:
                meta = self.cache_meta(req) if self.cache_meta else None
                if meta is not None:
                    compat, source = meta
                    fence = self.cache_epoch() if self.cache_epoch else 0
                    self.result_cache.store(compat, source, fence, res)
        self.batch_hist[len(batch)] = self.batch_hist.get(len(batch), 0) + 1
        self.completed += len(batch)
        return results

    def admission_wait_summary(self) -> dict:
        """p50 / p99 of the recorded submit -> dispatch waits, ms."""
        return latency_summary_ms(self.admission_waits)

    def pump(self, now: float | None = None, *,
             force: bool = False) -> List[ServeResult]:
        """Dispatch at most one batch (full, aged past `max_wait_s`, or
        `force`d); returns the delivered results with any expired ones
        ([] when nothing was ready)."""
        batch = self._pop_ready(now, force=force)
        out = self.take_expired()
        if not batch:
            return out
        out.extend(self.deliver(batch, self._dispatch(batch)))
        return out

    def drain(self) -> List[ServeResult]:
        """Pump until the queue is empty, partial batches forced."""
        out: List[ServeResult] = self.take_expired()
        while self._pending:
            out.extend(self.pump(force=True))
        return out
