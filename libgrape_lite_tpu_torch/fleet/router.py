"""Replica routing: one graph resident R times behind one front router.

Counterpart of `libgrape_lite_tpu/fleet/router.py`.  The same graph
serves from R replica `ServeSession`s, each on its own fragment copy
(`fragment.mutation.replicate_fragment` rebuilds from the retained edge
list, deterministically, so replicas answer byte-identically):

* **least-outstanding routing**: `submit` picks the routable replica
  with the fewest outstanding queries (ties by replica index, so a
  scripted stream routes the same every run) and keeps per-replica
  served / ok / latency accounting (`Replica.summary`).
* **graph-version fence**: the router's fence counts ingests.  An
  ingest is a fleet-wide barrier: every routable replica drains (its
  in-flight queries land on the graph before the delta), applies the
  same delta chunk and takes the new fence.  A routable replica whose
  version is not the fence raises `FenceViolationError` at submit and at
  pump time: no result may mix graph versions.
* **drain** (fleet/drain.py): stop routing to a replica, finish what it
  admitted, run offline work, rejoin at the fence.

Each replica serves through an `AsyncServePump` (window 1 by default:
the synchronous loop's batches and order) whose quiesce is the drain
barrier.  With obs/ armed each replica's pump pass is a `fleet_pump`
span (and a `fleet_replica` span on the replica's own row when it
delivered), each ingest a `fleet_ingest` instant, and a submit sets the
replica's `grape_fleet_outstanding_r<idx>` gauge.  A fence violation
triggers the flight recorder (a postmortem bundle when a sink is set)
before it raises.
"""

from __future__ import annotations

from typing import List, Optional

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fleet.budget import FLEET_STATS
from libgrape_lite_tpu_torch.obs.recorder import RECORDER


class FenceError(RuntimeError):
    """No routable replica is available at the current fence."""


class FenceViolationError(RuntimeError):
    """A routable replica's graph version is not the fence: dispatching
    to it could mix results of two graph versions."""


class Replica:
    """One resident copy of the graph: its session, pump, version and
    accounting."""

    def __init__(self, idx: int, session, window: int = 1):
        self.idx = idx
        self.session = session
        self.pump = session.async_pump(window=window)
        self.version = 0
        self.routable = True
        self.outstanding = 0
        self.catchup: List[tuple] = []  # (fence, ops, force) missed
        self.served = 0
        self.ok = 0
        self.latencies: List[float] = []
        self.drains = 0

    def summary(self, wall_s: Optional[float] = None) -> dict:
        from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

        lat = latency_summary_ms(self.latencies)
        out = {
            "served": self.served,
            "ok": self.ok,
            "p50_ms": lat["p50_ms"],
            "p99_ms": lat["p99_ms"],
            "version": self.version,
            "drains": self.drains,
        }
        if wall_s:
            out["qps"] = round(self.served / wall_s, 2)
        return out


class FleetRouter:
    """Front router over R replica sessions (module docstring)."""

    def __init__(self, sessions, *, window: int = 1):
        if not sessions:
            raise ValueError("router needs at least one replica session")
        self._window = int(window)
        self.replicas = [Replica(i, s, window)
                         for i, s in enumerate(sessions)]
        self.fence = 0
        self._live: List[tuple] = []  # (QueryRequest, Replica)
        self.stats = {"routed": 0, "ingests": 0, "drains": 0}
        # the shared result cache (autopilot/cache.py); the fence is its
        # invalidation epoch
        self.cache = None

    # ---- elasticity (autopilot/scaler.py) ----

    def add_replica(self, session) -> Replica:
        """Join a new replica session at the current fence (the
        autoscaler's scale-up).  The session must hold a content-
        identical copy of the current graph (`replicate_fragment` of a
        live replica's fragment).  Routable at once; recorded."""
        r = Replica(len(self.replicas), session, self._window)
        r.version = self.fence
        self.replicas.append(r)
        if self.cache is not None:
            session.attach_result_cache(self.cache,
                                        epoch=lambda: self.fence)
        FLEET_STATS.record("add_replica", replica=r.idx, fence=self.fence)
        return r

    def attach_cache(self, cache) -> None:
        """Share one ResultCache (autopilot/cache.py) across the
        replicas, keyed on the router's fence: a result of any replica
        holds fleet-wide (replicas are byte-identical at one fence), and
        `ingest` drops the old epoch after the fence moves."""
        self.cache = cache
        for r in self.replicas:
            r.session.attach_result_cache(cache, epoch=lambda: self.fence)

    # ---- routing ----

    def _routable(self) -> List[Replica]:
        out = [r for r in self.replicas if r.routable]
        for r in out:
            self._check_fence(r)
        return out

    def _check_fence(self, r: Replica) -> None:
        if r.version != self.fence:
            RECORDER.trigger("fence_violation", extra={
                "replica": r.idx, "replica_version": r.version,
                "fence": self.fence})
            raise FenceViolationError(
                f"replica {r.idx} is routable at graph version "
                f"{r.version} but the fence is {self.fence} -- results "
                "would mix graph versions")

    def submit(self, app_key: str, args: dict | None = None, **kw):
        """Route one query to the least-outstanding routable replica
        (fence-checked); returns its QueryRequest."""
        cands = self._routable()
        if not cands:
            raise FenceError("no routable replica (all draining?) -- "
                             "rejoin one before submitting")
        pick = min(cands, key=lambda r: (r.outstanding, r.idx))
        req = pick.session.submit(app_key, args, **kw)
        pick.outstanding += 1
        self._live.append((req, pick))
        self.stats["routed"] += 1
        tr = obs.tracer()
        if tr.enabled:
            obs.metrics().gauge(f"grape_fleet_outstanding_r{pick.idx}").set(
                pick.outstanding)
        return req

    def _collect(self) -> None:
        """Bind finished requests back to their replica's accounting."""
        still = []
        for req, r in self._live:
            if req.done:
                r.outstanding -= 1
                r.served += 1
                r.ok += int(bool(req.result.ok))
                r.latencies.append(req.result.latency_s)
            else:
                still.append((req, r))
        self._live = still

    # ---- driving ----

    def pump(self) -> List:
        """One pass: pump every routable replica once (fence-checked),
        collect the accounting, return this pass's results."""
        return self._each_replica(lambda r: r.pump.pump(force=True))

    def drain(self) -> List:
        """Drain every routable replica's queue and window (a draining
        replica is finished by fleet/drain.py)."""
        return self._each_replica(lambda r: r.pump.drain())

    def _each_replica(self, step) -> List:
        """`step(replica)` on every routable replica in turn, each call a
        `fleet_pump` span (and a `fleet_replica` span on the replica's
        row when it delivered); then the accounting."""
        out = []
        tr = obs.tracer()
        for r in self._routable():
            with tr.span("fleet_pump", replica=r.idx,
                         outstanding=r.outstanding) as sp:
                got = step(r)
            if tr.enabled and got:
                tr.emit_span_raw(
                    "fleet_replica", t0_ns=sp.t0_ns, dur_ns=sp.dur_ns,
                    tid=tr.replica_tid(r.idx), replica=r.idx,
                    results=len(got))
            out.extend(got)
        self._collect()
        return out

    # ---- dyn ingest: the version fence ----

    def ingest(self, ops, *, force_repack: bool = False) -> dict:
        """Broadcast one delta chunk behind the version fence.  First
        every routable replica drains, so every query admitted before
        this call lands on the graph before the delta: queries and
        ingests interleave alike at any replica count, which makes R 2
        byte-identical to R 1.  Then the fence moves, every routable
        replica applies the same ops (`dyn.broadcast_ingest`), and a
        draining replica logs the chunk for its catch-up."""
        from libgrape_lite_tpu_torch.dyn.ingest import broadcast_ingest

        self.drain()
        self.fence += 1
        ops = list(ops)
        live = [r for r in self.replicas if r.routable]
        reports = broadcast_ingest([r.session for r in live], ops,
                                   force_repack=force_repack)
        for r in self.replicas:
            if r.routable:
                r.version = self.fence
            else:
                r.catchup.append((self.fence, ops, force_repack))
        self.stats["ingests"] += 1
        if self.cache is not None:
            # results of the old epoch describe a graph that is gone
            self.cache.invalidate_stale(self.fence)
        obs.tracer().instant(
            "fleet_ingest", fence=self.fence, ops=len(ops),
            applied=len(reports),
            deferred=len(self.replicas) - len(reports))
        return {"fence": self.fence, "applied_replicas": len(reports),
                "reports": reports}

    # ---- drain lifecycle (fleet/drain.py) ----

    def begin_drain(self, idx: int, *, offline=None) -> dict:
        from libgrape_lite_tpu_torch.fleet.drain import begin_drain

        return begin_drain(self, idx, offline=offline)

    def rejoin(self, idx: int) -> dict:
        from libgrape_lite_tpu_torch.fleet.drain import rejoin

        return rejoin(self, idx)

    def drain_replica(self, idx: int, *, offline=None) -> dict:
        from libgrape_lite_tpu_torch.fleet.drain import drain_replica

        return drain_replica(self, idx, offline=offline)

    def summary(self, wall_s: Optional[float] = None) -> dict:
        return {
            "fence": self.fence,
            "stats": dict(self.stats),
            "replicas": {f"r{r.idx}": r.summary(wall_s)
                         for r in self.replicas},
        }


def run_fleet_script(target, queries, *, manager=None, tenant_of=None,
                     delta_ops=None, ingest_every: int = 8,
                     drain_at: Optional[int] = None,
                     drain_idx: int = 0, offline=None,
                     submit_kwargs: Optional[dict] = None) -> List:
    """The deterministic fleet loop of the CLI, chip_smoke.py and the
    tests: submit `queries` ([(app_key, args)] in order) in groups of
    `ingest_every`, complete each group (a fleet-wide barrier), then
    broadcast the next delta chunk -- so the query / graph-version
    interleave, and every result byte, is the same at any replica count,
    window or tenant split.  `drain_at` begins draining replica
    `drain_idx` before that query index is submitted; it rejoins after
    the next ingest barrier (its catch-up log then holds a chunk) or at
    the end.  Returns the tickets or requests in submit order.

    `target` is a FleetRouter or a bare ServeSession; with `manager`,
    submissions go through the tenancy front (`tenant_of(i, app_key)`
    names query i's tenant).  `submit_kwargs` (e.g. {"max_rounds": 3})
    rides on every submit, as on the plain serve path."""
    delta_ops = list(delta_ops or [])
    submit_kwargs = dict(submit_kwargs or {})
    router = target if hasattr(target, "replicas") else None
    n_groups = max(1, -(-len(queries) // max(1, ingest_every)))
    chunk = -(-len(delta_ops) // n_groups) if delta_ops else 0
    oi = 0
    draining = False

    def complete():
        if manager is not None:
            manager.drain()
        elif router is not None:
            router.drain()
        else:
            target.drain()

    def ingest_next():
        nonlocal oi
        (router or target).ingest(delta_ops[oi:oi + chunk])
        oi += chunk

    reqs = []
    for i, (app_key, args) in enumerate(queries):
        if drain_at is not None and i == drain_at and router is not None:
            complete()  # the manager's lanes empty before the drain
            router.begin_drain(drain_idx, offline=offline)
            draining = True
        if manager is not None:
            reqs.append(manager.submit(tenant_of(i, app_key), app_key,
                                       args, **submit_kwargs))
        else:
            reqs.append(target.submit(app_key, args, **submit_kwargs))
        if (i + 1) % max(1, ingest_every) == 0:
            complete()
            if oi < len(delta_ops):
                ingest_next()
                if draining:
                    router.rejoin(drain_idx)
                    draining = False
    complete()
    while oi < len(delta_ops):
        ingest_next()
    if draining:
        router.rejoin(drain_idx)
    complete()
    return reqs
