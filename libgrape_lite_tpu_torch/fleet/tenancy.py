"""Tenants under one budget: fairness, eviction, re-admission.

Counterpart of `libgrape_lite_tpu/fleet/tenancy.py`.  A tenant is one
serving principal: a `ServeSession` of its own (or shared), or a
`FleetRouter`, plus its own pending lane, fairness weight and
accounting.  The `FleetManager` runs N tenants in one process:

* **weighted round-robin**: `submit` appends a `TenantTicket` to the
  tenant's lane; `forward_round` moves tickets into the sessions' queues
  in WRR order (ceil(weight) tickets a tenant a cycle, tenants in
  insertion order), so a deep backlog never starves a light tenant.
  Forwarded requests carry `tenant=`, which joins the compat key: two
  tenants never share a batch.
* **budgeted residency**: before a tenant's work dispatches its priced
  footprint (fleet/budget.py) is admitted under the shared
  `FleetBudget`, which may evict cost-weighted LRU victims through
  `ServeSession.release_device`: the device tensors go, the host side
  (workers, host plans) stays, so a re-admission restores the tensors
  and builds no worker and no plan.  Every decision lands in
  FLEET_STATS; with obs/ armed an eviction also counts in
  `grape_fleet_evictions_total` and an admission sets
  `grape_fleet_resident_bytes`.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fleet.budget import (
    FLEET_STATS,
    FleetBudget,
    target_footprint,
)


class FleetAdmissionError(RuntimeError):
    """The budget rejected a tenant and nothing could be evicted."""


class TenantTicket:
    """One submitted query, forwarded or not yet.  Once forwarded,
    `request` is the QueryRequest and `result` its outcome."""

    __slots__ = ("tenant", "app_key", "args", "kwargs", "request")

    def __init__(self, tenant: str, app_key: str, args: dict,
                 kwargs: dict):
        self.tenant = tenant
        self.app_key = app_key
        self.args = args
        self.kwargs = kwargs
        self.request = None  # the QueryRequest once forwarded

    @property
    def forwarded(self) -> bool:
        return self.request is not None

    @property
    def done(self) -> bool:
        return self.request is not None and self.request.done

    @property
    def result(self):
        return None if self.request is None else self.request.result


class Tenant:
    """One serving principal: its target (session or router), weight,
    pending lane and accounting."""

    def __init__(self, name: str, target, weight: float = 1.0):
        self.name = name
        self.target = target
        self.weight = float(weight)
        self.pending = deque()  # tickets not forwarded yet
        self.tickets: List[TenantTicket] = []  # every ticket, in order
        self.admitted = False
        self.stats = {
            "submitted": 0, "forwarded": 0, "completed": 0,
            "ok": 0, "failed": 0, "readmits": 0,
        }

    @property
    def evictable(self) -> bool:
        """A router is never evicted by the manager: drain is its
        lifecycle."""
        return hasattr(self.target, "release_device")

    def latencies(self) -> List[float]:
        return [t.result.latency_s for t in self.tickets
                if t.done and t.result.latency_s]


class FleetManager:
    """N tenants, one budget, one process (module docstring)."""

    def __init__(self, budget: Optional[FleetBudget] = None):
        self.budget = budget or FleetBudget()
        self.tenants: Dict[str, Tenant] = {}
        self.forward_order: List[str] = []  # the tenant of each forward
        # the control loop (autopilot/), ticked once a pump when attached
        self.autopilot = None

    def attach_autopilot(self, autopilot) -> None:
        """Own an Autoscaler: `pump` ticks it once a pass.  Its budget
        should be this manager's, so scale-ups and admissions price
        against one capacity."""
        self.autopilot = autopilot

    def add_tenant(self, name: str, target, *,
                   weight: float = 1.0) -> Tenant:
        """Register a tenant over `target` (its own ServeSession, one
        shared with other tenants -- the budget bills the fragment once
        -- or a FleetRouter).  Admission waits for the first use."""
        if name in self.tenants:
            raise ValueError(f"duplicate tenant {name!r}")
        t = Tenant(name, target, weight)
        self.tenants[name] = t
        return t

    # ---- budget ----

    def _evict_cb(self, victim: str) -> None:
        """Release the victim's device footprint (the budget calls this
        mid-admission).  A fragment another resident tenant shares stays
        placed; only the victim's own buffers go."""
        t = self.tenants[victim]
        frag = getattr(t.target, "fragment", None)
        shared = frag is not None and any(
            getattr(o.target, "fragment", None) is frag
            and o.admitted and o.name != victim
            for o in self.tenants.values())
        t.target.release_device(release_fragment=not shared)
        t.admitted = False
        if obs.tracer().enabled:
            obs.metrics().counter("grape_fleet_evictions_total").inc()

    def ensure_resident(self, name: str) -> None:
        """Admit (or re-admit) a tenant before its work dispatches: the
        budget decides first, from the host-priced footprint, and only
        then are the device tensors placed -- a reject must not leave
        the fragment on the card.  A re-admission is counted in the
        tenant's stats and FLEET_STATS."""
        t = self.tenants[name]
        if t.admitted and getattr(t.target, "resident", True):
            self.budget.touch(name)
            return
        was_evicted = t.admitted is False and t.stats["forwarded"] > 0
        decision = self.budget.admit(
            name, target_footprint(t.target), weight=t.weight,
            evictable=t.evictable, evict=self._evict_cb)
        if not decision["admitted"]:
            raise FleetAdmissionError(
                f"tenant {name!r} rejected: {decision['reason']} (asked "
                f"{decision['asked_bytes']}B, used "
                f"{decision['used_bytes']}B of {decision['capacity']}B)")
        restore = getattr(t.target, "restore_device", None)
        if restore is not None:
            restore()
        t.admitted = True
        if was_evicted:
            t.stats["readmits"] += 1
            FLEET_STATS._record({"kind": "tenant_readmit", "name": name})
        if obs.tracer().enabled:
            obs.metrics().gauge("grape_fleet_resident_bytes").set(
                self.budget.used_bytes())

    # ---- admission front and fairness ----

    def submit(self, tenant: str, app_key: str,
               args: dict | None = None, **kwargs) -> TenantTicket:
        t = self.tenants[tenant]
        ticket = TenantTicket(tenant, app_key, dict(args or {}), kwargs)
        t.pending.append(ticket)
        t.tickets.append(ticket)
        t.stats["submitted"] += 1
        return ticket

    def _forward(self, t: Tenant, ticket: TenantTicket) -> None:
        self.ensure_resident(t.name)
        self.budget.touch(t.name)
        ticket.request = t.target.submit(ticket.app_key, ticket.args,
                                         tenant=t.name, **ticket.kwargs)
        t.stats["forwarded"] += 1
        self.forward_order.append(t.name)

    def forward_round(self) -> int:
        """One WRR cycle: each tenant with pending work forwards up to
        ceil(weight) tickets, tenants in insertion order.  Returns how
        many were forwarded (0: nothing pending)."""
        n = 0
        for t in self.tenants.values():
            quota = max(1, int(-(-t.weight // 1)))
            while quota > 0 and t.pending:
                self._forward(t, t.pending.popleft())
                quota -= 1
                n += 1
        return n

    def _targets(self) -> List:
        """The distinct targets (tenants may share a session or a
        router), each pumped once a step."""
        seen, out = set(), []
        for t in self.tenants.values():
            if id(t.target) not in seen:
                seen.add(id(t.target))
                out.append(t.target)
        return out

    def _account(self) -> None:
        for t in self.tenants.values():
            done = sum(1 for tk in t.tickets if tk.done)
            if done != t.stats["completed"]:
                t.stats["completed"] = done
                t.stats["ok"] = sum(1 for tk in t.tickets
                                    if tk.done and tk.result.ok)
                t.stats["failed"] = done - t.stats["ok"]

    def pump(self) -> List:
        """One step: a WRR forward cycle, then one pump pass over each
        distinct target; with an autopilot attached, one control tick
        after it.  Returns this step's results."""
        self.forward_round()
        out = []
        for target in self._targets():
            out.extend(target.pump(force=True) if _takes_force(target)
                       else target.pump())
        self._account()
        if self.autopilot is not None:
            self.autopilot.tick()
        return out

    def drain(self) -> List:
        """Forward and pump until every lane and every target queue is
        empty.  Every pending ticket forwards first, cycle by cycle (the
        queue order is the fairness decision), then the targets drain."""
        out = []
        while any(t.pending for t in self.tenants.values()) or any(
                _target_busy(tg) for tg in self._targets()):
            while self.forward_round():
                pass
            for target in self._targets():
                out.extend(target.drain())
            self._account()
        return out

    def snapshot(self) -> dict:
        from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

        per_tenant = {}
        for t in self.tenants.values():
            lat = latency_summary_ms(t.latencies())
            per_tenant[t.name] = {
                **t.stats,
                "weight": t.weight,
                "resident": bool(t.admitted
                                 and getattr(t.target, "resident", True)),
                "p50_ms": lat["p50_ms"],
                "p99_ms": lat["p99_ms"],
            }
        out = {"tenants": per_tenant, "budget": self.budget.snapshot(),
               "fleet": FLEET_STATS.snapshot()}
        if self.autopilot is not None:
            from libgrape_lite_tpu_torch.autopilot.signals import (
                AUTOPILOT_STATS,
            )

            out["autopilot"] = AUTOPILOT_STATS.snapshot()
        return out


def _takes_force(target) -> bool:
    """ServeSession.pump passes `force` to the queue; FleetRouter.pump
    takes no argument."""
    return not hasattr(target, "replicas")


def _target_busy(target) -> bool:
    if hasattr(target, "replicas"):
        return any(r.session.queue.pending() or r.pump.inflight()
                   for r in target.replicas)
    return bool(target.queue.pending())
