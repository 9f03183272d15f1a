"""Autoscaler: queue, wait and burn signals in; drain, rejoin, replicate out.

Counterpart of `libgrape_lite_tpu/autopilot/scaler.py`.  The decide step
is a pure function (`decide`) over the SignalReader's window.  The act
step (`Autoscaler.act`) moves the fleet only through the drain
machinery, which drops no query:

  * **scale up**: rejoin a drained replica when one is parked (its
    catch-up log replays to the fence; its host side is warm), else
    replicate a fresh fragment from a live replica (`replicate_fragment`,
    a deterministic rebuild from the retained edge list) and
    `FleetRouter.add_replica` it at the fence.  A pending overlay is
    folded first (a counted forced repack) so the edge list is the
    current graph.
  * **scale down**: `begin_drain` without a rejoin, last in first out:
    the replica finishes what it admitted, stops routing and parks with
    a catch-up log, which makes the next scale-up cheap.

Guard rails: replica bounds, a cooldown after every act, the device
budget (a scale-up that does not fit is a recorded hold) and the
hysteresis window.  Every decision is recorded in the federated
``autopilot`` namespace.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

from libgrape_lite_tpu_torch.autopilot.signals import (
    AUTOPILOT_STATS,
    ControlSignals,
    SignalReader,
    record_decision,
)


@dataclass(frozen=True)
class ScalerConfig:
    """Knobs of the scaling policy."""

    min_replicas: int = 1
    max_replicas: int = 4
    # hysteresis: a condition must hold across this many reads
    window: int = 3
    # ticks to sit out after an act, while the fleet absorbs it
    cooldown_ticks: int = 4
    # overload: queue depth per routable replica above this ...
    up_queue_depth: int = 8
    # ... or the p99 submit -> dispatch wait above this (ms; 0 disables)
    up_wait_p99_ms: float = 0.0
    # ... or any key burning at or past this (0 disables)
    up_burn: float = 0.0
    # calm: total depth at or below this, nothing outstanding or burning
    down_queue_depth: int = 0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.cooldown_ticks < 0:
            raise ValueError(
                f"cooldown_ticks must be >= 0, got {self.cooldown_ticks}")


@dataclass(frozen=True)
class Decision:
    """One verdict: the action, why, and the replica counts."""

    action: str      # "scale_up" | "scale_down" | "hold"
    reason: str
    replicas: int    # routable replicas the decision saw
    target: int      # routable replicas the action aims at


def _overloaded(sig: ControlSignals, cfg: ScalerConfig) -> bool:
    if sig.queue_depth / max(1, sig.replicas) > cfg.up_queue_depth:
        return True
    if cfg.up_wait_p99_ms and sig.wait_p99_ms > cfg.up_wait_p99_ms:
        return True
    return bool(cfg.up_burn and sig.max_burn >= cfg.up_burn)


def _calm(sig: ControlSignals, cfg: ScalerConfig) -> bool:
    if sig.queue_depth > cfg.down_queue_depth or sig.outstanding > 0:
        return False
    return not (cfg.up_burn and sig.max_burn >= cfg.up_burn)


def decide(window: Sequence[ControlSignals], cfg: ScalerConfig, *,
           cooldown: int = 0) -> Decision:
    """The policy: the window (oldest first) in, one Decision out;
    `cooldown` is the ticks still to sit out."""
    if not window:
        return Decision("hold", "no_signals", 0, 0)
    cur = window[-1]
    n = cur.replicas
    if cooldown > 0:
        return Decision("hold", "cooldown", n, n)
    if len(window) < cfg.window:
        return Decision("hold", "window_filling", n, n)
    recent = list(window)[-cfg.window:]
    if all(_overloaded(s, cfg) for s in recent):
        if n >= cfg.max_replicas:
            return Decision("hold", "at_max_replicas", n, n)
        if cfg.up_burn and cur.max_burn >= cfg.up_burn:
            why = f"burn {cur.max_burn:.2f} >= {cfg.up_burn}"
        elif cur.queue_depth / max(1, n) > cfg.up_queue_depth:
            why = (f"queue depth {cur.queue_depth} over "
                   f"{cfg.up_queue_depth}/replica x {n}")
        else:
            why = f"wait p99 {cur.wait_p99_ms}ms > {cfg.up_wait_p99_ms}ms"
        return Decision("scale_up", why, n, n + 1)
    if all(_calm(s, cfg) for s in recent):
        if n <= cfg.min_replicas:
            return Decision("hold", "at_min_replicas", n, n)
        return Decision("scale_down", "sustained_idle", n, n - 1)
    return Decision("hold", "in_band", n, n)


class Autoscaler:
    """Observe (SignalReader), decide (pure), act (fleet moves).

    `session_factory(fragment)` builds a replica ServeSession around a
    replicated fragment; without it a scale-up can only rejoin a drained
    replica.  `budget` (FleetBudget) gates fresh replicas."""

    def __init__(self, router, config: Optional[ScalerConfig] = None, *,
                 session_factory: Optional[Callable] = None, budget=None,
                 reader: Optional[SignalReader] = None):
        self.router = router
        self.config = config or ScalerConfig()
        self.reader = reader or SignalReader(router,
                                             window=self.config.window)
        self._factory = session_factory
        self.budget = budget
        self.cooldown = 0

    def tick(self) -> Decision:
        """One iteration: read, decide, act, record.  Never raises: a
        failed act becomes a recorded hold."""
        AUTOPILOT_STATS["ticks"] += 1
        self.reader.read()
        d = decide(self.reader.recent, self.config, cooldown=self.cooldown)
        if self.cooldown > 0:
            self.cooldown -= 1
        if d.action != "hold":
            d = self.act(d)
        record_decision(d.action, reason=d.reason, replicas=d.replicas,
                        target=d.target, fence=self.router.fence)
        return d

    def _routable(self):
        return [r for r in self.router.replicas if r.routable]

    def act(self, decision: Decision) -> Decision:
        """Carry out one non-hold decision; returns the decision taken
        (one that cannot proceed becomes a hold)."""
        try:
            if decision.action == "scale_up":
                return self._scale_up(decision)
            if decision.action == "scale_down":
                return self._scale_down(decision)
        except Exception as e:  # the loop outlives a failed act
            return replace(decision, action="hold",
                           reason=f"act_failed: {type(e).__name__}: {e}")
        return decision

    def _scale_up(self, decision: Decision) -> Decision:
        parked = [r for r in self.router.replicas if not r.routable]
        if parked:
            idx = parked[0].idx
            self.router.rejoin(idx)
            self.cooldown = self.config.cooldown_ticks
            return replace(decision,
                           reason=decision.reason + f"; rejoined r{idx}")
        if self._factory is None:
            return replace(decision, action="hold",
                           reason="no_session_factory")
        src = self._routable()[0].session
        if self.budget is not None and self.budget.capacity:
            from libgrape_lite_tpu_torch.fleet.budget import (
                session_footprint,
            )

            est = session_footprint(src).total
            if self.budget.used_bytes() + est > self.budget.capacity:
                return replace(decision, action="hold",
                               reason=f"hbm_budget: +{est}B over capacity")
        if src.dyn is not None and src.dyn.overlay_count:
            # the edge list must be the current graph: fold the overlay
            # first, a counted forced repack of the source
            src.ingest([], force_repack=True)
        from libgrape_lite_tpu_torch.fragment.mutation import (
            replicate_fragment,
        )

        sess = self._factory(replicate_fragment(src.fragment))
        r = self.router.add_replica(sess)
        self.cooldown = self.config.cooldown_ticks
        return replace(decision,
                       reason=decision.reason + f"; added r{r.idx}")

    def _scale_down(self, decision: Decision) -> Decision:
        routable = self._routable()
        if len(routable) <= max(1, self.config.min_replicas):
            return replace(decision, action="hold",
                           reason="at_min_replicas")
        victim = routable[-1]  # the highest index: last in, first out
        self.router.begin_drain(victim.idx)
        self.cooldown = self.config.cooldown_ticks
        return replace(decision,
                       reason=decision.reason + f"; drained r{victim.idx}")
