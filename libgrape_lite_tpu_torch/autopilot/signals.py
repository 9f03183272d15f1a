"""Control signals: the autopilot's one read of the serving fleet.

Counterpart of `libgrape_lite_tpu/autopilot/signals.py`.  One
`SignalReader.read()` takes the federation's ``slo`` namespace
(obs/slo.py: error-budget burn per key) and the live queues and router
into an immutable `ControlSignals`:

  * queue depth, and p50 / p99 of the recent submit -> dispatch waits
    (serve/queue.py records each popped request's wait);
  * outstanding queries, the routable replica count and the fence
    (fleet/router.py);
  * the worst burn and the burn by key.

The reader keeps a window of recent reads, and the scaler's `decide`
acts only on a condition that held across the whole window, so one
spike never flaps the fleet.  Every autopilot counter lives in the
federated ``autopilot`` namespace (`AUTOPILOT_STATS`).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

from libgrape_lite_tpu_torch.obs import federation as _federation
from libgrape_lite_tpu_torch.obs import slo as _slo  # noqa: F401  (registers "slo")
from libgrape_lite_tpu_torch.obs.federation import FederatedStats

#: every decision of the control loop, counted, with a bounded history
AUTOPILOT_STATS = FederatedStats("autopilot", {
    "ticks": 0,
    "scale_ups": 0,
    "scale_downs": 0,
    "holds": 0,
    "shed": 0,
    "deferred": 0,
    "priced": 0,
    "cache_hits": 0,
    "cache_misses": 0,
    "cache_stores": 0,
    "cache_evictions": 0,
    "cache_invalidations": 0,
    "decisions": [],
})

#: bound on the recorded decision list
MAX_DECISIONS = 256


def record_decision(kind: str, **detail) -> None:
    """Append one decision event (bounded) and count it."""
    counter = {
        "scale_up": "scale_ups",
        "scale_down": "scale_downs",
        "hold": "holds",
        "shed": "shed",
        "defer": "deferred",
    }.get(kind)
    if counter is not None:
        AUTOPILOT_STATS[counter] += 1
    ev = AUTOPILOT_STATS["decisions"]
    ev.append({"kind": kind, **detail})
    if len(ev) > MAX_DECISIONS:
        del ev[: MAX_DECISIONS // 2]


@dataclass(frozen=True)
class ControlSignals:
    """One immutable read of the fleet's control inputs."""

    queue_depth: int            # pending requests on routable replicas
    outstanding: int            # admitted and unfinished, all replicas
    wait_p50_ms: float          # recent submit -> dispatch waits
    wait_p99_ms: float
    max_burn: float             # worst error-budget burn of any key
    burn_by_key: Tuple[Tuple[str, float], ...]  # sorted (key, burn)
    replicas: int               # routable replicas
    total_replicas: int         # routable + draining
    fence: int                  # the router's graph-version fence

    def burn_of(self, tenant: Optional[str]) -> float:
        """The burn of one tenant's objective key (0.0 when unknown)."""
        key = f"tenant:{tenant}"
        for k, v in self.burn_by_key:
            if k == key:
                return v
        return 0.0


#: how many recent waits feed the wait signal: the current load, not a
#: lifetime average
WAIT_WINDOW = 64


class SignalReader:
    """Read the router (or one bare `session=`, as one permanent
    replica), its queues and the federation into ControlSignals;
    `window` bounds the history `decide` consumes."""

    def __init__(self, router=None, session=None, window: int = 3):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.router = router
        self.session = session
        self.window = int(window)
        self._recent: deque = deque(maxlen=self.window)

    def _sessions(self) -> List:
        if self.router is not None:
            return [r.session for r in self.router.replicas if r.routable]
        return [self.session] if self.session is not None else []

    def read(self) -> ControlSignals:
        """Take one read, append it to the window and return it."""
        from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

        depth = 0
        waits: List[float] = []
        for s in self._sessions():
            depth += s.queue.pending()
            waits.extend(s.queue.admission_waits[-WAIT_WINDOW:])
        lat = latency_summary_ms(waits)
        slo_view = _federation.snapshot("slo") or {}
        burn = dict(slo_view.get("burn_by_key") or {})
        common = dict(
            queue_depth=depth,
            wait_p50_ms=lat["p50_ms"],
            wait_p99_ms=lat["p99_ms"],
            max_burn=float(slo_view.get("max_burn") or 0.0),
            burn_by_key=tuple(sorted(burn.items())),
        )
        if self.router is not None:
            routable = [r for r in self.router.replicas if r.routable]
            sig = ControlSignals(
                outstanding=sum(r.outstanding for r in routable),
                replicas=len(routable),
                total_replicas=len(self.router.replicas),
                fence=self.router.fence, **common)
        else:
            n = 1 if self.session is not None else 0
            sig = ControlSignals(outstanding=0, replicas=n,
                                 total_replicas=n, fence=0, **common)
        self._recent.append(sig)
        return sig

    @property
    def recent(self) -> Tuple[ControlSignals, ...]:
        """The last `window` reads, oldest first."""
        return tuple(self._recent)

    @property
    def saturated(self) -> bool:
        """True once the window is full."""
        return len(self._recent) >= self.window

    def clear(self) -> None:
        self._recent.clear()
