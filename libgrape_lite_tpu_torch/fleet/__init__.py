"""fleet/ -- the multi-tenant serving fleet.

Counterpart of `libgrape_lite_tpu/fleet/`.  One process, N resident
(graph x app) sessions, R replicas, one device byte budget:

* **budget.py**: price each session's device footprint (fragment,
  per-fragment caches, overlay planes, resident results) and decide
  admission and eviction with a cost-weighted LRU; every decision in
  `FLEET_STATS`.
* **tenancy.py**: `FleetManager`, N tenants with weighted round-robin
  fairness, tenants never sharing a batch, eviction and re-admission
  through `ServeSession.release_device` / `restore_device`.
* **router.py / drain.py**: `FleetRouter`, one graph resident R times
  behind a least-outstanding router, ingest broadcast behind a
  graph-version fence, and `drain(replica)` with no dropped query.

The CLI surface is `python -m libgrape_lite_tpu_torch.cli serve
--replicas R --drain_at K --tenants by_app|N`.
"""

from libgrape_lite_tpu_torch.fleet.budget import (
    FLEET_STATS,
    FleetBudget,
    Footprint,
    fragment_bytes,
    overlay_bytes,
    plan_stream_bytes,
    runner_bytes,
    session_footprint,
    target_footprint,
)
from libgrape_lite_tpu_torch.fleet.drain import (
    begin_drain,
    drain_replica,
    rejoin,
    rejoin_lost,
)
from libgrape_lite_tpu_torch.fleet.router import (
    FenceError,
    FenceViolationError,
    FleetRouter,
    Replica,
    run_fleet_script,
)
from libgrape_lite_tpu_torch.fleet.tenancy import (
    FleetAdmissionError,
    FleetManager,
    Tenant,
    TenantTicket,
)

__all__ = [
    "FLEET_STATS",
    "FenceError",
    "FenceViolationError",
    "FleetAdmissionError",
    "FleetBudget",
    "FleetManager",
    "FleetRouter",
    "Footprint",
    "Replica",
    "Tenant",
    "TenantTicket",
    "begin_drain",
    "drain_replica",
    "fragment_bytes",
    "overlay_bytes",
    "plan_stream_bytes",
    "rejoin",
    "rejoin_lost",
    "run_fleet_script",
    "runner_bytes",
    "session_footprint",
    "target_footprint",
]
