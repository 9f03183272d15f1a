"""Priced per-query admission: shed or defer tenants past their budget.

Counterpart of `libgrape_lite_tpu/autopilot/admission.py`.  A point
query's cost is priced before the fleet pays for it, and a pure decide
maps (tenant burn, cost) to a verdict:

  * burn below `defer_burn` -> **admit**;
  * past budget, under `shed_burn` and affordable -> **defer**: the
    request stays queued, and the queue serves in-budget tenants first
    (an all-deferred queue still drains);
  * at or past `shed_burn`, or an over-budget tenant's request pricier
    than `max_cost` -> **shed**: a failed ServeResult with
    ``reason=shed_over_budget``, returned through `take_expired` like a
    deadline expiry, and counted against the tenant's SLO.

Every shed and defer is recorded in the federated ``autopilot``
namespace.

Pricing: the JAX package prices a query from its resolved pack plans'
per-round ledgers (`spmv_pack.plan_ledger`), and falls back to the
fragment's CSR bytes a round when no plan is resolved.  This package
has no pack plans (its K1 walks the CSR itself), so `query_cost` is
that fallback: `fragment_bytes` x rounds, the JAX package's answer on a
fresh fragment.  The wall-clock price `query_wall_s` is one K1 pull over
the fragment's in-CSR a round (`calibration.k1_columns`, the columns the
rate sweep and the live harvest count) through the active rate profile's
wall model, times the rounds.  Every shed and defer record carries the
profile's label.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from libgrape_lite_tpu_torch.autopilot.signals import (
    AUTOPILOT_STATS,
    record_decision,
)

#: rounds priced for an unbounded request (max_rounds None)
DEFAULT_PRICED_ROUNDS = 16


def query_cost(fragment, max_rounds: Optional[int] = None) -> float:
    """One point query's priced cost on `fragment`, in device bytes: the
    fragment's CSR bytes (`fragment_bytes`) a round, times the round
    limit."""
    from libgrape_lite_tpu_torch.fleet.budget import fragment_bytes

    rounds = int(max_rounds) if max_rounds else DEFAULT_PRICED_ROUNDS
    AUTOPILOT_STATS["priced"] += 1
    return float(fragment_bytes(fragment)) * rounds


def query_wall_s(fragment, max_rounds: Optional[int] = None,
                 profile=None, weighted: Optional[bool] = None) -> float:
    """One point query's modelled wall seconds on `fragment` under
    `profile` (default: the active RateProfile): one K1 pull over its
    in-CSR a round (with its edge weights when `weighted` is None and it
    carries them), priced by `profile.wall_s`, times the round limit.
    0.0 for a fragment without a stacked in-CSR (the vertex cut)."""
    from libgrape_lite_tpu_torch.ops.calibration import (
        active_profile,
        k1_columns,
    )

    cols = k1_columns(fragment, weighted=weighted)
    if cols is None:
        return 0.0
    p = profile or active_profile()
    rounds = int(max_rounds) if max_rounds else DEFAULT_PRICED_ROUNDS
    return p.wall_s(cols) * rounds


@dataclass(frozen=True)
class AdmissionConfig:
    """Thresholds of the shed / defer policy."""

    # burn >= 1.0: the error budget is spent; deferral starts there
    defer_burn: float = 1.0
    # a tenant burning at twice its budget gets no device time
    shed_burn: float = 2.0
    # an over-budget tenant's request pricier than this (device bytes)
    # sheds instead of deferring; in-budget tenants are never cost-gated
    max_cost: Optional[float] = None
    # the same in modelled wall seconds (`query_wall_s`)
    max_cost_s: Optional[float] = None

    def __post_init__(self):
        if self.defer_burn <= 0:
            raise ValueError(
                f"defer_burn must be > 0, got {self.defer_burn}")
        if self.shed_burn < self.defer_burn:
            raise ValueError(
                f"shed_burn ({self.shed_burn}) must be >= defer_burn "
                f"({self.defer_burn})")


def decide_admission(burn: float, cost: float, cfg: AdmissionConfig,
                     cost_s: float = 0.0) -> str:
    """'admit' | 'defer' | 'shed' for one request of a tenant burning
    `burn`, priced `cost` bytes and `cost_s` seconds (0.0: unpriced)."""
    if burn < cfg.defer_burn:
        return "admit"
    if burn >= cfg.shed_burn:
        return "shed"
    if cfg.max_cost is not None and cost > cfg.max_cost:
        return "shed"
    if cfg.max_cost_s is not None and cost_s > cfg.max_cost_s:
        return "shed"
    return "defer"


class AdmissionController:
    """The queue's hook: `review(req)` prices one pending request, reads
    its tenant's burn from the SLO surface and returns the verdict.
    Wire it with `ServeSession.attach_admission`.  `cost_of` defaults to
    `query_cost` over `fragment`; a callable serves decide tables in
    tests."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 fragment=None, cost_of: Optional[Callable] = None):
        self.config = config or AdmissionConfig()
        self._fragment = fragment
        self._cost_of = cost_of

    def burn_of(self, tenant: Optional[str]) -> float:
        """The current burn of one tenant's objective key (0.0 without
        one)."""
        from libgrape_lite_tpu_torch.obs.slo import SLO_STATS

        if tenant is None:
            return 0.0
        burn = SLO_STATS.get("burn_by_key") or {}
        return float(burn.get(f"tenant:{tenant}", 0.0))

    def cost_of(self, req) -> float:
        if self._cost_of is not None:
            return float(self._cost_of(req))
        if self._fragment is None:
            return 0.0
        return query_cost(self._fragment, req.max_rounds)

    def wall_of(self, req) -> float:
        if self._cost_of is not None or self._fragment is None:
            return 0.0
        return query_wall_s(self._fragment, req.max_rounds)

    def review(self, req) -> str:
        """'admit' | 'defer' | 'shed' for one queued request; sheds and
        defers are recorded.  Never raises: a failure admits."""
        try:
            burn = self.burn_of(req.tenant)
            cost = self.cost_of(req)
            cost_s = self.wall_of(req)
            verdict = decide_admission(burn, cost, self.config,
                                       cost_s=cost_s)
        except Exception:
            return "admit"
        if verdict != "admit":
            from libgrape_lite_tpu_torch.ops.calibration import profile_label

            record_decision(verdict, tenant=req.tenant or "",
                            app=req.app_key, burn=round(burn, 4),
                            cost=round(cost, 1), cost_s=round(cost_s, 6),
                            profile=profile_label())
        return verdict
