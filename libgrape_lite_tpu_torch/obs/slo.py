"""Per-app and per-tenant latency SLOs with error-budget burn.

Counterpart of `libgrape_lite_tpu/obs/slo.py`.  Objectives are latency
targets in milliseconds, from ``GRAPE_SLO`` or the serve CLI's ``--slo``:

    GRAPE_SLO="sssp=5,bfs=10,tenant:t0=50,*=100"

A key resolves most specific first: ``tenant:<name>``, then the app,
then ``*``.  A query breaches when it failed or took longer than its
objective.  A breach is a counter, never an exception: the serving loop
does not change because an objective exists.

With an allowed breach fraction ``f`` (``GRAPE_SLO_BUDGET``, default 1%),
a key's burn is ``breaches / (observed * f)``: 1.0 spends the budget as
fast as it accrues.  `SLO_STATS` is the federated ``slo`` namespace.
`observe` is called where the queue delivers a result and where it fails
one undispatched (deadline expiry, shedding); with no objective
configured it is one falsy-dict check.  Each breach is also a
`slo_breach` trace instant and a `grape_slo_breaches_total` count when
obs/ is armed.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from libgrape_lite_tpu_torch.obs.federation import FederatedStats

SLO_ENV = "GRAPE_SLO"
SLO_BUDGET_ENV = "GRAPE_SLO_BUDGET"
DEFAULT_BUDGET_FRAC = 0.01

#: objective key -> latency objective (ms); empty when unconfigured
_OBJECTIVES: Dict[str, float] = {}
_BUDGET_FRAC = DEFAULT_BUDGET_FRAC

SLO_STATS = FederatedStats("slo", {
    "observed": 0,
    "breaches": 0,
    "budget_frac": DEFAULT_BUDGET_FRAC,
    "observed_by_key": {},
    "breaches_by_key": {},
    "burn_by_key": {},
    "objectives_ms": {},
    "max_burn": 0.0,
})


def parse_spec(spec: str) -> Dict[str, float]:
    """``"sssp=5,tenant:t0=50,*=100"`` -> {key: objective_ms}; a bad
    entry raises ValueError."""
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad SLO entry (want key=ms): {part!r}")
        key, _, ms = part.partition("=")
        key = key.strip()
        try:
            val = float(ms)
        except ValueError:
            raise ValueError(f"bad SLO objective (want ms): {part!r}")
        if not key or val <= 0:
            raise ValueError(f"bad SLO entry: {part!r}")
        out[key] = val
    return out


def configure(spec: Optional[str] = None,
              budget_frac: Optional[float] = None) -> None:
    """Install objectives (None or "" clears) and reset SLO_STATS, so
    burn counts against the new objectives only."""
    global _BUDGET_FRAC
    _OBJECTIVES.clear()
    if spec:
        _OBJECTIVES.update(parse_spec(spec))
    if budget_frac is not None:
        if not (0 < budget_frac <= 1):
            raise ValueError(
                f"SLO budget fraction out of (0, 1]: {budget_frac}")
        _BUDGET_FRAC = budget_frac
    SLO_STATS.reset()
    SLO_STATS["budget_frac"] = _BUDGET_FRAC
    SLO_STATS["objectives_ms"] = dict(_OBJECTIVES)


def maybe_configure_from_env() -> bool:
    """Configure from GRAPE_SLO / GRAPE_SLO_BUDGET when set."""
    spec = os.environ.get(SLO_ENV)
    if not spec:
        return False
    frac = None
    raw = os.environ.get(SLO_BUDGET_ENV)
    if raw:
        try:
            frac = float(raw)
        except ValueError:
            frac = None
    configure(spec, budget_frac=frac)
    return True


def configured() -> bool:
    return bool(_OBJECTIVES)


def objective_for(app: str,
                  tenant: Optional[str] = None) -> Optional[tuple]:
    """(key, objective_ms) of the most specific matching objective, or
    None: tenant:<t>, then the app, then '*'."""
    if tenant is not None:
        key = f"tenant:{tenant}"
        ms = _OBJECTIVES.get(key)
        if ms is not None:
            return key, ms
    ms = _OBJECTIVES.get(app)
    if ms is not None:
        return app, ms
    ms = _OBJECTIVES.get("*")
    if ms is not None:
        return "*", ms
    return None


def observe(app: str, tenant: Optional[str], latency_s: float,
            ok: bool = True) -> None:
    """Count one finished query against its objective.  Never raises."""
    if not _OBJECTIVES:
        return
    hit = objective_for(app, tenant)
    if hit is None:
        return
    key, objective_ms = hit
    SLO_STATS["observed"] += 1
    by_obs = SLO_STATS["observed_by_key"]
    by_obs[key] = by_obs.get(key, 0) + 1
    latency_ms = latency_s * 1e3
    breached = (not ok) or latency_ms > objective_ms
    if breached:
        SLO_STATS["breaches"] += 1
        by_br = SLO_STATS["breaches_by_key"]
        by_br[key] = by_br.get(key, 0) + 1
    burn = round(SLO_STATS["breaches_by_key"].get(key, 0)
                 / (by_obs[key] * _BUDGET_FRAC), 4)
    SLO_STATS["burn_by_key"][key] = burn
    if burn > SLO_STATS["max_burn"]:
        SLO_STATS["max_burn"] = burn
    if breached:
        from libgrape_lite_tpu_torch import obs

        obs.tracer().instant(
            "slo_breach", key=key, app=app,
            tenant=tenant if tenant is not None else "",
            latency_ms=round(latency_ms, 3), objective_ms=objective_ms,
            ok=ok, burn=burn)
        obs.metrics().counter(
            "grape_slo_breaches_total",
            "queries past their SLO objective (or failed)").inc()


maybe_configure_from_env()
