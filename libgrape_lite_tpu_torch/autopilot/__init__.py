"""autopilot/ -- the serving fleet's control loop.

Counterpart of `libgrape_lite_tpu/autopilot/`: observe, decide, act over
the fleet (fleet/):

  * `signals`: SignalReader / ControlSignals, one typed read of burn,
    queue depth and waits, and replica load, with the hysteresis window;
    the federated AUTOPILOT_STATS.
  * `scaler`: Autoscaler, a pure `decide` over the window and an `act`
    through drain, rejoin and replicate under the device budget.
  * `admission`: AdmissionController, priced per-query admission that
    sheds or defers tenants past their error budget.
  * `cache`: ResultCache, a fence-epoch result cache for point queries.

The CLI surface is `python -m libgrape_lite_tpu_torch.cli serve
--autopilot [--min_replicas N --max_replicas M --cache_entries K]`.
"""

from libgrape_lite_tpu_torch.autopilot.admission import (
    AdmissionConfig,
    AdmissionController,
    decide_admission,
    query_cost,
)
from libgrape_lite_tpu_torch.autopilot.cache import (
    CACHE_KEY_FIELDS,
    ResultCache,
)
from libgrape_lite_tpu_torch.autopilot.scaler import (
    Autoscaler,
    Decision,
    ScalerConfig,
    decide,
)
from libgrape_lite_tpu_torch.autopilot.signals import (
    AUTOPILOT_STATS,
    ControlSignals,
    SignalReader,
    record_decision,
)

__all__ = [
    "AUTOPILOT_STATS",
    "AdmissionConfig",
    "AdmissionController",
    "Autoscaler",
    "CACHE_KEY_FIELDS",
    "ControlSignals",
    "Decision",
    "ResultCache",
    "ScalerConfig",
    "SignalReader",
    "decide",
    "decide_admission",
    "query_cost",
    "record_decision",
]
