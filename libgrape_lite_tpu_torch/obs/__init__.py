"""obs/ -- the stats federation and the SLO surface.

Counterpart of the two modules of `libgrape_lite_tpu/obs/` that the
autopilot reads: `federation` (one namespace-keyed snapshot of every
``*_STATS`` surface) and `slo` (latency objectives and error-budget
burn).  The tracer, metrics, exporters and flight recorder of the JAX
package's `obs/` are ROADMAP Queue A item 6a.
"""

from libgrape_lite_tpu_torch.obs import federation, slo
from libgrape_lite_tpu_torch.obs.federation import FederatedStats
from libgrape_lite_tpu_torch.obs.slo import SLO_STATS

__all__ = ["FederatedStats", "SLO_STATS", "federation", "slo"]
