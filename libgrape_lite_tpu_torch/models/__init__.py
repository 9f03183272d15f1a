"""The analytical-app library (reference `examples/analytical_apps`).

The registry uses the reference's app names; this slice ports PageRank
(LDBC global variant) and SSSP (dense pull).
"""

from libgrape_lite_tpu_torch.models.pagerank import PageRank
from libgrape_lite_tpu_torch.models.sssp import SSSP

APP_REGISTRY = {
    "pagerank": PageRank,
    "sssp": SSSP,
}

__all__ = ["APP_REGISTRY", "PageRank", "SSSP"]
