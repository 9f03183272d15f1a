"""The analytical-app library (reference `examples/analytical_apps`).

The registry uses the JAX package's names for the six LDBC Graphalytics
apps (`libgrape_lite_tpu/models/__init__.py`): PageRank (LDBC global
variant), SSSP and BFS (dense pulls), WCC, CDLP, and LCC in three forms
-- `lcc` is the merge-intersection LCCBeta, `lcc_opt` / `lcc_bitmap` the
bitmap LCC on the row AND-popcount kernel, `lcc_directed` the directed
coefficient.  `cdlp_auto` and `lcc_auto` alias their base apps, as in
the JAX registry.
"""

from libgrape_lite_tpu_torch.models.bfs import BFS
from libgrape_lite_tpu_torch.models.cdlp import CDLP
from libgrape_lite_tpu_torch.models.lcc import LCC
from libgrape_lite_tpu_torch.models.lcc_beta import LCCBeta
from libgrape_lite_tpu_torch.models.lcc_directed import LCCDirected
from libgrape_lite_tpu_torch.models.pagerank import PageRank
from libgrape_lite_tpu_torch.models.sssp import SSSP
from libgrape_lite_tpu_torch.models.wcc import WCC

APP_REGISTRY = {
    "pagerank": PageRank,
    "sssp": SSSP,
    "bfs": BFS,
    "wcc": WCC,
    "cdlp": CDLP,
    "cdlp_auto": CDLP,
    "lcc": LCCBeta,
    "lcc_auto": LCCBeta,
    "lcc_beta": LCCBeta,
    "lcc_opt": LCC,
    "lcc_bitmap": LCC,
    "lcc_directed": LCCDirected,
}

__all__ = ["APP_REGISTRY", "BFS", "CDLP", "LCC", "LCCBeta", "LCCDirected",
           "PageRank", "SSSP", "WCC"]
