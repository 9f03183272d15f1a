"""The analytical-app library (reference `examples/analytical_apps`).

The registry uses the JAX package's names
(`libgrape_lite_tpu/models/__init__.py`) for the six LDBC Graphalytics
apps and their variants.  Base apps: PageRank (LDBC global variant),
SSSP and BFS (dense pulls), WCC, CDLP, and LCC in three forms -- `lcc` is
the merge-intersection LCCBeta, `lcc_opt` / `lcc_bitmap` the bitmap LCC
on the row AND-popcount kernel, `lcc_directed` the directed coefficient.
Variants with their own round or message structure have their own
classes: the message-path apps `sssp_msg` / `bfs_msg`, the bucketed
`sssp_opt` / `sssp_delta`, the direction-optimizing `bfs_opt`, the
SyncBuffer push apps `*_auto` (with `pagerank_push`,
`pagerank_push_opt`), the pointer-jumping `wcc_opt` and `cdlp_opt*`'s
first-round shortcut.  `sssp_select` names SSSP here; `run_app` probes
the graph and runs `sssp` or `sssp_delta` (models/sssp_select.py).  The
other names alias their base apps, as in the JAX registry.

Beyond the LDBC six: the peeling apps `kcore` and `core_decomposition`,
single-source betweenness `bc` (`staged_bc` and `staged_bc_bfs` name the
same app, as in the JAX registry), the unnormalised `pagerank_local`
(with `pagerank_local_parallel`), the hop-bounded BFS `khop`, the 2-hop
`common_neighbors` query, `triangle_count` (the bitmap LCC's credits)
and `kclique` (dispatching to the device clique apps or a host
recursion).  The vertex-cut names run on an ImmutableVertexcutFragment
(fragment/vertexcut.py): `sssp_vc`, `bfs_vc`, `wcc_vc` (models/vc2d.py)
and `pagerank_vc`, `pagerank_vc_rep` (models/pagerank_vc.py).
"""

from libgrape_lite_tpu_torch.models.auto_apps import (
    BFSAuto,
    PageRankAuto,
    SSSPAuto,
    WCCAuto,
)
from libgrape_lite_tpu_torch.models.bc import BC
from libgrape_lite_tpu_torch.models.bfs import BFS
from libgrape_lite_tpu_torch.models.bfs_opt import BFSOpt
from libgrape_lite_tpu_torch.models.cdlp import CDLP, CDLPOpt
from libgrape_lite_tpu_torch.models.core_decomposition import (
    CoreDecomposition,
)
from libgrape_lite_tpu_torch.models.kclique import KClique
from libgrape_lite_tpu_torch.models.kcore import KCore
from libgrape_lite_tpu_torch.models.khop import KHopNeighborhood
from libgrape_lite_tpu_torch.models.lcc import LCC
from libgrape_lite_tpu_torch.models.lcc_beta import LCCBeta
from libgrape_lite_tpu_torch.models.lcc_directed import LCCDirected
from libgrape_lite_tpu_torch.models.pagerank import PageRank
from libgrape_lite_tpu_torch.models.pagerank_local import PageRankLocal
from libgrape_lite_tpu_torch.models.pagerank_vc import (
    PageRankVC,
    PageRankVCReplicated,
)
from libgrape_lite_tpu_torch.models.sssp import SSSP
from libgrape_lite_tpu_torch.models.sssp_delta import SSSPDelta
from libgrape_lite_tpu_torch.models.sssp_msg import BFSMsg, SSSPMsg
from libgrape_lite_tpu_torch.models.vc2d import BFSVC2D, SSSPVC2D, WCCVC2D
from libgrape_lite_tpu_torch.models.triangle_count import (
    CommonNeighbors,
    TriangleCount,
)
from libgrape_lite_tpu_torch.models.wcc import WCC
from libgrape_lite_tpu_torch.models.wcc_opt import WCCOpt

APP_REGISTRY = {
    "sssp": SSSP,
    "sssp_select": SSSP,
    "sssp_auto": SSSPAuto,
    "sssp_opt": SSSPDelta,
    "sssp_delta": SSSPDelta,
    "sssp_msg": SSSPMsg,
    "bfs": BFS,
    "bfs_auto": BFSAuto,
    "bfs_opt": BFSOpt,
    "bfs_msg": BFSMsg,
    "wcc": WCC,
    "wcc_auto": WCCAuto,
    "wcc_opt": WCCOpt,
    "pagerank": PageRank,
    "pagerank_auto": PageRankAuto,
    "pagerank_parallel": PageRank,
    "pagerank_opt": PageRank,
    "pagerank_push": PageRankAuto,
    "pagerank_push_opt": PageRankAuto,
    "pagerank_directed": PageRank,
    "cdlp": CDLP,
    "cdlp_auto": CDLP,
    "cdlp_opt": CDLPOpt,
    "cdlp_opt_ud": CDLPOpt,
    "cdlp_opt_ud_dense": CDLPOpt,
    "lcc": LCCBeta,
    "lcc_auto": LCCBeta,
    "lcc_beta": LCCBeta,
    "lcc_opt": LCC,
    "lcc_bitmap": LCC,
    "lcc_directed": LCCDirected,
    "bc": BC,
    "staged_bc": BC,
    "staged_bc_bfs": BC,
    "kcore": KCore,
    "kclique": KClique,
    "core_decomposition": CoreDecomposition,
    "pagerank_local": PageRankLocal,
    "pagerank_local_parallel": PageRankLocal,
    "triangle_count": TriangleCount,
    "common_neighbors": CommonNeighbors,
    "khop": KHopNeighborhood,
    "pagerank_vc": PageRankVC,
    "pagerank_vc_rep": PageRankVCReplicated,
    "sssp_vc": SSSPVC2D,
    "bfs_vc": BFSVC2D,
    "wcc_vc": WCCVC2D,
}

__all__ = ["APP_REGISTRY", "BC", "BFS", "BFSAuto", "BFSMsg", "BFSOpt",
           "BFSVC2D", "CDLP", "CDLPOpt", "CommonNeighbors",
           "CoreDecomposition", "KClique", "KCore", "KHopNeighborhood",
           "LCC", "LCCBeta", "LCCDirected", "PageRank", "PageRankAuto",
           "PageRankLocal", "PageRankVC", "PageRankVCReplicated", "SSSP",
           "SSSPAuto", "SSSPDelta", "SSSPMsg", "SSSPVC2D", "TriangleCount",
           "WCC", "WCCAuto", "WCCOpt", "WCCVC2D"]
