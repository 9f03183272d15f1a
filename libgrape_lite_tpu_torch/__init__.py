"""libgrape-lite on PyTorch and CUDA: the port of `libgrape_lite_tpu`.

The package mirrors the JAX package's layer layout (load -> fragment ->
worker loop -> apps -> SpMV kernels) with PyTorch idiom: plain functions
on tensors, an explicit `device` on every entry point, and the stacked
`[fnum, ...]` fragment layout kept at every public function.  Fragments
(`fnum > 1`) are a leading dimension on one device.

Entry points (`LoadGraph`, `Worker`, `run_app`, the CLI) default to
`device="cuda"` and raise when CUDA is absent; the tests pass
`device="cpu"`.  The hot operations run in hand-written CUDA kernels
built with `nvcc` at first use: the per-row gather-reduce over a CSR
(`csrc/spmv.cu`; PageRank, SSSP, BFS, WCC) and the row AND-popcount of
packed bitmaps (`csrc/intersect.cu`; the bitmap LCCs).  Nothing here
imports JAX or the JAX package.
"""

from libgrape_lite_tpu_torch.fragment.edgecut import (
    ShardedEdgecutFragment,
    fragment_from_numpy,
)
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import (
    APP_REGISTRY,
    BFS,
    CDLP,
    LCC,
    WCC,
    LCCBeta,
    LCCDirected,
    PageRank,
    SSSP,
)
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import QueryArgs, run_app
from libgrape_lite_tpu_torch.worker.worker import Worker

__all__ = [
    "APP_REGISTRY",
    "BFS",
    "CDLP",
    "CommSpec",
    "LCC",
    "LCCBeta",
    "LCCDirected",
    "LoadGraph",
    "LoadGraphSpec",
    "PageRank",
    "QueryArgs",
    "SSSP",
    "ShardedEdgecutFragment",
    "WCC",
    "Worker",
    "fragment_from_numpy",
    "run_app",
]
