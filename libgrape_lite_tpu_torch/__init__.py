"""libgrape-lite on PyTorch and CUDA: the port of `libgrape_lite_tpu`.

The package mirrors the JAX package's layer layout (load -> fragment ->
worker loop -> apps -> SpMV kernels) with PyTorch idiom: plain functions
on tensors, an explicit `device` on every entry point, and the stacked
`[fnum, ...]` fragment layout kept at every public function.  Fragments
(`fnum > 1`) are a leading dimension on one device.

Entry points (`LoadGraph`, `Worker`, `run_app`, the CLI) default to
`device="cuda"` and raise when CUDA is absent; the tests pass
`device="cpu"`.  The hot operation, the per-row gather-reduce over the
in-edge CSR, runs in hand-written CUDA kernels (`csrc/spmv.cu`) built
with `nvcc` at first use.  Nothing here imports JAX or the JAX package.
"""

from libgrape_lite_tpu_torch.fragment.edgecut import (
    ShardedEdgecutFragment,
    fragment_from_numpy,
)
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import APP_REGISTRY, PageRank, SSSP
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import QueryArgs, run_app
from libgrape_lite_tpu_torch.worker.worker import Worker

__all__ = [
    "APP_REGISTRY",
    "CommSpec",
    "LoadGraph",
    "LoadGraphSpec",
    "PageRank",
    "QueryArgs",
    "SSSP",
    "ShardedEdgecutFragment",
    "Worker",
    "fragment_from_numpy",
    "run_app",
]
