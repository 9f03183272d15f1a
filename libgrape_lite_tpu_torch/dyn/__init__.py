"""dyn/ -- the dynamic-graph runtime.

Counterpart of `libgrape_lite_tpu/dyn/`: delta-edge buffers staged
against a built fragment, applied between queries either as an overlay
side-path (folded each round by the gather-reduce kernel) or as a
repack into rebuilt CSRs; incremental IncEval seeds a query from the
previous fixed point.
"""

from libgrape_lite_tpu_torch.dyn.delta import (
    DeltaBuffer,
    DeltaDivergenceError,
    DeltaOverflowError,
    DeltaSummary,
    parse_ops_file,
    parse_ops_line,
)
from libgrape_lite_tpu_torch.dyn.incremental import (
    incremental_plan,
    reseed_fold,
)
from libgrape_lite_tpu_torch.dyn.ingest import (
    DeltaOverlay,
    DynGraph,
    broadcast_ingest,
    overlay_state_entries,
)
from libgrape_lite_tpu_torch.dyn.repack import RepackPolicy, repack_fragment

__all__ = [
    "DeltaBuffer",
    "DeltaDivergenceError",
    "DeltaOverflowError",
    "DeltaSummary",
    "DeltaOverlay",
    "DynGraph",
    "RepackPolicy",
    "broadcast_ingest",
    "incremental_plan",
    "overlay_state_entries",
    "parse_ops_file",
    "parse_ops_line",
    "repack_fragment",
    "reseed_fold",
]
