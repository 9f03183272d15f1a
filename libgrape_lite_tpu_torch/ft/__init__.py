"""Fault tolerance: superstep checkpoint/restore, fault injection, and
retry/backoff, for one process.

Counterpart of `libgrape_lite_tpu/ft/`.  A superstep boundary is a
consistent cut of the whole computation, so durable fault tolerance costs
one host snapshot of the query carry a cadence interval:

* `checkpoint` -- `CheckpointManager` writes checksummed snapshots of the
  carry, the round counter and the config fingerprint, the copy to the
  host overlapped with the next rounds; `restore_latest` walks them
  newest-first, rejecting fingerprint mismatches and skipping corrupt
  shards.  The on-disk format is the JAX package's: a lineage written by
  either resumes in the other.
* `fingerprint` -- the identity of a query (app, fragment content, mesh
  shape, query args, numeric config) a checkpoint must match.
* `faults` -- `FaultPlan`, armed by GRAPE_FT_FAULTS: kill at superstep k,
  corrupt a shard or the live carry, clamp the message capacity
  (`libgrape_lite_tpu_torch/scripts/fault_drill.py` drives it).
* `retry` -- `with_retries`, the shared exponential-backoff policy, around
  the garc cache read (fragment/loader.py).

The JAX package's multi-process layer (`ft/distributed.py`: sharded
checkpoints, `restore_resharded`) comes with the port's multi-GPU
runtime (ROADMAP Queue A item 8).
"""

from libgrape_lite_tpu_torch.ft.checkpoint import (
    CheckpointManager,
    CheckpointMismatchError,
    CorruptCheckpointError,
    restore_latest,
)
from libgrape_lite_tpu_torch.ft.faults import (
    FaultPlan,
    InjectedFault,
    active_plan,
)
from libgrape_lite_tpu_torch.ft.fingerprint import compute_fingerprint
from libgrape_lite_tpu_torch.ft.retry import (
    RetryableError,
    RetryPolicy,
    is_transient_distributed_error,
    is_transient_io_error,
    with_retries,
)

__all__ = [
    "CheckpointManager",
    "CheckpointMismatchError",
    "CorruptCheckpointError",
    "FaultPlan",
    "InjectedFault",
    "RetryPolicy",
    "RetryableError",
    "active_plan",
    "compute_fingerprint",
    "is_transient_distributed_error",
    "is_transient_io_error",
    "restore_latest",
    "with_retries",
]
