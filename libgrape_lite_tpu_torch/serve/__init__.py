"""serve/ -- the multi-query serving runtime.

Counterpart of `libgrape_lite_tpu/serve/`.  A `ServeSession` pins one
loaded graph -- the fragment's device tensors, the per-fragment plans,
one resident Worker per app -- and serves many queries against it.  An
`AdmissionQueue` coalesces compatible point queries into batched
queries (`Worker.query_batch`: k SSSP / BFS / k-hop / common-neighbour /
personalized PageRank sources a batch, pulled together by one
`gather_reduce_lanes` call a round, each lane byte-identical to its own
query) under a `BatchPolicy` (max batch, max wait).  The async pump
(serve/pipeline.py) keeps up to `BatchPolicy.inflight` batches admitted
at once, each launched batch running in its own thread and CUDA stream,
harvested FIFO, with `ingest` as a window barrier.

The CLI surface is `python -m libgrape_lite_tpu_torch.cli serve ...`.
Guarded batches (`serve/batch.py`): with a guard policy armed a batch
probes every lane at each chunk boundary in one read, and a breached lane
fails alone with its diagnostic bundle.
"""

from libgrape_lite_tpu_torch.serve.feeder import ArrivalFeeder
from libgrape_lite_tpu_torch.serve.pipeline import PUMP_STATS, AsyncServePump
from libgrape_lite_tpu_torch.serve.policy import BatchPolicy, compat_key
from libgrape_lite_tpu_torch.serve.queue import (
    AdmissionQueue,
    QueryRequest,
    ServeResult,
)
from libgrape_lite_tpu_torch.serve.session import ServeSession

__all__ = [
    "AdmissionQueue",
    "ArrivalFeeder",
    "AsyncServePump",
    "BatchPolicy",
    "PUMP_STATS",
    "QueryRequest",
    "ServeResult",
    "ServeSession",
    "compat_key",
]
