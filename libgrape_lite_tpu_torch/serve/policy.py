"""Admission and coalescing policy of the serving runtime.

Counterpart of `libgrape_lite_tpu/serve/policy.py`.  A session
multiplexes many point queries over one resident graph; this module is
the one place the batching trade-off lives: how many compatible queries
may share one batched query (`max_batch`), and how long the head of the
queue may wait for batchmates before a partial batch ships
(`max_wait_s`).

Compatibility is structural: two requests coalesce only when they would
run the same batched loop -- the same app, the same `max_rounds`, the
same guard policy and identical non-lane query arguments.  The per-lane
argument (`batch_query_key`, e.g. the SSSP / BFS source) is the only one
that varies inside a batch.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BatchPolicy:
    """Knobs of the admission queue (serve/queue.py)."""

    # lanes per batched query; 1 disables batching (every query runs
    # the plain Worker.query)
    max_batch: int = 8
    # seconds the queue head may wait for batchmates; 0 ships whatever
    # has coalesced when the pump runs
    max_wait_s: float = 0.0
    # the async pump's window (serve/pipeline.py): how many coalesced
    # batches may be admitted and not yet harvested at once.  1 is the
    # synchronous discipline; only a pump reads it
    inflight: int = 1

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.inflight < 1:
            raise ValueError(
                f"inflight must be >= 1, got {self.inflight}")


def compat_key(app_key: str, args: dict, max_rounds, guard,
               batch_key: str | None, mesh_kind: str = "frag"):
    """Hashable coalescing key: requests with equal keys may share one
    batched query.  `batch_key` (the app's per-lane argument) is left
    out -- it is what varies across lanes; everything else must match.
    Whether the lane argument is present at all is structural: a
    personalized PageRank lane (source given) and a global one (none)
    build different states."""
    fixed = tuple(sorted(
        (k, v) for k, v in args.items() if k != batch_key))
    policy = getattr(guard, "policy", guard) or ""
    has_lane_arg = (
        batch_key is not None and args.get(batch_key) is not None)
    return (app_key, max_rounds, str(policy), fixed, has_lane_arg,
            mesh_kind)
