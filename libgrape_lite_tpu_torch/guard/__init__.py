"""guard/ -- runtime invariant monitors, a divergence watchdog, and
self-healing rollback-replay.

Counterpart of `libgrape_lite_tpu/guard/`.  Every query has a consistent
cut at each superstep boundary; `ft/` uses it for checkpoint/restore, and
`guard/` detects that a run has gone wrong and drives recovery:

* **Invariants** (`invariants.py`) -- app-declared predicates over
  consecutive carries (`AppBase.invariants`): distances monotonically
  non-increasing, PageRank mass conserved within eps, WCC labels
  non-increasing, float carries NaN-free, the active vote within
  `[0, vnum]`.
* **Divergence watchdog** (`watchdog.py`) -- a carry-digest history
  proves oscillation cycles and flags residual stagnation, halting with
  a diagnostic bundle instead of spinning to `max_rounds`.
* **Monitor and breach policies** (`monitor.py`) -- `warn | halt |
  rollback`; rollback restores the last good snapshot through
  `ft.checkpoint.restore_latest`, replays with a probe every round to
  localize a deterministic fault, and continues.

Guards are off by default and cost nothing then: the worker's loop
checks one flag.  On, `Worker.query` probes every round (GRAPE_GUARD_EVERY
thins the cadence), on the carry's device; a guarded batch
(`Worker.query_batch(guard=)`, serve/batch.py) probes all its lanes in
one read a chunk and isolates a breached lane.  The JAX package's cross-rank
breach vote (`vote.py`) comes with the port's multi-GPU runtime (ROADMAP
Queue A item 8).
"""

from libgrape_lite_tpu_torch.guard.config import (
    GUARD_ENV,
    GUARD_EVERY_ENV,
    GUARD_STAGNATION_ENV,
    GuardConfig,
)
from libgrape_lite_tpu_torch.guard.invariants import (
    Invariant,
    default_invariants,
    finite,
    in_range,
    monotone_non_increasing,
    no_nan,
)
from libgrape_lite_tpu_torch.guard.monitor import (
    DivergenceError,
    GuardError,
    GuardMonitor,
    InvariantBreachError,
)
from libgrape_lite_tpu_torch.guard.watchdog import (
    DivergenceWatchdog,
    carry_digest,
)

__all__ = [
    "GUARD_ENV",
    "GUARD_EVERY_ENV",
    "GUARD_STAGNATION_ENV",
    "GuardConfig",
    "Invariant",
    "default_invariants",
    "finite",
    "in_range",
    "monotone_non_increasing",
    "no_nan",
    "GuardError",
    "InvariantBreachError",
    "DivergenceError",
    "GuardMonitor",
    "DivergenceWatchdog",
    "carry_digest",
]
