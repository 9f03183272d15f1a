"""Guard configuration: breach policy, probe cadence, watchdog knobs.

Counterpart of `libgrape_lite_tpu/guard/config.py`.  Armed by env (so
drills can guard any process without code changes) or explicitly via
`Worker.query(guard=GuardConfig(...))` / `guard="halt"`:

    GRAPE_GUARD=off|warn|halt|rollback   breach policy (default off)
    GRAPE_GUARD_EVERY=K                  probe cadence in supersteps
                                         (probe every Kth round;
                                         default 1)
    GRAPE_GUARD_STAGNATION=K             residual-stagnation window
                                         (default 256; 0 disables the
                                         heuristic, cycle detection
                                         stays on)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

GUARD_ENV = "GRAPE_GUARD"
GUARD_EVERY_ENV = "GRAPE_GUARD_EVERY"
GUARD_STAGNATION_ENV = "GRAPE_GUARD_STAGNATION"

POLICIES = ("off", "warn", "halt", "rollback")


@dataclass(frozen=True)
class GuardConfig:
    """Resolved guard settings for one query."""

    policy: str = "off"
    # probe cadence in supersteps: the loop probes every `every` rounds
    every: int = 1
    # halt when the best residual has not improved for this many probes
    # (heuristic -- a long-diameter BFS/SSSP legitimately plateaus, so
    # the default window is generous; 0 disables)
    stagnation_window: int = 256
    # rollback budget: a breach that keeps recurring past this many
    # restores is deterministic and halts with the diagnostic bundle
    max_rollbacks: int = 2

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown guard policy {self.policy!r} "
                f"(expected one of {POLICIES})"
            )
        if self.every < 1:
            raise ValueError(f"guard cadence must be >= 1, got {self.every}")
        if self.stagnation_window < 0:
            raise ValueError(
                f"stagnation window must be >= 0, got {self.stagnation_window}"
            )
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    @classmethod
    def resolve(cls, guard=None) -> "GuardConfig":
        """`GuardConfig` | policy string | None (env) -> GuardConfig.
        The env knobs fill whatever a bare policy string leaves open."""
        if isinstance(guard, GuardConfig):
            return guard
        if guard is None:
            policy = os.environ.get(GUARD_ENV, "") or "off"
        else:
            policy = str(guard) or "off"
        return cls(
            policy=policy,
            every=int(os.environ.get(GUARD_EVERY_ENV, "") or 1),
            stagnation_window=int(
                os.environ.get(GUARD_STAGNATION_ENV, "") or 256
            ),
        )
