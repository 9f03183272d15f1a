"""Repack policy: when accumulated deltas fold into a rebuilt CSR.

Counterpart of `libgrape_lite_tpu/dyn/repack.py`.  Below the threshold,
staged additions ride the overlay side-path (dyn/ingest.py) and each
query round pays one extra gather-reduce over a few thousand slots.
Past the threshold the rebuild wins (SparseP's delta-ratio analysis,
arxiv 2201.05072), and the buffer folds into the base arrays through
`BasicFragmentMutator.mutate`: the retained host edge list is edited and
the padded CSRs are rebuilt on the fragment's device.

Non-additive ops (removals, weight updates, vertex changes) force a
repack whatever the ratio: a min fold cannot take a candidate back, so
the overlay cannot represent them.

Env knobs (read by `RepackPolicy.from_env`):
  GRAPE_DYN_REPACK_RATIO   delta-ratio threshold (default 0.05)
  GRAPE_DYN_CAP            delta buffer / overlay capacity (default 4096)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from libgrape_lite_tpu_torch.dyn.delta import DeltaBuffer

REPACK_RATIO_ENV = "GRAPE_DYN_REPACK_RATIO"
CAPACITY_ENV = "GRAPE_DYN_CAP"

DEFAULT_REPACK_RATIO = 0.05
DEFAULT_CAPACITY = 4096


@dataclass(frozen=True)
class RepackPolicy:
    """The fold-versus-accumulate trade-off in one place."""

    # staged edge ops / base real edges above which apply() folds the
    # buffer into a rebuilt CSR; 0 repacks on every apply, >= 1 never
    # by ratio (the bounded buffer still folds at capacity)
    threshold: float = DEFAULT_REPACK_RATIO
    # delta buffer bound == overlay slot capacity per fragment
    capacity: int = DEFAULT_CAPACITY

    def __post_init__(self):
        if self.threshold < 0:
            raise ValueError(
                f"threshold must be >= 0, got {self.threshold}"
            )
        if self.capacity < 1:
            raise ValueError(
                f"capacity must be >= 1, got {self.capacity}"
            )

    @classmethod
    def from_env(cls) -> "RepackPolicy":
        return cls(
            threshold=float(
                os.environ.get(REPACK_RATIO_ENV, DEFAULT_REPACK_RATIO)
            ),
            capacity=int(os.environ.get(CAPACITY_ENV, DEFAULT_CAPACITY)),
        )

    def should_repack(self, buffer: DeltaBuffer, fragment) -> bool:
        """Ratio trigger only; the structural triggers (non-additive
        ops, unknown endpoints, slot overflow) are DynGraph.apply's,
        which sees the overlay build's outcome."""
        return (
            buffer.delta_ratio(fragment.total_edges_num) > self.threshold
        )


def repack_fragment(fragment, buffer: DeltaBuffer):
    """Fold the staged buffer into a rebuilt fragment: host edge-list
    edit, partition, padded CSR build on the fragment's device,
    validated under GRAPE_VALIDATE_LOAD=1 like every load path."""
    if fragment.edge_list is None:
        raise ValueError(
            "repack needs the retained host edge list; build the base "
            "fragment with retain_edge_list=True (LoadGraphSpec"
            "(retain_edge_list=True) or LoadGraphAndMutate)"
        )
    return buffer.to_mutator(directed=fragment.directed).mutate(fragment)
