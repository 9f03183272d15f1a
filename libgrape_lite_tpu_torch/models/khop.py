"""K-hop neighbourhood: BFS levels with the round budget as the hop bound.

Counterpart of `libgrape_lite_tpu/models/khop.py`: after k IncEval rounds
of BFS's pull (the gather-reduce kernel, int32 kind `min`) the depth
plane holds exactly the ball of radius k around the source.  The result
is the hop distance inside the ball and -1 outside it.  BFS's source
lanes carry over: k sources run as one batch of lanes.
"""

from __future__ import annotations

import numpy as np

from libgrape_lite_tpu_torch.models.bfs import _SENTINEL, BFS


class KHopNeighborhood(BFS):
    result_format = "int"
    # the hop cap makes the previous fixed point unusable, so an
    # incremental query runs cold (the overlay fold is inherited: min is
    # exact at any round budget)
    inc_mode = None
    inc_seed_keys: dict = {}

    def __init__(self, k: int = 2):
        k = int(k)
        if k < 1:
            raise ValueError(f"khop needs k >= 1, got {k}")
        self.k = k
        # round r relaxes depths to r, so k rounds give the <= k-hop ball
        self.max_rounds = k

    def finalize(self, frag, state):
        d = state["depth"].numpy().astype(np.int64)
        return np.where((d == _SENTINEL) | (d > self.k), -1, d)
