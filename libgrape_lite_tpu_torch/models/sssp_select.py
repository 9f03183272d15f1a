"""Evidence-based SSSP variant selection (`sssp_select`).

Counterpart of `libgrape_lite_tpu/models/sssp_select.py`.  The
reference's CUDA SSSP picks its work discipline from the graph: the
near/far bucketing (`examples/analytical_apps/cuda/sssp/sssp.h:50-100`)
exists because on high-diameter graphs a plain Bellman-Ford sweep pays
O(E) a round for thousands of rounds, while on low-diameter power-law
graphs the sweep converges in tens of rounds.  The dense pull's round
count is bounded by the hop diameter from the source (times the weight
stretch), so the probe measures exactly that: one host BFS over the
host out-CSRs, capped at `cap` levels, O(E) in all.

  * converges within `cap` levels -> "sssp" (the dense pull)
  * frontier still alive at `cap` -> "sssp_delta" (near/far buckets)

`GRAPE_SSSP_PROBE_CAP` overrides the cap (default 64).

This is the JAX package's policy, kept as it is.  On one H100 it has not
paid off on either graph measured (PERF.md section 6): on RMAT-20 the
probe takes far longer than the `sssp` query it picks, and on a
512 x 512 grid the `sssp_delta` it picks is slower than `sssp`.  So on
the card `sssp_select` is never faster than `sssp`; re-deciding the
policy for the GPU is a ROADMAP item.
"""

from __future__ import annotations

import os

import numpy as np

from libgrape_lite_tpu_torch.app.base import resolve_source


def host_bfs_levels(frag, src_pid: int, cap: int = 64):
    """Hop levels from `src_pid` over the host out-CSRs, capped.

    Returns (levels, converged): `levels` is the last level at which the
    frontier was non-empty; `converged` False means the cap was reached
    with a live frontier.  Each vertex enters the frontier at most once
    and only frontier adjacency is read."""
    fnum, vp = frag.fnum, frag.vp
    degs, adjs = [], []
    for f in range(fnum):
        c = frag.host_oe[f]
        n_real = int(c.indptr[c.num_rows])
        degs.append(np.diff(c.indptr[: c.num_rows + 1]).astype(np.int64))
        adjs.append(c.edge_nbr[:n_real])  # int32 pids index as they are
    deg = np.concatenate(degs)
    indptr = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    adj = np.concatenate(adjs) if adjs else np.zeros(0, np.int32)

    visited = np.zeros(fnum * vp, dtype=bool)
    frontier = np.asarray([src_pid], dtype=np.int64)
    visited[src_pid] = True
    levels = 0
    for level in range(1, cap + 1):
        d = deg[frontier]
        total = int(d.sum())
        if total == 0:
            return levels, True
        starts = indptr[frontier]
        # absolute edge indices of every frontier vertex's adjacency
        base = np.repeat(starts - np.concatenate(([0], np.cumsum(d[:-1]))), d)
        nxt = adj[np.arange(total, dtype=np.int64) + base]
        nxt = nxt[~visited[nxt]]
        if nxt.size == 0:
            return levels, True
        nxt = np.unique(nxt)
        visited[nxt] = True
        frontier = nxt
        levels = level
    return levels, False


def select_sssp_variant(frag, source) -> tuple[str, str]:
    """Pick the SSSP app for this (graph, source): (registry name,
    reason)."""
    cap = int(os.environ.get("GRAPE_SSSP_PROBE_CAP", "64"))
    pid = resolve_source(frag, source, "SSSP")
    if pid < 0:
        return "sssp", "source not in graph; trivial query"
    levels, converged = host_bfs_levels(frag, int(pid), cap)
    if converged:
        return "sssp", (
            f"BFS probe: {levels} hop levels (< cap {cap}) -> dense "
            "fused pull (low-diameter regime, FRONTIER_NOTES)"
        )
    return "sssp_delta", (
        f"BFS probe: frontier alive after {cap} levels -> delta-stepping "
        "(high-diameter regime; near-far analogue, cuda/sssp.h:50-100)"
    )
