"""1-D edge cut or 2-D vertex cut: the partition planner and its records.

Counterpart of `libgrape_lite_tpu/fragment/partition.py`.
`GRAPE_PARTITION` picks the layout of a run:

  * unset / "" / "0" / "off" / "1d" -- the 1-D edge cut, untouched;
  * "2d" -- the 2-D vertex cut when the app and geometry allow it; an
    ineligible request declines with its reason recorded and runs 1-D;
  * "auto" -- 2-D only when the modeled round wins.

`PARTITION_STATS` records every decision and decline (and, under
"rebalance", what the loader's `--rebalance` did), federated as
"partition" as in the JAX package.

The cost model is the JAX package's formula, term for term: a round
costs its most loaded shard's (or tile's) padded edges times the ops an
edge takes over the compute rate, plus its exchange bytes over the link
rate.  The exchange bytes and the ops an edge takes come from
`parallel/mirror.py` and `parallel/pipeline.py`, the one copy of each
that the exchange and the pipeline read too.  Both rates come from the
active rate profile (`ops/calibration.py`).  Each layout's record holds
its terms in their own units (`padded_edge_ops`, `exchange_bytes`), the compute term in seconds
(`t_compute_s`) when the profile measured `ops_per_s`, and the round in
seconds (`t_round_s`) only when it measured the exchange rate too.
Seconds decide `auto` only then: a rate the profile did not measure
(listed in its `unfitted`, as every data-sheet rate is) decides nothing.
On one card no link is measured (`StepContext.gather_state` is a
reshape), so `auto` engages the 2-D layout only when it wins on both terms,
and otherwise declines, its reason naming the unfitted exchange rate.
"""

from __future__ import annotations

import os

import numpy as np

from libgrape_lite_tpu_torch.fragment.edgecut import _next_pow2, _round_up
from libgrape_lite_tpu_torch.obs.federation import FederatedStats
from libgrape_lite_tpu_torch.ops.calibration import RateProfile, active_profile
from libgrape_lite_tpu_torch.parallel.mirror import (
    exchange_bytes_ledger,
    vc2d_exchange_bytes,
)
from libgrape_lite_tpu_torch.parallel.pipeline import DEFAULT_OPS_PER_EDGE

# 1-D app name -> its registered 2-D twin; min folds are bit-equal to
# the 1-D pull, PageRankVC's sum fold agrees within float eps
VC2D_APPS = {
    "sssp": "sssp_vc",
    "bfs": "bfs_vc",
    "wcc": "wcc_vc",
    "pagerank": "pagerank_vc",
}

PARTITION_STATS = FederatedStats("partition", {
    "resolved_2d": 0,     # decisions that engaged the 2-D path
    "declined": 0,        # 2d / auto requested, ineligible or priced out
    "last_decision": None,
})


def partition_mode() -> str:
    """1d | 2d | auto from GRAPE_PARTITION (default 1d).  An unknown
    value runs 1d, with a log line."""
    v = (os.environ.get("GRAPE_PARTITION", "") or "1d").strip().lower()
    if v in ("", "0", "off", "1d"):
        return "1d"
    if v == "2d":
        return "2d"
    if v in ("auto", "1"):
        return "auto"
    from libgrape_lite_tpu_torch.utils import logging as glog

    glog.log_info(f"GRAPE_PARTITION={v!r} is not one of 1d|2d|auto; using 1d")
    return "1d"


def _timed(term: dict, ope: float, profile: RateProfile, mode: str) -> dict:
    """Seconds of a layout's terms, each only under a measured rate."""
    if profile.measured("ops_per_s"):
        term["t_compute_s"] = term["padded_edges"] * ope / profile.ops_per_s
        if profile.measured("exchange_bps"):
            term["t_round_s"] = (term["t_compute_s"] + term["exchange_bytes"]
                                 / profile.exchange_bps[mode])
    return term


def modeled_costs(src: np.ndarray, dst: np.ndarray, n_vertices: int,
                  fnum: int, *, directed: bool = False, itemsize: int = 4,
                  ops_per_edge: float | None = None,
                  profile: RateProfile | None = None) -> dict:
    """One pull round priced under both layouts.  `src` / `dst` are the
    raw oid edge list (symmetrised here when undirected); shards and
    tiles follow the map partitioner's and VCPartitioner's contiguous
    ranges.  Each layout's record holds its most loaded shard or tile
    (`max_shard_edges` / `max_tile_edges`), the padded edge ops of a
    round and its exchange bytes, and the seconds `_timed` allows under
    `profile` (default: the active one)."""
    ope = DEFAULT_OPS_PER_EDGE if ops_per_edge is None else ops_per_edge
    profile = profile or active_profile()
    s = np.asarray(src)
    d = np.asarray(dst)
    if not directed:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])

    # 1-D: contiguous oid blocks; in-CSR rows are the destination owner
    shard_w = max(1, -(-n_vertices // fnum))
    shard_counts = np.bincount(np.minimum(d // shard_w, fnum - 1),
                               minlength=fnum)
    max_shard = int(shard_counts.max())
    vp = _next_pow2(max(shard_w, 8))
    # one fragment exchanges nothing in either layout
    bytes_1d = (exchange_bytes_ledger(fnum, vp, itemsize=itemsize)["gather"]
                if fnum > 1 else 0)
    out = {"1d": _timed({
        "max_shard_edges": max_shard,
        "padded_edges": _round_up(max_shard, 128),
        "padded_edge_ops": _round_up(max_shard, 128) * ope,
        "exchange_bytes": bytes_1d,
    }, ope, profile, "gather")}
    k = int(round(np.sqrt(fnum)))
    if k * k == fnum and k >= 1:
        chunk = max(1, -(-n_vertices // k))
        vc = _round_up(chunk, 128)
        tile = (np.minimum(s // chunk, k - 1) * k
                + np.minimum(d // chunk, k - 1))
        max_tile = int(np.bincount(tile, minlength=k * k).max())
        out["2d"] = _timed({
            "k": k,
            "max_tile_edges": max_tile,
            "padded_edges": _round_up(max_tile, 128),
            "padded_edge_ops": _round_up(max_tile, 128) * ope,
            "exchange_bytes": vc2d_exchange_bytes(k, vc, itemsize),
        }, ope, profile, "vc2d")
    for rec in out.values():
        del rec["padded_edges"]
    return out


def precheck_partition(app_name: str, fnum: int, *, directed: bool = False,
                       string_id: bool = False) -> str | None:
    """The eligibility checks that need no edge data: a decline reason,
    or None.  The runner records a cheap decline with it before reading
    the edge file."""
    if app_name not in VC2D_APPS:
        return (f"no 2-D vertex-cut implementation for {app_name!r} "
                f"(known: {sorted(VC2D_APPS)})")
    k = int(round(np.sqrt(fnum)))
    if k * k != fnum:
        return f"fnum={fnum} is not a perfect square"
    if string_id:
        return ("string ids: the vertex-cut fragment is specialized to "
                "integer oids (reference immutable_vertexcut_fragment.h)")
    if directed and app_name == "pagerank":
        return ("pagerank_vc accumulates both directions (the reference's "
                "undirected gather-scatter semantics); the directed 1-D "
                "formulation has no 2-D twin")
    return None


def _beats(costs: dict, profile: RateProfile) -> tuple:
    """(2-D wins, the comparison's text): by seconds when the profile
    measured every rate they use, else on both terms at once."""
    one, two = costs["1d"], costs["2d"]
    if "t_round_s" in one:
        return (two["t_round_s"] < one["t_round_s"],
                f"modeled 2-D round cost {two['t_round_s']:.3e}s does not "
                f"beat 1-D {one['t_round_s']:.3e}s")
    wins = (two["padded_edge_ops"] < one["padded_edge_ops"]
            and two["exchange_bytes"] < one["exchange_bytes"])
    unmeasured = [r for r in ("ops_per_s", "exchange_bps")
                  if not profile.measured(r)]
    return wins, (
        f"modeled 2-D round ({two['padded_edge_ops']:.3e} padded edge ops, "
        f"{two['exchange_bytes']} exchange B) does not beat 1-D "
        f"({one['padded_edge_ops']:.3e}, {one['exchange_bytes']} B) on "
        f"both terms, and rate profile {profile.label()} has no measured "
        f"{' or '.join(unmeasured)} to weigh one against the other "
        "(unfitted: one card measures no link)")


def resolve_partition(app_name: str, fnum: int, src: np.ndarray,
                      dst: np.ndarray, oids: np.ndarray, *,
                      directed: bool = False, string_id: bool = False,
                      mode: str | None = None, eligible: bool = True,
                      reason: str = "",
                      profile: RateProfile | None = None) -> dict:
    """The partition decision for one (app, graph, fnum): {"mode": "1d" |
    "2d", "engaged", "costs", "reason", ...}, recorded in
    PARTITION_STATS.  Every 2d / auto request that lands on 1-D carries
    its reason; `eligible=False` with `reason` records a decline the
    planner cannot see (a delta load, the serialization cache)."""
    from libgrape_lite_tpu_torch.utils import logging as glog

    mode = partition_mode() if mode is None else mode
    profile = profile or active_profile()
    decision = {
        "app": app_name, "requested": mode, "fnum": fnum,
        "mode": "1d", "engaged": False, "profile": profile.label(),
    }

    def declined(why: str, count: bool = True):
        decision["reason"] = why
        PARTITION_STATS["last_decision"] = decision
        if count:
            PARTITION_STATS["declined"] += 1
            glog.vlog(1, "partition: 2d declined for %s: %s", app_name, why)
        return decision

    if mode == "1d":
        return declined("GRAPE_PARTITION off (1d)", count=False)
    if not eligible:
        return declined(reason or "caller declared ineligible")
    why = precheck_partition(app_name, fnum, directed=directed,
                             string_id=string_id)
    if why is not None:
        return declined(why)
    k = int(round(np.sqrt(fnum)))
    n_vertices = int(np.asarray(oids).max()) + 1 if len(oids) else 1
    costs = modeled_costs(src, dst, n_vertices, fnum, directed=directed,
                          profile=profile)
    decision["costs"] = costs
    if "2d" not in costs:
        return declined("cost model found no k^2 tiling")
    if mode == "auto":
        wins, text = _beats(costs, profile)
        if not wins:
            return declined(text + " (balanced cut or k too small for the "
                            "byte win; GRAPE_PARTITION=2d forces)")
    decision["mode"] = "2d"
    decision["engaged"] = True
    PARTITION_STATS["resolved_2d"] += 1
    PARTITION_STATS["last_decision"] = decision
    glog.vlog(1, "partition: 2d engaged for %s (k=%d, max tile %d vs max "
              "shard %d edges, %d vs %d exchange B/round)", app_name, k,
              costs["2d"]["max_tile_edges"], costs["1d"]["max_shard_edges"],
              costs["2d"]["exchange_bytes"], costs["1d"]["exchange_bytes"])
    return decision
