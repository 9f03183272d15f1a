"""Guarded batched execution: per-lane monitors, breach isolation.

Counterpart of `libgrape_lite_tpu/serve/batch.py`.  The unguarded batch
is `Worker.query_batch` (the lane loop, one vote read a round).  With
guards armed a batch runs here instead: the same freeze-masked lane
loop in chunks of `guard_cfg.every` rounds, with ONE GuardMonitor per
lane on the host for the policy, the counters and the bundles.  Lanes
never share state, so a poisoned query cannot contaminate its
batchmates; what isolation adds is the policy: a lane whose invariants
fail is frozen (its vote forced to 0, its carry pinned by the loop's
freeze mask) and its slot in `batch_breaches` holds the diagnostic
bundle, while every other lane runs to convergence and returns the
bytes of its own query.  `rollback` degrades to per-lane halt (a batch
has no per-lane checkpoint lineage), logged, as in the JAX package.

A chunk boundary costs one host read for all k lanes: the invariants,
the carry digest and the residual are evaluated over the lane-stacked
carry (a counting invariant's violation mask once, reduced per lane;
`guard/watchdog.py::carry_digest_lanes`), or over each lane of a
per-lane batch, all on the card, and read back as one [k, columns]
tensor.  Each lane's digest words equal the JAX package's for that lane.
The read waits on the batch's own stream only (under the async pump a
batch runs in its own thread and CUDA stream), never on the device.

Under the pump (serve/pipeline.py) a guarded batch runs this chunk loop
in its launched thread; its verdicts are snapshot into the dispatch
handle (`BatchDispatch.breaches`) and its values harvest lazily with
every other batch's.

With obs/ armed: a `query` span (mode "guarded-batched") with `peval`
and `chunk` spans (start round, live lanes, end round), a
`serve_lane_breach` instant a breached lane, and the monitors' own
guard counters and instants.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.guard.watchdog import carry_digest_lanes
from libgrape_lite_tpu_torch.obs.federation import FederatedStats

_INT32_MAX = np.iinfo(np.int32).max

#: chunk boundaries probed and the host seconds their probes took,
#: summed over every guarded batch of the process; federated as
#: "guarded_batch" (a namespace of the port's: the JAX package keeps no
#: such counters)
GUARDED_BATCH_STATS = FederatedStats("guarded_batch", {
    "batches": 0, "boundaries": 0, "probe_s": 0.0, "breaches": 0,
})


def lane_slices(carry: Dict, lane: int) -> Dict:
    """Lane `lane`'s view of a lane-stacked carry."""
    return {k: v[lane] for k, v in carry.items()}


def _lane_of(carry, lane: int) -> Dict:
    return carry[lane] if isinstance(carry, list) else lane_slices(carry,
                                                                    lane)


def _float_keys(carry: Dict) -> List[str]:
    return sorted(k for k, v in carry.items()
                  if torch.as_tensor(v).is_floating_point())


def _residual(prev: Dict, cur: Dict, keys: List[str], lanes: int):
    """[lanes] max |cur - prev| over the float leaves, non-finite deltas
    read as 0 (the monitor's residual, a lane a row)."""
    d = torch.cat([(cur[k].reshape(lanes, -1).to(torch.float32)
                    - prev[k].reshape(lanes, -1).to(torch.float32)).abs()
                   for k in keys], dim=1)
    d = torch.where(torch.isfinite(d), d, 0.0)
    return d.amax(dim=1) if d.shape[1] else d.sum(dim=1)


def _probe_stacked(invs, dev, prev: Dict, cur: Dict, lanes: int):
    """[lanes, columns] float64 on the card: each invariant's (ok,
    measure), the digest words, the residual (when float leaves exist)."""
    cols = []
    for inv in invs:
        if inv.bad is not None:
            nbad = inv.bad(prev, cur).reshape(lanes, -1).sum(dim=1)
            cols += [(nbad == 0).to(torch.float64), nbad.to(torch.float64)]
        else:
            pairs = [inv.check(dev, lane_slices(prev, b), lane_slices(cur, b))
                     for b in range(lanes)]
            cols += [torch.stack([p[0] for p in pairs]).to(torch.float64),
                     torch.stack([p[1] for p in pairs]).to(torch.float64)]
    dig = carry_digest_lanes(cur, lanes).to(torch.float64)  # exact: < 2^32
    cols = [c.reshape(lanes, 1) for c in cols] + [dig]
    keys = _float_keys(cur)
    if keys:
        cols.append(_residual(prev, cur, keys, lanes).to(
            torch.float64).reshape(lanes, 1))
    return torch.cat([c.to(dig.device) for c in cols], dim=1)


def _probe_lanes(invs, dev, prev: List[Dict], cur: List[Dict]):
    """The same columns for a per-lane batch, a row a lane."""
    rows = []
    for p, c in zip(prev, cur):
        one = {k: v.unsqueeze(0) for k, v in c.items()}
        before = {k: v.unsqueeze(0) for k, v in p.items()}
        rows.append(_probe_stacked(invs, dev, before, one, 1))
    return torch.cat(rows, dim=0)


def probe_rows(invs, dev, prev, cur, lanes: int) -> list:
    """Every lane's (oks, measures, digest, residual), computed on the
    carry's device and read back in ONE transfer."""
    table = (_probe_lanes(invs, dev, prev, cur) if isinstance(cur, list)
             else _probe_stacked(invs, dev, prev, cur, lanes))
    n_inv = len(invs)
    example = cur[0] if isinstance(cur, list) else cur
    n_dig = 2 * len(example)
    has_res = bool(_float_keys(example))
    out = []
    for row in table.tolist():  # the one host read
        oks = [bool(row[2 * i]) for i in range(n_inv)]
        vals = [row[2 * i + 1] for i in range(n_inv)]
        digest = tuple(int(x) for x in row[2 * n_inv:2 * n_inv + n_dig])
        residual = row[2 * n_inv + n_dig] if has_res else None
        out.append((oks, vals, digest, residual))
    return out


def guarded_lane_loop(app, frag, state, eph: frozenset, max_rounds: int,
                      batch: int, guard_cfg, *, chunk_hook=None):
    """The guarded batch's loop: PEval, a probe of every lane, then
    chunks of `guard_cfg.every` rounds each followed by a probe of the
    lanes that were live at its start.  Returns (state, rounds [k],
    votes [k], breaches [k], monitors [k]).

    `chunk_hook(carry, rounds)` is a test seam: called after every chunk
    with the loop's carry (a lane-stacked dict, or a list of per-lane
    dicts), it may return replacement leaves in the same form (a dict of
    stacked leaves, or a list with a dict or None a lane), which are
    placed before the probe -- the breach drills poison one lane
    through it (`lane_fault_hook`)."""
    from libgrape_lite_tpu_torch.guard.monitor import GuardMonitor
    from libgrape_lite_tpu_torch.utils import logging as glog
    from libgrape_lite_tpu_torch.worker.worker import _LaneLoop

    if guard_cfg.policy == "rollback":
        glog.log_info(
            "guard: batched dispatches have no per-lane checkpoint "
            "lineage -- rollback degrades to per-lane halt (breach "
            "isolation)")
    limit = max_rounds if max_rounds > 0 else _INT32_MAX
    loop = _LaneLoop(app, frag, state, eph, batch)
    monitors = [GuardMonitor(app=app, frag=frag, config=guard_cfg)
                for _ in range(batch)]
    breaches: list = [None] * batch
    failed = [False] * batch
    tr = obs.tracer()
    GUARDED_BATCH_STATS["batches"] += 1

    def probe(prev, lanes):
        t0 = time.perf_counter()
        cur = loop.carry()
        invs = monitors[0].resolve(_lane_of(cur, 0))
        for m in monitors[1:]:
            m._invariants = invs
        rows = probe_rows(invs, frag.dev, prev, cur, batch)
        for b in lanes:
            if loop.act[b] < 0:  # a cooperative abort is the app's verdict
                continue
            breach = monitors[b].check(
                _lane_of(prev, b), _lane_of(cur, b), loop.rounds[b],
                loop.act[b], probed=rows[b])
            if breach is not None:
                failed[b] = True
                breaches[b] = breach.bundle
                loop.freeze(b)
                GUARDED_BATCH_STATS["breaches"] += 1
                tr.instant("serve_lane_breach", lane=b,
                           round=loop.rounds[b],
                           kind=breach.verdict["kind"],
                           policy=guard_cfg.policy)
        GUARDED_BATCH_STATS["boundaries"] += 1
        GUARDED_BATCH_STATS["probe_s"] += time.perf_counter() - t0
        return cur

    prev = loop.carry()
    with tr.span("peval", batch=batch) as sp:
        loop.peval()
        sp.mark("dispatched")
    if tr.enabled:
        obs.metrics().counter("grape_supersteps_total").inc(batch)
    prev = probe(prev, range(batch))
    while loop.live() and loop.r < limit:
        live_in = [b for b in range(batch) if loop.act[b] > 0]
        stop = min(loop.r + guard_cfg.every, limit)
        start = loop.r
        with tr.span("chunk", start_round=start, lanes=len(live_in)) as sp:
            while loop.live() and loop.r < stop:
                loop.step()
            sp.mark("dispatched")
            sp.set(end_round=loop.r)
        if tr.enabled:
            obs.metrics().counter("grape_supersteps_total").inc(
                loop.r - start)
        if chunk_hook is not None:
            new = chunk_hook(loop.carry(), loop.r)
            if new is not None:
                loop.replace(new)
        prev = probe(prev, [b for b in live_in if not failed[b]])
    out, rounds, act = loop.result()
    return out, rounds, act, breaches, monitors


def lane_fault_hook(plan, lane: int):
    """A `chunk_hook` that offers lane `lane`'s carry to a FaultPlan
    (ft/faults.py, e.g. `corrupt_carry@K`) after every chunk, and puts
    what the plan corrupts back into that lane alone."""
    def hook(carry, rounds):
        if isinstance(carry, list):
            got = plan.maybe_corrupt_carry(carry[lane], rounds)
            if got is None:
                return None
            return [got if b == lane else None for b in range(len(carry))]
        got = plan.maybe_corrupt_carry(lane_slices(carry, lane), rounds)
        if got is None:
            return None
        out = {}
        for k, v in got.items():
            full = carry[k].clone()
            full[lane] = torch.as_tensor(v).to(full.device)
            out[k] = full
        return out

    return hook


def run_guarded_batch(worker, args_list, mr: int, guard_cfg, *,
                      chunk_hook=None):
    """Run a k-lane batch under per-lane guard monitors on `worker`.

    Returns the batched result state (as Worker.query_batch does) and
    leaves the per-lane verdicts on the worker: `batch_rounds`,
    `batch_terminate` and `batch_breaches` (a diagnostic bundle or None
    a lane; serve/session.py turns bundles into failed ServeResults)."""
    prepared = worker.query_batch_prepare(args_list, mr, guard=guard_cfg,
                                          chunk_hook=chunk_hook)
    batch = prepared.batch
    tr = obs.tracer()
    try:
        with tr.span("query", mode="guarded-batched",
                     app=type(worker.app).__name__, batch=batch) as qsp:
            d = prepared.run()
            worker.batch_rounds = d.rounds
            worker.batch_terminate = d.terminate
            worker.batch_breaches = list(d.breaches)
            worker.rounds = int(d.rounds.max()) if batch else 0
            worker._terminate_code = (int(d.terminate.min()) if batch
                                      else 0)
            worker._guard_monitor = d.monitors[0] if d.monitors else None
            if tr.enabled:
                qsp.set(lane_rounds=[int(x) for x in d.rounds],
                        failed_lanes=[b for b in range(batch)
                                      if d.breaches[b] is not None])
            worker._finish_query_obs(qsp)
    finally:
        if tr.enabled:
            obs.flush()
    worker._batch = d
    worker._result_state = d.state
    # the fragment this result's rows live in (query_incremental's
    # prev_fragment default)
    worker._result_fragment = prepared.fragment
    return d.state


__all__ = ["GUARDED_BATCH_STATS", "guarded_lane_loop", "lane_fault_hook",
           "lane_slices", "probe_rows", "run_guarded_batch"]
