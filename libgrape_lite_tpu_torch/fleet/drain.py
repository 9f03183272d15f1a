"""Replica drain with no dropped query: stop routing, quiesce, work, rejoin.

Counterpart of `libgrape_lite_tpu/fleet/drain.py`.  One replica leaves
rotation for offline work (a repack, a catch-up ingest) while its
siblings serve:

  1. **stop routing**: the replica leaves the candidate set; new queries
     spread over its siblings (least-outstanding).
  2. **quiesce**: every query the replica already admitted finishes
     through its pump's drain (partial batches forced); none is dropped.
  3. **offline work**: the caller's `offline(session)` runs against the
     idle replica (e.g. `session.dyn.fold_now`).
  4. **rejoin**: the catch-up log -- each fence the replica missed, with
     its ops -- replays in order, so its graph equals its siblings'; the
     versions must reach the fence or rejoin raises
     `FenceViolationError`.

With obs/ armed the drain and the rejoin are `fleet_drain_begin` and
`fleet_rejoin` trace instants.  Rejoining a replica lost with its
process (`rejoin_lost`) reads a sharded checkpoint lineage, which only
the multi-GPU runtime writes (ROADMAP Queue A item 8); a single-process
loss resumes through `Worker.resume`.
"""

from __future__ import annotations

import time

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fleet.budget import FLEET_STATS
from libgrape_lite_tpu_torch.fleet.router import FenceViolationError


def begin_drain(router, idx: int, *, offline=None) -> dict:
    """Steps 1-3: stop routing, quiesce, run the offline work.  The
    replica stays out of rotation until `rejoin`; deltas ingested
    meanwhile collect in its catch-up log."""
    r = router.replicas[idx]
    if not r.routable:
        raise ValueError(f"replica {idx} is already draining")
    if len([x for x in router.replicas if x.routable]) < 2:
        raise ValueError(
            f"cannot drain replica {idx}: it is the last routable replica "
            "-- traffic would drop")
    t0 = time.perf_counter()
    r.routable = False
    obs.tracer().instant("fleet_drain_begin", replica=idx,
                         outstanding=r.outstanding,
                         pending=r.session.queue.pending())
    drained = r.pump.drain()
    router._collect()
    if offline is not None:
        offline(r.session)
    r.drains += 1
    router.stats["drains"] += 1
    report = {
        "replica": idx,
        "drained_queries": len(drained),
        "offline": offline is not None,
        "wall_s": round(time.perf_counter() - t0, 4),
    }
    FLEET_STATS.record("drain", **report)
    return report


def rejoin(router, idx: int) -> dict:
    """Step 4: replay the catch-up log in fence order, check the version
    against the fence, and return to rotation."""
    r = router.replicas[idx]
    if r.routable:
        raise ValueError(f"replica {idx} is not draining")
    t0 = time.perf_counter()
    applied = 0
    for fence, ops, force in r.catchup:
        r.session.ingest(ops, force_repack=force)
        r.version = fence
        applied += len(ops)
    r.catchup = []
    if r.version != router.fence:
        # every ingest during the drain logged an entry: a mismatch means
        # the log lost one
        raise FenceViolationError(
            f"replica {idx} rejoining at version {r.version} but the fence "
            f"is {router.fence} -- catch-up log incomplete")
    r.routable = True
    obs.tracer().instant("fleet_rejoin", replica=idx, fence=router.fence,
                         catchup_ops=applied)
    report = {"replica": idx, "catchup_ops": applied, "version": r.version,
              "wall_s": round(time.perf_counter() - t0, 4)}
    FLEET_STATS.record("rejoin", **report)
    return report


def rejoin_lost(router, checkpoint_dir: str, *, session_factory):
    """Process-loss rejoin (JAX `fleet/drain.py::rejoin_lost`): a replica
    lost with a dead rank cannot drain or replay a catch-up log; what
    survives is the last committed sharded checkpoint, from which a
    replacement replica resumes the interrupted queries.  Reads the
    lineage's newest metadata (`ft.checkpoint.latest_meta`).  A
    single-file lineage is a single-process loss: the ordinary
    `Worker.resume` path, a ValueError here.  A sharded lineage needs the
    multi-GPU runtime that writes one (ROADMAP Queue A item 8)."""
    from libgrape_lite_tpu_torch.ft.checkpoint import latest_meta

    meta = latest_meta(checkpoint_dir)
    if meta.get("layout") != "sharded":
        raise ValueError(
            f"rejoin_lost needs a sharded (multi-process) checkpoint "
            f"lineage; {checkpoint_dir!r} holds a "
            f"{meta.get('layout', 'single-file')!r} layout -- use the "
            f"ordinary resume path for single-process loss")
    raise NotImplementedError(
        f"rejoin_lost: {checkpoint_dir!r} is a sharded lineage; the port "
        "restores one with its multi-GPU runtime (ft/distributed.py, "
        "restore_resharded): ROADMAP Queue A item 8")


def drain_replica(router, idx: int, *, offline=None) -> dict:
    """Begin and rejoin at once (no ingest can land in between, so the
    replica rejoins at the unchanged fence)."""
    report = begin_drain(router, idx, offline=offline)
    report["rejoin"] = rejoin(router, idx)
    return report
