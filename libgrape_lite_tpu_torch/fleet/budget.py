"""Fleet budget: price resident sessions, decide admission and eviction.

Counterpart of `libgrape_lite_tpu/fleet/budget.py`.  A serving fleet
keeps N resident (graph x app) sessions under one device byte budget.
Footprints are priced from what already exists, not from a new model:

  * **fragment bytes**: the stacked device CSRs and vertex planes,
    priced from their host twins (`host_oe` / `host_ie`: the shapes and
    types `_to_device` places; a vertex-cut fragment's concatenated tile
    CSRs), so an evicted session prices as a resident one;
  * **plan bytes**: the per-fragment caches built for the fragment --
    the device caches of DEVICE_CACHES (push CSRs, `dest_degree`), the
    strict plans (`ops/spmv.py`) and the spgemm plans
    (`ops/spgemm_pack.py`); a cache never built prices 0;
  * **overlay bytes**: the dyn delta overlay's [fnum, capacity] planes;
  * **runner bytes**: the resident workers' last results
    (`Worker._result_state`), which `Worker.release_buffers` drops.

`FleetBudget.admit` fits a priced footprint under the capacity and, when
it does not fit, evicts cost-weighted LRU victims: the resident with the
largest `idle_seconds * freeable_bytes / weight` goes first.  A fragment
shared by residents is billed once and freeable only with its last
resident.  The capacity is GRAPE_FLEET_HBM_BYTES, else GRAPE_HBM_BYTES,
else the card's free memory (`device_budget_bytes`, as the loader's
check reads it; the default rate profile's 80 GB on the CPU); 0 means no
limit.
Every decision -- admit, evict, re-admit, reject -- is recorded in
`FLEET_STATS`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

#: capacity env knob; falls back to the loader's GRAPE_HBM_BYTES
FLEET_HBM_ENV = "GRAPE_FLEET_HBM_BYTES"


class FleetStats:
    """Every fleet decision, counted, with a bounded event history:
    admissions, evictions, re-admissions, rejections, drains, rejoins."""

    MAX_EVENTS = 256

    def __init__(self):
        self.admits = 0
        self.evictions = 0
        self.readmits = 0
        self.rejects = 0
        self.drains = 0
        self.rejoins = 0
        self.events: List[dict] = []

    def _record(self, ev: dict) -> None:
        self.events.append(ev)
        if len(self.events) > self.MAX_EVENTS:
            del self.events[: self.MAX_EVENTS // 2]

    def record(self, kind: str, **detail) -> None:
        counter = {"admit": "admits", "evict": "evictions",
                   "readmit": "readmits", "reject": "rejects",
                   "drain": "drains", "rejoin": "rejoins"}.get(kind)
        if counter is not None:
            setattr(self, counter, getattr(self, counter) + 1)
        self._record({"kind": kind, **detail})

    def snapshot(self) -> dict:
        return {
            "admits": self.admits, "evictions": self.evictions,
            "readmits": self.readmits, "rejects": self.rejects,
            "drains": self.drains, "rejoins": self.rejoins,
        }

    def reset(self) -> None:
        self.__init__()


#: one record for every budget, manager and router of the process
FLEET_STATS = FleetStats()

# federated as "fleet" (obs/federation.py)
from libgrape_lite_tpu_torch.obs import federation as _federation  # noqa: E402

_federation.register("fleet", FLEET_STATS.snapshot, FLEET_STATS.reset,
                     module=__name__)


# ---- footprint pricing ----

def fragment_bytes(frag) -> int:
    """Device bytes of one stacked fragment, priced from the host CSR
    twins; an undirected fragment's aliased ie pays once.  A vertex-cut
    fragment prices the host arrays its `dev` places
    (`ImmutableVertexcutFragment.device_arrays`: the concatenated tile
    CSRs and the vertex mask), not the JAX package's COO tile blocks,
    which the port does not place."""
    if getattr(frag, "mesh_kind", "frag") == "vc2d":
        return sum(int(a.nbytes) for a in frag.device_arrays().values())
    def csr(csrs):
        b = 0
        for c in csrs:
            b += c.indptr.nbytes + c.edge_src.nbytes
            b += c.edge_nbr.nbytes + c.edge_mask.nbytes
            if c.edge_w is not None:
                b += c.edge_w.nbytes
        return b

    total = csr(frag.host_oe)
    aliased = frag.host_ie is frag.host_oe
    if not aliased:
        total += csr(frag.host_ie)
    # ivnum + inner_mask + oids (int64) + degree plane(s)
    fnum, vp = frag.fnum, frag.vp
    total += fnum * 4 + fnum * vp * (1 + 8 + 4 + (0 if aliased else 4))
    return total


def _nbytes(obj, seen: set) -> int:
    """Bytes of the arrays and tensors in a cache entry (tuples, lists,
    dicts, a plan's `host_streams`), each counted once."""
    if obj is None or id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_nbytes(v, seen) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(v, seen) for v in obj)
    return _nbytes(getattr(obj, "host_streams", None), seen)


def plan_stream_bytes(frag) -> int:
    """Bytes of every per-fragment cache built for `frag`: the device
    caches (push CSRs, `dest_degree`), the strict plans and the spgemm
    plans.  0 on a fragment whose caches were never built."""
    from libgrape_lite_tpu_torch.fragment.edgecut import DEVICE_CACHES
    from libgrape_lite_tpu_torch.ops.spgemm_pack import _FRAG_PLANS
    from libgrape_lite_tpu_torch.ops.spmv import _PLAN_CACHE

    seen: set = set()
    return sum(_nbytes(cache.get(frag), seen)
               for cache in (*DEVICE_CACHES, _PLAN_CACHE, _FRAG_PLANS))


def overlay_bytes(frag) -> int:
    """Bytes of the attached dyn delta overlay's side planes."""
    ov = getattr(frag, "dyn_overlay", None)
    if ov is None:
        return 0
    sides = [ov.ie] if ov.oe is ov.ie else [ov.ie, ov.oe]
    return sum(s.src.nbytes + s.nbr.nbytes + s.w.nbytes + s.mask.nbytes
               for s in sides)


def runner_bytes(session) -> int:
    """Device bytes of the session's resident workers' last results."""
    total = 0
    for w in getattr(session, "_workers", {}).values():
        st = getattr(w, "_result_state", None)
        if isinstance(st, dict):
            total += sum(v.nbytes for v in st.values()
                         if hasattr(v, "nbytes"))
    return total


@dataclass
class Footprint:
    """One resident target's priced footprint.  `frag_keys` names the
    fragment objects, so a fragment shared by tenants is billed once and
    not freed while a sibling still serves from it."""

    frag_bytes: int = 0
    plan_bytes: int = 0
    overlay_bytes: int = 0
    runner_bytes: int = 0
    frag_keys: Dict[int, int] = field(default_factory=dict)  # id -> bytes

    @property
    def total(self) -> int:
        return (self.frag_bytes + self.plan_bytes
                + self.overlay_bytes + self.runner_bytes)

    @property
    def private_bytes(self) -> int:
        """Everything but the (possibly shared) fragment."""
        return self.total - self.frag_bytes

    def as_dict(self) -> dict:
        return {
            "frag_bytes": self.frag_bytes,
            "plan_bytes": self.plan_bytes,
            "overlay_bytes": self.overlay_bytes,
            "runner_bytes": self.runner_bytes,
            "total": self.total,
        }


def session_footprint(session) -> Footprint:
    """Price one ServeSession (the four parts of the module docstring)."""
    frag = session.fragment
    fb = fragment_bytes(frag)
    return Footprint(
        frag_bytes=fb,
        plan_bytes=plan_stream_bytes(frag),
        overlay_bytes=overlay_bytes(frag),
        runner_bytes=runner_bytes(session),
        frag_keys={id(frag): fb},
    )


def target_footprint(target) -> Footprint:
    """Price a tenancy target: a ServeSession, or a FleetRouter priced
    replica by replica (a fragment shared by replicas counts once)."""
    replicas = getattr(target, "replicas", None)
    if replicas is None:
        return session_footprint(target)
    out = Footprint()
    for r in replicas:
        fp = session_footprint(r.session)
        out.plan_bytes += fp.plan_bytes
        out.overlay_bytes += fp.overlay_bytes
        out.runner_bytes += fp.runner_bytes
        for k, b in fp.frag_keys.items():
            if k not in out.frag_keys:
                out.frag_keys[k] = b
                out.frag_bytes += b
    return out


# ---- the budget ----

@dataclass
class _Resident:
    footprint: Footprint
    weight: float
    last_use: float
    evictable: bool


class FleetBudget:
    """Admission and eviction under one byte budget.  The budget only
    decides; the caller's `evict` callback releases the device buffers
    (FleetManager points it at `ServeSession.release_device`).  Without
    `capacity_bytes` the capacity is GRAPE_FLEET_HBM_BYTES, else
    `device_budget_bytes(device)`; `device` None means the card when
    there is one."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic, *,
                 device=None):
        if capacity_bytes is None:
            from libgrape_lite_tpu_torch.fragment.edgecut import (
                device_budget_bytes,
            )

            env = os.environ.get(FLEET_HBM_ENV)
            if device is None:
                device = "cuda" if torch.cuda.is_available() else "cpu"
            capacity_bytes = (int(env) if env is not None
                              else device_budget_bytes(device))
        self.capacity = int(capacity_bytes)  # 0 = unlimited
        self._clock = clock
        self.residents: Dict[str, _Resident] = {}

    # ---- accounting ----

    def used_bytes(self) -> int:
        """Resident bytes, shared fragments billed once."""
        total, seen = 0, set()
        for r in self.residents.values():
            total += r.footprint.private_bytes
            for k, b in r.footprint.frag_keys.items():
                if k not in seen:
                    seen.add(k)
                    total += b
        return total

    def _freeable_bytes(self, name: str) -> int:
        """Bytes evicting `name` recovers: its private bytes plus its
        fragments no other resident shares."""
        r = self.residents[name]
        freeable = r.footprint.private_bytes
        for k, b in r.footprint.frag_keys.items():
            if not any(k in o.footprint.frag_keys
                       for n, o in self.residents.items() if n != name):
                freeable += b
        return freeable

    def _marginal_bytes(self, footprint: Footprint) -> int:
        """What admitting a footprint adds to what is resident (shared
        fragments are paid already)."""
        cost = footprint.private_bytes
        for k, b in footprint.frag_keys.items():
            if not any(k in r.footprint.frag_keys
                       for r in self.residents.values()):
                cost += b
        return cost

    def touch(self, name: str) -> None:
        if name in self.residents:
            self.residents[name].last_use = self._clock()

    # ---- decisions ----

    def _pick_victim(self) -> Optional[str]:
        """Cost-weighted LRU: the evictable resident with the largest
        idle_seconds * freeable_bytes / weight (ties: insertion order);
        None when nothing can be evicted."""
        now = self._clock()
        best, best_score = None, -1.0
        for name, r in self.residents.items():
            if not r.evictable:
                continue
            idle = max(now - r.last_use, 1e-9)
            score = idle * self._freeable_bytes(name) / max(r.weight, 1e-9)
            if score > best_score:
                best, best_score = name, score
        return best

    def admit(self, name: str, footprint: Footprint, *,
              weight: float = 1.0, evictable: bool = True,
              evict: Optional[Callable[[str], None]] = None) -> dict:
        """Admit `name`, evicting cost-weighted LRU victims (each through
        the `evict` callback) until it fits.  Returns the recorded
        decision; a reject (over budget with nothing left to evict) is
        recorded and returned with admitted=False, never silent."""
        # a resident re-priced: its old entry leaves for the computation
        # and comes back on a reject (it is still resident at that size)
        prior = self.residents.pop(name, None)
        readmit = prior is not None
        evicted: List[dict] = []
        while (self.capacity
               and self.used_bytes() + self._marginal_bytes(footprint)
               > self.capacity):
            victim = self._pick_victim()
            if victim is None:
                if prior is not None:
                    self.residents[name] = prior
                decision = {
                    "admitted": False, "name": name,
                    "asked_bytes": footprint.total,
                    "used_bytes": self.used_bytes(),
                    "capacity": self.capacity,
                    "evicted": evicted,
                    "reason": "over budget with no evictable resident",
                }
                FLEET_STATS.record("reject", **decision)
                return decision
            freed = self._freeable_bytes(victim)
            if evict is not None:
                evict(victim)
            del self.residents[victim]
            ev = {"name": victim, "freed_bytes": freed, "for": name}
            evicted.append(ev)
            FLEET_STATS.record("evict", **ev)
        self.residents[name] = _Resident(
            footprint=footprint, weight=float(weight),
            last_use=self._clock(), evictable=evictable)
        decision = {
            "admitted": True, "name": name,
            "bytes": footprint.total,
            "used_bytes": self.used_bytes(),
            "capacity": self.capacity,
            "evicted": evicted,
        }
        FLEET_STATS.record("readmit" if readmit else "admit", **decision)
        return decision

    def release(self, name: str, reason: str = "release") -> None:
        if name in self.residents:
            freed = self._freeable_bytes(name)
            del self.residents[name]
            FLEET_STATS.record("evict", name=name, freed_bytes=freed,
                               reason=reason)

    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "used_bytes": self.used_bytes(),
            "residents": {
                n: {**r.footprint.as_dict(), "weight": r.weight,
                    "evictable": r.evictable}
                for n, r in self.residents.items()
            },
        }
