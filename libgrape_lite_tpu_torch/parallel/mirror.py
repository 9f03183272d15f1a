"""Mirror-compressed state exchange: send outer-vertex rows only.

Counterpart of `libgrape_lite_tpu/parallel/mirror.py` (reference
batch-shuffle mirror sync, `grape/parallel/batch_shuffle_message_
manager.h:237-264`; mirror lists from `grape/fragment/edgecut_fragment_
base.h:569-602`).  Instead of gathering the full per-vertex state, each
fragment g sends every other fragment f exactly the rows of g that f's
edges read.

Host side (`build_mirror_plan`, cached per fragment and direction): per
(receiver f, sender g) the sorted unique pids of g that f's edges
reference; m = the longest such list rounded up to 128; the send table
`send_idx` [fnum (sender), fnum (receiver), m] of local ids; every edge
column remapped into fragment f's COMPACT space [vp local | g0 mirrors
| g1 mirrors | ...] of `n_compact = vp + fnum * m` entries
(`nbr_compact`).  The arrays equal the JAX plan's.

Per round (`StepContext.exchange_mirrors`): one gather x[g][send_idx[g]],
one all-to-all (a transpose of the [fnum, fnum, m] send block on one
card), one concat per fragment: the compact tables [fnum, n_compact].
The pull's K1 takes one x for the whole stacked CSR, so the compact
tables are flattened and the plan's `pull_columns` remaps fragment f's
columns to f * n_compact + nbr_compact[f] once, on the host; K1 itself
is unchanged.  Rows and their edge order are the serial pull's, so the
pull's result is bit-equal to the gather's.

The byte models (`exchange_bytes_ledger`, `vc2d_exchange_bytes`,
`pipelined_round_s`) are the one copy both the mirror auto gate, the
pipeline threshold (parallel/pipeline.py) and the partition planner
(fragment/partition.py) read.

`auto` and the card: the JAX gates price a link between chips.  Every
fragment here lives on one device, so on a CUDA device the exchange is a
copy in its memory, and on the H100 the mirror pull and the pipelined
round both ran slower than the serial gather round.  `auto_keeps_serial`
says so: on a CUDA device, until the rate profile holds a measured
`exchange_bps`, `auto` resolves to the gather and the serial round, and
the decision records why.  On the CPU (which only the tests ask for) the
JAX gates stand, so the decisions there stay the reference's.
"""

from __future__ import annotations

import itertools
import os
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from libgrape_lite_tpu_torch.fragment.edgecut import (
    device_cache,
    device_cache_filled,
)
from libgrape_lite_tpu_torch.ops.calibration import active_profile

_UID = itertools.count(1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def exchange_bytes_ledger(fnum: int, vp: int, m: int | None = None,
                          itemsize: int = 4) -> dict:
    """The per-round exchange bytes of one device: {"gather": the full
    state gather, "mirror": the mirror all-to-all (None without a
    plan)}.  The one model the mirror auto gate and the pipeline
    threshold share."""
    return {
        "gather": fnum * vp * itemsize,
        "mirror": None if m is None else fnum * m * itemsize,
    }


def vc2d_exchange_bytes(k: int, vc: int, itemsize: int = 4,
                        pulls: int = 1) -> int:
    """The 2-D vertex-cut round's exchange bytes a device: per pull a
    ring reduction of the [vc] partials along the k row peers (2 (k - 1)
    / k * vc items) and one transpose ((1 - 1/k) * vc on average: the
    diagonal maps to itself)."""
    if k <= 1:
        return 0
    per_pull = (2 * (k - 1) / k + (1 - 1 / k)) * vc * itemsize
    return int(round(pulls * per_pull))


def pipelined_round_s(compute_interior_s: float, exchange_s: float,
                      compute_boundary_s: float) -> float:
    """The pipelined round's modeled wall:

        t = max(compute_interior, exchange) + compute_boundary

    the exchange for round k + 1 overlaps round k's interior pull and
    joins before the next round reads it; only the boundary pull, which
    produces the exchange payload, stays on the critical path."""
    return max(compute_interior_s, exchange_s) + compute_boundary_s


@dataclass
class MirrorPlan:
    """Static routing of the mirror exchange of one fragment and
    direction (host arrays, as the JAX plan's)."""

    fnum: int
    vp: int
    m: int                     # mirror slots per (sender, receiver) pair
    n_compact: int             # vp + fnum * m
    send_idx: np.ndarray       # [fnum (sender), fnum (receiver), m] int32
    nbr_compact: np.ndarray    # [fnum, Ep] int32 compact edge columns
    uid: int = field(default_factory=lambda: next(_UID))

    @property
    def bytes_all_gather(self) -> int:
        """Bytes a round of the full-state gather this plan replaces."""
        return exchange_bytes_ledger(self.fnum, self.vp, self.m)["gather"]

    @property
    def bytes_mirror(self) -> int:
        """Bytes a round of the mirror all-to-all."""
        return exchange_bytes_ledger(self.fnum, self.vp, self.m)["mirror"]

    def pull_columns(self, edge_mask: np.ndarray, lo: int = 0,
                     fl: int | None = None) -> np.ndarray:
        """[fnum, Ep] int32: fragment f's compact columns shifted to f's
        block of the flattened [fnum * n_compact] table; pad edges on
        column 0 (K1 reads no edge past its row ends).  A rank's slab
        (`lo`, `fl`) gives those fragments' rows, each shifted to its
        block of the slab's [fl * n_compact] table."""
        hi = self.fnum if fl is None else lo + fl
        base = (np.arange(hi - lo, dtype=np.int64) * self.n_compact)[:, None]
        cols = np.where(edge_mask[lo:hi], self.nbr_compact[lo:hi] + base, 0)
        return cols.astype(np.int32)

    def state_entries(self, prefix: str, frag, direction: str = "ie") -> dict:
        """The ephemeral state leaves of a pull under this plan, on the
        fragment's device: the send table (`<prefix>send`, int64 for
        indexing) and the remapped pull columns (`<prefix>nbr`).  Under a
        process group both are the rank's slab: its senders' rows of the
        send table and its receivers' columns.  Placed once per fragment
        and plan (a DEVICE_CACHES entry)."""
        per = _PLACED.setdefault(frag, {})
        key = (self.uid, prefix)
        if key not in per:
            csrs = frag.host_ie if direction == "ie" else frag.host_oe
            mask = np.stack([h.edge_mask for h in csrs])
            lo, fl = frag.fid_lo, frag.fl
            per[key] = {
                prefix + "send": torch.from_numpy(
                    self.send_idx[lo:lo + fl].astype(np.int64)).to(
                        frag.device),
                prefix + "nbr": torch.from_numpy(
                    self.pull_columns(mask, lo, fl)).to(frag.device),
            }
            device_cache_filled()
        return dict(per[key])


_FRAG_MIRROR_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


#: the placed state leaves of each fragment's plans (`state_entries`)
_PLACED = device_cache()

# auto-mode engagement gate (the JAX package's): the mirror exchange must
# at least halve the bytes, and the gather it replaces must be larger
# than 1 MiB, below which a collective is latency-bound
_AUTO_RATIO = 0.5
_AUTO_MIN_BYTES = 1 << 20


#: the last `resolve_mirror_plan` outcome: {"mode": GRAPE_EXCHANGE's
#: value, "exchange": "mirror" | "gather", "reason": why}
LAST_EXCHANGE_DECISION: dict = {}


def auto_keeps_serial(frag, profile=None) -> str | None:
    """Why `auto` keeps the gather exchange and the serial round on
    `frag`, or None when the JAX gates decide: on a CUDA device whose
    rate profile has no measured `exchange_bps`, the exchange is a copy
    in device memory and neither the mirror pull nor the split round has
    anything to hide (both measured slower on the H100)."""
    if frag.device.type != "cuda":
        return None
    p = profile or active_profile()
    if p.measured("exchange_bps"):
        return None
    return (f"one CUDA device, exchange_bps unmeasured under profile "
            f"{p.label()}: the exchange is a copy in device memory; set "
            "GRAPE_EXCHANGE=mirror / GRAPE_PIPELINE=force to override")


def resolve_mirror_plan(frag, direction: str = "ie"):
    """The exchange mode of an app's pull, from `GRAPE_EXCHANGE`:

      * "mirror" -- always exchange mirrors (fnum > 1);
      * "gather" / "off" -- always the full-state gather;
      * unset / "auto" -- the gather on one CUDA device
        (`auto_keeps_serial`), else mirrors only when the byte model
        shows a clear win (`_AUTO_RATIO`, `_AUTO_MIN_BYTES`).

    Returns a MirrorPlan, or None for the gather; the outcome and its
    reason land in LAST_EXCHANGE_DECISION."""
    mode = os.environ.get("GRAPE_EXCHANGE", "auto") or "auto"

    def decided(plan, why: str):
        LAST_EXCHANGE_DECISION.clear()
        LAST_EXCHANGE_DECISION.update(
            mode=mode, exchange="gather" if plan is None else "mirror",
            reason=why)
        return plan

    if mode not in ("mirror", "gather", "off", "auto"):
        # an unrecognised value must not silently engage mirrors
        from libgrape_lite_tpu_torch.utils import logging as glog

        glog.log_info(f"GRAPE_EXCHANGE={mode!r} is not one of "
                      "mirror|gather|off|auto; using gather")
        return decided(None, "unrecognised GRAPE_EXCHANGE")
    if frag.fnum == 1:
        return decided(None, "fnum==1: nothing to exchange")
    if mode in ("gather", "off"):
        return decided(None, f"GRAPE_EXCHANGE={mode}")
    if mode == "mirror":
        return decided(build_mirror_plan(frag, direction),
                       "GRAPE_EXCHANGE=mirror")
    why = auto_keeps_serial(frag)
    if why is not None:
        return decided(None, why)
    gather_bytes = exchange_bytes_ledger(frag.fnum, frag.vp)["gather"]
    if gather_bytes <= _AUTO_MIN_BYTES:
        # too small for bytes to matter; skip the planner
        return decided(None, f"gather bytes {gather_bytes} at most "
                       f"{_AUTO_MIN_BYTES}")
    plan = build_mirror_plan(frag, direction)
    if plan.bytes_mirror <= _AUTO_RATIO * plan.bytes_all_gather:
        return decided(plan, f"mirror bytes {plan.bytes_mirror} at most "
                       f"{_AUTO_RATIO} x the gather's")
    return decided(None, f"mirror bytes {plan.bytes_mirror} over "
                   f"{_AUTO_RATIO} x the gather's")


def build_mirror_plan(frag, direction: str = "ie") -> MirrorPlan | None:
    """The mirror plan of `frag`'s pull over `direction` ("ie" | "oe"),
    cached per fragment; None at fnum 1 (nothing to exchange)."""
    if frag.fnum == 1:
        return None
    per_frag = _FRAG_MIRROR_CACHE.setdefault(frag, {})
    if direction in per_frag:
        return per_frag[direction]

    fnum, vp = frag.fnum, frag.vp
    csrs = frag.host_ie if direction == "ie" else frag.host_oe

    # per receiver f: a mark a pid its real edges read (the sorted unique
    # request lists of every sender g, in one O(E + N) pass, no sort)
    # and each mark's rank inside its sender's block
    marks, m = [], 1
    for f in range(fnum):
        h = csrs[f]
        mark = np.zeros((fnum, vp), dtype=bool)
        mark.reshape(-1)[h.edge_nbr[h.edge_mask]] = True
        mark[f] = False  # local reads are not requested
        marks.append(mark)
        m = max(m, int(mark.sum(axis=1).max()))
    m = _round_up(m, 128)

    send_idx = np.zeros((fnum, fnum, m), dtype=np.int32)
    ep = csrs[0].edge_nbr.shape[0]
    nbr_compact = np.zeros((fnum, ep), dtype=np.int32)
    for f in range(fnum):
        mark = marks[f]
        rank = np.cumsum(mark, axis=1) - 1  # [g, lid] -> slot in g's list
        for g in range(fnum):
            if g != f:
                r = np.flatnonzero(mark[g])
                send_idx[g, f, :len(r)] = r
        h = csrs[f]
        nbr = h.edge_nbr.astype(np.int64)
        g_of, lid = nbr // vp, nbr % vp
        out = np.where(g_of == f, lid,
                       vp + g_of * m + rank[g_of, lid])
        nbr_compact[f] = np.where(h.edge_mask, out, 0).astype(np.int32)

    plan = MirrorPlan(fnum=fnum, vp=vp, m=m, n_compact=vp + fnum * m,
                      send_idx=send_idx, nbr_compact=nbr_compact)
    per_frag[direction] = plan
    return plan
