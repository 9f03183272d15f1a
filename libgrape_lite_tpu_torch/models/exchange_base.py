"""Shared machinery of the message-exchange apps (sssp_msg, bfs_msg,
sssp_delta, bfs_opt).

Counterpart of `libgrape_lite_tpu/models/exchange_base.py`: the push
relaxation step `exchange_relax`, and `ExchangeAppBase` with the
capacity protocol -- grow on overflow, remember the settled capacity
per fragment so that repeat queries skip the retry ladder (the
reference's `EstimateMessageSize` priming,
`parallel_message_manager_opt.h`).  The host loops stay in each app.

On one device the push is a pull.  The JAX route sends a candidate
`x[u] (+ w)` along each out-edge `u -> v` of a sending `u` to owner(v)
and min-reduces it there.  The in-edge CSR is the transpose of the
out-edge CSR (`kBothOutIn` loading; on undirected graphs the two are one
aliased CSR), so the same minimum is

    gather_reduce(ie.indptr, ie.edge_nbr, w_ie, where(valid, x, neutral), "min")

through the gather-reduce kernel (K1).  The capacity accounting stays
exact: the messages fragment s sends to fragment t in a round are the
out-edges into t of s's sending vertices, a masked sum of each vertex's
out-degree into t (`dest_degree`); the JAX exchange overflows when any
such count exceeds the capacity.  There an overflowed round lost
messages and is rerun with the capacity doubled; here the pull is exact
at any capacity, so the round is kept and the capacity doubled until it
holds the largest count (`ExchangeAppBase._fit_cap`), one retry a
doubling.  So rounds, retries and the settled capacity equal the JAX
app's, with no round thrown away.  `exchange_relax_plain` is the literal
route: the per-edge messages through `exchange`, then a scatter-min.

Across processes a rank holds the slab `[fl, vp]` of every state and
loop mask: `exchange_relax` gathers the masked candidates into the
`[fnum * vp]` vector its pid columns read (one all_gather a round, as
the pull apps do), `dest_degree` is the slab's `[fl, vp, fnum]`, and
`round_scalars` folds a round's host scalars (the messages sent: max;
the counts: sum; the smallest pending distance: min) across ranks in one
all_gather, so that every rank doubles its capacity, advances its
bucket, switches direction and stops in the same rounds as one process.

guard/ and ft/ reach the host loops through `_round_hooks` (JAX
`exchange_base.py:100-160`): the worker cannot probe a loop the app runs
itself, so `sssp_msg` and `sssp_delta` call the hooks at their round
boundaries, and `invariants` gives the distance state SSSP's algebra.
"""

from __future__ import annotations

import weakref

import torch

from libgrape_lite_tpu_torch.app.base import AppBase, local_frags
from libgrape_lite_tpu_torch.fragment.edgecut import (
    device_cache,
    device_cache_filled,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.ops.segment import identity, segment_reduce
from libgrape_lite_tpu_torch.parallel.message_manager import (
    AllToAllMessageManager,
    plan_initial_capacity,
)

_DEST_DEGREE = device_cache()


def dest_degree(frag) -> torch.Tensor:
    """[fl, vp, fnum] int32: out-edges of each vertex into each
    fragment, from the out-edge CSR on the device (`fl` fnum, or the
    rank's slab under a process group); cached per fragment."""
    if frag not in _DEST_DEGREE:
        oe, fnum, vp = frag.dev.oe, frag.fnum, frag.vp
        # pads (src vp, nbr 0) land in the overflow bin vp * fnum
        key = oe.edge_src.long() * fnum + oe.edge_nbr.long() // vp
        deg = torch.stack([torch.bincount(k, minlength=vp * fnum + 1)
                           for k in key])
        _DEST_DEGREE[frag] = (deg[:, :vp * fnum].view(-1, vp, fnum)
                              .to(torch.int32))
        device_cache_filled()
    return _DEST_DEGREE[frag]


def _max_sent(valid, dest_deg) -> torch.Tensor:
    """The most messages one local fragment sends to one fragment, 0-d
    int64 (a rank's share: `round_scalars` takes the maximum across
    ranks)."""
    sent = torch.where(valid.unsqueeze(-1), dest_deg, 0).sum(dim=1)
    return sent.max().to(torch.int64)


def exchange_relax(dev, x, valid, dest_deg, w=None, ctx=None):
    """The push-relax step of the exchange apps as a masked pull (K1).

    x [fl, vp] per-vertex candidates (float32 / float64 distances or
    int32 levels), valid [fl, vp] the sending vertices, w the in-edge
    weights in x's type or None; `ctx` gathers the masked candidates
    into the [fnum * vp] vector the in-edges' pid columns read (one
    all_gather a round across ranks; None: one process's stack).
    Returns (relaxed [fl, vp]: the minimum of x[u] (+ w) over the valid
    in-neighbours u, the neutral element (+inf, INT32_MAX) where none;
    the largest per-(source, destination) message count of the local
    fragments, 0-d int64, which overflows a capacity below it)."""
    ie = dev.ie
    xm = torch.where(valid, x, identity("min", x.dtype))
    full = xm.reshape(-1) if ctx is None else ctx.gather_state(xm)
    relaxed = spmv.gather_reduce(ie.indptr, ie.edge_nbr, w, full, "min")
    return relaxed, _max_sent(valid, dest_deg)


def round_scalars(ctx, parts) -> list:
    """A round's host scalars, whole-graph, in one host read: `parts` is
    a list of (op, 0-d tensor) with op "max", "sum" or "min" over the
    local fragments' values.  Under a process group the ranks' values
    cross in ONE all_gather (float64: the counts stay exact to 2^53) and
    each column folds with its op, so every rank takes the same
    decisions in the same rounds.  Integer inputs come back as ints."""
    v = torch.stack([t.to(torch.float64) for _, t in parts])
    if ctx is not None and ctx.spec is not None:
        rows = ctx.spec.all_gather_into(v.unsqueeze(0))  # [world, k]
        folded = {"max": rows.amax(dim=0), "sum": rows.sum(dim=0),
                  "min": rows.amin(dim=0)}
        v = torch.stack([folded[op][i] for i, (op, _) in enumerate(parts)])
    return [x if t.is_floating_point() else int(x)
            for x, (_, t) in zip(v.tolist(), parts)]


def source_slab(frag, pid: int, fill, dtype):
    """(x, at): the [fl, vp] initial state of a one-source host loop --
    `fill` everywhere, 0 at `pid` -- and the mask of that entry; under a
    process group only the rank that holds pid's fragment sets it."""
    fl, lo = local_frags(frag)
    vp, device = frag.vp, frag.device
    x = torch.full((fl, vp), fill, dtype=dtype, device=device)
    at = torch.zeros((fl, vp), dtype=torch.bool, device=device)
    if pid >= 0 and lo <= pid // vp < lo + fl:
        x[pid // vp - lo, pid % vp] = 0
        at[pid // vp - lo, pid % vp] = True
    return x, at


def exchange_relax_plain(dev, x, valid, cap: int, w_oe=None):
    """The literal route of `exchange_relax`, after the JAX package: per
    out-edge messages x[u] (+ w) of the valid senders through
    `AllToAllMessageManager.exchange`, then a scatter-min of the received
    slots into their rows, and the overflow vote.  Equal to
    `exchange_relax` where the vote is 0; on overflow it drops messages,
    as the JAX route does."""
    oe, fnum, vp = dev.oe, dev.fnum, dev.vp
    neutral = identity("min", x.dtype)
    src = oe.edge_src.clamp(max=vp - 1).long()
    sending = oe.edge_mask & torch.gather(valid, 1, src)
    cand = torch.gather(x, 1, src)
    if w_oe is not None:
        cand = cand + w_oe
    rl, rp, rv, ovf = AllToAllMessageManager.exchange(
        oe.edge_nbr // vp, oe.edge_nbr % vp, cand, sending, cap, fnum)
    relaxed = segment_reduce(torch.where(rv, rp, neutral),
                             torch.where(rv, rl, vp), vp, "min")
    return relaxed, ovf


class ExchangeAppBase(AppBase):
    """Host-driven exchange app: the worker calls `host_compute`, which
    runs the app's own round loop and sets `rounds`."""

    host_only = True
    host_guard = True  # the host loops run guard probes (_round_hooks)

    def __init__(self, initial_capacity: int | None = None,
                 dtype: torch.dtype = torch.float32):
        # None: derive from the graph at query time (plan_initial_capacity)
        self.initial_capacity = initial_capacity
        # the distance type: float32 on the card (K1's type), float64
        # where the caller asks for the JAX package's x64 distances
        self.dtype = dtype
        self.rounds = 0
        self.retries = 0  # overflow-driven capacity regrows
        self.final_capacity = initial_capacity or 1024
        self._learned_cap = weakref.WeakKeyDictionary()

    def _fit_cap(self, cap: int, max_sent: int) -> int:
        """The capacity the JAX app settles at in a round whose largest
        message count is `max_sent`: it doubles and reruns the round
        until nothing overflows.  Counts each doubling as a retry."""
        while max_sent > cap:
            cap *= 2
            self.retries += 1
        return cap

    def _initial_cap(self, frag) -> int:
        return plan_initial_capacity(frag, self.initial_capacity,
                                     self._learned_cap)

    def _save_cap(self, frag, cap: int) -> None:
        self.final_capacity = cap
        self._learned_cap[frag] = cap

    # ---- runtime invariants and host-loop guard probes (guard/) --------

    def invariants(self, frag, state):
        """The exchange apps' distance state is tropical-min like
        models/sssp.py's: never negative (in_range(lo=0) rejects NaN
        too) and only ever improving; +inf is the unreached sentinel.
        The monitor drops these for a subclass whose carry has no
        "dist" leaf."""
        from libgrape_lite_tpu_torch.guard.invariants import (
            in_range, monotone_non_increasing,
        )

        return [
            in_range("dist", lo=0.0),
            monotone_non_increasing("dist"),
        ]

    def _round_hooks(self, frag, carry0: dict) -> "_HostRoundHooks":
        """Guard and fault-injection hooks for the app's own host loop,
        at its round boundaries (its consistent cuts).  Armed by
        Worker.query(guard=...) through `_host_guard_cfg`, or by
        GRAPE_GUARD when host_compute is called directly."""
        return _HostRoundHooks(self, frag, carry0)


class _HostRoundHooks:
    """A host-driven loop's guard monitor and fault plan for one query.

    `observe(carry, rounds, active)` keeps the worker's order in a
    round: injected corruption first (so detection is same-round), then
    the probe (warn logs; halt and rollback raise -- a host loop has no
    checkpoint lineage, so rollback halts), then the remaining fault
    hooks (kill@K).  Returns the carry for the loop to adopt, corrupted
    where a fault fired."""

    def __init__(self, app, frag, carry0: dict):
        from libgrape_lite_tpu_torch.ft.faults import active_plan
        from libgrape_lite_tpu_torch.guard.config import GuardConfig

        # the worker hands over this query's resolved config (a disabled
        # one too: guard="off" disarms an env-armed GRAPE_GUARD); the env
        # covers host_compute calls that bypass the worker
        cfg = getattr(app, "_host_guard_cfg", None) or GuardConfig.resolve(
            None)
        self.monitor = None
        if cfg.enabled:
            from libgrape_lite_tpu_torch.guard.monitor import GuardMonitor

            self.monitor = GuardMonitor(app=app, frag=frag, config=cfg)
        app._host_guard_monitor = self.monitor
        plan = active_plan()
        self.plan = None if plan.is_noop() else plan
        self._prev = dict(carry0)

    @property
    def armed(self) -> bool:
        return self.monitor is not None or self.plan is not None

    def observe(self, carry: dict, rounds: int, active: int) -> dict:
        if self.plan is not None:
            corrupted = self.plan.maybe_corrupt_carry(carry, rounds)
            if corrupted is not None:
                carry = {**carry, **{
                    k: torch.from_numpy(v).to(carry[k].device)
                    for k, v in corrupted.items()}}
        if (self.monitor is not None and active >= 0
                and self.monitor.due(rounds)):
            breach = self.monitor.check(self._prev, carry, rounds, active)
            if breach is not None:
                # no snapshot lineage in a host loop: whatever survives
                # the warn policy halts
                self.monitor.raise_breach(breach)
            self._prev = dict(carry)
        if self.plan is not None:
            self.plan.on_superstep(rounds, None)
        return carry
