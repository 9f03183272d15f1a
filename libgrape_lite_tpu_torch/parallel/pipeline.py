"""Superstep pipelining: overlap the halo exchange with the interior pull.

Counterpart of `libgrape_lite_tpu/parallel/pipeline.py`.  A serial round
pulls, then exchanges.  The pipelined round splits each fragment's rows
into boundary rows (read by another fragment, `fragment/edgecut.py::
boundary_split`) and interior rows, and runs

    boundary K1 pull            (current stream; reads the buffered table)
    kickoff of the exchange     (side stream, after an event on the
                                 current one: round k + 1's inputs into a
                                 fresh double buffer)
    interior K1 pull            (current stream, overlapping the kickoff)
    join                        (the current stream waits on the side
                                 stream's event; the next round reads
                                 the buffer)

The two pulls are two K1 CSRs (`_split_streams`): [fnum, vp + 1] indptrs
whose rows of the other part are empty, each row's edges in the original
CSR order.  K1 takes one x for the stacked CSR, so the pull table is the
splice `cat(live [N], xbuf)`: local columns index the live state, remote
columns the buffer -- the gathered state [N] (gather mode) or the
received mirror rows [fnum, fnum * m] (mirror mode, `parallel/
mirror.py`).  Remote reads really come from the buffer.

Bit-equality with the serial round: every remote read touches a boundary
row (the definition of boundary) and the kickoff carries those rows' new
values; local reads see the live state; the two parts partition the
rows and every row folds its own edges.  Min folds and integer folds are
exact in any grouping, CDLP's mode fold only groups equal rows.  A float
SUM is not: K1's merge path cuts a long row where its diagonal falls and
splitting the rows moves the cuts, so sums regroup -- a sum fold declines
(the JAX package's decline for its pack backend, K1's counterpart).

The buffer is a pure function of the carry: the worker builds it after
PEval, after a resume and after anything rewrites the carry, and it never
enters the carry, a checkpoint, a digest or a probe.

Engagement, `GRAPE_PIPELINE` (the JAX names and gates):

  * unset / "0" / "off" -- off: the serial round;
  * "1" / "auto" -- on one CUDA device with no measured `exchange_bps`
    off (`mirror.auto_keeps_serial`: the exchange is a copy in device
    memory and the split round measured slower on the H100); elsewhere
    engage when the modeled exchange bytes (`mirror.exchange_bytes_
    ledger`) reach GRAPE_PIPELINE_MIN_BYTES (default 1 MiB) and the
    modeled hidden time reaches GRAPE_PIPELINE_MIN_HIDDEN_US (default
    0);
  * "force" -- engage whenever the structure allows.

Every decline is recorded in PIPELINE_STATS (federated as "pipeline").
On the CPU (asked for explicitly) the same steps run in order, with no
streams.

Across ranks (a StepContext over a process group) a rank's split CSRs
are its slab's rows, the splice's live half its [fl, vp] slab, and the
kickoff issues the exchange -- the state all_gather (gather) or
`StepContext.mirror_recv`'s all_to_all (mirror) -- as an asynchronous
collective (`async_op=True`, a `comm_spec.Pending`) that the interior
K1 does not wait on: under NCCL on the side stream, under gloo staged
through the host the device-to-host copy on the side stream and the
collective's work handle held, on the CPU the work handle held.  `join`
waits on the handle and the side stream's event and lands the buffer
the next round reads.
"""

from __future__ import annotations

import copy
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from libgrape_lite_tpu_torch.fragment.edgecut import (
    boundary_split,
    boundary_stats,
    device_cache,
    device_cache_filled,
)
from libgrape_lite_tpu_torch.obs.federation import FederatedStats
from libgrape_lite_tpu_torch.ops.calibration import active_profile
from libgrape_lite_tpu_torch.parallel.mirror import (
    auto_keeps_serial,
    exchange_bytes_ledger,
    pipelined_round_s,
)

# auto-mode floor (the JAX package's): below about 1 MiB an exchange is
# latency-bound and the split's extra launch loses
_MIN_BYTES_DEFAULT = 1 << 20

#: ops an edge takes in a pull round: a counting convention, not a rate
DEFAULT_OPS_PER_EDGE = 30.0

# ---- the pipeline window contract (grape-lint R6) --------------------------
#
# Between the kickoff and the join, the only reads of the query carry
# (or of the streams standing in for it) R6 permits are these names;
# an entry ending in "*" is a prefix.  Each read is safe because the
# kickoff writes a fresh double buffer and never aliases the live carry.
# A new read in the window is audited and named here.
PIPELINE_WINDOW_READS = frozenset({
    # live carry leaves the interior pulls fold against
    "dist", "depth", "comp",
    # CDLP's label plane (the join's fallback) and its label universe
    "labels", "lut",
    # the boundary mask (the join selector) and the interior K1 CSR
    "pl_bmask", "pl_i_indptr", "pl_i_nbr", "pl_i_w",
    # CDLP's interior edge rows (its mode fold groups by row)
    "pl_i_row",
    # the second direction of the directed double pull (WCC's oe leg):
    # both its parts fold inside the window the first kickoff opens
    "pl2_*",
    # the vertex cut's phase-1 K1 CSR, pulled while the phase-0 row
    # reduction runs on the side stream
    "pl_p1_*",
})

# Callees audited to receive the whole carry dict inside the window:
#   kickoff  PipelinePlan.kickoff -- reads only its send table (a static
#            host stream), never a live carry value; the directed double
#            pull issues a second kickoff inside the first's window
PIPELINE_WINDOW_CALLEES = frozenset({"kickoff"})

PIPELINE_STATS = FederatedStats("pipeline", {
    "resolved": 0,        # plans built (engaged)
    "declined": 0,        # structurally eligible but below threshold/off
    "last_decision": None,
    "last_stats": None,
})


def pipeline_mode() -> str:
    """off | auto | force, from GRAPE_PIPELINE (default off)."""
    v = os.environ.get("GRAPE_PIPELINE", "") or "0"
    if v in ("0", "", "off"):
        return "off"
    if v == "force":
        return "force"
    return "auto"  # "1", "auto", anything else truthy


def pipeline_min_bytes() -> int:
    v = os.environ.get("GRAPE_PIPELINE_MIN_BYTES", "")
    return int(v) if v else _MIN_BYTES_DEFAULT


def pipeline_min_hidden_us() -> float:
    """The auto mode's priced floor (µs of exchange hidden a round);
    default 0: the byte threshold alone decides."""
    v = os.environ.get("GRAPE_PIPELINE_MIN_HIDDEN_US", "")
    return float(v) if v else 0.0


def overlap_model(boundary_edges: int, interior_edges: int,
                  exchange_bytes: int, ops_per_edge: float | None = None,
                  profile=None, mode: str = "gather") -> dict:
    """The exchange-overlap term:

        t_serial    = compute_b + compute_i + exchange
        t_pipelined = max(compute_i, exchange) + compute_b

    priced from the rate profile (`ops/calibration.py`): compute from
    `ops_per_s`, the exchange from `exchange_bps[mode]`.  `hidden_frac`
    is min(compute_i, exchange) / exchange."""
    p = profile or active_profile()
    ope = DEFAULT_OPS_PER_EDGE if ops_per_edge is None else ops_per_edge
    t_b = boundary_edges * ope / p.ops_per_s
    t_i = interior_edges * ope / p.ops_per_s
    t_x = exchange_bytes / p.exchange_bps[mode]
    t_serial = t_b + t_i + t_x
    t_pipe = pipelined_round_s(t_i, t_x, t_b)
    hidden = min(t_i, t_x) / t_x if t_x > 0 else 0.0
    return {
        "t_serial_s": t_serial,
        "t_pipelined_s": t_pipe,
        "hidden_frac": round(hidden, 4),
        "round_speedup": round(t_serial / t_pipe, 4) if t_pipe > 0 else 1.0,
        "exchange_s": t_x,
        "compute_boundary_s": t_b,
        "compute_interior_s": t_i,
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _declined(decision: dict, app_name: str, why: str,
              count: bool = True) -> None:
    """Record a decline and its reason in PIPELINE_STATS; returns None
    (the unresolved plan)."""
    from libgrape_lite_tpu_torch.utils import logging as glog

    decision["reason"] = why
    PIPELINE_STATS["last_decision"] = decision
    if count:
        PIPELINE_STATS["declined"] += 1
        glog.vlog(1, "pipeline: declined for %s: %s", app_name, why)
    return None


class _PlanBrief:
    """The modeled overlap of a resolved plan (`stats` totals, its
    `exchange_bytes` and `mode`), as the query span and the truth meter
    read it."""

    def _model(self) -> dict:
        t = self.stats.get("totals", {})
        return overlap_model(t.get("boundary_edges", 0),
                             t.get("interior_edges", 0),
                             self.exchange_bytes, mode=self.mode)

    def span_brief(self) -> dict:
        """The query span's `pipeline` record (trace_report's overlap
        column and the truth meter read it)."""
        t = self.stats.get("totals", {})
        return {
            "engaged": True,
            "mode": self.mode,
            "plan_uid": self.uid,
            "exchange_bytes": self.exchange_bytes,
            "modeled_hidden_frac": self._model()["hidden_frac"],
            "hidden_us_per_round": self.hidden_us_per_round(),
            "boundary_vertices": t.get("boundary_vertices", 0),
            "interior_vertices": t.get("interior_vertices", 0),
            "boundary_edges": t.get("boundary_edges", 0),
            "interior_edges": t.get("interior_edges", 0),
        }

    def hidden_us_per_round(self) -> float:
        """Modeled exchange µs hidden under the interior pull a round:
        min(compute_interior, exchange)."""
        m = self._model()
        return round(min(m["compute_interior_s"], m["exchange_s"]) * 1e6, 3)


# ---- the side stream -------------------------------------------------------

_SIDE_STREAMS: dict = {}
_SIDE_LOCK = threading.Lock()


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The kickoff's CUDA stream on `device` (one a device, made at first
    use)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _SIDE_LOCK:
        s = _SIDE_STREAMS.get(index)
        if s is None:
            s = _SIDE_STREAMS[index] = torch.cuda.Stream(index)
        return s


def _tensors_of(out) -> list:
    """The tensors of a side-stream result: a tensor, a Pending's
    buffers, or a tuple of them."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return [t for o in out for t in _tensors_of(o)]
    tensors = getattr(out, "tensors", None)
    return list(tensors()) if tensors is not None else []


def run_on_side(fn, *inputs: torch.Tensor):
    """(fn(*inputs), event): on a CUDA device `fn` runs on the side
    stream after the work queued on the current stream, the inputs are
    marked as read there (`record_stream`, so the caching allocator
    keeps them until the side stream is done) and the output's tensors
    (a tensor, a Pending's buffers, or a tuple of them) as read on the
    current stream; the event marks the end of the side work.  On the
    CPU `fn` runs in place and the event is None."""
    dev = inputs[0].device
    if dev.type != "cuda":
        return fn(*inputs), None
    main = torch.cuda.current_stream(dev)
    side = side_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*inputs)
        done = torch.cuda.Event()
        done.record(side)
    for t in inputs:
        t.record_stream(side)
    for t in _tensors_of(out):
        if t.device.type == "cuda":
            t.record_stream(main)
    return out, done


def join(event) -> None:
    """The current stream waits for a side-stream event (no host sync);
    None (the CPU) is a no-op."""
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


# ---- the 1-D edge-cut pipeline ---------------------------------------------


@dataclass
class PipelinePlan(_PlanBrief):
    """One resolved boundary / interior pipeline for an app's pull.  The
    split K1 CSRs ride as ephemeral state leaves (`host_entries`, placed
    tensors); `exchange` / `kickoff` / `join` / `splice` are the round's
    exchange touchpoints."""

    mode: str                  # "mirror" | "gather"
    key: str                   # the exchanged carry leaf ("dist", ...)
    fnum: int
    vp: int
    m: int                     # mirror slots (0 in gather mode)
    send_key: str              # state key of the mirror send table
    stats: dict = field(default_factory=dict)
    exchange_bytes: int = 0
    decision: dict = field(default_factory=dict)
    host_entries: dict = field(default_factory=dict)
    # the second leg of the directed double pull (WCC's oe), or None
    mode2: Optional[str] = None
    send_key2: str = ""
    _pending: dict = field(default_factory=dict, repr=False)

    @property
    def uid(self) -> str:
        """Stable fingerprint of the plan's routing: the truth meter's
        join key (JAX `PipelinePlan.uid`; the pull is K1 here)."""
        return (f"{self.mode}:{self.fnum}:{self.vp}:{self.m}:k1:"
                f"{self.mode2 or '-'}")

    def _leg(self, leg: int):
        if leg == 2:
            if self.mode2 is None:
                raise ValueError("pipeline plan has no second leg")
            return self.mode2, self.send_key2
        return self.mode, self.send_key

    def exchange(self, ctx, x_local: torch.Tensor, state, leg: int = 1):
        """The exchange of `x_local`'s remotely read rows into a fresh
        buffer: the gathered state [N] (gather) or the received mirror
        rows [fnum, fnum * m] (mirror; the live local block is spliced
        in at read time).  Bitwise the serial round's remote values when
        the boundary rows of `x_local` are current."""
        mode, send_key = self._leg(leg)
        if mode == "mirror":
            return ctx.mirror_recv(x_local, state[send_key])
        return ctx.all_gather(x_local).clone()

    def kickoff(self, ctx, x_kick: torch.Tensor, state, leg: int = 1):
        """Start the next pull's exchange from the boundary-merged carry
        (new values at boundary rows; the other rows are never read
        remotely) on the side stream; `join(leg)` ends it.  Across ranks
        the exchange is an asynchronous collective and the buffer holds
        its values only after the join.  This call opens the window
        grape-lint R6 audits."""
        if ctx.spec is None:
            xbuf, self._pending[leg] = run_on_side(
                lambda x: self.exchange(ctx, x, state, leg), x_kick)
            return xbuf
        (xbuf, pend), event = run_on_side(
            lambda x: self._issue(ctx, x, state, leg), x_kick)
        self._pending[leg] = (event, pend)
        return xbuf

    def _issue(self, ctx, x_local: torch.Tensor, state, leg: int):
        """(buffer, Pending): `exchange` issued as an asynchronous
        collective across ranks."""
        mode, send_key = self._leg(leg)
        if mode == "mirror":
            return ctx.mirror_recv(x_local, state[send_key], async_op=True)
        return ctx.all_gather(x_local, async_op=True)

    def join(self, leg: int = 1) -> None:
        """The current stream waits for the leg's kickoff; across ranks
        the collective's handle is waited on and its buffer landed."""
        pending = self._pending.pop(leg, None)
        if isinstance(pending, tuple):
            event, pend = pending
            join(event)
            pend.wait()
        else:
            join(pending)

    @staticmethod
    def splice(x_local: torch.Tensor, xbuf: torch.Tensor) -> torch.Tensor:
        """The pull table of a round: the live local rows, then the
        buffered remote rows (the split CSRs' columns index this)."""
        return torch.cat([x_local.reshape(-1), xbuf.reshape(-1)])


def _split_streams(frag, bmask: np.ndarray, direction: str, mirror,
                   with_weights: bool, prefix: str,
                   with_rows: bool = False) -> dict:
    """The boundary (b) and interior (i) K1 CSRs of one pull, host arrays:
    `<prefix><part>_indptr` [fnum, vp + 1] int32 (the other part's rows
    empty), `_nbr` [fnum, Ep_part] int32 columns of the splice table,
    `_w` [fnum, Ep_part] when weighted, `_row` [fnum, Ep_part] int32
    local rows (pads on row vp) when asked for; Ep_part is the part's
    largest fragment rounded up to 128 (pads on column 0, never read by
    K1).  Each row keeps its edges in the original CSR order.

    Splice columns: a local pid (this fragment's) indexes the live half
    at its pid; a remote pid indexes the buffer half, N + pid in gather
    mode, N + f * fnum * m + (compact - vp) in mirror mode (fragment f's
    received rows, `nbr_compact`'s order).  Under a process group the
    arrays are the rank's slab (fragments fid_lo .. fid_lo + fl - 1)
    and N, the pid of a local column and f count from its first
    fragment."""
    fnum, vp = frag.fnum, frag.vp
    lo = getattr(frag, "fid_lo", 0)
    fl = getattr(frag, "fl", fnum)
    n = fl * vp
    csrs = frag.host_ie if direction == "ie" else frag.host_oe
    parts = {"b": [], "i": []}
    for f in range(lo, lo + fl):
        h = csrs[f]
        mask = h.edge_mask
        src = h.edge_src.astype(np.int64)
        nbr = h.edge_nbr.astype(np.int64)
        if mirror is not None:
            c = mirror.nbr_compact[f].astype(np.int64)
            cols = np.where(c < vp, (f - lo) * vp + c,
                            n + (f - lo) * fnum * mirror.m + (c - vp))
        else:
            cols = np.where(nbr // vp == f, nbr - lo * vp, n + nbr)
        is_b = mask & bmask[f][np.minimum(src, vp - 1)]
        for part, sel in (("b", is_b), ("i", mask & ~is_b)):
            idx = np.flatnonzero(sel)
            parts[part].append((
                src[idx],
                cols[idx].astype(np.int32),
                h.edge_w[idx] if with_weights else None,
            ))
    out = {prefix + "bmask": bmask[lo:lo + fl]}
    for part, shards in parts.items():
        cap = _round_up(max([len(s[1]) for s in shards] + [1]), 128)
        indptr = np.zeros((fl, vp + 1), dtype=np.int32)
        nbr_a = np.zeros((fl, cap), dtype=np.int32)
        w_a = (np.zeros((fl, cap), dtype=csrs[0].edge_w.dtype)
               if with_weights else None)
        row_a = np.full((fl, cap), vp, dtype=np.int32) if with_rows \
            else None
        for f, (rows, cols, w) in enumerate(shards):
            np.cumsum(np.bincount(rows, minlength=vp), out=indptr[f, 1:])
            nbr_a[f, :len(cols)] = cols
            if w_a is not None:
                w_a[f, :len(cols)] = w
            if row_a is not None:
                row_a[f, :len(rows)] = rows
        p = f"{prefix}{part}_"
        out[p + "indptr"] = indptr
        out[p + "nbr"] = nbr_a
        if w_a is not None:
            out[p + "w"] = w_a
        if row_a is not None:
            out[p + "row"] = row_a
    return out


#: fragment -> {stream key: placed tensors}
_STREAMS = device_cache()
#: fragment -> {split key: boundary stats} (host counts, O(E) to make)
_STATS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _split_stats(frag, bmask, directions, direction, direction2) -> dict:
    """`boundary_stats` of a pull (both pulls' edge totals added for the
    double pull, over the one joint mask), counted once per fragment;
    each call gets its own copy."""
    per = _STATS.setdefault(frag, {})
    key = (directions, direction, direction2)
    if key not in per:
        stats = boundary_stats(frag, bmask, direction)
        if direction2 is not None:
            stats2 = boundary_stats(frag, bmask, direction2)
            for part in ("boundary_edges", "interior_edges"):
                stats["totals"][part] = (stats["totals"].get(part, 0)
                                         + stats2["totals"].get(part, 0))
        per[key] = stats
    return copy.deepcopy(per[key])


def _placed_streams(frag, key: tuple, build, w_dtype) -> dict:
    """The split streams on the fragment's device, built once per
    fragment and key (a DEVICE_CACHES entry: `release_device` drops it)."""
    per = _STREAMS.setdefault(frag, {})
    if key not in per:
        placed = {}
        for k, v in build().items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k.endswith("_w") and w_dtype is not None:
                t = t.to(w_dtype)
            placed[k] = t.to(frag.device)
        per[key] = placed
        device_cache_filled()
    return per[key]


def resolve_pipeline(frag, *, app_name: str, key: str,
                     direction: str = "ie", mirror=None,
                     mx_prefix: str = "mx_", fold: str = "min",
                     with_weights: bool = False, w_dtype=None,
                     with_rows: bool = False,
                     eligible: bool = True, reason: str = "",
                     direction2: str | None = None, mirror2=None,
                     mx2_prefix: str = "mx_oe_"):
    """The superstep pipeline of one app's pull, or None (JAX
    `resolve_pipeline`).  `mirror` / `mirror2` are the app's resolved
    exchange plans, reused verbatim.  Every pull here is K1, the JAX
    package's pack counterpart, so a sum fold declines with the JAX
    reason.  `direction2` asks for the directed double pull (WCC: ie
    then oe a round) over the joint boundary mask of both directions,
    its second leg's CSRs under `pl2_`.  Declines land in
    PIPELINE_STATS["last_decision"] with their reason."""
    from libgrape_lite_tpu_torch.utils import logging as glog

    mode = pipeline_mode()
    prof = active_profile()
    decision = {"app": app_name, "mode": mode, "engaged": False,
                "profile": prof.label()}

    def declined(why: str, count: bool = True):
        return _declined(decision, app_name, why, count)

    if mode == "off":
        return declined("GRAPE_PIPELINE off", count=False)
    if not eligible:
        return declined(reason or "app declared ineligible")
    if frag.fnum <= 1:
        return declined("fnum==1: no exchange to overlap")
    if getattr(frag, "dyn_overlay", None) is not None:
        return declined("dyn overlay attached (pid-addressed reads)")
    if fold == "sum":
        # K1's merge path cuts long rows where the diagonal falls;
        # splitting the rows moves the cuts and regroups float sums
        return declined("sum fold over the K1 merge path is not "
                        "bit-stable under a split plan")

    xmode = "mirror" if mirror is not None else "gather"
    xbytes = exchange_bytes_ledger(
        frag.fnum, frag.vp, mirror.m if mirror is not None else None
    )[xmode] or 0
    xmode2 = None
    if direction2 is not None:
        xmode2 = "mirror" if mirror2 is not None else "gather"
        xbytes += exchange_bytes_ledger(
            frag.fnum, frag.vp, mirror2.m if mirror2 is not None else None
        )[xmode2] or 0
    decision["exchange_bytes"] = xbytes
    decision["min_bytes"] = pipeline_min_bytes()
    single = auto_keeps_serial(frag, prof) if mode == "auto" else None
    if single is not None:
        return declined(single)
    if mode == "auto" and xbytes < pipeline_min_bytes():
        return declined(
            f"modeled exchange bytes {xbytes} below threshold "
            f"{pipeline_min_bytes()} (latency-bound; set "
            "GRAPE_PIPELINE_MIN_BYTES or =force to override)")

    directions = (direction,) if direction2 is None \
        else (direction, direction2)
    bmask = boundary_split(frag, directions)
    stats = _split_stats(frag, bmask, directions, direction, direction2)
    m = mirror.m if mirror is not None else 0
    uid = f"{xmode}:{frag.fnum}:{frag.vp}:{m}:k1:{xmode2 or '-'}"

    min_hidden = pipeline_min_hidden_us()
    if mode == "auto" and min_hidden > 0:
        tot = stats["totals"]
        model = overlap_model(tot.get("boundary_edges", 0),
                              tot.get("interior_edges", 0), xbytes,
                              profile=prof, mode=xmode)
        hidden_us = min(model["compute_interior_s"],
                        model["exchange_s"]) * 1e6
        decision["modeled_hidden_us"] = round(hidden_us, 3)
        # grape-lint R12: the modeled claim carries its trace key
        decision["plan_uid"] = uid
        if hidden_us < min_hidden:
            return declined(
                f"modeled hidden exchange {hidden_us:.2f}us under profile "
                f"{prof.label()} is below the "
                f"GRAPE_PIPELINE_MIN_HIDDEN_US={min_hidden:g} floor")

    def build():
        out = _split_streams(frag, bmask, direction, mirror, with_weights,
                             "pl_", with_rows)
        if direction2 is not None:
            h2 = _split_streams(frag, bmask, direction2, mirror2,
                                with_weights, "pl2_", with_rows)
            h2.pop("pl2_bmask")  # one joint mask, under pl_
            out.update(h2)
        return out

    skey = (directions, direction,
            None if mirror is None else mirror.uid,
            None if mirror2 is None else mirror2.uid,
            with_weights, with_rows, str(w_dtype))
    host_entries = dict(_placed_streams(frag, skey, build, w_dtype))

    decision["engaged"] = True
    plan = PipelinePlan(
        mode=xmode, key=key, fnum=frag.fnum, vp=frag.vp, m=m,
        send_key=mx_prefix + "send", stats=stats, exchange_bytes=xbytes,
        decision=decision, host_entries=host_entries, mode2=xmode2,
        send_key2=mx2_prefix + "send",
    )
    decision["plan_uid"] = plan.uid  # the truth meter's join key
    PIPELINE_STATS["resolved"] += 1
    PIPELINE_STATS["last_decision"] = decision
    PIPELINE_STATS["last_stats"] = stats
    glog.vlog(1, "pipeline: engaged for %s (%s exchange, %d B/round, "
              "%d boundary / %d interior vertices)", app_name, xmode, xbytes,
              stats["totals"].get("boundary_vertices", 0),
              stats["totals"].get("interior_vertices", 0))
    return plan


# ---- the 2-D vertex-cut pipeline -------------------------------------------


@dataclass
class VC2DPipelinePlan(_PlanBrief):
    """The pipelined vertex-cut round: a static phase split of each
    tile's edges into two K1 CSRs over the concatenated tiles, so the
    phase-0 row reduction runs on the side stream while the phase-1 K1
    pulls:

      serial:     partial = K1(all edges); row_min
      pipelined:  p0 = K1(phase 0); r0 = row_min(p0)   <- side stream
                  p1 = K1(phase 1)                     <- overlaps it
                  join; r1 = row_min(p1); relax = min(r0, r1)

    min regroups exactly over disjoint edge sets, so the round is
    bit-equal to the serial one.  The round has no cross-round buffer:
    `pipeline_exchange` returns None."""

    k: int
    vc: int
    split: int                  # phase-0 edge slots a tile
    stats: dict = field(default_factory=dict)
    exchange_bytes: int = 0
    decision: dict = field(default_factory=dict)
    host_entries: dict = field(default_factory=dict)
    mode: str = "vc2d"
    _pending: object = field(default=None, repr=False)

    @property
    def uid(self) -> str:
        return f"vc2d:{self.k}:{self.vc}:{self.split}"

    def kickoff(self, ctx, partial: torch.Tensor) -> torch.Tensor:
        """ctx.row_min(partial) on the side stream (the phase-0 row
        reduction; across ranks its row-axis all_reduce issued
        asynchronously, valid after the join); `join` ends it."""
        if ctx.spec is None:
            out, self._pending = run_on_side(ctx.row_min, partial)
            return out
        pend, event = run_on_side(
            lambda p: ctx.row_min(p, async_op=True), partial)
        self._pending = (event, pend)
        return pend.out

    def join(self) -> None:
        pending, self._pending = self._pending, None
        if isinstance(pending, tuple):
            event, pend = pending
            join(event)
            pend.wait()
        else:
            join(pending)


def _phase_streams(frag, split: int, weighted: bool) -> dict:
    """The two phase CSRs of the ie tile CSR of the rank's tiles (host
    arrays, one stacked "fragment" each as K1 takes the tiles): an edge
    whose position in its tile's row-sorted range is below `split` is
    phase 0, every other edge phase 1; rows keep their edge order."""
    cat = frag._slab_csr("ie")
    vc = frag.vc
    n_rows = frag.grid.fl * vc
    e = int(cat.indptr[-1])
    rows = cat.edge_src[:e].astype(np.int64)
    pos = np.arange(e) - cat.indptr[(rows // vc) * vc]
    out = {}
    for p, sel in (("pl_p0_", pos < split), ("pl_p1_", pos >= split)):
        idx = np.flatnonzero(sel)
        indptr = np.zeros((1, n_rows + 1), dtype=np.int32)
        np.cumsum(np.bincount(rows[idx], minlength=n_rows),
                  out=indptr[0, 1:])
        cap = _round_up(max(len(idx), 1), 128)
        nbr = np.zeros((1, cap), dtype=np.int32)
        nbr[0, :len(idx)] = cat.edge_nbr[idx]
        out[p + "indptr"] = indptr
        out[p + "nbr"] = nbr
        if weighted:
            w = np.zeros((1, cap), dtype=cat.edge_w.dtype)
            w[0, :len(idx)] = cat.edge_w[idx]
            out[p + "w"] = w
    return out


def resolve_vc2d_pipeline(frag, *, app_name: str, src_pull: bool = False,
                          dtype_bytes: int = 4, weighted: bool = False,
                          w_dtype=None):
    """The pipelined vertex-cut round of a vc2d app, or None (JAX
    `resolve_vc2d_pipeline`, its gates and records but the per-tile pack
    plan, which this package does not have): k == 1 and the directed
    src pull (a dependent chain) decline, as does a tile ring too small
    to split in two 128-slot phases."""
    from libgrape_lite_tpu_torch.utils import logging as glog

    mode = pipeline_mode()
    prof = active_profile()
    decision = {"app": app_name, "mode": mode, "engaged": False,
                "profile": prof.label(), "plan": "vc2d"}

    def declined(why: str, count: bool = True):
        return _declined(decision, app_name, why, count)

    if mode == "off":
        return declined("GRAPE_PIPELINE off", count=False)
    k = int(frag.k)
    if k <= 1:
        return declined("k==1: the row-axis pmin is a no-op")
    if src_pull:
        return declined(
            "directed src-pull round: the column-axis pull consumes the "
            "transposed row relax -- a dependent chain with no "
            "independent fold to overlap")

    _, _, _, m_arr = frag._host_tiles
    ep = int(m_arr.shape[1])
    split = min(_round_up(max(ep // 2, 1), 128), ep)
    if split >= ep:
        return declined(f"tile edge ring too small to split ({ep} slots): "
                        "nothing to overlap")

    # the hideable reduction: one row-axis reduction of the [vc] partial
    vc = int(frag.vc)
    xbytes = int(vc * dtype_bytes * 2 * (k - 1) / k)
    decision["exchange_bytes"] = xbytes
    decision["min_bytes"] = pipeline_min_bytes()
    per = _STATS.setdefault(frag, {})
    if ("vc2d", split) not in per:  # O(tiles x Ep) host counts: once
        per["vc2d", split] = {"totals": {
            "boundary_edges": int(m_arr[:, :split].sum()),
            "interior_edges": int(m_arr[:, split:].sum()),
            "boundary_vertices": 0, "interior_vertices": 0,
            "phase_split": split, "edge_slots": ep,
        }}
    stats = copy.deepcopy(per["vc2d", split])
    e0 = stats["totals"]["boundary_edges"]
    e1 = stats["totals"]["interior_edges"]
    model = overlap_model(e0, e1, xbytes, profile=prof, mode="vc2d")
    hidden_us = min(model["compute_interior_s"], model["exchange_s"]) * 1e6
    decision["modeled_hidden_us"] = round(hidden_us, 3)
    # grape-lint R12: the modeled claim carries its trace key
    decision["plan_uid"] = f"vc2d:{k}:{vc}:{split}"

    single = auto_keeps_serial(frag, prof) if mode == "auto" else None
    if single is not None:
        return declined(single)
    if mode == "auto" and xbytes < pipeline_min_bytes():
        return declined(
            f"modeled pmin bytes {xbytes} below threshold "
            f"{pipeline_min_bytes()} (latency-bound; set "
            "GRAPE_PIPELINE_MIN_BYTES or =force to override)")
    min_hidden = pipeline_min_hidden_us()
    if mode == "auto" and min_hidden > 0 and hidden_us < min_hidden:
        return declined(
            f"modeled hidden pmin {hidden_us:.2f}us under profile "
            f"{prof.label()} is below the "
            f"GRAPE_PIPELINE_MIN_HIDDEN_US={min_hidden:g} floor")

    host_entries = dict(_placed_streams(
        frag, ("vc2d", split, weighted, str(w_dtype)),
        lambda: _phase_streams(frag, split, weighted), w_dtype))
    decision["engaged"] = True
    plan = VC2DPipelinePlan(k=k, vc=vc, split=split, stats=stats,
                            exchange_bytes=xbytes, decision=decision,
                            host_entries=host_entries)
    PIPELINE_STATS["resolved"] += 1
    PIPELINE_STATS["last_decision"] = decision
    PIPELINE_STATS["last_stats"] = stats
    glog.vlog(1, "pipeline: engaged vc2d for %s (k=%d, split %d/%d slots, "
              "%d B pmin/round)", app_name, k, split, ep, xbytes)
    return plan
