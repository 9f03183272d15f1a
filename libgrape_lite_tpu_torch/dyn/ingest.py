"""Live ingest: the delta overlay side-path and the DynGraph runtime.

Counterpart of `libgrape_lite_tpu/dyn/ingest.py`.  `DynGraph` pairs a
built fragment with a `DeltaBuffer` and decides, at every apply, between
two representations of the staged updates:

  * **overlay** -- additive-only deltas between known vertices become
    [fnum, capacity] side arrays (`DeltaOverlay`), attached to the
    fragment as `frag.dyn_overlay`.  Overlay-contracted apps (SSSP, BFS,
    WCC: `AppBase.dyn_overlay_support`) take them as ephemeral state and
    fold the extra edges into their pull reduction each round with one
    `overlay_fold` launch over the overlay's slots (ops/spmv.py: a
    segment min by `src` applied in place to the pull result) -- min is
    exact in any order, so the
    query result is bit-identical to a cold run on the rebuilt graph
    while the base CSR stays untouched.
  * **repack** -- everything else (ratio past the policy threshold,
    non-additive ops, unknown endpoints, slot overflow) folds the buffer
    into a rebuilt CSR (dyn/repack.py).

Applies happen between queries, so a delta never lands inside a running
query; a mid-query mutation goes through the MutationContext path
(`collect_mutations`, worker/worker.py) instead.

Under a process group every rank runs its own DynGraph over its copy of
the host fragment and stages the same ops in the same order: an apply
first compares the ranks' staged contents (a divergent rank raises on
every rank), the overlay build and a repack are host work every rank
repeats alike, and each rank places only its slab -- the overlay's
`[fl, capacity]` rows, the rebuilt fragment's `[fl, ...]` arrays.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from libgrape_lite_tpu_torch.dyn.delta import (
    DeltaBuffer,
    DeltaDivergenceError,
    DeltaOverflowError,
    DeltaSummary,
)
from libgrape_lite_tpu_torch.dyn.repack import RepackPolicy, repack_fragment
from libgrape_lite_tpu_torch.parallel.comm_spec import host_allgather

_LOG = logging.getLogger(__name__)


class _OverlaySide:
    """One pull direction's side arrays: [fnum, cap] slots."""

    def __init__(self, src, nbr, w, mask):
        self.src = src        # i32 local row (the vertex relaxed); pad = vp
        self.nbr = nbr        # i32 pid of the contributing neighbour; pad 0
        self.w = w            # f64 edge weight; pad 0
        self.mask = mask      # bool, True on the real slots


class DeltaOverlay:
    """Side-path for staged ADD edges.

    Slots are grouped by owner fragment and sorted by local row, so a
    row's slots are adjacent (the fold's warps reduce each run before
    one atomic).  Pad slots follow a fragment's real slots and route to
    the vp overflow row with mask False."""

    def __init__(self, fnum: int, vp: int, capacity: int,
                 ie: _OverlaySide, oe: _OverlaySide, count: int,
                 edata_dtype=np.float64):
        self.fnum = fnum
        self.vp = vp
        self.capacity = capacity
        self.ie = ie
        self.oe = oe
        self.count = count  # staged edges represented (0 = inert)
        # the weight type of the fragment's CSRs: overlay weights pass
        # through it as the rebuilt CSR's weights do
        self.edata_dtype = np.dtype(edata_dtype)
        self._placed = {}  # entries already on a device (see `placed`)

    @staticmethod
    def _edata_dtype(frag):
        return (frag.host_ie[0].edge_w.dtype if frag.weighted
                else np.float64)

    @classmethod
    def empty(cls, frag, capacity: int) -> "DeltaOverlay":
        side = cls._blank(frag.fnum, frag.vp, capacity)
        return cls(frag.fnum, frag.vp, capacity, side, side, 0,
                   cls._edata_dtype(frag))

    @staticmethod
    def _blank(fnum: int, vp: int, cap: int) -> _OverlaySide:
        return _OverlaySide(
            src=np.full((fnum, cap), vp, dtype=np.int32),
            nbr=np.zeros((fnum, cap), dtype=np.int32),
            w=np.zeros((fnum, cap), dtype=np.float64),
            mask=np.zeros((fnum, cap), dtype=bool),
        )

    @classmethod
    def build(cls, frag, adds: List[Tuple], capacity: int):
        """(overlay, None), or (None, reason) when the buffer cannot ride
        the side-path and must repack instead."""
        if not adds:
            return cls.empty(frag, capacity), None
        src_oid = np.asarray([a[0] for a in adds])
        dst_oid = np.asarray([a[1] for a in adds])
        w = np.asarray([a[2] for a in adds], dtype=np.float64)
        sp = frag.oid_to_pid(src_oid)
        dp = frag.oid_to_pid(dst_oid)
        if (sp < 0).any() or (dp < 0).any():
            return None, "edge endpoint(s) outside the vertex map"

        # pull orientations: the ie fold relaxes the DST row from the
        # SRC neighbour; undirected graphs symmetrise (both orientations,
        # as the CSR build does) and their oe aliases ie
        if frag.directed:
            ie_rows, ie_nbr, ie_w = dp, sp, w
            oe_rows, oe_nbr, oe_w = sp, dp, w
        else:
            ie_rows = np.concatenate([dp, sp])
            ie_nbr = np.concatenate([sp, dp])
            ie_w = np.concatenate([w, w])
            oe_rows, oe_nbr, oe_w = ie_rows, ie_nbr, ie_w

        def fill(rows, nbr, ww):
            side = cls._blank(frag.fnum, frag.vp, capacity)
            fid = rows // frag.vp
            lid = rows % frag.vp
            for f in range(frag.fnum):
                m = fid == f
                n = int(m.sum())
                if n > capacity:
                    return None
                order = np.argsort(lid[m], kind="stable")
                side.src[f, :n] = lid[m][order]
                side.nbr[f, :n] = nbr[m][order]
                side.w[f, :n] = ww[m][order]
                side.mask[f, :n] = True
            return side

        full = f"overlay capacity ({capacity} slots/fragment) exceeded"
        ie = fill(ie_rows, ie_nbr, ie_w)
        if ie is None:
            return None, full
        if frag.directed:
            oe = fill(oe_rows, oe_nbr, oe_w)
            if oe is None:
                return None, full
        else:
            oe = ie
        return cls(frag.fnum, frag.vp, capacity, ie, oe, len(adds),
                   cls._edata_dtype(frag)), None

    def entries(self, direction: str, weight_dtype=None,
                prefix: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Ephemeral state entries for one pull direction: keys
        `dyn_<dir>_{src,nbr,mask[,w]}`.  The weight column comes
        only with `weight_dtype` (BFS and WCC fold unweighted), cast
        first to the fragment's edata type and then to the app's."""
        side = self.ie if direction == "ie" else self.oe
        prefix = prefix if prefix is not None else f"dyn_{direction}_"
        out = {
            prefix + "src": side.src,
            prefix + "nbr": side.nbr,
            prefix + "mask": side.mask,
        }
        if weight_dtype is not None:
            out[prefix + "w"] = side.w.astype(self.edata_dtype).astype(
                weight_dtype)
        return out

    def placed(self, direction: str, weight_dtype, prefix: Optional[str],
               device, slab: Tuple[int, int] | None = None
               ) -> Dict[str, torch.Tensor]:
        """`entries` as tensors on `device`, copied there once: an overlay
        never changes after its build, so every query between two applies
        reuses the same device arrays instead of uploading the 4 MB row
        pointer again.  `slab` (fid_lo, fl) places only the rows of a
        rank's fragments, `[fl, capacity]` each (the slab rule of
        `comm_spec.is_slab`); `nbr` stays pids into the gathered
        `[fnum * vp]` state, which the fold reads."""
        lo, fl = slab if slab is not None else (0, self.fnum)
        key = (direction, None if weight_dtype is None
               else np.dtype(weight_dtype).str, prefix, str(device), lo, fl)
        if key not in self._placed:
            self._placed[key] = {
                k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + fl])).to(
                    device)
                for k, v in self.entries(direction, weight_dtype,
                                         prefix).items()}
        return dict(self._placed[key])

    def drop_placed(self) -> None:
        """Forget the device copies (`placed`): an evicted fragment's
        overlay holds no device memory; the next query places again."""
        self._placed.clear()


class DynGraph:
    """A built fragment, its delta buffer and the apply policy: the
    dynamic-graph runtime.

    Typical use::

        dg = DynGraph(frag)                 # frag built retain_edge_list=True
        dg.ingest([("a", 3, 9, 1.5)])       # stage and apply
        Worker(SSSP(), dg.fragment).query(source=0)   # sees the delta

    An empty overlay is attached from construction on (as in the JAX
    package); apps fold an overlay only while it holds staged edges."""

    def __init__(self, fragment, policy: RepackPolicy | None = None):
        self.policy = policy or RepackPolicy.from_env()
        self.fragment = fragment
        self.buffer = DeltaBuffer(capacity=self.policy.capacity)
        self.stats = {
            "ingested": 0, "overlay_applies": 0, "repacks": 0,
            "folded_ops": 0,
        }
        # the ops the last apply() acted on: a repack CLEARS the buffer,
        # so incremental seeding must use this snapshot (it rides in
        # every report as "delta" too), not summary()
        self.last_applied: Optional[DeltaSummary] = None
        self._attach(DeltaOverlay.empty(fragment, self.policy.capacity))

    def _attach(self, overlay: DeltaOverlay) -> None:
        self.fragment.dyn_overlay = overlay

    @property
    def overlay_count(self) -> int:
        ov = getattr(self.fragment, "dyn_overlay", None)
        return 0 if ov is None else ov.count

    def stage(self, ops) -> int:
        """Stage ops, folding at capacity: a chunk that would overflow
        the bounded buffer repacks the pending ops (a counted fold) and
        staging continues.  Batches larger than the capacity split into
        capacity-sized chunks with a fold between each."""
        ops = list(ops)
        total = 0
        cap = self.policy.capacity
        for lo in range(0, len(ops), cap):
            chunk = ops[lo:lo + cap]
            try:
                total += self.buffer.stage(chunk)
            except DeltaOverflowError:
                # buffer.stage is atomic, so nothing is half-staged: fold
                # the pending ops, then the chunk (<= capacity) fits
                self.apply(force_repack=True,
                           reason="delta buffer at capacity")
                total += self.buffer.stage(chunk)
        self.stats["ingested"] += total
        return total

    def ingest(self, ops, *, force_repack: bool = False) -> dict:
        """Stage `ops` and apply them."""
        staged = self.stage(ops)
        report = self.apply(force_repack=force_repack)
        report["staged"] = staged
        return report

    def summary(self) -> DeltaSummary:
        return self.buffer.summary()

    def fold_now(self, reason: str = "forced") -> dict:
        """Unconditional repack of the pending buffer (e.g. before a
        query by an app with no overlay contract)."""
        return self.apply(force_repack=True, reason=reason)

    def apply(self, *, force_repack: bool = False,
              reason: str = "") -> dict:
        """Apply the staged buffer.  Decision ladder: forced, then the
        policy ratio, then the overlay build (non-additive ops, unknown
        endpoints and slot overflow fall through to a repack).  Returns
        {mode, pending, delta_ratio, delta, reason[, folded]}.

        Under a process group every rank applies: the ranks' staged
        contents are compared first (`DeltaBuffer.digest` through
        `host_allgather`), and a rank that staged other ops than rank
        0 makes every rank raise DeltaDivergenceError, so no query
        computes on graphs that differ between ranks."""
        self._check_ranks_agree()
        ratio = self.buffer.delta_ratio(self.fragment.total_edges_num)
        delta = self.buffer.summary()
        self.last_applied = delta
        why = reason
        repack = force_repack
        if not repack and self.policy.should_repack(
            self.buffer, self.fragment
        ):
            repack = True
            why = (
                f"delta ratio {ratio:.4f} > threshold "
                f"{self.policy.threshold:g}"
            )
        overlay = None
        if not repack:
            if not self.buffer.additive_only:
                repack = True
                why = "non-additive ops cannot ride the min-fold overlay"
            else:
                overlay, build_reason = DeltaOverlay.build(
                    self.fragment, self.buffer.add_edges,
                    self.policy.capacity,
                )
                if overlay is None:
                    repack = True
                    why = build_reason

        if repack:
            rep = self._repack(why or "forced")
            rep["delta"] = delta
            return rep
        self._attach(overlay)
        self.stats["overlay_applies"] += 1
        _LOG.debug("dyn: overlay apply -- %d staged edge(s), ratio %.4f "
                   "(threshold %g)", self.buffer.n_edge_ops, ratio,
                   self.policy.threshold)
        return {
            "mode": "overlay",
            "pending": self.buffer.n_ops,
            "delta_ratio": ratio,
            "delta": delta,
            "reason": "below repack threshold",
        }

    def _check_ranks_agree(self) -> None:
        """Raise on every rank when the ranks of the fragment's process
        group staged different ops (one digest a rank, one exchange on
        the control plane); nothing to compare without a group."""
        spec = getattr(self.fragment, "comm_spec", None)
        if getattr(spec, "group", None) is None:
            return
        rows = host_allgather(self.buffer.digest())
        off = [r for r in range(rows.shape[0])
               if not np.array_equal(rows[r], rows[0])]
        if off:
            raise DeltaDivergenceError(
                f"rank(s) {off} of {rows.shape[0]} staged other delta ops "
                "than rank 0 (every rank must stage the same ops in the "
                "same order); nothing was applied")

    def _repack(self, why: str) -> dict:
        n = self.buffer.n_ops
        folded = repack_fragment(self.fragment, self.buffer)
        self.buffer.clear()
        self.fragment = folded
        self._attach(DeltaOverlay.empty(folded, self.policy.capacity))
        self.stats["repacks"] += 1
        self.stats["folded_ops"] += n
        _LOG.info("dyn: repack -- folded %d staged op(s) into a rebuilt "
                  "CSR (%s)", n, why)
        return {
            "mode": "repack",
            "pending": 0,
            "folded": n,
            "delta_ratio": 0.0,
            "reason": why,
        }


def broadcast_ingest(targets, ops, *, force_repack: bool = False) -> list:
    """Apply ONE delta chunk to every target (DynGraphs) in order.  The
    ops are materialised once, so a generator cannot feed target 0 a
    different stream than target 1; reports return in target order."""
    ops = list(ops)
    return [t.ingest(ops, force_repack=force_repack) for t in targets]


def overlay_state_entries(frag, direction: str, weight_dtype=None,
                          prefix: Optional[str] = None) -> Dict:
    """For an app's init_state: the fragment's overlay entries, as
    tensors on the fragment's device (the rank's `[fl, capacity]` rows
    under a process group), or {} when no overlay is attached or it
    holds no staged edge.  (The JAX
    package ships the empty overlay's masked slots too, to keep its
    compiled state structure; here an empty overlay would only cost an
    `overlay_fold` launch a round that folds nothing.)"""
    ov = getattr(frag, "dyn_overlay", None)
    if ov is None or ov.count == 0:
        return {}
    return ov.placed(direction, weight_dtype, prefix, frag.device,
                     slab=(getattr(frag, "fid_lo", 0),
                           getattr(frag, "fl", frag.fnum)))
