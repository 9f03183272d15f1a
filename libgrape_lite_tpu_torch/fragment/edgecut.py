"""Edge-cut fragments, stacked on one device.

Counterpart of `libgrape_lite_tpu/fragment/edgecut.py` (reference
`grape/fragment/immutable_edgecut_fragment.h:113-917`).  One Python
object describes all `fnum` fragments; device tensors are stacked
`[fnum, ...]` on a single device.  The per-fragment vertex capacity `vp`
is a power of two and the padded global id is `pid = fid * vp + lid`,
so the state of every fragment flattens to one pid-indexed vector.

Under a process group (`CommSpec.init_distributed`) every rank builds
the same host fragment -- the host CSRs, oids and vertex map stay whole
-- and places only its slab `[fid_lo, fid_lo + fl)` of every stacked
array on its device (`DeviceFragment.fl`, `fid_lo`; the JAX package's
`put_global` contract).  The padded edge width `Ep` stays the global
one, so every rank's shapes agree, and CSR columns stay global pids
into the gathered `[fnum * vp]` vector.

Undirected graphs store one symmetrised CSR and alias it as both the
in- and the out-CSR, as the JAX package does.  On `--string_id` graphs
the host keeps the `str` oids and the device's `oids` hold each vertex's
pid as a numeric surrogate, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import time
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from libgrape_lite_tpu_torch.graph.csr import CSR, build_csr
from libgrape_lite_tpu_torch.ops.calibration import default_profile
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec, resolve_device
from libgrape_lite_tpu_torch.utils.types import LoadStrategy
from libgrape_lite_tpu_torch.vertex_map.idxer import sorted_lookup
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

_LOG = logging.getLogger(__name__)
#: the budget off the card: the default rate profile's device memory
#: (one H100's data-sheet 80 GB)
_CPU_BUDGET_DEFAULT = default_profile().hbm_capacity_bytes

#: the per-fragment caches of device tensors derived from `dev` (the push
#: CSRs, `dest_degree`), each weak-keyed on the fragment: `release_device`
#: empties a fragment's entries, and fleet/budget.py prices them
DEVICE_CACHES: list = []
#: misses of those caches, each one building device tensors
#: (analysis/artifact.py's `build_events` counts them)
DEVICE_CACHE_FILLS = 0


def device_cache() -> "weakref.WeakKeyDictionary":
    """A new per-fragment cache of device tensors, registered in
    DEVICE_CACHES."""
    cache = weakref.WeakKeyDictionary()
    DEVICE_CACHES.append(cache)
    return cache


def device_cache_filled() -> None:
    """Count one fill of a DEVICE_CACHES entry."""
    global DEVICE_CACHE_FILLS
    DEVICE_CACHE_FILLS += 1


def device_budget_bytes(device) -> int:
    """The device byte budget: `GRAPE_HBM_BYTES` when set (0: no limit),
    else the card's free memory (`torch.cuda.mem_get_info`) on a CUDA
    device, else the default rate profile's `hbm_capacity_bytes`."""
    env = os.environ.get("GRAPE_HBM_BYTES")
    if env is not None:
        return int(env)
    if torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[0])
    return _CPU_BUDGET_DEFAULT


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


@dataclass
class DeviceCSR:
    """Stacked [fnum, ...] padded CSR on the device."""

    indptr: torch.Tensor  # [fnum, vp+1] int32
    edge_src: torch.Tensor  # [fnum, Ep] int32 (pad rows = vp)
    edge_nbr: torch.Tensor  # [fnum, Ep] int32 pid
    edge_w: Optional[torch.Tensor]  # [fnum, Ep] float or None
    edge_mask: torch.Tensor  # [fnum, Ep] bool


@dataclass
class DeviceFragment:
    """The device view of all fragments (JAX `DeviceFragment`)."""

    ivnum: torch.Tensor  # [fnum] int32 real inner vertex count
    inner_mask: torch.Tensor  # [fnum, vp] bool
    oids: torch.Tensor  # [fnum, vp] int64 original ids (pad = -1)
    oe: DeviceCSR
    ie: DeviceCSR
    out_degree: torch.Tensor  # [fnum, vp] int32
    in_degree: torch.Tensor  # [fnum, vp] int32
    fnum: int
    vp: int
    directed: bool
    total_vnum: int
    total_enum: int
    # the stacked fragments this device holds: [fid_lo, fid_lo + fl)
    # (all of them single-process)
    fl: int
    fid_lo: int

    @property
    def n_pad(self) -> int:
        return self.fnum * self.vp


_CSR_FIELDS = ("indptr", "edge_src", "edge_nbr", "edge_w", "edge_mask")


def _stack_csrs(csrs: list[CSR]) -> dict:
    return {
        "indptr": np.stack([c.indptr for c in csrs]),
        "edge_src": np.stack([c.edge_src for c in csrs]),
        "edge_nbr": np.stack([c.edge_nbr for c in csrs]),
        "edge_w": (None if csrs[0].edge_w is None
                   else np.stack([c.edge_w for c in csrs])),
        "edge_mask": np.stack([c.edge_mask for c in csrs]),
    }


def _unstack_csrs(stacked: dict, vp: int) -> list[CSR]:
    fnum = stacked["indptr"].shape[0]
    return [
        CSR(
            stacked["indptr"][f], stacked["edge_src"][f],
            stacked["edge_nbr"][f],
            None if stacked["edge_w"] is None else stacked["edge_w"][f],
            stacked["edge_mask"][f], vp, int(stacked["indptr"][f, -1]),
        )
        for f in range(fnum)
    ]


class ShardedEdgecutFragment:
    """Host-side descriptor of the full graph (all fragments) plus its
    stacked device tensors in `dev`."""

    def __init__(
        self,
        comm_spec: CommSpec,
        host_oe: list[CSR],
        host_ie: list[CSR],
        oids: np.ndarray,
        ivnum: np.ndarray,
        directed: bool,
        total_vnum: int,
        total_enum: int,
    ):
        self.comm_spec = comm_spec
        self.device = comm_spec.device
        self.host_oe = host_oe
        self.host_ie = host_ie
        oids = np.asarray(oids)
        # [fnum, vp]: int64, or str objects on string-keyed graphs (pad -1)
        self.host_oids = oids if oids.dtype == object else oids.astype(
            np.int64)
        self.host_ivnum = np.asarray(ivnum, dtype=np.int32)  # [fnum]
        self.directed = directed
        self.weighted = host_ie[0].edge_w is not None
        self.fnum = comm_spec.fnum
        # the slab this process places: every fragment single-process
        self.fl, self.fid_lo = comm_spec.fl, comm_spec.fid_lo
        self.vp = self.host_oids.shape[1]
        self._oid_index = None
        self.edge_list = None  # the oid edge list, when retained
        # the LoadGraphSpec a rebuild keeps (partitioner, idxer, edata
        # dtype), and the staged delta-edge overlay a DynGraph attaches
        self.load_spec = None
        self.dyn_overlay = None
        t0 = time.perf_counter()
        self.dev = self._to_device(total_vnum, total_enum)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.place_seconds = time.perf_counter() - t0  # host -> device

    # ---- FragmentBase API (fragment_base.h:50-133) ----

    @property
    def total_vertices_num(self) -> int:
        return self.dev.total_vnum

    @property
    def total_edges_num(self) -> int:
        return self.dev.total_enum

    def inner_vertices_num(self, fid: int) -> int:
        return int(self.host_ivnum[fid])

    def host_inner_mask(self) -> np.ndarray:
        """[fnum, vp] bool: True for real (non-padding) vertex rows."""
        return np.arange(self.vp)[None, :] < self.host_ivnum[:, None]

    def inner_oids(self, fid: int) -> np.ndarray:
        return self.host_oids[fid, : self.inner_vertices_num(fid)]

    def is_string_keyed(self) -> bool:
        """True when the vertex oids are strings (`--string_id` graphs)."""
        return self.host_oids.dtype == object

    def oid_to_pid(self, oids: np.ndarray) -> np.ndarray:
        """oid -> padded global id; -1 for unknown oids.  A string-keyed
        graph asked for a numeric id looks it up as text."""
        if self._oid_index is None:
            inner = self.host_inner_mask().reshape(-1)
            pids = np.nonzero(inner)[0].astype(np.int64)
            vals = self.host_oids.reshape(-1)[pids]
            order = np.argsort(vals, kind="stable")
            self._oid_index = (vals[order], pids[order])
        sorted_oids, pids = self._oid_index
        q = np.asarray(oids)
        if self.is_string_keyed():
            q = np.array([str(o) for o in q.tolist()], dtype=object)
        else:
            q = q.astype(np.int64)
        return sorted_lookup(sorted_oids, pids, q)

    def pid_to_oid(self, pids: np.ndarray) -> np.ndarray:
        return self.host_oids.reshape(-1)[np.asarray(pids)]

    # ---- eviction and re-admission (serve/) ----

    def release_device(self) -> bool:
        """Evict: drop the stacked device tensors (`dev`), the device
        caches derived from them (DEVICE_CACHES: push CSRs,
        `dest_degree`; rebuilt at their next use) and the overlay's
        placed planes.  The host CSRs, the vertex map and the host plans
        (strict, spgemm) stay, so `restore_device` places the same
        content again and plans nothing.  False when already released."""
        if self.dev is None:
            return False
        self._dev_meta = (self.dev.total_vnum, self.dev.total_enum)
        self.dev = None
        for cache in DEVICE_CACHES:
            cache.pop(self, None)
        if self.dyn_overlay is not None:
            self.dyn_overlay.drop_placed()
        return True

    def restore_device(self) -> bool:
        """Re-admission: place the device tensors from the host CSRs
        again.  False when already resident."""
        if self.dev is not None:
            return False
        self.dev = self._to_device(*self._dev_meta)
        return True

    # ---- construction ----

    @classmethod
    def build(
        cls,
        comm_spec: CommSpec,
        vertex_map: VertexMap,
        src_oid: np.ndarray,
        dst_oid: np.ndarray,
        weights: np.ndarray | None,
        directed: bool,
        load_strategy: LoadStrategy = LoadStrategy.kBothOutIn,
        edata_dtype=np.float32,
        retain_edge_list: bool = False,
    ) -> "ShardedEdgecutFragment":
        """Group edges by owner fragment and build padded CSRs
        (`ShardedEdgecutFragment.build` of the JAX package).
        `retain_edge_list` keeps the oid edge list on `edge_list`."""
        fnum = comm_spec.fnum
        total_vnum = vertex_map.total_vertex_num()
        max_ivnum = max(vertex_map.inner_vertex_num(f) for f in range(fnum))
        vp = _next_pow2(max(max_ivnum, 8))
        parser = vertex_map.id_parser

        def to_pid(oids):
            g = vertex_map.get_gid(oids)
            if (g < 0).any():
                bad = np.asarray(oids)[g < 0][:5]
                raise ValueError(
                    f"edge endpoint(s) not in vertex map, e.g. {bad}")
            f = parser.get_fid(g)
            lid = parser.get_lid(g)
            return f * vp + lid, f, lid

        edge_list = None
        if retain_edge_list:
            edge_list = (np.asarray(src_oid).copy(),
                         np.asarray(dst_oid).copy(),
                         None if weights is None
                         else np.asarray(weights).copy())
        src_pid, src_fid, src_lid = to_pid(src_oid)
        dst_pid, dst_fid, dst_lid = to_pid(dst_oid)
        real_enum = len(src_pid)
        if not directed:
            # symmetrise with multiplicity (csr_edgecut_fragment_base.h)
            src_pid, dst_pid = (np.concatenate([src_pid, dst_pid]),
                                np.concatenate([dst_pid, src_pid]))
            src_fid, dst_fid = (np.concatenate([src_fid, dst_fid]),
                                np.concatenate([dst_fid, src_fid]))
            src_lid, dst_lid = (np.concatenate([src_lid, dst_lid]),
                                np.concatenate([dst_lid, src_lid]))
            if weights is not None:
                weights = np.concatenate([weights, weights])

        need_oe = load_strategy in (
            LoadStrategy.kOnlyOut, LoadStrategy.kBothOutIn
        ) or (not directed and load_strategy == LoadStrategy.kOnlyIn)
        need_ie = directed and load_strategy in (
            LoadStrategy.kOnlyIn, LoadStrategy.kBothOutIn
        )
        oe_counts = np.bincount(src_fid, minlength=fnum)
        ie_counts = np.bincount(dst_fid, minlength=fnum)
        ep_oe = _round_up(max(int(oe_counts.max()), 1), 128) if need_oe else 128
        ep_ie = _round_up(max(int(ie_counts.max()), 1), 128) if need_ie else 128
        # every fragment pads to the most-loaded one's Ep: check the bill
        # fits the card and report skew before an opaque allocator error
        check_hbm_budget(
            comm_spec.device, vp, ep_oe, ep_ie, aliased=not directed,
            need_oe=need_oe, need_ie=need_ie, weighted=weights is not None,
            edata_itemsize=np.dtype(edata_dtype).itemsize,
            oe_counts=oe_counts if need_oe else None,
            ie_counts=ie_counts if need_ie else None,
        )

        w_np = None if weights is None else np.asarray(weights, edata_dtype)
        host_oe, host_ie = [], []
        for f in range(fnum):
            if need_oe:
                m = src_fid == f if fnum > 1 else slice(None)
                host_oe.append(build_csr(
                    src_lid[m], dst_pid[m], None if w_np is None else w_np[m],
                    vp, ep_oe,
                ))
            if need_ie:
                m = dst_fid == f if fnum > 1 else slice(None)
                host_ie.append(build_csr(
                    dst_lid[m], src_pid[m], None if w_np is None else w_np[m],
                    vp, ep_ie,
                ))
        if not need_oe:
            host_oe = host_ie
        if not need_ie:
            host_ie = host_oe

        ivnum = np.array(
            [vertex_map.inner_vertex_num(f) for f in range(fnum)], np.int32)
        oids = np.full((fnum, vp), -1, dtype=(
            object if vertex_map.is_string_keyed() else np.int64))
        for f in range(fnum):
            o = vertex_map.inner_oids(f)
            oids[f, : len(o)] = o
        frag = cls(comm_spec, host_oe, host_ie, oids, ivnum, directed,
                   total_vnum, real_enum)
        frag.edge_list = edge_list
        return frag

    def _device_oids(self) -> np.ndarray:
        """[fnum, vp] int64 oids for the device; string oids cannot live
        there, so a string-keyed graph stores each vertex's pid (pad -1)."""
        if not self.is_string_keyed():
            return self.host_oids
        pid = (np.arange(self.fnum, dtype=np.int64)[:, None] * self.vp
               + np.arange(self.vp, dtype=np.int64)[None, :])
        return np.where(self.host_inner_mask(), pid, -1)

    def _to_device(self, total_vnum: int, total_enum: int) -> DeviceFragment:
        """Place the stacked arrays of this process's slab (every
        fragment single-process) on the device."""
        dev = self.device
        lo, hi = self.fid_lo, self.fid_lo + self.fl

        def put(x, sliced=False):
            """One [fnum, ...] host array's slab on the device (`sliced`:
            already the slab)."""
            if x is None:
                return None
            x = np.ascontiguousarray(x if sliced else x[lo:hi])
            if not x.flags.writeable:  # e.g. a view of another framework's
                x = x.copy()           # buffer: torch wants writable memory
            return torch.from_numpy(x).to(dev)

        def put_csr(csrs):
            st = _stack_csrs(csrs[lo:hi])
            return DeviceCSR(*(put(st[k], True) for k in _CSR_FIELDS))

        aliased = self.host_ie is self.host_oe
        oe = put_csr(self.host_oe)
        ie = oe if aliased else put_csr(self.host_ie)
        out_degree = put(np.stack([c.degree for c in self.host_oe[lo:hi]])
                         .astype(np.int32), True)
        in_degree = out_degree if aliased else put(
            np.stack([c.degree for c in self.host_ie[lo:hi]])
            .astype(np.int32), True)
        return DeviceFragment(
            ivnum=put(self.host_ivnum),
            inner_mask=put(self.host_inner_mask()),
            oids=put(self._device_oids()),
            oe=oe,
            ie=ie,
            out_degree=out_degree,
            in_degree=in_degree,
            fnum=self.fnum,
            vp=self.vp,
            directed=self.directed,
            total_vnum=int(total_vnum),
            total_enum=int(total_enum),
            fl=self.fl,
            fid_lo=self.fid_lo,
        )


# ---- boundary / interior vertex split (parallel/pipeline.py) -------------
#
# A vertex of fragment f is *boundary* for a pull direction when some
# OTHER fragment's edges over that direction read it: its new value must
# travel in the exchange before the next round can run anywhere.  Every
# other vertex is *interior*, read only by its own fragment, so its pull
# can overlap the exchange in flight.  The read sets are the mirror
# request lists of parallel/mirror.py; the two must agree, or a
# pipelined kickoff would send stale rows.

_BOUNDARY_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def boundary_split(frag, directions=("ie",)) -> np.ndarray:
    """[fnum, vp] bool: True where the vertex is boundary for a pull over
    `directions` (JAX `fragment/edgecut.py::boundary_split`; cached per
    fragment and direction set).  Pad rows are never boundary."""
    per_frag = _BOUNDARY_CACHE.setdefault(frag, {})
    key = tuple(sorted(directions))
    if key in per_frag:
        return per_frag[key]
    fnum, vp = frag.fnum, frag.vp
    read = np.zeros((fnum, vp), dtype=bool)
    for d in key:
        csrs = frag.host_ie if d == "ie" else frag.host_oe
        for g in range(fnum):
            h = csrs[g]
            nbr = h.edge_nbr[h.edge_mask].astype(np.int64)
            owner = nbr // vp
            remote = owner != g
            read[owner[remote], nbr[remote] % vp] = True
    bmask = read & frag.host_inner_mask()
    per_frag[key] = bmask
    return bmask


def boundary_stats(frag, bmask: np.ndarray, direction: str = "ie") -> dict:
    """Per-fragment boundary and interior vertex and edge counts for one
    pull direction (JAX `boundary_stats`): an edge belongs to the part of
    its destination row, the row whose fold it feeds."""
    inner = frag.host_inner_mask()
    csrs = frag.host_ie if direction == "ie" else frag.host_oe
    per_frag = []
    for f in range(frag.fnum):
        h = csrs[f]
        is_b = bmask[f][h.edge_src[h.edge_mask]]
        bv = int(bmask[f].sum())
        per_frag.append({
            "boundary_vertices": bv,
            "interior_vertices": int(inner[f].sum()) - bv,
            "boundary_edges": int(is_b.sum()),
            "interior_edges": int(len(is_b) - is_b.sum()),
        })
    tot = {k: sum(p[k] for p in per_frag) for k in per_frag[0]} \
        if per_frag else {}
    return {"per_fragment": per_frag, "totals": tot, "direction": direction}


def check_hbm_budget(device, vp, ep_oe, ep_ie, aliased, need_oe, need_ie,
                     weighted, edata_itemsize, oe_counts=None,
                     ie_counts=None) -> int:
    """The fragment's device bytes, estimated as the JAX package's
    `_check_hbm_budget` does (`fragment/edgecut.py:468-510`); logs a
    warning past the budget and on partition skew above 1.5.  The budget
    is `device_budget_bytes(device)` (0 disables the check).  Returns
    the estimate."""
    budget = device_budget_bytes(device)

    def csr_bytes(ep):  # indptr + edge_src + edge_nbr + mask (+ weights)
        return (vp + 1) * 4 + ep * (4 + 4 + 1) + (
            ep * edata_itemsize if weighted else 0)

    per_dev = vp * (4 + 4 + 8 + 1)  # degrees, oids, inner_mask
    if aliased or not (need_oe and need_ie):
        sides = 1
        per_dev += csr_bytes(ep_oe if need_oe else ep_ie)
    else:
        sides = 2
        per_dev += csr_bytes(ep_oe) + csr_bytes(ep_ie)
    for name, counts, ep in (("oe", oe_counts, ep_oe),
                             ("ie", ie_counts, ep_ie)):
        if counts is None or len(counts) < 2:
            continue
        mean = max(float(counts.mean()), 1.0)
        skew = float(counts.max()) / mean
        if skew > 1.5:
            _LOG.warning(
                "partition skew: max/mean %s edges per shard = %.2f (%d vs "
                "%.0f); every shard pads to Ep=%d -- consider --rebalance "
                "or a hash partitioner", name, skew, int(counts.max()),
                mean, ep)
    if budget and per_dev > budget:
        def fmt(b):
            return (f"{b / (1 << 30):.2f} GiB" if b >= (1 << 30)
                    else f"{b / (1 << 20):.2f} MiB")

        _LOG.warning(
            "fragment needs ~%s (vp=%d, ep=%d, %d CSR side(s)) -- exceeds "
            "the %s device budget (GRAPE_HBM_BYTES); expect an allocator "
            "failure at this scale/partition", fmt(per_dev), vp,
            max(ep_oe, ep_ie), sides, fmt(budget))
    return per_dev


def fragment_from_numpy(arrays: dict, meta: dict,
                        device="cuda") -> ShardedEdgecutFragment:
    """Build the port's fragment from another fragment's leaves.

    `arrays` holds numpy arrays keyed by DeviceFragment field
    (`ivnum`, `inner_mask`, `oids`, `out_degree`, `in_degree`) and by
    DeviceCSR field under an `oe.` / `ie.` prefix (`oe.indptr`,
    `oe.edge_src`, `oe.edge_nbr`, `oe.edge_w`, `oe.edge_mask`); the `ie.`
    group may be left out, and the in-CSR then aliases the out-CSR, as
    on undirected graphs.  `meta` holds `fnum`, `vp`, `directed`,
    `total_vnum` and `total_enum`.  This carries a graph built by the
    JAX package (`np.asarray` of each leaf of its `DeviceFragment`)
    across unchanged, so both packages can run on identical bytes."""
    fnum, vp = int(meta["fnum"]), int(meta["vp"])
    comm_spec = CommSpec(fnum=fnum, device=resolve_device(device))

    def side(prefix):
        st = {k: arrays.get(f"{prefix}.{k}") for k in _CSR_FIELDS}
        st = {k: (None if v is None else np.asarray(v)) for k, v in st.items()}
        if st["indptr"].shape != (fnum, vp + 1):
            raise ValueError(
                f"{prefix}.indptr shape {st['indptr'].shape} != "
                f"({fnum}, {vp + 1})")
        return _unstack_csrs(st, vp)

    host_oe = side("oe")
    host_ie = side("ie") if "ie.indptr" in arrays else host_oe
    ivnum = np.asarray(arrays["ivnum"], dtype=np.int32)
    oids = np.asarray(arrays["oids"], dtype=np.int64)
    frag = ShardedEdgecutFragment(
        comm_spec, host_oe, host_ie, oids, ivnum, bool(meta["directed"]),
        int(meta["total_vnum"]), int(meta["total_enum"]),
    )
    if not np.array_equal(np.asarray(arrays["inner_mask"]),
                          frag.host_inner_mask()):
        raise ValueError("inner_mask disagrees with ivnum")
    return frag
