"""Tiled masked SpGEMM triangle credits (`GRAPE_LCC_BACKEND=spgemm`).

Counterpart of `libgrape_lite_tpu/ops/spgemm_pack.py`: the GraphBLAS
triangle-count formulation ``B = (A · Aᵀ) ∘ A`` over the degree-oriented
DAG.  The mask IS the oriented deduplicated edge list, so the host plan
enumerates mask edges and tiles the contraction dimension: the w-space
(list members) is compacted and popularity-sorted, then cut into 128-lane
K-tiles; the oriented adjacency ships as a packed bitmap
``[rows, n_ktiles * 4] uint32`` over that space; one work item is (mask
edge (v, u), K-tile k), emitted only where both rows have bits in tile k.

The planner is host numpy and its streams, ledger and stats are the JAX
planner's, bit for bit (`plan_spgemm`, `plan_spgemm_edges`).  The JAX
package runs the credit pass in XLA, not Pallas, so its port is torch
ops on the device (`spgemm_credits`): per block of items gather the two
packed rows' 4 words, expand them to [block, 128] bits, AND them and mask
by `valid`, take `cnt` as the row sum, credit `cnt` to the apex and the
middle pid and the hit bits to the tile's far-end pids (`colpid`).  Every
scatter is an int32 `index_add_`, so the result does not depend on
order, and per-vertex triangle counts are integer-identical to the
intersect backend (the same 3-credit algebra over the same oriented
edges).

`GRAPE_LCC_BACKEND` = intersect | spgemm | auto selects the LCC backend
(`resolve_lcc_backend`); `auto` prices both ledgers at the active rate
profile (`ops/calibration.py`: the H100 data sheet unless
GRAPE_RATE_PROFILE installs a fitted one; `H100_RATES` reads the data
sheet's two rates).  Every decision and every decline is
recorded in `SPGEMM_STATS`, never silent.  Plans are memoized per
fragment and, under `GRAPE_PACK_PLAN_CACHE`, in an npz disk cache whose
file names are the JAX package's.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import tempfile
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from libgrape_lite_tpu_torch.obs.federation import FederatedStats
from libgrape_lite_tpu_torch.ops import calibration

_LOG = logging.getLogger(__name__)
_DATASHEET = calibration.default_profile()

C = 128          # lane width == K-tile width (one [128,128]-bit tile)
WPT = C // 32    # uint32 words per bitmap row per K-tile

# modeled per-item op counts (counting conventions, shared with the
# independent recount in scripts/pack_cost_model.spgemm_recount — a
# drift here must trip the 5% gate there, so do not import these from
# the recount side):
#   * expand: 6 plane-rows of 128 lanes (two operands x shift / mask /
#     lane-select of the 4 packed words into the dense uint8 block);
#   * mask_and: 2 planes (the AND and the item-validity select);
#   * far_scatter: 1 plane (the [128]-lane hit-vector scatter-add);
#   * tail: 1 plane (count cast + apex/middle scalar scatters, priced
#     at one plane per item — scalar work rides the vector epilogue);
#   * count-reduce: one 128-lane row sum per item, kept as the JAX
#     package's [chunk,128] @ [128,128] matmul row = 128 elements
#     (`mxu` column);
#   * gather_rows: 2 per item (the two packed bitmap row fetches).
_ITEM_VPU_PLANES = {"expand": 6, "mask_and": 2, "far_scatter": 1,
                    "tail": 1}
_ITEM_VPU = sum(_ITEM_VPU_PLANES.values())   # 10 planes x 128 lanes
_ITEM_MXU = C
_ITEM_GATHER_ROWS = 2

_SPGEMM_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class SpGemmConfig:
    """chunk = items per step of the JAX package's credit loop
    (GRAPE_SPGEMM_CHUNK overrides).  Part of the plan geometry: the item
    streams are padded to a chunk multiple."""

    chunk: int = 1024

    def __post_init__(self):
        if not (0 < self.chunk <= (1 << 20)):
            raise ValueError(
                f"chunk={self.chunk} not in (0, {1 << 20}]"
            )

    @staticmethod
    def from_env() -> "SpGemmConfig":
        spec = os.environ.get("GRAPE_SPGEMM_CHUNK", "")
        if not spec:
            return SpGemmConfig()
        try:
            return SpGemmConfig(chunk=int(spec))
        except ValueError as e:
            raise ValueError(
                f"GRAPE_SPGEMM_CHUNK={spec!r}: expected a positive int"
            ) from e


_PLAN_COUNTER = itertools.count()


@dataclass
class SpGemmPlan:
    """Static streams + ledger for one fragment's masked SpGEMM."""

    n_pad: int
    fnum: int
    vp: int
    n_ktiles: int                 # compacted-colspace tiles (K dim)
    words: int                    # uint32 words per bitmap row
    items: int                    # real work items across shards
    p_pad: int                    # per-shard padded item count
    rows_pad: int                 # per-shard padded bitmap height
    mask_edges: int               # kept oriented (dedup) edges
    orientation: str              # "lo" | "hi" (threshold forces hi)
    degree_threshold: int
    cfg: SpGemmConfig = field(default_factory=SpGemmConfig)
    # [fnum, ...] stacked host streams (None for plan_only plans)
    host_streams: dict | None = None
    ledger: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    uid: int = field(default_factory=lambda: next(_PLAN_COUNTER))


# stream-name -> dtype table (fingerprinted in the disk-cache digest,
# like spmv_pack._STREAM_DTYPES)
_SG_DTYPES = {
    "bm": "uint32", "vrow": "int32", "urow": "int32", "kt": "int32",
    "apex": "int32", "mid": "int32", "valid": "int8", "colpid": "int32",
}


def _ledger_from_counts(items: int, mask_edges: int, n_chunks: int,
                        hbm_bytes: int) -> dict:
    """The op-budget ledger under the conventions above (the JAX
    package's: split engine columns, per-stage attribution, one
    level)."""
    per_stage = {
        k: v * C * items for k, v in _ITEM_VPU_PLANES.items()
    }
    vpu = sum(per_stage.values())
    mxu = _ITEM_MXU * items
    gr = _ITEM_GATHER_ROWS * items
    totals = {
        "vpu_ops": vpu, "mxu_ops": mxu, "gather_rows": gr,
        "hbm_bytes": hbm_bytes, "blocks": n_chunks,
        "per_stage": per_stage,
    }
    return {
        "edges": mask_edges,
        "levels": [{
            "level": 0, "blocks": n_chunks, "has_gather": True,
            "vpu_ops": vpu, "mxu_ops": mxu, "gather_rows": gr,
            "hbm_bytes": hbm_bytes, "per_stage": per_stage,
        }],
        "totals": totals,
    }


def _oriented_mask_edges(frag, degree_threshold: int):
    """Host-side oriented dedup edge list in GLOBAL pids, matching
    models/lcc.py's `_oriented(..., toward_nbr=True)` rule exactly:

      * degree = out-degree incl. multiplicity (lcc_context degree);
      * dedup + self-loop drop (build_csr sorts, np.unique here);
      * threshold > 0 keeps the reference's "hi" orientation (the
        filter semantics of lcc.h:234-243 are DEFINED on lower-degree
        neighbor lists: a filtered OWNER contributes no list) and
        drops rows of filtered owners;
      * threshold == 0 orients "lo" (toward the higher (deg, id)
        endpoint): triangle enumeration is orientation-agnostic, and
        under "lo" the compacted column space concentrates on hubs —
        fewer K-tiles, denser pruning.

    Returns (v, u, deg) with v, u int64 pid arrays row-major sorted.
    """
    fnum, vp = frag.fnum, frag.vp
    n_pad = fnum * vp
    deg = np.zeros(n_pad, dtype=np.int64)
    vs, us = [], []
    for f in range(fnum):
        h = frag.host_oe[f]
        deg[f * vp:(f + 1) * vp] = np.diff(h.indptr)
        e = h.num_edges
        vs.append(f * vp + np.asarray(h.edge_src[:e], dtype=np.int64))
        us.append(np.asarray(h.edge_nbr[:e], dtype=np.int64))
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)
    u = np.concatenate(us) if us else np.zeros(0, np.int64)
    keep = v != u
    v, u = v[keep], u[keep]
    if len(v):
        pairs = np.unique(np.stack([v, u], 1), axis=0)
        v, u = pairs[:, 0], pairs[:, 1]
    thr = int(degree_threshold)
    if thr > 0:
        k = (deg[u] < deg[v]) | ((deg[u] == deg[v]) & (u < v))
        k &= deg[v] <= thr
        orientation = "hi"
    else:
        k = (deg[u] > deg[v]) | ((deg[u] == deg[v]) & (u > v))
        orientation = "lo"
    return v[k], u[k], deg, orientation


def plan_spgemm(frag, degree_threshold: int = 0,
                cfg: SpGemmConfig | None = None,
                plan_only: bool = False) -> SpGemmPlan:
    """Build the static masked-SpGEMM plan for `frag`.

    `plan_only=True` computes geometry, item counts and the ledger
    without materializing the streams (what `auto`'s pricing needs)."""
    cfg = cfg or SpGemmConfig.from_env()
    fnum, vp = frag.fnum, frag.vp
    n_pad = fnum * vp
    v, u, deg, orientation = _oriented_mask_edges(frag, degree_threshold)
    return _plan_from_oriented(
        v, u, n_pad, fnum, vp, orientation, int(degree_threshold), cfg,
        plan_only,
    )


def plan_spgemm_edges(src, dst, n_vertices: int,
                      degree_threshold: int = 0,
                      cfg: SpGemmConfig | None = None,
                      plan_only: bool = True) -> SpGemmPlan:
    """Plan from a raw undirected edge list (no fragment build), for
    host-side harnesses.  Symmetrizes, dedups, drops self-loops and
    orients exactly like the fragment path (degree = symmetrized
    adjacency degree incl. multiplicity)."""
    cfg = cfg or SpGemmConfig.from_env()
    vp = -(-int(n_vertices) // C) * C
    a = np.concatenate([np.asarray(src, np.int64),
                        np.asarray(dst, np.int64)])
    b = np.concatenate([np.asarray(dst, np.int64),
                        np.asarray(src, np.int64)])
    keep = a != b
    a, b = a[keep], b[keep]
    deg = np.bincount(a, minlength=vp)
    if len(a):
        pairs = np.unique(np.stack([a, b], 1), axis=0)
        a, b = pairs[:, 0], pairs[:, 1]
    thr = int(degree_threshold)
    if thr > 0:
        k = (deg[b] < deg[a]) | ((deg[b] == deg[a]) & (b < a))
        k &= deg[a] <= thr
        orientation = "hi"
    else:
        k = (deg[b] > deg[a]) | ((deg[b] == deg[a]) & (b > a))
        orientation = "lo"
    return _plan_from_oriented(
        a[k], b[k], vp, 1, vp, orientation, thr, cfg, plan_only
    )


def _plan_from_oriented(v, u, n_pad, fnum, vp, orientation, thr,
                        cfg: SpGemmConfig, plan_only: bool) -> SpGemmPlan:
    E = len(v)
    # ---- compacted, popularity-sorted column (w) space ----
    colcnt = np.bincount(u, minlength=n_pad)
    cols = np.argsort(-colcnt, kind="stable")
    cols = cols[colcnt[cols] > 0]
    colmap = np.full(n_pad, -1, dtype=np.int64)
    colmap[cols] = np.arange(len(cols))
    n_ktiles = max(1, -(-len(cols) // C))
    words = n_ktiles * WPT

    # ---- bitmap row space: vertices with oriented out-edges ----
    rowcnt = np.bincount(v, minlength=n_pad)
    rows = np.flatnonzero(rowcnt > 0)
    rowmap = np.full(n_pad, -1, dtype=np.int64)
    rowmap[rows] = np.arange(len(rows))
    n_rows = max(1, len(rows))

    # ---- per-row K-tile incidence (u64 bitset) for pruning ----
    kt_of_u = colmap[u] // C
    kwords = (n_ktiles + 63) // 64
    ktbm = np.zeros((n_rows, kwords), dtype=np.uint64)
    rk = np.unique(rowmap[v] * n_ktiles + kt_of_u)
    rr, kk = rk // n_ktiles, rk % n_ktiles
    np.bitwise_or.at(
        ktbm, (rr, kk // 64),
        np.uint64(1) << (kk % 64).astype(np.uint64),
    )

    # items: per mask edge, the K-tiles where BOTH rows have bits
    # (u ∉ rowspace has no list -> no items; the edge contributes 0)
    vr_all = rowmap[v]
    ur_all = rowmap[u]
    has_u = ur_all >= 0
    items = 0
    items_by_fid = np.zeros(fnum, dtype=np.int64)
    item_e: list = []
    item_k: list = []
    step = max(1, (1 << 24) // max(n_ktiles, 1))
    sel = np.flatnonzero(has_u)
    for lo in range(0, len(sel), step):
        s = sel[lo:lo + step]
        both = ktbm[vr_all[s]] & ktbm[ur_all[s]]
        bits = (
            (both[:, :, None] >> np.arange(64, dtype=np.uint64)) & 1
        ).astype(bool).reshape(len(s), kwords * 64)[:, :n_ktiles]
        per_edge = bits.sum(axis=1).astype(np.int64)
        np.add.at(items_by_fid, (v[s] // vp).astype(np.int64), per_edge)
        if plan_only:
            items += int(per_edge.sum())
        else:
            ei, ki = np.nonzero(bits)
            items += len(ei)
            item_e.append(s[ei])
            item_k.append(ki.astype(np.int64))

    stats = {
        "mask_edges": E, "items": items,
        "items_per_edge": round(items / max(1, E), 3),
        "n_ktiles": n_ktiles, "colspace": int(len(cols)),
        "rowspace": int(len(rows)), "orientation": orientation,
    }

    if plan_only:
        # byte model mirrors the materialized layout: item streams pad
        # to the per-shard max; the stacked sub-bitmap is modeled at the
        # full height once (a lower bound: hub rows repeat across shards
        # in the materialized form)
        rows_pad = n_rows
        p_max = int(items_by_fid.max()) if fnum > 1 else items
        p_pad = max(cfg.chunk,
                    -(-max(1, p_max) // cfg.chunk) * cfg.chunk)
        hbm = (rows_pad * words * 4
               + fnum * p_pad * (5 * 4 + 1)
               + fnum * n_ktiles * C * 4)
        n_chunks = fnum * (p_pad // cfg.chunk)
        return SpGemmPlan(
            n_pad=n_pad, fnum=fnum, vp=vp, n_ktiles=n_ktiles,
            words=words, items=items, p_pad=p_pad, rows_pad=rows_pad,
            mask_edges=E, orientation=orientation, degree_threshold=thr,
            cfg=cfg, host_streams=None,
            ledger=_ledger_from_counts(items, E, n_chunks, hbm),
            stats=stats,
        )

    e_idx = (np.concatenate(item_e) if item_e
             else np.zeros(0, np.int64))
    k_idx = (np.concatenate(item_k) if item_k
             else np.zeros(0, np.int64))

    # ---- packed adjacency bitmap over the compacted colspace ----
    bm = np.zeros((n_rows, words), dtype=np.uint32)
    cw = colmap[u]
    np.bitwise_or.at(
        bm, (rowmap[v], (cw // 32).astype(np.int64)),
        (np.uint32(1) << (cw % 32).astype(np.uint32)),
    )

    # colspace block -> pid table (far-end credit scatter targets);
    # padding lanes hit the n_pad sink row
    colpid = np.full(n_ktiles * C, n_pad, dtype=np.int32)
    colpid[:len(cols)] = cols.astype(np.int32)

    # ---- partition items by apex fragment, build per-shard streams ----
    fid_of = (v[e_idx] // vp).astype(np.int64) if len(e_idx) else \
        np.zeros(0, np.int64)
    per_shard = [np.flatnonzero(fid_of == f) for f in range(fnum)]
    p_real = [len(s) for s in per_shard]
    p_max = max([1] + p_real)
    p_pad = -(-p_max // cfg.chunk) * cfg.chunk

    sub_rows = []
    for f in range(fnum):
        s = per_shard[f]
        need = np.unique(np.concatenate([
            vr_all[e_idx[s]], ur_all[e_idx[s]],
        ])) if len(s) else np.zeros(0, np.int64)
        sub_rows.append(need)
    rows_pad = max(1, max(len(r) for r in sub_rows))

    st = {
        "bm": np.zeros((fnum, rows_pad, words), np.uint32),
        "vrow": np.zeros((fnum, p_pad), np.int32),
        "urow": np.zeros((fnum, p_pad), np.int32),
        "kt": np.zeros((fnum, p_pad), np.int32),
        "apex": np.full((fnum, p_pad), n_pad, np.int32),
        "mid": np.full((fnum, p_pad), n_pad, np.int32),
        "valid": np.zeros((fnum, p_pad), np.int8),
        "colpid": np.tile(colpid, (fnum, 1)),
    }
    for f in range(fnum):
        s = per_shard[f]
        if not len(s):
            continue
        need = sub_rows[f]
        local = np.full(n_rows, 0, dtype=np.int64)
        local[need] = np.arange(len(need))
        st["bm"][f, :len(need)] = bm[need]
        n = len(s)
        ei = e_idx[s]
        st["vrow"][f, :n] = local[vr_all[ei]].astype(np.int32)
        st["urow"][f, :n] = local[ur_all[ei]].astype(np.int32)
        st["kt"][f, :n] = k_idx[s].astype(np.int32)
        st["apex"][f, :n] = v[ei].astype(np.int32)
        st["mid"][f, :n] = u[ei].astype(np.int32)
        st["valid"][f, :n] = 1

    hbm = sum(int(a.nbytes) for a in st.values())
    n_chunks = fnum * (p_pad // cfg.chunk)
    stats["item_imbalance"] = round(
        p_max / max(1.0, items / max(1, fnum)), 3
    )
    return SpGemmPlan(
        n_pad=n_pad, fnum=fnum, vp=vp, n_ktiles=n_ktiles, words=words,
        items=items, p_pad=p_pad, rows_pad=rows_pad, mask_edges=E,
        orientation=orientation, degree_threshold=thr, cfg=cfg,
        host_streams=st,
        ledger=_ledger_from_counts(items, E, n_chunks, hbm),
        stats=stats,
    )


# --------------------------------------------------------------------------
# the credit pass on the device
# --------------------------------------------------------------------------

#: items per device step: a whole number of plan chunks, [block, 128]
#: int32 working sets of 128 MiB
_BLOCK_ITEMS = 1 << 18


def spgemm_credits(streams: dict, n_pad: int, chunk: int) -> torch.Tensor:
    """[n_pad] int32 triangle credits of every fragment's items.

    `streams` holds the plan's [fnum, ...] streams as tensors on one
    device (`bm` as int32, the bit pattern of the plan's uint32 words).
    Per block of items: gather the two packed rows' K-tile words, expand
    them to [block, 128] bits, AND them and mask by `valid`, take `cnt` as
    the row sum, credit `cnt` to the apex and the middle pid and the hit
    bits to the tile's far-end pids.  Fragments fold by summing into one
    vector (the JAX package's psum); pads credit the sink row n_pad."""
    bm, vrow, urow, kt = (streams[k] for k in ("bm", "vrow", "urow", "kt"))
    apex, mid, valid, colpid = (streams[k] for k in
                                ("apex", "mid", "valid", "colpid"))
    dev = vrow.device
    fnum, p = vrow.shape
    block = max(chunk, _BLOCK_ITEMS // chunk * chunk)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    wiota = torch.arange(WPT, dtype=torch.int64, device=dev)
    liota = torch.arange(C, dtype=torch.int64, device=dev)
    cred = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev)
    for f in range(fnum):
        for lo in range(0, p, block):
            sl = slice(lo, min(p, lo + block))
            k = kt[f, sl].long()
            wcol = k[:, None] * WPT + wiota[None, :]
            vw = bm[f][vrow[f, sl].long()[:, None], wcol]  # [b, WPT] words
            uw = bm[f][urow[f, sl].long()[:, None], wcol]
            # bit (w, s) of the tile is lane 32 w + s (an arithmetic
            # shift keeps bit s of the word at bit 0)
            both = ((vw & uw).unsqueeze(-1) >> shifts) & 1
            hits = both.reshape(-1, C) * valid[f, sl].to(torch.int32)[:, None]
            cnt = hits.sum(1, dtype=torch.int32)
            cred.index_add_(0, apex[f, sl].long(), cnt)
            cred.index_add_(0, mid[f, sl].long(), cnt)
            far = colpid[f][k[:, None] * C + liota[None, :]]
            cred.index_add_(0, far.reshape(-1).long(), hits.reshape(-1))
    return cred[:n_pad]


# --------------------------------------------------------------------------
# dispatch resolution: per-fragment memo + persistent plan cache
# --------------------------------------------------------------------------

_FRAG_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _frag_cache(frag) -> dict:
    return _FRAG_PLANS.setdefault(frag, {})


class SpGemmDispatch:
    """The resolved spgemm backend of one fragment: the plan, and its
    streams as state entries (`prefix` + stream name) that the worker
    places on the device."""

    def __init__(self, plan: SpGemmPlan, prefix: str = "sg_"):
        self.plan = plan
        self.prefix = prefix

    @property
    def chunk(self) -> int:
        return self.plan.cfg.chunk

    def state_entries(self, fid_lo: int = 0, fl: int | None = None) -> dict:
        """The streams as state entries: the rows `fid_lo .. fid_lo + fl
        - 1` of each [fnum, ...] stream (every fragment by default; a
        rank's slab under a process group -- the items whose apex is
        one of its rows)."""
        if self.plan.host_streams is None:
            raise ValueError("a plan_only plan has no streams")
        hi = self.plan.fnum if fl is None else fid_lo + fl
        out = {}
        for k, v in self.plan.host_streams.items():
            v = v[fid_lo:hi]
            if k == "bm":  # torch has no uint32 bitwise ops: same bits
                v = v.view(np.int32)
            out[self.prefix + k] = v
        return out

    def credits(self, state: dict) -> torch.Tensor:
        """[n_pad] int32 pid-indexed credits of the items in `state`
        (under a process group, this rank's share: fold them across
        ranks)."""
        streams = {k: state[self.prefix + k] for k in _SG_DTYPES}
        return spgemm_credits(streams, self.plan.n_pad, self.chunk)


def resolve_spgemm_dispatch(frag, degree_threshold: int = 0,
                            cfg: SpGemmConfig | None = None,
                            prefix: str = "sg_") -> SpGemmDispatch:
    """The spgemm plan of `frag`: the per-fragment memo first, then the
    disk cache (`GRAPE_PACK_PLAN_CACHE`), then the host planner; the
    counters in SPGEMM_STATS say which."""
    cfg = cfg or SpGemmConfig.from_env()
    per_frag = _frag_cache(frag)
    key = ("spgemm", cfg, int(degree_threshold))
    if key in per_frag:
        SPGEMM_STATS["frag_cache_hits"] += 1
        return SpGemmDispatch(per_frag[key], prefix)
    v, u, deg, orientation = _oriented_mask_edges(frag, degree_threshold)
    plan = _load_cached_plan(v, u, frag, degree_threshold, cfg)
    if plan is not None:
        SPGEMM_STATS["disk_cache_hits"] += 1
    else:
        SPGEMM_STATS["planned"] += 1
        plan = _plan_from_oriented(
            v, u, frag.fnum * frag.vp, frag.fnum, frag.vp, orientation,
            int(degree_threshold), cfg, plan_only=False,
        )
        _save_cached_plan(plan, v, u, frag, degree_threshold, cfg)
    per_frag[key] = plan
    return SpGemmDispatch(plan, prefix)


def _stable_config_digest(obj) -> str:
    """sha256 of canonical JSON (the JAX package's
    `ft/fingerprint.py::stable_config_digest`)."""
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


def _spgemm_digest(v, u, frag, thr: int, cfg: SpGemmConfig) -> str:
    """Content key of a cached plan; the JAX package's, so both
    packages name one plan's file alike."""
    fp = _stable_config_digest({
        "backend": "spgemm",
        "schema": _SPGEMM_SCHEMA_VERSION,
        "chunk": cfg.chunk,
        "thr": int(thr),
        "fnum": frag.fnum,
        "vp": frag.vp,
        "stream_dtypes": _SG_DTYPES,
    })
    h = hashlib.sha256()
    h.update(fp.encode())
    h.update(np.ascontiguousarray(v, np.int64).tobytes())
    h.update(np.ascontiguousarray(u, np.int64).tobytes())
    return h.hexdigest()[:24]


def _plan_cache_path(v, u, frag, thr, cfg):
    root = os.environ.get("GRAPE_PACK_PLAN_CACHE")
    if not root:
        return None
    return os.path.join(
        root, f"spgemmplan_{_spgemm_digest(v, u, frag, thr, cfg)}.npz")


def _save_cached_plan(plan: SpGemmPlan, v, u, frag, thr, cfg):
    path = _plan_cache_path(v, u, frag, thr, cfg)
    if path is None or plan.host_streams is None:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {
        "n_pad": plan.n_pad, "fnum": plan.fnum, "vp": plan.vp,
        "n_ktiles": plan.n_ktiles, "words": plan.words,
        "items": plan.items, "p_pad": plan.p_pad,
        "rows_pad": plan.rows_pad, "mask_edges": plan.mask_edges,
        "orientation": plan.orientation,
        "degree_threshold": plan.degree_threshold,
        "chunk": plan.cfg.chunk,
        "ledger": plan.ledger, "stats": plan.stats,
    }
    # a temporary name of this process's own: ranks that share the cache
    # directory each write theirs and rename it over the same plan
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta=np.frombuffer(json.dumps(meta).encode(),
                                             dtype=np.uint8).copy(),
                     **plan.host_streams)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_cached_plan(v, u, frag, thr, cfg) -> SpGemmPlan | None:
    path = _plan_cache_path(v, u, frag, thr, cfg)
    if path is None or not os.path.exists(path):
        return None
    try:
        z = np.load(path)  # no pickle: object arrays are refused
        meta = json.loads(bytes(z["__meta"]))
        if meta["chunk"] != cfg.chunk:
            return None
        streams = {k: z[k] for k in z.files if k != "__meta"}
        return SpGemmPlan(
            n_pad=meta["n_pad"], fnum=meta["fnum"], vp=meta["vp"],
            n_ktiles=meta["n_ktiles"], words=meta["words"],
            items=meta["items"], p_pad=meta["p_pad"],
            rows_pad=meta["rows_pad"], mask_edges=meta["mask_edges"],
            orientation=meta["orientation"],
            degree_threshold=meta["degree_threshold"], cfg=cfg,
            host_streams=streams, ledger=meta["ledger"],
            stats=meta["stats"],
        )
    except (OSError, ValueError, KeyError):
        return None  # a corrupt or stale entry is planned again


# --------------------------------------------------------------------------
# backend selection + stats
# --------------------------------------------------------------------------

#: resolve counters and the bounded decision / decline records: every
#: backend request that does not engage spgemm leaves a record here;
#: federated as "spgemm"
SPGEMM_STATS = FederatedStats("spgemm", {
    "planned": 0, "frag_cache_hits": 0, "disk_cache_hits": 0,
    "auto_spgemm": 0, "auto_intersect": 0,
    "declines": [], "decisions": [],
})
_STATS_CAP = 64

#: the data-sheet rates `auto` prices at when no profile is installed,
#: read from the default profile (ops/calibration.py)
H100_RATES = {"label": _DATASHEET.label(), "ops_per_s": _DATASHEET.ops_per_s,
              "bytes_per_s": _DATASHEET.hbm_bps}


def _record(kind: str, rec: dict):
    lst = SPGEMM_STATS[kind]
    if len(lst) >= _STATS_CAP:
        del lst[0]
    lst.append(rec)


def record_decline(app: str, reason: str, requested: str):
    """A backend request that falls back to intersect: recorded and
    logged, never silent."""
    _record("declines", {"app": app, "reason": reason,
                         "requested": requested})
    _LOG.info("spgemm backend declined for %s (requested %s): %s",
              app, requested, reason)


def lcc_backend_mode() -> str:
    mode = os.environ.get("GRAPE_LCC_BACKEND", "intersect")
    if mode not in ("intersect", "spgemm", "auto"):
        raise ValueError(
            f"GRAPE_LCC_BACKEND={mode!r}: expected 'intersect', "
            "'spgemm' or 'auto'")
    return mode


def intersect_ledger(frag, chunk: int) -> dict:
    """Modeled cost of the intersect backend on this fragment's geometry
    (the JAX package's model: per ring step every padded oe and ie chunk
    slot pays 3 word-ops per bitmap word over n_pad/32 words)."""
    ep_oe = len(frag.host_oe[0].edge_src)
    ep_ie = len((frag.host_ie or frag.host_oe)[0].edge_src)
    return intersect_ledger_geom(
        frag.fnum * frag.vp, ep_oe, ep_ie, frag.fnum, frag.vp, chunk)


def intersect_ledger_geom(n_pad: int, ep_oe: int, ep_ie: int,
                          fnum: int, vp: int, chunk: int) -> dict:
    """`intersect_ledger` on raw geometry (no fragment)."""
    words = (n_pad + 31) // 32
    c_oe = max(1, min(chunk, ep_oe))
    c_ie = max(1, min(chunk, ep_ie))
    slots = (max(1, -(-ep_oe // c_oe)) * c_oe
             + max(1, -(-ep_ie // c_ie)) * c_ie)
    word_ops = fnum * fnum * slots * 3 * words
    hbm = fnum * (2 * vp * words * 4)
    return {
        "word_ops": word_ops,
        "word_ops_per_edge": round(word_ops / max(1, fnum * ep_oe), 1),
        "hbm_bytes": hbm,
        "words": words,
        "chunk": chunk,
    }


def price_backends(spgemm_ledger: dict, intersect: dict,
                   profile=None) -> dict:
    """Modeled seconds of both backends at `profile` (default: the active
    RateProfile), each max(compute, bytes / hbm_bps) with the columns of
    `calibration.spgemm_columns` / `intersect_columns`: spgemm's compute is
    its ops over ops_per_s plus its gather rows over gather_per_s.  Gather
    rows are priced in op equivalents, so at the data sheet (gather rows
    at the op rate) the sums are the ones priced before profiles existed,
    bit for bit."""
    p = profile or calibration.active_profile()
    sg = calibration.spgemm_columns(spgemm_ledger)
    it = calibration.intersect_columns(intersect)
    t_sp = max((sg["ops"] + sg["gather_rows"] * (p.ops_per_s
                                                 / p.gather_per_s))
               / p.ops_per_s, sg["hbm_bytes"] / p.hbm_bps)
    t_it = max(it["ops"] / p.ops_per_s, it["hbm_bytes"] / p.hbm_bps)
    return {"t_spgemm_s": t_sp, "t_intersect_s": t_it,
            "spgemm_wins": bool(t_sp < t_it), "profile": p.label()}


def resolve_lcc_backend(app_name: str, frag, degree_threshold: int = 0,
                        chunk: int = 4096, supported: bool = True,
                        unsupported_reason: str = "") -> str:
    """The GRAPE_LCC_BACKEND resolution an LCC-family app runs at
    init_state: "intersect" or "spgemm", every non-intersect request's
    outcome recorded in SPGEMM_STATS.  `supported=False` (lcc_beta's
    merge intersection, lcc_directed's direction-weighted counts)
    always yields intersect, with a recorded decline, and so does a
    fragment with a staged delta overlay attached (dyn/).  `chunk` is the
    intersect model's edge chunk (the JAX package's GRAPE_LCC_CHUNK
    default)."""
    mode = lcc_backend_mode()
    if mode == "intersect":
        return "intersect"
    if not supported:
        record_decline(app_name, unsupported_reason
                       or "app has no spgemm lowering", mode)
        return "intersect"
    if getattr(frag, "dyn_overlay", None) is not None:
        record_decline(
            app_name,
            "dyn overlay attached: the host-planned bitmap would go "
            "stale against staged deltas", mode)
        return "intersect"
    if mode == "spgemm":
        _record("decisions", {"app": app_name, "mode": mode,
                              "backend": "spgemm"})
        return "spgemm"
    # auto: price both ledgers; the pricing plan is memoized per
    # fragment, and an engaged plan is reused
    cfg = SpGemmConfig.from_env()
    per_frag = _frag_cache(frag)
    plan = per_frag.get(("spgemm", cfg, int(degree_threshold)))
    if plan is None:
        price_key = ("spgemm-price", cfg, int(degree_threshold))
        plan = per_frag.get(price_key)
        if plan is None:
            plan = plan_spgemm(frag, degree_threshold, cfg=cfg,
                               plan_only=True)
            per_frag[price_key] = plan
    prices = price_backends(plan.ledger, intersect_ledger(frag, chunk))
    one_decision_across_ranks(frag, app_name, prices)
    backend = "spgemm" if prices["spgemm_wins"] else "intersect"
    SPGEMM_STATS["auto_spgemm" if prices["spgemm_wins"]
                 else "auto_intersect"] += 1
    _record("decisions", {
        "app": app_name, "mode": "auto", "backend": backend,
        "t_spgemm_s": round(prices["t_spgemm_s"], 6),
        "t_intersect_s": round(prices["t_intersect_s"], 6),
        "items": plan.items, "mask_edges": plan.mask_edges,
        "profile": prices["profile"],
    })
    if backend == "intersect":
        record_decline(
            app_name,
            f"auto: modeled intersect {prices['t_intersect_s']:.2e}s "
            f"beats spgemm {prices['t_spgemm_s']:.2e}s", mode)
    return backend


def one_decision_across_ranks(frag, app_name: str, prices: dict) -> None:
    """Under a process group every rank must take `auto`'s decision alike
    (one runs the ring, the other the credit fold otherwise): each rank's
    pick is exchanged over the control plane (`host_allgather`), and a
    disagreement -- rate profiles that differ between ranks -- raises on
    every rank, naming each rank's pick."""
    from libgrape_lite_tpu_torch.parallel import comm_spec

    spec = getattr(frag, "comm_spec", None)
    if getattr(spec, "group", None) is None or spec.world <= 1:
        return
    picks = comm_spec.host_allgather(
        np.array([int(prices["spgemm_wins"])], np.int64)).reshape(-1)
    if len(set(picks.tolist())) > 1:
        names = ", ".join(f"rank {r}: {'spgemm' if p else 'intersect'}"
                          for r, p in enumerate(picks.tolist()))
        raise ValueError(
            f"GRAPE_LCC_BACKEND=auto for {app_name}: the ranks priced the "
            f"backends apart ({names}; this rank's profile "
            f"{prices['profile']}); install one GRAPE_RATE_PROFILE on "
            "every rank")
