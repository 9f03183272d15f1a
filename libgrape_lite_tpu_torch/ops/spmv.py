"""SpMV over the stacked in-edge CSR: the two CUDA kernels and their
plain PyTorch versions.

One operation carries PageRank, SSSP, BFS and WCC, the per-row
gather-reduce

    y[r] = (+)_{e in in(r)} x[nbr_e] (*) w_e

with sum and multiply (PageRank), min and add (SSSP), an unweighted
int32 min (BFS depths, WCC labels) or an unweighted int32 sum (the
peeling apps' neighbour counts).  Two kernels
compute it (sources and design notes in `csrc/spmv.cu`):

* `gather_reduce` -- the counterpart of the JAX package's pack-gather
  pipeline (`libgrape_lite_tpu/ops/spmv_pack.py::segment_reduce_pack`):
  it reads `indptr`/`nbr`/`w` directly on an edge-balanced merge path
  (block partition, block gather-reduce with carries, carry fold: three
  device passes per call).  `merge_partition_plain` and
  `gather_reduce_merge_plain` are that schedule's plain twins.
  `gather_reduce_lanes` runs it for k lanes of x in one call (the JAX
  package's vmapped pull of a batched serve query): the CSR is staged
  once a block, and each lane's rows come out bit-equal to
  `gather_reduce` on that lane.  `pull` picks one or the other by the
  rank of x.  `overlay_fold` is K1's use on the delta overlay
  (`dyn/ingest.py`): one pass over the overlay's slots that folds a min
  in place into the caller's pull result (one lane or k), where a merge
  path would walk every row for a few thousand edges.
* `spmv_strict` -- the counterpart of the strict-tile kernel
  (`libgrape_lite_tpu/ops/spmv.py::spmv_strict`): a segment sum of
  per-edge values over equal tiles of `tile` edges, each tile summing
  its rows in edge order and leaving a carry for a row that crosses
  one of its edges, then a fold of the carries in tile order (three
  device passes per call: zero fill, tiles, carry fold).
  `strict_tile_carries_plain` and `spmv_strict_segments_plain` are that
  schedule's plain twins; `spmv_strict_plain` keeps the JAX package's
  order (window partials, then their fold).

Each wrapper takes its plain version (`gather_reduce_plain`,
`gather_reduce_lanes_plain`, `overlay_fold_plain`, `spmv_strict_plain`)
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises.  `wrapper.launches` counts wrapper calls that launched their
kernels (three device passes each, `overlay_fold` one;
`_build.count_launch` under a lock, as the
serving pump launches from several threads).  `plan_tiles`,
`strict_worthwhile` and `plan_for_app` are the JAX package's host-side
planning rules, unchanged.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from libgrape_lite_tpu_torch.obs.federation import FederatedStats
from libgrape_lite_tpu_torch.ops import _build
from libgrape_lite_tpu_torch.ops._build import (
    check_cuda_args,
    check_rc,
    count_launch,
    require,
)
from libgrape_lite_tpu_torch.ops.segment import identity, segment_reduce

KINDS = {"sum": 0, "min": 1, "max": 2}
MAX_LANES = 64  # gather_reduce_lanes: lanes of x a call
LANE = 128  # the strict plan's row-window alignment (JAX package's rule)
INT32_LIMIT = 1 << 31
INT32_MAX = (1 << 31) - 1  # the int32 min identity, BFS's sentinel
STRICT_TILE = 2048  # edges per strict tile (the JAX package's tile)


# ---- host-side strict planning (libgrape_lite_tpu/ops/spmv.py) ----------

def _align_rmax(span: int) -> int:
    return max(LANE, -(-span // LANE) * LANE)


def plan_tiles(edge_src_sorted: np.ndarray, tile: int, vp: int):
    """Strict tiling of a row-sorted edge array (pad rows `vp` included).
    Returns (row_lo [num_tiles] int32, rmax, num_tiles).  Pad edges clamp
    to the last real row for planning, so they never widen a window."""
    e = len(edge_src_sorted)
    if e == 0:
        return np.zeros(1, dtype=np.int32), _align_rmax(1), 1
    real = edge_src_sorted[edge_src_sorted < vp]
    last_real = int(real[-1]) if len(real) else 0
    src_plan = np.minimum(edge_src_sorted, last_real)
    num_tiles = -(-e // tile)
    starts = np.arange(num_tiles, dtype=np.int64) * tile
    ends = np.minimum(starts + tile, e) - 1
    row_lo = src_plan[starts].astype(np.int32)
    row_hi = src_plan[ends].astype(np.int32)
    rmax = _align_rmax(int((row_hi - row_lo).max()) + 1)
    return row_lo, rmax, num_tiles


def strict_worthwhile(rmax: int, tile: int) -> bool:
    """Adoption rule of the JAX package: accept a plan whose row window
    is at most 1/16 of the tile (hub-heavy tiles), reject degree-1 tails."""
    return rmax * 16 <= tile


_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: strict plans built from the host CSRs, and plans served from the
#: per-fragment cache (a serving session's "builds no plan" check);
#: federated as "plan" with the JAX keys (strict plans have no disk
#: cache here: `disk_cache_hits` stays 0)
PLAN_STATS = FederatedStats("plan", {
    "frag_cache_hits": 0, "disk_cache_hits": 0, "planned": 0,
})


def plan_stats() -> dict:
    return dict(PLAN_STATS)


def plan_for_app(frag, vp: int, dtype: torch.dtype, mode: str = "auto"):
    """(row_lo [fnum, num_tiles] int32, tile, rmax) when the strict kernel
    should serve the in-edge segment sums, else None (gather_reduce).

    `strict` always plans; `auto` plans only float32 states (the kernel's
    type) and only when `strict_worthwhile` accepts the worst tile span.
    Plans come from the host CSRs and are cached per fragment."""
    if mode not in ("auto", "strict"):
        raise ValueError(f"unknown spmv mode {mode!r} (auto | strict)")
    if mode == "auto" and dtype != torch.float32:
        return None
    cached = _PLAN_CACHE.setdefault(frag, {}).get(vp)
    if cached is not None:
        PLAN_STATS["frag_cache_hits"] += 1
    else:
        PLAN_STATS["planned"] += 1
        edge_src = [c.edge_src for c in frag.host_ie]
        if not any((s < vp).any() for s in edge_src):
            cached = False  # no real edge anywhere: nothing to tile
        else:
            plans = [plan_tiles(s, STRICT_TILE, vp) for s in edge_src]
            rmax = max(p[1] for p in plans)
            row_lo = np.stack([p[0] for p in plans]).astype(np.int32)
            cached = (row_lo, STRICT_TILE, rmax)
        _PLAN_CACHE[frag][vp] = cached
    if cached is False:
        return None
    row_lo, tile, rmax = cached
    if mode == "auto" and not strict_worthwhile(rmax, tile):
        return None
    return row_lo, tile, rmax


# ---- kernel library ------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("spmv")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grape_gather_reduce.argtypes = [p, p, p, p, p, p, i, i, ll, i, p]
        lib.grape_gather_reduce.restype = i
        lib.grape_gather_reduce_i32.argtypes = [p, p, p, p, p, i, i, ll, i, p]
        lib.grape_gather_reduce_i32.restype = i
        lib.grape_gather_scratch_ints.argtypes = [i, i, ll]
        lib.grape_gather_scratch_ints.restype = ll
        lib.grape_gather_config.argtypes = [i, i, i, p]
        lib.grape_gather_config.restype = i
        lib.grape_strict_tile.argtypes = [p, p, p, p, i, ll, i, i, i, p]
        lib.grape_strict_tile.restype = i
        lib.grape_strict_scratch_ints.argtypes = [i, i]
        lib.grape_strict_scratch_ints.restype = ll
        lib.grape_gather_reduce_lanes.argtypes = [p, p, p, p, p, p, i, i, ll,
                                                  i, i, i, p]
        lib.grape_gather_reduce_lanes.restype = i
        lib.grape_gather_reduce_lanes_i32.argtypes = [p, p, p, p, p, i, i, ll,
                                                      i, i, i, p]
        lib.grape_gather_reduce_lanes_i32.restype = i
        lib.grape_gather_lanes_scratch_ints.argtypes = [i, i, ll, i]
        lib.grape_gather_lanes_scratch_ints.restype = ll
        lib.grape_gather_lanes_config.argtypes = [i, i, i, p]
        lib.grape_gather_lanes_config.restype = i
        lib.grape_overlay_fold.argtypes = [p, p, p, p, p, p, i, i, i, ll, i,
                                           p]
        lib.grape_overlay_fold.restype = i
        lib.grape_overlay_fold_i32.argtypes = [p, p, p, p, p, i, i, i, ll, i,
                                               i, p]
        lib.grape_overlay_fold_i32.restype = i
        _LIB = lib
    return _LIB


# ---- gather_reduce: counterpart of the pack-gather pipeline (K1) ---------

def gather_reduce_plain(indptr: torch.Tensor, nbr: torch.Tensor,
                        w: torch.Tensor | None, x: torch.Tensor,
                        kind: str = "sum") -> torch.Tensor:
    """Plain PyTorch gather-reduce over the stacked CSR: [fnum, vp].
    Only edges inside `indptr` are read, so pads never contribute."""
    fnum, vp = indptr.shape[0], indptr.shape[1] - 1
    ep = nbr.shape[1]
    ind = indptr.long()
    real = torch.arange(ep, device=x.device).unsqueeze(0) < ind[:, -1:]
    vals = x[nbr[real].long()]
    if w is not None:
        vals = vals * w[real] if kind == "sum" else vals + w[real]
    deg = (ind[:, 1:] - ind[:, :-1]).reshape(-1)
    rows = torch.repeat_interleave(
        torch.arange(fnum * vp, device=x.device), deg)
    return segment_reduce(vals, rows, fnum * vp, kind).view(fnum, vp)


def merge_partition_plain(indptr: torch.Tensor, ep: int,
                          items_per_block: int) -> torch.Tensor:
    """Pass 1 of the kernel's schedule: [fnum, bpf + 1] int64, the row
    coordinate of every block boundary d = b * items_per_block (clamped to
    the fragment's vp + nnz merge items), bpf = ceil((vp + ep) / items).
    Row end i sits at merge position indptr[i + 1] + i, so the coordinate
    is the number of row ends placed before d."""
    fnum, vp = indptr.shape[0], indptr.shape[1] - 1
    ind = indptr.long()
    bpf = -(-(vp + ep) // items_per_block)
    d = torch.arange(bpf + 1, device=ind.device) * items_per_block
    d = torch.minimum(d.unsqueeze(0), vp + ind[:, -1:]).contiguous()
    pos = (ind[:, 1:] + torch.arange(vp, device=ind.device)).contiguous()
    return torch.searchsorted(pos, d)


def gather_reduce_merge_plain(indptr: torch.Tensor, nbr: torch.Tensor,
                              w: torch.Tensor | None, x: torch.Tensor,
                              kind: str, items_per_block: int
                              ) -> torch.Tensor:
    """The kernel's merge-path schedule in plain PyTorch, the same function
    as `gather_reduce_plain`: each block reduces the rows that end inside
    it from its own edges on, leaves a carry (row, partial) for the row
    that runs past it, and the carries fold into their rows in block
    order.  Loops over blocks and rows: for small inputs (tests)."""
    fnum, vp = indptr.shape[0], indptr.shape[1] - 1
    ep = nbr.shape[1]
    part = merge_partition_plain(indptr, ep, items_per_block).tolist()
    ind = indptr.long().tolist()
    # sums accumulate in x's type (int32 stays int32)
    fold = {"sum": lambda t: t.sum(dtype=t.dtype), "min": torch.amin,
            "max": torch.amax}[kind]
    ident = identity(kind, x.dtype)
    y = torch.full((fnum, vp), ident, dtype=x.dtype, device=x.device)

    def reduce(vals):
        return fold(vals) if vals.numel() else ident

    carries = []  # (f, row, partial), in block order
    for f in range(fnum):
        terms = x[nbr[f].long()]
        if w is not None:
            terms = terms * w[f] if kind == "sum" else terms + w[f]
        total = vp + ind[f][vp]
        for b in range(len(part[f]) - 1):
            d0 = b * items_per_block
            if d0 >= total:
                break
            d1 = min(d0 + items_per_block, total)
            r0, r1 = part[f][b], part[f][b + 1]
            e0, e1 = d0 - r0, d1 - r1
            for r in range(r0, r1):
                y[f, r] = reduce(terms[max(e0, ind[f][r]):ind[f][r + 1]])
            if r1 < vp and e1 > max(e0, ind[f][r1]):
                carries.append((f, r1, reduce(terms[max(e0, ind[f][r1]):e1])))
    run = {}
    for f, r, v in carries:  # fold each row's run in block order
        run[f, r] = reduce(torch.stack([run[f, r], v])) if (f, r) in run else v
    for (f, r), v in run.items():
        y[f, r] = reduce(torch.stack([v.to(y.dtype), y[f, r]]))
    return y


def gather_reduce(indptr: torch.Tensor, nbr: torch.Tensor,
                  w: torch.Tensor | None, x: torch.Tensor,
                  kind: str = "sum") -> torch.Tensor:
    """y[f, r] = (+)_{e in indptr[f, r]..indptr[f, r+1]} x[nbr[f, e]] (*) w[f, e].

    indptr [fnum, vp+1] int32, nbr [fnum, Ep] int32 (pids into x),
    w [fnum, Ep] float32 or None, x [N] float32 -> y [fnum, vp] float32.
    kind: sum (w multiplies), min / max (w adds).  Rows without edges
    hold the identity (0, +inf, -inf).

    int32 x (BFS depths, WCC labels, neighbour counts) takes sum, min or
    max without weights; rows without edges then hold 0, INT32_MAX or
    INT32_MIN.  An int32 sum is exact in any order; each row's sum must
    stay below 2^31 (it wraps, as int32 addition does)."""
    name = "gather_reduce"
    require(kind in KINDS, f"{name}: unknown kind {kind!r}")
    is_int = x.dtype == torch.int32
    require(not is_int or w is None, f"{name}: int32 x takes no weights")
    if x.device.type == "cpu":
        return gather_reduce_plain(indptr, nbr, w, x, kind)
    require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    check_cuda_args(name, x.device, indptr=indptr, nbr=nbr, w=w, x=x)
    require(indptr.dim() == 2 and nbr.dim() == 2 and x.dim() == 1,
            f"{name}: indptr/nbr must be [fnum, *], x [N]")
    fnum, vp = indptr.shape[0], indptr.shape[1] - 1
    ep = nbr.shape[1]
    require(nbr.shape[0] == fnum, f"{name}: nbr has {nbr.shape[0]} "
            f"fragments, indptr {fnum}")
    require(indptr.dtype == torch.int32 and nbr.dtype == torch.int32,
            f"{name}: indptr and nbr must be int32")
    require(x.dtype in (torch.float32, torch.int32),
            f"{name}: x must be float32 or int32")
    require(w is None or (w.dtype == torch.float32 and w.shape == nbr.shape),
            f"{name}: w must be float32 shaped like nbr")
    require(ep < INT32_LIMIT and fnum * vp < INT32_LIMIT
            and x.numel() < INT32_LIMIT,
            f"{name}: sizes must stay below 2^31 (int32 indices)")
    y = torch.empty((fnum, vp), dtype=x.dtype, device=x.device)
    lib = _lib()
    # block boundaries and carries of the merge path (csrc/spmv.cu)
    scratch = torch.empty(lib.grape_gather_scratch_ints(fnum, vp, ep),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if is_int:
            rc = lib.grape_gather_reduce_i32(
                indptr.data_ptr(), nbr.data_ptr(), x.data_ptr(),
                y.data_ptr(), scratch.data_ptr(), fnum, vp, ep, KINDS[kind],
                stream,
            )
        else:
            rc = lib.grape_gather_reduce(
                indptr.data_ptr(), nbr.data_ptr(),
                None if w is None else w.data_ptr(), x.data_ptr(),
                y.data_ptr(), scratch.data_ptr(), fnum, vp, ep, KINDS[kind],
                stream,
            )
    check_rc(lib, rc, name)
    count_launch(gather_reduce)
    return y


gather_reduce.launches = 0


def gather_config(kind: str = "sum", weighted: bool = False,
                  int32: bool = False, lanes: bool = False) -> dict:
    """Launch facts of the merge-path gather kernel for one kind (of its
    lane form with `lanes`), as the card reports them (a CUDA device must
    be current): threads, items per thread and per block, static shared
    memory and registers per thread, resident blocks per SM and the
    shared-memory carve-out (%)."""
    out = (ctypes.c_int * 6)()
    fn = (_lib().grape_gather_lanes_config if lanes
          else _lib().grape_gather_config)
    check_rc(_lib(), fn(KINDS[kind], int(weighted), int(int32), out),
             "gather_config")
    keys = ("threads", "items_per_thread", "smem_bytes", "registers",
            "blocks_per_sm", "carveout_pct")
    cfg = dict(zip(keys, out))
    cfg["items_per_block"] = cfg["threads"] * cfg["items_per_thread"]
    return cfg


# ---- gather_reduce_lanes: K1 for k lanes of x (the vmapped pull) ---------

def gather_reduce_lanes_plain(indptr: torch.Tensor, nbr: torch.Tensor,
                              w: torch.Tensor | None, x: torch.Tensor,
                              kind: str = "sum") -> torch.Tensor:
    """Plain PyTorch lanes: `gather_reduce_plain` on each lane of x
    [k, N], stacked [k, fnum, vp]."""
    return torch.stack([gather_reduce_plain(indptr, nbr, w, x[b], kind)
                        for b in range(x.shape[0])])


def lane_pitch(lanes: int) -> int:
    """The lanes of a row of the lane kernel's x: 2 for 2 lanes, else
    `lanes` rounded up to 4, so that its 8- and 16-byte vector loads of
    a vertex's lanes stay aligned and inside the row (`csrc/spmv.cu`
    refuses another pitch)."""
    return 2 if lanes == 2 else -(-lanes // 4) * 4


def lane_minor(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """x [k, N] as the lane kernel reads it: [N, pitch], a vertex's
    lanes side by side, the pad lanes zero."""
    k, n = x.shape
    if pitch == k:
        return x.t().contiguous()
    xt = x.new_zeros((n, pitch))
    xt[:, :k] = x.t()
    return xt


def lane_chunk(fnum: int, vp: int) -> int:
    """The most lanes one `gather_reduce_lanes` call takes over fnum x vp
    rows: MAX_LANES, with its carry keys lane * fnum * vp + pid int32."""
    return max(1, min(MAX_LANES, (INT32_LIMIT - 1) // max(1, fnum * vp)))


def gather_reduce_lanes(indptr: torch.Tensor, nbr: torch.Tensor,
                        w: torch.Tensor | None, x: torch.Tensor,
                        kind: str = "sum") -> torch.Tensor:
    """`gather_reduce` for k lanes of x [k, N] (on the card 1 <= k <=
    `lane_chunk(fnum, vp)`; `pull` splits larger batches) at once -> y
    [k, fnum, vp]: one merge partition, one gather pass that stages each
    block's CSR span once and reduces it for every lane (x transposed to
    [N, pitch] first, the lanes padded to the vector width, so a
    vertex's lanes come in 16-byte loads from one sector), one carry
    fold over every lane's carries.  Lane b of y is bit-equal to
    `gather_reduce(indptr, nbr, w, x[b], kind)`, float sums included
    (the same partition, walk, scan and carry order).  One lane is
    `gather_reduce`'s own call."""
    name = "gather_reduce_lanes"
    require(kind in KINDS, f"{name}: unknown kind {kind!r}")
    is_int = x.dtype == torch.int32
    require(not is_int or w is None, f"{name}: int32 x takes no weights")
    require(x.dim() == 2, f"{name}: x must be [k, N]")
    if x.device.type == "cpu":
        return gather_reduce_lanes_plain(indptr, nbr, w, x, kind)
    require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    check_cuda_args(name, x.device, indptr=indptr, nbr=nbr, w=w, x=x)
    require(indptr.dim() == 2 and nbr.dim() == 2,
            f"{name}: indptr/nbr must be [fnum, *]")
    fnum, vp = indptr.shape[0], indptr.shape[1] - 1
    ep = nbr.shape[1]
    lanes, n = x.shape
    most = lane_chunk(fnum, vp)
    require(1 <= lanes <= most,
            f"{name}: {lanes} lanes, the kernel takes 1 to {most} here")
    require(nbr.shape[0] == fnum, f"{name}: nbr has {nbr.shape[0]} "
            f"fragments, indptr {fnum}")
    require(indptr.dtype == torch.int32 and nbr.dtype == torch.int32,
            f"{name}: indptr and nbr must be int32")
    require(x.dtype in (torch.float32, torch.int32),
            f"{name}: x must be float32 or int32")
    require(w is None or (w.dtype == torch.float32 and w.shape == nbr.shape),
            f"{name}: w must be float32 shaped like nbr")
    require(ep < INT32_LIMIT and n < INT32_LIMIT,
            f"{name}: sizes must stay below 2^31 (int32 indices)")
    if lanes == 1:
        return gather_reduce(indptr, nbr, w, x[0], kind).unsqueeze(0)
    y = torch.empty((lanes, fnum, vp), dtype=x.dtype, device=x.device)
    lib = _lib()
    scratch = torch.empty(
        lib.grape_gather_lanes_scratch_ints(fnum, vp, ep, lanes),
        dtype=torch.int32, device=x.device)
    pitch = lane_pitch(lanes)
    with torch.cuda.device(x.device):
        # the kernel gathers a vertex's lanes by vector loads
        xt = lane_minor(x, pitch)
        stream = torch.cuda.current_stream().cuda_stream
        if is_int:
            rc = lib.grape_gather_reduce_lanes_i32(
                indptr.data_ptr(), nbr.data_ptr(), xt.data_ptr(),
                y.data_ptr(), scratch.data_ptr(), fnum, vp, ep, KINDS[kind],
                lanes, pitch, stream,
            )
        else:
            rc = lib.grape_gather_reduce_lanes(
                indptr.data_ptr(), nbr.data_ptr(),
                None if w is None else w.data_ptr(), xt.data_ptr(),
                y.data_ptr(), scratch.data_ptr(), fnum, vp, ep, KINDS[kind],
                lanes, pitch, stream,
            )
    check_rc(lib, rc, name)
    count_launch(gather_reduce_lanes)
    return y


gather_reduce_lanes.launches = 0


# ---- overlay_fold: K1 on the delta overlay (a pass over its slots) -------

def _flip(bits: torch.Tensor) -> torch.Tensor:
    """A float's bits (int32 / int64) <-> the key the card's fold orders
    floats by (`ordered_key` in csrc/spmv.cu: the negative floats'
    magnitude bits flipped, so integer order is float order with -0.0
    below +0.0); the map is its own inverse."""
    return torch.where(bits >= 0, bits, bits ^ torch.iinfo(bits.dtype).max)


def overlay_fold_plain(relaxed: torch.Tensor, src: torch.Tensor,
                       nbr: torch.Tensor, w: torch.Tensor | None,
                       mask: torch.Tensor, x: torch.Tensor,
                       plus_one: bool = False) -> torch.Tensor:
    """Plain PyTorch overlay fold, in place into `relaxed`: each slot's
    candidate x[..., nbr] (+ w; + 1 short of the int32 sentinel), the
    identity where `mask` is off, a segment min over `src` (pads route
    to the overflow row vp) -- the JAX package's fold -- then the
    minimum with `relaxed`.  Floats are reduced as their ordered int32
    keys, so -0.0 wins over +0.0 whatever the order, as on the card
    and in the JAX fold."""
    vp = relaxed.shape[-1]
    cand = x[..., nbr.long()]
    if w is not None:
        cand = cand + w
    if plus_one:
        cand = torch.where(cand != INT32_MAX, cand + 1, cand)
    cand = torch.where(mask, cand, identity("min", x.dtype))
    if not x.dtype.is_floating_point:
        extra = segment_reduce(cand, src.expand_as(cand), vp, "min")
        return torch.minimum(relaxed, extra, out=relaxed)
    ibits = torch.int64 if x.dtype == torch.float64 else torch.int32
    key = _flip(cand.view(ibits))
    extra = segment_reduce(key, src.expand_as(key), vp, "min")
    best = torch.minimum(_flip(relaxed.view(ibits)), extra)
    return relaxed.copy_(_flip(best).view(relaxed.dtype))


def overlay_fold(relaxed: torch.Tensor, src: torch.Tensor, nbr: torch.Tensor,
                 w: torch.Tensor | None, mask: torch.Tensor, x: torch.Tensor,
                 plus_one: bool = False) -> torch.Tensor:
    """Fold the delta overlay (`dyn/ingest.py::DeltaOverlay`: planes
    src, nbr, w, mask [fnum, cap], src sorted within a fragment, pads
    src == vp with mask off) into a min reduction, in place:

        relaxed[.., f, src[f, s]] = min(relaxed[.., f, src[f, s]],
                                        x[.., nbr[f, s]] (+) w[f, s])

    for every slot with mask[f, s], and returns `relaxed`, which the
    caller owns (a fresh pull result).  x [N] with relaxed [fnum, vp],
    or k lanes x [k, N] (lane-major) with relaxed [k, fnum, vp].
    `plus_one` (int32, unweighted: BFS) adds one hop to each candidate,
    the sentinel INT32_MAX kept.  The result equals
    `torch.minimum(relaxed, post(gather_reduce(indptr, nbr, w, x,
    "min")))` over the CSR of the sorted `src` plane (a zero's sign
    aside): min is exact in any order.  On the card one launch, one thread a slot and lane.
    Floats order -0.0 below +0.0 on the card and in the plain version
    alike; +inf is the identity; no NaN."""
    name = "overlay_fold"
    is_int = x.dtype == torch.int32
    require(not is_int or w is None, f"{name}: int32 x takes no weights")
    require(not plus_one or (is_int and w is None),
            f"{name}: plus_one takes unweighted int32 x")
    if x.device.type == "cpu":
        return overlay_fold_plain(relaxed, src, nbr, w, mask, x, plus_one)
    require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    check_cuda_args(name, x.device, relaxed=relaxed, src=src, nbr=nbr, w=w,
                    mask=mask, x=x)
    require(src.dim() == 2 and src.shape == nbr.shape == mask.shape,
            f"{name}: src, nbr and mask must be [fnum, cap] alike")
    fnum, cap = src.shape
    require(x.dim() in (1, 2), f"{name}: x must be [N] or [k, N]")
    lanes = x.shape[0] if x.dim() == 2 else 1
    vp = relaxed.shape[-1]
    require(relaxed.shape == (*x.shape[:-1], fnum, vp),
            f"{name}: relaxed {tuple(relaxed.shape)} does not match x "
            f"{tuple(x.shape)} over {fnum} fragments")
    require(src.dtype == torch.int32 and nbr.dtype == torch.int32
            and mask.dtype == torch.bool,
            f"{name}: src and nbr must be int32, mask bool")
    require(x.dtype in (torch.float32, torch.int32) and relaxed.dtype == x.dtype,
            f"{name}: x and relaxed must be float32 or int32 alike")
    require(w is None or (w.dtype == torch.float32 and w.shape == nbr.shape),
            f"{name}: w must be float32 shaped like nbr")
    require(fnum * vp < INT32_LIMIT and x.shape[-1] < INT32_LIMIT
            and lanes < 1 << 16,
            f"{name}: sizes out of range (int32 rows, 65535 lanes)")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if is_int:
            rc = lib.grape_overlay_fold_i32(
                src.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                x.data_ptr(), relaxed.data_ptr(), fnum, cap, vp, x.shape[-1],
                lanes, int(plus_one), stream,
            )
        else:
            rc = lib.grape_overlay_fold(
                src.data_ptr(), nbr.data_ptr(),
                None if w is None else w.data_ptr(), mask.data_ptr(),
                x.data_ptr(), relaxed.data_ptr(), fnum, cap, vp, x.shape[-1],
                lanes, stream,
            )
    check_rc(lib, rc, name)
    count_launch(overlay_fold)
    return relaxed


overlay_fold.launches = 0


def pull(indptr: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor | None,
         x: torch.Tensor, kind: str = "sum") -> torch.Tensor:
    """The apps' pull: `gather_reduce` for x [N] -> [fnum, vp], one
    `gather_reduce_lanes` call for lane-stacked x [k, N] -> [k, fnum, vp]
    (one a chunk of `lane_chunk` lanes where k is larger)."""
    if x.dim() == 1:
        return gather_reduce(indptr, nbr, w, x, kind)
    step = lane_chunk(indptr.shape[0], indptr.shape[1] - 1)
    if x.shape[0] <= step:
        return gather_reduce_lanes(indptr, nbr, w, x, kind)
    return torch.cat([gather_reduce_lanes(indptr, nbr, w, x[i:i + step], kind)
                      for i in range(0, x.shape[0], step)])


# ---- spmv_strict: counterpart of the strict-tile kernel (K2) -------------

def spmv_strict_plain(values: torch.Tensor, edge_src: torch.Tensor,
                      row_lo: torch.Tensor, vp: int, tile: int,
                      rmax: int) -> torch.Tensor:
    """Plain PyTorch strict-tile segment sum: tile partials over each
    window [row_lo[t], row_lo[t] + rmax), then the clamped fold into
    [fnum, vp] (`spmv_strict` of the JAX package, stacked)."""
    fnum, ep = values.shape
    num_tiles = row_lo.shape[1]
    e_pad = num_tiles * tile
    if e_pad > ep:
        values = torch.cat([values, values.new_zeros(fnum, e_pad - ep)], 1)
        edge_src = torch.cat(
            [edge_src, edge_src.new_full((fnum, e_pad - ep), vp)], 1)
    local = (edge_src[:, :e_pad].reshape(fnum, num_tiles, tile).long()
             - row_lo.long().unsqueeze(-1))
    inwin = (local >= 0) & (local < rmax)
    vals = torch.where(inwin, values[:, :e_pad].reshape(local.shape),
                       values.new_zeros(()))
    partials = values.new_zeros(fnum, num_tiles, rmax)
    partials.scatter_add_(2, local.clamp(0, rmax - 1), vals)
    idx = row_lo.long().unsqueeze(-1) + torch.arange(rmax, device=values.device)
    idx = idx.clamp(max=vp)  # the overflow row, sliced off below
    return segment_reduce(partials.reshape(fnum, -1), idx.reshape(fnum, -1),
                          vp, "sum")


def strict_tile_carries_plain(values: torch.Tensor, edge_src: torch.Tensor,
                              vp: int, tile: int):
    """The kernel's tile pass in plain PyTorch.  Each tile of `tile`
    edges sums its rows in edge order; a row whose edges all lie in the
    tile goes to y, a row that crosses the tile's first or last edge
    boundary to the tile's left or right carry slot (a tile inside one
    row: its sum left, 0 right).  Returns (y [fnum, vp] with crossing and
    edgeless rows 0, carry_row [fnum, num_tiles, 2] int64 pids with -1
    for none, carry_val [fnum, num_tiles, 2]).  Pads (src == vp, edges
    past ep) credit nothing."""
    fnum, ep = values.shape
    num_tiles = -(-ep // tile)
    dev = values.device
    y = values.new_zeros(fnum, vp)
    carry_row = torch.full((fnum, num_tiles, 2), -1, dtype=torch.int64,
                           device=dev)
    carry_val = values.new_zeros(fnum, num_tiles, 2)
    if ep == 0:
        return y, carry_row, carry_val
    src = edge_src.long()
    # segments: runs of one row inside one tile, numbered in edge order
    tile_start = torch.arange(ep, device=dev) % tile == 0
    starts = torch.ones(fnum, ep, dtype=torch.bool, device=dev)
    starts[:, 1:] = (src[:, 1:] != src[:, :-1]) | tile_start[1:]
    flat = src.reshape(-1)
    seg = torch.cumsum(starts.reshape(-1), 0) - 1
    sums = values.new_zeros(int(seg[-1]) + 1).index_add_(
        0, seg, values.reshape(-1))
    first = starts.reshape(-1).nonzero().squeeze(1)
    last = torch.cat([first[1:], first.new_full((1,), fnum * ep)]) - 1
    f_of, e_first, e_last = first // ep, first % ep, last % ep
    row = flat[first]
    real = row < vp
    # the row ids just before and after each segment, in its fragment
    prev = torch.where(e_first > 0, flat[(first - 1).clamp(min=0)], -1)
    nxt = torch.where(e_last + 1 < ep,
                      flat[(last + 1).clamp(max=fnum * ep - 1)], -1)
    left = real & (e_first % tile == 0) & (prev == row)
    right = real & ((e_last + 1) % tile == 0) & (nxt == row)
    inner = real & ~left & ~right
    y.view(-1).index_put_((f_of[inner] * vp + row[inner],), sums[inner])
    pid = f_of * vp + row
    t = e_first // tile
    carry_row[f_of[left], t[left], 0] = pid[left]
    carry_val[f_of[left], t[left], 0] = sums[left]
    carry_row[f_of[right], t[right], 1] = pid[right]
    carry_val[f_of[right], t[right], 1] = torch.where(
        left[right], sums.new_zeros(()), sums[right])
    return y, carry_row, carry_val


def spmv_strict_segments_plain(values: torch.Tensor, edge_src: torch.Tensor,
                               row_lo: torch.Tensor, vp: int, tile: int,
                               rmax: int) -> torch.Tensor:
    """The kernel's order in plain PyTorch, the same function as
    `spmv_strict_plain`: the tile pass (`strict_tile_carries_plain`), then
    each row's carries added in tile order into its 0.  `row_lo` and
    `rmax` are the plan's, unused: each row comes from `edge_src`."""
    y, carry_row, carry_val = strict_tile_carries_plain(values, edge_src, vp,
                                                        tile)
    keep = carry_row.reshape(-1) >= 0
    y.view(-1).index_add_(0, carry_row.reshape(-1)[keep],
                          carry_val.reshape(-1)[keep])
    return y


def spmv_strict(values: torch.Tensor, edge_src: torch.Tensor,
                row_lo: torch.Tensor, vp: int, tile: int,
                rmax: int) -> torch.Tensor:
    """Strict-tile segment sum of `values` [fnum, Ep] float32 by sorted
    `edge_src` [fnum, Ep] int32 (pads == vp) into [fnum, vp], with the
    plan `row_lo` [fnum, num_tiles] int32 from `plan_tiles`."""
    if values.device.type == "cpu":
        return spmv_strict_plain(values, edge_src, row_lo, vp, tile, rmax)
    name = "spmv_strict"
    require(values.device.type == "cuda",
            f"{name}: unsupported device {values.device}")
    check_cuda_args(name, values.device, values=values, edge_src=edge_src,
                    row_lo=row_lo)
    require(values.dim() == 2 and values.shape == edge_src.shape,
            f"{name}: values and edge_src must be [fnum, Ep] alike")
    fnum, ep = values.shape
    require(row_lo.dim() == 2 and row_lo.shape[0] == fnum,
            f"{name}: row_lo must be [fnum, num_tiles]")
    num_tiles = row_lo.shape[1]
    require(values.dtype == torch.float32, f"{name}: values must be float32")
    require(edge_src.dtype == torch.int32 and row_lo.dtype == torch.int32,
            f"{name}: edge_src and row_lo must be int32")
    require(num_tiles * tile >= ep, f"{name}: {num_tiles} tiles of {tile} "
            f"cannot cover {ep} edges")
    # a tile's stage (two spans of tile + 6 ints, csrc/spmv.cu) stays far
    # inside the 48 KB a block gets without opt-in
    require(0 < tile <= STRICT_TILE and tile & (tile - 1) == 0,
            f"{name}: tile {tile} is not a power of two up to {STRICT_TILE}")
    require(0 < rmax and ep < INT32_LIMIT and fnum * vp < INT32_LIMIT,
            f"{name}: sizes out of range")
    lib = _lib()
    y = torch.empty((fnum, vp), dtype=torch.float32, device=values.device)
    # the tiles' carry slots (csrc/spmv.cu); no [fnum, tiles, rmax] partials
    scratch = torch.empty(lib.grape_strict_scratch_ints(fnum, num_tiles),
                          dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.grape_strict_tile(
            values.data_ptr(), edge_src.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), fnum, ep, num_tiles, tile, vp, stream,
        )
    check_rc(lib, rc, name)
    count_launch(spmv_strict)
    return y


spmv_strict.launches = 0


def reset_launch_counts() -> None:
    gather_reduce.launches = 0
    gather_reduce_lanes.launches = 0
    overlay_fold.launches = 0
    spmv_strict.launches = 0


__all__ = [
    "MAX_LANES", "PLAN_STATS", "gather_config", "gather_reduce",
    "lane_chunk", "lane_minor", "lane_pitch",
    "gather_reduce_lanes", "gather_reduce_lanes_plain",
    "gather_reduce_merge_plain", "gather_reduce_plain",
    "merge_partition_plain", "overlay_fold", "overlay_fold_plain",
    "plan_for_app", "plan_stats", "plan_tiles",
    "pull", "reset_launch_counts", "spmv_strict", "spmv_strict_plain",
    "spmv_strict_segments_plain", "strict_tile_carries_plain",
    "strict_worthwhile",
]
