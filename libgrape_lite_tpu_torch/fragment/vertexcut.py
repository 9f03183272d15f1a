"""Vertex-cut (2-D edge partition) fragments on one device.

Counterpart of `libgrape_lite_tpu/fragment/vertexcut.py` (reference
`grape/fragment/immutable_vertexcut_fragment.h:40-349` and
`VCPartitioner`, `grape/vertex_map/partitioner.h:269-330`): fnum must be
k^2; edge (src, dst) lands on tile (src_chunk * k + dst_chunk); vertex
masters are 1-D oid-range chunks, mastered by the diagonal tiles.  A
vertex's global padded id is gpid = chunk * vc + offset, with vc the
chunk width rounded up to 128.

The host side is the JAX package's, array for array: the padded COO tile
blocks `_host_tiles` ([fnum, Ep] src / dst gpids, weights, mask, edges in
input order), the per-tile CSR views `host_ie` / `host_oe` (local rows
and columns, what the checkpoint fingerprint hashes), `tile_stats` and
the oid <-> gpid arithmetic.

On the device the fragment holds what K1 (`ops/spmv.py::gather_reduce`)
pulls, not the JAX package's COO blocks: each orientation's k^2 tile
CSRs concatenated into ONE CSR of k^2 * vc rows -- tile f's rows at f *
vc, built by `graph/csr.py::build_csr` in the tiles' own edge order,
each edge's neighbour a global gpid -- so one merge-path launch walks
every tile's edges in equal shares (RMAT's tile (0, 0) holds most of
them; a [k^2, Ep] stack would pad every tile to it).  `ie` pulls into
the dst side (rows dst, neighbours src), `oe` into the src side; `oe` is
placed only on raw (unsymmetrised) storage, where PageRankVC and
directed WCC pull both directions.  K1's [1, k^2 * vc] output viewed as
[k, k, vc] is the per-tile partials the 2-D StepContext reduces over the
row or column axis.

Across ranks (a CommSpec with world > 1) every rank reads the edge file
and keeps the host tiles, as the 1-D gangs do, and places only its slab
of the grid (`CommSpec.vc_grid`): the rows of its fl tiles in each
orientation's concatenated CSR (`_slab_csr`), whose neighbours index the
rank's own chunks of the carry -- the tile rows it holds for `ie` (the
src chunks), the tile columns for `oe` (the dst chunks) -- and the vertex
mask of its tile rows.  The host tiles, `tile_stats` and the fingerprint
stay those of the whole grid.

`VC_TILE_STATS` is federated as "vc_tiles", as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from libgrape_lite_tpu_torch.graph.csr import CSR, build_csr
from libgrape_lite_tpu_torch.obs.federation import FederatedStats

# 2-D tile fill and pad waste, the latest `tile_stats` scan
VC_TILE_STATS = FederatedStats("vc_tiles", {
    "scans": 0,
    "tiles": 0,
    "edge_slots": 0,        # padded COO slots a tile (Ep)
    "edges": 0,             # real edges across all tiles
    "pad_slots": 0,         # fnum * Ep - edges
    "pad_waste_frac": 0.0,  # pad_slots / (fnum * Ep)
    "min_fill_frac": 0.0,
    "mean_fill_frac": 0.0,
    "max_fill_frac": 0.0,
    "tile_skew": 0.0,
})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class VCDeviceCSR:
    """One orientation's concatenated tile CSR on the device, as K1
    takes it (one fragment of k^2 * vc rows)."""

    indptr: torch.Tensor  # [1, k*k*vc + 1] int32
    nbr: torch.Tensor  # [1, Ep] int32 gpid of the pulled endpoint
    w: Optional[torch.Tensor]  # [1, Ep] edge data, or None


@dataclass
class VCDeviceFragment:
    """The device view of a rank's k x k tiles (JAX `VCDeviceFragment`;
    every tile with one process)."""

    ie: VCDeviceCSR
    oe: Optional[VCDeviceCSR]
    vmask: torch.Tensor  # [nr * vc] bool: real vertex slots of the rank's
    # tile rows (all k rows with one process)
    fnum: int
    k: int
    vc: int  # padded chunk width
    chunk: int  # real chunk width
    total_vnum: int
    total_enum: int

    @property
    def n_pad(self) -> int:
        return self.k * self.vc

    @property
    def inner_mask(self) -> torch.Tensor:
        """The master slots, the vote's mask (the worker reads its
        device)."""
        return self.vmask


class ImmutableVertexcutFragment:
    """Host descriptor of the 2-D partitioned graph plus its device
    tiles in `dev`."""

    mesh_kind = "vc2d"

    def __init__(self, comm_spec, oids, k, vc, chunk, total_enum,
                 directed: bool = True, weighted: bool = False,
                 symmetrized: bool = False):
        self.comm_spec = comm_spec
        self.device = comm_spec.device
        self.k = k
        self.vc = vc
        self.chunk = chunk
        self.fnum = k * k
        self.vp = vc  # chunk width, for the Worker's result shapes
        self.total_enum = total_enum
        self._oids = np.asarray(oids)
        self._chunk_oids = [
            np.sort(self._oids[(self._oids // chunk) == c]) for c in range(k)
        ]
        self.total_vnum = len(self._oids)
        # traversal semantics of the stored tiles: `symmetrized` says
        # they hold (u, v) and (v, u) for each input edge, so one
        # dst-side pull a round covers the undirected traversal;
        # PageRankVC keeps raw storage and pulls both sides itself
        self.directed = directed
        self.weighted = weighted
        self.symmetrized = symmetrized
        # no delta overlay, edge list or load spec: dyn/ and the loader's
        # rebuilds refuse vertex-cut storage
        self.dyn_overlay = None
        self.edge_list = None
        self.load_spec = None
        self._host_csrs = {}
        self._tiles = None
        self.dev = None
        # this rank's place on the grid (every tile with one process)
        self.grid = comm_spec.vc_grid(k)

    # ---- ids ----

    @property
    def total_vertices_num(self) -> int:
        return self.total_vnum

    @property
    def total_edges_num(self) -> int:
        return self.total_enum

    def is_string_keyed(self) -> bool:
        return False

    def oid_to_gpid(self, oids: np.ndarray) -> np.ndarray:
        oids = np.asarray(oids)
        return (oids // self.chunk) * self.vc + (oids % self.chunk)

    def gpid_to_oid(self, gpids: np.ndarray) -> np.ndarray:
        """Inverse of `oid_to_gpid`; gpid order is oid order, which makes
        the 2-D WCC representative the min-oid member."""
        gpids = np.asarray(gpids)
        return (gpids // self.vc) * self.chunk + (gpids % self.vc)

    def vertex_mask(self) -> np.ndarray:
        """[k * vc] bool: which gpid slots are real vertices."""
        m = np.zeros(self.k * self.vc, dtype=bool)
        m[self.oid_to_gpid(self._oids)] = True
        return m

    def chunk_span(self, side: str = "row") -> tuple:
        """(lo, hi) gpid bounds of the carry chunks this rank holds: its
        tile rows' ("row") or tile columns' ("col"); [0, k * vc) with
        one process."""
        g = self.grid
        lo, n = (g.r_lo, g.nr) if side == "row" else (g.c_lo, g.nc)
        return lo * self.vc, (lo + n) * self.vc

    # masters: the diagonal tile (c, c) owns chunk c
    def inner_vertices_num(self, fid: int) -> int:
        i, j = divmod(fid, self.k)
        return len(self._chunk_oids[i]) if i == j else 0

    def inner_oids(self, fid: int) -> np.ndarray:
        i, j = divmod(fid, self.k)
        return self._chunk_oids[i] if i == j else np.zeros(0, np.int64)

    # ---- host tiles ----

    @property
    def _tile_ep(self) -> int:
        """Ep: the largest tile's edge count rounded up to 128."""
        return _round_up(max(int(self._tile_counts.max(initial=0)), 1), 128)

    @property
    def _host_tiles(self):
        """(src, dst, w, mask) [fnum, Ep] COO blocks, each tile's edges in
        input order from slot 0 (JAX `_host_tiles`).  Built on first
        read from the edge arrays the build kept."""
        if self._tiles is None:
            sg, dg, w, fid = self._edges
            fnum = self.fnum
            counts = self._tile_counts
            ep = self._tile_ep
            order = np.argsort(fid, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)])
            s_arr = np.zeros((fnum, ep), dtype=np.int32)
            d_arr = np.zeros((fnum, ep), dtype=np.int32)
            w_arr = None if w is None else np.zeros((fnum, ep), w.dtype)
            m_arr = np.zeros((fnum, ep), dtype=bool)
            for f in range(fnum):
                sel = order[starts[f]:starts[f + 1]]
                n = len(sel)
                s_arr[f, :n] = sg[sel]
                d_arr[f, :n] = dg[sel]
                if w_arr is not None:
                    w_arr[f, :n] = w[sel]
                m_arr[f, :n] = True
            self._tiles = (s_arr, d_arr, w_arr, m_arr)
        return self._tiles

    def _concat_csr(self, orientation: str) -> CSR:
        """The orientation's k^2 tile CSRs as one CSR over k^2 * vc rows
        (tile f's rows at f * vc), neighbours as global gpids.  Within a
        tile every neighbour lies in one chunk, so build_csr's (row,
        gpid) order is the tile's (row, offset) order."""
        key = "cat_" + orientation
        if key not in self._host_csrs:
            sg, dg, w, fid = self._edges
            rows, cols = (dg, sg) if orientation == "ie" else (sg, dg)
            rid = fid.astype(np.int64) * self.vc + rows % self.vc
            n_rows = self.fnum * self.vc
            self._host_csrs[key] = build_csr(
                rid, cols, w, n_rows, _round_up(max(len(sg), 1), 128))
        return self._host_csrs[key]

    def _tile_csrs(self, orientation: str):
        """host_ie[f]: rows dst offsets in chunk j, columns src offsets
        in chunk i; host_oe[f] the transpose.  Local [vc] tables, padded
        to the tiles' Ep: the JAX package's tile CSR views, array for
        array, cut from the concatenated CSR."""
        if orientation in self._host_csrs:
            return self._host_csrs[orientation]
        cat = self._concat_csr(orientation)
        ep = self._tile_ep
        vc = self.vc
        csrs = []
        for f in range(self.fnum):
            ip = cat.indptr[f * vc:(f + 1) * vc + 1]
            a, b = int(ip[0]), int(ip[-1])
            n, pad = b - a, ep - (b - a)
            w = None
            if cat.edge_w is not None:
                w = np.concatenate([cat.edge_w[a:b],
                                    np.zeros(pad, cat.edge_w.dtype)])
            csrs.append(CSR(
                (ip - a).astype(np.int32),
                np.concatenate([cat.edge_src[a:b] - f * vc,
                                np.full(pad, vc, np.int32)]).astype(np.int32),
                np.concatenate([cat.edge_nbr[a:b] % vc,
                                np.zeros(pad, np.int32)]).astype(np.int32),
                w,
                np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
                vc, n,
            ))
        self._host_csrs[orientation] = csrs
        return csrs

    def _slab_csr(self, orientation: str) -> CSR:
        """The rows of this rank's tiles in the orientation's concatenated
        CSR (all of it with one process), rows local to the slab and
        neighbours local to the carry chunks the pull reads: the tile
        rows' for `ie` (src), the tile columns' for `oe` (dst)."""
        cat = self._concat_csr(orientation)
        g = self.grid
        if g.world == 1:
            return cat
        key = "slab_" + orientation
        if key not in self._host_csrs:
            vc = self.vc
            r0, r1 = g.fid_lo * vc, (g.fid_lo + g.fl) * vc
            a, b = int(cat.indptr[r0]), int(cat.indptr[r1])
            shift = self.chunk_span("row" if orientation == "ie"
                                    else "col")[0]
            n = b - a
            pad = _round_up(max(n, 1), 128) - n
            w = None
            if cat.edge_w is not None:
                w = np.concatenate([cat.edge_w[a:b],
                                    np.zeros(pad, cat.edge_w.dtype)])
            self._host_csrs[key] = CSR(
                (cat.indptr[r0:r1 + 1] - a).astype(np.int32),
                np.concatenate([cat.edge_src[a:b] - r0,
                                np.full(pad, r1 - r0)]).astype(np.int32),
                np.concatenate([cat.edge_nbr[a:b] - shift,
                                np.zeros(pad, np.int64)]).astype(np.int32),
                w,
                np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
                r1 - r0, n)
        return self._host_csrs[key]

    @property
    def host_ie(self):
        return self._tile_csrs("ie")

    @property
    def host_oe(self):
        return self._tile_csrs("oe")

    def tile_stats(self) -> dict:
        """Per-tile real edge counts and the skew summary the span record
        and `trace_report` read; also the fill and pad-waste profile in
        VC_TILE_STATS.  Host data only."""
        counts = self._tile_counts
        ep = self._tile_ep
        mean = max(float(counts.mean()), 1.0)
        fills = counts / max(ep, 1)
        edges = int(counts.sum())
        pad = self.fnum * ep - edges
        skew = round(float(counts.max()) / mean, 3)
        VC_TILE_STATS["scans"] += 1
        VC_TILE_STATS.update({
            "tiles": self.fnum,
            "edge_slots": ep,
            "edges": edges,
            "pad_slots": pad,
            "pad_waste_frac": round(pad / max(self.fnum * ep, 1), 4),
            "min_fill_frac": round(float(fills.min()), 4),
            "mean_fill_frac": round(float(fills.mean()), 4),
            "max_fill_frac": round(float(fills.max()), 4),
            "tile_skew": skew,
        })
        return {
            "k": self.k,
            "per_tile": [
                {"tile": f, "row": f // self.k, "col": f % self.k,
                 "edges": int(c), "fill_frac": round(float(fr), 4)}
                for f, (c, fr) in enumerate(zip(counts, fills))
            ],
            "max_tile_edges": int(counts.max()),
            "mean_tile_edges": round(mean, 1),
            "tile_skew": skew,
            "edge_slots": ep,
            "pad_slots": pad,
            "pad_waste_frac": round(pad / max(self.fnum * ep, 1), 4),
        }

    # ---- device residency (fleet/ eviction) ----

    def device_arrays(self) -> dict:
        """The host arrays `dev` places, by name: each orientation's
        concatenated indptr, neighbours and weights over this rank's
        tiles, and the vertex mask of its tile rows.  fleet/budget.py
        prices exactly these."""
        out = {}
        sides = ("ie",) if self.symmetrized else ("ie", "oe")
        for side in sides:
            cat = self._slab_csr(side)
            out[side + "_indptr"] = cat.indptr.reshape(1, -1)
            out[side + "_nbr"] = cat.edge_nbr.reshape(1, -1)
            if cat.edge_w is not None:
                out[side + "_w"] = cat.edge_w.reshape(1, -1)
        lo, hi = self.chunk_span("row")
        out["vmask"] = self.vertex_mask()[lo:hi]
        return out

    def _place_tiles(self) -> VCDeviceFragment:
        """Deterministic placement of `device_arrays`, shared by the build
        and `restore_device`, so a restored fragment holds the evicted
        one's bytes."""
        dev = self.device
        arrs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in self.device_arrays().items()}

        def side(s):
            if s + "_indptr" not in arrs:
                return None
            return VCDeviceCSR(arrs[s + "_indptr"], arrs[s + "_nbr"],
                               arrs.get(s + "_w"))

        return VCDeviceFragment(
            ie=side("ie"), oe=side("oe"), vmask=arrs["vmask"],
            fnum=self.fnum, k=self.k, vc=self.vc, chunk=self.chunk,
            total_vnum=self.total_vnum, total_enum=self.total_enum)

    def release_device(self) -> bool:
        """Evict: drop the device tiles.  The host tiles and CSRs stay,
        so `restore_device` places the same bytes again.  False when
        already released."""
        if self.dev is None:
            return False
        self.dev = None
        return True

    def restore_device(self) -> bool:
        """Re-admission: place the device tiles from the host CSRs.
        False when already resident."""
        if self.dev is not None:
            return False
        self.dev = self._place_tiles()
        return True

    # ---- construction ----

    @classmethod
    def build(cls, comm_spec, oids: np.ndarray, src_oid: np.ndarray,
              dst_oid: np.ndarray, weights: np.ndarray | None = None,
              edata_dtype=np.float64, directed: bool = True,
              symmetrize: bool = False) -> "ImmutableVertexcutFragment":
        """`symmetrize=True` stores (u, v) in tile (cu, cv) and (v, u) in
        tile (cv, cu) for each input edge, so one dst-side pull a round
        covers the undirected traversal (min folds stay bit-equal to the
        1-D pull).  The default keeps raw storage, which PageRankVC's
        both-direction accumulation needs."""
        fnum = comm_spec.fnum
        k = int(round(np.sqrt(fnum)))
        if k * k != fnum:
            raise ValueError(f"vertex-cut needs fnum = k^2, got {fnum}")
        oids = np.asarray(oids)
        space = int(oids.max()) + 1 if len(oids) else 1
        chunk = (space + k - 1) // k
        vc = _round_up(chunk, 128)

        src = np.asarray(src_oid)
        dst = np.asarray(dst_oid)
        real_enum = len(src)
        if weights is not None:
            weights = np.asarray(weights, dtype=edata_dtype)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if weights is not None:
                weights = np.concatenate([weights, weights])
        bad = (src < 0) | (src >= space) | (dst < 0) | (dst >= space)
        if bad.any():
            ex = np.stack([src[bad], dst[bad]], 1)[:3]
            raise ValueError(
                f"edge endpoint(s) outside the vertex oid space "
                f"[0, {space}), e.g. {ex.tolist()} -- the vertex-cut "
                "fragment requires dense oid ids covering all endpoints")
        sc = src // chunk
        dc = dst // chunk
        fid = (sc * k + dc).astype(np.int16 if fnum < (1 << 15) else np.int64)
        sg = (sc * vc + src % chunk).astype(np.int32)
        dg = (dc * vc + dst % chunk).astype(np.int32)

        out = cls(comm_spec, oids, k, vc, chunk, real_enum,
                  directed=directed, weighted=weights is not None,
                  symmetrized=symmetrize)
        # the edge arrays stay: the host tiles, the CSR views, tile_stats,
        # the fingerprint and restore_device all read them
        out._edges = (sg, dg, weights, fid)
        # every query's partition record reads the per-tile edge counts:
        # counted once here, not a pass over the edges a query
        out._tile_counts = np.bincount(fid, minlength=fnum).astype(np.int64)
        out.dev = out._place_tiles()
        return out
