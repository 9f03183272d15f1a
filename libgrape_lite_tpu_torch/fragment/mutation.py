"""Graph mutation: staged edits and the rebuild.

Counterpart of `libgrape_lite_tpu/fragment/mutation.py` (reference
`grape/fragment/basic_fragment_mutator.h`, `ev_fragment_mutator.h` and
`LoadGraphAndMutate`, `grape/fragment/loader.h:59-68`).

`BasicFragmentMutator` collects vertex and edge edits; `mutate` applies
them to the fragment's retained host oid edge list and rebuilds the
padded CSRs on the old fragment's device, with the old fragment's load
options (partitioner, idxer, edata dtype).  The delta files use the
reference grammar: vfile `a oid` / `d oid` / `u oid`, efile
`a src dst [w]` / `d src dst` / `u src dst w`; on undirected graphs `d`
and `u` apply to both orientations (`ev_fragment_mutator.h:118-127`).
`LoadGraphAndMutate` applies the edit to the parsed host arrays, so a
load-and-mutate pays for one device build.  Added vertices are appended
in load order (the reference's `VertexMap::ExtendVertices`), so the
rebuilt CSRs equal the JAX package's array for array.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.vertex_map.partitioner import make_partitioner
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap


def _pair_match(src: np.ndarray, dst: np.ndarray, pairs) -> np.ndarray:
    """Membership of (src[i], dst[i]) in `pairs`, exact for int64 ids.
    Integer ids are coded by their rank among the ids the pairs name (two
    binary searches over that short list), so a pair is one int64 key
    and the test one np.isin; string ids go through a set."""
    if not pairs:
        return np.zeros(len(src), dtype=bool)
    src, dst = np.asarray(src), np.asarray(dst)
    p = np.asarray(pairs)
    if not (src.dtype.kind in "iu" and dst.dtype.kind in "iu"
            and p.dtype.kind in "iu"):
        pset = set(pairs)
        return np.fromiter(
            ((s, d) in pset for s, d in zip(src.tolist(), dst.tolist())),
            dtype=bool, count=len(src),
        )
    p = p.astype(np.int64)
    vals = np.unique(p)

    def rank(a):
        i = np.searchsorted(vals, a).clip(max=len(vals) - 1)
        return i, vals[i] == a

    si, s_ok = rank(src.astype(np.int64))
    di, d_ok = rank(dst.astype(np.int64))
    ok = s_ok & d_ok
    k = len(vals)
    out = np.zeros(len(src), dtype=bool)
    out[ok] = np.isin(si[ok] * k + di[ok],
                      rank(p[:, 0])[0] * k + rank(p[:, 1])[0])
    return out


def oid_row_alignment(old_frag, new_frag):
    """(of, ol, nf, nl): row coordinates aligning old_frag's [fnum, vp]
    per-vertex layout to new_frag's, matched by oid, for every vertex in
    both maps -- the one migration rule of `AppBase.migrate_state` and
    `dyn.incremental.migrate_rows`."""
    old_oids = (
        np.concatenate([old_frag.inner_oids(f) for f in range(old_frag.fnum)])
        if old_frag.fnum else np.zeros(0, np.int64)
    )
    if len(old_oids) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    old_pids = old_frag.oid_to_pid(old_oids)
    new_pids = new_frag.oid_to_pid(old_oids)
    keep = (old_pids >= 0) & (new_pids >= 0)
    return (
        old_pids[keep] // old_frag.vp, old_pids[keep] % old_frag.vp,
        new_pids[keep] // new_frag.vp, new_pids[keep] % new_frag.vp,
    )


def same_layout(old_frag, new_frag) -> bool:
    """True when every vertex keeps its row (same fnum, vp, inner counts
    and oid table), as after a repack of additive edges between known
    vertices: rows and pid-valued state then carry over unchanged, with
    no oid lookups."""
    return old_frag is new_frag or (
        old_frag.fnum == new_frag.fnum and old_frag.vp == new_frag.vp
        and np.array_equal(old_frag.host_ivnum, new_frag.host_ivnum)
        and np.array_equal(old_frag.host_oids, new_frag.host_oids))


@dataclass
class BasicFragmentMutator:
    """Staged mutation set (reference basic_fragment_mutator.h API)."""

    add_vertices: List[int] = field(default_factory=list)
    remove_vertices: List[int] = field(default_factory=list)
    add_edges: List[Tuple[int, int, float]] = field(default_factory=list)
    remove_edges: List[Tuple[int, int]] = field(default_factory=list)
    update_edges: List[Tuple[int, int, float]] = field(default_factory=list)

    def AddVertex(self, oid: int, data=None) -> None:
        self.add_vertices.append(int(oid))

    def RemoveVertex(self, oid: int) -> None:
        self.remove_vertices.append(int(oid))

    def UpdateVertex(self, oid: int, data=None) -> None:
        pass  # vertex data is EmptyType throughout the LDBC apps

    def AddEdge(self, src: int, dst: int, w: float = 0.0) -> None:
        self.add_edges.append((int(src), int(dst), float(w)))

    def RemoveEdge(self, src: int, dst: int) -> None:
        self.remove_edges.append((int(src), int(dst)))

    def UpdateEdge(self, src: int, dst: int, w: float) -> None:
        self.update_edges.append((int(src), int(dst), float(w)))

    def apply_to_arrays(self, src, dst, w, oid_order):
        """Apply the staged ops to host oid edge arrays and the ordered
        vertex universe; returns (src, dst, w, oids)."""
        src = np.asarray(src).copy()
        dst = np.asarray(dst).copy()
        w = None if w is None else np.asarray(w).copy()

        keep = np.ones(len(src), dtype=bool)
        removed_v = set(self.remove_vertices)
        if removed_v:
            rv = np.fromiter(removed_v, dtype=np.int64)
            keep &= ~np.isin(src, rv)
            keep &= ~np.isin(dst, rv)
        if self.remove_edges:
            keep &= ~_pair_match(src, dst, self.remove_edges)
        if self.update_edges and w is not None:
            hit = _pair_match(src, dst,
                              [(s, d) for s, d, _ in self.update_edges])
            if hit.any():
                upd = {(s, d): x for s, d, x in self.update_edges}
                for i in np.nonzero(hit)[0]:
                    w[i] = upd[(int(src[i]), int(dst[i]))]
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
        if self.add_edges:
            # int64 columns straight from the staged ints: oids above
            # 2^53 never pass through a float64
            src = np.concatenate([src, np.array(
                [s for s, _, _ in self.add_edges], dtype=np.int64)])
            dst = np.concatenate([dst, np.array(
                [d for _, d, _ in self.add_edges], dtype=np.int64)])
            if w is not None:
                w = np.concatenate([w, np.array(
                    [x for _, _, x in self.add_edges], dtype=w.dtype)])
        # the new vertex universe keeps load order; added vertices append
        oids = [o for o in np.asarray(oid_order).tolist()
                if o not in removed_v]
        seen = set(oids)
        for o in self.add_vertices:
            if o not in seen:
                oids.append(o)
                seen.add(o)
        return src, dst, w, np.asarray(oids, dtype=np.int64)

    def mutate(self, frag: ShardedEdgecutFragment) -> ShardedEdgecutFragment:
        """Apply the staged ops and rebuild (reference MutateFragment),
        on `frag`'s device with `frag`'s load options."""
        if frag.edge_list is None:
            raise ValueError(
                "fragment was not built mutable; load with "
                "retain_edge_list=True (LoadGraphAndMutate does this)"
            )
        src, dst, w = frag.edge_list
        old_order = (
            np.concatenate([frag.inner_oids(f) for f in range(frag.fnum)])
            if frag.fnum else np.zeros(0, np.int64)
        )
        src, dst, w, oids = self.apply_to_arrays(src, dst, w, old_order)
        return _build_edgecut(frag.comm_spec, oids, src, dst, w,
                              frag.directed, frag.load_spec)


def _build_edgecut(comm_spec, oids, src, dst, w, directed, spec):
    """The one device build of a mutation, validated under
    GRAPE_VALIDATE_LOAD=1 like every load path.  A fragment built
    without a load spec rebuilds with the default one, as in the JAX
    package."""
    from libgrape_lite_tpu_torch.fragment.loader import (
        LoadGraphSpec,
        _validate_load,
    )

    spec = spec or LoadGraphSpec(directed=directed)
    partitioner = make_partitioner(spec.partitioner_type, comm_spec.fnum,
                                   oids)
    vm = VertexMap.build(oids, partitioner, idxer_type=spec.idxer_type)
    frag = ShardedEdgecutFragment.build(
        comm_spec, vm, src, dst, w,
        directed=directed,
        load_strategy=spec.load_strategy,
        edata_dtype=spec.edata_dtype,
        retain_edge_list=True,
    )
    frag.load_spec = spec
    return _validate_load(frag)


def replicate_fragment(frag: ShardedEdgecutFragment) -> ShardedEdgecutFragment:
    """A fresh, content-identical fragment rebuilt from `frag`'s retained
    edge list: an empty mutation through the rebuild."""
    return BasicFragmentMutator().mutate(frag)


def parse_delta_efile(path: str, weighted: bool, mutator: BasicFragmentMutator,
                      directed: bool) -> None:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            parts = line.split()
            op = parts[0]
            if op == "a":
                s, d = int(parts[1]), int(parts[2])
                w = float(parts[3]) if (weighted and len(parts) > 3) else 0.0
                mutator.AddEdge(s, d, w)
            elif op == "d":
                s, d = int(parts[1]), int(parts[2])
                mutator.RemoveEdge(s, d)
                if not directed:
                    mutator.RemoveEdge(d, s)
            elif op == "u":
                s, d = int(parts[1]), int(parts[2])
                w = float(parts[3]) if len(parts) > 3 else 0.0
                mutator.UpdateEdge(s, d, w)
                if not directed:
                    mutator.UpdateEdge(d, s, w)


def parse_delta_vfile(path: str, mutator: BasicFragmentMutator) -> None:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if parts[0] == "a":
                mutator.AddVertex(int(parts[1]))
            elif parts[0] == "d":
                mutator.RemoveVertex(int(parts[1]))
            elif parts[0] == "u":
                mutator.UpdateVertex(int(parts[1]))


def LoadGraphAndMutate(
    efile: str,
    vfile: str | None,
    delta_efile: str | None,
    delta_vfile: str | None,
    comm_spec: CommSpec,
    spec=None,
) -> ShardedEdgecutFragment:
    """Reference `LoadGraphAndMutate` (`loader.h:59-68`): the delta is
    applied to the parsed host arrays before the one device build, on
    `comm_spec.device`."""
    from libgrape_lite_tpu_torch.fragment.loader import LoadGraphSpec
    from libgrape_lite_tpu_torch.io.line_parser import (
        read_edge_file,
        read_vertex_file,
    )

    spec = spec or LoadGraphSpec()
    src, dst, w = read_edge_file(efile, weighted=spec.weighted,
                                 string_id=spec.string_id)
    if not spec.weighted:
        w = None
    if vfile:
        oids = read_vertex_file(vfile, string_id=spec.string_id)
    else:
        oids = np.unique(np.concatenate([src, dst]))
    mutator = BasicFragmentMutator()
    if delta_vfile:
        parse_delta_vfile(delta_vfile, mutator)
    if delta_efile:
        parse_delta_efile(delta_efile, spec.weighted, mutator, spec.directed)
    src, dst, w, oids = mutator.apply_to_arrays(src, dst, w, oids)
    return _build_edgecut(comm_spec, oids, src, dst, w, spec.directed, spec)
