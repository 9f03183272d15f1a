"""Graph mutation in the port (`libgrape_lite_tpu_torch/fragment/
mutation.py`, the Worker's MutationContext path, `--delta_efile`) on the
CPU, against the JAX package.

* `LoadGraphAndMutate` on p2p-31's mutable base and delta builds CSRs
  identical to the JAX package's (indptr, edge_src, edge_nbr, edge_w,
  edge_mask, oids, the retained edge list) at fnum 1, 2, 4 and 8, and
  the six LDBC apps on it equal the JAX Worker (PageRank within 1e-10
  relative, the rest bit-equal) and the p2p-31 goldens;
* the staged-mutator API, and `d` / `u` lines on undirected graphs,
  rebuild exactly as the JAX package does;
* a MutationContext app (SSSP adding a shortcut after round 2) equals
  the JAX Worker value for value, with equal round counts;
* GRAPE_VALIDATE_LOAD=1 checks the rebuilt CSRs;
* the port's CLI with `--delta_efile` writes result files byte-identical
  to the JAX CLI's.
"""

import os

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JSpec
from libgrape_lite_tpu.fragment.mutation import (
    BasicFragmentMutator as JMutator,
)
from libgrape_lite_tpu.fragment.mutation import (
    LoadGraphAndMutate as JLoadGraphAndMutate,
)
from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch import cli
from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.fragment.loader import LoadGraphSpec
from libgrape_lite_tpu_torch.fragment.mutation import (
    BasicFragmentMutator,
    LoadGraphAndMutate,
    parse_delta_efile,
    replicate_fragment,
)
from libgrape_lite_tpu_torch.models import APP_REGISTRY, SSSP
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.vertex_map.partitioner import MapPartitioner
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_dyn import oid_values
from tests.test_torch_apps import result_dict
from tests.test_torch_substrate import assert_same_fragment
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
BASE, DELTA = "p2p-31.e.mutable_base", "p2p-31.e.mutable_delta"
# app -> (query kwargs, golden, rule)
LDBC = {
    "sssp": ({"source": 6}, "p2p-31-SSSP", exact_verify),
    "bfs": ({"source": 6}, "p2p-31-BFS", exact_verify),
    "pagerank": ({"delta": 0.85, "max_round": 10}, "p2p-31-PR", eps_verify),
    "wcc": ({}, "p2p-31-WCC", wcc_verify),
    "cdlp": ({"max_round": 10}, "p2p-31-CDLP", exact_verify),
    "lcc": ({}, "p2p-31-LCC", eps_verify),
}
_FRAGS = {}


def mutated(fnum):
    """(port fragment, JAX fragment) of p2p-31's mutable base + delta."""
    if fnum not in _FRAGS:
        args = (dataset_path(BASE), dataset_path("p2p-31.v"),
                dataset_path(DELTA), None)
        _FRAGS[fnum] = (
            LoadGraphAndMutate(
                *args, CommSpec(fnum=fnum, device="cpu"),
                LoadGraphSpec(weighted=True, edata_dtype=np.float64)),
            JLoadGraphAndMutate(
                *args, JCommSpec(fnum=fnum),
                JSpec(weighted=True, edata_dtype=np.float64)),
        )
    return _FRAGS[fnum]


def assert_same_rebuild(pfrag, jfrag):
    """Device leaves, host CSRs and the retained edge list all equal."""
    assert_same_fragment(pfrag, jfrag)
    for side in ("host_oe", "host_ie"):
        for pc, jc in zip(getattr(pfrag, side), getattr(jfrag, side)):
            for k in ("indptr", "edge_src", "edge_nbr", "edge_w",
                      "edge_mask"):
                pv, jv = getattr(pc, k), getattr(jc, k)
                assert (pv is None) == (jv is None), k
                if pv is not None:
                    np.testing.assert_array_equal(pv, jv, err_msg=k)
    for f in range(jfrag.fnum):
        np.testing.assert_array_equal(pfrag.inner_oids(f),
                                      jfrag.inner_oids(f))
    for pv, jv in zip(pfrag.edge_list, jfrag.edge_list):
        np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("fnum", FNUMS)
def test_load_graph_and_mutate_matches_jax(fnum):
    pfrag, jfrag = mutated(fnum)
    assert_same_rebuild(pfrag, jfrag)
    assert pfrag.device.type == "cpu"
    assert pfrag.load_spec.edata_dtype == np.float64
    # an empty mutation keeps the load options: the replica is the same
    assert_same_rebuild(replicate_fragment(pfrag), jfrag)


def _port_app(name):
    cls = APP_REGISTRY[name]
    if name in ("sssp", "pagerank"):
        return cls(dtype=torch.float64)
    return cls()


@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("app", list(LDBC))
def test_mutated_load_queries_match_jax_and_goldens(app, fnum):
    kw, golden, rule = LDBC[app]
    pfrag, jfrag = mutated(fnum)
    jw = JWorker(JAPPS[app](), jfrag)
    jw.query(**kw)
    w = Worker(_port_app(app), pfrag)
    w.query(**kw)
    got, want = w.result_values(), jw.result_values()
    assert w.rounds == jw.rounds
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    rule(result_dict(pfrag, got, w.app.result_format),
         load_golden(dataset_path(golden)))


def _small(fnum, lib):
    """tests/test_mutable.py's 4-vertex graph, built mutable."""
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    w = np.array([1.0, 1.0, 10.0])
    oids = np.arange(4, dtype=np.int64)
    if lib == "port":
        vm = VertexMap.build(oids, MapPartitioner(fnum, oids))
        return ShardedEdgecutFragment.build(
            CommSpec(fnum=fnum, device="cpu"), vm, src, dst, w,
            directed=False, retain_edge_list=True)
    from libgrape_lite_tpu.fragment.edgecut import (
        ShardedEdgecutFragment as JFrag,
    )
    from libgrape_lite_tpu.vertex_map.partitioner import (
        MapPartitioner as JMap,
    )
    from libgrape_lite_tpu.vertex_map.vertex_map import VertexMap as JVM

    return JFrag.build(JCommSpec(fnum=fnum), JVM.build(oids, JMap(fnum, oids)),
                       src, dst, w, directed=False, retain_edge_list=True)


def _stage(m):
    m.AddVertex(4)
    m.AddEdge(2, 4, 1.0)
    m.AddEdge(4, 3, 1.0)  # shortcut 2-4-3 cheaper than 2-3 (10)
    m.RemoveEdge(0, 1)
    m.RemoveEdge(1, 0)
    return m


@pytest.mark.parametrize("fnum", FNUMS)
def test_staged_mutator_api(fnum):
    """tests/test_mutable.py::test_staged_mutator_api in the port, and
    the rebuild equal to the JAX package's."""
    frag2 = _stage(BasicFragmentMutator()).mutate(_small(fnum, "port"))
    assert_same_rebuild(frag2, _stage(JMutator()).mutate(_small(fnum, "jax")))
    w = Worker(SSSP(), frag2)
    w.query(source=1)
    got = oid_values(w)
    assert got[0] == np.inf  # edge removed
    assert got[2] == 1.0
    assert got[4] == 2.0  # via the new vertex
    assert got[3] == 3.0  # via the shortcut, not the 10-edge


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("fnum", [1, 4])
def test_delta_efile_d_and_u_orientations(tmp_path, fnum, directed):
    """On undirected graphs `d` and `u` apply to both orientations
    (ev_fragment_mutator.h:118-127): the retained list holds (4, 5) and
    (6, 7), the delta names (5, 4) and (7, 6)."""
    from libgrape_lite_tpu.fragment.mutation import (
        parse_delta_efile as jparse,
    )

    delta = tmp_path / "delta.e"
    delta.write_text("# edits\nd 5 4\nu 7 6 3.5\na 0 7 0.25\n")
    n = 10
    src, dst, w = np.arange(n - 1), np.arange(1, n), np.ones(n - 1)
    oids = np.arange(n, dtype=np.int64)
    frag = ShardedEdgecutFragment.build(
        CommSpec(fnum=fnum, device="cpu"),
        VertexMap.build(oids, MapPartitioner(fnum, oids)), src, dst, w,
        directed=directed, retain_edge_list=True)
    m = BasicFragmentMutator()
    parse_delta_efile(str(delta), True, m, directed)
    jm = JMutator()
    jparse(str(delta), True, jm, directed)
    assert (m.remove_edges, m.update_edges, m.add_edges) == (
        jm.remove_edges, jm.update_edges, jm.add_edges)
    assert len(m.remove_edges) == (1 if directed else 2)
    new = m.mutate(frag)
    from libgrape_lite_tpu.fragment.edgecut import (
        ShardedEdgecutFragment as JFrag,
    )
    from libgrape_lite_tpu.vertex_map.partitioner import (
        MapPartitioner as JMap,
    )
    from libgrape_lite_tpu.vertex_map.vertex_map import VertexMap as JVM

    jfrag = JFrag.build(JCommSpec(fnum=fnum),
                        JVM.build(oids, JMap(fnum, oids)), src, dst, w,
                        directed=directed, retain_edge_list=True)
    assert_same_rebuild(new, jm.mutate(jfrag))
    s, d, ww = new.edge_list
    pairs = dict(zip(zip(s.tolist(), d.tolist()), ww.tolist()))
    assert ((4, 5) in pairs) == directed
    assert pairs[(6, 7)] == (1.0 if directed else 3.5)
    assert pairs[(0, 7)] == 0.25


def _shortcut_app(base):
    """SSSP adding vertex 100 after round 2, bridging 0 -> 100 -> 9 with
    tiny weights (tests/test_mutation_context.py)."""

    class SSSPWithShortcut(base):
        fired = False

        def collect_mutations(self, frag, host_state, rounds):
            if self.fired or rounds != 2:
                return None
            self.fired = True
            m = (BasicFragmentMutator() if base is SSSP else JMutator())
            m.AddVertex(100)
            m.AddEdge(0, 100, 0.5)
            m.AddEdge(100, 9, 0.5)
            return m

    return SSSPWithShortcut()


def _chain(fnum, lib):
    src, dst, w = np.arange(9), np.arange(1, 10), np.ones(9)
    oids = np.arange(10, dtype=np.int64)
    if lib == "port":
        return ShardedEdgecutFragment.build(
            CommSpec(fnum=fnum, device="cpu"),
            VertexMap.build(oids, MapPartitioner(fnum, oids)), src, dst,
            w.astype(np.float64), directed=False, retain_edge_list=True)
    from libgrape_lite_tpu.fragment.edgecut import (
        ShardedEdgecutFragment as JFrag,
    )
    from libgrape_lite_tpu.vertex_map.partitioner import (
        MapPartitioner as JMap,
    )
    from libgrape_lite_tpu.vertex_map.vertex_map import VertexMap as JVM

    return JFrag.build(JCommSpec(fnum=fnum), JVM.build(oids, JMap(fnum, oids)),
                       src, dst, w.astype(np.float64), directed=False,
                       retain_edge_list=True)


@pytest.mark.parametrize("fnum", FNUMS)
def test_mutation_context_shortcut_matches_jax(fnum):
    from libgrape_lite_tpu.models import SSSP as JSSSP

    jw = JWorker(_shortcut_app(JSSSP), _chain(fnum, "jax"))
    jw.query(source=0)
    frag = _chain(fnum, "port")
    w = Worker(_shortcut_app(SSSP), frag)
    w.query(source=0)
    assert w.fragment is not frag and w.app.fired
    got, want = oid_values(w), oid_values(jw)
    assert got == want
    assert got[9] == 1.0 and got[100] == 0.5 and got[5] == 5.0
    assert w.rounds == jw.rounds
    assert_same_rebuild(w.fragment, jw.fragment)


def test_validate_load_checks_the_rebuild(monkeypatch):
    import libgrape_lite_tpu_torch.fragment.edgecut as ec
    from libgrape_lite_tpu_torch.graph.csr import CSRValidationError

    frag = _small(2, "port")
    m = BasicFragmentMutator()
    m.AddEdge(0, 3, 1.0)
    real_build_csr = ec.build_csr

    def corrupt_build_csr(*args, **kwargs):
        csr = real_build_csr(*args, **kwargs)
        if csr.edge_nbr.size:
            csr.edge_nbr[0] = 1 << 28  # out-of-range pid
        return csr

    monkeypatch.setattr(ec, "build_csr", corrupt_build_csr)
    monkeypatch.setenv("GRAPE_VALIDATE_LOAD", "1")
    with pytest.raises(CSRValidationError):
        m.mutate(frag)
    # gate off: the corrupt rebuild passes unvalidated
    monkeypatch.delenv("GRAPE_VALIDATE_LOAD")
    m.mutate(frag)


def _read(prefix, fnum):
    out = []
    for f in range(fnum):
        with open(os.path.join(prefix, f"result_frag_{f}")) as fh:
            out.append(fh.read())
    return out


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("app", ["sssp", "bfs"])
def test_cli_delta_efile_files_match_jax_cli(tmp_path, app, fnum):
    from libgrape_lite_tpu import cli as jcli

    args = ["--application", app, "--efile", dataset_path(BASE),
            "--vfile", dataset_path("p2p-31.v"),
            "--delta_efile", dataset_path(DELTA), "--fnum", str(fnum),
            f"--{app}_source", "6"]
    cli.main(args + ["--out_prefix", str(tmp_path / "port"),
                     "--device", "cpu"])
    jcli.main(args + ["--out_prefix", str(tmp_path / "jax")])
    got = _read(str(tmp_path / "port"), fnum)
    assert got == _read(str(tmp_path / "jax"), fnum)
    golden = load_golden(dataset_path(f"p2p-31-{app.upper()}"))
    exact_verify(load_result_lines("".join(got)), golden)
