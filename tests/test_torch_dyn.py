"""The port's dynamic-graph runtime (`libgrape_lite_tpu_torch/dyn/`) on
the CPU, against the JAX package on the same seeded graphs.

* the delta buffer and the op grammar behave as the JAX package's;
* the overlay's side arrays equal the JAX overlay's, and each
  fragment's real slots come first, sorted by `src`;
* overlay queries (sssp, bfs, wcc, wcc_opt, khop, sssp_select) equal
  the JAX overlay query and a cold query on the repacked graph, bit for
  bit, with the same round counts, at fnum 1, 2, 4 and 8;
* repack decisions carry the JAX package's modes and reasons;
* apps without an overlay contract -- PageRank, and in the port the
  three auto apps, whose push reads no overlay -- are refused while
  staged edges exist and run after `fold_now`;
* `query_incremental` equals the cold query, with the JAX package's
  seeded round counts, and falls back cold where JAX does;
* every registry name shares the JAX contracts, the auto apps'
  `dyn_overlay_support` excepted.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.dyn import DynGraph as JDynGraph
from libgrape_lite_tpu.dyn import RepackPolicy as JRepackPolicy
from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.dyn import (
    DeltaBuffer,
    DeltaOverflowError,
    DeltaOverlay,
    DynGraph,
    RepackPolicy,
    parse_ops_line,
)
from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.fragment.mutation import same_layout
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.vertex_map.partitioner import MapPartitioner
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests import test_dyn as jdyn
from tests.test_dyn import ADDS, oid_bytes, oid_values

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
OVERLAY_APPS = ["sssp", "bfs", "wcc", "wcc_opt", "khop", "sssp_select"]


def _edges_graph(fnum, n, seed, edge_factor):
    rng = np.random.default_rng(seed)
    e = edge_factor * n
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.uniform(0.5, 2.0, e))


def _build(fnum, n, src, dst, w, directed=False):
    oids = np.arange(n, dtype=np.int64)
    vm = VertexMap.build(oids, MapPartitioner(fnum, oids))
    return ShardedEdgecutFragment.build(
        CommSpec(fnum=fnum, device="cpu"), vm, src, dst, w,
        directed=directed, retain_edge_list=True)


def build_graph(fnum, n=32, seed=3, edge_factor=4, directed=False):
    """tests/test_dyn.py's build_graph, in the port."""
    return _build(fnum, n, *_edges_graph(fnum, n, seed, edge_factor),
                  directed=directed)


def build_path(fnum, n=24):
    """tests/test_dyn.py's build_path, in the port."""
    return _build(fnum, n, np.arange(n - 1), np.arange(1, n),
                  np.ones(n - 1))


def jax_build_directed(fnum, n=32, seed=3, edge_factor=4):
    from libgrape_lite_tpu.fragment.edgecut import (
        ShardedEdgecutFragment as JFrag,
    )
    from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
    from libgrape_lite_tpu.vertex_map.partitioner import (
        MapPartitioner as JMap,
    )
    from libgrape_lite_tpu.vertex_map.vertex_map import VertexMap as JVM

    src, dst, w = _edges_graph(fnum, n, seed, edge_factor)
    oids = np.arange(n, dtype=np.int64)
    return JFrag.build(JCommSpec(fnum=fnum), JVM.build(oids, JMap(fnum, oids)),
                       src, dst, w, directed=True, retain_edge_list=True)


def _kw(app):
    return {} if app.startswith("wcc") else {"source": 0}


# ---- delta buffer --------------------------------------------------------


def test_delta_buffer_typed_and_bounded():
    buf = DeltaBuffer(capacity=4)
    assert buf.stage([("a", 1, 2, 0.5), ("d", 3, 4), ("u", 5, 6, 1.0)]) == 3
    assert buf.n_edge_ops == 3 and not buf.additive_only
    buf.add_vertex(9)
    with pytest.raises(DeltaOverflowError):
        buf.add_edge(7, 8)
    s = buf.summary()
    assert (s.n_add_edges, s.n_remove_edges, s.n_update_edges,
            s.n_add_vertices) == (1, 1, 1, 1)
    assert set(s.touched_oids) == {1, 2, 3, 4, 5, 6, 9}
    assert s.n_edge_ops == 3 and s.n_ops == 4

    add_only = DeltaBuffer()
    add_only.stage([("a", 1, 2, 0.5)])
    assert add_only.additive_only
    assert add_only.delta_ratio(100) == pytest.approx(0.01)

    assert parse_ops_line("a 3 4 1.5") == ("a", 3, 4, 1.5)
    assert parse_ops_line("d 3 4") == ("d", 3, 4)
    assert parse_ops_line("# comment") is None
    with pytest.raises(ValueError, match="unknown delta op"):
        parse_ops_line("x 1 2")
    with pytest.raises(ValueError, match="malformed 'u' op"):
        parse_ops_line("u 3 5")
    with pytest.raises(ValueError, match="malformed 'a' op"):
        parse_ops_line("a 3 5", weighted=True)
    assert parse_ops_line("a 3 5", weighted=False) == ("a", 3, 5, 0.0)
    for bad in ("d 5", "a 5", "av", "dv", "u 3"):
        with pytest.raises(ValueError, match="malformed"):
            parse_ops_line(bad)

    # stage() is atomic against the bound and against malformed input
    small = DeltaBuffer(capacity=2)
    with pytest.raises(DeltaOverflowError):
        small.stage([("a", 1, 2, 0.5), ("a", 2, 3, 0.5), ("a", 3, 4, 0.5)])
    assert small.n_ops == 0
    with pytest.raises(ValueError, match="malformed delta op"):
        small.stage([("a", 1, 2, 0.5), ("x", 3)])
    assert small.n_ops == 0


def test_parse_ops_file_matches_jax(tmp_path):
    from libgrape_lite_tpu.dyn import parse_ops_file as jparse

    from libgrape_lite_tpu_torch.dyn import parse_ops_file

    p = tmp_path / "ops.txt"
    p.write_text("# stream\na 1 2 0.5\nd 3 4\n\nu 5 6 2.0\nav 9\ndv 8\n")
    assert parse_ops_file(str(p)) == jparse(str(p))
    assert parse_ops_file(str(p), string_id=True) == jparse(
        str(p), string_id=True)


# ---- the overlay's side arrays -------------------------------------------


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("fnum", FNUMS)
def test_overlay_side_arrays_match_jax(fnum, directed):
    from libgrape_lite_tpu.dyn import DeltaOverlay as JOverlay

    adds = [(int(s), int(d), float(w)) for _, s, d, w in ADDS] + [
        (5, 6, 0.25), (6, 5, 0.75), (31, 0, 1.5)]
    pfrag = build_graph(fnum, directed=directed)
    jfrag = (jax_build_directed(fnum) if directed
             else jdyn.build_graph(fnum))
    pov, preason = DeltaOverlay.build(pfrag, adds, 16)
    jov, jreason = JOverlay.build(jfrag, adds, 16)
    assert preason is None and jreason is None and pov.count == jov.count
    for d in ("ie", "oe"):
        # the fragment's edata type (float32), the weight type SSSP asks
        # for in both packages
        pe = pov.entries(d, np.float32)
        je = jov.entries(d, np.float32)
        for k, v in je.items():
            np.testing.assert_array_equal(pe[k], v, err_msg=k)
            assert pe[k].dtype == v.dtype, k
        side, jside = getattr(pov, d), getattr(jov, d)
        np.testing.assert_array_equal(side.w, jside.w)  # float64 values
        for f in range(fnum):
            n = int(side.mask[f].sum())
            assert side.mask[f, :n].all()
            assert (np.diff(side.src[f, :n]) >= 0).all()
            assert (side.src[f, n:] == pfrag.vp).all()
    # capacity overflow and unknown endpoints decline with JAX's reasons
    assert DeltaOverlay.build(pfrag, adds, 2)[1] == JOverlay.build(
        jfrag, adds, 2)[1]
    assert DeltaOverlay.build(pfrag, [(0, 999, 1.0)], 16)[1] == \
        JOverlay.build(jfrag, [(0, 999, 1.0)], 16)[1]


# ---- overlay queries -----------------------------------------------------


@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("app", OVERLAY_APPS)
def test_overlay_query_matches_jax_and_repack(app, fnum):
    jdg = JDynGraph(jdyn.build_graph(fnum),
                    JRepackPolicy(threshold=0.9, capacity=64))
    assert jdg.ingest(ADDS)["mode"] == "overlay"
    jw = JWorker(JAPPS[app](), jdg.fragment)
    jw.query(**_kw(app))

    frag = build_graph(fnum)
    dg = DynGraph(frag, RepackPolicy(threshold=0.9, capacity=64))
    rep = dg.ingest(ADDS)
    assert rep["mode"] == "overlay" and dg.fragment is frag
    w = Worker(APP_REGISTRY[app](), dg.fragment)
    w.query(**_kw(app))

    dg2 = DynGraph(build_graph(fnum), RepackPolicy(threshold=0.0))
    assert dg2.ingest(ADDS)["mode"] == "repack"
    wc = Worker(APP_REGISTRY[app](), dg2.fragment)
    wc.query(**_kw(app))

    assert oid_bytes(w) == oid_bytes(jw)
    assert oid_bytes(w) == oid_bytes(wc)
    assert w.rounds == jw.rounds


@pytest.mark.parametrize("fnum", [1, 4])
def test_directed_wcc_overlay_folds_both_directions(fnum):
    """Directed WCC folds the ie overlay into its ie pull and the oe
    overlay into its oe pull, as the JAX package does."""
    adds = [("a", 0, 17, 1.0), ("a", 30, 2, 1.0), ("a", 9, 21, 1.0)]
    jdg = JDynGraph(jax_build_directed(fnum),
                    JRepackPolicy(threshold=0.9, capacity=64))
    assert jdg.ingest(adds)["mode"] == "overlay"
    jw = JWorker(JAPPS["wcc"](), jdg.fragment)
    jw.query()
    dg = DynGraph(build_graph(fnum, directed=True),
                  RepackPolicy(threshold=0.9, capacity=64))
    assert dg.ingest(adds)["mode"] == "overlay"
    w = Worker(APP_REGISTRY["wcc"](), dg.fragment)
    state = w.query()
    assert {"dyn_ie_src", "dyn_oe_src"} <= w.app.ephemeral_keys
    assert "dyn_ie_src" not in state
    dg2 = DynGraph(build_graph(fnum, directed=True),
                   RepackPolicy(threshold=0.0))
    dg2.ingest(adds)
    wc = Worker(APP_REGISTRY["wcc"](), dg2.fragment)
    wc.query()
    assert oid_bytes(w) == oid_bytes(jw) == oid_bytes(wc)
    assert w.rounds == jw.rounds


def test_overlay_weights_pass_through_the_edata_type():
    """An f64 overlay weight reaches a float64 SSSP through the
    fragment's float32 edata, as the repacked CSR's weights do."""
    adds = [("a", 0, 17, 0.1), ("a", 17, 31, 0.3)]
    dg = DynGraph(build_graph(2), RepackPolicy(threshold=0.9, capacity=64))
    dg.ingest(adds)
    w = Worker(APP_REGISTRY["sssp"](dtype=torch.float64), dg.fragment)
    w.query(source=0)
    dg2 = DynGraph(build_graph(2), RepackPolicy(threshold=0.0))
    dg2.ingest(adds)
    wc = Worker(APP_REGISTRY["sssp"](dtype=torch.float64), dg2.fragment)
    wc.query(source=0)
    assert oid_bytes(w) == oid_bytes(wc)


def test_empty_overlay_is_inert():
    plain = build_graph(2)
    managed = build_graph(2)
    DynGraph(managed, RepackPolicy())
    assert managed.dyn_overlay is not None and plain.dyn_overlay is None
    w1 = Worker(APP_REGISTRY["sssp"](), plain)
    w1.query(source=0)
    w2 = Worker(APP_REGISTRY["sssp"](), managed)
    w2.query(source=0)
    assert oid_bytes(w1) == oid_bytes(w2)
    # nothing staged, nothing folded: no overlay entries at all
    assert not any(k.startswith("dyn_") for k in w2.app.ephemeral_keys)


# ---- repack decisions ----------------------------------------------------


def test_stream_longer_than_capacity_folds_and_continues():
    dg = DynGraph(build_graph(1, n=64, edge_factor=8),
                  RepackPolicy(threshold=10.0, capacity=8))
    jdg = JDynGraph(jdyn.build_graph(1, n=64, edge_factor=8),
                    JRepackPolicy(threshold=10.0, capacity=8))
    rng = np.random.default_rng(11)
    ops = [("a", int(s), int(d), 1.0) for s, d in
           zip(rng.integers(0, 64, 20), rng.integers(0, 64, 20))]
    for lo in range(0, 20, 5):
        rep, jrep = dg.ingest(ops[lo:lo + 5]), jdg.ingest(ops[lo:lo + 5])
        assert (rep["mode"], rep["reason"]) == (jrep["mode"], jrep["reason"])
    assert dg.stats == jdg.stats
    assert dg.stats["ingested"] == 20 and dg.stats["repacks"] >= 2
    pending = dg.buffer.n_edge_ops
    assert dg.fragment.total_edges_num + pending == 64 * 8 + 20
    w = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    w.query(source=0)
    jw = JWorker(JAPPS["sssp"](), jdg.fragment)
    jw.query(source=0)
    assert oid_bytes(w) == oid_bytes(jw)


@pytest.mark.parametrize("fnum", [1, 2])
def test_nonadditive_and_unknown_endpoints_force_repack(fnum):
    cases = [
        [("d", 0, 1)],
        [("av", 999), ("a", 0, 999, 1.0)],
        [("a", 0, 999, 1.0)],  # unknown endpoint: the overlay declines
        [("u", 3, 4, 2.0)],
        ADDS * 20,  # 60 ops fit the buffer, their 120 slots do not
    ]
    reasons = []
    for ops in cases:
        dg = DynGraph(build_graph(fnum),
                      RepackPolicy(threshold=0.9, capacity=64))
        jdg = JDynGraph(jdyn.build_graph(fnum),
                        JRepackPolicy(threshold=0.9, capacity=64))
        if ops[0] == ("a", 0, 999, 1.0):
            # a repack cannot build an edge to an unknown vertex: both
            # packages refuse it at the rebuild
            with pytest.raises(ValueError):
                dg.ingest(ops)
            with pytest.raises(ValueError):
                jdg.ingest(ops)
            assert DeltaOverlay.build(dg.fragment, dg.buffer.add_edges,
                                      64)[1] == \
                "edge endpoint(s) outside the vertex map"
            continue
        rep, jrep = dg.ingest(ops), jdg.ingest(ops)
        assert rep["mode"] == jrep["mode"] == "repack"
        assert rep["reason"] == jrep["reason"]
        reasons.append(rep["reason"])
        assert asdict(rep["delta"]) == asdict(jrep["delta"])
        if ops[0][0] == "av":
            assert int(dg.fragment.oid_to_pid(np.array([999]))[0]) >= 0
        assert dg.fragment.device.type == "cpu"
    assert reasons[:3] == ["non-additive ops cannot ride the min-fold "
                           "overlay"] * 3
    assert reasons[3] == "overlay capacity (64 slots/fragment) exceeded"


def test_undirected_removal_applies_both_orientations():
    dg = DynGraph(build_path(1, n=8), RepackPolicy(threshold=0.0))
    assert dg.ingest([("d", 5, 4)])["mode"] == "repack"
    w = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    w.query(source=0)
    vals = oid_values(w)
    assert vals[4] == 4.0
    assert vals[5] == np.inf


# ---- the stale-view refusal ----------------------------------------------


@pytest.mark.parametrize("app", ["pagerank", "sssp_auto", "bfs_auto",
                                 "wcc_auto"])
def test_uncontracted_apps_refused_then_run_after_fold(app):
    fnum = 2
    dg = DynGraph(build_graph(fnum), RepackPolicy(threshold=0.9,
                                                  capacity=64))
    dg.ingest(ADDS)
    kw = {"max_round": 3} if app == "pagerank" else _kw(app)
    w = Worker(APP_REGISTRY[app](), dg.fragment)
    with pytest.raises(ValueError, match="no dyn-overlay contract"):
        w.query(**kw)
    dg.fold_now()
    assert dg.overlay_count == 0
    w.fragment = dg.fragment
    w.query(**kw)
    if app == "pagerank":
        assert w.rounds == 3
        return
    dg2 = DynGraph(build_graph(fnum), RepackPolicy(threshold=0.0))
    dg2.ingest(ADDS)
    base = {"sssp_auto": "sssp", "bfs_auto": "bfs", "wcc_auto": "wcc"}[app]
    wc = Worker(APP_REGISTRY[base](), dg2.fragment)
    wc.query(**kw)
    assert oid_bytes(w) == oid_bytes(wc)


def test_host_only_apps_are_checked_too():
    dg = DynGraph(build_graph(1), RepackPolicy(threshold=0.9, capacity=64))
    dg.ingest(ADDS)
    with pytest.raises(ValueError, match="no dyn-overlay contract"):
        Worker(APP_REGISTRY["sssp_msg"](), dg.fragment).query(source=0)


# ---- incremental IncEval -------------------------------------------------


@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("app", ["sssp", "bfs", "wcc"])
def test_incremental_over_repack_matches_jax_and_cold(app, fnum):
    kw = _kw(app)
    delta = [("a", 4, 20, 0.5)]

    jbase = jdyn.build_path(fnum)
    jprev = JWorker(JAPPS[app](), jbase).query(**kw)
    jdg = JDynGraph(jbase, JRepackPolicy(threshold=0.0))
    jdg.stage(delta)
    jsum = jdg.summary()
    jdg.apply()
    jw = JWorker(JAPPS[app](), jdg.fragment)
    jw.query_incremental(jprev, jsum, prev_fragment=jbase, **kw)

    base = build_path(fnum)
    prev = Worker(APP_REGISTRY[app](), base).query(**kw)
    dg = DynGraph(base, RepackPolicy(threshold=0.0))
    dg.stage(delta)
    summary = dg.summary()
    assert dg.apply()["mode"] == "repack"
    w = Worker(APP_REGISTRY[app](), dg.fragment)
    w.query_incremental(prev, summary, prev_fragment=base, **kw)
    assert w.inc_report == jw.inc_report
    assert w.inc_report["mode"] == "seeded" and w.inc_stats["seeded"] == 1
    # an add between known vertices keeps every row: the seed folds in
    # place, with no oid migration
    assert same_layout(base, dg.fragment)

    wc = Worker(APP_REGISTRY[app](), dg.fragment)
    wc.query(**kw)
    assert oid_bytes(w) == oid_bytes(wc) == oid_bytes(jw)
    assert w.rounds == jw.rounds
    assert w.rounds < wc.rounds


@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_incremental_over_overlay(fnum):
    jdg = JDynGraph(jdyn.build_path(fnum),
                    JRepackPolicy(threshold=0.9, capacity=64))
    jprev = JWorker(JAPPS["sssp"](), jdg.fragment).query(source=0)
    jdg.ingest([("a", 4, 20, 0.5)])
    jw = JWorker(JAPPS["sssp"](), jdg.fragment)
    jw.query_incremental(jprev, jdg.summary(), source=0)

    dg = DynGraph(build_path(fnum), RepackPolicy(threshold=0.9, capacity=64))
    prev = Worker(APP_REGISTRY["sssp"](), dg.fragment).query(source=0)
    dg.ingest([("a", 4, 20, 0.5)])
    w = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    w.query_incremental(prev, dg.summary(), source=0)
    assert w.inc_report["mode"] == "seeded"
    wc = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    wc.query(source=0)
    assert oid_bytes(w) == oid_bytes(wc) == oid_bytes(jw)
    assert w.rounds == jw.rounds < wc.rounds


@pytest.mark.parametrize("fnum", [2, 4])
def test_incremental_resident_worker_across_repack(fnum):
    base = build_path(fnum)
    w = Worker(APP_REGISTRY["sssp"](), base)
    prev = w.query(source=0)
    dg = DynGraph(base, RepackPolicy(threshold=0.0))
    rep = dg.ingest([("a", 4, 20, 0.5)])
    assert rep["mode"] == "repack"
    w.fragment = dg.fragment
    w.query_incremental(prev, rep["delta"], source=0)
    assert w.inc_report["mode"] == "seeded"
    wc = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    wc.query(source=0)
    assert oid_bytes(w) == oid_bytes(wc)
    assert w.rounds < wc.rounds


def test_incremental_cold_fallbacks_match_jax():
    # non-additive: a removed edge breaks the upper-bound property
    jbase = jdyn.build_graph(1)
    jprev = JWorker(JAPPS["sssp"](), jbase).query(source=0)
    base = build_graph(1)
    prev = Worker(APP_REGISTRY["sssp"](), base).query(source=0)
    edge = ("d", int(base.edge_list[0][0]), int(base.edge_list[1][0]))
    assert edge == ("d", int(jbase.edge_list[0][0]),
                    int(jbase.edge_list[1][0]))
    jdg = JDynGraph(jbase, JRepackPolicy(threshold=0.0))
    jdg.stage([edge])
    jsum = jdg.summary()
    jdg.apply()
    jw = JWorker(JAPPS["sssp"](), jdg.fragment)
    jw.query_incremental(jprev, jsum, prev_fragment=jbase, source=0)
    dg = DynGraph(base, RepackPolicy(threshold=0.0))
    dg.stage([edge])
    summary = dg.summary()
    dg.apply()
    w = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    w.query_incremental(prev, summary, prev_fragment=base, source=0)
    assert w.inc_report == jw.inc_report
    assert w.inc_report["mode"] == "cold" and w.inc_stats["cold"] == 1
    wc = Worker(APP_REGISTRY["sssp"](), dg.fragment)
    wc.query(source=0)
    assert oid_bytes(w) == oid_bytes(wc) == oid_bytes(jw)

    # PageRank: fixed-round iteration declares the restart contract
    add = DeltaBuffer()
    add.stage([("a", 0, 17, 0.01)])
    wp = Worker(APP_REGISTRY["pagerank"](), build_graph(1))
    prev_p = wp.query(max_round=5)
    wp2 = Worker(APP_REGISTRY["pagerank"](), wp.fragment)
    wp2.query_incremental(prev_p, add.summary(), max_round=5)
    assert wp2.inc_report["mode"] == "cold"
    assert "restart" in wp2.inc_report["reason"]

    # an empty delta description is not "nothing changed"
    we = Worker(APP_REGISTRY["sssp"](), build_graph(1))
    prev_e = we.query(source=0)
    we2 = Worker(APP_REGISTRY["sssp"](), we.fragment)
    we2.query_incremental(prev_e, DeltaBuffer().summary(), source=0)
    assert we2.inc_report["mode"] == "cold"
    assert "empty delta" in we2.inc_report["reason"]
    # no contract (khop) and no description
    wk = Worker(APP_REGISTRY["khop"](), build_graph(1))
    wk.query_incremental({}, add.summary(), source=0)
    assert "no incremental contract" in wk.inc_report["reason"]
    ws = Worker(APP_REGISTRY["sssp"](), build_graph(1))
    ws.query_incremental(prev_e, None, source=0)
    assert ws.inc_report["reason"].startswith("no delta description")


@pytest.mark.parametrize("fnum", [2, 4])
def test_wcc_inc_value_map_across_repack(fnum):
    """Labels are pids: across a repack that adds a vertex at the front
    of the pid order they are re-addressed by oid, as in JAX."""
    from libgrape_lite_tpu.fragment.mutation import (
        BasicFragmentMutator as JMut,
    )

    from libgrape_lite_tpu_torch.fragment.mutation import (
        BasicFragmentMutator,
    )

    base = build_graph(fnum, n=32, edge_factor=1)
    jbase = jdyn.build_graph(fnum, n=32, edge_factor=1)
    prev = Worker(APP_REGISTRY["wcc"](), base).query()
    jprev = JWorker(JAPPS["wcc"](), jbase).query()
    m, jm = BasicFragmentMutator(), JMut()
    for mm in (m, jm):
        mm.AddVertex(100)
        mm.AddEdge(100, 3, 1.0)
    new, jnew = m.mutate(base), jm.mutate(jbase)
    got = APP_REGISTRY["wcc"]().inc_value_map(
        "comp", prev["comp"].numpy(), base, new)
    want = JAPPS["wcc"]().inc_value_map(
        "comp", np.asarray(jprev["comp"]), jbase, jnew)
    np.testing.assert_array_equal(got, want)
    assert not same_layout(base, new)  # rows migrate by oid
    # a new vertex with one edge only adds min candidates, so seeding is
    # exact; DeltaBuffer counts vertex ops as non-additive (it cannot see
    # that), so an add-only description reaches the migration path
    summary = DeltaBuffer()
    summary.stage([("a", 100, 3, 1.0)])
    w = Worker(APP_REGISTRY["wcc"](), new)
    w.query_incremental(prev, summary.summary(), prev_fragment=base)
    wc = Worker(APP_REGISTRY["wcc"](), new)
    wc.query()
    assert oid_bytes(w) == oid_bytes(wc)
    # SSSP across the same layout change: migrated rows, fresh new row
    prev_s = Worker(APP_REGISTRY["sssp"](), base).query(source=0)
    ws = Worker(APP_REGISTRY["sssp"](), new)
    ws.query_incremental(prev_s, summary.summary(), prev_fragment=base,
                         source=0)
    wsc = Worker(APP_REGISTRY["sssp"](), new)
    wsc.query(source=0)
    assert ws.inc_report["mode"] == "seeded"
    assert oid_bytes(ws) == oid_bytes(wsc)


# ---- contracts -----------------------------------------------------------


def test_registry_contracts_match_jax():
    """Every registry name the port shares with JAX declares the JAX
    package's dyn contracts and replicated keys.  The one exception: the
    auto apps' push reads no overlay, so the port refuses them while
    staged edges exist instead of answering on the stale graph."""
    refused = {"sssp_auto", "bfs_auto", "wcc_auto"}

    def replicated(c):
        # a class may declare them as a property (the JAX package's
        # PageRankVCReplicated): read an instance's then
        keys = c.replicated_keys
        return set(c().replicated_keys if isinstance(keys, property)
                   else keys)

    for name, cls in APP_REGISTRY.items():
        jcls = JAPPS[name]
        assert cls.inc_mode == jcls.inc_mode, name
        assert dict(cls.inc_seed_keys) == dict(jcls.inc_seed_keys), name
        assert replicated(cls) == replicated(jcls), name
        if name in refused:
            assert jcls.dyn_overlay_support and not cls.dyn_overlay_support
        else:
            assert cls.dyn_overlay_support == jcls.dyn_overlay_support, name


def test_spgemm_decline_recorded_with_overlay(monkeypatch):
    from libgrape_lite_tpu_torch.ops import spgemm_pack

    monkeypatch.setenv("GRAPE_LCC_BACKEND", "spgemm")
    from libgrape_lite_tpu.ops import spgemm_pack as jsp

    frag = build_graph(2)
    jfrag = jdyn.build_graph(2)
    assert spgemm_pack.resolve_lcc_backend("lcc_opt", frag) == "spgemm"
    DynGraph(frag, RepackPolicy())
    JDynGraph(jfrag, JRepackPolicy())
    assert spgemm_pack.resolve_lcc_backend("lcc_opt", frag) == "intersect"
    assert jsp.resolve_lcc_backend("lcc_opt", jfrag) == "intersect"
    rec = spgemm_pack.SPGEMM_STATS["declines"][-1]
    assert rec == jsp.SPGEMM_STATS["declines"][-1]
    assert rec["app"] == "lcc_opt" and rec["requested"] == "spgemm"
    assert "dyn overlay attached" in rec["reason"]
