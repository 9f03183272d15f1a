"""The staged overlay and incremental queries across processes on the CPU
(gloo), against one process and the JAX package.

One scenario (`SCENARIO`) runs on a two-rank gloo group (each rank a
child process with its own DynGraph over p2p-31 at fnum 4) and, in this
process, on one process over the same fragment; every result is compared
with the one-process run's, bit for bit, with equal rounds and
`overlay_fold` calls:

* seeded adds staged through `DynGraph.ingest` on every rank ride the
  overlay; each rank places only its `[fl, capacity]` slot planes, rows
  `fid_lo ..` of the one-process planes; SSSP, BFS and WCC over it equal
  the JAX package's overlay query and the cold query after the repack;
* `query_incremental` after more adds (over the overlay, and across the
  repack that folds them) is seeded, equal to the cold query in fewer
  rounds;
* across a rebuild that moves rows (a new vertex first in the pid
  order), the seed migrates the whole previous result by oid (gathered
  across ranks, cut back to the slab); WCC's pid labels are re-addressed;
* a non-additive delta and PageRank run cold, counted in
  `inc_stats["cold"]`;
* a rank that stages other ops than rank 0 raises on every rank at
  `apply`, before any query.
"""

import pickle
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.dyn import DynGraph as JDynGraph
from libgrape_lite_tpu.dyn import RepackPolicy as JRepackPolicy
from libgrape_lite_tpu.fragment.loader import LoadGraph as JLoadGraph
from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JLoadGraphSpec
from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from tests.test_torch_dist import P2P, free_port, run_gang

torch.set_num_threads(1)

FNUM = 4

# The scenario: `run(spec)` -> a record of host values, on one process
# (a CommSpec without a group) or on a rank of a group.
SCENARIO = r'''
import numpy as np
import torch

from libgrape_lite_tpu_torch.dyn import DeltaBuffer, DynGraph, RepackPolicy
from libgrape_lite_tpu_torch.dyn.ingest import overlay_state_entries
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.fragment.mutation import (
    BasicFragmentMutator,
    same_layout,
)
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.worker.worker import Worker

APPS = {"sssp": {"source": 6}, "bfs": {"source": 6}, "wcc": {}}
NEW_OID = 0  # no p2p-31 vertex has it: the first oid of the pid order
FOLDS = [0]
_fold = spmv.overlay_fold


def counted_fold(*a, **kw):
    FOLDS[0] += 1
    return _fold(*a, **kw)


spmv.overlay_fold = counted_fold


def make(app):
    if app == "sssp":
        return APP_REGISTRY["sssp"](dtype=torch.float64)
    if app == "pagerank":
        return APP_REGISTRY["pagerank"](dtype=torch.float64)
    return APP_REGISTRY[app]()


def load(spec):
    return LoadGraph(EFILE, VFILE, spec, LoadGraphSpec(
        weighted=True, edata_dtype=np.float64, retain_edge_list=True))


def adds(frag, n, seed):
    """n seeded edge additions between known vertices."""
    oids = np.sort(np.concatenate([frag.inner_oids(f)
                                   for f in range(frag.fnum)]))
    rng = np.random.default_rng(seed)
    s, d = rng.choice(oids, n), rng.choice(oids, n)
    w = rng.uniform(0.1, 10.0, n).round(4)
    return [("a", int(a), int(b), float(x)) for a, b, x in zip(s, d, w)]


def query(frag, app, rec, key, **kw):
    """Run one query; record its values, rounds and overlay folds."""
    w = Worker(make(app), frag)
    FOLDS[0] = 0
    prev = w.query(**APPS[app], **kw)
    rec[key] = dict(values=w.result_values(), rounds=w.rounds,
                    folds=FOLDS[0])
    return w, prev


def incremental(w, prev, change, rec, key, **kw):
    FOLDS[0] = 0
    w.query_incremental(prev, change, **kw)
    rec[key] = dict(values=w.result_values(), rounds=w.rounds,
                    folds=FOLDS[0], inc=dict(w.inc_stats),
                    mode=w.inc_report["mode"])


def run(spec):
    rec = {}
    frag = load(spec)
    # (1) the staged overlay
    dg = DynGraph(frag, RepackPolicy(threshold=0.9, capacity=256))
    rep = dg.ingest(adds(frag, 64, 13))
    rec["mode"] = rep["mode"]
    rec["planes"] = {k: v.numpy() for k, v in overlay_state_entries(
        dg.fragment, "ie", np.float64, "dyn_ie_").items()}
    prevs = {app: query(dg.fragment, app, rec, f"overlay {app}")[1]
             for app in APPS}
    # (2) incremental over the overlay: 32 more adds
    rep2 = dg.ingest(adds(frag, 32, 14))
    rec["mode2"] = rep2["mode"]
    colds = {}
    for app in APPS:
        w = Worker(make(app), dg.fragment)
        incremental(w, prevs[app], rep2["delta"], rec, f"inc overlay {app}",
                    **APPS[app])
        colds[app] = query(dg.fragment, app, rec, f"cold overlay {app}")[1]
    # (3) the repack folds the 96 adds: cold on it equals the overlay;
    # seeded across it (the same layout: the fold runs on the slab)
    old = dg.fragment
    rep3 = dg.fold_now()
    rec["mode3"] = rep3["mode"]
    rec["same_layout3"] = same_layout(old, dg.fragment)
    for app in APPS:
        query(dg.fragment, app, rec, f"cold repack {app}")
        w = Worker(make(app), dg.fragment)
        incremental(w, colds[app], rep3["delta"], rec, f"inc repack {app}",
                    prev_fragment=old, **APPS[app])
    # (4) a rebuild that moves rows: a new vertex first in the pid order,
    # one edge to it (add-only description: migrate_rows by oid)
    base = load(spec)
    m = BasicFragmentMutator()
    m.AddVertex(NEW_OID)
    m.AddEdge(NEW_OID, 6, 0.5)
    moved = m.mutate(base)
    rec["same_layout4"] = same_layout(base, moved)
    summary = DeltaBuffer()
    summary.stage([("a", NEW_OID, 6, 0.5)])
    for app in APPS:
        prev = Worker(make(app), base).query(**APPS[app])
        w = Worker(make(app), moved)
        incremental(w, prev, summary.summary(), rec, f"inc moved {app}",
                    prev_fragment=base, **APPS[app])
        query(moved, app, rec, f"cold moved {app}")
    # (5) the cold fallbacks: a removal, and PageRank
    dg5 = DynGraph(load(spec), RepackPolicy(threshold=0.9, capacity=256))
    w, prev = query(dg5.fragment, "sssp", rec, "pre removal sssp")
    rep5 = dg5.ingest([("d", 6, 4)])
    w.fragment = dg5.fragment
    incremental(w, prev, rep5["delta"], rec, "inc removal sssp", source=6)
    query(dg5.fragment, "sssp", rec, "cold removal sssp")
    pr = Worker(make("pagerank"), base)
    prev = pr.query(delta=0.85, max_round=10)
    # (the damping stays the app's 0.85: `delta` names the change here)
    incremental(pr, prev, summary.summary(), rec, "inc pagerank",
                max_round=10)
    return rec
'''

CHILD = r'''
import pickle, sys
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec

rank, world, port, efile, vfile, out, mode = sys.argv[1:8]
rank, world = int(rank), int(world)
spec = CommSpec.init_distributed(f"127.0.0.1:{port}", world, rank,
                                 fnum=FNUM, device="cpu")
ns = {"EFILE": efile, "VFILE": vfile}
exec(SCENARIO, ns)
if mode == "diverge":
    from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy

    frag = ns["load"](spec)
    dg = DynGraph(frag, RepackPolicy(threshold=0.9, capacity=256))
    ops = ns["adds"](frag, 16, 13 + rank)  # rank 1 stages other ops
    try:
        dg.ingest(ops)
        rec = {"raised": None}
    except Exception as e:
        rec = {"raised": type(e).__name__, "msg": str(e),
               "count": dg.overlay_count}
else:
    rec = ns["run"](spec)
with open(out, "wb") as fh:
    pickle.dump(rec, fh)
spec.close()
'''.replace("FNUM", str(FNUM)).replace(
    "exec(SCENARIO, ns)", "exec(" + repr(SCENARIO) + ", ns)")

APP_NAMES = ("sssp", "bfs", "wcc")


def _gang(tmp_path, mode, world=2):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    port = free_port()
    outs = run_gang(lambda r: [sys.executable, str(script), str(r),
                               str(world), str(port), P2P[0], P2P[1],
                               str(tmp_path / f"r{r}.pkl"), mode], world)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    recs = []
    for r in range(world):
        with open(tmp_path / f"r{r}.pkl", "rb") as fh:
            recs.append(pickle.load(fh))
    return recs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process record, the two ranks' records)."""
    ns = {"EFILE": P2P[0], "VFILE": P2P[1]}
    exec(SCENARIO, ns)
    one = ns["run"](CommSpec(FNUM, "cpu"))
    return one, _gang(tmp_path_factory.mktemp("dist_dyn_overlay"), "run")


def _same(got, want, what):
    assert got["rounds"] == want["rounds"], what
    assert got["folds"] == want["folds"], what
    assert got["values"].dtype == want["values"].dtype, what
    assert got["values"].tobytes() == want["values"].tobytes(), what


def test_each_rank_places_its_rows_of_the_overlay(runs):
    one, ranks = runs
    assert one["mode"] == "overlay" and one["mode2"] == "overlay"
    fl = FNUM // len(ranks)
    for r, rec in enumerate(ranks):
        assert (rec["mode"], rec["mode2"]) == ("overlay", "overlay")
        assert set(rec["planes"]) == set(one["planes"])
        for k, v in rec["planes"].items():
            assert v.shape == (fl, 256), k
            assert v.tobytes() == one["planes"][k][r * fl:(r + 1) * fl] \
                .tobytes(), (r, k)


@pytest.mark.parametrize("app", APP_NAMES)
def test_overlay_query_equals_one_process_and_the_repack(runs, app):
    one, ranks = runs
    for key in ("overlay", "cold overlay", "cold repack"):
        for rec in ranks:
            _same(rec[f"{key} {app}"], one[f"{key} {app}"], (key, app))
    # one overlay_fold a round, and the repack's cold query computes the
    # same values as the overlay's
    over = one[f"overlay {app}"]
    assert over["folds"] == over["rounds"] > 0
    assert one[f"cold repack {app}"]["folds"] == 0
    assert (one[f"cold overlay {app}"]["values"].tobytes()
            == one[f"cold repack {app}"]["values"].tobytes())


def test_overlay_queries_equal_the_jax_package(runs):
    """The same 64 adds staged on a JAX fnum-4 fragment of p2p-31: the
    JAX overlay query's values equal the gang's."""
    one, ranks = runs
    ns = {"EFILE": P2P[0], "VFILE": P2P[1]}
    exec(SCENARIO, ns)
    jfrag = JLoadGraph(P2P[0], P2P[1], JCommSpec(fnum=FNUM),
                       JLoadGraphSpec(weighted=True, edata_dtype=np.float64))
    port = ns["load"](CommSpec(FNUM, "cpu"))
    jdg = JDynGraph(jfrag, JRepackPolicy(threshold=0.9, capacity=256))
    assert jdg.ingest(ns["adds"](port, 64, 13))["mode"] == "overlay"
    for app in APP_NAMES:
        jw = JWorker(JAPPS[app](), jdg.fragment)
        jw.query(**ns["APPS"][app])
        want = np.asarray(jw.result_values())
        for rec in ranks:
            got = rec[f"overlay {app}"]
            assert got["values"].tobytes() == want.astype(
                got["values"].dtype).tobytes(), app
            assert got["rounds"] == jw.rounds, app


@pytest.mark.parametrize("key", ["inc overlay", "inc repack", "inc moved"])
@pytest.mark.parametrize("app", APP_NAMES)
def test_incremental_is_seeded_and_equals_cold(runs, app, key):
    one, ranks = runs
    cold = {"inc overlay": "cold overlay", "inc repack": "cold repack",
            "inc moved": "cold moved"}[key]
    assert one["same_layout3"] and not one["same_layout4"]
    for rec in ranks:
        inc = rec[f"{key} {app}"]
        _same(inc, one[f"{key} {app}"], (key, app))
        assert inc["mode"] == "seeded"
        assert inc["inc"] == {"seeded": 1, "cold": 0}
        c = rec[f"{cold} {app}"]
        assert inc["values"].tobytes() == c["values"].tobytes()
        assert inc["rounds"] < c["rounds"], (key, app)


def test_removal_and_pagerank_run_cold(runs):
    one, ranks = runs
    for rec in ranks:
        for key in ("inc removal sssp", "inc pagerank"):
            inc = rec[key]
            assert inc["mode"] == "cold" and inc["inc"] == {"seeded": 0,
                                                            "cold": 1}
            _same(inc, one[key], key)
        assert rec["inc removal sssp"]["values"].tobytes() == \
            rec["cold removal sssp"]["values"].tobytes()


def test_divergent_staging_raises_on_every_rank(tmp_path):
    recs = _gang(tmp_path, "diverge")
    for r, rec in enumerate(recs):
        assert rec["raised"] == "DeltaDivergenceError", (r, rec)
        assert "rank(s) [1] of 2" in rec["msg"]
        # nothing was applied: the attached overlay stays empty
        assert rec["count"] == 0
