"""The port's serving fleet (`libgrape_lite_tpu_torch/fleet/`) on the CPU,
held against the JAX package's `fleet/` on the same inputs.

* pricing: `fragment_bytes` and `overlay_bytes` equal the JAX package's
  on p2p-31 and on tests/test_dyn.py's graph with ADDS at fnum 1, 2, 4
  and 8 (integers: exact), and `fragment_bytes` equals the bytes the
  port places on the device; the per-fragment caches are priced and
  dropped at eviction;
* the budget: the same footprints under the same injected clock give
  the JAX budget's admit / evict / re-admit / reject events, in order;
* tenancy: the weighted round-robin forwarding order, tenants never
  sharing a batch, eviction and re-admission with no worker and no plan
  built again (`cache_stats`, PLAN_STATS), a reject that places nothing;
* the router: least-outstanding picks equal the JAX router's, loud fence
  violations, the drain guards, catch-up;
* `run_fleet_script` at R 1, 2 and 3, with and without a drain and
  ingest: every query's values and rounds bit-equal to the JAX fleet's
  (sssp and bfs are min folds: exact) and to the port's bare session;
* the serve CLI's fleet and autopilot paths: --dump_results equal to the
  plain port run and to the JAX CLI's, armed with --trace or --metrics
  too.
"""

import json

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.dyn import DeltaOverlay as JDeltaOverlay
from libgrape_lite_tpu.dyn import RepackPolicy as JRepackPolicy
from libgrape_lite_tpu.fleet import FLEET_STATS as JFLEET_STATS
from libgrape_lite_tpu.fleet import FleetBudget as JFleetBudget
from libgrape_lite_tpu.fleet import FleetManager as JFleetManager
from libgrape_lite_tpu.fleet import FleetRouter as JFleetRouter
from libgrape_lite_tpu.fleet import Footprint as JFootprint
from libgrape_lite_tpu.fleet import fragment_bytes as jfragment_bytes
from libgrape_lite_tpu.fleet import overlay_bytes as joverlay_bytes
from libgrape_lite_tpu.fleet import run_fleet_script as jrun_fleet_script
from libgrape_lite_tpu.fragment.mutation import (
    replicate_fragment as jreplicate,
)
from libgrape_lite_tpu.serve import BatchPolicy as JBatchPolicy
from libgrape_lite_tpu.serve import ServeSession as JServeSession
from libgrape_lite_tpu_torch.dyn import DeltaOverlay, RepackPolicy
from libgrape_lite_tpu_torch.fleet import (
    FLEET_STATS,
    FenceError,
    FenceViolationError,
    FleetAdmissionError,
    FleetBudget,
    FleetManager,
    FleetRouter,
    Footprint,
    fragment_bytes,
    overlay_bytes,
    plan_stream_bytes,
    rejoin_lost,
    run_fleet_script,
    session_footprint,
)
from libgrape_lite_tpu_torch.fragment.mutation import replicate_fragment
from libgrape_lite_tpu_torch.ops.spmv import plan_stats
from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession
from tests import test_dyn as jdyn
from tests.conftest import dataset_path
from tests.test_dyn import ADDS
from tests.test_torch_dyn import build_graph
from tests.test_torch_lanes import port_fragment

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
MORE_ADDS = ADDS + [("a", 1, 30, 0.2), ("a", 2, 28, 0.3), ("a", 5, 9, 0.7)]
P2P = ["--efile", dataset_path("p2p-31.e"),
       "--vfile", dataset_path("p2p-31.v")]


@pytest.fixture(autouse=True)
def _clean_fleet_stats():
    FLEET_STATS.reset()
    JFLEET_STATS.reset()
    yield
    FLEET_STATS.reset()
    JFLEET_STATS.reset()


def _policy(dyn=True):
    return RepackPolicy(threshold=0.5, capacity=64) if dyn else None


def _jpolicy(dyn=True):
    return JRepackPolicy(threshold=0.5, capacity=64) if dyn else None


def _router(R, *, dyn=True, max_batch=4, base=None):
    base = build_graph(2) if base is None else base
    frags = [base] + [replicate_fragment(base) for _ in range(R - 1)]
    return FleetRouter([ServeSession(f, policy=BatchPolicy(
        max_batch=max_batch), dyn=_policy(dyn)) for f in frags])


def _jrouter(R, *, dyn=True, max_batch=4):
    base = jdyn.build_graph(2)
    frags = [base] + [jreplicate(base) for _ in range(R - 1)]
    return JFleetRouter([JServeSession(f, policy=JBatchPolicy(
        max_batch=max_batch), dyn=_jpolicy(dyn)) for f in frags])


# ---- pricing --------------------------------------------------------------

@pytest.mark.parametrize("fnum", FNUMS)
def test_fragment_and_overlay_bytes_match_jax_on_p2p(graph_cache, fnum):
    """Exact integers: the same host CSR geometry, the same overlay
    planes for the same adds."""
    jfrag, frag = graph_cache(fnum), port_fragment(fnum)
    assert fragment_bytes(frag) == jfragment_bytes(jfrag) > 0
    oids = np.loadtxt(dataset_path("p2p-31.v"), dtype=np.int64, usecols=0)
    rng = np.random.default_rng(13)
    adds = [(int(a), int(b), 0.5) for a, b in rng.choice(oids, (40, 2))]
    ov, why = DeltaOverlay.build(frag, adds, 128)
    jov, jwhy = JDeltaOverlay.build(jfrag, adds, 128)
    assert why is None and jwhy is None

    class Holder:  # overlay_bytes reads `frag.dyn_overlay`
        def __init__(self, o):
            self.dyn_overlay = o

    assert overlay_bytes(Holder(ov)) == joverlay_bytes(Holder(jov)) > 0


@pytest.mark.parametrize("fnum", FNUMS)
def test_fragment_and_overlay_bytes_match_jax_with_adds(fnum):
    """tests/test_dyn.py's graph in a session with dyn=, before and after
    ingesting ADDS."""
    sess = ServeSession(build_graph(fnum), dyn=_policy())
    jsess = JServeSession(jdyn.build_graph(fnum), dyn=_jpolicy())
    for step in range(2):
        fp = session_footprint(sess)
        assert fp.frag_bytes == jfragment_bytes(jsess.fragment)
        assert fp.overlay_bytes == joverlay_bytes(jsess.fragment) > 0
        assert fp.plan_bytes == 0 and fp.runner_bytes == 0  # nothing built
        if step == 0:
            sess.ingest(ADDS)
            jsess.ingest(ADDS)


def test_fragment_bytes_equal_the_placed_tensors():
    frag = build_graph(4)
    dev = frag.dev
    placed = sum(t.nbytes for t in (
        dev.ivnum, dev.inner_mask, dev.oids, dev.out_degree,
        *(getattr(dev.ie, k) for k in ("indptr", "edge_src", "edge_nbr",
                                       "edge_w", "edge_mask"))))
    assert frag.host_ie is frag.host_oe and dev.in_degree is dev.out_degree
    assert fragment_bytes(frag) == placed


def test_footprint_prices_the_caches_and_eviction_drops_them():
    """Push CSRs and dest_degree are device caches: priced in
    plan_bytes, dropped with the fragment's tensors, rebuilt at the next
    use; the strict plan is host-side and stays (no re-planning)."""
    from libgrape_lite_tpu_torch.models.auto_apps import _PUSH
    from libgrape_lite_tpu_torch.models.exchange_base import _DEST_DEGREE

    sess = ServeSession(build_graph(2))
    fp0 = session_footprint(sess)
    assert fp0.plan_bytes == 0 and fp0.runner_bytes == 0
    for app in ("sssp_auto", "sssp_msg", "pagerank"):
        res = sess.serve([(app, {"source": 0} if app != "pagerank" else {})])
        assert res[0].ok, res[0].error
    frag = sess.fragment
    assert frag in _PUSH and frag in _DEST_DEGREE
    fp1 = session_footprint(sess)
    assert fp1.plan_bytes == plan_stream_bytes(frag) > 0
    assert fp1.runner_bytes > 0 and fp1.frag_bytes == fp0.frag_bytes
    planned = plan_stats()["planned"]
    sess.release_device()
    assert frag not in _PUSH and frag not in _DEST_DEGREE
    assert session_footprint(sess).runner_bytes == 0
    sess.restore_device()
    assert sess.serve([("sssp_auto", {"source": 0})])[0].ok
    assert sess.serve([("pagerank", {})])[0].ok
    assert plan_stats()["planned"] == planned


# ---- the budget: the JAX package's decisions ------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _budget_script(budget_cls, footprint_cls, stats):
    """One scripted admission sequence; returns the recorded events."""
    clock = Clock()
    b = budget_cls(capacity_bytes=1000, clock=clock)
    evicted = []
    fp = lambda nb, k, priv=0: footprint_cls(  # noqa: E731
        frag_bytes=nb, runner_bytes=priv, frag_keys={k: nb})
    steps = [
        ("a", fp(300, 1), 1.0, True),
        ("b", fp(300, 2, 50), 1.0, True),
        ("c", fp(200, 1, 20), 1.0, True),   # shares a's fragment
        ("d", fp(400, 4), 4.0, True),       # evicts the coldest big one
        ("e", fp(600, 5), 1.0, False),
        ("a", fp(350, 1), 1.0, True),       # re-admission
        ("f", fp(900, 6), 1.0, True),       # nothing evictable enough
    ]
    for i, (name, f, w, ev) in enumerate(steps):
        clock.t = float(i * (i + 1))
        if name in ("c", "e"):
            b.touch("a")
        b.admit(name, f, weight=w, evictable=ev, evict=evicted.append)
    b.release("d")
    return ([{k: v for k, v in e.items()} for e in stats.events],
            stats.snapshot(), evicted, b.snapshot())


def test_budget_events_match_jax_under_an_injected_clock():
    got = _budget_script(FleetBudget, Footprint, FLEET_STATS)
    want = _budget_script(JFleetBudget, JFootprint, JFLEET_STATS)
    assert got == want
    kinds = [e["kind"] for e in got[0]]
    assert {"admit", "evict", "readmit", "reject"} <= set(kinds)


def test_budget_cost_weighted_lru_and_weights():
    clock = Clock()
    b = FleetBudget(capacity_bytes=1000, clock=clock)
    b.admit("hot", Footprint(frag_bytes=400, frag_keys={1: 400}))
    b.admit("cold", Footprint(frag_bytes=400, frag_keys={2: 400}))
    clock.t = 10.0
    b.touch("hot")
    d = b.admit("new", Footprint(frag_bytes=400, frag_keys={3: 400}))
    assert d["admitted"] and [e["name"] for e in d["evicted"]] == ["cold"]
    clock.t = 20.0
    b.residents["new"].weight = 100.0  # heavy tenants pay last
    d = b.admit("next", Footprint(frag_bytes=400, frag_keys={4: 400}))
    assert [e["name"] for e in d["evicted"]] == ["hot"]


def test_budget_shared_fragment_billed_once_and_reject_restores_prior():
    b = FleetBudget(capacity_bytes=1000)
    b.admit("a", Footprint(frag_bytes=600, frag_keys={7: 600}))
    b.admit("b", Footprint(frag_bytes=600, runner_bytes=100,
                           frag_keys={7: 600}))
    assert b.used_bytes() == 700
    assert b._freeable_bytes("a") == 0  # b still serves from it
    b2 = FleetBudget(capacity_bytes=1000)
    b2.admit("a", Footprint(frag_bytes=400, frag_keys={1: 400}))
    b2.admit("pinned", Footprint(frag_bytes=500, frag_keys={2: 500}),
             evictable=False)
    d = b2.admit("a", Footprint(frag_bytes=800, frag_keys={1: 800}))
    assert not d["admitted"] and "a" in b2.residents
    assert b2.used_bytes() == 900
    assert FLEET_STATS.rejects == 1


def test_budget_capacity_from_env_and_device(monkeypatch):
    from libgrape_lite_tpu_torch.fragment.edgecut import _CPU_BUDGET_DEFAULT

    monkeypatch.delenv("GRAPE_FLEET_HBM_BYTES", raising=False)
    monkeypatch.delenv("GRAPE_HBM_BYTES", raising=False)
    assert FleetBudget(device="cpu").capacity == _CPU_BUDGET_DEFAULT
    monkeypatch.setenv("GRAPE_HBM_BYTES", "12345")
    assert FleetBudget(device="cpu").capacity == 12345
    monkeypatch.setenv("GRAPE_FLEET_HBM_BYTES", "777")
    assert FleetBudget(device="cpu").capacity == 777


# ---- tenancy --------------------------------------------------------------

class _Done:
    done = True

    class result:  # noqa: N801
        ok = True
        latency_s = 0.001


class StubTarget:
    """A router-shaped target with no replicas: it prices nothing, is
    never evicted, and records what was forwarded to it."""

    replicas = []

    def __init__(self):
        self.log = []

    def submit(self, app_key, args, tenant=None, **kw):
        self.log.append((tenant, args["source"]))
        return _Done()

    def pump(self):
        return []

    def drain(self):
        return []


def _wrr(manager_cls, budget_cls):
    target = StubTarget()
    mgr = manager_cls(budget_cls(capacity_bytes=0))
    for name, w in (("a", 2.0), ("b", 1.0), ("c", 0.5), ("d", 3.0)):
        mgr.add_tenant(name, target, weight=w)
    for i in range(17):
        mgr.submit("abcd"[i % 4] if i % 3 else "a", "sssp", {"source": i})
    mgr.forward_round()
    first = list(mgr.forward_order)
    for i in range(5):
        mgr.submit("c", "sssp", {"source": 100 + i})
    mgr.drain()
    return first, mgr.forward_order, target.log


def test_wrr_forwarding_order_matches_jax():
    got = _wrr(FleetManager, FleetBudget)
    assert got == _wrr(JFleetManager, JFleetBudget)
    assert got[0][:3] == ["a", "a", "b"]  # ceil(weight) tickets a cycle


def test_wrr_starvation_bound():
    sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=8))
    mgr = FleetManager(FleetBudget(capacity_bytes=0))
    mgr.add_tenant("a", sess)
    mgr.add_tenant("b", sess)
    for s in range(16):
        mgr.submit("a", "sssp", {"source": s % 32})
    for s in range(4):
        mgr.submit("b", "sssp", {"source": s})
    mgr.drain()
    assert mgr.forward_order[:8] == ["a", "b"] * 4
    assert all(t.done and t.result.ok for t in mgr.tenants["b"].tickets)


def test_tenants_never_share_a_batch():
    sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=8))
    mgr = FleetManager(FleetBudget(capacity_bytes=0))
    mgr.add_tenant("a", sess)
    mgr.add_tenant("b", sess)
    for s in (0, 7, 19, 30):
        mgr.submit("a", "sssp", {"source": s})
        mgr.submit("b", "sssp", {"source": s})
    mgr.drain()
    assert sess.queue.batch_hist == {4: 2}
    for t in mgr.tenants.values():
        assert all(tk.result.ok and tk.result.batch_size == 4
                   for tk in t.tickets)


def test_manager_evicts_and_readmits_with_no_rebuild():
    """Two tenants under a budget that holds one: each switch evicts the
    other; the re-admitted tenant builds no worker and no plan and
    answers as the JAX session does (a min fold: bit-equal)."""
    fa = build_graph(2, seed=3)
    fb = build_graph(2, seed=5)
    want = JServeSession(jdyn.build_graph(2, seed=3)).serve(
        [("sssp", {"source": 0})])[0].values
    cap = int(max(fragment_bytes(fa), fragment_bytes(fb)) * 1.5)
    mgr = FleetManager(FleetBudget(capacity_bytes=cap))
    sa = ServeSession(fa)
    sb = ServeSession(fb)
    mgr.add_tenant("a", sa)
    mgr.add_tenant("b", sb)
    mgr.submit("a", "sssp", {"source": 0})
    mgr.drain()
    mgr.submit("b", "sssp", {"source": 0})
    mgr.drain()
    assert not sa.resident and FLEET_STATS.evictions == 1
    planned, workers = plan_stats(), sa.cache_stats()["runner"]["misses"]
    t = mgr.submit("a", "sssp", {"source": 0})
    mgr.drain()
    assert t.result.ok and t.result.values.tobytes() == want.tobytes()
    assert sa.resident and not sb.resident
    assert mgr.tenants["a"].stats["readmits"] == 1
    assert plan_stats() == planned
    assert sa.cache_stats()["runner"]["misses"] == workers == 1
    assert any(e["kind"] == "tenant_readmit" for e in FLEET_STATS.events)


def test_rejected_readmission_places_no_buffers():
    fa = build_graph(2, seed=3)
    sa = ServeSession(fa)
    cap = int(fragment_bytes(fa) * 1.2)
    mgr = FleetManager(FleetBudget(capacity_bytes=cap))
    mgr.add_tenant("a", sa)
    mgr.submit("a", "sssp", {"source": 0})
    mgr.drain()
    mgr.budget.release("a")
    mgr.tenants["a"].admitted = False
    sa.release_device()
    mgr.budget.admit("pinned", Footprint(frag_bytes=cap, frag_keys={-1: cap}),
                     evictable=False)
    used = mgr.budget.used_bytes()
    mgr.submit("a", "sssp", {"source": 0})
    with pytest.raises(FleetAdmissionError, match="rejected"):
        mgr.drain()
    assert not sa.resident and mgr.budget.used_bytes() == used


def test_shared_fragment_stays_placed_when_one_tenant_is_evicted():
    frag = build_graph(2)
    s1 = ServeSession(frag)
    s2 = ServeSession(frag)
    mgr = FleetManager(FleetBudget(capacity_bytes=0))
    mgr.add_tenant("a", s1)
    mgr.add_tenant("b", s2)
    for name in "ab":
        mgr.submit(name, "sssp", {"source": 0})
    mgr.drain()
    mgr._evict_cb("a")
    assert frag.dev is not None and s2.resident


# ---- the router -----------------------------------------------------------

class _StubReq:
    def __init__(self):
        self.done = False
        self.result = None


class _StubPump:
    def __init__(self, sess):
        self.sess = sess

    def pump(self, force=False):
        """Finish the oldest unfinished request only."""
        for q in self.sess.reqs:
            if not q.done:
                q.done = True
                q.result = _Done.result
                return [q.result]
        return []

    def drain(self):
        out = []
        while self.pump():
            out.append(1)
        return out

    def inflight(self):
        return 0


class _StubSession:
    def __init__(self):
        self.reqs = []

    def async_pump(self, window=1):
        return _StubPump(self)

    def submit(self, app_key, args=None, **kw):
        q = _StubReq()
        self.reqs.append(q)
        return q


def _picks(router_cls):
    router = router_cls([_StubSession() for _ in range(3)])
    picks = []
    for burst in (5, 3, 0, 4, 2):
        for _ in range(burst):
            router.submit("sssp", {"source": 0})
            picks.append(tuple(r.outstanding for r in router.replicas))
        router.pump()
        picks.append(tuple(r.served for r in router.replicas))
    return picks


def test_router_least_outstanding_picks_match_jax():
    got = _picks(FleetRouter)
    assert got == _picks(JFleetRouter)
    assert got[:3] == [(1, 0, 0), (1, 1, 0), (1, 1, 1)]


def test_router_routes_and_collects_real_sessions():
    router = _router(2, dyn=False)
    picks = []
    for s in range(4):
        router.submit("sssp", {"source": s})
        picks.append([r.outstanding for r in router.replicas])
    assert picks == [[1, 0], [1, 1], [2, 1], [2, 2]]
    res = router.drain()
    assert len(res) == 4 and all(r.ok for r in res)
    assert all(r.outstanding == 0 and r.served == 2 for r in router.replicas)
    summary = router.summary(wall_s=1.0)
    assert summary["replicas"]["r0"]["qps"] == 2.0


def test_fence_violation_and_drain_guards_are_loud():
    router = _router(3, dyn=False)
    router.replicas[1].version = 99
    with pytest.raises(FenceViolationError, match="mix graph versions"):
        router.submit("sssp", {"source": 0})
    with pytest.raises(FenceViolationError):
        router.pump()
    router.replicas[1].version = 0
    for r in router.replicas:
        r.routable = False
    with pytest.raises(FenceError, match="no routable replica"):
        router.submit("sssp", {"source": 0})
    router = _router(2, dyn=False)
    router.begin_drain(0)
    with pytest.raises(ValueError, match="last routable"):
        router.begin_drain(1)
    router.rejoin(0)
    with pytest.raises(ValueError, match="not draining"):
        router.rejoin(0)
    router.begin_drain(0)
    router.fence += 1  # a fence move that never logged a catch-up
    with pytest.raises(FenceViolationError, match="catch-up log"):
        router.rejoin(0)
    # a process loss rejoins from a checkpoint lineage: none there, a
    # single-file one resumes through Worker.resume, a sharded one brings
    # a replacement replica at the fence and the lineage's newest meta
    with pytest.raises(FileNotFoundError):
        rejoin_lost(router, "/nonexistent", session_factory=None)
    import os
    import tempfile

    from libgrape_lite_tpu_torch.ft.checkpoint import CheckpointManager

    d = tempfile.mkdtemp()
    mgr = CheckpointManager(d, fingerprint={"app": "sssp"}, query_args={},
                            checkpoint_every=1)
    mgr.save_async({"dist": torch.zeros(4)}, 2, 1)
    mgr.close()
    with pytest.raises(ValueError, match="ordinary resume path"):
        rejoin_lost(router, d, session_factory=None)
    meta_path = os.path.join(d, "ckpt_00000002", "meta.json")
    meta = json.load(open(meta_path))
    meta["layout"] = "sharded"
    json.dump(meta, open(meta_path, "w"))
    for r in router.replicas:
        r.routable = True
    n = len(router.replicas)
    replica, got = rejoin_lost(
        router, d, session_factory=lambda f: ServeSession(
            f, policy=BatchPolicy(max_batch=4), dyn=_policy(False)))
    assert got["layout"] == "sharded" and got["rounds"] == 2
    assert replica.idx == n and replica.routable
    assert replica.version == router.fence
    assert FLEET_STATS.events[-1]["lost_process"] is True


def test_drain_catchup_applies_missed_deltas():
    router = _router(2)
    for s in (0, 7, 19, 30):
        router.submit("sssp", {"source": s})
    router.drain()
    router.begin_drain(0)
    rep = router.ingest(ADDS)
    assert rep["applied_replicas"] == 1 and router.replicas[0].version == 0
    out = router.rejoin(0)
    assert out["catchup_ops"] == len(ADDS)
    assert router.replicas[0].version == router.fence == 1
    vals = [r.session.serve([("sssp", {"source": 0})])[0].values.tobytes()
            for r in router.replicas]
    assert vals[0] == vals[1]
    assert [e["kind"] for e in FLEET_STATS.events] == ["drain", "rejoin"]


# ---- run_fleet_script against the JAX fleet -------------------------------

def _queries():
    rng = np.random.default_rng(11)
    return [("sssp" if i % 3 else "bfs", {"source": int(s)})
            for i, s in enumerate(rng.integers(0, 32, 18))]


def _values(reqs):
    assert all(q.result is not None and q.result.ok for q in reqs)
    return [(q.result.rounds, q.result.values.tobytes()) for q in reqs]


@pytest.fixture(scope="module")
def jax_fleet_values():
    """The JAX fleet's values: R 2 with a drain and ingest, and R 1 with
    no ingest (the JAX package's own tests pin R 1 = R 2 = R 3)."""
    out = {}
    for ingest, R, drain_at in ((True, 2, 7), (False, 1, None)):
        reqs = jrun_fleet_script(
            _jrouter(R), _queries(), delta_ops=MORE_ADDS if ingest else None,
            ingest_every=6, drain_at=drain_at,
            offline=lambda s: s.ingest([], force_repack=True))
        out[ingest] = _values(reqs)
    return out


@pytest.mark.parametrize("R,drain_at", [(1, None), (2, None), (2, 7),
                                        (3, None), (3, 7)])
@pytest.mark.parametrize("ingest", [True, False])
def test_fleet_script_bit_equal_to_jax_and_a_bare_session(
        jax_fleet_values, R, drain_at, ingest):
    delta = MORE_ADDS if ingest else None
    router = _router(R)
    reqs = run_fleet_script(router, _queries(), delta_ops=delta,
                            ingest_every=6, drain_at=drain_at,
                            offline=lambda s: s.ingest([], force_repack=True))
    got = _values(reqs)
    assert got == jax_fleet_values[ingest]
    bare = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=4), dyn=_policy())
    assert _values(run_fleet_script(bare, _queries(), delta_ops=delta,
                                    ingest_every=6)) == got
    assert router.fence == (3 if ingest else 0)
    if drain_at is not None:
        assert router.replicas[0].drains == 1
        assert router.replicas[0].version == router.fence
    assert all(r.served > 0 for r in router.replicas)


def test_fleet_script_through_tenants_and_submit_kwargs():
    router = _router(2)
    mgr = FleetManager(FleetBudget(capacity_bytes=0))
    for app in ("bfs", "sssp"):
        mgr.add_tenant(app, router)
    tickets = run_fleet_script(router, _queries(), manager=mgr,
                               tenant_of=lambda i, app: app,
                               delta_ops=MORE_ADDS, ingest_every=6,
                               drain_at=7)
    ref = run_fleet_script(_router(1), _queries(), delta_ops=MORE_ADDS,
                           ingest_every=6)
    assert _values(tickets) == _values(ref)
    capped = run_fleet_script(_router(2, dyn=False), _queries(),
                              submit_kwargs={"max_rounds": 1})
    assert all(q.result.ok and q.result.rounds <= 1 and q.max_rounds == 1
               for q in capped)


# ---- the serve CLI --------------------------------------------------------

def _summary(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def _delta_file(tmp_path):
    oids = np.loadtxt(dataset_path("p2p-31.v"), dtype=np.int64, usecols=0)
    rng = np.random.default_rng(13)
    path = tmp_path / "adds.txt"
    path.write_text("".join(f"a {a} {b} 0.5\n"
                            for a, b in rng.choice(oids, (24, 2))))
    return str(path)


@pytest.mark.parametrize("fnum", [1, 4])
def test_cli_fleet_dump_equals_plain_and_jax(capsys, tmp_path, fnum):
    from libgrape_lite_tpu.cli import serve_main as jserve_main

    from libgrape_lite_tpu_torch.cli import main

    args = [*P2P, "--fnum", str(fnum), "--application", "bfs", "--sources",
            "6,17,3,42,11,12,13,14,15,16", "--max_batch", "4",
            "--delta_stream", _delta_file(tmp_path), "--ingest_every", "4"]
    fleet = ["--replicas", "2", "--drain_at", "4", "--tenants", "2"]
    jserve_main([*args, *fleet, "--dump_results", str(tmp_path / "j.txt")])
    capsys.readouterr()
    for name, extra in (("plain", []), ("fleet", fleet)):
        assert main(["serve", *args, *extra, "--dump_results",
                     str(tmp_path / f"{name}.txt"), "--device", "cpu"]) == 0
        rec = _summary(capsys.readouterr().out)
        assert rec["queries"] == 10 and rec["failed"] == 0
    fl = rec["fleet"]
    assert fl["replicas"] == 2 and fl["tenants"] == 2 and fl["dropped"] == 0
    assert fl["drains"] == 1 and fl["rejoins"] == 1 and fl["fence"] == 3
    assert rec["dyn"]["ingested"] == 2 * 24  # both replicas
    plain = (tmp_path / "plain.txt").read_text()
    assert (tmp_path / "fleet.txt").read_text() == plain
    assert (tmp_path / "j.txt").read_text() == plain


def test_cli_fleet_by_app_tenants_mixed_stream(capsys, tmp_path):
    """A mixed stream: the plain loop's ingests follow dispatch counts,
    which a batch of one app can carry past another app's queries, so
    the fleet run is held to the one-replica fleet run (the same
    `run_fleet_script` barriers) and its bfs lines to the JAX fleet's
    (the port's sssp is float32 on the card, the JAX CLI's float64)."""
    from libgrape_lite_tpu.cli import serve_main as jserve_main

    from libgrape_lite_tpu_torch.cli import main

    stream = tmp_path / "stream.txt"
    stream.write_text("".join(f"{'sssp' if i % 2 else 'bfs'} {6 + i}\n"
                              for i in range(12)))
    args = [*P2P, "--fnum", "2", "--stream", str(stream), "--max_batch", "4",
            "--delta_stream", _delta_file(tmp_path), "--ingest_every", "4"]
    fleet = ["--replicas", "2", "--drain_at", "8", "--tenants", "by_app"]
    jserve_main([*args, *fleet, "--dump_results", str(tmp_path / "j.txt")])
    capsys.readouterr()
    main(["serve", *args, "--tenants", "by_app", "--device", "cpu",
          "--dump_results", str(tmp_path / "r1.txt")])
    capsys.readouterr()
    main(["serve", *args, *fleet, "--device", "cpu", "--dump_results",
          str(tmp_path / "f.txt")])
    rec = _summary(capsys.readouterr().out)
    assert rec["fleet"]["tenants"] == 2 and rec["fleet"]["dropped"] == 0
    assert set(rec["fleet"]["tenant_stats"]) == {"bfs", "sssp"}
    got = (tmp_path / "f.txt").read_text()
    assert got == (tmp_path / "r1.txt").read_text()
    bfs = [ln for ln in got.splitlines() if " bfs " in ln]
    assert len(bfs) == 6 and bfs == [
        ln for ln in (tmp_path / "j.txt").read_text().splitlines()
        if " bfs " in ln]


@pytest.mark.parametrize("fnum", [1, 4])
def test_cli_autopilot_dump_equals_plain_and_jax(capsys, tmp_path, fnum):
    from libgrape_lite_tpu.cli import serve_main as jserve_main

    from libgrape_lite_tpu_torch.cli import main

    args = [*P2P, "--fnum", str(fnum), "--application", "bfs", "--sources",
            "6,17,3,42,6,17,11,12", "--max_batch", "4"]
    auto = ["--autopilot", "--min_replicas", "1", "--max_replicas", "2",
            "--cache_entries", "64"]
    jserve_main([*args, *auto, "--dump_results", str(tmp_path / "j.txt")])
    capsys.readouterr()
    for name, extra in (("plain", []), ("auto", auto)):
        assert main(["serve", *args, *extra, "--dump_results",
                     str(tmp_path / f"{name}.txt"), "--device", "cpu"]) == 0
        rec = _summary(capsys.readouterr().out)
        assert rec["queries"] == 8 and rec["failed"] == 0
    ap = rec["autopilot"]
    assert ap["min_replicas"] == 1 and ap["max_replicas"] == 2
    assert ap["ticks"] > 0 and ap["cache"]["capacity"] == 64
    assert ap["cache_hits"] + ap["cache_misses"] == 8
    assert rec["fleet"]["dropped"] == 0
    plain = (tmp_path / "plain.txt").read_text()
    assert (tmp_path / "auto.txt").read_text() == plain
    assert (tmp_path / "j.txt").read_text() == plain


@pytest.mark.parametrize("extra,msg", [
    (["--drain_at", "2"], "--drain_at needs --replicas"),
    (["--autopilot", "--tenants", "2"], "does not compose with --tenants"),
    (["--autopilot", "--delta_stream", None],
     "does not compose with --delta_stream"),
    (["--autopilot", "--min_replicas", "0"], "--min_replicas must be"),
    (["--autopilot", "--min_replicas", "3", "--max_replicas", "2"],
     "--max_replicas must be"),
    (["--replicas", "2", "--arrival_rate", "50"], "--arrival_rate"),
])
def test_cli_fleet_misuse_fails_before_the_load(tmp_path, extra, msg):
    from libgrape_lite_tpu_torch.cli import serve_main

    extra = [_delta_file(tmp_path) if x is None else x for x in extra]
    with pytest.raises(SystemExit) as exc:
        serve_main([*P2P, "--num_queries", "2", "--device", "cpu", *extra])
    assert msg in str(exc.value.code)


@pytest.mark.parametrize("flag,value", [("--trace", "t.json"),
                                        ("--metrics", "m.txt")])
def test_cli_trace_and_metrics_still_refuse(tmp_path, monkeypatch, flag,
                                            value):
    """Refused until obs/ was ported; now the fleet path takes --trace
    (a `fleet_pump` span on each replica) and --metrics (the snapshot
    files), with --dump_results equal to the disarmed run's."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.cli import serve_main

    monkeypatch.chdir(tmp_path)
    argv = [*P2P, "--num_queries", "4", "--device", "cpu", "--replicas",
            "2"]
    assert serve_main(argv + ["--dump_results", "plain.txt"]) == 0
    try:
        assert serve_main(argv + [flag, value, "--dump_results",
                                  "armed.txt"]) == 0
        if flag == "--trace":
            pumps = [e for e in obs.load_trace("t.json")
                     if e["ph"] == "X" and e["name"] == "fleet_pump"]
            assert {e["args"]["replica"] for e in pumps} == {0, 1}
        else:
            snap = json.loads((tmp_path / "m.txt.json").read_text())
            assert snap["grape_serve_admission_wait_seconds"]["count"] == 4
            assert snap["grape_fleet_outstanding_r1"]["value"] >= 1
    finally:
        obs.reset()
    assert (tmp_path / "armed.txt").read_text() == \
        (tmp_path / "plain.txt").read_text()


def test_cli_slo_flag_reports_burn(capsys):
    from libgrape_lite_tpu_torch.cli import main
    from libgrape_lite_tpu_torch.obs import slo

    try:
        main(["serve", *P2P, "--fnum", "2", "--application", "bfs",
              "--sources", "6,17", "--slo", "bfs=0.000001,*=1000",
              "--device", "cpu"])
        rec = _summary(capsys.readouterr().out)
        assert rec["slo"]["observed"] == 2 and rec["slo"]["breaches"] == 2
        assert rec["slo"]["burn_by_key"] == {"bfs": 100.0}
    finally:
        slo.configure(None)
