"""The port's autopilot (`libgrape_lite_tpu_torch/autopilot/`) and the two
`obs/` modules it reads, on the CPU, held against the JAX package.

* the pure decides: `scaler.decide` over the same ControlSignals windows
  and `decide_admission` over the same (burn, cost) tables give the JAX
  package's verdicts and reasons;
* `ResultCache`'s counters, LRU and epoch invalidation equal the JAX
  cache's on one scripted sequence; `query_cost` equals the JAX price on
  p2p-31 at fnum 1, 2, 4 and 8 (an integer number of bytes: exact);
  `query_wall_s` is one K1 pull a round priced at the data sheet;
* `obs/slo.py`: `parse_spec`, `objective_for` and the burn after the
  same observations equal the JAX module's (burn rounded to 4 places by
  both); `obs/federation.py`: the namespaces, `self_check`;
* the session and queue hooks: a cache hit dispatches nothing and
  returns the cold bytes; ingest moves the epoch; shed, defer and
  deadline expiry, each counted against the SLO;
* the autoscaler on a real fleet: a scale-up mid-stream, grow and shrink
  drills, rejoin before replicate, the budget's hold -- every answer
  bit-equal to a one-session run (min folds: exact).
"""

import time

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.autopilot import admission as jadmission
from libgrape_lite_tpu.autopilot import cache as jcache
from libgrape_lite_tpu.autopilot import scaler as jscaler
from libgrape_lite_tpu.autopilot import signals as jsignals
from libgrape_lite_tpu.fleet import FLEET_STATS as JFLEET_STATS
from libgrape_lite_tpu.obs import federation as jfederation
from libgrape_lite_tpu.obs import slo as jslo
from libgrape_lite_tpu_torch.autopilot import (
    AUTOPILOT_STATS,
    CACHE_KEY_FIELDS,
    AdmissionConfig,
    AdmissionController,
    Autoscaler,
    ControlSignals,
    Decision,
    ResultCache,
    ScalerConfig,
    SignalReader,
    decide,
    decide_admission,
    query_cost,
    record_decision,
)
from libgrape_lite_tpu_torch.autopilot.admission import (
    DEFAULT_PRICED_ROUNDS,
    query_wall_s,
)
from libgrape_lite_tpu_torch.autopilot.signals import MAX_DECISIONS
from libgrape_lite_tpu_torch.dyn import RepackPolicy
from libgrape_lite_tpu_torch.fleet import FLEET_STATS, FleetBudget, FleetRouter
from libgrape_lite_tpu_torch.fragment.mutation import replicate_fragment
from libgrape_lite_tpu_torch.obs import federation, slo
from libgrape_lite_tpu_torch.obs.slo import SLO_STATS
from libgrape_lite_tpu_torch.ops import calibration
from libgrape_lite_tpu_torch.ops.spmv import plan_stats
from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession
from tests.conftest import dataset_path
from tests.test_dyn import ADDS
from tests.test_torch_dyn import build_graph
from tests.test_torch_lanes import port_fragment

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_surfaces():
    """Every test starts from empty autopilot, fleet and SLO records."""
    def clean():
        for stats in (AUTOPILOT_STATS, jsignals.AUTOPILOT_STATS):
            stats.reset()
        FLEET_STATS.reset()
        JFLEET_STATS.reset()
        slo.configure(None)
        jslo.configure(None)

    clean()
    yield
    clean()


def _sig(cls, depth=0, out=0, replicas=1, burn=0.0, p99=0.0, fence=0):
    return cls(queue_depth=depth, outstanding=out, wait_p50_ms=0.0,
               wait_p99_ms=p99, max_burn=burn, burn_by_key=(),
               replicas=replicas, total_replicas=replicas, fence=fence)


# ---- the pure decides against the JAX package ----------------------------

HOT, CALM = {"depth": 50}, {}
DECIDE_CASES = [
    ([], {}, 0),
    ([HOT], {"window": 3, "up_queue_depth": 2}, 0),
    ([HOT] * 3, {"window": 3, "up_queue_depth": 2}, 0),
    ([CALM, HOT, HOT], {"window": 3, "up_queue_depth": 2}, 0),
    ([HOT, CALM, HOT], {"window": 3, "up_queue_depth": 2}, 0),
    ([HOT], {"window": 1, "up_queue_depth": 2}, 2),
    ([{"depth": 50, "replicas": 2}],
     {"min_replicas": 1, "max_replicas": 2, "window": 1,
      "up_queue_depth": 2}, 0),
    ([{"replicas": 1}], {"window": 1}, 0),
    ([{"replicas": 2}], {"window": 1}, 0),
    ([{"depth": 20}], {"window": 1, "up_queue_depth": 8,
                       "max_replicas": 8}, 0),
    ([{"depth": 20, "replicas": 4}], {"window": 1, "up_queue_depth": 8,
                                      "max_replicas": 8}, 0),
    ([{"burn": 2.5}], {"window": 1, "up_queue_depth": 1000,
                       "up_burn": 1.0, "up_wait_p99_ms": 50.0}, 0),
    ([{"p99": 200.0}], {"window": 1, "up_queue_depth": 1000,
                        "up_burn": 1.0, "up_wait_p99_ms": 50.0}, 0),
    ([{"out": 3, "replicas": 2}], {"window": 1, "up_burn": 1.0}, 0),
    ([{"depth": 9}] * 4, {}, 0),
    ([{"depth": 9}] * 4, {}, 1),
]


@pytest.mark.parametrize("window,cfg,cooldown", DECIDE_CASES)
def test_decide_matches_jax(window, cfg, cooldown):
    got = decide([_sig(ControlSignals, **w) for w in window],
                 ScalerConfig(**cfg), cooldown=cooldown)
    want = jscaler.decide([_sig(jsignals.ControlSignals, **w)
                           for w in window],
                          jscaler.ScalerConfig(**cfg), cooldown=cooldown)
    assert (got.action, got.reason, got.replicas, got.target) == (
        want.action, want.reason, want.replicas, want.target)


def test_decide_verdicts():
    cfg = ScalerConfig(window=3, up_queue_depth=2)
    hot = _sig(ControlSignals, depth=50)
    assert decide([hot] * 2, cfg).reason == "window_filling"
    d = decide([hot] * 3, cfg)
    assert d.action == "scale_up" and d.target == 2
    calm = _sig(ControlSignals)
    assert decide([hot, hot, calm], cfg).action == "hold"


@pytest.mark.parametrize("kw,match", [
    ({"min_replicas": 0}, "min_replicas"),
    ({"min_replicas": 3, "max_replicas": 2}, "max_replicas"),
    ({"window": 0}, "window"),
    ({"cooldown_ticks": -1}, "cooldown"),
])
def test_scaler_config_validates(kw, match):
    with pytest.raises(ValueError, match=match):
        ScalerConfig(**kw)


ADMISSION_CFGS = [{}, {"max_cost": 100.0}, {"defer_burn": 0.5,
                                            "shed_burn": 3.0},
                  {"max_cost_s": 0.01}]


@pytest.mark.parametrize("cfg", ADMISSION_CFGS)
def test_decide_admission_matches_jax(cfg):
    table = [(b, c, cs) for b in (0.0, 0.5, 0.99, 1.0, 1.5, 2.0, 5.0)
             for c in (0.0, 50.0, 500.0) for cs in (0.0, 0.5)]
    got = [decide_admission(b, c, AdmissionConfig(**cfg), cost_s=cs)
           for b, c, cs in table]
    want = [jadmission.decide_admission(
        b, c, jadmission.AdmissionConfig(**cfg), cost_s=cs)
        for b, c, cs in table]
    assert got == want and {"admit", "shed"} <= set(got)


def test_admission_config_validates():
    with pytest.raises(ValueError, match="defer_burn"):
        AdmissionConfig(defer_burn=0.0)
    with pytest.raises(ValueError, match="shed_burn"):
        AdmissionConfig(defer_burn=2.0, shed_burn=1.0)


@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_query_cost_matches_jax(fnum):
    """The price of a fresh fragment (no pack plan in either package)."""
    from libgrape_lite_tpu.fragment.loader import LoadGraph as JLoadGraph
    from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JSpec
    from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec

    jfrag = JLoadGraph(dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
                       JCommSpec(fnum=fnum),
                       JSpec(weighted=True, edata_dtype=np.float64))
    frag = port_fragment(fnum)
    for rounds in (None, 3, 16):
        assert query_cost(frag, rounds) == jadmission.query_cost(
            jfrag, rounds) > 0
    assert query_cost(frag) == query_cost(frag, DEFAULT_PRICED_ROUNDS)
    one_pull = calibration.default_profile().wall_s(
        calibration.k1_columns(frag))
    assert one_pull > 0
    assert query_wall_s(frag) == one_pull * DEFAULT_PRICED_ROUNDS
    assert AUTOPILOT_STATS["priced"] == 5  # one count a price


# ---- the result cache -----------------------------------------------------

class _Res:
    def __init__(self, ok=True, values=b"v", rounds=3, terminate_code=0,
                 deferred=False):
        self.ok = ok
        self.values = values
        self.rounds = rounds
        self.terminate_code = terminate_code
        self.deferred = deferred


def _cache_script(cache_cls, stats):
    c = cache_cls(capacity=3)
    trace = []
    for i in range(5):
        trace.append(c.store(("sssp",), i, 0, _Res(values=f"v{i}")))
    trace.append(c.lookup(("sssp",), 1, 0))   # evicted (LRU)
    trace.append(c.lookup(("sssp",), 3, 0))   # hit, now most recent
    trace.append(c.store(("sssp",), 9, 0, _Res()))  # evicts 2
    trace.append(c.lookup(("sssp",), 2, 0))
    trace.append(c.lookup(("sssp",), 3, 1))   # another fence: miss
    trace.append(c.store(("sssp",), 8, 1, _Res(values="f1")))
    trace.append(c.store(("sssp",), 7, 1, _Res(ok=False)))
    trace.append(c.store(("sssp",), 7, 1, _Res(deferred=True)))
    trace.append(c.store(("sssp",), 7, 1, _Res(values=None)))
    trace.append(c.store(([1],), 7, 1, _Res()))  # unhashable
    trace.append(c.lookup(([1],), 7, 1))
    trace.append(c.invalidate_stale(1))
    trace.append(c.lookup(("sssp",), 8, 1))
    return trace, c.snapshot(), len(c), {
        k: stats[k] for k in ("cache_hits", "cache_misses", "cache_stores",
                              "cache_evictions", "cache_invalidations")}


def test_result_cache_matches_jax():
    got = _cache_script(ResultCache, AUTOPILOT_STATS)
    assert got == _cache_script(jcache.ResultCache, jsignals.AUTOPILOT_STATS)
    snap = got[1]
    assert snap["hits"] == 2 and snap["evictions"] >= 2
    assert snap["invalidations"] == 2 and got[2] == 1
    assert CACHE_KEY_FIELDS == jcache.CACHE_KEY_FIELDS
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=0)


# ---- obs/slo.py and obs/federation.py -------------------------------------

@pytest.mark.parametrize("spec", [
    "sssp=5,bfs=10,tenant:t0=50,*=100", " sssp = 2.5 ,, ", "",
])
def test_parse_spec_matches_jax(spec):
    assert slo.parse_spec(spec) == jslo.parse_spec(spec)


@pytest.mark.parametrize("bad", ["sssp", "sssp=x", "=5", "sssp=0",
                                 "sssp=-1"])
def test_parse_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        slo.parse_spec(bad)
    with pytest.raises(ValueError):
        jslo.parse_spec(bad)


def test_slo_burn_matches_jax():
    spec = "sssp=5,tenant:t0=50,*=100"
    obs = [("sssp", None, 0.001, True), ("sssp", None, 0.009, True),
           ("bfs", "t0", 0.06, True), ("bfs", "t1", 0.2, True),
           ("khop", None, 0.01, False), ("sssp", "t0", 0.01, True),
           ("sssp", None, 0.002, True)]
    for mod in (slo, jslo):
        mod.configure(spec, budget_frac=0.05)
        for app, tenant, lat, ok in obs:
            mod.observe(app, tenant, lat, ok)
    assert SLO_STATS.snapshot() == jslo.SLO_STATS.snapshot()
    assert SLO_STATS["burn_by_key"]["sssp"] == round(1 / (3 * 0.05), 4)
    for app, tenant in (("sssp", "t0"), ("bfs", None), ("x", "t9")):
        assert slo.objective_for(app, tenant) == jslo.objective_for(
            app, tenant)
    slo.configure(None)
    assert not slo.configured()
    slo.observe("sssp", None, 1.0, False)
    assert SLO_STATS["observed"] == 0
    with pytest.raises(ValueError, match="budget"):
        slo.configure("sssp=1", budget_frac=2.0)


def test_slo_configures_from_env(monkeypatch):
    monkeypatch.setenv("GRAPE_SLO", "bfs=7")
    monkeypatch.setenv("GRAPE_SLO_BUDGET", "0.1")
    assert slo.maybe_configure_from_env()
    assert SLO_STATS["objectives_ms"] == {"bfs": 7.0}
    assert SLO_STATS["budget_frac"] == 0.1
    slo.configure(None, budget_frac=slo.DEFAULT_BUDGET_FRAC)


def test_federation_namespaces_and_self_check():
    import libgrape_lite_tpu_torch.autopilot  # noqa: F401
    import libgrape_lite_tpu_torch.fleet  # noqa: F401
    import libgrape_lite_tpu_torch.serve  # noqa: F401

    # the JAX namespaces, plus the rate profile's (registered, not
    # listed, in JAX) and the guarded batch's
    assert set(federation.EXPECTED) == (
        set(jfederation.EXPECTED) | {"calibration", "guarded_batch"})
    for ns, owner in federation.EXPECTED.items():
        if ns in ("calibration", "guarded_batch"):
            continue
        # the port's strict planner lives in ops/spmv.py (no spmv_pack)
        jowner = jfederation.EXPECTED[ns].replace(
            ".ops.spmv_pack", ".ops.spmv")
        assert owner == jowner.replace("libgrape_lite_tpu.",
                                       "libgrape_lite_tpu_torch.")
    assert federation.self_check() == []
    assert set(federation.registered()) == set(federation.EXPECTED)
    record_decision("scale_up", reason="test", replicas=1, target=2)
    record_decision("shed", tenant="t0")
    snap = federation.snapshot("autopilot")
    assert snap["scale_ups"] == 1 and snap["shed"] == 1
    assert snap["decisions"][-1]["kind"] == "shed"
    snap["decisions"].append("not shared")
    assert len(AUTOPILOT_STATS["decisions"]) == 2
    assert set(federation.snapshot()) == set(federation.EXPECTED)
    federation.reset("autopilot")
    assert AUTOPILOT_STATS["scale_ups"] == 0
    with pytest.raises(KeyError):
        federation.snapshot("nope")
    with pytest.raises(ValueError, match="already registered"):
        federation.register("pump", dict, module="elsewhere")
    with pytest.raises(ValueError, match="bad federation namespace"):
        federation.register("a-b", dict)


def test_decision_log_is_bounded():
    for i in range(MAX_DECISIONS + 10):
        record_decision("hold", i=i)
    assert len(AUTOPILOT_STATS["decisions"]) <= MAX_DECISIONS
    assert AUTOPILOT_STATS["decisions"][-1]["i"] == MAX_DECISIONS + 9
    assert AUTOPILOT_STATS["holds"] == MAX_DECISIONS + 10


# ---- the session and queue hooks ------------------------------------------

def _session(**kw):
    return ServeSession(build_graph(2), policy=BatchPolicy(max_batch=4),
                        **kw)


def test_cache_hit_dispatches_nothing_and_returns_the_cold_bytes():
    sess = _session()
    cache = ResultCache(capacity=8)
    sess.attach_result_cache(cache)
    cold = sess.serve([("sssp", {"source": 0})])
    assert cold[0].ok and cache.stores == 1
    batches, plans = sess.stats["batches"], plan_stats()
    workers = sess.cache_stats()["runner"]
    hot = sess.serve([("sssp", {"source": 0})])
    assert cache.hits == 1 and sess.stats["cache_hits"] == 1
    assert sess.stats["batches"] == batches and plan_stats() == plans
    assert sess.cache_stats()["runner"] == workers
    assert hot[0].ok and hot[0].values.tobytes() == cold[0].values.tobytes()
    assert hot[0].stages["device_us"] == 0 and sess.queue.completed == 2
    # a guard named, or an app without a lane key, is not cached
    assert sess._cacheable("sssp", {"source": 0}, "off") is None
    assert sess._cacheable("pagerank", {}, None) is None


def test_cache_hits_count_against_the_slo():
    slo.configure("sssp=100000")
    sess = _session()
    sess.attach_result_cache(ResultCache(capacity=8))
    sess.serve([("sssp", {"source": 0})] * 2)
    sess.serve([("sssp", {"source": 0})])
    assert SLO_STATS["observed"] == 3 and SLO_STATS["breaches"] == 0


def test_router_ingest_fence_invalidates_the_cache():
    from libgrape_lite_tpu.dyn import RepackPolicy as JRepackPolicy
    from libgrape_lite_tpu.serve import BatchPolicy as JBatchPolicy
    from libgrape_lite_tpu.serve import ServeSession as JServeSession
    from tests import test_dyn as jdyn

    base = build_graph(2)
    cold_frag = replicate_fragment(base)
    router = FleetRouter([ServeSession(
        base, policy=BatchPolicy(max_batch=4),
        dyn=RepackPolicy(threshold=0.5, capacity=64))])
    cache = ResultCache(capacity=8)
    router.attach_cache(cache)
    r1 = router.submit("sssp", {"source": 0})
    router.drain()
    r2 = router.submit("sssp", {"source": 0})
    router.drain()
    assert r1.result.ok and r2.result.ok and cache.hits == 1
    router.ingest(ADDS)
    assert router.fence == 1 and cache.invalidations >= 1 and len(cache) == 0
    r3 = router.submit("sssp", {"source": 0})
    router.drain()
    cold = ServeSession(cold_frag, policy=BatchPolicy(max_batch=4),
                        dyn=RepackPolicy(threshold=0.5, capacity=64))
    cold.ingest(ADDS)
    ref = cold.serve([("sssp", {"source": 0})])
    jsess = JServeSession(jdyn.build_graph(2), policy=JBatchPolicy(
        max_batch=4), dyn=JRepackPolicy(threshold=0.5, capacity=64))
    jsess.ingest(ADDS)
    want = jsess.serve([("sssp", {"source": 0})])[0].values.tobytes()
    assert r3.result.values.tobytes() == ref[0].values.tobytes() == want
    assert r3.result.values.tobytes() != r1.result.values.tobytes()


def test_bare_session_ingest_bumps_the_cache_epoch():
    sess = _session(dyn=RepackPolicy(threshold=0.5, capacity=64))
    cache = ResultCache(capacity=8)
    sess.attach_result_cache(cache)
    sess.serve([("sssp", {"source": 0})])
    assert cache.stores == 1
    sess.ingest([])  # nothing staged: the epoch stays
    assert len(cache) == 1
    sess.ingest(ADDS)
    assert len(cache) == 0
    out = sess.serve([("sssp", {"source": 0})])
    assert out[0].ok and cache.hits == 0


def test_shed_fails_loudly_and_burns_the_tenant():
    slo.configure("tenant:hog=0.000001")
    slo.observe("sssp", "hog", 0.001, ok=False)
    burn0 = SLO_STATS["burn_by_key"]["tenant:hog"]
    assert burn0 >= 2.0
    sess = _session()
    ctl = AdmissionController(cost_of=lambda req: 0.0)
    sess.attach_admission(ctl)
    doomed = sess.submit("sssp", {"source": 0}, tenant="hog")
    live = sess.submit("sssp", {"source": 7})
    out = sess.drain()
    assert len(out) == 2
    assert not doomed.result.ok
    assert doomed.result.error["reason"] == "shed_over_budget"
    assert sess.queue.shed == 1 and live.result.ok
    assert SLO_STATS["breaches"] >= 2
    assert SLO_STATS["burn_by_key"]["tenant:hog"] >= burn0
    assert AUTOPILOT_STATS["shed"] == 1
    assert AUTOPILOT_STATS["decisions"][-1]["tenant"] == "hog"


def test_defer_queues_behind_in_budget_tenants():
    sess = ServeSession(build_graph(2),
                        policy=BatchPolicy(max_batch=1, max_wait_s=60.0))
    sess.queue.admission = (
        lambda req: "defer" if req.tenant == "slow" else "admit")
    first = sess.queue.submit("sssp", {"source": 0}, tenant="slow")
    second = sess.queue.submit("sssp", {"source": 7}, tenant="fast")
    assert [r.id for r in sess.queue._pop_ready(force=True)] == [second.id]
    assert [r.id for r in sess.queue._pop_ready(force=True)] == [first.id]


def test_admission_review_prices_and_never_raises():
    frag = build_graph(2)
    slo.configure("tenant:t=0.000001")
    slo.observe("sssp", "t", 0.01, ok=False)
    slo.observe("sssp", "t", 0.0, ok=True)  # burn 50: past shed
    ctl = AdmissionController(AdmissionConfig(shed_burn=1000.0,
                                              max_cost=1.0), fragment=frag)

    class Req:
        tenant, app_key, max_rounds = "t", "sssp", 2

    assert ctl.review(Req) == "shed"  # over budget and pricier than 1 B
    assert AUTOPILOT_STATS["decisions"][-1]["cost"] == round(
        query_cost(frag, 2), 1)
    Req.tenant = None
    assert ctl.review(Req) == "admit"
    boom = AdmissionController(cost_of=lambda req: 1 / 0)
    assert boom.review(Req) == "admit"


def test_deadline_expiry_burns_the_slo_budget():
    slo.configure("sssp=1000")
    sess = ServeSession(build_graph(2),
                        policy=BatchPolicy(max_batch=8, max_wait_s=60.0))
    doomed = sess.submit("sssp", {"source": 0}, deadline_s=0.001)
    time.sleep(0.01)
    out = sess.drain()
    assert doomed.result.error["reason"] == "deadline_expired"
    assert any(r.request_id == doomed.id for r in out)
    assert SLO_STATS["breaches"] >= 1 and SLO_STATS["burn_by_key"]["sssp"] > 0


# ---- signals and the autoscaler on a real fleet ---------------------------

def test_signal_reader_without_a_fleet_and_over_a_router():
    rd = SignalReader(window=2)
    s1 = rd.read()
    assert s1.replicas == 0 and s1.queue_depth == 0 and not rd.saturated
    rd.read()
    assert rd.saturated and rd.recent[0] is s1
    rd.clear()
    assert rd.recent == ()
    router = _fleet(2)
    for s in (0, 7, 19):
        router.submit("sssp", {"source": s})
    slo.configure("tenant:t0=1")
    slo.observe("sssp", "t0", 1.0, ok=True)
    sig = SignalReader(router).read()
    assert (sig.queue_depth, sig.outstanding, sig.replicas) == (3, 3, 2)
    assert sig.burn_of("t0") == 100.0 and sig.max_burn == 100.0
    assert sig.burn_of("nobody") == 0.0
    with pytest.raises(ValueError, match="window"):
        SignalReader(window=0)


def _fleet(R, *, max_batch=4):
    base = build_graph(2)
    frags = [base] + [replicate_fragment(base) for _ in range(R - 1)]
    return FleetRouter([ServeSession(
        f, policy=BatchPolicy(max_batch=max_batch),
        dyn=RepackPolicy(threshold=0.5, capacity=64)) for f in frags])


def _factory(max_batch=4):
    return lambda frag: ServeSession(
        frag, policy=BatchPolicy(max_batch=max_batch),
        dyn=RepackPolicy(threshold=0.5, capacity=64))


def _reference(sources):
    ref = _fleet(1)
    out = {}
    for s in sources:
        q = ref.submit("sssp", {"source": s})
        ref.drain()
        out[s] = q.result.values.tobytes()
    return out


def test_autoscaler_grows_the_fleet_bit_equally():
    sources = [0, 7, 19, 30, 3, 11, 23, 29]
    want = _reference(sources)
    router = _fleet(1, max_batch=2)
    scaler = Autoscaler(router, ScalerConfig(
        min_replicas=1, max_replicas=2, window=2, cooldown_ticks=2,
        up_queue_depth=2), session_factory=_factory(max_batch=2))
    reqs = [router.submit("sssp", {"source": s}) for s in sources]
    assert scaler.tick().reason == "window_filling"
    d = scaler.tick()
    assert d.action == "scale_up" and "added r1" in d.reason
    router.drain()
    assert AUTOPILOT_STATS["scale_ups"] == 1 and AUTOPILOT_STATS["ticks"] == 2
    assert sum(r.routable for r in router.replicas) == 2
    assert all(q.result.ok for q in reqs)
    assert [q.result.values.tobytes() for q in reqs] == [want[s]
                                                         for s in sources]
    assert FLEET_STATS.events[-1]["kind"] == "add_replica"


@pytest.mark.parametrize("R", [2, 3])
def test_scale_drill_grow_and_shrink(R):
    sources = [0, 7, 19, 30]
    want = _reference(sources)
    router = _fleet(1)
    router.ingest([])  # the fence moves; a new replica joins at it
    scaler = Autoscaler(router, ScalerConfig(min_replicas=1, max_replicas=R,
                                             cooldown_ticks=0),
                        session_factory=_factory())
    for n in range(1, R):
        assert scaler.act(Decision("scale_up", "drill", n, n + 1)).action \
            == "scale_up"
    assert all(r.version == router.fence for r in router.replicas)
    grown = [router.submit("sssp", {"source": s}) for s in sources]
    router.drain()
    assert [q.result.values.tobytes() for q in grown] == [want[s]
                                                          for s in sources]
    for n in range(R, 1, -1):
        assert scaler.act(Decision("scale_down", "drill", n, n - 1)).action \
            == "scale_down"
        router.pump()
    assert sum(r.routable for r in router.replicas) == 1
    d = scaler.act(Decision("scale_down", "drill", 1, 0))
    assert d.action == "hold" and d.reason == "at_min_replicas"
    shrunk = [router.submit("sssp", {"source": s}) for s in sources]
    router.drain()
    assert [q.result.values.tobytes() for q in shrunk] == [want[s]
                                                           for s in sources]


def test_autoscaler_prefers_rejoin_folds_the_overlay_and_scales_down_lifo():
    router = _fleet(2)
    router.begin_drain(1)

    def boom(frag):
        raise AssertionError("must rejoin the parked replica")

    scaler = Autoscaler(router, ScalerConfig(max_replicas=3),
                        session_factory=boom)
    d = scaler.act(Decision("scale_up", "drill", 1, 2))
    assert "rejoined r1" in d.reason and router.replicas[1].routable
    assert scaler.cooldown == scaler.config.cooldown_ticks
    # a fresh replica folds the source's overlay first (a counted repack)
    router.ingest(ADDS)
    grow = Autoscaler(router, ScalerConfig(max_replicas=3),
                      session_factory=_factory())
    src = router.replicas[0].session
    assert grow.act(Decision("scale_up", "drill", 2, 3)).action == "scale_up"
    assert src.stats["repacks"] == 1 and src.dyn.overlay_count == 0
    down = Autoscaler(router, ScalerConfig(min_replicas=1, max_replicas=3,
                                           window=2, cooldown_ticks=0))
    decisions = [down.tick() for _ in range(3)]
    assert any(d.action == "scale_down" for d in decisions)
    assert not router.replicas[2].routable and router.replicas[0].routable


def test_autoscaler_holds_without_a_factory_over_budget_and_on_failure():
    router = _fleet(1)
    d = Autoscaler(router, ScalerConfig(max_replicas=2)).act(
        Decision("scale_up", "drill", 1, 2))
    assert d.action == "hold" and d.reason == "no_session_factory"
    d = Autoscaler(router, ScalerConfig(max_replicas=2),
                   session_factory=_factory(),
                   budget=FleetBudget(capacity_bytes=1)).act(
        Decision("scale_up", "drill", 1, 2))
    assert d.action == "hold" and d.reason.startswith("hbm_budget")

    def broken(frag):
        raise RuntimeError("no room")

    d = Autoscaler(router, ScalerConfig(max_replicas=2),
                   session_factory=broken).act(
        Decision("scale_up", "drill", 1, 2))
    assert d.action == "hold" and d.reason.startswith("act_failed")
    assert len(router.replicas) == 1
