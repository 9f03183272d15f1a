"""The port's telemetry plane on the CPU (`libgrape_lite_tpu_torch/obs/`
exporter, recorder and SLO hooks, and the spans of serve/ and fleet/),
held against the JAX package's where both produce the same record, plus
the port counterparts of tests/test_telemetry.py.

* the federation's wiring holds with the flight recorder's namespace;
  the exporter's text of one snapshot is byte-equal to the JAX
  exporter's; a live scrape names every registered namespace; a serve
  run armed in both CLIs exposes every `grape_` name of the JAX
  exporter's scrape whose surface the port has;
* an SLO breach is the same instant and counter in both; the recorder
  ring is bounded, triggers count without a sink, dump with one and
  never raise; a deadline storm dumps a bundle with the JAX bundle's
  keys;
* the serving session and pump emit the JAX session's `serve_batch` /
  `serve_query` rows (lane, rounds, ok) with tenant and queue wait; the
  pump's dispatch and harvest spans; the fleet router's `fleet_pump`
  spans on every replica, its ingest and drain instants, the fence
  violation's bundle; the tenancy's eviction counter and resident bytes;
* the `postmortem` subcommand renders a bundle and joins it row for row
  to the trace, catches drift, refuses a foreign schema, and each
  package's bundle renders in the other's subcommand.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from libgrape_lite_tpu import obs as jobs
from libgrape_lite_tpu.obs import slo as jslo
from libgrape_lite_tpu.obs.recorder import RECORDER as JRECORDER
from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.obs import exporter, federation, slo
from libgrape_lite_tpu_torch.obs.recorder import (
    BUNDLE_SCHEMA,
    DEADLINE_STORM_THRESHOLD,
    REC_STATS,
    RECORDER,
    FlightRecorder,
)
from libgrape_lite_tpu_torch.serve import AdmissionQueue, BatchPolicy, ServeSession
from tests.conftest import dataset_path
from tests.test_torch_lanes import port_fragment

torch.set_num_threads(1)

P2P = ["--efile", dataset_path("p2p-31.e"),
       "--vfile", dataset_path("p2p-31.v")]
SOURCES = [6, 5229, 8200, 17]


@pytest.fixture(autouse=True)
def _telemetry_reset(monkeypatch):
    """Both packages disarmed, with no SLO and no sink, before and after."""
    for o, s in ((obs, slo), (jobs, jslo)):
        monkeypatch.delenv(o.TRACE_ENV, raising=False)
        monkeypatch.delenv(o.METRICS_ENV, raising=False)
        monkeypatch.delenv(s.SLO_ENV, raising=False)
        o.reset()
        s.configure(None, budget_frac=s.DEFAULT_BUDGET_FRAC)
    monkeypatch.delenv("GRAPE_POSTMORTEM", raising=False)
    monkeypatch.delenv(exporter.METRICS_PORT_ENV, raising=False)
    for rec in (RECORDER, JRECORDER):
        rec.set_sink(None)
    yield
    for o, s in ((obs, slo), (jobs, jslo)):
        o.reset()
        s.configure(None, budget_frac=s.DEFAULT_BUDGET_FRAC)
    for rec in (RECORDER, JRECORDER):
        rec.set_sink(None)
    exporter.stop_exporter()


# ---- federation and exporter -----------------------------------------------


def test_federation_wires_the_recorder_namespace():
    from libgrape_lite_tpu.obs import federation as jfederation

    assert federation.self_check() == []
    assert federation.EXPECTED["recorder"] == \
        jfederation.EXPECTED["recorder"].replace(
            "libgrape_lite_tpu.", "libgrape_lite_tpu_torch.")
    snap = federation.snapshot("recorder")
    assert set(snap) == set(jfederation.snapshot("recorder"))


def test_exporter_text_byte_equal_to_jax():
    from libgrape_lite_tpu.obs.exporter import (
        federation_text as jfederation_text,
    )

    snap = {
        "t": {"count": 3, "ratio": 0.5, "whole": 2.0, "flag": True,
              "by_key": {"a": 1, "b": 2.5, "c": "x"}, "note": "json-only",
              "hist": [1, 2], "none": None},
        "u": {}, 'q"x': {"n": 1},
    }
    text = exporter.federation_text(snap)
    assert text == jfederation_text(snap)
    assert 'grape_stats_t_by_key{key="b"} 2.5' in text
    assert "note" not in text and "hist" not in text


def test_exporter_scrape_names_every_registered_namespace():
    federation.self_check()
    obs.configure(in_memory=True)
    obs.metrics().counter("grape_queries_total").inc()
    exp = exporter.MetricsExporter(port=0)
    try:
        text = urllib.request.urlopen(exp.url + "/metrics",
                                      timeout=10).read().decode()
        assert text.endswith("# EOF\n")
        assert "grape_queries_total 1" in text
        for ns in federation.registered():
            assert f'grape_stats_registry{{namespace="{ns}"}} 1' in text
        fed = json.load(urllib.request.urlopen(exp.url + "/federation",
                                               timeout=10))
        assert sorted(fed) == federation.registered()
        health = json.load(urllib.request.urlopen(exp.url + "/healthz",
                                                  timeout=10))
        assert health == {"ok": True,
                          "namespaces": len(federation.registered())}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(exp.url + "/nope", timeout=10)
    finally:
        exp.stop()


def test_exporter_start_is_idempotent_stoppable_and_env_armed(monkeypatch):
    a = exporter.start_exporter(0)
    assert exporter.start_exporter(0) is a and a.port > 0
    exporter.stop_exporter()
    assert exporter.get_exporter() is None
    for bad in ("x", "-1"):
        monkeypatch.setenv(exporter.METRICS_PORT_ENV, bad)
        assert exporter.maybe_start_from_env() is None
    monkeypatch.setenv(exporter.METRICS_PORT_ENV, "0")
    assert exporter.maybe_start_from_env() is exporter.get_exporter()


def _scrape_names(text: str) -> set:
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            names.add(line.split("{")[0].split(" ")[0])
    return names


def test_serve_scrape_has_every_jax_name_of_the_ported_surfaces(capsys):
    from libgrape_lite_tpu.cli import serve_main as jserve_main
    from libgrape_lite_tpu.obs import exporter as jexporter
    from libgrape_lite_tpu.obs import federation as jfederation

    from libgrape_lite_tpu_torch.cli import serve_main

    argv = [*P2P, "--num_queries", "8", "--max_batch", "4", "--inflight",
            "2", "--metrics_port", "0", "--slo", "sssp=0.001"]
    scraped = {}
    # both scrapes hold this run's records only: a decision record left
    # by an earlier test in the process (say `partition.last_decision`)
    # is no name of the serving run
    jfederation.reset()
    federation.reset()
    try:
        jobs.configure(in_memory=True)
        jserve_main(argv)
        scraped["jax"] = urllib.request.urlopen(
            jexporter.get_exporter().url + "/metrics", timeout=10
        ).read().decode()
    finally:
        jexporter.stop_exporter()
    obs.configure(in_memory=True)
    assert serve_main(argv + ["--device", "cpu"]) == 0
    scraped["port"] = urllib.request.urlopen(
        exporter.get_exporter().url + "/metrics", timeout=10).read().decode()
    capsys.readouterr()
    jax_names, port_names = (_scrape_names(scraped[k]) for k in ("jax",
                                                                  "port"))
    ours = tuple(f"grape_stats_{ns}_" for ns in federation.registered())
    wanted = {n for n in jax_names
              if not n.startswith("grape_pack_")
              and (not n.startswith("grape_stats_")
                   or n == "grape_stats_registry" or n.startswith(ours))}
    assert wanted - port_names == set()
    for name in ("grape_serve_admission_wait_seconds_count",
                 "grape_serve_window_depth", "grape_supersteps_total",
                 "grape_slo_breaches_total", "grape_graph_edges",
                 "grape_stats_pump_engaged", "grape_stats_slo_breaches"):
        assert name in port_names, name


# ---- SLO -------------------------------------------------------------------


def test_slo_breach_instant_and_counter_match_jax():
    for o, s in ((obs, slo), (jobs, jslo)):
        o.configure(in_memory=True)
        s.configure("sssp=0.0001", budget_frac=0.05)
        s.observe("sssp", "t0", 1.0)
        s.observe("sssp", None, 0.0, ok=False)
        s.observe("bfs", None, 1.0)  # no objective: nothing
    p = [e for e in obs.history() if e["ph"] == "i"]
    j = [e for e in jobs.history() if e["ph"] == "i"]
    assert [e["args"] for e in p] == [e["args"] for e in j]
    assert [e["name"] for e in p] == ["slo_breach"] * 2
    assert obs.metrics().snapshot() == jobs.metrics().snapshot()
    assert obs.metrics().snapshot()["grape_slo_breaches_total"][
        "value"] == 2


def test_slo_disarmed_observe_stays_cheap():
    assert not slo.configured()
    n = 50_000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            slo.observe("sssp", None, 0.001)
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"disarmed observe costs {best * 1e9:.0f}ns"


# ---- flight recorder -------------------------------------------------------


def test_recorder_ring_is_bounded_and_counts_drops():
    rec = FlightRecorder(capacity=4)
    base = REC_STATS["dropped"]
    for i in range(10):
        rec.record("tick", i=i)
    assert [e["i"] for e in rec.events()] == [6, 7, 8, 9]
    assert REC_STATS["dropped"] == base + 6


def test_recorder_trigger_without_sink_counts_but_never_dumps():
    rec = FlightRecorder()
    before = REC_STATS["triggers"]
    assert rec.trigger("unit_test_reason") is None
    assert REC_STATS["triggers"] == before + 1
    assert REC_STATS["last_reason"] == "unit_test_reason"


def test_recorder_dump_is_schema_valid_and_correlated(tmp_path):
    tr = obs.configure(in_memory=True)
    with tr.span("serve_query", query_id=7):
        pass
    tr.instant("fleet_ingest", fence=1)
    rec = FlightRecorder()
    rec.set_sink(str(tmp_path))
    rec.record("admission", qid=7)
    path = rec.trigger("fence_violation", extra={"replica": 1})
    bundle = json.load(open(path))
    assert bundle["schema"] == BUNDLE_SCHEMA
    assert bundle["trace_id"] == obs.trace_id()
    assert bundle["extra"] == {"replica": 1}
    assert any(e["kind"] == "admission" for e in bundle["events"])
    want = [e for e in tr.events() if e["ph"] == "X"]
    assert [json.dumps(s, sort_keys=True) for s in bundle["spans"]] == \
        [json.dumps(e, sort_keys=True) for e in want]
    assert "recorder" in bundle["federation"]
    # the dump itself lands on the timeline
    assert tr.events()[-1]["name"] == "postmortem"
    jrec = type(JRECORDER)()
    jobs.configure(in_memory=True)
    assert list(jrec.build_bundle("x")) == list(rec.build_bundle("x"))


def test_recorder_trigger_never_raises_on_bad_sink(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    rec = FlightRecorder()
    rec.set_sink(str(blocker / "sub"))
    assert rec.trigger("whatever") is None


def test_deadline_storm_trips_the_recorder(tmp_path):
    RECORDER.set_sink(str(tmp_path))
    before = REC_STATS["triggers"]
    q = AdmissionQueue(dispatch=lambda batch: [])
    for i in range(DEADLINE_STORM_THRESHOLD + 1):
        q.submit("sssp", {"source": i}, deadline_s=-1.0)
    assert q._pop_ready(force=True) == []
    assert REC_STATS["triggers"] == before + 1
    assert REC_STATS["last_reason"] == "deadline_storm"
    expired = q.take_expired()
    assert len(expired) == DEADLINE_STORM_THRESHOLD + 1
    assert all(not r.ok and r.error["reason"] == "deadline_expired"
               for r in expired)
    (path,) = tmp_path.glob("postmortem_deadline_storm_*.json")
    bundle = json.load(open(path))
    assert bundle["extra"]["expired_in_sweep"] == DEADLINE_STORM_THRESHOLD + 1
    assert bundle["events"][-1]["kind"] == "deadline_expired"
    # one expiry below the threshold records without a trigger
    q.submit("sssp", {"source": 0}, deadline_s=-1.0)
    q._pop_ready(force=True)
    assert REC_STATS["triggers"] == before + 1


def test_shed_records_the_recorder_event():
    q = AdmissionQueue(dispatch=lambda batch: [])
    q.admission = lambda req: "shed"
    q.submit("sssp", {"source": 1}, tenant="t0")
    assert q._pop_ready(force=True) == []
    last = RECORDER.events()[-1]
    assert last["kind"] == "shed_over_budget" and last["n"] == 1


# ---- serve/ spans ----------------------------------------------------------


def _serve_rows(events):
    return [(e["name"], (e.get("args") or {}).get("lane"),
             (e.get("args") or {}).get("rounds"),
             (e.get("args") or {}).get("ok"),
             (e.get("args") or {}).get("batch"))
            for e in events if e["ph"] == "X"
            and e["name"] in ("serve_batch", "serve_query")]


@pytest.mark.parametrize("max_batch", [1, 2])
def test_session_serve_rows_match_jax(graph_cache, max_batch):
    from libgrape_lite_tpu.serve import BatchPolicy as JBatchPolicy
    from libgrape_lite_tpu.serve import ServeSession as JServeSession

    stream = [("sssp", {"source": s}) for s in SOURCES]
    jobs.configure(in_memory=True)
    JServeSession(graph_cache(2),
                  policy=JBatchPolicy(max_batch=max_batch)).serve(stream)
    obs.configure(in_memory=True)
    sess = ServeSession(port_fragment(2),
                        policy=BatchPolicy(max_batch=max_batch))
    sess.serve(stream)
    assert _serve_rows(obs.history()) == _serve_rows(jobs.history())
    rows = [e for e in obs.history() if e["ph"] == "X"
            and e["name"] == "serve_query"]
    assert len(rows) == len(stream)
    for e in rows:
        assert e["args"]["tenant"] == "" and e["args"]["queue_wait_us"] >= 0
    psnap, jsnap = obs.metrics().snapshot(), jobs.metrics().snapshot()
    for k in ("grape_supersteps_total", "grape_queries_total"):
        assert psnap[k] == jsnap[k], k
    assert psnap["grape_serve_admission_wait_seconds"]["count"] == \
        jsnap["grape_serve_admission_wait_seconds"]["count"] == len(stream)


def test_pump_spans_and_window_metrics():
    obs.configure(in_memory=True)
    sess = ServeSession(port_fragment(2), policy=BatchPolicy(max_batch=2))
    pump = sess.async_pump(window=2)
    reqs = [sess.submit("sssp", {"source": s}, tenant="t1")
            for s in SOURCES]
    pump.drain()
    assert all(r.result.ok for r in reqs)
    ev = [e for e in obs.history() if e["ph"] == "X"]
    names = [e["name"] for e in ev]
    assert names.count("serve_dispatch") == names.count("serve_harvest") == 2
    q = [e for e in ev if e["name"] == "serve_query"]
    assert sorted(e["args"]["query_id"] for e in q) == \
        sorted(r.id for r in reqs)
    assert {e["args"]["tenant"] for e in q} == {"t1"}
    assert {e["tid"] for e in q} == {2000, 2001}  # one row a lane
    snap = obs.metrics().snapshot()
    assert snap["grape_serve_window_depth"]["value"] == 0
    assert len(snap["grape_serve_queue_depth_series"]["values"]) == 2
    assert snap["grape_supersteps_total"]["value"] == sum(
        r.result.rounds for r in reqs) + len(reqs)


def test_cache_hit_emits_a_cached_serve_query():
    from libgrape_lite_tpu_torch.autopilot import ResultCache

    sess = ServeSession(port_fragment(1))
    sess.attach_result_cache(ResultCache(capacity=8))
    sess.serve([("sssp", {"source": 6})])
    obs.configure(in_memory=True)
    sess.serve([("sssp", {"source": 6})])
    rows = [e for e in obs.history() if e.get("name") == "serve_query"]
    assert len(rows) == 1 and rows[0]["args"]["cached"] is True


# ---- fleet/ spans ----------------------------------------------------------


def _router(R, *, dyn=False):
    from libgrape_lite_tpu_torch.dyn import RepackPolicy
    from libgrape_lite_tpu_torch.fleet import FleetRouter
    from libgrape_lite_tpu_torch.fragment.mutation import replicate_fragment
    from tests.test_torch_dyn import build_graph

    base = build_graph(2)
    frags = [base] + [replicate_fragment(base) for _ in range(R - 1)]
    return FleetRouter([ServeSession(
        f, policy=BatchPolicy(max_batch=4),
        dyn=RepackPolicy(threshold=0.5, capacity=64) if dyn else None)
        for f in frags])


def test_fleet_router_spans_instants_and_gauges():
    from tests.test_dyn import ADDS

    obs.configure(in_memory=True)
    router = _router(2, dyn=True)
    for s in (0, 7, 19, 30):
        router.submit("sssp", {"source": s})
    router.pump()
    router.drain()
    router.begin_drain(0)
    router.ingest(ADDS)
    router.rejoin(0)
    ev = obs.history()
    pumps = [e for e in ev if e["ph"] == "X" and e["name"] == "fleet_pump"]
    assert {e["args"]["replica"] for e in pumps} == {0, 1}
    rows = [e for e in ev if e["ph"] == "X" and e["name"] == "fleet_replica"]
    assert {e["tid"] for e in rows} == {3000, 3001}
    inst = [e["name"] for e in ev if e["ph"] == "i"]
    assert inst == ["fleet_drain_begin", "fleet_ingest", "fleet_rejoin"]
    ingest = [e for e in ev if e.get("name") == "fleet_ingest"][0]["args"]
    assert ingest == {"fence": 1, "ops": len(ADDS), "applied": 1,
                      "deferred": 1}
    snap = obs.metrics().snapshot()
    assert snap["grape_fleet_outstanding_r0"]["value"] == 2
    assert snap["grape_fleet_outstanding_r1"]["value"] == 2


def test_fence_violation_triggers_the_recorder(tmp_path):
    from libgrape_lite_tpu_torch.fleet import FenceViolationError

    RECORDER.set_sink(str(tmp_path))
    router = _router(2)
    router.replicas[1].version = 5
    with pytest.raises(FenceViolationError):
        router.submit("sssp", {"source": 0})
    (path,) = tmp_path.glob("postmortem_fence_violation_*.json")
    assert json.load(open(path))["extra"] == {
        "replica": 1, "replica_version": 5, "fence": 0}


def test_tenancy_eviction_counter_and_resident_bytes():
    from libgrape_lite_tpu_torch.fleet import (
        FleetBudget,
        FleetManager,
        fragment_bytes,
    )
    from tests.test_torch_dyn import build_graph

    obs.configure(in_memory=True)
    fa, fb = build_graph(2, seed=3), build_graph(2, seed=5)
    cap = int(max(fragment_bytes(fa), fragment_bytes(fb)) * 1.5)
    mgr = FleetManager(FleetBudget(capacity_bytes=cap))
    mgr.add_tenant("a", ServeSession(fa))
    mgr.add_tenant("b", ServeSession(fb))
    for t in ("a", "b", "a"):
        mgr.submit(t, "sssp", {"source": 0})
        mgr.drain()
    snap = obs.metrics().snapshot()
    assert snap["grape_fleet_evictions_total"]["value"] == 2
    assert snap["grape_fleet_resident_bytes"]["value"] == \
        mgr.budget.used_bytes() > 0


# ---- postmortem ------------------------------------------------------------


def _bundle_with_trace(tmp_path, package: str, graph_cache=None):
    """An armed serve run and a recorder dump, flushed to disk."""
    trace = str(tmp_path / f"{package}_trace.json")
    sink = str(tmp_path / f"{package}_sink")
    stream = [("sssp", {"source": s}) for s in (6, 5229)]
    if package == "jax":
        from libgrape_lite_tpu.obs.recorder import (
            FlightRecorder as JFlightRecorder,
        )
        from libgrape_lite_tpu.serve import BatchPolicy as JBatchPolicy
        from libgrape_lite_tpu.serve import ServeSession as JServeSession

        jobs.configure(trace_path=trace)
        JServeSession(graph_cache(2),
                      policy=JBatchPolicy(max_batch=2)).serve(stream)
        rec = JFlightRecorder()
        rec.set_sink(sink)
        path = rec.trigger("deadline_storm", extra={"expired_in_sweep": 8})
        jobs.flush()
        return path, trace
    obs.configure(trace_path=trace)
    ServeSession(port_fragment(2),
                 policy=BatchPolicy(max_batch=2)).serve(stream)
    rec = FlightRecorder()
    rec.set_sink(sink)
    path = rec.trigger("deadline_storm", extra={"expired_in_sweep": 8})
    obs.flush()
    return path, trace


def test_postmortem_cli_renders_and_byte_matches_trace(tmp_path, capsys):
    from libgrape_lite_tpu_torch.cli import main

    bundle, trace = _bundle_with_trace(tmp_path, "port")
    assert main(["postmortem", bundle]) == 0
    out = capsys.readouterr().out
    assert "postmortem: deadline_storm" in out and "guard:       no" in out
    assert main(["postmortem", bundle, "--trace", trace]) == 0
    assert "2 serve_query row(s) byte-matched, 0 mismatched, 0 absent" \
        in capsys.readouterr().out
    assert main(["postmortem", bundle, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["schema"] == BUNDLE_SCHEMA


def test_postmortem_cli_detects_row_drift(tmp_path, capsys):
    from libgrape_lite_tpu_torch.cli import postmortem_main

    bundle, trace = _bundle_with_trace(tmp_path, "port")
    doc = json.load(open(bundle))
    for s in doc["spans"]:
        if s["name"] == "serve_query":
            s["dur"] += 1
    drifted = str(tmp_path / "drifted.json")
    json.dump(doc, open(drifted, "w"))
    assert postmortem_main([drifted, "--trace", trace]) == 1
    assert "2 mismatched" in capsys.readouterr().out
    doc["spans"] = [dict(s, args=dict(s.get("args") or {}, query_id=-1))
                    for s in doc["spans"]]
    json.dump(doc, open(drifted, "w"))
    assert postmortem_main([drifted, "--trace", trace]) == 1
    assert "2 absent" in capsys.readouterr().out


def test_postmortem_cli_rejects_foreign_schema(tmp_path, capsys):
    from libgrape_lite_tpu_torch.cli import postmortem_main

    p = str(tmp_path / "not_a_bundle.json")
    json.dump({"schema": "something-else-v9"}, open(p, "w"))
    assert postmortem_main([p]) == 2
    assert postmortem_main([str(tmp_path / "missing.json")]) == 2
    json.dump([1, 2], open(p, "w"))
    assert postmortem_main([p]) == 2
    assert "schema" in capsys.readouterr().err


def test_bundles_render_in_both_packages(tmp_path, capsys, graph_cache):
    from libgrape_lite_tpu.cli import postmortem_main as jpostmortem_main

    from libgrape_lite_tpu_torch.cli import postmortem_main

    port_bundle, port_trace = _bundle_with_trace(tmp_path, "port")
    jax_bundle, jax_trace = _bundle_with_trace(tmp_path, "jax", graph_cache)
    outs = {}
    for who, fn in (("port", postmortem_main), ("jax", jpostmortem_main)):
        for bundle, trace in ((port_bundle, port_trace),
                              (jax_bundle, jax_trace)):
            assert fn([bundle, "--trace", trace]) == 0
            outs[(who, bundle)] = capsys.readouterr().out
    for bundle in (port_bundle, jax_bundle):
        assert outs[("port", bundle)] == outs[("jax", bundle)]
        assert "2 serve_query row(s) byte-matched" in outs[("port", bundle)]
    pdoc, jdoc = json.load(open(port_bundle)), json.load(open(jax_bundle))
    assert list(pdoc) == list(jdoc)
    assert np.array_equal(
        [s["args"]["lane"] for s in pdoc["spans"]
         if s["name"] == "serve_query"],
        [s["args"]["lane"] for s in jdoc["spans"]
         if s["name"] == "serve_query"])
