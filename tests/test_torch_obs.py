"""The port's obs/ tracer and metrics registry (`libgrape_lite_tpu_torch/
obs/`) on the CPU, held against the JAX package's on p2p-31 at fnum 1
and 4, plus the port counterparts of tests/test_obs.py.

* An SSSP and a PageRank query armed in both packages (JAX
  `Worker.query_stepwise`, the port's `Worker.query`) emit the same
  sequence of spans and counters -- names, `round`, `active`, the
  per-fragment mirrors -- and equal metrics snapshots (the JAX pack
  planner's `grape_pack_*` gauges excluded by name); the load emits the
  same `load_graph` spans and gauges.
* Identical registries print byte-equal Prometheus text in both.
* Each package's trace loads in the other's `load_trace` and renders the
  same table in both `trace_report`s.
* Armed results are bit-equal to disarmed ones.
* The tracer core: span nesting, the dispatched / device-wait split, the
  Chrome schema and its JSONL twin, the disarmed span under a
  microsecond, the disarmed surface inert; the registry; the `compiled`
  mark; the logging module's lazy levels, rank prefix and tracer sink;
  `run_app --trace / --metrics / --profile`.
"""

import json
import sys
import time

import numpy as np
import pytest
import torch

from libgrape_lite_tpu import obs as jobs
from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import SSSP, PageRank
from libgrape_lite_tpu_torch.obs.events import CHROME_REQUIRED, FRAG_TID_BASE
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path

torch.set_num_threads(1)

P2P = (dataset_path("p2p-31.e"), dataset_path("p2p-31.v"))


@pytest.fixture(autouse=True)
def _obs_reset(monkeypatch):
    """Both packages disarmed before and after every case."""
    for mod in (obs, jobs):
        monkeypatch.delenv(mod.TRACE_ENV, raising=False)
        monkeypatch.delenv(mod.METRICS_ENV, raising=False)
        mod.reset()
    yield
    obs.reset()
    jobs.reset()


_FRAGS = {}


def port_fragment(fnum: int):
    if fnum not in _FRAGS:
        _FRAGS[fnum] = LoadGraph(
            *P2P, CommSpec(fnum=fnum, device="cpu"),
            LoadGraphSpec(weighted=True, edata_dtype=np.float64))
    return _FRAGS[fnum]


def port_app(name: str):
    if name == "pagerank":
        return PageRank(dtype=torch.float64)
    return SSSP(dtype=torch.float64)


def jax_app(name: str):
    from libgrape_lite_tpu.models import SSSP as JSSSP
    from libgrape_lite_tpu.models import PageRank as JPageRank

    return JPageRank() if name == "pagerank" else JSSSP()


QUERY = {"pagerank": {"delta": 0.85, "max_round": 10},
         "sssp": {"source": 6}}


def shape(events):
    """The comparable skeleton of a trace: per event its kind and name,
    and a span's row band, round, active vote and fragment."""
    out = []
    for e in events:
        a = e.get("args") or {}
        if e["ph"] == "X":
            out.append(("X", e["name"], e["tid"] >= FRAG_TID_BASE,
                        a.get("round"), a.get("active"), a.get("frag")))
        elif e["ph"] == "C":
            out.append(("C", e["name"], tuple(sorted(a.items()))))
        elif e["ph"] == "i":
            out.append(("i", e["name"]))
    return out


def without_pack(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if not k.startswith("grape_pack_")}


# ---- parity with the JAX package -------------------------------------------


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_query_spans_and_metrics_match_jax(graph_cache, app, fnum):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    jfrag = graph_cache(fnum)
    pfrag = port_fragment(fnum)
    jtr = jobs.configure(in_memory=True)
    jw = JWorker(jax_app(app), jfrag)
    jw.query_stepwise(**QUERY[app])
    ptr = obs.configure(in_memory=True)
    pw = Worker(port_app(app), pfrag)
    pw.query(**QUERY[app])
    assert pw.rounds == jw.rounds
    jev, pev = jobs.history(), obs.history()
    assert shape(pev) == shape(jev)
    names = [e["name"] for e in pev if e["ph"] == "X"
             and e["tid"] < FRAG_TID_BASE]
    assert names == ["peval"] + ["superstep"] * pw.rounds + ["query"]
    mirrors = [e for e in pev if e["ph"] == "X"
               and e["tid"] >= FRAG_TID_BASE]
    assert len(mirrors) == (0 if fnum == 1 else fnum * (pw.rounds + 1))
    q = [e for e in pev if e["name"] == "query"][0]["args"]
    assert q["mode"] == "host" and q["rounds"] == pw.rounds
    for e in pev:
        if e["ph"] == "X" and e["name"] in ("peval", "superstep") \
                and e["tid"] < FRAG_TID_BASE:
            assert e["args"]["device_wait_us"] >= 0
            assert "dispatched_us" in e["args"]
    psnap = obs.metrics().snapshot()
    assert psnap == without_pack(jobs.metrics().snapshot())
    assert psnap["grape_supersteps_total"]["value"] == pw.rounds + 1
    assert psnap["grape_queries_total"]["value"] == 1
    assert ptr.trace_id != jtr.trace_id


@pytest.mark.parametrize("fnum", [1, 4])
def test_load_graph_spans_and_gauges_match_jax(fnum):
    from libgrape_lite_tpu.fragment.loader import LoadGraph as JLoadGraph
    from libgrape_lite_tpu.fragment.loader import (
        LoadGraphSpec as JLoadGraphSpec,
    )
    from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec

    jobs.configure(in_memory=True)
    JLoadGraph(*P2P, JCommSpec(fnum=fnum),
               JLoadGraphSpec(weighted=True, edata_dtype=np.float64))
    obs.configure(in_memory=True)
    LoadGraph(*P2P, CommSpec(fnum=fnum, device="cpu"),
              LoadGraphSpec(weighted=True, edata_dtype=np.float64))

    def spans(events):
        return [(e["name"], e.get("args")) for e in events
                if e["ph"] == "X"]

    assert spans(obs.history()) == spans(jobs.history())
    assert [n for n, _ in spans(obs.history())] == [
        "read_edges", "partition", "build_fragment", "load_graph"]
    assert obs.metrics().snapshot() == jobs.metrics().snapshot()
    assert obs.metrics().snapshot()["grape_graph_edges"]["value"] > 0


def _fill(m):
    m.counter("grape_retry_attempts_total", help="retries").inc(2)
    m.counter("grape_supersteps_total").inc(3.0)
    m.gauge("grape_query_rounds").set(7)
    m.gauge("grape_ratio").set(0.125)
    h = m.histogram("grape_serve_admission_wait_seconds", help="waits")
    for v in (0.00005, 0.003, 0.2, 99.0):
        h.observe(v)
    m.series("grape_active_per_round").append(5)
    m.series("grape_active_per_round").append(0)
    m.series("grape_empty_series")


def test_prometheus_text_and_snapshot_byte_equal_to_jax(tmp_path):
    from libgrape_lite_tpu.obs.metrics import (
        MetricsRegistry as JMetricsRegistry,
    )

    from libgrape_lite_tpu_torch.obs.metrics import MetricsRegistry

    pm, jm = MetricsRegistry(), JMetricsRegistry()
    _fill(pm)
    _fill(jm)
    assert pm.to_prometheus_text() == jm.to_prometheus_text()
    assert pm.snapshot() == jm.snapshot()
    pm.write(str(tmp_path / "p.json"), str(tmp_path / "p.prom"))
    jm.write(str(tmp_path / "j.json"), str(tmp_path / "j.prom"))
    for ext in ("json", "prom"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def _trace_report(package: str):
    if package == "jax":
        sys.path.insert(0, "scripts")
        try:
            import trace_report
        finally:
            sys.path.pop(0)
        return trace_report
    from libgrape_lite_tpu_torch.scripts import trace_report

    return trace_report


def _render(package, events) -> str:
    import io

    buf = io.StringIO()
    _trace_report(package).render(events, out=buf)
    return buf.getvalue()


def test_traces_load_and_render_in_both_packages(tmp_path, graph_cache):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    ptrace, jtrace = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    obs.configure(trace_path=ptrace)
    Worker(port_app("sssp"), port_fragment(4)).query(source=6)
    obs.flush()
    jobs.configure(trace_path=jtrace)
    JWorker(jax_app("sssp"), graph_cache(4)).query_stepwise(source=6)
    jobs.flush()
    for path in (ptrace, jtrace):
        p_events, j_events = obs.load_trace(path), jobs.load_trace(path)
        assert p_events == j_events
        # the JSONL twin holds the same records
        twin = path[:-len(".json")] + ".jsonl"
        assert [e for e in obs.load_trace(twin) if e["ph"] != "M"] == \
            [e for e in j_events if e["ph"] != "M"]
        assert obs.rollup(p_events) == jobs.rollup(j_events)
        p_out, j_out = _render("port", p_events), _render("jax", j_events)
        assert p_out == j_out
        assert "superstep table" in p_out and "phase rollup" in p_out
        rounds = [e["args"]["round"] for e in p_events if e["ph"] == "X"
                  and e["name"] == "superstep" and e["tid"] < FRAG_TID_BASE]
        for r in rounds:
            assert f"\n{r:>5} superstep" in p_out
    assert shape(obs.load_trace(ptrace)) == shape(jobs.load_trace(jtrace))


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_armed_results_bit_equal_to_disarmed(app):
    frag = port_fragment(4)
    plain = Worker(port_app(app), frag)
    plain.query(**QUERY[app])
    obs.configure(in_memory=True)
    armed = Worker(port_app(app), frag)
    armed.query(**QUERY[app])
    assert armed.rounds == plain.rounds
    assert np.array_equal(armed.result_values(), plain.result_values())


def test_trace_report_main_prints_the_table(tmp_path, capsys):
    trace = str(tmp_path / "t.json")
    obs.configure(trace_path=trace)
    w = Worker(port_app("sssp"), port_fragment(1))
    w.query(source=6)
    obs.flush()
    from libgrape_lite_tpu_torch.scripts.trace_report import main

    assert main([trace]) == 0
    out = capsys.readouterr().out
    for r in range(1, w.rounds + 1):
        assert f"\n{r:>5} superstep" in out
    assert "    0     peval" in out


# ---- tracer core (tests/test_obs.py counterparts) --------------------------


def test_span_nesting_and_ordering():
    tr = obs.configure(in_memory=True)
    with tr.span("outer", a=1):
        with tr.span("inner1"):
            time.sleep(0.001)
        with tr.span("inner2"):
            time.sleep(0.001)
    evs = [e for e in tr.events() if e["ph"] == "X"]
    assert [e["name"] for e in evs] == ["inner1", "inner2", "outer"]
    outer = evs[2]
    for child in evs[:2]:
        assert outer["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert evs[0]["ts"] + evs[0]["dur"] <= evs[1]["ts"]
    assert outer["args"] == {"a": 1}


def test_span_mark_dispatch_device_split():
    tr = obs.configure(in_memory=True)
    with tr.span("superstep") as sp:
        time.sleep(0.002)
        sp.mark("dispatched")
        time.sleep(0.004)
    args = [e for e in tr.events() if e["ph"] == "X"][0]["args"]
    assert args["dispatched_us"] >= 2000
    assert args["device_wait_us"] >= 4000


def test_span_records_the_error_of_a_raise():
    tr = obs.configure(in_memory=True)
    with pytest.raises(KeyError):
        with tr.span("superstep"):
            raise KeyError("x")
    assert tr.events()[-1]["args"] == {"error": "KeyError"}


def test_chrome_trace_schema_and_jsonl_twin(tmp_path):
    trace = str(tmp_path / "t.json")
    tr = obs.configure(trace_path=trace)
    with tr.span("query", mode="test"):
        pass
    tr.instant("ping")
    tr.counter("active", value=3)
    out = obs.flush()
    assert out["trace"] == trace
    doc = json.load(open(trace))
    assert doc["traceEvents"]
    assert doc["metadata"]["trace_id"] == obs.trace_id()
    assert doc["metadata"]["producer"] == "libgrape-lite-tpu obs/"
    for ev in doc["traceEvents"]:
        for key in CHROME_REQUIRED:
            assert key in ev, f"{ev} missing {key}"
    lines = [json.loads(ln) for ln in open(out["jsonl"])]
    assert {e["name"] for e in lines} >= {"query", "ping", "active"}
    assert {e["name"] for e in obs.load_trace(trace)} == {
        e["name"] for e in doc["traceEvents"]}


def test_disabled_span_overhead_budget():
    """The disarmed span is the shared no-op and costs about what a bare
    no-op context manager costs: the round loop calls it every round, so
    this is the tax on every untraced query.  Timed in batches
    interleaved with the bare context manager in this process, and
    bounded by the ratio of the two best batches, so a loaded host slows
    both alike."""
    from libgrape_lite_tpu_torch.obs.tracer import NULL_SPAN

    tr = obs.tracer()
    assert not tr.enabled
    assert tr.span("superstep") is NULL_SPAN

    class Bare:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    bare = Bare()
    n = 20_000

    def span_batch():
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("superstep"):
                pass
        return time.perf_counter() - t0

    def bare_batch():
        t0 = time.perf_counter()
        for _ in range(n):
            with bare:
                pass
        return time.perf_counter() - t0

    best_span = best_bare = float("inf")
    for _ in range(7):
        best_span = min(best_span, span_batch())
        best_bare = min(best_bare, bare_batch())
    ratio = best_span / best_bare
    assert ratio < 3.0, (
        f"disabled span costs {ratio:.2f}x a bare no-op context manager "
        f"({best_span / n * 1e9:.0f}ns vs {best_bare / n * 1e9:.0f}ns)")


def test_disabled_surface_is_inert():
    tr = obs.tracer()
    sp = tr.span("x", round=1)
    sp.mark("dispatched")
    sp.set(active=3)
    sp.close()
    tr.instant("i")
    tr.counter("c", v=1)
    tr.emit_span_raw("y", t0_ns=0, dur_ns=1, tid=0)
    assert tr.events() == [] and obs.history() == []
    assert obs.trace_id() is None and not obs.armed()
    m = obs.metrics()
    m.counter("x").inc()
    m.histogram("y").observe(1.0)
    m.series("z").append(1)
    assert m.snapshot() == {} and m.to_prometheus_text() == ""
    assert obs.flush()["events"] == 0


def test_env_arms_lazily(monkeypatch, tmp_path):
    monkeypatch.setenv(obs.TRACE_ENV, str(tmp_path / "e.json"))
    monkeypatch.setenv(obs.METRICS_ENV, str(tmp_path / "m"))
    obs.reset()
    assert obs.armed()
    obs.metrics().counter("grape_queries_total").inc()
    out = obs.flush()
    assert out["trace"] == str(tmp_path / "e.json")
    assert json.load(open(tmp_path / "m.json"))["grape_queries_total"][
        "value"] == 1


def test_metrics_prometheus_and_json():
    obs.configure(in_memory=True)
    m = obs.metrics()
    m.counter("grape_retry_attempts_total", help="retries").inc(2)
    m.gauge("grape_query_rounds").set(7)
    h = m.histogram("grape_checkpoint_save_seconds")
    h.observe(0.003)
    h.observe(0.2)
    snap = m.snapshot()
    assert snap["grape_retry_attempts_total"]["value"] == 2
    assert snap["grape_checkpoint_save_seconds"]["count"] == 2
    text = m.to_prometheus_text()
    assert "# TYPE grape_retry_attempts_total counter" in text
    assert 'grape_checkpoint_save_seconds_bucket{le="+Inf"} 2' in text
    with pytest.raises(TypeError, match="already registered"):
        m.gauge("grape_retry_attempts_total")


def test_metrics_flush_creates_missing_directory(tmp_path):
    mp = str(tmp_path / "deep" / "nested" / "metrics")
    obs.configure(metrics_path=mp)
    obs.metrics().counter("grape_queries_total").inc()
    assert obs.flush()["metrics"] == mp
    assert json.load(open(mp + ".json"))["grape_queries_total"][
        "value"] == 1


def test_metrics_only_arming_does_not_accumulate_history():
    from libgrape_lite_tpu_torch.obs import config as obs_config

    obs.configure(metrics_path=None, in_memory=False)
    tr = obs.tracer()
    for _ in range(10):
        with tr.span("superstep"):
            pass
    obs.flush()
    assert obs_config._state["chrome_history"] == []


def test_trace_report_keeps_replayed_rounds():
    from libgrape_lite_tpu_torch.scripts.trace_report import superstep_rows

    tr = obs.configure(in_memory=True)
    for rnd in (1, 2, 1, 2, 3):
        with tr.span("superstep", round=rnd) as sp:
            sp.set(active=rnd)
    assert [r["round"] for r in superstep_rows(obs.history())] == \
        [1, 2, 1, 2, 3]


def test_round_that_loads_a_library_is_marked_compiled():
    """A round during which a CUDA library is built or loaded carries
    `compiled_us`; the rounds around it do not."""
    from libgrape_lite_tpu_torch.ops import _build

    class LoadsInRound2(SSSP):
        def inceval(self, ctx, dev, state):
            self.calls = getattr(self, "calls", 0) + 1
            if self.calls == 2:
                _build.LOAD_EVENTS += 1  # what `_build.load` does
            return super().inceval(ctx, dev, state)

    obs.configure(in_memory=True)
    w = Worker(LoadsInRound2(dtype=torch.float64), port_fragment(1))
    w.query(source=6)
    steps = [e for e in obs.history() if e["ph"] == "X"
             and e["name"] in ("peval", "superstep")]
    compiled = [e["args"].get("round") for e in steps
                if "compiled_us" in e["args"]]
    assert compiled == [2]
    for e in steps:  # `dispatched` stays the last mark
        assert e["args"]["device_wait_us"] >= 0


def test_batched_query_span_and_supersteps():
    obs.configure(in_memory=True)
    w = Worker(SSSP(dtype=torch.float64), port_fragment(1))
    w.query_batch([{"source": 6}, {"source": 17}, {"source": 3}])
    q = [e for e in obs.history() if e.get("name") == "query"][-1]
    assert q["args"]["mode"] == "batched" and q["args"]["batch"] == 3
    assert q["args"]["lane_rounds"] == [int(r) for r in w.batch_rounds]
    snap = obs.metrics().snapshot()
    assert snap["grape_supersteps_total"]["value"] == \
        int(np.sum(w.batch_rounds)) + 3


def test_query_incremental_and_host_apps_trace():
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    obs.configure(in_memory=True)
    w = Worker(APP_REGISTRY["sssp_msg"](), port_fragment(1))
    w.query(source=6)
    q = [e for e in obs.history() if e.get("name") == "query"][-1]
    assert q["args"]["mode"] == "host" and q["args"]["app"] == "SSSPMsg"
    w2 = Worker(SSSP(dtype=torch.float64), port_fragment(1))
    prev = w2.query(source=6)
    w2.query_incremental(prev, None, source=6)
    inst = [e for e in obs.history() if e["ph"] == "i"]
    assert inst[-1]["name"] == "query_incremental"
    assert inst[-1]["args"]["mode"] == "cold"


# ---- logging ---------------------------------------------------------------


def test_vlog_lazy_formatting_skips_disabled_levels():
    from libgrape_lite_tpu_torch.utils import logging as glog

    class Explosive:
        def __str__(self):
            raise AssertionError("formatted a disabled log level")

    old = glog.vlog_level()
    try:
        glog.set_vlog_level(0)
        glog.vlog(1, "round %s", Explosive())
        glog.set_vlog_level(1)
        with pytest.raises(AssertionError, match="formatted"):
            glog.vlog(1, "round %s", Explosive())
    finally:
        glog.set_vlog_level(old)


def test_log_rank_prefix_and_tracer_sink(capsys):
    from libgrape_lite_tpu_torch.utils import logging as glog

    tr = obs.configure(in_memory=True)
    glog.log_info("hello %d", 42)
    assert "[grape-tpu r0] hello 42" in capsys.readouterr().err
    logs = [e for e in tr.events() if e.get("name") == "log"]
    assert logs and "hello 42" in logs[0]["args"]["msg"]


def test_set_vlog_level_thread_safe():
    import threading

    from libgrape_lite_tpu_torch.utils import logging as glog

    old = glog.vlog_level()
    try:
        threads = [threading.Thread(target=glog.set_vlog_level,
                                    args=(i % 3,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert glog.vlog_level() in (0, 1, 2)
    finally:
        glog.set_vlog_level(old)


# ---- run_app --trace / --metrics / --profile -------------------------------


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_run_app_trace_metrics_profile(tmp_path, capsys, app):
    from libgrape_lite_tpu_torch.cli import main
    from libgrape_lite_tpu_torch.utils import logging as glog

    plain, armed = tmp_path / "plain", tmp_path / "armed"
    base = ["--application", app, "--efile", P2P[0], "--vfile", P2P[1],
            "--sssp_source", "6", "--fnum", "2", "--device", "cpu"]
    assert main(base + ["--out_prefix", str(plain)]) == 0
    old = glog.vlog_level()
    try:
        assert main(base + ["--out_prefix", str(armed), "--trace",
                            str(tmp_path / "t.json"), "--metrics",
                            str(tmp_path / "m"), "--profile"]) == 0
    finally:
        glog.set_vlog_level(old)
    for f in ("result_frag_0", "result_frag_1"):
        assert (armed / f).read_bytes() == (plain / f).read_bytes()
    err = capsys.readouterr().err
    assert "PEval: " in err and "IncEval round 1: " in err
    assert "obs: trace -> " in err and "obs: metrics -> " in err
    events = obs.load_trace(str(tmp_path / "t.json"))
    names = [e["name"] for e in events if e["ph"] == "X"
             and e["tid"] < FRAG_TID_BASE]
    snap = json.load(open(tmp_path / "m.json"))
    rounds = snap["grape_query_rounds"]["value"]
    assert names[:4] == ["read_edges", "partition", "build_fragment",
                         "load_graph"]
    assert names[4:] == ["peval"] + ["superstep"] * rounds + ["query"]
    assert snap["grape_supersteps_total"]["value"] == rounds + 1
    assert len(snap["grape_active_per_round"]["values"]) == rounds + 1
    assert "grape_graph_edges 147892" in open(tmp_path / "m.prom").read()
    # the profile's vlog lines ride the trace as `log` instants
    assert any(e["name"] == "log" and "IncEval round" in e["args"]["msg"]
               for e in events if e["ph"] == "i")
