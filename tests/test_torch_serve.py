"""The port's serving runtime (`libgrape_lite_tpu_torch/serve/`) on the
CPU: the non-guard, non-obs cases of tests/test_serve.py, held against
the JAX package's ServeSession and CLI where a result is compared.

* a coalesced session returns, lane for lane, the JAX session's bytes
  and the port's own sequential queries (sssp, bfs, personalized
  pagerank within 1e-10 of JAX); host-only apps fall back to sequential
  queries; unknown apps fail as results without wedging the queue;
  personalized and global PageRank never coalesce;
* the queue policy: FIFO per class, max_rounds apart, max_wait holds a
  partial batch, a full batch ships at once, priorities, deadlines;
* a session's second query builds no worker and no plan (`cache_stats`,
  the port's counterpart of the JAX compile check); eviction and
  re-admission; live ingest through the session;
* the `serve` CLI: a scripted stream whose --dump_results equal the JAX
  CLI's, an empty stream, a delta stream, `--guard` (its subsystem not
  ported) a usage error naming its ROADMAP item, and the obs/ flags
  working with the disarmed run's dumps.
"""

import json

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.serve import BatchPolicy as JBatchPolicy
from libgrape_lite_tpu.serve import ServeSession as JServeSession
from libgrape_lite_tpu_torch.models import APP_REGISTRY, SSSP, PageRank
from libgrape_lite_tpu_torch.models.sssp_msg import SSSPMsg
from libgrape_lite_tpu_torch.serve import (
    AdmissionQueue,
    ArrivalFeeder,
    BatchPolicy,
    ServeResult,
    ServeSession,
)
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_dyn import ADDS
from tests.test_torch_dyn import build_graph
from tests.test_torch_lanes import SOURCES, port_fragment

torch.set_num_threads(1)


class SSSP64(SSSP):
    def __init__(self):
        super().__init__(dtype=torch.float64)


class PageRank64(PageRank):
    def __init__(self):
        super().__init__(dtype=torch.float64)


class StrictPageRank64(PageRank):
    def __init__(self):
        super().__init__(spmv_mode="strict", dtype=torch.float64)


class SSSPMsg64(SSSPMsg):
    def __init__(self):
        super().__init__(dtype=torch.float64)


def port_apps() -> dict:
    """The registry with the JAX package's float64 state where a class
    takes a dtype (the JAX tests' x64)."""
    return dict(APP_REGISTRY, sssp=SSSP64, pagerank=PageRank64,
                sssp_msg=SSSPMsg64)


def session(frag=None, **kw):
    return ServeSession(port_fragment(2) if frag is None else frag,
                        apps=port_apps(), **kw)


def jax_results(graph_cache, stream, max_batch=4):
    sess = JServeSession(graph_cache(2),
                         policy=JBatchPolicy(max_batch=max_batch))
    return sess.serve(stream)


def sequential(name, args):
    w = Worker(port_apps()[name](), port_fragment(2))
    w.query(**args)
    return w.result_values(), w.rounds


# ---- sessions against the JAX session ------------------------------------

@pytest.mark.parametrize("name", ["sssp", "bfs"])
def test_session_lanes_byte_identical_to_jax_and_sequential(graph_cache,
                                                            name):
    stream = [(name, {"source": s}) for s in SOURCES]
    want = jax_results(graph_cache, stream)
    sess = session(policy=BatchPolicy(max_batch=4))
    got = sess.serve(stream)
    assert sess.queue.batch_hist == {4: 1}
    assert len(set(r.rounds for r in got)) >= 3  # ragged lanes
    for (_, args), r, j in zip(stream, got, want):
        assert r.ok and r.batch_size == 4
        assert r.rounds == j.rounds
        assert r.values.tobytes() == j.values.tobytes()
        vals, rounds = sequential(name, args)
        assert r.values.tobytes() == vals.tobytes() and r.rounds == rounds


def test_session_coalesced_results_match_jax(graph_cache):
    sources = [6, 17, 3, 42, 11, 12, 13, 14]
    stream = [("sssp", {"source": s}) for s in sources]
    want = jax_results(graph_cache, stream)
    sess = session(policy=BatchPolicy(max_batch=4))
    reqs = [sess.submit(*item) for item in stream]
    results = sess.drain()
    assert len(results) == len(sources)
    assert sess.queue.batch_hist == {4: 2}
    for req, j in zip(reqs, want):
        assert req.done and req.result.ok and req.result.batch_size == 4
        assert req.result.values.tobytes() == j.values.tobytes()


def test_session_ppr_lanes_match_jax(graph_cache):
    sources = [6, 5229, 999999]
    stream = [("pagerank", {"source": s}) for s in sources]
    want = jax_results(graph_cache, stream)
    got = session(policy=BatchPolicy(max_batch=4)).serve(stream)
    for (_, args), r, j in zip(stream, got, want):
        assert r.ok and r.batch_size == 3
        np.testing.assert_allclose(r.values, j.values, rtol=1e-10, atol=0)
        assert r.values.tobytes() == sequential("pagerank", args)[0].tobytes()
    assert float(got[-1].values.sum()) == 0.0  # the absent seed


def test_ppr_and_global_pagerank_do_not_coalesce(graph_cache):
    sess = session(policy=BatchPolicy(max_batch=4))
    ppr = sess.submit("pagerank", {"source": 6})
    glob = sess.submit("pagerank", {})
    sess.drain()
    assert ppr.result.ok and glob.result.ok
    assert ppr.result.batch_size == 1 and glob.result.batch_size == 1
    want = jax_results(graph_cache, [("pagerank", {}),
                                     ("pagerank", {"source": 6})])
    np.testing.assert_allclose(glob.result.values, want[0].values,
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(ppr.result.values, want[1].values,
                               rtol=1e-10, atol=0)


def test_session_sequential_fallback_for_host_only(graph_cache):
    stream = [("sssp_msg", {"source": 6}), ("sssp_msg", {"source": 17})]
    want = jax_results(graph_cache, stream)
    sess = session(policy=BatchPolicy(max_batch=4))
    res = sess.serve(stream)
    assert all(r.ok for r in res)
    assert sess.queue.batch_hist == {1: 2}  # no lane key: never coalesce
    for r, j in zip(res, want):
        assert r.values.tobytes() == j.values.tobytes()
    # identical arguments coalesce, and the batch falls back
    res2 = sess.serve([("sssp_msg", {"source": 6})] * 2)
    assert all(r.ok for r in res2)
    assert sess.stats["sequential_fallbacks"] == 1
    assert all(r.values.tobytes() == want[0].values.tobytes() for r in res2)


def test_unknown_app_request_fails_without_wedging_queue(graph_cache):
    sess = session()
    bad = sess.submit("not_an_app", {"source": 1})
    good = sess.submit("sssp", {"source": 6})
    res = sess.drain()
    assert len(res) == 2 and sess.queue.pending() == 0
    assert bad.done and not bad.result.ok
    assert "unknown application" in bad.result.error["error"]
    want = jax_results(graph_cache, [("sssp", {"source": 6})])
    assert good.result.ok
    assert good.result.values.tobytes() == want[0].values.tobytes()


def test_session_unknown_app_rejected():
    sess = ServeSession(port_fragment(1), apps={})
    with pytest.raises(ValueError, match="unknown application"):
        sess.worker("sssp")


def test_session_refuses_guard_policies():
    """Guard policies are served (tests/test_torch_guarded_serve.py); an
    unknown one is refused at the door, the session's and a request's."""
    with pytest.raises(ValueError, match="unknown guard policy"):
        ServeSession(port_fragment(1), guard="panic")
    sess = ServeSession(port_fragment(1), guard="halt")
    with pytest.raises(ValueError, match="unknown guard policy"):
        sess.submit("sssp", {"source": 6}, guard="sometimes")
    assert sess.submit("sssp", {"source": 6}, guard="rollback").app_key


# ---- caches, eviction, ingest --------------------------------------------

def test_session_second_query_builds_no_worker_and_no_plan():
    """The port's counterpart of the JAX compile check: after the first
    query warms a session, a second one of the same app reuses the
    resident worker and the cached strict plan."""
    sess = ServeSession(build_graph(1), apps={"pagerank": StrictPageRank64},
                        policy=BatchPolicy(max_batch=1))
    r1 = sess.serve([("pagerank", {"source": 6})])
    assert r1[0].ok, r1[0].error
    s1 = sess.cache_stats()
    assert s1["runner"] == {"hits": 0, "misses": 1}
    r2 = sess.serve([("pagerank", {"source": 17})])
    assert r2[0].ok
    s2 = sess.cache_stats()
    assert s2["runner"] == {"hits": 1, "misses": 1}
    assert s2["pack"]["planned"] == s1["pack"]["planned"]
    assert s2["pack"]["frag_cache_hits"] > s1["pack"]["frag_cache_hits"]
    assert r1[0].values.tobytes() != r2[0].values.tobytes()


def test_release_and_restore_device():
    frag = build_graph(2)
    sess = ServeSession(frag, apps=port_apps())
    want = sess.serve([("bfs", {"source": 3})])[0].values
    assert sess.resident
    assert sess.release_device() == {"fragment_released": True,
                                     "workers": 1}
    assert not sess.resident and frag.dev is None
    assert sess.restore_device() and not sess.restore_device()
    again = sess.serve([("bfs", {"source": 3})])[0]
    assert again.values.tobytes() == want.tobytes()
    assert sess.cache_stats()["runner"]["misses"] == 1
    sess.close()
    sess.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit("bfs", {"source": 3})


def test_session_ingest_rides_the_overlay_and_matches_jax():
    from libgrape_lite_tpu.dyn import RepackPolicy as JRepackPolicy
    from tests.test_dyn import build_graph as jbuild_graph

    from libgrape_lite_tpu_torch.dyn import RepackPolicy

    stream = [("sssp", {"source": s}) for s in [0, 5, 9, 13]]
    jsess = JServeSession(jbuild_graph(2), policy=JBatchPolicy(max_batch=4),
                          dyn=JRepackPolicy(threshold=0.9, capacity=64))
    jsess.ingest(ADDS)
    want = jsess.serve(stream)
    # float32 edata: the JAX SSSP runs in float32 here, as the port's
    sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=4),
                        dyn=RepackPolicy(threshold=0.9, capacity=64))
    assert sess.ingest(ADDS)["mode"] == "overlay"
    got = sess.serve(stream)
    assert sess.stats["overlay_applies"] == 1 and sess.stats["repacks"] == 0
    assert sess.stats["ingested_ops"] == len(ADDS)
    for r, j in zip(got, want):
        assert r.ok and r.rounds == j.rounds
        assert r.values.tobytes() == j.values.tobytes()


def test_session_forced_repack_for_uncontracted_app():
    from libgrape_lite_tpu_torch.dyn import RepackPolicy

    sess = ServeSession(build_graph(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=1),
                        dyn=RepackPolicy(threshold=0.9, capacity=64))
    assert sess.ingest(ADDS)["mode"] == "overlay"
    res = sess.serve([("pagerank", {})])
    assert res[0].ok, res[0].error
    assert sess.stats["forced_repacks"] == 1
    assert sess.dyn.overlay_count == 0
    assert sess.fragment is sess.dyn.fragment


def test_session_failed_forced_repack_yields_error_results():
    from libgrape_lite_tpu_torch.dyn import RepackPolicy

    frag = build_graph(2)
    frag.edge_list = None  # as if loaded without retain_edge_list
    sess = ServeSession(frag, apps=port_apps(),
                        policy=BatchPolicy(max_batch=1),
                        dyn=RepackPolicy(threshold=0.9, capacity=64))
    assert sess.ingest(ADDS)["mode"] == "overlay"
    bad = sess.submit("pagerank", {})
    good = sess.submit("sssp", {"source": 0})
    assert len(sess.drain()) == 2
    assert not bad.result.ok and good.result.ok


def test_session_without_dyn_rejects_ingest():
    with pytest.raises(RuntimeError, match="without dyn="):
        ServeSession(port_fragment(1)).ingest([("a", 1, 2, 0.5)])


# ---- the admission queue --------------------------------------------------

def _stub_queue(policy):
    batches = []

    def dispatch(batch):
        batches.append([r.id for r in batch])
        return [ServeResult(request_id=r.id, app_key=r.app_key, ok=True,
                            lane=b, batch_size=len(batch))
                for b, r in enumerate(batch)]

    return AdmissionQueue(dispatch, policy), batches


def test_queue_coalesces_compatible_fifo():
    q, batches = _stub_queue(BatchPolicy(max_batch=4))
    ids = [q.submit(app, {"source": i}).id for i, app in enumerate(
        ["sssp", "sssp", "bfs", "sssp", "sssp", "sssp"])]
    q.drain()
    assert batches == [[ids[0], ids[1], ids[3], ids[4]], [ids[2]], [ids[5]]]
    assert q.batch_hist == {4: 1, 1: 2}
    assert q.completed == 6


def test_queue_max_rounds_never_coalesces():
    q, batches = _stub_queue(BatchPolicy(max_batch=8))
    a = q.submit("sssp", {"source": 1})
    b = q.submit("sssp", {"source": 2}, max_rounds=5)
    c = q.submit("sssp", {"source": 3})
    q.drain()
    assert batches == [[a.id, c.id], [b.id]]


def test_queue_max_wait_holds_partial_batches():
    q, batches = _stub_queue(BatchPolicy(max_batch=4, max_wait_s=60.0))
    r = q.submit("sssp", {"source": 1})
    q.submit("sssp", {"source": 2})
    assert q.pump() == [] and q.pending() == 2
    out = q.pump(now=r.submitted_s + 61.0)
    assert len(out) == 2 and batches == [[r.id, out[1].request_id]]


def test_queue_full_batch_ships_immediately():
    q, _ = _stub_queue(BatchPolicy(max_batch=2, max_wait_s=60.0))
    q.submit("sssp", {"source": 1})
    q.submit("sssp", {"source": 2})
    assert len(q.pump()) == 2


def test_queue_serves_priority_first_and_fails_expired_deadlines():
    q, batches = _stub_queue(BatchPolicy(max_batch=4))
    low = q.submit("sssp", {"source": 1})
    high = q.submit("sssp", {"source": 2}, priority=5)
    late = q.submit("sssp", {"source": 3}, deadline_s=1.0)
    out = q.pump(now=late.submitted_s + 2.0, force=True)
    assert late.done and not late.result.ok
    assert late.result.error["reason"] == "deadline_expired"
    assert batches == [[high.id]] and q.expired == 1
    assert [r.request_id for r in out] == [late.id, high.id]
    q.drain()
    assert batches[-1] == [low.id]


def test_policy_validates_its_knobs():
    for bad in ({"max_batch": 0}, {"max_wait_s": -1}, {"inflight": 0}):
        with pytest.raises(ValueError):
            BatchPolicy(**bad)


# ---- the arrival feeder ---------------------------------------------------

def test_rate_specs_and_offsets_match_jax():
    from libgrape_lite_tpu.serve.feeder import arrival_offsets as jo
    from libgrape_lite_tpu.serve.feeder import parse_rate_spec as jp

    from libgrape_lite_tpu_torch.serve.feeder import (
        arrival_offsets,
        parse_rate_spec,
    )

    for spec in (50, "50", "50:2x@100", "50:2x@100:0.5x@300"):
        assert parse_rate_spec(spec) == jp(spec)
        base, steps = parse_rate_spec(spec)
        assert arrival_offsets(400, base, steps) == jo(400, base, steps)
    for bad in ("0", "50:2@100", "50:2x@0", "50:2x@100:3x@50", "50:-1x@5"):
        with pytest.raises(ValueError):
            parse_rate_spec(bad)


def test_arrival_feeder_serves_the_stream():
    stream = [("bfs", {"source": s}) for s in [6, 17, 3, 42, 11, 12]]
    want = session(policy=BatchPolicy(max_batch=4)).serve(stream)
    sess = session(policy=BatchPolicy(max_batch=4, max_wait_s=0.01))
    feeder = ArrivalFeeder(sess.submit, stream, 2000.0)
    assert feeder.rate_qps == 2000.0
    feeder.start()
    while feeder.is_alive() or sess.queue.pending():
        sess.pump()
    feeder.join()
    sess.drain()
    assert feeder.submitted == len(stream)
    for req, w in zip(feeder.requests, want):
        assert req.result.ok
        assert req.result.values.tobytes() == w.values.tobytes()


# ---- the serve CLI --------------------------------------------------------

def _summary(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


P2P = ["--efile", dataset_path("p2p-31.e"), "--vfile", dataset_path("p2p-31.v")]


def test_cli_serve_scripted_stream_matches_jax_cli(capsys, tmp_path):
    from libgrape_lite_tpu.cli import serve_main as jserve_main

    from libgrape_lite_tpu_torch.cli import main

    args = [*P2P, "--fnum", "2", "--application", "bfs", "--sources",
            "6,17,3,42,11,12", "--max_batch", "4"]
    jserve_main([*args, "--dump_results", str(tmp_path / "jax.txt")])
    capsys.readouterr()
    assert main(["serve", *args, "--dump_results", str(tmp_path / "pt.txt"),
                 "--device", "cpu"]) == 0
    rec = _summary(capsys.readouterr().out)
    assert rec["queries"] == 6 and rec["failed"] == 0
    assert rec["batch_hist"] == {"4": 1, "2": 1}
    assert rec["apps"] == {"bfs": 6}
    assert rec["cache"]["runner"]["misses"] >= 1
    assert rec["device"] == "cpu"
    assert ((tmp_path / "pt.txt").read_text()
            == (tmp_path / "jax.txt").read_text())


def test_cli_serve_empty_stream_is_a_usage_error(tmp_path):
    from libgrape_lite_tpu_torch.cli import serve_main

    stream = tmp_path / "empty.txt"
    stream.write_text("# only comments\n")
    with pytest.raises(SystemExit, match="empty"):
        serve_main(["--efile", dataset_path("p2p-31.e"), "--stream",
                    str(stream), "--device", "cpu"])


def test_cli_serve_delta_stream(capsys, tmp_path):
    from libgrape_lite_tpu_torch.cli import serve_main

    stream = tmp_path / "stream.txt"
    stream.write_text("".join(f"sssp {6 + i}\n" for i in range(12)))
    delta = tmp_path / "delta.txt"
    delta.write_text("".join(f"a 6 {100 + i} 0.5\n" for i in range(10)))
    serve_main([*P2P, "--fnum", "2", "--max_batch", "4", "--stream",
                str(stream), "--delta_stream", str(delta), "--ingest_every",
                "4", "--dyn_repack_ratio", "0.5", "--device", "cpu"])
    rec = _summary(capsys.readouterr().out)
    assert rec["queries"] == 12 and rec["failed"] == 0
    assert rec["dyn"]["ingested"] == 10
    assert rec["dyn"]["overlay_applies"] >= 1
    assert rec["dyn"]["repack_count"] == 0
    assert rec["dyn"]["queries_ok"] == 12 and rec["dyn"]["updates_per_s"] > 0


@pytest.mark.parametrize("flag,value,item", [
    ("--guard", "halt", 6), ("--trace", "t.json", 6),
    ("--metrics", "m.txt", 6), ("--metrics_port", "0", 6),
])
def test_cli_serve_unported_flags_are_usage_errors(capsys, tmp_path,
                                                   monkeypatch, flag, value,
                                                   item):
    """Each flag was a usage error naming its ROADMAP item until its
    subsystem was ported: now each works -- `--guard halt` guards the
    batches, the obs/ flags' file or endpoint exists -- and the run's
    --dump_results equal the disarmed run's (an unknown guard policy is
    still a usage error)."""
    import urllib.request

    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.cli import serve_main
    from libgrape_lite_tpu_torch.obs import exporter

    argv = [*P2P, "--num_queries", "2", "--device", "cpu"]
    if flag == "--guard":
        with pytest.raises(SystemExit) as exc:
            serve_main(argv + [flag, "panic"])
        assert exc.value.code == 2 and flag in capsys.readouterr().err
    monkeypatch.chdir(tmp_path)
    assert serve_main(argv + ["--dump_results", "plain.txt"]) == 0
    try:
        assert serve_main(argv + [flag, value, "--dump_results",
                                  "armed.txt"]) == 0
        if flag == "--trace":
            rows = [e for e in obs.load_trace("t.json")
                    if e["ph"] == "X" and e["name"] == "serve_query"]
            assert sorted(e["args"]["lane"] for e in rows) == [0, 1]
        elif flag == "--metrics":
            snap = json.loads((tmp_path / "m.txt.json").read_text())
            assert snap["grape_serve_admission_wait_seconds"]["count"] == 2
            assert (tmp_path / "m.txt.prom").exists()
        elif flag == "--metrics_port":
            exp = exporter.get_exporter()
            assert exp is not None and exp.port > 0
            assert f"[serve] metrics exporter: {exp.url}" in \
                capsys.readouterr().err
            text = urllib.request.urlopen(exp.url + "/metrics",
                                          timeout=10).read().decode()
            assert 'grape_stats_registry{namespace="pump"} 1' in text
    finally:
        exporter.stop_exporter()
        obs.reset()
    assert (tmp_path / "armed.txt").read_text() == \
        (tmp_path / "plain.txt").read_text()
