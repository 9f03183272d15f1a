"""The port's async serving pump (`serve/pipeline.py`) on the CPU: the
non-guard, non-obs cases of tests/test_serve_async.py.

* at W = 1 and W = 4 the pump returns the synchronous loop's results,
  byte for byte and in order -- batched, single, sequential-fallback and
  unknown-app batches, and batches running concurrently in their own
  threads (launch cap 4); with live ingest too, where the results also
  equal the JAX pump's;
* `ingest` is a window barrier, also when called on the session; a full
  window does not starve a waiting batch; forced partial batches drain;
  a failed launch, or a failure inside a running batch, fails only its
  batch; the window genuinely overlaps (`max_inflight` > 1,
  `overlapped_harvests` >= 1);
* deferred values resolve once and lazily; the queue records admission
  waits; picking a batch builds no worker; PUMP_STATS records every
  engage and decline, the GRAPE_SERVE_INFLIGHT override included; the
  CLI's --inflight runs the pump; launch counts stay exact under
  threads.
"""

import json

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch.dyn import RepackPolicy
from libgrape_lite_tpu_torch.serve import (
    PUMP_STATS,
    BatchPolicy,
    ServeResult,
    ServeSession,
)
from libgrape_lite_tpu_torch.worker import worker as worker_mod
from tests.conftest import dataset_path
from tests.test_dyn import ADDS
from tests.test_torch_dyn import build_graph
from tests.test_torch_lanes import SOURCES, port_fragment
from tests.test_torch_serve import port_apps

torch.set_num_threads(1)


def _pump_serve(stream, *, window, policy=None, frag=None, launch_cap=None):
    sess = ServeSession(port_fragment(2) if frag is None else frag,
                        apps=port_apps(),
                        policy=policy or BatchPolicy(max_batch=4))
    pump = sess.async_pump(window=window)
    if launch_cap is not None:
        pump.launch_cap = launch_cap
    for app_key, args in stream:
        sess.submit(app_key, args)
    return sess, pump.drain()


def _sync_serve(stream, *, policy=None, frag=None):
    sess = ServeSession(port_fragment(2) if frag is None else frag,
                        apps=port_apps(),
                        policy=policy or BatchPolicy(max_batch=4))
    return sess, sess.serve(stream)


def _assert_identical(res_sync, res_pump):
    assert len(res_sync) == len(res_pump)
    for a, b in zip(res_sync, res_pump):
        assert a.app_key == b.app_key
        assert a.ok == b.ok, (a.error, b.error)
        assert a.rounds == b.rounds and a.batch_size == b.batch_size
        if a.ok:
            assert a.values.tobytes() == b.values.tobytes(), (
                f"pump diverged from the sync loop for {a.app_key}")


# ---- identity with the synchronous loop ----------------------------------

@pytest.mark.parametrize("window", [1, 4])
def test_pump_batched_identical_to_sync(window):
    stream = [("sssp", {"source": s}) for s in [6, 17, 3, 42, 11, 12]]
    s0, r0 = _sync_serve(stream)
    s1, r1 = _pump_serve(stream, window=window)
    _assert_identical(r0, r1)
    assert s1.queue.batch_hist == s0.queue.batch_hist


def test_pump_concurrent_batches_identical_to_sync():
    """Four batches of three apps running at once, each in its thread."""
    stream = ([("sssp", {"source": s}) for s in [6, 17, 3, 42]]
              + [("bfs", {"source": s}) for s in SOURCES]
              + [("pagerank", {"source": s}) for s in [6, 17]]
              + [("sssp", {"source": s}) for s in [11, 12]])
    _, r0 = _sync_serve(stream)
    s1, r1 = _pump_serve(stream, window=4, launch_cap=4)
    _assert_identical(r0, r1)
    assert s1._pump.stats["max_inflight"] == 4


def test_pump_sequential_fallback_declined_and_identical():
    stream = [("sssp_msg", {"source": 6}), ("sssp_msg", {"source": 6})]
    _, r0 = _sync_serve(stream)
    PUMP_STATS.reset()
    s1, r1 = _pump_serve(stream, window=4)
    _assert_identical(r0, r1)
    assert s1.stats["sequential_fallbacks"] == 1
    assert PUMP_STATS.snapshot()["declines"]["sequential_fallback"] >= 1


def test_pump_unknown_app_fails_without_wedging():
    stream = [("not_an_app", {"source": 1}), ("sssp", {"source": 6})]
    _, r0 = _sync_serve(stream)
    _, r1 = _pump_serve(stream, window=4)
    _assert_identical(r0, r1)
    assert not r1[0].ok and "unknown application" in r1[0].error["error"]
    assert r1[1].ok
    assert PUMP_STATS.snapshot()["declines"].get("unknown_app", 0) >= 1


def test_pump_single_query_identical_to_sync():
    """A 1-lane batch rides the window as a batch of one lane, equal to
    the sync loop's plain Worker.query."""
    stream = [("sssp", {"source": 6}), ("bfs", {"source": 17}),
              ("common_neighbors", {"source": 6}), ("wcc", {})]
    policy = BatchPolicy(max_batch=1)
    _, r0 = _sync_serve(stream, policy=policy)
    _, r1 = _pump_serve(stream, window=2, policy=policy)
    _assert_identical(r0, r1)


# ---- ingest under the pump -----------------------------------------------

def _dyn_run(window, lib="port"):
    """Queries, an ingest, the same queries; sync (window None) or
    pumped; the port's session or, with lib="jax", the JAX package's."""
    if lib == "jax":
        from libgrape_lite_tpu.dyn import RepackPolicy as JRepackPolicy
        from libgrape_lite_tpu.serve import BatchPolicy as JBatchPolicy
        from libgrape_lite_tpu.serve import ServeSession as JServeSession
        from tests.test_dyn import build_graph as jbuild_graph

        sess = JServeSession(jbuild_graph(2),
                             policy=JBatchPolicy(max_batch=4),
                             dyn=JRepackPolicy(capacity=4096))
    else:
        sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=4),
                            dyn=RepackPolicy(capacity=4096))
    pump = sess.async_pump(window=window) if window else None
    out = []
    for s in [0, 5, 9, 13]:
        sess.submit("sssp", {"source": s})
    out += pump.drain() if pump else sess.drain()
    (pump.ingest if pump else sess.ingest)(ADDS)
    for s in [0, 5, 9, 13]:
        sess.submit("sssp", {"source": s})
    out += pump.drain() if pump else sess.drain()
    return sess, pump, out


def test_pump_dyn_ingest_identical_across_windows_and_to_jax():
    _, _, r0 = _dyn_run(None)
    _, _, r1 = _dyn_run(1)
    s4, _, r4 = _dyn_run(4)
    _, _, rj = _dyn_run(4, lib="jax")
    _assert_identical(r0, r1)
    _assert_identical(r0, r4)
    _assert_identical(rj, r4)
    assert s4.stats["overlay_applies"] >= 1 and s4.stats["repacks"] == 0


def test_pump_overlay_ingest_builds_no_worker_and_no_plan():
    """The port's counterpart of the JAX zero-recompile pin: a barrier
    ingest below the repack threshold, then warmed queries, reuse the
    resident worker and build no plan."""
    sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=4),
                        dyn=RepackPolicy(capacity=4096))
    pump = sess.async_pump(window=4)
    for s in [0, 5, 9, 13]:
        sess.submit("sssp", {"source": s})
    pump.drain()
    pump.ingest([("a", 0, 17, 0.01)])
    before = sess.cache_stats()
    pump.ingest([("a", 1, 18, 0.02)])
    for s in [0, 5, 9, 13]:
        sess.submit("sssp", {"source": s})
    assert all(r.ok for r in pump.drain())
    after = sess.cache_stats()
    assert after["runner"]["misses"] == before["runner"]["misses"]
    assert after["pack"]["planned"] == before["pack"]["planned"]
    assert sess.stats["repacks"] == 0


def test_pump_ingest_is_a_window_barrier():
    sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=2),
                        dyn=RepackPolicy(capacity=4096))
    pump = sess.async_pump(window=4)
    reqs = [sess.submit("sssp", {"source": s}) for s in [0, 5, 9, 13]]
    pump._fill(force=True)  # admit both batches, harvest nothing
    assert pump.inflight() == 2
    pump.ingest(ADDS)
    assert pump.inflight() == 0 and pump.stats["quiesces"] == 1
    assert all(r.done for r in reqs)  # the quiesce delivered them

    ref = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=2))
    ref_res = ref.serve([("sssp", {"source": s}) for s in [0, 5, 9, 13]])
    for got, want in zip([r.result for r in reqs], ref_res):
        assert got.values.tobytes() == want.values.tobytes()

    post = sess.submit("sssp", {"source": 0})
    pump.drain()
    ref2 = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=2),
                        dyn=RepackPolicy(capacity=4096))
    ref2.ingest(ADDS)
    want2 = ref2.serve([("sssp", {"source": 0})])[0]
    assert post.result.values.tobytes() == want2.values.tobytes()


def test_session_ingest_quiesces_attached_pump():
    sess = ServeSession(build_graph(2), policy=BatchPolicy(max_batch=2),
                        dyn=RepackPolicy(capacity=4096))
    pump = sess.async_pump(window=4)
    for s in [0, 5]:
        sess.submit("sssp", {"source": s})
    pump._fill(force=True)
    assert pump.inflight() == 1
    sess.ingest(ADDS)
    assert pump.inflight() == 0 and pump.stats["quiesces"] == 1


def test_pump_forced_repack_is_declined_after_a_quiesce():
    sess = ServeSession(build_graph(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4),
                        dyn=RepackPolicy(threshold=0.9, capacity=64))
    pump = sess.async_pump(window=4)
    sess.ingest(ADDS)
    PUMP_STATS.reset()
    sess.submit("sssp", {"source": 0})
    sess.submit("pagerank", {})
    res = pump.drain()
    assert all(r.ok for r in res)
    assert PUMP_STATS.snapshot()["declines"] == {"dyn_force_repack": 1}
    assert sess.stats["forced_repacks"] == 1


# ---- window mechanics -----------------------------------------------------

def test_pump_window_genuinely_overlaps():
    stream = [("sssp", {"source": 6 + i}) for i in range(16)]
    s1, r1 = _pump_serve(stream, window=4)
    assert all(r.ok for r in r1)
    assert s1._pump.stats["max_inflight"] > 1
    assert s1._pump.stats["overlapped_harvests"] >= 1


def test_pump_full_window_does_not_starve_waiting_batch():
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4, max_wait_s=60.0))
    pump = sess.async_pump(window=1)
    a = sess.submit("sssp", {"source": 6})
    sess.submit("sssp", {"source": 17})
    assert pump.pump() == []  # 2 < max_batch and the head is fresh
    assert sess.queue.pending() == 2 and pump.inflight() == 0
    pump.pump(now=a.submitted_s + 61.0)
    assert sess.queue.pending() == 0
    b = sess.submit("bfs", {"source": 6})
    c = sess.submit("bfs", {"source": 17})
    pump.pump(now=b.submitted_s + 61.0)
    pump.pump(now=c.submitted_s + 61.0)
    pump.drain()
    assert a.done and b.done and c.done
    assert all(r.result.ok for r in (a, b, c))


def test_pump_forced_partial_batches_drain():
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=8, max_wait_s=3600.0))
    pump = sess.async_pump(window=2)
    reqs = [sess.submit("sssp", {"source": s}) for s in [6, 17, 3]]
    assert pump.pump() == []  # held: partial and fresh
    res = pump.drain()
    assert len(res) == 3 and all(r.ok for r in res)
    assert sess.queue.batch_hist == {3: 1}
    assert all(r.done for r in reqs)


def test_launch_failure_fails_its_batch_only(monkeypatch):
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=2))
    pump = sess.async_pump(window=3)
    orig = worker_mod.PreparedBatch.launch
    calls = {"n": 0}

    def flaky(self):
        calls["n"] += 1
        if calls["n"] == 2:  # the second batch's launch blows up
            raise RuntimeError("synthetic launch failure")
        return orig(self)

    monkeypatch.setattr(worker_mod.PreparedBatch, "launch", flaky)
    a = [sess.submit("sssp", {"source": s}) for s in [6, 17]]
    b = [sess.submit("bfs", {"source": s}) for s in [6, 17]]
    c = [sess.submit("wcc", {})]
    assert len(pump.drain()) == 5
    assert all(r.result.ok for r in a + c)
    assert all(not r.result.ok for r in b)
    assert "synthetic launch failure" in b[0].result.error["error"]
    assert sess.stats["failed"] == 2


def test_failure_inside_a_running_batch_fails_its_batch_only(monkeypatch):
    """A batch whose round loop raises in its thread becomes per-lane
    error results at harvest; its neighbours in the window serve."""
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=2))
    pump = sess.async_pump(window=3)
    pump.launch_cap = 3
    orig = worker_mod.Worker.query_batch_prepare

    def poisoned(self, args_list, max_rounds=None):
        prepared = orig(self, args_list, max_rounds)
        if type(prepared.app).__name__ == "BFS":
            def boom(ctx, dev, state):
                raise RuntimeError("synthetic round failure")
            prepared.app.inceval = boom
        return prepared

    monkeypatch.setattr(worker_mod.Worker, "query_batch_prepare", poisoned)
    a = [sess.submit("sssp", {"source": s}) for s in [6, 17]]
    b = [sess.submit("bfs", {"source": s}) for s in [6, 17]]
    c = [sess.submit("sssp", {"source": s}) for s in [3, 42]]
    assert len(pump.drain()) == 6
    assert all(r.result.ok for r in a + c)
    assert all(not r.result.ok for r in b)
    assert "synthetic round failure" in b[1].result.error["error"]
    # the resident worker's own app was never poisoned
    assert sess.serve([("bfs", {"source": 6})])[0].ok


# ---- deferred results, admission waits, stats -----------------------------

def test_serve_result_deferred_values_resolve_once():
    calls = []

    def thunk():
        calls.append(1)
        return np.arange(4)

    r = ServeResult(request_id=0, app_key="sssp", ok=True, values_fn=thunk)
    assert r.deferred
    assert r.values.tobytes() == np.arange(4).tobytes()
    assert r.values is r.values
    assert not r.deferred and calls == [1]
    r2 = ServeResult(request_id=1, app_key="sssp", ok=True,
                     values=np.ones(2))
    assert not r2.deferred and r2.values.sum() == 2.0


def test_pump_lazy_harvest_defers_extraction():
    _, want = _sync_serve([("sssp", {"source": 6}), ("sssp", {"source": 17})])
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=2))
    pump = sess.async_pump(window=2)
    pump.eager_values = False
    sess.submit("sssp", {"source": 6})
    sess.submit("sssp", {"source": 17})
    res = pump.drain()
    assert all(r.deferred for r in res)
    assert res[0].values.tobytes() == want[0].values.tobytes()
    assert res[1].values.tobytes() == want[1].values.tobytes()
    assert not any(r.deferred for r in res)


def test_admission_queue_records_waits():
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4))
    for s in [6, 17, 3]:
        sess.submit("sssp", {"source": s})
    sess.drain()
    waits = sess.queue.admission_waits
    assert len(waits) == 3 and all(w >= 0 for w in waits)
    summ = sess.queue.admission_wait_summary()
    assert summ["n"] == 3 and summ["p99_ms"] >= summ["p50_ms"] >= 0.0


def test_compat_key_pick_builds_no_worker():
    sess = ServeSession(port_fragment(2),
                        policy=BatchPolicy(max_batch=4, max_wait_s=3600.0))
    sess.submit("sssp", {"source": 6})
    assert sess._workers == {}
    assert sess.pump() == []
    assert sess._workers == {}
    a = sess.submit("pagerank", {"source": 6})
    b = sess.submit("pagerank", {})
    assert sess._compat_key(a) != sess._compat_key(b)
    assert sess._workers == {}


def test_pump_stats_records_env_override(monkeypatch):
    PUMP_STATS.reset()
    monkeypatch.setenv("GRAPE_SERVE_INFLIGHT", "1")
    pump = ServeSession(port_fragment(2)).async_pump(window=4)
    assert pump.window == 1
    assert PUMP_STATS.snapshot()["declines"]["inflight_env"] == 1
    monkeypatch.setenv("GRAPE_SERVE_LAUNCH_CAP", "3")
    assert ServeSession(port_fragment(2)).async_pump().launch_cap == 3


def test_pump_close_detaches_after_draining():
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=2))
    pump = sess.async_pump(window=2)
    reqs = [sess.submit("bfs", {"source": s}) for s in [6, 17]]
    pump._fill(force=True)
    pump.close()
    assert sess._pump is None and all(r.done for r in reqs)


# ---- CLI ------------------------------------------------------------------

def test_cli_serve_inflight_pump(capsys, tmp_path):
    from libgrape_lite_tpu_torch.cli import serve_main

    dumps = {}
    for window in (1, 4):
        dump = tmp_path / f"res{window}.txt"
        serve_main([
            "--efile", dataset_path("p2p-31.e"),
            "--vfile", dataset_path("p2p-31.v"),
            "--fnum", "2", "--application", "bfs",
            "--sources", "6,17,3,42", "--max_batch", "2",
            "--inflight", str(window), "--dump_results", str(dump),
            "--device", "cpu",
        ])
        rec = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")][-1])
        assert rec["queries"] == 4 and rec["failed"] == 0
        assert rec["inflight"] == window
        assert "p99" in rec["admission_wait_ms"]
        dumps[window] = dump.read_text()
    assert rec["pump"]["window"] == 4 and rec["pump"]["engaged"] >= 1
    assert dumps[1] == dumps[4]
    lines = dumps[4].strip().splitlines()
    assert len(lines) == 4
    for i, line in enumerate(lines):
        idx, app, ok, rounds, digest = line.split()
        assert int(idx) == i and app == "bfs" and ok == "1"
        assert len(digest) == 64


def test_launch_counts_are_exact_under_threads():
    """The kernels' launch counters take a lock: batches of the pump
    count from their own threads, and no update may be lost."""
    import sys
    import threading

    from libgrape_lite_tpu_torch.ops._build import count_launch

    def wrapper():
        pass

    wrapper.launches = 0

    def hammer():
        for _ in range(2000):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000
