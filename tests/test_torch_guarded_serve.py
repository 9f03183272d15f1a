"""Guarded serving in the port (`serve/batch.py`, `Worker.query_batch(
guard=...)`, the session's, queue's and pump's guard policies, `serve
--guard`) on the CPU, held against the JAX package on `dataset/
p2p-31.*`: the guard cases of tests/test_serve.py, tests/test_serve_async.py
and tests/test_fleet.py.

* Clean guarded lanes are bit-equal to their sequential queries and to
  the JAX package's `run_guarded_batch` at fnum 1, 2, 4 and 8.
* A poisoned lane (the JAX test's chunk hook: NaN or a negative value in
  lane 1 after round 3) fails alone, with the JAX bundle's verdict kind,
  round, failed invariants and recent digest words, for native lanes
  (sssp, bfs) and per-lane batches (wcc); its batchmates stay bit-equal.
* Each lane's digest words equal the JAX package's for that lane.
* A chunk boundary costs one host read for all lanes: the guarded
  batch's reads are the unguarded batch's plus one a boundary.
* The session reports a breached lane as a failed result; guarded
  requests skip the cache; a request's guard wins over the session's.
* The pump at W > 1 returns the synchronous path's results, a breach in
  a window batch included.
* `serve --guard halt|warn|rollback` dumps equal the JAX CLI's and the
  unguarded run's, through replicas and tenants too; tenant breach
  isolation holds.
"""

import json

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch.guard.config import GuardConfig
from libgrape_lite_tpu_torch.guard.watchdog import (
    carry_digest,
    carry_digest_lanes,
    digest_hex,
)
from libgrape_lite_tpu_torch.models import APP_REGISTRY, SSSP
from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession
from libgrape_lite_tpu_torch.serve import batch as serve_batch
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_lanes import port_app, port_fragment
from tests.test_torch_serve import port_apps

torch.set_num_threads(1)

SOURCES = [6, 17, 3, 42]
P2P = ["--efile", dataset_path("p2p-31.e"), "--vfile",
       dataset_path("p2p-31.v")]


def sequential(frag, name, sources):
    out = {}
    for s in sources:
        w = Worker(port_app(name), frag)
        w.query(source=s)
        out[s] = w.result_values()
    return out


def jax_guarded(graph_cache, fnum, name, args_list, hook=None):
    """The JAX package's guarded batch: (values a lane, breaches)."""
    from libgrape_lite_tpu.guard.config import GuardConfig as JConfig
    from libgrape_lite_tpu.models import APP_REGISTRY as J
    from libgrape_lite_tpu.serve.batch import run_guarded_batch as jrun
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    w = JWorker(J[name](), graph_cache(fnum))
    jrun(w, args_list, 0, JConfig(policy="halt", every=1), chunk_hook=hook)
    return ([np.asarray(w.batch_result_values(b))
             for b in range(len(args_list))], w.batch_breaches)


def port_guarded(fnum, name, args_list, hook=None, every=1,
                 policy="halt"):
    w = Worker(port_app(name), port_fragment(fnum))
    serve_batch.run_guarded_batch(
        w, args_list, 0, GuardConfig(policy=policy, every=every),
        chunk_hook=hook)
    return w


@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["sssp", "bfs"])
def test_clean_guarded_lanes_equal_sequential_and_jax(graph_cache, name,
                                                      fnum):
    args = [{"source": s} for s in SOURCES]
    want = sequential(port_fragment(fnum), name, SOURCES)
    w = port_guarded(fnum, name, args)
    jvals, jbreach = jax_guarded(graph_cache, fnum, name, args)
    assert w.batch_breaches == [None] * 4 and jbreach == [None] * 4
    for b, s in enumerate(SOURCES):
        got = w.batch_result_values(b)
        assert got.tobytes() == want[s].tobytes()
        assert got.tobytes() == jvals[b].tobytes()
    rep = w.guard_report
    assert rep["probes"] == int(w.batch_rounds[0]) + 1


POISON = {"nan": float("nan"), "negative": -5.0}


def _jax_hook(key, value):
    import jax

    def hook(carry, rounds):
        if rounds != 3:
            return None
        a = np.array(jax.device_get(carry[key]))
        a[1, 0, :8] = value
        return {key: a}

    return hook


def _port_hook(key, value):
    def hook(carry, rounds):
        if rounds != 3:
            return None
        if isinstance(carry, list):  # a per-lane batch
            a = carry[1][key].clone()
            a[0, :8] = value
            return [None, {key: a}] + [None] * (len(carry) - 2)
        a = carry[key].clone()
        a[1, 0, :8] = value
        return {key: a}

    return hook


@pytest.mark.parametrize("fnum", [2, 4])
@pytest.mark.parametrize("name,key,poison", [
    ("sssp", "dist", "nan"), ("sssp", "dist", "negative"),
    ("bfs", "depth", "negative"), ("wcc", "comp", "negative"),
])
def test_poisoned_lane_isolated_like_jax(graph_cache, name, key, poison,
                                         fnum):
    value = POISON[poison]
    if name == "wcc":
        args = [{}, {}, {}]
        value = -5
    else:
        args = [{"source": s} for s in SOURCES]
        if name == "bfs":
            value = -5
    w = port_guarded(fnum, name, args, hook=_port_hook(key, value))
    jvals, jbreach = jax_guarded(graph_cache, fnum, name, args,
                                 hook=_jax_hook(key, value))
    got = w.batch_breaches
    assert [b is None for b in got] == [b is None for b in jbreach]
    assert got[1] is not None
    for field in ("round", "active", "policy", "invariants"):
        assert got[1][field] == jbreach[1][field], field
    assert got[1]["verdict"]["kind"] == jbreach[1]["verdict"]["kind"]
    assert (got[1]["verdict"]["failed"].keys()
            == jbreach[1]["verdict"]["failed"].keys())
    # the digest words of every probe the lane saw, as the JAX package's
    assert ([tuple(x) for x in got[1]["recent_digests"]]
            == [tuple(x) for x in jbreach[1]["recent_digests"]])
    assert len(got[1]["recent_digests"]) == 4  # rounds 0 to 3
    assert int(w.batch_rounds[1]) == 3
    for b in range(len(args)):
        if b == 1:
            continue
        assert w.batch_result_values(b).tobytes() == jvals[b].tobytes()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.int32])
def test_lane_digest_words_equal_jax(dtype):
    from libgrape_lite_tpu.guard.watchdog import carry_digest as jdigest
    from libgrape_lite_tpu.guard.watchdog import digest_hex as jhex

    g = torch.Generator().manual_seed(7)
    if dtype == torch.int32:
        a = torch.randint(-9, 1 << 30, (5, 3, 64), generator=g,
                          dtype=torch.int32)
    else:
        a = (torch.rand((5, 3, 64), generator=g) * 100).to(dtype)
        a[2, 1, 5] = float("inf")
    b = torch.arange(5 * 3 * 64, dtype=torch.int32).reshape(5, 3, 64)
    carry = {"x": a, "b": b}
    lanes = carry_digest_lanes(carry, 5)
    for lane in range(5):
        one = {k: v[lane] for k, v in carry.items()}
        want = jhex(tuple(int(x) for x in np.asarray(jdigest(
            {k: v.numpy() for k, v in one.items()}))))
        assert digest_hex(tuple(int(x) for x in lanes[lane])) == want
        assert lanes[lane].tolist() == carry_digest(one).tolist()


def test_a_boundary_costs_one_host_read(monkeypatch):
    """Reads of the card's values: the unguarded batch's, plus one a
    chunk boundary (not one a lane), at cadence 1 and 3."""
    reads = {"n": 0}
    orig = torch.Tensor.tolist

    def counting(self):
        reads["n"] += 1
        return orig(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    frag = port_fragment(2)
    args = [{"source": s} for s in SOURCES]
    w = Worker(port_app("sssp"), frag)
    w.query_batch(args)
    plain = reads["n"]
    rounds = int(w.batch_rounds.max())
    for every in (1, 3):
        reads["n"] = 0
        before = dict(serve_batch.GUARDED_BATCH_STATS)
        port_guarded(2, "sssp", args, every=every)
        boundaries = (serve_batch.GUARDED_BATCH_STATS["boundaries"]
                      - before["boundaries"])
        assert boundaries == 1 + -(-rounds // every)
        assert reads["n"] == plain + boundaries


def test_rollback_degrades_to_per_lane_halt(capsys):
    w = port_guarded(2, "sssp", [{"source": s} for s in SOURCES],
                     hook=_port_hook("dist", -5.0), policy="rollback")
    assert w.batch_breaches[1] is not None
    assert w.batch_breaches[1]["policy"] == "rollback"
    assert "rollback degrades to per-lane halt" in capsys.readouterr().err
    want = sequential(port_fragment(2), "sssp", SOURCES)
    assert w.batch_result_values(0).tobytes() == want[6].tobytes()


# ---- the session, the queue and the pump -----------------------------------


def _patch_hook(monkeypatch, key, value, lanes=None):
    """Poison lane 1 of every guarded batch (of `lanes` lanes) through
    the guarded loop the session and the pump both run."""
    orig = serve_batch.guarded_lane_loop
    hits = []

    def poisoned(app, frag, state, eph, mr, batch, cfg, chunk_hook=None):
        if lanes is not None and batch != lanes:
            return orig(app, frag, state, eph, mr, batch, cfg)
        hits.append(batch)

        def hook(carry, rounds):
            if rounds != 2:
                return None
            a = carry[key].clone()
            a[0, 0, :4] = value
            return {key: a}

        return orig(app, frag, state, eph, mr, batch, cfg, chunk_hook=hook)

    monkeypatch.setattr(serve_batch, "guarded_lane_loop", poisoned)
    return hits


def test_session_reports_breached_lane_as_failed_result(monkeypatch):
    _patch_hook(monkeypatch, "dist", -5.0)
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4), guard="halt")
    res = sess.serve([("sssp", {"source": s}) for s in [6, 17, 3]])
    assert not res[0].ok and res[0].error["verdict"]["kind"] == "invariant"
    assert res[0].error["round"] == 2
    assert res[1].ok and res[2].ok
    assert sess.stats["failed"] == 1
    want = sequential(port_fragment(2), "sssp", [17, 3])
    assert res[1].values.tobytes() == want[17].tobytes()


def test_guarded_single_query_breach_fails_alone(monkeypatch):
    monkeypatch.setenv("GRAPE_FT_FAULTS", "corrupt_carry@2")
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=1), guard="halt")
    res = sess.serve([("sssp", {"source": 6})])
    monkeypatch.delenv("GRAPE_FT_FAULTS")
    assert not res[0].ok and res[0].error["verdict"]["kind"] == "invariant"
    assert res[0].error["round"] == 2
    res = sess.serve([("sssp", {"source": 6})])
    assert res[0].ok


def test_guarded_requests_skip_the_cache():
    from libgrape_lite_tpu_torch.autopilot import ResultCache

    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4))
    cache = ResultCache(capacity=8)
    sess.attach_result_cache(cache)
    for guard in ("halt", "warn", "off"):
        r = sess.submit("sssp", {"source": 6}, guard=guard)
        sess.drain()
        assert r.result.ok
    assert cache.stores == 0 and cache.hits == 0
    sess.serve([("sssp", {"source": 6})])
    sess.serve([("sssp", {"source": 6})])
    assert cache.stores == 1 and cache.hits == 1


def test_request_guard_wins_over_the_session_default():
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4), guard="halt")
    r1 = sess.submit("sssp", {"source": 6})
    r2 = sess.submit("sssp", {"source": 17}, guard="off")
    sess.drain()
    assert sess.queue.batch_hist == {1: 2}  # never one batch
    assert r1.result.ok and r2.result.ok
    with pytest.raises(ValueError, match="unknown guard policy"):
        sess.submit("sssp", {"source": 6}, guard="panic")


@pytest.mark.parametrize("window", [1, 3])
def test_pump_guarded_equals_sync(window):
    stream = [("sssp", {"source": s}) for s in [6, 17, 3, 42, 11, 12]]
    s0 = ServeSession(port_fragment(2), apps=port_apps(),
                      policy=BatchPolicy(max_batch=2), guard="halt")
    r0 = s0.serve(stream)
    s1 = ServeSession(port_fragment(2), apps=port_apps(),
                      policy=BatchPolicy(max_batch=2), guard="halt")
    pump = s1.async_pump(window=window)
    for app, args in stream:
        s1.submit(app, args)
    r1 = pump.drain()
    assert [r.values.tobytes() for r in r0] == [
        r.values.tobytes() for r in r1]
    assert [r.rounds for r in r0] == [r.rounds for r in r1]


def test_pump_breach_mid_window_isolated(monkeypatch):
    hits = _patch_hook(monkeypatch, "dist", -5.0, lanes=3)
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=4))
    pump = sess.async_pump(window=3)
    head = [sess.submit("sssp", {"source": s}) for s in [42, 11]]
    mid = [sess.submit("sssp", {"source": s}, guard="halt")
           for s in [6, 17, 3]]
    tail = [sess.submit("sssp", {"source": s}) for s in [6, 17]]
    pump.drain()
    assert hits == [3]
    want = sequential(port_fragment(2), "sssp", [6, 17, 3, 42, 11])
    assert not mid[0].result.ok
    assert mid[0].result.error["verdict"]["kind"] == "invariant"
    for req, s in zip(mid[1:] + head + tail,
                      [17, 3] + [42, 11] + [6, 17]):
        assert req.result.ok
        assert req.result.values.tobytes() == want[s].tobytes()


def test_tenant_breach_isolation(monkeypatch):
    from libgrape_lite_tpu_torch.fleet import FleetBudget, FleetManager

    hits = _patch_hook(monkeypatch, "dist", -5.0, lanes=2)
    sess = ServeSession(port_fragment(2), apps=port_apps(),
                        policy=BatchPolicy(max_batch=8), guard="halt")
    mgr = FleetManager(FleetBudget(capacity_bytes=0))
    mgr.add_tenant("a", sess)
    mgr.add_tenant("b", sess)
    p2p = [6, 17, 3, 42, 11]
    ta = [mgr.submit("a", "sssp", {"source": s}) for s in p2p[:2]]
    tb = [mgr.submit("b", "sssp", {"source": s}) for s in p2p[2:]]
    mgr.drain()
    assert hits == [2]
    assert not ta[0].result.ok
    assert ta[0].result.error["verdict"]["kind"] == "invariant"
    want = sequential(port_fragment(2), "sssp", p2p[2:])
    for t, s in zip(tb, p2p[2:]):
        assert t.result.ok and t.result.values.tobytes() == want[s].tobytes()


# ---- the serve CLI ---------------------------------------------------------


def _summary(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("guard", ["halt", "warn", "rollback"])
def test_cli_serve_guard_dumps_equal_jax(capsys, tmp_path, guard):
    from libgrape_lite_tpu.cli import serve_main as jserve_main
    from libgrape_lite_tpu_torch.cli import main

    # bfs: integer depths, the same bytes in both packages (the CLI's
    # SSSP is float32 in the port, float64 under the JAX tests' x64)
    args = [*P2P, "--fnum", "2", "--application", "bfs", "--sources",
            "6,17,3,42,11,12", "--max_batch", "4"]
    jserve_main([*args, "--guard", guard, "--dump_results",
                 str(tmp_path / "jax.txt")])
    capsys.readouterr()
    assert main(["serve", *args, "--guard", guard, "--dump_results",
                 str(tmp_path / "pt.txt"), "--device", "cpu"]) == 0
    rec = _summary(capsys.readouterr().out)
    assert rec["queries"] == 6 and rec["failed"] == 0
    assert main(["serve", *args, "--dump_results",
                 str(tmp_path / "plain.txt"), "--device", "cpu"]) == 0
    got = (tmp_path / "pt.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    assert got == (tmp_path / "plain.txt").read_text()


@pytest.mark.parametrize("fnum", ["1", "4"])
def test_cli_serve_guard_through_replicas_and_tenants(capsys, tmp_path,
                                                      fnum):
    from libgrape_lite_tpu_torch.cli import main

    stream = tmp_path / "stream.txt"
    stream.write_text("".join(f"sssp {s}\nbfs {s}\n"
                              for s in (6, 17, 3, 42)))
    args = [*P2P, "--fnum", fnum, "--stream", str(stream), "--max_batch",
            "4", "--device", "cpu"]
    assert main(["serve", *args, "--dump_results",
                 str(tmp_path / "plain.txt")]) == 0
    assert main(["serve", *args, "--guard", "halt", "--replicas", "2",
                 "--tenants", "by_app", "--dump_results",
                 str(tmp_path / "fleet.txt")]) == 0
    rec = _summary(capsys.readouterr().out)
    assert rec["failed"] == 0 and rec["fleet"]["tenants"] == 2
    assert ((tmp_path / "fleet.txt").read_text()
            == (tmp_path / "plain.txt").read_text())


def test_guarded_batch_on_the_registry_default_app():
    """The CLI's float32 SSSP (the registry's class) guarded and not."""
    frag = port_fragment(2)
    args = [{"source": s} for s in SOURCES]
    w = Worker(APP_REGISTRY["sssp"](), frag)
    w.query_batch(args)
    plain = [w.batch_result_values(b).tobytes() for b in range(4)]
    w = Worker(SSSP(), frag)
    w.query_batch(args, guard="warn")
    assert [w.batch_result_values(b).tobytes() for b in range(4)] == plain
    assert w.batch_breaches == [None] * 4
