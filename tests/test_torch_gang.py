"""The port's plane across ranks, on the CPU, against the JAX package:
obs/gang.py (the clock handshake, the 30-bit word split, per-rank
sidecars and their assembler, `trace_word`, `incident_id`, the gang
postmortem, `trace_report --gang`), guard/vote.py (`classify_breach_error`
and `round_vote`: healthy, a remote breach, a local re-raise, round skew,
the shared incident id and the flow legs) and the guard's probe across
ranks (guard/monitor.py): two slab ranks in threads exchanging their
partial sums give the one-process verdict, measures, digest and residual.

Every case feeds the same inputs (seeded numpy, the same vote matrices,
the same sidecar files) to the JAX function and its port.  Rank fakes
are injected allgathers; no process group is started here (the real
gloo gangs are in tests/test_torch_dist_ft.py).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from libgrape_lite_tpu import obs as jobs
from libgrape_lite_tpu.obs import gang as jgang
from libgrape_lite_tpu.obs.tracer import Tracer as JTracer
from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.guard.config import GuardConfig
from libgrape_lite_tpu_torch.guard.monitor import (
    GuardMonitor,
    InvariantBreachError,
)
from libgrape_lite_tpu_torch.guard.watchdog import digest_hex
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.obs import gang
from libgrape_lite_tpu_torch.obs.tracer import Tracer
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path

torch.set_num_threads(1)

P2P = (dataset_path("p2p-31.e"), dataset_path("p2p-31.v"))


@pytest.fixture(autouse=True)
def _obs_reset(monkeypatch):
    """Every case starts disarmed in both packages, with no env arming,
    and leaves nothing armed behind (reset also forgets the handshake)."""
    for name in (obs.TRACE_ENV, obs.METRICS_ENV, "GRAPE_POSTMORTEM"):
        monkeypatch.delenv(name, raising=False)
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


class ThreadGather:
    """The allgathers of `n` fake ranks running in threads: each call
    blocks until every rank has contributed, then returns the stacked
    rows in rank order (the host_allgather contract)."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=60)
        self._slots = [None] * n

    def of(self, rank: int):
        def allgather(vec):
            self._slots[rank] = np.array(vec)
            self._barrier.wait()
            out = np.stack(self._slots)
            self._barrier.wait()
            return out

        return allgather


def run_ranks(fn, n: int) -> list:
    """`fn(rank)` in `n` threads; their results in rank order (a raise in
    any thread is re-raised here)."""
    out, errs = [None] * n, [None] * n

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # re-raised below
            errs[r] = e

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for e in errs:
        if e is not None:
            raise e
    return out


# ---- the word split and the clock handshake ---------------------------------


def test_word_split_matches_jax():
    for v in (0, 1, (1 << 30) - 1, 1 << 30, (1 << 60) + 12345,
              time.time_ns(), time.perf_counter_ns()):
        words = gang._split_ns(v)
        assert words == jgang._split_ns(v)
        assert all(0 <= w < (1 << 30) for w in words)
        assert gang._join_ns(words) == jgang._join_ns(words) == v
        assert np.asarray(words, np.int32).tolist() == words  # int32-safe


def test_handshake_offsets_match_jax():
    """The same peer anchors through both handshakes: rank 1's offset is
    rank 0's own perf anchor minus the peer's in each, rank 0's is 0, and
    the peer's anchors decode identically; cached until reset."""
    peer_perf = time.perf_counter_ns() + 5_000_000
    peer_wall = time.time_ns()
    peer = np.asarray(gang._split_ns(peer_perf) + gang._split_ns(peer_wall),
                      np.int32)
    calls = []

    def allgather(v):
        calls.append(np.asarray(v).tolist())
        return np.stack([np.asarray(v), peer])

    got = gang.ensure_handshake(rank=0, nprocs=2, allgather=allgather)
    want = jgang.ensure_handshake(rank=0, nprocs=2, allgather=allgather)
    assert set(got) == set(want)
    assert got["anchors"][1] == want["anchors"][1] == {
        "perf_ns": peer_perf, "wall_ns": peer_wall}
    for hs in (got, want):
        assert hs["nprocs"] == 2 and hs["offsets_ns"]["0"] == 0
        assert hs["offsets_ns"]["1"] == hs["anchors"][0]["perf_ns"] - peer_perf
    # each sends its own 6 words: perf then wall anchor
    assert [len(c) for c in calls] == [6, 6]
    assert gang.ensure_handshake(allgather=None) is got  # cached
    obs.reset()
    assert gang._state["handshake"] is None
    assert gang.ensure_handshake(rank=0, nprocs=1) is None
    assert jgang.ensure_handshake(rank=0, nprocs=1, force=True) is None


# ---- incident ids and trace words ---------------------------------------------


@pytest.mark.parametrize("basis", [
    {"kind": "breach_vote", "rounds": 3, "votes": [[0, 3, 0], [4, 3, 0]]},
    {"rounds": 3, "kind": "breach_vote",
     "votes": [[1, 7, 123456], [0, 7, 98765]]},
    ["InjectedFault", 4],
])
def test_incident_id_matches_jax(basis):
    got = gang.incident_id(basis)
    assert got == jgang.incident_id(basis) and len(got) == 16


def test_trace_word_matches_jax(monkeypatch):
    assert gang.trace_word() == jgang.trace_word() == 0  # disarmed
    tr, jtr = obs.configure(in_memory=True), jobs.configure(in_memory=True)
    tid = "%032x" % np.random.default_rng(3).integers(1 << 62)
    monkeypatch.setattr(tr, "trace_id", tid)
    monkeypatch.setattr(jtr, "trace_id", tid)
    assert gang.trace_word() == jgang.trace_word() == int(tid[:7], 16)
    assert gang.trace_word() < (1 << 28)


# ---- sidecars and the assembler -------------------------------------------------


def _two_rank_sidecars(tmp_path, writer: str, skew_ns: int = 2_500_000):
    """Two fake rank tracers of `writer`'s package, each with one superstep
    span and one leg of a shared vote flow, written as real sidecars with
    an injected handshake (rank 1's clock ahead)."""
    mod, cls = (gang, Tracer) if writer == "port" else (jgang, JTracer)
    hs = {"nprocs": 2, "offsets_ns": {"0": 0, "1": -skew_ns},
          "allgather_wall_ns": 0}
    gdir = str(tmp_path / "trace.gang")
    for r in (0, 1):
        t = cls(enabled=True, rank=r, nprocs=2)
        with t.span("superstep", round=1):
            pass
        t.flow("breach_vote", flow_id=3, cat="gang-vote",
               phase="s" if r == 0 else "f", round=2)
        p = mod.write_sidecar(tracer=t, handshake=dict(hs, rank=r),
                              path=os.path.join(gdir, f"rank_{r}.json"),
                              events=t.events())
        with open(p) as fh:
            doc = json.load(fh)
        assert doc["schema"] == gang.GANG_TRACE_SCHEMA
        assert (doc["rank"], doc["nprocs"]) == (r, 2)
    return gdir


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_assemble_matches_jax(tmp_path, writer):
    """The same sidecars (written by either package) assemble to the same
    summary and the same merged events in both."""
    gdir = _two_rank_sidecars(tmp_path, writer)
    got = gang.assemble(gdir, out_path=str(tmp_path / "port.json"))
    want = jgang.assemble(gdir, out_path=str(tmp_path / "jax.json"))
    assert {**got, "out": None} == {**want, "out": None}
    assert got["complete"] and got["aligned"] and got["monotonic"]
    assert got["cross_rank_flows"] == 1 and got["flow_events"] == 2
    assert got["supersteps_by_rank"] == {"0": 1, "1": 1}
    with open(got["out"]) as fh:
        mine = json.load(fh)
    with open(want["out"]) as fh:
        theirs = json.load(fh)
    assert mine["traceEvents"] == theirs["traceEvents"]
    assert mine["metadata"]["gang"] == theirs["metadata"]["gang"]
    legs = [e for e in mine["traceEvents"] if e.get("ph") in ("s", "t", "f")]
    assert {(e["cat"], e["id"]) for e in legs} == {("gang-vote", 3)}
    ts = [e["ts"] for e in mine["traceEvents"] if e.get("ph") != "M"]
    assert ts == sorted(ts)


def test_assemble_incomplete_cases_match_jax(tmp_path):
    gdir = _two_rank_sidecars(tmp_path, "port")
    os.remove(os.path.join(gdir, "rank_1.json"))
    got, want = gang.assemble(gdir), jgang.assemble(gdir)
    assert got == want and got["missing"] == [1] and not got["complete"]
    t = Tracer(enabled=True, rank=0, nprocs=2)
    with t.span("superstep"):
        pass
    solo = str(tmp_path / "solo.gang")
    gang.write_sidecar(tracer=t, handshake=None,
                       path=os.path.join(solo, "rank_0.json"),
                       events=t.events())
    got, want = gang.assemble(solo), jgang.assemble(solo)
    assert got == want and not got["aligned"] and not got["complete"]
    empty = tmp_path / "empty.gang"
    empty.mkdir()
    assert gang.assemble(str(empty)) == jgang.assemble(str(empty))


def test_trace_report_gang_cli(tmp_path, capsys):
    from libgrape_lite_tpu_torch.scripts import trace_report

    gdir = _two_rank_sidecars(tmp_path, "port")
    # the report finds `<base>.gang` from the trace path it is given
    assert trace_report.main(["--gang", str(tmp_path / "trace.json")]) == 0
    assert os.path.exists(os.path.join(gdir, "merged.json"))
    out = capsys.readouterr().out
    assert "gang trace federation" in out and "complete=True" in out
    os.remove(os.path.join(gdir, "rank_1.json"))
    assert trace_report.main(["--gang", gdir]) == 1  # incomplete
    assert "MISSING [1]" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        trace_report.main(["--gang", str(tmp_path / "nothing.json")])


def test_gang_events_stamp_rank_and_solo_stays_bare():
    solo = Tracer(enabled=True)
    with solo.span("superstep"):
        pass
    ev = [e for e in solo.events() if e["ph"] == "X"][0]
    assert "rank" not in ev and "nprocs" not in ev
    t1 = Tracer(enabled=True, rank=1, nprocs=2)
    with t1.span("superstep"):
        pass
    t1.flow("ckpt_stage", flow_id=5, phase="t", cat="gang-ckpt")
    ev = [e for e in t1.events() if e["ph"] == "X"][0]
    assert ev["pid"] == 1 and ev["rank"] == 1 and ev["nprocs"] == 2
    leg = [e for e in t1.events() if e["ph"] == "t"][0]
    assert (leg["cat"], leg["id"], leg["pid"]) == ("gang-ckpt", 5, 1)
    meta = [e for e in t1.metadata() if e["name"] == "process_name"]
    assert meta[0]["rank"] == 1
    assert gang.write_sidecar(tracer=Tracer(enabled=False)) is None


def test_gang_stats_federated_like_jax():
    from libgrape_lite_tpu.obs import federation as jfederation

    from libgrape_lite_tpu_torch.obs import federation

    snap, jsnap = federation.snapshot(), jfederation.snapshot()
    assert set(snap["gang"]) == set(jsnap["gang"])
    assert federation.EXPECTED["gang"] == "libgrape_lite_tpu_torch.obs.gang"


# ---- the breach vote ---------------------------------------------------------------


def test_vote_codes_classify_like_jax():
    from libgrape_lite_tpu.ft.faults import InjectedFault as JFault
    from libgrape_lite_tpu.guard import monitor as jmon
    from libgrape_lite_tpu.guard import vote as jvote

    from libgrape_lite_tpu_torch.ft.faults import InjectedFault
    from libgrape_lite_tpu_torch.guard import monitor as mon
    from libgrape_lite_tpu_torch.guard import vote

    for name in ("VOTE_HEALTHY", "VOTE_INVARIANT", "VOTE_DIVERGENCE",
                 "VOTE_FAULT", "VOTE_ERROR"):
        assert getattr(vote, name) == getattr(jvote, name)
    pairs = [(None, None),
             (mon.InvariantBreachError("b", {}),
              jmon.InvariantBreachError("b", {})),
             (mon.DivergenceError("d", {}), jmon.DivergenceError("d", {})),
             (InjectedFault("k"), JFault("k")),
             (OSError("io"), OSError("io")),
             (vote.RemoteBreachError("r", {}),
              jvote.RemoteBreachError("r", {}))]
    for mine, theirs in pairs:
        assert vote.classify_breach_error(mine) == \
            jvote.classify_breach_error(theirs)


def _votes(rank, responses, pkg):
    if pkg == "port":
        from libgrape_lite_tpu_torch.guard.vote import BreachVote
    else:
        from libgrape_lite_tpu.guard.vote import BreachVote
    return BreachVote(rank=rank, nprocs=len(responses),
                      allgather=lambda v: np.asarray(responses, np.int32))


@pytest.mark.parametrize("case", ["healthy", "remote", "skew", "rows"])
def test_round_vote_matches_jax(case):
    """The same gathered matrix: the same outcome, message, bundle and
    incident id in both packages, on every rank."""
    responses, rounds = {
        "healthy": ([[0, 7, 0], [0, 7, 0]], 7),
        "remote": ([[0, 7, 0], [1, 7, 0], [3, 7, 0]], 7),
        "skew": ([[0, 6, 0], [0, 7, 0]], 6),
        "rows": ([[0, 5, 0]], 5),
    }[case]
    n = len(responses)
    for rank in range(n):
        outcome = []
        for pkg in ("port", "jax"):
            v = _votes(rank, responses, pkg)
            if case == "rows":
                v.nprocs = 2  # one row for two processes
            try:
                v.round_vote(rounds)
                outcome.append(None)
            except Exception as e:
                outcome.append((type(e).__name__, str(e), e.bundle,
                                e.gang_incident))
        assert outcome[0] == outcome[1]
        assert (outcome[0] is None) == (case == "healthy")
    if case == "remote":
        assert "rank 1: invariant breach, rank 2: injected fault" in \
            outcome[0][1]
        assert outcome[0][2]["ranks"] == [1, 2]


def test_vote_local_error_reraised_after_exchange():
    from libgrape_lite_tpu.guard.monitor import (
        InvariantBreachError as JBreach,
    )
    from libgrape_lite_tpu.guard.vote import BreachVote as JVote

    from libgrape_lite_tpu_torch.guard.vote import BreachVote

    sent = {}
    matrix = np.asarray([[1, 7, 0], [0, 7, 0]], np.int32)
    for cls, exc, key in ((BreachVote, InvariantBreachError, "port"),
                          (JVote, JBreach, "jax")):
        def allgather(v, key=key):
            sent[key] = np.asarray(v).tolist()
            return matrix

        err = exc("dist went up", {"round": 7})
        with pytest.raises(exc, match="dist went up") as ei:
            cls(rank=0, nprocs=2, allgather=allgather).round_vote(7, err)
        sent[key + "_incident"] = ei.value.gang_incident
    # the verdict crossed the wire before the local raise: code 1 at 7
    assert sent["port"] == sent["jax"] == [1, 7, 0]
    assert sent["port_incident"] == sent["jax_incident"]


def test_vote_flow_legs_and_shared_incident():
    from libgrape_lite_tpu_torch.guard.vote import (
        BreachVote,
        RemoteBreachError,
    )

    tr = obs.configure(in_memory=True)
    votes = np.asarray([[0, 3, 0], [4, 3, 0]], np.int32)
    incidents = []
    for rank in (0, 1):
        v = BreachVote(rank=rank, nprocs=2, allgather=lambda vec: votes)
        with pytest.raises(RemoteBreachError) as ei:
            v.round_vote(3)
        incidents.append(ei.value.gang_incident)
    assert incidents[0] == incidents[1] == jgang.incident_id(
        {"kind": "breach_vote", "rounds": 3, "votes": votes.tolist()})
    legs = [e for e in tr.events() if e.get("ph") in ("s", "t", "f")]
    assert {(e["cat"], e["id"]) for e in legs} == {("gang-vote", 4)}
    assert sorted(e["ph"] for e in legs) == ["f", "s"]
    healthy = np.asarray([[0, 5, 0], [0, 5, 0]], np.int32)
    BreachVote(rank=0, nprocs=2, allgather=lambda vec: healthy).round_vote(5)
    last = [e for e in tr.events() if e.get("ph") == "s"][-1]
    assert last["args"]["halted"] is False
    assert BreachVote.for_current_process() is None  # no process group


# ---- the distributed flight recorder ---------------------------------------------


def test_gang_postmortem_byte_verified_manifest(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAPE_POSTMORTEM", str(tmp_path))
    obs.configure(in_memory=True)
    incident = gang.incident_id({"kind": "test", "n": 1})
    captured = {}

    def ag1(vec):
        captured["r1"] = np.asarray(vec).copy()
        return np.stack([np.zeros(3, np.int32), np.asarray(vec)])

    out1 = gang.gang_postmortem(incident, "drill", rank=1, nprocs=2,
                                allgather=ag1)
    assert out1["manifest"] is None  # rank 1 dumps, never manifests
    idir = tmp_path / f"incident_{incident}"
    assert (idir / "rank_1.json").exists()
    with open(idir / "rank_1.json") as fh:
        assert json.load(fh)["incident"] == incident

    def ag0(vec):
        return np.stack([np.asarray(vec), captured["r1"]])

    out0 = gang.gang_postmortem(incident, "drill", rank=0, nprocs=2,
                                allgather=ag0)
    assert out0["complete"] is True
    with open(out0["manifest"]) as fh:
        man = json.load(fh)
    assert man["schema"] == gang.GANG_BUNDLE_SCHEMA == jgang.GANG_BUNDLE_SCHEMA
    assert (man["incident"], man["nprocs"], man["complete"]) == (
        incident, 2, True)
    assert all(man["shards"][r]["verified"] for r in ("0", "1"))
    with open(idir / "rank_1.json", "a") as fh:  # tampered
        fh.write("\n")
    out_t = gang.gang_postmortem(incident, "drill", rank=0, nprocs=2,
                                 allgather=ag0)
    assert out_t["complete"] is False


def test_gang_postmortem_counts_only_without_sink():
    obs.configure(in_memory=True)
    before = gang.GANG_STATS["postmortems"]

    def boom(v):
        raise AssertionError("allgather reached")

    assert gang.gang_postmortem("deadbeefdeadbeef", "drill", rank=0,
                                nprocs=2, allgather=boom) is None
    assert gang.GANG_STATS["postmortems"] == before + 1


def test_on_breach_halt_dumps_under_the_vote_incident(tmp_path, monkeypatch):
    from libgrape_lite_tpu_torch.guard.vote import RemoteBreachError

    monkeypatch.setenv("GRAPE_POSTMORTEM", str(tmp_path / "pm"))
    tr = obs.configure(in_memory=True)
    err = RemoteBreachError("halt voted", {"rounds": 4, "ranks": [1],
                                           "codes": [3]})
    err.gang_incident = "0123456789abcdef"
    halts = gang.GANG_STATS["halts"]
    gang.on_breach_halt(err, 4, allgather=lambda v: np.asarray(v)[None])
    assert gang.GANG_STATS["halts"] == halts + 1
    assert gang.GANG_STATS["last_incident"] == err.gang_incident
    idir = tmp_path / "pm" / f"incident_{err.gang_incident}"
    with open(idir / "rank_0.json") as fh:
        shard = json.load(fh)
    assert shard["extra"]["vote"] == {"rounds": 4, "ranks": [1],
                                      "codes": [3]}
    assert any(e.get("name") == "gang_halt" for e in tr.events())


# ---- the guard's probe across ranks ------------------------------------------------

_FRAGS = {}


def frag_of(rank=None):
    """p2p-31 at fnum 4: one process (rank None), or rank r of a two-rank
    group's view (its [2, vp] slab placed; no group is needed)."""
    if rank not in _FRAGS:
        spec = (CommSpec(4, "cpu") if rank is None
                else CommSpec(4, "cpu", rank=rank, world=2))
        _FRAGS[rank] = LoadGraph(*P2P, spec, LoadGraphSpec(
            weighted=True, edata_dtype=np.float64))
    return _FRAGS[rank]


PROBE_APPS = {
    "sssp": (lambda: APP_REGISTRY["sssp"](dtype=torch.float64),
             {"source": 6}),
    "bfs": (lambda: APP_REGISTRY["bfs"](), {"source": 6}),
    "wcc": (lambda: APP_REGISTRY["wcc"](), {}),
    "pagerank": (lambda: APP_REGISTRY["pagerank"](dtype=torch.float64),
                 {"delta": 0.85, "max_round": 10}),
}


def _carries(name):
    """The one-process carries after rounds 2 and 3."""
    make, kw = PROBE_APPS[name]
    out = []
    for rounds in (2, 3):
        w = Worker(make(), frag_of())
        out.append({k: v.clone() for k, v in w.query(rounds, **kw).items()})
    return make, out


def _slab(app, carry, rank):
    rep = getattr(app, "replicated_keys", frozenset())
    return {k: (v[2 * rank:2 * rank + 2] if k not in rep and v.dim() >= 2
                else v) for k, v in carry.items()}


def _probe_both(make, prev, cur):
    cfg = GuardConfig(policy="halt")
    one = GuardMonitor(make(), frag_of(), cfg)
    one.resolve(cur)
    want = one._probe(prev, cur)
    g = ThreadGather(2)

    def rank(r):
        app = make()
        m = GuardMonitor(app, frag_of(r), cfg, allgather=g.of(r))
        c = _slab(app, cur, r)
        m.resolve(c)
        return m._probe(_slab(app, prev, r), c)

    return want, run_ranks(rank, 2)


@pytest.mark.parametrize("name", list(PROBE_APPS))
def test_probe_across_ranks_is_the_one_process_probe(name):
    make, (prev, cur) = _carries(name)
    want, got = _probe_both(make, prev, cur)
    for oks, vals, digest, residual in got:
        assert oks == want[0] and all(want[0])
        np.testing.assert_allclose(vals, want[1], rtol=1e-5, atol=1e-7)
        assert digest == want[2]
        assert digest_hex(digest) == digest_hex(want[2])
        assert residual == pytest.approx(want[3], rel=1e-7)


def test_probe_across_ranks_sees_a_breach_in_one_slab():
    """A poisoned row in rank 1's slab alone: both ranks' verdicts fail
    with the one-process measures, and the digests still agree."""
    make, (prev, cur) = _carries("sssp")
    bad = {**cur, "dist": cur["dist"].clone()}
    bad["dist"][3, :5] = float("nan")
    bad["dist"][2, 7] = prev["dist"][2, 7] + 1.0  # an increase
    want, got = _probe_both(make, prev, bad)
    assert not all(want[0])
    for oks, vals, digest, _ in got:
        assert oks == want[0] and vals == want[1] and digest == want[2]
