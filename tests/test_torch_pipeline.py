"""The port's pipelined superstep (`parallel/pipeline.py`,
`fragment/edgecut.py::boundary_split`, the apps' `inceval_pipelined`, the
worker's pipelined round, `obs/truth.py`) against the JAX package's, on
the CPU, where the steps run in order with no streams.

* `boundary_split` and `boundary_stats` equal the JAX ones (fnum 2, 4, 8;
  ie, oe and the joint mask); the split covers the mirror requests.
* The split K1 CSRs hold the rows and edges of the JAX `_split_streams`
  in the same order, their columns the JAX columns remapped into the
  splice table (gather and mirror), pads in range.
* The env knobs and the engage / decline decision with its reason equal
  the JAX package's for SSSP, BFS, WCC (undirected and directed), CDLP
  and PageRank at fnum 1, 2, 4 and 8 under GRAPE_PIPELINE 0 / 1 / force
  and GRAPE_EXCHANGE gather / mirror / auto -- but PageRank, which
  declines with the sum-fold reason wherever it would engage.
* Results: pipelined equals serial bit for bit and the JAX pipelined
  result (SSSP, BFS, WCC both forms, CDLP, cdlp_opt at fnum 2, 4, 8,
  gather and mirror; sssp_vc, bfs_vc, wcc_vc at fnum 4, and the port
  alone at fnum 9); PageRank stays serial within 1e-4 of JAX.
* A pipelined round makes 2 K1 pulls (4 for directed WCC); a buffer
  poisoned outside the rows other fragments read changes nothing.
* The drills of tests/test_pipeline.py: guard halt, corrupt-carry
  rollback, kill and resume, and the batched, incremental and dyn
  queries that keep the serial round; the traced query's span brief and
  the truth meter's join (equal to the JAX meter's on the same events);
  the ledger's pipeline block; `pipeline` in the federation.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.fragment.edgecut import (
    boundary_split,
    boundary_stats,
)
from libgrape_lite_tpu_torch.models import (
    BFS,
    CDLP,
    SSSP,
    WCC,
    CDLPOpt,
    PageRank,
    WCCOpt,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel import mirror, pipeline
from libgrape_lite_tpu_torch.parallel.pipeline import PIPELINE_STATS
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.test_torch_mirror import jax_frag, rand_frag

torch.set_num_threads(1)

FNUMS = [2, 4, 8]
_ENV = ("GRAPE_PIPELINE", "GRAPE_PIPELINE_MIN_BYTES",
        "GRAPE_PIPELINE_MIN_HIDDEN_US", "GRAPE_EXCHANGE", "GRAPE_SPMV",
        "GRAPE_CALIBRATE_HARVEST", "GRAPE_RATE_PROFILE")


@pytest.fixture(autouse=True)
def _pipeline_env(monkeypatch):
    from libgrape_lite_tpu import obs as jobs

    for var in _ENV + (obs.TRACE_ENV, obs.METRICS_ENV):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    jobs.reset()
    yield monkeypatch
    obs.reset()
    jobs.reset()


# ---- the boundary / interior split -----------------------------------------

@pytest.mark.parametrize("directions", [("ie",), ("oe",), ("ie", "oe")])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("fnum", FNUMS)
def test_boundary_split_equals_jax(fnum, directed, directions):
    from libgrape_lite_tpu.fragment.edgecut import (
        boundary_split as jsplit,
        boundary_stats as jstats,
    )

    frag = rand_frag(fnum, directed=directed)
    jfrag = jax_frag(fnum, directed)
    bmask = boundary_split(frag, directions)
    np.testing.assert_array_equal(bmask, jsplit(jfrag, directions))
    assert not bmask[~frag.host_inner_mask()].any()
    assert boundary_split(frag, tuple(reversed(directions))) is bmask
    for d in ("ie", "oe"):
        assert boundary_stats(frag, bmask, d) == jstats(jfrag, bmask, d)


@pytest.mark.parametrize("fnum", [2, 4])
def test_boundary_split_covers_mirror_requests(fnum):
    frag = rand_frag(fnum)
    plan = mirror.build_mirror_plan(frag, "ie")
    bmask = boundary_split(frag, ("ie",))
    for g in range(fnum):
        for f in range(fnum):
            if f != g:
                rows = plan.send_idx[g, f][plan.send_idx[g, f] > 0]
                assert bmask[g][rows].all()


# ---- the split K1 CSRs -------------------------------------------------------

def expand(indptr, nbr):
    """(rows, columns) of a K1 CSR's real edges, in CSR order."""
    deg = np.diff(indptr)
    n = int(indptr[-1])
    return np.repeat(np.arange(len(deg)), deg), nbr[:n]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("exchange", ["gather", "mirror"])
@pytest.mark.parametrize("fnum", FNUMS)
def test_split_csrs_hold_the_jax_streams(fnum, exchange, weighted):
    from libgrape_lite_tpu.parallel import pipeline as jpipe
    from libgrape_lite_tpu.parallel.mirror import build_mirror_plan as jbuild

    frag, jfrag = rand_frag(fnum), jax_frag(fnum)
    vp, n = frag.vp, fnum * frag.vp
    bmask = boundary_split(frag, ("ie",))
    mx = mirror.build_mirror_plan(frag, "ie") if exchange == "mirror" \
        else None
    jmx = jbuild(jfrag, "ie") if exchange == "mirror" else None
    got = pipeline._split_streams(frag, bmask, "ie", mx, weighted, "pl_",
                                  with_rows=True)
    want = jpipe._split_streams(jfrag, bmask, "ie", jmx, weighted, "pl_")
    table = 2 * n if mx is None else n + fnum * fnum * mx.m
    for part in ("b", "i"):
        p = f"pl_{part}_"
        for f in range(fnum):
            val = np.asarray(want[p + "val"][f])
            jsrc = np.asarray(want[p + "src"][f])[val]
            jnbr = np.asarray(want[p + "nbr"][f])[val].astype(np.int64)
            rows, cols = expand(got[p + "indptr"][f], got[p + "nbr"][f])
            np.testing.assert_array_equal(rows, jsrc)
            if mx is None:
                expect = np.where(jnbr // vp == f, jnbr, n + jnbr)
            else:
                expect = np.where(jnbr < vp, f * vp + jnbr,
                                  n + f * fnum * mx.m + (jnbr - vp))
            np.testing.assert_array_equal(cols, expect)
            assert (got[p + "nbr"][f] < table).all()
            assert (got[p + "nbr"][f][len(cols):] == 0).all()
            k = len(cols)
            np.testing.assert_array_equal(got[p + "row"][f][:k], jsrc)
            assert (got[p + "row"][f][k:] == vp).all()
            if weighted:
                np.testing.assert_array_equal(
                    got[p + "w"][f][:k], np.asarray(want[p + "w"][f])[val])
            on = bmask[f][rows] if part == "b" else ~bmask[f][rows]
            assert on.all()


# ---- the models and the knobs -------------------------------------------------

def test_overlap_model_prices_from_the_rate_profile():
    from dataclasses import replace

    from libgrape_lite_tpu_torch.ops.calibration import default_profile

    prof = default_profile()
    m = pipeline.overlap_model(1000, 100_000, 1000)
    assert m["compute_boundary_s"] == 1000 * 30.0 / prof.ops_per_s
    assert m["compute_interior_s"] == 100_000 * 30.0 / prof.ops_per_s
    assert m["exchange_s"] == 1000 / prof.exchange_bps["gather"]
    assert m["hidden_frac"] == 1.0 and m["round_speedup"] > 1.0
    m2 = pipeline.overlap_model(1000, 10**8, 10**9)
    assert 0.0 < m2["hidden_frac"] < 1.0
    assert m2["t_pipelined_s"] == mirror.pipelined_round_s(
        m2["compute_interior_s"], m2["exchange_s"],
        m2["compute_boundary_s"])
    assert pipeline.overlap_model(10, 10, 0)["hidden_frac"] == 0.0
    slow = replace(prof, exchange_bps={"gather": 1e9, "mirror": 2e9,
                                       "vc2d": 4e9})
    assert pipeline.overlap_model(1, 1, 4000, profile=slow,
                                  mode="mirror")["exchange_s"] == 2e-6


@pytest.mark.parametrize("value", ["", "0", "off", "1", "auto", "force",
                                   "yes"])
def test_env_knobs_equal_jax(monkeypatch, value):
    from libgrape_lite_tpu.parallel import pipeline as jpipe

    monkeypatch.setenv("GRAPE_PIPELINE", value)
    assert pipeline.pipeline_mode() == jpipe.pipeline_mode()
    assert pipeline.pipeline_min_bytes() == jpipe.pipeline_min_bytes()
    monkeypatch.setenv("GRAPE_PIPELINE_MIN_BYTES", "4096")
    monkeypatch.setenv("GRAPE_PIPELINE_MIN_HIDDEN_US", "2.5")
    assert pipeline.pipeline_min_bytes() == jpipe.pipeline_min_bytes()
    assert pipeline.pipeline_min_hidden_us() == \
        jpipe.pipeline_min_hidden_us()


def _pair(name):
    """(port app, JAX app, query args, directed) on the rand graphs."""
    from libgrape_lite_tpu import models as J

    return {
        "sssp": (SSSP(), J.SSSP(), {"source": 0}, False),
        "bfs": (BFS(), J.BFS(), {"source": 0}, False),
        "wcc": (WCC(), J.WCC(), {}, False),
        "wcc_directed": (WCC(), J.WCC(), {}, True),
        "cdlp": (CDLP(), J.CDLP(), {"max_round": 10}, False),
        "cdlp_opt": (CDLPOpt(), J.CDLPOpt(), {"max_round": 10}, False),
        "pagerank": (PageRank(), J.PageRank(), {}, False),
        "wcc_opt": (WCCOpt(), J.WCCOpt(), {}, False),
    }[name]


def _decision(stats):
    dec = stats["last_decision"] or {}
    return dec.get("engaged"), dec.get("reason"), dec.get("exchange_bytes")


@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc", "wcc_directed",
                                  "cdlp", "pagerank", "wcc_opt"])
def test_decisions_equal_jax(monkeypatch, name, fnum):
    from libgrape_lite_tpu.parallel.pipeline import (
        PIPELINE_STATS as JSTATS,
    )

    for pipe in ("0", "1", "force"):
        for exchange in ("gather", "mirror", "auto"):
            monkeypatch.setenv("GRAPE_PIPELINE", pipe)
            monkeypatch.setenv("GRAPE_EXCHANGE", exchange)
            app, japp, qa, directed = _pair(name)
            PIPELINE_STATS["last_decision"] = None
            JSTATS["last_decision"] = None
            app.init_state(rand_frag(fnum, directed=directed), **qa)
            japp.init_state(jax_frag(fnum, directed), **qa)
            got, want = _decision(PIPELINE_STATS), _decision(JSTATS)
            case = (pipe, exchange)
            if name == "pagerank" and pipe != "0" and fnum > 1:
                # the JAX XLA sum pipelines (or reaches its byte gate);
                # the port's sums run on K1 or the strict tiles, and
                # both regroup under a split: a decline, its reason named
                assert app._pipeline is None, case
                assert got[1] in (
                    "sum fold over the K1 merge path is not bit-stable "
                    "under a split plan",
                    "strict-tile spmv plan engaged (tile partial sums "
                    "regroup under a split)"), case
                continue
            assert got == want, case
            assert (app._pipeline is None) == (japp._pipeline is None)
            if app._pipeline is not None:
                assert app._pipeline.mode == japp._pipeline.mode
                assert app._pipeline.stats == japp._pipeline.stats
                assert app._pipeline.decision["profile"]


def test_auto_declines_on_one_cuda_device(monkeypatch):
    """GRAPE_PIPELINE=1 on one CUDA device with no measured exchange_bps
    declines past every byte gate (edge cut and vertex cut), with the
    reason and the profile's label; the same fragment on the CPU
    engages as the JAX package does."""
    from tests.test_torch_mirror import OnCard
    from tests.test_torch_vertexcut import vc_frag

    monkeypatch.setenv("GRAPE_PIPELINE", "1")
    monkeypatch.setenv("GRAPE_PIPELINE_MIN_BYTES", "1")
    frag = rand_frag(4)
    kw = dict(app_name="SSSP", key="dist", fold="min")
    assert pipeline.resolve_pipeline(frag, **kw) is not None
    assert pipeline.resolve_pipeline(OnCard(frag), **kw) is None
    dec = PIPELINE_STATS["last_decision"]
    assert dec["reason"].startswith("one CUDA device")
    assert dec["profile"] in dec["reason"]
    vfrag = vc_frag(4, True)
    assert pipeline.resolve_vc2d_pipeline(vfrag, app_name="SSSPVC2D")
    assert pipeline.resolve_vc2d_pipeline(OnCard(vfrag),
                                          app_name="SSSPVC2D") is None
    assert PIPELINE_STATS["last_decision"]["reason"].startswith(
        "one CUDA device")


def test_min_hidden_floor_declines_with_the_profile(monkeypatch):
    monkeypatch.setenv("GRAPE_PIPELINE", "1")
    monkeypatch.setenv("GRAPE_PIPELINE_MIN_BYTES", "1")
    monkeypatch.setenv("GRAPE_PIPELINE_MIN_HIDDEN_US", "1e9")
    app = SSSP()
    app.init_state(rand_frag(4), source=0)
    dec = PIPELINE_STATS["last_decision"]
    assert app._pipeline is None
    assert "GRAPE_PIPELINE_MIN_HIDDEN_US" in dec["reason"]
    assert dec["plan_uid"] and "modeled_hidden_us" in dec
    assert dec["profile"] in dec["reason"]


# ---- results -------------------------------------------------------------------

def port_run(app, frag, monkeypatch, pipe, **qa):
    monkeypatch.setenv("GRAPE_PIPELINE", pipe)
    w = Worker(app, frag)
    w.query(**qa)
    return w


@pytest.mark.parametrize("exchange", ["gather", "mirror"])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc", "wcc_directed",
                                  "cdlp", "cdlp_opt"])
def test_pipelined_equals_serial_and_jax(monkeypatch, name, fnum, exchange):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    monkeypatch.setenv("GRAPE_EXCHANGE", exchange)
    app, japp, qa, directed = _pair(name)
    frag = rand_frag(fnum, directed=directed)
    serial = port_run(_pair(name)[0], frag, monkeypatch, "0", **qa)
    piped = port_run(app, frag, monkeypatch, "force", **qa)
    assert app._pipeline is not None
    assert piped.result_values().tobytes() == \
        serial.result_values().tobytes()
    assert piped.rounds == serial.rounds
    jw = JWorker(japp, jax_frag(fnum, directed))
    jw.query(**qa)
    assert japp._pipeline is not None
    assert app._pipeline.mode == japp._pipeline.mode
    np.testing.assert_array_equal(piped.result_values(), jw.result_values())
    assert piped.rounds == jw.rounds


@pytest.mark.parametrize("pipe", ["1", "force"])
def test_pagerank_declines_and_stays_serial(monkeypatch, pipe):
    from libgrape_lite_tpu.models import PageRank as JPageRank
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    monkeypatch.setenv("GRAPE_PIPELINE_MIN_BYTES", "1")
    frag = rand_frag(4)
    serial = port_run(PageRank(), frag, monkeypatch, "0")
    app = PageRank()
    w = port_run(app, frag, monkeypatch, pipe)
    assert app._pipeline is None
    reason = PIPELINE_STATS["last_decision"]["reason"]
    assert reason == ("sum fold over the K1 merge path is not bit-stable "
                      "under a split plan")
    assert w.result_values().tobytes() == serial.result_values().tobytes()
    japp = JPageRank()
    jw = JWorker(japp, jax_frag(4))
    jw.query()
    assert japp._pipeline is not None  # the JAX XLA path pipelines
    np.testing.assert_allclose(w.result_values(), jw.result_values(),
                               rtol=1e-4, atol=1e-7)


def counting_k1(monkeypatch):
    calls = []
    real = spmv.gather_reduce

    def count(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(spmv, "gather_reduce", count)
    return calls


@pytest.mark.parametrize("name,serial_k1,piped_k1", [
    ("sssp", 1, 2), ("bfs", 1, 2), ("wcc", 1, 2), ("wcc_directed", 2, 4),
    ("cdlp", 0, 0),
])
def test_k1_pulls_a_round(monkeypatch, name, serial_k1, piped_k1):
    app, _, qa, directed = _pair(name)
    frag = rand_frag(4, directed=directed)
    calls = counting_k1(monkeypatch)
    w = port_run(_pair(name)[0], frag, monkeypatch, "0", **qa)
    assert len(calls) == serial_k1 * w.rounds
    del calls[:]
    w = port_run(app, frag, monkeypatch, "force", **qa)
    assert len(calls) == piped_k1 * w.rounds


def _read_slots(frag, plan, direction):
    """[fnum, fnum * m] bool: the mirror buffer slots fragment f's real
    edges read."""
    fnum, vp = frag.fnum, frag.vp
    csrs = frag.host_ie if direction == "ie" else frag.host_oe
    read = np.zeros((fnum, fnum * plan.m), dtype=bool)
    for f in range(fnum):
        c = plan.nbr_compact[f][csrs[f].edge_mask]
        read[f, c[c >= vp] - vp] = True
    return read


@pytest.mark.parametrize("exchange", ["gather", "mirror"])
@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc", "wcc_directed",
                                  "cdlp"])
def test_poisoned_buffer_changes_nothing(monkeypatch, name, exchange):
    """Every buffer entry no other fragment reads (non-boundary rows of
    the gathered state, unread mirror slots) is overwritten with a value
    that would win any fold as each buffer is made (after PEval and at
    each kickoff), so before each pull: the result stays bit-equal, so
    remote reads touch the boundary rows only."""
    monkeypatch.setenv("GRAPE_EXCHANGE", exchange)
    app, _, qa, directed = _pair(name)
    frag = rand_frag(4, directed=directed)
    serial = port_run(_pair(name)[0], frag, monkeypatch, "0", **qa)
    dirs = ("ie", "oe") if directed else (
        ("oe",) if name == "cdlp" else ("ie",))
    bmask = boundary_split(frag, dirs).reshape(-1)
    poisoned = []
    real_exchange = pipeline.PipelinePlan.exchange

    def exchange(self, ctx, x_local, state, leg=1):
        xbuf = real_exchange(self, ctx, x_local, state, leg)
        mode = self.mode if leg == 1 else self.mode2
        if mode == "gather":
            keep = torch.from_numpy(bmask)
        else:
            d = "oe" if (leg == 2 or name == "cdlp") else "ie"
            keep = torch.from_numpy(_read_slots(
                frag, mirror.build_mirror_plan(frag, d), d))
        bad = -1 if not xbuf.is_floating_point() else float("-inf")
        xbuf = torch.where(keep, xbuf, torch.full_like(xbuf, bad))
        poisoned.append(int((~keep).sum()))
        return xbuf

    monkeypatch.setattr(pipeline.PipelinePlan, "exchange", exchange)
    w = port_run(app, frag, monkeypatch, "force", **qa)
    assert app._pipeline is not None
    assert poisoned and max(poisoned) > 0
    assert w.result_values().tobytes() == serial.result_values().tobytes()


def test_run_on_side_runs_in_place_on_the_cpu():
    x = torch.arange(6)
    out, ev = pipeline.run_on_side(lambda t: t * 2, x)
    assert ev is None and torch.equal(out, x * 2)
    pipeline.join(None)


# ---- the drills ---------------------------------------------------------------

def test_guard_halt_identity(monkeypatch):
    frag = rand_frag(2)
    serial = port_run(SSSP(), frag, monkeypatch, "0", source=0)
    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    w = Worker(SSSP(), frag)
    w.query(source=0, guard="halt")
    assert w.app._pipeline is not None
    assert w.result_values().tobytes() == serial.result_values().tobytes()
    assert not w.guard_report["breaches"]


def test_corrupt_carry_rollback_pipelined(monkeypatch, tmp_path):
    from libgrape_lite_tpu_torch.ft.faults import FaultPlan

    frag = rand_frag(2)
    serial = port_run(SSSP(), frag, monkeypatch, "0", source=0)
    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    w = Worker(SSSP(), frag)
    w.query(source=0, checkpoint_every=3,
            checkpoint_dir=str(tmp_path / "ck"), guard="rollback",
            fault_plan=FaultPlan(corrupt_carry_at=4))
    assert w.app._pipeline is not None
    assert w.result_values().tobytes() == serial.result_values().tobytes()
    rep = w.guard_report
    assert rep["rollbacks"] == 1
    assert rep["breaches"][0]["round"] == 4


def test_kill_resume_pipelined(monkeypatch, tmp_path):
    from libgrape_lite_tpu_torch.ft.faults import FaultPlan, InjectedFault

    frag = rand_frag(2)
    serial = port_run(SSSP(), frag, monkeypatch, "0", source=0)
    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    kill_dir = str(tmp_path / "kill")
    w = Worker(SSSP(), frag)
    with pytest.raises(InjectedFault):
        w.query(source=0, checkpoint_every=3, checkpoint_dir=kill_dir,
                fault_plan=FaultPlan(kill_at_superstep=4, mode="raise"))
    w2 = Worker(SSSP(), frag)
    w2.resume(kill_dir)
    assert w2.app._pipeline is not None
    assert w2.result_values().tobytes() == serial.result_values().tobytes()


def test_batched_incremental_and_dyn_keep_the_serial_round(monkeypatch):
    from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy
    from tests.test_torch_dyn import build_path

    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    frag = rand_frag(2)
    w = Worker(SSSP(), frag)
    w.query_batch([{"source": 0}, {"source": 5}])
    assert getattr(w.app, "_pipeline", None) is None
    for b, src in enumerate((0, 5)):
        seq = port_run(SSSP(), frag, monkeypatch, "0", source=src)
        assert w.batch_result_values(b).tobytes() == \
            seq.result_values().tobytes()
        monkeypatch.setenv("GRAPE_PIPELINE", "force")
    # per-lane states (no native lanes): the batch's app keeps the serial
    # round too
    wb = Worker(WCC(), frag)
    wb.query_batch([{}, {}])
    seq = port_run(WCC(), frag, monkeypatch, "0")
    assert wb.batch_result_values(1).tobytes() == \
        seq.result_values().tobytes()
    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    # a dyn overlay: declined before any plan
    dg = DynGraph(build_path(2), RepackPolicy(threshold=0.9, capacity=64))
    prev = Worker(SSSP(dtype=torch.float64), dg.fragment).query(source=0)
    dg.ingest([("a", 4, 20, 0.5)])
    wd = Worker(SSSP(dtype=torch.float64), dg.fragment)
    wd.query(source=0)
    assert wd.app._pipeline is None
    # incremental: seeded from the previous result, serial round
    wi = Worker(SSSP(dtype=torch.float64), dg.fragment)
    wi.query_incremental(prev, dg.summary(), source=0)
    assert wi.app._pipeline is None
    assert wi.result_values().tobytes() == wd.result_values().tobytes()


def test_traced_query_carries_the_brief_and_the_truth_joins(monkeypatch):
    from libgrape_lite_tpu.obs import truth as jtruth
    from libgrape_lite_tpu_torch.obs import truth
    from libgrape_lite_tpu_torch.ops import calibration as calib

    frag = rand_frag(2)
    serial = port_run(SSSP(), frag, monkeypatch, "0", source=0)
    obs.configure(in_memory=True)
    app = SSSP()
    w = port_run(app, frag, monkeypatch, "force", source=0)
    assert w.result_values().tobytes() == serial.result_values().tobytes()
    events = obs.history()
    q = [e for e in events if e.get("ph") == "X" and e["name"] == "query"]
    brief = q[-1]["args"]["pipeline"]
    assert brief == app._pipeline.span_brief()
    assert brief["engaged"] and brief["boundary_vertices"] > 0
    assert 0.0 <= brief["modeled_hidden_frac"] <= 1.0
    assert q[-1]["args"]["overlap_hidden_us"] == round(
        app._pipeline.hidden_us_per_round() * w.rounds, 1)
    rep = truth.truth_report(events)
    assert rep == jtruth.truth_report(events)
    assert rep["queries"] == 1 and rep["joined"] == 1
    row = rep["rows"][0]
    assert row["plan_uid"] == app._pipeline.uid == brief["plan_uid"]
    assert row["measured_round_us"] > 0 and row["claim_frac"] is not None
    blk = truth.block_brief(rep)
    assert blk == jtruth.block_brief(rep)
    assert truth.harvest_report(rep, brief) == 0  # disarmed
    monkeypatch.setenv("GRAPE_CALIBRATE_HARVEST", "1")
    calib.reset_harvest()
    assert truth.harvest_report(rep, brief) == 1
    sample = calib.harvested_samples()[-1]
    assert sample["surface"] == "overlap"
    assert sample["plan_uid"] == brief["plan_uid"]
    assert sample["ops"] == (brief["boundary_edges"]
                             + brief["interior_edges"]) * \
        row["rounds_measured"]
    calib.reset_harvest()


def test_ledger_carries_the_split(monkeypatch):
    frag = rand_frag(2)
    w = port_run(SSSP(), frag, monkeypatch, "force", source=0)
    led = w.pack_ledger()
    p = led["pipeline"]
    assert p["mode"] == "gather" and p["exchange_bytes"] > 0
    assert p["boundary_vertices"] == \
        w.app._pipeline.stats["totals"]["boundary_vertices"]
    assert led["totals"]["gather_rows"] > 0
    serial = port_run(SSSP(), frag, monkeypatch, "0", source=0)
    assert "pipeline" not in serial.pack_ledger()


def test_federation_demands_pipeline():
    from libgrape_lite_tpu.obs import federation as jfed
    from libgrape_lite_tpu_torch.obs import federation

    assert federation.EXPECTED["pipeline"] == \
        "libgrape_lite_tpu_torch.parallel.pipeline"
    assert federation.self_check() == []
    assert set(federation.snapshot("pipeline")) == set(
        jfed.snapshot("pipeline"))
    PIPELINE_STATS["declined"] += 1
    federation.reset("pipeline")
    assert PIPELINE_STATS["declined"] == 0


def test_placed_streams_are_built_once(monkeypatch):
    from libgrape_lite_tpu_torch.fragment import edgecut

    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    frag = rand_frag(4)
    SSSP().init_state(frag, source=0)
    fills = edgecut.DEVICE_CACHE_FILLS
    SSSP().init_state(frag, source=7)
    assert edgecut.DEVICE_CACHE_FILLS == fills
    frag.release_device()
    frag.restore_device()
    SSSP().init_state(frag, source=7)
    assert edgecut.DEVICE_CACHE_FILLS > fills


# ---- the vertex cut -----------------------------------------------------------

@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc"])
def test_vc_pipelined_equals_serial_and_jax(monkeypatch, name):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker
    from tests.test_torch_vertexcut import (
        APPS,
        jax_apps,
        jax_vc_frag,
        vc_frag,
    )

    vc_cls, _, kw, weighted = APPS[name]
    frag = vc_frag(4, weighted)
    serial = port_run(vc_cls(), frag, monkeypatch, "0", **kw)
    app = vc_cls()
    piped = port_run(app, frag, monkeypatch, "force", **kw)
    assert app._pipeline is not None and app._pipeline.mode == "vc2d"
    assert piped.result_values().tobytes() == \
        serial.result_values().tobytes()
    assert piped.rounds == serial.rounds
    japp = jax_apps(name)[0]
    jw = JWorker(japp, jax_vc_frag(4, weighted))
    jw.query(**kw)
    assert japp._pipeline is not None
    assert app._pipeline.uid == japp._pipeline.uid
    assert app._pipeline.stats == japp._pipeline.stats
    assert piped.result_values().tobytes() == \
        np.asarray(jw.result_values()).tobytes()


@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc"])
def test_vc_pipelined_at_fnum_9(monkeypatch, name):
    from tests.test_torch_vertexcut import APPS, vc_frag

    vc_cls, _, kw, weighted = APPS[name]
    frag = vc_frag(9, weighted)
    serial = port_run(vc_cls(), frag, monkeypatch, "0", **kw)
    calls = counting_k1(monkeypatch)
    app = vc_cls()
    piped = port_run(app, frag, monkeypatch, "force", **kw)
    assert app._pipeline is not None
    assert len(calls) == 2 * piped.rounds
    assert piped.result_values().tobytes() == \
        serial.result_values().tobytes()


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("pipe", ["0", "1", "force"])
def test_vc_decisions_equal_jax(monkeypatch, fnum, pipe):
    from libgrape_lite_tpu.parallel.pipeline import (
        PIPELINE_STATS as JSTATS,
    )
    from tests.test_torch_vertexcut import (
        APPS,
        jax_apps,
        jax_vc_frag,
        vc_frag,
    )

    monkeypatch.setenv("GRAPE_PIPELINE", pipe)
    for name in ("sssp", "bfs", "wcc"):
        vc_cls, _, kw, weighted = APPS[name]
        app, japp = vc_cls(), jax_apps(name)[0]
        app.init_state(vc_frag(fnum, weighted), **kw)
        japp.init_state(jax_vc_frag(fnum, weighted), **kw)
        got = dict(PIPELINE_STATS["last_decision"])
        want = dict(JSTATS["last_decision"])
        # the modeled µs are each package's rate profile's; present
        # alike, with the profile label
        for dec in (got, want):
            dec.pop("profile")
            assert (dec.pop("modeled_hidden_us", None) is None) == (
                pipe == "0" or fnum == 1)
        assert got == want, (name, pipe)


def test_vc_src_pull_declines(monkeypatch):
    from tests.test_torch_vertexcut import vc_frag
    from libgrape_lite_tpu_torch.models import WCCVC2D

    monkeypatch.setenv("GRAPE_PIPELINE", "force")
    app = WCCVC2D()
    app.init_state(vc_frag(4, False, symmetrize=False, directed=True))
    assert app._pipeline is None
    assert "src-pull" in PIPELINE_STATS["last_decision"]["reason"]
