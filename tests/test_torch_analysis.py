"""grape-lint over the port (`libgrape_lite_tpu_torch/analysis/`) against
the JAX package's `analysis/`, on the CPU.

* Parity per carried rule (R4, R5, R6, R7, R8, R9, R10, R12): each trip
  and pass fixture of the JAX tests goes through the JAX `lint_source`
  and, with the package name in its text and path rewritten, the port's;
  the sets of (rule, line, symbol) are equal, and the rule trips where
  the fixture says.  R6 judges each package against its own window
  contract: the JAX pass fixtures that name JAX-only reads (the pack
  sub-plan streams, PageRank's `round_update`) pass in the port with the
  port's names in their place.  The port alone: R7's PyTorch forcers,
  and a `FederatedStats` that always registers.
* The baseline (round trip, budget, stale entry, no entry without a
  reason), the report schema (valid, drift caught, the JAX record's
  keys), the self-lint gate over `libgrape_lite_tpu_torch`, and the `lint`
  CLI's exit codes 0, 1 (a fixture of each rule), 2 and 3.
* A3 on the CPU: zero build events over the warmed matrix; a leaking plan
  cache caught; `build_events()` counting one real strict-plan build and
  each device-cache fill, a refill under the same key too.
* The federation: with every owner imported, the port registers the JAX
  namespaces but `gang`, and `self_check()` passes.
"""

import json
import re
import textwrap

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.analysis.astlint import lint_source as jlint_source
from libgrape_lite_tpu_torch import analysis
from libgrape_lite_tpu_torch.analysis import artifact
from libgrape_lite_tpu_torch.analysis.astlint import lint_source
from libgrape_lite_tpu_torch.cli import lint_main

torch.set_num_threads(1)

CARRIED = ("R4", "R5", "R6", "R7", "R8", "R9", "R10", "R12")

_PUMP = "libgrape_lite_tpu/serve/pipeline.py"
_SESSION = "libgrape_lite_tpu/serve/session.py"
_QUEUE = "libgrape_lite_tpu/serve/queue.py"
_THING = "libgrape_lite_tpu/ops/thing.py"
_MOD = "libgrape_lite_tpu/m.py"
_PIPE = "libgrape_lite_tpu/parallel/pipe.py"

# (id, rule, JAX path, source, trips): the JAX tests' fixtures
# (tests/test_analysis.py, tests/test_calibration.py's R10)
FIXTURES = [
    ("r4_entry_skips_dyn_view", "R4", "fixture.py", """
    class Worker:
        def _check_dyn_view(self):
            pass

        def query(self, source=0):
            from libgrape_lite_tpu.guard.config import GuardConfig
            cfg = GuardConfig.resolve(None)
            return cfg
    """, True),
    ("r4_transitive_self_calls", "R4", "fixture.py", """
    class Worker:
        def _check_dyn_view(self):
            pass

        def query(self, source=0):
            from libgrape_lite_tpu.guard.config import GuardConfig
            self._check_dyn_view()
            cfg = GuardConfig.resolve(None)
            return cfg

        def query_incremental(self, prev):
            return self.query()
    """, False),
    ("r4_entry_skips_guard_resolve", "R4", "fixture.py", """
    class Worker:
        def _check_dyn_view(self):
            pass

        def query_batch(self, lanes):
            self._check_dyn_view()
            return lanes
    """, True),
    ("r4_dispatch_skips_ensure", "R4", "fixture.py", """
    class Session:
        def _ensure_dyn_view(self, app_key, w):
            pass

        def _dispatch(self, batch):
            return [w.query() for w in batch]
    """, True),
    ("r5_eager_vlog", "R5", "fixture.py", """
    from libgrape_lite_tpu.utils import logging as glog

    def run(r, dt):
        glog.vlog(1, f"round {r}: {dt:.6f}s")
    """, True),
    ("r5_concat_vlog", "R5", "fixture.py", """
    from libgrape_lite_tpu.utils import logging as glog

    def run(r):
        glog.vlog(1, "round " + str(r))
    """, True),
    ("r5_lazy_vlog", "R5", "fixture.py", """
    from libgrape_lite_tpu.utils import logging as glog

    def run(r, dt):
        glog.vlog(1, "round %d: %.6fs", r, dt)
    """, False),
    ("r5_bool_blind_schema", "R5", "fixture.py", """
    def validate_record(record):
        errors = []
        for k, v in record.items():
            if not isinstance(v, (int, float)):
                errors.append(k)
        return errors
    """, True),
    ("r5_bool_rejected", "R5", "fixture.py", """
    def validate_record(record):
        errors = []
        for k, v in record.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                errors.append(k)
        return errors
    """, False),
    ("r6_unnamed_window_read", "R6", "fixture.py", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        new_b = state["dist"] + 1
        xbuf2 = self._pipeline.kickoff(ctx, new_b, state)
        fr = state["frontier"]
        return {"dist": new_b + fr}, 1, xbuf2
    """, True),
    ("r6_pre_kickoff_alias_read", "R6", "fixture.py", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        shadow = state["scratch"]
        xbuf2 = self._pipeline.kickoff(ctx, state["dist"], state)
        return {"dist": shadow}, 1, xbuf2
    """, True),
    ("r6_nested_closure_read", "R6", "fixture.py", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        def helper():
            return state["frontier"]
        pre = state["dist"]
        xbuf2 = self._pipeline.kickoff(ctx, pre, state)
        return {"dist": helper()}, 1, xbuf2
    """, True),
    ("r6_whole_carry_escape", "R6", "fixture.py", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        new_b = state["dist"] + 1
        xbuf2 = self._pipeline.kickoff(ctx, new_b, state)
        out = self.mystery_fold(frag, state)
        return {"dist": out}, 1, xbuf2
    """, True),
    ("r6_non_dict_params", "R6", "fixture.py", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        xbuf2 = self._pipeline.kickoff(ctx, state["dist"], state)
        deg = self.degree_of(frag, ctx)
        return {"dist": state["dist"] + deg}, 1, xbuf2
    """, False),
    ("r6_reads_before_kickoff_are_free", "R6", "fixture.py", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        pre = state["unnamed_leaf"] + state["another_one"]
        xbuf2 = self._pipeline.kickoff(ctx, pre, state)
        return {"dist": pre}, 1, xbuf2
    """, False),
    ("r6_no_kickoff", "R6", "fixture.py", """
    def inceval(self, ctx, frag, state):
        return {"dist": state["dist"] + state["frontier"]}, 1
    """, False),
    ("r7_asarray_in_dispatch", "R7", _PUMP, """
    import numpy as np

    class Pump:
        def _fill(self, force=False):
            self._dispatch(self.queue.pop())

        def _dispatch(self, batch):
            out, rounds, active = self.runner(batch)
            return np.asarray(rounds)
    """, True),
    ("r7_int_of_device_value", "R7", _PUMP, """
    class Pump:
        def _dispatch_stage(self, batch):
            d = self.worker.dispatch(batch)
            return int(d.rounds[0])
    """, True),
    ("r7_session_may_sync", "R7", _SESSION, """
    import numpy as np

    class Session:
        def _dispatch(self, batch):
            return np.asarray(self.runner(batch))
    """, False),
    ("r7_same_code_in_the_pump", "R7", _PUMP, """
    import numpy as np

    class Session:
        def _dispatch(self, batch):
            return np.asarray(self.runner(batch))
    """, True),
    ("r7_harvest_contract", "R7", _PUMP, """
    import jax
    import numpy as np

    class Pump:
        def _fill(self, force=False):
            self._dispatch_stage(self.queue.pop())

        def _dispatch_stage(self, batch):
            return self._run_declined(batch)

        def _run_declined(self, batch):
            return jax.block_until_ready(self.session._dispatch(batch))

        def _harvest_head(self, pb):
            return np.asarray(pb.rounds)
    """, False),
    ("r7_nested_thunk", "R7", _PUMP, """
    class Pump:
        def _dispatch_stage(self, batch):
            d = self.worker.dispatch(batch)
            return lambda: int(d.rounds[0])
    """, False),
    ("r8_hand_rolled_dict", "R8", _THING, """
    THING_STATS = {"planned": 0, "declines": []}

    def plan():
        THING_STATS["planned"] += 1
    """, True),
    ("r8_ad_hoc_class", "R8", _THING, """
    class _Stats:
        def snapshot(self):
            return {}

    THING_STATS = _Stats()
    """, True),
    ("r8_ctor_under_alias", "R8", _THING, """
    from libgrape_lite_tpu.obs.federation import FederatedStats as _FedStats

    THING_STATS = _FedStats("thing", {"planned": 0})
    """, False),
    ("r8_register_via_module_alias", "R8", _THING, """
    from libgrape_lite_tpu.obs import federation as _federation

    class _Stats:
        def snapshot(self):
            return {}

    THING_STATS = _Stats()
    _federation.register("thing", THING_STATS.snapshot, None,
                         module=__name__)
    """, False),
    ("r8_lazy_register", "R8", _THING, """
    THING_STATS = {"planned": 0}

    def _wire():
        from libgrape_lite_tpu.obs.federation import register
        register("thing", lambda: dict(THING_STATS), None)

    _wire()
    """, False),
    ("r8_federation_exempt", "R8", "libgrape_lite_tpu/obs/federation.py", """
    SLO_STATS = {"observed": 0}
    """, False),
    ("r8_other_obs_module", "R8", "libgrape_lite_tpu/obs/other.py", """
    SLO_STATS = {"observed": 0}
    """, True),
    ("r9_incomplete_lookup", "R9", _SESSION, """
    def probe(cache, compat, src_id):
        return cache.lookup(compat, src_id, 0)
    """, True),
    ("r9_store_missing_fence", "R9", _QUEUE, """
    def deliver(self, compat, source, res):
        self.result_cache.store(compat, source, res)
    """, True),
    ("r9_starred_key", "R9", _QUEUE, """
    def deliver(self, req, res):
        meta = self.cache_meta(req)
        fence = self.cache_epoch()
        self.result_cache.store(*meta, fence, res)
    """, True),
    ("r9_full_positional_key", "R9", _SESSION, """
    def probe(cache, compat, source, fence):
        return cache.lookup(compat, source, fence)
    """, False),
    ("r9_keyword_and_synonyms", "R9", _QUEUE, """
    def deliver(self, ck, s, res):
        self.result_cache.store(compat=ck, source=s,
                                fence=self.epoch(), result=res)

    def probe(self, cache, compat, source):
        return cache.lookup(compat, source, self._ingest_epoch)
    """, False),
    ("r9_non_cache_receiver", "R9", _SESSION, """
    def resolve(registry, compat, src_id):
        return registry.lookup(compat, src_id)
    """, False),
    ("r9_other_module", "R9", "libgrape_lite_tpu/serve/other.py", """
    def _evict(self, compat, src_id):
        self._entries.cache.lookup(compat, src_id, 0)
    """, True),
    ("r9_cache_module_exempt", "R9", "libgrape_lite_tpu/autopilot/cache.py",
     """
    def _evict(self, compat, src_id):
        self._entries.cache.lookup(compat, src_id, 0)
    """, False),
    ("r10_pinned_bps", "R10", "libgrape_lite_tpu/some/module.py", """
    HBM_BPS = 819e9
    """, True),
    ("r10_table_and_annotated", "R10", _MOD, """
    _GATHER_RATES = {'row': 128.0}
    CLOCK_HZ: float = 940e6
    """, True),
    ("r10_literal_expression", "R10", _MOD, """
    ICI_BPS = 2 * 45e9
    """, True),
    ("r10_profile_read", "R10", _MOD, """
    from libgrape_lite_tpu.ops.calibration import default_profile
    HBM_BPS = default_profile().hbm_bps
    CLOCK_HZ = default_profile().clock_hz
    """, False),
    ("r10_op_counts_are_no_rates", "R10", _MOD, """
    DEFAULT_OPS_PER_EDGE = 30.0
    _ITEM_VPU_PLANES = 6
    """, False),
    ("r10_calibration_home", "R10", "libgrape_lite_tpu/ops/calibration.py",
     """
    HBM_BPS = 819e9
    """, False),
    ("r12_unkeyed_literal", "R12", _PIPE, """
    def span_brief():
        return {"engaged": True, "hidden_us_per_round": 12.5}
    """, True),
    ("r12_plan_uid", "R12", _PIPE, """
    def span_brief():
        return {
            "engaged": True,
            "hidden_us_per_round": 12.5,
            "plan_uid": "gather:2:128",
        }
    """, False),
    ("r12_decision_record", "R12", _PIPE, """
    def decide(plan):
        dec = {"engaged": False}
        dec["modeled_exchange_us"] = plan.cost()
        return dec
    """, True),
    ("r12_subscript_supplies_key", "R12", _PIPE, """
    def decide(plan):
        dec = {"engaged": False}
        dec["modeled_exchange_us"] = plan.cost()
        dec["plan_uid"] = plan.uid
        return dec
    """, False),
    ("r12_trace_key", "R12", "libgrape_lite_tpu/models/m.py", """
    REC = {"engaged": True, "modeled_round_us": 3.0, "trace_key": "t"}
    """, False),
    ("r12_unengaged_cost_table", "R12", "libgrape_lite_tpu/models/m.py", """
    COSTS = {"modeled_round_us": 3.0, "hidden_us_per_round": 1.0}
    """, False),
]

_PKG = re.compile(r"\blibgrape_lite_tpu\b")


def _port(text: str) -> str:
    return _PKG.sub("libgrape_lite_tpu_torch", text)


def _keys(findings):
    return {(f.rule, f.line, f.symbol) for f in findings
            if f.rule in CARRIED}


@pytest.mark.parametrize("fid,rule,path,src,trips", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_rule_parity_with_jax(fid, rule, path, src, trips):
    src = textwrap.dedent(src)
    jax_found = _keys(jlint_source(src, path))
    port_found = _keys(lint_source(_port(src), _port(path)))
    assert port_found == jax_found, (port_found, jax_found)
    assert (rule in {r for r, _, _ in port_found}) == trips, port_found


def test_catalogue_carries_the_named_rules():
    from libgrape_lite_tpu.analysis.rules import RULES as JRULES

    assert set(analysis.RULES) == set(CARRIED) | {"A3"}
    for rid, rule in analysis.RULES.items():
        assert rule.slug == JRULES[rid].slug and rule.history
    for gone in ("R1", "R2", "R3", "R11", "A1", "A2"):
        assert gone not in analysis.RULES


# R6's JAX pass fixtures that name JAX-only reads, and their port form:
# the same window with the port's contract names in place of the pack
# sub-plan stream (pki_*) and of the pack / PageRank callees
R6_RENAMED = [
    ("r6_contract_named_reads", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        dist = state["dist"]
        xbuf2 = self._pipeline.kickoff(ctx, dist, state)
        cand = state["pl_i_nbr"] + state["pki_l0_rows"]
        new = cand * state["pl_bmask"] + dist
        return {"dist": new}, 1, xbuf2
    """, {"pki_l0_rows": "pl_i_indptr"}),
    ("r6_audited_callees", """
    def inceval_pipelined(self, ctx, frag, state, xbuf):
        def pack_fold(dispatch, table):
            return dispatch.reduce(table, state, "min")
        full = self._pipeline.splice(ctx, state["rank"], state, xbuf)
        xbuf2 = self._pipeline.kickoff(ctx, state["rank"], state)
        cur = pack_fold(self._pipeline.pack_i, full)
        st2, active = self.round_update(frag, state, cur)
        return st2, active, xbuf2
    """, {"dispatch.reduce(table, state":
          "self._pipeline.kickoff(ctx, table, state",
          "self.round_update(frag, state, cur)":
          "self._pipeline.kickoff(ctx, cur, state, leg=2), 1",
          '"rank"': '"comp"'}),
]


@pytest.mark.parametrize("fid,src,renames", R6_RENAMED,
                         ids=[r[0] for r in R6_RENAMED])
def test_r6_pass_fixtures_in_the_port_contract(fid, src, renames):
    src = textwrap.dedent(src)
    assert not [f for f in jlint_source(src, "fixture.py")
                if f.rule == "R6"]
    port = src
    for old, new in renames.items():
        port = port.replace(old, new)
    assert port != src
    assert not [f for f in lint_source(port, "fixture.py")
                if f.rule == "R6"]
    # the JAX names are not in the port's contract: the JAX text trips
    assert [f for f in lint_source(src, "fixture.py") if f.rule == "R6"]


def test_r6_trips_on_an_unnamed_read_in_a_port_round():
    """A read the port's contract does not name, added after the kickoff
    of the port's pipelined min round (SSSP's, BFS's and WCC's,
    `AppBase.pipelined_min_round`), trips R6 there."""
    import inspect

    from libgrape_lite_tpu_torch.app import base

    src = inspect.getsource(base)
    assert not [f for f in lint_source(src, "app/base.py")
                if f.rule == "R6"]
    bad = src.replace('state["pl_i_indptr"], state["pl_i_nbr"]',
                      'state["wf_eff"], state["pl_i_nbr"]')
    assert bad != src
    found = [f for f in lint_source(bad, "app/base.py") if f.rule == "R6"]
    assert [f.symbol for f in found] == ["AppBase.pipelined_min_round"]


# ---- the port alone --------------------------------------------------------

_PORT_PUMP = "libgrape_lite_tpu_torch/serve/pipeline.py"

TORCH_FORCERS = [
    ("cpu", "return d.rounds.cpu()"),
    ("numpy", "return d.rounds.numpy()"),
    ("cuda_synchronize", "torch.cuda.synchronize()"),
    ("event_synchronize", "self._done.synchronize()"),
]


@pytest.mark.parametrize("name,line", TORCH_FORCERS,
                         ids=[t[0] for t in TORCH_FORCERS])
def test_r7_torch_forcers_trip_in_the_port_alone(name, line):
    src = textwrap.dedent(f"""
    import torch

    class Pump:
        def _fill(self):
            self._dispatch_stage(self.queue.pop())

        def _dispatch_stage(self, batch):
            d = self.worker.dispatch(batch)
            {line}
    """)
    port = [f for f in lint_source(src, _PORT_PUMP) if f.rule == "R7"]
    assert [f.symbol for f in port] == ["Pump._dispatch_stage"]
    assert not [f for f in jlint_source(src, _PUMP) if f.rule == "R7"]
    # the same call in a harvest-contract method is the audited stage
    harvest = src.replace("_dispatch_stage", "_harvest_head")
    assert not [f for f in lint_source(harvest, _PORT_PUMP)
                if f.rule == "R7"]


def test_federated_stats_always_registers():
    """R8 passes every `FederatedStats(...)`: it has no switch to skip
    the registry, so building one federates it under its owner."""
    from libgrape_lite_tpu_torch.obs import federation

    with pytest.raises(TypeError):
        federation.FederatedStats("lint_probe", {"n": 0}, register_=False)
    try:
        stats = federation.FederatedStats("lint_probe", {"n": 0})
        stats["n"] += 1
        assert federation.snapshot("lint_probe") == {"n": 1}
        assert federation._REGISTRY["lint_probe"]["module"] == __name__
        federation.reset("lint_probe")
        assert stats == {"n": 0}
    finally:
        federation._REGISTRY.pop("lint_probe", None)


def test_pump_harvest_contract_names_real_methods():
    from libgrape_lite_tpu.serve.pipeline import (
        PUMP_HARVEST_SYNCS as JSYNCS,
    )
    from libgrape_lite_tpu_torch.serve.pipeline import (
        PUMP_HARVEST_SYNCS,
        AsyncServePump,
    )

    assert PUMP_HARVEST_SYNCS <= JSYNCS
    for name in PUMP_HARVEST_SYNCS:
        assert callable(getattr(AsyncServePump, name)), name


# ---- the baseline ----------------------------------------------------------

_EAGER = """
from libgrape_lite_tpu_torch.utils import logging as glog

def run(r):
    glog.vlog(1, f"round {r}")
"""


def test_baseline_suppression_roundtrip(tmp_path):
    findings = lint_source(_EAGER, "mod.py")
    assert [f.rule for f in findings] == ["R5"]
    f = findings[0]
    bl = analysis.Baseline(entries={}, path=str(tmp_path / "b.json"))
    with pytest.raises(ValueError):
        bl.add(f, "")  # reasons are mandatory
    bl.add(f, "test exception")
    bl.save()
    loaded = analysis.Baseline.load(str(tmp_path / "b.json"))
    assert loaded.suppresses(f)
    live, quiet = analysis.split_by_baseline(findings, loaded)
    assert live == [] and quiet == [f]
    # line-stable: two lines down, the same entry suppresses
    shifted = lint_source("\n\n" + _EAGER, "mod.py")
    assert loaded.suppresses(shifted[0]) and shifted[0].line != f.line
    # an entry pins its rule
    assert not loaded.suppresses(
        analysis.Finding("R9", f.path, f.line, f.symbol, f.message))
    # the fingerprint is the JAX package's for the same finding
    from libgrape_lite_tpu.analysis.report import Finding as JFinding

    assert JFinding(f.rule, f.path, f.line, f.symbol,
                    f.message).fingerprint == f.fingerprint


def test_baseline_budget_blocks_a_second_identical_finding(tmp_path):
    two = _EAGER + '    glog.vlog(1, f"round again {r}")\n'
    f1 = lint_source(_EAGER, "mod.py")
    f2 = lint_source(two, "mod.py")
    assert len(f2) == 2 and f2[0].fingerprint == f2[1].fingerprint
    bl = analysis.Baseline(entries={}, path=str(tmp_path / "b.json"))
    bl.add(f1[0], "known exception")
    live, quiet = analysis.split_by_baseline(f2, bl)
    assert len(live) == 1 and len(quiet) == 1
    bl.add(f2[1], "second instance, also fine")
    live2, quiet2 = analysis.split_by_baseline(f2, bl)
    assert live2 == [] and len(quiet2) == 2
    entry = bl.entries[f2[0].fingerprint]
    assert entry["count"] == 2
    assert "known exception" in entry["reason"]
    assert "second instance, also fine" in entry["reason"]


def test_stale_baseline_entry_fails_the_default_scope(tmp_path):
    shipped = analysis.Baseline.load(None)
    bl_path = str(tmp_path / "b.json")
    shipped.path = bl_path
    shipped.save()
    report, rc = analysis.run_lint(baseline_path=bl_path)
    assert rc == 0 and report["stale"] == []
    ghost = analysis.Finding(
        "R9", "libgrape_lite_tpu_torch/serve/queue.py", 1, "store",
        "ghost defect that was fixed long ago")
    shipped.add(ghost, "entry for a finding that no longer exists")
    shipped.save()
    report, rc = analysis.run_lint(baseline_path=bl_path)
    assert rc == 1 and not report["ok"]
    assert [s["fingerprint"] for s in report["stale"]] == [ghost.fingerprint]
    assert report["stale"][0]["unused"] == 1
    assert analysis.validate_lint_report(report) == []
    txt = analysis.render_text([], [], report["stale"])
    assert "stale baseline entry" in txt and ghost.fingerprint in txt
    # a sub-tree scope proves nothing about tree-wide entries
    scoped, rc2 = analysis.run_lint([str(tmp_path)], baseline_path=bl_path)
    assert rc2 == 0 and scoped["stale"] == []


def test_baseline_rejects_entries_without_a_reason(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"version": 1, "suppressions": [
        {"fingerprint": "abc", "rule": "R5"}]}))
    with pytest.raises(ValueError, match="named"):
        analysis.Baseline.load(str(p))


def test_shipped_baseline_names_every_reason():
    doc = json.load(open(analysis.DEFAULT_BASELINE))
    assert doc["version"] == 1
    for e in doc["suppressions"]:
        assert e.get("reason"), e


# ---- the report ------------------------------------------------------------


def test_report_schema_valid_drift_caught_and_jax_keys(tmp_path):
    from libgrape_lite_tpu import analysis as janalysis

    report, rc = analysis.run_lint()
    assert analysis.validate_lint_report(report) == []
    bad = dict(report, surprise=1)
    assert any("surprise" in e for e in analysis.validate_lint_report(bad))
    bad2 = dict(report, suppressed=True)
    assert any("bool" in e for e in analysis.validate_lint_report(bad2))
    jrep, _ = janalysis.run_lint([str(tmp_path)])
    assert set(jrep) == set(report)


def test_self_lint_gate_zero_unsuppressed_findings():
    report, rc = analysis.run_lint()
    live = [f for f in report["findings"] if not f["suppressed"]]
    assert rc == 0 and live == [] and report["stale"] == [], live


# ---- the CLI ---------------------------------------------------------------

_TRIPS = {}
for _fid, _rule, _path, _src, _trips in FIXTURES:
    if _trips and _rule not in _TRIPS:
        _TRIPS[_rule] = (_port(_path), textwrap.dedent(_port(_src)))


@pytest.mark.parametrize("rule", CARRIED)
def test_cli_lint_exits_1_naming_each_rule(rule, tmp_path, capsys):
    relpath, src = _TRIPS[rule]
    f = tmp_path / relpath
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    assert lint_main([str(f), "--json"]) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["counts"].get(rule, 0) >= 1 and not rec["ok"]
    assert analysis.validate_lint_report(rec) == []
    assert lint_main([str(f)]) == 1
    assert f"[{rule}]" in capsys.readouterr().out


def test_cli_lint_exit_codes(tmp_path, capsys, monkeypatch):
    assert lint_main([]) == 0
    assert "grape-lint: clean" in capsys.readouterr().out
    assert lint_main(["--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    # a mistyped path fails the gate, never lints nothing
    assert lint_main([str(tmp_path / "no_such_dir")]) == 2
    # an empty reason is a usage error, not a plain lint run
    assert lint_main(["--update-baseline", ""]) == 2
    # --update-baseline writes named suppressions, and they then hold
    bad = tmp_path / "seeded.py"
    bad.write_text(_EAGER)
    bl = tmp_path / "b.json"
    assert lint_main([str(bad), "--update-baseline", "fixture",
                      "--baseline", str(bl)]) == 0
    assert json.load(open(bl))["suppressions"][0]["reason"] == "fixture"
    assert lint_main([str(bad), "--baseline", str(bl)]) == 0
    capsys.readouterr()
    # a record that drifts from its schema exits 3, after printing it
    real = analysis.build_report
    monkeypatch.setattr(analysis, "build_report",
                        lambda *a, **k: dict(real(*a, **k), surprise=1))
    assert lint_main(["--json"]) == 3
    out, err = capsys.readouterr()
    assert json.loads(out)["surprise"] == 1 and "surprise" in err


def test_grape_lint_script_is_the_cli():
    from libgrape_lite_tpu_torch.scripts import grape_lint

    assert grape_lint.lint_main is lint_main


# ---- A3: the warm matrix under build_events --------------------------------


def _fragment():
    return artifact._default_fragment(device="cpu")


def test_warm_matrix_builds_nothing_on_the_cpu():
    findings, info = artifact.warm_matrix_audit(_fragment())
    assert findings == [], [f.message for f in findings]
    assert info["unexpected_builds"] == 0 and info["device"] == "cpu"
    assert [(c["app"], c["mode"]) for c in info["cells"]] == [
        (a, m) for a in artifact.MATRIX_APPS for m in artifact.MATRIX_MODES]
    assert all(c["events"] == dict.fromkeys(artifact.BUILD_KINDS, 0)
               for c in info["cells"])


def test_cli_artifact_audit_on_the_cpu(capsys):
    assert lint_main(["--artifact", "--device", "cpu", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert analysis.validate_lint_report(rec) == []
    audit = rec["artifact"]["build_audit"]
    assert len(audit["cells"]) == 8 and audit["unexpected_builds"] == 0


def test_leaking_plan_cache_is_caught_as_a3(monkeypatch):
    from libgrape_lite_tpu_torch.models.sssp import SSSP
    from libgrape_lite_tpu_torch.ops import spmv

    init_state = SSSP.init_state

    def planning_init_state(self, frag, **query_args):
        # an sssp that asks for a strict plan every query
        spmv.plan_for_app(frag, frag.vp, torch.float32, mode="strict")
        return init_state(self, frag, **query_args)

    monkeypatch.setattr(SSSP, "init_state", planning_init_state)
    frag = _fragment()
    findings, info = artifact.warm_matrix_audit(frag)
    assert findings == []  # the plan cache holds: a warmed query plans none

    class Forgetful(dict):
        """A plan cache that keeps nothing."""

        def setdefault(self, key, default=None):
            return {}

        def __getitem__(self, key):
            return {}

    monkeypatch.setattr(spmv, "_PLAN_CACHE", Forgetful())
    findings, info = artifact.warm_matrix_audit(frag)
    assert {f.rule for f in findings} == {"A3"}
    assert sorted(f.symbol for f in findings) == sorted(
        f"sssp.{m}" for m in artifact.MATRIX_MODES)
    for c in info["cells"]:
        assert c["events"]["plans"] == (c["builds"] if c["app"] == "sssp"
                                        else 0)
        assert (c["builds"] > 0) == (c["app"] == "sssp")


def test_build_events_count_each_kind():
    from libgrape_lite_tpu_torch.models import auto_apps
    from libgrape_lite_tpu_torch.models.exchange_base import dest_degree
    from libgrape_lite_tpu_torch.ops import spmv

    frag = _fragment()
    with artifact.build_events() as ev:
        assert spmv.plan_for_app(frag, frag.vp, torch.float32,
                                 mode="strict") is not None
    assert ev.events == {"library_loads": 0, "plans": 1,
                         "device_caches": 0} and ev.builds == 1
    with artifact.build_events() as ev:
        spmv.plan_for_app(frag, frag.vp, torch.float32, mode="strict")
    assert ev.builds == 0
    with artifact.build_events() as ev:
        for _ in range(2):
            auto_apps.push_csr(frag, "oe", torch.float32)
            dest_degree(frag)
    assert ev.events["device_caches"] == 2 and ev.builds == 2
    # a cache that forgets and refills under the same key keeps its size
    # but counts every fill
    key = ("oe", torch.float32)
    with artifact.build_events() as ev:
        for _ in range(3):
            del auto_apps._PUSH[frag][key]
            auto_apps.push_csr(frag, *key)
    assert ev.events["device_caches"] == 3


# ---- the federation --------------------------------------------------------


def test_federation_holds_the_jax_namespaces_and_self_checks():
    from libgrape_lite_tpu.obs import federation as jfederation

    from libgrape_lite_tpu_torch.obs import federation

    assert jfederation.self_check() == []
    assert federation.self_check() == []
    wanted = set(jfederation.registered())
    assert {"plan", "spgemm", "partition", "vc_tiles", "calibration",
            "pipeline"} <= wanted
    assert wanted <= set(federation.registered())
    for ns in wanted:
        assert set(federation.snapshot(ns)) <= set(
            jfederation.snapshot(ns)) | {"rebalance"}, ns
    json.dumps(federation.snapshot())
    # mutation sites keep the dict idiom
    from libgrape_lite_tpu_torch.serve.batch import GUARDED_BATCH_STATS

    GUARDED_BATCH_STATS["batches"] += 1
    assert federation.snapshot("guarded_batch")["batches"] >= 1
    federation.reset("guarded_batch")
    assert GUARDED_BATCH_STATS["batches"] == 0


def test_the_tree_has_no_unfederated_stats():
    """R8 over every owner the federation expects, and the JAX linter
    agrees that only the federation module's name differs."""
    import os

    from libgrape_lite_tpu_torch.obs.federation import EXPECTED

    root = analysis.repo_root()
    for owner in EXPECTED.values():
        rel = owner.replace(".", "/") + ".py"
        src = open(os.path.join(root, rel)).read()
        assert not [f for f in lint_source(src, rel) if f.rule == "R8"], rel
        # the JAX R8 looks for its own federation module: renamed, the
        # port's owner passes it too
        jsrc = src.replace("libgrape_lite_tpu_torch", "libgrape_lite_tpu")
        assert not [f for f in jlint_source(jsrc, rel) if f.rule == "R8"], \
            rel


def test_default_fragment_is_the_jax_audit_graph():
    from libgrape_lite_tpu.analysis.artifact import (
        _default_fragment as jdefault,
    )

    frag, jfrag = _fragment(), jdefault()
    assert (frag.fnum, frag.vp) == (jfrag.fnum, jfrag.vp)
    np.testing.assert_array_equal(
        frag.host_ie[0].edge_src, np.asarray(jfrag.host_ie[0].edge_src))
