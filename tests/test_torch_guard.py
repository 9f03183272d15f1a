"""The port's guard/ (`libgrape_lite_tpu_torch/guard/`) on the CPU, held
against the JAX package's.

* `carry_digest`'s `digest_hex` equals the JAX package's on carries of
  f32, f64, int32, int64 and bool leaves with several keys (under x64
  the JAX words are unwrapped uint64 sums; their low 32 bits are
  compared, which is what `digest_hex` prints); `DivergenceWatchdog`
  gives equal verdicts on equal sequences.
* `corrupt_carry@K` under `halt` is detected in the same round with the
  same failed invariant names as the JAX app, for every app with
  declared invariants (p2p-31 at fnum 2; the exchange apps through their
  host-loop hooks).
* `rollback` with checkpoints heals sssp, pagerank and wcc byte-identically
  with one rollback; a deterministic fault is localized; rollback without
  checkpoints halts; probes are forced on checkpoint rounds.
* The JAX tests' oscillator and stagnator halt with the same verdict kind
  and period; a bad vote is an `active_range` breach; the bundle's key
  set is the JAX package's; `guard="off"` runs no probe and reads nothing
  more from the device; `on_mutation` resets the digest history; the obs
  hooks (counters, instants, the recorder's bundle) fire.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.app.base import ParallelAppBase
from libgrape_lite_tpu_torch.ft.faults import FaultPlan
from libgrape_lite_tpu_torch.guard import (
    DivergenceError,
    GuardConfig,
    InvariantBreachError,
)
from libgrape_lite_tpu_torch.guard.monitor import GuardMonitor
from libgrape_lite_tpu_torch.guard.watchdog import (
    DivergenceWatchdog,
    carry_digest,
    digest_hex,
)
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.test_torch_ft import QUERY, port_fragment

torch.set_num_threads(1)

# reads that move a tensor's value to the host: each is a device sync on
# the card
_HOST_READS = {"__int__", "__bool__", "__float__", "__index__", "item",
               "tolist", "numpy", "cpu"}


class _ReadCounter(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in _HOST_READS:
            self.reads += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def count_host_reads():
    """Count the tensor reads to the host made on this thread."""
    with _ReadCounter() as c:
        yield c


def port_app(name: str):
    cls = APP_REGISTRY[name]
    import inspect

    if "dtype" in inspect.signature(cls).parameters:
        return cls(dtype=torch.float64)
    return cls()


def jax_app(name: str):
    from libgrape_lite_tpu.models import APP_REGISTRY as JREG

    return JREG[name]()


def query_of(name):
    if name in QUERY:
        return QUERY[name]
    if name in ("bfs", "bc", "common_neighbors", "sssp_msg", "sssp_delta"):
        return {"source": 6}
    if name == "kcore":
        return {"k": 3}
    return {}


# ---- digest and watchdog ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_digest_hex_matches_jax(seed):
    import jax.numpy as jnp

    from libgrape_lite_tpu.guard.watchdog import (
        carry_digest as jdigest,
        digest_hex as jhex,
    )

    rng = np.random.default_rng(seed)
    carry = {
        "f32": rng.random((2, 300)).astype(np.float32),
        "f64": rng.random((3, 77)),
        "i32": rng.integers(-2**31, 2**31 - 1, (2, 50)).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, (2, 41)),
        "b": rng.random((2, 33)) > 0.5,
        "scalar": np.int32(-3),
        "nan": np.float64(np.nan),
    }
    carry["f64"][0, :4] = [np.inf, -np.inf, np.nan, -0.0]
    want = jhex(tuple(int(x) for x in np.asarray(
        jdigest({k: jnp.asarray(v) for k, v in carry.items()}))))
    got = digest_hex(tuple(carry_digest(
        {k: torch.as_tensor(v) for k, v in carry.items()}).tolist()))
    assert got == want
    one = {"f32": carry["f32"]}
    assert digest_hex(tuple(carry_digest(
        {"f32": torch.as_tensor(one["f32"])}).tolist())) == jhex(
        tuple(int(x) for x in np.asarray(jdigest(
            {"f32": jnp.asarray(one["f32"])}))))


def test_watchdog_verdicts_match_jax():
    from libgrape_lite_tpu.guard.watchdog import (
        DivergenceWatchdog as JWatchdog,
    )

    rng = np.random.default_rng(5)
    seqs = [
        [((1, 2), 0.5), ((3, 4), 0.4), ((1, 2), 0.3)],  # period 2
        [((k, k), 0.0) for k in range(12)],  # stagnation at window 6
        [((k, 0), float(1.0 / (k + 1))) for k in range(12)],  # healthy
        [((k, 1), float("nan") if k % 2 else float("inf"))
         for k in range(10)],
    ] + [[((int(rng.integers(0, 4)), 0), float(rng.random()))
          for _ in range(10)] for _ in range(3)]
    for seq in seqs:
        pw, jw = DivergenceWatchdog(6), JWatchdog(6)
        for r, (dig, res) in enumerate(seq):
            assert pw.observe(r, dig, res) == jw.observe(r, dig, res)
        pw.reset()
        jw.reset()
        assert pw.observe(0, seq[0][0]) == jw.observe(0, seq[0][0])


# ---- invariants against injected corruption ---------------------------------

# (app, corrupt_carry round): the single-pass apps end at PEval (round 0)
CORRUPT = [("sssp", 2), ("bfs", 2), ("pagerank", 2), ("wcc", 2),
           ("cdlp", 2), ("core_decomposition", 2), ("kcore", 1),
           ("bc", 0), ("lcc", 0), ("lcc_opt", 0), ("triangle_count", 0),
           ("common_neighbors", 1), ("sssp_msg", 2), ("sssp_delta", 2)]


def _verdict(run):
    try:
        run()
    except Exception as e:  # both packages' InvariantBreachError
        b = e.bundle
        return (type(e).__name__, b["round"], b["verdict"]["kind"],
                sorted(b["verdict"].get("failed", {})), b["invariants"])
    return None


@pytest.mark.parametrize("name,k", CORRUPT)
def test_corrupt_carry_detected_as_in_jax(graph_cache, monkeypatch, name, k):
    from libgrape_lite_tpu.ft.faults import FaultPlan as JPlan
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    frag = port_fragment(2)
    host = getattr(APP_REGISTRY[name], "host_only", False)
    if host:  # the host loops read GRAPE_FT_FAULTS
        monkeypatch.setenv("GRAPE_FT_FAULTS", f"corrupt_carry@{k}")
        jrun = JWorker(jax_app(name), graph_cache(2))
        want = _verdict(lambda: jrun.query(guard="halt", **query_of(name)))
        got = _verdict(lambda: Worker(port_app(name), frag).query(
            guard="halt", **query_of(name)))
    else:
        jrun = JWorker(jax_app(name), graph_cache(2))
        want = _verdict(lambda: jrun.query_stepwise(
            guard="halt", fault_plan=JPlan(corrupt_carry_at=k),
            **query_of(name)))
        got = _verdict(lambda: Worker(port_app(name), frag).query(
            guard="halt", fault_plan=FaultPlan(corrupt_carry_at=k),
            **query_of(name)))
    assert got == want
    if name != "kcore":  # kcore's carry is all bool: nothing to poison
        assert got is not None and got[1] == k


@pytest.mark.parametrize("name", ["sssp", "pagerank", "wcc"])
def test_clean_guarded_run_is_unchanged(name):
    frag = port_fragment(2)
    ref = Worker(port_app(name), frag)
    ref.query(**query_of(name))
    w = Worker(port_app(name), frag)
    w.query(guard="halt", **query_of(name))
    assert w.result_values().tobytes() == ref.result_values().tobytes()
    rep = w.guard_report
    assert rep["probes"] == ref.rounds + 1 and not rep["breaches"]


# ---- self-heal ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["sssp", "pagerank", "wcc"])
def test_self_heal_byte_identical(tmp_path, name):
    frag = port_fragment(2)
    ref = Worker(port_app(name), frag)
    ref.query(**query_of(name))
    w = Worker(port_app(name), frag)
    w.query(checkpoint_every=3, checkpoint_dir=str(tmp_path / "ck"),
            guard="rollback", fault_plan=FaultPlan(corrupt_carry_at=4),
            **query_of(name))
    assert w.result_values().tobytes() == ref.result_values().tobytes()
    assert w.rounds == ref.rounds
    rep = w.guard_report
    assert rep["rollbacks"] == 1 and rep["paranoid"]
    assert len(rep["breaches"]) == 1 and rep["breaches"][0]["round"] == 4


def test_rollback_without_checkpoints_halts():
    with pytest.raises(InvariantBreachError):
        Worker(port_app("sssp"), port_fragment(2)).query(
            guard="rollback", fault_plan=FaultPlan(corrupt_carry_at=2),
            source=6)


def test_deterministic_fault_localized_after_rollback(tmp_path):
    plan = FaultPlan(corrupt_carry_at=2)
    w = Worker(port_app("sssp"), port_fragment(2))

    def refire(carry, rounds):
        if rounds < 2:
            return None
        plan.corrupt_carry_at = rounds
        plan._carry_fired = False
        return FaultPlan.maybe_corrupt_carry(plan, carry, rounds)

    plan.maybe_corrupt_carry = refire
    with pytest.raises(InvariantBreachError) as ei:
        w.query(checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"),
                guard="rollback", fault_plan=plan, source=6)
    assert ei.value.bundle.get("localized_round") == 2
    assert w.guard_report["rollbacks"] == 1


def test_probe_forced_on_checkpoint_rounds(tmp_path):
    frag = port_fragment(2)
    ref = Worker(port_app("sssp"), frag)
    ref.query(source=6)
    w = Worker(port_app("sssp"), frag)
    w.query(checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"),
            guard=GuardConfig(policy="rollback", every=3),
            fault_plan=FaultPlan(corrupt_carry_at=4), source=6)
    assert w.result_values().tobytes() == ref.result_values().tobytes()
    rep = w.guard_report
    assert rep["rollbacks"] == 1 and rep["breaches"][0]["round"] == 4


# ---- the watchdog on toy apps (the JAX tests' oscillator and stagnator) -----


class Oscillator(ParallelAppBase):
    max_rounds = 200

    def init_state(self, frag, **_):
        return {"x": torch.zeros((frag.fnum, frag.vp), dtype=torch.int32)}

    def peval(self, ctx, dev, state):
        return state, 1

    def inceval(self, ctx, dev, state):
        return {"x": 1 - state["x"]}, 1

    def finalize(self, frag, state):
        return state["x"].numpy()


class Stagnator(ParallelAppBase):
    max_rounds = 200
    replicated_keys = frozenset({"step"})

    def init_state(self, frag, **_):
        return {"v": torch.ones((frag.fnum, frag.vp), dtype=torch.float64),
                "step": torch.zeros((), dtype=torch.int32)}

    def peval(self, ctx, dev, state):
        return state, 1

    def inceval(self, ctx, dev, state):
        return dict(state, step=state["step"] + 1), 1

    def finalize(self, frag, state):
        return state["v"].numpy()


class BadVoter(Oscillator):
    max_rounds = 20

    def inceval(self, ctx, dev, state):
        return state, 10**9


def _toy():
    from tests.test_guard import _toy_fragment
    from tests.test_torch_variants import _carry

    jfrag = _toy_fragment()
    return jfrag, _carry(jfrag)


@pytest.mark.parametrize("toy,cfg", [
    ("Oscillator", dict(policy="halt")),
    ("Stagnator", dict(policy="halt", stagnation_window=6)),
    ("BadVoter", dict(policy="halt")),
])
def test_toy_verdicts_match_jax(toy, cfg):
    import tests.test_guard as jt
    from libgrape_lite_tpu.guard import GuardConfig as JConfig
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    jfrag, pfrag = _toy()
    with pytest.raises(Exception) as ej:
        JWorker(getattr(jt, toy)(), jfrag).query_stepwise(
            guard=JConfig(**cfg))
    with pytest.raises(DivergenceError if toy != "BadVoter"
                       else InvariantBreachError) as ep:
        Worker(globals()[toy](), pfrag).query(guard=GuardConfig(**cfg))
    jv, pv = ej.value.bundle["verdict"], ep.value.bundle["verdict"]
    assert type(ep.value).__name__ == type(ej.value).__name__
    for key in ("kind", "round", "period", "first_seen_round",
                "best_residual", "stale_probes", "active"):
        assert pv.get(key) == jv.get(key), key
    jb, pb = ej.value.bundle, ep.value.bundle
    assert set(pb) == set(jb)
    assert set(pb["guard_config"]) == set(jb["guard_config"])
    assert pb["recent_digests"] == jb["recent_digests"] or toy != "BadVoter"
    assert pb["active_history"] == jb["active_history"]
    assert pb["config_fingerprint"]["fragment_hash"] == jb[
        "config_fingerprint"]["fragment_hash"]


def test_oscillator_digests_match_jax():
    """The digest history of a cycling run is the JAX package's word for
    word (the carry is int32, so the words are comparable in full)."""
    import tests.test_guard as jt
    from libgrape_lite_tpu.guard import GuardConfig as JConfig
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    jfrag, pfrag = _toy()
    with pytest.raises(Exception) as ej:
        JWorker(jt.Oscillator(), jfrag).query_stepwise(
            guard=JConfig(policy="halt"))
    with pytest.raises(DivergenceError) as ep:
        Worker(Oscillator(), pfrag).query(guard="halt")
    assert ep.value.bundle["recent_digests"] == ej.value.bundle[
        "recent_digests"]


def test_stagnation_window_zero_and_warn_policy():
    _, pfrag = _toy()
    w = Worker(Stagnator(), pfrag)
    w.query(max_rounds=12, guard=GuardConfig(policy="halt",
                                             stagnation_window=0))
    assert w.rounds == 12
    w = Worker(Oscillator(), pfrag)
    w.query(max_rounds=9, guard=GuardConfig(policy="warn"))
    assert w.rounds == 9 and w.guard_report["breaches"]


# ---- guard off, obs hooks, mutation reset -----------------------------------


def test_guard_off_runs_no_probe_and_reads_nothing_more(monkeypatch):
    frag = port_fragment(2)
    with count_host_reads() as plain:
        Worker(port_app("sssp"), frag).query(source=6)

    def boom(*a, **k):
        raise AssertionError("probe with guards off")

    monkeypatch.setattr(GuardMonitor, "check", boom)
    monkeypatch.setenv("GRAPE_GUARD", "halt")
    with count_host_reads() as off:
        w = Worker(port_app("sssp"), frag)
        w.query(guard="off", source=6)
    assert w.guard_report is None
    assert off.reads == plain.reads
    monkeypatch.undo()
    with count_host_reads() as on:
        w = Worker(port_app("sssp"), frag)
        w.query(guard="halt", source=6)
    # one read a probe: verdicts, digest and residual in one transfer
    assert on.reads == plain.reads + w.guard_report["probes"]


def test_obs_hooks_and_recorder_bundle(tmp_path, monkeypatch):
    from libgrape_lite_tpu_torch.obs.recorder import RECORDER

    monkeypatch.setenv("GRAPE_POSTMORTEM", str(tmp_path / "pm"))
    obs.reset()
    obs.configure(in_memory=True)
    try:
        w = Worker(port_app("sssp"), port_fragment(2))
        w.query(checkpoint_every=3, checkpoint_dir=str(tmp_path / "ck"),
                guard="rollback", fault_plan=FaultPlan(corrupt_carry_at=4),
                source=6)
        snap = obs.metrics().snapshot()
        names = [e["name"] for e in obs.history()]
    finally:
        obs.reset()
        RECORDER.set_sink(None)
    assert snap["grape_guard_probes_total"]["value"] == w.guard_report[
        "probes"]
    assert snap["grape_guard_breaches_total"]["value"] == 1
    assert snap["grape_guard_rollbacks_total"]["value"] == 1
    assert snap["grape_checkpoint_restores_total"]["value"] == 1
    assert snap["grape_checkpoint_saves_total"]["value"] >= 2
    for name in ("guard_breach", "rollback", "checkpoint_restore",
                 "checkpoint_save", "checkpoint_write"):
        assert name in names, name
    import glob
    import json

    bundles = glob.glob(str(tmp_path / "pm" / "postmortem_guard_breach_*"))
    assert len(bundles) == 1
    b = json.load(open(bundles[0]))
    assert b["guard"]["verdict"]["kind"] == "invariant"
    assert b["guard"]["round"] == 4


def test_on_mutation_resets_the_digest_history():
    from libgrape_lite_tpu.guard.monitor import GuardMonitor as JMonitor

    frag = port_fragment(2)
    mon = GuardMonitor(app=port_app("sssp"), frag=frag,
                       config=GuardConfig(policy="halt"), ckpt=object())
    mon.watchdog.observe(1, (1, 2), 0.5)
    mon.on_mutation(frag)
    assert mon.watchdog.observe(2, (1, 2), 0.4) is None
    assert mon.mutations == 1 and mon.ckpt is None
    assert set(mon.report()) == set(JMonitor(
        app=jax_app("sssp"), frag=None,
        config=__import__("libgrape_lite_tpu.guard", fromlist=["x"])
        .GuardConfig(policy="halt")).report())


def test_guard_config_resolution_matches_jax(monkeypatch):
    from libgrape_lite_tpu.guard.config import GuardConfig as JConfig

    monkeypatch.setenv("GRAPE_GUARD", "warn")
    monkeypatch.setenv("GRAPE_GUARD_EVERY", "3")
    monkeypatch.setenv("GRAPE_GUARD_STAGNATION", "9")
    for g in (None, "halt", "", "off"):
        assert GuardConfig.resolve(g).__dict__ == JConfig.resolve(g).__dict__
    for bad in (dict(policy="nope"), dict(every=0),
                dict(stagnation_window=-1), dict(max_rollbacks=-1)):
        with pytest.raises(ValueError):
            GuardConfig(**bad)
