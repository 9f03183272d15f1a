"""The port's ft/ (`libgrape_lite_tpu_torch/ft/`) on the CPU, held against
the JAX package's on `dataset/p2p-31.*`.

* The fingerprint: `fragment_content_hash` equal to the JAX package's at
  fnum 1, 2, 4 and 8; `canonical_query_args` and `compute_fingerprint`
  equal; `meta.json`'s key set and leaf manifest equal for one carry.
* Lineages cross between the packages both ways (x64 carries on both
  sides): the resumed result against each package's uninterrupted run,
  SSSP bit-equal, PageRank within 1e-4 relative (a mixed lineage sums in
  both packages' orders).
* `kill@4,mode=raise` then `Worker.resume` byte-identical to the
  uninterrupted query for sssp, pagerank, cdlp and wcc at fnum 1, 2, 4, 8.
* The JAX package's tests/test_checkpoint_restore.py cases as port
  cases: corrupt-shard fallback then failure, `corrupt@6,kill@7`, the
  fingerprint and carry-key refusals, the argument refusals, a reused
  dir's fresh lineage, stale temp dirs, gc under concurrent removal, a
  converged checkpoint.
* `capacity=N` sends `sssp_msg` up the same overflow ladder as the JAX
  app; the fault grammar parses to the same fields in both packages;
  the retry policy's delays and classifiers agree; a transient EIO on
  the garc read is retried.
"""

import errno
import json
import os
import shutil

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.ft import checkpoint as ck
from libgrape_lite_tpu_torch.ft import fingerprint as fp
from libgrape_lite_tpu_torch.ft import retry
from libgrape_lite_tpu_torch.ft.checkpoint import (
    CheckpointManager,
    CheckpointMismatchError,
    CorruptCheckpointError,
    list_checkpoints,
)
from libgrape_lite_tpu_torch.ft.faults import (
    FaultPlan,
    FaultSpecError,
    InjectedFault,
    corrupt_file,
)
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path

torch.set_num_threads(1)

P2P = (dataset_path("p2p-31.e"), dataset_path("p2p-31.v"))
FNUMS = [1, 2, 4, 8]
QUERY = {
    "sssp": {"source": 6},
    "pagerank": {"delta": 0.85, "max_round": 10},
    "cdlp": {"max_round": 10},
    "wcc": {},
}
_FRAGS = {}


def port_fragment(fnum: int):
    if fnum not in _FRAGS:
        _FRAGS[fnum] = LoadGraph(
            *P2P, CommSpec(fnum=fnum, device="cpu"),
            LoadGraphSpec(weighted=True, edata_dtype=np.float64))
    return _FRAGS[fnum]


def port_app(name: str):
    """The port's app with the JAX tests' x64 carries where it takes a
    dtype."""
    cls = APP_REGISTRY[name]
    if name in ("sssp", "pagerank", "sssp_msg"):
        return cls(dtype=torch.float64)
    return cls()


def jax_app(name: str):
    from libgrape_lite_tpu.models import APP_REGISTRY as JREG

    return JREG[name]()


def run(frag, name, **kw):
    w = Worker(port_app(name), frag)
    w.query(**QUERY[name], **kw)
    return w


# ---- fingerprint and format ------------------------------------------------


@pytest.mark.parametrize("fnum", FNUMS)
def test_fragment_content_hash_matches_jax(graph_cache, fnum):
    from libgrape_lite_tpu.ft.fingerprint import (
        fragment_content_hash as jhash,
    )

    assert fp.fragment_content_hash(port_fragment(fnum)) == jhash(
        graph_cache(fnum))


def test_canonical_query_args_match_jax():
    from libgrape_lite_tpu.ft.fingerprint import (
        canonical_query_args as jcanon,
        stable_config_digest as jdigest,
    )

    cases = [{"source": np.int64(6)}, {"delta": np.float32(0.85),
                                       "max_round": 10},
             {"flag": np.bool_(True), "name": "x", "none": None}, {}]
    for qa in cases:
        got = fp.canonical_query_args(qa)
        assert got == jcanon(qa)
        assert json.dumps(got) == json.dumps(jcanon(qa))
        assert fp.stable_config_digest(got) == jdigest(jcanon(qa))
    for bad in ({"source": [1, 2]}, {"w": np.zeros(3)}):
        with pytest.raises(TypeError):
            fp.canonical_query_args(bad)
        with pytest.raises(TypeError):
            jcanon(bad)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_compute_fingerprint_matches_jax(graph_cache, name):
    """The whole fingerprint is the JAX package's for the same query (so
    a lineage is resumable across them)."""
    from libgrape_lite_tpu.ft.fingerprint import compute_fingerprint

    pfrag = port_fragment(2)
    app = port_app(name)
    state = app.init_state(pfrag, **QUERY[name])
    carry = {k: v for k, v in state.items() if k not in app.ephemeral_keys}
    got = fp.compute_fingerprint(app, pfrag, QUERY[name], carry=carry)
    want = compute_fingerprint(jax_app(name), graph_cache(2), QUERY[name])
    assert got == want


def test_meta_keys_and_leaves_match_jax(tmp_path):
    from libgrape_lite_tpu.ft.checkpoint import (
        CheckpointManager as JManager,
        read_meta as jread,
    )

    rng = np.random.default_rng(0)
    carry = {"dist": rng.random((2, 64)), "step": np.int32(3),
             "comp": rng.integers(0, 9, (2, 64)).astype(np.int32),
             "alive": rng.random((2, 64)) > 0.5}
    kw = dict(fingerprint={"app": "t"}, query_args={"source": 6},
              checkpoint_every=2)
    jm = JManager(str(tmp_path / "j"), **kw)
    jm.save_async(carry, 4, 7)
    jm.close()
    pm = CheckpointManager(str(tmp_path / "p"), **kw)
    pm.save_async({k: torch.as_tensor(v) for k, v in carry.items()}, 4, 7)
    pm.close()
    jmeta = jread(list_checkpoints(str(tmp_path / "j"))[0][1])
    steps = list_checkpoints(str(tmp_path / "p"))
    assert [r for r, _ in steps] == [4]
    assert os.path.basename(steps[0][1]) == "ckpt_00000004"
    pmeta = ck.read_meta(steps[0][1])
    assert set(pmeta) == set(jmeta)
    assert pmeta["leaves"] == jmeta["leaves"]
    for k in ("format", "rounds", "active", "checkpoint_every",
              "fingerprint", "query_args"):
        assert pmeta[k] == jmeta[k]
    state = ck.load_state(steps[0][1], pmeta)
    for k, v in carry.items():
        assert state[k].dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(state[k], v)
    assert sorted(os.listdir(steps[0][1])) == ["meta.json", "state.npz"]


# ---- lineages across the packages -----------------------------------------


def _close(name, got, want):
    if name == "sssp":
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_jax_lineage_resumes_in_the_port(graph_cache, tmp_path, name):
    from libgrape_lite_tpu.ft.faults import (
        FaultPlan as JPlan,
        InjectedFault as JFault,
    )
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    jfrag = graph_cache(2)
    jw = JWorker(jax_app(name), jfrag)
    jw.query(**QUERY[name])
    jax_ref = jw.result_values()
    d = str(tmp_path / "ck")
    with pytest.raises(JFault):
        JWorker(jax_app(name), jfrag).query_stepwise(
            checkpoint_every=2, checkpoint_dir=d,
            fault_plan=JPlan.from_spec("kill@4,mode=raise"), **QUERY[name])
    assert [r for r, _ in list_checkpoints(d)] == [2, 4]
    pfrag = port_fragment(2)
    w = Worker(port_app(name), pfrag)
    w.resume(d)
    got = w.result_values()
    _close(name, got, jax_ref)
    # a mixed lineage sums PageRank in both packages' orders: within the
    # tolerance of the port's own run, SSSP bit-equal
    _close(name, got, run(pfrag, name).result_values())


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_port_lineage_resumes_in_jax(graph_cache, tmp_path, name):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    pfrag = port_fragment(2)
    port_ref = run(pfrag, name).result_values()
    d = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        run(pfrag, name, checkpoint_every=2, checkpoint_dir=d,
            fault_plan=FaultPlan.from_spec("kill@4,mode=raise"))
    jfrag = graph_cache(2)
    jw = JWorker(jax_app(name), jfrag)
    jw.resume(d)
    got = jw.result_values()
    _close(name, got, port_ref)
    jref = JWorker(jax_app(name), jfrag)
    jref.query(**QUERY[name])
    _close(name, got, jref.result_values())


# ---- kill and resume --------------------------------------------------------


@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", ["sssp", "pagerank", "cdlp", "wcc"])
def test_kill_resume_byte_identical(tmp_path, name, fnum):
    frag = port_fragment(fnum)
    ref = run(frag, name)
    d = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        run(frag, name, checkpoint_every=2, checkpoint_dir=d,
            fault_plan=FaultPlan.from_spec("kill@4,mode=raise"))
    assert list_checkpoints(d), "the kill left no complete checkpoint"
    w = Worker(port_app(name), frag)
    w.resume(d)
    assert w.rounds == ref.rounds
    for k, v in ref._result_state.items():
        assert w._result_state[k].numpy().tobytes() == v.numpy().tobytes()
    assert w.result_values().tobytes() == ref.result_values().tobytes()


def test_checkpointing_leaves_results_and_host_reads_alone(tmp_path):
    """A checkpointed query equals the plain one, and the snapshots add
    no read of a tensor on the loop's thread beyond the plain query's
    (on the card: non-blocking copies the writer thread waits for)."""
    from tests.test_torch_guard import count_host_reads

    frag = port_fragment(2)
    with count_host_reads() as plain:
        ref = run(frag, "sssp")
    with count_host_reads() as ckpt:
        w = run(frag, "sssp", checkpoint_every=2,
                checkpoint_dir=str(tmp_path / "ck"))
    assert w.result_values().tobytes() == ref.result_values().tobytes()
    assert ckpt.reads == plain.reads
    rounds = [r for r, _ in list_checkpoints(str(tmp_path / "ck"))]
    assert len(rounds) == 2 and rounds[-1] == ref.rounds - ref.rounds % 2


# ---- the JAX package's checkpoint-restore cases -----------------------------


def test_corrupt_shard_falls_back_then_fails(tmp_path):
    frag = port_fragment(2)
    ref = run(frag, "sssp").result_values()
    d = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        run(frag, "sssp", checkpoint_every=3, checkpoint_dir=d,
            fault_plan=FaultPlan(kill_at_superstep=7, mode="raise"))
    steps = list_checkpoints(d)
    assert [r for r, _ in steps] == [3, 6]  # keep=2 retention
    corrupt_file(os.path.join(steps[-1][1], "state.npz"))
    w = Worker(port_app("sssp"), frag)
    w.resume(d)
    assert w.result_values().tobytes() == ref.tobytes()
    for _, path in list_checkpoints(d):
        corrupt_file(os.path.join(path, "state.npz"))
    with pytest.raises(CorruptCheckpointError):
        Worker(port_app("sssp"), frag).resume(d)


def test_corrupt_via_fault_plan(tmp_path):
    frag = port_fragment(2)
    ref = run(frag, "sssp").result_values()
    d = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        run(frag, "sssp", checkpoint_every=3, checkpoint_dir=d,
            fault_plan=FaultPlan.from_spec("corrupt@6,kill@7,mode=raise"))
    w = Worker(port_app("sssp"), frag)
    w.resume(d)
    assert w.result_values().tobytes() == ref.tobytes()


def test_fingerprint_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ck")
    run(port_fragment(2), "sssp", checkpoint_every=3, checkpoint_dir=d)
    with pytest.raises(CheckpointMismatchError, match="app"):
        Worker(port_app("pagerank"), port_fragment(2)).resume(d)
    with pytest.raises(CheckpointMismatchError, match="fnum|fragment"):
        Worker(port_app("sssp"), port_fragment(4)).resume(d)
    # a float32 carry is another numeric config than the lineage's x64
    with pytest.raises(CheckpointMismatchError, match="x64"):
        Worker(APP_REGISTRY["sssp"](), port_fragment(2)).resume(d)


def test_carry_key_mismatch_rejected(tmp_path):
    """A lineage whose leaves are not this query's carry is refused
    before any state is adopted."""
    d = str(tmp_path / "ck")
    run(port_fragment(2), "sssp", checkpoint_every=3, checkpoint_dir=d)
    path = list_checkpoints(d)[-1][1]
    meta = ck.read_meta(path)
    state = ck.load_state(path, meta)
    state["extra"] = np.zeros(3)
    import io

    buf = io.BytesIO()
    np.savez(buf, **state)
    blob = buf.getvalue()
    with open(os.path.join(path, "state.npz"), "wb") as fh:
        fh.write(blob)
    import hashlib

    meta["npz_sha256"] = hashlib.sha256(blob).hexdigest()
    meta["leaves"]["extra"] = {"shape": [3], "dtype": "<f8"}
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(CheckpointMismatchError, match="carry keys"):
        Worker(port_app("sssp"), port_fragment(2)).resume(d)


class _Mutating(APP_REGISTRY["sssp"]):
    def collect_mutations(self, frag, host_state, rounds):
        return None


def test_checkpoint_refusals(tmp_path):
    frag = port_fragment(2)
    with pytest.raises(ValueError, match="host-only"):
        Worker(APP_REGISTRY["kclique"](), frag).query(
            checkpoint_every=2, checkpoint_dir=str(tmp_path / "a"), k=3)
    with pytest.raises(ValueError, match="MutationContext"):
        Worker(_Mutating(), frag).query(
            checkpoint_every=2, checkpoint_dir=str(tmp_path / "m"), source=6)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Worker(port_app("sssp"), frag).query(checkpoint_every=2, source=6)
    with pytest.raises(ValueError, match="checkpoint_every"):
        Worker(port_app("sssp"), frag).query(
            checkpoint_dir=str(tmp_path / "c"), source=6)
    with pytest.raises(ValueError, match=">= 1"):
        Worker(port_app("sssp"), frag).query(
            checkpoint_every=0, checkpoint_dir=str(tmp_path / "b"), source=6)
    with pytest.raises(FileNotFoundError):
        Worker(port_app("sssp"), frag).resume(str(tmp_path / "none"))


def test_reused_dir_starts_fresh_lineage(tmp_path):
    frag = port_fragment(2)
    d = str(tmp_path / "ck")
    run(frag, "sssp", checkpoint_every=3, checkpoint_dir=d)
    assert list_checkpoints(d)
    ref = run(frag, "pagerank", checkpoint_every=2,
              checkpoint_dir=str(tmp_path / "ref")).result_values()
    with pytest.raises(InjectedFault):
        run(frag, "pagerank", checkpoint_every=2, checkpoint_dir=d,
            fault_plan=FaultPlan(kill_at_superstep=5, mode="raise"))
    assert max(r for r, _ in list_checkpoints(d)) <= 5
    w = Worker(port_app("pagerank"), frag)
    w.resume(d)
    assert w.result_values().tobytes() == ref.tobytes()


def test_stale_tmp_dirs_swept(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    stale = d / ".tmp-3-99999"
    stale.mkdir()
    (stale / "state.npz").write_bytes(b"half-written")
    run(port_fragment(2), "sssp", checkpoint_every=3, checkpoint_dir=str(d))
    assert not stale.exists()
    assert not any(n.startswith(".tmp-") for n in os.listdir(str(d)))


def test_gc_tolerates_concurrent_removal(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, fingerprint={"app": "t"}, query_args={},
                            checkpoint_every=1, keep=1)
    state = {"x": torch.arange(8)}
    for r in (0, 1, 2):
        mgr.save_async(state, r, 1)
        mgr.wait()
    real_list = ck.list_checkpoints

    def racing_list(directory):
        steps = real_list(directory)
        for _, p in steps[:-1]:
            shutil.rmtree(p, ignore_errors=True)
        return steps

    monkeypatch.setattr(ck, "list_checkpoints", racing_list)
    mgr._gc()  # must not raise
    monkeypatch.setattr(ck, "list_checkpoints", real_list)
    shutil.rmtree(d)
    mgr.save_async(state, 3, 1)
    mgr.close()
    assert [r for r, _ in list_checkpoints(d)] == [3]


def test_resume_from_converged_checkpoint(tmp_path):
    frag = port_fragment(2)
    d = str(tmp_path / "ck")
    ref = run(frag, "pagerank", checkpoint_every=1,
              checkpoint_dir=d).result_values()
    w = Worker(port_app("pagerank"), frag)
    w.resume(d)
    assert w.rounds == 10
    assert w.result_values().tobytes() == ref.tobytes()


def test_writer_failure_raises_into_the_loop(tmp_path, monkeypatch):
    """A checkpoint write that fails surfaces at the next wait() in the
    superstep loop, never swallowed."""
    def boom(self, *a):
        raise OSError(errno.ENOSPC, "disk full")

    monkeypatch.setattr(CheckpointManager, "_write_inner", boom)
    with pytest.raises(OSError, match="disk full"):
        run(port_fragment(1), "sssp", checkpoint_every=2,
            checkpoint_dir=str(tmp_path / "ck"))


# ---- capacity clamp --------------------------------------------------------


def test_capacity_clamp_takes_the_jax_ladder(monkeypatch):
    from libgrape_lite_tpu.models import SSSPMsg as JSSSPMsg
    from libgrape_lite_tpu.worker.worker import Worker as JWorker
    from tests.test_torch_variants import _carry
    from tests.test_worker import build_fragment

    rng = np.random.default_rng(1)
    n, e = 64, 512
    jfrag = build_fragment(rng.integers(0, n, e), rng.integers(0, n, e),
                           rng.random(e), n, 2)
    monkeypatch.setenv("GRAPE_FT_FAULTS", "capacity=2")
    japp = JSSSPMsg()
    jw = JWorker(japp, jfrag)
    jw.query(source=0)
    app = APP_REGISTRY["sssp_msg"]()  # the JAX app's f32 distances here
    w = Worker(app, _carry(jfrag))
    w.query(source=0)
    assert app.retries > 0
    assert (app.retries, app.final_capacity) == (japp.retries,
                                                 japp.final_capacity)
    assert w.result_values().tobytes() == jw.result_values().tobytes()


# ---- fault grammar ---------------------------------------------------------

GOOD_SPECS = ["kill@4", "corrupt@2", "corrupt_carry@5", "capacity=3",
              "capacity=0", "mode=raise", "mode=exit", "exit=3", "", "kill@1",
              "corrupt@6, kill@7, mode=raise", "corrupt_carry@3",
              "kill_rank@4:1", "kill_rank@0:0,mode=raise,exit=9"]
BAD_SPECS = ["kil@3", "corrupt_cary@3", "bogus", "kill@x", "corrupt@",
             "capacity=many", "mode=wrong", "exit=abc", "kill_rank@4",
             "kill_rank@x:1", "kill_rank@1:y", "kill_rank@1:-2"]
FIELDS = ("kill_at_superstep", "kill_rank_at", "kill_rank",
          "corrupt_checkpoint_at", "corrupt_carry_at", "capacity_clamp",
          "mode", "exit_code")


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_good_specs_parse_as_in_jax(spec):
    from libgrape_lite_tpu.ft.faults import FaultPlan as JPlan

    got, want = FaultPlan.from_spec(spec), JPlan.from_spec(spec)
    assert [getattr(got, f) for f in FIELDS] == [
        getattr(want, f) for f in FIELDS]
    assert got.is_noop() == want.is_noop()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_as_in_jax(spec):
    from libgrape_lite_tpu.ft.faults import (
        FaultPlan as JPlan,
        FaultSpecError as JSpecError,
    )

    with pytest.raises(FaultSpecError) as ei:
        FaultPlan.from_spec(spec)
    with pytest.raises(JSpecError) as ej:
        JPlan.from_spec(spec)
    assert str(ei.value) == str(ej.value)
    assert isinstance(ei.value, ValueError)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_corrupt_carry_poisons_the_jax_band_once(dtype):
    from libgrape_lite_tpu.ft.faults import FaultPlan as JPlan

    carry = {"b": np.zeros((2, 40), dtype), "a": np.ones((2, 3, 8), dtype),
             "m": np.zeros((2, 40), bool), "s": np.zeros((), dtype)}
    plan, jplan = FaultPlan(corrupt_carry_at=2), JPlan(corrupt_carry_at=2)
    pc = {k: torch.as_tensor(v) for k, v in carry.items()}
    assert plan.maybe_corrupt_carry(pc, 1) is None
    got, want = plan.maybe_corrupt_carry(pc, 2), jplan.maybe_corrupt_carry(
        carry, 2)
    assert list(got) == list(want) == ["a"]
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["a"].dtype == want["a"].dtype
    assert not torch.isnan(pc["a"].to(torch.float64)).any()  # a copy
    assert plan.maybe_corrupt_carry(pc, 2) is None  # once


def test_kill_rank_fires_on_rank_zero_only():
    hit = FaultPlan(kill_rank_at=3, kill_rank=0, mode="raise")
    hit.on_superstep(2, None)
    with pytest.raises(InjectedFault, match="rank 0 at superstep 3"):
        hit.on_superstep(3, None)
    FaultPlan(kill_rank_at=3, kill_rank=1, mode="raise").on_superstep(3, None)


# ---- retry -----------------------------------------------------------------


def test_seeded_delays_match_jax(monkeypatch):
    from libgrape_lite_tpu.ft import retry as jretry

    policy = dict(max_attempts=5, base_delay=0.5, multiplier=2.0,
                  max_delay=8.0, jitter=0.25)

    def sleeps(mod):
        out, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 5:
                raise OSError("transient")
            return "ok"

        assert mod.with_retries(flaky, policy=mod.RetryPolicy(**policy),
                                retryable=lambda e: True,
                                sleep=out.append) == "ok"
        return out

    monkeypatch.setenv(retry.RETRY_SEED_ENV, "1234")
    got = sleeps(retry)
    assert got == sleeps(jretry) and len(got) == 4
    assert got != [0.5, 1.0, 2.0, 4.0]
    monkeypatch.setenv(retry.RETRY_SEED_ENV, "x")
    with pytest.raises(ValueError, match="GRAPE_RETRY_SEED"):
        sleeps(retry)


def test_classifiers_match_jax():
    from libgrape_lite_tpu.ft import retry as jretry

    errors = [
        RuntimeError("jax.distributed.initialize() must be called before "
                     "any JAX computations are executed"),
        RuntimeError("DEADLINE_EXCEEDED: handshake timed out before "
                     "barrier"),
        RuntimeError("UNAVAILABLE: failed to connect before deadline"),
        ConnectionRefusedError("nope"), TimeoutError("slow"),
        ValueError("bad address"), FileNotFoundError("gone"),
        PermissionError("denied"), OSError(errno.EIO, "stale NFS handle"),
        OSError(errno.ESTALE, "stale"), OSError("no errno"),
        OSError(errno.ENOSPC, "full"), ValueError("not io at all"),
    ]
    for fn in ("is_late_init_error", "is_transient_distributed_error",
               "is_transient_io_error"):
        assert [getattr(retry, fn)(e) for e in errors] == [
            getattr(jretry, fn)(e) for e in errors], fn


def test_garc_read_retries_a_transient_eio(tmp_path, monkeypatch):
    """A transient EIO on the cache read is retried once, then the
    fragment loads -- bit-equal to the one the cache was written from."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.fragment import loader as loader_mod

    prefix = str(tmp_path / "ser")
    spec = dict(weighted=True, edata_dtype=np.float64,
                serialization_prefix=prefix)
    src = LoadGraph(*P2P, CommSpec(fnum=2, device="cpu"),
                    LoadGraphSpec(serialize=True, **spec))
    monkeypatch.setattr(retry, "CACHE_READ_POLICY", retry.RetryPolicy(
        max_attempts=3, base_delay=0.0, jitter=0.0))
    real_open = open
    fails = [1]

    def flaky_open(p, mode="r", *a, **kw):
        if str(p).endswith("frag.garc") and "r" in mode and fails[0] > 0:
            fails[0] -= 1
            raise OSError(errno.EIO, "flaky fs")
        return real_open(p, mode, *a, **kw)

    obs.configure(in_memory=True)
    try:
        monkeypatch.setattr("builtins.open", flaky_open)
        frag = LoadGraph(*P2P, CommSpec(fnum=2, device="cpu"),
                         LoadGraphSpec(deserialize=True, **spec))
        monkeypatch.setattr("builtins.open", real_open)
        assert fails[0] == 0
        snap = obs.metrics().snapshot()
        assert snap["grape_retry_attempts_total"]["value"] == 1
        assert [e["name"] for e in obs.history()
                if e["name"] == "retry"] == ["retry"]
    finally:
        obs.reset()
    assert fp.fragment_content_hash(frag) == fp.fragment_content_hash(src)
    # a permanent error is not retried
    with pytest.raises(FileNotFoundError):
        loader_mod._read_cache_file(str(tmp_path / "missing.garc"))
