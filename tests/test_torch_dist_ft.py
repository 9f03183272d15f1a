"""The port's resilience across ranks on the CPU, against the JAX package:
sharded two-phase checkpoints (ft/distributed.py), the reshard restore,
and checkpoints, resumes, guards and fault plans in real gloo gangs.

* The fast lane runs the protocol in one process: `_HostComm` takes an
  injected allgather, a solo comm makes the two-phase commit exercisable
  without a gang, and two ranks run as threads over slab fragments
  (`CommSpec(4, rank=r, world=2)`), the JAX side as threads over
  fake-sharded leaves.  Lineages cross both ways: a two-rank lineage
  written by either package reads in the other (`load_sharded_state`) and
  resumes through the other's `Worker` onto fnum 2 (SSSP bit-equal,
  PageRank within 1e-4); `restore_resharded` fnum 4 -> 2 equals JAX's;
  the refusals (a single-file layout, another graph, a partition-mode
  mismatch) raise the same types.
* The gang lane runs two CLI ranks over gloo (`--device cpu`, p2p-31,
  fnum 4): `--checkpoint_every 2` then `--resume` on the same mesh, byte
  for byte; `kill_rank@4:1` then a one-process fnum-2 resume whose files
  equal the JAX one-process fnum-2 `Worker`'s (PageRank within 1e-4) and
  pass the goldens; a raise-mode kill halting both ranks under one
  incident; `--guard halt` with no fault, equal to one process.  Every
  child runs under a subprocess timeout and its group under
  GRAPE_DIST_TIMEOUT_S.
* The full `fault_drill.py --kill_rank` drill is a slow test.
"""

import glob
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.ft import checkpoint as jck
from libgrape_lite_tpu.ft import distributed as jdist
from libgrape_lite_tpu.ft.fingerprint import (
    compute_fingerprint as jcompute_fingerprint,
)
from libgrape_lite_tpu.models import APP_REGISTRY as JREG
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.ft import checkpoint as ck
from libgrape_lite_tpu_torch.ft import distributed as dist_ft
from libgrape_lite_tpu_torch.ft.checkpoint import (
    CheckpointMismatchError,
    CorruptCheckpointError,
)
from libgrape_lite_tpu_torch.ft.faults import (
    FaultPlan,
    InjectedFault,
    maybe_kill_between_phases,
)
from libgrape_lite_tpu_torch.ft.fingerprint import (
    canonical_query_args,
    compute_fingerprint,
)
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.obs import gang
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import QueryArgs, run_app
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_dist import free_port, run_gang
from tests.test_torch_gang import ThreadGather, run_ranks
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P2P = (dataset_path("p2p-31.e"), dataset_path("p2p-31.v"))
QUERY = {"sssp": {"source": 6}, "bfs": {"source": 6}, "wcc": {},
         "pagerank": {"delta": 0.85, "max_round": 10}}
_FRAGS = {}


def frag_of(fnum: int, rank=None):
    """The port's p2p-31 fragment at `fnum`: one process (rank None), or
    rank r's view of a two-rank group (its slab placed; no group needed
    to build it)."""
    key = (fnum, rank)
    if key not in _FRAGS:
        spec = (CommSpec(fnum, "cpu") if rank is None
                else CommSpec(fnum, "cpu", rank=rank, world=2))
        _FRAGS[key] = LoadGraph(*P2P, spec, LoadGraphSpec(
            weighted=True, edata_dtype=np.float64))
    return _FRAGS[key]


def port_app(name: str):
    """The port's app with the JAX tests' x64 carries where it takes a
    dtype."""
    cls = APP_REGISTRY[name]
    return cls(dtype=torch.float64) if name in ("sssp", "pagerank") \
        else cls()


def _solo_comm():
    return dist_ft._HostComm(rank=0, nprocs=1,
                             allgather=lambda v: np.asarray(v)[None])


def _mgr(directory, frag, fingerprint=None, comm=None, **kw):
    return dist_ft.ShardedCheckpointManager(
        str(directory), fingerprint=fingerprint or {"app": "t"},
        query_args=kw.pop("query_args", {}),
        checkpoint_every=kw.pop("checkpoint_every", 2), frag=frag,
        comm=comm or _solo_comm(), **kw)


def _state(fnum, vp):
    rng = np.random.default_rng(0)
    return {"dist": rng.random((fnum, vp)).astype(np.float64),
            "aux": np.arange(3, dtype=np.int32)}  # a replicated leaf


# ---- the two-phase commit ----------------------------------------------------


def test_sharded_commit_roundtrip_reads_in_both_packages(graph_cache,
                                                         tmp_path):
    """Stage + commit writes the rank shard and a sharded meta.json whose
    manifest is the JAX manager's for the same state; both packages'
    `load_sharded_state` and `restore_latest` gather the same carry."""
    frag, jfrag = frag_of(2), graph_cache(2)
    state = _state(frag.fnum, frag.vp)
    _mgr(tmp_path / "ck", frag).save_async(state, rounds=4, active=5)
    jdist.ShardedCheckpointManager(
        str(tmp_path / "jck"), fingerprint={"app": "t"}, query_args={},
        checkpoint_every=2, frag=jfrag,
        comm=jdist._HostComm(rank=0, nprocs=1,
                             allgather=lambda v: np.asarray(v)[None]),
    ).save_async(state, rounds=4, active=5)
    (_, path), = ck.list_checkpoints(str(tmp_path / "ck"))
    (_, jpath), = jck.list_checkpoints(str(tmp_path / "jck"))
    meta, jmeta = ck.read_meta(path), jck.read_meta(jpath)
    assert set(meta) == set(jmeta)
    for k in ("layout", "ranks", "fnum", "vp", "rounds", "active",
              "leaves"):
        assert meta[k] == jmeta[k], k
    for k in ("leaves", "oid_rows"):
        assert meta["shards"]["0"][k] == jmeta["shards"]["0"][k]
    assert sorted(os.listdir(path)) == sorted(os.listdir(jpath)) == [
        "meta.json", "rank_0.json", "rank_0.npz"]
    for load in (dist_ft.load_sharded_state, jdist.load_sharded_state):
        got = load(path, meta)
        assert set(got) == set(state)
        for k in state:
            assert got[k].tobytes() == state[k].tobytes()
    for restore in (ck.restore_latest, jck.restore_latest):
        restored, rmeta = restore(str(tmp_path / "ck"), {"app": "t"})
        assert (rmeta["rounds"], rmeta["active"]) == (4, 5)
        assert restored["dist"].tobytes() == state["dist"].tobytes()


def test_stage_without_commit_never_adopted(tmp_path):
    frag = frag_of(2)
    mgr = _mgr(tmp_path / "ck", frag)
    stage = str(tmp_path / "ck" / ".stage-00000004")
    os.makedirs(stage)
    mgr._stage_local(_state(frag.fnum, frag.vp), 4, 5, stage)
    assert not os.path.exists(os.path.join(stage, "meta.json"))
    assert ck.list_checkpoints(str(tmp_path / "ck")) == []
    _mgr(tmp_path / "ck", frag)  # construction sweeps the partial
    assert not os.path.exists(stage)


def test_commit_refuses_corrupted_stage(tmp_path):
    frag = frag_of(2)
    mgr = _mgr(tmp_path / "ck", frag)
    stage = str(tmp_path / "ck" / ".stage-00000004")
    os.makedirs(stage)
    sha, _ = mgr._stage_local(_state(frag.fnum, frag.vp), 4, 5, stage)
    npz = os.path.join(stage, "rank_0.npz")
    with open(npz, "rb") as fh:
        blob = bytearray(fh.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(npz, "wb") as fh:
        fh.write(bytes(blob))
    lo, hi = dist_ft._sha_prefix(sha)
    assert (lo, hi) == jdist._sha_prefix(sha)
    with pytest.raises(CorruptCheckpointError, match="refusing to commit"):
        mgr._commit(stage, 4, 5, np.asarray([[1, 4, lo, hi]], np.int32))
    assert not os.path.exists(str(tmp_path / "ck" / "ckpt_00000004"))


def test_stage_failure_fails_every_rank(tmp_path):
    """A rank voting its stage failed is a gang-wide CorruptCheckpointError
    at the first barrier (nobody commits); a rank out of step is a
    lockstep error."""
    frag = frag_of(2)

    def peer(flip):
        def allgather(vec):
            v = np.asarray(vec, np.int32)
            p = v.copy()
            if p.shape[0] > 1:
                flip(p)
            return np.stack([v, p])
        return allgather

    def failed(p):
        p[0] = 0

    def skewed(p):
        p[1] += 1

    mgr = _mgr(tmp_path / "a", frag, comm=dist_ft._HostComm(
        rank=0, nprocs=2, allgather=peer(failed)))
    with pytest.raises(CorruptCheckpointError, match=r"rank\(s\) \[1\]"):
        mgr.save_async(_state(frag.fnum, frag.vp), rounds=2, active=3)
    mgr = _mgr(tmp_path / "b", frag, comm=dist_ft._HostComm(
        rank=0, nprocs=2, allgather=peer(skewed)))
    with pytest.raises(RuntimeError, match="out of lockstep"):
        mgr.save_async(_state(frag.fnum, frag.vp), rounds=2, active=3)
    assert ck.list_checkpoints(str(tmp_path / "a")) == []


def test_two_phase_kill_hook_parses_like_jax(monkeypatch):
    monkeypatch.setenv("GRAPE_FT_2PC_KILL", "4")
    with pytest.raises(ValueError, match="is not K:R"):
        maybe_kill_between_phases(4, 1)
    with pytest.raises(ValueError, match="is not K:R"):
        jdist._maybe_kill_between_phases(4, 1)
    monkeypatch.setenv("GRAPE_FT_2PC_KILL", "4:1")
    maybe_kill_between_phases(4, 0)  # another rank: no-op
    maybe_kill_between_phases(2, 1)  # another superstep: no-op


def test_replicated_leaf_divergence_is_corrupt_in_both(tmp_path):
    step = tmp_path / "ckpt_00000004"
    step.mkdir()
    fnum, vp = 2, 3
    dist = np.arange(fnum * vp, dtype=np.float64).reshape(fnum, vp)
    shards = {}
    for r in range(2):
        aux = np.arange(3, dtype=np.int32) + (7 if r else 0)
        buf = io.BytesIO()
        np.savez(buf, dist=dist[r][None], aux=aux,
                 **{f"__oids_{r}": np.arange(vp, dtype=np.int64)})
        blob = buf.getvalue()
        (step / f"rank_{r}.npz").write_bytes(blob)
        shards[str(r)] = {
            "sha256": hashlib.sha256(blob).hexdigest(), "oid_rows": [r],
            "leaves": {"dist": {"rows": [r], "shape": [fnum, vp],
                                "dtype": "<f8"},
                       "aux": {"replicated": True, "shape": [3],
                               "dtype": "<i4"}}}
    meta = {"fnum": fnum, "vp": vp, "shards": shards,
            "leaves": {"dist": {"shape": [fnum, vp], "dtype": "<f8"},
                       "aux": {"shape": [3], "dtype": "<i4"}}}
    with pytest.raises(CorruptCheckpointError, match="diverges"):
        dist_ft.load_sharded_state(str(step), meta)
    with pytest.raises(jck.CorruptCheckpointError, match="diverges"):
        jdist.load_sharded_state(str(step), meta)


# ---- two-rank lineages in threads ---------------------------------------------


class _Shard:
    def __init__(self, start, data):
        self.index = (slice(start, start + data.shape[0]),)
        self.data = data


class _ShardedLeaf:
    """A leaf as a JAX process of a mesh sees it: its addressable rows."""

    def __init__(self, start, data):
        self.addressable_shards = [_Shard(start, data)]


def write_port_lineage(directory, full: dict, rounds, active, *,
                       fingerprint, query_args, replicated=()):
    """`full` ([fnum, vp] leaves) committed as a two-rank sharded lineage
    by the port's managers, one thread a rank over its slab fragment."""
    g = ThreadGather(2)

    def rank(r):
        frag = frag_of(4, r)
        slab = {k: (v if k in replicated else v[2 * r:2 * r + 2])
                for k, v in full.items()}
        dist_ft.ShardedCheckpointManager(
            str(directory), fingerprint=fingerprint, query_args=query_args,
            checkpoint_every=2, frag=frag, replicated_keys=replicated,
            comm=dist_ft._HostComm(rank=r, nprocs=2, allgather=g.of(r)),
        ).save_async(slab, rounds, active)

    run_ranks(rank, 2)


def write_jax_lineage(directory, full: dict, rounds, active, *, jfrag,
                      fingerprint, query_args, replicated=()):
    """The same through the JAX managers, each thread's leaves holding
    only its rank's rows (as `addressable_shards`)."""
    g = ThreadGather(2)

    def rank(r):
        leaves = {k: (v if k in replicated
                      else _ShardedLeaf(2 * r, v[2 * r:2 * r + 2]))
                  for k, v in full.items()}
        jdist.ShardedCheckpointManager(
            str(directory), fingerprint=fingerprint, query_args=query_args,
            checkpoint_every=2, frag=jfrag,
            comm=jdist._HostComm(rank=r, nprocs=2, allgather=g.of(r)),
        ).save_async(leaves, rounds, active)

    run_ranks(rank, 2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_two_rank_lineage_reads_in_both_packages(graph_cache, tmp_path,
                                                 writer):
    """A rank writes global fragment rows fid_lo .. fid_lo + fl - 1 and
    their vertex maps: the shard files name the rows JAX's do, and the
    gathered carry is the same in both packages."""
    full = _state(4, frag_of(4).vp)
    d = tmp_path / "ck"
    if writer == "port":
        write_port_lineage(d, full, 6, 9, fingerprint={"app": "t"},
                           query_args={}, replicated=("aux",))
    else:
        write_jax_lineage(d, full, 6, 9, jfrag=graph_cache(4),
                          fingerprint={"app": "t"}, query_args={},
                          replicated=("aux",))
    (_, path), = ck.list_checkpoints(str(d))
    meta = ck.read_meta(path)
    assert (meta["layout"], meta["ranks"], meta["fnum"]) == ("sharded", 2, 4)
    for r in (0, 1):
        sh = meta["shards"][str(r)]
        assert sh["leaves"]["dist"]["rows"] == [2 * r, 2 * r + 1]
        assert sh["oid_rows"] == [2 * r, 2 * r + 1]
        assert sh["leaves"]["aux"]["replicated"] is True
    for load in (dist_ft.load_sharded_state, jdist.load_sharded_state):
        got = load(path, meta)
        for k in full:
            assert got[k].tobytes() == full[k].tobytes(), k
    oids = dist_ft.load_shard_layout(path, meta)
    assert oids.keys() == jdist.load_shard_layout(path, meta).keys()
    for f in range(4):
        np.testing.assert_array_equal(oids[f], frag_of(4).inner_oids(f))


def _kill_carry(name, tmp_path, make=port_app):
    """The port's carry at superstep 4 of a fnum-4 query killed there
    (raise mode), from its single-file lineage."""
    d = str(tmp_path / f"kill_{name}")
    with pytest.raises(InjectedFault):
        Worker(make(name), frag_of(4)).query(
            checkpoint_every=2, checkpoint_dir=d,
            fault_plan=FaultPlan(kill_at_superstep=4, mode="raise"),
            **QUERY[name])
    rounds, path = ck.list_checkpoints(d)[-1]
    meta = ck.read_meta(path)
    return ck.load_state(path, meta), meta


def _values_close(got, want, name):
    if name == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12)
    else:
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_lineages_cross_both_ways(graph_cache, tmp_path, name, writer):
    """A two-rank fnum-4 lineage written by one package resumes through
    the other's `Worker` onto fnum 2 (a reshard) and finishes as a cold
    fnum-2 query of the resuming package: SSSP bit-equal, PageRank
    within 1e-4."""
    full, kmeta = _kill_carry(name, tmp_path)
    rep = tuple(sorted(getattr(port_app(name), "replicated_keys", ())))
    fp = compute_fingerprint(port_app(name), frag_of(4), QUERY[name],
                             carry=full)
    jfp = jcompute_fingerprint(JREG[name](), graph_cache(4), QUERY[name])
    assert fp == jfp  # one query identity in both packages
    d = tmp_path / "shard"
    kw = dict(fingerprint=fp, query_args=canonical_query_args(QUERY[name]),
              replicated=rep)
    if writer == "port":
        write_port_lineage(d, full, 4, int(kmeta["active"]), **kw)
    else:
        write_jax_lineage(d, full, 4, int(kmeta["active"]),
                          jfrag=graph_cache(4), **kw)
    if writer == "port":  # the JAX Worker resumes the port's lineage
        w = JWorker(JREG[name](), graph_cache(2))
        w.resume(str(d))
        cold = JWorker(JREG[name](), graph_cache(2))
    else:
        w = Worker(port_app(name), frag_of(2))
        w.resume(str(d))
        cold = Worker(port_app(name), frag_of(2))
    cold.query(**QUERY[name])
    assert w.rounds > 4  # resumed mid-query, not from scratch
    _values_close(np.asarray(w.result_values()),
                  np.asarray(cold.result_values()), name)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_restore_resharded_matches_jax(graph_cache, tmp_path, name):
    full, kmeta = _kill_carry(name, tmp_path)
    rep = tuple(sorted(getattr(port_app(name), "replicated_keys", ())))
    fp = compute_fingerprint(port_app(name), frag_of(4), QUERY[name],
                             carry=full)
    d = tmp_path / "shard"
    write_port_lineage(d, full, 4, int(kmeta["active"]), fingerprint=fp, query_args=canonical_query_args(
                           QUERY[name]), replicated=rep)
    app2, japp2 = port_app(name), JREG[name]()
    base = {k: v.numpy() for k, v in app2.init_state(
        frag_of(2), **QUERY[name]).items() if k in full}
    jbase = {k: np.asarray(v) for k, v in japp2.init_state(
        graph_cache(2), **QUERY[name]).items() if k in full}
    got, meta = dist_ft.restore_resharded(
        str(d), frag_of(2), compute_fingerprint(
            port_app(name), frag_of(2), QUERY[name], carry=base),
        base_state=base)
    want, jmeta = jdist.restore_resharded(
        str(d), graph_cache(2), jcompute_fingerprint(
            JREG[name](), graph_cache(2), QUERY[name]), base_state=jbase)
    assert set(got) == set(want) == set(full)
    for k in got:
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == np.asarray(want[k]).astype(
            got[k].dtype).tobytes(), k
    assert meta["resharded_from"] == jmeta["resharded_from"] == {
        "fnum": 4, "vp": frag_of(4).vp, "ranks": 2}


def test_reshard_refusals_match_jax(graph_cache, tmp_path, monkeypatch):
    """A single-file lineage, another graph and a partition-mode mismatch
    raise CheckpointMismatchError in both packages."""
    d = str(tmp_path / "single")
    Worker(port_app("sssp"), frag_of(4)).query(
        checkpoint_every=3, checkpoint_dir=d, source=6)
    base = {"dist": np.zeros((2, frag_of(2).vp))}
    fp2 = compute_fingerprint(port_app("sssp"), frag_of(2), {"source": 6})
    with pytest.raises(CheckpointMismatchError, match="original mesh"):
        dist_ft.restore_resharded(d, frag_of(2), fp2, base_state=base)
    with pytest.raises(jck.CheckpointMismatchError, match="original mesh"):
        jdist.restore_resharded(d, graph_cache(2), fp2, base_state=base)

    frag = frag_of(2)
    _mgr(tmp_path / "ck", frag).save_async(_state(frag.fnum, frag.vp), 2, 3)

    class Shrunk:
        fnum, vp = frag.fnum, frag.vp

        @staticmethod
        def inner_oids(f):
            oids = np.asarray(frag.inner_oids(f), np.int64)
            return oids[:-1] if f == 0 else oids  # one vertex dropped

        oid_to_pid = staticmethod(frag.oid_to_pid)

    for restore, exc in ((dist_ft.restore_resharded,
                          CheckpointMismatchError),
                         (jdist.restore_resharded,
                          jck.CheckpointMismatchError)):
        with pytest.raises(exc, match="universes differ"):
            restore(str(tmp_path / "ck"), Shrunk, {"app": "t"},
                    base_state=_state(frag.fnum, frag.vp))
        with pytest.raises(exc, match="partition_mode"):
            restore(str(tmp_path / "ck"), frag, {"app": "t",
                                                 "partition_mode": "2d"},
                    base_state=_state(frag.fnum, frag.vp))
    monkeypatch.setenv("GRAPE_PARTITION", "2d")
    with pytest.raises(CheckpointMismatchError, match="partition_mode"):
        Worker(port_app("sssp"), frag_of(4)).resume(d)


def test_reshard_readdresses_wcc_labels(graph_cache, tmp_path):
    """WCC's labels are pids: the worker's reshard maps them by oid onto
    the new layout (the app's inc_value_map) and folds in the fresh init,
    so the resumed fnum-2 files equal a cold fnum-2 query's byte for byte
    (and the JAX package's)."""
    full, kmeta = _kill_carry("wcc", tmp_path)
    fp = compute_fingerprint(port_app("wcc"), frag_of(4), {}, carry=full)
    d = tmp_path / "shard"
    write_port_lineage(d, full, 4, int(kmeta["active"]), fingerprint=fp,
                       query_args={})
    w = Worker(port_app("wcc"), frag_of(2))
    w.resume(str(d))
    w.output(str(tmp_path / "res"))
    jw = JWorker(JREG["wcc"](), graph_cache(2))
    jw.query()
    jw.output(str(tmp_path / "cold"))
    assert _read(str(tmp_path / "res"), 2) == _read(str(tmp_path / "cold"), 2)


# ---- real gloo gangs ------------------------------------------------------------


def _read(prefix, fnum):
    out = []
    for f in range(fnum):
        with open(os.path.join(prefix, f"result_frag_{f}")) as fh:
            out.append(fh.read())
    return out


CLI_FLAGS = {"sssp": ["--sssp_source", "6"], "bfs": ["--bfs_source", "6"],
             "wcc": [], "pagerank": ["--pr_d", "0.85", "--pr_mr", "10"]}
GOLDEN = {"sssp": ("p2p-31-SSSP", exact_verify),
          "bfs": ("p2p-31-BFS", exact_verify),
          "wcc": ("p2p-31-WCC", wcc_verify),
          "pagerank": ("p2p-31-PR", eps_verify)}


def cli_gang(app, prefix, *flags, **env):
    """A two-rank CLI gang at fnum 4 on p2p-31; rank 1's --out_prefix
    gets `_r1` (nothing may land there)."""
    port = free_port()
    return run_gang(lambda r: [
        sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
        "--application", app, "--efile", P2P[0], "--vfile", P2P[1],
        "--out_prefix", prefix + (f"_r{r}" if r else ""), "--fnum", "4",
        "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(r), *CLI_FLAGS[app],
        *flags], 2, **env)


def jax_files(graph_cache, tmp_path, app, fnum):
    w = JWorker(JREG[app](), graph_cache(fnum))
    w.query(**QUERY[app])
    w.output(str(tmp_path / f"jax_{app}_{fnum}"))
    return _read(str(tmp_path / f"jax_{app}_{fnum}"), fnum)


def check_files(app, got, want):
    res = load_result_lines("".join(got))
    if app == "pagerank":
        eps_verify(res, load_result_lines("".join(want)))
    else:
        assert got == want
    golden, verify = GOLDEN[app]
    verify(res, load_golden(dataset_path(golden)))


def test_gang_checkpoint_then_resume_same_mesh(graph_cache, tmp_path):
    """--checkpoint_every 2 across two ranks writes a two-rank sharded
    lineage and the JAX Worker's files; --resume on the same mesh picks
    it up (restore_latest's sharded read, each rank its slab) and writes
    the same files."""
    ckdir = str(tmp_path / "ck")
    first = str(tmp_path / "first")
    for rc, so, se in cli_gang("sssp", first, "--checkpoint_every", "2",
                               "--checkpoint_dir", ckdir):
        assert rc == 0, se[-3000:]
    got = _read(first, 4)
    check_files("sssp", got, jax_files(graph_cache, tmp_path, "sssp", 4))
    rounds, path = ck.list_checkpoints(ckdir)[-1]
    meta = ck.read_meta(path)
    assert (meta["layout"], meta["ranks"]) == ("sharded", 2)
    assert meta["fingerprint"]["processes"] == 2
    again = str(tmp_path / "again")
    outs = cli_gang("sssp", again, "--resume", "--checkpoint_dir", ckdir,
                    "--profile")
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
        assert f"resumed from superstep {rounds}" in se
    assert _read(again, 4) == got
    assert not os.path.exists(again + "_r1")


@pytest.mark.parametrize("app", ["sssp", "bfs", "wcc", "pagerank"])
def test_gang_kill_rank_then_one_process_reshard(graph_cache, tmp_path,
                                                 app):
    """kill_rank@4:1 kills rank 1 after superstep 4's commit (exit 17);
    rank 0 loses its peer and fails (no hang: the group's timeout); one
    process then resumes the two-rank lineage onto fnum 2, and its files
    equal the JAX one-process fnum-2 Worker's and pass the goldens."""
    ckdir = str(tmp_path / "ck")
    outs = cli_gang(app, str(tmp_path / "gang"), "--checkpoint_every", "2",
                    "--checkpoint_dir", ckdir,
                    GRAPE_FT_FAULTS="kill_rank@4:1")
    assert outs[1][0] == 17, outs[1][2][-3000:]
    assert outs[0][0] != 0
    rounds, path = ck.list_checkpoints(ckdir)[-1]
    meta = ck.read_meta(path)
    assert (rounds, meta["layout"], meta["ranks"]) == (4, "sharded", 2)
    res = str(tmp_path / "res")
    run_app(QueryArgs(application=app, efile=P2P[0], vfile=P2P[1], fnum=2,
                      resume=True, checkpoint_dir=ckdir, out_prefix=res,
                      device="cpu"))
    check_files(app, _read(res, 2), jax_files(graph_cache, tmp_path, app, 2))


def test_gang_resumes_a_lineage_resharded_onto_two_ranks(graph_cache,
                                                       tmp_path):
    """A two-rank fnum-4 lineage resumed by a two-rank gang at fnum 2:
    every rank gathers the fresh carry, reshards the lineage onto it and
    keeps its own rows; the files equal the JAX fnum-2 Worker's."""
    full, kmeta = _kill_carry("sssp", tmp_path,
                              make=lambda name: APP_REGISTRY[name]())
    ckdir = str(tmp_path / "ck")
    write_port_lineage(ckdir, full, 4, int(kmeta["active"]),
                       fingerprint=kmeta["fingerprint"],
                       query_args=kmeta["query_args"])
    port = free_port()
    outs = run_gang(lambda r: [
        sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
        "--application", "sssp", "--efile", P2P[0], "--vfile", P2P[1],
        "--out_prefix", str(tmp_path / "res"), "--fnum", "2", "--device",
        "cpu", "--resume", "--checkpoint_dir", ckdir, "--coordinator",
        f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
        str(r)], 2)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
        assert "resharded checkpoint" in se
    check_files("sssp", _read(str(tmp_path / "res"), 2),
                jax_files(graph_cache, tmp_path, "sssp", 2))


def test_gang_raise_mode_kill_halts_both_ranks(tmp_path):
    """kill_rank@4:1 in raise mode travels the breach vote: rank 1 raises
    its InjectedFault, rank 0 a RemoteBreachError naming rank 1, both exit
    non-zero; their postmortem shards land under one incident with a
    byte-verified manifest, and their trace sidecars merge complete."""
    pm, trace = str(tmp_path / "pm"), str(tmp_path / "t.json")
    outs = cli_gang("sssp", str(tmp_path / "out"), "--checkpoint_every",
                    "2", "--checkpoint_dir", str(tmp_path / "ck"),
                    GRAPE_FT_FAULTS="kill_rank@4:1,mode=raise",
                    GRAPE_POSTMORTEM=pm, GRAPE_TRACE=trace)
    assert outs[0][0] not in (0, None) and outs[1][0] not in (0, None)
    assert "RemoteBreachError" in outs[0][2]
    assert "halt voted at superstep 4: rank 1: injected fault" in outs[0][2]
    assert "injected kill of rank 1 at superstep 4" in outs[1][2]
    incidents = glob.glob(os.path.join(pm, "incident_*"))
    assert len(incidents) == 1
    with open(os.path.join(incidents[0], "gang.json")) as fh:
        man = json.load(fh)
    assert man["complete"] and man["nprocs"] == 2
    assert sorted(man["shards"]) == ["0", "1"]
    s = gang.assemble(str(tmp_path / "t.gang"))
    assert s["complete"] and s["ranks"] == [0, 1]
    assert s["cross_rank_flows"] >= 1 and s["monotonic"]


def test_gang_guard_halt_no_fault_equals_one_process(graph_cache, tmp_path):
    """--guard halt across two ranks probes every round (the global
    verdict; the vote a round) and writes one process's files."""
    outs = cli_gang("pagerank", str(tmp_path / "guarded"), "--guard",
                    "halt", "--profile")
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
        assert "guard: probes every 1 round(s) (policy=halt)" in se
    one = str(tmp_path / "one")
    run_app(QueryArgs(application="pagerank", efile=P2P[0], vfile=P2P[1],
                      fnum=4, pr_d=0.85, pr_mr=10, out_prefix=one,
                      device="cpu"))
    got = _read(str(tmp_path / "guarded"), 4)
    assert got == _read(one, 4)
    check_files("pagerank", got,
                jax_files(graph_cache, tmp_path, "pagerank", 4))


@pytest.mark.slow
def test_kill_rank_reshard_drill(tmp_path):
    """The acceptance drill end to end through the CLI (JAX
    `test_kill_rank_reshard_drill`): exit 0, byte-identical files, the
    gang telemetry complete."""
    r = subprocess.run(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.scripts.fault_drill",
         "--kill_rank", "--device", "cpu", "--workdir",
         str(tmp_path / "drill")],
        cwd=REPO, capture_output=True, text=True, timeout=570,
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads([ln for ln in r.stdout.splitlines()
                      if '"ft_drill"' in ln][-1])["ft_drill"]
    assert rec["byte_identical"] is True and rec["ranks"] == 2
    assert rec["gang_trace_complete"] and rec["gang_bundle_verified"]
    assert rec["gang_cross_rank_flows"] >= 1
