"""The port's multi-process runtime on the CPU (gloo), against the JAX
package.

* The CLI checks of `run_app --coordinator / --num_processes /
  --process_id` raise the JAX package's texts, before any load.
* `host_allgather` and `LocalIOAdaptor` equal the JAX functions.
* The collectives of a process group (two spawned gloo ranks, and one)
  equal the single-process `Communicator` / `StepContext` on the full
  stack; `sum` is bit-equal to the one-process fold and stable on rerun.
* End to end: CLI gangs (`--device cpu`, two ranks at fnum 2 and 4, four
  ranks at fnum 4 for SSSP) write the result files of the JAX package's
  single-process `Worker` at the same fnum -- byte for byte for sssp, bfs
  and wcc, within 1e-4 for pagerank -- in the same number of rounds,
  and pass the goldens.
* What a gang declines raises before the load, naming ROADMAP item 8b.4
  or 8c.  (Checkpoints, resumes, guards and fault plans run across ranks:
  tests/test_torch_dist_ft.py.)

Every child runs under a subprocess timeout and the group under
GRAPE_DIST_TIMEOUT_S, so a stuck rank fails the test instead of hanging
it.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.io.io_adaptor import LocalIOAdaptor as JIOAdaptor
from libgrape_lite_tpu.models import BFS as JBFS
from libgrape_lite_tpu.models import PageRank as JPageRank
from libgrape_lite_tpu.models import SSSP as JSSSP
from libgrape_lite_tpu.models import WCC as JWCC
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.parallel.comm_spec import host_allgather as jgather
from libgrape_lite_tpu.runner import QueryArgs as JQueryArgs
from libgrape_lite_tpu.runner import run_app as jrun_app
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.ft import retry
from libgrape_lite_tpu_torch.io import LocalIOAdaptor
from libgrape_lite_tpu_torch.models import CDLP, SSSP, PageRank
from libgrape_lite_tpu_torch.parallel import comm_spec as cs
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import QueryArgs, run_app
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
P2P = (dataset_path("p2p-31.e"), dataset_path("p2p-31.v"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GRAPE_")}
    env.update(GRAPE_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO, **extra)
    return env


def run_gang(argv_of, world: int, **env):
    """Start `world` children (`argv_of(rank)`), wait for all of them
    under the subprocess timeout, and return their (rc, stdout, stderr)
    in rank order; a child past the timeout is killed with the rest."""
    procs = [subprocess.Popen(argv_of(r), cwd=REPO, env=child_env(**env),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=CHILD_TIMEOUT_S)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


# ---- the CLI checks, before any load ----------------------------------------

def _raised(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_cli_checks_match_jax_before_any_load(tmp_path):
    """No coordinator, and a prebuilt comm_spec with the flags: the port
    raises the JAX text, and no edge file is read (it does not exist)."""
    missing = str(tmp_path / "absent.e")
    base = dict(application="sssp", efile=missing, num_processes=2)
    got = _raised(run_app, QueryArgs(process_id=0, device="cpu", **base))
    want = _raised(jrun_app, JQueryArgs(process_id=0, **base))
    assert got == want and "--coordinator" in got
    flags = dict(base, coordinator="127.0.0.1:1", process_id=1)
    got = _raised(run_app, QueryArgs(device="cpu", **flags),
                  comm_spec=CommSpec(2, "cpu"))
    want = _raised(jrun_app, JQueryArgs(**flags), comm_spec=JCommSpec(2))
    assert got == want and "EITHER" in got


def test_host_allgather_single_process_matches_jax():
    for v in (np.arange(5, dtype=np.int64), np.array([0.5, -2.0]),
              np.zeros((2, 3), np.int32)):
        got, want = cs.host_allgather(v), jgather(v)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts", range(1, 9))
def test_io_adaptor_partial_reads_match_jax(parts):
    path = dataset_path("p2p-31.e")
    chunks = []
    for i in range(parts):
        with LocalIOAdaptor(path) as a, JIOAdaptor(path) as j:
            a.set_partial_read(i, parts)
            j.set_partial_read(i, parts)
            got = a.read_bytes()
            assert got == j.read_bytes()
            chunks.append(got)
    with open(path, "rb") as f:
        assert b"".join(chunks) == f.read()


def test_backend_choice_is_explicit(monkeypatch):
    """NCCL with two local ranks on one card raises and names the gloo
    choice; GRAPE_DIST_BACKEND=gloo on CUDA stages through the host; the
    CPU takes gloo and refuses nccl."""
    monkeypatch.delenv(cs.DIST_BACKEND_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    with pytest.raises(RuntimeError, match="GRAPE_DIST_BACKEND=gloo"):
        cs.pick_backend(cuda, 2)
    assert cs.pick_backend(cuda, 1) == ("nccl", False)
    assert cs.pick_backend(torch.device("cpu"), 2) == ("gloo", False)
    monkeypatch.setenv(cs.DIST_BACKEND_ENV, "gloo")
    assert cs.pick_backend(cuda, 2) == ("gloo", True)
    monkeypatch.setenv(cs.DIST_BACKEND_ENV, "nccl")
    with pytest.raises(ValueError, match="CUDA"):
        cs.pick_backend(torch.device("cpu"), 2)
    monkeypatch.setenv(cs.DIST_BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="nccl\\|gloo"):
        cs.pick_backend(cuda, 1)


def test_retry_classifiers_know_torch_rendezvous_errors():
    from torch.distributed import DistNetworkError, DistStoreError

    transient = [
        DistNetworkError("The client socket has timed out after 3000ms "
                         "while trying to connect to (127.0.0.1, 29599)."),
        DistNetworkError("The server socket has failed to listen on any "
                         "local network address. port: 29500, code: -98, "
                         "name: EADDRINUSE, message: address already in "
                         "use"),
        RuntimeError("Connection refused"),
        DistStoreError("Timed out after 61 seconds waiting for clients. "
                       "1/2 clients joined."),
    ]
    for e in transient:
        assert retry.is_transient_distributed_error(e), e
        assert not retry.is_late_init_error(e), e
    twice = ValueError("trying to initialize the default process group "
                       "twice!")
    assert retry.is_late_init_error(twice)
    assert not retry.is_transient_distributed_error(twice)


def test_fnum_must_divide_among_ranks():
    with pytest.raises(ValueError, match="multiple of num_processes"):
        CommSpec(3, "cpu", rank=0, world=2)
    with pytest.raises(ValueError, match="multiple of num_processes"):
        CommSpec.init_distributed("127.0.0.1:1", 2, 0, fnum=3, device="cpu")
    spec = CommSpec(4, "cpu", rank=1, world=2)
    assert (spec.fl, spec.fid_lo, spec.is_coordinator) == (2, 2, False)
    assert [spec.frag_to_worker(f) for f in range(4)] == [0, 0, 1, 1]


# ---- collectives across spawned gloo ranks ----------------------------------

COLLECTIVES_CHILD = r'''
import sys
import numpy as np
import torch
from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.parallel.comm_spec import (
    CommSpec, host_allgather)

rank, world, port, fnum, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], int(sys.argv[4]), sys.argv[5])
spec = CommSpec.init_distributed(f"127.0.0.1:{port}", world, rank,
                                 fnum=fnum, device="cpu")
lo, hi = spec.fid_lo, spec.fid_lo + spec.fl
ctx = StepContext(fnum, spec=spec)
rng = np.random.default_rng(7)
t = torch.from_numpy
res = {}
for i in range(3):
    x = rng.standard_normal((fnum, 257, 3)).astype(np.float32) * 10 ** i
    res[f"sum{i}"] = ctx.sum(t(x)[lo:hi])
    res[f"sum{i}_rerun"] = ctx.sum(t(x)[lo:hi])
    res[f"min{i}"] = ctx.min(t(x)[lo:hi])
    res[f"max{i}"] = ctx.max(t(x)[lo:hi])
    res[f"all_gather{i}"] = ctx.all_gather(t(x)[lo:hi])
    res[f"all_gather_untiled{i}"] = ctx.all_gather(t(x)[lo:hi], tiled=False)
    perm = [(s, (s + 1 + i) % fnum) for s in range(fnum - 1)]
    res[f"ppermute{i}"] = ctx.ppermute(t(x)[lo:hi], perm)
a = rng.integers(0, 1000, (fnum, fnum, 3)).astype(np.int32)
res["all_to_all_00"] = ctx.all_to_all(t(a)[lo:hi], 0, 0)
b = rng.integers(0, 1000, (fnum, 2, fnum * 2)).astype(np.int32)
res["all_to_all_10"] = ctx.all_to_all(t(b)[lo:hi], 1, 0)
res["axis_index"] = ctx.axis_index()
res["axis_size"] = torch.tensor(ctx.axis_size())
state = rng.standard_normal((fnum, 16)).astype(np.float32)
lanes = rng.standard_normal((3, fnum, 16)).astype(np.float32)
send = rng.integers(0, 16, (fnum, fnum, 4)).astype(np.int64)
res["gather_state"] = ctx.gather_state(t(state)[lo:hi])
res["gather_lanes"] = ctx.gather_lanes(t(lanes)[:, lo:hi])
res["mirror_recv"] = ctx.mirror_recv(t(state)[lo:hi], t(send)[lo:hi])
res["exchange_mirrors"] = ctx.exchange_mirrors(t(lanes)[:, lo:hi],
                                               t(send)[lo:hi])
res["vote"] = ctx.vote(torch.tensor(rank + 1))
res["vote_replicated"] = ctx.vote(torch.tensor(1), replicated=True)
res["host_allgather"] = host_allgather(np.array([rank, 2 * rank]))
res["dist_calls"] = np.array(spec.stats["calls"])
try:
    CommSpec.init_distributed(f"127.0.0.1:{port}", world, rank, fnum=fnum,
                              device="cpu")
    res["double_init"] = np.array(0)
except RuntimeError as e:
    res["double_init"] = np.array(int("already joined" in str(e)))
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
spec.close()
'''


@pytest.fixture(scope="module", params=[2, 1], ids=["world2", "world1"])
def collectives(request, tmp_path_factory):
    world, fnum = request.param, 4
    d = tmp_path_factory.mktemp(f"coll{world}")
    script = d / "child.py"
    script.write_text(COLLECTIVES_CHILD)
    port = free_port()
    outs = run_gang(lambda r: [sys.executable, str(script), str(r),
                               str(world), str(port), str(fnum),
                               str(d / f"r{r}.npz")], world)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    return world, fnum, [dict(np.load(d / f"r{r}.npz"))
                         for r in range(world)]


def test_collectives_equal_the_single_process_fold(collectives):
    world, fnum, ranks = collectives
    one = StepContext(fnum)
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    want = {}
    for i in range(3):
        x = t(rng.standard_normal((fnum, 257, 3)).astype(np.float32)
              * 10 ** i)
        want[f"sum{i}"] = one.sum(x)
        want[f"sum{i}_rerun"] = one.sum(x)
        want[f"min{i}"] = one.min(x)
        want[f"max{i}"] = one.max(x)
        want[f"all_gather{i}"] = one.all_gather(x)
        want[f"all_gather_untiled{i}"] = one.all_gather(x, tiled=False)
        perm = [(s, (s + 1 + i) % fnum) for s in range(fnum - 1)]
        want[f"ppermute{i}"] = ("rows", one.ppermute(x, perm))
    a = t(rng.integers(0, 1000, (fnum, fnum, 3)).astype(np.int32))
    want["all_to_all_00"] = ("rows", one.all_to_all(a, 0, 0))
    b = t(rng.integers(0, 1000, (fnum, 2, fnum * 2)).astype(np.int32))
    want["all_to_all_10"] = ("rows", one.all_to_all(b, 1, 0))
    want["axis_index"] = ("rows", one.axis_index())
    want["axis_size"] = torch.tensor(fnum)
    state = t(rng.standard_normal((fnum, 16)).astype(np.float32))
    lanes = t(rng.standard_normal((3, fnum, 16)).astype(np.float32))
    send = t(rng.integers(0, 16, (fnum, fnum, 4)).astype(np.int64))
    want["gather_state"] = one.gather_state(state)
    want["gather_lanes"] = one.gather_lanes(lanes)
    want["mirror_recv"] = ("rows", one.mirror_recv(state, send))
    want["exchange_mirrors"] = ("lanes",
                                one.exchange_mirrors(lanes, send))
    want["vote"] = torch.tensor(sum(r + 1 for r in range(world)))
    want["vote_replicated"] = torch.tensor(1)
    want["host_allgather"] = torch.tensor(
        [[r, 2 * r] for r in range(world)])
    fl = fnum // world
    for r, got in enumerate(ranks):
        for k, w in want.items():
            if isinstance(w, tuple):  # this rank's slab of the stack
                kind, w = w
                w = w[r * fl:(r + 1) * fl] if kind == "rows" else \
                    w[:, r * fl:(r + 1) * fl]
            w = w.numpy()
            assert got[k].shape == w.shape, k
            # bit-equal, float sums included
            assert got[k].tobytes() == w.astype(got[k].dtype).tobytes(), k
        assert int(got["double_init"]) == 1  # refused, not retried
        assert int(got["dist_calls"]) > 0  # every collective crossed


# ---- end to end: CLI gangs against the JAX single-process Worker -----------

# app -> (CLI flags, JAX app, JAX query kwargs, golden, verifier, files)
CASES = {
    "sssp": (["--sssp_source", "6"], JSSSP, {"source": 6}, "p2p-31-SSSP",
             exact_verify, "equal"),
    "bfs": (["--bfs_source", "6"], JBFS, {"source": 6}, "p2p-31-BFS",
            exact_verify, "equal"),
    "wcc": ([], JWCC, {}, "p2p-31-WCC", wcc_verify, "equal"),
    "pagerank": (["--pr_d", "0.85", "--pr_mr", "10"], JPageRank,
                 {"delta": 0.85, "max_round": 10}, "p2p-31-PR", eps_verify,
                 "eps"),
}
_GANGS = {}


def _read(prefix, fnum):
    out = []
    for f in range(fnum):
        with open(os.path.join(prefix, f"result_frag_{f}")) as fh:
            out.append(fh.read())
    return out


def gang(tmp_root, app: str, fnum: int, world: int = 2):
    """(files, rounds) of one CLI gang, run once per (app, fnum, world)
    for the module.  Rank r > 0 is given its own `--out_prefix`
    (`<prefix>_r<r>`), where nothing may appear: only the coordinator
    writes."""
    key = (app, fnum, world)
    if key not in _GANGS:
        prefix = str(tmp_root / f"{app}_{fnum}_{world}")
        port = free_port()
        outs = run_gang(lambda r: [
            sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
            "--application", app, "--efile", P2P[0], "--vfile", P2P[1],
            "--out_prefix", prefix + (f"_r{r}" if r else ""),
            "--fnum", str(fnum), "--device", "cpu",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes",
            str(world), "--process_id", str(r), "--profile",
            *CASES[app][0]], world)
        for rc, so, se in outs:
            assert rc == 0, se[-3000:]
        rounds = [int(m[-1]) if (m := re.findall(r"IncEval round (\d+):",
                                                 se)) else 0
                  for _, _, se in outs]
        _GANGS[key] = (_read(prefix, fnum), rounds)
    return _GANGS[key]


@pytest.fixture(scope="module")
def gang_root(tmp_path_factory):
    return tmp_path_factory.mktemp("gangs")


@pytest.mark.parametrize("fnum", [2, 4])
@pytest.mark.parametrize("app", list(CASES))
def test_gang_files_equal_jax_worker(gang_root, tmp_path, graph_cache, app,
                                     fnum):
    flags, jcls, kw, golden, verify, rule = CASES[app]
    got, rounds = gang(gang_root, app, fnum)
    w = JWorker(jcls(), graph_cache(fnum))
    w.query(**kw)
    w.output(str(tmp_path / "jax"))
    want = _read(str(tmp_path / "jax"), fnum)
    res = load_result_lines("".join(got))
    if rule == "equal":
        assert got == want
    else:
        eps_verify(res, load_result_lines("".join(want)))
    verify(res, load_golden(dataset_path(golden)))
    # every rank ran the single-process rounds
    assert rounds == [w.rounds] * len(rounds)


def test_gang_of_four_sssp_equals_jax_worker(gang_root, tmp_path,
                                             graph_cache):
    got, rounds = gang(gang_root, "sssp", 4, world=4)
    w = JWorker(JSSSP(), graph_cache(4))
    w.query(source=6)
    w.output(str(tmp_path / "jax"))
    assert got == _read(str(tmp_path / "jax"), 4)
    assert rounds == [w.rounds] * 4


@pytest.mark.parametrize("app,fnum,world", [("bfs", 2, 2),
                                            ("sssp", 4, 4)])
def test_gang_writes_on_the_coordinator_only(gang_root, app, fnum, world):
    """The coordinator's prefix holds the fnum files; the other ranks'
    prefixes were never created."""
    gang(gang_root, app, fnum, world)
    base = f"{app}_{fnum}_{world}"
    assert sorted(os.listdir(gang_root / base)) == [
        f"result_frag_{f}" for f in range(fnum)]
    assert not any((gang_root / f"{base}_r{r}").exists()
                   for r in range(1, world))


def test_gang_serialization_cache_written_once(tmp_path, graph_cache):
    """--serialize in a gang: the coordinator alone writes the garc cache
    (the key is the one-process key, fnum 2), the other rank waits; a
    --deserialize gang then reads it, and both gangs' files equal the JAX
    Worker's."""
    cache = tmp_path / "ser"
    w = JWorker(JSSSP(), graph_cache(2))
    w.query(source=6)
    w.output(str(tmp_path / "jax"))
    want = _read(str(tmp_path / "jax"), 2)
    for flag in ("--serialize", "--deserialize"):
        prefix = str(tmp_path / flag.strip("-"))
        port = free_port()
        outs = run_gang(lambda r: [
            sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
            "--application", "sssp", "--sssp_source", "6",
            "--efile", P2P[0], "--vfile", P2P[1], "--out_prefix", prefix,
            "--fnum", "2", "--device", "cpu", flag,
            "--serialization_prefix", str(cache),
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
            "--process_id", str(r)], 2)
        for rc, so, se in outs:
            assert rc == 0, se[-3000:]
        assert _read(prefix, 2) == want
        garcs = sorted(p.relative_to(cache).parts[-2:]
                       for p in cache.rglob("frag.garc"))
        assert garcs == [("part_2", "frag.garc")]


# ---- what a gang declines --------------------------------------------------

DECLINES = [
    (dict(application="cdlp"), {}, "8c"),
    (dict(application="lcc"), {}, "8c"),
    (dict(delta_efile="d.e"), {}, "8b.4"),
    (dict(vc=True, application="pagerank"), {}, "8c"),
    ({}, {"GRAPE_PARTITION": "2d"}, "8c"),
    ({}, {"GRAPE_PIPELINE": "force"}, "8c"),
]


@pytest.mark.parametrize("flags,env,item", DECLINES)
def test_gang_declines_before_the_load(tmp_path, monkeypatch, flags, env,
                                       item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = dict(application="sssp", efile=str(tmp_path / "absent.e"),
                device="cpu", coordinator="127.0.0.1:1", num_processes=2,
                process_id=0)
    args.update(flags)
    if "checkpoint_dir" in args:
        args["checkpoint_dir"] = str(tmp_path / args["checkpoint_dir"])
    msg = _raised(run_app, QueryArgs(**args))
    assert f"ROADMAP item {item}" in msg and "world 2 > 1" in msg, msg


@pytest.fixture(scope="module")
def slab_frag():
    """Rank 0's view of a two-rank fnum-4 fragment (no group is needed
    to hit the declines: they read the world size)."""
    return LoadGraph(*P2P, CommSpec(4, "cpu", rank=0, world=2),
                     LoadGraphSpec(weighted=True, edata_dtype=np.float64))


def test_worker_declines_across_ranks(slab_frag):
    assert slab_frag.dev.ie.indptr.shape[0] == 2 and slab_frag.fl == 2
    for call, item in [
        (lambda: Worker(CDLP(), slab_frag).query(max_round=3), "8c"),
        (lambda: Worker(PageRank(spmv_mode="strict"), slab_frag).query(),
         "8c"),
        (lambda: Worker(SSSP(), slab_frag).query_batch(
            [{"source": 6}, {"source": 7}]), "8b.4"),
        (lambda: Worker(SSSP(), slab_frag).query_incremental({}), "8b.4"),
    ]:
        msg = _raised(call)
        assert f"ROADMAP item {item}" in msg, msg


def test_pipeline_declines_across_ranks(slab_frag, monkeypatch):
    from libgrape_lite_tpu_torch.parallel import pipeline

    monkeypatch.setenv("GRAPE_PIPELINE", "1")
    assert pipeline.resolve_pipeline(slab_frag, app_name="SSSP",
                                     key="dist") is None
    assert "item 8c" in pipeline.PIPELINE_STATS["last_decision"]["reason"]
