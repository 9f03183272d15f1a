"""The edge-cut variants across processes on the CPU (gloo), against one
process and the JAX package.

* CLI gangs (`--device cpu`, p2p-31 at fnum 4, two ranks; four for
  sssp_delta and pagerank_auto) of the SyncBuffer apps (sssp_auto,
  bfs_auto, wcc_auto, pagerank_auto, pagerank_push, pagerank_push_opt),
  the exchange apps' host loops (sssp_msg, bfs_msg, sssp_delta, sssp_opt,
  bfs_opt), wcc_opt and cdlp_opt (cdlp_opt_ud, cdlp_opt_ud_dense) write
  the files of the port's one-process CLI byte for byte (the PageRanks
  too: the proposals fold in fragment order) and of the JAX package's
  single-process `Worker` at fnum 4 (PageRank within 1e-4), in the same
  rounds on every rank; the exchange apps' capacity retries, bucket
  advances, push and pull rounds and settled capacity equal one
  process's on every rank (the `--profile` "host loop:" line).
* `sssp_select` under GRAPE_SSSP_PROBE_CAP=1: every rank picks
  `sssp_delta` and the gang writes its files.
* GRAPE_FT_FAULTS=capacity=8 on sssp_msg and bfs_opt: the same retries
  on every rank as in one process; `--guard halt` on sssp_delta and
  pagerank_auto: probes, no breach, the unguarded files;
  `--checkpoint_every 2` with kill@4 on pagerank_auto, then `--resume`:
  the uninterrupted files; `--delta_efile` loads of sssp_auto and
  sssp_delta: the goldens.
* Unit cases with no group (`tests/test_torch_gang.py::frag_of`): the
  push CSR, `dest_degree` and the own-slice fold on a rank's slab equal
  the whole stack's rows; `AutoParallelMessageManager.sync` and
  `round_scalars` over two slab ranks in threads (the all_to_all and
  all_gather through a thread barrier) equal one process's bit for bit.

A gang's children each run several CLI invocations in one process (one
group a run), so the file starts few processes; every gang runs under
the subprocess timeout and its groups under GRAPE_DIST_TIMEOUT_S, and
the gangs of the file start at once.
"""

import json
import os
import re
import subprocess
import sys
import threading
import types

import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.models import auto_apps
from libgrape_lite_tpu_torch.models.exchange_base import (
    dest_degree,
    round_scalars,
)
from libgrape_lite_tpu_torch.parallel.message_manager import (
    AutoParallelMessageManager,
)
from libgrape_lite_tpu_torch.runner import DIST_APP_NAMES
from libgrape_lite_tpu_torch.worker.worker import HOST_LOOP_DECISIONS
from tests.conftest import dataset_path
from tests.test_torch_dist import CHILD_TIMEOUT_S, P2P, REPO, child_env
from tests.test_torch_dist import free_port
from tests.test_torch_dist_apps import _read
from tests.test_torch_gang import frag_of, run_ranks
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
)

torch.set_num_threads(1)

FNUM = 4
_SSSP = (["--sssp_source", "6"], {"source": 6})
_BFS = (["--bfs_source", "6"], {"source": 6})
_PR = (["--pr_d", "0.85", "--pr_mr", "10"], {"delta": 0.85, "max_round": 10})
_CDLP = (["--cdlp_mr", "10"], {"max_round": 10})
# registry name -> (CLI flags, JAX query kwargs)
NAMES = {
    "sssp_auto": _SSSP, "bfs_auto": _BFS, "wcc_auto": ([], {}),
    "pagerank_auto": _PR, "pagerank_push": _PR, "pagerank_push_opt": _PR,
    "sssp_msg": _SSSP, "bfs_msg": _BFS, "sssp_delta": _SSSP,
    "sssp_opt": _SSSP, "bfs_opt": _BFS, "wcc_opt": ([], {}),
    "cdlp_opt": _CDLP, "cdlp_opt_ud": _CDLP, "cdlp_opt_ud_dense": _CDLP,
    "sssp_select": _SSSP,
}
PAGERANKS = {"pagerank_auto", "pagerank_push", "pagerank_push_opt"}
# the JAX app each name runs (sssp_select picks sssp_delta under the cap)
JAX_NAME = {"sssp_select": "sssp_delta"}
PROBE_CAP = {"GRAPE_SSSP_PROBE_CAP": "1"}

# gang -> (world, runs [(run, name, extra flags)], env)
GANGS = {
    "auto": (2, [(n, n, []) for n in (
        "sssp_auto", "bfs_auto", "wcc_auto", "pagerank_auto",
        "pagerank_push", "pagerank_push_opt", "sssp_select")], PROBE_CAP),
    "exchange": (2, [(n, n, []) for n in (
        "sssp_msg", "bfs_msg", "sssp_delta", "sssp_opt", "bfs_opt")], {}),
    "opt": (2, [(n, n, []) for n in (
        "wcc_opt", "cdlp_opt", "cdlp_opt_ud", "cdlp_opt_ud_dense")], {}),
    "world4": (4, [(f"{n}-world4", n, []) for n in (
        "sssp_delta", "pagerank_auto")], {}),
    "capacity": (2, [(f"{n}-capacity", n, []) for n in (
        "sssp_msg", "bfs_opt")], {"GRAPE_FT_FAULTS": "capacity=8"}),
    "guard": (2, [(f"{n}-guard", n, ["--guard", "halt"]) for n in (
        "sssp_delta", "pagerank_auto")], {}),
    "delta": (2, [(f"{n}-delta", n, [
        "--delta_efile", dataset_path("p2p-31.e.mutable_delta")])
        for n in ("sssp_auto", "sssp_delta")], {}),
    "killed": (2, [("pagerank_auto-killed", "pagerank_auto", [
        "--checkpoint_every", "2", "--checkpoint_dir", "{ck}"])],
        {"GRAPE_FT_FAULTS": "kill@4"}),
}
# one process: every name, and the capacity runs under the clamp
ONE = [(n, n, []) for n in NAMES]
ONE_CAPACITY = [(f"{n}-capacity", n, []) for n in ("sssp_msg", "bfs_opt")]

# A child: each argv of the JSON list through the CLI in turn, stderr
# marked "[run] <name>" before and "[rc] <code>" after each
CHILD = r"""
import json, sys
from libgrape_lite_tpu_torch import cli
for name, argv in json.loads(sys.argv[1]):
    print("[run] " + name, file=sys.stderr, flush=True)
    rc = cli.main(argv)
    print(f"[rc] {rc}", file=sys.stderr, flush=True)
    if rc:
        sys.exit(rc)
"""


def _argv(root, run, name, extra, world=1, rank=0, port=0):
    efile = P2P[0]
    if "--delta_efile" in extra:
        efile = dataset_path("p2p-31.e.mutable_base")
    prefix = os.path.join(root, run + (f"_r{rank}" if rank else ""))
    argv = ["--application", name, "--efile", efile, "--vfile", P2P[1],
            "--out_prefix", prefix, "--fnum", str(FNUM), "--device", "cpu",
            "--profile", *NAMES[name][0],
            *(x.format(ck=os.path.join(root, "ck")) for x in extra)]
    if world > 1:
        argv += ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                 str(world), "--process_id", str(rank)]
    return argv


def _start(root, runs, world, env):
    """`world` children running `runs`, a free port a run."""
    ports = [free_port() for _ in runs]
    return [subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(
            [(run, _argv(root, run, name, extra, world, r, port))
             for (run, name, extra), port in zip(runs, ports)])],
        cwd=REPO, env=child_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs):
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=CHILD_TIMEOUT_S)
            out.append((p.returncode, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _runs_of(stderr):
    """run -> its stderr segment, from the "[run] <name>" markers."""
    parts = re.split(r"^\[run\] (\S+)\n", stderr, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def loop_of(seg):
    """(rounds, host-loop decisions) a run logged: the last IncEval round
    of a superstep app, the "host loop:" fields of an exchange app."""
    host = re.findall(r"host loop: (.*)", seg)
    if host:
        stats = dict(kv.split("=") for kv in host[-1].split())
        return int(stats["rounds"]), stats
    rounds = re.findall(r"IncEval round (\d+):", seg)
    return (int(rounds[-1]) if rounds else 0), {}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """(root, gang -> the ranks' run segments, one process's segments):
    every gang of the file and the one-process children, started at
    once; then the killed gang's --resume."""
    root = str(tmp_path_factory.mktemp("dist_variants"))
    procs = {g: _start(root, runs, world, env)
             for g, (world, runs, env) in GANGS.items()}
    procs["one"] = _start(os.path.join(root, "one"), ONE, 1, PROBE_CAP)
    procs["one-capacity"] = _start(os.path.join(root, "one"), ONE_CAPACITY,
                                   1, {"GRAPE_FT_FAULTS": "capacity=8"})
    outs = {g: _wait(ps) for g, ps in procs.items()}
    for g, ranks in outs.items():
        want = 17 if g == "killed" else 0
        for rc, se in ranks:
            assert rc == want, (g, se[-3000:])
    resumed = _wait(_start(root, [("pagerank_auto-resumed", "pagerank_auto",
                                   ["--resume", "--checkpoint_dir",
                                    "{ck}"])], 2, {}))
    for rc, se in resumed:
        assert rc == 0, se[-3000:]
    outs["resumed"] = resumed
    segs = {g: [_runs_of(se) for _, se in ranks]
            for g, ranks in outs.items()}
    one = {**segs.pop("one")[0], **segs.pop("one-capacity")[0]}
    return root, segs, one


_JAX = {}


def jax_files(graph_cache, tmp_path, name):
    """(files, rounds) of the JAX single-process Worker at fnum 4, once a
    JAX class (aliases share it)."""
    jname = JAX_NAME.get(name, name)
    key = (JAPPS[jname], json.dumps(NAMES[name][1]))
    if key not in _JAX:
        w = JWorker(JAPPS[jname](), graph_cache(FNUM))
        w.query(**NAMES[name][1])
        out = str(tmp_path / f"jax_{jname}")
        w.output(out)
        _JAX[key] = (_read(out, FNUM), w.rounds)
    return _JAX[key]


def _same(name, got, want):
    if name in PAGERANKS:
        eps_verify(load_result_lines("".join(got)),
                   load_result_lines("".join(want)))
    else:
        assert got == want


CASES = [(g, run, name) for g, (_, runs, _) in GANGS.items()
         if g in ("auto", "exchange", "opt", "world4")
         for run, name, _ in runs]


@pytest.mark.parametrize("gang,run,name", CASES,
                         ids=[f"{g}-{r}" for g, r, _ in CASES])
def test_gang_files_equal_one_process_and_jax(gangs, tmp_path, graph_cache,
                                              gang, run, name):
    root, segs, one = gangs
    world = GANGS[gang][0]
    got = _read(os.path.join(root, run), FNUM)
    assert not any(os.path.exists(os.path.join(root, f"{run}_r{r}"))
                   for r in range(1, world))
    # the port's one-process CLI: byte for byte, the PageRanks too
    assert got == _read(os.path.join(root, "one", name), FNUM)
    want, jrounds = jax_files(graph_cache, tmp_path, name)
    _same(name, got, want)
    loops = [loop_of(s[run]) for s in segs[gang]]
    assert loops == [loop_of(one[name])] * world
    assert loops[0][0] == jrounds
    if name in ("sssp_delta", "sssp_select"):
        assert int(loops[0][1]["buckets"]) > 0


def test_sssp_select_picks_delta_on_every_rank(gangs):
    root, segs, one = gangs
    for seg in [s["sssp_select"] for s in segs["auto"]] + [one["sssp_select"]]:
        assert "sssp_select -> sssp_delta" in seg
    assert (_read(os.path.join(root, "sssp_select"), FNUM)
            == _read(os.path.join(root, "one", "sssp_delta"), FNUM))


@pytest.mark.parametrize("name", ["sssp_msg", "bfs_opt"])
def test_capacity_fault_retries_alike(gangs, name):
    root, segs, one = gangs
    run = f"{name}-capacity"
    loops = [loop_of(s[run]) for s in segs["capacity"]]
    assert loops == [loop_of(one[run])] * 2
    # the clamp ran the ladder: more retries than the unclamped query
    assert int(loops[0][1]["retries"]) > int(loop_of(one[name])[1]["retries"])
    assert (_read(os.path.join(root, run), FNUM)
            == _read(os.path.join(root, "one", name), FNUM))


@pytest.mark.parametrize("name", ["sssp_delta", "pagerank_auto"])
def test_guard_halt_probes_without_breach(gangs, name):
    root, segs, _ = gangs
    run = f"{name}-guard"
    for s in segs["guard"]:
        seg = s[run]
        if name == "sssp_delta":  # the host loop's own probe
            m = re.search(r"guard: host loop probed (\d+) round\(s\) "
                          r"\(policy=halt\), 0 breach", seg)
            assert m and int(m.group(1)) == loop_of(seg)[0]
        else:
            assert "guard: probes every 1 round(s) (policy=halt)" in seg
    assert (_read(os.path.join(root, run), FNUM)
            == _read(os.path.join(root, name), FNUM))


def test_killed_then_resumed_files_match(gangs):
    root, segs, _ = gangs
    for s in segs["resumed"]:
        assert "resumed from superstep 4" in s["pagerank_auto-resumed"]
    assert not os.path.exists(os.path.join(root, "pagerank_auto-killed"))
    assert (_read(os.path.join(root, "pagerank_auto-resumed"), FNUM)
            == _read(os.path.join(root, "pagerank_auto"), FNUM))


@pytest.mark.parametrize("name", ["sssp_auto", "sssp_delta"])
def test_delta_loads_pass_the_golden(gangs, name):
    root, segs, _ = gangs
    got = _read(os.path.join(root, f"{name}-delta"), FNUM)
    exact_verify(load_result_lines("".join(got)),
                 load_golden(dataset_path("p2p-31-SSSP")))
    assert got == _read(os.path.join(root, name), FNUM)


def test_the_variants_pass_the_gate():
    assert set(NAMES) <= set(DIST_APP_NAMES)
    assert HOST_LOOP_DECISIONS[0] == "rounds"


# ---- a rank's slab, with no group -------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, None])
def test_push_csr_and_dest_degree_on_a_slab(dtype):
    whole = auto_apps.push_csr(frag_of(), "oe", dtype)
    deg = dest_degree(frag_of())
    for r in (0, 1):
        rows = slice(2 * r, 2 * r + 2)
        slab = auto_apps.push_csr(frag_of(r), "oe", dtype)
        assert slab[0].shape[0] == 2
        for got, want in zip(slab, whole):
            if want is None:
                assert got is None
            else:
                assert torch.equal(got, want[rows])
        assert torch.equal(dest_degree(frag_of(r)), deg[rows])


def test_own_slice_min_on_a_slab():
    gen = torch.Generator().manual_seed(3)
    fnum, vp = 4, 16
    prop = torch.rand(fnum, fnum * vp, generator=gen)
    local = torch.rand(fnum, vp, generator=gen)
    want = auto_apps._own_slice_min(prop.clone(), local)
    for r in (0, 1):
        rows = slice(2 * r, 2 * r + 2)
        got = auto_apps._own_slice_min(prop[rows].clone(), local[rows], 2 * r)
        assert torch.equal(got, want[rows])


class ThreadSpec:
    """A rank's CommSpec for fake ranks in threads: all_to_all_single and
    all_gather_into through a barrier (the group's contracts)."""

    def __init__(self, rank, world, fnum, slots, barrier):
        self.rank, self.world = rank, world
        self.fl, self.fid_lo = fnum // world, rank * (fnum // world)
        self.group = "threads"
        self._slots, self._barrier = slots, barrier

    def _swap(self, x):
        self._slots[self.rank] = x.clone()
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got

    def all_to_all_single(self, inp):
        return torch.stack([blk[self.rank] for blk in self._swap(inp)])

    def all_gather_into(self, inp):
        return torch.cat(self._swap(inp))


def _thread_contexts(world, fnum):
    slots, barrier = [None] * world, threading.Barrier(world, timeout=60)
    return [StepContext(fnum, spec=ThreadSpec(r, world, fnum, slots,
                                              barrier))
            for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_sync_across_slab_ranks_is_one_process(world):
    """Float32 proposals of mixed magnitudes, so a sum in another order
    would differ in its last bits: min, max and sum bit-equal."""
    fnum, vp = 4, 96
    gen = torch.Generator().manual_seed(world)
    mag = 10.0 ** torch.randint(-4, 5, (fnum, fnum * vp), generator=gen)
    props = {k: torch.randn(fnum, fnum * vp, generator=gen) * mag
             for k in "abc"}
    ops = {"a": "min", "b": "max", "c": "sum"}
    dev = types.SimpleNamespace(fnum=fnum, vp=vp)
    want = AutoParallelMessageManager.sync(dev, props, ops)
    ctxs = _thread_contexts(world, fnum)
    fl = fnum // world

    def rank(r):
        rows = slice(r * fl, (r + 1) * fl)
        return AutoParallelMessageManager.sync(
            dev, {k: v[rows].contiguous() for k, v in props.items()}, ops,
            ctxs[r])

    for r, got in enumerate(run_ranks(rank, world)):
        for k in "abc":
            w = want[k][r * fl:(r + 1) * fl]
            assert torch.equal(got[k].view(torch.int32), w.view(torch.int32))


def test_round_scalars_across_slab_ranks():
    gen = torch.Generator().manual_seed(9)
    sent = torch.randint(0, 1000, (4,), generator=gen)
    count = torch.randint(0, 1000, (4,), generator=gen)
    low = torch.rand(4, generator=gen, dtype=torch.float64)
    parts = lambda lo, hi: [  # noqa: E731
        ("max", sent[lo:hi].max()), ("sum", count[lo:hi].sum()),
        ("min", low[lo:hi].min())]
    want = round_scalars(None, parts(0, 4))
    assert want == [int(sent.max()), int(count.sum()), float(low.min())]
    assert [type(x) for x in want] == [int, int, float]
    ctxs = _thread_contexts(2, 4)
    got = run_ranks(lambda r: round_scalars(ctxs[r], parts(2 * r, 2 * r + 2)),
                    2)
    assert got == [want, want]
