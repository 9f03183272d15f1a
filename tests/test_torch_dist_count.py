"""The counting apps across processes on the CPU (gloo), against one
process and the JAX package.

* CLI gangs (`--device cpu`, p2p-31 at fnum 4, two ranks; four for
  triangle_count) of triangle_count (LCC's N+ ring through the row
  AND-popcount), lcc_directed `--directed` (the OUT ring), kclique at k 3
  (ApexTriangleCount: LCCBeta's ring in apex mode), 4 and 5 (the device
  clique apps over the gathered ELL) and 7 (p2p-31's oriented D, 14, is
  past general_cap(7) = 13: the host recursion over each rank's apexes),
  lcc_bitmap and triangle_count under GRAPE_LCC_BACKEND=spgemm (a rank's
  items of the plan, the credits folded), lcc_opt under `auto` with the
  ranks and a one-process child sharing one GRAPE_PACK_PLAN_CACHE, and
  `--guard halt` on triangle_count write the files of the port's
  one-process CLI byte for byte (the intersect backend's: the backends
  agree bit for bit) and of the JAX package's single-process `Worker` at
  fnum 4; `global_triangles`, `total_cliques`, `used_device_kernel` and
  the LCC backend are the same on every rank and in one process, and
  the lcc values pass the LCC golden.
* Unit cases with no group: two slab ranks in threads (`ThreadSpec`: the
  all_gather, all_reduce and ring shift through a thread barrier) --
  LCCDirected's OUT ring gives one process's counts and degrees,
  KCliqueDevice's gathered ELL is the stack's, a rank's spgemm streams
  folded give the whole plan's credits, and a Worker over the slab ranks
  returns one process's result for every counting app and backend; the
  `auto` decision raises on ranks that price apart; concurrent plan-cache
  writes each use a temporary name of their own.

A gang's children each run several CLI calls (one group a call), and the
gangs of the file start at once, as in tests/test_torch_dist_variants.py.
"""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.models.kclique_device import KCliqueDevice
from libgrape_lite_tpu_torch.models.lcc import slab_credits
from libgrape_lite_tpu_torch.models.lcc_directed import LCCDirected
from libgrape_lite_tpu_torch.ops import spgemm_pack
from libgrape_lite_tpu_torch.parallel import comm_spec as cs
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import DIST_APP_NAMES
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_dist import CHILD_TIMEOUT_S, P2P, REPO, child_env
from tests.test_torch_dist import free_port
from tests.test_torch_dist_apps import _read
from tests.test_torch_gang import run_ranks
from tests.verifiers import eps_verify, load_golden, load_result_lines

torch.set_num_threads(1)

FNUM = 4
HOST_K = 7  # p2p-31's oriented D (14) is past general_cap(7) (13)
# run -> (registry name, CLI flags, JAX query kwargs, directed)
RUNS = {
    "triangle_count": ("triangle_count", [], {}, False),
    "lcc_directed": ("lcc_directed", ["--directed"], {}, True),
    **{f"kclique{k}": ("kclique", ["--kclique_k", str(k)], {"k": k}, False)
       for k in (3, 4, 5, HOST_K)},
    "lcc_bitmap": ("lcc_bitmap", [], {}, False),
    "lcc_opt": ("lcc_opt", [], {}, False),
}
LCCS = {"lcc_bitmap", "lcc_opt"}  # the runs with an LCC golden
PLANS = "{root}/plans"  # the shared plan cache of the `auto` runs
AUTO = {"GRAPE_LCC_BACKEND": "auto", "GRAPE_PACK_PLAN_CACHE": PLANS}

# gang -> (world, [(run name, RUNS key, extra flags)], env)
GANGS = {
    "count": (2, [(r, r, []) for r in ("triangle_count", "lcc_directed")],
              {}),
    "clique": (2, [(f"kclique{k}", f"kclique{k}", []) for k in
                   (3, 4, 5, HOST_K)], {}),
    "world4": (4, [("triangle_count-world4", "triangle_count", [])], {}),
    "spgemm": (2, [(f"{r}-spgemm", r, []) for r in
                   ("lcc_bitmap", "triangle_count")],
               {"GRAPE_LCC_BACKEND": "spgemm"}),
    "auto": (2, [("lcc_opt-auto", "lcc_opt", [])], AUTO),
    "guard": (2, [("triangle_count-guard", "triangle_count",
                   ["--guard", "halt"])], {}),
}
# one process: every run under the intersect backend; lcc_opt under
# `auto` beside the gang, on the same plan cache
ONE = [(r, r, []) for r in RUNS]
ONE_AUTO = [("lcc_opt-auto", "lcc_opt", [])]

# A child: each argv of the JSON list through the CLI in turn, stderr
# marked "[run] <name>" before and "[rc] <code>" after each, and the
# app's counts and backend as one "[app] {...}" line after its run
CHILD = r"""
import json, sys
from libgrape_lite_tpu_torch import cli

run_app = cli.run_app


def counted(args):
    w = run_app(args)
    keys = ("global_triangles", "total_cliques", "used_device_kernel",
            "lcc_backend")
    print("[app] " + json.dumps({k: getattr(w.app, k) for k in keys
                                 if hasattr(w.app, k)}),
          file=sys.stderr, flush=True)
    return w


cli.run_app = counted
for name, argv in json.loads(sys.argv[1]):
    print("[run] " + name, file=sys.stderr, flush=True)
    rc = cli.main(argv)
    print(f"[rc] {rc}", file=sys.stderr, flush=True)
    if rc:
        sys.exit(rc)
"""


def _argv(root, run, key, extra, world=1, rank=0, port=0):
    name, flags, _, _ = RUNS[key]
    prefix = os.path.join(root, run + (f"_r{rank}" if rank else ""))
    argv = ["--application", name, "--efile", P2P[0], "--vfile", P2P[1],
            "--out_prefix", prefix, "--fnum", str(FNUM), "--device", "cpu",
            "--profile", *flags, *extra]
    if world > 1:
        argv += ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                 str(world), "--process_id", str(rank)]
    return argv


def _start(root, runs, world, env):
    """`world` children running `runs`, a free port a run."""
    ports = [free_port() for _ in runs]
    env = {k: v.format(root=root) for k, v in env.items()}
    return [subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(
            [(run, _argv(root, run, key, extra, world, r, port))
             for (run, key, extra), port in zip(runs, ports)])],
        cwd=REPO, env=child_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs):
    out = []
    try:
        for p in procs:
            _, se = p.communicate(timeout=CHILD_TIMEOUT_S)
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


def app_of(seg) -> dict:
    """The "[app] {...}" record a run printed."""
    return json.loads(re.findall(r"^\[app\] (.*)$", seg, flags=re.M)[-1])


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """(root, gang -> the ranks' run segments, one process's segments):
    every gang of the file and the one-process children, started at
    once."""
    root = str(tmp_path_factory.mktemp("dist_count"))
    procs = {g: _start(root, runs, world, env)
             for g, (world, runs, env) in GANGS.items()}
    procs["one"] = _start(os.path.join(root, "one"), ONE, 1, {})
    procs["one-auto"] = _start(os.path.join(root, "one"), ONE_AUTO, 1,
                               {k: v.format(root=root)
                                for k, v in AUTO.items()})
    outs = {g: _wait(ps) for g, ps in procs.items()}
    for g, ranks in outs.items():
        for rc, se in ranks:
            assert rc == 0, (g, se[-3000:])
    segs = {g: [_runs_of(se) for _, se in ranks]
            for g, ranks in outs.items()}
    one = {**segs.pop("one")[0], **segs.pop("one-auto")[0]}
    return root, segs, one


_JAX = {}


def jax_run(graph_cache, tmp_path, key):
    """(files, app) of the JAX single-process Worker at fnum 4, once a
    run key."""
    if key not in _JAX:
        name, _, kw, directed = RUNS[key]
        w = JWorker(JAPPS[name](), graph_cache(FNUM, directed))
        w.query(**kw)
        out = str(tmp_path / f"jax_{key}")
        w.output(out)
        _JAX[key] = (_read(out, FNUM), w.app)
    return _JAX[key]


CASES = [(g, run, key) for g, (_, runs, _) in GANGS.items()
         if g != "guard" for run, key, _ in runs]


@pytest.mark.parametrize("gang,run,key", CASES,
                         ids=[f"{g}-{r}" for g, r, _ in CASES])
def test_gang_files_equal_one_process_and_jax(gangs, tmp_path, graph_cache,
                                              gang, run, key):
    root, segs, one = gangs
    world = GANGS[gang][0]
    got = _read(os.path.join(root, run), FNUM)
    assert not any(os.path.exists(os.path.join(root, f"{run}_r{r}"))
                   for r in range(1, world))
    # the port's one-process CLI (the intersect backend): byte for byte
    assert got == _read(os.path.join(root, "one", key), FNUM)
    # the JAX Worker: counts exact, lcc values bit for bit
    want, japp = jax_run(graph_cache, tmp_path, key)
    assert got == want
    if key in LCCS:
        eps_verify(load_result_lines("".join(got)),
                   load_golden(dataset_path("p2p-31-LCC")))
    # every rank counts alike, and as one process and the JAX app do
    recs = [app_of(s[run]) for s in segs[gang]]
    assert recs == [recs[0]] * world
    solo = app_of(one[key])
    for k in ("global_triangles", "total_cliques", "used_device_kernel"):
        if k in solo:
            assert recs[0][k] == solo[k] == getattr(japp, k), k
    if gang == "spgemm":
        assert recs[0]["lcc_backend"] == "spgemm"


def test_kclique_paths_across_ranks(gangs):
    """k 3, 4, 5 ran on the device apps, k 7 the host recursion, with
    the one-process counts (p2p-31: 2,024 triangles, 16 4-cliques)."""
    _, segs, one = gangs
    want = {3: (2024, True), 4: (16, True), 5: (0, True),
            HOST_K: (0, False)}
    for k, (total, device) in want.items():
        for s in segs["clique"] + [one]:
            rec = app_of(s[f"kclique{k}"])
            assert (rec["total_cliques"], rec["used_device_kernel"]) == (
                total, device), (k, rec)


def test_auto_takes_one_decision_with_a_shared_plan_cache(gangs):
    """Two ranks and a one-process child priced `auto` alike and shared
    one plan cache directory: one plan file, no temporary left."""
    root, segs, one = gangs
    picks = [app_of(s["lcc_opt-auto"])["lcc_backend"]
             for s in segs["auto"]]
    assert picks == [app_of(one["lcc_opt-auto"])["lcc_backend"]] * 2
    files = sorted(os.listdir(PLANS.format(root=root)))
    if picks[0] == "spgemm":
        assert len(files) == 1 and files[0].startswith("spgemmplan_")
        assert files[0].endswith(".npz")
    else:
        assert files == []


def test_guard_halt_probes_without_breach(gangs):
    root, segs, _ = gangs
    for s in segs["guard"]:
        assert ("guard: probes every 1 round(s) (policy=halt)"
                in s["triangle_count-guard"])
    assert (_read(os.path.join(root, "triangle_count-guard"), FNUM)
            == _read(os.path.join(root, "triangle_count"), FNUM))


def test_the_counting_apps_pass_the_gate():
    assert {"triangle_count", "lcc_directed", "kclique", "lcc_bitmap",
            "lcc_opt"} <= set(DIST_APP_NAMES)


# ---- slab ranks in threads, with no group -----------------------------------


class ThreadSpec:
    """Rank r's CommSpec for fake ranks in threads: all_gather_into,
    all_reduce and ring_shift through a barrier (the group's contracts),
    the spec's `stats` counted as CommSpec counts them."""

    def __init__(self, rank, world, fnum, slots, barrier):
        self.rank, self.world, self.fnum = rank, world, fnum
        self.fl, self.fid_lo = fnum // world, rank * (fnum // world)
        self.device = torch.device("cpu")
        self.group, self.backend, self.staged = "threads", "threads", False
        self.stats = dict.fromkeys(
            ("calls", "bytes", "staged", "all_gather", "all_gather_bytes",
             "all_reduce", "all_to_all", "ring", "ring_bytes"), 0)
        self._slots, self._barrier = slots, barrier

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def _swap(self, x):
        self._slots[self.rank] = x.clone()
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got

    def all_gather_into(self, inp):
        self.stats["all_gather"] += 1
        return torch.cat(self._swap(inp))

    def all_reduce(self, t, op):
        self.stats["all_reduce"] += 1
        got = torch.stack(self._swap(t))
        return {"sum": got.sum(0), "min": got.amin(0),
                "max": got.amax(0)}[op].to(t.dtype)

    def all_to_all_single(self, inp):
        self.stats["all_to_all"] += 1
        return torch.stack([blk[self.rank] for blk in self._swap(inp)])

    def ring_shift(self, t):
        self.stats["ring"] += 1
        return self._swap(t)[(self.rank + 1) % self.world]

    def barrier(self):
        self._barrier.wait()


_FRAGS = {}


def slab_frags(world: int, directed: bool = False) -> list:
    """p2p-31 at fnum 4: one process (world 1), or each rank's view of a
    `world`-rank group, its slab placed and its spec a `ThreadSpec`
    (fresh ones each call: the barrier is the call's)."""
    key = (world, directed)
    if key not in _FRAGS:
        _FRAGS[key] = [LoadGraph(*P2P, CommSpec(FNUM, "cpu", rank=r,
                                                world=world),
                                 LoadGraphSpec(directed=directed))
                       for r in range(world)]
    frags = _FRAGS[key]
    if world > 1:
        slots = [None] * world
        barrier = threading.Barrier(world, timeout=60)
        for r, f in enumerate(frags):
            f.comm_spec = ThreadSpec(r, world, FNUM, slots, barrier)
    return frags


def ctx_of(frag) -> StepContext:
    return StepContext(frag.fnum, spec=frag.comm_spec)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("thr", [0, 5])
def test_lcc_directed_out_ring_is_one_process(world, thr):
    app = LCCDirected()
    app.degree_threshold = thr
    whole = slab_frags(1, True)[0]
    tri, deg = app.tricnt(whole.dev)
    assert int(tri.sum()) > 0
    frags = slab_frags(world, True)
    got = run_ranks(lambda r: app.tricnt(frags[r].dev, ctx_of(frags[r])),
                    world)
    fl = FNUM // world
    for r, (t, d) in enumerate(got):
        assert torch.equal(t, tri[r * fl:(r + 1) * fl])
        assert torch.equal(d, deg[r * fl:(r + 1) * fl])
        # world - 1 shifts of the OUT block, no fold of the credits
        stats = frags[r].comm_spec.stats
        assert stats["ring"] == world - 1
        assert stats["all_gather"] == (1 if thr else 0)


def test_kclique_device_gathered_ell_is_the_stacks():
    app = KCliqueDevice(5)
    v, u, ell, cnt = app.stacked_ell(slab_frags(1)[0].dev)
    frags = slab_frags(2)
    got = run_ranks(lambda r: app.stacked_ell(frags[r].dev,
                                              ctx_of(frags[r])), 2)
    rows = (FNUM // 2) * frags[0].vp
    for r, (vr, ur, er, cr) in enumerate(got):
        assert torch.equal(er, ell) and torch.equal(cr, cnt)
        own = (v >= r * rows) & (v < (r + 1) * rows)
        assert torch.equal(vr, v[own]) and torch.equal(ur, u[own])


@pytest.mark.parametrize("thr", [0, 20])
def test_spgemm_rank_streams_fold_to_the_whole_plan(thr):
    whole = slab_frags(1)[0]
    sg = spgemm_pack.resolve_spgemm_dispatch(whole, degree_threshold=thr)

    def credits(fid_lo, fl):
        state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 sg.state_entries(fid_lo, fl).items()}
        return sg.credits(state)

    want = credits(0, FNUM)
    assert int(want.sum()) > 0
    parts = [credits(2 * r, 2) for r in range(2)]
    assert torch.equal(parts[0] + parts[1], want)
    frags = slab_frags(2)
    got = run_ranks(lambda r: slab_credits(ctx_of(frags[r]), frags[r].dev,
                                           parts[r]), 2)
    full = want.to(torch.int32).view(FNUM, -1)
    for r, t in enumerate(got):
        assert torch.equal(t, full[2 * r:2 * r + 2])


def _host_kclique():
    app = APP_REGISTRY["kclique"]()
    app.hub_cap = 0  # k 4 takes the host recursion
    return app


# case -> (app factory, query kwargs, directed, GRAPE_LCC_BACKEND)
WORKER_CASES = {
    "triangle_count": (APP_REGISTRY["triangle_count"], {}, False,
                       "intersect"),
    "triangle_count-spgemm": (APP_REGISTRY["triangle_count"], {}, False,
                              "spgemm"),
    "lcc_bitmap-auto": (APP_REGISTRY["lcc_bitmap"], {}, False, "auto"),
    "lcc_directed": (APP_REGISTRY["lcc_directed"], {"degree_threshold": 5},
                     True, "intersect"),
    "apex_triangle_count": (APP_REGISTRY["kclique"], {"k": 3}, False,
                            "intersect"),
    "kclique4": (APP_REGISTRY["kclique"], {"k": 4}, False, "intersect"),
    "kclique5": (APP_REGISTRY["kclique"], {"k": 5}, False, "intersect"),
    "kclique4-host": (_host_kclique, {"k": 4}, False, "intersect"),
}


def run_slab_workers(make, kw, directed, world):
    """One process's (result, app) and each slab rank's, in threads."""
    one = Worker(make(), slab_frags(1, directed)[0])
    one.query(**kw)
    frags = slab_frags(world, directed)

    def rank(r):
        w = Worker(make(), frags[r])
        w.query(**kw)
        return w.result_values(), w.app

    return (one.result_values(), one.app), run_ranks(rank, world)


@pytest.mark.parametrize("case", list(WORKER_CASES))
def test_worker_over_slab_ranks_is_one_process(case, monkeypatch):
    make, kw, directed, backend = WORKER_CASES[case]
    monkeypatch.setenv("GRAPE_LCC_BACKEND", backend)
    (want, wapp), got = run_slab_workers(make, kw, directed, 2)
    for vals, app in got:
        assert vals.dtype == want.dtype and np.array_equal(vals, want)
        for k in ("global_triangles", "total_cliques", "used_device_kernel",
                  "lcc_backend"):
            if hasattr(wapp, k):
                assert getattr(app, k) == getattr(wapp, k), k
    if case == "kclique4-host":
        assert got[0][1].total_cliques == 16
        assert not got[0][1].used_device_kernel


def test_auto_raises_on_ranks_that_price_apart(monkeypatch):
    frag = slab_frags(2)[0]
    monkeypatch.setattr(cs, "host_allgather",
                        lambda v: np.array([[1], [0]], np.int64))
    prices = {"spgemm_wins": True, "profile": "h100"}
    with pytest.raises(ValueError, match="rank 0: spgemm, rank 1: "
                       "intersect"):
        spgemm_pack.one_decision_across_ranks(frag, "LCC", prices)
    monkeypatch.setattr(cs, "host_allgather",
                        lambda v: np.array([[1], [1]], np.int64))
    spgemm_pack.one_decision_across_ranks(frag, "LCC", prices)


def test_plan_cache_writers_use_their_own_temporary(tmp_path, monkeypatch):
    """Writers of one plan into one directory at once each rename their
    own temporary file: every one lands, one plan file stays."""
    monkeypatch.setenv("GRAPE_PACK_PLAN_CACHE", str(tmp_path))
    frag = slab_frags(1)[0]
    cfg = spgemm_pack.SpGemmConfig()
    v, u, _, _ = spgemm_pack._oriented_mask_edges(frag, 0)
    plan = spgemm_pack.plan_spgemm(frag, 0, cfg)
    barrier = threading.Barrier(4, timeout=60)

    def write(_):
        barrier.wait()
        spgemm_pack._save_cached_plan(plan, v, u, frag, 0, cfg)

    run_ranks(write, 4)
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(
        spgemm_pack._plan_cache_path(v, u, frag, 0, cfg))]
    back = spgemm_pack._load_cached_plan(v, u, frag, 0, cfg)
    assert back is not None and back.items == plan.items
