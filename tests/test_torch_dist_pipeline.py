"""The pipelined round across processes on the CPU (gloo), against the
serial gang and one process.

* CLI gangs (`--device cpu`, p2p-31 at fnum 4) under GRAPE_PIPELINE=force
  at two and four ranks, under GRAPE_EXCHANGE gather and mirror, run
  sssp, bfs, wcc and cdlp (its split-mode fold) with the plan engaged on
  every rank, and write the files of the serial four-rank gang and of one
  process byte for byte; PageRank's sum fold still declines, with the JAX
  reason.  The vertex cut's pipelined round (sssp_vc, bfs_vc at four
  ranks: the phase-0 row-axis all_reduce kicked while the phase-1 K1
  pulls) writes its serial round's files.  GRAPE_PIPELINE=auto takes one
  decision on every rank.
* The kickoff is asynchronous: in a two-rank gang whose children log the
  K1 calls, the exchange's issue and the collective's wait, every round's
  interior K1 runs between the kickoff and the wait (a blocking kickoff
  would serialize the round and fail no other test).

The gangs of the file start at once; each child runs several CLI calls
(one group a call), as in tests/test_torch_dist_count.py.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from tests.test_torch_dist import P2P, REPO, child_env, free_port
from tests.test_torch_dist_count import CHILD, _runs_of, _wait
from tests.test_torch_dist_vc import _files, _ok

torch.set_num_threads(1)

APPS = ("sssp", "bfs", "wcc", "cdlp")
VC = ("sssp_vc", "bfs_vc")
FORCE = {"GRAPE_PIPELINE": "force", "GRAPE_TPU_VLOG": "1"}
# gang -> (world, runs, env)
GANGS = {
    "gather2": (2, APPS + ("pagerank",),
                {**FORCE, "GRAPE_EXCHANGE": "gather"}),
    "mirror2": (2, APPS, {**FORCE, "GRAPE_EXCHANGE": "mirror"}),
    "gather4": (4, APPS + VC, {**FORCE, "GRAPE_EXCHANGE": "gather"}),
    "mirror4": (4, APPS, {**FORCE, "GRAPE_EXCHANGE": "mirror"}),
    "serial4": (4, APPS + VC, {}),
    "one": (1, APPS + VC, {}),
    "auto": (2, ("sssp",), {"GRAPE_PIPELINE": "auto", "GRAPE_TPU_VLOG": "1"}),
}
QUERY = ["--sssp_source", "6", "--bfs_source", "6", "--cdlp_mr", "10",
         "--pr_d", "0.85", "--pr_mr", "10"]

# the order child: the CLI with K1, the exchange's issue and the
# collective's wait logged; one "[order] [...]" line a run
ORDER = r"""
import json, sys
from libgrape_lite_tpu_torch import cli
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel import comm_spec, pipeline

log = []
k1 = spmv.gather_reduce
issue = pipeline.PipelinePlan._issue
wait = comm_spec.Pending.wait


def gather_reduce(*a, **kw):
    log.append("k1")
    return k1(*a, **kw)


def issued(self, *a, **kw):
    log.append("kick")
    return issue(self, *a, **kw)


def waited(self):
    log.append("wait")
    return wait(self)


spmv.gather_reduce = gather_reduce
pipeline.PipelinePlan._issue = issued
comm_spec.Pending.wait = waited
for name, argv in json.loads(sys.argv[1]):
    del log[:]
    rc = cli.main(argv)
    print(f"[order] {name} " + json.dumps(log), file=sys.stderr, flush=True)
    if rc:
        sys.exit(rc)
"""


def _argv(root, tag, app, world=1, rank=0, port=0):
    prefix = os.path.join(root, tag, app + (f"_r{rank}" if rank else ""))
    argv = ["--application", app, "--efile", P2P[0], "--vfile", P2P[1],
            "--out_prefix", prefix, "--fnum", "4", "--device", "cpu",
            *QUERY]
    if world > 1:
        argv += ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                 str(world), "--process_id", str(rank)]
    return argv


def _launch(root, tag, world, runs, env, script=CHILD):
    ports = [free_port() for _ in runs]
    return [subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(
            [(app, _argv(root, tag, app, world, r, port))
             for app, port in zip(runs, ports)])],
        cwd=REPO, env=child_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_pipe"))
    started = {tag: _launch(root, tag, w, runs, env)
               for tag, (w, runs, env) in GANGS.items()}
    started["order"] = _launch(root, "order", 2, ("sssp", "wcc"),
                               {"GRAPE_PIPELINE": "force",
                                "GRAPE_EXCHANGE": "mirror"}, ORDER)
    out = {tag: _wait(procs) for tag, procs in started.items()}
    out["root"] = root
    return out


CASES = [(tag, app) for tag in ("gather2", "mirror2", "gather4", "mirror4")
         for app in GANGS[tag][1] if app != "pagerank"]


@pytest.mark.parametrize("tag,app", CASES, ids=[f"{t}-{a}" for t, a in CASES])
def test_pipelined_gang_equals_serial_gang_and_one_process(gangs, tag, app):
    for t in (tag, "serial4", "one"):
        _ok(gangs[t])
    root = gangs["root"]
    got = _files(os.path.join(root, tag, app))
    assert got == _files(os.path.join(root, "serial4", app))
    assert got == _files(os.path.join(root, "one", app))
    engaged = ("pipeline: engaged vc2d for" if app.endswith("_vc")
               else "pipeline: engaged for")
    # CDLP's label table is always the gathered state
    mode = "gather" if app == "cdlp" else GANGS[tag][2]["GRAPE_EXCHANGE"]
    for _, se in gangs[tag]:
        seg = _runs_of(se)[app]
        assert engaged in seg, seg[-2000:]
        if not app.endswith("_vc"):
            assert f"({mode} exchange" in seg


def test_sum_fold_still_declines(gangs):
    _ok(gangs["gather2"])
    for _, se in gangs["gather2"]:
        seg = _runs_of(se)["pagerank"]
        assert "pipeline: declined for PageRank: sum fold" in seg
        assert "pipeline: engaged" not in seg


def test_auto_decides_alike_on_every_rank(gangs):
    _ok(gangs["auto"])
    said = [re.findall(r"pipeline: (?:engaged|declined)[^\n]*", se)
            for _, se in gangs["auto"]]
    assert said[0] and said[0] == said[1], said
    root = gangs["root"]
    assert _files(os.path.join(root, "auto", "sssp")) == _files(
        os.path.join(root, "one", "sssp"))


@pytest.mark.parametrize("app", ["sssp", "wcc"])
def test_interior_k1_runs_between_the_kickoff_and_the_wait(gangs, app):
    _ok(gangs["order"])
    for _, se in gangs["order"]:
        log = json.loads(re.search(rf"^\[order\] {app} (.*)$", se,
                                   flags=re.M).group(1))
        kicks = [i for i, e in enumerate(log) if e == "kick"]
        waits = [i for i, e in enumerate(log) if e == "wait"]
        assert kicks and len(kicks) == len(waits), log
        for k, w in zip(kicks, waits):
            assert k < w and "k1" in log[k:w], log[k:w + 1]
    root = gangs["root"]
    assert _files(os.path.join(root, "order", app)) == _files(
        os.path.join(root, "one", app))
