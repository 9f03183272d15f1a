"""The vertex cut across processes on the CPU (gloo), against one process
and the JAX package.

* CLI gangs (`--device cpu`, p2p-31): sssp_vc, bfs_vc, wcc_vc (raw
  directed storage: the src pull over the column-axis group),
  `--vc pagerank` and pagerank_vc_rep at k 2 on two ranks (whole tile
  rows) and four (one tile a rank), and at k 3 on three ranks, write the
  files of the port's one-process CLI -- byte for byte for the min
  folds, within 1e-4 for PageRank, which passes the golden -- and, at
  fnum 4, the JAX package's single-process `run_app` on the 8-device CPU
  mesh.  GRAPE_PARTITION=2d engages the 2-D twins on every rank (the
  goldens hold; the min folds equal the 1-D one-process files), `auto`
  takes one decision on every rank.  `--guard halt` runs under the
  breach vote; `--checkpoint_every 2` with kill_rank@4:1 and `--resume`
  at world 4 give the uninterrupted gang's files; a resume onto another
  process count declines, recorded in the partition ledger; a world that
  breaks the layout rule declines before the load.
* Unit cases with no group: the ranks of a k x k grid in threads
  (`ThreadVCSpec`: the group reductions and gathers through a thread
  board, the transpose's peer messages through a mailbox, the peer plan
  and every count the CommSpec's own) -- each reduction, the transpose,
  the re-alignments and the row count of `VCStepContext` give the
  one-card context's values (min bit-equal, sums within 1e-6), no round
  all-gathers the tile stack, and a rank places one tile's bytes at
  world 4, k 2.

The gangs of the file start at once; each child runs several CLI calls
(one group a call), as in tests/test_torch_dist_count.py.
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

from libgrape_lite_tpu_torch.app.base import VCStepContext
from libgrape_lite_tpu_torch.fleet.budget import fragment_bytes
from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS
from libgrape_lite_tpu_torch.fragment.vertexcut import (
    ImmutableVertexcutFragment,
)
from libgrape_lite_tpu_torch.ft.checkpoint import CheckpointMismatchError
from libgrape_lite_tpu_torch.parallel import comm_spec as cs
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec, VCGrid
from libgrape_lite_tpu_torch.runner import DIST_APP_NAMES, QueryArgs, run_app
from libgrape_lite_tpu_torch.ft import checkpoint as ck
from tests.conftest import dataset_path
from tests.test_torch_dist import P2P, REPO, child_env, free_port
from tests.test_torch_dist_count import CHILD, _runs_of, _wait
from tests.test_torch_gang import run_ranks
from tests.test_torch_vertexcut import edges
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

VC_APPS = ("sssp_vc", "bfs_vc", "wcc_vc", "pagerank_vc", "pagerank_vc_rep")
# run -> (application, flags)
RUNS = {
    **{a: (a, []) for a in ("sssp_vc", "bfs_vc", "wcc_vc",
                            "pagerank_vc_rep")},
    "pagerank_vc": ("pagerank", ["--vc"]),
    **{f"{a}-2d": (a, []) for a in ("sssp", "bfs", "wcc", "pagerank")},
    "sssp-auto": ("sssp", []),
    "sssp_vc-guard": ("sssp_vc", ["--guard", "halt"]),
    "bfs_vc-ck": ("bfs_vc", ["--checkpoint_every", "2", "--checkpoint_dir",
                             "{root}/ck_full"]),
    "bfs_vc-kill": ("bfs_vc", ["--checkpoint_every", "2",
                               "--checkpoint_dir", "{root}/ck_kill"]),
    "bfs_vc-resume": ("bfs_vc", ["--resume", "--checkpoint_dir",
                                 "{root}/ck_kill"]),
}
QUERY = ["--sssp_source", "6", "--bfs_source", "6", "--pr_d", "0.85",
         "--pr_mr", "10"]
# gang -> (world, fnum, runs, env)
GANGS = {
    "w2": (2, 4, VC_APPS, {}),
    "w4": (4, 4, VC_APPS + ("sssp_vc-guard", "bfs_vc-ck"), {}),
    "k3": (3, 9, ("sssp_vc", "bfs_vc", "wcc_vc", "pagerank_vc"), {}),
    "part2d": (2, 4, ("sssp-2d", "bfs-2d", "wcc-2d", "pagerank-2d"),
               {"GRAPE_PARTITION": "2d", "GRAPE_TPU_VLOG": "1"}),
    "auto": (2, 4, ("sssp-auto",), {"GRAPE_PARTITION": "auto",
                                    "GRAPE_TPU_VLOG": "1"}),
    "kill": (4, 4, ("bfs_vc-kill",), {"GRAPE_FT_FAULTS": "kill_rank@4:1"}),
}
# one process: every vc run at fnum 4 and 9, the 1-D twins at fnum 4
ONE = {4: VC_APPS + ("sssp-2d", "bfs-2d", "wcc-2d", "pagerank-2d"),
       9: ("sssp_vc", "bfs_vc", "wcc_vc", "pagerank_vc")}
GOLDEN = {"sssp": ("p2p-31-SSSP", exact_verify),
          "bfs": ("p2p-31-BFS", exact_verify),
          "wcc": ("p2p-31-WCC", wcc_verify),
          "pagerank": ("p2p-31-PR", eps_verify)}


def _argv(root, tag, run, fnum, world=1, rank=0, port=0):
    app, flags = RUNS[run]
    prefix = os.path.join(root, tag, run + (f"_r{rank}" if rank else ""))
    argv = ["--application", app, "--efile", P2P[0], "--vfile", P2P[1],
            "--out_prefix", prefix, "--fnum", str(fnum), "--device", "cpu",
            *QUERY, *[f.format(root=root) for f in flags]]
    if world > 1:
        argv += ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                 str(world), "--process_id", str(rank)]
    return argv


def _launch(root, tag, world, fnum, runs, env):
    ports = [free_port() for _ in runs]
    return [subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(
            [(run, _argv(root, tag, run, fnum, world, r, port))
             for run, port in zip(runs, ports)])],
        cwd=REPO, env=child_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Every gang and the one-process children started at once; the
    resume gang after the killed one.  {tag: [(rc, stderr)] a rank}."""
    root = str(tmp_path_factory.mktemp("dist_vc"))
    started = {tag: _launch(root, tag, w, f, runs, env)
               for tag, (w, f, runs, env) in GANGS.items()}
    started.update({f"one{f}": _launch(root, f"one{f}", 1, f, runs, {})
                    for f, runs in ONE.items()})
    out = {"root": root}
    out["kill"] = _wait(started.pop("kill"))
    resume = _launch(root, "kill", 4, 4, ("bfs_vc-resume",),
                     {"GRAPE_TPU_VLOG": "1"})
    for tag, procs in started.items():
        out[tag] = _wait(procs)
    out["resume"] = _wait(resume)
    return out


def _values(prefix: str) -> dict:
    text = "".join(open(os.path.join(prefix, f)).read()
                   for f in sorted(os.listdir(prefix)))
    return load_result_lines(text)


def _files(prefix: str) -> list:
    return [open(os.path.join(prefix, f)).read()
            for f in sorted(os.listdir(prefix))]


def _ok(outs):
    for rank, (rc, se) in enumerate(outs):
        assert rc == 0, f"rank {rank}: {se[-3000:]}"


def _same(run: str, got: str, want: str, files: bool = True):
    """PageRank within 1e-4 by oid; a min fold byte for byte, file for
    file (`files`: the same cut) or by oid (a 2-D run against 1-D)."""
    if run.startswith("pagerank"):
        eps_verify(_values(got), _values(want))
    elif files:
        assert _files(got) == _files(want)
    else:
        assert _values(got) == _values(want)


CASES = [(tag, run) for tag in ("w2", "w4", "k3")
         for run in GANGS[tag][2] if run in VC_APPS]


@pytest.mark.parametrize("tag,run", CASES, ids=[f"{t}-{r}" for t, r in CASES])
def test_vc_gang_equals_one_process(gangs, tag, run):
    _ok(gangs[tag])
    world, fnum = GANGS[tag][:2]
    root = gangs["root"]
    _ok(gangs[f"one{fnum}"])
    got = os.path.join(root, tag, run)
    _same(run, got, os.path.join(root, f"one{fnum}", run))
    # only the coordinator writes
    for r in range(1, world):
        assert not os.path.exists(f"{got}_r{r}")
    if run.startswith("pagerank"):
        eps_verify(_values(got), load_golden(dataset_path("p2p-31-PR")))


@pytest.mark.parametrize("run", VC_APPS)
def test_vc_gang_equals_jax_worker(gangs, tmp_path, run):
    """The four-rank gang against the JAX package's one-process run_app
    at fnum 4 on the 8-device CPU mesh: the same values by oid (the min
    folds exactly, PageRank within 1e-4)."""
    from libgrape_lite_tpu.runner import QueryArgs as JQueryArgs
    from libgrape_lite_tpu.runner import run_app as jrun_app

    _ok(gangs["w4"])
    app, flags = RUNS[run]
    out = str(tmp_path / "jax")
    jrun_app(JQueryArgs(application=app, efile=P2P[0], vfile=P2P[1],
                        fnum=4, out_prefix=out, vc="--vc" in flags,
                        sssp_source=6, bfs_source=6, pr_d=0.85, pr_mr=10))
    got = _values(os.path.join(gangs["root"], "w4", run))
    want = _values(out)
    if run.startswith("pagerank"):
        eps_verify(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("app", ["sssp", "bfs", "wcc", "pagerank"])
def test_partition_2d_engages_on_every_rank(gangs, app):
    _ok(gangs["part2d"])
    root = gangs["root"]
    run = f"{app}-2d"
    got = os.path.join(root, "part2d", run)
    _same(run, got, os.path.join(root, "one4", run), files=False)
    golden, verify = GOLDEN[app]
    verify(_values(got), load_golden(dataset_path(golden)))
    for _, se in gangs["part2d"]:
        assert f"partition: 2d engaged for {app} " in _runs_of(se)[run]


def test_partition_auto_takes_one_decision(gangs):
    _ok(gangs["auto"])
    said = [re.findall(r"partition: 2d (engaged|declined) for sssp", se)
            for _, se in gangs["auto"]]
    assert said[0] and said[0] == said[1], said
    root = gangs["root"]
    _same("sssp", os.path.join(root, "auto", "sssp-auto"),
          os.path.join(root, "one4", "sssp-2d"), files=False)


def test_guard_halt_and_checkpoint_on_a_vc_gang(gangs):
    _ok(gangs["w4"])
    root = gangs["root"]
    for run, base in (("sssp_vc-guard", "sssp_vc"), ("bfs_vc-ck", "bfs_vc")):
        assert _files(os.path.join(root, "w4", run)) == _files(
            os.path.join(root, "one4", base))
    rounds, path = ck.list_checkpoints(os.path.join(root, "ck_full"))[-1]
    meta = ck.read_meta(path)
    assert (meta["layout"], meta["ranks"]) == ("sharded", 4)
    # the carry is gathered whole: every rank's copy is the same
    assert all(lm.get("replicated") for sh in meta["shards"].values()
               for lm in sh["leaves"].values())


def test_kill_then_resume_is_the_uninterrupted_gang(gangs):
    rcs = [rc for rc, _ in gangs["kill"]]
    assert rcs[1] == 17 and all(rc != 0 for rc in rcs), rcs
    _ok(gangs["resume"])
    for _, se in gangs["resume"]:
        assert "resumed from superstep 4" in se
    root = gangs["root"]
    assert _files(os.path.join(root, "kill", "bfs_vc-resume")) == _files(
        os.path.join(root, "one4", "bfs_vc"))


def test_vc_lineage_reshard_declines_and_is_recorded(gangs):
    """The four-rank lineage resumed by one process (processes 4 -> 1)
    declines, its reason in the partition ledger."""
    _ok(gangs["resume"])
    before = PARTITION_STATS["declined"]
    with pytest.raises(CheckpointMismatchError, match="does not reshard"):
        run_app(QueryArgs(application="bfs_vc", efile=P2P[0], vfile=P2P[1],
                          fnum=4, device="cpu", resume=True,
                          checkpoint_dir=os.path.join(gangs["root"],
                                                      "ck_kill")))
    assert PARTITION_STATS["declined"] == before + 1
    rec = PARTITION_STATS["last_decision"]
    assert "vertex-cut lineage" in rec["reason"]
    assert "processes 4 -> 1" in rec["reason"]


@pytest.mark.parametrize("flags", [dict(vc=True, application="pagerank"),
                                   dict(application="sssp_vc")])
def test_layout_rule_declines_before_the_load(tmp_path, flags):
    """fnum 36 on four ranks gives each nine tiles of a 6 x 6 grid:
    neither whole tile rows nor part of one -- refused before any
    rendezvous or read (the edge file does not exist)."""
    with pytest.raises(ValueError, match="whole tile rows") as e:
        run_app(QueryArgs(efile=str(tmp_path / "absent.e"), device="cpu",
                          coordinator="127.0.0.1:1", num_processes=4,
                          process_id=0, fnum=36, **flags))
    assert "8c" not in str(e.value)
    assert cs.vc_layout_error(36, 4) == str(e.value)
    assert cs.vc_layout_error(16, 8) is None  # part of one row
    assert cs.vc_layout_error(16, 2) is None  # two rows a rank


def test_every_vc_name_runs_across_processes():
    assert set(VC_APPS) <= set(DIST_APP_NAMES)


# ---- ranks in threads ----------------------------------------------------


class _Board:
    def __init__(self, world):
        self.barrier = threading.Barrier(world, timeout=60)
        self.slots = [None] * world
        self.mail = {}

    def share(self, rank, value):
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class ThreadVCSpec(CommSpec):
    """A rank of a k x k grid in a thread: the CommSpec's grid, peer plan
    and counts; its group collectives and peer messages through a board
    shared by the ranks."""

    def __init__(self, k, world, rank, board):
        super().__init__(k * k, "cpu", rank=rank, world=world)
        self.group = "threads"
        self.board = board

    def vc_grid(self, k):
        if k not in self._vc:
            grid = VCGrid(k, self.world, self.rank)
            self._vc[k] = (grid, {
                a: (grid.members(a) if len(grid.members(a)) > 1 else None)
                for a in (cs.VC_ROW_AXIS, cs.VC_COL_AXIS)})
        return self._vc[k][0]

    def axis_reduce(self, t, k, axis, op, async_op=False):
        members = self._axis_group(k, axis)
        every = self.board.share(self.rank, t.clone())
        if members is None:
            out = t
        else:
            vals = torch.stack([every[m] for m in members])
            out = {"min": vals.amin(0), "max": vals.amax(0),
                   "sum": vals.sum(0)}[op]
            self._count("vc_reduce", t.numel() * t.element_size())
        return cs.Pending(None, out, out) if async_op else out

    def axis_gather(self, t, k, axis):
        members = self._axis_group(k, axis)
        every = self.board.share(self.rank, t.clone())
        if members is None:
            return t
        self._count("vc_gather", t.numel() * t.element_size() * len(members))
        return torch.cat([every[m] for m in members])

    def vc_transpose(self, blocks, k):
        self._swapped = False
        out = super().vc_transpose(blocks, k)
        if not self._swapped:  # no peer: meet the others at the mailbox
            self.board.barrier.wait()
            self.board.barrier.wait()
        return out

    def _swap(self, blocks, peers):
        self._swapped = True
        for q, (send, _) in peers.items():
            self.board.mail[self.rank, q] = blocks[send].clone()
        self.board.barrier.wait()
        got = {q: self.board.mail[q, self.rank] for q in peers}
        self.board.barrier.wait()
        return got


def _grid_worlds():
    return [(2, 2), (2, 4), (3, 3), (4, 2), (4, 8)]


@pytest.mark.parametrize("k,world", _grid_worlds())
def test_vc_context_collectives_are_the_one_card_context(k, world):
    rng = np.random.default_rng(7 + k * world)
    vc = 8
    x = torch.from_numpy(rng.uniform(0, 1, (k, k, vc)).astype(np.float32))
    v = torch.from_numpy(rng.integers(0, 100, (k, vc)).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(size=(k * vc,)) < 0.3)
    one = VCStepContext(k)
    board = _Board(world)

    def rank(r):
        spec = ThreadVCSpec(k, world, r, board)
        ctx = VCStepContext(k, spec=spec)
        g = ctx.grid
        rows = slice(g.r_lo, g.r_lo + g.nr)
        cols = slice(g.c_lo, g.c_lo + g.nc)
        mine = x[rows, cols].contiguous()
        got = {
            "row_min": ctx.row_min(mine), "col_min": ctx.col_min(mine),
            "row_sum": ctx.row_sum(mine), "col_sum": ctx.col_sum(mine),
            "transpose": ctx.vc_transpose(mine),
            "cols_to_rows": ctx.cols_to_rows(ctx.row_min(mine)),
            "rows_to_cols": ctx.rows_to_cols(v[rows]),
            "count": ctx.count_rows(mask[g.r_lo * vc:(g.r_lo + g.nr) * vc]),
        }
        return got, (rows, cols), dict(spec.stats)

    want = {"row_min": one.row_min(x), "col_min": one.col_min(x),
            "row_sum": one.row_sum(x), "col_sum": one.col_sum(x),
            "transpose": one.vc_transpose(x), "count": one.count_rows(mask)}
    for got, (rows, cols), stats in run_ranks(rank, world):
        for key, sel in (("row_min", cols), ("col_min", rows)):
            assert torch.equal(got[key], want[key][sel]), key
        for key, sel in (("row_sum", cols), ("col_sum", rows)):
            torch.testing.assert_close(got[key], want[key][sel], rtol=1e-6,
                                       atol=1e-6)
        assert torch.equal(got["transpose"], want["transpose"][rows, cols])
        assert torch.equal(got["cols_to_rows"], want["row_min"][rows])
        assert torch.equal(got["rows_to_cols"], v[cols])
        assert int(got["count"]) == int(want["count"])
        # no collective moves the tile stack
        assert stats["all_gather"] == 0 and stats["vc_gather"] == 0
        # a transpose moves at most the rank's fl [vc] blocks (three here)
        assert stats["vc_transpose_bytes"] <= 3 * x[rows, cols].numel() * 4


def test_a_rank_places_its_tiles_only():
    """At world 4, k 2 a rank places one tile's CSR rows and its row
    chunk's mask; fragment_bytes prices exactly the placed tensors; a
    release and restore keep the slab."""
    src, dst, w, oids = edges()
    whole = ImmutableVertexcutFragment.build(
        CommSpec(4, "cpu"), oids, src, dst, None)
    total = 0
    for r in range(4):
        spec = ThreadVCSpec(2, 4, r, _Board(1))
        f = ImmutableVertexcutFragment.build(spec, oids, src, dst, None)
        arrs = f.device_arrays()
        vc = f.vc
        assert arrs["ie_indptr"].shape == (1, vc + 1)
        assert arrs["vmask"].shape == (vc,)
        placed = sum(t.numel() * t.element_size()
                     for t in (f.dev.ie.indptr, f.dev.ie.nbr, f.dev.oe.indptr,
                               f.dev.oe.nbr, f.dev.vmask))
        assert fragment_bytes(f) == placed
        assert f.release_device() and f.restore_device()
        assert torch.equal(f.dev.ie.nbr, torch.from_numpy(arrs["ie_nbr"]))
        total += f._slab_csr("ie").num_edges
        assert f.tile_stats() == whole.tile_stats()
    assert total == whole._concat_csr("ie").num_edges
