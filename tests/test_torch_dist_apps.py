"""The rest of the LDBC six across processes on the CPU (gloo), against
the JAX package.

* CLI gangs (`--device cpu`, p2p-31): `cdlp` (CDLP on the global label
  universe), `lcc` (LCCBeta's ring of ELL blocks) and `lcc_bitmap` (LCC's
  ring of bitmap blocks through the row AND-popcount) write the result
  files of the JAX package's single-process `Worker` at the same fnum,
  byte for byte, in the same rounds on every rank, and pass the goldens
  (CDLP exact, LCC within 1e-4).
* `Communicator.ring_shift` across two spawned gloo ranks hands each rank
  the next rank's block, bit for bit, and counts its calls and bytes; a
  group of one is the identity.
* PageRank `spmv_mode="strict"` through `Worker` on a two-rank gloo group
  runs the strict tiles on each rank's slab: equal to one process's
  strict run bit for bit, within 1e-4 of the JAX Worker and the golden.
* CDLP under `--guard halt` (the global universe's probe) and through
  `kill_rank@4:1`, its two-rank lineage resumed by one process at fnum 2,
  equal to a cold fnum-2 run.
* What declined across ranks until the counting apps ran there (the
  spgemm and auto backends, kclique, triangle_count) passes the gate.

Every gang runs under the subprocess timeout of `run_gang` and its group
under GRAPE_DIST_TIMEOUT_S, so a stuck rank fails the test instead of
hanging it.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import CDLP as JCDLP
from libgrape_lite_tpu.models import LCC as JLCC
from libgrape_lite_tpu.models import LCCBeta as JLCCBeta
from libgrape_lite_tpu.models import PageRank as JPageRank
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.ft import checkpoint as ck
from libgrape_lite_tpu_torch.models import APP_REGISTRY, PageRank
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import DIST_APP_NAMES, QueryArgs, run_app
from libgrape_lite_tpu_torch.worker.worker import Worker, dist_apps
from tests.conftest import dataset_path
from tests.test_torch_dist import P2P, free_port, run_gang
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
)

torch.set_num_threads(1)

# app -> (CLI flags, JAX app, JAX query kwargs, golden, verifier)
APPS = {
    "cdlp": (["--cdlp_mr", "10"], JCDLP, {"max_round": 10}, "p2p-31-CDLP",
             exact_verify),
    "lcc": ([], JLCCBeta, {}, "p2p-31-LCC", eps_verify),
    "lcc_bitmap": ([], JLCC, {}, "p2p-31-LCC", eps_verify),
}
# (app, fnum, world) of every gang
GANGS = [("cdlp", 2, 2), ("cdlp", 4, 2), ("lcc", 2, 2), ("lcc", 4, 2),
         ("cdlp", 4, 4), ("lcc", 4, 4), ("lcc_bitmap", 2, 2)]


def _read(prefix, fnum):
    out = []
    for f in range(fnum):
        with open(os.path.join(prefix, f"result_frag_{f}")) as fh:
            out.append(fh.read())
    return out


def cli_argv(app, prefix, fnum, world, port, *flags):
    """The CLI argv of rank r of a gang (rank r > 0 writes nowhere: its
    --out_prefix gets `_r<r>`, which must not appear)."""
    return lambda r: [
        sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
        "--application", app, "--efile", P2P[0], "--vfile", P2P[1],
        "--out_prefix", prefix + (f"_r{r}" if r else ""), "--fnum",
        str(fnum), "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", str(world), "--process_id", str(r), "--profile",
        *APPS[app][0], *flags]


def rounds_of(outs):
    """The last IncEval round each rank logged (0: PEval only)."""
    return [int(m[-1]) if (m := re.findall(r"IncEval round (\d+):", se))
            else 0 for _, _, se in outs]


_GANGS = {}


@pytest.fixture(scope="module")
def gang_root(tmp_path_factory):
    return tmp_path_factory.mktemp("dist_apps")


def gang(root, app, fnum, world):
    """(files, rounds a rank) of one gang, run once per key."""
    key = (app, fnum, world)
    if key not in _GANGS:
        prefix = str(root / f"{app}_{fnum}_{world}")
        outs = run_gang(cli_argv(app, prefix, fnum, world, free_port()),
                        world)
        for rc, so, se in outs:
            assert rc == 0, se[-3000:]
        assert not any(os.path.exists(f"{prefix}_r{r}")
                       for r in range(1, world))
        _GANGS[key] = (_read(prefix, fnum), rounds_of(outs))
    return _GANGS[key]


def jax_files(graph_cache, tmp_path, app, fnum):
    """(files, rounds) of the JAX single-process Worker."""
    _, jcls, kw, _, _ = APPS[app]
    w = JWorker(jcls(), graph_cache(fnum))
    w.query(**kw)
    w.output(str(tmp_path / f"jax_{app}_{fnum}"))
    return _read(str(tmp_path / f"jax_{app}_{fnum}"), fnum), w.rounds


@pytest.mark.parametrize("app,fnum,world", GANGS,
                         ids=[f"{a}-fnum{f}-world{w}" for a, f, w in GANGS])
def test_gang_files_equal_jax_worker(gang_root, tmp_path, graph_cache, app,
                                     fnum, world):
    got, rounds = gang(gang_root, app, fnum, world)
    want, jrounds = jax_files(graph_cache, tmp_path, app, fnum)
    assert got == want  # triangle credits and labels are exact
    _, _, _, golden, verify = APPS[app]
    verify(load_result_lines("".join(got)),
           load_golden(dataset_path(golden)))
    assert rounds == [jrounds] * world


# ---- the ring primitive across spawned gloo ranks --------------------------

RING_CHILD = r'''
import sys
import numpy as np
import torch
from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec

rank, world, port, fnum, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], int(sys.argv[4]), sys.argv[5])
spec = CommSpec.init_distributed(f"127.0.0.1:{port}", world, rank,
                                 fnum=fnum, device="cpu")
lo, hi = spec.fid_lo, spec.fid_lo + spec.fl
ctx = StepContext(fnum, spec=spec)
rng = np.random.default_rng(3)
words = torch.from_numpy(rng.integers(-2**31, 2**31, (fnum, 33, 5))
                         .astype(np.int32))
floats = torch.from_numpy(rng.standard_normal((fnum, 7)).astype(np.float32))
held, blk = [words[lo:hi]], words[lo:hi]
for _ in range(world):  # a full turn brings the own block back
    blk = ctx.ring_shift(blk)
    held.append(blk)
np.savez(out, held=torch.stack(held).numpy(),
         floats=ctx.ring_shift(floats[lo:hi]).numpy(),
         blocks=np.array([ctx.ring_block(s) for s in range(world + 1)]),
         size=np.array(ctx.ring_size()), ring=np.array(spec.stats["ring"]),
         ring_bytes=np.array(spec.stats["ring_bytes"]))
spec.close()
'''


@pytest.mark.parametrize("world", [2, 1], ids=["world2", "world1"])
def test_ring_shift_hands_on_the_next_ranks_block(tmp_path, world):
    fnum = 4
    script = tmp_path / "child.py"
    script.write_text(RING_CHILD)
    port = free_port()
    outs = run_gang(lambda r: [sys.executable, str(script), str(r),
                               str(world), str(port), str(fnum),
                               str(tmp_path / f"r{r}.npz")], world)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    rng = np.random.default_rng(3)
    words = rng.integers(-2**31, 2**31, (fnum, 33, 5)).astype(np.int32)
    floats = rng.standard_normal((fnum, 7)).astype(np.float32)
    fl = fnum // world
    for r in range(world):
        got = dict(np.load(tmp_path / f"r{r}.npz"))
        blocks = [(r + s) % world for s in range(world + 1)]
        assert got["blocks"].tolist() == blocks
        assert int(got["size"]) == world
        for s, q in enumerate(blocks):
            assert got["held"][s].tobytes() == \
                words[q * fl:(q + 1) * fl].tobytes(), (r, s)
        q = (r + 1) % world
        assert got["floats"].tobytes() == floats[q * fl:(q + 1) * fl].tobytes()
        # world shifts of the int32 block and one of the float32 one; a
        # group of one moves nothing and counts nothing
        shifts = world + 1 if world > 1 else 0
        assert int(got["ring"]) == shifts
        assert int(got["ring_bytes"]) == (
            world * fl * 33 * 5 * 4 + fl * 7 * 4 if world > 1 else 0)


# ---- PageRank's strict tiles on a rank's slab -------------------------------

PR_CHILD = r'''
import sys
import numpy as np
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import PageRank
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker

rank, port, efile, vfile, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 sys.argv[4], sys.argv[5])
spec = CommSpec.init_distributed(f"127.0.0.1:{port}", 2, rank, fnum=4,
                                 device="cpu")
frag = LoadGraph(efile, vfile, spec,
                 LoadGraphSpec(weighted=True, edata_dtype=np.float64))
shapes = []
strict = spmv.spmv_strict


def counted(values, *a, **kw):
    shapes.append(tuple(values.shape))
    return strict(values, *a, **kw)


spmv.spmv_strict = counted
w = Worker(PageRank(spmv_mode="strict"), frag)
w.query(delta=0.85, max_round=10)
vals = w.result_values()
w.output(out)
np.save(f"{out}_rank{rank}.npy", vals)
np.save(f"{out}_rank{rank}_calls.npy",
        np.array([w.rounds, len(shapes)] + sorted({s[0] for s in shapes})))
spec.close()
'''


def test_pagerank_strict_on_two_ranks(tmp_path, graph_cache):
    script = tmp_path / "child.py"
    script.write_text(PR_CHILD)
    out = str(tmp_path / "pr")
    port = free_port()
    outs = run_gang(lambda r: [sys.executable, str(script), str(r),
                               str(port), P2P[0], P2P[1], out], 2)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    one = Worker(PageRank(spmv_mode="strict"),
                 LoadGraph(*P2P, CommSpec(4, "cpu"),
                           LoadGraphSpec(weighted=True,
                                         edata_dtype=np.float64)))
    one.query(delta=0.85, max_round=10)
    want = one.result_values()
    for r in range(2):
        got = np.load(f"{out}_rank{r}.npy")
        # tiles never cross a fragment: each slab's sums are one process's
        assert got.tobytes() == want.tobytes()
        rounds, calls, *rows = np.load(f"{out}_rank{r}_calls.npy").tolist()
        # a strict pull a round, each on the rank's [2, Ep] slab
        assert (rounds, calls, rows) == (one.rounds, one.rounds, [2])
    jw = JWorker(JPageRank(), graph_cache(4))
    jw.query(delta=0.85, max_round=10)
    jw.output(str(tmp_path / "jax"))
    res = load_result_lines("".join(_read(out, 4)))
    eps_verify(res, load_result_lines("".join(_read(str(tmp_path / "jax"),
                                                    4))))
    eps_verify(res, load_golden(dataset_path("p2p-31-PR")))
    assert jw.rounds == one.rounds


# ---- CDLP's guard and fault plan across ranks -------------------------------

def test_cdlp_gang_guard_halt_equals_one_process(gang_root, tmp_path,
                                                 graph_cache):
    """--guard halt across two ranks probes the label universe every
    round (the slabs' bad-label counts summed: none) and writes the
    unguarded files."""
    prefix = str(tmp_path / "guarded")
    outs = run_gang(cli_argv("cdlp", prefix, 4, 2, free_port(), "--guard",
                             "halt"), 2)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
        assert "guard: probes every 1 round(s) (policy=halt)" in se
    assert _read(prefix, 4) == gang(gang_root, "cdlp", 4, 2)[0]


def test_cdlp_gang_kill_rank_then_one_process_reshard(tmp_path):
    """kill_rank@4:1 kills rank 1 after superstep 4's commit (exit 17);
    one process resumes the two-rank lineage onto fnum 2 (labels are
    oids: no value map) and writes the cold fnum-2 run's files."""
    ckdir = str(tmp_path / "ck")
    outs = run_gang(cli_argv("cdlp", str(tmp_path / "gang"), 4, 2,
                             free_port(), "--checkpoint_every", "2",
                             "--checkpoint_dir", ckdir), 2,
                    GRAPE_FT_FAULTS="kill_rank@4:1")
    assert outs[1][0] == 17, outs[1][2][-3000:]
    assert outs[0][0] != 0
    rounds, path = ck.list_checkpoints(ckdir)[-1]
    meta = ck.read_meta(path)
    assert (rounds, meta["layout"], meta["ranks"]) == (4, "sharded", 2)
    common = dict(application="cdlp", efile=P2P[0], vfile=P2P[1], fnum=2,
                  cdlp_mr=10, device="cpu")
    run_app(QueryArgs(resume=True, checkpoint_dir=ckdir,
                      out_prefix=str(tmp_path / "res"), **common))
    run_app(QueryArgs(out_prefix=str(tmp_path / "cold"), **common))
    assert _read(str(tmp_path / "res"), 2) == _read(str(tmp_path / "cold"),
                                                    2)


# ---- the gate ----------------------------------------------------------------

def test_dist_app_names_follow_the_classes():
    """Every registry name of a dist app's class passes the gate (aliases
    included), and no other name does; since the vertex cut runs across
    ranks that is every name of the registry."""
    classes = dist_apps()
    assert set(DIST_APP_NAMES) == {n for n, c in APP_REGISTRY.items()
                                   if c in classes}
    assert {"cdlp", "cdlp_auto", "lcc", "lcc_auto", "lcc_beta", "lcc_opt",
            "lcc_bitmap", "lcc_directed", "triangle_count",
            "kclique"} <= set(DIST_APP_NAMES)
    assert {"pagerank_vc", "pagerank_vc_rep", "sssp_vc", "bfs_vc",
            "wcc_vc"} <= set(DIST_APP_NAMES)
    assert set(DIST_APP_NAMES) == set(APP_REGISTRY)


# what declined across ranks until the counting apps ran there: the same
# flags now pass the gate, and the absent edge file fails the load
DECLINES = [
    (dict(application="lcc_bitmap"), {"GRAPE_LCC_BACKEND": "spgemm"}),
    (dict(application="lcc_opt"), {"GRAPE_LCC_BACKEND": "auto"}),
    (dict(application="kclique"), {}),
    (dict(application="triangle_count"), {}),
]


@pytest.mark.parametrize("flags,env", DECLINES,
                         ids=["spgemm", "auto", "kclique", "triangle_count"])
def test_still_declines_before_the_load(tmp_path, monkeypatch, flags, env):
    from tests.test_torch_dist import pass_the_gate

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = dict(efile=str(tmp_path / "absent.e"), device="cpu",
                coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                fnum=2, **flags)
    pass_the_gate(monkeypatch)
    with pytest.raises(FileNotFoundError, match="absent.e"):
        run_app(QueryArgs(**args))


def test_worker_declines_the_spgemm_backend_across_ranks(monkeypatch):
    """A Worker over two slab ranks (in threads) runs the spgemm backend:
    each rank keeps its fragments' items, the credits fold across ranks,
    and the result is one process's."""
    from libgrape_lite_tpu_torch.models import LCC
    from tests.test_torch_dist_count import run_slab_workers

    monkeypatch.setenv("GRAPE_LCC_BACKEND", "spgemm")
    (want, _), got = run_slab_workers(LCC, {}, False, 2)
    for vals, app in got:
        assert app.lcc_backend == "spgemm"
        np.testing.assert_array_equal(vals, want)
