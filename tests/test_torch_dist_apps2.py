"""The K1 library apps across processes on the CPU (gloo), against one
process and the JAX package.

* CLI gangs (`--device cpu`, p2p-31 at fnum 4, two ranks; four for one
  case) of kcore (`--kcore_k`), core_decomposition, pagerank_local, khop
  (`--khop_k` 2 and 3), common_neighbors (`--cn_source`) and bc
  (`--bc_source`) write the files of the port's one-process CLI byte for
  byte (pagerank_local within 1e-4) and of the JAX package's
  single-process `Worker` at fnum 4 (pagerank_local: float64 there,
  float32 in the CLI, within 1e-4), in the same rounds on every rank;
  under `--guard halt` two of them probe every round with no breach and
  write the unguarded files.
* The guard's probe of two slab ranks in threads (no group: the probe's
  exchange through a thread barrier, tests/test_torch_gang.py) gives one
  process's verdicts, measures and digest for the six apps.

Every gang runs under the subprocess timeout and its group under
GRAPE_DIST_TIMEOUT_S; the gangs of the file start at once.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch import cli
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.runner import DIST_APP_NAMES
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.test_torch_dist import CHILD_TIMEOUT_S, P2P, REPO, child_env
from tests.test_torch_dist import free_port
from tests.test_torch_dist_apps import _read, rounds_of
from tests.test_torch_gang import _probe_both, frag_of
from tests.verifiers import eps_verify, load_result_lines

torch.set_num_threads(1)

FNUM = 4
CN_SOURCE = 10316  # p2p-31's vertex in the most triangles

# case -> (app, CLI flags, JAX constructor kwargs, JAX query kwargs)
CASES = {
    "kcore": ("kcore", ["--kcore_k", "4"], {}, {"k": 4}),
    "core_decomposition": ("core_decomposition", [], {}, {}),
    "pagerank_local": ("pagerank_local", ["--pr_mr", "10"], {},
                       {"delta": 0.85, "max_round": 10}),
    "khop2": ("khop", ["--khop_k", "2", "--bfs_source", "6"], {"k": 2},
              {"source": 6}),
    "khop3": ("khop", ["--khop_k", "3", "--bfs_source", "6"], {"k": 3},
              {"source": 6}),
    "common_neighbors": ("common_neighbors",
                         ["--cn_source", str(CN_SOURCE)], {},
                         {"source": CN_SOURCE}),
    "bc": ("bc", ["--bc_source", "6"], {}, {"source": 6}),
}
# (gang, case, world, extra flags)
GANGS = [(case, case, 2, []) for case in CASES] + [
    ("core_decomposition-world4", "core_decomposition", 4, []),
    ("kcore-guard", "kcore", 2, ["--guard", "halt"]),
    ("core_decomposition-guard", "core_decomposition", 2,
     ["--guard", "halt"]),
]
RTOL = {"pagerank_local"}  # float sums: the verifier's 1e-4


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """gang -> (rank outputs, files): every gang of the file, started at
    once."""
    root = tmp_path_factory.mktemp("dist_apps2")
    procs = {}
    for gang, case, world, extra in GANGS:
        app, flags = CASES[case][:2]
        port, prefix = free_port(), str(root / gang)
        procs[gang] = [subprocess.Popen(
            [sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
             "--application", app, "--efile", P2P[0], "--vfile", P2P[1],
             "--out_prefix", prefix + (f"_r{r}" if r else ""), "--fnum",
             str(FNUM), "--device", "cpu", "--coordinator",
             f"127.0.0.1:{port}", "--num_processes", str(world),
             "--process_id", str(r), "--profile", *flags, *extra],
            cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    out = {}
    try:
        for gang, ps in procs.items():
            out[gang] = []
            for p in ps:
                so, se = p.communicate(timeout=CHILD_TIMEOUT_S)
                out[gang].append((p.returncode, so, se))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for gang, outs in out.items():
        for rc, so, se in outs:
            assert rc == 0, (gang, se[-3000:])
    return root, out


def _same(case, got, want):
    if case in RTOL:
        eps_verify(load_result_lines("".join(got)),
                   load_result_lines("".join(want)))
    else:
        assert got == want


@pytest.mark.parametrize("gang", [g[0] for g in GANGS])
def test_gang_files_equal_one_process_and_jax(gangs, tmp_path, graph_cache,
                                              gang):
    root, out = gangs
    _, case, world, extra = next(g for g in GANGS if g[0] == gang)
    app, flags, ctor, kw = CASES[case]
    got = _read(str(root / gang), FNUM)
    assert not any(os.path.exists(f"{root / gang}_r{r}")
                   for r in range(1, world))
    one = str(tmp_path / "one")
    cli.main(["--application", app, "--efile", P2P[0], "--vfile", P2P[1],
              "--out_prefix", one, "--fnum", str(FNUM), "--device", "cpu",
              *flags])
    # a one-process run of the port prints the same bytes (pagerank_local
    # too: each row's sum reads the same edges in the same order)
    assert got == _read(one, FNUM)
    jw = JWorker(JAPPS[app](**ctor), graph_cache(FNUM))
    jw.query(**kw)
    jw.output(str(tmp_path / "jax"))
    _same(case, got, _read(str(tmp_path / "jax"), FNUM))
    assert rounds_of(out[gang]) == [jw.rounds] * world
    if extra:
        for _, _, se in out[gang]:
            assert "guard: probes every 1 round(s) (policy=halt)" in se


def test_the_six_pass_the_gate():
    assert {"kcore", "core_decomposition", "pagerank_local",
            "pagerank_local_parallel", "khop", "common_neighbors", "bc",
            "staged_bc", "staged_bc_bfs"} <= set(DIST_APP_NAMES)


# ---- the guard's probe of two slab ranks ------------------------------------

PROBE_APPS = {
    "kcore": (lambda: APP_REGISTRY["kcore"](), {"k": 4}),
    "core_decomposition": (lambda: APP_REGISTRY["core_decomposition"](),
                           {}),
    "pagerank_local": (lambda: APP_REGISTRY["pagerank_local"](
        dtype=torch.float64), {"delta": 0.85, "max_round": 10}),
    "khop": (lambda: APP_REGISTRY["khop"](k=3), {"source": 6}),
    "common_neighbors": (lambda: APP_REGISTRY["common_neighbors"](),
                         {"source": CN_SOURCE}),
    "bc": (lambda: APP_REGISTRY["bc"](dtype=torch.float64), {"source": 6}),
}


@pytest.mark.parametrize("name", list(PROBE_APPS))
def test_probe_across_ranks_is_the_one_process_probe(name):
    """Carries after rounds 1 and 2 (bc: its PEval), probed by one
    process and by two slab ranks exchanging their partial sums."""
    make, kw = PROBE_APPS[name]
    prev, cur = ({k: v.clone() for k, v in Worker(make(), frag_of()).query(
        rounds, **kw).items()} for rounds in (1, 2))
    want, got = _probe_both(make, prev, cur)
    assert all(want[0])
    for oks, vals, digest, residual in got:
        assert oks == want[0]
        np.testing.assert_allclose(vals, want[1], rtol=1e-5, atol=1e-7)
        assert digest == want[2]
        assert residual == pytest.approx(want[3], rel=1e-7)
