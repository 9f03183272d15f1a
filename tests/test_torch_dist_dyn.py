"""Delta loads across processes on the CPU (gloo), against the JAX
package.

`run_app --delta_efile / --delta_vfile` under `--coordinator /
--num_processes / --process_id`: every rank applies the same edit to its
parsed host arrays (`LoadGraphAndMutate`) and places its slab.  CLI gangs
of two ranks at fnum 4 (and one of four) on p2p-31's mutable base and
delta write the files of the port's one-process CLI byte for byte
(PageRank within 1e-4), equal the JAX package's `LoadGraphAndMutate` +
`Worker` files, in the same rounds on every rank, and pass the p2p-31
goldens (the base and the delta make p2p-31).  A delta load reads and
writes no garc cache, in a gang as in one process.

Every gang runs under the subprocess timeout of `run_gang` and its group
under GRAPE_DIST_TIMEOUT_S.  The gangs of the file start at once, before
the first check.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JLoadGraphSpec
from libgrape_lite_tpu.fragment.mutation import (
    LoadGraphAndMutate as JLoadGraphAndMutate,
)
from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch import cli
from tests.conftest import dataset_path
from tests.test_torch_dist import (
    CHILD_TIMEOUT_S,
    P2P,
    REPO,
    child_env,
    free_port,
)
from tests.test_torch_dist_apps import _read, rounds_of
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

BASE = dataset_path("p2p-31.e.mutable_base")
DELTA = dataset_path("p2p-31.e.mutable_delta")
FNUM = 4
# the vertex edit of the --delta_vfile case: a new isolated vertex, and
# one removed with its edges
VDELTA = "a 99999999\nd 17\n"

# app -> (CLI flags, JAX query kwargs, golden, verifier)
APPS = {
    "sssp": (["--sssp_source", "6"], {"source": 6}, "p2p-31-SSSP",
             exact_verify),
    "bfs": (["--bfs_source", "6"], {"source": 6}, "p2p-31-BFS",
            exact_verify),
    "wcc": ([], {}, "p2p-31-WCC", wcc_verify),
    "pagerank": (["--pr_mr", "10"], {"delta": 0.85, "max_round": 10},
                 "p2p-31-PR", eps_verify),
    "cdlp": (["--cdlp_mr", "10"], {"max_round": 10}, "p2p-31-CDLP",
             exact_verify),
    "lcc": ([], {}, "p2p-31-LCC", eps_verify),
}
# (case, app, world, vfile delta?, --serialize?)
GANGS = [(app, app, 2, False, False) for app in APPS] + [
    ("sssp-world4", "sssp", 4, False, False),
    ("bfs-vfile", "bfs", 2, True, False),
    ("sssp-serialize", "sssp", 2, False, True),
]


def _argv(case, app, world, vfile, ser, root, port):
    """Rank r's CLI argv (r > 0 writes under `_r<r>`, which must not
    appear)."""
    prefix = str(root / case)
    extra = ["--delta_vfile", str(root / "vdelta")] if vfile else []
    if ser:
        extra += ["--serialize", "--serialization_prefix",
                  str(root / "ser")]
    return lambda r: [
        sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
        "--application", app, "--efile", BASE, "--vfile", P2P[1],
        "--delta_efile", DELTA, "--out_prefix",
        prefix + (f"_r{r}" if r else ""), "--fnum", str(FNUM), "--device",
        "cpu", "--coordinator", f"127.0.0.1:{port}", "--num_processes",
        str(world), "--process_id", str(r), "--profile", *APPS[app][0],
        *extra]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """case -> (rank outputs, files): every gang of the file, started at
    once."""
    root = tmp_path_factory.mktemp("dist_dyn")
    (root / "vdelta").write_text(VDELTA)
    procs = {}
    for case, app, world, vfile, ser in GANGS:
        argv = _argv(case, app, world, vfile, ser, root, free_port())
        procs[case] = [subprocess.Popen(
            argv(r), cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    out = {}
    try:
        for case, ps in procs.items():
            out[case] = []
            for p in ps:
                so, se = p.communicate(timeout=CHILD_TIMEOUT_S)
                out[case].append((p.returncode, so, se))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for case, outs in out.items():
        for rc, so, se in outs:
            assert rc == 0, (case, se[-3000:])
    return root, out


def one_process(tmp_path, app, *extra):
    """The port's one-process CLI files of the same delta load."""
    prefix = str(tmp_path / f"one_{app}")
    cli.main(["--application", app, "--efile", BASE, "--vfile", P2P[1],
              "--delta_efile", DELTA, "--out_prefix", prefix, "--fnum",
              str(FNUM), "--device", "cpu", *APPS[app][0], *extra])
    return _read(prefix, FNUM)


def jax_files(tmp_path, app, vdelta=None):
    """(files, rounds) of the JAX `LoadGraphAndMutate` + `Worker`."""
    frag = JLoadGraphAndMutate(
        BASE, P2P[1], DELTA, vdelta, JCommSpec(fnum=FNUM),
        JLoadGraphSpec(weighted=True, edata_dtype=np.float64))
    w = JWorker(JAPPS[app](), frag)
    w.query(**APPS[app][1])
    prefix = str(tmp_path / f"jax_{app}")
    w.output(prefix)
    return _read(prefix, FNUM), w.rounds


def _same(app, got, want):
    """Byte-equal, PageRank within the verifier's 1e-4."""
    if app == "pagerank":
        eps_verify(load_result_lines("".join(got)),
                   load_result_lines("".join(want)))
    else:
        assert got == want


@pytest.mark.parametrize("case", [g[0] for g in GANGS])
def test_delta_gang_files_equal_one_process_and_jax(gangs, tmp_path, case):
    root, out = gangs
    _, app, world, vfile, ser = next(g for g in GANGS if g[0] == case)
    got = _read(str(root / case), FNUM)
    assert not any(os.path.exists(f"{root / case}_r{r}")
                   for r in range(1, world))
    extra = ["--delta_vfile", str(root / "vdelta")] if vfile else []
    _same(app, got, one_process(tmp_path, app, *extra))
    want, jrounds = jax_files(tmp_path, app,
                              str(root / "vdelta") if vfile else None)
    _same(app, got, want)
    assert rounds_of(out[case]) == [jrounds] * world
    if not vfile:  # base + delta is p2p-31
        _, _, golden, verify = APPS[app]
        verify(load_result_lines("".join(got)),
               load_golden(dataset_path(golden)))
    if ser:
        # a delta load builds from the edited arrays: no garc cache is
        # written, by the gang as by one process
        assert not list(root.rglob("frag.garc"))
        one_process(tmp_path, app, "--serialize", "--serialization_prefix",
                    str(tmp_path / "ser"))
        assert not list(tmp_path.rglob("frag.garc"))
