"""The port's load path (libgrape_lite_tpu_torch) against the JAX package.

The same p2p-31 files go through both loaders; every array of the
fragment -- the oid <-> pid maps, each CSR stream, degrees, inner mask
and oids -- must be equal, element for element, at fnum 1, 2 and 4,
directed and undirected.  Also: partitioner and idxer parity on random
oids, `fragment_from_numpy`, `CSR.validate`, and that the package imports
neither JAX nor the JAX package and refuses a missing CUDA device.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment.loader import LoadGraph as JLoadGraph
from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JSpec
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.vertex_map import idxer as jidx
from libgrape_lite_tpu.vertex_map import partitioner as jpart
from libgrape_lite_tpu_torch.fragment.edgecut import fragment_from_numpy
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.graph.csr import CSRValidationError
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.vertex_map import idxer as tidx
from libgrape_lite_tpu_torch.vertex_map import partitioner as tpart
from tests.conftest import dataset_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_FRAGS = {}
_PORT_FRAGS = {}


def jax_frag(fnum, directed):
    key = (fnum, directed)
    if key not in _JAX_FRAGS:
        _JAX_FRAGS[key] = JLoadGraph(
            dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
            JCommSpec(fnum=fnum),
            JSpec(directed=directed, weighted=True, edata_dtype=np.float64),
        )
    return _JAX_FRAGS[key]


def port_frag(fnum, directed):
    key = (fnum, directed)
    if key not in _PORT_FRAGS:
        _PORT_FRAGS[key] = LoadGraph(
            dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
            CommSpec(fnum=fnum, device="cpu"),
            LoadGraphSpec(directed=directed, weighted=True,
                          edata_dtype=np.float64),
        )
    return _PORT_FRAGS[key]


def jax_arrays(jfrag):
    """numpy leaves of a JAX DeviceFragment, keyed for fragment_from_numpy."""
    d = jfrag.dev
    arrays = {k: np.asarray(getattr(d, k)) for k in
              ("ivnum", "inner_mask", "oids", "out_degree", "in_degree")}
    sides = [("oe", d.oe)] + ([] if d.ie is d.oe else [("ie", d.ie)])
    for name, csr in sides:
        for k in ("indptr", "edge_src", "edge_nbr", "edge_w", "edge_mask"):
            v = getattr(csr, k)
            if v is not None:
                arrays[f"{name}.{k}"] = np.asarray(v)
    meta = {k: getattr(d, k) for k in
            ("fnum", "vp", "directed", "total_vnum", "total_enum")}
    return arrays, meta


def assert_same_fragment(pfrag, jfrag):
    jd, pd = jfrag.dev, pfrag.dev
    for k in ("fnum", "vp", "directed", "total_vnum", "total_enum"):
        assert getattr(pd, k) == getattr(jd, k), k
    for k in ("ivnum", "inner_mask", "oids", "out_degree", "in_degree"):
        np.testing.assert_array_equal(
            getattr(pd, k).numpy(), np.asarray(getattr(jd, k)), err_msg=k)
    for side in ("oe", "ie"):
        for k in ("indptr", "edge_src", "edge_nbr", "edge_w", "edge_mask"):
            jv = getattr(getattr(jd, side), k)
            pv = getattr(getattr(pd, side), k)
            assert (jv is None) == (pv is None), f"{side}.{k}"
            if jv is not None:
                np.testing.assert_array_equal(
                    pv.numpy(), np.asarray(jv), err_msg=f"{side}.{k}")
    assert (pfrag.host_ie is pfrag.host_oe) == (jfrag.host_ie is jfrag.host_oe)


@pytest.mark.parametrize("directed", [False, True], ids=["undirected",
                                                         "directed"])
@pytest.mark.parametrize("fnum", [1, 2, 4])
def test_load_graph_matches_jax(fnum, directed):
    jfrag, pfrag = jax_frag(fnum, directed), port_frag(fnum, directed)
    assert_same_fragment(pfrag, jfrag)
    # oid <-> pid maps
    oids = np.loadtxt(dataset_path("p2p-31.v"), dtype=np.int64, usecols=0)
    probe = np.concatenate([oids, [-5, 10**9]])  # two unknown oids
    pids = pfrag.oid_to_pid(probe)
    np.testing.assert_array_equal(pids, jfrag.oid_to_pid(probe))
    np.testing.assert_array_equal(pfrag.pid_to_oid(pids[:-2]), oids)
    for f in range(fnum):
        np.testing.assert_array_equal(pfrag.inner_oids(f),
                                      jfrag.inner_oids(f))


@pytest.mark.parametrize("directed", [False, True], ids=["undirected",
                                                         "directed"])
def test_fragment_from_numpy_carries_jax_fragment(directed):
    jfrag = jax_frag(2, directed)
    arrays, meta = jax_arrays(jfrag)
    pfrag = fragment_from_numpy(arrays, meta, device="cpu")
    assert_same_fragment(pfrag, jfrag)
    probe = np.array([1, 2, 3, 62586, -1])
    np.testing.assert_array_equal(pfrag.oid_to_pid(probe),
                                  jfrag.oid_to_pid(probe))


def test_csr_validate():
    pfrag = port_frag(2, True)
    n_pad = pfrag.fnum * pfrag.vp
    for c in pfrag.host_oe + pfrag.host_ie:
        c.validate(n_pad=n_pad)
    bad = pfrag.host_ie[0]
    nbr = bad.edge_nbr.copy()
    nbr[0] = n_pad  # out of the padded id space
    broken = type(bad)(bad.indptr, bad.edge_src, nbr, bad.edge_w,
                       bad.edge_mask, bad.num_rows, bad.num_edges)
    with pytest.raises(CSRValidationError, match="outside"):
        broken.validate(n_pad=n_pad)


@pytest.mark.parametrize("kind", ["hash", "map", "segment"])
@pytest.mark.parametrize("fnum", [1, 3, 4])
def test_partitioners_match_jax(kind, fnum):
    rng = np.random.default_rng(5)
    oids = rng.permutation(rng.choice(10**6, 5000, replace=False))
    queries = np.concatenate([oids, rng.integers(0, 10**6, 500)])
    want = jpart.make_partitioner(kind, fnum, oids).get_partition_id(queries)
    got = tpart.make_partitioner(kind, fnum, oids).get_partition_id(queries)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["hashmap", "sorted_array"])
def test_idxers_match_jax(kind):
    rng = np.random.default_rng(6)
    oids = rng.permutation(rng.choice(10**6, 4000, replace=False))
    queries = np.concatenate([oids[::-1], rng.integers(0, 10**6, 300)])
    j, t = jidx.make_idxer(kind, oids), tidx.make_idxer(kind, oids)
    np.testing.assert_array_equal(t.get_index(queries), j.get_index(queries))
    lids = np.arange(len(oids))
    np.testing.assert_array_equal(t.get_oid(lids), j.get_oid(lids))


def test_import_is_jax_free_and_cuda_default_raises():
    """Importing the port loads neither jax, the JAX package nor triton; the
    default device is CUDA and every entry point refuses its absence."""
    code = (
        "import sys\n"
        "import libgrape_lite_tpu_torch as L\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'libgrape_lite_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "for make in (lambda: L.CommSpec(),\n"
        "             lambda: L.LoadGraph('dataset/p2p-31.e', None,\n"
        "                                 L.CommSpec()),\n"
        "             lambda: L.run_app(L.QueryArgs(application='sssp',\n"
        "                               efile='dataset/p2p-31.e'))):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'cuda' in str(e).lower(), e\n"
        "    else:\n"
        "        raise AssertionError('no error without CUDA')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_port_sources_import_no_jax():
    """No module of the port and no line of chip_smoke.py imports jax or
    the JAX package (checked on the syntax tree)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "libgrape_lite_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    # the serving fleet's slice; fault tolerance and the guards; guarded
    # serving and the vertex cut; grape-lint
    for sub in ("fleet", "autopilot", "obs", "ft", "guard", "analysis"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for mod in ("serve/batch.py", "fragment/vertexcut.py",
                "fragment/partition.py", "models/vc2d.py",
                "models/pagerank_vc.py"):
        assert any(f.endswith(os.sep + mod.replace("/", os.sep))
                   for f in files), mod
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "libgrape_lite_tpu"), (path, m)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA,
    in the repo and as a lone copy outside it."""
    import shutil

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), str(lone))):
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


SLICE8_MODULES = [
    "libgrape_lite_tpu_torch.utils.archive",
    "libgrape_lite_tpu_torch.utils.memory",
    "libgrape_lite_tpu_torch.utils.thread_pool",
    "libgrape_lite_tpu_torch.io.native",
    "libgrape_lite_tpu_torch.fragment.rebalancer",
    "libgrape_lite_tpu_torch.fragment.partition",
    "libgrape_lite_tpu_torch.ops.spgemm_pack",
    "libgrape_lite_tpu_torch.sampler",
    "libgrape_lite_tpu_torch.sampler.stream",
    "libgrape_lite_tpu_torch.scripts.run_sampler",
]


def test_slice8_modules_import_without_jax():
    """Each module of the load options, the spgemm backend and the
    sampler imports with neither jax, the JAX package nor triton, and
    builds nothing at import (no native library, no CUDA kernel)."""
    code = (
        "import sys, importlib\n"
        f"for m in {SLICE8_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'libgrape_lite_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "from libgrape_lite_tpu_torch.io import native\n"
        "assert native._tried is False\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


FLEET_MODULES = [
    "libgrape_lite_tpu_torch.obs",
    "libgrape_lite_tpu_torch.obs.federation",
    "libgrape_lite_tpu_torch.obs.slo",
    "libgrape_lite_tpu_torch.fleet",
    "libgrape_lite_tpu_torch.fleet.budget",
    "libgrape_lite_tpu_torch.fleet.router",
    "libgrape_lite_tpu_torch.fleet.drain",
    "libgrape_lite_tpu_torch.fleet.tenancy",
    "libgrape_lite_tpu_torch.autopilot",
    "libgrape_lite_tpu_torch.autopilot.signals",
    "libgrape_lite_tpu_torch.autopilot.cache",
    "libgrape_lite_tpu_torch.autopilot.admission",
    "libgrape_lite_tpu_torch.autopilot.scaler",
    "libgrape_lite_tpu_torch.ft",
    "libgrape_lite_tpu_torch.ft.checkpoint",
    "libgrape_lite_tpu_torch.ft.faults",
    "libgrape_lite_tpu_torch.ft.fingerprint",
    "libgrape_lite_tpu_torch.ft.retry",
    "libgrape_lite_tpu_torch.guard",
    "libgrape_lite_tpu_torch.guard.config",
    "libgrape_lite_tpu_torch.guard.invariants",
    "libgrape_lite_tpu_torch.guard.monitor",
    "libgrape_lite_tpu_torch.guard.watchdog",
    "libgrape_lite_tpu_torch.scripts.fault_drill",
    "libgrape_lite_tpu_torch.serve.batch",
    "libgrape_lite_tpu_torch.fragment.vertexcut",
    "libgrape_lite_tpu_torch.fragment.partition",
    "libgrape_lite_tpu_torch.models.vc2d",
    "libgrape_lite_tpu_torch.models.pagerank_vc",
    "libgrape_lite_tpu_torch.vertex_map.partitioner",
    "libgrape_lite_tpu_torch.analysis",
    "libgrape_lite_tpu_torch.scripts.grape_lint",
]


def test_fleet_modules_import_without_jax():
    """Each module of the fleet, the autopilot and the port's obs/ imports
    with neither jax, the JAX package nor triton, and registers its
    federation namespace without asking for a card."""
    code = (
        "import sys, importlib\n"
        f"for m in {FLEET_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'libgrape_lite_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "from libgrape_lite_tpu_torch.obs import federation\n"
        "assert federation.self_check() == [], federation.self_check()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
