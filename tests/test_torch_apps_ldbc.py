"""BFS, WCC, CDLP and the three LCCs through the port's Worker, against
the JAX Worker on the same fragment and against the goldens.

* the JAX Worker's `result_values()`: bit-equal (int64 depths, component
  oids and community labels; float64 clustering coefficients) with equal
  round counts -- every fold here is an integer min, mode or sum, exact
  in any order;
* the goldens by the rules of tests/verifiers.py: p2p-31-BFS and
  p2p-31-BFS-directed and p2p-31-CDLP exact, p2p-31-WCC by partition
  isomorphism, p2p-31-LCC within 1e-4 (lcc and lcc_bitmap);
* per-vertex triangle counts integer-identical to the JAX package's.

Fragments reach the port carried across from the JAX fragment
(`fragment_from_numpy`) and through the port's own loader, at fnum 1, 2,
4 and 8.  One JAX run per (app, fnum) is shared through a module cache.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import BFS as JBFS
from libgrape_lite_tpu.models import CDLP as JCDLP
from libgrape_lite_tpu.models import LCC as JLCC
from libgrape_lite_tpu.models import WCC as JWCC
from libgrape_lite_tpu.models import LCCBeta as JLCCBeta
from libgrape_lite_tpu.models import LCCDirected as JLCCDirected
from libgrape_lite_tpu.models.triangle_count import TriangleCount
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.edgecut import fragment_from_numpy
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import (
    APP_REGISTRY,
    BFS,
    CDLP,
    LCC,
    WCC,
    LCCBeta,
    LCCDirected,
)
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_apps import result_dict
from tests.test_torch_substrate import REPO, jax_arrays
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    wcc_verify,
)

torch.set_num_threads(1)

# name -> (JAX class, port class, query kwargs, directed, golden, rule)
QUERIES = {
    "bfs": (JBFS, BFS, {"source": 6}, False, "p2p-31-BFS", exact_verify),
    "bfs_directed": (JBFS, BFS, {"source": 6}, True, "p2p-31-BFS-directed",
                     exact_verify),
    "wcc": (JWCC, WCC, {}, False, "p2p-31-WCC", wcc_verify),
    "wcc_directed": (JWCC, WCC, {}, True, None, None),
    "cdlp": (JCDLP, CDLP, {"max_round": 10}, False, "p2p-31-CDLP",
             exact_verify),
    "lcc": (JLCCBeta, LCCBeta, {}, False, "p2p-31-LCC", eps_verify),
    "lcc_bitmap": (JLCC, LCC, {}, False, "p2p-31-LCC", eps_verify),
    "lcc_directed": (JLCCDirected, LCCDirected, {}, True, None, None),
}
_JAX_RUNS = {}
_PORT_FRAGS = {}


def jax_run(graph_cache, name, fnum, **kw):
    """(jax fragment, result_values, rounds), once per (name, fnum, kw)."""
    key = (name, fnum, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jcls, _, qkw, directed, _, _ = QUERIES[name]
        frag = graph_cache(fnum, directed=directed)
        w = JWorker(jcls(), frag)
        w.query(**qkw, **kw)
        _JAX_RUNS[key] = (frag, w.result_values(), w.rounds)
    return _JAX_RUNS[key]


def port_fragment(jfrag, how, fnum, directed):
    if how == "carried":
        arrays, meta = jax_arrays(jfrag)
        return fragment_from_numpy(arrays, meta, device="cpu")
    key = (fnum, directed)
    if key not in _PORT_FRAGS:
        _PORT_FRAGS[key] = LoadGraph(
            dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
            CommSpec(fnum=fnum, device="cpu"),
            LoadGraphSpec(directed=directed, weighted=True,
                          edata_dtype=np.float64),
        )
    return _PORT_FRAGS[key]


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(QUERIES))
def test_app_matches_jax_and_golden(graph_cache, name, fnum, how):
    jfrag, want, jrounds = jax_run(graph_cache, name, fnum)
    _, pcls, kw, directed, golden, verify = QUERIES[name]
    frag = port_fragment(jfrag, how, fnum, directed)
    w = Worker(pcls(), frag)
    w.query(**kw)
    got = w.result_values()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert w.rounds == jrounds
    np.testing.assert_array_equal(got, want)
    if golden is not None:
        verify(result_dict(frag, got, w.app.result_format),
               load_golden(dataset_path(golden)))


@pytest.mark.parametrize("name", ["lcc", "lcc_bitmap", "lcc_directed"])
def test_lcc_degree_threshold_matches_jax(graph_cache, name):
    """The hub cap (degree_threshold > 0; LCCBeta switches to the "hi"
    orientation) filters the same neighbour lists as the JAX apps."""
    jfrag, want, _ = jax_run(graph_cache, name, 2, degree_threshold=5)
    _, pcls, _, directed, _, _ = QUERIES[name]
    w = Worker(pcls(), port_fragment(jfrag, "carried", 2, directed))
    w.query(degree_threshold=5)
    np.testing.assert_array_equal(w.result_values(), want)
    assert (want != jax_run(graph_cache, name, 2)[1]).any()


def _placed(app, frag):
    return {k: torch.as_tensor(np.asarray(v))
            for k, v in app.init_state(frag).items()}


def test_triangle_counts_integer_identical(graph_cache):
    """Per-vertex triangle credits of the bitmap LCC and of LCCBeta equal
    the JAX package's TriangleCount (its LCC credit pass), and directed
    tricnt reproduces the JAX directed lcc values exactly."""
    jfrag = graph_cache(2)
    jw = JWorker(TriangleCount(), jfrag)
    jw.query()
    want = jw.result_values()
    frag = port_fragment(jfrag, "carried", 2, False)
    inner = frag.host_inner_mask()
    for app in (LCC(), LCCBeta()):
        tri = app.triangles(frag.dev, _placed(app, frag)).numpy()
        assert tri.dtype == np.int32
        np.testing.assert_array_equal(np.where(inner, tri, 0), want)
    assert int(want.sum()) % 3 == 0 and want.sum() > 0

    jfrag, lcc_d, _ = jax_run(graph_cache, "lcc_directed", 2)
    frag = port_fragment(jfrag, "carried", 2, True)
    tri, deg = LCCDirected().tricnt(frag.dev)
    tri, deg = tri.numpy().astype(np.int64), deg.numpy().astype(np.int64)
    np.testing.assert_array_equal(
        np.where(deg >= 2, tri, 0), np.rint(lcc_d * deg * (deg - 1)))


def test_registry_names_match_jax():
    from libgrape_lite_tpu.models import APP_REGISTRY as JREG

    for name, cls in APP_REGISTRY.items():
        assert cls.__name__ == JREG[name].__name__, name
    assert APP_REGISTRY["lcc"] is LCCBeta  # never the bitmap LCC


def test_every_port_module_imports_without_jax():
    """Importing every module of the port, the new apps and kernels
    included, loads neither jax, the JAX package nor triton."""
    code = (
        "import pkgutil, sys\n"
        "import libgrape_lite_tpu_torch as L\n"
        "names = [m.name for m in pkgutil.walk_packages(L.__path__,\n"
        "                                              L.__name__ + '.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'libgrape_lite_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "need = {'ops.intersect', 'utils.bitset', 'models.bfs', 'models.wcc',\n"
        "        'models.cdlp', 'models.lcc', 'models.lcc_beta',\n"
        "        'models.lcc_directed'}\n"
        "assert need <= {n.split('.', 1)[1] for n in names}, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and int(r.stdout.strip()) >= 20, r.stderr
