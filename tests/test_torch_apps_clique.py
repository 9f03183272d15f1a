"""The port's triangle and clique apps through its Worker, against the
JAX Worker on the same fragment.

* `triangle_count`: per-vertex counts (the bitmap LCC's credits, through
  the AND-popcount kernel's plain version) and `global_triangles` equal;
* `ApexTriangleCount` (LCCBeta's merge pass in apex mode): per-apex
  counts equal;
* `kclique` at k = 2, 3, 4 and 5 on tests/test_kclique.py's seeded
  graphs: per-apex counts, `total_cliques` and `used_device_kernel` equal
  to the JAX app's, totals to that file's brute force; on p2p-31 in
  tests/test_torch_apps_kclique.py (one file each keeps each near a
  minute on one core);
* the host recursion where a cap sends it there (a dense core past
  `hub_cap`, as tests/test_kclique.py sets it up), the device apps
  against it per apex, and the brute-force counts of tests/test_kclique.py
  on its seeded graphs.

Inputs: `dataset/p2p-31.*`, carried across from the JAX fragment and
through the port's own loader, at fnum 1, 2, 4 and 8, and the seeded
graphs of tests/test_kclique.py.  One JAX run per (app, fnum) is shared
through a module cache.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from libgrape_lite_tpu.models.kclique_device import (
    KCliqueDevice as JKCliqueDevice,
)
from libgrape_lite_tpu.models.lcc_beta import (
    ApexTriangleCount as JApexTriangleCount,
)
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.edgecut import fragment_from_numpy
from libgrape_lite_tpu_torch.models import APP_REGISTRY, KClique
from libgrape_lite_tpu_torch.models.kclique_device import (
    KClique4Device,
    KCliqueDevice,
)
from libgrape_lite_tpu_torch.models.lcc_beta import ApexTriangleCount
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.test_kclique import brute_force_kcliques
from tests.test_torch_apps_peel import port_fragment
from tests.test_torch_substrate import jax_arrays
from tests.test_worker import build_fragment

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
_JAX_RUNS = {}


def jax_run(graph_cache, key, fnum, make, **kw):
    """(jax fragment, app, result_values), once per (key, fnum)."""
    if (key, fnum) not in _JAX_RUNS:
        frag = graph_cache(fnum)
        w = JWorker(make(), frag)
        w.query(**kw)
        _JAX_RUNS[key, fnum] = (frag, w.app, w.result_values())
    return _JAX_RUNS[key, fnum]


def carry(jfrag):
    arrays, meta = jax_arrays(jfrag)
    return fragment_from_numpy(arrays, meta, device="cpu")


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", FNUMS)
def test_triangle_count_matches_jax(graph_cache, fnum, how):
    jfrag, japp, want = jax_run(graph_cache, "triangle_count", fnum,
                                JREGISTRY["triangle_count"])
    w = Worker(APP_REGISTRY["triangle_count"](),
               port_fragment(jfrag, how, fnum))
    w.query()
    got = w.result_values()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert w.app.global_triangles == japp.global_triangles > 0


@pytest.mark.parametrize("fnum", FNUMS)
def test_apex_triangle_count_matches_jax(graph_cache, fnum):
    jfrag, _, want = jax_run(graph_cache, "apex", fnum, JApexTriangleCount)
    w = Worker(ApexTriangleCount(), carry(jfrag))
    w.query()
    np.testing.assert_array_equal(w.result_values(), want)
    # each triangle once, at its apex: a third of the LCC credits
    tri = jax_run(graph_cache, "triangle_count", fnum,
                  JREGISTRY["triangle_count"])[2]
    assert 3 * int(want.sum()) == int(tri.sum())


def _random_graph(seed, n, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("fnum", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_kclique_small_graph_matches_jax_and_brute_force(k, fnum):
    """tests/test_kclique.py's dense seeded graph (24 vertices, 120
    edges)."""
    src, dst = _random_graph(5, 24, 120)
    jfrag = build_fragment(src, dst, None, 24, fnum)
    japp = JREGISTRY["kclique"]()
    jw = JWorker(japp, jfrag)
    jw.query(k=k)
    app = KClique()
    w = Worker(app, carry(jfrag))
    w.query(k=k)
    np.testing.assert_array_equal(w.result_values(), jw.result_values())
    assert app.total_cliques == japp.total_cliques == brute_force_kcliques(
        24, src, dst, k)
    assert app.used_device_kernel == japp.used_device_kernel


@pytest.mark.parametrize("fnum", [1, 4])
def test_k4_device_matches_host_recursion(fnum):
    """tests/test_kclique.py's k = 4 graph (48 vertices, 320 edges): the
    device app and the host recursion agree per apex."""
    src, dst = _random_graph(11, 48, 320)
    frag = carry(build_fragment(src, dst, None, 48, fnum))
    dev_app, host_app = KClique(), KClique()
    host_app.hub_cap = 0  # force the host recursion
    w1, w2 = Worker(dev_app, frag), Worker(host_app, frag)
    w1.query(k=4)
    w2.query(k=4)
    assert dev_app.used_device_kernel and not host_app.used_device_kernel
    np.testing.assert_array_equal(w1.result_values(), w2.result_values())
    assert dev_app.total_cliques == brute_force_kcliques(48, src, dst, 4)


def test_k4_hub_cap_falls_back_to_host():
    """A 24-clique's oriented out-degree (23) exceeds a hub_cap of 8: the
    host recursion counts it, as the JAX app does
    (tests/test_kclique.py:73-92)."""
    m = 24
    edges = [(a, b) for a in range(m) for b in range(a + 1, m)]
    src = np.array([a for a, _ in edges])
    dst = np.array([b for _, b in edges])
    jfrag = build_fragment(src, dst, None, m, 2)
    japp = JREGISTRY["kclique"]()
    japp.hub_cap = 8
    jw = JWorker(japp, jfrag)
    jw.query(k=4)
    app = KClique()
    app.hub_cap = 8
    w = Worker(app, carry(jfrag))
    w.query(k=4)
    assert not app.used_device_kernel and not japp.used_device_kernel
    assert app.total_cliques == japp.total_cliques == brute_force_kcliques(
        m, src, dst, 4)
    np.testing.assert_array_equal(w.result_values(), jw.result_values())


@pytest.mark.parametrize("k", [5, 6])
@pytest.mark.parametrize("fnum", [1, 4])
def test_general_k_device_matches_jax_and_host(k, fnum):
    """tests/test_kclique.py's general-k graph (26 vertices, 150 edges):
    KCliqueDevice against the JAX KCliqueDevice and the host recursion,
    per apex."""
    src, dst = _random_graph(7, 26, 150)
    jfrag = build_fragment(src, dst, None, 26, fnum)
    jw = JWorker(JKCliqueDevice(k), jfrag)
    jw.query()
    frag = carry(jfrag)
    w = Worker(KCliqueDevice(k), frag)
    w.query()
    np.testing.assert_array_equal(w.result_values(), jw.result_values())
    host = KClique()
    host.hub_cap = 0
    host._GENERAL_WORK_BUDGET = 0  # force the host recursion
    wh = Worker(host, frag)
    wh.query(k=k)
    assert not host.used_device_kernel
    np.testing.assert_array_equal(w.result_values(), wh.result_values())
    assert host.total_cliques == brute_force_kcliques(26, src, dst, k)


def test_k4_apps_agree():
    """KCliqueDevice(4) equals KClique4Device per apex (tests/test_kclique.py
    holds the JAX package's two forms to the same)."""
    src, dst = _random_graph(13, 40, 260)
    frag = carry(build_fragment(src, dst, None, 40, 2))
    w1, w2 = Worker(KCliqueDevice(4), frag), Worker(KClique4Device(), frag)
    w1.query()
    w2.query()
    np.testing.assert_array_equal(w1.result_values(), w2.result_values())
    assert w1.result_values().sum() == brute_force_kcliques(40, src, dst, 4)
    with pytest.raises(ValueError, match="k >= 4"):
        KCliqueDevice(3)
