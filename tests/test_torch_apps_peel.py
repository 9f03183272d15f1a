"""The port's peeling, path-counting, local-rank and hop apps through its
Worker, against the JAX Worker on the same fragment.

Apps: `kcore` (k = 2, 4 and 6), `core_decomposition`, `pagerank_local`,
`bc` with its aliases `staged_bc` and `staged_bc_bfs`, `khop` (k = 1, 2
and 3) and `common_neighbors`, each over the gather-reduce kernel's plain
version on the CPU (int32 sums for the peeling counts and the 2-hop
pulls, float sums for `bc` and `pagerank_local`, int32 min for `khop`):

* integers (memberships, core numbers, hop distances, common-neighbour
  counts) and `bc`'s path counts `pn` bit-equal to the JAX package's;
* `bc`'s dependencies and `pagerank_local`'s ranks, in float64, within
  1e-10 relative (the rule of tests/test_torch_apps.py: sums regroup);
* equal round counts.

Inputs: `dataset/p2p-31.*`, carried across from the JAX fragment
(`fragment_from_numpy`) and through the port's own loader, at fnum 1, 2,
4 and 8 (and directed at fnum 2); and the small seeded graphs of tests/test_kcore_coredecomp.py
and tests/test_bc.py, against the JAX apps and those files' numpy
references.  One JAX run per (app, arguments, fnum) is shared through a
module cache.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.edgecut import fragment_from_numpy
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_bc import numpy_brandes_single_source
from tests.test_kcore_coredecomp import numpy_core_numbers, small_graph
from tests.test_torch_substrate import jax_arrays
from tests.test_worker import build_fragment

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
RTOL = 1e-10  # float64 sums in another order
# case -> (registry name, constructor arguments, query arguments)
CASES = {
    "kcore_2": ("kcore", {}, {"k": 2}),
    "kcore_4": ("kcore", {}, {"k": 4}),
    "kcore_6": ("kcore", {}, {"k": 6}),
    "core_decomposition": ("core_decomposition", {}, {}),
    "pagerank_local": ("pagerank_local", {},
                       {"delta": 0.85, "max_round": 10}),
    "bc": ("bc", {}, {"source": 6}),
    "staged_bc": ("staged_bc", {}, {}),
    "staged_bc_bfs": ("staged_bc_bfs", {}, {}),
    "khop_1": ("khop", {"k": 1}, {"source": 6}),
    "khop_2": ("khop", {"k": 2}, {"source": 6}),
    "khop_3": ("khop", {"k": 3}, {"source": 6}),
    "common_neighbors": ("common_neighbors", {}, {"source": 6}),
}
_JAX_RUNS = {}
_PORT_FRAGS = {}


def port_app(name, **ctor):
    """The port's class, with float64 state where it takes a dtype (the
    JAX package's x64 state)."""
    if name in ("bc", "staged_bc", "staged_bc_bfs", "pagerank_local",
                "pagerank_local_parallel"):
        ctor.setdefault("dtype", torch.float64)
    return APP_REGISTRY[name](**ctor)


def jax_query(jfrag, name, ctor, kw):
    w = JWorker(JREGISTRY[name](**ctor), jfrag)
    w.query(**kw)
    return w


def jax_run(graph_cache, case, fnum):
    """(jax fragment, result_values, rounds, pn or None), once per case
    and fnum."""
    if (case, fnum) not in _JAX_RUNS:
        name, ctor, kw = CASES[case]
        frag = graph_cache(fnum)
        w = jax_query(frag, name, ctor, kw)
        pn = w._result_state.get("pn")
        _JAX_RUNS[case, fnum] = (frag, w.result_values(), w.rounds,
                                 None if pn is None else np.asarray(pn))
    return _JAX_RUNS[case, fnum]


def port_fragment(jfrag, how, fnum):
    if how == "carried":
        arrays, meta = jax_arrays(jfrag)
        return fragment_from_numpy(arrays, meta, device="cpu")
    if fnum not in _PORT_FRAGS:
        _PORT_FRAGS[fnum] = LoadGraph(
            dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
            CommSpec(fnum=fnum, device="cpu"),
            LoadGraphSpec(directed=False, weighted=True,
                          edata_dtype=np.float64),
        )
    return _PORT_FRAGS[fnum]


def assert_same(w, want, rounds, pn=None):
    got = w.result_values()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert w.rounds == rounds
    if got.dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    if pn is not None:
        np.testing.assert_array_equal(w._result_state["pn"].numpy(), pn)


def inner_values(w):
    """Inner vertices' values, fragment after fragment (vertex order
    for the map partitioner of tests/test_worker.py)."""
    vals = w.result_values()
    return np.concatenate([vals[f, :w.fragment.inner_vertices_num(f)]
                           for f in range(w.fragment.fnum)])


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("case", list(CASES))
def test_app_matches_jax(graph_cache, case, fnum, how):
    jfrag, want, rounds, pn = jax_run(graph_cache, case, fnum)
    name, ctor, kw = CASES[case]
    w = Worker(port_app(name, **ctor), port_fragment(jfrag, how, fnum))
    w.query(**kw)
    assert_same(w, want, rounds, pn)


@pytest.mark.parametrize("case", ["kcore_4", "core_decomposition",
                                  "pagerank_local", "bc", "khop_2",
                                  "common_neighbors"])
def test_directed_app_matches_jax(graph_cache, case):
    """p2p-31 loaded directed (in-edges differ from out-edges), fnum 2."""
    name, ctor, kw = CASES[case]
    jfrag = graph_cache(2, directed=True)
    jw = jax_query(jfrag, name, ctor, kw)
    w = Worker(port_app(name, **ctor), port_fragment(jfrag, "carried", 2))
    w.query(**kw)
    pn = jw._result_state.get("pn")
    assert_same(w, jw.result_values(), jw.rounds,
                None if pn is None else np.asarray(pn))


def test_peeling_apps_agree():
    """kcore(k) is core_decomposition's core >= k; khop(k) is BFS's depth
    masked to <= k; common_neighbors is the square of the deduplicated
    adjacency -- the cross-checks chip_smoke.py makes on the card."""
    frag = LoadGraph(dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
                     CommSpec(fnum=2, device="cpu"), LoadGraphSpec())
    w = Worker(port_app("core_decomposition"), frag)
    w.query()
    core = w.result_values()
    for k in (2, 4, 6):
        w = Worker(port_app("kcore"), frag)
        w.query(k=k)
        np.testing.assert_array_equal(w.result_values(),
                                      (core >= k).astype(np.int64))
    w = Worker(port_app("bfs"), frag)
    w.query(source=6)
    depth = w.result_values()
    for k in (1, 2, 3):
        w = Worker(port_app("khop", k=k), frag)
        w.query(source=6)
        np.testing.assert_array_equal(w.result_values(),
                                      np.where(depth <= k, depth, -1))
    w = Worker(port_app("common_neighbors"), frag)
    w.query(source=6)
    pairs = np.unique(np.concatenate([
        np.stack([f * frag.vp + c.edge_src[:c.num_edges],
                  c.edge_nbr[:c.num_edges]], 1)
        for f, c in enumerate(frag.host_oe)]), axis=0)
    src = int(frag.oid_to_pid(np.array([6]))[0])
    near = pairs[pairs[:, 0] == src, 1]
    cn = np.bincount(pairs[np.isin(pairs[:, 0], near), 1],
                     minlength=frag.fnum * frag.vp)
    cn[src] = 0
    np.testing.assert_array_equal(w.result_values().reshape(-1), cn)


@pytest.mark.parametrize("fnum", FNUMS)
def test_small_graph_peeling_matches_jax_and_numpy(small_graph, fnum):
    """The seeded graph of tests/test_kcore_coredecomp.py (300 vertices,
    1,500 random edges with repeats and self loops)."""
    n, src, dst = small_graph
    jfrag = build_fragment(src, dst, None, n, fnum)
    frag = port_fragment(jfrag, "carried", fnum)
    core = numpy_core_numbers(n, src, dst)
    for name, ctor, kw in (("core_decomposition", {}, {}),
                           ("kcore", {}, {"k": 2}), ("kcore", {}, {"k": 4}),
                           ("kcore", {}, {"k": 6}),
                           ("pagerank_local", {},
                            {"delta": 0.85, "max_round": 10})):
        jw = jax_query(jfrag, name, ctor, kw)
        w = Worker(port_app(name, **ctor), frag)
        w.query(**kw)
        assert_same(w, jw.result_values(), jw.rounds)
        got = inner_values(w)
        if name == "core_decomposition":
            np.testing.assert_array_equal(got, core)
        elif name == "kcore":
            np.testing.assert_array_equal(got, core >= kw["k"])


@pytest.mark.parametrize("fnum", FNUMS)
def test_small_graph_bc_matches_jax_and_brandes(fnum):
    """The seeded graph of tests/test_bc.py (200 vertices, 800 random
    edges), from vertex 0, against the JAX app and that file's Brandes."""
    rng = np.random.default_rng(3)
    n, e = 200, 800
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    jfrag = build_fragment(src, dst, None, n, fnum)
    jw = jax_query(jfrag, "bc", {}, {"source": 0})
    w = Worker(port_app("bc"), port_fragment(jfrag, "carried", fnum))
    w.query(source=0)
    assert_same(w, jw.result_values(), jw.rounds,
                np.asarray(jw._result_state["pn"]))
    adj = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    want, _, _ = numpy_brandes_single_source(n, adj, 0)
    np.testing.assert_allclose(inner_values(w), want, rtol=1e-9, atol=1e-12)


def test_registry_and_query_arguments_match_jax():
    """The eleven names bind the JAX registry's classes, and run_app's
    query arguments are the JAX runner's (bc takes --bc_source, staged_bc*
    none; khop its source from --bfs_source)."""
    from libgrape_lite_tpu.runner import QueryArgs as JArgs
    from libgrape_lite_tpu.runner import build_query_kwargs as jkwargs
    from libgrape_lite_tpu_torch.runner import QueryArgs, build_query_kwargs

    names = ("bc", "staged_bc", "staged_bc_bfs", "kcore", "kclique",
             "core_decomposition", "pagerank_local",
             "pagerank_local_parallel", "triangle_count",
             "common_neighbors", "khop")
    flags = dict(bc_source=3, kcore_k=4, kclique_k=5, khop_k=3, cn_source=7,
                 bfs_source=6, degree_threshold=2)
    for name in names:
        assert APP_REGISTRY[name].__name__ == JREGISTRY[name].__name__
        assert (build_query_kwargs(name, QueryArgs(**flags))
                == jkwargs(name, JArgs(**flags))), name
    # the vertex-cut names complete the registry (fragment/vertexcut.py)
    assert len(APP_REGISTRY) == 47
    assert set(JREGISTRY) == set(APP_REGISTRY)
    with pytest.raises(ValueError, match="k >= 1"):
        APP_REGISTRY["khop"](k=0)


def test_common_neighbors_refuses_a_source_list(graph_cache):
    """A query takes one source; a list of sources is a batch of lanes
    (Worker.query_batch, tests/test_torch_lanes.py)."""
    frag = port_fragment(graph_cache(1), "carried", 1)
    with pytest.raises(ValueError, match="Worker.query_batch"):
        Worker(port_app("common_neighbors"), frag).query(source=[6, 7])
