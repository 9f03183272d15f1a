"""The message-path variants of the port (`sssp_msg`, `bfs_msg`) and
`sssp_select` through the port's Worker, against the JAX Worker on the
same fragment and against the goldens; the helpers the other variant
files share.

* the JAX Worker's `result_values()`: bit-equal (float64 distances,
  int64 depths) with equal `rounds`, overflow `retries`, settled
  `final_capacity` and, where the app has them, `buckets`,
  `push_rounds` and `pull_rounds`;
* the goldens by tests/verifiers.py (p2p-31-SSSP, -BFS and their
  directed twins exact);
* forced overflow (`initial_capacity=8`), the learned capacity of a
  second query, directed graphs, and the `sssp_select` probe's pick.

Fragments reach the port carried across from the JAX fragment
(`fragment_from_numpy`) and through the port's own loader, at fnum 1, 2,
4 and 8.  One JAX run per (app class, fnum, query) is shared through a
module cache.  `sssp_opt` / `sssp_delta` and `bfs_opt` are in
tests/test_torch_variants_opt.py; the SyncBuffer apps, `wcc_opt`,
`cdlp_opt` and the PageRank aliases in tests/test_torch_variants_sync.py
(one file each keeps each JAX-heavy file near a minute on one core).
"""

import inspect

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment.edgecut import (
    ShardedEdgecutFragment as JFragment,
)
from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from libgrape_lite_tpu.models.sssp_select import (
    select_sssp_variant as jselect,
)
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.vertex_map.partitioner import (
    SegmentedPartitioner as JSegmented,
)
from libgrape_lite_tpu.vertex_map.vertex_map import VertexMap as JVertexMap
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.edgecut import fragment_from_numpy
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.models.sssp_select import select_sssp_variant
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_apps import result_dict
from tests.test_torch_substrate import jax_arrays
from tests.verifiers import eps_verify, exact_verify, load_golden, wcc_verify

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
COUNTERS = ("retries", "final_capacity", "buckets", "push_rounds",
            "pull_rounds")
# base app -> (query kwargs, golden, directed golden, rule)
BASES = {
    "sssp": ({"source": 6}, "p2p-31-SSSP", "p2p-31-SSSP-directed",
             exact_verify),
    "bfs": ({"source": 6}, "p2p-31-BFS", "p2p-31-BFS-directed",
            exact_verify),
    "wcc": ({}, "p2p-31-WCC", None, wcc_verify),
    "pagerank": ({"delta": 0.85, "max_round": 10}, "p2p-31-PR",
                 "p2p-31-PR-directed", eps_verify),
    "cdlp": ({"max_round": 10}, "p2p-31-CDLP", None, exact_verify),
}
_JAX_RUNS = {}
_PORT_FRAGS = {}


def base_of(name):
    return name.split("_")[0]


def jax_run(graph_cache, name, fnum, directed=False, **ctor):
    """(jax fragment, result_values, rounds, counters), once per (JAX
    class, fnum, directed, constructor arguments)."""
    jcls = JREGISTRY[name]
    key = (jcls, fnum, directed, tuple(sorted(ctor.items())))
    if key not in _JAX_RUNS:
        frag = graph_cache(fnum, directed=directed)
        app = jcls(**ctor)
        w = JWorker(app, frag)
        w.query(**BASES[base_of(name)][0])
        _JAX_RUNS[key] = (frag, w.result_values(), w.rounds,
                          {k: getattr(app, k) for k in COUNTERS
                           if hasattr(app, k)})
    return _JAX_RUNS[key]


def port_app(name, **ctor):
    """The port's registry class, with float64 distances and ranks (the
    JAX package's x64 state) where the class takes a dtype."""
    cls = APP_REGISTRY[name]
    if "dtype" in inspect.signature(cls).parameters:
        ctor.setdefault("dtype", torch.float64)
    return cls(**ctor)


def port_fragment(jfrag, how, fnum, directed=False):
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


def check_against_jax(graph_cache, name, fnum, how, directed=False,
                      rtol=0.0, **ctor):
    """Run `name` on the port and hold it against the JAX run and the
    golden; returns the port app."""
    jfrag, want, jrounds, jcounters = jax_run(graph_cache, name, fnum,
                                              directed, **ctor)
    frag = port_fragment(jfrag, how, fnum, directed)
    kw, golden, golden_dir, verify = BASES[base_of(name)]
    app = port_app(name, **ctor)
    w = Worker(app, frag)
    w.query(**kw)
    got = w.result_values()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert w.rounds == jrounds
    assert {k: getattr(app, k) for k in jcounters} == jcounters
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    golden = golden_dir if directed else golden
    if golden is not None:
        verify(result_dict(frag, got, app.result_format),
               load_golden(dataset_path(golden)))
    return app


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", ["sssp_msg", "bfs_msg", "sssp_select"])
def test_variant_matches_jax_and_golden(graph_cache, name, fnum, how):
    check_against_jax(graph_cache, name, fnum, how)


def test_forced_overflow_retries_like_jax(graph_cache):
    """A capacity of 8 overflows from the first rounds on.  The JAX app
    discards each overflowed round and reruns it with the capacity
    doubled; the port keeps the round and counts the same doublings, so
    retries and the settled capacity are equal."""
    app = check_against_jax(graph_cache, "sssp_msg", 2, "carried",
                            initial_capacity=8)
    assert app.retries > 0


@pytest.mark.parametrize("name", ["sssp_msg", "bfs_msg"])
def test_directed_variant_matches_jax(graph_cache, name):
    check_against_jax(graph_cache, name, 2, "carried", directed=True)


def test_learned_capacity_skips_the_retries(graph_cache):
    """A second query on the same fragment starts at the capacity the
    first settled at: no retries, the same result."""
    jfrag, want, _, jc = jax_run(graph_cache, "sssp_msg", 2)
    frag = port_fragment(jfrag, "carried", 2)
    app = port_app("sssp_msg")
    w = Worker(app, frag)
    w.query(source=6)
    assert app.retries == jc["retries"] > 0
    w.query(source=6)
    assert app.retries == 0
    assert app.final_capacity == jc["final_capacity"]
    np.testing.assert_array_equal(w.result_values(), want)


def _chain(n, weight, edata_dtype):
    """A path 0 - 1 - ... - n-1 (undirected), built by the JAX builder."""
    oids = np.arange(n, dtype=np.int64)
    vm = JVertexMap.build(oids, JSegmented(1, oids))
    return JFragment.build(
        JCommSpec(fnum=1), vm, oids[:-1], oids[1:],
        np.full(n - 1, weight, dtype=edata_dtype), directed=False,
        edata_dtype=edata_dtype)


def _carry(jfrag):
    arrays, meta = jax_arrays(jfrag)
    return fragment_from_numpy(arrays, meta, device="cpu")


@pytest.mark.parametrize("cap", [None, "4"])
def test_select_picks_what_jax_picks(graph_cache, monkeypatch, cap):
    """p2p-31 converges inside any cap of at least its depth; a chain
    longer than the cap keeps a live frontier: sssp_delta."""
    if cap is not None:
        monkeypatch.setenv("GRAPE_SSSP_PROBE_CAP", cap)
    jfrag = graph_cache(2)
    chain = _chain(100, 1.0, np.float64)
    for jf, source in ((jfrag, 6), (chain, 0), (chain, 12345)):
        got = select_sssp_variant(_carry(jf), source)
        assert got == jselect(jf, source)
    assert select_sssp_variant(_carry(chain), 0)[0] == "sssp_delta"
    assert select_sssp_variant(_carry(jfrag), 6)[0] == (
        "sssp" if cap is None else "sssp_delta")
