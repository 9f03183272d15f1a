"""PageRank and SSSP through the port's Worker, against the goldens and
against the JAX Worker on the same fragment.

* goldens (tests/verifiers.py rules): PageRank within 1e-4 relative,
  SSSP exact;
* the JAX Worker's `result_values()`, element for element in float64:
  PageRank within 1e-10 relative (the port's SpMV regroups float sums),
  SSSP bit-equal (min is exact in any order); equal round counts.

Fragments reach the port two ways: carried across from the JAX
fragment (`fragment_from_numpy`) and through the port's own loader.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import PageRank as JPageRank
from libgrape_lite_tpu.models import SSSP as JSSSP
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.edgecut import fragment_from_numpy
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import PageRank, SSSP
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker, format_result_lines
from tests.conftest import dataset_path
from tests.test_torch_substrate import jax_arrays
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
)

torch.set_num_threads(1)

QUERIES = {
    "pagerank": (JPageRank, {"delta": 0.85, "max_round": 10}, "p2p-31-PR"),
    "sssp": (JSSSP, {"source": 6}, "p2p-31-SSSP"),
}
_JAX_RUNS = {}


def jax_run(graph_cache, app, fnum):
    """(jax fragment, result_values, rounds), once per (app, fnum)."""
    key = (app, fnum)
    if key not in _JAX_RUNS:
        cls, kw, _ = QUERIES[app]
        frag = graph_cache(fnum)
        w = JWorker(cls(), frag)
        w.query(**kw)
        _JAX_RUNS[key] = (frag, w.result_values(), w.rounds)
    return _JAX_RUNS[key]


def port_app(app):
    if app == "pagerank":
        return PageRank(dtype=torch.float64)
    return SSSP(dtype=torch.float64)


def port_fragment(jfrag, how, fnum):
    if how == "carried":
        arrays, meta = jax_arrays(jfrag)
        return fragment_from_numpy(arrays, meta, device="cpu")
    return LoadGraph(
        dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
        CommSpec(fnum=fnum, device="cpu"),
        LoadGraphSpec(weighted=True, edata_dtype=np.float64),
    )


def result_dict(frag, values, fmt):
    return load_result_lines("".join(
        format_result_lines(frag.inner_oids(f),
                            values[f, :frag.inner_vertices_num(f)], fmt)
        for f in range(frag.fnum)))


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
@pytest.mark.parametrize("app", ["pagerank", "sssp"])
def test_app_matches_golden_and_jax(graph_cache, app, fnum, how):
    jfrag, want, jrounds = jax_run(graph_cache, app, fnum)
    frag = port_fragment(jfrag, how, fnum)
    _, kw, golden = QUERIES[app]
    w = Worker(port_app(app), frag)
    w.query(**kw)
    got = w.result_values()
    assert got.dtype == np.float64 and got.shape == want.shape
    assert w.rounds == jrounds
    res = result_dict(frag, got, w.app.result_format)
    if app == "pagerank":
        eps_verify(res, load_golden(dataset_path(golden)))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    else:
        exact_verify(res, load_golden(dataset_path(golden)))
        np.testing.assert_array_equal(got, want)


def test_pagerank_strict_plan_matches_jax(graph_cache):
    """spmv_mode='strict' routes the pull through the strict-tile plain
    version (the kernel on the card); same ranks, same rounds."""
    jfrag, want, jrounds = jax_run(graph_cache, "pagerank", 2)
    frag = port_fragment(jfrag, "carried", 2)
    w = Worker(PageRank(spmv_mode="strict", dtype=torch.float64), frag)
    w.query(delta=0.85, max_round=10)
    assert w.rounds == jrounds
    np.testing.assert_allclose(w.result_values(), want, rtol=1e-10, atol=0)


def test_sssp_from_jax_initial_state(graph_cache):
    """An initial state built by the JAX app (numpy) runs unchanged on
    the port: both packages start from byte-identical graphs and states."""
    jfrag, want, jrounds = jax_run(graph_cache, "sssp", 4)
    jstate = JSSSP().init_state(jfrag, source=6)
    frag = port_fragment(jfrag, "carried", 4)
    w = Worker(SSSP(dtype=torch.float64), frag)
    w.query(source=12345, initial_state={"dist": np.asarray(jstate["dist"])})
    assert w.rounds == jrounds
    np.testing.assert_array_equal(w.result_values(), want)
    with pytest.raises(KeyError):
        w.query(source=6, initial_state={"nope": np.zeros(3)})


def test_float32_states_hold_the_goldens(graph_cache):
    """The card's state type: float32 PageRank within 1e-4, SSSP exact
    (p2p-31's integer weights sum exactly in float32)."""
    jfrag, _, _ = jax_run(graph_cache, "pagerank", 1)
    frag = port_fragment(jfrag, "carried", 1)
    for app, cls in (("pagerank", PageRank), ("sssp", SSSP)):
        _, kw, golden = QUERIES[app]
        w = Worker(cls(), frag)
        w.query(**kw)
        values = w.result_values()
        assert values.dtype == np.float32
        res = result_dict(frag, values, w.app.result_format)
        verify = eps_verify if app == "pagerank" else exact_verify
        verify(res, load_golden(dataset_path(golden)))
