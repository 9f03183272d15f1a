"""Batched source lanes in the port, on the CPU.

* `gather_reduce_lanes_plain` (the plain version of K1 with a lane axis)
  is `gather_reduce_plain` on each lane, bit for bit, in every kind --
  float sum, min and max with and without weights, int32 sum, min and
  max -- over stacked CSRs with empty rows, an edgeless fragment and pad
  edges past each fragment's `indptr[vp]`, at fnum 1, 2, 4 and 8 and k
  1, 3 and 8; the wrapper takes it only for CPU tensors, `pull` picks
  the lane form by the rank of x and splits a batch wider than one
  kernel call takes;
* `Worker.query_batch` against the JAX package's `Worker.query_batch`
  on p2p-31 for sssp, bfs, khop, common_neighbors, personalized
  pagerank and wcc (no native lanes: per-lane states), with the ragged
  sources of tests/test_serve.py at fnum 1, 2, 4 and 8: values
  bit-equal (float64 PageRank within 1e-10), `batch_rounds` equal, and
  every lane byte-equal to the port's own sequential query;
* a batch over staged overlay edges equals the sequential overlay
  queries; a launched batch (its own thread) equals the inline one;
* mixed personalized and global PageRank lanes raise; host-only and
  MutationContext apps are refused; each registry name's lane key is
  the JAX class's.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JAPPS
from libgrape_lite_tpu.models import KHopNeighborhood as JKHop
from libgrape_lite_tpu.models import PageRank as JPageRank
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import (
    APP_REGISTRY,
    SSSP,
    KHopNeighborhood,
    PageRank,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_dyn import ADDS
from tests.test_torch_dyn import build_graph

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
SOURCES = [6, 5229, 8200, 999999]  # ragged; the last id is absent
VP = 64


# ---- the plain version of K1 with a lane axis ----------------------------

def stacked_csr(fnum: int, seed: int, weighted: bool):
    """[fnum] stacked CSR of VP rows: rows past 48 empty, fragment 1 (when
    fnum > 1) without edges, and pad edges past each indptr[vp] that
    point at real columns (the kernel must never read them)."""
    rng = np.random.default_rng(seed)
    counts = [0 if f == 1 else int(rng.integers(50, 300))
              for f in range(fnum)]
    ep = max(counts) + 17
    indptr = np.zeros((fnum, VP + 1), np.int32)
    nbr = np.zeros((fnum, ep), np.int32)
    w = np.zeros((fnum, ep), np.float32)
    for f, e in enumerate(counts):
        rows = np.sort(rng.integers(0, 48, e))
        np.cumsum(np.bincount(rows, minlength=VP), out=indptr[f, 1:])
        nbr[f] = rng.integers(0, fnum * VP, ep)
        w[f] = rng.uniform(0.1, 5.0, ep)
    return (torch.from_numpy(indptr), torch.from_numpy(nbr),
            torch.from_numpy(w) if weighted else None)


def lane_x(k: int, n: int, seed: int, int32: bool):
    rng = np.random.default_rng(seed)
    if int32:
        x = rng.integers(0, 1000, (k, n)).astype(np.int32)
        x[rng.random((k, n)) < 0.2] = np.iinfo(np.int32).max
    else:
        x = rng.normal(size=(k, n)).astype(np.float32)
        x[rng.random((k, n)) < 0.2] = np.inf
    return torch.from_numpy(x)


KINDS = [("sum", False, False), ("sum", True, False), ("min", False, False),
         ("min", True, False), ("max", False, False), ("max", True, False),
         ("sum", False, True), ("min", False, True), ("max", False, True)]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("kind,weighted,int32", KINDS)
def test_lanes_plain_is_the_plain_version_per_lane(kind, weighted, int32,
                                                   fnum, k):
    indptr, nbr, w = stacked_csr(fnum, seed=fnum * 7 + k, weighted=weighted)
    x = lane_x(k, fnum * VP, seed=k, int32=int32)
    if kind == "sum" and not int32:
        x = torch.where(torch.isinf(x), torch.zeros(()), x)
    got = spmv.gather_reduce_lanes_plain(indptr, nbr, w, x, kind)
    assert got.shape == (k, fnum, VP) and got.dtype == x.dtype
    for b in range(k):
        want = spmv.gather_reduce_plain(indptr, nbr, w, x[b], kind)
        assert got[b].numpy().tobytes() == want.numpy().tobytes()
    if fnum > 1:  # the edgeless fragment holds the kind's identity
        ident = {"sum": 0, "min": np.inf, "max": -np.inf}[kind]
        if int32:
            ident = {"sum": 0, "min": np.iinfo(np.int32).max,
                     "max": np.iinfo(np.int32).min}[kind]
        assert (got[:, 1].numpy() == ident).all()
    # the wrapper takes the plain version for CPU tensors, counting no
    # launch, and `pull` picks the lane form by the rank of x
    before = spmv.gather_reduce_lanes.launches
    assert torch.equal(spmv.gather_reduce_lanes(indptr, nbr, w, x, kind), got)
    assert torch.equal(spmv.pull(indptr, nbr, w, x, kind), got)
    assert torch.equal(spmv.pull(indptr, nbr, w, x[0], kind), got[0])
    assert spmv.gather_reduce_lanes.launches == before


def test_lanes_wrapper_refuses_what_the_kernel_does_not_take():
    indptr, nbr, w = stacked_csr(2, seed=1, weighted=True)
    x = lane_x(2, 2 * VP, seed=1, int32=False)
    with pytest.raises(ValueError, match=r"x must be \[k, N\]"):
        spmv.gather_reduce_lanes(indptr, nbr, w, x[0], "min")
    with pytest.raises(ValueError, match="unknown kind"):
        spmv.gather_reduce_lanes(indptr, nbr, w, x, "prod")
    with pytest.raises(ValueError, match="int32 x takes no weights"):
        spmv.gather_reduce_lanes(indptr, nbr, w, x.to(torch.int32), "min")
    meta = [t.to("meta") for t in (indptr, nbr, w, x)]
    with pytest.raises(ValueError, match="unsupported device"):
        spmv.gather_reduce_lanes(*meta, "min")


def counting_lanes(monkeypatch):
    """Stand `gather_reduce_lanes` in with its plain version, holding
    each call to what the kernel takes; returns the lanes of each call."""
    calls = []

    def stub(indptr, nbr, w, x, kind="sum"):
        fnum, vp = indptr.shape[0], indptr.shape[1] - 1
        assert 1 <= x.shape[0] <= spmv.lane_chunk(fnum, vp) <= spmv.MAX_LANES
        calls.append(x.shape[0])
        return spmv.gather_reduce_lanes_plain(indptr, nbr, w, x, kind)

    monkeypatch.setattr(spmv, "gather_reduce_lanes", stub)
    return calls


@pytest.mark.parametrize("lanes,int32_limit,chunks", [
    (100, None, [64, 36]),               # MAX_LANES a call
    (10, 3 * 2 * VP + 1, [3, 3, 3, 1]),  # carry keys lane * fnum * vp + pid
])
def test_pull_splits_lanes_within_the_kernel_limits(monkeypatch, lanes,
                                                    int32_limit, chunks):
    indptr, nbr, w = stacked_csr(2, seed=3, weighted=True)
    x = lane_x(lanes, 2 * VP, seed=4, int32=False)
    want = spmv.gather_reduce_lanes_plain(indptr, nbr, w, x, "min")
    if int32_limit is not None:
        monkeypatch.setattr(spmv, "INT32_LIMIT", int32_limit)
    calls = counting_lanes(monkeypatch)
    got = spmv.pull(indptr, nbr, w, x, "min")
    assert calls == chunks
    assert got.numpy().tobytes() == want.numpy().tobytes()


# ---- Worker.query_batch against the JAX package ---------------------------

_PORT_FRAGS = {}
_JAX_BATCHES = {}


def port_fragment(fnum):
    if fnum not in _PORT_FRAGS:
        _PORT_FRAGS[fnum] = LoadGraph(
            dataset_path("p2p-31.e"), dataset_path("p2p-31.v"),
            CommSpec(fnum=fnum, device="cpu"),
            LoadGraphSpec(weighted=True, edata_dtype=np.float64))
    return _PORT_FRAGS[fnum]


def port_app(name):
    if name == "sssp":
        return SSSP(dtype=torch.float64)
    if name == "pagerank":
        return PageRank(dtype=torch.float64)
    return APP_REGISTRY[name]()


def jax_app(name):
    if name == "pagerank":
        return JPageRank(max_round=10)
    if name == "khop":
        return JKHop()
    return JAPPS[name]()


def lanes_of(name):
    if name == "wcc":  # no lane argument: identical queries
        return [{} for _ in SOURCES]
    extra = {"max_round": 10} if name == "pagerank" else {}
    return [dict(extra, source=s) for s in SOURCES]


def jax_batch(graph_cache, name, fnum):
    if (name, fnum) not in _JAX_BATCHES:
        w = JWorker(jax_app(name), graph_cache(fnum))
        w.query_batch(lanes_of(name))
        _JAX_BATCHES[name, fnum] = (
            [w.batch_result_values(b) for b in range(len(SOURCES))],
            [int(r) for r in w.batch_rounds])
    return _JAX_BATCHES[name, fnum]


@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", ["sssp", "bfs", "khop", "common_neighbors",
                                  "pagerank", "wcc"])
def test_query_batch_matches_jax_and_sequential(graph_cache, name, fnum):
    want, want_rounds = jax_batch(graph_cache, name, fnum)
    frag = port_fragment(fnum)
    lanes = lanes_of(name)
    w = Worker(port_app(name), frag)
    w.query_batch(lanes)
    assert [int(r) for r in w.batch_rounds] == want_rounds
    if name in ("sssp", "bfs"):  # ragged: the absent source settles first
        assert len(set(want_rounds)) >= 3 and want_rounds[-1] == 1
    assert list(w.batch_terminate) == [0] * len(lanes)
    for b, args in enumerate(lanes):
        got = w.batch_result_values(b)
        assert got.dtype == want[b].dtype and got.shape == want[b].shape
        if name == "pagerank":
            np.testing.assert_allclose(got, want[b], rtol=1e-10, atol=0)
        else:
            np.testing.assert_array_equal(got, want[b])
        seq = Worker(port_app(name), frag)
        seq.query(**args)
        assert seq.rounds == want_rounds[b]
        assert got.tobytes() == seq.result_values().tobytes(), (
            f"{name} lane {b} differs from its sequential query")


def test_ppr_lanes_keep_their_seed_mass():
    frag = port_fragment(2)
    w = Worker(PageRank(dtype=torch.float64), frag)
    w.query_batch([{"source": 6, "max_round": 10},
                   {"source": 999999, "max_round": 10}])
    assert float(w.batch_result_values(0).sum()) == pytest.approx(1.0,
                                                                  rel=1e-6)
    assert float(w.batch_result_values(1).sum()) == 0.0


def test_query_batch_wider_than_one_kernel_call(monkeypatch):
    """72 lanes pull in chunks of at most MAX_LANES a round, each lane
    still byte-equal to its sequential query."""
    frag = port_fragment(1)
    lanes = [{"source": s} for s in SOURCES * 18]
    calls = counting_lanes(monkeypatch)
    w = Worker(port_app("sssp"), frag)
    w.query_batch(lanes)
    assert calls and calls == [64, 8] * (len(calls) // 2)
    for s in SOURCES:
        seq = Worker(port_app("sssp"), frag)
        seq.query(source=s)
        for b in range(SOURCES.index(s), len(lanes), len(SOURCES)):
            assert int(w.batch_rounds[b]) == seq.rounds
            assert (w.batch_result_values(b).tobytes()
                    == seq.result_values().tobytes())


def test_global_pagerank_lanes_run_per_lane():
    """All-global lanes are per-lane states (the lane path would
    personalize them), each byte-equal to the global query."""
    frag = port_fragment(2)
    w = Worker(PageRank(dtype=torch.float64), frag)
    state = w.query_batch([{"max_round": 5}, {"max_round": 5}])
    assert isinstance(state, list) and len(state) == 2
    seq = Worker(PageRank(dtype=torch.float64), frag)
    seq.query(max_round=5)
    for b in range(2):
        assert (w.batch_result_values(b).tobytes()
                == seq.result_values().tobytes())


@pytest.mark.parametrize("name", ["sssp_auto", "bfs_auto"])
def test_auto_apps_batch_their_sources_per_lane(name):
    frag = port_fragment(2)
    w = Worker(APP_REGISTRY[name](), frag)
    assert isinstance(w.query_batch([{"source": 6}, {"source": 17}]), list)
    for b, s in enumerate([6, 17]):
        seq = Worker(APP_REGISTRY[name](), frag)
        seq.query(source=s)
        assert (w.batch_result_values(b).tobytes()
                == seq.result_values().tobytes())
        assert int(w.batch_rounds[b]) == seq.rounds


def test_lane_keys_match_jax_registry():
    """Each name coalesces on the JAX class's per-lane argument."""
    for name, cls in APP_REGISTRY.items():
        assert cls.batch_query_key == JAPPS[name].batch_query_key, name
    native = {n for n, c in APP_REGISTRY.items() if c.lane_native}
    # the vertex cut's sssp_vc and bfs_vc pull their lanes together too
    assert native == {"sssp", "sssp_select", "bfs", "khop", "pagerank",
                      "pagerank_parallel", "pagerank_opt",
                      "pagerank_directed", "common_neighbors", "sssp_vc",
                      "bfs_vc"}


# ---- overlay, threads, refusals -------------------------------------------

@pytest.mark.parametrize("name", ["sssp", "bfs", "khop"])
def test_batch_over_staged_overlay_equals_sequential(name):
    dg = DynGraph(build_graph(2), RepackPolicy(threshold=0.9, capacity=64))
    assert dg.ingest(ADDS)["mode"] == "overlay"

    def app():
        return (SSSP(dtype=torch.float64) if name == "sssp"
                else KHopNeighborhood(2) if name == "khop"
                else APP_REGISTRY[name]())

    sources = [0, 5, 9, 13]
    w = Worker(app(), dg.fragment)
    w.query_batch([{"source": s} for s in sources])
    for b, s in enumerate(sources):
        seq = Worker(app(), dg.fragment)
        seq.query(source=s)
        assert int(w.batch_rounds[b]) == seq.rounds
        assert (w.batch_result_values(b).tobytes()
                == seq.result_values().tobytes())


def test_launched_batch_equals_inline_batch():
    frag = port_fragment(2)
    lanes = [{"source": s} for s in SOURCES]
    w = Worker(APP_REGISTRY["bfs"](), frag)
    w.query_batch(lanes)
    d = w.query_batch_dispatch(lanes)
    d.wait()
    assert d.is_ready()
    assert list(d.rounds) == list(w.batch_rounds)
    for b in range(len(lanes)):
        assert d.lane_values(b).tobytes() == w.batch_result_values(b).tobytes()


def test_failure_in_a_launched_batch_is_raised_by_wait(monkeypatch):
    frag = port_fragment(1)
    w = Worker(APP_REGISTRY["bfs"](), frag)
    prepared = w.query_batch_prepare([{"source": 6}, {"source": 17}])

    def boom(ctx, dev, state):
        raise RuntimeError("synthetic round failure")

    monkeypatch.setattr(prepared.app, "inceval", boom)
    d = prepared.launch()
    with pytest.raises(RuntimeError, match="synthetic round failure"):
        d.wait()
    # the worker's own app was never touched: it still serves
    w.query_batch([{"source": 6}])
    assert w.batch_rounds[0] > 0


def test_mixed_ppr_lanes_raise():
    w = Worker(PageRank(dtype=torch.float64), port_fragment(2))
    with pytest.raises(ValueError, match="cannot share one batch"):
        w.query_batch([{"source": 6}, {}])


def test_host_only_and_mutation_apps_are_refused():
    frag = port_fragment(2)
    with pytest.raises(ValueError, match="host-only"):
        Worker(APP_REGISTRY["sssp_msg"](), frag).query_batch(
            [{"source": 6}, {"source": 3}])

    class Mutating(SSSP):
        def collect_mutations(self, frag, host_state, rounds):
            return None

    with pytest.raises(ValueError, match="MutationContext"):
        Worker(Mutating(), frag).query_batch([{"source": 6}])
    with pytest.raises(ValueError, match="at least one lane"):
        Worker(SSSP(), frag).query_batch([])


def test_query_takes_one_source_and_batch_needs_a_query():
    w = Worker(SSSP(dtype=torch.float64), port_fragment(1))
    with pytest.raises(ValueError, match="query_batch"):
        w.query(source=[6, 7])
    with pytest.raises(RuntimeError, match="query_batch"):
        w.batch_result_values(0)
