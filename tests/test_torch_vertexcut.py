"""The port's 2-D vertex cut on the CPU (`fragment/vertexcut.py`,
`fragment/partition.py`, `models/vc2d.py`, `models/pagerank_vc.py`, the
runner's `--vc` and GRAPE_PARTITION), held against the JAX package on
`dataset/p2p-31.*`: the cases of tests/test_partition2d.py,
tests/test_vertexcut.py and the non-pipeline, non-compile-count cases of
tests/test_vc2d_pipeline.py.

* The host tiles (`_host_tiles`), the tile CSR views and `tile_stats`
  equal the JAX fragment's, symmetrised and raw, at fnum 1 and 4; the
  content hash too, and VCPartitioner assigns as the JAX one does.
* `sssp_vc`, `bfs_vc` and `wcc_vc` are bit-equal by oid to the JAX vc
  apps and the 1-D apps (with equal round counts) at fnum 1 and 4, and
  to the port's 1-D apps at fnum 9 and 16 (the JAX package's CPU mesh
  has 8 devices); `pagerank_vc` and `pagerank_vc_rep` agree with JAX
  within 1e-9 relative and pass the golden's 1e-4.
* Every tile pull goes through K1 (`ops/spmv.py::gather_reduce`, one call
  a round, lanes one `gather_reduce_lanes` call): on a CUDA fragment the
  kernel, so a plain torch reduction in its place fails here.
* `resolve_partition`: the JAX decisions and reasons on its test's
  cases; the modeled terms equal JAX's, and with a given rate profile
  the seconds too.
* Fingerprints cover the tiles; kill and resume is bit-equal, and a JAX
  `sssp_vc` lineage resumes in the port; guard halt keeps the results;
  release and restore keep the tiles' bytes; `fragment_bytes` equals the
  placed bytes; dyn refuses; a batched vc session equals sequential
  queries; `run_app --vc` and GRAPE_PARTITION=2d match the goldens, and
  the runner's declines and errors are the JAX package's.
"""

import glob
import json

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch.fragment.vertexcut import (
    VC_TILE_STATS,
    ImmutableVertexcutFragment,
)
from libgrape_lite_tpu_torch.io.line_parser import (
    read_edge_file,
    read_vertex_file,
)
from libgrape_lite_tpu_torch.models import (
    APP_REGISTRY,
    BFS,
    BFSVC2D,
    SSSP,
    SSSPVC2D,
    WCC,
    WCCVC2D,
    PageRank,
    PageRankVC,
    PageRankVCReplicated,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_lanes import port_fragment
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

P2P = (dataset_path("p2p-31.e"), dataset_path("p2p-31.v"))
_EDGES = {}
_VC = {}


def edges():
    if not _EDGES:
        src, dst, w = read_edge_file(P2P[0], weighted=True)
        _EDGES["e"] = (src, dst, w, read_vertex_file(P2P[1]))
    return _EDGES["e"]


def vc_frag(fnum, weighted=True, symmetrize=True, directed=False):
    key = (fnum, weighted, symmetrize, directed)
    if key not in _VC:
        src, dst, w, oids = edges()
        _VC[key] = ImmutableVertexcutFragment.build(
            CommSpec(fnum=fnum, device="cpu"), oids, src, dst,
            w if weighted else None, directed=directed,
            symmetrize=symmetrize)
    return _VC[key]


def jax_vc_frag(fnum, weighted=True, symmetrize=True, directed=False):
    from libgrape_lite_tpu.fragment.vertexcut import (
        ImmutableVertexcutFragment as J,
    )
    from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JC

    src, dst, w, oids = edges()
    return J.build(JC(fnum=fnum), oids, src, dst, w if weighted else None,
                   directed=directed, symmetrize=symmetrize)


def by_oid(w) -> dict:
    """{oid: value} over the fragments' masters."""
    vals = w.result_values()
    frag = w.fragment
    out = {}
    for f in range(frag.fnum):
        n = frag.inner_vertices_num(f)
        for o, v in zip(frag.inner_oids(f), vals[f, :n]):
            out[int(o)] = v
    return out


def run(app, frag, **kw):
    w = Worker(app, frag)
    w.query(**kw)
    return w


def same_bytes(a: dict, b: dict):
    assert a.keys() == b.keys()
    bad = [k for k in a
           if np.asarray(a[k]).tobytes() != np.asarray(b[k]).tobytes()]
    assert not bad, f"{len(bad)} mismatches, e.g. {bad[:5]}"


# the 2-D app, its 1-D twin, the query, and whether it needs weights
APPS = {
    "sssp": (lambda: SSSPVC2D(dtype=torch.float64),
             lambda: SSSP(dtype=torch.float64), {"source": 6}, True),
    "bfs": (BFSVC2D, BFS, {"source": 6}, False),
    "wcc": (WCCVC2D, WCC, {}, False),
}


class SSSPVC64(SSSPVC2D):
    """The session builds apps from classes (the lane key is read off
    the class): the JAX tests' float64 state."""

    def __init__(self):
        super().__init__(dtype=torch.float64)


def jax_apps(name):
    from libgrape_lite_tpu.models import APP_REGISTRY as J

    return J[name + "_vc"](), J[name]()


# ---- the fragment ---------------------------------------------------------


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("fnum", [1, 4])
def test_host_tiles_equal_jax(fnum, symmetrize):
    from libgrape_lite_tpu.ft.fingerprint import fragment_content_hash as jh
    from libgrape_lite_tpu_torch.ft.fingerprint import fragment_content_hash

    jf = jax_vc_frag(fnum, symmetrize=symmetrize)
    pf = vc_frag(fnum, symmetrize=symmetrize)
    for a, b in zip(jf._host_tiles, pf._host_tiles):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    for side in ("host_ie", "host_oe"):
        for c1, c2 in zip(getattr(jf, side), getattr(pf, side)):
            for name in ("indptr", "edge_src", "edge_nbr", "edge_w",
                         "edge_mask"):
                a, b = getattr(c1, name), getattr(c2, name)
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            assert (c1.num_rows, c1.num_edges) == (c2.num_rows, c2.num_edges)
    assert jf.tile_stats() == pf.tile_stats()
    assert VC_TILE_STATS["tiles"] == fnum and VC_TILE_STATS["scans"] >= 1
    assert np.array_equal(jf.vertex_mask(), pf.vertex_mask())
    for f in range(fnum):
        assert jf.inner_vertices_num(f) == pf.inner_vertices_num(f)
        assert np.array_equal(jf.inner_oids(f), pf.inner_oids(f))
    assert jh(jf) == fragment_content_hash(pf)


@pytest.mark.parametrize("fnum", [4, 9])
def test_vc_partitioner_matches_jax(fnum):
    from libgrape_lite_tpu.vertex_map.partitioner import make_partitioner as J
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        make_partitioner,
    )

    src, dst, _, oids = edges()
    jp = J("vc", fnum, vnum=len(oids))
    pp = make_partitioner("vc", fnum, vnum=len(oids))
    assert np.array_equal(jp.get_partition_id(oids), pp.get_partition_id(oids))
    assert np.array_equal(jp.get_edge_partition(src, dst),
                          pp.get_edge_partition(src, dst))
    with pytest.raises(ValueError, match="k\\^2"):
        make_partitioner("vc", 8, vnum=10)


def test_build_refusals_match_jax():
    src, dst, w, oids = edges()
    with pytest.raises(ValueError, match="fnum = k\\^2"):
        ImmutableVertexcutFragment.build(CommSpec(fnum=2, device="cpu"),
                                         oids, src, dst, w)
    with pytest.raises(ValueError, match="outside the vertex oid space"):
        ImmutableVertexcutFragment.build(
            CommSpec(fnum=4, device="cpu"), oids[:10], src, dst, w)


def test_concatenated_tile_csr_is_what_k1_pulls():
    """The device CSR is one CSR of k^2 * vc rows, tile f's rows at f *
    vc, neighbours global gpids: it equals the tile CSR views shifted."""
    frag = vc_frag(4, symmetrize=False)
    dev = frag.dev
    k, vc = frag.k, frag.vc
    ip = dev.ie.indptr[0].numpy()
    nb = dev.ie.nbr[0].numpy()
    assert ip.shape == (k * k * vc + 1,) and dev.ie.indptr.dtype == torch.int32
    for f, c in enumerate(frag.host_ie):
        a = ip[f * vc]
        assert np.array_equal(ip[f * vc:(f + 1) * vc + 1] - a, c.indptr)
        i = f // k  # the ie tile gathers from src chunk i
        assert np.array_equal(nb[a:a + c.num_edges],
                              c.edge_nbr[:c.num_edges] + i * vc)
    assert dev.oe is not None
    assert vc_frag(4).dev.oe is None  # symmetrised storage pulls ie only


@pytest.mark.parametrize("lanes", [None, 3])
def test_step_context_reduces_the_tile_axes(lanes):
    """The row-axis reduction folds the k tiles of a column (dst chunk
    j), the column-axis one those of a row (src chunk i), lane axes pass
    through, and `vc_transpose` swaps tile (i, j) with (j, i)."""
    from libgrape_lite_tpu_torch.app.base import VCStepContext, make_context

    k, vc = 3, 5
    ctx = VCStepContext(k)
    lead = () if lanes is None else (lanes,)
    y = torch.randn(lead + (1, k * k * vc), dtype=torch.float64)
    t = ctx.tiles(y)
    assert t.shape == lead + (k, k, vc)
    for i in range(k):
        for j in range(k):
            f = i * k + j
            assert torch.equal(t[..., i, j, :], y[..., 0, f * vc:(f + 1) * vc])
    for j in range(k):
        col = torch.stack([t[..., i, j, :] for i in range(k)])
        assert torch.equal(ctx.row_min(t)[..., j, :], col.amin(dim=0))
        assert torch.allclose(ctx.row_sum(t)[..., j, :], col.sum(dim=0))
        row = torch.stack([t[..., j, i, :] for i in range(k)])
        assert torch.equal(ctx.col_min(t)[..., j, :], row.amin(dim=0))
        assert torch.allclose(ctx.col_sum(t)[..., j, :], row.sum(dim=0))
    assert torch.equal(ctx.vc_transpose(t)[..., 0, 2, :], t[..., 2, 0, :])
    assert ctx.flat(ctx.row_min(t)).shape == lead + (k * vc,)
    assert isinstance(make_context(SSSPVC2D(), vc_frag(4)), VCStepContext)
    assert not isinstance(make_context(SSSP(), port_fragment(1)),
                          VCStepContext)


# ---- the apps against the JAX package and the 1-D path ---------------------


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc"])
def test_min_fold_bit_equal_to_jax_and_1d(graph_cache, name, fnum):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    vc_cls, one_cls, kw, weighted = APPS[name]
    got = run(vc_cls(), vc_frag(fnum, weighted))
    got = run(vc_cls(), vc_frag(fnum, weighted), **kw)
    j2, j1 = jax_apps(name)
    jw = JWorker(j2, jax_vc_frag(fnum, weighted))
    jw.query(**kw)
    jvals = jw.result_values()
    assert got.result_values().tobytes() == np.asarray(jvals).tobytes()
    assert got.rounds == jw.rounds
    one = run(one_cls(), port_fragment(fnum), **kw)
    same_bytes(by_oid(got), by_oid(one))
    assert got.rounds == one.rounds


@pytest.mark.parametrize("fnum", [9, 16])
@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc"])
def test_min_fold_bit_equal_to_port_1d(name, fnum):
    vc_cls, one_cls, kw, weighted = APPS[name]
    got = run(vc_cls(), vc_frag(fnum, weighted), **kw)
    one = run(one_cls(), port_fragment(4), **kw)
    same_bytes(by_oid(got), by_oid(one))
    assert got.rounds == one.rounds


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("rep", [False, True])
def test_pagerank_vc_within_eps_of_jax_and_golden(fnum, rep):
    from libgrape_lite_tpu.models import APP_REGISTRY as J
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    name = "pagerank_vc_rep" if rep else "pagerank_vc"
    cls = PageRankVCReplicated if rep else PageRankVC
    kw = dict(delta=0.85, max_round=10)
    got = run(cls(dtype=torch.float64), vc_frag(fnum, False, False), **kw)
    jw = JWorker(J[name](), jax_vc_frag(fnum, False, False))
    jw.query(**kw)
    want = np.asarray(jw.result_values())
    vals = got.result_values()
    assert vals.dtype == np.float64 and vals.shape == want.shape
    np.testing.assert_allclose(vals, want, rtol=1e-9, atol=1e-15)
    eps_verify({o: f"{v:.15e}" for o, v in by_oid(got).items()},
               load_golden(dataset_path("p2p-31-PR")))
    one = by_oid(run(PageRank(dtype=torch.float64), port_fragment(fnum),
                     **kw))
    mine = by_oid(got)
    assert max(abs(mine[o] - one[o]) / abs(one[o]) for o in one) < 1e-9


def test_pagerank_vc_refuses_symmetrised_storage():
    with pytest.raises(ValueError, match="symmetrize=False"):
        run(PageRankVC(dtype=torch.float64), vc_frag(4, False, True))


def test_directed_wcc_pulls_both_sides():
    """Directed raw storage: wcc_vc pulls the ie and the oe tiles (two K1
    calls a round) and finds the weak components of the 1-D directed
    WCC."""
    frag = vc_frag(4, False, symmetrize=False, directed=True)
    got = by_oid(run(WCCVC2D(), frag))
    want_frag = port_fragment(1)
    want = by_oid(run(WCC(), want_frag))
    # the same partition into components (labels may be other members)
    pairs = {(got[o], want[o]) for o in want}
    assert len({a for a, _ in pairs}) == len(pairs) == len(
        {b for _, b in pairs})


class _Counting:
    """Counts the K1 calls of a run on the CPU (their plain versions)."""

    def __init__(self, monkeypatch):
        self.single = self.lanes = 0
        gr, grl = spmv.gather_reduce, spmv.gather_reduce_lanes

        def single(*a, **k):
            self.single += 1
            return gr(*a, **k)

        def lanes(*a, **k):
            self.lanes += 1
            return grl(*a, **k)

        monkeypatch.setattr(spmv, "gather_reduce", single)
        monkeypatch.setattr(spmv, "gather_reduce_lanes", lanes)


@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc", "pagerank"])
def test_every_tile_pull_is_one_k1_call(monkeypatch, name):
    if name == "pagerank":
        app, frag, kw, per_round = (PageRankVC(dtype=torch.float64),
                                    vc_frag(4, False, False),
                                    dict(max_round=10), 2)
    else:
        vc_cls, _, kw, weighted = APPS[name]
        app, frag, per_round = vc_cls(), vc_frag(4, weighted), 1
    c = _Counting(monkeypatch)
    w = run(app, frag, **kw)
    assert c.single == per_round * w.rounds and c.lanes == 0


def test_vc_lanes_are_one_k1_call_a_round(monkeypatch):
    frag = vc_frag(4)
    sources = [6, 17, 3, 42]
    want = [run(SSSPVC2D(dtype=torch.float64), frag, source=s)
            .result_values() for s in sources]
    c = _Counting(monkeypatch)
    w = Worker(SSSPVC2D(dtype=torch.float64), frag)
    w.query_batch([{"source": s} for s in sources])
    assert c.lanes == int(w.batch_rounds.max()) and c.single == 0
    for b, v in enumerate(want):
        assert w.batch_result_values(b).tobytes() == v.tobytes()


# ---- the partition planner -------------------------------------------------


@pytest.mark.parametrize("value,mode", [
    (None, "1d"), ("1d", "1d"), ("0", "1d"), ("off", "1d"), ("2d", "2d"),
    ("auto", "auto"), ("1", "auto"), ("bogus", "1d"),
])
def test_partition_mode_matches_jax(monkeypatch, value, mode):
    from libgrape_lite_tpu.fragment.partition import partition_mode as J
    from libgrape_lite_tpu_torch.fragment.partition import partition_mode

    if value is None:
        monkeypatch.delenv("GRAPE_PARTITION", raising=False)
    else:
        monkeypatch.setenv("GRAPE_PARTITION", value)
    assert partition_mode() == J() == mode


def test_resolve_partition_decisions_match_jax(monkeypatch):
    """The JAX test's cases: the same decisions and recorded reasons."""
    from libgrape_lite_tpu.fragment.partition import resolve_partition as J
    from libgrape_lite_tpu_torch.fragment.partition import (
        PARTITION_STATS,
        resolve_partition,
    )

    src, dst, _, oids = edges()
    cases = [
        dict(app_name="sssp", fnum=2, mode="2d"),
        dict(app_name="cdlp", fnum=4, mode="2d"),
        dict(app_name="sssp", fnum=4, mode="2d", string_id=True),
        dict(app_name="pagerank", fnum=4, mode="2d", directed=True),
        dict(app_name="sssp", fnum=4, mode="2d"),
        dict(app_name="sssp", fnum=4, mode="auto"),
        dict(app_name="sssp", fnum=4, mode="1d"),
        dict(app_name="sssp", fnum=4, mode="2d", eligible=False,
             reason="delta-mutation load has no vertex-cut path"),
    ]
    for kw in cases:
        before = dict(PARTITION_STATS)
        d = resolve_partition(src=src, dst=dst, oids=oids, **kw)
        j = J(src=src, dst=dst, oids=oids, **kw)
        assert d["engaged"] == j["engaged"] and d["mode"] == j["mode"], kw
        assert PARTITION_STATS["last_decision"] is d
        if not j["engaged"]:
            if "does not beat" in j["reason"]:
                assert "does not beat" in d["reason"]
            else:
                assert d["reason"] == j["reason"], kw
            counted = kw["mode"] != "1d"
            assert (PARTITION_STATS["declined"]
                    == before["declined"] + counted)
        else:
            assert set(d["costs"]) == {"1d", "2d"}
            assert PARTITION_STATS["resolved_2d"] == before["resolved_2d"] + 1


@pytest.mark.parametrize("fnum", [1, 4, 9, 16])
def test_modeled_costs_terms_match_jax(fnum):
    """The same terms; under a profile that measured the compute and link
    rates (here the JAX package's default rates, set by the test: the
    port carries none) the same seconds; under the data sheet, whose rates
    are all unfitted, no seconds."""
    from libgrape_lite_tpu.fragment.partition import modeled_costs as J
    from libgrape_lite_tpu.ops.calibration import active_profile
    from libgrape_lite_tpu_torch.fragment.partition import modeled_costs
    from libgrape_lite_tpu_torch.ops.calibration import (
        EXCHANGE_MODES,
        RateProfile,
    )

    src, dst, _, oids = edges()
    n = int(oids.max()) + 1
    jp = active_profile()
    prof = RateProfile(ops_per_s=jp.vpu_lanes_per_cycle * jp.clock_hz,
                       exchange_bps=dict.fromkeys(EXCHANGE_MODES, jp.ici_bps),
                       fitted=True, unfitted=())
    want = J(src, dst, n, fnum)
    got = modeled_costs(src, dst, n, fnum, profile=prof)
    bare = modeled_costs(src, dst, n, fnum)
    assert set(got) == set(want)
    for lay in want:
        assert "t_compute_s" not in bare[lay]
        for key, v in want[lay].items():
            if key == "t_round_s":
                assert got[lay][key] == pytest.approx(v, rel=1e-12)
                assert key not in bare[lay]
            else:
                assert got[lay][key] == v == bare[lay][key]


# ---- ft/, guard/, fleet/, dyn/ on the vertex cut ---------------------------


def test_fingerprint_covers_the_tiles():
    from libgrape_lite_tpu_torch.ft.fingerprint import fragment_content_hash

    src, dst, w, oids = edges()
    w3 = np.array(w, copy=True)
    w3[0] += 1.0
    f3 = ImmutableVertexcutFragment.build(
        CommSpec(fnum=4, device="cpu"), oids, src, dst, w3,
        symmetrize=True, directed=False)
    assert fragment_content_hash(vc_frag(4)) != fragment_content_hash(f3)
    f1 = ImmutableVertexcutFragment.build(
        CommSpec(fnum=4, device="cpu"), oids, src, dst, w,
        symmetrize=True, directed=False)
    assert fragment_content_hash(vc_frag(4)) == fragment_content_hash(f1)


def test_fingerprint_reads_partition_mode(monkeypatch):
    from libgrape_lite_tpu.ft.fingerprint import compute_fingerprint as J
    from libgrape_lite_tpu_torch.ft.fingerprint import compute_fingerprint

    monkeypatch.setenv("GRAPE_PARTITION", "2d")
    app = SSSPVC2D(dtype=torch.float64)
    frag = vc_frag(4)
    carry = {"dist": app.init_state(frag, source=6)["dist"]}
    got = compute_fingerprint(app, frag, {"source": 6}, carry=carry)
    want = J(jax_apps("sssp")[0], jax_vc_frag(4), {"source": 6})
    assert got["partition_mode"] == "2d"
    assert got == want


def test_kill_resume_bit_equal(tmp_path):
    from libgrape_lite_tpu_torch.ft.checkpoint import list_checkpoints
    from libgrape_lite_tpu_torch.ft.faults import FaultPlan, InjectedFault

    frag = vc_frag(4)
    ref = run(SSSPVC2D(dtype=torch.float64), frag, source=6).result_values()
    d = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        run(SSSPVC2D(dtype=torch.float64), frag, source=6,
            checkpoint_every=2, checkpoint_dir=d,
            fault_plan=FaultPlan.from_spec("kill@4,mode=raise"))
    assert [r for r, _ in list_checkpoints(d)] == [2, 4]
    w = Worker(SSSPVC2D(dtype=torch.float64), frag)
    w.resume(d)
    assert w.result_values().tobytes() == ref.tobytes()


def test_jax_vc_lineage_resumes_in_the_port(tmp_path):
    """An `sssp_vc` lineage crosses: the carry keys ("dist") and the
    fingerprint agree."""
    from libgrape_lite_tpu.ft.faults import FaultPlan as JPlan
    from libgrape_lite_tpu.ft.faults import InjectedFault as JFault
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    d = str(tmp_path / "ck")
    with pytest.raises(JFault):
        JWorker(jax_apps("sssp")[0], jax_vc_frag(4)).query(
            checkpoint_every=2, checkpoint_dir=d,
            fault_plan=JPlan.from_spec("kill@4,mode=raise"), source=6)
    w = Worker(SSSPVC2D(dtype=torch.float64), vc_frag(4))
    w.resume(d)
    ref = run(SSSPVC2D(dtype=torch.float64), vc_frag(4), source=6)
    assert w.result_values().tobytes() == ref.result_values().tobytes()


@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc"])
def test_guard_halt_keeps_the_results(name):
    vc_cls, _, kw, weighted = APPS[name]
    frag = vc_frag(4, weighted)
    plain = run(vc_cls(), frag, **kw).result_values()
    w = run(vc_cls(), frag, guard="halt", **kw)
    assert w.result_values().tobytes() == plain.tobytes()
    rep = w.guard_report
    assert rep["probes"] == w.rounds + 1 and not rep["breaches"]
    assert len(rep["invariants"]) == 2


def test_guard_catches_a_corrupt_vc_carry():
    from libgrape_lite_tpu_torch.guard.monitor import InvariantBreachError

    frag = vc_frag(4)
    w = Worker(SSSPVC2D(dtype=torch.float64), frag)

    class Poison(SSSPVC2D):
        def inceval(self, ctx, dev, state):
            st, a = super().inceval(ctx, dev, state)
            st["dist"] = st["dist"].clone()
            st["dist"][:4] = -1.0
            return st, a

    w = Worker(Poison(dtype=torch.float64), frag)
    with pytest.raises(InvariantBreachError):
        w.query(source=6, guard="halt")


def test_release_restore_keeps_the_tiles():
    src, dst, w, oids = edges()
    frag = ImmutableVertexcutFragment.build(
        CommSpec(fnum=4, device="cpu"), oids, src, dst, w,
        symmetrize=False)
    before = {k: v.clone() for k, v in
              (("ie_i", frag.dev.ie.indptr), ("ie_n", frag.dev.ie.nbr),
               ("ie_w", frag.dev.ie.w), ("oe_n", frag.dev.oe.nbr),
               ("vm", frag.dev.vmask))}
    ref = run(SSSPVC2D(dtype=torch.float64), frag, source=6).result_values()
    assert frag.release_device() and frag.dev is None
    assert not frag.release_device()
    assert frag.restore_device() and not frag.restore_device()
    after = {"ie_i": frag.dev.ie.indptr, "ie_n": frag.dev.ie.nbr,
             "ie_w": frag.dev.ie.w, "oe_n": frag.dev.oe.nbr,
             "vm": frag.dev.vmask}
    for k in before:
        assert before[k].numpy().tobytes() == after[k].numpy().tobytes(), k
    got = run(SSSPVC2D(dtype=torch.float64), frag, source=6).result_values()
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("symmetrize", [True, False])
def test_fragment_bytes_equal_the_placed_tensors(symmetrize):
    from libgrape_lite_tpu_torch.fleet.budget import fragment_bytes

    frag = vc_frag(4, True, symmetrize)
    dev = frag.dev
    placed = [dev.ie.indptr, dev.ie.nbr, dev.ie.w, dev.vmask]
    if dev.oe is not None:
        placed += [dev.oe.indptr, dev.oe.nbr, dev.oe.w]
    assert fragment_bytes(frag) == sum(t.nbytes for t in placed)
    assert (dev.oe is None) == symmetrize


def test_dyn_refuses_the_vertex_cut():
    from libgrape_lite_tpu_torch.serve import ServeSession

    with pytest.raises(ValueError, match="vertex-cut"):
        ServeSession(vc_frag(4), dyn=True)


def test_mesh_kind_keys_session_compat():
    from libgrape_lite_tpu_torch.serve.policy import compat_key

    a = compat_key("sssp", {"source": 0}, 100, "off", "source", "frag")
    b = compat_key("sssp", {"source": 0}, 100, "off", "source", "vc2d")
    assert a != b


def test_vc_session_batches_bit_equal_to_sequential():
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    frag = vc_frag(4)
    sources = [0, 6, 31]
    want = {s: run(SSSPVC2D(dtype=torch.float64), frag, source=s)
            .result_values() for s in sources}
    apps = dict(APP_REGISTRY, sssp_vc=SSSPVC64)
    sess = ServeSession(frag, apps=apps, policy=BatchPolicy(max_batch=4))
    res = sess.serve([("sssp_vc", {"source": s}) for s in sources])
    assert sess.queue.batch_hist == {3: 1}
    for r, s in zip(res, sources):
        assert r.ok and r.values.tobytes() == want[s].tobytes()
    # guarded, the same bytes
    sess = ServeSession(frag, apps=apps, policy=BatchPolicy(max_batch=4),
                        guard="halt")
    res = sess.serve([("sssp_vc", {"source": s}) for s in sources])
    for r, s in zip(res, sources):
        assert r.ok and r.values.tobytes() == want[s].tobytes()


def test_query_span_carries_the_tile_record(tmp_path, capsys):
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.scripts import trace_report

    path = str(tmp_path / "t.json")
    obs.configure(trace_path=path)
    try:
        run(BFSVC2D(), vc_frag(4, False), source=6)
        obs.flush()
    finally:
        obs.reset()
    spans = [e for e in obs.load_trace(path)
             if e.get("name") == "query" and e.get("ph") == "X"]
    part = spans[-1]["args"]["partition"]
    assert part["k"] == 2 and len(part["per_tile"]) == 4
    assert part == {k: v for k, v in part.items()}
    trace_report.main([path])
    assert "partition2d tiles (k=2" in capsys.readouterr().out


# ---- the runner and the CLI ------------------------------------------------


def _cli(tmp_path, monkeypatch, *argv, partition=None):
    from libgrape_lite_tpu_torch import cli

    if partition is None:
        monkeypatch.delenv("GRAPE_PARTITION", raising=False)
    else:
        monkeypatch.setenv("GRAPE_PARTITION", partition)
    out = str(tmp_path / "out")
    assert cli.main([*argv, "--efile", P2P[0], "--vfile", P2P[1],
                     "--out_prefix", out, "--device", "cpu"]) == 0
    text = "".join(open(f).read()
                   for f in sorted(glob.glob(out + "/result_frag_*")))
    return load_result_lines(text)


@pytest.mark.parametrize("app,golden,check,flags", [
    ("pagerank", "PR", eps_verify, ["--vc"]),
    ("sssp", "SSSP", exact_verify, []),
    ("bfs", "BFS", exact_verify, []),
    ("wcc", "WCC", wcc_verify, []),
])
def test_run_app_vc_matches_the_goldens(tmp_path, monkeypatch, app, golden,
                                        check, flags):
    from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS

    res = _cli(tmp_path, monkeypatch, "--application", app, "--fnum", "4",
               "--sssp_source", "6", "--bfs_source", "6", *flags,
               partition=None if flags else "2d")
    check(res, load_golden(dataset_path(f"p2p-31-{golden}")))
    if not flags:
        d = PARTITION_STATS["last_decision"]
        assert d["engaged"] and d["app"] == app


@pytest.mark.parametrize("case", ["vc_not_gs", "vc_delta", "vc_string"])
def test_runner_errors_match_jax(case):
    from libgrape_lite_tpu.runner import QueryArgs as JArgs
    from libgrape_lite_tpu.runner import run_app as jrun
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    kw = {"vc_not_gs": dict(application="cdlp", vc=True),
          "vc_delta": dict(application="pagerank", vc=True,
                           delta_efile=P2P[0] + ".mutable_delta"),
          "vc_string": dict(application="pagerank", vc=True,
                            string_id=True)}[case]
    with pytest.raises(ValueError) as ep:
        run_app(QueryArgs(efile=P2P[0], vfile=P2P[1], device="cpu", **kw))
    with pytest.raises(ValueError) as ej:
        jrun(JArgs(efile=P2P[0], vfile=P2P[1], **kw))
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("case", ["delta", "serialize", "cdlp", "fnum2"])
def test_runner_records_its_declines(tmp_path, monkeypatch, case):
    """GRAPE_PARTITION=2d on a run the vertex cut cannot take: the 1-D
    run, with the decline and its reason recorded (as JAX's)."""
    from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    monkeypatch.setenv("GRAPE_PARTITION", "2d")
    kw = {"delta": dict(application="bfs",
                        efile=P2P[0] + ".mutable_base",
                        delta_efile=P2P[0] + ".mutable_delta"),
          "serialize": dict(application="bfs", serialize=True,
                            serialization_prefix=str(tmp_path / "ser")),
          "cdlp": dict(application="cdlp"),
          "fnum2": dict(application="bfs", fnum=2)}[case]
    kw.setdefault("efile", P2P[0])
    kw.setdefault("fnum", 4)
    before = PARTITION_STATS["declined"]
    w = run_app(QueryArgs(vfile=P2P[1], device="cpu", bfs_source=6, **kw))
    d = PARTITION_STATS["last_decision"]
    assert not d["engaged"] and PARTITION_STATS["declined"] == before + 1
    want = {"delta": "delta-mutation load", "serialize": "serialization",
            "cdlp": "no 2-D vertex-cut implementation",
            "fnum2": "not a perfect square"}[case]
    assert want in d["reason"]
    assert w.app.mesh_kind == "frag"


def test_registry_names_equal_jax():
    from libgrape_lite_tpu.models import APP_REGISTRY as J

    assert set(APP_REGISTRY) == set(J) and len(APP_REGISTRY) == 47
    for name in ("sssp_vc", "bfs_vc", "wcc_vc", "pagerank_vc",
                 "pagerank_vc_rep"):
        assert APP_REGISTRY[name].__name__ == J[name].__name__
    assert json.dumps(sorted(APP_REGISTRY))
