"""The port's mirror exchange (`parallel/mirror.py`, `parallel/
communicator.py`, `StepContext.exchange_mirrors`) against the JAX
package's, on the CPU.

* `build_mirror_plan`'s arrays (`m`, `n_compact`, `send_idx`,
  `nbr_compact`) equal the JAX plan's on the `_rand_frag` graphs of
  tests/test_pipeline.py (n 900, e 7000, seed 11; directed too) and on
  `dataset/p2p-31.*` at fnum 2, 4 and 8, both directions; `pull_columns`
  addresses the flattened compact tables, pads on column 0.
* The byte models (`exchange_bytes_ledger`, `vc2d_exchange_bytes`,
  `pipelined_round_s`) equal the JAX ones on the same arguments, and
  `fragment/partition.py` reads them.
* The collectives over the stacked axis (`all_gather`, `all_to_all`,
  `ppermute`, `axis_index`, `axis_size`) and `exchange_mirrors` equal the
  JAX collectives under `shard_map` on the 8-device CPU mesh.
* `GRAPE_EXCHANGE` (mirror, gather, off, auto, an unknown value) engages
  or declines as the JAX gate does.
* Under GRAPE_EXCHANGE=mirror every app's result equals its gather
  result bit for bit (PageRank's K1 sum included: same rows, same edge
  order) and the JAX package's mirror result (bit-equal for SSSP, BFS,
  WCC; PageRank within the verifier's 1e-4); lanes and the p2p-31 goldens too; an
  attached dyn overlay keeps the gather; the placed tables are built
  once per fragment.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.models import (
    BFS,
    SSSP,
    WCC,
    PageRank,
)
from libgrape_lite_tpu_torch.parallel import mirror
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.parallel.communicator import Communicator
from libgrape_lite_tpu_torch.utils.types import LoadStrategy
from libgrape_lite_tpu_torch.vertex_map.partitioner import MapPartitioner
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_pipeline import _rand_frag as jax_rand_frag
from tests.test_torch_lanes import port_fragment
from tests.verifiers import eps_verify, exact_verify, load_golden, wcc_verify

torch.set_num_threads(1)

FNUMS = [2, 4, 8]
_RAND = {}


@pytest.fixture(autouse=True)
def _exchange_env(monkeypatch):
    for var in ("GRAPE_PIPELINE", "GRAPE_PIPELINE_MIN_BYTES",
                "GRAPE_PIPELINE_MIN_HIDDEN_US", "GRAPE_EXCHANGE",
                "GRAPE_SPMV"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch


def rand_frag(fnum, n=900, e=7000, seed=11, directed=False):
    """The port twin of tests/test_pipeline.py's `_rand_frag` (same
    numpy draws), cached."""
    key = (fnum, n, e, seed, directed)
    if key not in _RAND:
        rng = np.random.default_rng(seed)
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        w = rng.uniform(0.5, 4.0, e).astype(np.float32)
        oids = np.arange(n, dtype=np.int64)
        vm = VertexMap.build(oids, MapPartitioner(fnum, oids))
        _RAND[key] = ShardedEdgecutFragment.build(
            CommSpec(fnum=fnum, device="cpu"), vm, src, dst, w,
            directed=directed, load_strategy=LoadStrategy.kBothOutIn)
    return _RAND[key]


def jax_frag(fnum, directed=False):
    return jax_rand_frag(fnum, directed=directed)


# ---- the plan's arrays ------------------------------------------------------

def assert_same_plan(plan, jplan):
    assert (plan.fnum, plan.vp, plan.m, plan.n_compact) == (
        jplan.fnum, jplan.vp, jplan.m, jplan.n_compact)
    np.testing.assert_array_equal(plan.send_idx, np.asarray(jplan.send_idx))
    np.testing.assert_array_equal(plan.nbr_compact,
                                  np.asarray(jplan.nbr_compact))
    assert plan.bytes_all_gather == jplan.bytes_all_gather
    assert plan.bytes_mirror == jplan.bytes_mirror


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("direction", ["ie", "oe"])
@pytest.mark.parametrize("fnum", FNUMS)
def test_plan_arrays_equal_jax_on_rand_frag(fnum, direction, directed):
    from libgrape_lite_tpu.parallel.mirror import build_mirror_plan as jbuild

    frag = rand_frag(fnum, directed=directed)
    plan = mirror.build_mirror_plan(frag, direction)
    assert_same_plan(plan, jbuild(jax_frag(fnum, directed), direction))
    # cached per fragment and direction
    assert mirror.build_mirror_plan(frag, direction) is plan


@pytest.mark.parametrize("fnum", FNUMS)
def test_plan_arrays_equal_jax_on_p2p(graph_cache, fnum):
    from libgrape_lite_tpu.parallel.mirror import build_mirror_plan as jbuild

    assert_same_plan(mirror.build_mirror_plan(port_fragment(fnum), "ie"),
                     jbuild(graph_cache(fnum), "ie"))


def test_no_plan_at_fnum_1():
    assert mirror.build_mirror_plan(rand_frag(1), "ie") is None


@pytest.mark.parametrize("fnum", FNUMS)
def test_pull_columns_address_the_flat_compact_tables(fnum):
    """Column f * n_compact + nbr_compact[f] of the flattened tables holds
    x[nbr] for every real edge; pads sit on column 0."""
    frag = rand_frag(fnum)
    plan = mirror.build_mirror_plan(frag, "ie")
    mask = np.stack([h.edge_mask for h in frag.host_ie])
    cols = plan.pull_columns(mask)
    assert (cols[~mask] == 0).all()
    x = torch.arange(frag.fnum * frag.vp, dtype=torch.int64).view(
        frag.fnum, frag.vp) * 3 + 1
    table = StepContext.exchange_mirrors(
        x, torch.from_numpy(plan.send_idx.astype(np.int64))).reshape(-1)
    assert table.numel() == fnum * plan.n_compact
    nbr = np.stack([h.edge_nbr for h in frag.host_ie])
    got = table[torch.from_numpy(cols[mask].astype(np.int64))]
    want = x.reshape(-1)[torch.from_numpy(nbr[mask].astype(np.int64))]
    assert torch.equal(got, want)


# ---- the byte models --------------------------------------------------------

@pytest.mark.parametrize("args", [(2, 256, None), (4, 1 << 16, 384),
                                  (8, 1024, 128, 8), (1, 64, None, 2)])
def test_exchange_bytes_ledger_equals_jax(args):
    from libgrape_lite_tpu.parallel import mirror as jmirror

    assert mirror.exchange_bytes_ledger(*args) == \
        jmirror.exchange_bytes_ledger(*args)


@pytest.mark.parametrize("args", [(1, 512), (2, 512), (3, 1000, 8),
                                  (4, 1 << 18, 4, 2)])
def test_vc2d_exchange_bytes_equals_jax(args):
    from libgrape_lite_tpu.parallel import mirror as jmirror

    assert mirror.vc2d_exchange_bytes(*args) == \
        jmirror.vc2d_exchange_bytes(*args)


@pytest.mark.parametrize("args", [(10.0, 3.0, 1.0), (3.0, 10.0, 1.0),
                                  (0.0, 0.0, 0.5), (2e-6, 2e-6, 1e-7)])
def test_pipelined_round_s_equals_jax(args):
    from libgrape_lite_tpu.parallel import mirror as jmirror

    assert mirror.pipelined_round_s(*args) == \
        jmirror.pipelined_round_s(*args)
    assert mirror.pipelined_round_s(*args) == max(args[0], args[1]) + \
        args[2]


def test_partition_reads_the_one_byte_model():
    from libgrape_lite_tpu_torch.fragment import partition

    assert not hasattr(partition, "exchange_bytes_1d")
    assert not hasattr(partition, "exchange_bytes_2d")
    assert partition.exchange_bytes_ledger is mirror.exchange_bytes_ledger
    assert partition.vc2d_exchange_bytes is mirror.vc2d_exchange_bytes
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 600, 4000), rng.integers(0, 600, 4000)
    costs = partition.modeled_costs(src, dst, 600, 4)
    vp = 256  # next_pow2(ceil(600 / 4))
    assert costs["1d"]["exchange_bytes"] == \
        mirror.exchange_bytes_ledger(4, vp)["gather"]
    assert costs["2d"]["exchange_bytes"] == mirror.vc2d_exchange_bytes(
        2, 384)


# ---- the collectives ---------------------------------------------------------

def _jax_collective(fn, x: np.ndarray):
    """fn applied per shard under shard_map over x's leading axis (one
    shard a device of the CPU mesh), the shards' outputs stacked."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from libgrape_lite_tpu import compat
    from libgrape_lite_tpu.parallel.comm_spec import FRAG_AXIS

    n = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), (FRAG_AXIS,))
    out = compat.shard_map(lambda b: fn(b[0])[None], mesh=mesh,
                           in_specs=P(FRAG_AXIS), out_specs=P(FRAG_AXIS),
                           check_vma=False)(x)
    return np.asarray(out)


@pytest.mark.parametrize("fnum", [2, 4, 8])
def test_collectives_equal_jax_under_shard_map(fnum):
    from libgrape_lite_tpu.parallel.communicator import (
        Communicator as JComm,
    )

    rng = np.random.default_rng(fnum)
    x = rng.integers(0, 1000, (fnum, fnum, 3)).astype(np.int32)
    t = torch.from_numpy(x)
    comm = Communicator(fnum)
    # all_to_all over the [fnum, 3] block of each shard
    want = _jax_collective(lambda b: JComm.all_to_all(b, 0, 0), x)
    np.testing.assert_array_equal(comm.all_to_all(t, 0, 0).numpy(), want)
    y = rng.integers(0, 1000, (fnum, 2, fnum * 2)).astype(np.int32)
    want = _jax_collective(lambda b: JComm.all_to_all(b, 1, 0), y)
    np.testing.assert_array_equal(
        comm.all_to_all(torch.from_numpy(y), 1, 0).numpy(), want)
    # all_gather (tiled): every shard holds the same concatenation
    want = _jax_collective(lambda b: JComm.all_gather(b), x)
    for f in range(fnum):
        np.testing.assert_array_equal(comm.all_gather(t).numpy(), want[f])
    # ppermute along a ring, one row left unwritten
    perm = [(i, (i + 1) % fnum) for i in range(fnum - 1)]
    want = _jax_collective(lambda b: JComm.ppermute(b, perm), x)
    np.testing.assert_array_equal(comm.ppermute(t, perm).numpy(), want)
    want = _jax_collective(lambda b: JComm.axis_index()[None], x[:, :1, 0])
    np.testing.assert_array_equal(comm.axis_index().numpy(), want.reshape(-1))
    assert comm.axis_size() == fnum
    np.testing.assert_array_equal(comm.sum(t).numpy(), x.sum(0))


@pytest.mark.parametrize("fnum", [2, 4, 8])
def test_exchange_mirrors_equals_jax_under_shard_map(fnum):
    from libgrape_lite_tpu.app.base import StepContext as JCtx
    from libgrape_lite_tpu.parallel.mirror import build_mirror_plan as jbuild

    jplan = jbuild(jax_frag(fnum), "ie")
    vp = jplan.vp
    x = np.random.default_rng(1).standard_normal((fnum, vp))
    send = np.asarray(jplan.send_idx)
    both = np.concatenate([x, send.reshape(fnum, -1).astype(np.float64)],
                          axis=1)

    def one(b):
        return JCtx.exchange_mirrors(b[:vp], b[vp:].astype(np.int32)
                                     .reshape(fnum, -1))

    want = _jax_collective(one, both)
    got = StepContext.exchange_mirrors(
        torch.from_numpy(x), torch.from_numpy(send.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # lanes pass through: each lane's table is its own exchange
    lanes = torch.from_numpy(np.stack([x, 2 * x]))
    got2 = StepContext.exchange_mirrors(
        lanes, torch.from_numpy(send.astype(np.int64)))
    np.testing.assert_array_equal(got2[1].numpy(), 2 * want)


# ---- the GRAPE_EXCHANGE gate --------------------------------------------------

@pytest.mark.parametrize("value", ["mirror", "gather", "off", "auto", "",
                                   "bogus"])
@pytest.mark.parametrize("fnum", [1, 2, 4])
def test_exchange_gate_matches_jax(monkeypatch, value, fnum, graph_cache):
    from libgrape_lite_tpu.parallel.mirror import (
        resolve_mirror_plan as jresolve,
    )

    monkeypatch.setenv("GRAPE_EXCHANGE", value)
    for frag, jfrag in ((rand_frag(fnum), jax_frag(fnum)),
                        (port_fragment(fnum), graph_cache(fnum))):
        got, want = mirror.resolve_mirror_plan(frag), jresolve(jfrag)
        assert (got is None) == (want is None), (value, fnum)
        if got is not None:
            assert got.m == want.m


def test_auto_gate_prices_the_bytes(monkeypatch):
    """auto engages only past 1 MiB of gathered state and at half the
    bytes: lower the floor and the thresholds decide as in the JAX
    package."""
    from libgrape_lite_tpu.parallel import mirror as jmirror

    monkeypatch.setattr(mirror, "_AUTO_MIN_BYTES", 1)
    monkeypatch.setattr(jmirror, "_AUTO_MIN_BYTES", 1)
    for fnum in FNUMS:
        got = mirror.resolve_mirror_plan(rand_frag(fnum))
        want = jmirror.resolve_mirror_plan(jax_frag(fnum))
        assert (got is None) == (want is None)


class OnCard:
    """A CPU fragment that reports a CUDA device: the auto gates read the
    device before anything is placed, so their card branch runs here."""

    def __init__(self, frag):
        self._frag = frag
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._frag, name)


def test_auto_keeps_the_gather_on_one_cuda_device(monkeypatch):
    """On one CUDA device with no measured exchange_bps, auto resolves
    to the gather wherever the byte gate would pick mirrors, and records
    why; `mirror` still builds the plan; a measured exchange_bps, or the
    CPU, hands the decision back to the byte gate."""
    from libgrape_lite_tpu_torch.ops.calibration import RateProfile

    monkeypatch.setattr(mirror, "_AUTO_MIN_BYTES", 1)
    monkeypatch.setattr(mirror, "_AUTO_RATIO", 1.0)
    engaged = 0
    for fnum in FNUMS:
        frag = rand_frag(fnum)
        monkeypatch.setenv("GRAPE_EXCHANGE", "auto")
        engaged += mirror.resolve_mirror_plan(frag) is not None
        assert mirror.resolve_mirror_plan(OnCard(frag)) is None
        dec = mirror.LAST_EXCHANGE_DECISION
        assert dec["mode"] == "auto" and dec["exchange"] == "gather"
        assert dec["reason"].startswith("one CUDA device")
        monkeypatch.setenv("GRAPE_EXCHANGE", "mirror")
        plan = mirror.resolve_mirror_plan(OnCard(frag))
        assert_same_plan(plan, mirror.build_mirror_plan(frag))
        assert mirror.LAST_EXCHANGE_DECISION["exchange"] == "mirror"
        measured = RateProfile(fitted=True, unfitted=())
        assert mirror.auto_keeps_serial(OnCard(frag), measured) is None
        assert mirror.auto_keeps_serial(frag) is None
    assert engaged  # the byte gate picks mirrors on the CPU somewhere


# ---- apps under the mirror exchange --------------------------------------------

def port_run(app, frag, exchange, monkeypatch, **qa):
    monkeypatch.setenv("GRAPE_EXCHANGE", exchange)
    w = Worker(app, frag)
    w.query(**qa)
    return w


def jax_run(app, frag, exchange, monkeypatch, **qa):
    from libgrape_lite_tpu.worker.worker import Worker as JWorker

    monkeypatch.setenv("GRAPE_EXCHANGE", exchange)
    w = JWorker(app, frag)
    w.query(**qa)
    return w


def _apps(name):
    """(port app, JAX app, query args) of one app on the rand graphs."""
    from libgrape_lite_tpu import models as J

    return {
        "sssp": (SSSP(), J.SSSP(), {"source": 0}),
        "bfs": (BFS(), J.BFS(), {"source": 0}),
        "wcc": (WCC(), J.WCC(), {}),
        # float32 weights: the JAX PageRank runs in float32 too
        "pagerank": (PageRank(), J.PageRank(), {}),
    }[name]


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", ["sssp", "bfs", "wcc", "pagerank"])
def test_mirror_equals_gather_and_jax(monkeypatch, name, fnum, directed):
    frag = rand_frag(fnum, directed=directed)
    app, japp, qa = _apps(name)
    w = port_run(app, frag, "mirror", monkeypatch, **qa)
    assert (getattr(app, "_mx", None) is not None
            or getattr(app, "_mx_ie", None) is not None)
    gather = port_run(_apps(name)[0], frag, "gather", monkeypatch, **qa)
    assert w.result_values().tobytes() == gather.result_values().tobytes()
    assert w.rounds == gather.rounds
    jw = jax_run(japp, jax_frag(fnum, directed), "mirror", monkeypatch,
                 **qa)
    if name == "pagerank":
        # K1's sum and XLA's group float32 sums apart: the verifier's
        # 1e-4
        np.testing.assert_allclose(w.result_values(), jw.result_values(),
                                   rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_array_equal(w.result_values(), jw.result_values())
        assert w.rounds == jw.rounds


def test_directed_wcc_mirrors_both_pulls(monkeypatch):
    frag = rand_frag(4, directed=True)
    app = WCC()
    port_run(app, frag, "mirror", monkeypatch)
    assert app._mx_ie is not None and app._mx_oe is not None
    assert app._mx_oe is mirror.build_mirror_plan(frag, "oe")


@pytest.mark.parametrize("fnum", [2, 4, 8])
@pytest.mark.parametrize("name,golden,check", [
    ("sssp", "p2p-31-SSSP", exact_verify),
    ("bfs", "p2p-31-BFS", exact_verify),
    ("wcc", "p2p-31-WCC", wcc_verify),
    ("pagerank", "p2p-31-PR", eps_verify),
])
def test_mirror_goldens_on_p2p(monkeypatch, fnum, name, golden, check):
    from libgrape_lite_tpu_torch.models import BFS as B, WCC as W

    app, qa = {
        "sssp": (SSSP(dtype=torch.float64), {"source": 6}),
        "bfs": (B(), {"source": 6}),
        "wcc": (W(), {}),
        "pagerank": (PageRank(dtype=torch.float64), {}),
    }[name]
    frag = port_fragment(fnum)
    w = port_run(app, frag, "mirror", monkeypatch, **qa)
    got = {}
    vals = w.result_values()
    for f in range(frag.fnum):
        n = frag.inner_vertices_num(f)
        for o, v in zip(frag.inner_oids(f), vals[f, :n]):
            got[int(o)] = v
    check(got, load_golden(dataset_path(golden)))


def test_mirror_lanes_equal_sequential(monkeypatch):
    monkeypatch.setenv("GRAPE_EXCHANGE", "mirror")
    frag = rand_frag(4)
    w = Worker(SSSP(), frag)
    w.query_batch([{"source": s} for s in (0, 5, 17)])
    for b, s in enumerate((0, 5, 17)):
        seq = port_run(SSSP(), frag, "gather", monkeypatch, source=s)
        assert w.batch_result_values(b).tobytes() == \
            seq.result_values().tobytes()


def test_dyn_overlay_keeps_the_gather(monkeypatch):
    from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy
    from tests.test_torch_dyn import build_graph

    monkeypatch.setenv("GRAPE_EXCHANGE", "mirror")
    dg = DynGraph(build_graph(2), RepackPolicy())
    app = SSSP(dtype=torch.float64)
    app.init_state(dg.fragment, source=6)
    assert app._mx is None


def test_placed_tables_are_built_once(monkeypatch):
    from libgrape_lite_tpu_torch.fragment import edgecut

    monkeypatch.setenv("GRAPE_EXCHANGE", "mirror")
    frag = rand_frag(4)
    SSSP().init_state(frag, source=0)
    fills = edgecut.DEVICE_CACHE_FILLS
    st = SSSP().init_state(frag, source=3)
    assert edgecut.DEVICE_CACHE_FILLS == fills
    assert st["mx_send"].dtype == torch.int64
    assert st["mx_nbr"].dtype == torch.int32
