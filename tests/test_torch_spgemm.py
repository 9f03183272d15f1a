"""The port's spgemm LCC backend against the JAX package's.

`GRAPE_LCC_BACKEND=spgemm` plans pruned [128, 128]-bit tile products on
the host and counts triangle credits on the device.  Here, on p2p-31 at
fnum 1, 2, 4 and 8: the plan's streams, ledger and stats are bit-equal
to the JAX planner's; the port's credit pass equals the JAX package's
`spgemm_credits` on the same streams; `triangle_count` and `lcc_bitmap`
are integer-identical across the two backends and to the JAX package's
spgemm runs (with and without `degree_threshold`).  Also the recorded
declines of lcc / lcc_beta / lcc_directed, `auto`'s recorded decision,
the disk plan cache and the env validation.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment.loader import LoadGraph as JLoadGraph
from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JSpec
from libgrape_lite_tpu.models import APP_REGISTRY as J_APPS
from libgrape_lite_tpu.ops import spgemm_pack as jsp
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.ops import spgemm_pack as sp
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path

torch.set_num_threads(1)

E, V = dataset_path("p2p-31.e"), dataset_path("p2p-31.v")
FNUMS = [1, 2, 4, 8]
_FRAGS = {}


def frags(fnum, directed=False):
    key = (fnum, directed)
    if key not in _FRAGS:
        _FRAGS[key] = (
            JLoadGraph(E, V, JCommSpec(fnum=fnum), JSpec(directed=directed)),
            LoadGraph(E, V, CommSpec(fnum=fnum, device="cpu"),
                      LoadGraphSpec(directed=directed)),
        )
    return _FRAGS[key]


def port_run(frag, name, **kw):
    w = Worker(APP_REGISTRY[name](), frag)
    w.query(**kw)
    return w.result_values(), w.app


def jax_run(frag, name, **kw):
    w = JWorker(J_APPS[name](), frag)
    w.query(**kw)
    return np.asarray(w.result_values()), w.app


# each fnum once, the degree threshold on every other one
FNUM_THR = [(1, 0), (2, 30), (4, 0), (8, 30)]


@pytest.mark.parametrize("fnum,thr", FNUM_THR)
def test_plan_bit_equal_to_jax(fnum, thr):
    jfrag, pfrag = frags(fnum)
    cfg = sp.SpGemmConfig(chunk=256)
    got = sp.plan_spgemm(pfrag, thr, cfg=cfg)
    want = jsp.plan_spgemm(jfrag, thr, cfg=jsp.SpGemmConfig(chunk=256))
    for k in ("n_pad", "fnum", "vp", "n_ktiles", "words", "items", "p_pad",
              "rows_pad", "mask_edges", "orientation", "degree_threshold"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.ledger == want.ledger and got.stats == want.stats
    assert set(got.host_streams) == set(want.host_streams)
    for k, v in want.host_streams.items():
        assert got.host_streams[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.host_streams[k], v, err_msg=k)
    if fnum != 4:
        return
    only = sp.plan_spgemm(pfrag, thr, cfg=cfg, plan_only=True)
    jonly = jsp.plan_spgemm(jfrag, thr, cfg=jsp.SpGemmConfig(chunk=256),
                            plan_only=True)
    assert only.host_streams is None
    assert (only.ledger, only.stats, only.items) == (
        jonly.ledger, jonly.stats, jonly.items)


def test_plan_from_edges_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 3000, (2, 40000))
    for thr in (0, 40):
        got = sp.plan_spgemm_edges(src, dst, 3000, thr, plan_only=False)
        want = jsp.plan_spgemm_edges(src, dst, 3000, thr, plan_only=False)
        assert got.ledger == want.ledger and got.stats == want.stats
        for k, v in want.host_streams.items():
            np.testing.assert_array_equal(got.host_streams[k], v)


@pytest.mark.parametrize("fnum", FNUMS)
def test_credits_equal_jax(fnum):
    import jax.numpy as jnp

    jfrag, pfrag = frags(fnum)
    plan = sp.plan_spgemm(pfrag, 0, cfg=sp.SpGemmConfig(chunk=512))
    disp = sp.SpGemmDispatch(plan)
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in disp.state_entries().items()}
    got = disp.credits(state).numpy()
    want = np.zeros(plan.n_pad, np.int64)
    for f in range(fnum):
        shard = {"sg_" + k: jnp.asarray(v[f])
                 for k, v in plan.host_streams.items()}
        want += np.asarray(jsp.spgemm_credits(shard, "sg_", plan.n_pad, 512))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fnum", FNUMS)
def test_triangle_count_backends_and_jax_identical(monkeypatch, fnum):
    jfrag, pfrag = frags(fnum)
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "spgemm")
    got, app = port_run(pfrag, "triangle_count")
    assert app.lcc_backend == "spgemm"
    want, japp = jax_run(jfrag, "triangle_count")
    assert japp.lcc_backend == "spgemm"
    np.testing.assert_array_equal(got, want)
    if fnum in (1, 4):  # the intersect backend (K3's plain version)
        monkeypatch.setenv("GRAPE_LCC_BACKEND", "intersect")
        inter, _ = port_run(pfrag, "triangle_count")
        np.testing.assert_array_equal(got, inter)
    assert app.global_triangles == japp.global_triangles


@pytest.mark.parametrize("fnum,thr", [(1, 30), (2, 0), (4, 30), (8, 0)])
def test_lcc_bitmap_spgemm_identical_to_jax(monkeypatch, fnum, thr):
    jfrag, pfrag = frags(fnum)
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "spgemm")
    got, _ = port_run(pfrag, "lcc_bitmap", degree_threshold=thr)
    want, _ = jax_run(jfrag, "lcc_bitmap", degree_threshold=thr)
    np.testing.assert_array_equal(got, want)
    if thr and fnum == 4:  # the threshold cuts the same lists on intersect
        monkeypatch.setenv("GRAPE_LCC_BACKEND", "intersect")
        inter, _ = port_run(pfrag, "lcc_bitmap", degree_threshold=thr)
        np.testing.assert_array_equal(got, inter)


@pytest.mark.parametrize("name,directed", [("lcc", False),
                                           ("lcc_beta", False),
                                           ("lcc_directed", True)])
def test_declines_recorded(monkeypatch, name, directed):
    jfrag, pfrag = frags(2, directed)
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "spgemm")
    n_port = len(sp.SPGEMM_STATS["declines"])
    n_jax = len(jsp.SPGEMM_STATS["declines"])
    got, _ = port_run(pfrag, name)
    jax_run(jfrag, name)
    rec = sp.SPGEMM_STATS["declines"][n_port:]
    jrec = jsp.SPGEMM_STATS["declines"][n_jax:]
    assert rec == jrec and len(rec) == 1
    assert rec[0]["requested"] == "spgemm"
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "intersect")
    want, _ = port_run(pfrag, name)
    np.testing.assert_array_equal(got, want)  # intersect's results


def test_auto_recorded(monkeypatch):
    _, pfrag = frags(4)
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "auto")
    before = dict(sp.SPGEMM_STATS)
    got, app = port_run(pfrag, "triangle_count")
    dec = sp.SPGEMM_STATS["decisions"][-1]
    assert dec["mode"] == "auto" and dec["backend"] == app.lcc_backend
    assert dec["profile"] == sp.H100_RATES["label"]
    # the plan auto priced: an engaged plan of this fragment, or its
    # pricing plan
    memo = sp._frag_cache(pfrag)
    cfg = sp.SpGemmConfig.from_env()
    plan = memo.get(("spgemm", cfg, 0)) or memo[("spgemm-price", cfg, 0)]
    prices = sp.price_backends(plan.ledger, sp.intersect_ledger(pfrag, 4096))
    assert dec["t_spgemm_s"] == round(prices["t_spgemm_s"], 6)
    assert (dec["backend"] == "spgemm") == prices["spgemm_wins"]
    key = "auto_spgemm" if prices["spgemm_wins"] else "auto_intersect"
    assert sp.SPGEMM_STATS[key] == before[key] + 1
    if not prices["spgemm_wins"]:
        assert sp.SPGEMM_STATS["declines"][-1]["reason"].startswith("auto:")
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "intersect")
    want, _ = port_run(pfrag, "triangle_count")
    np.testing.assert_array_equal(got, want)


def test_disk_plan_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAPE_PACK_PLAN_CACHE", str(tmp_path))
    pfrag = LoadGraph(E, V, CommSpec(fnum=2, device="cpu"))
    first = sp.resolve_spgemm_dispatch(pfrag)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("spgemmplan_")
    # the JAX package names the same plan's file alike
    v, u, _, _ = sp._oriented_mask_edges(pfrag, 0)
    jfrag, _ = frags(2)
    assert jsp._plan_cache_path(v, u, jfrag, 0, jsp.SpGemmConfig()) == \
        str(files[0])
    hits = sp.SPGEMM_STATS["disk_cache_hits"]
    again = sp.resolve_spgemm_dispatch(
        LoadGraph(E, V, CommSpec(fnum=2, device="cpu")))
    assert sp.SPGEMM_STATS["disk_cache_hits"] == hits + 1
    for k, a in first.plan.host_streams.items():
        np.testing.assert_array_equal(again.plan.host_streams[k], a)
    assert again.plan.ledger == first.plan.ledger
    memo = sp.SPGEMM_STATS["frag_cache_hits"]
    sp.resolve_spgemm_dispatch(pfrag)
    assert sp.SPGEMM_STATS["frag_cache_hits"] == memo + 1
    files[0].write_bytes(b"corrupt")  # a corrupt entry is planned again
    planned = sp.SPGEMM_STATS["planned"]
    sp.resolve_spgemm_dispatch(LoadGraph(E, V, CommSpec(fnum=2,
                                                        device="cpu")))
    assert sp.SPGEMM_STATS["planned"] == planned + 1


def test_env_validation(monkeypatch):
    monkeypatch.setenv("GRAPE_LCC_BACKEND", "bogus")
    with pytest.raises(ValueError, match="GRAPE_LCC_BACKEND"):
        sp.lcc_backend_mode()
    monkeypatch.setenv("GRAPE_SPGEMM_CHUNK", "abc")
    with pytest.raises(ValueError, match="GRAPE_SPGEMM_CHUNK"):
        sp.SpGemmConfig.from_env()
    monkeypatch.setenv("GRAPE_SPGEMM_CHUNK", "0")
    with pytest.raises(ValueError, match="GRAPE_SPGEMM_CHUNK"):
        sp.SpGemmConfig.from_env()
    monkeypatch.setenv("GRAPE_SPGEMM_CHUNK", "2048")
    assert sp.SpGemmConfig.from_env().chunk == 2048
