"""The port's load options against the JAX package's, on p2p-31.

Every `--partitioner_type` x `--idxer_type` pair, `--rebalance` and
`--string_id` go through both loaders at fnum 1, 2, 4 and 8: every leaf
of the port's fragment equals the JAX `DeviceFragment`'s, and the SSSP
(and for string ids WCC and CDLP) output files are byte-identical.  Also:
the native parser (`io/native.py`, built from `native/loader.cc`) against
the numpy parser and the JAX package's edge cases, the native sort and
id tables, `GRAPE_HBM_BYTES`'s warning and `GRAPE_VALIDATE_LOAD`.
"""

import logging
import os

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment.loader import LoadGraph as JLoadGraph
from libgrape_lite_tpu.fragment.loader import LoadGraphSpec as JSpec
from libgrape_lite_tpu.fragment.partition import (
    PARTITION_STATS as J_PARTITION_STATS,
)
from libgrape_lite_tpu.models import CDLP as JCDLP
from libgrape_lite_tpu.models import SSSP as JSSSP
from libgrape_lite_tpu.models import WCC as JWCC
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.vertex_map import idxer as jidx
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS
from libgrape_lite_tpu_torch.graph.csr import CSRValidationError
from libgrape_lite_tpu_torch.io import line_parser, native
from libgrape_lite_tpu_torch.models import CDLP, SSSP, WCC
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.vertex_map import idxer as tidx
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.conftest import dataset_path
from tests.test_torch_substrate import assert_same_fragment

torch.set_num_threads(1)

E, V = dataset_path("p2p-31.e"), dataset_path("p2p-31.v")
FNUMS = [1, 2, 4, 8]
PARTITIONERS = ["hash", "map", "segment"]
IDXERS = ["hashmap", "sorted_array", "pthash", "local"]


def load_both(fnum, **opts):
    j = JLoadGraph(E, V, JCommSpec(fnum=fnum),
                   JSpec(weighted=True, edata_dtype=np.float64, **opts))
    p = LoadGraph(E, V, CommSpec(fnum=fnum, device="cpu"),
                  LoadGraphSpec(weighted=True, edata_dtype=np.float64, **opts))
    return j, p


def read_files(prefix, fnum):
    out = []
    for f in range(fnum):
        with open(os.path.join(prefix, f"result_frag_{f}")) as fh:
            out.append(fh.read())
    return out


def outputs(tmp_path, jfrag, pfrag, japp, papp, **kw):
    jw = JWorker(japp, jfrag)
    jw.query(**kw)
    jw.output(str(tmp_path / "jax"))
    pw = Worker(papp, pfrag)
    pw.query(**kw)
    pw.output(str(tmp_path / "port"))
    return (read_files(tmp_path / "port", pfrag.fnum),
            read_files(tmp_path / "jax", jfrag.fnum))


def assert_same_maps(jfrag, pfrag):
    oids = np.loadtxt(V, dtype=np.int64, usecols=0)
    probe = np.concatenate([oids, [-5, 10**9]])
    np.testing.assert_array_equal(pfrag.oid_to_pid(probe),
                                  jfrag.oid_to_pid(probe))
    for f in range(pfrag.fnum):
        np.testing.assert_array_equal(pfrag.inner_oids(f),
                                      jfrag.inner_oids(f))


@pytest.mark.parametrize("idxer", IDXERS)
@pytest.mark.parametrize("part", PARTITIONERS)
@pytest.mark.parametrize("fnum", FNUMS)
def test_partitioner_idxer_fragment_matches_jax(fnum, part, idxer):
    jfrag, pfrag = load_both(fnum, partitioner_type=part, idxer_type=idxer)
    assert_same_fragment(pfrag, jfrag)
    assert_same_maps(jfrag, pfrag)


@pytest.mark.parametrize("idxer", IDXERS)
@pytest.mark.parametrize("part", PARTITIONERS)
def test_partitioner_idxer_sssp_files_byte_identical(tmp_path, part, idxer):
    jfrag, pfrag = load_both(4, partitioner_type=part, idxer_type=idxer)
    got, want = outputs(tmp_path, jfrag, pfrag, JSSSP(), SSSP(), source=6)
    assert got == want


@pytest.mark.parametrize("fnum", FNUMS)
def test_rebalance_matches_jax(tmp_path, fnum):
    PARTITION_STATS.pop("rebalance", None)
    jfrag, pfrag = load_both(fnum, rebalance=True,
                             rebalance_vertex_factor=3)
    assert_same_fragment(pfrag, jfrag)
    assert_same_maps(jfrag, pfrag)
    assert PARTITION_STATS["rebalance"] == J_PARTITION_STATS["rebalance"]
    stats = PARTITION_STATS["rebalance"]
    assert stats["fnum"] == fnum and stats["vertex_factor"] == 3
    if fnum > 1:  # p2p-31's vfile-order blocks are skewed; the cut fixes it
        assert stats["after"]["skew"] < stats["before"]["skew"]
    got, want = outputs(tmp_path, jfrag, pfrag, JSSSP(), SSSP(), source=6)
    assert got == want


def test_rebalance_env_folds_into_spec(monkeypatch):
    monkeypatch.setenv("GRAPE_PARTITION_REBALANCE", "1")
    PARTITION_STATS.pop("rebalance", None)
    frag = LoadGraph(E, V, CommSpec(fnum=2, device="cpu"),
                     LoadGraphSpec(edata_dtype=np.float64))
    assert PARTITION_STATS["rebalance"]["fnum"] == 2
    monkeypatch.delenv("GRAPE_PARTITION_REBALANCE")
    want = LoadGraph(E, V, CommSpec(fnum=2, device="cpu"),
                     LoadGraphSpec(rebalance=True, edata_dtype=np.float64))
    np.testing.assert_array_equal(frag.host_oids, want.host_oids)


@pytest.mark.parametrize("fnum", FNUMS)
def test_string_id_outputs_byte_identical(tmp_path, fnum):
    jfrag, pfrag = load_both(fnum, string_id=True)
    assert pfrag.is_string_keyed() and jfrag.is_string_keyed()
    assert_same_fragment(pfrag, jfrag)
    for f in range(fnum):
        assert pfrag.inner_oids(f).tolist() == jfrag.inner_oids(f).tolist()
    for japp, papp, kw in ((JSSSP(), SSSP(), {"source": "6"}),
                           (JWCC(), WCC(), {}),
                           (JCDLP(), CDLP(), {"max_round": 10})):
        got, want = outputs(tmp_path / type(papp).__name__, jfrag, pfrag,
                            japp, papp, **kw)
        assert got == want, type(papp).__name__
    # a numeric source names the same vertex as its text
    np.testing.assert_array_equal(pfrag.oid_to_pid(np.array([6])),
                                  pfrag.oid_to_pid(np.array(["6"], object)))


def test_native_parser_matches_numpy():
    assert native.available(), native.UNAVAILABLE_REASON
    src, dst, w = native.parse_file_native(E, 2, True)
    cols = line_parser._parse_columns(E, 2, 3)
    np.testing.assert_array_equal(src, cols[0])
    np.testing.assert_array_equal(dst, cols[1])
    np.testing.assert_array_equal(w, cols[2])
    oids = native.parse_file_native(V, 1, False)[0]
    np.testing.assert_array_equal(oids, line_parser._parse_columns(V, 1, 1)[0])
    before = dict(line_parser.PARSE_COUNTS)
    line_parser.read_edge_file(E, weighted=True)
    assert line_parser.PARSE_COUNTS["native"] == before["native"] + 1


def test_native_parser_edge_cases(tmp_path):
    p = tmp_path / "t.e"
    p.write_text("# comment line\n1 2 0.5\n\n"
                 "9007199254740993 4 1.25\n-3 7 2.0\n")
    src, dst, w = native.parse_file_native(str(p), 2, True)
    assert src.tolist() == [1, 9007199254740993, -3]  # int64-exact
    assert dst.tolist() == [2, 4, 7]
    assert w.tolist() == [0.5, 1.25, 2.0]
    cols = line_parser._parse_columns(str(p), 2, 3)
    assert [c.tolist() for c in cols] == [src.tolist(), dst.tolist(),
                                          w.tolist()]
    with pytest.raises(FileNotFoundError):
        native.parse_file_native(str(tmp_path / "nope.e"), 2, True)
    q = tmp_path / "u.e"  # no weight column: w is None on both paths
    q.write_text("1 2\n3 4\n")
    assert native.parse_file_native(str(q), 2, True)[2] is None
    assert len(line_parser._parse_columns(str(q), 2, 3)) == 2


def test_string_table_parse(tmp_path):
    p = tmp_path / "s.e"
    p.write_text("# c\nalice bob 1.5\nbob carol 2\n\n")
    src, dst, w = line_parser.read_edge_file(str(p), True, string_id=True)
    assert src.tolist() == ["alice", "bob"] and dst.tolist() == ["bob",
                                                                 "carol"]
    assert w.dtype == np.float64 and w.tolist() == [1.5, 2.0]


def test_native_sort_and_tables():
    rng = np.random.default_rng(3)
    n_rows, n_cols, e = 500, 900, 20000
    src = rng.integers(0, n_rows, e)
    nbr = rng.integers(0, n_cols, e)
    w = rng.random(e)
    s, n, ws, ip = native.sort_edges_native(src, nbr, w, n_rows, n_cols)
    order = np.lexsort((nbr, src))
    np.testing.assert_array_equal(s, src[order])
    np.testing.assert_array_equal(n, nbr[order])
    np.testing.assert_array_equal(ws, w[order])
    want_ip = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_rows), out=want_ip[1:])
    np.testing.assert_array_equal(ip, want_ip)
    with pytest.raises(ValueError, match="out of range"):
        native.sort_edges_native(src, nbr, None, n_rows, n_cols - 1)
    oids = rng.permutation(rng.choice(10**9, 3000, replace=False))
    queries = np.concatenate([oids[::-1], rng.integers(0, 10**9, 200)])
    for kind in IDXERS:
        j, t = jidx.make_idxer(kind, oids), tidx.make_idxer(kind, oids)
        np.testing.assert_array_equal(t.get_index(queries),
                                      j.get_index(queries), err_msg=kind)
        lids = np.arange(len(oids))
        np.testing.assert_array_equal(t.get_oid(lids), j.get_oid(lids))
    strs = np.array([f"v{o}" for o in oids[:500]], dtype=object)
    for kind in IDXERS:
        j, t = jidx.make_idxer(kind, strs), tidx.make_idxer(kind, strs)
        q = np.concatenate([strs[::-1], np.array(["nope"], object)])
        np.testing.assert_array_equal(t.get_index(q), j.get_index(q))


def test_hbm_budget_warning(monkeypatch, caplog):
    monkeypatch.setenv("GRAPE_HBM_BYTES", "1024")
    with caplog.at_level(logging.WARNING):
        LoadGraph(E, V, CommSpec(fnum=2, device="cpu"))
    assert any("GRAPE_HBM_BYTES" in r.getMessage() for r in caplog.records)
    caplog.clear()
    monkeypatch.setenv("GRAPE_HBM_BYTES", "0")  # 0 disables the check
    with caplog.at_level(logging.WARNING):
        LoadGraph(E, V, CommSpec(fnum=2, device="cpu"))
    assert not any("GRAPE_HBM_BYTES" in r.getMessage()
                   for r in caplog.records)


def test_skew_warning(caplog):
    # p2p-31's vfile-order blocks at fnum 8 load one shard far above the
    # mean: the skew line names --rebalance
    with caplog.at_level(logging.WARNING):
        LoadGraph(E, V, CommSpec(fnum=8, device="cpu"),
                  LoadGraphSpec(directed=True))
    assert any("--rebalance" in r.getMessage() for r in caplog.records)


def test_validate_load(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAPE_VALIDATE_LOAD", "1")
    spec = LoadGraphSpec(serialize=True, deserialize=True,
                         serialization_prefix=str(tmp_path))
    LoadGraph(E, V, CommSpec(fnum=2, device="cpu"), spec)
    # tamper with the cache: an edge id past the padded id space
    from libgrape_lite_tpu_torch.fragment import loader

    orig = loader._read_garc

    def tampered(cache):
        meta, frags = orig(cache)
        indptr, src, nbr, mask, ne, w = frags[0]["oe"]
        nbr = nbr.copy()
        nbr[0] = meta["fnum"] * meta["vp"]
        frags[0]["oe"] = (indptr, src, nbr, mask, ne, w)
        return meta, frags

    monkeypatch.setattr(loader, "_read_garc", tampered)
    with pytest.raises(CSRValidationError, match="outside"):
        LoadGraph(E, V, CommSpec(fnum=2, device="cpu"), spec)
    monkeypatch.setenv("GRAPE_VALIDATE_LOAD", "0")
    LoadGraph(E, V, CommSpec(fnum=2, device="cpu"), spec)  # unchecked


def test_retain_edge_list():
    frag = LoadGraph(E, V, CommSpec(fnum=2, device="cpu"),
                     LoadGraphSpec(retain_edge_list=True))
    src, dst, w = line_parser.read_edge_file(E, weighted=True)
    np.testing.assert_array_equal(frag.edge_list[0], src)
    np.testing.assert_array_equal(frag.edge_list[1], dst)
    np.testing.assert_array_equal(frag.edge_list[2], w)
