"""The port's garc fragment cache against the JAX package's.

`--serialize` / `--deserialize` write and read
`<prefix>/<sig hash>/part_<fnum>/frag.garc` in the JAX package's format:
a cache either package writes loads in the other with every fragment leaf
equal, at fnum 1, 2, 4 and 8, directed and undirected, integer and string
ids.  Also the stream codecs (byte-identical to the JAX package's), the
fnum / weight / direction refusals and the refusal of a pickle stream
and of a decompression bomb (a stream's, and a v2 archive's whole).
"""

import os
import zlib

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.fragment import loader as jloader
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.utils import archive as jarchive
from libgrape_lite_tpu_torch.fragment import loader
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.utils import archive
from tests.conftest import dataset_path
from tests.test_torch_substrate import assert_same_fragment

torch.set_num_threads(1)

E, V = dataset_path("p2p-31.e"), dataset_path("p2p-31.v")


def spec_pair(prefix, **opts):
    kw = dict(dict(weighted=True, edata_dtype=np.float64, serialize=True,
                   deserialize=True, serialization_prefix=str(prefix)),
              **opts)
    return jloader.LoadGraphSpec(**kw), loader.LoadGraphSpec(**kw)


def port_load(fnum, spec):
    return loader.LoadGraph(E, V, CommSpec(fnum=fnum, device="cpu"), spec)


def jax_load(fnum, spec):
    return jloader.LoadGraph(E, V, JCommSpec(fnum=fnum), spec)


def assert_same_host(a, b):
    """Two port fragments: equal oids and host CSR streams."""
    assert a.host_oids.tolist() == b.host_oids.tolist()
    for sa, sb in ((a.host_oe, b.host_oe), (a.host_ie, b.host_ie)):
        for ca, cb in zip(sa, sb):
            for k in ("indptr", "edge_src", "edge_nbr", "edge_mask"):
                np.testing.assert_array_equal(getattr(ca, k), getattr(cb, k))
            np.testing.assert_array_equal(ca.edge_w, cb.edge_w)
            assert ca.num_edges == cb.num_edges
    assert (a.host_ie is a.host_oe) == (b.host_ie is b.host_oe)


@pytest.mark.parametrize("directed", [False, True],
                         ids=["undirected", "directed"])
@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_garc_round_trip(tmp_path, fnum, directed):
    _, spec = spec_pair(tmp_path, directed=directed)
    fresh = port_load(fnum, spec)
    assert "serialize" in loader.LOAD_SECONDS
    cached = port_load(fnum, spec)
    assert set(loader.LOAD_SECONDS) == {"deserialize"}
    assert_same_host(cached, fresh)
    np.testing.assert_array_equal(cached.oid_to_pid(np.arange(70000)),
                                  fresh.oid_to_pid(np.arange(70000)))


@pytest.mark.parametrize("string_id", [False, True], ids=["int", "string"])
@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_jax_cache_read_by_port(tmp_path, fnum, string_id):
    jspec, pspec = spec_pair(tmp_path, string_id=string_id)
    jfrag = jax_load(fnum, jspec)  # writes the cache
    cache, _ = loader._cache_dir(E, V, pspec, fnum)
    assert os.path.exists(os.path.join(cache, "frag.garc"))
    pfrag = port_load(fnum, pspec)
    assert set(loader.LOAD_SECONDS) == {"deserialize"}
    assert_same_fragment(pfrag, jfrag)
    for f in range(fnum):
        assert pfrag.inner_oids(f).tolist() == jfrag.inner_oids(f).tolist()


@pytest.mark.parametrize("string_id", [False, True], ids=["int", "string"])
@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_port_cache_read_by_jax(tmp_path, fnum, string_id):
    jspec, pspec = spec_pair(tmp_path, string_id=string_id, directed=True)
    pfrag = port_load(fnum, pspec)  # writes the cache
    cache, _ = jloader._cache_dir(E, V, jspec, fnum)
    assert cache == loader._cache_dir(E, V, pspec, fnum)[0]
    jfrag = jax_load(fnum, jspec)
    # the JAX deserializer rebuilds an explicit partitioner: the cache was
    # hit
    from libgrape_lite_tpu.vertex_map.partitioner import ExplicitPartitioner

    assert isinstance(jfrag.vertex_map.partitioner, ExplicitPartitioner)
    assert_same_fragment(pfrag, jfrag)
    probe = (np.array([str(i) for i in range(0, 70000, 7)], dtype=object)
             if string_id else np.arange(0, 70000, 7))
    np.testing.assert_array_equal(pfrag.oid_to_pid(probe),
                                  jfrag.oid_to_pid(probe))


def test_garc_bytes_equal_jax(tmp_path):
    jspec, pspec = spec_pair(tmp_path / "j")
    jax_load(4, jspec)
    _, pspec = spec_pair(tmp_path / "p")
    port_load(4, pspec)
    jc = jloader._cache_dir(E, V, jspec, 4)[0]
    pc = loader._cache_dir(E, V, pspec, 4)[0]
    for name in ("frag.garc", "sig"):
        with open(os.path.join(jc, name), "rb") as a, \
                open(os.path.join(pc, name), "rb") as b:
            assert a.read() == b.read(), name


def test_fnum_and_spec_mismatch_refused(tmp_path):
    _, spec = spec_pair(tmp_path)
    port_load(2, spec)
    cache, _ = loader._cache_dir(E, V, spec, 2)
    with pytest.raises(ValueError, match="serialized fnum=2 != requested 4"):
        loader._deserialize_fragment(cache, CommSpec(fnum=4, device="cpu"),
                                     spec)
    _, dspec = spec_pair(tmp_path, directed=True)
    with pytest.raises(ValueError, match="directed"):
        loader._deserialize_fragment(cache, CommSpec(fnum=2, device="cpu"),
                                     dspec)
    _, uspec = spec_pair(tmp_path / "u", weighted=False)
    port_load(2, uspec)
    ucache, _ = loader._cache_dir(E, V, uspec, 2)
    with pytest.raises(ValueError, match="no edge weights"):
        loader._deserialize_fragment(ucache, CommSpec(fnum=2, device="cpu"),
                                     spec)
    # the signature keys every option: another partitioner misses
    _, hspec = spec_pair(tmp_path, partitioner_type="hash")
    assert loader._cache_dir(E, V, hspec, 2)[0] != cache


def test_codecs_round_trip_and_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    n = loader._FPLANE_MIN + 17
    f32 = rng.uniform(0.1, 10, n).astype(np.float32)
    f32[:4] = [np.inf, -np.inf, np.nan, -0.0]
    arrays = [
        f32, rng.normal(size=n) * 1e18,
        np.sort(rng.integers(0, 1 << 40, n)),  # delta stream
        rng.integers(0, 1 << 30, n),  # varint stream
        rng.random(n) < 0.5,  # bit stream
        np.array(["a", "β", "", "x" * 300], dtype=object),  # UTF-8 oids
        rng.integers(-5, 5, n),  # raw (negatives)
        np.zeros(0, dtype=np.float32),
    ]
    for compact in ("", "1"):
        monkeypatch.setenv("GRAPE_GARC_COMPACT", compact)
        ar, jar = archive.InArchive(), jarchive.InArchive()
        for a in arrays:
            loader._put_array(ar, a)
            jloader._put_array(jar, a)
        assert ar.get_buffer() == jar.get_buffer()
        oa = archive.OutArchive(ar.get_buffer())
        for a in arrays:
            got = loader._get_array(oa)
            if a.dtype == object:
                assert got.tolist() == a.tolist()
            else:
                np.testing.assert_array_equal(got, a)
                assert got.dtype == a.dtype
        assert oa.empty()


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
def test_varint_codecs_match_jax(monkeypatch, native_on):
    from libgrape_lite_tpu_torch.io import native

    if not native_on:
        monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.integers(0, 1 << 62, 1000, dtype=np.int64),
                           [0, 127, 128, 16383, 16384]]).astype(np.uint64)
    enc = archive.varint_encode(vals)
    assert enc == jarchive.varint_encode(vals)
    np.testing.assert_array_equal(archive.varint_decode(enc), vals)
    srt = np.sort(vals)
    denc = archive.delta_varint_encode(srt)
    assert denc == jarchive.delta_varint_encode(srt)
    np.testing.assert_array_equal(archive.delta_varint_decode(denc), srt)
    with pytest.raises(ValueError, match="corrupt varint"):
        archive.varint_decode(enc[:-1] + bytes([enc[-1] | 0x80]))


def test_pickle_stream_refused():
    ar = archive.InArchive()
    ar.add_scalar(loader._ENC_PICKLE, "<b")
    ar.add_scalar(4)
    ar.add_bytes(b"\x80\x04N.")
    with pytest.raises(ValueError, match="pickle"):
        loader._get_array(archive.OutArchive(ar.get_buffer()))


def test_decompression_bomb_refused():
    bomb = zlib.compress(b"\x01" * (64 << 20), 9)
    ar = archive.InArchive()
    ar.add_scalar(loader._ENC_VARINT_Z, "<b")
    ar.add_scalar(8)  # claimed element count: at most 80 bytes inflated
    ar.add_scalar(len(bomb))
    ar.add_bytes(bomb)
    with pytest.raises(ValueError, match="corrupt|exceeds"):
        loader._get_array(archive.OutArchive(ar.get_buffer()))
    payload = zlib.compress(b"x" * 100)
    assert loader._bounded_decompress(payload, 100) == b"x" * 100
    with pytest.raises(ValueError, match="exceeds"):
        loader._bounded_decompress(payload, 99)
    with pytest.raises(ValueError, match="corrupt"):
        loader._bounded_decompress(b"not deflate at all", 100)
    with pytest.raises(ValueError, match="exceeds"):
        loader._bounded_decompress(bomb, 0)
    assert loader._bounded_decompress(zlib.compress(b""), 0) == b""


def test_v2_whole_archive_inflate_is_capped(tmp_path):
    """A v2 frag.garc (the whole archive deflated) loads as the archive it
    wraps, and a small crafted bomb in its place is refused: the inflate
    stops at `_V2_INFLATE_RATIO` times the file's size."""
    _, spec = spec_pair(tmp_path)
    want = port_load(1, spec)
    cache, _ = loader._cache_dir(E, V, spec, 1)
    path = os.path.join(cache, "frag.garc")
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(zlib.compress(blob, 9))
    assert_same_host(port_load(1, spec), want)
    bomb = zlib.compress(b"\x00" * (32 << 20), 9)  # ~32 KiB on disk
    assert len(bomb) * loader._V2_INFLATE_RATIO < 32 << 20
    with open(path, "wb") as fh:
        fh.write(bomb)
    with pytest.raises(ValueError, match="exceeds"):
        port_load(1, spec)


def test_trailing_bytes_and_bad_magic_refused(tmp_path):
    _, spec = spec_pair(tmp_path)
    port_load(1, spec)
    cache, _ = loader._cache_dir(E, V, spec, 1)
    path = os.path.join(cache, "frag.garc")
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        port_load(1, spec)
    with open(path, "wb") as fh:
        fh.write(blob[:8].replace(b"C", b"X") + blob[8:])
    with pytest.raises(Exception):
        port_load(1, spec)
