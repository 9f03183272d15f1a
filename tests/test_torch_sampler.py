"""The port's GNN sampler against the JAX package's, on p2p-31.

`top_k` is deterministic and bit-equal to the JAX sampler; `random` and
`edge_weight` are bit-equal when the port's hop is fed the uniform draws
the JAX sampler makes from the same `PRNGKey`.  Also: the append-only
fragment's rebuilds, the streaming pipeline and both modes of the
`run_sampler` script (the same files as `scripts/run_sampler.py`), the
AsyncSink's order and error surfacing, and the sample invariants the
chip run gates on (neighbours only, no repeated slot, -1 for isolated
rows, reruns bit-equal).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from libgrape_lite_tpu.sampler import sampler as jsampler
from libgrape_lite_tpu.sampler import stream as jstream
from libgrape_lite_tpu.sampler.append_only_fragment import (
    AppendOnlyEdgecutFragment as JFrag,
)
from libgrape_lite_tpu_torch.io.line_parser import read_edge_file
from libgrape_lite_tpu_torch.sampler import stream
from libgrape_lite_tpu_torch.sampler.append_only_fragment import (
    AppendOnlyEdgecutFragment,
)
from libgrape_lite_tpu_torch.sampler.sampler import GraphSampler, sample_hop
from libgrape_lite_tpu_torch.scripts import run_sampler
from tests.conftest import dataset_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, V = dataset_path("p2p-31.e"), dataset_path("p2p-31.v")


def p2p_edges():
    src, dst, w = read_edge_file(E, weighted=True)
    n = int(max(src.max(), dst.max())) + 1
    return (n, np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([w, w]))


@pytest.fixture(scope="module")
def frags():
    n, s, d, w = p2p_edges()
    return (JFrag(n, s, d, w),
            AppendOnlyEdgecutFragment(n, s, d, w, device="cpu"),
            AppendOnlyEdgecutFragment(n, s, d, None, device="cpu"))


def queries(n, count=300, seed=2):
    q = np.random.default_rng(seed).integers(0, n, count)
    return np.concatenate([q, [n - 1, n + 5]])  # past the id space: -1


@pytest.mark.parametrize("window", [1024, 8])
def test_top_k_bit_equal_to_jax(frags, window):
    jfrag, pfrag, _ = frags
    q = queries(pfrag.n)
    want = jsampler.GraphSampler(jfrag, "top_k", window).sample(q, (4, 5))
    got = GraphSampler(pfrag, "top_k", window).sample(q, (4, 5))
    assert len(got) == 2
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)


def test_top_k_unweighted_takes_first_slots(frags):
    _, _, ufrag = frags
    indptr, nbr, _ = ufrag.device_csr()
    q = torch.tensor([int(torch.argmax(indptr[1:] - indptr[:-1]))])
    got = GraphSampler(ufrag, "top_k").sample(q.numpy(), (6,))[0][0]
    s = int(indptr[q])
    np.testing.assert_array_equal(got.numpy(), nbr[s:s + 6].numpy())


@pytest.mark.parametrize("strategy", ["random", "edge_weight"])
def test_random_strategies_bit_equal_given_jax_draws(frags, strategy):
    jfrag, pfrag, _ = frags
    q = queries(pfrag.n)
    fanouts = (4, 5)
    want = jsampler.GraphSampler(jfrag, strategy).sample(q, fanouts, seed=7)
    j_indptr, j_nbr, j_w = jfrag.device_csr()
    indptr, nbr, w = pfrag.device_csr()
    key = jax.random.PRNGKey(7)
    frontier = torch.from_numpy(q.astype(np.int64))
    for h, k in enumerate(fanouts):
        key, sub = jax.random.split(key)
        if strategy == "random":
            draws = jax.random.uniform(sub, (frontier.numel(), k))
        else:
            draws = jax.random.uniform(sub, (int(j_nbr.shape[0]),),
                                       minval=1e-9, maxval=1.0)
        got = sample_hop(indptr, nbr, w, frontier, k, strategy,
                         torch.from_numpy(np.array(draws)))
        np.testing.assert_array_equal(got.numpy().reshape(len(q), -1),
                                      want[h], err_msg=f"hop {h}")
        flat = got.reshape(-1).long()
        frontier = torch.where(flat >= 0, flat, pfrag.n)


@pytest.mark.parametrize("strategy", ["random", "edge_weight", "top_k"])
def test_sample_invariants(frags, strategy):
    _, pfrag, _ = frags
    indptr, nbr, _ = pfrag.device_csr()
    q = queries(pfrag.n, 500)
    sampler = GraphSampler(pfrag, strategy)
    hops = sampler.sample(q, (4, 5), seed=3)
    again = sampler.sample(q, (4, 5), seed=3)
    parents = torch.from_numpy(q)
    for h, k in zip(hops, (4, 5)):
        assert h.dtype == torch.int32
        par = parents.repeat_interleave(k) if h is hops[0] else \
            parents.reshape(-1).repeat_interleave(k)
        flat = h.reshape(-1).long()
        ok = flat >= 0
        p = par.clamp(max=pfrag.n - 1)
        lo, hi = indptr[p].long(), indptr[p + 1].long()
        assert (~ok | (par < pfrag.n)).all()
        # every pick is a neighbour of its parent
        for i in torch.nonzero(ok).reshape(-1)[:2000].tolist():
            assert int(flat[i]) in nbr[lo[i]:hi[i]].tolist()
        # parents without neighbours (or dead) give -1
        assert (~ok | (hi > lo)).all()
        dead = (par >= pfrag.n) | (hi == lo)
        assert (flat[dead] == -1).all()
        parents = h.reshape(-1).long()
        parents = torch.where(parents >= 0, parents, pfrag.n)
    for a, b in zip(hops, again):
        assert torch.equal(a, b)


def test_weighted_picks_never_repeat_a_slot():
    # a row with repeated neighbour ids: picks are slots, not ids
    src = np.zeros(6, np.int64)
    dst = np.array([1, 1, 2, 2, 3, 3])
    w = np.array([1.0, 5.0, 1.0, 5.0, 2.0, 2.0])
    frag = AppendOnlyEdgecutFragment(4, src, dst, w, device="cpu")
    for strategy in ("edge_weight", "top_k"):
        got = GraphSampler(frag, strategy).sample(np.array([0]), (8,))[0][0]
        picks = got.tolist()
        assert sorted(picks[:6]) == [1, 1, 2, 2, 3, 3] and picks[6:] == [-1,
                                                                         -1]
    top = GraphSampler(frag, "top_k").sample(np.array([0]), (2,))[0][0]
    assert top.tolist() == [1, 2]  # the two weight-5 slots, in slot order


def test_append_only_rebuilds_like_jax():
    n, s, d, w = p2p_edges()
    j = JFrag(n, s[:1000], d[:1000], w[:1000], rebuild_threshold=0.5)
    p = AppendOnlyEdgecutFragment(n, s[:1000], d[:1000], w[:1000],
                                  rebuild_threshold=0.5, device="cpu")
    for lo in range(1000, 3000, 300):
        sl = slice(lo, lo + 300)
        j.extend(s[sl], d[sl], w[sl])
        p.extend(s[sl], d[sl], w[sl])
        assert p.num_edges == j.num_edges
        for a, b in zip(p.device_csr(), j.device_csr()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j.extend([n + 3], [0])  # a new vertex past the id space, unweighted
    p.extend([n + 3], [0])
    j.flush()
    p.flush()
    assert p.n == j.n == n + 4
    for a, b in zip(p.device_csr(), j.device_csr()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stream_pipeline_matches_jax(tmp_path):
    n, s, d, w = p2p_edges()
    lines = []
    rng = np.random.default_rng(5)
    for i in range(150):  # each update rebuilds (and the JAX hop recompiles)
        if i % 40 == 3:
            lines.append(f"e {rng.integers(0, n)} {rng.integers(0, n)} "
                         f"{rng.integers(1, 90)}")
        else:
            lines.append(f"q {rng.integers(0, n)}")
    path = tmp_path / "in.txt"
    path.write_text("# stream\n" + "\n".join(lines) + "\n")
    for directed in (False, True):
        outs = []
        for mod, frag_cls, kw in ((stream, AppendOnlyEdgecutFragment,
                                   {"device": "cpu"}),
                                  (jstream, JFrag, {})):
            frag = frag_cls(n, s, d, w, **kw)
            sampler_cls = (GraphSampler if mod is stream
                           else jsampler.GraphSampler)
            out = tmp_path / f"{mod.__name__}-{directed}.txt"
            sink = mod.AsyncSink(mod.FileSink(str(out)))
            emitted = mod.run_pipeline(
                frag, sampler_cls(frag, "top_k"), mod.FileSource(str(path)),
                sink, fanouts=(3, 2), batch=16, directed=directed)
            sink.close()
            outs.append((emitted, out.read_text(), frag.num_edges))
        assert outs[0] == outs[1]


def _jax_run_sampler():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sampler", os.path.join(REPO, "scripts", "run_sampler.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_sampler_static_mode_files_equal(tmp_path):
    common = ["--efile", E, "--vfile", V, "--sampling_strategy", "top_k",
              "--hop_and_num", "4-5", "--weighted"]
    run_sampler.main(common + ["--out_prefix", str(tmp_path / "port"),
                               "--device", "cpu"])
    _jax_run_sampler().main(common + ["--out_prefix", str(tmp_path / "jax"),
                                      "--platform", "cpu"])
    got = (tmp_path / "port" / "result_frag_0").read_text()
    assert got == (tmp_path / "jax" / "result_frag_0").read_text()
    assert got.count("\n") == 62586


def test_run_sampler_stream_mode_files_equal(tmp_path):
    (tmp_path / "in.txt").write_text(
        "q 6\nq 10316\ne 6 10316 3\nq 6\ne 70000 6\nq 70000\nq 1\n")
    outs = []
    for name, main, extra in (
            ("port", run_sampler.main, ["--device", "cpu"]),
            ("jax", _jax_run_sampler().main, ["--platform", "cpu"])):
        out = tmp_path / f"{name}.txt"
        main(["--efile", E, "--sampling_strategy", "top_k",
              "--hop_and_num", "3-2", "--input_stream",
              str(tmp_path / "in.txt"), "--output_stream", str(out),
              "--batch", "2", *extra])
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0].count("\n") == 5


def test_run_sampler_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_sampler.main(["--efile", E, "--out_prefix", "/nonexistent"])


class _ListSink:
    def __init__(self, fail_at=None):
        self.lines, self.closed, self.fail_at = [], False, fail_at

    def emit(self, line):
        if self.fail_at is not None and len(self.lines) == self.fail_at:
            raise OSError("disk full")
        self.lines.append(line)

    def close(self):
        self.closed = True


def test_async_sink_order_and_errors():
    inner = _ListSink()
    sink = stream.AsyncSink(inner, maxsize=16)
    for i in range(5000):
        sink.emit(str(i))
    sink.close()
    assert inner.lines == [str(i) for i in range(5000)] and inner.closed
    bad = _ListSink(fail_at=5)
    sink = stream.AsyncSink(bad, maxsize=4)
    with pytest.raises(RuntimeError, match="writer failed"):
        for i in range(10000):
            sink.emit(str(i))
    with pytest.raises(RuntimeError, match="writer failed"):
        sink.close()
    assert bad.closed and bad.lines == [str(i) for i in range(5)]
