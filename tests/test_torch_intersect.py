"""The row AND-popcount (K3), the bitmap helpers and the int32
gather-reduce of the port against the JAX package, on the CPU.

* `row_and_popcount_plain` (the K3 wrapper's CPU path) against the
  Pallas kernel `intersect_count` in interpret mode, as
  tests/test_pallas_kernels.py runs it, against `row_and_popcount`, and
  in its indexed form against a numpy gather -- all integer-equal;
* `pack_bits` / `popcount_rows` against `libgrape_lite_tpu/utils/
  bitset.py`, bitmaps compared through `.view(np.uint32)`;
* int32 `gather_reduce_plain` min / max against the JAX package's
  `segment_reduce`, bit-equal.

Inputs are seeded numpy arrays with bit 31 set in some words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgrape_lite_tpu.ops.pallas_kernels import (
    intersect_count as jintersect_count,
)
from libgrape_lite_tpu.ops.pallas_kernels import row_and_popcount
from libgrape_lite_tpu.ops.segment import segment_reduce as jsegment_reduce
from libgrape_lite_tpu.utils import bitset as jbitset
from libgrape_lite_tpu_torch.ops import intersect, spmv
from libgrape_lite_tpu_torch.utils import bitset

torch.set_num_threads(1)


def bitmaps(seed, n, words, density):
    """uint32 [n, words] with about `density` of the words non-zero and
    bit 31 forced on in a quarter of those."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(n, words), dtype=np.uint64)
    a = a.astype(np.uint32)
    a[rng.random(a.shape) >= density] = 0
    hi = (rng.random(a.shape) < 0.25) & (a != 0)
    a[hi] |= np.uint32(1 << 31)
    return a


def t32(a):
    """uint32 numpy -> the port's int32 bit pattern."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("words", [1, 3, 4, 37])
@pytest.mark.parametrize("density", [0.02, 0.5, 1.0])
def test_dense_form_matches_pallas_interpret(words, density):
    a = bitmaps(words, 256, words, density)
    b = bitmaps(words + 100, 256, words, density)
    assert (a >> 31).any()
    want = np.asarray(jintersect_count(jnp.asarray(a), jnp.asarray(b),
                                       block=128, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(row_and_popcount(jnp.asarray(a), jnp.asarray(b))), want)
    got = intersect.intersect_count(t32(a), t32(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        intersect.row_and_popcount_plain(t32(a), None, t32(b), None).numpy(),
        want)


@pytest.mark.parametrize("words", [1, 3, 4, 64])
@pytest.mark.parametrize("chunk", [1 << 24, 7])
def test_indexed_form_matches_numpy_gather(monkeypatch, words, chunk):
    """Indexed pairs (repeats, hub rows, empty rows) against numpy; a
    tiny chunk drives the plain version through many pair groups."""
    monkeypatch.setattr(intersect, "PLAIN_CHUNK_WORDS", chunk)
    rng = np.random.default_rng(words)
    a = bitmaps(1, 90, words, 0.3)
    b = bitmaps(2, 70, words, 0.6)
    a[5] = 0xFFFFFFFF  # a full row: every word non-zero, bit 31 set
    ia = rng.integers(0, 90, 500).astype(np.int32)
    ib = rng.integers(0, 70, 500).astype(np.int32)
    ia[:50] = 5
    want = np.bitwise_count(a[ia] & b[ib]).sum(axis=1)
    got = intersect.row_and_popcount_indexed(t32(a), torch.from_numpy(ia),
                                             t32(b), torch.from_numpy(ib))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    empty = torch.zeros(0, dtype=torch.int32)
    assert intersect.row_and_popcount_indexed(
        t32(a), empty, t32(b), empty).shape == (0,)


def test_cuda_wrapper_refuses_other_devices():
    a = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        intersect.row_and_popcount_indexed(a, None, a, None)


@pytest.mark.parametrize("num_bits", [32, 95, 4096])
def test_pack_bits_and_popcount_rows_match_jax(num_bits):
    rng = np.random.default_rng(num_bits)
    num_rows = 40
    rows = rng.integers(0, num_rows, 600)
    cols = rng.integers(0, num_bits, 600)
    cols[:20] = 31  # bit 31 of word 0
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)  # unique pairs
    rows, cols = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    keep = rng.random(len(rows)) < 0.8
    want = np.asarray(jbitset.pack_bits(jnp.asarray(cols), jnp.asarray(keep),
                                        num_rows, jnp.asarray(rows),
                                        num_bits))
    got = bitset.pack_bits(torch.from_numpy(cols), torch.from_numpy(keep),
                           num_rows, torch.from_numpy(rows), num_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want >> 31).any()
    np.testing.assert_array_equal(
        bitset.popcount_rows(got).numpy(),
        np.asarray(jbitset.popcount_rows(jnp.asarray(want))))


def test_popcount_every_bit_pattern_edge():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA,
                      0x55555555, 0x80000001], dtype=np.uint32)
    np.testing.assert_array_equal(bitset.popcount(t32(words)).numpy(),
                                  np.bitwise_count(words))


@pytest.mark.parametrize("kind", ["min", "max"])
def test_int32_gather_reduce_plain_matches_jax(graph_cache, kind):
    """int32 min / max over the p2p-31 in-CSR (fnum 2, directed: rows
    without in-edges exist) against the JAX segment_reduce, bit-equal,
    identities INT32_MAX / INT32_MIN included."""
    frag = graph_cache(2, directed=True)
    ie = frag.dev.ie
    n = frag.fnum * frag.vp
    rng = np.random.default_rng(9)
    x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    x[:8] = [2**31 - 1, -2**31, 0, -1, 1, 2**31 - 1, -2**31, 7]
    nbr, src, mask = (np.array(ie.edge_nbr), np.array(ie.edge_src),
                      np.array(ie.edge_mask))
    ident = np.iinfo(np.int32).max if kind == "min" else np.iinfo(np.int32).min
    want = np.stack([
        np.asarray(jsegment_reduce(
            jnp.asarray(np.where(mask[f], x[nbr[f]], ident)),
            jnp.asarray(src[f]), frag.vp, kind))
        for f in range(frag.fnum)])
    indptr = torch.from_numpy(np.array(ie.indptr))
    tnbr, tx = torch.from_numpy(nbr), torch.from_numpy(x)
    got = spmv.gather_reduce_plain(indptr, tnbr, None, tx, kind)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == ident).any()
    np.testing.assert_array_equal(
        spmv.gather_reduce(indptr, tnbr, None, tx, kind).numpy(), want)


def test_int32_gather_reduce_refuses_sum_and_weights():
    """int32 x takes no weights, for any kind; an unweighted int32 sum
    is a kind of its own since the peeling apps (rows without edges
    hold 0)."""
    indptr = torch.zeros((1, 2), dtype=torch.int32)
    nbr = torch.zeros((1, 4), dtype=torch.int32)
    x = torch.zeros(1, dtype=torch.int32)
    got = spmv.gather_reduce(indptr, nbr, None, x, "sum")
    assert got.dtype == torch.int32 and torch.equal(got, torch.zeros_like(got))
    with pytest.raises(ValueError, match="int32"):
        spmv.gather_reduce(indptr, nbr, torch.zeros((1, 4)), x, "sum")
    with pytest.raises(ValueError, match="int32"):
        spmv.gather_reduce(indptr, nbr, torch.zeros((1, 4)), x, "min")
