"""The shapes that break a row-per-warp or a merge-path schedule, and the
plain twins of the K1 and K3 kernels' passes, on the CPU.

* `gather_reduce_plain` and `gather_reduce_merge_plain` (the merge-path
  kernel's schedule: block partition, per-block rows, carries folded in
  block order) against the JAX package's XLA `segment_reduce` on a star
  (one hub row, leaves of one edge), a stack with an edgeless fragment
  and a degree-1 chain, at fnum 1, 2 and 4 with a pad gap after every
  fragment: min / max (float and int32) bit-equal, sums within 1e-5 of
  each row's sum of |terms| (float32 sums in another order).
* the int32 sum (kcore's and core_decomposition's alive-neighbour
  counts, common_neighbors' pulls) of both, bit-equal to it on every
  shape and fnum.
* `merge_partition_plain` against a step-by-step walk of the merge path.
* `row_and_popcount_plain` against the Pallas `intersect_count` in
  interpret mode (operands gathered and padded to its 512-row block) on
  shuffled and repeated pairs at 1, 3, 37 and 64 words: integer-equal.
* `row_occupancy_plain` and `row_and_popcount_occupancy_plain` (the K3
  kernel's summary and pair passes) against brute-force counts.

Inputs are seeded numpy arrays.  The CUDA kernels run only on the card:
chip_smoke.py holds them against these plain versions at full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgrape_lite_tpu.ops.pallas_kernels import (
    intersect_count as jintersect_count,
)
from libgrape_lite_tpu.ops.segment import segment_reduce as jsegment_reduce
from libgrape_lite_tpu_torch.ops import intersect, spmv

torch.set_num_threads(1)

SUM_TOL = 1e-5
INT32 = np.iinfo(np.int32)


def star_shape(n):
    """Row 0 holds an edge from every other vertex; each leaf one edge
    back (in-edges of an undirected star)."""
    rows = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n)])
    cols = np.concatenate([np.arange(1, n), np.zeros(n - 1, np.int64)])
    return rows, cols


def chain_shape(n):
    """Row r holds one edge from r - 1; row 0 none."""
    return np.arange(1, n), np.arange(n - 1)


def empty_last_shape(n, fnum, seed=0):
    """Random rows of 0..7 edges, none in the last fragment's rows."""
    rng = np.random.default_rng(seed)
    vp = n // fnum
    deg = rng.integers(0, 8, n)
    deg[(fnum - 1) * vp:] = 0  # at fnum 1: no edges at all
    rows = np.repeat(np.arange(n), deg)
    return rows, rng.integers(0, n, len(rows))


SHAPES = {
    "star": lambda n, fnum: star_shape(n),
    "empty": empty_last_shape,
    "chain": lambda n, fnum: chain_shape(n),
}


def stacked(rows, cols, n, fnum, pad=5, seed=1):
    """Stacked CSR of fnum fragments of vp = n / fnum rows (pid = f * vp +
    lid): indptr [fnum, vp + 1], nbr / w / src [fnum, ep] with `pad` pad
    edges (src = vp) after the longest fragment's edges."""
    vp = n // fnum
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    w = np.random.default_rng(seed).uniform(0.5, 2.0, len(rows))
    frag = rows // vp
    ep = max(int((frag == f).sum()) for f in range(fnum)) + pad
    indptr = np.zeros((fnum, vp + 1), np.int32)
    nbr = np.zeros((fnum, ep), np.int32)
    wt = np.zeros((fnum, ep), np.float32)
    src = np.full((fnum, ep), vp, np.int32)
    for f in range(fnum):
        sel = frag == f
        k = int(sel.sum())
        indptr[f, 1:] = np.cumsum(np.bincount(rows[sel] - f * vp,
                                              minlength=vp))
        nbr[f, :k], wt[f, :k], src[f, :k] = cols[sel], w[sel], rows[sel] - f * vp
    return indptr, nbr, wt, src


def jax_reduce(x, nbr, w, src, vp, kind):
    """The JAX package's XLA segment_reduce, per fragment; pad edges
    (src = vp) land in its overflow row."""
    out = []
    for f in range(nbr.shape[0]):
        vals = x[nbr[f]]
        if w is not None:
            vals = vals * w[f] if kind == "sum" else vals + w[f]
        out.append(np.asarray(jsegment_reduce(
            jnp.asarray(vals), jnp.asarray(src[f]), vp, kind)))
    return np.stack(out)


def sum_abs(x, nbr, w, src, vp):
    """Each row's sum of |terms| in float64: the scale of a sum's error."""
    out = np.zeros((nbr.shape[0], vp + 1))
    for f in range(nbr.shape[0]):
        t = np.abs(x[nbr[f]].astype(np.float64))
        if w is not None:
            t = t * np.abs(w[f])
        np.add.at(out[f], src[f], t)
    return out[:, :vp]


def check_all_kinds(reduce_fn, shape, fnum, n=96):
    """reduce_fn(indptr, nbr, w, x, kind) against the JAX segment_reduce
    for float sum (with and without w), min + w, max and int32 min / max."""
    rows, cols = SHAPES[shape](n, fnum)
    indptr, nbr, w, src = stacked(rows, cols, n, fnum)
    vp = n // fnum
    rng = np.random.default_rng(fnum)
    x = rng.normal(size=n).astype(np.float32)
    xi = rng.integers(INT32.min, INT32.max, n, dtype=np.int64).astype(np.int32)
    tin = [torch.from_numpy(a) for a in (indptr, nbr, w)]
    for kind, xin, wt in (("sum", x, None), ("sum", x, w), ("min", x, w),
                          ("max", x, None), ("min", xi, None),
                          ("max", xi, None)):
        want = jax_reduce(xin, nbr, wt, src, vp, kind)
        got = reduce_fn(tin[0], tin[1], None if wt is None else tin[2],
                        torch.from_numpy(xin), kind).numpy()
        assert got.dtype == xin.dtype and got.shape == (fnum, vp)
        if kind == "sum":
            bound = SUM_TOL * sum_abs(x, nbr, wt, src, vp)
            assert (np.abs(got.astype(np.float64) - want) <= bound).all()
        else:
            np.testing.assert_array_equal(got, want)
    assert (indptr[:, -1] < nbr.shape[1]).all()  # every fragment has pads
    return indptr


@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gather_reduce_plain_matches_jax_on_shapes(shape, fnum):
    indptr = check_all_kinds(spmv.gather_reduce_plain, shape, fnum)
    if shape == "empty" and fnum > 1:
        assert indptr[-1, -1] == 0  # the last fragment has no edges


@pytest.mark.parametrize("items", [1, 3, 16, 64])
@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_merge_path_schedule_matches_jax_on_shapes(shape, fnum, items):
    """The kernel's schedule: a hub row spans many blocks (its carries
    fold in block order), empty rows cost one item each, pads lie past
    every fragment's merge path."""
    check_all_kinds(
        lambda *args: spmv.gather_reduce_merge_plain(*args, items),
        shape, fnum)


@pytest.mark.parametrize("form", ["plain", "merge1", "merge3", "merge16"])
@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_int32_sum_matches_jax_on_shapes(shape, fnum, form):
    """K1's int32 sum (the peeling apps' neighbour counts): the plain
    version and the merge-path schedule (1, 3 and 16 items a block) are
    bit-equal to the JAX segment_reduce and stay int32; rows without
    edges hold 0."""
    n = 96
    rows, cols = SHAPES[shape](n, fnum)
    indptr, nbr, _, src = stacked(rows, cols, n, fnum)
    vp = n // fnum
    x = np.random.default_rng(fnum).integers(-1000, 1000, n).astype(np.int32)
    want = jax_reduce(x, nbr, None, src, vp, "sum")
    args = (torch.from_numpy(indptr), torch.from_numpy(nbr), None,
            torch.from_numpy(x), "sum")
    if form == "plain":
        got = spmv.gather_reduce_plain(*args)
    else:
        got = spmv.gather_reduce_merge_plain(*args, int(form[5:]))
    assert got.dtype == torch.int32 and got.shape == (fnum, vp)
    np.testing.assert_array_equal(got.numpy(), want)
    deg = np.diff(indptr, axis=1)
    assert (got.numpy()[deg == 0] == 0).all()


@pytest.mark.parametrize("items", [1, 2, 5, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_merge_partition_matches_a_walk(shape, items):
    """Block boundaries against a walk of the merge path: at diagonal d,
    a row end goes first when it is <= the next edge index."""
    fnum, n = 2, 40
    rows, cols = SHAPES[shape](n, fnum)
    indptr, nbr, _, _ = stacked(rows, cols, n, fnum)
    got = spmv.merge_partition_plain(torch.from_numpy(indptr),
                                     nbr.shape[1], items).numpy()
    vp = n // fnum
    bpf = -(-(vp + nbr.shape[1]) // items)
    assert got.shape == (fnum, bpf + 1)
    for f in range(fnum):
        ends, nnz = indptr[f, 1:], int(indptr[f, -1])
        coord, xr, ye = [0], 0, 0
        while xr + ye < vp + nnz:  # one merge item a step
            if xr < vp and (ye >= nnz or ends[xr] <= ye):
                xr += 1
            else:
                ye += 1
            coord.append(xr)
        want = [coord[min(b * items, vp + nnz)] for b in range(bpf + 1)]
        np.testing.assert_array_equal(got[f], want)


def bitmaps(seed, n, words, density):
    """uint32 [n, words], about `density` of the words non-zero, bit 31
    set in a quarter of those, one all-zero row and one full row."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(n, words), dtype=np.uint64)
    a = a.astype(np.uint32)
    a[rng.random(a.shape) >= density] = 0
    a[(rng.random(a.shape) < 0.25) & (a != 0)] |= np.uint32(1 << 31)
    a[0], a[1] = 0, 0xFFFFFFFF
    return a


def t32(a):
    """uint32 numpy -> the port's int32 bit pattern."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def pairs(order, rows_a, rows_b, n, seed):
    """Index pairs in the callers' order (a row repeated over a run),
    shuffled, or one hub row repeated over most pairs."""
    rng = np.random.default_rng(seed)
    ib = np.sort(rng.integers(0, rows_b, n))
    ia = rng.integers(0, rows_a, n)
    if order == "shuffled":
        perm = rng.permutation(n)
        ia, ib = ia[perm], ib[perm]
    elif order == "repeated":
        ib[: n * 3 // 4] = 1
        ia[::7] = 0
    return ia.astype(np.int32), ib.astype(np.int32)


@pytest.mark.parametrize("order", ["shuffled", "repeated"])
@pytest.mark.parametrize("words", [1, 3, 37, 64])
def test_row_and_popcount_plain_matches_pallas_interpret(words, order):
    a = bitmaps(words, 70, words, 0.2)
    b = bitmaps(words + 1, 50, words, 0.5)
    ia, ib = pairs(order, 70, 50, 600, words)
    block = 512
    pad = -len(ia) % block
    ga = np.concatenate([a[ia], np.zeros((pad, words), np.uint32)])
    gb = np.concatenate([b[ib], np.zeros((pad, words), np.uint32)])
    want = np.asarray(jintersect_count(jnp.asarray(ga), jnp.asarray(gb),
                                       block=block, interpret=True))
    assert (want[len(ia):] == 0).all()
    got = intersect.row_and_popcount_plain(
        t32(a), torch.from_numpy(ia), t32(b), torch.from_numpy(ib))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[:len(ia)])


@pytest.mark.parametrize("words", [1, 3, 37, 64, 200])
def test_row_occupancy_plain_matches_brute_force(words):
    a = bitmaps(words, 30, words, 0.05)
    got = intersect.row_occupancy_plain(t32(a)).numpy().view(np.uint32)
    sw = intersect.summary_words(words)
    assert got.shape == (30, sw) and sw == -(-(-(-words // 4)) // 32)
    for r in range(30):
        for g in range(sw * 32):
            want = bool(a[r, 4 * g:4 * g + 4].any())  # empty past the row
            assert bool((got[r, g // 32] >> (g % 32)) & 1) == want


@pytest.mark.parametrize("order", ["shuffled", "repeated"])
@pytest.mark.parametrize("words", [1, 3, 37, 64])
def test_occupancy_pair_pass_matches_brute_force(words, order):
    a = bitmaps(words + 7, 70, words, 0.1)
    ia, ib = pairs(order, 70, 70, 400, words)
    want = np.bitwise_count(a[ia] & a[ib]).sum(axis=1)
    got = intersect.row_and_popcount_occupancy_plain(
        t32(a), torch.from_numpy(ia), t32(a), torch.from_numpy(ib))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    empty = torch.zeros(0, dtype=torch.int32)
    assert intersect.row_and_popcount_occupancy_plain(
        t32(a), empty, t32(a), empty).shape == (0,)
