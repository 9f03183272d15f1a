"""The port's SpMV plain versions against the JAX package's Pallas
functions, run in interpret mode on the CPU.

* `gather_reduce_plain` vs `segment_reduce_pack(..., interpret=True)`
  (the pack-gather pipeline) at a tiny PackConfig on ~2 k edges: sum, min
  and max, with and without weights, with empty rows and +inf inputs.
  min/max are bit-equal; sum agrees to 1e-5 relative in float32 (the
  pipeline regroups float sums) and to 1e-12 in float64 against an
  `np.add.at` reference.
* the int32 sum (no weights; weights raise) of `gather_reduce_plain` and
  `gather_reduce_merge_plain` on four stacked fragments, one without
  edges, bit-equal to the JAX package's XLA `segment_reduce`.
* `spmv_strict_plain` vs `spmv_strict(..., interpret=True)` on the hub,
  uniform and mixed shapes of tests/test_spmv_strict.py and with pad
  edges; 1e-5 relative (the MXU product regroups the tile sums).

The CUDA kernels themselves cannot run here; chip_smoke.py holds them
against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgrape_lite_tpu.ops.segment import segment_reduce as jsegment_reduce
from libgrape_lite_tpu.ops.spmv import plan_tiles as jplan_tiles
from libgrape_lite_tpu.ops.spmv import spmv_strict as jspmv_strict
from libgrape_lite_tpu.ops.spmv_pack import (
    PackConfig,
    plan_pack,
    segment_reduce_pack,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.ops.segment import segment_reduce

torch.set_num_threads(1)

TINY = PackConfig(sub=16, out_sub=8, hub=128)
VP = 256


def _graph(seed=0, e=2000):
    """Row-sorted random edges over VP rows; rows >= 200 stay empty."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, 200, e))
    cols = rng.integers(0, VP, e)
    w = rng.uniform(0.1, 5.0, e).astype(np.float32)
    x = rng.normal(size=VP).astype(np.float32)
    x[rng.integers(0, VP, 20)] = np.inf  # unreached vertices (SSSP)
    return rows, cols, w, x


def _csr(rows, cols, w, pad=64):
    """Stacked [1, ...] CSR with `pad` trailing pad edges."""
    indptr = np.zeros(VP + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=VP), out=indptr[1:])
    nbr = np.concatenate([cols, np.zeros(pad, np.int64)]).astype(np.int32)
    wp = np.concatenate([w, np.full(pad, 7.0, np.float32)])
    return (torch.from_numpy(indptr[None]), torch.from_numpy(nbr[None]),
            torch.from_numpy(wp[None]))


@pytest.mark.parametrize("kind,weighted", [
    ("sum", False), ("sum", True), ("min", False), ("min", True),
    ("max", False), ("max", True),
])
def test_gather_reduce_plain_matches_pack_pipeline(kind, weighted):
    rows, cols, w, x = _graph()
    if kind == "sum":
        x = np.where(np.isinf(x), 1.5, x)  # the MXU scan wants finite sums
    plan = plan_pack(rows, cols, VP, VP, TINY,
                     edge_w=w if weighted else None)
    want = np.asarray(segment_reduce_pack(jnp.asarray(x), plan, kind,
                                          interpret=True))
    indptr, nbr, wt = _csr(rows, cols, w)
    got = spmv.gather_reduce_plain(indptr, nbr, wt if weighted else None,
                                   torch.from_numpy(x), kind)[0].numpy()
    assert got.dtype == np.float32 and got.shape == (VP,)
    if kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (got[200:] == 0).all()
    else:
        np.testing.assert_array_equal(got, want)
        ident = np.inf if kind == "min" else -np.inf
        assert (got[200:] == ident).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_reduce_plain_sum_float64_reference(weighted):
    rows, cols, w, x = _graph(seed=1)
    x = np.where(np.isinf(x), 2.0, x).astype(np.float64)
    w64 = w.astype(np.float64)
    want = np.zeros(VP)
    np.add.at(want, rows, x[cols] * (w64 if weighted else 1.0))
    indptr, nbr, wt = _csr(rows, cols, w)
    got = spmv.gather_reduce_plain(
        indptr, nbr, wt.double() if weighted else None,
        torch.from_numpy(x), "sum")[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_gather_reduce_plain_stacked_fragments():
    """fnum > 1: each fragment reads its own indptr row and edge block,
    and x is the pid-indexed state of every fragment."""
    parts = [_graph(seed=s, e=700 + 100 * s) for s in range(3)]
    ep = max(len(p[0]) for p in parts) + 32
    ind, nbrs = [], []
    for rows, cols, w, _ in parts:
        i, n, _ = _csr(rows, cols + VP * len(ind), w, pad=ep - len(rows))
        ind.append(i)
        nbrs.append(n)
    x = np.random.default_rng(9).normal(size=3 * VP)
    got = spmv.gather_reduce_plain(torch.cat(ind), torch.cat(nbrs), None,
                                   torch.from_numpy(x), "max").numpy()
    for f, (rows, cols, _, _) in enumerate(parts):
        want = np.full(VP, -np.inf)
        np.maximum.at(want, rows, x[cols + VP * f])
        np.testing.assert_array_equal(got[f], want)


@pytest.mark.parametrize("form", ["plain", "merge"])
def test_gather_reduce_int32_sum_stacked_fragments(form):
    """int32 sum over four stacked fragments (the peeling apps' counts):
    each fragment's rows equal the JAX segment_reduce of its edges, in
    int32; the fragment without edges holds 0."""
    parts = [_graph(seed=s, e=600 + 100 * s) for s in range(3)] + [None]
    ep = 1000
    ind, nbrs, srcs = [], [], []
    for f, part in enumerate(parts):
        rows, cols = ((part[0], part[1] + VP * f) if part is not None
                      else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        i, n, _ = _csr(rows, cols, np.ones(len(rows), np.float32),
                       pad=ep - len(rows))
        ind.append(i)
        nbrs.append(n)
        srcs.append(np.concatenate([rows, np.full(ep - len(rows), VP)]))
    x = np.random.default_rng(2).integers(0, 2, 4 * VP).astype(np.int32)
    args = (torch.cat(ind), torch.cat(nbrs), None, torch.from_numpy(x), "sum")
    got = (spmv.gather_reduce_plain(*args) if form == "plain"
           else spmv.gather_reduce_merge_plain(*args, 64))
    assert got.dtype == torch.int32
    for f in range(4):
        nbr = torch.cat(nbrs)[f].numpy()
        want = np.asarray(jsegment_reduce(jnp.asarray(x[nbr]),
                                          jnp.asarray(srcs[f]), VP, "sum"))
        np.testing.assert_array_equal(got[f].numpy(), want)
    assert (got[3] == 0).all()


def test_int32_sum_takes_no_weights():
    rows, cols, w, _ = _graph(seed=5)
    indptr, nbr, wt = _csr(rows, cols, w)
    x = torch.ones(VP, dtype=torch.int32)
    assert spmv.gather_reduce(indptr, nbr, None, x, "sum").dtype == torch.int32
    with pytest.raises(ValueError, match="int32 x takes no weights"):
        spmv.gather_reduce(indptr, nbr, wt, x, "sum")
    meta = [t.to("meta") for t in (indptr, nbr, wt, x)]
    with pytest.raises(ValueError, match="int32 x takes no weights"):
        spmv.gather_reduce(*meta, "sum")


def _strict_case(n_rows, degrees, seed=0):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n_rows), degrees).astype(np.int32)
    vals = rng.normal(size=len(src)).astype(np.float32)
    return src, vals


@pytest.mark.parametrize("shape", [
    ("hub", 8, [4000, 1000, 500, 100, 50, 20, 10, 4]),
    ("uniform", 64, [16] * 64),
    ("mixed", 32, [512] + [3] * 31),
], ids=lambda s: s[0])
def test_spmv_strict_plain_matches_pallas(shape):
    _, n_rows, degrees = shape
    src, vals = _strict_case(n_rows, degrees)
    vp, tile = n_rows + 1, 512  # one empty row checks the zero fill
    row_lo, rmax, _ = jplan_tiles(src, tile, vp)
    want = np.asarray(jspmv_strict(jnp.asarray(vals), jnp.asarray(src),
                                   row_lo, vp, tile, rmax, interpret=True))
    got = spmv.spmv_strict_plain(
        torch.from_numpy(vals[None]), torch.from_numpy(src[None]),
        torch.from_numpy(row_lo[None]), vp, tile, rmax)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = segment_reduce(torch.from_numpy(vals).double(),
                         torch.from_numpy(src), vp, "sum").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_spmv_strict_plain_pad_edges():
    """Pad edges (src == vp, value garbage masked to 0 by the caller)
    land only in the overflow row; tiles need not divide Ep."""
    src, vals = _strict_case(16, [32] * 16)
    vp = 16
    src_p = np.concatenate([src, np.full(100, vp, np.int32)])
    vals_p = np.concatenate([vals, np.zeros(100, np.float32)])
    row_lo, rmax, _ = spmv.plan_tiles(src_p, 256, vp)
    want = np.asarray(jspmv_strict(jnp.asarray(vals_p), jnp.asarray(src_p),
                                   row_lo, vp, 256, rmax, interpret=True))
    got = spmv.spmv_strict_plain(
        torch.from_numpy(vals_p[None]), torch.from_numpy(src_p[None]),
        torch.from_numpy(row_lo[None]), vp, 256, rmax)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plan_tiles_matches_jax():
    rng = np.random.default_rng(3)
    src = np.sort(rng.integers(0, 900, 5000)).astype(np.int32)
    src = np.concatenate([src, np.full(300, 1024, np.int32)])
    for tile in (128, 512, 2048):
        got, want = spmv.plan_tiles(src, tile, 1024), jplan_tiles(
            src, tile, 1024)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_wrappers_take_plain_version_only_on_cpu():
    rows, cols, w, x = _graph(seed=4)
    indptr, nbr, wt = _csr(rows, cols, w)
    before = spmv.gather_reduce.launches
    got = spmv.gather_reduce(indptr, nbr, wt, torch.from_numpy(x), "min")
    want = spmv.gather_reduce_plain(indptr, nbr, wt, torch.from_numpy(x),
                                    "min")
    assert torch.equal(got, want)
    assert spmv.gather_reduce.launches == before  # no kernel ran
    # any other device reaches neither the plain version nor a fallback
    meta = [t.to("meta") for t in (indptr, nbr, wt)]
    with pytest.raises(ValueError, match="unsupported device"):
        spmv.gather_reduce(*meta, torch.empty(VP, device="meta"), "sum")
    with pytest.raises(ValueError, match="unsupported device"):
        spmv.spmv_strict(torch.empty((1, 512), device="meta"),
                         torch.empty((1, 512), dtype=torch.int32,
                                     device="meta"),
                         torch.zeros((1, 1), dtype=torch.int32,
                                     device="meta"), VP, 512, 128)
    with pytest.raises(ValueError, match="unknown kind"):
        spmv.gather_reduce(indptr, nbr, None, torch.from_numpy(x), "prod")
