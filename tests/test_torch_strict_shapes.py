"""The strict-tile kernel's schedule (K2) on the shapes that break a tile
schedule, and the sublane gather's table placement, on the CPU.

* `spmv_strict_segments_plain` (the kernel's order: per-tile segment
  sums in edge order, boundary carries folded in tile order) against
  the JAX package's `spmv_strict(..., interpret=True)` and its XLA
  `segment_reduce`, per fragment, on a star, a stack with an edgeless
  fragment, a degree-1 chain, pads past every fragment (garbage values:
  pads credit nothing) and the hub / uniform / mixed shapes of
  tests/test_spmv_strict.py, at tiles of 128, 512 and 2048 and fnum 1,
  2 and 4: float32 within 1e-5 of each row's sum of |terms|, float64
  against the port's JAX-order `spmv_strict_plain` within 1e-12.
* Every carry of `strict_tile_carries_plain` lies on a tile boundary,
  and every row that crosses one leaves a carry on both sides.
* `probe.sublane_plan`: the slice width divides 128 and fits the
  opt-in; S8 and S64 stay "shared"; a table too large for a 4-column
  slice is refused.

Inputs are seeded numpy arrays.  The CUDA kernels run only on the card:
chip_smoke.py holds them against these plain versions at full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgrape_lite_tpu.ops.segment import segment_reduce as jsegment_reduce
from libgrape_lite_tpu.ops.spmv import plan_tiles as jplan_tiles
from libgrape_lite_tpu.ops.spmv import spmv_strict as jspmv_strict
from libgrape_lite_tpu_torch.ops import probe, spmv

torch.set_num_threads(1)

SUM_TOL = 1e-5
F64_TOL = 1e-12
PAD_VALUE = 7.7  # pads credit nothing, whatever they hold


def degrees(shape, n, fnum, rng):
    """In-degree of each of n rows (rows are sorted, so edges run row by
    row)."""
    deg = np.zeros(n, np.int64)
    if shape == "star":  # one hub row spanning many tiles, then leaves
        deg[0], deg[1:] = 3 * n, 1
    elif shape == "edgeless":  # the last fragment (all at fnum 1) empty
        deg[:] = rng.integers(0, 8, n)
        deg[(fnum - 1) * (n // fnum):] = 0
    elif shape == "chain":  # every edge its own row; row 0 none
        deg[1:] = 1
    elif shape == "pad":  # a long pad gap after every fragment
        deg[:] = rng.integers(0, 4, n)
    elif shape == "hub":
        deg[:8] = [4000, 1000, 500, 100, 50, 20, 10, 4]
    elif shape == "uniform":
        deg[:] = 16
    elif shape == "mixed":
        deg[0], deg[1:] = 512, 3
    return deg


SHAPES = ["star", "edgeless", "chain", "pad", "hub", "uniform", "mixed"]


def strict_case(shape, fnum, seed=0):
    """Stacked [fnum, ep] values and row ids (pid = f * vp + lid), pads
    (src = vp) after each fragment's edges; returns values, src and the
    per-fragment real edge counts."""
    rng = np.random.default_rng(seed)
    n = 2400 if shape in ("star", "chain", "pad") else 48
    n -= n % fnum
    vp = n // fnum
    deg = degrees(shape, n, fnum, rng).reshape(fnum, vp)
    counts = deg.sum(1)
    pad = 1037 if shape == "pad" else 5
    ep = int(counts.max()) + pad
    values = np.full((fnum, ep), PAD_VALUE, np.float32)
    src = np.full((fnum, ep), vp, np.int32)
    for f in range(fnum):
        k = int(counts[f])
        src[f, :k] = np.repeat(np.arange(vp), deg[f])
        values[f, :k] = rng.normal(size=k)
    return values, src, counts, vp


def row_abs_sums(values, src, vp):
    out = np.zeros((values.shape[0], vp + 1))
    for f in range(values.shape[0]):
        np.add.at(out[f], src[f], np.abs(values[f].astype(np.float64)))
    return out[:, :vp]


def torch_plan(src, tile, vp):
    """The stacked plan as plan_for_app builds it: per-fragment
    plan_tiles, the widest rmax."""
    plans = [spmv.plan_tiles(s, tile, vp) for s in src]
    return (torch.from_numpy(np.stack([p[0] for p in plans])),
            max(p[1] for p in plans))


@pytest.mark.parametrize("tile", [128, 512, 2048])
@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_segments_twin_matches_jax_strict_and_segment_reduce(shape, fnum,
                                                              tile):
    values, src, counts, vp = strict_case(shape, fnum)
    row_lo, rmax = torch_plan(src, tile, vp)
    got = spmv.spmv_strict_segments_plain(
        torch.from_numpy(values), torch.from_numpy(src), row_lo, vp, tile,
        rmax).numpy()
    assert got.dtype == np.float32 and got.shape == (fnum, vp)
    bound = SUM_TOL * row_abs_sums(values, src, vp)
    masked = np.where(src < vp, values, 0).astype(np.float32)
    for f in range(fnum):
        # the JAX kernel takes pads masked to 0, as its callers pass them
        jlo, jrmax, _ = jplan_tiles(src[f], tile, vp)
        want = np.asarray(jspmv_strict(jnp.asarray(masked[f]),
                                       jnp.asarray(src[f]), jlo, vp, tile,
                                       jrmax, interpret=True))
        ref = np.asarray(jsegment_reduce(jnp.asarray(values[f]),
                                         jnp.asarray(src[f]), vp, "sum"))
        for name, w in (("pallas", want), ("segment_reduce", ref)):
            err = np.abs(got[f].astype(np.float64) - w)
            assert (err <= bound[f]).all(), (name, f, float(err.max()))
    if shape == "edgeless" and fnum > 1:
        assert counts[-1] == 0 and not got[-1].any()


@pytest.mark.parametrize("tile", [128, 512, 2048])
@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_segments_twin_float64_matches_jax_order(shape, fnum, tile):
    values, src, _, vp = strict_case(shape, fnum, seed=1)
    row_lo, rmax = torch_plan(src, tile, vp)
    v64 = torch.from_numpy(values.astype(np.float64))
    args = (torch.from_numpy(src), row_lo, vp, tile, rmax)
    got = spmv.spmv_strict_segments_plain(v64, *args).numpy()
    want = spmv.spmv_strict_plain(v64, *args).numpy()
    assert (np.abs(got - want) <= F64_TOL * row_abs_sums(values, src, vp)
            ).all()


@pytest.mark.parametrize("tile", [128, 512, 2048])
@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_carries_lie_on_tile_boundaries(shape, fnum, tile):
    values, src, _, vp = strict_case(shape, fnum, seed=2)
    ep = src.shape[1]
    _, crow, cval = spmv.strict_tile_carries_plain(
        torch.from_numpy(values), torch.from_numpy(src), vp, tile)
    crow, cval = crow.numpy(), cval.numpy()
    num_tiles = -(-ep // tile)
    assert crow.shape == (fnum, num_tiles, 2)
    for f in range(fnum):
        for t in range(num_tiles):
            e0, e1 = t * tile, min((t + 1) * tile, ep)
            for side, (inside, outside) in enumerate(
                    ((e0, e0 - 1), (e1 - 1, e1))):
                crosses = (0 <= outside < ep and src[f, inside] < vp
                           and src[f, outside] == src[f, inside])
                if crosses:  # the crossing row, as a pid
                    assert crow[f, t, side] == f * vp + src[f, inside]
                else:
                    assert crow[f, t, side] == -1 and cval[f, t, side] == 0
            if crow[f, t, 0] >= 0 and crow[f, t, 0] == crow[f, t, 1]:
                assert cval[f, t, 1] == 0  # a tile inside one row
    # the carries of a row form one run in tile order
    flat = crow.reshape(-1)
    starts = [k for i, k in enumerate(flat)
              if k >= 0 and (i == 0 or flat[i - 1] != k)]
    assert len(starts) == len(set(starts))
    if shape == "star":
        assert (flat == 0).sum() >= 2 * (3 * 2400 // fnum // tile) - 2


@pytest.mark.parametrize("optin", [232_448, 101_376, 49_152])
@pytest.mark.parametrize("s", [8, 64, 512, 8192, 14_528, 60_000])
def test_sublane_plan_slices(s, optin):
    if s * 16 > optin:  # not even a 4-column slice fits: refused
        with pytest.raises(ValueError, match="opt-in"):
            probe.sublane_plan(s, optin)
        return
    placement, c = probe.sublane_plan(s, optin)
    if s * 512 <= optin:
        assert (placement, c) == ("shared", 128)
    else:
        assert placement == "sliced" and 4 <= c < 128 and 128 % c == 0
        assert s * c * 4 <= optin < s * 2 * c * 4  # the widest that fits
    if optin == 232_448:  # an H100's opt-in
        assert placement == {8: "shared", 64: "shared", 512: "sliced",
                             8192: "sliced", 14_528: "sliced"}[s]
        assert c == {512: 64, 8192: 4}.get(s, c)
