"""K1 with a lane axis (`gather_reduce_lanes`) after its Hopper redesign,
on the CPU.

The lane kernel keeps `gather_reduce`'s schedule on every lane -- the
merge partition, each thread's walk of 4 merge items, the block's
segmented scan and the carry fold in block order -- and changes how a
thread fetches its edges' lanes: vector loads from x laid out
lane-minor, rows padded to the vector width.  So its plain twins are
the single kernel's, one lane at a time (`gather_reduce_merge_plain`,
held against the JAX package in tests/test_torch_kernel_shapes.py),
and what is new is tested here:

* `lane_pitch` and `lane_minor`, the layout the kernel reads: every
  vector load aligned and inside its row, the lanes bit-equal to x, pad
  lanes zero, at k 2 to 64;
* the lane form's plain version (`gather_reduce_lanes_plain`) against
  the JAX package's XLA `segment_reduce` on each lane, on the star,
  empty-fragment and chain shapes of tests/test_torch_kernel_shapes.py,
  at fnum 1, 2 and 4 and k 2, 3 and 8 (lane groups of 2, 4 and 8):
  min / max / int32 sum bit-equal, float sums within 1e-5 of each row's
  sum of |terms|.

The CUDA kernel runs only on the card: chip_smoke.py holds every lane
bit-equal to k single `gather_reduce` calls and to these plain versions
at RMAT-20, k 1, 2, 3, 8 and 32.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu_torch.ops import spmv
from tests.test_torch_kernel_shapes import (
    INT32,
    SHAPES,
    SUM_TOL,
    jax_reduce,
    stacked,
    sum_abs,
)

torch.set_num_threads(1)

N = 96


@pytest.mark.parametrize("k", [2, 3, 4, 5, 8, 9, 31, 32, 33, 64])
def test_lane_pitch_and_layout(k):
    pitch = spmv.lane_pitch(k)
    vec = 2 if k == 2 else 4  # lanes a vector load brings
    assert k <= pitch < k + vec and pitch % vec == 0
    x = torch.from_numpy(
        np.random.default_rng(k).normal(size=(k, N)).astype(np.float32))
    xt = spmv.lane_minor(x, pitch)
    assert xt.shape == (N, pitch) and xt.is_contiguous()
    assert xt.stride(0) * xt.element_size() % (4 * vec) == 0
    assert xt[:, :k].numpy().tobytes() == x.t().contiguous().numpy().tobytes()
    assert (xt[:, k:] == 0).all()
    xi = x.view(torch.int32)
    assert torch.equal(spmv.lane_minor(xi, pitch)[:, :k], xi.t())


CASES = [("sum", False, False), ("sum", True, False), ("min", True, False),
         ("max", False, False), ("min", False, True), ("max", False, True),
         ("sum", False, True)]


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("fnum", [1, 2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_lane_form_matches_jax_on_shapes(shape, fnum, k):
    rows, cols = SHAPES[shape](N, fnum)
    indptr, nbr, w, src = stacked(rows, cols, N, fnum)
    vp = N // fnum
    rng = np.random.default_rng(fnum * 10 + k)
    xf = rng.normal(size=(k, N)).astype(np.float32)
    xi = rng.integers(INT32.min, INT32.max, (k, N),
                      dtype=np.int64).astype(np.int32)
    xs = rng.integers(-1000, 1000, (k, N)).astype(np.int32)  # no overflow
    ti, tn, tw = (torch.from_numpy(a) for a in (indptr, nbr, w))
    for kind, weighted, int32 in CASES:
        x = (xs if kind == "sum" else xi) if int32 else xf
        wt = w if weighted else None
        tx = torch.from_numpy(x)
        lanes = spmv.gather_reduce_lanes_plain(ti, tn, tw if weighted else None,
                                               tx, kind)
        assert lanes.shape == (k, fnum, vp) and lanes.dtype == tx.dtype
        for b in range(k):
            want = jax_reduce(x[b], nbr, wt, src, vp, kind)
            got = lanes[b].numpy()
            if kind == "sum" and not int32:
                tol = SUM_TOL * sum_abs(x[b], nbr, wt, src, vp)
                assert (np.abs(got.astype(np.float64) - want) <= tol).all()
            else:
                np.testing.assert_array_equal(got, want)
