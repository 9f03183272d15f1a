"""The overlay fold (`ops/spmv.py::overlay_fold`, K1's use on the delta
overlay) on the CPU, against the JAX package's fold.

* `overlay_fold_plain`, single and 3 lanes, in the three kinds the
  overlay apps fold (SSSP: float min with weights; WCC: int32 min; BFS:
  int32 min with one hop a slot, the INT32_MAX sentinel kept), against
  `libgrape_lite_tpu.app.base.AppBase.dyn_min_fold` -- the candidates
  built as the JAX models build them, then a segment min over `src` and
  `minimum` -- and against the port's former fold, `gather_reduce_plain`
  over the CSR of the overlay's sorted `src` plane then `torch.minimum`,
  bit for bit, at fnum 1, 2, 4 and 8;
* -0.0 and +0.0 mixed in x, the weights and the pull result: the plain
  fold orders -0.0 below +0.0 as the card's kernel does, bit-equal to
  the JAX fold (whose segment min and minimum pick -0.0 too);
* on tests/test_dyn.py's graph with its ADDS (and three more), an empty
  overlay, pad slots that point at real vertices with weights that would
  win, every slot in one row, and x full of the sentinel;
* the wrapper takes the plain version for CPU tensors, in place, counts
  no launch, and refuses what the kernel does not take.

Inputs are seeded numpy arrays.  The CUDA kernel runs only on the card:
chip_smoke.py holds it against this plain version, the old K1 path and
`scatter_reduce_` at RMAT-20 (4,096 slots), in lanes, on a star overlay
and with -0.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgrape_lite_tpu.app.base import AppBase as JAppBase
from libgrape_lite_tpu_torch.dyn import DeltaOverlay
from libgrape_lite_tpu_torch.ops import spmv
from tests.test_dyn import ADDS
from tests.test_torch_dyn import build_graph

torch.set_num_threads(1)

FNUMS = [1, 2, 4, 8]
SENT = np.iinfo(np.int32).max
KINDS = ["min+w", "int32 min", "bfs"]  # SSSP, WCC, BFS
LANES = [None, 3]  # x [N], or x [3, N]
CAP = 16
EXTRA_ADDS = [(5, 6, 0.25), (6, 5, 0.75), (31, 0, 1.5)]


def planes_of(ov):
    """The overlay's ie planes as numpy arrays: src, nbr, w (float32),
    mask."""
    ent = ov.entries("ie", np.float32)
    return {k.removeprefix("dyn_ie_"): v for k, v in ent.items()}


def from_adds(fnum):
    adds = [(int(s), int(d), float(w)) for _, s, d, w in ADDS] + EXTRA_ADDS
    frag = build_graph(fnum)
    ov, reason = DeltaOverlay.build(frag, adds, CAP)
    assert reason is None
    return frag.vp, planes_of(ov)


def empty(fnum):
    frag = build_graph(fnum)
    return frag.vp, planes_of(DeltaOverlay.empty(frag, CAP))


def with_live_pads(fnum):
    """ADDS' overlay with every pad slot pointing at a real vertex, with
    a weight that would win any min: the mask alone keeps them out."""
    vp, p = from_adds(fnum)
    rng = np.random.default_rng(fnum)
    pads = ~p["mask"]
    p["nbr"][pads] = rng.integers(0, fnum * vp, int(pads.sum()))
    p["w"][pads] = -1e6
    return vp, p


def one_row(fnum, vp=8):
    """Every slot of every fragment real and in one row (row 3 of
    fragment f), its neighbours spread over all fragments."""
    rng = np.random.default_rng(7 + fnum)
    src = np.full((fnum, CAP), 3, np.int32)
    nbr = rng.integers(0, fnum * vp, (fnum, CAP)).astype(np.int32)
    w = rng.uniform(0.1, 10.0, (fnum, CAP)).astype(np.float32)
    mask = np.ones((fnum, CAP), bool)
    return vp, dict(src=src, nbr=nbr, w=w, mask=mask)


SHAPES = {"adds": from_adds, "empty": empty, "live pads": with_live_pads,
          "one row": one_row}


def inputs(kind, lanes, n, rows, seed, all_sentinel=False):
    """x [N] or [lanes, N] and relaxed [..., *rows] of the kind's type:
    floats in [0, 50) with +inf, int32 depths / labels with the
    sentinel."""
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    out = []
    for shape in ((*lead, n), (*lead, *rows)):
        if kind == "min+w":
            a = rng.uniform(0, 50, shape).astype(np.float32)
            a[rng.random(shape) < 0.3] = np.inf
        else:
            a = rng.integers(0, 64, shape).astype(np.int32)
            a[rng.random(shape) < 0.3] = SENT
            if all_sentinel:
                a[...] = SENT
        out.append(a)
    return out


def jax_fold(p, x, relaxed, kind, vp):
    """AppBase.dyn_min_fold of the JAX package, per fragment and lane, on
    the candidates its SSSP / WCC / BFS build."""
    xs = x[None] if x.ndim == 1 else x
    rs = relaxed[None] if x.ndim == 1 else relaxed
    out = np.empty_like(rs)
    for b in range(xs.shape[0]):
        full = jnp.asarray(xs[b])
        for f in range(p["src"].shape[0]):
            mask = jnp.asarray(p["mask"][f])
            dv = full[jnp.asarray(p["nbr"][f])]
            if kind == "min+w":
                cand = jnp.where(mask, dv + jnp.asarray(p["w"][f]), jnp.inf)
            elif kind == "bfs":
                cand = jnp.where(jnp.logical_and(mask, dv != SENT), dv + 1,
                                 SENT)
            else:
                cand = jnp.where(mask, dv, SENT)
            out[b, f] = np.asarray(JAppBase.dyn_min_fold(
                jnp.asarray(rs[b, f]), {"dyn_ie_src": jnp.asarray(p["src"][f])},
                vp, "dyn_ie_", cand))
    return out[0] if x.ndim == 1 else out


def overlay_csr(t, vp):
    """The CSR [fnum, vp + 1] of the overlay's sorted `src` plane: each
    fragment's real slots come first, so it indexes the nbr / w planes."""
    fnum = t["src"].shape[0]
    indptr = torch.zeros((fnum, vp + 1), dtype=torch.int32)
    for f in range(fnum):
        rows = t["src"][f][t["mask"][f]].long()
        indptr[f, 1:] = torch.bincount(rows, minlength=vp).cumsum(0)
    return indptr


def k1_fold(t, x, relaxed, kind):
    """The port's former fold: K1's plain version over the overlay's CSR,
    BFS's hop after the row min, then torch.minimum."""
    w = t["w"] if kind == "min+w" else None
    xs = x.unsqueeze(0) if x.dim() == 1 else x
    extra = spmv.gather_reduce_lanes_plain(overlay_csr(t, relaxed.shape[-1]),
                                           t["nbr"], w, xs, "min")
    if kind == "bfs":
        extra = torch.where(extra != SENT, extra + 1, extra)
    return torch.minimum(relaxed, extra[0] if x.dim() == 1 else extra)


def fold_args(t, kind):
    w = t["w"] if kind == "min+w" else None
    return t["src"], t["nbr"], w, t["mask"]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("fnum", FNUMS)
def test_overlay_fold_plain_is_the_jax_fold_and_the_k1_fold(fnum, shape,
                                                            kind, lanes):
    vp, p = SHAPES[shape](fnum)
    x, relaxed = inputs(kind, lanes, fnum * vp, (fnum, vp),
                        seed=fnum * 10 + len(shape))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    xt, rt = torch.from_numpy(x), torch.from_numpy(relaxed)
    plus_one = kind == "bfs"
    dest = rt.clone()
    got = spmv.overlay_fold_plain(dest, *fold_args(t, kind), xt, plus_one)
    assert got is dest and got.dtype == xt.dtype  # in place
    assert got.shape == rt.shape
    assert got.numpy().tobytes() == jax_fold(p, x, relaxed, kind,
                                             vp).tobytes()
    assert got.numpy().tobytes() == k1_fold(t, xt, rt, kind).numpy().tobytes()
    if shape == "empty":
        assert torch.equal(got, rt)
    # the wrapper: the plain version for CPU tensors, no launch counted
    before = spmv.overlay_fold.launches
    again = spmv.overlay_fold(rt.clone(), *fold_args(t, kind), xt, plus_one)
    assert torch.equal(again, got)
    assert spmv.overlay_fold.launches == before


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("fnum", FNUMS)
def test_bfs_hop_keeps_the_sentinel(fnum, lanes):
    """x all INT32_MAX: no slot relaxes anything (no wrap to INT32_MIN),
    in the JAX fold as in the port."""
    vp, p = one_row(fnum)
    x, relaxed = inputs("bfs", lanes, fnum * vp, (fnum, vp), seed=fnum,
                        all_sentinel=True)
    relaxed[..., 3] = 5  # the folded row keeps its own value
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    rt = torch.from_numpy(relaxed)
    got = spmv.overlay_fold_plain(rt.clone(), *fold_args(t, "bfs"),
                                  torch.from_numpy(x), True)
    assert torch.equal(got, rt)
    assert got.numpy().tobytes() == jax_fold(p, x, relaxed, "bfs",
                                             vp).tobytes()


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("shape", ["adds", "one row"])
@pytest.mark.parametrize("fnum", FNUMS)
def test_signed_zeros_fold_as_the_kernel_and_jax_order_them(fnum, shape,
                                                            lanes):
    """x, the weights and the pull result mix -0.0 and +0.0 (x also small
    positives, the pull result also +inf): a row whose candidates or
    pull value hold a -0.0 folds to -0.0, whatever the slots' order --
    the card's `ordered_min` -- bit-equal to the JAX fold."""
    vp, p = SHAPES[shape](fnum)
    rng = np.random.default_rng(100 + fnum)
    lead = () if lanes is None else (lanes,)
    zeros = lambda shape: np.where(rng.random(shape) < 0.5, -0.0,
                                   0.0).astype(np.float32)
    p["w"] = np.where(p["mask"], zeros(p["w"].shape), p["w"]).astype(
        np.float32)
    x = np.where(rng.random((*lead, fnum * vp)) < 0.5,
                 zeros((*lead, fnum * vp)),
                 rng.uniform(0, 1, (*lead, fnum * vp))).astype(np.float32)
    relaxed = np.where(rng.random((*lead, fnum, vp)) < 0.5,
                       zeros((*lead, fnum, vp)), np.inf).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    rt = torch.from_numpy(relaxed)
    # one row: its slots in reverse order too
    orders = [t] + ([{k: v.flip(-1) for k, v in t.items()}]
                    if shape == "one row" else [])
    for tt in orders:
        got = spmv.overlay_fold_plain(rt.clone(), *fold_args(tt, "min+w"),
                                      torch.from_numpy(x))
        assert got.numpy().tobytes() == jax_fold(p, x, relaxed, "min+w",
                                                 vp).tobytes()
    signs = np.signbit(got.numpy()) & (got.numpy() == 0)
    assert signs.any()  # some row folded to -0.0
    assert torch.equal(got, k1_fold(t, torch.from_numpy(x), rt, "min+w"))


def test_overlay_fold_refuses_what_the_kernel_does_not_take():
    vp, p = from_adds(2)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    x, relaxed = inputs("min+w", None, 2 * vp, (2, vp), seed=1)
    xt, rt = torch.from_numpy(x), torch.from_numpy(relaxed)
    with pytest.raises(ValueError, match="int32 x takes no weights"):
        spmv.overlay_fold(rt.int(), t["src"], t["nbr"], t["w"], t["mask"],
                          xt.int(), False)
    with pytest.raises(ValueError, match="plus_one takes unweighted int32"):
        spmv.overlay_fold(rt, t["src"], t["nbr"], None, t["mask"], xt, True)
    meta = [v.to("meta") for v in (rt, t["src"], t["nbr"], t["w"],
                                   t["mask"], xt)]
    with pytest.raises(ValueError, match="unsupported device"):
        spmv.overlay_fold(*meta)
