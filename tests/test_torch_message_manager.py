"""The port's message layer (`parallel/message_manager.py`,
`models/exchange_base.py`) against the JAX package's.

* `AllToAllMessageManager.exchange` on stacked `[fnum, M]` messages
  against the JAX `exchange` run under `shard_map`, element for element,
  receive buffers and overflow count, at fnum 2, 4 and 8, with and
  without overflow, on seeded numpy inputs;
* `AutoParallelMessageManager.sync` against the JAX `sync` (min, max and
  an integer-valued sum: exact);
* `plan_initial_capacity` equal on p2p-31;
* `exchange_relax` (the masked pull through the gather-reduce kernel's
  plain version here) equal to the literal route, `exchange` then a
  scatter-min, whose overflow vote fires exactly where the capacity is
  below the largest per-fragment-pair count that `exchange_relax` reports.
"""

import types
import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from libgrape_lite_tpu import compat
from libgrape_lite_tpu.parallel.comm_spec import FRAG_AXIS
from libgrape_lite_tpu.parallel.comm_spec import CommSpec as JCommSpec
from libgrape_lite_tpu.parallel.message_manager import (
    AllToAllMessageManager as JAllToAll,
)
from libgrape_lite_tpu.parallel.message_manager import (
    AutoParallelMessageManager as JAuto,
)
from libgrape_lite_tpu.parallel.message_manager import (
    plan_initial_capacity as jplan,
)
from libgrape_lite_tpu_torch.models.exchange_base import (
    dest_degree,
    exchange_relax,
    exchange_relax_plain,
)
from libgrape_lite_tpu_torch.parallel.message_manager import (
    AllToAllMessageManager,
    AutoParallelMessageManager,
    plan_initial_capacity,
)
from tests.test_torch_variants import _carry

torch.set_num_threads(1)

M = 300  # messages per fragment


def _shard(fn, fnum, n_in, n_sharded_out, n_replicated_out):
    return jax.jit(compat.shard_map(
        fn, mesh=JCommSpec(fnum=fnum).mesh,
        in_specs=(P(FRAG_AXIS),) * n_in,
        out_specs=(P(FRAG_AXIS),) * n_sharded_out + (P(),) * n_replicated_out,
        check_vma=False))


def _messages(fnum, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, fnum, (fnum, M)).astype(np.int32),
            rng.integers(0, 1 << 20, (fnum, M)).astype(np.int32),
            rng.standard_normal((fnum, M)),
            rng.random((fnum, M)) < 0.8)


@pytest.mark.parametrize("cap", [16, 400])
@pytest.mark.parametrize("fnum", [2, 4, 8])
def test_exchange_matches_jax(fnum, cap):
    dest, lid, pay, valid = _messages(fnum, 100 + fnum)

    def step(d, l, p, v):
        rl, rp, rv, ovf = JAllToAll.exchange(d[0], l[0], p[0], v[0], cap,
                                             fnum)
        return rl[None], rp[None], rv[None], ovf

    want = _shard(step, fnum, 4, 3, 1)(dest, lid, pay, valid)
    got = AllToAllMessageManager.exchange(
        *(torch.from_numpy(a) for a in (dest, lid, pay, valid)), cap, fnum)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(np.asarray(g).shape)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert (int(got[3]) > 0) == (cap == 16)


@pytest.mark.parametrize("fnum", [2, 4, 8])
def test_sync_matches_jax(fnum):
    vp = 64
    rng = np.random.default_rng(fnum)
    props = {k: rng.integers(-1000, 1000, (fnum, fnum * vp)).astype(
        np.float64) for k in "abc"}
    ops = {"a": "min", "b": "max", "c": "sum"}

    def step(a, b, c):
        out = JAuto.sync(types.SimpleNamespace(vp=vp),
                         {"a": a[0], "b": b[0], "c": c[0]}, ops)
        return tuple(out[k][None] for k in "abc")

    want = _shard(step, fnum, 3, 3, 0)(*(props[k] for k in "abc"))
    got = AutoParallelMessageManager.sync(
        types.SimpleNamespace(fnum=fnum, vp=vp),
        {k: torch.from_numpy(v) for k, v in props.items()}, ops)
    for k, w in zip("abc", want):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))


@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_plan_initial_capacity_matches_jax(graph_cache, fnum):
    jfrag = graph_cache(fnum)
    frag = _carry(jfrag)
    learned, jlearned = weakref.WeakKeyDictionary(), weakref.WeakKeyDictionary()
    assert plan_initial_capacity(frag, None, learned) == jplan(
        jfrag, None, jlearned) >= 1024
    assert plan_initial_capacity(frag, 5, learned) == jplan(jfrag, 5, {}) == 5
    learned[frag], jlearned[jfrag] = 4096, 4096
    assert plan_initial_capacity(frag, None, learned) == jplan(
        jfrag, None, jlearned) == 4096


def _relax_inputs(frag, seed, dtype):
    fnum, vp = frag.fnum, frag.vp
    gen = torch.Generator().manual_seed(seed)
    valid = (torch.rand(fnum, vp, generator=gen) < 0.3) & frag.dev.inner_mask
    if dtype == torch.int32:
        x = torch.randint(0, 1000, (fnum, vp), generator=gen,
                          dtype=torch.int32)
        return x, valid, None, None
    x = torch.rand(fnum, vp, generator=gen, dtype=dtype) * 100
    x = torch.where(torch.rand(fnum, vp, generator=gen) < 0.2,
                    torch.tensor(float("inf"), dtype=dtype), x)
    return x, valid, frag.dev.ie.edge_w.to(dtype), frag.dev.oe.edge_w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("fnum", [1, 2, 4, 8])
def test_exchange_relax_matches_the_literal_route(graph_cache, fnum, directed,
                                                  dtype):
    frag = _carry(graph_cache(fnum, directed=directed))
    x, valid, w_ie, w_oe = _relax_inputs(frag, fnum, dtype)
    deg = dest_degree(frag)
    got, sent = exchange_relax(frag.dev, x, valid, deg, w_ie)
    sent = int(sent)
    assert sent == int(torch.where(valid.unsqueeze(-1), deg, 0).sum(1).max())
    for cap in (sent, sent - 1):
        want, want_ovf = exchange_relax_plain(frag.dev, x, valid, cap, w_oe)
        # the literal exchange overflows exactly below the largest count
        assert (int(want_ovf) > 0) == (cap < sent)
        if cap == sent:
            assert got.dtype == want.dtype == dtype
            torch.testing.assert_close(got, want, rtol=0, atol=0)
