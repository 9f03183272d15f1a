"""`sssp_opt` / `sssp_delta` (near/far buckets) and `bfs_opt` (Beamer
push/pull) through the port's Worker, against the JAX Worker on the same
fragment and against the goldens (helpers in tests/test_torch_variants.py):
bit-equal values with equal `rounds`, `retries`, `final_capacity`,
`buckets`, `push_rounds` and `pull_rounds`, carried and loaded at fnum
1, 2, 4 and 8; forced overflow; the round limit of `Worker.query`; and
the tiny-delta chain whose bucket advance must clamp in float32.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.test_torch_variants import (
    FNUMS,
    _carry,
    _chain,
    check_against_jax,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", ["sssp_opt", "sssp_delta", "bfs_opt"])
def test_variant_matches_jax_and_golden(graph_cache, name, fnum, how):
    app = check_against_jax(graph_cache, name, fnum, how)
    if name == "bfs_opt":  # p2p-31 from vertex 6 takes both directions
        assert app.push_rounds > 0 and app.pull_rounds > 0
    else:
        assert app.buckets > 0


@pytest.mark.parametrize("name", ["sssp_delta", "bfs_opt"])
def test_forced_overflow_retries_like_jax(graph_cache, name):
    """A capacity of 8 overflows from the first rounds on.  The JAX app
    discards each overflowed round and reruns it with the capacity
    doubled; the port keeps the round and counts the same doublings, so
    retries and the settled capacity are equal."""
    app = check_against_jax(graph_cache, name, 2, "carried",
                            initial_capacity=8)
    assert app.retries > 0


def test_sssp_delta_tiny_delta_terminates():
    """With a delta far below float32's spacing at the working distances
    (~2e5), the bucket arithmetic rounds back to the old threshold; the
    advance clamps to the next float32 value, as in the JAX app
    (tests/test_frontier_opt.py), and the query ends with its rounds
    and bucket advances."""
    jfrag = _chain(5, 1.0e5, np.float32)
    japp = JREGISTRY["sssp_delta"](delta=1e-3)
    jw = JWorker(japp, jfrag)
    jw.query(source=0)
    app = APP_REGISTRY["sssp_delta"](delta=1e-3, dtype=torch.float32)
    w = Worker(app, _carry(jfrag))
    w.query(source=0)
    got = w.result_values()[0, :5]
    np.testing.assert_array_equal(got, [0, 1e5, 2e5, 3e5, 4e5])
    np.testing.assert_array_equal(got, np.asarray(jw.result_values())[0, :5])
    assert (w.rounds, app.buckets) == (jw.rounds, japp.buckets)
    assert app.buckets > 0


def test_round_limit_matches_jax(graph_cache):
    """`Worker.query(max_rounds=...)` bounds a host-driven loop as it
    bounds the JAX app's: the same rounds, counters and partial depths."""
    jfrag = graph_cache(4)
    japp = JREGISTRY["bfs_opt"]()
    jw = JWorker(japp, jfrag)
    jw.query(max_rounds=3, source=6)
    app = APP_REGISTRY["bfs_opt"]()
    w = Worker(app, _carry(jfrag))
    w.query(max_rounds=3, source=6)
    assert w.rounds == jw.rounds == 3
    assert (app.push_rounds, app.pull_rounds, app.retries) == (
        japp.push_rounds, japp.pull_rounds, japp.retries)
    np.testing.assert_array_equal(w.result_values(), jw.result_values())
