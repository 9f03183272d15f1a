"""The SyncBuffer push apps (`sssp_auto`, `bfs_auto`, `wcc_auto`,
`pagerank_auto` with `pagerank_push` and `pagerank_push_opt`), `wcc_opt`,
`cdlp_opt` (with `cdlp_opt_ud` and `cdlp_opt_ud_dense`) and the PageRank
aliases (`pagerank_parallel`, `pagerank_opt`, `pagerank_directed`)
through the port's Worker, against the JAX Worker on the same fragment
and against the goldens (helpers in tests/test_torch_variants.py).

* bit-equal (float64 distances, int64 depths, component oids and
  community labels) with equal round counts; PageRank forms within
  1e-10 relative, the rule of tests/test_torch_apps.py (the port's
  kernels regroup float sums);
* carried and loaded fragments at fnum 1, 2, 4 and 8; directed runs of
  `wcc_auto`, `pagerank_auto` and `pagerank_directed`; `wcc_opt` on a
  512-vertex chain, where pointer jumping cuts the rounds.
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
    base_of,
    check_against_jax,
)

torch.set_num_threads(1)

SYNC = ["sssp_auto", "bfs_auto", "wcc_auto", "wcc_opt", "pagerank_auto",
        "pagerank_push", "pagerank_push_opt", "pagerank_parallel",
        "pagerank_opt", "pagerank_directed", "cdlp_opt", "cdlp_opt_ud",
        "cdlp_opt_ud_dense"]


def rtol_of(name):
    return 1e-10 if base_of(name) == "pagerank" else 0.0


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("name", SYNC)
def test_variant_matches_jax_and_golden(graph_cache, name, fnum, how):
    check_against_jax(graph_cache, name, fnum, how, rtol=rtol_of(name))


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("name", ["wcc_auto", "pagerank_auto",
                                  "pagerank_directed"])
def test_directed_variant_matches_jax(graph_cache, name, fnum):
    """Directed WCCAuto pushes along out- and in-edges from the same old
    labels; directed PageRank holds p2p-31-PR-directed."""
    check_against_jax(graph_cache, name, fnum, "carried", directed=True,
                      rtol=rtol_of(name))


def test_wcc_opt_chain_rounds():
    """On a 512-vertex chain, pointer jumping takes the JAX app's rounds,
    far fewer than plain propagation, to the same labels."""
    jfrag = _chain(512, 1.0, np.float64)
    frag = _carry(jfrag)
    rounds = {}
    for name in ("wcc", "wcc_opt"):
        jw = JWorker(JREGISTRY[name](), jfrag)
        jw.query()
        w = Worker(APP_REGISTRY[name](), frag)
        w.query()
        np.testing.assert_array_equal(w.result_values(), jw.result_values())
        assert w.rounds == jw.rounds
        rounds[name] = w.rounds
    assert rounds["wcc_opt"] * 4 < rounds["wcc"]
