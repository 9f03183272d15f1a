"""`kclique` on p2p-31 through the port's Worker, against the JAX Worker
on the same fragment, at k = 2, 3, 4 and 5: per-apex counts,
`total_cliques` and `used_device_kernel` equal.  k = 3 runs
`ApexTriangleCount`, k = 4 `KClique4Device` and k = 5 `KCliqueDevice`
(p2p-31's oriented out-degree, 14, fits every cap); k = 2 is the host
path.  Fragments are carried across from the JAX fragment and loaded by
the port's loader, at fnum 1, 2, 4 and 8; one JAX run per (k, fnum) is
shared through the module cache of tests/test_torch_apps_clique.py.
"""

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.worker.worker import Worker
from tests.test_torch_apps_clique import FNUMS, jax_run
from tests.test_torch_apps_peel import port_fragment

torch.set_num_threads(1)


@pytest.mark.parametrize("how", ["carried", "loaded"])
@pytest.mark.parametrize("fnum", FNUMS)
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_kclique_matches_jax(graph_cache, k, fnum, how):
    jfrag, japp, want = jax_run(graph_cache, f"kclique_{k}", fnum,
                                JREGISTRY["kclique"], k=k)
    w = Worker(APP_REGISTRY["kclique"](), port_fragment(jfrag, how, fnum))
    w.query(k=k)
    np.testing.assert_array_equal(w.result_values(), want)
    assert w.app.total_cliques == japp.total_cliques
    assert w.app.used_device_kernel == japp.used_device_kernel == (k > 2)
