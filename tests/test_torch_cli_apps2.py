"""The port's CLI on the CPU for the apps beyond the LDBC six, against
the JAX Worker's output files.

`python -m libgrape_lite_tpu_torch.cli --application <name> ... --device
cpu` writes the same bytes as `Worker.output` of the JAX package for the
same query, at fnum 1 and 4: `kcore --kcore_k 4`, `core_decomposition`,
`khop --khop_k 2` (source from --bfs_source), `triangle_count` and
`kclique` print integers; `bc` (--bc_source, default 0) runs its float64
state on the CPU, whose path counts are exact and whose dependency sums
come out bit-equal to the JAX package's on p2p-31.
"""

import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from tests.test_torch_cli import _jax_output, _port_cli

torch.set_num_threads(1)

# app -> (CLI flags, JAX constructor arguments, JAX query arguments)
CASES = {
    "kcore": (["--kcore_k", "4"], {}, {"k": 4}),
    "core_decomposition": ([], {}, {}),
    "bc": (["--bc_source", "6"], {}, {"source": 6}),
    "khop": (["--khop_k", "2", "--bfs_source", "6"], {"k": 2},
             {"source": 6}),
    "triangle_count": ([], {}, {}),
    "kclique": ([], {}, {"k": 3}),
}


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("app", list(CASES))
def test_cli_files_byte_identical_to_jax(tmp_path, graph_cache, app, fnum):
    flags, ctor, kw = CASES[app]
    got = _port_cli(tmp_path, app, fnum, *flags)
    want = _jax_output(tmp_path, graph_cache(fnum), JREGISTRY[app](**ctor),
                       **kw)
    assert got == want
    assert len(got) == fnum
