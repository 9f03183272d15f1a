"""The port's CLI on the CPU for the app variants, against the JAX
Worker's output files.

`python -m libgrape_lite_tpu_torch.cli --application <name> ... --device
cpu` runs the port's float32 state, as on the card.  For the min folds,
levels, labels and CDLP the result files are byte-identical to those
`Worker.output` of the JAX package writes for the same query (p2p-31's
integer weights sum exactly in float32); `pagerank_auto`'s agree with
them and with the golden within the golden rule (1e-4 relative), as
tests/test_torch_cli.py holds `pagerank`.  `sssp_select` goes through
`run_app`'s probe, which picks `sssp` on p2p-31.
"""

import pytest
import torch

from libgrape_lite_tpu.models import APP_REGISTRY as JREGISTRY
from tests.conftest import dataset_path
from tests.test_torch_cli import _jax_output, _port_cli
from tests.verifiers import (
    eps_verify,
    exact_verify,
    load_golden,
    load_result_lines,
    wcc_verify,
)

torch.set_num_threads(1)

# app -> (CLI flags, JAX query kwargs, golden, rule)
CASES = {
    "sssp_msg": (["--sssp_source", "6"], {"source": 6}, "p2p-31-SSSP",
                 exact_verify),
    "sssp_delta": (["--sssp_source", "6"], {"source": 6}, "p2p-31-SSSP",
                   exact_verify),
    "sssp_select": (["--sssp_source", "6"], {"source": 6}, "p2p-31-SSSP",
                    exact_verify),
    "bfs_opt": (["--bfs_source", "6"], {"source": 6}, "p2p-31-BFS",
                exact_verify),
    "wcc_auto": ([], {}, "p2p-31-WCC", wcc_verify),
    "cdlp_opt": (["--cdlp_mr", "10"], {"max_round": 10}, "p2p-31-CDLP",
                 exact_verify),
}


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("app", list(CASES))
def test_cli_files_byte_identical_to_jax(tmp_path, graph_cache, app, fnum):
    flags, kw, golden, verify = CASES[app]
    got = _port_cli(tmp_path, app, fnum, *flags)
    want = _jax_output(tmp_path, graph_cache(fnum), JREGISTRY[app](), **kw)
    assert got == want
    verify(load_result_lines("".join(got)),
           load_golden(dataset_path(golden)))


@pytest.mark.parametrize("fnum", [1, 4])
def test_cli_pagerank_auto_within_golden_rule(tmp_path, graph_cache, fnum):
    got = _port_cli(tmp_path, "pagerank_auto", fnum, "--pr_d", "0.85",
                    "--pr_mr", "10")
    want = _jax_output(tmp_path, graph_cache(fnum),
                       JREGISTRY["pagerank_auto"](), delta=0.85,
                       max_round=10)
    res = load_result_lines("".join(got))
    eps_verify(res, load_result_lines("".join(want)))
    eps_verify(res, load_golden(dataset_path("p2p-31-PR")))


def test_cli_directed_pagerank_push(tmp_path, graph_cache):
    """--directed reaches the SyncBuffer PageRank: p2p-31-PR-directed."""
    got = _port_cli(tmp_path, "pagerank_push", 2, "--directed")
    want = _jax_output(tmp_path, graph_cache(2, directed=True),
                       JREGISTRY["pagerank_push"](), delta=0.85,
                       max_round=10)
    res = load_result_lines("".join(got))
    eps_verify(res, load_result_lines("".join(want)))
    eps_verify(res, load_golden(dataset_path("p2p-31-PR-directed")))
