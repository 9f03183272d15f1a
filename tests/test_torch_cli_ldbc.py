"""The port's CLI on the CPU for BFS, WCC, CDLP and the LCCs, against the
JAX Worker's output files.

`python -m libgrape_lite_tpu_torch.cli --application <app> ... --device
cpu` writes `result_frag_<fid>` files; for these apps they are
byte-identical to those `Worker.output` of the JAX package writes for
the same query (every value is bit-equal), and they pass the goldens.
The flags `--bfs_source`, `--cdlp_mr` and `--degree_threshold` dispatch
as the JAX package's `build_query_kwargs` does.
"""

import pytest
import torch

from libgrape_lite_tpu.models import BFS as JBFS
from libgrape_lite_tpu.models import CDLP as JCDLP
from libgrape_lite_tpu.models import LCC as JLCC
from libgrape_lite_tpu.models import WCC as JWCC
from libgrape_lite_tpu.models import LCCBeta as JLCCBeta
from libgrape_lite_tpu.models import LCCDirected as JLCCDirected
from libgrape_lite_tpu.runner import QueryArgs as JQueryArgs
from libgrape_lite_tpu.runner import build_query_kwargs as jbuild
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.runner import QueryArgs, build_query_kwargs
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

# app -> (CLI flags, JAX app, JAX query kwargs, golden, rule)
CASES = {
    "bfs": (["--bfs_source", "6"], JBFS, {"source": 6}, "p2p-31-BFS",
            exact_verify),
    "wcc": ([], JWCC, {}, "p2p-31-WCC", wcc_verify),
    "cdlp": (["--cdlp_mr", "10"], JCDLP, {"max_round": 10}, "p2p-31-CDLP",
             exact_verify),
    "lcc": ([], JLCCBeta, {}, "p2p-31-LCC", eps_verify),
}


@pytest.mark.parametrize("fnum", [1, 4])
@pytest.mark.parametrize("app", list(CASES))
def test_cli_files_byte_identical_to_jax(tmp_path, graph_cache, app, fnum):
    flags, jcls, kw, golden, verify = CASES[app]
    got = _port_cli(tmp_path, app, fnum, *flags)
    want = _jax_output(tmp_path, graph_cache(fnum), jcls(), **kw)
    assert got == want
    verify(load_result_lines("".join(got)),
           load_golden(dataset_path(golden)))


def test_cli_flags_reach_the_apps(tmp_path, graph_cache):
    """--degree_threshold on lcc_bitmap, --directed on lcc_directed and a
    short --cdlp_mr run, each byte-identical to the JAX output."""
    got = _port_cli(tmp_path / "a", "lcc_bitmap", 2, "--degree_threshold",
                    "5")
    assert got == _jax_output(tmp_path / "a", graph_cache(2), JLCC(),
                              degree_threshold=5)
    got = _port_cli(tmp_path / "b", "lcc_directed", 2, "--directed")
    assert got == _jax_output(tmp_path / "b", graph_cache(2, directed=True),
                              JLCCDirected())
    got = _port_cli(tmp_path / "c", "cdlp_auto", 2, "--cdlp_mr", "3")
    assert got == _jax_output(tmp_path / "c", graph_cache(2), JCDLP(),
                              max_round=3)


def test_query_kwargs_match_jax():
    flags = dict(sssp_source="6", bfs_source="12", pr_d=0.8, pr_mr=7,
                 cdlp_mr=4, degree_threshold=9)
    for name in APP_REGISTRY:
        assert build_query_kwargs(name, QueryArgs(**flags)) == jbuild(
            name, JQueryArgs(**flags)), name
