"""The port's CLI on the CPU against the JAX Worker's output files.

`python -m libgrape_lite_tpu_torch.cli ... --device cpu` writes
`result_frag_<fid>` files.  For SSSP they are byte-identical to those
`Worker.output` of the JAX package writes for the same query; for
PageRank they agree within the golden rule (1e-4 relative).  Without
`--device` the CLI asks for CUDA and fails when it is absent.
"""

import os

import pytest
import torch

from libgrape_lite_tpu.models import PageRank as JPageRank
from libgrape_lite_tpu.models import SSSP as JSSSP
from libgrape_lite_tpu.worker.worker import Worker as JWorker
from libgrape_lite_tpu_torch import cli
from tests.conftest import dataset_path
from tests.verifiers import eps_verify, load_golden, load_result_lines

torch.set_num_threads(1)


def _read(prefix, fnum):
    out = []
    for f in range(fnum):
        with open(os.path.join(prefix, f"result_frag_{f}")) as fh:
            out.append(fh.read())
    return out


def _port_cli(tmp_path, app, fnum, *extra):
    prefix = str(tmp_path / "port")
    cli.main([
        "--application", app, "--efile", dataset_path("p2p-31.e"),
        "--vfile", dataset_path("p2p-31.v"), "--out_prefix", prefix,
        "--fnum", str(fnum), "--device", "cpu", *extra,
    ])
    return _read(prefix, fnum)


def _jax_output(tmp_path, frag, app, **kw):
    prefix = str(tmp_path / "jax")
    w = JWorker(app, frag)
    w.query(**kw)
    w.output(prefix)
    return _read(prefix, frag.fnum)


@pytest.mark.parametrize("fnum", [1, 4])
def test_cli_sssp_files_byte_identical(tmp_path, graph_cache, fnum):
    got = _port_cli(tmp_path, "sssp", fnum, "--sssp_source", "6")
    want = _jax_output(tmp_path, graph_cache(fnum), JSSSP(), source=6)
    assert got == want


@pytest.mark.parametrize("fnum", [1, 4])
def test_cli_pagerank_files_within_golden_rule(tmp_path, graph_cache, fnum):
    got = _port_cli(tmp_path, "pagerank", fnum, "--pr_d", "0.85",
                    "--pr_mr", "10")
    want = _jax_output(tmp_path, graph_cache(fnum), JPageRank(),
                       delta=0.85, max_round=10)
    res = load_result_lines("".join(got))
    eps_verify(res, load_result_lines("".join(want)))
    eps_verify(res, load_golden(dataset_path("p2p-31-PR")))


def test_cli_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--application", "sssp",
                  "--efile", dataset_path("p2p-31.e"),
                  "--out_prefix", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()
