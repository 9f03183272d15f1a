"""`run_app`'s ft/ and guard/ flags on the port's CLI (`--checkpoint_every`,
`--checkpoint_dir`, `--resume`, `--guard`), on the CPU with
`dataset/p2p-31.*`, held against the JAX CLI's behaviour:

* a checkpointed run writes files byte-identical to the plain run;
* `--resume` after a `GRAPE_FT_FAULTS=kill@4,mode=raise` run writes files
  byte-identical to the plain run's;
* `--guard halt` under `corrupt_carry@4` exits 1, as the JAX CLI does (its
  InvariantBreachError leaves `main`); `--guard rollback` heals;
* the flag checks raise the JAX CLI's errors before the load;
* `libgrape_lite_tpu_torch/scripts/fault_drill.py --apps sssp` passes in a
  subprocess at `--device cpu` (three CLI runs, ~15 s on one core), its
  `--kill_rank` mode exits 2 for an app that does not run across processes
  yet, and `--postmortem` runs the guarded fleet's drill.
"""

import os
import subprocess
import sys

import pytest
import torch

from libgrape_lite_tpu_torch import cli
from libgrape_lite_tpu_torch.ft.checkpoint import list_checkpoints
from libgrape_lite_tpu_torch.ft.faults import InjectedFault
from tests.conftest import dataset_path
from tests.test_torch_cli import _read

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP_FLAGS = {"sssp": ["--sssp_source", "6"], "pagerank": ["--pr_mr", "10"],
             "wcc": []}


def _argv(app, prefix, fnum=2, *extra):
    return ["--application", app, "--efile", dataset_path("p2p-31.e"),
            "--vfile", dataset_path("p2p-31.v"), "--out_prefix", prefix,
            "--fnum", str(fnum), "--device", "cpu", *APP_FLAGS[app], *extra]


def _run(tmp_path, name, app, *extra):
    prefix = str(tmp_path / name)
    assert cli.main(_argv(app, prefix, 2, *extra)) == 0
    return _read(prefix, 2)


@pytest.fixture(autouse=True)
def _no_ambient_faults(monkeypatch):
    for k in ("GRAPE_FT_FAULTS", "GRAPE_GUARD", "GRAPE_POSTMORTEM"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_checkpointed_run_files_byte_identical(tmp_path, app):
    plain = _run(tmp_path, "plain", app)
    d = str(tmp_path / "ck")
    got = _run(tmp_path, "ck_out", app, "--checkpoint_every", "2",
               "--checkpoint_dir", d)
    assert got == plain
    assert len(list_checkpoints(d)) == 2


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_resume_after_kill_files_byte_identical(tmp_path, monkeypatch, app):
    plain = _run(tmp_path, "plain", app)
    d = str(tmp_path / "ck")
    monkeypatch.setenv("GRAPE_FT_FAULTS", "kill@4,mode=raise")
    with pytest.raises(InjectedFault):
        _run(tmp_path, "killed", app, "--checkpoint_every", "2",
             "--checkpoint_dir", d)
    assert not os.path.exists(str(tmp_path / "killed"))
    monkeypatch.delenv("GRAPE_FT_FAULTS")
    assert _run(tmp_path, "resumed", app, "--resume",
                "--checkpoint_dir", d) == plain


def test_guard_halt_exits_as_the_jax_cli(tmp_path, monkeypatch):
    from libgrape_lite_tpu import cli as jcli
    from libgrape_lite_tpu.guard import InvariantBreachError as JBreach

    argv = _argv("sssp", str(tmp_path / "out"), 2, "--guard", "halt")
    env = dict(os.environ, GRAPE_FT_FAULTS="corrupt_carry@4")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run([sys.executable, "-m", "libgrape_lite_tpu_torch.cli",
                        *argv], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1, r.stderr
    assert "invariant breach at superstep 4" in r.stderr
    assert "InvariantBreachError" in r.stderr
    assert not os.path.exists(str(tmp_path / "out"))
    # the JAX CLI's halt is the same exception out of main: exit 1
    monkeypatch.setenv("GRAPE_FT_FAULTS", "corrupt_carry@4")
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(JBreach) as ei:
        jcli.main(jargv)
    assert ei.value.bundle["round"] == 4


def test_guard_rollback_heals(tmp_path, monkeypatch):
    plain = _run(tmp_path, "plain", "wcc")
    monkeypatch.setenv("GRAPE_FT_FAULTS", "corrupt_carry@4")
    assert _run(tmp_path, "healed", "wcc", "--checkpoint_every", "2",
                "--checkpoint_dir", str(tmp_path / "ck"),
                "--guard", "rollback") == plain


def test_flag_checks_match_the_jax_cli(tmp_path, capsys):
    from libgrape_lite_tpu.runner import QueryArgs as JArgs
    from libgrape_lite_tpu.runner import run_app as jrun
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    for bad in (dict(checkpoint_every=2), dict(resume=True),
                dict(checkpoint_dir=str(tmp_path / "d"))):
        with pytest.raises(ValueError) as ep:
            run_app(QueryArgs(application="sssp", efile="/nonexistent",
                              device="cpu", **bad))
        with pytest.raises(ValueError) as ej:
            jrun(JArgs(application="sssp", efile="/nonexistent", **bad))
        assert str(ep.value) == str(ej.value)
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv("sssp", str(tmp_path / "o"), 1, "--guard", "panic"))
    assert exc.value.code == 2
    assert "--guard" in capsys.readouterr().err


def test_fault_drill_passes_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.scripts.fault_drill",
         "--apps", "sssp", "--device", "cpu", "--workdir",
         str(tmp_path / "drill")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[sssp] PASS: killed at superstep 4 (exit 17" in r.stdout
    assert "fault_drill: PASS" in r.stdout


@pytest.mark.parametrize("flag,item", [("--postmortem", "item 6"),
                                       ("--kill_rank", "item 8")])
def test_fault_drill_unported_modes_exit_2(capsys, tmp_path, flag, item):
    """Both modes exited 2 until their slices were ported: `--postmortem`
    now runs its drill (every poisoned query fails alone and each bundle
    joins the trace); `--kill_rank` runs its gangs (the full drill is a
    slow test in test_torch_dist_ft.py), and a vertex-cut name, which now
    runs across processes too, exits 2 as not among its apps (the drill
    reshards onto fnum 2, which a vertex-cut lineage refuses)."""
    from libgrape_lite_tpu_torch.scripts import fault_drill

    if flag == "--postmortem":
        assert fault_drill.main([flag, "--device", "cpu", "--workdir",
                                 str(tmp_path / "drill")]) == 0
        assert "[postmortem] PASS" in capsys.readouterr().out
        return
    assert fault_drill.main([flag, "--apps", "sssp_vc", "--device", "cpu",
                             "--workdir", str(tmp_path / "drill")]) == 2
    err = capsys.readouterr().err
    assert "not among its apps" in err and flag in err and "sssp_vc" in err
    assert "ROADMAP" not in err
    assert not (tmp_path / "drill").exists()  # declined before any run
