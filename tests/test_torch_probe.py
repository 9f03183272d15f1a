"""The port's rate probe (`ops/probe.py`, `scripts/cuda_probe.py`) and
CUDA build-capability probe (`ops/caps.py`), on the CPU.

* The plain versions (the wrappers' CPU path) against the jnp functions
  that the Pallas bodies of `scripts/pallas_probe.py` apply, on seeded
  numpy inputs: `a * 2.0 + 1.0` (:66), `take_along_axis` on the broadcast
  128-entry table along axis 1 (:86-90) and on an S-row table along axis
  0 (:118-123), bit-equal; `jnp.cumsum(axis=1)` (:148) within 1e-5 of the
  prefix sum of |a| (the kernel adds in another order).
* The entry point at `--device cpu`: one line per case of the JAX script,
  in its order; its input check; `--device cuda` raising without CUDA.
* `cuda_build_caps()`: raises without nvcc; with a fake nvcc that fails on
  one probe source, that capability reads False and keeps its message,
  and a failed kernel build names the capabilities its caller found
  missing; the capability names are the JAX probe's.
* Importing the three modules loads neither jax, the JAX package nor
  triton.
"""

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgrape_lite_tpu.ops import pallas_kernels as jpallas
from libgrape_lite_tpu_torch.ops import _build, caps, probe
from libgrape_lite_tpu_torch.scripts import cuda_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def plane(seed, rows, lo=0.0):
    rng = np.random.default_rng(seed)
    return (lo + (1 - lo) * rng.random((rows, 128))).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 8, 64])
def test_stream_plain_matches_jax(rows):
    a = plane(rows, rows, lo=-4.0)
    want = np.asarray(jnp.asarray(a) * 2.0 + 1.0)
    got = probe.stream(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [1, 8, 64])
def test_lane_gather_plain_matches_jax(rows):
    rng = np.random.default_rng(10 + rows)
    tab = rng.random((8, 128)).astype(np.float32)
    idx = rng.integers(0, 128, size=(rows, 128)).astype(np.int32)
    tab_b = jnp.broadcast_to(jnp.asarray(tab)[0:1], idx.shape)
    want = np.asarray(jnp.take_along_axis(tab_b, jnp.asarray(idx), axis=1))
    got = probe.lane_gather_t128(torch.from_numpy(tab[0].copy()),
                                 torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [8, 64, 512, 8192])
def test_sublane_gather_plain_matches_jax(s):
    rng = np.random.default_rng(s)
    tab = rng.random((s, 128)).astype(np.float32)
    idx = rng.integers(0, s, size=(16, 128)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx),
                                          axis=0))
    got, where = probe.sublane_gather(torch.from_numpy(tab),
                                      torch.from_numpy(idx))
    assert where == "plain"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo", [0.0, -1.0])
@pytest.mark.parametrize("rows", [1, 32])
def test_cumsum_plain_matches_jax_within_prefix_tolerance(rows, lo):
    """|port - jnp.cumsum| <= CUMSUM_TOL (1e-5) x prefix sum of |a|: the
    kernel's order (4 in a lane, Hillis-Steele over 32 lanes) is not
    jnp's."""
    a = plane(100 + rows, rows, lo=lo)
    want = np.asarray(jnp.cumsum(jnp.asarray(a), axis=1)).astype(np.float64)
    got = probe.cumsum_lanes(torch.from_numpy(a)).numpy().astype(np.float64)
    prefix_abs = np.cumsum(np.abs(a.astype(np.float64)), axis=1)
    assert probe.CUMSUM_TOL == 1e-5
    assert (np.abs(got - want) <= probe.CUMSUM_TOL * prefix_abs).all()


def jax_case_names():
    """The case names scripts/pallas_probe.py emits, in its order."""
    src = open(os.path.join(REPO, "scripts", "pallas_probe.py")).read()
    sizes = re.search(r"for S in \(([\d, ]+)\)", src).group(1)
    names = []
    for m in re.finditer(r'emit\(\s*f?"([^"]+)"', src):
        name = m.group(1)
        if "{S}" in name:
            names += [name.replace("{S}", s.strip())
                      for s in sizes.split(",")]
        else:
            names.append(name)
    return names


def test_cli_cpu_prints_the_jax_cases_in_order(capsys):
    records = cuda_probe.main(["--device", "cpu", "--e_log", "12",
                               "--block", "8", "--iters", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["case"] for x in lines] == jax_case_names()
    assert list(cuda_probe.CASES) == jax_case_names()
    assert [r["case"] for r in records] == jax_case_names()
    for x in lines:
        assert x["device"] == "cpu"
        assert x["ms"] >= 0 and x["gelem_s"] >= 0
        assert ("placement" in x) == x["case"].startswith("sublane")
    assert {x["placement"] for x in lines if "placement" in x} == {"plain"}
    assert all(x["fits_l2"] for x in lines[:-1])  # 16 KiB planes


def test_cli_defaults_are_the_jax_scripts():
    args = cuda_probe.parse_args([])
    assert (args.e_log, args.block, args.iters, args.device) == (
        22, 512, 5, "cuda")


@pytest.mark.parametrize("e_log, block", [(12, 24), (12, 64), (12, 0)])
def test_cli_refuses_a_block_that_does_not_divide_the_rows(e_log, block):
    with pytest.raises(SystemExit) as exc:
        cuda_probe.parse_args(["--e_log", str(e_log), "--block", str(block),
                               "--device", "cpu"])
    assert exc.value.code != 0


def test_cli_cuda_default_raises_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.scripts.cuda_probe",
         "--e_log", "12", "--block", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower() and '"case"' not in r.stdout


@pytest.mark.parametrize("wrapper", probe.WRAPPERS,
                         ids=lambda f: f.__name__)
def test_wrappers_raise_off_the_cpu_and_cuda(wrapper):
    """No silent fallback: a tensor neither on the CPU nor on CUDA
    raises before any launch."""
    a = torch.empty(4, 128, device="meta")
    idx = torch.empty(4, 128, dtype=torch.int32, device="meta")
    args = {probe.stream: (a,), probe.cumsum_lanes: (a,),
            probe.lane_gather_t128: (torch.empty(128, device="meta"), idx),
            probe.sublane_gather: (a, idx)}[wrapper]
    before = wrapper.launches
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*args)
    assert wrapper.launches == before


@pytest.fixture
def fresh_caps():
    caps.cuda_build_caps.cache_clear()
    yield
    caps.cuda_build_caps.cache_clear()


def test_caps_raise_without_nvcc(fresh_caps, monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        caps.cuda_build_caps()


FAKE_NVCC = """#!/bin/sh
# writes the -o file unless the source's name is in FAKE_NVCC_FAIL
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift ;; *.cu) src="$1" ;; esac
  shift
done
name=$(basename "$src" .cu)
case ",$FAKE_NVCC_FAIL," in
  *",$name,"*) echo "$src(1): error: fake refusal of $name"; exit 2 ;;
esac
: > "$out"
"""


@pytest.fixture
def fake_nvcc(fresh_caps, monkeypatch, tmp_path):
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC)
    path.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(path))
    return monkeypatch


@pytest.mark.parametrize("failing", caps.CAPABILITIES)
def test_caps_report_a_failed_probe_with_its_message(fake_nvcc, failing):
    fake_nvcc.setenv("FAKE_NVCC_FAIL", failing)
    got = caps.cuda_build_caps()
    assert list(got) == list(caps.CAPABILITIES)
    assert {k for k, ok in got.items() if not ok} == {failing}
    assert got.missing() == [failing]
    assert f"fake refusal of {failing}" in got.log[failing]
    assert got.seconds >= 0
    assert caps.cuda_build_caps() is got  # cached per process


def test_build_failure_names_missing_capabilities(fake_nvcc, tmp_path):
    fake_nvcc.setenv("FAKE_NVCC_FAIL", "probe")
    fake_nvcc.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError) as exc:
        _build.build_all(["probe"], missing_caps=["mxu_dot"])
    msg = str(exc.value)
    assert "fake refusal of probe" in msg and "mxu_dot" in msg
    with pytest.raises(RuntimeError) as exc:
        _build.build_all(["probe"])
    assert "capabilities" not in str(exc.value)


def test_caps_names_are_the_jax_probes():
    jax_names = re.findall(r'probe\("(\w+)"', jpallas._CAP_PROBE)
    assert jax_names == list(caps.CAPABILITIES)
    for name in jax_names:
        assert (caps.CAPS_DIR / f"{name}.cu").is_file()
    # the probes sit outside the kernel libraries' csrc/*.cu glob
    assert not set(jax_names) & set(_build.sources())
    assert "probe" in _build.sources()


def test_probe_modules_import_no_jax_or_triton():
    code = (
        "import sys\n"
        "import libgrape_lite_tpu_torch.ops.caps\n"
        "import libgrape_lite_tpu_torch.ops.probe\n"
        "import libgrape_lite_tpu_torch.scripts.cuda_probe\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'libgrape_lite_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
