"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface (`build/torch_kernels/lib<name>-<digest>.so`, the
digest covering the source and the flags), loaded with `ctypes`.  The
build runs at first use, never at import, so the package imports on a
machine without `nvcc`.  `build_all` starts one `nvcc` per source, all
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
#: ptxas resource report (registers, shared memory, spills) per source,
#: filled by the build that produced the library in this process
BUILD_LOG: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build only where the CUDA toolkit is installed"
    )


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every missing library concurrently; returns the seconds
    each build took (0.0 when it was already built).  Raises with the
    compiler's output when any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LOADED[name] = lib
    return lib
