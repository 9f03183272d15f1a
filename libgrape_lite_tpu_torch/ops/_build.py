"""Build, load and call the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface (`build/torch_kernels/lib<name>-<digest>.so`, the
digest covering the source and the flags), loaded with `ctypes`.  The
build runs at first use, never at import, so the package imports on a
machine without `nvcc`.  `build_all` starts one `nvcc` per source, all
at once.  Every library exports `grape_cuda_error_string`; the wrappers
check their arguments with `require` / `check_cuda_args` and each
launch's return code with `check_rc`, and count their launches with
`count_launch`.  Loading and counting take a lock: the serving pump runs
batches in threads of their own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Sequence
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
#: ptxas resource report (registers, shared memory, spills) per source,
#: filled by the build that produced the library in this process
BUILD_LOG: dict[str, str] = {}
#: libraries built or loaded in this process: a traced round during which
#: it moves is marked `compiled` (worker/worker.py)
LOAD_EVENTS = 0


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


def build_all(names: list[str] | None = None,
              missing_caps: Sequence[str] = ()) -> dict[str, float]:
    """Compile every missing library concurrently; returns the seconds
    each build took (0.0 when it was already built).  Raises with the
    compiler's output when any build fails, naming `missing_caps`: the
    capabilities the caller found this nvcc does not build
    (`caps.cuda_build_caps().missing()`)."""
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
        if missing_caps:
            failed.append("this nvcc does not build the capabilities "
                          f"{', '.join(missing_caps)} (ops/caps.py)")
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    global LOAD_EVENTS
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            LOAD_EVENTS += 1
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.grape_cuda_error_string.argtypes = [ctypes.c_int]
            lib.grape_cuda_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """One more launch of `wrapper`'s kernel (`wrapper.launches`)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda_args(name: str, device: torch.device, **tensors) -> None:
    """Every given tensor lies on `device` and is contiguous (None skips)."""
    for arg, t in tensors.items():
        if t is None:
            continue
        require(t.device == device,
                f"{name}: {arg} on {t.device}, expected {device}")
        require(t.is_contiguous(), f"{name}: {arg} must be contiguous")


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.grape_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
