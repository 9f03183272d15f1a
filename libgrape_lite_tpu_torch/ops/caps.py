"""Which primitives this CUDA toolchain builds for the card.

Counterpart of the JAX package's offline lowering probe
(`libgrape_lite_tpu/ops/pallas_kernels.py::mosaic_lowering_caps`), which
lowers four small Pallas kernels for the TPU without running them.  Here
one probe source per capability (`csrc/caps/<name>.cu`) is compiled by
`nvcc` with the kernels' own flags (`_build.NVCC_FLAGS`, `sm_90a`) into
an object that is thrown away: nothing is launched and no card is
needed.  The four capabilities keep the JAX probe's names:

    sublane_gather  x[idx[i, j], j] from a shared-memory table (int16 idx)
    lane_gather     x[i, idx[i, j]] across a warp by __shfl_sync (int8 idx)
    int_reduce      an int32 row sum by __reduce_add_sync, added to f32
    mxu_dot         a [128, 128] @ [128, 128] tf32 product by
                    wgmma.mma_async, which exists only for sm_90a

Where `nvcc` is missing, `cuda_build_caps()` raises with
`_build.nvcc()`'s message; it never answers with an empty result.
"""

from __future__ import annotations

import functools
import os
import subprocess
import tempfile
import time
from pathlib import Path

from libgrape_lite_tpu_torch.ops import _build

CAPS_DIR = _build.CSRC_DIR / "caps"
#: the JAX probe's capability names, in its order
CAPABILITIES = ("sublane_gather", "lane_gather", "int_reduce", "mxu_dot")


class BuildCaps(dict):
    """{capability: built} with the compiler's output for each capability
    (`log`) and the wall seconds the probe took (`seconds`)."""

    def __init__(self, built: dict, log: dict, seconds: float):
        super().__init__(built)
        self.log = log
        self.seconds = seconds

    def missing(self) -> list[str]:
        return [name for name, ok in self.items() if not ok]


@functools.lru_cache(maxsize=None)
def cuda_build_caps() -> BuildCaps:
    """Compile every `csrc/caps/<name>.cu` at once (one `nvcc` each) and
    report which built.  Cached for the life of the process."""
    nvcc = _build.nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="grape_caps_") as tmp:
        procs = {}
        for name in CAPABILITIES:
            cmd = [nvcc, *_build.NVCC_FLAGS, "-c",
                   "-o", os.path.join(tmp, f"{name}.o"),
                   str(CAPS_DIR / f"{name}.cu")]
            procs[name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        built, log = {}, {}
        for name, proc in procs.items():
            log[name], _ = proc.communicate()
            built[name] = (proc.returncode == 0
                           and Path(tmp, f"{name}.o").exists())
    return BuildCaps(built, log, time.perf_counter() - t0)


__all__ = ["BuildCaps", "CAPABILITIES", "CAPS_DIR", "cuda_build_caps"]
