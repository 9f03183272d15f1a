"""The card's primitive rates: four CUDA probe kernels and their plain
PyTorch versions.

Counterparts of the Pallas kernels in the JAX package's probe script
(`scripts/pallas_probe.py::main`), over E = rows * 128 float32 elements
held as `[rows, 128]`:

    stream            out = a * 2 + 1                (vpu_stream)
    lane_gather_t128  out[i, j] = tab[idx[i, j]]     (128-entry table)
    sublane_gather    out[i, j] = tab[idx[i, j], j]  (S-row table)
    cumsum_lanes      inclusive prefix sum along each row

Source and design notes: `csrc/probe.cu`.  The entry point that runs
them is `libgrape_lite_tpu_torch/scripts/cuda_probe.py`.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  `<wrapper>.launches`
counts kernel launches.  stream and the gathers are bit-equal to their
plain versions; `cumsum_lanes` adds in another order than
`torch.cumsum` and is held to |delta| <= CUMSUM_TOL x the prefix sum of
|a| (its plain version repeats the kernel's order).
"""

from __future__ import annotations

import ctypes

import torch

from libgrape_lite_tpu_torch.ops import _build
from libgrape_lite_tpu_torch.ops._build import (
    check_cuda_args,
    check_rc,
    require,
)

LANES = 128
#: cumsum_lanes against torch.cumsum: |delta| <= CUMSUM_TOL * prefix of |a|
CUMSUM_TOL = 1e-5

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("probe")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grape_probe_stream.argtypes = [p, p, ll, p]
        lib.grape_probe_lane_gather_t128.argtypes = [p, p, p, ll, p]
        lib.grape_probe_sublane_gather.argtypes = [p, p, p, ll, i, i, p]
        lib.grape_probe_cumsum_lanes.argtypes = [p, p, ll, p]
        for fn in (lib.grape_probe_stream, lib.grape_probe_lane_gather_t128,
                   lib.grape_probe_sublane_gather,
                   lib.grape_probe_cumsum_lanes):
            fn.restype = i
        _LIB = lib
    return _LIB


def _check_plane(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    require(t.dim() == 2 and t.shape[1] == LANES and t.dtype == dtype,
            f"{name}: expected a [rows, {LANES}] {dtype} tensor, got "
            f"{list(t.shape)} {t.dtype}")


def _launch(name: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_rc(_lib(), rc, name)


# ---- plain versions (CPU tensors; the card's comparisons) ---------------

def stream_plain(a: torch.Tensor) -> torch.Tensor:
    return a * 2.0 + 1.0


def lane_gather_t128_plain(tab: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    return tab[idx.long()]


def sublane_gather_plain(tab: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    col = torch.arange(LANES, device=idx.device)
    return tab.reshape(-1)[idx.long() * LANES + col]


def cumsum_lanes_plain(a: torch.Tensor) -> torch.Tensor:
    """The kernel's order: each lane's 4 values scanned in sequence, the
    32 lane totals scanned Hillis-Steele, the exclusive total added."""
    v = a.reshape(a.shape[0], 32, 4)
    c0 = v[..., 0]
    c1 = c0 + v[..., 1]
    c2 = c1 + v[..., 2]
    c3 = c2 + v[..., 3]
    s = c3
    off = 1
    while off < 32:
        s = torch.cat([s[:, :off], s[:, :-off] + s[:, off:]], dim=1)
        off *= 2
    excl = torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1)
    out = torch.stack([excl + c0, excl + c1, excl + c2, excl + c3], dim=2)
    return out.reshape(a.shape)


# ---- wrappers ----------------------------------------------------------

def stream(a: torch.Tensor) -> torch.Tensor:
    """out = a * 2 + 1 for a [rows, 128] float32."""
    if a.device.type == "cpu":
        return stream_plain(a)
    name = "probe_stream"
    require(a.device.type == "cuda", f"{name}: unsupported device {a.device}")
    _check_plane(name, a, torch.float32)
    check_cuda_args(name, a.device, a=a)
    require(a.data_ptr() % 16 == 0, f"{name}: a must be 16-byte aligned")
    out = torch.empty_like(a)
    _launch(name, a.device, _lib().grape_probe_stream, a.data_ptr(),
            out.data_ptr(), a.numel())
    stream.launches += 1
    return out


def lane_gather_t128(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = tab[idx[i, j]] for tab [128] float32, idx [rows, 128]
    int32 in [0, 128)."""
    if idx.device.type == "cpu":
        return lane_gather_t128_plain(tab, idx)
    name = "probe_lane_gather_t128"
    require(idx.device.type == "cuda",
            f"{name}: unsupported device {idx.device}")
    require(tab.shape == (LANES,) and tab.dtype == torch.float32,
            f"{name}: tab must be a [{LANES}] float32 tensor")
    _check_plane(name, idx, torch.int32)
    check_cuda_args(name, idx.device, tab=tab, idx=idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _launch(name, idx.device, _lib().grape_probe_lane_gather_t128,
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel())
    lane_gather_t128.launches += 1
    return out


def sublane_plan(s: int, optin: int) -> tuple[str, int]:
    """Where the sublane gather reads an [s, 128] float32 table from,
    given the card's per-block shared-memory opt-in (bytes), and the
    columns a block stages: ("shared", 128) when the whole table fits;
    else ("sliced", c) for the widest column slice (128 % c == 0, c >= 4,
    one float4 of a row) whose s * c * 4 bytes fit.  Raises ValueError
    for a table too large for a 4-column slice."""
    c = LANES
    while c >= 4:
        if s * c * 4 <= optin:
            return ("shared" if c == LANES else "sliced"), c
        c //= 2
    raise ValueError(f"sublane_gather: a 4-column slice of {s} table rows "
                     f"({s * 16} bytes) exceeds the {optin}-byte "
                     "shared-memory opt-in")


def sublane_gather(tab: torch.Tensor, idx: torch.Tensor
                   ) -> tuple[torch.Tensor, str]:
    """out[i, j] = tab[idx[i, j], j] for tab [S, 128] float32, idx
    [rows, 128] int32 in [0, S).  Returns the output and where the table
    was read from (`sublane_plan`): "shared" (staged whole in each
    block's shared memory), "sliced" (staged a column slice a block), or
    "plain" on the CPU.  On the card a table too large for a 4-column
    slice is refused."""
    if idx.device.type == "cpu":
        return sublane_gather_plain(tab, idx), "plain"
    name = "probe_sublane_gather"
    require(idx.device.type == "cuda",
            f"{name}: unsupported device {idx.device}")
    _check_plane(name, tab, torch.float32)
    _check_plane(name, idx, torch.int32)
    check_cuda_args(name, idx.device, tab=tab, idx=idx)
    s = tab.shape[0]
    require(s > 0, f"{name}: the table has no rows")
    require(tab.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0,
            f"{name}: tab and idx must be 16-byte aligned")
    placement, cols = sublane_plan(s, torch.cuda.get_device_properties(
        idx.device).shared_memory_per_block_optin)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _launch(name, idx.device, _lib().grape_probe_sublane_gather,
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), s,
            cols)
    sublane_gather.launches += 1
    return out, placement


def cumsum_lanes(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of each row of a [rows, 128] float32."""
    if a.device.type == "cpu":
        return cumsum_lanes_plain(a)
    name = "probe_cumsum_lanes"
    require(a.device.type == "cuda", f"{name}: unsupported device {a.device}")
    _check_plane(name, a, torch.float32)
    check_cuda_args(name, a.device, a=a)
    require(a.data_ptr() % 16 == 0, f"{name}: a must be 16-byte aligned")
    out = torch.empty_like(a)
    _launch(name, a.device, _lib().grape_probe_cumsum_lanes, a.data_ptr(),
            out.data_ptr(), a.shape[0])
    cumsum_lanes.launches += 1
    return out


WRAPPERS = (stream, lane_gather_t128, sublane_gather, cumsum_lanes)
for _fn in WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = [
    "CUMSUM_TOL", "LANES", "WRAPPERS", "cumsum_lanes", "cumsum_lanes_plain",
    "lane_gather_t128", "lane_gather_t128_plain", "launch_counts",
    "reset_launch_counts", "stream", "stream_plain", "sublane_gather",
    "sublane_gather_plain", "sublane_plan",
]
