"""Device and host memory accounting (`--memory_stats`).

Counterpart of `libgrape_lite_tpu/utils/memory.py` (reference
`MemoryTracker`, `grape/utils/memory_tracker.h:26-43`, and
`GetMemoryUsage`, `grape/util.h:51-69`): live and peak bytes from
PyTorch's CUDA caching allocator (`torch.cuda.memory_allocated`,
`torch.cuda.max_memory_allocated`) and the process RSS from /proc.  A
CPU device has no allocator counters and reports 0 device bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class MemoryStats:
    device_bytes_in_use: int
    device_peak_bytes: int
    host_rss_bytes: int

    def __str__(self):
        gb = 1 << 30
        return (
            f"device in-use {self.device_bytes_in_use / gb:.3f} GiB, "
            f"device peak {self.device_peak_bytes / gb:.3f} GiB, "
            f"host rss {self.host_rss_bytes / gb:.3f} GiB"
        )


def get_host_rss() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def get_memory_stats(device="cuda") -> MemoryStats:
    dev = torch.device(device)
    in_use = peak = 0
    if dev.type == "cuda":
        in_use = int(torch.cuda.memory_allocated(dev))
        peak = int(torch.cuda.max_memory_allocated(dev))
    return MemoryStats(in_use, peak, get_host_rss())
