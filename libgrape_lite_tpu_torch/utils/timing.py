"""The port's timer for kernels and plain versions on the card.

`time_ms` returns the median milliseconds per call over `samples`
samples; a sample is a batch of `batch` back-to-back calls between two
CUDA events, queued behind a GPU busy-wait so that the events time the
device and not the host's dispatch of the batch's first call (the
dispatch of the others overlaps the calls before them).  On the CPU the
host clock times a sample; such times are no measurement of a card.
"""

from __future__ import annotations

import statistics
import time

import torch

BATCH = 10
# GPU clock cycles of the busy-wait queued before each timed batch (about
# 1 ms on an H100): longer than the host takes to dispatch a batch.
BUSY_WAIT_CYCLES = 2_000_000


def time_ms(fn, device, samples: int, batch: int = BATCH,
            warmup: int = 2) -> float:
    """Median milliseconds per call of `fn` over `samples` samples of
    `batch` calls, after `warmup` calls."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = []
    for _ in range(samples):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(BUSY_WAIT_CYCLES)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / batch)
        else:
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / batch)
    return statistics.median(out)


__all__ = ["BATCH", "BUSY_WAIT_CYCLES", "time_ms"]
