"""Fragment <-> device topology.

Counterpart of `libgrape_lite_tpu/parallel/comm_spec.py` (reference
`grape/worker/comm_spec.h:34-239`).  In this slice every fragment lives
on one device as a leading `[fnum, ...]` dimension, so the spec is the
fragment count and the device; there is no mesh and no process group.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for
    and absent (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


class CommSpec:
    def __init__(self, fnum: int | None = None, device="cuda"):
        fnum = 1 if fnum is None else int(fnum)
        if fnum < 1:
            raise ValueError("fnum must be >= 1")
        self.fnum = fnum
        self.device = resolve_device(device)

    def __repr__(self):
        return f"CommSpec(fnum={self.fnum}, device={self.device})"
