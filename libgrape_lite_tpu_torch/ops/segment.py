"""Segment reductions (counterpart of `libgrape_lite_tpu/ops/segment.py`).

The plain PyTorch form of the JAX package's ForEachEdge: per-edge values
keyed by their row id, reduced into rows.  Ids equal to `num_rows` (the
padding convention of graph/csr.py) land in an overflow row that is
sliced off.  Stacked inputs `[fnum, E]` reduce per fragment into
`[fnum, num_rows]`.  Rows without edges hold the identity: 0 for sum,
+inf / -inf for min / max on floats.
"""

from __future__ import annotations

import math

import torch

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def identity(kind: str, dtype: torch.dtype) -> float | int:
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_rows: int, kind: str = "sum") -> torch.Tensor:
    """Reduce `values` [..., E] by `segment_ids` [..., E] into
    [..., num_rows]; ids must lie in [0, num_rows]."""
    if kind not in _REDUCE:
        raise ValueError(f"unknown reduction kind {kind!r}")
    lead = values.shape[:-1]
    nb = math.prod(lead)
    v = values.reshape(nb, -1)
    offs = torch.arange(nb, device=values.device).unsqueeze(1) * (num_rows + 1)
    ids = (segment_ids.reshape(nb, -1).long() + offs).reshape(-1)
    out = torch.full((nb * (num_rows + 1),), identity(kind, values.dtype),
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, ids, v.reshape(-1), _REDUCE[kind],
                        include_self=True)
    return out.view(nb, num_rows + 1)[:, :num_rows].reshape(*lead, num_rows)
