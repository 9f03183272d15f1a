"""Message managers: how fragments hand values to each other.

Counterpart of `libgrape_lite_tpu/parallel/message_manager.py`
(reference `grape/parallel/*message_manager*.h`).  Every fragment sits
stacked `[fnum, ...]` on one device, so the JAX package's collectives
become operations over the leading axis:

* auto messaging (SyncBuffer) -> `AutoParallelMessageManager.sync`:
  per-fragment pid-indexed proposals `[fnum, fnum * vp]` folded over the
  fragment axis with the buffer's aggregate op, in fragment order (the
  JAX package's `pmin` / `pmax` / `psum`), each fragment keeping its own
  slice; across ranks a rank's `[fl, fnum * vp]` proposals cross in one
  all_to_all on destination blocks first;
* point-to-point message tensors -> `AllToAllMessageManager.exchange`:
  fixed-capacity per-destination (lid, payload) buffers, the JAX
  package's stable sort by destination, rank within the group, capacity
  drop and overflow vote, with its `all_to_all` as a transpose of the
  stacked send buffers.

The exchange apps on one device do not call `exchange` on their hot
path: `models/exchange_base.py::exchange_relax` computes the same
min-reduction of the received messages as a masked pull through the
gather-reduce kernel, and keeps the overflow vote exact.  `exchange`
stays as the literal route that `exchange_relax` is held against.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class AutoParallelMessageManager:
    """SyncBuffer aggregation over stacked proposals (reference
    `auto_parallel_message_manager.h:47-365`)."""

    _FOLDS = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}

    @classmethod
    def sync(cls, dev, proposals: Dict[str, torch.Tensor],
             ops: Dict[str, str], ctx=None) -> Dict[str, torch.Tensor]:
        """Fold each key's `[fl, fnum * vp]` proposals over the source
        fragments in fragment order with `ops[key]` (min | max | sum);
        return each local fragment's own slice, `[fl, vp]`.

        Single-process (`ctx` None or without a process group) `fl` is
        fnum and the fold reads the stacked rows in place.  Under a
        process group each rank's proposals cross ranks in one
        `ctx.all_to_all` on destination blocks of `vp`: a rank gets, for
        each of its fl destinations, the fnum sources' blocks in sender
        order, and folds them in that order -- the one-process fold bit
        for bit, sums included (no float all_reduce)."""
        out = {}
        for k, prop in proposals.items():
            fold = cls._FOLDS[ops[k]]
            fl, n = prop.shape
            fnum = n // dev.vp
            if ctx is not None and ctx.spec is not None:
                # [fl (dst), fnum (src), vp] -> sources first
                src = ctx.all_to_all(prop).reshape(fl, fnum, dev.vp)
                src = src.transpose(0, 1)
            else:
                src = prop.view(fnum, fnum, dev.vp)  # [src, dst, vp]
            combined = src[0]
            for f in range(1, fnum):
                combined = fold(combined, src[f])
            out[k] = combined
        return out


class AllToAllMessageManager:
    """Fixed-capacity point-to-point message tensors (reference
    `default_message_manager.h` / `parallel_message_manager.h`)."""

    @staticmethod
    def exchange(dest_fid: torch.Tensor, lid: torch.Tensor,
                 payload: torch.Tensor, valid: torch.Tensor, capacity: int,
                 fnum: int):
        """Route per-message payloads to their destination fragments.

        Inputs are stacked `[fnum, M]`, row s holding fragment s's
        messages.  Each row is sorted stably by destination (invalid
        messages last), a message's rank within its destination group
        picks its slot, and messages past `capacity` are dropped.
        Returns `(recv_lid, recv_payload, recv_valid, overflowed)`: the
        receive buffers `[fnum, fnum * capacity]`, row t holding the
        `capacity` slots sent by each fragment s at `s * capacity`, and
        the number of fragments that dropped a message (0-d int32)."""
        m = dest_fid.shape[1]
        dev = dest_fid.device
        big = fnum
        d = torch.where(valid, dest_fid.to(torch.int64),
                        torch.full((), big, dtype=torch.int64, device=dev))
        d_s, order = torch.sort(d, dim=1, stable=True)
        lid_s = torch.gather(lid, 1, order)
        pay_s = torch.gather(payload, 1, order)
        # rank within the destination group: position - group start
        counts = torch.zeros(fnum, big + 1, dtype=torch.int64, device=dev)
        counts.scatter_add_(1, d_s, torch.ones_like(d_s))
        starts = torch.cumsum(counts, 1) - counts
        rank = torch.arange(m, device=dev) - torch.gather(starts, 1, d_s)

        real = d_s < big
        ok = real & (rank < capacity)
        slot_d = torch.where(ok, d_s, big)
        slot_r = torch.where(ok, rank, 0)
        src = torch.arange(fnum, device=dev).unsqueeze(1).expand(-1, m)
        index = (src[ok], slot_d[ok], slot_r[ok])

        def send(values, dtype):
            buf = torch.zeros(fnum, big + 1, capacity, dtype=dtype,
                              device=dev)
            buf.index_put_(index, values[ok])
            # the all_to_all: fragment t receives every s's slice t
            return buf[:, :big].transpose(0, 1).reshape(fnum, -1)

        overflowed = (real & (rank >= capacity)).any(dim=1).sum()
        return (send(lid_s, lid.dtype), send(pay_s, payload.dtype),
                send(torch.ones_like(ok), torch.bool),
                overflowed.to(torch.int32))


def plan_initial_capacity(frag, requested: int | None, learned) -> int:
    """Initial per-destination message capacity for the exchange apps,
    the role of the reference's `EstimateMessageSize` priming
    (`parallel_message_manager_opt.h`): `requested` wins; else the
    capacity a previous query on this fragment settled at (`learned`,
    the app's per-fragment WeakKeyDictionary); else the smallest power
    of two from 1024 up that lets the densest vertex push all its edges
    to one destination fragment twice over.

    An armed fault plan (GRAPE_FT_FAULTS=capacity=N, ft/faults.py)
    clamps the result, so the overflow-retry ladder runs in drills
    instead of being dead code on real graphs."""
    from libgrape_lite_tpu_torch.ft.faults import active_plan

    if requested:
        return active_plan().clamp_capacity(max(1, requested))
    if frag in learned:
        return active_plan().clamp_capacity(learned[frag])
    max_deg = max(
        int(np.diff(c.indptr).max(initial=1)) for c in frag.host_oe
    )
    cap = 1024
    while cap < 2 * max_deg:
        cap *= 2
    return active_plan().clamp_capacity(cap)
