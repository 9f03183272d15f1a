"""App-facing collectives over the stacked fragment axis.

Counterpart of `libgrape_lite_tpu/parallel/communicator.py` (reference
`grape/communication/communicator.h:35-127`,
`grape/cuda/communication/communicator.h:29-216`).  Single-process,
every fragment sits on one device as the leading `[fnum, ...]` axis of a
tensor, so a collective over the JAX package's fragment mesh axis is an
operation on that axis: a reduction folds it away, `all_gather` flattens
it, `all_to_all` swaps the sender and receiver blocks, `ppermute` moves
rows.  The per-shard block of the JAX collective is row f of the stacked
tensor, so each function here returns, stacked, what every shard of the
JAX collective returns.

Under a process group (`CommSpec.init_distributed`) each rank holds the
slab `[fl, ...]` of fragments `[fid_lo, fid_lo + fl)`.  Each collective
works on the local axis as the single-process form does, then crosses
ranks through the spec's primitives (NCCL, or gloo):

  * `sum` -- all_gather of the per-fragment partials into `[fnum, ...]`,
    then the same `x.sum(dim=0)` in fragment order: bit-equal to the
    single-process fold and stable across reruns (no float all_reduce);
  * `min` / `max` -- the local fold, then all_reduce MIN / MAX (exact);
  * `all_gather` -- all_gather into `[fnum, ...]`;
  * `all_to_all` -- all_to_all_single over `[world]` blocks;
  * `ppermute` -- an all_to_all_single whose blocks carry the moved rows;
    a row no pair writes is zero, as in `lax.ppermute`;
  * `ring_shift` -- a rank's whole block to rank r - 1, rank r + 1's
    back, point to point (the ring of rank blocks the LCCs run);
  * `axis_index` -- this rank's `fid_lo + arange(fl)`; `axis_size` fnum.
"""

from __future__ import annotations

import torch


class Communicator:
    """Collectives over the leading fragment axis.  `fnum` is the axis
    size; `spec` (a CommSpec with a process group) makes each collective
    cross ranks, the local axis then being the rank's slab of `fl`
    fragments."""

    def __init__(self, fnum: int = 1, spec=None):
        self.fnum = fnum
        self.spec = (spec if spec is not None
                     and getattr(spec, "group", None) is not None else None)
        self.fl = self.spec.fl if self.spec is not None else fnum
        self.fid_lo = self.spec.fid_lo if self.spec is not None else 0

    def _gather_frags(self, x: torch.Tensor) -> torch.Tensor:
        """The local [fl, ...] slab -> every rank's, [fnum, ...]."""
        if x.dtype == torch.bool:
            return self.spec.all_gather_into(x.to(torch.uint8)).bool()
        return self.spec.all_gather_into(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec is not None:
            x = self._gather_frags(x)
        return x.sum(dim=0)

    def _extreme(self, x: torch.Tensor, op: str) -> torch.Tensor:
        y = x.amin(dim=0) if op == "min" else x.amax(dim=0)
        if self.spec is None:
            return y
        if y.dtype == torch.bool:
            return self.spec.all_reduce(y.to(torch.uint8), op).bool()
        return self.spec.all_reduce(y, op)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._extreme(x, "min")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._extreme(x, "max")

    def all_gather(self, x: torch.Tensor, tiled: bool = True,
                   async_op: bool = False):
        """Every shard's block, concatenated ([fnum, n, ...] -> [fnum *
        n, ...]) or, untiled, stacked ([fnum, n, ...]); the gathered
        array is the same on every shard, so it is returned once.
        `async_op` (a process group only) returns (the output, its
        `comm_spec.Pending`): the output holds the gather after `wait`."""
        if async_op:
            pend = self.spec.all_gather_into(x, async_op=True)
            out = pend.out
            return (out.reshape((-1,) + tuple(out.shape[2:])) if tiled
                    else out), pend
        if self.spec is not None:
            x = self._gather_frags(x)
        return x.reshape((-1,) + tuple(x.shape[2:])) if tiled else x

    def all_to_all(self, x: torch.Tensor, split_axis: int = 0,
                   concat_axis: int = 0) -> torch.Tensor:
        """Tiled all-to-all: shard g cuts its block into fnum chunks
        along `split_axis` (axes of the block, not of the stack) and
        sends chunk f to shard f, which concatenates what it receives in
        sender order along `concat_axis`.  On the stack [g, ...] that is
        a transpose of the sender and chunk axes; a [fnum, fnum, m] send
        block with both axes 0 comes back as its transpose (0, 1)."""
        fnum = self.fnum if self.spec is not None else x.shape[0]
        s, c = split_axis + 1, concat_axis + 1
        # [g, ..., f, chunk, ...]: the split axis cut into fnum chunks
        y = x.unflatten(s, (fnum, -1))
        # receiver first: [f, g, ...(chunked block)...]
        y = y.movedim(s, 0)
        if self.spec is not None:
            # receivers grouped by rank: [world, fl (f), fl (g), ...];
            # back come [world (sender rank), fl (f), fl (g), ...], the
            # senders in fragment order once the rank axis joins g
            w = self.spec.world
            recv = self.spec.all_to_all_single(y.unflatten(0, (w, -1)))
            y = recv.movedim(0, 1).flatten(1, 2)
        # the sender axis joins the concat axis, in sender order
        return y.movedim(1, c).flatten(c, c + 1)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Row `dst` takes row `src` for each (src, dst) pair; a row
        no pair writes is zero, as in `lax.ppermute`."""
        out = torch.zeros_like(x)
        if self.spec is None:
            if perm:
                src, dst = zip(*perm)
                out[list(dst)] = x[list(src)]
            return out
        w, fl, lo = self.spec.world, self.fl, self.fid_lo
        send = torch.zeros((w,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)
        for s, d in perm:
            if lo <= s < lo + fl:  # a row this rank sends
                send[d // fl, d % fl] = x[s - lo]
        recv = self.spec.all_to_all_single(send)  # [sender rank, fl, ...]
        for s, d in perm:
            if lo <= d < lo + fl:  # a row this rank receives
                out[d - lo] = recv[s // fl, d - lo]
        return out

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """The block of the next rank in the ring (`CommSpec.ring_shift`);
        single-process the whole stack is one rank's block, and the shift
        is the identity."""
        if self.spec is None:
            return x
        return self.spec.ring_shift(x)

    def ring_block(self, step: int) -> int:
        """The rank whose block this rank holds after `step` ring shifts
        (0 single-process)."""
        if self.spec is None:
            return 0
        return (self.spec.rank + step) % self.spec.world

    def ring_size(self) -> int:
        """Steps of a full ring: the world size (1 single-process)."""
        return 1 if self.spec is None else self.spec.world

    def axis_index(self) -> torch.Tensor:
        """Each local shard's index on the fragment axis: [fl]."""
        return torch.arange(self.fid_lo, self.fid_lo + self.fl)

    def axis_size(self) -> int:
        return self.fnum
