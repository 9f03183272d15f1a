"""App-facing collectives over the stacked fragment axis.

Counterpart of `libgrape_lite_tpu/parallel/communicator.py` (reference
`grape/communication/communicator.h:35-127`,
`grape/cuda/communication/communicator.h:29-216`).  Every fragment sits
on one device as the leading `[fnum, ...]` axis of a tensor, so a
collective over the JAX package's fragment mesh axis is an operation on
that axis: a reduction folds it away, `all_gather` flattens it,
`all_to_all` swaps the sender and receiver blocks, `ppermute` moves
rows.  The per-shard block of the JAX collective is row f of the stacked
tensor, so each function here returns, stacked, what every shard of the
JAX collective returns.  On several cards these become NCCL collectives.
"""

from __future__ import annotations

import torch


class Communicator:
    """Collectives over the leading fragment axis.  `fnum` is the axis
    size: the stacked tensors carry it, `axis_index` and `axis_size`
    read it here."""

    def __init__(self, fnum: int = 1):
        self.fnum = fnum

    @staticmethod
    def sum(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    @staticmethod
    def min(x: torch.Tensor) -> torch.Tensor:
        return x.amin(dim=0)

    @staticmethod
    def max(x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    @staticmethod
    def all_gather(x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """Every shard's block, concatenated ([fnum, n, ...] -> [fnum *
        n, ...]) or, untiled, stacked (the input itself); the gathered
        array is the same on every shard, so it is returned once."""
        return x.reshape((-1,) + tuple(x.shape[2:])) if tiled else x

    @staticmethod
    def all_to_all(x: torch.Tensor, split_axis: int = 0,
                   concat_axis: int = 0) -> torch.Tensor:
        """Tiled all-to-all: shard g cuts its block into fnum chunks
        along `split_axis` (axes of the block, not of the stack) and
        sends chunk f to shard f, which concatenates what it receives in
        sender order along `concat_axis`.  On the stack [g, ...] that is
        a transpose of the sender and chunk axes; a [fnum, fnum, m] send
        block with both axes 0 comes back as its transpose (0, 1)."""
        fnum = x.shape[0]
        s, c = split_axis + 1, concat_axis + 1
        # [g, ..., f, chunk, ...]: the split axis cut into fnum chunks
        y = x.unflatten(s, (fnum, -1))
        # receiver first: [f, g, ...(chunked block)...]
        y = y.movedim(s, 0)
        # the sender axis joins the concat axis, in sender order
        return y.movedim(1, c).flatten(c, c + 1)

    @staticmethod
    def ppermute(x: torch.Tensor, perm) -> torch.Tensor:
        """Row `dst` takes row `src` for each (src, dst) pair; a row
        no pair writes is zero, as in `lax.ppermute`."""
        out = torch.zeros_like(x)
        if perm:
            src, dst = zip(*perm)
            out[list(dst)] = x[list(src)]
        return out

    def axis_index(self) -> torch.Tensor:
        """Each stacked shard's index on the fragment axis: [fnum]."""
        return torch.arange(self.fnum)

    def axis_size(self) -> int:
        return self.fnum
