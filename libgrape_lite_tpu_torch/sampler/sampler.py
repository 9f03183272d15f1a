"""Multi-hop neighbour sampling.

Counterpart of `libgrape_lite_tpu/sampler/sampler.py` (reference
`examples/gnn_sampler/sampler.h`: random / edge-weight / top-k): fixed
fanout per hop, every hop dense tensor work on the device.

  * random      -- per-slot uniform draws scaled by the degree pick CSR
                   slots with replacement;
  * edge_weight -- Gumbel-max over per-edge keys log(w) + G within the
                   row's first `window` slots, k picks without
                   replacement;
  * top_k       -- the same picks with keys log(w) (deterministic).

A zero-degree frontier slot yields -1 (the reference emits an empty
list), and a -1 stays -1 in later hops.  Randomness comes from a
`torch.Generator` seeded from `seed`; `sample_hop` is a pure function of
its draws, so the JAX package's draws can be fed to it.  The JAX package
picks k times with `argmax`, which takes the first maximum; here one
stable descending sort of each row's keys gives the same order, ties to
the lower slot, and a -inf key yields -1.
"""

from __future__ import annotations

import numpy as np
import torch

STRATEGIES = ("random", "edge_weight", "top_k")
#: keys per block of frontier rows in the weighted strategies
_BLOCK_KEYS = 1 << 26


def sample_hop(indptr: torch.Tensor, nbr: torch.Tensor, w, frontier,
               k: int, strategy: str, draws=None,
               window: int = 1024) -> torch.Tensor:
    """[q, k] int32 picks for the frontier rows (row n = a dead slot).

    `draws`: [q, k] uniforms in [0, 1) for `random`, [E] uniforms in
    (0, 1) for `edge_weight` (one per CSR slot), None for `top_k`."""
    n = indptr.numel() - 1
    e = nbr.numel()
    frontier = frontier.long()
    starts = indptr[frontier.clamp(max=n)].long()
    degs = indptr[(frontier + 1).clamp(max=n)].long() - starts
    valid = degs > 0
    neg = torch.full((), -1, dtype=torch.int32, device=nbr.device)
    if e == 0:
        return neg.expand(frontier.numel(), k).clone()
    if strategy == "random":
        off = (draws * degs[:, None]).to(torch.int32)
        idx = starts[:, None] + torch.minimum(
            off.long(), (degs - 1).clamp(min=0)[:, None])
        return torch.where(valid[:, None], nbr[idx.clamp(max=e - 1)], neg)
    if strategy not in ("edge_weight", "top_k"):
        raise ValueError(f"unknown strategy {strategy!r}")

    if w is None:
        base = torch.zeros(e, dtype=torch.float32, device=nbr.device)
    else:
        base = torch.log(w.to(torch.float32).clamp(min=1e-30))
    if strategy == "edge_weight":
        base = base + -torch.log(-torch.log(draws))
    # rows longer than `window` are sampled from their first slots; a
    # window past the frontier's longest row changes nothing
    width = int(min(window, int(degs.max()) if degs.numel() else 0))
    out = neg.expand(frontier.numel(), k).clone()
    if width == 0:
        return out
    win = torch.arange(width, device=nbr.device)
    rows = max(1, _BLOCK_KEYS // width)
    for lo in range(0, frontier.numel(), rows):
        st, dg = starts[lo:lo + rows], degs[lo:lo + rows]
        idx = (st[:, None] + torch.minimum(
            win[None, :], (dg - 1).clamp(min=0)[:, None])).clamp(max=e - 1)
        keys = torch.where(win[None, :] < dg.clamp(max=width)[:, None],
                           base[idx], torch.tensor(-torch.inf,
                                                   dtype=base.dtype,
                                                   device=base.device))
        sk, order = torch.sort(keys, dim=1, descending=True, stable=True)
        kk = min(k, width)
        picked = torch.gather(idx, 1, order[:, :kk])
        chosen = torch.where(sk[:, :kk] == -torch.inf, neg, nbr[picked])
        out[lo:lo + rows, :kk] = torch.where(valid[lo:lo + rows, None],
                                             chosen, neg)
    return out


class GraphSampler:
    """`window` bounds the per-row candidate span of the weighted
    strategies: rows of higher degree are sampled from their first
    `window` CSR slots only.  `random` indexes the whole row."""

    STRATEGIES = STRATEGIES

    def __init__(self, fragment, strategy: str = "random",
                 window: int = 1024):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.fragment = fragment
        self.strategy = strategy
        self.window = window

    def sample(self, queries, fanouts, seed: int = 0) -> list:
        """Multi-hop sample: one int32 tensor per hop on the fragment's
        device, hop h of shape [len(queries), prod(fanouts[:h+1])]."""
        indptr, nbr, w = self.fragment.device_csr()
        dev = nbr.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        frontier = torch.as_tensor(np.asarray(queries),
                                   dtype=torch.int64).to(dev)
        nq = frontier.numel()
        n = indptr.numel() - 1
        out = []
        for k in fanouts:
            k = int(k)
            draws = None
            if self.strategy == "random":
                draws = torch.rand((frontier.numel(), k), generator=gen,
                                   device=dev)
            elif self.strategy == "edge_weight":
                draws = torch.rand(nbr.numel(), generator=gen,
                                   device=dev).clamp_(min=1e-9)
            nxt = sample_hop(indptr, nbr, w, frontier.reshape(-1), k,
                             self.strategy, draws, self.window)
            out.append(nxt.reshape(nq, -1))
            # dead (-1) slots become row n, of degree 0: -1 again
            flat = nxt.reshape(-1).long()
            frontier = torch.where(flat >= 0, flat, n)
        return out
