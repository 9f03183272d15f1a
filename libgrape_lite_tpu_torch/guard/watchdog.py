"""Divergence watchdog: carry-digest cycle proof and residual stagnation.

Counterpart of `libgrape_lite_tpu/guard/watchdog.py`.  A superstep is a
deterministic function of the carry (the kernels reduce in a fixed
order), so a carry digest at round r equal to the one at round r0 < r
proves an infinite cycle of period r - r0.  Residual stagnation is the
heuristic companion for float carries whose digests never repeat but
whose residual (max |delta| between probes) stops improving for
`window` probes (0 disables it; cycle detection stays on).

`carry_digest` is the JAX package's digest word for word, so
`digest_hex` agrees between the packages: per leaf, in sorted-key order,
two position-weighted wrapping sums over the leaf's uint32 bit-words.
PyTorch has no general uint32 arithmetic on CUDA, so the words live in
int64: each product is reduced mod 2^32 through 16-bit halves (no
product passes 2^49) and each sum is taken mod 2^32.  (Under x64 the JAX
package sums into uint64 without wrapping; its `digest_hex` keeps the
low 32 bits, which are these.)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _u32_words(v: torch.Tensor) -> torch.Tensor:
    """One carry leaf as its uint32 bit-words, held in int64 (exact: two
    states digest equal iff their bytes are equal, leaf by leaf)."""
    v = torch.as_tensor(v)
    if v.dtype == torch.bool or v.element_size() < 4:
        # sub-word leaves digest by value (two's complement mod 2^32)
        return v.reshape(-1).to(torch.int64) & _M32
    words = v.contiguous().reshape(-1).view(torch.int32)
    return words.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for a and b (a tensor or a constant) in
    [0, 2^32): through b's 16-bit halves, no product passes 2^49."""
    return (a * (b & _M16) + (((a * (b >> 16)) & _M16) << 16)) & _M32


def carry_digest(carry: Dict, pos0: Optional[Dict[str, int]] = None,
                 skip=()) -> torch.Tensor:
    """[2 * nleaves] int64 digest words, each in [0, 2^32), on the carry's
    device: per leaf in sorted-key order, sum(bits * w1) and
    sum((bits ^ bits >> 16) * w2) mod 2^32 with w1 = pos * 2654435761 + 1
    and w2 = pos * 0x85EBCA77 + 0x9E3779B1, pos a word's position in its
    leaf (the JAX package's).  The weighting runs once over the leaves'
    concatenated words; each leaf's two sums are then reductions over its
    slice (integer sums: exact in any order).

    Across ranks a rank digests its slab as a part of the whole leaf:
    `pos0[k]` is the position of the slab's first word in leaf k, and the
    leaves in `skip` (a replicated leaf on every rank but one) sum to 0,
    so the ranks' words added mod 2^32 are the one-process digest."""
    keys = sorted(carry)
    if not keys:
        return torch.zeros((0,), dtype=torch.int64)
    words = [_u32_words(carry[k]) for k in keys]
    device = words[0].device
    lens = [w.numel() for w in words]
    bits = torch.cat(words)
    pos0 = pos0 or {}
    pos = torch.cat([torch.arange(n, dtype=torch.int64, device=device)
                     + int(pos0.get(k, 0)) for k, n in zip(keys, lens)])
    w1 = (_mul32(pos, 2654435761) + 1) & _M32
    w2 = (_mul32(pos, 0x85EBCA77) + 0x9E3779B1) & _M32
    mixed = bits ^ (bits >> 16)
    terms = torch.stack([_mul32(bits, w1), _mul32(mixed, w2)])
    sums = torch.stack([part.sum(dim=1) if k not in skip
                        else part.new_zeros(2)
                        for k, part in zip(keys, torch.split(terms, lens,
                                                             dim=1))])
    return (sums & _M32).reshape(-1)


def words_per_element(v: torch.Tensor) -> int:
    """The uint32 words a carry element digests as (`_u32_words`)."""
    return max(1, torch.as_tensor(v).element_size() // 4)


def carry_digest_lanes(carry: Dict, lanes: int) -> torch.Tensor:
    """[lanes, 2 * nleaves] int64: `carry_digest` of every lane of a
    lane-stacked carry (each leaf [lanes, ...]) at once, row b equal
    word for word to `carry_digest` of lane b's slice."""
    keys = sorted(carry)
    if not keys:
        return torch.zeros((lanes, 0), dtype=torch.int64)
    sums = []
    for k in keys:
        bits = _u32_words(carry[k]).reshape(lanes, -1)
        pos = torch.arange(bits.shape[1], dtype=torch.int64,
                           device=bits.device)
        w1 = (_mul32(pos, 2654435761) + 1) & _M32
        w2 = (_mul32(pos, 0x85EBCA77) + 0x9E3779B1) & _M32
        mixed = bits ^ (bits >> 16)
        sums += [_mul32(bits, w1).sum(dim=1), _mul32(mixed, w2).sum(dim=1)]
    return torch.stack(sums, dim=1) & _M32


def digest_hex(digest: Tuple[int, ...]) -> str:
    return "".join(f"{int(w) & 0xFFFFFFFF:08x}" for w in digest)


class DivergenceWatchdog:
    """Observes (round, digest, residual) at every probe and returns a
    verdict dict when the run provably cycles or heuristically
    stagnates; None while healthy.  `reset()` after a rollback: replayed
    rounds would otherwise re-present digests the history holds."""

    def __init__(self, stagnation_window: int = 256):
        self.stagnation_window = stagnation_window
        self._seen: Dict[Tuple[int, ...], int] = {}
        self._best_residual: Optional[float] = None
        self._stale_probes = 0

    def reset(self) -> None:
        self._seen.clear()
        self._best_residual = None
        self._stale_probes = 0

    def observe(
        self,
        rounds: int,
        digest: Tuple[int, ...],
        residual: Optional[float] = None,
    ) -> Optional[dict]:
        first = self._seen.get(digest)
        if first is not None:
            return {
                "kind": "oscillation",
                "period": rounds - first,
                "first_seen_round": first,
                "round": rounds,
                "detail": (
                    f"carry digest at superstep {rounds} repeats superstep "
                    f"{first}: the loop is in a provable cycle of period "
                    f"{rounds - first} and will never converge"
                ),
            }
        self._seen[digest] = rounds
        if residual is not None and self.stagnation_window > 0:
            if (
                self._best_residual is None
                or (np.isfinite(residual) and residual < self._best_residual)
            ):
                self._best_residual = (
                    float(residual) if np.isfinite(residual) else None
                )
                self._stale_probes = 0
            else:
                self._stale_probes += 1
                if self._stale_probes >= self.stagnation_window:
                    return {
                        "kind": "stagnation",
                        "round": rounds,
                        "best_residual": self._best_residual,
                        "stale_probes": self._stale_probes,
                        "detail": (
                            f"residual has not improved on "
                            f"{self._best_residual!r} for "
                            f"{self._stale_probes} probes "
                            f"(window {self.stagnation_window})"
                        ),
                    }
        return None
