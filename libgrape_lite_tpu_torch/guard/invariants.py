"""App-declared runtime invariants.

Counterpart of `libgrape_lite_tpu/guard/invariants.py`, as plain
functions on tensors.  An `Invariant` is a named predicate over
consecutive carries: `fn(dev, prev, cur) -> (ok, measure)`, `ok` a 0-d
bool tensor and `measure` a 0-d float32 tensor the diagnostic bundle
records (the violating-element count or the error).  They run on the
carry's device; the monitor (guard/monitor.py) reads every verdict back
in one transfer.

`requires` names the carry keys the predicate reads; the monitor drops
an invariant whose keys are absent from the carry.

Soundness notes baked into the builders:

* `in_range(lo=0)` catches NaN (NaN >= 0 is False) while
  `monotone_non_increasing` alone does not (NaN > x is False too): pair
  them.
* padded rows satisfy every invariant in a healthy run (pad distance
  +inf, pad label INT32_MAX, pad rank 0), so predicates scan the whole
  carry unmasked.
* CDLP labels are not monotone (mode adoption can raise a label); CDLP
  declares range membership instead (models/cdlp.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import torch


@dataclass(frozen=True)
class Invariant:
    name: str
    fn: Callable  # (dev, prev, cur) -> (ok 0-d, measure 0-d)
    requires: Tuple[str, ...]
    description: str = field(default="")
    # the elementwise violation mask (prev, cur) -> bool of a counting
    # invariant, or None: lets a guarded batch count every lane of a
    # lane-stacked carry in one pass (serve/batch.py)
    bad: Optional[Callable] = field(default=None, compare=False)

    def check(self, dev, prev, cur):
        ok, measure = self.fn(dev, prev, cur)
        return (torch.as_tensor(ok).to(torch.bool),
                torch.as_tensor(measure).to(torch.float32))


def _count_invariant(name, key, bad_fn, description):
    def fn(dev, prev, cur):
        nbad = bad_fn(prev, cur).sum()
        return nbad == 0, nbad.to(torch.float32)

    return Invariant(name, fn, (key,), description, bad=bad_fn)


def no_nan(key: str) -> Invariant:
    """No NaN anywhere in a float leaf (+/-inf may be a sentinel, NaN
    never is)."""
    return _count_invariant(
        f"no_nan({key})", key,
        lambda prev, cur: torch.isnan(cur[key]),
        f"float carry {key!r} must be NaN-free",
    )


def finite(key: str) -> Invariant:
    """Strictly finite float leaf (no NaN, no +/-inf)."""
    return _count_invariant(
        f"finite({key})", key,
        lambda prev, cur: ~torch.isfinite(cur[key]),
        f"float carry {key!r} must be finite",
    )


def in_range(key: str, lo=None, hi=None) -> Invariant:
    """Every element within [lo, hi] (either bound optional).  NaN fails
    any given bound, so this doubles as a NaN check."""

    def bad(prev, cur):
        v = cur[key]
        ok = torch.ones(v.shape, dtype=torch.bool, device=v.device)
        # a Python bound takes the leaf's dtype (the JAX package casts
        # it), and comparing with a Python number copies nothing to the
        # card
        if lo is not None:
            ok = ok & (v >= lo)
        if hi is not None:
            ok = ok & (v <= hi)
        return ~ok

    bounds = f"[{'-inf' if lo is None else lo}, {'inf' if hi is None else hi}]"
    return _count_invariant(
        f"in_range({key})", key, bad,
        f"carry {key!r} must lie in {bounds}",
    )


def monotone_non_increasing(key: str) -> Invariant:
    """No element may grow between consecutive probes (min-propagation
    carries: distances, labels).  Transitive, so it holds across a probe
    cadence > 1.  NaN-blind by itself; pair with `in_range` / `no_nan`."""
    return _count_invariant(
        f"monotone_non_increasing({key})", key,
        lambda prev, cur: cur[key] > prev[key],
        f"carry {key!r} may only decrease between supersteps",
    )


def monotone_non_decreasing(key: str) -> Invariant:
    """No element may shrink between consecutive probes (peeling levels,
    accumulating sums).  NaN-blind by itself, like its mirror."""
    return _count_invariant(
        f"monotone_non_decreasing({key})", key,
        lambda prev, cur: cur[key] < prev[key],
        f"carry {key!r} may only increase between supersteps",
    )


def set_once(key: str, unset) -> Invariant:
    """Elements may change only from the `unset` sentinel: a pinned value
    never changes again (core numbers), so an in-range corruption of a
    pinned element trips the next probe."""
    return _count_invariant(
        f"set_once({key})", key,
        lambda prev, cur: (cur[key] != prev[key]) & (prev[key] != unset),
        f"carry {key!r} may only change from its unset value {unset!r}",
    )


def default_invariants(app, frag, state) -> list:
    """The floor every app gets: NaN-free float carries.  (The
    active-vote range check is the monitor's.)  Ephemeral leaves are
    round inputs, not loop state: excluded."""
    eph = frozenset(getattr(app, "ephemeral_keys", ()) or ())
    return [no_nan(k) for k in sorted(state)
            if k not in eph and torch.as_tensor(state[k]).is_floating_point()]
