"""Threaded admission front: wall-clock arrivals.

Counterpart of `libgrape_lite_tpu/serve/feeder.py`.  A scripted stream
submits every query up front, so `BatchPolicy.max_wait_s` and the
priority / deadline scheduling of `AdmissionQueue._pop_ready` never act
under load.  `ArrivalFeeder` is one thread that submits the stream at a
fixed arrival rate (deterministic 1 / rate spacing: a reproducible
arrival order) while the caller's thread pumps:

    feeder = ArrivalFeeder(sess.submit, stream, rate_qps=200.0)
    feeder.start()
    while feeder.is_alive() or sess.queue.pending():
        sess.pump()              # max_wait_s now gates
    feeder.join(); sess.drain()

`AdmissionQueue.submit` and `_pop_ready` share a lock.  The rate is a
plain number or a step schedule, ``"50:2x@100"``: 50 queries a second,
doubled from arrival 100 on; steps chain (``"50:2x@100:0.5x@300"``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Tuple


def parse_rate_spec(spec) -> Tuple[float, List[Tuple[int, float]]]:
    """``"50:2x@100"`` -> ``(50.0, [(100, 2.0)])``: a base rate and
    ``(index, multiplier)`` steps applied cumulatively from that arrival
    on.  A bare number has no steps.  Raises ValueError on a bad spec."""
    if isinstance(spec, (int, float)):
        base, steps = float(spec), []
    else:
        parts = str(spec).split(":")
        base = float(parts[0])
        steps = []
        last_idx = 0
        for part in parts[1:]:
            try:
                mult_s, idx_s = part.split("@")
                if not mult_s.endswith("x"):
                    raise ValueError
                mult = float(mult_s[:-1])
                idx = int(idx_s)
            except ValueError:
                raise ValueError(
                    f"bad rate step {part!r} in {spec!r} "
                    "(want MULTx@INDEX, e.g. 2x@100)") from None
            if mult <= 0:
                raise ValueError(f"rate multiplier must be > 0: {part!r}")
            if idx <= last_idx:
                raise ValueError(
                    f"rate steps must have increasing indices: {spec!r}")
            steps.append((idx, mult))
            last_idx = idx
    if base <= 0:
        raise ValueError(f"rate_qps must be > 0, got {base}")
    return base, steps


def arrival_offsets(n: int, base: float,
                    steps: List[Tuple[int, float]]) -> List[float]:
    """Each of `n` arrivals' offset in seconds from the first: arrival
    i + 1 follows arrival i by 1 / rate(i), rate(i) being the base
    times every multiplier whose step index is <= i."""
    out, t, rate = [], 0.0, float(base)
    pending = list(steps)
    for i in range(n):
        while pending and pending[0][0] <= i:
            rate *= pending.pop(0)[1]
        out.append(t)
        t += 1.0 / rate
    return out


class ArrivalFeeder(threading.Thread):
    """Submit `stream` through `submit_fn` at `rate_qps` arrivals a
    second (a number or a step schedule, `parse_rate_spec`).  Items are
    (app_key, args) pairs or dicts in `ServeSession.serve`'s format
    (with max_rounds / guard / priority / deadline_s / tenant); the
    submitted requests collect in `self.requests`, in arrival order."""

    def __init__(self, submit_fn: Callable, stream, rate_qps,
                 name: str = "grape-feeder"):
        super().__init__(name=name, daemon=True)
        base, steps = parse_rate_spec(rate_qps)
        self._submit = submit_fn
        self._stream = list(stream)
        self.rate_qps = base
        self.rate_steps = steps
        self._offsets = arrival_offsets(len(self._stream), base, steps)
        self.requests: List = []
        self.submitted = 0

    def run(self) -> None:
        t0 = time.perf_counter()
        for i, item in enumerate(self._stream):
            # an absolute schedule: a slow submit does not delay the rest
            delay = t0 + self._offsets[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if isinstance(item, dict):
                req = self._submit(
                    item["app"], item.get("args"),
                    max_rounds=item.get("max_rounds"),
                    guard=item.get("guard"),
                    priority=item.get("priority", 0),
                    deadline_s=item.get("deadline_s"),
                    tenant=item.get("tenant"),
                )
            else:
                app_key, args = item
                req = self._submit(app_key, args)
            self.requests.append(req)
            self.submitted += 1
