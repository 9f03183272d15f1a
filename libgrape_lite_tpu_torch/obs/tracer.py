"""Tracer: nested host spans with a disarmed fast path.

Counterpart of `libgrape_lite_tpu/obs/tracer.py`.  Two constraints rule
this file:

1. **Disarmed cost is a branch.**  The worker's round loop calls
   `tracer.span(...)` every round whether or not tracing is on, so a
   disarmed tracer returns one shared no-op span from a two-branch
   method: no allocation, no clock read, no buffering (held under a
   microsecond by tests/test_torch_obs.py).
2. **Armed cost stays off the device path.**  Spans buffer into a
   `collections.deque`, whose append is atomic under the interpreter
   lock, so the round loop, the serving pump's batch threads and a
   feeder thread never contend on a lock; nothing is serialized before
   `flush()`.  Arming adds no host synchronisation: no span reads a
   device value.

Timing convention on CUDA: a kernel launch returns before the card has
run it, so a span's clock stops only after the host has synchronised on
the round's result.  In `Worker.query` that synchronisation already
exists: it is the read of the round's active vote.  A caller that wants
the split calls `span.mark("dispatched")` between the app's round
returning (every launch queued) and that read: the span then reports
`dispatched_us` (host launch time) and `device_wait_us` (the wait in the
read, the device-time estimate).  A round during which a CUDA extension
was built or loaded, or a plan cache missed, is marked `compiled`, so
readers can leave it out of device accounting.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict

from libgrape_lite_tpu_torch.obs.events import (
    FRAG_TID_BASE,
    LANE_TID_BASE,
    REPLICA_TID_BASE,
    counter_event,
    instant_event,
    metadata_event,
    span_event,
)
from libgrape_lite_tpu_torch.obs.metrics import gang_identity


class _NullSpan:
    """The shared no-op span: the whole disarmed surface."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self, label: str) -> None:
        pass

    def set(self, **args) -> None:
        pass

    def close(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One armed span, made by `Tracer.span` and closed by the context
    manager (or `close()`)."""

    __slots__ = ("_tracer", "name", "args", "tid", "t0_ns", "dur_ns",
                 "_marks")

    def __init__(self, tracer: "Tracer", name: str, tid: int,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.tid = tid
        self.t0_ns = time.perf_counter_ns()
        self.dur_ns = 0
        self._marks = None

    def mark(self, label: str) -> None:
        """Record a named timestamp (`<label>_us`, offset from the
        start, in the args); a last mark `dispatched` also yields
        `device_wait_us` = close - mark."""
        if self._marks is None:
            self._marks = []
        self._marks.append((label, time.perf_counter_ns()))

    def set(self, **args) -> None:
        """Attach or overwrite args."""
        self.args.update(args)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.close()
        return False

    def close(self) -> None:
        end = time.perf_counter_ns()
        self.dur_ns = end - self.t0_ns
        if self._marks:
            for label, t in self._marks:
                self.args[f"{label}_us"] = round((t - self.t0_ns) / 1000.0, 3)
            last_label, last_t = self._marks[-1]
            if last_label == "dispatched":
                self.args["device_wait_us"] = round((end - last_t) / 1000.0, 3)
        self._tracer._emit_span(self)


class Tracer:
    """Buffered span / instant / counter recorder of one process.

    `enabled` is fixed at construction: the global disarmed tracer is a
    singleton whose emitters are two-branch no-ops, and arming
    (`obs.configure`) swaps in a fresh enabled one; call sites read the
    global through `obs.tracer()` each query."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.trace_id = uuid.uuid4().hex if enabled else None
        self._buf = deque()  # append is atomic under the interpreter lock
        self._meta_rows: list = []  # (tid, name) thread rows
        self._tids: Dict[int, int] = {}
        self._tid_counter = itertools.count()
        self._lock = threading.Lock()  # the tid registry only
        self._t_anchor_ns = time.perf_counter_ns()
        self._wall_anchor = time.time()

    @property
    def pid(self) -> int:
        """The process rank, read live: `torch.distributed`'s rank once
        a process group is initialized (it may start after arming),
        else 0."""
        return gang_identity()[0]

    @property
    def nprocs(self) -> int:
        """The world size, read live like `pid`."""
        return gang_identity()[1]

    # ---- track bookkeeping ----

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, next(self._tid_counter))
            name = threading.current_thread().name
            self._meta_rows.append((tid, "host" if tid == 0 else name))
        return tid

    def _band_tid(self, base: int, idx: int, label: str) -> int:
        tid = base + int(idx)
        if tid not in self._tids:
            with self._lock:
                if tid not in self._tids:
                    self._tids[tid] = tid
                    self._meta_rows.append((tid, f"{label}/{idx}"))
        return tid

    def frag_tid(self, fid: int) -> int:
        """The per-fragment track row (named on first use)."""
        return self._band_tid(FRAG_TID_BASE, fid, "frag")

    def lane_tid(self, lane: int) -> int:
        """The per-lane row of a batched serve dispatch: each query of a
        batch renders on its own row (the batch's interval; attribution,
        not measurement, so the rollup leaves it out)."""
        return self._band_tid(LANE_TID_BASE, lane, "lane")

    def replica_tid(self, replica: int) -> int:
        """The per-replica row of the fleet router's pump passes."""
        return self._band_tid(REPLICA_TID_BASE, replica, "replica")

    # ---- emitters ----

    def _push(self, ev: Dict[str, Any]) -> None:
        """Buffer one event, stamped with `rank` / `nprocs` when the
        process is one of several (a single process keeps the plain
        schema)."""
        n = self.nprocs
        if n > 1:
            ev["rank"] = ev["pid"]
            ev["nprocs"] = n
        self._buf.append(ev)

    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, self._tid(), args)

    def _emit_span(self, span: Span) -> None:
        self._push(span_event(
            span.name, ts_ns=span.t0_ns, dur_ns=span.dur_ns,
            pid=self.pid, tid=span.tid, args=span.args or None))

    def emit_span_raw(self, name: str, *, t0_ns: int, dur_ns: int,
                      tid: int, **args) -> None:
        """Re-emit an interval on another track (the worker mirrors
        superstep spans onto per-fragment rows: the fragments of the one
        card run each round together)."""
        if not self.enabled:
            return
        self._push(span_event(name, ts_ns=t0_ns, dur_ns=dur_ns,
                              pid=self.pid, tid=tid, args=args or None))

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._push(instant_event(
            name, ts_ns=time.perf_counter_ns(), pid=self.pid,
            tid=self._tid(), args=args or None))

    def counter(self, name: str, **values) -> None:
        if not self.enabled:
            return
        self._push(counter_event(
            name, ts_ns=time.perf_counter_ns(), pid=self.pid,
            tid=self._tid(), values=values))

    # ---- draining ----

    def drain(self) -> list:
        """Pop every buffered event (the metadata rows stay: they go out
        with every flush, so a partial file stays labelled)."""
        out = []
        while True:
            try:
                out.append(self._buf.popleft())
            except IndexError:
                return out

    def events(self) -> list:
        """Metadata plus the buffered events, without draining."""
        return self.metadata() + list(self._buf)

    def metadata(self) -> list:
        """Process and thread name rows, built at export time so they
        carry the current rank."""
        if not self.enabled:
            return []
        pid = self.pid
        rows = [metadata_event("process_name", pid=pid, name=f"grape/r{pid}")]
        rows += [metadata_event("thread_name", pid=pid, tid=tid, name=name)
                 for tid, name in list(self._meta_rows)]
        n = self.nprocs
        if n > 1:
            for ev in rows:
                ev["rank"] = pid
                ev["nprocs"] = n
        return rows

    def wall_anchor(self) -> Dict[str, float]:
        """The monotonic clock against the wall clock, for the export's
        metadata."""
        return {"perf_counter_ns": self._t_anchor_ns,
                "unix_time": self._wall_anchor}


#: the disarmed singleton every call site sees until `obs.configure`
DISABLED = Tracer(enabled=False)
