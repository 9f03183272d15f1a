"""Flight recorder: a cheap ring of recent events that dumps a
postmortem bundle when something goes wrong.

Counterpart of `libgrape_lite_tpu/obs/recorder.py`; its bundle schema and
layout are the JAX package's, so a bundle of either package renders in
the other's `postmortem` subcommand.

The ring (`deque(maxlen=...)`, 512 by default) costs one append per
`record()`; there is no arming step, so the events leading into a
failure are already there when it fires.  Two triggers dump here: a
fleet fence violation (fleet/router.py) and a deadline storm
(serve/queue.py: at least `DEADLINE_STORM_THRESHOLD` queries expired in
one sweep).  The JAX package's third, a guard breach, waits for guard/.

A dump is written only with a sink (`GRAPE_POSTMORTEM=<dir>` or
`set_sink()`); without one a trigger still counts in the federated
`recorder` namespace.  Triggers never raise.

Bundle (`grape-postmortem-v1`):

* `reason` -- what tripped the dump; `extra` -- the trigger's context;
* `trace_id` / `wall_anchor` -- the join to the Chrome trace;
* `events` -- the recorder's own ring;
* `spans` / `instants` -- the last tracer events, verbatim: a bundle's
  span row serializes byte for byte as the same row of the trace;
* `federation` -- the stats federation's snapshot;
* `guard` -- the guard bundle of a breach (None here).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from libgrape_lite_tpu_torch.obs.federation import FederatedStats

POSTMORTEM_ENV = "GRAPE_POSTMORTEM"
RING_CAPACITY = 512
BUNDLE_SPANS = 256
DEADLINE_STORM_THRESHOLD = 8
BUNDLE_SCHEMA = "grape-postmortem-v1"

REC_STATS = FederatedStats("recorder", {
    "recorded": 0,
    "dropped": 0,
    "triggers": 0,
    "dumps": 0,
    "last_reason": None,
})


class FlightRecorder:
    """A bounded ring of breadcrumbs and the postmortem dump."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._sink: Optional[str] = None
        self._seq = 0

    # ---- the cheap side ----

    def record(self, kind: str, **detail) -> None:
        """One breadcrumb; the deque drops its oldest entry itself and
        the drop counter keeps that visible."""
        if len(self._ring) == self._ring.maxlen:
            REC_STATS["dropped"] += 1
        self._ring.append({"kind": kind, "t_ns": time.perf_counter_ns(),
                           **detail})
        REC_STATS["recorded"] += 1

    def events(self) -> List[dict]:
        return list(self._ring)

    # ---- the dump side ----

    def set_sink(self, path: Optional[str]) -> None:
        """The directory bundles go to (None: the environment only)."""
        self._sink = path

    def sink(self) -> Optional[str]:
        return self._sink or os.environ.get(POSTMORTEM_ENV) or None

    def build_bundle(self, reason: str,
                     extra: Optional[Dict[str, Any]] = None,
                     guard: Optional[Dict[str, Any]] = None) -> dict:
        from libgrape_lite_tpu_torch import obs
        from libgrape_lite_tpu_torch.obs import federation
        from libgrape_lite_tpu_torch.obs.metrics import gang_identity

        spans: List[dict] = []
        instants: List[dict] = []
        trace_id = wall_anchor = None
        try:
            if obs.armed():
                trace_id = obs.trace_id()
                wall_anchor = obs.tracer().wall_anchor()
                # the history holds the exported dicts themselves, so a
                # bundle row serializes as the trace's row
                for ev in obs.history():
                    ph = ev.get("ph")
                    if ph == "X":
                        spans.append(ev)
                    elif ph == "i":
                        instants.append(ev)
                spans = spans[-BUNDLE_SPANS:]
                instants = instants[-BUNDLE_SPANS:]
        except Exception:  # forensics must not fail the run
            pass
        try:
            fed = federation.snapshot()
        except Exception:
            fed = {}
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "trace_id": trace_id,
            "wall_anchor": wall_anchor,
            "events": self.events(),
            "spans": spans,
            "instants": instants,
            "federation": fed,
            "guard": guard,
            "extra": extra or {},
        }
        rank, nprocs = gang_identity()
        if nprocs > 1:
            bundle["rank"] = rank
            bundle["nprocs"] = nprocs
        return bundle

    def trigger(self, reason: str,
                extra: Optional[Dict[str, Any]] = None,
                guard: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Count the moment; dump `postmortem_<reason>_<seq>.json` into
        the sink when one is set.  Returns the bundle's path or None;
        never raises."""
        try:
            REC_STATS["triggers"] += 1
            REC_STATS["last_reason"] = reason
            sink = self.sink()
            if not sink:
                return None
            bundle = self.build_bundle(reason, extra=extra, guard=guard)
            with self._lock:
                self._seq += 1
                seq = self._seq
            os.makedirs(sink, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)
            path = os.path.join(sink, f"postmortem_{safe}_{seq:03d}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(bundle, fh, indent=1, sort_keys=False, default=str)
                fh.write("\n")
            os.replace(tmp, path)
            REC_STATS["dumps"] += 1
            try:
                from libgrape_lite_tpu_torch import obs

                obs.tracer().instant("postmortem", reason=reason, path=path)
            except Exception:
                pass
            return path
        except Exception:
            return None


RECORDER = FlightRecorder()
