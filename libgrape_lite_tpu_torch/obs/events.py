"""Event model shared by the tracer and the exporters.

Counterpart of `libgrape_lite_tpu/obs/events.py`, field for field: both
packages write the same event dicts, so a trace of either loads in the
other's readers (`obs.load_trace`, `scripts/trace_report.py`, the
`postmortem` subcommand).

One process emits a flat stream of event dicts, a strict subset of the
Chrome `trace_event` format, so the JSONL sink and the Chrome export are
two serializations of the same records.  Event kinds (the `ph` tag):

* ``X`` -- complete span: `ts` (start, us) and `dur` (us).  Two spans on
  one `(pid, tid)` row nest when one's [ts, ts + dur) holds the other's.
* ``i`` -- instant (a log line, a drain, an SLO breach).
* ``C`` -- counter (active vertices per round).
* ``M`` -- metadata: `process_name` / `thread_name` rows.  Host threads,
  per-fragment tracks (`frag/<fid>`), serve lanes (`lane/<b>`) and fleet
  replicas (`replica/<r>`) get distinct `tid` rows.
* ``s`` / ``t`` / ``f`` -- the legs of a cross-track flow arrow.

Timestamps are integer nanoseconds internally (`time.perf_counter_ns`)
and microseconds on export, Chrome's unit.
"""

from __future__ import annotations

from typing import Any, Dict

# tid rows: host threads count up from 0; per-fragment tracks, serve
# lanes and fleet replicas each have a band of their own.  All three
# bands restate host intervals, so the span rollup skips every tid at or
# above FRAG_TID_BASE
FRAG_TID_BASE = 1000
LANE_TID_BASE = 2000
REPLICA_TID_BASE = 3000

#: keys every exported event carries
CHROME_REQUIRED = ("ph", "ts", "pid", "name")


def span_event(name: str, *, ts_ns: int, dur_ns: int, pid: int, tid: int,
               args: Dict[str, Any] | None = None,
               cat: str = "grape") -> Dict[str, Any]:
    ev = {
        "ph": "X",
        "name": name,
        "cat": cat,
        "ts": ts_ns / 1000.0,
        "dur": dur_ns / 1000.0,
        "pid": pid,
        "tid": tid,
    }
    if args:
        ev["args"] = args
    return ev


def instant_event(name: str, *, ts_ns: int, pid: int, tid: int,
                  args: Dict[str, Any] | None = None,
                  cat: str = "grape") -> Dict[str, Any]:
    ev = {
        "ph": "i",
        "name": name,
        "cat": cat,
        "ts": ts_ns / 1000.0,
        "pid": pid,
        "tid": tid,
        "s": "t",  # thread-scoped (Chrome's default scope draws nothing)
    }
    if args:
        ev["args"] = args
    return ev


def counter_event(name: str, *, ts_ns: int, pid: int, tid: int,
                  values: Dict[str, float],
                  cat: str = "grape") -> Dict[str, Any]:
    return {
        "ph": "C",
        "name": name,
        "cat": cat,
        "ts": ts_ns / 1000.0,
        "pid": pid,
        "tid": tid,
        "args": dict(values),
    }


def flow_event(name: str, *, ts_ns: int, pid: int, tid: int,
               flow_id: int, phase: str,
               args: Dict[str, Any] | None = None,
               cat: str = "gang") -> Dict[str, Any]:
    """One leg of a cross-track flow arrow: `phase` "s" (start), "t"
    (step) or "f" (end); every leg of one arrow shares `(cat, flow_id)`.
    The end leg binds to its enclosing slice (`bp: "e"`)."""
    if phase not in ("s", "t", "f"):
        raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
    ev = {
        "ph": phase,
        "name": name,
        "cat": cat,
        "id": int(flow_id),
        "ts": ts_ns / 1000.0,
        "pid": pid,
        "tid": tid,
    }
    if phase == "f":
        ev["bp"] = "e"
    if args:
        ev["args"] = args
    return ev


def metadata_event(kind: str, *, pid: int, tid: int = 0,
                   name: str) -> Dict[str, Any]:
    """`kind` is `process_name` or `thread_name` (trace_event M args)."""
    return {
        "ph": "M",
        "name": kind,
        "ts": 0,
        "pid": pid,
        "tid": tid,
        "args": {"name": name},
    }
