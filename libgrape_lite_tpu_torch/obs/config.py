"""Global observability state: arming, the environment, flushing.

Counterpart of `libgrape_lite_tpu/obs/config.py`.  Off by default; three
ways to arm:

* environment -- `GRAPE_TRACE=/path/out.json` (a Chrome trace, with a
  JSONL twin `out.jsonl` beside it) and / or `GRAPE_METRICS=/path/m`
  (`m.json` and `m.prom` at each flush), read once, lazily, at the first
  `obs.tracer()` / `obs.metrics()`; an `atexit` hook flushes at exit;
* the command line -- `run_app --trace / --metrics` and the same flags
  of `serve` call `configure`;
* the API -- `obs.configure(trace_path=..., metrics_path=...,
  in_memory=True)`; `in_memory` arms with no file sink and keeps the
  history for `obs.history()`.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Optional

from libgrape_lite_tpu_torch.obs import export as _export
from libgrape_lite_tpu_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from libgrape_lite_tpu_torch.obs.tracer import DISABLED, Tracer

TRACE_ENV = "GRAPE_TRACE"
METRICS_ENV = "GRAPE_METRICS"

_lock = threading.Lock()
_state = {
    "resolved": False,     # the environment read yet?
    "tracer": DISABLED,
    "metrics": NULL_METRICS,
    "trace_path": None,    # Chrome JSON
    "jsonl_path": None,
    "metrics_path": None,  # base name: .json / .prom appended
    "in_memory": False,    # keep the history with no file sink
    "chrome_history": [],  # every flushed event, for the whole-file rewrite
    "atexit": False,
}


def _jsonl_twin(trace_path: str) -> str:
    base, ext = os.path.splitext(trace_path)
    return (base if ext else trace_path) + ".jsonl"


def _rank_suffixed(path: Optional[str], rank: int,
                   default_ext: str) -> Optional[str]:
    if not path or not rank:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.r{rank}{ext or default_ext}"


def _sink_paths():
    """(trace, jsonl, metrics) paths, suffixed with the rank when it is
    not 0, resolved at flush time (a process group can start after the
    tracer was armed)."""
    tr = _state["tracer"]
    rank = tr.pid if tr.enabled else 0
    return (
        _rank_suffixed(_state["trace_path"], rank, ".json"),
        _rank_suffixed(_state["jsonl_path"], rank, ".jsonl"),
        (f"{_state['metrics_path']}.r{rank}"
         if rank and _state["metrics_path"] else _state["metrics_path"]),
    )


def _resolve_env_locked() -> None:
    if _state["resolved"]:
        return
    _state["resolved"] = True
    trace = os.environ.get(TRACE_ENV, "")
    metrics = os.environ.get(METRICS_ENV, "")
    if trace or metrics:
        _configure_locked(trace_path=trace or None,
                          metrics_path=metrics or None)


def _configure_locked(*, trace_path: Optional[str] = None,
                      jsonl_path: Optional[str] = None,
                      metrics_path: Optional[str] = None,
                      in_memory: bool = False) -> None:
    if trace_path and not jsonl_path:
        jsonl_path = _jsonl_twin(trace_path)
    _state["trace_path"] = trace_path
    _state["jsonl_path"] = jsonl_path
    _state["metrics_path"] = metrics_path
    _state["in_memory"] = in_memory
    _state["tracer"] = Tracer(enabled=True)
    _state["metrics"] = MetricsRegistry()
    _state["chrome_history"] = []
    _state["resolved"] = True
    if not in_memory and not _state["atexit"]:
        _state["atexit"] = True
        atexit.register(flush)


def configure(*, trace_path: Optional[str] = None,
              jsonl_path: Optional[str] = None,
              metrics_path: Optional[str] = None,
              in_memory: bool = False) -> Tracer:
    """Arm observability; returns the new tracer."""
    with _lock:
        _configure_locked(trace_path=trace_path, jsonl_path=jsonl_path,
                          metrics_path=metrics_path, in_memory=in_memory)
        return _state["tracer"]


def reset() -> None:
    """Disarm and forget the environment read (tests re-arm per case)."""
    with _lock:
        _state["resolved"] = False
        _state["tracer"] = DISABLED
        _state["metrics"] = NULL_METRICS
        _state["trace_path"] = None
        _state["jsonl_path"] = None
        _state["metrics_path"] = None
        _state["in_memory"] = False
        _state["chrome_history"] = []
    from libgrape_lite_tpu_torch.obs import gang

    gang.reset()  # the cached clock handshake goes with the rest


def tracer() -> Tracer:
    if not _state["resolved"]:
        with _lock:
            _resolve_env_locked()
    return _state["tracer"]


def metrics():
    if not _state["resolved"]:
        with _lock:
            _resolve_env_locked()
    return _state["metrics"]


def armed() -> bool:
    return tracer().enabled


def trace_id() -> Optional[str]:
    return tracer().trace_id


def flush() -> dict:
    """Drain the buffered events into the configured sinks; returns
    {"events": n, "trace": path | None, "jsonl": path | None,
    "metrics": base | None}.  Cheap disarmed or with no sink."""
    tr = _state["tracer"]
    out = {"events": 0, "trace": None, "jsonl": None, "metrics": None}
    if not tr.enabled:
        return out
    drained = tr.drain()
    out["events"] = len(drained)
    trace_path, jsonl_path, mp = _sink_paths()
    if jsonl_path and (drained or tr.metadata()):
        _export.append_jsonl(tr.metadata() + drained, jsonl_path)
        out["jsonl"] = jsonl_path
    if trace_path or _state["in_memory"]:
        # the Chrome rewrite and the in-memory history need every event;
        # with metrics alone the drained events have no reader and go
        _state["chrome_history"].extend(drained)
    if trace_path:
        _export.write_chrome_trace(
            tr.metadata() + _state["chrome_history"], trace_path,
            trace_id=tr.trace_id, anchor=tr.wall_anchor())
        out["trace"] = trace_path
    if mp:
        _state["metrics"].write(json_path=mp + ".json",
                                prom_path=mp + ".prom")
        out["metrics"] = mp
    if _state["trace_path"] and tr.nprocs > 1:
        # a gang rank also rewrites its sidecar, so the assembler
        # (trace_report --gang) sees everything flushed so far; one
        # process never touches the gang directory
        from libgrape_lite_tpu_torch.obs import gang

        gang.write_sidecar()
    return out


def history() -> list:
    """Every event of this armed session, flushed and pending."""
    tr = _state["tracer"]
    if not tr.enabled:
        return []
    return tr.metadata() + _state["chrome_history"] + list(tr._buf)
