"""Exporters: the JSONL sink, Chrome trace_event JSON, span rollups.

Counterpart of `libgrape_lite_tpu/obs/export.py`; both file formats
serialize the same event dicts (obs/events.py):

* JSONL -- one event a line, appended: a killed process leaves every
  flushed line readable.  Each flush starts with the metadata rows, so a
  file of several flushes still labels its rows.
* Chrome JSON object format -- `{"traceEvents": [...], ...}`, loadable in
  Perfetto / `chrome://tracing`, rewritten whole at each flush; its
  `metadata` holds the trace id and the clock anchor.

`rollup()` gives per-span-name wall totals (scripts/trace_report.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

from libgrape_lite_tpu_torch.obs.events import FRAG_TID_BASE


def append_jsonl(events: Iterable[dict], path: str) -> int:
    """Append one JSON line per event; returns the count written."""
    n = 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as fh:
        for ev in events:
            fh.write(json.dumps(ev, sort_keys=True))
            fh.write("\n")
            n += 1
    return n


def write_chrome_trace(events: List[dict], path: str, *,
                       trace_id: Optional[str] = None,
                       anchor: Optional[dict] = None) -> None:
    doc = {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "metadata": {
            "producer": "libgrape-lite-tpu obs/",
            **({"trace_id": trace_id} if trace_id else {}),
            **({"clock_anchor": anchor} if anchor else {}),
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    os.replace(tmp, path)  # a reader never sees a half-written trace


def load_trace(path: str) -> List[dict]:
    """Events from either format, told apart by content: a JSON object
    with `traceEvents`, a JSON array, or JSONL."""
    with open(path) as fh:
        text = fh.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and "traceEvents" in doc:
            return list(doc["traceEvents"])
    if stripped.startswith("["):
        return list(json.loads(text))
    events = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            events.append(json.loads(line))
    return events


def rollup(events: Iterable[dict],
           include_frag_rows: bool = False) -> Dict[str, dict]:
    """{span name: {count, total_s, mean_s, max_s}} over the `X` events.
    The rows at or above FRAG_TID_BASE restate a host interval (per
    fragment, lane or replica) and are left out unless asked for, so
    totals stay wall time."""
    acc: Dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if not include_frag_rows and ev.get("tid", 0) >= FRAG_TID_BASE:
            continue
        name = ev.get("name", "?")
        dur_s = float(ev.get("dur", 0)) / 1e6
        r = acc.get(name)
        if r is None:
            acc[name] = {"count": 1, "total_s": dur_s, "max_s": dur_s}
        else:
            r["count"] += 1
            r["total_s"] += dur_s
            r["max_s"] = max(r["max_s"], dur_s)
    for r in acc.values():
        r["total_s"] = round(r["total_s"], 6)
        r["max_s"] = round(r["max_s"], 6)
        r["mean_s"] = round(r["total_s"] / r["count"], 6)
    return acc
