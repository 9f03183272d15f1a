"""Gang-wide observability: sidecars, the clock handshake, the assembler
and the distributed flight recorder.

Counterpart of `libgrape_lite_tpu/obs/gang.py`, with its schemas, file
layout, word split and incident ids, so a gang's sidecars and incident
bundles read the same in either package.  The single-process telemetry
(the tracer's Chrome trace, the federation's scrape) sees one rank; the
machinery it should watch across ranks (guard/vote.py's breach votes,
ft/distributed.py's two-phase checkpoints) spans all of them.  Three
pieces, none on the device path:

* **Per-rank sidecars** -- each rank rewrites one JSON file
  (``<trace base>.gang/rank_<r>.json``, schema ``grape-gang-trace-v1``)
  with its whole event history, its federated ``*_STATS`` snapshot and
  the clock handshake, as an atomic whole-file replace at each superstep
  boundary: a rank killed mid-run (``os._exit`` skips atexit) leaves its
  last complete snapshot.
* **Clock handshake** -- `perf_counter` is per process, so raw
  timestamps of two ranks do not compare.  `ensure_handshake` allgathers
  every rank's monotonic and wall anchors at one collective instant (the
  int64 nanoseconds ride the int32 `host_allgather` as 30-bit words) and
  derives ``offset_ns[r] = anchor[0] - anchor[r]``; the assembler shifts
  rank r's events by it onto rank 0's clock.  The residual skew is at
  most the allgather's wall, recorded in the handshake.
* **Gang postmortem** -- a breach vote halts every rank at the same cut
  (guard/vote.py), so every rank dumps its flight-recorder bundle under
  one incident id (a digest of the voted content: no extra message
  carries it) and joins one more allgather with a 28-bit sha prefix of
  the bytes it dumped.  Rank 0 then writes the manifest
  (``incident_<id>/gang.json``), checking each shard against its rank's
  vote.

Symmetry contract: everything here that allgathers (the handshake, the
postmortem's sha confirm) is gated on state that is the same on every
rank (``GRAPE_TRACE`` / ``GRAPE_POSTMORTEM`` set for the whole gang, the
same CLI flags), the contract the breach vote relies on too.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np

from libgrape_lite_tpu_torch.obs.federation import FederatedStats

GANG_TRACE_SCHEMA = "grape-gang-trace-v1"
GANG_BUNDLE_SCHEMA = "grape-gang-postmortem-v1"

GANG_STATS = FederatedStats("gang", {
    "handshakes": 0,
    "sidecar_writes": 0,
    "assemblies": 0,
    "halts": 0,
    "postmortems": 0,
    "last_incident": None,
})

#: int64 nanoseconds ride the int32 allgather as little-endian 30-bit
#: words (3 words: 90 bits, above any wall-clock nanosecond count)
_WORD_BITS = 30
_WORD_MASK = (1 << _WORD_BITS) - 1
_NS_WORDS = 3

_state: Dict[str, Any] = {"handshake": None}


def reset() -> None:
    """Forget the cached handshake (obs.reset calls it)."""
    _state["handshake"] = None


# ---- clock handshake -------------------------------------------------------


def _split_ns(v: int) -> List[int]:
    v = int(v)
    return [(v >> (_WORD_BITS * i)) & _WORD_MASK for i in range(_NS_WORDS)]


def _join_ns(words) -> int:
    return sum((int(w) & _WORD_MASK) << (_WORD_BITS * i)
               for i, w in enumerate(words))


def _default_allgather():
    from libgrape_lite_tpu_torch.parallel.comm_spec import host_allgather

    return host_allgather


def _identity(rank, nprocs) -> tuple:
    if rank is None or nprocs is None:
        from libgrape_lite_tpu_torch.obs.metrics import gang_identity

        return gang_identity()
    return int(rank), int(nprocs)


def ensure_handshake(*, rank: Optional[int] = None,
                     nprocs: Optional[int] = None, allgather=None,
                     force: bool = False) -> Optional[dict]:
    """Run (or return the cached) clock-offset handshake: every rank reads
    its monotonic and wall anchors just before one collective allgather,
    so the offsets onto rank 0's clock are the same on every rank and the
    assembler can run anywhere.  None for one process."""
    if _state["handshake"] is not None and not force:
        return _state["handshake"]
    rank, nprocs = _identity(rank, nprocs)
    if nprocs <= 1:
        return None
    if allgather is None:
        allgather = _default_allgather()
    t0 = time.perf_counter_ns()
    vec = _split_ns(t0) + _split_ns(time.time_ns())
    stacked = np.asarray(allgather(np.asarray(vec, np.int32)))
    t1 = time.perf_counter_ns()
    anchors = [{"perf_ns": _join_ns(row[:_NS_WORDS]),
                "wall_ns": _join_ns(row[_NS_WORDS:2 * _NS_WORDS])}
               for row in stacked.tolist()]
    hs = {
        "rank": rank,
        "nprocs": int(stacked.shape[0]),
        "anchors": anchors,
        "offsets_ns": {str(r): anchors[0]["perf_ns"] - a["perf_ns"]
                       for r, a in enumerate(anchors)},
        "allgather_wall_ns": t1 - t0,  # the skew's upper bound
    }
    _state["handshake"] = hs
    GANG_STATS["handshakes"] += 1
    return hs


# ---- per-rank sidecars -----------------------------------------------------


def gang_dir(trace_path: Optional[str] = None) -> Optional[str]:
    """`<trace base>.gang/` beside the configured Chrome trace, or None
    when tracing has no file sink."""
    if trace_path is None:
        from libgrape_lite_tpu_torch.obs import config

        trace_path = config._state["trace_path"]
    if not trace_path:
        return None
    base, ext = os.path.splitext(trace_path)
    return (base if ext else trace_path) + ".gang"


def sidecar_path(rank: int,
                 trace_path: Optional[str] = None) -> Optional[str]:
    d = gang_dir(trace_path)
    return os.path.join(d, f"rank_{int(rank)}.json") if d else None


def write_sidecar(*, tracer=None, path: Optional[str] = None,
                  handshake: Optional[dict] = None,
                  events: Optional[list] = None) -> Optional[str]:
    """Atomically rewrite this rank's sidecar with its whole event history
    and federation snapshot (a whole-file replace: a rank killed between
    writes leaves the previous complete one).  Returns the path, or None
    when disarmed or with no file sink.  Never raises."""
    try:
        from libgrape_lite_tpu_torch import obs
        from libgrape_lite_tpu_torch.obs import federation

        if tracer is None:
            tracer = obs.tracer()
        if not tracer.enabled:
            return None
        rank = tracer.pid
        if path is None:
            path = sidecar_path(rank)
        if path is None:
            return None
        if handshake is None:
            handshake = _state["handshake"]
        if events is None:
            events = (obs.history() if tracer is obs.tracer()
                      else tracer.events())
        try:
            fed = federation.snapshot()
        except Exception:
            fed = {}
        doc = {
            "schema": GANG_TRACE_SCHEMA,
            "rank": int(rank),
            "nprocs": int(tracer.nprocs),
            "trace_id": tracer.trace_id,
            "wall_anchor": tracer.wall_anchor(),
            "handshake": handshake,
            "federation": fed,
            "events": list(events),
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, default=str)
            fh.write("\n")
        os.replace(tmp, path)
        GANG_STATS["sidecar_writes"] += 1
        return path
    except Exception:
        return None


# ---- the assembler ---------------------------------------------------------

_SIDE_RE = re.compile(r"^rank_(\d+)\.json$")


def load_sidecars(dirpath: str) -> List[dict]:
    """Every `rank_<r>.json` under `dirpath`, sorted by rank."""
    docs = []
    for fn in sorted(os.listdir(dirpath)):
        m = _SIDE_RE.match(fn)
        if not m:
            continue
        with open(os.path.join(dirpath, fn)) as fh:
            doc = json.load(fh)
        doc["rank"] = int(doc.get("rank", int(m.group(1))))
        docs.append(doc)
    docs.sort(key=lambda d: d["rank"])
    return docs


def _count(docs, pred) -> Dict[str, int]:
    return {str(d["rank"]): sum(1 for e in d.get("events", ()) if pred(e))
            for d in docs}


def assemble(dirpath: str, out_path: Optional[str] = None) -> dict:
    """Merge every rank sidecar under `dirpath` into one Perfetto timeline
    (a process track a rank) and report its completeness.

    Each rank's non-metadata events shift by the handshake's
    `offset_ns[rank]` onto rank 0's clock; the merged stream is sorted, so
    its timestamps are monotonic by construction (the summary checks
    it).  Flow legs (ph s / t / f) keep their `(cat, id)`, so Perfetto
    draws the vote and commit arrows across the rank tracks."""
    docs = load_sidecars(dirpath)
    if not docs:
        return {"ranks": [], "nprocs": 0, "events": 0, "complete": False,
                "monotonic": False, "aligned": False, "missing": [],
                "flow_ids": 0, "flow_events": 0, "spans_by_rank": {},
                "supersteps_by_rank": {}, "out": None}
    nprocs = max(int(d.get("nprocs", 1)) for d in docs)
    offsets: Dict[int, int] = {}
    for d in docs:
        hs = d.get("handshake") or {}
        for k, v in (hs.get("offsets_ns") or {}).items():
            offsets.setdefault(int(k), int(v))
    merged: List[dict] = []
    aligned = True
    for d in docs:
        off = offsets.get(d["rank"])
        if off is None:
            off = 0
            if nprocs > 1:
                aligned = False
        off_us = off / 1000.0
        for ev in d.get("events", ()):
            ev = dict(ev)
            if ev.get("ph") != "M":
                ev["ts"] = float(ev.get("ts", 0)) + off_us
            merged.append(ev)
    merged.sort(key=lambda e: (0 if e.get("ph") == "M" else 1,
                               float(e.get("ts", 0)), int(e.get("pid", 0))))
    ranks = [d["rank"] for d in docs]
    missing = [r for r in range(nprocs) if r not in ranks]
    spans_by_rank = _count(docs, lambda e: e.get("ph") == "X")
    supersteps_by_rank = _count(
        docs, lambda e: e.get("ph") == "X" and e.get("name") == "superstep")
    flows: Dict[tuple, set] = {}
    flow_events = 0
    for ev in merged:
        if ev.get("ph") in ("s", "t", "f"):
            flow_events += 1
            flows.setdefault((ev.get("cat"), ev.get("id")),
                             set()).add(ev.get("pid"))
    ts_seq = [float(e["ts"]) for e in merged if e.get("ph") != "M"]
    summary = {
        "ranks": ranks,
        "nprocs": nprocs,
        "events": len(merged),
        "spans_by_rank": spans_by_rank,
        "supersteps_by_rank": supersteps_by_rank,
        "flow_ids": len(flows),
        "flow_events": flow_events,
        "cross_rank_flows": sum(1 for p in flows.values() if len(p) >= 2),
        "missing": missing,
        "aligned": aligned,
        "monotonic": all(b >= a for a, b in zip(ts_seq, ts_seq[1:])),
        "complete": (not missing and aligned
                     and all(v > 0 for v in spans_by_rank.values())),
        "out": None,
    }
    if out_path:
        doc = {
            "traceEvents": merged,
            "displayTimeUnit": "ms",
            "metadata": {
                "producer": "libgrape-lite-tpu obs/gang",
                "gang": {
                    "schema": GANG_TRACE_SCHEMA,
                    "nprocs": nprocs,
                    "ranks": ranks,
                    "offsets_ns": {str(k): v
                                   for k, v in sorted(offsets.items())},
                    "trace_ids": {str(d["rank"]): d.get("trace_id")
                                  for d in docs},
                    "federation": {str(d["rank"]): d.get("federation")
                                   for d in docs},
                },
            },
        }
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        os.replace(tmp, out_path)
        summary["out"] = out_path
    GANG_STATS["assemblies"] += 1
    return summary


# ---- the distributed flight recorder ---------------------------------------


def trace_word() -> int:
    """A 28-bit prefix of this process's trace id (0 disarmed): int32-safe,
    so it rides the vote and commit allgathers and lets the gathered
    matrix name every rank's trace file."""
    try:
        from libgrape_lite_tpu_torch import obs

        tid = obs.trace_id()
        return int(tid[:7], 16) if tid else 0
    except Exception:
        return 0


def incident_id(basis) -> str:
    """A deterministic 16-hex incident id over JSON-serializable content.
    guard/vote.py feeds the allgathered vote matrix (the same bytes on
    every rank), so the gang agrees on the id with no extra message."""
    raw = json.dumps(basis, sort_keys=True, default=str)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _sha_words_of_file(path: str) -> tuple:
    """Two 28-bit words of the file's sha256 (int32-safe)."""
    with open(path, "rb") as fh:
        h = hashlib.sha256(fh.read()).hexdigest()
    return int(h[:7], 16), int(h[7:14], 16)


def gang_postmortem(incident: str, reason: str, *,
                    extra: Optional[dict] = None, rank: Optional[int] = None,
                    nprocs: Optional[int] = None,
                    allgather=None) -> Optional[dict]:
    """Dump this rank's postmortem shard under the shared incident id and,
    on rank 0, write the gang manifest with each shard checked byte for
    byte against its rank's vote.

    Every rank calls this from the same cut (the breach vote sees to it):
    the sha confirm is collective.  With no sink configured it counts
    only, with no allgather (the sink is the same on every rank).  Never
    raises."""
    try:
        from libgrape_lite_tpu_torch.obs.recorder import RECORDER

        rank, nprocs = _identity(rank, nprocs)
        GANG_STATS["postmortems"] += 1
        GANG_STATS["last_incident"] = incident
        sink = RECORDER.sink()
        if not sink:
            return None
        shard = RECORDER.trigger(
            reason, extra=extra, incident=incident,
            filename=os.path.join(f"incident_{incident}",
                                  f"rank_{rank}.json"))
        ok, lo, hi = 0, 0, 0
        if shard:
            try:
                lo, hi = _sha_words_of_file(shard)
                ok = 1
            except Exception:
                ok, lo, hi = 0, 0, 0
        if nprocs > 1:
            if allgather is None:
                allgather = _default_allgather()
            votes = np.asarray(allgather(np.asarray([ok, lo, hi], np.int32)))
        else:
            votes = np.asarray([[ok, lo, hi]], np.int32)
        out = {"incident": incident, "path": shard, "manifest": None,
               "complete": None}
        if rank != 0:
            return out
        incident_dir = os.path.join(sink, f"incident_{incident}")
        shards = {}
        complete = True
        for r in range(int(votes.shape[0])):
            p = os.path.join(incident_dir, f"rank_{r}.json")
            present = os.path.exists(p)
            verified = False
            if present and int(votes[r][0]) == 1:
                try:
                    verified = (_sha_words_of_file(p)
                                == (int(votes[r][1]), int(votes[r][2])))
                except Exception:
                    verified = False
            complete = complete and present and verified
            shards[str(r)] = {
                "path": f"rank_{r}.json",
                "present": present,
                "verified": verified,
                "sha28x2": [int(votes[r][1]), int(votes[r][2])],
            }
        manifest = {
            "schema": GANG_BUNDLE_SCHEMA,
            "incident": incident,
            "reason": reason,
            "nprocs": int(votes.shape[0]),
            "complete": complete,
            "shards": shards,
        }
        os.makedirs(incident_dir, exist_ok=True)
        mpath = os.path.join(incident_dir, "gang.json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, mpath)
        out["manifest"] = mpath
        out["complete"] = complete
        return out
    except Exception:
        return None


def on_breach_halt(err, rounds, *, allgather=None) -> None:
    """The worker's hook for a vote-raised halt: an instant for the halt,
    a last sidecar, and the gang postmortem under the incident id the
    vote attached (`err.gang_incident`).  Every rank raises from the same
    vote cut, so this runs on all of them.  Never raises: forensics must
    not mask the halt."""
    try:
        incident = getattr(err, "gang_incident", None) or incident_id(
            [type(err).__name__, int(rounds)])
        GANG_STATS["halts"] += 1
        GANG_STATS["last_incident"] = incident
        from libgrape_lite_tpu_torch import obs

        tr = obs.tracer()
        if tr.enabled:
            tr.instant("gang_halt", round=int(rounds),
                       error=type(err).__name__, incident=incident)
            write_sidecar()
        extra: Dict[str, Any] = {"round": int(rounds),
                                 "error": type(err).__name__}
        bundle = getattr(err, "bundle", None)
        if isinstance(bundle, dict):
            extra["vote"] = {k: bundle[k] for k in ("rounds", "ranks", "codes")
                             if k in bundle}
        gang_postmortem(incident, f"breach_halt_{type(err).__name__}",
                        extra=extra, allgather=allgather)
    except Exception:
        pass
