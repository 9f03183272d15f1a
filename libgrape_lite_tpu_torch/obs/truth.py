"""Overlap truth meter: the modeled `hidden_us_per_round` against the
measured round, joined per plan uid.

Counterpart of `libgrape_lite_tpu/obs/truth.py`.  A pipeline decision's
headline is modeled: the overlap model (parallel/pipeline.py) prices the
boundary and interior edges and the exchange bytes under the rate
profile and claims `hidden_us_per_round` of exchange hidden under the
interior pull.  The tracer measures: a span that marks `dispatched`
before its sync reports `device_wait_us`, the wait for the card.  This
module joins the two per plan uid (the key grape-lint R12 makes every
modeled claim carry) and reports the claim against the measured round,
``claim_frac = modeled_hidden_us_per_round / measured_round_us``.

A claim_frac above the limit (default 1.25) claims more hidden exchange
a round than the whole measured round took: the rate profile or the edge
totals are wrong.  On one card the exchange is a copy in device memory
priced at the profile's unmeasured link rate, so the report informs and
gates nothing.

The worker here runs one `superstep` span a round (the JAX package's
stepwise form): a query's measured round is the median `device_wait_us`
of its superstep spans.  Spans carrying `compiled_us` (a CUDA library
built or loaded, or a plan cache missed, inside the round) are excluded
and counted: build time would launder the claim.

Joined rows feed the rate profile's harvest
(`ops.calibration.harvest_overlap`, armed by GRAPE_CALIBRATE_HARVEST).
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: modeled hidden µs may not exceed the measured round wall by more
#: than this factor (a little slack for clock/model noise)
DEFAULT_CLAIM_LIMIT = 1.25


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def truth_report(events,
                 claim_limit: float = DEFAULT_CLAIM_LIMIT) -> dict:
    """Join every engaged pipelined query span in `events` against its
    measured device waits (JAX `truth_report`): a query span with its own
    `device_wait_us` covers PEval and `rounds` IncEvals in one wait; any
    other joins the superstep spans inside its window (same pid) and
    takes their median `device_wait_us`.  Spans carrying `compiled_us`
    are excluded and counted."""
    evs = [e for e in events if isinstance(e, dict)]
    queries = [e for e in evs
               if e.get("ph") == "X" and e.get("name") == "query"]
    supersteps = [e for e in evs
                  if e.get("ph") == "X" and e.get("name") == "superstep"]
    rows: List[dict] = []
    excluded_compile = 0
    for q in queries:
        a = q.get("args") or {}
        pipe = a.get("pipeline") or {}
        if not pipe.get("engaged"):
            continue
        modeled = float(pipe.get("hidden_us_per_round") or 0.0)
        rounds = int(a.get("rounds") or 0)
        measured: Optional[float] = None
        n_meas = 0
        if "compiled_us" in a:
            # the one wait includes a build: no honest device
            # split exists for this query
            excluded_compile += 1
        elif "device_wait_us" in a:
            # one wait covers PEval + `rounds` IncEvals
            measured = float(a["device_wait_us"]) / max(rounds + 1, 1)
            n_meas = rounds + 1
        else:
            # stepwise: the per-round superstep spans inside the
            # query window carry the splits
            t0 = float(q.get("ts", 0))
            t1 = t0 + float(q.get("dur", 0))
            waits = []
            for s in supersteps:
                if s.get("pid") != q.get("pid"):
                    continue
                sa = s.get("args") or {}
                if "device_wait_us" not in sa:
                    continue
                ts = float(s.get("ts", 0))
                if not (t0 <= ts <= t1):
                    continue
                if "compiled_us" in sa:
                    excluded_compile += 1
                    continue
                waits.append(float(sa["device_wait_us"]))
            if waits:
                measured = _median(waits)
                n_meas = len(waits)
        row: Dict[str, object] = {
            "plan_uid": pipe.get("plan_uid") or "-",
            "mode": pipe.get("mode"),
            "modeled_hidden_us_per_round": modeled,
            "measured_round_us": measured,
            "rounds_measured": n_meas,
            "joined": measured is not None,
        }
        if measured is not None and measured > 0:
            frac = round(modeled / measured, 4)
            row["claim_frac"] = frac
            row["ok"] = frac <= claim_limit
        else:
            row["claim_frac"] = None
            row["ok"] = None
        rows.append(row)
    joined = [r for r in rows if r["joined"]]
    fracs = [r["claim_frac"] for r in joined
             if r["claim_frac"] is not None]
    return {
        "queries": len(rows),
        "joined": len(joined),
        "compile_rounds_excluded": excluded_compile,
        "claim_limit": claim_limit,
        "max_claim_frac": max(fracs) if fracs else None,
        "median_claim_frac": _median(fracs) if fracs else None,
        "ok": (all(bool(r["ok"]) for r in joined
                   if r["ok"] is not None)
               if joined else True),
        "rows": rows,
    }


def block_brief(report: dict) -> dict:
    """The report's first joined row as flat scalars (the JAX bench
    block's keys)."""
    first = next((r for r in report["rows"] if r["joined"]), None) or {}
    return {
        "queries": int(report["queries"]),
        "joined": int(report["joined"]),
        "plan_uid": str(first.get("plan_uid") or "-"),
        "modeled_hidden_us_per_round": float(
            first.get("modeled_hidden_us_per_round") or 0.0),
        "measured_round_us": float(
            first.get("measured_round_us") or 0.0),
        "claim_frac": float(first.get("claim_frac") or 0.0),
        "compile_rounds_excluded": int(
            report["compile_rounds_excluded"]),
        "ok": bool(report["ok"]),
    }


def harvest_report(events_or_report, pipe_brief: Optional[dict] = None,
                   ) -> int:
    """Feed every joined row into the rate profile's harvest (a no-op
    unless GRAPE_CALIBRATE_HARVEST is armed).  Takes an event list or a
    built report; `pipe_brief` (the live plan's `span_brief()`) supplies
    the edge and byte columns, without which a row has none and is
    skipped.  Returns the rows harvested."""
    from libgrape_lite_tpu_torch.ops import calibration as calib

    if not calib.harvest_armed():
        return 0
    report = (events_or_report
              if isinstance(events_or_report, dict)
              else truth_report(events_or_report))
    n = 0
    for row in report["rows"]:
        if not row["joined"]:
            continue
        brief = dict(pipe_brief or {})
        brief.setdefault("plan_uid", row["plan_uid"])
        brief.setdefault("hidden_us_per_round",
                         row["modeled_hidden_us_per_round"])
        sample = calib.harvest_overlap(
            brief, float(row["measured_round_us"]),
            max(int(row["rounds_measured"]), 1),
        )
        if sample is not None:
            n += 1
    return n
