#!/usr/bin/env python
"""Render a per-superstep table from an obs/ trace.

Counterpart of the JAX package's `scripts/trace_report.py`.  Reads a Chrome trace_event JSON or its JSONL twin -- written by
GRAPE_TRACE, `--trace` or `obs.configure`, by either package -- and
prints:

* one row per round (PEval = round 0): wall ms, device-wait ms (the wait
  in the read of the round's vote: the device-time estimate, tracer.py),
  launch ms, active vertices, and any instants inside the round;
* the 2-D tile table when the query span carries a partition record (a
  vertex-cut query of either package), and the modeled per-round cost
  and the pipeline table (JAX traces only: the port has no pack ledger
  or pipeline yet);
* the async serve pump's table (serve_dispatch / serve_harvest spans):
  per-batch dispatch and harvest lag, window occupancy, the hidden
  harvest share, and a PUMP DRIFT flag when a W > 1 window hides < 10%;
* the per-query serve table (serve_query spans) with its queue-wait
  column and per-tenant and per-replica (fleet_replica) rollups;
* a drift flag on a round more than DRIFT_X (2x) off the median wall;
* a phase rollup (obs.rollup) of every span name.

`--gang` first merges the per-rank sidecars of a multi-process run
(`<trace base>.gang/rank_<r>.json`, obs/gang.py) into one timeline on
rank 0's clock, prints who contributed, the alignment and the flows
crossing the rank tracks, then renders the merged trace; it exits 1 when
the merge is incomplete (a rank missing, unaligned or without spans).

Usage: python -m libgrape_lite_tpu_torch.scripts.trace_report TRACE
       [--drift-x 2.0] [--gang [--out MERGED]]
"""

from __future__ import annotations

import argparse
import os
import sys

from libgrape_lite_tpu_torch.obs.events import FRAG_TID_BASE
from libgrape_lite_tpu_torch.obs.export import load_trace, rollup

DRIFT_X = 2.0


def _fmt_ms(us):
    return f"{us / 1000.0:10.3f}" if us is not None else f"{'-':>10}"


def superstep_rows(events):
    """One row per host-track peval/superstep span, in timestamp
    order.  Rounds deliberately may REPEAT: a guard rollback-replay
    re-executes rounds and a file can hold several queries (bench
    warm + measured) — every execution is a real measurement, so rows
    are never keyed/overwritten by round number."""
    rows = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") not in (
            "peval", "superstep"
        ):
            continue
        if ev.get("tid", 0) >= FRAG_TID_BASE:
            continue  # per-fragment mirrors restate the host interval
        args = ev.get("args") or {}
        rnd = args.get("round")
        if rnd is None:
            rnd = 0 if ev["name"] == "peval" else None
        if rnd is None:
            continue
        rows.append({
            "round": int(rnd),
            "name": ev["name"],
            "ts": float(ev["ts"]),
            "wall_us": float(ev.get("dur", 0)),
            "dispatch_us": args.get("dispatched_us"),
            "device_us": args.get("device_wait_us"),
            "active": args.get("active"),
            "verdicts": [],
        })
    return sorted(rows, key=lambda r: r["ts"])


def attach_verdicts(rows, events):
    """Guard instants land on the row whose [ts, ts+dur) contains (or
    last precedes) them — a probe fires after its round's sync."""
    for ev in events:
        if ev.get("ph") != "i" or ev.get("name") not in (
            "guard_breach", "resume"
        ):
            continue
        ts = float(ev.get("ts", 0))
        owner = None
        for r in rows:
            if r["ts"] <= ts:
                owner = r
            else:
                break
        if owner is not None:
            args = ev.get("args") or {}
            tag = args.get("kind", ev["name"])
            owner["verdicts"].append(str(tag))


def query_ledger(events):
    """The pack_ledger args of the last query span (modeled per-round
    cost), or None."""
    led = None
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "query":
            args = ev.get("args") or {}
            if "pack_ledger" in args:
                led = args["pack_ledger"]
    return led


def query_partition(events):
    """The 2-D vertex-cut tile record of the last query span that
    carried one (a 2-D vertex-cut query), or None."""
    pt = None
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "query":
            args = ev.get("args") or {}
            if "partition" in args:
                pt = args["partition"]
    return pt


def query_pipeline(events):
    """The superstep-pipeline brief of the last query span that
    carried one (a JAX trace of a pipelined query, with
    `overlap_hidden_us`), or None."""
    pl = None
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "query":
            args = ev.get("args") or {}
            if "pipeline" in args:
                pl = dict(args["pipeline"])
                if "overlap_hidden_us" in args:
                    pl["overlap_hidden_us"] = args["overlap_hidden_us"]
    return pl


def serve_pump_rows(events):
    """(dispatch, harvest) span pairs of the async serve pump, in
    dispatch order: one row per batch with its dispatch/harvest lag
    and the window occupancy at harvest (serve/pipeline.py tags every
    span with window/inflight/overlapped)."""
    disp = sorted(
        (ev for ev in events
         if ev.get("ph") == "X" and ev.get("name") == "serve_dispatch"),
        key=lambda e: float(e.get("ts", 0)),
    )
    harv = sorted(
        (ev for ev in events
         if ev.get("ph") == "X" and ev.get("name") == "serve_harvest"),
        key=lambda e: float(e.get("ts", 0)),
    )
    rows = []
    # FIFO harvest: the i-th harvest drains the i-th dispatch
    for i, h in enumerate(harv):
        d = disp[i] if i < len(disp) else None
        da = (d.get("args") or {}) if d else {}
        ha = h.get("args") or {}
        rows.append({
            "app": ha.get("app", da.get("app", "?")),
            "batch": ha.get("batch", da.get("batch", 0)),
            "mode": ha.get("mode", "?"),
            "dispatch_us": float(d.get("dur", 0)) if d else None,
            "harvest_us": float(h.get("dur", 0)),
            "occupancy": ha.get("inflight", 0),
            "overlapped": bool(ha.get("overlapped", False)),
            "window": ha.get("window", da.get("window", 1)),
        })
    return rows


def serve_query_rows(events):
    """One row per serve_query lane span, in (timestamp, lane) order:
    the per-query view of a serve trace, carrying the queue-wait the
    session stamped at emit time (submit->pop admission wait µs)."""
    rows = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != "serve_query":
            continue
        a = ev.get("args") or {}
        rows.append({
            "ts": float(ev.get("ts", 0)),
            "wall_us": float(ev.get("dur", 0)),
            "query_id": a.get("query_id", "?"),
            "app": a.get("app", "?"),
            "tenant": a.get("tenant", "") or "-",
            "lane": a.get("lane", 0),
            "rounds": a.get("rounds", 0),
            "ok": a.get("ok", True),
            "queue_wait_us": a.get("queue_wait_us"),
        })
    return sorted(rows, key=lambda r: (r["ts"], r["lane"]))


def fleet_replica_rows(events):
    """fleet_replica spans (fleet/router.py): one per replica pump
    pass that delivered results, on the replica's own trace row."""
    rows = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != "fleet_replica":
            continue
        a = ev.get("args") or {}
        rows.append({
            "replica": a.get("replica", "?"),
            "results": a.get("results", 0),
            "wall_us": float(ev.get("dur", 0)),
        })
    return rows


_QUERY_ROWS_CAP = 64


def render_serve_queries(rows, replica_rows, out=sys.stdout):
    """Per-query serve table with the queue-wait column, then the
    per-tenant and per-replica rollup rows.  Percentiles follow
    serve/queue.py latency_summary_ms (p50 = v[n//2])."""
    if not rows and not replica_rows:
        return

    def _p50(v):
        return v[len(v) // 2]

    def _p99(v):
        return v[min(len(v) - 1, int(len(v) * 0.99))]

    if rows:
        print("\nserve queries (serve_query lane spans; qwait = "
              "submit->pop admission wait):", file=out)
        print(f"{'qid':>6} {'app':>10} {'tenant':>8} {'lane':>5} "
              f"{'rounds':>6} {'ok':>3} {'qwait_ms':>10} "
              f"{'wall_ms':>10}", file=out)
        for r in rows[:_QUERY_ROWS_CAP]:
            print(
                f"{str(r['query_id']):>6} {r['app']:>10} "
                f"{r['tenant']:>8} {r['lane']:>5} {r['rounds']:>6} "
                f"{'y' if r['ok'] else 'n':>3} "
                f"{_fmt_ms(r['queue_wait_us'])} {_fmt_ms(r['wall_us'])}",
                file=out,
            )
        if len(rows) > _QUERY_ROWS_CAP:
            print(f"  ... {len(rows) - _QUERY_ROWS_CAP} more query "
                  "row(s) elided (rollups below cover all of them)",
                  file=out)
        by_tenant: dict = {}
        for r in rows:
            by_tenant.setdefault(r["tenant"], []).append(r)
        print("  per-tenant rollup:", file=out)
        for t, rs in sorted(by_tenant.items()):
            qw = sorted(float(x["queue_wait_us"] or 0) for x in rs)
            wl = sorted(x["wall_us"] for x in rs)
            print(
                f"    tenant={t:<10} n={len(rs):<4} "
                f"ok={sum(bool(x['ok']) for x in rs):<4} "
                f"qwait p50={_p50(qw) / 1e3:.3f} "
                f"p99={_p99(qw) / 1e3:.3f} "
                f"wall p50={_p50(wl) / 1e3:.3f} "
                f"p99={_p99(wl) / 1e3:.3f} ms", file=out,
            )
    if replica_rows:
        by_rep: dict = {}
        for r in replica_rows:
            by_rep.setdefault(r["replica"], []).append(r)
        print("  per-replica rollup (fleet_replica spans):", file=out)
        for idx, rs in sorted(by_rep.items(), key=lambda kv: str(kv[0])):
            print(
                f"    replica={idx!s:<3} pumps={len(rs):<4} "
                f"results={sum(x['results'] for x in rs):<5} "
                f"pump wall={sum(x['wall_us'] for x in rs) / 1e3:.3f} ms",
                file=out,
            )


def render_serve_pump(rows, out=sys.stdout) -> int:
    """The async-pump section: per-batch dispatch/harvest lag + window
    occupancy, the hidden-harvest fraction, and the PUMP DRIFT flag
    (W>1 armed but <10% of the harvest wall overlapped with in-flight
    work).  Returns 1 when flagged, else 0."""
    if not rows:
        return 0
    print("\nasync serve pump (serve_dispatch/serve_harvest spans, "
          "serve/pipeline.py):", file=out)
    print(f"{'batch':>5} {'app':>10} {'lanes':>6} {'mode':>9} "
          f"{'disp_ms':>10} {'harv_ms':>10} {'occ':>4}  ovl", file=out)
    total = hidden = 0.0
    for i, r in enumerate(rows):
        total += r["harvest_us"]
        if r["overlapped"]:
            hidden += r["harvest_us"]
        print(
            f"{i:>5} {r['app']:>10} {r['batch']:>6} {r['mode']:>9} "
            f"{_fmt_ms(r['dispatch_us'])} {_fmt_ms(r['harvest_us'])} "
            f"{r['occupancy']:>4}  {'y' if r['overlapped'] else '-'}",
            file=out,
        )
    armed = any(r["window"] > 1 for r in rows)
    frac = hidden / total if total > 0 else 0.0
    occ = [r["occupancy"] for r in rows]
    print(
        f"  window={'/'.join(str(w) for w in sorted({r['window'] for r in rows}))} "
        f"occupancy mean={sum(occ) / len(occ):.2f} max={max(occ)} "
        f"hidden harvest wall {frac:.1%}",
        file=out,
    )
    if armed and frac < 0.10:
        print(
            "  PUMP DRIFT: a W>1 window is armed but <10% of the "
            f"harvest wall overlapped in-flight work ({frac:.1%}) — "
            "the stream never kept the window full (batch cadence too "
            "coarse, declines forcing the sync path, or ingest "
            "barriers quiescing every step; see PUMP_STATS and "
            "docs/SERVING.md)",
            file=out,
        )
        return 1
    return 0


def drift_flags(rows, drift_x: float):
    """Flag rounds whose wall-per-modeled-unit ratio is > drift_x off
    the median.  Modeled cost is constant per round (static ledger),
    so the ratio reduces to wall time vs the median round — but the
    division is kept explicit so a future per-round model (active-
    scaled ops) slots in without changing the report."""
    walls = sorted(r["wall_us"] for r in rows if r["wall_us"] > 0)
    if not walls:
        return
    median = walls[len(walls) // 2]
    if median <= 0:
        return
    for r in rows:
        ratio = r["wall_us"] / median
        r["drift"] = ratio
        r["flag"] = ratio > drift_x or ratio < 1.0 / drift_x


def render(events, drift_x: float = DRIFT_X, out=None):
    # resolved at call time: a default bound at import would pin
    # whatever stdout happened to be when the module first loaded
    out = out if out is not None else sys.stdout

    rows = superstep_rows(events)
    attach_verdicts(rows, events)
    led = query_ledger(events)
    pipe = query_pipeline(events)
    hidden_us = (pipe or {}).get("hidden_us_per_round")
    print("superstep table (wall/device from synced spans; "
          "docs/OBSERVABILITY.md):", file=out)
    hdr = (f"{'round':>5} {'phase':>9} {'wall_ms':>10} {'disp_ms':>10} "
           f"{'dev_ms':>10} {'ovl_ms':>10} {'active':>9} "
           f"{'x_med':>6}  guard")
    print(hdr, file=out)
    drift_flags(rows, drift_x)
    flagged = 0
    pipe_flagged = 0
    for r in rows:
        flag = "  DRIFT" if r.get("flag") else ""
        flagged += bool(r.get("flag"))
        verd = ",".join(r["verdicts"]) or "-"
        act = r["active"] if r["active"] is not None else "-"
        # overlap column: modeled hidden-exchange µs per superstep
        # when the pipeline is armed (constant per round — the static
        # split; PEval is pre-pipeline, so round 0 shows '-')
        ovl = (hidden_us if hidden_us is not None
               and r["name"] == "superstep" else None)
        print(
            f"{r['round']:>5} {r['name']:>9} {_fmt_ms(r['wall_us'])} "
            f"{_fmt_ms(r['dispatch_us'])} {_fmt_ms(r['device_us'])} "
            f"{_fmt_ms(ovl)} "
            f"{act:>9} {r.get('drift', 0):>6.2f}  {verd}{flag}",
            file=out,
        )
    if not rows:
        print("  (no peval/superstep spans — fused query? the fused "
              "path is one dispatch; use --profile / stepwise for "
              "per-round rows)", file=out)
    if led:
        e = max(1, led.get("edges", 1))
        print(
            "\nmodeled per-round budget (pack ledger on the query "
            f"span): {led.get('vpu_ops', 0) / e:.1f} VPU ops/edge, "
            f"{led.get('mxu_ops', 0) / e:.1f} MXU elems/edge, "
            f"{led.get('hbm_bytes', 0) / e:.1f} B/edge over "
            f"{e} edges",
            file=out,
        )
    if pipe:
        print(
            "\npipeline split (query span, parallel/pipeline.py): "
            f"{pipe.get('boundary_vertices', 0)} boundary / "
            f"{pipe.get('interior_vertices', 0)} interior vertices "
            f"({pipe.get('boundary_edges', 0)} / "
            f"{pipe.get('interior_edges', 0)} edges), "
            f"{pipe.get('mode', '?')} exchange "
            f"{pipe.get('exchange_bytes', 0)} B/round, modeled hidden "
            f"frac {pipe.get('modeled_hidden_frac', 0.0):.2%}"
            + (f", {pipe['overlap_hidden_us']:.1f} µs hidden over the "
               "query" if "overlap_hidden_us" in pipe else ""),
            file=out,
        )
        if pipe.get("modeled_hidden_frac", 0.0) < 0.10:
            pipe_flagged = 1
            print(
                "  PIPELINE DRIFT: pipelining is armed but hides "
                f"<10% of the exchange "
                f"({pipe.get('modeled_hidden_frac', 0.0):.2%}) — the "
                "interior slice is too small to cover the collective "
                "(hub-heavy cut? see docs/PIPELINE.md: the split "
                "costs a dispatch and buys almost nothing here)",
                file=out,
            )
    part = query_partition(events)
    if part:
        # 2-D vertex-cut tile table (docs/PARTITION2D.md): one
        # row per tile with its share of the max-tile skew — the
        # per-tile analogue of the partition-skew warning, read from
        # the SAME record the worker attached to the query span
        k = part.get("k", 0)
        mx = max(1, part.get("max_tile_edges", 1))
        print(
            f"\npartition2d tiles (k={k}, "
            f"max {part.get('max_tile_edges', 0)} / mean "
            f"{part.get('mean_tile_edges', 0)} edges, skew "
            f"{part.get('tile_skew', 0.0):.3f}x):",
            file=out,
        )
        print(f"{'tile':>10} {'edges':>10} {'x_max':>7}", file=out)
        for t in part.get("per_tile", []):
            label = f"({t.get('row', '?')},{t.get('col', '?')})"
            print(
                f"{label:>10} {t.get('edges', 0):>10} "
                f"{t.get('edges', 0) / mx:>7.2f}",
                file=out,
            )
    pump_flagged = render_serve_pump(serve_pump_rows(events), out)
    render_serve_queries(
        serve_query_rows(events), fleet_replica_rows(events), out
    )
    if flagged:
        print(
            f"\n{flagged} superstep(s) drifted >{drift_x}x from the "
            "median wall-per-modeled-unit ratio — same modeled work, "
            "different measured time (contention, recompile, or a "
            "frontier the static model does not see)", file=out,
        )
    print("\nphase rollup:", file=out)
    for name, r in sorted(rollup(events).items(),
                          key=lambda kv: -kv[1]["total_s"]):
        print(
            f"  {name:<20} n={r['count']:<4} total={r['total_s']:.4f}s "
            f"mean={r['mean_s']:.4f}s max={r['max_s']:.4f}s", file=out,
        )
    # superstep x_med drift, the pipeline <10%-hidden flag, and the
    # serve-pump <10%-hidden flag are counted separately (the summary
    # above names only the first); callers get the total so any kind
    # reads as "worth a look"
    return flagged + pipe_flagged + pump_flagged


def render_gang_summary(summary, out=None):
    """The header of a --gang report: who contributed, how the clocks were
    aligned, and whether the merge is complete (every rank present,
    aligned and with spans)."""
    out = out if out is not None else sys.stdout
    print("gang trace federation (obs/gang.py):", file=out)
    print(f"  ranks {summary['ranks']} of nprocs={summary['nprocs']}"
          + (f", MISSING {summary['missing']}" if summary["missing"]
             else ""), file=out)
    for r in sorted(summary["spans_by_rank"]):
        print(f"  rank {r}: {summary['spans_by_rank'][r]} span(s), "
              f"{summary['supersteps_by_rank'].get(r, 0)} superstep(s)",
              file=out)
    print(f"  flows: {summary['flow_ids']} id(s), "
          f"{summary['flow_events']} leg event(s), "
          f"{summary['cross_rank_flows']} crossing rank tracks", file=out)
    print(f"  aligned={summary['aligned']} monotonic={summary['monotonic']} "
          f"complete={summary['complete']}"
          + (f"\n  merged trace -> {summary['out']}" if summary["out"]
             else ""), file=out)


def _gang_dir_of(trace: str) -> str:
    """The sidecar directory a --gang TRACE names: the directory itself,
    or the `<base>.gang` twin of a trace path."""
    if os.path.isdir(trace):
        return trace
    for twin in (trace + ".gang", os.path.splitext(trace)[0] + ".gang"):
        if os.path.isdir(twin):
            return twin
    raise FileNotFoundError(
        f"--gang: no sidecar directory at {trace!r} (or its .gang twin); "
        "expected the directory a gang's GRAPE_TRACE wrote rank_<r>.json "
        "files into")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace JSON or JSONL path (with "
                                  "--gang: the sidecar directory or the "
                                  "trace path of a gang)")
    ap.add_argument("--drift-x", type=float, default=DRIFT_X,
                    help="ratio-vs-median threshold to flag (default 2)")
    ap.add_argument("--gang", action="store_true",
                    help="merge every rank sidecar into one timeline "
                         "first, then render it")
    ap.add_argument("--out", default="",
                    help="with --gang: where the merged Chrome trace goes "
                         "(default <dir>/merged.json)")
    ns = ap.parse_args(argv)
    if ns.gang:
        from libgrape_lite_tpu_torch.obs import gang

        dirpath = _gang_dir_of(ns.trace)
        out_path = ns.out or os.path.join(dirpath, "merged.json")
        summary = gang.assemble(dirpath, out_path=out_path)
        render_gang_summary(summary)
        if summary["events"]:
            print()
            render(load_trace(out_path), ns.drift_x)
        # an incomplete merge is the federation's drift flag
        return 0 if summary["complete"] else 1
    render(load_trace(ns.trace), ns.drift_x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
