"""Command-line entry point (counterpart of `libgrape_lite_tpu/cli.py`,
reference `run_app` flags):

    python -m libgrape_lite_tpu_torch.cli --application sssp \\
        --efile dataset/p2p-31.e --vfile dataset/p2p-31.v \\
        --sssp_source 6 --out_prefix out/ [--fnum 4] [--device cpu]

Applications, with their query flags:
  pagerank, pagerank_auto, pagerank_parallel, pagerank_opt, pagerank_push,
    pagerank_push_opt, pagerank_directed (--pr_d, --pr_mr);
  sssp, sssp_select, sssp_auto, sssp_opt, sssp_delta, sssp_msg
    (--sssp_source);
  bfs, bfs_auto, bfs_opt, bfs_msg (--bfs_source);
  wcc, wcc_auto, wcc_opt;
  cdlp, cdlp_auto, cdlp_opt, cdlp_opt_ud, cdlp_opt_ud_dense (--cdlp_mr);
  lcc, lcc_auto, lcc_beta, lcc_opt, lcc_bitmap, lcc_directed,
    triangle_count (--degree_threshold);
  bc (--bc_source), staged_bc, staged_bc_bfs;
  kcore (--kcore_k), core_decomposition;
  pagerank_local, pagerank_local_parallel (--pr_d, --pr_mr);
  khop (--khop_k, --bfs_source), common_neighbors (--cn_source);
  kclique (--kclique_k);
  pagerank_vc, pagerank_vc_rep, sssp_vc, bfs_vc, wcc_vc (the 2-D vertex
    cut: fnum must be k^2; the same query flags as their 1-D names).
--directed loads the graph directed.  `--vc` runs vertex-cut storage
(with it `pagerank` names pagerank_vc, reference run_app_vc.h:82-89);
GRAPE_PARTITION=2d|auto swaps sssp, bfs, wcc and pagerank for their 2-D
twins when the planner engages (fragment/partition.py), every decline
recorded with its reason.

Loading: --partitioner_type hash|map|segment, --idxer_type
hashmap|sorted_array|pthash|local, --string_id (vertex ids as strings),
--rebalance [--rebalance_vertex_factor N] (degree-weighted fragments),
--serialize / --deserialize with --serialization_prefix (the garc
fragment cache, readable by the JAX package too), --memory_stats,
--delta_efile / --delta_vfile (edit files in the reference's `a`/`d`/`u`
grammar, applied to the parsed graph before the build:
LoadGraphAndMutate).
GRAPE_LCC_BACKEND=intersect|spgemm|auto picks the triangle-credit
backend of lcc_opt / lcc_bitmap / triangle_count.

`--device` defaults to `cuda` and the run fails when CUDA is absent.

Observability (obs/): `--trace t.json` writes a Chrome trace (Perfetto
loads it; `libgrape_lite_tpu_torch/scripts/trace_report.py` prints its
per-superstep table) with a JSONL twin `t.jsonl`, `--metrics m` writes
`m.json` and `m.prom`, and `--profile` logs each round's seconds and
active count; GRAPE_TRACE and GRAPE_METRICS arm the same sinks.

Several processes (the multi-process runtime): `--coordinator host:port
--num_processes N --process_id i`, one command a process, start a
torch.distributed group (gloo on `--device cpu`; NCCL on CUDA, one card
a local rank; GRAPE_DIST_BACKEND=gloo lets ranks share a card, each
collective staged through host memory; GRAPE_DIST_TIMEOUT_S bounds the
rendezvous and every collective).  fnum must be a multiple of N; each
rank holds fnum / N fragments and only process 0 writes --out_prefix.
Across processes sssp, bfs, wcc and pagerank run; other apps,
checkpoints, guards, fault injection, delta files, --vc and
GRAPE_PIPELINE=force raise before the load.

Fault tolerance (ft/, guard/): `--checkpoint_every K --checkpoint_dir D`
snapshots the query's carry every K supersteps, `--resume
--checkpoint_dir D` continues the newest usable snapshot (the lineage's
format is the JAX package's), `--guard warn|halt|rollback` probes the
app's invariants each round (rollback heals from the last snapshot; a
halt exits 1).  GRAPE_FT_FAULTS injects faults (kill@K, corrupt@K,
corrupt_carry@K, capacity=N, mode=raise; a kill exits 17),
GRAPE_GUARD / GRAPE_GUARD_EVERY / GRAPE_GUARD_STAGNATION arm the guard,
GRAPE_RETRY_SEED seeds the cache-read retry's jitter.

The `serve` subcommand loads the graph once and serves a stream of
point queries through a ServeSession (serve/), batching compatible
ones, and prints one JSON summary line (the JAX CLI's keys):

    python -m libgrape_lite_tpu_torch.cli serve --efile dataset/p2p-31.e \
        --vfile dataset/p2p-31.v --application sssp --num_queries 16 \
        --max_batch 8 [--inflight 4] [--dump_results out.txt] \
        [--delta_stream ops.txt --ingest_every 8] [--device cpu]

The fleet paths (fleet/, autopilot/): `--replicas R [--drain_at K]`
serves from R replica sessions behind a version-fenced router (replica 0
drained before query K), `--tenants by_app|N` puts N tenants under one
device budget, and `--autopilot [--min_replicas N --max_replicas M
--cache_entries C]` lets an autoscaler move the replica count with a
shared result cache in front; `--slo 'sssp=5,*=100'` sets latency
objectives.  On a one-app stream `--dump_results` of a fleet run equals
the plain run's (on a mixed stream the plain loop ingests by dispatch
count, `run_fleet_script` by submit count).  `--trace` / `--metrics` arm
obs/ for the run (per-query `serve_query` rows, the pump's and the
router's spans); `--metrics_port P` (or GRAPE_METRICS_PORT) serves a live
OpenMetrics endpoint on 127.0.0.1 for the run's duration, 0 an ephemeral
port (its URL goes to stderr).

The `postmortem` subcommand renders a flight-recorder bundle (obs/
recorder.py writes one per trigger into GRAPE_POSTMORTEM's directory);
with `--trace` it checks that every `serve_query` row of the bundle is
byte for byte the trace's row of that query:

    python -m libgrape_lite_tpu_torch.cli postmortem bundle.json \
        [--trace t.json] [--json]

The `calibrate` subcommand (ops/calibration.py) times the port's kernels
on the card, fits the rate profile every priced decision reads, writes
it (install it with GRAPE_RATE_PROFILE=<path>) and gates modelled
against measured seconds; exit 0 when the fit or the gate holds, 2 when
the fit is infeasible, the drift passes 5% or a file is unreadable:

    python -m libgrape_lite_tpu_torch.cli calibrate --out rates.json \
        --samples-out samples.json [--scales 16,18 --ef 4,16] [--json]
    python -m libgrape_lite_tpu_torch.cli calibrate --check \
        --samples samples.json --profile rates.json

The `lint` subcommand runs grape-lint (analysis/) over this package's
tree: the AST rules R4, R5, R7, R8, R9, R10 and R12, and with
`--artifact` the A3 audit (the warm query matrix on `--device`, zero
rebuilds).  Exit 0 clean, 1 on an unsuppressed or stale finding, 2 on a
missing path or an empty `--update-baseline` reason, 3 when the `--json`
record fails its schema:

    python -m libgrape_lite_tpu_torch.cli lint [paths ...] [--json] \
        [--artifact --device cpu] [--baseline b.json] \
        [--update-baseline REASON]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.runner import QueryArgs, run_app


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="libgrape_lite_tpu_torch",
        description="libgrape-lite analytical apps on PyTorch/CUDA",
    )
    p.add_argument("--application", required=True,
                   help="app name: " + ", ".join(sorted(APP_REGISTRY)))
    p.add_argument("--efile", required=True)
    p.add_argument("--vfile", default="")
    p.add_argument("--out_prefix", default="")
    p.add_argument("--directed", action="store_true")
    p.add_argument("--sssp_source", default="0")
    p.add_argument("--bfs_source", default="0")
    p.add_argument("--bc_source", default="0")
    p.add_argument("--kcore_k", type=int, default=0)
    p.add_argument("--kclique_k", type=int, default=3)
    p.add_argument("--khop_k", type=int, default=2,
                   help="k-hop neighbourhood hop bound (the source comes "
                        "from --bfs_source)")
    p.add_argument("--cn_source", default="0",
                   help="common_neighbors 2-hop query source vertex")
    p.add_argument("--pr_d", type=float, default=0.85)
    p.add_argument("--pr_mr", type=int, default=10)
    p.add_argument("--cdlp_mr", type=int, default=10)
    p.add_argument("--degree_threshold", type=int, default=0,
                   help="LCC hub cap: skip neighbour lists of vertices "
                        "above this degree (0 disables)")
    p.add_argument("--fnum", type=int, default=None,
                   help="fragment count, stacked on the device (each "
                        "process's share of them across processes)")
    p.add_argument("--partitioner_type", default="map",
                   choices=["hash", "map", "segment"])
    p.add_argument("--idxer_type", default="hashmap",
                   choices=["hashmap", "sorted_array", "pthash", "local"])
    p.add_argument("--serialize", action="store_true")
    p.add_argument("--deserialize", action="store_true")
    p.add_argument("--serialization_prefix", default="")
    p.add_argument("--vc", action="store_true",
                   help="vertex-cut (2-D) storage; fnum must be k^2")
    p.add_argument("--delta_efile", default="")
    p.add_argument("--delta_vfile", default="")
    p.add_argument("--string_id", action="store_true",
                   help="treat vertex ids as strings")
    p.add_argument("--rebalance", action="store_true")
    p.add_argument("--rebalance_vertex_factor", type=int, default=0)
    p.add_argument("--memory_stats", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--profile", action="store_true",
                   help="log each round's seconds and active count")
    p.add_argument("--trace", default="",
                   help="arm obs/ tracing: a Chrome trace_event JSON "
                        "(Perfetto loads it) at this path and a JSONL twin "
                        "beside it; the same as GRAPE_TRACE=path")
    p.add_argument("--metrics", default="",
                   help="write the obs/ metrics snapshot to <path>.json and "
                        "<path>.prom at query end; the same as "
                        "GRAPE_METRICS=path")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="snapshot the query carry every K supersteps "
                        "(ft/checkpoint.py; 0 = off; requires "
                        "--checkpoint_dir)")
    p.add_argument("--checkpoint_dir", default="",
                   help="directory for superstep checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the last complete checkpoint in "
                        "--checkpoint_dir (query args replay from the "
                        "checkpoint metadata; the config fingerprint "
                        "must match)")
    p.add_argument("--guard", default="",
                   choices=["", "off", "warn", "halt", "rollback"],
                   help="runtime invariant guard policy (guard/): warn "
                        "logs breaches, halt raises with a diagnostic "
                        "bundle, rollback self-heals from the last "
                        "checkpoint (needs --checkpoint_every); default "
                        "reads GRAPE_GUARD")
    p.add_argument("--coordinator", default="",
                   help="torch.distributed rendezvous address (host:port, "
                        "served by process 0); arms the multi-process "
                        "runtime with --num_processes/--process_id")
    p.add_argument("--num_processes", type=int, default=0,
                   help="total process count (0 = single-process); fnum "
                        "must be a multiple of it")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's rank in [0, num_processes)")
    return p


def make_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="libgrape_lite_tpu_torch serve")
    p.add_argument("--efile", required=True)
    p.add_argument("--vfile", default="")
    p.add_argument("--directed", action="store_true")
    p.add_argument("--application", default="sssp",
                   help="app of --sources / --num_queries streams "
                        "(--stream lines name their own)")
    p.add_argument("--sources", default="",
                   help="comma-separated source ids, one query each")
    p.add_argument("--num_queries", type=int, default=0,
                   help="N queries from sources 0..N-1 (when --sources "
                        "and --stream are not given)")
    p.add_argument("--stream", default="",
                   help="scripted stream file: one 'app source' line a "
                        "query")
    p.add_argument("--max_batch", type=int, default=8,
                   help="lanes per batched query (serve/policy.py)")
    p.add_argument("--max_wait_ms", type=float, default=0.0,
                   help="queue-head wait before a partial batch ships")
    p.add_argument("--inflight", type=int, default=1,
                   help="window of the async pump (serve/pipeline.py): "
                        "> 1 keeps up to W batches admitted at once, each "
                        "launched one running in its own thread and CUDA "
                        "stream, harvested FIFO, an ingest a barrier; 1 "
                        "keeps the synchronous loop")
    p.add_argument("--dump_results", default="",
                   help="one line per query in submit order: index, app, "
                        "ok, rounds, sha256 of the assembled values")
    p.add_argument("--max_rounds", type=int, default=0)
    p.add_argument("--arrival_rate", default="",
                   help="submit from a feeder thread at this rate "
                        "(serve/feeder.py): queries a second, or a step "
                        "schedule like '50:2x@100'; empty or 0 keeps the "
                        "scripted mode")
    p.add_argument("--delta_stream", default="",
                   help="dyn/ live ingest: a delta-op file ('a src dst "
                        "[w]' / 'd src dst' / 'u src dst w' lines), "
                        "ingested in chunks between query batches")
    p.add_argument("--ingest_every", type=int, default=8,
                   help="queries dispatched between delta-chunk ingests")
    p.add_argument("--dyn_repack_ratio", type=float, default=None,
                   help="delta ratio past which staged ops fold into a "
                        "rebuilt CSR (default GRAPE_DYN_REPACK_RATIO)")
    p.add_argument("--fnum", type=int, default=None)
    p.add_argument("--string_id", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--guard", default="",
                   choices=["", "off", "warn", "halt", "rollback"],
                   help="per-lane guard policy (breach isolation: a "
                        "poisoned lane fails alone; rollback degrades to "
                        "per-lane halt in a batch); default reads "
                        "GRAPE_GUARD")
    p.add_argument("--replicas", type=int, default=1,
                   help="fleet/: serve from R replica sessions behind a "
                        "least-outstanding router with a graph-version "
                        "fence; 1 keeps the single-session path")
    p.add_argument("--drain_at", type=int, default=-1,
                   help="fleet/: begin draining replica 0 before query K "
                        "(it rejoins after the next ingest, or at the "
                        "end); needs --replicas >= 2")
    p.add_argument("--tenants", default="",
                   help="fleet/: 'by_app' gives each app a tenant, N "
                        "round-robins the queries over N tenants; tenants "
                        "share the device budget (GRAPE_FLEET_HBM_BYTES) "
                        "under weighted round-robin and never share a "
                        "batch")
    p.add_argument("--autopilot", action="store_true",
                   help="autopilot/: an autoscaler moves the replica "
                        "count between --min_replicas and --max_replicas "
                        "(drain, rejoin, replicate), with a shared "
                        "fence-epoch result cache (--cache_entries)")
    p.add_argument("--min_replicas", type=int, default=1,
                   help="autopilot: replica floor (and the initial count)")
    p.add_argument("--max_replicas", type=int, default=4,
                   help="autopilot: replica ceiling")
    p.add_argument("--cache_entries", type=int, default=1024,
                   help="autopilot: result-cache entries (0: no cache)")
    p.add_argument("--slo", default="",
                   help="obs/slo.py latency objectives in ms, e.g. "
                        "'sssp=5,tenant:t0=50,*=100'; a breach counts "
                        "against the key's error budget, never raises "
                        "(also GRAPE_SLO; budget: GRAPE_SLO_BUDGET)")
    p.add_argument("--trace", default="",
                   help="obs/ Chrome-trace path (per-query lane rows)")
    p.add_argument("--metrics", default="",
                   help="obs/ metrics snapshot: <path>.json and <path>.prom")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="obs/exporter.py: a live OpenMetrics endpoint on "
                        "127.0.0.1 for the run's duration (/metrics, "
                        "/federation, /healthz); 0 binds an ephemeral port "
                        "(the URL goes to stderr); the same as "
                        "GRAPE_METRICS_PORT")
    return p


def _serve_queries(ns) -> list:
    """The scripted stream: (app, source) a query."""
    from libgrape_lite_tpu_torch.runner import _coerce_source

    if ns.stream:
        queries = []
        with open(ns.stream) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                app_key, src = line.split()
                queries.append((app_key, _coerce_source(src, ns.string_id)))
        return queries
    if ns.sources:
        return [(ns.application, _coerce_source(s, ns.string_id))
                for s in ns.sources.split(",")]
    return [(ns.application, s) for s in range(max(1, ns.num_queries))]


def serve_main(argv=None) -> int:
    """The `serve` subcommand: a resident session over a scripted stream
    (JAX `cli.py::serve_main`, its single-session path)."""
    import numpy as np

    from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.obs import exporter

    parser = make_serve_parser()
    ns = parser.parse_args(argv)
    if ns.slo:
        from libgrape_lite_tpu_torch.obs import slo

        try:
            slo.configure(ns.slo)
        except ValueError as e:
            parser.error(f"--slo: {e}")
    if ns.trace or ns.metrics:
        obs.configure(trace_path=ns.trace or None,
                      metrics_path=ns.metrics or None)
    exp = (exporter.start_exporter(ns.metrics_port)
           if ns.metrics_port is not None
           else exporter.maybe_start_from_env())
    if exp is not None:
        print(f"[serve] metrics exporter: {exp.url}", file=sys.stderr)
    queries = _serve_queries(ns)
    if not queries:
        # fail before the graph load, not on an empty percentile after
        sys.exit("serve: the query stream is empty")
    for app_key, _ in queries:
        if app_key not in APP_REGISTRY:
            raise ValueError(f"unknown application {app_key!r}")
    weighted = any(getattr(APP_REGISTRY[a], "needs_edata", False)
                   for a, _ in queries)
    delta_ops = []
    if ns.delta_stream:
        from libgrape_lite_tpu_torch.dyn import parse_ops_file

        # the graph's weightedness: a weighted serve must not ingest
        # zero-cost edges from an unweighted stream
        delta_ops = parse_ops_file(ns.delta_stream, weighted=weighted,
                                   string_id=ns.string_id)
    if ns.arrival_rate:
        try:
            if float(ns.arrival_rate) == 0.0:
                ns.arrival_rate = ""
        except ValueError:
            pass
    if ns.arrival_rate:
        from libgrape_lite_tpu_torch.serve.feeder import parse_rate_spec

        try:
            parse_rate_spec(ns.arrival_rate)
        except ValueError as e:
            sys.exit(f"serve: {e}")
    fleet_mode = ns.replicas > 1 or bool(ns.tenants)
    if ns.drain_at >= 0 and ns.replicas < 2:
        sys.exit("serve: --drain_at needs --replicas >= 2 (draining the "
                 "only replica would drop traffic)")
    if ns.autopilot:
        # the autopilot owns the replica count: the static fleet knobs
        # do not compose with it
        for flag, bad in (("--tenants", bool(ns.tenants)),
                          ("--drain_at", ns.drain_at >= 0),
                          ("--delta_stream", bool(ns.delta_stream))):
            if bad:
                sys.exit(f"serve: --autopilot does not compose with "
                         f"{flag} yet")
        if ns.min_replicas < 1:
            sys.exit("serve: --min_replicas must be >= 1")
        if ns.max_replicas < ns.min_replicas:
            sys.exit("serve: --max_replicas must be >= --min_replicas")
    elif fleet_mode and ns.arrival_rate:
        sys.exit("serve: --arrival_rate does not compose with "
                 "--replicas/--tenants yet")
    if ns.arrival_rate and delta_ops:
        # the ingest cadence is pinned by dispatch count, which a
        # wall-clock feeder cannot reproduce
        sys.exit("serve: --arrival_rate does not compose with "
                 "--delta_stream")
    # replicas (and autopilot scale-ups) rebuild from the edge list
    spec = LoadGraphSpec(directed=ns.directed, weighted=weighted,
                         string_id=ns.string_id, edata_dtype=np.float64,
                         retain_edge_list=bool(ns.delta_stream)
                         or ns.replicas > 1 or ns.autopilot)
    frag = LoadGraph(ns.efile, ns.vfile or None,
                     CommSpec(fnum=ns.fnum, device=ns.device), spec)

    def dyn_policy():
        # one copy of the repack decision, so a fleet run uses the plain
        # run's policy
        if not ns.delta_stream:
            return None
        from libgrape_lite_tpu_torch.dyn import RepackPolicy

        return (RepackPolicy(threshold=ns.dyn_repack_ratio)
                if ns.dyn_repack_ratio is not None
                else RepackPolicy.from_env())

    policy = BatchPolicy(max_batch=ns.max_batch,
                         max_wait_s=ns.max_wait_ms / 1e3)
    if ns.autopilot:
        return _serve_autopilot(ns, frag, queries, policy)
    if fleet_mode:
        return _serve_fleet(ns, frag, queries, delta_ops, policy,
                            dyn_policy)
    sess = ServeSession(frag, policy=policy, guard=ns.guard or None,
                        dyn=dyn_policy())
    pump = sess.async_pump(window=ns.inflight) if ns.inflight > 1 else None
    t0 = time.perf_counter()
    if ns.arrival_rate:
        from libgrape_lite_tpu_torch.serve import ArrivalFeeder

        feeder = ArrivalFeeder(
            sess.submit,
            [{"app": app_key, "args": {"source": src},
              "max_rounds": ns.max_rounds or None}
             for app_key, src in queries],
            ns.arrival_rate)
        results = []
        feeder.start()
        while feeder.is_alive() or sess.queue.pending() or (
                pump is not None and pump.inflight()):
            got = pump.pump() if pump is not None else sess.pump()
            results.extend(got)
            if not got:
                time.sleep(1e-4)
        feeder.join()
        results.extend(pump.drain() if pump is not None else sess.drain())
        return _serve_summary(ns, sess, pump, feeder.requests, results,
                              time.perf_counter() - t0, delta_ops)
    reqs = [sess.submit(app_key, {"source": src},
                        max_rounds=ns.max_rounds or None)
            for app_key, src in queries]
    if delta_ops:
        results = serve_with_ingest(sess, pump, reqs, delta_ops,
                                    ns.ingest_every)
    else:
        results = pump.drain() if pump is not None else sess.drain()
    return _serve_summary(ns, sess, pump, reqs, results,
                          time.perf_counter() - t0, delta_ops)


def serve_with_ingest(sess, pump, reqs, delta_ops, ingest_every: int):
    """Serve the submitted requests `reqs` with `delta_ops` ingested in
    equal chunks, one after every `ingest_every` dispatched queries, so
    updates land between batches while the stream runs.  The pump pins
    the same ingest points by dispatch count (`max_dispatch`), so every
    result byte is the same at any window.  Returns the results (the
    sync loop's in delivery order, the pump's in submit order: the same
    for a FIFO stream)."""
    ingest_every = max(1, ingest_every)
    n_chunks = max(1, -(-len(reqs) // ingest_every))
    chunk = -(-len(delta_ops) // n_chunks)
    oi = 0
    results = []
    if pump is not None:
        while sess.queue.pending() or pump.inflight() or oi < len(delta_ops):
            target = pump.dispatched_queries + ingest_every
            while sess.queue.pending() and pump.dispatched_queries < target:
                pump.pump(force=True, block=True, max_dispatch=target)
            if oi < len(delta_ops):
                pump.ingest(delta_ops[oi:oi + chunk])
                oi += chunk
            else:
                pump.drain()
        return [q.result for q in reqs]
    while sess.queue.pending() or oi < len(delta_ops):
        pumped = 0
        while sess.queue.pending() and pumped < ingest_every:
            got = sess.pump(force=True)
            results.extend(got)
            pumped += len(got)
        if oi < len(delta_ops):
            sess.ingest(delta_ops[oi:oi + chunk])
            oi += chunk
    return results


def _serve_fleet(ns, frag, queries, delta_ops, policy, dyn_policy) -> int:
    """The fleet path (JAX `cli.py::_serve_fleet`): R replica sessions
    behind a version-fenced router and/or N tenants under one budget,
    driven by `run_fleet_script`, so a `--replicas 2 --drain_at K` run
    is byte-identical, query by query, to the plain run."""
    from libgrape_lite_tpu_torch.fleet import (
        FLEET_STATS,
        FleetBudget,
        FleetManager,
        FleetRouter,
        run_fleet_script,
    )
    from libgrape_lite_tpu_torch.fragment.mutation import replicate_fragment
    from libgrape_lite_tpu_torch.serve import ServeSession

    FLEET_STATS.reset()  # the summary's fleet counters are this run's
    frags = [frag] + [replicate_fragment(frag)
                      for _ in range(ns.replicas - 1)]
    sessions = [ServeSession(f, policy=policy, guard=ns.guard or None,
                             dyn=dyn_policy())
                for f in frags]
    router = (FleetRouter(sessions, window=max(1, ns.inflight))
              if ns.replicas > 1 else None)
    target = router if router is not None else sessions[0]
    manager = tenant_of = None
    if ns.tenants:
        manager = FleetManager(FleetBudget(device=frag.device))
        if ns.tenants == "by_app":
            names = sorted({app for app, _ in queries})
            tenant_of = lambda i, app: app  # noqa: E731
        else:
            try:
                n_t = max(1, int(ns.tenants))
            except ValueError:
                sys.exit(f"serve: --tenants must be 'by_app' or an "
                         f"integer, got {ns.tenants!r}")
            names = [f"t{j}" for j in range(n_t)]
            tenant_of = lambda i, app: f"t{i % n_t}"  # noqa: E731
        for name in names:
            manager.add_tenant(name, target)
    t0 = time.perf_counter()
    reqs = run_fleet_script(
        target, [(app_key, {"source": src}) for app_key, src in queries],
        manager=manager, tenant_of=tenant_of, delta_ops=delta_ops,
        ingest_every=max(1, ns.ingest_every),
        drain_at=ns.drain_at if ns.drain_at >= 0 else None, drain_idx=0,
        submit_kwargs={"max_rounds": ns.max_rounds or None})
    wall = time.perf_counter() - t0
    results = [q.result for q in reqs if q.result is not None]
    fleet_block = {
        "replicas": ns.replicas,
        "tenants": len(manager.tenants) if manager is not None else 0,
        "fence": router.fence if router is not None else 0,
        "dropped": len(reqs) - len(results),
        **FLEET_STATS.snapshot(),
    }
    if router is not None:
        fleet_block["router"] = router.summary(wall)
    if manager is not None:
        snap = manager.snapshot()
        fleet_block["tenant_stats"] = snap["tenants"]
        fleet_block["budget"] = {"capacity": snap["budget"]["capacity"],
                                 "used_bytes": snap["budget"]["used_bytes"]}
    return _serve_summary(ns, sessions[0], None, reqs, results, wall,
                          delta_ops, fleet_block=fleet_block,
                          sessions=sessions)


def serve_autopilot_stream(router, autopilot, stream,
                           arrival_rate="") -> list:
    """Serve `stream` (the ServeSession.serve dict items) through
    `router` while `autopilot` (an Autoscaler) ticks after every pump
    pass.  With `arrival_rate` a feeder thread appends arrivals to an
    inbox at that rate (a number or a step schedule, '50:2x@100') and
    this thread alone submits, pumps and ticks; without it every query
    is submitted up front, one pump and tick after each.  Returns the
    requests in submit order, each finished."""
    from collections import deque

    def busy():
        return any(r.session.queue.pending() or r.pump.inflight()
                   for r in router.replicas)

    reqs = []
    if arrival_rate:
        from libgrape_lite_tpu_torch.serve import ArrivalFeeder

        inbox: deque = deque()

        def enqueue(app_key, args, **kw):
            inbox.append((app_key, args, kw))

        feeder = ArrivalFeeder(enqueue, stream, arrival_rate)
        feeder.start()
        while feeder.is_alive() or inbox or busy():
            moved = 0
            while inbox:
                app_key, args, kw = inbox.popleft()
                reqs.append(router.submit(app_key, args, **kw))
                moved += 1
            got = router.pump()
            autopilot.tick()
            if not got and not moved:
                time.sleep(1e-4)
        feeder.join()
    else:
        for item in stream:
            reqs.append(router.submit(item["app"], item["args"],
                                      max_rounds=item["max_rounds"]))
            router.pump()
            autopilot.tick()
        while busy():
            got = router.pump()
            autopilot.tick()
            if not got:
                # a launched batch runs in its own thread: let it have
                # the interpreter instead of spinning on it
                time.sleep(1e-4)
    router.drain()
    return reqs


def _serve_autopilot(ns, frag, queries, policy) -> int:
    """The closed-loop path (JAX `cli.py::_serve_autopilot`): a replica
    fleet whose size an Autoscaler moves between --min_replicas and
    --max_replicas, with a shared fence-epoch result cache in front."""
    from libgrape_lite_tpu_torch.autopilot import (
        AUTOPILOT_STATS,
        Autoscaler,
        ResultCache,
        ScalerConfig,
    )
    from libgrape_lite_tpu_torch.fleet import (
        FLEET_STATS,
        FleetBudget,
        FleetRouter,
    )
    from libgrape_lite_tpu_torch.fragment.mutation import replicate_fragment
    from libgrape_lite_tpu_torch.serve import ServeSession

    FLEET_STATS.reset()
    AUTOPILOT_STATS.reset()

    def make_session(f):
        return ServeSession(f, policy=policy, guard=ns.guard or None)

    n0 = max(1, ns.min_replicas, ns.replicas)
    sessions = [make_session(f) for f in
                [frag] + [replicate_fragment(frag) for _ in range(n0 - 1)]]
    router = FleetRouter(sessions, window=max(1, ns.inflight))
    cache = None
    if ns.cache_entries > 0:
        cache = ResultCache(capacity=ns.cache_entries)
        router.attach_cache(cache)
    cfg = ScalerConfig(min_replicas=n0,
                       max_replicas=max(n0, ns.max_replicas))
    autopilot = Autoscaler(router, cfg, session_factory=make_session,
                           budget=FleetBudget(device=frag.device))
    stream = [{"app": app_key, "args": {"source": src},
               "max_rounds": ns.max_rounds or None}
              for app_key, src in queries]
    t0 = time.perf_counter()
    reqs = serve_autopilot_stream(router, autopilot, stream,
                                  ns.arrival_rate)
    wall = time.perf_counter() - t0
    results = [q.result for q in reqs if q.result is not None]
    ap = AUTOPILOT_STATS.snapshot()
    autopilot_block = {
        "min_replicas": cfg.min_replicas,
        "max_replicas": cfg.max_replicas,
        "replicas_final": sum(1 for r in router.replicas if r.routable),
        "replicas_peak": len(router.replicas),
        **{k: ap[k] for k in (
            "ticks", "scale_ups", "scale_downs", "holds", "shed",
            "deferred", "cache_hits", "cache_misses", "cache_stores")},
    }
    if cache is not None:
        autopilot_block["cache"] = cache.snapshot()
    fleet_block = {
        "replicas": len(router.replicas),
        "tenants": 0,
        "fence": router.fence,
        "dropped": len(reqs) - len(results),
        **FLEET_STATS.snapshot(),
        "router": router.summary(wall),
    }
    return _serve_summary(
        ns, router.replicas[0].session, None, reqs, results, wall, [],
        fleet_block=fleet_block,
        sessions=[r.session for r in router.replicas],
        autopilot_block=autopilot_block)


def _serve_summary(ns, sess, pump, reqs, results, wall, delta_ops,
                   fleet_block=None, sessions=None,
                   autopilot_block=None) -> int:
    """Print the serve summary record (JAX `cli.py::_serve_summary`'s
    keys, plus the device it ran on) and write --dump_results.  With
    `sessions` (the fleet paths) the batch histograms, admission waits,
    worker counters and dyn counters add up over them."""
    import hashlib

    import torch

    from libgrape_lite_tpu_torch.obs import slo
    from libgrape_lite_tpu_torch.serve import PUMP_STATS
    from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

    sessions = sessions or [sess]
    lat = latency_summary_ms([r.latency_s for r in results])
    ok = sum(1 for r in results if r.ok)
    per_app, by_app = {}, {}
    for r in results:
        per_app[r.app_key] = per_app.get(r.app_key, 0) + 1
        by_app.setdefault(r.app_key, []).append(r.latency_s)
    waits = latency_summary_ms(
        [w for s in sessions for w in s.queue.admission_waits])
    batch_hist: dict = {}
    cache = {"runner": {"hits": 0, "misses": 0},
             "pack": sess.cache_stats()["pack"]}
    for s in sessions:
        for k, v in s.queue.batch_hist.items():
            batch_hist[k] = batch_hist.get(k, 0) + v
        for k, v in s.cache_stats()["runner"].items():
            cache["runner"][k] += v
    record = {
        "queries": len(results),
        "ok": ok,
        "failed": len(results) - ok,
        "wall_s": round(wall, 4),
        "qps": round(len(results) / wall, 2) if wall > 0 else 0.0,
        "p50_ms": lat["p50_ms"],
        "p99_ms": lat["p99_ms"],
        "max_batch": ns.max_batch,
        "inflight": ns.inflight,
        "batch_hist": {str(k): v for k, v in sorted(batch_hist.items())},
        "admission_wait_ms": {"p50": waits["p50_ms"],
                              "p99": waits["p99_ms"]},
        "apps": per_app,
        "per_app_ms": {
            app: {"p50": s["p50_ms"], "p99": s["p99_ms"]}
            for app, s in ((a, latency_summary_ms(v))
                           for a, v in sorted(by_app.items()))},
        "cache": cache,
        "device": (torch.cuda.get_device_name(sess.fragment.device)
                   if sess.fragment.device.type == "cuda" else "cpu"),
    }
    stage_lists: dict = {}
    for r in results:
        for k, v in (r.stages or {}).items():
            stage_lists.setdefault(k, []).append(v / 1e6)
    if stage_lists:
        record["stages"] = {
            k: {"p50": s["p50_ms"], "p99": s["p99_ms"]}
            for k, s in ((k, latency_summary_ms(v))
                         for k, v in sorted(stage_lists.items()))}
    if slo.configured():
        record["slo"] = slo.SLO_STATS.snapshot()
    if pump is not None:
        record["pump"] = {"window": pump.window, **pump.stats,
                          **PUMP_STATS.snapshot()}
    if delta_ops:
        ingested = sum(s.stats["ingested_ops"] for s in sessions)
        record["dyn"] = {
            "ingested": ingested,
            "overlay_applies": sum(s.stats["overlay_applies"]
                                   for s in sessions),
            "repack_count": sum(s.stats["repacks"] for s in sessions),
            "queries": len(results),
            "queries_ok": ok,
            "updates_per_s": round(ingested / wall, 2) if wall > 0 else 0.0,
        }
    if fleet_block is not None:
        record["fleet"] = fleet_block
    if autopilot_block is not None:
        record["autopilot"] = autopilot_block
    if ns.dump_results:
        with open(ns.dump_results, "w") as fh:
            for i, req in enumerate(reqs):
                r = req.result
                digest = (hashlib.sha256(r.values.tobytes()).hexdigest()
                          if r is not None and r.ok and r.values is not None
                          else "-")
                fh.write(f"{i} {req.app_key} "
                         f"{int(bool(r is not None and r.ok))} "
                         f"{r.rounds if r is not None else -1} {digest}\n")
    print(json.dumps(record), flush=True)
    if results and not ok:
        print("[serve] every query failed", file=sys.stderr)
        sys.exit(1)
    from libgrape_lite_tpu_torch import obs

    if obs.armed():
        obs.flush()
    return 0


def make_postmortem_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="libgrape_lite_tpu_torch postmortem")
    p.add_argument("bundle",
                   help="flight-recorder bundle json (obs/recorder.py writes "
                        "one per trigger into the GRAPE_POSTMORTEM "
                        "directory)")
    p.add_argument("--trace", default="",
                   help="Chrome trace of the same run: check that every "
                        "serve_query row of the bundle is byte for byte the "
                        "trace's row of that query id (exit 1 on any "
                        "mismatch)")
    p.add_argument("--json", action="store_true",
                   help="print the raw bundle instead of the report")
    return p


def postmortem_main(argv=None) -> int:
    """The `postmortem` subcommand (JAX `cli.py::postmortem_main`):
    render a bundle; with --trace, prove its `serve_query` rows are the
    trace's rows (the sort_keys serialization of each, by query id: the
    bundle copies the tracer's history, so any drift is a fault).
    Returns 0, 1 (rows drifted or absent) or 2 (unreadable or foreign
    bundle or trace)."""
    from collections import Counter

    from libgrape_lite_tpu_torch.obs.recorder import BUNDLE_SCHEMA

    ns = make_postmortem_parser().parse_args(argv)
    try:
        with open(ns.bundle) as fh:
            bundle = json.load(fh)
    except (OSError, ValueError) as e:
        print(f"postmortem: {ns.bundle}: {e}", file=sys.stderr)
        return 2
    if not isinstance(bundle, dict) or bundle.get("schema") != BUNDLE_SCHEMA:
        schema = bundle.get("schema") if isinstance(bundle, dict) else None
        print(f"postmortem: {ns.bundle}: schema {schema!r} != "
              f"{BUNDLE_SCHEMA!r}", file=sys.stderr)
        return 2
    if ns.json:
        print(json.dumps(bundle, indent=1))
        return 0

    events = bundle.get("events") or []
    spans = bundle.get("spans") or []
    instants = bundle.get("instants") or []
    fed = bundle.get("federation") or {}
    guard = bundle.get("guard")
    guard_text = ("yes (" + str((guard.get("verdict") or {}).get("kind"))
                  + ")" if guard else "no")
    lines = [
        f"postmortem: {bundle['reason']}",
        f"  trace_id:    {bundle.get('trace_id')}",
        f"  extra:       "
        f"{json.dumps(bundle.get('extra') or {}, sort_keys=True)}",
        f"  ring events: {len(events)} "
        f"({dict(Counter(e.get('kind') for e in events))})",
        f"  spans:       {len(spans)} "
        f"({dict(Counter(s.get('name') for s in spans))})",
        f"  instants:    {len(instants)} "
        f"({dict(Counter(i.get('name') for i in instants))})",
        f"  federation:  {sorted(fed)}",
        f"  guard:       {guard_text}",
    ]
    slo_snap = fed.get("slo") or {}
    if slo_snap.get("objectives_ms"):
        lines.append(
            f"  slo:         {slo_snap.get('breaches', 0)} breach(es) of "
            f"{slo_snap.get('observed', 0)} observed, max burn "
            f"{slo_snap.get('max_burn', 0.0)}")
    print("\n".join(lines))
    if not ns.trace:
        return 0
    try:
        with open(ns.trace) as fh:
            trace = json.load(fh)
    except (OSError, ValueError) as e:
        print(f"postmortem: {ns.trace}: {e}", file=sys.stderr)
        return 2
    by_qid: dict = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("name") != "serve_query":
            continue
        qid = (ev.get("args") or {}).get("query_id")
        if qid is not None:
            by_qid.setdefault(qid, []).append(json.dumps(ev, sort_keys=True))
    matched = mismatched = missing = 0
    for row in spans:
        if row.get("name") != "serve_query":
            continue
        qid = (row.get("args") or {}).get("query_id")
        want = json.dumps(row, sort_keys=True)
        cands = by_qid.get(qid, [])
        if want in cands:
            matched += 1
        elif cands:
            mismatched += 1
        else:
            missing += 1
    print(f"trace cross-check: {matched} serve_query row(s) byte-matched, "
          f"{mismatched} mismatched, {missing} absent from the trace")
    return 1 if (mismatched or missing) else 0


def make_lint_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="libgrape_lite_tpu_torch lint")
    p.add_argument("paths", nargs="*",
                   help="files / directories to lint (default: the "
                        "libgrape_lite_tpu_torch tree)")
    p.add_argument("--json", action="store_true",
                   help="print the structured report, checked against "
                        "its schema (analysis/report.py) first")
    p.add_argument("--baseline", default="",
                   help="suppression baseline path (default: "
                        "analysis/baseline.json)")
    p.add_argument("--artifact", action="store_true",
                   help="also run A3: the warm query matrix (sssp / bfs "
                        "x fused / guarded / batched / incremental) "
                        "must build no library, plan, worker or device "
                        "cache")
    p.add_argument("--update-baseline", default=None, metavar="REASON",
                   help="suppress every current unsuppressed AST finding "
                        "into the baseline with this reason")
    p.add_argument("--device", default="cuda",
                   help="device of the --artifact audit: cuda (raises "
                        "without CUDA) or cpu")
    return p


def lint_main(argv=None) -> int:
    """The `lint` subcommand; returns the exit code (1 on any
    unsuppressed or stale finding)."""
    import os

    from libgrape_lite_tpu_torch import analysis

    ns = make_lint_parser().parse_args(argv)
    if ns.update_baseline is not None:
        if not ns.update_baseline:
            # an empty reason (an unset shell variable) is a usage error,
            # not a plain lint run
            print("grape-lint: --update-baseline needs a non-empty "
                  "REASON — exceptions are named, not invisible",
                  file=sys.stderr)
            return 2
        paths = ns.paths or [
            os.path.join(analysis.repo_root(), "libgrape_lite_tpu_torch")]
        try:
            findings = analysis.lint_paths(paths)
        except FileNotFoundError as e:
            print(f"grape-lint: {e}", file=sys.stderr)
            return 2
        baseline = analysis.Baseline.load(ns.baseline or None)
        live, _ = analysis.split_by_baseline(findings, baseline)
        for f in live:
            baseline.add(f, ns.update_baseline)
        path = baseline.save()
        print(f"baseline: {len(live)} suppression(s) added -> {path}")
        return 0

    try:
        report, rc = analysis.run_lint(
            ns.paths, baseline_path=ns.baseline or None,
            artifact=ns.artifact, device=ns.device)
    except FileNotFoundError as e:
        print(f"grape-lint: {e}", file=sys.stderr)
        return 2
    if ns.json:
        errors = analysis.validate_lint_report(report)
        # the record prints either way: schema drift fails after it
        print(json.dumps(report), flush=True)
        for e in errors:
            print(f"lint-report schema: {e}", file=sys.stderr)
        return 3 if errors else rc
    live = [analysis.Finding(**{k: f[k] for k in (
        "rule", "path", "line", "symbol", "message")})
        for f in report["findings"] if not f["suppressed"]]
    quiet = [f for f in report["findings"] if f["suppressed"]]
    print(analysis.render_text(live, quiet, report.get("stale")))
    return rc


def make_calibrate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="libgrape_lite_tpu_torch calibrate")
    p.add_argument("--out", default="",
                   help="write the fitted rate profile json here "
                        "(install it with GRAPE_RATE_PROFILE=<path>)")
    p.add_argument("--samples-out", default="",
                   help="write the measured sweep json (--check "
                        "--samples replays it)")
    p.add_argument("--samples", default="",
                   help="fit or check a recorded sample set instead of "
                        "measuring")
    p.add_argument("--check", action="store_true",
                   help="no fit: gate the active profile (or --profile) "
                        "against the samples; exit 2 past the 5%% "
                        "tolerance")
    p.add_argument("--profile", default="",
                   help="the profile json --check gates (default: the "
                        "active profile)")
    p.add_argument("--scales", default="16,18",
                   help="comma-separated RMAT scales of the sweep")
    p.add_argument("--ef", default="4,16",
                   help="comma-separated RMAT edge factors of the sweep")
    p.add_argument("--repeats", type=int, default=3,
                   help="best-of-N walls a call")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--min-wall-s", type=float, default=-1.0,
                   help="leave out sweep samples under this wall "
                        "(default: 20 ms on the CPU, 0 on the card)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON record instead of the table")
    p.add_argument("--device", default="cuda",
                   help="cuda (raises without CUDA) or cpu (plain "
                        "versions on the host clock: no card's rates)")
    return p


def _ints(text: str) -> tuple:
    return tuple(int(v) for v in text.split(",") if v)


def calibrate_main(argv=None) -> int:
    """The `calibrate` subcommand: measure (or read) samples, fit the
    rate profile and write it, or gate a profile against the samples.
    Samples of the HELD_OUT surfaces are reported, never fitted or gated.
    Exit 0 when the fit or the gate holds, 2 when the fit is infeasible,
    the drift passes DRIFT_TOLERANCE or a samples or profile file is
    unreadable."""
    from libgrape_lite_tpu_torch.ops import calibration as calib
    from libgrape_lite_tpu_torch.parallel.comm_spec import resolve_device

    ns = make_calibrate_parser().parse_args(argv)
    device = resolve_device(ns.device)
    try:
        if ns.samples:
            samples = calib.load_samples(ns.samples)
        else:
            samples = calib.microbench_samples(
                scales=_ints(ns.scales), efs=_ints(ns.ef), seed=ns.seed,
                repeats=ns.repeats, device=device,
                log=lambda line: print(line, file=sys.stderr, flush=True))
            floor = (ns.min_wall_s if ns.min_wall_s >= 0
                     else calib.default_min_wall_s(device))
            kept = [s for s in samples if s["wall_s"] >= floor]
            if len(kept) < len(samples):
                print(f"calibrate: dropped {len(samples) - len(kept)} "
                      f"sample(s) under the {floor * 1e3:g} ms floor",
                      file=sys.stderr)
            samples = kept
        gated, held = calib.split_held_out(samples)
        if not gated:
            print("calibrate: no usable samples: nothing to fit",
                  file=sys.stderr)
            return 2
        notes: list = []
        fit = None
        if ns.check:
            prof = (calib.load_profile(ns.profile) if ns.profile
                    else calib.active_profile())
        else:
            fit, notes = calib.fit_rates_auto(
                gated, base=calib.default_profile(),
                source="samples" if ns.samples else "microbench",
                device=device)
            prof = fit.profile
        rep = calib.drift_report(prof, gated)
        held_rep = calib.drift_report(prof, held) if held else None
    except calib.CalibrationError as e:
        print(f"calibrate: {e}", file=sys.stderr)
        return 2

    out_path = samples_path = None
    if not ns.check and ns.out:
        out_path = calib.save_profile(prof, ns.out)
    if ns.samples_out:
        samples_path = calib.save_samples(samples, ns.samples_out, device)
    block = {
        "profile": prof.label(),
        "fingerprint": calib.backend_fingerprint(device),
        "source": prof.source,
        "fitted": bool(prof.fitted),
        "samples": len(samples),
        "regressors": list(fit.regressors) if fit is not None else [],
        "cond": fit.cond if fit is not None else None,
        "residual_pct": (round(fit.residual * 100.0, 3) if fit is not None
                         else -1.0),
        "drift_pct": rep["drift_pct"],
        "max_sample_drift_pct": rep["max_sample_drift_pct"],
        "drift_ok": rep["drift_ok"],
        "rates": {
            "ops_per_s": prof.ops_per_s,
            "gather_per_s": prof.gather_per_s,
            "hbm_bps": prof.hbm_bps,
            "dispatch_overhead_s": prof.dispatch_overhead_s,
            "exchange_bps": dict(prof.exchange_bps),
            "hbm_capacity_bytes": prof.hbm_capacity_bytes,
        },
        "unfitted": sorted(prof.unfitted),
        "fallback_notes": list(notes),
        "surfaces": rep["surfaces"],
        # measured under the profile, neither fitted nor gated
        "held_out": held_rep["surfaces"] if held_rep else {},
    }
    if ns.json:
        print(json.dumps({"calibration": block, "out": out_path,
                          "samples_out": samples_path}))
    else:
        print(f"profile:  {block['profile']} (source={block['source']}, "
              f"fitted={block['fitted']})")
        for r, v in sorted(block["rates"].items()):
            print(f"  {r:<22} {v}")
        if fit is not None:
            print(f"  regressors: {'+'.join(fit.regressors)}, condition "
                  f"{fit.cond:.4g}")
        if block["unfitted"]:
            print(f"  unfitted (inherited): {', '.join(block['unfitted'])}")
        for n in notes:
            print(f"  [fallback] {n}")
        for surf, e in sorted(rep["surfaces"].items()) + sorted(
                block["held_out"].items()):
            tag = " (held out)" if surf in block["held_out"] else ""
            print(f"drift[{surf}]{tag}: modeled {e['modeled_s']:.6f}s vs "
                  f"measured {e['measured_s']:.6f}s over {e['samples']} "
                  f"sample(s) = {e['drift_pct']:g}%")
        verdict = "OK" if rep["drift_ok"] else "FAIL"
        print(f"{verdict}: drift {rep['drift_pct']:g}% (tolerance "
              f"{rep['tolerance_pct']:g}%), residual "
              f"{block['residual_pct']:g}%")
        if out_path:
            print(f"profile -> {out_path}")
        if samples_path:
            print(f"samples -> {samples_path}")
    return 0 if rep["drift_ok"] else 2


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "postmortem":
        return postmortem_main(argv[1:])
    if argv and argv[0] == "calibrate":
        return calibrate_main(argv[1:])
    if argv and argv[0] == "lint":
        return lint_main(argv[1:])
    ns = make_parser().parse_args(argv)
    try:
        run_app(QueryArgs(**vars(ns)))
    finally:
        # a gang member leaves its process group on the error path too
        from libgrape_lite_tpu_torch.parallel.comm_spec import leave_group

        leave_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
