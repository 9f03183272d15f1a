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
  kclique (--kclique_k).
--directed loads the graph directed.

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

The `serve` subcommand loads the graph once and serves a stream of
point queries through a ServeSession (serve/), batching compatible
ones, and prints one JSON summary line (the JAX CLI's keys):

    python -m libgrape_lite_tpu_torch.cli serve --efile dataset/p2p-31.e \
        --vfile dataset/p2p-31.v --application sssp --num_queries 16 \
        --max_batch 8 [--inflight 4] [--dump_results out.txt] \
        [--delta_stream ops.txt --ingest_every 8] [--device cpu]
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
                   help="fragment count, stacked on the one device")
    p.add_argument("--partitioner_type", default="map",
                   choices=["hash", "map", "segment"])
    p.add_argument("--idxer_type", default="hashmap",
                   choices=["hashmap", "sorted_array", "pthash", "local"])
    p.add_argument("--serialize", action="store_true")
    p.add_argument("--deserialize", action="store_true")
    p.add_argument("--serialization_prefix", default="")
    p.add_argument("--delta_efile", default="")
    p.add_argument("--delta_vfile", default="")
    p.add_argument("--string_id", action="store_true",
                   help="treat vertex ids as strings")
    p.add_argument("--rebalance", action="store_true")
    p.add_argument("--rebalance_vertex_factor", type=int, default=0)
    p.add_argument("--memory_stats", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


# serve flags whose subsystem is not ported yet: (subsystem, ROADMAP
# Queue A item).  Given at all, each is a usage error
_UNPORTED_SERVE_FLAGS = {
    "replicas": ("fleet/", 5),
    "drain_at": ("fleet/", 5),
    "tenants": ("fleet/", 5),
    "autopilot": ("autopilot/", 5),
    "min_replicas": ("autopilot/", 5),
    "max_replicas": ("autopilot/", 5),
    "cache_entries": ("autopilot/", 5),
    "trace": ("obs/", 6),
    "metrics": ("obs/", 6),
    "metrics_port": ("obs/", 6),
    "slo": ("obs/", 6),
}


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
                   help="per-lane guard policy: only off here (warn, "
                        "halt, rollback: ROADMAP Queue A item 6)")
    unported = p.add_argument_group(
        "not ported yet (each one a usage error naming its ROADMAP item)")
    for flag in ("replicas", "drain_at", "min_replicas", "max_replicas",
                 "cache_entries", "metrics_port"):
        unported.add_argument(f"--{flag}", type=int, default=None)
    for flag in ("tenants", "trace", "metrics", "slo"):
        unported.add_argument(f"--{flag}", default=None)
    unported.add_argument("--autopilot", action="store_true", default=None)
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

    parser = make_serve_parser()
    ns = parser.parse_args(argv)
    for flag, (subsystem, item) in _UNPORTED_SERVE_FLAGS.items():
        if getattr(ns, flag) is not None:
            parser.error(f"--{flag} needs {subsystem}, not ported yet: "
                         f"ROADMAP Queue A item {item}")
    if ns.guard not in ("", "off"):
        parser.error(f"--guard {ns.guard} needs guard/ and serve/batch.py, "
                     "not ported yet: ROADMAP Queue A item 6")
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
        if delta_ops:
            # the ingest cadence is pinned by dispatch count, which a
            # wall-clock feeder cannot reproduce
            sys.exit("serve: --arrival_rate does not compose with "
                     "--delta_stream")
    spec = LoadGraphSpec(directed=ns.directed, weighted=weighted,
                         string_id=ns.string_id, edata_dtype=np.float64,
                         retain_edge_list=bool(ns.delta_stream))
    frag = LoadGraph(ns.efile, ns.vfile or None,
                     CommSpec(fnum=ns.fnum, device=ns.device), spec)
    dyn = None
    if ns.delta_stream:
        from libgrape_lite_tpu_torch.dyn import RepackPolicy

        dyn = (RepackPolicy(threshold=ns.dyn_repack_ratio)
               if ns.dyn_repack_ratio is not None
               else RepackPolicy.from_env())
    sess = ServeSession(frag, policy=BatchPolicy(
        max_batch=ns.max_batch, max_wait_s=ns.max_wait_ms / 1e3), dyn=dyn)
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


def _serve_summary(ns, sess, pump, reqs, results, wall, delta_ops) -> int:
    """Print the serve summary record (JAX `cli.py::_serve_summary`'s
    keys, plus the device it ran on) and write --dump_results."""
    import hashlib

    import torch

    from libgrape_lite_tpu_torch.serve import PUMP_STATS
    from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

    lat = latency_summary_ms([r.latency_s for r in results])
    ok = sum(1 for r in results if r.ok)
    per_app, by_app = {}, {}
    for r in results:
        per_app[r.app_key] = per_app.get(r.app_key, 0) + 1
        by_app.setdefault(r.app_key, []).append(r.latency_s)
    waits = sess.queue.admission_wait_summary()
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
        "batch_hist": {str(k): v
                       for k, v in sorted(sess.queue.batch_hist.items())},
        "admission_wait_ms": {"p50": waits["p50_ms"],
                              "p99": waits["p99_ms"]},
        "apps": per_app,
        "per_app_ms": {
            app: {"p50": s["p50_ms"], "p99": s["p99_ms"]}
            for app, s in ((a, latency_summary_ms(v))
                           for a, v in sorted(by_app.items()))},
        "cache": sess.cache_stats(),
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
    if pump is not None:
        record["pump"] = {"window": pump.window, **pump.stats,
                          **PUMP_STATS.snapshot()}
    if delta_ops:
        ingested = sess.stats["ingested_ops"]
        record["dyn"] = {
            "ingested": ingested,
            "overlay_applies": sess.stats["overlay_applies"],
            "repack_count": sess.stats["repacks"],
            "queries": len(results),
            "queries_ok": ok,
            "updates_per_s": round(ingested / wall, 2) if wall > 0 else 0.0,
        }
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
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    ns = make_parser().parse_args(argv)
    run_app(QueryArgs(**vars(ns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
