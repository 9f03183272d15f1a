"""run_app: dispatch by app name, load, query, output.

Counterpart of `libgrape_lite_tpu/runner.py::run_app` (reference
`examples/analytical_apps/run_app.{cc,h}`).  `trace` / `metrics` arm
obs/ before the load (a Chrome trace with its JSONL twin, and the
metrics snapshot as `<metrics>.json` / `.prom`); `profile` logs each
round's seconds and vote (vlog level 1).  `checkpoint_every` /
`checkpoint_dir` snapshot the query's supersteps, `resume` continues
the lineage in `checkpoint_dir`, `guard` sets the breach policy (ft/,
guard/).  A guard halt raises out of `run_app` (the CLI exits 1, as the
JAX package's does).

The vertex cut (JAX `runner.py:183-310`): `vc` runs the gather-scatter
app on an ImmutableVertexcutFragment (`pagerank` names `pagerank_vc`,
reference `run_app_vc.h:82-89`).  Without it, `GRAPE_PARTITION=2d|auto`
asks the partition planner (fragment/partition.py) after a probe read
of the edge file; an engaged decision swaps in the app's 2-D twin and
builds the vertex-cut fragment from the probe's arrays.  Every declined
request is recorded with its reason -- the cheap ones (another app, a
non-square fnum, string ids, a delta load, the serialization cache)
without reading the edge file.

Several processes (JAX `runner.py:114-140`): `coordinator`,
`num_processes` and `process_id` start a `torch.distributed` group
(`CommSpec.init_distributed`) before the partition probe and the load;
every rank loads the same graph and places its slab of fragments, the
query's collectives cross ranks, and only the coordinator writes the
result files.  Across processes (world > 1) this runs the edge-cut
superstep of sssp, bfs, wcc and pagerank; every other app and mode
raises before the load, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
from libgrape_lite_tpu_torch.models import APP_REGISTRY
from libgrape_lite_tpu_torch.parallel.comm_spec import (
    CommSpec,
    decline_across_ranks,
    host_allgather,
)
from libgrape_lite_tpu_torch.utils.memory import get_memory_stats
from libgrape_lite_tpu_torch.worker.worker import Worker

_LOG = logging.getLogger(__name__)


@dataclass
class QueryArgs:
    """Flag bag (reference `examples/analytical_apps/flags.cc:23-69`)."""

    application: str = "sssp"
    efile: str = ""
    vfile: str = ""
    out_prefix: str = ""
    directed: bool = False
    sssp_source: int | str = 0
    bfs_source: int | str = 0
    bc_source: int | str = 0
    kcore_k: int = 0
    kclique_k: int = 3
    khop_k: int = 2  # khop's hop bound (its source is bfs_source)
    cn_source: int | str = 0  # common_neighbors' query source
    pr_d: float = 0.85
    pr_mr: int = 10
    cdlp_mr: int = 10
    degree_threshold: int = 0
    fnum: int | None = None
    device: str = "cuda"
    partitioner_type: str = "map"
    idxer_type: str = "hashmap"
    rebalance: bool = False
    rebalance_vertex_factor: int = 0
    string_id: bool = False
    memory_stats: bool = False
    serialize: bool = False
    deserialize: bool = False
    serialization_prefix: str = ""
    # reference LoadGraphAndMutate: edit files applied before the build
    delta_efile: str = ""
    delta_vfile: str = ""
    # obs/: per-round timing lines, the Chrome trace, the metrics files
    profile: bool = False
    trace: str = ""
    metrics: str = ""
    # ft/ and guard/: the superstep checkpoint cadence (0 = off), its
    # directory, a resume from it, and the breach policy ("" reads
    # GRAPE_GUARD)
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    resume: bool = False
    guard: str = ""
    # vertex-cut (2-D) storage; fnum must be k^2
    vc: bool = False
    # the multi-process runtime: the rendezvous address (host:port), the
    # process count (0 or 1 = one process) and this process's rank
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1


def _coerce_source(v, string_id: bool = False):
    """A numeric source string becomes an int, unless the graph's ids
    are strings."""
    if string_id or isinstance(v, int):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        return v


def build_query_kwargs(app_name: str, args: QueryArgs) -> dict:
    """Per-query arguments by app-name prefix (the JAX package's
    `build_query_kwargs`)."""
    if app_name.startswith("sssp"):
        return {"source": _coerce_source(args.sssp_source, args.string_id)}
    if app_name.startswith("bfs"):
        return {"source": _coerce_source(args.bfs_source, args.string_id)}
    if app_name == "bc":  # staged_bc and staged_bc_bfs take none
        return {"source": _coerce_source(args.bc_source, args.string_id)}
    if app_name == "kcore":
        return {"k": args.kcore_k}
    if app_name == "kclique":
        return {"k": args.kclique_k}
    if app_name.startswith("pagerank"):
        return {"delta": args.pr_d, "max_round": args.pr_mr}
    if app_name.startswith("lcc") or app_name == "triangle_count":
        # hub cost cap (reference FLAGS_degree_threshold, lcc.h:234-243);
        # 0 disables it
        return {"degree_threshold": args.degree_threshold}
    if app_name == "common_neighbors":
        return {"source": _coerce_source(args.cn_source, args.string_id)}
    if app_name == "khop":
        # the hop bound is a constructor argument (run_app); the query
        # takes the source alone
        return {"source": _coerce_source(args.bfs_source, args.string_id)}
    if app_name.startswith("cdlp"):
        return {"max_round": args.cdlp_mr}
    return {}


def _resolve_partition(args: QueryArgs, name: str, app, comm_spec,
                       weighted: bool):
    """GRAPE_PARTITION's branch (JAX `runner.py:202-286`): (name, app,
    the probe's (src, dst, w, oids) when the 2-D twin engaged, else
    None).  Consulted only when GRAPE_PARTITION asks; every decline is
    recorded, the structural ones before any edge is read."""
    from libgrape_lite_tpu_torch.fragment.partition import (
        VC2D_APPS,
        partition_mode,
        precheck_partition,
        resolve_partition,
    )

    if partition_mode() == "1d":
        return name, app, None
    empty = np.zeros(0, dtype=np.int64)
    kw = dict(directed=args.directed, string_id=args.string_id)
    if comm_spec.world > 1:
        resolve_partition(name, comm_spec.fnum, empty, empty, empty,
                          eligible=False,
                          reason="world > 1: the vertex cut across "
                                 "processes is ROADMAP item 8c", **kw)
    elif args.delta_efile or args.delta_vfile:
        resolve_partition(name, comm_spec.fnum, empty, empty, empty,
                          eligible=False,
                          reason="delta-mutation load has no vertex-cut "
                                 "path", **kw)
    elif args.serialize or args.deserialize or not args.efile:
        # the garc cache is an edge-cut artifact, and a deserialize run
        # may name no edge file at all
        resolve_partition(name, comm_spec.fnum, empty, empty, empty,
                          eligible=False,
                          reason="serialization cache flags (or no edge "
                                 "file): the vertex-cut fragment has no "
                                 "serialized form", **kw)
    elif precheck_partition(name, comm_spec.fnum, **kw) is not None:
        resolve_partition(name, comm_spec.fnum, empty, empty, empty, **kw)
    else:
        from libgrape_lite_tpu_torch.io.line_parser import (
            read_edge_file,
            read_vertex_file,
        )

        src, dst, w = read_edge_file(args.efile, weighted=weighted)
        oids = (read_vertex_file(args.vfile) if args.vfile
                else np.unique(np.concatenate([src, dst])))
        decision = resolve_partition(name, comm_spec.fnum, src, dst, oids,
                                     directed=args.directed)
        if decision["engaged"]:
            name = VC2D_APPS[name]
            return name, APP_REGISTRY[name](), (src, dst, w, oids)
        # a declined probe falls through to the 1-D loader, which reads
        # the file again
    return name, app, None


def _load_vertexcut(args: QueryArgs, name: str, comm_spec, weighted: bool,
                    inputs):
    """The vertex-cut fragment of a run: from the partition probe's
    arrays, or read here.  A probe-engaged min-fold twin gets symmetrised
    tiles when the graph is undirected (wcc_vc always: weak connectivity
    is the undirected traversal); pagerank_vc keeps raw storage.  The
    `--vc` path builds raw directed storage, the JAX package's build
    defaults (its --vc is the reference's PageRank-only path)."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.fragment.vertexcut import (
        ImmutableVertexcutFragment,
    )

    with obs.tracer().span("load_graph", efile=args.efile,
                           fnum=comm_spec.fnum, path="vertexcut"):
        if inputs is None:
            from libgrape_lite_tpu_torch.io.line_parser import (
                read_edge_file,
                read_vertex_file,
            )

            src, dst, w = read_edge_file(args.efile, weighted=weighted)
            oids = (read_vertex_file(args.vfile) if args.vfile
                    else np.unique(np.concatenate([src, dst])))
            directed, sym = True, False
        else:
            src, dst, w, oids = inputs
            directed = args.directed
            sym = name == "wcc_vc" or (name != "pagerank_vc"
                                       and not args.directed)
        return ImmutableVertexcutFragment.build(
            comm_spec, oids, src, dst, w if weighted else None,
            directed=directed, symmetrize=sym)


#: the apps whose superstep runs across processes (world > 1)
DIST_APP_NAMES = ("sssp", "bfs", "wcc", "pagerank")


def check_across_processes(args: QueryArgs) -> None:
    """What a run across processes declines, before any load: each
    raises a ValueError naming ROADMAP item 8b.4 or 8c (never a silent
    single-process run).  Checkpoints, resumes, guards and fault plans
    run across processes (ft/distributed.py, guard/vote.py)."""
    from libgrape_lite_tpu_torch.fragment.partition import partition_mode
    from libgrape_lite_tpu_torch.parallel.pipeline import pipeline_mode

    world = args.num_processes
    name = "pagerank_vc" if args.vc and args.application == "pagerank" \
        else args.application
    for what, item, ok in (
            (f"the app {name!r} (across processes: "
             f"{', '.join(DIST_APP_NAMES)})", "8c", name in DIST_APP_NAMES),
            ("--delta_efile / --delta_vfile", "8b.4",
             not (args.delta_efile or args.delta_vfile)),
            ("vertex-cut storage (--vc, GRAPE_PARTITION=2d)", "8c",
             not (args.vc or partition_mode() == "2d")),
            ("GRAPE_PIPELINE=force (the pipelined round)", "8c",
             pipeline_mode() != "force")):
        decline_across_ranks(world, what, item, ok)


def run_app(args: QueryArgs, comm_spec: CommSpec | None = None) -> Worker:
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.utils import logging as glog

    # flag-consistency checks fail in milliseconds, before the load
    if (args.checkpoint_every or args.resume) and not args.checkpoint_dir:
        raise ValueError(
            "--checkpoint_every/--resume require --checkpoint_dir")
    if args.checkpoint_dir and not (args.checkpoint_every or args.resume):
        raise ValueError(
            "--checkpoint_dir requires --checkpoint_every (or --resume)")
    if args.num_processes and args.num_processes > 1:
        if args.process_id < 0 or not args.coordinator:
            raise ValueError(
                "--num_processes > 1 requires --coordinator and "
                "--process_id (every member of the gang names itself)"
            )
        if comm_spec is not None:
            raise ValueError(
                "pass EITHER a prebuilt comm_spec or the "
                "--coordinator/--num_processes/--process_id flags, "
                "not both"
            )
        check_across_processes(args)
        # before the partition probe and the load
        comm_spec = CommSpec.init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            fnum=args.fnum, device=args.device)
    if args.trace or args.metrics:
        # armed before the load, so the load_graph span is in the trace;
        # the flags win over GRAPE_TRACE / GRAPE_METRICS
        obs.configure(trace_path=args.trace or None,
                      metrics_path=args.metrics or None)
    name = args.application
    if args.vc and name == "pagerank":
        name = "pagerank_vc"  # reference run_app_vc.h:82-89
    if name not in APP_REGISTRY:
        raise ValueError(
            f"unknown application {name!r}; known: {sorted(APP_REGISTRY)}"
        )
    app_cls = APP_REGISTRY[name]
    app = app_cls(k=args.khop_k) if name == "khop" else app_cls()
    if comm_spec is None:
        comm_spec = CommSpec(fnum=args.fnum, device=args.device)
    weighted = getattr(app_cls, "needs_edata", False)
    spec = LoadGraphSpec(
        directed=args.directed,
        weighted=weighted,
        load_strategy=app_cls.load_strategy,
        partitioner_type=args.partitioner_type,
        idxer_type=args.idxer_type,
        rebalance=args.rebalance,
        rebalance_vertex_factor=args.rebalance_vertex_factor,
        string_id=args.string_id,
        serialize=args.serialize,
        deserialize=args.deserialize,
        serialization_prefix=args.serialization_prefix,
        edata_dtype=np.float64,
    )
    vc_inputs = None
    if not args.vc:
        name, app, vc_inputs = _resolve_partition(args, name, app, comm_spec,
                                                  weighted)
    from libgrape_lite_tpu_torch.utils.types import MessageStrategy

    is_vc = (APP_REGISTRY[name].message_strategy
             == MessageStrategy.kGatherScatter)
    if args.vc and not is_vc:
        raise ValueError(
            f"--vc has no vertex-cut implementation for {name!r} (the "
            "reference's --vc path supports pagerank only, "
            "run_app_vc.h:82-89)")
    if is_vc and (args.delta_efile or args.delta_vfile):
        raise ValueError("--delta_efile/--delta_vfile are not supported "
                         "with vertex-cut storage")
    if is_vc and args.string_id:
        raise ValueError(
            "--string_id is not supported with vertex-cut storage (the "
            "reference's VC fragment is specialized to uint64 oids, "
            "immutable_vertexcut_fragment.h)")
    if is_vc:
        frag = _load_vertexcut(args, name, comm_spec, weighted, vc_inputs)
    elif args.delta_efile or args.delta_vfile:
        from libgrape_lite_tpu_torch.fragment.mutation import (
            LoadGraphAndMutate,
        )

        frag = LoadGraphAndMutate(
            args.efile, args.vfile or None, args.delta_efile or None,
            args.delta_vfile or None, comm_spec, spec)
    else:
        frag = LoadGraph(args.efile, args.vfile or None, comm_spec, spec)
    if args.memory_stats:
        print(f"[memory] after load: {get_memory_stats(comm_spec.device)}")
    if name == "sssp_select":
        # the dense-vs-delta pick for this (graph, source), from a host
        # BFS probe over the CSRs the load just built
        from libgrape_lite_tpu_torch.models.sssp_select import (
            select_sssp_variant,
        )

        picked, reason = select_sssp_variant(
            frag, _coerce_source(args.sssp_source, args.string_id))
        _LOG.info("sssp_select -> %s: %s", picked, reason)
        app = APP_REGISTRY[picked]()
    worker = Worker(app, frag)
    if args.profile and glog.vlog_level() < 1:
        glog.set_vlog_level(1)  # --profile exists to show the round times
    guard = args.guard or None  # None: GRAPE_GUARD
    if args.resume:
        # the query args replay from the checkpoint's metadata (the
        # fingerprint holds them to this app and fragment); a cadence
        # flag overrides the recorded one
        worker.resume(args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every or None,
                      guard=guard)
    elif args.checkpoint_every:
        worker.query(checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir, guard=guard,
                     **build_query_kwargs(name, args))
    else:
        worker.query(guard=guard, **build_query_kwargs(name, args))
    if args.memory_stats:
        print(f"[memory] after query: {get_memory_stats(comm_spec.device)}")
    write = bool(args.out_prefix)
    if comm_spec.group is not None:
        # the result gather is a collective: every rank joins it when any
        # rank was given --out_prefix (only the coordinator writes)
        write = bool(host_allgather(np.array([int(write)])).max())
    if write and args.out_prefix:
        worker.output(args.out_prefix)
    elif write:
        worker.result_values()
    if obs.armed():
        # the worker flushes each query; this lands what came after
        flushed = obs.flush()
        if flushed["trace"]:
            glog.log_info(f"obs: trace -> {flushed['trace']} (JSONL twin "
                          f"{flushed['jsonl']}); open via "
                          "https://ui.perfetto.dev")
        if flushed["metrics"]:
            glog.log_info(f"obs: metrics -> {flushed['metrics']}.json / "
                          ".prom")
    return worker
