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
"""

from __future__ import annotations

import argparse
import sys

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


def main(argv=None) -> int:
    ns = make_parser().parse_args(sys.argv[1:] if argv is None else argv)
    run_app(QueryArgs(**vars(ns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
