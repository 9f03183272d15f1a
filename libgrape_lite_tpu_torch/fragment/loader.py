"""Graph loading pipeline.

Counterpart of `libgrape_lite_tpu/fragment/loader.py::LoadGraph`
(reference `grape/fragment/loader.h:42-80`, `ev_fragment_loader.h`): read
the .v/.e files, build the vertex map (partitioner + idxer), group edges
by owner fragment and place the padded CSRs on the device.  There is no
serialization cache and no rebalancer in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.io.line_parser import (
    read_edge_file,
    read_vertex_file,
)
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.utils.types import LoadStrategy
from libgrape_lite_tpu_torch.vertex_map.partitioner import MapPartitioner
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap


@dataclass
class LoadGraphSpec:
    """Loading options (reference `LoadGraphSpec`)."""

    directed: bool = False
    weighted: bool = True
    load_strategy: LoadStrategy = LoadStrategy.kBothOutIn
    edata_dtype: type = np.float32


def LoadGraph(
    efile: str,
    vfile: str | None,
    comm_spec: CommSpec,
    spec: LoadGraphSpec | None = None,
) -> ShardedEdgecutFragment:
    """Entry point, mirroring `LoadGraph<FRAG_T>` (`loader.h:42-53`).
    The device is `comm_spec.device`."""
    spec = spec or LoadGraphSpec()
    src, dst, w = read_edge_file(efile, weighted=spec.weighted)
    if not spec.weighted:
        w = None
    if vfile:
        oids = read_vertex_file(vfile)
    else:
        # efile-only loading: the vertex universe is the set of endpoints
        oids = np.unique(np.concatenate([src, dst]))
    # the reference's defaults (flags.cc): map partitioner, hashmap idxer
    vm = VertexMap.build(oids, MapPartitioner(comm_spec.fnum, oids))
    return ShardedEdgecutFragment.build(
        comm_spec, vm, src, dst, w,
        directed=spec.directed,
        load_strategy=spec.load_strategy,
        edata_dtype=spec.edata_dtype,
    )
