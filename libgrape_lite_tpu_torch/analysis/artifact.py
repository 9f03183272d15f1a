"""grape-lint's run-time audit A3: a warmed query builds nothing.

Counterpart of `libgrape_lite_tpu/analysis/artifact.py`, A3 only.  The JAX
package counts XLA compiles on the live compile stream; this package traces
and lowers nothing (A1 and A2 have no artifact to scan), so a cache that
leaks shows as a rebuild instead.  `build_events()` counts three:

* kernel library loads (`ops/_build.py::LOAD_EVENTS`: an nvcc build or a
  `ctypes` load of `csrc/<name>.cu`'s library);
* strict plans (`ops/spmv.py::PLAN_STATS["planned"]`);
* device-cache fills (`fragment/edgecut.py::DEVICE_CACHE_FILLS`: a push
  CSR or `dest_degree` built on a miss).

The first two are `worker/worker.py::build_counts`, which the tracer's
`compiled` mark reads too.

`warm_matrix_audit` runs the JAX matrix (sssp / bfs x fused / guarded /
batched / incremental, sources 0 and 1) once to warm, then again with
each cell under `build_events()`, and pins zero.  `run_artifact_audit`
runs it on `device="cuda"` unless the caller asks for the CPU.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

from libgrape_lite_tpu_torch.analysis.report import Finding

#: what `build_events()` counts, in report order
BUILD_KINDS = ("library_loads", "plans", "device_caches")


def _build_counters() -> Dict[str, int]:
    from libgrape_lite_tpu_torch.fragment import edgecut
    from libgrape_lite_tpu_torch.worker.worker import build_counts

    return {**build_counts(), "device_caches": edgecut.DEVICE_CACHE_FILLS}


class BuildEvents:
    """What a `build_events()` block built, by kind (`events`); `builds`
    is their sum."""

    def __init__(self):
        self.events: Dict[str, int] = dict.fromkeys(BUILD_KINDS, 0)

    @property
    def builds(self) -> int:
        return sum(self.events.values())


@contextmanager
def build_events():
    """Count the rebuilds inside the block::

        with build_events() as ev:
            worker.query(source=0)      # warmed: expect ev.builds == 0

    The counters are process-wide, so a build by another thread during
    the block counts too."""
    rec = BuildEvents()
    before = _build_counters()
    try:
        yield rec
    finally:
        after = _build_counters()
        rec.events = {k: after[k] - before[k] for k in BUILD_KINDS}


# ---------------------------------------------------------------------------
# A3 -- the canonical warm query matrix under the build counters
# ---------------------------------------------------------------------------

MATRIX_APPS = ("sssp", "bfs")
MATRIX_MODES = ("fused", "guarded", "batched", "incremental")


def _additive_delta():
    """A minimal additive delta description: enough for
    `Worker.query_incremental` to take the seeded path (the audit does
    not mutate the graph)."""
    from libgrape_lite_tpu_torch.dyn.delta import DeltaBuffer

    buf = DeltaBuffer(capacity=4)
    buf.stage([("a", 0, 1, 1.0)])
    return buf.summary()


def _run_cell(worker, mode: str, sources):
    if mode == "fused":
        worker.query(source=sources[0])
    elif mode == "guarded":
        worker.query(source=sources[0], guard="halt")
    elif mode == "batched":
        worker.query_batch([{"source": s} for s in sources])
    elif mode == "incremental":
        prev = worker.query(source=sources[0])
        worker.query_incremental(prev, delta=_additive_delta(),
                                 source=sources[0])
    else:
        raise ValueError(f"unknown matrix mode {mode!r}")


def warm_matrix_audit(frag, apps=MATRIX_APPS, modes=MATRIX_MODES,
                      sources=(0, 1)):
    """A3: run every (app, mode) cell once to warm, then each again under
    `build_events()` and pin zero builds.  Returns (findings, info);
    info["cells"] carries each cell's build events for the report."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY
    from libgrape_lite_tpu_torch.worker.worker import Worker

    workers = {a: Worker(APP_REGISTRY[a](), frag) for a in apps}
    for a in apps:
        for mode in modes:
            _run_cell(workers[a], mode, sources)

    findings: List[Finding] = []
    cells = []
    total = 0
    for a in apps:
        for mode in modes:
            with build_events() as ev:
                _run_cell(workers[a], mode, sources)
            cells.append({"app": a, "mode": mode, "builds": ev.builds,
                          "events": dict(ev.events)})
            total += ev.builds
            if ev.builds:
                what = ", ".join(f"{n} {k}" for k, n in ev.events.items()
                                 if n)
                findings.append(Finding(
                    "A3", f"<warm:{a}>", 0, f"{a}.{mode}",
                    f"warmed {mode} query built {ev.builds} artifact(s) "
                    f"({what}) — a library, plan, worker or device "
                    "cache is leaking",
                ))
    info = {
        "cells": cells,
        "unexpected_builds": total,
        "apps": list(apps),
        "modes": list(modes),
        "device": str(frag.device),
    }
    return findings, info


def _default_fragment(n: int = 400, e: int = 3200, fnum: int = 1,
                      device="cuda"):
    """The JAX audit's graph: a small weighted random graph (seed 8,
    undirected, weights uniform(0.5, 2.0)), audited in seconds."""
    import numpy as np

    from libgrape_lite_tpu_torch.fragment.edgecut import (
        ShardedEdgecutFragment,
    )
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        MapPartitioner,
    )
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    rng = np.random.default_rng(8)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.uniform(0.5, 2.0, e).astype(np.float32)
    oids = np.arange(n, dtype=np.int64)
    vm = VertexMap.build(oids, MapPartitioner(fnum, oids))
    return ShardedEdgecutFragment.build(
        CommSpec(fnum=fnum, device=device), vm, src, dst, w, directed=False,
    )


def run_artifact_audit(frag=None, *, device="cuda", apps=MATRIX_APPS,
                       modes=MATRIX_MODES):
    """A3 as (findings, report block).  `frag=None` builds the small
    canonical fragment on `device`; pass a loaded fragment to audit a
    real geometry."""
    if frag is None:
        frag = _default_fragment(device=device)
    findings, matrix = warm_matrix_audit(frag, apps=apps, modes=modes)
    report = {
        "findings": [f.to_dict(False) for f in findings],
        "build_audit": matrix,
    }
    return findings, report
