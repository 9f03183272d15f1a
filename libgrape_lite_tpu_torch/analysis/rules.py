"""grape-lint rule catalogue for the PyTorch/CUDA package.

Counterpart of `libgrape_lite_tpu/analysis/rules.py`, under the same rule
ids, which findings, baselines and commit messages cite.  Each rule
fossilizes a defect class so that it cannot ship again; `summary` states
what the rule forbids in this package, `history` the incident behind the
JAX rule (as `libgrape_lite_tpu/analysis/rules.py` tells it) and, where
there is one, this package's own.

The catalogue holds the rules this package carries.  The AST rules live
in analysis/astlint.py, A3 in analysis/artifact.py.  Not carried:

* R1 baked-constant, R2 uncached-jit, R3 cache-key-field, A1
  constant-bloat, A2 donation -- nothing here is traced or lowered (no
  jit, no `torch.compile`, no CUDA-graph capture, no donated buffers);
  `Worker.query` is a Python loop over eager kernels.  A3's build
  events audit what R2 and R3 protected: no cache leaks a rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Rule:
    id: str
    slug: str
    summary: str   # what the rule forbids
    history: str   # the shipped bug it would have caught


RULES: Dict[str, Rule] = {
    r.id: r
    for r in [
        Rule(
            "R4", "dyn-view-parity",
            "a public query entrypoint of a class that defines "
            "_check_dyn_view (worker/worker.py) does not reach it and "
            "GuardConfig.resolve through self-calls, or a serving "
            "class's _dispatch does not reach _ensure_dyn_view "
            "(serve/session.py) -- an uncontracted app can silently "
            "compute on the pre-delta graph, or an env-armed guard is "
            "ignored",
            "JAX package (found in review): GUARDED query_batch ran the "
            "stale-view check after the guard routing, and "
            "query_stepwise skipped it entirely -- both silently "
            "served the pre-delta graph on a staged dyn view",
        ),
        Rule(
            "R5", "eager-log-bool-schema",
            "a level-gated vlog call (utils/logging.py) formats its "
            "message eagerly (f-string/%/.format/concat), or a numeric "
            "schema validator accepts bool through isinstance(x, int)",
            "JAX package: hot-loop f-strings were formatted-then-dropped "
            "at disabled vlog levels (measurable per round), and the "
            "bench schema checker accepted bools in numeric fields "
            "(bool is an int subclass)",
        ),
        Rule(
            "R6", "pipeline-window-read",
            "code between the exchange kickoff and the join of a "
            "pipelined superstep reads a query-carry key (or a carry "
            "alias bound before the kickoff, or -- position-"
            "independently -- inside a nested function capturing the "
            "carry) that is not named in the pipeline window contract "
            "(parallel/pipeline.PIPELINE_WINDOW_READS), or passes the "
            "whole carry dict to a callee not named in "
            "PIPELINE_WINDOW_CALLEES -- a side-stream kickoff aliasing "
            "the live carry reads torn state",
            "JAX package (preventive): the double-buffered pipeline "
            "exists because an in-flight exchange aliasing the live "
            "carry reads torn state; every window read is audited and "
            "named.  Here the kickoff runs on a second CUDA stream, so "
            "the same class is a stream race (zero-entry baseline)",
        ),
        Rule(
            "R7", "sync-in-pump",
            "a host-sync forcer (block_until_ready, device_get, "
            "np.asarray, .item()/.tolist(), int()/float() on a "
            "non-literal value, .cpu(), .numpy(), torch.cuda."
            "synchronize() or .synchronize() on an event or stream) is "
            "reached from serve/pipeline.py dispatch-stage code "
            "(_dispatch*/_fill* self-call chains) outside the audited "
            "harvest contract (serve/pipeline.PUMP_HARVEST_SYNCS) -- "
            "one stray sync re-serialises the whole dispatch window",
            "JAX package (preventive): the synchronous serve loop "
            "blocked pulling every lane's result to host before the "
            "next batch could dispatch -- the defect class the async "
            "pump removes (zero-entry baseline)",
        ),
        Rule(
            "R8", "unfederated-stats",
            "a module-level *_STATS surface is neither constructed as "
            "obs.federation.FederatedStats nor registered with "
            "obs.federation.register in its defining module -- "
            "the ledger is invisible to federation.snapshot(), the "
            "live /metrics exporter and every postmortem bundle",
            "JAX package: PLAN/SPGEMM/PARTITION/PIPELINE_STATS were "
            "hand-rolled module dicts and PUMP/FLEET_STATS ad-hoc "
            "classes; a scrape could not see them.  This package "
            "repeated it: PLAN_STATS, SPGEMM_STATS and "
            "GUARDED_BATCH_STATS were plain dicts, PARTITION_STATS and "
            "VC_TILE_STATS FederatedStats that skipped registration, "
            "and the rate profile registered nothing, so every "
            "snapshot, scrape and bundle lacked plan, spgemm, "
            "partition, vc_tiles and calibration (repaired with this "
            "rule's port; zero-entry baseline)",
        ),
        Rule(
            "R9", "cache-key-completeness",
            "a call into the autopilot result cache "
            "(autopilot/cache.py lookup()/store()) does not name "
            "every field of the result identity -- the compat key, "
            "the lane source and the fence epoch "
            "(cache.CACHE_KEY_FIELDS) -- so two structurally "
            "different queries (or two graph versions) could share "
            "one cached answer",
            "JAX package (preventive), after the R3 incident (a cache "
            "key missing max_rounds silently shared one compile).  "
            "This package's queue stored under a starred key, "
            "store(*meta, fence, res), which hid compat and source "
            "from the call site (spelled out with this rule's port)",
        ),
        Rule(
            "R10", "pinned-rate-constant",
            "a module-level numeric-literal pricing RATE (a *_BPS / "
            "*_HZ / *_CYC_PER_ELEM / *_PER_CYCLE constant or a "
            "GATHER_RATES table) is defined outside ops/calibration.py "
            "-- a private rate copy that the calibration fit cannot "
            "update and the drift gate cannot see",
            "JAX package: one MXU rate lived in both ops/spgemm_pack.py "
            "and scripts/pack_cost_model.py, and pipeline/partition "
            "carried their own copies -- five pricing surfaces, none "
            "fittable; collapsed onto the RateProfile (zero-entry "
            "baseline)",
        ),
        Rule(
            "R11", "raw-axis-name",
            "a models/ module spells a mesh axis name of the vertex cut "
            "as a raw string literal ('vcrow' / 'vccol') instead of "
            "importing VC_ROW_AXIS / VC_COL_AXIS from "
            "parallel/comm_spec.py -- a private copy of the grid "
            "contract that a rename (or a third axis) silently misses, "
            "turning an import error into a collective over the wrong "
            "row- or column-axis group at run time",
            "JAX package (preventive): the pipelined SUMMA round "
            "put the row-axis psum on the hot path of three apps at "
            "once.  Here the k x k rank grid (CommSpec.vc_grid) gives "
            "every row- and column-axis reduction of models/vc2d.py and "
            "pagerank_vc.py a process group named by these constants "
            "(zero-entry baseline)",
        ),
        Rule(
            "R12", "unkeyed-modeled-claim",
            "a decision/brief dict that carries a modeled overlap "
            "claim (a modeled_* or hidden_us* key) next to an "
            "`engaged` verdict does not also carry the correlation "
            "key (`plan_uid` or `trace_key`) -- the claim cannot be "
            "joined against measured device waits",
            "JAX package (preventive): every pipeline/2-D engagement "
            "headline was modeled, and the join hangs on the plan uid "
            "riding in the same record (zero-entry baseline; this "
            "package's partition records carry `engaged` and `costs` "
            "but no modeled_* key)",
        ),
        Rule(
            "A3", "surprise-compile",
            "a warmed query of the canonical matrix (sssp/bfs x "
            "fused/guarded/batched/incremental) loads a kernel "
            "library, builds a strict plan or fills a device cache -- "
            "a cache leaks a rebuild per query",
            "JAX package: a per-batch re-jit of the guarded batched "
            "PEval, then the stepwise/guarded runner and the guard "
            "probe were rebuilt per query.  Here the same intent is "
            "counted in build events (analysis/artifact.py) instead "
            "of XLA compiles",
        ),
    ]
}


def describe(rule_id: str) -> str:
    r = RULES[rule_id]
    return f"[{r.id} {r.slug}] {r.summary}"
