"""Incremental IncEval: seed a query from the previous fixed point.

Counterpart of `libgrape_lite_tpu/dyn/incremental.py`.  PIE's headline
capability (the GRAPE paper's IncEval is *specified*
for incremental recomputation after a graph change): instead of
recomputing a query from scratch on the mutated graph, re-activate
only what the delta touched.  In this dense pull-mode formulation
there is no explicit frontier array — re-activation means seeding the
superstep carry so that the very first rounds propagate only the
delta's effect:

    seeded = elementwise_min(fresh_init, migrate(prev_result))

For the monotone-min apps (SSSP/BFS/WCC — `AppBase.inc_mode ==
"monotone-min"`), this is EXACT for additive deltas, not a heuristic:

  * the previous fixed point's values are achievable in the mutated
    graph (additive deltas keep every old edge), so they are valid
    upper bounds — relaxation from them stays sound;
  * the superstep operator F' of the mutated graph is monotone and
    F'(seeded) <= seeded, so iteration decreases;
  * cold* <= seeded <= fresh_init pointwise, and iterating F' from
    fresh_init converges to cold* (that IS the cold query), so by
    monotonicity the seeded iterates are squeezed onto the same fixed
    point — byte-identical values, usually in a fraction of the
    rounds (the seeded run only pays the delta's propagation depth).

  (The min with fresh_init matters for WCC: migrated labels are the
  OLD representatives' ids, which need not be minimal in the new pid
  space — folding the fresh own-pid init back in restores the cold
  fixed point exactly.)

Non-additive deltas break the upper-bound property (a removed edge
can leave stale too-small values), and fixed-round sum iterations
(PageRank runs exactly `max_round` steps from a fixed init — there is
no fixed point to reuse at finite rounds) declare `inc_mode ==
"restart"`: `Worker.query_incremental` then runs the cold query
through the same API, counted in `Worker.inc_stats` — an honest
fallback, never a silent wrong answer.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """A state leaf as a host numpy array (tensors may sit on the card)."""
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def incremental_plan(app, delta) -> Tuple[str, str]:
    """("seeded" | "cold", reason) for this (app, delta) pair.

    `delta` is a DeltaBuffer / DeltaSummary (anything exposing
    `additive_only`); None means "unknown delta class", which must be
    treated as non-additive."""
    mode = getattr(app, "inc_mode", None)
    if mode is None:
        return "cold", (
            f"{type(app).__name__} declares no incremental contract"
        )
    if mode == "restart":
        return "cold", (
            f"{type(app).__name__} contract is 'restart' (fixed-round "
            "iteration has no reusable fixed point)"
        )
    if mode != "monotone-min":
        raise ValueError(
            f"unknown inc_mode {mode!r} on {type(app).__name__}"
        )
    if delta is None:
        return "cold", "no delta description (treated as non-additive)"
    if getattr(delta, "n_ops", 0) == 0:
        # an empty description is indistinguishable from a missing one
        # — notably DynGraph.summary() AFTER a repack cleared the
        # buffer; seeding on it would silently trust that NOTHING
        # changed, so treat it like no description at all
        return "cold", (
            "empty delta description (describe the ops that separate "
            "prev_result's graph from this one — e.g. the ingest "
            "report's 'delta' snapshot)"
        )
    if not getattr(delta, "additive_only", False):
        return "cold", (
            "non-additive delta (removals/updates/vertex ops) breaks "
            "the monotone upper-bound property"
        )
    if not app.inc_seed_keys:
        return "cold", (
            f"{type(app).__name__} declares monotone-min but no "
            "inc_seed_keys"
        )
    return "seeded", "additive delta under a monotone-min contract"


def migrate_rows(old_frag, new_frag, old_v: np.ndarray,
                 fresh_v: np.ndarray) -> np.ndarray:
    """Old per-vertex rows re-addressed into the new fragment's [fnum,
    vp] layout by oid, with fresh init values where no old row exists
    (new vertices, padding) — the host-side sparse extraction +
    assignment of arxiv 2509.20776, at single-host scale.  The row
    mapping is the same `oid_row_alignment` MutationContext state
    migration uses."""
    from libgrape_lite_tpu_torch.fragment.mutation import (
        oid_row_alignment,
    )

    out = np.array(fresh_v, copy=True)
    of, ol, nf, nl = oid_row_alignment(old_frag, new_frag)
    out[nf, nl] = old_v[of, ol]
    return out


def _fold_same_layout(frag, fresh, prev):
    """min(fresh, prev) on the real rows and fresh on the pad rows --
    what migrate_rows and the min give when every vertex keeps its row --
    on the carry's device when it is a tensor."""
    if isinstance(fresh, torch.Tensor):
        prev = torch.as_tensor(prev).to(fresh.device, fresh.dtype)
        return torch.where(frag.dev.inner_mask,
                           torch.minimum(fresh, prev), fresh)
    fresh_v = np.asarray(fresh)
    return np.where(frag.host_inner_mask(),
                    np.minimum(fresh_v, _host(prev).astype(fresh_v.dtype)),
                    fresh_v)


def reseed_fold(app, frag, fresh_state: Dict, prev_frag,
                prev_state: Dict) -> Dict:
    """The seeded carry overrides: per declared key, elementwise min of
    the fresh init and the (migrated, value-remapped) previous result.
    See the module docstring for why this is exact.  When every vertex
    kept its row (`same_layout`: the same fragment, or a repack of adds
    between known vertices) rows and pid values carry over as they are,
    and the min runs where the carry lives; otherwise rows migrate by
    oid on the host, values through `app.inc_value_map`."""
    from libgrape_lite_tpu_torch.fragment.mutation import same_layout

    in_place = same_layout(prev_frag, frag)
    out = {}
    for key, kind in app.inc_seed_keys.items():
        if kind != "min":
            raise ValueError(
                f"unsupported inc_seed fold {kind!r} for key {key!r}"
            )
        if key not in prev_state:
            raise KeyError(
                f"previous result has no {key!r} carry — "
                "query_incremental needs the state dict returned by "
                "the previous query of the SAME app and args"
            )
        if in_place:
            out[key] = _fold_same_layout(frag, fresh_state[key],
                                         prev_state[key])
            continue
        fresh_v = _host(fresh_state[key])
        prev_v = _host(prev_state[key])
        prev_v = app.inc_value_map(key, prev_v, prev_frag, frag)
        if prev_frag is frag and prev_v.shape == fresh_v.shape:
            mig = prev_v
        else:
            mig = migrate_rows(prev_frag, frag, prev_v, fresh_v)
        out[key] = np.minimum(fresh_v, mig.astype(fresh_v.dtype))
    return out
