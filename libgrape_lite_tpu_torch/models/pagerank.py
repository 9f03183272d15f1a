"""PageRank -- LDBC variant with dangling-mass approximation.

Counterpart of `libgrape_lite_tpu/models/pagerank.py` (reference
`examples/analytical_apps/pagerank/pagerank.h:34-160`).  During iteration
the state holds rank/degree; each round pulls the in-neighbour sum and
applies

    base = (1-d)/n + d * dangling_sum / n
    next[v] = deg > 0 ? (d * sum + base) / deg : base
    dangling_sum' = base * total_dangling

and the last round multiplies the degree back in.

The pull is one SpMV over the in-edge CSR: the strict-tile kernel when
`plan_for_app` accepts a strict plan (or `spmv_mode="strict"`), the
gather-reduce kernel otherwise.  Both regroup the float sums relative to
the JAX package, so results agree to a tolerance, not bitwise.  Across
processes (world > 1) every pull runs over the rank's slab: K1 on its
[fl, vp + 1] CSR, or the strict tiles on its [fl, Ep] edges with the
slab's rows of the plan (tiles never cross a fragment, so each
fragment's sums are the one-process ones); the dangling mass folds
through `ctx.sum`, bit-equal to one process's fold.

Personalized PageRank (`source` given): the teleport and the dangling
mass land on the one-hot seed instead of spreading 1/n, as in the JAX
package.  A sequence of sources builds k personalized lanes (rank and
seed [k, fnum, vp], the scalars [k]) pulled by one `gather_reduce_lanes`
call a round -- or, under a strict plan, one strict-tile call a lane --
so each lane is bit-equal to its own query.  Global queries (no source)
keep the LDBC variant untouched and batch as per-lane states.

`GRAPE_EXCHANGE` (parallel/mirror.py) picks the exchange of the pull;
under a mirror plan K1 sums the same rows' edges in the same order over
the remapped columns, so the result is the gather's bit for bit.
`GRAPE_PIPELINE` declines here: a split moves K1's merge-path cuts and
regroups the float sums (parallel/pipeline.py), so the rounds stay
serial and the decline's reason is recorded.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import (
    BatchShuffleAppBase,
    StepContext,
    exchange_table,
    is_lane_sequence,
    local_frags,
    source_lane_array,
)
from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy


class PageRank(BatchShuffleAppBase):
    # kBothOutIn like pagerank_parallel.h:46: the pull reads incoming
    # edges, the normalisation uses the out-degree
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongOutgoingEdgeToOuterVertex
    need_split_edges = True
    result_format = "float"
    ephemeral_keys = frozenset({"spmv_row_lo"})
    replicated_keys = frozenset({"step", "dangling_sum", "total_dangling"})
    # dyn/: a fixed-round iteration has no fixed point to reuse, so an
    # incremental query is a counted cold run
    inc_mode = "restart"
    # serve/: personalized queries batch over their seeds
    batch_query_key = "source"
    lane_native = True
    k1_pull = "plain"  # ops/calibration.py: one K1 pull a round
    # parallel/pipeline.py: the exchanged leaf (a sum fold: declines)
    pipeline_state_key = "rank"
    # the round vote is the step counter's, the same on every rank
    replicated_vote = True

    def __init__(self, delta: float = 0.85, max_round: int = 10,
                 spmv_mode: str = "auto", dtype: torch.dtype = torch.float32):
        self.delta = delta
        self.max_round = max_round
        self.spmv_mode = spmv_mode
        self.dtype = dtype
        self._spmv_tile = self._spmv_rmax = 0
        self._const = {}
        self._personalized = False
        self._mx = None

    def init_state_batch(self, frag, args_list):
        """Seed lanes only when every lane carries a source; all-global
        lanes batch as per-lane states (the lane path would personalize
        them at vertex 0), and a mix cannot share one batch (JAX
        `PageRank.init_state_batch`)."""
        seeded = [a.get("source") is not None for a in args_list]
        if not any(seeded):
            return [self.init_state(frag, **a) for a in args_list]
        if not all(seeded):
            raise ValueError(
                "personalized (source given) and global PageRank lanes "
                "cannot share one batch -- their carries have different "
                "structure; batch them separately")
        return super().init_state_batch(frag, args_list)

    def init_state(self, frag, delta: float | None = None,
                   max_round: int | None = None, source=None):
        if delta is not None:
            self.delta = delta
        if max_round is not None:
            self.max_round = max_round
        dev, dt = frag.device, self.dtype
        batched = is_lane_sequence(source)
        sources = list(source) if batched else [source]
        self._personalized = any(s is not None for s in sources)
        lead = (len(sources),) if batched else ()
        fl, _ = local_frags(frag)
        state = {
            "rank": torch.zeros(lead + (fl, frag.vp), dtype=dt,
                                device=dev),
            "step": torch.zeros(lead, dtype=torch.int32, device=dev),
            "dangling_sum": torch.zeros(lead, dtype=dt, device=dev),
            "total_dangling": torch.zeros(lead, dtype=dt, device=dev),
        }
        if self._personalized:
            _, seed = source_lane_array(frag, sources, "PageRank", 0.0, 1.0,
                                        dt)
            state["seed"] = seed if batched else seed[0]
        # the plan covers the stack, tile rows per fragment: a rank
        # keeps its slab's rows
        plan = spmv.plan_for_app(frag, frag.vp, dt, mode=self.spmv_mode)
        self._spmv_tile = plan[1] if plan else 0
        self._spmv_rmax = plan[2] if plan else 0
        if plan:
            lo = local_frags(frag)[1]
            state["spmv_row_lo"] = torch.from_numpy(
                np.ascontiguousarray(plan[0][lo:lo + fl])).to(dev)
        self._mx = self.resolve_exchange(frag, state)
        self._pipeline = None
        if not batched:
            # a sum fold: records its decline (the strict tiles' or
            # K1's), never engages
            self.attach_pipeline(
                frag, state, app_name="PageRank", mirror=self._mx,
                fold="sum", eligible="spmv_row_lo" not in state,
                reason="strict-tile spmv plan engaged (tile partial "
                       "sums regroup under a split)")
        self.ephemeral_keys = type(self).ephemeral_keys | (
            frozenset() if self._mx is None else {"mx_send", "mx_nbr"})
        self._set_constants(frag.dev, dt)
        return state

    def _set_constants(self, dev, dt) -> None:
        """The round's constants, rounded to the state type once a query,
        as the JAX package rounds them with jnp.asarray.  Set in
        init_state, so a resumed query (no PEval) has them too."""
        n, d = dev.total_vnum, self.delta

        def c(v):
            return torch.tensor(v, dtype=dt, device=dev.out_degree.device)

        self._const = {"teleport": c((1.0 - d) / n), "d_over_n": c(d / n),
                       "d": c(d), "zero": c(0.0), "one_minus_d": c(1.0 - d)}

    def peval(self, ctx: StepContext, dev, state):
        dt = state["rank"].dtype
        deg = dev.out_degree
        dangling = dev.inner_mask & (deg == 0)
        n = dev.total_vnum

        def c(v):
            return torch.tensor(v, dtype=dt, device=deg.device)

        zero = self._const["zero"]
        vote = 1 if self.max_round > 0 else 0
        if self._personalized:
            # the one-hot seed s takes the uniform 1/n's place; the two
            # scalars become seed masses (the mass on dangling vertices)
            s = state["seed"]
            rank = torch.where(
                dev.inner_mask,
                torch.where(deg > 0, s / deg.clamp(min=1).to(dt), s), zero)

            def dangling_mass(sb):
                return ctx.sum(torch.where(dangling, sb, zero).sum(dim=-1))

            # each lane's mass summed alone, in its own query's order
            total_dangling = (torch.stack([dangling_mass(sb) for sb in s])
                              if s.dim() == 3 else dangling_mass(s))
            state = dict(state, rank=rank,
                         step=torch.zeros_like(state["step"]),
                         dangling_sum=total_dangling,
                         total_dangling=total_dangling)
            return state, torch.full_like(state["step"], vote)
        p = c(1.0 / n)
        rank = torch.where(
            dev.inner_mask,
            torch.where(deg > 0, p / deg.clamp(min=1).to(dt), p),
            zero,
        )
        total_dangling = ctx.sum(dangling.sum(dim=-1).to(dt))
        state = dict(
            state,
            rank=rank,
            step=torch.zeros((), dtype=torch.int32, device=deg.device),
            dangling_sum=p * total_dangling,
            total_dangling=total_dangling,
        )
        return state, vote

    def round_update(self, dev, state, cur):
        """One round given the in-neighbour rank sum `cur`
        (pagerank.h:102-156), including the final rank*deg assemble.
        Lane-stacked states carry their scalars as [k] vectors."""
        k = self._const
        dt = state["rank"].dtype
        step = state["step"] + 1
        if self._personalized:
            # teleport and dangling mass both land on the seed
            scal = k["one_minus_d"] + k["d"] * state["dangling_sum"]
            base = scal[..., None, None] * state["seed"]
            dangling_sum = scal * state["total_dangling"]
        else:
            base = k["teleport"] + k["d_over_n"] * state["dangling_sum"]
            dangling_sum = base * state["total_dangling"]
        deg = dev.out_degree
        nxt = torch.where(
            deg > 0, (k["d"] * cur + base) / deg.clamp(min=1).to(dt), base)
        nxt = torch.where(dev.inner_mask, nxt, k["zero"])
        is_last = step >= self.max_round
        finald = torch.where(deg > 0, nxt * deg.to(dt), nxt)
        new_state = dict(
            state,
            rank=torch.where(is_last[..., None, None], finald, nxt),
            step=step,
            dangling_sum=dangling_sum,
        )
        return new_state, torch.where(is_last, 0, 1)

    def inceval(self, ctx: StepContext, dev, state):
        # pull over incoming edges (pagerank_parallel.h:128-136)
        rank = state["rank"]
        ie = dev.ie
        full, nbr = exchange_table(ctx, rank, ie, state, self._mx)
        if "spmv_row_lo" in state:
            def strict(x):
                contrib = torch.where(ie.edge_mask, x[nbr],
                                      self._const["zero"])
                return spmv.spmv_strict(contrib, ie.edge_src,
                                        state["spmv_row_lo"], dev.vp,
                                        self._spmv_tile, self._spmv_rmax)

            # the tiles take one vector: a call a lane
            cur = (strict(full) if full.dim() == 1
                   else torch.stack([strict(x) for x in full]))
        else:
            cur = spmv.pull(ie.indptr, nbr, None, full, "sum")
        return self.round_update(dev, state, cur.to(rank.dtype))


    # PageRank is a probability distribution: within each round the
    # stored form is rank/deg (dangling vertices hold the raw base), so
    # the conserved quantity is sum(deg>0 ? rank*deg : rank) == 1; the
    # final round multiplies the degree back in, making it sum(rank).
    # The tolerance absorbs f32 sum error at RMAT-20 scale.
    mass_rtol = 1e-3

    def invariants(self, frag, state):
        from libgrape_lite_tpu_torch.guard.invariants import (
            Invariant, finite, in_range,
        )

        mr = self.max_round
        rtol = self.mass_rtol
        personalized = self._personalized

        def mass_parts(dev, prev, cur):
            """The slab's mass and seed mass (the whole carry's with one
            process)."""
            rank = cur["rank"]
            dt = rank.dtype
            deg = dev.out_degree.to(dt)
            iter_mass = torch.where(deg > 0, rank * deg, rank).sum()
            is_final = cur["step"] >= mr
            mass = torch.where(is_final, rank.sum(), iter_mass)
            # PPR conserves the seed mass (1 when the source resolves, 0
            # for an absent seed) instead of the global unit mass
            target = (cur["seed"].sum() if personalized
                      else torch.zeros((), dtype=dt, device=rank.device))
            return mass, target

        def mass_fn(dev, prev, cur):
            mass, target = mass_parts(dev, prev, cur)
            if not personalized:
                target = target + 1
            err = (mass - target).abs()
            return err <= rtol, err

        def mass_judge(sums):
            err = abs(sums[0] - (sums[1] if personalized else 1.0))
            return err <= rtol, err

        out = [finite("rank"), in_range("rank", lo=0.0)]
        if mr > 0:  # a 0-round query never leaves the rank/deg form
            requires = (("rank", "step", "seed") if personalized
                        else ("rank", "step"))
            out.append(Invariant(
                "pagerank_mass", mass_fn, requires,
                f"total probability mass conserved within {rtol:g}",
                partial=lambda dev, prev, cur: torch.stack(
                    mass_parts(dev, prev, cur)),
                judge=mass_judge,
            ))
        return out

    def finalize(self, frag, state):
        return np.asarray(state["rank"].cpu().numpy())
