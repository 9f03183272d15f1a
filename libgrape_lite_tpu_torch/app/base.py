"""App-framework API: the PIE model on stacked fragments.

Counterpart of `libgrape_lite_tpu/app/base.py` (reference `grape/app/*`).
An app provides

  * `init_state(frag, **query_args)` -- host side: the initial state, a
    dict of numpy arrays or tensors stacked `[fnum, ...]`;
  * `peval(ctx, dev, state) -> (state, active)` -- the first superstep;
  * `inceval(ctx, dev, state) -> (state, active)` -- repeated while the
    active vote is positive and the round limit is not reached;
  * `finalize(frag, state) -> np.ndarray [fnum, vp]`.

`dev` is the fragment's `DeviceFragment`; all fragments sit stacked on
one device, so the JAX package's per-shard collectives become operations
over the leading axis (`StepContext`).

Vertex-cut apps (`mesh_kind = "vc2d"`, models/vc2d.py and
models/pagerank_vc.py) run on the k x k tiles of an
ImmutableVertexcutFragment with a `VCStepContext`: their per-tile
partials come stacked [k, k, vc] (tile (i, j) at [i, j]), and the
context's row- and column-axis reductions and `vc_transpose` stand for
the JAX package's pmin / psum over the SUMMA mesh's axes and its
ppermute.

Batched source lanes (serve/, `Worker.query_batch`): an app that names
its per-lane query argument in `batch_query_key` takes a sequence of k
values for it in `init_state` and returns carry leaves with a leading
[k] lane axis; its `peval` / `inceval` then run all k lanes at once (one
`spmv.pull` over lane-stacked x a round) and vote a [k] tensor.  The
JAX package runs one lane's superstep under `jax.vmap` instead.  Every
other app batches through `init_state_batch`'s per-lane states.
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet

import numpy as np
import torch

from libgrape_lite_tpu_torch.ops import spmv
from libgrape_lite_tpu_torch.parallel.comm_spec import (
    VC_COL_AXIS,
    VC_ROW_AXIS,
)
from libgrape_lite_tpu_torch.parallel.communicator import Communicator
from libgrape_lite_tpu_torch.parallel.mirror import resolve_mirror_plan
from libgrape_lite_tpu_torch.parallel.pipeline import resolve_pipeline
from libgrape_lite_tpu_torch.parallel.message_manager import (
    AutoParallelMessageManager,
)
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_LOG = logging.getLogger(__name__)


class _ctxmethod:
    """A StepContext method that reads the context's process group.  Read
    off the class (`StepContext.gather_state(x)`), it binds to the
    single-process context, whose collectives fold the stacked axis on
    one device."""

    def __init__(self, fn):
        self.fn = fn
        self.__doc__ = fn.__doc__

    def __get__(self, obj, cls=None):
        if obj is None:
            obj = _local_context()
        return self.fn.__get__(obj, type(obj))


_LOCAL_CTX = None


def _local_context() -> "StepContext":
    global _LOCAL_CTX
    if _LOCAL_CTX is None:
        _LOCAL_CTX = StepContext()
    return _LOCAL_CTX


class StepContext(Communicator):
    """Per-superstep toolkit.  Per-fragment values carry the stacked
    `[fnum, ...]` axis first (a rank's `[fl, ...]` slab under a process
    group); the collectives of `Communicator` act on it (the JAX
    package's psum / pmin / pmax / all_gather / all_to_all over the
    fragment mesh axis)."""

    @_ctxmethod
    def gather_state(self, x: torch.Tensor) -> torch.Tensor:
        """[fnum, vp, ...] -> the full pid-indexed [fnum * vp, ...]; a
        rank's [fl, vp, ...] slab joins the others' in one all_gather."""
        if self.spec is not None:
            x = self._gather_frags(x)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    @_ctxmethod
    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """[fnum, vp] -> [fnum * vp]; lane-stacked [k, fnum, vp] -> the
        lanes' full vectors [k, fnum * vp]."""
        if self.spec is not None:
            if x.dim() == 2:
                x = self._gather_frags(x)
            else:  # the fragment axis first for the gather, then back
                x = self._gather_frags(x.movedim(-2, 0)).movedim(0, -2)
        return x.reshape(tuple(x.shape[:-2]) + (-1,))

    @_ctxmethod
    def mirror_recv(self, x_local: torch.Tensor, send_idx: torch.Tensor,
                    async_op: bool = False):
        """The remote half of `exchange_mirrors`: [..., fnum, vp] state
        and the [fnum (sender), fnum (receiver), m] send table ->
        [..., fnum, fnum * m], fragment f's received rows in sender
        order.  One gather x[g][send_idx[g]] and one all-to-all (the
        transpose of the send block on one card).  Under a process group
        the state and the table's sender rows are the rank's slab, and
        the all-to-all crosses ranks; `async_op` then returns (the
        output, its `comm_spec.Pending`), the output filled by `wait`."""
        nsend = send_idx.shape[0]
        sender = torch.arange(nsend, device=x_local.device).view(nsend, 1, 1)
        vals = x_local[..., sender, send_idx]  # [..., g, f, m]
        if self.spec is None:
            recv = vals.transpose(-3, -2)  # all_to_all: [..., f, g, m]
            return recv.reshape(tuple(recv.shape[:-2]) + (-1,))

        def arrange(recv):
            # [p, f, ..., g, m]: the sender ranks' blocks join the local
            # sender axis in fragment order
            recv = recv.movedim(0, -3).flatten(-3, -2).movedim(0, -3)
            return recv.reshape(tuple(recv.shape[:-2]) + (-1,))

        # receivers first, grouped by rank: [world, fl (f), ..., fl (g), m]
        v = vals.movedim(-2, 0).unflatten(0, (self.spec.world, -1))
        if not async_op:
            return arrange(self.spec.all_to_all_single(v))
        out = torch.empty(arrange(torch.empty(v.shape, device="meta")).shape,
                          dtype=v.dtype, device=v.device)
        pend = self.spec.all_to_all_single(
            v, async_op=True, then=lambda recv: out.copy_(arrange(recv)))
        return out, pend

    @_ctxmethod
    def exchange_mirrors(self, x_local: torch.Tensor,
                         send_idx: torch.Tensor) -> torch.Tensor:
        """Mirror-compressed form of `gather_state` (JAX
        `StepContext.exchange_mirrors`, reference
        `batch_shuffle_message_manager.h:237-264`): fragment f's compact
        table [vp local | g0 mirrors | g1 mirrors | ...], stacked
        [..., fnum, vp + fnum * m], addressed by the plan's
        `nbr_compact` (parallel/mirror.py).  Leading lane axes pass
        through."""
        return torch.cat([x_local, self.mirror_recv(x_local, send_idx)],
                         dim=-1)

    def vote(self, active, replicated: bool = False):
        """The round's termination vote across ranks: a rank's active
        count all-reduced as an exact int64 SUM, or a `replicated` vote
        (the same on every rank) as MAX.  A vote given as a Python int
        is a constant of the query, the same on every rank, and stays on
        the host.  Single-process the vote is returned as it is; the
        worker's read of it is the round's one host sync."""
        if self.spec is None or not isinstance(active, torch.Tensor):
            return active
        t = active.to(torch.int64).reshape(1)
        return self.spec.all_reduce(t, "max" if replicated else "sum")[0]


class VCStepContext(StepContext):
    """The 2-D superstep toolkit over the k x k tiles (JAX
    `models/vc2d.py` over the SUMMA mesh).  A per-tile value is a [...,
    nr, nc, vc] tensor over the tile rows and columns this context holds
    (all k of each with one process), tile (i, j) at [i - r_lo, j -
    c_lo]: row i is the src chunk, column j the dst chunk.  Reducing over
    the row axis folds the tiles of one column (JAX's pmin / psum over
    `VC_ROW_AXIS`), which completes dst chunk j; over the column axis,
    the tiles of one row (`VC_COL_AXIS`), src chunk i.  They leave [...,
    nc, vc] and [..., nr, vc], indexed by the chunk they completed.  The
    master carry is chunk-indexed by tile row ([..., nr * vc], the JAX
    package's P(vcrow) layout); `cols_to_rows` re-aligns a completed
    column reduction to it and `rows_to_cols` gives the column copy a
    src-side pull reads (both the identity with one process), and
    `vc_transpose` swaps a per-tile value's tiles ((i, j) -> (j, i), JAX's
    ppermute).  Leading lane axes pass through.

    Given a CommSpec with a process group (`spec`), the rank holds its
    slab of the grid (`CommSpec.vc_grid`): each reduction folds the local
    tiles, then runs over the rank's row- or column-axis group
    (`CommSpec.axis_reduce`), the re-alignments are tile transposes
    (`CommSpec.vc_transpose`), and `count_rows` sums a vote over the row
    axis, whose ranks hold every tile row once.  No collective moves the
    tile stack."""

    def __init__(self, k: int, spec=None):
        super().__init__(k * k, spec=spec)
        self.k = k
        self.grid = spec.vc_grid(k) if self.spec is not None else None

    @property
    def nr(self) -> int:
        return self.k if self.grid is None else self.grid.nr

    @property
    def nc(self) -> int:
        return self.k if self.grid is None else self.grid.nc

    def tiles(self, y: torch.Tensor) -> torch.Tensor:
        """K1's [..., 1, fl * vc] output as [..., nr, nc, vc]."""
        return y.reshape(tuple(y.shape[:-2]) + (self.nr, self.nc, -1))

    def _across(self, y: torch.Tensor, axis: str, op: str,
                async_op: bool = False):
        if self.spec is None:
            return y
        return self.spec.axis_reduce(y, self.k, axis, op, async_op)

    def row_min(self, x: torch.Tensor, async_op: bool = False):
        """`async_op` (a process group only) returns the Pending of the
        group's reduction (the pipelined round's kickoff)."""
        return self._across(x.amin(dim=-3), VC_ROW_AXIS, "min", async_op)

    def col_min(self, x: torch.Tensor) -> torch.Tensor:
        return self._across(x.amin(dim=-2), VC_COL_AXIS, "min")

    def row_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._across(x.sum(dim=-3), VC_ROW_AXIS, "sum")

    def col_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._across(x.sum(dim=-2), VC_COL_AXIS, "sum")

    def vc_transpose(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec is None:
            return x.transpose(-3, -2)
        blocks = x.flatten(-3, -2).movedim(-2, 0)  # [fl, ..., vc]
        out = self.spec.vc_transpose(blocks.contiguous(), self.k)
        return out.movedim(0, -2).unflatten(-2, (self.nr, self.nc))

    def cols_to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[..., nc, vc] completed column chunks -> [..., nr, vc], the
        chunks of this rank's tile rows: a local pick when the rank holds
        every column, else one tile transpose (tile (i, j) takes the
        chunk i that tile (j, i) completed)."""
        if self.spec is None or self.nc == self.k:
            g = self.grid
            return x if g is None else x[..., g.r_lo:g.r_lo + g.nr, :]
        per_tile = x.unsqueeze(-3).expand(
            tuple(x.shape[:-2]) + (self.nr,) + tuple(x.shape[-2:]))
        return self.vc_transpose(per_tile)[..., :, 0, :]

    def rows_to_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[..., nr, vc] row chunks -> [..., nc, vc], the chunks of this
        rank's tile columns (the column copy a src-side pull reads): one
        tile transpose, the identity when the rank holds every row."""
        if self.spec is None or self.nr == self.k:
            return x
        per_tile = x.unsqueeze(-2).expand(
            tuple(x.shape[:-1]) + (self.nc, x.shape[-1]))
        return self.vc_transpose(per_tile)[..., 0, :, :]

    def chunks(self, x: torch.Tensor) -> torch.Tensor:
        """The [..., n * vc] chunk layout as [..., n, vc] (n = nr)."""
        return x.unflatten(-1, (self.nr, -1))

    @staticmethod
    def flat(x: torch.Tensor) -> torch.Tensor:
        """[..., n, vc] chunk-indexed -> the [..., n * vc] gpid layout."""
        return x.reshape(tuple(x.shape[:-2]) + (-1,))

    def count_rows(self, mask: torch.Tensor) -> torch.Tensor:
        """A [..., nr * vc] mask's true count over every vertex once: the
        row-axis group's ranks hold each tile row once."""
        return self._across(mask.sum(dim=-1), VC_ROW_AXIS, "sum")

    def vote(self, active, replicated: bool = False):
        """A vertex-cut vote is the same on every rank already (a
        `count_rows` or a round constant): no collective."""
        return active


def make_context(app, frag) -> StepContext:
    """The superstep context of `app` on `frag`: the 2-D one for a
    vertex-cut app, else the fragment stack's, over the process group of
    the fragment's CommSpec when it has one."""
    if getattr(app, "mesh_kind", "frag") == "vc2d":
        return VCStepContext(frag.k, spec=frag.comm_spec)
    return StepContext(frag.fnum, spec=getattr(frag, "comm_spec", None))


def exchange_table(ctx: StepContext, x: torch.Tensor, csr, state: Dict,
                   mirror, prefix: str = "mx_"):
    """(table, columns) of a K1 pull over `csr`: the gathered state and
    the CSR's pid columns, or under a mirror plan (parallel/mirror.py)
    the flattened compact tables and the plan's remapped columns
    (`<prefix>send`, `<prefix>nbr` in `state`).  Lane-stacked x gives
    [k, ...] tables over the same columns."""
    if mirror is None:
        return ctx.gather_lanes(x), csr.edge_nbr
    # the compact tables stay where they are: each fragment's own table
    # already holds every row its edges read (a local flatten, no gather)
    table = ctx.exchange_mirrors(x, state[prefix + "send"])
    return (table.reshape(tuple(table.shape[:-2]) + (-1,)),
            state[prefix + "nbr"])


def resolve_source(frag, source, app_name: str) -> int:
    """oid -> pid for a query source; logs when the oid is absent."""
    pid = int(frag.oid_to_pid(np.array([source]))[0])
    if pid < 0:
        _LOG.warning("%s: source %r is not in the vertex map; all "
                     "vertices will be unreachable", app_name, source)
    return pid


def local_frags(frag) -> tuple:
    """(fl, fid_lo): the fragments whose state this process holds --
    every fragment single-process, the rank's slab under a group."""
    return getattr(frag, "fl", frag.fnum), getattr(frag, "fid_lo", 0)


def is_lane_sequence(source) -> bool:
    """True for a batched query's sequence of lane values."""
    return isinstance(source, (list, tuple, np.ndarray))


def source_lane_array(frag, source, app_name: str, fill, hit,
                      dtype: torch.dtype):
    """(batched, arr): the source-vector contract's shared scaffolding
    (JAX `app/base.py::source_lane_array`).  `source` is one query id or
    a sequence of k lane ids; `arr` is [k, fnum, vp] on the fragment's
    device, `hit` at each resolved source and `fill` elsewhere -- SSSP's
    distances (inf / 0), BFS's depths (sentinel / 0), personalized
    PageRank's teleport vector (0 / 1).  An absent or None source leaves
    its lane all `fill`.  Under a process group the array is the rank's
    [k, fl, vp] slab: every rank resolves the source on its host twins,
    and only the rank that owns its fragment sets the hit."""
    batched = is_lane_sequence(source)
    sources = list(source) if batched else [source]
    fl, lo = local_frags(frag)
    arr = torch.full((len(sources), fl, frag.vp), fill, dtype=dtype,
                     device=frag.device)
    pids = [resolve_source(frag, s, app_name) if s is not None else -1
            for s in sources]
    lanes = [b for b, pid in enumerate(pids)
             if pid >= 0 and lo <= pid // frag.vp < lo + fl]
    if lanes:
        hits = np.array([pids[b] for b in lanes], dtype=np.int64)
        idx = (torch.tensor(lanes), torch.from_numpy(hits // frag.vp - lo),
               torch.from_numpy(hits % frag.vp))
        arr[tuple(i.to(frag.device) for i in idx)] = hit
    return batched, arr


class AppBase:
    # trait parity (parallel_app_base.h:42-46)
    load_strategy: LoadStrategy = LoadStrategy.kBothOutIn
    message_strategy: MessageStrategy = MessageStrategy.kSyncOnOuterVertex
    need_split_edges: bool = False

    # state keys that are read-only inputs of every round rather than
    # loop state; the worker leaves them out of the result state
    ephemeral_keys: FrozenSet[str] = frozenset()

    # state keys that are whole-graph scalars or tables rather than
    # [fnum, vp, ...] rows; a mutation carries them over as they are
    replicated_keys: FrozenSet[str] = frozenset()

    # the mesh the superstep runs on: "frag" (the fragment stack) or
    # "vc2d" (the k x k tiles of a vertex-cut fragment, VCStepContext)
    mesh_kind: str = "frag"

    # serve/: the query argument that varies per lane of a batched
    # query (e.g. "source"); queries differing in nothing else coalesce.
    # With `lane_native`, `init_state` also takes a sequence of k values
    # for it and returns carry leaves with a leading [k] lane axis
    # (ephemeral leaves built once, shared), and `peval` / `inceval` run
    # the lanes together and vote a [k] tensor.
    # None: such queries never share a batch.
    batch_query_key: str | None = None
    # serve/: True when init_state takes the vector argument and
    # peval / inceval run lane-stacked states (the native lanes above);
    # a batch of an app without them runs per-lane states
    lane_native: bool = False

    # ops/calibration.py: the K1 pull a round of this app, as the rate
    # harvest counts it -- "plain" (x only) or "weighted" (x and the edge
    # weights) over the fragment's in-CSR; None when a round is not one
    # such pull (no harvest)
    k1_pull: str | None = None

    # dyn/: True when the app folds a fragment's staged delta-edge
    # overlay (frag.dyn_overlay) into its pull reduction -- sound only
    # for min folds, where extra candidates merge exactly.  Apps without
    # the contract must not run while an overlay holds staged edges
    # (they would see the stale graph); Worker.query enforces this.
    dyn_overlay_support: bool = False

    # dyn/: the incremental-IncEval contract (dyn/incremental.py):
    #   None            -- no contract; query_incremental runs cold
    #   "monotone-min"  -- an additive delta reuses the previous fixed
    #                      point: seeded = min(fresh init, migrated prev)
    #                      per key of `inc_seed_keys`, equal to a cold
    #                      run on the mutated graph
    #   "restart"       -- declared, but the iteration has no reusable
    #                      fixed point (fixed-round PageRank): cold, counted
    inc_mode: str | None = None
    inc_seed_keys: Dict[str, str] = {}

    def inc_value_map(self, key: str, values: np.ndarray, old_frag,
                      new_frag) -> np.ndarray:
        """Remap carry values across a repack (rows migrate by oid in
        the framework; values are the app's).  Identity by default,
        right for distances and depths; WCC re-addresses its pid labels."""
        return values

    # ---- superstep pipelining (parallel/pipeline.py) ----
    #
    # An app whose round is "exchange -> pull -> fold" can run pipelined:
    # the boundary pull, the kickoff of the next round's exchange on a
    # side stream, the interior pull overlapping it, the join.
    # `init_state` resolves the plan (resolve_pipeline: the env gate, the
    # byte threshold, the app's eligibility) into `self._pipeline` and
    # merges its split CSRs into the ephemeral state; the worker then
    # runs `inceval_pipelined` instead of `inceval`.  The serial
    # `inceval` stays as it is: batched, incremental and dyn queries
    # keep it, and the two rounds are bit-equal (the tests hold this).
    pipeline_state_key: str | None = None  # the exchanged carry leaf
    _pipeline = None                       # the resolved plan or None

    def _exchange_off(self, frag) -> bool:
        """No exchange plan: an auto twin (no pull) or an attached dyn
        overlay (its columns index the pid-addressed gather)."""
        return (self.pipeline_state_key is None
                or getattr(frag, "dyn_overlay", None) is not None)

    def resolve_exchange(self, frag, state: Dict, direction: str = "ie",
                         prefix: str = "mx_"):
        """The mirror plan of one pull (parallel/mirror.py::
        resolve_mirror_plan), its send table and remapped columns merged
        into `state` under `prefix`; None for the gather."""
        if self._exchange_off(frag):
            return None
        mx = resolve_mirror_plan(frag, direction)
        if mx is not None:
            state.update(mx.state_entries(prefix, frag, direction))
        return mx

    def attach_pipeline(self, frag, state: Dict, **kw) -> None:
        """Resolve the pull's pipeline into `self._pipeline`
        (parallel/pipeline.py::resolve_pipeline, `kw` its arguments, the
        exchanged leaf `pipeline_state_key`) and merge its split CSRs
        into `state`."""
        self._pipeline = None
        if self._exchange_off(frag):
            return
        self._pipeline = resolve_pipeline(
            frag, key=self.pipeline_state_key, **kw)
        if self._pipeline is not None:
            state.update(self._pipeline.host_entries)

    def pipeline_exchange(self, ctx: StepContext, dev, state):
        """The exchange buffer of the next round's pull, built from the
        current carry (the worker calls it after PEval and whenever the
        carry is rewritten: the buffer is a pure function of the
        carry, so the rebuilt one is bitwise the one in flight)."""
        return self._pipeline.exchange(ctx, state[self.pipeline_state_key],
                                       state)

    def inceval_pipelined(self, ctx: StepContext, dev, state, xbuf):
        """One pipelined superstep: (state', active, xbuf'), bit-equal to
        `inceval`.  Called only when `self._pipeline` resolved; the
        reads after the kickoff are audited against parallel/pipeline.
        PIPELINE_WINDOW_READS by grape-lint R6."""
        raise NotImplementedError(
            f"{type(self).__name__} resolved a pipeline plan but "
            "implements no inceval_pipelined")

    def pipelined_min_round(self, ctx: StepContext, state, xbuf,
                            post=None):
        """The pipelined round of one K1 min pull over the split CSRs
        (SSSP, BFS, undirected WCC): the boundary rows' relax, the
        exchange kickoff from the boundary-merged carry, the interior
        rows' relax overlapping it, the join.  `post` maps a pull's
        result before the min (BFS's +1).  Each row folds its own edges
        in their order, so (new, improved = new < old, xbuf') is
        bit-equal to the serial round's."""
        pl = self._pipeline
        x = state[self.pipeline_state_key]
        bmask = state["pl_bmask"]
        full = pl.splice(x, xbuf)
        rel_b = spmv.gather_reduce(
            state["pl_b_indptr"], state["pl_b_nbr"],
            state["pl_b_w"] if "pl_b_w" in state else None, full, "min")
        new_b = torch.minimum(x, rel_b if post is None else post(rel_b))
        xbuf2 = pl.kickoff(ctx, torch.where(bmask, new_b, x), state)
        # ---- pipelined window: every carry read below is named in
        # parallel/pipeline.PIPELINE_WINDOW_READS (grape-lint R6) ----
        rel_i = spmv.gather_reduce(
            state["pl_i_indptr"], state["pl_i_nbr"],
            state["pl_i_w"] if "pl_i_w" in state else None, full, "min")
        new = torch.where(bmask, new_b, torch.minimum(
            x, rel_i if post is None else post(rel_i)))
        pl.join()
        return new, new < x, xbuf2

    # 0 means "run until the termination vote fires"
    max_rounds: int = 0

    # output formatting: float | int | sssp_infinity
    result_format: str = "float"

    def init_state(self, frag, **query_args) -> Dict:
        raise NotImplementedError

    def init_state_batch(self, frag, args_list):
        """Initial state for k query lanes (serve/, JAX
        `AppBase.init_state_batch`): an app with a `batch_query_key` and
        lanes whose other arguments agree gets ONE lane-stacked state
        from one `init_state` call with the vector argument (a dict);
        every other batch gets a list of k per-lane states, each run
        by the worker through the single-lane supersteps."""
        key = self.batch_query_key
        if key is not None and self.lane_native:
            fixed = {k: v for k, v in args_list[0].items() if k != key}
            if all({k: v for k, v in a.items() if k != key} == fixed
                   for a in args_list[1:]):
                return self.init_state(
                    frag, **fixed,
                    **{key: [a.get(key, 0) for a in args_list]})
        return [self.init_state(frag, **a) for a in args_list]

    def peval(self, ctx: StepContext, dev, state: Dict):
        raise NotImplementedError

    def inceval(self, ctx: StepContext, dev, state: Dict):
        raise NotImplementedError

    def finalize(self, frag, state: Dict) -> np.ndarray:
        raise NotImplementedError

    # ---- runtime invariants (guard/) ----
    #
    # Named predicates over consecutive carries, evaluated on the carry's
    # device by the guard monitor when GRAPE_GUARD (or
    # Worker.query(guard=...)) arms it.  The default is the generic floor
    # (NaN-free float carries); apps override to declare their algebraic
    # invariants (monotone distances, conserved mass, label ranges).
    # `state` is the example carry, to read dtypes and keys from.

    def invariants(self, frag, state: Dict) -> list:
        from libgrape_lite_tpu_torch.guard.invariants import (
            default_invariants,
        )

        return default_invariants(self, frag, state)

    # ---- MutationContext (reference grape/app/mutation_context.h) ----
    #
    # An app that mutates the graph mid-query defines
    # `collect_mutations(frag, host_state, rounds)`, returning a
    # BasicFragmentMutator or None; the worker calls it after PEval and
    # after every round (reference worker.h:211-222), rebuilds the
    # fragment, and carries the state over with `migrate_state`.

    def migrate_state(self, old_frag, new_frag, old_state, new_state):
        """Copy per-vertex state rows (numpy) across a rebuild, matched
        by oid; new vertices keep `new_state`'s init values, replicated
        keys carry over, and ephemeral keys keep the new fragment's."""
        from libgrape_lite_tpu_torch.fragment.mutation import (
            oid_row_alignment,
        )

        of, ol, nf, nl = oid_row_alignment(old_frag, new_frag)
        out = dict(new_state)
        for k, v in new_state.items():
            if k in self.ephemeral_keys:
                continue  # built by init_state for the new fragment
            if k in self.replicated_keys:
                out[k] = old_state.get(k, v)
                continue
            ov = old_state.get(k)
            if (
                ov is not None
                and np.ndim(ov) >= 2
                and ov.shape[:2] == (old_frag.fnum, old_frag.vp)
                and np.ndim(v) >= 2
                and v.shape[:2] == (new_frag.fnum, new_frag.vp)
            ):
                nv = np.array(v)
                nv[nf, nl] = ov[of, ol]
                out[k] = nv
        return out

    @staticmethod
    def dyn_min_fold(relaxed: torch.Tensor, state: Dict, prefix: str,
                     full: torch.Tensor, plus_one: bool = False
                     ) -> torch.Tensor:
        """Merge the staged delta-edge overlay (dyn/ingest.py) into a
        pull-mode min reduction: one `overlay_fold` over the overlay's
        slot planes (`<prefix>src` rows, `nbr` pids, `w` when weighted,
        `mask`), in place into `relaxed` (the caller's fresh pull
        result) -- the JAX package's gather plus segment min over `src`,
        then `minimum`.  `plus_one` adds BFS's hop to each slot as the
        base pull's post-map does to each row.  min is exact in any
        order, so the result equals a cold query on the rebuilt graph.
        Lane-stacked `full` [k, N] folds every lane in the same launch."""
        from libgrape_lite_tpu_torch.ops import spmv

        return spmv.overlay_fold(relaxed, state[prefix + "src"],
                                 state[prefix + "nbr"],
                                 state.get(prefix + "w"),
                                 state[prefix + "mask"], full, plus_one)

    @staticmethod
    def segment_reduce(values, edge_src, vp, kind="sum"):
        """Reduce per-edge values into per-vertex rows; padded edges fall
        into the overflow row `vp`, which is sliced off."""
        from libgrape_lite_tpu_torch.ops.segment import segment_reduce

        return segment_reduce(values, edge_src, vp, kind)


class ParallelAppBase(AppBase):
    """Explicit-messaging superstep app (reference ParallelAppBase)."""


class BatchShuffleAppBase(AppBase):
    """Whole-array mirror-sync app (PageRank-style)."""

    message_strategy = MessageStrategy.kSyncOnOuterVertex


class AutoAppBase(AppBase):
    """Auto-messaging app (reference `auto_app_base.h:38-84` +
    `auto_parallel_message_manager.h:47-365`; JAX `app/base.py:377-418`):
    the app registers SyncBuffers (state key -> aggregate op) and writes
    only the local compute; messaging is implicit.

    `propose(ctx, dev, state)` returns, per synced key, each fragment's
    pid-indexed proposals `[fnum, fnum * vp]` (a rank's `[fl, fnum *
    vp]` under a process group; the neutral element where
    a fragment has nothing to say: the push of generateAutoMessages);
    `AutoParallelMessageManager.sync` folds them with the buffer's op
    (aggregateAutoMessages) and hands each fragment its slice to
    `update` (by default: adopt it, vote the changed inner vertices)."""

    sync_buffers: Dict[str, str] = {}
    # the push has no pull to pipeline or mirror-compress: the pull
    # apps' exchange plans stay off in their auto twins
    pipeline_state_key = None

    def propose(self, ctx: StepContext, dev, state: Dict) -> Dict:
        raise NotImplementedError

    def update(self, ctx: StepContext, dev, state: Dict, combined: Dict):
        changed_any = 0
        new_state = dict(state)
        for k in self.sync_buffers:
            new = combined[k]
            changed = (new != state[k]) & dev.inner_mask
            changed_any = changed_any + changed.sum()
            new_state[k] = new
        return new_state, changed_any

    def peval(self, ctx: StepContext, dev, state: Dict):
        return state, 1

    def inceval(self, ctx: StepContext, dev, state: Dict):
        combined = AutoParallelMessageManager.sync(
            dev, self.propose(ctx, dev, state), self.sync_buffers, ctx)
        return self.update(ctx, dev, state, combined)


class GatherScatterAppBase(AppBase):
    """Vertex-cut app (reference `gather_scatter_app_base.h:30-61`, JAX
    `app/base.py:421`)."""

    message_strategy = MessageStrategy.kGatherScatter
