"""Fragment <-> device <-> process topology.

Counterpart of `libgrape_lite_tpu/parallel/comm_spec.py` (reference
`grape/worker/comm_spec.h:34-239`).  Single-process, every fragment
lives on one device as a leading `[fnum, ...]` dimension: the spec is the
fragment count and the device, and there is no process group.

Several processes (`CommSpec.init_distributed`, the CLI's
`--coordinator / --num_processes / --process_id`) form a
`torch.distributed` group of `world` ranks.  `fnum % world == 0`, and
rank r owns the fragment slab `[r * fl, (r + 1) * fl)` with `fl = fnum /
world` (`frag_to_worker`).  Every rank loads the same host arrays, as the
JAX package's processes do (`put_global`), and places only its slab on
its device.  The backend follows the device:

  * `cpu` -- gloo;
  * `cuda` -- NCCL, one card a rank (`cuda:{rank % device_count}`).
    Two ranks on one card raise: NCCL refuses a duplicate GPU.
    `GRAPE_DIST_BACKEND=gloo` is then the explicit choice (the
    counterpart of the JAX package's `jax_cpu_collectives_
    implementation` selection): the kernels still run on the card, and
    each collective stages through pinned host buffers (device to host,
    the gloo call, host to device), a host sync per collective.

The spec's collective primitives (`all_gather_into`, `all_reduce`,
`all_to_all_single`, and `ring_shift`, the point-to-point step of a ring
of rank blocks) do that staging and count every call and its bytes in
the spec's `stats` (the group's traffic); `Communicator`
(parallel/communicator.py) builds the apps' collectives on them.
`host_allgather` is the control plane (breach votes, checkpoint commits,
the gang handshake): host-side and synchronous, over a gloo group of its
own when the data plane is NCCL, so no vote or commit barrier enters a
card's NCCL stream.

The vertex cut lays its k x k tiles over the same slabs (`VCGrid`): tile
(i, j) is fid i * k + j, and rank r holds tiles `fid_lo .. fid_lo + fl -
1`, whole tile rows (k divides fl) or part of one row (fl divides k);
any other world is refused before the load (`vc_layout_error`).  The
ranks holding the same tile columns form the row-axis group of their
columns (`VC_ROW_AXIS`: a fold over the tile rows), those holding the
same tile rows the column-axis group (`VC_COL_AXIS`); `vc_grid` makes
every group once per gang, every rank in the same order.  `axis_reduce`
and `axis_gather` run over one of them, `vc_transpose` swaps tile (i,
j)'s block with tile (j, i)'s in one `batch_isend_irecv`.  A primitive
given `async_op=True` returns a `Pending` whose `wait` lands its output
(the pipelined round's kickoff).
"""

from __future__ import annotations

import datetime
import inspect
import logging
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

kCoordinatorRank = 0  # reference grape/config.h:64

#: the vertex cut's mesh axes (the JAX package's names): a reduction over
#: VC_ROW_AXIS folds the k tile rows of a column, over VC_COL_AXIS the k
#: tile columns of a row
VC_ROW_AXIS = "vcrow"
VC_COL_AXIS = "vccol"

#: the process-group backend on a CUDA device: "nccl" (default) or
#: "gloo" (staged through host memory); ignored on the CPU (gloo)
DIST_BACKEND_ENV = "GRAPE_DIST_BACKEND"
#: seconds a rendezvous or a collective may wait for a missing rank
DIST_TIMEOUT_ENV = "GRAPE_DIST_TIMEOUT_S"
_DEFAULT_TIMEOUT_S = 300.0

def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for
    and absent (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def dist_timeout_s() -> float:
    return float(os.environ.get(DIST_TIMEOUT_ENV, "") or _DEFAULT_TIMEOUT_S)


#: the control plane's group: gloo beside an NCCL data plane, else None
#: (the default group, which is gloo already)
_CONTROL = {"group": None}


def host_allgather(vec: np.ndarray) -> np.ndarray:
    """Host-side allgather of a small vector, stacked `[nprocs, ...]`
    (JAX `host_allgather`): the control plane of breach votes, checkpoint
    commits and the gang handshake.  Every rank passes the same shape and
    dtype.  Single-process it stacks the input alone and touches no
    backend, so a caller's quorum logic is the same at every process
    count; under a group every rank contributes its vector, over host
    memory (the control group, never NCCL)."""
    v = np.asarray(vec)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return v[None]
    t = torch.from_numpy(np.ascontiguousarray(v).reshape(-1).copy())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_CONTROL["group"])
    return np.stack([o.numpy().reshape(v.shape) for o in out])


def is_slab(v, fl: int, replicated: bool = False) -> bool:
    """Whether a state leaf is a rank's slab of the fragment stack (its
    rows `fid_lo .. fid_lo + fl - 1`): not replicated, two or more
    dimensions, `fl` rows.  Every other leaf is held whole by every rank.
    The result gather, the sharded checkpoint, the resume and the guard's
    probe across ranks all split a carry by this rule."""
    return not replicated and getattr(v, "ndim", 0) >= 2 and v.shape[0] == fl


def leave_group() -> None:
    """Destroy this process's groups, the control group's handle with
    them (the CLI's `main` calls it, on the error path too)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _CONTROL["group"] = None


def vc_layout_error(fnum: int, world: int) -> str | None:
    """Why `world` ranks cannot hold the k x k tiles of a vertex cut of
    `fnum` = k^2 fragments, or None.  Rank r holds the tiles `r * fl ..
    (r + 1) * fl - 1` (fl = fnum / world): whole tile rows (k divides fl)
    or part of one row (fl divides k).  A non-square fnum, or one the
    world does not divide, is left to the checks that name it."""
    k = math.isqrt(fnum)
    if world <= 1 or k * k != fnum or fnum % world:
        return None
    fl = fnum // world
    if fl % k == 0 or k % fl == 0:
        return None
    return (f"the vertex cut of {k} x {k} tiles across {world} processes "
            f"gives each rank fl = fnum / num_processes = {fl} tiles; a "
            "rank's slab must be whole tile rows (k divides fl) or part of "
            "one tile row (fl divides k)")


@dataclass(frozen=True)
class VCGrid:
    """The k x k tile grid over `world` rank slabs: which tiles, tile
    rows and tile columns rank `rank` holds, its row- and column-axis
    groups and the tile transpose's peers.  Pure geometry (no process
    group), the same on every rank."""

    k: int
    world: int
    rank: int

    @property
    def fl(self) -> int:
        return self.k * self.k // self.world

    def span(self, rank: int) -> tuple:
        """(r_lo, nr, c_lo, nc): the tile rows and columns `rank` holds."""
        k, fl = self.k, self.fl
        lo = rank * fl
        if fl % k == 0:
            return lo // k, fl // k, 0, k
        return lo // k, 1, lo % k, fl

    @property
    def fid_lo(self) -> int:
        return self.rank * self.fl

    @property
    def r_lo(self) -> int:
        return self.span(self.rank)[0]

    @property
    def nr(self) -> int:
        return self.span(self.rank)[1]

    @property
    def c_lo(self) -> int:
        return self.span(self.rank)[2]

    @property
    def nc(self) -> int:
        return self.span(self.rank)[3]

    def members(self, axis: str, rank: int | None = None) -> tuple:
        """The ranks of `rank`'s group over `axis`: those holding the same
        tile columns (VC_ROW_AXIS) or the same tile rows (VC_COL_AXIS),
        in rank order."""
        mine = self.span(self.rank if rank is None else rank)
        part = (slice(2, 4) if axis == VC_ROW_AXIS else slice(0, 2))
        return tuple(q for q in range(self.world)
                     if self.span(q)[part] == mine[part])

    def groups(self, axis: str) -> list:
        """Every group over `axis` of more than one rank, in one order."""
        out = []
        for q in range(self.world):
            m = self.members(axis, q)
            if len(m) > 1 and m not in out:
                out.append(m)
        return out

    def transpose_peers(self) -> tuple:
        """(local, peers) of the tile transpose: `local` the (dst, src)
        local tile pairs this rank moves itself; `peers` {rank: (send,
        recv)} -- the local tiles whose blocks go to that rank, in this
        rank's fid order, and those whose blocks come back, in the
        sender's fid order."""
        k, fl, lo = self.k, self.fl, self.fid_lo
        local, send, recv = [], {}, {}
        for t in range(fl):
            i, j = divmod(lo + t, k)
            partner = j * k + i
            q = partner // fl
            if q == self.rank:
                local.append((t, partner - lo))
            else:
                send.setdefault(q, []).append(t)
                recv.setdefault(q, []).append((partner, t))
        peers = {q: (send[q], [t for _, t in sorted(recv[q])])
                 for q in sorted(send)}
        return local, peers


class Pending:
    """An issued collective (`async_op=True`): `wait` ends it, lands a
    staged output on the device and returns the output (`then` maps it
    first, into the tensor the caller was handed)."""

    def __init__(self, work, out: torch.Tensor, wire_out: torch.Tensor,
                 then=None):
        self._work, self._out, self._wire_out = work, out, wire_out
        self._then = then

    @property
    def out(self) -> torch.Tensor:
        """The tensor `wait` lands the output in (its values are the
        collective's only after `wait`)."""
        return self._out

    def tensors(self) -> tuple:
        return (self._out, self._wire_out)

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        out = CommSpec._land(self._out, self._wire_out)
        return out if self._then is None else self._then(out)


def pick_backend(device: torch.device, world: int) -> tuple:
    """(backend, staged) of a group of `world` ranks on `device` (every
    rank on this host): gloo on the CPU; on CUDA NCCL, or gloo staged
    through the host when GRAPE_DIST_BACKEND=gloo.  NCCL with more ranks
    than cards raises, naming the gloo choice: it is never made
    silently."""
    asked = (os.environ.get(DIST_BACKEND_ENV, "") or "").strip().lower()
    if asked not in ("", "nccl", "gloo"):
        raise ValueError(
            f"{DIST_BACKEND_ENV}={asked!r} is not one of nccl|gloo")
    if device.type == "cpu":
        if asked == "nccl":
            raise ValueError(
                f"{DIST_BACKEND_ENV}=nccl needs a CUDA device; the CPU "
                "runs its collectives over gloo")
        return "gloo", False
    if asked == "gloo":
        return "gloo", True
    cards = torch.cuda.device_count()
    if world > cards:
        raise RuntimeError(
            f"NCCL needs one card a rank: {world} ranks share "
            f"{cards} CUDA device(s) and NCCL refuses a duplicate GPU; set "
            f"{DIST_BACKEND_ENV}=gloo to run the ranks on shared cards "
            "with each collective staged through host memory")
    return "nccl", False


class CommSpec:
    def __init__(self, fnum: int | None = None, device="cuda", *,
                 rank: int = 0, world: int = 1, group=None,
                 backend: str | None = None, staged: bool = False):
        fnum = 1 if fnum is None else int(fnum)
        if fnum < 1:
            raise ValueError("fnum must be >= 1")
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        if fnum % world:
            raise ValueError(
                f"fnum={fnum} is not a multiple of num_processes={world}: "
                "every rank holds fnum / num_processes fragments")
        self.fnum = fnum
        self.device = resolve_device(device)
        self.rank, self.world = int(rank), int(world)
        self.fl = fnum // self.world
        self.fid_lo = self.rank * self.fl
        self.group = group
        self.backend = backend
        self.staged = bool(staged)
        #: the group's collective traffic, counted by the primitives below:
        #: calls and payload bytes per kind, the calls staged through the
        #: host
        self.stats = {}
        self.reset_stats()
        # the vertex cut's grid and groups, by k (`vc_grid`)
        self._vc = {}

    def reset_stats(self) -> None:
        self.stats.update(calls=0, bytes=0, staged=0, all_gather=0,
                          all_gather_bytes=0, all_reduce=0, all_to_all=0,
                          ring=0, ring_bytes=0, vc_reduce=0,
                          vc_reduce_bytes=0, vc_gather=0, vc_gather_bytes=0,
                          vc_transpose=0, vc_transpose_bytes=0)

    # ---- topology (comm_spec.h:128-150) ----

    @property
    def is_coordinator(self) -> bool:
        return self.rank == kCoordinatorRank

    def frag_to_worker(self, fid: int) -> int:
        return fid // self.fl

    @property
    def transport(self) -> str:
        if self.group is None:
            return "local"
        return f"{self.backend}{'-staged' if self.staged else ''}"

    def __repr__(self):
        if self.group is None:
            return f"CommSpec(fnum={self.fnum}, device={self.device})"
        return (f"CommSpec(fnum={self.fnum}, device={self.device}, "
                f"rank={self.rank}/{self.world}, fl={self.fl}, "
                f"transport={self.transport})")

    # ---- the multi-process runtime ----

    @classmethod
    def init_distributed(cls, coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         fnum: int | None = None, retry_policy=None,
                         device="cuda") -> "CommSpec":
        """Join the process group (the reference's `InitMPIComm`,
        JAX `CommSpec.init_distributed`): `torch.distributed.
        init_process_group` over `tcp://<coordinator_address>` with this
        rank, the world size and a timeout (GRAPE_DIST_TIMEOUT_S), so a
        rank that never arrives fails the run instead of hanging it.
        Transient rendezvous faults (connection refused, a store timeout,
        a port in use) retry under `DISTRIBUTED_INIT_POLICY`; a double
        init never does.  The device of rank r is `cuda:{r %
        device_count}`, set before the group comes up.  fnum defaults to
        the world size and must be a multiple of it (checked before
        anything connects).  Every rank runs on this host."""
        import torch.distributed as dist

        from libgrape_lite_tpu_torch.ft.retry import (
            DISTRIBUTED_INIT_POLICY,
            is_late_init_error,
            is_transient_distributed_error,
            with_retries,
        )

        world = int(num_processes or 1)
        rank = int(process_id or 0)
        if not coordinator_address:
            raise ValueError("init_distributed needs a coordinator address "
                             "(host:port)")
        if not 0 <= rank < world:
            raise ValueError(
                f"process_id {rank} is not in [0, num_processes={world})")
        fnum = world if fnum is None else int(fnum)
        if fnum % world:
            raise ValueError(
                f"fnum={fnum} is not a multiple of num_processes={world}: "
                "every rank holds fnum / num_processes fragments")
        dev = resolve_device(device)
        backend, staged = pick_backend(dev, world)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=dist_timeout_s())

        def _initialize():
            try:
                kw = {}
                if backend == "nccl" and "device_id" in inspect.signature(
                        dist.init_process_group).parameters:
                    kw["device_id"] = dev  # binds the rank's card eagerly
                dist.init_process_group(
                    backend, init_method=f"tcp://{coordinator_address}",
                    rank=rank, world_size=world, timeout=timeout, **kw)
            except Exception as e:
                # a failed rendezvous may leave a half-built default
                # group; clear it only for an error that will be retried
                # (a double init must not tear down a live group)
                if (is_transient_distributed_error(e)
                        and dist.is_initialized()):
                    try:
                        dist.destroy_process_group()
                    except Exception:
                        pass
                raise

        try:
            with_retries(_initialize,
                         policy=retry_policy or DISTRIBUTED_INIT_POLICY,
                         retryable=is_transient_distributed_error,
                         describe="torch.distributed.init_process_group")
        except (RuntimeError, ValueError) as e:
            if not is_late_init_error(e):
                raise
            raise RuntimeError(
                "CommSpec.init_distributed: this process already joined a "
                "process group (torch.distributed.init_process_group runs "
                "once a process)") from e
        # the control plane (host_allgather) stays on the host: a gloo
        # group beside NCCL, made by every rank in the same order
        _CONTROL["group"] = (dist.new_group(backend="gloo", timeout=timeout)
                             if backend == "nccl" else None)
        spec = cls(fnum, dev, rank=rank, world=world,
                   group=dist.group.WORLD, backend=backend, staged=staged)
        _LOG.info("process group up: %r (%s)", spec,
                  "gloo staged through pinned host buffers" if staged
                  else backend)
        return spec

    def barrier(self) -> None:
        """Every rank of the group waits here (no-op single-process)."""
        if self.group is None:
            return
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Leave the process group (the CLI's `main` calls it, on the
        error path too)."""
        if self.group is None:
            return
        leave_group()
        self.group = None

    # ---- collective primitives (staged through the host under gloo on
    # CUDA; counted in `stats`) ----

    def _count(self, kind: str, nbytes: int) -> None:
        st = self.stats
        st["calls"] += 1
        st[kind] += 1
        st["bytes"] += int(nbytes)
        if self.staged:
            st["staged"] += 1

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend reads: a pinned host copy when staged
        (the device-to-host copy is the collective's host sync)."""
        if not self.staged:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    @staticmethod
    def _land(out: torch.Tensor, wire: torch.Tensor) -> torch.Tensor:
        if wire is not out:
            out.copy_(wire, non_blocking=True)
        return out

    def _issued(self, work, out, wire_out, async_op: bool, then=None):
        """The output of an issued collective: landed now, or a Pending."""
        if async_op:
            return Pending(work, out, wire_out, then)
        out = self._land(out, wire_out)
        return out if then is None else then(out)

    def all_gather_into(self, inp: torch.Tensor, async_op: bool = False):
        """[n, ...] on every rank -> [world * n, ...], rank order."""
        return self._gather(inp, self.group, self.world, "all_gather",
                            async_op)

    def _gather(self, inp: torch.Tensor, group, n: int, kind: str,
                async_op: bool = False):
        """[m, ...] on each of the `n` ranks of `group` -> [n * m, ...] in
        rank order, counted as `kind` and its bytes."""
        import torch.distributed as dist

        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        inp = inp.contiguous()
        shape = (n * inp.shape[0],) + tuple(inp.shape[1:])
        out = torch.empty(shape, dtype=inp.dtype, device=inp.device)
        wire_out = out if not self.staged else self._buffer(shape, inp.dtype)
        work = gather(wire_out, self._wire(inp), group=group,
                      async_op=async_op)
        nbytes = out.numel() * out.element_size()
        self._count(kind, nbytes)
        self.stats[kind + "_bytes"] += nbytes
        return self._issued(work, out, wire_out, async_op)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Elementwise "sum" / "min" / "max" across ranks, in place (a
        new tensor when staged)."""
        t = t.contiguous()
        wire = self._wire(t)
        self._reduce(wire, op, self.group)
        self._count("all_reduce", t.numel() * t.element_size())
        return self._land(t, wire)

    @staticmethod
    def _reduce(wire: torch.Tensor, op: str, group, async_op=False):
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}
        return dist.all_reduce(wire, op=ops[op], group=group,
                               async_op=async_op)

    def all_to_all_single(self, inp: torch.Tensor, async_op: bool = False,
                          then=None):
        """[world, ...] blocks: block q goes to rank q, which stacks what
        it receives in sender order."""
        import torch.distributed as dist

        inp = inp.contiguous()
        out = torch.empty_like(inp)
        wire_out = out if not self.staged else self._buffer(inp.shape,
                                                            inp.dtype)
        work = dist.all_to_all_single(wire_out, self._wire(inp),
                                      group=self.group, async_op=async_op)
        self._count("all_to_all", inp.numel() * inp.element_size())
        return self._issued(work, out, wire_out, async_op, then)

    # ---- the vertex cut's k x k grid ----

    def vc_grid(self, k: int) -> VCGrid:
        """This rank's place on the k x k tile grid.  Under a process
        group the first call for `k` makes every row- and column-axis
        group of more than one rank -- on every rank, in the same order,
        as `torch.distributed.new_group` requires -- so each rank makes
        its fragments' grids in one order.  Raises the layout rule's
        ValueError for a world that breaks it."""
        if k not in self._vc:
            why = vc_layout_error(k * k, self.world)
            if why is not None:
                raise ValueError(why)
            if self.fnum != k * k:
                raise ValueError(f"vertex-cut needs fnum = k^2, got "
                                 f"{self.fnum} for k {k}")
            grid = VCGrid(k, self.world, self.rank)
            groups = {VC_ROW_AXIS: None, VC_COL_AXIS: None}
            if self.group is not None:
                import torch.distributed as dist

                timeout = datetime.timedelta(seconds=dist_timeout_s())
                for axis in (VC_ROW_AXIS, VC_COL_AXIS):
                    for m in grid.groups(axis):
                        g = dist.new_group(list(m), timeout=timeout)
                        if self.rank in m:
                            groups[axis] = g
            self._vc[k] = (grid, groups)
        return self._vc[k][0]

    def _axis_group(self, k: int, axis: str):
        self.vc_grid(k)
        return self._vc[k][1][axis]

    def axis_reduce(self, t: torch.Tensor, k: int, axis: str, op: str,
                    async_op: bool = False):
        """Elementwise "sum" / "min" / "max" over this rank's `axis`
        group of the k x k grid (the JAX package's psum / pmin over the
        axis); a group of one rank is the identity, counted nowhere."""
        group = self._axis_group(k, axis)
        t = t.contiguous()
        if group is None:
            return Pending(None, t, t) if async_op else t
        wire = self._wire(t)
        work = self._reduce(wire, op, group, async_op)
        nbytes = t.numel() * t.element_size()
        self._count("vc_reduce", nbytes)
        self.stats["vc_reduce_bytes"] += nbytes
        return self._issued(work, t, wire, async_op)

    def axis_gather(self, t: torch.Tensor, k: int, axis: str) -> torch.Tensor:
        """[n, ...] on every rank of this rank's `axis` group -> [len
        (group) * n, ...] in rank order (the identity for one rank)."""
        group = self._axis_group(k, axis)
        if group is None:
            return t
        n = len(self._vc[k][0].members(axis))
        return self._gather(t, group, n, "vc_gather")

    def vc_transpose(self, blocks: torch.Tensor, k: int) -> torch.Tensor:
        """[fl, ...] blocks, one a local tile in fid order -> the blocks
        of the transposed tiles: out[t] is tile (j, i)'s block for local
        tile t = (i, j).  The diagonal and the partners this rank holds
        move locally; every other peer swaps its blocks in one
        `batch_isend_irecv` (one message each way a peer)."""
        local, peers = self.vc_grid(k).transpose_peers()
        out = torch.empty_like(blocks)
        if local:
            dst, src = zip(*local)
            out[list(dst)] = blocks[list(src)]
        if not peers:
            return out
        got = self._swap(blocks, peers)
        nbytes = 0
        for q, (send, recv) in peers.items():
            out[recv] = got[q].to(out.device, non_blocking=True)
            nbytes += got[q].numel() * got[q].element_size()
        self._count("vc_transpose", nbytes)
        self.stats["vc_transpose_bytes"] += nbytes
        return out

    def _swap(self, blocks: torch.Tensor, peers: dict) -> dict:
        """{peer: the blocks it sent}: each peer's `send` blocks of
        `blocks` go to it as one message and its message comes back, all
        in one `batch_isend_irecv`."""
        import torch.distributed as dist

        ops, got = [], {}
        for q, (send, recv) in peers.items():
            msg = blocks[send].contiguous()
            got[q] = self._buffer(msg.shape, msg.dtype)
            ops.append(dist.P2POp(dist.isend, self._wire(msg), q,
                                  group=self.group))
            ops.append(dist.P2POp(dist.irecv, got[q], q, group=self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """One step of a ring of rank blocks: this rank's block goes to
        rank r - 1 and rank r + 1's comes back (the JAX package's
        `ppermute` with perm i -> i - 1), as one `batch_isend_irecv` pair.
        Every rank passes a block of the same shape and dtype.  One rank
        is the identity (nothing crosses and nothing is counted)."""
        if self.group is None or self.world == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        out = torch.empty_like(t)
        wire_out = out if not self.staged else self._buffer(t.shape, t.dtype)
        r, w = self.rank, self.world
        ops = [dist.P2POp(dist.isend, self._wire(t), (r - 1) % w,
                          group=self.group),
               dist.P2POp(dist.irecv, wire_out, (r + 1) % w,
                          group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        nbytes = t.numel() * t.element_size()
        self._count("ring", nbytes)
        self.stats["ring_bytes"] += nbytes
        return self._land(out, wire_out)
