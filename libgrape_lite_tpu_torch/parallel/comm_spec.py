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
`all_to_all_single`) do that staging and count every call and its bytes
in the spec's `stats` (the group's traffic); `Communicator`
(parallel/communicator.py) builds the apps' collectives on them.
`host_allgather` is the control plane (breach votes, checkpoint commits,
the gang handshake): host-side and synchronous, over a gloo group of its
own when the data plane is NCCL, so no vote or commit barrier enters a
card's NCCL stream.
"""

from __future__ import annotations

import datetime
import inspect
import logging
import os

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

kCoordinatorRank = 0  # reference grape/config.h:64

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


def decline_across_ranks(world: int, what: str, item: str,
                         ok: bool = False) -> None:
    """Raise a ValueError naming ROADMAP item `item` when a run spans
    processes (`world` > 1) and `ok` is false: `what` is not yet
    supported across ranks, and a run never drops to one process without
    saying so."""
    if ok or world <= 1:
        return
    raise ValueError(
        f"{what} is not yet supported across processes (world {world} > "
        f"1): ROADMAP item {item}")


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

    def reset_stats(self) -> None:
        self.stats.update(calls=0, bytes=0, staged=0, all_gather=0,
                          all_gather_bytes=0, all_reduce=0, all_to_all=0)

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

    def all_gather_into(self, inp: torch.Tensor) -> torch.Tensor:
        """[n, ...] on every rank -> [world * n, ...], rank order."""
        import torch.distributed as dist

        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        inp = inp.contiguous()
        shape = (self.world * inp.shape[0],) + tuple(inp.shape[1:])
        out = torch.empty(shape, dtype=inp.dtype, device=inp.device)
        wire_out = out if not self.staged else self._buffer(shape, inp.dtype)
        gather(wire_out, self._wire(inp), group=self.group)
        nbytes = out.numel() * out.element_size()
        self._count("all_gather", nbytes)
        self.stats["all_gather_bytes"] += nbytes
        return self._land(out, wire_out)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Elementwise "sum" / "min" / "max" across ranks, in place (a
        new tensor when staged)."""
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}
        t = t.contiguous()
        wire = self._wire(t)
        dist.all_reduce(wire, op=ops[op], group=self.group)
        self._count("all_reduce", t.numel() * t.element_size())
        return self._land(t, wire)

    def all_to_all_single(self, inp: torch.Tensor) -> torch.Tensor:
        """[world, ...] blocks: block q goes to rank q, which stacks what
        it receives in sender order."""
        import torch.distributed as dist

        inp = inp.contiguous()
        out = torch.empty_like(inp)
        wire_out = out if not self.staged else self._buffer(inp.shape,
                                                            inp.dtype)
        dist.all_to_all_single(wire_out, self._wire(inp), group=self.group)
        self._count("all_to_all", inp.numel() * inp.element_size())
        return self._land(out, wire_out)
