"""Fault injection: recovery is tested, not assumed.

Counterpart of `libgrape_lite_tpu/ft/faults.py`, with its grammar.  A
`FaultPlan` describes the faults to inject into a query, armed by the
GRAPE_FT_FAULTS environment variable (so `scripts/fault_drill.py` arms a
child process without code changes) or built in tests.

Spec grammar -- comma-separated tokens:

    kill@K            kill the process after superstep K's checkpoint
                      is durable (os._exit; `mode=raise` raises
                      InjectedFault instead, for in-process tests)
    kill_rank@K:R     the same, only on rank R (`torch.distributed`'s
                      rank; 0 without a process group)
    corrupt@K         flip bytes in the newest checkpoint shard after
                      the superstep-K checkpoint lands (the resume falls
                      back to the previous one)
    corrupt_carry@K   overwrite a band of the live carry right after
                      superstep K, once: NaN into the first float
                      per-vertex leaf, -7 into an int one (the guard's
                      self-heal drill)
    capacity=N        clamp the planned message capacity to N, forcing
                      the overflow-retry ladder
                      (message_manager.plan_initial_capacity)
    mode=raise        kill via InjectedFault instead of os._exit
    exit=N            exit code for the kill (default 17)

An unknown or malformed token raises `FaultSpecError` naming the
grammar: a typo like `kil@3` never parses to a silent no-op plan.

`GRAPE_FT_2PC_KILL=K:R` (JAX `ft/distributed.py`'s test hook) kills rank
R between the two phases of superstep K's sharded checkpoint: its shard
is staged, the commit never happens (`maybe_kill_between_phases`, read
by ft/distributed.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from libgrape_lite_tpu_torch.utils import logging as glog

FAULTS_ENV = "GRAPE_FT_FAULTS"
DEFAULT_KILL_EXIT_CODE = 17
#: "K:R" kills rank R between the stage barrier and the commit of
#: superstep K's sharded checkpoint (the window the two-phase commit is
#: about)
TWO_PHASE_KILL_ENV = "GRAPE_FT_2PC_KILL"


class InjectedFault(RuntimeError):
    """A deliberately injected fault (mode=raise kills)."""


SPEC_GRAMMAR = (
    "kill@K, kill_rank@K:R, corrupt@K, corrupt_carry@K, capacity=N, "
    "mode=raise|exit, exit=N"
)


class FaultSpecError(ValueError):
    """A GRAPE_FT_FAULTS token is unknown or malformed; the message lists
    the supported grammar."""

    def __init__(self, token: str, why: str):
        super().__init__(
            f"bad fault token {token!r} in {FAULTS_ENV}: {why} "
            f"(supported spec forms: {SPEC_GRAMMAR})"
        )
        self.token = token


def corrupt_file(path: str, nbytes: int = 16, offset: Optional[int] = None):
    """Flip `nbytes` bytes mid-file: a truncation-free corruption only a
    content checksum catches."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    nbytes = min(nbytes, size)
    if offset is None:
        offset = max(0, size // 2 - nbytes // 2)
    with open(path, "r+b") as fh:
        fh.seek(offset)
        chunk = fh.read(nbytes)
        fh.seek(offset)
        fh.write(bytes(b ^ 0xFF for b in chunk))


def _kind(dtype) -> str:
    """numpy kind letter of a numpy or torch dtype ('b' for bool)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            return "b"
        if dtype.is_floating_point:
            return "f"
        if dtype.is_complex:
            return "c"
        return "i" if dtype.is_signed else "u"
    return np.dtype(dtype).kind


def _host_copy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(np.asarray(a))


@dataclass
class FaultPlan:
    kill_at_superstep: Optional[int] = None
    kill_rank_at: Optional[int] = None   # kill_rank@K:R superstep K
    kill_rank: Optional[int] = None      # kill_rank@K:R rank R
    corrupt_checkpoint_at: Optional[int] = None
    corrupt_carry_at: Optional[int] = None
    capacity_clamp: Optional[int] = None
    mode: str = "exit"  # exit | raise
    exit_code: int = DEFAULT_KILL_EXIT_CODE
    _carry_fired: bool = False  # corrupt_carry injects once a process

    @staticmethod
    def _int_of(tok: str, payload: str) -> int:
        try:
            return int(payload)
        except ValueError:
            raise FaultSpecError(
                tok, f"{payload!r} is not an integer") from None

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            # longest prefixes first: corrupt@ must not swallow
            # corrupt_carry@, nor kill@ kill_rank@
            if tok.startswith("corrupt_carry@"):
                plan.corrupt_carry_at = cls._int_of(
                    tok, tok[len("corrupt_carry@"):])
            elif tok.startswith("kill_rank@"):
                payload = tok[len("kill_rank@"):]
                k, sep, r = payload.partition(":")
                if not sep:
                    raise FaultSpecError(
                        tok, f"{payload!r} is not K:R (missing rank)")
                plan.kill_rank_at = cls._int_of(tok, k)
                plan.kill_rank = cls._int_of(tok, r)
                if plan.kill_rank < 0:
                    raise FaultSpecError(
                        tok, f"rank {plan.kill_rank} is negative")
            elif tok.startswith("kill@"):
                plan.kill_at_superstep = cls._int_of(tok, tok[len("kill@"):])
            elif tok.startswith("corrupt@"):
                plan.corrupt_checkpoint_at = cls._int_of(
                    tok, tok[len("corrupt@"):])
            elif tok.startswith("capacity="):
                plan.capacity_clamp = max(
                    1, cls._int_of(tok, tok[len("capacity="):]))
            elif tok.startswith("mode="):
                mode = tok[len("mode="):]
                if mode not in ("exit", "raise"):
                    raise FaultSpecError(tok, f"unknown kill mode {mode!r}")
                plan.mode = mode
            elif tok.startswith("exit="):
                plan.exit_code = cls._int_of(tok, tok[len("exit="):])
            else:
                raise FaultSpecError(tok, "unknown fault kind")
        return plan

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlan":
        return cls.from_spec((environ or os.environ).get(FAULTS_ENV, ""))

    def is_noop(self) -> bool:
        return (
            self.kill_at_superstep is None
            and self.kill_rank_at is None
            and self.corrupt_checkpoint_at is None
            and self.corrupt_carry_at is None
            and self.capacity_clamp is None
        )

    # ---- hook points -----------------------------------------------------

    def clamp_capacity(self, cap: int) -> int:
        """plan_initial_capacity's hook: a capacity small enough to
        overflow, so the retry ladder runs."""
        if self.capacity_clamp is None:
            return cap
        clamped = max(1, min(cap, self.capacity_clamp))
        if clamped != cap:
            glog.log_info(f"fault injection: message capacity clamped "
                          f"{cap} -> {clamped}")
        return clamped

    def maybe_corrupt_carry(self, carry, rounds: int):
        """corrupt_carry@K's hook (after superstep `rounds`, before its
        probe and save): `{key: corrupted host array}` for the worker to
        place on the device, or None.  Fires once -- a guard rollback
        replays the superstep, which must then run clean.  The target is
        the first float per-vertex leaf in sorted-key order, else the
        first int one; its `flat[0, :16]` becomes NaN or -7."""
        if (
            self.corrupt_carry_at is None
            or rounds != self.corrupt_carry_at
            or self._carry_fired
        ):
            return None
        key = None
        for want_float in (True, False):
            for k in sorted(carry):
                a = carry[k]
                if getattr(a, "ndim", 0) < 2:
                    continue
                kind = _kind(a.dtype)
                if (kind == "f") == want_float and kind in "fi":
                    key = k
                    break
            if key is not None:
                break
        if key is None:
            glog.log_info("fault injection: corrupt_carry found no "
                          "per-vertex leaf to poison; skipping")
            return None
        self._carry_fired = True
        a = _host_copy(carry[key])
        flat = a.reshape(a.shape[0], -1)
        n = min(16, flat.shape[1])
        poison = np.nan if a.dtype.kind == "f" else -7
        flat[0, :n] = poison
        glog.log_info(f"fault injection: corrupted carry leaf {key!r} after "
                      f"superstep {rounds} ({n} values set to {poison!r})")
        return {key: a}

    def on_superstep(self, rounds: int, manager=None) -> None:
        """Called after superstep `rounds` and its checkpoint save."""
        if (
            self.corrupt_checkpoint_at is not None
            and rounds == self.corrupt_checkpoint_at
            and manager is not None
        ):
            from libgrape_lite_tpu_torch.ft.checkpoint import (
                list_checkpoints,
            )

            manager.wait()  # the shard must exist before it is mauled
            steps = list_checkpoints(manager.directory)
            if steps:
                # a sharded lineage: each rank mauls its own shard file
                shard = os.path.join(steps[-1][1], "state.npz")
                if not os.path.exists(shard):
                    shard = os.path.join(steps[-1][1],
                                         f"rank_{self._this_rank()}.npz")
                corrupt_file(shard)
                glog.log_info(
                    f"fault injection: corrupted checkpoint shard {shard}")
        if (
            self.kill_at_superstep is not None
            and rounds == self.kill_at_superstep
        ):
            if manager is not None:
                manager.wait()  # kill only once the checkpoint is durable
            glog.log_info(f"fault injection: killing at superstep {rounds} "
                          f"(mode={self.mode})")
            if self.mode == "raise":
                raise InjectedFault(f"injected kill at superstep {rounds}")
            os._exit(self.exit_code)
        if (
            self.kill_rank_at is not None
            and rounds == self.kill_rank_at
            and self._this_rank() == self.kill_rank
        ):
            if manager is not None:
                manager.wait()
            glog.log_info(
                f"fault injection: killing rank {self.kill_rank} at "
                f"superstep {rounds} (mode={self.mode})")
            if self.mode == "raise":
                raise InjectedFault(
                    f"injected kill of rank {self.kill_rank} at "
                    f"superstep {rounds}")
            os._exit(self.exit_code)

    @staticmethod
    def _this_rank() -> int:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:
            pass
        return 0


def maybe_kill_between_phases(rounds: int, rank: int) -> None:
    """GRAPE_FT_2PC_KILL=K:R: exit rank R at superstep K after its shard
    is staged and voted, before the coordinator commits."""
    spec = os.environ.get(TWO_PHASE_KILL_ENV, "")
    if not spec:
        return
    k, _, r = spec.partition(":")
    try:
        k, r = int(k), int(r)
    except ValueError:
        raise ValueError(f"{TWO_PHASE_KILL_ENV}={spec!r} is not K:R") from None
    if k == rounds and r == rank:
        glog.log_info(
            f"fault injection: killing rank {rank} between checkpoint "
            f"phases at superstep {rounds} (stage is durable, commit "
            "never happens)")
        os._exit(DEFAULT_KILL_EXIT_CODE)


_NOOP = FaultPlan()


def active_plan() -> FaultPlan:
    """The env-armed plan (a no-op plan when GRAPE_FT_FAULTS is unset)."""
    spec = os.environ.get(FAULTS_ENV, "")
    if not spec:
        return _NOOP
    return FaultPlan.from_spec(spec)
