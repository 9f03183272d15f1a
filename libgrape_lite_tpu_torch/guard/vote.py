"""Cross-rank breach votes: one rank's halt is every rank's halt.

Counterpart of `libgrape_lite_tpu/guard/vote.py`, with its vote codes,
vector layout and incident ids.  Under a process group the guard's probe
is a global verdict (guard/monitor.py exchanges its partial sums), but
the raise is host-side, and a raise on one rank strands its siblings in
the next superstep's collective.  Host-side failures are worse: an
`InjectedFault`, an IO error in a checkpoint hook, anything rank-local
halts exactly one process.

`BreachVote.round_vote` closes that gap with a small host-side allgather
(`parallel.comm_spec.host_allgather`, the control plane) at each
superstep boundary where hazard hooks run: every rank votes (verdict
code, superstep, trace word).  A healthy gang pays one 3-int32 exchange;
any non-zero vote makes every rank raise at the same cut -- the
breaching rank re-raises its own error, the healthy ranks raise
`RemoteBreachError` naming who halted and why -- and nobody is left in a
collective.  The vote also checks the superstep numbers: ranks voting at
different cuts are out of lockstep, a halt.

The worker arms the vote only when a hazard hook exists (a guard,
checkpointing or a fault plan, each the same on every rank) and only
under a process group, so a run with no group behaves as before with
this module never imported.  A one-rank group votes too (a one-row
allgather): its cost is what a gang's vote adds to a round on one card.

With obs/ armed the third word of the vector is a 28-bit prefix of this
rank's trace id (the gathered matrix names every rank's trace file), and
each rank emits one flow leg a vote (`("gang-vote", rounds + 1)`), which
the merged gang trace draws as an arrow across the rank tracks.  Every
raise attaches `err.gang_incident`, a digest of the gathered votes (the
same bytes on every rank), under which obs/gang.py dumps the distributed
postmortem.  Fakes that gather 2-wide vectors keep working: the third
column is read only when present.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from libgrape_lite_tpu_torch.guard.monitor import (
    DivergenceError,
    GuardError,
    InvariantBreachError,
)

VOTE_HEALTHY = 0
VOTE_INVARIANT = 1
VOTE_DIVERGENCE = 2
VOTE_FAULT = 3
VOTE_ERROR = 4

_VOTE_NAMES = {
    VOTE_HEALTHY: "healthy",
    VOTE_INVARIANT: "invariant breach",
    VOTE_DIVERGENCE: "divergence",
    VOTE_FAULT: "injected fault",
    VOTE_ERROR: "host-side error",
}


class RemoteBreachError(GuardError):
    """Another rank voted a halt at this superstep: this rank is healthy
    and halts in lockstep instead of blocking in the next collective.
    `.bundle` names the voting ranks and their codes; `.gang_incident`
    (when set) is the gang's shared incident id."""


def classify_breach_error(err: Optional[BaseException]) -> int:
    """The vote code of a caught hazard-hook error: the guard's verdicts
    keep their identity across the wire, anything else is a host-side
    error."""
    if err is None:
        return VOTE_HEALTHY
    if isinstance(err, DivergenceError):
        return VOTE_DIVERGENCE
    if isinstance(err, InvariantBreachError):
        return VOTE_INVARIANT
    from libgrape_lite_tpu_torch.ft.faults import InjectedFault

    if isinstance(err, InjectedFault):
        return VOTE_FAULT
    return VOTE_ERROR


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


class BreachVote:
    """One breach-vote endpoint a process.  `allgather`, `rank` and
    `nprocs` are injectable, so the quorum logic is testable in one
    process."""

    def __init__(self, *, rank: Optional[int] = None,
                 nprocs: Optional[int] = None, allgather=None):
        if rank is None or nprocs is None:
            from libgrape_lite_tpu_torch.obs.metrics import gang_identity

            r, n = gang_identity()
            rank = r if rank is None else rank
            nprocs = n if nprocs is None else nprocs
        self.rank, self.nprocs = int(rank), int(nprocs)
        if allgather is None:
            from libgrape_lite_tpu_torch.parallel.comm_spec import (
                host_allgather,
            )

            allgather = host_allgather
        self._allgather = allgather

    @classmethod
    def for_current_process(cls) -> Optional["BreachVote"]:
        """The process's vote endpoint, or None with no process group (the
        caller then skips voting)."""
        return cls() if _group_up() else None

    @staticmethod
    def _incident(votes, rounds: int) -> str:
        """The gang's incident id over the gathered vote matrix."""
        from libgrape_lite_tpu_torch.obs.gang import incident_id

        return incident_id({
            "kind": "breach_vote",
            "rounds": int(rounds),
            "votes": [[int(x) for x in row]
                      for row in np.asarray(votes).tolist()],
        })

    def _emit_flow(self, rounds: int, halted: bool) -> None:
        """This rank's leg of the vote's flow arrow: every rank shares
        `(cat="gang-vote", id=rounds+1)`."""
        from libgrape_lite_tpu_torch import obs

        tr = obs.tracer()
        if not tr.enabled:
            return
        phase = ("s" if self.rank == 0 else
                 "f" if self.rank == self.nprocs - 1 else "t")
        tr.flow("breach_vote", flow_id=int(rounds) + 1, phase=phase,
                cat="gang-vote", round=int(rounds), halted=bool(halted))

    def round_vote(self, rounds: int,
                   err: Optional[BaseException] = None) -> None:
        """Exchange this superstep's verdict with every rank.  Raises when
        any rank (this one included) voted unhealthy: `err` re-raised
        here, `RemoteBreachError` on healthy ranks; returns only on a
        unanimous healthy vote.  Every raised error carries
        `.gang_incident`."""
        from libgrape_lite_tpu_torch.obs.gang import trace_word

        code = classify_breach_error(err)
        votes = np.asarray(self._allgather(
            np.asarray([code, int(rounds), trace_word()], np.int32)))
        if votes.shape[0] != self.nprocs:
            e = RemoteBreachError(
                f"breach vote returned {votes.shape[0]} rows for "
                f"{self.nprocs} processes", {"rounds": int(rounds)})
            e.gang_incident = self._incident(votes, rounds)
            raise e
        codes = votes[:, 0]
        rds = votes[:, 1]
        healthy = (err is None and np.all(rds == int(rounds))
                   and not np.any(codes != VOTE_HEALTHY))
        self._emit_flow(rounds, halted=not healthy)
        if err is not None:
            # every sibling saw the vote and halts too; the breaching rank
            # keeps its own, more specific error
            try:
                err.gang_incident = self._incident(votes, rounds)
            except AttributeError:  # an error type without a __dict__
                pass
            raise err
        if not np.all(rds == int(rounds)):
            e = RemoteBreachError(
                "breach vote out of lockstep: per-rank supersteps "
                f"{rds.tolist()} (this rank {self.rank} at {int(rounds)})",
                {"rounds": rds.tolist(), "codes": codes.tolist()})
            e.gang_incident = self._incident(votes, rounds)
            raise e
        bad = np.nonzero(codes != VOTE_HEALTHY)[0]
        if bad.size:
            detail = ", ".join(
                f"rank {int(r)}: "
                f"{_VOTE_NAMES.get(int(codes[r]), int(codes[r]))}"
                for r in bad)
            e = RemoteBreachError(
                f"halt voted at superstep {int(rounds)}: {detail} (this "
                f"rank {self.rank} is healthy and halts in lockstep)",
                {"rounds": int(rounds), "ranks": [int(r) for r in bad],
                 "codes": [int(codes[r]) for r in bad]})
            e.gang_incident = self._incident(votes, rounds)
            raise e
