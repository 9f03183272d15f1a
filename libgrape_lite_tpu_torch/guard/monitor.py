"""GuardMonitor: one probe a cadence, the breach policy, rollback state.

Counterpart of `libgrape_lite_tpu/guard/monitor.py`.  The monitor owns
detection and policy; the Worker owns execution (it places restored
state and rewinds its loop counters).  A probe:

  1. host check: the active vote must not exceed `total_vnum` (a
     negative vote is the app's own abort, which ends the loop before
     the monitor sees it);
  2. on the carry's device, every applicable invariant, the carry digest
     and the float residual, read back in ONE transfer (the JAX package
     reads them from one jitted dispatch);
  3. invariant failures -> a breach verdict; otherwise, while the run
     still votes active, the watchdog checks the digest history;
  4. policy: warn logs and continues; halt raises with the diagnostic
     bundle; rollback asks the Worker to restore the last good snapshot
     (it needs a CheckpointManager) and turns paranoid (a probe every
     round), so a deterministic fault is localized on replay.

Watchdog verdicts never roll back: a cycle or stagnation is a property
of the healthy deterministic loop, and a replay would diverge the same
way; they halt (or warn) instead.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

import torch

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.guard.config import GuardConfig
from libgrape_lite_tpu_torch.guard.watchdog import (
    DivergenceWatchdog,
    carry_digest,
    digest_hex,
)
from libgrape_lite_tpu_torch.utils import logging as glog

_HISTORY = 64  # rounds of digest/active context kept for the bundle


class GuardError(RuntimeError):
    """A guard breach under the halt policy (or an exhausted rollback
    budget).  `.bundle` carries the structured diagnostic."""

    def __init__(self, msg: str, bundle: dict):
        super().__init__(msg)
        self.bundle = bundle


class InvariantBreachError(GuardError):
    """An app-declared invariant failed on the live carry."""


class DivergenceError(GuardError):
    """The watchdog proved an oscillation cycle or flagged residual
    stagnation."""


@dataclass
class Breach:
    action: str  # "halt" | "rollback"
    verdict: dict
    bundle: dict
    message: str


def _float_keys(carry: Dict) -> List[str]:
    return sorted(k for k, v in carry.items()
                  if torch.as_tensor(v).is_floating_point())


class GuardMonitor:
    def __init__(self, app, frag, config: GuardConfig, *, ckpt=None):
        self.app = app
        self.frag = frag
        self.config = config
        self.ckpt = ckpt
        self.watchdog = DivergenceWatchdog(config.stagnation_window)
        self.paranoid = False
        self.rollbacks = 0
        self.probes = 0
        self.mutations = 0  # mutation boundaries crossed (dyn/)
        self.breaches: List[dict] = []
        self._invariants = None
        self._digest_hist: List = []
        self._active_hist: List = []
        self._last_breach = None

    # ---- probe construction ---------------------------------------------

    def due(self, rounds: int) -> bool:
        return (
            self.paranoid
            or self.config.every <= 1
            or rounds % self.config.every == 0
        )

    def can_rollback(self) -> bool:
        return self.ckpt is not None

    def on_mutation(self, new_frag) -> None:
        """Mutation-boundary reset (dyn/): the graph, and with it the
        superstep operator, changed, so a digest match against a
        pre-mutation round no longer proves a cycle: the watchdog history
        clears and the invariants re-resolve against the new fragment.
        A pre-mutation snapshot is no rollback target for the rebuilt
        graph, so the checkpoint manager is dropped (a later rollback
        verdict halts)."""
        self.frag = new_frag
        self.mutations += 1
        self.watchdog.reset()
        self._invariants = None
        self.ckpt = None
        obs.tracer().instant("guard_mutation_reset")
        glog.vlog(1, "guard: mutation boundary -- watchdog history reset, "
                  "invariants re-resolve against the mutated fragment")

    def resolve(self, carry: Dict) -> list:
        """The invariants that apply to `carry` (resolved once)."""
        if self._invariants is None:
            self._resolve(carry)
        return self._invariants

    def _resolve(self, carry: Dict) -> None:
        declared = self.app.invariants(self.frag, carry)
        kept, dropped = [], []
        for inv in declared:
            (kept if set(inv.requires) <= set(carry) else dropped).append(inv)
        if dropped:
            glog.log_info(
                "guard: dropped invariants whose carry keys are absent: "
                + ", ".join(i.name for i in dropped))
        self._invariants = kept

    def _probe(self, prev: Dict, cur: Dict):
        """Every invariant's (ok, measure), the digest and the residual,
        computed on the carry's device and read back in one transfer."""
        parts = []
        if self._invariants:
            checks = [inv.check(self.frag.dev, prev, cur)
                      for inv in self._invariants]
            parts.append(torch.stack(
                [t for pair in checks for t in pair]).to(torch.float64))
        dig = carry_digest(cur)
        parts.append(dig.to(torch.float64))  # words < 2^32: exact
        keys = _float_keys(cur)
        if keys:
            d = (torch.cat([cur[k].reshape(-1).to(torch.float32)
                            for k in keys])
                 - torch.cat([prev[k].reshape(-1).to(torch.float32)
                              for k in keys])).abs()
            # a non-finite delta (inf sentinels in both carries, inf ->
            # finite) has no usable magnitude
            d = torch.where(torch.isfinite(d), d, 0.0)
            parts.append((d.max() if d.numel() else d.sum()).to(
                torch.float64).reshape(1))
        host = torch.cat([p.to(dig.device) for p in parts]).tolist()
        n_inv, n_dig = len(self._invariants), dig.numel()
        oks = [bool(host[2 * i]) for i in range(n_inv)]
        vals = [host[2 * i + 1] for i in range(n_inv)]
        digest = tuple(int(x) for x in host[2 * n_inv:2 * n_inv + n_dig])
        residual = host[2 * n_inv + n_dig] if keys else None
        return oks, vals, digest, residual

    # ---- per-probe entry point ------------------------------------------

    def check(self, prev: Dict, cur: Dict, rounds: int, active: int, *,
              probed=None) -> Optional[Breach]:
        """One probe of the carry `cur` after superstep `rounds` against
        the last probed carry `prev`: a Breach for the worker to act on,
        or None while healthy.  `probed` is the probe's (oks, measures,
        digest, residual) when the caller evaluated it already (a guarded
        batch probes every lane in one pass, serve/batch.py)."""
        self.probes += 1
        obs.metrics().counter("grape_guard_probes_total").inc()
        if self._invariants is None:
            self._resolve(cur)
        vnum = self.frag.dev.total_vnum
        if active > vnum:
            verdict = {
                "kind": "active_range",
                "round": rounds,
                "active": int(active),
                "detail": (
                    f"active vote {int(active)} exceeds the vertex count "
                    f"{vnum} -- the termination allreduce is corrupt"
                ),
            }
            return self._policy(verdict, rounds, active, failed=None)

        oks, vals, digest, residual = (probed if probed is not None
                                       else self._probe(prev, cur))
        self._digest_hist.append((rounds, digest_hex(digest)[:16]))
        self._active_hist.append((rounds, int(active)))
        del self._digest_hist[:-_HISTORY], self._active_hist[:-_HISTORY]

        failed = [(inv, float(v))
                  for inv, ok, v in zip(self._invariants, oks, vals)
                  if not ok]
        if failed:
            verdict = {
                "kind": "invariant",
                "round": rounds,
                "failed": {inv.name: v for inv, v in failed},
                "detail": "; ".join(
                    f"{inv.name}: {inv.description} (measure={v:g})"
                    for inv, v in failed
                ),
            }
            return self._policy(
                verdict, rounds, active,
                failed=tuple(inv.name for inv, _ in failed),
            )
        if active > 0:
            # a converged final round repeats the previous digest
            # legitimately: only a still-active loop can be cycling
            verdict = self.watchdog.observe(
                rounds, digest,
                None if residual is None else float(residual),
            )
            if verdict is not None:
                return self._policy(verdict, rounds, active, failed=None)
        return None

    # ---- policy ----------------------------------------------------------

    def _policy(self, verdict: dict, rounds: int, active: int,
                failed) -> Optional[Breach]:
        bundle = self._bundle(verdict, rounds, active)
        self.breaches.append(bundle)
        obs.metrics().counter("grape_guard_breaches_total").inc()
        obs.tracer().instant(
            "guard_breach", kind=verdict["kind"], round=rounds,
            policy=self.config.policy,
            detail=verdict.get("detail", ""),
        )
        from libgrape_lite_tpu_torch.obs.recorder import RECORDER

        RECORDER.trigger(
            "guard_breach",
            extra={"kind": verdict["kind"], "round": rounds,
                   "policy": self.config.policy},
            guard=bundle,
        )
        msg = (
            f"guard: {verdict['kind']} breach at superstep {rounds} "
            f"(policy={self.config.policy}): {verdict['detail']}"
        )
        if self.config.policy == "warn":
            glog.log_info(msg + " -- continuing (warn policy)")
            return None
        action = "halt"
        if self.config.policy == "rollback" and verdict["kind"] == "invariant":
            if not self.can_rollback():
                glog.log_info(
                    "guard: rollback policy without a checkpoint manager "
                    "(no checkpoint_every/checkpoint_dir) -- halting instead")
            elif self.rollbacks > 0 and self._last_breach == (rounds, failed):
                # the paranoid replay reproduced the exact breach: the
                # fault is a deterministic property of this superstep
                glog.log_info(
                    f"guard: breach recurred at superstep {rounds} after a "
                    "rollback -- the fault is deterministic; localized, "
                    "halting")
                bundle["localized_round"] = rounds
            elif self.rollbacks >= self.config.max_rollbacks:
                glog.log_info(
                    f"guard: rollback budget ({self.config.max_rollbacks}) "
                    "exhausted -- halting")
            else:
                action = "rollback"
        elif self.config.policy == "rollback":
            glog.log_info(
                f"guard: {verdict['kind']} verdicts are deterministic "
                "under replay -- halting instead of rolling back")
        self._last_breach = (rounds, failed)
        glog.log_info(msg)
        return Breach(action=action, verdict=verdict, bundle=bundle,
                      message=msg)

    def raise_breach(self, breach: Breach):
        cls = (
            InvariantBreachError
            if breach.verdict["kind"] in ("invariant", "active_range")
            else DivergenceError
        )
        raise cls(breach.message, breach.bundle)

    # ---- rollback --------------------------------------------------------

    def rollback(self, breach: Breach):
        """(restored_state, meta) of the last good snapshot; turns the
        monitor paranoid and resets the watchdog history (replayed rounds
        must not match their own old digests)."""
        from libgrape_lite_tpu_torch.ft.checkpoint import restore_latest

        self.ckpt.wait()  # an in-flight write lands before the listing
        with obs.tracer().span("rollback",
                               breach_round=breach.verdict["round"]):
            state, meta = restore_latest(self.ckpt.directory,
                                         self.ckpt.fingerprint)
        self.rollbacks += 1
        obs.metrics().counter("grape_guard_rollbacks_total").inc()
        self.paranoid = True
        self.watchdog.reset()
        glog.log_info(
            f"guard: rolled back to superstep {int(meta['rounds'])} "
            f"(breach at superstep {breach.verdict['round']}, "
            f"rollback {self.rollbacks}/{self.config.max_rollbacks}); "
            "replaying in paranoid mode")
        return state, meta

    # ---- diagnostics -----------------------------------------------------

    def _bundle(self, verdict: dict, rounds: int, active: int) -> dict:
        try:
            from libgrape_lite_tpu_torch.ft.fingerprint import (
                app_registry_name,
                fragment_content_hash,
            )

            fingerprint = (
                dict(self.ckpt.fingerprint) if self.ckpt is not None else {
                    "app": app_registry_name(self.app),
                    "fragment_hash": fragment_content_hash(self.frag),
                    "fnum": self.frag.fnum,
                    "vp": self.frag.vp,
                }
            )
        except Exception as e:  # diagnostics never mask the breach
            fingerprint = {"error": f"{type(e).__name__}: {e}"}
        return {
            "verdict": dict(verdict),
            "round": rounds,
            "active": int(active),
            # None when obs/ is disarmed; armed, it ties the bundle to
            # the trace file's metadata
            "trace_id": obs.trace_id(),
            "policy": self.config.policy,
            "paranoid": self.paranoid,
            "rollbacks": self.rollbacks,
            "recent_digests": list(self._digest_hist),
            "active_history": list(self._active_hist),
            "invariants": [i.name for i in (self._invariants or [])],
            # the JAX package's TPU pack-planner op ledger: the port has
            # no pack planner
            "op_ledger": None,
            "config_fingerprint": fingerprint,
            "guard_config": asdict(self.config),
        }

    def report(self) -> dict:
        return {
            "policy": self.config.policy,
            "every": self.config.every,
            "probes": self.probes,
            "paranoid": self.paranoid,
            "rollbacks": self.rollbacks,
            "mutations": self.mutations,
            "breaches": list(self.breaches),
            "invariants": [i.name for i in (self._invariants or [])],
        }
