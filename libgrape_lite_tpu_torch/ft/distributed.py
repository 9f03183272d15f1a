"""Resilience across ranks: sharded two-phase checkpoints and the reshard.

Counterpart of `libgrape_lite_tpu/ft/distributed.py`, with its on-disk
layout byte for byte, so a lineage written by either package restores in
the other.  Under a process group every rank holds only its slab of the
carry (`[fl, vp]`, fragment rows `fid_lo .. fid_lo + fl - 1`), so
`CheckpointManager`'s single `state.npz` cannot be written by any one
rank.  `ShardedCheckpointManager` keeps the same superstep-cut contract
with a file a rank:

    <dir>/ckpt_<rounds:08d>/{rank_<r>.npz, rank_<r>.json, meta.json}

committed by a **two-phase barrier** over the host-side control plane
(`parallel.comm_spec.host_allgather`):

* **phase 1 (stage)** -- every rank writes its slab rows (by global
  fragment id) and the `__oids_<f>` vertex maps of those rows into a
  shared `.stage-<rounds:08d>` directory, then votes (ok, rounds, a
  sha256 prefix).  A rank-local IO failure turns into an all-ranks error
  at this barrier instead of a stranded peer.
* **phase 2 (commit)** -- the coordinator re-hashes every staged shard
  against its vote, writes `meta.json` (`"layout": "sharded"`, a
  manifest a rank) into the stage and renames it to `ckpt_<rounds:08d>`.
  A second barrier makes every rank's return mean durable (the
  kill-after-checkpoint contract).

`meta.json` appears only inside a verified directory and the rename is
atomic, so a kill between the phases leaves a `.stage-*` partial that
`list_checkpoints` / `restore_latest` never adopt; the next manager
construction sweeps it, with a log line.  The checkpoint directory must
be on a file system every rank shares (the ranks of one host do).

Restore has two shapes:

* the same mesh -- `ft.checkpoint.restore_latest` recognises the sharded
  layout and gathers the whole carry on the host (`load_sharded_state`),
  every shard checked against the committed manifest; the worker keeps
  its slab's rows;
* a reshard after a loss -- `restore_resharded` rebuilds the old mesh's
  vertex map from the stored `__oids_<f>` arrays (`_CheckpointLayout`),
  aligns it to the new fragment by oid (`fragment.mutation.
  oid_row_alignment`), scatters the old `[fnum, vp]` carry onto the new
  layout, and records the surviving mesh's 1d / 2d decision in the
  partition ledger.  Geometry (fnum, vp, fragment content hash, process
  count) may differ; every other fingerprint field must match.

The collectives here are host-side and synchronous on purpose: a barrier
in a writer thread could interleave with the main thread's collectives
and deadlock the gang, so unlike `CheckpointManager` there is no writer
thread; `save_async` keeps the name (the worker drives both managers
through one interface) and returns after the commit.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.ft.checkpoint import (
    CKPT_FORMAT,
    CheckpointMismatchError,
    CorruptCheckpointError,
    _step_path,
    list_checkpoints,
    read_meta,
)
from libgrape_lite_tpu_torch.ft.faults import maybe_kill_between_phases
from libgrape_lite_tpu_torch.ft.fingerprint import fingerprint_mismatch
from libgrape_lite_tpu_torch.parallel.comm_spec import is_slab
from libgrape_lite_tpu_torch.utils import logging as glog

#: fingerprint keys a reshard restore may change; every other key (app,
#: app_class, query_args, x64, spmv_mode, partition_mode) must match
GEOMETRY_KEYS = ("fnum", "vp", "fragment_hash", "processes")

_OIDS_PREFIX = "__oids_"
_STAGE_PREFIX = ".stage-"


class _HostComm:
    """The control plane a two-phase commit needs: this rank, the rank
    count, and a host-side allgather of a small int32 vector (by default
    `torch.distributed`'s identity and `host_allgather`).  Injectable, so
    the commit protocol is testable in one process."""

    def __init__(self, rank: Optional[int] = None,
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

    def allgather(self, vec: np.ndarray) -> np.ndarray:
        out = np.asarray(self._allgather(np.asarray(vec, np.int32)))
        if out.shape[0] != self.nprocs:
            raise RuntimeError(f"host allgather returned {out.shape[0]} "
                               f"rows for {self.nprocs} processes")
        return out

    def barrier(self) -> None:
        self.allgather(np.zeros(1, np.int32))


def _sha_prefix(sha_hex: str) -> Tuple[int, int]:
    # two 28-bit chunks, int32-safe in the vote; the commit phase still
    # checks the whole sha256 against the staged file
    return int(sha_hex[:7], 16), int(sha_hex[7:14], 16)


def _obs_trace_word() -> int:
    """The 28-bit trace-id prefix riding the commit votes (0 disarmed):
    the gathered matrix names every rank's trace file.  Readers use only
    the columns they need, so 4-wide fakes keep working."""
    from libgrape_lite_tpu_torch.obs.gang import trace_word

    return trace_word()


def _ckpt_flow(comm, rounds: int, leg: str) -> None:
    """One flow leg per commit barrier: every rank shares `(cat=
    "gang-ckpt", id=rounds+1)`, so the merged gang trace draws stage ->
    commit as one arrow across the rank tracks.  A no-op disarmed."""
    tr = obs.tracer()
    if not tr.enabled:
        return
    if leg == "stage":
        phase = "s" if comm.rank == 0 else "t"
    else:
        phase = "f" if comm.rank == comm.nprocs - 1 else "t"
    tr.flow(f"ckpt_{leg}", flow_id=int(rounds) + 1, phase=phase,
            cat="gang-ckpt", round=int(rounds))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _extract_local(leaf, frag, replicated: bool = False):
    """(rows, block) of this rank's part of one carry leaf: `rows` the
    global fragment ids it holds (None for a leaf every rank holds whole),
    `block` the host array in `rows` order.  A rank of a group holds
    fragment rows `fid_lo .. fid_lo + fl - 1` as its slab leaves' rows
    0 .. fl - 1 (`comm_spec.is_slab`); with one process (`fl == fnum`) it
    holds them all."""
    a = _host(leaf)
    fl = int(getattr(frag, "fl", frag.fnum))
    lo = int(getattr(frag, "fid_lo", 0))
    if is_slab(a, fl, replicated):
        return list(range(lo, lo + fl)), a
    return None, a


class ShardedCheckpointManager:
    """A shard file a rank and the two-phase commit barrier: the
    multi-process `CheckpointManager` (the same `save_async` / `wait` /
    `close` surface).  `replicated_keys` names the carry leaves every
    rank holds whole (the app's `replicated_keys`)."""

    def __init__(self, directory: str, *, fingerprint: Dict[str, Any],
                 query_args: Dict[str, Any], checkpoint_every: int, frag,
                 keep: int = 2, fresh_start: bool = False,
                 comm: Optional[_HostComm] = None,
                 replicated_keys=frozenset()):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.fingerprint = fingerprint
        self.query_args = query_args
        self.checkpoint_every = checkpoint_every
        self.keep = keep
        self.frag = frag
        self.replicated_keys = frozenset(replicated_keys)
        self.comm = comm if comm is not None else _HostComm()
        if self.comm.rank == 0:
            os.makedirs(directory, exist_ok=True)
            for name in os.listdir(directory):
                # a kill between the phases leaves a staged partial:
                # never adoptable (no meta.json outside a committed
                # directory), but loud: silence would hide that a gang
                # died inside the commit window
                if name.startswith((_STAGE_PREFIX, ".tmp-")):
                    glog.log_info(f"checkpoint: sweeping partial {name!r} "
                                  "(a previous run died before its commit "
                                  "phase)")
                    shutil.rmtree(os.path.join(directory, name),
                                  ignore_errors=True)
            if fresh_start:  # a new query starts a new lineage
                for _, path in list_checkpoints(directory):
                    shutil.rmtree(path, ignore_errors=True)
        # no rank stages into a directory the coordinator still sweeps
        self.comm.barrier()
        os.makedirs(directory, exist_ok=True)

    # ---- save ------------------------------------------------------------

    def save_async(self, state: Dict[str, Any], rounds: int, active: int):
        """Stage and commit the superstep-`rounds` snapshot.  Synchronous
        despite the name: the phase barriers are collectives and run on
        the caller's thread, in lockstep with the rounds' collectives."""
        t0 = time.perf_counter()
        with obs.tracer().span("checkpoint_save_sharded",
                               round=int(rounds)) as sp:
            self._save(state, int(rounds), int(active), sp)
        m = obs.metrics()
        m.counter("grape_checkpoint_saves_total").inc()
        m.histogram("grape_checkpoint_save_seconds").observe(
            time.perf_counter() - t0)

    def wait(self) -> None:
        """No write is in flight: `save_async` returns after the commit
        barrier."""

    def close(self) -> None:
        pass

    def _save(self, state, rounds: int, active: int, sp) -> None:
        stage = os.path.join(self.directory, f"{_STAGE_PREFIX}{rounds:08d}")
        ok, sha_hex, stage_err = 1, "0" * 64, None
        try:
            os.makedirs(stage, exist_ok=True)
            sha_hex, nbytes = self._stage_local(state, rounds, active, stage)
            sp.set(bytes=nbytes)
        except Exception as e:  # voted, not raised: the barrier turns a
            ok, stage_err = 0, e  # local failure into a gang-wide one
        lo, hi = _sha_prefix(sha_hex)
        votes = self.comm.allgather(np.asarray(
            [ok, rounds, lo, hi, _obs_trace_word()], np.int32))
        _ckpt_flow(self.comm, rounds, "stage")
        if not np.all(votes[:, 0] == 1):
            bad = np.nonzero(votes[:, 0] != 1)[0].tolist()
            raise CorruptCheckpointError(
                f"checkpoint stage failed on rank(s) {bad} at superstep "
                f"{rounds}; no rank commits") from stage_err
        if not np.all(votes[:, 1] == rounds):
            raise RuntimeError(
                "two-phase commit out of lockstep: per-rank supersteps "
                f"{votes[:, 1].tolist()} (this rank at {rounds})")
        maybe_kill_between_phases(rounds, self.comm.rank)
        committed, commit_err = 1, None
        if self.comm.rank == 0:
            try:
                self._commit(stage, rounds, active, votes)
            except Exception as e:
                committed, commit_err = 0, e
        done = self.comm.allgather(np.asarray(
            [committed, rounds, _obs_trace_word()], np.int32))
        _ckpt_flow(self.comm, rounds, "commit")
        if not np.all(done[:, 0] == 1):
            raise CorruptCheckpointError(
                f"two-phase commit failed in the commit phase at superstep "
                f"{rounds} (the coordinator could not certify every staged "
                "shard)") from commit_err

    def _stage_local(self, state, rounds: int, active: int,
                     stage: str) -> Tuple[str, int]:
        payload: Dict[str, np.ndarray] = {}
        leafmeta: Dict[str, Any] = {}
        owned: set = set()
        fnum = int(self.frag.fnum)
        for k in sorted(state):
            if k.startswith(_OIDS_PREFIX):
                raise ValueError(
                    f"carry leaf {k!r} collides with the reserved "
                    f"{_OIDS_PREFIX}* vertex-map namespace")
            rows, block = _extract_local(state[k], self.frag,
                                         k in self.replicated_keys)
            if block.dtype == object:
                raise TypeError(
                    f"state leaf {k!r} has object dtype and cannot be "
                    "checkpointed without pickle (refused: a checkpoint "
                    "must never execute code on restore)")
            payload[k] = block
            if rows is None:
                leafmeta[k] = {"replicated": True,
                               "shape": list(block.shape),
                               "dtype": block.dtype.str}
            else:
                owned.update(rows)
                leafmeta[k] = {"rows": rows,
                               "shape": [fnum] + list(block.shape[1:]),
                               "dtype": block.dtype.str}
        if not owned and self.comm.rank == 0:
            # an all-replicated carry still needs the vertex maps for a
            # later reshard: the coordinator owns them
            owned = set(range(fnum))
        oid_rows = sorted(owned)
        for f in oid_rows:
            payload[f"{_OIDS_PREFIX}{f}"] = np.asarray(
                self.frag.inner_oids(f), np.int64)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        blob = buf.getvalue()
        sha = hashlib.sha256(blob).hexdigest()
        npz = os.path.join(stage, f"rank_{self.comm.rank}.npz")
        with open(npz + ".part", "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.rename(npz + ".part", npz)
        rank_meta = {
            "rank": self.comm.rank,
            "rounds": rounds,
            "active": active,
            "sha256": sha,
            "leaves": leafmeta,
            "oid_rows": oid_rows,
            "vp": int(self.frag.vp),
        }
        with open(os.path.join(stage, f"rank_{self.comm.rank}.json"),
                  "w") as fh:
            json.dump(rank_meta, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        return sha, len(blob)

    def _commit(self, stage: str, rounds: int, active: int,
                votes: np.ndarray) -> None:
        """The coordinator's quorum check and atomic rename: every rank's
        staged shard exists, hashes to its voted sha256, and together they
        cover every fragment row exactly once."""
        shards: Dict[str, Any] = {}
        leaves: Dict[str, Any] = {}
        covered: Dict[str, List[int]] = {}
        oid_cover: set = set()
        for r in range(self.comm.nprocs):
            npz = os.path.join(stage, f"rank_{r}.npz")
            try:
                with open(npz, "rb") as fh:
                    blob = fh.read()
                with open(os.path.join(stage, f"rank_{r}.json")) as fh:
                    rank_meta = json.load(fh)
            except OSError as e:
                raise CorruptCheckpointError(
                    f"rank {r} voted its stage complete but its shard is "
                    f"unreadable: {e}") from e
            sha = hashlib.sha256(blob).hexdigest()
            lo, hi = _sha_prefix(sha)
            if sha != rank_meta.get("sha256") or (
                    lo != int(votes[r, 2]) or hi != int(votes[r, 3])):
                raise CorruptCheckpointError(
                    f"rank {r} staged shard hash {sha[:12]}… does not "
                    "match its vote/manifest — refusing to commit")
            shards[str(r)] = {"sha256": sha, "leaves": rank_meta["leaves"],
                              "oid_rows": rank_meta["oid_rows"]}
            oid_cover.update(rank_meta["oid_rows"])
            for k, lm in rank_meta["leaves"].items():
                prev = leaves.setdefault(
                    k, {"shape": lm["shape"], "dtype": lm["dtype"]})
                if (prev["shape"] != lm["shape"]
                        or prev["dtype"] != lm["dtype"]):
                    raise CorruptCheckpointError(
                        f"leaf {k!r}: rank {r} disagrees on global "
                        "shape/dtype")
                if not lm.get("replicated"):
                    covered.setdefault(k, []).extend(lm["rows"])
        every = set(range(self.frag.fnum))
        for k, rows in covered.items():
            if sorted(rows) != sorted(every):
                raise CorruptCheckpointError(
                    f"leaf {k!r}: staged rows {sorted(rows)} do not cover "
                    f"fragment rows {sorted(every)} exactly once")
        if covered and oid_cover != every:
            raise CorruptCheckpointError(
                f"staged vertex maps cover rows {sorted(oid_cover)}, not "
                f"{sorted(every)}")
        meta = {
            "format": CKPT_FORMAT,
            "layout": "sharded",
            "ranks": self.comm.nprocs,
            "fnum": int(self.frag.fnum),
            "vp": int(self.frag.vp),
            "rounds": rounds,
            "active": active,
            "checkpoint_every": self.checkpoint_every,
            "fingerprint": self.fingerprint,
            "query_args": self.query_args,
            "leaves": leaves,
            "shards": shards,
        }
        with open(os.path.join(stage, "meta.json"), "w") as fh:
            json.dump(meta, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        final = _step_path(self.directory, rounds)
        if os.path.exists(final):  # a rollback replay re-saves a round
            shutil.rmtree(final, ignore_errors=True)
        os.rename(stage, final)
        self._gc()
        glog.vlog(1, "checkpoint: superstep %d -> %s (%d rank shards)",
                  rounds, final, self.comm.nprocs)

    def _gc(self) -> None:
        try:
            steps = list_checkpoints(self.directory)
        except OSError:  # pragma: no cover - a listdir race
            return
        for _, path in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(path, ignore_errors=True)


# ---- restore ---------------------------------------------------------------


def _read_rank_npz(step_path: str, r: str, info: Dict[str, Any]):
    npz = os.path.join(step_path, f"rank_{r}.npz")
    try:
        with open(npz, "rb") as fh:
            blob = fh.read()
    except OSError as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint shard {npz}: {e}") from e
    sha = hashlib.sha256(blob).hexdigest()
    if sha != info.get("sha256"):
        raise CorruptCheckpointError(
            f"checkpoint shard {npz} failed its integrity check (sha256 "
            f"{sha[:12]}… != recorded {str(info.get('sha256'))[:12]}…)")
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (ValueError, OSError, KeyError) as e:
        raise CorruptCheckpointError(
            f"undecodable checkpoint shard {npz}: {e}") from e


def _by_rank(meta):
    return sorted(meta.get("shards", {}).items(), key=lambda kv: int(kv[0]))


def load_sharded_state(step_path: str,
                       meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The whole `[fnum, vp]` carry gathered on the host from every rank's
    shard: the sharded `load_state`, with its integrity contract (a sha256
    a shard, leaf and row coverage against the committed manifest)."""
    manifest = meta.get("leaves", {})
    fnum = int(meta["fnum"])
    out: Dict[str, np.ndarray] = {}
    seen_rows: Dict[str, set] = {}
    for r, info in _by_rank(meta):
        arrays = _read_rank_npz(step_path, r, info)
        for k, lm in info["leaves"].items():
            if k not in arrays:
                raise CorruptCheckpointError(
                    f"rank {r} shard is missing leaf {k!r}")
            a = arrays[k]
            if lm.get("replicated"):
                prev = out.get(k)
                if prev is None:
                    out[k] = a
                elif (prev.shape != a.shape or prev.dtype != a.dtype
                      or prev.tobytes() != a.tobytes()):
                    # a replicated leaf is byte-identical on every rank;
                    # a divergence means the gang staged out of lockstep
                    raise CorruptCheckpointError(
                        f"replicated leaf {k!r} diverges across shard "
                        f"files (rank {r} copy != earlier ranks')")
                continue
            dst = out.setdefault(k, np.empty(tuple(lm["shape"]),
                                             dtype=np.dtype(lm["dtype"])))
            rows = lm["rows"]
            if a.shape[0] != len(rows):
                raise CorruptCheckpointError(
                    f"rank {r} leaf {k!r} block has {a.shape[0]} rows for "
                    f"manifest rows {rows}")
            for i, row in enumerate(rows):
                dst[row] = a[i]
            seen_rows.setdefault(k, set()).update(rows)
    for k, rows in seen_rows.items():
        if rows != set(range(fnum)):
            raise CorruptCheckpointError(
                f"leaf {k!r}: shard files cover rows {sorted(rows)}, not "
                f"0..{fnum - 1}")
    if set(out) != set(manifest):
        raise CorruptCheckpointError(
            f"sharded checkpoint leaf set {sorted(out)} != manifest "
            f"{sorted(manifest)}")
    return out


def load_shard_layout(step_path: str,
                      meta: Dict[str, Any]) -> Dict[int, np.ndarray]:
    """{fragment row: inner oids} of the checkpointed mesh, from the
    `__oids_<f>` arrays its shards carry."""
    fnum = int(meta["fnum"])
    oids: Dict[int, np.ndarray] = {}
    for r, info in meta.get("shards", {}).items():
        arrays = _read_rank_npz(step_path, r, info)
        for f in info.get("oid_rows", []):
            key = f"{_OIDS_PREFIX}{f}"
            if key not in arrays:
                raise CorruptCheckpointError(
                    f"rank {r} shard is missing vertex map {key!r}")
            oids[int(f)] = np.asarray(arrays[key], np.int64)
    if set(oids) != set(range(fnum)):
        raise CorruptCheckpointError(
            f"shard vertex maps cover rows {sorted(oids)}, not "
            f"0..{fnum - 1}")
    return oids


class _CheckpointLayout:
    """The checkpointed mesh's fragment as `oid_row_alignment` reads it
    (fnum, vp, inner_oids, oid_to_pid), rebuilt from the `__oids_<f>`
    arrays alone: the dead mesh is never rebuilt to migrate its carry."""

    def __init__(self, fnum: int, vp: int,
                 oids_by_row: Dict[int, np.ndarray]):
        self.fnum = int(fnum)
        self.vp = int(vp)
        self._oids = oids_by_row
        z = np.zeros(0, np.int64)
        all_oids = (np.concatenate([oids_by_row[f]
                                    for f in range(self.fnum)])
                    if self.fnum else z)
        all_pids = (np.concatenate([
            f * self.vp + np.arange(len(oids_by_row[f]), dtype=np.int64)
            for f in range(self.fnum)]) if self.fnum else z)
        order = np.argsort(all_oids, kind="stable")
        self._sorted_oids = all_oids[order]
        self._sorted_pids = all_pids[order]

    def inner_oids(self, f: int) -> np.ndarray:
        return self._oids[int(f)]

    def pid_to_oid(self, pids) -> np.ndarray:
        """The oids of old-mesh pids (an app's `inc_value_map` reads its
        pid-valued leaves through it)."""
        pids = np.asarray(pids, np.int64)
        return np.asarray([self._oids[int(p) // self.vp][int(p) % self.vp]
                           for p in pids.reshape(-1)],
                          np.int64).reshape(pids.shape)

    def oid_to_pid(self, oids) -> np.ndarray:
        oids = np.asarray(oids, np.int64)
        if not len(self._sorted_oids):
            return np.full(oids.shape, -1, np.int64)
        idx = np.searchsorted(self._sorted_oids, oids)
        idx = np.minimum(idx, len(self._sorted_oids) - 1)
        hit = self._sorted_oids[idx] == oids
        return np.where(hit, self._sorted_pids[idx], -1)


def restore_resharded(
    directory: str, new_frag, expected_fingerprint: Dict[str, Any], *,
    base_state: Dict[str, np.ndarray], value_map=None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(state, meta) of the newest usable sharded checkpoint, resharded
    onto `new_frag`'s layout: the survivors-on-a-smaller-fnum restore.
    The fingerprint's geometry (GEOMETRY_KEYS) may differ, every other
    field must match; the vertex universes must be identical (the same
    graph cut another way); `base_state` is the new mesh's freshly
    initialised `[fnum, vp]` carry, so padding rows keep their init
    values.  Walks newest-first like `restore_latest`: a mismatch raises,
    a corrupt shard falls back a checkpoint.  `value_map(key, values,
    old_layout, new_frag)` re-addresses a leaf's values before the scatter
    (the worker passes the app's `inc_value_map`: WCC's labels are pids);
    None copies them as they are, as the JAX function does."""
    t0 = time.perf_counter()
    with obs.tracer().span("checkpoint_restore_resharded",
                           dir=directory) as sp:
        state, meta = _restore_resharded(directory, new_frag,
                                         expected_fingerprint, base_state,
                                         value_map)
        sp.set(round=int(meta.get("rounds", -1)))
    m = obs.metrics()
    m.counter("grape_checkpoint_restores_total").inc()
    m.counter("grape_checkpoint_reshards_total").inc()
    m.histogram("grape_checkpoint_restore_seconds").observe(
        time.perf_counter() - t0)
    return state, meta


def _reshard_fingerprint_check(path, expected, found):
    exp = {k: v for k, v in expected.items() if k not in GEOMETRY_KEYS}
    fnd = {k: v for k, v in found.items() if k not in GEOMETRY_KEYS}
    diffs = fingerprint_mismatch(exp, fnd)
    if diffs:
        raise CheckpointMismatchError(
            f"checkpoint {path} does not match this query (beyond mesh "
            "geometry, which a reshard may change): " + "; ".join(diffs))


def _restore_resharded(directory, new_frag, expected_fingerprint,
                       base_state, value_map=None):
    from libgrape_lite_tpu_torch.fragment.mutation import oid_row_alignment

    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {directory!r}")
    last_err: Optional[Exception] = None
    picked = None
    for _, path in reversed(steps):
        try:
            meta = read_meta(path)
        except CorruptCheckpointError as e:
            glog.log_info(f"skipping corrupt checkpoint {path}: {e}")
            last_err = e
            continue
        if meta.get("layout") != "sharded":
            raise CheckpointMismatchError(
                f"checkpoint {path} was written single-process (no "
                "per-rank shard files or vertex maps); resume it on its "
                "original mesh instead of resharding")
        _reshard_fingerprint_check(path, expected_fingerprint,
                                   meta.get("fingerprint", {}))
        try:
            state = load_sharded_state(path, meta)
            oids = load_shard_layout(path, meta)
        except CorruptCheckpointError as e:
            glog.log_info(f"skipping corrupt checkpoint {path}: {e}")
            last_err = e
            continue
        picked = (path, meta, state, oids)
        break
    if picked is None:
        raise CorruptCheckpointError(
            f"every checkpoint under {directory!r} is corrupt; last error: "
            f"{last_err}")
    path, meta, state, oids = picked
    layout = _CheckpointLayout(meta["fnum"], meta["vp"], oids)
    # the same graph, another cut: the vertex universes must be identical
    # (a missing oid means another graph, and resuming would compute
    # garbage)
    old_u = np.sort(np.concatenate([oids[f] for f in range(layout.fnum)]))
    new_u = np.sort(np.concatenate([
        np.asarray(new_frag.inner_oids(f), np.int64)
        for f in range(new_frag.fnum)]))
    if old_u.shape != new_u.shape or not np.array_equal(old_u, new_u):
        raise CheckpointMismatchError(
            f"checkpoint {path} covers {old_u.size} vertices but the "
            f"restore fragment holds {new_u.size}; the vertex universes "
            "differ — this is a different graph, not a reshard")
    of, ol, nf, nl = oid_row_alignment(layout, new_frag)
    out: Dict[str, np.ndarray] = {}
    for k, v in state.items():
        if k not in base_state:
            raise CheckpointMismatchError(
                f"checkpoint carry leaf {k!r} has no counterpart in this "
                "query's carry")
        b = np.array(_host(base_state[k]))
        if value_map is not None:
            v = np.asarray(value_map(k, v, layout, new_frag))
        if (v.ndim >= 2 and v.shape[:2] == (layout.fnum, layout.vp)
                and b.shape[:2] == (new_frag.fnum, new_frag.vp)
                and v.shape[2:] == b.shape[2:]):
            b[nf, nl] = v[of, ol]
        elif v.shape == b.shape:
            b[...] = v
        else:
            raise CheckpointMismatchError(
                f"carry leaf {k!r}: cannot reshard shape {tuple(v.shape)} "
                f"onto {tuple(b.shape)}")
        out[k] = b
    # the surviving mesh's partition decision, in the ledger: the
    # checkpointed carry is a 1-D edge cut, so a 2d / auto request during
    # a reshard is a recorded decline, never a silent downgrade
    from libgrape_lite_tpu_torch.fragment.partition import (
        partition_mode,
        resolve_partition,
    )

    if partition_mode() != "1d":
        z = np.zeros(0, np.int64)
        resolve_partition(
            str(meta.get("fingerprint", {}).get("app", "?")),
            new_frag.fnum, z, z, z, eligible=False,
            reason=("reshard restore: the checkpointed carry is 1-D "
                    f"edge-cut layout (fnum {layout.fnum} -> "
                    f"{new_frag.fnum}); re-partitioning mid-query would "
                    "change the superstep operator"))
    glog.log_info(
        f"resharded checkpoint {path}: fnum {layout.fnum} -> "
        f"{new_frag.fnum} (vp {layout.vp} -> {new_frag.vp}) at superstep "
        f"{int(meta['rounds'])}")
    meta = dict(meta)
    meta["resharded_from"] = {"fnum": layout.fnum, "vp": layout.vp,
                              "ranks": meta.get("ranks")}
    return out, meta
