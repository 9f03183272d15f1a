"""Superstep checkpoint/restore.

Counterpart of `libgrape_lite_tpu/ft/checkpoint.py`, with its on-disk
format byte for byte, so a lineage written by either package resumes in
the other.  A superstep boundary is a consistent cut: the whole query is
the carry plus the round counter.  `CheckpointManager` snapshots that cut
at a cadence:

* **overlapped offload** -- `save_async` waits for the previous write,
  then enqueues a non-blocking device-to-host copy of each carry leaf
  into a pinned host buffer on the loop's stream, records a CUDA event
  after the copies, and hands the buffers to one writer thread, which
  waits on that event (never on the whole device) before `np.savez`.
  The superstep loop never blocks on the disk, and the next rounds'
  kernels queue behind the copies on the same stream.  On the CPU the
  copy is a clone of the leaf, read by the writer thread.
* **atomic commit** -- a checkpoint is staged in `.tmp-<rounds>-<pid>`
  and `os.rename`d into place; `meta.json` inside it marks completion,
  so a kill mid-write leaves only a stale temp dir.
* **corruption detection** -- `meta.json` records the sha256 of
  `state.npz`; `restore_latest` walks checkpoints newest-first, rejects
  a fingerprint mismatch and skips a corrupt shard, falling back to the
  previous complete superstep.
* **retention** -- the newest `keep` complete checkpoints survive
  (default 2).

Layout: `<dir>/ckpt_<rounds:08d>/{state.npz, meta.json}`.  A write that
fails raises into the superstep loop at the next `wait()`.  Across ranks
the lineage is sharded (`ft/distributed.py`: a file a rank, a two-phase
commit); `restore_latest` reads both layouts.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from libgrape_lite_tpu_torch import obs
from libgrape_lite_tpu_torch.ft.fingerprint import fingerprint_mismatch
from libgrape_lite_tpu_torch.utils import logging as glog

CKPT_FORMAT = 1
_STEP_RE = re.compile(r"^ckpt_(\d{8})$")


class CheckpointMismatchError(ValueError):
    """The checkpoint belongs to a different computation (app, fragment
    content, mesh shape, query args, or numeric config differ)."""


class CorruptCheckpointError(ValueError):
    """The checkpoint failed its integrity check (sha256 mismatch,
    unreadable metadata, or missing leaves)."""


def _step_path(directory: str, rounds: int) -> str:
    return os.path.join(directory, f"ckpt_{rounds:08d}")


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(rounds, path) of every complete checkpoint, ascending."""
    out = []
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in entries:
        m = _STEP_RE.match(name)
        path = os.path.join(directory, name)
        if m and os.path.exists(os.path.join(path, "meta.json")):
            out.append((int(m.group(1)), path))
    return sorted(out)


def read_meta(step_path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(step_path, "meta.json")) as fh:
            meta = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint metadata in {step_path}: {e}"
        ) from e
    if meta.get("format") != CKPT_FORMAT:
        raise CorruptCheckpointError(
            f"unsupported checkpoint format {meta.get('format')!r} "
            f"in {step_path}"
        )
    return meta


def load_state(step_path: str, meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Read and integrity-check one checkpoint's state leaves."""
    npz_path = os.path.join(step_path, "state.npz")
    try:
        with open(npz_path, "rb") as fh:
            blob = fh.read()
    except OSError as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint shard {npz_path}: {e}"
        ) from e
    digest = hashlib.sha256(blob).hexdigest()
    if digest != meta.get("npz_sha256"):
        raise CorruptCheckpointError(
            f"checkpoint shard {npz_path} failed its integrity check "
            f"(sha256 {digest[:12]}… != recorded "
            f"{str(meta.get('npz_sha256'))[:12]}…)"
        )
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
    except (ValueError, OSError, KeyError) as e:
        raise CorruptCheckpointError(
            f"undecodable checkpoint shard {npz_path}: {e}"
        ) from e
    manifest = meta.get("leaves", {})
    if set(state) != set(manifest):
        raise CorruptCheckpointError(
            f"checkpoint shard {npz_path} leaf set "
            f"{sorted(state)} != manifest {sorted(manifest)}"
        )
    return state


def latest_meta(directory: str) -> Dict[str, Any]:
    """Metadata of the newest complete checkpoint (to replay the query
    args before the fragment-dependent restore); checkpoints with
    unreadable metadata are skipped, as `restore_latest` skips them."""
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(
            f"no complete checkpoint under {directory!r}"
        )
    last_err: Optional[Exception] = None
    for _, path in reversed(steps):
        try:
            return read_meta(path)
        except CorruptCheckpointError as e:
            glog.log_info(f"skipping corrupt checkpoint {path}: {e}")
            last_err = e
    raise CorruptCheckpointError(
        f"every checkpoint under {directory!r} has unreadable metadata; "
        f"last error: {last_err}"
    )


def restore_latest(
    directory: str, expected_fingerprint: Dict[str, Any]
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(state, meta) of the newest usable checkpoint.

    A fingerprint mismatch raises `CheckpointMismatchError` at once
    (resuming a different computation is never safe); a corrupt shard is
    skipped with a log line, falling back to the previous complete
    superstep."""
    t0 = time.perf_counter()
    with obs.tracer().span("checkpoint_restore", dir=directory) as sp:
        state, meta = _restore_latest(directory, expected_fingerprint)
        sp.set(round=int(meta.get("rounds", -1)))
    m = obs.metrics()
    m.counter("grape_checkpoint_restores_total").inc()
    m.histogram("grape_checkpoint_restore_seconds").observe(
        time.perf_counter() - t0
    )
    return state, meta


def _restore_latest(directory: str, expected_fingerprint: Dict[str, Any]):
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(
            f"no complete checkpoint under {directory!r}"
        )
    last_err: Optional[Exception] = None
    for _, path in reversed(steps):
        try:
            meta = read_meta(path)
        except CorruptCheckpointError as e:
            glog.log_info(f"skipping corrupt checkpoint {path}: {e}")
            last_err = e
            continue
        diffs = fingerprint_mismatch(expected_fingerprint,
                                     meta.get("fingerprint", {}))
        if diffs:
            raise CheckpointMismatchError(
                f"checkpoint {path} does not match this query: "
                + "; ".join(diffs)
            )
        try:
            if meta.get("layout") == "sharded":
                # a lineage across ranks (ft/distributed.py): the whole
                # carry gathered from the rank shard files; the
                # fingerprint check above proved the same mesh
                from libgrape_lite_tpu_torch.ft.distributed import (
                    load_sharded_state,
                )

                state = load_sharded_state(path, meta)
            else:
                state = load_state(path, meta)
        except CorruptCheckpointError as e:
            glog.log_info(f"skipping corrupt checkpoint {path}: {e}")
            last_err = e
            continue
        return state, meta
    raise CorruptCheckpointError(
        f"every checkpoint under {directory!r} is corrupt; last error: "
        f"{last_err}"
    )


class CheckpointManager:
    """Writes superstep checkpoints for one query, one write in flight."""

    def __init__(
        self,
        directory: str,
        *,
        fingerprint: Dict[str, Any],
        query_args: Dict[str, Any],
        checkpoint_every: int,
        keep: int = 2,
        fresh_start: bool = False,
    ):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.fingerprint = fingerprint
        self.query_args = query_args
        self.checkpoint_every = checkpoint_every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # a kill mid-write leaves a .tmp-<rounds>-<pid> staging dir (a
        # different pid on resume, so the per-write cleanup never
        # matches it): sweep them all here
        for name in os.listdir(directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
        if fresh_start:
            # a new query (not a resume) starts a new lineage: stale
            # higher-round checkpoints would shadow its snapshots in the
            # retention sweep and in restore_latest's newest-first walk
            for _, path in list_checkpoints(directory):
                shutil.rmtree(path, ignore_errors=True)
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="grape-ckpt")
        self._pending: Optional[Future] = None
        # pinned host buffers, one a leaf, reused across saves: a save
        # first waits for the previous write, so they are free again
        self._pinned: Dict[str, torch.Tensor] = {}

    # ---- save ------------------------------------------------------------

    def _host_copy(self, key: str, v):
        """Start the copy of one leaf to the host; returns what the
        writer thread turns into a numpy array."""
        if not isinstance(v, torch.Tensor):
            return np.array(np.asarray(v))
        if v.device.type != "cuda":
            return v.detach().clone()  # the writer thread reads it
        buf = self._pinned.get(key)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(v, non_blocking=True)
        return buf

    def save_async(self, state: Dict[str, Any], rounds: int, active: int):
        """Snapshot the carry at superstep `rounds` without blocking the
        superstep loop on the copy or the disk; waits only for the
        previous write."""
        with obs.tracer().span("checkpoint_save", round=int(rounds)):
            # the span covers the wait for the previous write and the
            # copies' enqueue -- what the loop pays; serialization lands
            # in the writer thread's checkpoint_write span
            self.wait()
            snap = {k: self._host_copy(k, v) for k, v in state.items()}
            event = None
            if any(isinstance(v, torch.Tensor) and v.is_pinned()
                   for v in snap.values()):
                event = torch.cuda.Event()
                event.record()
            self._pending = self._executor.submit(
                self._write, snap, event, int(rounds), int(active))

    def wait(self) -> None:
        """Block until the in-flight write (if any) is durable; a writer
        failure raises here, into the superstep loop."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._executor.shutdown(wait=True)

    def _write(self, state, event, rounds: int, active: int):
        t0 = time.perf_counter()
        with obs.tracer().span("checkpoint_write", round=rounds) as sp:
            if event is not None:
                # the copies, not the whole device: poll the event (a
                # blocking event wait would count as a host sync)
                while not event.query():
                    time.sleep(1e-4)
            self._write_inner(state, rounds, active, sp)
        m = obs.metrics()
        m.counter("grape_checkpoint_saves_total").inc()
        m.histogram("grape_checkpoint_save_seconds").observe(
            time.perf_counter() - t0
        )

    def _write_inner(self, state, rounds: int, active: int, sp):
        host: Dict[str, np.ndarray] = {}
        for k, v in state.items():
            a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if a.dtype == object:
                raise TypeError(
                    f"state leaf {k!r} has object dtype and cannot be "
                    "checkpointed without pickle (refused: a checkpoint "
                    "must never execute code on restore)"
                )
            host[k] = a
        buf = io.BytesIO()
        np.savez(buf, **host)
        blob = buf.getvalue()
        meta = {
            "format": CKPT_FORMAT,
            "rounds": rounds,
            "active": active,
            "checkpoint_every": self.checkpoint_every,
            "fingerprint": self.fingerprint,
            "query_args": self.query_args,
            "leaves": {
                k: {"shape": list(v.shape), "dtype": v.dtype.str}
                for k, v in host.items()
            },
            "npz_sha256": hashlib.sha256(blob).hexdigest(),
        }
        final = _step_path(self.directory, rounds)
        tmp = os.path.join(self.directory, f".tmp-{rounds}-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "state.npz"), "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        if os.path.exists(final):  # a rollback replay re-saves a round;
            # ignore_errors: a concurrent cleaner may have won the race
            shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        sp.set(bytes=len(blob))
        glog.vlog(1, "checkpoint: superstep %d -> %s (%d bytes)",
                  rounds, final, len(blob))

    def _gc(self) -> None:
        """Retention sweep: keep the newest `keep` complete checkpoints.
        Tolerates concurrent removal -- another process may delete
        entries, or the directory, between the listing and the rmtree;
        retention never takes down a healthy run."""
        try:
            steps = list_checkpoints(self.directory)
        except OSError as e:  # pragma: no cover - listdir race
            glog.vlog(1, "checkpoint gc: listing failed (%s); skipping", e)
            return
        for _, path in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(path, ignore_errors=True)
