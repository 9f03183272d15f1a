"""Retry/backoff policy with typed retryable-error classification.

Counterpart of `libgrape_lite_tpu/ft/retry.py`.  The transient subset of
coordinator hiccups and flaky shared-filesystem reads gets a bounded
exponential-backoff retry instead of failing the job.  One policy object
serves every call site -- the garc cache read (fragment/loader.py) now,
the process-group handshake with the multi-GPU runtime -- so backoff
never diverges between subsystems.

Classification is explicit: a call site passes a `retryable` predicate
(or raises `RetryableError` itself); anything the predicate rejects
propagates unchanged on the first attempt.
"""

from __future__ import annotations

import errno
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from libgrape_lite_tpu_torch.utils import logging as glog

#: seeds the backoff-jitter RNG, so a fault drill that crosses a retry
#: sleeps the same sequence each run; unset = wall-entropy jitter
RETRY_SEED_ENV = "GRAPE_RETRY_SEED"


def _default_rng() -> random.Random:
    seed = os.environ.get(RETRY_SEED_ENV, "")
    if not seed:
        return random.Random()
    try:
        return random.Random(int(seed))
    except ValueError:
        raise ValueError(
            f"{RETRY_SEED_ENV}={seed!r} is not an integer; a typo "
            "must not silently decorrelate a drill that expected "
            "deterministic backoff"
        ) from None


class RetryableError(Exception):
    """Wrap an error a caller positively knows to be transient."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with bounded jitter: the delay before retry i
    (0-based) is `min(base_delay * multiplier**i, max_delay)`, scaled by
    a uniform factor in [1 - jitter, 1 + jitter]."""

    max_attempts: int = 3
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.1

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


#: process-group handshake: ~3 attempts over ~10 s before giving up
DISTRIBUTED_INIT_POLICY = RetryPolicy(max_attempts=3, base_delay=2.0)

#: cache reads: short -- the loader can always rebuild from source text
CACHE_READ_POLICY = RetryPolicy(max_attempts=3, base_delay=0.2, max_delay=2.0)


def with_retries(
    fn: Callable,
    *,
    policy: RetryPolicy = RetryPolicy(),
    retryable: Optional[Callable[[BaseException], bool]] = None,
    describe: str = "",
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
):
    """Call `fn()` under `policy`.  An exception is retried iff it is a
    `RetryableError` or `retryable` returns True for it; everything else
    (and the last attempt's) propagates unchanged."""
    if policy.max_attempts < 1:
        raise ValueError(
            f"max_attempts must be >= 1, got {policy.max_attempts}")
    if rng is None and policy.jitter:
        rng = _default_rng()
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- classification below
            transient = isinstance(e, RetryableError) or (
                retryable is not None and retryable(e))
            if not transient or attempt + 1 >= policy.max_attempts:
                raise
            d = policy.delay(attempt, rng)
            from libgrape_lite_tpu_torch import obs

            obs.metrics().counter("grape_retry_attempts_total").inc()
            obs.tracer().instant(
                "retry", attempt=attempt + 1,
                of=describe or None, delay_s=round(d, 3),
                error=f"{type(e).__name__}: {e}",
            )
            glog.log_info(
                f"retry {attempt + 1}/{policy.max_attempts - 1}"
                f"{' of ' + describe if describe else ''} in {d:.2f}s "
                f"after {type(e).__name__}: {e}"
            )
            sleep(d)
    raise AssertionError("unreachable")  # the loop returns or raises


# ---- classifiers ---------------------------------------------------------

#: phrases of an initialize-order contract violation (a late or
#: duplicate initialize): never transient, never retried
LATE_INIT_PHRASES = (
    "must be called before",
    "before any JAX",
    "already initialized",
    "Distributed initialization should be called before",
    # torch.distributed.init_process_group's double init (a ValueError)
    "initialize the default process group twice",
)

#: phrases a coordinator client surfaces for transient transport faults
_TRANSIENT_DIST_PHRASES = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "timed out",
    "timeout",
    "connection refused",
    "connection reset",
    "failed to connect",
    "temporarily unavailable",
    # torch.distributed's TCPStore rendezvous: a port another process
    # holds, and a peer that has not come up yet
    "address already in use",
    "waiting for clients",
)


def is_late_init_error(exc: BaseException) -> bool:
    """The caller violated the initialize-once contract (torch raises a
    ValueError for a second `init_process_group`)."""
    msg = str(exc)
    return isinstance(exc, (RuntimeError, ValueError)) and any(
        p.lower() in msg.lower() for p in LATE_INIT_PHRASES
    )


def is_transient_distributed_error(exc: BaseException) -> bool:
    """A coordinator handshake failure worth retrying: a transport
    phrase, or torch's `DistNetworkError` (a rendezvous socket that could
    not connect or listen)."""
    if is_late_init_error(exc):
        return False
    msg = str(exc).lower()
    return isinstance(exc, (RuntimeError, ConnectionError, TimeoutError)) and (
        isinstance(exc, (ConnectionError, TimeoutError))
        or type(exc).__name__ == "DistNetworkError"
        or any(p.lower() in msg for p in _TRANSIENT_DIST_PHRASES)
    )


#: OSError subclasses that describe a state of the filesystem, not a
#: transient fault: retrying cannot change the outcome
_PERMANENT_IO = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)

#: errnos of flaky network filesystems and stale NFS handles
_TRANSIENT_ERRNOS = frozenset(
    e for e in (
        errno.EAGAIN, errno.EBUSY, errno.EIO, errno.ESTALE,
        errno.ETIMEDOUT, errno.EINTR,
    ) if e is not None
)


def is_transient_io_error(exc: BaseException) -> bool:
    """A cache-read failure worth retrying (a flaky shared filesystem)."""
    if not isinstance(exc, OSError) or isinstance(exc, _PERMANENT_IO):
        return False
    return exc.errno is None or exc.errno in _TRANSIENT_ERRNOS
