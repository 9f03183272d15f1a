"""glog-style leveled logging (the reference's VLOG,
`grape/worker/worker.h:120-139`).

Counterpart of `libgrape_lite_tpu/utils/logging.py`.  The level comes
from GRAPE_TPU_VLOG (default 0: silent) or `set_vlog_level` (`run_app
--profile` sets 1):

* lazy formatting -- `vlog(1, "round %d: %.6fs", r, dt)` formats only
  when the level passes, so a silent level costs one int compare in the
  round loop;
* a rank prefix -- every line carries `r<rank>` (`torch.distributed`'s
  rank once a process group is up, else 0);
* thread safety -- `set_vlog_level` takes a lock; readers do not;
* a tracer sink -- with obs/ armed, every printed line is also a `log`
  instant on the trace timeline.

The port's modules also log through the standard `logging` module; this
module is the JAX package's `glog` surface.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_level = int(os.environ.get("GRAPE_TPU_VLOG", "0"))
_level_lock = threading.Lock()


def set_vlog_level(level: int) -> None:
    global _level
    with _level_lock:
        _level = int(level)


def vlog_level() -> int:
    return _level


def _rank() -> int:
    """The process rank, read on every printed line (a process group may
    start after the first lines)."""
    from libgrape_lite_tpu_torch.obs.metrics import gang_identity

    return gang_identity()[0]


def _emit(line: str, *, level: int) -> None:
    print(line, file=sys.stderr)
    # the same line on the trace timeline when obs/ is armed (imported
    # here: obs modules log through this one)
    try:
        from libgrape_lite_tpu_torch import obs

        tr = obs.tracer()
        if tr.enabled:
            tr.instant("log", msg=line, level=level)
    except Exception:
        pass  # logging never stops the run (interpreter shutdown included)


def vlog(level: int, msg: str, *args) -> None:
    """Leveled log; printf-style `args` are formatted only when `level`
    is at or below the threshold."""
    if level > _level:
        return
    if args:
        msg = msg % args
    ts = time.strftime("%H:%M:%S")
    _emit(f"[grape-tpu r{_rank()} {ts}] {msg}", level=level)


def log_info(msg: str, *args) -> None:
    if args:
        msg = msg % args
    _emit(f"[grape-tpu r{_rank()}] {msg}", level=0)
