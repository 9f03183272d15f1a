"""Superstep driver.

Counterpart of `libgrape_lite_tpu/worker/worker.py` (reference
`grape/worker/worker.h:48-232`).  `query` runs PEval, then IncEval while
the active vote is positive and fewer than the round limit have run --
the semantics of the JAX package's fused `while_loop` runner, with
`rounds` counting IncEval calls.  Here the loop runs on the host and
reads the vote back each round.  Apps with `host_only` set run their
own round loop (`host_compute`) instead.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import AppBase, StepContext
from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment

_INT32_MAX = np.iinfo(np.int32).max


def _place(v, device: torch.device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v, order="C")).to(device)
    return torch.as_tensor(v, device=device)


class Worker:
    """Binds an app to a fragment and runs queries
    (reference `Worker<APP_T, MESSAGE_MANAGER_T>`)."""

    def __init__(self, app: AppBase, fragment: ShardedEdgecutFragment):
        self.app = app
        self.fragment = fragment
        self.rounds = 0
        self._result_state = None

    def query(self, max_rounds: int | None = None, *,
              initial_state: Dict | None = None, **query_args):
        """Run one query (reference `Worker::Query`, worker.h:104-146).

        `initial_state` (numpy arrays or tensors) replaces entries of the
        state `init_state` built, before PEval runs; every key must be
        one that `init_state` produced."""
        app, frag = self.app, self.fragment
        mr = app.max_rounds if max_rounds is None else max_rounds
        if getattr(app, "host_only", False):
            return self._query_host(mr, initial_state, query_args)
        state = app.init_state(frag, **query_args)
        for k, v in (initial_state or {}).items():
            if k not in state:
                raise KeyError(f"initial_state key {k!r} is not a state key "
                               f"of {type(app).__name__}")
            state[k] = v
        state = {k: _place(v, frag.device) for k, v in state.items()}

        ctx = StepContext()
        state, active = app.peval(ctx, frag.dev, state)
        active = int(active)
        limit = mr if mr > 0 else _INT32_MAX
        rounds = 0
        while active > 0 and rounds < limit:
            state, active = app.inceval(ctx, frag.dev, state)
            active = int(active)  # the termination vote, read back
            rounds += 1
        self.rounds = rounds
        return self._keep(state)

    def _query_host(self, mr: int, initial_state, query_args):
        """Host-driven apps (the exchange apps: capacity retries, bucket
        advances and push/pull switches decide each round on the host)
        run their own loop, under the same round limit (JAX
        `worker.py:1208-1230`)."""
        app = self.app
        if initial_state:
            raise ValueError(f"{type(app).__name__} runs its own host loop "
                             "and takes no initial_state")
        state = app.host_compute(self.fragment, max_rounds=mr, **query_args)
        self.rounds = app.rounds
        return self._keep(state)

    def _keep(self, state: Dict) -> Dict:
        eph = self.app.ephemeral_keys
        self._result_state = {
            k: v for k, v in state.items() if k not in eph
        }
        return self._result_state

    # ---- Output / Assemble (reference worker.h:148-154, ctx.Output) ----

    def result_values(self) -> np.ndarray:
        """Per-vertex assembled values, [fnum, vp] numpy."""
        if self._result_state is None:
            raise RuntimeError("query() first")
        host = {k: v.cpu() for k, v in self._result_state.items()}
        return self.app.finalize(self.fragment, host)

    def output(self, prefix: str) -> None:
        """Write per-fragment result files `result_frag_<fid>` with
        `oid value` lines (reference `GetResultFilename` + ctx Output)."""
        values = self.result_values()
        os.makedirs(prefix, exist_ok=True)
        fmt = self.app.result_format
        for f in range(self.fragment.fnum):
            n = self.fragment.inner_vertices_num(f)
            oids = self.fragment.inner_oids(f)
            path = os.path.join(prefix, f"result_frag_{f}")
            with open(path, "w") as out:
                out.write(format_result_lines(oids, values[f, :n], fmt))


def format_result_lines(oids, vals, fmt: str) -> str:
    if len(oids) == 0:
        return ""
    lines = []
    if fmt == "int":
        for o, v in zip(oids.tolist(), np.asarray(vals).tolist()):
            # string-keyed graphs carry str component / community ids
            lines.append(f"{o} {v if isinstance(v, str) else int(v)}")
    elif fmt == "sssp_infinity":
        for o, v in zip(oids.tolist(), np.asarray(vals).tolist()):
            if not np.isfinite(v):
                lines.append(f"{o} infinity")
            else:
                lines.append(f"{o} {v:.15e}")
    else:
        for o, v in zip(oids.tolist(), np.asarray(vals).tolist()):
            lines.append(f"{o} {v:.15e}")
    return "\n".join(lines) + "\n"
