"""Append-only streaming fragment.

Counterpart of `libgrape_lite_tpu/sampler/append_only_fragment.py`
(reference `examples/gnn_sampler/append_only_edgecut_fragment.h`): edge
inserts accumulate in a host spill buffer and the CSR on the device is
rebuilt when the buffer passes `rebuild_threshold` times the edge count
(or on `flush`).  `device_csr()` hands out the current snapshot as
tensors on the fragment's device.
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.parallel.comm_spec import resolve_device


class AppendOnlyEdgecutFragment:
    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 w: np.ndarray | None = None, rebuild_threshold: float = 0.25,
                 device="cuda"):
        self.device = resolve_device(device)
        self._src = np.asarray(src, dtype=np.int64)
        self._dst = np.asarray(dst, dtype=np.int64)
        # the id space grows with the data, as in flush()
        self.n = max(n, int(self._src.max(initial=n - 1)) + 1,
                     int(self._dst.max(initial=n - 1)) + 1)
        self._w = None if w is None else np.asarray(w, dtype=np.float32)
        self._pending: list[tuple[int, int, float]] = []
        self.rebuild_threshold = rebuild_threshold
        self._snapshot = None
        self.rebuilds = 0
        self._build()

    # ---- streaming ingest (reference AddEdges path) ----

    def extend(self, src, dst, w=None) -> None:
        src = np.asarray(src).tolist()
        dst = np.asarray(dst).tolist()
        ws = np.asarray(w).tolist() if w is not None else [1.0] * len(src)
        if w is not None and self._w is None:
            # weights arrive on an unweighted stream: the existing edges
            # weigh 1
            self._w = np.ones(len(self._src), dtype=np.float32)
        self._pending.extend(zip(src, dst, ws))
        if len(self._pending) > self.rebuild_threshold * max(len(self._src),
                                                             1):
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        a_src = np.array([s for s, _, _ in self._pending], dtype=np.int64)
        a_dst = np.array([d for _, d, _ in self._pending], dtype=np.int64)
        a_w = np.array([x for _, _, x in self._pending], dtype=np.float32)
        self._src = np.concatenate([self._src, a_src])
        self._dst = np.concatenate([self._dst, a_dst])
        if self._w is not None:
            self._w = np.concatenate([self._w, a_w])
        self.n = max(self.n, int(self._src.max(initial=self.n - 1)) + 1,
                     int(self._dst.max(initial=self.n - 1)) + 1)
        self._pending.clear()
        self._build()

    def _build(self) -> None:
        # rows by src, each row's neighbours ascending (ties keep arrival
        # order): the JAX package's lexsort, as one stable argsort
        order = np.argsort(self._src * max(self.n, 1) + self._dst,
                           kind="stable")
        counts = np.bincount(self._src, minlength=self.n)
        indptr = np.zeros(self.n + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self._snapshot = (
            put(indptr),
            put(self._dst[order].astype(np.int32)),
            None if self._w is None else put(self._w[order]),
        )
        self.rebuilds += 1

    # ---- queries ----

    @property
    def num_edges(self) -> int:
        return len(self._src) + len(self._pending)

    def device_csr(self):
        """(indptr [n+1] int32, nbr [E] int32, w [E] float32 | None) on
        the device; flushed edges only (flush() first for all)."""
        return self._snapshot
