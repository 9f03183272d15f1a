"""SSSPDelta -- bucketed (delta-stepping style) SSSP: `sssp_opt`,
`sssp_delta`.

Counterpart of `libgrape_lite_tpu/models/sssp_delta.py` (reference
near/far worklist SSSP, `examples/analytical_apps/cuda/sssp/sssp.h:70-124`).
Vertices with pending improvements are bucketed by distance: only the
*near* set -- pending vertices with dist < threshold -- pushes; far
improvements wait.  When the near set drains, the threshold advances to
the bucket holding the smallest pending distance.  A vertex then usually
pushes once, with its (near-)final distance.

Each round pushes through `exchange_relax` (a masked pull through the
gather-reduce kernel on one device) with the capacity accounting of
sssp_msg.  The host reads the round's largest message count, near and
pending counts and smallest pending distance with one `.tolist()`
(`round_scalars`: across processes the whole graph's, through one
all_gather, so every rank advances the same buckets in the same
rounds), and advances the threshold in the distance type: float32 on the card
(so the bucket sequence is float32's), float64 where the caller asks
for the JAX package's x64 distances.  The result equals Bellman-Ford's
fixed point.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import make_context, resolve_source
from libgrape_lite_tpu_torch.models.exchange_base import (
    ExchangeAppBase,
    dest_degree,
    exchange_relax,
    round_scalars,
    source_slab,
)
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}
# fragment -> its mean edge weight; kept across app instances, since
# run_app builds a fresh app for each query
_MEAN_WEIGHT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class SSSPDelta(ExchangeAppBase):
    load_strategy = LoadStrategy.kBothOutIn
    message_strategy = MessageStrategy.kAlongEdgeToOuterVertex
    result_format = "sssp_infinity"
    needs_edata = True

    def __init__(self, delta: float | None = None,
                 initial_capacity: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(initial_capacity, dtype)
        self.delta = delta  # None: mean edge weight at query time
        self.buckets = 0

    def _resolve_delta(self, frag) -> float:
        """`delta`, else the mean edge weight (buckets then hold about
        one extra hop each), an O(E) host scan cached per fragment."""
        if self.delta is not None and self.delta > 0:
            return float(self.delta)
        if frag in _MEAN_WEIGHT:
            return _MEAN_WEIGHT[frag]
        if frag.host_oe[0].edge_w is None:
            return 1.0
        total, count = 0.0, 0
        for c in frag.host_oe:
            if c.edge_w is not None and c.num_edges:
                total += float(c.edge_w[c.edge_mask].sum())
                count += int(c.num_edges)
        delta = max(total / count, 1e-6) if count else 1.0
        _MEAN_WEIGHT[frag] = delta
        return delta

    def host_compute(self, frag, source=0, max_rounds: int | None = None,
                     ctx=None):
        ctx = make_context(self, frag) if ctx is None else ctx
        device = frag.device
        dt = self.dtype
        np_dt = np.dtype(_NP_DTYPE[dt])
        pid = resolve_source(frag, source, "SSSPDelta")
        dist, pending = source_slab(frag, pid, float("inf"), dt)

        delta = self._resolve_delta(frag)
        w = frag.dev.ie.edge_w.to(dt)
        dest_deg = dest_degree(frag)
        inner = frag.dev.inner_mask
        thr = delta
        cap = self._initial_cap(frag)
        self.rounds = self.retries = self.buckets = 0
        limit = max_rounds if (max_rounds and max_rounds > 0) else None
        n_pend = 1 if pid >= 0 else 0
        # guard/ft hooks at round boundaries (bucket advances are not
        # rounds: no probe there).  `pending` is part of the probed
        # carry: a bucketed round can leave dist unchanged while the near
        # set drains, and a dist-only digest would repeat -- the watchdog
        # would take healthy progress for a cycle
        hooks = self._round_hooks(frag, {"dist": dist, "pending": pending})
        while n_pend > 0 and (limit is None or self.rounds < limit):
            near = pending & (dist < torch.full((), thr, dtype=dt,
                                                device=device))
            relaxed, sent = exchange_relax(frag.dev, dist, near, dest_deg, w,
                                           ctx)
            new = torch.minimum(dist, relaxed)
            improved = (new < dist) & inner
            new_pend = (pending & ~near) | improved
            sent, n_near, n_pend_d, min_pend = round_scalars(ctx, [
                ("max", sent), ("sum", near.sum()),
                ("sum", new_pend.sum()),
                ("min", torch.where(new_pend, new, float("inf")).min()
                 .to(torch.float64))])
            cap = self._fit_cap(cap, sent)
            if n_near == 0:
                # near set empty but work remains: advance to the bucket
                # of the smallest pending distance.  The new threshold
                # must exceed it in the distance type: with a tiny delta
                # the bucket arithmetic can round back to it, so clamp
                # to the next representable value above it.
                mp = min_pend
                if not np.isfinite(mp):
                    break
                thr = (np.floor(mp / delta) + 1.0) * delta
                if float(np.asarray(thr, np_dt)) <= mp:
                    thr = float(np.nextafter(np_dt.type(mp),
                                             np_dt.type(np.inf)))
                self.buckets += 1
                continue
            dist, pending = new, new_pend
            n_pend = int(n_pend_d)
            self.rounds += 1
            if hooks.armed:
                probed = hooks.observe({"dist": dist, "pending": pending},
                                       self.rounds, n_pend)
                dist, pending = probed["dist"], probed["pending"]
        self._save_cap(frag, cap)
        return {"dist": dist}

    def finalize(self, frag, state):
        return np.asarray(state["dist"].numpy())
