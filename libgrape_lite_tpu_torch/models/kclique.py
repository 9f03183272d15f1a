"""KClique -- k-clique counting, dispatched by k and the oriented degree.

Counterpart of `libgrape_lite_tpu/models/kclique.py` (reference
`examples/analytical_apps/kclique/kclique.h` + `kclique_utils.h`): count
k-cliques over the (degree, pid) "lo" orientation DAG, each clique at its
DAG-minimal apex.  A host app (`host_compute`), with the JAX package's
dispatch:

  * k = 3: `ApexTriangleCount` (LCCBeta's merge pass in apex mode);
  * k = 4 while the largest oriented out-degree is at most `hub_cap`:
    `KClique4Device`;
  * k >= 5 while it is at most `general_cap(k)` and the ELL fits the
    gather budget: `KCliqueDevice(k)`;
  * otherwise the numpy recursion over packed bitmaps, per apex.

Output: per-apex counts; `total_cliques` (their sum) and
`used_device_kernel` after a query.  The device apps run through the
port's `Worker` on the same fragment; the oriented pairs and the k = 3
worker are cached per fragment (weak keys).

Across processes the dispatch reads the whole host CSRs every rank
keeps, so every rank takes the same path; the nested workers run their
collectives in the same order on every rank, and their gathered result
is the whole `[fnum, vp]` count on every rank.  The host recursion runs
the slab's apexes and all-gathers the counts, dividing the host work.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import AppBase
from libgrape_lite_tpu_torch.utils.types import LoadStrategy, MessageStrategy

# fragment -> Worker over ApexTriangleCount, reused by k = 3 queries
_TRIANGLE_WORKERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_ORIENTED_PAIRS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _popcount(a: np.ndarray) -> np.ndarray:
    """Row-wise popcount of a 2-D packed bitmap -> [rows] int64."""
    return np.unpackbits(a.view(np.uint8), axis=1).sum(axis=1, dtype=np.int64)


def _oriented_pairs(frag):
    """Deduplicated (degree, pid)-oriented edge pairs (v, u) in pid space,
    "lo" (u has the higher degree, ties by pid), from the host CSRs;
    cached per fragment."""
    cached = _ORIENTED_PAIRS.get(frag)
    if cached is not None:
        return cached
    fnum, vp = frag.fnum, frag.vp
    v_list, u_list = [], []
    deg = np.zeros(fnum * vp, dtype=np.int64)
    for f in range(fnum):
        c = frag.host_oe[f]
        e = c.num_edges
        deg[f * vp:(f + 1) * vp] = np.diff(c.indptr)
        v_list.append(f * vp + c.edge_src[:e].astype(np.int64))
        u_list.append(c.edge_nbr[:e].astype(np.int64))
    pairs = np.unique(np.stack([np.concatenate(v_list),
                                np.concatenate(u_list)], 1), axis=0)
    v, u = pairs[:, 0], pairs[:, 1]
    keep = (deg[u] > deg[v]) | ((deg[u] == deg[v]) & (u > v))
    keep &= v != u
    cached = (v[keep], u[keep])
    _ORIENTED_PAIRS[frag] = cached
    return cached


class KClique(AppBase):
    load_strategy = LoadStrategy.kOnlyOut
    message_strategy = MessageStrategy.kSyncOnOuterVertex
    result_format = "int"
    host_only = True

    # k = 4 runs on the device while the largest oriented out-degree is at
    # most this cap (it bounds the D^2 candidate tests per edge; RMAT-18's
    # D is 259, RMAT-20's 679)
    hub_cap = 320
    # per-edge candidate tests of the general-k device app: D^(k-2) at
    # most this (k = 5: D <= 80, k = 6: D <= 26, k = 7: D <= 13)
    _GENERAL_WORK_BUDGET = 1 << 19
    # the general-k device app's ELL, (fnum * vp + 1) x (D + 1) int32
    _GATHER_BYTES_BUDGET = 2 << 30

    def __init__(self, k: int = 3):
        self.k = k
        self.total_cliques = 0
        self.used_device_kernel = False
        self.rounds = 0

    def general_cap(self, k: int) -> int:
        return int(self._GENERAL_WORK_BUDGET ** (1.0 / (k - 2)))

    @staticmethod
    def _oriented_dmax(frag) -> int:
        """The largest "lo"-oriented out-degree: the width D of the device
        apps' ELL."""
        v, _ = _oriented_pairs(frag)
        return int(np.bincount(v).max()) if len(v) else 0

    @staticmethod
    def _count(frag, counts: np.ndarray) -> dict:
        """The result state: the [fnum, vp] per-apex counts, whole on
        every rank and on the fragment's device.  Across ranks it has
        fnum rows, not a slab's fl, so the result gather passes it as it
        is (a group of one rank gathers it from itself)."""
        return {"count": torch.from_numpy(
            counts.reshape(frag.fnum, frag.vp)).to(frag.device)}

    def _device(self, worker) -> dict:
        worker.query()
        per_apex = worker.result_values()
        self.used_device_kernel = True
        self.total_cliques = int(per_apex.sum())
        return self._count(worker.fragment, per_apex)

    def host_compute(self, frag, k: int | None = None, max_rounds: int = 0,
                     ctx=None):
        # `ctx`, the worker's step context, gathers the host recursion's
        # slab counts across ranks (the device paths' nested workers
        # gather their own)
        from libgrape_lite_tpu_torch.models.kclique_device import (
            KClique4Device,
            KCliqueDevice,
        )
        from libgrape_lite_tpu_torch.models.lcc_beta import ApexTriangleCount
        from libgrape_lite_tpu_torch.worker.worker import Worker

        if k is not None:
            self.k = k
        k = self.k
        fnum, vp = frag.fnum, frag.vp
        if k == 3:
            if frag not in _TRIANGLE_WORKERS:
                _TRIANGLE_WORKERS[frag] = Worker(ApexTriangleCount(), frag)
            return self._device(_TRIANGLE_WORKERS[frag])
        dmax = self._oriented_dmax(frag) if k >= 4 else 0
        if k == 4 and dmax <= self.hub_cap:
            return self._device(Worker(KClique4Device(), frag))
        if (k >= 5 and dmax <= self.general_cap(k) and (fnum * vp + 1)
                * (dmax + 1) * 4 <= self._GATHER_BYTES_BUDGET):
            return self._device(Worker(KCliqueDevice(k), frag))
        self.used_device_kernel = False
        spec = getattr(frag, "comm_spec", None)
        if ctx is None or getattr(spec, "group", None) is None:
            counts = self._host_counts(frag, k)
        else:  # the slab's apexes, every rank's gathered
            lo = spec.fid_lo * vp
            own = self._host_counts(frag, k, (lo, lo + spec.fl * vp))
            counts = ctx.gather_state(torch.from_numpy(
                own[lo:lo + spec.fl * vp].reshape(spec.fl, vp)).to(
                    frag.device)).cpu().numpy()
        self.total_cliques = int(counts.sum())
        return self._count(frag, counts)

    @staticmethod
    def _host_counts(frag, k: int, apexes: tuple | None = None) -> np.ndarray:
        """[fnum * vp] int64 per-apex counts by the numpy recursion over
        packed bitmaps of the oriented adjacency (dense ranks); `apexes`
        (lo, hi) counts only the apexes of that pid range."""
        fnum, vp = frag.fnum, frag.vp
        lo, hi = (0, fnum * vp) if apexes is None else apexes
        v, u = _oriented_pairs(frag)
        counts = np.zeros(fnum * vp, dtype=np.int64)
        if k == 1:
            for f in range(lo // vp, hi // vp):
                counts[f * vp:f * vp + frag.inner_vertices_num(f)] = 1
            return counts
        if k == 2:
            own = (v >= lo) & (v < hi)
            np.add.at(counts, v[own], 1)
            return counts
        if len(v) == 0:
            return counts
        used, inv = np.unique(np.concatenate([v, u]), return_inverse=True)
        vr, ur = inv[:len(v)], inv[len(v):]
        n = len(used)
        words = (n + 63) // 64
        adj = np.zeros((n, words), dtype=np.uint64)
        np.bitwise_or.at(adj, (vr, ur // 64),
                         np.uint64(1) << (ur % 64).astype(np.uint64))
        order = np.argsort(vr, kind="stable")
        vs, us = vr[order], ur[order]
        starts = np.searchsorted(vs, np.arange(n))
        ends = np.searchsorted(vs, np.arange(n) + 1)

        def bits(bm):
            out = []
            for wi in np.nonzero(bm)[0]:
                word = int(bm[wi])
                while word:
                    b = word & -word
                    out.append(wi * 64 + b.bit_length() - 1)
                    word ^= b
            return np.asarray(out, dtype=np.int64)

        def rec(cand, depth):
            """Cliques extending the current chain by `depth` more members
            of the candidate bitmap `cand`."""
            if depth == 0:
                return int(_popcount(cand[None, :]).sum())
            members = bits(cand)
            if len(members) == 0:
                return 0
            if depth == 1:
                return int(_popcount(adj[members] & cand[None, :]).sum())
            return sum(rec(cand & adj[w], depth - 1) for w in members)

        for apex in range(n):
            s, e = starts[apex], ends[apex]
            if e - s < k - 1 or not lo <= used[apex] < hi:
                continue
            cand = np.zeros(words, np.uint64)
            np.bitwise_or.at(cand, us[s:e] // 64,
                             np.uint64(1) << (us[s:e] % 64).astype(np.uint64))
            counts[int(used[apex])] += rec(cand, k - 2)
        return counts

    def finalize(self, frag, state):
        return np.asarray(state["count"].numpy())
