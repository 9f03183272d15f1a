"""Device k-clique counting (k >= 4) over the oriented ELL.

Counterpart of `libgrape_lite_tpu/models/kclique_device.py`
(`KClique4Device`, `KCliqueDevice`; reference
`examples/analytical_apps/kclique/kclique.h` UniFragCliqueNumRecursive).
Under LCCBeta's "lo" (degree, pid) orientation every k-clique has one
ascending order v < u < w < ..., so its count at the apex v is

    count(v) = sum over u in N+(v) of chains(C2, k - 2),
    C2 = N+(v) & N+(u),
    chains(mask, 1) = |mask|,
    chains(mask, m) = sum over w in mask of chains(mask & N+(w), m - 1).

Rows are read from the stacked `[fnum * vp, D]` ELL by pid: the JAX
package's double ring (k = 4, `ppermute` of ELL blocks) and all-gather
(k >= 5) become these reads, so `KClique4Device` is `KCliqueDevice(4)`
here.  Under a process group each rank builds its slab's ELL block at
the widest row of any rank (`ctx.max`) and all-gathers the blocks and
their row lengths into that same stacked ELL (one process's, so a rank
holds no more than one process does); a rank expands its slab's edges,
whose apexes are its own rows.  Membership is a batched
`torch.searchsorted`; there is no Pallas kernel behind these apps (the
JAX package runs them in XLA).

The JAX package tests every lane of a level at once: its third level is a
[chunk, D, D] tensor, D^(k-2) tests an edge whatever the graph holds.
Here each level expands only its members: the (row, member w) pairs of
the mask, each a [W] membership test of the row's lanes in N+(w), so the
work follows the cliques' prefixes (triangles, then 4-cliques, ...), not
D^(k-2); rows with too few members to close a clique are dropped.  Edges
run in groups by width, as LCCBeta's pass does: every row an edge (v, u)
reads -- N+(v), N+(u) and N+(w) for w in N+(v) -- lies in the first W
entries of its row, W the power of two at or above the longest of them
(at most D), so a group runs at its own width with the counts of the full
width.  Each step holds at most 2^21 lanes (the JAX package's bound on
its third level); each expansion is one host read.  Counts are int32
sums, exact in any order, so per-apex counts equal the JAX package's; an
apex's count is at most C(D, k - 1) (1.9e8 for k = 5 at D = 261).
"""

from __future__ import annotations

import numpy as np
import torch

from libgrape_lite_tpu_torch.app.base import StepContext
from libgrape_lite_tpu_torch.models.lcc_beta import LCCBeta

_STEP_LANES = 1 << 21  # lanes of one [rows, W] step


def _member(rows, rcnt, q):
    """[B, W] bool: is q[b, j] in the sorted rows[b, :rcnt[b]]?"""
    q = q.contiguous()
    pos = torch.searchsorted(rows, q)
    hit = rows.gather(1, pos.clamp(max=rows.shape[1] - 1)) == q
    return hit & (pos < rcnt.unsqueeze(1))


class KCliqueDevice(LCCBeta):
    """Per-apex k-clique counts on the device, k >= 4."""

    credit_mode = "apex"
    result_format = "int"

    def __init__(self, k: int):
        if k < 4:
            raise ValueError("KCliqueDevice handles k >= 4")
        super().__init__()
        self.k = int(k)

    def init_state(self, frag, **kw):
        state = super().init_state(frag, **kw)
        state.pop("lcc")
        state["quad"] = torch.zeros((getattr(frag, "fl", frag.fnum), frag.vp),
                                    dtype=torch.int32, device=frag.device)
        return state

    def _count(self, quad, apex, qv, mask, m, ell, cnt):
        """Add to quad[apex[t]] the number of m mutually adjacent
        ascending members of mask[t] (lanes of qv[t])."""
        if m == 1:
            quad.index_add_(0, apex, mask.sum(1, dtype=torch.int32))
            return
        t, p = mask.nonzero(as_tuple=True)
        step = max(1, _STEP_LANES // mask.shape[1])
        for s in range(0, t.numel(), step):
            tt, pp = t[s:s + step], p[s:s + step]
            q, w = qv[tt], qv[tt, pp]
            nm = mask[tt] & _member(ell[w], cnt[w], q)
            if m > 2:  # rows that can still close a clique
                live = (nm.sum(1) >= m - 1).nonzero().squeeze(1)
                tt, q, nm = tt[live], q[live], nm[live]
            self._count(quad, apex[tt], q, nm, m - 1, ell, cnt)

    def stacked_ell(self, dev, ctx=None):
        """(v, u) the slab's kept oriented edges and the whole stack's
        ELL ([fnum * vp + 1, D] int32, the last row the sentinel's empty
        list) with its row lengths ([fnum * vp + 1]): built whole in one
        process, gathered from the ranks' slab blocks under a group."""
        ctx = StepContext(dev.fnum) if ctx is None else ctx
        n_pad = dev.fnum * dev.vp
        v, u = self._oriented_edges(dev, ctx)
        if ctx.ring_size() == 1:
            ell, cnt = self._ell(v, u, n_pad)
        else:  # every rank's block at the widest row of any rank
            rows = dev.oe.edge_src.shape[0] * dev.vp
            base = getattr(dev, "fid_lo", 0) * dev.vp
            widest = torch.bincount((v - base).long(), minlength=1).max()
            d = max(1, int(ctx.max(widest.reshape(1, 1))[0]))
            ell, cnt = self._ell(v - base, u, rows, n_pad, d)
            ell = ctx.gather_state(ell.view(-1, dev.vp, d))
            cnt = ctx.gather_state(cnt.view(-1, dev.vp))
        d = ell.shape[1]
        # a sentinel row: padded query lanes (pid n_pad) read an empty list
        ell = torch.cat([ell, ell.new_full((1, d), n_pad)])
        cnt = torch.cat([cnt, cnt.new_zeros(1)])
        return v, u, ell, cnt

    def peval(self, ctx, dev, state):
        n_pad = dev.fnum * dev.vp
        v, u, ell, cnt = self.stacked_ell(dev, ctx)
        d = ell.shape[1]
        vl, ul = v.long(), u.long()
        longest = cnt.clone().scatter_reduce_(0, vl, cnt[ul], "amax")
        width = longest[vl].clamp(min=1)
        n_groups = max(1, (d - 1).bit_length() + 1)
        pow2 = 2 ** torch.arange(n_groups, device=ell.device)
        group = torch.searchsorted(pow2, width)  # 2^group >= width
        order = torch.argsort(group, stable=True)
        vl, ul = vl[order], ul[order]
        sizes = torch.bincount(group, minlength=n_groups).tolist()
        quad = torch.zeros(n_pad, dtype=torch.int32, device=ell.device)
        start = 0
        for g, size in enumerate(sizes):
            w = min(1 << g, d)
            ell_w = ell[:, :w]
            lanes = torch.arange(w, device=ell.device)
            chunk = max(1, _STEP_LANES // w)
            for s in range(start, start + size, chunk):
                e = min(s + chunk, start + size)
                vv, uu = vl[s:e], ul[s:e]
                qv = ell_w[vv]  # [C, W]: N+(v)
                c2 = (_member(ell_w[uu], cnt[uu], qv)
                      & (lanes < cnt[vv].unsqueeze(1)))
                # an edge with fewer than k - 2 common members closes none
                live = (c2.sum(1) >= self.k - 2).nonzero().squeeze(1)
                self._count(quad, vv[live], qv[live], c2[live], self.k - 2,
                            ell_w, cnt)
            start += size
        # the slab's rows: every apex is one
        base = getattr(dev, "fid_lo", 0) * dev.vp
        quad = quad[base:base + dev.oe.edge_src.shape[0] * dev.vp].view(
            -1, dev.vp)
        return dict(state, quad=torch.where(dev.inner_mask, quad, 0)), 0

    def inceval(self, ctx, dev, state):
        return state, 0

    def finalize(self, frag, state):
        return state["quad"].numpy().astype(np.int64)


class KClique4Device(KCliqueDevice):
    """Per-apex 4-clique counts (the JAX package's double-ring kernel;
    on one device the same reads as `KCliqueDevice(4)`)."""

    def __init__(self):
        super().__init__(4)
