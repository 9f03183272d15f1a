"""Padded CSR storage (host side).

Counterpart of `libgrape_lite_tpu/graph/csr.py` (reference
`grape/graph/immutable_csr.h:36-381`).  The padding contract is the JAX
package's, array for array:

  * vertex rows are padded to `num_rows`;
  * edges are padded to `num_edges_padded`; padded edges have
    `edge_src = num_rows` (an overflow row sliced off by consumers),
    `edge_nbr = 0` and `edge_mask = False`;
  * adjacency is sorted by (src, nbr), ties in input order.

The CUDA gather-reduce kernel reads `indptr` and `edge_nbr` directly and
never touches the padded tail; the strict-tile kernel reads `edge_src`,
where pads land in the overflow row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class CSRValidationError(ValueError):
    """The CSR violates its structural contract (see CSR.validate)."""


@dataclass
class CSR:
    """Host-side (numpy) padded CSR for one fragment."""

    indptr: np.ndarray  # [num_rows + 1] int32
    edge_src: np.ndarray  # [Ep] int32, local row id; pad = num_rows
    edge_nbr: np.ndarray  # [Ep] int32, neighbor global padded id
    edge_w: np.ndarray | None  # [Ep] float, 0-padded
    edge_mask: np.ndarray  # [Ep] bool
    num_rows: int
    num_edges: int  # real edge count

    @property
    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def validate(self, name: str = "csr", n_pad: int | None = None) -> None:
        """Check every invariant of the padding contract; raise
        `CSRValidationError` naming the first violation.  `n_pad` bounds
        neighbor ids (fnum * vp) when the caller knows it."""

        def bad(why: str):
            raise CSRValidationError(f"{name}: {why}")

        ip, src, nbr, mask = (
            np.asarray(self.indptr), np.asarray(self.edge_src),
            np.asarray(self.edge_nbr), np.asarray(self.edge_mask),
        )
        ep = len(src)
        ne = self.num_edges
        if ip.shape != (self.num_rows + 1,):
            bad(f"indptr shape {ip.shape} != ({self.num_rows + 1},)")
        if len(nbr) != ep or len(mask) != ep:
            bad(f"edge stream lengths disagree: src={ep} nbr={len(nbr)} "
                f"mask={len(mask)}")
        if self.edge_w is not None and len(self.edge_w) != ep:
            bad(f"weight stream length {len(self.edge_w)} != {ep}")
        if not (0 <= ne <= ep):
            bad(f"num_edges={ne} outside [0, {ep}]")
        if ip.size and ip[0] != 0:
            bad(f"indptr[0] = {ip[0]} != 0")
        if np.any(np.diff(ip) < 0):
            r = int(np.argmax(np.diff(ip) < 0))
            bad(f"indptr is not monotone non-decreasing (row {r})")
        if ip.size and ip[-1] != ne:
            bad(f"indptr[-1] = {int(ip[-1])} != num_edges = {ne}")
        real_src = src[:ne]
        if ne and (real_src.min() < 0 or real_src.max() >= self.num_rows):
            bad(f"edge_src out of range [0, {self.num_rows})")
        if np.any(np.diff(real_src) < 0):
            bad("edge_src is not sorted")
        counts = (np.bincount(real_src, minlength=self.num_rows) if ne
                  else np.zeros(self.num_rows, dtype=np.int64))
        if not np.array_equal(counts, np.diff(ip)):
            r = int(np.argmax(counts != np.diff(ip)))
            bad(f"row {r}: indptr degree {int(np.diff(ip)[r])} != "
                f"edge_src count {int(counts[r])}")
        if np.any(src[ne:] != self.num_rows):
            bad(f"padded edge_src must equal num_rows ({self.num_rows})")
        if not mask[:ne].all():
            bad("edge_mask False on a real edge")
        if mask[ne:].any():
            bad("edge_mask True on a padded edge")
        real_nbr = nbr[:ne]
        if ne and real_nbr.min() < 0:
            bad(f"negative neighbor id {int(real_nbr.min())}")
        if ne and n_pad is not None and real_nbr.max() >= n_pad:
            bad(f"neighbor id {int(real_nbr.max())} outside [0, {n_pad})")
        if self.edge_w is not None and ne:
            w = np.asarray(self.edge_w[:ne])
            if np.isnan(w).any():
                bad(f"{int(np.isnan(w).sum())} NaN edge weight(s)")


def build_csr(
    src_lid: np.ndarray,
    nbr_pid: np.ndarray,
    weights: np.ndarray | None,
    num_rows: int,
    num_edges_padded: int,
) -> CSR:
    """Sort edges by (src, nbr), ties in input order, count degrees,
    pad.  Same arrays as the JAX package's `build_csr`.  A big fragment sorts
    in the native counting sort (`io/native.py`), as the JAX package's
    does, where its count array stays modest; otherwise the sort is the
    lexsort permutation, computed as one stable argsort of the combined
    key src * (max_nbr + 1) + nbr, which is faster than `np.lexsort`."""
    e = len(src_lid)
    if e > num_edges_padded:
        raise ValueError(f"edge overflow: {e} > {num_edges_padded}")
    nbr64 = np.asarray(nbr_pid, dtype=np.int64)
    span = int(nbr64.max(initial=0)) + 1
    nat = None
    if e >= 1 << 17 and span <= min(16 * e, 1 << 25):
        from libgrape_lite_tpu_torch.io.native import sort_edges_native

        nat = sort_edges_native(src_lid, nbr64, weights, num_rows, span)
    if nat is not None:
        s64, n64, w64, ip64 = nat
        src_sorted = s64.astype(np.int32)
        nbr_sorted = n64.astype(np.int32)
        w_sorted = (None if weights is None
                    else w64.astype(np.asarray(weights).dtype))
        indptr = ip64.astype(np.int32)
    else:
        src64 = np.asarray(src_lid, dtype=np.int64)
        order = np.argsort(src64 * span + nbr64, kind="stable")
        src_sorted = np.asarray(src_lid)[order].astype(np.int32)
        nbr_sorted = np.asarray(nbr_pid)[order].astype(np.int32)
        w_sorted = None if weights is None else np.asarray(weights)[order]
        counts = np.bincount(src_sorted, minlength=num_rows)
        indptr = np.zeros(num_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])

    pad = num_edges_padded - e
    edge_src = np.concatenate(
        [src_sorted, np.full(pad, num_rows, dtype=np.int32)]
    )
    edge_nbr = np.concatenate([nbr_sorted, np.zeros(pad, dtype=np.int32)])
    edge_w = (
        None
        if w_sorted is None
        else np.concatenate([w_sorted, np.zeros(pad, dtype=w_sorted.dtype)])
    )
    edge_mask = np.concatenate(
        [np.ones(e, dtype=bool), np.zeros(pad, dtype=bool)]
    )
    return CSR(indptr, edge_src, edge_nbr, edge_w, edge_mask, num_rows, e)
