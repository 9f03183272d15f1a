"""Packed row bitmaps (counterpart of `libgrape_lite_tpu/utils/bitset.py`,
the traced helpers `pack_bits` and `popcount_rows`).

A bitmap is an int32 tensor `[rows, words]` holding the uint32 bit
pattern of the JAX package's uint32 bitmaps: bit `c` of row `r` lives in
word `c >> 5` at bit `c & 31`, and bit 31 reads as -2^31.  (torch's
uint32 has no shifts and no `index_put_`, and the CUDA kernels read the
words as raw 32-bit patterns anyway.)  Compare with the JAX package
through `t.numpy().view(np.uint32)`.
"""

from __future__ import annotations

import torch

_M1, _M2, _M4, _H01 = 0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101


def pack_bits(indices: torch.Tensor, keep: torch.Tensor, num_rows: int,
              rows: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Set bit `indices[i]` of row `rows[i]` for every kept entry and
    return [num_rows, ceil(num_bits / 32)] int32.  Kept (row, index)
    pairs must be unique, so the accumulating add is an or: distinct
    powers of two never carry, and bit 31 (-2^31) plus lower bits stays
    inside int32."""
    words = (num_bits + 31) // 32
    bm = torch.zeros((num_rows, words), dtype=torch.int32,
                     device=indices.device)
    sel = keep.reshape(-1)
    idx = indices.reshape(-1)[sel].long()
    r = rows.reshape(-1)[sel].long()
    bit = torch.ones_like(idx) << (idx & 31)  # int64: 1 .. 2^31
    bit = torch.where(bit >= (1 << 31), bit - (1 << 32), bit)
    bm.index_put_((r, idx >> 5), bit.to(torch.int32), accumulate=True)
    return bm


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-element population count of int32 words (as uint32 bit
    patterns), as int64.  SWAR on the words widened to int64 and masked
    to 32 bits, so no arithmetic shift ever reads a sign bit."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * _H01) >> 24) & 0xFF


def nonzero_words(bm: torch.Tensor, chunk_words: int = 1 << 24):
    """The non-zero words of a [rows, words] bitmap in row-major order:
    (rows int64, cols int64, values int32), found in blocks of about
    `chunk_words` words."""
    n_rows, words = bm.shape
    step = max(1, chunk_words // max(words, 1))
    rows, cols = [], []
    for s in range(0, n_rows, step):
        r, c = torch.nonzero(bm[s:s + step], as_tuple=True)
        rows.append(r + s)
        cols.append(c)
    rows = torch.cat(rows) if rows else bm.new_zeros(0, dtype=torch.int64)
    cols = torch.cat(cols) if cols else bm.new_zeros(0, dtype=torch.int64)
    return rows, cols, bm[rows, cols]


def popcount_rows(bm: torch.Tensor) -> torch.Tensor:
    """Row-wise population count of packed bitmaps: [..., words] -> [...]
    int32 (only the non-zero words are counted)."""
    flat = bm.reshape(-1, bm.shape[-1])
    rows, _, vals = nonzero_words(flat)
    out = torch.zeros(flat.shape[0], dtype=torch.int64, device=bm.device)
    out.index_add_(0, rows, popcount(vals))
    return out.to(torch.int32).view(bm.shape[:-1])
