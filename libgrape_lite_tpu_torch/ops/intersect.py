"""Row AND-popcount: the CUDA kernel behind LCC's set intersections and its
plain PyTorch version.

    out[i] = sum_w popcount(A[ia[i], w] & B[ib[i], w])

over packed row bitmaps (`utils/bitset.py`: int32 words holding uint32
bit patterns).  This is the counterpart of the JAX package's Pallas
kernel `libgrape_lite_tpu/ops/pallas_kernels.py::intersect_count`
(reached through `row_and_popcount`), in the indexed form: the kernel
gathers rows `ia[i]` of A and `ib[i]` of B itself, where the JAX callers
gather `[chunk, words]` operands first.  With `ia = ib = arange(n)` it is
`intersect_count(a, b)` exactly.  The indexed form skips all-zero words:
it marks the rows the call names, summarises each once (one occupancy
bit per 16-byte group, `row_occupancy_plain`), and pairs only the groups
set in both summaries (`row_and_popcount_occupancy_plain`).  Source and
design notes: `csrc/intersect.cu`.

`row_and_popcount_indexed` takes its plain version
(`row_and_popcount_plain`) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  `row_and_popcount_indexed.launches`
counts kernel launches, `intersect_count` included.
"""

from __future__ import annotations

import ctypes

import torch

from libgrape_lite_tpu_torch.ops import _build
from libgrape_lite_tpu_torch.ops._build import (
    check_cuda_args,
    check_rc,
    count_launch,
    require,
)
from libgrape_lite_tpu_torch.utils.bitset import nonzero_words, popcount

#: words per block of the plain version's scans and expansions
PLAIN_CHUNK_WORDS = 1 << 24
#: words per occupancy group: one summary bit per 16 bytes of a row
GROUP_WORDS = 4

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("intersect")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grape_row_and_popcount.argtypes = [p, p, p, ll, i, i, p]
        lib.grape_row_and_popcount.restype = i
        lib.grape_row_and_popcount_indexed.argtypes = [
            p, p, p, p, ll, p, p, p, p, ll, p, ll, i, i, i, i, p]
        lib.grape_row_and_popcount_indexed.restype = i
        _LIB = lib
    return _LIB


def row_and_popcount_plain(a: torch.Tensor, ia: torch.Tensor | None,
                           b: torch.Tensor, ib: torch.Tensor | None
                           ) -> torch.Tensor:
    """Plain PyTorch version.  Only the non-zero words of A can add to a
    count, so A's non-zero words (`nonzero_words`, row-major) are
    expanded per pair, each ANDed with the same word of the pair's B row
    and popcounted into the pair.  Pairs go in groups of about
    PLAIN_CHUNK_WORDS expanded words."""
    n = a.shape[0] if ia is None else ia.shape[0]
    dev = a.device
    rows, cols, vals = nonzero_words(a, PLAIN_CHUNK_WORDS)
    row_cnt = torch.bincount(rows, minlength=a.shape[0])
    row_start = torch.cumsum(row_cnt, 0) - row_cnt
    ra = torch.arange(n, device=dev) if ia is None else ia.long()
    rb = torch.arange(n, device=dev) if ib is None else ib.long()
    cnt = row_cnt[ra]
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1]) if n else 0
    marks = torch.arange(1, total // PLAIN_CHUNK_WORDS + 1, device=dev)
    cuts = torch.searchsorted(ends, marks * PLAIN_CHUNK_WORDS,
                              right=True).tolist()
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    for p0, p1 in zip([0] + cuts, cuts + [n]):
        if p1 <= p0:
            continue
        first = ends[p0:p1] - cnt[p0:p1]  # expanded offset of each pair
        pid = torch.repeat_interleave(torch.arange(p0, p1, device=dev),
                                      cnt[p0:p1])
        pos = torch.arange(int(first[0]), int(ends[p1 - 1]), device=dev)
        word = row_start[ra[pid]] + pos - first[pid - p0]
        both = vals[word] & b[rb[pid], cols[word]]
        out.index_add_(0, pid, popcount(both))
    return out.to(torch.int32)


def summary_words(words: int) -> int:
    """int32 words of one row's occupancy summary."""
    return -(-(-(-words // GROUP_WORDS)) // 32)


def row_occupancy_plain(bm: torch.Tensor) -> torch.Tensor:
    """[rows, summary_words(words)] int32 occupancy summary of a bitmap
    (the kernel's first pass, for every row): bit l of word j is set when
    group 32 j + l, words [4 (32 j + l), 4 (32 j + l) + 4) of the row
    (the last group ragged), holds a set bit."""
    rows, words = bm.shape
    sw = summary_words(words)
    groups = -(-words // GROUP_WORDS)
    pad = groups * GROUP_WORDS - words
    nz = torch.nn.functional.pad(bm != 0, (0, pad))
    nz = nz.view(rows, groups, GROUP_WORDS).any(-1)
    nz = torch.nn.functional.pad(nz, (0, sw * 32 - groups))
    bits = nz.view(rows, sw, 32).long() << torch.arange(32, device=bm.device)
    packed = bits.sum(-1)  # distinct powers of two: the sum is an or
    return torch.where(packed >= 1 << 31, packed - (1 << 32),
                       packed).to(torch.int32)


def row_and_popcount_occupancy_plain(a: torch.Tensor, ia: torch.Tensor | None,
                                     b: torch.Tensor, ib: torch.Tensor | None
                                     ) -> torch.Tensor:
    """The kernel's pair pass in plain PyTorch, the same function as
    `row_and_popcount_plain`: AND the two rows' occupancy summaries and
    popcount the AND of only the groups whose bit survives."""
    n = a.shape[0] if ia is None else ia.shape[0]
    dev = a.device
    words = a.shape[1]
    ra = torch.arange(n, device=dev) if ia is None else ia.long()
    rb = torch.arange(n, device=dev) if ib is None else ib.long()
    both = row_occupancy_plain(a)[ra] & row_occupancy_plain(b)[rb]
    bit = (both.long().unsqueeze(-1) >> torch.arange(32, device=dev)) & 1
    pair, grp = torch.nonzero(bit.reshape(n, both.shape[1] * 32),
                              as_tuple=True)
    word = (grp.unsqueeze(1) * GROUP_WORDS
            + torch.arange(GROUP_WORDS, device=dev))  # [hits, 4]
    inside = word < words
    word = word.clamp(max=words - 1)
    anded = a[ra[pair].unsqueeze(1), word] & b[rb[pair].unsqueeze(1), word]
    cnt = torch.where(inside, popcount(anded), 0).sum(1)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    out.index_add_(0, pair, cnt)
    return out.to(torch.int32)


def _check_indices(name: str, named: list) -> None:
    """Each (arg, idx, n_rows) holds a 1-D int32 index inside [0, n_rows);
    the bounds of all of them come back in one sync."""
    for arg, idx, _ in named:
        require(idx.dtype == torch.int32 and idx.dim() == 1,
                f"{name}: {arg} must be a 1-D int32 tensor")
    named = [t for t in named if t[1].numel()]
    if not named:
        return
    bounds = torch.stack([torch.stack(torch.aminmax(idx))
                          for _, idx, _ in named]).tolist()
    for (arg, _, n_rows), (lo, hi) in zip(named, bounds):
        require(0 <= lo and hi < n_rows,
                f"{name}: {arg} holds rows [{lo}, {hi}] outside [0, {n_rows})")


def row_and_popcount_indexed(a: torch.Tensor, ia: torch.Tensor | None,
                             b: torch.Tensor, ib: torch.Tensor | None
                             ) -> torch.Tensor:
    """out[i] = sum_w popcount(a[ia[i], w] & b[ib[i], w]).

    a [ra, words], b [rb, words] int32 bitmaps; ia, ib [n] int32 row
    indices, or None for row i itself -> out [n] int32."""
    if a.device.type == "cpu":
        return row_and_popcount_plain(a, ia, b, ib)
    name = "row_and_popcount"
    require(a.device.type == "cuda", f"{name}: unsupported device {a.device}")
    check_cuda_args(name, a.device, a=a, ia=ia, b=b, ib=ib)
    require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[1],
            f"{name}: a and b must be [rows, words] with equal words")
    require(a.dtype == torch.int32 and b.dtype == torch.int32,
            f"{name}: a and b must be int32 bitmaps")
    words = a.shape[1]
    sides = (("ia", ia, a), ("ib", ib, b))
    _check_indices(name, [(arg, idx, rows.shape[0])
                          for arg, idx, rows in sides if idx is not None])
    lengths = {rows.shape[0] if idx is None else idx.shape[0]
               for _, idx, rows in sides}
    require(len(lengths) == 1, f"{name}: the two sides pair {lengths} rows")
    n = lengths.pop()
    require(words < 2**31, f"{name}: {words} words per row exceed int32")
    vec = (words % GROUP_WORDS == 0 and a.data_ptr() % 16 == 0
           and b.data_ptr() % 16 == 0)
    out = torch.empty(n, dtype=torch.int32, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if ia is None and ib is None:  # dense: stream both rows
            rc = lib.grape_row_and_popcount(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), n, words,
                int(vec), stream)
            check_rc(lib, rc, name)
        else:  # indexed: occupancy summaries, then the pair pass
            same = a is b
            sw = summary_words(words)
            scratch = []  # (zeroed row flags or None, summaries) a side
            for t, idx in ((a, ia),) if same else ((a, ia), (b, ib)):
                every = idx is None or (same and ib is None)
                scratch.append((
                    None if every else torch.zeros(
                        t.shape[0], dtype=torch.uint8, device=t.device),
                    torch.empty((t.shape[0], sw), dtype=torch.int32,
                                device=t.device)))
            (fa, oa), (fb, ob) = scratch * 2 if same else scratch
            rc = lib.grape_row_and_popcount_indexed(
                a.data_ptr(), _ptr(ia), _ptr(fa), oa.data_ptr(), a.shape[0],
                b.data_ptr(), _ptr(ib), _ptr(fb), ob.data_ptr(), b.shape[0],
                out.data_ptr(), n, words, sw, int(vec), int(same), stream)
            check_rc(lib, rc, name)
    count_launch(row_and_popcount_indexed)
    return out


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


row_and_popcount_indexed.launches = 0


def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense form: out[i] = sum_w popcount(a[i, w] & b[i, w]) for a, b
    [n, words] int32 (the JAX package's `intersect_count`, with no row
    multiple required)."""
    return row_and_popcount_indexed(a, None, b, None)


def reset_launch_counts() -> None:
    row_and_popcount_indexed.launches = 0


__all__ = [
    "intersect_count", "reset_launch_counts", "row_and_popcount_indexed",
    "row_and_popcount_occupancy_plain", "row_and_popcount_plain",
    "row_occupancy_plain", "summary_words",
]
