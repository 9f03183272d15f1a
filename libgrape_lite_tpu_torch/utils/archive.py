"""Byte archives and varint codecs (host side).

Counterpart of `libgrape_lite_tpu/utils/archive.py` (reference
`grape/serialization/{in,out}_archive.h`, `grape/utils/varint.h:39-402`):
the In/Out archive and the LEB128 `varint_*` / `delta_varint_*` codecs
that the garc fragment cache (`fragment/loader.py`) writes.  The same
bytes as the JAX package's, so either package reads the other's cache.
The native library (`io/native.py`) encodes and decodes when it built;
the vectorised numpy paths below give the same bytes otherwise.
"""

from __future__ import annotations

import struct

import numpy as np


class InArchive:
    """Append-only byte buffer (reference in_archive.h:43-244)."""

    def __init__(self):
        self._parts: list[bytes] = []

    def add_bytes(self, b: bytes) -> None:
        self._parts.append(bytes(b))

    def add_scalar(self, v, fmt: str = "<q") -> None:
        self._parts.append(struct.pack(fmt, v))

    def add_array(self, a: np.ndarray) -> None:
        a = np.ascontiguousarray(a)
        self.add_scalar(a.nbytes)
        self._parts.append(a.tobytes())

    def get_buffer(self) -> bytes:
        return b"".join(self._parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts)


class OutArchive:
    """Cursor-based reader with zero-copy array views
    (reference out_archive.h `SetSlice`)."""

    def __init__(self, buf: bytes):
        self._buf = memoryview(buf)
        self._pos = 0

    def get_bytes(self, n: int) -> memoryview:
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def get_scalar(self, fmt: str = "<q"):
        n = struct.calcsize(fmt)
        (v,) = struct.unpack(fmt, self.get_bytes(n))
        return v

    def get_array(self, dtype) -> np.ndarray:
        nbytes = self.get_scalar()
        return np.frombuffer(self.get_bytes(nbytes), dtype=dtype)

    def empty(self) -> bool:
        return self._pos >= len(self._buf)


# ---- varint / delta-varint (reference varint.h) ----

def varint_encode(values: np.ndarray) -> bytes:
    """LEB128 encode an unsigned int64 array (native fast path,
    vectorised numpy fallback)."""
    v = np.asarray(values, dtype=np.uint64)
    if len(v) == 0:
        return b""
    from libgrape_lite_tpu_torch.io.native import varint_encode_native

    nat = varint_encode_native(v, delta=False)
    if nat is not None:
        return nat
    nbytes = np.maximum((70 - _clz64(v)) // 7, 1)  # ceil(bits/7), min 1
    total = int(nbytes.sum())
    out = np.zeros(total, dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    rem = v.copy()
    for b in range(10):  # max 10 bytes for 64-bit
        active = nbytes > b
        if not active.any():
            break
        byte = (rem & np.uint64(0x7F)).astype(np.uint8)
        more = (b + 1) < nbytes
        byte = np.where(more, byte | 0x80, byte)
        out[(offs + b)[active]] = byte[active]
        rem >>= np.uint64(7)
    return out.tobytes()


def varint_decode(buf: bytes) -> np.ndarray:
    from libgrape_lite_tpu_torch.io.native import varint_decode_native

    nat = varint_decode_native(buf, delta=False)
    if nat is not None:
        return nat
    b = np.frombuffer(buf, dtype=np.uint8)
    if len(b) == 0:
        return np.zeros(0, dtype=np.uint64)
    if b[-1] & 0x80:
        # truncated mid-value: match the native decoder instead of
        # silently dropping the tail
        raise ValueError("corrupt varint stream: trailing bytes have "
                         "no terminator")
    is_last = (b & 0x80) == 0
    ends = np.nonzero(is_last)[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    out = np.zeros(len(ends), dtype=np.uint64)
    max_len = int((ends - starts).max()) + 1
    for k in range(max_len):
        pos = starts + k
        active = pos <= ends
        low7 = (b[pos[active]] & np.uint64(0x7F)).astype(np.uint64)
        out[active] |= low7 << np.uint64(7 * k)
    return out


def delta_varint_encode(sorted_values: np.ndarray) -> bytes:
    """Delta + varint for non-decreasing streams
    (reference DeltaVarintEncoder, varint.h:283-316)."""
    v = np.asarray(sorted_values, dtype=np.uint64)
    if len(v) == 0:
        return b""
    from libgrape_lite_tpu_torch.io.native import varint_encode_native

    nat = varint_encode_native(v, delta=True)
    if nat is not None:
        return nat
    deltas = np.diff(v, prepend=np.uint64(0))
    return varint_encode(deltas)


def delta_varint_decode(buf: bytes) -> np.ndarray:
    from libgrape_lite_tpu_torch.io.native import varint_decode_native

    nat = varint_decode_native(buf, delta=True)
    if nat is not None:
        return nat
    return np.cumsum(varint_decode(buf), dtype=np.uint64)


def _clz64(v: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64 via float64 exponent trick +
    correction (exact for all uint64)."""
    v = np.asarray(v, dtype=np.uint64)
    bits = np.zeros(len(v), dtype=np.int64)
    x = v.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        m = x >= (np.uint64(1) << np.uint64(shift))
        bits[m] += shift
        x = np.where(m, x >> np.uint64(shift), x)
    # bits = floor(log2(v)) for v>0; clz = 63 - bits; v==0 -> 64
    return np.where(v == 0, 64, 63 - bits)
