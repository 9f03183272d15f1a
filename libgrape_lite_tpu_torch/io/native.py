"""ctypes binding to the repo's native C++ loader (`native/loader.cc`).

Counterpart of `libgrape_lite_tpu/io/native.py`.  The port compiles
`native/loader.cc` itself at first use, never at import:

    g++ -O3 -std=c++17 -fPIC -shared -pthread native/loader.cc

into `build/native/libgrape_native-<digest>.so`, the digest covering the
source and the flags (as `ops/_build.py` names the CUDA libraries), so
nothing is written into `native/`.  It binds the entry points the JAX
binding uses: the mmap + multi-threaded TSV parser (`parse_file_native`),
the stable counting sort of a CSR build (`sort_edges_native`), the LEB128
codecs of the garc cache (`varint_{en,de}code_native`), the byte-plane
transpose of its float streams (`byte_split` / `byte_join`), and the
vertex map's open-addressing id table (`NativeIdTable`) and minimal
perfect hash (`NativeMph`).  This is host code: where the compiler or
the build is missing, every caller keeps a numpy path with the same
result (`available()` says which one runs).  `GRAPE_TPU_NO_NATIVE`
(the JAX package's variable) turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "loader.cc"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
#: why the library is not in use (None while it is, or before first use)
UNAVAILABLE_REASON: str | None = None


def lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgrape_native-{digest[:16]}.so"


def _build() -> Path:
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} native/loader.cc failed:\n{r.stderr}")
    os.replace(tmp, out)  # a concurrent dlopen never sees a partial file
    return out


def _bind(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {
        "gl_parse": (vp, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int]),
        "gl_num_rows": (i64, [vp]),
        "gl_col0": (ctypes.POINTER(i64), [vp]),
        "gl_col1": (ctypes.POINTER(i64), [vp]),
        "gl_colw": (ctypes.POINTER(ctypes.c_double), [vp]),
        "gl_all_weighted": (ctypes.c_int, [vp]),
        "gl_free": (None, [vp]),
        "gl_sort_edges": (None, [i64p, i64p, vp, i64, i64, i64, i64p, i64p,
                                 vp, i64p]),
        "gl_ht_build": (vp, [i64p, i64]),
        "gl_ht_insert": (None, [vp, i64p, i64, vp]),
        "gl_ht_lookup": (None, [vp, i64p, i64, i64p]),
        "gl_ht_size": (i64, [vp]),
        "gl_ht_oids": (None, [vp, i64p]),
        "gl_ht_free": (None, [vp]),
        "gl_mph_build": (vp, [i64p, i64]),
        "gl_mph_pos": (None, [vp, i64p, i64, i64p]),
        "gl_mph_free": (None, [vp]),
        "gl_varint_count": (i64, [u8p, i64]),
        "gl_varint_decode": (i64, [u8p, i64, u64p, i64, ctypes.c_int]),
        "gl_varint_size": (i64, [u64p, i64, ctypes.c_int]),
        "gl_varint_encode": (i64, [u64p, i64, u8p, i64, ctypes.c_int]),
        "gl_byte_split": (None, [u8p, i64, ctypes.c_int, u8p]),
        "gl_byte_join": (None, [u8p, i64, ctypes.c_int, u8p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, UNAVAILABLE_REASON
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("GRAPE_TPU_NO_NATIVE"):
            UNAVAILABLE_REASON = "GRAPE_TPU_NO_NATIVE is set"
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
            _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError,
                AttributeError) as e:
            UNAVAILABLE_REASON = f"{type(e).__name__}: {e}"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library built and loaded (it builds here)."""
    return _load() is not None


def byte_split(a: np.ndarray) -> np.ndarray:
    """[n] itemsize-wide array -> [itemsize, n] uint8 planes."""
    n, itemsize = len(a), a.dtype.itemsize
    flat = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    lib = _load()
    if lib is not None and n:
        out = np.empty(itemsize * n, dtype=np.uint8)
        lib.gl_byte_split(flat, n, itemsize, out)
        return out.reshape(itemsize, n)
    return flat.reshape(n, itemsize).T.copy()


def byte_join(planes: np.ndarray, dtype) -> np.ndarray:
    """Inverse of byte_split: [itemsize, n] uint8 planes -> [n] dtype."""
    itemsize, n = planes.shape
    if np.dtype(dtype).itemsize != itemsize:
        raise ValueError(f"{itemsize} planes for a {np.dtype(dtype)} array")
    lib = _load()
    if lib is not None and n:
        out = np.empty(itemsize * n, dtype=np.uint8)
        lib.gl_byte_join(np.ascontiguousarray(planes).reshape(-1), n,
                         itemsize, out)
        return out.view(dtype)
    return np.ascontiguousarray(planes.T).reshape(-1).view(dtype)


def varint_encode_native(vals: np.ndarray, delta: bool) -> bytes | None:
    """LEB128 (optionally delta) encode; None without the library."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vals, dtype=np.uint64)
    if len(v) == 0:
        return b""
    size = lib.gl_varint_size(v, len(v), int(delta))
    out = np.empty(size, dtype=np.uint8)
    if lib.gl_varint_encode(v, len(v), out, size, int(delta)) != size:
        return None
    return out.tobytes()


def varint_decode_native(buf: bytes, delta: bool) -> np.ndarray | None:
    """LEB128 (optionally delta-accumulated) decode; None without the
    library.  Raises on a truncated stream."""
    lib = _load()
    if lib is None:
        return None
    b = np.frombuffer(buf, dtype=np.uint8)
    if len(b) == 0:
        return np.zeros(0, dtype=np.uint64)
    n = lib.gl_varint_count(b, len(b))
    out = np.empty(n, dtype=np.uint64)
    got = lib.gl_varint_decode(b, len(b), out, n, int(delta))
    if got != n:
        raise ValueError(
            f"corrupt varint stream: decoded {got} of {n} values")
    return out


def _as_i64(a) -> np.ndarray | None:
    """Contiguous int64 copy of an integer array; None for other dtypes
    (string-keyed graphs keep the numpy paths)."""
    arr = np.asarray(a)
    if not np.issubdtype(arr.dtype, np.integer):
        return None
    return np.ascontiguousarray(arr, dtype=np.int64)


class NativeIdTable:
    """Open-addressing oid -> lid table, lid = insertion order (the
    reference `IdIndexer`, grape/graph/id_indexer.h)."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    @classmethod
    def build(cls, oids: np.ndarray) -> "NativeIdTable | None":
        lib = _load()
        o = _as_i64(oids)
        if lib is None or o is None:
            return None
        h = lib.gl_ht_build(o, len(o))
        return cls(lib, h) if h else None

    def insert(self, oids: np.ndarray) -> np.ndarray:
        """Arrival-order setdefault; returns each input's lid."""
        o = _as_i64(oids)
        if o is None:
            raise TypeError("NativeIdTable.insert: non-integer oids")
        out = np.empty(len(o), dtype=np.int64)
        self._lib.gl_ht_insert(self._h, o, len(o), out.ctypes.data)
        return out

    def lookup(self, oids: np.ndarray) -> np.ndarray:
        o = _as_i64(oids)
        if o is None:  # a non-integer query is never in an int64 table
            return np.full(len(np.asarray(oids)), -1, dtype=np.int64)
        out = np.empty(len(o), dtype=np.int64)
        self._lib.gl_ht_lookup(self._h, o, len(o), out)
        return out

    def size(self) -> int:
        return int(self._lib.gl_ht_size(self._h))

    def oids(self) -> np.ndarray:
        out = np.empty(self.size(), dtype=np.int64)
        self._lib.gl_ht_oids(self._h, out)
        return out

    def __del__(self):
        h, self._h = self._h, None
        if h and self._lib is not None:
            self._lib.gl_ht_free(h)


class NativeMph:
    """Minimal perfect hash over int64 keys (PTHash-style build; the
    reference `pthash_idxer.h`)."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    @classmethod
    def build(cls, keys: np.ndarray) -> "NativeMph | None":
        lib = _load()
        k = _as_i64(keys)
        if lib is None or k is None or len(k) == 0:
            return None
        h = lib.gl_mph_build(k, len(k))
        return cls(lib, h) if h else None

    def positions(self, keys: np.ndarray) -> np.ndarray:
        """A position in [0, n) per key; arbitrary for unknown keys
        (callers check against their lid -> oid array)."""
        k = _as_i64(keys)
        out = np.empty(len(k), dtype=np.int64)
        self._lib.gl_mph_pos(self._h, k, len(k), out)
        return out

    def __del__(self):
        h, self._h = self._h, None
        if h and self._lib is not None:
            self._lib.gl_mph_free(h)


def sort_edges_native(src, nbr, w, num_rows: int, num_cols: int):
    """Stable counting sort by (src, nbr) plus indptr; returns (src, nbr,
    w | None, indptr) as int64 / float64, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    src64 = np.ascontiguousarray(src, dtype=np.int64)
    nbr64 = np.ascontiguousarray(nbr, dtype=np.int64)
    n = len(src64)
    if n:
        # the counting sort indexes raw ids: out-of-range ids must raise
        # here, not write past its arrays
        if int(src64.min()) < 0 or int(src64.max()) >= num_rows:
            raise ValueError("sort_edges_native: src id out of range")
        if int(nbr64.min()) < 0 or int(nbr64.max()) >= num_cols:
            raise ValueError("sort_edges_native: nbr id out of range")
    w64 = None if w is None else np.ascontiguousarray(w, dtype=np.float64)
    out_src = np.empty(n, dtype=np.int64)
    out_nbr = np.empty(n, dtype=np.int64)
    out_w = None if w is None else np.empty(n, dtype=np.float64)
    indptr = np.empty(num_rows + 1, dtype=np.int64)
    lib.gl_sort_edges(
        src64, nbr64, None if w64 is None else w64.ctypes.data,
        n, num_rows, num_cols, out_src, out_nbr,
        None if out_w is None else out_w.ctypes.data, indptr,
    )
    return out_src, out_nbr, out_w, indptr


def parse_file_native(path: str, ncols: int, weighted: bool):
    """(col0 int64, col1 int64 | None, w float64 | None), or None without
    the library.  `w` is None when not every row has a weight."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.gl_parse(os.fsencode(path), ncols, int(weighted), 0)
    if not handle:
        raise FileNotFoundError(path)
    try:
        n = lib.gl_num_rows(handle)
        if n == 0:  # empty columns come back as NULL pointers
            return (np.zeros(0, np.int64),
                    np.zeros(0, np.int64) if ncols >= 2 else None,
                    np.zeros(0, np.float64) if weighted else None)
        c0 = np.ctypeslib.as_array(lib.gl_col0(handle), shape=(n,)).copy()
        c1 = (np.ctypeslib.as_array(lib.gl_col1(handle), shape=(n,)).copy()
              if ncols >= 2 else None)
        w = None
        if weighted and lib.gl_all_weighted(handle):
            w = np.ctypeslib.as_array(lib.gl_colw(handle), shape=(n,)).copy()
    finally:
        lib.gl_free(handle)
    return c0, c1, w
