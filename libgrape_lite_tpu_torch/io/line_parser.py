"""TSV parsing for LDBC .v/.e files.

Counterpart of `libgrape_lite_tpu/io/line_parser.py` (reference
`grape/io/tsv_line_parser.h`): whitespace-separated `src dst [edata]`
and `oid [vdata]` lines, `#` comments.  Integer ids go through the native
mmap + multi-threaded parser (`io/native.py` over `native/loader.cc`) and,
where that library is missing, through numpy; both keep ids as int64, so
oids above 2^53 keep their precision, and weights parse as float64.
`string_id` keeps the id columns as `str` objects (reference
`--string_id`, `load_tests.cc:45`).  `PARSE_COUNTS` counts the files
each path parsed.
"""

from __future__ import annotations

import numpy as np

from libgrape_lite_tpu_torch.io.native import parse_file_native

PARSE_COUNTS = {"native": 0, "numpy": 0, "string": 0}


def _parse_columns(path: str, int_cols: int, want_cols: int):
    """The numpy parse: id columns as int64, a weight column as float64
    (left out when the file has none)."""
    ids = np.loadtxt(
        path, dtype=np.int64, comments="#", ndmin=2, usecols=range(int_cols)
    )
    cols = [ids[:, i] for i in range(int_cols)]
    if want_cols > int_cols and len(ids):
        try:
            extra = np.loadtxt(
                path, dtype=np.float64, comments="#", ndmin=2,
                usecols=range(int_cols, want_cols),
            )
        except (ValueError, IndexError):
            return cols  # no weight column: an unweighted file
        cols.extend(extra[:, i] for i in range(extra.shape[1]))
    return cols


def _parse_string_table(path: str, id_cols: int, weighted: bool):
    """String-oid parse: the id columns stay `str` objects; a weight
    column parses as float64."""
    with open(path, encoding="utf-8") as f:
        rows = [line.split() for line in f
                if line.strip() and not line.lstrip().startswith("#")]
    out = [np.asarray([r[i] for r in rows], dtype=object)
           for i in range(id_cols)]
    if weighted and rows and all(len(r) > id_cols for r in rows):
        out.append(np.asarray([r[id_cols] for r in rows], dtype=np.float64))
    return out


def read_vertex_file(path: str, string_id: bool = False) -> np.ndarray:
    """Read a .v file; returns oids (int64, or `str` objects)."""
    if string_id:
        PARSE_COUNTS["string"] += 1
        return _parse_string_table(path, 1, False)[0]
    nat = parse_file_native(path, 1, False)
    if nat is not None:
        PARSE_COUNTS["native"] += 1
        return nat[0]
    PARSE_COUNTS["numpy"] += 1
    return _parse_columns(path, 1, 1)[0]


def read_edge_file(path: str, weighted: bool, string_id: bool = False):
    """Read a .e file; returns (src_oid, dst_oid, weight | None)."""
    if string_id:
        PARSE_COUNTS["string"] += 1
        cols = _parse_string_table(path, 2, weighted)
        return cols[0], cols[1], cols[2] if len(cols) > 2 else None
    nat = parse_file_native(path, 2, weighted)
    if nat is not None:
        PARSE_COUNTS["native"] += 1
        return nat
    PARSE_COUNTS["numpy"] += 1
    cols = _parse_columns(path, 2, 3 if weighted else 2)
    w = cols[2] if (weighted and len(cols) > 2) else None
    return cols[0], cols[1], w
