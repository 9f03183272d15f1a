"""TSV parsing for LDBC .v/.e files (numpy path).

Counterpart of `libgrape_lite_tpu/io/line_parser.py` (reference
`grape/io/tsv_line_parser.h`): whitespace-separated `src dst [edata]`
and `oid [vdata]` lines, `#` comments.  Id columns parse as int64, so
oids above 2^53 keep their precision; weights parse as float64.
"""

from __future__ import annotations

import numpy as np


def _parse_columns(path: str, int_cols: int, want_cols: int):
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


def read_vertex_file(path: str) -> np.ndarray:
    """Read a .v file; returns int64 oids."""
    return _parse_columns(path, 1, 1)[0]


def read_edge_file(path: str, weighted: bool):
    """Read a .e file; returns (src_oid, dst_oid, weight | None)."""
    cols = _parse_columns(path, 2, 3 if weighted else 2)
    w = cols[2] if (weighted and len(cols) > 2) else None
    return cols[0], cols[1], w
