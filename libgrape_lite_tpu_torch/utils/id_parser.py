"""Global-ID bit codec (counterpart of `libgrape_lite_tpu/utils/id_parser.py`).

gid = [fid : high bits][lid : low bits], as the reference `IdParser`
(`grape/fragment/id_parser.h:23-60`).  Pure shift/mask on Python ints and
numpy arrays.
"""

from __future__ import annotations

import numpy as np


class IdParser:
    """Encode/decode (fid, lid) <-> gid with a fixed bit split;
    `lid_bits` = ceil(log2(max_lid_capacity))."""

    def __init__(self, fnum: int, max_lid_capacity: int, dtype=np.int64):
        if fnum < 1:
            raise ValueError("fnum must be >= 1")
        fid_bits = max(1, int(np.ceil(np.log2(max(fnum, 2)))))
        lid_bits = max(1, int(np.ceil(np.log2(max(max_lid_capacity, 2)))))
        total = np.dtype(dtype).itemsize * 8 - 1  # keep sign bit clear
        if fid_bits + lid_bits > total:
            raise ValueError(
                f"fid_bits({fid_bits}) + lid_bits({lid_bits}) > {total}; "
                "use a wider dtype"
            )
        self.fnum = fnum
        self.fid_bits = fid_bits
        self.lid_bits = lid_bits
        self.dtype = np.dtype(dtype)
        self.lid_mask = (1 << lid_bits) - 1

    def generate(self, fid, lid):
        return (fid << self.lid_bits) | lid

    def get_fid(self, gid):
        return gid >> self.lid_bits

    def get_lid(self, gid):
        return gid & self.lid_mask

    def max_local_num(self) -> int:
        return 1 << self.lid_bits

    def __repr__(self):
        return (
            f"IdParser(fnum={self.fnum}, fid_bits={self.fid_bits}, "
            f"lid_bits={self.lid_bits})"
        )
