"""File IO with byte-range partial reads.

Counterpart of `libgrape_lite_tpu/io/io_adaptor.py` (reference
`grape/io/local_io_adaptor.{h,cc}`): the reference splits a file into
per-worker byte ranges (`SetPartialRead(worker_id, worker_num)`,
`local_io_adaptor.h:49`) and each MPI rank parses its slice.  Every rank
of the port's process group loads the whole graph today (the JAX
package's contract); the partial read is here for a per-rank load.
Ranges are aligned to line boundaries by scanning forward to the next
newline, as in the reference, so the parts of a file concatenate to it.
"""

from __future__ import annotations

import os


class LocalIOAdaptor:
    def __init__(self, location: str):
        self.location = location
        self._f = None
        self._start = 0
        self._end = None

    def open(self):
        self._f = open(self.location, "rb")
        if self._end is None:
            self._end = os.path.getsize(self.location)
        return self

    def set_partial_read(self, index: int, total_parts: int) -> None:
        """Restrict later reads to part `index` of `total_parts`, aligned
        to line boundaries (reference `local_io_adaptor.cc`
        SetPartialRead): a part starts after the newline at or past its
        byte offset and ends with the line spanning its end offset."""
        size = os.path.getsize(self.location)
        chunk = size // total_parts
        start = chunk * index
        end = size if index == total_parts - 1 else chunk * (index + 1)
        if self._f is None:
            self.open()
        f = self._f
        if start > 0:
            f.seek(start - 1)
            f.readline()
            start = f.tell()
        if end < size:
            f.seek(end - 1)
            f.readline()
            end = f.tell()
        self._start, self._end = start, end

    def read_bytes(self) -> bytes:
        if self._f is None:
            self.open()
        self._f.seek(self._start)
        return self._f.read(self._end - self._start)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()
        return False
