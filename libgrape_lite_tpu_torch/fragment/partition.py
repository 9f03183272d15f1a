"""Partition records.

Counterpart of the record half of `libgrape_lite_tpu/fragment/
partition.py`: `PARTITION_STATS`, where the loader records what
`--rebalance` did (per-shard in-edge counts and skew before and after,
under the key "rebalance").  The 1-D / 2-D partition resolution
(`resolve_partition`) and its records belong to the vertex cut, which
the port does not have yet.
"""

from __future__ import annotations

PARTITION_STATS: dict = {}
