"""Core type vocabulary (counterpart of `libgrape_lite_tpu/utils/types.py`).

The enums keep the reference's names and values (`grape/types.h:81-104`)
so that apps written against either package read the same.
"""

from __future__ import annotations

import enum


class LoadStrategy(enum.Enum):
    """How edges are attached to fragments (reference `grape/types.h:81-86`)."""

    kOnlyOut = "only_out"
    kOnlyIn = "only_in"
    kBothOutIn = "both_out_in"
    kNullLoadStrategy = "null"


class MessageStrategy(enum.Enum):
    """How cross-fragment messages flow (reference `grape/types.h:98-104`).

    With every fragment stacked on one device, each strategy reduces to
    indexing the flattened `[fnum * vp]` state; the names are kept for
    parity with the apps' traits."""

    kAlongOutgoingEdgeToOuterVertex = "along_out_edge"
    kAlongIncomingEdgeToOuterVertex = "along_in_edge"
    kAlongEdgeToOuterVertex = "along_edge"
    kSyncOnOuterVertex = "sync_on_outer_vertex"
    kGatherScatter = "gather_scatter"
