"""The switch of the cluster plane.

The port's copy of ``ENV_PEERS`` and ``cluster_enabled`` from
``selkies_tpu/cluster/membership.py`` (lines 72 and 80-82), unchanged.
``ClusterNode``, the capacity digest and the rest of membership wait for
ROADMAP queue 1, item 3.4.
"""

from __future__ import annotations

import os

__all__ = ["ENV_PEERS", "cluster_enabled"]

ENV_PEERS = "SELKIES_CLUSTER_PEERS"


def cluster_enabled() -> bool:
    """The cluster plane exists exactly when a peer seed list does."""
    return bool(os.environ.get(ENV_PEERS, "").strip())
