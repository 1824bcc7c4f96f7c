"""Multi-host cluster plane of the port — only what the solo server reads.

Counterpart of ``selkies_tpu/cluster/``. The port holds copies of the
redirect record the signalling client follows (``router.py``: ``Redirect``,
``parse_redirect``, ``ws_url_of``) and the plane's switch
(``membership.py``: ``ENV_PEERS``, ``cluster_enabled``). Membership,
routing, migration and ``build_cluster_plane`` wait for ROADMAP queue 1,
item 3.4; until then the orchestrator raises when the plane is switched on.
"""

from selkies_tpu_torch.cluster.membership import ENV_PEERS, cluster_enabled
from selkies_tpu_torch.cluster.router import Redirect, parse_redirect, ws_url_of

__all__ = ["ENV_PEERS", "Redirect", "cluster_enabled", "parse_redirect", "ws_url_of"]
