"""Multi-host cluster plane of the port: membership, capacity routing, migration.

The port's copy of ``selkies_tpu/cluster/``, whole, exporting JAX's
``__all__`` (and the plane's switch ``ENV_PEERS``). Its wire — the
heartbeat envelope and its HMAC, the capacity digest, the ``REDIRECT``
record and the shipped checkpoint — is JAX's, so port hosts and JAX hosts
join one cluster.

Turns N independent selkies-tpu hosts into one service (ROADMAP item 4's
multi-host tentpole). Three halves, each usable alone:

* :mod:`~selkies_tpu_torch.cluster.membership` — per-host :class:`ClusterNode`
  heartbeating a signed capacity digest to the static seed list in
  ``SELKIES_CLUSTER_PEERS``, with lease-based failure detection and
  capped-backoff re-join;
* :mod:`~selkies_tpu_torch.cluster.router` — :class:`ClusterRouter` answers
  client HELLOs on the signalling plane: serve locally or redirect to
  the best-scoring peer (free capacity up, chronic SLO burn and
  quarantined chips down, codec capability respected);
* :mod:`~selkies_tpu_torch.cluster.migrate` — cross-host live migration of
  the PR 6 session checkpoints over an authenticated channel, driven by
  the drain controller's migrate-off-then-stop mode.

The plane is OFF unless ``SELKIES_CLUSTER_PEERS`` is set; a single-host
deployment pays nothing. :func:`build_cluster_plane` is the wiring
helper the orchestrators call.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from selkies_tpu_torch.cluster.membership import (
    ENV_PEERS,
    ClusterNode,
    build_digest,
    capacity_rows_from_env,
    cluster_enabled,
    cluster_peers_from_env,
    cluster_self_from_env,
    load_capacity_rows,
    measured_max_sessions,
)
from selkies_tpu_torch.cluster.migrate import (
    HttpMigrationChannel,
    LocalMigrationChannel,
    MigrationError,
    MigrationTarget,
    migrate_session,
    migration_stats,
)
from selkies_tpu_torch.cluster.router import (
    ClusterRouter,
    Redirect,
    parse_redirect,
    ws_url_of,
)

__all__ = [
    "ENV_PEERS",
    "ClusterNode",
    "ClusterPlane",
    "ClusterRouter",
    "HttpMigrationChannel",
    "LocalMigrationChannel",
    "MigrationError",
    "MigrationTarget",
    "Redirect",
    "build_cluster_plane",
    "build_digest",
    "capacity_rows_from_env",
    "cluster_enabled",
    "cluster_peers_from_env",
    "cluster_self_from_env",
    "load_capacity_rows",
    "measured_max_sessions",
    "migrate_session",
    "migration_stats",
    "parse_redirect",
    "wire_cluster_plane",
    "ws_url_of",
]


@dataclass
class ClusterPlane:
    """One host's assembled cluster wiring (node + router + optional
    migration halves), as attached to an orchestrator."""

    node: ClusterNode
    router: ClusterRouter
    target: MigrationTarget | None = None
    channel: HttpMigrationChannel | None = field(default=None)

    def stats(self) -> dict:
        """/statz ``cluster`` provider block."""
        return {
            "membership": self.node.stats(),
            "router": self.router.stats(),
            "migrations": migration_stats(),
        }

    async def start(self) -> None:
        await self.node.start()

    async def stop(self) -> None:
        await self.node.stop()
        if self.channel is not None:
            await self.channel.close()


def build_cluster_plane(*, fleet=None, is_local_session=None,
                        digest_fn=None) -> ClusterPlane:
    """Assemble the plane from the ``SELKIES_CLUSTER_*`` knobs:
    node + router always; the migration target/channel only when a
    fleet is wired (solo hosts route and heartbeat but don't receive
    migrations — a solo process has exactly one session shape)."""
    node = ClusterNode.from_env(digest_fn=digest_fn)
    router = ClusterRouter(node, is_local_session=is_local_session)
    target = channel = None
    if fleet is not None:
        target = MigrationTarget(fleet=fleet, secret=node.secret,
                                 advertise=node.host)
        channel = HttpMigrationChannel(secret=node.secret)
    return ClusterPlane(node=node, router=router, target=target,
                        channel=channel)


def wire_cluster_plane(plane: ClusterPlane, server, *,
                       enable_basic_auth: bool = False) -> ClusterPlane | None:
    """Attach an assembled plane to a signalling server, or refuse.

    The ``/cluster`` routes dispatch BEFORE the server's basic auth
    (HMAC replaces it there) — with no secret configured they would be
    the only unauthenticated write surface on an otherwise
    auth-protected server, so a basic-auth server without
    ``SELKIES_CLUSTER_SECRET`` refuses to wire the plane at all. The
    ONE place this security policy lives for both orchestrators.
    Returns the plane when wired, None when refused (the caller leaves
    its ``.cluster`` unset)."""
    import logging

    from selkies_tpu_torch.monitoring.telemetry import telemetry

    logger = logging.getLogger("cluster")
    if bool(enable_basic_auth) and not plane.node.secret:
        logger.error(
            "SELKIES_CLUSTER_SECRET is unset while basic auth is on; "
            "cluster plane DISABLED (unsigned /cluster routes would "
            "bypass the server's auth)")
        return None
    if not plane.node.secret:
        logger.warning("cluster plane running UNSIGNED "
                       "(SELKIES_CLUSTER_SECRET unset) — closed "
                       "networks only")
    server.cluster_router = plane.router
    server.ws_routes["/cluster/heartbeat"] = plane.node.http_handler
    if plane.target is not None:
        server.ws_routes["/cluster/migrate"] = plane.target.http_handler
    telemetry.register_provider("cluster", plane.stats)
    return plane
