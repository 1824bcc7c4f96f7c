"""Per-client codec negotiation: preference list -> registry row.

The port's copy of ``selkies_tpu/signalling/negotiate.py``: the
availability probes are the port's library wrappers and the column
budget is the port's ``parallel/codec_mesh.budget_cols``.

The reference pipeline promises three encoders (tpuh264enc /
tpuav1enc / tpuvp9enc) but picks ONE at process start from config.  This
module closes the loop per client: the browser's HELLO meta carries a
codec preference list (``{"codecs": ["av1", "h264"]}``), the server
resolves it here against

* the registry's codec rows (models/registry.py: every encoder row
  declares its codec; tools/check_codec_rows.py ratchets that), and
  whether the row's backing library actually probes in this image;
* the session's chip carve — a fleet slot on the lockstep batch shard
  (MultiSessionH264Service: one chip, one sharded H.264 step for the
  whole slice) cannot host a per-session AV1/VP9 mesh encoder, so only
  carves with per-session chip rows (BandedFleetService / solo) are
  av1/vp9-eligible, and the row width bounds the tile-column count;

and the winning codec selects the encoder row, the SDP offer codec, and
thereby the RTP payloader (transport/webrtc/peer.py) end-to-end.  The
resolver is pure (no I/O beyond the availability probes) so the
preference-list -> row -> payloader walk is unit-testable
(tests/test_negotiation.py).

``SELKIES_CODEC`` sets the server-side preference list used when the
client does not send one (comma-separated, first supported wins);
unset, the server keeps the configured encoder row.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

logger = logging.getLogger("signalling.negotiate")

__all__ = ["NegotiatedCodec", "resolve", "server_preferences",
           "codec_available", "CODEC_ROWS"]

# codec name -> the registry row that serves it when negotiated per
# client (the TPU-native rows; the registry's other rows are explicit
# SELKIES_ENCODER choices, not negotiation targets)
CODEC_ROWS = {
    "h264": "tpuh264enc",
    "av1": "tpuav1enc",
    "vp9": "tpuvp9enc",
    "vp8": "vp8enc",
    "h265": "x265enc",
}


@dataclass
class NegotiatedCodec:
    codec: str       # lowercase codec name ("h264"/"av1"/...)
    encoder: str     # registry row serving it
    cols: int        # tile columns the carve supports (1 = no mesh)
    reason: str      # why this codec won (logs + /statz)


def codec_available(codec: str) -> bool:
    """Does the backing library for this codec's row probe in this
    image?  h264 is always available (the from-scratch TPU row)."""
    codec = codec.lower()
    if codec == "h264":
        return True
    if codec == "av1":
        # the tile-column splice path (modern or legacy libaom) OR the
        # realtime hybrid row
        from selkies_tpu_torch.models.libaom_enc import (
            aom_strip_available, libaom_available)

        return aom_strip_available() or libaom_available()
    if codec in ("vp9", "vp8"):
        from selkies_tpu_torch.models.libvpx_enc import libvpx_available

        return libvpx_available()
    if codec == "h265":
        from selkies_tpu_torch.models.x265enc import x265_available

        return x265_available()
    return False


def server_preferences() -> list[str]:
    """SELKIES_CODEC: comma-separated server-side preference list."""
    env = os.environ.get("SELKIES_CODEC", "")
    return [c.strip().lower() for c in env.split(",") if c.strip()]


def resolve(preferences, *, session_chips: int = 1,
            per_session_carve: bool = True,
            fallback: str = "h264") -> NegotiatedCodec:
    """Resolve a client's codec preference list against the registry and
    the session's chip carve.

    ``session_chips`` is the number of chips the placer granted this
    session (its tile-column budget); ``per_session_carve`` is False on
    the lockstep batch shard, where every session rides ONE sharded
    H.264 step and a per-session AV1/VP9 encoder has no chips to mesh
    over — there only h264 can win.  Unknown codec names are skipped
    (forward compatibility with browsers offering codecs this build
    never heard of)."""
    prefs = [str(c).lower() for c in (preferences or [])]
    if not prefs:
        prefs = server_preferences()
    if not prefs:
        prefs = [fallback]
    from selkies_tpu_torch.parallel.codec_mesh import budget_cols

    # tile-column budget: the chips the placer granted the session,
    # clamped by SELKIES_TILE_COLS when the operator pins one (the same
    # helper the fleet's per-session encoder builds apply)
    cols = budget_cols(session_chips) if per_session_carve else 1
    for codec in prefs:
        if codec not in CODEC_ROWS:
            logger.info("skipping unknown codec preference %r", codec)
            continue
        if codec not in ("h264",) and not per_session_carve:
            logger.info("codec %r refused: session rides the lockstep "
                        "batch carve (no per-session chips to mesh)", codec)
            continue
        if not codec_available(codec):
            logger.info("codec %r refused: backing library not available",
                        codec)
            continue
        return NegotiatedCodec(
            codec=codec, encoder=CODEC_ROWS[codec],
            cols=cols if codec in ("av1", "vp9") else 1,
            reason="client-preference" if preferences else "server-default")
    return NegotiatedCodec(codec=fallback, encoder=CODEC_ROWS[fallback],
                           cols=1, reason="fallback")
