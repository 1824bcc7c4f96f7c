"""Fleet serving — the ``--tpu_sessions N`` product path.

The port's copy of ``selkies_tpu/parallel/fleet.py`` up to ``dryrun``
(``fleet.py:1-1075``): ``SessionSlot``, ``_FleetRecovery``, ``SessionFleet``
and ``dryrun``, over the port's services (``TorchMultiSessionH264Service``
for one band, ``TorchBandedFleetService`` for more, ``SoftwareFleetService``
on the ladder's software rung), placer, occupancy scheduler, supervisor,
policy and SLO planes. Where it departs from JAX (ROADMAP queue 3,
"Interface differences of the fleet loop"):

* ``SessionFleet(devices=None)`` takes the port's device pool's cards and
  raises without a card; the CPU runs only when the caller passes CPU
  devices. The batch service splits its sessions over ``devices``, one
  group per device (on the pool's first healthy card when it is None),
  the banded service takes the placer's rows, the software rung runs on
  the first of ``devices``, and ``dryrun(n)`` puts its n sessions on one
  card.
* A slot's planes may be passed in: ``ws=None`` builds the port's
  ``WebSocketTransport`` (so this module imports without ``aiohttp``
  until a slot needs one), and ``webrtc=None`` the port's
  ``WebRTCTransport``, as JAX's slot builds its own. With no peer
  connected the mux routes media and control to the WebSocket plane.
* ``FleetOrchestrator(cfg, devices=None)`` (``fleet.py:1077-1768``: the
  ``--tpu_sessions N`` server with signalling, WebRTC, audio, input, the
  drain and the cluster plane) takes ``devices`` as ``SessionFleet`` does.
  ``DeviceMonitor`` takes ``TPUMonitor``'s place and is not built on the
  CPU. The server stack (aiohttp, the input host) is imported when a
  ``FleetOrchestrator`` is built, not with this module. Its drain flush
  counts ticks where JAX's polls ``_tick_in_flight`` (``_drain_flush``).

One host process serves N concurrent browser sessions off ONE batched
device step (parallel/serving.TorchMultiSessionH264Service): session k's
browser connects to the same web/signalling server as solo mode, speaks
the same protocol, and gets its own media transport (WebRTC preferred,
``/media/<k>`` WebSocket fallback), its own input host, and its own
rate-control loop — while every encode tick runs all N sessions as one
batched step on the card (K1 launched once per tick with a P session).
Peer-id convention extends the reference's browser=1/server=2 pair
(reference __main__.py:555): session k uses browser ``1+10k`` / server
``2+10k``, so session 0 remains exactly the reference convention and a
stock client needs no changes for it.

Session fan-in/fan-out per tick:

    [slot 0 source] ─┐                       ┌─► slot 0 transport
    [slot 1 source] ─┼─► (N,H,W,4) batch ──► │   (per-slot AU)
        ...          │   TorchMultiSession   └─► slot k transport
    [slot N source] ─┘   H264Service.encode_tick

Per-session divergence (QP, force-IDR) rides the service's per-session
IDR/P choice; per-session *geometry/framerate* cannot diverge — the batch
is lockstep — so client fps/resize requests are acknowledged but pinned to
the fleet configuration.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

import numpy as np

from selkies_tpu_torch.models.h264.ratecontrol import CbrRateController
from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.pipeline.elements import EncodedFrame, SyntheticSource
from selkies_tpu_torch.resilience import SlotSupervisor, get_injector
from selkies_tpu_torch.transport.mux import TransportMux
from selkies_tpu_torch.transport.congestion import GccController
from selkies_tpu_torch.transport.recovery import RecoveryController
from selkies_tpu_torch.transport.webrtc.transport import WebRTCTransport

logger = logging.getLogger("fleet")

__all__ = ["SessionSlot", "SessionFleet", "FleetOrchestrator", "dryrun"]


def browser_peer_id(session: int) -> int:
    """Session k's browser registers as this signalling peer id."""
    return 1 + 10 * session


def server_client_id(session: int) -> int:
    return 2 + 10 * session


class SessionSlot:
    """Per-session serving state: both byte planes, input host, RC.

    ``ws`` and ``webrtc`` are the slot's planes; ``ws=None`` builds a
    ``WebSocketTransport`` and ``webrtc=None`` a ``WebRTCTransport`` with
    ``webrtc_audio`` and ``turn_tls_insecure``, as JAX's slot does."""

    def __init__(self, index: int, *, bitrate_kbps: int, fps: int,
                 codec: str = "h264", webrtc_audio: bool = False,
                 turn_tls_insecure: bool = False, ws=None, webrtc=None):
        self.index = index
        if ws is None:
            # aiohttp is imported only for a slot that needs the WS plane
            from selkies_tpu_torch.transport.websocket import WebSocketTransport

            ws = WebSocketTransport()
        self.ws = ws
        self.ws.session = str(index)  # telemetry seq->frame correlation
        self.webrtc = webrtc if webrtc is not None else WebRTCTransport(
            audio=webrtc_audio, turn_tls_insecure=turn_tls_insecure)
        self.webrtc.set_codec(codec)
        self.transport = TransportMux(self.ws, self.webrtc,
                                      fault_site=f"send:{index}")
        self.rc = CbrRateController(bitrate_kbps=bitrate_kbps, fps=fps)
        self.gcc: GccController | None = None
        self.recovery: RecoveryController | None = None  # _wire_slots
        self.input = None  # the host input plane (FleetOrchestrator wires it)
        self.audio = None  # per-session AudioPipeline (fleet._wire_audio)
        self.audio_lock = asyncio.Lock()  # serializes audio start/stop
        self.connected = False
        self.frames = 0
        # resilience accounting (SessionFleet._run): consecutive counts
        self.send_failures = 0
        self.capture_failures = 0
        # cumulative (packetsLost, packetsReceived) from the last client
        # stats upload — interval loss for GCC on the WS plane
        self.last_loss_counters = (0.0, 0.0)

    # -- server→client control vocabulary (the TPUWebRTCApp subset a
    #    fleet slot needs; same wire format, gstwebrtc_app.py:1454-1579)

    def _send(self, msg_type: str, data) -> None:
        if self.transport.data_channel_ready:
            self.transport.send_data_channel(
                json.dumps({"type": msg_type, "data": data}))

    def send_codec(self, codec: str) -> None:
        self._send("codec", {"codec": codec})

    def send_ping(self, t: float) -> None:
        self._send("ping", {"start_time": float(f"{t:.3f}")})

    def send_system_stats(self, cpu: float, total: float, used: float) -> None:
        self._send("system_stats",
                   {"cpu_percent": cpu, "mem_total": total, "mem_used": used})

    def send_cursor_data(self, data) -> None:
        self._send("cursor", data)

    def send_clipboard_data(self, text: str) -> None:
        import base64

        payload = base64.b64encode(text.encode()).decode()
        if len(payload) <= 65400:
            self._send("clipboard", {"content": payload})

    def send_latency_time(self, ms: float) -> None:
        self._send("latency_measurement", {"latency_ms": ms})


class _FleetRecovery:
    """RecoveryActions for the batched fleet tick (resilience/supervisor).

    The sharded step is lockstep, so rung actions are fleet-wide: the
    force-IDR lands on every session (the failed tick may have corrupted
    any reference plane), RESTART rebuilds the whole service, and the
    degradation ladder sheds fps then swaps to the software service —
    per-session resolution divergence is impossible in a lockstep batch
    (docs/fleet.md), so the resolution rung maps to a second fps halving.
    """

    def __init__(self, fleet: "SessionFleet"):
        self.fleet = fleet

    def warn(self, msg: str) -> None:
        logger.warning("%s", msg)

    def force_idr(self) -> None:
        for k in range(self.fleet.n):
            self.fleet.service.force_keyframe(k)

    def restart_encoder(self) -> None:
        self.fleet.restart_service()

    def degrade(self, level: int) -> None:
        self.fleet.apply_degrade(level)

    def undegrade(self, level: int) -> None:
        self.fleet.apply_degrade(level)

    def recycle(self) -> None:
        self.fleet.recycle_sessions()


class SessionFleet:
    """Media core for N sessions: one device tick, N output streams.

    ``sources`` is a list of per-session FrameSources (defaults to
    distinct SyntheticSources). The tick loop skips device work while no
    session has a client — an idle fleet costs no device time.

    The loop is supervised (resilience/supervisor.py): tick failures climb
    the recovery ladder — warn → batch force-IDR → service rebuild with
    capped backoff → fps shedding / software-encoder fallback → session
    recycle — and the loop itself never returns. Per-slot capture and send
    failures are accounted separately so one poisoned session is ejected
    (``on_slot_poisoned``) instead of taking the sharded batch down.
    """

    # consecutive per-slot failures before the slot is ejected
    SEND_FAILURE_LIMIT = 30
    CAPTURE_FAILURE_LIMIT = 120

    def __init__(self, slots: list[SessionSlot], *, width: int, height: int,
                 fps: int, qp: int = 28, sources=None, devices=None,
                 service=None, supervisor: SlotSupervisor | None = None,
                 placer=None):
        from selkies_tpu_torch.parallel.bands import bands_from_env, grid_from_env
        from selkies_tpu_torch.parallel.lifecycle import SessionPlacer
        from selkies_tpu_torch.parallel.serving import (
            TorchBandedFleetService, TorchMultiSessionH264Service)

        self.slots = slots
        self.n = len(slots)
        self.width, self.height, self.fps = width, height, fps
        self.base_fps = fps
        self.qp = qp
        self._devices = devices
        # the batch service splits its sessions over the devices given
        # (None: the pool's first healthy card); the software rung runs on
        # the first
        self._device = devices[0] if devices else None
        # chips-per-session trade (SELKIES_BANDS / SELKIES_TILE_GRID):
        # 1 band keeps the classic one-session-per-chip lockstep shard;
        # B>1 gives every session a B-chip band row for intra-frame
        # slice parallelism (parallel/bands.py), and RxC carves a
        # two-axis tile grid per session (rows*cols chips each, the
        # 4K/8K split-frame placement) — fewer sessions per slice,
        # each faster
        grid = grid_from_env()
        rows_, cols_ = grid if grid is not None else (bands_from_env(), 1)
        self.grid = (rows_, cols_)
        bands = rows_ * cols_  # chips per session (the placer's unit)
        self.bands = bands
        # the carve is MUTABLE state owned by the placer (parallel/
        # lifecycle.py): admission gates client connects against it, and
        # for banded services re-carves move chips between sessions live
        self.placer = placer or SessionPlacer(devices=devices, bands=bands,
                                              grid=self.grid)
        self.placer.place_initial(self.n, bands)
        # queue promotion: a release frees chips, the placer grants them
        # to a queued session, and THIS rebuilds its encoder on the new
        # row so the client's reconnect retry serves from it
        self.placer.on_admitted = self._on_promoted
        if bands > 1:
            logger.info("fleet: %s — %s per-session encoders (%d sessions)",
                        f"SELKIES_TILE_GRID={rows_}x{cols_}" if cols_ > 1
                        else f"SELKIES_BANDS={bands}",
                        "tile-grid" if cols_ > 1 else "band-parallel", self.n)
            # rebuilds (supervisor RESTART rung) read the placer's LIVE
            # carve, so a restarted service keeps any borrowed chips
            # codecs come from the placer too: a supervisor service
            # rebuild mid-AV1-session must come back as AV1
            self._make_tpu_service = lambda: TorchBandedFleetService(
                self.n, width, height, qp=qp, fps=self.base_fps,
                bands=rows_, cols=cols_, devices=devices,
                rows=[self.placer.row(k) for k in range(self.n)],
                codecs=[self.placer.codec(k) for k in range(self.n)],
                # shared small-slice rows band-slice at the full carve;
                # non-shared rows SMALLER than it were shrunk by a chip
                # quarantine and rebuild on fewer bands (serving.py
                # _row_bands) — a restart must reconstruct that shape
                shared=self.placer.shared)
        else:
            self._make_tpu_service = lambda: TorchMultiSessionH264Service(
                self.n, width, height, qp=qp, fps=self.base_fps, devices=devices or None)
        self.service = service or self._make_tpu_service()
        self.software_mode = False
        # occupancy scheduler bound to the live service (built lazily on
        # the first tick; rebuilt when a restart swaps the service)
        self._occ = None
        self._occ_service = None
        telemetry.register_provider("occupancy", self._occupancy_stats)
        self.sources = sources or [
            SyntheticSource(width, height, seed=k) for k in range(self.n)]
        # zero-initialized, not np.empty: a slot whose FIRST capture fails
        # rides "its previous frame", which must be black — never
        # uninitialized heap memory encoded and sent to a client
        self._batch = np.zeros((self.n, height, width, 4), np.uint8)
        self._geometry_warned: set[int] = set()
        self._task: asyncio.Task | None = None
        self._watchdog_task: asyncio.Task | None = None
        self.watchdog_interval = 1.0
        # restart/tick serialization (both touched only on the event loop)
        self._tick_in_flight = False
        self._tick_started_at = 0.0
        self._restart_pending = False
        self._pending_recarves: list[int] = []
        self.ticks = 0
        self.last_tick_ms = 0.0
        self.on_tick = lambda device_ms: None  # monitoring tap
        # a persistently-failing slot is ejected through this hook; the
        # FleetOrchestrator rewires it to its disconnect path so transport
        # teardown and signalling re-arm happen too
        self.on_slot_poisoned = self._default_poison
        self.supervisor = supervisor or SlotSupervisor(
            "fleet", _FleetRecovery(self), fps=float(fps))
        # scenario-adaptive policy (selkies_tpu/policy, SELKIES_POLICY=1):
        # one engine per SLOT — classification state is per session —
        # actuating through whatever per-session encoder the live service
        # exposes. Banded/codec-mesh sessions classify via the skip-
        # fraction fallback (their FrameStats carry no upload
        # attribution, hence the total_mbs plumbing) and actuate the
        # knob subset their encoder exports; the LOCKSTEP batch service
        # has no per-session encoder OR per-session stats, so its slots
        # skip the policy tick entirely. Fault sites policy:<k>.
        self.policies = None
        from selkies_tpu_torch.policy import policy_enabled

        if policy_enabled():
            from selkies_tpu_torch.policy import (
                EncoderActuator, PolicyEngine, PolicyRuntime,
                preset_from_env)

            total_mbs = ((height + 15) // 16) * ((width + 15) // 16)
            preset = preset_from_env()
            self.policies = [
                PolicyRuntime(
                    PolicyEngine(session=str(k), preset=preset,
                                 total_mbs=total_mbs,
                                 fault_site=f"policy:{k}"),
                    EncoderActuator(lambda k=k: self._session_encoder(k)))
                for k in range(self.n)
            ]
            telemetry.register_provider("policy", self._policy_rollup)

        # serving SLO plane (monitoring/slo.py, SELKIES_SLO=1): one
        # SessionSLO per SLOT sharing the fleet supervisor (its sticky
        # WARN rung refcounts by session key). A slot's acute breach
        # sheds its OWN downlink bytes — the bitrate target halves, the
        # per-session CBR follows — before anything touches the lockstep
        # tick rate every other session shares; relief restores the
        # pre-shed target. Opting in turns the telemetry bus on (the
        # plane is a bus consumer).
        self.slos = None
        self._slo_shed_kbps: dict[int, int] = {}
        from selkies_tpu_torch.monitoring.slo import slo_enabled

        if slo_enabled():
            from selkies_tpu_torch.monitoring import jitprof
            from selkies_tpu_torch.monitoring.slo import SessionSLO

            telemetry.enable()
            jitprof.install()
            self.slos = [
                SessionSLO(session=str(k), supervisor=self.supervisor)
                for k in range(self.n)
            ]
            for k, slo in enumerate(self.slos):
                slo.on_pressure = (lambda k=k: self._slo_shed(k))
                slo.on_relief = (lambda k=k: self._slo_restore(k))
                if self.policies is not None:
                    self.policies[k].engine.on_scenario = slo.set_scenario
            telemetry.register_provider("slo", self._slo_rollup)
            telemetry.register_provider("compile", jitprof.stats)
            telemetry.register_slo(self._slo_health)

    def _slo_rollup(self) -> dict:
        if self.slos is None:
            return {}
        return {str(k): s.stats() for k, s in enumerate(self.slos)}

    def _slo_health(self) -> dict:
        if self.slos is None:
            return {}
        return {str(k): s.health_view() for k, s in enumerate(self.slos)
                if self.slots[k].connected}

    def _slo_shed(self, k: int) -> None:
        if k in self._slo_shed_kbps:
            return
        cur = int(self.slots[k].rc.bitrate_kbps)
        shed = max(250, cur // 2)
        if shed >= cur:
            # already at/below the shed floor: RAISING the target under
            # pressure would be the opposite of shedding — leave it
            return
        self._slo_shed_kbps[k] = cur
        logger.warning("session %d SLO breach: shedding bitrate %d -> %d "
                       "kbps (bytes before fps)", k, cur, shed)
        self.set_session_bitrate(k, shed)

    def _slo_restore(self, k: int) -> None:
        prior = self._slo_shed_kbps.pop(k, None)
        if prior is not None:
            logger.info("session %d SLO recovered: restoring %d kbps",
                        k, prior)
            self.set_session_bitrate(k, prior)

    def reset_session_slo(self, k: int) -> None:
        """Client departure (disconnect / release / poison-eject): the
        breach belonged to the departed client's traffic — restore any
        shed bitrate and clear the windows + sticky WARN so the next
        admit starts clean, as the codec record is cleared on release)."""
        if self.slos is None:
            return
        self._slo_restore(k)
        self.slos[k].reset()

    def _session_encoder(self, k: int):
        """Session k's per-session encoder on the LIVE service, or None
        (lockstep batch service / parked slot) — the policy actuator
        resolves through this so supervisor service rebuilds are seen."""
        encs = getattr(self.service, "encoders", None)
        return encs[k] if encs is not None and k < len(encs) else None

    def _policy_rollup(self) -> dict:
        if self.policies is None:
            return {}
        return {str(k): rt.engine.stats()
                for k, rt in enumerate(self.policies)}

    def _default_poison(self, k: int) -> None:
        logger.error("session %d ejected (persistent failures)", k)
        self.slots[k].connected = False
        self.reset_session_slo(k)

    # -- lifecycle control plane (parallel/lifecycle.py) ---------------

    def release_session(self, k: int) -> None:
        """Tear session k out of the carve (migrated away for good —
        NOT the eject path, whose client reconnects into its kept row):
        its chips go back to the pool — possibly promoting a queued
        session (on_admitted rebuilds the promoted encoder) — then k's
        now-rowless encoder is parked so nothing keeps encoding its
        unwatched frames on the freed chips. Encoders sharing a chip
        for the one deferred tick in between is benign (the shared
        fallback carve runs that way permanently, parallel/bands.py)."""
        codecs = getattr(self.service, "codecs", None)
        if codecs is not None:
            # the negotiated codec left with the client (placer.release
            # clears its record too); the next admit rebuilds as h264
            # until the new client's negotiation says otherwise
            codecs[k] = "h264"
        self.reset_session_slo(k)
        self.placer.release(k)
        self._recarve_safely(k)

    def _on_promoted(self, k: int) -> None:
        """placer.on_admitted: a queued session was just granted a row
        on someone else's release — rebuild its encoder there so the
        client's reconnect retry serves from the new chips."""
        self._recarve_safely(int(k))

    def admit_client(self, k: int):
        """Admission gate for a client connecting to session k. A
        ``chips-lent`` queue answer means this idle session lent its
        band chips away: reclaim them (pressure) and retry once."""
        adm = self.placer.admit(k)
        if adm.decision == "queue" and adm.reason == "chips-lent":
            for borrower in self.placer.borrowers_from(k):
                self.return_bands(borrower)
            adm = self.placer.admit(k)
        if adm.accepted:
            self.placer.set_busy(k, True)
            # a released-then-re-admitted session comes back with a row
            # but a PARKED encoder (recarve(k, []) on release): rebuild
            # it on the freshly granted chips or the client streams b""
            encs = getattr(self.service, "encoders", None)
            if encs is not None and encs[k] is None and self.placer.row(k):
                self._recarve_safely(k)
        return adm

    def _recarve_safely(self, k: int) -> bool:
        """Rebuild session k's encoder on its CURRENT placer row —
        deferred past an in-flight tick exactly like a service restart
        (swapping an encoder under the worker thread's encode would
        abort the pack mid-frame)."""
        if not hasattr(self.service, "recarve"):
            return False
        if self._tick_in_flight:
            self._pending_recarves.append(k)
            return True
        try:
            self.service.recarve(k, self.placer.row(k))
        except Exception:
            # recarve raises BEFORE touching the encoder (incl. injected
            # migrate faults), so the session keeps serving its old row
            logger.exception("re-carve of session %d failed; encoder "
                             "keeps its current row", k)
            return False
        return True

    def _apply_pending_recarves(self) -> None:
        while self._pending_recarves:
            k = self._pending_recarves.pop(0)
            try:
                self.service.recarve(k, self.placer.row(k))
                # a deferred encoder build that degraded the codec (e.g.
                # an av1 mesh that failed to construct) must heal the
                # placer's record too, or a supervisor rebuild re-seeds
                # the failed codec forever
                self.placer.set_codec(k, self.session_codec(k))
            except Exception:
                logger.exception("deferred re-carve of session %d failed", k)
                # mirror the synchronous borrow path's rollback: if k is
                # a borrower, settle its debts so the carve never
                # disagrees with the running encoders (return_bands
                # rebuilds both sides on their restored rows; a failure
                # there keeps the old encoders on those same rows —
                # still consistent). No tick is in flight here, so
                # nothing re-enters this queue.
                if self.return_bands(k):
                    logger.warning("rolled back session %d's borrow after "
                                   "its deferred re-carve failed", k)

    def borrow_bands(self, k: int) -> bool:
        """Dynamic re-carve: move an idle session's band chips to busy
        session k and rebuild its encoder (byte continuity via the
        restored encoder's forced IDR). A failed/injected re-carve
        undoes the borrow before any encoder state moves — never a
        leaked chip, never a carve the encoders disagree with."""
        try:
            chips = self.placer.borrow(k)
        except Exception as exc:
            logger.warning("re-carve borrow for session %d failed: %r", k, exc)
            return False
        if not chips:
            return False
        if not self._recarve_safely(k):
            # the rebuild never happened (service without recarve, or
            # checkpoint/build raised before touching the encoder):
            # settle the debt so the carve matches the running encoders
            self.placer.return_borrowed(k)
            return False
        # park each lender whose whole row was just lent: left running,
        # the lent chips would carry the borrower's enlarged mesh AND
        # the lender's unwatched frames every tick
        for sid, state in self.placer.states().items():
            if state == "lent":
                self._recarve_safely(int(sid))
        return True

    def return_bands(self, k: int) -> bool:
        """Return session k's borrowed chips to their lenders and
        rebuild both sides' encoders on their restored rows."""
        settled = self.placer.return_borrowed(k)
        if not settled:
            return False
        ok = self._recarve_safely(k)
        for lender, _ in settled:
            if self.placer.row(lender):
                self._recarve_safely(lender)
        return ok

    # -- device health plane (resilience/devhealth.py) -----------------

    def note_device_failure(self, exc: BaseException) -> bool:
        """Classify a failed tick as a device error: a DeviceFault in
        the exception chain names the chip (the deterministic chaos
        plane); jax/XLA-shaped failures fall back to probing the carve —
        the failing mesh coordinate mapped to a chip. Crossing the
        failure threshold quarantines the chip and re-carves every
        session whose row held it onto the SHRUNK mesh (an emptied row
        ejects the slot via the existing poison path — never the whole
        batch). Returns True when a chip was newly quarantined."""
        key = self._classify_device_failure(exc)
        if key is None:
            return False
        self._quarantine_chip(key)
        return True

    def _classify_device_failure(self, exc: BaseException) -> str | None:
        """The (possibly probing, hence blocking) classification half —
        the serving loop runs this via to_thread and applies the
        quarantine on the loop, where the re-carve guard is race-free."""
        from selkies_tpu_torch.resilience.devhealth import note_tick_failure

        return note_tick_failure(exc, self.placer.devices)

    def _quarantine_chip(self, key: str) -> None:
        """Placement half of a quarantine: pull the chip out of the
        carve and rebuild the affected sessions on their shrunk rows
        (deferred past an in-flight tick like every re-carve). Byte
        continuity rides the same checkpoint/restore + forced-IDR
        machinery as a borrow."""
        affected = self.placer.quarantine(key)
        for k in affected:
            if not self.placer.row(k):
                # 0 surviving chips: the SLOT dies, not the batch — the
                # client reconnects into freed capacity once chips exist
                logger.error("session %d lost its last chip to the "
                             "quarantine of %s; ejecting slot", k, key)
                self.on_slot_poisoned(k)
            self._recarve_safely(k)

    def _device_health_tick(self) -> None:
        """Synchronous health work (tests, direct callers): probation
        probes then the carve sync. The watchdog splits the two — the
        probes (which can block on sick hardware) go to a thread, the
        carve mutations stay on the event loop where the
        ``_tick_in_flight`` re-carve guard is race-free."""
        from selkies_tpu_torch.resilience import peek_device_pool

        pool = peek_device_pool()
        if pool is None:
            return
        pool.tick()
        self._device_health_sync(pool)

    def _device_health_sync(self, pool) -> None:
        """Converge the placer to the pool's health view (no probes, no
        blocking — loop-safe): quarantines the pool discovered outside
        the tick path (flap noise crossing the threshold) shrink the
        carve, and chips the pool readmitted rejoin it. Reconciles by
        STATE, not by tick()'s return value — another consumer (the
        solo pipeline's watchdog, a second fleet) may have driven the
        probes that readmitted a chip."""
        for key in pool.quarantined_keys():
            if self.placer.owns(key) and not self.placer.is_quarantined(key):
                self._quarantine_chip(key)
        for key in self.placer.quarantined_keys():
            if not pool.is_quarantined(key):
                home = self.placer.readmit(key)
                if home is not None:
                    self._recarve_safely(home)

    def checkpoint_all(self) -> list:
        """Drain hand-off: checkpoint every connected session's minimal
        encoder state (lifecycle.checkpoint_session)."""
        from selkies_tpu_torch.parallel.lifecycle import checkpoint_session

        cks = []
        for k, slot in enumerate(self.slots):
            if not slot.connected:
                continue
            try:
                cks.append(checkpoint_session(self.service, k, slot=slot))
            except Exception:
                logger.exception("checkpointing session %d failed", k)
        return cks

    # -- per-session controls (wired to slot transports/input) ---------

    def session_codec(self, k: int) -> str:
        """Session k's live codec (h264 unless negotiation changed it)."""
        codecs = getattr(self.service, "codecs", None)
        return codecs[k] if codecs else "h264"

    def negotiate_session(self, k: int, preferences):
        """Resolve a client's codec preference list (HELLO meta) against
        the registry rows and this session's chip carve, rebuilding the
        session's encoder when the codec changes (deferred past an
        in-flight tick exactly like a lifecycle re-carve). Returns the
        NegotiatedCodec that actually holds — a failed rebuild degrades
        back to h264 inside the service and is reported as such."""
        from selkies_tpu_torch.signalling import negotiate

        per_session = hasattr(self.service, "recarve")
        row = self.placer.row(k)
        n = negotiate.resolve(preferences,
                              session_chips=max(1, len(row)),
                              per_session_carve=per_session)
        if per_session and self.service.set_codec(k, n.codec):
            self._recarve_safely(k)
        codec = self.session_codec(k)
        self.placer.set_codec(k, codec)
        if codec != n.codec:
            n = negotiate.NegotiatedCodec(
                codec=codec,
                encoder=negotiate.CODEC_ROWS.get(codec, "tpuh264enc"),
                cols=1, reason="rebuild-degraded")
        logger.info("session %d negotiated codec %s (%s, %d chips)",
                    k, n.codec, n.reason, len(row))
        telemetry.event("codec_negotiated", session=str(k), codec=n.codec,
                        reason=n.reason, chips=len(row))
        return n

    def force_keyframe(self, session: int) -> None:
        self.service.force_keyframe(session)

    def set_session_bitrate(self, session: int, kbps: int) -> None:
        self.slots[session].rc.set_bitrate(int(kbps))
        if hasattr(self.service, "set_bitrate"):
            # degraded software mode: the encoder's own CBR takes the
            # target directly (its set_qp is a no-op by design)
            self.service.set_bitrate(session, int(kbps))

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        if self._task is None:
            loop = asyncio.get_running_loop()
            self._task = loop.create_task(self._run())
            self._watchdog_task = loop.create_task(self._watchdog())

    async def stop(self) -> None:
        for attr in ("_task", "_watchdog_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        if self._occ is not None:
            self._occ.close()
            self._occ = None
            self._occ_service = None
        self.service.close()

    # -- recovery ladder plumbing (called via _FleetRecovery) ----------

    # a tick stalled longer than this is treated as WEDGED: the restart is
    # applied under it (its thread raises into the tick try/except and is
    # counted) — deferring forever would make the watchdog a no-op for the
    # exact scenario it exists for
    FORCE_RESTART_STALL_S = 20.0

    def restart_service(self) -> None:
        """Rebuild the encode service. A tick mid-flight in the worker
        thread (the watchdog escalates on slow-but-alive ticks too) only
        REQUESTS the swap — closing the live service under the encode
        would abort the pack mid-frame — unless the tick has been stuck
        past FORCE_RESTART_STALL_S, in which case the swap is forced: a
        wedged device call never returns to apply a pending restart."""
        if self._tick_in_flight:
            stalled = time.monotonic() - self._tick_started_at
            if stalled < self.FORCE_RESTART_STALL_S:
                self._restart_pending = True
                logger.warning("fleet service restart requested (tick in "
                               "flight %.1fs; applying after it returns)",
                               stalled)
                return
            logger.error("fleet tick wedged for %.1fs; forcing service "
                         "restart under it", stalled)
        self._do_restart_service()

    def _do_restart_service(self) -> None:
        from selkies_tpu_torch.parallel.serving import SoftwareFleetService

        self._restart_pending = False
        # a full service rebuild re-reads the placer's live carve, so any
        # deferred per-session re-carves are subsumed by it
        self._pending_recarves.clear()
        old = self.service
        logger.warning("rebuilding fleet service (software_mode=%s)",
                       self.software_mode)
        if self.software_mode:
            self.service = SoftwareFleetService(
                self.n, self.width, self.height, qp=self.qp,
                fps=max(1, int(self.fps)),
                bitrate_kbps=[int(s.rc.bitrate_kbps) for s in self.slots],
                device=self._device)
        else:
            self.service = self._make_tpu_service()
        try:
            old.close()
        except Exception:
            logger.exception("closing failed fleet service")

    def apply_degrade(self, level: int) -> None:
        """Converge to degradation ``level``: 0 = full rate device service,
        1 = half fps, 2 = quarter fps (the lockstep batch cannot diverge
        resolution per session), 3 = quarter fps + software encoders."""
        new_fps = max(1, self.base_fps // (2 ** min(level, 2)))
        software = level >= 3
        if new_fps != self.fps:
            logger.warning("fleet fps %s -> %s (degrade level %d)",
                           self.fps, new_fps, level)
            self.fps = new_fps
            for slot in self.slots:
                slot.rc.set_framerate(new_fps)
        if software != self.software_mode:
            self.software_mode = software
            self.restart_service()

    def recycle_sessions(self) -> None:
        """Last rung: eject every connected client (they reconnect into a
        fresh session) and rebuild the service."""
        for k, slot in enumerate(self.slots):
            if slot.connected:
                self.on_slot_poisoned(k)
        self.restart_service()

    async def _watchdog(self) -> None:
        """Tick-deadline watchdog: catches a *silent* stall (a device call
        that neither returns nor raises keeps _run awaiting and unable to
        report), escalating through the same ladder."""
        while True:
            await asyncio.sleep(self.watchdog_interval)
            if any(s.connected for s in self.slots):
                self.supervisor.check_deadline()
            else:
                self.supervisor.note_idle()
            try:
                # probation probes can block (device round-trips to sick
                # hardware, injected delay faults): they run off the
                # loop; the carve sync then runs ON the loop so the
                # _tick_in_flight re-carve guard stays race-free —
                # a thread-side recarve could read the flag as clear
                # just as the loop dispatches the next encode tick
                from selkies_tpu_torch.resilience import peek_device_pool

                pool = peek_device_pool()
                if pool is not None:
                    await asyncio.to_thread(pool.tick)
                    self._device_health_sync(pool)
            except Exception:
                logger.exception("device health tick failed")

    def _capture_batch(self) -> list[tuple[int, Exception]]:
        """Capture every session's frame. A source that throws (X server
        died, injected fault) keeps its slot's PREVIOUS frame in the batch
        and is reported to the caller — one session's dead display must
        not take the lockstep batch down. Returns [(slot, exc), ...]."""
        h, w = self.height, self.width
        fi = get_injector()
        failed: list[tuple[int, Exception]] = []
        for k, src in enumerate(self.sources):
            try:
                if fi is not None:
                    fi.check(f"capture:{k}")
                frame = src.capture()
            except Exception as exc:
                failed.append((k, exc))
                continue
            if frame.shape[:2] == (h, w):
                self._batch[k] = frame
                continue
            # a runtime xrandr resize on one display must not take the
            # whole lockstep batch down: fit the capture to the fleet
            # geometry (crop / zero-pad) and keep streaming
            if k not in self._geometry_warned:
                self._geometry_warned.add(k)
                logger.warning(
                    "session %d capture is %dx%d but fleet geometry is "
                    "%dx%d; fitting (fleet geometry is fixed per run)",
                    k, frame.shape[1], frame.shape[0], w, h)
            fh, fw = min(h, frame.shape[0]), min(w, frame.shape[1])
            self._batch[k] = 0
            self._batch[k, :fh, :fw] = frame[:fh, :fw]
        return failed

    def _encode_tick(self) -> tuple[list[bytes], list[bool], list[int], float]:
        t0 = time.perf_counter()
        fi = get_injector()
        if fi is not None:
            fi.check("encoder")
        # snapshot: a supervisor-driven restart may swap self.service
        # while this runs on the worker thread; qps, AUs and idr flags
        # must all come from the SAME service instance
        service = self.service
        qps = [slot.rc.frame_qp() for slot in self.slots]
        for k, qp in enumerate(qps):
            service.set_qp(k, qp)
        # overlapped occupancy scheduling (parallel/occupancy.py): same
        # per-session bytes, session A's host front-end/pack overlapping
        # session B's device step. SELKIES_OCCUPANCY=0 (or a service
        # with no schedulable shape — the software fallback) takes the
        # serial lockstep tick.
        occ = self._occupancy_for(service)
        if occ is not None:
            aus = occ.encode_tick(self._batch)
        else:
            aus = service.encode_tick(self._batch)
        # per-session downlink modes from the SAME service instance (the
        # swap-safety rule above); stashed rather than returned so the
        # tuple callers keep their shape
        self._last_modes = list(getattr(service, "last_modes", ()))
        if self.policies is not None:
            # per-slot scenario policy: observe each session's frame
            # signals and retune its encoder's runtime-safe knobs.
            # PolicyRuntime.tick never raises (a wedged engine disarms
            # to static knobs), so a policy fault can't poison the tick.
            with tracer.span("policy"):
                for k, rt in enumerate(self.policies):
                    if not self.slots[k].connected or not aus[k]:
                        continue
                    enc = self._session_encoder(k)
                    stats = (getattr(enc, "last_stats", None)
                             if enc is not None else None)
                    if stats is not None:
                        rt.tick([stats],
                                interval_ms=1000.0 / max(1.0, self.fps))
        return (aus, list(service.last_idrs), qps,
                (time.perf_counter() - t0) * 1e3)

    def _occupancy_for(self, service):
        """The occupancy scheduler bound to ``service``, built lazily and
        rebuilt when a supervisor restart swaps the service instance
        (re-carves mutate the encoders list in place — the scheduler's
        units resolve encoders lazily, so no rebuild is needed there).
        None when SELKIES_OCCUPANCY=0 or the service has no schedulable
        shape (software fallback, test fakes)."""
        from selkies_tpu_torch.parallel.occupancy import (
            OccupancyScheduler, occupancy_enabled)

        if not occupancy_enabled():
            return None
        if self._occ is None or self._occ_service is not service:
            if self._occ is not None:
                self._occ.close()
            self._occ = OccupancyScheduler.for_service(service)
            self._occ_service = service
        return self._occ

    def _occupancy_stats(self) -> dict:
        from selkies_tpu_torch.parallel.occupancy import occupancy_enabled

        if self._occ is None:
            return {"enabled": occupancy_enabled(), "ticks": 0}
        return self._occ.stats()

    def _note_capture_failures(self, failed: list[tuple[int, Exception]]) -> None:
        """Per-slot capture accounting: transient faults ride on the slot's
        previous frame; a persistently dead source ejects the slot."""
        failed_slots = {k for k, _ in failed}
        for k, exc in failed:
            slot = self.slots[k]
            slot.capture_failures += 1
            if slot.capture_failures == 1 or slot.capture_failures % 60 == 0:
                logger.warning("session %d capture failure #%d: %r",
                               k, slot.capture_failures, exc)
            if (slot.capture_failures >= self.CAPTURE_FAILURE_LIMIT
                    and slot.connected):
                logger.error("session %d capture dead (%d consecutive); "
                             "ejecting slot", k, slot.capture_failures)
                self.on_slot_poisoned(k)
                slot.capture_failures = 0
        for k, slot in enumerate(self.slots):
            if k not in failed_slots:
                slot.capture_failures = 0

    def _note_send_result(self, k: int, result) -> None:
        """Per-slot send accounting from the gather results (previously
        discarded): count failures, log them, eject persistent failers."""
        slot = self.slots[k]
        if isinstance(result, BaseException) or result is False:
            slot.send_failures += 1
            if isinstance(result, BaseException):
                logger.warning("session %d send failure #%d: %r",
                               k, slot.send_failures, result)
            elif slot.send_failures == 1 or slot.send_failures % 30 == 0:
                logger.info("session %d send refused #%d (client gone?)",
                            k, slot.send_failures)
            if slot.send_failures >= self.SEND_FAILURE_LIMIT and slot.connected:
                logger.error("session %d persistently failing sends (%d); "
                             "ejecting slot", k, slot.send_failures)
                self.on_slot_poisoned(k)
                slot.send_failures = 0
        else:
            slot.send_failures = 0

    async def _run(self) -> None:
        next_tick = time.monotonic()
        t0 = next_tick
        while True:
            now = time.monotonic()
            if now < next_tick:
                await asyncio.sleep(next_tick - now)
            next_tick = max(next_tick + 1.0 / self.fps,
                            time.monotonic() - 0.5 / self.fps)
            if not any(s.connected for s in self.slots):
                self.supervisor.note_idle()
                continue  # idle fleet: no capture, no device work
            # one correlation id per lockstep tick: every slot's frame
            # this tick shares it (the batch IS one device dispatch)
            fid = telemetry.next_frame_id() if telemetry.enabled else 0
            try:
                if self._restart_pending:
                    self._do_restart_service()
                self._apply_pending_recarves()
                self._tick_in_flight = True
                self._tick_started_at = time.monotonic()
                with telemetry.span("capture", fid, session="fleet"):
                    capture_failed = await asyncio.to_thread(self._capture_batch)
                self._note_capture_failures(capture_failed)
                if len(capture_failed) == self.n and self.ticks == 0:
                    # no slot has EVER captured: the batch is still all-
                    # black — count and retry rather than stream nothing
                    raise capture_failed[0][1]
                with telemetry.span("encode", fid, session="fleet"):
                    aus, idrs, qps, tick_ms = await asyncio.to_thread(self._encode_tick)
                self.ticks += 1
                self.last_tick_ms = tick_ms
                self.on_tick(tick_ms)
                ts = int((time.monotonic() - t0) * 90000)
                wall = time.time()
                sends: list[tuple[int, object]] = []  # (slot index, coroutine)
                for k, (slot, au, idr, qp) in enumerate(
                        zip(self.slots, aus, idrs, qps)):
                    if not au:
                        # parked session (chips lent away): no frame was
                        # encoded — feeding len 0 into the CBR controller
                        # would walk qp to the floor and blow up the
                        # post-reclaim recovery IDR
                        continue
                    slot.rc.update(len(au), idr=idr)
                    if not slot.connected:
                        continue
                    ef = EncodedFrame(
                        au=au, timestamp_90k=ts, wall_time=wall, idr=idr,
                        # the QP this frame was actually encoded at (rc
                        # .update above may already have moved the next)
                        qp=qp, device_ms=tick_ms,
                        pack_ms=0.0, frame_id=fid,
                    )
                    slot.frames += 1
                    if fid:
                        modes = getattr(self, "_last_modes", ())
                        telemetry.frame_done(
                            fid, len(au), idr=idr, session=str(k),
                            device_ms=tick_ms,
                            downlink_mode=modes[k] if k < len(modes) else "",
                            qp=qp,
                            rc_fullness=getattr(slot.rc, "fullness", None))
                    sends.append((k, slot.transport.send_video(ef)))
                if sends:
                    results = await asyncio.gather(
                        *(coro for _, coro in sends), return_exceptions=True)
                    for (k, _), result in zip(sends, results):
                        self._note_send_result(k, result)
                if self.slos is not None:
                    # SLO intake: the lockstep tick's wall span (capture
                    # begin → sends landed) is every slot's frame latency
                    # this tick — the batch IS one device dispatch. Must
                    # never poison the tick (a failure here would count
                    # as an encode failure and climb the ladder).
                    try:
                        lat_ms = (time.monotonic()
                                  - self._tick_started_at) * 1e3
                        for k, (slot, au) in enumerate(
                                zip(self.slots, aus)):
                            if not au or not slot.connected:
                                continue
                            slo = self.slos[k]
                            slo.observe_frame(lat_ms, len(au), fid=fid)
                            slo.evaluate()
                    except Exception:
                        logger.exception("SLO intake failed")
                self.supervisor.tick_ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # the supervisor escalates (warn → IDR → service rebuild →
                # degrade → recycle); the loop itself NEVER returns — a
                # poisoned tick must degrade quality, not availability
                logger.exception("fleet tick error (%d consecutive)",
                                 self.supervisor.failures + 1)
                self._tick_in_flight = False
                # device-error classification BEFORE the ladder acts: a
                # quarantine re-carves the hit sessions onto surviving
                # chips, so the ladder's own restart (if the streak gets
                # there) rebuilds on a healthy carve instead of the dead
                # chip forever. The classification may PROBE (blocking
                # device round-trips) — it runs off the loop; the carve
                # mutation runs on it, where _tick_in_flight is stable.
                try:
                    key = await asyncio.to_thread(
                        self._classify_device_failure, exc)
                    if key is not None:
                        self._quarantine_chip(key)
                except Exception:
                    logger.exception("device-failure classification failed")
                self.supervisor.failure(exc)
            finally:
                self._tick_in_flight = False


def dryrun(n_devices: int, devices=None) -> None:
    """Build the PRODUCT serving core — SessionSlots + SessionFleet over
    TorchMultiSessionH264Service — with ``n_devices`` sessions on one card
    (``devices``: the card by default, CPU devices on request) and run real
    ticks: the all-IDR first tick, then a mixed tick with one session
    forcing a keyframe and a diverged QP."""
    slots = [SessionSlot(k, bitrate_kbps=2000, fps=60)
             for k in range(n_devices)]
    fleet = SessionFleet(slots, width=64, height=64, fps=60, devices=devices)
    try:
        fleet._capture_batch()
        aus, idrs, _, _ = fleet._encode_tick()
        assert len(aus) == n_devices and all(idrs)
        for au in aus:
            assert au.startswith(b"\x00\x00\x00\x01") and len(au) > 50
        # steady state with per-session divergence: slot 1 (if present)
        # forces an IDR while others ride the P branch; slot 0 retunes
        fleet.force_keyframe(min(1, n_devices - 1))
        fleet.set_session_bitrate(0, 900)
        fleet._capture_batch()
        aus2, idrs2, _, _ = fleet._encode_tick()
        assert len(aus2) == n_devices
        if n_devices > 1:
            assert idrs2[1] and not idrs2[0]
        # streams must be distinct per session (distinct sources)
        assert len({bytes(a) for a in aus2}) == n_devices
    finally:
        fleet.service.close()


class FleetOrchestrator:
    """The ``selkies-tpu --tpu_sessions N`` entrypoint.

    Shares the solo Orchestrator's server construction and TURN chain
    (orchestrator.make_signalling_server / resolve_rtc_config); differs
    in the media core (SessionFleet) and in wiring one transport pair +
    input host per session. Fleet mode serves the tpuh264enc row only —
    the batched step is the multi-session program (parallel/sessions.py).

    ``devices`` is SessionFleet's: None takes the device pool's cards and
    raises without one; the CPU serves only when the caller passes it.
    The device monitor reads the card the batch service runs on; on the
    CPU none is built and no ``gpu_stats`` are sent.
    """

    def __init__(self, cfg, *, devices=None, service=None):
        self.cfg = cfg
        self.n = int(cfg.tpu_sessions)
        if self.n < 2:
            raise ValueError("FleetOrchestrator requires tpu_sessions >= 2")
        if str(cfg.encoder) != "tpuh264enc":
            logger.warning(
                "fleet mode serves the sharded tpuh264enc step; ignoring "
                "encoder=%s", cfg.encoder)
        from selkies_tpu_torch.device import resolve_device
        from selkies_tpu_torch.monitoring import DeviceMonitor, Metrics, SystemMonitor
        from selkies_tpu_torch.orchestrator import make_signalling_server

        self.metrics = Metrics(
            port=int(cfg.metrics_http_port),
            using_webrtc_csv=bool(cfg.enable_webrtc_statistics),
        )
        width, height = int(cfg.capture_width), int(cfg.capture_height)
        # one parse for both the frame sources and the input backends —
        # the two must agree on which session owns which display
        self.displays = [d.strip() for d in str(
            cfg.session_displays or "").split(",") if d.strip()]
        self.audio_devices = [d.strip() for d in str(
            cfg.session_audio_devices or "").split(",")]
        from selkies_tpu_torch.audio import opus_available

        self._opus = opus_available()
        if any(self.audio_devices) and not self._opus:
            logger.warning(
                "session_audio_devices configured but libopus is not "
                "available; fleet audio disabled")

        self.slots = [
            SessionSlot(
                k, bitrate_kbps=int(cfg.video_bitrate), fps=int(cfg.framerate),
                # the SDP offer must carry an audio m-line exactly when
                # this session will actually stream audio
                webrtc_audio=self._has_audio(k),
                turn_tls_insecure=bool(cfg.turn_tls_insecure),
            )
            for k in range(self.n)
        ]
        sources = self._make_sources(width, height)
        self.fleet = SessionFleet(
            self.slots, width=width, height=height, fps=int(cfg.framerate),
            sources=sources, devices=devices, service=service,
        )
        self._wire_audio()
        # a poisoned slot (persistent capture/send failures, recycle rung)
        # goes through the full disconnect path: transport teardown, input
        # reset, signalling re-arm — the client reconnects into a fresh
        # session instead of staring at a frozen canvas
        self.fleet.on_slot_poisoned = (
            lambda k: self._slot_disconnected(k, self.slots[k]))
        self.server = make_signalling_server(cfg)
        # /media/<k> per session; bare /media aliases session 0 so the
        # stock solo client works against a fleet server
        for k, slot in enumerate(self.slots):
            self.server.ws_routes[f"/media/{k}"] = slot.ws.handle_connection
        self.server.ws_routes["/media"] = self.slots[0].ws.handle_connection
        self.system_mon = SystemMonitor()
        # the card's monitor reads the batch service's card: none on the CPU
        device = getattr(self.fleet.service, "device", None)
        if device is None:
            device = resolve_device(devices[0] if devices else None)
        self.device_mon = (DeviceMonitor(device=device)
                           if device.type == "cuda" else None)
        if self.device_mon is not None:
            self.fleet.on_tick = lambda ms: self.device_mon.observe_encode(ms)
            self.device_mon.on_stats = self._broadcast_tpu_stats
        self._tasks: list[asyncio.Task] = []
        self._rearm: dict[int, asyncio.Event] = {}
        self._uninstall_signals = None
        self._wire_slots()
        # multi-host cluster plane (selkies_tpu_torch/cluster, on only when
        # SELKIES_CLUSTER_PEERS names peers): membership heartbeats,
        # capacity-aware HELLO routing on the signalling server, and the
        # inbound/outbound live-migration halves
        self.cluster = None
        from selkies_tpu_torch.cluster import cluster_enabled

        if cluster_enabled():
            from selkies_tpu_torch.cluster import build_cluster_plane, wire_cluster_plane

            # wire_cluster_plane owns the wire-or-refuse security policy
            # (unsigned /cluster routes on a basic-auth server)
            self.cluster = wire_cluster_plane(
                build_cluster_plane(
                    fleet=self.fleet,
                    is_local_session=self._cluster_local_session),
                self.server, enable_basic_auth=bool(cfg.enable_basic_auth))
        # graceful drain (the K8s preStop path, parallel/lifecycle.py):
        # SIGTERM stops admitting, force-IDRs every client, flushes the
        # in-flight tick, live-migrates sessions to cluster peers when
        # the plane is wired (migrate-off-then-stop), checkpoints the
        # leftovers for hand-off, then stops the serving loop and the
        # server so run() returns cleanly
        from selkies_tpu_torch.parallel.lifecycle import DrainController

        self.drain_checkpoints: list = []
        self.drainer = DrainController(
            "fleet", placer=self.fleet.placer,
            force_idr=self._drain_force_idr, flush=self._drain_flush,
            handoff=self._drain_handoff, on_drained=self._drain_exit,
            migrate=self._drain_migrate if self.cluster is not None else None)
        telemetry.register_provider("fleet", self._fleet_stats)
        telemetry.register_provider("recovery", self._recovery_stats)

    def _fleet_stats(self) -> dict:
        """/statz live view of the lockstep serving core + placement."""
        f = self.fleet
        return {
            "sessions": self.n,
            "connected": sum(1 for s in self.slots if s.connected),
            "ticks": f.ticks, "fps": f.fps,
            "last_tick_ms": round(f.last_tick_ms, 3),
            "software_mode": f.software_mode,
            "frames": {str(k): s.frames for k, s in enumerate(self.slots)},
            # placement rollup: live carve map, admission accept/reject
            # counters, queue depth, borrowed-chip count
            "placement": f.placer.stats(),
        }

    def _recovery_stats(self) -> dict:
        """/statz recovery block: one ladder per session slot."""
        return {str(k): s.recovery.stats()
                for k, s in enumerate(self.slots) if s.recovery is not None}

    # -- cluster plumbing (selkies_tpu_torch/cluster) ------------------

    def _cluster_local_session(self, uid: str) -> bool:
        """Router hook: HELLOs from clients of sessions currently
        served HERE are pinned — their encoder state and carve row live
        on this host, so redirecting a reconnect would orphan both.
        A migrated-in session inside its claim window counts too: its
        restored encoder state is parked on a not-yet-connected slot,
        and bouncing the redirected client away (e.g. because the
        restore consumed the last free slot) would strand that state
        until the claim expires and the session is lost."""
        try:
            n = int(uid)
        except (TypeError, ValueError):
            return False
        k, rem = divmod(n - 1, 10)
        if rem != 0 or not 0 <= k < self.n:
            return False
        if self.slots[k].connected:
            return True
        plane = self.cluster
        return plane is not None and k in plane.target.pending_claims

    async def _drain_migrate(self) -> list[int]:
        """Migrate-off-then-stop: for every connected session pick the
        best cluster target (codec-capable, capacity, not draining),
        ship its checkpoint, and redirect its client to the new host.
        Sessions the cluster can't place (or whose ship fails) stay
        connected and fall through to the checkpoint hand-off."""
        from selkies_tpu_torch.cluster import Redirect, migrate_session

        async def _migrate_one(k: int, slot) -> int | None:
            target = self.cluster.router.pick_migration_target(
                codec=self.fleet.session_codec(k))
            if target is None:
                logger.warning("drain: no cluster target for session %d; "
                               "leaving it for the checkpoint hand-off", k)
                return None
            try:
                ack = await migrate_session(self.fleet, k, target,
                                            self.cluster.channel,
                                            source=self.cluster.node.host)
            except Exception:
                logger.exception("drain: migrating session %d to %s "
                                 "failed; it stays for the hand-off",
                                 k, target)
                return None
            # mark the slot migrated BEFORE the redirect await: a drain
            # deadline cancelling us here must not leave a connected
            # slot for checkpoint_all to double-checkpoint (the client
            # missing its redirect degrades to the documented
            # lost-redirect path — target claim expiry)
            slot.connected = False
            # the client follows the redirect into its restored session;
            # the landing slot index rides along so a cross-index
            # landing re-registers under the right peer id. The full
            # transport teardown runs only AFTER the record is on the
            # signalling socket — the dc/pc close racing ahead of the
            # redirect would strand a browser, whose only reconnect
            # path IS the redirect itself
            await self.server.redirect_peer(
                str(browser_peer_id(k)),
                Redirect(host=target, reason="migrated",
                         session=ack.get("session")))
            self._teardown_slot(k, slot)
            return k

        # ship concurrently: migrations are independent, and one slow or
        # dead target (the 10 s HTTP ship timeout) must not serially eat
        # the shared drain deadline for sessions whose targets are fine
        moved = await asyncio.gather(
            *(_migrate_one(k, slot) for k, slot in enumerate(self.slots)
              if slot.connected),
            return_exceptions=True)
        for m in moved:
            if isinstance(m, BaseException):
                logger.error("drain migrate task failed: %r", m)
        return [m for m in moved if isinstance(m, int)]

    # -- drain plumbing (lifecycle.DrainController callbacks) ----------

    def _drain_force_idr(self) -> None:
        for k, slot in enumerate(self.slots):
            if slot.connected:
                self.fleet.force_keyframe(k)

    async def _drain_flush(self) -> None:
        """In-flight groups land on the wire: the first tick that STARTS
        after _drain_force_idr set the flags carries the forced IDR — the
        tick after the one running now, if one is — and its sends have
        landed once the loop went idle between ticks or the tick after
        it has encoded (ticks increments after a tick's encode; the next
        tick starts only after the previous sends gathered).

        JAX's flush polls for ``_tick_in_flight`` to clear. A fleet that
        runs behind its fps (8 x 1080p60 on one card) starts the next
        tick in the same loop iteration that clears the flag, so the poll
        never sees it clear and the flush runs out the drain deadline
        (leaving none for the migrate-off). The port counts ticks instead;
        the same tick carries the IDR, so the bytes are JAX's."""
        fleet = self.fleet
        target = fleet.ticks + (2 if fleet._tick_in_flight else 1)
        while (any(s.connected for s in self.slots) and fleet._task is not None
               and (fleet.ticks < target
                    or (fleet.ticks == target and fleet._tick_in_flight))):
            await asyncio.sleep(0.02)

    def _drain_handoff(self) -> list:
        self.drain_checkpoints = self.fleet.checkpoint_all()
        return self.drain_checkpoints

    async def _drain_exit(self) -> None:
        await self.fleet.stop()
        await self.server.stop()

    async def drain(self) -> bool:
        """Graceful exit: see lifecycle.DrainController.drain()."""
        return await self.drainer.drain()

    def _make_sources(self, width: int, height: int):
        """Per-session displays from ``--session_displays`` (csv of X
        DISPLAY names, e.g. ':10,:11'); sessions beyond the list — and
        sessions whose display is unreachable or mis-sized — get a
        synthetic source seeded per-session, so streams stay distinct
        even when every display fails (headless / test rigs)."""
        from selkies_tpu_torch.pipeline.capture import make_frame_source

        sources = []
        for k in range(self.n):
            src = None
            if k < len(self.displays):
                src = make_frame_source(width, height, display=self.displays[k])
                if isinstance(src, SyntheticSource):
                    src = None  # display unreachable; re-seed below
                elif (src.width, src.height) != (width, height):
                    logger.warning(
                        "session %d display %s is %dx%d; fleet geometry is "
                        "%dx%d (lockstep batch) — using synthetic source",
                        k, self.displays[k], src.width, src.height, width, height)
                    src = None
            sources.append(src if src is not None
                           else SyntheticSource(width, height, seed=k))
        return sources

    def _has_audio(self, k: int) -> bool:
        """Whether session k streams audio — the ONE predicate behind
        both the SDP audio m-line and the pipeline construction."""
        return (self._opus and k < len(self.audio_devices)
                and bool(self.audio_devices[k]))

    def _wire_audio(self) -> None:
        """Per-session audio: each fleet session's desktop pairs with its
        own PulseAudio monitor (``--session_audio_devices``). Sessions
        with a listed device get an Opus pipeline into their own
        transport; without one, fleet stays video+input for that session
        (one shared default monitor would leak audio across users)."""
        from selkies_tpu_torch.audio import AudioPipeline, open_best_audio_source

        for k, slot in enumerate(self.slots):
            slot.audio = None
            if self._has_audio(k):
                slot.audio = AudioPipeline(
                    source=open_best_audio_source(self.audio_devices[k]),
                    sink=slot.transport.send_audio,
                    bitrate_bps=int(self.cfg.audio_bitrate),
                )

    async def _apply_audio_state(self, slot: SessionSlot) -> None:
        """Converge the slot's audio pipeline to its connect state.
        Serialized per slot: fire-and-forget stop()/start() from a fast
        reconnect can interleave (start early-returns while the
        cancelled task is still unwinding) and leave a connected client
        silent; under the lock the LAST task applies the latest state."""
        if slot.audio is None:
            return
        async with slot.audio_lock:
            if slot.connected and not slot.audio.running:
                await slot.audio.start()
            elif not slot.connected and slot.audio.running:
                await slot.audio.stop()

    def _make_input(self, k: int):
        """Session k's input host. Slots with a configured display inject
        into that X server; others record into the fake backend (a fleet
        host runs one Xvfb per session, packaging/Dockerfile)."""
        from selkies_tpu_torch.input_host import HostInput
        from selkies_tpu_torch.input_host.backends import FakeBackend, X11Backend
        from selkies_tpu_torch.input_host.x11 import X11Display

        cfg = self.cfg
        backend = None
        if k < len(self.displays):
            try:
                backend = X11Backend(X11Display.open(self.displays[k]))
            except Exception as exc:
                logger.warning("session %d: X input on %s unavailable (%s)",
                               k, self.displays[k], exc)
        has_display = backend is not None
        if backend is None:
            backend = FakeBackend()
        # per-session gamepad socket directory: the selkies_js{0-3}.sock
        # names are fixed, so sessions sharing one directory would steal
        # each other's bound sockets (gamepad cross-wiring)
        js_dir = os.path.join(str(cfg.js_socket_path), f"session-{k}")
        os.makedirs(js_dir, exist_ok=True)
        return HostInput(
            backend=backend,
            js_socket_path=js_dir,
            enable_clipboard=str(cfg.enable_clipboard).lower(),
            # cursor monitoring is per-X-display (XFixes events); only
            # slots driving a real display can observe cursor changes
            enable_cursors=bool(cfg.enable_cursors) and has_display,
            cursor_size=int(cfg.cursor_size),
            cursor_debug=bool(cfg.debug_cursors),
        )

    def _wire_slots(self) -> None:
        cfg = self.cfg
        for k, slot in enumerate(self.slots):
            slot.input = self._make_input(k)
            inp = slot.input

            def on_connect(k=k, slot=slot):
                first = not slot.connected
                if first:
                    # admission control (parallel/lifecycle.py): a first
                    # plane connecting is a session asking for capacity —
                    # draining hosts, down fleets, and over-committed
                    # carves refuse here; the client's reconnect loop
                    # retries into freed capacity (queue promotion)
                    adm = self.fleet.admit_client(k)
                    if not adm.accepted:
                        logger.warning("session %d client refused: %s (%s)",
                                       k, adm.decision, adm.reason)
                        loop = asyncio.get_running_loop()
                        loop.create_task(slot.ws.close())
                        loop.create_task(slot.webrtc.stop_session())
                        return
                slot.connected = True
                if slot.gcc is not None:
                    slot.gcc.reset()
                self.fleet.force_keyframe(k)
                slot.send_codec(self.fleet.session_codec(k))
                if first and slot.audio is not None:
                    asyncio.get_running_loop().create_task(
                        self._apply_audio_state(slot))
                logger.info("session %d client connected%s", k,
                            "" if first else " (additional plane)")

            def on_ws_disconnect(k=k, slot=slot):
                if slot.webrtc.connected:
                    return
                self._slot_disconnected(k, slot)

            def on_rtc_disconnect(k=k, slot=slot):
                if slot.ws.data_channel_ready:
                    return
                self._slot_disconnected(k, slot)

            slot.ws.on_connect = on_connect
            slot.ws.on_disconnect = on_ws_disconnect
            slot.ws.on_data_message = inp.on_message
            slot.webrtc.on_connect = on_connect
            slot.webrtc.on_disconnect = on_rtc_disconnect
            slot.webrtc.on_data_message = inp.on_message
            slot.webrtc.on_force_keyframe = (
                lambda k=k: self.fleet.force_keyframe(k))

            # per-session rate loop: client vb → cap + probe point; GCC
            # estimates → this session's CBR target only
            if bool(cfg.congestion_control):
                audio_kbps = max(int(cfg.audio_bitrate) // 1000, 0)
                slot.gcc = GccController(
                    start_kbps=int(cfg.video_bitrate),
                    min_kbps=max(100 + audio_kbps, int(cfg.video_bitrate) // 10),
                    max_kbps=int(cfg.video_bitrate),
                    on_estimate=lambda kbps, k=k: self.fleet.set_session_bitrate(k, kbps),
                    session=str(k),
                )
                slot.ws.on_video_sent = slot.gcc.on_frame_sent
                inp.on_media_ack = slot.gcc.on_frame_ack
                slot.webrtc.on_video_sent = slot.gcc.on_frame_sent
                slot.webrtc.on_video_acked = slot.gcc.on_frame_ack
                slot.webrtc.on_loss = slot.gcc.on_loss_report

            # per-session recovery ladder (transport/recovery.py): FEC
            # tracks THIS session's loss; an unrecoverable gap force-IDRs
            # only this slot; the degrade rung clamps this session's
            # bitrate (fleet geometry/fps are lockstep, so a single bad
            # link must never downscale the whole fleet). Inert under
            # SELKIES_RECOVERY=0.
            slot.recovery = RecoveryController(session=str(k))
            slot.recovery.on_set_fec = slot.webrtc.set_fec_percentage
            slot.recovery.on_force_idr = (
                lambda k=k: self.fleet.force_keyframe(k))

            def on_rec_degrade(k=k, slot=slot):
                floor = max(250, int(cfg.video_bitrate) // 4)
                self.fleet.set_session_bitrate(k, floor)
                if slot.gcc is not None:
                    slot.gcc.set_target(floor)

            def on_rec_undegrade(k=k, slot=slot):
                self.fleet.set_session_bitrate(k, int(cfg.video_bitrate))
                if slot.gcc is not None:
                    slot.gcc.set_target(int(cfg.video_bitrate))

            slot.recovery.on_degrade = on_rec_degrade
            slot.recovery.on_undegrade = on_rec_undegrade
            slot.webrtc.on_nack = slot.recovery.on_nack
            slot.webrtc.on_unrecoverable = slot.recovery.on_unrecoverable
            rtc_loss = slot.webrtc.on_loss
            rec_loss = slot.recovery.on_loss_report

            def on_slot_loss(fraction: float, _gcc=rtc_loss, _rec=rec_loss):
                _gcc(fraction)
                _rec(fraction)

            slot.webrtc.on_loss = on_slot_loss

            def on_video_bitrate(kbps: int, k=k, slot=slot):
                self.fleet.set_session_bitrate(k, int(kbps))
                if slot.gcc is not None:
                    slot.gcc.set_target(int(kbps))

            inp.on_video_encoder_bit_rate = on_video_bitrate

            def on_audio_bitrate(bps: int, slot=slot):
                if slot.audio is not None:
                    slot.audio.set_bitrate(int(bps))

            inp.on_audio_encoder_bit_rate = on_audio_bitrate
            # lockstep batch: fps/resize are fleet configuration, not
            # per-session — acknowledge without applying (docs/fleet.md)
            inp.on_set_fps = lambda fps, k=k: logger.info(
                "session %d requested fps=%s; fleet tick is %s (lockstep)",
                k, fps, self.fleet.fps)
            inp.on_set_enable_resize = lambda en, res, k=k: logger.info(
                "session %d resize request ignored (fleet geometry is fixed)", k)
            inp.on_clipboard_read = slot.send_clipboard_data
            inp.on_cursor_change = slot.send_cursor_data
            # per-session labeled gauges: N clients writing one scalar
            # gauge would be last-writer-wins noise
            set_fps, set_latency = self.metrics.session_setters(k)
            inp.on_client_fps = set_fps
            inp.on_client_latency = set_latency

            def on_ping(ms: float, k=k, slot=slot):
                slot.send_latency_time(ms)
                if telemetry.enabled:
                    telemetry.gauge("selkies_congestion_rtt_ms", ms,
                                    session=str(k))

            inp.on_ping_response = on_ping
            inp.on_client_webrtc_stats = (
                lambda t, s, k=k, slot=slot: self._on_slot_stats(slot, t, s))

        def on_timer(ts: float) -> None:
            for slot in self.slots:
                if slot.connected:
                    slot.input.send_ping(ts)
                    slot.send_ping(ts)
                    slot.send_system_stats(
                        self.system_mon.cpu_percent,
                        self.system_mon.mem_total, self.system_mon.mem_used)

        self.system_mon.on_timer = on_timer

    async def _on_slot_stats(self, slot: SessionSlot, stat_type: str,
                             stats_json: str) -> None:
        """Client RTCStats upload: record + feed interval loss into this
        session's GCC when the WS fallback plane carries the media (the
        WebRTC plane reports loss via RTCP instead — counting the upload
        too would double the multiplicative back-off; solo parity:
        orchestrator._on_client_webrtc_stats)."""
        from selkies_tpu_torch.orchestrator import _loss_counters

        await self.metrics.set_webrtc_stats(stat_type, stats_json)
        if (slot.gcc is None or stat_type != "_stats_video"
                or slot.webrtc.connected):
            return
        counters = _loss_counters(stats_json)
        if counters is None:
            return
        lost, received = counters
        p_lost, p_recv = slot.last_loss_counters
        d_lost, d_recv = lost - p_lost, received - p_recv
        slot.last_loss_counters = (lost, received)
        if d_lost >= 0 and d_recv >= 0 and d_lost + d_recv > 0:
            slot.gcc.on_loss_report(d_lost / (d_lost + d_recv))

    def _broadcast_tpu_stats(self, load: float, total: float, used: float) -> None:
        self.metrics.set_tpu_utilization(load * 100)
        for slot in self.slots:
            if slot.connected:
                slot._send("gpu_stats", {
                    "load": load, "memory_total": total, "memory_used": used})

    def _slot_disconnected(self, k: int, slot: SessionSlot) -> None:
        if not slot.connected:
            return
        slot.connected = False
        self._teardown_slot(k, slot)

    def _teardown_slot(self, k: int, slot: SessionSlot) -> None:
        """Post-disconnect teardown (transport, input, SLO, re-arm) —
        split from _slot_disconnected so the drain migrate path can
        flip ``connected`` early (its double-checkpoint guard) yet run
        the teardown only after the client's redirect went out."""
        # placement pressure bookkeeping: an idle session's chips become
        # borrowable again (its row stays carved until release/recycle)
        self.fleet.placer.set_busy(k, False)
        # the departed client's SLO breach state / shed bitrate / sticky
        # WARN must not outlive it (the next admit starts clean)
        self.fleet.reset_session_slo(k)
        logger.info("session %d client disconnected", k)
        slot.input.reset_keyboard()
        loop = asyncio.get_running_loop()
        loop.create_task(slot.webrtc.stop_session())
        if slot.audio is not None:
            loop.create_task(self._apply_audio_state(slot))
        if k in self._rearm:
            self._rearm[k].set()

    # -- per-slot WebRTC negotiation (solo _signalling_loop × N) -------

    async def _slot_signalling_loop(self, k: int) -> None:
        from selkies_tpu_torch.signalling.client import (
            SignallingClient,
            SignallingErrorNoPeer,
            reconnect_backoff,
            run_reconnect_loop,
        )

        cfg, slot = self.cfg, self.slots[k]
        scheme = "wss" if bool(cfg.enable_https) else "ws"
        client = SignallingClient(
            f"{scheme}://127.0.0.1:{self.server.bound_port}/ws",
            id=server_client_id(k), peer_id=browser_peer_id(k),
            enable_https=bool(cfg.enable_https),
            enable_basic_auth=bool(cfg.enable_basic_auth),
            basic_auth_user=cfg.basic_auth_user,
            basic_auth_password=cfg.basic_auth_password,
            # decaying, jittered retries inside connect() too — N slots
            # hammering a dead server on one fixed beat is the fleet-
            # sized thundering herd
            retry_backoff=reconnect_backoff(),
        )
        slot.webrtc.on_sdp = client.send_sdp
        slot.webrtc.on_ice = client.send_ice

        async def on_error(exc: Exception) -> None:
            if isinstance(exc, SignallingErrorNoPeer):
                await asyncio.sleep(2.0)
                await client.setup_call()
            else:
                logger.warning("session %d signalling error: %s", k, exc)

        async def on_session(peer, meta, k=k, slot=slot):
            # per-client codec negotiation: the browser's HELLO meta
            # carries its preference list; the fleet resolves it against
            # the registry and this session's chip carve BEFORE the
            # offer is built, so the SDP (and thereby the payloader)
            # matches the encoder that will actually stream
            prefs = meta.get("codecs") if isinstance(meta, dict) else None
            n = self.fleet.negotiate_session(k, prefs)
            slot.webrtc.set_codec(n.codec)
            await slot.webrtc.start_session()
            if slot.recovery is not None:
                # fresh peer starts at the ladder's current level
                slot.recovery.attach()

        client.on_connect = client.setup_call
        client.on_error = on_error
        client.on_session = on_session
        client.on_sdp = slot.webrtc.set_remote_sdp
        client.on_ice = slot.webrtc.add_remote_ice

        async def rearm_watch() -> None:
            while True:
                await self._rearm[k].wait()
                self._rearm[k].clear()
                try:
                    await client.setup_call()
                except Exception as exc:
                    logger.warning(
                        "session %d signalling re-arm failed: %r "
                        "(will retry on next re-arm)", k, exc)

        rearm = asyncio.get_running_loop().create_task(rearm_watch())
        try:
            # shared reconnect loop with backoff + jitter — N slots
            # hammering a dead server on one fixed beat would be the
            # fleet-sized thundering herd (signalling/client.py)
            await run_reconnect_loop(client, f"session {k} signalling")
        finally:
            rearm.cancel()
            await client.stop()

    # ------------------------------------------------------------------

    async def run(self) -> None:
        from selkies_tpu_torch.orchestrator import (
            _first_ice_servers,
            make_rtc_monitors,
            resolve_rtc_config,
            wait_for_app_ready,
        )

        cfg = self.cfg
        await wait_for_app_ready(cfg.app_ready_file, bool(cfg.app_wait_ready))
        stun, turn, rtc_config = await resolve_rtc_config(cfg)
        self.server.set_rtc_config(rtc_config)
        ice_kw = _first_ice_servers(stun, turn)
        for slot in self.slots:
            slot.webrtc.set_ice_servers(**ice_kw)
        await self.server.start()
        self._rearm.update({k: asyncio.Event() for k in range(self.n)})
        for slot in self.slots:
            await slot.input.connect()
        # live TURN credential refresh, same chain as solo mode
        monitors = make_rtc_monitors(
            cfg, lambda stun_s, turn_s, config: self.server.set_rtc_config(config))
        spawn = asyncio.get_running_loop().create_task
        self._tasks = [spawn(self._slot_signalling_loop(k))
                       for k in range(self.n)]
        self._tasks.extend(spawn(m.start()) for m in monitors)
        self._tasks.append(spawn(self.system_mon.start()))
        if self.device_mon is not None:
            self._tasks.append(spawn(self.device_mon.start()))
        for slot in self.slots:
            self._tasks.append(spawn(slot.input.start_clipboard()))
            self._tasks.append(spawn(slot.input.start_cursor_monitor()))
        if cfg.enable_metrics_http:
            self._tasks.append(spawn(self.metrics.start_http()))
        await self.fleet.start()
        if self.cluster is not None:
            await self.cluster.start()  # membership heartbeats
        # SIGTERM/SIGINT route through the drain path (lifecycle.py)
        # instead of abrupt cancellation: the K8s preStop contract
        from selkies_tpu_torch.parallel.lifecycle import install_signal_handlers

        self._uninstall_signals = install_signal_handlers(self.drain)
        logger.info("selkies-tpu (torch) fleet ready on %s:%s (%d sessions %dx%d@%d)",
                    cfg.addr, cfg.port, self.n, self.fleet.width,
                    self.fleet.height, self.fleet.fps)
        try:
            await self.server.run()
        finally:
            await self.shutdown()

    async def shutdown(self) -> None:
        if self._uninstall_signals is not None:
            self._uninstall_signals()
            self._uninstall_signals = None
        if self.cluster is not None:
            await self.cluster.stop()
        await self.fleet.stop()
        self.system_mon.stop()
        if self.device_mon is not None:
            self.device_mon.stop()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        for slot in self.slots:
            await slot.webrtc.stop_session()
            if slot.audio is not None:
                await slot.audio.stop()
            await slot.input.stop_js_server()
            await slot.input.disconnect()
        await self.server.stop()
