"""The port's fleet server (``FleetOrchestrator``, ``--tpu_sessions N``)
against JAX's, on the CPU.

tests/test_fleet.py's scenarios, each served by both packages' servers
(192x128, 2 sessions, port 0): JAX's on tier-1's virtual CPU devices, the
port's on ``devices=[torch.device("cpu")]`` with its batch service wrapped
in a recorder. The same scripted clients drive each session's
``/media/<k>`` (and, for the WebRTC plane, JAX's ``FakeBrowser`` on each
session's ``browser_peer_id``). Compared:

- the input backends' call logs per session and the control messages that
  do not depend on the clock (the timing ones by type only; ``gpu_stats``
  is JAX's alone: the port builds no device monitor on the CPU): equal;
- the port server's AUs: every service call it made is recorded, and the
  calls replayed into a direct port service and into JAX's
  ``MultiSessionH264Service`` give the AUs it returned (sha256), of which
  each session's client received the head;
- ticks driven by hand through each server's ``SessionFleet``, the GCC
  loss feed, a capture of the wrong geometry, failing captures, ``dryrun``,
  per-session audio and the drain without a cluster (forced IDRs, the
  flush, checkpoints whose JSON is equal apart from ``wall_time``; the
  port's flush and JAX's on a fleet that runs behind its fps).

Torch runs with one intra-op thread. ``main(["--tpu_sessions", ...])`` is
tests/test_torch_orchestrator.py's.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time

import aiohttp
import numpy as np
import pytest
import torch

import jax

from selkies_tpu.config import Config as JConfig
from selkies_tpu.parallel import fleet as jfleet
from selkies_tpu.parallel.serving import MultiSessionH264Service
from selkies_tpu.pipeline import elements as jel
from selkies_tpu_torch.config import FLAGS, Config as TConfig
from selkies_tpu_torch.parallel import fleet as tfleet
from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
from selkies_tpu_torch.pipeline import elements as tel
from selkies_tpu_torch.transport.rtp import H264Depayloader
from selkies_tpu_torch.transport.websocket import (FLAG_KEYFRAME, KIND_AUDIO, KIND_VIDEO,
                                                   parse_media_frame)
from test_e2e_webrtc import SignallingPump
from test_fleet import _decode_all
from test_torch_orchestrator import SERVER_ENV
from test_torch_webrtc_session import _units, _video
from test_webrtc_peer import FakeBrowser

W, H = 192, 128  # tests/test_fleet.py's geometry
CPU = torch.device("cpu")
TIMING = {"ping", "latency_measurement", "system_stats", "gpu_stats"}
FLEET_ENV = SERVER_ENV + ("SELKIES_OCCUPANCY", "SELKIES_CLUSTER_SELF", "SELKIES_CLUSTER_SECRET")
SCRIPT = ["kd,65", "ku,65", "m,10,20,1,0", "m,12,22,0,0", "m2,-3,4,0,0", "vb,700",
          "_arg_fps,25", "_arg_resize,true,800x601", "p,0", "_f,24", "_l,9"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in FLEET_ENV:
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_config(pkg, tmp_path, n=2, **overrides):
    """tests/test_fleet.py's make_config; the port's Config holds the same values."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    values = {fl.name: fl.default for fl in FLAGS}
    values.update(addr="127.0.0.1", port=0, framerate=30, capture_width=W, capture_height=H,
                  tpu_sessions=n, json_config=str(tmp_path / "selkies_config.json"),
                  rtc_config_json=str(tmp_path / "rtc.json"), enable_clipboard="false",
                  enable_cursors=False)
    values.update(overrides)
    return (JConfig if pkg == "jax" else TConfig)(values=values)


class RecordingService:
    """Stands in for the port fleet's batch service: forwards every
    attribute and logs each call that feeds or steers it (each tick's batch
    and the AUs with the IDR flags it returned)."""

    CALLS = ("set_qp", "set_bitrate", "force_keyframe", "encode_tick", "dispatch_tick",
             "complete_tick")

    def __init__(self, svc):
        self.__dict__.update(svc=svc, log=[])

    def __getattr__(self, attr):
        val = getattr(self.svc, attr)
        if attr not in self.CALLS:
            return val

        def call(*a, **k):
            if attr in ("encode_tick", "dispatch_tick"):
                self.log.append(("tick", np.array(a[0], copy=True)))
            out = val(*a, **k)
            if attr in ("encode_tick", "complete_tick"):
                self.log.append(("aus", [bytes(x) for x in out], list(self.svc.last_idrs)))
            elif attr != "dispatch_tick":
                self.log.append((attr, a, k))
            return out
        return call

    def __setattr__(self, attr, value):
        setattr(self.svc, attr, value)

    def ticks(self) -> list:
        """-> [(AUs, IDR flags)] of every tick in order."""
        return [tuple(e[1:]) for e in self.log if e[0] == "aus"]


def replay(rec, make) -> list:
    """Feed a fresh service the recorded calls -> [(AUs, IDR flags)]."""
    svc = make()
    out = []
    try:
        for ev in rec.log:
            if ev[0] == "tick":
                aus = svc.encode_tick(ev[1])
                out.append(([bytes(a) for a in aus], list(svc.last_idrs)))
            elif ev[0] != "aus":
                getattr(svc, ev[0])(*ev[1], **ev[2])
    finally:
        svc.close()
    return out


def check_replay(rec, n=2, fps=30):
    """The recorded ticks equal their replay in both packages (a stop may
    cut the last tick between its dispatch and its completion)."""
    got = rec.ticks()
    assert got, "the server coded nothing"
    for make in (lambda: TorchMultiSessionH264Service(n, W, H, qp=28, fps=fps, device=CPU),
                 lambda: MultiSessionH264Service(n, W, H, qp=28, fps=fps,
                                                 devices=jax.devices()[:n])):
        out = replay(rec, make)
        assert out[:len(got)] == got and len(out) - len(got) <= 1
    return got


def check_sent(ticks, k, sent):
    """The AUs session k's client received are its recorded ones, in order
    (a closed socket may miss the last)."""
    want = [aus[k] for aus, _ in ticks if aus[k]]
    assert sent and sent == want[:len(sent)], (len(sent), len(want))


def orchestrator(pkg, cfg):
    if pkg == "jax":
        return jfleet.FleetOrchestrator(cfg)
    rec = RecordingService(TorchMultiSessionH264Service(
        int(cfg.tpu_sessions), W, H, qp=28, fps=int(cfg.framerate), device=CPU))
    return tfleet.FleetOrchestrator(cfg, devices=[CPU], service=rec)


async def started(orch):
    task = asyncio.ensure_future(orch.run())
    for _ in range(400):
        if orch.server._runner is not None and orch.server._runner.addresses:
            return task
        await asyncio.sleep(0.05)
    raise TimeoutError("the fleet server did not start")


async def stopped(orch, task):
    task.cancel()
    try:
        await task
    except (asyncio.CancelledError, Exception):
        pass
    await orch.shutdown()


class Client:
    """A scripted browser on /media/<k>: keeps every video frame, audio
    packet and control message, answers pings."""

    def __init__(self, ws):
        self.ws, self.video, self.audio, self.texts = ws, [], [], []

    async def pump(self, until, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not until(self):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(self.video)} frames, texts {self.types()}")
            msg = await asyncio.wait_for(self.ws.receive(), 60)
            if msg.type == aiohttp.WSMsgType.BINARY:
                kind, flags, ts, payload = parse_media_frame(msg.data)
                if kind == KIND_VIDEO:
                    self.video.append((flags, payload))
                elif kind == KIND_AUDIO:
                    self.audio.append((ts, payload))
            elif msg.type == aiohttp.WSMsgType.TEXT:
                obj = json.loads(msg.data)
                self.texts.append(obj)
                if obj["type"] == "ping":
                    await self.ws.send_str(f"pong,{obj['data']['start_time']}")
            else:
                raise ConnectionError(f"socket ended: {msg.type}")

    def types(self):
        return [t["type"] for t in self.texts]


def steady(texts):
    return [t for t in texts if t["type"] not in TIMING]


# -- two browsers, distinct streams (test_fleet_two_browsers_distinct_streams) ------

async def _two_browsers(pkg, tmp_path):
    orch = orchestrator(pkg, make_config(pkg, tmp_path))
    task = await started(orch)
    base = f"http://127.0.0.1:{orch.server.bound_port}"
    try:
        async with aiohttp.ClientSession() as http:
            ws0 = await http.ws_connect(base + "/media/0")
            ws1 = await http.ws_connect(base + "/media/1")
            c0, c1 = Client(ws0), Client(ws1)
            # the timing messages come once the host's stats timer fired
            await asyncio.gather(*(c.pump(lambda c: len(c.video) >= 6 and TIMING - {
                "gpu_stats"} <= set(c.types())) for c in (c0, c1)))
            b0, b1 = (orch.slots[k].input.backend for k in range(2))
            base0 = len(b0.events)
            for msg in SCRIPT:
                await ws1.send_str(msg)
            await c1.pump(lambda c: orch.slots[1].rc.bitrate_kbps == 700
                          and ("key", 65, False) in b1.events and len(c.video) >= 10)
            await ws1.close()
            n0 = len(c0.video)
            await c0.pump(lambda c: len(c.video) >= n0 + 2)
            await ws0.close()
    finally:
        await stopped(orch, task)
    return {"events": [list(b0.events[:base0]), list(b0.events[base0:]), list(b1.events)],
            "kbps": [s.rc.bitrate_kbps for s in orch.slots],
            "texts": [c0.texts, c1.texts], "video": [c0.video, c1.video],
            "backends": [type(b).__name__ for b in (b0, b1)],
            "device_monitor": getattr(orch, "device_mon", "jax"),
            "service": orch.fleet.service}


@pytest.fixture(scope="module")
def two_browsers(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k in FLEET_ENV:
                mp.delenv(k, raising=False)
            return {pkg: asyncio.run(_two_browsers(pkg, tmp_path_factory.mktemp(pkg)))
                    for pkg in ("jax", "torch")}
    finally:
        torch.set_num_threads(threads)


def test_input_routes_to_the_session_like_jax(two_browsers):
    j, t = two_browsers["jax"], two_browsers["torch"]
    assert t["events"] == j["events"] and t["backends"] == j["backends"] == ["FakeBackend"] * 2
    assert ("key", 65, True) in t["events"][2] and ("key", 65, True) not in t["events"][1]
    assert len(t["events"][2]) > len(t["events"][0]), t["events"][2]
    assert t["kbps"] == j["kbps"] and t["kbps"][1] == 700 and t["kbps"][0] != 700


def test_control_messages_match_jax(two_browsers):
    j, t = two_browsers["jax"], two_browsers["torch"]
    for k in range(2):
        assert steady(t["texts"][k]) == steady(j["texts"][k])
        jtypes = {m["type"] for m in j["texts"][k]} & TIMING
        ttypes = {m["type"] for m in t["texts"][k]} & TIMING
        assert ttypes == jtypes - {"gpu_stats"}
    assert steady(t["texts"][0])[0] == {"type": "codec", "data": {"codec": "h264"}}
    assert t["device_monitor"] is None


def test_two_browsers_get_distinct_streams_equal_to_their_replay(two_browsers):
    t = two_browsers["torch"]
    ticks = check_replay(t["service"])
    decoded = []
    for k in range(2):
        video = t["video"][k]
        check_sent(ticks, k, [payload for _, payload in video])
        # a client that connects while a tick encodes gets that tick's P
        # frame first (in both packages); its forced keyframe follows
        key = first_key(video)
        dec = _decode_all(video[key:])
        assert len(dec) == len(video) - key and dec[0].shape[:2] == (H, W)
        decoded.append(dec[0].astype(np.int32))
    assert np.abs(decoded[0] - decoded[1]).mean() > 2.0
    for pkg in ("jax", "torch"):  # JAX's server streams the same way
        assert all(first_key(v) < 2 for v in two_browsers[pkg]["video"])


def first_key(video) -> int:
    return next(i for i, (flags, _) in enumerate(video) if flags & FLAG_KEYFRAME)


# -- the /media alias and the static client ---------------------------------------------

async def _alias(pkg, tmp_path):
    orch = orchestrator(pkg, make_config(pkg, tmp_path))
    task = await started(orch)
    base = f"http://127.0.0.1:{orch.server.bound_port}"
    try:
        async with aiohttp.ClientSession() as http:
            r = await http.get(base + "/app.js")
            app_js = (r.status, await r.text())
            ws = await http.ws_connect(base + "/media")
            c = Client(ws)
            await c.pump(lambda c: len(c.video) >= 2)
            routes = sorted(p for p in orch.server.ws_routes if p.startswith("/media"))
            connected = [s.connected for s in orch.slots]
            await ws.close()
    finally:
        await stopped(orch, task)
    return app_js, routes, connected, steady(c.texts), orch.fleet.service, c.video


def test_media_alias_and_static_client_match_jax(tmp_path):
    got = {pkg: asyncio.run(_alias(pkg, tmp_path / pkg)) for pkg in ("jax", "torch")}
    assert got["torch"][:4] == got["jax"][:4]
    (status, text), routes, connected, _, svc, video = got["torch"]
    assert status == 200 and "session" in text and "/media/" in text
    assert routes == ["/media", "/media/0", "/media/1"] and connected == [True, False]
    check_sent(check_replay(svc), 0, [p for _, p in video])


# -- dryrun, ticks by hand, the bare service --------------------------------------------

def _dryrun(pkg, monkeypatch):
    mod = jfleet if pkg == "jax" else tfleet
    out = []
    real = mod.SessionFleet._encode_tick

    def spy(self):
        aus, idrs, qps, modes = real(self)
        out.append(([hashlib.sha256(bytes(a)).hexdigest() for a in aus], list(idrs), list(qps)))
        return aus, idrs, qps, modes
    monkeypatch.setattr(mod.SessionFleet, "_encode_tick", spy)
    mod.dryrun(4) if pkg == "jax" else mod.dryrun(4, devices=[CPU])
    monkeypatch.undo()
    return out


def test_dryrun_matches_jax(monkeypatch):
    got = {pkg: _dryrun(pkg, monkeypatch) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"] and len(got["torch"]) == 2
    assert got["torch"][1][1] == [False, True, False, False]


def _by_hand(pkg, tmp_path, ticks=3, edit=None, **over):
    """Build the server, tick its fleet by hand as _run does -> per tick
    (AU sha256s, IDR flags, QPs), and the by-hand AUs against a bare
    service of the same package."""
    orch = orchestrator(pkg, make_config(pkg, tmp_path, **over))
    fleet = orch.fleet
    if edit is not None:
        edit(pkg, fleet)
    out = []
    try:
        for t in range(ticks):
            if t == 1:
                fleet.force_keyframe(1)
            failed = fleet._capture_batch()
            aus, idrs, qps, _ = fleet._encode_tick()
            for slot, au, idr in zip(fleet.slots, aus, idrs):
                slot.rc.update(len(au), idr=idr)
            out.append(([hashlib.sha256(bytes(a)).hexdigest() for a in aus], list(idrs),
                        list(qps), [(k, repr(e)) for k, e in failed or []]))
    finally:
        fleet.service.close()
    return out, fleet


def test_fleet_server_streams_bit_exact_vs_service(tmp_path):
    """The server's fleet ticks equal JAX's, and equal a bare service of
    the port fed the same frames and QPs (the transport adds nothing)."""
    got = {pkg: _by_hand(pkg, tmp_path / pkg) for pkg in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0]
    ref = TorchMultiSessionH264Service(2, W, H, qp=28, fps=30, device=CPU)
    sources = [tel.SyntheticSource(W, H, seed=k) for k in range(2)]
    try:
        for t, (shas, idrs, qps, _) in enumerate(got["torch"][0]):
            if t == 1:
                ref.force_keyframe(1)
            for k, qp in enumerate(qps):
                ref.set_qp(k, qp)
            aus = ref.encode_tick(np.stack([s.capture() for s in sources]))
            assert [hashlib.sha256(bytes(a)).hexdigest() for a in aus] == shas
    finally:
        ref.close()
    assert got["torch"][0][1][1] == [False, True]


def _mismatch(pkg, fleet):
    fleet.sources[1] = (jel if pkg == "jax" else tel).SyntheticSource(W // 2, H // 2, seed=9)


def test_capture_geometry_mismatch_survives_like_jax(tmp_path):
    got = {pkg: _by_hand(pkg, tmp_path / pkg, edit=_mismatch) for pkg in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0]
    empty = hashlib.sha256(b"").hexdigest()
    assert all(empty not in shas for shas, *_ in got["torch"][0])


class _Flaky:
    """A source whose third and fourth captures raise (an X server dying
    mid-session)."""

    def __init__(self, src):
        self.src, self.calls = src, 0
        self.width, self.height = src.width, src.height

    def capture(self):
        self.calls += 1
        if self.calls in (3, 4):
            raise RuntimeError("X connection lost")
        return self.src.capture()


def _flaky(pkg, fleet):
    fleet.sources[1] = _Flaky((jel if pkg == "jax" else tel).SyntheticSource(W, H, seed=5))


def test_tick_survives_capture_failures_like_jax(tmp_path):
    """By hand: the failed captures ride the previous frame with the same
    bytes in both packages; live: the port's loop keeps ticking through
    them, and its ticks replay to the same AUs in both packages."""
    got = {pkg: _by_hand(pkg, tmp_path / pkg, ticks=6, edit=_flaky) for pkg in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0]
    lost = [(1, repr(RuntimeError("X connection lost")))]
    assert [t[3] for t in got["torch"][0]] == [[], [], lost, lost, [], []]

    async def live():
        orch = orchestrator("torch", make_config("torch", tmp_path / "live", framerate=60))
        fleet = orch.fleet
        flaky = _Flaky(tel.SyntheticSource(W, H, seed=5))
        fleet.sources[1] = flaky
        orch.slots[0].connected = True
        await fleet.start()
        try:
            for _ in range(1800):
                if fleet.ticks >= 6 and flaky.calls >= 5:
                    break
                await asyncio.sleep(0.05)
        finally:
            for s in orch.slots:
                s.connected = False
            await fleet.stop()
        return fleet, flaky
    fleet, flaky = asyncio.run(live())
    assert fleet.ticks >= 6 and flaky.calls >= 5
    check_replay(fleet.service, fps=60)


def test_ws_loss_feeds_session_gcc_like_jax(tmp_path):
    async def case(pkg):
        orch = orchestrator(pkg, make_config(pkg, tmp_path / pkg, congestion_control=True))
        try:
            s0, s1 = orch.slots
            before = (s0.gcc.estimate_kbps, s1.gcc.estimate_kbps)
            stats = json.dumps([{"type": "inbound-rtp", "packetsLost": 20,
                                 "packetsReceived": 80}])
            await orch._on_slot_stats(s0, "_stats_video", stats)
            await orch._on_slot_stats(s0, "_stats_video", stats)  # no new loss
            await orch._on_slot_stats(s1, "_stats_audio", stats)  # not video
            return before, (s0.gcc.estimate_kbps, s1.gcc.estimate_kbps), s0.last_loss_counters
        finally:
            await orch.fleet.stop()
    got = {pkg: asyncio.run(case(pkg)) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    (b0, b1), (a0, a1), _ = got["torch"]
    assert a0 < b0 and a1 == b1


# -- the WebRTC plane of session k ------------------------------------------------------

async def _drive_browser(http, port, session, min_packets=12):
    browser = FakeBrowser()
    ws = await http.ws_connect(f"http://127.0.0.1:{port}/ws")
    await ws.send_str(f"HELLO {tfleet.browser_peer_id(session)}")
    pump = SignallingPump(ws, browser)
    ch = None
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        assert await pump.step(), f"session {session}: the signalling socket closed"
        if browser.dtls is not None and browser.dtls.handshake_complete and ch is None:
            ch = browser.sctp.open_channel("input")
            for pkt in browser.sctp.take_packets():
                browser.dtls.send(pkt)
            browser._flush()
        if len(_video(browser)) >= min_packets:
            break
    await ws.close()
    assert pump.offer_sdp is not None and browser.dtls.handshake_complete, session
    browser.ice.close()
    return _units(_video(browser), H264Depayloader()), pump.offer_sdp


async def _webrtc(pkg, tmp_path):
    rtc = tmp_path / "rtc_in.json"
    tmp_path.mkdir(parents=True, exist_ok=True)
    rtc.write_text(json.dumps({"iceServers": []}))
    orch = orchestrator(pkg, make_config(pkg, tmp_path, rtc_config_json=str(rtc)))
    task = await started(orch)
    try:
        async with aiohttp.ClientSession() as http:
            got = await asyncio.gather(_drive_browser(http, orch.server.bound_port, 0),
                                       _drive_browser(http, orch.server.bound_port, 1))
    finally:
        await stopped(orch, task)
    return got, orch.fleet.service, [s.webrtc.frames_sent for s in orch.slots]


def test_webrtc_plane_of_session_k_like_jax(tmp_path):
    """Two FakeBrowsers on peers 1 and 11 (sessions 0 and 1) answer their
    slot's offer, complete ICE and DTLS-SRTP and receive distinct H.264
    streams from both packages' servers; the port's units are the head of
    each session's recorded AUs, which replay equal in both packages."""
    got = {pkg: asyncio.run(_webrtc(pkg, tmp_path / pkg)) for pkg in ("jax", "torch")}
    ticks = check_replay(got["torch"][1])
    for pkg in ("jax", "torch"):
        (u0, offer0), (u1, offer1) = got[pkg][0]
        assert u0 and u1 and b"".join(u0)[:2000] != b"".join(u1)[:2000]
        for units in (u0, u1):
            frames = _decode_all([(0, b"".join(units))])
            assert frames and frames[0].shape[:2] == (H, W)
        assert "H264/90000" in offer0 and "H264/90000" in offer1
    for k in range(2):
        units = got["torch"][0][k][0]
        want = [aus[k] for aus, _ in ticks if aus[k]]
        start = want.index(units[0])  # the session's first AU after its peer came up
        assert units == want[start:start + len(units)]


# -- per-session audio ------------------------------------------------------------------

async def _audio(pkg, tmp_path):
    orch = orchestrator(pkg, make_config(pkg, tmp_path, session_audio_devices="dev0.monitor"))
    flags = ([s.audio is not None for s in orch.slots], [s.webrtc._kw["audio"]
                                                         for s in orch.slots])
    task = await started(orch)
    base = f"http://127.0.0.1:{orch.server.bound_port}"
    try:
        async with aiohttp.ClientSession() as http:
            ws0 = await http.ws_connect(base + "/media/0")
            c0 = Client(ws0)
            await c0.pump(lambda c: len(c.audio) >= 5, timeout=60)
            await ws0.close()
            ws1 = await http.ws_connect(base + "/media/1")
            c1 = Client(ws1)
            await c1.pump(lambda c: len(c.video) >= 6, timeout=60)
            await ws1.close()
    finally:
        await stopped(orch, task)
    return flags, c0.audio, len(c1.audio)


def test_per_session_audio_like_jax(tmp_path):
    from selkies_tpu.audio import opus_available

    if not opus_available():
        pytest.skip("libopus absent")
    got = {pkg: asyncio.run(_audio(pkg, tmp_path / pkg)) for pkg in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0] == ([True, False], [True, False])
    assert got["torch"][2] == got["jax"][2] == 0
    j, t = dict(got["jax"][1]), dict(got["torch"][1])
    common = sorted(set(j) & set(t))
    assert len(t) >= 5 and common and all(j[ts] == t[ts] for ts in common)


# -- the drain without a cluster --------------------------------------------------------

async def _drain_by_hand(pkg, tmp_path):
    """Two admitted sessions ticked by hand, then the drain: the forced IDR
    of every connected session, the flush (no loop runs), the checkpoint
    hand-off, the fleet and server stopped."""
    orch = orchestrator(pkg, make_config(pkg, tmp_path))
    fleet = orch.fleet
    for k, slot in enumerate(orch.slots):
        assert fleet.admit_client(k).accepted
        slot.connected = True
    for _ in range(3):
        fleet._capture_batch()
        aus, idrs, _, _ = fleet._encode_tick()
        for slot, au, idr in zip(fleet.slots, aus, idrs):
            slot.rc.update(len(au), idr=idr)
    svc = getattr(fleet.service, "svc", fleet.service)
    ok = await orch.drain()
    forced = [bool(s.force_idr) for s in svc.sessions]
    cks = []
    for ck in orch.drain_checkpoints:
        d = json.loads(ck.to_json())
        d.pop("wall_time")
        cks.append(d)
    return ok, forced, cks, orch.drainer.state


def test_drain_hands_off_checkpoints_like_jax(tmp_path):
    got = {pkg: asyncio.run(_drain_by_hand(pkg, tmp_path / pkg)) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    ok, forced, cks, state = got["torch"]
    assert ok and forced == [True, True] and [c["session"] for c in cks] == [0, 1]
    assert state == "drained" and all(c["frames_since_idr"] > 0 for c in cks)


async def _flush_behind_fps(tmp_path):
    """The port's fleet loop with every slot connected and each encode
    slowed to two frame periods, so the loop starts the next tick in the
    iteration that ends the last and never shows ``_tick_in_flight``
    clear. The drain's forced IDR, then the port's flush; then the forced
    IDR again and JAX's flush (on the same server) under a deadline."""
    orch = orchestrator("torch", make_config("torch", tmp_path))
    fleet = orch.fleet
    period = 1.0 / fleet.fps
    sent = []
    for k, slot in enumerate(orch.slots):
        assert fleet.admit_client(k).accepted
        slot.connected = True

        async def send_video(ef, k=k):
            sent.append((k, ef.idr))
            return True
        slot.transport.send_video = send_video
    encode = fleet._encode_tick

    def slow_encode():
        time.sleep(2 * period)
        return encode()
    fleet._encode_tick = slow_encode
    seen_clear = []

    async def watch():
        while True:
            seen_clear.append(not fleet._tick_in_flight)
            await asyncio.sleep(0.002)
    await fleet.start()
    watcher = None
    try:
        while fleet.ticks < 3:
            await asyncio.sleep(0.01)
        watcher = asyncio.ensure_future(watch())
        out = {}
        for name, flush, deadline in (("torch", orch._drain_flush, 30.0),
                                      ("jax", lambda: jfleet.FleetOrchestrator._drain_flush(orch),
                                       20 * period)):
            n0, t0 = len(sent), fleet.ticks
            orch._drain_force_idr()
            try:
                await asyncio.wait_for(flush(), deadline)
                returned = True
            except asyncio.TimeoutError:
                returned = False
            # the IDR each slot had received when the flush returned (or ran out)
            out[name] = {"returned": returned, "ticks": fleet.ticks - t0,
                         "idr_sent": sorted({k for k, idr in sent[n0:] if idr})}
    finally:
        if watcher is not None:
            watcher.cancel()
        await fleet.stop()
        await orch.shutdown()
    return out, seen_clear


def test_drain_flush_behind_fps_counts_ticks(tmp_path):
    """A fleet behind its fps: the port's flush returns within the tick
    that carries the IDR and the one after it, the IDR sent on every
    slot; JAX's flush on the same fleet polls for an idle instant that
    never comes and runs out its deadline (ROADMAP queue 3)."""
    out, seen_clear = asyncio.run(_flush_behind_fps(tmp_path))
    assert not any(seen_clear), "the loop went idle between ticks"
    assert out["torch"]["returned"] and 1 <= out["torch"]["ticks"] <= 3, out
    assert out["torch"]["idr_sent"] == [0, 1], out
    assert not out["jax"]["returned"] and out["jax"]["ticks"] >= 3, out
    assert out["jax"]["idr_sent"] == [0, 1], out


async def _drain_live(pkg, tmp_path):
    orch = orchestrator(pkg, make_config(pkg, tmp_path))
    task = await started(orch)
    base = f"http://127.0.0.1:{orch.server.bound_port}"
    health = []
    async with aiohttp.ClientSession() as http:
        health.append((await http.get(base + "/healthz")).status)
        clients = [Client(await http.ws_connect(f"{base}/media/{k}")) for k in range(2)]
        await asyncio.gather(*(c.pump(lambda c: len(c.video) >= 4) for c in clients))
        marks = [len(c.video) for c in clients]

        async def read_to_the_idr(c, n0):
            try:
                await c.pump(lambda c: any(f & FLAG_KEYFRAME for f, _ in c.video[n0:]),
                             timeout=60.0)
            except ConnectionError:
                pass
            await c.ws.close()
        readers = [asyncio.ensure_future(read_to_the_idr(c, n)) for c, n in zip(clients, marks)]
        for t in orch._tasks:  # the slots' in-process signalling clients
            if t.get_coro().__name__ == "_slot_signalling_loop":
                t.cancel()
        drain = asyncio.ensure_future(orch.drain())
        while not drain.done():
            try:
                r = await http.get(base + "/healthz")
                health.append((r.status, json.loads(await r.text())["status"]))
            except aiohttp.ClientError:
                break
            await asyncio.sleep(0.05)
        ok = await drain
        await asyncio.wait_for(asyncio.gather(*readers), 30)
    await asyncio.wait_for(task, 60)
    return {"completed": ok, "health_first": health[0],
            "draining_503": (503, "draining") in health[1:],
            "idr_after_drain": [any(f & FLAG_KEYFRAME for f, _ in c.video[n:])
                                for c, n in zip(clients, marks)],
            "checkpoints": [ck.session for ck in orch.drain_checkpoints]}, orch, clients


def test_live_drain_matches_jax(tmp_path):
    got = {pkg: asyncio.run(_drain_live(pkg, tmp_path / pkg)) for pkg in ("jax", "torch")}
    # each client leaves once its IDR arrived, so the hand-off finds no
    # connected session in either package (the by-hand test holds it)
    assert got["torch"][0] == got["jax"][0] == {
        "completed": True, "health_first": 200, "draining_503": True,
        "idr_after_drain": [True, True], "checkpoints": []}
    _, orch, clients = got["torch"]
    ticks = check_replay(orch.fleet.service)
    for k, c in enumerate(clients):
        check_sent(ticks, k, [p for _, p in c.video])
