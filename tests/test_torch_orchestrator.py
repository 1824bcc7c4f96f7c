"""The port's solo server (``selkies_tpu_torch/orchestrator.py``) against
JAX's, on the CPU.

Each package's ``Orchestrator`` boots in turn with test_e2e_session.py's
``make_config`` (192x128, port 0; a ``FakeBackend`` and a
``MemoryClipboard`` in the input host), and the same scripted client
drives it over ``/media``: it waits for video, a ping (answered), the
host's stats and the client latency, then sends keyboard, mouse, scroll,
clipboard and settings messages, and leaves. Compared:

- the input backend's call logs and the JSON overlay's writes: equal;
- the control messages that do not depend on the clock (codec, system
  actions), in order: equal; the clipboard messages by content (the
  clipboard monitor polls on its own clock). The timing messages (``ping``,
  ``latency_measurement``, ``system_stats``) are compared by type only,
  and ``gpu_stats`` is JAX's alone: the port builds no device monitor on
  the CPU;
- the port server's AUs: every encoder call it made is recorded, and the
  calls replayed into the port's direct row and into JAX's give the AUs
  it returned (sha256), of which the sent ones are the head;
- the Opus packets, where libopus loads: each timestamp both servers sent
  before the client's audio bitrate retune carries the same packet (the
  retune lands at a moment that depends on the clock).

The port's ``test_congestion_control_loop``, the drain path, the TURN
chain and the refusals (no card, ``tpu_sessions > 1``, the cluster plane)
follow."""

from __future__ import annotations

import asyncio
import base64
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import pytest
import torch

from selkies_tpu import orchestrator as jorch
from selkies_tpu.input_host import FakeBackend as JFakeBackend
from selkies_tpu.input_host import MemoryClipboard as JMemoryClipboard
from selkies_tpu.models import registry as jreg
from selkies_tpu.signalling import turn as jturn
from selkies_tpu.transport.websocket import parse_media_frame_seq
from selkies_tpu_torch import orchestrator as torch_orch
from selkies_tpu_torch.config import Config as TConfig
from selkies_tpu_torch.input_host import FakeBackend as TFakeBackend
from selkies_tpu_torch.input_host import MemoryClipboard as TMemoryClipboard
from selkies_tpu_torch.models import registry as treg
from selkies_tpu_torch.pipeline import app as tapp
from selkies_tpu_torch.signalling import turn as tturn
from selkies_tpu_torch.transport.websocket import (FLAG_KEYFRAME, KIND_AUDIO, KIND_VIDEO,
                                                   parse_media_frame)
from test_e2e_session import make_config
from test_torch_gpu import logged_outputs, record_encoders, replay, sps_size

REPO = Path(__file__).resolve().parents[1]
TIMING = {"ping", "latency_measurement", "system_stats", "gpu_stats"}
CLIENT_SCRIPT = [
    "kd,65", "ku,65", "kd,65505", "kd,98", "ku,98", "ku,65505",
    "m,10,20,1,0", "m,12,22,0,0", "m,12,22,8,2", "m,12,22,0,0", "m2,-3,4,0,0",
    "vb,3500", "_arg_fps,25", "ab,96000", "p,0", "_arg_resize,true,800x601",
    "cw," + base64.b64encode(b"from-browser").decode(), "cr", "_f,24", "_l,9",
]
SERVER_ENV = ("SELKIES_FAULTS", "SELKIES_POLICY", "SELKIES_POLICY_PRESET", "SELKIES_SLO",
              "SELKIES_QUALITY", "SELKIES_FRAME_BATCH", "SELKIES_PIPELINE_DEPTH",
              "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY", "SELKIES_BANDS",
              "SELKIES_TILE_GRID", "SELKIES_TELEMETRY", "SELKIES_DAMAGE_FULL_SCAN",
              "SELKIES_CODEC", "SELKIES_CLUSTER_PEERS", "SELKIES_RECOVERY", "DISPLAY")


def _clean(mp):
    for k in SERVER_ENV:
        mp.delenv(k, raising=False)


def _config(pkg, tmp_path, **over):
    """test_e2e_session.py's config; the port's Config holds the same values."""
    cfg = make_config(tmp_path, **over)
    return cfg if pkg == "jax" else TConfig(values=dict(cfg.values))


def _orchestrator(pkg, cfg):
    orch = (jorch.Orchestrator(cfg) if pkg == "jax"
            else torch_orch.Orchestrator(cfg, device="cpu"))
    orch.input.backend = (JFakeBackend if pkg == "jax" else TFakeBackend)()
    orch.input.clipboard = (JMemoryClipboard if pkg == "jax" else TMemoryClipboard)("host-text")
    return orch


async def _started(orch):
    task = asyncio.ensure_future(orch.run())
    for _ in range(200):
        if orch.server._runner is not None and orch.server._runner.addresses:
            return task
        await asyncio.sleep(0.05)
    raise TimeoutError("the server did not start")


async def _close_signalling(orch):
    """End the server's in-process signalling client. Its open ``/ws``
    socket would hold the server's stop for aiohttp's shutdown timeout
    (in both packages); the harness closes it first."""
    for t in orch._tasks:
        if t.get_coro().__name__ == "_signalling_loop":
            t.cancel()
            await asyncio.gather(t, return_exceptions=True)


async def _stopped(orch, task):
    await _close_signalling(orch)
    await orch.server.stop()
    try:
        await asyncio.wait_for(task, 20)
    except (asyncio.TimeoutError, asyncio.CancelledError):
        task.cancel()


class _Client:
    """The scripted browser on /media: keeps every video frame, audio
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
                    self.video.append((flags, ts, payload, parse_media_frame_seq(msg.data)))
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


async def _scripted_session(pkg, tmp_path):
    cfg = _config(pkg, tmp_path)
    writes = []
    real_set = cfg.set_json_setting

    def set_json_setting(name, value):
        writes.append((name, value))
        real_set(name, value)
    cfg.set_json_setting = set_json_setting
    orch = _orchestrator(pkg, cfg)
    task = await _started(orch)
    async with aiohttp.ClientSession() as http:
        ws = await http.ws_connect(f"http://127.0.0.1:{orch.server.bound_port}/media")
        c = _Client(ws)
        await c.pump(lambda c: len(c.video) >= 8 and {"latency_measurement", "system_stats"}
                     <= set(c.types()))
        mark = len(c.texts)
        # the audio bitrate retune lands after this packet, at a moment
        # that depends on the clock
        audio_mark = c.audio[-1][0] if c.audio else -1
        for msg in CLIENT_SCRIPT:
            await ws.send_str(msg)
        # the script's replies (framerate, video and audio bitrate, resize,
        # clipboard) are in once the clipboard read came back
        await c.pump(lambda c: "clipboard" in c.types()[mark:] and len(c.video) >= 16)
        await ws.close()
        for _ in range(200):
            if orch.app.pipeline is None or not orch.app.pipeline.running:
                break
            await asyncio.sleep(0.05)
    await _stopped(orch, task)
    return {"events": list(orch.input.backend.events), "writes": writes,
            "overlay": json.loads(Path(cfg.json_config).read_text()),
            "texts": c.texts, "video": c.video, "audio": c.audio, "audio_mark": audio_mark,
            "clipboard": orch.input.clipboard.read(),
            "app": (orch.app.video_bitrate_kbps, orch.app.framerate),
            "device_monitor": getattr(orch, "device_mon", "jax")}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both servers served the client script once: {"jax": ..., "torch": ...};
    the port's run also carries its recorded encoders."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            _clean(mp)
            for pkg in ("jax", "torch"):
                built = record_encoders(mp, tapp) if pkg == "torch" else None
                out[pkg] = asyncio.run(_scripted_session(pkg, tmp_path_factory.mktemp(pkg)))
                if built is not None:
                    out[pkg]["encoders"] = built
    finally:
        torch.set_num_threads(threads)
    return out


def test_input_backend_call_logs_match_jax(sessions):
    assert sessions["torch"]["events"] == sessions["jax"]["events"]
    assert ("key", 65, True) in sessions["jax"]["events"]
    assert ("scroll", True) in sessions["jax"]["events"]
    assert sessions["torch"]["clipboard"] == sessions["jax"]["clipboard"] == "from-browser"


def test_json_overlay_writes_match_jax(sessions):
    assert sessions["torch"]["writes"] == sessions["jax"]["writes"]
    assert sessions["torch"]["overlay"] == sessions["jax"]["overlay"]
    assert sessions["torch"]["app"] == sessions["jax"]["app"] == (3500, 25)


def test_control_messages_match_jax(sessions):
    def steady(texts):
        return [t for t in texts if t["type"] not in TIMING | {"clipboard"}]

    def clipboard(texts):  # the clipboard monitor polls on its own clock
        return {t["data"]["content"] for t in texts if t["type"] == "clipboard"}

    got = {k: steady(s["texts"]) for k, s in sessions.items()}
    assert got["torch"] == got["jax"]
    clip = {k: clipboard(s["texts"]) for k, s in sessions.items()}
    assert clip["torch"] == clip["jax"] and clip["jax"]
    actions = [t["data"]["action"] for t in got["jax"] if t["type"] == "system"]
    for want in ("encoder,tpuh264enc", "video_bitrate,3500", "framerate,25",
                 "audio_bitrate,96000"):
        assert want in actions


def test_timing_messages_match_jax_by_type(sessions):
    jax_types = {t["type"] for t in sessions["jax"]["texts"]} & TIMING
    port_types = {t["type"] for t in sessions["torch"]["texts"]} & TIMING
    assert port_types == jax_types - {"gpu_stats"}
    assert {"ping", "latency_measurement", "system_stats"} <= port_types
    assert sessions["torch"]["device_monitor"] is None


def test_first_frame_is_an_idr_with_the_sps(sessions):
    for s in sessions.values():
        flags, _, au, _ = s["video"][0]
        assert flags & FLAG_KEYFRAME and sps_size(au) == (192, 128)
        assert [seq for *_, seq in s["video"]] == list(range(1, len(s["video"]) + 1))


def test_sent_aus_equal_their_replay_in_both_rows(sessions):
    built = sessions["torch"]["encoders"]
    assert len(built) == 1 and built[0].kw["device"] == torch.device("cpu")
    built[0].flush()
    got = [(au, m) for au, _, m in logged_outputs(built[0])]
    sent = [(au, ts) for _, ts, au, _ in sessions["torch"]["video"]]
    assert got[:len(sent)] == sent and len(sent) >= 16

    def jax_create(name, device=None, **kw):
        return jreg.create_encoder(name, **kw)
    assert replay(built[0], treg.create_encoder, device="cpu") == got
    assert replay(built[0], jax_create) == got


def test_opus_packets_match_jax(sessions):
    from selkies_tpu_torch.audio import opus_available

    if not opus_available():
        pytest.skip("libopus not present")
    j, t = dict(sessions["jax"]["audio"]), dict(sessions["torch"]["audio"])
    # both servers coded these before the client's audio bitrate retune
    mark = min(sessions["jax"]["audio_mark"], sessions["torch"]["audio_mark"])
    common = sorted(ts for ts in set(j) & set(t) if ts <= mark)
    assert len(common) >= 5 and all(j[ts] == t[ts] for ts in common)


# -- GCC end to end (test_e2e_session.py::test_congestion_control_loop) -----------

def test_congestion_control_loop(tmp_path, monkeypatch):
    """Client acks with a growing queue drive the port's CBR target down
    through set_video_bitrate(cc=True), as JAX's test does."""
    _clean(monkeypatch)

    async def scenario():
        orch = _orchestrator("torch", _config("torch", tmp_path, congestion_control=True))
        assert orch.gcc is not None
        start_kbps = orch.app.rc.bitrate_kbps
        task = await _started(orch)
        async with aiohttp.ClientSession() as http:
            ws = await http.ws_connect(f"http://127.0.0.1:{orch.server.bound_port}/media")
            n, queue_ms = 0, 0.0
            deadline = time.monotonic() + 120
            while n < 50 and time.monotonic() < deadline:
                msg = await asyncio.wait_for(ws.receive(), 60)
                if msg.type == aiohttp.WSMsgType.BINARY:
                    if parse_media_frame(msg.data)[0] != KIND_VIDEO:
                        continue
                    queue_ms += 3.0 * (n + 1)
                    recv_ms = asyncio.get_event_loop().time() * 1000.0 + queue_ms
                    await ws.send_str(f"_ack,{parse_media_frame_seq(msg.data)},{recv_ms:.1f}")
                    n += 1
                elif msg.type != aiohttp.WSMsgType.TEXT:
                    break
            await asyncio.sleep(0.3)
            assert n >= 50, f"only {n} video frames"
            assert orch.app.rc.bitrate_kbps < start_kbps
            await ws.close()
        await _stopped(orch, task)

    asyncio.run(scenario())


# -- the drain path (SIGTERM) ------------------------------------------------------

async def _drain_session(pkg, tmp_path):
    """Drain mid-session as SIGTERM does: /healthz turns 503 while it
    drains, the client gets an IDR after the drain began, the server
    stops and run() returns."""
    orch = _orchestrator(pkg, _config(pkg, tmp_path))
    task = await _started(orch)
    base = f"http://127.0.0.1:{orch.server.bound_port}"
    health = []
    async with aiohttp.ClientSession() as http:
        health.append((await http.get(base + "/healthz")).status)
        ws = await http.ws_connect(base + "/media")
        c = _Client(ws)
        await c.pump(lambda c: len(c.video) >= 4)
        n0 = len(c.video)

        async def read_to_the_idr():
            # then leave: an open /media socket would hold the server's
            # stop for aiohttp's shutdown timeout
            try:
                await c.pump(lambda c: any(f & FLAG_KEYFRAME for f, *_ in c.video[n0:]),
                             timeout=60.0)
            except ConnectionError:
                pass
            await ws.close()
        reader = asyncio.ensure_future(read_to_the_idr())
        await _close_signalling(orch)
        drain = asyncio.ensure_future(orch.drain())
        while not drain.done():
            try:
                r = await http.get(base + "/healthz")
                health.append((r.status, json.loads(await r.text())["status"]))
            except aiohttp.ClientError:
                break
            await asyncio.sleep(0.05)
        ok = await drain
        await asyncio.wait_for(reader, 30)
    await asyncio.wait_for(task, 30)
    idr_after = any(flags & FLAG_KEYFRAME for flags, *_ in c.video[n0:])
    return {"completed": ok, "health_first": health[0],
            "draining_503": (503, "draining") in health[1:], "idr_after_drain": idr_after,
            "pipeline_stopped": orch.app.pipeline is None or not orch.app.pipeline.running}


def test_drain_path_matches_jax(tmp_path, monkeypatch):
    _clean(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = {pkg: asyncio.run(_drain_session(pkg, tmp_path / pkg)) for pkg in ("jax", "torch")}
    finally:
        torch.set_num_threads(threads)
    assert got["torch"] == got["jax"]
    assert got["torch"] == {"completed": True, "health_first": 200, "draining_503": True,
                            "idr_after_drain": True, "pipeline_stopped": True}


# -- the TURN chain and the server's options -----------------------------------------

RTC_CASES = {
    "stun_only": {},
    "stun_host": {"stun_host": "stun.example.com", "stun_port": 3479},
    "legacy": {"turn_host": "turn.example.com", "turn_port": 3478, "turn_username": "u",
               "turn_password": "p", "turn_protocol": "tcp"},
    "hmac": {"turn_host": "turn.example.com", "turn_port": 3478, "turn_shared_secret": "s",
             "turn_rest_username": "alice", "turn_tls": True},
    "rtc_json": {"rtc_config_json": "FILE"},
}


@pytest.mark.parametrize("case", sorted(RTC_CASES))
def test_rtc_config_chain_matches_jax(case, tmp_path, monkeypatch):
    import types

    for turn in (jturn, tturn):
        monkeypatch.setattr(turn, "time", types.SimpleNamespace(time=lambda: 1_760_000_000.0))
    over = dict(RTC_CASES[case])
    if over.get("rtc_config_json") == "FILE":
        path = tmp_path / "rtc_in.json"
        path.write_text(jturn.generate_rtc_config("t.example", 3478, "k", "bob"))
        over["rtc_config_json"] = str(path)
    got = {}
    for pkg, mod in (("jax", jorch), ("torch", torch_orch)):
        cfg = _config(pkg, tmp_path, **over)
        got[pkg] = (asyncio.run(mod.resolve_rtc_config(cfg)),
                    [(type(m).__name__, sorted(k for k in vars(m) if not k.startswith("_")))
                     for m in mod.make_rtc_monitors(cfg, lambda *a: None)])
    assert got["torch"] == got["jax"]


def test_signalling_server_options_match_jax(tmp_path):
    over = {"enable_basic_auth": True, "basic_auth_user": "u", "basic_auth_password": "p",
            "turn_host": "t", "turn_port": 3478, "turn_shared_secret": "s"}
    j = jorch.make_signalling_server(_config("jax", tmp_path, **over)).options
    t = torch_orch.make_signalling_server(_config("torch", tmp_path, **over)).options
    jv, tv = dict(vars(j)), dict(vars(t))
    assert tv.pop("web_root") == torch_orch.DEFAULT_WEB_ROOT
    assert jv.pop("web_root") == jorch.DEFAULT_WEB_ROOT
    assert tv == jv


# -- the absent peer plane -----------------------------------------------------------

def test_absent_peer_plane_is_inert():
    plane = torch_orch.AbsentPeerPlane()
    assert not plane.connected and not plane.data_channel_ready
    assert plane.frames_sent == plane.bytes_sent == 0
    plane.set_codec("h264", "main")
    assert (plane.codec, plane.h264_profile) == ("h264", "main")
    plane.set_codec("av1")  # the fleet slot's one-argument call
    assert (plane.codec, plane.h264_profile) == ("av1", "baseline")
    plane.set_fec_percentage(20)
    plane.set_ice_servers(**torch_orch._first_ice_servers("stun://s:1", ""))
    assert plane.fec_percentage == 20 and plane.ice_servers["stun_server"] == ("s", 1)
    for cb in ("on_connect", "on_disconnect", "on_data_message", "on_force_keyframe",
               "on_video_sent", "on_video_acked", "on_loss", "on_nack", "on_unrecoverable",
               "on_sdp", "on_ice"):
        assert getattr(plane, cb) is None
    asyncio.run(plane.start_session())
    asyncio.run(plane.stop_session())
    with pytest.raises(NotImplementedError, match="3.3"):
        plane.set_remote_sdp("answer", "v=0")
    with pytest.raises(NotImplementedError, match="3.3"):
        plane.add_remote_ice(0, "candidate")


def test_fleet_slot_still_takes_the_absent_plane():
    from selkies_tpu_torch.parallel.fleet import SessionSlot

    class Recorder:
        frames_sent = bytes_sent = 0
        data_channel_ready = False

    slot = SessionSlot(0, bitrate_kbps=2000, fps=30, codec="h264", ws=Recorder())
    assert isinstance(slot.webrtc, torch_orch.AbsentPeerPlane)
    assert slot.webrtc.codec == "h264" and slot.transport.active is slot.ws


# -- refusals: no card, the fleet, the cluster ---------------------------------------

def test_orchestrator_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None serves on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_orch.Orchestrator(_config("torch", tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(torch_orch.main(["--port", "0", "--json_config",
                                     str(tmp_path / "c.json")]))


def test_main_refuses_fleet_sessions(tmp_path):
    with pytest.raises(NotImplementedError, match="FleetOrchestrator.*3.3"):
        asyncio.run(torch_orch.main(["--tpu_sessions", "2", "--port", "0", "--json_config",
                                     str(tmp_path / "c.json")], device="cpu"))


def test_cluster_plane_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("SELKIES_CLUSTER_PEERS", "http://peer-a:8080")
    with pytest.raises(NotImplementedError, match="3.4"):
        torch_orch.Orchestrator(_config("torch", tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="3.4"):
        asyncio.run(torch_orch.main(["--port", "0", "--json_config", str(tmp_path / "c.json")],
                                    device="cpu"))


def test_entry_point_without_a_card_names_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would serve on it")
    env = {k: v for k, v in os.environ.items() if k not in SERVER_ENV}
    proc = subprocess.run(
        [sys.executable, "-m", "selkies_tpu_torch", "--addr", "127.0.0.1", "--port", "0",
         "--json_config", str(tmp_path / "c.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
