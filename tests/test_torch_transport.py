"""The port's transport, signalling-free orchestrator pieces and config
against JAX's, on the CPU.

``selkies_tpu_torch/transport/`` (``congestion.py``, ``recovery.py``,
``websocket.py``), ``orchestrator.py`` (``TransportMux``, ``_loss_counters``)
and ``config.py`` against their ``selkies_tpu`` counterparts:

- ``GccController`` and ``RecoveryController`` stepped over the same
  seeded sequences of sends, acks, loss reports, NACKs and unrecoverable
  gaps give equal estimates, FEC percentages, rungs and callbacks at every
  step;
- the media framing is equal, and a ``WebSocketTransport`` served by an
  aiohttp server on localhost delivers the same framed bytes and text
  messages to a client in both packages;
- ``TransportMux`` routes to the same plane and handles ``send:<k>`` drop,
  delay and raise faults as JAX's does; ``_loss_counters`` is equal;
- ``parse_config`` gives equal values over argv, env and JSON-overlay cases.

Everything here is host code: every comparison is exact.
"""

from __future__ import annotations

import asyncio
import json

import aiohttp
import numpy as np
import pytest
from aiohttp import web

from selkies_tpu import config as jcfg
from selkies_tpu import orchestrator as jorch
from selkies_tpu.pipeline.elements import EncodedFrame as JFrame
from selkies_tpu.resilience import configure_faults as jconfigure
from selkies_tpu.resilience import reset_faults as jreset
from selkies_tpu.transport import congestion as jcc
from selkies_tpu.transport import recovery as jrec
from selkies_tpu.transport import websocket as jws
from selkies_tpu_torch import config as tcfg
from selkies_tpu_torch import orchestrator as torch_orch
from selkies_tpu_torch.pipeline.elements import EncodedFrame as TFrame
from selkies_tpu_torch.resilience import InjectedFault
from selkies_tpu_torch.resilience import configure_faults as tconfigure
from selkies_tpu_torch.resilience import reset_faults as treset
from selkies_tpu_torch.transport import congestion as tcc
from selkies_tpu_torch.transport import recovery as trec
from selkies_tpu_torch.transport import websocket as tws

JAX = dict(cc=jcc, rec=jrec, ws=jws, orch=jorch, cfg=jcfg, frame=JFrame,
           configure=jconfigure, reset=jreset)
PORT = dict(cc=tcc, rec=trec, ws=tws, orch=torch_orch, cfg=tcfg, frame=TFrame,
            configure=tconfigure, reset=treset)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SELKIES_FAULTS", "SELKIES_RECOVERY", "SELKIES_FEC_MAX_PCT"):
        monkeypatch.delenv(k, raising=False)
    jreset()
    treset()
    yield
    jreset()
    treset()


# -- congestion control ------------------------------------------------------------

def _gcc_trace(seed: int) -> list:
    """A seeded feedback timeline: frames sent every ~16 ms, acked with a
    one-way delay that is flat, then grows (a queue building), then drains;
    some acks lost, some loss reports."""
    rng = np.random.default_rng(seed)
    ev, t = [], 0.0
    for seq in range(1, 400):
        t += 16.0 + float(rng.random())
        size = int(rng.integers(2000, 40000))
        ev.append(("sent", seq & 0xFFFF, t, size))
        delay = 20.0 + (0.0 if seq < 120 else min(300.0, 2.5 * (seq - 120)) if seq < 260
                        else max(0.0, 350.0 - 3.0 * (seq - 260)))
        if rng.random() > 0.05:
            ev.append(("ack", seq & 0xFFFF, t + delay + float(rng.random()) * 3.0))
        if seq % 50 == 0:
            ev.append(("loss", float(rng.choice([0.0, 0.01, 0.05, 0.2, 0.4]))))
    return ev


def _step_gcc(pkg, trace) -> list:
    seen = []
    gcc = pkg["cc"].GccController(start_kbps=3000, min_kbps=150, max_kbps=12000,
                                  on_estimate=seen.append, session="2")
    out = []
    for e in trace:
        if e[0] == "sent":
            gcc.on_frame_sent(e[1], e[2], e[3])
        elif e[0] == "ack":
            gcc.on_frame_ack(e[1], e[2])
        else:
            gcc.on_loss_report(e[1])
        out.append((gcc.estimate_kbps, gcc._trend.state, gcc.last_loss, len(seen)))
    gcc.set_target(5000)
    out.append((gcc.estimate_kbps, gcc.max_kbps, gcc.min_kbps))
    return out + [seen]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gcc_matches_jax(seed):
    trace = _gcc_trace(seed)
    got, want = _step_gcc(PORT, trace), _step_gcc(JAX, trace)
    assert got == want
    estimates = [s[0] for s in got[:-2]]
    assert min(estimates) < 3000 and got[-1]  # the queue cut the estimate


def test_trendline_matches_jax():
    rng = np.random.default_rng(7)
    jt, tt = jcc.TrendlineEstimator(), tcc.TrendlineEstimator()
    t = 0.0
    for i in range(300):
        t += 16.0
        recv = t + 20.0 + (3.0 * i if 100 < i < 180 else 0.0) + float(rng.random())
        assert tt.add(t, recv) == jt.add(t, recv)


# -- the recovery ladder ---------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _step_recovery(pkg, seed: int, enabled) -> list:
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    rc = pkg["rec"].RecoveryController(session="1", enabled=enabled, clock=clock)
    calls = []
    rc.on_set_fec = lambda pct: calls.append(("fec", pct))
    rc.on_force_idr = lambda: calls.append(("idr",))
    rc.on_degrade = lambda: calls.append(("degrade",))
    rc.on_undegrade = lambda: calls.append(("undegrade",))
    rc.attach()
    out = []
    for i in range(240):
        clock.t += 0.25
        phase = (i // 40) % 3
        loss = [0.0, 0.04, 0.25][phase] * float(rng.random())
        rc.on_loss_report(loss)
        if phase and rng.random() < 0.3:
            rc.on_nack(int(rng.integers(1, 8)))
        if phase == 2 and rng.random() < 0.2:
            rc.on_unrecoverable(int(rng.integers(0, 65536)))
        out.append((rc.fec_pct, rc.rung, rc.smoothed_loss, len(calls)))
    return [out, calls, rc.stats()]


@pytest.mark.parametrize("enabled", [True, False, None], ids=["on", "off", "env"])
@pytest.mark.parametrize("seed", [4, 5])
def test_recovery_matches_jax(seed, enabled):
    got, want = _step_recovery(PORT, seed, enabled), _step_recovery(JAX, seed, enabled)
    assert got == want
    if enabled is not False:
        assert {c[0] for c in got[1]} >= {"fec", "idr"}
    else:
        assert got[1] == []


def test_recovery_switches_match_jax(monkeypatch):
    for env in ("", "0", "1"):
        for pct in ("", "7", "250", "x"):
            monkeypatch.setenv("SELKIES_RECOVERY", env)
            monkeypatch.setenv("SELKIES_FEC_MAX_PCT", pct)
            assert (trec.recovery_enabled(), trec.max_fec_pct()) == \
                (jrec.recovery_enabled(), jrec.max_fec_pct())


# -- the media framing and the WebSocket plane -------------------------------------------

def test_media_framing_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(50):
        kind, flags = int(rng.integers(1, 3)), int(rng.integers(0, 2))
        ts, seq = int(rng.integers(0, 2**40)), int(rng.integers(0, 2**20))
        payload = rng.integers(0, 255, int(rng.integers(0, 64)), np.uint8).tobytes()
        got = tws.pack_media_frame(kind, flags, ts, payload, seq)
        assert got == jws.pack_media_frame(kind, flags, ts, payload, seq)
        assert tws.parse_media_frame(got) == jws.parse_media_frame(got)
        assert tws.parse_media_frame_seq(got) == jws.parse_media_frame_seq(got)
    assert (tws.HEADER.format, tws.KIND_VIDEO, tws.KIND_AUDIO, tws.FLAG_KEYFRAME) == \
        (jws.HEADER.format, jws.KIND_VIDEO, jws.KIND_AUDIO, jws.FLAG_KEYFRAME)


def _frame(pkg, au: bytes, ts: int, idr: bool = False):
    return pkg["frame"](au=au, timestamp_90k=ts, wall_time=0.0, idr=idr, qp=30,
                        device_ms=0.0, pack_ms=0.0)


class _Audio:
    def __init__(self, ts, packet):
        self.timestamp_48k, self.packet = ts, packet


async def _ws_session(pkg) -> dict:
    """Serve the package's WebSocketTransport at /media on localhost; a
    client connects, sends two text messages, receives 5 video frames, 1
    audio frame and 2 data-channel messages, then closes."""
    tr = pkg["ws"].WebSocketTransport()
    tr.session = "3"
    events, texts, sent = [], [], []
    tr.on_connect = lambda: events.append("connect")
    tr.on_disconnect = lambda: events.append("disconnect")
    tr.on_data_message = texts.append
    tr.on_video_sent = lambda seq, ms, size: sent.append((seq, size))
    app = web.Application()
    app.router.add_get("/media", tr.handle_connection)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    got, oks = [], []
    try:
        async with aiohttp.ClientSession() as http:
            ws = await http.ws_connect(f"http://127.0.0.1:{port}/media")
            await ws.send_str("kd,65")
            await ws.send_str("_ack,1,12.5")
            for _ in range(200):
                if tr.data_channel_ready and len(texts) == 2:
                    break
                await asyncio.sleep(0.01)
            for i in range(5):
                ef = _frame(pkg, b"\x00\x00\x00\x01" + bytes([i]) * (10 + i), 1500 * i,
                            idr=i == 0)
                oks.append(await tr.send_video(ef))
            await tr.send_audio(_Audio(960, b"opus"))
            tr.send_data_channel(json.dumps({"type": "ping", "data": 1}))
            tr.send_data_channel("plain")
            while len(got) < 8:
                msg = await asyncio.wait_for(ws.receive(), 10)
                got.append((msg.type.name, msg.data))
            await ws.close()
            for _ in range(200):
                if "disconnect" in events:
                    break
                await asyncio.sleep(0.01)
        closed = await tr.send_video(_frame(pkg, b"x", 0))
    finally:
        await runner.cleanup()
    return {"got": got, "oks": oks, "closed": closed, "events": events, "texts": texts,
            "sent": sent, "counts": (tr.frames_sent, tr.bytes_sent),
            "ready": tr.data_channel_ready}


def test_websocket_transport_delivers_the_same_bytes_as_jax():
    got = asyncio.run(_ws_session(PORT))
    want = asyncio.run(_ws_session(JAX))
    assert got == want
    assert got["oks"] == [True] * 5 and got["closed"] is False
    assert got["events"] == ["connect", "disconnect"] and not got["ready"]
    kinds = [tws.parse_media_frame(d)[0] for t, d in got["got"] if t == "BINARY"]
    assert kinds == [tws.KIND_VIDEO] * 5 + [tws.KIND_AUDIO]


# -- the mux and the loss counters ----------------------------------------------------------

class Plane:
    """A byte plane double: records what it is sent."""

    def __init__(self, name, connected=False, ready=False):
        self.name, self.connected, self.data_channel_ready = name, connected, ready
        self.video, self.audio, self.messages = [], [], []
        self.frames_sent, self.bytes_sent = 3, 30
        self.sdp = []

    def send_data_channel(self, m):
        self.messages.append(m)

    async def send_video(self, ef):
        self.video.append(ef.au)
        return None if self.name == "rtc" else True

    async def send_audio(self, ea):
        self.audio.append(ea.packet)

    def set_remote_sdp(self, t, s):
        self.sdp.append((t, s))

    def add_remote_ice(self, i, c):
        self.sdp.append((i, c))


async def _mux_run(pkg, spec: str) -> list:
    pkg["configure"](spec)
    ws, rtc = Plane("ws", ready=True), Plane("rtc")
    mux = pkg["orch"].TransportMux(ws, rtc, fault_site="send:1")
    out = []
    try:
        for i in range(8):
            if i == 4:
                rtc.connected = True
            if i == 6:
                rtc.data_channel_ready = True
            ef = _frame(pkg, bytes([i]), i)
            try:
                ok = await mux.send_video(ef)
            except Exception as exc:  # noqa: BLE001 - the injected raise is compared
                ok = type(exc).__name__
            mux.send_data_channel(f"m{i}")
            await mux.send_audio(_Audio(i, bytes([i])))
            out.append((ok, mux.active.name, mux.data_channel_ready))
        mux.set_remote_sdp("answer", "v=0")
        mux.add_remote_ice(0, "candidate:1")
        return [out, ws.video, rtc.video, ws.messages, rtc.messages, ws.audio, rtc.audio,
                rtc.sdp, mux.frames_sent, mux.bytes_sent]
    finally:
        pkg["reset"]()


@pytest.mark.parametrize("spec", ["", "send:1@2,5:drop", "send:1@3:delay:5;send:1@6:raise",
                                  "send:0@1-8:drop"])
def test_transport_mux_matches_jax(spec):
    got = asyncio.run(_mux_run(PORT, spec))
    want = asyncio.run(_mux_run(JAX, spec))
    got[0] = [(o if isinstance(o, bool) else o.replace(InjectedFault.__name__, "Injected"), a, r)
              for o, a, r in got[0]]
    want[0] = [(o if isinstance(o, bool) else o.replace("InjectedFault", "Injected"), a, r)
               for o, a, r in want[0]]
    assert got == want
    if spec == "send:1@2,5:drop":
        assert [o for o, _, _ in got[0]] == [True, False, True, True, False, True, True, True]


LOSS_CASES = [
    "", "not json", "null", "3", json.dumps({"type": "inbound-rtp", "packetsLost": 4,
                                             "packetsReceived": 96}),
    json.dumps([{"type": "outbound-rtp"}, {"type": "inbound-rtp", "packetsLost": -2,
                                           "packetsReceived": "50"}]),
    json.dumps([{"type": "inbound-rtp", "packetsLost": None, "packetsReceived": 5},
                {"type": "inbound-rtp", "packetsLost": "x", "packetsReceived": 5},
                {"type": "inbound-rtp", "packetsLost": 1, "packetsReceived": 9}]),
    json.dumps([1, "a", {"type": "inbound-rtp"}]), json.dumps({"a": 1}), json.dumps([]),
]


def test_loss_counters_match_jax():
    for case in LOSS_CASES:
        assert torch_orch._loss_counters(case) == jorch._loss_counters(case), case
    assert torch_orch._loss_counters(LOSS_CASES[4]) == (4.0, 96.0)


# -- the config ------------------------------------------------------------------------------

ARGVS = [[], ["--port", "9000", "--framerate", "30", "--enable_resize", "true"],
         ["--tpu_sessions", "8", "--video_bitrate", "8000", "--transport", "websocket",
          "--congestion_control", "1", "--keyframe_distance", "2.5"]]
ENVS = [{}, {"SELKIES_FRAMERATE": "24", "SELKIES_DEBUG": "yes", "SELKIES_ENCODER": "x264enc"},
        {"SELKIES_VIDEO_PACKETLOSS_PERCENT": "5.5", "SELKIES_ENABLE_CURSORS": "off"}]


@pytest.mark.parametrize("env", range(len(ENVS)))
@pytest.mark.parametrize("argv", range(len(ARGVS)))
def test_parse_config_matches_jax(monkeypatch, tmp_path, argv, env):
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    path = tmp_path / "cfg.json"
    args = ARGVS[argv] + ["--json_config", str(path)]
    assert tcfg.parse_config(args).values == jcfg.parse_config(args).values
    # the JSON overlay: mutable settings persist, others are refused
    path.write_text(json.dumps({"framerate": "48", "video_bitrate": 1234, "port": 1,
                                "enable_resize": True}))
    got, want = tcfg.parse_config(args), jcfg.parse_config(args)
    assert got.values == want.values and got.framerate == 48 and got.port != 1
    got.set_json_setting("audio_bitrate", 96000)
    with pytest.raises(ValueError):
        got.set_json_setting("port", 1)
    assert json.loads(path.read_text())["audio_bitrate"] == 96000


def test_flag_table_matches_jax():
    assert [(f.name, f.default, f.help, f.env) for f in tcfg.FLAGS] == \
        [(f.name, f.default, f.help, f.env) for f in jcfg.FLAGS]
    assert tcfg.JSON_MUTABLE == jcfg.JSON_MUTABLE
    assert tcfg.build_parser().format_help() == jcfg.build_parser().format_help()
