"""The port's solo serving app against JAX's, on the CPU.

``selkies_tpu_torch/pipeline/`` (``elements.py``: the sources, traces and
``VideoPipeline``; ``app.py``: ``TorchWebRTCApp``) against
``selkies_tpu/pipeline/`` (``TPUWebRTCApp``) at 320x192 and 328x200:

- the sources and traces give equal arrays and damage rects;
- the flat row (``SELKIES_FRAME_BATCH=1``, ``SELKIES_PIPELINE_DEPTH=0``:
  each submit hands back its own AU) served live by both apps gives equal
  AUs and QPs;
- the registry row (groups of 4, depth 2) hands back whatever completed,
  so what the controller has seen depends on the clock: the port's app is
  held by replay instead. Every encoder it builds is recorded
  (``RecordingEncoder``, tests/test_torch_gpu.py); a directly built row,
  the port's and JAX's, fed the logged calls gives the same AUs;
- the recovery ladder under ``SELKIES_FAULTS`` rules at the ``capture`` and
  ``encoder`` sites (warn, force-IDR, restart, degrade levels 1-3, the
  reversal) climbs through the same rungs and geometries in both apps,
  with equal AUs, and each of the port's encoders equals its replay;
- a failed rebuild keeps the encoder; the data channel's messages are
  equal JSON text; a run with the policy engine and the SLO plane on;
  ``device=None`` means the card.

The supervisor's clock is frozen in the ladder runs, so its restart
backoff (wall-clock seconds) cannot make the two runs differ.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging

import numpy as np
import pytest
import torch

from selkies_tpu.models import frameprep as jfp
from selkies_tpu.models import registry as jreg
from selkies_tpu.models import x264enc as jx264
from selkies_tpu.pipeline import app as japp
from selkies_tpu.pipeline import elements as jel
from selkies_tpu.resilience import faultinject as jfi
from selkies_tpu_torch.models import frameprep as tfp
from selkies_tpu_torch.models import registry as treg
from selkies_tpu_torch.models import x264enc as tx264
from selkies_tpu_torch.pipeline import app as tapp
from selkies_tpu_torch.pipeline import elements as tel
from selkies_tpu_torch.resilience import faultinject as tfi
from test_torch_gpu import (FakeTransport, closed, logged_outputs, record_encoders, replay,
                            serve_app, sps_size)

GEOMS = [(320, 192), (328, 200)]
JAX = dict(app=japp, el=jel, fi=jfi, reg=jreg, x264=jx264, kw={})
PORT = dict(app=tapp, el=tel, fi=tfi, reg=treg, x264=tx264, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every switch the app and its row read cleared, each package's
    injector unset, one torch intra-op thread."""
    for k in ("SELKIES_FAULTS", "SELKIES_POLICY", "SELKIES_POLICY_PRESET", "SELKIES_SLO",
              "SELKIES_QUALITY", "SELKIES_FRAME_BATCH", "SELKIES_PIPELINE_DEPTH",
              "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY", "SELKIES_BANDS",
              "SELKIES_TILE_GRID", "SELKIES_TELEMETRY", "SELKIES_DAMAGE_FULL_SCAN"):
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for p in (JAX, PORT):
        p["fi"].reset_faults()
    yield
    for p in (JAX, PORT):
        p["fi"].reset_faults()
    torch.set_num_threads(threads)


@pytest.fixture
def flat(monkeypatch):
    """The registry row ungrouped and unpipelined: each submit hands back
    its own AU, so a live run does not depend on the clock."""
    monkeypatch.setenv("SELKIES_FRAME_BATCH", "1")
    monkeypatch.setenv("SELKIES_PIPELINE_DEPTH", "0")


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


def _make_app(pkg, w, h, transport=None, **kw):
    cls = pkg["app"].TorchWebRTCApp if pkg is PORT else pkg["app"].TPUWebRTCApp
    return cls(source=pkg["el"].SyntheticSource(w, h, seed=4), transport=transport or FakeTransport(),
               framerate=kw.pop("framerate", 60), video_bitrate_kbps=kw.pop("kbps", 800),
               **pkg["kw"], **kw)


def _frames(app) -> list[tuple]:
    return [(_sha(f.au), f.qp, f.idr, f.upload_kind, f.skipped_mbs, f.bands)
            for f in app.transport.frames]


# -- sources and traces -------------------------------------------------------

@pytest.mark.parametrize("w,h", GEOMS)
def test_sources_match_jax(w, h):
    js, ts = jel.SyntheticSource(w, h, seed=9), tel.SyntheticSource(w, h, seed=9)
    jd, td = jel.DownscaleSource(jel.SyntheticSource(w, h, seed=3)), \
        tel.DownscaleSource(tel.SyntheticSource(w, h, seed=3))
    assert (td.width, td.height) == (jd.width, jd.height)
    for _ in range(40):
        np.testing.assert_array_equal(ts.capture(), js.capture())
        assert ts.last_damage == js.last_damage
        np.testing.assert_array_equal(td.capture(), jd.capture())
        assert td.inner.last_damage == jd.inner.last_damage
    assert tfp.tile_width_for(w) == jfp.tile_width_for(w)


@pytest.mark.parametrize("w,h", GEOMS)
def test_traces_match_jax(w, h):
    for kw in ({}, {"band0": 1, "bands": 4, "seed": 3}):
        for a, b in zip(tel.scroll_trace(w, h, 12, **kw), jel.scroll_trace(w, h, 12, **kw)):
            np.testing.assert_array_equal(a, b)
    for kw in ({}, {"tile_w": 16, "seed": 2}):
        for a, b in zip(tel.window_move_trace(w, h, 20, **kw),
                        jel.window_move_trace(w, h, 20, **kw)):
            np.testing.assert_array_equal(a, b)
    tw = tfp.tile_width_for(w)
    assert [tel.window_move_x(i, w, tw) for i in range(30)] == \
        [jel.window_move_x(i, w, tw) for i in range(30)]
    for mod in (tel, jel):
        with pytest.raises(ValueError):
            mod.scroll_trace(w, 64, 3)
        with pytest.raises(ValueError):
            mod.window_move_trace(64, h, 3, tile_w=32)


def test_encoded_frame_fields_match_jax():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(tel.EncodedFrame)] == \
        [(f.name, f.default) for f in dataclasses.fields(jel.EncodedFrame)]


# -- the flat row live, against JAX's app --------------------------------------

@pytest.mark.parametrize("w,h", GEOMS)
def test_flat_app_live_matches_jax(flat, w, h):
    """Both apps served live until 14 frames went out: equal AUs, QPs,
    keyframes and upload kinds, frame for frame."""
    runs = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        app = _make_app(pkg, w, h)
        serve_app(app, lambda a: len(a.transport.frames) >= 14)
        runs[name] = _frames(app)[:14]
        assert app.pipeline is None
    assert runs["port"] == runs["jax"]
    qps = [r[1] for r in runs["port"]]
    assert runs["port"][0][2] and len(set(qps)) > 1  # an IDR first; the controller moved


def test_rate_controller_steps_like_jax(flat):
    """A GCC drop to 100 kbps (cc=True) delivered with the 4th frame: the
    QP sequence equals JAX's, climbs after the drop, and the configured
    bitrate persists."""
    runs = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        class Transport(FakeTransport):
            async def send_video(self, frame):
                self.frames.append(frame)
                if len(self.frames) == 4:
                    self.app.set_video_bitrate(100, cc=True)
        t = Transport()
        app = _make_app(pkg, 320, 192, transport=t, kbps=5000, framerate=30)
        t.app = app
        serve_app(app, lambda a: len(a.transport.frames) >= 12)
        runs[name] = ([f.qp for f in t.frames][:12], app.video_bitrate_kbps, app.rc.bitrate_kbps)
    assert runs["port"] == runs["jax"]
    qps, persisted, target = runs["port"]
    assert qps[-1] > qps[4] and persisted == 5000 and target == 100


# -- the registry row by replay ------------------------------------------------

@pytest.mark.parametrize("w,h", GEOMS)
def test_registry_row_app_by_replay(monkeypatch, w, h):
    """The port's app on the registry row, live: what it sent is the head
    of what its encoder returned (flushed after the stop), and a direct
    port row and a direct JAX row fed the logged calls return the same
    AUs with the same timestamps."""
    built = record_encoders(monkeypatch, tapp)
    app = _make_app(PORT, w, h)
    serve_app(app, lambda a: len(a.transport.frames) >= 20)
    assert len(built) == 1 and built[0].kw["device"] == torch.device("cpu")
    built[0].flush()
    got = [(au, m) for au, _, m in logged_outputs(built[0])]
    sent = [(f.au, f.timestamp_90k) for f in app.transport.frames]
    assert got[:len(sent)] == sent
    assert [m for _, m in got] == [a[1][2] for a in built[0].log if a[0] == "submit"]
    assert sps_size(got[0][0]) == (w, h) and got[0][0].startswith(b"\x00\x00\x00\x01\x67")
    assert replay(built[0], treg.create_encoder, device="cpu") == got

    def jax_create(name, device=None, **kw):
        return jreg.create_encoder(name, **kw)
    assert replay(built[0], jax_create) == got


# -- the recovery ladder --------------------------------------------------------

def _ladder_app(pkg, w, h, events):
    """An app whose supervisor's clock is frozen and whose recovery walks
    back after 4 healthy ticks; every tick_ok / failure appends (event,
    rung, degrade level, encoder geometry, software fallback, framerate,
    consecutive failures) to ``events``."""
    app = _make_app(pkg, w, h)
    sup = app.supervisor
    sup.clock = lambda: 0.0
    sup.last_ok = 0.0
    sup.recover_after = 4
    for name in ("tick_ok", "failure"):
        orig = getattr(sup, name)

        def wrapped(*a, _o=orig, _n=name, **k):
            r = _o(*a, **k)
            events.append((_n, sup.rung.name, sup.degrade_level, app.encoder.width,
                           app.encoder.height, app.software_fallback, app.framerate,
                           sup.failures))
            return r
        setattr(sup, name, wrapped)
    return app


# capture ticks 5-16 raise; the encoder site counts only ticks whose capture
# passed, so its checks 5-16 are ticks 17-28: 24 failures in a row (warn,
# force-IDR, one restart under the frozen clock, degrade 1 / 2 / 3 at 12 /
# 18 / 24), then 4 healthy ticks per reversed level
LADDER_SPEC = "capture@5-16:raise;encoder@5-16:raise"
LADDER_TICKS = 48


def _ladder_run(pkg, w, h, monkeypatch, x264: bool):
    if not x264:  # an image without libx264: the software rung degrades
        monkeypatch.setattr(pkg["x264"], "x264_available", lambda: False)
    pkg["fi"].configure_faults(LADDER_SPEC)
    events = []
    app = _ladder_app(pkg, w, h, events)
    serve_app(app, lambda a: len(events) >= LADDER_TICKS)
    pkg["fi"].reset_faults()
    return app, events[:LADDER_TICKS]


@pytest.mark.parametrize("w,h", GEOMS)
def test_ladder_matches_jax(flat, monkeypatch, caplog, w, h):
    """The ladder with the software row missing (libx264 not loadable):
    the same rungs, geometries, fallback flags and framerates tick for
    tick, equal AUs and QPs, equal data-channel messages, and each of the
    port's encoders gives its replay's AUs."""
    caplog.set_level(logging.WARNING)
    japp_, jev = _ladder_run(JAX, w, h, monkeypatch, x264=False)
    built = record_encoders(monkeypatch, tapp)
    tapp_, tev = _ladder_run(PORT, w, h, monkeypatch, x264=False)
    assert tev == jev
    n = min(len(japp_.transport.frames), len(tapp_.transport.frames))
    assert n >= LADDER_TICKS - 26
    assert _frames(tapp_)[:n] == _frames(japp_)[:n]
    assert tapp_.transport.messages == japp_.transport.messages
    rungs = [e[1] for e in tev]
    assert rungs.index("WARN") < rungs.index("FORCE_IDR") < rungs.index("RESTART") \
        < rungs.index("DEGRADE")
    levels = [e[2] for e in tev]
    assert max(levels) == 3 and levels[-1] == 0
    dw, dh = tel.DownscaleSource(tel.SyntheticSource(w, h)).width, \
        tel.DownscaleSource(tel.SyntheticSource(w, h)).height
    assert {(e[3], e[4]) for e in tev} == {(w, h), (dw, dh)}
    assert any(e[5] for e in tev) and not tev[-1][5] and tev[-1][6] == 60
    assert sum("x264enc falls back to tpuh264enc" in r.getMessage() for r in caplog.records) == 2
    # initial, restart, downscale rebuild, software rung, its reversal,
    # the full-size rebuild: each starts with an SPS of its own size
    assert [(b.name, b.kw["width"], b.kw["height"]) for b in built] == [
        ("tpuh264enc", w, h), ("tpuh264enc", w, h), ("tpuh264enc", dw, dh),
        ("x264enc", dw, dh), ("tpuh264enc", dw, dh), ("tpuh264enc", w, h)]
    for b in built:
        outs = logged_outputs(b)
        if outs:
            assert sps_size(outs[0][0]) == (b.kw["width"], b.kw["height"])
        assert replay(b, treg.create_encoder) == [(au, m) for au, _, m in outs]


def test_ladder_with_software_row_matches_jax(flat, monkeypatch):
    """With libx264 loaded the software rung is the real
    x264 row: the rungs, geometries, fallback flags and framerates still
    match JAX's tick for tick (libx264's bytes, and so the QPs after it,
    are not compared: it does not repeat its own bytes threaded)."""
    if not tx264.x264_available():
        pytest.skip("libx264 not loadable")
    _, jev = _ladder_run(JAX, 320, 192, monkeypatch, x264=True)
    tapp_, tev = _ladder_run(PORT, 320, 192, monkeypatch, x264=True)
    assert tev == jev
    assert any(e[5] for e in tev)
    codecs = [json.loads(m) for m in tapp_.transport.messages]
    assert {"type": "codec", "data": {"codec": "h264"}} in codecs


def test_ladder_swap_closes_the_replaced_encoder_at_once(flat, monkeypatch):
    """A swap from the tick's own ladder bookkeeping closes the replaced
    encoder before the next tick (its call had returned), even when the
    loop runs behind its clock: here the reversal of the software rung,
    made in tick_ok after a frame took longer than a 120 fps tick. JAX's
    closer waits for an idle instant between ticks, which such a loop
    never has, up to 30 s (ROADMAP queue 3)."""
    monkeypatch.setattr(tx264, "x264_available", lambda: False)
    built = record_encoders(monkeypatch, tapp)
    tfi.configure_faults("encoder@3-5:raise")
    app = _make_app(PORT, 320, 192, framerate=240)
    sup = app.supervisor
    sup.clock = lambda: 0.0
    sup.degrade_after, sup.degrade_every, sup.recover_after = 1, 1, 2
    sup.restart_after = sup.recycle_after = 100
    seen = {}

    def until(a):
        if len(built) == 4 and logged_outputs(built[3]) and "closed" not in seen:
            seen["closed"] = closed(built[2])
        return "closed" in seen
    serve_app(app, until)
    assert [b.name for b in built] == ["tpuh264enc", "tpuh264enc", "x264enc", "tpuh264enc"]
    assert seen["closed"]


# -- the app's own contracts ----------------------------------------------------

def test_failed_rebuild_keeps_previous_encoder_like_jax(monkeypatch):
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        app = _make_app(pkg, 320, 192)
        old, calls = app.encoder, []

        def boom(*a, **k):
            calls.append(k)
            raise RuntimeError("no encoder for you")
        monkeypatch.setattr(pkg["app"], "create_encoder", boom)
        first = app._rebuild_encoder(256, 160)
        again = app._rebuild_encoder(256, 160)  # rate-limited: no second build
        swapped = app._swap_encoder("tpuh264enc", 320, 192)
        assert first is old and again is old and app.encoder is old and not swapped
        out[name] = (app.transport.messages, len(calls))
        old.close()
    assert out["port"] == out["jax"]
    assert "256x160" in json.loads(out["port"][0][0])["data"]["message"]


def test_every_build_gets_the_apps_device(monkeypatch):
    """Construction, a resize rebuild, a restart, the software rung and
    its reversal all build on the app's device."""
    kws = []
    real = tapp.create_encoder

    def create(name, **kw):
        kws.append((name, kw["device"]))
        return real(name, **kw)
    monkeypatch.setattr(tapp, "create_encoder", create)
    app = _make_app(PORT, 320, 192)
    app._rebuild_encoder(160, 96)
    app._restart_encoder()
    app._enter_software_fallback()
    app._exit_software_fallback()
    app.encoder.close()
    cpu = torch.device("cpu")
    assert [d for _, d in kws] == [cpu] * 5 and app.device == cpu
    assert [n for n, _ in kws] == ["tpuh264enc", "tpuh264enc", "tpuh264enc", "x264enc",
                                   "tpuh264enc"]


def test_device_none_is_the_card():
    """``device=None`` means ``cuda``: without a card the app raises."""
    src = tel.SyntheticSource(64, 64)
    if torch.cuda.is_available():
        app = tapp.TorchWebRTCApp(source=src, width=64, height=64)
        assert app.device.type == "cuda" and app.encoder.device.type == "cuda"
        app.encoder.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapp.TorchWebRTCApp(source=src, width=64, height=64)
    with pytest.raises(ValueError, match="unsupported device"):
        tapp.TorchWebRTCApp(source=src, width=64, height=64, device="meta")


class _WebRTCTransport(FakeTransport):
    def __init__(self, ready=True):
        super().__init__(ready)
        self.remote = []

    def set_remote_sdp(self, t, sdp):
        self.remote.append(("sdp", t, sdp))

    def add_remote_ice(self, m, c):
        self.remote.append(("ice", m, c))


def _vocabulary(app) -> None:
    app.send_framerate(60)
    app.send_video_bitrate(4000)
    app.send_audio_bitrate(128000)
    app.send_encoder("tpuh264enc")
    app.send_codec()
    app.send_system_stats(12.5, 1024, 512)
    app.send_gpu_stats(0.5, 80.0, 12.25)
    app.send_tpu_stats(0.25, 16.0, 3.5)
    app.send_ping(123.4567)
    app.send_latency_time(17.25)
    app.send_clipboard_data("hello ünïcode")
    app.send_clipboard_data("x" * 70000)  # too large: dropped
    app.send_cursor_data({"curdata": "AAAA", "handle": 7, "override": None})
    app.send_reload_window()
    app.send_resize_enabled(True)
    app.send_resize_enabled(False)
    app.send_remote_resolution("1920x1080")
    app.set_sdp("offer", "v=0")
    app.set_ice(0, "candidate:1")


@pytest.mark.parametrize("ready", [True, False])
def test_data_channel_messages_match_jax(ready):
    """Every send_* and the SDP/ICE plumbing give equal JSON text (nothing
    while the channel is not ready); handle_data_message awaits a
    coroutine callback and calls a plain one."""
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        t = _WebRTCTransport(ready)
        app = _make_app(pkg, 64, 64, transport=t)
        _vocabulary(app)
        got = []

        async def cb(m):
            got.append(("async", m))
        app.on_data_message = cb
        asyncio.run(app.handle_data_message("kd,65"))
        app.on_data_message = lambda m: got.append(("sync", m))
        asyncio.run(app.handle_data_message("ku,65"))
        out[name] = (t.messages, t.remote, got, app.last_cursor_sent,
                     app.is_data_channel_ready())
        app.encoder.close()
    assert out["port"] == out["jax"]
    # 17 sends, less the oversized clipboard; SDP and ICE go to the peer
    assert len(out["port"][0]) == (16 if ready else 0) and len(out["port"][1]) == 2


def test_policy_and_slo_run_by_replay(monkeypatch):
    """SELKIES_POLICY=1 and SELKIES_SLO=1 on the registry row: the engine
    and the SLO plane observe the frames (their stats reach the telemetry
    providers), and each encoder's logged calls, knob retunes included,
    replay to the same AUs (a replaced encoder's are the head of its
    replay's: its close discarded the frames in flight). On the CPU the
    frames can miss the latency and fps objectives; the SLO pressure then
    downscales the source, and a second encoder is built at the reduced
    size."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry

    monkeypatch.setenv("SELKIES_POLICY", "1")
    monkeypatch.setenv("SELKIES_SLO", "1")
    built = record_encoders(monkeypatch, tapp)
    try:
        app = _make_app(PORT, 320, 192)
        assert app.policy_engine is not None and app.slo is not None
        serve_app(app, lambda a: len(a.transport.frames) >= 40)
        built[-1].flush()
        eng, slo = app.policy_engine.stats(), app.slo.stats()
        # the stop can land inside a tick, before its frames reach the planes
        assert eng["frames"] > 0 and slo["frames"] > 0 and not eng["disarmed"]
        assert slo["evaluations"] >= 1
        providers = json.loads(telemetry.statz_json())["providers"]
        assert providers["policy"]["0"]["frames"] == eng["frames"]
        assert providers["slo"]["0"]["frames"] == slo["frames"]
        assert providers["pipeline"]["running"] is False
        sent = [(f.au, f.timestamp_90k) for f in app.transport.frames]
        got = []
        for b in built:
            outs = [(au, m) for au, _, m in logged_outputs(b)]
            rep = replay(b, treg.create_encoder, device="cpu")
            assert rep[:len(outs)] == outs and (closed(b) or len(rep) == len(outs))
            got += outs
        assert got[:len(sent)] == sent
    finally:
        telemetry.disable()
        telemetry.reset()
