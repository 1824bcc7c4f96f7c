"""The fleet's session lifecycle in the port (selkies_tpu_torch/parallel/
lifecycle.py) against JAX's: the SessionPlacer fed the same stand-in chip
lists and call sequences as tests/test_lifecycle.py, compared on rows,
counters, ``stats()``, ``states()`` and the placement gauges, also under
seeded ``admission`` / ``recarve`` chaos and through quarantine and
readmission; the placer over the device pool; checkpoints field for field
against JAX's off live services and through the JSON round trip (a JAX
checkpoint restored into the port continues JAX's stream); drain under a
``drain`` fault and SIGTERM over a fake fleet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.monitoring.telemetry import telemetry as jtelemetry
from selkies_tpu.parallel import lifecycle as J
from selkies_tpu.parallel.serving import BandedFleetService, MultiSessionH264Service
from selkies_tpu.resilience import InjectedFault as JaxInjectedFault
from selkies_tpu.resilience import configure_faults as jax_configure
from selkies_tpu.resilience import reset_faults as jax_reset
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttelemetry
from selkies_tpu_torch.parallel import lifecycle as T
from selkies_tpu_torch.parallel.serving import TorchBandedFleetService, TorchMultiSessionH264Service
from selkies_tpu_torch.resilience import (
    DevicePool,
    InjectedFault,
    configure_faults,
    reset_device_pool,
    reset_faults,
    set_device_pool,
)

W, H = 64, 96  # tests/test_lifecycle.py's geometry: 6 MB rows, 2 bands of 3
CPU = torch.device("cpu")
PKGS = {"jax": (J, jtelemetry, jax_configure, JaxInjectedFault),
        "torch": (T, ttelemetry, configure_faults, InjectedFault)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SELKIES_FAULTS", "SELKIES_DRAIN_TIMEOUT", "SELKIES_ADMISSION_QUEUE",
              "SELKIES_BANDS", "SELKIES_TILE_GRID", "SELKIES_FRONTEND_WORKERS",
              "SELKIES_PARALLEL_FRONTEND", "SELKIES_DAMAGE_FULL_SCAN"):
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    reset_faults()
    jax_reset()
    reset_device_pool()
    for tel in (jtelemetry, ttelemetry):
        tel.enabled = False
        tel.reset()


@pytest.fixture
def loop():
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    yield loop
    loop.close()


def chips(n=8):
    return [f"chip{i}" for i in range(n)]


def _gauges(tel) -> dict:
    return {f"{fam}:{','.join(lbls)}": v for (fam, lbls), v in sorted(tel._gauges.items())
            if fam in ("selkies_placement_chips", "selkies_codec_sessions")}


def _view(p) -> dict:
    """Everything a placer shows: stats (carve, counters, queue), states,
    free pool order and the debts."""
    return {"stats": p.stats(), "states": p.states(), "free": list(p._free),
            "debts": {k: [(l, list(c)) for l, c in v] for k, v in sorted(p._debts.items())}}


def _both(script, *, telemetry_on: bool = False) -> None:
    """Run ``script(pkg, module, log)`` for JAX and the port; the logs
    (return values and views after each step) must be equal."""
    logs = {}
    for name, (mod, tel, *_rest) in PKGS.items():
        tel.reset()
        tel.enabled = telemetry_on
        log: list = []
        script(name, mod, log)
        if telemetry_on:
            log.append(_gauges(tel))
        logs[name] = log
        tel.enabled = False
        tel.reset()
    assert logs["torch"] == logs["jax"]
    return logs["torch"]


def _adm(a) -> tuple:
    return (a.decision, a.reason, a.accepted)


# -- the placer: tests/test_lifecycle.py's sequences, on both packages ---------


def test_admission_and_queue_promotion_as_jax():
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(8), bands=2, host_cores=8, queue_limit=2)
        log.append(p.place_initial(3, 2))
        for s in (0, 3, 4, 5, 6):
            log.append(_adm(p.admit(s)))
        promoted = []
        p.on_admitted = promoted.append
        p.release(3)
        log += [promoted, _view(p)]

    log = _both(script, telemetry_on=True)
    assert log[1:6] == [("accept", "placed", True), ("accept", "placed", True),
                        ("queue", "capacity", False), ("queue", "capacity", False),
                        ("reject", "capacity", False)]
    assert log[6] == [4]


def test_pack_pool_headroom_gates_admission_as_jax():
    def script(_, m, log):
        for n in (2, 3):
            p = m.SessionPlacer(devices=chips(8), bands=2, host_cores=2, queue_limit=4)
            p.place_initial(n, 2)
            p.set_busy(0, True)
            p.set_busy(1, True)
            log.append(_adm(p.admit(2)))
            p.set_busy(1, False)
            log += [_adm(p.admit(2)), _view(p)]

    log = _both(script)
    assert log[0] == ("queue", "pack-pool", False) and log[3] == ("queue", "pack-pool", False)
    assert log[4][2]


def test_shared_fallback_small_slice_as_jax():
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(1), bands=2, host_cores=8)
        log += [p.place_initial(2, 2), p.shared, _adm(p.admit(0)), _adm(p.admit(5)),
                p.borrow(0)]
        p.draining = True
        log += [_adm(p.admit(6)), _view(p)]

    log = _both(script, telemetry_on=True)
    assert log[:2] == [[["chip0"], ["chip0"]], True] and log[4] == []


def test_borrow_return_and_reclaim_as_jax():
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(4), bands=2, host_cores=8)
        p.place_initial(2, 2)
        p.set_busy(0, True)
        log += [p.borrow(0), _view(p), _adm(p.admit(1)), p.borrowers_from(1)]
        log += [p.return_borrowed(0), _adm(p.admit(1)), _view(p)]

    log = _both(script, telemetry_on=True)
    assert len(log[0]) == 2 and log[2] == ("queue", "chips-lent", False) and log[3] == [0]


def test_released_lender_readmission_as_jax():
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(6), bands=2, host_cores=8)
        p.place_initial(2, 2)
        p.set_busy(0, True)
        log.append(p.borrow(0))
        p.release(1)
        log += [_adm(p.admit(1)), p.row(1), p.return_borrowed(0), _view(p)]

    log = _both(script)
    assert log[-1]["stats"]["free"] == 2 and log[-1]["stats"]["borrowed"] == 0


def test_grid_carve_admission_borrow_and_gauges_as_jax():
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(16), bands=4, grid=(2, 2), host_cores=16,
                            queue_limit=2)
        log += [p.place_initial(3, 4), p.stats()["grid"], _adm(p.admit(3)), _adm(p.admit(4))]
        p.set_busy(0, True)
        log += [p.borrow(0), _view(p), p.return_borrowed(0), _view(p)]

    log = _both(script, telemetry_on=True)
    assert log[1] == "2x2" and len(log[4]) == 4


@pytest.mark.parametrize("grid,bands", [((2, 2), 3), ((1, 3), 2), ((3, 1), 4)])
def test_grid_shape_must_match_chip_budget(grid, bands):
    for m in (J, T):
        with pytest.raises(ValueError, match="does not match"):
            m.SessionPlacer(devices=chips(8), bands=bands, grid=grid)


@pytest.mark.parametrize("seed", [42, 7, 2024])
def test_seeded_chaos_never_overcommits_as_jax(seed):
    """tests/test_lifecycle.py's chaos: a seeded random op sequence with
    admission / re-carve faults firing. Every mutator self-checks the
    no-over-commit invariant; here every step's outcome and view must
    also equal JAX's under the same spec."""
    spec = "admission@p:0.2,seed:7:drop;recarve@p:0.3,seed:11:raise"

    def script(name, m, log):
        _, _, configure, exc = PKGS[name]
        configure(spec)
        p = m.SessionPlacer(devices=chips(8), bands=2, host_cores=8, queue_limit=4)
        p.place_initial(2, 2)
        rng = np.random.default_rng(seed)
        for _ in range(300):
            sid = int(rng.integers(0, 6))
            op = int(rng.integers(0, 5))
            if op == 0:
                out = _adm(p.admit(sid))
            elif op == 1:
                out = p.release(sid)
            elif op == 2:
                try:
                    out = p.borrow(sid)
                except exc:
                    out = "recarve-fault"
            elif op == 3:
                out = p.return_borrowed(sid)
            else:
                out = p.set_busy(sid, bool(rng.integers(0, 2)))
            p.assert_consistent()
            st = p.stats()
            assert sum(len(v) for v in st["carve"].values()) + st["free"] == 8
            log.append((op, sid, out, st))
        log.append(dict(p.counters))

    log = _both(script)
    assert "recarve-fault" in [x[2] for x in log[:-1]]
    assert log[-1]["borrows"] >= 1 and log[-1]["returns"] >= 1


def test_admission_fault_site_rejects_as_jax():
    def script(name, m, log):
        fi = PKGS[name][2]("admission@1:drop;admission@2:raise")
        p = m.SessionPlacer(devices=chips(4), bands=1, host_cores=8)
        p.place_initial(2, 1)
        log += [_adm(p.admit(0)) for _ in range(3)]
        log.append([x[0] for x in fi.injected])

    log = _both(script, telemetry_on=True)
    assert log[:3] == [("reject", "fault-injected", False)] * 2 + [("accept", "placed", True)]


def test_quarantine_and_readmit_as_jax():
    """A chip out of the free pool, out of a row, off a live loan and with
    its home released; readmission into the row, the debt and the pool."""
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(6), bands=2, host_cores=8, queue_limit=2)
        p.place_initial(2, 2)
        log += [p.quarantine("chip4"), p.quarantine("chip1"), _adm(p.admit(2)), _view(p)]
        p.set_busy(0, True)
        log += [p.borrow(0), p.quarantine("chip2"), _view(p)]
        log += [p.readmit("chip2"), _view(p), p.return_borrowed(0), p.readmit("chip1"),
                _view(p)]
        p.release(1)
        log += [p.quarantine("chip0"), p.readmit("chip4"), p.readmit("chip0"),
                p.readmit("nope"), p.quarantine("nope"), p.quarantined_keys(),
                p.is_quarantined("chip0"), p.owns("chip5"), _view(p)]

    log = _both(script, telemetry_on=True)
    assert log[0] == [] and log[1] == [0]


def test_codec_record_and_gauges_as_jax():
    def script(_, m, log):
        p = m.SessionPlacer(devices=chips(4), bands=1, host_cores=8)
        p.place_initial(3, 1)
        p.set_codec(1, "AV1")
        p.set_codec(2, "")
        log += [p.codec(1), p.codec(2), p.codec(7), p.codec_counts()]
        p.release(1)
        log += [p.codec(1), p.codec_counts(), _view(p)]

    log = _both(script, telemetry_on=True)
    assert log[:4] == ["av1", "h264", "h264", {"h264": 2, "av1": 1}]


def test_placer_over_the_device_pool():
    """devices=None takes the pool's chips and pre-applies its quarantine
    (the card's pool here stood in by one over the CPU); on one device a
    2-session carve is shared and borrow gives nothing."""
    pool = set_device_pool(DevicePool(devices=[CPU]))
    p = T.SessionPlacer(bands=2, host_cores=8)
    assert p.devices == [CPU] and p.quarantined_keys() == []
    assert p.place_initial(2, 2) == [[CPU], [CPU]] and p.shared
    assert p.admit(0).accepted and p.borrow(0) == []
    pool.quarantine(CPU)
    q = T.SessionPlacer(bands=1, host_cores=8)
    assert q.quarantined_keys() == ["0"] and q.stats()["quarantined"] == ["0"]


def test_placer_devices_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pool enumerates it")
    reset_device_pool()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.SessionPlacer(bands=2)


@pytest.mark.parametrize("name,value", [
    ("SELKIES_DRAIN_TIMEOUT", ""), ("SELKIES_DRAIN_TIMEOUT", "3.5"),
    ("SELKIES_DRAIN_TIMEOUT", "0"), ("SELKIES_DRAIN_TIMEOUT", "soon"),
    ("SELKIES_ADMISSION_QUEUE", ""), ("SELKIES_ADMISSION_QUEUE", "3"),
    ("SELKIES_ADMISSION_QUEUE", "-2"), ("SELKIES_ADMISSION_QUEUE", "x")])
def test_env_knobs_resolve_as_jax(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    assert T.drain_timeout_from_env() == J.drain_timeout_from_env()
    assert T._queue_limit_from_env() == J._queue_limit_from_env()


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_json_roundtrip_as_jax():
    kw = dict(session=3, qp=31, frames_since_idr=17, idr_pic_id=1,
              rc={"bitrate_kbps": 1500}, congestion={"estimate_kbps": 900.0}, ltr={"0": 5})
    ck, jck = T.SessionCheckpoint(**kw), J.SessionCheckpoint(**kw)
    assert ck.to_json() == jck.to_json()
    assert T.SessionCheckpoint.from_json(ck.to_json()) == ck
    blob = jck.to_json()[:-1] + ', "future_field": 1}'
    assert T.SessionCheckpoint.from_json(blob) == ck
    assert [f.name for f in dataclasses.fields(T.SessionCheckpoint)] == \
        [f.name for f in dataclasses.fields(J.SessionCheckpoint)]


class _RC:
    def __init__(self, kbps, fps):
        self.bitrate_kbps, self.fps, self.qp, self._fullness = kbps, fps, 30, 0.25

    def set_bitrate(self, kbps):
        self.bitrate_kbps = kbps

    def set_framerate(self, fps):
        self.fps = fps


class _GCC:
    def __init__(self, est):
        self.estimate_kbps, self.max_kbps, self.min_kbps = est, 6000, 300


def _slot(kbps=1800, est=2500.0):
    s = type("Slot", (), {})()
    s.rc, s.gcc = _RC(kbps, 30), _GCC(est)
    return s


def _ck_fields(ck) -> dict:
    d = dataclasses.asdict(ck)
    d.pop("wall_time")
    return d


def _frames(n, seed=0, w=W, h=H, sessions=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (sessions, h, w, 4), np.uint8) for _ in range(n)]


def test_live_checkpoints_equal_jax_field_for_field():
    """Checkpoints off live services after the same ticks (a forced
    keyframe and a QP change among them) equal JAX's in every field but
    the wall clock: the banded service's per-session encoders and the
    batch service's session states, with a slot's rate control and
    congestion estimate."""
    frames = _frames(4, seed=5)
    devs = jax.devices()
    pairs = [
        (TorchBandedFleetService(2, W, H, qp=28, fps=30, bands=2, rows=[[CPU] * 2] * 2),
         BandedFleetService(2, W, H, qp=28, fps=30, bands=2, rows=[devs[:2], devs[2:4]])),
        (TorchMultiSessionH264Service(2, W, H, qp=28, fps=30, device="cpu"),
         MultiSessionH264Service(2, W, H, qp=28, fps=30, devices=devs[4:6])),
    ]
    try:
        for svc, jsvc in pairs:
            for t, f in enumerate(frames):
                if t == 2:
                    for s in (svc, jsvc):
                        s.force_keyframe(1)
                        s.set_qp(0, 33)
                assert svc.encode_tick(f) == jsvc.encode_tick(f)
            for k in range(2):
                got = _ck_fields(T.checkpoint_session(svc, k, slot=_slot()))
                want = _ck_fields(J.checkpoint_session(jsvc, k, slot=_slot()))
                assert got == want
                assert got["idr_pic_id"] == 1 - k and got["frames_since_idr"] == 4 - 2 * k
                assert got["qp"] == (33 if k == 0 else 28) and got["width"] == W
                assert got["rc"]["fullness"] == 0.25 and got["congestion"]["max_kbps"] == 6000
    finally:
        for pair in pairs:
            for s in pair:
                s.close()


def test_jax_checkpoint_resumes_in_the_port_within_one_gop():
    """Kill-slot-mid-migration across packages: the first checkpoint of
    JAX's session dies on an injected fault, the retry lands; its JSON is
    restored into a fresh port service (through the port's own migrate
    site, which fails once first), and the recovery IDR and the P frame
    after it equal JAX's uninterrupted oracle forced a keyframe there."""
    devs = jax.devices()
    frames = _frames(5)
    jax_configure("migrate:1@1:raise")
    configure_faults("migrate:1@1:raise")
    jsvc = MultiSessionH264Service(2, W, H, qp=28, fps=30, devices=devs[:2])
    oracle = MultiSessionH264Service(2, W, H, qp=28, fps=30, devices=devs[2:4])
    target = TorchMultiSessionH264Service(2, W, H, qp=28, fps=30, device="cpu")
    try:
        for t in range(3):
            assert jsvc.encode_tick(frames[t]) == oracle.encode_tick(frames[t])
        with pytest.raises(JaxInjectedFault):
            J.checkpoint_session(jsvc, 1, slot=_slot())
        blob = J.checkpoint_session(jsvc, 1, slot=_slot()).to_json()
        slot2 = _slot(kbps=1000, est=100.0)
        with pytest.raises(InjectedFault):
            T.restore_session(T.SessionCheckpoint.from_json(blob), target, 1, slot=slot2)
        T.restore_session(T.SessionCheckpoint.from_json(blob), target, 1, slot=slot2)
        assert slot2.rc.bitrate_kbps == 1800 and slot2.gcc.estimate_kbps == 2500.0
        oracle.force_keyframe(0)
        oracle.force_keyframe(1)
        a, b = target.encode_tick(frames[3]), oracle.encode_tick(frames[3])
        assert target.last_idrs[1] and a[1] == b[1], "recovery IDR differs from JAX's oracle"
        a, b = target.encode_tick(frames[4]), oracle.encode_tick(frames[4])
        assert a[1] == b[1], "post-IDR P frame differs"
    finally:
        for s in (jsvc, oracle, target):
            s.close()


def test_restore_clamps_congestion_and_keeps_missing_rc():
    svc = TorchMultiSessionH264Service(1, W, H, device="cpu")
    try:
        ck = T.SessionCheckpoint(session=0, qp=40, idr_pic_id=1, frames_since_idr=9,
                                 congestion={"estimate_kbps": 1e9})
        slot = _slot(kbps=700, est=500.0)
        T.restore_session(ck, svc, slot=slot)
        s = svc.sessions[0]
        assert (s.qp, s.idr_pic_id, s.frames_since_idr, s.force_idr) == (40, 1, 9, True)
        assert slot.gcc.estimate_kbps == 6000 and slot.rc.bitrate_kbps == 700
    finally:
        svc.close()


# -- drain --------------------------------------------------------------------


class _FakeSessionState:
    def __init__(self):
        self.frames_since_idr = 4
        self.idr_pic_id = 1
        self.force_idr = False
        self.qp = 30


class _FakeService:
    """tests/test_lifecycle.py's MultiSessionH264Service-shaped double:
    instant ticks, real per-session GOP state for checkpointing."""

    def __init__(self, n):
        self.n = n
        self.sessions = [_FakeSessionState() for _ in range(n)]
        self.params = type("P", (), {"width": W, "height": H, "fps": 30})()
        self.forced: list[int] = []
        self.ticks = 0

    def force_keyframe(self, k):
        self.forced.append(k)
        self.sessions[k].force_idr = True

    def encode_tick(self, frames):
        for s in self.sessions:
            s.force_idr = False
        self.ticks += 1
        return [b"\x00\x00\x00\x01" + bytes([65 + k]) * 8 for k in range(self.n)]


def _drain_run(name: str, loop) -> dict:
    """A fake fleet (a placer with two busy sessions, a tick loop on the
    event loop) drained under ``drain@1:delay:50``."""
    m, tel, configure, _ = PKGS[name]
    configure("drain@1:delay:50")
    placer = m.SessionPlacer(devices=chips(2), bands=1, host_cores=8)
    placer.place_initial(2, 1)
    for k in range(2):
        placer.set_busy(k, True)
    svc = _FakeService(2)

    async def scenario():
        stop = asyncio.Event()

        async def ticker():
            while not stop.is_set():
                svc.encode_tick(None)
                await asyncio.sleep(0.01)

        async def flush():
            target = svc.ticks + 1
            while svc.ticks < target:
                await asyncio.sleep(0.01)

        drainer = m.DrainController(
            "fleet-test", placer=placer, deadline_s=5.0,
            force_idr=lambda: [svc.force_keyframe(k) for k in range(2)], flush=flush,
            handoff=lambda: [m.checkpoint_session(svc, k) for k in range(2)],
            on_drained=stop.set)
        task = asyncio.ensure_future(ticker())
        health = [tel.health()["lifecycle"]["state"]]
        ok = await asyncio.wait_for(drainer.drain(), 10)
        again = await drainer.drain()
        await task
        health.append(tel.health()["status"])
        return {"ok": ok, "again": again, "state": drainer.state, "forced": sorted(svc.forced),
                "checkpoints": [_ck_fields(c) for c in drainer.checkpoints],
                "admit": _adm(placer.admit(0)), "health": health,
                "view": drainer.health_view()}

    try:
        return loop.run_until_complete(scenario())
    finally:
        tel._lifecycle = None


def test_drain_under_fault_injection_meets_deadline_as_jax(loop):
    got, want = _drain_run("torch", loop), _drain_run("jax", loop)
    assert got == want
    assert got["ok"] and got["again"] and got["state"] == "drained"
    assert got["forced"] == [0, 1] and len(got["checkpoints"]) == 2
    assert got["checkpoints"][0]["idr_pic_id"] == 1
    assert got["admit"] == ("reject", "draining", False)
    assert got["health"] == ["serving", "draining"]
    assert got["view"]["slots"] == {"0": "busy", "1": "busy"}


def test_drain_failures_are_reported_not_raised(loop):
    """A failing flush and handoff, and an injected drain raise: the drain
    still completes, reports False, and the gauge walks 0 -> 1 -> 2."""
    configure_faults("drain@1:raise")
    ttelemetry.enabled = True

    async def bad_flush():
        raise RuntimeError("flush failed")

    def bad_handoff():
        raise RuntimeError("handoff failed")

    drainer = T.DrainController("bad", deadline_s=1.0, flush=bad_flush, handoff=bad_handoff,
                                force_idr=lambda: 1 / 0)
    try:
        assert loop.run_until_complete(drainer.drain()) is False
        assert drainer.state == "drained" and drainer.completed_in_deadline is False
        assert ttelemetry._gauges[("selkies_drain_state", ())] == 2
    finally:
        ttelemetry._lifecycle = None


def test_sigterm_routes_through_drain(loop):
    """A real SIGTERM drives the drain path, which completes in its
    deadline; a second signal restores the default disposition."""

    async def scenario():
        flushed = []

        async def _sleepy():
            await asyncio.sleep(0.01)
            flushed.append("flushed")

        drainer = T.DrainController("sig-test", deadline_s=5.0, flush=_sleepy)
        uninstall = T.install_signal_handlers(drainer.drain, loop=asyncio.get_running_loop(),
                                              signals=(signal.SIGTERM,))
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):
            if drainer.state == "drained":
                break
            await asyncio.sleep(0.02)
        assert drainer.state == "drained", "SIGTERM did not drain"
        assert drainer.completed_in_deadline and flushed == ["flushed"]
        uninstall()

    try:
        loop.run_until_complete(scenario())
    finally:
        ttelemetry._lifecycle = None


def test_checkpoint_of_a_bare_encoder_and_tile_epoch():
    """_session_gop's third shape: a bare banded encoder."""
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    enc = TorchBandedH264Encoder(W, H, qp=27, fps=24, bands=2, device="cpu")
    try:
        for f in _frames(3, seed=3, sessions=1):
            enc.encode_frame(f[0])
        ck = T.checkpoint_session(enc, 0)
        assert (ck.codec, ck.qp, ck.frames_since_idr, ck.idr_pic_id, ck.width, ck.height,
                ck.fps, ck.tile_epoch, ck.ltr) == ("h264", 27, 3, 1, W, H, 24.0, 0, {})
        enc2 = TorchBandedH264Encoder(W, H, qp=28, bands=2, device="cpu")
        T.restore_session(ck, enc2)
        assert (enc2.qp, enc2._idr_pic_id, enc2._frames_since_idr, enc2._force_idr) == \
            (27, 1, 3, True)
        enc2.close()
    finally:
        enc.close()
