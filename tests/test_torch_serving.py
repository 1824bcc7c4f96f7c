"""Multi-session serving in the port: TorchMultiSessionH264Service against
JAX's MultiSessionH264Service (one virtual CPU device per session) by
sha256 per session and tick, over a trace with per-session QP, forced
keyframes and mixed ticks; against solo encoders fed the same frames (the
ported forms of tests/test_multi_session_serving.py); continuing a stream
JAX started (load_jax_state); the dispatch/complete seam and the API."""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.parallel.serving import MultiSessionH264Service
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

_ENV = ("SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND", "SELKIES_DAMAGE_FULL_SCAN",
        "SELKIES_TILE_CACHE", "SELKIES_PACK_DENSITY", "SELKIES_PACK_WORKERS",
        "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY", "SELKIES_BANDS")


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed, n, h, w):
    """tests/test_multi_session_serving.py's frames: a noise strip panned
    4 pixels per frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + 32, 4), dtype=np.uint8)
    return [np.ascontiguousarray(base[:, 4 * i:4 * i + w]) for i in range(n)]


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


# -- against JAX's service -------------------------------------------------

N, W, H = 4, 64, 48
TICKS = 7
# tick -> ops before it: ("qp", session, qp) and ("key", session)
OPS = {1: [("qp", 1, 34)], 2: [("key", 2)], 3: [("qp", 3, 20)],
       4: [("key", 0), ("key", 3), ("qp", 0, 40)], 6: [("key", 1)]}


def _trace():
    return [np.stack([_frames(10 + s, TICKS, H, W)[t] for s in range(N)]) for t in range(TICKS)]


def _drive(svc, ticks=range(TICKS)):
    """-> per tick, the sessions' AU sha256s and the IDR flags."""
    trace = _trace()
    out = []
    for t in ticks:
        for op in OPS.get(t, ()):
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
        aus = svc.encode_tick(trace[t])
        assert all(au.startswith(b"\x00\x00\x00\x01") for au in aus)
        out.append(([_sha(a) for a in aus], list(svc.last_idrs)))
    return out


@functools.lru_cache(maxsize=None)
def jax_run():
    svc = MultiSessionH264Service(N, W, H, qp=26, devices=jax.devices()[:N])
    try:
        return _drive(svc)
    finally:
        svc.close()


@functools.lru_cache(maxsize=None)
def port_run():
    svc = TorchMultiSessionH264Service(N, W, H, qp=26, device="cpu")
    try:
        return _drive(svc)
    finally:
        svc.close()


@pytest.mark.parametrize("tick", range(TICKS))
def test_service_matches_jax(tick):
    got, want = port_run()[tick], jax_run()[tick]
    assert got == want


def test_service_trace_has_mixed_ticks():
    idrs = [i for _, i in port_run()]
    assert idrs[0] == [True] * N and idrs[1] == [False] * N
    assert idrs[2] == [False, False, True, False]
    assert idrs[4] == [True, False, False, True]  # two forced sessions in one tick


def _jax_state(svc) -> dict:
    return {"ref": [np.asarray(r) for r in svc.enc._ref],
            "sessions": [{"frames_since_idr": s.frames_since_idr, "idr_pic_id": s.idr_pic_id,
                          "force_idr": s.force_idr, "qp": s.qp} for s in svc.sessions],
            "pic_init_qp": svc.params.qp}


def test_load_jax_state_continues_the_stream():
    """JAX runs 2 ticks; the port continues from its state with JAX's AUs
    (the same service's run from tick 2 on, forced keyframes included)."""
    jsvc = MultiSessionH264Service(N, W, H, qp=30, devices=jax.devices()[:N])
    try:
        _drive(jsvc, range(2))
        state = _jax_state(jsvc)
        want = _drive(jsvc, range(2, 5))
    finally:
        jsvc.close()
    svc = TorchMultiSessionH264Service(N, W, H, qp=22, device="cpu")  # another pic_init_qp
    try:
        svc.load_jax_state(state)
        got = _drive(svc, range(2, 5))
    finally:
        svc.close()
    assert got == want


def test_load_jax_state_checks_its_input():
    svc = TorchMultiSessionH264Service(2, 32, 32, device="cpu")
    good = {"ref": [np.zeros((2, 32, 32)), np.zeros((2, 16, 16)), np.zeros((2, 16, 16))],
            "sessions": [{"frames_since_idr": 1, "idr_pic_id": 1, "force_idr": False,
                          "qp": 28}] * 2, "pic_init_qp": 28}
    try:
        with pytest.raises(ValueError, match="reference planes"):
            svc.load_jax_state({**good, "ref": [r[:1] for r in good["ref"]]})
        with pytest.raises(ValueError, match="session states"):
            svc.load_jax_state({**good, "sessions": good["sessions"][:1]})
        pending = svc.dispatch_tick(np.zeros((2, 32, 32, 4), np.uint8))
        with pytest.raises(RuntimeError, match="in flight"):
            svc.load_jax_state(good)
        svc.complete_tick(pending)
        svc.load_jax_state(good)
        assert svc.enc._ref[0].shape == (2, 32, 32) and svc.params.qp == 28
    finally:
        svc.close()


# -- against solo encoders ------------------------------------------------


def _solo(w, h, qp, device="cpu"):
    return TorchH264Encoder(w, h, qp=qp, host_convert=False, frame_batch=1, pipeline_depth=0,
                            device=device)


def test_two_sessions_bit_identical_to_solo(tmp_path):
    h = w = 64
    n_frames = 4
    a = _frames(1, n_frames, h, w)
    b = _frames(2, n_frames, h, w)
    svc = TorchMultiSessionH264Service(2, w, h, qp=26, device="cpu")
    svc.set_qp(1, 30)  # sessions retune independently
    streams = [b"", b""]
    for t in range(n_frames):
        aus = svc.encode_tick(np.stack([a[t], b[t]]))
        streams[0] += aus[0]
        streams[1] += aus[1]
    svc.close()
    for sid, (frames, qp) in enumerate([(a, 26), (b, 30)]):
        # the service's pic_init_qp (26); per-session QP through encode_frame
        solo = _solo(w, h, 26)
        ref = b"".join(solo.encode_frame(f, qp=qp) for f in frames)
        solo.close()
        assert streams[sid] == ref, f"session {sid} diverged from the solo stream"
    cv2 = pytest.importorskip("cv2")
    for sid in (0, 1):
        p = tmp_path / f"s{sid}.h264"
        p.write_bytes(streams[sid])
        cap = cv2.VideoCapture(str(p))
        k = 0
        while cap.read()[0]:
            k += 1
        assert k == n_frames


def test_forced_keyframe_mixed_tick():
    """One session's keyframe does not drag the other onto the IDR path,
    and both streams equal solo encoders given the same keyframe."""
    h = w = 64
    frames = _frames(5, 4, h, w)
    svc = TorchMultiSessionH264Service(2, w, h, qp=28, device="cpu")
    aus = [svc.encode_tick(np.stack([frames[0], frames[0]])),
           svc.encode_tick(np.stack([frames[1], frames[1]]))]
    svc.force_keyframe(1)
    aus.append(svc.encode_tick(np.stack([frames[2], frames[2]])))
    assert aus[2][1][4] & 0x1F == 7, "forced session did not IDR"
    assert aus[2][0][4] & 0x1F == 1, "unforced session was dragged onto the IDR path"
    assert svc.last_idrs == [False, True]
    aus.append(svc.encode_tick(np.stack([frames[3], frames[3]])))
    assert all(au[4] & 0x1F == 1 for au in aus[3])
    svc.close()
    for sid in (0, 1):
        solo = _solo(w, h, 28)
        want = []
        for t, f in enumerate(frames):
            if sid == 1 and t == 2:
                solo.force_keyframe()
            want.append(solo.encode_frame(f))
        solo.close()
        assert [a[sid] for a in aus] == want, f"session {sid}"


# -- the seam and the API ---------------------------------------------------


def test_dispatch_complete_equals_encode_tick():
    frames = _frames(8, 3, 32, 48)
    one = TorchMultiSessionH264Service(2, 48, 32, device="cpu")
    two = TorchMultiSessionH264Service(2, 48, 32, device="cpu")
    try:
        for t, f in enumerate(frames):
            batch = np.stack([f, frames[-1 - t]])
            pending = two.dispatch_tick(batch)
            assert two.sessions[0].frames_since_idr == t  # the GOP advances at completion
            assert two.complete_tick(pending) == one.encode_tick(batch)
        timing = two.last_timing
        assert set(timing) == {"convert_ms", "h2d_ms", "dispatch_ms", "step_ms", "fetch_ms",
                               "pack_ms", "down_bytes"}
        # a P tick fetches int16 dense coefficients without the I-only fields
        mbs = 2 * 6
        assert timing["down_bytes"] == 2 * mbs * (2 + 1 + 256 + 8 + 128)
    finally:
        one.close()
        two.close()


def test_errors_match_jax():
    svc = TorchMultiSessionH264Service(2, 32, 32, device="cpu")
    jsvc = MultiSessionH264Service(2, 32, 32, devices=jax.devices()[:2])
    try:
        for s in (svc, jsvc):
            with pytest.raises(ValueError, match="expected 2 frames, got 3"):
                s.dispatch_tick(np.zeros((3, 32, 32, 4), np.uint8))
            with pytest.raises(ValueError, match="out of range"):
                s.set_qp(0, 52)
        with pytest.raises(ValueError, match="MB-aligned"):
            TorchMultiSessionH264Service(2, 1920, 1080, device="cpu")
        with pytest.raises(ValueError, match="MB-aligned"):
            MultiSessionH264Service(2, 1920, 1080, devices=jax.devices()[:2])
    finally:
        svc.close()
        jsvc.close()
