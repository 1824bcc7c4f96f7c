"""TorchH264Encoder against TPUH264Encoder in its device-conversion
configuration (``host_convert=False`` on both): the same frames must give
byte-identical access units."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu_torch.models.h264 import native
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

W, H = 320, 192


def _jax_encoder(**kw):
    return TPUH264Encoder(W, H, host_convert=False, pipeline_depth=0, frame_batch=1,
                          entropy_coder="cavlc", tile_cache=0, **kw)


def _trace(seed=1):
    """Desktop-like BGRx trace: block wallpaper, scrolls, a typing patch,
    a repeated (static) frame, a pan and a full-frame change."""
    rng = np.random.default_rng(seed)
    cur = np.kron(rng.integers(40, 200, (H // 16, W // 16, 4), np.uint8),
                  np.ones((16, 16, 1), np.uint8))
    frames = [cur]
    for _ in range(2):
        cur = np.roll(cur, 8, 0)
        frames.append(cur)
    cur = cur.copy()
    cur[40:56, 40:200, :3] = rng.integers(0, 255, (16, 160, 3), np.uint8)
    frames += [cur, cur.copy()]  # typing, then static repeat
    frames.append(np.roll(cur, (-5, 3), (0, 1)))
    frames.append(np.roll(frames[-1], 16, 1))
    frames.append(rng.integers(0, 255, (H, W, 4), np.uint8))
    frames.append(np.roll(frames[-1], (2, -2), (0, 1)))
    frames.append(frames[-1].copy())
    return frames


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


def _drive(enc, frames):
    """Encode the trace with a force_keyframe at frame 5 and a QP change at 7."""
    out = []
    for i, f in enumerate(frames):
        if i == 5:
            enc.force_keyframe()
        au = enc.encode_frame(f, qp=34 if i == 7 else None)
        out.append((_sha(au), enc.last_stats.idr))
    return out


@pytest.mark.parametrize("keyframe_interval", [0, 4])
def test_matches_jax_encoder_bytes(keyframe_interval):
    frames = _trace()
    want = _drive(_jax_encoder(qp=28, keyframe_interval=keyframe_interval), frames)
    calls = native.calls
    got = _drive(TorchH264Encoder(W, H, qp=28, keyframe_interval=keyframe_interval,
                                  host_convert=False, device="cpu"), frames)
    assert got == want
    assert native.calls > calls
    idrs = [i for i, (_, idr) in enumerate(got) if idr]
    assert idrs == ([0, 5] if keyframe_interval == 0 else [0, 4, 5, 9])


def test_static_frame_is_allskip_au():
    frames = _trace()
    enc = TorchH264Encoder(W, H, host_convert=False, device="cpu")
    enc.encode_frame(frames[3])
    au = enc.encode_frame(frames[3])
    assert enc.last_stats.upload_kind == "static"
    assert enc.last_stats.skipped_mbs == (H // 16) * (W // 16)
    assert len(au) < 16


def test_load_jax_state_continues_the_stream():
    frames = _trace(seed=2)
    jax_enc = _jax_encoder(qp=30)
    for f in frames[:2]:  # IDR + P
        jax_enc.encode_frame(f)
    state = {
        "ref": [np.asarray(p) for p in jax_enc._ref],
        "frame_index": jax_enc.frame_index,
        "frames_since_idr": jax_enc._frames_since_idr,
        "idr_pic_id": jax_enc._idr_pic_id,
        "qp": jax_enc.qp,
        "pic_init_qp": jax_enc.params.qp,
        "prev_frame": jax_enc._prev_frame,
    }
    # default qp 28: the state sets 30
    enc = TorchH264Encoder(W, H, host_convert=False, device="cpu")
    enc.load_jax_state(state)
    for i, f in enumerate(frames[2:7]):
        qp = 26 if i == 2 else None
        assert _sha(enc.encode_frame(f, qp)) == _sha(jax_enc.encode_frame(f, qp))
        assert not enc.last_stats.idr
    enc.force_keyframe()
    jax_enc.force_keyframe()
    assert enc.encode_frame(frames[7]) == jax_enc.encode_frame(frames[7])  # same SPS/PPS


def test_recon_planes_match_jax():
    frame = _trace(seed=3)[-3]
    want = _jax_encoder().recon_planes(frame)
    got = TorchH264Encoder(W, H, host_convert=False, device="cpu").recon_planes(frame)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_non_mb_multiple_size_pads_like_jax():
    w, h = 98, 50  # pads to 112x64
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 255, (h, w, 3), np.uint8) for _ in range(2)]
    jax_enc = TPUH264Encoder(w, h, channels=3, host_convert=False, pipeline_depth=0,
                             frame_batch=1, entropy_coder="cavlc", tile_cache=0)
    enc = TorchH264Encoder(w, h, channels=3, host_convert=False, device="cpu")
    for f in frames:
        assert enc.encode_frame(f) == jax_enc.encode_frame(f)


def test_construction_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchH264Encoder(W, H)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchH264Encoder(W, H, device="cuda")
    TorchH264Encoder(W, H, device="cpu")  # an explicit CPU request works


def test_bad_qp_and_frame_raise():
    enc = TorchH264Encoder(W, H, host_convert=False, device="cpu")
    with pytest.raises(ValueError):
        enc.set_qp(52)
    with pytest.raises(ValueError):
        enc.encode_frame(np.zeros((H, W, 3), np.uint8))

