"""The entropy plane of the whole encoder: TorchH264Encoder against
TPUH264Encoder with device CAVLC, the host CABAC coder and the device CABAC
tokenizer, on the flat host path (every frame kind, depth 0), the
registry row (groups, depth 2, LTR restores) and, for CABAC, the
device-conversion path; then the overflow, spill and short-hint paths,
retune_entropy and load_jax_state under CABAC.

Access units must be sha256-equal; at depth 0 FrameStats.downlink_mode and
every link-byte counter are equal too, at depth 2 the up_* counters
(the down_* ones follow the workers' fetch-hint updates in both)."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from test_torch_encoder_host import _jax_state, _pin_env, host_trace  # noqa: F401
from test_torch_pipeline import REGISTRY, registry_trace
from test_torch_pipeline import _drive as drive_collected

from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu_torch.models.h264 import encoder as enc_mod
from selkies_tpu_torch.models.h264 import native
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

W, H = 320, 192
BOOST = 6
# bits_min_mbs 4 of 240 MBs: the busy deltas of the traces ship coded slices
CONFIGS = {
    "cavlc_device": dict(device_entropy=True, bits_min_mbs=4, entropy_coder="cavlc"),
    "cabac_host": dict(device_entropy=False, entropy_coder="cabac"),
    "cabac_device": dict(device_entropy=True, bits_min_mbs=4, entropy_coder="cabac"),
}
FLAT = dict(pipeline_depth=0, frame_batch=1, ltr_scenes=False)


def _jax(w=W, h=H, **kw):
    cfg = dict(REGISTRY, **FLAT)
    cfg.update(kw)
    return TPUH264Encoder(w, h, **cfg)


def _port(w=W, h=H, **kw):
    cfg = dict(FLAT, scene_qp_boost=BOOST)
    cfg.update(kw)
    return TorchH264Encoder(w, h, device="cpu", **cfg)


def _drive(enc, trace, ops=None):
    """Depth 0 -> per frame (sha256, upload_kind, idr, downlink_mode,
    link-byte snapshot). ``ops`` maps a frame index to a call made on the
    encoder before that frame."""
    out = []
    for i, (frame, op, damage, *_) in enumerate(trace):
        if ops and i in ops:
            ops[i](enc)
        if op == "idr":
            enc.force_keyframe()
        (au, st, _), = enc.submit(frame, damage=damage)
        out.append((hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.downlink_mode,
                    enc.link_bytes.snapshot()))
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_flat_host_path_matches_jax(config):
    trace = host_trace(seed=3)
    jax_enc = _jax(**CONFIGS[config])
    want = _drive(jax_enc, trace)
    jax_enc.close()
    calls = native.cabac_calls
    enc = _port(**CONFIGS[config])
    got = _drive(enc, trace)
    enc.close()
    assert got == want
    modes = [r[3] for r in got]
    coded = {"cavlc_device": "bits", "cabac_device": "cabac"}.get(config)
    if coded:
        assert coded in modes and "coeff" in modes
    else:
        assert set(modes) == {"", "coeff"}
    assert (native.cabac_calls > calls) == config.startswith("cabac")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_registry_row_matches_jax(config):
    frames = registry_trace(seed=27)
    jax_enc = TPUH264Encoder(W, H, **dict(REGISTRY, **CONFIGS[config]))
    want = drive_collected(jax_enc, frames)
    restores = jax_enc.ltr_restores
    jax_enc.close()
    enc = TorchH264Encoder(W, H, scene_qp_boost=BOOST, device="cpu", **CONFIGS[config])
    got = drive_collected(enc, frames)
    enc.close()
    assert got == want
    assert len(got[0]) == len(frames)
    assert enc.ltr_restores == restores >= 2 and enc.group_sizes[4] >= 1


def test_device_conversion_cabac_matches_jax():
    """host_convert=False keeps CABAC and forces device entropy off."""
    from test_torch_encoder import _drive as drive_sync
    from test_torch_encoder import _trace

    frames = _trace(seed=5)
    jax_enc = TPUH264Encoder(W, H, host_convert=False, pipeline_depth=0, frame_batch=1,
                             entropy_coder="cabac", device_entropy=True, tile_cache=0)
    want = drive_sync(jax_enc, frames)
    jax_enc.close()
    enc = TorchH264Encoder(W, H, host_convert=False, pipeline_depth=0, frame_batch=1,
                           entropy_coder="cabac", device_entropy=True, device="cpu")
    assert not enc.device_entropy and enc.h264_profile == "main"
    got = drive_sync(enc, frames)
    assert enc.retune_entropy(entropy_coder="cavlc") is False
    enc.close()
    assert got == want


def _noise_frames(n=3, w=96, h=64, seed=41):
    rng = np.random.default_rng(seed)
    return [(np.ascontiguousarray(rng.integers(0, 255, (h, w, 4), np.uint8)), None, None)
            for _ in range(n)]


@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
def test_full_p_spill_and_overflow_fallbacks(monkeypatch, coder):
    """A full P frame's coded slice past the prefix spill-fetches the rest;
    past the word cap it falls back to the dense coefficients (tiny caps
    force both). The bytes equal the host-coded stream."""
    frames = _noise_frames()
    jax_enc = _jax(96, 64, entropy_coder=coder, device_entropy=False, qp=22)
    want = [r[0] for r in _drive(jax_enc, frames)]
    jax_enc.close()
    mode = "bits" if coder == "cavlc" else "cabac"
    monkeypatch.setattr(enc_mod, "BITS_PREFIX_WORDS", 8)
    monkeypatch.setattr(enc_mod, "TOK_PREFIX_WORDS", 8)
    enc = _port(96, 64, entropy_coder=coder, device_entropy=True, qp=22)
    got = _drive(enc, frames)
    assert [r[0] for r in got] == want
    assert [r[3] for r in got] == ["", mode, mode]
    assert got[-1][4]["down_bits_spill"] > 0
    monkeypatch.setattr(enc_mod, "BITS_WORD_CAP", 64)
    monkeypatch.setattr(enc_mod, "TOK_WORD_CAP", 64)
    enc = _port(96, 64, entropy_coder=coder, device_entropy=True, qp=22)
    got = _drive(enc, frames)
    assert [r[0] for r in got] == want
    assert [r[3] for r in got] == ["", "dense", "dense"]


@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
def test_delta_word_cap_overflow_ships_coefficients(coder):
    """A busy delta whose coded slice overflows its word cap ships its
    sparse coefficients instead (decided on the device); same bytes."""
    trace = host_trace(seed=5)
    jax_enc = _jax(entropy_coder=coder, device_entropy=False)
    want = [r[0] for r in _drive(jax_enc, trace)]
    jax_enc.close()
    coded = "bits" if coder == "cavlc" else "cabac"
    modes = []
    for cap in (None, 8):
        enc = _port(entropy_coder=coder, device_entropy=True, bits_min_mbs=0)
        if cap:
            words, min_mbs, buckets, c = enc._entropy
            enc._entropy, enc._bits_words = (cap, min_mbs, buckets, c), cap
            enc._size_downlink()
        got = _drive(enc, trace)
        enc.close()
        assert [r[0] for r in got] == want
        modes.append([r[3] for r in got])
    # a slice that fits 8 words may still ship coded; the others fall back
    fell_back = [a == coded and b == "coeff" for a, b in zip(*modes)]
    assert any(fell_back) and set(modes[1]) <= {"", "coeff", coded}


@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
def test_short_hint_refetches_the_coded_slice(monkeypatch, coder):
    """A fetch hint shorter than a busy delta's coded slice refetches the
    whole buffer (down_bits_refetch); the bytes do not change."""
    trace = host_trace(seed=6)
    jax_enc = _jax(entropy_coder=coder, device_entropy=False)
    want = [r[0] for r in _drive(jax_enc, trace)]
    jax_enc.close()
    # the hint stays at 64 int16 words (both metas fit): every delta falls short
    monkeypatch.setattr(TorchH264Encoder, "_update_pfx_hint", lambda self: None)
    enc = _port(entropy_coder=coder, device_entropy=True, bits_min_mbs=4)
    enc._pfx_hint = 64
    got = _drive(enc, trace)
    enc.close()
    assert [r[0] for r in got] == want
    assert got[-1][4]["down_bits_refetch"] > 0


def test_retune_entropy_mid_stream_matches_jax():
    """Switch the coder both ways and device entropy on and off mid-stream
    on both encoders: the same True/False answers, forced IDRs with new
    SPS/PPS on a coder switch, and equal bytes throughout."""
    trace = host_trace(seed=7) + host_trace(seed=8)[1:]
    answers = {"jax": [], "port": []}

    def ops(name):
        def call(**kw):
            return lambda e: answers[name].append(e.retune_entropy(**kw))

        # a knob left None re-resolves to its default, as in the JAX encoder
        return {2: call(entropy_coder="cabac"),
                4: call(entropy_coder="cabac"),  # no change
                5: call(device_entropy=True, bits_min_mbs=4),
                9: call(device_entropy=True, bits_min_mbs=8),
                11: call(entropy_coder="cavlc"),  # device entropy back to its default
                13: call(device_entropy=True, bits_min_mbs=4),
                15: call(bits_min_mbs=16),  # device entropy off again
                17: call(bits_min_mbs=16)}  # threshold only, device coder off

    jax_enc = _jax(entropy_coder="cavlc", device_entropy=False)
    want = _drive(jax_enc, trace, ops("jax"))
    jax_enc.close()
    enc = _port(entropy_coder="cavlc", device_entropy=False)
    got = _drive(enc, trace, ops("port"))
    assert [r[:4] for r in got] == [r[:4] for r in want]
    assert answers["port"] == answers["jax"]
    assert answers["port"][:2] == [True, False]
    assert got[2][2] and got[11][2]  # the coder switches forced IDRs
    assert "cabac" in {r[3] for r in got[5:11]} and "bits" in {r[3] for r in got[13:15]}
    assert enc.entropy_coder == "cavlc" and not enc.device_entropy
    enc.close()


def test_retune_entropy_refused_with_frames_in_flight():
    frames = registry_trace(seed=9)
    enc = TorchH264Encoder(W, H, scene_qp_boost=BOOST, device="cpu")
    enc.submit(frames[0][0])
    enc.flush()
    enc.submit(frames[2][0])  # a delta parked in the group accumulator
    assert enc._batch_pend
    for kw in ({"entropy_coder": "cabac"}, {"device_entropy": True}):
        with pytest.raises(RuntimeError, match="flight"):
            enc.retune_entropy(**kw)
    assert enc.retune_entropy(bits_min_mbs=8)  # device coder off: nothing to resize
    enc.flush()
    assert enc.retune_entropy(entropy_coder="cabac", device_entropy=True)
    assert enc._pfx_total > enc._pfx_hint and enc._entropy[3] == "cabac"
    enc.close()


def test_load_jax_state_continues_a_cabac_stream():
    trace = host_trace(seed=4)
    jax_enc = _jax(qp=30, entropy_coder="cabac", device_entropy=True, bits_min_mbs=4)
    _drive(jax_enc, trace[:5])
    enc = _port(entropy_coder="cabac", device_entropy=True, bits_min_mbs=4)
    enc.load_jax_state(_jax_state(jax_enc))
    want = _drive(jax_enc, trace[5:])
    jax_enc.close()
    got = _drive(enc, trace[5:])
    enc.close()
    assert [r[:4] for r in got] == [r[:4] for r in want]
    assert "cabac" in {r[3] for r in got}
