"""Pipelined submit (``pipeline_depth > 0``) and the registry row's whole
configuration: TorchH264Encoder against TPUH264Encoder on the same frames.

Completions arrive from worker threads, so how many frames one submit
returns depends on timing; the sequence of frames collected across every
submit and the final flush must be equal (access units by sha256,
upload_kind, idr, qp), and so must the ``up_*`` link-byte counters after
every submit (uploads happen on the submit thread). The ``down_*``
counters are not compared: in both packages they depend on when the
workers update the delta downlink's fetch hint."""

from __future__ import annotations

import hashlib

import pytest
from test_torch_encoder_host import _pin_env, host_trace  # noqa: F401
from test_torch_group import typing_run

from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu_torch.models.h264 import encoder as enc_mod
from selkies_tpu_torch.models.h264 import native
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

BOOST = 6
# the registry row's configuration of the JAX encoder (the port's defaults)
REGISTRY = dict(host_convert=True, pipeline_depth=2, frame_batch=4, ltr_scenes=True,
                entropy_coder="cavlc", device_entropy=False, tile_cache=1024,
                packed_downlink=True, pack_density=75, scene_qp_boost=BOOST)


def registry_trace(w=320, h=192, seed=21):
    """host_trace's every kind, then a typing run (groups), a switch to the
    other window and a typed line there, switches back to both (LTR
    restores), and a static frame."""
    ht = host_trace(w, h, seed=seed)
    a, b = ht[0][0], ht[3][0]
    t = typing_run(a, 6, seed + 1)
    b1 = typing_run(b, 1, seed + 2, row0=96)[0]
    frames = [(f, op) for f, op, *_ in ht] + [(a, None)] + [(f, None) for f in t]
    frames += [(b, None), (b1, None), (t[-1], None), (b1, None), (b1.copy(), None)]
    return frames


def _drive(enc, frames):
    """-> (completed frames [(sha256, upload_kind, idr, qp)] in order, the
    up_* counters after every submit)."""
    done, ups = [], []

    def take(outs):
        done.extend((hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.qp)
                    for au, st, _ in outs)

    for frame, op in frames:
        if op == "idr":
            enc.force_keyframe()
        take(enc.submit(frame))
        ups.append({k: v for k, v in enc.link_bytes.snapshot().items() if k.startswith("up_")})
    take(enc.flush())
    return done, ups


@pytest.mark.parametrize("frame_batch", [1, 4])
def test_pipelined_matches_jax(frame_batch):
    frames = registry_trace(seed=31)
    cfg = dict(REGISTRY, frame_batch=frame_batch, ltr_scenes=False)
    jax_enc = TPUH264Encoder(320, 192, **cfg)
    want = _drive(jax_enc, frames)
    jax_enc.close()
    enc = TorchH264Encoder(320, 192, scene_qp_boost=BOOST, frame_batch=frame_batch,
                           ltr_scenes=False, device="cpu")
    got = _drive(enc, frames)
    enc.close()
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[0]) == len(frames)
    assert bool(enc.group_sizes) == (frame_batch > 1)


@pytest.mark.parametrize("size", [(320, 192), (328, 200)], ids=["320x192", "328x200"])
def test_registry_configuration_matches_jax(size):
    """The port with no arguments but the boost is the registry row:
    grouped, pipelined, LTR on, tile cache, bit-packed sparse downlink."""
    w, h = size
    frames = registry_trace(w, h)
    jax_enc = TPUH264Encoder(w, h, **REGISTRY)
    want = _drive(jax_enc, frames)
    jax_restores = jax_enc.ltr_restores
    jax_enc.close()
    sparse = native.sparse_calls
    enc = TorchH264Encoder(w, h, scene_qp_boost=BOOST, device="cpu")
    got = _drive(enc, frames)
    enc.close()
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert enc.ltr_restores == jax_restores >= 2
    assert enc.group_sizes[4] >= 1
    assert {k for _, k, _, _ in got[0]} == {"full", "static", "delta"}
    assert sum(idr for _, _, idr, _ in got[0]) == 3
    assert native.sparse_calls > sparse


def test_failed_worker_drops_the_chain(monkeypatch):
    """A completion worker fails: the error re-raises from submit or flush,
    the reference, source planes, in-flight queue, pending group and tile
    cache are all dropped, and the next frame is a full-upload IDR."""
    frames = registry_trace(seed=41)
    enc = TorchH264Encoder(320, 192, scene_qp_boost=BOOST, device="cpu")
    for frame, op in frames[:3]:  # IDR, static, delta
        enc.submit(frame)
    enc.flush()

    def fail(*args, **kwargs):
        raise RuntimeError("pack failed")

    monkeypatch.setattr(enc_mod, "complete_sparse_slice", fail)
    with pytest.raises(RuntimeError, match="pack failed"):
        for frame, _ in frames[12:19]:  # the typing run
            enc.submit(frame)
        enc.flush()
    assert enc._ref is None and enc._src is None and enc._pool_d is None
    assert not enc._inflight and not enc._batch_pend and not enc._tcache._hash2slot
    monkeypatch.undo()
    before = enc.link_bytes.snapshot()["up_full"]
    outs = enc.submit(frames[19][0]) + enc.flush()
    assert len(outs) == 1 and outs[0][1].idr and outs[0][1].upload_kind == "full"
    assert enc.link_bytes.snapshot()["up_full"] > before
    enc.close()


def test_encode_frame_with_frames_in_flight_raises():
    frames = registry_trace(seed=51)
    enc = TorchH264Encoder(320, 192, device="cpu")
    outs = enc.submit(frames[0][0])
    outs += enc.submit(frames[2][0])  # a delta: it waits for its group
    with pytest.raises(RuntimeError, match="in flight"):
        enc.encode_frame(frames[2][0])
    assert len(outs + enc.flush()) == 2
    assert enc.encode_frame(frames[1][0]).startswith(b"\x00\x00\x00\x01")
    enc.close()
