"""Grouped dispatch (``frame_batch > 1``): TorchH264Encoder against
TPUH264Encoder at pipeline depth 0, where every completion is waited for
before submit returns. The frames each submit returns, their access units
(sha256), FrameStats.upload_kind, idr and qp, and the whole
LinkByteCounter snapshot must be equal after every submit. A group's upload
pads to the batch bucket ladder, so its ``up_delta`` bytes differ from
singles' and must equal the JAX encoder's."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from test_torch_encoder_host import _pin_env, host_trace  # noqa: F401

from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu_torch.models.h264 import encoder as enc_mod
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

W, H = 320, 192
BOOST = 6


def _jax_encoder(**kw):
    cfg = dict(host_convert=True, pipeline_depth=0, frame_batch=4, entropy_coder="cavlc",
               device_entropy=False, ltr_scenes=False, tile_cache=1024, packed_downlink=True,
               pack_density=75, scene_qp_boost=BOOST)
    cfg.update(kw)
    return TPUH264Encoder(W, H, **cfg)


def _port_encoder(**kw):
    cfg = dict(pipeline_depth=0, frame_batch=4, ltr_scenes=False)
    cfg.update(kw)
    return TorchH264Encoder(W, H, scene_qp_boost=BOOST, device="cpu", **cfg)


def typing_run(base, n, seed, row0=16):
    """n frames, each typing one more 16-row line of glyph noise into the
    previous one (a few dirty tiles: delta frames)."""
    rng = np.random.default_rng(seed)
    out = [base]
    for k in range(n):
        f = out[-1].copy()
        r = row0 + 16 * (k % 10)
        f[r:r + 16, 24 + 8 * k:200 + 8 * k, :3] = rng.integers(0, 255, (16, 176, 3), np.uint8)
        out.append(f)
    return out[1:]


def group_trace():
    """-> [(frame, op)]: an IDR, a full group of 4, a half group closed by
    a static frame, 3 deltas closed by a full frame (a half group and a
    single), a remap-only/scroll tail from host_trace, and one delta closed
    by a forced IDR."""
    ht = host_trace(seed=11)
    a = ht[0][0]
    t1 = typing_run(a, 4, 1)
    t2 = typing_run(t1[-1], 2, 2, row0=112)
    t3 = typing_run(t2[-1], 3, 3, row0=48)
    b = ht[3][0]
    t4 = typing_run(ht[8][0], 1, 4)
    frames = [(a, None)] + [(f, None) for f in t1 + t2] + [(t2[-1].copy(), None)]
    frames += [(f, None) for f in t3] + [(b, None)]
    frames += [(f, op) for f, op, *_ in ht[4:6]] + [(ht[8][0], None)]
    frames += [(t4[0], None), (t4[0].copy(), "idr"), (ht[9][0], None)]
    return frames


def _drive(enc, frames, qps=None, caps=None):
    """-> per submit: (completed frames [(sha256, upload_kind, idr, qp)],
    link-byte snapshot). ``caps`` maps a frame index to a set_batch_cap
    call made before that frame."""
    out = []
    for i, (frame, op) in enumerate(frames):
        if caps and i in caps:
            enc.set_batch_cap(caps[i])
        if op == "idr":
            enc.force_keyframe()
        done = enc.submit(frame, qp=(qps or {}).get(i))
        out.append(([(hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.qp)
                     for au, st, _ in done], enc.link_bytes.snapshot()))
    done = enc.flush()
    out.append(([(hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.qp)
                 for au, st, _ in done], enc.link_bytes.snapshot()))
    return out


@pytest.mark.parametrize("tile_cache", [1024, 0], ids=["tile_cache", "no_tile_cache"])
def test_grouping_matches_jax(tile_cache):
    frames = group_trace()
    qps = {2: 31, 3: 25, 6: 33}  # per-frame QPs inside the full and the half group
    jax_enc = _jax_encoder(tile_cache=tile_cache)
    want = _drive(jax_enc, frames, qps)
    jax_enc.close()
    enc = _port_encoder(tile_cache=tile_cache)
    got = _drive(enc, frames, qps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"submit {i}"
    assert [len(done) for done, _ in got[1:5]] == [0, 0, 0, 4]  # the group of 4 waits
    assert enc.group_sizes[4] >= 1 and enc.group_sizes[2] >= 2 and enc.group_sizes[1] >= 1
    assert {q for done, _ in got for *_, q in done} >= {31, 25, 33}
    assert sum(len(done) for done, _ in got) == len(frames)


def test_set_batch_cap_mid_stream_matches_jax():
    """Cap 2 while three deltas are pending (the cap flushes a group of 2
    at once), then cap 1 (every delta dispatches alone), then back to 4."""
    frames = group_trace()[:12]
    caps = {3: 2, 7: 1, 10: 4}
    jax_enc = _jax_encoder()
    want = _drive(jax_enc, frames, caps=caps)
    jax_enc.close()
    enc = _port_encoder()
    got = _drive(enc, frames, caps=caps)
    assert got == want
    assert enc._batch_cap == 4 and not enc.set_batch_cap(4) and enc.set_batch_cap(3)
    assert enc._batch_cap == 2  # snaps down to a group size in use


def test_failed_group_dispatch_drops_the_chain(monkeypatch):
    """The grouped step fails when a static frame flushes a half group: the
    pending frames never produce AUs and leave the in-flight queue, the
    reference, source planes, device pool and host tile cache drop
    together, and the next frame is a full-upload IDR."""
    frames = group_trace()
    enc = _port_encoder()
    for frame, _ in frames[:5]:  # IDR, then a group of 4 typing deltas
        enc.submit(frame)
    assert enc.group_sizes[4] == 1
    assert enc._pool_d is not None and enc._tcache._hash2slot

    def fail(*args, **kwargs):
        raise RuntimeError("grouped step failed")

    monkeypatch.setattr(enc_mod, "_p_scatter_multi_step2", fail)
    assert enc.submit(frames[5][0]) == [] and enc.submit(frames[6][0]) == []  # two pend
    assert len(enc._inflight) == 2
    with pytest.raises(RuntimeError, match="grouped step failed"):
        enc.submit(frames[7][0])  # static: the half group dispatches first
    assert enc._ref is None and enc._src is None and enc._pool_d is None
    assert not enc._tcache._hash2slot and not enc._inflight and not enc._batch_pend
    monkeypatch.undo()
    before = enc.link_bytes.snapshot()["up_full"]
    (_, st, _), = enc.submit(frames[8][0])
    assert st.idr and st.upload_kind == "full"
    assert enc.link_bytes.snapshot()["up_full"] > before
