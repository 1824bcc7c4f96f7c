"""The host-conversion slice as a whole: TorchH264Encoder against
TPUH264Encoder in the registry row's configuration (host conversion,
fused dirty scan, tile-delta uploads, the 1024-slot tile cache, the
bit-packed sparse downlink) on traces that produce every frame kind.
Access units must be sha256-equal, FrameStats.upload_kind equal and the
LinkByteCounter snapshots equal after every frame."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu_torch.models.h264 import native
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

W, H = 320, 192
BOOST = 6


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for k in ("SELKIES_TILE_CACHE", "SELKIES_PACK_DENSITY", "SELKIES_BANDS",
              "SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND",
              "SELKIES_DAMAGE_FULL_SCAN", "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY",
              "SELKIES_BITS_MIN_MBS", "SELKIES_SPARSE_NATIVE", "SELKIES_PACK_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    # one torch intra-op thread: the encoder issues many small CPU ops, and
    # under pytest-xdist several workers' OpenMP teams spin-wait against
    # each other for the same cores (the integer results do not change)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_encoder(w=W, h=H, **kw):
    cfg = dict(host_convert=True, pipeline_depth=0, frame_batch=1, entropy_coder="cavlc",
               device_entropy=False, ltr_scenes=False, tile_cache=1024, packed_downlink=True,
               pack_density=75, scene_qp_boost=BOOST)
    cfg.update(kw)
    return TPUH264Encoder(w, h, **cfg)


def _port_encoder(w=W, h=H, **kw):
    """The port at depth 0, ungrouped, LTR off: each submit returns its frame."""
    cfg = dict(frame_batch=1, pipeline_depth=0, ltr_scenes=False)
    cfg.update(kw)
    return TorchH264Encoder(w, h, scene_qp_boost=BOOST, device="cpu", **cfg)


def host_trace(w=W, h=H, seed=1):
    """-> [(frame, op, damage, expected kind)]. ``op`` "idr" forces a
    keyframe before the frame. The kinds, in order: IDR, static, delta
    with uploads (with a damage hint), scene cut (full P with the QP boost
    and pool seeding), a second over-budget full P (seeding), remap-only
    delta, forced IDR over a static frame (from the resident planes),
    forced IDR on a delta frame, a scroll (remaps + uploads), a cursor
    delta with a damage hint, and a static frame with an empty hint."""
    rng = np.random.default_rng(seed)
    a = np.kron(rng.integers(40, 200, (h // 16 + 1, w // 16 + 1, 4), np.uint8),
                np.ones((16, 16, 1), np.uint8))[:h, :w].copy()
    a[::4, ::3, :3] = rng.integers(0, 255, a[::4, ::3, :3].shape, np.uint8)
    b = rng.integers(0, 255, (h, w, 4), np.uint8)
    typed = a.copy()
    typed[40:56, 40:100, :3] = 255 - typed[40:56, 40:100, :3]
    patched = b.copy()
    patched[100:116, 0:64, :3] = 7
    scrolled = np.roll(patched, -16, 0)
    scrolled[-16:] = rng.integers(0, 255, (16, w, 4), np.uint8)
    cursor = scrolled.copy()
    cursor[60:70, 150:158, :3] = 250
    return [
        (a, None, None, "idr"),
        (a.copy(), None, None, "static"),
        (typed, None, [(40, 40, 60, 16)], "delta_upload"),
        (b, None, None, "scene_cut_seed"),
        (typed.copy(), None, None, "full_seed"),
        (b.copy(), None, None, "remap_only"),
        (b.copy(), "idr", None, "idr_resident"),
        (patched, "idr", None, "idr_delta"),
        (scrolled, None, None, "delta_mixed"),
        (cursor, None, [(150, 60, 8, 10), (0, 0, 1, 1)], "delta_upload"),
        (cursor.copy(), None, [], "static"),
    ]


def _drive(enc, trace, qps=None):
    """-> per frame (sha256, upload_kind, idr, qp, scene_cut, link-byte
    snapshot, remap_frac)."""
    out = []
    for i, (frame, op, damage, _) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        (au, st, _), = enc.submit(frame, qp=(qps or {}).get(i), damage=damage)
        out.append((hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.qp,
                    st.scene_cut, enc.link_bytes.snapshot(), st.remap_frac))
    return out


def _kind_of(prev_links, row):
    """The frame kind as the port's own counters show it."""
    _, upload_kind, idr, qp, scene_cut, links, remap = row
    grew = {k for k, v in links.items() if v != prev_links.get(k, 0)}
    if idr:
        if not grew & {"up_full", "up_delta"}:
            return "idr_resident"
        return "idr_delta" if "up_delta" in grew else "idr"
    if upload_kind == "static":
        return "static"
    if upload_kind == "full":
        assert "up_seed" in grew
        return "scene_cut_seed" if scene_cut and qp == 28 + BOOST else "full_seed"
    if remap == 1.0:
        return "remap_only"
    return "delta_upload" if remap == 0.0 else "delta_mixed"


def test_host_path_matches_jax_on_every_frame_kind():
    trace = host_trace()
    jax_enc = _jax_encoder()
    want = _drive(jax_enc, trace)
    jax_enc.close()
    packs, sparse = native.calls, native.sparse_calls
    got = _drive(_port_encoder(), trace)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i}"
    prev = {}
    kinds = []
    for row in got:
        kinds.append(_kind_of(prev, row))
        prev = row[5]
    assert kinds == [k for *_, k in trace]
    assert native.sparse_calls - sparse == sum(1 for k in kinds if k.startswith(("delta", "remap")))
    assert native.calls > packs


def test_padded_edge_geometry_matches_jax():
    """328x200: 16-column tiles, and the right and bottom edge tiles are not
    cacheable, so their uploads go to the pool's scratch row."""
    w, h = 328, 200
    trace = host_trace(w, h, seed=5)
    jax_enc = _jax_encoder(w, h)
    want = _drive(jax_enc, trace)
    jax_enc.close()
    enc = _port_encoder(w, h)
    got = _drive(enc, trace)
    assert got == want
    assert {r[1] for r in got} == {"full", "static", "delta"}
    assert 0.0 < got[5][6] < 1.0  # the edge tiles upload, the rest remap


def test_failed_step_drops_the_chain(monkeypatch):
    """A device step that fails mid-frame drops the reference, the source
    planes, the device pool and the host tile cache together and restores
    the QP; the next frame is a full-upload IDR."""
    from selkies_tpu_torch.models.h264 import encoder as enc_mod

    trace = host_trace(seed=6)
    enc = _port_encoder()
    for frame, *_ in trace[:5]:  # IDR, static, delta, two seeding full P frames
        enc.submit(frame)
    assert enc._pool_d is not None and enc._tcache._hash2slot

    def fail(*args, **kwargs):
        raise RuntimeError("device step failed")

    monkeypatch.setattr(enc_mod, "_p_scatter_step2", fail)
    with pytest.raises(RuntimeError, match="device step failed"):
        enc.submit(trace[5][0])  # a remap-only delta
    assert enc._ref is None and enc._src is None and enc._pool_d is None
    assert not enc._tcache._hash2slot and enc.qp == 28
    monkeypatch.undo()
    before = enc.link_bytes.snapshot()["up_full"]
    (_, st, _), = enc.submit(trace[2][0])
    assert st.idr and enc.link_bytes.snapshot()["up_full"] > before


def test_keyframe_interval_and_qp_change_match_jax():
    trace = host_trace(seed=2)[:8]
    qps = {2: 33, 5: 24}
    jax_enc = _jax_encoder(keyframe_interval=4)
    want = _drive(jax_enc, trace, qps)
    jax_enc.close()
    got = _drive(_port_encoder(keyframe_interval=4), trace, qps)
    assert got == want
    assert [r[2] for r in got] == [True, False, False, False, True, False, True, True]


@pytest.mark.parametrize("layout", [{"tile_cache": 0}, {"packed_downlink": False}],
                         ids=["no_tile_cache", "var_downlink"])
def test_other_delta_layouts_match_jax(layout):
    trace = host_trace(seed=3)[:6] + host_trace(seed=3)[8:10]
    jax_enc = _jax_encoder(**layout)
    want = _drive(jax_enc, trace)
    jax_enc.close()
    got = _drive(_port_encoder(**layout), trace)
    assert got == want
    assert "delta" in {r[1] for r in got}


def _jax_state(j) -> dict:
    tc = j._tcache
    return {
        "ref": [np.asarray(p) for p in j._ref], "frame_index": j.frame_index,
        "frames_since_idr": j._frames_since_idr, "idr_pic_id": j._idr_pic_id,
        "qp": j.qp, "pic_init_qp": j.params.qp,
        "src": [np.asarray(p) for p in j._src],
        "pool": None if j._pool_d is None else [np.asarray(p) for p in j._pool_d],
        "prep_prev": j._prep._prev, "scan_count": j._prep._scan_count,
        "prev_kind": j._prev_kind, "full_run": j._full_run,
        "pfx_hint": j._pfx_hint, "pfx_recent": list(j._pfx_recent),
        "tile_cache": None if tc is None else {
            "hash2slot": tc._hash2slot, "slot_hash": tc._slot_hash, "free": tc._free,
            "stamp": tc._stamp, "clock": tc._clock, "store": tc._store, "hits": tc.hits,
            "misses": tc.misses, "evictions": tc.evictions},
    }


def test_load_jax_state_continues_a_host_stream():
    """The port takes over a JAX stream after the pool was seeded and
    continues byte for byte: remap-only delta, resident IDR, delta IDR,
    scroll and cursor deltas."""
    trace = host_trace(seed=4)
    jax_enc = _jax_encoder(qp=30)
    _drive(jax_enc, trace[:5])
    enc = _port_encoder()  # default qp 28: the state sets 30
    enc.load_jax_state(_jax_state(jax_enc))
    base_j, base_t = jax_enc.link_bytes.snapshot(), enc.link_bytes.snapshot()
    want = _drive(jax_enc, trace[5:])
    jax_enc.close()
    got = _drive(enc, trace[5:])

    def strip(rows, base):
        return [(*r[:5], {k: v - base.get(k, 0) for k, v in r[5].items()
                          if v != base.get(k, 0)}, r[6]) for r in rows]

    assert strip(got, base_t) == strip(want, base_j)
    assert [r[1] for r in got][0] == "delta" and got[0][6] == 1.0


@pytest.mark.parametrize("knobs,env", [
    ({"device_entropy": True}, {}),
    ({"entropy_coder": "cabac"}, {}),
    ({"device_entropy": True, "bits_min_mbs": 64, "entropy_coder": "cabac"}, {}),
    ({}, {"SELKIES_DEVICE_ENTROPY": "1", "SELKIES_BITS_MIN_MBS": "64"}),
    ({}, {"SELKIES_ENTROPY_CODER": "cabac", "SELKIES_BITS_MIN_MBS": "junk"}),
    ({}, {"SELKIES_ENTROPY_CODER": "auto", "SELKIES_DEVICE_ENTROPY": "0"}),
    ({"device_entropy": False, "entropy_coder": "cavlc"},
     {"SELKIES_DEVICE_ENTROPY": "1", "SELKIES_ENTROPY_CODER": "cabac"}),
    ({"host_convert": False, "device_entropy": True, "entropy_coder": "cabac"}, {}),
], ids=["device_entropy", "cabac", "cabac_device", "env_device", "env_cabac", "env_auto",
        "explicit_wins", "device_conversion"])
def test_entropy_knobs_resolve_as_jax(monkeypatch, knobs, env):
    """device_entropy and entropy_coder, as arguments or env values,
    resolve as the JAX encoder's (AUTO as on its CPU backend): the same
    device_entropy, bits_min_mbs, coder, profile, downlink consts and
    SPS/PPS bytes."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = TPUH264Encoder(W, H, **knobs)
    t = TorchH264Encoder(W, H, device="cpu", **knobs)
    got = (t.device_entropy, t.bits_min_mbs, t.entropy_coder, t.h264_profile, t._entropy,
           t._pfx_total, t._headers)
    want = (j.device_entropy, j.bits_min_mbs, j.entropy_coder, j.h264_profile, j._entropy,
            j._pfx_total, j._headers)
    j.close()
    t.close()
    assert got == want


def test_env_defaults_match_jax(monkeypatch):
    monkeypatch.setenv("SELKIES_TILE_CACHE", "0")
    monkeypatch.setenv("SELKIES_PACK_DENSITY", "40")
    enc = TorchH264Encoder(W, H, device="cpu")
    assert enc._tcache is None and enc._density == 40
    monkeypatch.setenv("SELKIES_PACK_DENSITY", "0")
    enc = TorchH264Encoder(W, H, device="cpu", tile_cache=16)
    assert enc.tile_cache_slots == 16 and enc._density is None
    assert TorchH264Encoder(W, H, device="cpu", pack_density=60)._density is None


def test_forced_idr_on_a_scene_cut_matches_jax():
    """A keyframe forced on a full-frame change after a delta: the QP is
    boosted, and FrameStats.scene_cut is False on the IDR, as in the JAX
    encoder (only P frames carry the scene-cut flag)."""
    trace = host_trace(seed=8)
    trace = trace[:3] + [(trace[3][0], "idr", None, "")] + trace[4:6]
    jax_enc = _jax_encoder()
    want = _drive(jax_enc, trace)
    jax_enc.close()
    got = _drive(_port_encoder(), trace)
    assert got == want
    assert got[3][2] and got[3][3] == 28 + BOOST and not got[3][4]
