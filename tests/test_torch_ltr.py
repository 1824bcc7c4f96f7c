"""The LTR scene cache (``ltr_scenes=True``): a switch back to a remembered
window is coded as a small delta against a long-term reference (MMCO 3
marking, ref-list modification, MMCO 1 evictions). TorchH264Encoder
against TPUH264Encoder on tests/test_h264_ltr.py's traces at pipeline
depth 0: the frames each submit returns (access units by sha256,
upload_kind, idr, qp), ``ltr_restores`` and the link-byte snapshot must be
equal after every submit."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from test_torch_encoder_host import _jax_state, _pin_env  # noqa: F401

from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

W, H = 320, 192


def _jax_encoder(**kw):
    cfg = dict(host_convert=True, pipeline_depth=0, frame_batch=1, entropy_coder="cavlc",
               device_entropy=False, ltr_scenes=True, tile_cache=1024, packed_downlink=True,
               pack_density=75, scene_qp_boost=6)
    cfg.update(kw)
    return TPUH264Encoder(W, H, **cfg)


def _port_encoder(**kw):
    cfg = dict(pipeline_depth=0, frame_batch=1)
    cfg.update(kw)
    return TorchH264Encoder(W, H, scene_qp_boost=6, device="cpu", **cfg)


def _scene(seed):
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(40, 200, (H // 16, W // 16, 4), np.uint8),
                   np.ones((16, 16, 1), np.uint8))


def _type_line(frame, rng, row=64):
    f = frame.copy()
    f[row:row + 16, 40:280, :3] = rng.integers(0, 255, (16, 240, 1), np.uint8)
    return f


def ltr_trace():
    """-> [(frame, op)]: test_h264_ltr.py's flip trace (A IDR, typing, cut
    to B, typing, restore A, typing, restore B, static B), a forced IDR on
    A that clears the slots (B after it must not restore), the marking on a
    static slice (A static, cut to B, B static twice, restore A), and
    restores to identical captures (B, A, B)."""
    rng = np.random.default_rng(7)
    a, b = _scene(1), _scene(2)
    a1 = _type_line(a, rng)
    a2 = _type_line(a1, rng)
    b1 = _type_line(b, rng)
    flip = [a, a1, a2, b, b1, a2, _type_line(a2, rng), b1, b1]
    frames = [(f, None) for f in flip]
    frames += [(a, "idr"), (b, None)]
    frames += [(a, "idr"), (a.copy(), None), (b, None), (b.copy(), None), (b.copy(), None),
               (a, None)]
    frames += [(b, None), (a, None), (b, None)]
    return frames


def _drive(enc, frames):
    """-> per submit: (completed [(sha256, upload_kind, idr, qp)],
    ltr_restores, link-byte snapshot)."""
    out = []

    def row(done):
        return ([(hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.qp)
                 for au, st, _ in done], enc.ltr_restores, enc.link_bytes.snapshot())

    for frame, op in frames:
        if op == "idr":
            enc.force_keyframe()
        out.append(row(enc.submit(frame)))
    out.append(row(enc.flush()))
    return out


@pytest.mark.parametrize("tile_cache,frame_batch", [(1024, 1), (1024, 4), (0, 1), (0, 4)],
                         ids=["tc-b1", "tc-b4", "notc-b1", "notc-b4"])
def test_ltr_traces_match_jax(tile_cache, frame_batch):
    frames = ltr_trace()
    jax_enc = _jax_encoder(tile_cache=tile_cache, frame_batch=frame_batch)
    want = _drive(jax_enc, frames)
    jax_enc.close()
    enc = _port_encoder(tile_cache=tile_cache, frame_batch=frame_batch)
    got = _drive(enc, frames)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"submit {i}"
    restores = [r for _, r, _ in got]
    # the flip trace restores A (frame 5) and B (frame 7); B after the
    # forced IDR at 9 does not restore; A at 16 does, after the marking
    # rode a static slice; of B, A, B at 17-19 at least one restores (with
    # the tile cache the others can be remap deltas)
    assert restores[5] - restores[4] == 1 and restores[7] - restores[6] == 1
    assert restores[10] == restores[9]
    assert restores[16] - restores[15] == 1 and restores[-1] > restores[16]


def two_restores_trace():
    """-> [(frame, op)]: A (IDR), A typed, cut to B, two typed lines on B
    (the resident source planes are written in place), X = A with its top
    two bands new (restores slot 0), Y = A with bands 6-7 new: Y differs
    from X over budget, so it restores slot 0 again from the same stash
    (X's candidate commits only with Y's slice), then B's first typed line
    (restores slot 1) and a static repeat."""
    rng = np.random.default_rng(3)
    a, b = _scene(4), _scene(5)
    a1 = _type_line(a, rng)
    b1 = _type_line(b, rng, row=16)
    b2 = _type_line(b1, rng, row=144)
    x, y = a.copy(), a.copy()
    x[0:32, :, :3] = rng.integers(0, 255, (32, W, 3), np.uint8)
    y[96:128, :, :3] = rng.integers(0, 255, (32, W, 3), np.uint8)
    return [(a, None), (a1, None), (b, None), (b1, None), (b2, None), (x, None), (y, None),
            (b1, None), (b1.copy(), None)]


@pytest.mark.parametrize("tile_cache", [1024, 0], ids=["tile_cache", "no_tile_cache"])
def test_two_restores_of_one_slot_are_exact(tile_cache):
    """A restore must leave its stash unchanged (it scatters into a clone
    of the stash's planes), and a stash must not alias the resident planes
    that later deltas write in place (_stash_candidate clones): otherwise
    the second restore of slot 0, or the restore of slot 1 after B's typed
    lines, codes the wrong source."""
    frames = two_restores_trace()
    jax_enc = _jax_encoder(tile_cache=tile_cache)
    want = _drive(jax_enc, frames)
    jax_enc.close()
    enc = _port_encoder(tile_cache=tile_cache)
    got = _drive(enc, frames)
    assert got == want
    assert [r for _, r, _ in got][4:8] == [0, 1, 2, 3]
    assert [done[0][1] for done, _, _ in got[5:8]] == ["delta"] * 3


def _jax_ltr_state(j) -> dict:
    def scene(s):
        if s is None:
            return None
        out = {"src": [np.asarray(p) for p in s["src"]],
               "ref": [np.asarray(p) for p in s["ref"]], "cap": s["cap"]}
        if "slot" in s:
            out["slot"] = s["slot"]
        return out

    return {**_jax_state(j), "ltr_slots": [scene(s) for s in j._ltr_slots],
            "ltr_candidate": scene(j._ltr_candidate), "ltr_mru": j._ltr_mru,
            "dpb_st": list(j._dpb_st), "ltr_restores": j.ltr_restores}


def test_load_jax_state_continues_through_a_restore():
    """The port takes over a JAX stream in the registry configuration after
    the JAX encoder stashed both scenes, and continues byte for byte
    through restores of both slots."""
    frames = two_restores_trace()
    cfg = dict(pipeline_depth=2, frame_batch=4)
    jax_enc = _jax_encoder(**cfg)
    for frame, _ in frames[:5]:
        jax_enc.submit(frame)
    jax_enc.flush()
    enc = TorchH264Encoder(W, H, scene_qp_boost=6, device="cpu")
    enc.submit(frames[0][0])
    enc.submit(frames[1][0])  # a delta: it waits for its group
    with pytest.raises(RuntimeError, match="in flight"):
        enc.load_jax_state(_jax_ltr_state(jax_enc))
    enc.flush()
    enc.load_jax_state(_jax_ltr_state(jax_enc))
    assert all(s is not None for s in enc._ltr_slots)
    base_j, base_t = jax_enc.link_bytes.snapshot(), enc.link_bytes.snapshot()
    rest = frames[5:] + [(frames[4][0], None)]
    want = _drive(jax_enc, rest)
    jax_enc.close()
    got = _drive(enc, rest)

    def strip(rows, base):
        seq = [f for done, _, _ in rows for f in done]
        ups = {k: v - base.get(k, 0) for k, v in rows[-1][2].items()
               if k.startswith("up_") and v != base.get(k, 0)}
        return seq, rows[-1][1], ups

    assert strip(got, base_t) == strip(want, base_j)
    assert enc.ltr_restores == 3  # X and Y from slot 0, B1 from slot 1: the loaded stashes
