"""Port tests that need a CUDA card (``gpu`` marker).

Each test decides inside itself whether a card exists and skips without
one. This file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from selkies_tpu_torch.models.h264 import encoder as enc_mod
from selkies_tpu_torch.models.h264 import encoder_core as core
from selkies_tpu_torch.models.h264 import me_mc, native
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.models.h264.numpy_ref import MV_PAD

W, H = 320, 192


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ME/MC kernel has no CPU mode")


def _planes(h, w, seed, motion, noise):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 255, (h, w), np.int32)
    ref = np.roll(cur, motion, (0, 1)).astype(np.int64)
    if noise:
        ref = ref + rng.integers(-noise, noise + 1, ref.shape)
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    cu = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
    cv = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
    return cur, ref, cu, cv


def _rand_cands(rng, n):
    """n seeded candidates within +-MV_PAD; the first four have dx = 0..3 mod 4."""
    c = rng.integers(-MV_PAD, MV_PAD + 1, (n, 2)).astype(np.int32)
    c[:4, 0] = [-40, 13, -2, 39][:n]
    return torch.from_numpy(c)


# name -> (h, w, seed, motion, noise, candidate list)
_CASES = {
    "320x192-static": (H, W, 0, (0, 0), 0, "hier"),
    "320x192-motion": (H, W, 1, (12, -20), 0, "hier"),
    "320x192-near-reach-noise": (H, W, 2, (-31, 30), 25, "hier"),
    # ragged strips of 8 MBs: 21 MB columns, one MB, and the 1080p width
    "336x208-ragged": (208, 336, 3, (5, -7), 4, "hier"),
    "16x16-one-mb": (16, 16, 4, (1, 2), 0, "hier"),
    "1920x1088": (1088, 1920, 5, (-24, 29), 6, "hier"),
    # the clamped lists a band (rows) and a tile (rows and columns) search
    "336x208-band-clamped": (208, 336, 6, (-30, 9), 3, "band"),
    "336x208-tile-clamped": (208, 336, 7, (21, -33), 3, "tile"),
    # candidate counts around a warp's 32 lanes and the 256-entry chunk
    "count-1": (208, 336, 8, (0, 0), 5, 1),
    "count-77": (208, 336, 9, (3, 3), 5, 77),
    "count-300": (208, 336, 10, (-9, 14), 20, 300),
    "count-600": (64, 96, 11, (2, -1), 40, 600),
    # cur and ry off 16-byte alignment: the kernel's byte- and int-load path
    "336x208-unaligned": (208, 336, 12, (-6, 11), 8, "unaligned"),
    # constant planes: every candidate has SAD 0 and the first must win in
    # every MB, across lanes and staged chunks, before a later duplicate
    "tie-3": (48, 336, 13, (0, 0), 0, "tie"),
    "tie-300": (48, 336, 14, (0, 0), 0, "tie"),
}


def _unaligned(t):
    """A contiguous copy of t whose data starts one element past an
    allocation's (16-byte aligned) start."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


def _case_inputs(name, dev):
    h, w, seed, motion, noise, kind = _CASES[name]
    cur, ref, cu, cv = (torch.from_numpy(a).to(dev) for a in _planes(h, w, seed, motion, noise))
    pads = [core.edge_pad(p, MV_PAD) for p in (ref, cu, cv)]
    rng = np.random.default_rng(seed)
    if kind == "hier":
        cands = core.hier_candidates(cur, ref)
    elif kind == "unaligned":
        cands = core.hier_candidates(cur, ref)
        cur, pads[0] = _unaligned(cur), _unaligned(pads[0])
    elif kind in ("band", "tile"):
        coarse = core.coarse_vote_candidates(cur, ref)
        clamp = {"dy_max": 16} if kind == "band" else {"dy_max": 24, "dx_max": 12}
        cands = core._refine_cands(coarse, **clamp)
    elif kind == "tie":
        cur = torch.full_like(cur, 9)
        pads = [torch.full_like(p, 9) for p in pads]
        cands = _rand_cands(rng, int(name.split("-")[1]))
        cands[-1] = cands[0]
    elif kind == 1:
        cands = torch.zeros((1, 2), dtype=torch.int32)
    elif kind == 77:  # the hierarchical list, then the true motion
        cands = torch.cat([core.hier_candidates(cur, ref).cpu(),
                           torch.tensor([[motion[1], motion[0]]], dtype=torch.int32)])
    else:
        cands = _rand_cands(rng, kind)
        cands[5] = torch.tensor([motion[1], motion[0]], dtype=torch.int32)
    return cands.to(dev), cur, *pads


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_CASES))
def test_kernel_matches_plain_on_card(case):
    _need_card()
    args = _case_inputs(case, torch.device("cuda"))
    before = me_mc.launches
    got = me_mc.me_mc(*args)
    want = me_mc.me_mc_plain(*args)
    torch.cuda.synchronize()
    assert me_mc.launches == before + 1
    for name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
        assert torch.equal(a, b), name
    if _CASES[case][-1] == "tie":
        assert (got[0] == args[0][0]).all()


_TRAP_SCRIPT = """
import torch
from selkies_tpu_torch.models.h264 import encoder_core as core, me_mc
from selkies_tpu_torch.models.h264.numpy_ref import MV_PAD
dev = torch.device("cuda")
cur = torch.zeros((32, 32), dtype=torch.int32, device=dev)
pads = [core.edge_pad(torch.zeros(s, dtype=torch.uint8, device=dev), MV_PAD)
        for s in ((32, 32), (16, 16), (16, 16))]
cands = torch.tensor([[0, 0], [MV_PAD + 1, 0]], dtype=torch.int32, device=dev)
try:
    me_mc.me_mc(cands, cur, *pads)
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("raised:", type(exc).__name__, me_mc.launches)
"""


@pytest.mark.gpu
def test_kernel_out_of_reach_candidate_raises():
    """The documented contract: the kernel traps and the launch or the next
    sync raises. Run in a child process: the trap leaves its CUDA context
    unusable."""
    _need_card()
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT], cwd=root, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(root)})
    assert "raised:" in res.stdout, res.stdout + res.stderr


def _trace(seed=1):
    rng = np.random.default_rng(seed)
    cur = np.kron(rng.integers(40, 200, (H // 16, W // 16, 4), np.uint8),
                  np.ones((16, 16, 1), np.uint8))
    frames = [cur, np.roll(cur, 8, 0)]
    cur = frames[-1].copy()
    cur[40:56, 40:200, :3] = rng.integers(0, 255, (16, 160, 3), np.uint8)
    frames += [cur, cur.copy(), np.roll(cur, (-5, 3), (0, 1)),
               rng.integers(0, 255, (H, W, 4), np.uint8)]
    return frames


def _drive(enc, frames):
    out = []
    for i, f in enumerate(frames):
        if i == 4:
            enc.force_keyframe()
        au = enc.encode_frame(f, qp=34 if i == 5 else None)
        out.append(hashlib.sha256(au).hexdigest())
    return out


@pytest.mark.gpu
def test_cuda_encoder_matches_cpu_bytes():
    _need_card()
    frames = _trace()
    before = me_mc.launches
    got = _drive(TorchH264Encoder(W, H, host_convert=False, device="cuda"), frames)
    launched = me_mc.launches - before
    assert got == _drive(TorchH264Encoder(W, H, host_convert=False, device="cpu"), frames)
    assert launched == 3  # 6 frames less 2 IDRs and 1 static repeat


def _tile_case(seed, tw=128, ph=1088, pw=1920, slots=1024, bucket=256, cbucket=1020):
    """A 1080p tile list as the host could send it, with heavy duplication:
    copies and uploads onto repeated positions, uploads into repeated pool
    slots and the scratch row, pads (-1) in both lists."""
    rng = np.random.default_rng(seed)
    nb, nt = ph // 16, pw // tw
    pos = rng.integers(0, nb, 64) * 1024 + rng.integers(0, nt, 64)  # few positions
    up_idx = rng.choice(pos, bucket).astype(np.int32)
    up_idx[-20:] = -1
    pool_dst = rng.integers(0, 40, bucket).astype(np.int32)
    pool_dst[rng.random(bucket) < 0.3] = slots
    pool_dst[-20:] = slots
    pairs = np.stack([rng.integers(0, slots, cbucket), rng.choice(pos, cbucket)], 1)
    pairs = pairs.astype(np.int32)
    pairs[rng.random(cbucket) < 0.2] = (-1, 0)
    tiles = [rng.integers(0, 256, (bucket, 16, tw), np.uint8),
             rng.integers(0, 256, (bucket, 8, tw // 2), np.uint8),
             rng.integers(0, 256, (bucket, 8, tw // 2), np.uint8)]
    packed = np.concatenate([up_idx.view(np.uint8), pool_dst.view(np.uint8),
                             pairs.reshape(-1).view(np.uint8), *(t.ravel() for t in tiles)])
    planes = [rng.integers(0, 256, (ph, pw), np.uint8),
              rng.integers(0, 256, (ph // 2, pw // 2), np.uint8),
              rng.integers(0, 256, (ph // 2, pw // 2), np.uint8)]
    pool = [rng.integers(0, 256, (slots + 1, 16, tw), np.uint8),
            rng.integers(0, 256, (slots + 1, 8, tw // 2), np.uint8),
            rng.integers(0, 256, (slots + 1, 8, tw // 2), np.uint8)]
    return packed, planes, pool, pairs


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_tiles2_with_duplicates_on_card_equals_cpu(seed):
    """Duplicate indices have no defined write order on CUDA: the scatter
    must resolve them itself. The card's planes and whole pool (scratch row
    included) equal the CPU result, for _apply_tiles2, _pool_seed_step and
    scatter_tiles."""
    _need_card()
    packed, planes, pool, pairs = _tile_case(seed)
    res = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
        out = enc_mod._apply_tiles2(*map(t, planes), *map(t, pool), t(packed), tile_w=128,
                                    bucket=256, cbucket=1020)
        seed_pairs = t(np.where(pairs[:, :1] < 0, 1024, pairs))
        seeded = enc_mod._pool_seed_step(seed_pairs, *out[:3], *map(t, pool), tile_w=128,
                                         sbucket=1020)
        idx = t(np.abs(pairs[:256, 1]))
        tiles = [t(np.array(pool[i][:256])) for i in range(3)]
        scattered = core.scatter_tiles(*map(t, planes), *tiles, idx, 128)
        res[dev] = [x.cpu() for x in (*out, *seeded, *scattered)]
    for i, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
        assert torch.equal(a, b), i


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["var", "packed"])
def test_sparse_packers_on_card_equal_cpu(packed):
    """Whole fused buffers, dense headers and row buffers at 1080p."""
    _need_card()
    rng = np.random.default_rng(5)
    mbh, mbw = 68, 120
    skip = rng.random((mbh, mbw)) < 0.7
    out = {"mvs": rng.integers(-40, 41, (mbh, mbw, 2)).astype(np.int32), "skip": skip}
    for k, shape in (("luma_ac", (4, 4, 4, 4)), ("chroma_dc", (2, 2, 2)),
                     ("chroma_ac", (2, 2, 2, 4, 4))):
        c = rng.integers(-20, 21, (mbh, mbw, *shape)) * (rng.random((mbh, mbw, *shape)) < 0.05)
        c[skip] = 0
        out[k] = c.astype(np.int32)
    res = {}
    for dev in ("cpu", "cuda"):
        o = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in out.items()}
        fn = core.pack_p_sparse_packed if packed else core.pack_p_sparse_var
        res[dev] = [x.cpu() for x in fn(o, 4096, 4096)]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)


def _host_trace_1080p():
    """IDR, static, typing delta, scene cut (full + seed), remap-only, a
    forced IDR on a delta frame, a window scroll (remaps + uploads)."""
    w, h = 1920, 1080
    rng = np.random.default_rng(11)
    a = np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))[:h]
    win = a.copy()
    win[192:720, 384:1408] = rng.integers(0, 255, (528, 1024, 4), np.uint8)
    typed = a.copy()
    typed[500:516, 300:700, :3] = 255 - typed[500:516, 300:700, :3]
    patched = win.copy()
    patched[900:916, 100:300, :3] = 9
    scrolled = patched.copy()
    scrolled[192:704, 384:1408] = patched[208:720, 384:1408]
    scrolled[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
    return [(a, None), (a.copy(), None), (typed, None), (win, None), (typed.copy(), None),
            (win.copy(), None), (patched, "idr"), (scrolled, None)]


@pytest.mark.gpu
def test_host_encoder_cuda_matches_cpu_at_1080p():
    _need_card()
    trace = _host_trace_1080p()

    def drive(dev):
        enc = TorchH264Encoder(1920, 1080, scene_qp_boost=6, frame_batch=1, pipeline_depth=0,
                               ltr_scenes=False, device=dev)
        out = []
        for frame, op in trace:
            if op == "idr":
                enc.force_keyframe()
            (au, st, _), = enc.submit(frame)
            out.append((hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr, st.remap_frac))
        return out, enc.link_bytes.snapshot()

    before, sparse = me_mc.launches, native.sparse_calls
    got = drive("cuda")
    launched, packed = me_mc.launches - before, native.sparse_calls - sparse
    assert got == drive("cpu")
    kinds = [(k, idr) for _, k, idr, _ in got[0]]
    assert kinds == [("full", True), ("static", False), ("delta", False), ("full", False),
                     ("full", False), ("delta", False), ("full", True), ("delta", False)]
    assert got[0][5][3] == 1.0 and 0.0 < got[0][7][3] < 1.0
    assert launched == 5  # the non-static P frames
    assert packed >= 1  # the sparse-wire packer (a dense fallback skips it)


@pytest.mark.gpu
def test_registry_row_cuda_matches_cpu_at_1080p():
    """The registry row (groups of 4, pipeline depth 2, the LTR scene cache)
    on the card against the CPU, AU by AU: IDR, four typing deltas (one
    group), a window switch, a typed line in the window, the switch back
    (an LTR restore)."""
    _need_card()
    trace = _host_trace_1080p()
    a, win = trace[0][0], trace[3][0]
    rng = np.random.default_rng(12)
    lines = [a]
    for k in range(4):
        f = lines[-1].copy()
        f[600 + 16 * k:616 + 16 * k, 200:600, :3] = rng.integers(0, 255, (16, 400, 3), np.uint8)
        lines.append(f)
    win_typed = win.copy()
    win_typed[400:416, 500:900, :3] = rng.integers(0, 255, (16, 400, 3), np.uint8)
    frames = lines + [win, win_typed, lines[-1]]

    def drive(dev):
        enc = TorchH264Encoder(1920, 1080, scene_qp_boost=6, device=dev)
        outs = []
        for i, f in enumerate(frames):
            outs += enc.submit(f, meta=i)
        outs += enc.flush()
        enc.close()
        assert [m for *_, m in outs] == list(range(len(frames)))
        return ([(hashlib.sha256(au).hexdigest(), st.upload_kind, st.idr) for au, st, _ in outs],
                enc.ltr_restores, dict(enc.group_sizes))

    before = me_mc.launches
    got = drive("cuda")
    launched = me_mc.launches - before
    assert got == drive("cpu")
    assert got[1] == 1 and got[2].get(4) == 1
    assert launched == sum(1 for _, kind, idr in got[0] if not idr and kind != "static")


# -- the entropy plane: device CAVLC (K2) and the CABAC tokenizer (K3) ------


def _entropy_out(mbh, mbw, seed, live_frac, dev):
    """Seeded P-frame outputs (mvs, skip, coefficients) on ``dev``, about
    ``live_frac`` of the MBs coded with a few coefficients each (a coded
    slice within the encoder's word caps); skip MBs carry their derived
    skip MV."""
    rng = np.random.default_rng(seed)
    skip = rng.random((mbh, mbw)) >= live_frac
    mvs = rng.integers(-12, 13, (mbh, mbw, 2)).astype(np.int32)
    native.derive_skip_mvs(mvs, skip)

    def coeffs(shape, mag):
        c = rng.integers(-mag, mag + 1, shape).astype(np.int32)
        c[rng.random(shape) < 0.96] = 0
        c[skip] = 0
        return c

    cac = coeffs((mbh, mbw, 2, 2, 2, 4, 4), 6)
    cac[..., 0, 0] = 0
    arrs = {"mvs": mvs, "skip": skip, "luma_ac": coeffs((mbh, mbw, 4, 4, 4, 4), 40),
            "chroma_dc": coeffs((mbh, mbw, 2, 2, 2), 9), "chroma_ac": cac}
    return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}


_ENTROPY_GEOMS = {"1920x1088": (68, 120), "1368x776-ragged": (49, 86)}


@pytest.mark.gpu
@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
@pytest.mark.parametrize("geom", list(_ENTROPY_GEOMS))
def test_device_entropy_downlink_on_card_equals_cpu(geom, coder):
    """The delta step's entropy-wrapped downlink (top bucket, the encoder's
    consts) and the full-P step's prefix, on the card and on the CPU, for a
    busy (coded-slice) and a quiet (coefficient) frame."""
    _need_card()
    from selkies_tpu_torch.models.h264.device_cavlc import resolve_entropy
    from selkies_tpu_torch.models.h264.encoder_core import pack_p_sparse_entropy

    mbh, mbw = _ENTROPY_GEOMS[geom]
    _, _, _, consts = resolve_entropy(mbh * mbw, True, 64, coder)
    for seed, live, mode in ((1, 0.25, 1), (2, 0.004, 0)):
        outs = [_entropy_out(mbh, mbw, seed, live, d) for d in ("cuda", "cpu")]
        got, want = (pack_p_sparse_entropy(o, enc_mod.NSCAP, enc_mod.CAP_ROWS_DELTA, 75, *consts)
                     for o in outs)
        for name, g, w in zip(("fused", "dense", "buf"), got, want):
            assert torch.equal(g.cpu(), w), (name, seed)
        meta = want[0][:16].view(torch.int32).tolist()
        assert meta[0] == mode, meta
    step = enc_mod._p_toks_step if coder == "cabac" else enc_mod._p_bits_step
    rng = np.random.default_rng(3)
    h, w = 16 * mbh, 16 * mbw
    planes = [rng.integers(0, 255, s, np.uint8) for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    ref = [np.roll(p, (2, -3), (0, 1)) for p in planes]
    res = [step(*(torch.from_numpy(p).to(d) for p in planes), 30,
                *(torch.from_numpy(p).to(d) for p in ref)) for d in ("cuda", "cpu")]
    for k, (g, w) in enumerate(zip(*res)):
        assert torch.equal(g.cpu(), w), k


@pytest.mark.gpu
@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
def test_top_bucket_equals_every_bucket_on_card(coder):
    """The encoder always runs the top bucket (no host read of the coded
    count); every bucket that holds the coded MBs gives the same output."""
    _need_card()
    from selkies_tpu_torch.models.h264.device_cabac import pack_p_slice_tokens_active
    from selkies_tpu_torch.models.h264.device_cavlc import bits_buckets, pack_p_slice_bits_active

    out = _entropy_out(68, 120, 4, 0.025, "cuda")  # ~200 coded MBs
    ns = int((~out["skip"]).sum())
    buckets = bits_buckets(68 * 120)
    fn = pack_p_slice_tokens_active if coder == "cabac" else pack_p_slice_bits_active
    runs = [fn(out, 1 << 17, buckets, bucket=b) for b in buckets if b >= ns]
    assert len(runs) == len(buckets)
    for other in runs[:-1]:
        for g, w in zip(other, runs[-1]):
            assert torch.equal(g, w)


def _submit_never_syncs(coder):
    """No synchronising CUDA call on the submit thread of the registry row
    with device entropy (groups, depth 2, LTR): torch's sync debug mode
    warns on every such call, and a hook records the thread that made it.
    The completion workers wait on events and may sync; they are not
    counted."""
    import threading
    import traceback
    import warnings

    trace = _host_trace_1080p()
    a, win = trace[0][0], trace[3][0]
    rng = np.random.default_rng(21)
    frames = [a]
    for k in range(9):
        f = frames[-1].copy()
        f[200 + 16 * k:216 + 16 * k, 100:1700, :3] = rng.integers(0, 255, (16, 1600, 3), np.uint8)
        frames.append(f)
    frames += [win, frames[-1], trace[7][0]]
    enc = TorchH264Encoder(1920, 1080, scene_qp_boost=6, device_entropy=True, bits_min_mbs=64,
                           entropy_coder=coder, device="cuda")
    for f in frames[:3]:  # warm-up: tables reach the card, the kernel builds
        enc.submit(f)
    enc.flush()
    submit_thread = threading.get_ident()
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.get_ident(), str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in frames[3:]:
                outs += enc.submit(f)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    outs += enc.flush()
    enc.close()
    on_submit = [st for tid, m, st in seen
                 if tid == submit_thread and "called a synchronizing CUDA operation" in m]
    assert not on_submit, f"{len(on_submit)} syncs; first at:\n" + "\n".join(
        dict.fromkeys(on_submit))
    assert len(outs) == len(frames) - 3
    assert {"bits" if coder == "cavlc" else "cabac"} <= {st.downlink_mode for _, st, _ in outs}
    return len(frames) - 3


@pytest.mark.gpu
@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
def test_pipelined_device_entropy_submit_never_syncs(coder):
    _need_card()
    _submit_never_syncs(coder)


@pytest.fixture
def hooks_on():
    """The port's tracer and telemetry bus on for the test, then off and
    reset."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.monitoring.tracing import tracer

    for plane in (tracer, telemetry):
        plane.reset()
        plane.enable()
    yield tracer, telemetry
    for plane in (tracer, telemetry):
        plane.disable()
        plane.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("coder", ["cavlc", "cabac"])
def test_submit_never_syncs_with_the_hooks_on(coder, hooks_on):
    """The same check with the tracer and telemetry on: a span reads the
    host clock, and the classify counters read host state only."""
    _need_card()
    tracer, telemetry = hooks_on
    timed = _submit_never_syncs(coder)
    spans = {k: v["count"] for k, v in tracer.summary().items()}
    assert spans["classify"] >= timed and spans["step"] > 0 and spans["pack"] > 0
    assert telemetry.rollup()["counters"]["selkies_tile_cache_frames_total"]


# -- the health plane on the card (selkies_tpu_torch/resilience/devhealth.py) --

@pytest.mark.gpu
def test_probe_round_trips_the_card():
    _need_card()
    from selkies_tpu_torch.resilience import devhealth

    assert devhealth._default_probe(torch.device("cuda", 0)) is True
    pool = devhealth.DevicePool(fail_threshold=1)
    assert pool.all_devices() == [torch.device("cuda", i)
                                  for i in range(torch.cuda.device_count())]
    assert pool.note_failure("0") and pool.healthy_devices() == pool.all_devices()[1:]
    pool._health["0"].probation_until = 0.0
    pool.readmit_after = 1
    assert pool.tick() == ["0"]


@pytest.mark.gpu
def test_chip_key_of_the_card():
    _need_card()
    from selkies_tpu_torch.device import resolve_device
    from selkies_tpu_torch.resilience.devhealth import chip_key

    assert chip_key(torch.device("cuda", 0)) == "0"
    assert chip_key(resolve_device(None)) == str(torch.cuda.current_device())


@pytest.mark.gpu
def test_device_monitor_reads_the_cards_memory():
    _need_card()
    from selkies_tpu_torch.monitoring.device_monitor import DeviceMonitor

    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    total_mb, used_mb = DeviceMonitor(device="cuda")._memory_mb()
    card_mb = torch.cuda.get_device_properties(0).total_memory / 1e6
    assert abs(total_mb - card_mb) <= 0.01 * card_mb
    assert keep.numel() / 1e6 < used_mb < total_mb


@pytest.mark.gpu
def test_banded_encoder_takes_the_card_from_the_pool():
    _need_card()
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
    from selkies_tpu_torch.resilience import devhealth

    devhealth.reset_device_pool()
    try:
        enc = TorchBandedH264Encoder(W, H, bands=2)
        assert enc.device == torch.device("cuda", 0) and enc.devices == [enc.device]
        enc.close()
        devhealth.get_device_pool().quarantine("0")
        enc = TorchBandedH264Encoder(W, H, bands=2)
        if torch.cuda.device_count() == 1:
            # the only card quarantined: one band on it, no fault check
            assert (enc.bands, enc.devices, enc.device.type) == (1, [], "cuda")
        enc.close()
    finally:
        devhealth.reset_device_pool()


# -- band and tile slicing (selkies_tpu_torch/parallel/bands.py) ----------

def _band_frames(w=336, h=192, seed=31):
    """IDR, a vertical scroll across the band seams, a horizontal one across
    the column seams with a new block, a static repeat, one dirty MB."""
    rng = np.random.default_rng(seed)
    f0 = np.kron(rng.integers(0, 256, (h // 16, w // 16, 4), np.uint8),
                 np.ones((16, 16, 1), np.uint8))
    f0[::3, ::5, :3] = rng.integers(0, 255, f0[::3, ::5, :3].shape, np.uint8)
    f1 = np.roll(f0, 22, 0).copy()
    f2 = np.roll(f1, -30, 1).copy()
    f2[40:104, 90:150] = rng.integers(0, 256, (64, 60, 4), np.uint8)
    quiet = f2.copy()
    quiet[150:158, 20:36] ^= 0x40
    return [f0, f1, f2, f2.copy(), quiet]


_BAND_CFGS = {
    "bands4": dict(bands=4),
    "grid4x3": dict(bands=4, cols=3),
    "cabac_device_bands4": dict(bands=4, entropy_coder="cabac", device_entropy=True,
                                bits_min_mbs=4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_BAND_CFGS))
def test_banded_encoder_cuda_matches_cpu(name):
    """336x192 (12 MB rows -> 4 bands of 3; 21 MB columns -> 3 tiles of 7):
    the card's AUs equal the CPU run's, and K1 launches once per band and
    tile of every non-static P frame."""
    _need_card()
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    frames = _band_frames()

    def drive(dev):
        enc = TorchBandedH264Encoder(336, 192, qp=30, device=dev, **_BAND_CFGS[name])
        out, launches = [], []
        for f in frames:
            before = me_mc.launches
            au = enc.encode_frame(f)
            st = enc.last_stats
            launches.append(me_mc.launches - before)
            out.append((hashlib.sha256(au).hexdigest(), st.idr, st.upload_kind,
                        st.downlink_mode))
        enc.close()
        return out, launches, enc.bands * enc.cols

    got, launches, tiles = drive("cuda")
    want, _, _ = drive("cpu")
    assert got == want
    assert tiles == (12 if name == "grid4x3" else 4)
    p = [not idr and kind != "static" for _, idr, kind, _ in got]
    assert launches == [tiles if is_p else 0 for is_p in p]
    if name.startswith("cabac"):
        assert "cabac" in {m for *_, m in got}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bands4", "grid4x3"])
def test_banded_dispatch_never_syncs(name):
    """dispatch_frame of a banded P frame (upload, step, the downlink
    copies enqueued) makes no synchronising CUDA call: torch's sync debug
    mode warns on each, recorded here by thread. complete_frame waits on
    the bands' events and is not counted."""
    _need_card()
    import threading
    import traceback
    import warnings

    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    frames = _band_frames()
    enc = TorchBandedH264Encoder(336, 192, qp=30, device="cuda", **_BAND_CFGS[name])
    for f in frames[:2]:  # warm-up: tables reach the card, the kernel builds
        enc.encode_frame(f)
    me = threading.get_ident()
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.get_ident(), str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    aus = []
    for f in frames[2:]:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pending = enc.dispatch_frame(f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        aus.append(enc.complete_frame(pending))
    enc.close()
    on_submit = [st for tid, m, st in seen
                 if tid == me and "called a synchronizing CUDA operation" in m]
    assert not on_submit, f"{len(on_submit)} syncs; first at:\n" + "\n".join(
        dict.fromkeys(on_submit))
    assert len(aus) == 3 and all(au.startswith(b"\x00\x00\x00\x01") for au in aus)


# -- multi-session serving (selkies_tpu_torch/parallel/serving.py) ---------

# name -> (n, h, w, seed, candidate count or "hier")
_BATCH_CASES = {
    "3x320x192-hier": (3, H, W, 40, "hier"),
    "1x320x192-hier": (1, H, W, 41, "hier"),
    "4x208x336-ragged": (4, 208, 336, 42, "hier"),
    "2x64x96-count-300": (2, 64, 96, 43, 300),
}


def _batch_case_inputs(name, dev):
    """Per-session planes with each session's own motion and candidates."""
    n, h, w, seed, kind = _BATCH_CASES[name]
    rng = np.random.default_rng(seed)
    ins = []
    for i in range(n):
        motion = tuple(int(x) for x in rng.integers(-30, 31, 2))
        cur, ref, cu, cv = (torch.from_numpy(a).to(dev)
                            for a in _planes(h, w, seed + i, motion, 4 * i))
        pads = [core.edge_pad(p, MV_PAD) for p in (ref, cu, cv)]
        cands = (core.hier_candidates(cur, ref) if kind == "hier"
                 else _rand_cands(rng, kind).to(dev))
        ins.append((cands, cur, *pads))
    return tuple(torch.stack(t).contiguous() for t in zip(*ins))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_BATCH_CASES))
def test_batched_kernel_matches_plain_on_card(case):
    """me_mc_batch is one launch over every session and equals the batched
    plain version (and so each session's solo plain version) exactly."""
    _need_card()
    args = _batch_case_inputs(case, torch.device("cuda"))
    launches = me_mc.launches
    got = me_mc.me_mc_batch(*args)
    assert me_mc.launches == launches + 1
    want = me_mc.me_mc_batch_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _session_trace(n, h, w, ticks=5, seed=51):
    """Per tick an (n, h, w, 4) batch: each session scrolls its own block
    content by its own step."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (n, h // 8 + 8, w // 8 + 8, 4), np.uint8),
                   np.ones((1, 8, 8, 1), np.uint8))
    return [np.stack([np.ascontiguousarray(base[i, 3 * t * (i + 1) % 48:][:h, 2 * t:2 * t + w])
                      for i in range(n)]) for t in range(ticks)]


def _drive_service(svc, trace):
    out = []
    for t, batch in enumerate(trace):
        if t == 2:
            svc.set_qp(1, 36)
            svc.force_keyframe(0)
        out.append([hashlib.sha256(au).hexdigest() for au in svc.encode_tick(batch)])
    return out


@pytest.mark.gpu
def test_service_cuda_matches_cpu():
    """3 sessions at 320x192: every AU of the card run equals the CPU run,
    and K1 launches once per tick that has a P session."""
    _need_card()
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    trace = _session_trace(3, H, W)
    svc = TorchMultiSessionH264Service(3, W, H, qp=30, device="cuda")
    launches = me_mc.launches
    got = _drive_service(svc, trace)
    assert me_mc.launches - launches == len(trace) - 1
    svc.close()
    cpu = TorchMultiSessionH264Service(3, W, H, qp=30, device="cpu")
    want = _drive_service(cpu, trace)
    cpu.close()
    assert got == want


@pytest.mark.gpu
def test_service_dispatch_never_syncs():
    """dispatch_tick (conversion, the pinned upload, the mixed step and its
    downlink copy) makes no synchronising CUDA call: torch's sync debug
    mode warns on each, recorded here by thread. complete_tick waits on
    the copy's events and is not counted."""
    _need_card()
    import threading
    import traceback
    import warnings

    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    trace = _session_trace(3, H, W, ticks=6)
    svc = TorchMultiSessionH264Service(3, W, H, qp=30, device="cuda")
    for batch in trace[:2]:  # warm-up: tables reach the card, the kernel builds
        svc.encode_tick(batch)
    me = threading.get_ident()
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.get_ident(), str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    aus = []
    for t, batch in enumerate(trace[2:]):
        if t == 1:
            svc.force_keyframe(2)  # a mixed tick
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pending = svc.dispatch_tick(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        aus.append(svc.complete_tick(pending))
    svc.close()
    on_dispatch = [st for tid, m, st in seen
                   if tid == me and "called a synchronizing CUDA operation" in m]
    assert not on_dispatch, f"{len(on_dispatch)} syncs; first at:\n" + "\n".join(
        dict.fromkeys(on_dispatch))
    assert len(aus) == 4 and aus[1][2][4] & 0x1F == 7


# -- the fleet's banded service and the occupancy scheduler
# (selkies_tpu_torch/parallel/serving.py, occupancy.py) -------------------------

def _fleet_service(kind, dev):
    """3 sessions at 320x192: the banded service at 2 bands (on the card
    through the pool, which gives the shared carve) or the batch service."""
    from selkies_tpu_torch.parallel.serving import (
        TorchBandedFleetService,
        TorchMultiSessionH264Service,
    )

    if kind == "banded":
        devices = None if dev == "cuda" else [torch.device("cpu")]
        return TorchBandedFleetService(3, W, H, qp=30, bands=2, devices=devices)
    return TorchMultiSessionH264Service(3, W, H, qp=30, device=dev)


def _drive_fleet(tick, svc, trace):
    out = []
    for t, batch in enumerate(trace):
        if t == 2:
            svc.set_qp(1, 36)
            svc.force_keyframe(0)
        out.append([hashlib.sha256(au).hexdigest() for au in tick(batch)])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["banded", "batch"])
def test_scheduler_equals_serial_tick_on_card(kind):
    """OccupancyScheduler.for_service over the banded service (a unit per
    session) and over the batch service (one unit): the AUs equal the
    serial tick's on the card and the CPU run's; K1 launches bands times
    per banded P session, once per batch tick with a P session."""
    _need_card()
    from selkies_tpu_torch.parallel.occupancy import OccupancyScheduler

    trace = _session_trace(3, H, W, ticks=5)
    svc = _fleet_service(kind, "cuda")
    sched = OccupancyScheduler.for_service(svc)
    launches = me_mc.launches
    got = _drive_fleet(sched.encode_tick, svc, trace)
    launched = me_mc.launches - launches
    sched.close()
    svc.close()
    serial = _fleet_service(kind, "cuda")
    want = _drive_fleet(serial.encode_tick, serial, trace)
    serial.close()
    cpu = _fleet_service(kind, "cpu")
    want_cpu = _drive_fleet(cpu.encode_tick, cpu, trace)
    cpu.close()
    assert got == want == want_cpu
    # ticks 1-4 are P for every session but the forced one at tick 2
    assert launched == (2 * (3 * 4 - 1) if kind == "banded" else 4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["banded", "batch"])
def test_scheduled_tick_never_syncs(kind):
    """A scheduled tick, dispatch lane and completion workers together,
    makes no synchronising CUDA call: each completion waits on its own
    events only (torch's sync debug mode warns on a stream or device
    synchronise, a blocking copy or .item(), recorded here by thread)."""
    _need_card()
    import threading
    import traceback
    import warnings

    from selkies_tpu_torch.parallel.occupancy import OccupancyScheduler

    trace = _session_trace(3, H, W, ticks=6)
    svc = _fleet_service(kind, "cuda")
    sched = OccupancyScheduler.for_service(svc)
    for batch in trace[:2]:  # warm-up: tables reach the card, the hints settle
        sched.encode_tick(batch)
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.current_thread().name, str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    aus = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t, batch in enumerate(trace[2:]):
                if t == 1:
                    svc.force_keyframe(2)  # an IDR among P sessions
                aus.append(sched.encode_tick(batch))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sched.close()
    svc.close()
    syncs = [(name, st) for name, m, st in seen if "called a synchronizing CUDA operation" in m]
    assert not syncs, f"{len(syncs)} syncs; first in {syncs[0][0]} at:\n{syncs[0][1]}"
    assert len(aus) == 4 and all(au.startswith(b"\x00\x00\x00\x01") for a in aus for au in a)


@pytest.mark.gpu
def test_refetch_after_an_event_never_syncs():
    """sparse_complete.host(t, after): the copy runs on a side stream behind
    ``after`` only, returns t's values, and makes no synchronising call,
    while the default stream is busy with later work."""
    _need_card()
    import warnings

    from selkies_tpu_torch.models.h264.sparse_complete import fetch_rest, host

    a = torch.arange(3 * 5000, dtype=torch.int32, device="cuda").reshape(5000, 3)[::2]
    done = torch.cuda.Event()
    done.record()
    big = torch.randn(2048, 2048, device="cuda")
    for _ in range(20):  # later work on the default stream
        big = big @ big / 2048
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = host(a, done)
            rest = fetch_rest(a, 2100, 2048, done)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    want = np.arange(3 * 5000, dtype=np.int32).reshape(5000, 3)[::2]
    assert np.array_equal(got, want) and np.array_equal(rest, want[2048:])
    assert not [w for w in seen if "synchronizing" in str(w.message)]


# -- the hybrid VP9/AV1 rows and the registry (models/hybrid_frontend.py,
# models/vp9, models/av1, models/registry.py) ---------------------------------

def _hybrid_trace(w=320, h=200, seed=41):
    """First frame, static, one MB, a one-byte change to one channel,
    typing, noise, its 16-row scroll, a static repeat."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(40, 200, (h // 16 + 1, w // 16 + 1, 4), np.uint8),
                   np.ones((16, 16, 1), np.uint8))[:h, :w].copy()
    one_mb = base.copy()
    one_mb[32:48, 64:80] = 255
    one_byte = one_mb.copy()
    one_byte[h - 3, w - 5, 2] ^= 1
    typed = one_byte.copy()
    typed[80:96, 16:200, :3] = rng.integers(0, 255, (16, 184, 3), np.uint8)
    noise = rng.integers(0, 255, (h, w, 4), np.uint8)
    scrolled = np.roll(noise, -16, 0)
    return [base, base.copy(), one_mb, one_byte, typed, noise, scrolled, scrolled.copy()]


@pytest.mark.gpu
def test_hybrid_frontend_on_card_matches_cpu():
    """Dirty maps and hints equal the CPU run's; the one-byte change marks
    one MB; a static frame launches no vote."""
    _need_card()
    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend

    frames = _hybrid_trace()
    out = {}
    for dev in ("cuda", "cpu"):
        fe = DeviceDeltaFrontend(320, 200, device=dev)
        steps = []
        for i, f in enumerate(frames):
            if i == 6:
                fe.reset()
                fe.step(frames[5])
            votes = fe.votes
            steps.append((*fe.step(f), fe.votes - votes))
        out[dev] = steps
    for i, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        if c[0] is None:
            assert g[0] is None and g[1] is None, i
            continue
        np.testing.assert_array_equal(g[0], c[0], err_msg=f"dirty, frame {i}")
        np.testing.assert_array_equal(g[1], c[1], err_msg=f"hints, frame {i}")
        assert g[2] == c[2] == int(c[0].any()), i
    assert out["cuda"][3][0].sum() == 1 and out["cuda"][1][2] == 0


@pytest.mark.gpu
def test_hybrid_frontend_step_syncs_only_to_fetch():
    """A static step makes one synchronising call (the dirty map's fetch),
    a changed one two (and the hints'); the upload never syncs."""
    _need_card()
    import warnings

    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend

    frames = _hybrid_trace()
    fe = DeviceDeltaFrontend(320, 200, device="cuda")
    for f in frames[:5]:  # warm-up: the vote's tables reach the card
        fe.step(f)
    counts = []
    for f in (frames[4].copy(), frames[5]):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fe.step(f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchronizing CUDA operation" in str(w.message) for w in seen))
    assert counts == [1, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("row", ["tpuvp9enc", "tpuav1enc"])
def test_hybrid_rows_on_card_match_cpu(row, monkeypatch):
    """The registry's row with the device front-end on the card gives the
    AUs of the same row on the CPU (VP9 with libvpx's row-mt off: with it
    on, libvpx does not repeat its own bytes); ``auto`` picks the device
    front-end on the card."""
    _need_card()
    from selkies_tpu_torch.models import libaom_enc, libvpx_enc
    from selkies_tpu_torch.models.registry import create_encoder

    if row == "tpuvp9enc" and not libvpx_enc.libvpx_available():
        pytest.skip("libvpx not loadable")
    if row == "tpuav1enc" and not libaom_enc.libaom_available():
        pytest.skip("libaom not loadable")
    monkeypatch.delenv("SELKIES_HYBRID_FRONTEND", raising=False)
    monkeypatch.setattr(libvpx_enc, "_row_mt_state", False)
    frames = _hybrid_trace()
    shas = {}
    for dev in ("cuda", "cpu"):
        enc = create_encoder(row, width=320, height=200, fps=30, frontend="device",
                             device=dev)
        aus = []
        for i, f in enumerate(frames):
            if i == 6:
                enc.force_keyframe()
            aus.append(enc.encode_frame(f))
        enc.close()
        shas[dev] = [hashlib.sha256(au).hexdigest() for au in aus]
        assert enc.static_frames >= 1 and enc.active_map_frames >= 2
    assert shas["cuda"] == shas["cpu"]
    enc = create_encoder(row, width=320, height=200)
    assert enc.frontend_mode == "device" and enc.device.type == "cuda"
    enc.close()


@pytest.mark.gpu
def test_registry_tpuh264enc_prewarmed_on_card_matches_direct():
    """The registry row, prewarmed on the card, gives the AUs of a fresh
    TorchH264Encoder built with the row's setdefaults."""
    _need_card()
    from selkies_tpu_torch.models.registry import create_encoder

    frames = _hybrid_trace(320, 192)
    reg = create_encoder("tpuh264enc", width=320, height=192, device="cuda")
    reg.prewarm()
    assert reg.frame_index == 0 and reg._force_idr
    direct = TorchH264Encoder(320, 192, frame_batch=4, pipeline_depth=2, scene_qp_boost=6,
                              device="cuda")
    got = {}
    for name, enc in (("registry", reg), ("direct", direct)):
        outs = []
        for f in frames:
            outs += enc.submit(f)
        outs += enc.flush()
        enc.close()
        got[name] = [(hashlib.sha256(au).hexdigest(), st.idr, st.frame_index)
                     for au, st, _ in outs]
    assert got["registry"] == got["direct"]
    assert got["registry"][0][1:] == (True, 0)
