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
    # every device step the workers waited on is on the device track
    assert spans["device-step"] >= spans["gpu-step"] > 0
    assert {"convert", "h2d", "complete_wait"} <= set(spans)


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
def test_device_monitor_reads_the_cards_load_from_nvml():
    """The load is NVML's kernel-active share: it loads from the driver's
    library on the card, and a card kept busy for a second reads busy."""
    _need_card()
    import time

    from selkies_tpu_torch.monitoring.device_monitor import DeviceMonitor

    mon = DeviceMonitor(device="cuda")
    assert 0.0 <= mon._load() <= 1.0 and not mon._nvml._failed
    end = time.perf_counter() + 1.2
    while time.perf_counter() < end:
        torch.cuda._sleep(10_000_000)
        torch.cuda.synchronize()
    assert mon._load() > 0.5 and not mon._nvml._failed


@pytest.mark.gpu
def test_banded_encoder_takes_the_card_from_the_pool():
    _need_card()
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
    from selkies_tpu_torch.resilience import devhealth

    devhealth.reset_device_pool()
    try:
        enc = TorchBandedH264Encoder(W, H, bands=2)
        # one card: the stacked steps on it; more: a 2-card band mesh
        cards = [torch.device("cuda", i) for i in range(min(2, torch.cuda.device_count()))]
        assert enc.device == cards[0] and enc.devices == (cards if len(cards) == 2
                                                          else [enc.device])
        assert enc.mesh_enabled == (len(cards) == 2)
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


# -- the multi-card carve: the band, tile and session meshes ----------------

def _need_cards(n: int):
    _need_card()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, this machine has {torch.cuda.device_count()}")


def _drive_banded(enc, frames):
    out, launches = [], []
    for f in frames:
        before = me_mc.launches
        au = enc.encode_frame(f)
        launches.append(me_mc.launches - before)
        out.append((hashlib.sha256(au).hexdigest(), enc.last_stats.idr,
                    enc.last_stats.upload_kind))
    enc.close()
    return out, launches


@pytest.mark.gpu
@pytest.mark.parametrize("name,listed", [("bands4", 4), ("grid4x3", 12)])
def test_band_mesh_on_one_card_repeated_equals_stacked(name, listed):
    """The mesh steps on [cuda:0] * k (every halo copy a same-card copy):
    the AUs of the stacked path on cuda:0, K1 once per band and tile of a
    non-static P frame."""
    _need_card()
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    frames = _band_frames()
    card = torch.device("cuda", 0)
    mesh = TorchBandedH264Encoder(336, 192, qp=30, devices=[card] * listed, **_BAND_CFGS[name])
    assert mesh.mesh_enabled
    got, launches = _drive_banded(mesh, frames)
    want, want_launches = _drive_banded(
        TorchBandedH264Encoder(336, 192, qp=30, device=card, **_BAND_CFGS[name]), frames)
    assert got == want and launches == want_launches
    assert launches == [0 if idr or kind == "static" else listed for _, idr, kind in got]


@pytest.mark.gpu
def test_fetch_of_another_cards_buffer_returns_its_bytes():
    """With cuda:0 current, a _Fetch of a buffer a kernel just wrote on
    cuda:1 waits on cuda:1's stream and returns the written bytes."""
    _need_cards(2)
    torch.cuda.set_device(0)
    src = torch.arange(1 << 24, dtype=torch.int32, device="cuda:1")
    for k in range(8):  # queue work on cuda:1's stream ahead of the copy
        src = src * 2 + k - src
    fetch = enc_mod._Fetch(src)
    arr, _, _ = fetch.wait(0.0, step_span=False)
    np.testing.assert_array_equal(arr, np.arange(1 << 24, dtype=np.int32) + 28)
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_kernel_on_another_card_keeps_the_current_card():
    """K1 launched on cuda:1 while cuda:0 is current: its outputs equal the
    plain version's and the thread's current card is still 0."""
    _need_cards(2)
    torch.cuda.set_device(0)
    args = _case_inputs("320x192-motion", torch.device("cuda", 1))
    got = me_mc.me_mc(*args)
    assert torch.cuda.current_device() == 0
    want = me_mc.me_mc_plain(*args)
    torch.cuda.synchronize(1)
    for a, b in zip(got, want):
        assert a.device == torch.device("cuda", 1) and torch.equal(a, b)


@pytest.mark.gpu
def test_tile_grid_on_two_cards_equals_stacked():
    """The 1x2 grid on cuda:0 and cuda:1 (cuda:0 current): the AUs of the
    stacked path on cuda:0, each tile's reference on its own card."""
    _need_cards(2)
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    torch.cuda.set_device(0)
    frames = _band_frames(w=320)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = TorchBandedH264Encoder(320, 192, qp=30, bands=1, cols=2, devices=cards)
    assert mesh.mesh_enabled and mesh.mesh == [cards]
    mesh_out = []
    for f in frames:
        mesh_out.append(hashlib.sha256(mesh.encode_frame(f)).hexdigest())
        assert torch.cuda.current_device() == 0
    assert [t.device for t in mesh._ref[0][0]] == cards
    mesh.close()
    stacked, _ = _drive_banded(
        TorchBandedH264Encoder(320, 192, qp=30, bands=1, cols=2, device=cards[0]), frames)
    assert mesh_out == [h for h, _, _ in stacked]


@pytest.mark.gpu
def test_session_groups_on_listed_cards_equal_one_group():
    """4 sessions in 2 groups (on cuda:0 twice, or on two cards) against
    one group on cuda:0: equal AUs, K1 once per group and tick with a P
    session."""
    _need_card()
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    n = torch.cuda.device_count()
    cards = [torch.device("cuda", min(i, n - 1)) for i in range(2)]
    trace = _session_trace(4, 192, 320)

    def run(**kw):
        svc = TorchMultiSessionH264Service(4, 320, 192, qp=28, **kw)
        out, launches = [], []
        for t, batch in enumerate(trace):
            if t == 2:
                svc.force_keyframe(1)
                svc.set_qp(3, 34)
            before = me_mc.launches
            out.append([hashlib.sha256(a).hexdigest() for a in svc.encode_tick(batch)])
            launches.append(me_mc.launches - before)
        svc.close()
        return out, launches

    got, launches = run(devices=cards)
    want, one = run(device=cards[0])
    assert got == want
    assert launches == [0] + [2] * (len(trace) - 1) and one == [0] + [1] * (len(trace) - 1)


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


def _service_dispatch_never_syncs():
    """dispatch_tick (conversion, the pinned upload, the mixed step and its
    downlink copy) makes no synchronising CUDA call: torch's sync debug
    mode warns on each, recorded here by thread. complete_tick waits on
    the copy's events and is not counted. -> the service's last_timing."""
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
    return svc.last_timing


@pytest.mark.gpu
def test_service_dispatch_never_syncs():
    _need_card()
    _service_dispatch_never_syncs()


@pytest.mark.gpu
def test_service_dispatch_never_syncs_with_the_hooks_on(hooks_on):
    """The same with the tracer on: the h2d, step-i / step-p spans, the
    first-op timing event and the anchor add no synchronising call; each
    tick is on the device track but perhaps the first, which may come
    before the card's first anchor."""
    _need_card()
    tracer, _ = hooks_on
    timing = _service_dispatch_never_syncs()
    spans = {k: v["count"] for k, v in tracer.summary().items()}
    assert spans["device-step"] == spans["h2d"] == 6 and spans["gpu-step"] in (5, 6)
    assert spans["step-i"] == 2 and spans["step-p"] == 5
    assert timing["device_tail_ms"] > -0.5


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


def _scheduled_tick_never_syncs(kind):
    """A scheduled tick, dispatch lane and completion workers together,
    makes no synchronising CUDA call: each completion waits on its own
    events only (torch's sync debug mode warns on a stream or device
    synchronise, a blocking copy or .item(), recorded here by thread)."""
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
@pytest.mark.parametrize("kind", ["banded", "batch"])
def test_scheduled_tick_never_syncs(kind):
    _need_card()
    _scheduled_tick_never_syncs(kind)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["banded", "batch"])
def test_scheduled_tick_never_syncs_with_the_hooks_on(kind, hooks_on):
    """The same with the tracer on: a unit-dispatch span per unit and tick
    and a complete_wait per completion the lane waited on."""
    _need_card()
    tracer, _ = hooks_on
    _scheduled_tick_never_syncs(kind)
    spans = {k: v["count"] for k, v in tracer.summary().items()}
    units = 3 if kind == "banded" else 1
    assert spans["unit-dispatch"] == spans["complete_wait"] == 6 * units
    if kind == "batch":
        assert spans["device-step"] == 6 and spans["gpu-step"] in (5, 6)


def _service_steps(tracer):
    """Five ticks of a 3-session service, the third mixed (a keyframe
    request): -> a callable per tick that runs it to its end."""
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    trace = _session_trace(3, H, W, ticks=7)
    svc = TorchMultiSessionH264Service(3, W, H, qp=30, device="cuda")
    for batch in trace[:2]:  # warm-up: tables reach the card, the kernel builds
        svc.encode_tick(batch)

    def tick(t, batch):
        if t == 2:
            svc.force_keyframe(1)
        svc.encode_tick(batch)
        assert svc.last_timing["device_tail_ms"] > -0.5

    return [lambda t=t, b=b: tick(t, b) for t, b in enumerate(trace[2:])], svc.close


def _solo_steps(tracer):
    """The solo row at 1080p with its groups and depth: a typed line
    dispatched alone and a group of two typed lines, each flushed: -> a
    callable per step. (Its IDR, ~64k kernels in 2 s, overflows the
    profiler's buffers, which then drop kernels and markers.)"""
    base = _host_trace_1080p()[0][0]
    rng = np.random.default_rng(5)
    enc = TorchH264Encoder(1920, 1080, ltr_scenes=False, device="cuda")
    screen = [base.copy()]

    def typed():
        f = screen[0].copy()
        r = int(rng.integers(0, 60)) * 16
        f[r:r + 12, 300:1324, :3] = rng.integers(0, 255, (12, 1024, 3), np.uint8)
        screen[0] = f
        return f

    def alone():
        enc.submit(typed())
        enc.flush()

    def group():
        for _ in range(2):
            enc.submit(typed())
        enc.flush()

    enc.submit(base)  # the first IDR
    enc.flush()
    for step in (alone, group) * 2:  # warm-up: every shape twice
        step()
    return [alone, group, alone, group, alone], enc.close


@pytest.mark.gpu
@pytest.mark.parametrize("row", ["service", "solo"])
def test_gpu_steps_hold_the_profilers_kernels(row, hooks_on):
    """Each step's device ops, as torch.profiler saw them, and its gpu-step
    span agree within 0.5 ms at both ends: no op lies more than that
    outside the span, and the span starts no more than that before the
    first op and ends no more than that after the last. The upload runs
    before a step and the downlink after it, so host-device copies are
    left out; copies on the card are the step's work. The profiler's
    clock is put on the host's at each end of each step by a marker
    kernel launched right after a synchronise and a host stamp (one
    marker for a whole run moved by up to 8 ms against the host's clock
    across the solo row's 2 s IDR step on an H100); the steps are apart,
    a synchronise and 5 ms between them."""
    _need_card()
    import time

    from torch.profiler import ProfilerActivity, profile

    tracer, _ = hooks_on
    steps, close = (_service_steps if row == "service" else _solo_steps)(tracer)
    torch.cuda.synchronize()
    tracer.reset()
    bounds = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the profiler's first launch is slow: not a marker
        torch.cuda.synchronize()
        for step in steps:
            time.sleep(0.005)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda._sleep(1000)  # the step's opening marker
            step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.cuda._sleep(1000)  # its closing marker
            torch.cuda.synchronize()
            bounds.append((t0, t1))
    close()
    dev = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
                 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [s for s, _, n in dev if "spin_kernel" in n][1:]
    assert len(marks) == 2 * len(bounds)
    spans = [(a, b) for name, a, b, card in tracer.device_spans() if name == "gpu-step"]
    ends, drift = [], []
    for (t0, t1), m0, m1 in zip(bounds, marks[::2], marks[1::2]):
        (g0, g1), = [g for g in spans if t0 < g[0] < t1]  # one step, one span
        mine = [(s, e) for s, e, n in dev
                if m0 < s < m1 and not n.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
        assert mine
        # each end on the host's clock through its own marker
        first, last = min(s for s, _ in mine) - m0 + t0, max(e for _, e in mine) - m1 + t1
        ends.append((first - g0, g1 - last))
        drift.append((m1 - m0) - (t1 - t0))
    print(f"{row}: first op after the span's start, span's end after the last op "
          "(ms):", [(round(h * 1e3, 4), round(t * 1e3, 4)) for h, t in ends],
          "; the profiler's clock against the host's over each step (ms):",
          [round(d * 1e3, 4) for d in drift])
    assert all(abs(h) <= 5e-4 and abs(t) <= 5e-4 for h, t in ends), ends


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


# -- the tile-column codec mesh (parallel/codec_mesh.py) ----------------------

def _mesh_trace(w=336, h=200, seed=43):
    """_hybrid_trace plus a window dragged across the middle column seam."""
    frames = _hybrid_trace(w, h, seed)
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 255, (48, 64, 4), np.uint8)
    for x in (w // 2 - 72, w // 2 - 8):
        f = frames[-1].copy()
        f[24:72, x:x + 64] = win
        frames.append(f)
    return frames


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [1, 2, 4, 7])
def test_mesh_frontend_on_card_matches_cpu(cols):
    """MeshDeltaFrontend's dirty maps and hints on the card equal the CPU
    run's, static steps (which vote too) and a reset included; a
    ``devices`` row of 2 runs the 2-column mesh, a column per entry, and
    any other count on its first entry."""
    _need_card()
    from selkies_tpu_torch.parallel.codec_mesh import MeshDeltaFrontend

    frames = _mesh_trace()
    out = {}
    for dev in ("cuda", "cpu"):
        fe = MeshDeltaFrontend(336, 200, cols, devices=[torch.device(dev)] * 2)
        assert fe.devices == [fe.device] * (2 if cols == 2 else 1) and fe.device.type == dev
        assert fe.mesh_enabled == (cols == 2)
        steps = []
        for i, f in enumerate(frames):
            if i == 6:
                fe.reset()
            steps.append(fe.step(f))
        out[dev] = steps
    for i, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        if c[0] is None:
            assert g[0] is None and g[1] is None, i
            continue
        np.testing.assert_array_equal(g[0], c[0], err_msg=f"dirty, frame {i}")
        np.testing.assert_array_equal(g[1], c[1], err_msg=f"hints, frame {i}")
    assert out["cuda"][1][1] is not None and not out["cuda"][1][0].any()


@pytest.mark.gpu
def test_mesh_frontend_step_syncs_only_to_fetch():
    """A mesh step, static or changed, makes one synchronising call: the
    fetch of the dirty map and the hints together; the upload never syncs."""
    _need_card()
    import warnings

    from selkies_tpu_torch.parallel.codec_mesh import MeshDeltaFrontend

    frames = _mesh_trace()
    fe = MeshDeltaFrontend(336, 200, 4, devices=[torch.device("cuda")])
    for f in frames[:5]:  # warm-up: the vote's tables reach the card
        fe.step(f)
    counts = []
    for f in (frames[4].copy(), frames[5], frames[-1]):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fe.step(f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchronizing CUDA operation" in str(w.message) for w in seen))
    assert counts == [1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("row", ["tpuvp9enc", "tpuav1enc"])
def test_tile_column_rows_on_card_match_cpu(row, monkeypatch):
    """The registry's tile-column row (cols=2, the device front-end) on the
    card gives the AUs of the same row on the CPU (VP9 with libvpx's row-mt
    off), and its mesh front-end runs on the row's own card."""
    _need_card()
    from selkies_tpu_torch.models import libaom_enc, libvpx_enc
    from selkies_tpu_torch.models.registry import create_encoder
    from selkies_tpu_torch.parallel.codec_mesh import MeshDeltaFrontend

    if row == "tpuvp9enc" and not libvpx_enc.libvpx_available():
        pytest.skip("libvpx not loadable")
    if row == "tpuav1enc" and not libaom_enc.aom_strip_available():
        pytest.skip("the libaom strip path is not loadable")
    monkeypatch.setattr(libvpx_enc, "_row_mt_state", False)
    frames = _mesh_trace()
    shas = {}
    for dev in ("cuda", "cpu", None):
        enc = create_encoder(row, width=336, height=200, fps=30, cols=2, frontend="device",
                             device=dev)
        assert isinstance(enc._device_fe, MeshDeltaFrontend) and enc.cols == 2
        assert enc._device_fe.devices == [enc.device]
        if dev is None:
            assert enc.device.type == "cuda"
            enc.close()
            continue
        aus = []
        for i, f in enumerate(frames):
            if i == 6:
                enc.force_keyframe()
            aus.append(enc.encode_frame(f))
        enc.close()
        shas[dev] = [hashlib.sha256(au).hexdigest() for au in aus]
    assert shas["cuda"] == shas["cpu"]


# -- the solo serving app (selkies_tpu_torch/pipeline/app.py) ------------------
#
# The app's recording harness: tests/test_torch_app.py (the CPU parity tests)
# imports it from here, since this file imports no JAX.

class FakeTransport:
    """The app's byte plane: keeps every video frame and every data-channel
    message (as sent, JSON text)."""

    def __init__(self, ready: bool = True):
        self.frames = []
        self.messages: list[str] = []
        self.data_channel_ready = ready

    def send_data_channel(self, message: str) -> None:
        self.messages.append(message)

    async def send_video(self, frame) -> None:
        self.frames.append(frame)


PENDING = object()  # a logged call that has not returned yet


class RecordingEncoder:
    """Stands in for an encoder the app built: forwards every attribute,
    and logs each call that feeds or steers the stream (with what it
    returned) and each attribute set on it, so a fresh row fed the same
    log must give the same AUs. A call takes its place in the log when it
    starts: a ``force_keyframe`` from the event loop that lands while a
    worker thread's ``submit`` runs is ordered after that submit, whose
    frame kind was already decided; ``PENDING`` stands for its return
    until it returns."""

    CALLS = ("submit", "encode_frame", "flush", "force_keyframe", "prewarm", "close",
             "set_tile_cache", "set_batch_cap", "retune_entropy")

    def __init__(self, enc, name: str, kw: dict):
        self.__dict__.update(enc=enc, name=name, kw=kw, log=[])

    def __getattr__(self, attr):
        val = getattr(self.enc, attr)
        if attr not in self.CALLS:
            return val

        def call(*a, **k):
            entry = [attr, a, k, PENDING]
            self.log.append(entry)
            try:
                entry[3] = out = val(*a, **k)
            except Exception as exc:
                entry[3] = exc
                raise
            return out
        return call

    def __setattr__(self, attr, value):
        setattr(self.enc, attr, value)
        self.log.append(("set", attr, value, None))


def record_encoders(monkeypatch, app_mod) -> list:
    """Wrap every encoder ``app_mod`` builds in a RecordingEncoder; -> the
    list they are appended to, in build order."""
    built = []
    real = app_mod.create_encoder

    def create(name, **kw):
        rec = RecordingEncoder(real(name, **kw), name, kw)
        built.append(rec)
        return rec
    monkeypatch.setattr(app_mod, "create_encoder", create)
    return built


def _returned(attr, out) -> list:
    """-> [(au, stats, meta)] a logged call handed back."""
    if attr in ("submit", "flush"):
        return list(out)
    if attr == "encode_frame":
        return [(out, None, None)]
    return []


def logged_outputs(rec) -> list:
    """Every (au, stats, meta) the recorded encoder returned, in order."""
    return [o for attr, _, _, out in rec.log
            if not isinstance(out, Exception) and out is not PENDING
            for o in _returned(attr, out)]


def replay(rec, create, **overrides) -> list:
    """Build ``rec.name`` with ``rec``'s arguments (``overrides`` replace
    some, e.g. the device) through ``create``, feed it the logged calls,
    flush it, and return every (au, meta) it hands back. The first
    ``prewarm`` is left out: a prewarmed row codes as a fresh one; a later
    one (a session restart) resets the GOP and is replayed. A logged ``close``
    ends the calls: the close discarded the frames then in flight, and
    which those were depends on the clock, so a closed encoder's AUs are
    the head of its replay's."""
    enc = create(rec.name, **dict(rec.kw, **overrides))
    outs, coded = [], False
    try:
        for attr, a, k, out in rec.log:
            if attr == "close":
                break
            if attr == "set":
                setattr(enc, a, k)
            elif attr == "prewarm":
                if coded:
                    enc.prewarm()
            else:
                coded = coded or attr == "submit"
                outs += _returned(attr, getattr(enc, attr)(*a, **k))
        outs += enc.flush()
    finally:
        enc.close()
    return [(au, m) for au, _, m in outs]


def closed(rec) -> bool:
    """Whether the app closed the recorded encoder (a replaced one)."""
    return any(attr == "close" for attr, *_ in rec.log)


def sps_size(au: bytes) -> tuple[int, int]:
    """(width, height) an Annex-B AU's SPS codes (cropping applied)."""
    nal = au.split(b"\x00\x00\x00\x01")[1]
    assert nal[0] & 0x1F == 7, "the AU does not start with an SPS"
    rbsp = nal[1:].replace(b"\x00\x00\x03", b"\x00\x00")
    bits = "".join(f"{b:08b}" for b in rbsp)
    pos = 24  # profile_idc, constraint flags, level_idc

    def u(n):
        nonlocal pos
        pos += n
        return int(bits[pos - n:pos], 2)

    def ue():
        nonlocal pos
        z = bits.index("1", pos) - pos
        pos += z + 1
        return (1 << z) - 1 + (u(z) if z else 0)

    profile = rbsp[0]
    ue()  # seq_parameter_set_id
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        raise AssertionError(f"profile {profile}: not a stream this encoder writes")
    ue()  # log2_max_frame_num_minus4
    if ue() == 0:  # pic_order_cnt_type
        ue()
    ue()  # max_num_ref_frames
    u(1)
    w_mbs, h_mbs = ue() + 1, ue() + 1
    assert u(1) == 1, "frame_mbs_only"
    u(1)
    crop = [ue() for _ in range(4)] if u(1) else [0, 0, 0, 0]
    return 16 * w_mbs - 2 * (crop[0] + crop[1]), 16 * h_mbs - 2 * (crop[2] + crop[3])


def serve_app(app, until, timeout_s: float = 240.0, during=None):
    """Serve ``app`` until ``until(app)`` holds, then stop it; ``during``
    (a coroutine function, optional) is awaited once the first frame has
    gone out."""
    import asyncio
    import time as _time

    async def go():
        await app.start_pipeline()
        t0, called = _time.monotonic(), False
        try:
            while not until(app):
                if during is not None and not called and app.transport.frames:
                    called = True
                    await during()
                if _time.monotonic() - t0 > timeout_s:
                    raise TimeoutError(f"{len(app.transport.frames)} frames in {timeout_s} s")
                await asyncio.sleep(0.005)
        finally:
            await app.stop_pipeline()
    asyncio.run(go())


def _card_app(monkeypatch):
    """TorchWebRTCApp over SyntheticSource(W, H) with the registry row on
    the card, every encoder it builds recorded -> (app, recorders)."""
    from selkies_tpu_torch.pipeline import app as app_mod
    from selkies_tpu_torch.pipeline.elements import SyntheticSource

    built = record_encoders(monkeypatch, app_mod)
    app = app_mod.TorchWebRTCApp(source=SyntheticSource(W, H, seed=12), transport=FakeTransport(),
                                 framerate=60, video_bitrate_kbps=1500, device="cuda")
    return app, built


@pytest.mark.gpu
def test_app_on_card_matches_cpu_replay(monkeypatch):
    """The app serves the registry row on the card: its AUs (sent and
    flushed after the stop) equal the same calls replayed into the row on
    the CPU, the first is an IDR with the SPS, and K1 launched once per
    non-static P frame (counted after the prewarm)."""
    _need_card()
    from selkies_tpu_torch.models.registry import create_encoder

    app, built = _card_app(monkeypatch)
    real = built[0].enc
    orig = real.prewarm

    def prewarm():
        orig()
        me_mc.launches = 0
    real.prewarm = prewarm
    serve_app(app, lambda a: len(a.transport.frames) >= 24)
    built[0].flush()
    launched = me_mc.launches
    outs = logged_outputs(built[0])
    sent = [f.au for f in app.transport.frames]
    assert [au for au, _, _ in outs][:len(sent)] == sent and len(built) == 1
    assert sent[0].startswith(b"\x00\x00\x00\x01\x67") and sps_size(sent[0]) == (W, H)
    assert launched == sum(1 for _, st, _ in outs if not st.idr and st.upload_kind != "static")
    assert replay(built[0], create_encoder, device="cpu") == [(au, m) for au, _, m in outs]


@pytest.mark.gpu
def test_app_tick_never_syncs(monkeypatch):
    """Once warm, the app's ticks make no synchronising CUDA call on the
    threads that capture and submit (asyncio.to_thread's workers, whose
    thread changes from tick to tick) in the pattern of
    test_scheduled_tick_never_syncs."""
    _need_card()
    import threading
    import traceback
    import warnings

    app, _ = _card_app(monkeypatch)
    seen, state = [], {}

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.current_thread().name, str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    async def watch():
        import asyncio

        while len(app.transport.frames) < 8:  # warm-up: tables on the card
            await asyncio.sleep(0.005)
        state["from"] = len(app.transport.frames)
        torch.cuda.set_sync_debug_mode("warn")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        try:
            serve_app(app, lambda a: "from" in state
                      and len(a.transport.frames) >= state["from"] + 24, during=watch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [(name, st) for name, m, st in seen
             if "called a synchronizing CUDA operation" in m and name.startswith("asyncio")]
    assert not syncs, f"{len(syncs)} syncs; first in {syncs[0][0]} at:\n{syncs[0][1]}"


@pytest.mark.gpu
def test_app_restarts_return_device_memory():
    """Three ladder restarts at 1920x1080 (each a new card encoder, the old
    one closed) leave the card's resident memory within 2 MiB of one
    encoder's (an encoder holds ~15 MiB there), and the peak of each
    restarted run within 2 MiB of the first run's."""
    _need_card()
    import gc

    from selkies_tpu_torch.pipeline.app import TorchWebRTCApp
    from selkies_tpu_torch.pipeline.elements import SyntheticSource

    slack = 2 << 20

    def settled():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()

    app = TorchWebRTCApp(source=SyntheticSource(1920, 1080, seed=13),
                         transport=FakeTransport(), framerate=60, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    serve_app(app, lambda a: len(a.transport.frames) >= 12)
    one, one_peak = settled()
    runs = []
    for _ in range(3):
        app._restart_encoder()
        torch.cuda.reset_peak_memory_stats()
        n = len(app.transport.frames)
        serve_app(app, lambda a, n=n: len(a.transport.frames) >= n + 8)
        runs.append(settled())
    app.encoder.close()
    for resident, peak in runs:
        assert abs(resident - one) <= slack, (one, runs)
        assert peak <= one_peak + slack, (one_peak, runs)


# -- the fleet's serving core (selkies_tpu_torch/parallel/fleet.py) ---------------

def _card_fleet(n, devices=None):
    """SessionFleet over n slots with recording WebSocket planes at 320x192
    (``devices=None``: the card through the pool)."""
    from selkies_tpu_torch.parallel.fleet import SessionFleet, SessionSlot

    slots = [SessionSlot(k, bitrate_kbps=2000, fps=30, ws=FakeTransport()) for k in range(n)]
    return SessionFleet(slots, width=W, height=H, fps=30, devices=devices)


def _drive_card_fleet(fleet, ticks):
    """-> per tick (AU sha256s, K1 launches inside _encode_tick)."""
    out = []
    for t in range(ticks):
        if t == 2:
            fleet.force_keyframe(1)
        fleet._capture_batch()
        k0 = me_mc.launches
        aus, idrs, _, _ = fleet._encode_tick()
        out.append(([hashlib.sha256(au).hexdigest() for au in aus], me_mc.launches - k0))
        for slot, au, idr in zip(fleet.slots, aus, idrs):
            slot.rc.update(len(au), idr=idr)
    return out


@pytest.mark.gpu
def test_fleet_devices_none_runs_on_the_card():
    """SessionFleet(devices=None) builds its batch service on the card
    (through the device pool), launches K1 once per tick with a P session,
    and gives the AUs of the same fleet on the CPU."""
    _need_card()
    from selkies_tpu_torch.resilience import reset_device_pool

    reset_device_pool()
    fleet = _card_fleet(3)
    try:
        assert fleet.service.device.type == "cuda"
        got = _drive_card_fleet(fleet, 5)
    finally:
        fleet.service.close()
        reset_device_pool()
    cpu = _card_fleet(3, devices=[torch.device("cpu")])
    try:
        want = _drive_card_fleet(cpu, 5)
    finally:
        cpu.service.close()
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[1] for g in got] == [0, 1, 1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("occupancy", ["1", "0"], ids=["scheduled", "serial"])
def test_fleet_encode_tick_never_syncs(monkeypatch, occupancy):
    """The fleet's _encode_tick on the card, the scheduler's lanes and
    workers or the serial tick, makes no synchronising CUDA call on any
    thread: each wait is on the tick's own events."""
    _need_card()
    import threading
    import traceback
    import warnings

    monkeypatch.setenv("SELKIES_OCCUPANCY", occupancy)
    fleet = _card_fleet(3, devices=[torch.device("cuda")])
    for _ in range(2):  # warm-up: tables reach the card, the kernel builds
        fleet._capture_batch()
        fleet._encode_tick()
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.current_thread().name, str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    aus = []
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for t in range(4):
                    if t == 1:
                        fleet.force_keyframe(2)  # an IDR among P sessions
                    fleet._capture_batch()
                    aus.append(fleet._encode_tick()[0])
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        if fleet._occ is not None:
            fleet._occ.close()
        fleet.service.close()
    syncs = [(name, st) for name, m, st in seen if "called a synchronizing CUDA operation" in m]
    assert not syncs, f"{len(syncs)} syncs; first in {syncs[0][0]} at:\n{syncs[0][1]}"
    assert len(aus) == 4 and all(au.startswith(b"\x00\x00\x00\x01") for a in aus for au in a)


# -- the solo server (selkies_tpu_torch/orchestrator.py) -----------------------------

@pytest.mark.gpu
def test_server_session_on_card_launches_k1_and_never_syncs(monkeypatch, tmp_path):
    """``Orchestrator(cfg)`` (device None: the card) at 640x384 serves a
    client over /media: once warm, its ticks make no synchronising CUDA
    call on the threads that capture and submit, and K1 launched once per
    non-static P frame the recorded encoder coded (the prewarm's apart)."""
    _need_card()
    import asyncio
    import threading
    import traceback
    import warnings

    import aiohttp

    from selkies_tpu_torch.config import FLAGS, Config
    from selkies_tpu_torch.input_host import FakeBackend, MemoryClipboard
    from selkies_tpu_torch.orchestrator import Orchestrator
    from selkies_tpu_torch.pipeline import app as app_mod
    from selkies_tpu_torch.transport.websocket import KIND_VIDEO, parse_media_frame

    for k in ("DISPLAY", "SELKIES_CLUSTER_PEERS", "SELKIES_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    values = {fl.name: fl.default for fl in FLAGS}
    values.update(addr="127.0.0.1", port=0, capture_width=640, capture_height=384,
                  framerate=60, video_bitrate=4000, enable_cursors=False,
                  json_config=str(tmp_path / "c.json"), rtc_config_json=str(tmp_path / "rtc.json"))
    built = record_encoders(monkeypatch, app_mod)
    seen, state = [], {}

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((threading.current_thread().name, str(message),
                     "".join(traceback.format_stack(limit=8)[:-1])))

    async def scenario():
        orch = Orchestrator(Config(values=values))
        assert orch.device.type == "cuda" and orch.device_mon is not None
        orch.input.backend, orch.input.clipboard = FakeBackend(), MemoryClipboard()
        real = built[0].enc
        orig = real.prewarm

        def prewarm():
            orig()
            state["k0"] = me_mc.launches
        real.prewarm = prewarm
        task = asyncio.ensure_future(orch.run())
        while orch.server._runner is None or not orch.server._runner.addresses:
            await asyncio.sleep(0.05)
        frames = 0
        async with aiohttp.ClientSession() as http:
            ws = await http.ws_connect(f"http://127.0.0.1:{orch.server.bound_port}/media")
            while frames < 48:
                msg = await asyncio.wait_for(ws.receive(), 120)
                if msg.type == aiohttp.WSMsgType.BINARY and \
                        parse_media_frame(msg.data)[0] == KIND_VIDEO:
                    frames += 1
                    if frames == 16:  # warm: tables on the card, the kernel built
                        torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode("default")
            await ws.close()
            while orch.app.pipeline is not None and orch.app.pipeline.running:
                await asyncio.sleep(0.05)
        for t in orch._tasks:  # the in-process signalling client's /ws
            if t.get_coro().__name__ == "_signalling_loop":
                t.cancel()
        await orch.server.stop()
        await asyncio.wait_for(task, 60)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        try:
            asyncio.run(scenario())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    built[0].flush()
    launched = me_mc.launches - state["k0"]
    outs = logged_outputs(built[0])
    syncs = [(name, st) for name, m, st in seen
             if "called a synchronizing CUDA operation" in m and name.startswith("asyncio")]
    assert not syncs, f"{len(syncs)} syncs; first in {syncs[0][0]} at:\n{syncs[0][1]}"
    p_frames = sum(1 for _, st, _ in outs if not st.idr and st.upload_kind != "static")
    assert p_frames > 0 and launched == p_frames
    assert sps_size(outs[0][0]) == (640, 384)


@pytest.mark.gpu
def test_webrtc_session_on_card_launches_k1(monkeypatch, tmp_path):
    """``Orchestrator(cfg)`` (device None: the card) at 640x368 serves
    chip_smoke.py's RtcBrowser over WebRTC (no STUN server): the AUs the
    browser depayloads are the head of what the recorded row returned, the
    first a keyframe with its SPS, and K1 launched once per non-static P
    frame the row coded (the prewarm's apart)."""
    _need_card()
    import asyncio
    import json

    import aiohttp

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from selkies_tpu_torch.config import FLAGS, Config
    from selkies_tpu_torch.input_host import FakeBackend, MemoryClipboard
    from selkies_tpu_torch.orchestrator import Orchestrator
    from selkies_tpu_torch.pipeline import app as app_mod

    for k in ("DISPLAY", "SELKIES_CLUSTER_PEERS", "SELKIES_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    (tmp_path / "rtc.json").write_text(json.dumps({"iceServers": []}))
    values = {fl.name: fl.default for fl in FLAGS}
    values.update(addr="127.0.0.1", port=0, capture_width=640, capture_height=368,
                  framerate=60, video_bitrate=4000, enable_cursors=False,
                  json_config=str(tmp_path / "c.json"), rtc_config_json=str(tmp_path / "rtc.json"))
    built = record_encoders(monkeypatch, app_mod)
    state = {}

    async def scenario():
        orch = Orchestrator(Config(values=values))
        assert orch.device.type == "cuda"
        orch.input.backend, orch.input.clipboard = FakeBackend(), MemoryClipboard()
        real = built[0].enc
        orig = real.prewarm

        def prewarm():
            orig()
            state["k0"] = me_mc.launches
        real.prewarm = prewarm
        task = asyncio.ensure_future(orch.run())
        while orch.server._runner is None or not orch.server._runner.addresses:
            await asyncio.sleep(0.05)
        async with aiohttp.ClientSession() as http:
            b = cs.RtcBrowser()
            ws, sig, fb, _ = await cs._rtc_connect(
                http, f"http://127.0.0.1:{orch.server.bound_port}", b)
            while len(b.aus) < 48:
                await asyncio.sleep(0.05)
            await cs._rtc_leave(ws, sig, fb, b)
            while orch.app.pipeline is not None and orch.app.pipeline.running:
                await asyncio.sleep(0.05)
        for t in orch._tasks:  # the in-process signalling client's /ws
            if t.get_coro().__name__ == "_signalling_loop":
                t.cancel()
        await orch.server.stop()
        await asyncio.wait_for(task, 60)
        state["frames"] = (orch.ws_transport.frames_sent, orch.webrtc.frames_sent)
        return b

    b = asyncio.run(scenario())
    built[0].flush()
    launched = me_mc.launches - state["k0"]
    outs = logged_outputs(built[0])
    aus = [au for _, _, au in b.aus]
    assert [au for au, _, _ in outs][:len(aus)] == aus and not b.receiver.frames_frozen
    assert sps_size(aus[0]) == (640, 368) and state["frames"][0] == 0
    p_frames = sum(1 for _, st, _ in outs if not st.idr and st.upload_kind != "static")
    assert p_frames > 0 and launched == p_frames
