#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (selkies_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --no-timing  # phases 1-9 only (a build-and-check run)

Phases, in order; any failure exits non-zero and prints no result:

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build the ME/MC kernel (nvcc, sm_90a), the native CAVLC packer and the
   frameprep library (g++) from the checkout's sources, all at once; print
   build seconds and the ``-Xptxas -v`` report; read the kernel's SASS
   (``cuobjdump -sass``) for the native 4-way byte SAD instruction that
   sets its operation floor;
3. hold the ME/MC kernel against its plain PyTorch version on the card at
   1920x1088 on three seeded cases (static, uniform motion, motion near the
   search reach with noise), on a tile-clamped candidate list, at a
   width whose last strip of 8 MBs is ragged (1376x768), and at the band
   path's 4K shapes: a 720x1920 tile of the 3x2 grid and a 720x3840 band,
   each on its reference slab, unclamped and clamped by 16-pixel halos,
   and the whole 2160x3840 frame; and the batched kernel (one launch over
   a session axis, each session with its own seeded motion and candidate
   list) against its batched plain version at 8 x 1088x1920 and at
   3 x 768x1376: every output exactly equal;
4. the device-conversion path: TorchH264Encoder(1920, 1080,
   host_convert=False, pipeline_depth=0, frame_batch=1, device="cuda")
   over a seeded desktop-like trace
   (IDR, scrolls, typing, a static repeat, force_keyframe, a QP change)
   with the launch counters zeroed just before; every access unit's sha256
   must equal the same trace on the CPU, the kernel must have launched once
   per non-static P frame and the native packer at least once;
5. the host-conversion path, ungrouped and unpipelined:
   TorchH264Encoder(1920, 1080, scene_qp_boost=6, frame_batch=1,
   pipeline_depth=0, ltr_scenes=False, device="cuda") over a
   seeded 1080p desktop trace that produces every frame kind (IDR, static,
   delta with uploads, scene cut with the QP boost and pool seeding,
   another over-budget full P, remap-only delta, forced IDR over a static
   frame, forced IDR on a delta frame, a scroll of remaps + uploads, damage
   hints), counters zeroed just before; each kind is asserted from
   FrameStats and the link-byte counters, every AU's sha256 must equal the
   CPU run's, K1 must have launched once per non-static P frame, the native
   sparse packer at least once, and the frameprep library must be the one
   built from ``native/frameprep.cc``;
6. the registry row: TorchH264Encoder(1920, 1080, scene_qp_boost=6,
   device="cuda") with its defaults (groups of 4, pipeline depth 2, the LTR
   scene cache) over a seeded 1080p trace (IDR, a group of 4 typing
   deltas, a group of 2 closed by a static frame, a window switch with the
   scene cut, a typed delta carrying the long-term marking, two switches
   back that restore from the scene cache, a scroll of remaps and uploads,
   a forced IDR that clears the slots, another group), counters zeroed
   just before, every AU collected across submit and flush; the AUs must
   equal the CPU run's and an ungrouped, unpipelined card run's (LTR on),
   with ltr_restores >= 2, a group of 4 and one of 2 dispatched, K1 launched
   once per non-static P frame, the native sparse packer run and the up_*
   link bytes equal to the CPU run's;
7. the entropy plane at 1920x1080, qp 28, on the card, over a short seeded
   trace (IDR, a quiet typed line, a scene cut, two busy window scrolls, an
   LTR restore, a static frame, an entropy retune before a static frame and
   a typed line): (a) the registry row with device_entropy=True,
   bits_min_mbs=64 must give the registry row's own CAVLC AUs; (c) the row
   with entropy_coder="cabac", device_entropy=True must give (b)'s, the row
   with the host CABAC coder; (b) and (d), the device-conversion path with
   CABAC, must equal their CPU runs; the busy frames ship "bits" in (a) and
   "cabac" in (c), the quiet one "coeff"; the retune to CAVLC forces an IDR
   in (b) and (c); K1 launched once per non-static P frame in every card
   run and the native CABAC engine ran;
8. band and tile slicing (TorchBandedH264Encoder, selkies_tpu_torch/
   parallel/bands.py): (a) at 1920x1080 over a seeded full-motion trace
   (IDR, two busy scrolls, a window, its drag across the band seams, a
   static frame, a forced IDR), bands=4 (4 bands of 17 MB rows), bands=4
   with cols=2, and bands=4 with entropy_coder="cabac", device_entropy=True
   on light content: every AU's sha256 must equal the port's CPU run of the
   trace, K1 must launch bands x cols times per non-static P frame; (b) at
   3840x2160 on the card alone: cols=2, bands=3 (45x120-MB tiles) must give
   the AUs of bands=3, bands=1 those of TorchH264Encoder(frame_batch=1,
   pipeline_depth=0, ltr_scenes=False), and bands=4 must resolve to 3;
9. multi-session serving (TorchMultiSessionH264Service, selkies_tpu_torch/
   parallel/serving.py): (a) 8 sessions of 1920x1088, qp 28, over a seeded
   6-tick trace (an IDR tick, two P ticks where each session scrolls or
   types its own desktop, set_qp on two sessions and a forced keyframe on
   one, a mixed tick with two forced sessions, a P tick), counters zeroed
   just before: every session's AUs must equal a solo TorchH264Encoder
   (host_convert=False, frame_batch=1, pipeline_depth=0) fed the same
   frames, QPs and keyframes, and K1 must launch exactly once per tick
   with a P session; (b) the same trace at 4 x 640x368 must equal the
   port's CPU run of the service;
10. time the kernel with CUDA events over 50 launches queued behind a spin
   kernel (the device's time; also as the host issues them), its plain
   version, the device-conversion encoder per frame for IDR and P, the
   host-conversion encoder's median FrameStats split per frame kind
   (classify / convert / h2d / step / fetch / unpack / cavlc ms, up and
   down bytes), and with torch.profiler the device's busy and idle share
   over IDR, P and delta-P frames; over a 1080p typing run, the registry
   row against frame_batch=1, pipeline_depth=0 (and each knob alone, in
   turns, twice each): frames per second, median
   and p95 latency from a frame's submit() call to the return of the call
   that hands back its AU, the FrameStats split, and the device idle share
   over 8 grouped typing deltas; for each coder with device entropy off
   and on, the FrameStats split and down bytes of 1080p full-P and
   window-scroll delta frames, the device-entropy downlink alone by CUDA
   events at the top bucket and at the smallest bucket that holds the
   frame, and the device op count and idle share of those frames
   (torch.profiler); on the 1080p full-motion trace, the median
   FrameStats split per frame kind (step, per-band step min/max, fetch,
   unpack, pack, AU, up and down bytes) of the flat solo encoder, bands=4,
   a 2x2 grid and the 4K 3x2 grid, and the device ops and idle share of
   solo and bands=4 P frames (torch.profiler); the multi-session service
   at 1, 2, 4 and 8 sessions of 1920x1088 on full motion: the IDR tick,
   the median P tick split (convert / h2d / dispatch / step / fetch /
   pack ms), frames per second, a mixed tick with one IDR, the device ops
   and idle share per P tick (torch.profiler; an 8-session tick must issue
   at most 1.25x the 1-session tick's ops) and peak device memory; the
   same frames through 8 solo flat encoders in turn; and the batched
   kernel at 8 x 1088x1920 by CUDA events against its byte bound;
11. print the ``{"kernels": [...]}`` line (K1 at the solo shape and as the
    8-session launch), then the ``{"ok": true, ...}`` line.

The full record is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

W, H = 1920, 1080
# H100 SXM published peaks: HBM 3.35 TB/s, 67 TFLOP/s fp32. int32 has no
# published peak: 64 int32 lanes per SM x 132 SMs x 1.98 GHz (the clock that
# gives 67 TFLOP/s fp32 from 128 fp32 lanes per SM).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _planes(h, w, seed, motion, noise, dev):
    import torch

    rng = np.random.default_rng(seed)
    # blocky content with texture: coarse voting finds the global motion
    cur = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8), np.int64))
    cur = np.clip(cur + rng.integers(-20, 21, cur.shape), 0, 255)
    ref = np.roll(cur, motion, (0, 1))
    if noise:
        ref = ref + rng.integers(-noise, noise + 1, ref.shape)
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    cu = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    cv = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(cur.astype(np.int32)), t(ref), t(cu), t(cv)


def _me_inputs(case, dev):
    """case: (seed, motion, noise[, (h, w)[, _refine_cands clamps]])."""
    from selkies_tpu_torch.models.h264 import encoder_core as core

    seed, motion, noise, *rest = case
    (h, w), clamp = (rest + [(1088, 1920), {}][len(rest):])
    cur, ref, cu, cv = _planes(h, w, seed, motion, noise, dev)
    pads = [core.edge_pad(p, core.MV_PAD) for p in (ref, cu, cv)]
    cands = core._refine_cands(core.coarse_vote_candidates(cur, ref), **clamp)
    return (cands, cur, *pads)


def _slab_me_inputs(case, dev):
    """case: (seed, motion, noise, (fh, fw), (r0, c0, h, w), (halo, halo_cols)).
    The kernel's inputs for the (h, w) tile at (r0, c0) of an (fh, fw)
    frame as the band and tile steps build them (encode_tile_p_planes): a
    reference slab of ``halo`` real rows and ``halo_cols`` real columns
    round the tile (chroma: half; 0 takes the whole axis), clipped at the
    picture's edges, edge-padded out to MV_PAD, and the candidate window
    clamped to ``halo - 2`` on an axis whose halo is below the full reach."""
    import torch

    from selkies_tpu_torch.models.h264 import encoder_core as core

    seed, motion, noise, (fh, fw), (r0, c0, h, w), (halo, hc) = case
    cur, ref, cu, cv = _planes(fh, fw, seed, motion, noise, dev)

    def axis(n, start, size, hv):
        if hv == 0:
            return torch.arange(n, device=dev)
        return torch.arange(start - hv, start + size + hv, device=dev).clamp(0, n - 1)

    def slab(p, s):
        hv, hh = halo >> s, hc >> s
        rows, cols = axis(p.shape[0], r0 >> s, h >> s, hv), axis(p.shape[1], c0 >> s, w >> s, hh)
        sl = p.index_select(0, rows).index_select(1, cols)
        vt, ht = core.MV_PAD - hv, core.MV_PAD - hh
        return core.edge_pad(sl, vt, vt, ht, ht)

    full_reach = core.COARSE_DS * core.COARSE_R + core.REFINE_R + 2
    clamp = {k: (None if v == 0 or v >= full_reach else v - 2)
             for k, v in (("dy_max", halo), ("dx_max", hc))}
    tile = cur[r0:r0 + h, c0:c0 + w]
    cands = core._refine_cands(
        core.coarse_vote_candidates(tile, ref[r0:r0 + h, c0:c0 + w]), **clamp)
    return (cands, tile.contiguous(), slab(ref, 0), slab(cu, 1), slab(cv, 1))


def _sass_check(lib_path: Path, nvcc: str) -> dict:
    """Count the kernel's native 4-way byte SAD instructions (VABSDIFF4) in
    its SASS. Each instantiation's SAD loop is unrolled over one 16x16
    block: 64 of them means one instruction per 4 pixels and candidate."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs = out.split("Function : ")[1:]
    per_kernel = [f.count("VABSDIFF4") for f in funcs]
    if not per_kernel:
        _fail("cuobjdump shows no kernel in the ME/MC library")
    # the opcode mix of the 16-byte-aligned instantiation (the main path's)
    vec = next((f for f in funcs if "ILb1E" in f.split()[0]), funcs[0])
    mix = {op: len(re.findall(rf"\b{op}[.\s]", vec)) for op in
           ("VABSDIFF4", "SHF", "LDS", "IADD3", "LDGSTS", "STG", "BAR")}
    return {"vabsdiff4_per_kernel": per_kernel, "native_simd4": min(per_kernel) == 64,
            "opcodes_vec_kernel": mix}


def _desktop_trace():
    """Seeded 1080p BGRx desktop trace: block wallpaper with text-like rows,
    two scrolls, a typing patch, a static repeat, a pan, a window change."""
    rng = np.random.default_rng(2026)
    base = np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))
    base = base[:H]
    glyphs = rng.integers(0, 2, (H // 4, W // 2, 1), np.uint8) * 180
    base[::4, ::2, :3] = np.minimum(base[::4, ::2, :3] + glyphs, 255)
    frames = [base]
    cur = base
    for dy in (16, 24):  # scrolls
        cur = np.roll(cur, -dy, 0)
        frames.append(cur)
    cur = cur.copy()
    cur[500:516, 300:900, :3] = rng.integers(0, 255, (16, 600, 3), np.uint8)  # typing
    frames += [cur, cur.copy()]  # then a static repeat
    frames.append(np.roll(cur, (6, -10), (0, 1)))  # pan (the IDR is forced here)
    frames.append(np.roll(frames[-1], 12, 1))  # QP change here
    win = frames[-1].copy()
    win[200:700, 400:1400] = rng.integers(0, 255, (500, 1000, 4), np.uint8)
    frames.append(win)
    return frames


def _drive(enc, frames):
    """-> [(sha256, FrameStats)] with force_keyframe at 5 and qp 34 at 6."""
    out = []
    for i, f in enumerate(frames):
        if i == 5:
            enc.force_keyframe()
        (au, stats, _), = enc.submit(f, qp=34 if i == 6 else None)
        if not au.startswith(b"\x00\x00\x00\x01"):
            _fail(f"frame {i}: access unit is not Annex-B")
        out.append((hashlib.sha256(au).hexdigest(), stats))
    return out


def _host_frames(seed: int):
    """1080p BGRx building blocks of the host-conversion traces: a block
    wallpaper, a 1024x528 tile-aligned window of new content over it, the
    wallpaper with a typed line, and the window scrolled up 16 rows with a
    new line at its bottom."""
    rng = np.random.default_rng(seed)
    a = np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))[:H]
    a[::4, ::3, :3] = rng.integers(0, 255, a[::4, ::3, :3].shape, np.uint8)
    win = a.copy()
    win[192:720, 384:1408] = rng.integers(0, 255, (528, 1024, 4), np.uint8)
    typed = a.copy()
    typed[500:516, 300:700, :3] = 255 - typed[500:516, 300:700, :3]
    scrolled = win.copy()
    scrolled[192:704, 384:1408] = win[208:720, 384:1408]
    scrolled[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
    return a, win, typed, scrolled


# the frame kinds of the host-conversion path, as _host_kind names them
HOST_KINDS = ("idr", "static", "delta_upload", "scene_cut_seed", "full_seed", "remap_only",
              "idr_resident", "idr_delta", "delta_mixed")
BOOST = 6


def _host_trace():
    """-> [(frame, op, damage, expected kind)] producing every kind."""
    a, win, typed, scrolled = _host_frames(2027)
    patched = win.copy()
    patched[900:916, 100:300, :3] = 9
    scrolled = scrolled.copy()
    scrolled[900:916, 100:300, :3] = 9
    cursor = scrolled.copy()
    cursor[60:76, 1500:1512, :3] = 250
    return [
        (a, None, None, "idr"),
        (a.copy(), None, None, "static"),
        (typed, None, [(300, 500, 400, 16)], "delta_upload"),
        (win, None, None, "scene_cut_seed"),
        (typed.copy(), None, None, "full_seed"),
        (win.copy(), None, None, "remap_only"),
        (win.copy(), "idr", None, "idr_resident"),
        (patched, "idr", None, "idr_delta"),
        (scrolled, None, None, "delta_mixed"),
        (cursor, None, [(1500, 60, 12, 16), (0, 0, 2, 2)], "delta_upload"),
        (cursor.copy(), None, [], "static"),
    ]


def _host_kind(prev_links: dict, links: dict, st, base_qp: int) -> str:
    """A host-path frame's kind from its FrameStats and the link-byte
    counters' growth over the frame."""
    grew = {k for k, v in links.items() if v != prev_links.get(k, 0)}
    if st.idr:
        if not grew & {"up_full", "up_delta"}:
            return "idr_resident"
        return "idr_delta" if "up_delta" in grew else "idr"
    if st.upload_kind == "static":
        return "static"
    if st.upload_kind == "full":
        if "up_seed" not in grew:
            return "full"
        return "scene_cut_seed" if st.scene_cut and st.qp == base_qp + BOOST else "full_seed"
    if st.remap_frac == 1.0:
        return "remap_only"
    return "delta_upload" if st.remap_frac == 0.0 else "delta_mixed"


def _drive_host(enc, trace, base_qp=28):
    """-> [(sha256, FrameStats, kind, up bytes, down bytes)]."""
    out = []
    prev = enc.link_bytes.snapshot()
    for i, (frame, op, damage, _) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        (au, st, _), = enc.submit(frame, damage=damage)
        if not au.startswith(b"\x00\x00\x00\x01"):
            _fail(f"host frame {i}: access unit is not Annex-B")
        links = enc.link_bytes.snapshot()
        grown = {k: v - prev.get(k, 0) for k, v in links.items()}
        out.append((hashlib.sha256(au).hexdigest(), st, _host_kind(prev, links, st, base_qp),
                    sum(v for k, v in grown.items() if k.startswith("up_")),
                    sum(v for k, v in grown.items() if k.startswith("down_"))))
        prev = links
    return out


def _host_timing_trace(rounds: int):
    """Rounds of every kind for the per-kind timing: a new wallpaper each
    round (forced IDR, static), four typed lines one after another (the
    first re-codes the IDR's quantisation tail, the next three are steady
    typing deltas), a forced IDR over the static screen, a window over it
    (full P with seeding), the typed screen and the window again (remaps),
    the window scrolled (remaps + uploads), a forced IDR on a delta frame."""
    trace = []
    for r in range(rounds):
        a, win, _, scrolled = _host_frames(100 + r)
        typed = [a]
        for k in range(4):
            t = typed[-1].copy()
            rows = slice(400 + 32 * k, 416 + 32 * k)
            t[rows, 300:700, :3] = 255 - t[rows, 300:700, :3]
            typed.append(t)
        patched = typed[-1].copy()
        patched[900:916, 100:300, :3] = 9
        trace += [(a, "idr", None, ""), (a.copy(), None, None, "")]
        trace += [(t, None, None, "") for t in typed[1:]]
        trace += [(typed[-1].copy(), "idr", None, ""), (win, None, None, ""),
                  (typed[-1].copy(), None, None, ""), (win.copy(), None, None, ""),
                  (scrolled, None, None, ""), (patched, "idr", None, "")]
    return trace


def _type(frame, rng, row: int, col: int, width: int = 400):
    """A copy of ``frame`` with one 16-row line of glyph noise typed in."""
    f = frame.copy()
    f[row:row + 16, col:col + width, :3] = rng.integers(0, 255, (16, width, 3), np.uint8)
    return f


def _registry_trace():
    """-> [(frame, op)], 19 frames at 1080p: desktop A (IDR), four typing
    deltas (a group of 4), two more (a group of 2) closed by a static frame,
    a switch to desktop B (A under a 1024x528 window: the scene cut), a
    line typed in B's window (its slice carries B's long-term marking),
    back to A's last capture and to B's (two restores from the scene
    cache), two 16-row scrolls of the window (remaps plus a new line of
    uploads), a forced IDR on the static screen (it clears the slots) and
    four typing deltas after it."""
    a, win, _, _ = _host_frames(2028)
    rng = np.random.default_rng(2029)
    typing = [a]
    for k in range(6):
        typing.append(_type(typing[-1], rng, 300 + 32 * k, 200))
    b_typed = _type(win, rng, 400, 500)
    scrolls = [b_typed]
    for _ in range(2):
        s = scrolls[-1].copy()
        s[192:704, 384:1408] = scrolls[-1][208:720, 384:1408]
        s[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
        scrolls.append(s)
    after = [scrolls[-1]]
    for k in range(4):
        after.append(_type(after[-1], rng, 900, 100 + 400 * k))
    return ([(a, None)] + [(f, None) for f in typing[1:]] + [(typing[-1].copy(), None)]
            + [(win, None), (b_typed, None), (typing[-1], None), (b_typed, None)]
            + [(f, None) for f in scrolls[1:]] + [(scrolls[-1].copy(), "idr")]
            + [(f, None) for f in after[1:]])


def _drive_registry(enc, trace):
    """Every AU of the trace, collected across submit() and flush() ->
    ([(sha256, FrameStats)] in frame order, up_* link bytes)."""
    outs = []
    for i, (frame, op) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        outs += enc.submit(frame, meta=i)
    outs += enc.flush()
    if [m for *_, m in outs] != list(range(len(trace))):
        _fail(f"registry path returned frames {[m for *_, m in outs]}")
    if not all(au.startswith(b"\x00\x00\x00\x01") for au, *_ in outs):
        _fail("registry path: an access unit is not Annex-B")
    ups = {k: v for k, v in enc.link_bytes.snapshot().items() if k.startswith("up_")}
    return [(hashlib.sha256(au).hexdigest(), st) for au, st, _ in outs], ups


def _typing_run(n: int, seed: int):
    """Desktop A, then n frames each typing one more line somewhere on it."""
    a, *_ = _host_frames(seed)
    rng = np.random.default_rng(seed + 1)
    frames = [a]
    for i in range(n):
        frames.append(_type(frames[-1], rng, 64 + 16 * (i % 60), 100 + (i * 37) % 1200))
    return frames


def _time_typing(cfg: dict, frames, warm: int) -> dict:
    """Frames per second, per-frame latency (a frame's submit() call to the
    return of the call that hands back its AU) and the median FrameStats
    split over frames[1 + warm:], after an IDR and ``warm`` deltas, on a
    fresh encoder of configuration ``cfg``. The frames are submitted back to
    back, not paced to a capture rate."""
    import torch
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

    enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **cfg)
    for f in frames[:1 + warm]:
        enc.submit(f)
    enc.flush()
    torch.cuda.synchronize()
    t_sub, lat, stats = {}, {}, {}

    def take(outs):
        now = time.perf_counter()
        for _, st, m in outs:
            lat[m], stats[m] = (now - t_sub[m]) * 1e3, st
    t0 = time.perf_counter()
    for i, f in enumerate(frames[1 + warm:]):
        t_sub[i] = time.perf_counter()
        take(enc.submit(f, meta=i))
    take(enc.flush())
    wall = time.perf_counter() - t0
    enc.close()
    n = len(t_sub)
    if len(lat) != n or any(st.upload_kind != "delta" for st in stats.values()):
        _fail(f"typing run {cfg}: {len(lat)} of {n} frames, kinds "
              f"{sorted({st.upload_kind for st in stats.values()})}")
    lats = sorted(lat.values())
    out = {"frames": n, "fps": n / wall, "latency_ms_median": statistics.median(lats),
           "latency_ms_p95": lats[-(-95 * n // 100) - 1], "latency_ms_max": lats[-1],
           "group_sizes": dict(enc.group_sizes)}
    for k in ("classify_ms", "convert_ms", "h2d_ms", "upload_ms", "step_ms", "fetch_ms",
              "unpack_ms", "cavlc_ms", "pack_ms", "device_ms", "bytes"):
        out[k] = statistics.median(getattr(st, k) for st in stats.values())
    return out


def _overlay(base, lift: int = 24):
    """``base`` under a dialog backdrop that lightens a 1280x432 region by
    ``lift``: 270 dirty tiles, over the delta budget, so a full P frame
    whose coded slice stays within the token cap."""
    w = base.copy()
    w[224:656, 320:1600, :3] = np.clip(base[224:656, 320:1600, :3].astype(np.int16) + lift,
                                       0, 255).astype(np.uint8)
    return w


def _scroll_window(frame, rng):
    """The backdrop region of ``frame`` scrolled up 16 rows, a new row of
    16x16 blocks at its bottom."""
    s = frame.copy()
    s[224:640, 320:1600] = frame[240:656, 320:1600]
    s[640:656, 320:1600] = np.kron(rng.integers(30, 250, (1, 80, 4), np.uint8),
                                   np.ones((16, 16, 1), np.uint8))
    return s


def _block_wallpaper(rng):
    """A 1080p wallpaper of flat 16x16 blocks: its IDR leaves no
    quantisation tail for the next P frames to re-code."""
    return np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))[:H]


def _entropy_trace():
    """-> [(frame, op)], 10 frames at 1080p: desktop A (IDR), two typed
    lines (quiet deltas), a dialog backdrop over A (a full-P scene cut),
    two 16-row scrolls of the backdrop region (busy deltas), back to the
    typed A (an LTR restore), a static frame, then ("switch": flush and
    retune the entropy knobs first) the static screen again and a third
    typed line."""
    rng = np.random.default_rng(2031)
    a = _block_wallpaper(rng)
    a1 = _type(a, rng, 304, 208)  # MB-aligned lines of 25 MBs
    a2 = _type(a1, rng, 352, 208)
    scrolls = [_overlay(a2)]
    for _ in range(2):
        scrolls.append(_scroll_window(scrolls[-1], rng))
    return [(a, None), (a1, None), (a2, None), (scrolls[0], None), (scrolls[1], None),
            (scrolls[2], None), (a2, None), (a2.copy(), None), (a2.copy(), "switch"),
            (_type(a2, rng, 400, 208), None)]


def _drive_entropy(enc, trace, switch: dict):
    """Every AU of the trace, collected across submit() and flush(); before
    a "switch" frame the encoder is flushed and ``retune_entropy(**switch)``
    called. -> ([(sha256, FrameStats)] in frame order, the retune's answer,
    K1 launches, LTR restores)."""
    from selkies_tpu_torch.models.h264 import me_mc

    me_mc.launches = 0
    outs, answer = [], None
    for i, (frame, op) in enumerate(trace):
        if op == "switch":
            outs += enc.flush()
            answer = enc.retune_entropy(**switch)
        outs += enc.submit(frame, meta=i)
    outs += enc.flush()
    launches = me_mc.launches
    enc.close()
    if [m for *_, m in outs] != list(range(len(trace))):
        _fail(f"entropy path returned frames {[m for *_, m in outs]}")
    if not all(au.startswith(b"\x00\x00\x00\x01") for au, *_ in outs):
        _fail("entropy path: an access unit is not Annex-B")
    rows = [(hashlib.sha256(au).hexdigest(), st) for au, st, _ in outs]
    p = sum(1 for _, st in rows if not st.idr and st.upload_kind != "static")
    if enc.device.type == "cuda" and launches != p:  # the CPU runs the plain version
        _fail(f"me_mc launched {launches} times for {p} non-static P frames (entropy path)")
    return rows, answer, launches, enc.ltr_restores


def _entropy_timing_frames(rounds: int):
    """A block wallpaper (a cheap IDR), then per round a dialog backdrop
    over it, lightening and darkening in turn (a full P frame), and its
    region scrolled by 16 rows with a new row of blocks (a delta with
    remaps and a busy slice)."""
    rng = np.random.default_rng(2040)
    a = _block_wallpaper(rng)
    trace = [(a, None, None, "")]
    for r in range(rounds):
        win = _overlay(a, (24 + 8 * r) * (-1) ** r)  # a new backdrop every round
        trace += [(win, None, None, ""), (_scroll_window(win, rng), None, None, "")]
    return trace


def _time_entropy(coder: str, device_entropy: bool, rounds: int = 3) -> dict:
    """Median FrameStats split and down bytes of the full-P and scroll-delta
    frames of ``_entropy_timing_frames`` (the first round warms up) on a
    flat encoder of this coder and device-entropy setting, and the device
    busy and idle share of two more rounds under torch.profiler."""
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

    trace = _entropy_timing_frames(rounds + 2)
    enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", frame_batch=1,
                           pipeline_depth=0, ltr_scenes=False, entropy_coder=coder,
                           device_entropy=device_entropy, bits_min_mbs=64)
    rows = _drive_host(enc, trace[:1 + 2 * rounds])[3:]
    out = {}
    for kind_name in ("full", "delta"):
        sel = [r for r in rows if r[1].upload_kind == kind_name]
        if not sel:
            _fail(f"entropy timing {coder} {device_entropy}: kinds "
                  f"{[r[1].upload_kind for r in rows]}")
        med = {k: statistics.median(getattr(r[1], k) for r in sel) for k in (
            "step_ms", "fetch_ms", "unpack_ms", "cavlc_ms", "pack_ms", "device_ms", "bytes")}
        med["down_bytes"] = statistics.median(r[4] for r in sel)
        med["downlink_mode"] = sorted({r[1].downlink_mode for r in sel})
        med["frames"] = len(sel)
        out[kind_name] = med
    tail = trace[1 + 2 * rounds:]
    out["profile"] = _profile_frames(enc, [], False, len(tail), feed=lambda i: tail[i][0])
    enc.close()
    return out


def _time_entropy_downlink(dev) -> dict:
    """The device-entropy delta downlink alone (CUDA events, the host
    issuing the calls): ``pack_p_sparse_entropy`` with the encoder's
    consts at the top bucket, and each coder at the smallest bucket that
    holds the frame, on the encode outputs of a 1080p window scroll (a busy
    delta) and of a new window (a full-P frame)."""
    import torch
    from selkies_tpu_torch.models.h264 import encoder as enc_mod
    from selkies_tpu_torch.models.h264.device_cabac import pack_p_slice_tokens_active
    from selkies_tpu_torch.models.h264.device_cavlc import (
        bits_buckets, pack_p_slice_bits_active, resolve_entropy)
    from selkies_tpu_torch.models.h264.encoder_core import (
        encode_frame_p_planes, pack_p_sparse_entropy, pack_p_sparse_packed)

    trace = _entropy_timing_frames(1)
    a, win, scrolled = (enc_mod._convert_pad(torch.from_numpy(f).to(dev), pad_h=1088,
                                             pad_w=W, channels=4) for f, *_ in trace)
    m = 68 * 120
    res = {}
    for name, cur, ref in (("scroll_delta", scrolled, win), ("full_p", win, a)):
        out = encode_frame_p_planes(*cur, *ref, 28)
        ns = int((~out["skip"]).sum())
        small = next(b for b in bits_buckets(m) if b >= ns)
        row = {"coded_mbs": ns, "smallest_bucket": small, "top_bucket": m}
        row["sparse_packed_ms"] = _time_cuda(
            lambda: pack_p_sparse_packed(out, enc_mod.NSCAP, enc_mod.CAP_ROWS_DELTA, 75),
            iters=10)
        for coder, fn in (("cavlc", pack_p_slice_bits_active),
                          ("cabac", pack_p_slice_tokens_active)):
            _, _, words, consts = resolve_entropy(m, True, 64, coder)
            row[f"{coder}_downlink_top_ms"] = _time_cuda(
                lambda: pack_p_sparse_entropy(out, enc_mod.NSCAP, enc_mod.CAP_ROWS_DELTA, 75,
                                              *consts), iters=10)
            row[f"{coder}_coder_top_ms"] = _time_cuda(
                lambda: fn(out, words, consts[2]), iters=10)
            row[f"{coder}_coder_smallest_ms"] = _time_cuda(
                lambda: fn(out, words, consts[2], bucket=small), iters=10)
        res[name] = row
    return res


def _time_cuda(fn, iters: int, warmup: int = 3, hold: bool = False) -> float:
    """Milliseconds per call by CUDA events around ``iters`` calls. With
    ``hold`` the stream first runs a ~10 ms spin kernel, so the host queues
    every call before the first starts and the events time the device
    alone, not the host's rate of issuing calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile_frames(enc, frames, idr: bool, n: int, feed=None, expect: str = "") -> dict:
    """Device busy and idle share over n frames (torch.profiler kernel and
    copy intervals, merged), and the kernels that took the most time.
    ``feed(i)`` picks frame i (default: frame 0 as forced IDRs, or frames 1
    and 2 in turn); ``expect`` is the upload_kind every frame must have.
    "not measured" when the profiler reports no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    feed = feed or (lambda i: frames[0] if idr else frames[1 + i % 2])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = []
        for i in range(n):
            if idr:
                enc.force_keyframe()
            outs += enc.submit(feed(i))
        outs += enc.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if len(outs) != n:
        _fail(f"profiled {n} frames, {len(outs)} came back")
    for i, (_, st, _) in enumerate(outs):
        if expect and st.upload_kind != expect:
            _fail(f"profiled frame {i} is {st.upload_kind}, not {expect}")
    return {"frames": n, **_device_activity(prof, wall_ms)}


def _profile_host_deltas(enc, n: int) -> dict:
    """Device busy and idle share over n typing-delta frames of the
    host-conversion encoder (torch.profiler, as _profile_frames)."""
    a, _, typed, _ = _host_frames(7)
    enc.force_keyframe()
    enc.submit(a)
    rng = np.random.default_rng(8)
    frames = []
    for i in range(n):
        f = a.copy()
        f[500:516, 300 + 16 * i:700 + 16 * i, :3] = rng.integers(0, 255, (16, 400, 3), np.uint8)
        frames.append(f)
    enc.submit(frames[-1])  # warm
    enc.flush()
    return _profile_frames(enc, frames, False, n, feed=lambda i: frames[i],
                           expect="delta")


def _band_trace(w: int = W, h: int = H, light: bool = False, seed: int = 2032):
    """-> [(frame, op)], a full-motion trace: a desktop (IDR), two busy
    scrolls (24 and 40 rows), a window opened over it, the window dragged
    down and right across the band seams (a quarter of the height), a
    static repeat, and a forced IDR on a second drag. ``light``: flat 16x16
    blocks without glyph noise, for the host CABAC coder (Python per MB)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(30, 220, (h // 16 + 1, w // 16 + 1, 4), np.uint8),
                   np.ones((16, 16, 1), np.uint8))[:h, :w].copy()
    if not light:
        glyphs = rng.integers(0, 2, (h // 4, w // 2, 1), np.uint8) * 180
        base[::4, ::2, :3] = np.minimum(base[::4, ::2, :3] + glyphs, 255)
    s1 = np.roll(base, -24, 0)
    s2 = np.roll(s1, -40, 0)
    wy, wx, wh, ww = h // 8, w // 4, h // 4, w // 3
    if light:
        content = np.kron(rng.integers(30, 250, (wh // 16 + 1, ww // 16 + 1, 4), np.uint8),
                          np.ones((16, 16, 1), np.uint8))[:wh, :ww]
    else:
        content = rng.integers(0, 255, (wh, ww, 4), np.uint8)

    def window(dy, dx):
        f = s2.copy()
        f[wy + dy:wy + dy + wh, wx + dx:wx + dx + ww] = content
        return f
    drag = window(h // 4, w // 16)
    return [(base, None), (s1, None), (s2, None), (window(0, 0), None), (drag, None),
            (drag.copy(), None), (window(h // 4 + 24, w // 16 + 40), "idr")]


def _drive_band(enc, trace):
    """-> ([(sha256, FrameStats)], K1 launches per frame)."""
    from selkies_tpu_torch.models.h264 import me_mc

    out, launches = [], []
    for i, (frame, op) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        before = me_mc.launches
        (au, st, _), = enc.submit(frame)
        launches.append(me_mc.launches - before)
        if not au.startswith(b"\x00\x00\x00\x01"):
            _fail(f"band frame {i}: access unit is not Annex-B")
        out.append((hashlib.sha256(au).hexdigest(), st))
    return out, launches


def _p_frames(rows) -> int:
    return sum(1 for _, st in rows if not st.idr and st.upload_kind != "static")


def _time_band_split(enc, frames, n_idr: int = 3) -> dict:
    """Median FrameStats split per frame kind: ``frames[0]`` as an IDR and
    ``frames[1]`` as a P frame warm up, then every later frame as a P frame
    and ``n_idr`` forced IDRs of ``frames[0]``."""
    prev = enc.link_bytes.snapshot()

    def one(frame, idr):
        nonlocal prev
        if idr:
            enc.force_keyframe()
        (_, st, _), = enc.submit(frame)
        links = enc.link_bytes.snapshot()
        grown = {k: v - prev.get(k, 0) for k, v in links.items()}
        prev = links
        if st.idr != idr or st.upload_kind == "static":
            _fail(f"band timing frame has the wrong kind ({st.idr}, {st.upload_kind})")
        return (st, sum(v for k, v in grown.items() if k.startswith("up_")),
                sum(v for k, v in grown.items() if k.startswith("down_")))

    one(frames[0], True)
    one(frames[1], False)
    rows = {"p": [one(f, False) for f in frames[2:]],
            "idr": [one(frames[0], True) for _ in range(n_idr)]}
    out = {}
    for kind_name, sel in rows.items():
        med = {k: statistics.median(getattr(st, k) for st, *_ in sel) for k in (
            "upload_ms", "step_ms", "fetch_ms", "unpack_ms", "cavlc_ms", "pack_ms",
            "device_ms", "bytes")}
        steps = [st.band_step_ms for st, *_ in sel if st.band_step_ms]
        if steps:
            med["band_step_ms_min"] = statistics.median(min(b) for b in steps)
            med["band_step_ms_max"] = statistics.median(max(b) for b in steps)
        med["up_bytes"] = statistics.median(r[1] for r in sel)
        med["down_bytes"] = statistics.median(r[2] for r in sel)
        med["frames"] = len(sel)
        out[kind_name] = med
    return out


def _scroll_run(w: int, h: int, n: int):
    """The full-motion trace's desktop, then n scrolls of 24 more rows each."""
    base = _band_trace(w, h)[0][0]
    return [base] + [np.roll(base, -24 * (k + 1), 0) for k in range(n)]


SW, SH = 1920, 1088  # the multi-session geometry (MB-aligned, as JAX requires)


def _batch_me_inputs(n: int, h: int, w: int, seed: int, dev):
    """The batched kernel's inputs for n sessions, each with its own seeded
    content, motion and noise, and its own coarse-voted candidate list
    (built as the batched P step builds them)."""
    import torch

    from selkies_tpu_torch.models.h264 import encoder_core as core

    rng = np.random.default_rng(seed)
    planes = [_planes(h, w, seed + i, tuple(int(x) for x in rng.integers(-34, 35, 2)),
                      int(rng.integers(0, 13)), dev) for i in range(n)]
    cur, ref, cu, cv = (torch.stack(t) for t in zip(*planes))
    cands = core._refine_cands(core.coarse_vote_candidates(cur, ref))
    return (cands, cur, *(core.edge_pad(p, core.MV_PAD) for p in (ref, cu, cv)))


def _session_base(i: int, w: int, h: int):
    """Session i's desktop: a block wallpaper with glyph rows, its own seed."""
    rng = np.random.default_rng(3000 + i)
    base = np.kron(rng.integers(30, 220, (h // 16, w // 16, 4), np.uint8),
                   np.ones((16, 16, 1), np.uint8))
    glyphs = rng.integers(0, 2, (h // 4, w // 2, 1), np.uint8) * 180
    base[::4, ::2, :3] = np.minimum(base[::4, ::2, :3] + glyphs, 255)
    return base


def _session_frame(base, i: int, t: int):
    """Session i's frame at tick t: even sessions scroll by 8 + 4i rows a
    tick, odd ones type a new 16-row line a tick on a pan of 2 columns."""
    h, w = base.shape[:2]
    if i % 2 == 0:
        return np.roll(base, -(8 + 4 * i) * t, 0)
    f = np.roll(base, 2 * t, 1)
    lw = min(400, w - 64)
    for k in range(1, t + 1):
        r = (48 + 32 * k + 16 * i) % (h - 16)
        f[r:r + 16, 64:64 + lw, :3] = np.random.default_rng(4000 + 10 * i + k).integers(
            0, 255, (16, lw, 3), np.uint8)
    return f


# the multi-session phase's ops before each tick: ("qp", session, qp),
# ("key", session); tick 0 keys every session, ticks 1-2 are P ticks
SESSION_OPS = {3: [("qp", 1, 24), ("qp", 2, 34), ("key", 3)], 4: [("key", 5), ("key", 6)]}
SESSION_TICKS = 6


def _drive_sessions(svc, bases):
    """-> (per tick the sessions' AU sha256s, per tick K1 launches, per
    session its QP per tick, the forced ticks per session)."""
    from selkies_tpu_torch.models.h264 import me_mc

    n = len(bases)
    shas, launches = [], []
    qps = {i: [] for i in range(n)}
    forced = {i: [] for i in range(n)}
    for t in range(SESSION_TICKS):
        for op in SESSION_OPS.get(t, ()):
            if op[1] >= n:
                continue
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
                forced[op[1]].append(t)
        for i in range(n):
            qps[i].append(svc.sessions[i].qp)
        batch = np.stack([_session_frame(b, i, t) for i, b in enumerate(bases)])
        k0 = me_mc.launches
        aus = svc.encode_tick(batch)
        launches.append(me_mc.launches - k0)
        if not all(au.startswith(b"\x00\x00\x00\x01") for au in aus):
            _fail(f"session tick {t}: an access unit is not Annex-B")
        shas.append([hashlib.sha256(au).hexdigest() for au in aus])
    return shas, launches, qps, forced


def _device_activity(prof, wall_ms: float) -> dict:
    """torch.profiler's device events -> busy ms (kernel and copy intervals,
    merged), idle share, op count, K1's share and the costliest kernels.
    "not measured" when the profiler reports no device activity."""
    import torch

    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in dev:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    k1 = [v for k, v in by_name.items() if "me_mc_kernel" in k]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ops": len(dev),
            "me_mc_kernel": {"ms": sum(v[0] for v in k1), "count": sum(v[1] for v in k1)},
            "top": [{"name": k[:80], "ms": v[0], "count": v[1]} for k, v in top]}


def _scrolled(bases, t: int) -> list:
    """The full-motion timing trace at tick t: session i scrolls its
    desktop by 8 + 2i rows a tick (all within the search's reach of 34)."""
    return [np.roll(b, -(8 + 2 * i) * t, 0) for i, b in enumerate(bases)]


def _time_sessions(n: int, p_ticks: int = 6, prof_ticks: int = 3) -> dict:
    """The service at n sessions of 1920x1088 on full motion (_scrolled):
    the IDR tick, the median
    split of p_ticks back-to-back P ticks after two warm-up ticks, frames
    per second over them (n x ticks / s), a mixed tick with one IDR, the
    device ops and idle share per P tick over prof_ticks more
    (torch.profiler) and the peak device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    bases = [_session_base(i, SW, SH) for i in range(n)]

    def batch(t):
        return np.stack(_scrolled(bases, t))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = TorchMultiSessionH264Service(n, SW, SH, qp=28, device="cuda")
    t0 = time.perf_counter()
    svc.encode_tick(batch(0))
    out = {"sessions": n, "idr_tick_ms": (time.perf_counter() - t0) * 1e3,
           "idr_tick": dict(svc.last_timing)}
    for t in (1, 2):
        svc.encode_tick(batch(t))
    p = [batch(t) for t in range(3, 3 + p_ticks)]
    rows = []
    k0 = me_mc.launches
    t0 = time.perf_counter()
    for b in p:
        svc.encode_tick(b)
        rows.append(dict(svc.last_timing))
    wall = time.perf_counter() - t0
    if me_mc.launches - k0 != p_ticks:
        _fail(f"sessions {n}: K1 launched {me_mc.launches - k0} times in {p_ticks} P ticks")
    out["p_tick"] = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    out["p_tick_wall_ms"] = wall * 1e3 / p_ticks
    out["fps"] = n * p_ticks / wall
    del p
    svc.force_keyframe(0)
    t0 = time.perf_counter()
    svc.encode_tick(batch(3 + p_ticks))
    out["mixed_tick_ms"] = (time.perf_counter() - t0) * 1e3
    out["mixed_tick"] = dict(svc.last_timing)
    pb = [batch(t) for t in range(4 + p_ticks, 4 + p_ticks + prof_ticks)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in pb:
            svc.encode_tick(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    act = _device_activity(prof, wall_ms)
    act["ticks"] = prof_ticks
    if isinstance(act.get("device_ops"), int):
        act["device_ops_per_tick"] = act["device_ops"] / prof_ticks
    out["profile_p"] = act
    out["peak_device_mb"] = torch.cuda.max_memory_allocated() / 2**20
    svc.close()
    return out


def _time_solo_in_turn(n: int, p_ticks: int = 6) -> dict:
    """The frames of _time_sessions(n) through n solo flat encoders
    (host conversion, no tile cache: full P frames, as the service codes
    them), stepped in turn: the IDR tick, and per P tick the wall time of
    the n encodes after two warm-up ticks."""
    import torch

    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

    bases = [_session_base(i, SW, SH) for i in range(n)]
    encs = [TorchH264Encoder(SW, SH, qp=28, device="cuda", tile_cache=0, frame_batch=1,
                             pipeline_depth=0, ltr_scenes=False) for _ in range(n)]

    def tick(t):
        frames = _scrolled(bases, t)
        t0 = time.perf_counter()
        for e, f in zip(encs, frames):
            e.encode_frame(f)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"sessions": n, "idr_tick_ms": tick(0)}
    tick(1)
    tick(2)
    ms = [tick(t) for t in range(3, 3 + p_ticks)]
    out["p_tick_ms"] = statistics.median(ms)
    out["fps"] = n * 1e3 / statistics.mean(ms)
    for e in encs:
        e.close()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from selkies_tpu_torch.models import frameprep
    from selkies_tpu_torch.models.h264 import me_mc, native
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
    from selkies_tpu_torch.utils.build import BUILD_DIR

    timing = "--no-timing" not in sys.argv[1:]
    t_start = time.perf_counter()

    record: dict = {}
    # -- 1. the card
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    card, power_limit = (s.strip() for s in smi.split(",", 1))
    print(f"device: {kind} (count {count}); torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    record["card"] = {"name": card, "power_limit": power_limit, "kind": kind, "count": count}

    # -- 2. build the three libraries at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(f) for f in (me_mc.build, native.build, frameprep.build)]
        k_build, n_build, f_build = (f.result() for f in futs)
    record["build_s"] = {"me_mc": k_build.seconds, "native": n_build.seconds,
                         "frameprep": f_build.seconds, "wall": time.perf_counter() - t0}
    print(f"build: me_mc {k_build.seconds:.2f} s, native {n_build.seconds:.2f} s, "
          f"frameprep {f_build.seconds:.2f} s, wall {record['build_s']['wall']:.2f} s")
    if f_build.path.parent != BUILD_DIR or not f_build.path.exists():
        _fail(f"frameprep library {f_build.path} is not a build of native/frameprep.cc")
    print(f"frameprep: {f_build.path.relative_to(BUILD_DIR.parents[1])} "
          f"(g++ of native/frameprep.cc, {f_build.seconds:.2f} s)")
    print("me_mc ptxas:", k_build.log.strip() or "(cached build)")
    sass = _sass_check(k_build.path, me_mc._nvcc())
    record["sass"] = sass
    print(f"me_mc SASS: VABSDIFF4 per kernel {sass['vabsdiff4_per_kernel']} "
          f"(native 4-way byte SAD: {sass['native_simd4']})")

    # -- 3. kernel against its plain version at 1920x1088
    cases = {"static": (1, (0, 0), 0), "uniform": (2, (-24, 29), 0),
             "near_reach_noise": (3, (33, -34), 12),
             # a tile with a 16-pixel halo: every |d| <= 14 (halo - 2)
             "tile_clamped": (4, (-20, 17), 6, (1088, 1920), {"dy_max": 14, "dx_max": 14}),
             # 86 MB columns: the last block holds a strip of 6 MBs
             "ragged_1376x768": (5, (9, -13), 6, (768, 1376))}
    # the band path's shapes at 4K (phase 8b): an interior tile of the 3x2
    # grid and the middle of 3 bands, each against its slab at the default
    # (full-reach) halos and clamped by 16-pixel halos; the whole frame
    # (bands=1 and the solo encoder)
    uhd = (2160, 3840)
    slab_cases = {
        "tile_720x1920": (6, (-24, 29), 6, uhd, (720, 1920, 720, 1920), (40, 40)),
        "tile_720x1920_clamped": (7, (-20, 17), 6, uhd, (720, 1920, 720, 1920), (16, 16)),
        "band_720x3840": (8, (33, -34), 12, uhd, (720, 0, 720, 3840), (40, 0)),
        "band_720x3840_clamped": (9, (-20, 17), 6, uhd, (720, 0, 720, 3840), (16, 0)),
        "frame_2160x3840": (10, (-24, 29), 6, uhd, (0, 0, 2160, 3840), (0, 0))}
    checks = [(n, _me_inputs, c) for n, c in cases.items()]
    checks += [(n, _slab_me_inputs, c) for n, c in slab_cases.items()]
    max_err = 0
    for name, make_inputs, case in checks:
        args = make_inputs(case, dev)
        got = me_mc.me_mc(*args)
        want = me_mc.me_mc_plain(*args)
        torch.cuda.synchronize()
        for out_name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
            err = int((a.long() - b.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                _fail(f"me_mc {name}: {out_name} differs from the plain version (max {err})")
        nz = int((got[0] != 0).any(-1).sum())
        h, w = args[1].shape
        print(f"me_mc check {name}: exact at {w}x{h}, reference {tuple(args[2].shape)} "
              f"({args[0].shape[0]} candidates, {nz} MBs with nonzero MV)")
        record.setdefault("me_mc_checks", {})[name] = {
            "cur": [h, w], "ref": list(args[2].shape), "candidates": args[0].shape[0],
            "nonzero_mv_mbs": nz}
    # the session axis: one launch over every session, each with its own
    # motion and candidate list (the multi-session tick's shapes)
    batch_cases = {"batch8_1088x1920": (8, 1088, 1920, 20), "batch3_768x1376": (3, 768, 1376, 30)}
    for name, (n, h, w, seed) in batch_cases.items():
        args = _batch_me_inputs(n, h, w, seed, dev)
        got = me_mc.me_mc_batch(*args)
        want = me_mc.me_mc_batch_plain(*args)
        torch.cuda.synchronize()
        for out_name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
            err = int((a.long() - b.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                _fail(f"me_mc_batch {name}: {out_name} differs from the plain version "
                      f"(max {err})")
        nz = [int((got[0][i] != 0).any(-1).sum()) for i in range(n)]
        print(f"me_mc_batch check {name}: exact, {n} sessions at {w}x{h} in one launch "
              f"({args[0].shape[1]} candidates each; MBs with nonzero MV per session {nz})")
        record.setdefault("me_mc_checks", {})[name] = {
            "sessions": n, "cur": [h, w], "candidates": args[0].shape[1],
            "nonzero_mv_mbs": nz}

    # -- 4. the device-conversion path: the encoder at 1920x1080 on the card vs the CPU
    frames = _desktop_trace()
    flat = dict(pipeline_depth=0, frame_batch=1)  # one AU per submit
    enc = TorchH264Encoder(W, H, qp=28, host_convert=False, device="cuda", **flat)
    me_mc.launches = 0
    native.calls = 0
    t0 = time.perf_counter()
    gpu = _drive(enc, frames)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, packs = me_mc.launches, native.calls
    t0 = time.perf_counter()
    cpu = _drive(TorchH264Encoder(W, H, qp=28, host_convert=False, device="cpu", **flat), frames)
    cpu_s = time.perf_counter() - t0
    for i, ((hg, sg), (hc, sc)) in enumerate(zip(gpu, cpu)):
        if hg != hc:
            _fail(f"frame {i}: cuda AU sha256 {hg[:16]} != cpu {hc[:16]}")
    p_frames = sum(1 for _, s in gpu if not s.idr and s.upload_kind != "static")
    if launches != p_frames:
        _fail(f"me_mc launched {launches} times for {p_frames} non-static P frames")
    if packs <= 0:
        _fail("the native packer never ran")
    kinds = ["I" if s.idr else ("S" if s.upload_kind == "static" else "P") for _, s in gpu]
    print(f"encoder 1920x1080: {len(frames)} frames {''.join(kinds)}, AUs sha256-equal cuda vs cpu; "
          f"me_mc launches {launches} (= non-static P frames), native packs {packs}; "
          f"bytes {[s.bytes for _, s in gpu]}; cuda run {main_s:.2f} s, cpu run {cpu_s:.2f} s")
    record["main_path"] = {"frames": "".join(kinds), "me_mc_launches": launches,
                           "native_packs": packs, "bytes": [s.bytes for _, s in gpu],
                           "sha256": [h for h, _ in gpu], "cuda_s": main_s, "cpu_s": cpu_s}

    # -- 5. the host-conversion path at 1920x1080 on the card vs the CPU
    trace = _host_trace()
    flat_host = dict(flat, ltr_scenes=False)
    henc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **flat_host)
    me_mc.launches = 0
    native.calls = native.sparse_calls = 0
    t0 = time.perf_counter()
    hgpu = _drive_host(henc, trace)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_launches, host_packs, host_sparse = me_mc.launches, native.calls, native.sparse_calls
    t0 = time.perf_counter()
    hcpu = _drive_host(TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cpu",
                                        **flat_host), trace)
    hcpu_s = time.perf_counter() - t0
    for i, (g, c) in enumerate(zip(hgpu, hcpu)):
        if g[0] != c[0]:
            _fail(f"host frame {i}: cuda AU sha256 {g[0][:16]} != cpu {c[0][:16]}")
        if (g[2], g[3], g[4]) != (c[2], c[3], c[4]):
            _fail(f"host frame {i}: cuda {g[2:]} != cpu {c[2:]}")
    hkinds = [r[2] for r in hgpu]
    if hkinds != [k for *_, k in trace]:
        _fail(f"host path frame kinds {hkinds} != {[k for *_, k in trace]}")
    if set(HOST_KINDS) - set(hkinds):
        _fail(f"host path missed kinds {set(HOST_KINDS) - set(hkinds)}")
    host_p = sum(1 for r in hgpu if not r[1].idr and r[1].upload_kind != "static")
    if host_launches != host_p:
        _fail(f"me_mc launched {host_launches} times for {host_p} non-static P frames (host path)")
    if host_sparse <= 0:
        _fail("the native sparse packer never ran on the host path")
    print(f"host path 1920x1080: {len(trace)} frames {hkinds}; AUs sha256-equal cuda vs cpu; "
          f"me_mc launches {host_launches} (= non-static P frames), native packs {host_packs} "
          f"(sparse {host_sparse}); bytes {[r[1].bytes for r in hgpu]}; up bytes "
          f"{[r[3] for r in hgpu]}; down bytes {[r[4] for r in hgpu]}; cuda run {host_s:.2f} s, "
          f"cpu run {hcpu_s:.2f} s")
    record["host_path"] = {
        "kinds": hkinds, "me_mc_launches": host_launches, "native_packs": host_packs,
        "native_sparse_packs": host_sparse, "bytes": [r[1].bytes for r in hgpu],
        "up_bytes": [r[3] for r in hgpu], "down_bytes": [r[4] for r in hgpu],
        "sha256": [r[0] for r in hgpu], "cuda_s": host_s, "cpu_s": hcpu_s,
        "frameprep_lib": str(f_build.path.name)}
    # -- 6. the registry row: groups of 4, pipeline depth 2, the LTR scene cache
    rtrace = _registry_trace()
    renc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda")
    me_mc.launches = 0
    native.calls = native.sparse_calls = 0
    t0 = time.perf_counter()
    rgpu, rups = _drive_registry(renc, rtrace)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    reg_launches, reg_sparse = me_mc.launches, native.sparse_calls
    groups, restores = dict(renc.group_sizes), renc.ltr_restores
    renc.close()
    t0 = time.perf_counter()
    rflat_enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **flat)
    rflat, _ = _drive_registry(rflat_enc, rtrace)
    flat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rcpu_enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cpu")
    rcpu, rcpu_ups = _drive_registry(rcpu_enc, rtrace)
    rcpu_s = time.perf_counter() - t0
    rcpu_enc.close()
    for i, ((g, st), (c, _), (f, _)) in enumerate(zip(rgpu, rcpu, rflat)):
        if g != c:
            _fail(f"registry frame {i}: cuda AU sha256 {g[:16]} != cpu {c[:16]}")
        if g != f:
            _fail(f"registry frame {i}: grouped+pipelined AU {g[:16]} != flat card run {f[:16]}")
    if rups != rcpu_ups:
        _fail(f"registry path up bytes {rups} != cpu {rcpu_ups}")
    if restores < 2 or rcpu_enc.ltr_restores != restores or rflat_enc.ltr_restores != restores:
        _fail(f"ltr_restores {restores} (cpu {rcpu_enc.ltr_restores}, flat "
              f"{rflat_enc.ltr_restores}); want >= 2 and equal")
    if groups.get(4, 0) < 1 or groups.get(2, 0) < 1:
        _fail(f"registry path dispatched groups {groups}; want a 4 and a 2")
    reg_p = sum(1 for _, st in rgpu if not st.idr and st.upload_kind != "static")
    if reg_launches != reg_p:
        _fail(f"me_mc launched {reg_launches} times for {reg_p} non-static P frames (registry)")
    if reg_sparse <= 0:
        _fail("the native sparse packer never ran on the registry path")
    rkinds = "".join("I" if st.idr else {"static": "S", "full": "F", "delta": "D"}[st.upload_kind]
                     for _, st in rgpu)
    print(f"registry path 1920x1080 (frame_batch 4, pipeline_depth 2, ltr_scenes): "
          f"{len(rtrace)} frames {rkinds}; AUs sha256-equal to the cpu run and to the card run "
          f"with frame_batch=1, pipeline_depth=0; up bytes equal to the cpu run's {rups}; "
          f"ltr_restores {restores}; groups dispatched {groups}; me_mc launches {reg_launches} "
          f"(= non-static P frames); native sparse packs {reg_sparse}; qp "
          f"{[st.qp for _, st in rgpu]}; bytes {[st.bytes for _, st in rgpu]}; cuda run "
          f"{reg_s:.2f} s, flat card run {flat_s:.2f} s, cpu run {rcpu_s:.2f} s")
    record["registry_path"] = {
        "kinds": rkinds, "ltr_restores": restores, "group_sizes": groups,
        "me_mc_launches": reg_launches, "native_sparse_packs": reg_sparse, "up_bytes": rups,
        "bytes": [st.bytes for _, st in rgpu], "qp": [st.qp for _, st in rgpu],
        "sha256": [g for g, _ in rgpu], "cuda_s": reg_s, "flat_cuda_s": flat_s,
        "cpu_s": rcpu_s}

    # -- 7. the entropy plane: device CAVLC, host CABAC, device CABAC tokens
    etrace = _entropy_trace()
    de = dict(device_entropy=True, bits_min_mbs=64)
    t0 = time.perf_counter()
    native.cabac_calls = 0

    def row_enc(dev, **kw):
        return TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device=dev, **kw)

    ref_rows, ref_ans, ref_k1, ref_ltr = _drive_entropy(row_enc("cuda"), etrace, {"device_entropy": False})
    a_rows, a_ans, a_k1, a_ltr = _drive_entropy(row_enc("cuda", **de), etrace, {"device_entropy": False})
    b_rows, b_ans, b_k1, b_ltr = _drive_entropy(row_enc("cuda", entropy_coder="cabac"), etrace,
                                         {"entropy_coder": "cavlc"})
    c_rows, c_ans, c_k1, c_ltr = _drive_entropy(row_enc("cuda", entropy_coder="cabac", **de), etrace,
                                         {"entropy_coder": "cavlc"})
    dtrace = etrace[:2] + etrace[3:5] + etrace[8:9]  # ends with the (refused) switch
    flat_d = dict(flat, host_convert=False, entropy_coder="cabac")
    d_rows, d_ans, d_k1, d_ltr = _drive_entropy(row_enc("cuda", **flat_d), dtrace,
                                         {"entropy_coder": "cavlc"})
    cabac_engine = native.cabac_calls
    ent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_cpu, *_ = _drive_entropy(row_enc("cpu", entropy_coder="cabac"), etrace,
                                 {"entropy_coder": "cavlc"})
    d_cpu, *_ = _drive_entropy(row_enc("cpu", **flat_d), dtrace, {"entropy_coder": "cavlc"})
    ent_cpu_s = time.perf_counter() - t0
    shas = {k: [h for h, _ in r] for k, r in (("ref", ref_rows), ("a", a_rows), ("b", b_rows),
                                              ("c", c_rows), ("d", d_rows), ("b_cpu", b_cpu),
                                              ("d_cpu", d_cpu))}
    for x, y in (("a", "ref"), ("c", "b"), ("b", "b_cpu"), ("d", "d_cpu")):
        bad = [i for i, (p, q) in enumerate(zip(shas[x], shas[y])) if p != q]
        if bad or len(shas[x]) != len(shas[y]):
            _fail(f"entropy path: ({x}) AUs differ from ({y}) at frames {bad}")
    modes = {k: [st.downlink_mode for _, st in r] for k, r in (
        ("a", a_rows), ("b", b_rows), ("c", c_rows), ("d", d_rows))}
    # frames 1 and 2 are the quiet typed lines; 3 the scene cut, 4 and 5
    # the busy scrolls
    for k, coded in (("a", "bits"), ("c", "cabac"), ("b", "coeff")):
        if modes[k][1:3] != ["coeff"] * 2 or modes[k][3:6] != [coded] * 3:
            _fail(f"entropy path ({k}): downlink modes {modes[k]}")
    if (a_ans, ref_ans, b_ans, c_ans, d_ans) != (True, False, True, True, False):
        _fail(f"retune answers a {a_ans} ref {ref_ans} b {b_ans} c {c_ans} d {d_ans}")
    if not (b_rows[8][1].idr and c_rows[8][1].idr) or a_rows[8][1].idr:
        _fail("the coder switch must force an IDR in (b) and (c), and nothing in (a)")
    if cabac_engine <= 0:
        _fail("the native CABAC engine never ran")
    if min(ref_ltr, a_ltr, b_ltr, c_ltr) < 1:
        _fail(f"entropy path: LTR restores ref {ref_ltr} a {a_ltr} b {b_ltr} c {c_ltr}")
    idr_pack = {"cabac_host_ms": b_rows[0][1].pack_ms, "cavlc_ms": ref_rows[0][1].pack_ms,
                "cabac_bytes": b_rows[0][1].bytes, "cavlc_bytes": ref_rows[0][1].bytes}
    ekinds = "".join("I" if st.idr else {"static": "S", "full": "F", "delta": "D"}[st.upload_kind]
                     for _, st in a_rows)
    print(f"entropy path 1920x1080 (registry row; {len(etrace)} frames {ekinds}): (a) device "
          f"CAVLC AUs equal the row's own CAVLC AUs, (c) device CABAC tokens equal (b) host "
          f"CABAC, (b) and (d) device conversion CABAC equal their cpu runs; modes "
          f"{json.dumps(modes)}; me_mc launches a {a_k1} b {b_k1} c {c_k1} d {d_k1} ref {ref_k1} "
          f"(= non-static P frames); native CABAC engine runs {cabac_engine}; ltr_restores "
          f"{[ref_ltr, a_ltr, b_ltr, c_ltr]}; IDR pack {json.dumps(idr_pack)}; bytes cavlc "
          f"{[st.bytes for _, st in a_rows]} cabac {[st.bytes for _, st in c_rows]}; cuda runs "
          f"{ent_s:.2f} s, cpu runs {ent_cpu_s:.2f} s")
    record["entropy_path"] = {
        "kinds": ekinds, "modes": modes, "sha256": shas, "idr_pack": idr_pack,
        "me_mc_launches": {"a": a_k1, "b": b_k1, "c": c_k1, "d": d_k1, "ref": ref_k1},
        "cabac_engine_runs": cabac_engine, "bytes": {
            k: [st.bytes for _, st in r] for k, r in (("a", a_rows), ("c", c_rows))},
        "cuda_s": ent_s, "cpu_s": ent_cpu_s}
    # -- 8. band and tile slicing: 1080p against the CPU, 4K on the card alone
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    btrace, ltrace = _band_trace(), _band_trace(light=True)
    band_cfgs = {"bands4": (dict(bands=4), btrace),
                 "bands4_cols2": (dict(bands=4, cols=2), btrace),
                 "cabac_device_bands4": (dict(bands=4, entropy_coder="cabac",
                                              device_entropy=True, bits_min_mbs=64), ltrace)}
    band_rec: dict = {}
    band_launches, band_p = {}, {}
    t0 = time.perf_counter()
    for name, (kw, tr) in band_cfgs.items():
        benc = TorchBandedH264Encoder(W, H, qp=28, device="cuda", **kw)
        me_mc.launches = 0
        tc = time.perf_counter()
        bgpu, per_frame = _drive_band(benc, tr)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - tc
        launched = me_mc.launches
        benc.close()
        tc = time.perf_counter()
        cpu_enc = TorchBandedH264Encoder(W, H, qp=28, device="cpu", **kw)
        bcpu, _ = _drive_band(cpu_enc, tr)
        cpu_enc.close()
        cpu_s = time.perf_counter() - tc
        bad = [i for i, ((g, _), (c, _)) in enumerate(zip(bgpu, bcpu)) if g != c]
        if bad:
            _fail(f"band path {name}: cuda AUs differ from the cpu run's at frames {bad}")
        tiles = benc.bands * benc.cols
        if (benc.bands, benc.cols) != (4, kw.get("cols", 1)):
            _fail(f"band path {name}: carve {benc.bands}x{benc.cols}")
        want = [0 if st.idr or st.upload_kind == "static" else tiles for _, st in bgpu]
        if per_frame != want or launched != sum(want):
            _fail(f"band path {name}: me_mc launches {per_frame}, want {want}")
        band_launches[name], band_p[name] = launched, _p_frames(bgpu)
        band_rec[name] = {
            "carve": f"{benc.bands}x{benc.cols}", "me_mc_launches": launched,
            "launches_per_frame": per_frame, "bytes": [st.bytes for _, st in bgpu],
            "modes": [st.downlink_mode for _, st in bgpu],
            "kinds": "".join("I" if st.idr else "S" if st.upload_kind == "static" else "P"
                             for _, st in bgpu),
            "sha256": [h for h, _ in bgpu], "cuda_s": cuda_s, "cpu_s": cpu_s}
    if "cabac" not in band_rec["cabac_device_bands4"]["modes"]:
        _fail(f"band path: no CABAC band shipped device tokens "
              f"{band_rec['cabac_device_bands4']['modes']}")
    # 4K on the card alone: the grid against its band oracle, one band
    # against the solo encoder
    k4 = _band_trace(3840, 2160)[:6]
    k4_runs = {}
    for name, make in (
            ("grid3x2", lambda: TorchBandedH264Encoder(3840, 2160, qp=28, bands=3, cols=2,
                                                       device="cuda")),
            ("bands3", lambda: TorchBandedH264Encoder(3840, 2160, qp=28, bands=3,
                                                      device="cuda")),
            ("bands1", lambda: TorchBandedH264Encoder(3840, 2160, qp=28, bands=1,
                                                      device="cuda")),
            ("solo", lambda: TorchH264Encoder(3840, 2160, qp=28, frame_batch=1,
                                              pipeline_depth=0, ltr_scenes=False,
                                              scene_qp_boost=0, device="cuda"))):
        kenc = make()
        me_mc.launches = 0
        tc = time.perf_counter()
        rows, per_frame = _drive_band(kenc, k4)
        torch.cuda.synchronize()
        k4_runs[name] = {"sha256": [h for h, _ in rows], "bytes": [st.bytes for _, st in rows],
                         "launches_per_frame": per_frame, "cuda_s": time.perf_counter() - tc,
                         "carve": f"{getattr(kenc, 'bands', 1)}x{getattr(kenc, 'cols', 1)}"}
        kenc.close()
    for x, y in (("grid3x2", "bands3"), ("bands1", "solo")):
        bad = [i for i, (p, q) in enumerate(zip(k4_runs[x]["sha256"], k4_runs[y]["sha256"]))
               if p != q]
        if bad:
            _fail(f"4K: {x} AUs differ from {y} at frames {bad}")
    if k4_runs["grid3x2"]["carve"] != "3x2" or max(k4_runs["grid3x2"]["launches_per_frame"]) != 6:
        _fail(f"4K grid: carve {k4_runs['grid3x2']['carve']}, launches "
              f"{k4_runs['grid3x2']['launches_per_frame']}")
    k4_enc = TorchBandedH264Encoder(3840, 2160, bands=4, device="cuda")
    k4_bands4 = (k4_enc.bands, k4_enc.cols)
    k4_enc.close()
    if k4_bands4 != (3, 1):
        _fail(f"4K bands=4 resolved to {k4_bands4}, not 3 bands (135 MB rows)")
    band_s = time.perf_counter() - t0
    print(f"band path 1920x1080 ({len(btrace)} frames {band_rec['bands4']['kinds']}): bands4, "
          f"bands4_cols2 and cabac_device_bands4 AUs sha256-equal cuda vs cpu; me_mc launches "
          f"{band_launches} (= bands x cols per non-static P frame); modes "
          f"{json.dumps({k: v['modes'] for k, v in band_rec.items()})}; bytes "
          f"{json.dumps({k: v['bytes'] for k, v in band_rec.items()})}; 4K 3840x2160: grid "
          f"3x2 = bands 3, bands 1 = solo encoder, bands=4 -> {k4_bands4[0]} bands, bytes "
          f"{k4_runs['grid3x2']['bytes']}; launches grid3x2 "
          f"{k4_runs['grid3x2']['launches_per_frame']}; {band_s:.1f} s")
    record["band_path"] = {"1080p": band_rec, "4k": k4_runs, "4k_bands4": k4_bands4,
                           "seconds": band_s}
    # -- 9. multi-session serving: 8 x 1920x1088 against solo card encoders,
    # 4 x 640x368 against the CPU run
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    t0 = time.perf_counter()
    bases = [_session_base(i, SW, SH) for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    svc = TorchMultiSessionH264Service(8, SW, SH, qp=28, device="cuda")
    me_mc.launches = 0
    ses_shas, ses_ticks, ses_qps, ses_forced = _drive_sessions(svc, bases)
    torch.cuda.synchronize()
    ses_launches = me_mc.launches
    ses_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    svc.close()
    ses_s = time.perf_counter() - t0
    # K1 once per tick with a P session: every tick after the first here
    want_ticks = [0] + [1] * (SESSION_TICKS - 1)
    if ses_ticks != want_ticks or ses_launches != sum(want_ticks):
        _fail(f"sessions: me_mc launches per tick {ses_ticks}, want {want_ticks}")
    t0 = time.perf_counter()
    for i, base in enumerate(bases):
        solo = TorchH264Encoder(SW, SH, qp=28, host_convert=False, frame_batch=1,
                                pipeline_depth=0, device="cuda")
        for t in range(SESSION_TICKS):
            if t in ses_forced[i]:
                solo.force_keyframe()
            au = solo.encode_frame(_session_frame(base, i, t), qp=ses_qps[i][t])
            if hashlib.sha256(au).hexdigest() != ses_shas[t][i]:
                _fail(f"sessions: session {i} tick {t} differs from its solo card encoder")
        solo.close()
    solo_s = time.perf_counter() - t0
    small_bases = [_session_base(i, 640, 368) for i in range(4)]
    small = {}
    for dev_name in ("cuda", "cpu"):
        ssvc = TorchMultiSessionH264Service(4, 640, 368, qp=28, device=dev_name)
        me_mc.launches = 0
        tc = time.perf_counter()
        small[dev_name] = _drive_sessions(ssvc, small_bases) + (
            me_mc.launches, time.perf_counter() - tc)
        ssvc.close()
    if small["cuda"][0] != small["cpu"][0]:
        bad = [t for t, (g, c) in enumerate(zip(small["cuda"][0], small["cpu"][0])) if g != c]
        _fail(f"sessions 4 x 640x368: cuda AUs differ from the cpu run's at ticks {bad}")
    if small["cuda"][4] != SESSION_TICKS - 1:
        _fail(f"sessions 4 x 640x368: me_mc launched {small['cuda'][4]} times")
    idr_map = ["".join("I" if t == 0 or t in ses_forced[i] else "P" for i in range(8))
               for t in range(SESSION_TICKS)]
    print(f"multi-session 8 x {SW}x{SH} ({SESSION_TICKS} ticks, per tick {idr_map}): every "
          f"session's AUs sha256-equal its solo card encoder's; me_mc launches per tick "
          f"{ses_ticks} (once per tick with a P session); peak device memory "
          f"{ses_peak_mb:.0f} MiB; service {ses_s:.1f} s, solo encoders {solo_s:.1f} s; "
          f"4 x 640x368 cuda AUs equal the cpu run's (me_mc launches {small['cuda'][4]}; "
          f"cuda {small['cuda'][5]:.1f} s, cpu {small['cpu'][5]:.1f} s)")
    record["session_path"] = {
        "ticks": idr_map, "me_mc_launches": ses_launches, "launches_per_tick": ses_ticks,
        "qps": ses_qps, "forced": ses_forced, "sha256": ses_shas, "peak_device_mb": ses_peak_mb,
        "cuda_s": ses_s, "solo_s": solo_s,
        "small_640x368": {"sha256": small["cuda"][0], "me_mc_launches": small["cuda"][4],
                          "cuda_s": small["cuda"][5], "cpu_s": small["cpu"][5]}}
    print(f"phases 1-9: {time.perf_counter() - t_start:.1f} s")
    if not timing:
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    # -- 10. timing
    args = _me_inputs(cases["uniform"], dev)
    ms = _time_cuda(lambda: me_mc.me_mc(*args), iters=50, hold=True)
    issued_ms = _time_cuda(lambda: me_mc.me_mc(*args), iters=50)
    # one candidate: the same loads and stores, ~1/76 of the SADs
    one_ms = _time_cuda(lambda: me_mc.me_mc(args[0][:1], *args[1:]), iters=50, hold=True)
    plain_ms = _time_cuda(lambda: me_mc.me_mc_plain(*args), iters=5, warmup=1)
    cands, cur, ry, ru, rv = args
    ncand, (h, w) = cands.shape[0], cur.shape
    out_bytes = (h // 16) * (w // 16) * 2 * 4 + h * w * 4 + 2 * (h // 2) * (w // 2) * 4
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    # one absolute difference per pixel and candidate; the kernel does four
    # at a time where the SASS shows the native instruction (VABSDIFF4)
    ops = ncand * h * w
    simd_ops = ops // 4 if sass["native_simd4"] else ops
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    simd_ms = simd_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, simd_ms)
    print(f"me_mc {ncand} cands x {w}x{h}: {ms:.5f} ms (CUDA events, 50 launches queued "
          f"behind a spin kernel; {issued_ms:.5f} ms as the host issues them; {one_ms:.5f} ms "
          f"for 1 candidate), plain "
          f"{plain_ms:.3f} ms; floors: bytes {bytes_ms:.5f} ms, operations {simd_ms:.5f} ms "
          f"({'one VABSDIFF4 per 4 pixels' if sass['native_simd4'] else 'one per pixel'}); "
          f"bound {bound_ms:.5f} ms = {100 * bound_ms / ms:.1f}% of the kernel's time")

    def per_frame(idr: bool, n: int, warmup: int = 2):
        """Median FrameStats split over n frames: forced IDRs of frame 0,
        or P frames alternating between two scroll positions."""
        rows = []
        launches0 = me_mc.launches
        for i in range(warmup + n):
            if idr:
                enc.force_keyframe()
            (_, s, _), = enc.submit(frames[0] if idr else frames[1 + i % 2])
            if s.idr != idr or s.upload_kind == "static":
                _fail(f"timing frame {i} has the wrong kind")
            rows.append(s)
        out = {k: statistics.median(getattr(s, k) for s in rows[warmup:])
               for k in ("device_ms", "upload_ms", "step_ms", "fetch_ms", "pack_ms", "bytes")}
        out["me_mc_launches_per_frame"] = (me_mc.launches - launches0) / len(rows)
        return out

    enc_t = {"idr": per_frame(True, 5), "p": per_frame(False, 20)}
    record["encoder_ms"] = enc_t
    print("device-conversion encoder per frame (median ms): " + json.dumps(enc_t))

    # the host-conversion encoder: median FrameStats split per frame kind
    tenc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **flat_host)
    rounds = _drive_host(tenc, _host_timing_trace(4))[12:]  # the first round warms up
    split = {}
    for kind_name in sorted({r[2] for r in rounds}):
        rows = [r for r in rounds if r[2] == kind_name]
        med = {k: statistics.median(getattr(r[1], k) for r in rows) for k in (
            "classify_ms", "convert_ms", "h2d_ms", "upload_ms", "step_ms", "fetch_ms",
            "unpack_ms", "cavlc_ms", "device_ms", "pack_ms", "bytes")}
        med.update(frames=len(rows), up_bytes=statistics.median(r[3] for r in rows),
                   down_bytes=statistics.median(r[4] for r in rows))
        split[kind_name] = med
    record["host_encoder_ms"] = split
    print("host-conversion encoder per frame kind (median ms, bytes): " + json.dumps(split))
    prof = {"idr": _profile_frames(enc, frames, True, 2),
            "p": _profile_frames(enc, frames, False, 5),
            "delta_p": _profile_host_deltas(tenc, 8)}
    record["profile"] = prof
    print("profile (torch.profiler, profiler on): " + json.dumps(prof))

    # the registry row against ungrouped, unpipelined, and each knob alone,
    # in turns, on a typing run
    typing = _typing_run(40, 300)
    cfgs = {"registry": {}, "flat": flat, "batch4_depth0": {"pipeline_depth": 0},
            "batch1_depth2": {"frame_batch": 1}}
    typing_t = {name: [] for name in cfgs}
    for name in list(cfgs) + list(cfgs)[::-1]:
        typing_t[name].append(_time_typing(cfgs[name], typing, warm=8))
    record["typing_run"] = typing_t
    print(f"1080p typing run, 32 deltas after an IDR and 8 warm-up deltas, submitted back to "
          f"back ({card}, {power_limit}): " + json.dumps(typing_t))
    preg = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda")
    prof_reg = _profile_host_deltas(preg, 8)
    prof_reg["group_sizes"] = dict(preg.group_sizes)
    preg.close()
    record["profile"]["delta_p_registry"] = prof_reg
    print(f"profile of 8 grouped typing deltas, registry row ({card}, {power_limit}): "
          + json.dumps(prof_reg))

    # the entropy plane: per coder, device entropy off and on
    ent_t = {f"{coder}_{'device' if on else 'host'}": _time_entropy(coder, on)
             for coder in ("cavlc", "cabac") for on in (False, True)}
    ent_t["downlink"] = _time_entropy_downlink(dev)
    # an IDR of the phase-5 desktop (a wallpaper dotted with glyph noise):
    # the host coders' pack time, CABAC (Python per MB) against CAVLC (C++)
    noisy = _host_frames(2027)[0]
    for coder in ("cavlc", "cabac"):
        ienc = TorchH264Encoder(W, H, qp=28, device="cuda", entropy_coder=coder, **flat_host)
        (_, st, _), = ienc.submit(noisy)
        ienc.close()
        ent_t[f"idr_{coder}"] = {k: getattr(st, k) for k in (
            "step_ms", "unpack_ms", "cavlc_ms", "pack_ms", "bytes")}
    record["entropy_timing"] = ent_t
    print(f"entropy plane at 1080p ({card}, {power_limit}): " + json.dumps(ent_t))

    # band and tile slicing against the flat solo encoder: 1080p full motion
    # (10 scrolls), and the 4K grid
    scrolls = _scroll_run(W, H, 10)
    band_t = {}
    for name, make in (
            # no tile cache: full motion is full P frames, as in the banded path
            ("solo_flat", lambda: TorchH264Encoder(W, H, qp=28, device="cuda", tile_cache=0,
                                                   **flat_host)),
            ("bands4", lambda: TorchBandedH264Encoder(W, H, qp=28, bands=4, device="cuda")),
            ("grid2x2", lambda: TorchBandedH264Encoder(W, H, qp=28, bands=2, cols=2,
                                                       device="cuda"))):
        benc = make()
        band_t[name] = _time_band_split(benc, scrolls)
        if name != "grid2x2":
            band_t[name]["profile_p"] = _profile_frames(
                benc, scrolls, False, 4, feed=lambda i: scrolls[3 + i % 2])
        benc.close()
    k4enc = TorchBandedH264Encoder(3840, 2160, qp=28, bands=3, cols=2, device="cuda")
    band_t["4k_grid3x2"] = _time_band_split(k4enc, _scroll_run(3840, 2160, 6), n_idr=2)
    k4enc.close()
    record["band_timing"] = band_t
    print(f"band and tile slicing, 1080p full motion and 4K ({card}, {power_limit}): "
          + json.dumps(band_t))

    # multi-session serving at 1, 2, 4 and 8 sessions of 1920x1088 on full
    # motion, then the same frames through 8 solo flat encoders in turn
    ses_t = {f"n{n}": _time_sessions(n) for n in (1, 2, 4, 8)}
    ses_t["solo8_in_turn"] = _time_solo_in_turn(8)
    tick_ops = {k: ses_t[k]["profile_p"].get("device_ops_per_tick") for k in ("n1", "n8")}
    if None in tick_ops.values():
        _fail(f"the profiler counted no device ops for a session P tick: {tick_ops}")
    ses_t["device_ops_ratio_8_to_1"] = tick_ops["n8"] / tick_ops["n1"]
    if tick_ops["n8"] > 1.25 * tick_ops["n1"]:
        _fail(f"an 8-session P tick issues {tick_ops['n8']} device ops, more than 1.25x the "
              f"1-session tick's {tick_ops['n1']}")
    # the batched kernel alone at 8 sessions of 1088x1920
    args8 = _batch_me_inputs(8, 1088, 1920, 20, dev)
    b_ms = _time_cuda(lambda: me_mc.me_mc_batch(*args8), iters=20, hold=True)
    b_issued_ms = _time_cuda(lambda: me_mc.me_mc_batch(*args8), iters=20)
    b_plain_ms = _time_cuda(lambda: me_mc.me_mc_batch_plain(*args8), iters=2, warmup=1)
    b_cands, b_cur = args8[0], args8[1]
    bn, (bh, bw), bk = b_cur.shape[0], b_cur.shape[1:], b_cands.shape[1]
    b_out_bytes = bn * ((bh // 16) * (bw // 16) * 2 * 4 + bh * bw * 4 + 2 * (bh // 2) * (bw // 2) * 4)
    b_bytes = sum(t.numel() * t.element_size() for t in args8) + b_out_bytes
    b_ops = bn * bk * bh * bw
    b_simd_ops = b_ops // 4 if sass["native_simd4"] else b_ops
    b_bytes_ms = b_bytes / HBM_BYTES_PER_S * 1e3
    b_simd_ms = b_simd_ops / INT32_OPS_PER_S * 1e3
    b_bound_ms = max(b_bytes_ms, b_simd_ms)
    ses_t["me_mc_batch8"] = {"ms": b_ms, "host_issued_ms": b_issued_ms, "plain_ms": b_plain_ms,
                             "bound_ms": b_bound_ms, "bytes": b_bytes}
    record["session_timing"] = ses_t
    print(f"multi-session serving, 1920x1088 full motion ({card}, {power_limit}): "
          + json.dumps(ses_t))
    print(f"me_mc_batch 8 sessions x {bk} cands x {bw}x{bh}: {b_ms:.5f} ms (CUDA events, 20 "
          f"launches queued behind a spin kernel; {b_issued_ms:.5f} ms as issued), plain "
          f"{b_plain_ms:.3f} ms; floors: bytes {b_bytes_ms:.5f} ms, operations {b_simd_ms:.5f} "
          f"ms; bound {b_bound_ms:.5f} ms = {100 * b_bound_ms / b_ms:.1f}% of the kernel's time")

    kernels = [{
        "name": "me_mc", "route": "cuda", "source": "selkies_tpu_torch/csrc/me_mc.cu",
        "replaces": me_mc.REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if simd_ms >= bytes_ms else "bytes", "library_ms": None,
        "design": "v2", "shape": f"{ncand} cands x {h}x{w}", "bytes": nbytes,
        "int32_ops": ops, "simd_ops": simd_ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "ops_ms_simd": simd_ms, "sass_vabsdiff4_native": sass["native_simd4"],
        "host_issued_ms": issued_ms, "one_cand_ms": one_ms,
        "bound_share": bound_ms / ms,
        "launches_per_p_frame": launches / p_frames, "launches_host_path": host_launches,
        "launches_per_p_frame_host_path": host_launches / host_p,
        "launches_registry_path": reg_launches,
        "launches_per_p_frame_registry_path": reg_launches / reg_p,
        "launches_entropy_path": a_k1 + b_k1 + c_k1 + d_k1,
        "launches_entropy_path_per_run": {"a": a_k1, "b": b_k1, "c": c_k1, "d": d_k1},
        "launches_band_path": sum(band_launches.values()),
        "launches_per_p_frame_band_path": {k: band_launches[k] / band_p[k]
                                           for k in band_launches},
        "launches_band_path_per_run": band_launches,
        "launches_session_path": ses_launches,
        "launches_per_tick_session_path": ses_ticks,
        "card": card, "power_limit": power_limit,
    }, {
        "name": "me_mc (8 sessions, one launch)", "route": "cuda",
        "source": "selkies_tpu_torch/csrc/me_mc.cu", "replaces": me_mc.REPLACES,
        "launches": ses_launches, "max_abs_err": max_err, "ms": b_ms, "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms, "bound_by": "operations" if b_simd_ms >= b_bytes_ms else "bytes",
        "library_ms": None, "shape": f"{bn} sessions x {bk} cands x {bh}x{bw}",
        "bytes": b_bytes, "simd_ops": b_simd_ops, "bytes_ms": b_bytes_ms,
        "ops_ms_simd": b_simd_ms, "host_issued_ms": b_issued_ms, "bound_share": b_bound_ms / b_ms,
        "launches_per_tick": ses_ticks, "card": card, "power_limit": power_limit,
    }]
    record["kernels"] = kernels
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
