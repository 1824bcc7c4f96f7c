#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (selkies_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --no-timing  # phases 1-9 and 12-14 only (a build-and-check run)

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
12. (run after phase 9, before the timing) the hybrid VP9/AV1 rows and the
   port's registry at 1920x1080, over a seeded desktop trace (the first
   frame, static repeats, typing, a 16-row scroll of a window, a window
   drag, a single-byte change to one channel, a forced keyframe): (a)
   DeviceDeltaFrontend on the card gives the CPU run's dirty maps and
   hints element for element, the one-byte change marks one MB and a
   static frame launches no coarse vote; (b) create_encoder("tpuvp9enc" /
   "tpuav1enc", frontend="device") on the card gives the AUs of the same
   row on the CPU by sha256 (VP9 with libvpx's row-mt off, since libvpx
   does not repeat its own bytes with it on; with it on, the active maps
   and static AUs equal), LibVpxDecoder decodes every VP9 AU, static
   frames are 1 byte (VP9) and 5 bytes (AV1, but the first repeat after a
   keyframe), and frontend "auto" resolves to the device front-end; a row
   whose library does not load prints ``{"row": ..., "skipped": ...}``;
   (c) create_encoder("tpuh264enc"), prewarmed, gives the AUs of
   TorchH264Encoder(frame_batch=4, pipeline_depth=2, scene_qp_boost=6)
   over a 1080p typing run, its first frame an IDR at frame_index 0, with
   K1 launched once per non-static P frame (counts zeroed after prewarm);
13. (run after phase 12, before the timing) the health and observability
   plane, all on the card with the port's own injector, tracer, telemetry
   and device pool: (a) create_encoder("tpuh264enc") over phase 12's
   typing trace with the tracer and telemetry off, then on, then on the
   CPU: the AUs sha256-equal in all three, ``classify`` once per submit,
   ``step`` / ``fetch`` / ``unpack`` / ``pack`` and the
   ``selkies_tile_cache_*`` counters as the CPU run's, K1 once per
   non-static P frame with the hooks on (counts zeroed just before), the
   chrome trace written to chiprun_out/phase13_trace.json; (b)
   ``frontend@4,9:raise`` on that row: exactly those submits raise, the
   other frames come out in order and equal the CPU run under the spec;
   (c) ``device:0@3:raise`` on TorchMultiSessionH264Service(8, 1920, 1088):
   tick 3 raises DeviceFault("0") with no tick in flight, note_tick_failure
   names the card at threshold 1, the other ticks equal the CPU run under
   the spec; TorchBandedH264Encoder(1920, 1080, bands=4) with device=None
   carves onto the card through the pool and, under
   ``device:0@every:1:flap`` at threshold 3, the card is quarantined from
   frame 3 on while the AUs equal phase 8's; after probation (an injected
   clock) pool.tick() runs the real probe on the card and readmits it on
   the third; the probe's ms; (d) DeviceMonitor reads the card's total
   and used memory;
14. (run after phase 13, before the timing) the fleet's device-facing
   layer, all on the card with the port's own pool, injector and telemetry,
   K1's counter zeroed just before each part: (a)
   TorchBandedFleetService(4, 1920, 1080, qp=28, bands=2) (the shared carve
   through the pool) over a seeded 8-tick full-motion trace (an IDR tick,
   P ticks where each session scrolls or types its own desktop, a static
   repeat for one session, set_qp on one, force_keyframe on another) with
   SELKIES_OCCUPANCY=0 (the serial tick) and through
   OccupancyScheduler.for_service: the AUs sha256-equal, equal to 4 solo
   TorchBandedH264Encoder(bands=2) card encoders, the trace at 4 x 640x384
   through the scheduler equal to the port's CPU run, K1 launched twice
   (bands) per non-static banded P frame; (b) checkpoint and re-carve of
   session 0 after tick 3 equal to an oracle forced a keyframe there,
   session 1 parked (b"", no IDR) and un-parked as a fresh IDR; (c)
   MixedTenancyService(TorchMultiSessionH264Service(4, 1920, 1088),
   TorchBandedFleetService(2, 1920, 1088, bands=2)): the AUs equal with
   occupancy off and on, K1 once per tick for the batch unit plus twice per
   banded P session; (d) ``sched:1@3:drop;sched:2@4:raise`` on (a)'s
   service: the dropped tick gives b"", the raising tick raises after the
   others ran, the two sessions then equal oracles that never saw those
   frames and every other session equals (a); (e) SessionPlacer(devices=None):
   the shared carve on the pool's one card, an accepted admission, and a
   DrainController drain (the service's force-keyframe, flush and hand-off)
   with a checkpoint per session inside its deadline;
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
   kernel at 8 x 1088x1920 by CUDA events against its byte bound; the
   hybrid front-end step per frame kind (static, typing, scroll, full; host
   clock around the synchronised step), its upload (host clock and CUDA
   events), its device ops and idle share over 8 steps (torch.profiler),
   FramePrep.dirty_tiles on the same frames, and the VP9/AV1 rows' median
   per-frame split (front-end, library, conversion ms, AU bytes) per frame
   kind with the device and the host front-end; the registry row's typing
   run with the tracer and telemetry off and on, in turns (off, on, on,
   off): frames per second, median and p95 latency, the span counts and
   median ms per span name, and the probe's ms; the fleet (phase 14's (a)
   and (c) configurations on full motion, with the card's name and power
   limit): occupancy off and on on one service in three alternating pairs
   of 6 P ticks (median tick ms, fps across sessions, the dispatch and
   complete ms per unit, the scheduler's overlap and sched_wait per
   session), the device ops and idle share per tick (torch.profiler over
   3 ticks each way), and the ms from a checkpoint to the first AU after a
   re-carve;
11. print the ``{"kernels": [...]}`` line (K1 at the solo shape and as the
    8-session launch, with its launches on every path, the fleet's
    included), then the ``{"ok": true, ...}`` line.

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


def _time_typing(cfg: dict, frames, warm: int, hooks: bool = False) -> dict:
    """Frames per second, per-frame latency (a frame's submit() call to the
    return of the call that hands back its AU) and the median FrameStats
    split over frames[1 + warm:], after an IDR and ``warm`` deltas, on a
    fresh encoder of configuration ``cfg``. The frames are submitted back to
    back, not paced to a capture rate. With ``hooks`` the tracer and the
    telemetry bus are on over the timed frames, and the span counts, their
    medians and the tracer's summary are returned too."""
    import torch
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
    from selkies_tpu_torch.monitoring.tracing import tracer

    enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **cfg)
    for f in frames[:1 + warm]:
        enc.submit(f)
    enc.flush()
    torch.cuda.synchronize()
    _set_hooks(hooks)
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
    spans = (_span_counts(), _span_medians(), tracer.summary()) if hooks else None
    _set_hooks(False)
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
    if spans is not None:
        out["span_counts"], out["span_median_ms"], out["span_summary"] = spans
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


# -- phase 12: the hybrid VP9/AV1 rows and the registry ---------------------

HYBRID_ROWS = (("tpuvp9enc", "libvpx"), ("tpuav1enc", "libaom"))


def _hybrid_trace():
    """-> [(frame, op, kind)], 13 frames at 1080p: desktop A (the first
    frame), two static repeats, two typed lines, a 1024x528 window over A,
    a 16-row scroll of the window (a new line at its bottom), the window
    dragged 24 rows down and 40 columns right, a single-byte change to one
    channel, a static repeat, a forced keyframe on it and two repeats."""
    a, win, _, scrolled = _host_frames(2040)
    rng = np.random.default_rng(2041)
    t1 = _type(a, rng, 300, 200)
    t2 = _type(t1, rng, 332, 260)
    win = t2.copy()
    win[192:720, 384:1408] = scrolled[192:720, 384:1408]
    scroll = win.copy()
    scroll[192:704, 384:1408] = win[208:720, 384:1408]
    scroll[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
    drag = t2.copy()
    drag[216:744, 424:1448] = scroll[192:720, 384:1408]
    one_byte = drag.copy()
    one_byte[700, 1000, 1] ^= 1
    return [(a, None, "full"), (a.copy(), None, "static"), (a.copy(), None, "static"),
            (t1, None, "typing"), (t2, None, "typing"), (win, None, "full"),
            (scroll, None, "scroll"), (drag, None, "drag"), (one_byte, None, "one_byte"),
            (one_byte.copy(), None, "static"), (one_byte.copy(), "key", "key"),
            (one_byte.copy(), None, "static"), (one_byte.copy(), None, "static")]


def _drive_hybrid(enc, trace, rounds: int = 1):
    """-> per frame: (sha256, the map handed to set_active_map or None,
    kind, front-end ms, library ms, conversion ms, AU) and the static and
    active-map counts. The front-end ms is the host clock around the row's
    classification; the library ms is FrameStats' encode time less the
    device front-end's share (0 for a frame the row does not encode)."""
    classify, set_map = enc._classify_mbs, enc.set_active_map
    seen: dict = {}

    def timed(frame):
        t0 = time.perf_counter()
        out = classify(frame)
        seen["fe_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def spy(active):
        if active is not None:
            seen["map"] = hashlib.sha256(np.asarray(active, bool).tobytes()).hexdigest()
        return set_map(active)

    enc._classify_mbs, enc.set_active_map = timed, spy
    rows = []
    for r in range(rounds):
        for frame, op, kind in trace:
            if op == "key":
                enc.force_keyframe()
            seen.pop("map", None)
            au = enc.encode_frame(frame)
            st = enc.last_stats
            # the static short-cut converts nothing: its FrameStats has pack_ms 0
            coded = st.pack_ms > 0
            fe_dev = enc.frontend_device_ms if enc.frontend_mode == "device" else 0.0
            lib_ms = (st.device_ms - fe_dev) if coded else 0.0
            rows.append((hashlib.sha256(au).hexdigest(), seen.get("map"),
                         kind if rows else "first", seen["fe_ms"], lib_ms,
                         st.pack_ms, au))
    counts = (enc.static_frames, enc.active_map_frames)
    enc.close()
    return rows, counts


def _hybrid_phase() -> dict:
    """(a) the device front-end on the card against the CPU; (b) the VP9
    and AV1 rows from the registry on the card against the CPU; (c) the
    tpuh264enc row from the registry, prewarmed, against a directly built
    encoder, with K1's launches counted over that run."""
    import torch

    from selkies_tpu_torch.models import libaom_enc, libvpx_enc
    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend
    from selkies_tpu_torch.models.registry import create_encoder

    trace = _hybrid_trace()
    out: dict = {}
    # (a) the front-end, a reset at the keyframe
    fe_runs = {}
    for dev in ("cuda", "cpu"):
        fe = DeviceDeltaFrontend(W, H, device=dev)
        steps = []
        for frame, op, _ in trace:
            if op == "key":
                fe.reset()
            votes = fe.votes
            steps.append((*fe.step(frame), fe.votes - votes))
        fe_runs[dev] = steps
    for i, ((gd, gh, gv), (cd, ch, cv), (_, _, kind)) in enumerate(
            zip(fe_runs["cuda"], fe_runs["cpu"], trace)):
        if cd is None:
            if gd is not None or gh is not None:
                _fail(f"front-end frame {i}: the card gave a map where the cpu gave none")
            continue
        if gd.shape != (68, 120) or not np.array_equal(gd, cd) or not np.array_equal(gh, ch):
            _fail(f"front-end frame {i} ({kind}): the card's map or hints differ from the cpu's")
        if gv != cv or gv != int(cd.any()):
            _fail(f"front-end frame {i} ({kind}): {gv} votes on the card, {cv} on the cpu")
        if kind == "static" and (cd.any() or gv):
            _fail(f"front-end frame {i}: a static frame is dirty or voted")
        if kind == "one_byte" and int(cd.sum()) != 1:
            _fail(f"front-end: the one-byte change marks {int(cd.sum())} MBs")
    out["frontend"] = {
        "frames": [k for *_, k in trace],
        "dirty_mbs": [None if d is None else int(d.sum()) for d, _, _ in fe_runs["cuda"]],
        "hints": [None if h is None else h.tolist() for _, h, _ in fe_runs["cuda"]],
        "votes": sum(v for *_, v in fe_runs["cuda"])}
    print("hybrid front-end 1920x1080: the card's dirty maps and hints equal the cpu run's "
          f"on {len(trace)} frames; dirty MBs {out['frontend']['dirty_mbs']}; votes "
          f"{out['frontend']['votes']} (none on a static frame)")

    # (b) the rows, frontend="device", the card against the cpu
    avail = {"libvpx": libvpx_enc.libvpx_available(), "libaom": libaom_enc.libaom_available()}
    for row, lib in HYBRID_ROWS:
        if not avail[lib]:
            skip = {"row": row, "skipped": f"{lib} not loadable"}
            print(json.dumps(skip))
            out[row] = skip
            continue
        auto = create_encoder(row, width=W, height=H)
        if auto.frontend_mode != "device" or auto.device.type != "cuda":
            _fail(f"{row}: frontend 'auto' resolved to {auto.frontend_mode} on "
                  f"{auto.device}")
        auto.close()
        # libvpx does not repeat its own bytes with VP9 row-mt on (the
        # port's CPU tests): byte equality is held with it off, as
        # SELKIES_VP9_ROW_MT=0 sets; with it on, the maps and static AUs
        vp9 = row == "tpuvp9enc"
        modes = ("probed", "off") if vp9 else ("probed",)
        probed = libvpx_enc._row_mt_available() if vp9 else None
        runs = {}
        for mode in modes:
            if vp9:
                libvpx_enc._row_mt_state = probed if mode == "probed" else False
            for dev in ("cuda", "cpu"):
                enc = create_encoder(row, width=W, height=H, frontend="device", device=dev)
                runs[mode, dev] = _drive_hybrid(enc, trace)
        if vp9:
            libvpx_enc._row_mt_state = probed
        exact = "off" if vp9 else "probed"
        (g, gc), (c, cc) = runs[exact, "cuda"], runs[exact, "cpu"]
        if [r[0] for r in g] != [r[0] for r in c] or gc != cc:
            bad = [i for i, (x, y) in enumerate(zip(g, c)) if x[0] != y[0]]
            _fail(f"{row}: the card's AUs differ from the cpu run's at frames {bad}")
        for mode in modes:
            (g, gc), (c, cc) = runs[mode, "cuda"], runs[mode, "cpu"]
            if [r[1] for r in g] != [r[1] for r in c] or gc != cc:
                _fail(f"{row} ({mode}): the active maps or counts differ from the cpu run's")
            statics = [r[6] for r in g if r[2] == "static"]
            size = 1 if vp9 else 5
            # AV1: the first repeat after each keyframe is an all-skip encode
            reshown = [s for s in statics if len(s) == size]
            if len(reshown) != len(statics) - (0 if vp9 else 2):
                _fail(f"{row} ({mode}): static AU sizes {[len(s) for s in statics]}")
            if vp9:
                dec = libvpx_enc.LibVpxDecoder()
                shown = [len(dec.decode(r[6])) for r in g]
                dec.close()
                if shown != [1] * len(g):
                    _fail(f"{row} ({mode}): decoded pictures per AU {shown}")
        g, counts = runs[exact, "cuda"]
        out[row] = {"exact": exact, "row_mt_probed": probed,
                    "sha256": [r[0] for r in g], "bytes": [len(r[6]) for r in g],
                    "static_frames": counts[0], "active_map_frames": counts[1]}
        print(f"{row} 1920x1080, frontend device: the card's AUs sha256-equal the cpu run's "
              f"({'row-mt off' if exact == 'off' else 'as configured'}); active maps and "
              f"static AUs equal with row-mt {f'as probed ({probed})' if vp9 else 'as configured'}; "
              f"AU bytes {out[row]['bytes']}; static {counts[0]}, active-map {counts[1]}; "
              f"'auto' resolves to the device front-end")

    # (c) tpuh264enc from the registry, prewarmed, against a direct build
    typing = _typing_run(12, 300)
    reg = create_encoder("tpuh264enc", width=W, height=H, device="cuda")
    reg.prewarm()
    if reg.frame_index != 0 or not reg._force_idr:
        _fail(f"prewarm left frame_index {reg.frame_index}, force_idr {reg._force_idr}")
    trace_h = [(f, None) for f in typing]
    me_mc.launches = 0
    got, _ = _drive_registry(reg, trace_h)
    torch.cuda.synchronize()
    launches = me_mc.launches
    reg.close()
    direct = TorchH264Encoder(W, H, qp=28, frame_batch=4, pipeline_depth=2, scene_qp_boost=6,
                              device="cuda")
    want, _ = _drive_registry(direct, trace_h)
    direct.close()
    if [s for s, _ in got] != [s for s, _ in want]:
        _fail("tpuh264enc from the registry: AUs differ from the direct encoder's")
    first = got[0][1]
    if not first.idr or first.frame_index != 0:
        _fail(f"after prewarm the first frame is idr={first.idr}, index {first.frame_index}")
    p_frames = sum(1 for _, st in got if not st.idr and st.upload_kind != "static")
    if launches != p_frames:
        _fail(f"tpuh264enc registry row: me_mc launched {launches} times for {p_frames} P frames")
    out["tpuh264enc"] = {"frames": len(got), "p_frames": p_frames, "me_mc_launches": launches,
                         "kinds": [st.upload_kind for _, st in got]}
    print(f"tpuh264enc from the registry at 1920x1080 (prewarmed): {len(got)} typing-run AUs "
          f"sha256-equal a TorchH264Encoder(frame_batch=4, pipeline_depth=2, "
          f"scene_qp_boost=6); the first an IDR at frame_index 0; me_mc launched {launches} "
          f"times for {p_frames} P frames")
    return out


def _time_hybrid(card: str, power_limit: str) -> dict:
    """The front-end step on the card per frame kind, its upload, its
    device ops and idle share (torch.profiler), FramePrep.dirty_tiles on
    the same frames, and the VP9/AV1 rows' per-frame split with each
    front-end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.models import libaom_enc, libvpx_enc
    from selkies_tpu_torch.models.frameprep import FramePrep
    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend
    from selkies_tpu_torch.models.registry import create_encoder

    trace = _hybrid_trace()
    rng = np.random.default_rng(2042)
    a, t1, win, scroll = trace[0][0], trace[3][0], trace[5][0], trace[6][0]
    noise = [rng.integers(0, 255, (H, W, 4), np.uint8) for _ in range(2)]
    # each kind alternates two frames, so that every step is that kind
    pairs = {"static": (a, a), "typing": (a, t1), "scroll": (win, scroll),
             "full": (noise[0], noise[1])}
    n, warm = 20, 4
    out: dict = {"card": card, "power_limit": power_limit, "steps": n}
    fe = DeviceDeltaFrontend(W, H, device="cuda")
    prep = FramePrep(W, H, 1920, 1088, nslots=2)
    for kind, (f0, f1) in pairs.items():
        feed = [f1 if i % 2 == 0 else f0 for i in range(warm + n)]
        fe.reset()
        fe.step(f0)
        step_ms, dirty = [], []
        for f in feed:
            d, _ = fe.step(f)
            step_ms.append(fe.last_device_ms)
            dirty.append(int(d.sum()))
        if (kind == "static") == any(dirty):
            _fail(f"front-end timing: {kind} frames gave dirty MB counts {sorted(set(dirty))}")
        prep.reset()
        prep.dirty_tiles(f0, 128)
        host_ms = []
        for f in feed:
            t0 = time.perf_counter()
            prep.dirty_tiles(f, 128)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in feed[:8]:
                fe.step(f)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        act = _device_activity(prof, wall_ms)
        if isinstance(act.get("device_ops"), int):
            act["device_ops_per_step"] = act["device_ops"] / 8
        out[kind] = {"step_ms": statistics.median(step_ms[warm:]),
                     "dirty_mbs": statistics.median(dirty[warm:]),
                     "frameprep_dirty_tiles_ms": statistics.median(host_ms[warm:]),
                     "profile_8_steps": act}
    # the upload alone: host staging copy + the pinned copy, host clock to
    # its completion, and the copy by CUDA events
    h2d_host, h2d_dev = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(warm + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fe._upload(noise[i % 2])
        end.record()
        end.synchronize()
        h2d_host.append((time.perf_counter() - t0) * 1e3)
        h2d_dev.append(start.elapsed_time(end))
    out["h2d"] = {"bytes": H * W * 4, "host_ms": statistics.median(h2d_host[warm:]),
                  "events_ms": statistics.median(h2d_dev[warm:])}
    fe.reset()
    # the rows' per-frame split, each front-end, 3 rounds (the first warms up)
    avail = {"libvpx": libvpx_enc.libvpx_available(), "libaom": libaom_enc.libaom_available()}
    for row, lib in HYBRID_ROWS:
        if not avail[lib]:
            out[row] = {"skipped": f"{lib} not loadable"}
            continue
        for mode in ("device", "host"):
            enc = create_encoder(row, width=W, height=H, frontend=mode, device="cuda")
            rows, _ = _drive_hybrid(enc, trace, rounds=3)
            rows = rows[len(trace):]
            split = {}
            for kind in dict.fromkeys(r[2] for r in rows):
                sel = [r for r in rows if r[2] == kind]
                split[kind] = {"frames": len(sel),
                               "frontend_ms": statistics.median(r[3] for r in sel),
                               "library_ms": statistics.median(r[4] for r in sel),
                               "convert_ms": statistics.median(r[5] for r in sel),
                               "au_bytes": statistics.median(len(r[6]) for r in sel)}
            out[f"{row}_{mode}"] = split
    return out



# -- phase 13: the health and observability plane ----------------------------

def _set_hooks(on: bool) -> None:
    """The port's tracer and telemetry bus, reset, then on or off."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.monitoring.tracing import tracer

    for plane in (tracer, telemetry):
        plane.reset()
        if on:
            plane.enable()
        else:
            plane.disable()


def _span_counts() -> dict:
    from selkies_tpu_torch.monitoring.tracing import tracer

    return {name: a["count"] for name, a in tracer.summary().items()}


def _span_medians() -> dict:
    """Median ms per span name over the tracer's ring."""
    from selkies_tpu_torch.monitoring.tracing import tracer

    by: dict = {}
    for name, _, dur, _ in list(tracer._ring):
        by.setdefault(name, []).append(dur * 1e3)
    return {k: statistics.median(v) for k, v in sorted(by.items())}


def _hook_site_us(n: int = 200000) -> dict:
    """Host microseconds of one hook site, off and on: a tracer span, a
    telemetry count, a stage_ms and the injector read (no spec set), each
    timed over ``n`` calls on this host's clock."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.monitoring.tracing import tracer
    from selkies_tpu_torch.resilience.faultinject import get_injector, reset_faults

    def per_call(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def span():
        with tracer.span("step"):
            pass

    reset_faults()
    out = {}
    for on in (False, True):
        _set_hooks(on)
        key = "on" if on else "off"
        out[f"span_{key}"] = per_call(span)
        out[f"count_{key}"] = per_call(
            lambda: telemetry.count("selkies_tile_cache_frames_total", kind="delta"))
        out[f"stage_ms_{key}"] = per_call(lambda: telemetry.stage_ms("step", 1.0))
    _set_hooks(False)
    out["injector_unset"] = per_call(get_injector)
    return out


def _run_registry_row(trace, dev: str, hooks: bool, spec: str | None = None) -> dict:
    """The registry's tpuh264enc row over ``trace`` with the hooks on or
    off and an optional SELKIES_FAULTS spec: the AUs (sha256 with their
    meta, in completion order), the submits that raised, K1's launches,
    the span counts and the tile-cache counters."""
    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.models.registry import create_encoder
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.resilience import faultinject

    _set_hooks(hooks)
    faultinject.reset_faults()
    if spec:
        faultinject.configure_faults(spec)
    enc = create_encoder("tpuh264enc", width=W, height=H, device=dev)
    rows, raised = [], []
    me_mc.launches = 0
    try:
        for i, frame in enumerate(trace):
            try:
                rows += enc.submit(frame, meta=i)
            except faultinject.InjectedFault:
                raised.append(i)
        rows += enc.flush()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = me_mc.launches
    finally:
        enc.close()
        faultinject.reset_faults()
    counters = {k: v for k, v in telemetry.rollup()["counters"].items()
                if k.startswith("selkies_tile_cache")}
    return {"aus": [(hashlib.sha256(au).hexdigest(), m) for au, _, m in rows],
            "p_frames": sum(1 for _, st, _ in rows if not st.idr and st.upload_kind != "static"),
            "raised": raised, "me_mc_launches": launches, "spans": _span_counts(),
            "counters": counters}


def _observability_phase(band_shas: list) -> dict:
    """(a) the hooks change no byte; (b) the frontend fault site; (c)
    device chaos on the session service and the banded encoder, and a
    readmission through the real probe; (d) the device monitor. Only
    injected faults: a real CUDA error would poison the context for every
    later phase."""
    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.monitoring.device_monitor import DeviceMonitor
    from selkies_tpu_torch.monitoring.tracing import tracer
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
    from selkies_tpu_torch.resilience import devhealth, faultinject

    out: dict = {}
    typing = _typing_run(12, 300)  # phase 12's typing trace
    # (a) the registry row, hooks off then on, and the CPU run with them on
    t0 = time.perf_counter()
    off = _run_registry_row(typing, "cuda", hooks=False)
    on = _run_registry_row(typing, "cuda", hooks=True)
    trace_json = tracer.chrome_trace()
    cpu = _run_registry_row(typing, "cpu", hooks=True)
    _set_hooks(False)
    if not off["aus"] == on["aus"] == cpu["aus"] or len(on["aus"]) != len(typing):
        _fail("phase 13 (a): the registry row's AUs differ between hooks off, hooks on and "
              "the cpu run")
    if [m for _, m in on["aus"]] != list(range(len(typing))):
        _fail(f"phase 13 (a): frames came out as {[m for _, m in on['aus']]}")
    if off["spans"] or off["counters"]:
        _fail(f"phase 13 (a): hooks off recorded {off['spans']} {off['counters']}")
    if on["spans"].get("classify") != len(typing):
        _fail(f"phase 13 (a): {on['spans'].get('classify')} classify spans for "
              f"{len(typing)} submits")
    names = ("step", "fetch", "unpack", "pack")
    if any(on["spans"].get(k) != cpu["spans"].get(k) for k in names) or not on["spans"].get(
            "step"):
        _fail(f"phase 13 (a): spans on the card {on['spans']}, on the cpu {cpu['spans']}")
    if on["counters"] != cpu["counters"] or not on["counters"]:
        _fail(f"phase 13 (a): tile-cache counters {on['counters']} != cpu {cpu['counters']}")
    for run_name, run in (("off", off), ("on", on)):
        if run["me_mc_launches"] != run["p_frames"]:
            _fail(f"phase 13 (a), hooks {run_name}: me_mc launched {run['me_mc_launches']} "
                  f"times for {run['p_frames']} P frames")
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase13_trace.json").write_text(trace_json)
    out["a"] = {"frames": len(typing), "spans": on["spans"], "counters": on["counters"],
                "me_mc_launches": on["me_mc_launches"], "p_frames": on["p_frames"],
                "trace_events": len(json.loads(trace_json)["traceEvents"]),
                "seconds": time.perf_counter() - t0}
    print(f"phase 13 (a) tpuh264enc 1920x1080, {len(typing)} typing frames: AUs sha256-equal "
          f"with hooks off, hooks on and the cpu run; spans {on['spans']} (step/fetch/unpack/"
          f"pack as the cpu run's); tile-cache counters {json.dumps(on['counters'])} as the cpu "
          f"run's; me_mc launched {on['me_mc_launches']} times for {on['p_frames']} P frames "
          f"with the hooks on; chrome trace in chiprun_out/phase13_trace.json")

    # (b) the frontend fault site on the registry row
    t0 = time.perf_counter()
    spec = "frontend@4,9:raise"
    g = _run_registry_row(typing, "cuda", hooks=False, spec=spec)
    c = _run_registry_row(typing, "cpu", hooks=False, spec=spec)
    if g["raised"] != [3, 8] or c["raised"] != [3, 8]:
        _fail(f"phase 13 (b): submits {g['raised']} raised on the card, {c['raised']} on the cpu")
    want_meta = [i for i in range(len(typing)) if i not in (3, 8)]
    if [m for _, m in g["aus"]] != want_meta or g["aus"] != c["aus"]:
        _fail("phase 13 (b): the frames after the faults differ or come out of order")
    out["b"] = {"spec": spec, "raised": g["raised"], "frames_out": len(g["aus"]),
                "me_mc_launches": g["me_mc_launches"], "seconds": time.perf_counter() - t0}
    print(f"phase 13 (b) {spec} on the registry row: submits {g['raised']} raised; the other "
          f"{len(g['aus'])} frames came out in order, sha256-equal the cpu run under the same "
          f"spec")

    # (c) device chaos: the session service, the banded encoder, readmission
    t0 = time.perf_counter()
    spec = "device:0@3:raise"
    bases = [_session_base(i, SW, SH) for i in range(8)]
    ses: dict = {}
    for dev_name in ("cuda", "cpu"):
        devhealth.set_device_pool(devhealth.DevicePool(
            None if dev_name == "cuda" else [torch.device("cpu")], fail_threshold=1))
        faultinject.configure_faults(spec)
        svc = TorchMultiSessionH264Service(8, SW, SH, qp=28, device=dev_name)
        ticks = []
        for t in range(5):
            batch = np.stack([_session_frame(b, i, t) for i, b in enumerate(bases)])
            try:
                ticks.append([hashlib.sha256(au).hexdigest() for au in svc.encode_tick(batch)])
            except devhealth.DeviceFault as e:
                ticks.append(("fault", e.chip, svc._inflight,
                              devhealth.note_tick_failure(e, svc.devices)))
        svc.close()
        ses[dev_name] = ticks
    faultinject.reset_faults()
    if ses["cuda"][2] != ("fault", "0", 0, "0"):
        _fail(f"phase 13 (c): tick 3 of the service gave {ses['cuda'][2]}")
    if ses["cuda"] != ses["cpu"]:
        _fail("phase 13 (c): the service's AUs under device:0@3:raise differ from the cpu run's")
    clock = [0.0]
    pool = devhealth.set_device_pool(devhealth.DevicePool(
        fail_threshold=3, probation_s=5.0, readmit_after=3, clock=lambda: clock[0]))
    faultinject.configure_faults("device:0@every:1:flap")
    btrace = _band_trace()
    benc = TorchBandedH264Encoder(W, H, qp=28, bands=4)
    if (benc.device.type, benc.bands, [devhealth.chip_key(d) for d in benc.devices]) != (
            "cuda", 4, ["0"]):
        _fail(f"phase 13 (c): the banded carve through the pool gave {benc.device}, "
              f"{benc.bands} bands, devices {benc.devices}")
    me_mc.launches = 0
    brows, bquar, b_p = [], [], 0
    for frame, op in btrace:
        if op == "idr":
            benc.force_keyframe()
        (au, st, _), = benc.submit(frame)
        brows.append(hashlib.sha256(au).hexdigest())
        bquar.append(pool.quarantined_keys())
        b_p += not st.idr and st.upload_kind != "static"
    torch.cuda.synchronize()
    b_launches = me_mc.launches
    benc.close()
    faultinject.reset_faults()
    if brows != band_shas:
        _fail("phase 13 (c): the banded encoder's AUs under device:0@every:1:flap differ from "
              "phase 8's bands=4 run")
    if bquar[:2] != [[], []] or any(q != ["0"] for q in bquar[2:]):
        _fail(f"phase 13 (c): quarantined chips after each frame {bquar}")
    if pool.stats()["quarantined"]["0"]["failures"] != len(btrace) or b_launches != 4 * b_p:
        _fail(f"phase 13 (c): pool {pool.stats()}, me_mc {b_launches} for {b_p} P frames")
    # readmission: probation over, the real probe on the card, readmit_after probes
    clock[0] += 5.5
    probes = [pool.tick() for _ in range(3)]
    if probes != [[], [], ["0"]] or pool.quarantined_keys():
        _fail(f"phase 13 (c): probes after probation gave {probes}, pool {pool.stats()}")
    dev0 = torch.device("cuda", 0)
    probe_ms = []
    for _ in range(21):
        tp = time.perf_counter()
        if not devhealth._default_probe(dev0):
            _fail("phase 13 (c): the card's probe failed")
        probe_ms.append((time.perf_counter() - tp) * 1e3)
    devhealth.reset_device_pool()
    out["c"] = {"service_ticks": [x if isinstance(x, tuple) else "ok" for x in ses["cuda"]],
                "banded_frames": len(brows), "banded_me_mc_launches": b_launches,
                "banded_quarantined_after": bquar,
                "probes": probes, "probe_ms_median": statistics.median(probe_ms[1:]),
                "seconds": time.perf_counter() - t0}
    print(f"phase 13 (c) device chaos: service 8 x {SW}x{SH} with {spec}: tick 3 raised "
          f"DeviceFault('0') with no tick in flight, note_tick_failure -> '0' (threshold 1), "
          f"the other ticks sha256-equal the cpu run; bands=4 1920x1080 carved through the pool "
          f"onto cuda:0 with device:0@every:1:flap: quarantined at frame 3 (threshold 3), "
          f"{len(brows)} AUs equal phase 8's; after probation 3 probes readmitted the card "
          f"({probes}); probe {out['c']['probe_ms_median']:.4f} ms (median of 20)")

    # (d) the device monitor
    mon = DeviceMonitor(device="cuda")
    total_mb, used_mb = mon._memory_mb()
    card_mb = torch.cuda.get_device_properties(0).total_memory / 1e6
    if abs(total_mb - card_mb) > 0.01 * card_mb or not 0 < used_mb < total_mb:
        _fail(f"phase 13 (d): the monitor read {total_mb} MB total, {used_mb} used; the card "
              f"has {card_mb} MB")
    mon.observe_encode(5.0)
    load = mon._load()
    if not 0.0 <= load <= 1.0:
        _fail(f"phase 13 (d): load {load}")
    out["d"] = {"total_mb": total_mb, "used_mb": used_mb, "card_mb": card_mb, "load": load}
    print(f"phase 13 (d) DeviceMonitor: total {total_mb:.1f} MB (the card's "
          f"{card_mb:.1f} MB), used {used_mb:.1f} MB, load {load:.4f}")
    return out


# -- phase 14: the fleet's banded service, lifecycle and occupancy scheduler --

FLEET_N, FLEET_TICKS = 4, 8
# tick -> ops before it: ("qp", session, qp) / ("key", session); session 3
# repeats its tick-3 frame at tick 4 (a static frame)
FLEET_OPS = {3: [("qp", 1, 24)], 5: [("key", 2)]}
FLEET_STATIC = {(3, 4)}
# the mixed tenancy's ops: a banded session's keyframe, then a batch one's
MIXED_OPS = {3: [("key", 4)], 4: [("key", 1)]}
MIXED_TICKS = 6
FLEET_SMALL = (640, 384)  # 24 MB rows: 2 bands of 12 (368's 23 rows clamp to 1 band)


def _fleet_bases(n: int, w: int, h: int) -> list:
    """Phase 9's desktops (session i's own seed), cut to h rows."""
    return [_session_base(i, w, (h + 15) // 16 * 16)[:h] for i in range(n)]


def _fleet_frame(bases, i: int, t: int):
    """Session i's frame at tick t: phase 9's scroll (even sessions) or
    typing (odd), with FLEET_STATIC's repeats."""
    if (i, t) in FLEET_STATIC:
        t -= 1
    return _session_frame(bases[i], i, t)


def _fleet_batch(bases, t: int):
    return np.stack([_fleet_frame(bases, i, t) for i in range(len(bases))])


def _drive_fleet(svc, tick, bases, ticks=range(FLEET_TICKS), ops=FLEET_OPS, hook=None):
    """-> per tick (the sessions' AU sha256s, or the name of the exception
    the tick raised, last_idrs, K1 launches, the tick's host ms).
    ``hook(t)`` runs before tick t's frames go in, after its ops."""
    from selkies_tpu_torch.models.h264 import me_mc

    out = []
    for t in ticks:
        for op in ops.get(t, ()):
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
        if hook is not None:
            hook(t)
        batch = _fleet_batch(bases, t)
        k0 = me_mc.launches
        t0 = time.perf_counter()
        try:
            aus = tick(batch)
        except Exception as e:  # noqa: BLE001 - the phase checks which tick raised what
            row = type(e).__name__
        else:
            if not all(au == b"" or au.startswith(b"\x00\x00\x00\x01") for au in aus):
                _fail(f"fleet tick {t}: an access unit is not Annex-B")
            row = [hashlib.sha256(au).hexdigest() for au in aus]
        out.append((row, list(svc.last_idrs), me_mc.launches - k0,
                    (time.perf_counter() - t0) * 1e3))
    return out


def _fleet_solo(bases, i: int, ticks, w: int, h: int, key_at=(), dev: str = "cuda") -> list:
    """Session i's AU sha256s from a solo TorchBandedH264Encoder(bands=2)
    fed the given ticks' frames, with the trace's QP and keyframe ops for
    session i and keyframes forced at ``key_at``."""
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    enc = TorchBandedH264Encoder(w, h, qp=28, bands=2, device=dev)
    out = []
    for t in ticks:
        for op in FLEET_OPS.get(t, ()):
            if op[1] == i:
                if op[0] == "qp":
                    enc.set_qp(op[2])
                else:
                    enc.force_keyframe()
        if t in key_at:
            enc.force_keyframe()
        out.append(hashlib.sha256(enc.encode_frame(_fleet_frame(bases, i, t))).hexdigest())
    enc.close()
    return out


def _fleet_launches_ok(run, bands: int, banded: range, batch: range = range(0)) -> list:
    """Expected K1 launches per tick: ``bands`` per banded session that
    coded a P frame (not an IDR, not static, not parked), plus one for the
    batch unit when it has a P session."""
    want = []
    for t, (row, idrs, *_) in enumerate(run):
        if isinstance(row, str):
            want.append(None)
            continue
        empty = hashlib.sha256(b"").hexdigest()
        p = sum(1 for i in banded if not idrs[i] and (i, t) not in FLEET_STATIC
                and row[i] != empty)
        want.append(bands * p + (1 if any(not idrs[i] for i in batch) else 0))
    return want


def _occupancy_tick(svc):
    """The fleet's choice: the scheduler when SELKIES_OCCUPANCY is on and
    the service has a schedulable shape, else the serial tick."""
    from selkies_tpu_torch.parallel.occupancy import OccupancyScheduler, occupancy_enabled

    sched = OccupancyScheduler.for_service(svc) if occupancy_enabled() else None
    return sched, (sched.encode_tick if sched is not None else svc.encode_tick)


def _fleet_phase() -> dict:
    """(a) the banded fleet service, serial and scheduled, against solo
    encoders and the CPU; (b) checkpoint + re-carve, parking; (c) mixed
    tenancy; (d) sched drop and raise; (e) the placer and a drain."""
    import asyncio
    import os

    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.parallel.lifecycle import (
        DrainController,
        SessionPlacer,
        checkpoint_session,
    )
    from selkies_tpu_torch.parallel.occupancy import MixedTenancyService, OccupancyScheduler
    from selkies_tpu_torch.parallel.serving import (
        TorchBandedFleetService,
        TorchMultiSessionH264Service,
    )
    from selkies_tpu_torch.resilience import devhealth, faultinject

    out: dict = {}
    _set_hooks(False)
    faultinject.reset_faults()
    devhealth.set_device_pool(devhealth.DevicePool())
    card = torch.device("cuda", 0)
    empty = hashlib.sha256(b"").hexdigest()
    env0 = os.environ.get("SELKIES_OCCUPANCY")
    bases = _fleet_bases(FLEET_N, W, H)

    # (a) serial, then scheduled; solo encoders; the small trace vs the CPU
    t0 = time.perf_counter()
    runs, totals, carve = {}, {}, None
    for name, env in (("serial", "0"), ("occupancy", "1")):
        os.environ["SELKIES_OCCUPANCY"] = env
        svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
        carve = (svc.shared_carve, svc.bands, [str(e.device) for e in svc.encoders])
        sched, tick = _occupancy_tick(svc)
        if (sched is None) != (name == "serial"):
            _fail(f"phase 14 (a): SELKIES_OCCUPANCY={env} gave scheduler {sched}")
        me_mc.launches = 0
        runs[name] = _drive_fleet(svc, tick, bases)
        totals[name] = me_mc.launches
        if sched is not None:
            out["a_stats"] = sched.stats()
            sched.close()
        svc.close()
    if carve != (True, 2, ["cuda:0"] * FLEET_N):
        _fail(f"phase 14 (a): the service's carve through the pool is {carve}")
    if [r[0] for r in runs["serial"]] != [r[0] for r in runs["occupancy"]]:
        bad = [t for t in range(FLEET_TICKS)
               if runs["serial"][t][0] != runs["occupancy"][t][0]]
        _fail(f"phase 14 (a): the scheduled AUs differ from the serial tick's at ticks {bad}")
    idrs = [r[1] for r in runs["serial"]]
    want_idrs = [[t == 0 or (t == 5 and i == 2) for i in range(FLEET_N)]
                 for t in range(FLEET_TICKS)]
    if idrs != want_idrs or [r[1] for r in runs["occupancy"]] != want_idrs:
        _fail(f"phase 14 (a): IDR flags {idrs}")
    for name, run in runs.items():
        got = [r[2] for r in run]
        want = _fleet_launches_ok(run, 2, range(FLEET_N))
        if got != want:
            _fail(f"phase 14 (a) {name}: me_mc launches per tick {got}, want {want}")
    t_solo = time.perf_counter()
    for i in range(FLEET_N):
        solo = _fleet_solo(bases, i, range(FLEET_TICKS), W, H)
        if solo != [runs["serial"][t][0][i] for t in range(FLEET_TICKS)]:
            _fail(f"phase 14 (a): session {i} differs from its solo bands=2 card encoder")
    solo_s = time.perf_counter() - t_solo
    sw, sh = FLEET_SMALL
    small_bases = _fleet_bases(FLEET_N, sw, sh)
    small = {}
    for dev_name in ("cuda", "cpu"):
        os.environ["SELKIES_OCCUPANCY"] = "1" if dev_name == "cuda" else "0"
        ssvc = TorchBandedFleetService(FLEET_N, sw, sh, qp=28, bands=2, devices=(
            None if dev_name == "cuda" else [torch.device("cpu")]))
        sched, tick = _occupancy_tick(ssvc)
        me_mc.launches = 0
        tc = time.perf_counter()
        run = _drive_fleet(ssvc, tick, small_bases)
        small[dev_name] = (run, me_mc.launches, time.perf_counter() - tc, ssvc.bands)
        if sched is not None:
            sched.close()
        ssvc.close()
    if [r[:2] for r in small["cuda"][0]] != [r[:2] for r in small["cpu"][0]]:
        _fail(f"phase 14 (a): {FLEET_N} x {sw}x{sh} scheduled on the card differs from the "
              "cpu run")
    want_small = _fleet_launches_ok(small["cuda"][0], 2, range(FLEET_N))
    if [r[2] for r in small["cuda"][0]] != want_small or small["cuda"][3] != 2:
        _fail(f"phase 14 (a) {sw}x{sh}: launches {[r[2] for r in small['cuda'][0]]}, want "
              f"{want_small}, bands {small['cuda'][3]}")
    out["a"] = {
        "sha256": [r[0] for r in runs["serial"]], "idrs": idrs,
        "launches_per_tick": {k: [r[2] for r in v] for k, v in runs.items()},
        "tick_ms": {k: [r[3] for r in v] for k, v in runs.items()},
        "me_mc_launches": totals, "solo_s": solo_s,
        "small": {"geometry": f"{sw}x{sh}", "sha256": [r[0] for r in small["cuda"][0]],
                  "me_mc_launches": small["cuda"][1], "cuda_s": small["cuda"][2],
                  "cpu_s": small["cpu"][2]},
        "seconds": time.perf_counter() - t0}
    print(f"phase 14 (a) TorchBandedFleetService({FLEET_N}, {W}, {H}, bands=2): the shared "
          f"carve on cuda:0 through the pool; {FLEET_TICKS} ticks (IDRs {idrs[0].count(True)} "
          f"+ 1 forced, 1 static, set_qp) serial and through OccupancyScheduler: AUs "
          f"sha256-equal, equal to 4 solo bands=2 card encoders; me_mc launches per tick "
          f"{out['a']['launches_per_tick']['occupancy']} (2 per non-static banded P); "
          f"{FLEET_N} x {sw}x{sh} scheduled on the card = the cpu run (launches "
          f"{small['cuda'][1]}); overlap {out['a_stats']['overlap_ratio']}; "
          f"{out['a']['seconds']:.1f} s")

    # (b) checkpoint + re-carve session 0 after tick 3; park session 1 at
    # ticks 4-5, un-park it at tick 6
    t0 = time.perf_counter()
    os.environ["SELKIES_OCCUPANCY"] = "1"
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
    sched, tick = _occupancy_tick(svc)
    rec: dict = {}

    def hook(t):
        if t == 4:
            tr = time.perf_counter()
            svc.recarve(0, [card])
            rec["recarve_ms"] = (time.perf_counter() - tr) * 1e3
            svc.recarve(1, [])
        elif t == 6:
            svc.recarve(1, [card])

    me_mc.launches = 0
    brun = _drive_fleet(svc, tick, bases, hook=hook)
    rec["me_mc_launches"] = me_mc.launches
    sched.close()
    svc.close()
    s0 = [r[0][0] for r in brun]
    if s0 != _fleet_solo(bases, 0, range(FLEET_TICKS), W, H, key_at={4}):
        _fail("phase 14 (b): the re-carved session differs from an oracle forced a keyframe")
    s1 = [(r[0][1], r[1][1]) for r in brun]
    if s1[4:6] != [(empty, False)] * 2 or not s1[6][1]:
        _fail(f"phase 14 (b): the parked session gave {s1[4:7]}")
    if [x for x, _ in s1[6:]] != _fleet_solo(bases, 1, range(6, FLEET_TICKS), W, H):
        _fail("phase 14 (b): the un-parked session differs from a fresh encoder")
    if any(r[0][i] != a[0][i] for r, a in zip(brun, runs["serial"]) for i in (2, 3)):
        _fail("phase 14 (b): sessions 2 and 3 differ from (a)")
    want = _fleet_launches_ok(brun, 2, range(FLEET_N))
    if [r[2] for r in brun] != want:
        _fail(f"phase 14 (b): launches {[r[2] for r in brun]}, want {want}")
    rec.update(idrs=[r[1] for r in brun], launches_per_tick=[r[2] for r in brun],
               seconds=time.perf_counter() - t0)
    out["b"] = rec
    print(f"phase 14 (b) checkpoint + re-carve of session 0 after tick 3: its AUs equal an "
          f"oracle forced a keyframe at tick 4 (re-carve {rec['recarve_ms']:.1f} ms); session "
          f"1 parked at ticks 4-5 gave b'' and no IDR, un-parked at tick 6 as a fresh IDR equal "
          f"to a new encoder's; launches {rec['launches_per_tick']}; {rec['seconds']:.1f} s")

    # (c) mixed tenancy: 4 batch sessions and 2 banded ones of 1920x1088
    t0 = time.perf_counter()
    mbases = _fleet_bases(6, SW, SH)
    mixed_runs = {}
    for env in ("0", "1"):
        os.environ["SELKIES_OCCUPANCY"] = env
        mixed = MixedTenancyService(
            TorchMultiSessionH264Service(4, SW, SH, qp=28, device="cuda"),
            TorchBandedFleetService(2, SW, SH, qp=28, bands=2))
        me_mc.launches = 0
        run = _drive_fleet(mixed, mixed.encode_tick, mbases, range(MIXED_TICKS), MIXED_OPS)
        mixed_runs[env] = (run, me_mc.launches, mixed.scheduler() is not None,
                           mixed.scheduler().stats() if mixed.scheduler() else None)
        mixed.close()
    off, on = mixed_runs["0"], mixed_runs["1"]
    if off[2] or not on[2]:
        _fail("phase 14 (c): SELKIES_OCCUPANCY did not pick the serial / scheduled tick")
    if [r[:2] for r in off[0]] != [r[:2] for r in on[0]]:
        _fail("phase 14 (c): mixed tenancy AUs differ between occupancy off and on")
    for env, (run, *_rest) in mixed_runs.items():
        want = _fleet_launches_ok(run, 2, range(4, 6), range(4))
        if [r[2] for r in run] != want:
            _fail(f"phase 14 (c) occupancy {env}: launches {[r[2] for r in run]}, want {want}")
    out["c"] = {"sha256": [r[0] for r in on[0]], "idrs": [r[1] for r in on[0]],
                "launches_per_tick": {"off": [r[2] for r in off[0]],
                                      "on": [r[2] for r in on[0]]},
                "tick_ms": {"off": [r[3] for r in off[0]], "on": [r[3] for r in on[0]]},
                "me_mc_launches": {"off": off[1], "on": on[1]}, "stats": on[3],
                "seconds": time.perf_counter() - t0}
    print(f"phase 14 (c) MixedTenancyService(4 x {SW}x{SH} batch, 2 x bands=2): AUs "
          f"sha256-equal with occupancy off and on over {MIXED_TICKS} ticks; me_mc launches "
          f"per tick {out['c']['launches_per_tick']['on']} (1 for the batch unit + 2 per banded "
          f"P); {out['c']['seconds']:.1f} s")

    # (d) sched:1@3:drop and sched:2@4:raise on (a)'s service
    t0 = time.perf_counter()
    spec = "sched:1@3:drop;sched:2@4:raise"
    fi = faultinject.configure_faults(spec)
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
    sched = OccupancyScheduler.for_service(svc)
    errors = {}

    def sched_tick(batch):
        try:
            return sched.encode_tick(batch)
        except faultinject.InjectedFault:
            errors[sched.ticks] = sorted(sched.stats()["errors"])
            raise

    drun = _drive_fleet(svc, sched_tick, bases)
    faultinject.reset_faults()
    sched.close()
    svc.close()
    injected = [tuple(x) for x in fi.injected]
    if injected != [("sched:1", 3, "drop"), ("sched:2", 4, "raise")]:
        _fail(f"phase 14 (d): injected {injected}")
    if drun[3][0] != "InjectedFault" or errors != {4: ["2"]}:
        _fail(f"phase 14 (d): tick 3 gave {drun[3][0]}, errors {errors}")
    if drun[2][0][1] != empty:
        _fail("phase 14 (d): the dropped tick delivered an AU")
    a_rows = [r[0] for r in runs["serial"]]
    for t in range(FLEET_TICKS):
        if t == 3:
            continue
        others = [0, 3] + ([1] if t < 2 else []) + ([2] if t < 3 else [])
        if any(drun[t][0][i] != a_rows[t][i] for i in others):
            _fail(f"phase 14 (d): tick {t}: a session without a fault differs from (a)")
    keep1 = [t for t in range(FLEET_TICKS) if t != 2]
    if [drun[t][0][1] for t in keep1 if t != 3] != [
            x for t, x in zip(keep1, _fleet_solo(bases, 1, keep1, W, H)) if t != 3]:
        _fail("phase 14 (d): the dropped session differs from an oracle that never saw tick 2")
    keep2 = [t for t in range(FLEET_TICKS) if t != 3]
    if [drun[t][0][2] for t in keep2] != _fleet_solo(bases, 2, keep2, W, H):
        _fail("phase 14 (d): the raised session differs from an oracle that never saw tick 3")
    out["d"] = {"spec": spec, "injected": injected, "errors": errors,
                "seconds": time.perf_counter() - t0}
    print(f"phase 14 (d) {spec}: session 1's tick 2 AU empty and its later frames equal an "
          f"oracle without that frame; tick 3 raised InjectedFault after the other sessions "
          f"ran (errors {errors}), session 2 then equals an oracle without frame 3; every "
          f"other session as (a); {out['d']['seconds']:.1f} s")

    # (e) the placer over the pool's one card, admission, and a drain with
    # the service's force-keyframe, flush and hand-off
    t0 = time.perf_counter()
    _set_hooks(True)
    placer = SessionPlacer(bands=2)
    rows = placer.place_initial(FLEET_N, 2)
    if not placer.shared or rows != [[card]] * FLEET_N or placer.devices != [card]:
        _fail(f"phase 14 (e): placer carve {rows}, shared {placer.shared}")
    adm = placer.admit(FLEET_N)
    if (adm.decision, adm.reason) != ("accept", "shared"):
        _fail(f"phase 14 (e): admission {adm}")
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2, rows=rows, shared=True)
    sched = OccupancyScheduler.for_service(svc)
    for t in range(2):
        sched.encode_tick(_fleet_batch(bases, t))

    async def flush():
        await asyncio.get_running_loop().run_in_executor(
            None, sched.encode_tick, _fleet_batch(bases, 2))

    drainer = DrainController(
        "fleet", placer=placer, deadline_s=120.0,
        force_idr=lambda: [svc.force_keyframe(k) for k in range(FLEET_N)], flush=flush,
        handoff=lambda: [checkpoint_session(svc, k) for k in range(FLEET_N)])
    ok = asyncio.run(drainer.drain())
    cks = [(c.session, c.idr_pic_id, c.frames_since_idr, c.qp) for c in drainer.checkpoints]
    health = telemetry.health()["status"]
    late = placer.admit(FLEET_N + 1)
    drain_gauge = telemetry._gauges.get(("selkies_drain_state", ()))
    sched.close()
    svc.close()
    telemetry._lifecycle = None
    _set_hooks(False)
    if not ok or not drainer.completed_in_deadline or svc.last_idrs != [True] * FLEET_N:
        _fail(f"phase 14 (e): drain ok {ok}, in deadline {drainer.completed_in_deadline}, "
              f"IDRs {svc.last_idrs}")
    if cks != [(k, 0, 1, 28) for k in range(FLEET_N)]:
        _fail(f"phase 14 (e): checkpoints {cks}")
    if health != "draining" or (late.decision, late.reason) != ("reject", "draining") \
            or drain_gauge != 2:
        _fail(f"phase 14 (e): health {health}, late admission {late}, gauge {drain_gauge}")
    out["e"] = {"carve": placer.stats()["carve"], "checkpoints": cks,
                "drain_s": time.perf_counter() - t0}
    print(f"phase 14 (e) SessionPlacer(devices=None): shared carve of {FLEET_N} sessions on "
          f"the pool's one card, admission accepted (shared); drain: forced IDRs flushed, "
          f"{len(cks)} checkpoints, completed in deadline, then health 'draining' and "
          f"admission rejected; {out['e']['drain_s']:.1f} s")
    if env0 is None:
        os.environ.pop("SELKIES_OCCUPANCY", None)
    else:
        os.environ["SELKIES_OCCUPANCY"] = env0
    return out


def _timed(obj, name: str, sink: list) -> None:
    """Wrap obj.name so each call appends its host-clock ms to sink."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, wrapper)


def _time_fleet(card: str, power_limit: str, pairs: int = 3, p_ticks: int = 6) -> dict:
    """Phase 14's (a) and (c) configurations on full motion (_scrolled):
    occupancy off and on in alternating pairs on one service (off, on, on,
    off, ...; the banded service also runs its sessions one after another,
    "in_turn", after each pair), p_ticks P ticks each; per run the median
    tick ms, fps across sessions, the dispatch and complete ms per unit
    (host clock), and with it on the scheduler's overlap and sched_wait
    (the median of each tick's, and the scheduler's EWMA, which still
    carries the IDR tick); then the device ops and idle share per tick
    over 3 ticks each way (torch.profiler), and for the banded service the
    ms from a checkpoint to the first AU after a re-carve."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.parallel.occupancy import MixedTenancyService, OccupancyScheduler
    from selkies_tpu_torch.parallel.serving import (
        TorchBandedFleetService,
        TorchMultiSessionH264Service,
    )

    env0 = os.environ.get("SELKIES_OCCUPANCY")
    out: dict = {"card": card, "power_limit": power_limit}
    for name in ("banded_4x1080_bands2", "mixed_4batch_2banded_1088"):
        if name.startswith("banded"):
            bases = _fleet_bases(FLEET_N, W, H)
            svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
            sched = OccupancyScheduler.for_service(svc)
            banded, batch = svc, None

            def tick(frames, mode):
                if mode == "in_turn":  # the serial tick's work, one session after another
                    return [e.encode_frame(f) for e, f in zip(svc.encoders, frames)]
                return (sched if mode == "on" else svc).encode_tick(frames)

            def scheduler():
                return sched
        else:
            bases = _fleet_bases(6, SW, SH)
            batch = TorchMultiSessionH264Service(4, SW, SH, qp=28, device="cuda")
            banded = TorchBandedFleetService(2, SW, SH, qp=28, bands=2)
            svc = MixedTenancyService(batch, banded)

            def tick(frames, mode):
                os.environ["SELKIES_OCCUPANCY"] = "1" if mode == "on" else "0"
                return svc.encode_tick(frames)

            def scheduler():
                return svc.scheduler()
        n = len(bases)
        times: dict = {}
        for k, enc in enumerate(banded.encoders):
            for m in ("dispatch_frame", "complete_frame"):
                _timed(enc, m, times.setdefault(f"banded{k}.{m.split('_')[0]}", []))
        if batch is not None:
            for m in ("dispatch_tick", "complete_tick"):
                _timed(batch, m, times.setdefault(f"batch.{m.split('_')[0]}", []))
        # warm-up: the IDR tick scheduled (phase 14 (a) times the serial
        # one), two serial P ticks, one scheduled
        t0 = time.perf_counter()
        tick(np.stack(_scrolled(bases, 0)), "on")
        rec = {"sessions": n, "idr_tick_ms_occupancy": (time.perf_counter() - t0) * 1e3}
        for t in (1, 2):
            tick(np.stack(_scrolled(bases, t)), "off")
        tick(np.stack(_scrolled(bases, 3)), "on")
        # each tick's sched_wait per session, as the scheduler notes it
        waits: list = []
        note = scheduler()._note_tick

        def noting(wall_s, stage_s, w, errors):
            waits.append(dict(w))
            return note(wall_s, stage_s, w, errors)

        scheduler()._note_tick = noting
        t = 4
        # alternating off / on pairs; the banded service also runs its
        # sessions one after another ("in_turn") after each pair
        turn = ["in_turn"] if name.startswith("banded") else []
        modes = [m for i in range(pairs) for m in (["off", "on"] if i % 2 == 0
                                                   else ["on", "off"]) + turn]
        runs = {m: [] for m in ("off", "on", *turn)}
        for mode in modes:
            frames = [np.stack(_scrolled(bases, t + j)) for j in range(p_ticks)]
            t += p_ticks
            for v in times.values():
                v.clear()
            waits.clear()
            ms, overlaps = [], []
            tw = time.perf_counter()
            for f in frames:
                tt = time.perf_counter()
                tick(f, mode)
                ms.append((time.perf_counter() - tt) * 1e3)
                if mode == "on":
                    overlaps.append(scheduler().last_overlap)
            wall = time.perf_counter() - tw
            r = {"tick_ms_median": statistics.median(ms), "fps": n * p_ticks / wall,
                 "unit_ms_median": {k: statistics.median(v) for k, v in times.items() if v}}
            if mode == "on":
                st = scheduler().stats()
                r.update(last_overlap_median=statistics.median(overlaps),
                         overlap_ewma=st["overlap_ratio"],
                         sched_wait_ms_median={s: statistics.median(w[s] for w in waits)
                                               for s in sorted(waits[0])},
                         sched_wait_ms_ewma=st["sched_wait_ms"])
            runs[mode].append(r)
        rec["runs"] = runs
        for mode in ("off", "on"):
            frames = [np.stack(_scrolled(bases, t + j)) for j in range(3)]
            t += 3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tw = time.perf_counter()
                for f in frames:
                    tick(f, mode)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - tw) * 1e3
            act = _device_activity(prof, wall_ms)
            act["ticks"] = 3
            if isinstance(act.get("device_ops"), int):
                act["device_ops_per_tick"] = act["device_ops"] / 3
            act.pop("top", None)
            rec[f"profile_{mode}"] = act
        if name.startswith("banded"):
            dev = torch.device("cuda", 0)
            rc = []
            for _ in range(3):
                frames = np.stack(_scrolled(bases, t))
                t += 1
                tr = time.perf_counter()
                svc.recarve(0, [dev])
                tb = time.perf_counter()
                sched.encode_tick(frames)
                rc.append({"recarve_ms": (tb - tr) * 1e3,
                           "checkpoint_to_first_au_ms": (time.perf_counter() - tr) * 1e3})
            rec["recarve"] = rc
            sched.close()
        svc.close()
        out[name] = rec
    if env0 is None:
        os.environ.pop("SELKIES_OCCUPANCY", None)
    else:
        os.environ["SELKIES_OCCUPANCY"] = env0
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
    # -- 12. the hybrid VP9/AV1 rows and the registry
    t0 = time.perf_counter()
    record["hybrid_path"] = _hybrid_phase()
    record["hybrid_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 12: {record['hybrid_path']['seconds']:.1f} s")
    # -- 13. the health and observability plane
    t0 = time.perf_counter()
    record["observability_path"] = _observability_phase(
        record["band_path"]["1080p"]["bands4"]["sha256"])
    record["observability_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 13: {record['observability_path']['seconds']:.1f} s")
    # -- 14. the fleet's banded service, lifecycle and occupancy scheduler
    t0 = time.perf_counter()
    record["fleet_path"] = _fleet_phase()
    record["fleet_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 14: {record['fleet_path']['seconds']:.1f} s")
    print(f"phases 1-9 and 12-14: {time.perf_counter() - t_start:.1f} s")
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
    # the registry row with the tracer and telemetry off and on, in turns
    hooks_t = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        hooks_t[name].append(_time_typing({}, typing, warm=8, hooks=name == "on"))
    from selkies_tpu_torch.resilience.devhealth import _default_probe

    probe_ms = []
    for _ in range(51):
        tp = time.perf_counter()
        _default_probe(dev)
        probe_ms.append((time.perf_counter() - tp) * 1e3)
    hooks_t["site_us"] = _hook_site_us()
    hooks_t["probe_ms_median"] = statistics.median(probe_ms[1:])
    hooks_t["probe_ms_p95"] = sorted(probe_ms[1:])[-(-95 * 50 // 100) - 1]
    record["hooks_timing"] = hooks_t
    print(f"hooks off / on, registry row 1080p typing run, in turns off-on-on-off ({card}, "
          f"{power_limit}): " + json.dumps({
              k: [{m: r[m] for m in ("fps", "latency_ms_median", "latency_ms_p95")
                   if m in r} for r in v] for k, v in hooks_t.items() if isinstance(v, list)})
          + f"; span medians (ms) {json.dumps(hooks_t['on'][0]['span_median_ms'])}; probe "
          f"{hooks_t['probe_ms_median']:.4f} ms median, {hooks_t['probe_ms_p95']:.4f} p95 "
          f"(of 50); one hook site's host cost in us {json.dumps(hooks_t['site_us'])}")

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

    # the hybrid rows' front-end and rows, per frame kind
    hyb_t = _time_hybrid(card, power_limit)
    record["hybrid_timing"] = hyb_t
    print(f"hybrid VP9/AV1 front-end and rows at 1920x1080 ({card}, {power_limit}): "
          + json.dumps(hyb_t))

    # the fleet: phase 14's (a) and (c) configurations, occupancy off and on
    fleet_t = _time_fleet(card, power_limit)
    record["fleet_timing"] = fleet_t
    print(f"fleet service and occupancy scheduler, full motion ({card}, {power_limit}): "
          + json.dumps(fleet_t))

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
        "launches_tpuh264enc_registry_path": record["hybrid_path"]["tpuh264enc"]["me_mc_launches"],
        "launches_observability_path_hooks_on": record["observability_path"]["a"][
            "me_mc_launches"],
        "launches_fleet_path": {
            "banded_serial": record["fleet_path"]["a"]["me_mc_launches"]["serial"],
            "banded_occupancy": record["fleet_path"]["a"]["me_mc_launches"]["occupancy"],
            "mixed_off": record["fleet_path"]["c"]["me_mc_launches"]["off"],
            "mixed_on": record["fleet_path"]["c"]["me_mc_launches"]["on"]},
        "launches_per_tick_fleet_path": {
            "banded_4x1080_bands2": record["fleet_path"]["a"]["launches_per_tick"]["occupancy"],
            "mixed_4batch_2banded": record["fleet_path"]["c"]["launches_per_tick"]["on"]},
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
