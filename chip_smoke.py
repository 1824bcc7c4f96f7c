#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (selkies_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build the ME/MC kernel (nvcc, sm_90a) and the native CAVLC packer (g++)
   from the checkout's sources, both at once; print build seconds and the
   ``-Xptxas -v`` report; read the kernel's SASS (``cuobjdump -sass``) for
   the native 4-way byte SAD instruction that sets its operation floor;
3. hold the ME/MC kernel against its plain PyTorch version on the card at
   1920x1088 on three seeded cases (static, uniform motion, motion near the
   search reach with noise), on a tile-clamped candidate list and at a
   width whose last strip of 8 MBs is ragged (1376x768): every output
   exactly equal;
4. drive TorchH264Encoder(1920, 1080, device="cuda") over a seeded
   desktop-like trace (IDR, scrolls, typing, a static repeat,
   force_keyframe, a QP change) with the launch counters zeroed just
   before; every access unit's sha256 must equal the same trace on the CPU,
   the kernel must have launched once per non-static P frame and the native
   packer at least once;
5. time the kernel with CUDA events over 50 launches queued behind a spin
   kernel (the device's time; also as the host issues them), its plain
   version, the encoder per frame (device step, fetch, pack) for IDR and P,
   and the device's busy and idle share and K1's kernel time over a few IDR
   and P frames with torch.profiler;
6. print the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

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


def _profile_frames(enc, frames, idr: bool, n: int) -> dict:
    """Device busy and idle share over n frames (torch.profiler kernel and
    copy intervals, merged), and the kernels that took the most time.
    "not measured" when the profiler reports no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            if idr:
                enc.force_keyframe()
            enc.submit(frames[0] if idr else frames[1 + i % 2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"frames": n, "wall_ms": wall_ms, "device_busy_ms": "not measured"}
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
    return {"frames": n, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ops": len(dev),
            "me_mc_kernel": {"ms": sum(v[0] for v in k1), "count": sum(v[1] for v in k1)},
            "top": [{"name": k[:80], "ms": v[0], "count": v[1]} for k, v in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from selkies_tpu_torch.models.h264 import me_mc, native
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

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

    # -- 2. build both libraries at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        fut_k, fut_n = pool.submit(me_mc.build), pool.submit(native.build)
        k_build, n_build = fut_k.result(), fut_n.result()
    record["build_s"] = {"me_mc": k_build.seconds, "native": n_build.seconds,
                         "wall": time.perf_counter() - t0}
    print(f"build: me_mc {k_build.seconds:.2f} s, native {n_build.seconds:.2f} s, "
          f"wall {record['build_s']['wall']:.2f} s")
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
    max_err = 0
    for name, case in cases.items():
        args = _me_inputs(case, dev)
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
        print(f"me_mc check {name}: exact at {w}x{h} ({args[0].shape[0]} candidates, "
              f"{nz} MBs with nonzero MV)")

    # -- 4. the main path: the encoder at 1920x1080 on the card vs the CPU
    frames = _desktop_trace()
    enc = TorchH264Encoder(W, H, qp=28, device="cuda")
    me_mc.launches = 0
    native.calls = 0
    t0 = time.perf_counter()
    gpu = _drive(enc, frames)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, packs = me_mc.launches, native.calls
    t0 = time.perf_counter()
    cpu = _drive(TorchH264Encoder(W, H, qp=28, device="cpu"), frames)
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
                           "sha256": [h for h, _ in gpu]}

    # -- 5. timing
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
    print("encoder per frame (median ms): " + json.dumps(enc_t))
    prof = {"idr": _profile_frames(enc, frames, True, 2),
            "p": _profile_frames(enc, frames, False, 5)}
    record["profile"] = prof
    print("profile (torch.profiler, profiler on): " + json.dumps(prof))

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
        "launches_per_p_frame": launches / p_frames, "card": card, "power_limit": power_limit,
    }]
    record["kernels"] = kernels
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
