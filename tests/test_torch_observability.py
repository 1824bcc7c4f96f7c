"""The port's observability plane against JAX's, and its hooks in the
encoders.

``selkies_tpu_torch/monitoring/`` (the tracer, the telemetry bus, the
flight recorder, the recompile sentinel) against ``selkies_tpu/
monitoring/`` on the same emissions; then the hooks the port's encoders
carry at JAX's sites, held against the JAX encoders on the same frames:

* ``TorchH264Encoder`` (the registry row: groups of 4, depth 2, LTR): the
  tracer's span counts per name, the tile-cache counters and the AUs with
  the tracer and telemetry on, the AUs with them off; the ``frontend``
  fault site under the same spec; the ``jitprof`` marks of each kind of
  ``retune_entropy``;
* ``TorchBandedH264Encoder`` and ``TorchMultiSessionH264Service``: span
  counts, ``selkies_stage_ms`` observations and AUs.

Span counts are compared with JAX's on every name JAX emits; the port's
own names (``monitoring/tracing.py``: ``convert``, ``h2d``,
``device-step``, ``allskip``, ``complete_wait`` on the solo row, ``h2d``,
``step-i`` and ``step-p`` on the service) are held to exact counts on the
same run.

Spans come from several threads in both packages (completion workers,
pack pools), so counts are compared per name, never their order. Both
packages' tracer, bus and injector are process-wide singletons of their
own: a fixture turns them off and resets them after every test.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_encoder_host import _pin_env  # noqa: F401
from test_torch_pipeline import BOOST, REGISTRY, registry_trace
from test_torch_sparse import MBH, MBW
from test_torch_sparse import _out as sparse_out

import jax

from selkies_tpu.models.h264 import bitstream as jbs
from selkies_tpu.models.h264 import sparse_complete as JS
from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu.monitoring import flightrecorder as jfr
from selkies_tpu.monitoring import jitprof as jjp
from selkies_tpu.monitoring.telemetry import telemetry as jtel
from selkies_tpu.monitoring.tracing import tracer as jtracer
from selkies_tpu.parallel.bands import BandedH264Encoder
from selkies_tpu.parallel.serving import MultiSessionH264Service
from selkies_tpu.resilience import faultinject as jfi
from selkies_tpu_torch.models.h264 import bitstream as tbs
from selkies_tpu_torch.models.h264 import device_cavlc as tdc
from selkies_tpu_torch.models.h264 import encoder as tenc
from selkies_tpu_torch.models.h264 import encoder_core as TC
from selkies_tpu_torch.models.h264 import sparse_complete as TS
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.monitoring import flightrecorder as tfr
from selkies_tpu_torch.monitoring import jitprof as tjp
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttel
from selkies_tpu_torch.monitoring.tracing import tracer as ttracer
from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
from selkies_tpu_torch.resilience import faultinject as tfi
from selkies_tpu_torch.utils import build as tbuild

JAX = SimpleNamespace(tracer=jtracer, tel=jtel, jp=jjp, fi=jfi, fr=jfr)
PORT = SimpleNamespace(tracer=ttracer, tel=ttel, jp=tjp, fi=tfi, fr=tfr)
PACKAGES = [JAX, PORT]


def _off(p):
    p.tracer.disable()
    p.tracer.reset()
    p.tel.disable()
    p.tel.reset()
    p.fi.reset_faults()


@pytest.fixture(autouse=True)
def _reset_planes(monkeypatch):
    monkeypatch.delenv("SELKIES_FAULTS", raising=False)
    for p in PACKAGES:
        _off(p)
    yield
    for p in PACKAGES:
        _off(p)
    tjp.uninstall()


def _on(p):
    p.tracer.enable()
    p.tel.enable()


def _spans(p) -> dict:
    return {name: a["count"] for name, a in p.tracer.summary().items()}


def _split_names(port: dict, jax_spans: dict) -> dict:
    """Assert the port's counts equal JAX's on every name JAX emits; -> the
    port's counts of the names JAX does not emit."""
    assert {k: port.get(k) for k in jax_spans} == jax_spans
    return {k: v for k, v in port.items() if k not in jax_spans}


def _calls(monkeypatch, module, name: str) -> list:
    """Count the calls of ``module.name`` (a one-element list)."""
    fn, n = getattr(module, name), [0]

    def counted(*a, **k):
        n[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return n


def _stage_counts(p) -> dict:
    hists = p.tel.rollup()["histograms"].get("selkies_stage_ms", {})
    return {k: v["count"] for k, v in hists.items()}


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


# -- the modules, on the same emissions ----------------------------------------

def _emit(p):
    t, tm = p.tracer, p.tel
    for name in ("classify", "step", "step", "pack", "fetch"):
        with t.span(name):
            pass
    t.instant("frame-drop")
    tm.count("selkies_tile_cache_tiles_total", 3, result="hit")
    tm.count("selkies_tile_cache_frames_total", kind="delta")
    tm.count("selkies_faults_injected_total", site="frontend", action="raise")
    tm.gauge("selkies_device_health", 1, chip="0")
    tm.observe("selkies_compile_ms", 120.0, trigger="startup")
    for ms in (0.02, 0.3, 7.0, 700.0):
        tm.stage_ms("classify", ms)
        tm.stage_ms("step", ms, session="1")
    tm.frame_done(7, 5000, idr=False, device_ms=3.0, pack_ms=1.0, unpack_ms=0.25,
                  cavlc_ms=0.75, downlink_mode="coeff", classify_ms=0.1, qp=28,
                  rc_fullness=0.5, entropy_coder="cavlc")
    tm.event("device", chip="0", action="quarantine")


def _emit_port_only(t):
    """The port's own names, through ``Tracer.record`` (JAX's tracer has no
    ``record``): one each, ``device-step`` twice."""
    t0 = time.perf_counter()
    for name in ("convert", "h2d", "device-step", "device-step", "complete_wait"):
        t.record(name, t0)


@pytest.mark.parametrize("enabled", [False, True], ids=["off", "on"])
def test_tracer_and_bus_match_jax(enabled):
    for p in PACKAGES:
        if enabled:
            _on(p)
        _emit(p)
    _emit_port_only(ttracer)
    own = _split_names(_spans(PORT), _spans(JAX))
    assert own == ({"convert": 1, "h2d": 1, "device-step": 2, "complete_wait": 1}
                   if enabled else {})
    got, want = ttel.rollup(), jtel.rollup()
    for k in ("enabled", "histograms", "counters", "gauges"):
        assert got[k] == want[k], k
    assert set(got["trace"]) == set(want["trace"]) | set(own)
    assert bool(got["counters"]) == enabled
    if enabled:
        events = json.loads(ttracer.chrome_trace())["traceEvents"]
        assert sorted(e["name"] for e in events if e["name"] not in own) == sorted(
            e["name"] for e in json.loads(jtracer.chrome_trace())["traceEvents"])
        assert sum(e["name"] in own for e in events) == sum(own.values())
        assert ttel.recorder.events("0")[-1]["ev"] == "device"


def test_off_means_no_state():
    """Off, every mutator returns on one attribute read and keeps nothing;
    a span is the shared no-op object."""
    assert ttracer.span("step") is ttracer.span("pack")
    assert ttel.span("submit", 3) is ttel.span("send", 4)
    _emit(PORT)
    assert ttracer.summary() == {} and ttel.recorder is None
    roll = ttel.rollup()
    assert roll["counters"] == roll["gauges"] == roll["histograms"] == {}


def test_health_matches_jax_less_the_capacity_block():
    from selkies_tpu.resilience import devhealth as jdh
    from selkies_tpu_torch.resilience import devhealth as tdh

    tp = tdh.DevicePool(devices=["c0", "c1"], fail_threshold=1)
    jp = jdh.DevicePool(devices=["c0", "c1"], fail_threshold=1)
    tp.quarantine("c1")
    jp.quarantine("c1")
    got, want = ttel.health(), jtel.health()
    # the capacity block apart: it carries the clock's ts
    cap, jcap = got.pop("capacity"), want.pop("capacity")
    assert got == want and got["devices"]["quarantined"] == ["c1"]
    cap.pop("ts")
    jcap.pop("ts")
    assert cap == jcap and (cap["chips"], cap["quarantined_chips"]) == (2, 1)
    assert ttel.rollup()["providers"]["devices"] == tp.stats()
    json.loads(ttel.statz_json())


def test_flight_recorder_bundle_matches_jax(tmp_path):
    names = {}
    for p in PACKAGES:
        _on(p)
        out = tmp_path / ("port" if p is PORT else "jax")
        p.tel.recorder = p.fr.FlightRecorder(out_dir=str(out))
        _emit(p)
        path = p.tel.escalation("0", "restart")
        assert path is not None and p.tel.escalation("0", "again") is None
        names[p is PORT] = sorted(os.listdir(path))
        events = [json.loads(x) for x in open(os.path.join(path, "events.jsonl"))]
        names[p is PORT, "ev"] = sorted((e["session"], e["ev"]) for e in events)
        json.loads(open(os.path.join(path, "trace.json")).read())
    assert names[True] == names[False] == ["events.jsonl", "meta.json", "metrics.json",
                                            "trace.json"]
    assert names[True, "ev"] == names[False, "ev"]


@pytest.mark.parametrize("window", [(8, 30.0), (3, 1.0)], ids=["storm", "no_storm"])
def test_compile_sentinel_matches_jax(window):
    storm_n, window_s = window
    runs = []
    for p in PACKAGES:
        t = [0.0]
        s = p.jp.CompileSentinel(storm_n=storm_n, storm_window_s=window_s, mark_ttl_s=5.0,
                                 startup_grace_s=10.0, clock=lambda: t[0])
        log = []
        for i in range(12):
            t[0] = 2.0 * i
            if i == 6:
                s.mark("actuation", "entropy-retune")
            if i == 9:
                with s.scope("startup", "prewarm"):
                    s.on_duration(p.jp.COMPILE_EVENT, 0.25)
            s.on_duration(p.jp.COMPILE_EVENT, 0.5 + i)
            s.on_duration("/some/other/event", 9.0)
            s.on_event(p.jp.CACHE_HIT_EVENT)
            log.append(s.stats())
        runs.append(log)
    assert runs[0] == runs[1]
    assert runs[1][-1]["by_trigger"] == {"startup": 7, "actuation": 3, "unattributed": 3}


def test_builds_report_to_the_sentinel(tmp_path, monkeypatch):
    """utils/build.py reports a build's duration (COMPILE_EVENT) and a
    reuse of a built library (CACHE_HIT_EVENT) to the active sentinel."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "out")
    src = tmp_path / "one.c"
    src.write_text("int one(void) { return 1; }\n")
    cmd = ["g++", "-x", "c", "-shared", "-fPIC", "-O0"]
    tbuild.build_shared("one", [src], cmd)  # no sentinel active: nothing observed
    s = tjp.install(tjp.CompileSentinel(startup_grace_s=0.0))
    res = tbuild.build_shared("one", [src], cmd)
    assert res.seconds == 0.0 and s.stats()["compiles"] == 0 and s.stats()["cache_hits"] == 1
    tjp.mark("actuation", "entropy-retune")
    src.write_text("int one(void) { return 2 - 1; }\n")
    res = tbuild.build_shared("one", [src], cmd)
    st = s.stats()
    assert res.seconds > 0 and st["compiles"] == 1
    assert st["by_site"] == {"actuation:entropy-retune": 1}
    tjp.uninstall()
    src.write_text("int one(void) { return 3 - 2; }\n")
    tbuild.build_shared("one", [src], cmd)
    assert s.stats()["compiles"] == 1


# -- one slice's sparse completion, every arm -------------------------------------

SLICE_ARMS = ["cavlc", "cabac", "dense", "device_bits", "device_tokens", "cavlc_short_hint",
              "device_bits_short_hint", "device_tokens_short_hint"]


@pytest.mark.parametrize("arm", SLICE_ARMS)
def test_sparse_completion_spans_match_jax(arm):
    """``complete_sparse_slice`` opens JAX's spans on every arm: ``unpack``
    and ``pack`` on the coefficient arms, ``pack`` alone on a device-coded
    payload, and ``bits_fetch`` for the refetch a short hint forces there."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in sparse_out(1, 0.8, 0.3, 2).items()}
    m = MBH * MBW
    coder = "cabac" if "cabac" in arm or "tokens" in arm else "cavlc"
    device = arm.startswith("device")
    nscap, cap = (4 if arm == "dense" else m), 26 * m
    if device:
        fused, dense, buf = TC.pack_p_sparse_entropy(
            out, nscap, cap, None, *tdc.resolve_entropy(m, True, 1, coder)[3][:3],
            entropy_coder=coder)
    else:
        fused, dense, buf = TC.pack_p_sparse_var(out, nscap, cap)
    fused, dense, buf = fused.numpy(), dense.numpy(), buf.numpy()
    pre = fused[:24] if arm.endswith("short_hint") else fused
    res = []
    for mod, bs, p in ((JS, jbs, JAX), (TS, tbs, PORT)):
        _on(p)
        params = bs.StreamParams(width=16 * MBW, height=16 * MBH, qp=26, entropy_coder=coder)
        nal, skipped, _, mode = mod.complete_sparse_slice(
            pre, mbh=MBH, mbw=MBW, nscap=nscap, cap_rows=cap, qp=26, frame_num=3,
            params=params, device_bits=device, full_d=fused, buf_d=buf, dense_d=dense,
            prefix_bytes=pre.nbytes, entropy_coder=coder)
        res.append((nal, skipped, mode, _spans(p)))
    assert res[1] == res[0]
    spans = res[1][3]
    if device:
        assert res[1][2] == ("cabac" if coder == "cabac" else "bits")
        assert spans == {"pack": 1, **({"bits_fetch": 1} if pre is not fused else {})}
    else:
        assert spans == {"unpack": 1, "pack": 1}


# -- the solo encoder: the registry row -----------------------------------------

W, H = 320, 192


def _drive_solo(enc, frames, faults, stats=None):
    """-> (every AU's sha256 in completion order with its meta, the indices
    whose submit raised); each FrameStats goes to ``stats`` if given."""
    done, raised = [], []
    for i, (frame, op) in enumerate(frames):
        if op == "idr":
            enc.force_keyframe()
        try:
            outs = enc.submit(frame, meta=i)
        except faults.InjectedFault:
            raised.append(i)
            continue
        done += [(_sha(au), m) for au, _, m in outs]
        if stats is not None:
            stats += [st for _, st, _ in outs]
    outs = enc.flush()
    done += [(_sha(au), m) for au, _, m in outs]
    if stats is not None:
        stats += [st for _, st, _ in outs]
    enc.close()
    return done, raised


def _tile_counters(p) -> dict:
    return {k: v for k, v in p.tel.rollup()["counters"].items()
            if k.startswith("selkies_tile_cache")}


def _port_solo():
    return TorchH264Encoder(W, H, scene_qp_boost=BOOST, device="cpu")


def test_solo_hooks_match_jax(monkeypatch):
    frames = registry_trace(seed=51)
    _on(JAX)
    want = _drive_solo(TPUH264Encoder(W, H, **REGISTRY), frames, jfi)
    _on(PORT)
    resident = _calls(monkeypatch, tenc, "_i_resident_step")  # an IDR with no upload
    seeds = _calls(monkeypatch, tenc, "_pool_seed_step")      # one more upload each
    enc, stats = _port_solo(), []
    got = _drive_solo(enc, frames, tfi, stats)
    assert got == want
    assert [m for _, m in got[0]] == list(range(len(frames)))
    spans = _spans(PORT)
    own = _split_names(spans, _spans(JAX))
    assert spans["classify"] == len(frames)
    assert {"step", "fetch", "unpack", "pack"} <= set(spans)
    # the port's names: a device-step per dispatch (each group, each frame
    # dispatched alone), a convert and an h2d per dispatched frame that
    # uploads (an h2d per group), an h2d per pool seed, and a
    # complete_wait per frame coded on the device, an allskip per unchanged
    # capture
    coded = sum(st.upload_kind != "static" for st in stats)
    grouped = sum(k * n for k, n in enc.group_sizes.items())
    dispatches = sum(enc.group_sizes.values()) + coded - grouped
    assert grouped and seeds[0] and dispatches < coded
    static = len(stats) - coded
    assert own == {"device-step": dispatches, "convert": coded - resident[0],
                   "h2d": dispatches - resident[0] + seeds[0], "complete_wait": coded,
                   "allskip": static}
    counters = _tile_counters(PORT)
    assert counters == _tile_counters(JAX)
    kinds = counters["selkies_tile_cache_frames_total"]
    assert sum(kinds.values()) == len(frames) and "session=0,kind=static" in kinds
    # hooks off: the same bytes, nothing recorded
    _off(PORT)
    assert _drive_solo(_port_solo(), frames, tfi) == got
    assert _spans(PORT) == {} and _tile_counters(PORT) == {}


def test_frontend_fault_matches_jax():
    """``frontend@4,9:raise``: exactly those two submits raise, before the
    front end changes anything; the frames in flight come out in order and
    the AUs that come out are JAX's under the same spec."""
    frames = registry_trace(seed=52)[:14]
    spec = "frontend@4,9:raise"
    jfi.configure_faults(spec)
    want = _drive_solo(TPUH264Encoder(W, H, **REGISTRY), frames, jfi)
    tfi.configure_faults(spec)
    got = _drive_solo(_port_solo(), frames, tfi)
    assert got == want
    assert got[1] == [3, 8]
    assert [m for _, m in got[0]] == [i for i in range(len(frames)) if i not in (3, 8)]
    assert tfi.get_injector().injected == [("frontend", 4, "raise"), ("frontend", 9, "raise")]


RETUNES = {
    "threshold_only": [dict(bits_min_mbs=32)],
    "device_entropy_on": [dict(device_entropy=True)],
    "on_then_threshold": [dict(device_entropy=True), dict(bits_min_mbs=16)],
    "coder_switch": [dict(entropy_coder="cabac")],
    "switch_and_back": [dict(entropy_coder="cabac"), dict(entropy_coder="cavlc")],
    "noop": [dict(), dict(device_entropy=False)],
}


def _marks(enc, p, steps):
    out = []
    s = p.jp._active or p.jp.sentinel
    for kw in steps:
        s._mark = None
        changed = enc.retune_entropy(**kw)
        out.append((changed, s._mark[:2] if s._mark else None))
    return out


@pytest.mark.parametrize("case", list(RETUNES))
def test_retune_marks_match_jax(case):
    """The sentinel mark on each kind of retune: a coder switch marks
    "entropy-coder-switch", a change of the delta steps' entropy consts
    "entropy-retune", a threshold-only or no-op retune nothing."""
    steps = RETUNES[case]
    want = _marks(TPUH264Encoder(W, H, **REGISTRY), JAX, steps)
    enc = _port_solo()
    got = _marks(enc, PORT, steps)
    enc.close()
    assert got == want
    assert got[0][1] == {"threshold_only": None, "noop": None,
                         "coder_switch": ("actuation", "entropy-coder-switch"),
                         "switch_and_back": ("actuation", "entropy-coder-switch"),
                         }.get(case, ("actuation", "entropy-retune"))


# -- the banded encoder and the session service ------------------------------------

def _banded_trace(seed=61):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (H, W, 4), np.uint8)
    frames = [f]
    for i in range(1, 5):
        f = np.roll(f, 5 * i, 0).copy()
        f[16 * i:16 * i + 16, 40:200] = rng.integers(0, 256, (16, 160, 4), np.uint8)
        frames.append(f)
    return frames + [frames[-1].copy(), frames[1]]


def _drive_banded(enc, frames):
    out = [_sha(enc.encode_frame(f)) for f in frames]
    enc.close()
    return out


def test_banded_hooks_match_jax():
    frames = _banded_trace()
    _on(JAX)
    want = _drive_banded(BandedH264Encoder(W, H, bands=2, devices=jax.devices()[:1]), frames)
    _on(PORT)
    got = _drive_banded(TorchBandedH264Encoder(W, H, bands=2, device="cpu"), frames)
    assert got == want
    spans = _spans(PORT)
    assert spans == _spans(JAX)
    coded = len(frames) - 1  # one static repeat
    assert spans["band_gather"] == coded and spans["step"] == spans["fetch"] == 2 * coded
    stages = _stage_counts(PORT)
    assert stages == _stage_counts(JAX)
    assert stages == {"stage=band_gather,session=0": coded, "stage=step,session=0": 2 * coded}
    _off(PORT)
    assert _drive_banded(TorchBandedH264Encoder(W, H, bands=2, device="cpu"), frames) == got
    assert _spans(PORT) == {}


def test_grid_gathers_by_row():
    frames = _banded_trace(seed=62)[:3]
    _on(PORT)
    _drive_banded(TorchBandedH264Encoder(W, H, bands=2, cols=2, device="cpu"), frames)
    spans = _spans(PORT)
    assert spans["row_gather"] == 3 and "band_gather" not in spans
    assert _stage_counts(PORT)["stage=row_gather,session=0"] == 3


N_SESS, SW, SH = 2, 64, 48


def _drive_service(svc, ticks=5, seed=71):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (N_SESS, SH, SW + 32, 4), np.uint8)
    out = []
    for t in range(ticks):
        if t == 3:
            svc.force_keyframe(1)
        out.append([_sha(a) for a in svc.encode_tick(
            np.ascontiguousarray(base[:, :, 4 * t:4 * t + SW]))])
    svc.close()
    return out


def test_service_hooks_match_jax():
    _on(JAX)
    want = _drive_service(MultiSessionH264Service(N_SESS, SW, SH, qp=26,
                                                  devices=jax.devices()[:N_SESS]))
    _on(PORT)
    svc = TorchMultiSessionH264Service(N_SESS, SW, SH, qp=26, device="cpu")
    got = _drive_service(svc)
    assert got == want
    spans = _spans(PORT)
    own = _split_names(spans, _spans(JAX))
    assert _spans(JAX) == {"convert": 5, "device-step": 5, "fetch": 5, "pack": 5}
    # an upload per tick; the IDR branch on the first tick and the mixed
    # tick 3, the P branch on ticks 1-4
    assert own == {"h2d": 5, "step-i": 2, "step-p": 4}
    assert set(svc.last_timing) >= {"convert_ms", "step_ms", "fetch_ms", "pack_ms"}
    _off(PORT)
    assert _drive_service(TorchMultiSessionH264Service(N_SESS, SW, SH, qp=26,
                                                       device="cpu")) == got
    assert _spans(PORT) == {}


def test_hooks_change_no_byte_at_depth_0():
    """Unpipelined and ungrouped, each submit returns its own frame: with
    the hooks on, every AU and FrameStats kind is that of the hooks off,
    frame for frame (the card's no-sync check with the hooks on is in
    tests/test_torch_gpu.py)."""
    frames = registry_trace(seed=53)[:8]
    runs = []
    for hooks in (False, True):
        if hooks:
            _on(PORT)
        enc = TorchH264Encoder(W, H, scene_qp_boost=BOOST, frame_batch=1, pipeline_depth=0,
                               device="cpu")
        runs.append([(_sha(au), st.upload_kind) for f, _ in frames
                     for au, st, _ in enc.submit(f)])
        enc.close()
    assert runs[0] == runs[1] and len(runs[0]) == len(frames)
    assert _spans(PORT)["classify"] == len(frames)
