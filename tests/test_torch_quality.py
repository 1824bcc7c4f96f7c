"""The port's quality plane against JAX's.

``selkies_tpu_torch/monitoring/quality.py`` against
``selkies_tpu/monitoring/quality.py``, exactly: the metric kernels
(``psnr_db``, ``ssim``, ``vmaf_proxy``, ``score_planes``), ``bd_rate``, the
switches, the decode oracles (``GopDecoder``) and the live ``QualityProbe``
(``stats()``, its SLO feed, its telemetry histograms and ring events) over
one AU stream of each codec whose decoder loads. A codec whose
decoder is absent skips, as in tests/test_quality.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from conftest import codec_trace
from selkies_tpu.monitoring import flightrecorder as jfr
from selkies_tpu.monitoring import quality as jq
from selkies_tpu.monitoring import slo as jslo
from selkies_tpu.monitoring.telemetry import telemetry as jtele
from selkies_tpu_torch.monitoring import flightrecorder as tfr
from selkies_tpu_torch.monitoring import quality as tq
from selkies_tpu_torch.monitoring import slo as tslo
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttele

W, H = 256, 160
JAX = dict(q=jq, slo=jslo, tele=jtele, fr=jfr)
PORT = dict(q=tq, slo=tslo, tele=ttele, fr=tfr)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    for k in ("SELKIES_QUALITY", "SELKIES_QUALITY_SAMPLE", "SELKIES_FRAME_BATCH",
              "SELKIES_PIPELINE_DEPTH", "SELKIES_ENTROPY_CODER"):
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tele_on(tmp_path):
    for p, name in ((JAX, "jax"), (PORT, "port")):
        p["tele"].reset()
        p["tele"].enabled = True
        p["tele"].recorder = p["fr"].FlightRecorder(out_dir=str(tmp_path / name))
    yield
    for p in (JAX, PORT):
        p["tele"].enabled = False
        p["tele"].reset()


# -- metric kernels, BD-rate, switches -----------------------------------------

def _noisy(seed: int, sigma: float, shape=(H, W)):
    rng = np.random.default_rng(seed)
    y = rng.integers(30, 220, shape).astype(np.uint8)
    noise = np.random.default_rng(seed + 100).normal(0.0, sigma, shape)
    return y, np.clip(y.astype(np.float64) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sigma", [0.0, 0.5, 3.0, 12.0, 40.0])
@pytest.mark.parametrize("shape", [(H, W), (7, 5), (96, 33)], ids=["256x160", "5x7", "33x96"])
def test_metric_kernels_match_jax(sigma, shape):
    ref, dec = _noisy(int(sigma * 10) + shape[1], sigma, shape)
    assert tq.psnr_db(ref, dec) == jq.psnr_db(ref, dec)
    for window in (8, 3, 11):
        assert tq.ssim(ref, dec, window) == jq.ssim(ref, dec, window)
    ts, js = tq.score_planes(ref, dec), jq.score_planes(ref, dec)
    assert ts.as_dict() == js.as_dict()
    assert (ts.psnr_db, ts.ssim, ts.vmaf, ts.vmaf_kind) == \
        (js.psnr_db, js.ssim, js.vmaf, js.vmaf_kind)


def test_vmaf_proxy_and_shape_errors_match_jax():
    for p in (math.inf, 99.0, 50.0, 35.5, 20.0, 10.0):
        for s in (1.0, 0.95, 0.5, 0.3, 0.0):
            assert tq.vmaf_proxy(p, s) == jq.vmaf_proxy(p, s)
    a, b = np.zeros((32, 32), np.uint8), np.zeros((32, 48), np.uint8)
    for mod in (tq, jq):
        for fn in (mod.psnr_db, mod.ssim):
            with pytest.raises(ValueError):
                fn(a, b)
    assert tq.PSNR_CAP_DB == jq.PSNR_CAP_DB


@pytest.mark.parametrize("seed", range(6))
def test_bd_rate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    anchor = [(float(r), float(q)) for r, q in zip(np.sort(rng.uniform(200, 8000, n)),
                                                   np.sort(rng.uniform(28, 45, n)))]
    test = [(r * float(rng.uniform(0.4, 1.6)), q + float(rng.uniform(-1, 1)))
            for r, q in anchor]
    assert tq.bd_rate(anchor, test) == jq.bd_rate(anchor, test)
    half = [(r / 2, q) for r, q in anchor]
    assert tq.bd_rate(anchor, half) == jq.bd_rate(anchor, half)


@pytest.mark.parametrize("val,rate", [(None, None), ("1", "7"), ("0", "x"), ("on", "0"),
                                      ("TRUE", "-3"), ("nope", "300")])
def test_switches_match_jax(monkeypatch, val, rate):
    for k, v in (("SELKIES_QUALITY", val), ("SELKIES_QUALITY_SAMPLE", rate)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    assert tq.quality_enabled() == jq.quality_enabled()
    assert tq.sample_rate() == jq.sample_rate()


@pytest.mark.parametrize("codec", ["h264", "vp9", "av1", "h265", "vp8"])
def test_decoder_available_matches_jax(codec):
    assert tq.decoder_available(codec) == jq.decoder_available(codec)


# -- decode oracles and the live probe over each codec's stream ----------------

def _h264_aus(frames):
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

    enc = TorchH264Encoder(W, H, qp=24, device="cpu")
    try:
        return [enc.encode_frame(f) for f in frames]
    finally:
        enc.close()


def _vp9_aus(frames):
    from selkies_tpu_torch.models.libvpx_enc import LibVpxEncoder

    enc = LibVpxEncoder(W, H, fps=30, bitrate_kbps=4000)
    try:
        return [enc.encode_frame(f) for f in frames]
    finally:
        enc.close()


def _av1_aus(frames):
    from selkies_tpu_torch.models.libaom_enc import LibAomEncoder

    enc = LibAomEncoder(W, H, fps=30, bitrate_kbps=4000)
    try:
        return [enc.encode_frame(f) for f in frames]
    finally:
        enc.close()


def _encoder_loads(codec: str) -> bool:
    if codec == "vp9":
        from selkies_tpu_torch.models.libvpx_enc import libvpx_available

        return libvpx_available()
    if codec == "av1":
        from selkies_tpu_torch.models.libaom_enc import libaom_available

        return libaom_available()
    return True


_AUS = {"h264": _h264_aus, "vp9": _vp9_aus, "av1": _av1_aus}


def _stream(codec: str):
    if not tq.decoder_available(codec) or not _encoder_loads(codec):
        pytest.skip(f"no loadable {codec} decoder or encoder")
    frames = codec_trace(9, W, H, static=(4,))
    return frames, _AUS[codec](frames)


@pytest.mark.parametrize("codec", ["h264", "vp9", "av1"])
def test_gop_decoder_matches_jax(codec):
    frames, aus = _stream(codec)
    t = tq.GopDecoder(codec).decode_all(aus)
    j = jq.GopDecoder(codec).decode_all(aus)
    assert len(t) == len(j) == len(aus)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    last = tq.GopDecoder(codec).decode_last(aus[:5])
    np.testing.assert_array_equal(last, jq.GopDecoder(codec).decode_last(aus[:5]))
    assert tq.psnr_db(tq.GopDecoder(codec).decode_all(aus[:1])[0],
                      j[0]) == math.inf


def _probe_run(pkg, codec, frames, aus, *, sample_every, max_gop):
    slo = pkg["slo"].SessionSLO(
        "3", targets={"unknown": pkg["slo"].SLOTargets(psnr_floor_db=35.0)},
        min_quality_samples=1)
    probe = pkg["q"].QualityProbe(session="3", codec=codec, scenario="typing",
                                  sample_every=sample_every, max_gop=max_gop, slo=slo,
                                  sync=True)
    views = []
    for i, (f, au) in enumerate(zip(frames, aus)):
        probe.note_frame(i, f)
        probe.note_au(i, au, idr=i in (0, 6))
        if i == 5:
            probe.set_scenario("video")
        views.append(probe.stats())
    probe.close()
    roll = pkg["tele"].rollup()["histograms"]
    hists = {k: v for k, v in roll.items() if k.startswith("selkies_quality")}
    evs = [{k: v for k, v in e.items() if k != "t"}
           for e in pkg["tele"].recorder.events("3") if e["ev"] == "quality_sample"]
    return views, hists, evs, slo.quality_samples, slo.stats()["quality_samples"]


@pytest.mark.parametrize("codec", ["h264", "vp9", "av1"])
@pytest.mark.parametrize("sample_every,max_gop", [(1, 600), (2, 4), (3, 600)])
def test_quality_probe_matches_jax(tele_on, codec, sample_every, max_gop):
    """Every probe view after each AU, its telemetry and its SLO feed; an
    IDR at frame 6 (the stream's own first AU again) re-arms the GOP."""
    frames, aus = _stream(codec)
    aus = list(aus)
    aus[6] = aus[0]
    frames = list(frames)
    frames[6] = frames[0]
    t = _probe_run(PORT, codec, frames, aus, sample_every=sample_every, max_gop=max_gop)
    j = _probe_run(JAX, codec, frames, aus, sample_every=sample_every, max_gop=max_gop)
    assert t == j
    assert t[0][-1]["scored"] >= 1


def test_probe_without_oracle_matches_jax():
    for codec in ("h266", "vp8"):
        t, j = tq.QualityProbe(codec=codec), jq.QualityProbe(codec=codec)
        for p in (t, j):
            p.note_frame(0, np.zeros((H, W, 4), np.uint8))
            p.note_au(0, b"\x00\x00\x00\x01", idr=True)
        assert t.stats() == j.stats()
    for mod in (tq, jq):
        with pytest.raises(ValueError):
            mod.GopDecoder("h265")
