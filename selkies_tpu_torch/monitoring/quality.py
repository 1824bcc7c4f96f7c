"""Decode-and-compare quality probe: PSNR/SSIM/VMAF for live sessions.

The port's copy of ``selkies_tpu/monitoring/quality.py``, decoding through
the port's ``models/av1/dav1d.py`` and ``models/libvpx_enc.py``; ``cv2``
stays optional.

Every bench row to date judged encoders on fps/bytes/latency alone;
ROADMAP item 2 calls the rate/quality frontier untouched and names the
prerequisite: a quality harness so every encoder row gets a quality
axis next to fps and bytes. This module is that harness, three layers
deep:

**Metric kernels** (:func:`psnr_db`, :func:`ssim`, :func:`vmaf_proxy`)
score a decoded luma plane against the pre-encode I420 source.
Identical planes score ``PSNR=inf`` / ``SSIM=1.0``; a seeded noise
ladder scores strictly monotonically worse (tests/test_quality.py).
The VMAF axis uses the real ``vmaf`` CLI when it is on PATH (bench
sequences only — it is far too slow per-frame) and otherwise a
documented rank-preserving proxy composite of PSNR and SSIM; every
emitted score carries ``vmaf_kind`` (``cli``/``proxy``) so the two are
never mistaken for each other. The proxy's definition and validity
bounds are in docs/quality.md — it tracks ordering on this repo's
synthetic scenario traces, it is NOT a perceptual model.

**Decode oracles** (:class:`GopDecoder`) reconstruct frames from the
encoded access units through the same independent decoders the
conformance tests trust: FFmpeg-via-OpenCV for H.264 (annex-B temp
file -> ``cv2.VideoCapture``), ctypes libdav1d for AV1, ctypes libvpx
for VP9. Decoded pixels come back as I420 planes; the H.264 path's
BGR round-trip re-derives luma with the encoders' own BT.601 matrix
(``models/libvpx_enc._bgrx_to_i420_np``) so the conversion bias is
shared with the reference plane.

**The live probe** (:class:`QualityProbe`) rides the solo video
pipeline behind ``SELKIES_QUALITY`` (off by default — no probe object
is ever constructed, so wire bytes and hot-path timing are untouched
by construction, the SELKIES_SLO/SELKIES_POLICY discipline). Enabled,
it samples one frame in ``SELKIES_QUALITY_SAMPLE`` (default 300 —
one score every ~5 s at 60 fps): the sampled frame's source luma is
retained at submit, the encoded AUs since the last IDR are buffered
(GOP-bounded), and when the sampled frame's AU completes the GOP
prefix is decoded and scored on a single background worker — the
serving loop never blocks on a decode. Scores land in the
``selkies_quality_psnr_db``/``ssim``/``vmaf`` histograms (labeled
session + scenario), the flight-recorder event ring
(``quality_sample``), the ``/statz`` ``quality`` block, and — when
the SLO plane is armed — the ``quality`` burn-rate objective
(monitoring/slo.py, min-PSNR floor per scenario class).

**BD-rate** (:func:`bd_rate`) is the Bjøntegaard delta-rate used by
``bench.py --quality`` to compare rate/quality curves against the
x264 software anchors: fit log(rate) as a polynomial in PSNR per
curve, integrate both fits over the overlapping PSNR interval, and
report the average rate delta as a percentage (negative = the test
curve spends fewer bits for the same quality).
"""

from __future__ import annotations

import logging
import math
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("quality")

__all__ = [
    "ENV_VAR", "SAMPLE_ENV_VAR", "quality_enabled", "sample_rate",
    "psnr_db", "ssim", "vmaf_proxy", "score_planes", "QualityScore",
    "GopDecoder", "decoder_available", "QualityProbe", "bd_rate",
    "vmaf_cli_available", "vmaf_cli_score", "PSNR_CAP_DB",
]

ENV_VAR = "SELKIES_QUALITY"
SAMPLE_ENV_VAR = "SELKIES_QUALITY_SAMPLE"

# identical planes are PSNR=inf mathematically; emitted series cap at
# this value so histogram sums and JSON rows stay finite (documented in
# docs/quality.md — anything >= the cap means "visually lossless")
PSNR_CAP_DB = 99.0


def quality_enabled() -> bool:
    """``SELKIES_QUALITY=1`` opts in; unset/0 means no probe object is
    ever constructed (byte-identical to a pre-quality build by
    construction, the SELKIES_SLO precedent)."""
    return os.environ.get(ENV_VAR, "0").strip().lower() in (
        "1", "true", "on", "yes")


def sample_rate() -> int:
    """Score one frame in N (``SELKIES_QUALITY_SAMPLE``, default 300 —
    one sample every ~5 s at 60 fps)."""
    try:
        n = int(os.environ.get(SAMPLE_ENV_VAR, "300"))
    except ValueError:
        n = 300
    return max(1, n)


# ---------------------------------------------------------------------------
# metric kernels (luma plane, uint8)
# ---------------------------------------------------------------------------


def psnr_db(ref: np.ndarray, dec: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB between two uint8 planes.
    ``inf`` when identical."""
    r = np.asarray(ref, np.float64)
    d = np.asarray(dec, np.float64)
    if r.shape != d.shape:
        raise ValueError(f"plane shape mismatch {r.shape} vs {d.shape}")
    mse = float(np.mean((r - d) ** 2))
    if mse <= 0.0:
        return math.inf
    return 10.0 * math.log10(255.0 * 255.0 / mse)


def _box_sum(a: np.ndarray, w: int) -> np.ndarray:
    """Sliding w*w window sums via an integral image (valid region)."""
    c = np.cumsum(np.cumsum(a, axis=0, dtype=np.float64), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    return c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]


def ssim(ref: np.ndarray, dec: np.ndarray, window: int = 8) -> float:
    """Mean structural similarity over sliding ``window``-square patches
    (uniform box weighting — the numpy-only form; Gaussian weighting
    shifts absolute values slightly but preserves ordering, which is
    what the probe consumes). 1.0 when identical."""
    r = np.asarray(ref, np.float64)
    d = np.asarray(dec, np.float64)
    if r.shape != d.shape:
        raise ValueError(f"plane shape mismatch {r.shape} vs {d.shape}")
    w = int(window)
    if r.shape[0] < w or r.shape[1] < w:
        w = max(1, min(r.shape))
    n = float(w * w)
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    mu_r = _box_sum(r, w) / n
    mu_d = _box_sum(d, w) / n
    var_r = _box_sum(r * r, w) / n - mu_r * mu_r
    var_d = _box_sum(d * d, w) / n - mu_d * mu_d
    cov = _box_sum(r * d, w) / n - mu_r * mu_d
    num = (2.0 * mu_r * mu_d + c1) * (2.0 * cov + c2)
    den = (mu_r * mu_r + mu_d * mu_d + c1) * (var_r + var_d + c2)
    return float(np.mean(num / den))


def vmaf_proxy(psnr: float, ssim_val: float) -> float:
    """Documented VMAF-proxy composite (docs/quality.md): equal-weight
    blend of PSNR rescaled over [20, 50] dB and SSIM rescaled over
    [0.3, 1.0], mapped to the familiar 0-100 axis. Rank-preserving in
    both inputs; NOT a perceptual model — emitted series must carry
    ``vmaf_kind="proxy"`` so it is never read as a real VMAF score."""
    p = min(max((min(psnr, PSNR_CAP_DB) - 20.0) / 30.0, 0.0), 1.0)
    s = min(max((ssim_val - 0.3) / 0.7, 0.0), 1.0)
    return 100.0 * (0.5 * p + 0.5 * s)


class QualityScore:
    """One scored sample. ``vmaf_kind`` says which axis produced
    ``vmaf`` (``cli`` = real libvmaf, ``proxy`` = the documented
    composite)."""

    __slots__ = ("psnr_db", "ssim", "vmaf", "vmaf_kind")

    def __init__(self, psnr: float, ssim_val: float, vmaf: float,
                 vmaf_kind: str = "proxy"):
        self.psnr_db = psnr
        self.ssim = ssim_val
        self.vmaf = vmaf
        self.vmaf_kind = vmaf_kind

    def as_dict(self) -> dict:
        return {"psnr_db": round(min(self.psnr_db, PSNR_CAP_DB), 3),
                "ssim": round(self.ssim, 5),
                "vmaf": round(self.vmaf, 2),
                "vmaf_kind": self.vmaf_kind}


def score_planes(ref_y: np.ndarray, dec_y: np.ndarray) -> QualityScore:
    """Score one decoded luma plane against its pre-encode source."""
    p = psnr_db(ref_y, dec_y)
    s = ssim(ref_y, dec_y)
    return QualityScore(p, s, vmaf_proxy(p, s), "proxy")


# ---------------------------------------------------------------------------
# real-VMAF CLI (dormant when the binary is absent; bench-only — far too
# slow per-frame for the live probe)
# ---------------------------------------------------------------------------


def vmaf_cli_available() -> bool:
    return shutil.which("vmaf") is not None


def _write_y4m(path: str, frames: list[tuple[np.ndarray, np.ndarray,
                                             np.ndarray]], fps: int) -> None:
    h, w = frames[0][0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420\n".encode())
        for y, u, v in frames:
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


def vmaf_cli_score(ref: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
                   dec: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
                   fps: int = 60) -> float | None:
    """Mean VMAF of a decoded sequence vs its source through the real
    ``vmaf`` CLI (y4m pair + JSON output). None when the binary is
    absent or the run fails — callers fall back to :func:`vmaf_proxy`
    and label the axis accordingly."""
    if not vmaf_cli_available() or not ref or len(ref) != len(dec):
        return None
    import json as _json

    tmp = tempfile.mkdtemp(prefix="selkies-vmaf-")
    ref_p = os.path.join(tmp, "ref.y4m")
    dec_p = os.path.join(tmp, "dec.y4m")
    out_p = os.path.join(tmp, "vmaf.json")
    try:
        _write_y4m(ref_p, ref, fps)
        _write_y4m(dec_p, dec, fps)
        proc = subprocess.run(
            ["vmaf", "-r", ref_p, "-d", dec_p, "--json", "-o", out_p],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            logger.warning("vmaf CLI failed (rc=%d): %s", proc.returncode,
                           proc.stderr[-500:])
            return None
        with open(out_p, encoding="utf-8") as f:
            doc = _json.load(f)
        return float(doc["pooled_metrics"]["vmaf"]["mean"])
    except Exception:
        logger.exception("vmaf CLI scoring failed")
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# decode oracles
# ---------------------------------------------------------------------------


def decoder_available(codec: str) -> bool:
    """Can this process reconstruct ``codec`` frames independently?"""
    codec = codec.lower()
    if codec == "h264":
        try:
            import cv2  # noqa: F401
            return True
        except Exception:
            return False
    if codec == "av1":
        from selkies_tpu_torch.models.av1.dav1d import dav1d_available
        return dav1d_available()
    if codec == "vp9":
        from selkies_tpu_torch.models.libvpx_enc import libvpx_available
        return libvpx_available()
    return False


class GopDecoder:
    """Stateless GOP decoder: feed the access units from an IDR through
    the frame of interest, get decoded luma planes back. Each call
    builds a fresh decoder so a sample can never be poisoned by a
    previous sample's state — the cost is O(GOP prefix) per decode,
    which is why the live probe samples and runs off-thread."""

    def __init__(self, codec: str = "h264"):
        self.codec = codec.lower()
        if self.codec not in ("h264", "av1", "vp9"):
            raise ValueError(f"no decode oracle for codec {self.codec!r}")

    def decode_all(self, aus: list[bytes]) -> list[np.ndarray]:
        """Decoded luma planes for every frame in ``aus`` (in order).
        May return fewer planes than AUs if the tail did not flush."""
        if not aus:
            return []
        if self.codec == "h264":
            return self._decode_h264(aus)
        if self.codec == "av1":
            from selkies_tpu_torch.models.av1.dav1d import Dav1dDecoder

            dec = Dav1dDecoder()
            out = []
            try:
                for tu in aus:
                    out.extend(y for y, _u, _v in dec.decode(tu))
                out.extend(y for y, _u, _v in dec.flush())
            finally:
                dec.close()
            return out
        from selkies_tpu_torch.models.libvpx_enc import LibVpxDecoder

        dec = LibVpxDecoder()
        out = []
        try:
            for frame in aus:
                out.extend(y for y, _u, _v in dec.decode(frame))
        finally:
            dec.close()
        return out

    def decode_last(self, aus: list[bytes]) -> np.ndarray | None:
        """Luma of the LAST frame of ``aus`` (the live probe's shape:
        decode the GOP prefix, score the sampled frame)."""
        planes = self.decode_all(aus)
        if len(planes) < len(aus):
            # the decoder held back frames (no flush): the last plane
            # is not the sampled frame — refuse rather than mis-score
            return None
        return planes[-1] if planes else None

    @staticmethod
    def _decode_h264(aus: list[bytes]) -> list[np.ndarray]:
        """FFmpeg-via-OpenCV oracle: annex-B byte stream to a temp file,
        cv2.VideoCapture decodes it, BGR comes back; luma re-derived
        with the encoders' own BT.601 matrix so the round-trip bias is
        shared with the reference plane (tests/test_quality_vs_software
        precedent)."""
        import cv2

        from selkies_tpu_torch.models.libvpx_enc import _bgrx_to_i420_np

        fd, path = tempfile.mkstemp(suffix=".h264", prefix="selkies-q-")
        try:
            with os.fdopen(fd, "wb") as f:
                for au in aus:
                    f.write(au)
            cap = cv2.VideoCapture(path)
            out: list[np.ndarray] = []
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    out.append(_bgrx_to_i420_np(frame)[0])
            finally:
                cap.release()
            return out
        finally:
            os.unlink(path)


# ---------------------------------------------------------------------------
# the live probe
# ---------------------------------------------------------------------------


class QualityProbe:
    """Sampled decode-and-compare scoring for one live session.

    Wiring contract (pipeline/elements.py): ``note_frame(ts, frame)``
    at submit with the 90 kHz timestamp the encoder is keyed on, and
    ``note_au(ts, au, idr)`` for every completed access unit (tick
    path and policy drain). Both are cheap on non-sampled frames: a
    counter bump and a bounded ``bytes`` append. Scoring runs on one
    background worker; when it falls behind, new samples are DROPPED
    (counted in ``stats()['dropped_busy']``) — the probe never queues
    unbounded work and never blocks the serving loop.

    Sampling model (docs/quality.md): a sampled frame is scored only
    while the GOP buffer covers it — AUs are buffered from the last
    IDR, capped at ``max_gop`` (default 600, the full-motion policy
    GOP). On an infinite-GOP interactive session the probe scores the
    first ``max_gop`` frames after each IDR and then goes quiet until
    the next one; sessions that want continuous coverage run a
    periodic-IDR posture (the policy engine's full-motion rows already
    do).
    """

    def __init__(self, session: str = "0", codec: str = "h264", *,
                 scenario: str = "unknown", sample_every: int | None = None,
                 max_gop: int = 600, slo=None, sync: bool = False):
        self.session = str(session)
        self.codec = codec.lower()
        self.scenario = str(scenario)
        self.sample_every = int(sample_every) if sample_every else \
            sample_rate()
        self.max_gop = max(1, int(max_gop))
        self.slo = slo
        self._decoder = GopDecoder(self.codec) \
            if decoder_available(self.codec) else None
        self._lock = threading.Lock()
        self._gop: list[bytes] = []
        self._gop_overflow = False
        self._pending: dict[int, np.ndarray] = {}  # ts -> source luma
        self._frames = 0
        self._sync = bool(sync)
        self._pool: ThreadPoolExecutor | None = None
        self._inflight = 0
        # read-side counters (stats())
        self.samples = 0          # samples scheduled for scoring
        self.scored = 0           # samples that produced a score
        self.dropped_busy = 0     # worker behind: sample skipped
        self.dropped_gop = 0      # GOP buffer overflowed before the IDR
        self.errors = 0
        self.last: dict | None = None
        self._sums = [0.0, 0.0, 0.0]
        if self._decoder is None:
            logger.warning("no decode oracle for codec %s; quality probe "
                           "is a no-op on session %s", self.codec, session)

    # -- intake (serving loop / policy drain thread) --------------------

    def note_frame(self, ts: int, frame: np.ndarray) -> None:
        """A frame is being submitted under 90 kHz timestamp ``ts``.
        Retains the source luma only when this frame is sampled."""
        if self._decoder is None:
            return
        self._frames += 1
        if self._frames % self.sample_every:
            return
        from selkies_tpu_torch.models.libvpx_enc import _bgrx_to_i420_np

        y = _bgrx_to_i420_np(np.asarray(frame))[0]
        with self._lock:
            self._pending[int(ts)] = y
            while len(self._pending) > 4:  # ts never completed (drops)
                self._pending.pop(next(iter(self._pending)))

    def note_au(self, ts: int, au: bytes, idr: bool) -> None:
        """The access unit for timestamp ``ts`` completed."""
        if self._decoder is None:
            return
        job = None
        with self._lock:
            if idr:
                self._gop.clear()
                self._gop_overflow = False
            if self._gop_overflow:
                pass
            elif len(self._gop) >= self.max_gop:
                self._gop.clear()
                self._gop_overflow = True
            else:
                self._gop.append(bytes(au))
            ref = self._pending.pop(int(ts), None)
            if ref is not None:
                if self._gop_overflow:
                    self.dropped_gop += 1
                elif self._inflight >= 1 and not self._sync:
                    self.dropped_busy += 1
                else:
                    self._inflight += 1
                    self.samples += 1
                    job = (list(self._gop), ref)
        if job is None:
            return
        if self._sync:
            self._score(*job)
        else:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="quality")
            self._pool.submit(self._score, *job)

    # -- scoring (background worker) ------------------------------------

    def _score(self, aus: list[bytes], ref_y: np.ndarray) -> None:
        try:
            dec_y = self._decoder.decode_last(aus)
            if dec_y is None or dec_y.shape != ref_y.shape:
                self.errors += 1
                return
            sc = score_planes(ref_y, dec_y)
            self.scored += 1
            capped = min(sc.psnr_db, PSNR_CAP_DB)
            self._sums[0] += capped
            self._sums[1] += sc.ssim
            self._sums[2] += sc.vmaf
            self.last = sc.as_dict()
            if telemetry.enabled:
                labels = {"session": self.session, "scenario": self.scenario}
                telemetry.observe("selkies_quality_psnr_db", capped, **labels)
                telemetry.observe("selkies_quality_ssim", sc.ssim, **labels)
                telemetry.observe("selkies_quality_vmaf", sc.vmaf, **labels)
                telemetry.event("quality_sample", session=self.session,
                                scenario=self.scenario, gop_frames=len(aus),
                                **self.last)
            slo = self.slo
            if slo is not None:
                try:
                    slo.observe_quality(capped)
                except Exception:
                    logger.exception("SLO quality intake failed")
        except Exception:
            self.errors += 1
            logger.exception("quality scoring failed on session %s",
                             self.session)
        finally:
            with self._lock:
                self._inflight -= 1

    # -- plumbing --------------------------------------------------------

    def set_scenario(self, scenario: str) -> None:
        """Scenario retarget (PolicyEngine.on_scenario chain): labels
        scores from now on; past histogram series keep their label."""
        self.scenario = str(scenario)

    def stats(self) -> dict:
        """The /statz ``quality`` block (telemetry provider)."""
        n = max(1, self.scored)
        return {
            "codec": self.codec,
            "scenario": self.scenario,
            "sample_every": self.sample_every,
            "oracle": self._decoder is not None,
            "frames_seen": self._frames,
            "samples": self.samples,
            "scored": self.scored,
            "dropped_busy": self.dropped_busy,
            "dropped_gop": self.dropped_gop,
            "errors": self.errors,
            "mean": {"psnr_db": round(self._sums[0] / n, 3),
                     "ssim": round(self._sums[1] / n, 5),
                     "vmaf": round(self._sums[2] / n, 2)}
            if self.scored else None,
            "last": self.last,
        }

    def close(self) -> None:
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


# ---------------------------------------------------------------------------
# BD-rate (Bjontegaard delta-rate) for the bench's rate/quality curves
# ---------------------------------------------------------------------------


def bd_rate(anchor: list[tuple[float, float]],
            test: list[tuple[float, float]]) -> float | None:
    """Average rate delta (percent) of ``test`` vs ``anchor`` over their
    overlapping quality interval; each input is [(rate_kbps, psnr_db),
    ...]. Negative = the test curve spends fewer bits for the same
    PSNR. The classic method: fit log(rate) as a polynomial in PSNR
    (degree min(3, points-1)) per curve, integrate both fits over the
    shared PSNR range, exponentiate the mean difference. None when a
    curve has < 2 points, the quality ranges do not overlap, the
    overlap is too thin to integrate meaningfully (< 0.5 dB), or the
    fit blows up (|result| > 1e4 % — near-duplicate PSNR points make
    the Vandermonde system ill-conditioned and the polynomial
    oscillates); a None row is dropped rather than committed."""
    def prep(pts):
        pts = sorted((float(q), math.log(float(r)))
                     for r, q in pts if r > 0 and math.isfinite(q))
        qs = [q for q, _ in pts]
        return qs, [lr for _, lr in pts]

    qa, la = prep(anchor)
    qt, lt = prep(test)
    if len(qa) < 2 or len(qt) < 2:
        return None
    lo = max(min(qa), min(qt))
    hi = min(max(qa), max(qt))
    if hi - lo < 0.5:
        return None
    pa = np.polyfit(qa, la, min(3, len(qa) - 1))
    pt = np.polyfit(qt, lt, min(3, len(qt) - 1))
    ia = np.polyint(pa)
    it = np.polyint(pt)
    span = hi - lo
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / span
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / span
    try:
        out = float((math.exp(avg_t - avg_a) - 1.0) * 100.0)
    except OverflowError:
        return None
    return out if abs(out) <= 1e4 else None
