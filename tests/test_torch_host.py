"""Port host layers: the copied bitstream/CAVLC modules, the port's native
packer binding, and the rule that the port imports nothing of JAX or of
the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from selkies_tpu.models.h264 import bitstream as jbs
from selkies_tpu.models.h264 import cavlc as jcavlc
from selkies_tpu_torch.models.h264 import bitstream as tbs
from selkies_tpu_torch.models.h264 import cavlc as tcavlc
from selkies_tpu_torch.models.h264 import encoder_core as T
from selkies_tpu_torch.models.h264 import native
from selkies_tpu_torch.models.h264 import numpy_ref as ref_np
from selkies_tpu_torch.models.h264.compact import (
    i_header_words,
    p_header_words,
    split_prefix,
    unpack_i_compact,
    unpack_p_compact,
)
from selkies_tpu_torch.utils import bits as tbits

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "selkies_tpu_torch"


def _i_coeffs(h, w, qp, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    out = T.encode_frame_planes(*(torch.from_numpy(p) for p in (y, u, v)), qp)
    return ref_np.FrameCoeffs(**{k: out[k].numpy() for k in (
        "luma_mode", "chroma_mode", "luma_dc", "luma_ac", "chroma_dc", "chroma_ac")}, qp=qp)


def _p_coeffs(h, w, qp, seed):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w), np.uint8)
    ref = np.clip(np.roll(cur, (2, -3), (0, 1)).astype(int)
                  + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    cu = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    args = [torch.from_numpy(np.array(a)) for a in (cur, cu, cu, ref, cu, cu)]
    out = T.encode_frame_p_planes(*args, qp)
    return ref_np.PFrameCoeffs(**{k: out[k].numpy() for k in (
        "mvs", "skip", "luma_ac", "chroma_dc", "chroma_ac")}, qp=qp)


@pytest.mark.parametrize("w,h,fps,coder", [(320, 192, 60, "cavlc"), (1920, 1080, 60, "cavlc"),
                                           (322, 178, 30, "cavlc"), (640, 480, 30, "cabac")])
def test_sps_pps_match_jax(w, h, fps, coder):
    jp = jbs.StreamParams(width=w, height=h, fps=fps, entropy_coder=coder)
    tp = tbs.StreamParams(width=w, height=h, fps=fps, entropy_coder=coder)
    assert tbs.write_sps(tp) == jbs.write_sps(jp)
    assert tbs.write_pps(tp) == jbs.write_pps(jp)


@pytest.mark.parametrize("qp", [12, 30, 45])
def test_slices_match_jax_on_same_coefficients(qp):
    jp, tp = jbs.StreamParams(width=64, height=48), tbs.StreamParams(width=64, height=48)
    fc = _i_coeffs(48, 64, qp, seed=qp)
    assert tcavlc.pack_slice(fc, tp, idr_pic_id=1) == jcavlc.pack_slice(fc, jp, idr_pic_id=1)
    pfc = _p_coeffs(48, 64, qp, seed=qp)
    for frame_num in (1, 255, 256 + 7):  # frame_num wraps at 256 (bitstream.py)
        assert (tcavlc.pack_slice_p(pfc, tp, frame_num)
                == jcavlc.pack_slice_p(pfc, jp, frame_num))


@pytest.mark.parametrize("qp", [0, 24, 51])
def test_native_binding_equals_python_packer(qp):
    p = tbs.StreamParams(width=64, height=48)
    fc = _i_coeffs(48, 64, qp, seed=100 + qp)
    pfc = _p_coeffs(48, 64, qp, seed=200 + qp)
    before = native.calls
    assert native.pack_slice_fast(fc, p, frame_num=0, idr=True, idr_pic_id=1) == \
        tcavlc.pack_slice(fc, p, frame_num=0, idr=True, idr_pic_id=1)
    assert native.pack_slice_p_fast(pfc, p, frame_num=3) == tcavlc.pack_slice_p(pfc, p, 3)
    assert native.calls == before + 2


def _wild_i_coeffs(mbh, mbw, seed, seams=(), qp=28):
    """Random Intra16x16 levels that reach CAVLC's corners: blocks dense
    enough for their neighbours' nC to reach 8 and beyond, levels past
    WriteLevel's escape prefixes (16 and above), MBs with DC only; in the
    MB rows on both sides of each seam, every other MB has no luma AC
    (cbp_luma 0; the MBs alternate from row to row) and every third no
    chroma AC."""
    rng = np.random.default_rng(seed)

    def levels(shape, dense):
        u = rng.random(shape)
        return np.where(u < 0.01, rng.integers(-8000, 8001, shape),
                        np.where(u < dense, rng.integers(-40, 41, shape),
                                 np.where(u < 2 * dense, rng.integers(-1, 2, shape), 0)))

    dense = rng.choice([0.0, 0.05, 0.3, 0.5], (mbh, mbw))
    luma_ac = levels((mbh, mbw, 4, 4, 4, 4), dense[:, :, None, None, None, None])
    chroma_ac = levels((mbh, mbw, 2, 2, 2, 4, 4), dense[:, :, None, None, None, None, None] / 2)
    for r in {r for s in seams for r in (s - 1, s)}:
        luma_ac[r, r % 2::2] = 0
        chroma_ac[r, ::3] = 0
    return ref_np.FrameCoeffs(
        luma_mode=rng.integers(0, 4, (mbh, mbw)), chroma_mode=rng.integers(0, 4, (mbh, mbw)),
        luma_dc=levels((mbh, mbw, 4, 4), 0.4), luma_ac=luma_ac,
        chroma_dc=levels((mbh, mbw, 2, 2, 2), 0.3), chroma_ac=chroma_ac, qp=qp)


def _split_counts():
    return native.calls, native.split_calls, native.row_chunks


# name -> (mbh, mbw, chunks, first_mb, idr); chunks None: one row per chunk
_SPLIT_CASES = {
    "one-chunk": (6, 5, 1, 0, True),
    "two": (6, 5, 2, 0, True),
    "three-odd-rows": (7, 5, 3, 0, True),
    "a-row-each-non-idr": (7, 4, None, 0, False),
    "band-three": (9, 6, 3, 54, True),
    "band-two-non-idr": (5, 3, 2, 15, False),
    "one-column-a-row-each": (5, 1, None, 0, True),
}


@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_i_slice_equals_the_single_pass(case):
    """An I slice packed as MB-row chunks and spliced equals
    pack_slice_rbsp's single call and the Python packer; a slice this small
    takes the single call through pack_slice_fast."""
    mbh, mbw, chunks, first_mb, idr = _SPLIT_CASES[case]
    chunks = chunks or mbh
    seams = [mbh * k // chunks for k in range(1, chunks)]
    fc = _wild_i_coeffs(mbh, mbw, seed=len(case), seams=seams)
    p = tbs.StreamParams(width=mbw * 16, height=(mbh + first_mb // mbw) * 16)
    want = tcavlc.pack_slice(fc, p, frame_num=3, idr=idr, idr_pic_id=1, first_mb=first_mb)
    calls, splits, chunked = _split_counts()
    assert native.pack_slice_fast(fc, p, 3, idr, 1, first_mb) == want
    assert _split_counts() == (calls + 1, splits, chunked)
    assert native._pack_slice_i(fc, p, 3, idr, 1, first_mb, chunks) == want
    assert _split_counts() == (calls + 2, splits + 1, chunked + chunks)
    # levels reach an escape prefix of 16 and above, and blocks nC >= 8
    assert max(np.abs(getattr(fc, k)).max() for k in ("luma_dc", "luma_ac", "chroma_ac")) > 4096
    ac = np.count_nonzero(fc.luma_ac.reshape(mbh, mbw, 16, 16)[..., 1:], axis=-1)
    assert (ac >= 8).any()


# name -> (mbh, mbw, cores, chunks the rule gives; None: the single call)
_RULE_CASES = {
    "1080p-8-cores": (68, 120, 8, 8),
    "1080p-many-cores": (68, 120, 64, 16),
    "4k-band": (45, 240, 8, 8),
    "short-wide": (9, 120, 8, 2),
    "under-1000-mbs": (7, 120, 8, None),
    "one-core": (40, 25, 1, None),
    "three-rows": (3, 400, 8, None),
}


@pytest.mark.parametrize("case", list(_RULE_CASES))
def test_i_slice_split_follows_the_rule(case, monkeypatch):
    """pack_slice_fast splits an I slice of 1000 MBs or more into
    min(cores, MB rows // 4, 16) chunks when that is 2 or more, and gives
    the single call's bytes either way."""
    mbh, mbw, cores, chunks = _RULE_CASES[case]
    native._row_pool()  # the pool keeps the cores it was made with
    monkeypatch.setattr(native, "_cores", lambda: cores)
    fc = _wild_i_coeffs(mbh, mbw, seed=mbh)
    p = tbs.StreamParams(width=mbw * 16, height=mbh * 16)
    want = native._pack_slice_i(fc, p, 0, True, 0, 0, None)
    calls, splits, chunked = _split_counts()
    assert native.pack_slice_fast(fc, p, 0, True, 0) == want
    assert _split_counts() == ((calls + 1, splits + 1, chunked + chunks) if chunks
                               else (calls + 1, splits, chunked))


def test_split_packs_from_a_busy_pool_finish():
    """Eight 1080p IDRs packed at once from an 8-worker pool, as the
    session service's first tick packs them: every pack's chunks queue on
    the row pool behind the others' and all finish, with the single call's
    bytes."""
    p = tbs.StreamParams(width=1920, height=1088)
    fcs = [_wild_i_coeffs(68, 120, seed=s) for s in range(8)]
    want = [native._pack_slice_i(fc, p, 0, True, 0, 0, None) for fc in fcs]
    splits = native.split_calls
    with ThreadPoolExecutor(max_workers=8) as pool:
        futures = [pool.submit(native._pack_slice_i, fc, p, 0, True, 0, 0, 8) for fc in fcs]
        got = [f.result(timeout=120) for f in futures]
    assert got == want
    assert native.split_calls == splits + 8


def test_native_emulation_prevent_and_skip_mvs():
    rng = np.random.default_rng(4)
    for data in (b"\x00\x00\x00\x00\x01\x00\x00\x03", rng.integers(0, 3, 4000, np.uint8).tobytes()):
        assert native.emulation_prevent(data) == tbits.emulation_prevent(data)
    mvs = rng.integers(-3, 4, (6, 9, 2)).astype(np.int32)
    skip = rng.random((6, 9)) < 0.5
    want = mvs.copy()
    for y in range(6):
        for x in range(9):
            if skip[y, x]:
                want[y, x] = ref_np.skip_mv_16x16(want, x, y)
    native.derive_skip_mvs(mvs, skip)
    np.testing.assert_array_equal(mvs, want)


def test_compact_roundtrip_to_coefficients():
    """pack_*_compact -> fuse -> split_prefix -> unpack gives the dense arrays back."""
    fc = _i_coeffs(48, 64, 20, seed=9)
    out = {k: torch.from_numpy(np.array(getattr(fc, k))) for k in (
        "luma_mode", "chroma_mode", "luma_dc", "luma_ac", "chroma_dc", "chroma_ac")}
    header, buf = T.pack_i_compact(out)
    for cap in (4096, 3):  # 3: the spill path supplies the rest
        prefix = T.fuse_downlink(header, buf, cap).numpy()
        hdr, data, n = split_prefix(prefix, i_header_words(3, 4))
        data = np.concatenate([data, buf[cap:n].numpy()]) if n > cap else data
        back = unpack_i_compact(hdr, data, 20)
        for k in out:
            np.testing.assert_array_equal(getattr(back, k), getattr(fc, k), err_msg=k)
    pfc = _p_coeffs(48, 64, 20, seed=9)
    pout = {k: torch.from_numpy(np.array(getattr(pfc, k))) for k in (
        "mvs", "skip", "luma_ac", "chroma_dc", "chroma_ac")}
    header, buf = T.pack_p_compact(pout)
    hdr, data, n = split_prefix(T.fuse_downlink(header, buf, 4096).numpy(), p_header_words(3, 4))
    back = unpack_p_compact(hdr, data, 20)
    for k in pout:
        np.testing.assert_array_equal(getattr(back, k), getattr(pfc, k), err_msg=k)


def _port_sources():
    return [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "selkies_tpu"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_port_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, selkies_tpu_torch\n"
        "for m in pkgutil.walk_packages(selkies_tpu_torch.__path__, 'selkies_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'selkies_tpu'))\n"
        "print('\\n'.join(bad)); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


WEBRTC_STACK = ("webrtc/__init__.py", "webrtc/stun.py", "webrtc/ice.py", "webrtc/dtls.py",
                "webrtc/srtp.py", "webrtc/fec.py", "webrtc/rtcp.py", "webrtc/sdp.py",
                "webrtc/sctp.py", "webrtc/peer.py", "webrtc/transport.py", "rtp.py",
                "rtp_h265.py", "rtp_av1.py", "rtp_vpx.py", "impair.py", "receiver.py")


def test_scan_covers_the_webrtc_stack():
    """The import scan above reads each of the port's copies of JAX's
    WebRTC stack, its RTP payloaders, impairment layer and receiver."""
    seen = {str(p.relative_to(REPO)) for p in _port_sources()}
    for rel in WEBRTC_STACK:
        assert f"selkies_tpu_torch/transport/{rel}" in seen, rel
        assert (REPO / "selkies_tpu" / "transport" / rel).exists(), rel


CLUSTER_AND_FLEET = ("cluster/__init__.py", "cluster/membership.py", "cluster/router.py",
                     "cluster/migrate.py", "parallel/fleet.py", "orchestrator.py",
                     "monitoring/telemetry.py")


def test_scan_covers_the_cluster_plane_and_the_fleet_server():
    """The import scan above reads each of the port's copies of JAX's
    cluster plane and the modules of the fleet server."""
    seen = {str(p.relative_to(REPO)) for p in _port_sources()}
    for rel in CLUSTER_AND_FLEET:
        assert f"selkies_tpu_torch/{rel}" in seen, rel
        assert (REPO / "selkies_tpu" / rel).exists(), rel
