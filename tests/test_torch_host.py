"""Port host layers: the copied bitstream/CAVLC modules, the port's native
packer binding, and the rule that the port imports nothing of JAX or of
the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
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
