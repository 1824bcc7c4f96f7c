"""ctypes binding for the repo's C++ CAVLC packer (``native/cavlc_pack.cc``)
and CABAC arithmetic engine (``native/cabac_pack.cc``).

The port builds ``native/cavlc_pack.cc`` + ``native/cabac_pack.cc`` with
``g++`` at first use into ``build/torch_kernels/`` (see
``selkies_tpu_torch.utils.build``); it never runs ``make`` inside
``native/``. The packers are byte-identical to the pure-Python ones in
``cavlc.py`` (tests/test_torch_host.py). A build failure raises: there
is no quiet fallback to the Python packer.

``calls`` counts native packer calls, so a run can show that the native
packer (and not the Python oracle) packed its slices; ``sparse_calls``
counts the sparse-wire P packer (``pack_slice_p_sparse_native``) alone,
and ``cabac_calls`` the CABAC arithmetic engine (``cabac_encode_tokens``),
which every CABAC slice goes through.
The encoder's completion workers pack on several threads at once (ctypes
releases the GIL), so the counts advance under a lock.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from selkies_tpu_torch.models.h264.bitstream import (
    NAL_SLICE_IDR,
    NAL_SLICE_NON_IDR,
    SLICE_I,
    SLICE_P,
    StreamParams,
    write_slice_header,
)
from selkies_tpu_torch.models.h264.numpy_ref import FrameCoeffs, PFrameCoeffs
from selkies_tpu_torch.utils.bits import BitWriter
from selkies_tpu_torch.utils.build import REPO_ROOT, BuildResult, build_shared

_NATIVE_DIR = REPO_ROOT / "native"
_SOURCES = [_NATIVE_DIR / "cavlc_pack.cc", _NATIVE_DIR / "cabac_pack.cc"]
_HEADERS = (_NATIVE_DIR / "cavlc_tables.h",)
_COMMAND = ["g++", "-O2", "-Wall", "-fPIC", "-std=c++17", "-shared",
            f"-I{_NATIVE_DIR}"]

calls = 0  # native slice packs (all three packers)
sparse_calls = 0  # pack_slice_p_sparse_native packs
cabac_calls = 0  # cabac_encode_tokens runs

_lib: ctypes.CDLL | None = None
_build: BuildResult | None = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()

_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build() -> BuildResult:
    """Build (or find) the library; returns the build record."""
    _load()
    return _build


def _load() -> ctypes.CDLL:
    global _lib, _build
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            res = build_shared("libcavlc", _SOURCES, _COMMAND, headers=_HEADERS)
            lib = ctypes.CDLL(str(res.path))
            lib.pack_slice_rbsp.restype = ctypes.c_int64
            lib.pack_slice_rbsp.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                _I16P, _I16P, _I16P, _I16P, _I16P, _I16P,
                ctypes.c_int, ctypes.c_int,
                _U8P, ctypes.c_int64, _I32P, _I32P,
            ]
            lib.pack_slice_p_rbsp.restype = ctypes.c_int64
            lib.pack_slice_p_rbsp.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                _I16P, _U8P, _I16P, _I16P, _I16P,
                ctypes.c_int, ctypes.c_int,
                _U8P, ctypes.c_int64, _I32P, _I32P,
            ]
            lib.pack_slice_p_sparse_rbsp.restype = ctypes.c_int64
            lib.pack_slice_p_sparse_rbsp.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                _I16P, _I16P, ctypes.c_int32, ctypes.c_int32,
                _I16P, _I16P, _I16P, ctypes.c_int32,
                _I16P, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int, ctypes.c_int,
                _U8P, ctypes.c_int64, _I32P, _I32P, _I32P,
            ]
            lib.emulation_prevent.restype = ctypes.c_int64
            lib.emulation_prevent.argtypes = [_U8P, ctypes.c_int64, _U8P, ctypes.c_int64]
            lib.derive_skip_mvs.restype = None
            lib.derive_skip_mvs.argtypes = [_I32P, _U8P, ctypes.c_int, ctypes.c_int]
            # a library without the CABAC engine fails here, at load
            lib.cabac_encode_tokens.restype = ctypes.c_int64
            lib.cabac_encode_tokens.argtypes = [
                _U8P, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, _U8P, ctypes.c_int64]
            _build, _lib = res, lib
    return _lib


def _count(sparse: bool = False) -> None:
    global calls, sparse_calls
    with _count_lock:
        calls += 1
        if sparse:
            sparse_calls += 1


def _count_cabac() -> None:
    global cabac_calls
    with _count_lock:
        cabac_calls += 1


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def emulation_prevent(rbsp: bytes) -> bytes:
    """Native emulation-prevention (7.4.1): equals utils.bits.emulation_prevent."""
    src = np.frombuffer(rbsp, np.uint8)
    out = np.empty(len(src) + len(src) // 2 + 16, np.uint8)
    m = _load().emulation_prevent(_ptr(src, _U8P), len(src), _ptr(out, _U8P), len(out))
    if m < 0:
        raise RuntimeError("emulation_prevent overflow")
    return out[:m].tobytes()


def derive_skip_mvs(mvs: np.ndarray, skip: np.ndarray) -> None:
    """Fill P_Skip MBs' motion vectors in place (8.4.1.1)."""
    if mvs.dtype != np.int32 or not mvs.flags["C_CONTIGUOUS"]:
        raise ValueError("mvs must be a C-contiguous int32 (mbh, mbw, 2) array")
    mbh, mbw = skip.shape
    if mvs.shape != (mbh, mbw, 2):
        raise ValueError(f"mvs shape {mvs.shape} does not match skip {skip.shape}")
    sk = np.ascontiguousarray(skip, np.uint8)
    _load().derive_skip_mvs(_ptr(mvs, _I32P), _ptr(sk, _U8P), mbh, mbw)


def _scratch(mbh: int, mbw: int, cap: int) -> dict[str, np.ndarray]:
    return {
        "rbsp": np.empty(cap, np.uint8),
        "luma_tc": np.empty(mbh * 4 * mbw * 4, np.int32),
        "chroma_tc": np.empty(2 * mbh * 2 * mbw * 2, np.int32),
        "mv": np.empty(mbh * mbw * 2, np.int32),  # the sparse packer's MV grid
    }


def _finish_nal(rbsp: np.ndarray, n: int, nal_type: int) -> bytes:
    lib = _load()
    ebsp = np.empty(n + n // 2 + 16, np.uint8)
    m = lib.emulation_prevent(_ptr(rbsp, _U8P), n, _ptr(ebsp, _U8P), len(ebsp))
    if m < 0:
        raise RuntimeError("emulation_prevent overflow")
    return b"\x00\x00\x00\x01" + bytes([(3 << 5) | nal_type]) + ebsp[:m].tobytes()


def pack_slice_fast(fc: FrameCoeffs, p: StreamParams, frame_num: int = 0,
                    idr: bool = True, idr_pic_id: int = 0, first_mb: int = 0) -> bytes:
    """I slice NAL; byte-identical to cavlc.pack_slice (the JAX package's
    ``native.pack_slice_fast`` signature; the port always packs natively)."""
    lib = _load()
    mbh, mbw = fc.luma_mode.shape
    hdr = BitWriter()
    write_slice_header(hdr, p, SLICE_I, frame_num, idr=idr, idr_pic_id=idr_pic_id,
                       slice_qp=fc.qp, first_mb=first_mb)
    hdr_bytes, hdr_bits = hdr.get_partial()
    arrs = [np.ascontiguousarray(getattr(fc, name), dtype=np.int16)
            for name in ("luma_mode", "chroma_mode", "luma_dc", "luma_ac",
                         "chroma_dc", "chroma_ac")]
    cap = mbh * mbw * 1024 + len(hdr_bytes) + 1024
    while True:
        s = _scratch(mbh, mbw, cap)
        n = lib.pack_slice_rbsp(
            hdr_bytes, hdr_bits, *(_ptr(a, _I16P) for a in arrs), mbh, mbw,
            _ptr(s["rbsp"], _U8P), cap, _ptr(s["luma_tc"], _I32P),
            _ptr(s["chroma_tc"], _I32P))
        if n >= 0:
            break
        cap *= 2  # pathological content; retry with more room
        if cap > (1 << 30):
            raise RuntimeError("pack_slice_rbsp overflow beyond 1 GiB")
    _count()
    return _finish_nal(s["rbsp"], n, NAL_SLICE_IDR if idr else NAL_SLICE_NON_IDR)


def pack_slice_p_fast(fc: PFrameCoeffs, p: StreamParams, frame_num: int,
                      ltr_ref: int | None = None, mark_ltr: int | None = None,
                      mmco_evict: tuple = (), first_mb: int = 0) -> bytes:
    """P slice NAL; byte-identical to cavlc.pack_slice_p (the JAX package's
    ``native.pack_slice_p_fast`` signature)."""
    lib = _load()
    mbh, mbw = fc.skip.shape
    hdr = BitWriter()
    write_slice_header(hdr, p, SLICE_P, frame_num, idr=False, slice_qp=fc.qp,
                       ltr_ref=ltr_ref, mark_ltr=mark_ltr,
                       mmco_evict=mmco_evict, first_mb=first_mb)
    hdr_bytes, hdr_bits = hdr.get_partial()
    mvs = np.ascontiguousarray(fc.mvs, dtype=np.int16)
    skip = np.ascontiguousarray(fc.skip, dtype=np.uint8)
    luma_ac = np.ascontiguousarray(fc.luma_ac, dtype=np.int16)
    chroma_dc = np.ascontiguousarray(fc.chroma_dc, dtype=np.int16)
    chroma_ac = np.ascontiguousarray(fc.chroma_ac, dtype=np.int16)
    cap = mbh * mbw * 1024 + len(hdr_bytes) + 1024
    while True:
        s = _scratch(mbh, mbw, cap)
        n = lib.pack_slice_p_rbsp(
            hdr_bytes, hdr_bits, _ptr(mvs, _I16P), _ptr(skip, _U8P),
            _ptr(luma_ac, _I16P), _ptr(chroma_dc, _I16P), _ptr(chroma_ac, _I16P),
            mbh, mbw, _ptr(s["rbsp"], _U8P), cap, _ptr(s["luma_tc"], _I32P),
            _ptr(s["chroma_tc"], _I32P))
        if n >= 0:
            break
        cap *= 2
        if cap > (1 << 30):
            raise RuntimeError("pack_slice_p_rbsp overflow beyond 1 GiB")
    _count()
    return _finish_nal(s["rbsp"], n, NAL_SLICE_NON_IDR)


def pack_slice_p_sparse_native(wire, p: StreamParams, frame_num: int, qp: int,
                               ltr_ref: int | None = None, mark_ltr: int | None = None,
                               mmco_evict: tuple = (), first_mb: int = 0) -> bytes:
    """P slice NAL straight from the sparse downlink's wire views
    (``compact.SparsePWire``): no dense scatter, no PFrameCoeffs.
    Byte-identical to cavlc.pack_slice_p fed the unpacked frame."""
    lib = _load()
    mbh, mbw = wire.mbh, wire.mbw
    hdr = BitWriter()
    write_slice_header(hdr, p, SLICE_P, frame_num, idr=False, slice_qp=qp,
                       ltr_ref=ltr_ref, mark_ltr=mark_ltr,
                       mmco_evict=mmco_evict, first_mb=first_mb)
    hdr_bytes, hdr_bits = hdr.get_partial()
    arrs = [np.ascontiguousarray(a, np.int16) for a in (
        wire.skip16, wire.pairs16, wire.rows16, wire.bitmaps, wire.vals, wire.extra_rows)]
    skip16, pairs16, rows16, bitmaps, vals, extra = arrs
    cap = len(hdr_bytes) + 4096 + 40 * wire.ns + 72 * wire.n
    while True:
        s = _scratch(mbh, mbw, cap)
        n = lib.pack_slice_p_sparse_rbsp(
            hdr_bytes, hdr_bits, _ptr(skip16, _I16P), _ptr(pairs16, _I16P),
            wire.ns, 1 if wire.packed else 0,
            _ptr(rows16, _I16P), _ptr(bitmaps, _I16P), _ptr(vals, _I16P),
            wire.held, _ptr(extra, _I16P), wire.n, len(vals), mbh, mbw,
            _ptr(s["rbsp"], _U8P), cap, _ptr(s["luma_tc"], _I32P),
            _ptr(s["chroma_tc"], _I32P), _ptr(s["mv"], _I32P))
        if n >= 0:
            break
        if n == -2:
            raise ValueError("sparse wire inconsistent: pair/row/value counts disagree "
                             "with the skip bitmap or mbinfo words")
        cap *= 2
        if cap > (1 << 30):
            raise RuntimeError("pack_slice_p_sparse_rbsp overflow beyond 1 GiB")
    _count(sparse=True)
    return _finish_nal(s["rbsp"], n, NAL_SLICE_NON_IDR)


def cabac_encode_tokens(states: np.ndarray, tokens: np.ndarray) -> bytes:
    """Run a slice's token stream (``cabac.py``'s uint16 IR) through the
    native arithmetic engine from the given context states. Byte-identical
    to ``cabac.encode_tokens_py``."""
    lib = _load()
    st = np.ascontiguousarray(states, np.uint8)
    tok = np.ascontiguousarray(tokens, np.uint16)
    cap = int(len(tok)) + 64  # ~1 bit per bin; one byte per token is generous
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.cabac_encode_tokens(_ptr(st, _U8P), tok.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)), len(tok), _ptr(out, _U8P), cap)
        if n == -2:
            raise ValueError("token stream did not end in a TERM(1) flush")
        if n >= 0:
            _count_cabac()
            return out[:n].tobytes()
        cap *= 2  # RUN/BYP tokens can expand past one byte per token
        if cap > (1 << 30):
            raise RuntimeError("cabac_encode_tokens overflow beyond 1 GiB")
