"""Per-slice sparse P completion: fused downlink words -> slice NAL.

Counterpart of ``selkies_tpu/models/h264/sparse_complete.py``. A delta
frame's fused sparse downlink is finished in four steps:

  1. read the fetched prefix's need/row/non-skip counts
     (``p_sparse_*_need``) and feed the fetch-hint loop;
  2. refetch the full live content when the hint-sized slice fell short;
  3. fetch the row spill past the fused cap (``fetch_rest``);
  4. hand the wire regions straight to the native sparse packer
     (``p_sparse_wire_views`` + ``pack_slice_p_sparse_native``), or when
     ns > nscap (or ``native_wire=False``, or the stream is CABAC) expand
     the rows on the host (``unpack_p_sparse_*``, with the dense-header
     fallback fetch) and pack with the native dense packer or the host
     CABAC coder.

With ``device_bits=True`` the buffer is the entropy-wrapped layout
(encoder_core.pack_p_sparse_entropy): its meta says whether the payload
is the sparse layout above (at an offset) or the frame's device-coded
slice -- its final bits (CAVLC: the host splices the header,
``assemble_p_nal``) or its token stream (CABAC: the host interleaves the
skip and terminate bins and runs the engine, ``assemble_p_cabac_nal``).

Device buffers are torch tensors. The prefix arrives already fetched;
each refetch, spill or dense-fallback fetch here is one more copy (rare).
Given ``step_done``, the event recorded when the step that wrote the
buffers finished, that copy runs on a side stream behind that event
only, and the worker waits on the copy's own event: it neither waits for
the steps other sessions enqueued since nor makes a synchronising call.
Without it the copy is a blocking ``.cpu()``, which on the card waits for
every step queued since (correct, only slower).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from selkies_tpu_torch.device import host
from selkies_tpu_torch.models.h264.cabac import pack_slice_p_cabac
from selkies_tpu_torch.models.h264.compact import (
    ENTROPY_META16,
    p_sparse_entropy_meta,
    p_sparse_packed_need,
    p_sparse_var_need,
    p_sparse_wire_views,
    unpack_p_compact,
    unpack_p_sparse_packed,
    unpack_p_sparse_var,
)
from selkies_tpu_torch.models.h264.device_cabac import assemble_p_cabac_nal
from selkies_tpu_torch.models.h264.device_cavlc import assemble_p_nal
from selkies_tpu_torch.models.h264.native import pack_slice_p_fast, pack_slice_p_sparse_native
from selkies_tpu_torch.monitoring.tracing import tracer

__all__ = ["complete_sparse_slice", "fetch_rest"]


def _settle_device_bits(fused, need: int, note_need, link_bytes, prefix_bytes: int, full_d,
                        step_done=None):
    """The device-coded payload's shared plumbing, for both coders: the
    hint feedback, the ``down_bits`` accounting and the refetch when the
    hint-sized prefix fell short. -> the (possibly refetched) buffer."""
    if note_need is not None:
        note_need(need)
    if link_bytes is not None and prefix_bytes:
        link_bytes.add("down_bits", prefix_bytes)
    if need > len(fused):  # hint too small: refetch
        # the span marks only this extra transfer; the prefix's fetch rode
        # the caller's "fetch" span
        with tracer.span("bits_fetch"):
            fused = host(full_d, step_done)
        if link_bytes is not None:
            link_bytes.add("down_bits_refetch", fused.nbytes)
    return fused


def fetch_rest(buf, n: int, base: int = 4096, after=None) -> np.ndarray:
    """Rows [base, >=n) of a row buffer, fetched in power-of-two buckets
    from 4096 (the whole buffer's tail once the bucket reaches it);
    ``after`` as for ``device.host``."""
    total = buf.shape[0]
    bucket = max(base, 4096)
    while bucket < n:
        bucket <<= 1
    if bucket >= total:
        return host(buf, after)[base:]
    return host(buf[base:bucket], after)


def complete_sparse_slice(
    fused: np.ndarray,
    *,
    mbh: int,
    mbw: int,
    nscap: int,
    cap_rows: int,
    qp: int,
    frame_num: int,
    params,
    packed: bool = False,
    device_bits: bool = False,
    full_d=None,
    buf_d=None,
    dense_d=None,
    link_bytes=None,
    prefix_bytes: int = 0,
    note_need: Callable[[int], None] | None = None,
    native_wire: bool = True,
    ltr_ref: int | None = None,
    mark_ltr: int | None = None,
    mmco_evict: tuple = (),
    first_mb: int = 0,
    entropy_coder: str = "cavlc",
    cabac_init_idc: int = 0,
    step_done=None,
) -> tuple[bytes, int, float, str]:
    """One P slice's fetched sparse prefix -> (nal, skipped_mbs,
    t_unpacked, downlink_mode).

    ``full_d`` is the full fused buffer on the device (shortfall refetch),
    ``buf_d`` the row buffer (spill), ``dense_d`` the dense header (the
    ns > nscap fallback). ``prefix_bytes`` is the size of the fetched
    prefix, counted as ``down_bits`` when it carried a device-coded slice,
    else ``down_prefix``. ``downlink_mode`` is "bits" / "cabac" (the
    device-coded payload), "coeff", or "dense" when the dense-header
    fallback ran. ``ltr_ref``, ``mark_ltr`` and ``mmco_evict`` go to the
    slice header (the LTR scene cache), as do ``first_mb`` (a band's first
    macroblock, parallel/bands.py) and ``cabac_init_idc``. ``step_done``:
    the event after which the device buffers are complete (module
    docstring)."""
    off = 0
    if device_bits:
        mode, nbits, trailing, nskip, ns = p_sparse_entropy_meta(fused)
        if mode == 1 and entropy_coder == "cabac":
            ntok = nbits  # the nbits slot carries the token count
            m = mbh * mbw
            sw = (m + 31) // 32
            nw = (ntok + 1) // 2
            base = ENTROPY_META16 + 2 * sw
            fused = _settle_device_bits(fused, base + ns + 2 * nw, note_need, link_bytes,
                                        prefix_bytes, full_d, step_done)
            skip_words = np.ascontiguousarray(fused[ENTROPY_META16:base]).view(np.uint32)
            skip = (((skip_words[:, None].astype(np.int64) >> np.arange(32)) & 1)
                    .astype(bool).reshape(-1)[:m].reshape(mbh, mbw))
            counts = fused[base:base + ns].astype(np.int64)
            words = np.ascontiguousarray(fused[base + ns:base + ns + 2 * nw]).view(np.uint32)
            t_unpacked = time.perf_counter()
            with tracer.span("pack"):
                nal = assemble_p_cabac_nal(words, ntok, counts, skip, params, frame_num, qp,
                                           ltr_ref=ltr_ref, mark_ltr=mark_ltr,
                                           mmco_evict=mmco_evict, first_mb=first_mb,
                                           cabac_init_idc=cabac_init_idc)
            return nal, nskip, t_unpacked, "cabac"
        if mode == 1:
            nw = (nbits + 31) // 32
            fused = _settle_device_bits(fused, ENTROPY_META16 + 2 * nw, note_need, link_bytes,
                                        prefix_bytes, full_d, step_done)
            words = np.ascontiguousarray(fused[ENTROPY_META16:ENTROPY_META16 + 2 * nw]).view(
                np.uint32)
            t_unpacked = time.perf_counter()
            with tracer.span("pack"):
                nal = assemble_p_nal(words, nbits, trailing, params, frame_num, qp,
                                     ltr_ref=ltr_ref, mark_ltr=mark_ltr, mmco_evict=mmco_evict,
                                     first_mb=first_mb)
            return nal, nskip, t_unpacked, "bits"
        # mode 0: the sparse coefficient layout at an offset
        off = ENTROPY_META16
        fused = fused[off:]
    if link_bytes is not None and prefix_bytes:
        link_bytes.add("down_prefix", prefix_bytes)
    mode = "coeff"
    with tracer.span("unpack"):
        need_fn = p_sparse_packed_need if packed else p_sparse_var_need
        need, n, ns = need_fn(fused, mbh, mbw, nscap, cap_rows)
        if note_need is not None:
            note_need(need + off)
        if need > len(fused):  # hint too small: refetch the live content
            fused = host(full_d, step_done)[off:]
            if link_bytes is not None:
                link_bytes.add("down_refetch", fused.nbytes)
        extra = None
        if n > cap_rows:  # rows spilled past the fused buffer
            extra = fetch_rest(buf_d, n, cap_rows, step_done)
            if link_bytes is not None:
                link_bytes.add("down_spill", extra.nbytes)
        wire = pfc = None
        if ns <= nscap and native_wire and entropy_coder == "cavlc":
            wire = p_sparse_wire_views(fused, mbh, mbw, nscap, cap_rows, packed, extra)
        if wire is None:
            unpack = unpack_p_sparse_packed if packed else unpack_p_sparse_var
            pfc, rows = unpack(fused, qp, mbh, mbw, nscap, cap_rows, extra)
            if pfc is None:  # ns > nscap: dense-header fallback fetch
                if dense_d is None:
                    raise RuntimeError("ns > nscap with no dense fallback buffer")
                dense = host(dense_d, step_done)
                if link_bytes is not None:
                    link_bytes.add("down_spill", dense.nbytes)
                pfc = unpack_p_compact(dense, rows, qp)
                mode = "dense"
    t_unpacked = time.perf_counter()
    with tracer.span("pack"):
        if wire is not None:
            nal = pack_slice_p_sparse_native(wire, params, frame_num, qp, ltr_ref=ltr_ref,
                                             mark_ltr=mark_ltr, mmco_evict=mmco_evict,
                                             first_mb=first_mb)
            skipped = mbh * mbw - wire.ns
        elif entropy_coder == "cabac":
            # a Main-profile stream cannot carry CAVLC slices (the PPS sets
            # entropy_coding_mode_flag): coefficients go through the host CABAC
            # coder
            nal = pack_slice_p_cabac(pfc, params, frame_num, ltr_ref=ltr_ref, mark_ltr=mark_ltr,
                                     mmco_evict=mmco_evict, first_mb=first_mb,
                                     cabac_init_idc=cabac_init_idc)
            skipped = int(pfc.skip.sum())
        else:
            nal = pack_slice_p_fast(pfc, params, frame_num=frame_num, ltr_ref=ltr_ref,
                                    mark_ltr=mark_ltr, mmco_evict=mmco_evict, first_mb=first_mb)
            skipped = int(pfc.skip.sum())
    return nal, skipped, t_unpacked, mode
