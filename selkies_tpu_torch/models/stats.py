"""Copy of ``selkies_tpu/models/stats.py``, kept so the port imports nothing of the JAX package.

Per-frame encoder statistics — shared by every encoder row.

One definition so pipeline/elements.py, monitoring, and tests consume a
single type regardless of which encoder produced the frame.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


class LinkByteCounter:
    """Per-stage host<->device link-byte accounting.

    Stages prefixed "up_" count host->device bytes, "down_" counts
    device->host. Incremented from the dispatch thread AND the
    completion workers, hence the lock. bench.py and
    tools/profile_link_bytes.py read snapshots around a timed pass to
    report bytes/frame per direction — the quantity the relay actually
    prices (PERF.md cost model)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: dict[str, int] = {}

    def add(self, stage: str, nbytes: int) -> None:
        with self._lock:
            self._stages[stage] = self._stages.get(stage, 0) + int(nbytes)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._stages)


@dataclass
class FrameStats:
    frame_index: int
    idr: bool
    qp: int
    bytes: int
    device_ms: float
    pack_ms: float
    skipped_mbs: int = 0
    scene_cut: bool = False  # full-frame change coded as P (keyframe-sized)
    # host completion sub-stages (pack_ms = unpack_ms + cavlc_ms for the
    # coefficient rows; encoder rows without the split leave them 0):
    # unpack_ms is downlink-bytes -> packer-ready coefficients (sparse
    # expansion / dense scatter / fallback fetches), cavlc_ms the entropy
    # pack + NAL assembly itself
    unpack_ms: float = 0.0
    cavlc_ms: float = 0.0
    # device-stage sub-split (device_ms ≈ upload_ms + step_ms + fetch_ms
    # plus queueing; rows without the attribution leave them 0):
    # upload_ms is the HOST front-end cost of the frame — classify +
    # convert + h2d enqueue + packing glue — step_ms is step-dispatch ->
    # device outputs ready (including any time the dispatch call itself
    # blocks: that is device-side backpressure, not host work — ISSUE 12
    # reattribution, PERF.md round 12), fetch_ms the d2h transfer itself
    upload_ms: float = 0.0
    step_ms: float = 0.0
    fetch_ms: float = 0.0
    # front-end sub-split of upload_ms (ISSUE 12; rows without the
    # attribution leave them 0): classify_ms is the fused dirty scan +
    # tile-cache hash/split (damage-bounded when the capture layer
    # passes rect hints), convert_ms the BGRx->I420 conversion of the
    # upload payload (full planes or dirty tiles), h2d_ms the
    # host->device transfer enqueues
    classify_ms: float = 0.0
    convert_ms: float = 0.0
    h2d_ms: float = 0.0
    # intra-frame band parallelism (parallel/bands.py): slice count and
    # per-band dispatch->ready latency when the frame was band-split.
    # cols > 1 = 2D tile grid (SELKIES_TILE_GRID): each of the `bands`
    # slice rows was additionally tile-split across `cols` chips
    # (band_step_ms stays per ROW — the row payload is col-merged on
    # device before it is fetched)
    bands: int = 1
    cols: int = 1
    band_step_ms: tuple = ()
    # upload-side classification signals for the scenario policy engine
    # (selkies_tpu/policy): upload_kind is the encoder's own frame
    # class ("static" byte-identical capture / "delta" tile upload /
    # "full" whole-frame upload; "" for rows without the attribution),
    # dirty_frac the dirty-tile fraction of the frame (1.0 for full
    # uploads), remap_frac the fraction of those dirty tiles served as
    # tile-cache remaps instead of pixel uploads. Metadata only — never
    # feeds back into the encoded bytes.
    upload_kind: str = ""
    dirty_frac: float = 0.0
    remap_frac: float = 0.0
    # which payload the P downlink shipped (ISSUE 7 / PERF.md round 9):
    # "coeff" sparse coefficient rows, "bits" device-entropy slice bits,
    # "dense" a dense-fallback fetch; "" for frames with no downlink
    # (static all-skip) or encoder rows that don't attribute it. A
    # banded frame reports "bits" only when EVERY band shipped bits.
    downlink_mode: str = ""
