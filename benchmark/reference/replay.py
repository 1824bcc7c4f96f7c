"""Re-encode the frames a run handed to the program and give the sampled AUs.

Each session's frames are encoded in order, as the encoder's stated
policy codes them (``Frame``): an IDR, a P frame against the previous
reconstruction, or, where the configuration codes unchanged captures as
skips, an all-skip P slice that leaves the reference as it was. Only the
sampled frames are entropy-coded; every frame a sampled one depends on is
reconstructed, since the next one predicts from it.

A configuration that states ``"bands": R`` (1 by default) splits its
padded MB rows into R equal bands, and every picture is R slices in band
order, as ISO/IEC 14496-10 (the slice header, 7.3.3; neighbour
availability, 6.4.x and 8.4.1.3) and the band policy of the repository's
``docs/bands.md`` ("Correctness") have it:

* **IDR:** each band is coded as a picture of its own rows: DC prediction
  along the band's top MB row, from the left, vertical below it.
* **P:** each band takes its own coarse vote over its own MBs and its own
  rows of the reference (edge-padded at the band's edges); the refine SAD
  and the compensation read the whole picture's reconstruction,
  edge-padded at the picture's edges only (``h264.Encoder.motion`` with
  ``mb_row0``). That is what the encoder's band slab reads where its halo
  of rows (and, in a tile grid, of columns) covers the search's reach plus
  the chroma bilinear's extra row, as its default of ``h264.MV_PAD`` does.
  A tile grid (``"cols": C``) merges its tiles' votes and MV grids into the
  band-row's, so it codes the same slices as its R bands.
* **Entropy:** each band's slice data is packed over the band's MB grid
  (its top row sees no neighbours above), its header carrying
  ``first_mb_in_slice``, the band's first MB; an unchanged capture is one
  all-skip slice per band.

With one band the band is the picture and its slice starts at MB 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reference import bitstream as bs
from reference import cavlc, h264


@dataclass(frozen=True)
class Frame:
    """How one frame is coded: ``idr``, its ``frame_num`` and ``idr_pic_id``,
    and the reference marking its slice carries."""

    idr: bool
    frame_num: int
    idr_pic_id: int = 0
    marking: bs.Marking = bs.Marking()


def _host(fc: dict, b: int | None = None) -> dict:
    """A frame's levels as numpy arrays (row ``b`` of a batched step)."""
    out = {}
    for k, v in fc.items():
        if k == "recon":
            continue
        if torch.is_tensor(v):
            v = (v if b is None else v[b]).cpu().numpy()
        out[k] = v
    return out


class Coder:
    """Codes the frames of ``sessions`` sessions tick by tick as the stated
    policy says, keeping each session's reference and last capture, each
    picture in ``cfg["bands"]`` band slices. The replay and the control
    both code through it; they differ only in ``precision``."""

    def __init__(self, cfg: dict, sessions: int, device, precision: str = "exact"):
        w, h = int(cfg["width"]), int(cfg["height"])
        self.qp = int(cfg["qp"])
        self.ph, self.pw = (h + 15) // 16 * 16, (w + 15) // 16 * 16
        stream = bs.Stream(w, h, self.qp)
        self.headers = bs.sps(stream) + bs.pps(stream)
        self.bands = int(cfg.get("bands", 1))
        mbh, mbw = self.ph // 16, self.pw // 16
        if mbh % self.bands:
            raise ValueError(f"{self.bands} bands do not split {mbh} MB rows equally")
        self.band_mbh = mbh // self.bands
        self.bh = 16 * self.band_mbh
        # a band's slice is packed against the band's own MB grid
        self.stream = bs.Stream(self.pw, self.bh, self.qp)
        self.first_mb = [b * self.band_mbh * mbw for b in range(self.bands)]
        self.enc = h264.Encoder(self.bh, self.pw, device, precision)
        self.device = device
        self.static_skip = bool(cfg.get("static_skip", False))
        self.refs, self.prev = [None] * sessions, [None] * sessions
        self._planes: dict = {}

    def _rows(self, planes, b: int) -> tuple:
        """Band ``b``'s rows of (y, u, v) planes, with any leading axes."""
        r0, h = b * self.bh, self.bh
        return (planes[0][..., r0:r0 + h, :], planes[1][..., r0 // 2:(r0 + h) // 2, :],
                planes[2][..., r0 // 2:(r0 + h) // 2, :])

    def _join(self, fcs: list, j=None) -> tuple:
        """The bands' reconstructions as one picture's planes (session ``j``
        of a batched step)."""
        recs = [fc["recon"] if j is None else tuple(r[j] for r in fc["recon"]) for fc in fcs]
        return recs[0] if len(recs) == 1 else tuple(torch.cat(p) for p in zip(*recs))

    def tick(self, frames: list, want=None) -> dict:
        """frames: (s, i, Frame, BGRx capture, cache key or None) of one
        tick, at most one a session. Reconstructs every one, band by band,
        the sessions' P frames of a band in one batched step, and
        entropy-codes those in ``want`` (all where None). -> {(s, i): AU
        bytes}."""
        qp, out, batch = self.qp, {}, []
        for s, i, fr, frame, key in frames:
            coded = want is None or (s, i) in want
            static = (self.static_skip and not fr.idr and self.prev[s] is not None
                      and np.array_equal(frame, self.prev[s]))
            if self.static_skip:
                self.prev[s] = frame.copy()
            if static:
                if coded:
                    out[(s, i)] = b"".join(
                        cavlc.pack_p({"qp": qp}, self.stream, frame_num=fr.frame_num,
                                     marking=fr.marking, all_skip=True, first_mb=mb0)
                        for mb0 in self.first_mb)
                continue
            planes = self._planes.get(key) if key is not None else None
            if planes is None:
                planes = h264.bgrx_to_i420(
                    torch.from_numpy(np.ascontiguousarray(frame)).to(self.device), self.ph, self.pw)
                if key is not None:
                    self._planes[key] = planes
            if not fr.idr:
                batch.append((s, i, fr, planes, coded))
                continue
            fcs = [self.enc.encode_idr(*self._rows(planes, b), qp) for b in range(self.bands)]
            self.refs[s] = self._join(fcs)
            if coded:
                out[(s, i)] = self.headers + b"".join(
                    cavlc.pack_i(_host(fc), self.stream, frame_num=0,
                                 idr_pic_id=fr.idr_pic_id, first_mb=mb0)
                    for fc, mb0 in zip(fcs, self.first_mb))
        if batch:
            planes = [torch.stack([p[k] for *_, p, _ in batch]) for k in range(3)]
            ref = tuple(torch.stack([self.refs[s][k] for s, *_ in batch]) for k in range(3))
            fcs = [self.enc.encode_p(*self._rows(planes, b), ref, qp, mb_row0=b * self.band_mbh)
                   for b in range(self.bands)]
            for j, (s, i, fr, _, coded) in enumerate(batch):
                self.refs[s] = self._join(fcs, j)
                if coded:
                    out[(s, i)] = b"".join(
                        cavlc.pack_p(_host(fc, j), self.stream, frame_num=fr.frame_num,
                                     marking=fr.marking, first_mb=mb0)
                        for fc, mb0 in zip(fcs, self.first_mb))
        return out


def needed(plan: list, wanted: set) -> list:
    """Which of a session's frames 0..max(wanted) the sampled ones (indices
    in ``wanted``) depend on: a frame is needed where a sampled frame at or
    after it is reached from it with no IDR in between, since an IDR codes
    from nothing but its capture."""
    last = max(wanted, default=-1)
    out, need = [False] * (last + 1), False
    for i in range(last, -1, -1):
        need = need or i in wanted
        out[i] = need
        if plan[i].idr:
            need = False
    return out


def replay(cfg: dict, screens, plans: list, want: set, device, precision: str = "exact") -> dict:
    """plans[s][i] codes frame i of session s; ``want`` holds the (s, i) to
    entropy-code. Frame i of every session is coded before frame i + 1, the
    sessions' P frames in one batched step; frames that no sampled frame
    depends on are skipped. -> {(s, i): AU bytes}."""
    n = len(plans)
    coder = Coder(cfg, n, device, precision)
    need = [needed(plans[s], {i for t, i in want if t == s}) for s in range(n)]
    out = {}
    for i in range(max(len(x) for x in need)):
        frames = []
        for s in range(n):
            if i >= len(need[s]):
                continue
            frame = screens.frame(s, i)       # frames may be states: make every one
            if need[s][i]:
                frames.append((s, i, plans[s][i], frame, screens.key(s, i)))
        out.update(coder.tick(frames, want))
    return out
