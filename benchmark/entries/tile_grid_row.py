"""Entry ``tile_grid_row``: one desktop on a registry row carved into band slices or a tile grid.

Builds ``create_encoder(row, width=, height=, qp=, bands=R, cols=C)``,
the registry's route for ``SELKIES_TILE_GRID=RxC`` (``"bands"`` and
``"cols"`` of the configuration, both 1 by default): on one card the
band- or tile-sliced encoder runs its carve stacked. It drives
``submit(frame)`` back to back; the encoder completes each frame at once.
A keyframe request is ``force_keyframe()`` before the frame. The build
raises where the encoder changed the carve it was asked for: a band count
or column count that does not split the MB grid, or halos other than the
full-reach default that the reference models.

Coding policy the reference follows (``reference/replay.py``): every
picture is R slices, one per band-row; the first frame and every frame
after a keyframe request are IDRs with the SPS and PPS in front, their
``idr_pic_id`` alternating 0, 1; every other frame is a P frame against
the previous one, ``frame_num`` counting from the IDR, with the sliding
window's marking; where ``static_skip`` is set, a capture equal to the
previous one is an all-skip P picture (one all-skip slice per band).
"""

from __future__ import annotations

from reference.replay import Frame
from yardstick.profile import program_spans

# the rows (columns) of reference a band (tile) reads beyond its own: the
# encoder's default, which covers the motion search's reach, as the reference has it
HALO = 40


class Entry:
    sessions = 1
    group = 1      # the encoder completes each frame at once

    def __init__(self, cfg: dict, device):
        from selkies_tpu_torch.models.registry import create_encoder

        bands, cols = int(cfg.get("bands", 1)), int(cfg.get("cols", 1))
        if bands * cols == 1:
            raise ValueError("a carve of one band and one column is the solo row: entry solo_row")
        self.enc = create_encoder(cfg["row"], width=int(cfg["width"]), height=int(cfg["height"]),
                                  qp=int(cfg["qp"]), bands=bands, cols=cols, device=device)
        want = {"bands": bands, "cols": cols,
                "halo": HALO if bands > 1 else 0, "halo_cols": HALO if cols > 1 else 0}
        got = {k: getattr(self.enc, k) for k in want}
        if got != want:
            self.enc.close()
            raise ValueError(f"the encoder carved {got}, not the configuration's {want}")
        self.frames: list = []     # FrameStats of the window's frames
        self._window = False

    def warm(self, feeder) -> None:
        """An IDR and two P frames; where the mix asks for keyframes, a
        forced IDR and the P frame after it."""
        for _ in range(3):
            feeder.feed()
        if feeder.screens.keyframe_every:
            feeder.feed([0])
            feeder.feed()

    def feed(self, j: int, screens, keyframes: list) -> list:
        if keyframes:
            self.enc.force_keyframe()
        outs = self.enc.submit(screens.frame(0, j), meta=j)
        if self._window:
            self.frames.extend(st for _, st, _ in outs)
        return [(0, meta, au) for au, _, meta in outs]

    def finish(self) -> list:
        return []

    def quiesce(self) -> list:
        return []   # each frame is complete when submit returns

    def start_window(self) -> None:
        self._window = True

    def end_window(self) -> None:
        self._window = False

    def tracer(self):
        from selkies_tpu_torch.monitoring.tracing import tracer

        return tracer

    def host_spans(self) -> list:
        return program_spans(self.tracer())

    def close(self) -> None:
        self.enc.close()
        del self.enc

    def plan(self, n: int, requests: set) -> list:
        return plan(self.sessions, n, requests)


def plan(sessions: int, n: int, requests: set) -> list:
    """How frames 0..n-1 are coded, given the (0, frame) pairs with a
    keyframe asked for."""
    rows, since, pic = [], 0, 0
    for i in range(n):
        if i == 0 or (0, i) in requests:
            rows.append(Frame(True, 0, pic))
            pic, since = pic ^ 1, 1
        else:
            rows.append(Frame(False, since % 256))
            since += 1
    return [rows]
