"""The keying session's host CAVLC pack on a tick that holds an IDR (``last_timing["idr_pack_ms"]``, the tick's longest IDR pack), mean over those ticks. None where the program has no such stamp."""

LAYER = "Host pack"
SOURCE = "program_span"
MOVES = "keyframe_ms"
WORKLOADS = ["sessions8.pli"]


def read(run):
    v = [t["idr_pack_ms"] for t in run.entry.ticks if t["idr"] and "idr_pack_ms" in t]
    return sum(v) / len(v) if v else None
