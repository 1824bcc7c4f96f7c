"""How far behind the host the card ran a P tick: the card's execution of the tick's step-done event minus the host's record of it (``last_timing["device_tail_ms"]``, on the tracer's device clock), mean over the window's P ticks. Near 0 the card waits on the Python issue. None where the program has no such stamp."""

LAYER = "Device"
SOURCE = "program_span"
MOVES = "keyframe_ms"
WORKLOADS = ["sessions8.pli"]


def read(run):
    v = [t["device_tail_ms"] for t in run.entry.ticks if not t["idr"] and "device_tail_ms" in t]
    return sum(v) / len(v) if v else None
