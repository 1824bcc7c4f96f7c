"""The batched IDR branch of the mixed tick (the keying session's step inside ``device-step``): the mean ``step-i`` span (``tracer.summary()``). None where the program has no such span."""

LAYER = "Device step dispatch"
SOURCE = "program_span"
MOVES = "keyframe_ms"
WORKLOADS = ["sessions8.pli"]


def read(run):
    s = run.entry.tracer().summary().get("step-i")
    return s["mean_ms"] if s else None
