"""The host's BGRx to I420 conversion of a coded 4K frame: the mean ``convert`` span of the tile grid's dispatch (``tracer.summary()``). None where the program has no such span."""

LAYER = "Host front end"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def read(run):
    s = run.entry.tracer().summary().get("convert")
    return s["mean_ms"] if s else None
