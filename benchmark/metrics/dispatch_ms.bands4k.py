"""The Python issue of the tile grid's P step (the stacked tile step: each band-row's vote, its tiles and its row pack): the mean ``step-p`` span (``tracer.summary()``). None where the program has no such span."""

LAYER = "Device step dispatch"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def read(run):
    s = run.entry.tracer().summary().get("step-p")
    return s["mean_ms"] if s else None
