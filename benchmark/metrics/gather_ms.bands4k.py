"""The completion of a coded frame of the tile grid: the mean ``row_gather`` span (``tracer.summary()``), the three band-rows' fetch, unpack and pack on the pack pool until the access unit is assembled. None where the program has no such span."""

LAYER = "Host pack"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def read(run):
    s = run.entry.tracer().summary().get("row_gather")
    return s["mean_ms"] if s else None
