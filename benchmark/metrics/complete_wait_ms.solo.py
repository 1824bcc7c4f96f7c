"""The submit thread's wait on the row's completion workers (``complete_wait`` spans, ``tracer.summary()``): their total over the frames handed over in the window. None where the program has no such span."""

LAYER = "Serving loop"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["solo.typing"]


def read(run):
    s = run.entry.tracer().summary().get("complete_wait")
    if not s or not run.handed:
        return None
    return s["count"] * s["mean_ms"] / len(run.handed)
