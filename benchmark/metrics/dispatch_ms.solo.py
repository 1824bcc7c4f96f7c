"""The Python issue of one device step of the row, single frame or group: the mean ``device-step`` span (``tracer.summary()``), from the ``step_ms`` stamp to the return of the step call. None where the program has no such span."""

LAYER = "Device step dispatch"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["solo.typing"]


def read(run):
    s = run.entry.tracer().summary().get("device-step")
    return s["mean_ms"] if s else None
