"""The card's time per P frame of the tile grid: the mean ``gpu-step`` device span (``tracer.summary()``), from the step's first op to band 0's step-done (behind the whole step, before any downlink copy), over the window's coded frames (P frames only: the cell's mix asks for no keyframe). None where the program has no such span."""

LAYER = "Device"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def read(run):
    s = run.entry.tracer().summary().get("gpu-step")
    return s["mean_ms"] if s else None
