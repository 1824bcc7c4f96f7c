"""Frames per second of the traced run of the tile grid: AUs returned inside the window over the window's seconds. In this run the profiler records 4 s of the window. The host's speed moves the rate from run to run by more than an end-to-end bound can hold, so it is read here, with no bound."""

LAYER = "Serving loop"
SOURCE = "host_clock"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def read(run):
    done = run.in_window()
    return len(done) / run.window_s if done else None
