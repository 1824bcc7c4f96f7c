"""Share of the traced stretch in which no kernel or copy ran on the card (merged device intervals)."""

LAYER = "Device"
SOURCE = "device_trace"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def read(run):
    act = run.activity
    if act is None or not act.ops:
        return None
    return 100.0 * (1.0 - act.busy_s / act.window_s)
