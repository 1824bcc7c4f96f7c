"""A delta frame's wait in the row's pending group until its group's dispatch starts (``FrameStats.group_wait_ms``), mean over the window's delta frames. None where the program has no such stamp."""

LAYER = "Serving loop"
SOURCE = "program_span"
MOVES = "au_bytes"
WORKLOADS = ["solo.typing"]


def read(run):
    v = [st.group_wait_ms for st in run.entry.frames
         if st.upload_kind == "delta" and hasattr(st, "group_wait_ms")]
    return sum(v) / len(v) if v else None
