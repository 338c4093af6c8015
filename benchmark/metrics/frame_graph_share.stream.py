"""The share of the frames that the exact plan's frame loop stepped inside a
CUDA graph's replay, over the window's pushes (a session's or a fleet's
frame loop): 100 x ``frame.steps_graphed`` / ``frame.steps``, the program's
counters (%).  Nothing for a program without the counters, or with no frame
stepped in the window."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("frame.steps", 0) <= 0:
        return None
    return 100.0 * c.get("frame.steps_graphed", 0) / c["frame.steps"]
