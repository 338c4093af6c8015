"""The share of the blocks that the block-adaptive step ran as a CUDA
graph's replay, over the window's pushes (a fleet's or a session's ticks):
100 x ``block.steps_graphed`` / ``block.steps``, the program's counters
(%).  Nothing for a program without the counters, or with no block stepped
in the window."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("block.steps", 0) <= 0:
        return None
    return 100.0 * c.get("block.steps_graphed", 0) / c["block.steps"]
