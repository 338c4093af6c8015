"""Kernels a block stepped: the profiler's raw kernel events inside the
window's pushes over the blocks the block-adaptive step ran in them
(``block.steps``, the program's counter).  Nothing for a program without
the counter, or with no block stepped in the window."""

from benchmark.program_trace import program_counters
from benchmark.yardstick import count_within


def read(run):
    spans = run.span(run.driver.span)
    c = program_counters()
    if run.trace is None or len(spans) == 0 or not c \
            or c.get("block.steps", 0) <= 0:
        return None
    return float(count_within(run.trace.starts, spans).sum()
                 / c["block.steps"])
