"""Kernels a frame stepped: the profiler's raw kernel events inside the
window's pushes over the frames those pushes stepped."""

from benchmark.yardstick import count_within


def read(run):
    spans = run.span(run.driver.span)
    if run.trace is None or len(spans) == 0:
        return None
    frames = len(spans) * int(run.cell.traffic["tick_hops"])
    return float(count_within(run.trace.starts, spans).sum() / frames)
