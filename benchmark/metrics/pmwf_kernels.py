"""Kernels a call of the offline PMWF plan: the profiler's raw kernel
events inside the window's ``enhance_batch`` calls, over the calls."""

from benchmark.yardstick import count_within


def read(run):
    spans = run.span("enhance_batch")
    if run.trace is None or len(spans) == 0:
        return None
    return float(count_within(run.trace.starts, spans).sum() / len(spans))
