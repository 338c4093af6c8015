"""The device's idle share of the window of a closed loop of calls:
1 - (union of kernel intervals / window) (%)."""

from benchmark.yardstick import covered


def read(run):
    if run.trace is None or len(run.span("enhance_batch")) == 0:
        return None
    busy = covered(run.trace.union, run.t0, run.t1)
    return 100.0 * (1.0 - busy / (run.t1 - run.t0))
