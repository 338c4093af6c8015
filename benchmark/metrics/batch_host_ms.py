"""ms of an ``enhance_batch`` call during which no kernel runs: the call's
wall time less the union of the kernel intervals inside it, averaged over
the window's calls."""

from benchmark.yardstick import covered_many


def read(run):
    spans = run.span("enhance_batch")
    if run.trace is None or len(spans) == 0:
        return None
    busy = covered_many(run.trace.union, spans)
    return float(((spans[:, 1] - spans[:, 0]) - busy).mean() * 1e3)
