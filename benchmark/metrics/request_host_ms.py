"""ms of a request (a fleet tick's or a session's push) during which no
kernel runs: the push's wall time less the union of the kernel intervals
inside it, averaged over the window's pushes."""

from benchmark.yardstick import covered_many


def read(run):
    spans = run.span(run.driver.span)
    if run.trace is None or len(spans) == 0:
        return None
    busy = covered_many(run.trace.union, spans)
    return float(((spans[:, 1] - spans[:, 0]) - busy).mean() * 1e3)
