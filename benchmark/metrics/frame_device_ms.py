"""Device ms a frame stepped: the union of the kernel intervals inside the
window's pushes over the frames those pushes stepped."""

from benchmark.yardstick import covered_many


def read(run):
    spans = run.span(run.driver.span)
    if run.trace is None or len(spans) == 0:
        return None
    frames = len(spans) * int(run.cell.traffic["tick_hops"])
    return float(covered_many(run.trace.union, spans).sum() / frames * 1e3)
