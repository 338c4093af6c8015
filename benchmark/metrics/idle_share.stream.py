"""The device's idle share while requests are in service: 1 - (the union
of kernel intervals over the union of the requests' [due, done]
intervals) (%).  The open loop's waits for audio are left out."""

import numpy as np

from benchmark.yardstick import covered_many, merge


def read(run):
    service = run.counts.get("service")
    if run.trace is None or not service:
        return None
    s = np.asarray(service)
    live = merge(s[:, 0], s[:, 1])
    busy = covered_many(run.trace.union, live).sum()
    return 100.0 * (1.0 - busy / float((live[:, 1] - live[:, 0]).sum()))
