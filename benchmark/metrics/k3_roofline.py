"""K3's share of its roofline on the fast plan: its least time over its
profiled time (%).  The profiled time is that of K3's kernels in the
window (``yardstick_k3.K3_KERNELS``: the solve on either path and the W
normalisation); the least time is the larger of the operations over the
float32 peak and the bytes over the memory rate, counted from the
program's counters of K3's work over the window (``k3.columns``,
``k3.column_trips``) and its launches (``yardstick_k3.k3_counts``) at F
and R."""

import numpy as np

from benchmark.program_trace import program_counters
from benchmark.yardstick import bound_s
from benchmark.yardstick_k3 import K3_KERNELS, K3_SOLVES, k3_counts


def read(run):
    tr = run.trace
    if tr is None:
        return None
    c = program_counters()
    if not c or c.get("k3.columns", 0) <= 0:
        return None
    inside = (tr.starts >= run.t0) & (tr.starts < run.t1)
    pick = inside & np.asarray([any(n in name for n in K3_KERNELS)
                                for name in tr.names], bool)
    launches = int((inside & np.asarray(
        [any(n in name for n in K3_SOLVES) for name in tr.names],
        bool)).sum())
    if launches == 0:
        return None
    b = run.cell.config["bases"]
    flops, n_bytes = k3_counts(b["f"], b["r_x"] + b["r_d"], c["k3.columns"],
                               c["k3.column_trips"], launches)
    took = float(np.sum(tr.ends[pick] - tr.starts[pick]))
    return 100.0 * bound_s(flops, n_bytes) / took
