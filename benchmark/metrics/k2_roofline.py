"""K2's share of its roofline on the per-frame plan: its least time over
its profiled time, the ``w_lanes_kernel`` events of the window (%).  The
least time is the larger of the operations over the float32 peak and the
bytes over the memory rate, counted from the program's counters of K2's
work over the window (``k2.lane_trips``, ``k2.active_lanes``) and the
lanes of its launches (``yardstick_k2.k2_counts``) at F, r_a and m_a."""

import numpy as np

from benchmark.program_trace import program_counters
from benchmark.yardstick import bound_s
from benchmark.yardstick_k2 import k2_counts

NAMES = ("w_lanes_kernel",)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    c = program_counters()
    if not c or "k2.lane_trips" not in c:
        return None
    pick = np.asarray([any(n in name for n in NAMES) for name in tr.names])
    pick &= (tr.starts >= run.t0) & (tr.starts < run.t1)
    if not pick.any():
        return None
    ad = run.cell.params["adapt"]
    flops, n_bytes = k2_counts(run.cell.config["bases"]["f"], ad["r_a"],
                               ad["m_a"], c["k2.lane_trips"],
                               c["k2.active_lanes"],
                               int(pick.sum()) * run.driver.lanes)
    took = float(np.sum(tr.ends[pick] - tr.starts[pick]))
    return 100.0 * bound_s(flops, n_bytes) / took
