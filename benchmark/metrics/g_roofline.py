"""G's share of its roofline on the block plan (bound by its bytes): its
least time at (lanes, K, F) over its profiled time, summed over the
window's launches (%)."""

import numpy as np

from benchmark.yardstick import bound_s, g_counts

NAMES = ("gain_scan_kernel",)


def read(run):
    tr = run.trace
    if tr is None or "block_adapt" not in run.cell.config["program"]:
        return None
    pick = np.asarray([any(n in name for n in NAMES) for name in tr.names])
    pick &= (tr.starts >= run.t0) & (tr.starts < run.t1)
    if not pick.any():
        return None
    lanes = int(run.cell.traffic["lanes"])
    one = bound_s(*g_counts(lanes, run.cell.config["program"]["block_adapt"],
                            run.cell.config["bases"]["f"]))
    took = float(np.sum(tr.ends[pick] - tr.starts[pick]))
    return 100.0 * one * int(pick.sum()) / took
