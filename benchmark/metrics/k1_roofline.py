"""K1's share of its roofline on the block plan: its least time at the
plan's shape (lanes, F, R, K columns, the fixed trips) over its profiled
time, summed over the window's launches (%)."""

import numpy as np

from benchmark.yardstick import bound_s, k1_counts

NAMES = ("h_lanes_kernel",)


def read(run):
    tr = run.trace
    if tr is None or "block_adapt" not in run.cell.config["program"]:
        return None
    pick = np.asarray([any(n in name for n in NAMES) for name in tr.names])
    pick &= (tr.starts >= run.t0) & (tr.starts < run.t1)
    if not pick.any():
        return None
    prog, sep = run.cell.config["program"], run.cell.params["sep"]
    lanes = int(run.cell.traffic["lanes"])
    one = bound_s(*k1_counts(lanes, run.cell.config["bases"]["f"],
                             sep["r_x"] + sep["r_d"], prog["block_adapt"],
                             prog["block_iter_cap"]))
    took = float(np.sum(tr.ends[pick] - tr.starts[pick]))
    return 100.0 * one * int(pick.sum()) / took
