"""The offline PMWF plan's share of its roofline (%): its least time, the
larger of the operations over the float32 peak and the bytes over the
memory rate (``yardstick_pmwf.pmwf_counts`` over the true frames of every
lane of the window's calls), over the kernel time of the window's
``enhance_batch`` calls (the union of the kernel intervals inside them:
every kernel of the call, the transforms and the int16 write too)."""

import math

from benchmark.yardstick import bound_s, covered_many
from benchmark.yardstick_pmwf import pmwf_counts


def read(run):
    spans = run.span("enhance_batch")
    lane_frames = getattr(run.driver, "window_lane_frames", None)
    if run.trace is None or len(spans) == 0 or lane_frames is None:
        return None
    busy = float(covered_many(run.trace.union, spans).sum())
    if busy <= 0:
        return None
    s, p = run.cell.params["signal"], run.cell.params["pmwf"]
    flen = int(math.floor(s["wintime"] * s["fs"] + 0.5))
    f = (1 << math.ceil(math.log2(flen))) // 2 + 1
    flops, n_bytes = pmwf_counts(
        lane_frames(len(spans)), f, int(run.cell.config["channels"]),
        p["m_nbr"], p["l_nbr"], p["init_n_len"], p["norm_period"])
    return 100.0 * bound_s(flops, n_bytes) / busy
