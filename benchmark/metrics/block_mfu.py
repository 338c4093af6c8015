"""The whole block step's share of the card's float32 peak: the useful
operations of the window's calls (``yardstick.block_call_flops`` over
their true frames) over the calls' wall time x 67 TFLOP/s (%)."""

import math

from benchmark.yardstick import PEAK_FLOPS, block_call_flops


def read(run):
    spans = run.span("enhance_batch")
    prog = run.cell.config["program"]
    if len(spans) == 0 or "block_adapt" not in prog:
        return None
    s, sep = run.cell.params["signal"], run.cell.params["sep"]
    flops = block_call_flops(run.counts["true_frames"],
                             run.cell.config["bases"]["f"],
                             sep["r_x"] + sep["r_d"],
                             int(math.floor(s["wintime"] * s["fs"] + 0.5)),
                             prog["block_iter_cap"])
    wall = float((spans[:, 1] - spans[:, 0]).sum())
    return 100.0 * flops / wall / PEAK_FLOPS
