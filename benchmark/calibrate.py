"""Readings for the comparison's limits, on the card: for each seed, one
run of a cell (a short window at the cell's own load) with the program's
numbers and the control's (the reference one precision below the
configuration's, in the program's place), in one process:

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--control-seeds 11,12,13]

Prints one JSON line a seed.  Benchmark runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import run_cell
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res, lines = run_cell(args.workload, seed, args.seconds, False,
                              control=seed in ctrl)
        print(json.dumps({"seed": seed, "checks": res["checks"],
                          "metrics": res["metrics"], "lines": lines,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
