"""The one-time sweep that sets the fleet cell's lane count: the fleet's
open loop at each lane count, on the card, with the cell's configuration
and traffic but for the lanes:

    python3 benchmark/traffic/knee_sweep.py --lanes 128,160,192,224,256 \
        --seconds 15 --seed 5

One JSON line a lane count: the latency percentiles, how late the
generator ran in the window's first and last fifths (a growing lateness
means the fleet does not keep up), and ticks over the 80 ms deadline.  The
knee is the largest lane count whose p95 stays under the tick with no
growing lateness; the cell runs at 4/5 of it, rounded down to a multiple
of 8.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lanes", default="128,160,192,224,256")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--workload", default="nat_frame.fleet")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from benchmark.harness import Cell, spec
    bench = spec()
    w = next(c for c in bench["workloads"] if c["name"] == args.workload)
    base = json.loads((ROOT / "benchmark" / "traffic"
                       / f"{w['traffic']}.json").read_text())
    for lanes in (int(v) for v in args.lanes.split(",")):
        cell = Cell(args.workload, args.seed, torch.device("cuda", 0), bench,
                    dict(base, lanes=lanes))
        drv = cell.driver()
        spans: list = []
        t0 = time.perf_counter()
        win = drv.window(args.seconds, spans)
        pushes = [(a, b) for n, a, b in spans if n == "fleet.push"]
        late = np.asarray([a for a, _ in pushes]) - \
            (drv.t0 + np.arange(len(pushes)) * drv.tick_s)
        lat = np.asarray([b for _, b in pushes]) - \
            (drv.t0 + np.arange(len(pushes)) * drv.tick_s)
        fifth = max(len(late) // 5, 1)
        print(json.dumps({
            "lanes": lanes, **win["end_to_end"],
            "ticks": len(pushes),
            "late_ms_first_fifth": float(late[:fifth].mean() * 1e3),
            "late_ms_last_fifth": float(late[-fifth:].mean() * 1e3),
            "over_tick": int((lat > drv.tick_s).sum()),
            "s": time.perf_counter() - t0}), flush=True)
        drv.release()
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
