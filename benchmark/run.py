"""Run one cell of the benchmark once, on the card of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the comparison's numbers beside their limits as the last lines of
standard error and one JSON object as the last line of standard output.
Exits with 1, printing no result, when there is no card, and when JAX or
the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    # every cache of the program stays inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark runs on the card", file=sys.stderr)
        return 1
    from benchmark.harness import run_cell, spec
    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r}", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < int(cells[args.workload]["chips"]):
        print("fewer cards than the cell asks for", file=sys.stderr)
        return 1
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), bench=bench, t_start=T_START)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
