"""Host-bound loops of the port on the card, timed for one source tree: the
exact per-frame plan (a warm ``enhance_batch`` at B=16 and B=64, and the
CUDA kernels it launches a frame), a ``StreamingSession`` push
(``block_frames`` 1 and 8) and a ``MultiStreamSession`` tick of 8 frames
at 64 lanes on the samples wire, at full width (``default_config()``, the
shapes of ``chip_smoke.py`` phases 6-8).  Each is measured ``--rounds``
times in turns.

    python3 tools/host_loop_times.py [--root DIR] [--rounds 3]

``--root`` is the root of the checkout whose ``se_snmf_nat_tpu_torch`` is
timed (this one by default), so that two commits are compared in one call
on one card: unpack the other commit into a git-ignored directory
(``git archive <commit> | tar -x -C build/parent``) and run parent,
change, change, parent.  Prints the card's name and power limit, then one
JSON line of the numbers; exits 1 without a CUDA card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_UTT = 16
N_SAMPLES = 54880           # 343 hops + 4 flush frames = 347 frames
FLEET_LANES = 64
FLEET_BLOCK = 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def kernels_launched(fn) -> int:
    """CUDA kernels launched by one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)


def batch_s(enh, batch) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enh.enhance_batch(batch, micro_batch=None)
    return time.perf_counter() - t0


def push_ms(enh, x, block_frames) -> float:
    """Median host ms of the pushes that complete a block, one stream."""
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    shift = enh.cfg.signal.frameshift
    sess = StreamingSession(enh, block_frames=block_frames)
    ms = []
    for i in range(0, len(x) - shift + 1, shift):
        t0 = time.perf_counter()
        sess.push(x[i: i + shift])
        ms.append((time.perf_counter() - t0) * 1e3)
    sess.flush()
    return float(np.median(ms[block_frames - 1::block_frames]))


def tick_ms(enh, xs) -> float:
    """Median host ms of a fleet tick (a push of one block of hops)."""
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
    fleet = MultiStreamSession(enh, xs.shape[0], block_frames=FLEET_BLOCK,
                               wire="samples")
    step = FLEET_BLOCK * enh.cfg.signal.frameshift
    ms = []
    for i in range(0, xs.shape[1] - step + 1, step):
        t0 = time.perf_counter()
        fleet.push(xs[:, i: i + step])
        ms.append((time.perf_counter() - t0) * 1e3)
    fleet.flush()
    return float(np.median(ms))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("host_loop_times: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import se_snmf_nat_tpu_torch as pkg
    if Path(pkg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {pkg.__file__}, not the tree {root}")
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.kernels import build
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

    card = card_line()
    print(card)
    build.load()
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cuda")
    n_frames = N_SAMPLES // cfg.signal.frameshift + cfg.delay + 1
    batches = {b: [fixtures.noisy_utterance(N_SAMPLES, seed=100 + i)
                   for i in range(b)] for b in (N_UTT, 64)}
    lanes = np.stack([fixtures.noisy_utterance(N_SAMPLES, seed=400 + i)
                      for i in range(FLEET_LANES)])
    x = batches[N_UTT][0]
    for b in batches.values():                                   # warm
        enh.enhance_batch(b, micro_batch=None)
    push_ms(enh, x, 1)
    push_ms(enh, x, 8)
    tick_ms(enh, lanes)
    kernels = kernels_launched(
        lambda: enh.enhance_batch(batches[N_UTT], micro_batch=None))
    rounds = {"batch_b16_s": [], "batch_b64_s": [], "push_bf1_ms": [],
              "push_bf8_ms": [], "tick_b64_ms": []}
    for _ in range(args.rounds):
        rounds["batch_b16_s"].append(batch_s(enh, batches[N_UTT]))
        rounds["batch_b64_s"].append(batch_s(enh, batches[64]))
        rounds["push_bf1_ms"].append(push_ms(enh, x, 1))
        rounds["push_bf8_ms"].append(push_ms(enh, x, 8))
        rounds["tick_b64_ms"].append(tick_ms(enh, lanes))
    print(json.dumps({
        "root": str(root), "card": card, "frames": n_frames,
        "kernels_a_frame_b16": kernels / n_frames,
        "median": {k: float(np.median(v)) for k, v in rounds.items()},
        "best": {k: float(np.min(v)) for k, v in rounds.items()},
        "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
