"""Which cuFFT calls give a row the same bits whatever the batch, at the
multichannel STFT's shapes: rfft of 640-sample frames at n=1024 and irfft
of 513 bins at n=1024, in float32 and float64, by batch size and by a row's
position in a batch of one size.

    python3 tools/fft_rows.py

on a machine with a CUDA card (it exits without one).  Prints one line a
dtype, transform and question, and the card's name and power limit.
"""

import subprocess
import sys

import torch

SIZES = (1, 2, 3, 6, 8, 16, 48, 64, 128, 256, 512, 1024, 2048, 2082, 4096,
         8192, 16656)


def main() -> int:
    if not torch.cuda.is_available():
        print("fft_rows: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    n_rows = max(SIZES) + 8

    def fwd(v):
        return torch.fft.rfft(v, n=1024, dim=-1)

    def inv(v):
        return torch.fft.irfft(v, n=1024, dim=-1)

    for dt in (torch.float32, torch.float64):
        x = (torch.randn(n_rows, 640, generator=gen, dtype=dt) * 1e3).to(dev)
        spec = fwd(x)
        for name, f, inp, full in (("rfft", fwd, x, spec),
                                   ("irfft", inv, spec, inv(spec))):
            prefix = {b: torch.equal(f(inp[:b]), full[:b]) for b in SIZES}
            one = f(inp[:1])
            alone = {b: torch.equal(f(inp[:b])[:1], one) for b in SIZES}
            shifted = {r: torch.equal(f(inp[:r])[1:], f(inp[1:1 + r])[:-1])
                       for r in (6, 48, 1024, 2048, 4096)}
            print(f"{dt} {name}: the first b rows alone = in the whole "
                  f"batch: {prefix}")
            print(f"{dt} {name}: row 0 in a batch of b = alone: {alone}")
            print(f"{dt} {name}: a row one place later in a batch of r "
                  f"rows, same bits: {shifted}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
