"""Time K2 built with other launch constants, and read where a trip of K2 or
K3 spends its cycles, on the card, beside the shipped build:

    python3 tools/kernel_variants.py w                  # K2, every variant
    python3 tools/kernel_variants.py w base threads_384
    python3 tools/kernel_variants.py w_clocks
    python3 tools/kernel_variants.py cols_clocks        # K3

from the root of a checkout, on a machine with an H100 and the CUDA
toolkit.  ``w`` compiles ``csrc/mu_w_solve.cu`` once a variant with the
library's flags plus ``-DMU_W_CLUSTER=`` / ``-DMU_W_THREADS=`` (the cluster
size and block size are constants of a build), loads each shared object from
``build/variants/`` and calls the same C entry on the same tensors; one line
a variant with the card's name and power limit.

The ``*_clocks`` commands build a copy of the source whose main loop reads
``clock64()`` after every block and cluster barrier (thread 0 of the first
block of the first cluster) and print the cycles of each stretch between two
barriers, summed over the loop's passes: which phase of a trip holds the
block.  Not part of the package: nothing on a path imports it.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import card_line, cuda_ms  # noqa: E402
from se_snmf_nat_tpu_torch.kernels import build  # noqa: E402

# name -> extra nvcc flags (the knobs of mu_w_solve.cu)
W_VARIANTS = {
    "base": [],
    "clusters_of_4": ["-DMU_W_CLUSTER=4"],
    "clusters_of_4_threads_512": ["-DMU_W_CLUSTER=4", "-DMU_W_THREADS=512"],
    "threads_128": ["-DMU_W_THREADS=128"],
    "threads_384": ["-DMU_W_THREADS=384"],
    "threads_512": ["-DMU_W_THREADS=512"],
}


OUT_DIR = build.BUILD_DIR / "variants"


def build_variant(source: Path, name: str, flags=()):
    """The source compiled with extra flags into its own library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"{name}_{source.name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, *flags, f"-I{build.CSRC}",
         "-shared", "-o", str(lib), str(source)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr}")
    regs = [ln.split(":")[-1].strip() for ln in proc.stderr.splitlines()
            if "registers" in ln]
    return ctypes.CDLL(str(lib)), regs


CLOCK_SLOTS = 32
CLOCK_HEAD = f"""
__device__ long long g_clk[{CLOCK_SLOTS}];
__device__ long long g_cnt[{CLOCK_SLOTS}];
#define CLK(i) do {{ if (blockIdx.x == 0 && blockIdx.y == 0 && \\
    threadIdx.x == 0) {{ const long long now_ = clock64(); \\
    g_clk[i] += now_ - clk_last_; g_cnt[i] += 1; clk_last_ = now_; }} \\
  }} while (0)
"""
CLOCK_TAIL = f"""
extern "C" int variant_clocks(long long* clk, long long* cnt, int reset) {{
  if (reset) {{
    long long z[{CLOCK_SLOTS}] = {{0}};
    cudaError_t e = cudaMemcpyToSymbol(g_clk, z, sizeof z);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbol(g_cnt, z, sizeof z);
  }}
  cudaError_t e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(long long) *
                                       {CLOCK_SLOTS});
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(cnt, g_cnt, sizeof(long long) *
                                   {CLOCK_SLOTS});
}}
"""


def with_clocks(text: str, loop_marker: str):
    """The source with a clock read after every barrier from the kernel's
    main loop on; returns it with the barriers' source lines in order."""
    if text.count(loop_marker) != 1 or text.count("namespace {\n") < 1:
        raise RuntimeError(f"clock variant: no single {loop_marker!r}")
    head, tail = text.split(loop_marker)
    head = head.replace("namespace {\n", "namespace {\n" + CLOCK_HEAD, 1)
    out, sites, in_kernel = [], [], True
    for line in tail.splitlines(keepends=True):
        out.append(line)
        if line.startswith("}"):          # the kernel ends here
            in_kernel = False
        stripped = line.strip()
        if in_kernel and len(sites) < CLOCK_SLOTS and stripped.startswith(
                ("__syncthreads();", "cluster.sync();")):
            out.append(f"CLK({len(sites)});\n")
            sites.append(stripped.split(";")[0])
    body = ("  long long clk_last_ = clock64();\n" + loop_marker
            + "".join(out))
    return head + body + CLOCK_TAIL, sites


def time_clocks(which: str, dev, card):
    """Cycles of each stretch between two barriers of the main loop."""
    source, marker = {
        "w": ("mu_w_solve.cu",
              "  for (int it = 0; it < max_iter; ++it) {\n"),
        "cols": ("mu_h_cols.cu", "  for (;;) {\n")}[which]
    text, sites = with_clocks((build.CSRC / source).read_text(), marker)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"clocks_{source}"
    src.write_text(text)
    lib, _ = build_variant(src, "clocks")
    lib.variant_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int]
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    stream = torch.cuda.current_stream(dev).cuda_stream
    if which == "w":
        b = 16
        v, w0, h = (t(rng.gamma(0.6, 2.0, (b, 513, 100))),
                    t(rng.random((b, 513, 50)) + 1e-3),
                    t(rng.random((b, 50, 100))))
        act = torch.ones(b, dtype=torch.int32, device=dev)
        w = torch.empty_like(w0)
        trips = torch.empty((b,), dtype=torch.int32, device=dev)
        fn = lib.mu_w_solve_lanes
        fn.argtypes = build.SIGNATURES["mu_w_solve_lanes"]

        def call():
            return fn(v.data_ptr(), w0.data_ptr(), h.data_ptr(),
                      act.data_ptr(), w.data_ptr(), trips.data_ptr(), b, 513,
                      50, 100, 22, 0.0, 5.0, 1e-9, stream)
        what = "K2 B=16 F=513 R=50 M=100, 22 fixed trips"
    else:
        n = 24576
        v = t(rng.gamma(0.6, 2.0, (n, 513))).t()
        w = t(rng.random((513, 200)) + 1e-3)
        h0 = t(rng.random((200, 1))).expand(200, n)
        h = torch.empty((n, 200), dtype=torch.float32, device=dev).t()
        trips = torch.empty((n,), dtype=torch.int32, device=dev)
        fn = lib.mu_h_solve_columns
        fn.argtypes = build.SIGNATURES["mu_h_solve_columns"]

        def call():
            return fn(v.data_ptr(), *v.stride(), w.data_ptr(), h0.data_ptr(),
                      *h0.stride(), h.data_ptr(), *h.stride(),
                      trips.data_ptr(), 0, 0, 0, 0, 513, 200, n, 100, 1e-3,
                      5.0, 1e-9, stream)
        what = "K3 F=513 R=200 N=24576 random spectra, cap 100 eps 1e-3"
    fn.restype = ctypes.c_int
    if call():
        raise RuntimeError("clock variant: launch error")
    torch.cuda.synchronize()
    lib.variant_clocks(None, None, 1)
    ms = cuda_ms(call, reps=1)
    clk = (ctypes.c_longlong * CLOCK_SLOTS)()
    cnt = (ctypes.c_longlong * CLOCK_SLOTS)()
    if lib.variant_clocks(ctypes.addressof(clk), ctypes.addressof(cnt), 0):
        raise RuntimeError("clock variant: reading the clocks failed")
    total = sum(clk)
    print(f"{what}: 2 launches {2 * ms:.3f} ms; cycles between barriers "
          f"(first block, thread 0), {total} in all ({card})")
    for i, site in enumerate(sites):
        if cnt[i]:
            print(f"  up to barrier {i} ({site}): {clk[i]} cycles in "
                  f"{cnt[i]} passes, {clk[i] / cnt[i]:.0f} a pass, "
                  f"{clk[i] / total:.1%}")


def time_w(dev, card, names):
    """K2 at the main path's shape with fixed trips: 22 at B=16 and B=64,
    and 0, 1, 2 and 12 at B=16 (the entry's and a trip's own time)."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    data = {}
    for b in (16, 64):
        data[b] = (t(rng.gamma(0.6, 2.0, (b, 513, 100))),
                   t(rng.random((b, 513, 50)) + 1e-3),
                   t(rng.random((b, 50, 100))),
                   torch.ones(b, dtype=torch.int32, device=dev),
                   torch.empty((b, 513, 50), dtype=torch.float32, device=dev),
                   torch.empty((b,), dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, flags in W_VARIANTS.items():
        if names and name not in names:
            continue
        lib, regs = build_variant(build.CSRC / "mu_w_solve.cu", name, flags)
        fn = lib.mu_w_solve_lanes
        fn.argtypes = build.SIGNATURES["mu_w_solve_lanes"]
        fn.restype = ctypes.c_int
        out = []
        for b, cap in ((16, 22), (64, 22), (16, 0), (16, 1), (16, 2),
                       (16, 12)):
            v, w0, h, act, w, trips = data[b]

            def call():
                rc = fn(v.data_ptr(), w0.data_ptr(), h.data_ptr(),
                        act.data_ptr(), w.data_ptr(), trips.data_ptr(), b,
                        513, 50, 100, cap, 0.0, 5.0, 1e-9, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch error {rc}")

            out.append(f"B={b} trips={cap} {cuda_ms(call):.3f} ms")
        print(f"K2 variant {name}: {'; '.join(out)}; {' | '.join(regs)} "
              f"({card})", flush=True)


def main(which: str, names=()) -> int:
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    card = card_line()
    if which == "w":
        time_w(dev, card, names)
    elif which in ("w_clocks", "cols_clocks"):
        time_clocks(which.split("_")[0], dev, card)
    else:
        raise SystemExit("usage: kernel_variants.py w|w_clocks|cols_clocks")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "", sys.argv[2:]))
