"""Time K2 built with other launch constants, K1's two paths at a few
columns a lane, and read where a trip of K2 or K3 spends its cycles, on the
card:

    python3 tools/kernel_variants.py w                  # K2, every variant
    python3 tools/kernel_variants.py w base threads_384
    python3 tools/kernel_variants.py h1                 # K1, N = 1, 2, 4
    python3 tools/kernel_variants.py h1 narrow          # one narrow build
    python3 tools/kernel_variants.py w_clocks
    python3 tools/kernel_variants.py h1_clocks          # K1's narrow trip
    python3 tools/kernel_variants.py cols_clocks        # K3

from the root of a checkout, on a machine with an H100 and the CUDA
toolkit.  ``w`` compiles ``csrc/mu_w_solve.cu`` once a variant with the
library's flags plus ``-DMU_W_CLUSTER=`` / ``-DMU_W_THREADS=`` (the cluster
size and block size are constants of a build), loads each shared object from
``build/variants/`` and calls the same C entry on the same tensors; one line
a variant with the card's name and power limit.  ``h1`` builds
``csrc/mu_h_solve.cu`` with ``-DMU_H_NARROW_MAX=0`` (every N on the wide
path, the 88-column design) and with ``=4`` (N <= 4 on the narrow path,
``-DMU_H_NARROW_CLUSTER=`` 8, 4 or 2), and times each narrow build in turns
with the wide one at F=513, R=200, N = 1, 2 and 4 columns a lane and B = 8,
16, 64, 128 and 256 lanes: the numbers that set N* and the cluster size.

The ``*_clocks`` commands build a copy of the source whose main loop reads
``clock64()`` after every block and cluster barrier (thread 0 of the first
block of the first cluster) and print the cycles of each stretch between two
barriers, summed over the loop's passes: which phase of a trip holds the
block.  ``h1_clocks`` reads it at the points of ``NARROW_CLOCKS`` in K1's
narrow kernel and its pass, from the kernel's start.  Not part of the
package: nothing on a path imports it.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import card_line, cuda_ms, in_turns, rel_err  # noqa: E402
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

# K1's two paths: every N on the wide path, and N <= 4 on the narrow one
# with clusters of 8, 4 and 2 blocks (4, 2 and 1 blocks a SM)
H_VARIANTS = {
    "wide": ["-DMU_H_NARROW_MAX=0"],
    "narrow": ["-DMU_H_NARROW_MAX=4", "-DMU_H_NARROW_CLUSTER=8"],
    "narrow_c4": ["-DMU_H_NARROW_MAX=4", "-DMU_H_NARROW_CLUSTER=4"],
    "narrow_c2": ["-DMU_H_NARROW_MAX=4", "-DMU_H_NARROW_CLUSTER=2"],
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


# The narrow K1 kernel's trip, cut where a clock is read: each source text
# (which must occur once in csrc/mu_h_solve.cu, or the build refuses) and
# the same with a read marked, @P in the pass (read from the first trip on)
# and @ in the kernel; then what the stretch ending at each read holds, in
# the order of the reads in the file (the pass comes first).
NARROW_CLOCKS = [
    ("  float cost_main = 0.f, cost_tail = 0.f;\n",
     "  float cost_main = 0.f, cost_tail = 0.f;\n  @P\n"),
    ("    rows<NC, G>(x, i * G, lane, h, acc, cost_main, with_cost);\n",
     "    rows<NC, G>(x, i * G, lane, h, acc, cost_main, with_cost);\n"
     "  @P\n"),
    ("    rows<NC, 1>(x, tail + k, lane, h, acc, cost_tail, with_cost);\n",
     "    rows<NC, 1>(x, tail + k, lane, h, acc, cost_tail, with_cost);\n"
     "  @P\n"),
    ("  // the warps' numerators added in a fixed tree",
     "  @P\n  // the warps' numerators added in a fixed tree"),
    ("  __syncthreads();\n  if (warp >= NW / 2) {",
     "  __syncthreads();\n  @P\n  if (warp >= NW / 2) {"),
    ("  if (with_cost && tid < NC) {   // the warps' costs in the same tree",
     "  @P\n  if (with_cost && tid < NC) {   // the warps' costs in the same "
     "tree"),
    ("  const int ws = l.ws, nc4 = l.nc4;\n",
     "  const int ws = l.ws, nc4 = l.nc4;\n  @START\n"),
    ("  pass<NC>(x, s, sparsity, false);\n",
     "  pass<NC>(x, s, sparsity, false);\n  @\n  @ON\n"),
    ("    cluster.sync();   // the pass's partials, in every block\n",
     "    cluster.sync();   // the pass's partials, in every block\n    @\n"),
    ("    if (!__syncthreads_or(any)) break;\n",
     "    @\n    const int any_ = __syncthreads_or(any);\n    @\n"
     "    if (!any_) break;\n"),
]
NARROW_STRETCHES = [
    "h into registers (from the block barrier after the update)",
    "the warp's groups of rows",
    "the rows past the last group",
    "the warp's costs and sum(h)",
    "the warps' first partials stored, a block barrier",
    "the other partials added, the tree's barriers and sums",
    "set-up: W's slice loaded and normalised, V, h0, the first pass",
    "the cost tree's thread, the loop, the cluster barrier",
    "remote reads, stop test and h update",
    "the block barrier after the update",
]
SETUP = 6
FIRST = "blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0"
NARROW_CLOCK_HEAD = CLOCK_HEAD + f"""
__device__ long long g_last;
__device__ int g_on;
#define GCLK(i) do {{ if ({FIRST}) {{ const long long now_ = clock64(); \\
    g_clk[i] += now_ - g_last; g_cnt[i] += 1; g_last = now_; }} }} while (0)
#define PCLK(i) do {{ if (({FIRST}) && g_on) GCLK(i); }} while (0)
"""


def narrow_with_clocks(text: str) -> str:
    """mu_h_solve.cu with a clock read at each marked point of
    NARROW_CLOCKS (thread 0 of the first block of the first cluster),
    counted from the narrow kernel's start; the pass's reads count from the
    first trip on, so that the set-up and the first pass are one stretch."""
    if "@" in text:
        raise RuntimeError("clock variant: the source holds an @")
    for anchor, marked in NARROW_CLOCKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"clock variant: no single {anchor!r}")
        text = text.replace(anchor, marked)
    text = text.replace("@START", f"if ({FIRST}) {{ g_last = clock64(); "
                        f"g_on = 0; }}")
    text = text.replace("@ON", f"if ({FIRST}) g_on = 1;")
    parts = re.split(r"(@P?)", text)
    marks = parts[1::2]
    if len(marks) != len(NARROW_STRETCHES):
        raise RuntimeError("clock variant: reads and stretches differ")
    text = parts[0] + "".join(
        f"{'PCLK' if mark == '@P' else 'GCLK'}({i});" + rest
        for i, (mark, rest) in enumerate(zip(marks, parts[2::2])))
    text = text.replace("namespace {\n", "namespace {\n" + NARROW_CLOCK_HEAD,
                        1)
    return text + CLOCK_TAIL


def time_h1_clocks(dev, card):
    """Cycles of each stretch of a narrow K1 trip (NARROW_CLOCKS) at N=1,
    F=513, R=200, B=8 and 64, 25 fixed trips and cap 100 with the 1e-3
    stop."""
    text = narrow_with_clocks((build.CSRC / "mu_h_solve.cu").read_text())
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "clocks_mu_h_solve.cu"
    src.write_text(text)
    lib, _ = build_variant(src, "clocks")
    lib.variant_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int]
    fn = lib.mu_h_solve_lanes
    fn.argtypes = build.SIGNATURES["mu_h_solve_lanes"]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    stream = torch.cuda.current_stream(dev).cuda_stream
    h0 = t(rng.random((200, 1)))
    for b in (8, 64):
        v = t(rng.gamma(0.6, 2.0, (b, 513, 1)))
        w = t(rng.random((b, 513, 200)) + 1e-3)
        h = torch.empty((b, 200, 1), dtype=torch.float32, device=dev)
        trips = torch.empty((b, 1), dtype=torch.int32, device=dev)
        for cap, eps in ((25, 0.0), (100, 1e-3)):

            def call():
                return fn(v.data_ptr(), w.data_ptr(), h0.data_ptr(), 0,
                          None, 0, h.data_ptr(), trips.data_ptr(), None, b,
                          513, 200, 1, cap, eps, 5.0, 1e-9, stream)

            if call():
                raise RuntimeError("clock variant: launch error")
            torch.cuda.synchronize()
            lib.variant_clocks(None, None, 1)
            ms = cuda_ms(call, reps=1)
            clk = (ctypes.c_longlong * CLOCK_SLOTS)()
            cnt = (ctypes.c_longlong * CLOCK_SLOTS)()
            if lib.variant_clocks(ctypes.addressof(clk),
                                  ctypes.addressof(cnt), 0):
                raise RuntimeError("clock variant: reading the clocks failed")
            passes = cnt[NARROW_STRETCHES.index(
                "remote reads, stop test and h update")]
            trip = sum(clk[i] for i in range(len(NARROW_STRETCHES))
                       if i != SETUP) / max(passes, 1)
            print(f"K1 narrow N=1 B={b} cap={cap} eps={eps} (lane 0: "
                  f"{int(trips[0, 0])} trips): 2 launches {2 * ms:.4f} ms; "
                  f"cycles of the first block's thread 0, a trip "
                  f"{trip:.0f} over {passes} trips ({card})")
            for i, what in enumerate(NARROW_STRETCHES):
                if cnt[i]:
                    print(f"  {i} {what}: {clk[i] / cnt[i]:.0f} cycles a "
                          f"pass over {cnt[i]} passes")


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
                      act.data_ptr(), w.data_ptr(), trips.data_ptr(), None,
                      b, 513, 50, 100, 22, 0.0, 5.0, 1e-9, stream)
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
                      trips.data_ptr(), None, 0, 0, 0, 0, 513, 200, n, 100,
                      1e-3, 5.0, 1e-9, stream)
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
                        act.data_ptr(), w.data_ptr(), trips.data_ptr(), None,
                        b, 513, 50, 100, cap, 0.0, 5.0, 1e-9, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch error {rc}")

            out.append(f"B={b} trips={cap} {cuda_ms(call):.3f} ms")
        print(f"K2 variant {name}: {'; '.join(out)}; {' | '.join(regs)} "
              f"({card})", flush=True)


def time_h1(dev, card, names):
    """K1 at F=513, R=200 with N = 1, 2 and 4 columns a lane at B = 8, 16,
    64, 128 and 256 (gamma spectra, a random dictionary a lane), cap 100
    with the 1e-3 stop, 25 fixed trips and no trip (the entry's own time: W
    loaded and normalised, the first pass): each narrow variant in turns
    with the wide path (wide, narrow, narrow, wide), with both launch
    shapes; the narrow result held to the wide one's (within 1e-4 relative
    on entries above 1e-6 of the largest, on the columns whose trips agree:
    at least three in four).  ``names`` picks narrow variants."""
    libs = {}
    for name, flags in H_VARIANTS.items():
        if names and name != "wide" and name not in names:
            continue
        lib, regs = build_variant(build.CSRC / "mu_h_solve.cu", name, flags)
        for entry in ("mu_h_solve_lanes", "mu_h_solve_lanes_shape"):
            fn = getattr(lib, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
        print(f"K1 build {name} ({' '.join(flags)}): {' | '.join(regs)}",
              flush=True)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in (1, 2, 4):
        h0 = t(rng.random((200, n)))
        for b in (8, 16, 64, 128, 256):
            v = t(rng.gamma(0.6, 2.0, (b, 513, n)))
            w = t(rng.random((b, 513, 200)) + 1e-3)
            out = {name: (torch.empty((b, 200, n), dtype=torch.float32,
                                      device=dev),
                          torch.empty((b, n), dtype=torch.int32, device=dev))
                   for name in libs}
            shape = {}
            for name, lib in libs.items():
                sh = (ctypes.c_int * 11)()
                if lib.mu_h_solve_lanes_shape(b, 513, 200, n,
                                              ctypes.addressof(sh)):
                    raise RuntimeError(f"{name}: shape query failed")
                shape[name] = (f"{('wide', 'narrow')[sh[9]]} path, "
                               f"{sh[8]} clusters of {sh[0]} x {sh[4]} "
                               f"threads, {sh[5]} resident, {sh[10]} waves, "
                               f"{sh[3]} B")
            for cap, eps in ((100, 1e-3), (25, 0.0), (0, 0.0)):

                def call(name):
                    h, trips = out[name]
                    rc = libs[name].mu_h_solve_lanes(
                        v.data_ptr(), w.data_ptr(), h0.data_ptr(), 0, None,
                        0, h.data_ptr(), trips.data_ptr(), None, b, 513, 200,
                        n, cap, eps, 5.0, 1e-9, stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch error {rc}")

                for name in libs:
                    if name == "wide":
                        continue
                    nar1, nar2, wid1, wid2 = in_turns(
                        lambda: call(name), lambda: call("wide"))
                    (hn, tn), (hw, tw) = out[name], out["wide"]
                    same = tn == tw
                    err, _ = rel_err(hn[same[:, None, :].expand_as(hn)],
                                     hw[same[:, None, :].expand_as(hw)])
                    other = int((~same).sum())
                    print(f"K1 N={n} B={b} cap={cap} eps={eps} (mean trips "
                          f"{tn.float().mean().item():.2f}): wide "
                          f"{wid1:.4f}, {wid2:.4f} ms, {name} {nar1:.4f}, "
                          f"{nar2:.4f} ms (in turns wide, {name}, {name}, "
                          f"wide), wide / {name} "
                          f"{min(wid1, wid2) / min(nar1, nar2):.2f}x; max_rel "
                          f"{err:.2e} on the columns of equal trips, other "
                          f"trips {other}/{same.numel()}; {name}: "
                          f"{shape[name]}; wide: {shape['wide']} ({card})",
                          flush=True)
                    if err > 1e-4 or other > same.numel() // 4:
                        raise AssertionError(f"K1 N={n} B={b}: {name} and "
                                             f"the wide path disagree")


def main(which: str, names=()) -> int:
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    card = card_line()
    if which == "w":
        time_w(dev, card, names)
    elif which == "h1":
        time_h1(dev, card, names)
    elif which == "h1_clocks":
        time_h1_clocks(dev, card)
    elif which in ("w_clocks", "cols_clocks"):
        time_clocks(which.split("_")[0], dev, card)
    else:
        raise SystemExit(
            "usage: kernel_variants.py w|h1|h1_clocks|w_clocks|cols_clocks")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "", sys.argv[2:]))
